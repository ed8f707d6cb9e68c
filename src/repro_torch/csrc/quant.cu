// The int4 wire format of the quantized gather, for Hopper (sm_90a):
//
//   nibble_pack    int8 codes (rows, n)   -> uint8 bytes (rows, ceil(n/2))
//   nibble_unpack  uint8 bytes (rows, nb) -> int8 codes (rows, n), n <= 2 nb
//
// Code 2k of a row goes to the low nibble of byte k and code 2k+1 to the
// high nibble; an odd row is padded with a zero code.  Pack keeps the low
// nibble of each code (two's complement, no range check); unpack
// sign-extends each nibble to [-8, 7].
//
// pack replaces the Pallas kernel `_pack_kernel` behind `nibble_pack`
// (src/repro/kernels/quant.py:25, :52); unpack replaces `_unpack_kernel`
// behind `nibble_unpack` (:32, :77).  The TPU kernels strided codes into
// even/odd halves on the host and padded them to 128 lanes; here the
// leading dims fold into rows and one launch covers every worker's payload.
//
// What bounds them on an H100: a few integer operations per byte, so
// device-memory bytes.  At the training path's payload, the Top-K chunk
// (2.57 MB moved, a 0.77 us byte bound at the DRAM rate, in L2 as the
// caller has just written it), the launch itself is most of the time: an
// empty kernel on this grid takes 1.13 us by CUDA-graph replay after a
// kernel that does not signal early (as PyTorch's do), 0.78 us behind
// another PDL launch.  At 16 workers' payload (20.6 MB, cold) it is device
// memory.  (PERF.md section 6 has the numbers, from
// repro_torch/bench/nibble_ab.py.)
//
// The design, each element kept or left by the card's measurement:
//
// 1. Index math off the critical path (kept).  A 2-D grid: blockIdx.y
//    walks rows, blockIdx.x and the thread pick a row's work item, in
//    32-bit indices; no division runs in the kernel.  A row whose start is not
//    aligned for the vector loads, and a row's ragged end, take a byte loop.
// 2. Each warp store covers contiguous bytes (kept).  Pack's work item is
//    32 codes: two 16-byte loads, the nibbles shuffled in 32-bit words
//    (`__byte_perm`), one 16-byte store.  Unpack's is 16 codes: one 8-byte
//    load, one 16-byte store.  An unpack item of 32 codes (one load, two
//    16-byte stores 32 bytes apart) wrote half of each 32-byte sector per
//    store instruction and was 0.4 us slower at the Top-K chunk, 1 us cold.
// 3. Programmatic dependent launch, PDL (kept).  Every launch carries
//    cudaLaunchAttributeProgrammaticStreamSerialization, so its blocks may be
//    scheduled while the kernel before it drains.  Each thread does only
//    index math before `griddepcontrol.wait` (every global load and store
//    comes after it: the output may reuse memory its predecessor reads), and
//    signals `griddepcontrol.launch_dependents` once its stores are issued.
//    Stream capture records the dependency as a programmatic graph edge.
//    It takes 0.3-0.5 us off a launch that follows another B4 launch; on
//    the training path B4 follows PyTorch's kernels, which never signal
//    early, and gains less there (PERF.md).
// 4. Loads of several items a thread issued before any store, and a grid
//    rounded up to whole waves over the SMs: both left out, as slower on the
//    card at the Top-K chunk and no faster at 16 workers.  One item a thread.
//
// A refused launch returns its CUDA error; nothing retries without PDL.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxGridY = 65535;

__device__ __forceinline__ void wait_for_predecessor() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void allow_successor() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Codes c0..c3 in the bytes of a and c4..c7 in b -> 4 packed bytes.
__device__ __forceinline__ uint32_t pack_words(uint32_t a, uint32_t b) {
  const uint32_t x = a & 0x0F0F0F0Fu, y = b & 0x0F0F0F0Fu;
  // byte 0 of (x | x >> 4) is c0 | c1 << 4, byte 2 is c2 | c3 << 4
  return __byte_perm(x | (x >> 4), y | (y >> 4), 0x6420);
}

// Nibbles in [0, 15], one per byte -> the same nibbles sign-extended.
__device__ __forceinline__ uint32_t sign_extend(uint32_t v) {
  return v | ((v & 0x08080808u) * 0x1Eu);  // 0x08 * 0x1E = 0xF0, no carries
}

// 4 packed bytes -> 8 codes: (lo0, hi0, lo1, hi1) and (lo2, hi2, lo3, hi3).
__device__ __forceinline__ void unpack_word(uint32_t p, uint32_t& o0, uint32_t& o1) {
  const uint32_t lo = p & 0x0F0F0F0Fu, hi = (p >> 4) & 0x0F0F0F0Fu;
  o0 = sign_extend(__byte_perm(lo, hi, 0x5140));
  o1 = sign_extend(__byte_perm(lo, hi, 0x7362));
}

// Pack's work item j of a row is codes [32 j, 32 j + 32), packed bytes
// [16 j, 16 j + 16): two 16-byte loads and one 16-byte store.  Thread t of
// block (x, y) takes item x kThreads + t of rows y, y + gridDim.y, ...
// `items` = ceil(n / 32) items a row, `full` = floor(n / 32) of them hold
// 32 codes.
__global__ void __launch_bounds__(kThreads)
pack_kernel(const int8_t* __restrict__ q, uint8_t* __restrict__ out, long long rows,
            long long n, long long nb, int items, int full) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  wait_for_predecessor();
  if (j < items) {
    for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
      const int8_t* src = q + row * n;
      uint8_t* dst = out + row * nb;
      if (j < full && aligned16(src) && aligned16(dst)) {
        const uint4* s = reinterpret_cast<const uint4*>(src + 32 * (size_t)j);
        const uint4 a = s[0], b = s[1];
        uint4 o;
        o.x = pack_words(a.x, a.y);
        o.y = pack_words(a.z, a.w);
        o.z = pack_words(b.x, b.y);
        o.w = pack_words(b.z, b.w);
        *reinterpret_cast<uint4*>(dst + 16 * (size_t)j) = o;
      } else {
        const int8_t* s = src + 32 * (size_t)j;
        uint8_t* d = dst + 16 * (size_t)j;
        const long long left = n - 32LL * j;  // codes of this row from s on
        const int bytes = (int)((left < 32 ? left + 1 : 32) / 2);
        for (int i = 0; i < bytes; ++i) {
          const uint32_t lo = (uint8_t)s[2 * i] & 0xFu;
          const uint32_t hi = 2 * i + 1 < left ? ((uint8_t)s[2 * i + 1] & 0xFu) : 0u;
          d[i] = (uint8_t)(lo | (hi << 4));
        }
      }
    }
  }
  allow_successor();
}

// Unpack's work item j of a row is codes [16 j, 16 j + 16), packed bytes
// [8 j, 8 j + 8): one 8-byte load and one 16-byte store, so each store
// instruction of a warp covers 512 contiguous bytes.  Laid out as in
// pack_kernel, with `items` = ceil(n / 16) and `full` = floor(n / 16).
__global__ void __launch_bounds__(kThreads)
unpack_kernel(const uint8_t* __restrict__ p, int8_t* __restrict__ out, long long rows,
              long long nb, long long n, int items, int full) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  wait_for_predecessor();
  if (j < items) {
    for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
      const uint8_t* src = p + row * nb;
      int8_t* dst = out + row * n;
      if (j < full && (reinterpret_cast<uintptr_t>(src) & 7) == 0 && aligned16(dst)) {
        const uint2 a = *reinterpret_cast<const uint2*>(src + 8 * (size_t)j);
        uint4 o;
        unpack_word(a.x, o.x, o.y);
        unpack_word(a.y, o.z, o.w);
        *reinterpret_cast<uint4*>(dst + 16 * (size_t)j) = o;
      } else {
        const uint8_t* s = src + 8 * (size_t)j;
        int8_t* d = dst + 16 * (size_t)j;
        const long long left = n - 16LL * j;
        const int codes = (int)(left < 16 ? left : 16);
        for (int i = 0; i < codes; ++i) {
          const uint32_t byte = s[i >> 1];
          const uint32_t v = (i & 1) ? (byte >> 4) : (byte & 0xFu);
          d[i] = (int8_t)(uint8_t)sign_extend(v);
        }
      }
    }
  }
  allow_successor();
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

struct Plan {
  dim3 grid;
  int items, full;
};

// The grid for rows of n codes, `codes` to a work item.  Fails (false) when
// a row has too many items for 32-bit indices.
bool plan_for(long long rows, long long n, int codes, Plan* plan) {
  const long long items = ceil_div(n, codes);
  if (items > INT_MAX / 2) return false;
  plan->grid = dim3((unsigned)ceil_div(items, kThreads),
                    (unsigned)(rows < kMaxGridY ? rows : kMaxGridY));
  plan->items = (int)items;
  plan->full = (int)(n / codes);
  return true;
}

template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), const Plan& plan, void* stream, Args... args) {
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = plan.grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

extern "C" {

// codes (rows, n) int8 -> out (rows, ceil(n/2)) uint8.  Launches on
// `stream`; returns the launch's CUDA error (0 = launched).
int nibble_pack(const int8_t* q, uint8_t* out, long long rows, long long n, void* stream) {
  Plan plan;
  if (q == nullptr || out == nullptr || rows < 1 || n < 1 ||
      !plan_for(rows, n, 32, &plan))
    return (int)cudaErrorInvalidValue;
  return launch(pack_kernel, plan, stream, q, out, rows, n, (n + 1) / 2, plan.items,
                plan.full);
}

// bytes (rows, nb) uint8 -> out (rows, n) int8, n <= 2 nb.  Launches on
// `stream`; returns the launch's CUDA error (0 = launched).
int nibble_unpack(const uint8_t* p, int8_t* out, long long rows, long long nb, long long n,
                  void* stream) {
  Plan plan;
  if (p == nullptr || out == nullptr || rows < 1 || n < 1 || n > 2 * nb ||
      !plan_for(rows, n, 16, &plan))
    return (int)cudaErrorInvalidValue;
  return launch(unpack_kernel, plan, stream, p, out, rows, nb, n, plan.items, plan.full);
}

const char* quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
