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
// behind `nibble_unpack` (:32, :77).
//
// What bounds them: a few integer operations per byte, so device-memory
// bandwidth, and at the training path's payload (under 2 MB) the launch
// itself.  The TPU kernels strided codes into even/odd halves on the host
// and padded them to 128 lanes; here the leading dims fold into rows, one
// launch covers every worker's payload, and each thread owns 16 packed
// bytes (32 codes) of one row: two 16-byte loads and one 16-byte store for
// pack, one load and two stores for unpack, with the nibbles shuffled in
// 32-bit words (`__byte_perm`).  A work item whose row start is not
// 16-byte aligned, or that holds the ragged end of a row, takes a byte loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 16;  // grid cap; threads stride over the rest

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

// One work item: packed bytes [16 j, 16 j + 16) of one row.
__global__ void __launch_bounds__(kThreads)
pack_kernel(const int8_t* __restrict__ q, uint8_t* __restrict__ out,
            long long rows, long long n, long long nb, long long items_per_row) {
  const long long total = rows * items_per_row;
  for (long long it = blockIdx.x * (long long)kThreads + threadIdx.x; it < total;
       it += (long long)gridDim.x * kThreads) {
    const long long row = it / items_per_row, j = it - row * items_per_row;
    const int8_t* src = q + row * n + 32 * j;
    uint8_t* dst = out + row * nb + 16 * j;
    if (32 * j + 32 <= n && aligned16(src) && aligned16(dst)) {
      const uint4 a = reinterpret_cast<const uint4*>(src)[0];
      const uint4 b = reinterpret_cast<const uint4*>(src)[1];
      uint4 o;
      o.x = pack_words(a.x, a.y);
      o.y = pack_words(a.z, a.w);
      o.z = pack_words(b.x, b.y);
      o.w = pack_words(b.z, b.w);
      *reinterpret_cast<uint4*>(dst) = o;
    } else {
      const long long left = n - 32 * j;  // codes of this row from src on
      const int bytes = (int)((left < 32 ? left + 1 : 32) / 2);
      for (int k = 0; k < bytes; ++k) {
        const uint32_t lo = (uint8_t)src[2 * k] & 0xFu;
        const uint32_t hi = 2 * k + 1 < left ? ((uint8_t)src[2 * k + 1] & 0xFu) : 0u;
        dst[k] = (uint8_t)(lo | (hi << 4));
      }
    }
  }
}

// One work item: codes [32 j, 32 j + 32) of one row (packed bytes from 16 j).
__global__ void __launch_bounds__(kThreads)
unpack_kernel(const uint8_t* __restrict__ p, int8_t* __restrict__ out,
              long long rows, long long nb, long long n, long long items_per_row) {
  const long long total = rows * items_per_row;
  for (long long it = blockIdx.x * (long long)kThreads + threadIdx.x; it < total;
       it += (long long)gridDim.x * kThreads) {
    const long long row = it / items_per_row, j = it - row * items_per_row;
    const uint8_t* src = p + row * nb + 16 * j;
    int8_t* dst = out + row * n + 32 * j;
    if (32 * j + 32 <= n && aligned16(src) && aligned16(dst)) {
      const uint4 a = *reinterpret_cast<const uint4*>(src);
      uint4 o0, o1;
      unpack_word(a.x, o0.x, o0.y);
      unpack_word(a.y, o0.z, o0.w);
      unpack_word(a.z, o1.x, o1.y);
      unpack_word(a.w, o1.z, o1.w);
      reinterpret_cast<uint4*>(dst)[0] = o0;
      reinterpret_cast<uint4*>(dst)[1] = o1;
    } else {
      const long long left = n - 32 * j;
      const int codes = (int)(left < 32 ? left : 32);
      for (int k = 0; k < codes; ++k) {
        const uint32_t byte = src[k >> 1];
        const uint32_t v = (k & 1) ? (byte >> 4) : (byte & 0xFu);
        dst[k] = (int8_t)(uint8_t)sign_extend(v);
      }
    }
  }
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

int grid_for(long long items, int sms) {
  const long long blocks = ceil_div(items, kThreads);
  const long long cap = (long long)(sms > 0 ? sms : 1) * kBlocksPerSm;
  return (int)(blocks < cap ? blocks : cap);
}

}  // namespace

extern "C" {

// codes (rows, n) int8 -> out (rows, ceil(n/2)) uint8.  Launches on
// `stream`; returns cudaGetLastError() (0 = launched).
int nibble_pack(const int8_t* q, uint8_t* out, long long rows, long long n, int sms,
                void* stream) {
  if (q == nullptr || out == nullptr || rows < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const long long nb = (n + 1) / 2;
  const long long items_per_row = ceil_div(nb, 16);
  pack_kernel<<<grid_for(rows * items_per_row, sms), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(q, out, rows, n, nb, items_per_row);
  return (int)cudaGetLastError();
}

// bytes (rows, nb) uint8 -> out (rows, n) int8, n <= 2 nb.  Launches on
// `stream`; returns cudaGetLastError() (0 = launched).
int nibble_unpack(const uint8_t* p, int8_t* out, long long rows, long long nb, long long n,
                  int sms, void* stream) {
  if (p == nullptr || out == nullptr || rows < 1 || n < 1 || n > 2 * nb)
    return (int)cudaErrorInvalidValue;
  const long long items_per_row = ceil_div(n, 32);
  unpack_kernel<<<grid_for(rows * items_per_row, sms), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(p, out, rows, nb, n, items_per_row);
  return (int)cudaGetLastError();
}

const char* quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
