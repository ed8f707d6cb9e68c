// The fused error-feedback apply of PowerSGD (Alg. 2 lines 11-13), for
// Hopper (sm_90a), float32:
//
//   delta  = P Q^T                  P (B, n, r), Q (B, m, r)
//   mom'   = lam * mom + delta      mom (B, n, m)
//   x'     = x - lr * (delta + mom')  x (B, n, m)
//
// for any r >= 1, with the batch dim B as a grid dimension.  x' and mom'
// go to new buffers.
//
// Replaces the Pallas kernel `_ef_apply_kernel` behind `_ef_apply_2d` and
// `ef_apply` (src/repro/kernels/ef_apply.py:25, :36, :71).
//
// What bounds it: x and mom are read once and x' and mom' written once,
// 16 bytes of device memory per element; P and Q add 4 (n + m) r bytes per
// matrix, negligible.  It does 2r + 5 flops per element, so at small r it
// is bound by bandwidth: over the 1,486,880,768 matrix entries of the
// full-width 2-layer Llama-3-8B that is 23.8 GB, about 7.1 ms at 3.35 TB/s.
//
// The design keeps delta out of device memory and moves each element of x
// and mom once.  The TPU kernel used (256 x 512) blocks, padded r to 128
// lanes and ran batches through jax.vmap; here a block of 256 threads owns
// one (16 x 256) tile of one batch item (blockIdx.y).  It stages its 16
// rows of P and 256 rows of Q in shared memory, r in chunks of 16 (Q
// transposed, so a warp reads 32 consecutive float4 of it), and each
// thread accumulates delta in registers for 4 rows x 4 adjacent columns
// (77 registers, no spills; every index into the accumulators is static).
// Only then does it read x and mom: a warp covers 512 contiguous bytes of
// a row with streaming 16-byte loads and stores.  Where m is not a multiple
// of 4 or a buffer is not 16-byte aligned, a thread walks its 4 columns
// one by one instead.  Offsets are 64-bit (the embedding slab alone has
// 525 M entries).  The momentum and parameter updates round as the plain
// PyTorch version does (one rounding per multiply and add, no fused
// multiply-add), so only delta's summation order differs from it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColThreads = 64;                       // threads across a tile row
constexpr int kRowGroups = kThreads / kColThreads;    // 4
constexpr int kVec = 4;                               // adjacent columns a thread owns
constexpr int kTileM = kColThreads * kVec;            // 256 columns
constexpr int kRowsPerThread = 4;
constexpr int kTileN = kRowGroups * kRowsPerThread;   // 16 rows
constexpr int kRankChunk = 16;                        // factor columns staged at a time

__device__ __forceinline__ float new_mom(float mom, float delta, float lam) {
  return __fadd_rn(__fmul_rn(lam, mom), delta);
}

__device__ __forceinline__ float new_x(float x, float delta, float nm, float lr) {
  return __fsub_rn(x, __fmul_rn(lr, __fadd_rn(delta, nm)));
}

// grid (tiles of one matrix, B); tile t covers rows (t / tiles_m) * kTileN
// and columns (t % tiles_m) * kTileM onward.
__global__ void __launch_bounds__(kThreads)
ef_apply_kernel(const float* __restrict__ x, const float* __restrict__ mom,
                const float* __restrict__ p, const float* __restrict__ q,
                float* __restrict__ x_out, float* __restrict__ mom_out,
                long long n, long long m, int r, long long tiles_m,
                float lr, float lam, bool vec) {
  __shared__ __align__(16) float ps[kTileN][kRankChunk];
  __shared__ __align__(16) float qs[kRankChunk][kTileM];

  const long long b = blockIdx.y;
  const long long tile = blockIdx.x;
  const long long row0 = (tile / tiles_m) * kTileN;
  const long long col0 = (tile % tiles_m) * kTileM;
  const int tx = threadIdx.x % kColThreads, ty = threadIdx.x / kColThreads;
  const float* pb = p + b * n * r;
  const float* qb = q + b * m * r;

  float acc[kRowsPerThread][kVec];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int c = 0; c < kVec; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < r; k0 += kRankChunk) {
    const int rc = min(kRankChunk, r - k0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int idx = threadIdx.x; idx < kTileN * rc; idx += kThreads) {
      const int i = idx / rc, k = idx - i * rc;
      const long long row = row0 + i;
      ps[i][k] = row < n ? pb[row * r + k0 + k] : 0.f;
    }
    for (int idx = threadIdx.x; idx < kTileM * rc; idx += kThreads) {
      const int k = idx / kTileM, j = idx - k * kTileM;
      const long long col = col0 + j;
      qs[k][j] = col < m ? qb[col * r + k0 + k] : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < rc; ++k) {
      const float4 qv = *reinterpret_cast<const float4*>(&qs[k][kVec * tx]);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float pv = ps[ty + kRowGroups * i][k];
        acc[i][0] = fmaf(pv, qv.x, acc[i][0]);
        acc[i][1] = fmaf(pv, qv.y, acc[i][1]);
        acc[i][2] = fmaf(pv, qv.z, acc[i][2]);
        acc[i][3] = fmaf(pv, qv.w, acc[i][3]);
      }
    }
  }

  const long long col = col0 + kVec * tx;
  if (col >= m) return;
  const long long base = b * n * m + col;
  if (vec) {  // m % 4 == 0 and every buffer 16-byte aligned: col + 4 <= m
    float4 xv[kRowsPerThread], mv[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const long long row = row0 + ty + kRowGroups * i;
      if (row < n) {
        xv[i] = __ldcs(reinterpret_cast<const float4*>(x + base + row * m));
        mv[i] = __ldcs(reinterpret_cast<const float4*>(mom + base + row * m));
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const long long row = row0 + ty + kRowGroups * i;
      if (row < n) {
        float4 nm, nx;
        nm.x = new_mom(mv[i].x, acc[i][0], lam);
        nm.y = new_mom(mv[i].y, acc[i][1], lam);
        nm.z = new_mom(mv[i].z, acc[i][2], lam);
        nm.w = new_mom(mv[i].w, acc[i][3], lam);
        nx.x = new_x(xv[i].x, acc[i][0], nm.x, lr);
        nx.y = new_x(xv[i].y, acc[i][1], nm.y, lr);
        nx.z = new_x(xv[i].z, acc[i][2], nm.z, lr);
        nx.w = new_x(xv[i].w, acc[i][3], nm.w, lr);
        __stcs(reinterpret_cast<float4*>(mom_out + base + row * m), nm);
        __stcs(reinterpret_cast<float4*>(x_out + base + row * m), nx);
      }
    }
  } else {
    const long long cols = m - col;  // columns of this thread inside the row
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const long long row = row0 + ty + kRowGroups * i;
      if (row >= n) break;
      const long long off = base + row * m;
#pragma unroll
      for (int c = 0; c < kVec; ++c) {  // static indices keep acc in registers
        if (c < cols) {
          const float nm = new_mom(mom[off + c], acc[i][c], lam);
          mom_out[off + c] = nm;
          x_out[off + c] = new_x(x[off + c], acc[i][c], nm, lr);
        }
      }
    }
  }
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// x, mom, x_out, mom_out (batch, n, m); p (batch, n, r); q (batch, m, r);
// all float32, contiguous, on one device.  Launches on `stream`; returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for sizes the
// grid cannot cover.
int ef_apply(const float* x, const float* mom, const float* p, const float* q,
             float* x_out, float* mom_out, long long batch, long long n, long long m,
             int r, float lr, float lam, void* stream) {
  if (!x || !mom || !p || !q || !x_out || !mom_out || batch < 1 || batch > 65535 ||
      n < 1 || m < 1 || r < 1)
    return (int)cudaErrorInvalidValue;
  const long long tiles_m = ceil_div(m, kTileM);
  const long long tiles = ceil_div(n, kTileN) * tiles_m;
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  const bool vec = m % kVec == 0 && aligned16(x) && aligned16(mom) && aligned16(x_out) &&
                   aligned16(mom_out);
  const dim3 grid((unsigned)tiles, (unsigned)batch);
  ef_apply_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, mom, p, q, x_out, mom_out, n, m, r, tiles_m, lr, lam, vec);
  return (int)cudaGetLastError();
}

const char* ef_apply_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
