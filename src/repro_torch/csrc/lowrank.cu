// The two tall-skinny products of one PowerSGD power-iteration step, for
// Hopper (sm_90a), float32:
//
//   project      P = M Q     M (B, n, m), Q (B, m, r) -> P (B, n, r)
//   backproject  Q = M^T P   M (B, n, m), P (B, n, r) -> Q (B, m, r)
//
// with 1 <= r <= 32 and the leading bucket dim B as a grid dimension.
//
// project replaces the Pallas kernels `_project_kernel` /
// `_project_kernel_batched` (src/repro/kernels/lowrank.py:33, :100);
// backproject replaces `_backproject_kernel` / `_backproject_kernel_batched`
// (src/repro/kernels/lowrank.py:67, :133).
//
// What bounds them: both read every element of M once and do 2r flops per
// element (r = 2 on the training path), so at ~1 flop per byte they are
// bound by device-memory bandwidth, far below the tensor cores' ridge.  The
// design therefore spends nothing on wgmma/TMA and everything on streaming
// M once with coalesced 16-byte loads while the skinny factor is staged in
// shared memory:
//
// * project: one warp per row (a few rows per warp for small r).  Lanes
//   walk the row in float4 steps, so a warp reads 512 contiguous bytes per
//   step; Q's rows for the current column chunk sit in shared memory and
//   are reused by every row of the block.  r accumulators per row live in
//   registers and are reduced with warp shuffles at the end.  The rank is
//   NOT padded to the TPU's 128 lanes: accumulators are padded only to the
//   next power of two (RP) and masked beyond r.
// * backproject: one thread per 4 adjacent columns, so neighbouring threads
//   read neighbouring addresses of each row; P's rows for the current row
//   chunk are staged in shared memory (every thread reads the same entry, a
//   broadcast).  The reduction runs over n.
//
// Filling 132 SMs: a bucket with few long rows (the LM head: n = 4096,
// m = 128256) gives project too few row blocks, and a bucket with few
// columns (the embedding: m = 4096, n = 128256) gives backproject too few
// column blocks.  Both kernels then split the reduced dimension across
// blocks (grid z), write per-split partial sums to a scratch buffer, and a
// second pass (`sum_splits`) adds the partials in split order.  No float
// atomics: results are identical from run to run on a given card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageFloats = 4096;  // 16 KB of shared memory per block
constexpr int kMinSplitRows = 128;  // backproject: rows per split, at least
constexpr int kWavesWanted = 4;     // blocks per SM before splitting stops

__host__ __device__ constexpr int rows_per_warp(int rp) {
  return rp <= 8 ? 4 : (rp == 16 ? 2 : 1);
}

__host__ __device__ constexpr int stage_rows(int rp) { return kStageFloats / rp; }

template <int VEC>
__device__ __forceinline__ void load_stream(const float* __restrict__ p, float* v) {
  if constexpr (VEC == 4) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __ldcs(p);
  }
}

// Stage rows [row0, row0 + rows) of a (len, r) row-major factor into
// shared memory as (stage_rows(RP), RP), zero-filled beyond r and rows.
template <int RP>
__device__ __forceinline__ void stage_factor(float* __restrict__ dst,
                                             const float* __restrict__ src,
                                             long long row0, int rows, int r) {
  for (int idx = threadIdx.x; idx < kStageFloats; idx += kThreads) {
    const int k = idx / RP, j = idx % RP;
    dst[idx] = (k < rows && j < r) ? src[(row0 + k) * r + j] : 0.f;
  }
}

// grid (ceil(n / rows per block), B, splits over m)
template <int RP, int VEC>
__global__ void __launch_bounds__(kThreads)
project_kernel(const float* __restrict__ M, const float* __restrict__ Q,
               float* __restrict__ out, int n, int m, int r, int cols_per_split) {
  constexpr int RW = rows_per_warp(RP);
  constexpr int CH = stage_rows(RP);
  __shared__ __align__(16) float qs[kStageFloats];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long b = blockIdx.y;
  const int row0 = (blockIdx.x * kWarps + warp) * RW;
  const int c_begin = blockIdx.z * cols_per_split;
  const int c_end = min(m, c_begin + cols_per_split);
  const float* Mb = M + b * n * (long long)m;
  const float* Qb = Q + b * m * (long long)r;

  float acc[RW][RP];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int j = 0; j < RP; ++j) acc[i][j] = 0.f;

  for (int c0 = c_begin; c0 < c_end; c0 += CH) {
    const int cols = min(CH, c_end - c0);
    __syncthreads();  // every warp is done with the previous chunk
    stage_factor<RP>(qs, Qb, c0, cols, r);
    __syncthreads();
    for (int k = lane * VEC; k < cols; k += 32 * VEC) {
      float q[VEC][RP];
#pragma unroll
      for (int t = 0; t < VEC; ++t)
#pragma unroll
        for (int j = 0; j < RP; ++j) q[t][j] = qs[(k + t) * RP + j];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int row = row0 + i;
        if (row < n) {
          float v[VEC];
          load_stream<VEC>(Mb + (long long)row * m + c0 + k, v);
#pragma unroll
          for (int t = 0; t < VEC; ++t)
#pragma unroll
            for (int j = 0; j < RP; ++j) acc[i][j] = fmaf(v[t], q[t][j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int j = 0; j < RP; ++j)
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], off);

  if (lane == 0) {
    float* o = out + ((long long)blockIdx.z * gridDim.y + b) * n * (long long)r;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int row = row0 + i;
      if (row < n) {
#pragma unroll
        for (int j = 0; j < RP; ++j)
          if (j < r) o[(long long)row * r + j] = acc[i][j];
      }
    }
  }
}

// grid (ceil(m / (threads * VEC)), B, splits over n)
template <int RP, int VEC>
__global__ void __launch_bounds__(kThreads)
backproject_kernel(const float* __restrict__ M, const float* __restrict__ P,
                   float* __restrict__ out, int n, int m, int r, int rows_per_split) {
  constexpr int RCH = stage_rows(RP);
  __shared__ __align__(16) float ps[kStageFloats];

  const long long b = blockIdx.y;
  const int col = (blockIdx.x * kThreads + threadIdx.x) * VEC;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = min(n, r_begin + rows_per_split);
  const bool active = col < m;
  const float* Mb = M + b * n * (long long)m;
  const float* Pb = P + b * n * (long long)r;

  float acc[VEC][RP];
#pragma unroll
  for (int t = 0; t < VEC; ++t)
#pragma unroll
    for (int j = 0; j < RP; ++j) acc[t][j] = 0.f;

  for (int i0 = r_begin; i0 < r_end; i0 += RCH) {
    const int rows = min(RCH, r_end - i0);
    __syncthreads();
    stage_factor<RP>(ps, Pb, i0, rows, r);
    __syncthreads();
    if (active) {
      const float* src = Mb + (long long)i0 * m + col;
#pragma unroll 4
      for (int k = 0; k < rows; ++k) {
        float v[VEC];
        load_stream<VEC>(src + (long long)k * m, v);
#pragma unroll
        for (int j = 0; j < RP; ++j) {
          const float p = ps[k * RP + j];
#pragma unroll
          for (int t = 0; t < VEC; ++t) acc[t][j] = fmaf(v[t], p, acc[t][j]);
        }
      }
    }
  }

  if (active) {
    float* o = out + ((long long)blockIdx.z * gridDim.y + b) * m * (long long)r;
#pragma unroll
    for (int t = 0; t < VEC; ++t)
#pragma unroll
      for (int j = 0; j < RP; ++j)
        if (j < r) o[(long long)(col + t) * r + j] = acc[t][j];
  }
}

// out[i] = sum over s in order of part[s * total + i]
__global__ void __launch_bounds__(kThreads)
sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                  int splits, long long total) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[k * total + i];
    out[i] = s;
  }
}

int rank_pad(int r) {
  int rp = 1;
  while (rp < r) rp *= 2;
  return rp;
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

int vec_width(int rp, int m, const float* M) {
  const bool aligned = m % 4 == 0 && reinterpret_cast<uintptr_t>(M) % 16 == 0;
  return (rp <= 8 && aligned) ? 4 : 1;
}

// How many blocks to split the reduced dimension over: enough for
// kWavesWanted blocks per SM, each split keeping at least `granule` of it.
int plan_splits(long long base_blocks, long long extent, long long granule, int sms) {
  const long long target = (long long)kWavesWanted * sms;
  if (base_blocks >= target) return 1;
  long long want = ceil_div(target, base_blocks);
  long long most = extent / granule;
  if (want > most) want = most;
  if (want > 65535) want = 65535;
  return want < 1 ? 1 : (int)want;
}

long long project_row_blocks(int n, int rp) {
  return ceil_div(n, (long long)kWarps * rows_per_warp(rp));
}

int project_cols_per_split(int m, int rp, int splits) {
  const long long ch = stage_rows(rp);
  return (int)(ceil_div(ceil_div(m, splits), ch) * ch);
}

long long backproject_col_blocks(int m, int vec) { return ceil_div(m, (long long)kThreads * vec); }

bool bad_args(int B, int n, int m, int r, int splits) {
  return B < 1 || B > 65535 || n < 1 || m < 1 || r < 1 || r > 32 || splits < 1 || splits > 65535;
}

int finish_splits(const float* part, float* out, int splits, long long total, int sms,
                  cudaStream_t stream) {
  if (splits > 1) {
    long long blocks = ceil_div(total, kThreads);
    if (blocks > 8LL * sms) blocks = 8LL * sms;
    sum_splits_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(part, out, splits, total);
  }
  return (int)cudaGetLastError();
}

template <int RP>
void launch_project(const float* M, const float* Q, float* dst, int B, int n, int m, int r,
                    int splits, cudaStream_t stream) {
  const dim3 grid((unsigned)project_row_blocks(n, RP), B, splits);
  const int cps = project_cols_per_split(m, RP, splits);
  if constexpr (RP <= 8) {
    if (vec_width(RP, m, M) == 4) {
      project_kernel<RP, 4><<<grid, kThreads, 0, stream>>>(M, Q, dst, n, m, r, cps);
      return;
    }
  }
  project_kernel<RP, 1><<<grid, kThreads, 0, stream>>>(M, Q, dst, n, m, r, cps);
}

template <int RP>
void launch_backproject(const float* M, const float* P, float* dst, int B, int n, int m, int r,
                        int splits, cudaStream_t stream) {
  const int vec = vec_width(RP, m, M);
  const dim3 grid((unsigned)backproject_col_blocks(m, vec), B, splits);
  const int rps = (int)ceil_div(n, splits);
  if constexpr (RP <= 8) {
    if (vec == 4) {
      backproject_kernel<RP, 4><<<grid, kThreads, 0, stream>>>(M, P, dst, n, m, r, rps);
      return;
    }
  }
  backproject_kernel<RP, 1><<<grid, kThreads, 0, stream>>>(M, P, dst, n, m, r, rps);
}

#define LOWRANK_DISPATCH(RPVAL, CALL) \
  switch (RPVAL) {                    \
    case 1: CALL(1); break;           \
    case 2: CALL(2); break;           \
    case 4: CALL(4); break;           \
    case 8: CALL(8); break;           \
    case 16: CALL(16); break;         \
    default: CALL(32); break;         \
  }

}  // namespace

extern "C" {

// Number of splits of the m columns project uses on a card with `sms` SMs.
int lowrank_project_splits(int B, int n, int m, int r, int sms) {
  if (bad_args(B, n, m, r, 1) || sms < 1) return 1;
  const int rp = rank_pad(r);
  const int ch = stage_rows(rp);
  const int want = plan_splits(project_row_blocks(n, rp) * B, m, ch, sms);
  return (int)ceil_div(m, project_cols_per_split(m, rp, want));
}

// Number of splits of the n rows backproject uses on a card with `sms` SMs.
int lowrank_backproject_splits(int B, int n, int m, int r, int sms) {
  if (bad_args(B, n, m, r, 1) || sms < 1) return 1;
  const int rp = rank_pad(r);
  const int vec = (rp <= 8 && m % 4 == 0) ? 4 : 1;
  return plan_splits(backproject_col_blocks(m, vec) * B, n, kMinSplitRows, sms);
}

// P = M Q.  `scratch` holds splits * B * n * r floats when splits > 1.
// Launches on `stream`; returns cudaGetLastError() (0 = launched).
int lowrank_project(const float* M, const float* Q, float* out, float* scratch, int B, int n,
                    int m, int r, int splits, int sms, void* stream) {
  if (bad_args(B, n, m, r, splits) || (splits > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? scratch : out;
#define CALL(RP) launch_project<RP>(M, Q, dst, B, n, m, r, splits, s)
  LOWRANK_DISPATCH(rank_pad(r), CALL)
#undef CALL
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return finish_splits(scratch, out, splits, (long long)B * n * r, sms, s);
}

// Q = M^T P.  `scratch` holds splits * B * m * r floats when splits > 1.
int lowrank_backproject(const float* M, const float* P, float* out, float* scratch, int B,
                        int n, int m, int r, int splits, int sms, void* stream) {
  if (bad_args(B, n, m, r, splits) || (splits > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? scratch : out;
#define CALL(RP) launch_backproject<RP>(M, P, dst, B, n, m, r, splits, s)
  LOWRANK_DISPATCH(rank_pad(r), CALL)
#undef CALL
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return finish_splits(scratch, out, splits, (long long)B * m * r, sms, s);
}

const char* lowrank_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
