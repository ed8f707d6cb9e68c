// The two tall-skinny products of one PowerSGD power-iteration step, for
// Hopper (sm_90a), float32:
//
//   project      P = M Q     M (B, n, m), Q (B, m, r) -> P (B, n, r)
//   backproject  Q = M^T P   M (B, n, m), P (B, n, r) -> Q (B, m, r)
//
// with 1 <= r <= 32.  project replaces the Pallas kernels `_project_kernel`
// / `_project_kernel_batched` (src/repro/kernels/lowrank.py:33, :100);
// backproject replaces `_backproject_kernel` / `_backproject_kernel_batched`
// (src/repro/kernels/lowrank.py:67, :133).
//
// What bounds them: both read every element of M once and do 2r flops per
// element, about 1 flop per byte at r = 2, far below the tensor cores'
// ridge (295 bf16 flops a byte; fp32 outside them, 20).  So there is no
// wgmma here: a tensor-core product would wait on the same bytes.  A large
// slab is bound by the bytes of M: stream them once with coalesced loads
// and keep enough in flight.  A small slab (the benchmark LM's hold a few
// MB, which 132 SMs read in about one memory latency) is bound by latency:
// a launch, and the number of memory round trips one after another.
//
// * One launch per call: a 1-D grid of tiles x cluster CTAs.  Where the
//   reduced dimension has to be split across CTAs, the CTAs of one
//   thread-block cluster share a tile of the kept dimension and split the
//   reduced one; each leaves its partial sums in its shared memory, and
//   after cluster.sync() rank k adds the partials of every rank, in rank
//   order, for its share of the tile (distributed shared memory,
//   map_shared_rank) and writes the result.  No scratch buffer, no second
//   kernel, no atomics: two calls give the same bits.  A cluster launch
//   costs more than a plain one, which a small slab feels, so the plans
//   split only where a CTA would otherwise stream far more than its share,
//   and a cluster of one is launched as a plain grid.
// * backproject: a CTA owns a strip of columns, `lpr` lanes (8, 16 or 32)
//   to a row, so one warp-wide load covers 32 / lpr rows; each of the 8
//   warps reads other rows, 4 rows a lane in flight, 16 bytes each (where
//   rows are not aligned, or r > 8, words lpr columns apart).  P's entries
//   for those rows are loaded beside them.  Partials are summed across the
//   rows of a warp (shuffles), across the warps (shared memory, warp
//   order), then across the cluster.  Narrow strips give small slabs many
//   CTAs without a cluster.
// * project: a CTA owns 1 to 32 rows and its cluster rank's run of
//   columns; its warps each take up to 4 rows, or share a row set 2, 4 or
//   8 ways and take every 2nd, 4th or 8th 128-column step.  A lane reads 4
//   columns a step (one float4, or 4 words 32 apart where rows are not
//   aligned) and has 4 such loads in flight: 4 rows, or 2 rows x 2 steps,
//   or 1 row x 4 steps, whatever the warp's share of rows.  Q for the run
//   goes to shared memory in windows of 4096 floats, transposed (no bank
//   conflicts), through cp.async, double buffered, so the stream of M
//   waits only at one barrier per window; the first loads of M go out
//   before the first window has landed.  Per row, window and warp, the
//   lanes' partial dots are summed with shuffles into the CTA's partial
//   row in shared memory, and summed over the warps sharing a row in a
//   fixed order at the end.
// * Rows that are not 16-byte aligned (m % 4 != 0, or an offset view) are
//   read as words, each warp-wide load a contiguous run of 32 per row
//   (backproject keeps 32 lanes to a row for such rows unless the slab is
//   small).  At the large slabs, measured on an H100, that costs project a
//   few per cent of rate against the float4 path and backproject up to a
//   fifth; no main path has such rows.  A realigning float4 load (the
//   aligned float4 holding a lane's first column plus the next lane's,
//   shuffled, selected by the row's shift) measured slower than words at
//   every shape tried.
// * The launch plan (vector width, tile, warps to a row or lanes to a row,
//   cluster size, reduced extent per rank, window) is computed by the
//   wrapper (src/repro_torch/kernels/lowrank.py) as a pure function of the
//   shape, the rank, the SM count and M's alignment, and checked here; an
//   inconsistent plan is refused with cudaErrorInvalidValue.  Clusters
//   hold at most 8 CTAs, the portable limit; a refused launch is returned,
//   never retried smaller.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStep = 128;           // project: columns a warp covers per step
constexpr int kWindowFloats = 4096;  // project: floats of Q per staging buffer
constexpr int kMaxTile = 32;         // project: rows x column warps per CTA, at most
constexpr int kClusterMax = 8;       // the portable cluster limit

// project: 16-byte loads a lane has in flight (registers: slots x r accumulators)
__host__ __device__ constexpr int load_slots(int rp) { return rp <= 8 ? 4 : (rp == 16 ? 2 : 1); }

// backproject: columns a lane owns (registers: columns x r accumulators)
__host__ __device__ constexpr int lane_cols(int rp) { return rp <= 8 ? 4 : 32 / rp; }

__host__ __device__ constexpr int min_blocks(int rp) { return rp <= 4 ? 4 : 2; }

// 4-byte asynchronous copy global -> shared; zero-fills when !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// Stage Q rows [c0, c0 + cols) transposed, as RP rows of `window` floats
// (zero beyond r), so that lanes reading adjacent columns of one factor
// column read adjacent words: no bank conflicts.
template <int RP>
__device__ __forceinline__ void stage_window(float* __restrict__ dst, const float* __restrict__ Qb,
                                             int c0, int cols, int r, int window) {
  for (int e = threadIdx.x; e < cols * RP; e += kThreads) {
    const int k = e / RP, j = e % RP;  // RP is a power of two: shifts
    const bool ok = j < r;
    cp_async4(dst + j * window + k, Qb + (long long)(c0 + k) * r + (ok ? j : 0), ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The 4 columns of a 128-column step (from column k0 of the window) that a
// lane owns: VEC = 4, k0 + 4 lane + t (one 16-byte load); VEC = 1,
// k0 + lane + 32 t.  Columns at or past `cols` read as 0.
template <int VEC>
__device__ __forceinline__ void load_step(const float* __restrict__ row, int k0, int lane, int cols,
                                          float v[4]) {
  if constexpr (VEC == 4) {
    const int c = k0 + lane * 4;
    if (c < cols) {
      const float4 t = __ldcs(reinterpret_cast<const float4*>(row + c));
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int c = k0 + lane + 32 * t;
      v[t] = c < cols ? __ldcs(row + c) : 0.f;
    }
  }
}

// 1-D grid of row_tiles * B tiles, `cluster` CTAs each.  A CTA owns rows
// [row0, row0 + tile) of batch item b and columns [rank * extent, + extent).
// Its warps form kWarps / wc row groups of tile * wc / kWarps rows each; the
// wc warps of a group take every wc-th step of the columns.
template <int RP, int VEC>
__global__ void __launch_bounds__(kThreads, min_blocks(RP))
project_kernel(const float* __restrict__ M, const float* __restrict__ Q, float* __restrict__ out,
               int n, int m, int r, int tile, int wc, int extent, int window, int row_tiles) {
  constexpr int SL = load_slots(RP);  // loads in flight per lane
  extern __shared__ __align__(16) float smem[];
  float* sums = smem;                  // (wc, tile, RP): this CTA's partial P
  float* qbuf = smem + wc * tile * RP; // 1 or 2 windows of (RP, window)

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long t = blockIdx.x / cs;
  const long long b = t / row_tiles;
  const int row0 = (int)(t % row_tiles) * tile;
  const int rpw = tile * wc / kWarps;  // rows of this CTA per warp
  const int cw = warp % wc;            // the warp's share of the steps
  const int G = min(SL, rpw);          // rows read together
  const int S = SL / G;                // steps of each read together
  const int c_begin = rank * extent;
  const int c_end = min(m, c_begin + extent);
  const int nwin = (c_end - c_begin + window - 1) / window;
  const float* Mb = M + b * n * (long long)m;
  const float* Qb = Q + b * m * (long long)r;

  // The warp reads its rows G at a time and S = SL / G steps of each at a
  // time: load slot j is row g + j / S at step k0 + (j % S) * kStep, so
  // every slot has a load in flight however few rows the warp has.
  const float* src[SL];
  int koff[SL];
  bool live[SL];
  auto rows_of = [&](int g, int c0) {
#pragma unroll
    for (int j = 0; j < SL; ++j) {
      const int row = row0 + warp / wc * rpw + g + j / S;
      live[j] = j < G * S && g + j / S < rpw && row < n;
      koff[j] = (j % S) * kStep;
      src[j] = Mb + (long long)(live[j] ? row : 0) * m + c0 + koff[j];
    }
  };
  float v[SL][4];
  auto load_slots = [&](int k0, int cols) {
#pragma unroll
    for (int j = 0; j < SL; ++j) {
      if (live[j]) {
        load_step<VEC>(src[j], k0, lane, cols - koff[j], v[j]);
      } else {
        v[j][0] = v[j][1] = v[j][2] = v[j][3] = 0.f;
      }
    }
  };

  for (int e = threadIdx.x; e < wc * tile * RP; e += kThreads) sums[e] = 0.f;
  stage_window<RP>(qbuf, Qb, c_begin, min(window, c_end - c_begin), r, window);
  // the first loads of M go out while the first window of Q is on its way
  const int k_first = cw * S * kStep;
  rows_of(0, c_begin);
  load_slots(k_first, min(window, c_end - c_begin));
  bool loaded = true;

  for (int w = 0; w < nwin; ++w) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // window w is in place; every warp is done with window w - 1
    const int c0 = c_begin + w * window;
    const int cols = min(window, c_end - c0);
    if (w + 1 < nwin)
      stage_window<RP>(qbuf + ((w + 1) & 1) * window * RP, Qb, c0 + window,
                       min(window, c_end - c0 - window), r, window);
    const float* qs = qbuf + (w & 1) * window * RP;

    for (int g = 0; g < rpw; g += G) {
      const int lr = warp / wc * rpw + g;  // first local row of this group
      if (!loaded) rows_of(g, c0);
      float acc[SL][RP];
#pragma unroll
      for (int j = 0; j < SL; ++j)
#pragma unroll
        for (int i = 0; i < RP; ++i) acc[j][i] = 0.f;

      for (int k0 = k_first; k0 < cols; k0 += wc * S * kStep) {
        if (!loaded) load_slots(k0, cols);
        loaded = false;
#pragma unroll
        for (int j = 0; j < SL; ++j) {
          const int c = koff[j] + k0 + (VEC == 4 ? lane * 4 : lane);
          if constexpr (VEC == 4) {
            if (live[j] && c < cols) {
#pragma unroll
              for (int i = 0; i < RP; ++i) {
                const float4 q = *reinterpret_cast<const float4*>(qs + i * window + c);
                acc[j][i] = fmaf(v[j][0], q.x, acc[j][i]);
                acc[j][i] = fmaf(v[j][1], q.y, acc[j][i]);
                acc[j][i] = fmaf(v[j][2], q.z, acc[j][i]);
                acc[j][i] = fmaf(v[j][3], q.w, acc[j][i]);
              }
            }
          } else {
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              if (live[j] && c + 32 * t < cols) {
#pragma unroll
                for (int i = 0; i < RP; ++i)
                  acc[j][i] = fmaf(v[j][t], qs[i * window + c + 32 * t], acc[j][i]);
              }
            }
          }
        }
      }

      loaded = false;
      // each row: its slots in slot order, then across the lanes
#pragma unroll
      for (int i = 0; i < SL; ++i) {
        if (i < G) {
          float tot[RP];
#pragma unroll
          for (int k = 0; k < RP; ++k) tot[k] = 0.f;
#pragma unroll
          for (int j = 0; j < SL; ++j)
            if (j / S == i)
#pragma unroll
              for (int k = 0; k < RP; ++k) tot[k] += acc[j][k];
#pragma unroll
          for (int k = 0; k < RP; ++k)
#pragma unroll
            for (int off = 16; off > 0; off /= 2)
              tot[k] += __shfl_xor_sync(0xffffffffu, tot[k], off);
          if (lane == 0 && g + i < rpw && row0 + lr + i < n)
#pragma unroll
            for (int k = 0; k < RP; ++k) sums[(cw * tile + lr + i) * RP + k] += tot[k];
        }
      }
    }
  }

  // Every rank's partial rows are complete; rank k sums its share of them
  // over the ranks in rank order, and within a rank over its warps' shares
  // of the steps in order.
  cluster.sync();
  const int total = tile * RP;
  const int per = (total + cs - 1) / cs;
  const int e_end = min(total, (rank + 1) * per);
  for (int e = rank * per + threadIdx.x; e < e_end; e += kThreads) {
    const int row = row0 + e / RP, j = e % RP;
    if (row < n && j < r) {
      float s = 0.f;
      for (int k = 0; k < cs; ++k) {
        const float* part = cluster.map_shared_rank(sums, k);
        for (int c = 0; c < wc; ++c) s += part[c * total + e];
      }
      out[(b * n + row) * r + j] = s;
    }
  }
  cluster.sync();  // no CTA leaves while another still reads its shared memory
}

// 1-D grid of strips * B tiles, `cluster` CTAs each.  A CTA owns a strip of
// lpr * CPL columns of batch item b and rows [rank * extent, + extent).
// `lpr` lanes (8, 16 or 32) read one row's part of the strip, so a warp
// reads 32 / lpr rows at a time.  A lane owns CPL of the strip's columns:
// 4 adjacent ones read as one float4 (VEC = 4), or ones lpr apart read as
// words (VEC = 1).
template <int RP, int VEC>
__global__ void __launch_bounds__(kThreads, min_blocks(RP))
backproject_kernel(const float* __restrict__ M, const float* __restrict__ P,
                   float* __restrict__ out, int n, int m, int r, int extent, int strips,
                   int lpr) {
  constexpr int CPL = lane_cols(RP);
  static_assert(VEC == 1 || VEC == CPL, "16-byte loads need 4 columns a lane");
  constexpr int U = 16 / CPL;      // load slots: rows a lane has in flight
  constexpr int E = 32 * CPL * RP; // partial sums per warp, at most
  constexpr bool kHoldP = U * RP <= 32;  // P's entries loaded beside M's
  __shared__ __align__(16) float red[kWarps * E];

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int seg = lane % lpr;      // the lane's place in its row's part
  const int rpi = 32 / lpr;        // rows one warp-wide load covers
  const int sw = lpr * CPL;        // strip width
  const long long t = blockIdx.x / cs;
  const long long b = t / strips;
  const int col0 = (int)(t % strips) * sw;
  const int r_begin = rank * extent;
  const int r_end = min(n, r_begin + extent);
  const float* Mb = M + b * n * (long long)m;
  const float* Pb = P + b * n * (long long)r;
  // strip offset of the lane's s-th column
  auto own = [seg, lpr](int s) { return VEC == 4 ? seg * 4 + s : seg + lpr * s; };

  float acc[CPL][RP];
#pragma unroll
  for (int s = 0; s < CPL; ++s)
#pragma unroll
    for (int j = 0; j < RP; ++j) acc[s][j] = 0.f;

  for (int row = r_begin + warp * rpi + lane / lpr; row < r_end + lane / lpr;
       row += kWarps * rpi * U) {
    float v[U][CPL];
    float p[kHoldP ? U : 1][RP];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = row + u * kWarps * rpi;
      const bool live = i < r_end;
      const float* src = Mb + (long long)(live ? i : 0) * m + col0;
      if constexpr (VEC == 4) {
        if (live && col0 + own(0) < m) {
          const float4 x = __ldcs(reinterpret_cast<const float4*>(src + own(0)));
          v[u][0] = x.x; v[u][1] = x.y; v[u][2] = x.z; v[u][3] = x.w;
        } else {
          v[u][0] = v[u][1] = v[u][2] = v[u][3] = 0.f;
        }
      } else {
#pragma unroll
        for (int s = 0; s < CPL; ++s)
          v[u][s] = live && col0 + own(s) < m ? __ldcs(src + own(s)) : 0.f;
      }
      if constexpr (kHoldP) {
#pragma unroll
        for (int j = 0; j < RP; ++j)
          p[u][j] = live && j < r ? __ldg(Pb + (long long)i * r + j) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = row + u * kWarps * rpi;
#pragma unroll
      for (int j = 0; j < RP; ++j) {
        float pj;
        if constexpr (kHoldP) {
          pj = p[u][j];
        } else {
          pj = i < r_end && j < r ? __ldg(Pb + (long long)i * r + j) : 0.f;
        }
#pragma unroll
        for (int s = 0; s < CPL; ++s) acc[s][j] = fmaf(v[u][s], pj, acc[s][j]);
      }
    }
  }

  // across the rows a warp reads at once, then across the warps in warp
  // order, into warp 0's slot
  for (int off = lpr; off < 32; off *= 2)
#pragma unroll
    for (int s = 0; s < CPL; ++s)
#pragma unroll
      for (int j = 0; j < RP; ++j) acc[s][j] += __shfl_xor_sync(0xffffffffu, acc[s][j], off);
  if (lane < lpr)
#pragma unroll
    for (int s = 0; s < CPL; ++s)
#pragma unroll
      for (int j = 0; j < RP; ++j) red[warp * E + own(s) * RP + j] = acc[s][j];
  __syncthreads();
  const int e_all = sw * RP;
  for (int e = threadIdx.x; e < e_all; e += kThreads) {
    float s = red[e];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w * E + e];
    red[e] = s;
  }

  // across the cluster, in rank order: rank k writes its share of the strip
  cluster.sync();
  const int per = (e_all + cs - 1) / cs;
  const int e_end = min(e_all, (rank + 1) * per);
  for (int e = rank * per + threadIdx.x; e < e_end; e += kThreads) {
    const int c = col0 + e / RP, j = e % RP;
    if (c < m && j < r) {
      float s = 0.f;
      for (int k = 0; k < cs; ++k) s += cluster.map_shared_rank(red, k)[e];
      out[(b * m + c) * r + j] = s;
    }
  }
  cluster.sync();  // no CTA leaves while another still reads its shared memory
}

int rank_pad(int r) {
  int rp = 1;
  while (rp < r) rp *= 2;
  return rp;
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// `extent` cuts `len` into `cluster` runs, none of them empty
bool bad_split(int len, int cluster, int extent) {
  return extent < 1 || (long long)cluster * extent < len || (long long)(cluster - 1) * extent >= len;
}

bool bad_common(const float* M, const float* F, const float* out, int B, int n, int m, int r,
                int vec, int cluster) {
  return !M || !F || !out || B < 1 || n < 1 || m < 1 || r < 1 || r > 32 ||
         !(vec == 1 || vec == 4) || cluster < 1 || cluster > kClusterMax ||
         (vec == 4 && (m % 4 != 0 || reinterpret_cast<uintptr_t>(M) % 16 != 0));
}

// One launch of `kernel` on a 1-D grid of `ctas` CTAs in clusters of
// `cluster`; returns the launch's error (0 = launched).
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), long long ctas, int cluster, size_t smem,
           cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;  // a lone CTA launches without one
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

template <int RP>
int project_rp(const float* M, const float* Q, float* out, int B, int n, int m, int r, int vec,
               int tile, int wc, int cluster, int extent, int window, cudaStream_t s) {
  const long long row_tiles = ceil_div(n, tile);
  const long long ctas = row_tiles * B * cluster;
  if (ctas > INT_MAX || window * RP > kWindowFloats) return (int)cudaErrorInvalidValue;
  const int nbuf = extent > window ? 2 : 1;
  const size_t smem = sizeof(float) * ((size_t)wc * tile * RP + (size_t)nbuf * window * RP);
  if (vec == 4)
    return launch(project_kernel<RP, 4>, ctas, cluster, smem, s, M, Q, out, n, m, r, tile, wc,
                  extent, window, (int)row_tiles);
  return launch(project_kernel<RP, 1>, ctas, cluster, smem, s, M, Q, out, n, m, r, tile, wc,
                extent, window, (int)row_tiles);
}

template <int RP>
int backproject_rp(const float* M, const float* P, float* out, int B, int n, int m, int r,
                   int vec, int lpr, int cluster, int extent, cudaStream_t s) {
  const long long strips = ceil_div(m, (long long)lpr * lane_cols(RP));
  const long long ctas = strips * B * cluster;
  if (ctas > INT_MAX) return (int)cudaErrorInvalidValue;
  if constexpr (RP <= 8) {
    if (vec == 4)
      return launch(backproject_kernel<RP, 4>, ctas, cluster, 0, s, M, P, out, n, m, r, extent,
                    (int)strips, lpr);
  }
  return launch(backproject_kernel<RP, 1>, ctas, cluster, 0, s, M, P, out, n, m, r, extent,
                (int)strips, lpr);
}

#define LOWRANK_DISPATCH(RPVAL, CALL) \
  switch (RPVAL) {                    \
    case 1: return CALL(1);           \
    case 2: return CALL(2);           \
    case 4: return CALL(4);           \
    case 8: return CALL(8);           \
    case 16: return CALL(16);         \
    default: return CALL(32);         \
  }

}  // namespace

extern "C" {

// P = M Q under the launch plan (vec, tile, wc, cluster, extent, window):
// CTAs of `tile` rows whose warps read them in groups of `wc` warps,
// `cluster` CTAs per tile splitting the m columns into runs of `extent`, Q
// staged `window` columns at a time.  Launches on `stream`; returns the
// CUDA error of the launch (0 = launched).
int lowrank_project(const float* M, const float* Q, float* out, int B, int n, int m, int r, int vec,
                    int tile, int wc, int cluster, int extent, int window, void* stream) {
  if (bad_common(M, Q, out, B, n, m, r, vec, cluster) || bad_split(m, cluster, extent) ||
      !(wc == 1 || wc == 2 || wc == 4 || wc == 8) || tile < 1 || tile * wc > kMaxTile ||
      tile * wc % kWarps != 0 || window < 1 ||
      (vec == 4 && (extent % 4 != 0 || window % 4 != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(RP) project_rp<RP>(M, Q, out, B, n, m, r, vec, tile, wc, cluster, extent, window, s)
  LOWRANK_DISPATCH(rank_pad(r), CALL)
#undef CALL
}

// Q = M^T P under the launch plan (vec, lpr, cluster, extent): strips of
// lpr * lane_cols(r) columns, `lpr` lanes to a row, `cluster` CTAs per strip
// splitting the n rows into runs of `extent`.
int lowrank_backproject(const float* M, const float* P, float* out, int B, int n, int m, int r,
                        int vec, int lpr, int cluster, int extent, void* stream) {
  if (bad_common(M, P, out, B, n, m, r, vec, cluster) || bad_split(n, cluster, extent) ||
      (vec == 4 && rank_pad(r) > 8) || !(lpr == 8 || lpr == 16 || lpr == 32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(RP) backproject_rp<RP>(M, P, out, B, n, m, r, vec, lpr, cluster, extent, s)
  LOWRANK_DISPATCH(rank_pad(r), CALL)
#undef CALL
}

const char* lowrank_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
