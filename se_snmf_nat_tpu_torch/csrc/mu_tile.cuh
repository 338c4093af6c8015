// The L2-streaming path of the shared-dictionary per-column KL H-solve
// (mu_h_cols.cu): one block per 16-column tile, for the shapes whose slice
// of W does not fit in a block's shared memory (the exemplar width R=1000).
//
// Problem of a tile:  V (F, TN), W (F, R), H (R, TN), columns independent.
//   W <- W / ||W||_col,  H <- H0 * ||W||_col,  dph = max(1'W + sparsity, flr)
//   each trip:  H <- H * W'(V / L) / dph  (active columns),  L = max(W H, flr)
// and each column freezes at its own relative-cost stop
// (se_snmf_nat_tpu/nmf/solver.py:snmf_h_solve_columns); with
// conv_eps <= 0 every column runs max_iter trips and the cost is skipped.
// A tile stops when its last column stops.
//
// Layout.  W is normalised once by a first kernel into both layouts
// (L2-resident, shared by every block).  V and U = V/L (2 x F x TN f32) and
// H (R x TN) live in shared memory; W streams from L2 twice per trip, once
// in each layout so both products read it coalesced:
//   W'U:  one thread per row r of H, reads W[f][r] (neighbouring r) and the
//         16 values of U[f][:] as four float4 shared-memory broadcasts;
//   W H:  one thread per row f of L, reads W'[r][f] (neighbouring f) and
//         H[r][:] as four float4 broadcasts; the same thread forms U and the
//         KL cost terms of its row.
// The block's thread count follows the shape (stream_threads): the rows of
// F are spread evenly over the fewest rounds of at most 288 threads, so that
// no round runs a handful of threads (F=513: two rounds of 288 threads, not
// two of 256 and a third of one).
// Bound: each trip is 2*F*R*TN FMAs per block, one W value read from L2 for
// every 16 FMAs; f32 FMA pipes and L2 latency, not device memory.
//
// No fast math: the relative-cost test relies on IEEE inf/NaN at trip 0
// (|cost - inf| / inf is NaN, and NaN < eps is false) and on an accurate
// logf.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

// Everything here has internal linkage (the anonymous namespace): each
// source that includes it gets its own copy.
namespace {

constexpr int TN = 16;               // columns per block
constexpr int STREAM_MAX_THREADS = 288;
constexpr int NORM_THREADS = 32;     // columns of W per normalisation block
constexpr size_t MAX_SMEM = 232448;  // 227 KB: a block's dynamic limit

// Threads of a tile's block: the rows of F evenly over the fewest rounds of
// at most STREAM_MAX_THREADS, a multiple of 32, and no fewer than the rows
// of H need (up to the same maximum).
inline int stream_threads(int F, int R) {
  const int rounds = (F + STREAM_MAX_THREADS - 1) / STREAM_MAX_THREADS;
  int t = ((F + rounds - 1) / rounds + 31) & ~31;
  const int for_r = ((R < STREAM_MAX_THREADS ? R : STREAM_MAX_THREADS) + 31)
                    & ~31;
  if (t < for_r) t = for_r;
  return t < STREAM_MAX_THREADS ? t : STREAM_MAX_THREADS;
}

// Dynamic shared memory of one tile.
inline size_t tile_smem_bytes(int F, int R, int threads) {
  return sizeof(float) * ((size_t)2 * F * TN + (size_t)R * TN
                          + (threads / 32) * TN + TN)
         + sizeof(int) * (2 * TN + 1);
}

// Normalise W (F, R) once, into both layouts, with its column norms and
// dph.  Grid ceil(R / NORM_THREADS), one thread per column of W.
__global__ void normalize_w_kernel(const float* __restrict__ w,
                                   float* __restrict__ wn_out,
                                   float* __restrict__ w_n,
                                   float* __restrict__ w_t,
                                   float* __restrict__ dph,
                                   int F, int R, float sparsity, float flr) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float ss = 0.f;
  for (int f = 0; f < F; ++f) {
    const float x = w[(size_t)f * R + r];
    ss += x * x;
  }
  const float norm = sqrtf(ss);
  const float safe = norm > 0.f ? norm : 1.f;
  float colsum = 0.f;
  for (int f = 0; f < F; ++f) {
    const float x = w[(size_t)f * R + r] / safe;
    w_n[(size_t)f * R + r] = x;
    w_t[(size_t)r * F + f] = x;
    colsum += x;
  }
  wn_out[r] = norm;
  dph[r] = fmaxf(colsum + sparsity, flr);
}

// The tile's shared memory, carved from the dynamic allocation.
struct Tile {
  float* sV;      // F * TN   V floored
  float* sU;      // F * TN   V / L
  float* sH;      // R * TN
  float* sRed;    // warps * TN
  float* sLast;   // TN
  int* sActive;   // TN
  int* sTrips;    // TN
  int* sAny;      // 1
};

__device__ __forceinline__ Tile carve(float* smem, int F, int R) {
  const int warps = blockDim.x / 32;
  Tile t;
  t.sV = smem;
  t.sU = t.sV + F * TN;
  t.sH = t.sU + F * TN;
  t.sRed = t.sH + R * TN;
  t.sLast = t.sRed + warps * TN;
  t.sActive = reinterpret_cast<int*>(t.sLast + TN);
  t.sTrips = t.sActive + TN;
  t.sAny = t.sTrips + TN;
  return t;
}

// L = max(W H, flr) and U = V / L for the tile; with `cost`, each thread
// also returns its rows' KL terms per column in cpart.
__device__ __forceinline__ void lambda_pass(const float* __restrict__ wtl,
                                            const Tile& t, int F, int R,
                                            float flr, bool cost,
                                            float cpart[TN]) {
  for (int j = 0; j < TN; ++j) cpart[j] = 0.f;
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float acc[TN];
    for (int j = 0; j < TN; ++j) acc[j] = 0.f;
    for (int r = 0; r < R; ++r) {
      const float wv = wtl[(size_t)r * F + f];
      const float4* hr = reinterpret_cast<const float4*>(t.sH + r * TN);
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 hv = hr[q];
        acc[4 * q + 0] += wv * hv.x;
        acc[4 * q + 1] += wv * hv.y;
        acc[4 * q + 2] += wv * hv.z;
        acc[4 * q + 3] += wv * hv.w;
      }
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float lam = fmaxf(acc[j], flr);
      const float vv = t.sV[f * TN + j];
      const float u = vv / lam;
      t.sU[f * TN + j] = u;
      if (cost) cpart[j] += vv * logf(u) - vv + lam;
    }
  }
}

// The MU loop of one tile.  On entry t.sV and t.sH hold the floored V and
// the rescaled H0 (columns past n_valid: V=1, H=0); they become visible to
// every thread at the first barrier here.  Leaves H in t.sH and each
// column's trip count in t.sTrips; columns past n_valid stay inactive.
__device__ void solve_tile(const Tile& t, int n_valid,
                           const float* __restrict__ wnl,
                           const float* __restrict__ wtl,
                           const float* __restrict__ dphl, int F, int R,
                           int max_iter, float conv_eps, float sparsity,
                           float flr) {
  const int tid = threadIdx.x;
  const int threads = blockDim.x, warps = blockDim.x / 32;
  const bool early = conv_eps > 0.f;
  if (tid < TN) {
    t.sActive[tid] = tid < n_valid ? 1 : 0;
    t.sTrips[tid] = 0;
    t.sLast[tid] = INFINITY;
  }
  if (tid == 0) *t.sAny = 1;
  __syncthreads();
  float cpart[TN];
  lambda_pass(wtl, t, F, R, flr, false, cpart);
  __syncthreads();

  for (int it = 0; it < max_iter; ++it) {
    if (early && *t.sAny == 0) break;
    if (tid < TN) t.sTrips[tid] += t.sActive[tid];
    // H <- H * W'U / dph on the active columns
    for (int r = tid; r < R; r += threads) {
      float acc[TN];
      for (int j = 0; j < TN; ++j) acc[j] = 0.f;
      for (int f = 0; f < F; ++f) {
        const float wv = wnl[(size_t)f * R + r];
        const float4* ur = reinterpret_cast<const float4*>(t.sU + f * TN);
#pragma unroll
        for (int q = 0; q < TN / 4; ++q) {
          const float4 uv = ur[q];
          acc[4 * q + 0] += wv * uv.x;
          acc[4 * q + 1] += wv * uv.y;
          acc[4 * q + 2] += wv * uv.z;
          acc[4 * q + 3] += wv * uv.w;
        }
      }
      const float d = dphl[r];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (t.sActive[j]) t.sH[r * TN + j] = t.sH[r * TN + j] * acc[j] / d;
    }
    __syncthreads();
    lambda_pass(wtl, t, F, R, flr, early, cpart);
    if (early) {
      const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float x = cpart[j];
        for (int off = 16; off > 0; off >>= 1)
          x += __shfl_down_sync(0xffffffffu, x, off);
        if (lane == 0) t.sRed[warp * TN + j] = x;
      }
      __syncthreads();
      if (tid < TN) {
        float div = 0.f;
        for (int k = 0; k < warps; ++k) div += t.sRed[k * TN + tid];
        float pen = 0.f;
        for (int r = 0; r < R; ++r) pen += sparsity * t.sH[r * TN + tid];
        const float cost = div + pen;
        const float rel = fabsf(cost - t.sLast[tid]) / fabsf(t.sLast[tid]);
        if (it > 0 && rel < conv_eps) t.sActive[tid] = 0;
        t.sLast[tid] = cost;
      }
      __syncthreads();
      if (tid == 0) {
        int any = 0;
        for (int j = 0; j < TN; ++j) any |= t.sActive[j];
        *t.sAny = any;
      }
    }
    __syncthreads();
  }
}

// Element (i, j) of a strided matrix whose unit-stride axis is taken by
// neighbouring threads: e counts over rows*TN, row-major over the tile
// unless the row stride is 1.
__device__ __forceinline__ void tile_index(int e, int rows, bool rows_unit,
                                           int& i, int& j) {
  if (rows_unit) {
    j = e / rows;
    i = e - j * rows;
  } else {
    i = e / TN;
    j = e - i * TN;
  }
}

__global__ void __launch_bounds__(STREAM_MAX_THREADS)
h_cols_stream_kernel(const float* __restrict__ v, long long v_sf,
                     long long v_sn, const float* __restrict__ w_n,
                     const float* __restrict__ w_t,
                     const float* __restrict__ h0, long long h0_sr,
                     long long h0_sn, const float* __restrict__ wn,
                     const float* __restrict__ dph, float* __restrict__ h_out,
                     long long h_sr, long long h_sn,
                     int* __restrict__ trips_out,
                     unsigned long long* __restrict__ counts, int F, int R,
                     int N, int max_iter, float conv_eps, float sparsity,
                     float flr) {
  extern __shared__ __align__(16) float smem[];
  const Tile t = carve(smem, F, R);
  const int n0 = blockIdx.x * TN;
  const int tid = threadIdx.x, threads = blockDim.x;

  // tile entry: V floored; H rescaled by the column norms.  Columns past N
  // in the ragged last tile get V=1, H=0 and stay inactive.
  for (int e = tid; e < F * TN; e += threads) {
    int f, j;
    tile_index(e, F, v_sf == 1, f, j);
    const int n = n0 + j;
    t.sV[f * TN + j] = n < N ? fmaxf(v[f * v_sf + n * v_sn], flr) : 1.f;
  }
  for (int e = tid; e < R * TN; e += threads) {
    int r, j;
    tile_index(e, R, h0_sr == 1, r, j);
    const int n = n0 + j;
    t.sH[r * TN + j] = n < N ? h0[r * h0_sr + n * h0_sn] * wn[r] : 0.f;
  }
  solve_tile(t, N - n0, w_n, w_t, dph, F, R, max_iter, conv_eps, sparsity,
             flr);

  for (int e = tid; e < R * TN; e += threads) {
    int r, j;
    tile_index(e, R, h_sr == 1, r, j);
    const int n = n0 + j;
    if (n < N) h_out[r * h_sr + n * h_sn] = t.sH[r * TN + j];
  }
  if (tid < TN && n0 + tid < N) {
    const int k = t.sTrips[tid];
    trips_out[n0 + tid] = k;
    if (counts != nullptr) {
      atomicAdd(counts, 1ULL);
      atomicAdd(counts + 1, (unsigned long long)k);
    }
  }
}

// The streaming path's two launches: W normalised into the scratch buffers
// (wn, dph (R,); w_n, w_t (F*R)), then one block per 16-column tile, each
// column adding 1 and its trips to `counts` (2,) unless it is null (an
// atomic a column where its trip count is written: a sum a tile by one
// thread cost the solve 4 registers and ~13% at R=1000 on the H100).
inline int stream_solve(const float* v, long long v_sf, long long v_sn,
                        const float* w, const float* h0, long long h0_sr,
                        long long h0_sn, float* h, long long h_sr,
                        long long h_sn, int* trips,
                        unsigned long long* counts, float* wn, float* dph,
                        float* w_n, float* w_t, int F, int R, int N,
                        int max_iter, float conv_eps, float sparsity,
                        float flr, int threads, size_t smem, cudaStream_t s) {
  normalize_w_kernel<<<(R + NORM_THREADS - 1) / NORM_THREADS, NORM_THREADS, 0,
                       s>>>(w, wn, w_n, w_t, dph, F, R, sparsity, flr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(h_cols_stream_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  h_cols_stream_kernel<<<(N + TN - 1) / TN, threads, smem, s>>>(
      v, v_sf, v_sn, w_n, w_t, h0, h0_sr, h0_sn, wn, dph, h, h_sr, h_sn,
      trips, counts, F, R, N, max_iter, conv_eps, sparsity, flr);
  return (int)cudaGetLastError();
}

}  // namespace
