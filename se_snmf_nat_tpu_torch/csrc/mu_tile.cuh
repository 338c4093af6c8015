// The per-column KL H-solve of one 16-column tile: the tile loop of the
// shared-dictionary H-solve (mu_h_cols.cu, one W for every column).  The
// per-lane H-solve (mu_h_solve.cu) has its own design.
//
// Problem of a tile:  V (F, TN), W (F, R), H (R, TN), columns independent.
//   W <- W / ||W||_col,  H <- H0 * ||W||_col,  dph = max(1'W + sparsity, flr)
//   each trip:  H <- H * W'(V / L) / dph  (active columns),  L = max(W H, flr)
// and each column freezes at its own relative-cost stop
// (se_snmf_nat_tpu/nmf/solver.py:snmf_h_solve_columns); with
// conv_eps <= 0 every column runs max_iter trips and the cost is skipped.
//
// Layout.  V and U = V/L (2 x F x TN f32) and H (R x TN) live in shared
// memory; W streams from L2 twice per trip, once in each layout so both
// products read it coalesced:
//   W'U:  one thread per row r of H, reads W[f][r] (neighbouring r) and the
//         16 values of U[f][:] as four float4 shared-memory broadcasts;
//   W H:  one thread per row f of L, reads W'[r][f] (neighbouring f) and
//         H[r][:] as four float4 broadcasts; the same thread forms U and the
//         KL cost terms of its row.
// Bound: each trip is 2*F*R*TN FMAs per block, one W value read from L2 for
// every 16 FMAs (both layouts of one shared W, 820 KB at F=513, R=200, stay
// L2-resident for every block); f32 FMA pipes and L2 latency, not device
// memory.  With one W per lane (B=64 lanes: 52.5 MB in both layouts, above
// the 50 MB L2) part of W would come from device memory.
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

constexpr int TN = 16;         // columns per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NORM_THREADS = 32;   // columns of W per normalisation block
constexpr size_t MAX_SMEM = 232448;   // 227 KB: a block's dynamic limit

// Dynamic shared memory of one tile.
inline size_t tile_smem_bytes(int F, int R) {
  return sizeof(float) * ((size_t)2 * F * TN + (size_t)R * TN + WARPS * TN
                          + TN)
         + sizeof(int) * (2 * TN + 1);
}

// Normalise each lane's W (F, R) once, into both layouts, with its column
// norms and dph.  Grid (ceil(R / NORM_THREADS), lanes), one thread per
// column of W.
__global__ void normalize_w_kernel(const float* __restrict__ w,
                                   float* __restrict__ wn_out,
                                   float* __restrict__ w_n,
                                   float* __restrict__ w_t,
                                   float* __restrict__ dph,
                                   int F, int R, float sparsity, float flr) {
  const int b = blockIdx.y;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float* wl = w + (size_t)b * F * R;
  float* wnl = w_n + (size_t)b * F * R;
  float* wtl = w_t + (size_t)b * R * F;
  float ss = 0.f;
  for (int f = 0; f < F; ++f) {
    const float x = wl[(size_t)f * R + r];
    ss += x * x;
  }
  const float norm = sqrtf(ss);
  const float safe = norm > 0.f ? norm : 1.f;
  float colsum = 0.f;
  for (int f = 0; f < F; ++f) {
    const float x = wl[(size_t)f * R + r] / safe;
    wnl[(size_t)f * R + r] = x;
    wtl[(size_t)r * F + f] = x;
    colsum += x;
  }
  wn_out[(size_t)b * R + r] = norm;
  dph[(size_t)b * R + r] = fmaxf(colsum + sparsity, flr);
}

inline cudaError_t normalize_w(const float* w, float* wn, float* w_n,
                               float* w_t, float* dph, int B, int F, int R,
                               float sparsity, float flr, cudaStream_t s) {
  dim3 grid((R + NORM_THREADS - 1) / NORM_THREADS, B);
  normalize_w_kernel<<<grid, NORM_THREADS, 0, s>>>(w, wn, w_n, w_t, dph, F,
                                                   R, sparsity, flr);
  return cudaGetLastError();
}

// The tile's shared memory, carved from the dynamic allocation.
struct Tile {
  float* sV;      // F * TN   V floored
  float* sU;      // F * TN   V / L
  float* sH;      // R * TN
  float* sRed;    // WARPS * TN
  float* sLast;   // TN
  int* sActive;   // TN
  int* sTrips;    // TN
  int* sAny;      // 1
};

__device__ __forceinline__ Tile carve(float* smem, int F, int R) {
  Tile t;
  t.sV = smem;
  t.sU = t.sV + F * TN;
  t.sH = t.sU + F * TN;
  t.sRed = t.sH + R * TN;
  t.sLast = t.sRed + WARPS * TN;
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
  for (int f = threadIdx.x; f < F; f += THREADS) {
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
    for (int r = tid; r < R; r += THREADS) {
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
        for (int k = 0; k < WARPS; ++k) div += t.sRed[k * TN + tid];
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

}  // namespace
