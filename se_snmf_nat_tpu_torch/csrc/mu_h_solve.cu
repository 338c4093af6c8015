// Batched per-column KL H-only multiplicative-update solve (Hopper, sm_90a).
//
// Replaces the TPU kernel se_snmf_nat_tpu/kernels/mu_pallas.py:
// _h_solve_kernel / pallas_h_solve, with the per-column stop of
// se_snmf_nat_tpu/nmf/solver.py:snmf_h_solve_columns (each column freezes at
// its own relative-cost test; with conv_eps <= 0 every column runs max_iter
// trips and the cost is skipped).
//
// Problem, per lane b:  V (F, N), W (F, R), H0 (R, N)
//   W <- W / ||W||_col,  H <- H0 * ||W||_col,  dph = max(1'W + sparsity, flr)
//   each trip:  H <- H * W'(V / L) / dph  (active columns),  L = max(W H, flr)
//
// Design.  The Pallas kernel keeps a whole lane's W in VMEM; at the main
// path's F=513, R=200 that is 410 KB, above the 227 KB of shared memory a
// block may use.  Columns are independent problems, so one block takes one
// (lane, 16-column tile): V and U = V/L for the tile (2 x 513 x 16 f32) and
// H (200 x 16) live in shared memory (~79 KB), and W streams from L2 twice
// per trip, once in each layout so both products read it coalesced:
//   W'U:  one thread per row r of H, reads W[f][r] (neighbouring r) and the
//         16 values of U[f][:] as four float4 shared-memory broadcasts;
//   W H:  one thread per row f of L, reads W'[r][f] (neighbouring f) and
//         H[r][:] as four float4 broadcasts; the same thread forms U and the
//         KL cost terms of its row.
// A first entry kernel normalises each lane's W once into both layouts and
// computes dph.  Bound: each trip is 2*F*R*16 FMAs per block against
// shared-memory operands (the f32 FMA pipes and shared-memory bandwidth,
// not device memory: W is re-read from L2).
//
// No fast math: the relative-cost test relies on IEEE inf/NaN at trip 0
// (|cost - inf| / inf is NaN, and NaN < eps is false) and on an accurate
// logf.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TN = 16;         // columns per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void h_entry_kernel(const float* __restrict__ w,
                               float* __restrict__ wn_out,
                               float* __restrict__ w_n,
                               float* __restrict__ w_t,
                               float* __restrict__ dph,
                               int F, int R, float sparsity, float flr) {
  const int b = blockIdx.x;
  const float* wl = w + (size_t)b * F * R;
  float* wnl = w_n + (size_t)b * F * R;
  float* wtl = w_t + (size_t)b * R * F;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
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
}

// L = max(W H, flr) and U = V / L for the tile; with `cost`, each thread
// also returns its rows' KL terms per column in cpart.
__device__ __forceinline__ void lambda_pass(const float* __restrict__ wtl,
                                            const float* sV, float* sU,
                                            const float* sH, int F, int R,
                                            float flr, bool cost,
                                            float cpart[TN]) {
  for (int j = 0; j < TN; ++j) cpart[j] = 0.f;
  for (int f = threadIdx.x; f < F; f += THREADS) {
    float acc[TN];
    for (int j = 0; j < TN; ++j) acc[j] = 0.f;
    for (int r = 0; r < R; ++r) {
      const float wv = wtl[(size_t)r * F + f];
      const float4* hr = reinterpret_cast<const float4*>(sH + r * TN);
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
      const float vv = sV[f * TN + j];
      const float u = vv / lam;
      sU[f * TN + j] = u;
      if (cost) cpart[j] += vv * logf(u) - vv + lam;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
h_solve_kernel(const float* __restrict__ v, const float* __restrict__ w_n,
               const float* __restrict__ w_t, const float* __restrict__ h0,
               long long h0_lane_stride, const float* __restrict__ wn,
               const float* __restrict__ dph, float* __restrict__ h_out,
               int* __restrict__ trips_out, int F, int R, int N,
               int max_iter, float conv_eps, float sparsity, float flr) {
  extern __shared__ __align__(16) float smem[];
  float* sV = smem;                        // F * TN
  float* sU = sV + F * TN;                 // F * TN   V / L
  float* sH = sU + F * TN;                 // R * TN
  float* sRed = sH + R * TN;               // WARPS * TN
  float* sLast = sRed + WARPS * TN;        // TN
  int* sActive = reinterpret_cast<int*>(sLast + TN);   // TN
  int* sTrips = sActive + TN;              // TN
  int* sAny = sTrips + TN;                 // 1

  const int b = blockIdx.y;
  const int n0 = blockIdx.x * TN;
  const int tid = threadIdx.x;
  const float* vl = v + (size_t)b * F * N;
  const float* wnl = w_n + (size_t)b * F * R;
  const float* wtl = w_t + (size_t)b * R * F;
  const float* h0l = h0 + (size_t)b * h0_lane_stride;
  const float* normsl = wn + (size_t)b * R;
  const float* dphl = dph + (size_t)b * R;
  const bool early = conv_eps > 0.f;

  // tile entry: V floored; H rescaled by the column norms; columns past N
  // (the ragged last tile) get V=1, H=0 and stay inactive
  for (int e = tid; e < F * TN; e += THREADS) {
    const int f = e / TN, n = n0 + e % TN;
    sV[e] = n < N ? fmaxf(vl[(size_t)f * N + n], flr) : 1.f;
  }
  for (int e = tid; e < R * TN; e += THREADS) {
    const int r = e / TN, n = n0 + e % TN;
    sH[e] = n < N ? h0l[(size_t)r * N + n] * normsl[r] : 0.f;
  }
  if (tid < TN) {
    sActive[tid] = (n0 + tid < N) ? 1 : 0;
    sTrips[tid] = 0;
    sLast[tid] = INFINITY;
  }
  if (tid == 0) *sAny = 1;
  __syncthreads();
  float cpart[TN];
  lambda_pass(wtl, sV, sU, sH, F, R, flr, false, cpart);
  __syncthreads();

  for (int it = 0; it < max_iter; ++it) {
    if (early && *sAny == 0) break;
    if (tid < TN) sTrips[tid] += sActive[tid];
    // H <- H * W'U / dph on the active columns
    for (int r = tid; r < R; r += THREADS) {
      float acc[TN];
      for (int j = 0; j < TN; ++j) acc[j] = 0.f;
      for (int f = 0; f < F; ++f) {
        const float wv = wnl[(size_t)f * R + r];
        const float4* ur = reinterpret_cast<const float4*>(sU + f * TN);
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
        if (sActive[j]) sH[r * TN + j] = sH[r * TN + j] * acc[j] / d;
    }
    __syncthreads();
    lambda_pass(wtl, sV, sU, sH, F, R, flr, early, cpart);
    if (early) {
      const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float x = cpart[j];
        for (int off = 16; off > 0; off >>= 1)
          x += __shfl_down_sync(0xffffffffu, x, off);
        if (lane == 0) sRed[warp * TN + j] = x;
      }
      __syncthreads();
      if (tid < TN) {
        float div = 0.f;
        for (int k = 0; k < WARPS; ++k) div += sRed[k * TN + tid];
        float pen = 0.f;
        for (int r = 0; r < R; ++r) pen += sparsity * sH[r * TN + tid];
        const float cost = div + pen;
        const float rel = fabsf(cost - sLast[tid]) / fabsf(sLast[tid]);
        if (it > 0 && rel < conv_eps) sActive[tid] = 0;
        sLast[tid] = cost;
      }
      __syncthreads();
      if (tid == 0) {
        int any = 0;
        for (int j = 0; j < TN; ++j) any |= sActive[j];
        *sAny = any;
      }
    }
    __syncthreads();
  }

  float* hl = h_out + (size_t)b * R * N;
  for (int e = tid; e < R * TN; e += THREADS) {
    const int r = e / TN, n = n0 + e % TN;
    if (n < N) hl[(size_t)r * N + n] = sH[e];
  }
  if (tid < TN && n0 + tid < N) trips_out[(size_t)b * N + n0 + tid] = sTrips[tid];
}

}  // namespace

// C entry.  v (B,F,N), w (B,F,R), h0 (B,R,N) with lane stride h0_lane_stride
// (0 broadcasts one (R,N) start to every lane); outputs h (B,R,N) and the
// per-column trip counts (B,N); scratch wn, dph (B,R) and w_n, w_t (B,F,R).
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int mu_h_solve_lanes(const float* v, const float* w,
                                const float* h0, long long h0_lane_stride,
                                float* h, int* trips, float* wn, float* dph,
                                float* w_n, float* w_t, int B, int F, int R,
                                int N, int max_iter, float conv_eps,
                                float sparsity, float flr, void* stream) {
  if (B == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  h_entry_kernel<<<B, THREADS, 0, s>>>(w, wn, w_n, w_t, dph, F, R, sparsity,
                                       flr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * ((size_t)2 * F * TN + (size_t)R * TN
                                       + WARPS * TN + TN)
                      + sizeof(int) * (2 * TN + 1);
  err = cudaFuncSetAttribute(h_solve_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + TN - 1) / TN, B);
  h_solve_kernel<<<grid, THREADS, smem, s>>>(
      v, w_n, w_t, h0, h0_lane_stride, wn, dph, h, trips, F, R, N, max_iter,
      conv_eps, sparsity, flr);
  return (int)cudaGetLastError();
}
