// Batched KL W-only multiplicative-update solve with H fixed (Hopper,
// sm_90a): the block-adaptive plan's per-block dictionary refit.
//
// Replaces the TPU kernel se_snmf_nat_tpu/kernels/mu_pallas.py:
// _w_solve_kernel / pallas_w_solve, and adds the per-lane `active` flag of
// se_snmf_nat_tpu/nmf/solver.py:snmf_solve (an inactive lane runs zero trips
// and returns its entry-normalised w0).
//
// Problem, per lane b:  V (F, M), W0 (F, R), H (R, M); masked columns arrive
// zeroed in W0 and in the rows of H, and stay zero.
//   entry:  W <- W0 / ||W0||_col,  H <- H * ||W0||_col,  sumh = H 1
//   each trip (L = max(W H, flr), U = V / max(L, flr)):
//     C = U H'                          corr_p = 1'(C * W)
//     W <- W * (C + (sumh * 1'W) W) / max(sumh + corr_p W, flr)
//     W <- W / ||W||_col
//     cost = sum(V log(V/L) - V + L) + sparsity * sum(H);  stop when the
//     relative change is below conv_eps (from the second trip on)
//
// Design.  The per-trip column reductions over F (corr_p, 1'W, the column
// norms) and the scalar cost span the whole lane, so one block takes one
// lane and loops over the trips; there is no cross-block reduction and no
// second launch per trip.  H (R x M, 20 KB at the main path's 50 x 100) is
// held in shared memory in both layouts; W lives in the output buffer and U
// and C in device scratch, all of them L2-resident (a lane's working set is
// about 0.4 MB).  Column sums are taken by fixed groups of threads in a
// fixed order, so results do not vary from run to run.  Bound: with one
// block per lane the main path's B lanes fill at most B of the 132 SMs; per
// trip a block does 2*F*R*M FMAs (5.1 M) and the reductions, so the refit is
// latency-bound on a partly idle card.  Inactive lanes leave after the entry
// normalisation.
//
// No fast math: the relative-cost test relies on IEEE inf/NaN at trip 0 and
// on an accurate logf.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WT = 512;                 // threads per block (one lane)
constexpr int WWARPS = WT / 32;

// Column sums over f of (mode 0) X^2, (mode 1) Y*X into outA and X into
// outB.  Column r belongs to the P = WT / R threads t = r*P .. r*P+P-1;
// partials combine in thread order.
__device__ void col_reduce(int mode, const float* X, const float* Y,
                           float* outA, float* outB, float* sPartA,
                           float* sPartB, int F, int R) {
  const int P = WT / R;
  const int t = threadIdx.x;
  const int r = t / P, part = t % P;
  float a = 0.f, b = 0.f;
  if (r < R) {
    for (int f = part; f < F; f += P) {
      const float x = X[(size_t)f * R + r];
      if (mode == 0) {
        a += x * x;
      } else {
        a += Y[(size_t)f * R + r] * x;
        b += x;
      }
    }
  }
  sPartA[t] = a;
  sPartB[t] = b;
  __syncthreads();
  if (t < R) {
    float sa = 0.f, sb = 0.f;
    for (int p = 0; p < P; ++p) {
      sa += sPartA[t * P + p];
      sb += sPartB[t * P + p];
    }
    outA[t] = sa;
    outB[t] = sb;
  }
  __syncthreads();
}

// L = max(W H, flr) and U = V / L over the lane; returns the thread's share
// of the KL divergence when `cost`.
__device__ float lambda_pass(const float* __restrict__ vl, const float* W,
                             const float* sH, float* U, int F, int R, int M,
                             float flr, bool cost) {
  float cp = 0.f;
  for (int e = threadIdx.x; e < F * M; e += WT) {
    const int f = e / M, m = e % M;
    const float* wr = W + (size_t)f * R;
    float acc = 0.f;
    for (int r = 0; r < R; ++r) acc += wr[r] * sH[r * M + m];
    const float lam = fmaxf(acc, flr);
    const float vv = fmaxf(vl[e], flr);
    const float u = vv / lam;
    U[e] = u;
    if (cost) cp += vv * logf(u) - vv + lam;
  }
  return cp;
}

__global__ void __launch_bounds__(WT)
w_solve_kernel(const float* __restrict__ v, const float* __restrict__ w0,
               const float* __restrict__ h, const int* __restrict__ active,
               float* __restrict__ w_out, int* __restrict__ trips_out,
               float* __restrict__ u_scr, float* __restrict__ c_scr, int F,
               int R, int M, int max_iter, float conv_eps, float sparsity,
               float flr) {
  extern __shared__ __align__(16) float smem[];
  float* sH = smem;                  // R * M   rescaled H
  float* sHT = sH + R * M;           // M * R   its transpose
  float* sSumh = sHT + M * R;        // R
  float* sA = sSumh + R;             // R
  float* sB = sA + R;                // R
  float* sPartA = sB + R;            // WT
  float* sPartB = sPartA + WT;       // WT
  float* sScal = sPartB + WT;        // [0] last cost, [1] sparsity * sum(H)
  int* sDone = reinterpret_cast<int*>(sScal + 2);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* vl = v + (size_t)b * F * M;
  const float* w0l = w0 + (size_t)b * F * R;
  const float* hl = h + (size_t)b * R * M;
  float* W = w_out + (size_t)b * F * R;
  float* U = u_scr + (size_t)b * F * M;
  float* C = c_scr + (size_t)b * F * R;
  const bool early = conv_eps > 0.f;

  // entry normalisation (done for inactive lanes too)
  col_reduce(0, w0l, nullptr, sA, sB, sPartA, sPartB, F, R);
  if (tid < R) sA[tid] = sqrtf(sA[tid]);           // column norms
  __syncthreads();
  for (int e = tid; e < F * R; e += WT) {
    const float n = sA[e % R];
    W[e] = w0l[e] / (n > 0.f ? n : 1.f);
  }
  if (active[b] == 0) {
    if (tid == 0) trips_out[b] = 0;
    return;
  }
  for (int e = tid; e < R * M; e += WT) {
    const int r = e / M, m = e % M;
    const float x = hl[e] * sA[r];
    sH[e] = x;
    sHT[m * R + r] = x;
  }
  __syncthreads();
  if (tid < R) {
    float s = 0.f, p = 0.f;
    for (int m = 0; m < M; ++m) {
      s += sH[tid * M + m];
      p += sparsity * sH[tid * M + m];
    }
    sSumh[tid] = s;
    sB[tid] = p;
  }
  __syncthreads();
  if (tid == 0) {
    float p = 0.f;
    for (int r = 0; r < R; ++r) p += sB[r];
    sScal[0] = INFINITY;
    sScal[1] = p;
    *sDone = 0;
  }
  lambda_pass(vl, W, sH, U, F, R, M, flr, false);
  __syncthreads();

  int trips = 0;
  for (int it = 0; it < max_iter; ++it) {
    ++trips;
    // C = U H'
    for (int e = tid; e < F * R; e += WT) {
      const int f = e / R, r = e % R;
      const float* ur = U + (size_t)f * M;
      float acc = 0.f;
      for (int m = 0; m < M; ++m) acc += ur[m] * sHT[m * R + r];
      C[e] = acc;
    }
    __syncthreads();
    col_reduce(1, W, C, sA, sB, sPartA, sPartB, F, R);   // corr_p, 1'W
    for (int e = tid; e < F * R; e += WT) {
      const int r = e % R;
      const float w = W[e];
      const float dpw = fmaxf(sSumh[r] + sA[r] * w, flr);
      const float dmw = C[e] + (sSumh[r] * sB[r]) * w;
      W[e] = w * dmw / dpw;
    }
    __syncthreads();
    col_reduce(0, W, nullptr, sA, sB, sPartA, sPartB, F, R);
    if (tid < R) {
      const float n = sqrtf(sA[tid]);
      sA[tid] = n > 0.f ? n : 1.f;
    }
    __syncthreads();
    for (int e = tid; e < F * R; e += WT) W[e] = W[e] / sA[e % R];
    __syncthreads();
    float cp = lambda_pass(vl, W, sH, U, F, R, M, flr, early);
    if (early) {
      for (int off = 16; off > 0; off >>= 1)
        cp += __shfl_down_sync(0xffffffffu, cp, off);
      if ((tid & 31) == 0) sPartA[tid >> 5] = cp;
      __syncthreads();
      if (tid == 0) {
        float div = 0.f;
        for (int k = 0; k < WWARPS; ++k) div += sPartA[k];
        const float cost = div + sScal[1];
        const float rel = fabsf(cost - sScal[0]) / fabsf(sScal[0]);
        *sDone = (it > 0 && rel < conv_eps) ? 1 : 0;
        sScal[0] = cost;
      }
    }
    __syncthreads();
    if (*sDone) break;
  }
  if (tid == 0) trips_out[b] = trips;
}

}  // namespace

// C entry.  v (B,F,M), w0 (B,F,R), h (B,R,M), active (B,) int32; outputs
// w (B,F,R) and the per-lane trip counts (B,); scratch u (B,F,M) and
// c (B,F,R).  Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int mu_w_solve_lanes(const float* v, const float* w0,
                                const float* h, const int* active, float* w,
                                int* trips, float* u_scr, float* c_scr, int B,
                                int F, int R, int M, int max_iter,
                                float conv_eps, float sparsity, float flr,
                                void* stream) {
  if (B == 0) return 0;
  if (R < 1 || R > WT) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)2 * R * M + 3 * R + 2 * WT + 2)
                      + sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      w_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  w_solve_kernel<<<B, WT, smem, static_cast<cudaStream_t>(stream)>>>(
      v, w0, h, active, w, trips, u_scr, c_scr, F, R, M, max_iter, conv_eps,
      sparsity, flr);
  return (int)cudaGetLastError();
}
