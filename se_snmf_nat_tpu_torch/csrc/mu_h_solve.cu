// Batched per-column KL H-only multiplicative-update solve (Hopper, sm_90a).
//
// Replaces the TPU kernel se_snmf_nat_tpu/kernels/mu_pallas.py:
// _h_solve_kernel / pallas_h_solve, with the per-column stop of
// se_snmf_nat_tpu/nmf/solver.py:snmf_h_solve_columns (each column freezes at
// its own relative-cost test; with conv_eps <= 0 every column runs max_iter
// trips and the cost is skipped).
//
// Problem, per lane b:  V (F, N), W (F, R), H0 (R, N); the tile solve is
// mu_tile.cuh's.
//
// Design.  The Pallas kernel keeps a whole lane's W in VMEM; at the main
// path's F=513, R=200 that is 410 KB, above the 227 KB of shared memory a
// block may use.  Columns are independent problems, so one block takes one
// (lane, 16-column tile) with V, V/L and H in shared memory (~79 KB) and W
// streamed from L2 (see mu_tile.cuh).  A first kernel normalises each
// lane's W once into both layouts and computes dph.

#include "mu_tile.cuh"

namespace {

__global__ void __launch_bounds__(THREADS)
h_solve_kernel(const float* __restrict__ v, const float* __restrict__ w_n,
               const float* __restrict__ w_t, const float* __restrict__ h0,
               long long h0_lane_stride, const float* __restrict__ wn,
               const float* __restrict__ dph, float* __restrict__ h_out,
               int* __restrict__ trips_out, int F, int R, int N,
               int max_iter, float conv_eps, float sparsity, float flr) {
  extern __shared__ __align__(16) float smem[];
  const Tile t = carve(smem, F, R);
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * TN;
  const int tid = threadIdx.x;
  const float* vl = v + (size_t)b * F * N;
  const float* h0l = h0 + (size_t)b * h0_lane_stride;
  const float* normsl = wn + (size_t)b * R;

  // tile entry: V floored; H rescaled by the column norms; columns past N
  // (the ragged last tile) get V=1, H=0 and stay inactive
  for (int e = tid; e < F * TN; e += THREADS) {
    const int f = e / TN, n = n0 + e % TN;
    t.sV[e] = n < N ? fmaxf(vl[(size_t)f * N + n], flr) : 1.f;
  }
  for (int e = tid; e < R * TN; e += THREADS) {
    const int r = e / TN, n = n0 + e % TN;
    t.sH[e] = n < N ? h0l[(size_t)r * N + n] * normsl[r] : 0.f;
  }
  solve_tile(t, N - n0, w_n + (size_t)b * F * R, w_t + (size_t)b * R * F,
             dph + (size_t)b * R, F, R, max_iter, conv_eps, sparsity, flr);

  float* hl = h_out + (size_t)b * R * N;
  for (int e = tid; e < R * TN; e += THREADS) {
    const int r = e / TN, n = n0 + e % TN;
    if (n < N) hl[(size_t)r * N + n] = t.sH[e];
  }
  if (tid < TN && n0 + tid < N)
    trips_out[(size_t)b * N + n0 + tid] = t.sTrips[tid];
}

}  // namespace

// C entry.  v (B,F,N), w (B,F,R), h0 (B,R,N) with lane stride h0_lane_stride
// (0 broadcasts one (R,N) start to every lane); outputs h (B,R,N) and the
// per-column trip counts (B,N); scratch wn, dph (B,R) and w_n, w_t (B,F,R).
// Launches on `stream`, does not synchronise, returns cudaGetLastError(),
// or -1 when a tile does not fit in shared memory.
extern "C" int mu_h_solve_lanes(const float* v, const float* w,
                                const float* h0, long long h0_lane_stride,
                                float* h, int* trips, float* wn, float* dph,
                                float* w_n, float* w_t, int B, int F, int R,
                                int N, int max_iter, float conv_eps,
                                float sparsity, float flr, void* stream) {
  if (B == 0 || N == 0) return 0;
  const size_t smem = tile_smem_bytes(F, R);
  if (smem > MAX_SMEM) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = normalize_w(w, wn, w_n, w_t, dph, B, F, R, sparsity, flr,
                                s);
  if (err != cudaSuccess) return (int)err;
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
