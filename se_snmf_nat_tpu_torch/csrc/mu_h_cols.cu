// Shared-dictionary per-column KL H-only multiplicative-update solve
// (Hopper, sm_90a): the fast plan's one H-solve over every frame of a batch.
//
// Replaces the TPU kernel se_snmf_nat_tpu/kernels/mu_pallas.py:
// _h_cols_kernel / pallas_h_solve_columns, with the semantics of
// se_snmf_nat_tpu/nmf/solver.py:snmf_h_solve_columns: one W (F, R) for all
// N columns, each column freezing at its own relative-cost stop (with
// conv_eps <= 0 every column runs max_iter trips and the cost is skipped),
// and each column's trip count returned.
//
// Design.  The Pallas kernel keeps W in VMEM for every column tile; on the
// H100 W (513 x 200 f32 = 410 KB, 2 MB at the exemplar width R=1000) is
// larger than a block's 227 KB of shared memory, so W is normalised once
// by a first kernel into both layouts (L2-resident, shared by every block)
// and each block solves one 16-column tile with V, V/L and H in shared
// memory (79 KB at R=200, 130 KB at R=1000); the tile loop is mu_tile.cuh's,
// as in mu_h_solve.cu.  The grid runs over column tiles only.  Each tile
// stops when its own last column stops.
//
// Layouts.  V, H0 and H are addressed through element strides, so the fast
// plan hands over its frame-major spectra (B*T, F) as the (F, N) view
// without a transposing copy, and H0 may be one (R, 1) column broadcast with
// stride 0.  Tile loads and stores walk the unit-stride axis with
// neighbouring threads.  Columns past N in the ragged last tile get V=1,
// H=0 and stay inactive (the Pallas wrapper pads with v=1 instead; the real
// columns' values are the same).

#include "mu_tile.cuh"

namespace {

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

__global__ void __launch_bounds__(THREADS)
h_cols_kernel(const float* __restrict__ v, long long v_sf, long long v_sn,
              const float* __restrict__ w_n, const float* __restrict__ w_t,
              const float* __restrict__ h0, long long h0_sr, long long h0_sn,
              const float* __restrict__ wn, const float* __restrict__ dph,
              float* __restrict__ h_out, long long h_sr, long long h_sn,
              int* __restrict__ trips_out, int F, int R, int N, int max_iter,
              float conv_eps, float sparsity, float flr) {
  extern __shared__ __align__(16) float smem[];
  const Tile t = carve(smem, F, R);
  const int n0 = blockIdx.x * TN;
  const int tid = threadIdx.x;

  // tile entry: V floored; H rescaled by the column norms
  for (int e = tid; e < F * TN; e += THREADS) {
    int f, j;
    tile_index(e, F, v_sf == 1, f, j);
    const int n = n0 + j;
    t.sV[f * TN + j] = n < N ? fmaxf(v[f * v_sf + n * v_sn], flr) : 1.f;
  }
  for (int e = tid; e < R * TN; e += THREADS) {
    int r, j;
    tile_index(e, R, h0_sr == 1, r, j);
    const int n = n0 + j;
    t.sH[r * TN + j] = n < N ? h0[r * h0_sr + n * h0_sn] * wn[r] : 0.f;
  }
  solve_tile(t, N - n0, w_n, w_t, dph, F, R, max_iter, conv_eps, sparsity,
             flr);

  for (int e = tid; e < R * TN; e += THREADS) {
    int r, j;
    tile_index(e, R, h_sr == 1, r, j);
    const int n = n0 + j;
    if (n < N) h_out[r * h_sr + n * h_sn] = t.sH[r * TN + j];
  }
  if (tid < TN && n0 + tid < N) trips_out[n0 + tid] = t.sTrips[tid];
}

}  // namespace

// C entry.  v: (F, N) with element strides (v_sf, v_sn); w (F, R)
// contiguous; h0: (R, N) with strides (h0_sr, h0_sn), h0_sn = 0 for one
// broadcast column; outputs h (R, N) with strides (h_sr, h_sn) and the
// per-column trip counts (N,); scratch wn, dph (R,) and w_n, w_t (F*R).
// Launches on `stream`, does not synchronise, returns cudaGetLastError(),
// or -1 when a tile does not fit in shared memory.
extern "C" int mu_h_solve_columns(const float* v, long long v_sf,
                                  long long v_sn, const float* w,
                                  const float* h0, long long h0_sr,
                                  long long h0_sn, float* h, long long h_sr,
                                  long long h_sn, int* trips, float* wn,
                                  float* dph, float* w_n, float* w_t, int F,
                                  int R, int N, int max_iter, float conv_eps,
                                  float sparsity, float flr, void* stream) {
  if (N == 0) return 0;
  const size_t smem = tile_smem_bytes(F, R);
  if (smem > MAX_SMEM) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = normalize_w(w, wn, w_n, w_t, dph, 1, F, R, sparsity, flr,
                                s);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(h_cols_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  h_cols_kernel<<<(N + TN - 1) / TN, THREADS, smem, s>>>(
      v, v_sf, v_sn, w_n, w_t, h0, h0_sr, h0_sn, wn, dph, h, h_sr, h_sn,
      trips, F, R, N, max_iter, conv_eps, sparsity, flr);
  return (int)cudaGetLastError();
}
