// Batched KL W-only multiplicative-update solve with H fixed (Hopper,
// sm_90a): the block-adaptive plan's per-block dictionary refit, one lane per
// thread-block cluster.
//
// Replaces the TPU kernel se_snmf_nat_tpu/kernels/mu_pallas.py:
// _w_solve_kernel / pallas_w_solve, and adds the per-lane `active` flag of
// se_snmf_nat_tpu/nmf/solver.py:snmf_solve (an inactive lane runs zero trips
// and returns its entry-normalised w0).
//
// Problem, per lane b:  V (F, M), W0 (F, R), H (R, M); masked columns arrive
// zeroed in W0 and in the rows of H, and stay zero.
//   entry:  W <- W0 / ||W0||_col,  H <- H * ||W0||_col,  sumh = H 1
//   each trip (L = max(W H, flr), U = V / L):
//     C = U H'                          corr_p = 1'(C * W)
//     W <- W * (C + (sumh * 1'W) W) / max(sumh + corr_p W, flr)
//     W <- W / ||W||_col
//     cost = sum(V log(V/L) - V + L) + sparsity * sum(H);  stop when the
//     relative change is below conv_eps (from the second trip on)
//
// What bounds it on the H100.  A trip is two products of F*R*M FMAs a lane
// (2 x 2.6 MFMA at the main path's F=513, R=50, M=100) and three reductions
// over F (corr_p and 1'W, the column norms, the scalar cost).  The bytes are
// nothing (0.4 MB a lane, read once), so the bound is the FP32 FMA rate; the
// earlier design (one block of 512 threads a lane, scalar dot products with
// W, U and C in device scratch) used B of the 132 SMs, one L2 load per FMA
// and nine block barriers a trip.
//
// Design, and what each choice does about that:
// * One cluster of C blocks takes one lane; F is split into C row slices and
//   block k keeps its slice of W, U and C in shared memory for every trip,
//   beside H in both layouts (R x M for W H, M x R for U H').  A trip reads
//   only V from device memory (L2-resident, loaded into registers after
//   the product) and nothing is written until the solve ends.  C = 8: 109 KB
//   a block at the main path's shape, so two blocks share a SM (30 clusters
//   resident on the H100).  Clusters of 4 (170 KB, one block a SM, also 30
//   resident) measured slower there at B=16 and at B=64 (PERF.md has the
//   times).  The cluster size is a constant of the build: a lane's bits
//   depend on it and must not depend on B.  MU_W_CLUSTER and MU_W_THREADS
//   can be set on the compiler's command line only so that
//   tools/kernel_variants.py can time another build beside this one.
// * Both products are register-blocked FFMA from shared memory, 4 x 4 tiles,
//   every operand read as float4; a warp's tiles span 4 tile rows x 8 tile
//   columns (strip_tile).  The W update runs on the same 4 x 4 tiles.
// * The sums over F are per-block partials (each tile's 4 rows, then the
//   row tiles in order) that every block of the cluster adds through
//   distributed shared memory in rank order: no atomics, so two launches
//   give the same bits, a lane alone gives the bits it has in a batch, and
//   every block takes the same stop decision.  Two cluster barriers a trip:
//   the cost of a trip travels with the next trip's corr_p and 1'W, so its
//   stop test is taken at the start of the next trip (one C = U H' is
//   wasted on the trip that stops; a third barrier a trip is saved).
// * The last trip's L = W H is never read and is skipped.
// * Inactive lanes leave after the entry normalisation (one cluster
//   reduction) without loading V or H.
// * The work tally: where `counts` is not null, each active lane adds its
//   trips to counts[0] and 1 to counts[1] at exit (one thread a lane), so
//   the caller can tell the work the launches ran from the launches.
//
// Shared memory per block (floats; FP = ceil(F/C) padded to 4, RP and MP = R
// and M padded to 4, W's row stride WS = RP + 4):
//   W FP*WS | U FP*MP | C FP*RP | H RP*MP | H' MP*RP |
//   column partials of each row tile 2*(FP/4)*RP | cost of each L tile |
//   published partials (corr_p, 1'W, cost; then the norms) 3*RP + 4 |
//   corr_p, sumh*1'W, sumh, norms, 1/norms, penalty terms 6*RP | scalars 4
// A shape that does not fit in 227 KB makes the entry return -1 (the
// wrapper raises).
//
// No fast math: the relative-cost test relies on IEEE inf/NaN at trip 0
// (|cost - inf| / inf is NaN, and NaN < eps is false) and on an accurate
// logf.  Float32 throughout, no tensor cores.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

#ifndef MU_W_THREADS
#define MU_W_THREADS 256
#endif
#ifndef MU_W_CLUSTER
#define MU_W_CLUSTER 8
#endif
constexpr int THREADS = MU_W_THREADS;
constexpr int C = MU_W_CLUSTER;       // blocks of a cluster (a lane)
constexpr size_t MAX_SMEM = 232448;   // 227 KB: a block's dynamic limit

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// The shared-memory carve-out of one block, as float offsets.
struct Layout {
  int fp, rp, mp, ws;
  int w, u, c, h, ht, pa, pb, tc, pub_a, pub_b, corr, cm, sumh, norm, inv,
      pen, scal;
  int floats;
};

__host__ __device__ inline Layout layout(int F, int R, int M) {
  Layout l;
  l.fp = round4((F + C - 1) / C);
  l.rp = round4(R);
  l.mp = round4(M);
  l.ws = l.rp + 4;
  const int nrt = l.fp / 4;
  int o = 0;
  l.w = o;      o += l.fp * l.ws;
  l.u = o;      o += l.fp * l.mp;
  l.c = o;      o += l.fp * l.rp;
  l.h = o;      o += l.rp * l.mp;
  l.ht = o;     o += l.mp * l.rp;
  l.pa = o;     o += nrt * l.rp;
  l.pb = o;     o += nrt * l.rp;
  l.tc = o;     o += round4(nrt * (l.mp / 4));
  l.pub_a = o;  o += 2 * l.rp + 4;    // corr_p | 1'W | cost
  l.pub_b = o;  o += l.rp;            // sums of squares
  l.corr = o;   o += l.rp;
  l.cm = o;     o += l.rp;
  l.sumh = o;   o += l.rp;
  l.norm = o;   o += l.rp;
  l.inv = o;    o += l.rp;
  l.pen = o;    o += l.rp;
  l.scal = o;   o += 4;               // last cost, penalty, stop flag
  l.floats = o;
  return l;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// acc[0..3] += a * (b.x, b.y, b.z, b.w)
__device__ __forceinline__ void fma4(float* acc, float a, float4 b) {
  acc[0] += a * b.x;
  acc[1] += a * b.y;
  acc[2] += a * b.z;
  acc[3] += a * b.w;
}

// Tile t of an nr x nc grid of tiles, walked in strips of 8 tile columns
// (row-major inside a strip), so that a warp's 32 tiles span 4 tile rows
// and 8 tile columns.
__device__ __forceinline__ void strip_tile(int t, int nr, int nc, int& rt,
                                           int& ct) {
  const int full = nc & ~7;
  if (t < nr * full) {
    const int s = t / (8 * nr), e = t - s * 8 * nr;
    rt = e >> 3;
    ct = 8 * s + (e & 7);
  } else {
    const int wide = nc - full, e = t - nr * full;
    rt = e / wide;
    ct = full + e % wide;
  }
}

// acc (4 x 4) = A[0..3][0..depth) * B[0..depth)[0..3]; A rows lda apart, B
// rows ldb apart, depth a multiple of 4 (padding zero on one side).
__device__ __forceinline__ void tile_product(const float* a, int lda,
                                             const float* b, int ldb,
                                             int depth, float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int k = 0; k < depth; k += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = ld4(a + i * lda + k);
#pragma unroll
    for (int q = 0; q < 4; ++q) y[q] = ld4(b + (k + q) * ldb);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      fma4(acc[i], x[i].x, y[0]);
      fma4(acc[i], x[i].y, y[1]);
      fma4(acc[i], x[i].z, y[2]);
      fma4(acc[i], x[i].w, y[3]);
    }
  }
}

struct Ctx {
  float* sW;
  float* sU;
  float* sC;
  float* sH;
  float* sHT;
  float* sPa;
  float* sPb;
  float* sTc;
  const float* vl;   // this lane's V, row-major (F, M)
  int M, R;
  int flo, nf;       // this block's rows of F
  int nrt;           // its 4-row tiles
  int rp, mp, ws;
  float flr;
};

// L = max(W H, flr) and U = V / L over the block's rows (padding rows and
// columns of U zero); with `cost`, each tile's KL terms into sTc.
__device__ void pass_l(const Ctx& x, bool cost) {
  const int nct = x.mp / 4;
  for (int t = threadIdx.x; t < x.nrt * nct; t += THREADS) {
    int rt, ct;
    strip_tile(t, x.nrt, nct, rt, ct);
    const int f0 = 4 * rt, m0 = 4 * ct;
    float acc[4][4];
    tile_product(x.sW + f0 * x.ws, x.ws, x.sH + m0, x.mp, x.rp, acc);
    // V after the product: its 16 values are not held in registers through
    // the product loop (measured 5% faster on the H100 than loading ahead;
    // scalar loads: one float4 a row measured 6-8% slower)
    float vv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = f0 + i, m = m0 + j;
        vv[i][j] = f < x.nf && m < x.M
                       ? fmaxf(__ldg(x.vl + (size_t)(x.flo + f) * x.M + m),
                               x.flr)
                       : 0.f;
      }
    float cp = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float u[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool real = f0 + i < x.nf && m0 + j < x.M;
        const float lam = fmaxf(acc[i][j], x.flr);
        u[j] = real ? vv[i][j] / lam : 0.f;
        if (cost && real) cp += vv[i][j] * logf(u[j]) - vv[i][j] + lam;
      }
      st4(x.sU + (f0 + i) * x.mp + m0, make_float4(u[0], u[1], u[2], u[3]));
    }
    if (cost) x.sTc[t] = cp;
  }
}

// C = U H' over the block's rows, and each row tile's share of the column
// sums corr_p = 1'(C * W) and 1'W into sPa and sPb.
__device__ void pass_c(const Ctx& x) {
  const int nct = x.rp / 4;
  for (int t = threadIdx.x; t < x.nrt * nct; t += THREADS) {
    int rt, ct;
    strip_tile(t, x.nrt, nct, rt, ct);
    const int f0 = 4 * rt, r0 = 4 * ct;
    float acc[4][4];
    tile_product(x.sU + f0 * x.mp, x.mp, x.sHT + r0, x.rp, x.mp, acc);
    float pa[4] = {0.f, 0.f, 0.f, 0.f}, pb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 w = ld4(x.sW + (f0 + i) * x.ws + r0);
      st4(x.sC + (f0 + i) * x.rp + r0,
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      pa[0] += acc[i][0] * w.x;
      pa[1] += acc[i][1] * w.y;
      pa[2] += acc[i][2] * w.z;
      pa[3] += acc[i][3] * w.w;
      pb[0] += w.x;
      pb[1] += w.y;
      pb[2] += w.z;
      pb[3] += w.w;
    }
    st4(x.sPa + rt * x.rp + r0, make_float4(pa[0], pa[1], pa[2], pa[3]));
    st4(x.sPb + rt * x.rp + r0, make_float4(pb[0], pb[1], pb[2], pb[3]));
  }
}

// W <- W * (C + (sumh * 1'W) W) / max(sumh + corr_p W, flr) on the block's
// rows, and each row tile's share of the new columns' sums of squares into
// sPa.  Padding rows and columns hold zeros and stay zero.
__device__ void update_w(const Ctx& x, const float* sCorr, const float* sCm,
                         const float* sSumh) {
  const int nct = x.rp / 4;
  for (int t = threadIdx.x; t < x.nrt * nct; t += THREADS) {
    int rt, ct;
    strip_tile(t, x.nrt, nct, rt, ct);
    const int f0 = 4 * rt, r0 = 4 * ct;
    const float4 corr = ld4(sCorr + r0), cm = ld4(sCm + r0),
                 sh = ld4(sSumh + r0);
    float ss[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 w = ld4(x.sW + (f0 + i) * x.ws + r0);
      const float4 c = ld4(x.sC + (f0 + i) * x.rp + r0);
      w.x = w.x * (c.x + cm.x * w.x) / fmaxf(sh.x + corr.x * w.x, x.flr);
      w.y = w.y * (c.y + cm.y * w.y) / fmaxf(sh.y + corr.y * w.y, x.flr);
      w.z = w.z * (c.z + cm.z * w.z) / fmaxf(sh.z + corr.z * w.z, x.flr);
      w.w = w.w * (c.w + cm.w * w.w) / fmaxf(sh.w + corr.w * w.w, x.flr);
      st4(x.sW + (f0 + i) * x.ws + r0, w);
      ss[0] += w.x * w.x;
      ss[1] += w.y * w.y;
      ss[2] += w.z * w.z;
      ss[3] += w.w * w.w;
    }
    st4(x.sPa + rt * x.rp + r0, make_float4(ss[0], ss[1], ss[2], ss[3]));
  }
}

// a / b from b's correctly rounded reciprocal y = 1 / b: q = RN(a y) and one
// residual step, q + (a - b q) y.  By Markstein's theorem this is the
// correctly rounded quotient (the IEEE division's own value) for normal
// operands, except possibly when b's significand is all ones; no branch, so
// the sixteen quotients of a tile overlap where sixteen divisions did not.
__device__ __forceinline__ float div_by(float a, float b, float y) {
  const float q = a * y;
  return fmaf(fmaf(-b, q, a), y, q);
}

// W <- W / norm on the block's rows, in 4 x 4 tiles (sNorm: the norms, 1
// where a column is zero; sInv: their reciprocals, one IEEE division a
// column).  A division an entry held the block for a ninth of a trip.
__device__ void scale_w(const Ctx& x, const float* sNorm, const float* sInv) {
  const int nct = x.rp / 4;
  for (int t = threadIdx.x; t < x.nrt * nct; t += THREADS) {
    const int rt = t / nct, ct = t - rt * nct;
    const float4 n = ld4(sNorm + 4 * ct), y = ld4(sInv + 4 * ct);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* p = x.sW + (4 * rt + i) * x.ws + 4 * ct;
      float4 w = ld4(p);
      w.x = div_by(w.x, n.x, y.x);
      w.y = div_by(w.y, n.y, y.y);
      w.z = div_by(w.z, n.z, y.z);
      w.w = div_by(w.w, n.w, y.w);
      st4(p, w);
    }
  }
}

// The block's rows of W to the lane's output.
__device__ void store_w(const Ctx& x, float* wl) {
  for (int e = threadIdx.x; e < x.nf * x.R; e += THREADS) {
    const int f = e / x.R, r = e - f * x.R;
    wl[(size_t)(x.flo + f) * x.R + r] = x.sW[f * x.ws + r];
  }
}

__global__ void __launch_bounds__(THREADS, 2)
w_lanes_kernel(const float* __restrict__ v, const float* __restrict__ w0,
               const float* __restrict__ h, const int* __restrict__ active,
               float* __restrict__ w_out, int* __restrict__ trips_out,
               unsigned long long* __restrict__ counts, int F, int R, int M,
               int max_iter, float conv_eps, float sparsity, float flr) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Layout l = layout(F, R, M);
  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const bool early = conv_eps > 0.f;

  Ctx x;
  x.sW = smem + l.w;
  x.sU = smem + l.u;
  x.sC = smem + l.c;
  x.sH = smem + l.h;
  x.sHT = smem + l.ht;
  x.sPa = smem + l.pa;
  x.sPb = smem + l.pb;
  x.sTc = smem + l.tc;
  float* sPubA = smem + l.pub_a;
  float* sPubB = smem + l.pub_b;
  float* sCorr = smem + l.corr;
  float* sCm = smem + l.cm;
  float* sSumh = smem + l.sumh;
  float* sNorm = smem + l.norm;
  float* sInv = smem + l.inv;
  float* sPen = smem + l.pen;
  float* sScal = smem + l.scal;   // [0] last cost, [1] penalty, [2] stop
  x.vl = v + (size_t)b * F * M;
  x.M = M;
  x.R = R;
  const int fbase = F / C, frem = F % C;
  x.flo = rank * fbase + min(rank, frem);
  x.nf = fbase + (rank < frem ? 1 : 0);
  x.nrt = (x.nf + 3) / 4;
  x.rp = l.rp;
  x.mp = l.mp;
  x.ws = l.ws;
  x.flr = flr;
  const int rp = l.rp, mp = l.mp, ws = l.ws;
  const float* w0l = w0 + (size_t)b * F * R;
  float* wl = w_out + (size_t)b * F * R;

  // W0's rows of the slice (padding rows and columns zero), the slice's
  // share of each column's sum of squares, and the norms over the cluster
  for (int e = tid; e < l.fp * ws; e += THREADS) {
    const int f = e / ws, r = e - f * ws;
    x.sW[e] = f < x.nf && r < R ? w0l[(size_t)(x.flo + f) * R + r] : 0.f;
  }
  __syncthreads();
  for (int r = tid; r < rp; r += THREADS) {
    float ss = 0.f;
    for (int f = 0; f < x.nf; ++f) {
      const float a = x.sW[f * ws + r];
      ss += a * a;
    }
    sPubB[r] = ss;
  }
  cluster.sync();
  for (int r = tid; r < rp; r += THREADS) {
    float ss = 0.f;
    for (int q = 0; q < C; ++q) ss += cluster.map_shared_rank(sPubB, q)[r];
    const float n = sqrtf(ss);
    sNorm[r] = n > 0.f ? n : 1.f;
    sInv[r] = 1.f / sNorm[r];
    sPen[r] = n;               // the norm itself rescales H below
  }
  __syncthreads();
  scale_w(x, sNorm, sInv);
  if (active[b] == 0) {
    __syncthreads();
    store_w(x, wl);
    if (rank == 0 && tid == 0) trips_out[b] = 0;
    cluster.sync();   // no block leaves while a peer may still read it
    return;
  }

  // H rescaled by the norms, in both layouts (padding zero); sumh = H 1 and
  // the penalty sparsity * sum(H)
  const float* hl = h + (size_t)b * R * M;
  for (int e = tid; e < rp * mp; e += THREADS) {
    const int r = e / mp, m = e - r * mp;
    const float a = r < R && m < M ? hl[(size_t)r * M + m] * sPen[r] : 0.f;
    x.sH[e] = a;
    x.sHT[m * rp + r] = a;
  }
  __syncthreads();
  for (int r = tid; r < rp; r += THREADS) {
    float s = 0.f, p = 0.f;
    for (int m = 0; m < M; ++m) {
      s += x.sH[r * mp + m];
      p += sparsity * x.sH[r * mp + m];
    }
    sSumh[r] = s;
    sPen[r] = p;
  }
  __syncthreads();
  if (tid == 0) {
    float p = 0.f;
    for (int r = 0; r < R; ++r) p += sPen[r];
    sScal[0] = INFINITY;
    sScal[1] = p;
    sScal[2] = 0.f;
  }
  pass_l(x, false);
  __syncthreads();

  const int n_ltiles = x.nrt * (mp / 4);
  int trips = 0;
  for (int it = 0; it < max_iter; ++it) {
    pass_c(x);
    __syncthreads();
    // the block's partials, published for the cluster: corr_p, 1'W and the
    // KL terms of the trip before
    for (int r = tid; r < rp; r += THREADS) {
      float pa = 0.f, pb = 0.f;
      for (int rt = 0; rt < x.nrt; ++rt) {
        pa += x.sPa[rt * rp + r];
        pb += x.sPb[rt * rp + r];
      }
      sPubA[r] = pa;
      sPubA[rp + r] = pb;
    }
    if (early && it > 0 && tid >= THREADS - 32) {
      const int lane = tid & 31;
      float cp = 0.f;
      for (int t = lane; t < n_ltiles; t += 32) cp += x.sTc[t];
      for (int off = 16; off > 0; off >>= 1)
        cp += __shfl_down_sync(0xffffffffu, cp, off);
      if (lane == 0) sPubA[2 * rp] = cp;
    }
    cluster.sync();
    for (int r = tid; r < rp; r += THREADS) {
      float corr = 0.f, cs = 0.f;
      for (int q = 0; q < C; ++q) {
        const float* pub = cluster.map_shared_rank(sPubA, q);
        corr += pub[r];
        cs += pub[rp + r];
      }
      sCorr[r] = corr;
      sCm[r] = sSumh[r] * cs;
    }
    if (early && it > 0 && tid == THREADS - 1) {
      float div = 0.f;
      for (int q = 0; q < C; ++q)
        div += cluster.map_shared_rank(sPubA, q)[2 * rp];
      const float cost = div + sScal[1];
      const float rel = fabsf(cost - sScal[0]) / fabsf(sScal[0]);
      sScal[2] = (it > 1 && rel < conv_eps) ? 1.f : 0.f;
      sScal[0] = cost;
    }
    __syncthreads();
    if (sScal[2] != 0.f) break;   // the trip before met the stop test
    ++trips;
    update_w(x, sCorr, sCm, sSumh);
    __syncthreads();
    for (int r = tid; r < rp; r += THREADS) {
      float ss = 0.f;
      for (int rt = 0; rt < x.nrt; ++rt) ss += x.sPa[rt * rp + r];
      sPubB[r] = ss;
    }
    cluster.sync();
    for (int r = tid; r < rp; r += THREADS) {
      float ss = 0.f;
      for (int q = 0; q < C; ++q) ss += cluster.map_shared_rank(sPubB, q)[r];
      const float n = sqrtf(ss);
      sNorm[r] = n > 0.f ? n : 1.f;
      sInv[r] = 1.f / sNorm[r];
    }
    __syncthreads();
    scale_w(x, sNorm, sInv);
    __syncthreads();
    if (it == max_iter - 1) break;   // the last trip's L is never read
    pass_l(x, early);
    __syncthreads();
  }
  cluster.sync();   // no block leaves while a peer may still read it
  store_w(x, wl);
  if (rank == 0 && tid == 0) {
    trips_out[b] = trips;
    if (counts != nullptr) {
      atomicAdd(counts, (unsigned long long)trips);
      atomicAdd(counts + 1, 1ULL);
    }
  }
}

// The launch of B lanes in clusters of C.
struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Launch(int B, int bytes, cudaStream_t s) {
    cfg = {};
    cfg.gridDim = dim3(C, B, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Shared-memory bytes of a block, or -1 when the shape does not fit; sets
// the kernel's limit.
int prepare(int F, int R, int M, int& bytes) {
  if (R < 1 || M < 1 || F < C) return -1;
  const size_t need = sizeof(float) * (size_t)layout(F, R, M).floats;
  if (need > MAX_SMEM) return -1;
  bytes = (int)need;
  return (int)cudaFuncSetAttribute(
      w_lanes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// The launch of mu_w_solve_lanes for B lanes of (F, R, M): out = {cluster
// size, shared-memory bytes per block, threads per block, clusters the card
// holds at once, waves of clusters the B lanes take}.  Returns 0, -1 when
// the shape does not fit in shared memory, or a CUDA error.
extern "C" int mu_w_solve_lanes_shape(int B, int F, int R, int M, int* out) {
  int bytes = 0;
  const int rc = prepare(F, R, M, bytes);
  if (rc != 0) return rc;
  Launch l(B > 0 ? B : 1, bytes, nullptr);
  int resident = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&resident, w_lanes_kernel,
                                                   &l.cfg);
  if (err != cudaSuccess) return (int)err;
  const int vals[5] = {C, bytes, THREADS, resident,
                       resident > 0 ? (B + resident - 1) / resident : 0};
  for (int i = 0; i < 5; ++i) out[i] = vals[i];
  return 0;
}

// C entry.  v (B,F,M), w0 (B,F,R), h (B,R,M), active (B,) int32; outputs
// w (B,F,R) and the per-lane trip counts (B,); `counts` (2,) uint64, or
// null, is added to: the active lanes' trips and their number.  Launches
// on `stream`, does not synchronise; returns the launch's error (a refused
// cluster launch included), or -1 as mu_w_solve_lanes_shape.
extern "C" int mu_w_solve_lanes(const float* v, const float* w0,
                                const float* h, const int* active, float* w,
                                int* trips, unsigned long long* counts, int B,
                                int F, int R, int M, int max_iter,
                                float conv_eps, float sparsity, float flr,
                                void* stream) {
  if (B == 0) return 0;
  int bytes = 0;
  const int rc = prepare(F, R, M, bytes);
  if (rc != 0) return rc;
  Launch l(B, bytes, static_cast<cudaStream_t>(stream));
  cudaError_t err = cudaLaunchKernelEx(&l.cfg, w_lanes_kernel, v, w0, h,
                                       active, w, trips, counts, F, R, M,
                                       max_iter, conv_eps, sparsity, flr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
