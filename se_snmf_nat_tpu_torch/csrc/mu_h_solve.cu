// Batched per-column KL H-only multiplicative-update solve (Hopper, sm_90a):
// one lane's column group per thread-block cluster.
//
// Replaces the TPU kernel se_snmf_nat_tpu/kernels/mu_pallas.py:
// _h_solve_kernel / pallas_h_solve, with the per-column stop of
// se_snmf_nat_tpu/nmf/solver.py:snmf_h_solve_columns (each column freezes at
// its own relative-cost test; with conv_eps <= 0 every column runs max_iter
// trips and the cost is skipped).
//
// Problem, per lane b:  V (F, N), W (F, R), H0 (R, N), columns independent.
//   W <- W / ||W||_col,  H <- H0 * ||W||_col,  dph = max(1'W + sparsity, flr)
//   each trip:  H <- H * W'(V / L) / dph  (active columns),  L = max(W H, flr)
//
// What bounds it on the H100.  A trip is 2*F*R*K FMAs per lane (K columns):
// 18 MFMA at the main path's F=513, R=200, K=88.  The Pallas kernel keeps a
// lane's W (410 KB) in VMEM; a block has 227 KB of shared memory, and the
// earlier design (one block per 16-column tile) streamed W from L2 twice
// per trip per tile, in two layouts: ~7 GB of L2 reads a B=64 call, one
// dependent global load per 16 FMAs, threads idle on ragged row sweeps.
//
// Design, and what each choice does about that:
// * One cluster of C=8 blocks takes one lane's group of up to 96 columns
//   (the whole K=88 block).  F is split into C row slices; block k keeps
//   its slice of W (normalised, 65 x 200 f32 = 52 KB) resident in shared
//   memory for every trip, so W is read from device memory once per call,
//   never per trip.  C measured on the H100 (one block a SM at this shared
//   memory; 15 clusters of 8, 30 of 4 or 66 of 2 resident at once): 8 was
//   faster than 4 at B=64 and, in bare launches, at B=16; 2 fits only 4
//   columns a group.
// * Per trip each block runs two register-blocked FFMA products from
//   shared memory, every operand read as float4: L = W_slice H in 4x4 tiles
//   (then U = V/L and the KL terms of its rows, V read from L2 into
//   registers before the product), and the partial numerator
//   P_k = W_slice' U (R x G) in 12x4 tiles.  The one W layout serves both
//   products; nothing is written back to device memory during the solve.
//   384 threads: at R=200, G=88 the two products have 374 tiles each, one
//   round of the block.  A warp's tiles span 4 tile rows x 8 tile columns
//   (strip_tile).  Measured on the H100 (B=64): 12-row tiles in strip order
//   3.5% faster than 8-row tiles in row-major order; 192, 256 or 512
//   threads and 4x8 L tiles were slower (the products are bound by latency
//   at 12 warps a SM, not by shared-memory bandwidth), and so were 3xTF32
//   mma.sync products (within the correctness gate, 27-48% slower: their
//   fragments are scalar loads, split into TF32 parts on every use).
// * The cluster reduces through distributed shared memory: block k owns
//   ceil(R/C) rows of H, sums the C partial numerators of its rows in rank
//   order (no atomics, so two launches give the same bits), updates them
//   and writes them into every block's copy of H.  The per-column cost is
//   the rank-ordered sum of each block's partial (the KL terms of its F
//   rows plus the penalty of its H rows); every block takes the same stop
//   decision from the same sums.  Two cluster barriers a trip.
// * W's column norms and 1'W are reduced the same way at the start, so the
//   solve is one launch with no scratch in device memory.
// * Wave tail: the lanes that do not fill a whole wave of resident clusters
//   (1 of 16, 4 of 64 at C=8) are cut into narrower column groups so that
//   the last wave spreads over the card.  A column's arithmetic does not
//   depend on its group, so the result is the same bits.
//
// Shared memory per block (floats; G columns padded to GP, a multiple of 4;
// RP = R padded to 8; FP = ceil(F/C) padded to 4; W's row stride WS = RP + 4,
// so neighbouring 4-row tiles of W fall in other banks; the last 12-row
// numerator tile may read up to 4 floats past a row of W, into the next row
// or the 4 floats after the slice, and its rows past RP are not stored):
//   W slice FP*WS + 4 | H RP*GP | partial numerator RP*GP | U FP*GP |
//   cost of each 4-row tile (FP/4)*GP | norms, 1'W (2 partial, 2 final) 4*RP |
//   last cost, cost partial, active, trips 4*GP
// At F=513, R=200, G=88: 230,832 bytes of the 232,448 a block may use.
// The group size is the largest multiple of 4 up to 96 that fits (F <= 513
// with R <= 400 always fits); a shape that cannot fit makes the
// entry return -1 (the wrapper raises).
//
// No fast math: the relative-cost test relies on IEEE inf/NaN at trip 0
// (|cost - inf| / inf is NaN, and NaN < eps is false) and on an accurate
// logf.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

// MU_H_THREADS and MU_H_CLUSTER can be set on the compiler's command line
// only so that tools/kernel_variants.py can time another build beside this
// one; a column's bits depend on the cluster size.
#ifndef MU_H_THREADS
#define MU_H_THREADS 384
#endif
#ifndef MU_H_CLUSTER
#define MU_H_CLUSTER 8
#endif
constexpr int THREADS = MU_H_THREADS;
constexpr int BR = 12;   // rows of a numerator tile
constexpr int C = MU_H_CLUSTER;   // blocks of a cluster
constexpr int MAX_GROUP = 96;
constexpr size_t MAX_SMEM = 232448;   // 227 KB: a block's dynamic limit

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// The shared-memory carve-out of one block, as float offsets.
struct Layout {
  int gp, fp, rp, ws;
  int w, h, n, u, tc, ss, cs, norm, dph, last, cpart, active, trips;
  int floats;
};

__host__ __device__ inline Layout layout(int F, int R, int g) {
  Layout l;
  l.gp = round4(g);
  l.fp = round4((F + C - 1) / C);
  l.rp = (R + 7) & ~7;
  l.ws = l.rp + 4;
  int o = 0;
  l.w = o;      o += l.fp * l.ws + 4;   // + the last tile's overrun
  l.h = o;      o += l.rp * l.gp;
  l.n = o;      o += l.rp * l.gp;
  l.u = o;      o += l.fp * l.gp;
  l.tc = o;     o += (l.fp / 4) * l.gp;
  l.ss = o;     o += l.rp;
  l.cs = o;     o += l.rp;
  l.norm = o;   o += l.rp;
  l.dph = o;    o += l.rp;
  l.last = o;   o += l.gp;
  l.cpart = o;  o += l.gp;
  l.active = o; o += l.gp;
  l.trips = o;  o += l.gp;
  l.floats = o;
  return l;
}

inline size_t smem_bytes(int F, int R, int g) {
  return sizeof(float) * (size_t)layout(F, R, g).floats;
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
// and 8 tile columns: its float4 reads of the column operand then touch 8
// addresses, not up to 22.
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

struct Ctx {
  float* sW;
  float* sH;
  float* sN;
  float* sU;
  float* sTc;
  float* sDph;
  float* sCpart;
  int* sActive;
  const float* vl;   // this lane's V, row-major (F, N)
  int N, n0, gv;     // columns: total, first of the group, valid in it
  int flo, nf;       // this block's rows of F
  int rlo, rhi;      // this block's rows of H
  int gp, ws, rp, nct;
  float flr, sparsity;
};

// One pass over the block's rows of F with the current H: L = max(W H, flr),
// U = V / L, (with `cost`) each column's KL terms over the rows plus the
// penalty of the block's rows of H into sCpart, and the partial numerator
// W' U into sN.  One tile a thread: 4 rows x 4 columns of L, BR (12) rows
// x 4 columns of the numerator.
__device__ void pass(const Ctx& x, bool cost) {
  const int tid = threadIdx.x;
  const int gp = x.gp, ws = x.ws, nct = x.nct;
  const int nrt = (x.nf + 3) / 4;
  for (int t = tid; t < nrt * nct; t += THREADS) {
    int rt, ct;
    strip_tile(t, nrt, nct, rt, ct);
    const int f0 = 4 * rt, j0 = 4 * ct;
    float vv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int f = f0 + i, j = j0 + jj;
        vv[i][jj] = f < x.nf && j < x.gv
                        ? fmaxf(__ldg(x.vl + (size_t)(x.flo + f) * x.N +
                                      x.n0 + j), x.flr)
                        : 1.f;
      }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;
    const float* wr = x.sW + f0 * ws;
    const float* hc = x.sH + j0;
#pragma unroll 2
    for (int r = 0; r < x.rp; r += 4) {
      float4 a[4], hb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ld4(wr + i * ws + r);
#pragma unroll
      for (int q = 0; q < 4; ++q) hb[q] = ld4(hc + (r + q) * gp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        fma4(acc[i], a[i].x, hb[0]);
        fma4(acc[i], a[i].y, hb[1]);
        fma4(acc[i], a[i].z, hb[2]);
        fma4(acc[i], a[i].w, hb[3]);
      }
    }
    float cp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (f0 + i >= x.nf) break;
      float u[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float lam = fmaxf(acc[i][jj], x.flr);
        u[jj] = vv[i][jj] / lam;
        if (cost) cp[jj] += vv[i][jj] * logf(u[jj]) - vv[i][jj] + lam;
      }
      st4(x.sU + (f0 + i) * gp + j0, make_float4(u[0], u[1], u[2], u[3]));
    }
    if (cost)
      st4(x.sTc + rt * gp + j0, make_float4(cp[0], cp[1], cp[2], cp[3]));
  }
  __syncthreads();
  constexpr int BQ = BR / 4;
  const int nrb = (x.rp + BR - 1) / BR;
  for (int t = tid; t < nrb * nct; t += THREADS) {
    int rt, ct;
    strip_tile(t, nrb, nct, rt, ct);
    const int r0 = BR * rt, j0 = 4 * ct;
    float acc[BR][4];
#pragma unroll
    for (int i = 0; i < BR; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;
    const float* wc = x.sW + r0;
    const float* uc = x.sU + j0;
#pragma unroll 4
    for (int f = 0; f < x.nf; ++f) {
      float4 a[BQ];
#pragma unroll
      for (int p = 0; p < BQ; ++p) a[p] = ld4(wc + f * ws + 4 * p);
      const float4 u = ld4(uc + f * gp);
#pragma unroll
      for (int p = 0; p < BQ; ++p) {
        fma4(acc[4 * p + 0], a[p].x, u);
        fma4(acc[4 * p + 1], a[p].y, u);
        fma4(acc[4 * p + 2], a[p].z, u);
        fma4(acc[4 * p + 3], a[p].w, u);
      }
    }
#pragma unroll
    for (int i = 0; i < BR; ++i)
      if (r0 + i < x.rp)
        st4(x.sN + (r0 + i) * gp + j0,
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
  }
  if (cost) {
    for (int j = tid; j < gp; j += THREADS) {
      float div = 0.f;
      for (int rt = 0; rt < nrt; ++rt) div += x.sTc[rt * gp + j];
      float pen = 0.f;
      for (int r = x.rlo; r < x.rhi; ++r) pen += x.sparsity * x.sH[r * gp + j];
      x.sCpart[j] = div + pen;
    }
  }
}

// H <- H * (sum of the C partial numerators, in rank order) / dph on the
// active columns, for the block's own rows of H, written into every block's
// copy.
__device__ void update_h(const Ctx& x, cg::cluster_group& cluster) {
  const int nct = x.nct, gp = x.gp;
  const int nown = x.rhi - x.rlo;
  for (int e = threadIdx.x; e < nown * nct; e += THREADS) {
    const int r = x.rlo + e / nct, j0 = 4 * (e % nct);
    const int off = r * gp + j0;
    float4 p[C];
#pragma unroll
    for (int q = 0; q < C; ++q)
      p[q] = ld4(cluster.map_shared_rank(x.sN, q) + off);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < C; ++q) {
      s.x += p[q].x;
      s.y += p[q].y;
      s.z += p[q].z;
      s.w += p[q].w;
    }
    float4 hv = ld4(x.sH + off);
    const float d = x.sDph[r];
    if (x.sActive[j0 + 0]) hv.x = hv.x * s.x / d;
    if (x.sActive[j0 + 1]) hv.y = hv.y * s.y / d;
    if (x.sActive[j0 + 2]) hv.z = hv.z * s.z / d;
    if (x.sActive[j0 + 3]) hv.w = hv.w * s.w / d;
#pragma unroll
    for (int q = 0; q < C; ++q)
      st4(cluster.map_shared_rank(x.sH, q) + off, hv);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
h_lanes_kernel(const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ h0, long long h0_lane_stride,
               float* __restrict__ h_out, int* __restrict__ trips_out, int F,
               int R, int N, int g, int lanes_full, int g2, int max_iter,
               float conv_eps, float sparsity, float flr) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  // this cluster's unit: lanes below lanes_full in groups of g, the rest in
  // groups of g2
  const int ng = (N + g - 1) / g, ng2 = (N + g2 - 1) / g2;
  int b, n0;
  if ((int)blockIdx.y < lanes_full * ng) {
    b = blockIdx.y / ng;
    n0 = (blockIdx.y % ng) * g;
  } else {
    const int y = blockIdx.y - lanes_full * ng;
    b = lanes_full + y / ng2;
    n0 = (y % ng2) * g2;
    g = g2;
  }
  const Layout l = layout(F, R, g);
  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const bool early = conv_eps > 0.f;

  Ctx x;
  x.sW = smem + l.w;
  x.sH = smem + l.h;
  x.sN = smem + l.n;
  x.sU = smem + l.u;
  x.sTc = smem + l.tc;
  x.sDph = smem + l.dph;
  x.sCpart = smem + l.cpart;
  x.sActive = reinterpret_cast<int*>(smem + l.active);
  float* sSS = smem + l.ss;
  float* sCS = smem + l.cs;
  float* sNorm = smem + l.norm;
  float* sLast = smem + l.last;
  int* sTrips = reinterpret_cast<int*>(smem + l.trips);
  x.vl = v + (size_t)b * F * N;
  x.N = N;
  x.n0 = n0;
  x.gv = min(g, N - x.n0);
  const int fbase = F / C, frem = F % C;
  x.flo = rank * fbase + min(rank, frem);
  x.nf = fbase + (rank < frem ? 1 : 0);
  const int rc = (R + C - 1) / C;
  x.rlo = min(R, rank * rc);
  x.rhi = min(R, x.rlo + rc);
  x.gp = l.gp;
  x.ws = l.ws;
  x.rp = l.rp;
  x.nct = l.gp / 4;
  x.flr = flr;
  x.sparsity = sparsity;
  const int gp = l.gp, ws = l.ws, rp = l.rp;
  const float* wl = w + (size_t)b * F * R;

  // W's rows of the slice (padding rows and columns zero); partial sums of
  // squares of each column over the slice
  for (int e = tid; e < l.fp * ws; e += THREADS) {
    const int f = e / ws, r = e - f * ws;
    x.sW[e] = f < x.nf && r < R ? wl[(size_t)(x.flo + f) * R + r] : 0.f;
  }
  __syncthreads();
  for (int r = tid; r < rp; r += THREADS) {
    float ss = 0.f;
    for (int f = 0; f < x.nf; ++f) {
      const float a = x.sW[f * ws + r];
      ss += a * a;
    }
    sSS[r] = ss;
  }
  cluster.sync();
  for (int r = tid; r < rp; r += THREADS) {
    float ss = 0.f;
    for (int q = 0; q < C; ++q) ss += cluster.map_shared_rank(sSS, q)[r];
    sNorm[r] = sqrtf(ss);
  }
  __syncthreads();
  // normalise the slice in place; partial column sums 1'W over the slice
  for (int e = tid; e < x.nf * ws; e += THREADS) {
    const int r = e % ws;
    if (r < R) {
      const float nrm = sNorm[r];
      x.sW[e] = x.sW[e] / (nrm > 0.f ? nrm : 1.f);
    }
  }
  // every block holds all of H: H0 rescaled by the norms (columns past the
  // group's valid ones and padding rows zero)
  const float* h0l = h0 + (size_t)b * h0_lane_stride;
  for (int e = tid; e < rp * gp; e += THREADS) {
    const int r = e / gp, j = e - r * gp;
    x.sH[e] = r < R && j < x.gv ? h0l[(size_t)r * N + x.n0 + j] * sNorm[r]
                                : 0.f;
  }
  for (int j = tid; j < gp; j += THREADS) {
    x.sActive[j] = j < x.gv ? 1 : 0;
    sTrips[j] = 0;
    sLast[j] = INFINITY;
  }
  __syncthreads();
  for (int r = tid; r < rp; r += THREADS) {
    float cs = 0.f;
    for (int f = 0; f < x.nf; ++f) cs += x.sW[f * ws + r];
    sCS[r] = cs;
  }
  cluster.sync();
  for (int r = tid; r < rp; r += THREADS) {
    float cs = 0.f;
    for (int q = 0; q < C; ++q) cs += cluster.map_shared_rank(sCS, q)[r];
    x.sDph[r] = r < R ? fmaxf(cs + sparsity, flr) : 1.f;
  }
  __syncthreads();

  pass(x, false);
  cluster.sync();
  bool any = true;
  for (int it = 0; it < max_iter; ++it) {
    if (early && !any) break;
    update_h(x, cluster);
    for (int j = tid; j < gp; j += THREADS) sTrips[j] += x.sActive[j];
    cluster.sync();
    if (it == max_iter - 1) break;   // the last trip's L is never read
    pass(x, early);
    cluster.sync();
    if (early) {
      int act = 0;
      if (tid < gp) {
        float cost = 0.f;
        for (int q = 0; q < C; ++q)
          cost += cluster.map_shared_rank(x.sCpart, q)[tid];
        const float last = sLast[tid];
        const float rel = fabsf(cost - last) / fabsf(last);
        act = x.sActive[tid];
        if (it > 0 && rel < conv_eps) act = 0;
        x.sActive[tid] = act;
        sLast[tid] = cost;
      }
      any = __syncthreads_or(act) != 0;
    }
  }
  cluster.sync();   // no block leaves while a peer may still read it

  float* hl = h_out + (size_t)b * R * N;
  for (int e = tid; e < (x.rhi - x.rlo) * gp; e += THREADS) {
    const int r = x.rlo + e / gp, j = e % gp;
    if (j < x.gv) hl[(size_t)r * N + x.n0 + j] = x.sH[r * gp + j];
  }
  if (rank == 0 && tid < x.gv)
    trips_out[(size_t)b * N + x.n0 + tid] = sTrips[tid];
}

// The launch of B lanes.  The group size g is the largest multiple of 4 up
// to MAX_GROUP that fits, evened out over the groups of a lane.  The wave
// tail: when the B lanes do not fill whole waves of resident clusters, the
// lanes of the last wave are cut into narrower groups (g2) so that its
// clusters spread over the card; a column's arithmetic does not depend on
// its group.
struct Plan {
  int g, bytes;
  int resident;     // clusters the card holds at once
  int lanes_full;   // lanes solved in groups of g; the rest in groups of g2
  int g2, units;    // clusters launched
};

// The launch configuration of a plan.
struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Launch(const Plan& p, cudaStream_t s) {
    cfg = {};
    cfg.gridDim = dim3(C, p.units, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = p.bytes;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Returns 0, -1 when nothing fits in shared memory, or a CUDA error.
int plan(int B, int F, int R, int N, Plan& p) {
  int gm = round4(N) < MAX_GROUP ? round4(N) : MAX_GROUP;
  while (gm >= 4 && smem_bytes(F, R, gm) > MAX_SMEM) gm -= 4;
  if (gm < 4) return -1;
  const int ng = (N + gm - 1) / gm;
  p.g = (N + ng - 1) / ng;
  p.bytes = (int)smem_bytes(F, R, p.g);
  cudaError_t err = cudaFuncSetAttribute(
      h_lanes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.bytes);
  if (err != cudaSuccess) return (int)err;
  // clusters the card holds at once, asked once per card and shared-memory
  // size
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static int asked_dev = -1, asked_bytes = 0, resident = 0;
  if (asked_dev != dev || asked_bytes != p.bytes) {
    p.units = 1;
    Launch l(p, nullptr);
    err = cudaOccupancyMaxActiveClusters(&resident, h_lanes_kernel, &l.cfg);
    if (err != cudaSuccess) return (int)err;
    asked_dev = dev;
    asked_bytes = p.bytes;
  }
  p.resident = resident;
  const int per_wave = resident / ng > 0 ? resident / ng : 1;
  const int rem = B % per_wave;
  p.lanes_full = B;
  p.g2 = p.g;
  if (rem > 0) {
    const int pieces = resident / rem;
    const int g2 = round4((N + pieces - 1) / pieces);
    if (g2 < p.g) {
      p.lanes_full = B - rem;
      p.g2 = g2;
    }
  }
  p.units = p.lanes_full * ng + (B - p.lanes_full) * ((N + p.g2 - 1) / p.g2);
  return 0;
}

}  // namespace

// The launch of mu_h_solve_lanes for B lanes of (F, R, N): out = {cluster
// size, group, groups a lane, shared-memory bytes per block, threads per
// block, clusters the card holds at once, lanes in groups of `group`, the
// last wave's group, clusters launched}.  Returns as plan().
extern "C" int mu_h_solve_lanes_shape(int B, int F, int R, int N, int* out) {
  Plan p;
  const int rc = plan(B, F, R, N, p);
  if (rc != 0) return rc;
  const int vals[9] = {C, p.g, (N + p.g - 1) / p.g, p.bytes, THREADS,
                       p.resident, p.lanes_full, p.g2, p.units};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}

// C entry.  v (B,F,N), w (B,F,R), h0 (B,R,N) with lane stride h0_lane_stride
// (0 broadcasts one (R,N) start to every lane); outputs h (B,R,N) and the
// per-column trip counts (B,N).  Launches on `stream`, does not
// synchronise; returns the launch's error (a refused cluster launch
// included), or plan()'s -1.
extern "C" int mu_h_solve_lanes(const float* v, const float* w,
                                const float* h0, long long h0_lane_stride,
                                float* h, int* trips, int B, int F, int R,
                                int N, int max_iter, float conv_eps,
                                float sparsity, float flr, void* stream) {
  if (B == 0 || N == 0) return 0;
  Plan p;
  const int rc = plan(B, F, R, N, p);
  if (rc != 0) return rc;
  Launch l(p, static_cast<cudaStream_t>(stream));
  cudaError_t err = cudaLaunchKernelEx(
      &l.cfg, h_lanes_kernel, v, w, h0, h0_lane_stride, h, trips, F, R, N,
      p.g, p.lanes_full, p.g2, max_iter, conv_eps, sparsity, flr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
