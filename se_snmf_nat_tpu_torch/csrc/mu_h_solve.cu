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
// * Lanes with nothing to solve: the caller may pass a flag a lane (the
//   block step passes "this lane has a true frame in this block", so a
//   block wholly past a lane's end is not solved; in a batch padded to its
//   longest lane that is a third or more of the lane-blocks).  A CUDA graph
//   fixes the grid, so the kernel plans its units itself, before W, the
//   norms or any cluster barrier: each warp counts the set flags with
//   ballots (A of them), the first units take the A active lanes in lane
//   order under the wave-tail cut for A, the next ones copy the clear
//   lanes' H0 columns (unscaled; 0 trips) a group a unit, and the rest of
//   the grid (sized for the worst A on the host) exits at once.  So a
//   launch's time follows its active lanes and its last wave spreads over
//   the card; a column's bits do not depend on its group or unit.  The
//   unit of a lane's first group adds 1 to counts[0] and, for a clear lane,
//   to counts[1].
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
//
// That design is the wide path, for N > N* columns a lane (the block plan's
// K=88).  A launch of N <= N* columns takes the narrow path below (h_narrow_
// kernel, see its note); mu_h_solve_lanes chooses from (F, R, N) alone.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

// MU_H_THREADS, MU_H_CLUSTER (the wide path), MU_H_NARROW_MAX (N*, the
// most columns a lane that take the narrow path; 0 turns it off) and
// MU_H_NARROW_CLUSTER (the narrow path's cluster size) can be set on the
// compiler's command line only so that tools/kernel_variants.py can time
// another build beside this one; a column's bits depend on the path and on
// its cluster size.
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

// The wave tail of A lanes of N columns in groups of g, with `resident`
// clusters on the card at once: when the A lanes do not fill whole waves,
// those of the last wave are cut into narrower groups (g2) so that its
// clusters spread over the card.  Lanes below lanes_full take groups of g;
// units is the clusters that makes.  The host plans a launch with it, and
// the kernel plans its active lanes with it.
struct Tail {
  int lanes_full, g2, units;
};

__host__ __device__ inline Tail wave_tail(int A, int N, int g, int resident) {
  const int ng = (N + g - 1) / g;
  const int per_wave = resident / ng > 0 ? resident / ng : 1;
  const int rem = A % per_wave;
  Tail t;
  t.lanes_full = A;
  t.g2 = g;
  if (rem > 0) {
    const int pieces = resident / rem;
    const int g2 = round4((N + pieces - 1) / pieces);
    if (g2 < g) {
      t.lanes_full = A - rem;
      t.g2 = g2;
    }
  }
  t.units = t.lanes_full * ng + (A - t.lanes_full) * ((N + t.g2 - 1) / t.g2);
  return t;
}

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

// A lane whose flag is clear: its H0 columns n0..n0+gv-1 as they came
// (unscaled) and no trips, block `rank` of `blocks` its own rows of H; no
// W, no norms, no barrier.
__device__ void skip_lane(const float* h0l, float* hl, int* trips_l, int R,
                          int N, int n0, int gv, int rank, int blocks) {
  const int rc = (R + blocks - 1) / blocks;
  const int rlo = min(R, rank * rc), rhi = min(R, rlo + rc);
  for (int e = threadIdx.x; e < (rhi - rlo) * gv; e += blockDim.x) {
    const size_t o = (size_t)(rlo + e / gv) * N + n0 + e % gv;
    hl[o] = h0l[o];
  }
  if (rank == 0 && (int)threadIdx.x < gv) trips_l[n0 + threadIdx.x] = 0;
}

// The lanes whose flag is set, as each warp counts them on its own (every
// warp gets the same count, with no barrier).
__device__ int count_flags(const unsigned char* active, long long stride,
                           int B) {
  const int lane = threadIdx.x & 31;
  int n = 0;
  for (int base = 0; base < B; base += 32) {
    const int i = base + lane;
    n += __popc(__ballot_sync(0xffffffffu,
                              i < B && active[(size_t)i * stride] != 0));
  }
  return n;
}

// The k-th lane (from 0) whose flag is `on`, as each warp finds it on its
// own; -1 past the last.
__device__ int kth_lane(const unsigned char* active, long long stride, int B,
                        bool on, int k) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < B; base += 32) {
    const int i = base + lane;
    unsigned m = __ballot_sync(
        0xffffffffu, i < B && (active[(size_t)i * stride] != 0) == on);
    const int c = __popc(m);
    if (k < c) {
      for (; k > 0; --k) m &= m - 1;
      return base + __ffs(m) - 1;
    }
    k -= c;
  }
  return -1;
}

__global__ void __launch_bounds__(THREADS, 1)
h_lanes_kernel(const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ h0, long long h0_lane_stride,
               const unsigned char* __restrict__ active,
               long long active_stride, float* __restrict__ h_out,
               int* __restrict__ trips_out,
               unsigned long long* __restrict__ counts, int F, int R, int N,
               int B, int g, int resident, int max_iter, float conv_eps,
               float sparsity, float flr) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  // this cluster's unit, before anything else (every block of the cluster
  // takes the same): the wave-tail plan of the lanes to solve (all B, or
  // those whose flag is set, in lane order); with flags, then a unit a
  // group of g for each lane whose flag is clear; then units with nothing
  // to do (the grid, fixed at launch, holds the most any count needs)
  const bool flags = active != nullptr;
  const int ng = (N + g - 1) / g;
  const int na = flags ? count_flags(active, active_stride, B) : B;
  const Tail t = wave_tail(na, N, g, resident);
  const int u = blockIdx.y;
  bool on = true;
  int k, n0;
  if (u < t.lanes_full * ng) {
    k = u / ng;
    n0 = (u % ng) * g;
  } else if (u < t.units) {
    const int ng2 = (N + t.g2 - 1) / t.g2, y = u - t.lanes_full * ng;
    k = t.lanes_full + y / ng2;
    n0 = (y % ng2) * t.g2;
    g = t.g2;
  } else if (u < t.units + (B - na) * ng) {
    on = false;
    k = (u - t.units) / ng;
    n0 = ((u - t.units) % ng) * g;
  } else {
    return;
  }
  const int b = flags ? kth_lane(active, active_stride, B, on, k) : k;
  if (b < 0) return;
  if (flags) {
    // the unit of the lane's first group tallies the lane, and whether it
    // was skipped
    if (counts != nullptr && n0 == 0 && rank == 0 && tid == 0) {
      atomicAdd(counts, 1ULL);
      if (!on) atomicAdd(counts + 1, 1ULL);
    }
    if (!on) {
      skip_lane(h0 + (size_t)b * h0_lane_stride, h_out + (size_t)b * R * N,
                trips_out + (size_t)b * N, R, N, n0, min(g, N - n0), rank,
                C);
      return;
    }
  }
  const Layout l = layout(F, R, g);
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

// With `flags` the grid holds the most units any count of active lanes
// needs, the clear lanes' copies included.  Returns 0, -1 when nothing fits
// in shared memory, or a CUDA error.
int plan(int B, int F, int R, int N, bool flags, Plan& p) {
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
  const Tail t = wave_tail(B, N, p.g, resident);
  p.lanes_full = t.lanes_full;
  p.g2 = t.g2;
  p.units = t.units;
  const int groups = (N + p.g - 1) / p.g;
  for (int a = 0; flags && a < B; ++a) {
    const int u = wave_tail(a, N, p.g, resident).units + (B - a) * groups;
    p.units = u > p.units ? u : p.units;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// The narrow path: N <= N* columns a lane.
//
// Replaces the same TPU kernel at the shape it was written for:
// mu_pallas.py:_h_solve_kernel at M=1, one (F, 1) problem a grid step, the
// per-frame activation inference of se_snmf_nat_tpu/enhance/engine.py (the
// exact plan, a StreamingSession, a fleet tick, the time shard: F=513,
// R=200, N=1, cap 100, eps 1e-3, B=1-256 lanes).
//
// What bounds it at N=1.  A trip is 2*F*R = 0.2 MFMA a lane, nothing to
// reuse between columns: each W entry is used once by L = W h and once by
// the numerator W'u.  So a lane costs W's 410 KB read once from device
// memory (7.8 us for 64 lanes at 3.35 TB/s), then, per trip, a sweep of W
// from shared memory and the barriers that order the trip, for ~12 trips
// (8-14 on the exact plan's spectra).  The wide path's 4x4 and 12x4 tiles
// gave 17 of a block's 384 threads work at N=1, each walking R or a slice's
// rows as one serial chain, and one block a SM held 15 lanes at once.
//
// Design, and what each choice does about that:
// * A cluster of C=8 blocks a lane, F in 8 slices (65 rows at F=513); block
//   k keeps its slice of W normalised in shared memory for the whole solve,
//   W's column norms and sums reduced once through distributed shared memory
//   (the column sums taken raw and divided by the norm: one cluster barrier).
// * 128 threads (4 warps) and 57,184 B of shared memory a block at F=513,
//   R=200, N=1, so that 4 blocks share an SM (launch bounds (128, 4): up to
//   128 registers a thread, 127 used).  The card then holds 62 lanes at once
//   (the occupancy query on the H100; clusters of 4 at 2 blocks a SM also
//   62, clusters of 2 at one block a SM 66): B=64 runs as 62 lanes and 2
//   that start as the first lanes stop.  Measured with tools/kernel_variants
//   .py h1: clusters of 2 (one wave at B=64) were slower at every B with the
//   1e-3 stop, their lane's trip 1.4x longer on 2 SMs than on 8.
// * One sweep of W a trip, both products from registers: a warp takes its
//   slice's rows in groups of G (8 at N=1); each lane loads its two float4
//   of each row (r = 4l.. and 4(l+32).., R <= 256), forms the G*N partial
//   dots with h (held in registers for the trip), and the warp reduces them
//   by halving exchanges (warp_sums: 9 shuffles for 8 rows at N=1); the
//   lane left with row g's L computes u = V/max(L, flr) and the KL term,
//   the G values of u are broadcast back (8 shuffles), and each lane adds
//   W_row * u into its numerator accumulators from the W it still holds.
//   Every thread works on every row; no thread walks a serial chain longer
//   than its group.
// * Sums in an order fixed by the code, never by B or the wave: a lane's
//   rows go to warps by group index, the warps' numerators and costs are
//   added in a fixed tree in shared memory ((w0 + w2) + (w1 + w3) at 4
//   warps), the C slices' sums in rank order.  Every block reads all C
//   partial numerators and updates the whole of its own copy of h (the same
//   bits in every block), so a trip needs one cluster barrier, with the
//   partials double-buffered, and the stop test is taken redundantly by the
//   threads that update h, its remote reads overlapped with theirs.
// * One stop per column (per lane at N=1), the last trip's L skipped, no
//   fast math, as on the wide path.  The launch is one cluster a lane,
//   whatever B: a lane's bits depend only on its inputs and on (F, R, N).
// * The flag a lane means what it means on the wide path: a cluster reads
//   its lane's flag first, and a clear lane copies its H0 columns (0 trips)
//   and exits before W's slice or any barrier.  The grid stays one cluster
//   a lane; the counters are added by the lane's first block.  A launch
//   with no flag runs an instance without that code (FLAG false): the
//   early exit cost the N=1 kernel a 4-byte spill and 1-2% at every B.
//
// Shared memory per block (floats; WS = R padded to 4, NC = N padded to 1,
// 2 or 4, FP = ceil(F/C), W = the warps): W slice FP*WS | V slice, floored,
// FP*NC padded to 4 | h NC*WS | partial
// numerators, two buffers 2*NC*WS | the warps' other partials (the norms
// during the set-up) (W/2 - 1)*NC*WS | the slice's sums of squares and
// column sums 2*WS | the warps' costs, the slice's cost (two buffers), the
// penalty.  MU_H_NARROW_CLUSTER (2, 4 or 8; 1,024/C threads a block) is a
// knob for tools/kernel_variants.py only.
// ---------------------------------------------------------------------------

#ifndef MU_H_NARROW_MAX
#define MU_H_NARROW_MAX 4
#endif

namespace narrow {

#ifndef MU_H_NARROW_CLUSTER
#define MU_H_NARROW_CLUSTER 8
#endif
constexpr int C = MU_H_NARROW_CLUSTER;   // blocks of a cluster: F in C slices
// C/2 blocks a SM at N=1, 1,024 threads a SM: up to 128 registers a thread
constexpr int THREADS = 1024 / C;
constexpr int NW = THREADS / 32;
constexpr int MIN_BLOCKS = C / 2;
constexpr int KJ = 2;           // float4 of a row a lane
constexpr int MAX_R = 32 * 4 * KJ;
constexpr unsigned FULL = 0xffffffffu;
static_assert(C == 2 || C == 4 || C == 8, "a cluster of 2, 4 or 8 blocks");

struct Layout {
  int ws, fp, nc4;
  int w, v, h, n, e, ss, cs, cw, c, pen;
  int floats;
};

__host__ __device__ inline Layout layout(int F, int R, int nc) {
  Layout l;
  l.ws = round4(R);
  l.fp = (F + C - 1) / C;
  l.nc4 = round4(nc);
  int o = 0;
  l.w = o;    o += l.fp * l.ws;
  l.v = o;    o += round4(l.fp * nc);
  l.h = o;    o += nc * l.ws;
  l.n = o;    o += 2 * nc * l.ws;
  l.e = o;    o += (NW / 2 - 1) * nc * l.ws;
  l.ss = o;   o += l.ws;
  l.cs = o;   o += l.ws;
  l.cw = o;   o += NW * l.nc4;
  l.c = o;    o += 2 * l.nc4;
  l.pen = o;  o += l.nc4;
  l.floats = o;
  return l;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void add4(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// acc += w * u
__device__ __forceinline__ void fma4(float4& acc, float4 w, float u) {
  acc.x += w.x * u;
  acc.y += w.y * u;
  acc.z += w.z * u;
  acc.w += w.w * u;
}

template <int P>
__host__ __device__ constexpr int log2p() {
  return P >= 8 ? 3 : P >= 4 ? 2 : P >= 2 ? 1 : 0;
}

// The warp's sums of p[0..P): lane l returns the sum over the 32 lanes of
// p[l >> (5 - log2 P)].  Halving exchanges at offsets 16, 8, ... while more
// than one value is left, then a butterfly over the remaining offsets; every
// lane that returns value k holds the same bits (each exchange adds the two
// halves in either order, and float addition commutes).
template <int P>
__device__ __forceinline__ float warp_sums(float (&p)[P], int lane) {
  int off = 16;
#pragma unroll
  for (int s = P; s > 1; s >>= 1, off >>= 1) {
    const bool up = (lane & off) != 0;
#pragma unroll
    for (int k = 0; k < s / 2; ++k) {
      const float send = up ? p[k] : p[k + s / 2];
      const float keep = up ? p[k + s / 2] : p[k];
      p[k] = keep + __shfl_xor_sync(FULL, send, off);
    }
  }
  float x = p[0];
#pragma unroll
  for (; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

struct Ctx {
  const float* sW;
  const float* sV;   // the slice's V, floored, (FP, NC)
  int N, nf, ws, r4;
  float flr;
};

// G rows from f0 of the slice (those past nf count as zero): L, u and the
// KL terms into `cost` (the lane's own row and column), and W' u into acc.
template <int NC, int G>
__device__ __forceinline__ void rows(const Ctx& x, int f0, int lane,
                                     const float4 (&h)[KJ][NC],
                                     float4 (&acc)[KJ][NC], float& cost,
                                     bool with_cost) {
  constexpr int P = G * NC;
  constexpr int SH = 5 - log2p<P>();
  const int idx = lane >> SH;
  const int fi = f0 + idx / NC, ci = idx % NC;
  const bool mine = fi < x.nf && ci < x.N;
  const float vv = mine ? x.sV[fi * NC + ci] : 0.f;
  float4 w[G][KJ];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int q = lane + 32 * j;
      w[g][j] = f0 + g < x.nf && q < x.r4
                    ? ld4(x.sW + (f0 + g) * x.ws + 4 * q)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  float p[P];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) d += dot4(w[g][j], h[j][c]);
      p[g * NC + c] = d;
    }
  const float lam = fmaxf(warp_sums<P>(p, lane), x.flr);
  float u = 0.f;
  if (mine) {
    u = vv / lam;
    if (with_cost) cost += vv * logf(u) - vv + lam;
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float ug = __shfl_sync(FULL, u, (g * NC + c) << SH);
#pragma unroll
      for (int j = 0; j < KJ; ++j) fma4(acc[j][c], w[g][j], ug);
    }
}

struct Smem {
  float* sH;
  float* sN;     // this pass's partial numerators (read by the cluster)
  float* sE;     // the warps' other partials
  float* sCw;    // the warps' costs
  float* sC;     // this pass's cost (read by the cluster)
  float* sPen;
};

// One pass over the block's rows with the current h: each warp's numerator
// and (with_cost) KL terms, then the block's partial numerator
// (w0 + w2) + (w1 + w3) into s.sN, its partial cost likewise into s.sC and
// sparsity * sum(h) into s.sPen.
template <int NC>
__device__ void pass(const Ctx& x, const Smem& s, float sparsity,
                     bool with_cost) {
  constexpr int G = 8 / NC;
  constexpr int SHM = 5 - log2p<G * NC>(), SHT = 5 - log2p<NC>();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ws = x.ws, nc4 = round4(NC);
  float4 h[KJ][NC], acc[KJ][NC];
#pragma unroll
  for (int j = 0; j < KJ; ++j)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int q = lane + 32 * j;
      h[j][c] = q < x.r4 ? ld4(s.sH + c * ws + 4 * q)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      acc[j][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  float cost_main = 0.f, cost_tail = 0.f;
  // groups of G rows to warps by group index; the rows past the last full
  // group one at a time, continuing the round
  const int ng = x.nf / G, tail = ng * G;
  for (int i = warp; i < ng; i += NW)
    rows<NC, G>(x, i * G, lane, h, acc, cost_main, with_cost);
  for (int k = ((warp - ng) % NW + NW) % NW; tail + k < x.nf; k += NW)
    rows<NC, 1>(x, tail + k, lane, h, acc, cost_tail, with_cost);
  if (with_cost) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float cs = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g)
        cs += __shfl_sync(FULL, cost_main, (g * NC + c) << SHM);
      cs += __shfl_sync(FULL, cost_tail, c << SHT);
      if (lane == 0) s.sCw[warp * nc4 + c] = cs;
    }
    if (warp == 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float hs = 0.f;
#pragma unroll
        for (int j = 0; j < KJ; ++j)
          hs += (h[j][c].x + h[j][c].y) + (h[j][c].z + h[j][c].w);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          hs += __shfl_xor_sync(FULL, hs, off);
        if (lane == 0) s.sPen[c] = sparsity * hs;
      }
    }
  }
  // the warps' numerators added in a fixed tree: buffer i (sN, then the
  // NW/2 - 1 of sE) takes w_i + w_(i + NW/2), then buffer i adds buffer
  // i + k for k = NW/4, ..., 1
  const int part = NC * ws;
  float* dst = warp % (NW / 2) == 0 ? s.sN
                                    : s.sE + (warp % (NW / 2) - 1) * part;
  if (warp < NW / 2) {
#pragma unroll
    for (int j = 0; j < KJ; ++j)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int q = lane + 32 * j;
        if (q < x.r4) st4(dst + c * ws + 4 * q, acc[j][c]);
      }
  }
  __syncthreads();
  if (warp >= NW / 2) {
#pragma unroll
    for (int j = 0; j < KJ; ++j)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int q = lane + 32 * j;
        if (q < x.r4) {
          float4 a = ld4(dst + c * ws + 4 * q);
          add4(a, acc[j][c]);
          st4(dst + c * ws + 4 * q, a);
        }
      }
  }
#pragma unroll
  for (int k = NW / 4; k >= 1; k >>= 1) {
    __syncthreads();
    for (int e = tid; e < k * NC * x.r4; e += THREADS) {
      const int i = e / (NC * x.r4), rest = e - i * NC * x.r4;
      const int c = rest / x.r4, q = rest - c * x.r4;
      float* a = (i == 0 ? s.sN : s.sE + (i - 1) * part) + c * ws + 4 * q;
      float4 sum = ld4(a);
      add4(sum, ld4(s.sE + (i + k - 1) * part + c * ws + 4 * q));
      st4(a, sum);
    }
  }
  if (with_cost && tid < NC) {   // the warps' costs in the same tree
    float cw[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) cw[i] = s.sCw[i * nc4 + tid];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) cw[i] = cw[i] + cw[i + NW / 2];
#pragma unroll
    for (int k = NW / 4; k >= 1; k >>= 1)
#pragma unroll
      for (int i = 0; i < k; ++i) cw[i] = cw[i] + cw[i + k];
    s.sC[tid] = cw[0];
  }
}

// One cluster a lane (grid (C, B)).  The threads below NC * ceil(R/4) each
// own one float4 of h (column c, rows 4q..4q+3) for the whole solve, in
// registers with its 1'W + sparsity, the column's last cost and stop flag,
// SLOTS of them a thread.
template <int NC, bool FLAG>
__global__ void __launch_bounds__(THREADS, NC == 1 ? MIN_BLOCKS
                                              : MIN_BLOCKS > 1 ? MIN_BLOCKS - 1
                                                               : 1)
h_narrow_kernel(const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ h0, long long h0_lane_stride,
                const unsigned char* __restrict__ active,
                long long active_stride, float* __restrict__ h_out,
                int* __restrict__ trips_out,
                unsigned long long* __restrict__ counts, int F, int R, int N,
                int max_iter, float conv_eps, float sparsity, float flr,
                int vec) {
  constexpr int SLOTS = (NC * 32 * KJ + THREADS - 1) / THREADS;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Layout l = layout(F, R, NC);
  const int b = blockIdx.y;
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  if constexpr (FLAG) {
    // the lane's flag before anything else (every block of the cluster
    // reads the same): the lane tallied, and a clear one not solved
    const bool on = active[(size_t)b * active_stride] != 0;
    if (counts != nullptr && rank == 0 && tid == 0) {
      atomicAdd(counts, 1ULL);
      if (!on) atomicAdd(counts + 1, 1ULL);
    }
    if (!on) {
      skip_lane(h0 + (size_t)b * h0_lane_stride, h_out + (size_t)b * R * N,
                trips_out + (size_t)b * N, R, N, 0, N, rank, C);
      return;
    }
  }
  const bool early = conv_eps > 0.f;
  const int ws = l.ws, nc4 = l.nc4;
  float* sW = smem + l.w;
  float* sSS = smem + l.ss;
  float* sCS = smem + l.cs;
  Smem s;
  s.sH = smem + l.h;
  s.sE = smem + l.e;
  s.sCw = smem + l.cw;
  s.sPen = smem + l.pen;
  float* sV = smem + l.v;
  Ctx x;
  x.sW = sW;
  x.sV = sV;
  x.N = N;
  const int fbase = F / C, frem = F % C;
  const int flo = rank * fbase + min(rank, frem);
  x.nf = fbase + (rank < frem ? 1 : 0);
  x.ws = ws;
  x.r4 = (R + 3) / 4;
  x.flr = flr;

  // W's rows of the slice (padding columns zero), V's floored; the slice's
  // sums of squares and column sums
  const float* wl = w + ((size_t)b * F + flo) * R;
  const float* vl = v + ((size_t)b * F + flo) * N;
  for (int e = tid; e < x.nf * NC; e += THREADS) {
    const int f = e / NC, c = e - f * NC;
    sV[e] = c < N ? fmaxf(vl[(size_t)f * N + c], flr) : 0.f;
  }
  if (vec) {   // R % 4 == 0 and W 16-byte aligned: nf * R floats in a row
    const float4* src = reinterpret_cast<const float4*>(wl);
    for (int e = tid; e < x.nf * R / 4; e += THREADS)
      st4(sW + 4 * e, __ldg(src + e));
  } else {
    for (int e = tid; e < x.nf * ws; e += THREADS) {
      const int f = e / ws, r = e - f * ws;
      sW[e] = r < R ? wl[(size_t)f * R + r] : 0.f;
    }
  }
  __syncthreads();
  for (int r = tid; r < ws; r += THREADS) {
    float ss = 0.f, cs = 0.f;
    for (int f = 0; f < x.nf; ++f) {
      const float a = sW[f * ws + r];
      ss += a * a;
      cs += a;
    }
    sSS[r] = ss;
    sCS[r] = cs;
  }
  cluster.sync();
  float* sNorm = s.sE;   // free until the first pass
  for (int r = tid; r < ws; r += THREADS) {
    float ss = 0.f;
    for (int q = 0; q < C; ++q) ss += cluster.map_shared_rank(sSS, q)[r];
    sNorm[r] = sqrtf(ss);
  }
  __syncthreads();
  for (int e = tid; e < x.nf * ws; e += THREADS) {
    const float nrm = sNorm[e % ws];
    sW[e] = sW[e] / (nrm > 0.f ? nrm : 1.f);
  }
  float4 hs[SLOTS], ds[SLOTS];
  float last[SLOTS];
  int act[SLOTS], trips[SLOTS];
  const float* h0l = h0 + (size_t)b * h0_lane_stride;
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    const int e = tid + k * THREADS;
    act[k] = 0;
    trips[k] = 0;
    last[k] = INFINITY;
    if (e < NC * x.r4) {
      const int c = e / x.r4, q = e - c * x.r4;
      float hv[4], dv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * q + i;
        float cs = 0.f;
        for (int p = 0; p < C; ++p) cs += cluster.map_shared_rank(sCS, p)[r];
        const float nrm = sNorm[r];
        dv[i] = r < R ? fmaxf(cs / (nrm > 0.f ? nrm : 1.f) + sparsity, flr)
                      : 1.f;
        hv[i] = r < R && c < N ? h0l[(size_t)r * N + c] * nrm : 0.f;
      }
      hs[k] = make_float4(hv[0], hv[1], hv[2], hv[3]);
      ds[k] = make_float4(dv[0], dv[1], dv[2], dv[3]);
      act[k] = c < N ? 1 : 0;
      st4(s.sH + c * ws + 4 * q, hs[k]);
    }
  }
  __syncthreads();

  s.sN = smem + l.n;
  s.sC = smem + l.c;
  pass<NC>(x, s, sparsity, false);
  for (int it = 0; it < max_iter; ++it) {
    cluster.sync();   // the pass's partials, in every block
    const int cb = it & 1;
    const float* rN = smem + l.n + cb * NC * ws;
    const float* rC = smem + l.c + cb * nc4;
    int any = 0;
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      const int e = tid + k * THREADS;
      if (e >= NC * x.r4) continue;
      const int c = e / x.r4, q = e - c * x.r4;
      // the numerators and costs are read from the C blocks at once, before
      // the stop test
      float4 part[C];
      float cpart[C];
#pragma unroll
      for (int p = 0; p < C; ++p) {
        part[p] = ld4(cluster.map_shared_rank(rN, p) + c * ws + 4 * q);
        cpart[p] = early ? cluster.map_shared_rank(rC, p)[c] : 0.f;
      }
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int p = 0; p < C; ++p) add4(sum, part[p]);
      if (early && it > 0) {   // the cost of the h the last pass used
        float cost = 0.f;
#pragma unroll
        for (int p = 0; p < C; ++p) cost += cpart[p];
        cost += s.sPen[c];
        const float rel = fabsf(cost - last[k]) / fabsf(last[k]);
        if (it > 1 && rel < conv_eps) act[k] = 0;
        last[k] = cost;
      }
      if (act[k]) {
        hs[k].x = hs[k].x * sum.x / ds[k].x;
        hs[k].y = hs[k].y * sum.y / ds[k].y;
        hs[k].z = hs[k].z * sum.z / ds[k].z;
        hs[k].w = hs[k].w * sum.w / ds[k].w;
        st4(s.sH + c * ws + 4 * q, hs[k]);
      }
      trips[k] += act[k];
      any |= act[k];
    }
    if (!__syncthreads_or(any)) break;
    if (it == max_iter - 1) break;   // the last trip's L is never read
    s.sN = smem + l.n + (cb ^ 1) * NC * ws;
    s.sC = smem + l.c + (cb ^ 1) * nc4;
    pass<NC>(x, s, sparsity, early);
  }
  cluster.sync();   // no block leaves while a peer may still read it

  if (rank != 0) return;
  float* hl = h_out + (size_t)b * R * N;
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    const int e = tid + k * THREADS;
    if (e >= NC * x.r4) continue;
    const int c = e / x.r4, q = e - c * x.r4;
    if (c >= N) continue;
    const float hv[4] = {hs[k].x, hs[k].y, hs[k].z, hs[k].w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * q + i < R) hl[(size_t)(4 * q + i) * N + c] = hv[i];
    if (q == 0) trips_out[(size_t)b * N + c] = trips[k];
  }
}

using Kernel = void (*)(const float*, const float*, const float*, long long,
                        const unsigned char*, long long, float*, int*,
                        unsigned long long*, int, int, int, int, float, float,
                        float, int);

// The columns padded to a kernel's NC, and that kernel (the one that reads
// a flag, or the one that takes none); null past N*.
Kernel kernel_for(int N, bool flag, int& nc) {
  nc = N <= 1 ? 1 : N <= 2 ? 2 : 4;
  if (N > MU_H_NARROW_MAX) return nullptr;
  switch (nc) {
#if MU_H_NARROW_MAX >= 1
    case 1: return flag ? h_narrow_kernel<1, true> : h_narrow_kernel<1, false>;
#endif
#if MU_H_NARROW_MAX >= 2
    case 2: return flag ? h_narrow_kernel<2, true> : h_narrow_kernel<2, false>;
#endif
#if MU_H_NARROW_MAX >= 3
    case 4: return flag ? h_narrow_kernel<4, true> : h_narrow_kernel<4, false>;
#endif
    default: return nullptr;
  }
}

struct Plan {
  Kernel kernel;
  int nc, bytes;
  int resident;   // clusters the card holds at once
};

// The launch: one cluster of C blocks a lane.
struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Launch(const Plan& p, int B, cudaStream_t s) {
    cfg = {};
    cfg.gridDim = dim3(C, B, 1);
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

// Whether (F, R, N) takes the narrow path: N <= N*, R <= 256 and the
// slice's layout fits a block; p.kernel (given a flag or not) is null for
// the wide path.  Returns 0 or a CUDA error.
int plan(int F, int R, int N, bool flag, Plan& p) {
  p.kernel = kernel_for(N, flag, p.nc);
  const size_t bytes = sizeof(float) * (size_t)layout(F, R, p.nc).floats;
  if (R > MAX_R || bytes > MAX_SMEM) p.kernel = nullptr;
  if (p.kernel == nullptr) return 0;
  p.bytes = (int)bytes;
  cudaError_t err = cudaFuncSetAttribute(
      p.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(p.kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static int asked_dev = -1, asked_bytes = 0, resident = 0;
  static Kernel asked_kernel = nullptr;
  if (asked_dev != dev || asked_bytes != p.bytes ||
      asked_kernel != p.kernel) {
    Launch l(p, 1, nullptr);
    err = cudaOccupancyMaxActiveClusters(&resident, p.kernel, &l.cfg);
    if (err != cudaSuccess) return (int)err;
    asked_dev = dev;
    asked_bytes = p.bytes;
    asked_kernel = p.kernel;
  }
  p.resident = resident;
  return 0;
}

}  // namespace narrow

}  // namespace

// The launch of mu_h_solve_lanes for B lanes of (F, R, N): out = {cluster
// size, group, groups a lane, shared-memory bytes per block, threads per
// block, clusters the card holds at once, lanes in groups of `group`, the
// last wave's group, clusters launched, the path (0 wide, 1 narrow), waves
// of resident clusters}.  On the narrow path the group is N padded to the
// kernel's 1, 2 or 4 columns, one cluster a lane.  Returns as plan().
extern "C" int mu_h_solve_lanes_shape(int B, int F, int R, int N, int* out) {
  narrow::Plan q;
  int rc = narrow::plan(F, R, N, false, q);
  if (rc != 0) return rc;
  if (q.kernel != nullptr) {
    const int res = q.resident > 0 ? q.resident : 1;
    const int vals[11] = {narrow::C, q.nc, 1, q.bytes, narrow::THREADS,
                          q.resident, B, q.nc, B, 1, (B + res - 1) / res};
    for (int i = 0; i < 11; ++i) out[i] = vals[i];
    return 0;
  }
  Plan p;
  rc = plan(B, F, R, N, false, p);
  if (rc != 0) return rc;
  const int res = p.resident > 0 ? p.resident : 1;
  const int vals[11] = {C, p.g, (N + p.g - 1) / p.g, p.bytes, THREADS,
                        p.resident, p.lanes_full, p.g2, p.units, 0,
                        (p.units + res - 1) / res};
  for (int i = 0; i < 11; ++i) out[i] = vals[i];
  return 0;
}

// C entry.  v (B,F,N), w (B,F,R), h0 (B,R,N) with lane stride h0_lane_stride
// (0 broadcasts one (R,N) start to every lane); outputs h (B,R,N) and the
// per-column trip counts (B,N).  `active`, or null (every lane solved), is a
// flag a lane, lane b's at active[b * active_stride]: a lane whose flag is 0
// returns its H0 columns and 0 trips.  `counts` (2,) uint64, or null, is
// added to where `active` is given: the lanes, and those skipped.  N <= N*
// takes the narrow path, the rest the wide one; both take the flag.
// Launches on `stream`, does not synchronise; returns the launch's error (a
// refused cluster launch included) or plan()'s -1.
extern "C" int mu_h_solve_lanes(const float* v, const float* w,
                                const float* h0, long long h0_lane_stride,
                                const unsigned char* active,
                                long long active_stride, float* h, int* trips,
                                unsigned long long* counts, int B, int F,
                                int R, int N, int max_iter, float conv_eps,
                                float sparsity, float flr, void* stream) {
  if (B == 0 || N == 0) return 0;
  narrow::Plan q;
  int rc = narrow::plan(F, R, N, active != nullptr, q);
  if (rc != 0) return rc;
  cudaError_t err;
  if (q.kernel != nullptr) {
    const int vec = R % 4 == 0 &&
                    reinterpret_cast<unsigned long long>(w) % 16 == 0;
    narrow::Launch l(q, B, static_cast<cudaStream_t>(stream));
    err = cudaLaunchKernelEx(&l.cfg, q.kernel, v, w, h0, h0_lane_stride,
                             active, active_stride, h, trips, counts, F, R,
                             N, max_iter, conv_eps, sparsity, flr, vec);
  } else {
    Plan p;
    rc = plan(B, F, R, N, active != nullptr, p);
    if (rc != 0) return rc;
    Launch l(p, static_cast<cudaStream_t>(stream));
    err = cudaLaunchKernelEx(&l.cfg, h_lanes_kernel, v, w, h0,
                             h0_lane_stride, active, active_stride, h, trips,
                             counts, F, R, N, B, p.g, p.resident, max_iter,
                             conv_eps, sparsity, flr);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
