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
// Problem:  V (F, N), W (F, R), H0 (R, N) or one (R, 1) column, columns
// independent.
//   W <- W / ||W||_col,  H <- H0 * ||W||_col,  dph = max(1'W + sparsity, flr)
//   each trip:  H <- H * W'(V / L) / dph  (active columns),  L = max(W H, flr)
//
// What bounds it on the H100.  A trip is 2*F*R FMAs a column (205 kFMA at
// F=513, R=200); the fast plan's N = 24,576 columns take ~28 trips on
// average and up to the cap, so a call is a few hundred GFLOP against
// ~120 MB of bytes: the FP32 FMA rate bounds it.  The earlier design (one
// block per 16-column tile) streamed both layouts of W from L2 on every
// trip of every tile (one L2 load per 16 FMAs), ran each tile until its
// slowest column stopped, and left one row of F=513 to a third round of the
// block.
//
// Design of the resident path (W's slice fits in shared memory):
// * Persistent clusters.  The grid is the clusters the card holds at once
//   (C = 8 blocks each; 15 on the H100 at this shared memory).  F is split
//   into C row slices; block k loads and normalises its slice of W once
//   (65 x 200 f32 = 52 KB) and keeps it for the whole call, so W is read
//   once a cluster, not once a tile and trip.
// * Column slots with refill.  A cluster holds G column slots (up to 96; 88
//   at F=513, R=200) and owns every n-th column of the call (n = cluster,
//   cluster + clusters, ...).  A slot whose column stops (its own
//   relative-cost test, or the cap) is written out and takes the cluster's
//   next column at once (one warp hands the columns out while the others
//   update H), so executed work stays close to the columns' own
//   trips instead of a group's slowest column.  A column's arithmetic does
//   not depend on its slot, its neighbours or the cluster it lands in (each
//   sum over R and over a slice of F runs in a fixed order inside one
//   thread, the slices add in rank order), so its result is the same bits
//   wherever and whenever it is solved.
// * Per trip each block runs two register-blocked FFMA products from shared
//   memory, operands read as float4: L = W_slice H in 4 x 4 tiles (then
//   U = V / L and the KL terms of its rows; V is read through its strides
//   from L2 into registers before the product), and the partial numerator
//   W_slice' U in 12 x 4 tiles; tiles whose four slots are all idle are
//   skipped.  Block k owns ceil(R/C) rows of H: it adds the C partial
//   numerators of its rows through distributed shared memory in rank order,
//   updates them and writes them into every block's copy of H.  Each
//   column's cost is the rank-ordered sum of the blocks' partials (KL terms
//   of their rows plus the penalty of their rows of H); every block takes
//   the same stop decisions from the same sums.  Two cluster barriers a
//   trip; a column that reaches the cap leaves after its update, so its
//   last L is never computed.
// * The work tally: where `counts` is not null, each column adds 1 to
//   counts[0] and its trips to counts[1] when it is written out (rank 0,
//   one thread a column; on the streaming path the thread that writes its
//   trip count), so the caller can tell the work the launches ran from the
//   columns they solved.
// * V, H0 and H are addressed through element strides, so the fast plan
//   hands over its frame-major spectra (B*T, F) as the (F, N) view without a
//   transposing copy (a column is then contiguous over F), and H0 may be one
//   (R, 1) column broadcast with stride 0.
//
// The streaming path (mu_tile.cuh) serves the shapes whose slice of W does
// not fit in a block's 227 KB (the exemplar width R=1000: 65 x 1004 f32 =
// 261 KB): W normalised once into both layouts and streamed from L2
// through a ring of bulk-copied chunks in each 16-column tile's shared
// memory, into register-blocked FFMA tiles.  The C entry chooses by shape;
// mu_h_solve_columns_shape reports the choice.
//
// Shared memory per block of the resident path (floats; G slots; RP = R
// padded to 8; FP = ceil(F/C) padded to 4; W's row stride WS = RP + 4; the
// last 12-row numerator tile may read up to 4 floats past a row of W):
//   W slice FP*WS + 4 | H RP*G | partial numerator RP*G | U FP*G |
//   cost of each 4-row tile (FP/4)*G | norms, 1'W (2 partial, 2 final) 4*RP |
//   per slot: last cost, cost partial, active, updates done, column,
//   update flag, done flag, next column 8*G | scalars 4
//
// No fast math: the relative-cost test relies on IEEE inf/NaN at a column's
// first trip (|cost - inf| / inf is NaN, and NaN < eps is false) and on an
// accurate logf.  Float32 throughout, no tensor cores.

#include <cooperative_groups.h>

#include "mu_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int RES_THREADS = 384;
constexpr int BR = 12;          // rows of a numerator tile
constexpr int C = 8;            // blocks of a cluster
constexpr int MAX_SLOTS = 96;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// The shared-memory carve-out of one block, as float offsets.
struct Layout {
  int g, fp, rp, ws;
  int w, h, n, u, tc, ss, cs, norm, dph, last, cpart, active, k, col, upd,
      done, next_col, scal;
  int floats;
};

__host__ __device__ inline Layout layout(int F, int R, int g) {
  Layout l;
  l.g = g;
  l.fp = round4((F + C - 1) / C);
  l.rp = (R + 7) & ~7;
  l.ws = l.rp + 4;
  int o = 0;
  l.w = o;      o += l.fp * l.ws + 4;   // + the last tile's overrun
  l.h = o;      o += l.rp * g;
  l.n = o;      o += l.rp * g;
  l.u = o;      o += l.fp * g;
  l.tc = o;     o += (l.fp / 4) * g;
  l.ss = o;     o += l.rp;
  l.cs = o;     o += l.rp;
  l.norm = o;   o += l.rp;
  l.dph = o;    o += l.rp;
  l.last = o;   o += g;
  l.cpart = o;  o += g;
  l.active = o; o += g;
  l.k = o;      o += g;
  l.col = o;    o += g;
  l.upd = o;    o += g;
  l.done = o;   o += g;
  l.next_col = o; o += g;
  l.scal = o;   o += 4;
  l.floats = o;
  return l;
}

inline size_t res_smem_bytes(int F, int R, int g) {
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

// True when one of the four slots from j0 is active.
__device__ __forceinline__ bool any_active(const int* sActive, int j0) {
  const int4 a = *reinterpret_cast<const int4*>(sActive + j0);
  return (a.x | a.y | a.z | a.w) != 0;
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
  int* sCol;
  int* sUpd;
  const float* v;
  long long v_sf, v_sn;
  int flo, nf;       // this block's rows of F
  int rlo, rhi;      // this block's rows of H
  int g, ws, rp, nct;
  float flr, sparsity;
};

// One pass over the block's rows of F with the current H of every active
// slot: L = max(W H, flr), U = V / L, (with `cost`) each slot's KL terms
// over the rows plus the penalty of the block's rows of H into sCpart, and
// the partial numerator W' U into sN.  One tile a thread and round: 4 rows
// x 4 slots of L, BR (12) rows x 4 slots of the numerator.
__device__ void pass(const Ctx& x, bool cost) {
  const int tid = threadIdx.x;
  const int g = x.g, ws = x.ws, nct = x.nct;
  const int nrt = (x.nf + 3) / 4;
  for (int t = tid; t < nrt * nct; t += RES_THREADS) {
    int rt, ct;
    strip_tile(t, nrt, nct, rt, ct);
    const int f0 = 4 * rt, j0 = 4 * ct;
    if (!any_active(x.sActive, j0)) continue;
    float vv[4][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = x.sCol[j0 + jj];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int f = f0 + i;
        vv[i][jj] = f < x.nf && n >= 0
                        ? fmaxf(__ldg(x.v + (x.flo + f) * x.v_sf +
                                      n * x.v_sn), x.flr)
                        : 1.f;
      }
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
      for (int q = 0; q < 4; ++q) hb[q] = ld4(hc + (r + q) * g);
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
      st4(x.sU + (f0 + i) * g + j0, make_float4(u[0], u[1], u[2], u[3]));
    }
    if (cost)
      st4(x.sTc + rt * g + j0, make_float4(cp[0], cp[1], cp[2], cp[3]));
  }
  __syncthreads();
  constexpr int BQ = BR / 4;
  const int nrb = (x.rp + BR - 1) / BR;
  for (int t = tid; t < nrb * nct; t += RES_THREADS) {
    int rt, ct;
    strip_tile(t, nrb, nct, rt, ct);
    const int r0 = BR * rt, j0 = 4 * ct;
    if (!any_active(x.sActive, j0)) continue;
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
      const float4 u = ld4(uc + f * g);
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
        st4(x.sN + (r0 + i) * g + j0,
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
  }
  if (cost) {
    for (int j = tid; j < g; j += RES_THREADS) {
      if (!x.sActive[j]) continue;
      float div = 0.f;
      for (int rt = 0; rt < nrt; ++rt) div += x.sTc[rt * g + j];
      float pen = 0.f;
      for (int r = x.rlo; r < x.rhi; ++r) pen += x.sparsity * x.sH[r * g + j];
      x.sCpart[j] = div + pen;
    }
  }
}

// Refill, by one warp: the idle slots take the cluster's next columns (cid,
// cid + ncl, ...) in slot order; sNew[j] is the column slot j takes, or -1.
// Every block of the cluster computes the same assignment.  sScal: [0] the
// active slots after the refill, [1] the columns handed out so far.
__device__ void refill(int* sActive, int* sNew, int* sScal, int g,
                       int n_mine, int cid, int ncl) {
  const int lane = threadIdx.x & 31;
  int next = sScal[1], n_active = 0;
  for (int j0 = 0; j0 < g; j0 += 32) {
    const int j = j0 + lane;
    const bool idle = j < g && !sActive[j];
    const unsigned m = __ballot_sync(0xffffffffu, idle);
    const int q = next + __popc(m & ((1u << lane) - 1u));
    const bool take = idle && q < n_mine;
    if (j < g) {
      sNew[j] = take ? cid + q * ncl : -1;
      if (take) sActive[j] = 1;
    }
    const int taken = min(__popc(m), max(n_mine - next, 0));
    next += taken;
    n_active += __popc(__ballot_sync(0xffffffffu, j < g && !idle)) + taken;
  }
  __syncwarp();
  if (lane == 0) {
    sScal[0] = n_active;
    sScal[1] = next;
  }
}

// H <- H * (sum of the C partial numerators, in rank order) / dph on the
// slots that update this trip, for the block's own rows of H, written into
// every block's copy; run by the threads from `first` on.
__device__ void update_h(const Ctx& x, cg::cluster_group& cluster,
                         int first) {
  const int nct = x.nct, g = x.g;
  const int nown = x.rhi - x.rlo;
  for (int e = (int)threadIdx.x - first; e < nown * nct;
       e += RES_THREADS - first) {
    const int r = x.rlo + e / nct, j0 = 4 * (e % nct);
    const int4 up = *reinterpret_cast<const int4*>(x.sUpd + j0);
    if (!(up.x | up.y | up.z | up.w)) continue;
    const int off = r * g + j0;
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
    if (up.x) hv.x = hv.x * s.x / d;
    if (up.y) hv.y = hv.y * s.y / d;
    if (up.z) hv.z = hv.z * s.z / d;
    if (up.w) hv.w = hv.w * s.w / d;
#pragma unroll
    for (int q = 0; q < C; ++q)
      st4(cluster.map_shared_rank(x.sH, q) + off, hv);
  }
}

__global__ void __launch_bounds__(RES_THREADS, 1)
h_cols_resident_kernel(const float* __restrict__ v, long long v_sf,
                       long long v_sn, const float* __restrict__ w,
                       const float* __restrict__ h0, long long h0_sr,
                       long long h0_sn, float* __restrict__ h_out,
                       long long h_sr, long long h_sn,
                       int* __restrict__ trips_out,
                       unsigned long long* __restrict__ counts, int F, int R,
                       int N, int g, int max_iter, float conv_eps,
                       float sparsity, float flr) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Layout l = layout(F, R, g);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.y, ncl = gridDim.y;
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
  x.sCol = reinterpret_cast<int*>(smem + l.col);
  x.sUpd = reinterpret_cast<int*>(smem + l.upd);
  float* sSS = smem + l.ss;
  float* sCS = smem + l.cs;
  float* sNorm = smem + l.norm;
  float* sLast = smem + l.last;
  int* sK = reinterpret_cast<int*>(smem + l.k);
  int* sDone = reinterpret_cast<int*>(smem + l.done);
  int* sNew = reinterpret_cast<int*>(smem + l.next_col);
  int* sScal = reinterpret_cast<int*>(smem + l.scal);   // see refill()
  x.v = v;
  x.v_sf = v_sf;
  x.v_sn = v_sn;
  const int fbase = F / C, frem = F % C;
  x.flo = rank * fbase + min(rank, frem);
  x.nf = fbase + (rank < frem ? 1 : 0);
  const int rc = (R + C - 1) / C;
  x.rlo = min(R, rank * rc);
  x.rhi = min(R, x.rlo + rc);
  x.g = g;
  x.ws = l.ws;
  x.rp = l.rp;
  x.nct = g / 4;
  x.flr = flr;
  x.sparsity = sparsity;
  const int ws = l.ws, rp = l.rp;
  // this cluster's columns: cid, cid + ncl, ...
  const int n_mine = cid < N ? (N - cid + ncl - 1) / ncl : 0;

  // W's rows of the slice (padding rows and columns zero), normalised over
  // the cluster; dph from the column sums
  for (int e = tid; e < l.fp * ws; e += RES_THREADS) {
    const int f = e / ws, r = e - f * ws;
    x.sW[e] = f < x.nf && r < R ? w[(size_t)(x.flo + f) * R + r] : 0.f;
  }
  for (int e = tid; e < rp * g; e += RES_THREADS) x.sH[e] = 0.f;
  for (int j = tid; j < g; j += RES_THREADS) {
    x.sActive[j] = 0;
    x.sCol[j] = -1;
    x.sUpd[j] = 0;
    sDone[j] = 0;
    sNew[j] = -1;
    sK[j] = 0;
  }
  if (tid == 0) sScal[1] = 0;
  __syncthreads();
  for (int r = tid; r < rp; r += RES_THREADS) {
    float ss = 0.f;
    for (int f = 0; f < x.nf; ++f) {
      const float a = x.sW[f * ws + r];
      ss += a * a;
    }
    sSS[r] = ss;
  }
  cluster.sync();
  for (int r = tid; r < rp; r += RES_THREADS) {
    float ss = 0.f;
    for (int q = 0; q < C; ++q) ss += cluster.map_shared_rank(sSS, q)[r];
    sNorm[r] = sqrtf(ss);
  }
  __syncthreads();
  for (int e = tid; e < x.nf * ws; e += RES_THREADS) {
    const int r = e % ws;
    if (r < R) {
      const float nrm = sNorm[r];
      x.sW[e] = x.sW[e] / (nrm > 0.f ? nrm : 1.f);
    }
  }
  __syncthreads();
  for (int r = tid; r < rp; r += RES_THREADS) {
    float cs = 0.f;
    for (int f = 0; f < x.nf; ++f) cs += x.sW[f * ws + r];
    sCS[r] = cs;
  }
  cluster.sync();
  for (int r = tid; r < rp; r += RES_THREADS) {
    float cs = 0.f;
    for (int q = 0; q < C; ++q) cs += cluster.map_shared_rank(sCS, q)[r];
    x.sDph[r] = r < R ? fmaxf(cs + sparsity, flr) : 1.f;
  }
  __syncthreads();

  // the shared start column rescaled by the norms, in the room of the
  // set-up's partial sums
  float* sH0 = sSS;
  const bool shared_h0 = h0_sn == 0;
  if (shared_h0)
    for (int r = tid; r < rp; r += RES_THREADS)
      sH0[r] = r < R ? h0[r * h0_sr] * sNorm[r] : 0.f;
  if (warp == 0) refill(x.sActive, sNew, sScal, g, n_mine, cid, ncl);
  __syncthreads();

  for (;;) {
    // intake, a warp per slot: a finished slot's rows of H (the block's
    // own) and its trip count (rank 0) go out; a slot that takes a new
    // column gets that column's H0 rescaled by the norms, in this block's
    // copy of H
    for (int j = warp; j < g; j += RES_THREADS / 32) {
      if (sDone[j]) {
        const int n = x.sCol[j];
        for (int r = x.rlo + lane; r < x.rhi; r += 32)
          h_out[r * h_sr + n * h_sn] = x.sH[r * g + j];
        if (rank == 0 && lane == 0) {
          trips_out[n] = sK[j];
          if (counts != nullptr) {
            atomicAdd(counts, 1ULL);
            atomicAdd(counts + 1, (unsigned long long)sK[j]);
          }
        }
      }
      const int n = sNew[j];
      if (n < 0) continue;
      for (int r = lane; r < rp; r += 32)
        x.sH[r * g + j] = shared_h0 ? sH0[r]
                          : r < R   ? h0[r * h0_sr + n * h0_sn] * sNorm[r]
                                    : 0.f;
      if (lane == 0) {
        x.sCol[j] = n;
        sK[j] = 0;
        sLast[j] = INFINITY;
      }
    }
    __syncthreads();
    if (sScal[0] == 0) break;

    pass(x, early);
    cluster.sync();
    // each active slot: the stop test of its last update, then whether it
    // updates now and whether that update is its last
    for (int j = tid; j < g; j += RES_THREADS) {
      int upd = 0, done = 0;
      if (x.sActive[j]) {
        const int k = sK[j];
        bool stop = false;
        if (early && k >= 1) {
          float cost = 0.f;
          for (int q = 0; q < C; ++q)
            cost += cluster.map_shared_rank(x.sCpart, q)[j];
          const float last = sLast[j];
          const float rel = fabsf(cost - last) / fabsf(last);
          stop = k >= 2 && rel < conv_eps;
          sLast[j] = cost;
        }
        if (stop || k >= max_iter) {
          done = 1;
        } else {
          upd = 1;
          sK[j] = k + 1;
          done = k + 1 >= max_iter ? 1 : 0;
        }
        if (done) x.sActive[j] = 0;
      }
      x.sUpd[j] = upd;
      sDone[j] = done;
    }
    __syncthreads();
    // warp 0 hands the idle slots their next columns while the others
    // update H
    if (warp == 0)
      refill(x.sActive, sNew, sScal, g, n_mine, cid, ncl);
    else
      update_h(x, cluster, 32);
    cluster.sync();
  }
}

// The launch of the resident path.
struct ResLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  ResLaunch(int clusters, int bytes, cudaStream_t s) {
    cfg = {};
    cfg.gridDim = dim3(C, clusters, 1);
    cfg.blockDim = dim3(RES_THREADS, 1, 1);
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

struct Plan {
  int resident_path;   // 1: W resident in a persistent cluster; 0: streaming
  int slots, bytes, clusters, resident, threads;
  Ring ring;           // the streaming path's ring of W chunks
};

// Returns 0, -1 when neither path fits in shared memory, or a CUDA error.
int plan(int F, int R, int N, Plan& p) {
  p.ring = Ring{0, 0, 0, 0, 0, 0, 0, 0};
  int g = MAX_SLOTS;
  while (g >= 4 && res_smem_bytes(F, R, g) > MAX_SMEM) g -= 4;
  if (g >= 4 && F >= C) {
    p.resident_path = 1;
    p.bytes = (int)res_smem_bytes(F, R, g);
    p.threads = RES_THREADS;
    cudaError_t err = cudaFuncSetAttribute(
        h_cols_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        p.bytes);
    if (err != cudaSuccess) return (int)err;
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    static int asked_dev = -1, asked_bytes = 0, resident = 0;
    if (asked_dev != dev || asked_bytes != p.bytes) {
      ResLaunch l(1, p.bytes, nullptr);
      err = cudaOccupancyMaxActiveClusters(&resident, h_cols_resident_kernel,
                                           &l.cfg);
      if (err != cudaSuccess) return (int)err;
      asked_dev = dev;
      asked_bytes = p.bytes;
    }
    if (resident < 1) return (int)cudaErrorLaunchOutOfResources;
    p.resident = resident;
    // no more clusters than fill their slots once, and slots evened out
    const int want = (N + g - 1) / g;
    p.clusters = want < resident ? want : resident;
    const int per = (N + p.clusters - 1) / p.clusters;
    p.slots = round4(per) < g ? round4(per) : g;
    p.bytes = (int)res_smem_bytes(F, R, p.slots);
    return 0;
  }
  p.resident_path = 0;
  p.slots = TN;
  p.threads = BLOCK_THREADS;
  p.clusters = (N + TN - 1) / TN;
  p.resident = 0;
  if (!stream_ring(F, R, p.ring)) return -1;
  p.bytes = (int)tile_smem_bytes(F, R, p.ring);
  return 0;
}

}  // namespace

// Which path mu_h_solve_columns takes for (F, R, N): out = {1 resident-W
// path / 0 streaming path, column slots of a cluster (columns of a tile),
// shared-memory bytes per block, threads per block, clusters (blocks)
// launched, clusters the card holds at once (0 on the streaming path), and
// the streaming path's ring: stages, rows of W a numerator chunk, rows of
// W' an L chunk, the rounds of rows of the numerator and of the L pass
// (each a sweep of its layout; 0 on the resident path)}.  Returns as
// plan().
extern "C" int mu_h_solve_columns_shape(int F, int R, int N, int* out) {
  Plan p;
  const int rc = plan(F, R, N > 0 ? N : 1, p);
  if (rc != 0) return rc;
  const int vals[11] = {p.resident_path,    p.slots,    p.bytes,
                        p.threads,          p.clusters, p.resident,
                        p.ring.stages,      p.ring.kf,  p.ring.kr,
                        p.ring.num_rounds,  p.ring.lam_rounds};
  for (int i = 0; i < 11; ++i) out[i] = vals[i];
  return 0;
}

// C entry.  v: (F, N) with element strides (v_sf, v_sn); w (F, R)
// contiguous; h0: (R, N) with strides (h0_sr, h0_sn), h0_sn = 0 for one
// broadcast column; outputs h (R, N) with strides (h_sr, h_sn) and the
// per-column trip counts (N,); `counts` (4,) uint64, or null, is added
// to: the columns solved and their trips, and (streaming path) the ring's
// chunks taken and those that had not landed; scratch wn, dph (R,) and
// w_n, w_t (pad4(F) * pad4(R) each), touched by the streaming path only.
// Launches on `stream`, does not synchronise, returns the launch's error,
// or -1 when the shape fits neither path's shared memory.
extern "C" int mu_h_solve_columns(const float* v, long long v_sf,
                                  long long v_sn, const float* w,
                                  const float* h0, long long h0_sr,
                                  long long h0_sn, float* h, long long h_sr,
                                  long long h_sn, int* trips,
                                  unsigned long long* counts, float* wn,
                                  float* dph, float* w_n, float* w_t, int F,
                                  int R, int N, int max_iter, float conv_eps,
                                  float sparsity, float flr, void* stream) {
  if (N == 0) return 0;
  Plan p;
  const int rc = plan(F, R, N, p);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.resident_path) {
    cudaError_t err = cudaFuncSetAttribute(
        h_cols_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        p.bytes);
    if (err != cudaSuccess) return (int)err;
    ResLaunch l(p.clusters, p.bytes, s);
    err = cudaLaunchKernelEx(&l.cfg, h_cols_resident_kernel, v, v_sf, v_sn,
                             w, h0, h0_sr, h0_sn, h, h_sr, h_sn, trips,
                             counts, F, R, N, p.slots, max_iter, conv_eps,
                             sparsity, flr);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  return stream_solve(v, v_sf, v_sn, w, h0, h0_sr, h0_sn, h, h_sr, h_sn,
                      trips, counts, wn, dph, w_n, w_t, F, R, N, max_iter,
                      conv_eps, sparsity, flr, (size_t)p.bytes, p.ring, s);
}
