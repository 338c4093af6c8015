// The streaming path of the shared-dictionary per-column KL H-solve
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
// What bounds it on the H100.  A trip is 2*F*R*TN FMAs a tile (16.4 MFMA
// at F=513, R=1000) on operands that do not fit in shared memory: W (2 MB
// in each layout) is read from L2 once a trip and layout by every tile.
// The earlier design had every thread load its own W value from L2 and
// spend 16 FMAs on it, at 9 warps a SM, which cannot cover L2's latency:
// 21% of the FP32 peak.  Here the FFMA rate that register-blocked tiles
// reach from shared memory binds: 4 x 8 tiles, their operands loaded a row
// ahead, at 16 or 8 warps (a block of 18 warps holds 96 registers a thread).
//
// Design.  W is normalised once by a first kernel into both layouts,
// rows padded to 4 floats (L2-resident, shared by every block).  U = V/L,
// the KL terms of the L pass (2 x F x TN f32) and H (R x TN) live in shared
// memory, beside a ring of W chunks; V is read through its strides where U
// is formed, a trip:
// * One producer warp (one thread) streams W through the ring with bulk
//   copies (cp.async.bulk), completed on an mbarrier a stage: chunks of
//   `kf` rows of W (numerator pass) or `kr` rows of W' (L pass), in the
//   order the passes take them, running ahead of the consumers by up to the
//   ring's depth across passes and trips; a chunk issued past the tile's
//   last trip is waited for and dropped.  At F=513, R=1000: two stages of
//   12 rows of W or 24 of W' (49.5 KB each).
// * 16 main consumer warps run register-blocked FFMA products on the chunk
//   that has landed, then hand its stage back (each consumer warp arrives
//   on the stage's empty barrier):
//     W'U:  a thread of the 16 warps owns 4 rows of H x 8 columns;
//     W H:  a thread of the first 8 owns 4 rows of L x 8 columns, then
//           forms U and the KL terms of its rows;
//   a row of the chunk, one float4 of W (or W') and two float4s of U (or
//   H) feed 32 FMAs.  A 17th, auxiliary warp sums the rows of L past the
//   8 warps' 512 a round (up to 2: F = 513 leaves the Nyquist row), a
//   column a lane, and the columns' penalties over R as the rows of H go
//   by.
// Every sum over F or R runs in one thread in ascending order, and each
// column's cost is summed as before: the KL terms staged in shared memory
// are added a row after another by the thread of the stream_threads deal
// (rows f, f + deal, ...), then by warp shuffle, the warps in rank order,
// and the penalty over R, so H and the trip counts are the bits of the
// earlier designs.  A trip whose column reaches the cap leaves without its
// L, which nothing reads.
//
// The tally: where `counts` is not null, counts[2] gets the chunks a
// block's consumers took from the ring and counts[3] those that warp 0
// found not yet landed at its first probe, one atomic each a block.
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
constexpr int MAIN_WARPS = 16;       // the numerator's warps
constexpr int MAIN_THREADS = 32 * MAIN_WARPS;
constexpr int CONSUMERS = MAIN_THREADS + 32;     // + the auxiliary warp
constexpr int BLOCK_THREADS = CONSUMERS + 32;    // + the producer warp
constexpr int NUM_ROWS = 4 * (MAIN_THREADS / 2);  // rows of H a round
constexpr int LAM_WARPS = MAIN_WARPS / 2;         // the L product's warps
constexpr int LAM_ROWS = 4 * (32 * LAM_WARPS / 2);  // rows of L a round
constexpr int LEFTOVER = 2;          // rows of L the auxiliary warp takes
constexpr int NORM_THREADS = 32;     // columns of W per normalisation block
constexpr size_t MAX_SMEM = 232448;  // 227 KB: a block's dynamic limit
constexpr int RING_STAGES = 4;       // the ring's depth at most
constexpr int CHUNK_F = 12;          // rows of W a numerator chunk, at most
constexpr int CHUNK_R = 24;          // rows of W' an L chunk, at most
constexpr int BAR_BYTES = 128;       // the ring's mbarriers, full and empty
static_assert(RING_STAGES >= 2 && 16 * RING_STAGES <= BAR_BYTES,
              "the ring holds 2 to 8 stages");

__host__ __device__ inline int pad4(int x) { return (x + 3) & ~3; }

// The deal of the rows of F over threads that orders each column's cost
// sum: the rows evenly over the fewest rounds of at most STREAM_MAX_THREADS,
// a multiple of 32, and no fewer than the rows of H need (up to the same
// maximum); thread t adds the KL terms of rows t, t + deal, ...
inline int stream_threads(int F, int R) {
  const int rounds = (F + STREAM_MAX_THREADS - 1) / STREAM_MAX_THREADS;
  int t = ((F + rounds - 1) / rounds + 31) & ~31;
  const int for_r = ((R < STREAM_MAX_THREADS ? R : STREAM_MAX_THREADS) + 31)
                    & ~31;
  if (t < for_r) t = for_r;
  return t < STREAM_MAX_THREADS ? t : STREAM_MAX_THREADS;
}

// A tile's plan: the ring (its stages, the floats of a stage, the rows of W
// (F-rows, numerator pass) and of W' (R-rows, L pass) a chunk holds), the
// rounds of rows each pass sweeps its layout for, the rows of L the main
// warps cover (the auxiliary warp takes the rest), and the cost deal.
struct Ring {
  int stages, stage_floats, kf, kr;
  int num_rounds, lam_rounds, lam_main, deal;
};

// Shared memory of a tile besides the ring.
inline size_t tile_fixed_bytes(int F, int R, int deal) {
  return BAR_BYTES
         + sizeof(float) * ((size_t)2 * F * TN + (size_t)R * TN
                            + (deal / 32) * TN + 2 * TN)
         + sizeof(int) * (2 * TN + 2);
}

// The deepest ring up to RING_STAGES whose stages hold full chunks
// (CHUNK_F rows of W, CHUNK_R rows of W'); else two stages of the largest
// chunks that fit; false when not even a row of each layout does.
inline bool stream_ring(int F, int R, Ring& g) {
  g.deal = stream_threads(F, R);
  g.num_rounds = (R + NUM_ROWS - 1) / NUM_ROWS;
  g.lam_rounds = F > LEFTOVER ? (F - LEFTOVER + LAM_ROWS - 1) / LAM_ROWS : 1;
  g.lam_main = F < g.lam_rounds * LAM_ROWS ? F : g.lam_rounds * LAM_ROWS;
  const size_t fixed = tile_fixed_bytes(F, R, g.deal);
  if (fixed >= MAX_SMEM) return false;
  const int rs = pad4(R), fs = pad4(F);
  for (int s = RING_STAGES; s >= 2; --s) {
    const int sf = (int)((MAX_SMEM - fixed) / sizeof(float) / s) & ~3;
    const int kf = sf / rs < CHUNK_F ? sf / rs : CHUNK_F;
    const int kr = sf / fs < CHUNK_R ? sf / fs : CHUNK_R;
    if ((kf == CHUNK_F && kr == CHUNK_R) || (s == 2 && kf >= 1 && kr >= 1)) {
      g.stages = s;
      g.kf = kf;
      g.kr = kr;
      g.stage_floats = kf * rs > kr * fs ? kf * rs : kr * fs;
      return true;
    }
  }
  return false;
}

inline size_t tile_smem_bytes(int F, int R, const Ring& g) {
  return tile_fixed_bytes(F, R, g.deal)
         + sizeof(float) * (size_t)g.stages * g.stage_floats;
}

// Normalise W (F, R) once, into both layouts (w_n (F, pad4(R)) and w_t
// (R, pad4(F)), the padding zero), with its column norms and dph.  Grid
// ceil(R / NORM_THREADS), one thread per column of W.
__global__ void normalize_w_kernel(const float* __restrict__ w,
                                   float* __restrict__ wn_out,
                                   float* __restrict__ w_n,
                                   float* __restrict__ w_t,
                                   float* __restrict__ dph,
                                   int F, int R, float sparsity, float flr) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int rs = pad4(R), fs = pad4(F);
  if (r >= R) {
    if (r < rs)
      for (int f = 0; f < F; ++f) w_n[(size_t)f * rs + r] = 0.f;
    return;
  }
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
    w_n[(size_t)f * rs + r] = x;
    w_t[(size_t)r * fs + f] = x;
    colsum += x;
  }
  for (int f = F; f < fs; ++f) w_t[(size_t)r * fs + f] = 0.f;
  wn_out[r] = norm;
  dph[r] = fmaxf(colsum + sparsity, flr);
}

// ---- the ring's mbarriers and bulk copies (PTX) ----

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* b,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

// True when the phase of parity `parity` has completed; test_wait returns
// at once, try_wait may first suspend the thread for a while.
__device__ __forceinline__ bool mbar_test(unsigned long long* b,
                                          unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(ok)
      : "r"(smem_u32(b)), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ bool mbar_try(unsigned long long* b,
                                         unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(ok)
      : "r"(smem_u32(b)), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ void mbar_wait(unsigned long long* b,
                                          unsigned parity) {
  while (!mbar_try(b, parity)) {
  }
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(b))
               : "memory");
}

// The producer's arrival, announcing the bytes the copy will complete.
__device__ __forceinline__ void mbar_expect(unsigned long long* b,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// memory into shared memory, completed on `b`.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(b))
      : "memory");
}

// The consumer warps' barrier (named barrier 1; the producer warp is not
// in it).
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// The tile's columns of V: n0 .. n0 + TN - 1 of N, element strides, the
// floor.
struct Cols {
  const float* v;
  long long v_sf, v_sn;
  int n0, N;
  float flr;
};

// ---- the tile's shared memory ----

struct Tile {
  unsigned long long* full;    // stages: a chunk has landed
  unsigned long long* empty;   // stages: every consumer warp is done with it
  float* ring;    // stages * stage_floats
  float* sU;      // F * TN   V / L
  float* sT;      // F * TN   KL terms of the L pass
  float* sH;      // R * TN
  float* sRed;    // deal / 32 * TN
  float* sPen;    // TN
  float* sLast;   // TN
  int* sActive;   // TN
  int* sTrips;    // TN
  int* sAny;      // 1
  int* sStop;     // 1: the consumers take no more chunks
};

__device__ __forceinline__ Tile carve(unsigned char* smem, int F, int R,
                                      const Ring& g) {
  Tile t;
  t.full = reinterpret_cast<unsigned long long*>(smem);
  t.empty = t.full + RING_STAGES;
  t.ring = reinterpret_cast<float*>(smem + BAR_BYTES);
  t.sU = t.ring + g.stages * g.stage_floats;
  t.sT = t.sU + F * TN;
  t.sH = t.sT + F * TN;
  t.sRed = t.sH + R * TN;
  t.sPen = t.sRed + g.deal / 32 * TN;
  t.sLast = t.sPen + TN;
  t.sActive = reinterpret_cast<int*>(t.sLast + TN);
  t.sTrips = t.sActive + TN;
  t.sAny = t.sTrips + TN;
  t.sStop = t.sAny + 1;
  return t;
}

// The ring as the consumers walk it: chunk c sits in stage c % stages and
// lands in phase (c / stages) & 1 of that stage's full barrier.  Every
// consumer thread keeps the same count.
struct Taker {
  int stage = 0;
  unsigned phase = 0;
  int chunks = 0;    // chunks taken
  int waits = 0;     // thread 0: chunks not landed at the first probe
};

__device__ __forceinline__ const float* take(const Tile& t, const Ring& g,
                                             Taker& k) {
  if (threadIdx.x == 0 && !mbar_test(&t.full[k.stage], k.phase)) ++k.waits;
  mbar_wait(&t.full[k.stage], k.phase);
  return t.ring + k.stage * g.stage_floats;
}

// The warp is done reading the stage: its lane 0 arrives on the stage's
// empty barrier (one arrival a consumer warp frees it).
__device__ __forceinline__ void give_back(const Tile& t, const Ring& g,
                                          Taker& k) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&t.empty[k.stage]);
  ++k.chunks;
  if (++k.stage == g.stages) {
    k.stage = 0;
    k.phase ^= 1;
  }
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[0..3] += a * (b.x, b.y, b.z, b.w)
__device__ __forceinline__ void ffma4(float* acc, float a, float4 b) {
  acc[0] += a * b.x;
  acc[1] += a * b.y;
  acc[2] += a * b.z;
  acc[3] += a * b.w;
}

// The producer (one thread): the chunks of the tile's passes in the order
// the consumers take them (the first L pass; then, a trip, the numerator
// pass and, but for the cap's trip, the L pass), each pass's sweep repeated
// for its rounds of rows.  Stops early when the consumers raise sStop, then
// waits until every chunk it issued has landed, so that no copy is in
// flight when the block exits.
__device__ void produce(const Tile& t, const Ring& g,
                        const float* __restrict__ w_n,
                        const float* __restrict__ w_t, int F, int R,
                        int max_iter) {
  const int rs = pad4(R), fs = pad4(F);
  const volatile int* stop = t.sStop;
  int issued = 0, stage = 0;
  unsigned phase = 0;
  // one chunk: wait until its stage is free (its previous chunk released:
  // the phase before this one; a fresh barrier reads that one as complete)
  auto issue = [&](const float* src, int floats) -> bool {
    while (!mbar_try(&t.empty[stage], phase ^ 1u))
      if (*stop) return false;
    mbar_expect(&t.full[stage], (unsigned)(sizeof(float) * floats));
    bulk_load(t.ring + stage * g.stage_floats, src,
              (unsigned)(sizeof(float) * floats), &t.full[stage]);
    ++issued;
    if (++stage == g.stages) {
      stage = 0;
      phase ^= 1u;
    }
    return true;
  };
  auto lam_pass = [&]() -> bool {
    for (int p = 0; p < g.lam_rounds; ++p)
      for (int r0 = 0; r0 < R; r0 += g.kr)
        if (!issue(w_t + (size_t)r0 * fs,
                   (R - r0 < g.kr ? R - r0 : g.kr) * fs))
          return false;
    return true;
  };
  auto num_pass = [&]() -> bool {
    for (int q = 0; q < g.num_rounds; ++q)
      for (int f0 = 0; f0 < F; f0 += g.kf)
        if (!issue(w_n + (size_t)f0 * rs,
                   (F - f0 < g.kf ? F - f0 : g.kf) * rs))
          return false;
    return true;
  };
  if (max_iter > 0 && lam_pass()) {
    for (int it = 0; it < max_iter; ++it) {
      if (!num_pass()) break;
      if (it + 1 < max_iter && !lam_pass()) break;
    }
  }
  // drain: the last chunk issued on each stage
  for (int c = issued > g.stages ? issued - g.stages : 0; c < issued; ++c)
    mbar_wait(&t.full[c % g.stages], (unsigned)((c / g.stages) & 1));
}

// One chunk of either product into a thread's 4 x 8 tile: ROWS (or `rows`
// when ROWS is 0) rows k of A (4 consecutive values from ap, row stride
// `as`) and of B (8 consecutive values from bp, row stride TN), acc[i][j] +=
// A[k][i] B[k][j] in ascending k; each row's operands are loaded while the
// row before is multiplied.
template <int ROWS>
__device__ __forceinline__ void tile_chunk(const float* __restrict__ ap,
                                           int as, const float* bp, int rows,
                                           float (&acc)[4][8]) {
  const int n = ROWS ? ROWS : rows;
  float4 a = lds4(ap), b0 = lds4(bp), b1 = lds4(bp + 4);
#pragma unroll
  for (int k = 0; k < n; ++k) {
    float4 an, bn0, bn1;
    if (k + 1 < n) {
      an = lds4(ap + (k + 1) * as);
      bn0 = lds4(bp + (k + 1) * TN);
      bn1 = lds4(bp + (k + 1) * TN + 4);
    }
    ffma4(&acc[0][0], a.x, b0);
    ffma4(&acc[0][4], a.x, b1);
    ffma4(&acc[1][0], a.y, b0);
    ffma4(&acc[1][4], a.y, b1);
    ffma4(&acc[2][0], a.z, b0);
    ffma4(&acc[2][4], a.z, b1);
    ffma4(&acc[3][0], a.w, b0);
    ffma4(&acc[3][4], a.w, b1);
    a = an;
    b0 = bn0;
    b1 = bn1;
  }
}

template <int FULL>
__device__ __forceinline__ void tile_chunk_any(const float* __restrict__ ap,
                                               int as, const float* bp,
                                               int rows, float (&acc)[4][8]) {
  if (rows == FULL)
    tile_chunk<FULL>(ap, as, bp, rows, acc);
  else
    tile_chunk<0>(ap, as, bp, rows, acc);
}

// H <- H * W'U / dph on the active columns.  Main thread m owns rows
// 4 (m / 2 + q NUM_ROWS / 4) .. + 3 of H and columns 8 (m % 2) .. + 7 for
// the rounds q; each sums over F in order, chunk after chunk, and updates
// its rows after the sweep.  The auxiliary warp takes the chunks only.
__device__ void numerator_pass(const Tile& t, const Ring& g, Taker& k,
                               const float* __restrict__ dphl, int F,
                               int R) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const int rs = pad4(R);
  const int chunks = (F + g.kf - 1) / g.kf;
  const bool main_warp = warp < MAIN_WARPS;
  const int col = 8 * (tid & 1);
  for (int q = 0; q < g.num_rounds; ++q) {
    const int r0 = 4 * (q * (NUM_ROWS / 4) + (tid >> 1));
    // rows past R (in the warp of the last rows) read the last four
    // columns of W and are not written
    const bool busy =
        main_warp && 4 * (q * (NUM_ROWS / 4) + 16 * warp) < R;
    const int rc = r0 < rs - 4 ? r0 : rs - 4;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int c = 0; c < chunks; ++c) {
      const float* wc = take(t, g, k);
      if (busy) {
        const int f0 = c * g.kf;
        const int rows = F - f0 < g.kf ? F - f0 : g.kf;
        tile_chunk_any<CHUNK_F>(wc + rc, rs, t.sU + f0 * TN + col, rows,
                                acc);
      }
      give_back(t, g, k);
    }
    if (!busy) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + i;
      if (r < R) {
        const float d = dphl[r];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (t.sActive[col + j])
            t.sH[r * TN + col + j] = t.sH[r * TN + col + j] * acc[i][j] / d;
      }
    }
  }
}

// One L chunk for the auxiliary warp: a leftover row of L in one column
// (wp's column of W', hp's column of H), and with PEN that column's
// penalty over these rows of H.
template <bool PEN>
__device__ __forceinline__ void leftover_chunk(const float* __restrict__ wp,
                                               const float* hp, int rows,
                                               int fs, float& acc,
                                               float& pen, float sparsity) {
#pragma unroll 4
  for (int rr = 0; rr < rows; ++rr) {
    const float h = hp[rr * TN];
    acc += wp[rr * fs] * h;
    if (PEN) pen += sparsity * h;
  }
}

// Row f, column j of L is done: U = V / max(L, flr) and, with `cost`, the
// KL term of the entry.
__device__ __forceinline__ void lambda_out(const Tile& t, int f, int j,
                                           float acc, float vv, float flr,
                                           bool cost) {
  const float lam = fmaxf(acc, flr);
  const float u = vv / lam;
  t.sU[f * TN + j] = u;
  if (cost) t.sT[f * TN + j] = vv * logf(u) - vv + lam;
}

// V's entry (f, n0 + j) floored; 1 past the last column.
__device__ __forceinline__ float v_at(const Cols& x, int f, int j) {
  const int n = x.n0 + j;
  return n < x.N ? fmaxf(x.v[f * x.v_sf + n * x.v_sn], x.flr) : 1.f;
}

// L = max(W H, flr) and U = V / L for the tile.  Of the main warps the
// first LAM_WARPS do the product: thread m owns rows 4 (m / 2 + p LAM_ROWS
// / 4) .. + 3 of L and columns 8 (m % 2) .. + 7 for the rounds p; the
// auxiliary warp's lane l owns row lam_main + l / 16 (if there is one) in
// column l % 16, and with `cost` sums column l's penalty over R into
// t.sPen.  With `cost`, the KL terms go to t.sT.
__device__ void lambda_pass(const Tile& t, const Ring& g, Taker& k,
                            const Cols& x, int F, int R, float sparsity,
                            bool cost) {
  const float flr = x.flr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int fs = pad4(F);
  const int chunks = (R + g.kr - 1) / g.kr;
  const bool lam_warp = warp < LAM_WARPS;
  const int col = 8 * (tid & 1);
  // the auxiliary warp: a leftover row in one column
  const int lrow = g.lam_main + (lane >> 4), lcol = lane & (TN - 1);
  const int lrc = lrow < fs ? lrow : fs - 1;
  const bool aux = warp == MAIN_WARPS && (cost || g.lam_main < F);
  float pen = 0.f;
  for (int p = 0; p < g.lam_rounds; ++p) {
    const int f0 = 4 * (p * (LAM_ROWS / 4) + (tid >> 1));
    const bool busy =
        lam_warp && 4 * (p * (LAM_ROWS / 4) + 16 * warp) < g.lam_main;
    const bool aux_now = aux && p == 0;
    const int fc = f0 < fs - 4 ? f0 : fs - 4;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    float left = 0.f;
    for (int c = 0; c < chunks; ++c) {
      const float* wc = take(t, g, k);
      const int r0 = c * g.kr;
      const int rows = R - r0 < g.kr ? R - r0 : g.kr;
      if (busy) {
        tile_chunk_any<CHUNK_R>(wc + fc, fs, t.sH + r0 * TN + col, rows,
                                acc);
      } else if (aux_now) {
        if (cost)
          leftover_chunk<true>(wc + lrc, t.sH + r0 * TN + lcol, rows, fs,
                               left, pen, sparsity);
        else
          leftover_chunk<false>(wc + lrc, t.sH + r0 * TN + lcol, rows, fs,
                                left, pen, sparsity);
      }
      give_back(t, g, k);
    }
    if (busy) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (f0 + i < g.lam_main)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            lambda_out(t, f0 + i, col + j, acc[i][j],
                       v_at(x, f0 + i, col + j), flr, cost);
    } else if (aux_now && lrow < F) {
      lambda_out(t, lrow, lcol, left, v_at(x, lrow, lcol), flr, cost);
    }
  }
  if (aux && cost && lane < TN) t.sPen[lane] = pen;
}

// The MU loop of one tile, run by the consumer threads.  On entry t.sH
// holds the rescaled H0 (columns past N: 0), visible to every consumer at
// the first barrier here.  Leaves H in t.sH and each column's trip count in
// t.sTrips; columns past N stay inactive.
__device__ void solve_tile(const Tile& t, const Ring& g, Taker& k,
                           const Cols& x, const float* __restrict__ dphl,
                           int F, int R, int max_iter, float conv_eps,
                           float sparsity) {
  const int tid = threadIdx.x;
  const int n_valid = x.N - x.n0;
  const bool early = conv_eps > 0.f;
  if (tid < TN) {
    t.sActive[tid] = tid < n_valid ? 1 : 0;
    t.sTrips[tid] = 0;
    t.sLast[tid] = INFINITY;
  }
  if (tid == 0) *t.sAny = 1;
  consumers_sync(CONSUMERS);
  if (max_iter > 0) lambda_pass(t, g, k, x, F, R, sparsity, false);
  consumers_sync(CONSUMERS);

  for (int it = 0; it < max_iter; ++it) {
    if (early && *t.sAny == 0) break;
    if (tid < TN) t.sTrips[tid] += t.sActive[tid];
    numerator_pass(t, g, k, dphl, F, R);
    consumers_sync(CONSUMERS);
    if (it + 1 == max_iter) break;     // the cap: this L is never read
    lambda_pass(t, g, k, x, F, R, sparsity, early);
    if (early) {
      consumers_sync(CONSUMERS);
      // each column's KL sum as the deal orders it: thread t adds rows t,
      // t + deal, ...; a warp's lanes by shuffle; the warps in rank order
      if (tid < g.deal) {
        const int lane = tid & 31, warp = tid >> 5;
        float cpart[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) cpart[j] = 0.f;
        for (int f = tid; f < F; f += g.deal)
#pragma unroll
          for (int j = 0; j < TN; ++j) cpart[j] += t.sT[f * TN + j];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float x = cpart[j];
          for (int off = 16; off > 0; off >>= 1)
            x += __shfl_down_sync(0xffffffffu, x, off);
          if (lane == 0) t.sRed[warp * TN + j] = x;
        }
      }
      consumers_sync(CONSUMERS);
      if (tid < TN) {
        float div = 0.f;
        for (int w = 0; w < g.deal / 32; ++w) div += t.sRed[w * TN + tid];
        const float cost = div + t.sPen[tid];
        const float rel = fabsf(cost - t.sLast[tid]) / fabsf(t.sLast[tid]);
        if (it > 0 && rel < conv_eps) t.sActive[tid] = 0;
        t.sLast[tid] = cost;
      }
      consumers_sync(CONSUMERS);
      if (tid == 0) {
        int any = 0;
        for (int j = 0; j < TN; ++j) any |= t.sActive[j];
        *t.sAny = any;
      }
    }
    consumers_sync(CONSUMERS);
  }
  if (tid == 0) *reinterpret_cast<volatile int*>(t.sStop) = 1;
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

// A block of BLOCK_THREADS a tile: the consumer warps, then the producer.
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
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
                     float flr, Ring g) {
  extern __shared__ __align__(16) float smem[];
  const Tile t = carve(reinterpret_cast<unsigned char*>(smem), F, R, g);
  const int n0 = blockIdx.x * TN;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(&t.full[s], 1);
      mbar_init(&t.empty[s], CONSUMERS / 32);
    }
    *t.sStop = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid >= CONSUMERS) {
    if (tid == CONSUMERS) produce(t, g, w_n, w_t, F, R, max_iter);
    return;
  }

  // tile entry: H rescaled by the column norms.  Columns past N in the
  // ragged last tile get H=0 (and V=1) and stay inactive.
  for (int e = tid; e < R * TN; e += CONSUMERS) {
    int r, j;
    tile_index(e, R, h0_sr == 1, r, j);
    const int n = n0 + j;
    t.sH[r * TN + j] = n < N ? h0[r * h0_sr + n * h0_sn] * wn[r] : 0.f;
  }
  Taker k;
  const Cols x{v, v_sf, v_sn, n0, N, flr};
  solve_tile(t, g, k, x, dph, F, R, max_iter, conv_eps, sparsity);
  consumers_sync(CONSUMERS);

  for (int e = tid; e < R * TN; e += CONSUMERS) {
    int r, j;
    tile_index(e, R, h_sr == 1, r, j);
    const int n = n0 + j;
    if (n < N) h_out[r * h_sr + n * h_sn] = t.sH[r * TN + j];
  }
  if (tid < TN && n0 + tid < N) {
    const int trips = t.sTrips[tid];
    trips_out[n0 + tid] = trips;
    if (counts != nullptr) {
      atomicAdd(counts, 1ULL);
      atomicAdd(counts + 1, (unsigned long long)trips);
    }
  }
  if (tid == 0 && counts != nullptr) {
    atomicAdd(counts + 2, (unsigned long long)k.chunks);
    atomicAdd(counts + 3, (unsigned long long)k.waits);
  }
}

// The streaming path's two launches: W normalised into the scratch buffers
// (wn, dph (R,); w_n F x pad4(R), w_t R x pad4(F)), then one block per
// 16-column tile, each column adding 1 and its trips to counts[0..1] unless
// `counts` is null (an atomic a column where its trip count is written: a
// sum a tile by one thread cost the solve 4 registers and ~13% at R=1000 on
// the H100), each block its ring's chunks and waits to counts[2..3].
inline int stream_solve(const float* v, long long v_sf, long long v_sn,
                        const float* w, const float* h0, long long h0_sr,
                        long long h0_sn, float* h, long long h_sr,
                        long long h_sn, int* trips,
                        unsigned long long* counts, float* wn, float* dph,
                        float* w_n, float* w_t, int F, int R, int N,
                        int max_iter, float conv_eps, float sparsity,
                        float flr, size_t smem, const Ring& g,
                        cudaStream_t s) {
  normalize_w_kernel<<<(pad4(R) + NORM_THREADS - 1) / NORM_THREADS,
                       NORM_THREADS, 0, s>>>(w, wn, w_n, w_t, dph, F, R,
                                             sparsity, flr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(h_cols_stream_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  h_cols_stream_kernel<<<(N + TN - 1) / TN, BLOCK_THREADS, smem, s>>>(
      v, v_sf, v_sn, w_n, w_t, h0, h0_sr, h0_sn, wn, dph, h, h_sr, h_sn,
      trips, counts, F, R, N, max_iter, conv_eps, sparsity, flr, g);
  return (int)cudaGetLastError();
}

}  // namespace
