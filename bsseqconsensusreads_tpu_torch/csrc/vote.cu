// Consensus column vote for Hopper (sm_90a): the fused segmented vote and
// the standalone finalize.
//
// Replaces the two Pallas kernels of the JAX package, both in
// bsseqconsensusreads_tpu/ops/pallas_vote.py:
//   * bsseq_seg_vote      <- _vote_kernel (:49; column_vote_groups, pallas_call
//                            at :277) and _finalize_kernel (:151;
//                            vote_finalize_groups, pallas_call at :217)
//                            together with the segment sum in front of it
//                            (models/molecular.py vote_partials_segments).
//   * bsseq_vote_finalize <- _finalize_kernel alone, over summed
//                            log-likelihoods.
//
// Bound: device memory. The byte bound counts each input byte once (base
// 1 B + qual 2 B per observation cell, the offsets, the 4 KB table) and
// each output byte once (base, qual, depth, errors: 6 B per output cell);
// the arithmetic is at most 4 float adds per observation plus three exp
// and one log per output cell, far below the card's float32 rate. Tensor
// cores and wgmma do not apply: there is no product, and each float32 sum
// must be taken in row order.
//
// Design of bsseq_seg_vote. The rows [N, P, W] are read as rows of R = P*W
// cells; segment s owns rows offsets[s]:offsets[s+1].
//   * Persistent grid: SM count x resident blocks per SM (queried once and
//     cached). Each block builds its term table in shared memory once —
//     per (qual, base) the float4 of the 4 terms a cell adds, log_ok in
//     the observed base's channel and log_err elsewhere, from the pinned
//     512 x 2 table, plus a row of -0 for an unobserved cell — then walks
//     work units by a grid stride. A unit is a run of consecutive segments
//     x one column tile: when R <= 2048 the tile is the whole row and the
//     unit holds as many segments as the block has groups of R / 8
//     threads; wider rows are cut into tiles of 2048 cells, one segment
//     per unit.
//   * Rows arrive through a ring of 3 shared-memory stages filled by 1-D
//     TMA (cp.async.bulk), one `full` mbarrier per stage. One producer
//     warp, of which one lane works, starts the copies; 8 consumer warps
//     sum. A stage holds up to 6,144 cells of bases and quals (18 KB), so
//     a block keeps up to 54 KB in flight. When the tile is the whole row
//     a stage is a run of whole rows, contiguous in memory: one copy for
//     bases and one for quals. Otherwise one copy per row.
//   * Each consumer warp releases a stage on its `empty` mbarrier (one
//     arrival per warp) as soon as it is done with it, so warps are not
//     held to each other's segment lengths; the producer refills a stage
//     once all 8 have released it. The producer fills one stage, waits
//     until it has landed, then fills the ring: every block starts
//     summing after one stage's latency rather than after the whole
//     grid's first stages.
//   * Each thread owns C = 8 contiguous cells of its segment: one 8 B
//     base load and one 16 B qual load per row from shared memory (a row
//     of 8 uncovered cells is skipped after the base load), then per cell
//     one float4 term load and 4 adds; 8 B / 8 B / 16 B / 16 B stores of
//     base / qual / depth / errors (and float4 x 8 of ll when asked).
//   * A unit whose rows run deep (more than kDeepRows, R <= 512) would
//     leave a deep segment to R / 8 threads, each a long chain of rows.
//     There every consumer thread takes 2 cells of each row instead, the
//     threads walk the unit's rows together and finish each segment where
//     its rows end (deep_unit). When the segments average more than
//     kDeepRows rows (the deep route's padded dispatches), a unit holds
//     one segment, so the families of a dispatch run on separate blocks;
//     a segment's rows stay on one block, whose ring bounds it (PERF.md).
//   * Every thread adds its segment's rows IN ROW ORDER into 4 float sums
//     per cell — the unfactored per-observation term — so the float sums
//     are bit-identical to the plain version's in-order segment sum by
//     construction (no reordering, no atomics, no multiply to contract;
//     adding -0 for an unobserved cell changes no bit). The four per-base
//     counts of a cell are 8-bit fields of one register, widened every
//     255 rows into 16-bit fields of a 64-bit word in shared memory;
//     deep_unit counts in 16-bit fields of a register directly. A 16-bit
//     field holds 65,535 rows and the int16 depth / errors outputs
//     32,767; a segment has at most 16,384 rows on the path (the deep
//     route's DEEP_TEMPLATE_CAP, pipeline/calling.py), and the ring,
//     whose stages hold whole rows, does not depend on the segment's
//     length.
//   * The finalize (tie-band argmax, 5-comparator ascending posterior,
//     two trials with the pre-UMI rate, Phred round) runs in registers and
//     each output is written once; a cell with depth 0 skips it (the
//     finalize gives N at qual 2 there whatever the sums). errors = depth -
//     cnt[consensus].
//   * What bounds it on the card: on wide, sparsely covered windows the
//     stream of bases and quals; on the path's dense W 192 batches the
//     instructions — the per-cell work of the sum and of the finalize
//     takes longer to execute than the bytes take to stream, and a block's first unit
//     waits for its first stage with nothing to overlap.
// One launch covers every layout: molecular packed (ragged row offsets,
// 2 planes = R1/R2), duplex packed (2-row segments, 1 plane) and padded
// (offsets k*T). The wrapper guarantees W % 16 == 0 and 16-byte aligned
// tensors, so every copy and vector access is aligned. A wait on an
// mbarrier that outlasts 2 s traps: a lost copy fails the launch instead
// of hanging the card.
//
// Built with -DBSSEQ_VOTE_BOUNDS_CHECK (ops/cuda_vote.py's bounds-checked
// debug build, its own library), every row range, segment, offset, shared
// memory stage, output cell and TMA address is checked against its tensor
// and the kernel traps on the first one outside; the release build
// compiles the checks to nothing.
//
// Design of bsseq_vote_finalize: one column per thread, one 128-thread
// block per 128 columns (one float4 of ll and one depth in, two 1-byte
// stores out; neighbouring threads take neighbouring columns, so every
// access coalesces). Four consecutive columns per thread with int4 / char4
// accesses, and a persistent grid-stride loop over one column per thread,
// both measured slower on the card (PERF.md): the finalize is a long
// dependent chain, and the most threads in flight hide it best. Both
// kernels call the same finalize(). Build with -fmad=false: the two-trials
// arithmetic must not contract into FMAs the CPU never makes.

#include <cuda_runtime.h>
#include <stdint.h>

#ifdef BSSEQ_VOTE_BOUNDS_CHECK
#define BOUNDS(cond)         \
  do {                       \
    if (!(cond)) __trap();   \
  } while (0)
#else
#define BOUNDS(cond) ((void)0)
#endif

namespace {

constexpr int kNBase = 4;          // alphabet.NBASE: no observation
constexpr int kTableQuals = 512;   // ops/phred.py TABLE_QUALS
constexpr float kTieTol = 2.5e-6f; // models/molecular.py ARGMAX_TIE_TOL

constexpr int kThreads = 256;                 // seg_vote consumer threads
constexpr int kWarps = kThreads / 32;         // consumer warps
constexpr int kBlock = kThreads + 32;         // + one producer warp
constexpr int kCells = 8;                     // cells per thread
constexpr int kTileMax = kThreads * kCells;   // widest column tile
constexpr int kStageCells = 6144;             // cells per ring stage
constexpr int kStages = 3;
constexpr int kStageBytes = kStageCells * 3;  // int8 base + int16 qual
constexpr uint32_t kAllN = 0x04040404u;      // four NBASE bytes
// the vote's table in shared memory: per (qual, base) the 4 terms a cell
// adds — log_ok for the observed base's channel, log_err for the others
// (base >= 4: log_err everywhere) — and one row of -0 for an unobserved cell
constexpr int kTermRows = kTableQuals * 5 + 1;
constexpr int kUnobserved = kTableQuals * 5;
constexpr unsigned long long kWaitLimitNs = 2000000000ull;  // 2 s
constexpr int kDeepRows = 64;  // a unit with more rows takes deep_unit
constexpr size_t kSegVoteSmem =
    (size_t)kStages * kStageBytes + kTermRows * sizeof(float4) +
    2 * kStages * sizeof(uint64_t) + kThreads * kCells * sizeof(uint64_t);
constexpr int kFinThreads = 128;              // vote_finalize block

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the phase of `bar` with the given parity has completed. A wait
// past kWaitLimitNs means a copy or an arrival was lost: the kernel traps
// (the launch fails) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - t0 > kWaitLimitNs) __trap();
  }
}

// 1-D TMA: `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory, completion counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---------------------------------------------------------------- finalize

// The finalize of models/molecular.py vote_finalize, op for op: the
// tie-canonical argmax (lowest base within kTieTol of the max), the
// 5-comparator sorting network on ll - max BEFORE the exp (largest term
// exactly 1.0), two trials with the pre-UMI rate, Phred clip and
// round-half-even. log10 is log(p) * float32(1 / log(10)), as jnp.log10
// lowers it.
__device__ __forceinline__ int finalize(const float ll[4], int depth,
                                        float min_cons, float p2,
                                        float* qual_out) {
  float m = fmaxf(fmaxf(ll[0], ll[1]), fmaxf(ll[2], ll[3]));
  float thr = m - kTieTol;
  int cons = ll[0] >= thr ? 0 : ll[1] >= thr ? 1 : ll[2] >= thr ? 2 : 3;
  float d0 = ll[0] - m, d1 = ll[1] - m, d2 = ll[2] - m, d3 = ll[3] - m;
  float a = fminf(d0, d1), b = fmaxf(d0, d1);
  float c = fminf(d2, d3), e = fmaxf(d2, d3);
  float a2 = fminf(a, c), c2 = fmaxf(a, c);
  float b2 = fminf(b, e);
  float b3 = fminf(b2, c2), c3 = fmaxf(b2, c2);
  float denom = ((expf(a2) + expf(b3)) + expf(c3)) + 1.0f;
  float p1 = 1.0f - 1.0f / denom;
  float pf = p1 * (1.0f - p2) + (1.0f - p1) * p2 + (2.0f / 3.0f) * p1 * p2;
  pf = fminf(fmaxf(pf, 1e-12f), 1.0f);
  const float inv_ln10 = __int_as_float(0x3EDE5BD9);  // float32(1 / log(10))
  float q = -10.0f * (logf(pf) * inv_ln10);
  q = fminf(fmaxf(q, 2.0f), 93.0f);
  bool keep = depth > 0 && !(q < min_cons);
  *qual_out = keep ? rintf(q) : 2.0f;
  return keep ? cons : kNBase;
}

// ---------------------------------------------------------------- seg_vote

// The launch's geometry, fixed by (S, P, W) on the host.
struct Geo {
  int N;       // rows of the bases / quals tensors
  int S;       // segments
  int R;       // cells per row (P * W)
  int tiles;   // column tiles per row (1: the tile is the whole row)
  int tile;    // tile width in cells
  int groups;  // threads per segment in a unit (tile / kCells)
  int segs;    // segments per unit
  int units;
};

// One work unit: segments [sa, sb) x cells [c0, c0 + tw) of their rows.
struct Unit {
  int sa, sb;
  int c0, tw;
  int ra, rb;  // rows [ra, rb)
  int k;       // rows per ring stage
  int chunks;  // stages the unit's rows fill
};

__device__ __forceinline__ Unit unit_at(const Geo& g,
                                        const int32_t* __restrict__ offsets,
                                        int u) {
  Unit un;
  if (g.tiles == 1) {
    un.sa = u * g.segs;
    un.sb = min(un.sa + g.segs, g.S);
    un.c0 = 0;
    un.tw = g.R;
  } else {
    un.sa = u / g.tiles;
    un.sb = un.sa + 1;
    un.c0 = (u - un.sa * g.tiles) * g.tile;
    un.tw = min(g.tile, g.R - un.c0);
  }
  un.ra = offsets[un.sa];
  un.rb = offsets[un.sb];
  un.k = kStageCells / un.tw;
  un.chunks = (un.rb - un.ra + un.k - 1) / un.k;
  BOUNDS(0 <= un.sa && un.sa < un.sb && un.sb <= g.S);
  BOUNDS(0 <= un.ra && un.ra <= un.rb && un.rb <= g.N);
  BOUNDS(un.c0 >= 0 && un.tw > 0 && un.c0 + un.tw <= g.R && un.k >= 1);
  return un;
}

// The producer's cursor: the chunk it loads next in the block's stream of
// units, and how many chunks it has started (which picks the ring slot).
struct Cursor {
  int u, k, started;
  Unit un;
};

// Move the cursor to the next chunk of the stream; false when it is done.
__device__ __forceinline__ bool cursor_next(Cursor& c, const Geo& g,
                                            const int32_t* __restrict__ offsets) {
  while (c.k >= c.un.chunks) {
    c.u += gridDim.x;
    if (c.u >= g.units) return false;
    c.un = unit_at(g, offsets, c.u);
    c.k = 0;
  }
  return true;
}

// Start loading the cursor's chunk into its ring slot: one copy for bases and one
// for quals when the tile is the whole row (the chunk's rows are
// contiguous), else one of each per row.
__device__ __forceinline__ void fill_slot(Cursor& c, const Geo& g,
                                      const int8_t* __restrict__ bases,
                                      const int16_t* __restrict__ quals,
                                      unsigned char* ring, uint64_t* full) {
  const Unit& un = c.un;
  const int slot = c.started % kStages;
  int8_t* sb = reinterpret_cast<int8_t*>(ring + slot * kStageBytes);
  int16_t* sq = reinterpret_cast<int16_t*>(sb + kStageCells);
  uint64_t* bar = full + slot;
  const int r0 = un.ra + c.k * un.k;
  const int nr = min(un.k, un.rb - r0);
  BOUNDS(nr >= 1 && r0 >= un.ra && r0 + nr <= un.rb && nr * un.tw <= kStageCells);
  BOUNDS(slot >= 0 && slot < kStages);
  mbar_expect_tx(bar, (uint32_t)(nr * un.tw * 3));
  if (g.tiles == 1) {
    const size_t cell = (size_t)r0 * g.R;
    BOUNDS(cell + (size_t)nr * g.R <= (size_t)g.N * g.R);
    BOUNDS(((uintptr_t)(bases + cell) & 15) == 0 && ((uintptr_t)(quals + cell) & 15) == 0);
    BOUNDS((nr * g.R) % 16 == 0 && (smem_addr(sb) & 15) == 0 && (smem_addr(sq) & 15) == 0);
    bulk_load(sb, bases + cell, (uint32_t)(nr * g.R), bar);
    bulk_load(sq, quals + cell, (uint32_t)(2 * nr * g.R), bar);
  } else {
    for (int i = 0; i < nr; ++i) {
      const size_t cell = (size_t)(r0 + i) * g.R + un.c0;
      BOUNDS(cell + un.tw <= (size_t)g.N * g.R && un.tw % 16 == 0);
      BOUNDS(((uintptr_t)(bases + cell) & 15) == 0 && ((uintptr_t)(quals + cell) & 15) == 0);
      bulk_load(sb + i * un.tw, bases + cell, (uint32_t)un.tw, bar);
      bulk_load(sq + i * un.tw, quals + cell, (uint32_t)(2 * un.tw), bar);
    }
  }
  ++c.k;
  ++c.started;
}

// Add one observation cell's unfactored term (hit ? log_ok : log_err) to
// its 4 sums, read as one float4 of `terms`. An unobserved cell (N, or qual
// below the input minimum) reads the row of -0: adding -0 changes no bit.
// Returns the base to count, or -1.
__device__ __forceinline__ int add_cell(int b, int q, int min_in,
                                        const float4* __restrict__ terms,
                                        float ll[4]) {
  const bool obs = b != kNBase && q >= min_in;
  const float4 t = terms[obs ? min(max(q, 0), kTableQuals - 1) * 5 + min((unsigned)b, 4u)
                             : kUnobserved];
  ll[0] += t.x;
  ll[1] += t.y;
  ll[2] += t.z;
  ll[3] += t.w;
  return obs && (unsigned)b < 4u ? b : -1;
}

// Add one row of a thread's 8 cells, and one to each observed base's 8-bit
// count.
__device__ __forceinline__ void add_row(uint2 bw, uint4 qw, int min_in,
                                        const float4* __restrict__ terms,
                                        float ll[kCells][4],
                                        uint32_t cnt8[kCells]) {
  const uint32_t qwords[4] = {qw.x, qw.y, qw.z, qw.w};
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    const int x = add_cell((int)(int8_t)((c < 4 ? bw.x : bw.y) >> (8 * (c & 3))),
                           (int)(int16_t)(qwords[c >> 1] >> (16 * (c & 1))),
                           min_in, terms, ll[c]);
    if (x >= 0) cnt8[c] += 1u << (8 * x);
  }
}

// What every unit writes to, and the vote's scalar parameters.
struct Out {
  size_t cells;  // S * R: the output planes' length in cells
  int8_t* base;
  uint8_t* qual;
  int16_t* depth;
  int16_t* err;
  float* ll;  // nullptr: not asked for
  int min_in;
  float min_cons, p2;
};

// Finalize C (8 or 2) consecutive cells, cell o of the flat output on,
// and store them: base, qual, depth and errors as one vector each, and ll
// as C float4 when asked. cnt[c * kStride] holds cell c's four 16-bit base
// counts.
template <int C, int kStride>
__device__ __forceinline__ void store_cells(const Out& out, size_t o,
                                            const float (*ll)[4],
                                            const unsigned long long* cnt) {
  static_assert(C == 8 || C == 2, "8 cells (the groups) or 2 (deep units)");
  BOUNDS(o + C <= out.cells && o % C == 0);
  uint32_t bo[(C + 3) / 4] = {}, qo[(C + 3) / 4] = {};
  uint32_t dp[C / 2] = {}, ep[C / 2] = {};
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const unsigned long long n = cnt[c * kStride];
    const int depth = (int)((n & 0xFFFFull) + ((n >> 16) & 0xFFFFull) +
                            ((n >> 32) & 0xFFFFull) + (n >> 48));
    float qual = 2.0f;  // depth 0: N at qual 2 whatever the sums
    const int cons =
        depth > 0 ? finalize(ll[c], depth, out.min_cons, out.p2, &qual) : kNBase;
    const int err =
        cons != kNBase ? depth - (int)((n >> (16 * cons)) & 0xFFFFull) : 0;
    bo[c >> 2] |= (uint32_t)(uint8_t)cons << (8 * (c & 3));
    qo[c >> 2] |= (uint32_t)(uint8_t)qual << (8 * (c & 3));
    dp[c >> 1] |= (uint32_t)(uint16_t)depth << (16 * (c & 1));
    ep[c >> 1] |= (uint32_t)(uint16_t)err << (16 * (c & 1));
  }
  if constexpr (C == 8) {
    *reinterpret_cast<uint2*>(out.base + o) = make_uint2(bo[0], bo[1]);
    *reinterpret_cast<uint2*>(out.qual + o) = make_uint2(qo[0], qo[1]);
    *reinterpret_cast<uint4*>(out.depth + o) = make_uint4(dp[0], dp[1], dp[2], dp[3]);
    *reinterpret_cast<uint4*>(out.err + o) = make_uint4(ep[0], ep[1], ep[2], ep[3]);
  } else {
    *reinterpret_cast<uint16_t*>(out.base + o) = (uint16_t)bo[0];
    *reinterpret_cast<uint16_t*>(out.qual + o) = (uint16_t)qo[0];
    *reinterpret_cast<uint32_t*>(out.depth + o) = dp[0];
    *reinterpret_cast<uint32_t*>(out.err + o) = ep[0];
  }
  if (out.ll != nullptr) {
    float4* dst = reinterpret_cast<float4*>(out.ll) + o;
#pragma unroll
    for (int c = 0; c < C; ++c)
      dst[c] = make_float4(ll[c][0], ll[c][1], ll[c][2], ll[c][3]);
  }
}

// A unit whose rows run deep (its rows > kDeepRows, whole rows of R <= 512
// cells): the 8-cell groups would leave a deep segment to R / 8 threads
// and one long chain of rows each. Instead every consumer thread takes 2
// cells of each row; the threads walk the unit's rows in order together
// and finish each segment where its rows end (empty segments included).
// Same terms, same row order per cell: the sums are the same bits.
// Consumes the unit's chunks from the ring like any unit.
__device__ __noinline__ void deep_unit(const Unit& un, const Geo& g,
                                       const int32_t* __restrict__ offsets,
                                       int consumed, const unsigned char* ring,
                                       uint64_t* full, uint64_t* empty,
                                       const float4* __restrict__ terms,
                                       const Out& out, int tid) {
  const int cell = 2 * tid;
  const bool active = cell < g.R;
  int s = un.sa;
  int end = offsets[s + 1];
  float ll[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
  unsigned long long cnt[2] = {0ull, 0ull};  // four 16-bit counts per cell
  for (int k = 0; k < un.chunks; ++k, ++consumed) {
    const int slot = consumed % kStages;
    mbar_wait(full + slot, (uint32_t)((consumed / kStages) & 1));
    const int8_t* sb = reinterpret_cast<const int8_t*>(ring + slot * kStageBytes);
    const int16_t* sq = reinterpret_cast<const int16_t*>(sb + kStageCells);
    const int r0 = un.ra + k * un.k;
    const int r1 = min(r0 + un.k, un.rb);
    BOUNDS(slot >= 0 && slot < kStages && r0 < r1 && (r1 - r0) * g.R <= kStageCells);
    for (int r = r0; r < r1;) {
      while (r >= end) {  // segment s is done
        BOUNDS(s < un.sb && offsets[s] <= offsets[s + 1]);
        if (active) store_cells<2, 1>(out, (size_t)s * g.R + cell, ll, cnt);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          ll[c][0] = ll[c][1] = ll[c][2] = ll[c][3] = 0.0f;
          cnt[c] = 0ull;
        }
        ++s;
        BOUNDS(s < un.sb);
        end = offsets[s + 1];
      }
      const int stop = min(r1, end);  // rows of segment s in this chunk
      if (!active) {
        r = stop;
        continue;
      }
#pragma unroll 8
      for (; r < stop; ++r) {  // unrolled: the rows' loads overlap
        const int at = (r - r0) * g.R + cell;
        BOUNDS(at >= 0 && at + 2 <= (r1 - r0) * g.R);
        const uint32_t bw = *reinterpret_cast<const uint16_t*>(sb + at);
        const uint32_t qw = *reinterpret_cast<const uint32_t*>(sq + at);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int x = add_cell((int)(int8_t)(bw >> (8 * c)), (int)(int16_t)(qw >> (16 * c)),
                                 out.min_in, terms, ll[c]);
          if (x >= 0) cnt[c] += 1ull << (16 * x);
        }
      }
    }
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(empty + slot);  // this warp is done with it
  }
  for (; s < un.sb; ++s) {  // the last segment, and empty ones after it
    if (active) store_cells<2, 1>(out, (size_t)s * g.R + cell, ll, cnt);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      ll[c][0] = ll[c][1] = ll[c][2] = ll[c][3] = 0.0f;
      cnt[c] = 0ull;
    }
  }
}

// Add the 8-bit per-base counts into the thread's 16-bit ones (in shared
// memory: they are touched every 255 rows, and registers are kept for the
// sums) and clear them.
__device__ __forceinline__ void widen_counts(uint32_t cnt8[kCells],
                                             unsigned long long* wide) {
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    const uint32_t v = cnt8[c];
    wide[c * kThreads] += (unsigned long long)(v & 0xFFu) |
                          ((unsigned long long)((v >> 8) & 0xFFu) << 16) |
                          ((unsigned long long)((v >> 16) & 0xFFu) << 32) |
                          ((unsigned long long)(v >> 24) << 48);
    cnt8[c] = 0u;
  }
}

// Warps 0..kWarps-1 sum and finalize; lane 0 of warp kWarps keeps the ring
// full. A consumer warp releases a slot (the `empty` barrier, one arrival
// per warp) as soon as it is done with it, so warps of short segments run
// ahead into the next unit while others still sum; the producer refills a
// slot once every warp has released it.
__global__ void __launch_bounds__(kBlock, 2)
seg_vote_kernel(const int8_t* __restrict__ bases,
                const int16_t* __restrict__ quals,
                const int32_t* __restrict__ offsets,
                const float* __restrict__ table, const Geo g, int min_in,
                float min_cons, float p2, int8_t* __restrict__ base_out,
                uint8_t* __restrict__ qual_out,
                int16_t* __restrict__ depth_out,
                int16_t* __restrict__ err_out, float* __restrict__ ll_out) {
  extern __shared__ __align__(128) unsigned char ring[];
  float4* terms = reinterpret_cast<float4*>(ring + kStages * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(terms + kTermRows);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;
  // this thread's 16-bit per-base counts, cell c at wide[c * kThreads]
  unsigned long long* wide =
      reinterpret_cast<unsigned long long*>(empty + kStages) + tid;
  const int warp = tid >> 5, lane = tid & 31;

  Cursor cur;
  if (tid == kThreads) {  // the producer: barriers, then the first stages
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    cur.u = (int)blockIdx.x - (int)gridDim.x;
    cur.k = cur.un.chunks = cur.started = 0;
    if (cursor_next(cur, g, offsets)) fill_slot(cur, g, bases, quals, ring, full);
  }
  for (int i = tid; i < kTermRows; i += kBlock) {
    const int q = i / 5, b = i - q * 5;
    const float lo = i < kUnobserved ? table[2 * q] : -0.0f;  // x + -0 == x
    const float le = i < kUnobserved ? table[2 * q + 1] : -0.0f;
    terms[i] = make_float4(b == 0 ? lo : le, b == 1 ? lo : le, b == 2 ? lo : le,
                           b == 3 ? lo : le);
  }
  __syncthreads();
  if (warp == kWarps) {
    if (lane == 0) {
      // every block's first chunk lands before any block fills its ring:
      // the consumers start summing after one chunk's latency, not after
      // the whole grid's first three chunks
      if (cur.started == 1) mbar_wait(full, 0);
      while (cursor_next(cur, g, offsets)) {
        const int slot = cur.started % kStages;
        if (cur.started >= kStages) {
          mbar_wait(empty + slot, (uint32_t)((cur.started / kStages - 1) & 1));
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        }
        fill_slot(cur, g, bases, quals, ring, full);
      }
    }
    return;
  }

  const int j = tid / g.groups;                    // segment within the unit
  const int cell = (tid - j * g.groups) * kCells;  // first cell in the tile
  int consumed = 0;
  const Out out = {(size_t)g.S * g.R, base_out, qual_out, depth_out, err_out, ll_out,
                   min_in, min_cons, p2};
  for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
    const Unit un = unit_at(g, offsets, u);
    if (g.tiles == 1 && g.R <= 2 * kThreads && un.rb - un.ra > kDeepRows) {
      deep_unit(un, g, offsets, consumed, ring, full, empty, terms, out, tid);
      consumed += un.chunks;
      continue;
    }
    const int s = un.sa + j;
    const bool active = s < un.sb && cell < un.tw;
    int rs = 0, re = 0;
    if (active) {
      rs = offsets[s];
      re = offsets[s + 1];
      BOUNDS(un.ra <= rs && rs <= re && re <= un.rb);
    }
    float ll[kCells][4];
    // per-base counts per cell: four 8-bit fields taken every row, moved
    // into the four 16-bit fields of `wide` at most every 255 rows
    uint32_t cnt8[kCells];
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
      ll[c][0] = ll[c][1] = ll[c][2] = ll[c][3] = 0.0f;
      cnt8[c] = 0u;
      wide[c * kThreads] = 0ull;
    }
    int pending = 0;  // rows in cnt8
    for (int k = 0; k < un.chunks; ++k, ++consumed) {
      const int slot = consumed % kStages;
      mbar_wait(full + slot, (uint32_t)((consumed / kStages) & 1));
      const int8_t* sb = reinterpret_cast<const int8_t*>(ring + slot * kStageBytes);
      const int16_t* sq = reinterpret_cast<const int16_t*>(sb + kStageCells);
      const int r0 = un.ra + k * un.k;
      const int hi = min(re, r0 + un.k);
      for (int r = max(rs, r0); r < hi; ++r) {
        const int at = (r - r0) * un.tw + cell;
        BOUNDS(r - r0 < un.k && at >= 0 && at + kCells <= kStageCells);
        const uint2 bw = *reinterpret_cast<const uint2*>(sb + at);
        if (bw.x == kAllN && bw.y == kAllN) continue;  // 8 uncovered cells
        add_row(bw, *reinterpret_cast<const uint4*>(sq + at), min_in, terms, ll, cnt8);
        if (++pending == 255) {
          widen_counts(cnt8, wide);
          pending = 0;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);  // this warp is done with it
    }
    if (!active) continue;
    widen_counts(cnt8, wide);
    store_cells<kCells, kThreads>(out, (size_t)s * g.R + un.c0 + cell, ll, wide);
  }
}

// ---------------------------------------------------------------- finalize

__global__ void __launch_bounds__(kFinThreads)
vote_finalize_kernel(const float4* __restrict__ ll,
                     const int32_t* __restrict__ depth, int n, float min_cons,
                     float p2, int8_t* __restrict__ base_out,
                     uint8_t* __restrict__ qual_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float4 v = ll[i];
  const float l[4] = {v.x, v.y, v.z, v.w};
  float qual;
  base_out[i] = (int8_t)finalize(l, depth[i], min_cons, p2, &qual);
  qual_out[i] = (uint8_t)qual;
}

// Resident blocks of `kernel` on the current card (SM count x blocks per
// SM at `smem` bytes of dynamic shared memory), queried once per card.
template <typename K>
int resident_blocks(K kernel, int threads, size_t smem, int* cache) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev < 0 || dev >= 64) return -1;
  if (cache[dev] > 0) return cache[dev];
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || per_sm < 1)
    return -1;
  cache[dev] = sms * per_sm;
  return cache[dev];
}

int seg_vote_slots[64];

}  // namespace

// Plain C entry points (bound with ctypes), called with at least one
// output column, W % 16 == 0 and 16-byte aligned tensors. Each launches on
// `stream` and returns a cudaError_t: 0 when the launch was accepted.
extern "C" int bsseq_seg_vote(const int8_t* bases, const int16_t* quals,
                              const int32_t* offsets, const float* table,
                              int N, int S, int P, int W, int min_in, float min_cons,
                              float p2, int8_t* base_out, uint8_t* qual_out,
                              int16_t* depth_out, int16_t* err_out,
                              float* ll_out, void* stream) {
  Geo g;
  g.N = N;
  g.S = S;
  g.R = P * W;
  if (g.R <= kTileMax) {
    g.tiles = 1;
    g.tile = g.R;
    g.groups = g.R / kCells;
    // segments deeper than kDeepRows on average (the deep route's padded
    // dispatches): one segment per unit, so each family takes its own block
    g.segs = N > (long long)S * kDeepRows ? 1 : kThreads / g.groups;
    g.units = (S + g.segs - 1) / g.segs;
  } else {
    g.tiles = (g.R + kTileMax - 1) / kTileMax;
    g.tile = kTileMax;
    g.groups = kThreads;
    g.segs = 1;
    g.units = S * g.tiles;
  }
  const int slots =
      resident_blocks(seg_vote_kernel, kBlock, kSegVoteSmem, seg_vote_slots);
  if (slots < 0) return -1;
  seg_vote_kernel<<<min(g.units, slots), kBlock, kSegVoteSmem,
                    (cudaStream_t)stream>>>(
      bases, quals, offsets, table, g, min_in, min_cons, p2, base_out,
      qual_out, depth_out, err_out, ll_out);
  return (int)cudaGetLastError();
}

extern "C" int bsseq_vote_finalize(const float* ll, const int32_t* depth,
                                   int n, float min_cons, float p2,
                                   int8_t* base_out, uint8_t* qual_out,
                                   void* stream) {
  vote_finalize_kernel<<<(n + kFinThreads - 1) / kFinThreads, kFinThreads, 0,
                         (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(ll), depth, n, min_cons, p2, base_out,
      qual_out);
  return (int)cudaGetLastError();
}
