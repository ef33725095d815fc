// The encode plane's parse, designed for Hopper: hash, previous
// occurrence, capped match extension, greedy selection, literal
// compaction and sequence-code histograms of every lane of a chunk in one
// launch, one block a lane.
//
// Replaces the TPU design of zstdsharp_tpu/ops/device_encode.py
// _parse_phase (:421, one jitted XLA program a chunk; no pallas_call):
// ops/matcher.py parse_blocks_ptrjump (:156-233) with ops/common.py
// u32_at_every_byte, hash4, previous_occurrence and match_lengths (:16,
// :30, :35, :71), the literal compaction by one sort a row, and the
// 36/32/53-bin sequence-code histograms.  The literal byte histogram
// stays with csrc/histogram.cu, which runs on lit_sorted afterwards.
//
// What it computes, integer for integer, for lane b of blocks [B, N]
// with nv = n_valid[b] (the plain version is ops/lz_parse.py
// parse_plain):
//   * v32[i], the little-endian u32 at byte i (zeros past N); h[i] =
//     (v32[i] * 2654435761) >> (32 - hash_log) in u32;
//   * cand[i], the last j < i with h[j] == h[i], else -1;
//   * valid[i]: cand >= 0, v32[cand] == v32[i], i + 4 <= nv; then ml[i]
//     by the reference's rounds (u64_rounds steps of "4 + min(ctz(x1) >>
//     3, 4)" on u32 pairs, stride_rounds 64-byte steps of 16 u32
//     compares, then 8 more u64 steps re-armed, all reads clamped to
//     v32[min(p, N - 1)]), min(ml, N - i), min(ml, nv - i), and valid &=
//     ml >= 4;
//   * the greedy walk: cursor 0, j = the next valid position >= cursor,
//     emit (j, ml[j], j - cand[j]), cursor = min(j + ml[j], N), at most S
//     sequences: starts/mls/offs [B, S] padded with N / 0 / 0, nseq [B];
//   * covered [B, N]: the capped sequences' [start, min(start + ml, N));
//   * lit_sorted [B, N]: the bytes at positions p < nv not covered, in
//     position order, then every other byte in position order;
//     lit_count [B] = nv - the sum of the live mls;
//   * the code histograms [B, 36], [B, 32], [B, 53] of the live
//     sequences' (llCode, ofCode, mlCode): ll = start - the previous
//     sequence's end, an offset equal to the previous one with ll > 0 is
//     rep0 (offBase 1), else offBase = off + 3; codes through the LUTs
//     (ll <= 63, ml - 3 <= 127) or highbit + 19 / + 36; codes outside a
//     histogram's bins count nowhere.
//
// What bounds it on the H100.  Roofline: a lane reads its N bytes and
// writes covered and lit_sorted (N bytes each), 12 bytes a sequence slot
// and the histograms: for the encode cell's chunk of 32 x 16 KB about 2.8
// MB, under 1 us at 3.35 TB/s.  The serial floor is two chains per lane,
// far above that: the previous occurrence is a hash table of last
// positions updated at every position in order, and the greedy walk
// visits each selected match in turn.  The design keeps the table's chain
// in one warp and takes everything else off it:
//
// * The hash groups of each 32-position step (__match_any_sync, whose
//   cost set the table walk's step when the walking warp took them) are
//   taken by the other 31 warps, an eighth of the row ahead of the walk.
// * The rounds' lengths are min(L, cap), L the common length of the row
//   at i and at cand[i] within the row, cap = 8 u64_rounds (+ 64
//   stride_rounds + 64 with strides): 640 for (8, 8), 1728 for (16, 24).
//   Along a diagonal (cand[i + 1] == cand[i] + 1) L(i) = L(i + 1) + 1
//   when byte i equals byte cand[i], else 0, and the cap passes through:
//   min(L(i), cap) = min(min(L(i + 1), cap) + 1, cap).  So only the last
//   position of a diagonal extends (over the row in shared memory, at
//   most cap bytes); every other position costs one byte compare.  A row
//   of long runs, which took up to 24 rounds of u32 loads at every
//   position, takes one extension a diagonal.
// * The greedy walk is cut into 32 segments walked at once, each as if a
//   cursor entered it at its start; the true walk then crosses each
//   segment only until it meets a match of that segment's walk (from
//   there the two agree), usually after a step or two.  At worst (a walk
//   that never meets) it is the serial walk.
//
// * Pass 0 (all threads): the table cleared to -1, the masks and
//   histograms cleared, the LUTs.
// * Pass 1: the previous occurrence.  Warps 1-31 take the 32-position
//   steps, an eighth of the row at a time: v32 of each position into a
//   global scratch row (L1/L2-resident), its hash and the step's groups
//   (lanes with equal hashes), then bar.arrive on that eighth's named
//   barrier.  Warp 0 bar.syncs there and walks the eighth, 32 positions a
//   step: a lane's candidate is the highest lower lane of its group, else
//   the table; the group's highest lane writes the table.  A step is its
//   table read and write alone: kAhead steps' entries are loaded ahead and
//   their candidates stored after them.  At hash_log <= 15 the table (128
//   KB at 15) lives in shared memory; at 16 and above in a per-lane global
//   scratch.  Only positions that may start a match (i < nv - 3) are
//   walked.
// * Pass 2 (all threads): the row's bytes into shared memory (over the
//   table).  Each warp walks its run of 32-position tiles backward, one
//   lane a position, extending at diagonal ends and comparing a byte
//   elsewhere; a warp scan over the tile gives each position's length as
//   a function of the length at the run's end (a constant, or "add k,
//   cap"); a block scan of the runs' functions gives each run its input,
//   then each position's length and validity (length >= 4, which holds
//   v32[cand] == v32[i]) and its bit in the valid bitmask (a tile is a
//   word).  A summary bit a word (set where the word has a valid
//   position) makes the mask two-level.
// * Pass 3: the jump byte of each valid j (all threads; the walk's next
//   match after j is at j + 4 + d, 255: look it up in the two-level
//   bitmask); warp 0's lanes walk the 32 segments, marking their matches;
//   lane 0 walks the true path across them, recording where it meets
//   each segment's walk; all threads merge the marks and rank them by one
//   block scan: the first S are the sequences, so the cap falls where the
//   reference's sort truncates.
// * Pass 4 (all threads): per sequence slot the match length and offset
//   (from the ml and cand rows), the padding, the covered bits (a shared
//   bitmask), the three codes (shared-memory atomics) and the sum of the
//   match lengths for lit_count; then one block scan of the literal words'
//   popcounts, and per position the covered byte and the byte's place in
//   lit_sorted.
//
// Opting into more than 48 KB of shared memory happens on every launch.
// Measured on an H100: PERF.md section 6 (chip_smoke.py phase lz_parse,
// kernel_bench --parse-only, which times this source beside another).

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMinMatch = 4;
constexpr int kLL = 36, kOF = 32, kML = 53;
constexpr int kLutLL = 64, kLutML = 128;
constexpr int kSharedHashLog = 15;  // ops/lz_parse.py SHARED_HASH_LOG
constexpr int kMaxHashLog = 24;     // ops/lz_parse.py MAX_HASH_LOG
constexpr int kMaxN = 1 << 17;      // ops/lz_parse.py MAX_N
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kPrime = 2654435761u;
// 227 KB, the most a block may opt into, less the static part
constexpr int kSmemMax = 232448 - 4096;
constexpr int kStamps = 6;
constexpr int kAhead = 8;  // table-walk steps loaded ahead
constexpr int kRowPad = 4;  // zero words past the row's last (extension)
constexpr int kChunks = 8;  // pass 1's hand-overs, named barriers 1-8

using i64 = long long;

struct Params {
  const uint8_t* blocks;   // [B, N]
  const int32_t* n_valid;  // [B]
  const int32_t* lut;      // ll_lut [64] then ml_lut [128]
  int N, S, hash_log, cap, nwords, region_a;
  int32_t* starts;  // [B, S]
  int32_t* mls;
  int32_t* offs;
  int32_t* nseq;       // [B]
  int32_t* lit_count;  // [B]
  uint8_t* covered;    // [B, N]
  uint8_t* lit_sorted;  // [B, N]; null: no compaction and no histograms
  int32_t* ll_hist;     // [B, 36]
  int32_t* of_hist;     // [B, 32]
  int32_t* ml_hist;     // [B, 53]
  // scratch, written and read by this launch only: plain (coherent) loads
  uint32_t* v32;  // [B, N]
  int32_t* cand;  // [B, N]: pass 1's hash-group entries, then cand
  int32_t* mlg;   // [B, N]: pass 2's functions, then ml where valid
  int32_t* table;  // [B, 2^hash_log] past kSharedHashLog, else null
  // null, or int64 [B, kStamps]: the SM clock (clock64) at the start and
  // after each pass, read by thread 0 (kernel_bench.parse_passes)
  long long* stamps;
};

__device__ __forceinline__ int ctz32(uint32_t x) {
  return x ? __ffs(static_cast<int>(x)) - 1 : 32;
}

__device__ __forceinline__ int highbit(int v) {
  return 31 - __clz(max(v, 1));
}

// min(L, lim): L the common length of the row at i and at c < i, lim <=
// N - i.  16 bytes a round: four new words a side, loaded together (the
// row has kRowPad zero words past N for the last round's reads).
__device__ int common_length(const uint32_t* w, int i, int c, int lim) {
  const int si = (i & 3) << 3, sc = (c & 3) << 3;
  int wi = i >> 2, wc = c >> 2;
  uint32_t ai = w[wi], ac = w[wc];
  for (int k = 0; k < lim; k += 16, wi += 4, wc += 4) {
    uint32_t bi[4], bc[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      bi[q] = w[wi + 1 + q];
      bc[q] = w[wc + 1 + q];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t x = __funnelshift_r(q ? bi[q - 1] : ai, bi[q], si) ^
                         __funnelshift_r(q ? bc[q - 1] : ac, bc[q], sc);
      if (x) return min(k + 4 * q + (ctz32(x) >> 3), lim);
    }
    ai = bi[3];
    ac = bc[3];
  }
  return lim;
}

// A run of positions' length as a function of the length x after it, in
// one int: v >= 0 is the constant v (the run holds a diagonal's end or a
// mismatch), v < 0 is min(x - 1 - v, cap).  a's positions lie before b's.
__device__ __forceinline__ int compose(int a, int b, int cap) {
  if (a >= 0) return a;
  if (b >= 0) return min(b - 1 - a, cap);
  return a + b + 1;
}

// Sets bits [s, e) of a shared bitmask; the ranges of two calls never
// overlap, so only the partial end words need atomics.
__device__ void set_bits(uint32_t* mask, int s, int e) {
  if (s >= e) return;
  const int w0 = s >> 5, w1 = (e - 1) >> 5;
  const uint32_t head = kFull << (s & 31);
  const uint32_t tail = kFull >> (31 - ((e - 1) & 31));
  if (w0 == w1) {
    atomicOr(&mask[w0], head & tail);
    return;
  }
  atomicOr(&mask[w0], head);
  for (int w = w0 + 1; w < w1; ++w) mask[w] = kFull;
  atomicOr(&mask[w1], tail);
}

// The literal positions of word w: not covered and below lim.
__device__ __forceinline__ uint32_t lit_word(const uint32_t* cmask, int w,
                                             int lim) {
  const int lo = w << 5;
  uint32_t m = ~cmask[w];
  if (lo + 32 > lim) m &= lim > lo ? kFull >> (32 - (lim - lo)) : 0u;
  return m;
}

// The first valid position at or past pos (N: none): its word, else the
// summary (bit x of sum[g]: word 32 g + x has a valid position).
__device__ int next_valid(const uint32_t* vmask, const uint32_t* sum,
                          int nw, int N, int pos) {
  if (pos >= N) return N;
  int w = pos >> 5;
  const uint32_t word = vmask[w] & (kFull << (pos & 31));
  if (word != 0u) return (w << 5) + __ffs(static_cast<int>(word)) - 1;
  const int q = w + 1, ng = (nw + 31) >> 5;
  int g = q >> 5;
  uint32_t sw = q < nw ? sum[g] & (kFull << (q & 31)) : 0u;
  while (sw == 0u && ++g < ng) sw = sum[g];
  if (sw == 0u) return N;
  w = (g << 5) + __ffs(static_cast<int>(sw)) - 1;
  return (w << 5) + __ffs(static_cast<int>(vmask[w])) - 1;
}

// The exclusive prefix of each thread's `local` in thread order, and the
// block's total.  Every thread calls it; it leaves s_scan free again.
__device__ int block_prefix(int local, int* s_scan, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_scan[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int z = s_scan[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, z, o);
      if (lane >= o) z += y;
    }
    s_scan[lane] = z;
  }
  __syncthreads();
  const int excl = x - local + (warp ? s_scan[warp - 1] : 0);
  *total = s_scan[kWarps - 1];
  __syncthreads();
  return excl;
}

// The SM clock at point k of lane b's launch, when the caller asked.
__device__ __forceinline__ void stamp(const Params& p, int b, int k) {
  if (p.stamps != nullptr && threadIdx.x == 0)
    p.stamps[static_cast<i64>(b) * kStamps + k] = clock64();
}

// Named barrier `id` (1-15) of all the block's threads: warps 1-31 arrive
// (release, no wait), warp 0 waits there (acquire).
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}

template <bool kSharedTable>
__global__ void __launch_bounds__(kThreads, 1) parse_kernel(Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_hist[kLL + kOF + kML];
  __shared__ int s_lut[kLutLL + kLutML];
  __shared__ int s_scan[kWarps];
  __shared__ uint32_t s_sum[kMaxN / 1024];
  __shared__ int s_exit[32], s_conv[32];  // pass 3's segments
  __shared__ int s_nseq, s_msum;

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int N = p.N, S = p.S, nw = p.nwords, cap = p.cap;
  const bool compact = p.lit_sorted != nullptr;
  const i64 row0 = static_cast<i64>(b) * N, seq0 = static_cast<i64>(b) * S;
  const uint8_t* row = p.blocks + row0;
  uint32_t* v32 = p.v32 + row0;
  int32_t* cand = p.cand + row0;
  int32_t* mlg = p.mlg + row0;
  // region A: the table (pass 1), the row's words (pass 2), the jump
  // bytes (pass 3), the literal words' prefix (pass 4)
  uint32_t* roww = reinterpret_cast<uint32_t*>(smem);
  uint32_t* vmask = reinterpret_cast<uint32_t*>(smem + p.region_a);
  uint32_t* cmask = vmask + nw;
  uint32_t* smask = cmask + nw;  // the positions the walk selects
  int32_t* table = kSharedTable
      ? reinterpret_cast<int32_t*>(smem)
      : p.table + (static_cast<i64>(b) << p.hash_log);
  const int nv = p.n_valid[b];
  // positions that may start a match: i + 4 <= nv, i < N
  const int cnt = static_cast<int>(
      max(0ll, min(static_cast<i64>(N), static_cast<i64>(nv) - 3)));

  stamp(p, b, 0);
  // ---- pass 0: the cleared table, masks and histograms, the LUTs ----
  for (int q = tid; q < kLL + kOF + kML; q += kThreads) s_hist[q] = 0;
  if (tid == 0) s_msum = 0;
  if (compact)
    for (int q = tid; q < kLutLL + kLutML; q += kThreads) s_lut[q] = p.lut[q];
  for (int q = tid; q < 3 * nw; q += kThreads) vmask[q] = 0u;
  for (int q = tid; q < (1 << p.hash_log); q += kThreads) table[q] = -1;
  __syncthreads();
  stamp(p, b, 1);

  // ---- pass 1: previous occurrence; warps 1-31 take the steps' v32 and
  // hash groups chunk by chunk while warp 0 walks the table behind them ----
  const int spc = (nw + kChunks - 1) / kChunks;  // steps a chunk
  if (warp > 0) {
    // step st (32 positions): its entry in cand is h, the highest lower
    // lane of the group plus 1 (0: none) and whether the lane is the
    // group's highest (bit 29)
    const int shift = 32 - p.hash_log;
    for (int k = 0; k < kChunks; ++k) {
      for (int st = k * spc + warp - 1; st < min((k + 1) * spc, nw);
           st += kWarps - 1) {
        const int i = st * 32 + lane;
        uint32_t x = 0u;
        if (i < N) {
          x = row[i];
          if (i + 1 < N) x |= static_cast<uint32_t>(row[i + 1]) << 8;
          if (i + 2 < N) x |= static_cast<uint32_t>(row[i + 2]) << 16;
          if (i + 3 < N) x |= static_cast<uint32_t>(row[i + 3]) << 24;
          v32[i] = x;
        }
        // a hash is below 2^hash_log, so the idle lanes' value is no hash
        const uint32_t h = i < cnt ? (x * kPrime) >> shift : kFull;
        const unsigned grp = __match_any_sync(kFull, h);
        const unsigned lower = grp & ((1u << lane) - 1u);
        if (i < cnt)
          cand[i] = static_cast<int32_t>(
              h |
              (lower ? static_cast<uint32_t>(32 - __clz(lower)) << 24 : 0u) |
              ((grp >> lane) == 1u ? 1u << 29 : 0u));
      }
      bar_arrive(1 + k);  // chunk k's entries are out
    }
  } else {
    // a step is its table read and write alone: kAhead steps' entries are
    // loaded ahead (within the chunk) and their candidates stored after
    // them, off the chain
    for (int k = 0; k < kChunks; ++k) {
      bar_sync(1 + k);
      const int lo = k * spc * 32, hi = min((k + 1) * spc * 32, cnt);
      int32_t eq[kAhead];
#pragma unroll
      for (int s = 0; s < kAhead; ++s) {
        const int i = lo + 32 * s + lane;
        eq[s] = i < hi ? cand[i] : 0;
      }
      for (int base = lo; base < hi; base += 32 * kAhead) {
        int32_t e[kAhead], tv[kAhead];
#pragma unroll
        for (int s = 0; s < kAhead; ++s) {
          e[s] = eq[s];
          const int i = base + 32 * (kAhead + s) + lane;
          eq[s] = i < hi ? cand[i] : 0;
        }
#pragma unroll
        for (int s = 0; s < kAhead; ++s) {
          const int i = base + 32 * s + lane;
          const int h = e[s] & 0xffffff;
          tv[s] = table[h];
          __syncwarp();
          if (i < hi && ((e[s] >> 29) & 1)) table[h] = i;
          __syncwarp();
        }
#pragma unroll
        for (int s = 0; s < kAhead; ++s) {
          const int i = base + 32 * s + lane;
          const int low = (e[s] >> 24) & 31;
          if (i < hi) cand[i] = low ? i - lane + low - 1 : tv[s];
        }
      }
    }
  }
  __syncthreads();
  stamp(p, b, 2);

  // ---- pass 2: lengths along diagonals, validity, the valid bitmask ----
  // the row as words, zero past N and kRowPad words more (v32 at 4 q is
  // word q)
  for (int q = tid; q < ((N + 3) >> 2) + kRowPad; q += kThreads)
    roww[q] = 4 * q < N ? v32[4 * q] : 0u;
  __syncthreads();
  // each warp a run of 32-position tiles (one bitmask word each), walked
  // backward: each position's length as a function of the length at the
  // run's end (compose's encoding), kept in mlg until the block scan
  const int ntile = (cnt + 31) >> 5;
  const int tpw = (ntile + kWarps - 1) / kWarps;
  const int t0 = min(warp * tpw, ntile), t1 = min(t0 + tpw, ntile);
  int carry = -1;  // the identity
  {
    int c_next = t1 * 32 < cnt ? cand[t1 * 32] : -1;
    // each tile's candidates are loaded one tile ahead
    int c_ahead = t1 > t0 && (t1 - 1) * 32 + lane < cnt
                      ? cand[(t1 - 1) * 32 + lane] : -1;
    for (int t = t1 - 1; t >= t0; --t) {
      const int i = t * 32 + lane;
      const int c = c_ahead;
      c_ahead = t > t0 ? cand[i - 32] : -1;
      int cn = __shfl_down_sync(kFull, c, 1);
      if (lane == 31) cn = c_next;
      c_next = __shfl_sync(kFull, c, 0);
      int f = -1;
      if (i < cnt) {
        if (c < 0)
          f = 0;
        else if (cn != c + 1)  // a diagonal's last position: extend
          f = common_length(roww, i, c, min(cap, N - i));
        else
          f = smem[i] != smem[c] ? 0 : -2;
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_down_sync(kFull, f, o);
        if (lane + o < 32) f = compose(f, y, cap);
      }
      f = compose(f, carry, cap);
      if (i < cnt) mlg[i] = f;
      carry = __shfl_sync(kFull, f, 0);
    }
  }
  // reverse scan of the warps' runs: the length at each run's end
  if (lane == 0) s_scan[warp] = carry;
  __syncthreads();
  if (warp == 0) {
    int z = s_scan[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_down_sync(kFull, z, o);
      if (lane + o < 32) z = compose(z, y, cap);
    }
    s_scan[lane] = z;
  }
  __syncthreads();
  {
    const int after = warp + 1 < kWarps ? s_scan[warp + 1] : -1;
    const int x_end = after >= 0 ? after : min(-1 - after, cap);
    int c_ahead = -1, f_ahead = -1;
    if (t0 < t1 && t0 * 32 + lane < cnt) {
      c_ahead = cand[t0 * 32 + lane];
      f_ahead = mlg[t0 * 32 + lane];
    }
    for (int t = t0; t < t1; ++t) {
      const int i = t * 32 + lane;
      const int c = c_ahead, f = f_ahead;
      if (t + 1 < t1 && i + 32 < cnt) {
        c_ahead = cand[i + 32];
        f_ahead = mlg[i + 32];
      }
      bool ok = false;
      if (i < cnt) {
        // m >= 4 holds the first 4 bytes equal: v32[c] == v32[i]
        const int m = min(f >= 0 ? f : min(x_end - 1 - f, cap), nv - i);
        ok = c >= 0 && m >= kMinMatch;
        if (ok) mlg[i] = m;
      }
      const unsigned bits = __ballot_sync(kFull, ok);
      if (lane == 0) vmask[t] = bits;
    }
  }
  __syncthreads();
  const int ng = (nw + 31) >> 5;
  for (int g = warp; g < ng; g += kWarps) {
    const int q = (g << 5) + lane;
    const unsigned nz = __ballot_sync(kFull, q < nw && vmask[q] != 0u);
    if (lane == 0) s_sum[g] = nz;
  }
  __syncthreads();
  stamp(p, b, 3);

  // ---- pass 3: the greedy walk, 32 segments at once, then stitched ----
  // the jump byte of each valid j (region A, over the row): the walk's
  // next match after j is at j + 4 + d, found in the word of min(j + ml,
  // N) or the next (N: none); 255 where it is not, or d would not fit
  uint8_t* jump = smem;
  for (int i = tid; i < cnt; i += kThreads) {
    if (!((vmask[i >> 5] >> (i & 31)) & 1u)) continue;
    const int t = min(i + mlg[i], N);
    int nx = -1;
    if (t >= N) {
      nx = N;
    } else {
      const int w = t >> 5;
      const uint32_t word = vmask[w] & (kFull << (t & 31));
      if (word != 0u)
        nx = (w << 5) + __ffs(static_cast<int>(word)) - 1;
      else if (w + 1 >= nw)
        nx = N;
      else if (vmask[w + 1] != 0u)
        nx = ((w + 1) << 5) + __ffs(static_cast<int>(vmask[w + 1])) - 1;
    }
    jump[i] = static_cast<uint8_t>(nx < 0 ? 255
                                          : min(nx - i - kMinMatch, 255));
  }
  __syncthreads();
  // the next match after the match at j (N: none)
  auto next_match = [&](int j) {
    const int d = jump[j];
    return d < 255 ? j + kMinMatch + d
                   : next_valid(vmask, s_sum, nw, N, min(j + mlg[j], N));
  };
  int32_t* starts = p.starts + seq0;
  int32_t* mls = p.mls + seq0;
  int32_t* offs = p.offs + seq0;
  const int wps = (nw + 31) >> 5;  // words a segment
  if (warp == 0) {
    // lane k walks segment k = [s, e) from its first valid position,
    // marking its matches in smask, as if a cursor entered it at s
    const int s = min(lane * wps * 32, N), e = min(s + wps * 32, N);
    int j = next_valid(vmask, s_sum, nw, N, s);
    while (j < e) {
      smask[j >> 5] |= 1u << (j & 31);
      j = next_match(j);
    }
    s_exit[lane] = j;
    __syncwarp();
    // lane 0 follows the true walk: through segment k until it meets a
    // match of lane k's walk (from there the two agree up to the
    // segment's exit) or leaves it; its own matches go to cmask
    if (lane == 0) {
      int jc = next_valid(vmask, s_sum, nw, N, 0);
      for (int k = 0; k < 32; ++k) {
        const int ek = min((k + 1) * wps * 32, N);
        s_conv[k] = ek;
        while (jc < ek) {
          if ((smask[jc >> 5] >> (jc & 31)) & 1u) {
            s_conv[k] = jc;
            jc = s_exit[k];
            break;
          }
          cmask[jc >> 5] |= 1u << (jc & 31);
          jc = next_match(jc);
        }
      }
    }
  }
  __syncthreads();
  // the walk's matches: segment k's own from its meeting point on, and
  // the true walk's before it; then their ranks, the first S sequences
  {
    const int wper = (nw + kThreads - 1) / kThreads;
    const int w0 = min(tid * wper, nw), w1 = min(w0 + wper, nw);
    int local = 0;
    for (int w = w0; w < w1; ++w) {
      const int conv = s_conv[w / wps], lo = w << 5;
      const uint32_t keep = conv <= lo ? kFull
                          : conv >= lo + 32 ? 0u
                          : kFull << (conv - lo);
      const uint32_t x = (smask[w] & keep) | cmask[w];
      smask[w] = x;
      cmask[w] = 0u;
      local += __popc(x);
    }
    int total;
    int k = block_prefix(local, s_scan, &total);
    for (int w = w0; w < w1 && k < S; ++w) {
      for (uint32_t x = smask[w]; x != 0u && k < S; x &= x - 1u)
        starts[k++] = (w << 5) + __ffs(static_cast<int>(x)) - 1;
    }
    if (tid == 0) {
      s_nseq = min(total, S);
      p.nseq[b] = s_nseq;
    }
  }
  __syncthreads();
  stamp(p, b, 4);

  // ---- pass 4a: offsets, padding, covered bits, code histograms ----
  const int nseq = s_nseq;
  int msum = 0;
  for (int k = tid; k < S; k += kThreads) {
    if (k >= nseq) {
      starts[k] = N;
      mls[k] = 0;
      offs[k] = 0;
      continue;
    }
    const int j = starts[k], m = mlg[j];
    const int off = j - cand[j];
    mls[k] = m;
    offs[k] = off;
    msum += m;
    set_bits(cmask, j, min(j + m, N));
    if (!compact) continue;
    int prev_end = 0, prev_off = 0;
    if (k > 0) {
      const int pj = starts[k - 1];
      prev_end = pj + mlg[pj];
      prev_off = pj - cand[pj];
    }
    const int ll = j - prev_end, mlv = m - 3;
    const int ofb = (k > 0 && off == prev_off && ll > 0) ? 1 : off + 3;
    const int llc = ll > 63 ? highbit(ll) + 19 : s_lut[min(max(ll, 0), 63)];
    const int mlc = mlv > 127 ? highbit(mlv) + 36
                              : s_lut[kLutLL + min(max(mlv, 0), 127)];
    const int ofc = highbit(ofb);
    if (llc >= 0 && llc < kLL) atomicAdd(&s_hist[llc], 1);
    if (ofc >= 0 && ofc < kOF) atomicAdd(&s_hist[kLL + ofc], 1);
    if (mlc >= 0 && mlc < kML) atomicAdd(&s_hist[kLL + kOF + mlc], 1);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) msum += __shfl_down_sync(kFull, msum, o);
  if (lane == 0 && msum != 0) atomicAdd(&s_msum, msum);
  __syncthreads();
  if (tid == 0) p.lit_count[b] = nv - s_msum;

  // ---- pass 4b: exclusive prefix of the literal words' popcounts ----
  uint32_t* wpre = reinterpret_cast<uint32_t*>(smem);  // region A
  const int lim = max(0, min(nv, N));
  int total = 0;
  if (compact) {
    const int per_w = (nw + kThreads - 1) / kThreads;
    const int w0 = min(tid * per_w, nw), w1 = min(w0 + per_w, nw);
    int local = 0;
    for (int w = w0; w < w1; ++w) local += __popc(lit_word(cmask, w, lim));
    int excl = block_prefix(local, s_scan, &total);
    for (int w = w0; w < w1; ++w) {
      wpre[w] = static_cast<uint32_t>(excl);
      excl += __popc(lit_word(cmask, w, lim));
    }
    __syncthreads();
    for (int q = tid; q < kLL + kOF + kML; q += kThreads) {
      const int v = s_hist[q];
      if (q < kLL) p.ll_hist[static_cast<i64>(b) * kLL + q] = v;
      else if (q < kLL + kOF) p.of_hist[static_cast<i64>(b) * kOF + q - kLL] = v;
      else p.ml_hist[static_cast<i64>(b) * kML + q - kLL - kOF] = v;
    }
  }

  // ---- pass 4c: covered bytes and the literal permutation ----
  uint8_t* covered = p.covered + row0;
  uint8_t* lit_sorted = compact ? p.lit_sorted + row0 : nullptr;
  for (int i = tid; i < N; i += kThreads) {
    const int w = i >> 5, bit = i & 31;
    covered[i] = static_cast<uint8_t>((cmask[w] >> bit) & 1u);
    if (!compact) continue;
    const uint32_t lw = lit_word(cmask, w, lim);
    const int before =
        static_cast<int>(wpre[w]) + __popc(lw & ((1u << bit) - 1u));
    const int dest = ((lw >> bit) & 1u) ? before : total + (i - before);
    lit_sorted[dest] = row[i];
  }
  if (p.stamps != nullptr) {
    __syncthreads();
    stamp(p, b, 5);
  }
}

}  // namespace

// Parse every lane of blocks (uint8 [b, n]) with n_valid (int32 [b]):
// starts/mls/offs int32 [b, s], nseq and lit_count int32 [b], covered u8
// [b, n]; with lit_sorted (u8 [b, n]) non-null also the literal
// permutation and the code histograms ll/of/ml_hist int32 [b, 36/32/53]
// (lut: int32 ll_lut [64] then ml_lut [128]).  scratch int32 [3, b, n];
// table int32 [b, 2^hash_log] when hash_log > 15, else null.  stamps:
// null, or int64 [b, 6] for the SM clock at the start and after each
// pass.  Returns a cudaError_t.
extern "C" int zt_lz_parse(const void* blocks, const void* n_valid, int b,
                           int n, int s, int hash_log, int u64_rounds,
                           int stride_rounds, const void* lut, void* starts,
                           void* mls, void* offs, void* nseq,
                           void* lit_count, void* covered, void* lit_sorted,
                           void* ll_hist, void* of_hist, void* ml_hist,
                           void* scratch, void* table, void* stamps,
                           void* stream) {
  if (b <= 0) return 0;
  const bool shared_table = hash_log <= kSharedHashLog;
  if (n < 1 || n > kMaxN || s < 1 || hash_log < 1 ||
      hash_log > kMaxHashLog || u64_rounds < 0 || stride_rounds < 0 ||
      (!shared_table && table == nullptr) ||
      (lit_sorted && (!lut || !ll_hist || !of_hist || !ml_hist)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.blocks = static_cast<const uint8_t*>(blocks);
  p.n_valid = static_cast<const int32_t*>(n_valid);
  p.lut = static_cast<const int32_t*>(lut);
  p.N = n;
  p.S = s;
  p.hash_log = hash_log;
  // the rounds' reach; past n every length is its within-row length
  const i64 reach = 8ll * u64_rounds +
                    (stride_rounds ? 64ll * stride_rounds + 64 : 0ll);
  p.cap = static_cast<int>(std::min(reach, static_cast<i64>(n)));
  p.nwords = (n + 31) / 32;
  const int table_bytes = shared_table ? 4 << hash_log : 0;
  const int row_bytes = 4 * (((n + 3) >> 2) + kRowPad);
  const int word_bytes = (p.nwords * 4 + 15) & ~15;
  p.region_a = (std::max({table_bytes, row_bytes, word_bytes}) + 15) & ~15;
  const int dyn = p.region_a + 3 * p.nwords * 4;
  if (dyn > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  p.starts = static_cast<int32_t*>(starts);
  p.mls = static_cast<int32_t*>(mls);
  p.offs = static_cast<int32_t*>(offs);
  p.nseq = static_cast<int32_t*>(nseq);
  p.lit_count = static_cast<int32_t*>(lit_count);
  p.covered = static_cast<uint8_t*>(covered);
  p.lit_sorted = static_cast<uint8_t*>(lit_sorted);
  p.ll_hist = static_cast<int32_t*>(ll_hist);
  p.of_hist = static_cast<int32_t*>(of_hist);
  p.ml_hist = static_cast<int32_t*>(ml_hist);
  const i64 plane = static_cast<i64>(b) * n;
  p.v32 = static_cast<uint32_t*>(scratch);
  p.cand = static_cast<int32_t*>(scratch) + plane;
  p.mlg = static_cast<int32_t*>(scratch) + 2 * plane;
  p.table = static_cast<int32_t*>(table);
  p.stamps = static_cast<long long*>(stamps);
  const auto st = static_cast<cudaStream_t>(stream);
  // the default 48 KB limit counts the static part too: opt in every time
  cudaError_t err;
  if (shared_table) {
    err = cudaFuncSetAttribute(parse_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dyn);
    if (err != cudaSuccess) return static_cast<int>(err);
    parse_kernel<true><<<b, kThreads, dyn, st>>>(p);
  } else {
    err = cudaFuncSetAttribute(parse_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dyn);
    if (err != cudaSuccess) return static_cast<int>(err);
    parse_kernel<false><<<b, kThreads, dyn, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
