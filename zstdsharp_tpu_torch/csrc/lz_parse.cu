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
// visits each selected match in turn, each step depending on the last.
// The design keeps both chains in shared memory, the table walk in one
// warp and the greedy walk in one thread, with everything parallel around
// them spread over 1,024 threads; the match extension of rows of long
// runs (up to 24 rounds of u32 loads a position) can outweigh both:
//
// * Pass 0 (all threads): v32 of every position into a global scratch row
//   (L1/L2-resident), the table cleared to -1.
// * Pass 1 (warp 0): the table walk, 32 positions a step.  Lanes with
//   equal hashes find each other with __match_any_sync; a lane's candidate
//   is the highest lower lane of its group, else the table; the group's
//   highest lane writes the table.  A group of kAhead steps takes its
//   hash groups before its table accesses and loads the next group's v32
//   while they run, so the chain from step to step runs through the table
//   alone.  At hash_log <= 15
//   the table (128 KB at 15) lives in shared memory; at 16 and above in a
//   per-lane global scratch.  Only positions that may start a match (i <
//   nv - 3) are walked.
// * Pass 2 (all threads): one thread a position computes valid and ml by
//   the reference's rounds, exiting when its rounds go inactive (a round
//   of an inactive position changes nothing).  A warp's ballot makes one
//   word of a valid-position bitmask; ml goes to a global scratch row.  A
//   summary bit a word (set where the word has a valid position) makes
//   the mask two-level.  Then, one thread a valid position j, the jump
//   byte d: the walk's next match after j is at j + 4 + d, the next valid
//   position at or past min(j + ml, N), looked up in the bitmask's word
//   there or the next (255: not found there, or too far for a byte).
// * Pass 3 (one thread): the greedy walk.  Each step is one shared-memory
//   byte load (the jump byte) and an add; a step whose byte is 255 finds
//   its next valid position in the two-level bitmask (one __ffs in the
//   cursor's word, else the summary, 32 words a load).  It emits at most
//   S sequences, so the cap falls where the reference's sort truncates.
// * Pass 4 (all threads): per sequence slot the match length and offset
//   (from the ml and cand rows), the padding, the covered bits (a shared
//   bitmask), the three codes (shared-memory atomics) and the sum of the
//   match lengths for lit_count; then one block scan of the literal words'
//   popcounts, and per position the covered byte and the byte's place in
//   lit_sorted.
//
// Opting into more than 48 KB of shared memory happens on every launch.
// Measured on an H100 (PERF.md section 6, chip_smoke.py phase lz_parse,
// kernel_bench --parse-only): 0.33 ms for the encode cell's 16 KB chunk
// of 32 lanes, against 0.46 ms for the first version of this design
// (a warp walking in step, the table walk waiting on each step's v32).

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
constexpr int kAhead = 4;  // table-walk steps whose v32 and groups go first

using i64 = long long;

struct Params {
  const uint8_t* blocks;   // [B, N]
  const int32_t* n_valid;  // [B]
  const int32_t* lut;      // ll_lut [64] then ml_lut [128]
  int N, S, hash_log, u64_rounds, stride_rounds, nwords, region_a;
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
  int32_t* cand;  // [B, N]
  int32_t* mlg;   // [B, N], ml at every valid position
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

// ops/common.py match_lengths for one position i with candidate j >= 0,
// before its min(., N - i).  Rounds stop once inactive: an inactive
// round leaves the length as it is.
__device__ int match_length(const uint32_t* v, int i, int j, int cap,
                            int u64_rounds, int stride_rounds) {
  int len = 0;
  bool active = true;
  for (int r = 0; r < u64_rounds && active; ++r) {
    const uint32_t x0 = v[min(i + len, cap)] ^ v[min(j + len, cap)];
    const uint32_t x1 = v[min(i + len + 4, cap)] ^ v[min(j + len + 4, cap)];
    len += x0 ? (ctz32(x0) >> 3) : 4 + min(ctz32(x1) >> 3, 4);
    active = x0 == 0u && x1 == 0u;
  }
  if (stride_rounds) {
    for (int r = 0; r < stride_rounds && active; ++r) {
      bool eq = true;
#pragma unroll
      for (int k = 0; k < 64; k += 4)
        eq &= v[min(i + len + k, cap)] == v[min(j + len + k, cap)];
      if (eq) len += 64;
      active = eq;
    }
    active = true;  // the refinement re-arms every candidate
    for (int r = 0; r < 8 && active; ++r) {
      const uint32_t x0 = v[min(i + len, cap)] ^ v[min(j + len, cap)];
      const uint32_t x1 =
          v[min(i + len + 4, cap)] ^ v[min(j + len + 4, cap)];
      len += x0 ? (ctz32(x0) >> 3) : 4 + min(ctz32(x1) >> 3, 4);
      active = x0 == 0u && x1 == 0u;
    }
  }
  return len;
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

// The SM clock at point k of lane b's launch, when the caller asked.
__device__ __forceinline__ void stamp(const Params& p, int b, int k) {
  if (p.stamps != nullptr && threadIdx.x == 0)
    p.stamps[static_cast<i64>(b) * kStamps + k] = clock64();
}

template <bool kSharedTable>
__global__ void __launch_bounds__(kThreads, 1) parse_kernel(Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_hist[kLL + kOF + kML];
  __shared__ int s_lut[kLutLL + kLutML];
  __shared__ int s_scan[kWarps];
  __shared__ uint32_t s_sum[kMaxN / 1024];
  __shared__ int s_nseq, s_msum;

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int N = p.N, S = p.S, nw = p.nwords;
  const bool compact = p.lit_sorted != nullptr;
  const i64 row0 = static_cast<i64>(b) * N, seq0 = static_cast<i64>(b) * S;
  const uint8_t* row = p.blocks + row0;
  uint32_t* v32 = p.v32 + row0;
  int32_t* cand = p.cand + row0;
  int32_t* mlg = p.mlg + row0;
  uint8_t* jump = smem;  // region A after pass 1: the walk's jump bytes
  uint32_t* vmask = reinterpret_cast<uint32_t*>(smem + p.region_a);
  uint32_t* cmask = vmask + nw;
  int32_t* table = kSharedTable
      ? reinterpret_cast<int32_t*>(smem)
      : p.table + (static_cast<i64>(b) << p.hash_log);
  const int nv = p.n_valid[b];
  // positions that may start a match: i + 4 <= nv, i < N
  const int cnt = static_cast<int>(
      max(0ll, min(static_cast<i64>(N), static_cast<i64>(nv) - 3)));

  stamp(p, b, 0);
  // ---- pass 0: v32, the cleared table and masks, the LUTs ----
  for (int q = tid; q < kLL + kOF + kML; q += kThreads) s_hist[q] = 0;
  if (tid == 0) s_msum = 0;
  if (compact)
    for (int q = tid; q < kLutLL + kLutML; q += kThreads) s_lut[q] = p.lut[q];
  for (int q = tid; q < nw; q += kThreads) cmask[q] = 0u;
  for (int q = tid; q < (1 << p.hash_log); q += kThreads) table[q] = -1;
  for (int i = tid; i < N; i += kThreads) {
    uint32_t x = row[i];
    if (i + 1 < N) x |= static_cast<uint32_t>(row[i + 1]) << 8;
    if (i + 2 < N) x |= static_cast<uint32_t>(row[i + 2]) << 16;
    if (i + 3 < N) x |= static_cast<uint32_t>(row[i + 3]) << 24;
    v32[i] = x;
  }
  __syncthreads();
  stamp(p, b, 1);

  // ---- pass 1: previous occurrence, one warp, 32 positions a step ----
  if (warp == 0) {
    const int shift = 32 - p.hash_log;
    // the table's chain runs through shared memory alone: a group of
    // kAhead steps takes its hashes' groups (__match_any_sync) before its
    // table accesses, and loads the next group's v32 while they run
    uint32_t vq[kAhead];
#pragma unroll
    for (int s = 0; s < kAhead; ++s) {
      const int i = 32 * s + lane;
      vq[s] = i < cnt ? v32[i] : 0u;
    }
    for (int base = 0; base < cnt; base += 32 * kAhead) {
      uint32_t h[kAhead];
      unsigned grp[kAhead];
#pragma unroll
      for (int s = 0; s < kAhead; ++s) {
        // a hash is below 2^hash_log, so the idle lanes' value is no hash
        h[s] = base + 32 * s + lane < cnt ? (vq[s] * kPrime) >> shift
                                          : kFull;
        grp[s] = __match_any_sync(kFull, h[s]);
      }
#pragma unroll
      for (int s = 0; s < kAhead; ++s) {
        const int i = base + 32 * (kAhead + s) + lane;
        vq[s] = i < cnt ? v32[i] : 0u;
      }
#pragma unroll
      for (int s = 0; s < kAhead; ++s) {
        const int i = base + 32 * s + lane;
        const bool act = i < cnt;
        const unsigned lower = grp[s] & ((1u << lane) - 1u);
        int c = -1;
        if (act) c = lower ? i - lane + 31 - __clz(static_cast<int>(lower))
                           : table[h[s]];
        __syncwarp();
        if (act && (grp[s] >> lane) == 1u) table[h[s]] = i;
        __syncwarp();
        if (act) cand[i] = c;
      }
    }
  }
  __syncthreads();
  stamp(p, b, 2);

  // ---- pass 2: validity and match length, the valid bitmask ----
  for (int base = warp * 32; base < nw * 32; base += kThreads) {
    const int i = base + lane;
    bool valid = false;
    if (i < cnt) {
      const int c = cand[i];
      if (c >= 0 && v32[c] == v32[i]) {
        int m = match_length(v32, i, c, N - 1, p.u64_rounds,
                             p.stride_rounds);
        m = min(min(m, N - i), nv - i);
        if (m >= kMinMatch) {
          valid = true;
          mlg[i] = m;
        }
      }
    }
    const unsigned bits = __ballot_sync(kFull, valid);
    if (lane == 0) vmask[base >> 5] = bits;
  }
  __syncthreads();
  // the summary: bit x of s_sum[g] is set when word 32 g + x has a valid
  // position
  const int ng = (nw + 31) >> 5;
  for (int g = warp; g < ng; g += kWarps) {
    const int q = (g << 5) + lane;
    const unsigned nz = __ballot_sync(kFull, q < nw && vmask[q] != 0u);
    if (lane == 0) s_sum[g] = nz;
  }
  // the jump byte of each valid j, in place of its ml byte: d with the
  // next valid position at or past min(j + ml, N) at j + 4 + d (N: none),
  // found in the word of j + ml or the next; 255 where it is not, or d
  // would not fit
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
  stamp(p, b, 3);

  // ---- pass 3: the greedy walk, one thread ----
  int32_t* starts = p.starts + seq0;
  int32_t* mls = p.mls + seq0;
  int32_t* offs = p.offs + seq0;
  if (tid == 0) {
    // the first valid position at or past pos (N: none), two-level
    auto next_valid = [&](int pos) {
      if (pos >= N) return N;
      int w = pos >> 5;
      const uint32_t word = vmask[w] & (kFull << (pos & 31));
      if (word != 0u) return (w << 5) + __ffs(static_cast<int>(word)) - 1;
      const int q = w + 1;
      int g = q >> 5;
      uint32_t sw = q < nw ? s_sum[g] & (kFull << (q & 31)) : 0u;
      while (sw == 0u && ++g < ng) sw = s_sum[g];
      if (sw == 0u) return N;
      w = (g << 5) + __ffs(static_cast<int>(sw)) - 1;
      return (w << 5) + __ffs(static_cast<int>(vmask[w])) - 1;
    };
    int k = 0;
    int j = next_valid(0);
    while (j < N && k < S) {
      starts[k++] = j;
      const int d = jump[j];
      j = d < 255 ? j + kMinMatch + d : next_valid(min(j + mlg[j], N));
    }
    s_nseq = k;
    p.nseq[b] = k;
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
    const int per = (nw + kThreads - 1) / kThreads;
    const int w0 = min(tid * per, nw), w1 = min(w0 + per, nw);
    int local = 0;
    for (int w = w0; w < w1; ++w) local += __popc(lit_word(cmask, w, lim));
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
    int excl = x - local + (warp ? s_scan[warp - 1] : 0);
    for (int w = w0; w < w1; ++w) {
      wpre[w] = static_cast<uint32_t>(excl);
      excl += __popc(lit_word(cmask, w, lim));
    }
    total = s_scan[kWarps - 1];
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
  p.u64_rounds = u64_rounds;
  p.stride_rounds = stride_rounds;
  p.nwords = (n + 31) / 32;
  const int table_bytes = shared_table ? 4 << hash_log : 0;
  const int row_bytes = (n + 15) & ~15;
  const int word_bytes = (p.nwords * 4 + 15) & ~15;
  p.region_a = std::max({table_bytes, row_bytes, word_bytes});
  const int dyn = p.region_a + 2 * word_bytes;
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
