// The decode plane's lane decode, designed for Hopper: literal assembly,
// sequence-row selection and batched LZ sequence execution
// (ZSTD_execSequence), one block per lane, every lane of a batch in one
// launch.
//
// Replaces the TPU design of zstdsharp_tpu/decode/device_pipeline.py
// _fused_decode (:1203, one jitted XLA program a chunk: the literal
// assembly, then ops/execseq.py:make_executor (:41; XLA, no pallas_call),
// reached from :1217).  Its one entry, zt_lz_decode, reads each lane
// straight from the decode plane's sources through its int64 meta row
// (lit_kind, pool_base, pool_len, huf_lane0, huf_seg, seq_kind, fse_lane,
// host_row, n_seq, lit_regen, out_len, win_len).  Literal byte i of a lane
// (i < L = O) is the function the plain version (ops/execseq.py assemble)
// evaluates, with its clamps:
//   - Huffman (lit_kind 1, with Huffman rows): s = min(i // seg, 3),
//     seg >= 1, qi = clamp(s T + i - s seg, 0, 4T - 1), the low byte of the
//     int32 symbol at st + qi of the flat rows, st = max(lane0, 0) T
//     clamped to [0, n_huf + 8] and 0 past the rows (the padded dynamic
//     slice);
//   - RLE (pool_len 1): the pool byte at st = clamp(pool_base, 0,
//     n_raw + 8), 0 past the pool;
//   - raw: the pool byte at st + i, 0 past the pool.
// ll/ml/off[k] are row min(max(fse_lane, 0), n_fse - 1) of the FSE rows
// (seq_kind 1; 0 for k >= their width T, off included), row
// min(max(host_row, 0), n_host - 1) of the host rows (seq_kind 2), else
// (0, 0, 1); last_lit = lit_regen - the int64 sum of the live ll.
//
// A lane's window is W bytes at a start clamped to [0, row - W] of its
// row of the window tensor (row stride 0: one row for every lane), and
// its output O bytes at a start clamped to [0, row - O] of its row of the
// output tensor.  A multi-block round so reads its window out of the
// frame accumulator and writes its block's output into it in place: lane
// k's window [st, st + Wb) ends where its output [Wb + st, ...) begins,
// and only lane k touches row k of the accumulator, so no byte a lane
// reads is written by another lane; a lane stores its row only after its
// last read of the window, so even a clamped start that made the two
// overlap would read the bytes as they were before the round.
//
// Per lane the kernel computes exactly what ops/execseq.py:make_executor's
// run computes, byte for byte on any operands:
//   * ll/ml/off are u32 bits read as int32, sums are int64, off is clamped
//     to >= 1, a trailing pseudo-sequence at n_seq carries last_lit;
//   * output byte p lies in the segment a binary search finds (the last
//     live-or-tail sequence whose run starts at or before p); a literal
//     byte reads pool index lit_before + (p - run_start), a match byte the
//     source j = p - off, collapsed onto [start - off, start) past the
//     first period; j >= 0 is an earlier output byte, j < 0 pool index
//     L + W + j, where the pool is lit || window;
//   * a pool index q below 0 is encoded by the plain version as -(1 + q),
//     which is >= 0 and so reads as output position -q - 1 (forward, past
//     O, or round a cycle for corrupt operands); a position at or past O
//     resolves to the last pool byte, a chain still unresolved after the
//     pointer-jumping rounds (a cycle) to pool byte 0; positions at or past
//     out_len take their literal source and are stored as zero.
// It also writes each lane's flags, exactly as ops/execseq.py:lane_flags
// computes them on any operands: bit 0 last_lit < 0; bit 1 the live ll
// and ml (as u32) plus last_lit, summed in wrapping int64, differ from
// out_len; bit 2 a live offset (as u32) is 0 or exceeds its match's
// output position (the u32 sums before it) plus win_len.  These are
// libzstd's checks in ZSTD_execSequence and ZSTD_decompressSequences, so
// the decode plane rejects the blocks libzstd rejects.
//
// What bounds it on the H100.  Roofline: the call must write N x O output
// bytes and read each lane's live literals (raw bytes, or 4-byte Huffman
// symbols), the window bytes its matches use, 12 bytes a live sequence
// and 96 bytes of meta: for the decode cell's 256 lanes [O 24576] about
// 12 MB, about 4 us at 3.35 TB/s.  Serial floor: within a lane a match
// may read the bytes the match before it wrote, so a lane walks its
// sequences in order, and each step (load the sequence, test its sources,
// copy, maybe a barrier) is a chain of shared-memory latencies, about
// 100 ns a sequence; a level-9 24 KB record has up to 1,900 sequences.
// One launch holds every lane, so the call takes about the longest lane's
// walk when all lanes fit in one wave, which they do at the decode cell's
// 256 lanes (2 a SM of the 132).  The serial floor is the larger bound by
// two orders of magnitude, so the design keeps that walk short and puts
// nothing else in front of it:
//
// * One launch for every lane of a batch, one block a lane, 128 threads,
//   a 1-D grid.  The lane's output row lives in dynamic shared memory (O
//   bytes, up to 227 KB less the static part; the launcher opts in on
//   every launch), so a match reads its sources at shared-memory latency;
//   the row is stored once at the end with 16-byte stores where aligned,
//   zeros past out_len included.  Blocks of other lanes share the SM.
// * No assembly pass.  The literal bytes and sequence rows are read from
//   the decode plane's sources through the lane's meta row, so the
//   assembled rows ([N, O] literals, [N, S] ll/ml/off) are never written
//   or read, and none of the assembly's ~40 small launches a chunk runs.
// * Sources staged in shared memory.  The one pass ahead of the walk reads
//   the live sequences once (for last_lit and the irregular-lane test)
//   with 8 loads in flight a thread, and where the three rows fit in the
//   launch's stage (the shared memory past the row that the wrapper gives
//   a block: as much as O literals and S sequences need, but no more than
//   lets the batch's blocks share the SMs in one wave) it writes them
//   there; the lane's literals follow, the same way, where they fit too.
//   The walk then waits on no device memory but the window's for its
//   sequences and literals.  A lane that does not fit reads them from
//   device memory where the walk needs them.
// * Sequences in tiles of 128: each thread loads one sequence and an int64
//   block scan (warp shuffles) gives every run's start and literal offset,
//   so the prefix sums cost no extra launch and no scratch.
// * Literal bytes first, matches after.  A literal reads only the pool, so
//   a tile's literal bytes, contiguous in the pool, are copied one a thread
//   with no barrier, each thread finding its byte's sequence by a binary
//   search of the tile's literal offsets: their loads are all in flight at
//   once rather than one run's after another's.
// * Matches in groups.  A match reads only bytes before its own start (the
//   collapse makes every byte of a match independent of the others), and
//   those are final once the matches before them are.  The walk keeps a
//   frontier F below which every byte is final and needs a barrier only
//   where a match's sources reach past F, which then moves to that match's
//   start.  Warp 0 finds those points for the tile with ballots (one step
//   a barrier, not a sequence); between two of them the matches are
//   independent, and their output positions are copied one a thread, each
//   finding its sequence by a binary search of the run starts.
// * The flags cost no pass of their own over a walked lane: each thread
//   adds its sequence's ll + ml to a register and tests its offset against
//   the run start the tile's scan already gave it; one block reduction at
//   the end sums and ORs the threads' registers.  Only where the walk stops
//   early (out_len reached before the last sequence, corrupt operands) or
//   the lane takes the exact path is the rest scanned for the flags alone.
// * Exact for any operand.  A lane with a negative live ll or ml, or a
//   negative last_lit, has run starts that are not monotone: it takes the
//   exact path, which is the plain version's algorithm inside the block
//   (the prefix sums into scratch, the same binary search per byte, the
//   first source of every position as an int32 code in scratch, then the
//   same number of pointer-jumping rounds in place, and the pool gather,
//   its literal part through the same literal function).  A walked lane
//   whose match reads a position the walk has not finalised (only a pool
//   reference below index 0 can, for corrupt offsets) drops its walk and
//   takes the exact path too.  Every index is clamped as the plain version
//   clamps it, so no meta and no operand gives an illegal address.  No
//   valid frame takes the exact path.
//
// Measured on an H100 (PERF.md section 6, chip_smoke.py phase lz_exec,
// tools/torch_decode_ab.py): the decode cell's 256 lanes in one launch
// take 0.199 ms of device time, 0.204 ms through the wrapper against 0.194
// ms for its longest lane alone (103 ns a sequence), where the chunked
// executor took 0.74 ms in 4 launches; staging took 2-3 % off the
// unstaged fused kernel's 0.203-0.205 ms.  Walking the match groups in
// one warp (warp barriers, 32 positions at a time) doubled the time, and
// loading each group's bounds ahead of its barrier changed nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // threads a block, also sequences a tile
constexpr int kWarps = kThreads / 32;
constexpr int kMeta = 12;      // int64 columns of a lane's meta row
constexpr int kUnroll = 8;     // loads in flight a thread while staging
// the static shared memory: the tile's arrays, the group count and the
// scan's partials (4,680 bytes)
constexpr int kStatic = kThreads * (8 + 8 + 8 + 4 + 4 + 4) + 8 +
                        2 * kWarps * 8;
// 227 KB, the most a block may opt into, less an allowance for the static
// part (ops/execseq.py MAX_O)
constexpr int kStaticAllowance = 8192;
constexpr long long kSmemMax = 232448 - kStaticAllowance;
static_assert(kStatic <= kStaticAllowance,
              "static shared memory over its allowance");

using i64 = long long;
using u64 = unsigned long long;

// What a launch reads.
struct Params {
  const i64* meta;  // [N, kMeta]
  // the decode plane's sources
  const uint8_t* raw;  // [n_raw], the literal pool
  const int32_t* huf;  // [n_huf], the Huffman rows, T a row; may be null
  const int32_t* fse[3];  // [n_fse, fse_T] ll, ml, off; may be null
  const int32_t* hst[3];  // [n_host, host_T]; may be null
  i64 n_raw, n_huf, huf_T, n_fse, fse_T, n_host, host_T;
  // window and output: lane b's row at b * stride, its bytes at a start
  // (null: 0) clamped to [0, row - width]
  const uint8_t* win;
  i64 W, win_stride, win_row;
  const i64* win_start;
  uint8_t* out;
  i64 O, O16, out_stride, out_row;
  const i64* out_start;
  i64 S;
  i64 stage;  // shared-memory bytes past the row for the staged sources
  int32_t* bad;  // [N] the flags
  i64* seg_scratch;  // [N, 2, S + 1]
  int32_t* code_scratch;  // [N, O]
  int search_rounds, jump_rounds;
};

enum LitMode { kRaw = 0, kRle = 1, kHuf = 2 };

struct Lane {
  // literals: raw bytes from raw[lst], one RLE byte, or Huffman symbols
  // from huf[lst]; the first n_lit_st of them staged in s_lit
  int mode;
  const uint8_t* raw;
  const int32_t* huf;
  i64 lst, n_src, T, seg;
  uint8_t rle;
  const uint8_t* s_lit;
  i64 n_lit_st;
  // sequence rows, width T_seq; null: (0, 0, 1); the live ones staged in
  // s_ll/s_ml/s_off when those are not null
  const int32_t* ll;
  const int32_t* ml;
  const int32_t* off;
  i64 T_seq;
  const int32_t* s_ll;
  const int32_t* s_ml;
  const int32_t* s_off;
  const uint8_t* win;  // [W]
  i64 L, P, S, O, n_seq, out_len, wlen;  // wlen: win_len
  int32_t last;  // last_lit as int32
};

__device__ __forceinline__ i64 clampi(i64 v, i64 lo, i64 hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Literal byte q of the lane, 0 <= q < L.
__device__ __forceinline__ uint8_t lit_at(const Lane& z, i64 q) {
  if (q < z.n_lit_st) return z.s_lit[q];
  if (z.mode == kRle) return z.rle;
  if (z.mode == kRaw) {
    const i64 i = z.lst + q;
    return i < z.n_src ? z.raw[i] : 0;
  }
  // the quarter: min(q // seg, 3) without a division (q < 2^30)
  const i64 seg = z.seg;
  const i64 s = q < seg ? 0 : (q - seg < seg ? 1 : (q - 2 * seg < seg ? 2
                                                                      : 3));
  const i64 qi = clampi(s * z.T + q - s * seg, 0, 4 * z.T - 1);
  const i64 i = z.lst + qi;
  return i < z.n_src ? static_cast<uint8_t>(z.huf[i]) : 0;
}

__device__ __forceinline__ uint8_t pool_at(const Lane& z, i64 q) {
  q = q < 0 ? 0 : (q >= z.P ? z.P - 1 : q);
  return q < z.L ? lit_at(z, q) : z.win[q - z.L];
}

// Sequence rows at k < S (staged: k < the live count, which every
// caller keeps to).
__device__ __forceinline__ int32_t ll_at(const Lane& z, i64 k) {
  if (z.s_ll) return z.s_ll[k];
  return z.ll && k < z.T_seq ? z.ll[k] : 0;
}
__device__ __forceinline__ int32_t ml_at(const Lane& z, i64 k) {
  if (z.s_ml) return z.s_ml[k];
  return z.ml && k < z.T_seq ? z.ml[k] : 0;
}
__device__ __forceinline__ int32_t off_at(const Lane& z, i64 k) {
  if (z.s_off) return z.s_off[k];
  return z.off ? (k < z.T_seq ? z.off[k] : 0) : 1;
}

// The plain version's extended sequence k in [0, S]: (ll, ml, off).
__device__ __forceinline__ void ext(const Lane& z, i64 k, i64& l, i64& m,
                                    i64& o) {
  const bool live = k < z.n_seq, tail = k == z.n_seq;
  const bool real = live && k < z.S;
  l = tail ? z.last : (real ? ll_at(z, k) : 0);
  m = real ? ml_at(z, k) : 0;
  o = real ? max(off_at(z, k), 1) : 1;
}

// Flag bit 2 for live sequence k whose match starts at output position
// ms: its offset as u32 is 0 or reaches before the lane's window.
__device__ __forceinline__ bool reach_bad(const Lane& z, i64 k, i64 ms) {
  const uint32_t o = static_cast<uint32_t>(off_at(z, k));
  const i64 lim = static_cast<i64>(static_cast<u64>(ms) +
                                   static_cast<u64>(z.wlen));
  return o == 0 || static_cast<i64>(o) > lim;
}

// Exclusive block scan of (a, b) over the block's threads in order: ea, eb
// the sums before this thread, ta, tb the block's totals.  sh holds
// 2 * kWarps partials; the leading barrier keeps a scan from overwriting
// them while the previous one still reads them.
__device__ __forceinline__ void scan2(i64 a, i64 b, i64& ea, i64& eb, i64& ta,
                                      i64& tb, i64* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  i64 ia = a, ib = b;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const i64 xa = __shfl_up_sync(0xffffffffu, ia, d);
    const i64 xb = __shfl_up_sync(0xffffffffu, ib, d);
    if (lane >= d) {
      ia += xa;
      ib += xb;
    }
  }
  __syncthreads();
  if (lane == 31) {
    sh[warp] = ia;
    sh[kWarps + warp] = ib;
  }
  __syncthreads();
  i64 pa = 0, pb = 0;
  ta = tb = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const i64 wa = sh[w], wb = sh[kWarps + w];
    if (w < warp) {
      pa += wa;
      pb += wb;
    }
    ta += wa;
    tb += wb;
  }
  ea = pa + ia - a;
  eb = pb + ib - b;
}

// Last index i in [lo, hi) with a[i] <= v, given a[lo] <= v and a
// nondecreasing on [lo, hi).
__device__ __forceinline__ int last_le(const i64* a, int lo, int hi, i64 v) {
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

// The flags' scan over live sequences [k_from, K), the first of which
// starts at output position rs: each thread adds its sequences' ll + ml
// (as u32) to fsum and ORs bit 2 into fbad.
__device__ void flag_scan(const Lane& z, i64 k_from, i64 rs, i64 K,
                          i64& fsum, bool& fbad, i64* sh) {
  for (i64 k0 = k_from; k0 < K; k0 += kThreads) {
    const i64 k = k0 + threadIdx.x;
    i64 l = 0, m = 0;
    if (k < K) {
      l = static_cast<uint32_t>(ll_at(z, k));
      m = static_cast<uint32_t>(ml_at(z, k));
    }
    i64 ers, e2, tot, t2;
    scan2(l + m, 0, ers, e2, tot, t2, sh);
    if (k < K) {
      fsum += l + m;
      fbad |= reach_bad(z, k, rs + ers + l);
    }
    rs += tot;
  }
}

// The in-order walk of a lane whose run starts are monotone: writes
// row[0, oe) and returns false, or returns true (every thread alike) when
// a match reads a position the walk has not finalised.  Per tile of
// kThreads sequences: the scan, the tile's literal bytes (one a thread),
// the barrier points (warp 0), then each group of matches between two
// barriers, one output position a thread.  The flags of the live
// sequences it reaches go into fsum and fbad; where it stops before the
// last one, k_rest and rs_rest say where the flags' scan resumes.
__device__ bool walk(const Lane& z, i64 oe, uint8_t* row, i64* t_rs,
                     i64* t_lb, i64* t_hi, int32_t* t_ll, int32_t* t_off,
                     int32_t* t_g, int* t_ng, i64* sh, i64& fsum, bool& fbad,
                     i64& k_rest, i64& rs_rest) {
  const int tid = threadIdx.x, lane = tid & 31;
  const i64 K = z.n_seq < 0 ? 0 : min(z.n_seq, z.S);  // the last segment
  i64 rs_c = 0, lb_c = 0;
  bool redo = false;
  for (i64 k0 = 0; k0 <= K; k0 += kThreads) {
    if (__syncthreads_or(redo)) return true;
    if (rs_c >= oe) {
      k_rest = k0;
      rs_rest = rs_c;
      break;
    }
    const int n = static_cast<int>(min(static_cast<i64>(kThreads),
                                       K + 1 - k0));
    i64 l = 0, m = 0, o = 1;
    if (tid < n) ext(z, k0 + tid, l, m, o);
    i64 ers, elb, tot_s, tot_l;
    scan2(l + m, l, ers, elb, tot_s, tot_l, sh);
    if (tid < n) {
      const i64 rs = rs_c + ers, ms = rs + l;
      const i64 me = k0 + tid == K ? oe : min(ms + m, oe);
      t_rs[tid] = rs;
      t_lb[tid] = elb;  // relative to the tile's first literal
      t_ll[tid] = static_cast<int32_t>(l);  // >= 0 in a walked lane
      t_off[tid] = static_cast<int32_t>(o);
      // the end of the match's sources at or above 0; none: never a barrier
      t_hi[tid] = ms < me ? ms - o + min(me - ms, o) : INT64_MIN;
      if (k0 + tid < K) {  // a live sequence (l, m >= 0: their u32 bits)
        fsum += l + m;
        fbad |= reach_bad(z, k0 + tid, ms);
      }
    }
    const i64 lb0 = lb_c;
    const i64 tile_end = k0 + n - 1 == K ? oe : min(rs_c + tot_s, oe);
    rs_c += tot_s;
    lb_c += tot_l;
    __syncthreads();

    // the tile's literal bytes, contiguous in the pool: one a thread,
    // positions rising with the byte, so a thread stops at the first at or
    // past oe
    for (i64 t = tid; t < tot_l; t += kThreads) {
      const int i = last_le(t_lb, 0, n, t);
      const i64 p = t_rs[i] + (t - t_lb[i]);
      if (p >= oe) break;
      row[p] = pool_at(z, lb0 + t);
    }

    // warp 0: the barrier points.  Every byte below F is final; a match
    // whose sources reach past F starts a group after a barrier and sets
    // F to its start.  Group g is the sequences [t_g[g], t_g[g + 1]).
    if (tid < 32) {
      i64 F = t_rs[0] + t_ll[0];
      int ng = 1;
      for (int base = 0; base < n; base += 32) {
        const int i = base + lane;
        const i64 hi = i < n ? t_hi[i] : INT64_MIN;
        const i64 ms = i < n ? t_rs[i] + t_ll[i] : 0;
        unsigned pend = __ballot_sync(0xffffffffu, hi > F);
        while (pend) {
          const int f = __ffs(pend) - 1;
          if (lane == 0) t_g[ng] = base + f;
          ++ng;
          F = __shfl_sync(0xffffffffu, ms, f);
          pend = __ballot_sync(0xffffffffu, hi > F && lane > f);
        }
      }
      if (lane == 0) {
        t_g[0] = 0;
        t_g[ng] = n;
        *t_ng = ng;
      }
    }
    __syncthreads();

    const int ng = *t_ng;
    for (int g = 0; g < ng; ++g) {
      const int gs = t_g[g], ge = t_g[g + 1];
      if (g > 0) __syncthreads();
      const i64 F = t_rs[gs] + t_ll[gs];
      const i64 end = ge < n ? min(t_rs[ge], oe) : tile_end;
      for (i64 p = F + tid; p < end; p += kThreads) {
        const int i = last_le(t_rs, gs, ge, p);
        const i64 ms = t_rs[i] + t_ll[i];
        if (p < ms) continue;  // a literal byte, already written
        const i64 o = t_off[i], d = p - ms;
        const i64 j = d < o ? p - o
                            : ms - o + static_cast<uint32_t>(d) %
                                           static_cast<uint32_t>(o);
        uint8_t v = 0;
        if (j >= 0) {
          v = row[j];
        } else if (z.P + j >= 0) {
          v = pool_at(z, z.P + j);
        } else {
          const i64 t = -(z.P + j) - 1;  // the plain version's position
          if (t >= z.O)
            v = pool_at(z, z.P - 1);
          else if (t < F)
            v = row[t];
          else
            redo = true;
        }
        row[p] = v;
      }
    }
  }
  return __syncthreads_or(redo);
}

// The plain version's algorithm for any lane: row[0, oe) from the prefix
// sums (seg scratch [2, S+1]), the binary search and the pointer-jumping
// rounds over int32 codes (code scratch [O]): -(1 + pool index) when
// resolved, else an output position.
__device__ void exact(const Lane& z, i64 oe, uint8_t* row, i64* seg,
                      int32_t* code, int search_rounds, int jump_rounds,
                      i64* sh) {
  const int tid = threadIdx.x;
  i64* rsa = seg;
  i64* lba = seg + z.S + 1;
  i64 rs_c = 0, lb_c = 0;
  for (i64 k0 = 0; k0 <= z.S; k0 += kThreads) {
    const i64 k = k0 + tid;
    i64 l = 0, m = 0, o = 1;
    if (k <= z.S) ext(z, k, l, m, o);
    i64 ers, elb, tot_s, tot_l;
    scan2(l + m, l, ers, elb, tot_s, tot_l, sh);
    if (k <= z.S) {
      rsa[k] = rs_c + ers;
      lba[k] = lb_c + elb;
    }
    rs_c += tot_s;
    lb_c += tot_l;
  }
  __syncthreads();

  for (i64 p = tid; p < z.O; p += kThreads) {
    i64 lo = 0, hi = z.S;
    for (int r = 0; r < search_rounds; ++r) {
      const i64 mid = (lo + hi + 1) >> 1;
      const i64 dead = z.n_seq >= 0 && mid <= z.n_seq ? rsa[mid] : 1ll << 30;
      if (dead <= p)
        lo = mid;
      else
        hi = mid - 1;
    }
    const i64 s = lo;
    i64 l, m, o;
    ext(z, s, l, m, o);
    const i64 ms = rsa[s] + l;
    i64 v;
    if (p < ms || p >= z.out_len) {
      v = -(1 + lba[s] + (p - rsa[s]));
    } else {
      i64 j = p - o;
      if (j >= ms) j = ms - o + (p - ms) % o;
      v = j >= 0 ? j : -(1 + z.P + j);
    }
    int32_t c;
    if (v >= z.O) {
      c = static_cast<int32_t>(-z.P);  // past O: the last pool byte
    } else if (v < 0) {
      i64 q = -v - 1;
      q = q < 0 ? 0 : (q >= z.P ? z.P - 1 : q);
      c = static_cast<int32_t>(-(1 + q));
    } else {
      c = static_cast<int32_t>(v);
    }
    code[p] = c;
  }
  __syncthreads();

  // in place: a thread may read a code already advanced this round, which
  // only takes more steps; resolved codes stay, so the result is the same
  volatile int32_t* vc = code;
  for (int r = 0; r < jump_rounds; ++r) {
    bool left = false;
    for (i64 p = tid; p < z.O; p += kThreads) {
      const int32_t c = vc[p];
      if (c >= 0) {
        const int32_t t = vc[c];
        vc[p] = t;
        left |= t >= 0;
      }
    }
    if (!__syncthreads_or(left)) break;
  }
  for (i64 p = tid; p < oe; p += kThreads) {
    const int32_t c = vc[p];
    row[p] = pool_at(z, c < 0 ? -static_cast<i64>(c) - 1 : 0);
  }
}

// Lane b's sources, its window and its meta scalars; the caller sets
// z.last from lit_regen.
__device__ void setup(const Params& p, i64 b, Lane& z, i64& lit_regen) {
  z.L = p.O;
  z.S = p.S;
  z.O = p.O;
  z.P = p.O + p.W;
  z.win = p.win + b * p.win_stride +
          (p.win_start ? clampi(p.win_start[b], 0, p.win_row - p.W) : 0);
  z.huf = nullptr;
  z.seg = 1;
  z.T = 0;
  z.rle = 0;
  z.s_lit = nullptr;
  z.n_lit_st = 0;
  z.s_ll = z.s_ml = z.s_off = nullptr;
  const i64* m = p.meta + b * kMeta;
  const i64 lit_kind = m[0], pool_base = m[1], pool_len = m[2];
  const i64 lane0 = m[3], seq_kind = m[5];
  z.n_seq = m[8];
  lit_regen = m[9];
  z.out_len = m[10];
  z.wlen = m[11];
  z.raw = p.raw;
  z.lst = clampi(pool_base, 0, p.n_raw + 8);
  z.n_src = p.n_raw;
  z.mode = kRaw;
  if (lit_kind == 1 && p.huf) {
    z.mode = kHuf;
    z.huf = p.huf;
    z.T = p.huf_T;
    z.seg = max(m[4], 1ll);
    // max(lane0, 0) * T wraps in int64 as the plain version's product
    z.lst = clampi(static_cast<i64>(static_cast<u64>(max(lane0, 0ll)) *
                                    static_cast<u64>(p.huf_T)),
                   0, p.n_huf + 8);
    z.n_src = p.n_huf;
  } else if (pool_len == 1) {
    z.mode = kRle;
    z.rle = z.lst < p.n_raw ? p.raw[z.lst] : 0;
  }
  z.ll = z.ml = z.off = nullptr;
  z.T_seq = 0;
  if (seq_kind == 1 && p.fse[0]) {
    const i64 r = min(max(m[6], 0ll), p.n_fse - 1) * p.fse_T;
    z.ll = p.fse[0] + r;
    z.ml = p.fse[1] + r;
    z.off = p.fse[2] + r;
    z.T_seq = p.fse_T;
  } else if (seq_kind == 2 && p.hst[0]) {
    const i64 r = min(max(m[7], 0ll), p.n_host - 1) * p.host_T;
    z.ll = p.hst[0] + r;
    z.ml = p.hst[1] + r;
    z.off = p.hst[2] + r;
    z.T_seq = p.host_T;
  }
}

__global__ void __launch_bounds__(kThreads) lz_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t row[];
  __shared__ i64 t_rs[kThreads], t_lb[kThreads], t_hi[kThreads];
  __shared__ i64 sh[2 * kWarps];
  __shared__ int32_t t_ll[kThreads], t_off[kThreads];
  __shared__ int32_t t_g[kThreads + 1];
  __shared__ int t_ng;
  const int tid = threadIdx.x;
  const i64 b = blockIdx.x;
  const i64 S = p.S, O = p.O;

  Lane z;
  i64 lit_regen;
  setup(p, b, z, lit_regen);
  const i64 oe = z.out_len < 0 ? 0 : min(z.out_len, O);

  // one pass over the live sequences: the int64 sum of ll (last_lit from
  // the meta) and the walk's test, every live ll and ml >= 0; where the
  // three rows fit in the stage, they are copied there on the way, with
  // kUnroll loads in flight a thread
  const i64 nlive = z.n_seq < 0 ? 0 : min(z.n_seq, S);
  int32_t* s_seq = reinterpret_cast<int32_t*>(row + p.O16);
  const bool st_seq = z.ll && 12 * nlive <= p.stage;
  i64 sum_ll = 0;
  bool neg = false;
  for (i64 k0 = tid; k0 < nlive; k0 += kUnroll * kThreads) {
    int32_t l[kUnroll], m[kUnroll], o[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const i64 k = k0 + u * kThreads;
      const bool in = k < nlive;
      l[u] = in ? ll_at(z, k) : 0;
      m[u] = in ? ml_at(z, k) : 0;
      o[u] = in && st_seq ? off_at(z, k) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const i64 k = k0 + u * kThreads;
      sum_ll += l[u];
      neg |= (l[u] < 0) | (m[u] < 0);
      if (st_seq && k < nlive) {
        s_seq[k] = l[u];
        s_seq[nlive + k] = m[u];
        s_seq[2 * nlive + k] = o[u];
      }
    }
  }
  i64 e1, e2, t_ll_sum, t_neg;
  scan2(sum_ll, neg ? 1 : 0, e1, e2, t_ll_sum, t_neg, sh);
  const i64 last = static_cast<i64>(static_cast<u64>(lit_regen) -
                                    static_cast<u64>(t_ll_sum));
  z.last = static_cast<int32_t>(last);

  // the literals the walk copies, [0, min(sum of ll + last_lit, L)), staged
  // after the rows where they fit too (an RLE lane reads no memory)
  const i64 n_lit = clampi(static_cast<i64>(static_cast<u64>(t_ll_sum) +
                                            static_cast<u64>(last)),
                           0, z.L);
  const i64 seq_bytes = st_seq ? 12 * nlive : 0;
  if (z.mode != kRle && n_lit > 0 && seq_bytes + n_lit <= p.stage) {
    uint8_t* s_lit = row + p.O16 + seq_bytes;
    for (i64 q0 = tid; q0 < n_lit; q0 += kUnroll * kThreads) {
      uint8_t v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const i64 q = q0 + u * kThreads;
        v[u] = q < n_lit ? lit_at(z, q) : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const i64 q = q0 + u * kThreads;
        if (q < n_lit) s_lit[q] = v[u];
      }
    }
    z.s_lit = s_lit;
    z.n_lit_st = n_lit;
  }
  if (st_seq) {
    z.s_ll = s_seq;
    z.s_ml = s_seq + nlive;
    z.s_off = s_seq + 2 * nlive;
  }
  __syncthreads();

  // walked lane: every live ll and ml and the tail's last_lit >= 0
  const bool irregular =
      t_neg > 0 || (z.n_seq >= 0 && z.n_seq <= S && z.last < 0);
  i64 fsum = 0, k_rest = nlive, rs_rest = 0;
  bool fbad = false;
  if (irregular ||
      walk(z, oe, row, t_rs, t_lb, t_hi, t_ll, t_off, t_g, &t_ng, sh, fsum,
           fbad, k_rest, rs_rest)) {
    fsum = 0;
    fbad = false;
    k_rest = rs_rest = 0;
    exact(z, oe, row, p.seg_scratch + b * 2 * (S + 1),
          p.code_scratch + b * O, p.search_rounds, p.jump_rounds, sh);
  }
  // the flags: the rest of the live sequences, then one block reduction
  flag_scan(z, k_rest, rs_rest, nlive, fsum, fbad, sh);
  i64 tsum, tbad;
  scan2(fsum, fbad ? 1 : 0, e1, e2, tsum, tbad, sh);
  if (tid == 0) {
    const i64 total = static_cast<i64>(static_cast<u64>(tsum) +
                                       static_cast<u64>(last));
    p.bad[b] = (last < 0 ? 1 : 0) | (total != z.out_len ? 2 : 0) |
               (tbad > 0 ? 4 : 0);
  }

  // the row, zeros past out_len, stored once, after every read of the
  // window
  for (i64 q = oe + tid; q < p.O16; q += kThreads) row[q] = 0;
  __syncthreads();
  uint8_t* dst =
      p.out + b * p.out_stride +
      (p.out_start ? clampi(p.out_start[b], 0, p.out_row - O) : 0);
  if ((O & 15) == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(row);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (i64 q = tid; q < O / 16; q += kThreads) d4[q] = s4[q];
  } else {
    for (i64 q = tid; q < O; q += kThreads) dst[q] = row[q];
  }
}

}  // namespace

// Every lane of a batch from its meta row (meta int64 [n, 12]) and the
// decode plane's sources: raw u8 [n_raw]; huf int32 [n_huf] (T = huf_T a
// row; null when there are none); fse_ll/ml/off int32 [n_fse, fse_T] and
// host_ll/ml/off int32 [n_host, host_T] (null when there are none).  The
// literal rows are O bytes wide.  Lane b's window is the W bytes at
// clamp(win_start[b], 0, win_row - W) of window + b * win_stride (a null
// win_start: 0), its output the O bytes at clamp(out_start[b], 0,
// out_row - O) of out + b * out_stride.  bad [n] int32, the flags;
// seg_scratch int64 [n, 2, S+1] and code_scratch int32 [n, O], written
// only by lanes that take the exact path.  stage: the shared-memory bytes
// a block gets past its row for the staged sources.  Opts into the row's
// shared memory on every launch and launches n blocks.  Returns a
// cudaError_t.
extern "C" int zt_lz_decode(
    const void* meta, long long n, const void* raw, long long n_raw,
    const void* huf, long long n_huf, long long huf_T, const void* fse_ll,
    const void* fse_ml, const void* fse_off, long long n_fse,
    long long fse_T, const void* host_ll, const void* host_ml,
    const void* host_off, long long n_host, long long host_T,
    const void* window, long long W, long long win_stride,
    long long win_row, const void* win_start, void* out, long long O,
    long long out_stride, long long out_row, const void* out_start,
    long long S, long long stage, void* bad, void* seg_scratch,
    void* code_scratch, int search_rounds, int jump_rounds, void* stream) {
  if (n <= 0 || O <= 0) return 0;
  const long long o16 = (O + 15) & ~15ll;
  if (n_raw < 0 || (huf && (n_huf < 0 || huf_T <= 0)) ||
      (fse_ll && (n_fse <= 0 || fse_T < 0)) ||
      (host_ll && (n_host <= 0 || host_T < 0)) || W < 0 || S < 0 ||
      O > (1ll << 30) || O + W > (1ll << 31) - 1 || n > 0x7fffffff ||
      win_row < W || out_row < O || stage < 0 || (stage & 15) ||
      o16 + stage > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.meta = static_cast<const i64*>(meta);
  p.raw = static_cast<const uint8_t*>(raw);
  p.n_raw = n_raw;
  p.huf = static_cast<const int32_t*>(huf);
  p.n_huf = n_huf;
  p.huf_T = huf_T;
  p.fse[0] = static_cast<const int32_t*>(fse_ll);
  p.fse[1] = static_cast<const int32_t*>(fse_ml);
  p.fse[2] = static_cast<const int32_t*>(fse_off);
  p.n_fse = n_fse;
  p.fse_T = fse_T;
  p.hst[0] = static_cast<const int32_t*>(host_ll);
  p.hst[1] = static_cast<const int32_t*>(host_ml);
  p.hst[2] = static_cast<const int32_t*>(host_off);
  p.n_host = n_host;
  p.host_T = host_T;
  p.win = static_cast<const uint8_t*>(window);
  p.W = W;
  p.win_stride = win_stride;
  p.win_row = win_row;
  p.win_start = static_cast<const i64*>(win_start);
  p.out = static_cast<uint8_t*>(out);
  p.O = O;
  p.O16 = o16;
  p.out_stride = out_stride;
  p.out_row = out_row;
  p.out_start = static_cast<const i64*>(out_start);
  p.S = S;
  p.stage = stage;
  p.bad = static_cast<int32_t*>(bad);
  p.seg_scratch = static_cast<i64*>(seg_scratch);
  p.code_scratch = static_cast<int32_t*>(code_scratch);
  p.search_rounds = search_rounds;
  p.jump_rounds = jump_rounds;
  const long long dyn = o16 + stage;
  // the default 48 KB limit counts the static shared memory too, so opt in
  // on every launch rather than from a threshold on the dynamic size alone
  cudaError_t err = cudaFuncSetAttribute(
      lz_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dyn));
  if (err != cudaSuccess) return static_cast<int>(err);
  lz_kernel<<<static_cast<unsigned>(n), kThreads, static_cast<size_t>(dyn),
              static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
