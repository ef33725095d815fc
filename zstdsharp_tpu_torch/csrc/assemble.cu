// The encode plane's frame assembly, designed for Hopper: the three FSE
// state chains, the sequence bitstream, the 4-stream Huffman literals and
// the zstd frame row of every lane of a chunk in one launch, one block a
// lane.
//
// Replaces the TPU design of zstdsharp_tpu/ops/device_encode.py
// _assembly_phase (:643, one jitted XLA program a chunk; no pallas_call),
// the vmapped _encode_lane (:230-418): the state chains by permutation-map
// suffix composition (_fse_stream_states, :132-222), the prefix-scan bit
// packer (ops/common.py pack_bits_device) over the sequence fields and
// each Huffman quarter, and a byte-position classifier that reads every
// section at its clamped offset for each byte of the row.
//
// What it computes, integer for integer (the plain version is
// ops/assemble.py assemble_plain), for lane b with ns = nseq[b] and
// L = lit_count[b]:
//   * per sequence i < ns: ll = start - the previous sequence's end,
//     mlv = ml - 3, ofb = 1 when the offset equals the previous one with
//     ll > 0 (rep0) else off + 3; the codes through the LUTs (ll <= 63,
//     mlv <= 127) or highbit + 19 / + 36, ofCode = highbit(ofb);
//   * per stream (ll, of, ml), from u = init[c[ns - 1]] and i = ns - 2
//     down to 0: the emission at i is (TS + u, nbs[c_i][u]), then
//     u = maps[c_i][u]; the flush is the last u (0 when ns == 0).  The
//     kernel gets these by the reference's own method, composing the
//     maps of segments of the chain; composition is associative, so any
//     cut gives the same integers;
//   * the sequence bitstream: sequences ns - 1 down to 0, each as
//     [of_state, ml_state, ll_state, ll_extra, ml_extra, of_extra]
//     (states of slot ns - 1 have width 0), then the flushes [ml, of, ll]
//     at the lane's flush widths, every width 0 when nseq <= 0, each value
//     masked to its width, the end mark at bit total - 1; a field half
//     whose stream word is at or past W is dropped;
//   * quarter q of the literals (seg = max((L + 3) >> 2, 1), seglen = seg,
//     or L - 3 seg for q = 3) read back to front from q seg + seglen - 1,
//     Huffman code and width per symbol, dropped past WQ words;
//   * the sizes: sl[q], comp_lit = desc_len + 6 + sum sl, use_huf = ok &
//     5 + comp_lit < 3 + L & nseq > 0, the literal section, the body,
//     use_raw = nseq == 0 | comp_total >= raw_total, out_len;
//   * the row [N + 16]: the frame header (magic, FHD 0xA0, FCS32), the
//     block header, then either the record (raw block) or the literal
//     section (3-byte raw header and the literals, or the 5-byte
//     compressed header, the descriptor, the jump table and the four
//     streams), nbSeq in its 2-byte form, the mode byte, the table area
//     and the sequence bitstream; every byte at or past out_len is 0, and
//     a read past a source (the descriptor, the table area, a stream cut
//     at its capacity) repeats its last byte, as the classifier's clamps.
//
// What bounds it on the H100.  Roofline: a lane reads its literals (at
// most N bytes; a raw block its record instead), 12 bytes a live sequence
// and its tables (about 38 KB as uploaded), and writes its row (N + 16
// bytes): for the encode cell's first chunk of 32 x 16 KB, with 48,318
// sequences and 5,737 literals, about 2.3 MB, about 0.7 us at 3.35 TB/s
// (kernel_bench.assemble_work counts it for each run's data).  What sets
// its time is a lane's longest serial chain: the three FSE state chains,
// each step a shared-memory load whose address depends on the step before
// (about 58 cycles; 2,000-2,500 steps a 16 KB lane, up to ~26,000 at 128
// KB).  Walked one thread a stream, as this kernel first did, they were 83 %
// of the lane with the most sequences (143k of 173k cycles at 16 KB, 1.25M
// of 1.49M at 128 KB; kernel_bench.assemble_passes).  The design:
//
// * The lane's tables go to shared memory as two u8 tables a stream, the
//   next state and the state's width per (symbol, state).
// * Values and codes are computed in parallel, one thread a sequence; each
//   code also as its table row, min(c, nsym - 1) TS (u16), written into
//   the emission array, which is free until the chains' walk.
// * The chains by segment map composition (the reference's
//   _fse_stream_states does it with 64-step chunks and a scan): the steps
//   are cut into G segments (chain_cut: 32, 64 or 128 by the chain's
//   length) of L steps, a multiple of 4.  (a) Warp w composes segments w,
//   w + 32, ... of all three streams at once: lane x follows entry states
//   x and x + 32, so a step is five conflict-free gathers (an add and a
//   byte load each, the rows of four steps one u64 load) with no
//   dependence between them; the segment's top steps down to a multiple
//   of 4 go first, so every further four steps run without a branch.  The
//   composite (where each entry state leaves the segment) goes to shared
//   memory.  (b) One thread a stream crosses the G composites from the
//   initial state: each segment's entry state and the flush.  (c) One
//   thread a segment walks its L steps from its entry state and puts the
//   emissions the later passes read over the rows, four a u64 store.  The
//   serial depth falls from ns steps to about 3 ns / 32 + G + L; the
//   composition's gathers (TS x ns a stream) are spread over all warps,
//   and it is bound by their issue (about 300 cycles a step of all 32
//   warps).  Measured and dropped (PERF.md): a speculative walk,
//   each segment walked from a guessed state and stitched where the true
//   chain meets it (the LL chain keeps paths apart for 52 steps on average
//   at 16 KB and 123 at 128 KB, so the stitch follows most of it: 2.2-2.4x
//   slower than the serial walk); stopping a stream's composition where
//   its paths merge (the segment whose paths merge last sets the time);
//   64 segments from 2,048 steps (no change).
// * Sizes before bytes: each thread sums the widths of a contiguous run of
//   fields (the sequences in emission order, each quarter's symbols); one
//   block scan gives every run its bit offset and every stream its length,
//   so every section's place in the row is known before a byte is written.
//   The Huffman quarters' widths are summed beside the chains' walk.
// * Each field is ORed into the row's u32 words at its final bit offset
//   (8 section_start + pos), atomically, since runs share words; the
//   fixed-form bytes are plain stores before them.
// * Where the row and the sequence arrays (codes, 3 bytes a slot, and
//   emissions, 6) fit in shared memory (the 4, 16 and 64 KB buckets) the
//   row is built there and stored with 16-byte stores; at 128 KB both live
//   in device memory (the row in the output, the arrays in a scratch the
//   wrapper allocates); the composites stay in shared memory.  Opting
//   into more than 48 KB of shared memory happens on every launch.
// * Optional clock stamps (int64 [B, kStamps], thread 0 after each pass's
//   barrier) time the passes; a null pointer costs a compare.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxN = 1 << 17;  // ops/assemble.py MAX_N
constexpr int kMaxTS = 64;      // ops/assemble.py MAX_TS: a state is a byte
constexpr int kMaxNsym = 64;    // ops/assemble.py MAX_NSYM
constexpr int kLutLL = 64, kLutML = 128, kBitsLL = 36, kBitsML = 53;
constexpr int kLut = kLutLL + kLutML + kBitsLL + kBitsML;
constexpr int kScan = 5;  // the four Huffman quarters and the sequences
constexpr int kSeqRun = 4;
// the segments a chain is cut into, at most (chain_cut)
constexpr int kMaxSeg = 128;
// 227 KB, the most a block may opt into
constexpr int kSmemMax = 232448;
// clock stamps a lane: the start and the end of each of the 8 passes
// (kernel_bench.ASSEMBLE_PASSES)
constexpr int kStamps = 9;
enum { kLL = 0, kOF = 1, kML = 2 };

using u32 = uint32_t;
using u64 = unsigned long long;
using i64 = long long;

struct Stream {
  const int32_t* maps;   // [B, nsym, ts]
  const uint8_t* nbs;    // [B, nsym, ts]
  const int32_t* init;   // [B, nsym]
  const int32_t* flush;  // [B]
  int nsym, ts;
};

struct Params {
  const uint8_t* blocks;  // [B, N]
  const int32_t* n_valid;
  const int32_t* starts;  // [B, S]
  const int32_t* mls;
  const int32_t* offs;
  const int32_t* nseq;
  const uint8_t* lit_sorted;  // [B, N]
  const int32_t* lit_count;
  const int64_t* h_codes;  // [B, 256]
  const int64_t* h_nbits;  // [B, 256]
  const uint8_t* h_desc;   // [B, desc_max]
  const int32_t* h_dlen;
  const uint8_t* h_ok;
  Stream st[3];  // ll, of, ml
  const int32_t* mode;
  const uint8_t* tbl;  // [B, tbl_max]
  const int32_t* tbl_len;
  const int32_t* lut;  // ll_lut 64, ml_lut 128, ll_bits 36, ml_bits 53
  uint8_t* rows;       // [B, N + 16]
  int32_t* out_len;
  uint8_t* scratch;  // [B, scratch_stride] when the arrays are not shared
  i64 scratch_stride;
  // null, or int64 [B, kStamps]: the SM clock (clock64) of thread 0 at the
  // start and after each pass's barrier (kernel_bench.assemble_passes)
  long long* stamps;
  int N, S, W, WQ, desc_max, tbl_max;
  bool shared_row;
};

struct Layout {
  int tab[3], init[3], hcode, hnb, lut, scan, comp, entry, row, em, code,
      total;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// The row strides of the codes (u8) and of the emissions (u16): a
// stream's row starts 16-byte (8-byte) aligned, and a u32 load of four
// codes (a u64 of four emissions) never leaves its row.
__host__ __device__ inline int code_stride(int s) { return align16(s); }
__host__ __device__ inline int em_stride(int s) { return (s + 3) & ~3; }

// Device-memory scratch bytes a lane needs where its arrays are not in
// shared memory: the emissions (u16 [3, em_stride]), then the codes.
__host__ __device__ inline long long scratch_bytes(int s) {
  return align16(6 * em_stride(s)) + 3LL * code_stride(s);
}

// The shared-memory layout; the row and the sequence arrays only when
// `shared_row`.
__host__ __device__ inline Layout make_layout(const int* nsym, const int* ts,
                                              int n, int s,
                                              bool shared_row) {
  Layout l;
  int o = 0;
  for (int k = 0; k < 3; ++k) {
    l.tab[k] = o;
    o = align16(o + 2 * nsym[k] * ts[k]);
  }
  for (int k = 0; k < 3; ++k) {
    l.init[k] = o;
    o = align16(o + nsym[k]);
  }
  l.hcode = o;
  o += 1024;
  l.hnb = o;
  o += 1024;
  l.lut = o;
  o = align16(o + kLut);
  l.scan = o;  // kScan x 32 warp sums, then the three flush states
  o = align16(o + 4 * (kScan * 32 + 3));
  l.comp = o;  // [3, kMaxSeg, kMaxTS]: each segment's composed map
  o += 3 * kMaxSeg * kMaxTS;
  l.entry = o;  // [3, kMaxSeg]: the state entering each segment
  o = align16(o + 3 * kMaxSeg);
  l.row = l.em = l.code = -1;
  if (shared_row) {
    l.row = o;
    o = align16(o + n + 16);
    l.em = o;
    o = align16(o + 6 * em_stride(s));
    l.code = o;
    o = align16(o + 3 * code_stride(s));
  }
  l.total = o;
  return l;
}

__device__ __forceinline__ i64 clamp64(i64 v, i64 lo, i64 hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int highbit(int v) {
  return v < 1 ? 0 : 31 - __clz(v);
}

__device__ __forceinline__ void put_byte(uint8_t* row, int out, i64 pos,
                                         i64 v) {
  if (pos >= 0 && pos < out) row[pos] = static_cast<uint8_t>(v & 0xff);
}

// One packer field: `v` masked to `nb` bits at stream bit `pos` of a
// stream that starts at row bit `base`; a half whose stream word is at or
// past `wlim` is dropped (the packer's drop mode).  Neighbouring runs share
// words, so the bits are ORed in atomically.
__device__ __forceinline__ void put_field(u32* row, int row_words, i64 base,
                                          u32 pos, u32 v, u32 nb, u32 wlim) {
  v &= nb >= 32 ? kFull : (1u << nb) - 1u;
  const u32 widx = pos >> 5;
  if (v == 0 || widx >= wlim) return;
  u64 f = static_cast<u64>(v) << (pos & 31);
  if (widx + 1 >= wlim) f &= 0xffffffffull;
  const i64 r0 = base + 32 * static_cast<i64>(widx);
  const int r = static_cast<int>(r0 & 31);
  const i64 w0 = r0 >> 5;
  const u32 lo = static_cast<u32>(f), hi = static_cast<u32>(f >> 32);
  const u32 x0 = lo << r;
  const u32 x1 = r ? (lo >> (32 - r)) | (hi << r) : hi;
  const u32 x2 = r ? hi >> (32 - r) : 0u;
  if (x0 && w0 < row_words) atomicOr(row + w0, x0);
  if (x1 && w0 + 1 < row_words) atomicOr(row + w0 + 1, x1);
  if (x2 && w0 + 2 < row_words) atomicOr(row + w0 + 2, x2);
}

// Exclusive block scan of kScan u32 values a thread (wrapping, as the
// packer's u32 offsets); `total` gets each value's block-wide sum.
__device__ __forceinline__ void block_scan(const u32* v, u32* excl,
                                           u32* total, u32* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  u32 incl[kScan];
#pragma unroll
  for (int k = 0; k < kScan; ++k) {
    u32 x = v[k];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const u32 y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    incl[k] = x;
    if (lane == 31) sh[k * 32 + warp] = x;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < kScan; ++k) {
      u32 x = sh[k * 32 + lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const u32 y = __shfl_up_sync(kFull, x, d);
        if (lane >= d) x += y;
      }
      sh[k * 32 + lane] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kScan; ++k) {
    excl[k] = (warp ? sh[k * 32 + warp - 1] : 0u) + incl[k] - v[k];
    total[k] = sh[k * 32 + 31];
  }
  __syncthreads();
}

// (ll, mlv, ofb) of sequence i of a lane whose rows start at `off`.
__device__ __forceinline__ void seq_values(const Params& p, i64 off, int i,
                                           int& ll, int& mlv, int& ofb) {
  const int st = p.starts[off + i], ml = p.mls[off + i], of = p.offs[off + i];
  int prev_end = 0, prev_off = 0;
  if (i > 0) {
    prev_end = p.starts[off + i - 1] + p.mls[off + i - 1];
    prev_off = p.offs[off + i - 1];
  }
  ll = st - prev_end;
  mlv = ml - 3;
  ofb = (i > 0 && of == prev_off && ll > 0) ? 1 : of + 3;
}

// A barrier between phases.  Where the row and the sequence arrays live in
// device memory the bitstreams' atomics run in L2, so every phase's plain
// stores are fenced first, and the row is read back through L2 (row_byte,
// __ldcg).
__device__ __forceinline__ void phase_barrier(const Params& p) {
  if (!p.shared_row) __threadfence();
  __syncthreads();
}

__device__ __forceinline__ uint8_t row_byte(const Params& p,
                                            const uint8_t* rowb, i64 i) {
  return p.shared_row ? rowb[i] : __ldcg(rowb + i);
}

// The SM clock at point k of lane b's launch, when the caller asked.
__device__ __forceinline__ void stamp(const Params& p, int b, int k) {
  if (p.stamps != nullptr && threadIdx.x == 0)
    p.stamps[static_cast<i64>(b) * kStamps + k] = clock64();
}

// The chain's n steps (i = n - 1 ... 0, n = ns - 1) cut into segments:
// G of them (32 up to 4,096 steps, 64 up to 16,384, kMaxSeg beyond) of
// `len` steps each, a multiple of 4 (0 when n is 0); segment j takes the
// steps [j len, min((j + 1) len, n)), and `used` segments hold any.
__device__ __forceinline__ void chain_cut(int n, int& len, int& used) {
  const int g = n <= 4096 ? 32 : (n <= 16384 ? 64 : kMaxSeg);
  len = ((n + g - 1) / g + 3) & ~3;
  used = len ? (n + len - 1) / len : 0;
}

// Entries i .. i + 3 of a stream's u16 row (i a multiple of 4), bits
// 16 s of the word being entry i + s.
__device__ __forceinline__ u64 row_word(const uint16_t* r, int i) {
  return *reinterpret_cast<const u64*>(r + i);
}

template <typename T>
__device__ __forceinline__ T pick(int k, T a, T b, T c) {
  return k == 0 ? a : (k == 1 ? b : c);
}

// The runs of one stream of n fields: thread t takes [t k, t k + k).
__device__ __forceinline__ void run_of(int n, int& a, int& e) {
  const int k = (n + kThreads - 1) / kThreads;
  a = min(static_cast<int>(threadIdx.x) * k, n);
  e = min(a + k, n);
}

__global__ void __launch_bounds__(kThreads, 1) assemble_kernel(Params p) {
  extern __shared__ __align__(16) uint8_t sm[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int N = p.N, S = p.S, OUT = N + 16, row_words = OUT / 4;
  const int nsym[3] = {p.st[0].nsym, p.st[1].nsym, p.st[2].nsym};
  const int ts[3] = {p.st[0].ts, p.st[1].ts, p.st[2].ts};
  const Layout l = make_layout(nsym, ts, N, S, p.shared_row);
  uint8_t* nxt[3];  // [nsym, ts]: the next state
  uint8_t* nbt[3];  // [nsym, ts]: the state's width
  uint8_t* init[3];
  for (int k = 0; k < 3; ++k) {
    nxt[k] = sm + l.tab[k];
    nbt[k] = nxt[k] + nsym[k] * ts[k];
    init[k] = sm + l.init[k];
  }
  u32* hcode = reinterpret_cast<u32*>(sm + l.hcode);
  u32* hnb = reinterpret_cast<u32*>(sm + l.hnb);
  uint8_t* lut = sm + l.lut;
  const uint8_t* ll_lut = lut;
  const uint8_t* ml_lut = lut + kLutLL;
  const uint8_t* ll_bits = lut + kLutLL + kLutML;
  const uint8_t* ml_bits = ll_bits + kBitsLL;
  u32* scan = reinterpret_cast<u32*>(sm + l.scan);
  u32* flush_state = scan + kScan * 32;
  uint8_t* comp = sm + l.comp;
  uint8_t* entry = sm + l.entry;
  const int Sc = code_stride(S), Se = em_stride(S);
  uint8_t* grow = p.rows + static_cast<i64>(b) * OUT;
  u32* row;
  // [3, Se]: the codes' table rows (min(c, nsym - 1) ts) until the chains
  // pass, then its emissions (nb << 8 | the incoming state)
  uint16_t* em;
  uint8_t* code;  // [3, Sc]
  if (p.shared_row) {
    row = reinterpret_cast<u32*>(sm + l.row);
    em = reinterpret_cast<uint16_t*>(sm + l.em);
    code = sm + l.code;
  } else {
    row = reinterpret_cast<u32*>(grow);
    uint8_t* sc = p.scratch + b * p.scratch_stride;
    em = reinterpret_cast<uint16_t*>(sc);
    code = sc + align16(6 * Se);
  }
  uint8_t* rowb = reinterpret_cast<uint8_t*>(row);
  const i64 seq_off = static_cast<i64>(b) * S;
  const uint8_t* lit = p.lit_sorted + static_cast<i64>(b) * N;

  const int nv = p.n_valid[b];
  const int ns_raw = p.nseq[b];
  const int ns = min(max(ns_raw, 0), S);
  const int lc = p.lit_count[b];
  const int dlen = p.h_dlen[b];
  const int tl = p.tbl_len[b];
  const bool hok = p.h_ok[b] != 0;
  const bool huf_sizes = hok && ns_raw > 0;  // else use_huf is false
  stamp(p, b, 0);

  // ---- the lane's tables into shared memory; the row cleared ----
  for (int k = 0; k < 3; ++k) {
    const Stream& s = p.st[k];
    const int n = s.nsym * s.ts;
    const i64 g0 = static_cast<i64>(b) * n;
    for (int j = tid; j < n; j += kThreads) {
      const int nx = min(max(s.maps[g0 + j], 0), s.ts - 1);
      nxt[k][j] = static_cast<uint8_t>(nx);
      nbt[k][j] = s.nbs[g0 + j];
    }
    for (int j = tid; j < s.nsym; j += kThreads)
      init[k][j] = static_cast<uint8_t>(
          min(max(s.init[static_cast<i64>(b) * s.nsym + j], 0), s.ts - 1));
  }
  for (int j = tid; j < 256; j += kThreads) {
    hcode[j] = static_cast<u32>(p.h_codes[static_cast<i64>(b) * 256 + j]);
    hnb[j] = static_cast<u32>(p.h_nbits[static_cast<i64>(b) * 256 + j]);
  }
  for (int j = tid; j < kLut; j += kThreads)
    lut[j] = static_cast<uint8_t>(p.lut[j]);
  for (int j = tid; j < OUT / 16; j += kThreads)
    reinterpret_cast<uint4*>(row)[j] = make_uint4(0, 0, 0, 0);
  phase_barrier(p);
  stamp(p, b, 1);

  // ---- values and codes, a thread a sequence; each code's table row ----
  for (int i = tid; i < ns; i += kThreads) {
    int ll, mlv, ofb;
    seq_values(p, seq_off, i, ll, mlv, ofb);
    const int llc = ll > 63 ? highbit(ll) + 19 : ll_lut[min(max(ll, 0), 63)];
    const int mlc =
        mlv > 127 ? highbit(mlv) + 36 : ml_lut[min(max(mlv, 0), 127)];
    const int c[3] = {llc & 0xff, highbit(ofb), mlc & 0xff};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      code[k * Sc + i] = static_cast<uint8_t>(c[k]);
      em[k * Se + i] = static_cast<uint16_t>(min(c[k], nsym[k] - 1) * ts[k]);
    }
  }
  phase_barrier(p);
  stamp(p, b, 2);

  // ---- the three state chains by segment map composition ----
  const int n_steps = max(ns - 1, 0);
  int L, used;
  chain_cut(n_steps, L, used);
  // (a) compose: warp w takes segments w, w + 32, ... of all three streams;
  // lane x follows the entry states x and x + 32 through the segment, one
  // conflict-free gather a state and step at its code's table row (the
  // rows of four steps a u64 word): the segment's top steps down to a
  // multiple of 4, then four steps a word with no branch, a word ahead
  for (int j = warp; j < used; j += kThreads / 32) {
    const int lo = j * L, hi = min(lo + L, n_steps);
    u32 y[3][2];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      y[k][0] = lane < ts[k] ? lane : 0u;
      y[k][1] = lane + 32 < ts[k] ? lane + 32u : 0u;
    }
    int g = (hi - 1) & ~3;
    u64 r[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) r[k] = row_word(em + k * Se, g);
    for (int q = hi - 1 - g; q >= 0; --q) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const uint8_t* t = nxt[k] + ((r[k] >> (16 * q)) & 0xffffu);
        y[k][0] = t[y[k][0]];
        if (ts[k] > 32) y[k][1] = t[y[k][1]];
      }
    }
    g -= 4;
    if (g >= lo) {
#pragma unroll
      for (int k = 0; k < 3; ++k) r[k] = row_word(em + k * Se, g);
    }
    for (; g >= lo; g -= 4) {
      u64 nx[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        nx[k] = g - 4 >= lo ? row_word(em + k * Se, g - 4) : 0ull;
#pragma unroll
      for (int q = 3; q >= 0; --q) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const uint8_t* t = nxt[k] + ((r[k] >> (16 * q)) & 0xffffu);
          y[k][0] = t[y[k][0]];
          if (ts[k] > 32) y[k][1] = t[y[k][1]];
        }
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) r[k] = nx[k];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      uint8_t* cm = comp + (k * kMaxSeg + j) * kMaxTS;
      if (lane < ts[k]) cm[lane] = static_cast<uint8_t>(y[k][0]);
      if (lane + 32 < ts[k]) cm[lane + 32] = static_cast<uint8_t>(y[k][1]);
    }
  }
  __syncthreads();

  // (b) cross: a thread a stream follows the composites from the initial
  // state, the last segment first; what leaves segment 0 is the flush
  if (lane == 0 && warp < 3) {
    const int k = warp;
    u32 u = 0;
    if (ns >= 1) {
      u = init[k][min(static_cast<int>(code[k * Sc + ns - 1]), nsym[k] - 1)];
      for (int j = used - 1; j >= 0; --j) {
        entry[k * kMaxSeg + j] = static_cast<uint8_t>(u);
        u = comp[(k * kMaxSeg + j) * kMaxTS + u];
      }
    }
    flush_state[k] = u;
  }
  __syncthreads();

  // (c) walk: a thread a segment walks its steps from its entry state and
  // puts the emissions (nb << 8 | the incoming state) over the rows it
  // read, four steps a u64 store (past the chain's last step, zeros)
  if (tid < 3 * used) {
    const int k = tid / used, j = tid - k * used;
    const int lo = j * L, hi = min(lo + L, n_steps);
    const uint8_t* nx_k = pick(k, nxt[0], nxt[1], nxt[2]);
    const uint8_t* nb_k = pick(k, nbt[0], nbt[1], nbt[2]);
    uint16_t* ek = em + k * Se;
    u32 u = entry[k * kMaxSeg + j];
    int g = (hi - 1) & ~3;
    u64 r = row_word(ek, g), out = 0;
    for (int q = hi - 1 - g; q >= 0; --q) {
      const int at = static_cast<int>((r >> (16 * q)) & 0xffffu) + u;
      out |= static_cast<u64>((nb_k[at] << 8) | u) << (16 * q);
      u = nx_k[at];
    }
    *reinterpret_cast<u64*>(ek + g) = out;
    g -= 4;
    r = g >= lo ? row_word(ek, g) : 0ull;
    for (; g >= lo; g -= 4) {
      const u64 nx = g - 4 >= lo ? row_word(ek, g - 4) : 0ull;
      out = 0;
#pragma unroll
      for (int q = 3; q >= 0; --q) {
        const int at = static_cast<int>((r >> (16 * q)) & 0xffffu) + u;
        out |= static_cast<u64>((nb_k[at] << 8) | u) << (16 * q);
        u = nx_k[at];
      }
      *reinterpret_cast<u64*>(ek + g) = out;
      r = nx;
    }
  }

  // ---- the Huffman quarters' widths, a run of symbols a thread ----
  const int seg = max((lc + 3) >> 2, 1);
  const int segmax = N / 4 + 1;
  int q_len[4];
  u32 part[kScan] = {0, 0, 0, 0, 0};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const i64 seglen = q < 3 ? seg : static_cast<i64>(lc) - 3 * seg;
    q_len[q] = static_cast<int>(clamp64(seglen, 0, segmax));
    if (!huf_sizes) continue;
    const i64 top = static_cast<i64>(q) * seg + seglen - 1;
    int a, e;
    run_of(q_len[q], a, e);
    for (int tq = a; tq < e; ++tq) {
      const i64 pos = clamp64(top - tq, 0, N - 1);
      part[q] += hnb[lit[pos]];
    }
  }
  phase_barrier(p);
  stamp(p, b, 3);

  // ---- the sequences' widths, a run of sequences a thread ----
  const uint8_t* c_ll = code + kLL * Sc;
  const uint8_t* c_of = code + kOF * Sc;
  const uint8_t* c_ml = code + kML * Sc;
  const uint16_t* e_ll = em + kLL * Se;
  const uint16_t* e_of = em + kOF * Se;
  const uint16_t* e_ml = em + kML * Se;
  int sa, se;
  run_of(ns, sa, se);
  for (int e = sa; e < se; ++e) {
    const int i = ns - 1 - e;
    u32 w = ll_bits[min(static_cast<int>(c_ll[i]), kBitsLL - 1)] +
            ml_bits[min(static_cast<int>(c_ml[i]), kBitsML - 1)] + c_of[i];
    if (i <= ns - 2) w += (e_of[i] >> 8) + (e_ml[i] >> 8) + (e_ll[i] >> 8);
    part[kSeqRun] += w;
  }
  u32 excl[kScan], total[kScan];
  block_scan(part, excl, total, scan);
  stamp(p, b, 4);

  // ---- sizes, before any byte is written ----
  u32 fl[3];
  for (int k = 0; k < 3; ++k)
    fl[k] = ns_raw > 0 ? static_cast<u32>(p.st[k].flush[b]) : 0u;
  const u32 seq_bits = total[kSeqRun] + fl[kML] + fl[kOF] + fl[kLL] + 1u;
  const i64 bits_len = (static_cast<i64>(seq_bits) + 7) >> 3;
  u32 htot[4];
  i64 sl[4], comp_lit = static_cast<i64>(dlen) + 6;
  for (int q = 0; q < 4; ++q) {
    htot[q] = total[q] + 1u;
    sl[q] = (static_cast<i64>(htot[q]) + 7) >> 3;
    comp_lit += sl[q];
  }
  const bool use_huf = hok && 5 + comp_lit < 3 + static_cast<i64>(lc) &&
                       ns_raw > 0;
  const i64 lit_sec = use_huf ? 5 + comp_lit : 3 + static_cast<i64>(lc);
  const i64 body = lit_sec + 3 + tl + bits_len;
  const i64 comp_total = 12 + body, raw_total = 12 + static_cast<i64>(nv);
  const bool use_raw = ns_raw == 0 || comp_total >= raw_total;
  const i64 out_len = use_raw ? raw_total : comp_total;
  const i64 seq_at = 12 + lit_sec + 3 + tl;  // the sequence bitstream
  const i64 s0_at = 12 + 5 + static_cast<i64>(dlen) + 6;  // stream 0

  // ---- the fixed-form bytes ----
  if (tid == 0) {
    const int magic[5] = {0x28, 0xB5, 0x2F, 0xFD, 0xA0};
    for (int j = 0; j < 5; ++j) put_byte(rowb, OUT, j, magic[j]);
    for (int j = 0; j < 4; ++j)
      put_byte(rowb, OUT, 5 + j, static_cast<u32>(nv) >> (8 * j));
    const i64 bh = 1 | ((use_raw ? 0 : 2) << 1) |
                   ((use_raw ? static_cast<i64>(nv) : body) << 3);
    for (int j = 0; j < 3; ++j) put_byte(rowb, OUT, 9 + j, bh >> (8 * j));
    if (!use_raw) {
      if (use_huf) {
        const i64 lu = static_cast<u32>(lc), cu = comp_lit & 0xffffffffll;
        put_byte(rowb, OUT, 12, (2 | (3 << 2)) | ((lu & 0xf) << 4));
        put_byte(rowb, OUT, 13, lu >> 4);
        put_byte(rowb, OUT, 14, ((lu >> 12) & 0x3f) | ((cu & 3) << 6));
        put_byte(rowb, OUT, 15, cu >> 2);
        put_byte(rowb, OUT, 16, cu >> 10);
        for (int q = 0; q < 3; ++q) {
          put_byte(rowb, OUT, s0_at - 6 + 2 * q, sl[q]);
          put_byte(rowb, OUT, s0_at - 5 + 2 * q, sl[q] >> 8);
        }
      } else {
        const i64 lh = (3 << 2) | (static_cast<i64>(lc) << 4);
        for (int j = 0; j < 3; ++j) put_byte(rowb, OUT, 12 + j, lh >> (8 * j));
      }
      put_byte(rowb, OUT, 12 + lit_sec, 128 + (ns_raw >> 8));
      put_byte(rowb, OUT, 13 + lit_sec, ns_raw);
      put_byte(rowb, OUT, 14 + lit_sec, p.mode[b]);
    }
    p.out_len[b] = static_cast<int32_t>(out_len);
  }
  if (use_raw) {
    // the record: row word 3 + k is the block's word k
    const u32* src = reinterpret_cast<const u32*>(p.blocks +
                                                  static_cast<i64>(b) * N);
    const int words = (min(max(nv, 0), N) + 3) / 4;
    for (int k = tid; k < words; k += kThreads) row[3 + k] = src[k];
  } else {
    if (use_huf) {
      const uint8_t* d = p.h_desc + static_cast<i64>(b) * p.desc_max;
      for (int k = tid; k < dlen; k += kThreads)
        put_byte(rowb, OUT, 17 + k, d[min(k, p.desc_max - 1)]);
    } else {
      for (int k = tid; k < lc; k += kThreads)
        put_byte(rowb, OUT, 15 + static_cast<i64>(k), lit[min(k, N - 1)]);
    }
    const uint8_t* t = p.tbl + static_cast<i64>(b) * p.tbl_max;
    for (int k = tid; k < tl; k += kThreads)
      put_byte(rowb, OUT, 15 + lit_sec + k, t[min(k, p.tbl_max - 1)]);
  }
  phase_barrier(p);
  stamp(p, b, 5);

  // ---- the bitstreams, each field at its final bit offset ----
  if (!use_raw) {
    const i64 base = 8 * seq_at;
    const u32 W = static_cast<u32>(p.W);
    u32 pos = excl[kSeqRun];
    const u32 ts_ll = ts[kLL], ts_of = ts[kOF], ts_ml = ts[kML];
    for (int e = sa; e < se; ++e) {
      const int i = ns - 1 - e;
      int ll, mlv, ofb;
      seq_values(p, seq_off, i, ll, mlv, ofb);
      if (i <= ns - 2) {
        const u32 so = e_of[i], sml = e_ml[i], sll = e_ll[i];
        put_field(row, row_words, base, pos, ts_of + (so & 0xff), so >> 8,
                  W);
        pos += so >> 8;
        put_field(row, row_words, base, pos, ts_ml + (sml & 0xff), sml >> 8,
                  W);
        pos += sml >> 8;
        put_field(row, row_words, base, pos, ts_ll + (sll & 0xff), sll >> 8,
                  W);
        pos += sll >> 8;
      }
      const u32 wll = ll_bits[min(static_cast<int>(c_ll[i]), kBitsLL - 1)];
      const u32 wml = ml_bits[min(static_cast<int>(c_ml[i]), kBitsML - 1)];
      const u32 wof = c_of[i];
      put_field(row, row_words, base, pos, static_cast<u32>(ll), wll, W);
      pos += wll;
      put_field(row, row_words, base, pos, static_cast<u32>(mlv), wml, W);
      pos += wml;
      put_field(row, row_words, base, pos, static_cast<u32>(ofb), wof, W);
      pos += wof;
    }
    if (tid == 0) {
      u32 at = total[kSeqRun];
      const int order[3] = {kML, kOF, kLL};
      for (int j = 0; j < 3; ++j) {
        const int k = order[j];
        put_field(row, row_words, base, at, flush_state[k], fl[k], W);
        at += fl[k];
      }
      put_field(row, row_words, base, seq_bits - 1u, 1u, 1u, W);
    }
    if (use_huf) {
      const u32 WQ = static_cast<u32>(p.WQ);
      i64 at = s0_at;
      for (int q = 0; q < 4; ++q) {
        const i64 qbase = 8 * at;
        const i64 seglen = q < 3 ? seg : static_cast<i64>(lc) - 3 * seg;
        const i64 top = static_cast<i64>(q) * seg + seglen - 1;
        int a, e;
        run_of(q_len[q], a, e);
        u32 hp = excl[q];
        for (int tq = a; tq < e; ++tq) {
          const i64 sp = clamp64(top - tq, 0, N - 1);
          const int sym = lit[sp];
          put_field(row, row_words, qbase, hp, hcode[sym], hnb[sym], WQ);
          hp += hnb[sym];
        }
        if (tid == 0)
          put_field(row, row_words, qbase, htot[q] - 1u, 1u, 1u, WQ);
        at += sl[q];
      }
    }
  }
  phase_barrier(p);
  stamp(p, b, 6);

  // ---- a stream cut at its capacity repeats its last kept byte ----
  if (!use_raw) {
    const i64 cap = 4 * static_cast<i64>(p.W);
    if (bits_len > cap) {
      const uint8_t last =
          row_byte(p, rowb, clamp64(seq_at + cap - 1, 0, OUT - 1));
      for (i64 k = cap + tid; k < bits_len; k += kThreads)
        put_byte(rowb, OUT, seq_at + k, last);
    }
    if (use_huf) {
      const i64 qcap = 4 * static_cast<i64>(p.WQ);
      i64 at = s0_at;
      for (int q = 0; q < 4; ++q) {
        if (sl[q] > qcap) {
          const uint8_t last =
              row_byte(p, rowb, clamp64(at + qcap - 1, 0, OUT - 1));
          for (i64 k = qcap + tid; k < sl[q]; k += kThreads)
            put_byte(rowb, OUT, at + k, last);
        }
        at += sl[q];
      }
    }
  }
  phase_barrier(p);
  stamp(p, b, 7);

  // ---- the row out, every byte at or past out_len zero ----
  const i64 keep = clamp64(out_len, 0, OUT);
  const int first = p.shared_row ? 0 : static_cast<int>(keep / 16);
  for (int c = first + tid; c < OUT / 16; c += kThreads) {
    uint4 v = p.shared_row ? reinterpret_cast<const uint4*>(row)[c]
                           : __ldcg(reinterpret_cast<const uint4*>(row) + c);
    u32* x = reinterpret_cast<u32*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const i64 o = 16 * static_cast<i64>(c) + 4 * j;
      if (o >= keep)
        x[j] = 0;
      else if (o + 4 > keep)
        x[j] &= (1u << (8 * (keep - o))) - 1u;
    }
    reinterpret_cast<uint4*>(grow)[c] = v;
  }
  if (p.stamps != nullptr) {
    __syncthreads();
    stamp(p, b, 8);
  }
}

bool shared_fits(const int* nsym, const int* ts, int n, int s) {
  return make_layout(nsym, ts, n, s, true).total <= kSmemMax;
}

}  // namespace

// Scratch bytes a lane needs in device memory: 0 where its row and
// sequence arrays fit in shared memory, else the arrays' (scratch_bytes).
extern "C" long long zt_assemble_scratch(int n, int s, int nsym_ll,
                                         int ts_ll, int nsym_of, int ts_of,
                                         int nsym_ml, int ts_ml) {
  const int nsym[3] = {nsym_ll, nsym_of, nsym_ml};
  const int ts[3] = {ts_ll, ts_of, ts_ml};
  if (shared_fits(nsym, ts, n, s)) return 0;
  return scratch_bytes(s);
}

// Assemble every lane of a chunk (the operands as ops/assemble.py
// assemble_lanes passes them); scratch as zt_assemble_scratch sizes it,
// null when that is 0.  stamps: null, or int64 [b, kStamps] for the SM
// clock at the start and after each pass.  Returns a cudaError_t.
extern "C" int zt_assemble(
    const void* blocks, const void* n_valid, const void* starts,
    const void* mls, const void* offs, const void* nseq,
    const void* lit_sorted, const void* lit_count, const void* h_codes,
    const void* h_nbits, const void* h_desc, const void* h_dlen,
    const void* h_ok, const void* ll_maps, const void* ll_nbs,
    const void* ll_init, const void* ll_flush, const void* of_maps,
    const void* of_nbs, const void* of_init, const void* of_flush,
    const void* ml_maps, const void* ml_nbs, const void* ml_init,
    const void* ml_flush, const void* mode, const void* tbl,
    const void* tbl_len, const void* lut, void* rows, void* out_len,
    void* scratch, int b, int n, int s, int w, int wq, int desc_max,
    int tbl_max, int nsym_ll, int ts_ll, int nsym_of, int ts_of,
    int nsym_ml, int ts_ml, void* stamps, void* stream) {
  if (b <= 0) return 0;
  const int nsym[3] = {nsym_ll, nsym_of, nsym_ml};
  const int ts[3] = {ts_ll, ts_of, ts_ml};
  for (int k = 0; k < 3; ++k)
    if (nsym[k] < 1 || nsym[k] > kMaxNsym || ts[k] < 1 || ts[k] > kMaxTS)
      return static_cast<int>(cudaErrorInvalidValue);
  if (n < 16 || n > kMaxN || n % 16 || s < 1 || w < 1 || wq < 1 ||
      desc_max < 1 || tbl_max < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.blocks = static_cast<const uint8_t*>(blocks);
  p.n_valid = static_cast<const int32_t*>(n_valid);
  p.starts = static_cast<const int32_t*>(starts);
  p.mls = static_cast<const int32_t*>(mls);
  p.offs = static_cast<const int32_t*>(offs);
  p.nseq = static_cast<const int32_t*>(nseq);
  p.lit_sorted = static_cast<const uint8_t*>(lit_sorted);
  p.lit_count = static_cast<const int32_t*>(lit_count);
  p.h_codes = static_cast<const int64_t*>(h_codes);
  p.h_nbits = static_cast<const int64_t*>(h_nbits);
  p.h_desc = static_cast<const uint8_t*>(h_desc);
  p.h_dlen = static_cast<const int32_t*>(h_dlen);
  p.h_ok = static_cast<const uint8_t*>(h_ok);
  const void* tabs[3][4] = {{ll_maps, ll_nbs, ll_init, ll_flush},
                            {of_maps, of_nbs, of_init, of_flush},
                            {ml_maps, ml_nbs, ml_init, ml_flush}};
  for (int k = 0; k < 3; ++k) {
    p.st[k].maps = static_cast<const int32_t*>(tabs[k][0]);
    p.st[k].nbs = static_cast<const uint8_t*>(tabs[k][1]);
    p.st[k].init = static_cast<const int32_t*>(tabs[k][2]);
    p.st[k].flush = static_cast<const int32_t*>(tabs[k][3]);
    p.st[k].nsym = nsym[k];
    p.st[k].ts = ts[k];
  }
  p.mode = static_cast<const int32_t*>(mode);
  p.tbl = static_cast<const uint8_t*>(tbl);
  p.tbl_len = static_cast<const int32_t*>(tbl_len);
  p.lut = static_cast<const int32_t*>(lut);
  p.rows = static_cast<uint8_t*>(rows);
  p.out_len = static_cast<int32_t*>(out_len);
  p.scratch = static_cast<uint8_t*>(scratch);
  p.stamps = static_cast<long long*>(stamps);
  p.N = n;
  p.S = s;
  p.W = w;
  p.WQ = wq;
  p.desc_max = desc_max;
  p.tbl_max = tbl_max;
  p.shared_row = shared_fits(nsym, ts, n, s);
  if (!p.shared_row) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    p.scratch_stride = scratch_bytes(s);
  }
  const int dyn = make_layout(nsym, ts, n, s, p.shared_row).total;
  const auto st = static_cast<cudaStream_t>(stream);
  // the default 48 KB limit: opt in every time
  cudaError_t err = cudaFuncSetAttribute(
      assemble_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  assemble_kernel<<<b, kThreads, dyn, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
