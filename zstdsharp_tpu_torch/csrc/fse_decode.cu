// Batched zstd sequence-section decode (three interleaved FSE states plus
// the repcode history), designed for Hopper.
//
// Replaces the Pallas kernel zstdsharp_tpu/ops/device_fse.py:_decode_fn
// (:292, its pallas_call at :472).  Per sequence it computes what
// ops/device_fse.py:decode_plain computes:
//   1. look up the LL, OF and ML entries (sym | ns << 8 | nb << 20) with
//      each state clipped to its table;
//   2. clip the codes to 35, 31 and 52;
//   3. LL/ML value bases and extra-bit counts by code; the OF base is
//      (1 << c) - 3 for c > 1, else c;
//   4. read the OF, ML and LL extra bits, in that order;
//   5. resolve the repcode with the collapsed rule (push / dec / rotate /
//      swap / keep) in 64 bits; the emitted offset is the new r0's low
//      32 bits;
//   6. update the LL, ML and OF states, in that order.
// A lane stops after its nseq sequences and its rows are zero past them.
// Stream words outside [0, wb) read as zero, bits below bit 0 read as zero
// and pos may go negative, as in the plain version; every table index is
// clipped, so operands planned from a corrupt frame give wrong values,
// never an illegal address.
//
// What bounds it on the H100.  Roofline: the bytes the call must move are
// each live lane's tables (5,120 B) and live words (ceil(pos/32) words),
// st and nseq, and the three [NL, T] int32 outputs; at the main path's
// window [256 lanes, Wb 1024, T 4096] that is about 14 MB, about 4.4 us
// at 3.35 TB/s, nearly all of it the zero tails of the outputs.  Serial
// floor: within a lane every sequence depends on the one before through
// the chain state -> table entry -> bit count -> bit position -> next
// state, so a lane takes at least nseq x (that chain's latency); the
// longest lane of that window has 1885 sequences.  The serial floor is
// the larger bound by an order of magnitude, so the design keeps that
// chain as short as the card allows and takes everything else off it:
//
// * Few lanes per block, spread over the SMs.  A block takes G lanes,
//   G = ceil(NL / SMs) clipped to [1, 16] and lowered until the block's
//   shared memory fits 227 KB (every bucket up to MAX_W = 8192 words fits
//   at G = 5 or more, up to 2048 words at G = 15); 256 lanes become 128
//   blocks of 2 lanes.  No lane takes another code path for its size.
// * The lane's working set in shared memory.  The block copies its lanes'
//   three tables and live stream words into dynamic shared memory with
//   cp.async (every copy in flight at once), then rewrites each table
//   entry in place as code | extra bits << 6 | state bits << 11 | next
//   state << 16, so the extra-bit count needs no second lookup by code.
// * A register bit container.  At each sequence the lane thread reloads
//   a 64-bit window holding the stream bits [pos - 64, pos) from shared
//   memory (three word loads and two funnel shifts, issued beside the
//   three table loads, as zstd's BIT_reloadDStream once per sequence).
//   The six widths come from the three entries, so where they sum to 64
//   bits or less (every valid table's usual case) the six reads are
//   independent shifts and masks of the window, not a chain; a sequence
//   that needs more reloads as it runs out.  pos is 32-bit, held at -256
//   or more, and the word rows carry zero pads, so a reload needs no
//   bounds test per word.
// * Only the chain on the serial warp.  A warp issues in order, so every
//   instruction in the lane thread's loop costs time on the chain.  Warp
//   0 (a thread per lane) runs the FSE states and the bit reads and hands
//   each 32 sequences' raw fields to warp 1 through a 4-chunk ring in
//   shared memory; warp 1 resolves the repcodes, adds the value bases,
//   and writes each lane's 32 values per array as one coalesced 128-byte
//   store.  Warps 2-3 zero-fill every row's tail [n, T) with 16-byte
//   stores meanwhile, so the zero tails (most of the bytes) cost the
//   chain nothing.
//
// Measured on an H100 (PERF.md, kernel_bench.py): about 145 ns per
// sequence on the longest lane, and the call takes that lane's time.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // warp 0 decodes, warp 1 emits, 2-3 zero-fill
constexpr int kMaxLanes = 16;  // lanes per block, one thread of a warp each
constexpr int kChunk = 32;     // sequences per hand-over and coalesced flush
constexpr int kRing = 4;       // chunks in flight between warps 0 and 1
constexpr int kPad = 4;        // zero words before and after a lane's words
constexpr int kStatesLLML = 512;
constexpr int kStatesOF = 256;
constexpr int kTabWords = 2 * kStatesLLML + kStatesOF;  // LL | OF | ML
constexpr int kMaxLLCode = 35;
constexpr int kMaxOFCode = 31;
constexpr int kMaxMLCode = 52;
// 227 KB, the most a block may opt into, less this kernel's static shared
// memory (the value tables and lane counts, under 1 KB)
constexpr int kSmemMax = 232448 - 1024;

__constant__ int32_t kLLBase[kMaxLLCode + 1] = {
    0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
    12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
__constant__ int32_t kLLBits[kMaxLLCode + 1] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  0,  1,  1,
    1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
__constant__ int32_t kMLBase[kMaxMLCode + 1] = {
    3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,   14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24,  25,  26,  27,   28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41,  43,  47,  51,   59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
__constant__ int32_t kMLBits[kMaxMLCode + 1] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
    2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// Row pitch of the hand-over ring and the output staging buffer: odd,
// so the flush's column reads (stride pitch words) hit 32 banks.
__host__ __device__ constexpr int stage_pitch(int g) { return g | 1; }

// A lane's padded word row: kPad zeros, its words, kPad zeros.
__host__ __device__ constexpr int word_pitch(int wb) { return wb + 2 * kPad; }

// tables and word rows, the hand-over ring, the output staging buffer
__host__ __device__ constexpr int64_t smem_bytes(int g, int wb) {
  return 4 * (static_cast<int64_t>(g) * (kTabWords + word_pitch(wb)) +
              (kRing + 1) * 3 * kChunk * stage_pitch(g));
}

// The backward bitstream of one lane: a 64-bit window hi:lo whose bit i
// is stream bit (pos - avail + i), i < avail, reloaded from the lane's
// padded word row in shared memory: kPad zero words, the words that hold
// bits [0, pos0) (nw of them), kPad zero words.  A word below 0 or at or
// past nw reads as zero (those past nw hold no bit the lane reads, or lie
// past wb); clamping the first word's index into [-kPad, nw] keeps every
// load inside the row and reads the same zeros.  Every bit below 0 is
// zero, so pos is kept at -256 or more, which fits 32 bits.
struct BitWindow {
  const uint32_t* w;  // word 0 of the padded row
  int nw;
  int pos;
  uint32_t lo, hi;
  int avail;

  static constexpr int kFloor = -256;

  __device__ __forceinline__ void reload() {
    const int first = pos - 64;
    const int k = min(max(first >> 5, -kPad), nw);  // >> is arithmetic
    const int s = first & 31;
    const uint32_t w0 = w[k], w1 = w[k + 1], w2 = w[k + 2];
    lo = __funnelshift_r(w0, w1, s);
    hi = __funnelshift_r(w1, w2, s);
    avail = 64;
  }

  // The nb (0..31) bits of the window from bit b (b + nb <= 64) up.
  __device__ __forceinline__ uint32_t field(int b, int nb) const {
    const uint32_t v =
        b < 32 ? __funnelshift_r(lo, hi, b) : __funnelshift_rc(hi, 0u, b - 32);
    return v & ((1u << nb) - 1u);
  }

  // The nb (0..31) bits ending at pos; pos moves down by nb.
  __device__ __forceinline__ uint32_t take(int nb) {
    if (nb > avail) reload();
    avail -= nb;
    pos -= nb;
    return field(avail, nb);
  }
};

__device__ __forceinline__ int clip_state(int64_t s, int n) {
  return s < 0 ? 0 : (s >= n ? n - 1 : static_cast<int>(s));
}

__global__ void __launch_bounds__(kThreads) fse_decode_kernel(
    const uint32_t* __restrict__ words, int wb,
    const int32_t* __restrict__ ll_tab, const int32_t* __restrict__ of_tab,
    const int32_t* __restrict__ ml_tab, const int32_t* __restrict__ st,
    const int32_t* __restrict__ nseq, int32_t* __restrict__ out_ll,
    int32_t* __restrict__ out_ml, int32_t* __restrict__ out_of, int nl,
    int t_len, int g_lanes) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int wp = word_pitch(wb), pitch = stage_pitch(g_lanes);
  uint32_t* s_tab = smem;                                 // [G][1280]
  uint32_t* s_words = smem + g_lanes * kTabWords;         // [G][wp]
  uint32_t* s_ring = s_words + g_lanes * wp;              // [R][3][32][P]
  int32_t* s_out = reinterpret_cast<int32_t*>(s_ring + kRing * 3 * kChunk *
                                              pitch);     // [3][32][P]
  __shared__ int32_t s_llb[kMaxLLCode + 1], s_llx[kMaxLLCode + 1];
  __shared__ int32_t s_mlb[kMaxMLCode + 1], s_mlx[kMaxMLCode + 1];
  __shared__ int s_n[kMaxLanes], s_nw[kMaxLanes], s_nmax;
  __shared__ int s_made, s_used;  // chunks handed over by warp 0 / taken

  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * g_lanes;
  const int G = min(g_lanes, nl - lane0);  // this block's real lanes

  // ---- per-lane counts, value tables ----
  for (int i = tid; i <= kMaxMLCode; i += kThreads) {
    if (i <= kMaxLLCode) {
      s_llb[i] = kLLBase[i];
      s_llx[i] = kLLBits[i];
    }
    s_mlb[i] = kMLBase[i];
    s_mlx[i] = kMLBits[i];
  }
  if (tid < kMaxLanes) {
    int n = 0, nw = 0;
    if (tid < G) {
      const int lane = lane0 + tid;
      n = min(max(nseq[lane], 0), t_len);
      const int64_t pos = st[static_cast<int64_t>(lane) * 8];
      // the words holding bits [0, pos): the only ones a read can reach
      const int64_t k = (pos + 31) >> 5;
      nw = n ? static_cast<int>(k < 0 ? 0 : (k > wb ? wb : k)) : 0;
    }
    s_n[tid] = n;
    s_nw[tid] = nw;
  }
  if (tid == 0) s_made = s_used = 0;
  __syncthreads();
  if (tid == 0) {
    int m = 0;
    for (int g = 0; g < G; g++) m = max(m, s_n[g]);
    s_nmax = m;
  }

  // ---- stage the live lanes' tables and words (cp.async, all at once) ----
  for (int g = 0; g < G; g++) {
    if (!s_n[g]) continue;
    const int64_t lane = lane0 + g;
    uint32_t* tab = s_tab + g * kTabWords;
    const int32_t* src[3] = {ll_tab + lane * kStatesLLML,
                             of_tab + lane * kStatesOF,
                             ml_tab + lane * kStatesLLML};
    const int off[3] = {0, kStatesLLML, kStatesLLML + kStatesOF};
    const int len[3] = {kStatesLLML, kStatesOF, kStatesLLML};
    for (int a = 0; a < 3; a++)
      for (int i = 4 * tid; i < len[a]; i += 4 * kThreads)
        __pipeline_memcpy_async(tab + off[a] + i, src[a] + i, 16);
    const uint32_t* row = words + lane * wb;
    uint32_t* dst = s_words + g * wp + kPad;
    const int nw = s_nw[g];
    int copied = nw;
    if ((wb & 3) == 0) {  // 16-byte rows: whole vectors (nw rounded up)
      copied = (nw + 3) & ~3;
      for (int i = 4 * tid; i < nw; i += 4 * kThreads)
        __pipeline_memcpy_async(dst + i, row + i, 16);
    } else {
      for (int i = tid; i < nw; i += kThreads)
        __pipeline_memcpy_async(dst + i, row + i, 4);
    }
    if (tid < kPad) {
      dst[tid - kPad] = 0u;
      dst[copied + tid] = 0u;
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // ---- rewrite each entry: code | xbits << 6 | nb << 11 | ns << 16 ----
  for (int g = 0; g < G; g++) {
    if (!s_n[g]) continue;
    uint32_t* tab = s_tab + g * kTabWords;
    for (int i = tid; i < kTabWords; i += kThreads) {
      const uint32_t e = tab[i];
      const uint32_t sym = e & 255u;
      uint32_t code, xbits;
      if (i < kStatesLLML) {
        code = min(sym, static_cast<uint32_t>(kMaxLLCode));
        xbits = s_llx[code];
      } else if (i < kStatesLLML + kStatesOF) {
        code = min(sym, static_cast<uint32_t>(kMaxOFCode));
        xbits = code;
      } else {
        code = min(sym, static_cast<uint32_t>(kMaxMLCode));
        xbits = s_mlx[code];
      }
      tab[i] = code | (xbits << 6) | (((e >> 20) & 31u) << 11) |
               (((e >> 8) & 4095u) << 16);
    }
  }
  __syncthreads();

  const int warp = tid >> 5, lt = tid & 31;
  const int nmax = s_nmax;
  const int g = lt;  // the lane of this thread in warps 0 and 1
  const bool mine = g < G && s_n[g] > 0;
  const int n = mine ? s_n[g] : 0;
  const int32_t* s0 = st + static_cast<int64_t>(lane0 + g) * 8;
  volatile int* made = &s_made;
  volatile int* used = &s_used;

  if (warp == 0) {
    // ---- warp 0: the FSE chain.  Hands each chunk of raw fields over
    // the ring: lle | llc << 16 | ofc << 22, mle | mlc << 16, ofv ----
    BitWindow bw{s_words + g * wp + kPad, mine ? s_nw[g] : 0, 0, 0u, 0u, 0};
    int s_ll = 0, s_of = 0, s_ml = 0;
    const uint32_t* t_ll = s_tab + g * kTabWords;
    const uint32_t* t_of = t_ll + kStatesLLML;
    const uint32_t* t_ml = t_of + kStatesOF;
    if (mine) {
      bw.pos = max(s0[0], BitWindow::kFloor);
      s_ll = clip_state(s0[4], kStatesLLML);
      s_of = clip_state(s0[5], kStatesOF);
      s_ml = clip_state(s0[6], kStatesLLML);
    }
    for (int c = 0, t0 = 0; t0 < nmax; c++, t0 += kChunk) {
      while (c - *used >= kRing) {
      }
      uint32_t* ring = s_ring + (c % kRing) * 3 * kChunk * pitch + g;
      const int tend = min(kChunk, n - t0);
      for (int j = 0; j < tend; j++) {
        const uint32_t e_ll = t_ll[s_ll], e_of = t_of[s_of],
                       e_ml = t_ml[s_ml];
        bw.reload();  // beside the table loads: both wait on pos alone
        const uint32_t ofc = e_of & 63u;
        // the six reads' widths, in stream order, and where each ends
        const int w_ml = (e_ml >> 6) & 31u, w_ll = (e_ll >> 6) & 31u;
        const int n_ll = (e_ll >> 11) & 31u, n_ml = (e_ml >> 11) & 31u;
        const int n_of = (e_of >> 11) & 31u;
        const int c1 = ofc, c2 = c1 + w_ml, c3 = c2 + w_ll;
        const int c4 = c3 + n_ll, c5 = c4 + n_ml, c6 = c5 + n_of;
        uint32_t ofv, mle, lle, b_ll, b_ml, b_of;
        if (c6 <= 64) {  // one window holds the sequence: parallel reads
          ofv = bw.field(64 - c1, ofc);
          mle = bw.field(64 - c2, w_ml);
          lle = bw.field(64 - c3, w_ll);
          b_ll = bw.field(64 - c4, n_ll);
          b_ml = bw.field(64 - c5, n_ml);
          b_of = bw.field(64 - c6, n_of);
          bw.pos = max(bw.pos - c6, BitWindow::kFloor);
        } else {  // up to 156 bits from a corrupt table: reload as needed
          ofv = bw.take(ofc);
          mle = bw.take(w_ml);
          lle = bw.take(w_ll);
          b_ll = bw.take(n_ll);
          b_ml = bw.take(n_ml);
          b_of = bw.take(n_of);
          bw.pos = max(bw.pos, BitWindow::kFloor);
        }
        s_ll = min((e_ll >> 16) + b_ll, static_cast<uint32_t>(kStatesLLML - 1));
        s_ml = min((e_ml >> 16) + b_ml, static_cast<uint32_t>(kStatesLLML - 1));
        s_of = min((e_of >> 16) + b_of, static_cast<uint32_t>(kStatesOF - 1));
        // extra-bit values fit 16 bits: the codes' counts are at most 16
        ring[(0 * kChunk + j) * pitch] = lle | ((e_ll & 63u) << 16) | (ofc << 22);
        ring[(1 * kChunk + j) * pitch] = mle | ((e_ml & 63u) << 16);
        ring[(2 * kChunk + j) * pitch] = ofv;
      }
      __syncwarp();
      __threadfence_block();
      if (lt == 0) *made = c + 1;
    }
  } else if (warp == 1) {
    // ---- warp 1: repcodes and values per lane, coalesced flush ----
    int64_t r0 = 0, r1 = 0, r2 = 0;
    if (mine) {
      r0 = s0[1];
      r1 = s0[2];
      r2 = s0[3];
    }
    for (int c = 0, t0 = 0; t0 < nmax; c++, t0 += kChunk) {
      while (*made <= c) {
      }
      __threadfence_block();
      const uint32_t* ring = s_ring + (c % kRing) * 3 * kChunk * pitch + g;
      const int tend = min(kChunk, n - t0);
      for (int j = 0; j < tend; j++) {
        const uint32_t a0 = ring[(0 * kChunk + j) * pitch];
        const uint32_t a1 = ring[(1 * kChunk + j) * pitch];
        const uint32_t ofv = ring[(2 * kChunk + j) * pitch];
        const int llc = (a0 >> 16) & 63u, ofc = a0 >> 22;
        const int mlc = a1 >> 16;
        const int64_t of_base =
            ofc > 1 ? (int64_t{1} << ofc) - 3 : static_cast<int64_t>(ofc);
        const bool big = ofc > 1;
        const int ll0 = llc == 0;  // LL base 0 is code 0 alone
        const int64_t idx = 1 + ll0 + static_cast<int64_t>(ofv);  // ofc == 1
        const bool case_a = !big && ofc == 0 && ll0 == 0;
        const bool swap =
            !big && ((ofc == 0 && ll0 == 1) || (ofc == 1 && idx == 1));
        const bool rot = !big && ofc == 1 && idx == 2;
        const bool dec = !big && ofc == 1 && idx == 3;
        const int64_t r0n = big   ? of_base + ofv
                            : dec ? (r0 - 1 > 1 ? r0 - 1 : 1)
                            : rot ? r2
                            : swap ? r1
                                   : r0;
        const int64_t r1n = case_a ? r1 : r0;
        const int64_t r2n = (case_a || swap) ? r2 : r1;
        r0 = r0n;
        r1 = r1n;
        r2 = r2n;
        s_out[(0 * kChunk + j) * pitch + g] =
            s_llb[llc] + static_cast<int32_t>(a0 & 0xFFFFu);
        s_out[(1 * kChunk + j) * pitch + g] =
            s_mlb[mlc] + static_cast<int32_t>(a1 & 0xFFFFu);
        s_out[(2 * kChunk + j) * pitch + g] =
            static_cast<int32_t>(static_cast<uint32_t>(r0));
      }
      __syncwarp();
      __threadfence_block();
      if (lt == 0) *used = c + 1;  // the ring slot is free again
      // coalesced flush: lane g2's sequences [t0, t0 + 32), 128 B an array
      for (int g2 = 0; g2 < G; g2++) {
        if (t0 + lt < s_n[g2]) {
          const int64_t o = static_cast<int64_t>(lane0 + g2) * t_len + t0 + lt;
          out_ll[o] = s_out[(0 * kChunk + lt) * pitch + g2];
          out_ml[o] = s_out[(1 * kChunk + lt) * pitch + g2];
          out_of[o] = s_out[(2 * kChunk + lt) * pitch + g2];
        }
      }
      __syncwarp();
    }
  } else {
    // ---- warps 2-3: zero the tails [n, T) of every row ----
    const int z = tid - 64, nz = kThreads - 64;
    for (int g2 = 0; g2 < G; g2++) {
      const int64_t base = static_cast<int64_t>(lane0 + g2) * t_len;
      const int n2 = s_n[g2];
      int32_t* outs[3] = {out_ll + base, out_ml + base, out_of + base};
      const int a = (t_len & 3) ? t_len : min((n2 + 3) & ~3, t_len);
      for (int k = 0; k < 3; k++) {
        for (int t = n2 + z; t < a; t += nz) outs[k][t] = 0;
        int4* v = reinterpret_cast<int4*>(outs[k]);
        for (int t = a / 4 + z; t < t_len / 4; t += nz)
          v[t] = make_int4(0, 0, 0, 0);
      }
    }
  }
}

}  // namespace

// Decode nl lane-major sequence sections into out_ll/out_ml/out_of
// [nl, t_len] (int32) on `stream`.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue when one lane's words do not fit shared memory).
extern "C" int zt_fse_decode(const void* words, int wb, const void* ll_tab,
                             const void* of_tab, const void* ml_tab,
                             const void* st, const void* nseq, void* out_ll,
                             void* out_ml, void* out_of, int nl, int t_len,
                             void* stream) {
  if (nl <= 0 || t_len <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int g = sms > 0 ? (nl + sms - 1) / sms : 1;
  g = g < 1 ? 1 : (g > kMaxLanes ? kMaxLanes : g);
  while (g > 1 && smem_bytes(g, wb) > kSmemMax) g--;
  const int64_t smem = smem_bytes(g, wb);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  // the default 48 KB limit counts the static shared memory too, so opt in
  // on every launch rather than from a threshold on the dynamic size alone
  err = cudaFuncSetAttribute(fse_decode_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (nl + g - 1) / g;
  fse_decode_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), wb,
      static_cast<const int32_t*>(ll_tab), static_cast<const int32_t*>(of_tab),
      static_cast<const int32_t*>(ml_tab), static_cast<const int32_t*>(st),
      static_cast<const int32_t*>(nseq), static_cast<int32_t*>(out_ll),
      static_cast<int32_t*>(out_ml), static_cast<int32_t*>(out_of), nl, t_len,
      g);
  return static_cast<int>(cudaGetLastError());
}
