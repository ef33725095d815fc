// Batched LZ sequence execution (ZSTD_execSequence), one block per lane,
// designed for Hopper.
//
// Replaces the TPU design of zstdsharp_tpu/ops/execseq.py:make_executor
// (:41; XLA, no pallas_call), which the decode plane reaches from
// zstdsharp_tpu/decode/device_pipeline.py:1217 (_fused_decode).  It computes
// exactly what ops/execseq.py:make_executor's run computes, byte for byte
// on any operands:
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
// What bounds it on the H100.  Roofline: the call must write B x O output
// bytes and read the literals, the window bytes and the 12 bytes of each
// sequence the lanes use: at the main path's chunk [64, 24576] about 3 MB,
// about 1 us at 3.35 TB/s.  Serial floor: within a lane a match may read
// the bytes the match before it wrote, so a lane walks its sequences in
// order, and each step (load the sequence, test its sources, copy, maybe a
// barrier) is a chain of shared-memory latencies; a level-9 24 KB record
// has a few thousand sequences.  The serial floor is the larger bound by
// two orders of magnitude, so the design keeps that walk short:
//
// * One block per lane, 128 threads.  The lane's output row lives in
//   dynamic shared memory (O bytes, up to 227 KB less the static part;
//   the launcher opts in on every launch), so a match reads its sources at
//   shared-memory latency; the row is stored once at the end with 16-byte
//   stores, zeros past out_len included.  The window (up to 4 MB) and the
//   literals are read from device memory.
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
//   finding its sequence by a binary search of the run starts.  Offsets
//   are mostly longer than a few sequences, so a group holds several
//   matches, and a tile costs a few barriers rather than one a sequence.
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
//   same number of pointer-jumping rounds in place, and the pool gather).
//   A walked lane whose match reads a position the walk has not finalised
//   (only a pool reference below index 0 can, for corrupt offsets) drops
//   its walk and takes the exact path too.  Every index is clamped as the
//   plain version clamps it, so a corrupt lane gives the plain version's
//   bytes, never an illegal address.  No valid frame takes the exact path.
//
// Measured on an H100 (PERF.md, chip_smoke.py phase lz_exec): 0.19 ms a
// chunk of the main path's [64, 24576], its longest lane alone the same
// (100 ns a sequence), against 2.7-3.2 ms for the plain version.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // threads a block, also sequences a tile
constexpr int kWarps = kThreads / 32;
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

struct Lane {
  const uint8_t* lit;  // [L]
  const uint8_t* win;  // [W]
  const int32_t* ll;   // [S]
  const int32_t* ml;
  const int32_t* off;
  i64 L, P, S, O, n_seq, out_len, wlen;  // wlen: win_len
  int32_t last;  // last_lit as int32
};

__device__ __forceinline__ uint8_t pool_at(const Lane& z, i64 q) {
  q = q < 0 ? 0 : (q >= z.P ? z.P - 1 : q);
  return q < z.L ? z.lit[q] : z.win[q - z.L];
}

// The plain version's extended sequence k in [0, S]: (ll, ml, off).
__device__ __forceinline__ void ext(const Lane& z, i64 k, i64& l, i64& m,
                                    i64& o) {
  const bool live = k < z.n_seq, tail = k == z.n_seq;
  const bool real = live && k < z.S;
  l = tail ? z.last : (real ? z.ll[k] : 0);
  m = real ? z.ml[k] : 0;
  o = real ? max(z.off[k], 1) : 1;
}

// Flag bit 2 for live sequence k whose match starts at output position
// ms: its offset as u32 is 0 or reaches before the lane's window.
__device__ __forceinline__ bool reach_bad(const Lane& z, i64 k, i64 ms) {
  const uint32_t o = static_cast<uint32_t>(z.off[k]);
  const i64 lim = static_cast<i64>(static_cast<unsigned long long>(ms) +
                                   static_cast<unsigned long long>(z.wlen));
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
      l = static_cast<uint32_t>(z.ll[k]);
      m = static_cast<uint32_t>(z.ml[k]);
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

__global__ void __launch_bounds__(kThreads)
    lz_exec_kernel(const uint8_t* __restrict__ lit, i64 L,
                   const uint8_t* __restrict__ window, i64 W, i64 ws,
                   const int32_t* __restrict__ ll,
                   const int32_t* __restrict__ ml,
                   const int32_t* __restrict__ off, i64 S,
                   const i64* __restrict__ n_seq,
                   const i64* __restrict__ last_lit,
                   const i64* __restrict__ out_len,
                   const i64* __restrict__ win_len, uint8_t* __restrict__ out,
                   i64 O, i64 O16, int32_t* __restrict__ bad, i64* seg_scratch,
                   int32_t* code_scratch, int search_rounds,
                   int jump_rounds) {
  extern __shared__ __align__(16) uint8_t row[];
  __shared__ i64 t_rs[kThreads], t_lb[kThreads], t_hi[kThreads];
  __shared__ i64 sh[2 * kWarps];
  __shared__ int32_t t_ll[kThreads], t_off[kThreads];
  __shared__ int32_t t_g[kThreads + 1];
  __shared__ int t_ng;
  const int tid = threadIdx.x;
  const i64 b = blockIdx.x;

  Lane z;
  z.lit = lit + b * L;
  z.win = window + b * ws;
  z.ll = ll + b * S;
  z.ml = ml + b * S;
  z.off = off + b * S;
  z.L = L;
  z.P = L + W;
  z.S = S;
  z.O = O;
  z.n_seq = n_seq[b];
  z.out_len = out_len[b];
  z.wlen = win_len[b];
  z.last = static_cast<int32_t>(last_lit[b]);
  const i64 oe = z.out_len < 0 ? 0 : min(z.out_len, O);

  // walked lane: every live ll and ml and the tail's last_lit >= 0
  const i64 nlive = z.n_seq < 0 ? 0 : min(z.n_seq, S);
  bool irregular = z.n_seq >= 0 && z.n_seq <= S && z.last < 0;
  for (i64 k = tid; k < nlive; k += kThreads)
    irregular |= (z.ll[k] < 0) | (z.ml[k] < 0);
  i64 fsum = 0, k_rest = nlive, rs_rest = 0;
  bool fbad = false;
  if (__syncthreads_or(irregular) ||
      walk(z, oe, row, t_rs, t_lb, t_hi, t_ll, t_off, t_g, &t_ng, sh, fsum,
           fbad, k_rest, rs_rest)) {
    fsum = 0;
    fbad = false;
    k_rest = rs_rest = 0;
    exact(z, oe, row, seg_scratch + b * 2 * (S + 1), code_scratch + b * O,
          search_rounds, jump_rounds, sh);
  }
  // the flags: the rest of the live sequences, then one block reduction
  flag_scan(z, k_rest, rs_rest, nlive, fsum, fbad, sh);
  i64 e1, e2, tsum, tbad;
  scan2(fsum, fbad ? 1 : 0, e1, e2, tsum, tbad, sh);
  if (tid == 0) {
    const i64 last = last_lit[b];
    const i64 total = static_cast<i64>(static_cast<unsigned long long>(tsum) +
                                       static_cast<unsigned long long>(last));
    bad[b] = (last < 0 ? 1 : 0) | (total != z.out_len ? 2 : 0) |
             (tbad > 0 ? 4 : 0);
  }

  // the row, zeros past out_len, stored once
  for (i64 p = oe + tid; p < O16; p += kThreads) row[p] = 0;
  __syncthreads();
  uint8_t* dst = out + b * O;
  if ((O & 15) == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(row);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (i64 q = tid; q < O / 16; q += kThreads) d4[q] = s4[q];
  } else {
    for (i64 p = tid; p < O; p += kThreads) dst[p] = row[p];
  }
}

}  // namespace

// lit [b, L] u8, window rows of W bytes `ws` apart (0: one shared row),
// ll/ml/off [b, S] int32, n_seq/last_lit/out_len/win_len [b] int64, out
// [b, O] u8, bad [b] int32 (the lanes' flags);
// seg_scratch int64 [b, 2, S+1] and code_scratch int32 [b, O], written only
// by lanes that take the exact path.  Returns a cudaError_t.
extern "C" int zt_lz_exec(const void* lit, long long L, const void* window,
                          long long W, long long ws, const void* ll,
                          const void* ml, const void* off, long long S,
                          const void* n_seq, const void* last_lit,
                          const void* out_len, const void* win_len, void* out,
                          long long O, void* bad, void* seg_scratch,
                          void* code_scratch, int search_rounds,
                          int jump_rounds, int b,
                          void* stream) {
  if (b <= 0 || O <= 0) return 0;
  if (L < 0 || W < 0 || L + W <= 0 || S < 0 || O > (1ll << 30) ||
      L + W > (1ll << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long o16 = (O + 15) & ~15ll;
  if (o16 > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  // the default 48 KB limit counts the static shared memory too, so opt in
  // on every launch rather than from a threshold on the dynamic size alone
  cudaError_t err = cudaFuncSetAttribute(
      lz_exec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(o16));
  if (err != cudaSuccess) return static_cast<int>(err);
  lz_exec_kernel<<<b, kThreads, static_cast<size_t>(o16),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(lit), L, static_cast<const uint8_t*>(window),
      W, ws, static_cast<const int32_t*>(ll), static_cast<const int32_t*>(ml),
      static_cast<const int32_t*>(off), S, static_cast<const i64*>(n_seq),
      static_cast<const i64*>(last_lit), static_cast<const i64*>(out_len),
      static_cast<const i64*>(win_len), static_cast<uint8_t*>(out), O, o16,
      static_cast<int32_t*>(bad), static_cast<i64*>(seg_scratch),
      static_cast<int32_t*>(code_scratch), search_rounds, jump_rounds);
  return static_cast<int>(cudaGetLastError());
}
