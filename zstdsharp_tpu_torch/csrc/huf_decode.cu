// Batched zstd Huffman X1 literal decode, one backward stream per lane,
// designed for Hopper.
//
// Replaces the Pallas kernel zstdsharp_tpu/ops/device_huf.py:_decode_fn
// (:238, its pallas_call at :356).  Per symbol it computes what
// ops/device_huf.py:decode_plain computes:
//   1. peek the 11 bits [pos - 11, pos) (zeros below bit 0 and for words
//      outside [0, wb));
//   2. class = the number of the lane's 16 limits the peek reaches (class
//      16 reads zeros);
//   3. rank = clip(base + ((v - off) >> clamp(shift, 0, 31)), 0, 255) in 64
//      bits, symbol = perm[rank];
//   4. pos -= 11 - shift, with the raw int32 shift.
// A lane stops after clamp(nsym, 0, T) symbols and its row is zero past
// them.  Every index is clamped as the plain version clamps it, so operands
// planned from a corrupt frame give wrong symbols, never an illegal address.
//
// What bounds it on the H100.  Roofline: the bytes the call must move are
// each live lane's tables (limits, bases, offs, shifts, planes: 512 B) and
// live words (ceil(pos/32) of them), pos and nsym, and the [NL, T] int32
// output (kernel_bench.huf_work); at the main path's window [1024 lanes,
// Wb 256, T 1024] that is about 4.7 MB, 1.4 us at 3.35 TB/s, nearly all of
// it the zero tails of the output.  Serial floor: within a lane each
// symbol's position depends on the one before through the chain
// pos -> peek -> table -> bits consumed -> pos, so a lane takes at least
// nsym x (that chain's latency); the longest lane of that window has 908
// symbols, and alone it takes 0.0314 ms on an H100 (34.6 ns a symbol).
// The serial floor is the larger bound by more than an order of
// magnitude, so the design keeps the chain as short as the card allows and
// takes everything else off it:
//
// * One lane per block, the blocks spread over the SMs.  1024 lanes are
//   1024 blocks, all resident at once (8 an SM; registers allow 10).  Lanes
//   that share a warp run in lockstep: each symbol's table load then waits
//   for the bank conflicts of all of them, and one flush warp serves them
//   all.  As blocks of their own, the SM's four schedulers interleave
//   independent chains.  On the H100 (PERF.md) 8, 4, 2 and 1 lanes a block
//   took 0.0499, 0.0424, 0.0381 and 0.0368 ms at the main path's window,
//   against 0.0331 ms for its longest lane alone.  The block's shared
//   memory is at most 13.2 KB (Wb 2048; T sets none); the launcher opts in
//   to it on every launch.
// * A decode table in shared memory.  The block's 128 threads build, in
//   parallel, the lane's 2^11-entry table: entry v is the bits peek v
//   consumes and its symbol, count | sym << 8, a u16.  The permutation is
//   first expanded from its bit-planes, one rank a thread.  The 16-way
//   class compare, the three class tables and the permutation thus leave
//   the chain, which becomes peek -> one shared-memory load -> advance.
// * Exact for any operand.  The entry's symbol is computed at build time
//   with the plain version's 64-bit arithmetic, so it is exact whatever the
//   tables hold.  The count 11 - shift is not small for a corrupt operand:
//   a lane whose 16 shifts all lie in [0, 11] (every planner's lane: valid
//   shifts are [0, 10]) is "fast" and its entries hold counts in [0, 11];
//   any other lane's entries hold the class, and its decode reads an int64
//   count table in a slower loop that peeks from global memory with int64
//   positions, as the plain version does.  No planner operand takes it.
// * The stream in shared memory and a 96-bit bit window.  The block copies
//   a fast lane's live words (word 0 to ceil(pos/32), capped at wb) into
//   shared memory with cp.async, between kPad zero words on each side.  The
//   decoding thread loads a window of the bits [pos - 96, pos) (four word
//   loads, three funnel shifts) once every 8 symbols: a fast lane consumes
//   at most 11 bits a symbol, so 8 peeks never reach past it.  Each peek is
//   the window's top 11 bits and the window then shifts left by the
//   entry's count, so the chain per symbol is the table load, one funnel
//   shift and the address.  A group of 8 is straight-line code; only a
//   lane's last group tests each symbol.  pos is 32-bit and held at -256 or
//   more: every bit below 0 reads zero, so the floor changes no read; a fast
//   lane never moves pos up, so no read reaches past ceil(pos/32) words.
// * Only the chain on the serial thread.  Thread 0 runs window -> table ->
//   advance and hands each 32 symbols to warp 1 through a 4-chunk ring in
//   shared memory; warp 1 writes them as one coalesced 128-byte store.
//   Warps 2-3 zero-fill the row's tail [n, T) with 16-byte stores
//   meanwhile, so the zero tail (most of the bytes) costs the chain
//   nothing.
//
// Measured on an H100 (PERF.md, kernel_bench.py --huf-baseline): 0.0369 ms
// at the main path's window, 1.18x its longest lane alone.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // thread 0 decodes, warp 1 emits, 2-3 zero
constexpr int kChunk = 32;     // symbols per hand-over and coalesced flush
constexpr int kRing = 4;       // chunks in flight between decoder and flush
constexpr int kPad = 4;        // zero words before and after the lane's words
constexpr int kMaxLog = 11;    // peek width
constexpr int kPeeks = 1 << kMaxLog;
constexpr int kClasses = 16;
constexpr int kRows = kClasses + 1;  // class 16 reads zeros
constexpr int kGroup = 8;            // symbols per window load
constexpr int kFloor = -256;         // fast lanes hold pos at this or more
// 227 KB, the most a block may opt into, less this kernel's static shared
// memory (two counters)
constexpr int kSmemMax = 232448 - 1024;

static_assert(kGroup * kMaxLog <= 96 && kChunk % kGroup == 0,
              "a group's peeks must stay inside the 96-bit window");

__host__ __device__ constexpr int64_t r16(int64_t b) { return (b + 15) & ~15ll; }

// Byte offsets of the dynamic shared memory regions: the padded word row
// (kPad zeros, the lane's words, kPad zeros) at 0, then int64 counts [17],
// int32 class tables [4][17] (limits, bases, offs, shifts), the ring
// [kRing][32] of u32, the decode table [2048] of u16, the permutation
// [256] of u8.
struct Layout {
  int64_t cnt, cls, ring, tab, perm, total;
};

__host__ __device__ constexpr Layout layout(int wb) {
  Layout l{};
  l.cnt = r16(4ll * (wb + 2 * kPad));
  l.cls = l.cnt + r16(8ll * kRows);
  l.ring = l.cls + r16(4ll * 4 * kRows);
  l.tab = l.ring + r16(4ll * kRing * kChunk);
  l.perm = l.tab + r16(2ll * kPeeks);
  l.total = l.perm + r16(256);
  return l;
}

// Zero out[t] for t in [n, t_len), thread z of nz: 16-byte stores where the
// row allows them.
__device__ __forceinline__ void zero_tail(int32_t* o, int n, int t_len, int z,
                                          int nz) {
  const int a = (t_len & 3) ? t_len : min((n + 3) & ~3, t_len);
  for (int t = n + z; t < a; t += nz) o[t] = 0;
  int4* v = reinterpret_cast<int4*>(o);
  for (int t = a / 4 + z; t < t_len / 4; t += nz) v[t] = make_int4(0, 0, 0, 0);
}

// One group of a fast lane: decodes m symbols (kFull: kGroup) from the
// stream bits below pos into ring[0, m) and returns the new pos.  a:b:c
// holds the bits [pos - 96, pos), bit pos - 1 at the top of a, from the
// padded word row w (word 0 of the lane at w[0], nw live words): a word
// index below 0 or at or past nw reads a zero pad (words past nw hold no
// bit below pos), and clamping the first index into [-kPad, nw] keeps
// every load in the row and reads the same zeros.  Each peek is the
// window's top 11 bits; the window then shifts left by the entry's count,
// which the funnel shifts take from the entry's low 5 bits themselves.
template <bool kFull>
__device__ __forceinline__ int fast_group(const uint16_t* tab,
                                          const uint32_t* w, int nw, int pos,
                                          uint32_t* ring, int m) {
  const int first = pos - 96;
  const int k = min(max(first >> 5, -kPad), nw);  // >> is arithmetic
  const int s = first & 31;
  const uint32_t x0 = w[k], x1 = w[k + 1], x2 = w[k + 2], x3 = w[k + 3];
  uint32_t a = __funnelshift_r(x2, x3, s);
  uint32_t b = __funnelshift_r(x1, x2, s);
  uint32_t c = __funnelshift_r(x0, x1, s);
  int used = 0;
#pragma unroll
  for (int j = 0; j < kGroup; j++) {
    if (kFull || j < m) {
      const uint32_t e = tab[a >> (32 - kMaxLog)];
      a = __funnelshift_l(b, a, e);
      b = __funnelshift_l(c, b, e);
      c = __funnelshift_l(0u, c, e);
      used += static_cast<int>(e & 31u);
      ring[j] = e >> 8;
    }
  }
  return max(pos - used, kFloor);
}

__global__ void __launch_bounds__(kThreads) huf_decode_kernel(
    const uint32_t* __restrict__ words, int wb,
    const int32_t* __restrict__ limits, const int32_t* __restrict__ bases,
    const int32_t* __restrict__ offs, const int32_t* __restrict__ shifts,
    const int32_t* __restrict__ planes, const int32_t* __restrict__ pos_in,
    const int32_t* __restrict__ nsym, int32_t* __restrict__ out, int t_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(wb);
  uint32_t* s_w = reinterpret_cast<uint32_t*>(smem) + kPad;  // word 0
  int64_t* s_cnt = reinterpret_cast<int64_t*>(smem + L.cnt);
  int32_t* s_cls = reinterpret_cast<int32_t*>(smem + L.cls);
  uint32_t* s_ring = reinterpret_cast<uint32_t*>(smem + L.ring);
  uint16_t* s_tab = reinterpret_cast<uint16_t*>(smem + L.tab);
  uint8_t* s_perm = smem + L.perm;
  __shared__ int s_made, s_used;  // chunks handed over by thread 0 / taken

  const int tid = threadIdx.x;
  const int64_t lane = blockIdx.x;
  int32_t* orow = out + lane * t_len;
  const int n = min(max(nsym[lane], 0), t_len);  // the same in every thread
  if (n == 0) {
    zero_tail(orow, 0, t_len, tid, kThreads);
    return;
  }
  if (tid == 0) s_made = s_used = 0;
  const int32_t* shf_in = shifts + lane * kClasses;
  const bool fast = __syncthreads_and(
      tid >= kClasses || (shf_in[tid] >= 0 && shf_in[tid] <= kMaxLog));

  // ---- stage a fast lane's live words (cp.async) and the zero pads ----
  int nw = 0;
  if (fast) {
    const int64_t k = (static_cast<int64_t>(pos_in[lane]) + 31) >> 5;
    nw = static_cast<int>(k < 0 ? 0 : (k > wb ? wb : k));
    const uint32_t* row = words + lane * wb;
    int copied = nw;
    if ((wb & 3) == 0 && (reinterpret_cast<uintptr_t>(words) & 15) == 0) {
      copied = (nw + 3) & ~3;  // whole 16-byte vectors, still <= wb
      for (int i = 4 * tid; i < nw; i += 4 * kThreads)
        __pipeline_memcpy_async(s_w + i, row + i, 16);
    } else {
      for (int i = tid; i < nw; i += kThreads)
        __pipeline_memcpy_async(s_w + i, row + i, 4);
    }
    if (tid < kPad) {
      s_w[tid - kPad] = 0u;
      s_w[copied + tid] = 0u;
    }
  }
  __pipeline_commit();

  // ---- class tables and counts; rank -> symbol, one rank a thread ----
  if (tid < kRows) {
    const int c = tid;
    const int64_t src = lane * kClasses + c;
    const bool real = c < kClasses;
    const int32_t shf = real ? shifts[src] : 0;
    s_cls[c] = real ? limits[src] : 0;
    s_cls[kRows + c] = real ? bases[src] : 0;
    s_cls[2 * kRows + c] = real ? offs[src] : 0;
    s_cls[3 * kRows + c] = shf;
    s_cnt[c] = kMaxLog - static_cast<int64_t>(shf);
  }
  for (int r = tid; r < 256; r += kThreads) {
    // bit j of perm[r] is bit (r & 31) of planes[j][r >> 5]
    const int32_t* pl = planes + lane * 64 + (r >> 5);
    uint32_t s = 0;
#pragma unroll
    for (int j = 0; j < 8; j++)
      s |= ((static_cast<uint32_t>(__ldg(pl + j * 8)) >> (r & 31)) & 1u) << j;
    s_perm[r] = static_cast<uint8_t>(s);
  }
  __syncthreads();

  // ---- the decode table: entry v = (count or class) | sym << 8 ----
  {
    int32_t lim[kClasses];
#pragma unroll
    for (int c = 0; c < kClasses; c++) lim[c] = s_cls[c];
    for (int v = tid; v < kPeeks; v += kThreads) {
      int cls = 0;
#pragma unroll
      for (int c = 0; c < kClasses; c++) cls += v >= lim[c];
      const int64_t base = s_cls[kRows + cls], off = s_cls[2 * kRows + cls];
      const int32_t shf = s_cls[3 * kRows + cls];
      const int sa = min(max(shf, 0), 31);
      int64_t rank = base + ((static_cast<int64_t>(v) - off) >> sa);
      rank = rank < 0 ? 0 : (rank > 255 ? 255 : rank);
      const uint32_t info = fast ? static_cast<uint32_t>(kMaxLog - shf)
                                 : static_cast<uint32_t>(cls);
      s_tab[v] = static_cast<uint16_t>(info | (s_perm[rank] << 8));
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  const int warp = tid >> 5, lt = tid & 31;
  volatile int* made = &s_made;
  volatile int* used = &s_used;

  if (tid == 0) {
    // ---- thread 0: the decode chain; hands each chunk over the ring ----
    const uint32_t* row = words + lane * wb;
    int pos = max(pos_in[lane], kFloor);  // fast lanes
    int64_t p = pos_in[lane];             // the others
    for (int c = 0, t0 = 0; t0 < n; c++, t0 += kChunk) {
      while (c - *used >= kRing) {
      }
      uint32_t* ring = s_ring + (c % kRing) * kChunk;
      const int tend = min(kChunk, n - t0);
      if (fast) {
        int j0 = 0;
        for (; j0 + kGroup <= tend; j0 += kGroup)
          pos = fast_group<true>(s_tab, s_w, nw, pos, ring + j0, kGroup);
        if (j0 < tend)
          pos = fast_group<false>(s_tab, s_w, nw, pos, ring + j0, tend - j0);
      } else {
        // any shift outside [0, 11]: int64 positions, words from global
        for (int j = 0; j < tend; j++) {
          const int64_t p0 = p - kMaxLog;
          const int64_t k = p0 >> 5;
          const uint32_t w0 = (k >= 0 && k < wb) ? __ldg(row + k) : 0u;
          const uint32_t w1 =
              (k + 1 >= 0 && k + 1 < wb) ? __ldg(row + k + 1) : 0u;
          const uint32_t e =
              s_tab[__funnelshift_r(w0, w1, static_cast<int>(p0 & 31)) &
                    (kPeeks - 1)];
          ring[j] = e >> 8;
          p -= s_cnt[e & 31u];
        }
      }
      __threadfence_block();
      *made = c + 1;
    }
  } else if (warp == 1) {
    // ---- warp 1: coalesced flush of symbols [t0, t0 + 32) ----
    for (int c = 0, t0 = 0; t0 < n; c++, t0 += kChunk) {
      while (*made <= c) __nanosleep(32);  // spare the chain's LSU
      __threadfence_block();
      const uint32_t v = s_ring[(c % kRing) * kChunk + lt];
      if (t0 + lt < n) orow[t0 + lt] = static_cast<int32_t>(v);
      __syncwarp();
      __threadfence_block();
      if (lt == 0) *used = c + 1;  // the ring slot is free again
    }
  } else if (warp >= 2) {
    // ---- warps 2-3: zero the tail [n, T) ----
    zero_tail(orow, n, t_len, tid - 64, kThreads - 64);
  }
}

}  // namespace

// Decode nl lane-major streams into out[nl, t_len] (int32 symbols) on
// `stream`, one block a lane.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue when a lane's words do not fit shared memory).
extern "C" int zt_huf_decode(const void* words, int wb, const void* limits,
                             const void* bases, const void* offs,
                             const void* shifts, const void* planes,
                             const void* pos, const void* nsym, void* out,
                             int nl, int t_len, void* stream) {
  if (nl <= 0 || t_len <= 0) return 0;
  const int64_t smem = layout(wb).total;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  // the default 48 KB limit counts the static shared memory too, so opt in
  // on every launch rather than from a threshold on the dynamic size alone
  cudaError_t err = cudaFuncSetAttribute(
      huf_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  huf_decode_kernel<<<nl, kThreads, static_cast<size_t>(smem),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), wb,
      static_cast<const int32_t*>(limits), static_cast<const int32_t*>(bases),
      static_cast<const int32_t*>(offs), static_cast<const int32_t*>(shifts),
      static_cast<const int32_t*>(planes), static_cast<const int32_t*>(pos),
      static_cast<const int32_t*>(nsym), static_cast<int32_t*>(out), t_len);
  return static_cast<int>(cudaGetLastError());
}
