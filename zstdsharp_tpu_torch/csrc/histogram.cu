// 256-bin byte histogram of B rows of N bytes, with an optional mask.
//
// Replaces the Pallas kernel zstdsharp_tpu/ops/histogram.py:36 _hist_kernel,
// reached through histogram_u8_pallas (:57, pallas_call at :69).  It
// computes out[b][v] = number of positions i < N of row b with
// data[b][i] == v (and mask[b][i] != 0 when a mask is given).  The Pallas
// kernel compares 4096-byte sub-steps against an iota because a TPU
// scatter is slow; Hopper has shared-memory atomics, so this kernel counts
// with them instead.
//
// Bound on the H100: the bytes over 3.35 TB/s -- every mask byte, the
// 32-byte sectors of data that hold a kept position, 1 KB written a row;
// two operations a byte are far below the core rate
// (kernel_bench.hist_work).  The encode plane's literal rows ([32, 16384]
// with prefix masks that keep about 1 % of the positions) need about
// 0.56 MB, 0.17 us; the unmasked 4 MB vector 1.25 us.  At about 1 MB a
// call the floor is the launch itself, not the bytes: an empty kernel of
// the same grid takes 0.85 us on the profiler, five times the bound
// (zt_histogram_floor launches one, so that a run shows how far the kernel
// sits above what any one launch can do).  Past the launch, a block's time
// is its load latency and its shared atomics, one a kept byte.  What each
// design choice does:
//
// - One launch, no fill.  Blocks never add into global memory: each row's
//   counts are summed on chip and stored once, zeros included, so the
//   caller allocates `out` uninitialised and no fill kernel runs first.
// - A row's blocks form one thread block cluster of cs <= 8 blocks (the
//   portable limit).  Each block counts its share of the row into per-warp
//   shared sub-histograms and sums its warps' copies, one bin a thread.
//   Block q of the cluster owns bins [q*256/cs, (q+1)*256/cs): every block
//   stores its sum of each bin into the owner's `stage` through
//   distributed shared memory, all arrive at one cluster barrier, and each
//   owner adds its bins' cs entries and stores them.  The remote stores go
//   out without waiting for a reply, and nothing reads another block's
//   shared memory after the barrier, so no exit barrier is needed; a first
//   barrier, arrived at on entry and waited for only before the remote
//   stores, makes sure every peer is running.  No global atomics, and the
//   result does not depend on block order.  The barriers still cost about
//   0.9 us on an H100, so the caller (ops/histogram.py plan) picks cs from
//   the shape: the encode plane's [32, 16384] literal rows run one block a
//   row (cs = 1: no cluster attribute, no barrier).  The grid is 1-D, so
//   B is not capped at 65,535.
// - Long rows.  So few rows that one cluster each would leave most SMs
//   idle take cpr > 1 clusters a row, each storing a partial row into
//   `scratch` [B, cpr, 256], which a second small kernel sums, four
//   threads a bin: one 4 MB row runs on 264 blocks, where one cluster of 8
//   is 11x slower and a non-portable cluster of 16 was 5.8x slower.
// - 16-byte loads.  Data and mask are read as uint4, neighbouring threads
//   on neighbouring words, kUnroll words of each in flight a thread, all
//   requested together; the first words before the shared histograms are
//   zeroed.  A word whose 16 mask bytes are all 0 (the masked-out end of a
//   prefix-masked row) is not counted.  Its data word is still loaded,
//   which the bound does not count: reading the mask first and the data
//   only where a mask word keeps a byte puts a second round trip into a
//   block's one round of loads, and was slower on the literal rows (2.84
//   against 2.64 us, PERF.md).  A row starts at row*N, which is not 16-byte
//   aligned when N % 16 != 0 or the tensor is a view, so each row has a
//   scalar head up to its first aligned word and a scalar tail.  The mask
//   is read as uint4 when it has the data's alignment, else byte by byte.
// - Skew.  Literal text puts most hits on a few bins.  The hardware
//   combines a warp's increments of one shared address into one, so plain
//   per-warp atomics cost the same on text, on "ab" rows and on rows of
//   one byte value; grouping a warp's lanes by value (__match_any_sync)
//   first was slower on every input measured (PERF.md).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kUnroll = 4;  // 16-byte words in flight a thread
constexpr int kMaxCluster = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kHist = kBins * kWarps;  // hist[warp * 256 + bin]
static_assert(kThreads == kBins, "the fold takes one bin a thread");

// Counts the 16 bytes of `d` whose mask byte in `m` is non-zero.
__device__ __forceinline__ void count_word(int32_t* h, uint4 d, uint4 m) {
  if ((m.x | m.y | m.z | m.w) == 0) return;
  const uint32_t dw[4] = {d.x, d.y, d.z, d.w};
  const uint32_t mw[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
  for (int k = 0; k < 16; k++) {
    const int s = 8 * (k & 3);
    if ((mw[k >> 2] >> s) & 0xFFu)
      atomicAdd(h + ((dw[k >> 2] >> s) & 0xFFu), 1);
  }
}

__device__ __forceinline__ uint4 load_mask(const uint8_t* p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; k++)
    w[k] = p[4 * k] | p[4 * k + 1] << 8 | p[4 * k + 2] << 16 |
           static_cast<uint32_t>(p[4 * k + 3]) << 24;
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Grid: B * cpr clusters of cs blocks, 1-D; block j of a row is rank j % cs
// of the row's cluster j / cs.  `dst` is out [B, 256] when cpr == 1, else
// scratch [B, cpr, 256].  `mask_vec`: the mask may be read as uint4.
__global__ void __launch_bounds__(kThreads) histogram_kernel(
    const uint8_t* __restrict__ data, const uint8_t* __restrict__ mask,
    int64_t n, int per_row, int cpr, bool mask_vec,
    int32_t* __restrict__ dst) {
  __shared__ __align__(16) int32_t hist[kHist];
  __shared__ int32_t stage[kMaxCluster * kBins];  // [sender][bin]
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x / per_row;
  const int j = blockIdx.x % per_row;
  const int cs = per_row / cpr;
  // this block is running: its peers may write into its shared memory
  // once every block of the cluster has arrived here
  if (cs > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" :::
                           "memory");
  const uint8_t* d = data + row * n;
  const uint8_t* m = mask ? mask + row * n : nullptr;
  int32_t* h = hist + (tid / 32) * kBins;

  // the row's aligned words [head, head + 16 nw), cut into per_row shares
  const int64_t lead = (16 - (reinterpret_cast<uintptr_t>(d) & 15)) & 15;
  const int64_t head = lead < n ? lead : n;
  const int64_t nw = (n - head) >> 4;
  const int64_t w0 = nw * j / per_row, w1 = nw * (j + 1) / per_row;
  const uint4* dw = reinterpret_cast<const uint4*>(d + head);
  const uint4 ones = make_uint4(kFull, kFull, kFull, kFull);
  uint4 dv[kUnroll], mv[kUnroll];
  bool ok[kUnroll];
  auto load = [&](int64_t base) {
#pragma unroll
    for (int u = 0; u < kUnroll; u++) {
      const int64_t w = base + u * kThreads + tid;
      ok[u] = w < w1;
      dv[u] = ok[u] ? __ldg(dw + w) : make_uint4(0, 0, 0, 0);
      mv[u] = ok[u] && m ? load_mask(m + head + 16 * w, mask_vec) : ones;
    }
  };
  // the first words are in flight while the histograms are zeroed
  load(w0);
  for (int i = tid; i < kHist / 4; i += kThreads)
    reinterpret_cast<int4*>(hist)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  for (int64_t base = w0; base < w1; base += kThreads * kUnroll) {
    if (base != w0) load(base);
#pragma unroll
    for (int u = 0; u < kUnroll; u++)
      if (ok[u]) count_word(h, dv[u], mv[u]);
  }
  // the head (lanes 0-15) and the tail (lanes 16-31): warp 0 of block 0
  if (j == 0 && tid < 32) {
    const int64_t i = tid < 16 ? tid : head + 16 * nw + (tid - 16);
    if ((tid < 16 ? i < head : i < n) && (m == nullptr || m[i] != 0))
      atomicAdd(h + d[i], 1);
  }
  __syncthreads();

  // the block's sum over its warps' copies, one bin a thread: the row's
  // (partial) counts when the cluster is this one block
  int32_t* o = dst + (row * cpr + j / cs) * kBins;
  const int bin = tid;
  int32_t s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; w++) s += hist[w * kBins + bin];
  if (cs == 1) {
    o[bin] = s;
    return;
  }
  // block q of the cluster owns bins [q*256/cs, (q+1)*256/cs): each block
  // stores its sum of a bin into the owner's stage[rank][bin], then one
  // barrier, then each owner adds its bins' cs entries and stores them.
  // Nothing reads another block's shared memory after that barrier.
  cg::cluster_group cluster = cg::this_cluster();
  const int r = static_cast<int>(cluster.block_rank());
  const int owner = ((bin + 1) * cs - 1) / kBins;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  cluster.map_shared_rank(stage, owner)[r * kBins + bin] = s;
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  if (bin >= r * kBins / cs && bin < (r + 1) * kBins / cs) {
    int32_t t = 0;
    for (int q = 0; q < cs; q++) t += stage[q * kBins + bin];
    o[bin] = t;
  }
}

// out[row][bin] = sum over the row's cpr partial rows of scratch: four
// threads a bin, each over every fourth partial row, so that a thread's
// loads are few and in flight together.
constexpr int kReduceThreads = 4 * kBins;

__global__ void __launch_bounds__(kReduceThreads) reduce_kernel(
    const int32_t* __restrict__ part, int cpr, int32_t* __restrict__ out) {
  __shared__ int32_t sums[kReduceThreads];
  const int64_t row = blockIdx.x;
  const int bin = threadIdx.x % kBins;
  int32_t s = 0;
#pragma unroll 8
  for (int c = threadIdx.x / kBins; c < cpr; c += kReduceThreads / kBins)
    s += part[(row * cpr + c) * kBins + bin];
  sums[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x < kBins)
    out[row * kBins + bin] = sums[bin] + sums[bin + kBins] +
                             sums[bin + 2 * kBins] + sums[bin + 3 * kBins];
}

__global__ void empty_kernel(int) {}

// Launches `kernel` on b * cs * cpr blocks of `threads` in clusters of cs.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int b, int cs, int cpr,
                            int threads, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(static_cast<long long>(b) * cs *
                                           cpr));
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1 ? 1 : 0;  // a block alone needs no cluster
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

bool bad_shape(int b, int cs, int cpr) {
  return b <= 0 || cs < 1 || cs > kMaxCluster || cpr < 1 ||
         static_cast<long long>(b) * cs * cpr > 0x7FFFFFFFLL;
}

// The launch's own error, else the first error the runtime recorded; either
// way the runtime's last error is cleared, so that a refused launch does
// not surface in a later, unrelated check.
int finish(cudaError_t rc) {
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(rc != cudaSuccess ? rc : last);
}

}  // namespace

// Histogram rows of `data` (uint8 [b, n], row-major) into out (int32
// [b, 256]; every entry is written) on `stream`: b * cpr clusters of cs
// blocks, cs in [1, 8], and when cpr > 1 `scratch` (int32 [b, cpr, 256])
// holds the partial rows that a second kernel sums.  `mask` is null or a
// uint8 [b, n] gate (bool tensors store 0/1 bytes).  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int zt_histogram(const void* data, const void* mask, int b,
                            long long n, void* out, void* scratch, int cs,
                            int cpr, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  if (bad_shape(b, cs, cpr) || (cpr > 1 && scratch == nullptr))
    return cudaErrorInvalidValue;
  const bool mask_vec = mask != nullptr &&
      ((reinterpret_cast<uintptr_t>(mask) - reinterpret_cast<uintptr_t>(data))
       & 15) == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  int32_t* dst = static_cast<int32_t*>(cpr > 1 ? scratch : out);
  cudaError_t rc = launch_clusters(
      histogram_kernel, b, cs, cpr, kThreads, s,
      static_cast<const uint8_t*>(data),
      static_cast<const uint8_t*>(mask), static_cast<int64_t>(n), cs * cpr,
      cpr, mask_vec, dst);
  if (rc == cudaSuccess && cpr > 1)
    rc = launch_clusters(reduce_kernel, b, 1, 1, kReduceThreads, s,
                         static_cast<const int32_t*>(scratch), cpr,
                         static_cast<int32_t*>(out));
  return finish(rc);
}

// The launch floor: empty kernels with zt_histogram's grids, cluster shape
// and block size (the reduce kernel's grid too when cpr > 1).
extern "C" int zt_histogram_floor(int b, int cs, int cpr, void* stream) {
  if (bad_shape(b, cs, cpr)) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = launch_clusters(empty_kernel, b, cs, cpr, kThreads, s, 0);
  if (rc == cudaSuccess && cpr > 1)
    rc = launch_clusters(empty_kernel, b, 1, 1, kReduceThreads, s, 0);
  return finish(rc);
}
