// 256-bin byte histogram of B rows of N bytes, with an optional mask.
//
// Replaces the Pallas kernel zstdsharp_tpu/ops/histogram.py:_hist_kernel
// (reached through histogram_u8_pallas).  It computes what that kernel
// computes, out[b][v] = number of positions i < N of row b with
// data[b][i] == v (and mask[b][i] != 0 when a mask is given), and is not
// carried over block by block: the Pallas kernel compares 4096-byte
// sub-steps against an iota because a TPU scatter is slow, while Hopper has
// fast shared-memory atomics.
//
// What bounds it on the H100: each input byte is read once (memory traffic
// of N bytes, plus N mask bytes), and the atomics into 256 bins.  Literal
// bytes of text put most hits on a few bins, so one shared histogram per
// block would serialise a warp's threads on the same address.  Each warp
// therefore counts into its own 256-bin copy in shared memory (8 KB for 8
// warps); at the end the block sums its copies per bin and adds each
// non-zero bin to the row's global histogram with one atomicAdd.  Integer
// atomics make the result independent of the order of blocks.
//
// The grid covers (slices of kChunk bytes) x (rows); `out` must be zeroed
// by the caller.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kPerThread = 16;
constexpr int kChunk = kThreads * kPerThread;  // bytes per block

__global__ void __launch_bounds__(kThreads) histogram_kernel(
    const uint8_t* __restrict__ data, const uint8_t* __restrict__ mask,
    int64_t n, int32_t* __restrict__ out) {
  __shared__ int32_t hist[kWarps * kBins];
  const int tid = threadIdx.x;
  for (int i = tid; i < kWarps * kBins; i += kThreads) hist[i] = 0;
  __syncthreads();

  const int64_t row = blockIdx.y;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kChunk;
  const uint8_t* d = data + row * n;
  const uint8_t* m = mask ? mask + row * n : nullptr;
  int32_t* h = hist + (tid / 32) * kBins;
  // neighbouring threads read neighbouring bytes
#pragma unroll
  for (int k = 0; k < kPerThread; k++) {
    const int64_t i = base + k * kThreads + tid;
    if (i < n && (m == nullptr || m[i] != 0)) atomicAdd(h + d[i], 1);
  }
  __syncthreads();

  for (int bin = tid; bin < kBins; bin += kThreads) {
    int32_t s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; w++) s += hist[w * kBins + bin];
    if (s != 0) atomicAdd(out + row * kBins + bin, s);
  }
}

}  // namespace

// Histogram rows of `data` (uint8 [b, n], row-major) into out (int32
// [b, 256], zeroed by the caller) on `stream`.  `mask` is null or a uint8
// [b, n] gate (bool tensors store 0/1 bytes).  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int zt_histogram(const void* data, const void* mask, int b,
                            long long n, void* out, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  const long long slices = (n + kChunk - 1) / kChunk;
  if (slices > 0x7FFFFFFFLL || b > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(slices), static_cast<unsigned>(b));
  histogram_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const uint8_t*>(mask), n,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
