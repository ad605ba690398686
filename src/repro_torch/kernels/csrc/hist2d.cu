// One weighted 2-D histogram, for Hopper.
//
// Replaces the TPU kernel
//   src/repro/kernels/hist2d/hist2d.py :: hist2d_pallas (_kernel)
//     H[a, b] = sum_n w[n] [clip(bi[n]) = a][clip(bj[n]) = b]
// The TPU turns each tile of 1024 rows into two one-hot matrices and adds
// their product into an accumulator that stays in VMEM for the whole grid:
// scatters serialize there, so the histogram became a matrix product. On
// Hopper it is a scatter-add.
//
// What bounds it on this card: it reads 12 bytes per row (int32 bi and bj,
// fp32 w) and writes KI * KJ fp32 counts, with one addition per row, so
// device memory bounds it: 1.46 MB at 100,000 rows into 256 x 256 bins
// (0.44 us at 3.35 TB/s, far below the cost of a launch) and 120 MB at
// 10,000,000 rows (36 us).
//
// Design: H is cut by its rows into slabs that fit in dynamic shared memory
// (at most 192 KB: 256 x 256 is two slabs of 128 rows, 512 x 512 six of 86,
// and a histogram of at most 49,152 bins is one slab). The grid is (slabs,
// row chunks). Each block zeroes its slab, reads its row chunk coalesced
// (16-byte vector loads when the inputs are aligned), skips rows of weight
// 0 and rows whose clipped bi lies outside its slab, adds the rest with
// shared-memory atomics and flushes its non-zero bins with global atomics
// into the output, which the wrapper zeroed. Slabs are the fastest grid
// index, so the blocks of one chunk run together and all but the first
// find the chunk in L2. The number of chunks fills the card (resident
// blocks per SM times SMs) but keeps at least kMinRows rows per block, so
// zeroing and flushing a slab stays small against the rows it counts.
// Indices are clipped into [0, k-1], as the plain version does; the TPU
// kernel drops out-of-range rows instead, and the two agree on rows of
// weight 0, which the contract requires of such rows. Accumulation is fp32,
// as on the TPU: counts of 0/1 weights are exact integers below 2^24 in any
// order of addition.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSlabBins = 49152;   // 192 KB of fp32
constexpr int kMinRows = 4096;        // rows per block, at least
constexpr int kMaxDevices = 64;

__device__ __forceinline__ int clip_index(int v, int k) {
  return v < 0 ? 0 : (v >= k ? k - 1 : v);
}

__device__ __forceinline__ void add_row(float* slab, int a, int b, float wt,
                                        int KI, int KJ, int row0, int rows) {
  if (wt == 0.0f) return;
  const int r = clip_index(a, KI) - row0;
  if (r < 0 || r >= rows) return;
  atomicAdd(&slab[r * KJ + clip_index(b, KJ)], wt);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
hist2d_kernel(const int* __restrict__ bi, const int* __restrict__ bj,
              const float* __restrict__ w, float* __restrict__ out,
              long long N, int KI, int KJ, int slab_rows,
              long long rows_per_block) {
  extern __shared__ float slab[];
  const int row0 = blockIdx.x * slab_rows;
  const int rows = min(slab_rows, KI - row0);
  const int nbins = rows * KJ;
  for (int i = threadIdx.x; i < nbins; i += kThreads) slab[i] = 0.0f;
  __syncthreads();

  const long long start = (long long)blockIdx.y * rows_per_block;
  const long long stop = min(N, start + rows_per_block);
  long long n = start + threadIdx.x;
  if (kVec) {
    // start is a multiple of 4 (so is rows_per_block): whole quads first.
    const int4* bi4 = reinterpret_cast<const int4*>(bi);
    const int4* bj4 = reinterpret_cast<const int4*>(bj);
    const float4* w4 = reinterpret_cast<const float4*>(w);
    const long long q_stop = stop / 4;
    for (long long q = start / 4 + threadIdx.x; q < q_stop; q += kThreads) {
      const int4 a = __ldg(bi4 + q);
      const int4 b = __ldg(bj4 + q);
      const float4 c = __ldg(w4 + q);
      add_row(slab, a.x, b.x, c.x, KI, KJ, row0, rows);
      add_row(slab, a.y, b.y, c.y, KI, KJ, row0, rows);
      add_row(slab, a.z, b.z, c.z, KI, KJ, row0, rows);
      add_row(slab, a.w, b.w, c.w, KI, KJ, row0, rows);
    }
    n = q_stop * 4 + threadIdx.x;   // the last block's ragged tail
  }
  for (; n < stop; n += kThreads)
    add_row(slab, __ldg(bi + n), __ldg(bj + n), __ldg(w + n), KI, KJ, row0,
            rows);
  __syncthreads();

  float* dst = out + (size_t)row0 * KJ;
  for (int i = threadIdx.x; i < nbins; i += kThreads) {
    const float v = slab[i];
    if (v != 0.0f) atomicAdd(&dst[i], v);
  }
}

using Kernel = void (*)(const int*, const int*, const float*, float*,
                        long long, int, int, int, long long);

cudaError_t sm_count(int* sms) {
  static int cache[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cache[dev] > 0) {
    *sms = cache[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kMaxDevices) cache[dev] = *sms;
  return err;
}

}  // namespace

// bi, bj (N,) int32; w (N,) fp32; out (KI * KJ,) fp32, zeroed. All
// contiguous, on the device of `stream`. N, KI >= 1; 1 <= KJ <= 49,152.
extern "C" int hist2d_launch(const void* bi, const void* bj, const void* w,
                             void* out, long long N, int KI, int KJ,
                             void* stream) {
  if (N < 1 || KI < 1 || KJ < 1 || KJ > kMaxSlabBins)
    return (int)cudaErrorInvalidValue;
  const int rows_fit = kMaxSlabBins / KJ;
  const int n_slabs = (KI + rows_fit - 1) / rows_fit;
  const int slab_rows = (KI + n_slabs - 1) / n_slabs;
  const size_t smem = (size_t)slab_rows * KJ * sizeof(float);
  const bool vec =
      (((uintptr_t)bi | (uintptr_t)bj | (uintptr_t)w) & 15) == 0;
  const Kernel kern = vec ? &hist2d_kernel<true> : &hist2d_kernel<false>;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;

  const long long fill = (long long)(per_sm > 0 ? per_sm : 1) * sms / n_slabs;
  long long chunks = (N + kMinRows - 1) / kMinRows;
  if (chunks > fill) chunks = fill;
  if (chunks < 1) chunks = 1;
  long long rows = (N + chunks - 1) / chunks;
  rows = (rows + 3) / 4 * 4;
  chunks = (N + rows - 1) / rows;
  const dim3 grid((unsigned)n_slabs, (unsigned)chunks);
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)bi, (const int*)bj, (const float*)w, (float*)out, N, KI, KJ,
      slab_rows, rows);
  return (int)cudaGetLastError();
}
