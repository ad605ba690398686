// Pair-batched weighted histogram over a flat id, for Hopper.
//
// Replaces two TPU kernels that are the same function on this card:
//   src/repro/kernels/hist2d/hist2d.py :: batched_hist2d_pallas (_batched_kernel)
//     out[p, a, b] = sum_n w[p, n] [clip(bi) = a][clip(bj) = b]   (KA = KI, KB = KJ)
//   src/repro/kernels/subbin/subbin.py :: batched_subbin_hist_pallas (_batched_kernel)
//     out[p, c, r] = sum_n w[p, n] [clip(cell) = c][clip(sub) = r] (KA = ncell, KB = s_max)
// The flat id is clip(a, 0, KA-1) * KB + clip(b, 0, KB-1).
//
// What bounds it on this card: it reads 8 + 8 + 4-or-8 bytes per row and
// writes P * KA * KB counts, with one addition per row, so device memory
// bounds it. The TPU built each histogram as a one-hot matrix product on the
// MXU because scatters serialize there; on Hopper a histogram is a
// scatter-add, so the one-hot matrices and the base-128 digit split of the
// sub-bin ids are gone.
//
// Design: grid (row chunks, P). When a pair's histogram fits in 64 KB of
// shared memory (KA * KB <= 16384: the 2-D counts up to k2 = 128) each
// block keeps a private fp32 copy, adds into it with shared-memory atomics
// and flushes its non-zero bins with global atomics. Larger histograms (2-D
// counts at k2 = 256, every sub-bin histogram) add with global atomics
// straight into the zeroed output. Rows of weight 0 (nulls, padding) are
// skipped. Accumulation is fp32, as on the TPU: counts of 0/1 weights are
// exact integers below 2^24 in any order of addition. Indices are read as
// int64, PyTorch's index type, so the wrapper casts nothing.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedBins = 16384;      // 64 KB of fp32
constexpr int kRowsGlobal = 4096;       // rows per block, global atomics

__device__ __forceinline__ int clip_index(int64_t v, int k) {
  return v < 0 ? 0 : (v >= k ? k - 1 : (int)v);
}

template <typename W, bool kShared>
__global__ void __launch_bounds__(kThreads)
flat_hist_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                 const W* __restrict__ w, float* __restrict__ out, int N,
                 int KA, int KB, int rows_per_block) {
  extern __shared__ float hist[];
  const int p = blockIdx.y;
  const int nbins = KA * KB;
  const size_t row0 = (size_t)p * N;
  float* plane = out + (size_t)p * nbins;

  if (kShared) {
    for (int i = threadIdx.x; i < nbins; i += kThreads) hist[i] = 0.0f;
    __syncthreads();
  }
  const int start = blockIdx.x * rows_per_block;
  const int stop = min(N, start + rows_per_block);
  for (int n = start + threadIdx.x; n < stop; n += kThreads) {
    const float wt = (float)w[row0 + n];
    if (wt == 0.0f) continue;
    const int id = clip_index(a[row0 + n], KA) * KB + clip_index(b[row0 + n], KB);
    if (kShared)
      atomicAdd(&hist[id], wt);
    else
      atomicAdd(&plane[id], wt);
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < nbins; i += kThreads) {
      const float v = hist[i];
      if (v != 0.0f) atomicAdd(&plane[i], v);
    }
  }
}

template <typename W>
int launch(const void* a, const void* b, const void* w, void* out, int P,
           int N, int KA, int KB, void* stream) {
  const int nbins = KA * KB;
  const cudaStream_t s = (cudaStream_t)stream;
  if (nbins <= kSharedBins) {
    // Enough rows per block that zeroing and flushing the private copy
    // stays small against the rows it counts.
    const int rows = max(kRowsGlobal, 2 * nbins);
    const dim3 grid((N + rows - 1) / rows, P);
    const size_t smem = (size_t)nbins * sizeof(float);
    auto kern = flat_hist_kernel<W, true>;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    kern<<<grid, kThreads, smem, s>>>((const int64_t*)a, (const int64_t*)b,
                                      (const W*)w, (float*)out, N, KA, KB,
                                      rows);
  } else {
    const dim3 grid((N + kRowsGlobal - 1) / kRowsGlobal, P);
    flat_hist_kernel<W, false><<<grid, kThreads, 0, s>>>(
        (const int64_t*)a, (const int64_t*)b, (const W*)w, (float*)out, N, KA,
        KB, kRowsGlobal);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// a, b (P, N) int64; w (P, N) fp32 or fp64; out (P, KA * KB) fp32, zeroed.
// All contiguous, on the device of `stream`. P, N, KA, KB >= 1.
extern "C" int flat_hist_f32(const void* a, const void* b, const void* w,
                             void* out, int P, int N, int KA, int KB,
                             void* stream) {
  return launch<float>(a, b, w, out, P, N, KA, KB, stream);
}

extern "C" int flat_hist_f64(const void* a, const void* b, const void* w,
                             void* out, int P, int N, int KA, int KB,
                             void* stream) {
  return launch<double>(a, b, w, out, P, N, KA, KB, stream);
}
