// Fused multi-predicate weightings (§5.3, Eq. 28) for Hopper.
//
// Replaces the TPU kernels src/repro/kernels/weightings/weightings.py ::
// batched_weightings_pallas (_batched_kernel) and :: fused_weightings_pallas
// (_kernel); the single-query entry is the Q = 1 launch of this kernel.
//
//   out[q, k] = prod_l  sum_a fold[l, k, a] * clip(v[a] / max(hx[l, a], 1e-30), 0, 1)
//   v[a]      = sum_b H[l, a, b] * beta[q, l, b]
//
// What bounds it on this card: per query the whole (L, K2, K2) H stack and
// the (L, K1, K2) fold stack are read, 2 * L * (K2^2 + K1 * K2) fp32
// operations. At serving sizes (K2 <= 256, K1 <= 512, L <= 5) the unique
// bytes are a few MB and stay in the 50 MB L2 across the Q blocks, so the
// fp32 CUDA-core rate bounds it, not device memory. fp32 stays IEEE here
// (no TF32, no fast-math division): the results are held to the reference
// at rtol 1e-5.
//
// Design: one block per query row q. The TPU grid's sequential l axis
// becomes a loop inside the block, with the (K1,) running product kept in
// shared memory (the TPU kept it in VMEM across grid steps). For each l the
// block stages beta[q, l, :] in shared memory; each warp takes rows a of H
// and reads them coalesced along b, reducing with shuffles, and writes
// p_row[a] to shared memory; then each warp takes rows k of the dense fold
// the same way and multiplies the dot product into acc[k]. The TPU's
// 128-lane padding is not needed: any K1, K2 works.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

__global__ void __launch_bounds__(kThreads)
weightings_kernel(const float* __restrict__ H, const float* __restrict__ beta,
                  const float* __restrict__ fold, const float* __restrict__ hx,
                  float* __restrict__ out, int L, int K1, int K2) {
  extern __shared__ float smem[];
  float* acc = smem;            // (K1,) running product over l
  float* bvec = smem + K1;      // (K2,) beta[q, l, :]
  float* prow = bvec + K2;      // (K2,) clip(H_l beta / hx_l, 0, 1)
  const int q = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int k = threadIdx.x; k < K1; k += kThreads) acc[k] = 1.0f;
  for (int l = 0; l < L; ++l) {
    const float* b = beta + ((size_t)q * L + l) * K2;
    for (int j = threadIdx.x; j < K2; j += kThreads) bvec[j] = b[j];
    __syncthreads();

    const float* Hl = H + (size_t)l * K2 * K2;
    const float* hxl = hx + (size_t)l * K2;
    for (int a = warp; a < K2; a += kWarps) {
      const float* row = Hl + (size_t)a * K2;
      float s = 0.0f;
      for (int j = lane; j < K2; j += 32) s += row[j] * bvec[j];
      s = warp_sum(s);
      if (lane == 0) {
        const float p = s / fmaxf(hxl[a], 1e-30f);
        prow[a] = fminf(fmaxf(p, 0.0f), 1.0f);
      }
    }
    __syncthreads();

    const float* Fl = fold + (size_t)l * K1 * K2;
    for (int k = warp; k < K1; k += kWarps) {
      const float* row = Fl + (size_t)k * K2;
      float s = 0.0f;
      for (int j = lane; j < K2; j += 32) s += row[j] * prow[j];
      s = warp_sum(s);
      if (lane == 0) acc[k] *= s;   // row k belongs to one warp for every l
    }
    // The next l overwrites bvec (last read before the previous barrier)
    // and then waits at its barrier before touching prow.
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K1; k += kThreads) out[(size_t)q * K1 + k] = acc[k];
}

}  // namespace

// H (L, K2, K2), beta (Q, L, K2), fold (L, K1, K2), hx (L, K2), out (Q, K1):
// all fp32, contiguous, on the device of `stream`. Q, K1, K2 >= 1.
extern "C" int weightings_launch(const void* H, const void* beta,
                                 const void* fold, const void* hx, void* out,
                                 int L, int Q, int K1, int K2, void* stream) {
  const size_t smem = (size_t)(K1 + 2 * K2) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        weightings_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  weightings_kernel<<<Q, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)H, (const float*)beta, (const float*)fold,
      (const float*)hx, (float*)out, L, K1, K2);
  return (int)cudaGetLastError();
}
