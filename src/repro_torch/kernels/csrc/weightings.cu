// Fused multi-predicate weightings (§5.3, Eq. 28) for Hopper.
//
// Replaces the TPU kernels src/repro/kernels/weightings/weightings.py ::
// batched_weightings_pallas (_batched_kernel) and :: fused_weightings_pallas
// (_kernel); the single-query entry is the Q = 1 launch of this kernel.
//
//   out[q, k] = prod_l  p[q, l, idx[l, k]]      (0 where idx[l, k] is not
//                                                 in [0, K2), e.g. -1)
//   p[q, l, a] = clip(v / max(hx[l, a], 1e-30), 0, 1)
//   v          = sum_b H[l, a, b] * beta[q, l, b]
//
// The TPU kernels take a dense (L, K1, K2) fold and multiply by it; the fold
// is one-hot by construction, so here it travels as its (L, K1) column
// index and the product is a gather, equal bit for bit (p >= 0 is finite,
// the only nonzero term is p * 1).
//
// What bounds it on this card: the work is tiny (2 * Q * L * K2^2 fp32
// operations, a few MB at the build caps K2 <= 256, K1 <= 512) against
// 67 TFLOP/s and 3.35 TB/s, so neither bytes nor operations do: latency
// does, the number of dependent trips to L2/device memory and of launches.
// fp32 stays IEEE (no TF32, no fast-math division): the results are held to
// the reference at rtol 1e-5.
//
// Design: two phases.
//
//  * Phase A: a grid of (tile of TR rows of the (L * K2, K2) stack, tile of
//    TQ queries) blocks writes p into a scratch (Q, L, K2) buffer that the
//    caller provides. Each block issues all of its loads at once as
//    cp.async (16 bytes a thread, a 4-byte head and tail for unaligned runs
//    such as K2 = 49 rows) and waits once, then computes from shared
//    memory: row (l, a) of H is read by one warp along b, and each lane
//    keeps a register tile of TQ queries, so H is read once per query tile,
//    not once per query. K2 is staged in chunks of 256 columns (one round
//    trip at K2 <= 256). Tiles are small enough (ops.py::_plan) that even a
//    single query spreads over many SMs.
//  * Phase B gathers p through the index and multiplies over l. Where a
//    query tile has at most one output a thread (the single queries of the
//    main path), the last block of the tile to finish phase A does it in
//    the same launch (a __threadfence and an atomic ticket per query tile,
//    which that block resets to 0); otherwise a second launch does it, one
//    thread per (q, k). Measured on the card, the fused tail saves a launch
//    where it is short and costs up to 3x where one block would loop over
//    thousands of outputs (see PERF.md).
//
// A variant in which one block per query tile held the whole stack of the
// main path in shared memory was slower on the card at every shape tried.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;       // H columns staged per round trip
constexpr int kMaxDevices = 64;

// Floats of a staged run of n values: a 16-byte multiple plus room for the
// shift that makes it congruent with its source modulo 16 bytes.
__host__ __device__ constexpr long long run_floats(long long n) {
  return ((n + 3) & ~3LL) + 4;
}

__device__ __forceinline__ int shift4(const void* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

// Issue (without waiting) the copy of n 4-byte values from src to dst by
// the `size` threads of a group, `rank` being this thread's. dst must be
// congruent with src modulo 16 bytes: the caller places each run at
// region + shift4(src) in a 16-byte aligned region of run_floats(n).
__device__ __forceinline__ void copy_run(void* dst, const void* src, int n,
                                         int rank, int size) {
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(dst);
  int head = (int)(((16 - (reinterpret_cast<uintptr_t>(s) & 15)) & 15) >> 2);
  if (head > n) head = n;
  const int nv = (n - head) >> 2;
  const int tail = head + 4 * nv;
  for (int i = rank; i < nv; i += size)
    cp_async16(d + 4 * (head + 4 * i), s + 4 * (head + 4 * i));
  const int ns = head + (n - tail);            // at most 6 scalars
  for (int i = rank; i < ns; i += size) {
    const int j = i < head ? i : tail + (i - head);
    cp_async4(d + 4 * j, s + 4 * j);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

// One warp: sums[q] = sum_{b < n} h[b] * bq[q][b] for q < TQ, reduced
// across the warp (every lane holds every sum).
template <int TQ>
__device__ __forceinline__ void row_dot(const float* h, const float* const* bq,
                                        int n, int lane, float* sums) {
#pragma unroll
  for (int q = 0; q < TQ; ++q) sums[q] = 0.0f;
  for (int b = lane; b < n; b += 32) {
    const float hv = h[b];
#pragma unroll
    for (int q = 0; q < TQ; ++q) sums[q] = fmaf(hv, bq[q][b], sums[q]);
  }
#pragma unroll
  for (int q = 0; q < TQ; ++q) sums[q] = warp_sum(sums[q]);
}

// ------------------------------------------------------------ kernel

__host__ __device__ constexpr int chunk_stride(int K2) {
  return (int)run_floats(K2 < kChunk ? K2 : kChunk);
}

// Beta slices (l) that a tile of tr consecutive stack rows can touch.
__host__ __device__ constexpr int tile_slices(int L, int K2, int tr) {
  return (tr - 1) / K2 + 2 < L ? (tr - 1) / K2 + 2 : L;
}

__host__ __device__ constexpr int rows_smem_floats(int L, int K2, int tq,
                                                   int tr) {
  return tr * chunk_stride(K2) + tq * tile_slices(L, K2, tr) * chunk_stride(K2)
         + (int)run_floats(tr) + tq * tr;
}

// Phase B for one (q, k): prod_l p[q, l, idx[l, k]], 0 for an index
// outside [0, K2). p is read through L2 (written by other blocks).
__device__ __forceinline__ float fold_product(const float* pq, const int* idx,
                                              int L, int K1, int K2, int k) {
  float prod = 1.0f;
  for (int l = 0; l < L; ++l) {
    const int j = __ldg(idx + l * K1 + k);
    prod *= (j >= 0 && j < K2) ? __ldcg(pq + l * K2 + j) : 0.0f;
  }
  return prod;
}

// Phase A: p[q, r] for the block's rows r in [r0, r0 + nr) of the
// (L * K2, K2) stack and its queries q in [q0, q0 + nq); then, given
// tickets, phase B for those queries in the tile's last block.
template <int TQ>
__global__ void __launch_bounds__(kThreads)
weightings_kernel(const float* __restrict__ H, const float* __restrict__ beta,
                  const int* __restrict__ idx, const float* __restrict__ hx,
                  float* __restrict__ p, float* __restrict__ out,
                  int* __restrict__ tickets, int L, int Q, int K1, int K2,
                  int tr) {
  extern __shared__ __align__(16) float smem[];
  const int R = L * K2;
  const int r0 = blockIdx.x * tr, nr = min(tr, R - r0);
  const int q0 = blockIdx.y * TQ, nq = min(TQ, Q - q0);
  const int l_lo = r0 / K2, nl = (r0 + nr - 1) / K2 - l_lo + 1;
  const int ns = tile_slices(L, K2, tr);
  const int cs = chunk_stride(K2);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float* hs = smem;                           // (tr, cs) rows of H
  float* bs = hs + tr * cs;                   // (TQ, ns, cs) beta slices
  float* hx_reg = bs + TQ * ns * cs;          // hx of the block's rows
  float* acc = hx_reg + run_floats(tr);       // (TQ, tr) partial sums
  const float* hxs = hx_reg + shift4(hx + r0);

  copy_run(const_cast<float*>(hxs), hx + r0, nr, tid, kThreads);
  for (int i = tid; i < TQ * tr; i += kThreads) acc[i] = 0.0f;

  for (int c0 = 0; c0 < K2; c0 += kChunk) {
    const int bc = min(kChunk, K2 - c0);
    for (int rr = warp; rr < nr; rr += kWarps) {
      const float* src = H + (size_t)(r0 + rr) * K2 + c0;
      copy_run(hs + rr * cs + shift4(src), src, bc, lane, 32);
    }
    for (int j = warp; j < nq * nl; j += kWarps) {
      const int q = j / nl, li = j - q * nl;
      const float* src = beta + ((size_t)(q0 + q) * L + l_lo + li) * K2 + c0;
      copy_run(bs + (q * ns + li) * cs + shift4(src), src, bc, lane, 32);
    }
    cp_async_wait_all();
    __syncthreads();

    for (int rr = warp; rr < nr; rr += kWarps) {
      const int r = r0 + rr, li = r / K2 - l_lo;
      const float* hrow = H + (size_t)r * K2 + c0;
      const float* bl[TQ];
#pragma unroll
      for (int q = 0; q < TQ; ++q) {          // queries past nq alias q = 0
        const int qq = q < nq ? q : 0;
        const float* src = beta + ((size_t)(q0 + qq) * L + l_lo + li) * K2 + c0;
        bl[q] = bs + (qq * ns + li) * cs + shift4(src);
      }
      float sums[TQ];
      row_dot<TQ>(hs + rr * cs + shift4(hrow), bl, bc, lane, sums);
#pragma unroll
      for (int q = 0; q < TQ; ++q)
        if (lane == q && q < nq) acc[q * tr + rr] += sums[q];
    }
    __syncthreads();                          // before the next chunk's loads
  }

  for (int i = tid; i < nq * nr; i += kThreads) {
    const int q = i / nr, rr = i - q * nr;
    const float v = acc[q * tr + rr] / fmaxf(hxs[rr], 1e-30f);
    p[(size_t)(q0 + q) * R + r0 + rr] = clip01(v);
  }

  if (tickets == nullptr) return;             // phase B is launched apart

  // Phase B, by the last block of this query tile to finish phase A.
  __shared__ int last;
  __threadfence();                            // this block's p, device-wide
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(&tickets[blockIdx.y], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < nq * K1; i += kThreads) {
    const int q = i / K1, k = i - q * K1;
    out[(size_t)(q0 + q) * K1 + k] =
        fold_product(p + (size_t)(q0 + q) * R, idx, L, K1, K2, k);
  }
  if (tid == 0) tickets[blockIdx.y] = 0;      // ready for the next launch
}

// Phase B as its own launch: one thread per (q, k).
__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ p, const int* __restrict__ idx,
              float* __restrict__ out, int L, int Q, int K1, int K2) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)Q * K1) return;
  const int q = (int)(i / K1), k = (int)(i - (long long)q * K1);
  out[i] = fold_product(p + (size_t)q * L * K2, idx, L, K1, K2, k);
}

// ---------------------------------------------------------------- launcher

#define FOR_EACH_TQ(X) X(1) X(2) X(4) X(8) X(16)

// Raise every kernel's dynamic shared-memory ceiling to what the device
// allows a block beside the kernel's static shared memory, once per device,
// and give the least of these ceilings in bytes; returns a CUDA error code.
int configure(int* max_smem) {
  static int configured[kMaxDevices];         // 0: not yet, else max + 1
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices && configured[dev] > 0) {
    *max_smem = configured[dev] - 1;
    return 0;
  }
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  int least = optin;
  cudaFuncAttributes fa;
  const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
#define SET(T)                                                             \
  if ((err = cudaFuncGetAttributes(&fa, weightings_kernel<T>)) !=         \
          cudaSuccess ||                                                  \
      (err = cudaFuncSetAttribute(weightings_kernel<T>, a,                \
                                  optin - (int)fa.sharedSizeBytes)) !=    \
          cudaSuccess)                                                    \
    return (int)err;                                                      \
  if (optin - (int)fa.sharedSizeBytes < least)                            \
    least = optin - (int)fa.sharedSizeBytes;
  FOR_EACH_TQ(SET)
#undef SET
  if (dev < kMaxDevices) configured[dev] = least + 1;
  *max_smem = least;
  return 0;
}

}  // namespace

// H (L, K2, K2), beta (Q, L, K2), idx (L, K1) int32, hx (L, K2), out (Q, K1)
// and the scratch p (Q, L, K2) fp32: contiguous, on the device of `stream`;
// L, Q, K1, K2 >= 1. tq (queries a block) is 1, 2, 4, 8 or 16; tr (stack
// rows a block) is at least 1. With tickets (one int32 per query tile, 0
// before the launch and 0 again after it) phase B runs in the same launch;
// with tickets null, in a second one.
extern "C" int weightings_launch(const void* H, const void* beta,
                                 const void* idx, const void* hx, void* out,
                                 void* p, void* tickets, int L, int Q, int K1,
                                 int K2, int tq, int tr, void* stream) {
  if (L < 1 || Q < 1 || K1 < 1 || K2 < 1 || tr < 1 || p == nullptr ||
      (tq != 1 && tq != 2 && tq != 4 && tq != 8 && tq != 16))
    return (int)cudaErrorInvalidValue;
  int max_smem = 0;
  const int status = configure(&max_smem);
  if (status != 0) return status;
  const size_t smem = (size_t)rows_smem_floats(L, K2, tq, tr) * 4;
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long rows = (long long)L * K2;
  const dim3 grid((unsigned)((rows + tr - 1) / tr),
                  (unsigned)((Q + tq - 1) / tq));
#define LAUNCH(T)                                                         \
  if (tq == T)                                                            \
    weightings_kernel<T><<<grid, kThreads, smem, s>>>(                    \
        (const float*)H, (const float*)beta, (const int*)idx,             \
        (const float*)hx, (float*)p, (float*)out, (int*)tickets, L, Q, K1, \
        K2, tr);
  FOR_EACH_TQ(LAUNCH)
#undef LAUNCH
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tickets != nullptr) return (int)err;
  const long long n = (long long)Q * K1;
  gather_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      (const float*)p, (const int*)idx, (float*)out, L, Q, K1, K2);
  return (int)cudaGetLastError();
}
