// One weighted 2-D histogram, for Hopper.
//
// Replaces the TPU kernel
//   src/repro/kernels/hist2d/hist2d.py :: hist2d_pallas (_kernel)
//     H[a, b] = sum_n w[n] [clip(bi[n]) = a][clip(bj[n]) = b]
// The TPU turns each tile of 1024 rows into two one-hot matrices and adds
// their product into an accumulator that stays in VMEM for the whole grid:
// scatters serialize there, so the histogram became a matrix product. On
// Hopper it is a scatter-add into shared memory.
//
// What bounds it on this card: it reads 12 bytes per row (int32 bi and bj,
// fp32 w) and writes KI * KJ fp32 counts, with one addition per row, so
// device memory bounds it: 1.46 MB at 100,000 rows into 256 x 256 bins
// (0.44 us at 3.35 TB/s, far below the cost of a launch) and 120 MB at
// 10,000,000 rows (36 us).
//
// Design. Two paths; the Python planner (kernels/hist2d/ops.py::_plan)
// picks one and every size.
//
//  * Up to 2M rows, no slabs: one cooperative launch of 256-thread blocks.
//    They zero the output, meet at a grid-wide barrier and add their
//    chunks' rows straight into it with one global atomic a row (the rows
//    sit in L2). One device operation a call, no zero-fill launch.
//  * Beyond it, H is cut by its rows into slabs that fit in shared memory
//    (grid x), the rows into chunks (grid y), and a cluster holds cy chunks
//    of one slab. Each 1,024-thread block zeroes its slab, streams its
//    chunk and adds the rows whose clipped bi falls in its slab with
//    shared-memory atomics (latency-bound, so more warps hide more of
//    them). The cy blocks of a slab then sum their partial slabs through
//    distributed shared memory, each its share of the bins, and add the
//    sums into the zeroed output with Hopper's vector reduction (a float4
//    atomicAdd: one red.global.add.v4.f32 a quad with a non-zero count).
//
// Both stream rows with 16-byte loads, four of each array in flight a
// thread before its first add (rows one by one when the three arrays
// differ in their offset modulo 16 bytes); the rows before the first and
// after the last 16-byte boundary, at most six, are added by the first
// chunk's blocks. Rows of weight 0 add nothing.
//
// Measured on the card against this design (PERF.md, section 6): staging
// the rows in a shared-memory ring with the bulk copy engine (cp.async.bulk
// on mbarriers, multicast to the slabs of a cluster so that each row is
// fetched once a cluster) streamed more slowly than 16-byte loads even with
// no adds, and a kernel built on it took twice the time of the kernel it
// was to replace at 10,000,000 rows; slab plans in which one cluster of up
// to 8 chunks covers every row, to store into an empty output, took 2.3x
// the slab-free path at 100,000 rows, so the slab path always adds into a
// zeroed output.
//
// Indices are clipped into [0, k-1], as the plain version does; the TPU
// kernel drops out-of-range rows instead, and the two agree on rows of
// weight 0, which the contract requires of such rows. Accumulation is fp32,
// as on the TPU: counts of 0/1 weights are exact integers below 2^24 in any
// order of addition.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kDirectThreads = 256;   // a block of the slab-free path
constexpr int kUnroll = 4;            // loads of each array in flight
constexpr int kMaxCluster = 8;        // the portable cluster size
constexpr int kMaxSlabBins = 49152;   // one row of 192 KB at most
constexpr int kMaxDevices = 64;

struct Params {
  const int* bi;
  const int* bj;
  const float* w;
  float* out;
  long long N;
  long long n_lo, n_hi;       // the rows of the chunks; the rest are edges
  long long rows_per_chunk;   // a multiple of 4
  int KI, KJ, slab_rows;
  bool vec;                   // rows [n_lo, n_hi) in 16-byte quads
};

__device__ __forceinline__ int clip_index(int v, int k) {
  return v < 0 ? 0 : (v >= k ? k - 1 : v);
}

// Idx is int for a slab (at most 49,152 bins) and long long for the whole
// output, which may hold 2^31 bins or more.
template <typename Idx>
__device__ __forceinline__ void add_row(float* slab, int a, int b, float wt,
                                        int KI, int KJ, int row0, int rows) {
  if (wt == 0.0f) return;
  const unsigned r = (unsigned)(clip_index(a, KI) - row0);
  if (r >= (unsigned)rows) return;
  atomicAdd(&slab[(Idx)r * KJ + clip_index(b, KJ)], wt);
}

// Rows [c0, c1) into the slab. A thread issues its next kUnroll loads of
// each array before its first add (past the end, it loads nothing and adds
// weight 0), so a chunk of a few rows a thread costs one load latency. The
// loads alone hold 48 of the 64 registers a thread of a 1,024-thread block
// has, so the quads are walked by stepping the pointers: a 64-bit index
// and bound beside them spilled to local memory inside the loop.
template <bool kVec, int kBlock, typename Idx>
__device__ __forceinline__ void add_chunk(const Params& p, float* slab,
                                          long long c0, long long c1,
                                          int row0, int rows) {
  const int tid = threadIdx.x;
  if (kVec) {                 // c0 and c1 - c0 are multiples of 4 rows
    const int4* A = reinterpret_cast<const int4*>(p.bi + c0) + tid;
    const int4* B = reinterpret_cast<const int4*>(p.bj + c0) + tid;
    const float4* W = reinterpret_cast<const float4*>(p.w + c0) + tid;
    constexpr int kStep = kUnroll * kBlock;
    for (long long left = (c1 - c0) / 4 - tid; left > 0;
         left -= kStep, A += kStep, B += kStep, W += kStep) {
      int4 a[kUnroll], b[kUnroll];
      float4 c[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool in = u * kBlock < left;
        a[u] = in ? __ldg(A + u * kBlock) : make_int4(0, 0, 0, 0);
        b[u] = in ? __ldg(B + u * kBlock) : make_int4(0, 0, 0, 0);
        c[u] = in ? __ldg(W + u * kBlock) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        add_row<Idx>(slab, a[u].x, b[u].x, c[u].x, p.KI, p.KJ, row0, rows);
        add_row<Idx>(slab, a[u].y, b[u].y, c[u].y, p.KI, p.KJ, row0, rows);
        add_row<Idx>(slab, a[u].z, b[u].z, c[u].z, p.KI, p.KJ, row0, rows);
        add_row<Idx>(slab, a[u].w, b[u].w, c[u].w, p.KI, p.KJ, row0, rows);
      }
    }
  } else {
    for (long long n = c0 + tid; n < c1; n += kUnroll * kBlock) {
      int a[kUnroll], b[kUnroll];
      float c[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long j = n + u * kBlock;
        a[u] = j < c1 ? __ldg(p.bi + j) : 0;
        b[u] = j < c1 ? __ldg(p.bj + j) : 0;
        c[u] = j < c1 ? __ldg(p.w + j) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        add_row<Idx>(slab, a[u], b[u], c[u], p.KI, p.KJ, row0, rows);
    }
  }
}

// Adds v (bins i..i+3 of the slab, of which those below i1 are real) into
// dst + i where non-zero.
__device__ __forceinline__ void add_quad(float* dst, int i, int i1, float4 v) {
  if (i + 4 <= i1) {
    if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
      atomicAdd(reinterpret_cast<float4*>(dst + i), v);
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
  for (int j = 0; j < i1 - i; ++j)
    if (e[j] != 0.f) atomicAdd(dst + i + j, e[j]);
}

__global__ void __launch_bounds__(kThreads, 1) hist2d_kernel(const Params p) {
  extern __shared__ __align__(16) float slab[];
  const int tid = threadIdx.x;
  cg::cluster_group cluster = cg::this_cluster();
  const int cy = cluster.dim_blocks().y;
  const int rank = cluster.block_index().y;

  const int row0 = blockIdx.x * p.slab_rows;
  const int rows = max(0, min(p.slab_rows, p.KI - row0));
  const int nbins = rows * p.KJ;
  float4* slab4 = reinterpret_cast<float4*>(slab);
  for (int i = tid; i < (nbins + 3) / 4; i += kThreads)
    slab4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const long long c0 = p.n_lo + (long long)blockIdx.y * p.rows_per_chunk;
  const long long c1 = min(p.n_hi, c0 + p.rows_per_chunk);
  if (c1 > c0) {
    if (p.vec)
      add_chunk<true, kThreads, int>(p, slab, c0, c1, row0, rows);
    else
      add_chunk<false, kThreads, int>(p, slab, c0, c1, row0, rows);
  }
  if (blockIdx.y == 0) {      // the edges: [0, n_lo) and [n_hi, N)
    const long long a = p.n_lo, b = p.n_hi;
    if (tid < a + (p.N - b)) {
      const long long e = tid < a ? tid : b + (tid - a);
      add_row<int>(slab, __ldg(p.bi + e), __ldg(p.bj + e), __ldg(p.w + e),
                   p.KI, p.KJ, row0, rows);
    }
  }
  cluster.sync();             // every partial slab of the cluster complete

  // This block's share of its slab's bins, summed over the cy partials.
  const int quads = ((nbins + 3) / 4 + cy - 1) / cy;
  const int i0 = min(nbins, rank * quads * 4);
  const int i1 = min(nbins, i0 + quads * 4);
  float* dst = p.out + (size_t)row0 * p.KJ;
  if ((((size_t)row0 * p.KJ) & 3) == 0) {     // dst + i0 on a 16-byte boundary
    for (int i = i0 + 4 * tid; i < i1; i += 4 * kThreads) {
      float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(slab + i, 0));
#pragma unroll
      for (int k = 1; k < kMaxCluster; ++k)
        if (k < cy) {
          const float4 u = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(slab + i, k));
          v.x += u.x;
          v.y += u.y;
          v.z += u.z;
          v.w += u.w;
        }
      add_quad(dst, i, i1, v);
    }
  } else {
    for (int i = i0 + tid; i < i1; i += kThreads) {
      float v = *cluster.map_shared_rank(slab + i, 0);
#pragma unroll
      for (int k = 1; k < kMaxCluster; ++k)
        if (k < cy) v += *cluster.map_shared_rank(slab + i, k);
      if (v != 0.f) atomicAdd(dst + i, v);
    }
  }
  if (cy > 1) cluster.sync();   // no block leaves while read remotely
}

// No slabs, one cooperative launch: the blocks zero the output, meet at a
// grid-wide barrier, then add their chunks' rows straight into it with
// global atomics (the first chunk's blocks also add the edges).
__global__ void __launch_bounds__(kDirectThreads)
    hist2d_direct_kernel(const Params p) {
  const int tid = threadIdx.x;
  const size_t bins = (size_t)p.KI * p.KJ;
  const size_t stride = (size_t)gridDim.y * kDirectThreads;
  float4* out4 = reinterpret_cast<float4*>(p.out);
  for (size_t i = blockIdx.y * kDirectThreads + tid; i < bins / 4; i += stride)
    out4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (blockIdx.y == 0 && tid < (int)(bins % 4)) p.out[bins / 4 * 4 + tid] = 0.f;
  cg::this_grid().sync();

  const long long c0 = p.n_lo + (long long)blockIdx.y * p.rows_per_chunk;
  const long long c1 = min(p.n_hi, c0 + p.rows_per_chunk);
  if (c1 > c0) {
    if (p.vec)
      add_chunk<true, kDirectThreads, long long>(p, p.out, c0, c1, 0, p.KI);
    else
      add_chunk<false, kDirectThreads, long long>(p, p.out, c0, c1, 0, p.KI);
  }
  if (blockIdx.y == 0 && tid < p.n_lo + (p.N - p.n_hi)) {
    const long long e = tid < p.n_lo ? tid : p.n_hi + (tid - p.n_lo);
    add_row<long long>(p.out, __ldg(p.bi + e), __ldg(p.bj + e),
                       __ldg(p.w + e), p.KI, p.KJ, 0, p.KI);
  }
}

// Raise the kernel's dynamic shared-memory ceiling to the device's opt-in
// limit, once per device; gives that limit in bytes.
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
  err = cudaFuncSetAttribute(
      hist2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices) configured[dev] = optin + 1;
  *max_smem = optin;
  return 0;
}

cudaLaunchConfig_t config(dim3 grid, int cy, size_t smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = cy;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// The shared memory a block may use on the current device and its SM
// count; sets the kernel's ceiling there (once a device). Returns a CUDA
// error code.
extern "C" int hist2d_device(int* max_smem, int* sms) {
  const int status = configure(max_smem);
  if (status != 0) return status;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

// How many blocks, in clusters of cy, with `smem` bytes of dynamic shared
// memory each, can be resident on the current device at once; with cy 0,
// how many blocks of the slab-free path (its cooperative launch's limit).
extern "C" int hist2d_resident(int cy, long long smem, int* blocks) {
  int max_smem = 0;
  const int status = configure(&max_smem);
  if (status != 0) return status;
  if (cy < 0 || cy > kMaxCluster || smem < 0 || smem > max_smem ||
      (cy == 0 && smem != 0))
    return (int)cudaErrorInvalidValue;
  if (cy == 0) {
    int per_sm = 0, dev = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hist2d_direct_kernel, kDirectThreads, 0);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    *blocks = per_sm * sms;
    return (int)err;
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config(dim3(1, cy), cy, (size_t)smem, nullptr,
                                  &attr);
  int clusters = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&clusters, hist2d_kernel, &cfg);
  *blocks = clusters * cy;
  return (int)err;
}

// bi, bj (N,) int32 and w (N,) fp32, 4-byte aligned; out (KI * KJ,) fp32,
// 16-byte aligned. All on the device of `stream`. N, KI >= 1; 1 <= KJ <=
// 49,152. The plan: n_slabs slabs of slab_rows rows (n_slabs * slab_rows >=
// KI, slab_rows * KJ <= 49,152) add into a zeroed output, n_chunks row
// chunks in clusters of cy (1 <= cy <= 8, dividing n_chunks). n_slabs 0 is
// the slab-free path, which zeroes the output itself: slab_rows 0, cy 1,
// n_chunks at most hist2d_resident(0, 0). Returns a CUDA error code
// (cudaErrorInvalidValue for a plan out of range).
extern "C" int hist2d_launch(const void* bi, const void* bj, const void* w,
                             void* out, long long N, int KI, int KJ,
                             int n_slabs, int slab_rows, int n_chunks, int cy,
                             void* stream) {
  const bool direct = n_slabs == 0;
  if (N < 1 || KI < 1 || KJ < 1 || KJ > kMaxSlabBins || n_slabs < 0 ||
      (direct && (slab_rows != 0 || cy != 1)) ||
      (!direct && (slab_rows < 1 || (long long)slab_rows * KJ > kMaxSlabBins ||
                   (long long)n_slabs * slab_rows < KI)) ||
      n_chunks < 1 ||
      n_chunks > 65535 || cy < 1 || cy > kMaxCluster || n_chunks % cy ||
      (((uintptr_t)bi | (uintptr_t)bj | (uintptr_t)w) & 3) ||
      ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  int max_smem = 0;
  const int status = configure(&max_smem);
  if (status != 0) return status;
  const size_t smem = (size_t)(slab_rows * KJ + 3) / 4 * 16;
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  Params p;
  p.bi = (const int*)bi;
  p.bj = (const int*)bj;
  p.w = (const float*)w;
  p.out = (float*)out;
  p.N = N;
  p.KI = KI;
  p.KJ = KJ;
  p.slab_rows = slab_rows;
  // Quads of rows with 16-byte loads when the arrays share their offset
  // modulo 16 bytes: rows [n_lo, n_hi) in quads, the rest at the edges.
  const uintptr_t off = (uintptr_t)bi & 15;
  p.vec = ((uintptr_t)bj & 15) == off && ((uintptr_t)w & 15) == off;
  if (p.vec) {
    const long long head = (long long)((16 - off) & 15) / 4;
    p.n_lo = head < N ? head : N;
    p.n_hi = p.n_lo + (N - p.n_lo) / 4 * 4;
  } else {
    p.n_lo = 0;
    p.n_hi = N;
  }
  const long long quads = (p.n_hi - p.n_lo + 3) / 4;
  p.rows_per_chunk = (quads + n_chunks - 1) / n_chunks * 4;
  if (direct) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1, (unsigned)n_chunks);
    cfg.blockDim = dim3(kDirectThreads);
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeCooperative;
    attr.val.cooperative = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, hist2d_direct_kernel, p);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      config(dim3((unsigned)n_slabs, (unsigned)n_chunks), cy, smem,
             (cudaStream_t)stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, hist2d_kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
