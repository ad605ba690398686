// Pair-batched weighted histogram over a flat id, for Hopper.
//
// Replaces two TPU kernels that are the same function on this card:
//   src/repro/kernels/hist2d/hist2d.py :: batched_hist2d_pallas (_batched_kernel)
//     out[p, a, b] = sum_n w[p, n] [clip(bi) = a][clip(bj) = b]   (KA = KI, KB = KJ)
//   src/repro/kernels/subbin/subbin.py :: batched_subbin_hist_pallas (_batched_kernel)
//     out[p, c, r] = sum_n w[p, n] [clip(cell) = c][clip(sub) = r] (KA = ncell, KB = s_max)
// The flat id is clip(a, 0, KA-1) * KB + clip(b, 0, KB-1). The TPU built
// each histogram as a one-hot matrix product on the MXU (with a base-128
// digit split of the sub-bin ids) because scatters serialize there; on
// Hopper a histogram is a scatter-add.
//
// What bounds it on this card: it reads 8 + 8 + 4-or-8 bytes a row and
// writes P * KA * KB counts in the weights' dtype, so device memory does.
// What held the first kernel back was its adds: the construction's rows
// arrive sorted by (x, y) or (y, x), so neighbouring rows carry the same flat
// id, and one atomic a row made up to 32 lanes of a warp add to one address.
//
// Design: one block a tile of kTile rows of one pair, grid (tiles, P), so
// that every tile's loads are in flight at once (a block holds 24 KB of
// shared memory, eight fit an SM).
//
//  * The block stages its tile of a, b and w in shared memory with cp.async
//    (16-byte copies, coalesced, from the 16-byte boundary below the tile's
//    first row; the copy past the end of an array is cut short).
//  * Each thread walks a strip of kStrip consecutive rows, sums the weights
//    of a run of equal flat ids and adds once when the id changes; rows of
//    weight 0 (nulls, padding) are skipped.
//  * In a warp, a strip's first run joins the previous lane's last run when
//    the ids match, and the last runs of neighbouring lanes with one id are
//    summed by a segmented shuffle; so a run costs one add a warp it spans,
//    not one a row. On uniform ids (runs of one row) it is one add a row.
//  * The adds go straight into the output in its own dtype (atomicAdd on
//    double for f64 weights), which the wrapper zeroed: no fp32 scratch
//    plane, no cast pass.
//
// Measured on the card against this design (PERF.md, PR 14): the plane held
// in a thread block cluster's distributed shared memory, cut by bin range
// and written out once, was 3.1-6.5x slower wherever it applied. Sorted rows
// send a pair's runs to one or two owning blocks, where remote shared-memory
// atomics serialize; on uniform ids they are slower than L2 atomics; and the
// zeroing it saves writes the bytes its final store writes anyway. Whole
// per-block copies summed through the cluster were 1.2-2.1x slower, and
// blocks that loop over several double-buffered tiles up to 2x (fewer
// loads in flight).
//
// Counts of 0/1 weights are exact integers below 2^24 rows a pair (fp32) or
// 2^53 (f64) in any order of addition. Indices are read as int64, the index
// type of the callers (their ids also feed torch.gather).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kStrip = 4;                  // rows a thread walks
constexpr int kTile = kThreads * kStrip;   // rows a block
constexpr unsigned kFull = 0xffffffffu;

// Bytes of one staged tile of one array: a 16-byte head for the shift that
// keeps the tile congruent with its source modulo 16 bytes.
__host__ __device__ constexpr int tile_bytes(int elem) {
  return kTile * elem + 16;
}

__device__ __forceinline__ int clip_index(int64_t v, int k) {
  return v < 0 ? 0 : (v >= k ? k - 1 : (int)v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

// Copies elements [g0, g1) of an array of `total` elements of E bytes at
// `base` (16-byte aligned) into `dst` as 16-byte chunks from g0 rounded
// down to 16 bytes; the last chunk stops at the array's end (cp.async
// zero-fills the rest). Returns where element g0 landed, in elements.
template <int E>
__device__ __forceinline__ int stage_rows(char* dst, const void* base,
                                          size_t total, size_t g0,
                                          size_t g1) {
  const size_t lo = (g0 * E) & ~(size_t)15;
  const size_t end = total * E;
  const int chunks = (int)((g1 * E - lo + 15) >> 4);
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const size_t off = lo + ((size_t)c << 4);
    const size_t left = end - off;              // >= 1: off < g1 * E <= end
    cp_async16(dst + (c << 4), (const char*)base + off,
               left < 16 ? (int)left : 16);
  }
  return (int)((g0 * E - lo) / E);
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
flat_hist_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                 const W* __restrict__ w, W* __restrict__ out, int N, int KA,
                 int KB) {
  __shared__ __align__(16) char smem[2 * tile_bytes(8) + tile_bytes(sizeof(W))];
  const int tid = threadIdx.x, lane = tid & 31;
  const int p = blockIdx.y;
  const size_t total = (size_t)gridDim.y * N;
  const size_t g0 = (size_t)p * N + (size_t)blockIdx.x * kTile;
  const size_t stop = (size_t)p * N + N;
  const size_t g1 = g0 + kTile < stop ? g0 + kTile : stop;
  const int64_t* as =
      (const int64_t*)smem + stage_rows<8>(smem, a, total, g0, g1);
  const int64_t* bs = (const int64_t*)(smem + tile_bytes(8)) +
                      stage_rows<8>(smem + tile_bytes(8), b, total, g0, g1);
  const W* ws = (const W*)(smem + 2 * tile_bytes(8)) +
                stage_rows<sizeof(W)>(smem + 2 * tile_bytes(8), w, total, g0,
                                      g1);
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
  __syncthreads();
  W* plane = out + (size_t)p * KA * KB;

  // The strip: its first run (fid, fsum) when it has more than one, the
  // runs between added at once, its last run (pid, psum) pending.
  int pid = -1, fid = -1;
  W psum = 0, fsum = 0;
  const int rows = (int)(g1 - g0);
  const int i1 = min(rows, (tid + 1) * kStrip);
  for (int i = tid * kStrip; i < i1; ++i) {
    const W wt = ws[i];
    if (wt == (W)0) continue;
    const int id = clip_index(as[i], KA) * KB + clip_index(bs[i], KB);
    if (id == pid) {
      psum += wt;
      continue;
    }
    if (pid >= 0) {
      if (fid < 0) {
        fid = pid;
        fsum = psum;
      } else {
        atomicAdd(plane + pid, psum);
      }
    }
    pid = id;
    psum = wt;
  }
  // A first run that continues the previous lane's last run joins it.
  const int prev_pid = __shfl_up_sync(kFull, pid, 1);
  const int next_fid = __shfl_down_sync(kFull, fid, 1);
  const W next_fsum = __shfl_down_sync(kFull, fsum, 1);
  if (lane < 31 && pid >= 0 && next_fid == pid) psum += next_fsum;
  if (fid >= 0 && !(lane > 0 && prev_pid == fid)) atomicAdd(plane + fid, fsum);
  // Neighbouring lanes' last runs of one id: a segmented suffix sum; the
  // segment's first lane adds.
  const bool head = lane == 0 || pid != prev_pid;
  const unsigned later = __ballot_sync(kFull, head) & ~((2u << lane) - 1u);
  const int seg_end = later ? __ffs(later) - 2 : 31;
  for (int d = 1; d < 32; d <<= 1) {
    const W v = __shfl_down_sync(kFull, psum, d);
    if (lane + d <= seg_end) psum += v;
  }
  if (head && pid >= 0) atomicAdd(plane + pid, psum);
}

template <typename W>
int launch(const void* a, const void* b, const void* w, void* out, int P,
           int N, int KA, int KB, void* stream) {
  const dim3 grid((unsigned)((N + kTile - 1) / kTile), (unsigned)P);
  flat_hist_kernel<W><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)a, (const int64_t*)b, (const W*)w, (W*)out, N, KA, KB);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b (P, N) int64; w (P, N) fp32 (wdouble 0) or fp64 (1); out (P, KA * KB)
// of w's dtype, zeroed. All contiguous, 16-byte aligned, on the device of
// `stream`; 1 <= P <= 65535, N >= 1, KA * KB <= 2^30. Returns a CUDA error
// code (cudaErrorInvalidValue for arguments out of range).
extern "C" int flat_hist_launch(const void* a, const void* b, const void* w,
                                void* out, int P, int N, int KA, int KB,
                                int wdouble, void* stream) {
  if (P < 1 || P > 65535 || N < 1 || KA < 1 || KB < 1 ||
      (long long)KA * KB > (1LL << 30) ||
      ((uintptr_t)a | (uintptr_t)b | (uintptr_t)w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (wdouble) return launch<double>(a, b, w, out, P, N, KA, KB, stream);
  return launch<float>(a, b, w, out, P, N, KA, KB, stream);
}
