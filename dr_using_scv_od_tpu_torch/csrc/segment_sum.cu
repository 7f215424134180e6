// Per-segment sums of the rows of x over stably sorted segment ids, each sum
// taken in row order from +0.0 (the card path of ops/segment_ops.py's
// `segment_sum_planned`).
//
// Replaces no TPU kernel: the JAX package sums with XLA scatters and one-hot
// matmuls. It replaces torch.segment_reduce, whose CUDA kernel gives each
// (segment, column) one thread that walks the segment's rows in a dependent
// loop. Its time is that of the longest segment, and the longest was the
// dropped bucket (ids outside [0, num): padding and points off the grid,
// 58k-140k rows a call on the main path), summed and then thrown away.
//
// Contract: x [M, K] (float or double, contiguous), order [M] int64 (the
// stable sort of the bucketed ids), seg [M] int64 (the sorted ids, every one
// in [0, num]; num is the dropped bucket, so it sorts last), out [num, K]
// zeros on entry. For each kept id s, out[s, k] = (((+0 + x[o0, k]) + x[o1,
// k]) + ...) over the rows o0, o1, ... of s in sorted order: the sums of
// torch.segment_reduce, bit for bit. No tree inside a sum, no atomics.
//
// Design:
//   * A run starts where the sorted id changes. A warp owns the runs that
//     start among its 32 sorted positions (one ballot) and sums them one
//     after another; a run of id num is never read, and a warp whose
//     positions hold no start exits after one coalesced load.
//   * Lane k of the warp owns column blockIdx.y * 32 + k (grid.y slices
//     K > 32 columns, the z histogram's 256). A run is walked 32 rows at a
//     time: the lanes load the next 32 (id, order) pairs coalesced (the
//     run's end is where the id differs: a prefix ballot, no lengths), the
//     32 row gathers go out together, then each lane adds its column over
//     the 32 values in row order. The next chunk's pairs are loaded before
//     this chunk's gathers, so a chunk costs about one gather latency.
//   * Rows are read through order: no x[order] copy is made.
//
// Bound: least bytes are the kept rows read once (rows x K x size), the
// sorted ids and order read once (16 B a row) and the output written once
// (num x K x size); for the voxel sum ([131,072 x 12] float into 1,296,000
// voxels) the output's 62.2 MB dominate, 19.5 us at 3.35 TB/s, and the
// zeros' fill outside this kernel writes them. The other floor is the
// serial add chain of the longest run (about 2,200 rows in patchwork's
// sums), a chunk's gather latency every 32 rows.

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
segment_reduce_runs(const T* __restrict__ x, const int64_t* __restrict__ order,
                    const int64_t* __restrict__ seg, T* __restrict__ out,
                    int64_t M, int64_t num, int K) {
  const int lane = threadIdx.x % kWarp;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp)
      * kWarp;
  const int col = blockIdx.y * kWarp + lane;
  const bool active = col < K;

  const int64_t p = first + lane;
  const int64_t id = p < M ? seg[p] : num;
  const bool start = id < num && (p == 0 || seg[p - 1] != id);
  unsigned starts = __ballot_sync(kFull, start);

  while (starts != 0) {
    const int s = __ffs(starts) - 1;
    starts &= starts - 1;
    const int64_t run = __shfl_sync(kFull, id, s);
    int64_t q = first + s + lane;            // this chunk's position
    int64_t qid = q < M ? seg[q] : -1;
    int64_t qrow = q < M ? order[q] : 0;
    T acc = T(0);
    for (;;) {
      // the run's rows in the chunk are a prefix of the lanes
      const int n = __popc(__ballot_sync(kFull, qid == run));
      int64_t nid = -1, nrow = 0;
      if (n == kWarp && q + kWarp < M) {
        nid = seg[q + kWarp];
        nrow = order[q + kWarp];
      }
      T v[kWarp];
#pragma unroll
      for (int r = 0; r < kWarp; ++r) {
        const int64_t row = __shfl_sync(kFull, qrow, r);
        v[r] = (r < n && active) ? x[row * K + col] : T(0);
      }
#pragma unroll
      for (int r = 0; r < kWarp; ++r)
        if (r < n) acc = acc + v[r];
      if (n < kWarp) break;
      q += kWarp;
      qid = nid;
      qrow = nrow;
    }
    if (active) out[run * K + col] = acc;
  }
}

template <typename T>
int launch(const void* x, const void* order, const void* seg, void* out,
           int64_t M, int64_t num, int K, cudaStream_t st) {
  const int64_t warps = (M + kWarp - 1) / kWarp;
  const dim3 grid(static_cast<unsigned>((warps + kWarpsPerBlock - 1)
                                        / kWarpsPerBlock),
                  static_cast<unsigned>((K + kWarp - 1) / kWarp));
  segment_reduce_runs<T><<<grid, kWarp * kWarpsPerBlock, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int64_t*>(order),
      static_cast<const int64_t*>(seg), static_cast<T*>(out), M, num, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [M, K] float32 (is_double 0) or float64 (1); order, seg: [M] int64;
// out: [num, K] of x's type, zeros. M, num and K are at least 1. Returns
// cudaGetLastError() after the launch on `stream`.
extern "C" int segment_sum_launch(const void* x, const void* order,
                                  const void* seg, void* out, int64_t M,
                                  int64_t num, int K, int is_double,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(x, order, seg, out, M, num, K, st)
                   : launch<float>(x, order, seg, out, M, num, K, st);
}
