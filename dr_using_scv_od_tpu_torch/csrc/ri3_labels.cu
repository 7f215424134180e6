// RI3 intensity fusion of a connected-components labelling, as a tiled
// lock-free union-find on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dr_using_scv_od_tpu/ops/pallas/ri3_kernel.py
// (_ri3_tile_kernel, ri3_kernel.py:52, launched by
// refine_by_intensity_pallas). Contract, on any input:
//   * occupancy is count > 0;
//   * the edges are every Chebyshev-1 pair of occupied voxels plus the
//     intensity-gated pairs at Chebyshev 2..radius (the union graph of
//     tiled_union_find.cuh);
//   * each occupied voxel gets the MINIMUM INPUT LABEL root_grid[v] over its
//     component, each empty voxel its own id.
// The TPU kernel propagates root_grid's own labels, so its output is that
// minimum. v is never united with root_grid[v]: that would add edges the
// TPU kernel has not got. On a connected-components fixpoint the result
// equals cluster_labels on the same occupancy.
//
// The TPU kernel iterated cheb-1 hops, the gated shell and same-cluster
// run scans over VMEM tiles to a capped fixpoint (max_outer=16), comparing
// means as round(mean * 8192) codes. Here, with the tile plan of
// ops/tile_plan.py (4 x 8 x 32 voxels, a halo of `radius`, 1024 threads a
// block; at radius 2 the tile pass takes 29,048 B of shared memory and the
// seam pass 44,216 B):
//   1. tile pass:  as in cluster_labels.cu, and each tile component's
//                  minimum input label, reduced in shared memory, goes to
//                  slot[tile root] (INT_MAX at the other occupied voxels);
//   2. seam pass:  as in cluster_labels.cu;
//   3. compress:   label[v] = root(v); a linked tile root v also does
//                  atomicMin(slot[root], slot[v]), so one global atomic
//                  per tile component, not per voxel;
//   4. gather:     label[v] = slot[label[v]] per occupied v.
// Exact fixpoint, no cap; means compared as floats, as the JAX semantic
// reference (models/segmentation.py:refine_by_intensity) does.
//
// Bound: counts G x 4 B + input labels M x 4 B + mean and variance M x 8 B
// + labels G x 4 B; on the frame-0 grid (G = 1,296,000, M = 8,947)
// 10.48 MB, 3.13 us at the H100's 3.35 TB/s. Measured on an H100
// (tools/kernel_times.py, device time per call on that grid, both kernels
// in one run): the untiled kernel (init, hook, compress, reduce, gather)
// took 170-173 us, its hook 154-157 us of it, latency-bound
// (tiled_union_find.cuh); this one takes 44 us: tile pass 22, seam pass 14,
// compress 4, gather 4, 14x the bound.

#include "tiled_union_find.cuh"

namespace {

// Compress, and the reduce: a linked tile root g (slot[g] != INT_MAX)
// also does atomicMin(slot[root], slot[g]). Only final roots receive, and
// g is no final root, so slot[g] is settled when it is read.
__global__ void __launch_bounds__(kMaxThreads)
    ri3_compress_kernel(volatile int* label, int* slot,
                        const int* __restrict__ flag, TiledGrid p) {
  if (!flag[blockIdx.x]) return;
  const int g = my_voxel(p, blockIdx.x);
  if (g < 0) return;
  int cur = label[g];
  if (cur == g) return;     // empty voxels and final roots
  int next;
  while (cur > (next = label[cur])) cur = next;
  label[g] = cur;
  const int m = slot[g];
  if (m != INT_MAX) atomicMin(&slot[cur], m);
}

// Gather: label[v] = slot[label[v]] at each occupied voxel.
__global__ void __launch_bounds__(kMaxThreads)
    ri3_gather_kernel(const int* __restrict__ count,
                      const int* __restrict__ slot, int* label,
                      const int* __restrict__ flag, TiledGrid p) {
  if (!flag[blockIdx.x]) return;
  const int g = my_voxel(p, blockIdx.x);
  if (g >= 0 && count[g] > 0) label[g] = slot[label[g]];
}

}  // namespace

// root_grid, count: [G] int32; mean, var: [G] float32; label: [G] int32
// output; slot: [G] int32 scratch; flag: [tiles] int32 scratch. radius:
// search_c when >= 2, else 1. TA, TR, TS, threads and the two passes'
// shared-memory bytes come from ops/tile_plan.py. Returns
// cudaGetLastError() after the four launches on `stream`.
extern "C" int ri3_labels_launch(const void* root_grid, const void* count,
                                 const void* mean, const void* var,
                                 void* label, void* slot, void* flag, int A,
                                 int R, int S, int radius,
                                 float intensity_cov, float intensity_diff,
                                 int far_bin, int TA, int TR, int TS,
                                 int threads, int tile_smem, int seam_smem,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TiledGrid p = make_tiled_grid(A, R, S, TA, TR, TS, radius, intensity_cov,
                                intensity_diff, far_bin);
  const int* cnt = static_cast<const int*>(count);
  CountOcc o{cnt};
  const float* m = static_cast<const float*>(mean);
  const float* v = static_cast<const float*>(var);
  int* lab = static_cast<int*>(label);
  int* slt = static_cast<int*>(slot);
  int* flg = static_cast<int*>(flag);
  auto tile_kernel = tile_pass_kernel<CountOcc, true>;
  auto seam_kernel = seam_pass_kernel<CountOcc>;
  cudaError_t err = allow_smem(tile_kernel, tile_smem);
  if (err == cudaSuccess) err = allow_smem(seam_kernel, seam_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = tile_count(p);
  tile_kernel<<<tile_pass_blocks(p), threads, tile_smem, st>>>(
      o, m, v, static_cast<const int*>(root_grid), lab, slt, flg, p);
  seam_kernel<<<tiles, threads, seam_smem, st>>>(o, m, v, lab, flg, p);
  ri3_compress_kernel<<<tiles, threads, 0, st>>>(lab, slt, flg, p);
  ri3_gather_kernel<<<tiles, threads, 0, st>>>(cnt, slt, lab, flg, p);
  return static_cast<int>(cudaGetLastError());
}
