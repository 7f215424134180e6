// RI3 intensity fusion of a connected-components labelling, as a lock-free
// union-find on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dr_using_scv_od_tpu/ops/pallas/ri3_kernel.py
// (_ri3_tile_kernel, launched by refine_by_intensity_pallas). Contract, on
// any input:
//   * occupancy is count > 0;
//   * the edges are every Chebyshev-1 pair of occupied voxels plus the
//     intensity-gated pairs at Chebyshev 2..radius (the union graph of
//     union_find.cuh, union_graph_hook_kernel);
//   * each occupied voxel gets the MINIMUM INPUT LABEL root_grid[v] over its
//     component, each empty voxel its own id.
// The TPU kernel propagates root_grid's own labels, so its output is that
// minimum. v is never united with root_grid[v]: that would add edges the
// TPU kernel has not got. On a connected-components fixpoint the result
// equals cluster_labels on the same occupancy.
//
// Design. The TPU kernel iterated cheb-1 hops, the gated shell and
// same-cluster run scans over VMEM tiles to a capped fixpoint
// (max_outer=16), comparing means as round(mean * 8192) codes. Here:
//   1. init:     label[g] = g, slot[g] = INT_MAX.
//   2. hook:     the union graph, as in cluster_labels.cu.
//   3. compress: label[g] = root(g), the component's minimum flat id.
//   4. reduce:   atomicMin(slot[label[v]], root_grid[v]) per occupied v.
//   5. gather:   label[v] = slot[label[v]] per occupied v.
// Exact fixpoint, no cap; means compared as floats, as the JAX semantic
// reference (models/segmentation.py:refine_by_intensity) does.
//
// What bounds it on the H100: latency, as for cluster_labels.cu: up to 62
// scattered neighbour reads and the pointer chases per occupied voxel; the
// reduce and gather are one scattered atomic and one scattered read per
// occupied voxel. The [G] planes (5.2 MB each at the semantickitti
// profile) fit the 50 MB L2.

#include <climits>

#include "union_find.cuh"

namespace {

__global__ void ri3_init_kernel(int* __restrict__ label, int* __restrict__ slot,
                                int n) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < n) {
    label[g] = g;
    slot[g] = INT_MAX;
  }
}

__global__ void min_input_kernel(const int* __restrict__ count,
                                 const int* __restrict__ root_grid,
                                 const int* __restrict__ label, int* slot,
                                 int n) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < n && count[g] > 0) atomicMin(&slot[label[g]], root_grid[g]);
}

__global__ void gather_kernel(const int* __restrict__ count,
                              const int* __restrict__ slot, int* label,
                              int n) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < n && count[g] > 0) label[g] = slot[label[g]];
}

}  // namespace

// root_grid, count: [G] int32; mean, var: [G] float32; label: [G] int32
// output; slot: [G] int32 scratch. radius: search_c when >= 2, else 1.
// Returns cudaGetLastError() after the five launches on `stream`.
extern "C" int ri3_labels_launch(const void* root_grid, const void* count,
                                 const void* mean, const void* var,
                                 void* label, void* slot, int A, int R, int S,
                                 int radius, float intensity_cov,
                                 float intensity_diff, int far_bin,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int n = A * R * S;
  int blocks = blocks_for(n);
  const int* cnt = static_cast<const int*>(count);
  int* lab = static_cast<int*>(label);
  int* slt = static_cast<int*>(slot);
  ri3_init_kernel<<<blocks, kThreads, 0, st>>>(lab, slt, n);
  union_graph_hook_kernel<<<blocks, kThreads, 0, st>>>(
      CountOcc{cnt}, static_cast<const float*>(mean),
      static_cast<const float*>(var), lab, A, R, S, radius, intensity_cov,
      intensity_diff, far_bin);
  compress_kernel<<<blocks, kThreads, 0, st>>>(lab, n);
  min_input_kernel<<<blocks, kThreads, 0, st>>>(
      cnt, static_cast<const int*>(root_grid), lab, slt, n);
  gather_kernel<<<blocks, kThreads, 0, st>>>(cnt, slt, lab, n);
  return static_cast<int>(cudaGetLastError());
}
