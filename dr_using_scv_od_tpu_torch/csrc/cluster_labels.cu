// Fused CVC + RI3 cluster labels on the curved-voxel grid, as a lock-free
// union-find on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dr_using_scv_od_tpu/ops/pallas/fused_seg.py
// (_fused_tile_kernel, launched by cluster_labels_pallas). It computes the
// same thing: the connected components of the union graph over occupied
// voxels of an [A, R, S] grid, whose edges are every Chebyshev-1 pair of
// occupied voxels and, with the shell on, the intensity-gated pairs at
// Chebyshev 2..radius (union_find.cuh, union_graph_hook_kernel).
// Output: each occupied voxel holds the minimum flat id of its component,
// each empty voxel its own id. Nothing wraps on any axis.
//
// Design. The TPU kernel iterated min-propagation over VMEM slabs with
// halos, rolls and log-depth run scans to a capped fixpoint. None of that
// carries over. Here:
//   1. init:     label[g] = g.
//   2. hook:     one thread per voxel unites it with its occupied forward
//                neighbours (13 offsets at radius 1, 62 at radius 2),
//                linking the larger root under the smaller with atomicCAS.
//   3. compress: label[g] = root(g), a read-only walk.
// Roots are component minima, so the result is the exact fixpoint with no
// iteration cap (union_find.cuh).
//
// Means are compared as floats, as the JAX semantic reference does
// (models/segmentation.py:refine_by_intensity); the TPU kernel's 2^-13
// fixed-point mean was a packing device and is not carried over.
//
// What bounds it on the H100: latency, not bandwidth. The four [G] arrays
// (1.3 M voxels at the semantickitti profile, 5.2 MB each) fit the 50 MB
// L2; the cost is up to 62 scattered neighbour reads and the pointer chases
// of each occupied voxel.

#include "union_find.cuh"

// occ: [G] uint8 (torch.bool), mean/var: [G] float32, label: [G] int32
// output. radius: 2..search_c shells when > 1, plain 26-connected CC when 1.
// Returns cudaGetLastError() after the three launches on `stream`.
extern "C" int cluster_labels_launch(const void* occ, const void* mean,
                                     const void* var, void* label, int A,
                                     int R, int S, int radius,
                                     float intensity_cov, float intensity_diff,
                                     int far_bin, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int n = A * R * S;
  int blocks = blocks_for(n);
  int* lab = static_cast<int*>(label);
  init_kernel<<<blocks, kThreads, 0, st>>>(lab, n);
  union_graph_hook_kernel<<<blocks, kThreads, 0, st>>>(
      ByteOcc{static_cast<const uint8_t*>(occ)},
      static_cast<const float*>(mean), static_cast<const float*>(var), lab,
      A, R, S, radius, intensity_cov, intensity_diff, far_bin);
  compress_kernel<<<blocks, kThreads, 0, st>>>(lab, n);
  return static_cast<int>(cudaGetLastError());
}
