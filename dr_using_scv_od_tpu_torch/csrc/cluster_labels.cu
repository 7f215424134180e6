// Fused CVC + RI3 cluster labels on the curved-voxel grid, as a tiled
// lock-free union-find on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dr_using_scv_od_tpu/ops/pallas/fused_seg.py
// (_fused_tile_kernel, fused_seg.py:56, launched by cluster_labels_pallas).
// It computes the same thing: the connected components of the union graph
// over occupied voxels of an [A, R, S] grid, whose edges are every
// Chebyshev-1 pair of occupied voxels and, with the shell on, the
// intensity-gated pairs at Chebyshev 2..radius (tiled_union_find.cuh).
// Output: each occupied voxel holds the minimum flat id of its component,
// each empty voxel its own id. Nothing wraps on any axis.
//
// The TPU kernel iterated min-propagation over VMEM slabs with halos, rolls
// and log-depth run scans to a capped fixpoint. None of that carries over.
// Here, with the tile plan of ops/tile_plan.py (4 x 8 x 32 voxels, a halo
// of `radius`, 1024 threads a block; at radius 2 the tile pass takes
// 24,952 B of shared memory and the seam pass 44,216 B):
//   1. tile pass:  empty tiles write label = id; occupied tiles unite their
//                  inner edges in shared memory and write each voxel's tile
//                  root;
//   2. seam pass:  occupied tiles unite, in global memory, the tile roots
//                  of the edges that leave them, once per distinct pair,
//                  with the tile and its halo in shared memory;
//   3. compress:   occupied tiles write each voxel's root.
// Roots are component minima, so the result is the exact fixpoint with no
// iteration cap (union_find.cuh).
//
// Means are compared as floats, as the JAX semantic reference does
// (models/segmentation.py:refine_by_intensity); the TPU kernel's 2^-13
// fixed-point mean was a packing device and is not carried over.
//
// Bound: occupancy G x 1 B + mean and variance M x 8 B + labels G x 4 B;
// on the frame-0 grid (G = 1,296,000, M = 8,947) 6.55 MB, 1.96 us at the
// H100's 3.35 TB/s. Measured on an H100 (tools/kernel_times.py, device
// time per call on that grid, both kernels in one run): the untiled kernel
// (init, one-thread-per-voxel hook, compress) took 160 us, its hook 151 us
// of it, latency-bound (tiled_union_find.cuh); this one takes 39 us: tile
// pass 21, seam pass 14, compress 4, 20x the bound. The few densest tiles
// set it (tiled_union_find.cuh).

#include "tiled_union_find.cuh"

// occ: [G] uint8 (torch.bool), mean/var: [G] float32, label: [G] int32
// output, flag: [tiles] int32 scratch. radius: 2..search_c shells when > 1,
// plain 26-connected CC when 1. TA, TR, TS, threads and the two passes'
// shared-memory bytes come from ops/tile_plan.py. Returns
// cudaGetLastError() after the three launches on `stream`.
extern "C" int cluster_labels_launch(const void* occ, const void* mean,
                                     const void* var, void* label, void* flag,
                                     int A, int R, int S, int radius,
                                     float intensity_cov, float intensity_diff,
                                     int far_bin, int TA, int TR, int TS,
                                     int threads, int tile_smem,
                                     int seam_smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TiledGrid p = make_tiled_grid(A, R, S, TA, TR, TS, radius, intensity_cov,
                                intensity_diff, far_bin);
  ByteOcc o{static_cast<const uint8_t*>(occ)};
  const float* m = static_cast<const float*>(mean);
  const float* v = static_cast<const float*>(var);
  int* lab = static_cast<int*>(label);
  int* flg = static_cast<int*>(flag);
  auto tile_kernel = tile_pass_kernel<ByteOcc, false>;
  auto seam_kernel = seam_pass_kernel<ByteOcc>;
  cudaError_t err = allow_smem(tile_kernel, tile_smem);
  if (err == cudaSuccess) err = allow_smem(seam_kernel, seam_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = tile_count(p);
  tile_kernel<<<tile_pass_blocks(p), threads, tile_smem, st>>>(
      o, m, v, nullptr, lab, nullptr, flg, p);
  seam_kernel<<<tiles, threads, seam_smem, st>>>(o, m, v, lab, flg, p);
  tile_compress_kernel<<<tiles, threads, 0, st>>>(lab, flg, p);
  return static_cast<int>(cudaGetLastError());
}
