// 26-connected components of the occupied curved-voxel grid, as a tiled
// lock-free union-find on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dr_using_scv_od_tpu/ops/pallas/cc_kernel.py
// (_cc_tile_kernel, cc_kernel.py:49, launched by
// connected_components_pallas). Same contract: [A, R, S] bool occupancy in,
// [G] int32 out, each occupied voxel holding the minimum flat id of its
// component, each empty voxel its own id. Nothing wraps on any axis.
//
// The TPU kernel propagated minima over VMEM tiles with halos, rolls and
// log-depth run scans, in a padded id space, up to max_outer=64 HBM rounds.
// None of it carries over. Here the three passes of tiled_union_find.cuh
// run at radius 1 over the occupancy alone (no intensity plane is read or
// held in shared memory), with the tile plan of ops/tile_plan.py
// (4 x 8 x 32 voxels, a halo of 1, 1024 threads a block):
//   1. tile pass (the header's tile_pass_kernel<ByteOcc, false, true>):
//      empty tiles write label = id; occupied tiles unite their inner edges
//      in shared memory and write each voxel's tile root. With kRuns the
//      edge loop works by RUNS of the row masks (unite_runs_shared): a row's
//      run of occupied voxels along S starts as one tree (no atomics), and
//      one thread per (occupied voxel, forward row) unites the voxel with
//      that row's runs under s - 1 .. s + 1 (at most two);
//   2. seam pass (the header's seam_pass_kernel<ByteOcc>, radius 1, mean
//      and var null: it reads them only where radius > 1);
//   3. compress (the header's tile_compress_kernel).
// Roots are component minima, so the result is the exact fixpoint with no
// iteration cap (union_find.cuh).
//
// What bounded the kernel this one replaces (one thread per voxel over the
// whole grid: init, hook, compress; measured on an H100,
// tools/kernel_times.py): the hook, 75 us of its 82 us. Its ~9k live
// threads of 1.3 M each walked 13 offsets as dependent L2 round trips.
//
// Bound: occupancy G x 1 B + labels G x 4 B; on the frame-0 grid
// (G = 1,296,000) 6.48 MB, 1.93 us at the H100's 3.35 TB/s.

#include "tiled_union_find.cuh"

// occ: [G] uint8 (torch.bool), label: [G] int32 output, flag: [tiles] int32
// scratch. TA, TR, TS, threads and the two passes' shared-memory bytes come
// from ops/tile_plan.py's plan at radius 1. Returns cudaGetLastError() after
// the three launches on `stream`.
extern "C" int cc_labels_launch(const void* occ, void* label, void* flag,
                                int A, int R, int S, int TA, int TR, int TS,
                                int threads, int tile_smem, int seam_smem,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TiledGrid p = make_tiled_grid(A, R, S, TA, TR, TS, 1, 0.f, 0.f, 0);
  const uint8_t* o = static_cast<const uint8_t*>(occ);
  int* lab = static_cast<int*>(label);
  int* flg = static_cast<int*>(flag);
  auto tile_kernel = tile_pass_kernel<ByteOcc, false, true>;
  auto seam_kernel = seam_pass_kernel<ByteOcc>;
  cudaError_t err = allow_smem(tile_kernel, tile_smem);
  if (err == cudaSuccess) err = allow_smem(seam_kernel, seam_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = tile_count(p);
  tile_kernel<<<tile_pass_blocks(p), threads, tile_smem, st>>>(
      ByteOcc{o}, nullptr, nullptr, nullptr, lab, nullptr, flg, p);
  seam_kernel<<<tiles, threads, seam_smem, st>>>(ByteOcc{o}, nullptr, nullptr,
                                                 lab, flg, p);
  tile_compress_kernel<<<tiles, threads, 0, st>>>(lab, flg, p);
  return static_cast<int>(cudaGetLastError());
}
