// 26-connected components of the occupied curved-voxel grid, as a lock-free
// union-find on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dr_using_scv_od_tpu/ops/pallas/cc_kernel.py
// (_cc_tile_kernel, launched by connected_components_pallas). Same contract:
// [A, R, S] bool occupancy in, [G] int32 out, each occupied voxel holding
// the minimum flat id of its component, each empty voxel its own id.
// Nothing wraps on any axis.
//
// Design. The TPU kernel propagated minima over VMEM tiles with halos,
// rolls and log-depth run scans, in a padded id space, up to max_outer=64
// HBM rounds. None of it carries over: here one thread per voxel unites an
// occupied voxel with its occupied neighbours at the 13 forward Chebyshev-1
// offsets, then a read-only compress writes each voxel's root. Roots are
// component minima (union_find.cuh), so the labels are the exact fixpoint,
// with no cap.
//
// The hook reads only the occupancy: the gated hook of cluster_labels.cu
// reads the intensity planes of every occupied voxel, which CC has not got.
//
// What bounds it on the H100: latency. Each occupied voxel does up to 13
// scattered byte reads and the pointer chases of its unions; the [G]
// occupancy (1.3 MB) and labels (5.2 MB) at the semantickitti profile sit
// in the 50 MB L2.

#include "union_find.cuh"

namespace {

__global__ void cc_hook_kernel(const uint8_t* __restrict__ occ, int* label,
                               int A, int R, int S) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= A * R * S || !occ[g]) return;
  int s = g % S;
  int t = g / S;
  int r = t % R;
  int a = t / R;
  for (int da = 0; da <= 1; ++da) {
    int na = a + da;
    if (na >= A) break;
    for (int dr = -1; dr <= 1; ++dr) {
      int nr = r + dr;
      if (nr < 0 || nr >= R) continue;
      for (int ds = -1; ds <= 1; ++ds) {
        // forward half only: (da, dr, ds) lexicographically > 0
        if (da == 0 && (dr < 0 || (dr == 0 && ds <= 0))) continue;
        int ns = s + ds;
        if (ns < 0 || ns >= S) continue;
        int n = (na * R + nr) * S + ns;
        if (occ[n]) unite(label, g, n);
      }
    }
  }
}

}  // namespace

// occ: [G] uint8 (torch.bool), label: [G] int32 output. Returns
// cudaGetLastError() after the three launches on `stream`.
extern "C" int cc_labels_launch(const void* occ, void* label, int A, int R,
                                int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int n = A * R * S;
  int blocks = blocks_for(n);
  int* lab = static_cast<int*>(label);
  init_kernel<<<blocks, kThreads, 0, st>>>(lab, n);
  cc_hook_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(occ), lab, A, R, S);
  compress_kernel<<<blocks, kThreads, 0, st>>>(lab, n);
  return static_cast<int>(cudaGetLastError());
}
