// Fused CVC + RI3 cluster labels on the curved-voxel grid, as a lock-free
// union-find on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dr_using_scv_od_tpu/ops/pallas/fused_seg.py
// (_fused_tile_kernel, launched by cluster_labels_pallas). It computes the
// same thing: the connected components of the union graph over occupied
// voxels of an [A, R, S] grid (flat id g = (a * R + r) * S + s), whose edges
// are
//   * every Chebyshev-1 (26-connected) pair of occupied voxels, and
//   * with the shell on, every pair at Chebyshev 2..radius for which
//       (qual[n] && r_v <= far_bin) || (qual[v] && r_n <= far_bin)
//     and |mean[v] - mean[n]| <= intensity_diff, qual = var <= intensity_cov.
// Output: each occupied voxel holds the minimum flat id of its component,
// each empty voxel its own id. Nothing wraps on any axis.
//
// Design. The TPU kernel iterated min-propagation over VMEM slabs with
// halos, rolls and log-depth run scans to a capped fixpoint. None of that
// carries over. Here:
//   1. init:     label[g] = g.
//   2. hook:     one thread per voxel; empty voxels (> 99 % of the grid on
//                a real scan) exit at once. An occupied voxel enumerates its
//                forward offsets (13 at radius 1, 62 at radius 2), so each
//                undirected edge is seen once, and unites both ends by
//                linking the larger root under the smaller with atomicCAS.
//   3. compress: label[g] = root(g), a read-only walk in which each thread
//                writes only its own voxel.
// Parents only ever point to smaller ids, so each root is the minimum id of
// its tree, and the result is the exact fixpoint whatever order the atomics
// run in: bit-identical from run to run, with no iteration cap.
//
// Means are compared as floats, as the JAX semantic reference does
// (models/segmentation.py:refine_by_intensity); the TPU kernel's 2^-13
// fixed-point mean was a packing device and is not carried over.
//
// What bounds it on the H100: latency, not bandwidth. The four [G] arrays
// (1.3 M voxels at the semantickitti profile, 5.2 MB each) fit the 50 MB
// L2; the cost is up to 62 scattered neighbour reads and the pointer chases
// of each occupied voxel. The launch covers all G voxels so that no
// compaction pass (and no host sync) is needed to find the occupied ones.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void init_kernel(int* __restrict__ label, int n) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < n) label[g] = g;
}

// Root of x, halving the path on the way: each write points a node at one
// of its ancestors, so parents stay smaller than their children.
__device__ __forceinline__ int find_root(volatile int* label, int x) {
  int cur = label[x];
  if (cur != x) {
    int prev = x;
    int next;
    while (cur > (next = label[cur])) {
      label[prev] = next;
      prev = cur;
      cur = next;
    }
  }
  return cur;
}

__device__ __forceinline__ void unite(int* label, int u, int v) {
  int ru = find_root(label, u);
  int rv = find_root(label, v);
  while (ru != rv) {
    if (ru < rv) {
      int old = atomicCAS(&label[rv], rv, ru);
      if (old == rv) return;
      rv = old;  // rv got a parent meanwhile: climb and retry
    } else {
      int old = atomicCAS(&label[ru], ru, rv);
      if (old == ru) return;
      ru = old;
    }
  }
}

__global__ void hook_kernel(const uint8_t* __restrict__ occ,
                            const float* __restrict__ mean,
                            const float* __restrict__ var,
                            int* label, int A, int R, int S, int radius,
                            float intensity_cov, float intensity_diff,
                            int far_bin) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= A * R * S || !occ[g]) return;
  int s = g % S;
  int t = g / S;
  int r = t % R;
  int a = t / R;
  bool qual_v = var[g] <= intensity_cov;
  bool near_v = r <= far_bin;
  float mean_v = mean[g];

  for (int da = 0; da <= radius; ++da) {
    int na = a + da;
    if (na >= A) break;
    for (int dr = -radius; dr <= radius; ++dr) {
      int nr = r + dr;
      if (nr < 0 || nr >= R) continue;
      for (int ds = -radius; ds <= radius; ++ds) {
        // forward half only: (da, dr, ds) lexicographically > 0
        if (da == 0 && (dr < 0 || (dr == 0 && ds <= 0))) continue;
        int ns = s + ds;
        if (ns < 0 || ns >= S) continue;
        int n = (na * R + nr) * S + ns;
        if (!occ[n]) continue;
        int cheb = max(da, max(abs(dr), abs(ds)));
        if (cheb >= 2) {
          bool gate = (var[n] <= intensity_cov && near_v) ||
                      (qual_v && nr <= far_bin);
          if (!gate || !(fabsf(mean_v - mean[n]) <= intensity_diff)) continue;
        }
        unite(label, g, n);
      }
    }
  }
}

// No unions run any more, so roots are fixed. Each thread walks up without
// halving and writes only its own voxel: a halving store by another thread
// could otherwise overwrite a voxel's final root with an older ancestor.
__global__ void compress_kernel(const uint8_t* __restrict__ occ,
                                volatile int* label, int n) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n || !occ[g]) return;
  int cur = label[g];
  int next;
  while (cur > (next = label[cur])) cur = next;
  label[g] = cur;
}

}  // namespace

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
  int blocks = (n + kThreads - 1) / kThreads;
  const uint8_t* o = static_cast<const uint8_t*>(occ);
  int* lab = static_cast<int*>(label);
  init_kernel<<<blocks, kThreads, 0, st>>>(lab, n);
  hook_kernel<<<blocks, kThreads, 0, st>>>(
      o, static_cast<const float*>(mean), static_cast<const float*>(var), lab,
      A, R, S, radius, intensity_cov, intensity_diff, far_bin);
  compress_kernel<<<blocks, kThreads, 0, st>>>(o, lab, n);
  return static_cast<int>(cudaGetLastError());
}
