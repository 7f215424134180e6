// Device union-find over a flat [A, R, S] voxel grid (flat id
// g = (a * R + r) * S + s), shared by the port's three label kernels:
// cluster_labels.cu, cc_labels.cu and ri3_labels.cu.
//
// label[g] is the parent of g. Parents only ever point to smaller ids, so
// each root is the minimum id of its tree, and after `compress_kernel` every
// voxel holds the minimum flat id of its component: the exact fixpoint,
// bit-identical whatever order the atomics run in.
//
// Each including .cu file is built into its own shared library, so these
// definitions live in an unnamed namespace: one private copy per library.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

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

// Link the larger of the two roots under the smaller with atomicCAS.
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

// Runs after the last union, so roots are fixed. Each thread walks up
// without halving and writes only its own voxel: a halving store by another
// thread could otherwise overwrite a voxel's final root with an older
// ancestor. Roots (empty voxels among them) return at once.
__global__ void compress_kernel(volatile int* label, int n) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  int cur = label[g];
  if (cur == g) return;
  int next;
  while (cur > (next = label[cur])) cur = next;
  label[g] = cur;
}

// Occupancy views: a bool grid, or the voxel point counts (occupied = > 0).
struct ByteOcc {
  const uint8_t* p;
  __device__ __forceinline__ bool operator()(int i) const { return p[i] != 0; }
};

struct CountOcc {
  const int* p;
  __device__ __forceinline__ bool operator()(int i) const { return p[i] > 0; }
};

// Hook of the union graph of fused_seg.py: one thread per voxel unites an
// occupied voxel with each occupied forward neighbour (lexicographically
// positive offset, so each undirected edge is seen once) at
//   * Chebyshev 1, unconditionally, and
//   * Chebyshev 2..radius, when
//       (qual[n] && r_v <= far_bin) || (qual[v] && r_n <= far_bin)
//     and |mean[v] - mean[n]| <= intensity_diff, qual = var <= intensity_cov.
// Nothing wraps on any axis. Empty voxels (> 99 % of a real scan's grid)
// exit at once; the launch covers all G voxels, so no compaction pass (and
// no host sync) is needed to find the occupied ones.
template <class Occ>
__global__ void union_graph_hook_kernel(Occ occ, const float* __restrict__ mean,
                                        const float* __restrict__ var,
                                        int* label, int A, int R, int S,
                                        int radius, float intensity_cov,
                                        float intensity_diff, int far_bin) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= A * R * S || !occ(g)) return;
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
        if (!occ(n)) continue;
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

}  // namespace
