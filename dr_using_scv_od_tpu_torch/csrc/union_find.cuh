// Device union-find over a flat [A, R, S] voxel grid (flat id
// g = (a * R + r) * S + s): find_root and unite on global memory, which
// tiled_union_find.cuh (behind cluster_labels.cu, cc_labels.cu and
// ri3_labels.cu) runs in its seam pass.
//
// label[g] is the parent of g. Parents only ever point to smaller ids, so
// each root is the minimum id of its tree, and after a compress pass (each
// voxel walks to its root once the last union is done) every voxel holds
// the minimum flat id of its component: the exact fixpoint, bit-identical
// whatever order the atomics run in.
//
// Each including .cu file is built into its own shared library, so these
// definitions live in an unnamed namespace: one private copy per library.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

}  // namespace
