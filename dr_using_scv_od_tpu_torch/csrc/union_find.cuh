// Device union-find over a flat [A, R, S] voxel grid (flat id
// g = (a * R + r) * S + s). cc_labels.cu runs it over the whole grid
// (init, hook, compress); tiled_union_find.cuh, behind cluster_labels.cu
// and ri3_labels.cu, runs find_root and unite on shared and global memory.
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

}  // namespace
