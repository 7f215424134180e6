// Tiled union-find over a flat [A, R, S] voxel grid (g = (a * R + r) * S
// + s), shared by cluster_labels.cu (kernel 1, replacing the TPU kernel
// dr_using_scv_od_tpu/ops/pallas/fused_seg.py:56) and ri3_labels.cu
// (kernel 3, replacing ops/pallas/ri3_kernel.py:52).
//
// The graph: every forward pair (v, n = v + d, d lexicographically
// positive, Chebyshev distance 1..radius) of occupied voxels at Chebyshev
// 1, and at Chebyshev 2..radius the pairs that pass the intensity gate
//   (var[n] <= cov && r_v <= far_bin) || (var[v] <= cov && r_n <= far_bin)
//   and |mean[v] - mean[n]| <= diff.
// Nothing wraps on any axis. Parents only ever point to smaller flat ids
// (union_find.cuh), so each root is its component's minimum flat id and
// the labels are the exact fixpoint whatever order the atomics run in.
//
// What bounded the untiled kernels (one thread per voxel over all G
// voxels; measured on an H100, tools/kernel_times.py): the hook, 95 % of
// kernel 1's 0.16 ms. Its ~9k live threads (1.4 % of the launch, a few
// warps per SM) each walked 62 offsets in turn, every one a chain of
// dependent L2 round trips (occupancy, intensity, two root walks, CAS):
// latency, with too few warps to hide it. The full-grid init and compress
// passes took 4 us each.
//
// The tile plan (ops/tile_plan.py) cuts the grid into TA x TR x TS tiles
// (4 x 8 x 32 by default, S innermost and at most 32, the last tile of an
// axis clipped; 1024 threads a block, one warp a row of a tile, one lane a
// voxel of it) and gives each pass its dynamic shared memory. A row is the
// voxels of one (a, r) along S; its occupancy is one bit mask, built with
// __ballot_sync.
//   1. tile pass, a fixed grid of about two blocks per SM walking the
//      tiles: load the occupancy of all of a block's tiles at once, then
//      the mean / variance (and kernel 3's input label) of the occupied
//      voxels of each; an empty tile writes label[g] = g and flag 0 (the
//      init pass, fused; most of the grid is skipped from here on). In an
//      occupied tile each run of occupied voxels along S starts as one tree
//      (parent = the run's first voxel: its cheb-1 S edges, without
//      atomics); then one warp per occupied voxel, one lane per forward
//      offset, unites in shared memory every edge whose ends both lie in the
//      tile, each warp linking all its roots under their minimum. Local ids
//      are lexicographic in the tile, so monotone in flat id: each voxel's
//      local root is its tile component's minimum flat id, which the block
//      writes as the voxel's global parent (parent <= child still holds).
//   2. seam pass, one block per tile (empty tiles return at once): load the
//      tile and a halo of `radius` voxels beyond every side a forward offset
//      can leave it by (+A, both R, both S): row masks (64 bits),
//      intensities and the tile pass's labels (tile roots) of the occupied
//      voxels. One warp per occupied voxel within `radius` of such a side
//      puts the two tile roots of each edge that leaves the tile in a set in
//      shared memory; then one thread per distinct pair unites it in global
//      memory. Only edges that cross a tile border reach global atomics
//      (25 % of the frame-0 grid's 62k edges), and most of them repeat a few
//      root pairs.
//   3. compress, one block per tile: the read-only walk of union_find.cuh's
//      compress_kernel. Kernel 3 adds a reduce here and a gather pass.
//
// What bounds the tiled kernel (tools/kernel_times.py on an H100, see
// cluster_labels.cu): the densest tiles. The frame-0 grid's densest tile
// holds 269 occupied voxels (16.7k voxel-offset pairs) and runs on one SM
// while most SMs idle. A layout where each lane walked its own voxel's
// neighbours was slower than this one, whose lanes stay converged; so were
// volatile loads of the shared parents, and per-thread tile arithmetic for
// every tile in the tile pass (its divisions made the empty tiles cost
// more than the rest).
//
// Bound (tools/kernel_times.py's bound_bytes): occupancy G x 1 B, mean and
// variance M x 8 B, labels G x 4 B: 6.55 MB, 1.96 us at 3.35 TB/s for
// kernel 1 on the frame-0 grid (G = 1,296,000, M = 8,947).
//
// Each including .cu file is built into its own shared library; these
// definitions live in an unnamed namespace.

#pragma once

#include <climits>

#include "union_find.cuh"

namespace {

// Occupancy views: a bool grid, or the voxel point counts (occupied = > 0).
struct ByteOcc {
  const uint8_t* p;
  __device__ __forceinline__ bool operator()(int i) const { return p[i] != 0; }
};

struct CountOcc {
  const int* p;
  __device__ __forceinline__ bool operator()(int i) const { return p[i] > 0; }
};

// The grid, the tile and the edge rule, as ops/tile_plan.py plans them.
struct TiledGrid {
  int A, R, S;
  int TA, TR, TS;
  int nta, ntr, nts;
  int radius;
  int K;         // forward offsets: ((2 radius + 1)^3 - 1) / 2
  float cov, diff;
  int far_bin;
};

inline TiledGrid make_tiled_grid(int A, int R, int S, int TA, int TR, int TS,
                                 int radius, float cov, float diff,
                                 int far_bin) {
  int w = 2 * radius + 1;
  return TiledGrid{A, R, S, TA, TR, TS, (A + TA - 1) / TA, (R + TR - 1) / TR,
                   (S + TS - 1) / TS, radius, (w * w * w - 1) / 2, cov, diff,
                   far_bin};
}

// One tile: its origin and its extent, clipped to the grid. Local ids
// l = (la * er + lr) * es + ls are lexicographic in (la, lr, ls), so
// monotone in flat id. The per-voxel loops give each warp a row (la, lr)
// and each lane a voxel of it: coalesced, and no division per voxel.
struct Tile {
  int a0, r0, s0;
  int ea, er, es;
  __device__ __forceinline__ int rows() const { return ea * er; }
  // Flat id of the row's first voxel.
  __device__ __forceinline__ int row_start(const TiledGrid& p, int row) const {
    int la = row / er;
    return ((a0 + la) * p.R + r0 + row - la * er) * p.S + s0;
  }
};

__device__ __forceinline__ Tile tile_at(const TiledGrid& p, int t) {
  int ts = t % p.nts;
  int u = t / p.nts;
  Tile k;
  k.a0 = (u / p.ntr) * p.TA;
  k.r0 = (u % p.ntr) * p.TR;
  k.s0 = ts * p.TS;
  k.ea = min(p.TA, p.A - k.a0);
  k.er = min(p.TR, p.R - k.r0);
  k.es = min(p.TS, p.S - k.s0);
  return k;
}

// Coordinates packed in one word: 10 bits each (tile and box sides < 1024).
__device__ __forceinline__ int pack3(int a, int r, int s) {
  return (a << 20) | (r << 10) | s;
}

__device__ __forceinline__ void unpack3(int c, int& a, int& r, int& s) {
  a = c >> 20;
  r = (c >> 10) & 1023;
  s = c & 1023;
}

// Forward offset q of `radius` in clustering.forward_offsets' order (cell
// half + 1 + q of the (2r+1)^3 cube), packed with r and s biased by 128.
// Each block builds its table of the K offsets once; the edge loops decode
// one with shifts.
__device__ __forceinline__ int packed_offset(int radius, int q) {
  int w = 2 * radius + 1;
  int c = (w * w * w - 1) / 2 + 1 + q;
  return ((c / (w * w) - radius) << 16) |
         (((c / w) % w - radius + 128) << 8) | (c % w - radius + 128);
}

__device__ __forceinline__ void unpack_offset(int o, int& da, int& dr,
                                              int& ds) {
  da = o >> 16;
  dr = ((o >> 8) & 255) - 128;
  ds = (o & 255) - 128;
}

// union_find.cuh's find_root and unite on a block's shared parent array.
// Shared memory is coherent within the block, so the walk needs no
// volatile loads (which were slower on the card).
__device__ __forceinline__ int find_root_shared(int* par, int x) {
  int cur = par[x];
  if (cur != x) {
    int prev = x;
    int next;
    while (cur > (next = par[cur])) {
      par[prev] = next;
      prev = cur;
      cur = next;
    }
  }
  return cur;
}

__device__ __forceinline__ void unite_shared(int* par, int u, int v) {
  int ru = find_root_shared(par, u);
  int rv = find_root_shared(par, v);
  while (ru != rv) {
    if (ru < rv) {
      int old = atomicCAS(&par[rv], rv, ru);
      if (old == rv) return;
      rv = old;
    } else {
      int old = atomicCAS(&par[ru], ru, rv);
      if (old == ru) return;
      ru = old;
    }
  }
}

// One warp's unions: the root of `v` (the same in every lane) with the
// neighbour `nl` of each lane (-1: none). Linking every root of the warp
// under their minimum, one lane per distinct root, leaves the lanes no
// parent to fight over: lanes that each linked the one root of `v` under
// their own smaller root would CAS the same word and win one at a time.
__device__ __forceinline__ void warp_unite_shared(int* par, int v, int nl) {
  const unsigned full = 0xffffffffu;
  const bool live = nl >= 0;
  if (!__any_sync(full, live)) return;
  const int rv = live ? find_root_shared(par, nl) : INT_MAX;
  const int ru = find_root_shared(par, v);
  const int m = min(ru, __reduce_min_sync(full, rv));
  const unsigned same = __match_any_sync(full, rv);
  const int lane = threadIdx.x & 31;
  if (live && rv != m && __ffs(same) - 1 == lane) unite_shared(par, rv, m);
  if (lane == 0 && ru != m) unite_shared(par, ru, m);
}

// A set of (root, root) pairs in shared memory, open addressing: false
// when `key` is in it, now or before; true when the probes ran out and the
// caller must unite the pair itself.
constexpr int kPairSlots = 1024;
constexpr unsigned long long kNoPair = ~0ull;

__device__ __forceinline__ bool pair_set_full(unsigned long long* set,
                                              unsigned long long key) {
  unsigned h = static_cast<unsigned>((key * 0x9E3779B97F4A7C15ull) >> 54);
  for (int probe = 0; probe < 16; ++probe) {
    unsigned long long old =
        atomicCAS(&set[(h + probe) & (kPairSlots - 1)], kNoPair, key);
    if (old == kNoPair || old == key) return false;
  }
  return true;
}

// The intensity gate of an edge at Chebyshev distance >= 2.
__device__ __forceinline__ bool gate_passes(const TiledGrid& p, float mean_v,
                                            float var_v, int r_v,
                                            float mean_n, float var_n,
                                            int r_n) {
  bool gate = (var_n <= p.cov && r_v <= p.far_bin) ||
              (var_v <= p.cov && r_n <= p.far_bin);
  return gate && fabsf(mean_v - mean_n) <= p.diff;
}

// The list slot of each lane whose `take` is set, one shared atomic per
// warp.
__device__ __forceinline__ int warp_append(bool take, int* count) {
  unsigned ballot = __ballot_sync(__activemask(), take);
  int lane = threadIdx.x & 31;
  int leader = __ffs(ballot) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(ballot));
  base = __shfl_sync(__activemask(), base, max(leader, 0));
  return base + __popc(ballot & ((1u << lane) - 1));
}

// One thread stands for one voxel of a tile: warp = row (TA x TR <= the
// block's warps, ops/tile_plan.py), lane = column (TS <= 32). The tile pass
// walks the tiles with a fixed grid of about two blocks per SM (block b
// takes tiles b, b + gridDim.x, ..., at most kTilesPerBlock of them) and
// fetches their occupancy in one round trip, so an empty tile costs no
// memory latency of its own. The other passes run a block per tile, which
// returns at once where the tile pass flagged the tile empty: every
// occupied tile then has an SM of its own.
constexpr int kTilesPerBlock = 8;
constexpr int kMaxThreads = 1024;    // ops/tile_plan.py THREADS

__host__ __device__ __forceinline__ int tile_count(const TiledGrid& p) {
  return p.nta * p.ntr * p.nts;
}

// Shared-memory layout of the tile pass (ops/tile_plan.py tile_smem):
// V = TA * TR * TS words each of parent and occupied list, TA * TR row
// masks, K words of offsets, V words each of [kernel 3: minimum input
// label] and [radius > 1: mean, variance], then kTilesPerBlock x threads
// occupancy bytes. Each tile's origin, extent and row starts are worked out
// once per block (a table in static shared memory): the runtime divisions
// of tile_at, done by every thread for every tile, made the empty tiles
// cost more than all the rest.
template <class Occ, bool kMinLabel>
__global__ void __launch_bounds__(kMaxThreads)
    tile_pass_kernel(Occ occ, const float* __restrict__ mean,
                     const float* __restrict__ var,
                     const int* __restrict__ in_label, int* __restrict__ label,
                     int* __restrict__ slot, int* __restrict__ flag,
                     TiledGrid p) {
  extern __shared__ int smem[];
  __shared__ int n_occ;
  __shared__ Tile tiles_of[kTilesPerBlock];
  __shared__ int row_g0[kTilesPerBlock][32];     // -1: no such row
  const int vmax = p.TA * p.TR * p.TS;
  const int h = p.radius;
  const bool shell = h > 1;
  int* par = smem;
  int* list = par + vmax;
  unsigned* rowmask = reinterpret_cast<unsigned*>(list + vmax);
  int* offs = reinterpret_cast<int*>(rowmask + p.TA * p.TR);
  int* words = offs + p.K;
  int* rmin = words;
  if (kMinLabel) words += vmax;
  float* smean = reinterpret_cast<float*>(words);
  float* svar = smean + vmax;
  if (shell) words += 2 * vmax;
  uint8_t* pre = reinterpret_cast<uint8_t*>(words);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int tiles = tile_count(p);

  if (threadIdx.x < kTilesPerBlock * 32) {
    const int i = threadIdx.x >> 5;
    const int t = blockIdx.x + i * gridDim.x;
    if (t < tiles) {
      const Tile k = tile_at(p, t);
      row_g0[i][lane] = lane < k.rows() ? k.row_start(p, lane) : -1;
      if (lane == 0) tiles_of[i] = k;
    }
  }
  for (int q = threadIdx.x; q < p.K; q += blockDim.x)
    offs[q] = packed_offset(h, q);
  __syncthreads();
  // This thread's voxel of each of the block's tiles: all loads in flight
  // at once.
  bool o_pre[kTilesPerBlock];
#pragma unroll
  for (int i = 0; i < kTilesPerBlock; ++i) {
    const int t = blockIdx.x + i * gridDim.x;
    const int g0 = t < tiles ? row_g0[i][warp] : -1;
    o_pre[i] = g0 >= 0 && lane < tiles_of[i].es && occ(g0 + lane);
  }
#pragma unroll
  for (int i = 0; i < kTilesPerBlock; ++i)
    pre[i * blockDim.x + threadIdx.x] = o_pre[i];

  for (int i = 0; i < kTilesPerBlock; ++i) {
    const int t = blockIdx.x + i * gridDim.x;
    if (t >= tiles) break;
    const Tile k = tiles_of[i];
    const int g0 = row_g0[i][warp];
    const bool mine = g0 >= 0 && lane < k.es;
    const bool o = pre[i * blockDim.x + threadIdx.x];
    const int l = warp * k.es + lane;
    const int g = g0 + lane;
    if (threadIdx.x == 0) n_occ = 0;
    const unsigned m = __ballot_sync(0xffffffffu, o);
    if (lane == 0 && warp < k.rows()) rowmask[warp] = m;
    if (__syncthreads_count(o) == 0) {
      if (mine) label[g] = g;
      if (threadIdx.x == 0) flag[t] = 0;
      continue;
    }
    // A run of occupied voxels along S starts as one tree rooted at its
    // first voxel: its cheb-1 S edges, without atomics.
    float mv = 0.f, vv = 0.f;
    int il = 0;
    if (o && shell) {
      mv = mean[g];
      vv = var[g];
    }
    if (o && kMinLabel) il = in_label[g];
    const int j = warp_append(o, &n_occ);
    if (o) {
      const unsigned starts = m & ~(m << 1);
      const unsigned upto = lane == 31 ? ~0u : (2u << lane) - 1;
      par[l] = warp * k.es + 31 - __clz(starts & upto);
      if (kMinLabel) rmin[l] = INT_MAX;
      if (shell) {
        smean[l] = mv;
        svar[l] = vv;
      }
      const int la = warp / k.er;
      list[j] = pack3(la, warp - la * k.er, lane);
    }
    __syncthreads();

    // One warp per occupied voxel, one lane per forward offset; the loops
    // are warp-uniform, so the lanes stay converged.
    const int n = n_occ;
    for (int jv = warp; jv < n; jv += nwarps) {
      int va, vr, vs;
      unpack3(list[jv], va, vr, vs);
      const int v = (va * k.er + vr) * k.es + vs;
      for (int q0 = 0; q0 < p.K; q0 += 32) {
        const int q = q0 + lane;
        int nl = -1;
        int da, dr, ds;
        if (q < p.K) {
          unpack_offset(offs[q], da, dr, ds);
          const int na = va + da, nr = vr + dr, ns = vs + ds;
          if (na < k.ea && nr >= 0 && nr < k.er && ns >= 0 && ns < k.es &&
              ((rowmask[na * k.er + nr] >> ns) & 1u) &&
              !(da == 0 && dr == 0 && ds == 1)) {    // not the run link
            nl = (na * k.er + nr) * k.es + ns;
            if (max(da, max(abs(dr), abs(ds))) >= 2 &&
                !gate_passes(p, smean[v], svar[v], k.r0 + vr, smean[nl],
                             svar[nl], k.r0 + nr))
              nl = -1;
          }
        }
        warp_unite_shared(par, v, nl);
      }
    }
    __syncthreads();

    // Roots are final: walk without halving, write the global parent.
    if (mine) {
      if (!o) {
        label[g] = g;
      } else {
        int cur = l;
        int next;
        while (cur > (next = par[cur])) cur = next;
        label[g] = row_g0[i][cur / k.es] + cur % k.es;
        if (kMinLabel) atomicMin(&rmin[cur], il);
      }
    }
    if (kMinLabel) {
      // slot: the tile component's minimum input label at its root,
      // INT_MAX at the tile's other occupied voxels.
      __syncthreads();
      if (o) slot[g] = par[l] == l ? rmin[l] : INT_MAX;
    }
    if (threadIdx.x == 0) flag[t] = 1;
    __syncthreads();    // the next tile reuses the shared arrays
  }
}

// Shared-memory layout of the seam pass (ops/tile_plan.py seam_smem): the
// set of united root pairs (kPairSlots x 8 bytes), the box's row masks (64
// bits), V words of the border list, K words of offsets, then for each of
// its BV voxels the tile pass's label and [radius > 1] mean and variance.
// The box is the tile plus `radius` voxels beyond +A and on both sides of R
// and S; box coordinates (a - a0, r - r0 + radius, s - s0 + radius), rows
// of BS = es + 2 radius <= 64 voxels, two half rows of 32 a warp.
template <class Occ>
__global__ void __launch_bounds__(kMaxThreads)
    seam_pass_kernel(Occ occ, const float* __restrict__ mean,
                     const float* __restrict__ var, int* label,
                     const int* __restrict__ flag, TiledGrid p) {
  const int t = blockIdx.x;
  if (!flag[t]) return;
  extern __shared__ unsigned long long smem64[];
  __shared__ int n_border;
  const int h = p.radius;
  const bool shell = h > 1;
  const int vmax = p.TA * p.TR * p.TS;
  const int bvmax = (p.TA + h) * (p.TR + 2 * h) * (p.TS + 2 * h);
  unsigned long long* pairs = smem64;
  unsigned long long* boxmask = pairs + kPairSlots;
  int* list = reinterpret_cast<int*>(boxmask + (p.TA + h) * (p.TR + 2 * h));
  int* offs = list + vmax;
  int* blab = offs + p.K;
  float* bmean = reinterpret_cast<float*>(blab + bvmax);
  float* bvar = bmean + bvmax;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int q = threadIdx.x; q < p.K; q += blockDim.x)
    offs[q] = packed_offset(h, q);
  const Tile k = tile_at(p, t);
  const int BR = k.er + 2 * h, BS = k.es + 2 * h;
  const int rows = (k.ea + h) * BR;
  if (threadIdx.x == 0) n_border = 0;
  for (int e = threadIdx.x; e < kPairSlots; e += blockDim.x)
    pairs[e] = kNoPair;
  __syncthreads();
  // The box, four rows a warp at a time: the occupancy of all of them in
  // flight at once, then their labels and intensities.
  for (int base = 0; base < rows; base += 4 * nwarps) {
    bool o[4][2];
    int g[4][2];
  #pragma unroll
    for (int jr = 0; jr < 4; ++jr) {
      const int row = base + warp + jr * nwarps;
      const int ba = row / BR, br = row - ba * BR;
      const int a = k.a0 + ba, r = k.r0 + br - h;
      const bool row_in = row < rows && a < p.A && r >= 0 && r < p.R;
  #pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int bs = hf * 32 + lane;
        const int s = k.s0 + bs - h;
        g[jr][hf] = (a * p.R + r) * p.S + s;
        o[jr][hf] = row_in && bs < BS && s >= 0 && s < p.S &&
                    occ(g[jr][hf]);
      }
    }
    int lab[4][2];
    float mv[4][2], vv[4][2];
  #pragma unroll
    for (int jr = 0; jr < 4; ++jr)
  #pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        if (o[jr][hf]) {
          lab[jr][hf] = label[g[jr][hf]];
          if (shell) {
            mv[jr][hf] = mean[g[jr][hf]];
            vv[jr][hf] = var[g[jr][hf]];
          }
        }
  #pragma unroll
    for (int jr = 0; jr < 4; ++jr) {
      const int row = base + warp + jr * nwarps;
      const int ba = row / BR, br = row - ba * BR;
      const bool row_in_tile = ba < k.ea && br >= h && br < k.er + h;
      // within h of +A or of either R side (lr < h, lr >= er - h)
      const bool row_border = ba >= k.ea - h || br < 2 * h || br >= k.er;
      unsigned long long bits = 0;
  #pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const bool oo = o[jr][hf];
        bits |= static_cast<unsigned long long>(
                    __ballot_sync(0xffffffffu, oo))
                << (32 * hf);
        const int bs = hf * 32 + lane;
        const int ls = bs - h;
        const bool border = oo && row_in_tile && ls >= 0 && ls < k.es &&
                            (row_border || ls < h || ls >= k.es - h);
        const int jb = warp_append(border, &n_border);
        if (!oo) continue;
        const int b = row * BS + bs;
        blab[b] = lab[jr][hf];
        if (shell) {
          bmean[b] = mv[jr][hf];
          bvar[b] = vv[jr][hf];
        }
        if (border) list[jb] = pack3(ba, br, bs);
      }
      if (lane == 0 && row < rows) boxmask[row] = bits;
    }
  }
  __syncthreads();

  // One warp per border voxel, one lane per forward offset: each edge
  // that leaves the tile puts its two tile roots (the tile pass's labels)
  // in the set. Then one thread per distinct pair unites it, all pairs in
  // one parallel round of global atomics.
  const int n = n_border;
  for (int jv = warp; jv < n; jv += nwarps) {
    int ba, br, bs;
    unpack3(list[jv], ba, br, bs);
    const int b = (ba * BR + br) * BS + bs;
    const int r_v = k.r0 + br - h;
    const int ru = blab[b];
    for (int q = lane; q < p.K; q += 32) {
      int da, dr, ds;
      unpack_offset(offs[q], da, dr, ds);
      const int na = ba + da, nr = br + dr, ns = bs + ds;
      const int nb = (na * BR + nr) * BS + ns;
      // the tile pass took the edges that stay in the tile
      if (!(na < k.ea && nr >= h && nr < k.er + h && ns >= h &&
            ns < k.es + h) &&
          ((boxmask[na * BR + nr] >> ns) & 1ull) &&
          (max(da, max(abs(dr), abs(ds))) < 2 ||
           gate_passes(p, bmean[b], bvar[b], r_v, bmean[nb], bvar[nb],
                       k.r0 + nr - h)) &&
          pair_set_full(pairs, (static_cast<unsigned long long>(ru) << 32) |
                                   static_cast<unsigned>(blab[nb])))
        unite(label, ru, blab[nb]);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kPairSlots; e += blockDim.x) {
    const unsigned long long key = pairs[e];
    if (key != kNoPair)
      unite(label, static_cast<int>(key >> 32),
            static_cast<int>(key & 0xffffffffu));
  }
}

// The flat id of this thread's voxel of tile t (row = warp, column =
// lane), -1 where the tile has none.
__device__ __forceinline__ int my_voxel(const TiledGrid& p, int t) {
  const Tile k = tile_at(p, t);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  return warp < k.rows() && lane < k.es ? k.row_start(p, warp) + lane : -1;
}

// Compress over occupied tiles: each voxel's root, by a read-only walk
// (union_find.cuh compress_kernel); empty voxels and roots return at once.
__global__ void __launch_bounds__(kMaxThreads)
    tile_compress_kernel(volatile int* label, const int* __restrict__ flag,
                         TiledGrid p) {
  if (!flag[blockIdx.x]) return;
  const int g = my_voxel(p, blockIdx.x);
  if (g < 0) return;
  int cur = label[g];
  if (cur == g) return;
  int next;
  while (cur > (next = label[cur])) cur = next;
  label[g] = cur;
}

// Blocks of the tile pass: about two per SM (two blocks of 1024 threads
// fill one), and enough that no block takes more than kTilesPerBlock
// tiles.
inline int tile_pass_blocks(const TiledGrid& p) {
  static int sms_of[64];      // per device, looked up once
  int dev = 0;
  cudaGetDevice(&dev);
  int& sms = sms_of[dev & 63];
  if (sms == 0 &&
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  const int tiles = tile_count(p);
  return max(min(tiles, 2 * sms),
             (tiles + kTilesPerBlock - 1) / kTilesPerBlock);
}

// Let a kernel take `bytes` of dynamic shared memory (above the 48 KB
// default it must ask).
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace
