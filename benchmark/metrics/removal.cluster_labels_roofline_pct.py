"""removal.cluster_labels_roofline_pct: kernel 1 (csrc/cluster_labels.cu)
against its memory bound in the profiled removal windows.

The least bytes of one call on a grid of G voxels with M occupied are
G + 8 M + 4 G (occupancy read, intensity mean and variance read at the
occupied voxels, labels written once: a copy of the port's
tools/kernel_times.bound_bytes("cluster_labels", G, M), kept here so that
the yardstick does not move with the port). M is counted by the benchmark
itself, from the reference's segmentation grid of each frame it handed
over. The bound is the bytes over the H100's 3.35 TB/s; the share is the
bound over the device time of the kernel's passes in the trace.

Kernel 1's passes are the CUDA kernels named in KERNELS (the tiled
union-find of csrc/tiled_union_find.cuh). Kernels 2 and 3 run the same
templates but are on no path a cell drives.
"""

from benchmark import harness

KERNELS = ("tile_pass_kernel", "seam_pass_kernel", "tile_compress_kernel")


def bound_bytes(G: int, M: int) -> int:
    return G * 1 + M * 8 + G * 4


def read(ctx):
    occupied = ctx.get("occupied_voxels")
    seconds = ctx["trace"].device_s(
        lambda name: any(k in name for k in KERNELS))
    if not occupied or seconds <= 0:
        return None
    G = ctx["grid_voxels"]
    total = sum(bound_bytes(G, M) for M in occupied)
    return 100.0 * total / harness.HBM_BYTES_PER_S / seconds
