"""Pipeline parallelism: the per-frame pipeline as a stage pipeline over
ranks (counterpart of dr_using_scv_od_tpu/parallel/pipeline_parallel.py;
see its docstring for the design).

GPipe-style schedule without weights: the stages are *compute* stages of
the per-frame pipeline (ground segmentation -> curved-voxel segmentation
-> recognition), one per rank. Frames are the microbatches: frame f enters
stage 0 at step f and its activations go from rank s to rank s + 1, so at
steady state all S ranks work on S consecutive frames. Total steps
T = F + S - 1; rank s is busy at steps s .. s + F - 1 and idle in the
(S - 1)-step fill and drain (the JAX program computes on stale frames
there; their outputs are never collected, so a rank here skips them).
Tracking is not part of the chain: it is a sequential cross-frame
recurrence and runs downstream on the collected window, as in run_window.

Activations move as a fixed-shape `PPBuffer`, the superset of every
inter-stage tensor, packed into one float32 and one int32 message. The
port's recognition reads the segmentation's per-cluster planar-point
count, so `n_planar` rides the buffer; the JAX stage's recognition inputs
(`point_voxel` over `xyz`) are not needed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional

import torch
import torch.distributed as dist

from ..config import PipelineConfig
from ..models import patchwork, recognition, segmentation
from ..models.recognition import Features
from ..types import ClusterTable, stack
from . import mesh


class PPBuffer(NamedTuple):
    """Superset of all inter-stage activations (fixed shapes)."""
    xyz: torch.Tensor            # [N,3]
    intensity: torch.Tensor      # [N]
    valid: torch.Tensor          # [N] bool
    nonground: torch.Tensor      # [N] bool   (stage: ground)
    ground: torch.Tensor         # [N] bool
    dropped: torch.Tensor        # [N] bool
    point_voxel: torch.Tensor    # [N] i32    (stage: segment)
    point_cluster: torch.Tensor  # [N] i32
    label_grid: torch.Tensor     # [G] i32
    table: ClusterTable          # [C] rows
    n_planar: torch.Tensor       # [C] f32
    feats: Features              # [C] slots  (stage: recognize)
    n_clusters: torch.Tensor     # scalar i32


def _zeros_buffer(cfg: PipelineConfig, device) -> PPBuffer:
    N = cfg.shapes.max_points
    G = cfg.grid.bin_num
    C = cfg.shapes.max_clusters

    def f32(*s):
        return torch.zeros(s, dtype=torch.float32, device=device)

    def i32(*s):
        return torch.zeros(s, dtype=torch.int32, device=device)

    def b(*s):
        return torch.zeros(s, dtype=torch.bool, device=device)

    table = ClusterTable(valid=b(C), n_points=i32(C), n_voxels=i32(C),
                         bbox_min=f32(C, 3), bbox_max=f32(C, 3),
                         type=i32(C), state=i32(C), track_id=i32(C))
    feats = Features(*(f32(C) for _ in Features._fields))
    return PPBuffer(xyz=f32(N, 3), intensity=f32(N), valid=b(N),
                    nonground=b(N), ground=b(N), dropped=b(N),
                    point_voxel=i32(N), point_cluster=i32(N),
                    label_grid=i32(G), table=table, n_planar=f32(C),
                    feats=feats, n_clusters=i32())


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    return [leaf for t in tree for leaf in _leaves(t)]


def _rebuild(like, leaves):
    """A tree shaped like `like` from an iterator over its leaves."""
    if isinstance(like, torch.Tensor):
        return next(leaves)
    if dataclasses.is_dataclass(like):
        return type(like)(**{f.name: _rebuild(getattr(like, f.name), leaves)
                             for f in dataclasses.fields(like)})
    return type(like)(*(_rebuild(t, leaves) for t in like))


def _stage_ground(buf: PPBuffer, cfg: PipelineConfig) -> PPBuffer:
    pw = patchwork.estimate_ground(buf.xyz, buf.valid, cfg.patchwork)
    return buf._replace(nonground=pw.nonground, ground=pw.ground,
                        dropped=pw.dropped)


def _stage_segment(buf: PPBuffer, cfg: PipelineConfig) -> PPBuffer:
    seg, point_voxel, _grid = segmentation.segment_frame(
        buf.xyz, buf.intensity, buf.nonground, buf.ground, buf.dropped, cfg)
    return buf._replace(point_voxel=point_voxel,
                        point_cluster=seg.point_cluster,
                        label_grid=seg.label_grid, table=seg.clusters,
                        n_planar=seg.n_planar, n_clusters=seg.n_clusters)


def _stage_recognize(buf: PPBuffer, cfg: PipelineConfig) -> PPBuffer:
    table, feats = recognition.recognize(buf.table, buf.n_planar, cfg)
    return buf._replace(table=table, feats=feats)


_LOGICAL_STAGES = (_stage_ground, _stage_segment, _stage_recognize)


def make_stages(cfg: PipelineConfig, n_stages: int
                ) -> List[Callable[[PPBuffer], PPBuffer]]:
    """Partition the 3 logical stages into `n_stages` contiguous groups
    (fused when n_stages < 3; n_stages > 3 leaves pass-through tail stages,
    useful only for schedule testing)."""
    if n_stages < 1:
        raise ValueError("n_stages must be >= 1")
    n_logical = len(_LOGICAL_STAGES)
    groups: List[List] = [[] for _ in range(n_stages)]
    for i, st in enumerate(_LOGICAL_STAGES):
        g = i if n_stages >= n_logical else (i * n_stages) // n_logical
        groups[g].append(st)

    def fuse(fns):
        def run(buf):
            for fn in fns:
                buf = fn(buf, cfg)
            return buf
        return run

    return [fuse(g) for g in groups]


class PPWindowResult(NamedTuple):
    point_voxel: torch.Tensor    # [F,N]
    point_cluster: torch.Tensor  # [F,N]
    label_grid: torch.Tensor     # [F,G]
    table: ClusterTable          # [F,C]
    feats: Features              # [F,C]
    n_clusters: torch.Tensor     # [F]


def _collect(buf: PPBuffer) -> PPWindowResult:
    return PPWindowResult(buf.point_voxel, buf.point_cluster, buf.label_grid,
                          buf.table, buf.feats, buf.n_clusters)


def pipelined_process_window(xyz: torch.Tensor, intensity: torch.Tensor,
                             valid: torch.Tensor, cfg: PipelineConfig,
                             n_stages: Optional[int] = None
                             ) -> PPWindowResult:
    """Run the per-frame pipeline over [F, ...] inputs with its stages on
    ranks 0 .. n_stages - 1 (default: every rank of the world). Called on
    every rank with the whole window; results are identical to
    `pipeline.process_window`'s (same stage functions, same order) and
    every rank of the world gets them."""
    S = n_stages or mesh.world_size()
    if S > mesh.world_size():
        raise ValueError(f"{S} stages need {S} ranks")
    stages = make_stages(cfg, S)
    s = mesh.rank()
    F = int(xyz.shape[0])
    buf0 = _zeros_buffer(cfg, xyz.device)
    like = _leaves(buf0)
    collected = []
    for t in range(F + S - 1 if s < S else 0):
        f = t - s
        if not 0 <= f < F:
            continue                  # fill / drain: no frame at this stage
        if s == 0:
            buf = buf0._replace(xyz=xyz[f], intensity=intensity[f],
                                valid=valid[f])
        else:
            words = tuple(torch.empty_like(w) for w in mesh.pack(like))
            for w in words:
                dist.recv(w, s - 1)
            buf = _rebuild(buf0, iter(mesh.unpack(words, like)))
        out = stages[s](buf)
        if s < S - 1:
            for w in mesh.pack(_leaves(out)):
                dist.send(w, s + 1)
        else:
            collected.append(_collect(out))

    # the last stage's outputs to every rank
    result = stack(collected or [_collect(buf0)] * F)
    leaves = _leaves(result)
    words = mesh.pack(leaves)
    for w in words:
        dist.broadcast(w, S - 1)
    return _rebuild(result, iter(mesh.unpack(words, leaves)))
