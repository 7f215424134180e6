"""Segment reductions keyed by voxel, patch or cluster id (counterpart of
the parts of dr_using_scv_od_tpu/ops/segment_ops.py that run_window uses).

The JAX package computes large histograms as one-hot matmuls and reads
small tables through select trees, because scatters and gathers are slow
on a TPU. Here they are direct: `bincount` with exact float64 weights,
`scatter_reduce` for min/max, and plain indexing for table lookups.
"""

from __future__ import annotations

from typing import List, Tuple

import torch


def _bucket(ids: torch.Tensor, num: int, valid=None) -> torch.Tensor:
    """int64 ids with anything outside [0, num) (or not `valid`) routed to
    an overflow bucket `num`."""
    ok = (ids >= 0) & (ids < num)
    if valid is not None:
        ok = ok & valid
    return torch.where(ok, ids, num).long()


def segment_sum(x: torch.Tensor, ids: torch.Tensor, num: int
                ) -> torch.Tensor:
    """Per-id sums of the rows of x ([M] or [M, K]) for ids in [0, num);
    other ids are dropped.

    Deterministic on every device: rows are stably sorted by id and each
    segment is summed in one sequential pass (`segment_reduce`), so the
    float result does not depend on thread timing, and each sum runs in
    row order, as a sequential scatter-add does."""
    return segment_sum_planned(x, *segment_plan(ids, num), num)


def segment_plan(ids: torch.Tensor, num: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, lengths) of `segment_sum` over `ids`, for callers that sum
    several arrays over the same ids: the stable sort by id, and the row
    count of each id in [0, num] (num is the dropped bucket)."""
    seg = _bucket(ids, num)
    seg_sorted, order = torch.sort(seg, stable=True)
    return order, torch.bincount(seg_sorted, minlength=num + 1)


def segment_sum_planned(x: torch.Tensor, order: torch.Tensor,
                        lengths: torch.Tensor, num: int) -> torch.Tensor:
    """`segment_sum` with the plan of `segment_plan`."""
    # unsafe=True skips a host-synchronising check of lengths.sum(); the
    # lengths count exactly the rows of x
    return torch.segment_reduce(x[order], "sum", lengths=lengths,
                                axis=0, unsafe=True)[:num]


def grid_label_counts(labels: torch.Tensor, num: int) -> torch.Tensor:
    """[num] int32 histogram of the labels in [0, num); others ignored
    (replaces the one-hot matmul of segment_ops.py:35-83)."""
    return torch.bincount(_bucket(labels, num),
                          minlength=num + 1)[:num].to(torch.int32)


def grid_label_hist_multi(labels: torch.Tensor, num: int,
                          weights: List[torch.Tensor]
                          ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(counts [num] int32, [weighted sums [num] f32]) over labels in
    [0, num) (replaces segment_ops.py:86-124). Weights are integer-valued
    (points per voxel), so the float64 sums are exact in any order."""
    seg = _bucket(labels, num)
    counts = torch.bincount(seg, minlength=num + 1)[:num].to(torch.int32)
    sums = [torch.bincount(seg, weights=w.double(),
                           minlength=num + 1)[:num].float()
            for w in weights]
    return counts, sums


def segment_minmax(x: torch.Tensor, ids: torch.Tensor,
                   valid: torch.Tensor, num: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-id (min, max) of [N, D] rows with `valid & ids >= 0`; empty ids
    give +inf / -inf (replaces segment_minmax_bcast,
    segment_ops.py:203-236; min and max are exact in any order)."""
    D = x.shape[-1]
    seg = _bucket(ids, num, valid)[:, None].expand(-1, D)
    lo = torch.full((num + 1, D), float("inf"), dtype=x.dtype,
                    device=x.device).scatter_reduce(0, seg, x, "amin")
    hi = torch.full((num + 1, D), float("-inf"), dtype=x.dtype,
                    device=x.device).scatter_reduce(0, seg, x, "amax")
    return lo[:num], hi[:num]
