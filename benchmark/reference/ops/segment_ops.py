"""Segment reductions keyed by voxel, patch or cluster id (counterpart of
dr_using_scv_od_tpu/ops/segment_ops.py).

The JAX package computes large histograms as one-hot matmuls and reads
small tables through select trees, because scatters and gathers are slow
on a TPU. Here they are direct: `bincount` with exact float64 weights,
`scatter_reduce` for min/max, and plain indexing for table lookups. So
two JAX functions have no counterpart: `small_table_lookup` (a select
tree in place of an indexed gather) and `segment_minmax_bcast` (a
broadcast compare in place of the min/max scatter of `segment_minmax`).
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


def segment_count(ids: torch.Tensor, valid: torch.Tensor, num: int
                  ) -> torch.Tensor:
    """[num] int32 count of the `valid` rows of each id in [0, num)
    (segment_ops.py:28)."""
    return torch.bincount(_bucket(ids, num, valid),
                          minlength=num + 1)[:num].to(torch.int32)


def segment_mean(x: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
                 num: int) -> torch.Tensor:
    """Per-id mean of the `valid` rows of x ([M] or [M, K]); empty ids give
    0 (segment_ops.py:239). The sums are `segment_sum`'s, in row order."""
    s = segment_sum(x, torch.where(valid, ids, -1), num)
    n = torch.clamp_min(segment_count(ids, valid, num).to(x.dtype), 1)
    return s / (n[:, None] if x.dim() > 1 else n)


def grid_label_counts(labels: torch.Tensor, num: int,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """[num] int32 histogram of the labels in [0, num); others ignored
    (replaces the one-hot matmul of segment_ops.py:35-83). With `weights`
    (integer-valued, same shape) the [num] float32 weight sums instead,
    exact in float64 for any integer weights below 2**53, so the JAX
    function's `weight_bound` has no counterpart."""
    if weights is not None:
        return grid_label_hist_multi(labels, num, [weights])[1][0]
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


def grid_label_hist2(labels: torch.Tensor, num: int, weights: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weighted histogram [num] f32, counts [num] int32): the JAX
    function's order of `grid_label_hist_multi`'s two outputs
    (segment_ops.py:127)."""
    counts, (wsum,) = grid_label_hist_multi(labels, num, [weights])
    return wsum, counts


def _segment_extreme(x: torch.Tensor, ids: torch.Tensor,
                     valid: torch.Tensor, num: int, reduce: str,
                     empty: float) -> torch.Tensor:
    seg = _bucket(ids, num, valid)
    if x.dim() > 1:
        seg = seg.reshape(-1, *([1] * (x.dim() - 1))).expand_as(x)
    out = torch.full((num + 1,) + tuple(x.shape[1:]), empty, dtype=x.dtype,
                     device=x.device)
    return out.scatter_reduce(0, seg, x, reduce)[:num]


def segment_min(x: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
                num: int) -> torch.Tensor:
    """Per-id minimum of the float rows of x ([N] or [N, D]) with
    `valid & ids >= 0`; empty ids give +inf (segment_ops.py:170)."""
    return _segment_extreme(x, ids, valid, num, "amin", float("inf"))


def segment_max(x: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
                num: int) -> torch.Tensor:
    """Per-id maximum, as `segment_min`; empty ids give -inf
    (segment_ops.py:178)."""
    return _segment_extreme(x, ids, valid, num, "amax", float("-inf"))


def segment_minmax(x: torch.Tensor, ids: torch.Tensor,
                   valid: torch.Tensor, num: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-id (min, max) of [N, D] rows with `valid & ids >= 0`; empty ids
    give +inf / -inf (replaces segment_minmax_bcast,
    segment_ops.py:203-236; min and max are exact in any order)."""
    return (segment_min(x, ids, valid, num),
            segment_max(x, ids, valid, num))
