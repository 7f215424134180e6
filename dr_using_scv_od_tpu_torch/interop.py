"""State carried across from the JAX package.

The system has no learned weights: its parameters are the frozen
`PipelineConfig`, the streaming tracking carry (table, label_grid,
counter) that `run_window(init_track=...)` takes, the GICP state (a
voxel map and its finalized target), and the SLAM engine's `EngineConfig`
and `EngineState`. These functions rebuild them from plain Python / numpy
values (`dataclasses.asdict` of a JAX config, arrays fetched with
`np.asarray`, an engine state's `jax.tree.leaves`), so nothing here
imports JAX.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import List, Mapping, Sequence, Tuple

import numpy as np
import torch

from .config import PipelineConfig
from .models import engine
from .models.gicp import GicpTarget, VoxelMap
from .types import ClusterTable

_TABLE_DTYPES = {
    "valid": torch.bool, "n_points": torch.int32, "n_voxels": torch.int32,
    "bbox_min": torch.float32, "bbox_max": torch.float32,
    "type": torch.int32, "state": torch.int32, "track_id": torch.int32,
}


def _build(cls, d: Mapping):
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}")
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        t = hints[f.name]
        if dataclasses.is_dataclass(t):
            v = _build(t, v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[f.name] = v
    return cls(**kw)


def config_from_reference(d: Mapping) -> PipelineConfig:
    """The port's PipelineConfig from `dataclasses.asdict` of a JAX
    PipelineConfig (lists, e.g. from JSON, become tuples)."""
    return _build(PipelineConfig, d)


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def cluster_table_from_numpy(fields: Mapping[str, np.ndarray],
                             device: torch.device | str) -> ClusterTable:
    """A ClusterTable on `device` from a mapping of field name to array
    (a JAX ClusterTable's fields fetched with np.asarray)."""
    return ClusterTable(**{name: _tensor(fields[name], dtype, device)
                           for name, dtype in _TABLE_DTYPES.items()})


def track_carry_from_numpy(table: Mapping[str, np.ndarray],
                           label_grid: np.ndarray, counter,
                           device: torch.device | str
                           ) -> Tuple[ClusterTable, torch.Tensor,
                                      torch.Tensor]:
    """The streaming carry (table, label_grid [G] int32, counter scalar
    int32) of `run_window(init_track=...)` on `device`."""
    return (cluster_table_from_numpy(table, device),
            _tensor(label_grid, torch.int32, device),
            _tensor(counter, torch.int32, device).reshape(()))


def window_from_numpy(win: Mapping[str, np.ndarray],
                      device: torch.device | str):
    """(xyz, intensity, valid, poses) tensors on `device` from a window
    dict of utils/synthetic.render_window."""
    return (_tensor(win["xyz"], torch.float32, device),
            _tensor(win["intensity"], torch.float32, device),
            _tensor(win["valid"], torch.bool, device),
            _tensor(win["poses"], torch.float32, device))


def voxel_map_from_numpy(fields: Mapping[str, np.ndarray],
                         device: torch.device | str) -> VoxelMap:
    """A gicp.VoxelMap on `device` from a mapping of field name to array
    (a JAX VoxelMap's `_asdict()`)."""
    return VoxelMap(n=_tensor(fields["n"], torch.float32, device),
                    sum_x=_tensor(fields["sum_x"], torch.float32, device),
                    sum_xx=_tensor(fields["sum_xx"], torch.float32, device),
                    n_oob=_tensor(fields["n_oob"], torch.int32,
                                  device).reshape(()))


def gicp_target_from_numpy(fields: Mapping[str, np.ndarray],
                           device: torch.device | str) -> GicpTarget:
    """A gicp.GicpTarget on `device` from a mapping of field name to array
    (a JAX GicpTarget's `_asdict()`)."""
    return GicpTarget(mean=_tensor(fields["mean"], torch.float32, device),
                      weight=_tensor(fields["weight"], torch.float32, device),
                      valid=_tensor(fields["valid"], torch.bool, device))


def engine_config_from_reference(d: Mapping) -> engine.EngineConfig:
    """The port's EngineConfig (with its nested DescriptorConfig and
    ErasorConfig) from `dataclasses.asdict` of a JAX EngineConfig."""
    return _build(engine.EngineConfig, d)


def engine_state_from_numpy(leaves: Sequence[np.ndarray],
                            device: torch.device | str
                            ) -> engine.EngineState:
    """An EngineState on `device` from a JAX EngineState's leaves in
    `jax.tree.leaves` order (each fetched with np.asarray); every leaf
    keeps its dtype."""
    return engine.state_from_leaves(
        [torch.from_numpy(np.array(a)).to(device) for a in leaves])


def engine_state_to_numpy(state: engine.EngineState) -> List[np.ndarray]:
    """The state's leaves as numpy arrays, in the JAX package's
    `jax.tree.leaves` order (`jax.tree.unflatten` of the JAX state's
    treedef rebuilds a JAX EngineState from them)."""
    return [t.detach().cpu().numpy() for t in engine.state_leaves(state)]
