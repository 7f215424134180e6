"""Checkpoint / resume for long mapping sessions (counterpart of
dr_using_scv_od_tpu/utils/checkpoint.py): flat .npz archives, single-host,
synchronous, dependency-free.

The key layout is the JAX package's (`leaves/0000`, ...), so a checkpoint
written by either package loads in the other. Tensors are fetched to the
host as numpy arrays of the same dtype. A container that is not a dict
flattens in the port's own field order: dataclass fields in declaration
order (nested ones recursively), then tuple items in order, which is the
order `jax.tree.flatten` gives the JAX package's counterparts.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch


def save(path: str | Path, state: Dict[str, Any]) -> None:
    """Save a dict (nested dicts, containers) of arrays or tensors."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {}
    for k, v in state.items():
        for leaf_path, leaf in _flatten(k, v):
            flat[leaf_path] = _numpy(leaf)
    np.savez_compressed(str(path) + ".npz" if path.suffix != ".npz"
                        else str(path), **flat)


def load(path: str | Path) -> Dict[str, Any]:
    path = Path(path)
    if path.suffix != ".npz":
        path = Path(str(path) + ".npz")
    data = np.load(path, allow_pickle=False)
    out: Dict[str, Any] = {}
    for k in data.files:
        parts = k.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = data[k]
    return out


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def leaves(v) -> list:
    """The leaves of a container of tensors in the port's field order."""
    if isinstance(v, torch.Tensor) or hasattr(v, "shape") or np.isscalar(v):
        return [v]
    if dataclasses.is_dataclass(v):
        return [leaf for f in dataclasses.fields(v)
                for leaf in leaves(getattr(v, f.name))]
    if isinstance(v, (tuple, list)):
        return [leaf for item in v for leaf in leaves(item)]
    if v is None:
        return []
    raise TypeError(f"cannot flatten {type(v).__name__}")


def _flatten(prefix: str, v):
    if isinstance(v, dict):
        for k, sub in v.items():
            yield from _flatten(f"{prefix}/{k}", sub)
    elif isinstance(v, torch.Tensor) or hasattr(v, "shape") \
            or np.isscalar(v):
        yield prefix, v
    else:
        for i, leaf in enumerate(leaves(v)):
            yield f"{prefix}/{i}", leaf
