"""Build this copy's config dataclasses from a configuration file of
`benchmark/configs/`: the file's `pipeline` object holds every field of
`PipelineConfig` and its `engine` object (or null) every field of
`EngineConfig`, nested groups as objects and tuples as lists.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from . import config
from .models import engine


def build_dataclass(default: Any, doc: Dict[str, Any]) -> Any:
    """`default` with every field replaced by `doc`'s value of the same
    name, nested dataclasses built the same way. Raises on a field that
    `doc` lacks or a key that is no field: the file holds the whole
    configuration as it is run."""
    names = [f.name for f in dataclasses.fields(default)]
    missing = [n for n in names if n not in doc]
    unknown = [k for k in doc if k not in names]
    if missing or unknown:
        raise KeyError(f"{type(default).__name__}: missing {missing}, "
                       f"unknown {unknown}")
    kw = {}
    for name in names:
        cur, val = getattr(default, name), doc[name]
        if dataclasses.is_dataclass(cur):
            val = build_dataclass(cur, val)
        elif isinstance(cur, tuple):
            val = tuple(val)
        kw[name] = val
    return dataclasses.replace(default, **kw)


def pipeline_config(doc: Dict[str, Any]) -> config.PipelineConfig:
    return build_dataclass(config.PipelineConfig(), doc["pipeline"])


def engine_config(doc: Dict[str, Any]) -> Optional[engine.EngineConfig]:
    if doc.get("engine") is None:
        return None
    return build_dataclass(engine.EngineConfig(), doc["engine"])
