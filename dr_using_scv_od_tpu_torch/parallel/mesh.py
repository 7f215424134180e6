"""Process groups for the parallel layer (counterpart of
dr_using_scv_od_tpu/parallel/mesh.py: make_mesh, frame_sharding,
replicated).

The JAX package runs one controller over a device mesh. The port runs one
process per rank on `torch.distributed`: each rank calls the same function
with the same global inputs and gets the same global (replicated) outputs
back, the values a JAX caller reads from a sharded program. The backend
follows the device: NCCL for a CUDA device (one card per rank), gloo for
the CPU. Every group is one-dimensional: the JAX package builds a 2-D mesh
only in tests/test_sharding.py:27-33 and never calls one, so a rank's place
is its index in the group.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist


def init_group(device: torch.device | str, rank: int, world_size: int,
               init_method: str,
               timeout: datetime.timedelta = datetime.timedelta(seconds=60)
               ) -> torch.device:
    """Join the default process group as `rank` of `world_size` through
    `init_method` (for example `file:///tmp/store` or
    `tcp://localhost:29500`): NCCL on a CUDA `device` (made the current
    card first), gloo on the CPU. Returns the device."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method=init_method, rank=rank,
                                world_size=world_size, timeout=timeout,
                                device_id=device)
    else:
        dist.init_process_group("gloo", init_method=init_method, rank=rank,
                                world_size=world_size, timeout=timeout)
    return device


def group_device() -> torch.device:
    """The device the default group was initialized for: the current card
    under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def rank(group=None) -> int:
    return dist.get_rank(group)


def world_size(group=None) -> int:
    return dist.get_world_size(group)


def frame_block(F: int, rank: int, world: int) -> slice:
    """The contiguous frames of `rank` when F frames split over `world`
    ranks; F must divide evenly, as a P(axis) sharding requires."""
    if F % world:
        raise ValueError(f"F={F} frames do not split over {world} ranks")
    k = F // world
    return slice(rank * k, (rank + 1) * k)


def subgroup(n: int):
    """The group of the first n ranks. Every rank of the default group must
    call this (a collective); ranks >= n get a handle they may not use."""
    return dist.new_group(ranks=list(range(n)))


def pack(tensors) -> tuple:
    """(float32 words, int32 words): the tensors flattened and joined by
    kind, bools as int32 (NCCL moves no bool), for one message of each."""
    fl = [t.reshape(-1) for t in tensors if t.is_floating_point()]
    it = [t.reshape(-1).to(torch.int32) for t in tensors
          if not t.is_floating_point()]
    dev = tensors[0].device
    return (torch.cat(fl) if fl else torch.zeros(0, device=dev),
            torch.cat(it) if it else torch.zeros(0, dtype=torch.int32,
                                                 device=dev))


def unpack(words: tuple, like) -> list:
    """Inverse of `pack` for tensors of the shapes and dtypes of `like`."""
    parts = {True: iter(()), False: iter(())}
    for kind, w in zip((True, False), words):
        sizes = [t.numel() for t in like if t.is_floating_point() == kind]
        parts[kind] = iter(torch.split(w, sizes))
    return [next(parts[t.is_floating_point()]).reshape(t.shape).to(t.dtype)
            for t in like]
