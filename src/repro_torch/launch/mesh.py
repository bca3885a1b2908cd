"""Device-mesh builders — the port of `repro/launch/mesh.py` over
``torch.distributed``.

The reference is one process over many devices; the port is SPMD: one
process per rank, and a ``DeviceMesh`` (from
``torch.distributed.device_mesh.init_device_mesh``) whose dimensions are
named like the reference's mesh axes.  Every builder needs a process
group: when none exists it starts one — from the ``torchrun``
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``) when that is
set, else a group of world size 1 in this process (NCCL on a card, gloo
on the CPU), so a plain ``python -m repro_torch.launch.serve
--cache-shards 2`` runs one shard, as the reference does on one
device.  A caller that runs several ranks on one card starts a gloo
group itself first (NCCL takes one rank per device).

Functions, not module-level meshes: importing this module starts no
process group.  The reference's TPU roofline constants are not ported
here; the H100's arrive with the roofline slice.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device


def _device_type(device) -> str:
    """The mesh's device type: the card unless the caller asks for the
    CPU (raises without a card, as every entry point)."""
    return resolve_device(device).type


def _ensure_group(device_type: str) -> int:
    """Start the default process group if none exists; returns the world
    size."""
    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            if device_type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    return dist.get_world_size()


def _mesh(device_type: str, shape, names) -> DeviceMesh:
    n = dist.get_world_size()
    size = 1
    for s in shape:
        size *= s
    if size != n:
        raise ValueError(f"a {shape} mesh needs {size} ranks; the process "
                         f"group has {n}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"
                         ) -> DeviceMesh:
    """The reference's production layout: ("data", "model") = (16, 16),
    or ("pod", "data", "model") = (2, 16, 16); the world must hold
    exactly 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dt = _device_type(device)
    _ensure_group(dt)
    return _mesh(dt, shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, device="cuda"
                   ) -> DeviceMesh:
    """A small ("data", "model") mesh over the ranks that exist: each
    axis is clamped to the world size, as the reference clamps to the
    device count; the clamped mesh must cover every rank."""
    dt = _device_type(device)
    n = _ensure_group(dt)
    data = min(data, n)
    model = min(model, max(n // data, 1))
    return _mesh(dt, (data, model), ("data", "model"))


def make_cache_mesh(model: int | None = None, device="cuda") -> DeviceMesh:
    """Mesh for the sharded warm tier of the cache service (DESIGN.md
    §8): one warm shard per rank of the ``model`` axis, queries, hot tier
    and thresholds replicated.  ``model=None`` spans the world; otherwise
    the axis is clamped to the world size."""
    dt = _device_type(device)
    n = _ensure_group(dt)
    return make_host_mesh(1, n if model is None else max(1, model), device)
