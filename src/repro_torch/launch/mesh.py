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
process group.  `fake_process_group` starts the one group of the dry-run
(``launch/dryrun.py``): every rank of a production mesh on one process,
no data and no transfers.

Hardware constants used by the roofline analysis (``launch/roofline.py``)
live here too: NVIDIA's published figures for the H100 SXM5 80 GB at its
700 W limit, the card the port targets.  The reference's are a TPU
v5e's.
"""
from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

# H100 SXM5 80 GB, 700 W (NVIDIA's datasheet): dense bf16 tensor-core peak
PEAK_FLOPS_BF16 = 989.4e12          # FLOP/s
# H100 SXM5 80 GB, 700 W: HBM3 bandwidth
HBM_BANDWIDTH = 3.35e12             # B/s
# H100 SXM5 80 GB, 700 W: HBM3 capacity, the memory per GPU of a dry-run
# without a card (with one, `device_memory_bytes` reads the card's)
HBM_BYTES = 80e9
# H100 SXM5 80 GB, 700 W: NVLink 4 (18 links), per direction — the link
# of a collective group whose ranks all sit in one node
NVLINK_BANDWIDTH = 450e9            # B/s
# one 400 Gb/s InfiniBand NDR port per GPU (an 8-GPU HGX H100 node) — the
# link of a collective group that leaves its node
NETWORK_BANDWIDTH = 50e9            # B/s
GPUS_PER_NODE = 8


def link_of(ranks) -> str:
    """``"nvlink"`` when every rank of a collective group sits in one
    ``GPUS_PER_NODE``-GPU node (ranks numbered node by node), else
    ``"network"``."""
    ranks = list(ranks)
    return "nvlink" if ranks and (min(ranks) // GPUS_PER_NODE
                                  == max(ranks) // GPUS_PER_NODE) \
        else "network"


def device_memory_bytes(device="cpu") -> float:
    """Memory per GPU: the card's when ``device`` is a card, else
    ``HBM_BYTES``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return float(torch.cuda.get_device_properties(
            resolve_device(dev)).total_memory)
    return HBM_BYTES


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A ``torch.distributed`` default group of ``world_size`` ranks in
    this process, all but rank 0 imaginary: the ``"fake"`` backend
    (``FakeStore``), whose collectives move nothing.  The dry-run's mesh
    lives on it; destroyed on exit.  Refuses to start beside another
    group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group already exists; the dry-run "
                           "runs in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


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


def make_mesh(sizes: dict, device="cuda") -> DeviceMesh:
    """A mesh named and sized by ``sizes`` ({axis: ranks}, in mesh-dim
    order) over the world, which must hold exactly that many ranks."""
    dt = _device_type(device)
    _ensure_group(dt)
    return _mesh(dt, tuple(sizes.values()), tuple(sizes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"
                         ) -> DeviceMesh:
    """The reference's production layout: ("data", "model") = (16, 16),
    or ("pod", "data", "model") = (2, 16, 16); the world must hold
    exactly 256 or 512 ranks."""
    if multi_pod:
        return make_mesh({"pod": 2, "data": 16, "model": 16}, device)
    return make_mesh({"data": 16, "model": 16}, device)


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
