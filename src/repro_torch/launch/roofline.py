"""Roofline terms of a dry-run, the port of `repro/launch/roofline.py`
with the H100's constants (``launch/mesh.py``).

Three terms per (arch × shape × mesh), in seconds:

  compute    = per_device_flops / PEAK_FLOPS_BF16
  memory     = per_device_bytes / HBM_BANDWIDTH
  collective = sum over collectives of moved bytes / the group's link

Flops and bytes are the dry-run's per-device counts (``launch/dryrun.py``
counts each op's local work).  The collectives are records of the
calls that ``DTensor`` and the port's own sharded code issued —
`CollectiveRecord` (op, output bytes, group size, link) — not parsed
HLO text.  Each is weighted by the reference's ring-transfer factors;
its link is NVLink 4 (``NVLINK_BANDWIDTH``) when the group's ranks sit
in one 8-GPU node, else the GPU's InfiniBand NDR port
(``NETWORK_BANDWIDTH``): on the 16x16 and 2x16x16 production meshes
every group (16 ranks along ``model``, 16 along ``data``, 2 along
``pod``) leaves its node.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterable

from repro_torch.launch.mesh import (
    HBM_BANDWIDTH, NETWORK_BANDWIDTH, NVLINK_BANDWIDTH, PEAK_FLOPS_BF16,
)

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
LINK_BANDWIDTH = {"nvlink": NVLINK_BANDWIDTH, "network": NETWORK_BANDWIDTH}


@dataclass(frozen=True)
class CollectiveRecord:
    """One collective as issued on this rank: ``op`` in the reference's
    names (``all-gather``, ...), ``out_bytes`` its output's bytes,
    ``group`` the size of its group (``None``: every device), ``link``
    ``"nvlink"`` or ``"network"``, ``shape`` its output's shape."""
    op: str
    out_bytes: int
    group: int | None = None
    link: str = "network"
    shape: tuple = ()


def moved_bytes(op: str, b: float, n: int) -> float:
    """Per-device bytes a ring moves for a collective with ``b`` output
    bytes over ``n`` ranks (the reference's factors)."""
    if op == "all-reduce":
        return 2.0 * (n - 1) / max(n, 1) * b
    if op in ("all-gather", "all-to-all"):
        return (n - 1) / max(n, 1) * b
    if op == "reduce-scatter":
        return (n - 1) * b                 # output is the shard
    return b                               # collective-permute


def collective_bytes(records: Iterable[CollectiveRecord],
                     n_devices: int) -> Dict[str, float]:
    """Per-device bytes moved, by collective type (ring model), with the
    counts, the top-8 largest collectives, and the bytes per link."""
    out: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    links: Dict[str, float] = defaultdict(float)
    top: list = []
    for r in records:
        if r.op not in _COLLECTIVES:
            raise ValueError(f"unknown collective {r.op!r}")
        n = r.group if r.group is not None else n_devices
        moved = moved_bytes(r.op, r.out_bytes, n)
        out[r.op] += moved
        counts[r.op] += 1
        links[r.link] += moved
        top.append((moved, r.op, str(list(r.shape)), n))
    out["total"] = sum(v for k, v in out.items() if k != "total")
    out["counts"] = dict(counts)  # type: ignore
    out["by_link"] = dict(links)  # type: ignore
    top.sort(reverse=True)
    out["top_ops"] = [  # type: ignore
        {"moved_bytes": t[0], "op": t[1], "shape": t[2], "group": t[3]}
        for t in top[:8]]
    return dict(out)


def roofline_terms(cost: dict, records: Iterable[CollectiveRecord],
                   n_devices: int) -> dict:
    """cost: {"flops", "bytes accessed"} per device."""
    flops = float(cost.get("flops", 0.0))
    bytes_accessed = float(cost.get("bytes accessed", 0.0))
    coll = collective_bytes(records, n_devices)
    t_coll = sum(b / LINK_BANDWIDTH[link]
                 for link, b in coll["by_link"].items())
    terms = {
        "per_device_flops": flops,
        "per_device_bytes": bytes_accessed,
        "per_device_collective_bytes": coll["total"],
        "collective_breakdown": {k: v for k, v in coll.items()
                                 if k not in ("total", "counts", "top_ops",
                                              "by_link")},
        "collective_counts": coll.get("counts", {}),
        "collective_top_ops": coll.get("top_ops", []),
        "collective_by_link": coll["by_link"],
        "t_compute": flops / PEAK_FLOPS_BF16,
        "t_memory": bytes_accessed / HBM_BANDWIDTH,
        "t_collective": t_coll,
    }
    dom = max(("compute", "memory", "collective"),
              key=lambda k: terms[f"t_{k}"])
    terms["bottleneck"] = dom
    t_max = terms[f"t_{dom}"]
    terms["roofline_fraction"] = (terms["t_compute"] / t_max) if t_max else 0.0
    terms["t_bound"] = t_max
    return terms


def model_flops(cfg, shape, n_layers_active=None) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (forward-only serving), with
    N = active params for MoE."""
    n = cfg.param_count(active_only=cfg.moe is not None)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
