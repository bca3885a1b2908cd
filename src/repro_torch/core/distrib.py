"""Shared distributed top-k schedule: local candidates, tiny merge — the
port of `repro/core/distrib.py` over ``torch.distributed``.

Every sharded lookup — the flat store (`store.query_sharded`) and the
sharded warm tier of the tiered cache (`cache_service.tiers.cascade_query`
with a mesh, DESIGN.md §8) — uses the same two steps: each shard computes
a LOCAL top-k over its slice of the corpus, then a tiny all-gather moves
only the (Q, k) candidate panels and a final top-k merges them.  The
collective is O(Q · k · shards), never O(Q · N).

  * `merge_local_topk`   — the collective form: one process per shard
    (a rank of ``group``), each holding its own (Q, k) candidates;
  * `merge_stacked_topk` — the single-process oracle over shard-stacked
    (S, Q, k) candidates.  The all-gather concatenates the ranks' panels
    in rank order (shard-major), exactly what the stacked reshape gives,
    so both forms pick the same winners, ties included.

Selection is `core.topk.topk_stable`: ties go to the lowest concatenated
index, as ``lax.top_k``'s do (``torch.topk`` promises no order), so they
resolve to the earliest shard, then to the earlier candidate within it
— the sharded cascade relies on that to keep hot-tier candidates
(shard 0, column 0) winning ties.

On a ``DeviceMesh`` the reference's ``shard_map`` primitives are:
``lax.axis_index`` — ``mesh.get_local_rank(axis)``; the tiled
``lax.all_gather`` — `all_gather` over ``mesh.get_group(axis)``;
``lax.psum`` — `all_reduce` (or a max / min).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.core.topk import topk_stable


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along the mesh axis named ``axis``."""
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def all_gather(group, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def all_reduce(group, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``op`` over every rank's ``x`` (a new tensor; ``x`` is kept)."""
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def merge_local_topk(group, k: int, scores: torch.Tensor,
                     *payloads: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Merge every rank's (Q, k) candidates into the global top-k.

    ``scores`` (float32) and every payload (integers that fit int32, or
    flags) are this rank's column-aligned local candidates.  They travel
    as one int32 stack — the scores' bits unchanged — in ONE all-gather
    over ``group`` into shard-major (Q, k · S) panels, and the global
    top-k is selected once on the scores.  Returns ``(merged_scores,
    *merged_payloads)``, each (Q, k), in its input's dtype, equal on
    every rank."""
    panel = torch.stack([scores.float().view(torch.int32)]
                        + [p.to(torch.int32) for p in payloads])
    every = all_gather(group, panel, 2)              # (1 + P, Q, k * S)
    sm, im = topk_stable(every[0].view(torch.float32), k)
    return (sm,) + tuple(torch.gather(every[1 + j], 1, im).to(p.dtype)
                         for j, p in enumerate(payloads))


def merge_stacked_topk(k: int, scores: torch.Tensor,
                       *payloads: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Single-process oracle of `merge_local_topk`: ``scores`` and the
    payloads are shard-stacked (S, Q, k), concatenated shard-major, as
    the all-gather does."""
    def flat(x):                                   # (S, Q, k) -> (Q, S*k)
        return x.transpose(0, 1).reshape(x.shape[1], -1)

    sm, im = topk_stable(flat(scores), k)
    return (sm,) + tuple(torch.gather(flat(p), 1, im) for p in payloads)
