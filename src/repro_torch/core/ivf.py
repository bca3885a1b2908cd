"""IVF (inverted-file) index: spherical k-means + fixed-bucket inverted
lists — the warm tier's periodic re-cluster — and the standalone probe
query over them (`ivf_query`).

Mirrors `repro/core/ivf.py` over torch tensors on any device, with
static shapes (the lists are (K, bucket) with -1 padding).  One
deliberate difference: the reference draws the first farthest-first
seed with ``jax.random.choice``, which torch cannot reproduce.  The port
draws that index from ``numpy.random.default_rng(seed)`` with the same
validity-weighted distribution (``first_seed``); ``kmeans(first=...)``
injects a given index instead, which is how the parity tests hand both
sides the same seed.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.topk import topk_stable


class IVFState(NamedTuple):
    centroids: torch.Tensor   # (K, D) unit-norm
    members: torch.Tensor     # (K, bucket) int32 row ids, -1 = empty
    keys: torch.Tensor        # (N, D) unit-norm
    valid: torch.Tensor       # (N,) bool
    value_ids: torch.Tensor   # (N,) int32
    sizes: torch.Tensor       # (K,) int32


def _unit(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim,
                                        keepdim=True).clamp_min(1e-9)


def first_seed(valid: torch.Tensor, seed: int) -> int:
    """The first k-means seed: one valid row drawn uniformly (any row
    when none is valid), from a numpy generator seeded with ``seed``."""
    p = valid.cpu().numpy().astype(np.float64)
    if p.sum() == 0:
        p = np.ones_like(p)
    return int(np.random.default_rng(seed).choice(len(p), p=p / p.sum()))


def _farthest_first_init(keys: torch.Tensor, valid: torch.Tensor, k: int,
                         first: int) -> torch.Tensor:
    """Greedy farthest-point seeding from row ``first``: each next seed
    is the valid row least similar to every seed chosen so far (lowest
    index on ties)."""
    idx = [torch.full((1,), first, dtype=torch.long, device=keys.device)]
    nearest = keys @ keys[first]
    inf = torch.tensor(float("inf"), device=keys.device)
    for _ in range(k - 1):
        nxt = torch.argmin(torch.where(valid, nearest, inf)).view(1)
        nearest = torch.maximum(nearest, keys @ keys.index_select(0, nxt)[0])
        idx.append(nxt)
    return torch.cat(idx)


def kmeans(keys: torch.Tensor, valid: torch.Tensor, k: int, iters: int = 8,
           seed: int = 0, first: Optional[int] = None) -> torch.Tensor:
    """Spherical k-means over the valid rows (cosine geometry)."""
    if first is None:
        first = first_seed(valid, seed)
    idx = _farthest_first_init(keys, valid, k, first)
    cent = _unit(keys[idx])
    vf = valid.to(keys.dtype)[:, None]
    for _ in range(iters):
        sims = keys @ cent.T                                  # (N, K)
        sims = torch.where(valid[:, None], sims,
                           torch.tensor(float("-inf"), device=keys.device))
        assign = torch.argmax(sims, dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(keys.dtype) * vf
        sums = onehot.T @ keys                                # (K, D)
        counts = onehot.sum(0)[:, None]
        cent = torch.where(counts > 0, _unit(sums), cent)
    return cent


def build_lists(keys: torch.Tensor, valid: torch.Tensor,
                centroids: torch.Tensor, bucket: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assign valid rows to their nearest centroid and fill the
    fixed-capacity inverted lists (row order within a list; overflow
    dropped).  Returns (members (K, bucket) int32 with -1 padding,
    sizes (K,) int32)."""
    n_clusters = centroids.shape[0]
    N = keys.shape[0]
    dev = keys.device
    sims = keys @ centroids.T
    sims = torch.where(valid[:, None], sims,
                       torch.tensor(float("-inf"), device=dev))
    assign = torch.argmax(sims, dim=1)
    assign = torch.where(valid, assign, n_clusters)        # invalid -> drop
    order = torch.sort(assign, stable=True).indices
    sorted_c = assign[order]
    starts = torch.searchsorted(sorted_c,
                                torch.arange(n_clusters, device=dev),
                                right=False)
    pos = torch.arange(N, device=dev) \
        - starts[sorted_c.clamp(0, n_clusters - 1)]
    keep = (pos < bucket) & (sorted_c < n_clusters)
    members = torch.full((n_clusters * bucket,), -1, dtype=torch.int32,
                         device=dev)
    members[(sorted_c * bucket + pos)[keep]] = order[keep].to(torch.int32)
    sizes = torch.bincount(assign, minlength=n_clusters + 1)[:n_clusters]
    return (members.reshape(n_clusters, bucket),
            sizes.clamp_max(bucket).to(torch.int32))


def build_ivf(keys: torch.Tensor, valid: torch.Tensor,
              value_ids: torch.Tensor, *, n_clusters: int = 64,
              bucket: int = 256, kmeans_iters: int = 8, seed: int = 0,
              first: Optional[int] = None) -> IVFState:
    """Cluster the store and fill fixed-capacity inverted lists."""
    keys = _unit(keys.float())
    cent = kmeans(keys, valid, n_clusters, kmeans_iters, seed, first)
    members, sizes = build_lists(keys, valid, cent, bucket)
    return IVFState(centroids=cent, members=members, keys=keys,
                    valid=valid, value_ids=value_ids.to(torch.int32),
                    sizes=sizes)


def ivf_query(state: IVFState, q: torch.Tensor, threshold: float,
              k: int = 1, n_probe: int = 4):
    """q: (Q, D) -> (scores (Q, k), slots (Q, k), value_ids (Q, k), hit
    (Q,)).  Probes the ``n_probe`` nearest lists; ties in both top-k's
    go to the lowest index, as ``lax.top_k``."""
    q = _unit(q.float())
    Q = q.shape[0]
    K, bucket = state.members.shape
    n_probe = min(n_probe, K)
    _, probes = topk_stable(q @ state.centroids.T, n_probe)   # (Q, P)
    cand = state.members[probes].reshape(Q, n_probe * bucket)
    safe = cand.clamp(0, state.keys.shape[0] - 1).long()
    ok = (cand >= 0) & state.valid[safe]
    scores = torch.einsum("qd,qnd->qn", q, state.keys[safe])
    scores = torch.where(ok, scores, torch.full_like(scores, -1e30))
    top_s, top_i = topk_stable(scores, k)
    slots = torch.gather(safe, 1, top_i)
    return top_s, slots, state.value_ids[slots], top_s[:, 0] >= threshold


def ivf_occupancy(state: IVFState) -> torch.Tensor:
    """Fraction of valid rows actually reachable through the lists."""
    listed = state.sizes.sum()
    total = state.valid.sum().clamp_min(1)
    return listed / total
