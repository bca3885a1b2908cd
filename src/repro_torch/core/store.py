"""The flat cache's device-resident vector store — the port of
`repro/core/store.py`.

A fixed-capacity store whose state is a tuple of device tensors:
insert, query, touch and evict are functions of a state that return a
new one (the tensors are cloned where written, as the reference's
functional updates are).  Eviction: first free slot, else the least
recently used (a Lamport clock bumped on hits, lowest slot on ties);
TTL eviction is a mask update on int32 clock differences.

`query` scores through `kernels.cosine_topk.ops` (the CUDA kernel on a
card, its plain version on the CPU), or an injected ``topk_fn``.
`query_sharded` splits the corpus over a mesh axis (one rank per
block) and merges the blocks' local top-k (`core.distrib`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.topk import topk_stable
from repro_torch.kernels.cosine_topk import ops as _topk_ops


class StoreState(NamedTuple):
    keys: torch.Tensor         # (N, D) float32, unit-norm rows
    valid: torch.Tensor        # (N,)  bool
    last_used: torch.Tensor    # (N,)  int32 Lamport clock
    inserted_at: torch.Tensor  # (N,)  int32
    value_ids: torch.Tensor    # (N,)  int32 host-side response index
    clock: torch.Tensor        # ()    int32


class QueryResult(NamedTuple):
    scores: torch.Tensor       # (Q, k) cosine similarity, desc
    slots: torch.Tensor        # (Q, k) store rows
    value_ids: torch.Tensor    # (Q, k)
    hit: torch.Tensor          # (Q,)  best score >= threshold


def store_axes() -> StoreState:
    """Logical sharding axes (encoded strings) of the store's tensors:
    corpus rows over the ``corpus`` axis, the clock a scalar."""
    return StoreState(
        keys="corpus,.", valid="corpus", last_used="corpus",
        inserted_at="corpus", value_ids="corpus", clock="",
    )


def init_store(capacity: int, dim: int, device="cpu") -> StoreState:
    i32 = torch.int32
    return StoreState(
        keys=torch.zeros((capacity, dim), dtype=torch.float32,
                         device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        last_used=torch.zeros((capacity,), dtype=i32, device=device),
        inserted_at=torch.zeros((capacity,), dtype=i32, device=device),
        value_ids=torch.full((capacity,), -1, dtype=i32, device=device),
        clock=torch.zeros((), dtype=i32, device=device))


def _normalise(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-9)


def insert(state: StoreState, emb: torch.Tensor,
           value_id) -> StoreState:
    """Insert one embedding (D,) with its response id."""
    vid = torch.as_tensor(value_id, dtype=torch.int32,
                          device=state.keys.device).reshape(1)
    return insert_batch(state, emb[None], vid)


def insert_batch(state: StoreState, embs: torch.Tensor,
                 value_ids: torch.Tensor) -> StoreState:
    """Insert B rows with the reference's sequential semantics, without
    a loop: row i takes the first free slot, else the least recently
    used one, and advances the clock by one.

    Every insertion leaves its slot the most recently used, so the
    slots are taken in one fixed cyclic order: the free slots by index,
    then the used ones by (last_used, index), then those again.  Row i
    goes to position ``i mod N`` of that order, with clock ``clock + 1 +
    i``; when B > N, row i is overwritten by row i + N, so only the last
    N rows are written.
    """
    dev = state.keys.device
    embs = torch.as_tensor(embs, device=dev)
    value_ids = torch.as_tensor(value_ids, device=dev)
    B = embs.shape[0]
    if B == 0:
        return state
    N = state.valid.shape[0]
    key = torch.where(state.valid, state.last_used.long(), -1)
    order = torch.sort(key, stable=True).indices                   # (N,)
    rows = torch.arange(max(0, B - N), B, device=dev)
    slots = order[rows % N]
    clocks = (state.clock + 1 + rows).to(torch.int32)
    keys = state.keys.clone()
    keys[slots] = _normalise(embs[rows])
    valid = state.valid.clone()
    valid[slots] = True
    last_used = state.last_used.clone()
    last_used[slots] = clocks
    inserted_at = state.inserted_at.clone()
    inserted_at[slots] = clocks
    vids = state.value_ids.clone()
    vids[slots] = value_ids[rows].to(torch.int32)
    return StoreState(keys, valid, last_used, inserted_at, vids,
                      state.clock + B)


def query(state: StoreState, q: torch.Tensor, threshold: float,
          k: int = 1, topk_fn=None) -> QueryResult:
    """q: (Q, D).  The top-k cosine matches among valid rows.

    ``topk_fn(q, keys, valid, k) -> (scores, slots)`` is the injection
    point; it defaults to `kernels.cosine_topk.ops.cosine_topk`.
    """
    qn = _normalise(q).contiguous()
    fn = topk_fn or _topk_ops.cosine_topk
    scores, slots = fn(qn, state.keys, state.valid, k)
    value_ids = state.value_ids[slots.long()]
    hit = scores[:, 0] >= threshold
    return QueryResult(scores=scores, slots=slots, value_ids=value_ids,
                       hit=hit)


def query_sharded(state: StoreState, q: torch.Tensor, threshold: float,
                  k: int, mesh, axis: str = "model") -> QueryResult:
    """Distributed lookup with the explicit local-top-k + tiny-merge
    schedule (DESIGN.md §3): the corpus rows split into contiguous
    blocks over ``axis`` (rank i of the axis scores rows
    [i·N/S, (i+1)·N/S) of ``state``), each block's local top-k, then one
    all-gather of (Q, k) candidates per rank (`distrib.merge_local_topk`)
    instead of a (Q, N) score matrix.  The queries split over the mesh's
    other axes where the batch divides, and the result is gathered back,
    so every rank returns the whole (Q, k) answer.  As in the reference,
    each block is scored with a plain matmul, outside the cosine top-k
    kernel."""
    from repro_torch.core import distrib
    n_total = state.keys.shape[0]
    n_shards = distrib.axis_size(mesh, axis)
    if n_total % n_shards:
        raise ValueError(f"store of {n_total} rows does not split over "
                         f"{n_shards} shards")
    shard_n = n_total // n_shards
    lo = mesh.get_local_rank(axis) * shard_n
    block = state._replace(keys=state.keys[lo:lo + shard_n],
                           valid=state.valid[lo:lo + shard_n],
                           value_ids=state.value_ids[lo:lo + shard_n])
    return query_block(block, lo, q, threshold, k, mesh, axis)


def query_block(block: StoreState, lo: int, q: torch.Tensor,
                threshold: float, k: int, mesh,
                axis: str = "model") -> QueryResult:
    """This rank's part of `query_sharded`: ``block`` holds the store's
    rows [lo, lo + n) (keys, valid, value ids), which this rank of
    ``axis`` scores; ``q`` is the whole (Q, D) batch."""
    from repro_torch.core import distrib
    qn = _normalise(q)
    batch_axes = [a for a in mesh.mesh_dim_names if a != axis
                  and distrib.axis_size(mesh, a) > 1
                  and q.shape[0] % distrib.axis_size(mesh, a) == 0]
    for a in batch_axes:
        qn = qn.chunk(distrib.axis_size(mesh, a))[mesh.get_local_rank(a)]
    scores = qn @ block.keys.T.to(qn.dtype)                     # (Q, N_loc)
    scores = torch.where(block.valid[None, :], scores, -1e30)
    s, i_loc = topk_stable(scores, k)
    vals = block.value_ids[i_loc]
    s, slots, vals = distrib.merge_local_topk(
        mesh.get_group(axis), k, s, (i_loc + lo).to(torch.int32), vals)
    for a in reversed(batch_axes):
        s, slots, vals = (distrib.all_gather(mesh.get_group(a), x)
                          for x in (s, slots, vals))
    return QueryResult(scores=s, slots=slots, value_ids=vals,
                       hit=s[:, 0] >= threshold)


def touch(state: StoreState, slots: torch.Tensor,
          hit: torch.Tensor) -> StoreState:
    """LRU bump of hit slots (slots, hit: (Q,)); a scatter-max, so a
    slot hit twice takes the clock once, and misses write 0 at slot
    0."""
    clock = state.clock + 1
    safe = torch.where(hit, slots.long(), 0)
    val = torch.where(hit, clock, torch.zeros_like(clock))
    last = state.last_used.scatter_reduce(0, safe, val.to(torch.int32),
                                          reduce="amax", include_self=True)
    return state._replace(last_used=last, clock=clock)


def evict_older_than(state: StoreState, max_age: int) -> StoreState:
    """TTL policy: invalidate entries older than ``max_age`` ticks."""
    expired = (state.clock - state.inserted_at) > max_age
    return state._replace(valid=state.valid & ~expired)


def occupancy(state: StoreState) -> torch.Tensor:
    return state.valid.float().mean()
