"""Device half of the tiered multi-tenant cache, over torch tensors.

The port of `repro/cache_service/tiers.py` (single device, one
embedder).  Two tiers share one geometry (unit-norm cosine keys) and one
id space (host-side ``value_ids``):

  * HOT  — a small flat store that absorbs every admitted insert and
    answers with exact brute-force top-k, masked on a tenant column.
  * WARM — a large ring buffer indexed by an IVF (centroids + fixed
    bucket inverted lists).  Cold hot-tier rows are demoted here in
    fixed-size flushes; the IVF is rebuilt periodically, and rows
    appended since the last rebuild stay reachable through a fixed-size
    brute-force *tail* window.

States are NamedTuples of tensors and every operation is functional:
it returns new states and never writes into the ones it was given
(``mask_expired`` hands the cascade a *view* with cleared valid bits
while the stored state stays intact, exactly as in the reference).
Scalars (``clock``, ``cursor``, ``total``, ``indexed_total``) are 0-d
int32 tensors on the tier's device, so a lookup never waits on the
host.

`cascade_query` selects between the four-op composition here
(``fused=False``, the parity reference) and the fused cascade kernel
(`kernels/cascade_lookup`: the hand-written CUDA kernel on a card, its
plain torch version for CPU tensors).

The multi-embedder ensemble (DESIGN.md §13) keeps E row-aligned key
panels beside the tiers (`EnsembleState`); `ensemble_cascade_query`
scores all of them in one pass with per-query mixture weights.

Scale-out (DESIGN.md §8): the warm tier also exists in a *sharded* form,
a ``WarmState`` whose every leaf carries a leading shard axis, one
independent ring and local IVF per shard.  Each shard probes its own
centroids and computes a local top-k (one cascade kernel launch per
shard); the only cross-shard step is the tiny (Q, k · shards) candidate
merge of `core.distrib`, shared with `store.query_sharded`.  The
stacked (S, …) form in one process (``mesh=None``) runs the S shards
one after another and merges with `merge_stacked_topk`: it is the
oracle, and the single-process path.  With a ``DeviceMesh`` the form is
SPMD: each rank holds its own shard as a (1, …) state of plain tensors
(`place_warm_sharded`), every rank runs the same code on the same
replicated hot tier, queries and thresholds, and only four things cross
ranks: the merge's candidate panels, shard 0's hot slots, the ensemble
winner's panel keys, and the warm evictions the host must free.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import distrib
from repro_torch.core import ivf as ivf_lib
from repro_torch.kernels.cascade_lookup import ops as casc_ops
from repro_torch.kernels.cascade_lookup import ref as casc_ref
from repro_torch.core.topk import topk_stable

NEG = -1e30
_I32 = torch.int32
_I32_MAX = torch.iinfo(torch.int32).max


class HotState(NamedTuple):
    keys: torch.Tensor        # (N, D) float32, unit-norm rows
    valid: torch.Tensor       # (N,)  bool
    tenants: torch.Tensor     # (N,)  int32, -1 when invalid
    last_used: torch.Tensor   # (N,)  int32 lamport clock
    inserted_at: torch.Tensor  # (N,) int32
    value_ids: torch.Tensor   # (N,)  int32 host-side response index
    clock: torch.Tensor       # ()    int32
    expires_at: torch.Tensor  # (N,)  float32 expiry, +inf = no TTL


class WarmState(NamedTuple):
    keys: torch.Tensor        # (Nw, D) float32 unit-norm
    valid: torch.Tensor       # (Nw,) bool
    tenants: torch.Tensor     # (Nw,) int32
    value_ids: torch.Tensor   # (Nw,) int32
    write_seq: torch.Tensor   # (Nw,) int32 1-based global write sequence
    cursor: torch.Tensor      # ()    int32 next ring position
    total: torch.Tensor       # ()    int32 total rows ever appended
    centroids: torch.Tensor   # (K, D)
    members: torch.Tensor     # (K, bucket) int32 row ids, -1 empty
    sizes: torch.Tensor       # (K,) int32
    indexed_total: torch.Tensor  # () int32: `total` at the last rebuild
    keys_q: torch.Tensor      # (Nw, D) int8 symmetric per-row quantization
    scales: torch.Tensor      # (Nw,) float32 per-row dequant scale
    expires_at: torch.Tensor  # (Nw,) float32 expiry, +inf = no TTL


class Demoted(NamedTuple):
    keys: torch.Tensor        # (m, D)
    value_ids: torch.Tensor   # (m,)
    tenants: torch.Tensor     # (m,)
    mask: torch.Tensor        # (m,) bool — False rows are padding
    expires: Optional[torch.Tensor] = None   # (m,) float32, None = no TTL


class CascadeResult(NamedTuple):
    scores: torch.Tensor      # (Q, k) best-of-both-tiers cosine, desc
    value_ids: torch.Tensor   # (Q, k) -1 where no candidate
    hot_slots: torch.Tensor   # (Q,)   hot-tier row of the hot top-1
    hot_hit: torch.Tensor     # (Q,)   hit answered by the hot tier
    hit: torch.Tensor         # (Q,)   best score >= per-query threshold


_unit = ivf_lib._unit


def _scalar(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=_I32, device=device)


# ---------------------------------------------------------------------------
# carry-across from the reference (tests)
# ---------------------------------------------------------------------------

def _from_reference(cls, state, device):
    out = {}
    for name in cls._fields:
        a = np.array(getattr(state, name))
        out[name] = torch.from_numpy(a).to(device)
    return cls(**out)


def hot_from_reference(state, device="cpu") -> HotState:
    """A reference ``HotState`` (leaves as numpy or JAX arrays) as the
    port's; dtypes and layouts are identical."""
    return _from_reference(HotState, state, device)


def warm_from_reference(state, device="cpu") -> WarmState:
    """A reference (unsharded) ``WarmState`` as the port's."""
    return _from_reference(WarmState, state, device)


def ensemble_from_reference(state, device="cpu") -> "EnsembleState":
    """A reference (unsharded) ``EnsembleState`` as the port's."""
    return _from_reference(EnsembleState, state, device)


# ---------------------------------------------------------------------------
# hot tier
# ---------------------------------------------------------------------------

def init_hot(capacity: int, dim: int, device="cpu") -> HotState:
    return HotState(
        keys=torch.zeros((capacity, dim), device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        tenants=torch.full((capacity,), -1, dtype=_I32, device=device),
        last_used=torch.zeros((capacity,), dtype=_I32, device=device),
        inserted_at=torch.zeros((capacity,), dtype=_I32, device=device),
        value_ids=torch.full((capacity,), -1, dtype=_I32, device=device),
        clock=_scalar(0, device),
        expires_at=torch.full((capacity,), float("inf"), device=device),
    )


def _insert_chunk(state: HotState, embs, value_ids, tenants, expires
                  ) -> Tuple[HotState, torch.Tensor, torch.Tensor]:
    """Insert up to ``capacity`` rows at once, with the sequential
    semantics of one-row-at-a-time `hot_insert`.  Row r (skipped when
    its value id is < 0) takes the next slot in the order the
    sequential loop would pick them: free slots by ascending index,
    then valid slots by (last_used, index) — within one chunk a freshly
    written slot carries the newest clock, so it is never picked twice.
    Returns (state, evicted (M,), slots (M,) int64: the slot each row
    took, -1 for skipped rows)."""
    cap = state.valid.shape[0]
    dev = state.keys.device
    idx = torch.arange(cap, device=dev, dtype=torch.int64)
    order_key = torch.where(state.valid,
                            (state.last_used.long() + 1) * cap + idx, idx)
    order = torch.argsort(order_key)
    live = value_ids >= 0
    rank = torch.cumsum(live.long(), 0) - 1
    slot = order[rank.clamp_min(0)]
    clock_r = state.clock + 1 + rank.to(_I32)               # per row
    evicted = torch.where(live & state.valid[slot],
                          state.value_ids[slot], -1).to(_I32)
    s = slot[live]
    new = HotState(
        keys=state.keys.clone(), valid=state.valid.clone(),
        tenants=state.tenants.clone(), last_used=state.last_used.clone(),
        inserted_at=state.inserted_at.clone(),
        value_ids=state.value_ids.clone(),
        clock=state.clock + live.sum().to(_I32),
        expires_at=state.expires_at.clone())
    new.keys[s] = _unit(embs.float())[live]
    new.valid[s] = True
    new.tenants[s] = tenants.to(_I32)[live]
    new.last_used[s] = clock_r[live]
    new.inserted_at[s] = clock_r[live]
    new.value_ids[s] = value_ids.to(_I32)[live]
    new.expires_at[s] = expires.float()[live]
    return new, evicted, torch.where(live, slot, -1)


def hot_insert_batch(state: HotState, embs: torch.Tensor,
                     value_ids: torch.Tensor, tenants: torch.Tensor,
                     expires: Optional[torch.Tensor] = None
                     ) -> Tuple[HotState, torch.Tensor]:
    """Sequential batch insert; ``value_id < 0`` rows are admission
    skips (no-op).  ``expires`` (float32, None = +inf) stamps each row's
    TTL deadline.  Returns (state, evicted (M,) int32): the response id
    of each overwritten valid slot (else -1), for host GC."""
    M = embs.shape[0]
    if expires is None:
        expires = torch.full((M,), float("inf"), device=embs.device)
    state, evicted, _ = _insert_chunks(state, embs, value_ids, tenants,
                                       expires)
    return state, evicted


def _insert_chunks(state: HotState, embs, value_ids, tenants, expires):
    """`_insert_chunk` over capacity-sized chunks, in order; returns
    (state, evicted (M,), per-chunk [(lo, slots)])."""
    cap = state.valid.shape[0]
    out, slots = [], []
    for lo in range(0, embs.shape[0], cap):
        state, ev, sl = _insert_chunk(state, embs[lo:lo + cap],
                                      value_ids[lo:lo + cap],
                                      tenants[lo:lo + cap],
                                      expires[lo:lo + cap])
        out.append(ev)
        slots.append((lo, sl))
    evicted = torch.cat(out) if out else torch.zeros(0, dtype=_I32,
                                                     device=embs.device)
    return state, evicted, slots


def hot_insert(state: HotState, emb, value_id, tenant, expires=None
               ) -> Tuple[HotState, torch.Tensor]:
    """Insert one embedding; returns (state, evicted_value_id)."""
    dev = state.keys.device
    exp = None if expires is None else \
        torch.as_tensor(expires, dtype=torch.float32, device=dev).view(1)
    state, ev = hot_insert_batch(
        state, torch.as_tensor(emb, device=dev).view(1, -1),
        torch.as_tensor(value_id, dtype=_I32, device=dev).view(1),
        torch.as_tensor(tenant, dtype=_I32, device=dev).view(1), exp)
    return state, ev[0]


def hot_touch(state: HotState, slots: torch.Tensor,
              hit: torch.Tensor) -> HotState:
    """LRU bump for hit slots (slots: (Q,), hit: (Q,))."""
    clock = state.clock + 1
    safe = torch.where(hit, slots.long(), 0)
    vals = torch.where(hit, clock, torch.zeros_like(clock))
    last = state.last_used.scatter_reduce(0, safe, vals, "amax",
                                          include_self=True)
    return state._replace(last_used=last, clock=clock)


def hot_query(state: HotState, q: torch.Tensor, q_tenants: torch.Tensor,
              k: int = 1):
    """Exact tenant-masked top-k.  q: (Q, D), q_tenants: (Q,) int32."""
    qn = _unit(q.float())
    scores = qn @ state.keys.T                                    # (Q, N)
    ok = state.valid[None, :] & (state.tenants[None, :]
                                 == q_tenants[:, None])
    scores = torch.where(ok, scores, NEG)
    s, slots = topk_stable(scores, k)
    vids = torch.where(s > NEG / 2, state.value_ids[slots], -1)
    return s, slots.to(_I32), vids.to(_I32)


def coldest_slots(state: HotState, m: int) -> torch.Tensor:
    """The m coldest hot slots in demotion order: ascending
    (last_used, inserted_at, slot), invalid rows last."""
    big = _I32_MAX
    lu = torch.where(state.valid, state.last_used, big).long()
    ins = torch.where(state.valid, state.inserted_at, big).long()
    return torch.sort(lu * (1 << 32) + ins, stable=True).indices[:m]


def demote_coldest(state: HotState, m: int) -> Tuple[HotState, Demoted]:
    """Pop the m least-recently-used valid rows for warm-tier flush
    (ties on ``last_used`` break on the insertion sequence, then slot).
    ``mask`` is False on padding rows (fewer than m valid)."""
    idx = coldest_slots(state, m)
    mask = state.valid[idx]
    valid = state.valid.clone()
    valid[idx] = False
    dem = Demoted(keys=state.keys[idx], value_ids=state.value_ids[idx],
                  tenants=state.tenants[idx], mask=mask,
                  expires=state.expires_at[idx])
    return state._replace(valid=valid), dem


# ---------------------------------------------------------------------------
# warm tier
# ---------------------------------------------------------------------------

def quantize_rows(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per-row quantization of a (…, D) key panel:
    ``keys ≈ q8 * scale[..., None]`` with scale = amax/127 (round half
    to even, as the reference).  Returns (q8 int8, scale float32)."""
    amax = keys.abs().amax(dim=-1)
    scale = amax.clamp_min(1e-9) / 127.0
    q8 = torch.round(keys / scale[..., None]).clamp(-127, 127)
    return q8.to(torch.int8), scale.float()


def requantize(state: WarmState) -> WarmState:
    """Refresh ``keys_q``/``scales`` from ``keys``."""
    q8, sc = quantize_rows(state.keys)
    return state._replace(keys_q=q8, scales=sc)


def init_warm(capacity: int, dim: int, n_clusters: int, bucket: int,
              device="cpu") -> WarmState:
    return WarmState(
        keys=torch.zeros((capacity, dim), device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        tenants=torch.full((capacity,), -1, dtype=_I32, device=device),
        value_ids=torch.full((capacity,), -1, dtype=_I32, device=device),
        write_seq=torch.zeros((capacity,), dtype=_I32, device=device),
        cursor=_scalar(0, device),
        total=_scalar(0, device),
        centroids=torch.zeros((n_clusters, dim), device=device),
        members=torch.full((n_clusters, bucket), -1, dtype=_I32,
                           device=device),
        sizes=torch.zeros((n_clusters,), dtype=_I32, device=device),
        indexed_total=_scalar(0, device),
        keys_q=torch.zeros((capacity, dim), dtype=torch.int8, device=device),
        scales=torch.zeros((capacity,), device=device),
        expires_at=torch.full((capacity,), float("inf"), device=device),
    )


def warm_append(state: WarmState, dem: Demoted
                ) -> Tuple[WarmState, torch.Tensor]:
    """Ring-buffer append of a demoted batch (m <= warm capacity).

    Returns (state, evicted (m,) int32) — response ids of overwritten
    ring slots, -1 padding.  Appended rows stay unindexed until the
    next rebuild; the cascade's tail window keeps them reachable.  The
    int8 panel and the TTL column are maintained in the same update.
    """
    cap = state.keys.shape[0]
    offs = torch.cumsum(dem.mask.to(_I32), 0, dtype=_I32) - 1
    pos = (state.cursor + offs) % cap
    evicted = torch.where(dem.mask & state.valid[pos],
                          state.value_ids[pos], -1).to(_I32)
    n = dem.mask.sum().to(_I32)
    seqs = state.total + 1 + offs
    kn = _unit(dem.keys.float())
    k8, sc = quantize_rows(kn)
    exp = dem.expires.float() if dem.expires is not None else \
        torch.full(dem.mask.shape, float("inf"), device=kn.device)
    d = pos[dem.mask].long()
    m = dem.mask
    new = state._replace(
        keys=state.keys.clone(), valid=state.valid.clone(),
        tenants=state.tenants.clone(), value_ids=state.value_ids.clone(),
        write_seq=state.write_seq.clone(),
        cursor=(state.cursor + n) % cap, total=state.total + n,
        keys_q=state.keys_q.clone(), scales=state.scales.clone(),
        expires_at=state.expires_at.clone())
    new.keys[d] = kn[m]
    new.valid[d] = True
    new.tenants[d] = dem.tenants.to(_I32)[m]
    new.value_ids[d] = dem.value_ids.to(_I32)[m]
    new.write_seq[d] = seqs[m]
    new.keys_q[d] = k8[m]
    new.scales[d] = sc[m]
    new.expires_at[d] = exp[m]
    return new, evicted


def warm_rebuild(state: WarmState, iters: int = 8, seed: int = 0,
                 first: Optional[int] = None) -> WarmState:
    """Re-cluster the warm corpus and refill the inverted lists
    (spherical k-means + the same static list fill as `build_ivf`);
    ``first`` injects the k-means seed row (see `core.ivf`)."""
    n_clusters, bucket = state.members.shape
    cent = ivf_lib.kmeans(state.keys, state.valid, n_clusters, iters, seed,
                          first)
    members, sizes = ivf_lib.build_lists(state.keys, state.valid, cent,
                                         bucket)
    return state._replace(centroids=cent, members=members, sizes=sizes,
                          indexed_total=state.total.clone())


def warm_publish_index(current: WarmState, shadow: WarmState) -> WarmState:
    """Swap a shadow-built IVF (DESIGN.md §7) into the live warm state.

    Only the index moves (centroids, inverted lists, sizes,
    ``indexed_total``); keys, valid bits and the ring counters stay the
    *current* ring's, which may have advanced past the shadow's
    snapshot.  ``indexed_total`` becomes the snapshot's total, so every
    row appended after the snapshot keeps ``write_seq > indexed_total``
    and stays in the tail window, and ring slots overwritten since the
    snapshot drop out of the stale lists by the same test."""
    return current._replace(centroids=shadow.centroids,
                            members=shadow.members, sizes=shadow.sizes,
                            indexed_total=shadow.indexed_total)


# ---------------------------------------------------------------------------
# the sharded warm tier (DESIGN.md §8)
# ---------------------------------------------------------------------------

def init_warm_sharded(shards: int, capacity: int, dim: int, n_clusters: int,
                      bucket: int, device="cpu") -> WarmState:
    """Stacked warm tier: ``shards`` independent rings of ``capacity``
    rows and ``n_clusters`` local centroids each."""
    one = init_warm(capacity, dim, n_clusters, bucket, device)
    return WarmState(*(x[None].expand((shards,) + x.shape).clone()
                       for x in one))


def stack_warm(states) -> WarmState:
    """Stack per-shard WarmStates into the sharded (leading-axis) form."""
    return WarmState(*(torch.stack(xs) for xs in zip(*states)))


def _shard(state: WarmState, j: int) -> WarmState:
    return WarmState(*(x[j] for x in state))


def local_shard(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """``x``'s leading shard axis cut to this rank's (1, …) slice; a leaf
    whose leading axis is 1 is already local and is returned as is."""
    if x.shape[0] == 1:
        return x
    S = distrib.axis_size(mesh, axis)
    if x.shape[0] != S:
        raise ValueError(f"leading axis {x.shape[0]} is neither 1 nor the "
                         f"{S} shards of mesh axis {axis!r}")
    i = mesh.get_local_rank(axis)
    return x[i:i + 1].contiguous()


def place_warm_sharded(warm: WarmState, mesh, axis: str = "model"
                       ) -> WarmState:
    """Commit a stacked warm state to the mesh: this rank keeps its own
    shard as a (1, …) state of plain contiguous tensors (the reference
    lays the leading axis over ``axis``; the CUDA kernels take plain
    tensors, so no DTensor).  Every later op keeps the (1, …) form."""
    return WarmState(*(local_shard(x, mesh, axis) for x in warm))


def _round_robin(x: torch.Tensor, shards: int) -> torch.Tensor:
    """(m, …) -> (S, m/S, …): batch row j goes to shard ``j % S``."""
    return x.reshape((x.shape[0] // shards, shards) + x.shape[1:]) \
        .transpose(0, 1)


def _demoted_per_shard(dem: Demoted, shards: int) -> Demoted:
    m = dem.keys.shape[0]
    if m % shards:
        raise ValueError(f"demoted batch {m} not divisible by {shards} "
                         "shards")
    exp = dem.expires if dem.expires is not None else torch.full(
        dem.mask.shape, float("inf"), device=dem.keys.device)
    return Demoted(*(_round_robin(x, shards)
                     for x in dem._replace(expires=exp.float())))


def _held_shards(state: WarmState, mesh, axis: str):
    """(shard count, the shard index of each stacked position held
    here): every shard in the stacked form, this rank's on a mesh."""
    if mesh is None:
        S = state.keys.shape[0]
        return S, list(range(S))
    return distrib.axis_size(mesh, axis), [mesh.get_local_rank(axis)]


def warm_append_sharded(state: WarmState, dem: Demoted, mesh=None,
                        axis: str = "model"
                        ) -> Tuple[WarmState, torch.Tensor]:
    """Round-robin a demoted batch over the shard rings: row j lands on
    shard ``j % S``, so every flush loads the shards evenly.  ``m`` must
    divide by the shard count (`CacheService` snaps ``flush_size`` to a
    multiple of it).  Returns (state, evicted (m,) int32) in the
    reference's shard-major order; on a mesh each rank appends its own
    rows and the evicted ids are all-gathered, so every rank frees the
    same strings."""
    S, held = _held_shards(state, mesh, axis)
    dem_s = _demoted_per_shard(dem, S)
    out, evicted = [], []
    for j, s in enumerate(held):
        st, ev = warm_append(_shard(state, j), Demoted(*(x[s] for x in dem_s)))
        out.append(st)
        evicted.append(ev)
    evicted = torch.stack(evicted)
    if mesh is not None:
        evicted = distrib.all_gather(mesh.get_group(axis), evicted)
    return stack_warm(out), evicted.reshape(-1)


def warm_rebuild_sharded(state: WarmState, iters: int = 8, seed: int = 0,
                         first=None) -> WarmState:
    """Per-shard re-cluster of the stacked warm tier: each shard its own
    spherical k-means over its local rows, with the same ``seed``
    (``first``: one injected seed row per shard, or None)."""
    n = state.keys.shape[0]
    first = [None] * n if first is None else list(first)
    return stack_warm([warm_rebuild(_shard(state, j), iters, seed, first[j])
                       for j in range(n)])


def _warm_candidates(state: WarmState, qn, q_tenants, n_probe: int,
                     tail: int):
    """IVF probe + unindexed-tail candidate panel: (safe (Q, C) row
    ids, ok (Q, C) mask)."""
    Q = qn.shape[0]
    cap = state.keys.shape[0]
    n_clusters, bucket = state.members.shape
    n_probe = min(n_probe, n_clusters)
    csims = qn @ state.centroids.T                                 # (Q, K)
    _, probes = topk_stable(csims, n_probe)
    cand = state.members[probes].reshape(Q, n_probe * bucket)
    is_tail = torch.zeros(cand.shape, dtype=torch.bool, device=qn.device)
    if tail:
        # floor-mod, as the reference's jnp `%`: torch's `%` on tensors
        # is torch.remainder, which takes the divisor's sign too
        offs = torch.arange(tail, dtype=_I32, device=qn.device)
        tail_idx = (state.cursor - 1 - offs) % cap
        unindexed = state.write_seq[tail_idx] > state.indexed_total
        tail_cand = torch.where(unindexed, tail_idx, -1).to(_I32)
        cand = torch.cat([cand, tail_cand[None, :].expand(Q, tail)], 1)
        is_tail = torch.cat(
            [is_tail, torch.ones((Q, tail), dtype=torch.bool,
                                 device=qn.device)], 1)
    safe = cand.clamp(0, cap - 1).long()
    ok = (cand >= 0) & state.valid[safe] \
        & (state.tenants[safe] == q_tenants[:, None]) \
        & (is_tail | (state.write_seq[safe] <= state.indexed_total))
    return safe, ok


def publish_reembedded_keys(hot: HotState, warm: WarmState,
                            hot_keys: torch.Tensor, warm_keys: torch.Tensor
                            ) -> Tuple[HotState, WarmState]:
    """Swap both tiers' key panels for re-embedded ones (DESIGN.md §11):
    full-capacity (Nh, D) / (Nw, D) replacements, re-normalized here,
    with the warm int8 mirror requantized in the same update.  Per-slot
    metadata, ring counters and the IVF are untouched."""
    hk = _unit(hot_keys.float())
    wk = _unit(warm_keys.float())
    q8, sc = quantize_rows(wk)
    return (hot._replace(keys=hk),
            warm._replace(keys=wk, keys_q=q8, scales=sc))


def warm_query(state: WarmState, q: torch.Tensor, q_tenants: torch.Tensor,
               k: int = 1, n_probe: int = 8, tail: int = 0,
               quantized: bool = False):
    """IVF probe + unindexed-tail scan, tenant-masked.  ``quantized``
    scores the candidates from the int8 panel (fp32 accumulation, times
    the row scale), as the reference's int8 cascade does."""
    qn = _unit(q.float())
    safe, ok = _warm_candidates(state, qn, q_tenants, n_probe, tail)
    if quantized:
        panel = state.keys_q[safe].float()
        scores = torch.einsum("qd,qnd->qn", qn, panel) * state.scales[safe]
    else:
        scores = torch.einsum("qd,qnd->qn", qn, state.keys[safe])
    scores = torch.where(ok, scores, NEG)
    top_s, top_i = topk_stable(scores, k)
    slots = torch.gather(safe, 1, top_i)
    vids = torch.where(top_s > NEG / 2, state.value_ids[slots], -1)
    return top_s, slots.to(_I32), vids.to(_I32)


# ---------------------------------------------------------------------------
# cascade + tenant eviction
# ---------------------------------------------------------------------------

def _merge_tiers(hs, hvids, ws, wvids, wslots, thresholds, k):
    """Best-of-tiers merge (hot side first, so ties resolve hot)."""
    Q = hs.shape[0]
    all_s = torch.cat([hs, ws], 1)                                 # (Q, 2k)
    all_v = torch.cat([hvids, wvids], 1)
    all_w = torch.cat([torch.full((Q, k), -1, dtype=_I32, device=hs.device),
                       wslots], 1)
    s, i = topk_stable(all_s, k)
    hit = s[:, 0] >= thresholds
    return (s, torch.gather(all_v, 1, i), torch.gather(all_w, 1, i),
            hit & (i[:, 0] < k), hit)


def cascade_lookup(hot: HotState, warm: WarmState, q: torch.Tensor,
                   q_tenants: torch.Tensor, thresholds: torch.Tensor,
                   k: int = 1, n_probe: int = 8, tail: int = 0,
                   quantized: bool = False) -> CascadeResult:
    """The four-op lookup over both tiers (hot exact top-k, warm probe,
    bucket gather + tail scan, merge).  ``quantized`` selects the int8
    warm scan and re-scores the merged warm rows exactly, as
    `cascade_query` does on the fused path."""
    hs, hslots, hvids = hot_query(hot, q, q_tenants, k)
    ws, wslots, wvids = warm_query(warm, q, q_tenants, k, n_probe, tail,
                                   quantized)
    wslots = torch.where(ws > NEG / 2, wslots, -1)
    s, vids, out_w, hot_hit, hit = _merge_tiers(hs, hvids, ws, wvids,
                                                wslots, thresholds, k)
    if quantized:
        return _requantized_result(_unit(q.float()), warm, s, vids, out_w,
                                   hslots[:, 0], thresholds, k)
    return CascadeResult(scores=s, value_ids=vids, hot_slots=hslots[:, 0],
                         hot_hit=hot_hit, hit=hit)


def _rescore_exact(qn, keys, s, wslots):
    """Replace quantized-selected warm scores with exact fp32 cosines;
    only the (Q, k) selected rows are gathered from the fp32 panel."""
    safe = wslots.clamp(0, keys.shape[0] - 1).long()
    exact = torch.einsum("qd,qkd->qk", qn, keys[safe])
    return torch.where(wslots >= 0, exact, s)


def _requantized_result(qn, warm, s, vids, wslots, hslots, thresholds, k
                        ) -> CascadeResult:
    """Exact re-score of an int8-selected candidate list, then re-rank
    (the exact scores may reorder the k selected candidates)."""
    s = _rescore_exact(qn, warm.keys, s, wslots)
    s, idx = topk_stable(s, k)
    vids = torch.gather(vids, 1, idx)
    wslots = torch.gather(wslots, 1, idx)
    hit = s[:, 0] >= thresholds
    return CascadeResult(scores=s, value_ids=vids, hot_slots=hslots,
                         hot_hit=hit & (wslots[:, 0] < 0), hit=hit)


def _cascade_ops(hot: HotState, warm: WarmState, qn, qt, thr, k, n_probe,
                 tail, fused, quantized):
    """The flat-array cascade: the kernel dispatch (``fused``: the CUDA
    kernel on a card, its plain version for CPU tensors) or the four-op
    plain version itself.  Returns the 6-tuple (scores, vids,
    warm_slots, hot_slots, hot_hit, hit)."""
    lookup = casc_ops.cascade_lookup if fused else casc_ref.cascade_lookup
    return lookup(
        qn, qt, thr, hot.keys, hot.valid, hot.tenants, hot.value_ids,
        warm.keys, warm.valid, warm.tenants, warm.value_ids,
        warm.write_seq, warm.centroids, warm.members, warm.cursor,
        warm.indexed_total, warm.keys_q, warm.scales, k=k,
        n_probe=n_probe, tail=tail, quantized=quantized)


def _hot_on_shard(hot: HotState, shard_index: int) -> HotState:
    """The replicated hot tier is attributed to shard 0 (its valid mask
    is cleared elsewhere), so the merge never sees a hot row twice."""
    return hot if shard_index == 0 else \
        hot._replace(valid=torch.zeros_like(hot.valid))


def _shard_cascade(hot: HotState, warm: WarmState, qn, qt, thr, k, n_probe,
                   tail, fused, quantized, shard_index: int):
    """One shard's candidates for the sharded cascade: (scores (Q, k),
    vids (Q, k), is_hot (Q, k) int32, hot_slots (Q,)), exact-rescored
    when quantized, so the merge compares true cosines."""
    s, vids, wslots, hslots, _, _ = _cascade_ops(
        _hot_on_shard(hot, shard_index), warm, qn, qt, thr, k, n_probe,
        tail, fused, quantized)
    if quantized:
        s = _rescore_exact(qn, warm.keys, s, wslots)
    return s, vids, ((wslots < 0) & (s > NEG / 2)).to(_I32), hslots


def _sharded_result(s, vids, is_hot, hslots, thr) -> CascadeResult:
    hit = s[:, 0] >= thr
    return CascadeResult(scores=s, value_ids=vids, hot_slots=hslots,
                         hot_hit=hit & (is_hot[:, 0] != 0), hit=hit)


def _cascade_sharded_oracle(hot: HotState, swarm: WarmState, qn, qt, thr,
                            k, n_probe, tail, fused, quantized
                            ) -> CascadeResult:
    """The sharded schedule in one process: shard s's candidates occupy
    columns [s·k, (s+1)·k) of the merge panel, as the all-gather's."""
    per = [_shard_cascade(hot, _shard(swarm, i), qn, qt, thr, k, n_probe,
                          tail, fused, quantized, i)
           for i in range(swarm.keys.shape[0])]
    s, vids, is_hot = distrib.merge_stacked_topk(
        k, *(torch.stack([p[j] for p in per]) for j in range(3)))
    return _sharded_result(s, vids, is_hot, per[0][3], thr)


def _cascade_sharded(hot: HotState, swarm: WarmState, qn, qt, thr, k,
                     n_probe, tail, fused, quantized, mesh, axis
                     ) -> CascadeResult:
    """The sharded schedule on a mesh: this rank's (1, …) shard, one
    (Q, k · S) all-gather merge over ``axis``."""
    i = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    s, vids, is_hot, hslots = _shard_cascade(
        hot, _shard(swarm, 0), qn, qt, thr, k, n_probe, tail, fused,
        quantized, i)
    sm, vm, hm = distrib.merge_local_topk(group, k, s, vids, is_hot)
    # only shard 0 computed real hot slots; the sum hands them to all
    hslot0 = distrib.all_reduce(
        group, hslots if i == 0 else torch.zeros_like(hslots))
    return _sharded_result(sm, vm, hm, hslot0, thr)


def cascade_query(hot: HotState, warm: WarmState, q: torch.Tensor,
                  q_tenants: torch.Tensor, thresholds: torch.Tensor,
                  k: int = 1, n_probe: int = 8, tail: int = 0,
                  fused: bool = False, quantized: bool = False,
                  mesh=None, axis: str = "model",
                  warm_block_n: Optional[int] = None) -> CascadeResult:
    """Cascade lookup with a selectable execution path.

    ``fused=False`` runs the four-op composition (`cascade_lookup`),
    the parity reference.  ``fused=True`` routes through
    `kernels/cascade_lookup`: the hand-written CUDA kernel for tensors
    on a card, its plain torch version for CPU tensors — same results
    either way, up to float32 summation order.  ``quantized=True`` scans
    the warm panel from its int8 form and re-scores the selected rows
    exactly (reported scores are fp32 cosines either way).

    A stacked ``warm`` (leading shard axis, ``keys.ndim == 3``) selects
    the sharded schedule (DESIGN.md §8): a local probe and top-k per
    shard (one cascade launch each, fused or four-op), then the tiny
    (Q, k · shards) merge.  With ``mesh`` this rank runs its own (1, …)
    shard and the merge is a collective over ``axis``; without, the
    stacked oracle runs every shard here (same results bit for bit).
    ``tail`` is then the *per-shard* tail window.
    ``warm_block_n`` is accepted for the reference's signature: it is a
    TPU VMEM-residency knob that never changes results, and the CUDA
    kernel tiles the warm panel internally.
    """
    del warm_block_n
    sharded = warm.keys.ndim == 3
    if mesh is not None and not sharded:
        raise ValueError("cascade_query(mesh=...) needs the stacked "
                         "(sharded) WarmState; see init_warm_sharded")
    qt = q_tenants.to(_I32)
    thr = thresholds.float()
    if sharded:
        qn = _unit(q.float())
        if mesh is None:
            return _cascade_sharded_oracle(hot, warm, qn, qt, thr, k,
                                           n_probe, tail, fused, quantized)
        return _cascade_sharded(hot, warm, qn, qt, thr, k, n_probe, tail,
                                fused, quantized, mesh, axis)
    if not fused:
        return cascade_lookup(hot, warm, q, qt, thr, k=k, n_probe=n_probe,
                              tail=tail, quantized=quantized)
    qn = _unit(q.float())
    s, vids, wslots, hslots, hot_hit, hit = _cascade_ops(
        hot, warm, qn, qt, thr, k, n_probe, tail, True, quantized)
    if quantized:
        return _requantized_result(qn, warm, s, vids, wslots, hslots, thr,
                                   k)
    return CascadeResult(scores=s, value_ids=vids, hot_slots=hslots,
                         hot_hit=hot_hit, hit=hit)


def _gathered(warm_ids: torch.Tensor, group) -> torch.Tensor:
    """A warm op's (1, cap) eviction report, all-gathered over the mesh
    axis's ``group`` into the stacked (S, cap) form (as is without)."""
    return warm_ids if group is None else distrib.all_gather(group,
                                                             warm_ids)


def evict_tenant(hot: HotState, warm: WarmState, tenant, group=None
                 ) -> Tuple[HotState, WarmState, torch.Tensor, torch.Tensor]:
    """Invalidate every row of one tenant in both tiers (either warm
    form: the masks are elementwise).  Returns (hot, warm, hot_evicted,
    warm_evicted): capacity-sized value-id lists (-1 padding) for host
    GC; on a mesh pass the shard axis's ``group``, and every rank gets
    every shard's warm list."""
    h_kill = hot.valid & (hot.tenants == tenant)
    w_kill = warm.valid & (warm.tenants == tenant)
    h_ev = torch.where(h_kill, hot.value_ids, -1)
    w_ev = torch.where(w_kill, warm.value_ids, -1)
    return (hot._replace(valid=hot.valid & ~h_kill),
            warm._replace(valid=warm.valid & ~w_kill), h_ev,
            _gathered(w_ev, group))


# ---------------------------------------------------------------------------
# multi-embedder ensemble: E stacked key panels over the shared tiers
# ---------------------------------------------------------------------------

class EnsembleState(NamedTuple):
    """E row-aligned key panels over the base tiers (DESIGN.md §13).

    The base ``HotState``/``WarmState`` keep every per-slot column, the
    ring counters and the IVF; panel 0 (the *pilot*) duplicates the base
    key panels, so routing and rebuilds stay single-embedder.  The other
    panels are the same rows under the other embedders, kept aligned by
    mirroring every slot decision of the base mutation
    (`ensemble_hot_insert_batch`, `ensemble_warm_append`); `warm_rebuild`
    never moves rows.  In the sharded form the warm leaves gain a leading
    shard axis ((S, E, cap, D) keys, detected by ``warm_keys.ndim == 4``;
    (1, E, cap, D) on a mesh rank) while ``hot_keys`` stays replicated.
    """
    hot_keys: torch.Tensor     # (E, Nh, D) float32 unit-norm
    warm_keys: torch.Tensor    # (E, Nw, D) float32 unit-norm
    warm_keys_q: torch.Tensor  # (E, Nw, D) int8 per-row symmetric quant
    warm_scales: torch.Tensor  # (E, Nw) float32 dequant scales


class EnsembleResult(NamedTuple):
    """`CascadeResult` plus the top-1 candidate's per-embedder cosines
    (``panel_scores``, -1.0 on rows with no candidate): the feedback
    loop's training signal for the per-tenant mixture weights."""
    scores: torch.Tensor       # (Q, k) fused best-of-tiers, desc
    value_ids: torch.Tensor    # (Q, k) -1 where no candidate
    hot_slots: torch.Tensor    # (Q,)
    hot_hit: torch.Tensor      # (Q,)
    hit: torch.Tensor          # (Q,)
    panel_scores: torch.Tensor  # (Q, E) unweighted per-panel cosines


def init_ensemble(n_embedders: int, hot: HotState,
                  warm: WarmState) -> EnsembleState:
    """E copies of the base key panels (a fresh service starts
    all-zero); a sharded warm (S, cap, D) gives (S, E, cap, D)."""
    def exp(x, at=0):
        return x.unsqueeze(at).expand(
            x.shape[:at] + (n_embedders,) + x.shape[at:]).clone()

    at = 1 if warm.keys.ndim == 3 else 0
    return EnsembleState(hot_keys=exp(hot.keys), warm_keys=exp(warm.keys, at),
                         warm_keys_q=exp(warm.keys_q, at),
                         warm_scales=exp(warm.scales, at).float())


def place_ensemble_sharded(ens: "EnsembleState", mesh, axis: str = "model"
                           ) -> "EnsembleState":
    """Commit stacked panels to the mesh: the warm leaves cut to this
    rank's (1, E, …) shard, the hot panels replicated (mirrors
    `place_warm_sharded`)."""
    return ens._replace(warm_keys=local_shard(ens.warm_keys, mesh, axis),
                        warm_keys_q=local_shard(ens.warm_keys_q, mesh, axis),
                        warm_scales=local_shard(ens.warm_scales, mesh, axis))


def make_ensemble(hot_panels: torch.Tensor,
                  warm_panels: torch.Tensor) -> EnsembleState:
    """An `EnsembleState` from raw stacked (E, Nh, D) / (E, Nw, D)
    panels: unit-normalized and quantized (tests and benches)."""
    hk = _unit(hot_panels.float())
    wk = _unit(warm_panels.float())
    q8, sc = quantize_rows(wk)
    return EnsembleState(hot_keys=hk, warm_keys=wk, warm_keys_q=q8,
                         warm_scales=sc)


def ensemble_hot_insert_batch(hot: HotState, ens: EnsembleState,
                              embs: torch.Tensor, value_ids: torch.Tensor,
                              tenants: torch.Tensor,
                              expires: Optional[torch.Tensor] = None
                              ) -> Tuple[HotState, EnsembleState,
                                         torch.Tensor]:
    """`hot_insert_batch` with the E panels mirrored: embs is (B, E, D),
    panel 0 the pilot.  The base insert reports the slot each row took
    and every panel's row is written there, chunk by chunk in the base
    insert's order, so the panels stay row-aligned with the base tier.
    Each panel row is normalized exactly as the base insert normalizes
    the pilot, so panel 0 stays bit-equal to ``hot.keys``.  Returns
    (hot, ens, evicted (B,))."""
    M, E, _ = embs.shape
    if expires is None:
        expires = torch.full((M,), float("inf"), device=embs.device)
    hot, evicted, chunks = _insert_chunks(hot, embs[:, 0].contiguous(),
                                          value_ids, tenants, expires)
    cap = hot.valid.shape[0]
    keys = ens.hot_keys.clone()
    for lo, slots in chunks:
        live = slots >= 0
        for e in range(E):
            kn = _unit(embs[lo:lo + cap, e].contiguous().float())
            keys[e, slots[live]] = kn[live]
    return hot, ens._replace(hot_keys=keys), evicted


def ensemble_warm_append(ens: EnsembleState, warm: WarmState, dem: Demoted,
                         panel_keys: torch.Tensor) -> EnsembleState:
    """Mirror of `warm_append` for the stacked panels: the identical
    ring arithmetic from the *pre-append* warm state, applied to the
    (E, m, D) panel rows of the demoted batch (gathered by the caller
    through `coldest_slots` before the demote).  Call `warm_append` on
    the base state with the same ``dem`` alongside."""
    cap = warm.valid.shape[0]
    offs = torch.cumsum(dem.mask.to(_I32), 0, dtype=_I32) - 1
    d = ((warm.cursor + offs) % cap)[dem.mask].long()
    wk, wq = ens.warm_keys.clone(), ens.warm_keys_q.clone()
    ws = ens.warm_scales.clone()
    for e in range(panel_keys.shape[0]):
        kn = _unit(panel_keys[e].contiguous().float())
        k8, sc = quantize_rows(kn)
        wk[e, d] = kn[dem.mask]
        wq[e, d] = k8[dem.mask]
        ws[e, d] = sc[dem.mask]
    return ens._replace(warm_keys=wk, warm_keys_q=wq, warm_scales=ws)


def ensemble_warm_append_sharded(ens: EnsembleState, warm: WarmState,
                                 dem: Demoted, panel_keys: torch.Tensor,
                                 mesh=None, axis: str = "model"
                                 ) -> EnsembleState:
    """`warm_append_sharded`'s round robin mirrored onto the stacked
    panels: batch row j lands on shard ``j % S`` exactly as the base
    append routes it, so each shard's rows stay aligned.  ``warm`` is
    the *pre-append* sharded state; on a mesh each rank writes its own
    shard's rows."""
    S, held = _held_shards(warm, mesh, axis)
    dem_s = _demoted_per_shard(dem, S)
    E, m = panel_keys.shape[:2]
    pk_s = panel_keys.reshape(E, m // S, S, -1).permute(2, 0, 1, 3)
    out = [ensemble_warm_append(
        EnsembleState(ens.hot_keys, ens.warm_keys[j], ens.warm_keys_q[j],
                      ens.warm_scales[j]),
        _shard(warm, j), Demoted(*(x[s] for x in dem_s)), pk_s[s])
        for j, s in enumerate(held)]
    return ens._replace(warm_keys=torch.stack([o.warm_keys for o in out]),
                        warm_keys_q=torch.stack([o.warm_keys_q for o in out]),
                        warm_scales=torch.stack([o.warm_scales for o in out]))


def publish_panel(ens: EnsembleState, e: int, hot_keys: torch.Tensor,
                  warm_keys: torch.Tensor) -> EnsembleState:
    """Swap ONE embedder's key panels — the E-panel generalization of
    `publish_reembedded_keys`: rows re-normalize and the int8 mirror
    requantizes in the same update; per-slot metadata and the
    pilot-built IVF are untouched.  Publishing panel 0 must go through
    `publish_reembedded_keys` on the base tiers as well (the pilot
    panel duplicates them)."""
    hk = _unit(hot_keys.float())
    wk = _unit(warm_keys.float())
    q8, sc = quantize_rows(wk)
    sharded = ens.warm_keys.ndim == 4        # warm leaves (S, E, cap, …)
    out = []
    for j, (panel, new) in enumerate(zip(ens, (hk, wk, q8, sc))):
        panel = panel.clone()
        if j and sharded:
            panel[:, e] = new
        else:
            panel[e] = new
        out.append(panel)
    return EnsembleState(*out)


def _rescore_exact_fused(qe, w, warm_panels, s, wslots):
    """Exact fp32 re-score of int8-selected warm winners, per panel,
    re-fused with the same stacked contraction the scan used: O(Q·k·E·D)
    on the few selected rows."""
    E = qe.shape[0]
    safe = wslots.clamp(0, warm_panels.shape[1] - 1).long()
    pans = [torch.einsum("qd,qkd->qk", qe[e], warm_panels[e][safe])
            for e in range(E)]
    exact = torch.einsum("qke,qe->qk", torch.stack(pans, -1), w)
    return torch.where(wslots >= 0, exact, s)


def _top1_panel_scores(qe, hot_panels, warm_winner_keys, wslot0, hslots,
                       has):
    """Per-embedder cosines of each query's merged top-1 candidate.
    ``warm_winner_keys`` is the (Q, E, D) gather of the winning warm
    rows; a hot winner is always the hot top-1, so it resolves through
    ``hslots``."""
    hsafe = hslots.clamp(0, hot_panels.shape[1] - 1).long()
    hkeys = hot_panels[:, hsafe].transpose(0, 1)                # (Q, E, D)
    keys = torch.where((wslot0 >= 0)[:, None, None], warm_winner_keys,
                       hkeys)
    ps = torch.einsum("eqd,qed->qe", qe, keys)
    return torch.where(has[:, None], ps, -1.0)


def _ensemble_ops(hot: HotState, warm: WarmState, ens: EnsembleState,
                  qe, w, qt, thr, k, n_probe, tail, fused, quantized):
    """The E-panel cascade: the kernel dispatch (``fused``: the CUDA
    kernel on a card, its plain version for CPU tensors) or the four-op
    plain version itself.  Returns the 6-tuple (scores, vids,
    warm_slots, hot_slots, hot_hit, hit)."""
    lookup = casc_ops.ensemble_lookup if fused else casc_ref.ensemble_lookup
    return lookup(
        qe, w, qt, thr, ens.hot_keys, hot.valid, hot.tenants, hot.value_ids,
        ens.warm_keys, warm.valid, warm.tenants, warm.value_ids,
        warm.write_seq, warm.centroids, warm.members, warm.cursor,
        warm.indexed_total, ens.warm_keys_q, ens.warm_scales, k=k,
        n_probe=n_probe, tail=tail, quantized=quantized)


def _shard_ensemble(hot: HotState, warm: WarmState, ens: EnsembleState,
                    qe, w, qt, thr, k, n_probe, tail, fused, quantized,
                    shard_index: int):
    """One shard's fused-ensemble candidates (mirrors `_shard_cascade`:
    hot attributed to shard 0, the exact fused re-score before the
    merge).  Returns (scores, vids, is_hot, hot_slots, warm_slots)."""
    s, vids, wslots, hslots, _, _ = _ensemble_ops(
        _hot_on_shard(hot, shard_index), warm, ens, qe, w, qt, thr, k,
        n_probe, tail, fused, quantized)
    if quantized:
        s = _rescore_exact_fused(qe, w, ens.warm_keys, s, wslots)
    return s, vids, ((wslots < 0) & (s > NEG / 2)).to(_I32), hslots, wslots


def _ens_shard(ens: EnsembleState, i: int) -> EnsembleState:
    """One shard's panel view ((S, E, …) -> (E, …)); the hot panels are
    replicated, so only the warm leaves index."""
    return ens._replace(warm_keys=ens.warm_keys[i],
                        warm_keys_q=ens.warm_keys_q[i],
                        warm_scales=ens.warm_scales[i])


def _ensemble_result(qe, hot_panels, s, vids, is_hot, hslots, wslot0, wwin,
                     thr) -> EnsembleResult:
    hit = s[:, 0] >= thr
    ps = _top1_panel_scores(qe, hot_panels, wwin, wslot0, hslots,
                            vids[:, 0] >= 0)
    return EnsembleResult(scores=s, value_ids=vids, hot_slots=hslots,
                          hot_hit=hit & (is_hot[:, 0] != 0), hit=hit,
                          panel_scores=ps)


def _ensemble_sharded_oracle(hot, swarm, ens, qe, w, qt, thr, k, n_probe,
                             tail, fused, quantized) -> EnsembleResult:
    """The sharded fused-ensemble schedule in one process: the merge
    carries (vid, is_hot, warm slot, shard), so the winner's panel keys
    are gathered after it."""
    S = swarm.keys.shape[0]
    per = [_shard_ensemble(hot, _shard(swarm, i), _ens_shard(ens, i), qe, w,
                           qt, thr, k, n_probe, tail, fused, quantized, i)
           for i in range(S)]
    cols = torch.stack([torch.full_like(per[0][1], i) for i in range(S)])
    s, vids, is_hot, wslot, wshard = distrib.merge_stacked_topk(
        k, *(torch.stack([p[j] for p in per]) for j in (0, 1, 2, 4)), cols)
    cap = ens.warm_keys.shape[2]
    wwin = ens.warm_keys[wshard[:, 0].clamp(0, S - 1).long(), :,
                         wslot[:, 0].clamp(0, cap - 1).long()]  # (Q, E, D)
    return _ensemble_result(qe, ens.hot_keys, s, vids, is_hot, per[0][3],
                            wslot[:, 0], wwin, thr)


def _ensemble_sharded(hot, swarm, ens, qe, w, qt, thr, k, n_probe, tail,
                      fused, quantized, mesh, axis) -> EnsembleResult:
    """The sharded fused ensemble on a mesh: this rank's (1, …) tiers and
    panels, one (Q, k · S) merge over (vid, is_hot, warm slot, shard).
    Only the owning rank holds the winner's warm rows: it writes its
    (Q, E, D) winners, the others zeros, and one sum hands every rank
    the same keys."""
    i = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    s, vids, is_hot, hslots, wslots = _shard_ensemble(
        hot, _shard(swarm, 0), _ens_shard(ens, 0), qe, w, qt, thr, k,
        n_probe, tail, fused, quantized, i)
    sm, vm, hm, wm, cm = distrib.merge_local_topk(
        group, k, s, vids, is_hot, wslots, torch.full_like(vids, i))
    hslot0 = distrib.all_reduce(
        group, hslots if i == 0 else torch.zeros_like(hslots))
    S = distrib.axis_size(mesh, axis)
    cap = ens.warm_keys.shape[2]
    mine = cm[:, 0].clamp(0, S - 1) == i
    local = ens.warm_keys[0][:, wm[:, 0].clamp(0, cap - 1).long()]
    wwin = distrib.all_reduce(group, torch.where(
        mine[:, None, None], local.transpose(0, 1), 0.0))  # (Q, E, D)
    return _ensemble_result(qe, ens.hot_keys, sm, vm, hm, hslot0, wm[:, 0],
                            wwin, thr)


def ensemble_cascade_query(hot: HotState, warm: WarmState,
                           ens: EnsembleState, q: torch.Tensor,
                           weights: torch.Tensor, q_tenants: torch.Tensor,
                           thresholds: torch.Tensor, k: int = 1,
                           n_probe: int = 8, tail: int = 0,
                           fused: bool = False, quantized: bool = False,
                           mesh=None, axis: str = "model",
                           warm_block_n: Optional[int] = None
                           ) -> EnsembleResult:
    """Fused multi-embedder cascade lookup (DESIGN.md §13).

    q: (Q, E, D), one embedding per embedder per query, panel 0 the
    pilot; weights: (Q, E) per-query mixture weights.  Paths, sharding
    (stacked oracle or ``mesh``) and quantization mirror `cascade_query`
    (``warm_block_n`` likewise has no effect); scores are the weighted
    fused cosine, and routing runs on the pilot against the base tier's
    IVF.  The result adds ``panel_scores``, the top-1 candidate's
    unweighted per-embedder cosines, which the feedback loop records to
    learn the weights.
    """
    del warm_block_n
    sharded = ens.warm_keys.ndim == 4
    if sharded != (warm.keys.ndim == 3):
        raise ValueError("ensemble/warm sharding mismatch: warm keys "
                         f"ndim {warm.keys.ndim}, ensemble warm ndim "
                         f"{ens.warm_keys.ndim}")
    if mesh is not None and not sharded:
        raise ValueError("ensemble_cascade_query(mesh=...) needs the "
                         "stacked (sharded) panels; see "
                         "place_ensemble_sharded")
    qe = _unit(q.float()).transpose(0, 1).contiguous()        # (E, Q, D)
    qt = q_tenants.to(_I32)
    thr = thresholds.float()
    w = weights.float().contiguous()
    if sharded:
        if mesh is None:
            return _ensemble_sharded_oracle(hot, warm, ens, qe, w, qt, thr,
                                            k, n_probe, tail, fused,
                                            quantized)
        return _ensemble_sharded(hot, warm, ens, qe, w, qt, thr, k, n_probe,
                                 tail, fused, quantized, mesh, axis)
    s, vids, wslots, hslots, hot_hit, hit = _ensemble_ops(
        hot, warm, ens, qe, w, qt, thr, k, n_probe, tail, fused, quantized)
    if quantized:
        # the exact fused re-score may reorder the k selected candidates
        s = _rescore_exact_fused(qe, w, ens.warm_keys, s, wslots)
        s, idx = topk_stable(s, k)
        vids = torch.gather(vids, 1, idx)
        wslots = torch.gather(wslots, 1, idx)
        hit = s[:, 0] >= thr
        hot_hit = hit & (wslots[:, 0] < 0)
    cap = ens.warm_keys.shape[1]
    wsafe = wslots[:, 0].clamp(0, cap - 1).long()
    wwin = ens.warm_keys[:, wsafe].transpose(0, 1)            # (Q, E, D)
    ps = _top1_panel_scores(qe, ens.hot_keys, wwin, wslots[:, 0], hslots,
                            vids[:, 0] >= 0)
    return EnsembleResult(scores=s, value_ids=vids, hot_slots=hslots,
                          hot_hit=hot_hit, hit=hit, panel_scores=ps)


# ---------------------------------------------------------------------------
# TTL / staleness (DESIGN.md §14); elementwise, so either warm form
# ---------------------------------------------------------------------------

def mask_expired(hot: HotState, warm: WarmState, now: float, group=None
                 ) -> Tuple[HotState, WarmState, torch.Tensor]:
    """Plan-time staleness mask: views of both tiers with every expired
    row's ``valid`` bit cleared; the stored state is untouched.
    Returns (hot_view, warm_view, n_masked); on a mesh pass the shard
    axis's ``group``, and the warm count covers every shard."""
    now = torch.tensor(now, dtype=torch.float32)
    h_live = hot.expires_at > now.to(hot.expires_at.device)
    w_live = warm.expires_at > now.to(warm.expires_at.device)
    n_warm = (warm.valid & ~w_live).sum()
    if group is not None:
        n_warm = distrib.all_reduce(group, n_warm)
    n = (hot.valid & ~h_live).sum() + n_warm
    return (hot._replace(valid=hot.valid & h_live),
            warm._replace(valid=warm.valid & w_live), n.to(_I32))


def reap_expired(hot: HotState, warm: WarmState, now: float, group=None
                 ) -> Tuple[HotState, WarmState, torch.Tensor, torch.Tensor]:
    """Free every expired row in both tiers.  Returns (hot, warm,
    hot_reaped, warm_reaped) value-id lists (-1 padding) for host GC
    (``group`` as in `evict_tenant`)."""
    now = torch.tensor(now, dtype=torch.float32)
    h_kill = hot.valid & (hot.expires_at <= now.to(hot.expires_at.device))
    w_kill = warm.valid & (warm.expires_at
                           <= now.to(warm.expires_at.device))
    h_ev = torch.where(h_kill, hot.value_ids, -1)
    w_ev = torch.where(w_kill, warm.value_ids, -1)
    return (hot._replace(valid=hot.valid & ~h_kill),
            warm._replace(valid=warm.valid & ~w_kill), h_ev,
            _gathered(w_ev, group))
