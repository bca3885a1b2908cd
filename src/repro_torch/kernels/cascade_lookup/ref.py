"""Plain torch version of the fused cascade lookup.

The port of the reference's oracle (`repro/kernels/cascade_lookup/
ref.py`): the tiered cache's four-op path (hot exact top-k, warm
centroid probe, IVF bucket gather + unindexed-tail scan, best-of-tiers
merge) over plain tensors.  The CPU tests run it, and ``chip_smoke.py``
holds the CUDA kernel against it on the card.  Candidate order matches
``jax.lax.top_k`` (lowest index first among ties) everywhere, via
``torch.sort(descending=True, stable=True)``; ``torch.topk`` promises no
order among ties.

Queries are unit-norm float32.  ``quantized=True`` scores the warm panel
from its int8 per-row quantization (``warm_keys_q`` + ``warm_scales``)
with fp32 accumulation; the caller re-scores the selected rows exactly
from the fp32 panel through the returned ``warm_slots``.

``ensemble_lookup`` is the same lookup over E stacked key panels (one
per embedder) with a weighted fused score and routing on panel 0: the
plain version of the ensemble kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core.topk import topk_stable

NEG = -1e30


def _hot_topk(scores, q_tenants, hot_valid, hot_tenants, hot_value_ids,
              k: int):
    """Tenant-masked exact top-k over the hot tier's (Q, Nh) scores."""
    ok = hot_valid[None, :] & (hot_tenants[None, :] == q_tenants[:, None])
    hs, hslots = topk_stable(torch.where(ok, scores, NEG), k)
    hvids = torch.where(hs > NEG / 2, hot_value_ids[hslots], -1)
    return hs, hslots, hvids


def _warm_candidates(q0, q_tenants, warm_valid, warm_tenants,
                     warm_write_seq, centroids, members, cursor,
                     indexed_total, n_probe: int, tail: int):
    """IVF probe (routed on ``q0``) + unindexed-tail candidate panel:
    (safe (Q, C) row ids, ok (Q, C) mask)."""
    i32 = torch.int32
    Q = q0.shape[0]
    dev = q0.device
    cap = warm_valid.shape[0]
    n_clusters, bucket = members.shape
    n_probe = min(n_probe, n_clusters)
    _, probes = topk_stable(q0 @ centroids.T, n_probe)             # (Q, K)
    cand = members[probes].reshape(Q, n_probe * bucket)
    is_tail = torch.zeros(cand.shape, dtype=torch.bool, device=dev)
    if tail:
        # torch's tensor `%` is a floor-mod, like the reference's
        offs = torch.arange(tail, dtype=i32, device=dev)
        tail_idx = (cursor - 1 - offs) % cap
        unindexed = warm_write_seq[tail_idx] > indexed_total
        tail_cand = torch.where(unindexed, tail_idx, -1).to(i32)
        cand = torch.cat([cand, tail_cand[None, :].expand(Q, tail)], 1)
        is_tail = torch.cat(
            [is_tail, torch.ones((Q, tail), dtype=torch.bool, device=dev)],
            1)
    safe = cand.clamp(0, cap - 1).long()
    ok = (cand >= 0) & warm_valid[safe] \
        & (warm_tenants[safe] == q_tenants[:, None]) \
        & (is_tail | (warm_write_seq[safe] <= indexed_total))
    return safe, ok


def _merge(hs, hslots, hvids, wscores, safe, warm_value_ids, thresholds,
           k: int):
    """Warm top-k over the masked candidate scores, then the
    best-of-tiers merge (hot side first, so ties resolve hot)."""
    i32 = torch.int32
    Q = hs.shape[0]
    ws, wi = topk_stable(wscores, k)
    wslots = torch.gather(safe, 1, wi)
    wvids = torch.where(ws > NEG / 2, warm_value_ids[wslots], -1)
    wslots = torch.where(ws > NEG / 2, wslots, -1)
    all_s = torch.cat([hs, ws], 1)                                 # (Q, 2k)
    all_v = torch.cat([hvids, wvids], 1).to(i32)
    all_w = torch.cat([torch.full((Q, k), -1, dtype=i32, device=hs.device),
                       wslots.to(i32)], 1)
    s, i = topk_stable(all_s, k)
    vids = torch.gather(all_v, 1, i)
    out_wslots = torch.gather(all_w, 1, i)
    hit = s[:, 0] >= thresholds
    hot_hit = hit & (i[:, 0] < k)
    return s, vids, out_wslots, hslots[:, 0].to(i32), hot_hit, hit


def cascade_lookup(q, q_tenants, thresholds,
                   hot_keys, hot_valid, hot_tenants, hot_value_ids,
                   warm_keys, warm_valid, warm_tenants, warm_value_ids,
                   warm_write_seq, centroids, members, cursor, indexed_total,
                   warm_keys_q=None, warm_scales=None,
                   k: int = 1, n_probe: int = 8, tail: int = 0,
                   quantized: bool = False):
    """q: (Q, D) unit-norm; q_tenants/thresholds: (Q,); ``cursor`` and
    ``indexed_total`` are 0-d int32 tensors (or ints).

    Returns (scores (Q, k) f32, value_ids (Q, k) i32, warm_slots (Q, k)
    i32, hot_slots (Q,) i32, hot_hit (Q,) bool, hit (Q,) bool) —
    ``warm_slots`` is -1 for candidates answered by the hot tier (or
    padding).
    """
    q = q.float()
    q_tenants = q_tenants.to(torch.int32)
    hs, hslots, hvids = _hot_topk(q @ hot_keys.T, q_tenants, hot_valid,
                                  hot_tenants, hot_value_ids, k)
    safe, ok = _warm_candidates(q, q_tenants, warm_valid, warm_tenants,
                                warm_write_seq, centroids, members, cursor,
                                indexed_total, n_probe, tail)
    if quantized:
        panel = warm_keys_q[safe].float()
        wscores = torch.einsum("qd,qnd->qn", q, panel) * warm_scales[safe]
    else:
        wscores = torch.einsum("qd,qnd->qn", q, warm_keys[safe])
    return _merge(hs, hslots, hvids, torch.where(ok, wscores, NEG), safe,
                  warm_value_ids, thresholds, k)


def ensemble_lookup(q, weights, q_tenants, thresholds,
                    hot_keys, hot_valid, hot_tenants, hot_value_ids,
                    warm_keys, warm_valid, warm_tenants, warm_value_ids,
                    warm_write_seq, centroids, members, cursor,
                    indexed_total, warm_keys_q=None, warm_scales=None,
                    k: int = 1, n_probe: int = 8, tail: int = 0,
                    quantized: bool = False):
    """The E-panel cascade (DESIGN.md §13), the port of the reference's
    ``ref.ensemble_lookup``.

    q: (E, Q, D) unit-norm, one query row per embedder; weights: (Q, E)
    per-query mixture weights; hot_keys: (E, Nh, D); warm_keys: (E, cap,
    D) (``warm_keys_q``/``warm_scales``: (E, cap, D) int8 / (E, cap)
    when ``quantized``).  Per-slot metadata and the IVF (built from the
    pilot panel 0) are shared by all panels.  A candidate's fused score
    is ``sum_e weights[q, e] * cos(q_e, key_e[row])``: the per-panel
    scores are stacked and contracted with the weights in one einsum,
    and the masks apply after the weighted sum.  Routing runs on the
    pilot query alone.  Returns the 6-tuple of `cascade_lookup` with
    fused scores.
    """
    E = q.shape[0]
    q = q.float()
    weights = weights.float()
    q_tenants = q_tenants.to(torch.int32)
    hot_pans = [q[e] @ hot_keys[e].T for e in range(E)]            # E×(Q, Nh)
    hs_all = torch.einsum("qne,qe->qn", torch.stack(hot_pans, -1), weights)
    hs, hslots, hvids = _hot_topk(hs_all, q_tenants, hot_valid,
                                  hot_tenants, hot_value_ids, k)
    safe, ok = _warm_candidates(q[0], q_tenants, warm_valid, warm_tenants,
                                warm_write_seq, centroids, members, cursor,
                                indexed_total, n_probe, tail)

    def panel(e):
        if quantized:
            return torch.einsum("qd,qnd->qn", q[e],
                                warm_keys_q[e][safe].float()) \
                * warm_scales[e][safe]
        return torch.einsum("qd,qnd->qn", q[e], warm_keys[e][safe])

    wscores = torch.einsum("qne,qe->qn",
                           torch.stack([panel(e) for e in range(E)], -1),
                           weights)
    return _merge(hs, hslots, hvids, torch.where(ok, wscores, NEG), safe,
                  warm_value_ids, thresholds, k)
