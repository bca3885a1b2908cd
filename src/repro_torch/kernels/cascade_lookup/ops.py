"""Dispatch wrappers for the fused cascade lookup, single
(`cascade_lookup`) and over an ensemble of E key panels
(`ensemble_lookup`).

Tensors on the CPU go to the plain torch version (`ref.py`); tensors on
a card go to the hand-written CUDA kernel (`kernel.py`) or raise — there
is no fallback from the card to the plain version.  Both return the
same 6-tuple, so `tiers.cascade_query` and
`tiers.ensemble_cascade_query` are agnostic.  ``quantized``
selects the int8 warm-panel variant in both; callers re-score the
returned ``warm_slots`` exactly from the fp32 panel.

The reference's ``warm_block_n`` (``TieringConfig.warm_block``,
``launch/serve.py --warm-block``: stream the warm panel through TPU VMEM
in blocks) does not change results and has no counterpart in the CUDA
kernel, which stages rows in its own 64-row tiles: it is accepted and
not passed here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import check_tensor
from repro_torch.kernels.cascade_lookup import kernel as _kernel
from repro_torch.kernels.cascade_lookup import ref as _ref


def _check(q, weights, q_tenants, thresholds, hot_keys, hot_valid,
           hot_tenants, hot_value_ids, warm_keys, warm_valid, warm_tenants,
           warm_value_ids, warm_write_seq, centroids, members, cursor,
           indexed_total, warm_keys_q, warm_scales, *, k: int, n_probe: int,
           tail: int, quantized: bool):
    """Refuse, with a ValueError, what the kernel does not take.  ``q``
    is (E, Q, D); the key panels carry a leading E axis and ``weights``
    is (Q, E) when ``weights`` is given, else E == 1 and they have
    none (the single cascade)."""
    dev = q.device
    E, Q, D = q.shape
    pan = (E,) if weights is not None else ()
    Nh = hot_valid.shape[0]
    cap = warm_valid.shape[0]
    K, bucket = members.shape
    n_probe = min(n_probe, K)
    if not 1 <= k <= _kernel.max_k():
        raise ValueError(f"k={k} outside the kernel's 1..{_kernel.max_k()}")
    if not 1 <= E <= _kernel.max_e():
        raise ValueError(f"E={E} outside the kernel's 1..{_kernel.max_e()}")
    if k > Nh or k > n_probe * bucket + tail:
        raise ValueError(f"k={k} exceeds a tier's candidate count")
    if tail < 0:
        raise ValueError(f"tail={tail} must be >= 0")
    i32, f32 = torch.int32, torch.float32
    checks = [
        ("q_tenants", q_tenants, i32, (Q,)),
        ("thresholds", thresholds, f32, (Q,)),
        ("hot_keys", hot_keys, f32, pan + (Nh, D)),
        ("hot_valid", hot_valid, torch.bool, (Nh,)),
        ("hot_tenants", hot_tenants, i32, (Nh,)),
        ("hot_value_ids", hot_value_ids, i32, (Nh,)),
        ("warm_valid", warm_valid, torch.bool, (cap,)),
        ("warm_tenants", warm_tenants, i32, (cap,)),
        ("warm_value_ids", warm_value_ids, i32, (cap,)),
        ("warm_write_seq", warm_write_seq, i32, (cap,)),
        ("centroids", centroids, f32, (K, D)),
        ("members", members, i32, (K, bucket)),
        ("cursor", cursor, i32, ()),
        ("indexed_total", indexed_total, i32, ())]
    if weights is not None:
        checks.append(("weights", weights, f32, (Q, E)))
    if quantized:
        checks += [("warm_keys_q", warm_keys_q, torch.int8, pan + (cap, D)),
                   ("warm_scales", warm_scales, f32, pan + (cap,))]
    else:
        checks.append(("warm_keys", warm_keys, f32, pan + (cap, D)))
    for name, t, dt, shape in checks:
        check_tensor(name, t, dt, shape, dev)
    return n_probe


def _device(q, name: str) -> str:
    dev = q.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, got "
                         f"{q.device}")
    return dev


def cascade_lookup(q, q_tenants, thresholds,
                   hot_keys, hot_valid, hot_tenants, hot_value_ids,
                   warm_keys, warm_valid, warm_tenants, warm_value_ids,
                   warm_write_seq, centroids, members, cursor, indexed_total,
                   warm_keys_q=None, warm_scales=None,
                   k: int = 1, n_probe: int = 8, tail: int = 0, *,
                   quantized: bool = False):
    """q: (Q, D) unit-norm -> (scores, value_ids, warm_slots, hot_slots,
    hot_hit, hit); see `ref.cascade_lookup`."""
    if _device(q, "cascade_lookup") == "cpu":
        return _ref.cascade_lookup(
            q, q_tenants, thresholds, hot_keys, hot_valid, hot_tenants,
            hot_value_ids, warm_keys, warm_valid, warm_tenants,
            warm_value_ids, warm_write_seq, centroids, members, cursor,
            indexed_total, warm_keys_q, warm_scales, k, n_probe, tail,
            quantized=quantized)
    if q.dim() != 2:
        raise ValueError(f"q has shape {tuple(q.shape)}, expected (Q, D)")
    check_tensor("q", q, torch.float32, q.shape, q.device)
    n_probe = _check(q[None], None, q_tenants, thresholds, hot_keys,
                     hot_valid, hot_tenants, hot_value_ids, warm_keys,
                     warm_valid, warm_tenants, warm_value_ids,
                     warm_write_seq, centroids, members, cursor,
                     indexed_total, warm_keys_q, warm_scales, k=k,
                     n_probe=n_probe, tail=tail, quantized=quantized)
    return _kernel.launch(
        q, q_tenants, thresholds, hot_keys, hot_valid, hot_tenants,
        hot_value_ids, None if quantized else warm_keys,
        warm_keys_q if quantized else None,
        warm_scales if quantized else None, warm_valid, warm_tenants,
        warm_value_ids, warm_write_seq, centroids, members, cursor,
        indexed_total, k=k, n_probe=n_probe, tail=tail, quantized=quantized)


def ensemble_lookup(q, weights, q_tenants, thresholds,
                    hot_keys, hot_valid, hot_tenants, hot_value_ids,
                    warm_keys, warm_valid, warm_tenants, warm_value_ids,
                    warm_write_seq, centroids, members, cursor,
                    indexed_total, warm_keys_q=None, warm_scales=None,
                    k: int = 1, n_probe: int = 8, tail: int = 0, *,
                    quantized: bool = False):
    """q: (E, Q, D) stacked unit-norm queries, weights (Q, E), key
    panels (E, rows, D) with shared per-slot metadata and the
    pilot-built IVF -> the 6-tuple of `cascade_lookup` with the weighted
    fused score; see `ref.ensemble_lookup`."""
    if _device(q, "ensemble_lookup") == "cpu":
        return _ref.ensemble_lookup(
            q, weights, q_tenants, thresholds, hot_keys, hot_valid,
            hot_tenants, hot_value_ids, warm_keys, warm_valid, warm_tenants,
            warm_value_ids, warm_write_seq, centroids, members, cursor,
            indexed_total, warm_keys_q, warm_scales, k, n_probe, tail,
            quantized=quantized)
    if q.dim() != 3:
        raise ValueError(f"q has shape {tuple(q.shape)}, expected (E, Q, D)")
    check_tensor("q", q, torch.float32, q.shape, q.device)
    n_probe = _check(q, weights, q_tenants, thresholds, hot_keys, hot_valid,
                     hot_tenants, hot_value_ids, warm_keys, warm_valid,
                     warm_tenants, warm_value_ids, warm_write_seq,
                     centroids, members, cursor, indexed_total, warm_keys_q,
                     warm_scales, k=k, n_probe=n_probe, tail=tail,
                     quantized=quantized)
    return _kernel.launch_ensemble(
        q, weights, q_tenants, thresholds, hot_keys, hot_valid, hot_tenants,
        hot_value_ids, None if quantized else warm_keys,
        warm_keys_q if quantized else None,
        warm_scales if quantized else None, warm_valid, warm_tenants,
        warm_value_ids, warm_write_seq, centroids, members, cursor,
        indexed_total, k=k, n_probe=n_probe, tail=tail, quantized=quantized)
