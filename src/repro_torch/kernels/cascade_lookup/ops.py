"""Dispatch wrapper for the fused cascade lookup.

Tensors on the CPU go to the plain torch version (`ref.py`); tensors on
a card go to the hand-written CUDA kernel (`kernel.py`) or raise — there
is no fallback from the card to the plain version.  Both return the
same 6-tuple, so `tiers.cascade_query` is agnostic.  ``quantized``
selects the int8 warm-panel variant in both; callers re-score the
returned ``warm_slots`` exactly from the fp32 panel.

The reference's ``warm_block_n`` (stream the warm panel through TPU
VMEM in blocks) never changes results and has no counterpart here: the
CUDA kernel gathers warm rows straight from device memory.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import check_tensor
from repro_torch.kernels.cascade_lookup import kernel as _kernel
from repro_torch.kernels.cascade_lookup import ref as _ref


def cascade_lookup(q, q_tenants, thresholds,
                   hot_keys, hot_valid, hot_tenants, hot_value_ids,
                   warm_keys, warm_valid, warm_tenants, warm_value_ids,
                   warm_write_seq, centroids, members, cursor, indexed_total,
                   warm_keys_q=None, warm_scales=None,
                   k: int = 1, n_probe: int = 8, tail: int = 0, *,
                   quantized: bool = False):
    """q: (Q, D) unit-norm -> (scores, value_ids, warm_slots, hot_slots,
    hot_hit, hit); see `ref.cascade_lookup`."""
    dev = q.device
    if dev.type == "cpu":
        return _ref.cascade_lookup(
            q, q_tenants, thresholds, hot_keys, hot_valid, hot_tenants,
            hot_value_ids, warm_keys, warm_valid, warm_tenants,
            warm_value_ids, warm_write_seq, centroids, members, cursor,
            indexed_total, warm_keys_q, warm_scales, k, n_probe, tail,
            quantized=quantized)
    if dev.type != "cuda":
        raise ValueError(f"cascade_lookup runs on cpu or cuda tensors, got "
                         f"{dev}")
    Q, D = q.shape
    Nh = hot_keys.shape[0]
    cap = warm_valid.shape[0]
    K, bucket = members.shape
    n_probe = min(n_probe, K)
    if not 1 <= k <= _kernel.max_k():
        raise ValueError(f"k={k} outside the kernel's 1..{_kernel.max_k()}")
    if k > Nh or k > n_probe * bucket + tail:
        raise ValueError(f"k={k} exceeds a tier's candidate count")
    if tail < 0:
        raise ValueError(f"tail={tail} must be >= 0")
    i32, f32 = torch.int32, torch.float32
    for name, t, dt, shape in (
            ("q", q, f32, (Q, D)), ("q_tenants", q_tenants, i32, (Q,)),
            ("thresholds", thresholds, f32, (Q,)),
            ("hot_keys", hot_keys, f32, (Nh, D)),
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
            ("indexed_total", indexed_total, i32, ())):
        check_tensor(name, t, dt, shape, dev)
    if quantized:
        check_tensor("warm_keys_q", warm_keys_q, torch.int8, (cap, D), dev)
        check_tensor("warm_scales", warm_scales, f32, (cap,), dev)
    else:
        check_tensor("warm_keys", warm_keys, f32, (cap, D), dev)
    return _kernel.launch(
        q, q_tenants, thresholds, hot_keys, hot_valid, hot_tenants,
        hot_value_ids, None if quantized else warm_keys,
        warm_keys_q if quantized else None,
        warm_scales if quantized else None, warm_valid, warm_tenants,
        warm_value_ids, warm_write_seq, centroids, members, cursor,
        indexed_total, k=k, n_probe=n_probe, tail=tail, quantized=quantized)
