"""Launch of the hand-written CUDA cascade-lookup kernel, for one key
panel (`launch`) or an ensemble of E stacked panels
(`launch_ensemble`).

The source is ``csrc/cascade_lookup.cu``: CUDA C++ for Hopper
(``sm_90a``) with a plain C interface, built at first use by
`repro_torch.kernels._build` and loaded with ``ctypes``.  Nothing is
built or loaded at import: the module imports on a machine without
``nvcc`` or a card.

``COUNTS["cascade_lookup"]`` and ``COUNTS["cascade_lookup_ensemble"]``
count launches: `launch` and `launch_ensemble` each add one to their own
where they launch the kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "cascade_lookup.cu"
MAX_SMEM = 48 * 1024

COUNTS = {"cascade_lookup": 0, "cascade_lookup_ensemble": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LAUNCH_ARGTYPES = (
    [_P, _P, _I]                          # q, weights, E
    + [_P, _P]                            # q_tenants, thresholds
    + [_P, _P, _P, _P, _I]                # hot keys/valid/tenants/vids, Nh
    + [_P, _P, _P, _P, _P, _P, _P, _I]    # warm keys/q8/scales/valid/
    #                                       tenants/vids/write_seq, cap
    + [_P, _P, _I, _I]                    # centroids, members, K, bucket
    + [_P, _P]                            # cursor, indexed_total
    + [_I, _I, _I, _I, _I, _I]            # Q, D, k, n_probe, tail, quantized
    + [_P, _P, _P, _P, _P, _P]            # outputs
    + [_P])                               # stream


def _declare(lib: ctypes.CDLL) -> None:
    lib.cascade_lookup_launch.argtypes = _LAUNCH_ARGTYPES
    lib.cascade_lookup_launch.restype = ctypes.c_int
    lib.cascade_lookup_smem_bytes.argtypes = [_I, _I, _I, _I, _I]
    lib.cascade_lookup_smem_bytes.restype = ctypes.c_size_t
    for fn in (lib.cascade_lookup_max_k, lib.cascade_lookup_max_e):
        fn.argtypes = []
        fn.restype = ctypes.c_int


def build() -> Path:
    """Compile the kernel unless a library for this source exists;
    returns its path."""
    return _build.build(SOURCE)


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _declare)


def max_k() -> int:
    return int(_lib().cascade_lookup_max_k())


def max_e() -> int:
    return int(_lib().cascade_lookup_max_e())


def _run(counter, q, weights, q_tenants, thresholds, hot_keys, hot_valid,
         hot_tenants, hot_value_ids, warm_keys, warm_keys_q, warm_scales,
         warm_valid, warm_tenants, warm_value_ids, warm_write_seq,
         centroids, members, cursor, indexed_total, *, k, n_probe, tail,
         quantized):
    lib = _lib()
    E, Q, D = q.shape
    K, bucket = members.shape
    smem = lib.cascade_lookup_smem_bytes(E, D, K, n_probe, k)
    if smem > MAX_SMEM:
        raise ValueError(f"cascade kernel needs {smem} B of shared memory "
                         f"(E={E}, D={D}, K={K}); at most {MAX_SMEM} B "
                         "supported")
    dev = q.device
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_v = torch.empty((Q, k), dtype=torch.int32, device=dev)
    out_w = torch.empty((Q, k), dtype=torch.int32, device=dev)
    out_h = torch.empty((Q,), dtype=torch.int32, device=dev)
    out_hh = torch.empty((Q,), dtype=torch.bool, device=dev)
    out_hit = torch.empty((Q,), dtype=torch.bool, device=dev)
    if Q == 0:
        return out_s, out_v, out_w, out_h, out_hh, out_hit

    def ptr(t):                           # NULL for what is not passed
        return None if t is None else t.data_ptr()

    err = lib.cascade_lookup_launch(
        ptr(q), ptr(weights), E, ptr(q_tenants), ptr(thresholds),
        ptr(hot_keys), ptr(hot_valid), ptr(hot_tenants), ptr(hot_value_ids),
        hot_valid.shape[0],
        ptr(warm_keys), ptr(warm_keys_q), ptr(warm_scales), ptr(warm_valid),
        ptr(warm_tenants), ptr(warm_value_ids), ptr(warm_write_seq),
        warm_valid.shape[0],
        ptr(centroids), ptr(members), K, bucket,
        ptr(cursor), ptr(indexed_total),
        Q, D, k, n_probe, tail, int(quantized),
        ptr(out_s), ptr(out_v), ptr(out_w), ptr(out_h), ptr(out_hh),
        ptr(out_hit), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{counter} kernel launch failed: CUDA error "
                           f"{err}")
    COUNTS[counter] += 1
    return out_s, out_v, out_w, out_h, out_hh, out_hit


def launch(q, q_tenants, thresholds, hot_keys, hot_valid, hot_tenants,
           hot_value_ids, warm_keys, warm_keys_q, warm_scales, warm_valid,
           warm_tenants, warm_value_ids, warm_write_seq, centroids, members,
           cursor, indexed_total, *, k: int, n_probe: int, tail: int,
           quantized: bool):
    """Launch the single cascade (q (Q, D), one key panel per tier) on
    ``torch.cuda.current_stream()``; every tensor is a checked,
    contiguous CUDA tensor of the kernel's dtype (see
    `ops.cascade_lookup`; the warm panel not scanned may be None).
    Allocates the outputs; does not synchronise.  Raises if the launch
    is refused."""
    return _run("cascade_lookup", q[None], None, q_tenants, thresholds,
                hot_keys, hot_valid, hot_tenants, hot_value_ids, warm_keys,
                warm_keys_q, warm_scales, warm_valid, warm_tenants,
                warm_value_ids, warm_write_seq, centroids, members, cursor,
                indexed_total, k=k, n_probe=n_probe, tail=tail,
                quantized=quantized)


def launch_ensemble(q, weights, q_tenants, thresholds, hot_keys, hot_valid,
                    hot_tenants, hot_value_ids, warm_keys, warm_keys_q,
                    warm_scales, warm_valid, warm_tenants, warm_value_ids,
                    warm_write_seq, centroids, members, cursor,
                    indexed_total, *, k: int, n_probe: int, tail: int,
                    quantized: bool):
    """Launch the E-panel ensemble cascade: q (E, Q, D), weights (Q, E),
    key panels (E, rows, D), int8 scales (E, cap); otherwise as
    `launch`."""
    return _run("cascade_lookup_ensemble", q, weights, q_tenants,
                thresholds, hot_keys, hot_valid, hot_tenants, hot_value_ids,
                warm_keys, warm_keys_q, warm_scales, warm_valid,
                warm_tenants, warm_value_ids, warm_write_seq, centroids,
                members, cursor, indexed_total, k=k, n_probe=n_probe,
                tail=tail, quantized=quantized)
