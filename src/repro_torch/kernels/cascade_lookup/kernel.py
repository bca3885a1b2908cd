"""Launch of the hand-written CUDA cascade-lookup kernel, for one key
panel (`launch`) or an ensemble of E stacked panels
(`launch_ensemble`).

The source is ``csrc/cascade_lookup.cu``: CUDA C++ for Hopper
(``sm_90a``) with a plain C interface, built at first use by
`repro_torch.kernels._build` and loaded with ``ctypes``.  Nothing is
built or loaded at import: the module imports on a machine without
``nvcc`` or a card.

A call is three device launches (probes, scoring, merge).  The scoring
launch's partition of the work is chosen here, in plain Python that the
CPU tests reach: `geometry` counts the CTAs and the partial top-k lists
per query, and `warm_spans` / `hot_spans` say which flat positions each
partial list covers.

``COUNTS["cascade_lookup"]`` and ``COUNTS["cascade_lookup_ensemble"]``
count calls: `launch` and `launch_ensemble` each add one to their own
where they launch the kernels, and nowhere else.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, NamedTuple, Tuple

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "cascade_lookup.cu"
MAX_SMEM = 48 * 1024       # the probe kernel's shared memory (centroids)
ROW_TILE = 64              # rows per scoring CTA (the kernel's kRT)
QUERY_TILE = 16            # queries per scoring CTA (the kernel's kQT)

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
    + [_P, _P, _P, _P]                    # probes, partial lists
    + [_I] * 7                            # geometry
    + [_I, _P])                           # vec, stream


def _declare(lib: ctypes.CDLL) -> None:
    lib.cascade_lookup_launch.argtypes = _LAUNCH_ARGTYPES
    lib.cascade_lookup_launch.restype = ctypes.c_int
    lib.cascade_lookup_probe_smem_bytes.argtypes = [_I]
    lib.cascade_lookup_probe_smem_bytes.restype = ctypes.c_size_t
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


class Geometry(NamedTuple):
    """The scoring launch's partition: CTAs of `ROW_TILE` rows x
    `QUERY_TILE` queries over the hot tier, the ring tail and each of
    ``n_clusters`` buckets (against the queries that probe it), and
    ``n_part`` partial top-k lists per query: the hot chunks first, then
    probe rank r's bucket chunks, then the tail chunks."""
    q_tiles: int
    hot_chunks: int
    bucket_chunks: int
    tail_chunks: int
    n_probe: int
    n_clusters: int

    @property
    def n_part(self) -> int:
        return self.hot_chunks + self.n_probe * self.bucket_chunks \
            + self.tail_chunks

    @property
    def ctas(self) -> int:
        return self.q_tiles * (self.hot_chunks + self.tail_chunks
                               + self.n_clusters * self.bucket_chunks)


def geometry(Q: int, Nh: int, n_clusters: int, n_probe: int, bucket: int,
             tail: int) -> Geometry:
    def tiles(n, t):
        return -(-n // t)
    return Geometry(tiles(Q, QUERY_TILE), tiles(Nh, ROW_TILE),
                    tiles(bucket, ROW_TILE), tiles(tail, ROW_TILE), n_probe,
                    n_clusters)


def hot_spans(g: Geometry, Nh: int) -> List[Tuple[int, int, int]]:
    """(partial list, first hot row, rows) of each hot chunk."""
    return [(c, c * ROW_TILE, min(ROW_TILE, Nh - c * ROW_TILE))
            for c in range(g.hot_chunks)]


def warm_spans(g: Geometry, bucket: int, tail: int
               ) -> List[Tuple[int, int, int]]:
    """(partial list, first flat position, positions) of each warm chunk
    of one query: probe rank r's bucket at positions r * bucket + j, the
    tail at n_probe * bucket + j, as in the plain version."""
    out = []
    for r in range(g.n_probe):
        for c in range(g.bucket_chunks):
            out.append((g.hot_chunks + r * g.bucket_chunks + c,
                        r * bucket + c * ROW_TILE,
                        min(ROW_TILE, bucket - c * ROW_TILE)))
    for c in range(g.tail_chunks):
        out.append((g.hot_chunks + g.n_probe * g.bucket_chunks + c,
                    g.n_probe * bucket + c * ROW_TILE,
                    min(ROW_TILE, tail - c * ROW_TILE)))
    return out


def _run(counter, q, weights, q_tenants, thresholds, hot_keys, hot_valid,
         hot_tenants, hot_value_ids, warm_keys, warm_keys_q, warm_scales,
         warm_valid, warm_tenants, warm_value_ids, warm_write_seq,
         centroids, members, cursor, indexed_total, *, k, n_probe, tail,
         quantized):
    lib = _lib()
    E, Q, D = q.shape
    K, bucket = members.shape
    smem = lib.cascade_lookup_probe_smem_bytes(K)
    if smem > MAX_SMEM:
        raise ValueError(f"cascade probe kernel needs {smem} B of shared "
                         f"memory (K={K} centroids); at most {MAX_SMEM} B "
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

    g = geometry(Q, hot_valid.shape[0], K, n_probe, bucket, tail)
    # int32 scratch: the probes, then the partial lists' scores (as
    # float32 bits), positions and slots
    n_list = Q * g.n_part * k
    scratch = torch.empty((Q * n_probe + 3 * n_list,), dtype=torch.int32,
                          device=dev)
    p = scratch.data_ptr()
    p_s = p + 4 * Q * n_probe
    panels = [q, hot_keys, warm_keys_q if quantized else warm_keys]
    vec = D % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in panels)
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
        ptr(out_hit), p, p_s, p_s + 4 * n_list, p_s + 8 * n_list,
        ROW_TILE, QUERY_TILE, g.q_tiles, g.hot_chunks, g.bucket_chunks,
        g.tail_chunks, g.n_part, int(vec),
        torch.cuda.current_stream(dev).cuda_stream)
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
