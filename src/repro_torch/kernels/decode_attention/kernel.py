"""Launch of the hand-written CUDA decode-attention kernel (split-L
flash-decoding).

The source is ``csrc/decode_attention.cu`` (CUDA C++ for ``sm_90a``,
plain C interface), built at first use by `repro_torch.kernels._build`
and loaded with ``ctypes``; nothing is built or loaded at import.

The launch geometry is chosen here, in plain Python that the CPU tests
reach: `uses_mma` picks the tensor-core kernel (bf16 with at least
`MMA_MIN_GROUP` query heads per KV head) or the row kernel, `units`
counts the CTAs one split of the cache needs, and `splits` cuts L into
S chunks so that the grid fills the card.

``COUNTS["decode_attention"]`` counts calls: `launch` adds one where it
launches the kernel (one device launch, or two when S > 1: the partial
pass and the merge), and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
HEAD_DIMS = (32, 64, 96, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64                  # cache rows per tile (the kernel's kTile)
BLOCKS_PER_SM = 2          # CTAs per SM the splits aim for
MMA_MIN_GROUP = 4          # bf16 query heads per KV head for the mma kernel
MMA_ROWS = 16              # query heads per mma tile

COUNTS = {"decode_attention": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _declare(lib: ctypes.CDLL) -> None:
    lib.decode_attention_launch.argtypes = [
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I,
        _I, _P, _P, _P, _P]
    lib.decode_attention_launch.restype = ctypes.c_int


def build() -> Path:
    """Compile the kernel unless a library for this source exists;
    returns its path."""
    return _build.build(SOURCE)


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _declare)


def uses_mma(dtype: torch.dtype, G: int) -> bool:
    """The tensor-core kernel takes bf16 groups of at least
    `MMA_MIN_GROUP` query heads; the row kernel takes the rest."""
    return dtype == torch.bfloat16 and G >= MMA_MIN_GROUP


def units(H: int, KV: int, mma: bool) -> int:
    """CTAs per batch row and split: one per query head (row kernel), or
    one per (KV head, 16 query heads of its group) (mma kernel)."""
    return KV * -(-(H // KV) // MMA_ROWS) if mma else H


def splits(B: int, KV: int, L: int, n_sm: int):
    """(S, rows): L cut into S chunks of ``rows`` cache rows (whole
    tiles of `TILE`, every chunk non-empty) for a grid of B * KV units
    (``KV`` as counted by `units`).  S = 1 when B * KV already fills the
    card's ``n_sm`` SMs; else as few splits as give `BLOCKS_PER_SM` CTAs
    per SM, at least one tile each."""
    tiles = -(-L // TILE)
    n = B * KV
    if n >= n_sm:
        return 1, TILE * tiles
    want = -(-BLOCKS_PER_SM * n_sm // n)
    rows = TILE * -(-tiles // min(tiles, want))
    return -(-L // rows), rows


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(q, k, v, kv_valid, scale: float):
    """q: (B, H, hd); k, v: (B, L, KV, hd); kv_valid: (B, L) bool —
    checked, contiguous, 16-byte aligned CUDA tensors of one dtype (see
    `ops.decode_attention`).  Returns (B, H, hd) in q's dtype.  Launches
    on the current stream, does not synchronise; raises if a launch is
    refused."""
    lib = _lib()
    B, H, hd = q.shape
    L, KV = k.shape[1], k.shape[2]
    dev = q.device
    out = torch.empty_like(q)
    if B == 0:
        return out
    mma = uses_mma(q.dtype, H // KV)
    S, rows = splits(B, units(H, KV, mma), L, _sm_count(dev.index or 0))
    part = (None, None, None)
    if S > 1:              # float32 (m, l, acc[hd]) per query head and split
        n = B * H * S
        scratch = torch.empty((n * (hd + 2),), dtype=torch.float32,
                              device=dev)
        p = scratch.data_ptr()
        part = (p, p + 4 * n, p + 8 * n)
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(),
        out.data_ptr(), B, H, KV, L, hd, DTYPES[q.dtype], float(scale),
        int(mma), S, rows, *part,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    COUNTS["decode_attention"] += 1
    return out
