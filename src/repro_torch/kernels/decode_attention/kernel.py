"""Launch of the hand-written CUDA decode-attention kernel.

The source is ``csrc/decode_attention.cu`` (CUDA C++ for ``sm_90a``,
plain C interface), built at first use by `repro_torch.kernels._build`
and loaded with ``ctypes``; nothing is built or loaded at import.

``COUNTS["decode_attention"]`` counts launches: `launch` adds one where
it launches the kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
HEAD_DIMS = (32, 64, 96, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

COUNTS = {"decode_attention": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _declare(lib: ctypes.CDLL) -> None:
    lib.decode_attention_launch.argtypes = [
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]
    lib.decode_attention_launch.restype = ctypes.c_int
    lib.decode_attention_max_group_width.argtypes = []
    lib.decode_attention_max_group_width.restype = ctypes.c_int


def build() -> Path:
    """Compile the kernel unless a library for this source exists;
    returns its path."""
    return _build.build(SOURCE)


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _declare)


def max_group_width() -> int:
    """Largest (H / KV) * hd one block holds."""
    return int(_lib().decode_attention_max_group_width())


def launch(q, k, v, kv_valid, scale: float):
    """q: (B, H, hd); k, v: (B, L, KV, hd); kv_valid: (B, L) bool —
    checked, contiguous CUDA tensors of one dtype (see
    `ops.decode_attention`).  Returns (B, H, hd) in q's dtype.  Launches
    on the current stream, does not synchronise; raises if the launch is
    refused."""
    lib = _lib()
    B, H, hd = q.shape
    L, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if B == 0:
        return out
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(),
        out.data_ptr(), B, H, KV, L, hd, DTYPES[q.dtype], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    COUNTS["decode_attention"] += 1
    return out
