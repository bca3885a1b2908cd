"""Launch of the hand-written CUDA flash-attention kernel.

The source is ``csrc/flash_attention.cu`` (CUDA C++ for ``sm_90a``,
plain C interface), built at first use by `repro_torch.kernels._build`
and loaded with ``ctypes``; nothing is built or loaded at import.

The kernel reads and writes through element strides, so `launch` takes
(B, H, S, hd) *views* of any layout whose last axis is contiguous: the
model's (B, S, H, hd) tensors go in as ``x.transpose(1, 2)``, with no
copy.  bfloat16 runs on the tensor cores in blocks of `warps` warps of
16 query rows each; float32 on the FMA kernel (64 query rows a block).
Each dtype has a bf16-accumulate mode (the config's ``attn_f32=False``),
dense or over ``kv_chunk``-key chunks, in a kernel of its own that walks
the keys twice (see the source); one launch a call in every mode.

``COUNTS["flash_attention"]`` counts launches: `launch` adds one where
it launches the kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (32, 64, 96, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ALIGN = 16                 # bytes: the bf16 kernel's cp.async copies

COUNTS = {"flash_attention": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _declare(lib: ctypes.CDLL) -> None:
    lib.flash_attention_launch.argtypes = [
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
        _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
        _I, _I, ctypes.c_float, _I, _I, _I, _P]
    lib.flash_attention_launch.restype = ctypes.c_int


def build() -> Path:
    """Compile the kernel unless a library for this source exists;
    returns its path."""
    return _build.build(SOURCE)


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _declare)


def warps(Sq: int) -> int:
    """Warps (16 query rows each) per block of the bf16 kernel: 2 when
    the sequence fits 32 rows (the decoder's prefill), else 4."""
    return 2 if Sq <= 32 else 4


def launch(q, k, v, out, *, causal: bool, window: int, scale: float,
           acc_bf16: bool = False, kv_chunk: int = 0):
    """q, out: (B, H, Sq, hd); k, v: (B, KV, Skv, hd) — checked CUDA
    tensors of one dtype, last axis contiguous, any other strides (see
    `ops.flash_attention`).  ``acc_bf16``: the bf16-accumulate mode, dense
    (``kv_chunk`` 0) or over ``kv_chunk``-key chunks.  Writes ``out`` and
    returns it.  Launches on the current stream, does not synchronise;
    raises if the launch is refused."""
    lib = _lib()
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if B == 0 or Sq == 0:
        return out
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KV,
        Sq, Skv, hd, DTYPES[q.dtype], *strides, int(causal), int(window),
        float(scale), warps(Sq), int(acc_bf16), int(kv_chunk),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    COUNTS["flash_attention"] += 1
    return out
