"""Launch of the hand-written CUDA flash-attention kernel.

The source is ``csrc/flash_attention.cu`` (CUDA C++ for ``sm_90a``,
plain C interface), built at first use by `repro_torch.kernels._build`
and loaded with ``ctypes``; nothing is built or loaded at import.

The kernel reads and writes through element strides, so `launch` takes
(B, H, S, hd) *views* of any layout whose last axis is contiguous: the
model's (B, S, H, hd) tensors go in as ``x.transpose(1, 2)``, with no
copy.  Both dtypes run on the tensor cores in blocks of `warps` warps of
16 query rows each: bfloat16 on bf16 ``mma.sync``, float32 in 3xTF32
(three TF32 products a product, float32-accurate; see the source).
float32 rows are read 16 bytes at a time where q's, k's and v's
pointers and strides allow it and 4 bytes where not (`aligned16`, from
the tensors).  Each dtype has a bf16-accumulate mode (the config's
``attn_f32=False``), dense or over ``kv_chunk``-key chunks, in a kernel
of its own (see the source) that keeps a short dense reach's values in
shared memory between its two phases (one walk), with the route, the
warps and the buffer chosen by `acc_bf16_route` from the shape and the
dtype.  One launch a call in every mode.

``COUNTS["flash_attention"]`` counts launches: `launch` adds one where
it launches the kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (32, 64, 96, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ALIGN = 16                 # bytes: the kernels' wide cp.async copies
TILE = 64                  # key rows per K / V tile of the bf16-accumulate
                           # kernels
SMEM_LIMIT = 232_448       # shared memory bytes a block may use (H100)
ONE_WALK_TILES = 3         # the longest chunk walked once (in tiles)

COUNTS = {"flash_attention": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _declare(lib: ctypes.CDLL) -> None:
    lib.flash_attention_launch.argtypes = [
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
        _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
        _I, _I, ctypes.c_float, _I, _I, _I, _I, _I, _P]
    lib.flash_attention_launch.restype = ctypes.c_int


def build() -> Path:
    """Compile the kernel unless a library for this source exists;
    returns its path."""
    return _build.build(SOURCE)


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _declare)


def warps(Sq: int) -> int:
    """Warps (16 query rows each) per block: 2 when the sequence fits 32
    rows (the decoder's prefill), else 4."""
    return 2 if Sq <= 32 else 4


def aligned16(*ts) -> bool:
    """Whether every tensor's base pointer and (b, h, s) strides (where
    the axis has more than one row) are multiples of `ALIGN` bytes, so
    that the float32 kernels may copy their rows 16 bytes at a time."""
    return all(
        t.data_ptr() % ALIGN == 0
        and all(st * t.element_size() % ALIGN == 0
                for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)
        for t in ts)


class Route(NamedTuple):
    """How the bf16-accumulate mode runs one shape: ``warps``
    per block, the block's shared memory in bytes (float32: the most it
    takes, see `f32_acc_bf16_smem`), and ``cap``, the tiles
    a warp keeps: > 0 for one walk (dense only: every tile a block walks
    keeps its values in shared memory from phase 0 to phase 1, so K and V
    are each copied once and q k^T runs once), 0 for two walks (phase 1
    copies K again beside V and runs q k^T again)."""
    warps: int
    smem: int
    cap: int

    @property
    def route(self) -> str:
        return "one walk" if self.cap else "two walks"


def acc_bf16_smem(hd: int, warps: int, chunked: bool, cap: int) -> int:
    """Bytes of shared memory the bf16 bf16-accumulate kernel takes (its
    layout, as ``acc_bf16_smem`` in the source): two ring stages of
    (hd + 8)-element bf16 rows (a stage holds one tile, or two for two
    walks), then, dense, 32 floats and a float2 a lane for each of ``cap``
    kept tiles, chunked (two walks only) the bf16 accumulator (hd / 4
    bytes a lane), or the q tile where that is larger (it lies over
    them)."""
    lanes = 32 * warps
    kept = lanes * (hd // 8) * 8 if chunked else lanes * cap * 136
    q = 2 * (hd + 8) * 16 * warps
    return 2 * (hd + 8) * 2 * (1 if cap else 2) * TILE + max(kept, q)


def tiles_per_chunk(Sq: int, Skv: int, rows: int, causal: bool, window: int,
                    kv_chunk: int) -> int:
    """The most `TILE`-key tiles any block of ``rows`` query rows walks in
    one chunk (dense: its whole reach), as the kernel counts them: from the
    tile (counted from the chunk's start) holding its first key in reach to
    the chunk's last key in reach."""
    C = kv_chunk or Skv
    full = -(-C // TILE)
    most = 0
    for q0 in range(0, Sq, rows):
        q_last = min(Sq, q0 + rows) - 1
        k_lo, k_hi = 0, Skv
        if causal:
            k_hi = min(k_hi, q_last + 1)
        if window > 0:
            k_lo = max(0, q0 - window + 1)
            if not causal:
                k_hi = min(k_hi, q_last + window)
        for c in range(k_lo // C, -(-k_hi // C)):
            first = c * C + (max(c * C, k_lo) - c * C) // TILE * TILE
            end = min(c * C + C, Skv, k_hi)
            most = max(most, -(-(end - first) // TILE))
            if most == full:
                return most
    return most


def f32_acc_bf16_smem(hd: int, warps: int, cap: int) -> int:
    """The most shared memory the float32 bf16-accumulate kernel takes
    (its layout, as ``f32_acc_bf16_smem`` in the source): the q tile in
    float32, two ring slots of one tile of (hd + 4)-float rows, and the
    kept tiles as the bf16 kernel's (its chunked accumulator lives in
    registers).  The source halves the slots for a dense launch over at
    most half a tile of keys (``f32_slot_rows`` there)."""
    return (4 * (16 * warps * hd + 2 * TILE * (hd + 4))
            + 32 * warps * cap * 136)


@functools.lru_cache(maxsize=256)
def acc_bf16_route(Sq: int, Skv: int, hd: int, causal: bool, window: int,
                   kv_chunk: int, f32: bool = False) -> Route:
    """The bf16-accumulate launch for one shape (``f32``: float32 inputs),
    chosen from the shape alone (never from a failed launch), at `warps`
    (Sq) warps: one walk when the mode is dense and no block walks more
    than ``ONE_WALK_TILES`` tiles, else two walks.  On the H100 the bf16
    kernel's one walk won over 1-3 tiles and lost past them (PERF.md):
    its buffer (16 rows x 64 keys x 4 bytes a tile a warp) leaves room for
    fewer blocks on an SM than the second q k^T costs; the reference's
    1024-key chunks always span more."""
    w = warps(Sq)
    need = tiles_per_chunk(Sq, Skv, 16 * w, causal, window, kv_chunk)
    cap = need if kv_chunk == 0 and need <= ONE_WALK_TILES else 0
    smem = (f32_acc_bf16_smem(hd, w, cap) if f32
            else acc_bf16_smem(hd, w, kv_chunk > 0, cap))
    return Route(w, smem, cap)


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
    w, cap = warps(Sq), 0
    if acc_bf16:
        r = acc_bf16_route(Sq, Skv, hd, bool(causal), int(window),
                           int(kv_chunk), q.dtype == torch.float32)
        w, cap = r.warps, r.cap
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KV,
        Sq, Skv, hd, DTYPES[q.dtype], *strides, int(causal), int(window),
        float(scale), w, int(acc_bf16), int(kv_chunk), cap,
        int(aligned16(q, k, v)),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    COUNTS["flash_attention"] += 1
    return out
