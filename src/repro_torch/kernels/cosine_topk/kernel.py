"""Launch of the hand-written CUDA cosine top-k kernel.

The source is ``csrc/cosine_topk.cu`` (CUDA C++ for ``sm_90a``, plain C
interface), built at first use by `repro_torch.kernels._build` and
loaded with ``ctypes``; nothing is built or loaded at import.

``COUNTS["cosine_topk"]`` counts launches: `launch` adds one where it
launches the kernel (the partial pass and the merge of its splits), and
nowhere else.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "cosine_topk.cu"
MAX_SMEM = 48 * 1024
BLOCKS_PER_SM = 4          # blocks of the partial pass to aim for per SM
MIN_ROWS_PER_SPLIT = 64

COUNTS = {"cosine_topk": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _declare(lib: ctypes.CDLL) -> None:
    lib.cosine_topk_launch.argtypes = [
        _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]
    lib.cosine_topk_launch.restype = ctypes.c_int
    lib.cosine_topk_smem_bytes.argtypes = [_I, _I]
    lib.cosine_topk_smem_bytes.restype = ctypes.c_size_t
    lib.cosine_topk_max_k.argtypes = []
    lib.cosine_topk_max_k.restype = ctypes.c_int
    lib.cosine_topk_query_tile.argtypes = []
    lib.cosine_topk_query_tile.restype = ctypes.c_int


def build() -> Path:
    """Compile the kernel unless a library for this source exists;
    returns its path."""
    return _build.build(SOURCE)


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _declare)


def max_k() -> int:
    return int(_lib().cosine_topk_max_k())


def splits(Q: int, N: int, n_sm: int, tile: int) -> int:
    """How many blocks share one query tile's key rows: enough for
    ``BLOCKS_PER_SM`` blocks per SM, at least ``MIN_ROWS_PER_SPLIT`` rows
    each."""
    tiles = -(-Q // tile)
    want = -(-BLOCKS_PER_SM * n_sm // tiles)
    return max(1, min(want, -(-N // MIN_ROWS_PER_SPLIT)))


def launch(q, keys, valid, k: int):
    """q: (Q, D), keys: (N, D) float32, valid: (N,) bool — checked,
    contiguous CUDA tensors (see `ops.cosine_topk`), 1 <= k <= N.
    Returns ((Q, k) float32 scores, (Q, k) int32 indices).  Launches on
    the current stream, does not synchronise; raises if a launch is
    refused."""
    lib = _lib()
    Q, D = q.shape
    N = keys.shape[0]
    dev = q.device
    smem = lib.cosine_topk_smem_bytes(D, k)
    if smem > MAX_SMEM:
        raise ValueError(f"cosine_topk needs {smem} B of shared memory "
                         f"(D={D}, k={k}); at most {MAX_SMEM} B supported")
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return out_s, out_i
    S = splits(Q, N, torch.cuda.get_device_properties(dev)
               .multi_processor_count, lib.cosine_topk_query_tile())
    part_s = torch.empty((Q, S, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((Q, S, k), dtype=torch.int32, device=dev)
    vec4 = D % 4 == 0 and keys.data_ptr() % 16 == 0
    err = lib.cosine_topk_launch(
        q.data_ptr(), keys.data_ptr(), valid.data_ptr(), Q, N, D, k,
        int(vec4), S, part_s.data_ptr(), part_i.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cosine_topk kernel launch failed: CUDA error "
                           f"{err}")
    COUNTS["cosine_topk"] += 1
    return out_s, out_i
