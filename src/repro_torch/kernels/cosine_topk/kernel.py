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
BLOCKS_PER_SM = 2          # partial-pass blocks resident per SM (smem)
KEY_TILES = (32, 64)       # key rows per tile the kernel is built for

COUNTS = {"cosine_topk": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _declare(lib: ctypes.CDLL) -> None:
    lib.cosine_topk_launch.argtypes = [
        _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]
    lib.cosine_topk_launch.restype = ctypes.c_int
    for fn in (lib.cosine_topk_max_k, lib.cosine_topk_query_tile):
        fn.argtypes = []
        fn.restype = ctypes.c_int


def build() -> Path:
    """Compile the kernel unless a library for this source exists;
    returns its path."""
    return _build.build(SOURCE)


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _declare)


def max_k() -> int:
    return int(_lib().cosine_topk_max_k())


def query_tile() -> int:
    """Query rows per block of the partial pass."""
    return int(_lib().cosine_topk_query_tile())


def key_tile(Q: int, N: int, n_sm: int, q_tile: int) -> int:
    """Key rows per tile: 64 (half the query-tile re-reads) when the
    panel has enough 64-row tiles for ``BLOCKS_PER_SM`` blocks per SM,
    else 32 (twice the blocks: the flat cache's 4096 rows)."""
    want = -(-BLOCKS_PER_SM * n_sm // -(-Q // q_tile))
    return KEY_TILES[1] if -(-N // KEY_TILES[1]) >= want else KEY_TILES[0]


def splits(Q: int, N: int, n_sm: int, q_tile: int, k_tile: int):
    """(S, rows): how many blocks share one query tile's N key rows, and
    the rows each takes — a whole number of ``k_tile`` key tiles, as few
    as give ``BLOCKS_PER_SM`` blocks per SM, every split non-empty."""
    q_tiles = -(-Q // q_tile)
    key_tiles = -(-N // k_tile)
    want = max(1, -(-BLOCKS_PER_SM * n_sm // q_tiles))
    rows = k_tile * -(-key_tiles // min(key_tiles, want))
    return -(-N // rows), rows


def vector_loads(q, keys) -> bool:
    """Whether the staging copies may move 16 bytes (float32, 4 values)
    or 8 bytes (bf16, 4 values) at a time: D a multiple of 4 and both
    base pointers aligned to that width (row strides then are too)."""
    width = 4 * q.element_size()
    return q.shape[1] % 4 == 0 and q.data_ptr() % width == 0 \
        and keys.data_ptr() % width == 0


def launch(q, keys, valid, k: int):
    """q: (Q, D), keys: (N, D), both float32 or both bfloat16 (widened
    to float32 as they are staged), valid: (N,) bool — checked,
    contiguous CUDA tensors (see `ops.cosine_topk`), 1 <= k <= N.
    Returns ((Q, k) float32 scores, (Q, k) int32 indices).  Launches on
    the current stream, does not synchronise; raises if a launch is
    refused."""
    lib = _lib()
    Q, D = q.shape
    N = keys.shape[0]
    dev = q.device
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return out_s, out_i
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    kt = key_tile(Q, N, n_sm, query_tile())
    S, rows = splits(Q, N, n_sm, query_tile(), kt)
    part_s = torch.empty((Q, S, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((Q, S, k), dtype=torch.int32, device=dev)
    err = lib.cosine_topk_launch(
        q.data_ptr(), keys.data_ptr(), valid.data_ptr(), Q, N, D, k,
        int(q.dtype == torch.bfloat16), int(vector_loads(q, keys)), kt, S,
        rows, part_s.data_ptr(), part_i.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cosine_topk kernel launch failed: CUDA error "
                           f"{err}")
    COUNTS["cosine_topk"] += 1
    return out_s, out_i
