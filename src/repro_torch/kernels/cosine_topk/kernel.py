"""Launch of the hand-written CUDA cosine top-k kernels.

The source is ``csrc/cosine_topk.cu`` (CUDA C++ for ``sm_90a``, plain C
interface), built at first use by `repro_torch.kernels._build` and
loaded with ``ctypes``; nothing is built or loaded at import.  Two
kernels, by the keys' type: float32 keys take the register-tiled float32
FMA kernel (`launch`), bf16 keys the bf16 tensor-core kernel
(`launch_bf16`, q float32 or bf16).  The launch geometry (`key_tile`,
`splits`, `mma_splits`) is plain Python that the CPU tests reach; the
tiles and the blocks an SM it is sized from are the source's own,
reported by the library.

``COUNTS["cosine_topk"]`` counts the float32-key kernel's calls and
``COUNTS["cosine_topk_bf16"]`` the bf16-key kernel's: each launching
function adds one where it launches (the partial pass and the merge of
its splits), and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "cosine_topk.cu"
KEY_TILES = (32, 64)       # key rows per tile the float32 kernel is built for
MMA_SPLIT_TILES = 16       # most key tiles one bf16-key block walks

COUNTS = {"cosine_topk": 0, "cosine_topk_bf16": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _declare(lib: ctypes.CDLL) -> None:
    lib.cosine_topk_launch.argtypes = [
        _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]
    lib.cosine_topk_mma_launch.argtypes = [
        _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]
    for fn in (lib.cosine_topk_mma_query_tile, lib.cosine_topk_blocks_per_sm):
        fn.argtypes = [_I]
    for fn in (lib.cosine_topk_max_k, lib.cosine_topk_query_tile,
               lib.cosine_topk_mma_key_tile,
               lib.cosine_topk_mma_blocks_per_sm):
        fn.argtypes = []
    for fn in (lib.cosine_topk_launch, lib.cosine_topk_mma_launch,
               lib.cosine_topk_max_k, lib.cosine_topk_query_tile,
               lib.cosine_topk_mma_query_tile, lib.cosine_topk_blocks_per_sm,
               lib.cosine_topk_mma_key_tile,
               lib.cosine_topk_mma_blocks_per_sm):
        fn.restype = ctypes.c_int


def build() -> Path:
    """Compile the kernel unless a library for this source exists;
    returns its path."""
    return _build.build(SOURCE)


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _declare)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def max_k() -> int:
    return int(_lib().cosine_topk_max_k())


def query_tile() -> int:
    """Query rows per block of the float32-key partial pass."""
    return int(_lib().cosine_topk_query_tile())


def blocks_per_sm(k: int) -> int:
    """float32-key blocks resident an SM at this k (2, 1 for k > 8)."""
    return int(_lib().cosine_topk_blocks_per_sm(k))


def mma_query_tile(k: int) -> int:
    """Query rows per block of the bf16-key kernel (32, or 16 for k > 4)."""
    return int(_lib().cosine_topk_mma_query_tile(k))


def mma_key_tile() -> int:
    """Key rows per tile of the bf16-key kernel (256)."""
    return int(_lib().cosine_topk_mma_key_tile())


def mma_blocks_per_sm() -> int:
    """bf16-key blocks resident an SM (1: the staged queries)."""
    return int(_lib().cosine_topk_mma_blocks_per_sm())


def key_tile(Q: int, N: int, n_sm: int, q_tile: int, per_sm: int) -> int:
    """Key rows per tile: 64 (half the query-tile re-reads) when the
    panel has enough 64-row tiles for ``per_sm`` blocks per SM, else 32
    (twice the blocks: the flat cache's 4096 rows)."""
    want = -(-per_sm * n_sm // -(-Q // q_tile))
    return KEY_TILES[1] if -(-N // KEY_TILES[1]) >= want else KEY_TILES[0]


def splits(Q: int, N: int, n_sm: int, q_tile: int, k_tile: int,
           per_sm: int):
    """(S, rows): how many blocks share one query tile's N key rows, and
    the rows each takes — a whole number of ``k_tile`` key tiles, as few
    as give ``per_sm`` blocks per SM, every split non-empty."""
    q_tiles = -(-Q // q_tile)
    key_tiles = -(-N // k_tile)
    want = max(1, -(-per_sm * n_sm // q_tiles))
    rows = k_tile * -(-key_tiles // min(key_tiles, want))
    return -(-N // rows), rows


def mma_splits(Q: int, N: int, n_sm: int, q_tile: int, k_tile: int,
               per_sm: int):
    """(S, rows) for the bf16-key kernel: each block walks the key tiles
    one wave of ``per_sm`` blocks per SM would give it, at most
    ``MMA_SPLIT_TILES`` — so a large panel is cut into many short splits
    (the last wave's tail small; the 32 query tiles of the cache
    program's splits run together and read each split's keys, 6.3 MB at
    D 768, from L2), every split non-empty."""
    q_tiles = -(-Q // q_tile)
    key_tiles = -(-N // k_tile)
    per = -(-q_tiles * key_tiles // (per_sm * n_sm))
    rows = k_tile * max(1, min(per, MMA_SPLIT_TILES))
    return -(-N // rows), rows


def vector_loads(q, keys) -> bool:
    """Whether the float32 kernel's staging copies may move 16 bytes (4
    values) at a time: D a multiple of 4 and both base pointers 16-byte
    aligned (row strides then are too)."""
    return q.shape[1] % 4 == 0 and q.data_ptr() % 16 == 0 \
        and keys.data_ptr() % 16 == 0


def mma_vector_loads(keys) -> bool:
    """Whether the bf16-key kernel copies keys 16 bytes (8 values) at a
    time: D a multiple of 8 and a 16-byte aligned base."""
    return keys.shape[1] % 8 == 0 and keys.data_ptr() % 16 == 0


def mma_vector_q(q) -> bool:
    """Whether the bf16-key kernel reads q 16 bytes at a time: D a
    multiple of 16 bytes of q's values and a 16-byte aligned base."""
    return (q.shape[1] * q.element_size()) % 16 == 0 \
        and q.data_ptr() % 16 == 0


def _outputs(Q, S, k, dev):
    f32, i32 = torch.float32, torch.int32
    return (torch.empty((Q, k), dtype=f32, device=dev),
            torch.empty((Q, k), dtype=i32, device=dev),
            torch.empty((Q, S, k), dtype=f32, device=dev),
            torch.empty((Q, S, k), dtype=i32, device=dev))


def _check(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"cosine_topk kernel launch failed: CUDA error "
                           f"{err}")


def launch(q, keys, valid, k: int):
    """q: (Q, D), keys: (N, D), both float32, valid: (N,) bool — checked,
    contiguous CUDA tensors (see `ops.cosine_topk`), 1 <= k <= N.
    Returns ((Q, k) float32 scores, (Q, k) int32 indices).  Launches on
    the current stream, does not synchronise; raises if a launch is
    refused."""
    lib = _lib()
    Q, D = q.shape
    N = keys.shape[0]
    dev = q.device
    if Q == 0:
        return _outputs(0, 1, k, dev)[:2]
    n_sm, per_sm = _sm_count(dev.index or 0), blocks_per_sm(k)
    kt = key_tile(Q, N, n_sm, query_tile(), per_sm)
    S, rows = splits(Q, N, n_sm, query_tile(), kt, per_sm)
    out_s, out_i, part_s, part_i = _outputs(Q, S, k, dev)
    _check(lib.cosine_topk_launch(
        q.data_ptr(), keys.data_ptr(), valid.data_ptr(), Q, N, D, k,
        int(vector_loads(q, keys)), kt, S, rows, part_s.data_ptr(),
        part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream))
    COUNTS["cosine_topk"] += 1
    return out_s, out_i


def launch_bf16(q, keys, valid, k: int):
    """`launch` for bf16 keys, q float32 or bf16: the bf16 tensor-core
    kernel (float32 q split into bf16 terms in the kernel)."""
    lib = _lib()
    Q, D = q.shape
    N = keys.shape[0]
    dev = q.device
    if Q == 0:
        return _outputs(0, 1, k, dev)[:2]
    n_sm = _sm_count(dev.index or 0)
    S, rows = mma_splits(Q, N, n_sm, mma_query_tile(k), mma_key_tile(),
                         mma_blocks_per_sm())
    out_s, out_i, part_s, part_i = _outputs(Q, S, k, dev)
    _check(lib.cosine_topk_mma_launch(
        q.data_ptr(), keys.data_ptr(), valid.data_ptr(), Q, N, D, k,
        int(q.dtype == torch.bfloat16),
        int(mma_vector_loads(keys)) | 2 * int(mma_vector_q(q)), S, rows,
        part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(),
        out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream))
    COUNTS["cosine_topk_bf16"] += 1
    return out_s, out_i
