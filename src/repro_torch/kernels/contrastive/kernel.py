"""Launch of the hand-written CUDA online-contrastive kernels.

The source is ``csrc/contrastive.cu`` (CUDA C++ for ``sm_90a``, plain C
interface), built at first use by `repro_torch.kernels._build` and
loaded with ``ctypes``; nothing is built or loaded at import.

The forward is one cooperative launch whose grid `geometry` chooses, in
plain Python that the CPU tests reach: one CTA of `WARPS` warps for
every `WARPS` pairs, capped at the CTAs the card holds at once (the
kernel's grid barrier needs every CTA resident), and the rows each warp
then owns.  Each call allocates one buffer, which holds the components,
the loss, the per-row scalars the backward reads and the per-CTA
partials.

``COUNTS["contrastive_components"]`` counts forward launches and
``COUNTS["contrastive_backward"]`` backward launches, one per call
each; each is added to where the kernel is launched, and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "contrastive.cu"
WARPS = 16                 # forward warps per CTA (the kernel's kWarps)
HEAD = 8                   # floats before the saved rows: comps, loss, pad

COUNTS = {"contrastive_components": 0, "contrastive_backward": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _declare(lib: ctypes.CDLL) -> None:
    lib.contrastive_forward_ctas_per_sm.argtypes = [
        ctypes.POINTER(ctypes.c_int)]
    lib.contrastive_forward_ctas_per_sm.restype = ctypes.c_int
    lib.contrastive_forward_launch.argtypes = [
        _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _P]
    lib.contrastive_forward_launch.restype = ctypes.c_int
    lib.contrastive_backward_launch.argtypes = [
        _P, _P, _P, _P, _I, _I, _I, _P, _P, _P]
    lib.contrastive_backward_launch.restype = ctypes.c_int


def build() -> Path:
    """Compile the kernels unless a library for this source exists;
    returns its path."""
    return _build.build(SOURCE)


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _declare)


def geometry(B: int, n_sm: int, max_ctas_per_sm: int):
    """(grid, rows_per_warp) of the forward for B pairs on a card of
    ``n_sm`` SMs that holds ``max_ctas_per_sm`` of its CTAs each: one
    CTA per `WARPS` pairs (one row per warp) up to the co-resident
    limit, then more rows per warp.  Warp w of CTA c owns the rows
    ``(k * grid + c) * WARPS + w`` for k < rows_per_warp that are < B.
    The grid does not depend on D: a warp streams a whole row at any
    width."""
    if B < 1 or n_sm < 1 or max_ctas_per_sm < 1:
        raise ValueError(f"no geometry for B={B} on {n_sm} SMs of "
                         f"{max_ctas_per_sm} CTAs")
    grid = min(-(-B // WARPS), n_sm * max_ctas_per_sm)
    return grid, -(-B // (grid * WARPS))


@functools.lru_cache(maxsize=None)
def _device_limits(index: int):
    """(SMs, forward CTAs per SM) of card ``index``, read once."""
    with torch.cuda.device(index):
        ctas = ctypes.c_int(0)
        err = _lib().contrastive_forward_ctas_per_sm(ctypes.byref(ctas))
        n_sm = torch.cuda.get_device_properties(index).multi_processor_count
    if err != 0:
        raise RuntimeError(f"contrastive occupancy query failed: CUDA error "
                           f"{err}")
    return n_sm, ctas.value


def _stream(dev) -> int:
    """The current stream's handle: the raw call, as the current
    ``torch.cuda.Stream`` object costs more host time than the launch."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def forward(e1, e2, labels, margin: float):
    """e1, e2: (B, D) float32, labels: (B,) int32 — checked, contiguous
    CUDA tensors (see `ops`).  Returns (components (4,), loss (),
    saved (B, 4)); ``saved`` is what `backward` reads.  All three are
    views of one buffer.  Launches on the current stream, does not
    synchronise; raises if the launch is refused."""
    B, D = e1.shape
    dev = e1.device
    grid, rows_per_warp = geometry(B, *_device_limits(dev.index or 0))
    parts = 8 * grid if grid > 1 else 0
    buf = torch.empty((HEAD + 4 * B + parts,), dtype=torch.float32,
                      device=dev)
    vec4 = D % 4 == 0 and _aligned(e1, e2)
    err = _lib().contrastive_forward_launch(
        e1.data_ptr(), e2.data_ptr(), labels.data_ptr(), B, D, int(vec4),
        grid, rows_per_warp, float(margin), buf.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"contrastive forward launch failed: CUDA error "
                           f"{err}")
    COUNTS["contrastive_components"] += 1
    return (buf.narrow(0, 0, 4), buf.select(0, 4),
            buf.narrow(0, HEAD, 4 * B).view(B, 4))


def backward(e1, e2, saved, upstream):
    """Gradients of the loss with respect to e1 and e2, (B, D) float32
    each, for the upstream gradient ``upstream`` (a 0-d float32 CUDA
    tensor) and the forward's ``saved`` rows."""
    B, D = e1.shape
    g1 = torch.empty_like(e1)
    g2 = torch.empty_like(e2)
    vec4 = D % 4 == 0 and _aligned(e1, e2, g1, g2)
    err = _lib().contrastive_backward_launch(
        e1.data_ptr(), e2.data_ptr(), saved.data_ptr(), upstream.data_ptr(),
        B, D, int(vec4), g1.data_ptr(), g2.data_ptr(), _stream(e1.device))
    if err != 0:
        raise RuntimeError(f"contrastive backward launch failed: CUDA error "
                           f"{err}")
    COUNTS["contrastive_backward"] += 1
    return g1, g2
