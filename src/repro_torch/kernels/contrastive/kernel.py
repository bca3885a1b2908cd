"""Launch of the hand-written CUDA online-contrastive kernels.

The source is ``csrc/contrastive.cu`` (CUDA C++ for ``sm_90a``, plain C
interface), built at first use by `repro_torch.kernels._build` and
loaded with ``ctypes``; nothing is built or loaded at import.

``COUNTS["contrastive_components"]`` counts forward launches (one per
`forward` call, which enqueues the rows pass and the one-block reduce)
and ``COUNTS["contrastive_backward"]`` backward launches; each is added
to where the kernel is launched, and nowhere else.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "contrastive.cu"

COUNTS = {"contrastive_components": 0, "contrastive_backward": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _declare(lib: ctypes.CDLL) -> None:
    lib.contrastive_forward_launch.argtypes = [
        _P, _P, _P, _I, _I, _I, _F, _P, _P, _P, _P, _P]
    lib.contrastive_forward_launch.restype = ctypes.c_int
    lib.contrastive_backward_launch.argtypes = [
        _P, _P, _P, _P, _P, _I, _I, _P, _P, _P]
    lib.contrastive_backward_launch.restype = ctypes.c_int


def build() -> Path:
    """Compile the kernels unless a library for this source exists;
    returns its path."""
    return _build.build(SOURCE)


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _declare)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def forward(e1, e2, labels, margin: float):
    """e1, e2: (B, D) float32, labels: (B,) int32 — checked, contiguous
    CUDA tensors (see `ops`).  Returns (components (4,), loss (),
    rows (B, 4), coef (B,)); ``rows`` and ``coef`` are what `backward`
    needs.  Launches on the current stream, does not synchronise;
    raises if a launch is refused."""
    B, D = e1.shape
    dev = e1.device
    rows = torch.empty((B, 4), dtype=torch.float32, device=dev)
    comps = torch.empty((4,), dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    coef = torch.empty((B,), dtype=torch.float32, device=dev)
    vec4 = D % 4 == 0 and e1.data_ptr() % 16 == 0 \
        and e2.data_ptr() % 16 == 0
    err = _lib().contrastive_forward_launch(
        e1.data_ptr(), e2.data_ptr(), labels.data_ptr(), B, D, int(vec4),
        float(margin), rows.data_ptr(), comps.data_ptr(), loss.data_ptr(),
        coef.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"contrastive forward launch failed: CUDA error "
                           f"{err}")
    COUNTS["contrastive_components"] += 1
    return comps, loss, rows, coef


def backward(e1, e2, rows, coef, upstream):
    """Gradients of the loss with respect to e1 and e2, (B, D) float32
    each, for the upstream gradient ``upstream`` (a 0-d float32 CUDA
    tensor)."""
    B, D = e1.shape
    g1 = torch.empty_like(e1)
    g2 = torch.empty_like(e2)
    err = _lib().contrastive_backward_launch(
        e1.data_ptr(), e2.data_ptr(), rows.data_ptr(), coef.data_ptr(),
        upstream.data_ptr(), B, D, g1.data_ptr(), g2.data_ptr(),
        _stream(e1.device))
    if err != 0:
        raise RuntimeError(f"contrastive backward launch failed: CUDA error "
                           f"{err}")
    COUNTS["contrastive_backward"] += 1
    return g1, g2
