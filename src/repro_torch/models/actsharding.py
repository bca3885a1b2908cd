"""Activation sharding anchors (§Perf H6), the port of
`repro/models/actsharding.py` on ``DTensor``s.

Weight shardings propagate into activations: the FSDP-sharded embedding
table (embed -> data) makes the embedding output — and from there the
whole network — run batch-replicated and embed-sharded.  The standard
fix (MaxText) anchors activations to the batch axes, so the weights are
gathered instead of the batch being replicated.  The reference writes
``with_sharding_constraint(x, P(batch_axes, None, ...))``; the port
redistributes a ``DTensor`` activation to ``Shard(0)`` over the batch
axes and ``Replicate()`` over every other mesh dim.

Model code cannot know the mesh: the launcher installs it with
`activation_ctx` around the program's run.  Outside any context, and
for anything but a ``DTensor``, `constrain_batch` returns its argument
itself, so served and trained results are untouched.
"""
from __future__ import annotations

import contextlib
import math
from contextvars import ContextVar
from typing import Optional, Tuple

_BATCH_AXES: ContextVar[Optional[Tuple]] = ContextVar(
    "repro_torch_batch_axes", default=None)


@contextlib.contextmanager
def activation_ctx(mesh, batch_axes=("pod", "data")):
    names = tuple(mesh.mesh_dim_names)
    axes = tuple(a for a in batch_axes if a in names)
    sizes = tuple(mesh.shape[names.index(a)] for a in axes)
    token = _BATCH_AXES.set((mesh, axes, sizes))
    try:
        yield
    finally:
        _BATCH_AXES.reset(token)


def batch_axes_for(n: int) -> Tuple[str, ...]:
    """The batch axes a leading dim of ``n`` is anchored to in the
    current context: ``pod`` is dropped first while the product does not
    divide ``n``; () when none fits or no context is installed."""
    ctx = _BATCH_AXES.get()
    if ctx is None:
        return ()
    _, axes, sizes = ctx
    while axes and n % math.prod(sizes) != 0:
        axes, sizes = axes[1:], sizes[1:]        # drop 'pod' first
    return axes


def constrain_batch(x):
    """Anchor the leading (batch) dim of a ``DTensor`` activation to the
    data axes; ``x`` itself when no context is installed, the batch
    does not divide, or ``x`` is not a ``DTensor``."""
    ctx = _BATCH_AXES.get()
    if ctx is None:
        return x
    axes = batch_axes_for(x.shape[0])
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not axes or not isinstance(x, DTensor):
        return x
    mesh = ctx[0]
    return x.redistribute(mesh, [Shard(0) if a in axes else Replicate()
                                 for a in mesh.mesh_dim_names])


def wrap_with_activation_constraints(fn, mesh):
    """Launcher-side: run ``fn`` inside the activation context."""
    def wrapped(*args, **kw):
        with activation_ctx(mesh):
            return fn(*args, **kw)
    return wrapped
