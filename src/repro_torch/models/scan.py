"""``scan(step, carry, xs)``: the port's counterpart of ``lax.scan`` for
the recurrent mixers' token loops (the mLSTM, the sLSTM and Mamba's
chunk scan).

``step(carry, x_t, *params) -> (carry, y_t)``: ``carry`` a tuple of
tensors, ``x_t`` the tuple of each input's token ``t`` (``xs`` are (B,
S, ...) tensors, iterated along dim 1), ``params`` the tensors every
step reads (weights), ``y_t`` one tensor.  Returns (the carry after the
last token, the ``y_t`` stacked along dim 1).  A step reads no tensor
but these: the dry-run's counted scan sees only what is passed (a weight
the step closed over would take no gradient there).

Each input is taken apart once with ``unbind(1)`` and the outputs are
stacked once, so under autograd the loop's backward is O(S) in bytes:
``unbind``'s backward stacks the token gradients, where indexing
``x[:, t]`` in the loop would give every token a zero gradient of the
whole input (``select_backward``) and sum them, O(S^2).

The dry-run (`launch.localcost.local_mixers`) installs a counted scan
with `counting`: a loop longer than its limit is counted from a few real
token steps instead of run token by token.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Sequence, Tuple

import torch

_COUNTED = None     # the dry-run's counted scan, while `counting` holds


def scan(step: Callable, carry: Tuple[torch.Tensor, ...],
         xs: Sequence[torch.Tensor], params: Sequence[torch.Tensor] = ()
         ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    if _COUNTED is not None:
        out = _COUNTED(step, tuple(carry), tuple(xs), tuple(params))
        if out is not None:
            return out
    ys = []
    for x_t in zip(*(x.unbind(1) for x in xs)):
        carry, y = step(carry, x_t, *params)
        ys.append(y)
    return carry, torch.stack(ys, dim=1)


@contextlib.contextmanager
def counting(counted: Callable):
    """Route `scan` through ``counted(step, carry, xs)`` (None from it:
    run the loop) while the context holds."""
    global _COUNTED
    prev, _COUNTED = _COUNTED, counted
    try:
        yield
    finally:
        _COUNTED = prev
