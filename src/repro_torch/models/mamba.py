"""Mamba (selective SSM) mixer: full sequence, prefill and O(1)-state
decode — the port of `repro/models/mamba.py` (Jamba's mixer).

Numerics follow the reference:

* the depthwise causal conv is a cross-correlation over the last
  ``d_conv`` inputs (``F.conv1d(groups=C)``, as the reference's grouped
  ``conv_general_dilated``; the kernel is not flipped), with the carried
  state — the last ``d_conv - 1`` *inputs*, in ``cfg.dtype`` —
  prepended in place of zero padding;
* the SSM inputs run in float32: ``dt = softplus(x_c W_x[:R] W_dt +
  b_dt)``, ``A = -exp(A_log) * [1..N]``, ``A_bar = exp(dt A)``,
  ``Bx = dt x_c B``;
* ``h_t = A_bar_t h_{t-1} + Bx_t``, ``y_t = h_t . C_t + D x_c``, gated
  by ``silu(z)``.

The reference evaluates the recurrence with ``lax.associative_scan``
inside chunks of ``MAMBA_CHUNK`` tokens; torch has no stable associative
scan, so the port runs it sequentially over each chunk through
`models.scan.scan`, one `ssm_step` a token (the reference's own unit
test holds the chunked scan to this recurrence).  The
``(B, chunk, d_in, N)`` float32 intermediates are built one chunk at a
time, so memory stays O(chunk) at Jamba's widths (d_in 16384, N 16:
1 MiB a token and batch row).  The chunk is a memory knob only: the
recurrence visits the real positions, so neither ``MAMBA_CHUNK`` nor
``unroll_inner`` changes a result.  (The reference zero-pads the last
chunk and keeps the state after the padding, which decays it when S >
256 is not a multiple of 256; the port's state is the recurrence's at
position S, as the reference's own decode path gives.)

Parameters in PyTorch's ``(out, in)`` layout (see `param.py`):
``in_proj`` (2 d_in, d), ``conv_w`` (d_in, 1, K), ``conv_b`` (d_in,),
``x_proj`` (R + 2N, d_in), ``dt_w`` (d_in, R), ``dt_b`` (d_in,),
``A_log`` (d_in, N), ``D`` (d_in,), ``out_proj`` (d, d_in).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.models.param import Initializer
from repro_torch.models.scan import scan

MAMBA_CHUNK = 256


def dims(cfg: ModelConfig) -> Tuple[SSMConfig, int, int]:
    """(ssm config, d_in, dt_rank)."""
    s = cfg.ssm or SSMConfig()
    return s, s.expand * cfg.d_model, s.dt_rank or -(-cfg.d_model // 16)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x: (B, S, C); w: (C, 1, K); b: (C,);
    ``state``: (B, K-1, C), the trailing inputs of the previous segment,
    prepended instead of zero padding.  Returns (y (B, S, C) in x's
    dtype, the new state: the last K-1 inputs)."""
    B, S, C = x.shape
    K = w.shape[-1]
    if state is None:
        state = x.new_zeros((B, K - 1, C))
    xp = torch.cat([state.to(x.dtype), x], dim=1)        # (B, S+K-1, C)
    y = F.conv1d(xp.transpose(1, 2), w.to(x.dtype), groups=C)
    new_state = xp[:, S:] if K > 1 else state
    return y.transpose(1, 2) + b.to(x.dtype), new_state


def init_state(cfg: ModelConfig, batch: int,
               device) -> Dict[str, torch.Tensor]:
    """Empty decode state: the SSM state ``h`` (B, d_in, N) float32 and
    the conv's carried inputs ``conv`` (B, K-1, d_in) in ``cfg.dtype``."""
    s, d_in, _ = dims(cfg)
    return {"h": torch.zeros((batch, d_in, s.d_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, max(s.d_conv - 1, 1), d_in),
                                dtype=getattr(torch, cfg.dtype),
                                device=device)}


def chunk_scan(A_bar: torch.Tensor, Bx: torch.Tensor, h0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence over one chunk.  A_bar, Bx: (B, L, d_in, N); h0:
    (B, d_in, N).  Returns (h at every position (B, L, d_in, N), h at the
    last)."""
    (h,), hs = scan(ssm_step, (h0,), (A_bar, Bx))
    return hs, h


def ssm_step(carry, inp):
    """One token of the recurrence: carry (h,), inp (A_bar_t, Bx_t)
    (B, d_in, N); h_t = A_bar_t h + Bx_t is both the new carry and the
    output."""
    (h,), (A_bar, Bx) = carry, inp
    h = torch.addcmul(Bx, A_bar, h)
    return (h,), h


class Mamba(nn.Module):
    def __init__(self, ini: Initializer, cfg: ModelConfig):
        super().__init__()
        s, d_in, R = dims(cfg)
        N, K, d = s.d_state, s.d_conv, cfg.d_model
        self.cfg = cfg
        self.in_proj = ini.lecun((2 * d_in, d), fan_in=d)
        self.conv_w = ini.lecun((d_in, 1, K), fan_in=K)
        self.conv_b = ini.zeros((d_in,))
        self.x_proj = ini.lecun((R + 2 * N, d_in), fan_in=d_in)
        self.dt_w = ini.lecun((d_in, R), fan_in=R)
        self.dt_b = ini.constant((d_in,), 0.5)
        # S4D-real: A = -exp(A_log) * [1..N]; A_log = 0 gives -[1..N]
        self.A_log = ini.constant((d_in, N), 0.0)
        self.D = ini.ones((d_in,))
        self.out_proj = ini.lecun((d, d_in), fan_in=d_in)

    def _in(self, x: torch.Tensor, conv_state=None):
        """(x_c = silu(conv(x_in)), the gate z, the new conv state)."""
        x_in, z = F.linear(x, self.in_proj.to(x.dtype)).chunk(2, dim=-1)
        x_conv, conv = causal_conv(x_in, self.conv_w, self.conv_b,
                                   conv_state)
        return F.silu(x_conv), z, conv

    def _ssm_inputs(self, x_c: torch.Tensor):
        """x_c: (B, L, d_in) -> (A_bar, Bx (B, L, d_in, N), C (B, L, N)),
        float32."""
        _, _, R = dims(self.cfg)
        N = self.A_log.shape[1]
        xc = x_c.float()
        dt_raw, Bm, Cm = F.linear(xc, self.x_proj.float()).split(
            [R, N, N], dim=-1)
        dt = F.softplus(F.linear(dt_raw, self.dt_w.float())
                        + self.dt_b.float())
        A = -torch.exp(self.A_log.float()) * torch.arange(
            1, N + 1, dtype=torch.float32, device=xc.device)
        A_bar = torch.exp(dt[..., None] * A)
        Bx = (dt * xc)[..., None] * Bm[..., None, :]
        return A_bar, Bx, Cm

    def _out(self, y: torch.Tensor, x_c: torch.Tensor,
             z: torch.Tensor) -> torch.Tensor:
        y = y + self.D.float() * x_c.float()
        dt = z.dtype
        return F.linear(y.to(dt) * F.silu(z), self.out_proj.to(dt))

    def _full(self, x: torch.Tensor):
        """x: (B, S, d) -> (y (B, S, d), SSM state at S, conv state)."""
        B, S, _ = x.shape
        x_c, z, conv = self._in(x)
        chunk = min(MAMBA_CHUNK, S)
        h = torch.zeros((B, x_c.shape[-1], self.A_log.shape[1]),
                        dtype=torch.float32, device=x.device)
        ys = []
        for lo in range(0, S, chunk):
            A_bar, Bx, Cm = self._ssm_inputs(x_c[:, lo:lo + chunk])
            h_all, h = chunk_scan(A_bar, Bx, h)
            ys.append(torch.einsum("bldn,bln->bld", h_all, Cm))
        y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
        return self._out(y, x_c, z), h, conv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._full(x)[0]

    def prefill(self, x: torch.Tensor,
                state: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The prompt's full sequence; ``state`` is set in place to the
        state after it."""
        y, h, conv = self._full(x)
        state["h"].copy_(h)
        state["conv"].copy_(conv)
        return y

    def decode(self, x: torch.Tensor,
               state: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One token.  x: (B, 1, d); ``state`` advanced in place."""
        x_c, z, conv = self._in(x, state["conv"])
        A_bar, Bx, Cm = self._ssm_inputs(x_c)
        h = torch.addcmul(Bx[:, 0], A_bar[:, 0], state["h"])
        y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])[:, None]
        state["h"].copy_(h)
        state["conv"].copy_(conv)
        return self._out(y, x_c, z)
