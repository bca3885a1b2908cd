"""xLSTM mixers, mLSTM (matrix memory) and sLSTM (scalar memory) — the
port of `repro/models/xlstm.py` (xLSTM-125M's alternating layers).

Both use exponential gating with the max-based log-space stabiliser
``m`` (arXiv:2405.04517).  The mLSTM recurrence, per head, in float32:

    C_t = f'_t C_{t-1} + i'_t v_t k_t^T,   n_t = f'_t n_{t-1} + i'_t k_t
    h_t = (C_t q_t) / max(|n_t . q_t|, 1)

with ``i'``, ``f'`` the gates over ``m_t = max(log f_t + m_{t-1},
log i_t)``; ``q``, ``k`` come from the causal-conv branch (``k`` scaled
by ``hd^-0.5``), ``v`` and the gates from the conv's *input* ``x_in``
(the gates in float32, ``log_sigmoid`` on the forget gate).  The output
is RMS-normalised per head, scaled, gated by ``silu(z)`` and projected
down.  The sLSTM mixes its hidden state back through block-diagonal
per-head recurrent weights ``r_gates`` (4, H, hd, hd); its ``n`` starts
at 1, not 0, and ``h`` divides by ``max(n, 1e-6)``; the block ends in
its own RMS norm and SwiGLU-style FFN.

Both loop over tokens in Python through `models.scan.scan`, as the
reference's ``lax.scan`` does, one step function a token
(`mlstm_step`, `slstm_step`): a chain of small ops a token (host-bound
on the card; hand-written kernels for these loops are later work).
Decode is the full path at S = 1 from the carried state.  States are dicts of batch-first tensors
(mLSTM ``C`` (B, H, hd, hd), ``n`` (B, H, hd), ``m`` (B, H) float32 and
``conv`` (B, K-1, d_in) in ``cfg.dtype``; sLSTM ``c``, ``n``, ``h``,
``m`` (B, d) float32), set in place by ``prefill`` and ``decode``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, XLSTMConfig
from repro_torch.models.mamba import causal_conv
from repro_torch.models.param import Initializer
from repro_torch.models.scan import scan

F32 = torch.float32


def _xcfg(cfg: ModelConfig) -> XLSTMConfig:
    return cfg.xlstm or XLSTMConfig()


def _rms(h: torch.Tensor) -> torch.Tensor:
    """RMS-normalised over the last axis with the reference's 1e-6."""
    return h * torch.rsqrt(h.square().mean(-1, keepdim=True) + 1e-6)


def _commit(state: Dict[str, torch.Tensor],
            new: Dict[str, torch.Tensor]) -> None:
    for name, t in new.items():
        state[name].copy_(t)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_dims(cfg: ModelConfig):
    """(xlstm config, d_in, head width)."""
    x = _xcfg(cfg)
    d_in = x.mlstm_expand * cfg.d_model
    return x, d_in, d_in // cfg.n_heads


def init_mlstm_state(cfg: ModelConfig, batch: int,
                     device) -> Dict[str, torch.Tensor]:
    x, d_in, hd = mlstm_dims(cfg)
    H = cfg.n_heads
    return {"C": torch.zeros((batch, H, hd, hd), dtype=F32, device=device),
            "n": torch.zeros((batch, H, hd), dtype=F32, device=device),
            "m": torch.zeros((batch, H), dtype=F32, device=device),
            "conv": torch.zeros((batch, max(x.d_conv - 1, 1), d_in),
                                dtype=getattr(torch, cfg.dtype),
                                device=device)}


def mlstm_step(carry, inp):
    """One token of the mLSTM recurrence (the reference's
    ``_mlstm_step``).  carry: (C (B, H, hd, hd), n (B, H, hd), m (B, H));
    inp: the token's q, k, v (B, H, hd) and gates i_log, f_log (B, H),
    float32.  Returns ((C, n, m) after it, h (B, H, hd))."""
    C, n, m = carry
    q, k, v, i_log, f_log = inp
    m_new = torch.maximum(f_log + m, i_log)
    i_p = torch.exp(i_log - m_new)
    f_p = torch.exp(f_log + m - m_new)
    C = f_p[..., None, None] * C + i_p[..., None, None] * (
        v[..., :, None] * k[..., None, :])
    n = f_p[..., None] * n + i_p[..., None] * k
    num = torch.einsum("bhij,bhj->bhi", C, q)
    den = torch.einsum("bhj,bhj->bh", n, q).abs().clamp_min(1.0)
    return (C, n, m_new), num / den[..., None]


class MLSTM(nn.Module):
    def __init__(self, ini: Initializer, cfg: ModelConfig):
        super().__init__()
        x, d_in, _ = mlstm_dims(cfg)
        d, H = cfg.d_model, cfg.n_heads
        self.cfg = cfg
        self.w_up = ini.lecun((2 * d_in, d), fan_in=d)
        self.conv_w = ini.lecun((d_in, 1, x.d_conv), fan_in=x.d_conv)
        self.conv_b = ini.zeros((d_in,))
        self.wq = ini.lecun((d_in, d_in), fan_in=d_in)
        self.wk = ini.lecun((d_in, d_in), fan_in=d_in)
        self.wv = ini.lecun((d_in, d_in), fan_in=d_in)
        self.w_if = ini.lecun((2 * H, d_in), fan_in=d_in)
        self.b_if = ini.constant((2 * H,), 1.0)
        self.norm_scale = ini.ones((d_in,))
        self.w_down = ini.lecun((d, d_in), fan_in=d_in)

    def _run(self, x: torch.Tensor, state: Optional[Dict] = None):
        """x: (B, S, d) from ``state`` (None: the empty state).  Returns
        (y (B, S, d), the state after the last token)."""
        cfg = self.cfg
        xc, d_in, hd = mlstm_dims(cfg)
        B, S, _ = x.shape
        H, dt = cfg.n_heads, x.dtype
        if state is None:
            state = init_mlstm_state(cfg, B, x.device)
        x_in, z = F.linear(x, self.w_up.to(dt)).chunk(2, dim=-1)
        x_conv, conv = causal_conv(x_in, self.conv_w, self.conv_b,
                                   state["conv"])
        x_c = F.silu(x_conv)
        q = F.linear(x_c, self.wq.to(dt)).reshape(B, S, H, hd).float()
        k = F.linear(x_c, self.wk.to(dt)).reshape(B, S, H, hd).float() \
            * hd ** -0.5
        v = F.linear(x_in, self.wv.to(dt)).reshape(B, S, H, hd).float()
        gates = F.linear(x_in.float(), self.w_if.float()) \
            + self.b_if.float()
        i_log, f_log = gates.chunk(2, dim=-1)                  # (B, S, H)
        f_log = F.logsigmoid(f_log)
        (C, n, m), h = scan(mlstm_step, (state["C"], state["n"], state["m"]),
                            (q, k, v, i_log, f_log))           # (B,S,H,hd)
        hf = (_rms(h).reshape(B, S, d_in) * self.norm_scale.float())
        y = F.linear(hf.to(dt) * F.silu(z), self.w_down.to(dt))
        return y, {"C": C, "n": n, "m": m, "conv": conv[:, -max(
            xc.d_conv - 1, 1):]}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x)[0]

    def prefill(self, x: torch.Tensor,
                state: Dict[str, torch.Tensor]) -> torch.Tensor:
        """From the empty state; ``state`` set in place to the state
        after the prompt."""
        y, new = self._run(x)
        _commit(state, new)
        return y

    def decode(self, x: torch.Tensor,
               state: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The full path at S = 1 from ``state``, advanced in place."""
        y, new = self._run(x, state)
        _commit(state, new)
        return y


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_dims(cfg: ModelConfig):
    """(xlstm config, head width, FFN hidden width)."""
    x = _xcfg(cfg)
    return x, cfg.d_model // cfg.n_heads, int(cfg.d_model
                                              * x.slstm_ffn_factor)


def init_slstm_state(cfg: ModelConfig, batch: int,
                     device) -> Dict[str, torch.Tensor]:
    """c, h, m zero and n one (no 0/0 on the first step), (B, d)
    float32."""
    out = {k: torch.zeros((batch, cfg.d_model), dtype=F32, device=device)
           for k in ("c", "n", "h", "m")}
    out["n"].fill_(1.0)
    return out


def slstm_step(carry, inp, r):
    """One token of the sLSTM recurrence (the reference's
    ``_slstm_step``).  carry: (c, n, h, m) (B, d); inp: (the token's
    input pre-activations (B, 4, d), gate-major (i, f, z, o), float32,);
    r: the recurrent weights (4, H, hd, hd) float32.  Returns ((c, n, h,
    m) after it, h)."""
    c, n, h, m = carry
    (pre_t,) = inp
    _, H, hd, _ = r.shape
    B, _, d = pre_t.shape
    rec = torch.einsum("ghij,bhj->gbhi", r,
                       h.reshape(B, H, hd)).reshape(4, B, d)
    i_t, f_t, z_t, o_t = pre_t.transpose(0, 1) + rec
    lf = F.logsigmoid(f_t)
    m_new = torch.maximum(lf + m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(lf + m - m_new)
    c = f_p * c + i_p * torch.tanh(z_t)
    n = f_p * n + i_p
    h = torch.sigmoid(o_t) * c / n.clamp_min(1e-6)
    return (c, n, h, m_new), h


class SLSTM(nn.Module):
    def __init__(self, ini: Initializer, cfg: ModelConfig):
        super().__init__()
        _, hd, ffh = slstm_dims(cfg)
        d, H = cfg.d_model, cfg.n_heads
        self.cfg = cfg
        self.w_gates = ini.lecun((4 * d, d), fan_in=d)
        self.b_gates = ini.zeros((4 * d,))
        self.r_gates = ini.lecun((4, H, hd, hd), fan_in=hd)
        self.norm_scale = ini.ones((d,))
        self.ff_gate = ini.lecun((ffh, d), fan_in=d)
        self.ff_up = ini.lecun((ffh, d), fan_in=d)
        self.ff_down = ini.lecun((d, ffh), fan_in=ffh)

    def _run(self, x: torch.Tensor, state: Optional[Dict] = None):
        cfg = self.cfg
        B, S, d = x.shape
        dt = x.dtype
        if state is None:
            state = init_slstm_state(cfg, B, x.device)
        # input pre-activations, gate-major columns (i, f, z, o)
        pre = (F.linear(x, self.w_gates.to(dt))
               + self.b_gates.to(dt)).float().reshape(B, S, 4, d)
        (c, n, h, m), hseq = scan(
            slstm_step, (state["c"], state["n"], state["h"], state["m"]),
            (pre,), (self.r_gates.float(),))
        hn = (_rms(hseq) * self.norm_scale.float()).to(dt)
        y = F.linear(F.silu(F.linear(hn, self.ff_gate.to(dt)))
                     * F.linear(hn, self.ff_up.to(dt)), self.ff_down.to(dt))
        return y, {"c": c, "n": n, "h": h, "m": m}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x)[0]

    def prefill(self, x: torch.Tensor,
                state: Dict[str, torch.Tensor]) -> torch.Tensor:
        y, new = self._run(x)
        _commit(state, new)
        return y

    def decode(self, x: torch.Tensor,
               state: Dict[str, torch.Tensor]) -> torch.Tensor:
        y, new = self._run(x, state)
        _commit(state, new)
        return y
