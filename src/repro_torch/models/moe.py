"""Mixture-of-Experts FFN with sort-based capacity dispatch — the port
of `repro/models/moe.py`.

Tokens are routed as the reference routes them: the top-k expert ids of
every token are flattened and stably argsorted, each assignment gets its
position within its expert from a searchsorted of the sorted ids, and
the first ``capacity`` assignments per expert are scattered into an
(E, C, d) buffer; the expert SwiGLU runs as three batched matrix
products over that buffer (``torch.bmm``: the reference computes them
outside any Pallas kernel), and the outputs are gathered back and mixed
by the renormalised gates.  FLOPs scale with top_k, not num_experts.

Two differences of the framework, not of the function:

* the reference drops an assignment past capacity by scattering it to
  the out-of-range row ``E * C`` (``mode="drop"``); a torch index past
  the end faults on the card, so the buffer has one extra dump row,
  sliced off before the expert products;
* top-k is a stable descending argsort, so ties go to the lowest expert
  index first, as ``lax.top_k`` does (``torch.topk`` promises no order).

Parameters keep the reference's layouts: ``router`` (d, E), ``w_gate``
and ``w_up`` (E, d, f), ``w_down`` (E, f, d), in ``cfg.param_dtype``,
cast to the activation dtype per call as the reference does.  The aux
loss is the switch-style load balance plus the router z-loss, in
float32.  ``dropped`` holds the last call's count of assignments past
capacity, as a device tensor (reading it syncs).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.param import Initializer


def padded_experts(cfg: ModelConfig) -> int:
    """The expert count rounded up to ``cfg.pad_experts_to``; the dummy
    experts are masked out of the router."""
    e = cfg.moe.num_experts
    if cfg.pad_experts_to:
        m = cfg.pad_experts_to
        return -(-e // m) * m
    return e


def capacity_for(cfg: ModelConfig, n_tokens: int) -> int:
    """Assignments each expert takes for ``n_tokens`` tokens: ``T * k /
    E * capacity_factor``, rounded up to a multiple of 8, at least 8."""
    m = cfg.moe
    c = int(n_tokens * m.top_k / m.num_experts * m.capacity_factor)
    return max(8, -(-c // 8) * 8)


class Routing(NamedTuple):
    """One call's dispatch plan over the T*k flattened assignments."""
    gate: torch.Tensor        # (T, k) float32, renormalised
    expert_ids: torch.Tensor  # (T, k) int64
    sort_idx: torch.Tensor    # (T*k,) assignments in expert order
    keep: torch.Tensor        # (T*k,) bool, in sorted order
    dest: torch.Tensor        # (T*k,) buffer row; E*C for a drop
    aux: torch.Tensor         # () float32 load balance + z-loss


class MoE(nn.Module):
    def __init__(self, ini: Initializer, cfg: ModelConfig):
        super().__init__()
        m = cfg.moe
        d, f = cfg.d_model, m.expert_d_ff
        e = padded_experts(cfg)
        self.cfg = cfg
        self.router = ini.lecun((d, e), fan_in=d)
        self.w_gate = ini.lecun((e, d, f), fan_in=d)
        self.w_up = ini.lecun((e, d, f), fan_in=d)
        self.w_down = ini.lecun((e, f, d), fan_in=f)
        self.dropped = None

    def route(self, xf: torch.Tensor, capacity: int) -> Routing:
        """xf: (T, d).  The router, its aux losses and the dispatch."""
        m = self.cfg.moe
        T = xf.shape[0]
        E, K = self.router.shape[1], m.top_k
        logits = xf.float() @ self.router.float()                  # (T, E)
        if E != m.num_experts:          # mask the padded dummy experts
            col = torch.arange(E, device=xf.device)
            logits = logits.masked_fill(col >= m.num_experts, -1e30)
        probs = torch.softmax(logits, dim=-1)
        expert_ids = torch.argsort(-probs, dim=-1, stable=True)[:, :K]
        gate = probs.gather(1, expert_ids)
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
        # load balance: E * sum_e f_e * p_e (switch transformer eq. 4)
        f_e = F.one_hot(expert_ids[:, 0], E).float().mean(0)
        p_e = probs.mean(0)
        lb = E * (f_e * p_e).sum() * m.load_balance_coef
        z = torch.logsumexp(logits, dim=-1).square().mean() \
            * m.router_z_coef
        flat_e = expert_ids.reshape(-1)
        sort_idx = torch.argsort(flat_e, stable=True)
        sorted_e = flat_e[sort_idx]
        starts = torch.searchsorted(
            sorted_e, torch.arange(E, device=xf.device), side="left")
        pos_in_e = torch.arange(T * K, device=xf.device) - starts[sorted_e]
        keep = pos_in_e < capacity
        dest = torch.where(keep, sorted_e * capacity + pos_in_e,
                           E * capacity)
        return Routing(gate, expert_ids, sort_idx, keep, dest, lb + z)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, S, d) -> (y (B, S, d) in x's dtype, aux () float32)."""
        B, S, d = x.shape
        T, K = B * S, self.cfg.moe.top_k
        E = self.router.shape[1]
        C = capacity_for(self.cfg, T)
        dt = x.dtype
        xf = x.reshape(T, d)
        r = self.route(xf, C)
        token_of = r.sort_idx // K
        # row E*C is the dump row of every dropped assignment
        buf = torch.zeros((E * C + 1, d), dtype=dt, device=x.device)
        buf[r.dest] = xf[token_of]
        buf = buf[:E * C].reshape(E, C, d)
        g = F.silu(torch.bmm(buf, self.w_gate.to(dt)))
        u = torch.bmm(buf, self.w_up.to(dt))
        out = torch.bmm(g * u, self.w_down.to(dt)).reshape(E * C, d)
        gathered = out[torch.where(r.keep, r.dest, 0)] \
            * r.keep[:, None].to(dt)
        contrib = torch.empty((T * K, d), dtype=dt, device=x.device)
        contrib[r.sort_idx] = gathered
        y = (contrib.reshape(T, K, d) * r.gate[..., None].to(dt)).sum(1)
        self.dropped = (~r.keep).sum()
        return y.reshape(B, S, d), r.aux
