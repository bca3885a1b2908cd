"""Top-level models: the encoder embedder (the paper's ModernBERT /
LangCache-Embed arch) and the dense decoder LM that answers cache
misses.

``Encoder.encode(tokens, mask)`` mirrors the reference's
`repro/models/model.py` ``encode``: token embedding in ``cfg.dtype``,
the layers in order, final norm, float32 masked mean-pool, L2
normalisation.  As in the reference, the token mask is used **only**
for the mean-pool: every layer attends to every position, pad tokens
included.  Matching it keeps the port's embeddings equal to the
reference's; "fixing" it would change every cache key.

``LM`` mirrors the reference's decoder functions (`repro/models/
model.py` ``forward_lm``, ``init_lm_state``, ``prefill``,
``decode_step``) for configs whose layers are all ``LayerSpec(ATTN,
DENSE)`` or ``LayerSpec(ATTN, MOE)``: the decode state is ``{"layers":
[one KV cache per layer], "cur_len": tokens consumed}``, updated in
place by ``decode_step``.  ``forward_lm`` sums the MoE layers' aux
losses; prefill and decode drop them, as the reference does.  Frontend
configs (audio, vision) and the recurrent mixers arrive with later
slices; ``lm_loss`` with the decoder-training slice.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks, layers
from repro_torch.models.param import make_initializer


class Encoder(nn.Module):
    """Encoder-only backbone; one ``Block`` per layer in period order.

    Parameters are drawn from ``seed`` on ``device`` (default the card;
    raises when CUDA is absent) with the reference's distributions, in
    ``cfg.param_dtype``; activations run in ``cfg.dtype``.
    """

    def __init__(self, cfg: ModelConfig, *, seed: int = 0,
                 device="cuda"):
        super().__init__()
        if not cfg.is_encoder:
            raise ValueError(f"{cfg.name} is not an encoder config")
        dev = resolve_device(device)
        ini = make_initializer(cfg, seed, dev)
        self.cfg = cfg
        self.embed = layers.TokenEmbedding(ini, cfg)
        self.layers = nn.ModuleList(
            blocks.Block(ini, cfg, spec) for spec in cfg.layer_specs())
        self.final_norm = layers.Norm(ini, cfg)

    def encode(self, tokens: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens: (B, S) int; mask: (B, S) bool validity (None -> all
        valid).  Returns (B, d_model) float32 unit-norm cache keys."""
        x = self.embed(tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        sin, cos = layers.rope_frequencies(self.cfg, positions)
        for blk in self.layers:
            x, _ = blk(x, sin, cos)
        x = self.final_norm(x).float()
        if mask is None:
            emb = x.mean(dim=1)
        else:
            m = mask.float()[..., None]
            emb = (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
        return emb / torch.linalg.vector_norm(
            emb, dim=-1, keepdim=True).clamp_min(1e-9)


class LM(nn.Module):
    """Decoder-only LM; one ``Block`` per layer in period order.

    Parameters are drawn from ``seed`` on ``device`` (default the card;
    raises when CUDA is absent) with the reference's distributions and in
    its order (embedding table, untied unembedding, layers, final norm),
    in ``cfg.param_dtype``; activations run in ``cfg.dtype``.
    """

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device="cuda"):
        super().__init__()
        if cfg.is_encoder:
            raise ValueError(f"{cfg.name} is encoder-only; no decode path")
        if cfg.frontend:
            raise NotImplementedError(
                f"{cfg.name} has a {cfg.frontend} frontend, which arrives "
                "with the frontend slice of the port (ROADMAP.md queue A)")
        dev = resolve_device(device)
        ini = make_initializer(cfg, seed, dev)
        self.cfg = cfg
        self.embed = layers.TokenEmbedding(ini, cfg)
        self.unembed = None if cfg.tie_embeddings else ini.normal(
            (layers.padded_vocab(cfg), cfg.d_model))
        self.layers = nn.ModuleList(
            blocks.Block(ini, cfg, spec) for spec in cfg.layer_specs())
        self.final_norm = layers.Norm(ini, cfg)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return layers.unembed(self.cfg, self.embed.table, self.unembed,
                              self.final_norm(x))

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device)

    def forward_lm(self, tokens) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens: (B, S) int.  Returns (logits (B, S, padded vocab) in
        ``cfg.dtype``, aux loss () float32: the sum over the MoE layers
        of their load-balance + z-losses, 0 without MoE)."""
        x = self.embed(self._tokens(tokens))
        positions = torch.arange(x.shape[1], device=x.device)
        sin, cos = layers.rope_frequencies(self.cfg, positions)
        aux = torch.zeros((), device=x.device)
        for blk in self.layers:
            x, a = blk(x, sin, cos)
            if a is not None:
                aux = aux + a
        return self._logits(x), aux

    def init_lm_state(self, batch: int, seq_len: int) -> Dict:
        """Empty decode state: a KV cache per layer sized for
        ``seq_len`` tokens (the window, if the config has one)."""
        return {"layers": [blocks.init_layer_state(self.cfg, spec, batch,
                                                   seq_len, self.device)
                           for spec in self.cfg.layer_specs()],
                "cur_len": 0}

    @torch.no_grad()
    def prefill(self, tokens, cache_len: int) -> Tuple[torch.Tensor, Dict]:
        """The prompt's full forward, building the decode state.
        tokens: (B, S) int.  Returns (last token's logits (B, padded
        vocab), state)."""
        tokens = self._tokens(tokens)
        B, S = tokens.shape
        state = self.init_lm_state(B, cache_len)
        x = self.embed(tokens)
        positions = torch.arange(S, device=x.device)
        sin, cos = layers.rope_frequencies(self.cfg, positions)
        for blk, st in zip(self.layers, state["layers"]):
            x, _ = blk.prefill(x, positions, sin, cos, st)
        state["cur_len"] = S
        return self._logits(x[:, -1:])[:, 0], state

    @torch.no_grad()
    def decode_step(self, state: Dict, tokens) -> Tuple[torch.Tensor, Dict]:
        """One decode step.  tokens: (B, 1) int.  Returns (logits (B,
        padded vocab), state) — the same state, advanced in place."""
        x = self.embed(self._tokens(tokens))
        cur = state["cur_len"]
        pos = torch.full((1,), cur, device=x.device)
        sin, cos = layers.rope_frequencies(self.cfg, pos)
        for blk, st in zip(self.layers, state["layers"]):
            x, _ = blk.decode(x, cur, sin, cos, st)
        state["cur_len"] = cur + 1
        return self._logits(x)[:, 0], state
