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
``decode_step``) for every decoder config: attention, Mamba, mLSTM and
sLSTM mixers with dense, MoE or no FFN.  The decode state is
``{"layers": [one state dict per layer], "cur_len": positions
consumed}``, updated in place by ``prefill``'s layers and by
``decode_step``.  ``forward_lm`` sums the MoE layers' aux losses;
prefill and decode drop them, as the reference does.

Frontend configs (MusicGen's audio, Pixtral's vision) take
``frontend_embeds`` (B, frontend_len, d), prepended to the token
embeddings in their dtype (`serving/frontend.py` draws the stubs), so
logits and ``cur_len`` cover frontend + token positions.  The audio
family without RoPE adds sinusoidal positions to the input (and one row
at ``cur_len`` a decode step), as the reference's ``_input_embeds``;
Jamba and xLSTM have no position signal at all.  ``lm_loss`` arrives
with the decoder-training slice.
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

    def _sinusoidal(self) -> bool:
        return not self.cfg.use_rope and self.cfg.family == "audio"

    def _rope(self, positions: torch.Tensor):
        """(sin, cos) for the attention layers, None without RoPE."""
        if not self.cfg.use_rope:
            return None, None
        return layers.rope_frequencies(self.cfg, positions)

    def _input_embeds(self, tokens, frontend_embeds) -> torch.Tensor:
        """Token embeddings after the frontend's, plus the audio
        family's sinusoidal positions (the reference's
        ``_input_embeds``)."""
        x = self.embed(self._tokens(tokens))
        if frontend_embeds is not None:
            x = torch.cat([torch.as_tensor(frontend_embeds, device=x.device)
                           .to(x.dtype), x], dim=1)
        if self._sinusoidal():
            x = x + layers.sinusoidal_positions(
                x.shape[1], self.cfg.d_model, device=x.device).to(
                    x.dtype)[None]
        return x

    def forward_lm(self, tokens, frontend_embeds=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens: (B, S) int; frontend_embeds: (B, S_fe, d) or None.
        Returns (logits (B, S_fe + S, padded vocab) in ``cfg.dtype``, aux
        loss () float32: the sum over the MoE layers of their load-balance
        + z-losses, 0 without MoE)."""
        x = self._input_embeds(tokens, frontend_embeds)
        positions = torch.arange(x.shape[1], device=x.device)
        sin, cos = self._rope(positions)
        aux = torch.zeros((), device=x.device)
        for blk in self.layers:
            x, a = blk(x, sin, cos)
            if a is not None:
                aux = aux + a
        return self._logits(x), aux

    def init_lm_state(self, batch: int, seq_len: int) -> Dict:
        """Empty decode state: per layer a KV cache sized for
        ``seq_len`` positions (the window, if the config has one) or a
        recurrent mixer's fixed-size state."""
        return {"layers": [blocks.init_layer_state(self.cfg, spec, batch,
                                                   seq_len, self.device)
                           for spec in self.cfg.layer_specs()],
                "cur_len": 0}

    @torch.no_grad()
    def prefill(self, tokens, cache_len: int, frontend_embeds=None
                ) -> Tuple[torch.Tensor, Dict]:
        """The prompt's full forward, building the decode state.
        tokens: (B, S) int; frontend_embeds: (B, S_fe, d) or None.
        Returns (last position's logits (B, padded vocab), state with
        ``cur_len`` = S_fe + S)."""
        x = self._input_embeds(tokens, frontend_embeds)
        B, S, _ = x.shape
        state = self.init_lm_state(B, cache_len)
        positions = torch.arange(S, device=x.device)
        sin, cos = self._rope(positions)
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
        if self._sinusoidal():       # one row at the current position
            x = x + layers.sinusoidal_positions(
                1, self.cfg.d_model, offset=cur, device=x.device).to(
                    x.dtype)[None]
        sin, cos = self._rope(torch.full((1,), cur, device=x.device))
        for blk, st in zip(self.layers, state["layers"]):
            x, _ = blk.decode(x, cur, sin, cos, st)
        state["cur_len"] = cur + 1
        return self._logits(x)[:, 0], state
