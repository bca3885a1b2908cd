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
Jamba and xLSTM have no position signal at all.

``LM.lm_loss`` is the reference's ``lm_loss``: next-token cross entropy
in float32 over the padded vocab (the padding columns are -1e30) plus
the MoE aux loss, through ``Block.forward_full`` (attention in plain
torch under autograd; the serving kernels have no backward).  With
``cfg.remat`` each period of blocks is recomputed in the backward pass
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of its
scanned period body); the recompute sets ``MoE.dropped`` again, to the
same count.  ``cfg.loss_chunk`` sums the loss over sequence chunks so
the (B, S, vocab) logits never exist whole.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks, layers
from repro_torch.models.actsharding import constrain_batch
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
            x = constrain_batch(x)
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
        # anchor the batch to the data axes, so that the FSDP-sharded
        # table cannot make the whole network batch-replicated (a no-op
        # outside a dry-run's context)
        return constrain_batch(x)

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
            x = constrain_batch(x)
            if a is not None:
                aux = aux + a
        return self._logits(x), aux

    def _run_full(self, x: torch.Tensor, sin: Optional[torch.Tensor],
                  cos: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every block's training forward; returns (x, aux summed in
        layer order).  With ``cfg.remat`` (and autograd recording) each
        period of ``len(cfg.period)`` blocks is checkpointed."""
        P = len(self.cfg.period)

        def period(j: int, x: torch.Tensor, aux: torch.Tensor):
            for blk in self.layers[j * P:(j + 1) * P]:
                x, a = blk.forward_full(x, sin, cos)
                x = constrain_batch(x)
                if a is not None:
                    aux = aux + a
            return x, aux

        aux = torch.zeros((), device=x.device)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for j in range(len(self.layers) // P):
            if remat:
                x, aux = checkpoint(period, j, x, aux, use_reentrant=False)
            else:
                x, aux = period(j, x, aux)
        return x, aux

    def _nll(self, x_pred: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        """Summed NLL of ``tgt`` (B, T) under the logits of the normed
        hidden states ``x_pred`` (B, T, d), in float32."""
        logits = layers.unembed(self.cfg, self.embed.table, self.unembed,
                                x_pred).float()
        gold = logits.gather(-1, tgt[..., None])[..., 0]
        return (torch.logsumexp(logits, dim=-1) - gold).sum()

    def lm_loss(self, tokens, frontend_embeds=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross entropy (+ MoE aux).  tokens: (B, S) int;
        frontend_embeds: (B, S_fe, d) or None (the prediction of token
        t + 1 comes from stream position S_fe + t).  Returns (loss, {"nll",
        "aux"}), 0-d float32 tensors; differentiable in every
        parameter."""
        cfg = self.cfg
        tokens = self._tokens(tokens)
        x = self._input_embeds(tokens, frontend_embeds)
        positions = torch.arange(x.shape[1], device=x.device)
        sin, cos = self._rope(positions)
        x, aux = self._run_full(x, sin, cos)
        x = self.final_norm(x)
        n_fe = 0 if frontend_embeds is None else frontend_embeds.shape[1]
        x_pred = x[:, n_fe:-1]
        tgt = tokens[:, 1:].long()
        B, T = tgt.shape
        C = cfg.loss_chunk
        if C and C < T:
            total = torch.zeros((), device=x.device)
            for lo in range(0, T, C):
                total = total + self._nll(x_pred[:, lo:lo + C],
                                          tgt[:, lo:lo + C])
            nll = total / (B * T)
        else:
            nll = self._nll(x_pred, tgt) / (B * T)
        return nll + aux, {"nll": nll, "aux": aux}

    def init_lm_state(self, batch: int, seq_len: int) -> Dict:
        """Empty decode state: per layer a KV cache sized for
        ``seq_len`` positions (the window, if the config has one) or a
        recurrent mixer's fixed-size state."""
        return {"layers": [blocks.init_layer_state(self.cfg, spec, batch,
                                                   seq_len, self.device)
                           for spec in self.cfg.layer_specs()],
                "cur_len": 0}

    @torch.no_grad()
    def prefill(self, tokens, cache_len: int, frontend_embeds=None,
                state: Optional[Dict] = None) -> Tuple[torch.Tensor, Dict]:
        """The prompt's full forward, building the decode state.
        tokens: (B, S) int; frontend_embeds: (B, S_fe, d) or None;
        ``state``: the empty state to fill, in `init_lm_state`'s layout
        (a new ``init_lm_state(B, cache_len)`` when None; the dry-run
        passes one placed on its mesh).  Returns (last position's logits
        (B, padded vocab), state with ``cur_len`` = S_fe + S)."""
        x = self._input_embeds(tokens, frontend_embeds)
        B, S, _ = x.shape
        if state is None:
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


def lm_state_axes(cfg: ModelConfig) -> Dict:
    """Encoded logical axes of `LM.init_lm_state`'s tree: per layer its
    state's axes, ``cur_len`` a scalar.  The reference stacks each period
    position's states on a leading replicated ``layers`` axis; every
    state leaf has two or more dims, so it resolves the same without
    it."""
    return {"layers": [blocks.layer_state_axes(cfg, spec)
                       for spec in cfg.layer_specs()],
            "cur_len": ""}


def lm_loss(lm: LM, tokens, frontend_embeds=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``lm.lm_loss(tokens, frontend_embeds)``: the reference's
    ``repro.models.lm_loss`` with the model in place of its params and
    config."""
    return lm.lm_loss(tokens, frontend_embeds)
