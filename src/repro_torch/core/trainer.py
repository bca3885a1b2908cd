"""Embedder fine-tuning — the paper's training recipe as a Trainer; the
port of `repro/core/trainer.py`.

Defaults are the paper's hyperparameters (§3 Experimental Setup): one
epoch, lr = 6.5383156211679e-5, batch 16, Adam, max grad norm 0.5,
online contrastive loss.  One step is one stacked encoder forward over
both sides of every pair, the loss — for ``loss="online"`` through
`kernels.contrastive.ops`, whose CUDA kernels compute the value and the
gradient of the embeddings on a card — then backward, the clip and the
Adam update of `training.optim`, in place on the encoder's parameters.

Without ``params`` the encoder is initialised from ``ft.seed`` at the
config's widths; ``params`` takes a port state dict (e.g.
`models.state_dict_from_reference` of the reference's weights, or
another trainer's ``params``), whose values are copied in: the trainer
never shares a tensor with the caller, so a candidate built from the
live trainer's ``params`` trains without touching the live weights.

``adopt(other)`` is the hot swap of the embedder refresh (DESIGN.md
§11).  The reference swaps by assigning ``params``, which works there
because its embed closure reads ``self.params`` on every call; here
``make_embed_fn`` closes over ``self.model``, so the swap copies the
other trainer's weights into this model's parameters in place and
adopts its optimizer state.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.losses import contrastive_loss
from repro_torch.core.metrics import pair_classification_metrics
from repro_torch.data.corpora import PairDataset
from repro_torch.data.pairs import iter_batches, tokenize_pairs
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.kernels.contrastive import ops as contrastive_ops
from repro_torch.models import Encoder
from repro_torch.training.optim import adam, apply_updates


@dataclass
class FinetuneConfig:
    epochs: int = 1
    lr: float = 6.5383156211679e-5
    batch_size: int = 16
    max_grad_norm: Optional[float] = 0.5
    margin: float = 0.5
    loss: str = "online"          # 'online' | 'contrastive'
    max_len: int = 32
    seed: int = 0
    log_every: int = 50


class EmbedderTrainer:
    def __init__(self, model_cfg: ModelConfig, ft: FinetuneConfig = None,
                 params: Optional[Dict[str, torch.Tensor]] = None, *,
                 device="cuda"):
        assert model_cfg.is_encoder, "embedder must be an encoder config"
        self.cfg = model_cfg
        self.ft = ft or FinetuneConfig()
        if self.ft.loss not in ("online", "contrastive"):
            raise ValueError(f"loss {self.ft.loss!r}: 'online' or "
                             "'contrastive'")
        self.model = Encoder(model_cfg, seed=self.ft.seed, device=device)
        if params is not None:
            self.model.load_state_dict(params)
        self.model.eval()                 # no dropout: train == eval
        self.device = next(self.model.parameters()).device
        self.params = dict(self.model.named_parameters())
        init_opt, self._update = adam(self.ft.lr,
                                      max_grad_norm=self.ft.max_grad_norm)
        self.opt_state = init_opt(self.params)
        self.history: List[dict] = []

    # ------------------------------------------------------------------
    def _objective(self, batch: dict) -> torch.Tensor:
        """The loss of one batch of tokenised pairs (numpy arrays)."""
        dev = self.device
        toks = torch.as_tensor(np.concatenate([batch["tok1"],
                                               batch["tok2"]]), device=dev)
        masks = torch.as_tensor(np.concatenate([batch["mask1"],
                                                batch["mask2"]]), device=dev)
        e1, e2 = self.model.encode(toks, masks).chunk(2)
        labels = torch.as_tensor(batch["label"], device=dev)
        if self.ft.loss == "online":
            return contrastive_ops.online_contrastive_loss(
                e1, e2, labels, self.ft.margin)
        return contrastive_loss(e1, e2, labels, self.ft.margin)

    def _grads(self, loss: torch.Tensor) -> Dict[str, torch.Tensor]:
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[n] for n in names],
                                    allow_unused=True)
        return {n: torch.zeros_like(self.params[n]) if g is None else g
                for n, g in zip(names, grads)}

    def _step(self, batch: dict) -> dict:
        """One optimizer step; returns device scalars (no host sync)."""
        loss = self._objective(batch)
        grads = self._grads(loss)
        updates, self.opt_state, om = self._update(grads, self.opt_state,
                                                   self.params)
        apply_updates(self.params, updates)
        return {"loss": loss.detach(), **om}

    def fit(self, train: PairDataset, tokenizer: HashTokenizer,
            eval_ds: Optional[PairDataset] = None) -> dict:
        """Every ``log_every`` steps ``history`` gets the step's loss,
        grad norm and the seconds since the fit began (read after the
        loss reaches the host)."""
        arrays = tokenize_pairs(train, tokenizer, self.ft.max_len)
        t0 = time.perf_counter()
        n_steps = 0
        for batch in iter_batches(arrays, self.ft.batch_size,
                                  seed=self.ft.seed, epochs=self.ft.epochs):
            m = self._step(batch)
            n_steps += 1
            if n_steps % self.ft.log_every == 0:
                rec = {"step": n_steps, "loss": float(m["loss"])}
                if "grad_norm" in m:
                    rec["grad_norm"] = float(m["grad_norm"])
                rec["seconds"] = time.perf_counter() - t0
                self.history.append(rec)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out = {"steps": n_steps, "train_seconds": time.perf_counter() - t0}
        if eval_ds is not None:
            out["eval"] = self.evaluate(eval_ds, tokenizer)
        return out

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def embed_texts(self, texts, tokenizer: HashTokenizer,
                    batch_size: int = 64) -> np.ndarray:
        out = []
        for i in range(0, len(texts), batch_size):
            chunk = list(texts[i:i + batch_size])
            while len(chunk) < batch_size:    # one shape per call
                chunk.append("")
            ids, mask = tokenizer.encode_batch(chunk, self.ft.max_len)
            e = self.model.encode(
                torch.as_tensor(ids, device=self.device),
                torch.as_tensor(mask, device=self.device))
            out.append(e.cpu().numpy()[: len(texts[i:i + batch_size])])
        return np.concatenate(out, axis=0)

    def pair_scores(self, ds: PairDataset, tokenizer: HashTokenizer
                    ) -> np.ndarray:
        e1 = self.embed_texts(ds.q1, tokenizer)
        e2 = self.embed_texts(ds.q2, tokenizer)
        return np.sum(e1 * e2, axis=-1)

    def evaluate(self, ds: PairDataset, tokenizer: HashTokenizer) -> dict:
        scores = self.pair_scores(ds, tokenizer)
        return pair_classification_metrics(scores, ds.labels)

    @torch.no_grad()
    def adopt(self, other: "EmbedderTrainer") -> None:
        """Take ``other``'s weights (copied in place into this model's
        parameters, so every embed function already handed out sees
        them) and its optimizer state."""
        for name, p in self.params.items():
            p.copy_(other.params[name])
        self.opt_state = other.opt_state

    def make_embed_fn(self, tokenizer: HashTokenizer) -> Callable:
        """list[str] -> (B, D) unit-norm np — plugs into CachedLLMService."""
        return lambda texts: self.embed_texts(texts, tokenizer)
