"""Serving engine: batched prefill + decode with carried state, and the
paper's deployment — a semantic cache in front of it.

The port of `repro/serving/engine.py`.  ``ServeEngine`` is the
host-side loop around ``LM.prefill`` / ``LM.decode_step``; PyTorch runs
them eagerly, so there is nothing to compile per shape.  Sampling draws
Gumbel noise from an explicit ``torch.Generator`` seeded per call; the
port cannot reproduce ``jax.random``'s bits, so sampled tokens are
compared with the reference by distribution, greedy tokens exactly.
``CachedLLMService`` answers each miss-group leader with ``engine``
(or, with ``engine=None``, the echo ``answer(<query>)``).
``generate(use_frontend=True)`` prepends the frontend stub's frames
(`serving/frontend.py`) for the audio and vision configs.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.cache_service.protocol import CacheBackend, CacheRequest
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models.model import LM
from repro_torch.obs import Telemetry
from repro_torch.obs.registry import tenant_label
from repro_torch.serving.frontend import stub_frontend_embeds


@dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, max_new) int32
    n_prompt: int
    n_generated: int
    cache_hit: bool = False


class ServeEngine:
    """Batched autoregressive serving for a decoder ``LM``: the prompt's
    prefill, then ``max_new_tokens`` decode steps, each feeding back the
    token chosen from the last logits (argmax, or argmax of logits /
    temperature + Gumbel noise).  The KV caches hold ``max_len`` slots.
    Past them the caches wrap, as the reference's do: prefill keeps the
    last ``max_len`` positions and decode writes slot ``cur_len %
    max_len``, so a call whose frontend frames + prompt + new tokens
    exceed ``max_len`` attends to the newest ``max_len`` positions."""

    def __init__(self, model: LM, max_len: int = 512):
        self.model = model
        self.cfg = model.cfg
        self.max_len = max_len

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new_tokens: int = 32,
                 temperature: float = 0.0, seed: int = 0,
                 use_frontend: bool = False) -> GenerationResult:
        """prompts: (B, S) int ids below the config's vocab.  Greedy
        (temperature=0) or sampled.  ``use_frontend`` prepends the
        config's stub frames drawn from ``seed`` (none without a
        frontend)."""
        prompts = np.asarray(prompts)
        B, S = prompts.shape
        n_fe = self.cfg.frontend_len if use_frontend and self.cfg.frontend \
            else 0
        if prompts.size and not 0 <= prompts.min() <= prompts.max() \
                < self.cfg.vocab_size:
            raise ValueError(
                f"token ids in [{prompts.min()}, {prompts.max()}] outside "
                f"{self.cfg.name}'s vocab of {self.cfg.vocab_size}: encode "
                "prompts with HashTokenizer(vocab_size=cfg.vocab_size)")
        dev = self.model.device
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        fe = stub_frontend_embeds(self.cfg, B, seed, device=dev) \
            if n_fe else None
        logits, state = self.model.prefill(
            torch.as_tensor(prompts, dtype=torch.int32, device=dev),
            self.max_len, frontend_embeds=fe)
        out = torch.empty((B, max_new_tokens), dtype=torch.int32,
                          device=dev)
        tok = self._select(logits, temperature, gen)
        for t in range(max_new_tokens):
            out[:, t] = tok[:, 0]
            logits, state = self.model.decode_step(state, tok)
            tok = self._select(logits, temperature, gen)
        return GenerationResult(out.cpu().numpy(), n_prompt=S,
                                n_generated=max_new_tokens)

    @staticmethod
    def _select(logits: torch.Tensor, temperature: float,
                gen: torch.Generator) -> torch.Tensor:
        if temperature <= 0.0:
            return logits.argmax(-1).to(torch.int32)[:, None]
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        g = -torch.log(-torch.log(u.clamp_min(1e-20)))
        return (logits.float() / temperature + g).argmax(-1).to(
            torch.int32)[:, None]


@dataclass
class ServedRequest:
    query: str
    response: str
    cache_hit: bool
    score: float = 0.0


class CachedLLMService:
    """``handle`` is a thin typed pipeline over any ``CacheBackend``
    (DESIGN.md §7): embed -> ``plan`` (per-row verdicts, resolved
    responses, admission pre-decision, miss coalescing) -> one answer
    per miss *group* leader -> ``commit`` -> ``maintenance()`` between
    batches when the receipt asks for it."""

    def __init__(self, embed_fn, cache: CacheBackend,
                 engine: Optional[ServeEngine], tokenizer: HashTokenizer,
                 max_query_len: int = 32,
                 max_new_tokens: int = 16, fused: Optional[bool] = None,
                 coalesce: bool = True,
                 telemetry: Optional[Telemetry] = None):
        """``fused`` (None = leave the backend's choice) selects the
        cache's cascade path — the fused lookup kernel vs the four-op
        composition.  ``telemetry`` (None = adopt the backend's) wires
        the §10 spans and serving counters: each ``handle`` produces
        one span tree rooted at ``request`` with embed/plan/generate/
        commit(/maintenance) children.

        ``tokenizer`` encodes the prompts for ``engine``, so its ids must
        stay inside the decoder's vocab: pass
        ``HashTokenizer(vocab_size=engine.cfg.vocab_size)``, not the
        encoder's tokenizer (the full-width encoder's vocab is larger
        than Phi-3-mini's); a larger one is refused."""
        if engine is not None \
                and tokenizer.vocab_size > engine.cfg.vocab_size:
            raise ValueError(
                f"tokenizer vocab {tokenizer.vocab_size} exceeds the "
                f"decoder's {engine.cfg.vocab_size}: prompt ids would fall "
                "outside its embedding table")
        self.embed_fn = embed_fn          # list[str] -> (B, D) unit vectors
        if not isinstance(cache, CacheBackend):
            raise TypeError(
                f"cache backend {type(cache).__name__} does not implement "
                "the CacheBackend protocol (capabilities/plan/commit/"
                "maintenance/stats_snapshot)")
        self.cache = cache
        self.caps = cache.capabilities()
        self.engine = engine
        self.tok = tokenizer
        self.max_query_len = max_query_len
        self.max_new_tokens = max_new_tokens
        self.coalesce = coalesce
        self.telemetry = (telemetry
                          or getattr(cache, "telemetry", None)
                          or Telemetry())
        reg = self.telemetry.registry
        self._stage_h = self.telemetry.stage_histogram()
        self._m_requests = reg.counter(
            "serve_requests_total", "queries handled", labels=("tenant",))
        self._m_hits = reg.counter(
            "serve_hits_total", "queries served from cache",
            labels=("tenant",))
        self._m_misses = reg.counter(
            "serve_misses_total", "queries that missed", labels=("tenant",))
        self._c_generations = reg.counter(
            "serve_generations_total", "LLM generations (group leaders)"
            ).labels()
        self._c_coalesced = reg.counter(
            "serve_coalesced_misses_total",
            "misses served by another row's generation").labels()
        self._c_maintenance = reg.counter(
            "serve_maintenance_calls_total",
            "between-batch maintenance() calls").labels()
        self._trace = itertools.count()
        if fused is not None:
            if self.caps.fused_lookup:
                self.cache.set_fused(fused)
            elif fused:
                raise ValueError(
                    f"cache backend {type(cache).__name__} has no fused "
                    "cascade path; use CacheService or drop fused=True")

    def _llm_answer(self, queries: List[str]) -> List[str]:
        if self.engine is None:  # degenerate echo backend
            return [f"answer({q})" for q in queries]
        ids, _ = self.tok.encode_batch(queries, self.max_query_len)
        res = self.engine.generate(ids, self.max_new_tokens)
        return [" ".join(map(str, row)) for row in res.tokens]

    def handle(self, queries: List[str],
               tenant: int = 0) -> List[ServedRequest]:
        if not self.caps.tenants and np.any(np.asarray(tenant) != 0):
            raise ValueError(
                f"cache backend {type(self.cache).__name__} is not "
                "tenant-aware; serving tenant "
                f"{tenant} through it would break isolation")
        tracer = self.telemetry.tracer
        lab = tenant_label(np.asarray(tenant))
        trace_id = next(self._trace)
        with tracer.span("request", tenant=lab, trace_id=trace_id,
                         n=len(queries)):
            t0 = time.perf_counter()
            with tracer.span("embed", tenant=lab):
                embs = self.embed_fn(queries)
            self._stage_h.observe(time.perf_counter() - t0,
                                  stage="embed", tenant=lab)
            with tracer.span("plan", tenant=lab):
                plan = self.cache.plan(
                    CacheRequest.build(embs, tenant, trace_id=trace_id,
                                       texts=queries),
                    coalesce=self.coalesce)

            leaders = plan.leader_rows()
            t0 = time.perf_counter()
            with tracer.span("generate", tenant=lab,
                             n_leaders=len(leaders)):
                answers = dict(zip(
                    leaders,
                    self._llm_answer([queries[i] for i in leaders])
                    if leaders else []))
            self._stage_h.observe(time.perf_counter() - t0,
                                  stage="generate", tenant=lab)
            responses: List[Optional[str]] = [None] * len(queries)
            for i in plan.miss_rows():
                responses[int(i)] = answers[int(plan.miss_leader[i])]

            with tracer.span("commit", tenant=lab):
                receipt = self.cache.commit(plan, responses)
            self._m_requests.inc(len(queries), tenant=lab)
            self._m_hits.inc(int(plan.hit.sum()), tenant=lab)
            self._m_misses.inc(int((~plan.hit).sum()), tenant=lab)
            self._c_generations.inc(len(leaders))
            self._c_coalesced.inc(plan.n_coalesced)
            if receipt.rebuild_due:
                with tracer.span("maintenance", tenant=lab):
                    self.cache.maintenance()
                self._c_maintenance.inc()

        out: List[Optional[ServedRequest]] = [None] * len(queries)
        for i, q in enumerate(queries):
            if plan.hit[i]:
                out[i] = ServedRequest(q, plan.responses[i], True,
                                       float(plan.scores[i]))
            else:
                out[i] = ServedRequest(q, responses[i], False)
        return out  # type: ignore

    def stats(self) -> Dict[str, object]:
        """Unified telemetry snapshot: the serving counters plus the
        backend's ``stats_snapshot()`` nested under ``"backend"``."""
        reg = self.telemetry.registry
        snap = self.cache.stats_snapshot()
        backend = snap.to_dict() if hasattr(snap, "to_dict") else dict(snap)
        return {"backend": backend,
                "requests": int(reg.value("serve_requests_total")),
                "hits": int(reg.value("serve_hits_total")),
                "misses": int(reg.value("serve_misses_total")),
                "generations": int(reg.value("serve_generations_total")),
                "coalesced_misses": int(
                    reg.value("serve_coalesced_misses_total")),
                "maintenance_calls": int(
                    reg.value("serve_maintenance_calls_total")),
                "hit_rate": self.hit_rate}

    @property
    def hit_rate(self) -> float:
        reg = self.telemetry.registry
        hits = reg.value("serve_hits_total")
        n = hits + reg.value("serve_misses_total")
        return hits / n if n else 0.0
