"""Synthetic data generation pipeline (paper §2.1, Listings 1-2) — a
numpy copy of `repro/core/synth.py`; its records are string-for-string
the reference's.

From *unlabeled* in-domain queries, generate:
  * positive samples  — paraphrases preserving intent (is_duplicate=1),
  * negative samples  — topically related but semantically distinct
                        queries (is_duplicate=0),
in one dual-labeling pass.

``TemplateGenerator`` (fully offline and deterministic) uses the
grammar metadata carried by :class:`repro_torch.data.corpora.Query` — a
paraphrase re-renders the same (entity, aspect) with a different
template/synonyms; a distinct query keeps the entity but switches to a
different aspect, or asks about another entity through the same aspect.
This is the structural analogue of the paper's Qwen2.5-32B prompting,
with the LLM replaced by the grammar that defines semantic equivalence
in this repo.  ``LLMGenerator`` runs the paper's two prompts through the
port's decoder engine (`repro_torch.serving.ServeEngine`) instead.
"""
from __future__ import annotations

import json
import zlib
from dataclasses import dataclass
from typing import List, Protocol, Sequence

import numpy as np

from repro_torch.data.corpora import (
    DOMAINS, PairDataset, Query, render_query,
)


PARAPHRASE_PROMPT = (
    "You are a helpful {domain} expert. Generate {n} unique paraphrases of "
    "the given query. Original Query: '{query}' Each paraphrase should "
    "preserve the original meaning but use different wording. Return JSON "
    "with a key 'queries'."
)
DISTINCT_PROMPT = (
    "You are a helpful {domain} expert. Given a query, generate {n} "
    "distinct but related queries that explore different aspects of the "
    "topic. They should not be rewordings. Return JSON with 'queries'."
)


class GeneratorBackend(Protocol):
    def paraphrases(self, q: Query, n: int) -> List[Query]: ...
    def distinct(self, q: Query, n: int) -> List[Query]: ...


class TemplateGenerator:
    """Deterministic grammar-backed generator (default backend).

    Determinism is per *call*, not per instance history: each
    ``paraphrases``/``distinct`` call derives a fresh RNG from the
    construction seed and a stable content hash of the query, so
    `generate_synthetic_pairs` is bit-reproducible for a fixed seed no
    matter how the caller orders or interleaves its queries.  (The
    original design threaded one stateful ``rng`` through every call,
    which made each sample depend on the entire preceding call history
    — iterate the same query set in a different order and every output
    changed.)
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def _rng(self, q: Query, kind: str) -> np.random.Generator:
        key = f"{kind}|{q.domain}|{q.entity}|{q.aspect}|{q.text}"
        return np.random.default_rng(
            [self.seed, zlib.crc32(key.encode("utf-8"))])

    def paraphrases(self, q: Query, n: int) -> List[Query]:
        rng = self._rng(q, "paraphrase")
        out = []
        for _ in range(n):
            out.append(render_query(rng, q.domain, q.entity, q.aspect,
                                    exclude_template=q.template_idx))
        return out

    def distinct(self, q: Query, n: int) -> List[Query]:
        """Related-but-distinct negatives across *both* confusion axes:
        same entity with a different aspect ("different subtopics …",
        Listing 2) and a different entity asked through the same
        aspect's surface form.  A contrastive fit on aspect-swapped
        negatives alone never learns that the entity tokens carry the
        intent, and at serving time its false hits are exactly the
        same-aspect/different-entity neighbours."""
        rng = self._rng(q, "distinct")
        entities, aspects = DOMAINS[q.domain]
        other_aspects = [a for a in aspects if a != q.aspect]
        other_entities = [e for e in entities if e != q.entity]
        out = []
        for _ in range(n):
            entity, aspect = q.entity, q.aspect
            if other_entities and rng.random() < 0.25:
                entity = str(rng.choice(other_entities))
            else:
                aspect = str(rng.choice(other_aspects))
            out.append(render_query(rng, q.domain, entity, aspect))
        return out


class LLMGenerator:
    """LLM-driven backend over the serving engine (system-path demo):
    each call encodes the prompt ``n`` times (48 tokens) with
    ``tokenizer`` — whose vocab must fit the decoder's — samples
    ``max_new_tokens`` at temperature 1 from ``seed`` and keeps the first
    12 token ids of each row as the new query's text.  The engine's
    sampler draws from a ``torch.Generator``, so the texts differ from
    the reference's ``jax.random`` draws; the records' structure and
    labels do not."""

    def __init__(self, engine, tokenizer, max_new_tokens: int = 24,
                 seed: int = 0):
        self.engine = engine
        self.tok = tokenizer
        self.max_new = max_new_tokens
        self.seed = seed

    def _gen(self, prompt_tpl: str, q: Query, n: int) -> List[Query]:
        prompt = prompt_tpl.format(domain=q.domain, n=n, query=q.text)
        ids, _ = self.tok.encode_batch([prompt] * n, 48)
        res = self.engine.generate(ids, self.max_new, temperature=1.0,
                                   seed=self.seed)
        out = []
        for row in res.tokens:
            text = " ".join(f"tok{t}" for t in row[:12])
            out.append(Query(text, q.domain, q.entity, q.aspect, -1))
        return out

    def paraphrases(self, q: Query, n: int) -> List[Query]:
        return self._gen(PARAPHRASE_PROMPT, q, n)

    def distinct(self, q: Query, n: int) -> List[Query]:
        return self._gen(DISTINCT_PROMPT, q, n)


@dataclass
class SynthRecord:
    question1: str
    question2: str
    is_duplicate: int
    domain: str
    kind: str  # 'paraphrase' | 'distinct'


def generate_synthetic_pairs(unlabeled: Sequence[Query],
                             backend: GeneratorBackend,
                             n_pos: int = 2, n_neg: int = 2
                             ) -> List[SynthRecord]:
    """The dual-labeling pass: every unlabeled query yields both
    paraphrase positives and related-but-distinct negatives."""
    records: List[SynthRecord] = []
    for q in unlabeled:
        for p in backend.paraphrases(q, n_pos):
            records.append(SynthRecord(q.text, p.text, 1, q.domain,
                                       "paraphrase"))
        for d in backend.distinct(q, n_neg):
            records.append(SynthRecord(q.text, d.text, 0, q.domain,
                                       "distinct"))
    return records


def records_to_dataset(records: Sequence[SynthRecord]) -> PairDataset:
    return PairDataset(
        q1=[r.question1 for r in records],
        q2=[r.question2 for r in records],
        labels=np.asarray([r.is_duplicate for r in records], np.int32),
        domain=records[0].domain if records else "synthetic",
    )


def export_jsonl(records: Sequence[SynthRecord], path: str) -> None:
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r.__dict__) + "\n")


def import_jsonl(path: str) -> List[SynthRecord]:
    out = []
    with open(path) as f:
        for line in f:
            out.append(SynthRecord(**json.loads(line)))
    return out
