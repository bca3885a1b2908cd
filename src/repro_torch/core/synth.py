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
in this repo.  ``LLMGenerator`` needs the decoder engine, which arrives
with the decoder-zoo slice of the port; until then it raises.
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
    """LLM-driven backend over the serving engine.  The port has no
    decoder engine yet (decoder-zoo slice), so constructing one raises."""

    def __init__(self, engine, tokenizer, max_new_tokens: int = 24,
                 seed: int = 0):
        raise NotImplementedError(
            "LLMGenerator drives the decoder engine, which arrives with "
            "the decoder-zoo slice of the port; use TemplateGenerator")


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
