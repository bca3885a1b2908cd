"""Deterministic domain corpora with duplicate-pair structure.

Offline stand-ins for the paper's Kaggle Quora and medical
question-pair datasets (same schema: ``(question1, question2,
is_duplicate)``).  Queries come from a templated grammar:

    query  = template(aspect) ⊗ entity ⊗ synonym choices

* **positive pair**   (is_duplicate=1): same (entity, aspect), different
  template + synonyms — "myocardial infarction treatment" vs "how to
  treat a heart attack".
* **hard negative**   (is_duplicate=0): same entity, different aspect —
  the paper's Q1/Q3 diabetes example (topically related, semantically
  distinct).
* **easy negative**   (is_duplicate=0): different entity.

The grammar metadata is retained on every :class:`Query`, which is what
lets the synthetic-data pipeline (repro/core/synth.py) act as the
structural analogue of the paper's LLM prompts in Listings 1 and 2.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Grammar
# ---------------------------------------------------------------------------

_PERSON = ["someone", "a person", "a patient", "an adult", "an individual"]
_FIND_OUT = ["tell", "find out", "know", "determine", "figure out"]
_BEST = ["best", "most effective", "recommended", "proven", "top"]
_WAYS = ["ways", "methods", "strategies", "approaches", "options"]

# aspect -> list of templates; {e}=entity, other slots from the synonym
# tables above.  Each aspect has >=3 surface forms so positives differ.
ASPECT_TEMPLATES = {
    "symptoms": [
        "What are the symptoms of {e}?",
        "How can I {find} if {person} has {e}?",
        "What signs indicate {e}?",
        "Which warning signs point to {e}?",
    ],
    "treatment": [
        "How is {e} treated?",
        "What are the {best} {ways} to treat {e}?",
        "What treatment options exist for {e}?",
        "How do doctors manage {e}?",
    ],
    "causes": [
        "What causes {e}?",
        "Why does {person} develop {e}?",
        "What are the main causes of {e}?",
        "Which factors lead to {e}?",
    ],
    "diagnosis": [
        "How is {e} diagnosed?",
        "Which tests confirm {e}?",
        "What is the diagnostic procedure for {e}?",
        "How do doctors detect {e}?",
    ],
    "prevention": [
        "How can {e} be prevented?",
        "What are the {best} {ways} to prevent {e}?",
        "How does {person} avoid developing {e}?",
        "Which habits reduce the chance of {e}?",
    ],
    "risk": [
        "What are the risk factors for {e}?",
        "Who is most at risk of {e}?",
        "Which groups are more likely to develop {e}?",
        "What raises the risk of {e}?",
    ],
    "prognosis": [
        "What is the prognosis for {e}?",
        "What is the long term outlook for {person} with {e}?",
        "How does {e} progress over time?",
        "What outcomes are expected with {e}?",
    ],
    "diet": [
        "What diet helps with {e}?",
        "Which foods should {person} with {e} avoid?",
        "How should {person} with {e} eat?",
        "What nutrition advice applies to {e}?",
    ],
    # quora-flavoured aspects
    "howto": [
        "How can I become a good {e}?",
        "What should I do to be a great {e}?",
        "What are the {best} {ways} to become a {e}?",
        "How does {person} get started as a {e}?",
    ],
    "salary": [
        "How much does a {e} earn?",
        "What is the typical salary of a {e}?",
        "What does a {e} get paid?",
        "What income can a {e} expect?",
    ],
    "skills": [
        "What skills does a {e} need?",
        "Which abilities are essential for a {e}?",
        "What should a {e} be good at?",
        "What qualifications help a {e}?",
    ],
    "dayinlife": [
        "What does a {e} do every day?",
        "What is the daily routine of a {e}?",
        "How does a {e} spend a typical workday?",
        "What tasks fill a {e}'s day?",
    ],
    "education": [
        "What degree do I need to become a {e}?",
        "Which studies lead to a career as a {e}?",
        "What education is required for a {e}?",
        "Do I need formal training to be a {e}?",
    ],
}

MEDICAL_ENTITIES = [
    "type 2 diabetes", "early-stage diabetes", "hypertension", "asthma",
    "myocardial infarction", "stroke", "pneumonia", "bronchitis",
    "migraine", "epilepsy", "anemia", "arthritis", "osteoporosis",
    "hypothyroidism", "hyperthyroidism", "chronic kidney disease",
    "hepatitis b", "tuberculosis", "malaria", "dengue fever",
    "ear infection", "sinusitis", "tonsillitis", "appendicitis",
    "gallstones", "peptic ulcer", "crohn disease", "ulcerative colitis",
    "psoriasis", "eczema", "glaucoma", "cataract", "sleep apnea",
    "atrial fibrillation", "heart failure", "deep vein thrombosis",
    "parkinson disease", "alzheimer disease", "multiple sclerosis",
    "stress urinary incontinence",
]
MEDICAL_ASPECTS = ["symptoms", "treatment", "causes", "diagnosis",
                   "prevention", "risk", "prognosis", "diet"]

QUORA_ENTITIES = [
    "geologist", "software engineer", "data scientist", "photographer",
    "journalist", "chef", "pilot", "architect", "lawyer", "nurse",
    "electrician", "translator", "game developer", "graphic designer",
    "teacher", "financial analyst", "marine biologist", "astronomer",
    "civil engineer", "pharmacist", "veterinarian", "screenwriter",
    "economist", "statistician", "historian", "chemist", "barista",
    "carpenter", "firefighter", "paramedic", "librarian", "geneticist",
]
QUORA_ASPECTS = ["howto", "salary", "skills", "dayinlife", "education"]

DOMAINS = {
    "medical": (MEDICAL_ENTITIES, MEDICAL_ASPECTS),
    "quora": (QUORA_ENTITIES, QUORA_ASPECTS),
}


@dataclass(frozen=True)
class Query:
    text: str
    domain: str
    entity: str
    aspect: str
    template_idx: int


def render_query(rng: np.random.Generator, domain: str, entity: str,
                 aspect: str, exclude_template: int = -1) -> Query:
    templates = ASPECT_TEMPLATES[aspect]
    choices = [i for i in range(len(templates)) if i != exclude_template]
    ti = int(rng.choice(choices))
    text = templates[ti].format(
        e=entity,
        person=rng.choice(_PERSON),
        find=rng.choice(_FIND_OUT),
        best=rng.choice(_BEST),
        ways=rng.choice(_WAYS),
    )
    return Query(text, domain, entity, aspect, ti)


def sample_query(rng: np.random.Generator, domain: str) -> Query:
    entities, aspects = DOMAINS[domain]
    return render_query(rng, domain, str(rng.choice(entities)),
                        str(rng.choice(aspects)))


# ---------------------------------------------------------------------------
# Pair datasets
# ---------------------------------------------------------------------------

@dataclass
class PairDataset:
    q1: List[str]
    q2: List[str]
    labels: np.ndarray  # (N,) int32
    domain: str

    def __len__(self):
        return len(self.q1)

    def split(self, eval_frac: float = 0.15, seed: int = 0):
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(self.q1))
        n_eval = int(len(idx) * eval_frac)
        ev, tr = idx[:n_eval], idx[n_eval:]

        def take(ix):
            return PairDataset([self.q1[i] for i in ix],
                               [self.q2[i] for i in ix],
                               self.labels[ix], self.domain)

        return take(tr), take(ev)


def make_pair_dataset(domain: str, n_pairs: int, seed: int = 0,
                      pos_frac: float = 0.5,
                      hard_neg_frac: float = 0.7) -> PairDataset:
    """Balanced duplicate-pair dataset with hard/easy negative mix."""
    entities, aspects = DOMAINS[domain]
    rng = np.random.default_rng(seed)
    q1, q2, labels = [], [], []
    for _ in range(n_pairs):
        a = sample_query(rng, domain)
        if rng.random() < pos_frac:
            # positive: same (entity, aspect), forced different template
            b = render_query(rng, domain, a.entity, a.aspect,
                             exclude_template=a.template_idx)
            labels.append(1)
        elif rng.random() < hard_neg_frac:
            # hard negative: same entity, different aspect
            other = [x for x in aspects if x != a.aspect]
            b = render_query(rng, domain, a.entity, str(rng.choice(other)))
            labels.append(0)
        else:
            # easy negative: different entity
            other_e = [e for e in entities if e != a.entity]
            b = render_query(rng, domain, str(rng.choice(other_e)),
                             str(rng.choice(aspects)))
            labels.append(0)
        q1.append(a.text)
        q2.append(b.text)
    return PairDataset(q1, q2, np.asarray(labels, np.int32), domain)


def make_query_stream(domain: str, n: int, seed: int = 0,
                      repeat_frac: float = 0.33) -> List[Query]:
    """A serving-trace-like query stream where ~repeat_frac of queries
    are paraphrases of earlier ones (the paper's ~33% repeated-query
    statistic) — used by the end-to-end cache benchmarks."""
    rng = np.random.default_rng(seed)
    out: List[Query] = []
    for _ in range(n):
        if out and rng.random() < repeat_frac:
            prev = out[int(rng.integers(len(out)))]
            out.append(render_query(rng, prev.domain, prev.entity,
                                    prev.aspect,
                                    exclude_template=prev.template_idx))
        else:
            out.append(sample_query(rng, domain))
    return out
