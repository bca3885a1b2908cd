"""Port parity for the synthetic-data pipeline (paper §2.1): the
template generator's records, the dataset built from them and the JSONL
files are string-for-string the reference's, for the same seeds and
queries.  Exact comparisons throughout."""
import numpy as np
import pytest

from repro.core import synth as jsynth
from repro.data import sample_query as jsample_query
from repro_torch.core import synth
from repro_torch.data import make_pair_dataset, sample_query


def _queries(sample, n, seed, domain):
    rng = np.random.default_rng(seed)
    return [sample(rng, domain) for _ in range(n)]


@pytest.mark.parametrize("domain", ["medical", "quora"])
@pytest.mark.parametrize("n_pos,n_neg", [(2, 2), (1, 3)])
def test_template_records_match_reference(domain, n_pos, n_neg):
    jq = _queries(jsample_query, 64, 3, domain)
    pq = _queries(sample_query, 64, 3, domain)
    assert [q.text for q in pq] == [q.text for q in jq]
    a = jsynth.generate_synthetic_pairs(jq, jsynth.TemplateGenerator(seed=1),
                                        n_pos=n_pos, n_neg=n_neg)
    b = synth.generate_synthetic_pairs(pq, synth.TemplateGenerator(seed=1),
                                       n_pos=n_pos, n_neg=n_neg)
    assert [r.__dict__ for r in b] == [r.__dict__ for r in a]
    assert len(b) == 64 * (n_pos + n_neg)
    ja, pb = jsynth.records_to_dataset(a), synth.records_to_dataset(b)
    assert (pb.q1, pb.q2, pb.domain) == (ja.q1, ja.q2, ja.domain)
    np.testing.assert_array_equal(pb.labels, ja.labels)
    assert pb.labels.dtype == ja.labels.dtype


def test_records_are_order_independent_and_seeded():
    qs = _queries(sample_query, 16, 4, "medical")
    gen = synth.TemplateGenerator(seed=2)
    fwd = synth.generate_synthetic_pairs(qs, gen)
    rev = synth.generate_synthetic_pairs(qs[::-1], gen)
    key = [(r.question1, r.question2, r.kind) for r in fwd]
    assert sorted(key) == sorted((r.question1, r.question2, r.kind)
                                 for r in rev)
    other = synth.generate_synthetic_pairs(qs, synth.TemplateGenerator(3))
    assert [r.question2 for r in other] != [r.question2 for r in fwd]


def test_jsonl_files_match_reference(tmp_path):
    qs = _queries(sample_query, 8, 5, "medical")
    recs = synth.generate_synthetic_pairs(qs, synth.TemplateGenerator(0))
    jrecs = jsynth.generate_synthetic_pairs(
        _queries(jsample_query, 8, 5, "medical"), jsynth.TemplateGenerator(0))
    synth.export_jsonl(recs, str(tmp_path / "port.jsonl"))
    jsynth.export_jsonl(jrecs, str(tmp_path / "ref.jsonl"))
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "ref.jsonl").read_bytes()
    back = synth.import_jsonl(str(tmp_path / "ref.jsonl"))
    assert [r.__dict__ for r in back] == [r.__dict__ for r in recs]


def test_real_plus_synthetic_training_set():
    """The paper's recipe as the smoke builds it: the real train split
    plus synthetic pairs from unlabeled in-domain queries."""
    train, _ = make_pair_dataset("medical", 256, seed=0).split(
        eval_frac=0.15, seed=1)
    unlabeled = _queries(sample_query, 32, 7, "medical")
    syn = synth.records_to_dataset(synth.generate_synthetic_pairs(
        unlabeled, synth.TemplateGenerator(seed=1), n_pos=2, n_neg=2))
    assert len(syn) == 128 and syn.labels.sum() == 64
    assert set(syn.q1) <= {q.text for q in unlabeled}
    assert syn.domain == train.domain == "medical"


def test_llm_generator_yields_dual_labelled_records():
    """The LLM backend over the port's (reduced) decoder engine: one
    pass gives both paraphrase positives and distinct negatives, each
    generated text the first 12 sampled token ids, as the reference's
    ``LLMGenerator``; the same seed gives the same records."""
    from repro_torch.configs import get_config
    from repro_torch.data import HashTokenizer
    from repro_torch.models import LM
    from repro_torch.serving import ServeEngine
    cfg = get_config("phi3-mini-3.8b").reduced()
    engine = ServeEngine(LM(cfg, seed=0, device="cpu"), max_len=64)
    qs = _queries(sample_query, 3, 5, "medical")

    def run():
        gen = synth.LLMGenerator(engine, HashTokenizer(cfg.vocab_size),
                                 max_new_tokens=12, seed=4)
        return synth.generate_synthetic_pairs(qs, gen, n_pos=2, n_neg=1)

    recs = run()
    assert len(recs) == 3 * 3
    assert [r.is_duplicate for r in recs] == [1, 1, 0] * 3
    assert [r.kind for r in recs[:3]] == ["paraphrase", "paraphrase",
                                         "distinct"]
    for r, q in zip(recs, [q for q in qs for _ in range(3)]):
        assert r.question1 == q.text and r.domain == "medical"
        words = r.question2.split()
        assert len(words) == 12 and all(
            w.startswith("tok") and 0 <= int(w[3:]) < cfg.vocab_size
            for w in words)
    assert [r.__dict__ for r in run()] == [r.__dict__ for r in recs]
    ds = synth.records_to_dataset(recs)
    assert ds.labels.tolist() == [1, 1, 0] * 3
