"""Port parity for the online embedder refresh (DESIGN.md §11): pair
pooling -> trigger -> background one-epoch fine-tune -> eval gate ->
shadow re-embed -> versioned publish or rollback, on the CPU.

Mirrors the reference's `tests/test_embedder_refresh.py` test for test,
driving the same numpy stream through the JAX service and the port's
with the reference's own ``init_lm`` weights carried into the port's
trainer (``modernbert-149m.reduced(vocab_size=1024)``, d_model 128), and
adds what only the port can get wrong:

* the hot swap: the reference publishes by assigning ``params``, which
  its embed closure reads per call; the port's embed function closes
  over the live ``nn.Module``, so the publish must copy the candidate's
  weights into it in place — after a publish the service's embed
  function returns the candidate's embeddings;
* reference behaviour reproduced, not fixed: a publish leaves the IVF
  centroids and lists, and the cold tier's int8 rows, in the old
  embedding space (until the next rebuild / forever).

Tolerances: ints, ids, slots, flags, versions, counters and strings
exact; keys, embeddings and scores ``atol 1e-4`` (a few Adam steps from
float32 gradients summed in another order); gate metrics and the
recalibrated threshold ``atol 1e-4``, with the same pass/fail.  The
k-means seed row is handed to the port from the reference's draw.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.cache_service.service as jservice_mod
import repro_torch.cache_service.service as service_mod
from repro.cache_service import CacheConfig as JCacheConfig
from repro.cache_service import CacheService as JCacheService
from repro.cache_service import EmbedderRefreshPolicy as JRefreshPolicy
from repro.cache_service import tiers as jtiers
from repro.cache_service.policy import PolicyTable as JPolicyTable
from repro.cache_service.policy import TenantPolicy as JTenantPolicy
from repro.cache_service.protocol import CacheRequest as JCacheRequest
from repro.configs import get_config as jget_config
from repro.core import EmbedderTrainer as JEmbedderTrainer
from repro.core import FinetuneConfig as JFinetuneConfig
from repro.data import HashTokenizer as JHashTokenizer
from repro.data.corpora import PairDataset as JPairDataset
from repro.models import init_lm, split
from repro_torch.cache_service import (
    CacheConfig, CacheRequest, CacheService, EmbedderRefreshPolicy, tiers,
)
from repro_torch.cache_service.policy import PolicyTable, TenantPolicy
from repro_torch.configs import get_config
from repro_torch.core import EmbedderTrainer, FinetuneConfig
from repro_torch.core import ivf as port_ivf
from repro_torch.data import HashTokenizer
from repro_torch.data.corpora import PairDataset
from repro_torch.models import state_dict_from_reference

ATOL = 1e-4


def _reference_first_seed(valid, seed):
    v = jnp.asarray(valid.cpu().numpy())
    p = v.astype(jnp.float32)
    p = jnp.where(p.sum() > 0, p, jnp.ones_like(p))
    return int(jax.random.choice(jax.random.PRNGKey(seed), v.shape[0],
                                 p=p / p.sum()))


@pytest.fixture(autouse=True)
def _same_kmeans_seed(monkeypatch):
    monkeypatch.setattr(port_ivf, "first_seed", _reference_first_seed)


def _unit(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


@pytest.fixture(scope="module")
def enc():
    jcfg = jget_config("modernbert-149m").reduced(vocab_size=1024)
    pcfg = get_config("modernbert-149m").reduced(vocab_size=1024)
    pv, _ = split(init_lm(jcfg, jax.random.PRNGKey(0)))
    sd = state_dict_from_reference(jax.tree_util.tree_map(np.asarray, pv),
                                   pcfg)
    return jcfg, pcfg, pv, sd


# a gate that always passes (unless eval-starved) + fast synth backfill
PERMISSIVE = dict(min_pairs=8, min_class=2, refresh_interval=8,
                  min_precision=0.0, min_recall=0.0,
                  max_f1_regression=10.0, synth_domain="medical",
                  synth_min_pairs=32)
FT = dict(epochs=1, batch_size=8, max_len=12)
# threshold 0.9: the untrained embedder scores distinct template texts
# up to ~0.87 against each other, so only exact repeats hit and the
# stream yields both hit and miss pairs
SVC = dict(hot_capacity=64, warm_capacity=256, n_clusters=4, bucket=32,
           threshold=0.9)


class Pair:
    """The reference service and the port's over the same weights; every
    call goes to both and their outputs are compared."""

    def __init__(self, enc, svc_kw=None, **pol_kw):
        jcfg, pcfg, pv, sd = enc
        pol = dict(PERMISSIVE)
        pol.update(pol_kw)
        kw = dict(SVC)
        kw.update(svc_kw or {})
        self.jtok = JHashTokenizer(vocab_size=jcfg.vocab_size)
        self.tok = HashTokenizer(vocab_size=pcfg.vocab_size)
        self.jtr = JEmbedderTrainer(jcfg, JFinetuneConfig(**FT), params=pv)
        self.tr = EmbedderTrainer(pcfg, FinetuneConfig(**FT), params=sd,
                                  device="cpu")
        self.ref = JCacheService(JCacheConfig.from_kwargs(
            jcfg.d_model, embedder_trainer=self.jtr,
            embedder_tokenizer=self.jtok,
            refresh_policy=JRefreshPolicy(**pol), **kw))
        self.port = CacheService(CacheConfig.from_kwargs(
            pcfg.d_model, embedder_trainer=self.tr,
            embedder_tokenizer=self.tok,
            refresh_policy=EmbedderRefreshPolicy(**pol), **kw),
            device="cpu")
        self.jemb = self.jtr.make_embed_fn(self.jtok)
        self.emb = self.tr.make_embed_fn(self.tok)

    def plan(self, texts, tenant=0):
        jp = self.ref.plan(JCacheRequest.build(self.jemb(texts), tenant,
                                               texts=texts), coalesce=False)
        pp = self.port.plan(CacheRequest.build(self.emb(texts), tenant,
                                               texts=texts), coalesce=False)
        np.testing.assert_array_equal(pp.hit, jp.hit)
        np.testing.assert_array_equal(pp.value_ids, jp.value_ids)
        np.testing.assert_allclose(pp.scores, jp.scores, atol=ATOL)
        assert pp.embed_version == jp.embed_version
        assert pp.responses == jp.responses
        return jp, pp

    def commit(self, jp, pp, responses):
        jr = self.ref.commit(jp, responses)
        pr = self.port.commit(pp, responses)
        for f in ("admitted", "skipped", "evicted", "rebuild_due",
                  "embed_version", "stale_version_skipped"):
            assert getattr(pr, f) == getattr(jr, f), f
        return pr

    def drive(self, texts, tenant=0):
        jp, pp = self.plan(texts, tenant)
        resp = [None if h else f"r({t})" for h, t in zip(pp.hit, texts)]
        return pp, self.commit(jp, pp, resp)

    def stream(self, n=24, tenant=0, prefix="drug"):
        """Repeats (-> hits, positive pairs) and fresh queries (-> misses
        with a same-tenant neighbour, negative pairs)."""
        texts = [f"what dose of {prefix} {i % 6} should the patient take"
                 for i in range(n)]
        for i in range(0, n, 4):
            self.drive(texts[i:i + 4], tenant)
        return texts

    def refresh_due(self):
        assert self.port._refresh_due() == self.ref._refresh_due()
        return self.port._refresh_due()

    def maintenance(self, block=False):
        jr = self.ref.maintenance(block=block)
        pr = self.port.maintenance(block=block)
        for f in ("refresh_started", "refresh_published",
                  "refresh_rolled_back", "refresh_in_flight",
                  "embed_version", "rebuild_started", "rebuild_published"):
            assert getattr(pr, f) == getattr(jr, f), f
        return pr

    def check_state(self):
        """Tiers, host maps, the pair pool, policies, refresh stats and
        the gate's gauges equal."""
        for a, b in ((self.port.hot, self.ref.hot),
                     (self.port.warm, self.ref.warm)):
            np.testing.assert_array_equal(a.valid.numpy(),
                                          np.asarray(b.valid))
            np.testing.assert_array_equal(a.value_ids.numpy(),
                                          np.asarray(b.value_ids))
            np.testing.assert_allclose(a.keys.numpy(), np.asarray(b.keys),
                                       atol=ATOL)
        assert self.port.responses == self.ref.responses
        assert self.port._texts == self.ref._texts
        assert self.port.feedback.pairs.items == self.ref.feedback.pairs.items
        assert self.port.feedback.pairs.seen == self.ref.feedback.pairs.seen
        for t in (0, 1, 9):
            np.testing.assert_allclose(self.port.policies.get(t).threshold,
                                       self.ref.policies.get(t).threshold,
                                       atol=ATOL)
        a = self.port.stats_snapshot().refresh
        b = self.ref.stats_snapshot().refresh
        for k in ("embed_version", "refreshes_started",
                  "refreshes_published", "refreshes_rolled_back",
                  "stale_version_commits", "refresh_in_flight",
                  "pairs_held"):
            assert a[k] == b[k], k
        if b["recalibrated_threshold"] is None:
            assert a["recalibrated_threshold"] is None
        else:
            np.testing.assert_allclose(a["recalibrated_threshold"],
                                       b["recalibrated_threshold"],
                                       atol=ATOL)
        for side in ("candidate", "baseline"):
            for m in ("precision", "recall", "f1"):
                np.testing.assert_allclose(
                    self.port.telemetry.registry.value(
                        "cache_refresh_eval", embedder=side, metric=m),
                    self.ref.telemetry.registry.value(
                        "cache_refresh_eval", embedder=side, metric=m),
                    atol=ATOL)


def _params(trainer):
    return {n: p.detach().clone() for n, p in trainer.params.items()}


# ---------------------------------------------------------------------------
# ctor / capability surface
# ---------------------------------------------------------------------------

def test_ctor_validation_and_caps(enc):
    pair = Pair(enc)
    caps = pair.port.capabilities()
    assert caps.learned_embedder and not caps.learned_admission
    assert dataclasses.asdict(caps) == dataclasses.asdict(
        pair.ref.capabilities())
    with pytest.raises(ValueError):
        JCacheService(JCacheConfig.from_kwargs(16, learned_embedder=True))
    with pytest.raises(ValueError):
        CacheService(CacheConfig.from_kwargs(16, learned_embedder=True),
                     device="cpu")


# ---------------------------------------------------------------------------
# tiers-level: the key-panel swap primitive
# ---------------------------------------------------------------------------

def test_publish_reembedded_keys_swaps_only_keys():
    rng = np.random.default_rng(3)
    D, Nh, Nw = 16, 8, 32
    hk = _unit(rng.standard_normal((Nh, D))).astype(np.float32)
    hv = rng.random(Nh) > 0.4
    hid = rng.integers(0, 99, Nh).astype(np.int32)
    wk = _unit(rng.standard_normal((Nw, D))).astype(np.float32)
    wv = rng.random(Nw) > 0.4
    wid = rng.integers(100, 199, Nw).astype(np.int32)
    nh = rng.standard_normal((Nh, D)).astype(np.float32) * 3.0
    nw = rng.standard_normal((Nw, D)).astype(np.float32) * 3.0
    jh = jtiers.init_hot(Nh, D)._replace(
        keys=jnp.asarray(hk), valid=jnp.asarray(hv),
        value_ids=jnp.asarray(hid))
    jw = jtiers.init_warm(Nw, D, 4, 8)._replace(
        keys=jnp.asarray(wk), valid=jnp.asarray(wv),
        value_ids=jnp.asarray(wid), cursor=jnp.asarray(7, jnp.int32),
        total=jnp.asarray(19, jnp.int32))
    jh2, jw2 = jtiers.publish_reembedded_keys(jh, jw, jnp.asarray(nh),
                                              jnp.asarray(nw))
    ph = tiers.init_hot(Nh, D, "cpu")._replace(
        keys=torch.as_tensor(hk), valid=torch.as_tensor(hv),
        value_ids=torch.as_tensor(hid))
    pw = tiers.init_warm(Nw, D, 4, 8, "cpu")._replace(
        keys=torch.as_tensor(wk), valid=torch.as_tensor(wv),
        value_ids=torch.as_tensor(wid), cursor=torch.tensor(7),
        total=torch.tensor(19))
    ph2, pw2 = tiers.publish_reembedded_keys(ph, pw, torch.as_tensor(nh),
                                             torch.as_tensor(nw))
    # keys swapped in re-normalized, the int8 mirror requantized
    np.testing.assert_allclose(ph2.keys.numpy(), np.asarray(jh2.keys),
                               atol=1e-6)
    np.testing.assert_allclose(pw2.keys.numpy(), np.asarray(jw2.keys),
                               atol=1e-6)
    np.testing.assert_array_equal(pw2.keys_q.numpy(), np.asarray(jw2.keys_q))
    # scales: XLA divides by 127 as a multiply by the reciprocal (2 ulps)
    np.testing.assert_allclose(pw2.scales.numpy(), np.asarray(jw2.scales),
                               rtol=3e-7)
    # liveness, identity, ring position and the index are untouched
    for a, b in ((ph.valid, ph2.valid), (ph.value_ids, ph2.value_ids),
                 (pw.valid, pw2.valid), (pw.value_ids, pw2.value_ids),
                 (pw.cursor, pw2.cursor), (pw.total, pw2.total),
                 (pw.centroids, pw2.centroids)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# trigger + synth backfill
# ---------------------------------------------------------------------------

def test_trigger_min_pairs_guard(enc):
    pair = Pair(enc, min_pairs=10**6)
    assert not pair.refresh_due()            # empty pool
    pair.stream(n=16)
    assert len(pair.port.feedback.pairs) > 0  # the stream did pool pairs
    assert not pair.refresh_due()            # but never enough
    pair.check_state()


def test_trigger_min_class_guard_and_synth_waiver(enc):
    # a hits-only stream pools positives only: without a synth domain
    # the class guard blocks the trigger
    pair = Pair(enc, min_pairs=4, min_class=2, synth_domain=None)
    for _ in range(6):
        pair.drive(["repeat me exactly", "repeat me exactly also"])
    pairs = pair.port.feedback.pairs
    assert pairs.n_pos >= 4 and pairs.n_neg == 0
    assert not pair.refresh_due()
    # the same pool with a synth domain: backfill waives the guard
    pair.port._refresh_policy = EmbedderRefreshPolicy(**PERMISSIVE)
    pair.ref._refresh_policy = JRefreshPolicy(**PERMISSIVE)
    assert pair.refresh_due()


def test_synth_backfill_balances_and_is_deterministic():
    out = {}
    for mod, ds, pol in (
            (jservice_mod, JPairDataset, JRefreshPolicy(**PERMISSIVE)),
            (service_mod, PairDataset, EmbedderRefreshPolicy(**PERMISSIVE))):
        one_class = ds(q1=["a", "b"], q2=["c", "d"],
                       labels=np.ones(2, np.int32), domain="feedback")
        empty = ds(q1=[], q2=[], labels=np.zeros(0, np.int32),
                   domain="feedback")
        balanced = ds(q1=["a", "b"], q2=["c", "d"],
                      labels=np.asarray([0, 1], np.int32), domain="feedback")
        tr, ev = mod._synth_backfill(one_class, empty, pol)
        assert len(tr.labels) + len(ev.labels) >= pol.synth_min_pairs
        assert len(set(np.asarray(tr.labels).tolist())) == 2   # balanced
        assert len(set(np.asarray(ev.labels).tolist())) == 2
        assert list(tr.q1[:2]) == ["a", "b"]                   # kept
        tr2, ev2 = mod._synth_backfill(one_class, empty, pol)
        assert list(tr.q1) == list(tr2.q1) and list(ev.q2) == list(ev2.q2)
        np.testing.assert_array_equal(tr.labels, tr2.labels)
        # a balanced eval slice is left untouched
        _, ev3 = mod._synth_backfill(one_class, balanced, pol)
        assert list(ev3.q1) == ["a", "b"]
        out[mod] = (tr, ev)
    (jtr, jev), (ptr, pev) = out[jservice_mod], out[service_mod]
    for a, b in ((ptr, jtr), (pev, jev)):      # string for string
        assert list(a.q1) == list(b.q1) and list(a.q2) == list(b.q2)
        np.testing.assert_array_equal(a.labels, b.labels)


def test_pair_pool_split_matches_reference(enc):
    """The reservoir's draws and ``split(eval_frac, seed)`` give the
    same pairs in the same order on both sides."""
    pair = Pair(enc, min_pairs=10**6)
    pair.stream(n=24)
    pair.stream(n=8, tenant=1, prefix="other drug")
    pol = pair.port._refresh_policy
    for a, b in zip(pair.port.feedback.pairs.split(pol.eval_frac, pol.seed),
                    pair.ref.feedback.pairs.split(pol.eval_frac, pol.seed)):
        assert list(a.q1) == list(b.q1) and list(a.q2) == list(b.q2)
        np.testing.assert_array_equal(a.labels, b.labels)


# ---------------------------------------------------------------------------
# full lifecycle: publish, hot swap, recall through the overlap
# ---------------------------------------------------------------------------

def test_refresh_publishes_and_recall_survives(enc):
    pair = Pair(enc)
    texts = pair.stream(n=24)
    assert pair.refresh_due()
    rep = pair.maintenance()
    assert rep.refresh_started and rep.refresh_in_flight
    old_hot_keys = pair.port.hot.keys.clone()
    rep = pair.maintenance(block=True)
    assert rep.refresh_published and not rep.refresh_rolled_back
    assert rep.embed_version == 1 and pair.port._embed_version == 1
    st = pair.port.stats_snapshot().refresh
    assert st["refreshes_published"] == 1 and st["embed_version"] == 1
    assert not st["refresh_in_flight"] and st["last_refresh_s"] > 0
    pair.check_state()
    # the panel moved: valid hot rows were re-embedded
    valid = pair.port.hot.valid
    assert valid.any()
    assert not torch.allclose(pair.port.hot.keys[valid],
                              old_hot_keys[valid])
    # recall 1.0 on committed entries through the swap: the live embed
    # function reads the refreshed weights and the panel was re-embedded
    # into the same space
    uniq = sorted(set(texts))
    jp, pp = pair.plan(uniq)
    assert pp.hit.all(), pp.scores
    assert all(r is not None for r in pp.responses)
    assert pp.embed_version == 1
    _, rc = pair.drive(["a brand new post-swap query"])
    assert rc.embed_version == 1 and rc.stale_version_skipped == 0


def test_publish_swaps_the_live_embedder_in_place(enc):
    """The hot swap: after a publish the service's embed function (made
    before it) returns the candidate's embeddings, which the reference's
    embed closure returns too; the live trainer took the candidate's
    optimizer state; a rollback leaves the live weights as they were."""
    pair = Pair(enc)
    probe = ["what dose of drug 1 should the patient take",
             "an unrelated probe text about visiting hours"]
    before = pair.emb(probe)
    pair.stream(n=24)
    assert pair.maintenance().refresh_started
    box = pair.port._refresh_box
    assert pair.maintenance(block=True).refresh_published
    cand = box["trainer"]
    after = pair.emb(probe)
    np.testing.assert_array_equal(after, cand.embed_texts(probe, pair.tok))
    assert np.abs(after - before).max() > 10 * ATOL
    np.testing.assert_allclose(after, pair.jemb(probe), atol=ATOL)
    assert pair.tr.opt_state is cand.opt_state
    assert pair.tr.opt_state.step == box["fit"]["steps"] > 0
    for n, p in pair.tr.params.items():
        assert torch.equal(p, cand.params[n])
        assert p is not cand.params[n]       # copied, not shared
    # the keys the service holds are the live embedder's, not stale ones
    uniq = sorted(set(pair.port._texts.values()))
    live = pair.emb(uniq)
    hv = pair.port.hot.value_ids[pair.port.hot.valid].tolist()
    keys = pair.port.hot.keys[pair.port.hot.valid].numpy()
    for v, key in zip(hv, keys):
        np.testing.assert_allclose(
            key, live[uniq.index(pair.port._texts[v])], atol=1e-5)


def test_rollback_keeps_live_embedder_and_panel(enc):
    pair = Pair(enc, min_precision=1.01)
    pair.stream(n=24)
    keys_before = pair.port.hot.keys.clone()
    old_params = _params(pair.tr)
    old_opt = pair.tr.opt_state
    assert pair.maintenance().refresh_started
    rep = pair.maintenance(block=True)
    assert rep.refresh_rolled_back and not rep.refresh_published
    assert pair.port._embed_version == 0
    for n, p in pair.tr.params.items():                 # never touched
        assert torch.equal(p, old_params[n])
    assert pair.tr.opt_state is old_opt
    assert torch.equal(pair.port.hot.keys, keys_before)
    st = pair.port.stats_snapshot().refresh
    assert st["refreshes_rolled_back"] == 1
    assert st["refreshes_started"] == 1
    pair.check_state()


def test_eval_starved_fails_closed(enc):
    """No synth domain + a one-class eval slice: the gate refuses to
    judge and rolls back rather than publish unjudged."""
    pair = Pair(enc, synth_domain=None, min_class=0, min_pairs=4)
    for _ in range(4):                    # hits only -> all-positive pool
        pair.drive(["repeat me exactly", "repeat me exactly also"])
    assert pair.port.feedback.pairs.n_neg == 0 and pair.refresh_due()
    pair.maintenance()
    rep = pair.maintenance(block=True)
    assert rep.refresh_rolled_back and pair.port._embed_version == 0
    pair.check_state()


# ---------------------------------------------------------------------------
# version consistency: stale plans rejected at commit, not mis-scored
# ---------------------------------------------------------------------------

def test_stale_version_plan_rejected_at_commit(enc):
    pair = Pair(enc)
    pair.stream(n=24)
    stale_texts = ["an in-flight query planned under version zero"]
    jp, pp = pair.plan(stale_texts)
    assert pp.embed_version == 0 and pp.admit.any()
    pair.maintenance()
    pair.maintenance(block=True)           # publish: version -> 1
    assert pair.port._embed_version == 1
    live = len(pair.port.responses)
    rc = pair.commit(jp, pp, ["stale response"])
    assert rc.admitted == 0
    assert rc.stale_version_skipped == 1
    assert rc.embed_version == 1
    assert len(pair.port.responses) == live
    assert pair.port.stats_snapshot().refresh["stale_version_commits"] == 1
    # the same query replanned under the live version commits
    plan2, rc2 = pair.drive(stale_texts)
    assert plan2.embed_version == 1
    assert rc2.stale_version_skipped == 0 and rc2.admitted == 1
    pair.check_state()


# ---------------------------------------------------------------------------
# evict-tenant during the shadow re-embed (no resurrection)
# ---------------------------------------------------------------------------

def test_evict_during_shadow_reembed_no_resurrection(enc, monkeypatch):
    pair = Pair(enc)
    pair.stream(n=16, tenant=0)
    doomed = pair.stream(n=8, tenant=1, prefix="other drug")
    assert pair.refresh_due()
    gate = threading.Event()
    for mod in (jservice_mod, service_mod):
        real = mod._reembed_snapshot

        def gated(*a, _real=real, **kw):
            assert gate.wait(timeout=120), "test gate never opened"
            return _real(*a, **kw)

        # the refresh thread resolves the name at call time, so patching
        # the module global parks it right before the snapshot re-embed
        monkeypatch.setattr(mod, "_reembed_snapshot", gated)
    assert pair.maintenance().refresh_started
    # mid-flight: drop tenant 1 entirely (its ids are in the snapshot)
    hot = pair.port.hot
    freed = set(hot.value_ids[(hot.tenants == 1) & hot.valid].tolist())
    assert freed
    n_ref = pair.ref.evict_tenant(1)
    assert pair.port.evict_tenant(1) == n_ref >= len(freed)
    assert not (pair.port.hot.valid & (pair.port.hot.tenants == 1)).any()
    gate.set()
    rep = pair.maintenance(block=True)
    assert rep.refresh_published and pair.port._embed_version == 1
    pair.check_state()
    # no resurrection: the freed rows stayed invalid through the swap
    live = {int(v) for v in pair.port._live_vids()}
    assert not (live & freed)
    dt = sorted(set(doomed))
    _, pp = pair.plan(dt, tenant=1)
    assert not pp.hit.any()
    assert all(r is None for r in pp.responses)
    # and the surviving tenant still serves at full recall
    t0 = sorted({f"what dose of drug {i % 6} should the patient take"
                 for i in range(16)})
    _, pp0 = pair.plan(t0)
    assert pp0.hit.all()


# ---------------------------------------------------------------------------
# publish-time threshold recalibration
# ---------------------------------------------------------------------------

def test_policy_table_recalibrate_all_moves_every_tenant():
    tables = []
    for table_t, pol_t in ((JPolicyTable, JTenantPolicy),
                           (PolicyTable, TenantPolicy)):
        table = table_t(pol_t(0.9, 0.02))
        table.set(5, pol_t(0.95, 0.01))
        table.recalibrate_all(0.8)
        assert table.default.threshold == 0.8
        assert table.get(5).threshold == 0.8
        assert table.get(7).threshold == 0.8      # unknown -> default
        # margins rescaled through with_threshold, not carried verbatim
        assert table.default.admission_margin == pytest.approx(
            pol_t(0.9, 0.02).with_threshold(0.8).admission_margin)
        assert table.get(5).admission_margin == pytest.approx(
            pol_t(0.95, 0.01).with_threshold(0.8).admission_margin)
        tables.append(table)
    for t in (5, 7):
        assert dataclasses.asdict(tables[1].get(t)) == \
            dataclasses.asdict(tables[0].get(t))


def test_publish_recalibrates_thresholds_and_resets_scores(enc):
    pair = Pair(enc, recalibrate=True)
    for svc in (pair.ref, pair.port):
        svc.set_tenant_policy(9, threshold=0.95, admission_margin=0.01)
    pair.stream(n=24)
    assert pair.port.feedback._res                 # §9 reservoirs fed
    pair.maintenance()
    rep = pair.maintenance(block=True)
    assert rep.refresh_published
    new_thr = pair.port.policies.get(0).threshold
    lo, hi = pair.port._refresh_policy.recalibrate_bounds
    assert lo <= new_thr <= hi
    assert pair.port.policies.get(9).threshold == new_thr  # every tenant
    st = pair.port.stats_snapshot().refresh
    assert st["recalibrated_threshold"] == pytest.approx(new_thr)
    np.testing.assert_allclose(
        pair.port.telemetry.registry.value(
            "cache_refresh_recalibrated_threshold"), new_thr)
    # old-space score reservoirs dropped; version-free pair texts kept
    assert not pair.port.feedback._res and not pair.ref.feedback._res
    assert len(pair.port.feedback.pairs) > 0
    pair.check_state()


def test_publish_without_recalibrate_keeps_thresholds(enc):
    pair = Pair(enc)                       # recalibrate defaults off
    pair.stream(n=24)
    pair.maintenance()
    assert pair.maintenance(block=True).refresh_published
    assert pair.port.policies.get(0).threshold == 0.9
    assert pair.port.stats_snapshot().refresh["recalibrated_threshold"] \
        is None
    assert pair.port.telemetry.registry.value("cache_embed_version") == 1
    pair.check_state()


def test_rollback_never_recalibrates(enc):
    pair = Pair(enc, recalibrate=True, min_precision=1.01)
    pair.stream(n=24)
    assert pair.port.feedback._res
    pair.maintenance()
    assert pair.maintenance(block=True).refresh_rolled_back
    assert pair.port.policies.get(0).threshold == 0.9   # untouched
    assert pair.port.feedback._res                      # reservoirs survive
    assert pair.port.stats_snapshot().refresh["recalibrated_threshold"] \
        is None
    pair.check_state()


def test_texts_gc_with_responses(enc):
    """Retained query texts are freed with the entry (no host leak)."""
    pair = Pair(enc, min_pairs=10**6)
    pair.stream(n=16, tenant=3, prefix="leaky")
    assert pair.port._texts
    assert pair.port.evict_tenant(3) == pair.ref.evict_tenant(3)
    assert not pair.port._texts and not pair.ref._texts


# ---------------------------------------------------------------------------
# reference behaviour reproduced at a publish: old-space IVF and cold rows
# ---------------------------------------------------------------------------

def test_publish_leaves_ivf_and_cold_tier_in_the_old_space(enc):
    """A publish re-embeds the warm ring's keys but leaves its IVF
    centroids and inverted lists, and the cold tier's int8 rows, as they
    were (old space), on both sides — until the next rebuild for the
    index, for good for the cold rows."""
    # a synthetic backfill larger than the pool: the pool's positives are
    # all exact repeats (no hard pair to learn from), so the candidate
    # moves the keys only through the synthetic paraphrases
    pair = Pair(enc, svc_kw=dict(hot_capacity=16, warm_capacity=32,
                                 n_clusters=4, bucket=16, flush_size=8,
                                 cold_capacity=64), synth_min_pairs=96)
    # distinct word salads: far apart under the untrained encoder, so
    # every one is admitted and the warm ring wraps into the cold tier
    rng = np.random.default_rng(5)
    texts = [" ".join(f"w{j}" for j in rng.integers(0, 5000, 8))
             for _ in range(64)]
    for i in range(0, 64, 8):
        pair.drive(texts[i:i + 8])
    pair.stream(n=24)
    port, ref = pair.port, pair.ref
    assert len(port.cold) == len(ref.cold) > 0
    assert int(port.warm.indexed_total) == int(ref.warm.indexed_total) > 0
    before = dict(cent=port.warm.centroids.clone(),
                  members=port.warm.members.clone(),
                  warm=port.warm.keys.clone(),
                  cold_q=port.cold.keys_q.copy(),
                  jcent=np.asarray(ref.warm.centroids),
                  jmembers=np.asarray(ref.warm.members),
                  jcold_q=np.asarray(ref.cold.keys_q).copy())
    np.testing.assert_allclose(before["cent"].numpy(), before["jcent"],
                               atol=ATOL)
    np.testing.assert_array_equal(before["members"].numpy(),
                                  before["jmembers"])
    assert pair.maintenance().refresh_started
    rep = pair.maintenance(block=True)
    assert rep.refresh_published and not rep.rebuild_published
    pair.check_state()
    v = port.warm.valid
    assert not torch.allclose(port.warm.keys[v], before["warm"][v])
    assert torch.equal(port.warm.centroids, before["cent"])
    assert torch.equal(port.warm.members, before["members"])
    np.testing.assert_array_equal(np.asarray(ref.warm.centroids),
                                  before["jcent"])
    np.testing.assert_array_equal(np.asarray(ref.warm.members),
                                  before["jmembers"])
    np.testing.assert_array_equal(port.cold.keys_q, before["cold_q"])
    np.testing.assert_array_equal(np.asarray(ref.cold.keys_q),
                                  before["jcold_q"])


def test_launcher_serves_with_the_learned_embedder(capsys):
    """``--learned-embedder`` runs the reference's smoke-scale policy:
    the refresh trips inside a 96-request stream and the summary line
    reports it; it excludes ``--ensemble`` as in the reference."""
    from repro_torch.launch import serve
    svc = serve.main(["--device", "cpu", "--cache", "--learned-embedder",
                      "--requests", "96", "--batch", "8",
                      "--max-new-tokens", "2"])
    rf = svc.stats()["backend"]["refresh"]
    assert svc.cache.capabilities().learned_embedder
    assert rf["refreshes_started"] >= 1 and rf["embed_version"] >= 1
    assert rf["refreshes_published"] + rf["refreshes_rolled_back"] \
        == rf["refreshes_started"]
    out = capsys.readouterr().out
    assert f"learned embedder: version {rf['embed_version']} " in out
    with pytest.raises(SystemExit):
        serve.parse_args(["--device", "cpu", "--cache", "--ensemble", "2",
                          "--learned-embedder"])
