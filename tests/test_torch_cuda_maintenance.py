"""The maintenance loop on the card: what only a CUDA run can show.

Only torch and the port are imported, so ``PYTHONPATH=src python -m
pytest -q --noconftest tests/test_torch_cuda_maintenance.py`` runs on
the card's machine; elsewhere every case skips.

* the double-buffered rebuild: the shadow thread's kernels queue on the
  device's default stream behind the lookups issued before it, while
  serving keeps appending; the published index equals an inline
  ``warm_rebuild`` of the same snapshot (lists and sizes exactly,
  centroids ``atol 1e-5``), the snapshot is unchanged bit for bit, and
  an exception on the thread ends in ``RuntimeError`` at the publish;
* the cold tier's device re-score against its CPU run on the same
  inputs (ids exactly, scores ``atol 1e-5``), and a cold service on the
  card against the same service on the CPU, fused int8;
* the batcher: an admission's copy into the pool's tensors on the card,
  bit for bit, with the pool's storage never rebound.
"""
import numpy as np
import pytest
import torch

from repro_torch.cache_service import (
    CacheConfig, CacheRequest, CacheService, tiers,
)
from repro_torch.cache_service.cold import ColdTier
from repro_torch.cache_service.policy import ColdRoutingPolicy
from repro_torch.configs import get_config
from repro_torch.models import LM
from repro_torch.serving import ContinuousBatcher, Request
from repro_torch.serving import scheduler

SCORE_ATOL = 1e-5
D = 64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run on the H100)")
    return torch.device("cuda")


def _unit(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


def _keys(rng, n, d=D):
    return _unit(rng.standard_normal((n, d)).astype(np.float32))


def _fill(svc, keys, tenant=0):
    for lo in range(0, len(keys), 16):
        plan = svc.plan(CacheRequest.build(keys[lo:lo + 16], tenant))
        svc.commit(plan, [f"r{lo + i}" for i in range(len(plan.hit))])


@pytest.mark.cuda
def test_shadow_rebuild_on_the_card_equals_inline(dev):
    svc = CacheService(CacheConfig.from_kwargs(
        D, hot_capacity=64, warm_capacity=1024, n_clusters=8, bucket=256,
        flush_size=16, rebuild_every=4, threshold=0.9, fused=True,
        background_rebuild=True), device=dev)
    seen = []
    real = svc._rebuild

    def capture(warm):
        snap = [t.clone() for t in warm]
        out = real(warm)
        seen.append((warm, snap, out))
        return out

    svc._rebuild = capture
    rng = np.random.default_rng(0)
    keys = _keys(rng, 640)
    _fill(svc, keys)
    svc.maintenance(block=True)
    assert svc.stats_snapshot().rebuild["shadow_started"] >= 2
    for warm, snap, out in seen:
        for name, a, b in zip(warm._fields, warm, snap):
            assert torch.equal(a, b), name
        inline = tiers.warm_rebuild(warm, svc._kmeans_iters, svc._seed)
        for name in ("members", "sizes", "indexed_total"):
            assert torch.equal(getattr(out, name), getattr(inline, name))
        torch.testing.assert_close(out.centroids, inline.centroids,
                                   atol=SCORE_ATOL, rtol=0)
    live = svc._live_vids()
    assert len(live) == len(svc.responses)
    plan = svc.plan(CacheRequest.build(keys[-200:], 0), coalesce=False)
    assert plan.hit.all()


@pytest.mark.cuda
def test_shadow_failure_on_the_card_is_raised(dev):
    svc = CacheService(CacheConfig.from_kwargs(
        D, hot_capacity=64, warm_capacity=1024, n_clusters=8, bucket=256,
        flush_size=16, rebuild_every=4, threshold=0.9,
        background_rebuild=True), device=dev)

    def broken(warm):
        raise RuntimeError("device fault")

    svc._rebuild = broken
    _fill(svc, _keys(np.random.default_rng(1), 64))
    svc.flush(rebuild=True)
    with pytest.raises(RuntimeError, match="background IVF rebuild failed"):
        svc.maintenance(block=True)


@pytest.mark.cuda
def test_cold_rescore_on_the_card_equals_the_cpu(dev):
    rng = np.random.default_rng(2)
    n = 4096
    keys = _keys(rng, n)
    pol = ColdRoutingPolicy(min_rows_for_routing=64, n_clusters=16,
                            router_margin=2.0)
    tiers_ = [ColdTier(n, D, policy=pol, device=d) for d in ("cpu", dev)]
    for t in tiers_:
        t.bulk_load(keys, np.arange(n), (np.arange(n) % 2).astype(np.int32))
    q = _unit(keys[rng.choice(n, 64)]
              + 0.05 * rng.standard_normal((64, D)).astype(np.float32))
    qt = rng.integers(0, 2, 64).astype(np.int32)
    a, b = (t.lookup(q, qt, np.full(64, 0.95, np.float32),
                     np.ones(64, bool)) for t in tiers_)
    np.testing.assert_array_equal(b.value_ids, a.value_ids)
    np.testing.assert_array_equal(b.consulted, a.consulted)
    np.testing.assert_allclose(b.scores, a.scores, atol=SCORE_ATOL)
    assert a.consulted.any() and tiers_[1].stats() == tiers_[0].stats()


@pytest.mark.cuda
def test_cold_service_on_the_card_equals_the_cpu(dev):
    rng = np.random.default_rng(3)
    pool = _keys(rng, 600)
    kw = dict(hot_capacity=32, warm_capacity=128, n_clusters=8, bucket=64,
              flush_size=16, threshold=0.9, cold_capacity=1024, fused=True,
              warm_dtype="int8", cold_policy=ColdRoutingPolicy(
                  min_rows_for_routing=64, n_clusters=8, router_margin=2.0))
    svcs = [CacheService(CacheConfig.from_kwargs(D, **kw), device=d)
            for d in ("cpu", dev)]
    for step in range(40):
        ids = np.where(rng.random(16) < 0.5,
                       rng.integers(0, min(16 * step + 16, len(pool)), 16),
                       np.arange(16 * step, 16 * step + 16) % len(pool))
        e = _unit(pool[ids] + 0.01 * rng.standard_normal((16, D))
                  ).astype(np.float32)
        plans = [s.plan(CacheRequest.build(e, step % 2)) for s in svcs]
        for name in ("hit", "value_ids", "admit"):
            np.testing.assert_array_equal(getattr(plans[1], name),
                                          getattr(plans[0], name))
        for s, p in zip(svcs, plans):
            s.commit(p, [f"s{step}-{i}" for i in range(16)])
            if step % 4 == 3:
                s.maintenance()
    a, b = (s.stats_snapshot() for s in svcs)
    assert a.traffic == b.traffic and a.tiers["cold"] == b.tiers["cold"]
    assert b.traffic["cold_hits"] > 0


@pytest.mark.cuda
def test_batcher_pool_copy_on_the_card(dev):
    lm = LM(get_config("phi3-mini-3.8b").reduced(), device=dev).eval()
    b = ContinuousBatcher(lm, n_slots=4, max_len=64, prompt_len=8)
    ptrs = [t.data_ptr() for st in b.pool["layers"] for t in st.values()]
    checked = []
    real = scheduler._write_slot

    def check(pool, one, slot):
        real(pool, one, slot)
        for st, o in zip(pool["layers"], one["layers"]):
            for name in ("k", "v", "pos"):
                assert torch.equal(st[name][slot], o[name][0])
        checked.append(slot)

    scheduler._write_slot = check
    try:
        rng = np.random.default_rng(4)
        for i in range(7):
            b.submit(Request(uid=i, prompt=rng.integers(
                4, lm.cfg.vocab_size, 6).astype(np.int32),
                max_new_tokens=3 + i % 3))
        done = b.run(max_ticks=100)
    finally:
        scheduler._write_slot = real
    assert sorted(done) == list(range(7)) and len(checked) == 7
    assert [t.data_ptr() for st in b.pool["layers"]
            for t in st.values()] == ptrs
