"""Port parity for the sharded `CacheService` (DESIGN.md §8) and its
launcher surface, on the CPU.

A 2-shard service on 2 gloo ranks is driven over traces the reference's
unsharded service serves in this process (`tests/test_sharded_cascade.py`'s
insert-and-look-up stream, fp32 and int8 warm; its tenant eviction; a
TTL stream; its mid-stream publish swap; the ensemble stream of
`tests/test_ensemble_cascade.py`): hits and served strings per step
equal the reference's, as do the traffic, demotion, eviction and TTL
counters (every lookup repeats an inserted key, so full recall hides the
per-shard clustering).  A one-rank mesh runs in this process: it serves
as the unsharded port does, and a cold tier beside it is refused as in
the reference.  Tolerances: panel scores ``atol 1e-5``; everything else
exactly.
"""
import numpy as np
import pytest
import torch

from repro.cache_service import CacheConfig as JCacheConfig
from repro.cache_service import CacheRequest as JCacheRequest
from repro.cache_service import CacheService as JCacheService
from repro.cache_service import EnsembleConfig as JEnsembleConfig
from repro.cache_service import StalenessConfig as JStalenessConfig
from repro.cache_service import TieringConfig as JTieringConfig
from repro_torch.cache_service import (
    CacheConfig, CacheService, ShardingConfig, TieringConfig,
)
from test_torch_ranks import (
    _lookup, _plan_commit, one_rank_mesh, sharded_service_ranks, spawn,
)

D = 16
TIERING = dict(hot_capacity=32, warm_capacity=128, n_clusters=8, bucket=32,
               n_probe=4, flush_size=8, rebuild_every=2)


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _ref(threshold=0.9, ensemble=None, staleness=None, **tiering):
    t = dict(TIERING)
    t.update(tiering)
    cfg = dict(dim=D, threshold=threshold, tiering=JTieringConfig(**t))
    if ensemble is not None:
        cfg["ensemble"] = JEnsembleConfig(embedders=ensemble)
    if staleness is not None:
        cfg["staleness"] = staleness
    return JCacheService(JCacheConfig(**cfg))


def _ref_commit(svc, embs, texts, tenant=0):
    from repro.cache_service import CachePlan
    req = JCacheRequest.build(np.asarray(embs), tenant)
    plan = CachePlan.for_insert(req, svc.policies.admit_mask(req.tenants,
                                                             None),
                                None, epoch=svc._epoch,
                                embed_version=svc._embed_version)
    return svc.commit(plan, list(texts)).admitted


def _ref_lookup(svc, embs, tenant=0):
    plan = svc.plan(JCacheRequest.build(np.asarray(embs), tenant),
                    coalesce=False)
    return plan.hit.tolist(), list(plan.responses)


def _panels(rng, n, noise=(0.9, 0.05, 0.9)):
    z = _unit(rng.normal(size=(n, D)))
    return np.stack([_unit(z + s * rng.normal(size=(n, D))) for s in noise],
                    1)


def _traces(rng):
    serve = [_unit(rng.standard_normal((8, D))) for _ in range(12)]
    # each step looks up 48 of the keys inserted so far (one batch shape)
    probe = [rng.integers(0, 8 * (step + 1), 48) for step in range(12)]
    tenants = [(_unit(rng.standard_normal((8, D))), step % 2)
               for step in range(12)]
    pool = _unit(rng.standard_normal((24, D)))
    ttl = [pool[rng.integers(0, 24, 8)] for _ in range(10)]
    swap = [_unit(rng.standard_normal((16, D))),
            _unit(rng.standard_normal((8, D)))]
    epool = _panels(rng, 40)
    ensemble = [epool[rng.integers(0, 40, 8)] for _ in range(14)]
    return dict(serve=serve, probe=probe, tenants=tenants, ttl=ttl,
                swap=swap, ensemble=ensemble)


def test_sharded_service_serves_as_the_reference_unsharded(tmp_path):
    """Two shards on two ranks: the same insert and look-up stream gives
    the reference's hits and strings at every step (fp32 and int8), the
    same tenant eviction, the same TTL masks, reaps and admissions, the
    same ensemble hits, answers and panel scores; a shadow build held
    open mid-stream serves every key and both shards publish at one
    tick."""
    rng = np.random.default_rng(3)
    p = _traces(rng)
    p["publish"] = (_unit(rng.normal(size=(32, D))),
                    _unit(rng.normal(size=(2, 128, D))))
    ranks, ref = spawn(2, sharded_service_ranks, (p,), tmp_path,
                       meanwhile=lambda: _reference_runs(p))
    for dtype in ("float32", "int8"):
        steps, snap = ref[dtype]
        assert snap.traffic["warm_hits"] > 0
        for r in ranks:
            got = r[dtype]
            assert got["sharded"] and got["tiers"]["warm_shards"] == 2
            assert got["steps"] == steps, dtype
            for key in ("hot_hits", "warm_hits", "plans", "lookup_rows"):
                assert got["traffic"][key] == snap.traffic[key], key
            for key in ("demotions", "evictions", "live_responses",
                        "warm_occupancy", "hot_occupancy"):
                assert got["tiers"][key] == snap.tiers[key], key
        # each rank holds its own shard: the rows split between them
        assert sum(r[dtype]["local_rows"] for r in ranks) \
            == round(snap.tiers["warm_occupancy"] * 128)
        assert all(r[dtype]["local_rows"] > 0 for r in ranks)

    n, before, after = ref["evict"]
    for r in ranks:
        ev = r["evict"]
        assert (ev["n"], ev["before"], ev["after"]) == (n, before, after)
        assert n > 0 and ev["demotions"] > 0 and not ev["tenant0_left"]
        assert not any(ev["gone"][0])
        hit, vals = ev["gone"][1]
        assert all(hit) and all(v is not None for v in vals)

    ttl, stl, responses = ref["ttl"]
    assert stl["expired_masked"] > 0 and stl["expired_reaped"] > 0
    for r in ranks:
        assert r["ttl"]["steps"] == ttl
        assert r["ttl"]["staleness"] == stl
        assert r["ttl"]["responses"] == responses

    for r in ranks:
        in_flight, (hit1, vals1), hit2, held, published, advanced, hit3 = \
            r["swap"]
        assert in_flight and all(hit1) and all(v is not None for v in vals1)
        assert all(hit2) and held            # nothing published yet
        assert published and advanced and all(hit3)

    plans, demotions = ref["ensemble"]
    assert sum(sum(hit) for hit, _, _ in plans) > 0 and demotions > 0
    for r in ranks:
        for (hit, responses, ps), (rhit, rresp, rps) in zip(
                r["ensemble"]["steps"], plans):
            assert hit == rhit and responses == rresp
            np.testing.assert_allclose(ps, rps, rtol=0, atol=1e-5)
        ens = r["ensemble"]
        assert (ens["version"], ens["nw"], ens["shards"]) == (2, 128, 2)


def _reference_runs(p) -> dict:
    """The reference's unsharded service over the same streams."""
    out = {}
    for dtype in ("float32", "int8"):
        ref = _ref(warm_dtype=dtype)
        steps, every = [], np.concatenate(p["serve"])
        for step, keys in enumerate(p["serve"]):
            _ref_commit(ref, keys, [f"x{step}-{i}" for i in range(8)])
            steps.append(_ref_lookup(ref, every[p["probe"][step]]))
        out[dtype] = (steps, ref.stats_snapshot())
    ref = _ref()
    for step, (keys, t) in enumerate(p["tenants"]):
        _ref_commit(ref, keys, [f"t{t}-{step}-{i}" for i in range(8)],
                    tenant=t)
    before = len(ref.responses)
    out["evict"] = (ref.evict_tenant(0), before, len(ref.responses))
    now = [1.7e9]
    ref = _ref(staleness=JStalenessConfig(default_ttl=30.0,
                                          clock=lambda: now[0]))
    ttl = []
    for step, keys in enumerate(p["ttl"]):
        plan = ref.plan(JCacheRequest.build(keys, 0), coalesce=True)
        rc = ref.commit(plan, [f"r{step}-{i}" for i in range(8)])
        ttl.append((plan.hit.tolist(), plan.expired_masked, rc.admitted,
                    rc.evicted))
        now[0] += 7.0
        if step % 3 == 2:
            ttl.append(ref.maintenance().expired_reaped)
    out["ttl"] = (ttl, ref.stats_snapshot().tiers["staleness"],
                  sorted(ref.responses.values()))
    ref = _ref(threshold=0.8, ensemble=3, hot_capacity=32,
               warm_capacity=256, n_clusters=4, bucket=64,
               flush_watermark=0.75)
    plans = []
    for step, panels in enumerate(p["ensemble"]):
        plan = ref.plan(JCacheRequest.build(panels, 0, texts=[
            f"e{step}-{i}" for i in range(8)]), coalesce=False)
        ref.commit(plan, [f"a{step}-{i}" for i in range(8)])
        plans.append((plan.hit.tolist(), list(plan.responses),
                      plan.panel_scores))
    out["ensemble"] = (plans, ref.stats_snapshot().tiers["demotions"])
    return out

def test_one_rank_mesh_serves_as_unsharded_and_refuses_cold():
    """A mesh of one rank is the sharded code path with S = 1: it serves
    the stream exactly as the unsharded port does.  A cold tier beside a
    sharded warm tier is refused, as in the reference
    (`tests/test_cold_tier.py::test_sharded_plus_cold_rejected`)."""
    import jax
    rng = np.random.default_rng(4)
    serve = [_unit(rng.standard_normal((8, D))) for _ in range(10)]
    from repro.cache_service import ShardingConfig as JShardingConfig
    with pytest.raises(ValueError, match="unsharded"):
        JCacheService(JCacheConfig(
            dim=8, tiering=JTieringConfig(cold_capacity=64),
            sharding=JShardingConfig(mesh=jax.sharding.Mesh(
                np.array(jax.devices()[:1]), ("model",)))))
    with one_rank_mesh() as mesh:
        with pytest.raises(ValueError, match="unsharded"):
            CacheService(CacheConfig(
                dim=8, sharding=ShardingConfig(mesh=mesh),
                tiering=TieringConfig(cold_capacity=64)), device="cpu")
        a = CacheService(CacheConfig(dim=D, threshold=0.9,
                                     tiering=TieringConfig(**TIERING)),
                         device="cpu")
        b = CacheService(CacheConfig(dim=D, threshold=0.9,
                                     tiering=TieringConfig(**TIERING),
                                     sharding=ShardingConfig(mesh=mesh)),
                         device="cpu")
        assert b.capabilities().warm_sharded and b.warm.keys.ndim == 3
        for step, keys in enumerate(serve):
            for svc in (a, b):
                _plan_commit(svc, keys, [f"x{step}-{i}" for i in range(8)])
            assert _lookup(a, np.concatenate(serve[:step + 1])) \
                == _lookup(b, np.concatenate(serve[:step + 1]))
        sa, sb = a.stats_snapshot(), b.stats_snapshot()
        assert sa.traffic == sb.traffic and sb.traffic["warm_hits"] > 0
        assert {k: v for k, v in sa.tiers.items() if k != "warm_shards"} \
            == {k: v for k, v in sb.tiers.items() if k != "warm_shards"}
        assert sb.tiers["warm_shards"] == 1
        torch.testing.assert_close(b.warm.keys[0], a.warm.keys, rtol=0,
                                   atol=0)


def test_launcher_cache_shards(capsys):
    """``--cache-shards N`` is accepted and implies the tiered cache; with
    one process the mesh has one rank, and the banner says so; beside
    ``--cold-capacity`` it is refused, as in the reference."""
    from repro_torch.launch import serve
    from repro_torch.obs import Telemetry
    args = serve.parse_args(["--device", "cpu", "--cache",
                             "--cache-shards", "2"])
    assert args.tiered and args.cache_shards == 2
    with pytest.raises(SystemExit):
        serve.parse_args(["--cache", "--cache-shards", "2",
                          "--cold-capacity", "64"])
    assert "unsharded warm ring" in capsys.readouterr().err
    with one_rank_mesh() as mesh:
        cache = serve.make_cache(args, D, Telemetry(), mesh=mesh)
        assert cache.warm_shards == 1 and cache.capabilities().warm_sharded
    assert "tiered cache: warm shards 1, warm dtype float32" \
        in capsys.readouterr().out
