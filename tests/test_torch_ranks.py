"""Ranks on the CPU for the port's sharded tests: `spawn` runs a function
on W processes joined by a gloo group, and `one_rank_mesh` gives a test
a mesh of world size 1 in its own process.

The group starts from a ``FileStore`` under the test's ``tmp_path``
(``file://``), so no TCP port is taken and parallel test workers never
collide.  Each rank's function is module-level here, so a child imports
this module (torch and the port only, never JAX): the parent computes
the reference's answers and hands them over as numpy.  A rank that
raises, or that does not report within the timeout, fails the spawn;
the other ranks are then killed (they may be blocked in a collective
with the failed one).
"""
import contextlib
import queue
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 120


def _run(rank, world, store, fn, args, out):
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        out.put((rank, True, fn(rank, *args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(world: int, fn, args, tmp_path, timeout: float = TIMEOUT_S,
          meanwhile=None):
    """``fn(rank, *args)`` on ``world`` gloo ranks; returns the ranks'
    results in rank order.  ``meanwhile()``, if given, runs here while
    the ranks work, and (ranks' results, its result) is returned."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = tmp_path / f"store-{fn.__name__}-{world}"
    procs = [ctx.Process(target=_run, args=(r, world, str(store), fn, args,
                                            out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        mine = meanwhile() if meanwhile is not None else None
        for _ in procs:
            try:
                rank, ok, val = out.get(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                pytest.fail(f"ranks {sorted(set(range(world)) - set(results))}"
                            f" did not report within {timeout} s")
            if not ok:
                pytest.fail(f"rank {rank} failed:\n{val}")
            results[rank] = val
    finally:
        for p in procs:
            p.join(timeout=10)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    ranks = [results[r] for r in range(world)]
    return ranks if meanwhile is None else (ranks, mine)


def _call(fn, args, out):
    try:
        torch.set_num_threads(1)
        out.put((True, fn(*args)))
    except BaseException:
        out.put((False, traceback.format_exc()))


def in_child(fn, args=(), timeout: float = TIMEOUT_S):
    """``fn(*args)`` in one spawned process, which starts whatever
    process group it needs (the dry-run's fake group) away from the test
    worker; returns its result, or fails on its traceback or its
    timeout (and kills it)."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    proc = ctx.Process(target=_call, args=(fn, args, out), daemon=True)
    proc.start()
    try:
        try:
            ok, val = out.get(timeout=timeout)
        except queue.Empty:
            pytest.fail(f"{fn.__name__} did not report within {timeout} s")
        if not ok:
            pytest.fail(f"{fn.__name__} failed:\n{val}")
        return val
    finally:
        proc.join(timeout=10)
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=10)


@contextlib.contextmanager
def one_rank_mesh():
    """A ("data", "model") = (1, 1) CPU mesh over a process group of
    world size 1 that `launch.mesh` starts here and this tears down."""
    from repro_torch.launch.mesh import make_cache_mesh
    assert not dist.is_initialized()
    try:
        yield make_cache_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the helper's own checks
# ---------------------------------------------------------------------------

def _echo_sum(rank, base):
    x = torch.tensor([base + rank])
    dist.all_reduce(x)
    return rank, int(x)


def _fails_on_rank_1(rank):
    if rank == 1:
        raise ValueError("rank 1 breaks")
    dist.barrier()                  # rank 0 waits here for the dead rank


def test_spawn_returns_rank_results_and_reports_a_failed_rank(tmp_path):
    assert spawn(2, _echo_sum, (10,), tmp_path) == [(0, 21), (1, 21)]
    with pytest.raises(pytest.fail.Exception, match="rank 1 breaks"):
        spawn(2, _fails_on_rank_1, (), tmp_path, timeout=60)


def _world_after_group(world):
    from repro_torch.launch.mesh import fake_process_group
    with fake_process_group(world):
        n = dist.get_world_size()
    return n, dist.is_initialized()


def test_in_child_returns_and_reports_a_failure():
    """`in_child` runs a function away from the test worker (here one
    that starts and ends a fake group of 16 ranks) and reports a raise."""
    assert in_child(_world_after_group, (16,)) == (16, False)
    with pytest.raises(pytest.fail.Exception, match="rank 1 breaks"):
        in_child(_fails_on_rank_1, (1,))
    assert not dist.is_initialized()


def test_one_rank_mesh_builds_and_tears_down():
    with one_rank_mesh() as mesh:
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1) and dist.get_world_size() == 1
        x = torch.arange(3)
        parts = [torch.empty_like(x)]
        dist.all_gather(parts, x, group=mesh.get_group("model"))
        np.testing.assert_array_equal(parts[0].numpy(), x.numpy())
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# rank functions of the sharded tests (they import torch and the port only)
# ---------------------------------------------------------------------------

def numpy_of(nt) -> dict:
    """A NamedTuple of tensors (or JAX arrays) as {field: numpy}."""
    return {f: np.asarray(getattr(nt, f).cpu() if torch.is_tensor(
        getattr(nt, f)) else getattr(nt, f)) for f in nt._fields}


def tensors(cls, d: dict):
    """``cls`` rebuilt from {field: numpy} as CPU tensors."""
    return cls(**{f: torch.as_tensor(np.array(d[f])) for f in cls._fields})


def assert_equal(a, b, what: str) -> None:
    """Two NamedTuples of tensors equal bit for bit."""
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.shape == y.shape and x.dtype == y.dtype, (what, f)
        assert torch.equal(x, y), (what, f)


def sharded_tiers_ranks(rank, p):
    """The mesh form against the stacked oracle on this rank: every
    lookup (cascade fused / four-op x fp32 / int8, the ensemble fp32 /
    int8) bit for bit, and the sharded mutations (append, rebuild, the
    ensemble append, tenant eviction, TTL mask and reap) against the
    oracle's slice for this rank.  Returns this rank's lookup results
    and eviction reports as numpy for the parent to hold against the
    reference."""
    from repro_torch.cache_service import tiers
    from repro_torch.launch.mesh import make_cache_mesh
    mesh = make_cache_mesh(2, device="cpu")
    group = mesh.get_group("model")
    hot = tensors(tiers.HotState, p["hot"])
    swarm = tensors(tiers.WarmState, p["swarm"])
    local = tiers.place_warm_sharded(swarm, mesh)
    assert local.keys.shape[0] == 1
    q, qt, thr = (torch.as_tensor(p[k]) for k in ("q", "qt", "thr"))
    kw = dict(k=2, n_probe=2, tail=5)
    out = {}
    for fused, quant in p["configs"]:
        oracle = tiers.cascade_query(hot, swarm, q, qt, thr, fused=fused,
                                     quantized=quant, **kw)
        got = tiers.cascade_query(hot, local, q, qt, thr, fused=fused,
                                  quantized=quant, mesh=mesh, **kw)
        assert_equal(oracle, got, f"cascade fused={fused} int8={quant}")
        out[("cascade", fused, quant)] = numpy_of(got)
    ens = tensors(tiers.EnsembleState, p["ens"])
    ehot = tensors(tiers.HotState, p["ens_hot"])
    eswarm = tensors(tiers.WarmState, p["ens_swarm"])
    qp, w, eqt = (torch.as_tensor(p[k]) for k in ("qp", "w", "eqt"))
    ethr = torch.full((qp.shape[0],), 0.8)
    ekw = dict(k=2, n_probe=2, tail=8)
    for quant in (False, True):
        oracle = tiers.ensemble_cascade_query(ehot, eswarm, ens, qp, w, eqt,
                                              ethr, fused=True,
                                              quantized=quant, **ekw)
        got = tiers.ensemble_cascade_query(
            ehot, tiers.place_warm_sharded(eswarm, mesh),
            tiers.place_ensemble_sharded(ens, mesh), qp, w, eqt, ethr,
            fused=True, quantized=quant, mesh=mesh, **ekw)
        assert_equal(oracle, got, f"ensemble int8={quant}")
        out[("ensemble", quant)] = numpy_of(got)
    # mutations: the mesh form equals this rank's slice of the oracle
    dem = tiers.Demoted(**{f: torch.as_tensor(v)
                           for f, v in p["dem"].items()})
    st_o, ev_o = tiers.warm_append_sharded(swarm, dem)
    st_m, ev_m = tiers.warm_append_sharded(local, dem, mesh)
    assert_equal(tiers.place_warm_sharded(st_o, mesh), st_m, "append")
    assert torch.equal(ev_o, ev_m)
    assert_equal(tiers.place_warm_sharded(
        tiers.warm_rebuild_sharded(st_o, 4, 0), mesh),
        tiers.warm_rebuild_sharded(st_m, 4, 0), "rebuild")
    pk = torch.as_tensor(p["panel_keys"])
    assert_equal(tiers.place_ensemble_sharded(
        tiers.ensemble_warm_append_sharded(ens, eswarm, dem, pk), mesh),
        tiers.ensemble_warm_append_sharded(
            tiers.place_ensemble_sharded(ens, mesh),
            tiers.place_warm_sharded(eswarm, mesh), dem, pk, mesh),
        "ensemble append")
    for name, op, arg in (("evict", tiers.evict_tenant, 1),
                          ("reap", tiers.reap_expired, p["now"])):
        h_o, w_o, hev_o, wev_o = op(hot, swarm, arg)
        h_m, w_m, hev_m, wev_m = op(hot, local, arg, group)
        assert_equal(h_o, h_m, name)
        assert_equal(tiers.place_warm_sharded(w_o, mesh), w_m, name)
        assert torch.equal(wev_o, wev_m) and torch.equal(hev_o, hev_m)
        out[name] = wev_m.numpy()
    _, w_o, n_o = tiers.mask_expired(hot, swarm, p["now"])
    _, w_m, n_m = tiers.mask_expired(hot, local, p["now"], group)
    assert int(n_o) == int(n_m)
    assert_equal(tiers.place_warm_sharded(w_o, mesh), w_m, "mask")
    out["evicted_append"] = ev_m.numpy()
    return out


def distrib_ranks(rank, p):
    """On 4 ranks: `merge_local_topk` over the world (W = 4) and over
    the ``model`` groups of a (2, 2) mesh (W = 2) against
    `merge_stacked_topk` of the same candidates; `query_sharded` on the
    (2, 2) mesh (corpus over ``model``, queries over ``data``) and on a
    (1, 4) mesh; `shard_batch` over the (2, 2) mesh's ``data`` axis.
    Returns the merged and queried results as numpy."""
    from repro_torch.core import distrib
    from repro_torch.core.store import StoreState, query_sharded
    from repro_torch.data.pairs import shard_batch
    from repro_torch.launch.mesh import make_host_mesh
    out = {}
    s, vids, shard = (torch.as_tensor(p[k]) for k in ("s", "vids", "shard"))
    got = distrib.merge_local_topk(dist.group.WORLD, p["k"], s[rank],
                                   vids[rank], shard[rank])
    want = distrib.merge_stacked_topk(p["k"], s, vids, shard)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    out["w4"] = [x.numpy() for x in got]
    mesh = make_host_mesh(2, 2, device="cpu")
    d, m = (mesh.get_local_rank(a) for a in ("data", "model"))
    assert distrib.axis_size(mesh, "model") == 2
    s2, v2 = (torch.as_tensor(p[k])[d] for k in ("s2", "vids2"))
    got = distrib.merge_local_topk(mesh.get_group("model"), p["k"], s2[m],
                                   v2[m])
    want = distrib.merge_stacked_topk(p["k"], s2, v2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    out["w2"] = [x.numpy() for x in got]
    st = StoreState(**{f: torch.as_tensor(v) for f, v in p["store"].items()})
    q = torch.as_tensor(p["q"])
    for name, mm in (("2x2", mesh), ("1x4", make_host_mesh(1, 4,
                                                           device="cpu"))):
        res = query_sharded(st, q, 0.8, 2, mm)
        out[name] = {f: getattr(res, f).numpy() for f in res._fields}
    sb = shard_batch(p["batch"], mesh)
    out["batch"] = {k: (v.placements, v.to_local().numpy(), tuple(v.shape))
                    for k, v in sb.items()}
    out["coord"] = (d, m)
    return out


def _plan_commit(svc, embs, texts, tenant=0):
    """Commit a batch as admitted misses (the reference tests'
    ``commit_insert``)."""
    from repro_torch.cache_service import CachePlan, CacheRequest
    req = CacheRequest.build(np.asarray(embs), tenant)
    plan = CachePlan.for_insert(req, svc.policies.admit_mask(req.tenants,
                                                             None),
                                None, epoch=svc._epoch,
                                embed_version=svc._embed_version)
    return svc.commit(plan, list(texts)).admitted


def _lookup(svc, embs, tenant=0):
    """(hit, responses) of one uncoalesced plan (``plan_lookup``)."""
    from repro_torch.cache_service import CacheRequest
    plan = svc.plan(CacheRequest.build(np.asarray(embs), tenant),
                    coalesce=False)
    return plan.hit.tolist(), list(plan.responses)


def sharded_service_ranks(rank, p):
    """The 2-shard `CacheService` on this rank, on the traces the parent
    also drove through the reference's unsharded service: per-step hits
    and served strings (fp32 and int8 warm), tenant eviction, the TTL
    counters, the double-buffered rebuild with the shadow build held
    mid-stream, and the ensemble.  Returns what the parent compares."""
    import threading
    from repro_torch.cache_service import (
        CacheConfig, CacheRequest, CacheService, EnsembleConfig,
        ShardingConfig, StalenessConfig, TieringConfig,
    )
    from repro_torch.launch.mesh import make_cache_mesh
    mesh = make_cache_mesh(2, device="cpu")

    def svc(threshold=0.9, ensemble=None, staleness=None, **tiering):
        t = dict(hot_capacity=32, warm_capacity=128, n_clusters=8,
                 bucket=32, n_probe=4, flush_size=8, rebuild_every=2)
        t.update(tiering)
        cfg = dict(dim=16, threshold=threshold, tiering=TieringConfig(**t),
                   sharding=ShardingConfig(mesh=mesh))
        if ensemble is not None:
            cfg["ensemble"] = EnsembleConfig(embedders=ensemble)
        if staleness is not None:
            cfg["staleness"] = staleness
        return CacheService(CacheConfig(**cfg), device="cpu")

    out = {}
    for dtype in ("float32", "int8"):
        s = svc(warm_dtype=dtype)
        steps = []
        every = np.concatenate(p["serve"])
        for step, keys in enumerate(p["serve"]):
            _plan_commit(s, keys, [f"x{step}-{i}" for i in range(len(keys))])
            steps.append(_lookup(s, every[p["probe"][step]]))
        snap = s.stats_snapshot()
        out[dtype] = dict(steps=steps, tiers=snap.tiers,
                          traffic=snap.traffic, rebuild=snap.rebuild,
                          sharded=s.capabilities().warm_sharded,
                          local_rows=int(s.warm.valid.sum()))
    s = svc()
    for step, (keys, t) in enumerate(p["tenants"]):
        _plan_commit(s, keys, [f"t{t}-{step}-{i}" for i in range(len(keys))],
                     tenant=t)
    before = len(s.responses)
    n = s.evict_tenant(0)
    gone = [_lookup(s, np.concatenate([k for k, t in p["tenants"] if t == 0]),
                    tenant=0)[0],
            _lookup(s, np.concatenate([k for k, t in p["tenants"] if t == 1]),
                    tenant=1)]
    out["evict"] = dict(n=n, before=before, after=len(s.responses),
                        gone=gone, demotions=s.stats_snapshot().tiers[
                            "demotions"],
                        tenant0_left=bool((s.warm.valid
                                           & (s.warm.tenants == 0)).any()))
    now = [1.7e9]
    s = svc(staleness=StalenessConfig(default_ttl=30.0, clock=lambda: now[0]))
    ttl = []
    for step, keys in enumerate(p["ttl"]):
        plan = s.plan(CacheRequest.build(keys, 0), coalesce=True)
        rc = s.commit(plan, [f"r{step}-{i}" for i in range(len(keys))])
        ttl.append((plan.hit.tolist(), plan.expired_masked, rc.admitted,
                    rc.evicted))
        now[0] += 7.0
        if step % 3 == 2:
            ttl.append(s.maintenance().expired_reaped)
    out["ttl"] = dict(steps=ttl, staleness=s.stats_snapshot().tiers[
        "staleness"], responses=sorted(s.responses.values()))
    # the double-buffered rebuild: a shadow build held open mid-stream
    # serves from the old per-shard indexes, and every shard publishes
    # at the same maintenance tick
    s = svc(background_rebuild=True, rebuild_every=3)
    gate, first = threading.Event(), [True]
    real = s._rebuild

    def gated(warm):
        if first[0]:
            first[0] = False
            assert gate.wait(timeout=60), "gate never opened"
        return real(warm)

    s._rebuild = gated
    k1, k2 = p["swap"]
    _plan_commit(s, k1, [f"r{i}" for i in range(len(k1))])
    s.flush(rebuild=True)
    swap = [s.stats_snapshot().rebuild["in_flight"], _lookup(s, k1)]
    before = int(s.warm.indexed_total)
    _plan_commit(s, k2, [f"s{i}" for i in range(len(k2))])
    s.flush(rebuild=False)
    swap += [_lookup(s, np.concatenate([k1, k2]))[0],
             int(s.warm.indexed_total) == before]
    gate.set()
    swap += [s.maintenance(block=True).rebuild_published,
             int(s.warm.indexed_total) > before,
             _lookup(s, np.concatenate([k1, k2]))[0]]
    out["swap"] = swap
    s = svc(threshold=0.8, ensemble=3, hot_capacity=32, warm_capacity=256,
            n_clusters=4, bucket=64, flush_watermark=0.75)
    ens = []
    for step, panels in enumerate(p["ensemble"]):
        plan = s.plan(CacheRequest.build(panels, 0, texts=[
            f"e{step}-{i}" for i in range(len(panels))]), coalesce=False)
        s.commit(plan, [f"a{step}-{i}" for i in range(len(panels))])
        ens.append((plan.hit.tolist(), list(plan.responses),
                    plan.panel_scores))
    nw = s.warm.keys.shape[1]
    s.publish_panel(2, p["publish"][0], p["publish"][1])
    s.publish_panel(1, p["publish"][0], p["publish"][1][rank:rank + 1])
    out["ensemble"] = dict(steps=ens, version=s._embed_version, nw=nw,
                           shards=s.warm_shards)
    return out
