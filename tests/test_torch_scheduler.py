"""Port parity for the IVF query and the continuous batcher: the same
seeded numpy inputs through the reference (`repro/core/ivf.py`,
`repro/serving/scheduler.py`) and the port on the CPU.

The IVF query runs on one index, the reference's, carried across
(integers exactly, scores ``atol 1e-5``).  The batcher runs the
reference's own ``init_lm`` weights carried into the port's ``LM``
(reduced Phi-3-mini: 2 layers, d_model 128, vocab 512, float32): the
generated token ids of every request equal the reference's, and the
pool's k/v within the decoder tests' float32 tolerance (``atol 2e-4,
rtol 1e-3``), its positions and ``cur_len`` exactly.  That includes the
reference's shared-``cur_len`` decode (the pool decodes every slot at
one position, from 0, whatever the slot's prompt length), which the
port reproduces.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.ivf import build_ivf as jbuild_ivf
from repro.core.ivf import ivf_occupancy as jivf_occupancy
from repro.core.ivf import ivf_query as jivf_query
from repro.models import init_lm, split
from repro.serving.scheduler import ContinuousBatcher as JBatcher
from repro.serving.scheduler import Request as JRequest
from repro_torch.configs import get_config
from repro_torch.core import build_ivf, ivf_occupancy, ivf_query
from repro_torch.core import ivf as port_ivf
from repro_torch.core.store import init_store, insert_batch, query
from repro_torch.models import LM, state_dict_from_reference
from repro_torch.serving import ContinuousBatcher, Request

SCORE_ATOL = 1e-5
TOL = dict(atol=2e-4, rtol=1e-3)


def _unit(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


def _clustered_keys(rng, n_clusters=16, per=32, d=32, spread=0.15):
    cents = _unit(rng.standard_normal((n_clusters, d)).astype(np.float32))
    keys = np.repeat(cents, per, axis=0)
    return _unit(keys + spread * rng.standard_normal(keys.shape
                                                     ).astype(np.float32))


def _port_state(js):
    return port_ivf.IVFState(*[torch.from_numpy(np.array(a)) for a in js])


# ---------------------------------------------------------------------------
# IVF
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,n_probe", [(1, 4), (2, 2), (4, 16), (3, 1)])
def test_ivf_query_matches_reference(k, n_probe):
    rng = np.random.default_rng(21)
    keys = _clustered_keys(rng)
    N = len(keys)
    valid = np.arange(N) % 7 != 3
    js = jbuild_ivf(jnp.asarray(keys), jnp.asarray(valid),
                    jnp.arange(N), n_clusters=16, bucket=24)
    # queries near members, some exact keys (score ties across rows
    # resolve to the lowest index on both sides), some far away
    q = np.concatenate([
        _unit(keys[rng.choice(N, 12)] + 0.01 * rng.standard_normal(
            (12, keys.shape[1])).astype(np.float32)),
        keys[:4], _unit(rng.standard_normal((4, keys.shape[1]))
                        .astype(np.float32))])
    want = jivf_query(js, jnp.asarray(q), threshold=0.9, k=k,
                      n_probe=n_probe)
    got = ivf_query(_port_state(js), torch.from_numpy(q), threshold=0.9,
                    k=k, n_probe=n_probe)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=SCORE_ATOL)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert abs(float(ivf_occupancy(_port_state(js)))
               - float(jivf_occupancy(js))) <= 1e-7


def test_ivf_recall_on_clustered_keys():
    rng = np.random.default_rng(22)
    keys = _clustered_keys(rng)
    N = len(keys)
    state = build_ivf(torch.from_numpy(keys), torch.ones(N, dtype=bool),
                      torch.arange(N), n_clusters=16, bucket=64)
    assert float(ivf_occupancy(state)) > 0.99
    q_idx = rng.choice(N, 32, replace=False)
    q = torch.from_numpy(_unit(keys[q_idx] + 0.01 * rng.standard_normal(
        (32, keys.shape[1])).astype(np.float32)))
    _, _, v, hit = ivf_query(state, q, threshold=0.9, k=1, n_probe=4)
    flat = insert_batch(init_store(N, keys.shape[1]),
                        torch.from_numpy(keys), torch.arange(N))
    res = query(flat, q, threshold=0.9, k=1)
    assert (v[:, 0] == res.value_ids[:, 0]).float().mean() > 0.9


def test_ivf_respects_validity():
    rng = np.random.default_rng(23)
    keys = _clustered_keys(rng, 4, 16)
    N = len(keys)
    state = build_ivf(torch.from_numpy(keys),
                      torch.from_numpy(np.arange(N) % 2 == 0),
                      torch.arange(N), n_clusters=4, bucket=32)
    _, _, v, _ = ivf_query(state, torch.from_numpy(keys[1:2]),
                           threshold=0.999, k=1, n_probe=4)
    assert int(v[0, 0]) != 1          # an invalid row is never returned


# ---------------------------------------------------------------------------
# continuous batcher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def decoder():
    jcfg = jget_config("phi3-mini-3.8b").reduced()
    pcfg = get_config("phi3-mini-3.8b").reduced()
    pv, _ = split(init_lm(jcfg, jax.random.PRNGKey(0)))
    lm = LM(pcfg, device="cpu")
    lm.load_state_dict(state_dict_from_reference(
        jax.tree_util.tree_map(np.asarray, pv), pcfg))
    return jcfg, pv, lm.eval()


def _requests(cls, cfg, n, seed, new=(4, 5, 6), lens=(6,)):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(
                4, cfg.vocab_size, lens[i % len(lens)]).astype(np.int32),
                max_new_tokens=new[i % len(new)]) for i in range(n)]


def _assert_pools_equal(pool, jpool):
    assert pool["cur_len"] == int(jpool["cur_len"])
    for i, st in enumerate(pool["layers"]):
        jst = {n: np.asarray(a[i]) for n, a in jpool["layers"]["pos0"].items()}
        np.testing.assert_array_equal(st["pos"].numpy(), jst["pos"])
        for n in ("k", "v"):
            np.testing.assert_allclose(st[n].numpy(), jst[n], **TOL)


def test_batcher_tokens_match_reference(decoder):
    """Seven requests of several prompt lengths on three slots, so slots
    retire and refill: every request's token ids, the tick count and
    the maintenance accounting equal the reference's, and so does the
    pool after the run."""
    jcfg, pv, lm = decoder
    kw = dict(n_slots=3, max_len=32, prompt_len=8)
    jcalls, calls = [], []
    ref = JBatcher(jcfg, pv, maintenance=lambda: jcalls.append(1),
                   maintenance_max_interval=4, **kw)
    port = ContinuousBatcher(lm, maintenance=lambda: calls.append(1),
                             maintenance_max_interval=4, **kw)
    for r in _requests(JRequest, jcfg, 7, seed=5, lens=(6, 8, 11)):
        ref.submit(r)
    for r in _requests(Request, jcfg, 7, seed=5, lens=(6, 8, 11)):
        port.submit(r)
    want, got = ref.run(max_ticks=200), port.run(max_ticks=200)
    assert sorted(got) == sorted(want) == list(range(7))
    for uid in want:
        assert got[uid].generated == want[uid].generated, uid
    assert port.ticks == ref.ticks
    assert (port.maintenance_runs, port.maintenance_skips) \
        == (ref.maintenance_runs, ref.maintenance_skips)
    assert len(calls) == len(jcalls) > 0
    _assert_pools_equal(port.pool, ref.pool)


def test_shared_cur_len_is_reproduced(decoder):
    """The reference's pool decodes every slot at the pool's ``cur_len``,
    which starts at 0 and which an admission does not set: the first
    tick writes each slot's new K/V over cache slot 0 (RoPE position 0),
    so the prompt's token 0 is overwritten and its tokens 1.. sit in
    the causal future.  The port reproduces it; the pools agree after
    the first tick."""
    jcfg, pv, lm = decoder
    kw = dict(n_slots=2, max_len=16, prompt_len=8)
    ref = JBatcher(jcfg, pv, **kw)
    port = ContinuousBatcher(lm, **kw)
    (jr,), (pr,) = (_requests(JRequest, jcfg, 1, seed=6),
                    _requests(Request, jcfg, 1, seed=6))
    ref.submit(jr)
    port.submit(pr)
    toks = np.full((1, 8), 2, np.int64)
    toks[0, :len(pr.prompt)] = pr.prompt
    _, one = lm.prefill(toks, 16)
    ref.tick()
    port.tick()
    _assert_pools_equal(port.pool, ref.pool)
    assert port.pool["cur_len"] == 1 and one["cur_len"] == 8
    for st, o in zip(port.pool["layers"], one["layers"]):
        assert not torch.equal(st["k"][0, 0], o["k"][0, 0])  # overwritten
        assert torch.equal(st["k"][0, 1:8], o["k"][0, 1:8])
        np.testing.assert_array_equal(st["pos"][0, :8].numpy(),
                                      np.arange(8))


def test_every_pool_row_has_a_valid_slot_after_a_tick(decoder):
    """Unused slots keep ``pos`` -1 (masked) until the first decode
    tick's write at ``cur_len``, which lands in every row: no row the
    decode kernel reads is fully masked."""
    _, _, lm = decoder
    b = ContinuousBatcher(lm, n_slots=4, max_len=16, prompt_len=8)
    b.submit(Request(uid=0, prompt=np.arange(4, 10, dtype=np.int32),
                     max_new_tokens=3))
    b._admit()
    for st in b.pool["layers"]:
        assert (st["pos"][1:] == -1).all()
    b.tick()
    for st in b.pool["layers"]:
        assert ((st["pos"] >= 0).sum(1) >= 1).all()


def test_write_slot_copies_in_place(decoder):
    """An admission copies the B=1 prefill state into the pool's own
    tensors (the pool is never rebound to the slot's), bit for bit."""
    _, _, lm = decoder
    b = ContinuousBatcher(lm, n_slots=3, max_len=16, prompt_len=8)
    ptrs = [t.data_ptr() for st in b.pool["layers"] for t in st.values()]
    toks = np.arange(4, 12, dtype=np.int64)[None]
    _, one = lm.prefill(toks, 16)
    b.pending.append(Request(uid=0, prompt=toks[0], max_new_tokens=2))
    b.slot_req[0] = b.slot_req[1] = Request(uid=9, prompt=toks[0])
    b._admit()                                       # lands in slot 2
    assert [t.data_ptr() for st in b.pool["layers"]
            for t in st.values()] == ptrs
    for st, o in zip(b.pool["layers"], one["layers"]):
        for n in ("k", "v", "pos"):
            assert torch.equal(st[n][2], o[n][0])
    assert b.pool["cur_len"] == 0


def test_batcher_drives_maintenance_on_idle_ticks(decoder):
    _, _, lm = decoder
    calls = []
    b = ContinuousBatcher(lm, n_slots=2, max_len=32, prompt_len=8,
                          maintenance=lambda: calls.append(1))
    b.submit(Request(uid=0, prompt=np.arange(4, 10, dtype=np.int32),
                     max_new_tokens=3))
    b.run(max_ticks=50)
    assert b.ticks > 0 and len(calls) == b.ticks
    assert b.maintenance_runs == len(calls) and b.maintenance_skips == 0


def test_batcher_defers_maintenance_under_backlog(decoder):
    """A saturated pool with requests queued skips the hook, runs it
    once the queue drains, and the starvation bound forces a run every
    ``maintenance_max_interval`` ticks regardless."""
    jcfg, _, lm = decoder
    calls = []
    b = ContinuousBatcher(lm, n_slots=1, max_len=32, prompt_len=8,
                          maintenance=lambda: calls.append(b.ticks))
    for r in _requests(Request, jcfg, 3, seed=7, new=(4,)):
        b.submit(r)
    b.run(max_ticks=60)
    assert b.maintenance_skips > 0 and b.maintenance_runs > 0
    assert b.maintenance_runs + b.maintenance_skips == b.ticks

    calls2 = []
    b2 = ContinuousBatcher(lm, n_slots=1, max_len=64, prompt_len=8,
                           maintenance=lambda: calls2.append(1),
                           maintenance_max_interval=5)
    for r in _requests(Request, jcfg, 8, seed=8, new=(30,)):
        b2.submit(r)
    for _ in range(20):
        b2.tick()
    assert len(b2.pending) > 0
    assert len(calls2) == 20 // 5
    st = b2.stats()
    assert st["ticks"] == 20 and st["queue_depth"] == len(b2.pending)
    assert st["admission_wait_p50_s"] >= 0


def test_continuous_batching_matches_sequential(decoder):
    """A lone request's tokens equal the same request's in a crowded
    pool that starts with it (slot isolation)."""
    jcfg, _, lm = decoder
    prompt = np.random.default_rng(9).integers(
        4, jcfg.vocab_size, 6).astype(np.int32)
    lone = ContinuousBatcher(lm, n_slots=1, max_len=32, prompt_len=8)
    lone.submit(Request(uid=0, prompt=prompt, max_new_tokens=5))
    want = lone.run()[0].generated
    crowd = ContinuousBatcher(lm, n_slots=3, max_len=32, prompt_len=8)
    crowd.submit(Request(uid=0, prompt=prompt, max_new_tokens=5))
    for r in _requests(Request, jcfg, 4, seed=10, new=(5,)):
        r.uid += 1
        crowd.submit(r)
    assert crowd.run()[0].generated == want
