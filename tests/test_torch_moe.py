"""Port parity for the MoE FFN (`models/moe.py`) and the MoE decoder
(``granite-moe-3b-a800m``), on the CPU.

``apply_moe``'s module is held to the reference's on the same weights
and inputs: at ample capacity, with drops forced
(``capacity_factor=0.1``) and with padded dummy experts; the routing
(top-k expert ids, the stable sort, the kept/dropped mask and each
assignment's buffer row) is compared exactly against the reference's
own dispatch arithmetic.  The reference's three MoE unit tests
(`tests/test_models_units.py`) are ported.  A reduced Granite-MoE
``LM`` from carried ``init_lm`` weights (2 layers, d_model 128, 4
experts top-2) is compared on prefill and every decode step's logits,
caches and greedy tokens, and ``forward_lm``'s summed aux loss; a
reduced Phi-3.5-MoE (16 experts top-2 at full width) on the same path.

Tolerances: ``y`` ``atol 1e-5``, aux ``rtol 1e-5``, ids and masks
exact; decoder logits and caches as `tests/test_torch_decoder.py`
(``atol 2e-4, rtol 1e-3`` in float32, ``3e-2`` in bf16), greedy tokens
exact; the bf16 decoder's summed aux ``rtol 1e-3`` (its router reads
bf16 hidden states, which the two frameworks round at different
places).
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import decode_step as jdecode_step
from repro.models import forward_lm as jforward_lm
from repro.models import init_lm, split
from repro.models import moe as jmoe
from repro.models import prefill as jprefill
from repro.models.param import Initializer as JInitializer
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.launch import serve
from repro_torch.models import LM, layers, moe, state_dict_from_reference
from repro_torch.models.param import make_initializer
from repro_torch.serving import ServeEngine

Y_ATOL, AUX_RTOL = 1e-5, 1e-5
AUX_RTOL_BF16 = 1e-3
TOL = {"float32": dict(atol=2e-4, rtol=1e-3),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
PROMPT, CACHE_LEN = 10, 14


def _tiny_cfgs(capacity_factor=8.0, num_experts=4, pad_to=0):
    kw = dict(name="tiny-moe", n_layers=1, d_model=16, n_heads=2,
              n_kv_heads=2, d_ff=32, vocab_size=64, pad_experts_to=pad_to)
    m = dict(num_experts=num_experts, top_k=2, expert_d_ff=32,
             capacity_factor=capacity_factor)
    return (JModelConfig(moe=JMoEConfig(**m), **kw),
            ModelConfig(moe=MoEConfig(**m), **kw))


def _pair(capacity_factor=8.0, num_experts=4, pad_to=0, key=1):
    """The reference's init_moe weights and the port's module holding
    them."""
    jcfg, pcfg = _tiny_cfgs(capacity_factor, num_experts, pad_to)
    pv, _ = split(jmoe.init_moe(JInitializer(jax.random.PRNGKey(key)),
                                jcfg))
    mod = moe.MoE(make_initializer(pcfg, 0, "cpu"), pcfg)
    mod.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in pv.items()})
    return jcfg, pv, mod


def _reference_routing(pv, cfg, x):
    """The reference's dispatch arithmetic (`repro/models/moe.py`
    ``apply_moe``), stopped before the expert products."""
    m = cfg.moe
    T = x.shape[0] * x.shape[1]
    E, K = jmoe.padded_experts(cfg), m.top_k
    C = jmoe.capacity_for(cfg, T)
    xf = jnp.asarray(x).reshape(T, -1)
    logits = xf.astype(jnp.float32) @ pv["router"].astype(jnp.float32)
    if E != m.num_experts:
        col = jax.lax.broadcasted_iota(jnp.int32, logits.shape, 1)
        logits = jnp.where(col < m.num_experts, logits, -1e30)
    probs = jax.nn.softmax(logits, axis=-1)
    _, expert_ids = jax.lax.top_k(probs, K)
    flat_e = expert_ids.reshape(-1)
    sort_idx = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    starts = jnp.searchsorted(sorted_e, jnp.arange(E), side="left")
    pos_in_e = jnp.arange(T * K) - starts[sorted_e]
    keep = pos_in_e < C
    dest = jnp.where(keep, sorted_e * C + pos_in_e, E * C)
    return {k: np.asarray(v) for k, v in dict(
        expert_ids=expert_ids, sort_idx=sort_idx, keep=keep,
        dest=dest).items()}, C


@pytest.mark.parametrize("case", [
    dict(capacity_factor=8.0),                       # ample capacity
    dict(capacity_factor=0.1),                       # forced drops
    dict(capacity_factor=8.0, num_experts=6, pad_to=8),   # padded experts
    dict(capacity_factor=0.1, num_experts=6, pad_to=8),
])
def test_apply_moe_matches_reference(case):
    jcfg, pv, mod = _pair(**case)
    x = np.random.default_rng(3).standard_normal((4, 32, 16)).astype(
        np.float32)
    y_ref, aux_ref = jmoe.apply_moe(pv, jcfg, jnp.asarray(x))
    with torch.no_grad():
        y, aux = mod(torch.as_tensor(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=Y_ATOL)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=AUX_RTOL)
    want, C = _reference_routing(pv, jcfg, x)
    assert C == moe.capacity_for(mod.cfg, 4 * 32)
    assert moe.padded_experts(mod.cfg) == jmoe.padded_experts(jcfg)
    r = mod.route(torch.as_tensor(x).reshape(128, 16), C)
    for k, v in want.items():
        np.testing.assert_array_equal(getattr(r, k).numpy(), v, err_msg=k)
    assert int(mod.dropped) == int((~want["keep"]).sum())
    if case["capacity_factor"] < 1:
        assert int(mod.dropped) > 0
    if case.get("pad_to"):        # no assignment reaches a dummy expert
        assert int(r.expert_ids.max()) < case["num_experts"]


def test_apply_moe_bf16_matches_reference():
    jcfg, pv, mod = _pair()
    x = np.random.default_rng(4).standard_normal((2, 8, 16)).astype(
        np.float32)
    y_ref, aux_ref = jmoe.apply_moe(pv, jcfg,
                                    jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        y, aux = mod(torch.as_tensor(x).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(y_ref, np.float32),
                               **TOL["bfloat16"])
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=AUX_RTOL)


def test_top_k_ties_go_to_the_lowest_expert():
    """Equal router probabilities pick the lowest expert ids first, as
    ``lax.top_k`` does (a zero router makes every expert tie)."""
    jcfg, pv, mod = _pair()
    with torch.no_grad():
        mod.router.zero_()
    r = mod.route(torch.randn(5, 16), 8)
    assert r.expert_ids.tolist() == [[0, 1]] * 5
    _, ids = jax.lax.top_k(jnp.full((5, 4), 0.25), 2)
    np.testing.assert_array_equal(r.expert_ids.numpy(), np.asarray(ids))


# ---------------------------------------------------------------------------
# the reference's MoE unit tests (tests/test_models_units.py), ported
# ---------------------------------------------------------------------------

def test_moe_matches_dense_dispatch_reference():
    """Sort-based capacity dispatch == dense one-hot dispatch when
    capacity is ample."""
    _, _, mod = _pair()
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (2, 8, 16)), dtype=torch.float32)
    with torch.no_grad():
        y, _ = mod(x)
        xf = x.reshape(-1, 16)
        probs = torch.softmax(xf @ mod.router, -1)
        gate, eid = torch.topk(probs, 2)
        gate = gate / gate.sum(-1, keepdim=True)
        g = torch.nn.functional.silu(torch.einsum("td,edf->tef", xf,
                                                  mod.w_gate))
        u = torch.einsum("td,edf->tef", xf, mod.w_up)
        per_expert = torch.einsum("tef,efd->ted", g * u, mod.w_down)
        w = torch.zeros(xf.shape[0], 4).scatter(1, eid, gate)
        y_ref = torch.einsum("te,ted->td", w, per_expert).reshape(x.shape)
    torch.testing.assert_close(y, y_ref, atol=1e-5, rtol=0)


def test_moe_capacity_drops_tokens():
    """With capacity_factor -> tiny, overloaded experts drop tokens (the
    dropped tokens contribute zero, not garbage)."""
    _, _, mod = _pair(capacity_factor=0.1)       # capacity floor = 8
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (4, 32, 16)), dtype=torch.float32)
    with torch.no_grad():
        y, aux = mod(x)
    assert torch.isfinite(y).all()
    assert float(aux) > 0
    assert int(mod.dropped) > 0
    # a token whose every assignment was dropped comes out as zero
    r = mod.route(x.reshape(-1, 16), 8)
    kept = torch.zeros(128 * 2, dtype=torch.bool)
    kept[r.sort_idx] = r.keep
    dead = ~kept.reshape(128, 2).any(1)
    assert dead.any()
    assert torch.equal(y.reshape(128, 16)[dead],
                       torch.zeros(int(dead.sum()), 16))


def test_moe_aux_penalises_imbalance():
    _, _, mod = _pair(key=2)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (2, 16, 16)), dtype=torch.float32)
    with torch.no_grad():
        _, aux_bal = mod(x)
        mod.router[:, 0] += 10.0          # force the router to expert 0
        _, aux_skew = mod(x)
    assert float(aux_skew) > float(aux_bal)


# ---------------------------------------------------------------------------
# the reduced Granite-MoE decoder from carried init_lm weights
# ---------------------------------------------------------------------------

GRANITE = "granite-moe-3b-a800m"
CASES = {"granite-moe": (GRANITE, {}),
         "granite-moe-gqa": (GRANITE, dict(n_kv_heads=2)),
         "granite-moe-bf16": (GRANITE, dict(dtype="bfloat16")),
         "phi3.5-moe": ("phi3.5-moe-42b-a6.6b", {})}


def _models(case, seed=0):
    name, kw = CASES[case]
    jcfg = jget_config(name).reduced(**kw)
    pcfg = get_config(name).reduced(**kw)
    pv, _ = split(init_lm(jcfg, jax.random.PRNGKey(seed)))
    lm = LM(pcfg, device="cpu")
    lm.load_state_dict(state_dict_from_reference(
        jax.tree_util.tree_map(np.asarray, pv), pcfg))
    return jcfg, pv, lm.eval()


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _tokens(cfg, B=2, S=CACHE_LEN, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_granite_moe_config_and_carried_weights():
    """The full config builds MoE blocks (no refusal), the reduced one
    carries every ``ffn`` leaf of ``init_lm``'s tree."""
    cfg = get_config("granite-moe-3b-a800m")
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (24, 8, 64)
    assert cfg.moe.num_experts == 40 and cfg.tie_embeddings
    jcfg, pv, lm = _models("granite-moe")
    sd = lm.state_dict()
    for i, blk in enumerate(lm.layers):
        assert isinstance(blk.moe, moe.MoE)
        for leaf in ("router", "w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(
                sd[f"layers.{i}.moe.{leaf}"].numpy(),
                np.asarray(pv["layers"]["pos0"]["ffn"][leaf][i]))
    assert sum(p.numel() for p in lm.parameters()) == sum(
        np.asarray(a).size for a in jax.tree_util.tree_leaves(pv))


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_reference(case):
    jcfg, pv, lm = _models(case)
    tol = TOL[jcfg.dtype]
    toks = _tokens(jcfg)
    jl, js = jax.jit(jprefill, static_argnums=(1, 3))(
        pv, jcfg, toks[:, :PROMPT], CACHE_LEN)
    pl, ps = lm.prefill(torch.as_tensor(toks[:, :PROMPT]), CACHE_LEN)
    np.testing.assert_allclose(_np(pl), _np(jl), **tol)
    step = jax.jit(jdecode_step, static_argnums=1)
    for t in range(PROMPT, CACHE_LEN):
        jl, js = step(pv, jcfg, js, toks[:, t:t + 1])
        pl, ps = lm.decode_step(ps, torch.as_tensor(toks[:, t:t + 1]))
        np.testing.assert_allclose(_np(pl), _np(jl), **tol)
        if jcfg.dtype == "float32":
            np.testing.assert_array_equal(pl.argmax(-1).numpy(),
                                          np.asarray(jl).argmax(-1))
        assert ps["cur_len"] == int(js["cur_len"]) == t + 1
        for i, st in enumerate(ps["layers"]):
            jst = {n: np.asarray(a[i]) for n, a in
                   js["layers"]["pos0"].items()}
            np.testing.assert_array_equal(st["pos"].numpy(), jst["pos"])
            for n in ("k", "v"):
                np.testing.assert_allclose(_np(st[n]), _np(jst[n]), **tol)


def _near_tie_shifts(cfg, router_logits):
    """The load-balance loss's change were each of the port's near-tie
    top-1 router choices flipped to the runner-up: a token whose two
    largest router logits lie within one bf16 ulp of the larger.  The loss
    (``E coef sum_e f_e p_e``, f_e the share of tokens whose first choice
    is e) then moves by ``E coef (p_b - p_a) / T``."""
    m = cfg.moe
    out = []
    for lg in router_logits:
        top, ids = lg.topk(2, dim=-1)
        p = torch.softmax(lg, dim=-1).mean(0)
        ulp = torch.finfo(torch.bfloat16).eps * top[:, 0].abs()
        for t in ((top[:, 0] - top[:, 1]) <= ulp).nonzero()[:, 0].tolist():
            a, b = ids[t].tolist()
            out.append(m.num_experts * m.load_balance_coef
                       * float(p[b] - p[a]) / lg.shape[0])
    return out


@pytest.mark.parametrize("case", ["granite-moe", "granite-moe-bf16"])
def test_forward_lm_sums_the_aux_losses(case):
    """The reference compiled, as it serves, and in bf16 also op by op.
    Compiled, XLA may keep a bf16 product in float32 (q times its bf16
    scale, here), and where two router logits lie within one bf16 ulp that
    can flip a top-1 choice and the aux loss with it: the compiled bf16 aux
    must equal the port's once some of the port's near-tie choices are
    flipped (at most two), op by op it must equal the port's as is."""
    jcfg, pv, lm = _models(case)
    toks = _tokens(jcfg)
    router = []
    hooks = [blk.moe.register_forward_hook(
        lambda mod, args, _: router.append(
            args[0].reshape(-1, args[0].shape[-1]).float()
            @ mod.router.float())) for blk in lm.layers]
    with torch.no_grad():
        pl, aux = lm.forward_lm(torch.as_tensor(toks))
    for h in hooks:
        h.remove()
    assert aux.dtype == torch.float32 and float(aux) > 0
    bf16 = jcfg.dtype == "bfloat16"
    rtol = AUX_RTOL_BF16 if bf16 else AUX_RTOL
    jl, jaux = jforward_lm(pv, jcfg, toks)
    np.testing.assert_allclose(_np(pl), _np(jl), **TOL[jcfg.dtype])
    shifts = _near_tie_shifts(lm.cfg, router) if bf16 else []
    assert len(shifts) <= 2, shifts
    flipped = [float(aux) + sum(c) for n in range(len(shifts) + 1)
               for c in itertools.combinations(shifts, n)]
    assert any(abs(f - float(jaux)) <= rtol * abs(float(jaux))
               for f in flipped), (float(jaux), flipped)
    if bf16:
        with jax.disable_jit():
            jl, jaux = jforward_lm(pv, jcfg, toks)
        np.testing.assert_allclose(_np(pl), _np(jl), **TOL[jcfg.dtype])
        np.testing.assert_allclose(float(aux), float(jaux), rtol=rtol)
    # the sum is over every layer's aux
    with torch.no_grad():
        h = lm.embed(torch.as_tensor(toks))
        sin, cos = layers.rope_frequencies(lm.cfg,
                                           torch.arange(toks.shape[1]))
        total = 0.0
        for blk in lm.layers:
            h, a = blk(h, sin, cos)
            total += float(a)
    np.testing.assert_allclose(float(aux), total, rtol=AUX_RTOL)


def test_decode_matches_forward_lm_without_drops():
    """The reduced config's capacity factor 4.0 drops nothing, so decode
    gives the full forward's logits at every position (the reference's
    own decode-versus-forward check); a step's drop count reads 0."""
    _, _, lm = _models("granite-moe")
    toks = torch.as_tensor(_tokens(lm.cfg))
    with torch.no_grad():
        full, _ = lm.forward_lm(toks)
        assert all(int(b.moe.dropped) == 0 for b in lm.layers)
        logits, state = lm.prefill(toks[:, :PROMPT], CACHE_LEN)
        torch.testing.assert_close(logits, full[:, PROMPT - 1],
                                   **TOL["float32"])
        for t in range(PROMPT, CACHE_LEN):
            logits, state = lm.decode_step(state, toks[:, t:t + 1])
            torch.testing.assert_close(logits, full[:, t],
                                       **TOL["float32"])
            assert all(int(b.moe.dropped) == 0 for b in lm.layers)


def test_engine_greedy_tokens_match_reference():
    jcfg, pv, lm = _models("granite-moe")
    prompts = _tokens(jcfg, B=3, S=9, seed=2)
    want = JServeEngine(jcfg, pv, max_len=24).generate(prompts, 8)
    got = ServeEngine(lm, max_len=24).generate(prompts, 8)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_launcher_serves_granite_moe_on_the_cpu():
    svc = serve.main(["--device", "cpu", "--arch", "granite-moe-3b-a800m",
                      "--cache", "--requests", "16", "--batch", "8",
                      "--max-new-tokens", "2"])
    st = svc.stats()
    assert st["requests"] == 16 and st["generations"] >= 1
    assert dataclasses.is_dataclass(svc.engine.model.cfg.moe)


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "musicgen-large"])
def test_mixers_still_to_port_are_refused(name):
    """Nothing is refused any more: every mixer is ported, and
    ``attn_f32=False`` on a decoder (bf16 attention weights and sums on
    the full-sequence paths; decode stays float32, as the reference's
    ``apply_decode``) builds and serves.  Prefill and one decode step's
    logits from carried weights within the float32 tolerance of the
    reference's at ``attn_f32=False``."""
    jcfg = jget_config(name).reduced(attn_f32=False)
    pcfg = get_config(name).reduced(attn_f32=False)
    pv, _ = split(init_lm(jcfg, jax.random.PRNGKey(0)))
    lm = LM(pcfg, device="cpu")
    lm.load_state_dict(state_dict_from_reference(
        jax.tree_util.tree_map(np.asarray, pv), pcfg))
    toks = _tokens(jcfg, S=5)
    want, jstate = jprefill(pv, jcfg, jnp.asarray(toks[:, :4]), 8)
    with torch.no_grad():
        got, state = lm.prefill(toks[:, :4], 8)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[jcfg.dtype])
    want, _ = jdecode_step(pv, jcfg, jstate, jnp.asarray(toks[:, 4:]))
    with torch.no_grad():
        got, _ = lm.decode_step(state, torch.from_numpy(toks[:, 4:]))
    np.testing.assert_allclose(_np(got), _np(want), **TOL[jcfg.dtype])
