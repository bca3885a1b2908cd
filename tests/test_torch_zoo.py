"""Port parity for the rest of the decoder zoo on the CPU: Jamba (Mamba +
attention without RoPE + MoE), xLSTM-125M (mLSTM / sLSTM, no FFN, tied
embeddings), MusicGen-large (audio frontend, sinusoidal positions) and
Pixtral-12B (vision frontend, explicit head width), through ``LM``,
``ServeEngine``, ``ContinuousBatcher`` and the launcher.

The reference's ``init_lm`` weights are carried across at reduced size
(``cfg.reduced()``: d 128, 4 heads, vocab 512, 8 frontend frames).
Jamba's reduced period keeps an attention layer: its positions 1–4
(Mamba + MoE, Mamba + dense, Mamba + MoE, attention + dense), where
``reduced()`` alone would keep four Mamba layers.  The frontend stub's
draw comes from ``jax.random`` on the reference's side, whose bits the
port cannot reproduce, so the reference's draw is passed across as
numpy (into ``ServeEngine`` through its module's ``stub_frontend_embeds``).

Tolerances: logits and states ``atol 2e-4, rtol 1e-3`` (float32, as
`tests/test_torch_decoder.py` and the reference's decode-versus-forward
test); tokens, slot positions and ``cur_len`` exactly.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ASSIGNED_ARCHS
from repro.models import decode_step as jdecode_step
from repro.models import forward_lm as jforward_lm
from repro.models import init_lm, init_lm_state, split
from repro.models import prefill as jprefill
from repro.models.layers import sinusoidal_positions as jsinusoidal
from repro.serving import ServeEngine as JServeEngine
from repro.serving import scheduler as jscheduler
from repro.serving.frontend import stub_frontend_embeds as jstub
from repro.serving.scheduler import ContinuousBatcher as JBatcher
from repro.serving.scheduler import Request as JRequest
from repro_torch.configs import get_config
from repro_torch.configs.base import ATTN
from repro_torch.launch import serve
from repro_torch.models import LM, layers, state_dict_from_reference
from repro_torch.serving import ContinuousBatcher, Request, ServeEngine
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import frontend, scheduler
from torch_decode_gap import decode_gaps

TOL = dict(atol=2e-4, rtol=1e-3)
PROMPT, CACHE_LEN = 10, 14
JAMBA = "jamba-1.5-large-398b"
CASES = {"jamba": JAMBA, "xlstm": "xlstm-125m", "musicgen": "musicgen-large",
         "pixtral": "pixtral-12b"}


def _reduced(get, name, **kw):
    cfg = get(name)
    if name == JAMBA:     # keep the attention layer (period position 4)
        kw = dict(period=cfg.period[1:5], n_layers=4, **kw)
    return cfg.reduced(**kw)


def _models(case, **kw):
    name = CASES[case]
    jcfg, pcfg = _reduced(jget_config, name, **kw), \
        _reduced(get_config, name, **kw)
    pv, _ = split(init_lm(jcfg, jax.random.PRNGKey(0)))
    lm = LM(pcfg, device="cpu")
    lm.load_state_dict(state_dict_from_reference(
        jax.tree_util.tree_map(np.asarray, pv), pcfg))
    return jcfg, pv, lm.eval()


def _tokens(cfg, B=2, S=CACHE_LEN, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _frontend(jcfg, B=2, seed=0):
    """The reference's stub draw, and the same numbers for the port."""
    if not jcfg.frontend:
        return None, None
    fe = jstub(jcfg, B, seed)
    return fe, torch.from_numpy(np.array(fe))


def _layer_states(js, cfg):
    """The reference's stacked state -> one dict of numpy arrays per
    layer, in the port's layer order."""
    P = len(cfg.period)
    return [{n: np.asarray(a[j]) for n, a in js["layers"][f"pos{i}"].items()}
            for j in range(cfg.n_periods) for i in range(P)]


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_reference(case):
    """Prefill logits (frontend frames in front), then each teacher-forced
    decode step's logits, argmax, ``cur_len`` and every layer's state —
    KV caches and slot positions, Mamba's ``h``/``conv``, the mLSTM's
    ``C``/``n``/``m``/``conv``, the sLSTM's ``c``/``n``/``h``/``m``."""
    jcfg, pv, lm = _models(case)
    toks = _tokens(jcfg)
    fe, pfe = _frontend(jcfg)
    n_fe = 0 if fe is None else jcfg.frontend_len
    jl, js = jax.jit(jprefill, static_argnums=(1, 3))(
        pv, jcfg, toks[:, :PROMPT], n_fe + CACHE_LEN, fe)
    pl, ps = lm.prefill(torch.as_tensor(toks[:, :PROMPT]), n_fe + CACHE_LEN,
                        frontend_embeds=pfe)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    assert ps["cur_len"] == int(js["cur_len"]) == n_fe + PROMPT
    step = jax.jit(jdecode_step, static_argnums=1)
    for t in range(PROMPT, CACHE_LEN):
        jl, js = step(pv, jcfg, js, toks[:, t:t + 1])
        pl, ps = lm.decode_step(ps, torch.as_tensor(toks[:, t:t + 1]))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_array_equal(pl.argmax(-1).numpy(),
                                      np.asarray(jl).argmax(-1))
        assert ps["cur_len"] == int(js["cur_len"]) == n_fe + t + 1
    for st, jst in zip(ps["layers"], _layer_states(js, jcfg)):
        assert set(st) == set(jst)
        for n, a in st.items():
            if n == "pos":
                np.testing.assert_array_equal(a.numpy(), jst[n])
            else:
                np.testing.assert_allclose(a.numpy(), jst[n], err_msg=n,
                                           **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_lm_matches_reference(case):
    """The full forward over frontend + token positions; the weights
    carried cover every leaf of ``init_lm``'s tree (an mLSTM's ``wq``
    is not taken for attention's)."""
    jcfg, pv, lm = _models(case)
    toks = _tokens(jcfg)
    fe, pfe = _frontend(jcfg)
    jl, jaux = jforward_lm(pv, jcfg, toks, fe)
    with torch.no_grad():
        pl, aux = lm.forward_lm(torch.as_tensor(toks), pfe)
    assert pl.shape == tuple(jl.shape)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=0)
    assert sum(p.numel() for p in lm.parameters()) == sum(
        np.asarray(a).size for a in jax.tree_util.tree_leaves(pv))


@pytest.mark.parametrize("case", list(CASES))
def test_decode_matches_forward_lm(case):
    """The port's own prefill + decode against its full forward at the
    same positions (the reference's ``test_decode_matches_forward``)."""
    _, _, lm = _models(case)
    toks = torch.as_tensor(_tokens(lm.cfg))
    pfe = frontend.stub_frontend_embeds(lm.cfg, 2, device="cpu")
    n_fe = 0 if pfe is None else lm.cfg.frontend_len
    with torch.no_grad():
        full, _ = lm.forward_lm(toks, pfe)
    logits, state = lm.prefill(toks[:, :PROMPT], n_fe + CACHE_LEN, pfe)
    torch.testing.assert_close(logits, full[:, n_fe + PROMPT - 1], **TOL)
    for t in range(PROMPT, CACHE_LEN):
        logits, state = lm.decode_step(state, toks[:, t:t + 1])
        torch.testing.assert_close(logits, full[:, n_fe + t], **TOL)


@pytest.mark.parametrize("case", ["jamba", "xlstm"])
def test_decode_vs_forward_gap_is_the_references_own(case):
    """The recurrent decoders' float32 decode drifts from ``forward_lm``
    further than attention-only ones do, in the reference as in the port
    (the recurrences sum in another order step by step than over the
    whole sequence): from the same weights, over a 32-token prompt and 16
    steps (`chip_smoke.py` phase 11(b)'s), the port's largest decode-vs-
    forward logit gap stays within twice the reference's own."""
    ref_gap, gap, _ = decode_gaps(case, "reduced")
    assert 0 < ref_gap <= TOL["atol"]
    assert gap <= 2 * ref_gap, (gap, ref_gap)


@pytest.mark.parametrize("case", list(CASES))
def test_engine_greedy_tokens_match_reference(case, monkeypatch):
    jcfg, pv, lm = _models(case)
    prompts = _tokens(jcfg, B=3, S=9, seed=2)
    use_fe = bool(jcfg.frontend)
    if use_fe:
        monkeypatch.setattr(
            engine_mod, "stub_frontend_embeds",
            lambda cfg, B, seed, device: _frontend(jcfg, B, seed)[1])
    want = JServeEngine(jcfg, pv, max_len=32).generate(
        prompts, 8, use_frontend=use_fe)
    got = ServeEngine(lm, max_len=32).generate(prompts, 8,
                                               use_frontend=use_fe)
    np.testing.assert_array_equal(got.tokens, want.tokens)


@pytest.mark.parametrize("case", ["jamba", "xlstm"])
def test_batcher_slot_write_matches_reference(case):
    """A B=1 prefill state written into row 2 of a 4-slot pool: every
    recurrent tensor and KV cache row equals the reference's
    ``_write_slot`` result, the other rows are untouched, and the pool's
    ``cur_len`` is kept."""
    jcfg, pv, lm = _models(case)
    toks = _tokens(jcfg, B=1, S=PROMPT)
    _, jone = jprefill(pv, jcfg, toks, CACHE_LEN)
    jpool = init_lm_state(jcfg, 4, CACHE_LEN)
    jpool = jscheduler._write_slot(jpool, jone, 2)
    pool = lm.init_lm_state(4, CACHE_LEN)
    _, one = lm.prefill(toks, CACHE_LEN)
    held = [dict(st) for st in pool["layers"]]
    scheduler._write_slot(pool, one, 2)
    assert pool["cur_len"] == int(jpool["cur_len"]) == 0
    for st, jst, h in zip(pool["layers"], _layer_states(jpool, jcfg), held):
        assert all(st[n] is h[n] for n in st)          # written in place
        for n, a in st.items():
            np.testing.assert_allclose(a.numpy(), jst[n], err_msg=n, **TOL)


@pytest.mark.parametrize("case", ["jamba", "xlstm"])
def test_batcher_tokens_match_reference(case):
    """Five requests on two slots, so slots retire and refill over the
    recurrent states: every request's tokens and the tick count equal
    the reference batcher's."""
    jcfg, pv, lm = _models(case)
    kw = dict(n_slots=2, max_len=24, prompt_len=6)
    ref, port = JBatcher(jcfg, pv, **kw), ContinuousBatcher(lm, **kw)
    rng = np.random.default_rng(5)
    for i in range(5):
        prompt = rng.integers(4, jcfg.vocab_size, 4 + i % 3).astype(np.int32)
        ref.submit(JRequest(uid=i, prompt=prompt, max_new_tokens=3 + i % 2))
        port.submit(Request(uid=i, prompt=prompt, max_new_tokens=3 + i % 2))
    want, got = ref.run(max_ticks=100), port.run(max_ticks=100)
    assert sorted(got) == sorted(want) == list(range(5))
    for uid in want:
        assert got[uid].generated == want[uid].generated, uid
    assert port.ticks == ref.ticks


def test_launcher_serves_xlstm_on_the_cpu():
    svc = serve.main(["--device", "cpu", "--arch", "xlstm-125m", "--cache",
                      "--requests", "16", "--batch", "8",
                      "--max-new-tokens", "2"])
    st = svc.stats()
    assert st["requests"] == 16 and st["generations"] >= 1
    assert st["generations"] + st["coalesced_misses"] == st["misses"]
    cfg = svc.engine.model.cfg
    assert cfg.name == "xlstm-125m-smoke" and cfg.tie_embeddings


@pytest.mark.parametrize("name", ASSIGNED_ARCHS)
def test_every_assigned_arch_builds_prefills_and_decodes(name):
    """``LM(get_config(name).reduced(), device="cpu")`` for all ten:
    finite logits of the padded vocab's width, frontend frames counted in
    ``cur_len``, no refusal left but ``attn_f32=False``."""
    cfg = get_config(name).reduced()
    lm = LM(cfg, device="cpu")
    B, S = 2, 6
    fe = frontend.stub_frontend_embeds(cfg, B, device="cpu")
    n_fe = 0 if fe is None else cfg.frontend_len
    logits, state = lm.prefill(_tokens(cfg, B, S), n_fe + S + 2, fe)
    logits, state = lm.decode_step(state, logits.argmax(-1)[:, None])
    assert logits.shape == (B, layers.padded_vocab(cfg))
    assert torch.isfinite(logits[:, :cfg.vocab_size]).all()
    assert state["cur_len"] == n_fe + S + 1


def test_frontend_stub():
    """(B, frontend_len, d) normal * 0.02 in ``cfg.dtype`` from the seed,
    its ``meta`` spec, and None without a frontend."""
    cfg = get_config("pixtral-12b").reduced(dtype="bfloat16")
    a = frontend.stub_frontend_embeds(cfg, 3, seed=5, device="cpu")
    b = frontend.stub_frontend_embeds(cfg, 3, seed=5, device="cpu")
    c = frontend.stub_frontend_embeds(cfg, 3, seed=6, device="cpu")
    assert a.shape == (3, cfg.frontend_len, cfg.d_model)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert not torch.equal(a, c)
    assert 0.015 < float(a.float().std()) < 0.025
    spec = frontend.frontend_spec(cfg, 3)
    assert spec.device.type == "meta" and spec.shape == a.shape \
        and spec.dtype == a.dtype
    phi = get_config("phi3-mini-3.8b").reduced()
    assert frontend.stub_frontend_embeds(phi, 3, device="cpu") is None
    assert frontend.frontend_spec(phi, 3) is None
    j = jstub(jget_config("pixtral-12b").reduced(dtype="bfloat16"), 3)
    assert tuple(j.shape) == tuple(a.shape) and str(j.dtype) == "bfloat16"


@pytest.mark.parametrize("offset", [0, 7])
def test_sinusoidal_positions_match_reference(offset):
    got = layers.sinusoidal_positions(5, 128, offset=offset)
    want = np.asarray(jsinusoidal(5, 128, offset=offset))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_only_the_audio_family_without_rope_adds_positions():
    """MusicGen adds sinusoidal positions; Jamba and xLSTM (no RoPE
    either) have no position signal, Pixtral has RoPE."""
    flags = {name: LM(get_config(name).reduced(), device="cpu")._sinusoidal()
             for name in CASES.values()}
    assert flags == {JAMBA: False, "xlstm-125m": False,
                     "musicgen-large": True, "pixtral-12b": False}
    assert get_config("pixtral-12b").head_dim == 128      # explicit, not 160
    assert not any(s.mixer == ATTN for s in get_config("xlstm-125m").period)


@pytest.mark.parametrize("case", ["musicgen", "phi3", "xlstm"])
def test_engine_wraps_past_its_caches_as_the_reference(case, monkeypatch):
    """Frontend frames + prompt + new tokens past ``max_len``: the KV
    caches wrap (prefill keeps the last ``max_len`` positions, decode
    writes slot ``cur_len % max_len``) and the greedy tokens equal the
    reference's.  MusicGen (8 frames + 9 + 8 = 25 > 24) wraps in decode;
    Phi-3-mini without a frontend (prompt 9 > 6) wraps at prefill; the
    recurrent xLSTM has no cache to wrap."""
    if case == "phi3":
        jcfg = jget_config("phi3-mini-3.8b").reduced()
        pv, _ = split(init_lm(jcfg, jax.random.PRNGKey(0)))
        lm = LM(get_config("phi3-mini-3.8b").reduced(), device="cpu")
        lm.load_state_dict(state_dict_from_reference(
            jax.tree_util.tree_map(np.asarray, pv), lm.cfg))
        max_len = 6
    else:
        jcfg, pv, lm = _models(case)
        max_len = 24 if case == "musicgen" else 4
    use_fe = bool(jcfg.frontend)
    if use_fe:
        monkeypatch.setattr(
            engine_mod, "stub_frontend_embeds",
            lambda cfg, B, seed, device: _frontend(jcfg, B, seed)[1])
    prompts = _tokens(jcfg, B=2, S=9, seed=3)
    n_fe = jcfg.frontend_len if use_fe else 0
    assert n_fe + 9 + 8 > max_len
    want = JServeEngine(jcfg, pv, max_len=max_len).generate(
        prompts, 8, use_frontend=use_fe)
    got = ServeEngine(lm, max_len=max_len).generate(prompts, 8,
                                                   use_frontend=use_fe)
    assert got.tokens.shape == (2, 8)
    np.testing.assert_array_equal(got.tokens, want.tokens)
