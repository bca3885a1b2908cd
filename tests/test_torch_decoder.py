"""Port parity for the dense decoder, its serving engine and the cached
LLM service, with the reference's own ``init_lm`` weights carried
across at reduced size (2 layers, d_model 128, vocab 512).

Configs: ``phi3-mini-3.8b`` (MHA, SwiGLU, RMSNorm, tied embeddings), a
GQA variant (``n_kv_heads=1``), ``starcoder2-15b`` (GELU MLP with
biases, LayerNorm, QKV bias, untied unembedding), a sliding window of 8
with a longer prompt (the ring-buffer cache), and Phi-3-mini in bf16.

Tolerances: logits and caches ``atol 2e-4, rtol 1e-3`` in float32 (the
reference's own decode-versus-forward tolerance,
``tests/test_arch_smoke.py``), ``atol 3e-2, rtol 3e-2`` in bf16 (both
sides round every activation to bf16, at places that differ by a last
bit); slot positions and greedy tokens exactly.  Sampling draws from a
``torch.Generator``, not ``jax.random``, so it is compared by
distribution.
"""
import zlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import SemanticCache as JSemanticCache
from repro.data import HashTokenizer as JHashTokenizer
from repro.models import decode_step as jdecode_step
from repro.models import init_lm, split
from repro.models import prefill as jprefill
from repro.serving import CachedLLMService as JCachedLLMService
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.core import SemanticCache
from repro_torch.data import HashTokenizer
from repro_torch.launch import serve
from repro_torch.models import LM, state_dict_from_reference
from repro_torch.serving import CachedLLMService, ServeEngine

CASES = {
    "phi3": ("phi3-mini-3.8b", {}),
    "phi3-gqa": ("phi3-mini-3.8b", dict(n_kv_heads=1)),
    "starcoder2": ("starcoder2-15b", {}),
    "phi3-window": ("phi3-mini-3.8b", dict(sliding_window=8)),
    "phi3-bf16": ("phi3-mini-3.8b", dict(dtype="bfloat16")),
}
F32_CASES = [c for c in CASES if c != "phi3-bf16"]
TOL = {"float32": dict(atol=2e-4, rtol=1e-3),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
PROMPT, CACHE_LEN = 10, 14


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


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_reference(case):
    """Prefill logits, then each teacher-forced decode step's logits,
    and the k/v caches and slot positions after every step."""
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
                assert st[n].dtype == getattr(torch, jcfg.dtype)
                np.testing.assert_allclose(_np(st[n]), _np(jst[n]), **tol)


@pytest.mark.parametrize("case", F32_CASES)
def test_decode_matches_forward_lm(case):
    """The port's prefill + decode steps give the logits of its own
    full-sequence forward at the same positions (the window case with
    a prompt longer than the window, so the ring buffer wraps)."""
    jcfg, _, lm = _models(case)
    toks = torch.as_tensor(_tokens(jcfg))
    with torch.no_grad():
        full, aux = lm.forward_lm(toks)
    assert float(aux) == 0.0
    logits, state = lm.prefill(toks[:, :PROMPT], CACHE_LEN)
    torch.testing.assert_close(logits, full[:, PROMPT - 1], **TOL["float32"])
    for t in range(PROMPT, CACHE_LEN):
        logits, state = lm.decode_step(state, toks[:, t:t + 1])
        torch.testing.assert_close(logits, full[:, t], **TOL["float32"])


@pytest.mark.parametrize("case", ["phi3", "starcoder2", "phi3-window"])
def test_engine_greedy_tokens_match_reference(case):
    jcfg, pv, lm = _models(case)
    prompts = _tokens(jcfg, B=3, S=9, seed=2)
    want = JServeEngine(jcfg, pv, max_len=24).generate(prompts, 8)
    got = ServeEngine(lm, max_len=24).generate(prompts, 8)
    assert got.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert (got.n_prompt, got.n_generated) == (want.n_prompt,
                                              want.n_generated)


def test_engine_sampling_follows_the_softmax():
    """Gumbel-max sampling at temperature T draws token i with
    probability softmax(logits / T)_i, on both sides (each with its own
    generator); the port's draws repeat for a seed."""
    logits = torch.log(torch.tensor([0.5, 0.25, 0.15, 0.1]))
    probs = torch.softmax(logits / 0.7, -1).numpy()
    n = 40_000
    gen = torch.Generator().manual_seed(3)
    got = ServeEngine._select(logits.expand(n, 4), 0.7, gen)[:, 0].numpy()
    want = np.asarray(JServeEngine._select(
        jax.numpy.asarray(logits.expand(n, 4).numpy()), 0.7,
        jax.random.PRNGKey(3)))[:, 0]
    for draws in (got, want):
        freq = np.bincount(draws, minlength=4) / n
        np.testing.assert_allclose(freq, probs, atol=0.01)
    again = ServeEngine._select(logits.expand(n, 4), 0.7,
                                torch.Generator().manual_seed(3))[:, 0]
    assert np.array_equal(again.numpy(), got)


def _embed(texts):
    """Deterministic unit vectors per text: equal texts hit, others
    score near 0."""
    out = np.stack([np.random.default_rng(zlib.crc32(t.encode()))
                    .standard_normal(32) for t in texts]).astype(np.float32)
    return out / np.linalg.norm(out, axis=1, keepdims=True)


def test_cached_llm_service_answers_misses_with_the_decoder():
    """Misses are answered by greedy generation from the decoder — the
    same token strings as the reference's service with the same weights
    — and a repeated query hits without reaching the engine."""
    jcfg, pv, lm = _models("phi3")
    rows = []
    engine = ServeEngine(lm, max_len=32)
    generate = engine.generate

    def counting(ids, *a, **k):
        rows.append(len(ids))
        return generate(ids, *a, **k)

    engine.generate = counting
    port = CachedLLMService(
        _embed, SemanticCache(capacity=64, dim=32, threshold=0.99,
                              device="cpu"),
        engine, HashTokenizer(vocab_size=jcfg.vocab_size),
        max_query_len=16, max_new_tokens=4)
    ref = JCachedLLMService(
        _embed, JSemanticCache(capacity=64, dim=32, threshold=0.99),
        JServeEngine(jcfg, pv, max_len=32),
        JHashTokenizer(vocab_size=jcfg.vocab_size), max_query_len=16,
        max_new_tokens=4)
    batches = [["what causes fever", "treatment for asthma"],
               ["what causes fever", "symptoms of flu",
                "treatment for asthma"]]
    first = None
    for i, batch in enumerate(batches):
        got, want = port.handle(batch), ref.handle(batch)
        assert [(r.response, r.cache_hit) for r in got] == \
            [(r.response, r.cache_hit) for r in want]
        for r in got:
            toks = r.response.split()
            assert len(toks) == 4 and all(0 <= int(t) < jcfg.vocab_size
                                          for t in toks)
        if i == 0:
            first = {r.query: r.response for r in got}
            assert not any(r.cache_hit for r in got)
    assert [r.cache_hit for r in got] == [True, False, True]
    assert got[0].response == first["what causes fever"]
    assert got[2].response == first["treatment for asthma"]
    assert rows == [2, 1]                 # the hits never reached it
    assert port.stats()["generations"] == 3


def test_decoder_tokenizer_must_fit_the_decoder_vocab():
    """The encoder's tokenizer (vocab 50368 at full width) would give ids
    past the decoder's table: the service and the engine refuse."""
    _, _, lm = _models("phi3")
    engine = ServeEngine(lm, max_len=16)
    with pytest.raises(ValueError, match="vocab"):
        CachedLLMService(_embed, SemanticCache(capacity=8, dim=32,
                                               device="cpu"),
                         engine, HashTokenizer())
    with pytest.raises(ValueError, match="vocab"):
        engine.generate(np.full((1, 4), lm.cfg.vocab_size, np.int32), 2)


def test_launcher_serves_on_the_cpu():
    svc = serve.main(["--device", "cpu", "--cache", "--requests", "16",
                      "--batch", "8", "--max-new-tokens", "2"])
    st = svc.stats()
    assert st["requests"] == 16
    assert st["generations"] >= 1
    assert st["generations"] + st["coalesced_misses"] == st["misses"]
    with pytest.raises(SystemExit):
        serve.parse_args(["--device", "cpu", "--scenario", "drift"])
    args = serve.parse_args(["--device", "cpu", "--cold-capacity", "64",
                             "--conformal"])
    assert args.tiered and args.cold_capacity == 64 and args.conformal
