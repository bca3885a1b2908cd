"""Port parity for the decoder's training loss: ``LM.lm_loss`` and its
gradients against the reference's ``lm_loss`` and ``jax.grad``, for each
of the ten assigned archs at reduced size (float32), with the
reference's ``init_lm`` weights carried across.

Jamba keeps an attention layer (its period positions 1–4, as
`tests/test_torch_zoo.py`); MusicGen and Pixtral take the reference's
frontend-stub draw as numpy; ``phi3-window`` is Phi-3-mini with a window
of 8 at S = 40 > 2W, the reference's ``local_window_attention`` branch.
The perf levers mirror `tests/test_perf_levers.py`: ``loss_chunk`` is
exact and ``attn_f32=False`` is close, with finite gradients.

Tolerances: the loss ``rtol 1e-5``; each gradient leaf relative L2
``<= 1e-4`` (sums in another order through autograd and XLA), or ``atol
1e-8`` for a leaf whose reference gradient is all but zero (norm below
1e-6); the chunked loss ``atol 2e-5`` (the reference test's own bound).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ASSIGNED_ARCHS
from repro.models import init_lm, lm_loss as jlm_loss, split
from repro.serving.frontend import stub_frontend_embeds as jstub
from repro_torch.configs import get_config
from repro_torch.models import LM, lm_loss, state_dict_from_reference

JAMBA = "jamba-1.5-large-398b"
CASES = {**{a: (a, {}) for a in ASSIGNED_ARCHS},
         "phi3-window": ("phi3-mini-3.8b", dict(sliding_window=8))}
SEQ = {"phi3-window": 40}


def _setup(case, **kw):
    name, extra = CASES[case]
    kw = {**extra, **kw}

    def cfg(get):
        c = get(name)
        if name == JAMBA:         # keep the attention layer
            kw.setdefault("period", c.period[1:5])
            kw.setdefault("n_layers", 4)
        return c.reduced(**kw)

    jcfg, pcfg = cfg(jget_config), cfg(get_config)
    pv, _ = split(init_lm(jcfg, jax.random.PRNGKey(0)))
    lm = LM(pcfg, device="cpu")
    lm.load_state_dict(state_dict_from_reference(
        jax.tree_util.tree_map(np.asarray, pv), pcfg))
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, SEQ.get(case, 16))).astype(np.int32)
    fe = jstub(jcfg, 2, 0) if jcfg.frontend else None
    return jcfg, pv, lm, toks, fe


def _port_fe(fe):
    return None if fe is None else torch.from_numpy(np.array(fe))


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("case", list(CASES))
def test_lm_loss_and_grads_match_reference(case):
    jcfg, pv, lm, toks, fe = _setup(case)

    def loss(p):
        return jlm_loss(p, jcfg, jnp.asarray(toks), fe)

    (jl, jparts), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(pv)
    pl, parts = lm_loss(lm, torch.from_numpy(toks), _port_fe(fe))
    pl.backward()
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=1e-5)
    aux = float(parts["aux"].detach())
    np.testing.assert_allclose(aux, float(jparts["aux"]), rtol=1e-5,
                               atol=1e-7)
    if lm.cfg.moe is not None:
        assert aux > 0
    want = state_dict_from_reference(
        jax.tree_util.tree_map(np.asarray, jg), lm.cfg)
    got = {n: p.grad for n, p in lm.named_parameters()}
    assert got.keys() == want.keys()
    for n, g in got.items():
        assert g is not None, n
        ref = want[n].numpy()
        if np.linalg.norm(ref) < 1e-6:
            np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=1e-8,
                                       err_msg=n)
        else:
            assert _rel_l2(g.numpy(), ref) <= 1e-4, n


@pytest.fixture(scope="module")
def phi3():
    """The reference's perf-lever fixture: reduced Phi-3-mini, (2, 33)
    tokens."""
    jcfg, pv, lm, _, _ = _setup("phi3-mini-3.8b")
    toks = np.random.default_rng(11).integers(
        0, jcfg.vocab_size, (2, 33)).astype(np.int32)
    return jcfg, pv, lm, toks


def _with(lm, **kw):
    other = LM(lm.cfg.replace(**kw), device="cpu")
    other.load_state_dict(lm.state_dict())
    return other


def test_loss_chunk_exact(phi3):
    jcfg, pv, lm, toks = phi3
    with torch.no_grad():
        l0 = float(lm.lm_loss(toks)[0])
        for chunk in (1, 8, 17, 32):
            l1 = float(_with(lm, loss_chunk=chunk).lm_loss(toks)[0])
            np.testing.assert_allclose(l0, l1, atol=2e-5)
    np.testing.assert_allclose(l0, float(jlm_loss(pv, jcfg, toks)[0]),
                               rtol=1e-5)


def test_attn_bf16_close(phi3):
    """bf16 softmax weights and PV sum: within 0.05 of float32 (the
    reference test's bound), and within 1e-3 relative of the reference's
    own bf16 loss (bf16 products round at other places in the two
    frameworks)."""
    jcfg, pv, lm, toks = phi3
    with torch.no_grad():
        l0 = float(lm.lm_loss(toks)[0])
        l1 = float(_with(lm, attn_f32=False).lm_loss(toks)[0])
    assert abs(l0 - l1) < 0.05
    want = float(jlm_loss(pv, jcfg.replace(attn_f32=False), toks)[0])
    np.testing.assert_allclose(l1, want, rtol=1e-3)


def test_attn_bf16_grads_finite(phi3):
    _, _, lm, toks = phi3
    other = _with(lm, attn_f32=False, loss_chunk=8)
    other.lm_loss(toks)[0].backward()
    for n, p in other.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), n


def test_remat_gives_the_same_loss_and_grads(phi3):
    """``cfg.remat`` recomputes each period in the backward pass: the
    same loss and the same gradients as without."""
    _, _, lm, toks = phi3
    grads = []
    for remat in (False, True):
        m = _with(lm, remat=remat)
        loss = m.lm_loss(toks)[0]
        loss.backward()
        grads.append((float(loss.detach()), {n: p.grad for n, p in
                                    m.named_parameters()}))
    assert grads[0][0] == grads[1][0]
    for n, g in grads[0][1].items():
        torch.testing.assert_close(grads[1][1][n], g, rtol=0, atol=0)
