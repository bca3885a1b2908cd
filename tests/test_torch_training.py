"""Port parity for the training slice: the optimizer, the batch order,
the metrics, one trainer step from the reference's own weights, and the
paper's claim (a fine-tune lifts pair-classification metrics) on the
port.

The same seeded numpy inputs go through the JAX reference and the port,
on the CPU, at a small size (``modernbert-149m.reduced(n_layers=2)``,
d_model 128).  Tolerances, stated next to each assert:

* Adam from identical gradients: parameters ``atol 1e-7``; moments
  within their dtype (``rtol`` and, for entries that cancel to near
  zero, ``atol`` = the dtype's eps times the tensor's largest entry:
  the clip's norm is summed in another order);
* one trainer step in float32: loss ``rtol 1e-5``, each gradient
  relative L2 ``<= 1e-4``, the parameters after it within 5 % of lr;
  in bf16: loss ``rtol 1e-2``, the global
  gradient relative L2 ``<= 5e-2`` (bf16 rounds at other places in the
  two frameworks);
* batch order, tokens, metrics: exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import EmbedderTrainer as JEmbedderTrainer
from repro.core import FinetuneConfig as JFinetuneConfig
from repro.core import losses as jlosses
from repro.core import metrics as jmetrics
from repro.data import HashTokenizer as JHashTokenizer
from repro.data import iter_batches as jiter_batches
from repro.data import make_pair_dataset as jmake_pair_dataset
from repro.data import tokenize_pairs as jtokenize_pairs
from repro.models import encode as jencode
from repro.models import init_lm, split
from repro.training import adamw as jadamw
from repro.training import apply_updates as japply_updates
from repro.training import clip_by_global_norm as jclip
from repro_torch.configs import get_config
from repro_torch.core import EmbedderTrainer, FinetuneConfig, metrics
from repro_torch.data import (
    HashTokenizer, iter_batches, make_pair_dataset, shard_batch,
    tokenize_pairs,
)
from repro_torch.models import state_dict_from_reference
from repro_torch.training import adamw, apply_updates, clip_by_global_norm


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _leaves(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32),
            "s": rng.standard_normal((3, 2, 4)).astype(np.float32)}


@pytest.mark.parametrize("max_norm", [None, 0.5, 1e3])   # off/active/idle
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adam_matches_reference(max_norm, state_dtype):
    rng = np.random.default_rng(1)
    params = _leaves(rng)
    grads = [_leaves(rng) for _ in range(3)]
    jinit, jupd = jadamw(1e-2, max_grad_norm=max_norm,
                         state_dtype=getattr(jnp, state_dtype))
    pinit, pupd = adamw(1e-2, max_grad_norm=max_norm,
                        state_dtype=getattr(torch, state_dtype))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: torch.tensor(v) for k, v in params.items()}
    js, ps = jinit(jp), pinit(pp)
    for g in grads:                       # three steps: bias corrections
        ju, js, jm = jupd({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = japply_updates(jp, ju)
        pu, ps, pm = pupd({k: torch.tensor(v) for k, v in g.items()}, ps,
                          pp)
        apply_updates(pp, pu)
        if max_norm is not None:
            np.testing.assert_allclose(float(pm["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=1e-6)
    assert ps.step == int(js.step) == 3
    eps = float(torch.finfo(getattr(torch, state_dtype)).eps)
    for k in params:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-7)
        for pm_, jm_ in ((ps.m[k], js.m[k]), (ps.v[k], js.v[k])):
            assert pm_.dtype == getattr(torch, state_dtype)
            ref = np.asarray(jm_).astype(np.float32)
            np.testing.assert_allclose(pm_.float().numpy(), ref, rtol=eps,
                                       atol=eps * np.abs(ref).max())


def test_clip_by_global_norm_matches_reference():
    tree = {"a": np.full((10,), 10.0, np.float32),
            "b": np.arange(4, dtype=np.float32)}
    jc, jn = jclip({k: jnp.asarray(v) for k, v in tree.items()}, 0.5)
    pc, pn = clip_by_global_norm({k: torch.tensor(v)
                                  for k, v in tree.items()}, 0.5)
    np.testing.assert_allclose(float(pn), float(jn), rtol=1e-6)
    for k in tree:
        np.testing.assert_allclose(pc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-6, atol=0)


def test_adam_reduces_quadratic():
    init, update = adamw(0.1)
    params = {"w": torch.tensor([3.0, -2.0], requires_grad=True)}
    opt = init(params)
    for _ in range(200):
        (g,) = torch.autograd.grad(params["w"].square().sum(),
                                   [params["w"]])
        ups, opt, _ = update({"w": g}, opt, params)
        apply_updates(params, ups)
    assert float(params["w"].detach().abs().max()) < 1e-2


# ---------------------------------------------------------------------------
# data and metrics
# ---------------------------------------------------------------------------

def test_batches_and_tokens_match_reference():
    jds = jmake_pair_dataset("medical", 100, seed=2)
    ds = make_pair_dataset("medical", 100, seed=2)
    ja = jtokenize_pairs(jds, JHashTokenizer(2048), max_len=24)
    pa = tokenize_pairs(ds, HashTokenizer(2048), max_len=24)
    jb = list(jiter_batches(ja, 16, seed=3, epochs=2))
    pb = list(iter_batches(pa, 16, seed=3, epochs=2))
    assert len(pb) == len(jb) == 2 * (100 // 16)
    for x, y in zip(jb, pb):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])
    tail = list(iter_batches(pa, 16, shuffle=False, drop_remainder=False))
    assert len(tail[-1]["label"]) == 100 % 16
    # shard_batch places a batch on a mesh (dim 0 over the batch axes);
    # on one rank the local block is the whole batch (2 ranks: the
    # distrib tests)
    from test_torch_ranks import one_rank_mesh
    with one_rank_mesh() as mesh:
        placed = shard_batch(pb[0], mesh)
    assert placed.keys() == pb[0].keys()
    for k, v in placed.items():
        np.testing.assert_array_equal(v.to_local().numpy(), pb[0][k])


@pytest.mark.parametrize("case", ["random", "ties", "one_class"])
def test_metrics_match_reference(case):
    rng = np.random.default_rng(4)
    scores = rng.random(300)
    labels = rng.integers(0, 2, 300).astype(np.int32)
    if case == "ties":
        scores = np.round(scores, 1)
    elif case == "one_class":
        labels[:] = 0
    a = jmetrics.pair_classification_metrics(scores, labels)
    b = metrics.pair_classification_metrics(scores, labels)
    assert a == b
    assert jmetrics.average_precision(scores, labels) == \
        metrics.average_precision(scores, labels)
    assert jmetrics.metrics_at_threshold(scores, labels, 0.4) == \
        metrics.metrics_at_threshold(scores, labels, 0.4)


# ---------------------------------------------------------------------------
# the trainer, from the reference's weights
# ---------------------------------------------------------------------------

def _configs(dtype, **kw):
    j = jget_config("modernbert-149m").reduced(n_layers=2, vocab_size=512,
                                               **kw)
    p = get_config("modernbert-149m").reduced(n_layers=2, vocab_size=512,
                                              **kw)
    return dataclasses.replace(j, dtype=dtype), \
        dataclasses.replace(p, dtype=dtype)


def _first_batch(cfg, n=64, batch=16, max_len=16):
    ds = make_pair_dataset("medical", n, seed=0)
    arrays = tokenize_pairs(ds, HashTokenizer(cfg.vocab_size), max_len)
    return next(iter_batches(arrays, batch, seed=0))


def _jax_value_and_grad(cfg, params, batch, loss_name, margin):
    loss_fn = getattr(jlosses, loss_name)

    def objective(p):
        toks = jnp.concatenate([batch["tok1"], batch["tok2"]], axis=0)
        masks = jnp.concatenate([batch["mask1"], batch["mask2"]], axis=0)
        e1, e2 = jnp.split(jencode(p, cfg, toks, masks), 2, axis=0)
        return loss_fn(e1, e2, jnp.asarray(batch["label"]), margin=margin)

    return jax.jit(jax.value_and_grad(objective))(params)


def _trainers(dtype, loss="online", **ft):
    jcfg, pcfg = _configs(dtype)
    kw = dict(max_len=16, seed=5, loss=loss, **ft)
    jt = JEmbedderTrainer(jcfg, JFinetuneConfig(**kw))
    pt = EmbedderTrainer(pcfg, FinetuneConfig(**kw),
                         params=state_dict_from_reference(
                             _np_tree(jt.params), pcfg), device="cpu")
    return jcfg, pcfg, jt, pt


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("loss", ["online", "contrastive"])
def test_trainer_step_matches_reference_fp32(loss):
    """Loss and every gradient of one step, then the parameters and
    Adam moments after it, from the reference's weights (float32)."""
    jcfg, pcfg, jt, pt = _trainers("float32", loss)
    batch = _first_batch(pcfg)
    jname = "online_contrastive_loss" if loss == "online" \
        else "contrastive_loss"
    jl, jg = _jax_value_and_grad(jcfg, jt.params, batch, jname, 0.5)
    pl = pt._objective(batch)
    pg = pt._grads(pl)
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=1e-5)
    jg_port = state_dict_from_reference(_np_tree(jg), pcfg)
    assert jg_port.keys() == pg.keys()
    for name, g in pg.items():
        assert _rel_l2(g.numpy(), jg_port[name].numpy()) <= 1e-4, name

    jt.params, jt.opt_state, jm = jt._step(
        jt.params, jt.opt_state, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    pm = pt._step(batch)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    # Adam's first step moves a weight by lr * g / (|g| + 1e-8): where
    # |g| is near 1e-8, the gradients' element-wise difference shows up
    # as a few percent of lr (observed 1.3 %), so the parameters are held
    # to 5 % of lr
    after = state_dict_from_reference(_np_tree(jt.params), pcfg)
    for name, p in pt.params.items():
        np.testing.assert_allclose(p.detach().numpy(), after[name].numpy(),
                                   rtol=0, atol=0.05 * pt.ft.lr,
                                   err_msg=name)
    for mine, ref in ((pt.opt_state.m, jt.opt_state.m),
                      (pt.opt_state.v, jt.opt_state.v)):
        ref = state_dict_from_reference(_np_tree(ref), pcfg)
        for name, x in mine.items():
            assert _rel_l2(x.numpy(), ref[name].numpy()) <= 1e-4, name


def test_trainer_step_matches_reference_bf16():
    """bf16 compute: the loss within 1e-2 and the global gradient within
    5e-2 relative L2 (observed on the CPU: 6.5e-4 and 9.8e-3)."""
    jcfg, pcfg, jt, pt = _trainers("bfloat16")
    batch = _first_batch(pcfg)
    jl, jg = _jax_value_and_grad(jcfg, jt.params, batch,
                                 "online_contrastive_loss", 0.5)
    pl = pt._objective(batch)
    pg = pt._grads(pl)
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=1e-2)
    jg_port = state_dict_from_reference(_np_tree(jg), pcfg)
    a = np.concatenate([pg[n].float().numpy().ravel() for n in pg])
    b = np.concatenate([jg_port[n].numpy().ravel() for n in pg])
    assert _rel_l2(a, b) <= 5e-2


def test_gradient_and_moment_trees_carry_like_weights():
    """The gradient tree and Adam's m/v trees have the weights' structure,
    so `state_dict_from_reference` carries them into the port's layout.
    With an untied config the one leaf without a counterpart,
    ``embed/unembed``, has an exactly zero gradient in the encoder."""
    jcfg, pcfg = _configs("float32", tie_embeddings=False)
    params, _ = split(init_lm(jcfg, jax.random.PRNGKey(2)))
    batch = _first_batch(pcfg)
    _, grads = _jax_value_and_grad(jcfg, params, batch,
                                   "online_contrastive_loss", 0.5)
    tree = _np_tree(grads)
    assert not np.any(tree["embed"]["unembed"])
    sd_w = state_dict_from_reference(_np_tree(params), pcfg)
    sd_g = state_dict_from_reference(tree, pcfg)
    init, update = jadamw(1e-3, max_grad_norm=0.5)
    _, st, _ = jax.jit(update)(grads, init(params), params)
    for t in (st.m, st.v):
        sd_t = state_dict_from_reference(_np_tree(t), pcfg)
        assert sd_t.keys() == sd_w.keys()
    assert sd_g.keys() == sd_w.keys()
    n_ref = sum(np.size(x) for x in jax.tree_util.tree_leaves(tree))
    n_port = sum(t.numel() for t in sd_g.values())
    assert n_ref - n_port == tree["embed"]["unembed"].size
    for name, t in sd_g.items():
        assert t.shape == sd_w[name].shape, name


@pytest.fixture(scope="module")
def tuning_setup():
    cfg = get_config("modernbert-149m").reduced(vocab_size=2048)
    jcfg = jget_config("modernbert-149m").reduced(vocab_size=2048)
    params, _ = split(init_lm(jcfg, jax.random.PRNGKey(0)))
    weights = state_dict_from_reference(_np_tree(params), cfg)
    tok = HashTokenizer(vocab_size=cfg.vocab_size)
    train = make_pair_dataset("medical", 192, seed=0)
    evl = make_pair_dataset("medical", 96, seed=99)
    return cfg, weights, tok, train, evl


def test_finetune_improves_metrics(tuning_setup):
    """The paper's central claim at smoke scale, on the port from the
    reference's weights (mirrors tests/test_training.py): fine-tuning
    with the online contrastive loss lifts AP by more than 0.03 and F1."""
    cfg, weights, tok, train, evl = tuning_setup
    ft = FinetuneConfig(epochs=2, batch_size=16, max_len=24, lr=3e-4,
                        log_every=4)
    trainer = EmbedderTrainer(cfg, ft, params=weights, device="cpu")
    before = trainer.evaluate(evl, tok)
    out = trainer.fit(train, tok, eval_ds=evl)
    after = out["eval"]
    assert out["steps"] == 2 * (192 // 16)
    assert after["ap"] > before["ap"] + 0.03, (before, after)
    assert after["f1"] > before["f1"]
    assert [h["step"] for h in trainer.history] == [4, 8, 12, 16, 20, 24]
    assert all(np.isfinite(h["loss"]) and 0 < h["grad_norm"]
               for h in trainer.history)
    # embed_texts runs under inference_mode and does not disturb steps
    trainer._step(next(iter_batches(tokenize_pairs(train, tok, 24), 16)))
