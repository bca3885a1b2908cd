"""The embedder refresh and the MoE decoder on the card: what only a
CUDA run can show.

Only torch and the port are imported, so ``PYTHONPATH=src python -m
pytest -q --noconftest tests/test_torch_cuda_refresh.py`` runs on the
card's machine; elsewhere every case skips.

* the refresh: the candidate trains on a host thread through the
  contrastive kernels (forward and backward launches equal its steps),
  its kernels queue on the default stream beside serving, the publish
  copies its weights into the live encoder (the service's embed
  function returns the candidate's embeddings), every published key is
  the live encoder's embedding of its text (``atol 1e-5``), and an
  exception on the thread ends in ``RuntimeError`` at the publish; the
  same stream on the CPU gives the same hits, versions and counters;
* the MoE decoder at Granite's head width 64 and GQA group 3 (the decode
  kernel's row path): prefill and every decode step's logits on the card
  against the CPU (``atol 2e-4, rtol 1e-3`` float32), one flash launch
  per layer a prefill and one decode launch per layer a step, and the
  capacity drops counted equal on both devices.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.cache_service.service as service_mod
from repro_torch.cache_service import (
    CacheConfig, CacheRequest, CacheService, EmbedderRefreshPolicy,
)
from repro_torch.configs import get_config
from repro_torch.core import EmbedderTrainer, FinetuneConfig
from repro_torch.data import HashTokenizer
from repro_torch.kernels.contrastive import kernel as contrastive_kernel
from repro_torch.kernels.decode_attention import kernel as decode_kernel
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.models import LM

POLICY = dict(min_pairs=8, min_class=2, refresh_interval=8,
              min_precision=0.0, min_recall=0.0, max_f1_regression=10.0,
              synth_domain="medical", synth_min_pairs=32)
TOL = dict(atol=2e-4, rtol=1e-3)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run on the H100)")
    return torch.device("cuda")


def _service(device):
    cfg = get_config("modernbert-149m").reduced(vocab_size=1024)
    tok = HashTokenizer(vocab_size=cfg.vocab_size)
    tr = EmbedderTrainer(cfg, FinetuneConfig(epochs=1, batch_size=8,
                                             max_len=12), device=device)
    svc = CacheService(CacheConfig.from_kwargs(
        cfg.d_model, hot_capacity=64, warm_capacity=256, n_clusters=4,
        bucket=32, threshold=0.99, fused=True, embedder_trainer=tr,
        embedder_tokenizer=tok,
        refresh_policy=EmbedderRefreshPolicy(**POLICY)), device=device)
    return svc, tr, tok


# threshold 0.99: only exact repeats hit, far from any score the two
# devices round differently (distinct template texts score near 0.9)
def _stream(svc, emb, n=24):
    texts = [f"what dose of drug {i % 6} should the patient take"
             for i in range(n)]
    hits = []
    for i in range(0, n, 4):
        t = texts[i:i + 4]
        plan = svc.plan(CacheRequest.build(emb(t), 0, texts=t),
                        coalesce=False)
        svc.commit(plan, [None if h else f"r({q})"
                          for h, q in zip(plan.hit, t)])
        hits.append(plan.hit.copy())
    return texts, np.concatenate(hits)


@pytest.mark.cuda
def test_refresh_on_the_card_publishes_the_candidate(dev):
    svc, tr, tok = _service(dev)
    emb = tr.make_embed_fn(tok)
    texts, hits = _stream(svc, emb)
    contrastive_kernel.COUNTS["contrastive_components"] = 0
    contrastive_kernel.COUNTS["contrastive_backward"] = 0
    assert svc.maintenance().refresh_started
    box = svc._refresh_box
    rep = svc.maintenance(block=True)
    assert rep.refresh_published and rep.embed_version == 1
    steps = box["fit"]["steps"]
    assert steps > 0
    assert contrastive_kernel.COUNTS == {"contrastive_components": steps,
                                         "contrastive_backward": steps}
    probe = sorted(set(texts))
    np.testing.assert_array_equal(emb(probe),
                                  box["trainer"].embed_texts(probe, tok))
    v = svc.hot.valid
    keys = svc.hot.keys[v].cpu().numpy()
    live = emb([svc._texts[int(x)] for x in svc.hot.value_ids[v].tolist()])
    np.testing.assert_allclose(keys, live, atol=1e-5)
    # the same stream on the CPU: same hits, versions and counters
    cpu, ctr, ctok = _service("cpu")
    _, chits = _stream(cpu, ctr.make_embed_fn(ctok))
    np.testing.assert_array_equal(hits, chits)
    cpu.maintenance()
    assert cpu.maintenance(block=True).refresh_published
    a, b = svc.stats_snapshot().refresh, cpu.stats_snapshot().refresh
    for k in ("embed_version", "refreshes_published", "pairs_held"):
        assert a[k] == b[k], k


@pytest.mark.cuda
def test_refresh_thread_error_is_raised_at_publish(dev, monkeypatch):
    svc, tr, tok = _service(dev)
    _stream(svc, tr.make_embed_fn(tok))

    def broken(*a, **k):
        raise ValueError("re-embed failed")

    monkeypatch.setattr(service_mod, "_reembed_snapshot", broken)
    assert svc.maintenance().refresh_started
    with pytest.raises(RuntimeError, match="refresh failed"):
        svc.maintenance(block=True)
    assert svc._embed_version == 0


def _granite_pair(dev):
    """A reduced Granite-MoE at the full model's head width 64 and GQA
    group 3, on the card and on the CPU with the same weights."""
    cfg = get_config("granite-moe-3b-a800m").reduced(
        d_model=384, n_heads=6, n_kv_heads=2, head_dim=64)
    lm = LM(cfg, seed=0, device=dev).eval()
    cpu = LM(cfg, seed=0, device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in lm.state_dict().items()})
    return cfg, lm, cpu


@pytest.mark.cuda
def test_moe_decoder_on_the_card_matches_the_cpu(dev):
    cfg, lm, cpu = _granite_pair(dev)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 20))
    flash_kernel.COUNTS["flash_attention"] = 0
    decode_kernel.COUNTS["decode_attention"] = 0
    gl, gs = lm.prefill(toks[:, :12], 20)
    cl, cs = cpu.prefill(toks[:, :12], 20)
    torch.testing.assert_close(gl.cpu(), cl, **TOL)
    assert flash_kernel.COUNTS["flash_attention"] == cfg.n_layers
    for t in range(12, 20):
        gl, gs = lm.decode_step(gs, toks[:, t:t + 1])
        cl, cs = cpu.decode_step(cs, toks[:, t:t + 1])
        torch.testing.assert_close(gl.cpu(), cl, **TOL)
    assert decode_kernel.COUNTS["decode_attention"] == cfg.n_layers * 8
    for a, b in zip(lm.layers, cpu.layers):
        assert int(a.moe.dropped) == int(b.moe.dropped)


@pytest.mark.cuda
def test_moe_capacity_drops_equal_on_the_card(dev):
    cfg = get_config("granite-moe-3b-a800m").reduced()
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=0.1))
    lm = LM(cfg, seed=0, device=dev).eval()
    cpu = LM(cfg, seed=0, device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in lm.state_dict().items()})
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 32))
    with torch.no_grad():
        gl, gaux = lm.forward_lm(toks)
        cl, caux = cpu.forward_lm(toks)
    torch.testing.assert_close(gl.cpu(), cl, **TOL)
    torch.testing.assert_close(gaux.cpu(), caux, rtol=1e-5, atol=0)
    dropped = [int(b.moe.dropped) for b in lm.layers]
    assert dropped == [int(b.moe.dropped) for b in cpu.layers]
    assert sum(dropped) > 0
