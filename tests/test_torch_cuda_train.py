"""Decoder training on the card: what only a CUDA run can show.

Only torch and the port are imported, so ``PYTHONPATH=src python -m
pytest -q --noconftest tests/test_torch_cuda_train.py`` runs on the
card's machine; elsewhere every case skips.

* the serving kernels (flash and decode attention) refuse inputs that
  require grad while autograd records, and run under ``no_grad``;
* the in-place AdamW update equals ``update_fn`` + ``apply_updates`` on
  the card, bit for bit (the same ``_foreach`` ops);
* the cosine top-k kernel on bf16 q and keys against its plain version
  (indices equal, scores ``atol 1e-5``: both multiply the same values in
  float32, in another order), on the vector path (D a multiple of 4) and
  the element path (D = 37, and a base pointer off by one element);
* a reduced ``lm_loss`` on the card against the same model on the CPU,
  float32 with TF32 off: the loss ``rtol 1e-5``, every gradient relative
  L2 ``<= 1e-4`` (sums in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.cosine_topk import kernel as ct_kernel
from repro_torch.kernels.cosine_topk import ops as ct_ops
from repro_torch.kernels.cosine_topk import ref as ct_ref
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import LM
from repro_torch.training import adamw, apply_updates, schedule


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_refuse_autograd(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(2, 16, 4, 64, generator=g, device=dev).to(dtype)
    k = torch.randn(2, 16, 2, 64, generator=g, device=dev).to(dtype)
    valid = torch.ones(2, 16, dtype=torch.bool, device=dev)
    qg = q.clone().requires_grad_()
    q1 = q[:, :1].clone().requires_grad_()        # one decode step
    with pytest.raises(RuntimeError, match="lm_loss"):
        flash_ops.flash_attention(qg, k, k)
    with pytest.raises(RuntimeError, match="lm_loss"):
        decode_ops.decode_attention(q1, k, k, valid)
    with torch.no_grad():
        assert flash_ops.flash_attention(qg, k, k).shape == q.shape
        assert decode_ops.decode_attention(q1, k, k, valid).shape \
            == (2, 1, 4, 64)
    flash_ops.flash_attention(q, k, k)            # nothing requires grad


@pytest.mark.cuda
@pytest.mark.parametrize("wd,clip", [(0.0, 1.0), (0.01, 0.5)])
def test_in_place_update_equals_update_fn_on_the_card(dev, wd, clip):
    g = torch.Generator(device=dev).manual_seed(2)
    shapes = {"table": (1000, 96), "w": (96, 300), "b": (300,)}
    p1 = {k: torch.randn(s, generator=g, device=dev)
          for k, s in shapes.items()}
    p2 = {k: v.clone() for k, v in p1.items()}
    init, upd = adamw(schedule.linear_warmup_cosine(1e-2, 2, 10),
                      weight_decay=wd, max_grad_norm=clip)
    s1, s2 = init(p1), init(p2)
    for _ in range(3):
        grads = {k: torch.randn(s, generator=g, device=dev)
                 for k, s in shapes.items()}
        u, s1, m1 = upd({k: v.clone() for k, v in grads.items()}, s1, p1)
        apply_updates(p1, u)
        s2, m2 = upd.in_place({k: v.clone() for k, v in grads.items()}, s2,
                              p2)
        assert torch.equal(m1["grad_norm"], m2["grad_norm"])
        for k in shapes:
            assert torch.equal(p1[k], p2[k]), k
            assert torch.equal(s1.m[k], s2.m[k]), k
            assert torch.equal(s1.v[k], s2.v[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("D,offset", [(768, 0), (64, 0), (37, 0), (768, 1)])
@pytest.mark.parametrize("k", [1, 4, 16])
def test_cosine_topk_bf16_matches_plain_version(dev, D, offset, k):
    g = torch.Generator(device=dev).manual_seed(D + k + offset)
    N, Q = 3001, 19
    keys = torch.randn(N, D, generator=g, device=dev)
    keys = (keys / keys.norm(dim=-1, keepdim=True)).bfloat16()
    if offset:                        # base pointer 2 bytes off 8
        keys = torch.cat([keys.reshape(-1), keys.new_zeros(offset)])[
            offset:].reshape(N, D)
        assert keys.data_ptr() % 8
    q = keys[:Q].float() + 0.05 * torch.randn(Q, D, generator=g,
                                               device=dev)
    q = (q / q.norm(dim=-1, keepdim=True)).bfloat16()
    valid = torch.rand(N, generator=g, device=dev) >= 0.25
    before = ct_kernel.COUNTS["cosine_topk_bf16"]
    a = ct_ref.cosine_topk(q, keys, valid, k)
    b = ct_ops.cosine_topk(q, keys, valid, k)
    torch.cuda.synchronize()
    assert ct_kernel.COUNTS["cosine_topk_bf16"] == before + 1
    assert b[0].dtype == torch.float32 and b[1].dtype == torch.int32
    torch.testing.assert_close(b[0], a[0], rtol=0, atol=1e-5)
    assert torch.equal(b[1], a[1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["phi3-mini-3.8b", "granite-moe-3b-a800m"])
def test_lm_loss_on_the_card_matches_the_cpu(dev, name):
    cfg = get_config(name).reduced(remat=True)
    card = LM(cfg, seed=0, device=dev)
    cpu = LM(cfg, seed=0, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    lg, pg = card.lm_loss(torch.as_tensor(toks, device=dev))
    lc, pc = cpu.lm_loss(torch.as_tensor(toks))
    lg.backward()
    lc.backward()
    np.testing.assert_allclose(float(lg.detach()), float(lc.detach()),
                               rtol=1e-5)
    np.testing.assert_allclose(float(pg["aux"].detach()),
                               float(pc["aux"].detach()),
                               rtol=1e-5, atol=1e-7)
    grads = dict(cpu.named_parameters())
    for n, p in card.named_parameters():
        want = grads[n].grad.numpy()
        got = p.grad.cpu().numpy()
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= 1e-4, (n, rel)
