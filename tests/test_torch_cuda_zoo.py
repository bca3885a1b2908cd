"""The rest of the decoder zoo on the card: what only a CUDA run can show.

Only torch and the port are imported, so ``PYTHONPATH=src python -m
pytest -q --noconftest tests/test_torch_cuda_zoo.py`` runs on the card's
machine; elsewhere every case skips.

* the new mixers (Mamba, mLSTM, sLSTM) on the card against the CPU's
  plain path with the same weights: the full sequence, the prefill state
  and every decode step's output and state (``atol 2e-4, rtol 1e-3``,
  float32; in bf16, where the card's and the CPU's bf16 products round
  at other places, ``atol 6.25e-2`` (8 bf16 ulps at 1.0), ``rtol 3e-2``
  and a mean |diff| of at most ``1e-2``, as `tests/test_torch_xlstm.py`
  holds the port to the reference);
* the four new decoders at reduced size (Jamba with its attention layer,
  xLSTM, MusicGen and Pixtral with their frontend frames): prefill and
  every decode step's logits on the card against the CPU, one flash
  launch per attention layer a prefill and one decode launch per
  attention layer a step;
* flash and decode attention at the zoo's shapes (MusicGen's MHA over a
  288-position prefill, Pixtral's head width 128 at GQA group 4, Jamba's
  group 8) against their plain versions, bf16 and float32 (the
  tolerances of `tests/test_torch_cuda_kernels.py`).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ATTN
from repro_torch.kernels.decode_attention import kernel as decode_kernel
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention import ref as decode_ref
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.models import LM, mamba, xlstm
from repro_torch.models.attention import decode_mask
from repro_torch.models.param import make_initializer
from repro_torch.serving import frontend

TOL = {"float32": dict(atol=2e-4, rtol=1e-3),
       "bfloat16": dict(atol=6.25e-2, rtol=3e-2)}
BF16_MEAN_TOL = 1e-2
ATTN_TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4),
            torch.bfloat16: dict(atol=3e-2, rtol=0.0)}
JAMBA = "jamba-1.5-large-398b"
MIXERS = {"mamba": (JAMBA, mamba.Mamba, mamba.init_state),
          "mlstm": ("xlstm-125m", xlstm.MLSTM, xlstm.init_mlstm_state),
          "slstm": ("xlstm-125m", xlstm.SLSTM, xlstm.init_slstm_state)}
# (name, B, H, KV, S, hd): the zoo's prefills on the card
FLASH_SHAPES = (("musicgen prefill", 8, 32, 32, 288, 64),
                ("pixtral prefill", 8, 32, 8, 288, 128),
                ("jamba prefill", 8, 64, 8, 32, 128))
# (name, B, H, KV, L, hd, cur): their decode steps
DECODE_SHAPES = (("musicgen decode", 8, 32, 32, 320, 64, 300),
                 ("pixtral decode", 8, 32, 8, 320, 128, 300),
                 ("jamba decode", 8, 64, 8, 64, 128, 48))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run on the H100)")
    return torch.device("cuda")


def _np(t):
    return t.float().cpu().numpy()


def _assert_close(got, want, dtype, what=""):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, err_msg=what, **TOL[dtype])
    if dtype == "bfloat16":
        assert np.abs(got - want).mean() <= BF16_MEAN_TOL, what


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", list(MIXERS))
def test_mixer_on_the_card_matches_the_cpu(dev, kind, dtype):
    name, module, init_state = MIXERS[kind]
    cfg = get_config(name).reduced(dtype=dtype)
    card = module(make_initializer(cfg, 0, dev), cfg).eval()
    cpu = module(make_initializer(cfg, 0, "cpu"), cfg).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (2, 12, cfg.d_model)), dtype=getattr(torch, dtype))
    sg, sc = init_state(cfg, 2, dev), init_state(cfg, 2, "cpu")
    with torch.no_grad():
        yg = card.prefill(x[:, :8].to(dev), sg)
        yc = cpu.prefill(x[:, :8], sc)
        _assert_close(yg, yc, dtype)
        for t in range(8, 12):
            yg = card.decode(x[:, t:t + 1].to(dev), sg)
            yc = cpu.decode(x[:, t:t + 1], sc)
            _assert_close(yg, yc, dtype)
        for n in sc:
            assert sg[n].dtype == sc[n].dtype and sg[n].device.type == "cuda"
            _assert_close(sg[n], sc[n], dtype, n)


def _zoo_cfg(name):
    cfg = get_config(name)
    if name == JAMBA:       # keep the attention layer (period position 4)
        return cfg.reduced(period=cfg.period[1:5], n_layers=4)
    return cfg.reduced()


@pytest.mark.cuda
@pytest.mark.parametrize("name", [JAMBA, "xlstm-125m", "musicgen-large",
                                  "pixtral-12b"])
def test_zoo_decoder_on_the_card_matches_the_cpu(dev, name):
    cfg = _zoo_cfg(name)
    lm = LM(cfg, seed=0, device=dev).eval()
    cpu = LM(cfg, seed=0, device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in lm.state_dict().items()})
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 20))
    fe = frontend.stub_frontend_embeds(cfg, 3, device="cpu")
    n_fe = 0 if fe is None else cfg.frontend_len
    n_attn = sum(s.mixer == ATTN for s in cfg.layer_specs())
    flash_kernel.COUNTS["flash_attention"] = 0
    decode_kernel.COUNTS["decode_attention"] = 0
    gl, gs = lm.prefill(toks[:, :12], n_fe + 20,
                        None if fe is None else fe.to(dev))
    cl, cs = cpu.prefill(toks[:, :12], n_fe + 20, fe)
    torch.testing.assert_close(gl.cpu(), cl, **TOL["float32"])
    assert flash_kernel.COUNTS["flash_attention"] == n_attn
    for t in range(12, 20):
        gl, gs = lm.decode_step(gs, toks[:, t:t + 1])
        cl, cs = cpu.decode_step(cs, toks[:, t:t + 1])
        torch.testing.assert_close(gl.cpu(), cl, **TOL["float32"])
    assert decode_kernel.COUNTS["decode_attention"] == n_attn * 8
    assert gs["cur_len"] == cs["cur_len"] == n_fe + 20


def _qkv(dev, dtype, B, H, KV, S, hd, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(B, S, H, hd, generator=g, device=dev).to(dtype),
            torch.randn(B, S, KV, hd, generator=g, device=dev).to(dtype),
            torch.randn(B, S, KV, hd, generator=g, device=dev).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: s[0])
def test_flash_at_zoo_shapes(dev, shape, dtype):
    _, B, H, KV, S, hd = shape
    q, k, v = _qkv(dev, dtype, B, H, KV, S, hd, seed=S + H)
    got = flash_ops.flash_attention(q, k, v, causal=True)
    want = flash_ref.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2)).transpose(1, 2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", DECODE_SHAPES, ids=lambda s: s[0])
def test_decode_at_zoo_shapes(dev, shape, dtype):
    _, B, H, KV, L, hd, cur = shape
    q, _, _ = _qkv(dev, dtype, B, H, KV, 1, hd, seed=L + H)
    _, k, v = _qkv(dev, dtype, B, H, KV, L, hd, seed=L + H + 1)
    slot = torch.arange(L, device=dev)
    pos = torch.where(slot <= cur, slot, -1).expand(B, L).contiguous()
    valid = decode_mask(pos, cur, 0)
    got = decode_ops.decode_attention(q, k, v, valid)[:, 0]
    want = decode_ref.decode_attention(q[:, 0], k, v, valid)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])
