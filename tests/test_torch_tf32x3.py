"""The float32 flash kernels' 3xTF32 products, emulated on the CPU.

The card's float32 flash-attention kernels run both products (q k^T and
P V) on TF32 tensor cores in 3xTF32: each float32 operand x is split
into big = cvt.rna.tf32.f32(x) and small = x - big (exact), of which the
tensor cores read the leading 10 mantissa bits (truncation), and a b is
summed as a_small b_big + a_big b_small + a_big b_big in float32.  Here
`tf32` rounds as ``cvt.rna`` does (to 10 mantissa bits, ties away from
zero, on the float32 bit pattern) and `tf32_trunc` as the tensor cores
read a register, the three products' sums are taken in float64 (each
product of two tf32 values is exact), and the attention output built
from them is held to the float32 plain version (`ref.flash_attention`)
within ``ATTN_TOL["float32"]``, the card's tolerance; one TF32 product
(a_big b_big alone) misses it, which is why the kernels do not use it.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ref

ATTN_TOL = dict(atol=2e-5, rtol=1e-4)     # chip_smoke.ATTN_TOL["float32"]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest tf32 value, ties away from zero (cvt.rna):
    add half of the 13 dropped bits' unit to the magnitude's bit pattern,
    then clear them."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """float32 -> tf32 toward zero: the 13 low bits cleared."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    return (b & -0x2000).view(torch.float32)


def product(a: torch.Tensor, b: torch.Tensor, split: bool) -> torch.Tensor:
    """a @ b (float32 operands) from TF32 products summed in float64:
    3xTF32 when ``split``, else one TF32 product; rounded to float32 as
    the kernels' accumulators hold it."""
    ab, bb = tf32(a), tf32(b)
    out = ab.double() @ bb.double()
    if split:
        a_s, b_s = tf32_trunc(a - ab), tf32_trunc(b - bb)
        out = a_s.double() @ bb.double() + ab.double() @ b_s.double() + out
    return out.float()


def attention(q, k, v, scale, split: bool) -> torch.Tensor:
    """Causal attention, (H, S, hd) each, with both products in TF32: the
    scores in float32, the weights exp(s - m) in float32, divided by their
    float32 sum after P V (the kernels' order)."""
    S = q.shape[1]
    s = product(q * scale, k.transpose(1, 2), split)
    s = torch.where(ref.position_mask(S, S, causal=True, window=0), s,
                    ref.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return product(p, v, split) / p.sum(-1, keepdim=True)


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    x = torch.tensor([one + 2.0 ** -12, one + 2.0 ** -11, one + 3 * 2.0 ** -11,
                      -(one + 2.0 ** -11), one + 2.0 ** -10, 3.0 - 2.0 ** -22])
    want = torch.tensor([one, one + 2.0 ** -10, one + 2.0 ** -9,
                         -(one + 2.0 ** -10), one + 2.0 ** -10, 3.0])
    assert torch.equal(tf32(x), want)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096).astype(np.float32))
    big = tf32(y)
    assert torch.all((big.view(torch.int32) & 0x1FFF) == 0)
    assert float(((y - big) / y).abs().max()) <= 2.0 ** -11
    assert float(((y - big - tf32(y - big)) / y).abs().max()) <= 2.0 ** -22
    small = tf32_trunc(y - big)
    assert torch.all(small.abs() <= (y - big).abs())
    assert float(((y - big - small) / y).abs().max()) <= 2.0 ** -21


@pytest.mark.parametrize("scale", [None, 0.3], ids=["hd^-0.5", "0.3"])
@pytest.mark.parametrize("hd", [32, 64, 96, 128])
def test_3xtf32_attention_is_float32_accurate_and_one_tf32_is_not(hd, scale):
    """Phi-3-mini's prefill heads (S = 32 causal rows, randn q, k, v as
    `chip_smoke.py` draws them), 4 heads."""
    rng = np.random.default_rng(hd)
    q, k, v = (torch.from_numpy(rng.standard_normal((4, 32, hd)).astype(
        np.float32)) for _ in range(3))
    sc = hd ** -0.5 if scale is None else scale
    want = ref.flash_attention(q[None], k[None], v[None], causal=True,
                               scale=sc)[0]
    torch.testing.assert_close(attention(q, k, v, sc, split=True), want,
                               **ATTN_TOL)
    one = attention(q, k, v, sc, split=False)
    bad = (one - want).abs() > ATTN_TOL["atol"] + ATTN_TOL["rtol"] * \
        want.abs()
    assert bad.any(), float((one - want).abs().max())
