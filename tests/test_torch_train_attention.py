"""Port parity for the training attention: the masked ``gqa_attention``
(dense, and the chunked online softmax above 2048 keys),
``local_window_attention``, and the encoder past 2048 tokens, forward and
gradient, against the reference's functions on the same numpy inputs.

Heads are tiny (H = 4 over KV = 2, hd = 8) so the chunked branch runs at
S = 2049 (a ragged last chunk: padded with position -1, ``valid=False``)
and S = 4096 on the CPU.  Gradients are taken with one numpy cotangent on
both sides (``jax.vjp`` / ``torch.autograd.grad``).

Tolerances: outputs ``atol 1e-5`` and gradients relative L2 ``<= 1e-4``
(float32 sums in another order); embeddings ``atol 1e-4`` (as
`tests/test_torch_encoder.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import encode as jencode
from repro.models import init_lm, split
from repro.models import attention as jattn
from repro_torch.configs import get_config
from repro_torch.models import Encoder, attention, state_dict_from_reference

H, KV, HD = 4, 2, 8


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _qkv(seed, B, Sq, Skv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, HD)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, HD)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, HD)).astype(np.float32),
            rng.standard_normal((B, Sq, H, HD)).astype(np.float32))


def _check(jfn, pfn, q, k, v, ct):
    """Forward and the vjp of ``ct`` through both functions."""
    want, vjp = jax.vjp(jax.jit(jfn), jnp.asarray(q), jnp.asarray(k),
                        jnp.asarray(v))
    jgrads = vjp(jnp.asarray(ct))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    got = pfn(*ts)
    pgrads = torch.autograd.grad(got, ts, torch.tensor(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    for name, a, b in zip("qkv", pgrads, jgrads):
        assert _rel_l2(a.numpy(), np.asarray(b)) <= 1e-4, name


# (causal, window, kv_valid): every mask of ``_mask_logits``
DENSE = {"causal": (True, 0, False), "window": (True, 5, False),
         "bidirectional": (False, 0, False),
         "bidirectional_window": (False, 4, False),
         "kv_valid": (True, 0, True)}


@pytest.mark.parametrize("case", list(DENSE))
def test_dense_gqa_attention_matches_reference(case):
    causal, window, with_valid = DENSE[case]
    B, S = 2, 19
    q, k, v, ct = _qkv(len(case), B, S, S)
    pos = np.arange(S, dtype=np.int32)
    valid = np.random.default_rng(3).random((B, S)) < 0.8
    valid[:, 0] = True
    kw = dict(causal=causal, window=window)

    def jfn(q, k, v):
        return jattn.gqa_attention(
            q, k, v, q_pos=jnp.asarray(pos), kv_pos=jnp.asarray(pos),
            kv_valid=jnp.asarray(valid) if with_valid else None, **kw)

    def pfn(q, k, v):
        return attention.gqa_attention(
            q, k, v, q_pos=torch.tensor(pos), kv_pos=torch.tensor(pos),
            kv_valid=torch.tensor(valid) if with_valid else None, **kw)

    _check(jfn, pfn, q, k, v, ct)


@pytest.mark.parametrize("S,causal", [(2049, True), (4096, True),
                                      (2049, False)])
def test_chunked_gqa_attention_matches_reference(S, causal):
    """Above ``CHUNK_THRESHOLD`` keys both sides take the online softmax
    over 1024-key chunks; 2049 keys leave a last chunk of one real key."""
    assert S > attention.CHUNK_THRESHOLD
    q, k, v, ct = _qkv(S, 1, S, S)
    pos = np.arange(S, dtype=np.int32)

    def jfn(q, k, v):
        return jattn.gqa_attention(q, k, v, q_pos=jnp.asarray(pos),
                                   kv_pos=jnp.asarray(pos), causal=causal,
                                   window=0)

    def pfn(q, k, v):
        return attention.gqa_attention(q, k, v, q_pos=torch.tensor(pos),
                                       kv_pos=torch.tensor(pos),
                                       causal=causal, window=0)

    _check(jfn, pfn, q, k, v, ct)


@pytest.mark.parametrize("S,W,q_chunk", [(100, 16, 16), (67, 8, 8),
                                         (64, 20, 32)])
def test_local_window_attention_matches_reference(S, W, q_chunk):
    """Query chunks of ``q_chunk`` over (window + chunk) keys; S = 67 and
    100 leave a ragged last chunk."""
    q, k, v, ct = _qkv(S + W, 2, S, S)
    pos = np.arange(S, dtype=np.int32)

    def jfn(q, k, v):
        return jattn.local_window_attention(
            q, k, v, positions=jnp.asarray(pos), window=W, causal=True,
            q_chunk=q_chunk)

    def pfn(q, k, v):
        return attention.local_window_attention(
            q, k, v, positions=torch.tensor(pos), window=W, causal=True,
            q_chunk=q_chunk)

    _check(jfn, pfn, q, k, v, ct)


def test_encoder_past_2048_tokens_matches_reference():
    """The encoder's bidirectional attention takes the chunked branch at
    S = 2049 (the port refused it before); embeddings against the
    reference's ``encode``."""
    jcfg = jget_config("modernbert-149m").reduced(n_layers=2)
    pcfg = get_config("modernbert-149m").reduced(n_layers=2)
    pv, _ = split(init_lm(jcfg, jax.random.PRNGKey(3)))
    enc = Encoder(pcfg, device="cpu")
    enc.load_state_dict(state_dict_from_reference(
        jax.tree_util.tree_map(np.asarray, pv), pcfg))
    toks = np.random.default_rng(4).integers(
        0, pcfg.vocab_size, (1, 2049)).astype(np.int32)
    want = np.asarray(jencode(pv, jcfg, jnp.asarray(toks)))
    with torch.no_grad():
        got = enc.encode(torch.as_tensor(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
