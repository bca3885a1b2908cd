"""Port parity for the encoder embedder: the reduced ``modernbert-149m``
(float32, a few layers, narrow widths) with the reference's own
``init_lm`` weights carried across, ``encode`` on padded tokens with a
mask, against the reference's ``encode``.

Tolerance: embeddings ``atol 1e-4`` at float32 (matmul and softmax sums
run in another order; the outputs are unit vectors).  The reference's
quirks are reproduced, not fixed: the mask only pools (pad positions
are attended to), GeLU is the tanh approximation, RoPE rotates halves.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import EmbedderTrainer as JEmbedderTrainer
from repro.core import FinetuneConfig as JFinetuneConfig
from repro.data import HashTokenizer as JHashTokenizer
from repro.models import encode as jencode
from repro.models import init_lm, split
from repro_torch.configs import get_config
from repro_torch.core import EmbedderTrainer, FinetuneConfig
from repro_torch.data import HashTokenizer
from repro_torch.models import Encoder, state_dict_from_reference

EMB_ATOL = 1e-4


def _reference(n_layers=3, seed=3):
    cfg = jget_config("modernbert-149m").reduced(n_layers=n_layers)
    pv, _ = split(init_lm(cfg, jax.random.PRNGKey(seed)))
    return cfg, pv, jax.tree_util.tree_map(np.asarray, pv)


def _port(tree, n_layers=3):
    cfg = get_config("modernbert-149m").reduced(n_layers=n_layers)
    enc = Encoder(cfg, device="cpu")
    enc.load_state_dict(state_dict_from_reference(tree, cfg))
    return enc.eval()


def _tokens(rng, B=4, S=16, vocab=512):
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    mask = np.ones((B, S), bool)
    for b, n in enumerate((S, 11, 5, 1)[:B]):
        mask[b, n:] = False
        toks[b, n:] = 0                       # PAD, still attended to
    return toks, mask


@pytest.mark.parametrize("use_mask", [True, False])
def test_encode_matches_reference(use_mask):
    cfg, pv, tree = _reference()
    enc = _port(tree)
    toks, mask = _tokens(np.random.default_rng(0))
    m = mask if use_mask else None
    a = np.asarray(jencode(pv, cfg, toks, m))
    with torch.no_grad():
        b = enc.encode(torch.as_tensor(toks),
                       None if m is None else torch.as_tensor(m)).numpy()
    assert b.shape == a.shape == (4, cfg.d_model) and b.dtype == np.float32
    np.testing.assert_allclose(b, a, rtol=0, atol=EMB_ATOL)
    np.testing.assert_allclose(np.linalg.norm(b, axis=-1), 1.0, atol=1e-5)


def test_pad_positions_are_attended_to():
    """The mask pools only: changing a pad token changes the embedding
    in both implementations, by the same amount."""
    cfg, pv, tree = _reference()
    enc = _port(tree)
    toks, mask = _tokens(np.random.default_rng(1))
    toks2 = toks.copy()
    toks2[2, -1] = 7                          # a pad slot of row 2
    outs = []
    for t in (toks, toks2):
        a = np.asarray(jencode(pv, cfg, t, mask))
        with torch.no_grad():
            b = enc.encode(torch.as_tensor(t), torch.as_tensor(mask)).numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=EMB_ATOL)
        outs.append(b)
    assert np.abs(outs[0][2] - outs[1][2]).max() > 1e-4


def test_embedder_trainer_matches_reference():
    """``embed_texts`` / ``pair_scores`` through the trainer, the
    reference's weights loaded as a port state dict."""
    cfg = jget_config("modernbert-149m").reduced(n_layers=2)
    ft = dict(max_len=16, seed=5)
    jt = JEmbedderTrainer(cfg, JFinetuneConfig(**ft))
    tree = jax.tree_util.tree_map(np.asarray, jt.params)
    pcfg = get_config("modernbert-149m").reduced(n_layers=2)
    pt = EmbedderTrainer(pcfg, FinetuneConfig(**ft),
                         params=state_dict_from_reference(tree, pcfg),
                         device="cpu")
    texts = ["how do I treat a heart attack", "symptoms of diabetes",
             "what causes migraines", ""]
    a = jt.embed_texts(texts, JHashTokenizer(cfg.vocab_size), batch_size=8)
    b = pt.embed_texts(texts, HashTokenizer(pcfg.vocab_size), batch_size=8)
    np.testing.assert_allclose(b, a, rtol=0, atol=EMB_ATOL)
    fn = pt.make_embed_fn(HashTokenizer(pcfg.vocab_size))
    np.testing.assert_allclose(fn(texts[:2]), b[:2], rtol=0, atol=1e-6)
    assert callable(pt.fit) and callable(pt.evaluate)   # the training half


def test_seeded_init_distributions():
    """The port's own init (no carried weights) draws the reference's
    distributions: normal(0.02) table, lecun-normal projections with
    the reference's fan-ins, unit/zero norms; seeded, so reproducible."""
    cfg = get_config("modernbert-149m").reduced(n_layers=2, d_model=128,
                                                d_ff=256)
    a, b = Encoder(cfg, seed=4, device="cpu"), Encoder(cfg, seed=4,
                                                       device="cpu")
    for (n1, p1), (_, p2) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p1, p2), n1
    sd = a.state_dict()
    d, f = cfg.d_model, cfg.d_ff
    for name, std in (("embed.table", 0.02),
                      ("layers.0.attn.wq", d ** -0.5),
                      ("layers.1.attn.wo", (cfg.n_heads * cfg.head_dim)
                       ** -0.5),
                      ("layers.0.mlp.w_gate", d ** -0.5),
                      ("layers.1.mlp.w_down", f ** -0.5)):
        assert abs(float(sd[name].std()) / std - 1) < 0.05, name
        assert abs(float(sd[name].mean())) < 0.1 * std, name
    assert torch.equal(sd["layers.0.norm1.scale"], torch.ones(d))
    assert torch.equal(sd["final_norm.bias"], torch.zeros(d))
    assert sd["layers.0.attn.wq"].dtype == torch.float32
    c = Encoder(cfg, seed=5, device="cpu").state_dict()
    assert not torch.equal(c["embed.table"], sd["embed.table"])
