"""The port's kernel build and launch geometry, on the CPU (no nvcc, no
card: nothing is compiled here).

* `_build.library_path` keys a library by its source, every header the
  source includes with quotes (the shared PTX wrappers in
  ``kernels/csrc/``) and the flags, so an edited header never loads a
  stale library; a missing header is an error, not a silent key.
* The cosine top-k kernel's splits of N cover every key row with
  non-empty splits of whole key tiles.
* The flash kernel's bf16 block size (2 warps of 16 query rows up to
  Sq = 32, else 4), and its bf16-accumulate route (one walk or two, the
  warps, the shared memory) at ``chip_smoke.py``'s flash shapes and
  route edges and every zoo decoder's prefill: within the block's
  shared memory, one walk exactly where the mode is dense and no block
  walks more than ``ONE_WALK_TILES`` tiles, the tiles counted as a plain
  mask counts them.
* The decode kernel's splits of the cache cover L exactly with whole
  64-row tiles and keep one split (one launch) when the units alone fill
  the card; which kernel (row or mma) a dtype and group width take.
* The cascade's scoring partition: the CTAs' chunks cover every hot row
  and every flat warm candidate position (probe-major, tail last) once,
  each into its own partial list.
* The contrastive forward's cooperative grid: its warps own every pair
  exactly once, the grid never exceeds the CTAs the card holds at once,
  and the training batch is one CTA.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ASSIGNED_ARCHS
from repro_torch.kernels import _build
from repro_torch.kernels.cascade_lookup import kernel as cl_kernel
from repro_torch.kernels.contrastive import kernel as co_kernel
from repro_torch.kernels.decode_attention import kernel as da_kernel
from repro_torch.kernels.cosine_topk import kernel as ct_kernel
from repro_torch.kernels.cosine_topk.kernel import SOURCE as CT_SOURCE
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ref as fa_ref

PTX = _build.INCLUDE_DIR / "ptx.cuh"
_SMOKE = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SMOKE)
_SMOKE.loader.exec_module(chip_smoke)


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A source including ``common.cuh`` from a private include
    directory, which itself includes ``leaf.cuh`` beside it."""
    inc = tmp_path / "include"
    inc.mkdir()
    (inc / "common.cuh").write_text('#pragma once\n#include "leaf.cuh"\n')
    (inc / "leaf.cuh").write_text("// leaf v1\n")
    src = tmp_path / "kern" / "kern.cu"
    src.parent.mkdir()
    src.write_text('#include <stdint.h>\n  #include "common.cuh"\n'
                   '// #include "not_a_file.cuh" is only a comment\n')
    monkeypatch.setattr(_build, "INCLUDE_DIR", inc)
    return src, inc


def test_library_path_changes_with_an_included_header(tree):
    src, inc = tree
    assert [p.name for p in _build.included_files(src)] == [
        "kern.cu", "common.cuh", "leaf.cuh"]
    before = _build.library_path(src)
    assert before.name.startswith("kern-") and before.suffix == ".so"
    assert _build.library_path(src) == before
    (inc / "leaf.cuh").write_text("// leaf v2\n")
    after = _build.library_path(src)
    assert after != before
    (inc / "unrelated.cuh").write_text("// not included\n")
    assert _build.library_path(src) == after


def test_a_header_beside_the_source_shadows_the_include_dir(tree):
    src, inc = tree
    (src.parent / "common.cuh").write_text("// local\n")
    assert [p.parent for p in _build.included_files(src)][1] == src.parent
    assert len(_build.included_files(src)) == 2


def test_a_missing_header_is_an_error(tree):
    src, _ = tree
    src.write_text('#include "nowhere.cuh"\n')
    with pytest.raises(FileNotFoundError, match="nowhere.cuh"):
        _build.library_path(src)


@pytest.mark.parametrize("source", [fa_kernel.SOURCE, CT_SOURCE,
                                    da_kernel.SOURCE, cl_kernel.SOURCE],
                         ids=lambda p: p.stem)
def test_redesigned_kernels_hash_the_shared_ptx_header(source):
    """The redesigned Hopper kernels include the shared wrappers, so
    editing them rebuilds every one."""
    assert PTX.resolve() in _build.included_files(source)


@pytest.mark.parametrize("Q,N", [(64, 4096), (64, 65536), (33, 4099),
                                 (1, 1), (130, 31), (64, 5), (1000, 10 ** 6)])
@pytest.mark.parametrize("n_sm", [132, 8])
@pytest.mark.parametrize("per_sm", [2, 1])     # k <= 8, k > 8
def test_cosine_topk_splits_cover_n(Q, N, n_sm, per_sm):
    q_tile = 64
    k_tile = ct_kernel.key_tile(Q, N, n_sm, q_tile, per_sm)
    S, rows = ct_kernel.splits(Q, N, n_sm, q_tile, k_tile, per_sm)
    assert rows % k_tile == 0 and rows > 0
    assert (S - 1) * rows < N <= S * rows       # every split non-empty
    assert S <= -(-N // k_tile)
    blocks = -(-Q // q_tile) * S
    # enough blocks to fill the card, unless N has too few key tiles
    assert blocks >= min(per_sm * n_sm,
                         -(-Q // q_tile) * -(-N // k_tile)) // 2


def test_cosine_topk_splits_at_the_flat_cache():
    """Q = 64 at the flat cache's 4096 rows on 132 SMs: one 32-row key
    tile per block, 128 blocks; at 65536 rows four 64-row tiles a block,
    256 blocks."""
    assert ct_kernel.splits(64, 4096, 132, 64, 32, 2) == (128, 32)
    assert ct_kernel.splits(64, 65536, 132, 64, 64, 2) == (256, 256)


@pytest.mark.parametrize("Q,N,n_sm,tile", [
    (64, 4096, 132, 32),     # the flat cache: 32-row tiles, 128 blocks
    (64, 65536, 132, 64),    # a large panel: 64-row tiles
    (33, 4099, 132, 32),
    (256, 16384, 132, 64),   # four query tiles share the card
    (256, 2048, 132, 32),
    (64, 4096, 8, 64),       # a small card
])
def test_cosine_topk_key_tile(Q, N, n_sm, tile):
    assert ct_kernel.key_tile(Q, N, n_sm, 64, 2) == tile
    assert tile in ct_kernel.KEY_TILES


@pytest.mark.parametrize("Sq,warps", [(1, 2), (32, 2), (33, 4), (2048, 4)])
def test_flash_bf16_block_size(Sq, warps):
    assert fa_kernel.warps(Sq) == warps


def _zoo_prefills():
    """(name, S, hd) of each attention decoder's prefill in
    `chip_smoke.py` (its prompt behind the frontend's frames)."""
    out = []
    for name in ASSIGNED_ARCHS:
        cfg = get_config(name)
        if any(spec.mixer == "attn" for spec in cfg.period):
            S = chip_smoke.GEN_PROMPT + (cfg.frontend_len
                                         if cfg.frontend else 0)
            out.append((name, S, cfg.head_dim))
    return out


ROUTE_SHAPES = ([(n, S, hd, c, w) for n, _, _, _, S, hd, c, w in
                 chip_smoke.FLASH_SHAPES + chip_smoke.FLASH_ACC_BF16_EDGES]
                + [(n, S, hd, True, 0) for n, S, hd in _zoo_prefills()]
                + [(f"1024-key chunks hd {hd} S={S}", S, hd, True, 0)
                   for hd in (96, 128) for S in (2049, 4096, 32768)])


@pytest.mark.parametrize("name,S,hd,causal,window", ROUTE_SHAPES,
                         ids=[r[0] for r in ROUTE_SHAPES])
def test_flash_acc_bf16_route(name, S, hd, causal, window):
    chunk = fa_ref.kv_chunk_for(S, S)
    r = fa_kernel.acc_bf16_route(S, S, hd, causal, window, chunk)
    need = fa_kernel.tiles_per_chunk(S, S, 16 * r.warps, causal, window,
                                     chunk)
    assert r.warps == fa_kernel.warps(S)
    assert r.smem == fa_kernel.acc_bf16_smem(hd, r.warps, chunk > 0, r.cap)
    assert r.smem <= fa_kernel.SMEM_LIMIT
    if chunk == 0 and need <= fa_kernel.ONE_WALK_TILES:
        assert (r.route, r.cap) == ("one walk", need)
    else:
        assert (r.route, r.cap) == ("two walks", 0)
    # the decoders' 32-token prompts walk their keys once; the 288-row
    # frontend prefills and the reference's 1024-key chunks twice
    if S <= chip_smoke.GEN_PROMPT:
        assert r.route == "one walk"
    if chunk or S >= 288:
        assert r.route == "two walks"


@pytest.mark.parametrize("name,S,hd,causal,window", ROUTE_SHAPES,
                         ids=[r[0] for r in ROUTE_SHAPES])
def test_flash_acc_bf16_route_float32(name, S, hd, causal, window):
    """The float32 inputs' bf16-accumulate launch takes the bf16 one's
    route and warps, with its own shared memory, within the card's: the
    most its layout takes (the q tile in float32, two ring slots of a
    tile of (hd + 4)-float rows, the kept tiles)."""
    chunk = fa_ref.kv_chunk_for(S, S)
    r = fa_kernel.acc_bf16_route(S, S, hd, causal, window, chunk, True)
    b = fa_kernel.acc_bf16_route(S, S, hd, causal, window, chunk)
    assert (r.warps, r.cap) == (b.warps, b.cap)
    assert r.smem == fa_kernel.f32_acc_bf16_smem(hd, r.warps, r.cap)
    assert r.smem <= fa_kernel.SMEM_LIMIT


@pytest.mark.parametrize("Sq,Skv,causal,window,kv_chunk", [
    (77, 77, True, 0, 0), (300, 300, True, 0, 100), (300, 300, True, 70, 100),
    (130, 130, False, 0, 48), (70, 70, False, 20, 0), (33, 80, True, 0, 0),
    (2100, 2100, True, 700, 1024), (1, 1, True, 0, 0)])
@pytest.mark.parametrize("rows", [32, 64])
def test_flash_tiles_per_chunk_counts_the_walk(Sq, Skv, causal, window,
                                               kv_chunk, rows):
    """The tiles a block walks in each chunk, from a plain mask: from the
    tile (counted from the chunk's start) holding the first key any of its
    rows reaches to the one holding the last."""
    T, C = fa_kernel.TILE, kv_chunk or Skv
    ok = fa_ref.position_mask(Sq, Skv, causal=causal, window=window)
    most = 0
    for q0 in range(0, Sq, rows):
        cols = ok[q0:q0 + rows].any(0).nonzero()[:, 0].tolist()
        lo, hi = min(cols), max(cols)
        for c in range(lo // C, hi // C + 1):
            first = max(lo, c * C) - c * C
            last = min(hi, c * C + C - 1) - c * C
            most = max(most, last // T - first // T + 1)
    assert fa_kernel.tiles_per_chunk(Sq, Skv, rows, causal, window,
                                     kv_chunk) == most


@pytest.mark.parametrize("B,KV,L", [(8, 32, 64), (8, 32, 4096),
                                    (1, 8, 32768), (8, 2, 4096), (2, 40, 77),
                                    (1, 1, 1), (3, 4, 300), (1, 8, 65),
                                    (1, 1, 10 ** 6)])
@pytest.mark.parametrize("n_sm", [132, 8])
def test_decode_splits_cover_l(B, KV, L, n_sm):
    S, rows = da_kernel.splits(B, KV, L, n_sm)
    assert rows > 0 and rows % da_kernel.TILE == 0
    assert (S - 1) * rows < L <= S * rows       # every split non-empty
    if B * KV >= n_sm:
        assert S == 1
    else:      # enough CTAs to fill the card, unless L has too few tiles
        assert B * KV * S >= min(da_kernel.BLOCKS_PER_SM * n_sm,
                                 B * KV * -(-L // da_kernel.TILE)) // 2


def test_decode_splits_at_the_decoders_shapes():
    """Phi-3-mini's decode step (B=8, H=KV=32): 256 row-kernel CTAs, one
    split, one launch; a ring of L=4096 likewise.  GQA at batch 1 (H=40,
    KV=8) and MQA at batch 8 (H=32, KV=1: two 16-head mma tiles) split
    L to reach 256 CTAs."""
    assert da_kernel.units(32, 32, False) == 32
    assert da_kernel.splits(8, 32, 64, 132) == (1, 64)
    assert da_kernel.splits(8, 32, 4096, 132) == (1, 4096)
    assert da_kernel.units(40, 8, True) == 8
    assert da_kernel.splits(1, 8, 32768, 132) == (32, 1024)
    assert da_kernel.units(32, 1, True) == 2
    assert da_kernel.splits(8, 2, 4096, 132) == (16, 256)


@pytest.mark.parametrize("dtype,G,mma", [
    (torch.bfloat16, 1, False), (torch.bfloat16, 3, False),
    (torch.bfloat16, 4, True), (torch.bfloat16, 32, True),
    (torch.float32, 1, False), (torch.float32, 32, False)])
def test_decode_kernel_choice(dtype, G, mma):
    assert da_kernel.uses_mma(dtype, G) == mma


@pytest.mark.parametrize("Q,Nh,K,n_probe,bucket,tail", [
    (64, 1024, 64, 8, 256, 256),    # the serving shapes
    (17, 300, 8, 4, 96, 48),        # the card tests' tiers
    (5, 8, 2, 2, 8, 3),
    (1, 1, 1, 1, 1, 0),             # no tail
    (33, 65, 3, 3, 130, 200),       # ragged everywhere
])
def test_cascade_partition_covers_every_candidate_once(Q, Nh, K, n_probe,
                                                       bucket, tail):
    g = cl_kernel.geometry(Q, Nh, K, n_probe, bucket, tail)
    hot = cl_kernel.hot_spans(g, Nh)
    warm = cl_kernel.warm_spans(g, bucket, tail)
    for spans, n in ((hot, Nh), (warm, n_probe * bucket + tail)):
        covered = [p for _, first, m in spans
                   for p in range(first, first + m)]
        assert all(m > 0 for _, _, m in spans)
        assert covered == list(range(n))
    lists = [i for i, _, _ in hot + warm]
    assert sorted(lists) == list(range(g.n_part))
    assert (g.q_tiles - 1) * cl_kernel.QUERY_TILE < Q \
        <= g.q_tiles * cl_kernel.QUERY_TILE
    assert g.ctas == g.q_tiles * (g.hot_chunks + g.tail_chunks
                                  + K * g.bucket_chunks)


def test_cascade_partition_at_the_serving_shapes():
    """Q=64, Nh=1024, K=64, n_probe=8, bucket=256, tail=256: 4 query
    tiles; 16 hot, 4 bucket and 4 tail chunks of 64 rows; 52 partial
    lists per query; 1104 CTAs, of which those of unprobed buckets (and
    query tiles past a bucket's queries) return at once."""
    g = cl_kernel.geometry(64, 1024, 64, 8, 256, 256)
    assert (g.q_tiles, g.hot_chunks, g.bucket_chunks, g.tail_chunks) \
        == (4, 16, 4, 4)
    assert g.n_part == 52 and g.ctas == 1104


@pytest.mark.parametrize("B", [1, 16, 37, 300, 4096, 4097])
@pytest.mark.parametrize("n_sm,ctas", [(132, 1), (132, 2), (8, 1), (8, 3)])
def test_contrastive_geometry_covers_every_pair_once(B, n_sm, ctas):
    """Warp w of CTA c owns rows (k * grid + c) * WARPS + w, k <
    rows_per_warp, below B (the kernel's loop): every pair once, no warp
    past its last row's chunk, the grid within the co-resident limit."""
    grid, rows_per_warp = co_kernel.geometry(B, n_sm, ctas)
    W = co_kernel.WARPS
    assert 1 <= grid <= n_sm * ctas
    owned = [(k * grid + c) * W + w for c in range(grid) for w in range(W)
             for k in range(rows_per_warp) if (k * grid + c) * W + w < B]
    assert sorted(owned) == list(range(B))
    assert (rows_per_warp - 1) * grid * W < B     # no empty last round
    if B <= n_sm * ctas * W:
        assert rows_per_warp == 1 and grid == -(-B // W)


@pytest.mark.parametrize("n_sm", [132, 8])
def test_contrastive_geometry_caps_the_grid(n_sm):
    """Past the co-resident rows the grid stays at n_sm * ctas and the
    warps take more rows each."""
    for ctas in (1, 2):
        cap = n_sm * ctas
        assert co_kernel.geometry(cap * co_kernel.WARPS, n_sm, ctas) \
            == (cap, 1)
        assert co_kernel.geometry(cap * co_kernel.WARPS + 1, n_sm, ctas) \
            == (cap, 2)
        assert co_kernel.geometry(10 ** 6, n_sm, ctas)[0] == cap


def test_contrastive_geometry_at_the_training_batch():
    """The paper's batch of 16 pairs is one CTA, one row per warp: its
    grid barriers are __syncthreads.  B = 4096 is 256 CTAs where the
    card holds two per SM, 132 (two rows a warp) where it holds one."""
    assert co_kernel.geometry(16, 132, 1) == (1, 1)
    assert co_kernel.geometry(4096, 132, 2) == (256, 1)
    assert co_kernel.geometry(4096, 132, 1) == (132, 2)


@pytest.mark.parametrize("B,n_sm,ctas", [(0, 132, 1), (16, 132, 0),
                                         (16, 0, 1)])
def test_contrastive_geometry_refuses_an_empty_grid(B, n_sm, ctas):
    with pytest.raises(ValueError, match="no geometry"):
        co_kernel.geometry(B, n_sm, ctas)
