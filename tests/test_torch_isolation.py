"""The port stands alone: nothing under ``src/repro_torch/``, nor
``chip_smoke.py`` or the port's example, imports JAX, the reference
package or the reference's benchmarks (nor loads a module from a file
path, as the reference's ``serve --scenario`` loads its benchmark's);
the entry points (the decoder and its launcher included) refuse
to run on a card that is absent rather than continue on the CPU; no
kernel wrapper has a fallback path."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
STANDALONE = sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "serve_with_cache_torch.py",
    ROOT / "examples" / "finetune_embedder_torch.py",
    ROOT / "tests" / "test_torch_cuda_kernels.py",      # run on the card
    ROOT / "tests" / "test_torch_cuda_zoo.py",
    ROOT / "tests" / "test_torch_cuda_train.py",
    ROOT / "tests" / "torch_flash_routes.py",
    ROOT / "tests" / "torch_flash_variants.py",
    ROOT / "tests" / "torch_topk_variants.py",
    ROOT / "tests" / "torch_jamba_gap.py",
    ROOT / "tests" / "test_torch_ranks.py"]      # the sharded tests' ranks
KERNELS = ("cascade_lookup", "cosine_topk", "contrastive",
           "flash_attention", "decode_attention")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", STANDALONE,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro", "flax", "optax",
                        "msgpack", "ml_dtypes", "benchmarks", "scenarios",
                        "bench_scenarios"}, roots


@pytest.mark.parametrize("path", [p for p in STANDALONE
                                  if PORT in p.parents],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_loaded_from_a_file_path(path):
    """The port keeps its own copy of what it needs (the scenario traces
    and their replay among them): no module of it loads another by path."""
    assert "spec_from_file_location" not in path.read_text()


def test_the_slice_modules_are_covered():
    names = {str(p.relative_to(PORT)) for p in STANDALONE if PORT in p.parents}
    for mod in ("core/losses.py", "core/store.py", "core/cache.py",
                "core/metrics.py", "core/synth.py", "data/pairs.py",
                "core/embedders.py", "cache_service/feedback.py",
                "cache_service/tiers.py", "cache_service/service.py",
                "training/optim.py", "kernels/_build.py",
                "models/attention.py", "models/model.py",
                "models/mamba.py", "models/xlstm.py", "models/scan.py",
                "serving/engine.py", "serving/frontend.py",
                "launch/serve.py", "launch/train.py",
                "launch/scenarios.py", "launch/replay.py",
                "launch/mesh.py", "core/distrib.py",
                "launch/sharding.py", "launch/programs.py",
                "launch/roofline.py", "launch/dryrun.py",
                "launch/localcost.py", "models/actsharding.py",
                "models/blocks.py", "models/param.py",
                "training/schedule.py", "training/train.py",
                "training/checkpoint.py", "training/msgpack_lite.py",
                *(f"kernels/{k}/{f}.py" for k in KERNELS
                  for f in ("kernel", "ref", "ops"))):
        assert mod in names, mod


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_wrapper_has_no_fallback(name):
    """ops.py dispatches on the device alone: no try/except that could
    route a card's tensors to the plain version."""
    src = (PORT / "kernels" / name / "ops.py").read_text()
    assert not any(isinstance(n, ast.Try) for n in ast.walk(ast.parse(src)))


def test_plain_version_only_for_cpu_tensors(monkeypatch):
    """Only CPU tensors reach the plain version: tensors on any other
    device go to the kernel or are refused (here: 'meta')."""
    from repro_torch.cache_service import tiers
    from repro_torch.kernels.cascade_lookup import ops, ref

    def forbidden(*a, **k):
        raise AssertionError("plain version called for non-CPU tensors")

    monkeypatch.setattr(ref, "cascade_lookup", forbidden)
    monkeypatch.setattr(ref, "ensemble_lookup", forbidden)
    hot, warm = tiers.init_hot(8, 4, "meta"), tiers.init_warm(16, 4, 2, 4,
                                                              "meta")
    ens = tiers.init_ensemble(2, hot, warm)
    q = torch.zeros(3, 4, device="meta")
    qt = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.cascade_lookup(
            q, qt, q[:, 0], hot.keys, hot.valid, hot.tenants, hot.value_ids,
            warm.keys, warm.valid, warm.tenants, warm.value_ids,
            warm.write_seq, warm.centroids, warm.members, warm.cursor,
            warm.indexed_total, warm.keys_q, warm.scales, k=1)
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    monkeypatch.setattr(fa_ref, "flash_attention", forbidden)
    monkeypatch.setattr(da_ref, "decode_attention", forbidden)
    x = torch.zeros(2, 5, 4, 32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa_ops.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="cpu or cuda"):
        da_ops.decode_attention(x[:, :1], x, x,
                                torch.ones(2, 5, dtype=torch.bool,
                                           device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.ensemble_lookup(
            torch.stack([q, q]), q[:, :2], qt, q[:, 0], ens.hot_keys,
            hot.valid, hot.tenants, hot.value_ids, ens.warm_keys,
            warm.valid, warm.tenants, warm.value_ids, warm.write_seq,
            warm.centroids, warm.members, warm.cursor, warm.indexed_total,
            ens.warm_keys_q, ens.warm_scales, k=1)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    from repro_torch import resolve_device
    from repro_torch.cache_service import CacheConfig, CacheService, ColdTier
    from repro_torch.configs import get_config
    from repro_torch.core import (
        EmbedderTrainer, EncoderEmbedder, SemanticCache,
    )
    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import make_cache_mesh
    from repro_torch.models import LM, Encoder
    from repro_torch.serving.frontend import stub_frontend_embeds
    cfg = get_config("modernbert-149m").reduced(n_layers=2)
    dec = get_config("phi3-mini-3.8b").reduced()
    for make in (lambda: resolve_device("cuda"),
                 lambda: Encoder(cfg),
                 lambda: EmbedderTrainer(cfg),
                 lambda: CacheService(CacheConfig(dim=16)),
                 lambda: ColdTier(8, 16),
                 lambda: SemanticCache(capacity=8, dim=16),
                 lambda: EncoderEmbedder(cfg),
                 lambda: LM(dec),
                 lambda: LM(get_config("xlstm-125m").reduced()),
                 lambda: stub_frontend_embeds(
                     get_config("pixtral-12b").reduced(), 1),
                 lambda: serve.main(["--requests", "1"]),
                 lambda: serve.main(["--scenario", "drift"]),
                 lambda: train.main(["--smoke", "--steps", "1"]),
                 lambda: make_cache_mesh(2),
                 lambda: CacheService(CacheConfig(dim=16), device="cuda:0")):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No card -> non-zero exit and no result line; the same alone in a
    directory that holds nothing else of the repo."""
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd is tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        res = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env={"PATH": "/usr/bin:/bin",
                                  "CUDA_VISIBLE_DEVICES": ""})
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout
