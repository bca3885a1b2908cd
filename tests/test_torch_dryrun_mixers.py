"""The port's dry-run of the decoders whose mixers have no ``DTensor``
sharding strategy — the MoE FFN's data-dependent dispatch, Mamba's chunk
scan, xLSTM's token loops — on a fake 2x2 ("data", "model") mesh: their
decode steps run with those modules batch-local on gathered weights
(`localcost.local_mixers`), and the argument bytes per device equal the
reference's ``sharded_bytes``; xLSTM's train step at 4096 tokens runs,
its token loops counted (`localcost.CountedScan`); an op with no
sharding strategy falls back to replicated local copies, counted.  Each
dry-run runs in a spawned child (`test_torch_ranks.in_child`)."""
import pytest

from repro_torch.launch.dryrun import KNOWN_FALLBACKS
from test_torch_dryrun import MESH, _run_cases, reference_arg_bytes
from test_torch_ranks import in_child


def _fallback_counts():
    """`LocalCost`'s fallbacks on a fake 2x2 mesh: ``searchsorted``
    (no sharding strategy) on sharded inputs runs on replicated local
    copies and returns a replicated result; ``fill_`` with a tensor
    value fills the local shard in place."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.localcost import LocalCost, fake_mesh
    with fake_mesh(MESH) as mesh, FakeTensorMode():
        a = DTensor.from_local(torch.empty(8, dtype=torch.int64), mesh,
                               [Shard(0), Replicate()], run_check=False,
                               shape=(16,), stride=(1,))
        v = DTensor.from_local(torch.empty(4, dtype=torch.int64), mesh,
                               [Replicate(), Shard(0)], run_check=False,
                               shape=(8,), stride=(1,))
        with LocalCost(4) as c:
            out = torch.searchsorted(a, v)
            same = a.fill_(torch.tensor(3)) is a
        return (dict(c.fallbacks), tuple(out.shape),
                [p.is_replicate() for p in out.placements], same,
                [r.op for r in c.records])


def _mixer_cases():
    """Decode steps of the MoE, Mamba and xLSTM decoders (their mixers
    run batch-local on gathered weights), xLSTM's train step at 4096
    tokens, and the fallbacks."""
    from repro_torch.launch.dryrun import run_one
    out = _run_cases([(a, "decode_32k", MESH, {"reduced": True})
                      for a in MIXER_ARCHS])
    r = run_one("xlstm-125m", "train_4k", mesh=MESH, reduced=True,
                device="cpu", verbose=False)
    train = {"args": r["memory"]["argument_bytes_per_device"],
             "flops": r["roofline"]["per_device_flops"],
             "counted": r["counted_loops"], "fallbacks": r["fallbacks"]}
    return out, train, _fallback_counts()


MIXER_ARCHS = ("granite-moe-3b-a800m", "jamba-1.5-large-398b", "xlstm-125m")


@pytest.fixture(scope="module")
def results():
    return in_child(_mixer_cases, timeout=240)


def test_moe_and_recurrent_mixers_run_batch_local(results):
    res, train, _ = results
    for arch, r in zip(MIXER_ARCHS, res):
        assert r["memory"]["argument_bytes_per_device"] == \
            reference_arg_bytes(arch, "decode_32k", MESH), arch
        assert r["flops"] > 0 and r["counts"].get("all-gather", 0) > 0, arch
    assert train["args"] == reference_arg_bytes("xlstm-125m", "train_4k",
                                                MESH)
    assert train["flops"] > 0 and train["counted"] > 0
    assert set(train["fallbacks"]) <= set(KNOWN_FALLBACKS)


def test_ops_without_a_strategy_fall_back(results):
    fallbacks, shape, replicated, in_place, ops = results[2]
    assert fallbacks == {"aten.searchsorted.Tensor (local, replicated)": 1,
                         "fill_ (local)": 1}
    assert shape == (8,) and replicated == [True, True] and in_place
    assert ops and set(ops) == {"all-gather"}    # the inputs replicated
