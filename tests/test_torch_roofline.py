"""The port's roofline (`repro_torch.launch.roofline`) against the
reference's (`repro.launch.roofline`): the same collectives — as the
port's records and rendered as the optimized-HLO lines the reference
parses — give the same per-device bytes by type, counts and top ops;
the terms use the H100's published constants and each group's link."""
import numpy as np
import pytest

from repro.launch.roofline import collective_bytes as jcollective_bytes
from repro_torch.launch import mesh as pmesh
from repro_torch.launch.roofline import (
    CollectiveRecord, collective_bytes, roofline_terms,
)

_HLO_DTYPE = {4: "f32", 2: "bf16", 1: "pred"}
_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute")


def _hlo(records, n_devices):
    """The records as the HLO text the reference's parser reads: one
    instruction per collective, its output shape before the op name and
    its replica groups in the iota form ``[groups,size]<=[n]`` (none:
    every device)."""
    lines = []
    for i, (r, item) in enumerate(records):
        shape = f"{_HLO_DTYPE[item]}[{','.join(map(str, r.shape))}]"
        groups = "" if r.group is None else \
            f", replica_groups=[{n_devices // r.group},{r.group}]<=[{n_devices}]"
        lines.append(f"  %c{i} = {shape}{{0}} {r.op}({shape}{{0}} %p{i})"
                     f"{groups}")
    return "\n".join(lines)


def _record(op, shape, item, group):
    return CollectiveRecord(op, int(np.prod(shape)) * item, group,
                            shape=tuple(shape))


def _same(records, n_devices):
    got = collective_bytes([r for r, _ in records], n_devices)
    want = jcollective_bytes(_hlo(records, n_devices), n_devices)
    for op in _OPS + ("total",):
        assert got.get(op, 0.0) == pytest.approx(want.get(op, 0.0), rel=1e-12)
    assert got["counts"] == want["counts"]
    assert [(t["moved_bytes"], t["op"], t["group"]) for t in got["top_ops"]] \
        == [(t["moved_bytes"], t["op"], t["group"]) for t in want["top_ops"]]
    return got


def test_collective_bytes_hand_cases():
    recs = [(_record("all-gather", (256, 1024), 4, 4), 4),
            (_record("all-reduce", (512,), 2, 16), 2),
            (_record("collective-permute", (8, 8), 4, None), 4)]
    got = _same(recs, 64)
    assert got["all-gather"] == pytest.approx(256 * 1024 * 4 * 3 / 4)
    assert got["all-reduce"] == pytest.approx(512 * 2 * 2 * 15 / 16)
    assert got["collective-permute"] == 8 * 8 * 4


@pytest.mark.parametrize("seed", range(8))
def test_collective_bytes_sweep(seed):
    rng = np.random.default_rng(seed)
    n_devices = 256
    recs = []
    for _ in range(int(rng.integers(1, 40))):
        op = _OPS[int(rng.integers(len(_OPS)))]
        shape = tuple(int(d) for d in rng.integers(1, 300,
                                                   int(rng.integers(1, 4))))
        item = int(rng.choice([4, 2, 1]))
        group = [None, 2, 4, 16, 256][int(rng.integers(5))]
        recs.append((_record(op, shape, item, group), item))
    _same(recs, n_devices)


def test_roofline_terms_use_the_h100_and_the_links():
    assert pmesh.PEAK_FLOPS_BF16 == 989.4e12
    assert pmesh.HBM_BANDWIDTH == 3.35e12
    assert (pmesh.NVLINK_BANDWIDTH, pmesh.NETWORK_BANDWIDTH) == (450e9, 50e9)
    assert pmesh.link_of(range(8)) == "nvlink"
    assert pmesh.link_of(range(0, 16)) == "network"
    assert pmesh.link_of([0, 16, 32]) == "network"
    assert pmesh.device_memory_bytes("cpu") == 80e9
    recs = [CollectiveRecord("all-gather", 8 * 10**6, 4, "nvlink"),
            CollectiveRecord("all-reduce", 10**6, 16, "network")]
    terms = roofline_terms({"flops": 1e12, "bytes accessed": 1e11}, recs,
                           256)
    assert terms["t_compute"] == pytest.approx(1e12 / 989.4e12)
    assert terms["t_memory"] == pytest.approx(1e11 / 3.35e12)
    nv, net = 8e6 * 3 / 4, 1e6 * 2 * 15 / 16
    assert terms["collective_by_link"] == pytest.approx(
        {"nvlink": nv, "network": net})
    assert terms["t_collective"] == pytest.approx(nv / 450e9 + net / 50e9)
    assert terms["bottleneck"] == "memory"
    assert terms["t_bound"] == terms["t_memory"]
    assert terms["roofline_fraction"] == pytest.approx(
        terms["t_compute"] / terms["t_memory"])
