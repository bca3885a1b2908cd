"""The dry-run's counted token loops (`localcost.CountedScan`) against
the real loops, through the same program (`launch.dryrun.
loop_count_check`: `launch.programs.build_program`, `launch.dryrun.
measure`) on a fake 2x2 ("data", "model") mesh: reduced xLSTM-125M cut
to one mLSTM layer and to one sLSTM layer, and reduced Jamba cut to one
Mamba layer, their train and prefill programs at 64 and 256 tokens,
each measured once with every loop longer than ``TOKEN_LOOP_LIMIT``
counted and once with every loop run token by token.

Flops, unfused bytes, temp (the peak of live bytes), output bytes and
every collective (op, bytes, group, link, in order) are equal: the
counted loop runs four real steps (tokens 0, 1, S-2, S-1) and holds
what each bulk step leaves live (autograd's saved tensors, the token
outputs until their stack, the token gradients until theirs) as fake
storage at the point the real loop holds it, so temp needs no margin.
The counted runs count at least one loop a mixer layer; the real runs
none.  The runs are in five spawned children at once
(`test_torch_ranks.in_child`), the real 256-token xLSTM train steps
each alone in one.  Apart from the dry-run, each mixer's real loop has
a backward linear in S (`models.scan`; indexing in the loop was
quadratic)."""
import pytest

from repro_torch.launch.dryrun import LOOP_MIXERS as MIXERS
from test_torch_ranks import in_child

CASES = [(mixer, shape, S) for mixer in MIXERS
         for shape in ("train_4k", "prefill_32k") for S in (64, 256)]
# the real 256-token train steps take longest: each in a child of its own
LONGEST = [c for c in CASES if c[0] != "mamba" and c[1:] == ("train_4k", 256)]
GROUPS = [[c] for c in LONGEST] + [
    [c for c in CASES if c[0] == m and c not in LONGEST] for m in MIXERS]


@pytest.fixture(scope="module")
def runs():
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch.dryrun import loop_count_check
    with ThreadPoolExecutor(len(GROUPS)) as pool:
        parts = list(pool.map(
            lambda g: in_child(loop_count_check, (g,), timeout=240), GROUPS))
    return {case: r for part in parts for case, r in part.items()}


@pytest.mark.parametrize("mixer,shape,S", CASES)
def test_counted_loop_equals_the_real_loop(runs, mixer, shape, S):
    r = runs[f"{mixer} {shape} {S}"]
    counted, real = r["counted"], r["real"]
    assert counted.pop("counted_loops") >= 1
    assert real.pop("counted_loops") == 0
    for key in counted:
        assert counted[key] == real[key], key
    assert real["flops"] > 0 and real["temp"] > 0


@pytest.mark.parametrize("mixer", list(MIXERS))
def test_loop_backward_bytes_are_linear_in_tokens(mixer):
    """One mixer's forward and backward on fake tensors at 4, 8 and 16
    tokens, every loop run token by token: the unfused bytes are affine
    in S (each doubling adds the same), as ``lax.scan``'s are.  Indexing
    ``x[:, t]`` in the loop gave every token a zero gradient of the whole
    input, O(S^2)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.launch.localcost import LocalCost
    from repro_torch.models.mamba import Mamba
    from repro_torch.models.param import Initializer
    from repro_torch.models.xlstm import MLSTM, SLSTM
    arch, _ = MIXERS[mixer]
    cls = {"mlstm": MLSTM, "slstm": SLSTM, "mamba": Mamba}[mixer]
    cfg = get_config(arch).reduced()
    got = []
    with FakeTensorMode():
        mod = cls(Initializer(torch.Generator().manual_seed(0)), cfg)
        for S in (4, 8, 16):
            mod.zero_grad(set_to_none=True)
            x = torch.randn(2, S, cfg.d_model, requires_grad=True)
            with LocalCost(1) as cost:
                mod(x).sum().backward()
            got.append(cost.bytes)
    assert got[2] - got[1] == 2 * (got[1] - got[0]) > 0, got
