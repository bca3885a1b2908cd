"""Per-device cost of a ``DTensor`` program run on fake tensors: the
counting half of the dry-run (``launch/dryrun.py``), which starts the
fake process group, places the arguments and runs the program inside
`LocalCost`, `EinsumRule` and `local_mixers`.

What is counted, per device (`LocalCost`):

* argument bytes: `launch.sharding.sharded_bytes` of the arguments,
  exact (the placed local shards add up to it, checked);
* output and temp bytes: live local storage, followed allocation by
  allocation (a finalizer on each new storage); ``temp`` is the peak of
  the bytes the run allocated, outputs included, ``output`` what the
  outputs hold at the end, ``peak_estimate`` arguments + temp;
* flops: each op's *local* work — the op ``DTensor`` runs on this
  rank's shards, counted with ``torch.utils.flop_counter``'s formulas
  (a ``FlopCounterMode`` around ``DTensor`` code counts the global op);
  the ops ``DTensor`` runs on global fake tensors to propagate shapes,
  or on constants of its own bookkeeping, are not work and are skipped;
* bytes accessed: every non-view local op's operand and result bytes,
  unfused, so larger than XLA's post-fusion figure (an allocation reads
  nothing, and an ``out=`` tensor is written, not read);
* collectives: every collective issued on this rank (``DTensor``'s
  functional collectives and the port's own ``dist.all_gather``), its
  output bytes and group, into `launch.roofline`'s ring model.

Two ops reach ``DTensor`` whole rather than decomposed (`EinsumRule`, a
``TorchFunctionMode``): a two-operand ``torch.einsum``, and ``F.linear``
on an activation of three or more dims, run as an einsum on the local
shards under an explicit sharding rule — decomposed, their flattened
batch dims carry ``_StridedShard`` placements that fail to propagate on
fake tensors.  A ``gather`` along a sharded dim is reduced at once (its
masked partial sum loses its mask through a later view).  An in-place
``fill_`` with a tensor value, which has no sharding strategy, fills the
local shard; any other op whose sharding ``DTensor`` cannot propagate
runs on its inputs replicated first (and on their local copies when it
has no strategy at all).  Each such op is counted under ``fallbacks`` in
the result.  The MoE FFN and the recurrent mixers run batch-local on
gathered weights (`local_mixers`); an xLSTM token loop longer than
``TOKEN_LOOP_LIMIT`` is refused (its train and prefill pairs fail).
"""
from __future__ import annotations

import contextlib
import math
import weakref
from collections import Counter

import torch
from torch import nn
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch import mesh as _mesh
from repro_torch.launch.roofline import CollectiveRecord

aten = torch.ops.aten
_LINEAR = (torch.nn.functional.linear, torch._C._nn.linear)

# functional collectives (DTensor's) and c10d ops (dist.*) -> reference op
_FUNCOL = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
           "all_gather_into_tensor": "all-gather",
           "reduce_scatter_tensor": "reduce-scatter",
           "all_to_all_single": "all-to-all", "broadcast": "collective-permute",
           "broadcast_": "collective-permute"}
_C10D = {"allgather_": "all-gather", "_allgather_base_": "all-gather",
         "allreduce_": "all-reduce", "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter", "alltoall_": "all-to-all",
         "alltoall_base_": "all-to-all", "broadcast_": "collective-permute"}
# the longest sequence an xLSTM token loop runs on fake tensors (each op
# costs ~0.2 ms of host time: a reduced xLSTM-125M train step at S=4096
# took 18 minutes on one CPU core)
TOKEN_LOOP_LIMIT = 256
_PROP_ROOTS = (aten.empty_strided.default, aten.lift_fresh.default,
               aten.lift_fresh_copy.default)
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh",
             "_unsafe_view", "t", "wait_tensor"}


def tensors_in(tree, out=None) -> list:
    """The tensors of a tree of lists, tuples and dicts, in order.  (No
    nested recursive function: its closure would be a reference cycle,
    holding every tensor it saw live until the cyclic collector ran, and
    ``temp`` would follow the collector's timing.)"""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for y in tree:
            tensors_in(y, out)
    elif isinstance(tree, dict):
        for y in tree.values():
            tensors_in(y, out)
    return out


def nbytes_of(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_info(func, args, n_default: int):
    """(group size, link) of a collective call."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    pg = None
    if func.namespace == "_c10d_functional":  # its last argument
        pg = _resolve_process_group(args[-1])
    for a in args:
        if isinstance(a, dist.ProcessGroup):
            pg = a
        elif isinstance(a, torch.ScriptObject):
            pg = dist.ProcessGroup.unbox(a)
    if pg is None:
        return n_default, "network"
    ranks = dist.get_process_group_ranks(pg)
    return len(ranks), _mesh.link_of(ranks)


class LocalCost(TorchDispatchMode):
    """Per-device flops, bytes, collectives and live memory of a
    ``DTensor`` program on fake tensors (see the module docstring)."""

    def __init__(self, n_devices: int):
        super().__init__()
        self.n_devices = n_devices
        self.flops = 0.0
        self.bytes = 0.0
        self.records = []
        self.fallbacks = Counter()
        self.live = 0
        self.peak = 0
        self._storages = {}
        self._prop = set()          # ids of shape-propagation tensors
        self._inside = False

    # -- memory ---------------------------------------------------------
    def _free(self, key):
        self.live -= self._storages.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        if t.device.type == "meta":
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def held_bytes(self, tree) -> int:
        """Bytes of the storages this run allocated that ``tree``'s
        tensors (``DTensor``s' local shards) hold."""
        keys = set()
        for t in tensors_in(tree):
            t = getattr(t, "_local_tensor", t)
            if t.device.type != "meta":
                keys.add(t.untyped_storage()._cdata)
        return sum(self._storages.get(k, 0) for k in keys)

    # -- work -----------------------------------------------------------
    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry
        outs = tensors_in(out)
        if not outs:
            return
        name = func._overloadpacket.__name__
        f = flop_registry.get(func._overloadpacket)
        if f is not None:
            self.flops += f(*args, **kwargs, out_val=out)
        if getattr(func, "is_view", False):
            return
        ins = tensors_in((args, kwargs))
        held = {t.untyped_storage()._cdata for t in ins
                if t.device.type != "meta"}
        for t in outs:                   # in-place results are not new
            if t.device.type == "meta" or \
                    t.untyped_storage()._cdata not in held:
                self._track(t)
        if name not in _NO_BYTES:        # an allocation reads nothing
            read = tensors_in((args, {k: v for k, v in kwargs.items()
                                      if k != "out"}))
            self.bytes += sum(nbytes_of(t) for t in read)
            self.bytes += sum(nbytes_of(t) for t in outs)

    def _collective(self, func, args, out) -> bool:
        ns = func.namespace
        name = func._overloadpacket.__name__
        op = (_FUNCOL.get(name) if ns == "_c10d_functional"
              else _C10D.get(name) if ns == "c10d" else None)
        if op is None:
            return False
        group, link = _group_info(func, args, self.n_devices)
        res = out[0] if ns == "c10d" and isinstance(out, tuple) else out
        outs = tensors_in(res)
        b = sum(nbytes_of(t) for t in outs)
        self.records.append(CollectiveRecord(
            op, b, group, link, tuple(outs[0].shape) if outs else ()))
        for t in outs:
            self._track(t)
        return True

    # -- dispatch -------------------------------------------------------
    def _run_dtensor(self, func, args, kwargs):
        from torch.distributed.tensor import DTensor, Replicate
        try:
            return func(*args, **kwargs)
        except Exception as err:             # sharding propagation failed
            # without its traceback: the frames it holds would make a
            # reference cycle through this frame's arguments
            first = err.with_traceback(None)
        if func is aten.fill_.Tensor and args[1].dim() == 0:
            self.fallbacks["fill_ (local)"] += 1      # no strategy: local
            v = args[1]
            args[0]._local_tensor.fill_(v.to_local()
                                        if isinstance(v, DTensor) else v)
            return args[0]
        mutated = func._schema.is_mutable

        def rep(i, x):
            if isinstance(x, (list, tuple)):
                return type(x)(rep(-1, y) for y in x)
            if not isinstance(x, DTensor) or (mutated and i == 0):
                return x
            return x.redistribute(x.device_mesh,
                                  [Replicate()] * x.device_mesh.ndim)
        args = [rep(i, x) for i, x in enumerate(args)]
        try:
            out = func(*args, **kwargs)
        except Exception:                # no strategy for any placement
            return self._run_local(func, args, kwargs, first)
        self.fallbacks[f"{func} (replicated)"] += 1
        return out

    def _run_local(self, func, args, kwargs, first):
        """Every rank computes the whole result from replicated inputs,
        on their local copies."""
        from torch.distributed.tensor import DTensor, Replicate
        dts = [x for x in tensors_in((args, kwargs)) if isinstance(x, DTensor)]
        if not dts or any(not p.is_replicate() for x in dts
                          for p in x.placements):
            raise first
        mesh = dts[0].device_mesh

        def local(x):
            if isinstance(x, (list, tuple)):
                return type(x)(local(y) for y in x)
            return x.to_local() if isinstance(x, DTensor) else x

        def wrap(x):
            if isinstance(x, (list, tuple)):
                return type(x)(wrap(y) for y in x)
            if isinstance(x, torch.Tensor) and not isinstance(x, DTensor):
                return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                          run_check=False)
            return x
        out = func(*[local(x) for x in args],
                   **{k: local(v) for k, v in kwargs.items()})
        self.fallbacks[f"{func} (local, replicated)"] += 1
        return args[0] if func._schema.is_mutable else wrap(out)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if func is aten.detach_.default:
                # below autograd a no-op; torch 2.11's DTensor has no
                # strategy for it (a redistribute under no_grad issues it)
                return args[0]
            if self._inside:
                return NotImplemented       # DTensor runs; we see its ops
            self._inside = True
            try:
                with self:
                    return self._run_dtensor(func, args, kwargs)
            finally:
                self._inside = False
        out = func(*args, **kwargs)
        if self._collective(func, args, out):
            return out
        if self._inside:
            # shape propagation on global fake tensors, or bookkeeping on
            # constants ``DTensor`` makes (its strategies' one-rank mesh,
            # built once a process): not work
            ins = tensors_in((args, kwargs))
            if func in _PROP_ROOTS or any(id(t) in self._prop for t in ins):
                for t in tensors_in(out):
                    self._prop.add(id(t))
                    weakref.finalize(t, self._prop.discard, id(t))
                return out
        self._count(func, args, kwargs, out)
        return out


class EinsumRule(TorchFunctionMode):
    """A sharding rule for two-operand ``torch.einsum`` on ``DTensor``s,
    which ``DTensor`` only sees decomposed: its flattened batch dims
    carry ``_StridedShard`` placements that fail to propagate on fake
    tensors.  Per mesh dim: a letter sharded in both operands stays
    sharded (a batch letter in the output) or makes the output
    ``Partial`` (a contracted one); a letter sharded in one operand only
    shards the other's same letter locally (no transfer) or, absent
    there, passes to the output; a ``Partial`` operand is reduced and
    any other placement replicated first.  The einsum then runs on the
    local shards."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if (func in _LINEAR and len(args) == 2 and not kwargs
                and isinstance(args[0], DTensor) and args[0].dim() > 2):
            # x (..., in) @ w (out, in)^T without flattening x's dims
            lead = "abcdefgh"[:args[0].dim() - 1]
            return self._local(f"{lead}y,zy->{lead}z", *args)
        if func in (torch.gather, torch.Tensor.gather):
            return self._gather(func, args, kwargs)
        if func is not torch.einsum or len(args) < 2:
            return func(*args, **kwargs)
        ops = args[1] if len(args) == 2 and isinstance(args[1], (list, tuple)) \
            else args[1:]
        eq = args[0].replace(" ", "")
        if (len(ops) != 2 or "->" not in eq or "." in eq
                or not any(isinstance(o, DTensor) for o in ops)):
            return func(*args, **kwargs)
        return self._local(eq, *ops)

    @staticmethod
    def _gather(func, args, kwargs):
        """A gather along a sharded dim leaves a masked partial sum,
        whose mask ``DTensor`` does not carry through a later view:
        reduce it at once."""
        from torch.distributed.tensor import DTensor, Replicate
        out = func(*args, **kwargs)
        if isinstance(out, DTensor) and any(
                type(p).__name__ == "_MaskPartial" for p in out.placements):
            out = out.redistribute(out.device_mesh, [
                Replicate() if type(p).__name__ == "_MaskPartial" else p
                for p in out.placements])
        return out

    @staticmethod
    def _local(eq, a, b):
        from torch.distributed.tensor import (
            DTensor, Partial, Replicate, Shard,
        )
        ins, out = eq.split("->")
        la, lb = ins.split(",")
        mesh = (a if isinstance(a, DTensor) else b).device_mesh
        n = mesh.ndim

        def as_dt(x):
            if isinstance(x, DTensor):
                return x
            return DTensor.from_local(x, mesh, [Replicate()] * n,
                                      run_check=False)

        def letter(x, lx, i):
            p = x.placements[i]
            return lx[p.dim] if type(p) is Shard else None

        a, b = as_dt(a), as_dt(b)
        ta, tb = list(a.placements), list(b.placements)
        for t in (ta, tb):
            for i, p in enumerate(t):
                if not (type(p) is Shard or p.is_replicate()):
                    t[i] = Replicate()           # reduce / gather first
        a = a.redistribute(mesh, ta) if ta != list(a.placements) else a
        b = b.redistribute(mesh, tb) if tb != list(b.placements) else b
        out_pl = []
        for i in range(n):
            ca, cb = letter(a, la, i), letter(b, lb, i)
            if ca and cb and ca != cb:
                tb[i], cb = Replicate(), None    # keep one operand's
            c = ca or cb
            if c is None:
                out_pl.append(Replicate())
                continue
            if ca and c in lb and not cb:
                tb[i] = Shard(lb.index(c))       # a local slice of b
            elif cb and c in la and not ca:
                ta[i] = Shard(la.index(c))
            out_pl.append(Shard(out.index(c)) if c in out else Partial())
        a = a.redistribute(mesh, ta) if ta != list(a.placements) else a
        b = b.redistribute(mesh, tb) if tb != list(b.placements) else b
        size = dict(zip(la, a.shape))
        size.update(zip(lb, b.shape))
        shape = tuple(size[c] for c in out)
        loc = torch.einsum(eq, a.to_local(), b.to_local())
        return DTensor.from_local(loc, mesh, out_pl, run_check=False,
                                  shape=shape, stride=_stride_like(loc, shape))


def _batch_placements(x, mesh) -> list:
    """``x``'s ``Shard(0)`` mesh dims kept, every other mesh dim
    replicated: the placements of a batch-local run."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(0) if type(p) is Shard and p.dim == 0 else Replicate()
            for p in x.placements]


@contextlib.contextmanager
def local_mixers(model: nn.Module, mesh):
    """Run the MoE FFN and the recurrent mixers (Mamba, mLSTM, sLSTM)
    data-parallel during a dry-run: their data-dependent dispatch and
    token loops have no ``DTensor`` sharding strategies.  Each call's
    activation keeps its batch sharding and is gathered along every
    other mesh dim, the module's weights are gathered whole (FSDP-style
    all-gathers, differentiable: their gradients reduce-scatter back),
    a decode state is taken batch-local and written back, and the
    module runs on the local tensors; its outputs come back batch-
    sharded (a 0-d aux loss replicated).  The reference's GSPMD may
    instead partition the experts (all-to-alls); the counts say what
    this plan costs."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.models.mamba import Mamba
    from repro_torch.models.moe import MoE
    from repro_torch.models.xlstm import MLSTM, SLSTM

    def wrap(mod, fn):
        def run(x, *rest):     # (x) or (x, state): the mixers' methods
            if not isinstance(x, DTensor):
                return fn(x, *rest)
            if isinstance(mod, (MLSTM, SLSTM)) and x.shape[1] > TOKEN_LOOP_LIMIT:
                raise NotImplementedError(
                    f"the port's {type(mod).__name__} runs a Python loop of "
                    f"~15 ops a token; {x.shape[1]} tokens on fake tensors "
                    f"take hours (a scan kernel is a ROADMAP speed item): "
                    f"the dry-run takes at most {TOKEN_LOOP_LIMIT}")
            state = rest[0] if rest else None
            lead = [x] + [v for v in (state or {}).values()
                          if isinstance(v, DTensor) and v.dim()]
            # a mesh dim that shards the batch of x or of the state does
            # so for both
            pl = [Shard(0) if any(q.is_shard() for q in col)
                  else Replicate() for col in
                  zip(*[_batch_placements(t, mesh) for t in lead])]
            full = [Replicate()] * mesh.ndim
            x_loc = x.redistribute(mesh, pl).to_local()
            saved = {}
            for name, sub in mod.named_modules():
                for k, p in list(sub._parameters.items()):
                    if isinstance(p, DTensor):
                        saved[(name, k)] = (sub, p)
                        sub._parameters[k] = p.redistribute(
                            mesh, full).to_local()
            placed = {}
            if state is not None:
                for k, v in list(state.items()):
                    if isinstance(v, DTensor):
                        spl = pl if v.dim() else full
                        placed[k] = (v, spl)
                        state[k] = v.redistribute(mesh, spl).to_local()
            try:
                out = fn(x_loc, *rest)
            finally:
                for (name, k), (sub, p) in saved.items():
                    sub._parameters[k] = p
                for k, (v, spl) in placed.items():
                    v.copy_(DTensor.from_local(state[k], mesh, spl,
                                               run_check=False,
                                               shape=v.shape,
                                               stride=v.stride()))
                    state[k] = v

            def back(t):
                if not isinstance(t, torch.Tensor) or isinstance(t, DTensor):
                    return t
                if t.dim() == 0:
                    return DTensor.from_local(t, mesh, full, run_check=False)
                shape = (x.shape[0],) + tuple(t.shape[1:])
                return DTensor.from_local(t, mesh, pl, run_check=False,
                                          shape=shape,
                                          stride=contiguous_stride(shape))
            if isinstance(out, tuple):
                return tuple(back(t) for t in out)
            return back(out)
        return run

    patched = []
    for mod in model.modules():
        if isinstance(mod, (MoE, Mamba, MLSTM, SLSTM)):
            for meth in ("forward", "prefill", "decode"):
                if hasattr(type(mod), meth):
                    setattr(mod, meth, wrap(mod, getattr(mod, meth)))
                    patched.append((mod, meth))
    try:
        yield
    finally:
        for mod, meth in patched:
            delattr(mod, meth)


def _stride_like(local: torch.Tensor, shape) -> tuple:
    """The global stride of ``shape`` laid out in ``local``'s dim order
    (a permuted einsum result stays a permuted view)."""
    order = sorted(range(local.dim()), key=lambda d: (-local.stride(d), d))
    stride, acc = [0] * local.dim(), 1
    for d in reversed(order):
        stride[d] = acc
        acc *= shape[d]
    return tuple(stride)


def contiguous_stride(shape):
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))

@contextlib.contextmanager
def fake_mesh(sizes: dict):
    """The fake group of ``prod(sizes)`` ranks and a ``DeviceMesh`` named
    by ``sizes`` on it; the group is destroyed on exit."""
    with _mesh.fake_process_group(math.prod(sizes.values())):
        yield _mesh.make_mesh(sizes, device="cpu")


def local_count_check() -> dict:
    """Local flops and collectives of hand-countable sharded products on
    a fake 2x2 ("data", "model") mesh, each beside its count by hand: a
    column-parallel matmul (rows over data, columns over model: each
    rank (32, 96) @ (96, 64)), a row-parallel one (the contraction over
    model: (64, 48) @ (48, 128), a partial sum, no transfer yet) and a
    3-d linear through `EinsumRule` ((4, 16, 96) rows times 64 of the
    128 out features).  {case: ((flops, collectives), (hand flops, 0))}."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def dt(local, mesh, pl, shape):
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=shape,
                                  stride=contiguous_stride(shape))
    out = {}
    with fake_mesh({"data": 2, "model": 2}) as mesh, FakeTensorMode():
        cases = {
            "column": (dt(torch.empty(32, 96), mesh, [Shard(0), Replicate()],
                          (64, 96)),
                       dt(torch.empty(96, 64), mesh, [Replicate(), Shard(1)],
                          (96, 128)), 2 * 32 * 96 * 64),
            "row": (dt(torch.empty(64, 48), mesh, [Replicate(), Shard(1)],
                       (64, 96)),
                    dt(torch.empty(48, 128), mesh, [Replicate(), Shard(0)],
                       (96, 128)), 2 * 64 * 48 * 128),
            "linear": (dt(torch.empty(4, 16, 96), mesh,
                          [Shard(0), Replicate()], (8, 16, 96)),
                       dt(torch.empty(64, 96), mesh, [Replicate(), Shard(0)],
                          (128, 96)), 2 * 4 * 16 * 96 * 64),
        }
        for name, (x, w, hand) in cases.items():
            with EinsumRule(), LocalCost(4) as c:
                if name == "linear":
                    torch.nn.functional.linear(x, w)
                else:
                    x @ w
            out[name] = ((c.flops, len(c.records)), (hand, 0))
    return out
