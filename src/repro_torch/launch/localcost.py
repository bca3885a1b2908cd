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
gathered weights (`local_mixers`).  Their token loops (`models.scan`)
run token by token up to ``TOKEN_LOOP_LIMIT`` tokens; a longer loop is
counted (`CountedScan`): a few of its steps run for real and the rest
are the steady step's counts scaled, forward and backward, with the
live bytes every step leaves behind held as fake storage, so flops,
bytes and temp are those of the whole loop.
"""
from __future__ import annotations

import contextlib
import math
import weakref
from collections import Counter

import torch
from torch import nn
from torch.autograd.graph import get_gradient_edge as _edge
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
# the longest token loop (`models.scan.scan`) the dry-run runs token by
# token; a longer one is counted from a few real steps (`CountedScan`)
TOKEN_LOOP_LIMIT = 16
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


def _splits_shards(x, size) -> bool:
    """Whether a view of the ``DTensor`` ``x`` to ``size`` splits a dim
    that a mesh dim shards, with an outer factor that mesh dim does not
    divide: ``DTensor`` can keep the shards only on the outer factor
    (the attention's q.reshape of query heads into fewer KV groups)."""
    from torch.distributed.tensor import Shard
    size = list(size)
    if -1 in size:
        size[size.index(-1)] = x.numel() // -math.prod(size)
    for m, p in enumerate(x.placements):
        if not isinstance(p, Shard):
            continue
        d, lead, j = p.dim, math.prod(x.shape[:p.dim]), 0
        acc = 1
        while j < len(size) and acc < lead:
            acc *= size[j]
            j += 1
        while j < len(size) - 1 and size[j] == 1 != x.shape[d]:
            j += 1
        if acc == lead and j < len(size) and size[j] != x.shape[d] \
                and x.shape[d] % size[j] == 0 \
                and size[j] % x.device_mesh.size(m):
            return True
    return False


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
        self.counted_loops = 0      # token loops `CountedScan` counted
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
        split = func is aten.view.default and _splits_shards(*args[:2])

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
        self.fallbacks[f"{func} (replicated"
                       f"{', a sharded dim split' if split else ''})"] += 1
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


class _Take(torch.autograd.Function):
    """An alias of ``x`` that requires grad through a 0-d ``anchor``: the
    gradient reaching it is captured at its node's edge, which holds no
    tensor (a leaf would keep the input's storage live through its
    ``AccumulateGrad`` node, where the real loop frees it)."""

    @staticmethod
    def forward(ctx, anchor, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, None


def _snapshot(cost) -> tuple:
    return cost.flops, cost.bytes, len(cost.records), cost.live


def _add_bulk(cost, n: int, before, after) -> None:
    """Add ``n`` times one step's flops and bytes, ``after - before``
    (counts: flops, bytes, collective records, live bytes); the step
    must have issued no collective."""
    if after[2] != before[2]:
        raise AssertionError("a collective inside a token step: the mixers "
                             "run on local tensors")
    cost.flops += n * (after[0] - before[0])
    cost.bytes += n * (after[1] - before[1])


def _reserve(n: int):
    """``n`` bytes of fake storage, which `LocalCost` tracks as live."""
    assert n >= 0, n
    return torch.empty(n, dtype=torch.uint8) if n else None


class _Loop:
    """One counted loop of S tokens (see `CountedScan`).  Real steps run
    at tokens 0, 1, S-2 and S-1; steps 2 .. S-3 are the bulk, counted as
    step 1 counted.  Tokens 1 and S-2 are steady steps (token 0 starts
    from the caller's carry, token S-1 ends the loop), so the bulk sits
    between two real steady steps, forward and backward, and a peak
    inside it is one of theirs (live bytes move by the same amount each
    step)."""

    def __init__(self, cost, step, carry, xs, params):
        self.cost, self.step = cost, step
        self.args = (carry, xs, params)
        self.S = xs[0].shape[1]
        self.idx = (0, 1, self.S - 2, self.S - 1)
        self.box = {}          # what the backward's hooks share

    def forward(self, need=None):
        """Run the real steps (recording a graph of them when ``need``
        names the inputs that need grad: carry, xs, params) and count the
        loop.  Returns (ys (B, S, ...), the carry after the last token)."""
        cost, S = self.cost, self.S
        carry, xs, params = self.args
        self.args = None
        grad = need is not None
        n_c, n_x = len(carry), len(xs)
        if not grad:
            need = [False] * (n_c + n_x + len(params))
        anchor = (torch.empty((), device="meta", requires_grad=True)
                  if grad else None)

        def take(t, needs):
            return _Take.apply(anchor, t) if needs else t

        if grad:        # the real steps' graph starts here
            carry, xs, params = ([t.detach() for t in ts]
                                 for ts in (carry, xs, params))
        carry = tuple(take(c, need[i]) for i, c in enumerate(carry))
        params = tuple(take(p, need[n_c + n_x + i])
                       for i, p in enumerate(params))
        if grad:
            self.in_edges = [[_edge(c) if need[i] else None
                              for i, c in enumerate(carry)],
                             [_edge(p) if need[n_c + n_x + i] else None
                              for i, p in enumerate(params)]]
            self.x_edges, self.y_edges, self.first = [], [], []
        ys = []
        for j, t in enumerate(self.idx):
            if j == 2:                   # the bulk, steps 2 .. S-3
                _add_bulk(cost, S - 4, c0, c1)
                self.box["saved"] = _reserve((S - 4) * (c1[3] - c0[3]))
            x_t = tuple(take(x.select(1, t), need[n_c + i])
                        for i, x in enumerate(xs))
            if grad:
                self.x_edges.append([_edge(x) if x.requires_grad else None
                                     for x in x_t])
            carry, y = self.step(carry, x_t, *params)
            ys.append(y)
            del x_t, y
            if j == 0:
                c0 = _snapshot(cost)
            elif j == 1:
                c1 = _snapshot(cost)
            if grad:
                self._mark(ys[-1], carry)
        if grad:
            self.carry_edges = [_edge(c) if c.requires_grad else None
                                for c in carry]
        y1 = ys[1].untyped_storage()._cdata
        out = torch.empty((ys[0].shape[0], S, *ys[0].shape[1:]),
                          dtype=ys[0].dtype)
        cost.bytes += 2 * nbytes_of(out)       # the stack: S in, S out
        del ys
        # what step 1 left live beyond the stack is what every bulk step
        # leaves: its output freed with the list, unless a later step
        # saved it
        keep = c1[3] - c0[3]
        if y1 not in cost._storages:
            keep -= nbytes_of(out) // S
        self.box["saved"] = None
        self.box["saved"] = _reserve((S - 4) * keep)
        self.keep = keep
        return out, carry

    def _mark(self, y, carry) -> None:
        """The edges of a real step's output and the node its VJP starts
        at: the last one the step created (its VJP runs after the next
        token's, before the previous token's)."""
        self.y_edges.append(_edge(y) if y.requires_grad else None)
        nodes = [o.grad_fn for o in (y, *carry) if o.grad_fn is not None]
        self.first.append(max(nodes, key=lambda n: n._sequence_nr())
                          if nodes else None)

    def backward(self, g_ys, g_carry):
        """The VJPs of the real steps, in one engine run over their
        graph, and the bulk's counted between tokens S-2 and 1 (node
        hooks).  Returns the gradients of the carry, the inputs and the
        params (None where not needed)."""
        cost, S, box, keep = self.cost, self.S, self.box, self.keep
        outs, grads = [], []
        for j, t in enumerate(self.idx):
            if g_ys is not None and self.y_edges[j] is not None:
                outs.append(self.y_edges[j])
                grads.append(g_ys.select(1, t))
        for e, g in zip(self.carry_edges, g_carry):
            if g is not None and e is not None:
                outs.append(e)
                grads.append(g)
        has = [e is not None for e in self.x_edges[0]]
        per = sum(has)
        ins = [e for row in self.x_edges for e in row if e is not None]
        others = [e for row in self.in_edges for e in row if e is not None]

        # the hooks hold no node (a node holds its hooks: no cycle)
        def at_token_s2(_grads):          # token S-2's VJP starts
            box["before"] = _snapshot(cost)

        def at_token_1(_grads):           # token S-2's VJP has ended
            before, after = box["before"], _snapshot(cost)
            _add_bulk(cost, S - 4, before, after)
            box["saved"] = None
            box["pieces"] = _reserve((S - 4) * (after[3] - before[3] + keep))
        hooks = [self.first[2].register_prehook(at_token_s2),
                 self.first[1].register_prehook(at_token_1)]
        try:
            got = list(torch.autograd.grad(outs, ins + others, grads,
                                           allow_unused=True))
        finally:
            for h in hooks:
                h.remove()
        del outs, grads, g_ys, g_carry
        pieces, got = got[:len(ins)], got[len(ins):]
        # the real loop's unbind backwards: one stack of S token gradients
        # per input, the last input's first, each freeing its tokens'
        # gradients; the bulk's tokens are split as token S-2's are
        order = [i for i in reversed(range(len(has))) if has[i]]
        slot = {i: sum(has[:i]) for i in order}
        last = {}
        for i in order:
            p = pieces[2 * per + slot[i]]
            if p is not None:
                last[p.untyped_storage()._cdata] = (i, p.untyped_storage()
                                                    .nbytes())
        share = {i: 0 for i in order}
        for i, n in last.values():
            share[i] += n
        grew = box["pieces"].numel() if box.get("pieces") is not None else 0
        if grew != (S - 4) * sum(share.values()):
            raise AssertionError(
                f"a bulk step's VJP left {grew // (S - 4)} bytes live, its "
                f"token gradients hold {sum(share.values())}")
        box["pieces"] = None
        parts = {i: _reserve((S - 4) * share[i]) for i in order}
        x_grads = [None] * len(has)
        for i in order:
            mine = pieces[slot[i]::per]
            ref = next(p for p in mine if p is not None)
            full = torch.empty((ref.shape[0], S, *ref.shape[1:]),
                               dtype=ref.dtype)
            cost.bytes += 2 * nbytes_of(full)
            x_grads[i] = full
            for q in range(slot[i], len(pieces), per):
                pieces[q] = None
            parts[i] = None
            del mine, ref, full
        box.clear()
        it = iter(got)
        c_grads, p_grads = [[next(it) if e is not None else None
                             for e in row] for row in self.in_edges]
        self.x_edges = self.y_edges = self.first = self.step = None
        self.carry_edges = self.in_edges = None
        return c_grads + x_grads + p_grads


class _CountedLoop(torch.autograd.Function):
    """The counted loop under autograd: `_Loop.forward` records a graph
    of the real steps on detached inputs; the backward runs it."""

    @staticmethod
    def forward(ctx, loop, n_carry, *tensors):    # carry, xs, params
        ctx.set_materialize_grads(False)
        with torch.enable_grad():
            ys, carry = loop.forward(list(ctx.needs_input_grad[2:]))
        ctx.loop = loop
        return (ys, *[c.detach() for c in carry])

    @staticmethod
    def backward(ctx, g_ys, *g_carry):
        loop, ctx.loop = ctx.loop, None
        return (None, None, *loop.backward(g_ys, g_carry))


class CountedScan:
    """`models.scan.scan` for the dry-run: a loop of at most ``limit``
    tokens runs (None: the caller runs it); a longer one runs its steps
    at tokens 0, 1, S-2 and S-1 and counts steps 2 .. S-3 as step 1 --
    its flops and bytes, forward and, under autograd, backward -- and
    holds the live bytes each leaves behind (autograd's saved tensors,
    the token outputs until the stack, the token gradients until their
    stack) as fake storage.  Outputs and the final carry have the whole
    loop's shapes; the stack of the outputs and of each input's token
    gradients is counted as the real loop's (S tokens read, S written).
    No collective may run inside a step."""

    def __init__(self, cost: "LocalCost", limit: int = TOKEN_LOOP_LIMIT):
        if limit < 4:
            raise ValueError("a counted loop runs four real steps")
        self.cost, self.limit = cost, limit

    def __call__(self, step, carry, xs, params):
        if xs[0].shape[1] <= self.limit:
            return None
        self.cost.counted_loops += 1
        loop = _Loop(self.cost, step, carry, xs, params)
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (*carry, *xs, *params)):
            out = _CountedLoop.apply(loop, len(carry), *carry, *xs, *params)
            return tuple(out[1:]), out[0]
        ys, carry = loop.forward()
        return carry, ys


@contextlib.contextmanager
def local_mixers(model: nn.Module, mesh, cost: "LocalCost",
                 loop_limit: int = TOKEN_LOOP_LIMIT):
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
    this plan costs.  A token loop longer than ``loop_limit`` is counted
    into ``cost``, the run's `LocalCost` (`CountedScan`)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.models import scan as _scan
    from repro_torch.models.mamba import Mamba
    from repro_torch.models.moe import MoE
    from repro_torch.models.xlstm import MLSTM, SLSTM

    def wrap(mod, fn):
        def run(x, *rest):     # (x) or (x, state): the mixers' methods
            if not isinstance(x, DTensor):
                return fn(x, *rest)
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
        with _scan.counting(CountedScan(cost, loop_limit)):
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
