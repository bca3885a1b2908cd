"""Program builders for the dry-run, the port of `repro/launch/programs.py`.

``build_program(cfg, shape)`` assembles, for one (architecture × input
shape), the function to run plus its arguments — fake tensors
(``FakeTensorMode``: shapes and dtypes, no memory) at full width — and
their logical-axes trees:

  train_4k     -> train_step(params, opt_state, batch)   (make_train_step)
  prefill_32k  -> prefill(params, batch)                 (LM.prefill)
  decode_32k   -> decode_step(params, state, tok)        (LM.decode_step)
  long_500k    -> decode_step with a 524288-token state; pure-attention
                  archs switch to the sliding-window variant
                  (cfg.for_long_context()), SSM/hybrids run natively.

``Program.args`` and ``arg_axes`` keep the reference's tree layout
(tuples, ``AdamState``, the batch and state dicts, ``StoreState``) so
the two can be compared leaf by leaf.  Two leaves differ in form: the
parameters are the model's ``state_dict`` in the port's layout, each
with a `models.param.LeafAxes` that maps it onto the reference's
stacked leaf, and a decode state holds one dict per layer (its leaves'
axes lack the reference's replicated leading ``layers`` entry).  The
optimizer's step and the state's ``cur_len`` are 0-d int32 leaves, as
the reference's; their values never reach the work (the train step
runs its first update, a decode step writes position ``seq_len - 1``).

``Program.fn(*args, place=None)`` runs the program on the model, whose
parameters it first replaces by ``args[0]``'s tensors.  ``place(tree,
axes)`` (the dry-run's) turns a tree of meta-device tensors into
tensors placed on its mesh; prefill builds its output state with it.
On fake CPU tensors the kernels' ``ops.py`` take their plain versions:
that is the count of the function, and no kernel path is entered.

``resolve_config`` sets the reference's fields, ``scan_layers``,
``unroll_inner`` and ``remat`` among them: they are levers for XLA's
cost analysis, which the port's one-module-per-layer loops ignore.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ATTN, INPUT_SHAPES, ModelConfig, \
    ShapeConfig
from repro_torch.models import blocks
from repro_torch.models.model import LM, Encoder, lm_state_axes
from repro_torch.models.param import A, param_axes
from repro_torch.training.optim import AdamState, adamw
from repro_torch.training.train import make_train_step

BIG_MODEL_PARAMS = 100e9   # above this, Adam moments go bf16


@dataclass
class Program:
    name: str
    cfg: ModelConfig
    shape: ShapeConfig
    fn: Callable
    args: Tuple[Any, ...]        # fake-tensor trees
    arg_axes: Tuple[Any, ...]    # encoded-axes / LeafAxes trees
    out_axes: Any                # encoded-axes tree matching fn output
    model: nn.Module = None      # the module fn runs (fake parameters)
    mode: Any = None             # the FakeTensorMode of args and model


def resolve_config(cfg: ModelConfig, shape: ShapeConfig,
                   unroll: bool = True) -> ModelConfig:
    if (shape.name == "long_500k"
            and all(s.mixer == ATTN for s in cfg.period)):
        # pure-attention archs need the bounded-window variant at 500k
        cfg = cfg.for_long_context()
    if unroll:
        cfg = cfg.replace(scan_layers=False, unroll_inner=True, remat=False)
    return cfg


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


def load_params(model: nn.Module, params: dict) -> None:
    """Make ``params`` (state-dict keys -> tensors) ``model``'s
    parameters, in place of its own."""
    for key, t in params.items():
        *path, name = key.split(".")
        mod = model.get_submodule(".".join(path))
        mod._parameters[name] = t if isinstance(t, nn.Parameter) \
            else nn.Parameter(t, requires_grad=t.requires_grad)


def _batch_specs(cfg: ModelConfig, shape: ShapeConfig):
    """Token (+ frontend stub) tensors; frontend tokens count toward S."""
    B, S = shape.global_batch, shape.seq_len
    s_tok = S - (cfg.frontend_len if cfg.frontend else 0)
    batch = {"tokens": torch.zeros((B, s_tok), dtype=torch.int32)}
    axes = {"tokens": A("batch", "seq")}
    if cfg.frontend:
        batch["frontend_embeds"] = torch.zeros(
            (B, cfg.frontend_len, cfg.d_model), dtype=getattr(torch, cfg.dtype))
        axes["frontend_embeds"] = A("batch", "seq", "embed")
    return batch, axes


def _opt_axes(param_axes_):
    return AdamState(step=A(), m=param_axes_, v=param_axes_)


def _state_shapes(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """`LM.init_lm_state`'s tree on the meta device: shapes only."""
    return {"layers": [blocks.init_layer_state(cfg, spec, batch, seq_len,
                                               "meta")
                       for spec in cfg.layer_specs()],
            "cur_len": 0}


def build_program(cfg: ModelConfig, shape: ShapeConfig,
                  unroll: bool = True, overrides: dict | None = None
                  ) -> Program:
    cfg = resolve_config(cfg, shape, unroll=unroll)
    if overrides:
        cfg = cfg.replace(**overrides)
    mode = _fake_mode()
    with mode:
        model = LM(cfg, seed=0, device="cpu")
        pv = dict(model.named_parameters())
        pax = param_axes(cfg, model)

        if shape.kind == "train":
            state_dtype = (torch.bfloat16
                           if cfg.param_count() > BIG_MODEL_PARAMS else None)
            init_opt, update = adamw(3e-4, max_grad_norm=1.0,
                                     state_dtype=state_dtype)
            opt = init_opt(pv)
            opt = AdamState(step=torch.zeros((), dtype=torch.int32),
                            m=opt.m, v=opt.v)
            batch, batch_axes = _batch_specs(cfg, shape)

            def fn(pv_, opt_, batch_, place=None):
                load_params(model, pv_)
                step = make_train_step(model, update)
                new_opt, metrics = step(AdamState(0, opt_.m, opt_.v), batch_)
                return pv_, new_opt, metrics

            metric_axes = {k: A() for k in ("loss", "nll", "aux",
                                            "grad_norm", "lr")}
            return Program("train_step", cfg, shape, fn, (pv, opt, batch),
                           (pax, _opt_axes(pax), batch_axes),
                           (pax, _opt_axes(pax), metric_axes), model, mode)

        if shape.kind == "prefill":
            batch, batch_axes = _batch_specs(cfg, shape)
            cache_len = shape.seq_len

            def fn(pv_, batch_, place=None):
                load_params(model, pv_)
                state = None
                if place is not None:
                    state = place(_state_shapes(
                        cfg, batch_["tokens"].shape[0], cache_len),
                        lm_state_axes(cfg))
                return model.prefill(batch_["tokens"], cache_len,
                                     batch_.get("frontend_embeds"),
                                     state=state)

            return Program("serve_prefill", cfg, shape, fn, (pv, batch),
                           (pax, batch_axes),
                           (A("batch", "vocab"), lm_state_axes(cfg)),
                           model, mode)

        if shape.kind == "decode":
            B = shape.global_batch
            state = model.init_lm_state(B, shape.seq_len)
            state["cur_len"] = torch.zeros((), dtype=torch.int32)
            tok = torch.zeros((B, 1), dtype=torch.int32)
            pos = shape.seq_len - 1

            def fn(pv_, state_, tok_, place=None):
                load_params(model, pv_)
                return model.decode_step(
                    {"layers": state_["layers"], "cur_len": pos}, tok_)

            return Program("serve_decode", cfg, shape, fn, (pv, state, tok),
                           (pax, lm_state_axes(cfg), A("batch", "seq")),
                           (A("batch", "vocab"), lm_state_axes(cfg)),
                           model, mode)

    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# The paper's own serving step: semantic-cache lookup at fleet scale
# ---------------------------------------------------------------------------

CACHE_SHAPE = ShapeConfig("cache_lookup", "cache", 64, 1024)  # 64-tok queries
CACHE_CAPACITY = 1_048_576     # 1M cached queries


def build_cache_program(corpus: int = CACHE_CAPACITY,
                        batch: int = CACHE_SHAPE.global_batch,
                        max_len: int = CACHE_SHAPE.seq_len,
                        variant: str = "auto",
                        keys_dtype=torch.float32,
                        overrides: dict | None = None) -> Program:
    """cache_serve(params, store, tokens, mask) -> (hit, scores, slots).

    Embeds a batch of queries with the encoder (modernbert-149m) and
    queries a 1M-entry store sharded over the ``model`` axis — the
    distributed analogue of the paper's Redis lookup (DESIGN.md §3).

    variant: 'auto' = `core.store.query` on the placed store (the
    sharding propagation partitions it: the baseline); 'shardmap' =
    `core.store.query_block`, `query_sharded`'s explicit local-top-k +
    tiny-merge schedule, on each rank's local block of a store split by
    rows over ``model`` (the whole queries gathered first).
    Both run forward only (no autograd graph), as the reference's jitted
    forward and the served lookup do.  The reference's ``multi_pod``
    argument picks its mesh; the port's comes with the placed store.
    """
    from repro_torch.configs import get_config
    from repro_torch.core.store import (
        StoreState, query as store_query, query_block, store_axes,
    )

    cfg = get_config("modernbert-149m").replace(
        scan_layers=False, unroll_inner=True, remat=False,
        **(overrides or {}))
    mode = _fake_mode()
    with mode:
        model = Encoder(cfg, seed=0, device="cpu")
        pv = dict(model.named_parameters())
        pax = param_axes(cfg, model)
        d = cfg.d_model
        i32 = torch.int32
        store = StoreState(
            keys=torch.zeros((corpus, d), dtype=keys_dtype),
            valid=torch.zeros((corpus,), dtype=torch.bool),
            last_used=torch.zeros((corpus,), dtype=i32),
            inserted_at=torch.zeros((corpus,), dtype=i32),
            value_ids=torch.zeros((corpus,), dtype=i32),
            clock=torch.zeros((), dtype=i32),
        )
        tokens = torch.zeros((batch, max_len), dtype=i32)
        mask = torch.ones((batch, max_len), dtype=torch.bool)

    if variant == "shardmap":
        def fn(pv_, store_, tokens_, mask_, place=None):
            load_params(model, pv_)
            block, lo, mesh = _local_block(store_)
            with torch.no_grad():
                emb = model.encode(tokens_, mask_)
                if hasattr(emb, "full_tensor"):
                    emb = emb.full_tensor()
                res = query_block(block, lo, emb, threshold=0.9, k=1,
                                  mesh=mesh)
            return res.hit, res.scores, res.slots
    else:
        def fn(pv_, store_, tokens_, mask_, place=None):
            load_params(model, pv_)
            with torch.no_grad():
                emb = model.encode(tokens_, mask_)
                res = store_query(store_, emb, threshold=0.9, k=1)
            return res.hit, res.scores, res.slots

    args = (pv, store, tokens, mask)
    arg_axes = (pax, store_axes(), A("batch", "seq"), A("batch", "seq"))
    out_axes = (A("batch"), A("batch", "."), A("batch", "."))
    return Program(f"cache_serve_{variant}", cfg, CACHE_SHAPE, fn, args,
                   arg_axes, out_axes, model, mode)


def _local_block(store):
    """(this rank's rows of the placed ``store``, their first row, the
    mesh): keys, valid and value ids must be split by rows over
    ``model`` alone."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(store.keys, DTensor):
        raise ValueError("the shardmap variant runs on a store placed on "
                         "a mesh")
    mesh = store.keys.device_mesh
    want = tuple(Shard(0) if a == "model" else Replicate()
                 for a in mesh.mesh_dim_names)
    loc = {}
    for f in ("keys", "valid", "value_ids"):
        t = getattr(store, f)
        if tuple(t.placements) != want:
            raise ValueError(f"store {f} placed {t.placements}, the "
                             f"shardmap lookup needs {want}")
        loc[f] = t.to_local()
    lo = mesh.get_local_rank("model") * loc["keys"].shape[0]
    return store._replace(**loc), lo, mesh


def get_program(arch: str, shape_name: str, unroll: bool = True,
                overrides: dict | None = None, *, reduced: bool = False,
                corpus: int = CACHE_CAPACITY) -> Program:
    """The reference's ``get_program`` (its ``multi_pod`` picks the mesh,
    which the dry-run builds here apart from the program); ``reduced``
    builds the config's ``reduced()`` variant and ``corpus`` sizes the
    cache program's store (both for CPU tests)."""
    from repro_torch.configs import get_config
    if arch.startswith("langcache") or shape_name == "cache_lookup":
        variant = "auto" if arch == "langcache" else "shardmap"
        keys_dtype = torch.bfloat16 if arch.endswith("-v3") else torch.float32
        ov = dict(overrides or {})
        if reduced:
            full = get_config("modernbert-149m")
            small = full.reduced()
            ov = {**{f.name: getattr(small, f.name)
                     for f in dataclasses.fields(small)
                     if f.name not in ("name", "scan_layers", "unroll_inner",
                                       "remat")
                     and getattr(small, f.name) != getattr(full, f.name)},
                  **ov}
        return build_cache_program(corpus=corpus, variant=variant,
                                   keys_dtype=keys_dtype,
                                   overrides=ov or None)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    return build_program(cfg, INPUT_SHAPES[shape_name], unroll=unroll,
                         overrides=overrides)
