"""Fleet dry-run: run every (arch × shape) on the production mesh with no
data, and extract per-device memory, work, collectives and the H100
roofline — the port of `repro/launch/dryrun.py`.

The reference lowers and compiles on 512 placeholder host devices.  The
port starts a ``"fake"`` ``torch.distributed`` group of 256 or 512 ranks
in this process (`launch.mesh.fake_process_group`), builds the
production ``DeviceMesh`` on it, places every argument leaf as a
``DTensor`` over a ``FakeTensor`` local shard (the rules of
`launch.sharding`, rank 0's shard: no memory), and runs the program
under ``FakeTensorMode``.  ``DTensor`` propagates the shardings op by op
and issues real collective calls on the fake group, which move nothing.

Usage (``--device cpu`` without a card; with one, its memory is the
per-GPU budget):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out build/dryrun/dr
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch langcache --shape cache_lookup --multi-pod

The counting is `launch.localcost`'s: per device, on the local shards
(argument bytes exact from `launch.sharding.sharded_bytes`; output and
temp bytes from live storage; flops and unfused bytes of each local
op; the collectives issued, into `launch.roofline`'s ring model).

The counts follow the strategies ``DTensor`` picks, which differ between
torch releases (2.11 and 2.13, say): the same program can come out
batch-sharded on one and batch-replicated, with many times the flops,
on the other (the reference's §Perf H6, which ``--constrain-acts``
anchors).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback

import torch
from torch import nn

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES
from repro_torch.launch import mesh as _mesh
from repro_torch.launch.localcost import (
    TOKEN_LOOP_LIMIT, EinsumRule, LocalCost, contiguous_stride, fake_mesh,
    local_mixers, nbytes_of, tensors_in,
)
from repro_torch.launch.programs import get_program
from repro_torch.launch.roofline import model_flops, roofline_terms
from repro_torch.launch.sharding import (
    RULE_SETS, leaf_spec, local_shape, map_axes, mesh_sizes, placements,
    port_dims, sharded_bytes,
)


# The ops `LocalCost` may run outside ``DTensor``'s sharding strategies
# (replicated first, or on local copies), each a known gap of a torch
# release the port runs on (2.11 on the card, 2.13 without one).  Any
# other fallback fails the pair, as a sharding bug fails the reference's.
KNOWN_FALLBACKS = {
    "fill_ (local)": "fill_ with a 0-d tensor value, no strategy on 2.11 "
                     "or 2.13: a decode step's write of its position",
    "aten.searchsorted.Tensor (local, replicated)":
        "no strategy on 2.11 or 2.13 (the MoE's runs batch-local)",
    "aten.index.Tensor (replicated)":
        "2.11: a row gather from a row-sharded table (the embedding's "
        "table[tokens], the store's value_ids[slots])",
    "aten.index_put.default (replicated)":
        "2.11: the embedding's backward, an accumulating index_put into "
        "the table's gradient",
    "aten.view.default (replicated, a sharded dim split)":
        "2.11 and 2.13: a view splitting a sharded dim into an outer "
        "factor its mesh dim does not divide (`localcost._splits_shards`; "
        "any other view that falls back fails): the attention's q.reshape "
        "of the query heads, sharded over model=16, into fewer KV groups "
        "(StarCoder2-15B's 48 into 4, Jamba's 64 into 8 on 2.11).  The "
        "attention then runs on q replicated over model, which the "
        "reference's GSPMD does not: the pair's counts are this plan's",
}


def check_fallbacks(name: str, fallbacks) -> None:
    """Raise unless every op that fell back is a known gap."""
    unknown = sorted(set(fallbacks) - set(KNOWN_FALLBACKS))
    if unknown:
        raise RuntimeError(
            f"{name}: ops outside DTensor's sharding strategies that are no "
            f"known gap: {unknown} (a sharding bug, or a gap of this torch "
            f"release to name in KNOWN_FALLBACKS)")


def make_placer(mesh, rules):
    """``place(values, axes)``: a tree of tensors -> ``DTensor``s over
    fake local shards on ``mesh`` under ``rules`` (parameters stay
    parameters); other leaves pass."""
    from torch.distributed.tensor import DTensor

    def one(v, a):
        if not isinstance(v, torch.Tensor):
            return v
        pl = placements(leaf_spec(v, a, mesh, rules), mesh, port_dims(v, a))
        local = torch.empty(local_shape(v, a, mesh, rules), dtype=v.dtype)
        d = DTensor.from_local(local, mesh, pl, run_check=False,
                               shape=tuple(v.shape),
                               stride=contiguous_stride(tuple(v.shape)))
        if isinstance(v, nn.Parameter):
            return nn.Parameter(d, requires_grad=v.requires_grad)
        return d

    def place(values, axes):
        return map_axes(one, values, axes)
    return place


def _axes_used(placed, mesh) -> list:
    """The mesh axes (of more than one rank) that shard some argument."""
    sizes = list(mesh_sizes(mesh).items())
    used = set()
    for t in tensors_in(placed):
        for (name, n), p in zip(sizes, getattr(t, "placements", ())):
            if p.is_shard() and n > 1:
                used.add(name)
    return sorted(used)


def measure(prog, mesh, rules: str = "train", constrain_acts: bool = False,
            loop_limit: int = TOKEN_LOOP_LIMIT) -> dict:
    """Run ``prog`` on ``mesh`` (a ``DeviceMesh`` of the fake group) and
    count it: argument, output and temp bytes per device, local flops
    and bytes, collective records and fallbacks (raises on a fallback
    outside ``KNOWN_FALLBACKS``).  A recurrent token loop longer than
    ``loop_limit`` tokens is counted, not run (`localcost.CountedScan`)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.actsharding import activation_ctx

    rule_set = RULE_SETS[rules]
    place = make_placer(mesh, rule_set)
    n_dev = math.prod(mesh_sizes(mesh).values())
    t0 = time.perf_counter()
    with prog.mode:
        placed = tuple(place(a, ax) for a, ax in zip(prog.args,
                                                     prog.arg_axes))
        arg_bytes = sharded_bytes(prog.args, prog.arg_axes, mesh, rule_set)
        local = sum(nbytes_of(t.to_local()) for t in tensors_in(placed))
        if local != arg_bytes:
            raise AssertionError(f"placed shards hold {local} bytes, "
                                 f"sharded_bytes says {arg_bytes}")
        t_place = time.perf_counter() - t0
        cost = LocalCost(n_dev)
        acts = activation_ctx(mesh) if constrain_acts \
            else contextlib.nullcontext()
        with implicit_replication(), acts, \
                local_mixers(prog.model, mesh, cost, loop_limit), \
                EinsumRule(), cost:
            out = prog.fn(*placed, place=place)
        t_run = time.perf_counter() - t0 - t_place
        output_bytes = cost.held_bytes(out)
        axes_used = _axes_used(placed, mesh)
    del out
    check_fallbacks(prog.name, cost.fallbacks)
    return {"args": arg_bytes, "output": output_bytes, "temp": cost.peak,
            "flops": cost.flops, "bytes": cost.bytes,
            "records": cost.records, "fallbacks": dict(cost.fallbacks),
            "counted_loops": cost.counted_loops,
            "axes_used": axes_used, "t_place": t_place, "t_run": t_run}


def mesh_shape(multi_pod: bool) -> dict:
    return ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            rules: str = "train", unroll: bool = True,
            overrides: dict | None = None, constrain_acts: bool = False,
            verbose: bool = True, mesh: dict | None = None,
            reduced: bool = False, corpus: int | None = None,
            device="cpu") -> dict:
    """One (arch × shape) on the production mesh (``mesh`` names another
    shape, e.g. ``{"data": 2, "model": 2}``).  ``unroll`` is the
    reference's switch between its unrolled roofline pass and its
    scanned multi-pod pass; the port runs its layers one module at a
    time either way and counts every layer.  ``overrides``:
    ``ModelConfig.replace`` kwargs; ``reduced`` and ``corpus`` shrink the
    config and the cache program's store (CPU tests); ``device`` names
    the card whose memory is the per-GPU budget (``"cpu"``: the H100's
    80 GB).  Runs in a fake process group of its own, destroyed on
    return; refuses to run beside another group."""
    t0 = time.perf_counter()
    kw = {} if corpus is None else {"corpus": corpus}
    prog = get_program(arch, shape_name, unroll=unroll, overrides=overrides,
                       reduced=reduced, **kw)
    t_build = time.perf_counter() - t0
    sizes = mesh or mesh_shape(multi_pod)
    n_dev = math.prod(sizes.values())
    budget = _mesh.device_memory_bytes(device)
    with fake_mesh(sizes) as m:
        r = measure(prog, m, rules, constrain_acts)
    terms = roofline_terms({"flops": r["flops"], "bytes accessed": r["bytes"]},
                           r["records"], n_dev)
    mf = model_flops(prog.cfg, prog.shape)
    total_flops = terms["per_device_flops"] * n_dev
    peak = r["args"] + r["temp"]
    result = {
        "arch": arch,
        "shape": shape_name,
        "program": prog.name,
        "mesh": list(sizes.values()),
        "mesh_axes": list(sizes),
        "multi_pod": multi_pod,
        "rules": rules,
        "unrolled": unroll,
        "overrides": overrides or {},
        "constrain_acts": constrain_acts,
        "reduced": reduced,
        "config_name": prog.cfg.name,
        "param_count": prog.cfg.param_count(),
        "param_count_active": prog.cfg.param_count(active_only=True),
        "memory": {
            "argument_bytes_per_device": r["args"],
            "output_bytes_per_device": r["output"],
            "temp_bytes_per_device": r["temp"],
            "peak_estimate_gib": peak / 2**30,
            "device_memory_bytes": budget,
            "fits": peak <= budget,
        },
        "roofline": terms,
        "model_flops": mf,
        "hlo_total_flops": total_flops,
        "useful_flops_ratio": (mf / total_flops if total_flops else 0.0),
        "fallbacks": r["fallbacks"],
        "counted_loops": r["counted_loops"],
        "mesh_axes_sharding_args": r["axes_used"],
        "lower_seconds": round(t_build + r["t_place"], 2),
        "compile_seconds": round(r["t_run"], 2),
    }
    if verbose:
        print(f"== {arch} × {shape_name} "
              f"({'x'.join(map(str, sizes.values()))} {tuple(sizes)}, "
              f"rules={rules}) ==")
        print(f"  program={prog.name}  params={result['param_count']:.3e} "
              f"(active {result['param_count_active']:.3e})")
        print(f"  memory/dev: args={r['args'] / 2**30:.2f}GiB "
              f"temp={r['temp'] / 2**30:.2f}GiB "
              f"out={r['output'] / 2**30:.2f}GiB "
              f"(peak {peak / 2**30:.2f} of {budget / 2**30:.1f} GiB)")
        print(f"  local work/dev: flops={terms['per_device_flops']:.3e} "
              f"bytes={terms['per_device_bytes']:.3e}")
        print(f"  collectives/dev: {terms['per_device_collective_bytes']:.3e}"
              f" B {terms['collective_counts']} "
              f"by link {terms['collective_by_link']}")
        print(f"  H100 roofline: compute={terms['t_compute'] * 1e3:.3f}ms "
              f"memory={terms['t_memory'] * 1e3:.3f}ms "
              f"collective={terms['t_collective'] * 1e3:.3f}ms "
              f"-> bottleneck={terms['bottleneck']}")
        print(f"  MODEL_FLOPS/LOCAL_FLOPS={result['useful_flops_ratio']:.3f}"
              f"  fallbacks={r['fallbacks']}  counted loops="
              f"{r['counted_loops']}  build+place="
              f"{result['lower_seconds']}s run={result['compile_seconds']}s")
    return result


def run_extrapolated(arch: str, shape_name: str, *, rules: str = "train",
                     multi_pod: bool = False, unroll: bool = True,
                     overrides: dict | None = None,
                     constrain_acts: bool = False, verbose: bool = True,
                     mesh: dict | None = None, reduced: bool = False,
                     device="cpu") -> dict:
    """Roofline terms without running the whole stack: run 1-period and
    2-period variants and scale the per-period delta,
    X(N) = X(1) + (N-1)·(X(2) - X(1)) — exact for layer-linear terms
    (flops, bytes, collectives and argument bytes of identical layers);
    embed/loss costs live in X(1); collective counts, fallbacks and
    counted token loops scale the same way.  Temp is a peak, not a sum:
    its extrapolation is the reference's estimate.  An ``n_layers`` override
    sets N; the others reach every variant.  Decoders only: the cache
    program has no layer periods to scale (refused)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.programs import build_program, resolve_config

    if arch.startswith("langcache") or shape_name == "cache_lookup":
        raise ValueError("--extrapolate scales a decoder's layer periods; "
                         "the cache program runs whole (drop the flag)")
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    ov = dict(overrides or {})
    period = len(cfg.period)
    n = ov.pop("n_layers", cfg.n_layers) // period
    shape = INPUT_SHAPES[shape_name]
    sizes = mesh or mesh_shape(multi_pod)
    n_dev = math.prod(sizes.values())
    budget = _mesh.device_memory_bytes(device)
    xs = []
    for k in (1, 2):
        sub = cfg.replace(n_layers=k * period, name=f"{cfg.name}-x{k}")
        prog = build_program(sub, shape, unroll=unroll, overrides=ov or None)
        with fake_mesh(sizes) as m:
            r = measure(prog, m, rules, constrain_acts)
        coll = roofline_terms({}, r["records"], n_dev)
        xs.append({"flops": r["flops"], "bytes": r["bytes"],
                   "coll": coll["per_device_collective_bytes"],
                   "t_coll": coll["t_collective"],
                   "args": r["args"], "temp": r["temp"],
                   "counts": coll["collective_counts"],
                   "links": coll["collective_by_link"],
                   "loops": r["counted_loops"], "fallbacks": r["fallbacks"],
                   "axes": r["axes_used"], "t_run": r["t_run"],
                   "t_place": r["t_place"]})
    x1, x2 = xs

    def ext(key, a=x1, b=x2):
        return a.get(key, 0) + (n - 1) * (b.get(key, 0) - a.get(key, 0))

    def ext_all(field):
        keys = sorted(set(x1[field]) | set(x2[field]))
        return {k: ext(k, x1[field], x2[field]) for k in keys}

    full = resolve_config(cfg.replace(n_layers=n * period), shape,
                          unroll=unroll)
    if ov:
        full = full.replace(**ov)
    terms = {
        "per_device_flops": ext("flops"),
        "per_device_bytes": ext("bytes"),
        "per_device_collective_bytes": ext("coll"),
        "t_compute": ext("flops") / _mesh.PEAK_FLOPS_BF16,
        "t_memory": ext("bytes") / _mesh.HBM_BANDWIDTH,
        "t_collective": ext("t_coll"),
        "collective_counts": ext_all("counts"),
        "collective_by_link": ext_all("links"),
        "collective_top_ops": [],
        "collective_breakdown": {},
    }
    dom = max(("compute", "memory", "collective"),
              key=lambda k: terms[f"t_{k}"])
    terms["bottleneck"] = dom
    terms["t_bound"] = terms[f"t_{dom}"]
    terms["roofline_fraction"] = (terms["t_compute"] / terms["t_bound"]
                                  if terms["t_bound"] else 0.0)
    mf = model_flops(full, shape)
    total = terms["per_device_flops"] * n_dev
    peak = ext("args") + ext("temp")
    result = {
        "arch": arch, "shape": shape_name, "program": prog.name,
        "mesh": list(sizes.values()), "mesh_axes": list(sizes),
        "multi_pod": multi_pod, "rules": rules, "unrolled": unroll,
        "extrapolated": True, "overrides": overrides or {},
        "constrain_acts": constrain_acts, "reduced": reduced,
        "config_name": full.name,
        "param_count": full.param_count(),
        "param_count_active": full.param_count(active_only=True),
        "memory": {"argument_bytes_per_device": ext("args"),
                   "output_bytes_per_device": 0,
                   "temp_bytes_per_device": ext("temp"),
                   "peak_estimate_gib": peak / 2**30,
                   "device_memory_bytes": budget,
                   "fits": peak <= budget},
        "roofline": terms,
        "model_flops": mf,
        "hlo_total_flops": total,
        "useful_flops_ratio": mf / total if total else 0.0,
        "fallbacks": ext_all("fallbacks"), "counted_loops": ext("loops"),
        "mesh_axes_sharding_args": x2["axes"],
        "lower_seconds": round(x1["t_place"] + x2["t_place"], 2),
        "compile_seconds": round(x1["t_run"] + x2["t_run"], 2),
    }
    if verbose:
        print(f"== {arch} × {shape_name} (EXTRAPOLATED {n} periods) ==")
        print(f"  H100 roofline: compute={terms['t_compute'] * 1e3:.3f}ms "
              f"memory={terms['t_memory'] * 1e3:.3f}ms "
              f"collective={terms['t_collective'] * 1e3:.3f}ms "
              f"-> bottleneck={dom}")
        print(f"  MODEL/LOCAL={result['useful_flops_ratio']:.3f} "
              f"args={ext('args') / 2**30:.2f}GiB")
    return result


# the loop check's mixers: one reduced decoder layer each, (arch, the
# layer's position in the reduced config's period)
LOOP_MIXERS = {"mlstm": ("xlstm-125m", 0), "slstm": ("xlstm-125m", 1),
               "mamba": ("jamba-1.5-large-398b", 0)}


def loop_count_check(cases) -> dict:
    """The counted token loops against the real ones, through the same
    program: for each (mixer of ``LOOP_MIXERS``, shape name, tokens), the
    reduced arch cut to that one mixer layer, the shape at that many
    tokens and a global batch of 4, measured on a fake 2x2 ("data",
    "model") mesh once with every loop longer than
    ``TOKEN_LOOP_LIMIT`` counted (`localcost.CountedScan`) and once with
    every loop run token by token.  {"mixer shape tokens": {"counted":
    counts, "real": counts}}, counts being argument, output and temp
    bytes, flops, bytes, every collective (op, bytes, group, link,
    shape), fallbacks and loops counted; both must be equal but the
    last."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.programs import build_program
    out = {}
    for mixer, shape, tokens in cases:
        arch, i = LOOP_MIXERS[mixer]
        cfg = get_config(arch).reduced()
        cfg = cfg.replace(n_layers=1, period=cfg.period[i:i + 1])
        assert cfg.period[0].mixer == mixer, cfg.period
        sh = dataclasses.replace(INPUT_SHAPES[shape], seq_len=tokens,
                                 global_batch=4)
        runs = {}
        for kind, limit in (("counted", TOKEN_LOOP_LIMIT), ("real", 10 ** 9)):
            prog = build_program(cfg, sh)
            with fake_mesh({"data": 2, "model": 2}) as m:
                r = measure(prog, m, loop_limit=limit)
            runs[kind] = {
                **{k: r[k] for k in ("args", "output", "temp", "flops",
                                     "bytes", "fallbacks", "counted_loops")},
                "collectives": [[c.op, c.out_bytes, c.group, c.link,
                                 list(c.shape)] for c in r["records"]]}
        out[f"{mixer} {shape} {tokens}"] = runs
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + ["cache_lookup", None])
    ap.add_argument("--all", action="store_true",
                    help="run every assigned arch × shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--rules", default="train", choices=list(RULE_SETS))
    ap.add_argument("--out", default=None, help="JSON output path prefix")
    ap.add_argument("--scan", action="store_true",
                    help="the reference's scanned pass (the port counts "
                         "every layer either way)")
    ap.add_argument("--attn-bf16", action="store_true",
                    help="§Perf: bf16 attention probs/accumulator")
    ap.add_argument("--param-bf16", action="store_true",
                    help="§Perf: bf16 master weights (serving)")
    ap.add_argument("--loss-chunk", type=int, default=0,
                    help="§Perf: fused chunked cross-entropy")
    ap.add_argument("--window", type=int, default=0,
                    help="§Perf ablation: sliding-window attention")
    ap.add_argument("--pad-vocab", type=int, default=0,
                    help="§Perf: pad vocab to a shardable multiple")
    ap.add_argument("--pad-experts", type=int, default=0,
                    help="§Perf H7: pad expert count (router-masked)")
    ap.add_argument("--constrain-acts", action="store_true",
                    help="§Perf H6: batch-anchor activation shardings")
    ap.add_argument("--extrapolate", action="store_true",
                    help="1/2-period runs + per-period scaling")
    ap.add_argument("--tag", default="", help="suffix for --out files")
    ap.add_argument("--mesh", default=None,
                    help="another mesh than the production one, e.g. "
                         "data=2,model=2 (axes in mesh-dim order)")
    ap.add_argument("--device", default="cuda",
                    help="the card whose memory is the per-GPU budget "
                         "('cpu': the H100's 80 GB)")
    return ap.parse_args(argv)


def parse_mesh(text: str | None) -> dict | None:
    if not text:
        return None
    return {k: int(v) for k, v in (kv.split("=") for kv in text.split(","))}


def overrides_of(args) -> dict:
    overrides = {}
    if args.window:
        overrides["sliding_window"] = args.window
    if args.pad_vocab:
        overrides["pad_vocab_to"] = args.pad_vocab
    if args.pad_experts:
        overrides["pad_experts_to"] = args.pad_experts
    if args.attn_bf16:
        overrides["attn_f32"] = False
    if args.param_bf16:
        overrides["param_dtype"] = "bfloat16"
    if args.loss_chunk:
        overrides["loss_chunk"] = args.loss_chunk
    return overrides


def main(argv=None):
    args = parse_args(argv)
    _mesh.device_memory_bytes(args.device)       # raises without the card
    overrides = overrides_of(args)
    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    pairs = [(a, s) for a in archs for s in shapes]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results, failures = [], []
    for arch, shape in pairs:
        for mp in meshes:
            try:
                if args.extrapolate:
                    r = run_extrapolated(arch, shape, rules=args.rules,
                                         multi_pod=mp, unroll=not args.scan,
                                         overrides=overrides or None,
                                         constrain_acts=args.constrain_acts,
                                         mesh=parse_mesh(args.mesh),
                                         device=args.device)
                else:
                    r = run_one(arch, shape, multi_pod=mp, rules=args.rules,
                                unroll=not args.scan,
                                overrides=overrides or None,
                                constrain_acts=args.constrain_acts,
                                mesh=parse_mesh(args.mesh),
                                device=args.device)
                results.append(r)
                if args.out:
                    tag = f"{arch}_{shape}_{'mp' if mp else 'sp'}_{args.rules}"
                    if args.tag:
                        tag += f"_{args.tag}"
                    with open(f"{args.out}_{tag}.json", "w") as f:
                        json.dump(r, f, indent=1, default=str)
            except Exception as e:  # a failure here is a sharding bug
                traceback.print_exc()
                failures.append((arch, shape, mp, repr(e)))
    print(f"\n{len(results)} ok, {len(failures)} failed")
    for f in failures:
        print("  FAIL:", f)
    if failures:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
