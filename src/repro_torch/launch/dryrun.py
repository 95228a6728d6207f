"""Production-mesh dry run: trace every (arch x shape x mesh) cell's
sharded step on the ``meta`` device in a fake world of ranks.

The port's counterpart of the JAX package's ``launch/dryrun.py``::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out dryrun_torch.json

The JAX dry run forces 512 host devices and compiles each cell's jitted
step for the production mesh.  Here this process starts a world of
`launch.mesh.n_chips` ``(True)`` = 512 ranks on torch's fake process
group (every collective returns at once and moves nothing) as its rank
0, before any mesh is made; the (16, 16) mesh is the world's first 256
ranks, with a replica past them.  Every tensor lives on ``meta``:
nothing is allocated and no kernel is launched.  The sharded steps are
`train.steps`' own: `make_sharded_train_step` for ``train`` cells,
`make_sharded_prefill_step` / `make_sharded_decode_step` for
``prefill`` / ``decode`` ones, on the state placed by
`launch.shardutil`'s shardings, under the attention route of each
arch's own configuration (the blocked one: ``use_pallas_attn`` is
False, as in the JAX dry run).

Per cell (and appended to a resumable JSON) the record holds, for rank 0:

* ``memory``: ``argument_bytes`` (the local shards of the state or the
  parameters, the decode caches of this rank's rows, and the global
  batch every rank is handed: ``argument_parts`` splits them), with the
  batch's and caches' bytes under the JAX package's roles beside them
  (``*_bytes_by_roles``, `parallel.sharding.spec_bytes_per_device`: the
  reference shards the caches' sequence over ``model``, where the port
  replicates compute along ``model`` and holds its rows' caches whole);
  ``peak_per_device_bytes``, ``MemTracker``'s peak over one step with
  the arguments tracked; ``fits_80gb``;
* ``cost``: ``flops_per_dev`` (``FlopCounterMode``: the products) and
  ``bytes_per_dev`` (`_CostMode`: every aten op's tensor inputs and
  outputs, views and allocations excluded: the counterpart of HLO's
  "bytes accessed");
* ``collectives``: the c10d ops the step issued (`_CostMode`; under the
  fake group they move no data, so only shapes and group sizes count):
  ``raw_bytes`` by kind, ``wire_bytes`` under the JAX dry run's ring
  model per group size (`ring_wire`), ``n_ops`` (and by group size),
  and ``collective_s`` at the NVLink rate for a group inside one 8-card
  node, the NIC rate for one across nodes;
* ``roofline``: ``compute_s``, ``memory_s``, ``collective_s``,
  ``dominant``, ``model_flops`` (`model_flops_for`),
  ``model_flops_per_dev``, ``useful_flops_ratio``, ``roofline_frac``,
  on the H100 spec-sheet constants below.

The counters see every op the step executes, so the JAX package's
``inner_scan_correction`` (XLA's cost analysis counts a rolled loop body
once) has no counterpart: ``inner_scan_corr_flops`` is 0.  Where the
recurrent blocks' Python time loops make a full-depth trace slow
(`TWIN_KINDS`: a mamba, mLSTM or sLSTM block in a train or prefill
cell), cost and peak come from the JAX package's two-twin extrapolation
over groups, F(G) = F1 + (G - 1)(F2 - F1) from 1- and 2-group twins
(``cost_source`` and ``memory_source`` say so): every group adds the
same ops and collectives, and under ``remat="block"`` the same live
bytes (its state shards and its layers' saved inputs) while the peak's
one recomputed block is the same.  ``wall_s`` is the cell's wall on
this host.

An encoder-decoder cell is an error naming the reason: the sharded steps
run decoder LMs.  The process exits 1 when any cell errors, as the JAX
dry run does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, input_specs, shape_applies
from repro_torch.launch import mesh as M
from repro_torch.launch.shardutil import (Sharding, param_shardings,
                                          roles_to_shardings,
                                          state_shardings)
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding as PS
from repro_torch.train import steps as ST
from repro_torch.train.optimizer import OptConfig

# H100 SXM5 80GB at its 700 W limit, NVIDIA's spec sheet (not measured):
# dense bf16 tensor-core rate and HBM3 bandwidth.
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
# NVLink 4 inside one 8-card HGX node, per direction (spec sheet: 900 GB/s
# both ways), and one 400 Gb/s NIC a card (ConnectX-7) between nodes.
NVLINK_BW = 450e9
NIC_BW = 50e9
NODE_CARDS = 8
# ``fits_80gb``'s limit: the card's 80 GB, decimal
HBM_BYTES = 80e9

# block kinds whose Python time loops make a full-depth trace slow
TWIN_KINDS = ("mamba", "mlstm", "slstm")

# ---------------------------------------------------------------------------
# collectives: the JAX dry run's ring wire model
# ---------------------------------------------------------------------------

def ring_wire(op: str, nbytes: float, n: int) -> float:
    """Bytes a rank sends for one collective of ``op`` whose local output
    is ``nbytes``, over a group of ``n`` ranks, in the JAX dry run's ring
    model (its ``parse_collectives``): all-gather (n-1)/n*out, all-reduce
    2*(n-1)/n*bytes, reduce-scatter (n-1)*out, all-to-all (n-1)/n*bytes,
    a collective-permute 1x."""
    if op == "all-gather":
        return nbytes * (n - 1) / n
    if op == "all-reduce":
        return 2 * nbytes * (n - 1) / n
    if op == "reduce-scatter":
        return nbytes * (n - 1)
    if op == "all-to-all":
        return nbytes * (n - 1) / n
    return nbytes


# ---------------------------------------------------------------------------
# model FLOPs
# ---------------------------------------------------------------------------

def model_flops_for(cfg: ModelConfig, kind: str, batch: int, seq: int,
                    actual_params: int) -> float:
    """MODEL_FLOPS: 6·N·D for train, 2·N·D for prefill, 2·N_active·B for
    one decode token (N = active params for MoE)."""
    frac_active = cfg.active_param_count() / max(cfg.param_count(), 1)
    n_active = actual_params * frac_active
    if kind == "train":
        return 6.0 * n_active * batch * seq
    if kind == "prefill":
        return 2.0 * n_active * batch * seq
    return 2.0 * n_active * batch  # decode: one token


# ---------------------------------------------------------------------------
# the JAX package's perf variants (configuration and rule overrides)
# ---------------------------------------------------------------------------

def _v_gw(cfg, rules):
    """ZeRO-3 weight gathering at use."""
    return dataclasses.replace(cfg, gather_weights=True), rules


def _v_serve(cfg, rules):
    """Serving sharding: bf16 params, TP-only (no FSDP axis)."""
    return (dataclasses.replace(cfg, param_dtype="bfloat16"),
            dataclasses.replace(rules, fsdp_axis=None))


def _v_serve_bf16s(cfg, rules):
    """serve + bf16 attention scores/softmax."""
    cfg, rules = _v_serve(cfg, rules)
    return dataclasses.replace(cfg, attn_score_dtype="bfloat16"), rules


def _v_serve_int8kv(cfg, rules):
    """serve + int8 KV cache."""
    cfg, rules = _v_serve_bf16s(cfg, rules)
    return dataclasses.replace(cfg, kv_cache_dtype="int8"), rules


def _v_gw_dots(cfg, rules):
    """gather-weights + dots-saveable remat."""
    return (dataclasses.replace(cfg, gather_weights=True, remat="dots"),
            rules)


def _v_cache4(cfg, rules):
    """llama4: layers as groups of 4, so only the every-4th global layer
    gets a full-length KV cache."""
    assert cfg.global_every == 4 and cfg.group_pattern == ("attn",)
    return dataclasses.replace(cfg, group_pattern=("attn",) * 4), rules


def _v_gw_qblock(cfg, rules):
    """gather-weights + attention q-block 512."""
    return (dataclasses.replace(cfg, gather_weights=True, attn_q_block=512),
            rules)


def _v_moelocal(cfg, rules):
    """Per-DP-shard MoE dispatch (local capacity pools)."""
    assert cfg.moe is not None
    return (dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch="local")),
            rules)


def _v_bf16_moelocal(cfg, rules):
    """local MoE dispatch + bf16 params."""
    cfg, rules = _v_moelocal(cfg, rules)
    return dataclasses.replace(cfg, param_dtype="bfloat16"), rules


VARIANTS = {
    "gw": _v_gw,
    "serve": _v_serve,
    "serve+bf16s": _v_serve_bf16s,
    "serve+int8kv": _v_serve_int8kv,
    "gw+dots": _v_gw_dots,
    "cache4": _v_cache4,
    "gw+cache4": lambda c, r: _v_gw(*_v_cache4(c, r)),
    "serve+cache4": lambda c, r: _v_serve(*_v_cache4(c, r)),
    "gw+qb512": _v_gw_qblock,
    "moelocal": _v_moelocal,
    "moelocal+bf16": _v_bf16_moelocal,
}

# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------


def start_world(world: int = M.n_chips(True)) -> None:
    """Make this process rank 0 of a fake world of ``world`` ranks (once;
    a fake world of that size already started is kept).  Refuses a
    process with another default group: `launch.mesh` caches meshes by
    default group and starts a world of one when there is none, so an
    earlier mesh would be reused silently."""
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        raise RuntimeError(
            f"the dry run needs its own fake world of {world} ranks, but "
            f"this process already has a default group (backend "
            f"{dist.get_backend()!r}, {dist.get_world_size()} ranks); run "
            "it in a process of its own")
    # torch's testing module registers the "fake" backend (its
    # FakeProcessGroup) in the form this torch version takes
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world)


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

# the c10d ops the sharded steps issue (`parallel.sharding`'s
# all_reduce / reduce_scatter, the gathers' all_gather), by the HLO name
# of their kind; any other c10d op is refused, not silently left out
_C10D_KINDS = {"allgather_": "all-gather", "allreduce_": "all-reduce",
               "_reduce_scatter_base_": "reduce-scatter"}
# factories that allocate and write nothing
_NO_BYTES = ("empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _group_ranks(args) -> list:
    """The global ranks of a counted c10d op's process group: its first
    ``ScriptObject`` argument (the group, boxed)."""
    pg = next(a for a in args if isinstance(a, torch.ScriptObject))
    return dist.get_process_group_ranks(dist.ProcessGroup.unbox(pg))


class _CostMode(TorchDispatchMode):
    """Bytes every aten op reads and writes (its tensor inputs and
    outputs, views and allocations excluded), and every c10d collective
    with its kind, local output bytes and group."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.coll: list = []       # (kind, output bytes, group ranks)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns == "c10d":
            if name not in _C10D_KINDS:
                raise NotImplementedError(f"c10d op {name} is not counted")
            # the first argument holds the local output (in place)
            self.coll.append((_C10D_KINDS[name],
                              sum(_nbytes(t) for t in _tensors(args[0])),
                              _group_ranks(args)))
            return out
        if func.is_view or name in _NO_BYTES:
            return out
        self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        self.bytes += sum(_nbytes(t) for t in _tensors(out))
        return out


def _rate(ranks: list) -> float:
    """A group's ring rate: NVLink inside one node of `NODE_CARDS`, the
    NIC across nodes."""
    if len({r // NODE_CARDS for r in ranks}) == 1:
        return NVLINK_BW
    return NIC_BW


def collectives_of(coll: list) -> Dict[str, Any]:
    """A record's ``collectives`` from `_CostMode`'s (kind, bytes, ranks)
    entries: raw bytes by kind, ring wire bytes, the op count (and by
    group size), and the seconds at each group's rate."""
    raw: Dict[str, int] = {}
    wire = 0.0
    seconds = 0.0
    by_size: Dict[int, int] = {}
    for kind, b, ranks in coll:
        if b == 0:
            continue
        n = len(ranks)
        raw[kind] = raw.get(kind, 0) + b
        w = ring_wire(kind, b, n)
        wire += w
        seconds += w / _rate(ranks)
        by_size[n] = by_size.get(n, 0) + 1
    return {"raw_bytes": raw, "wire_bytes": wire,
            "n_ops": sum(by_size.values()),
            "ops_by_group_size": {str(k): v for k, v in
                                  sorted(by_size.items())},
            "collective_s": seconds}


# ---------------------------------------------------------------------------
# per-cell trace
# ---------------------------------------------------------------------------

def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def _build(cfg: ModelConfig, shape, rules: PS.MeshRules):
    """(run, arguments, argument parts, bytes under the reference's
    roles) of one cell's sharded step: ``run()`` takes the step once."""
    args_abs, roles = input_specs(cfg, shape)
    state = ST.abstract_state(cfg)
    by_roles: Dict[str, int] = {}

    def role_bytes(tree, role_tree):
        sh = tree_flatten(roles_to_shardings(tree, role_tree, rules),
                          is_leaf=lambda x: isinstance(x, Sharding))[0]
        return sum(PS.spec_bytes_per_device(tuple(t.shape), t.dtype,
                                            s.spec, rules)
                   for t, s in zip(_tensors(tree), sh))

    if shape.kind == "train":
        batch = args_abs[0]
        state = ST.shard_state(state, state_shardings(state, rules))
        step = ST.make_sharded_train_step(cfg, OptConfig(), rules)
        held = [state.params.state_dict(), state.opt.m, state.opt.v,
                state.opt.count, state.step]
        by_roles["batch"] = role_bytes(batch, roles[0])
        parts = {"state": held, "batch": batch}
        return (lambda: step(state, batch)), parts, by_roles
    params = ST.shard_params(state.params, param_shardings(state.params,
                                                          rules))
    if shape.kind == "prefill":
        batch = args_abs[0]
        step = ST.make_sharded_prefill_step(cfg, rules)
        by_roles["batch"] = role_bytes(batch, roles[0])
        parts = {"params": params.state_dict(), "batch": batch}
        return (lambda: step(params, batch)), parts, by_roles
    step = ST.make_sharded_decode_step(cfg, rules)
    (caches_abs, tokens, _), (c_roles, t_roles, _) = args_abs, roles
    rows = ST.local_rows(rules, tokens.shape[0], cfg)
    caches = T.init_caches(cfg, rows, shape.seq_len, "meta")
    by_roles["caches"] = role_bytes(caches_abs, c_roles)
    by_roles["batch"] = role_bytes(tokens, t_roles)
    parts = {"params": params.state_dict(), "caches": caches,
             "batch": tokens}
    # the last slot of the cache: any position costs the same
    pos = shape.seq_len - 1
    return (lambda: step(params, caches, tokens, pos)), parts, by_roles


def trace_step(cfg: ModelConfig, shape, rules: PS.MeshRules
               ) -> Dict[str, Any]:
    """One cell's step traced once on ``meta``: FLOPs, bytes, collectives
    and the peak live bytes (`MemTracker`, the arguments tracked as
    external tensors)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    run, parts, by_roles = _build(cfg, shape, rules)
    held = {k: [_local(t) for t in _tensors(v)] for k, v in parts.items()}
    arg_parts = {k: sum(_nbytes(t) for t in v) for k, v in held.items()}
    mt = MemTracker()
    mt.track_external(*(t for v in held.values() for t in v))
    cost = _CostMode()
    with FlopCounterMode(display=False) as flops, mt, cost:
        run()
    peak = sum(s["Total"] for s in mt.get_tracker_snapshot("peak").values())
    return dict(flops=float(flops.get_total_flops()), bytes=float(cost.bytes),
                coll=cost.coll, peak=float(peak), arg_parts=arg_parts,
                by_roles=by_roles)


def _twins(cfg: ModelConfig, kind: str) -> bool:
    return kind != "decode" and any(k in TWIN_KINDS
                                    for k in cfg.group_pattern)


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               cfg_override: Optional[ModelConfig] = None,
               extra_tag: str = "") -> Dict[str, Any]:
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "tag": extra_tag,
    }
    ok, why = shape_applies(cfg, shape)
    if not ok:
        rec.update(status="skip", reason=why)
        return rec
    t0 = time.time()
    try:
        start_world()
        mesh = M.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        rules = PS.make_rules(mesh)
        if extra_tag:
            cfg, rules = VARIANTS[extra_tag](cfg, rules)
        n_dev = M.n_chips(multi_pod)
        actual_params = sum(t.numel() for t in
                            ST.abstract_state(cfg).params.state_dict()
                            .values())
        if _twins(cfg, shape.kind):
            g = cfg.group_size
            total_g = cfg.n_groups
            g1, g2 = 1, 2
            t1 = trace_step(dataclasses.replace(cfg, n_layers=g1 * g), shape, rules)
            t2 = trace_step(dataclasses.replace(cfg, n_layers=g2 * g), shape, rules)
            slope = (total_g - g1) / (g2 - g1)
            lerp = lambda a, b: a + slope * (b - a)  # noqa: E731
            c1, c2 = collectives_of(t1["coll"]), collectives_of(t2["coll"])
            coll = {"raw_bytes": {k: lerp(c1["raw_bytes"].get(k, 0),
                                          c2["raw_bytes"].get(k, 0))
                                  for k in set(c1["raw_bytes"])
                                  | set(c2["raw_bytes"])},
                    "wire_bytes": lerp(c1["wire_bytes"], c2["wire_bytes"]),
                    "n_ops": round(lerp(c1["n_ops"], c2["n_ops"])),
                    "collective_s": lerp(c1["collective_s"],
                                         c2["collective_s"]),
                    "extrapolated_from_groups": [g1, g2]}
            tr = {k: lerp(t1[k], t2[k]) for k in ("flops", "bytes", "peak")}
            # the full model's arguments are counted, not extrapolated
            full_args = _argument_bytes(cfg, shape, rules)
            tr.update(arg_parts=full_args[0], by_roles=full_args[1])
            cost_source = memory_source = (
                f"{g1}g/{g2}g-twin-extrapolation of {total_g} groups")
        else:
            tr = trace_step(cfg, shape, rules)
            coll = collectives_of(tr["coll"])
            cost_source = "full-depth trace"
            memory_source = "full-depth trace (MemTracker peak)"
        flops, nbytes, peak = tr["flops"], tr["bytes"], tr["peak"]
        mf = model_flops_for(cfg, shape.kind, shape.global_batch,
                             shape.seq_len, actual_params)
        terms = {"compute_s": flops / PEAK_FLOPS_BF16,
                 "memory_s": nbytes / HBM_BW,
                 "collective_s": coll["collective_s"]}
        dominant = max(terms, key=terms.get)
        rec.update(
            status="ok",
            wall_s=round(time.time() - t0, 2),
            cost_source=cost_source,
            memory_source=memory_source,
            inner_scan_corr_flops=0.0,
            n_devices=n_dev,
            params=actual_params,
            memory=dict(
                argument_bytes=sum(tr["arg_parts"].values()),
                argument_parts=tr["arg_parts"],
                **{f"{k}_bytes_by_roles": v
                   for k, v in tr["by_roles"].items()},
                peak_per_device_bytes=peak,
                fits_80gb=bool(peak < HBM_BYTES),
            ),
            cost=dict(flops_per_dev=flops, bytes_per_dev=nbytes),
            collectives=coll,
            roofline=dict(
                **{k: float(v) for k, v in terms.items()},
                dominant=dominant,
                model_flops=mf,
                model_flops_per_dev=mf / n_dev,
                useful_flops_ratio=(mf / n_dev) / flops if flops else 0.0,
                roofline_frac=max(terms.values()) and
                (mf / n_dev / PEAK_FLOPS_BF16) / max(terms.values()),
            ),
        )
    except Exception as e:  # a step that does not trace is a fault: record it
        rec.update(status="error", wall_s=round(time.time() - t0, 2),
                   error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    return rec


def _argument_bytes(cfg: ModelConfig, shape, rules: PS.MeshRules):
    """(argument parts, bytes under the roles) of a cell's step, its
    arguments built but the step not run."""
    _, parts, by_roles = _build(cfg, shape, rules)
    return ({k: sum(_nbytes(_local(t)) for t in _tensors(v))
             for k, v in parts.items()}, by_roles)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def run(arches, shapes, meshes, out_path: str, force: bool = False,
        tag: str = "") -> int:
    results = []
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)
    if force:  # recompute ONLY the requested cells; keep everything else
        requested = {(a, s, m, tag) for a in arches for s in shapes
                     for m in meshes}
        results = [r for r in results
                   if (r["arch"], r["shape"], r["mesh"],
                       r.get("tag", "")) not in requested]
    done = {(r["arch"], r["shape"], r["mesh"], r.get("tag", ""))
            for r in results if r["status"] != "error"}  # retry errors
    results = [r for r in results if r["status"] != "error"]
    for mesh_name in meshes:
        multi = mesh_name == "2x16x16"
        for arch in arches:
            for shape in shapes:
                key = (arch, shape, mesh_name, tag)
                if key in done:
                    continue
                print(f"[dryrun] {arch} x {shape} x {mesh_name} "
                      f"tag={tag or '-'} ...", flush=True)
                rec = lower_cell(arch, shape, multi, extra_tag=tag)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    extra = (f" wall={rec['wall_s']}s "
                             f"peak={rec['memory']['peak_per_device_bytes']:.4g}B "
                             f"dom={rec['roofline']['dominant']} "
                             f"fits={rec['memory']['fits_80gb']}")
                elif status == "error":
                    extra = " " + rec["error"][:160]
                elif status == "skip":
                    extra = " " + rec["reason"][:80]
                print(f"[dryrun]   -> {status}{extra}", flush=True)
                results.append(rec)
                with open(out_path, "w") as f:
                    json.dump(results, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skip, {n_err} error")
    return 1 if n_err else 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all' or comma list")
    ap.add_argument("--shape", default="all",
                    help="shape name or 'all' or comma list")
    ap.add_argument("--mesh", default="both",
                    choices=["16x16", "2x16x16", "both"])
    ap.add_argument("--out", default="dryrun_torch.json")
    ap.add_argument("--force", action="store_true",
                    help="recompute cells already in --out")
    ap.add_argument("--variant", default="",
                    help=f"perf variant tag: one of {list(VARIANTS)}")
    args = ap.parse_args(argv)
    if args.variant and args.variant not in VARIANTS:
        ap.error(f"--variant {args.variant!r}: one of {list(VARIANTS)}")
    arches = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = (["16x16", "2x16x16"] if args.mesh == "both" else [args.mesh])
    start_world()
    raise SystemExit(run(arches, shapes, meshes, args.out, args.force,
                         tag=args.variant))


if __name__ == "__main__":
    main()
