"""The sharded Monte-Carlo sweep on ``torch.distributed``.

Counterpart of the JAX package's ``parallel/sweep.py``.  There one
controller ``shard_map``s global arrays over a sweep mesh; here every
rank is its own process and runs the same program (SPMD): every rank
calls `run_sweep` (through ``simulate.run_trials`` with
``SimConfig(mesh_shape=...)``) on the same global (T[, C], ...) stacks,
which every rank builds alike from the seed, keeps its shard of them,
schedules it with `engine.run_stream_batch` (either backend), merges
through collectives and gathers the per-stream outputs in mesh order,
so every rank returns what the single-device dispatch returns.  The mesh
is `launch.mesh.make_sweep_mesh`'s: ``("trials",)`` or ``("trials",
"clients")``.

Bit-exactness is the design, as in the reference:

* the TRIAL axis is embarrassingly parallel: a stream's outputs do not
  depend on which rank schedules it or beside which others.  The trial
  tile is pinned from the global trial count and each shard holds at
  least one tile, the reference's rule (here the tile is only the stream
  kernel's launch shape, but the tuning table keys on it);
* the CLIENT axis adds one association level to the cross-client merge:
  each rank folds its local clients with `policy_core.masked_client_sum`
  (the merge kernel under ``merge_mean=False``: raw sums, since a mean
  does not compose across ranks), then `policy_core.psum_tree` (an
  ``all_gather`` in rank order and the pinned `tree_sum` halving tree)
  folds the rank partials.  `policy_core.sharded_client_sum` is the host
  oracle of the two levels.  Every collective is an ``all_gather``: the
  makespan's max and the integer probe counts' sum are taken over the
  gathered partials (exact in any order), and nothing goes through
  ``all_reduce``, whose float sums are in the backend's order.

Padding: the trial axis pads by repeating trial 0 (padded trials
recompute a real trial and are dropped at the end; merges are per
trial, so they never reach a real one); the client axis pads with
phantom clients (every request invalid), which every masked merge
leaves out.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import engine, policy_core
from repro_torch.core.policy_core import F32, f32
from repro_torch.kernels.sched_select import kernel as kkernel
from repro_torch.kernels.sched_select import ops as kops
from repro_torch.launch.mesh import make_sweep_mesh


class SweepMerge(NamedTuple):
    """Per-trial cross-client aggregates of the sharded (T, C) sweep,
    merged across the client axis of the mesh: the rank partials of
    `masked_client_sum` folded by `psum_tree`, the makespan as a max and
    the integer probe counts as a sum.  The sharded twin of
    `engine.ClientMerge`, alike on both backends: the rows the per_client
    fold of `simulate._sched_trials` takes.

    ``p99`` is the global cross-client nearest-rank p99: every rank's
    merged latency block (the merge kernel's ``lats``/``lats_valid``, or
    `engine.grouped_latency_block` on the eager engine) is gathered over
    the client axis and bisected once by `policy_core.nearest_rank_p99`,
    which does not depend on the order of the block."""

    window_loads_mean: torch.Tensor  # (T, W, M) masked client-mean loads
    phase_time: torch.Tensor         # (T,) merged makespan, real clients
    probe_msgs: torch.Tensor         # (T,) int32 probes, real clients
    p99: torch.Tensor                # (T,) global merged nearest-rank p99


def _map(fn, tree):
    """``fn`` over the tensors of a tensor, a tuple or NamedTuple of them
    (nested, with None fields) or None."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    parts = (_map(fn, x) for x in tree)
    return tuple(parts) if type(tree) is tuple else type(tree)(*parts)


def _edge_pad(tree, axis: int, new: int):
    """Pad ``axis`` up to length ``new`` by repeating index 0 (the padded
    slots recompute slot 0)."""
    def one(a):
        if a.shape[axis] == new:
            return a
        idx = torch.arange(new, device=a.device)
        return a.index_select(axis, torch.where(idx < a.shape[axis], idx, 0))

    return _map(one, tree)


def _gather_axis(a: torch.Tensor, group, axis: int) -> torch.Tensor:
    """Every rank's ``a`` of ``group`` joined along ``axis`` in rank
    order (a concatenation, so exact)."""
    parts = policy_core.all_gather_stack(a, group)
    return torch.cat(tuple(parts.unbind(0)), dim=axis)


def run_sweep(states, works, keys, *, mesh_shape: Optional[Tuple[int, ...]],
              policy, log_cfg, window_size: int, backend: str = "kernel",
              traces=None, window_dt: float = 0.0,
              observe: Optional[bool] = None, trial_tile=None,
              client_tile=None, stream_batch=kops.sched_stream_batch,
              stream_grid=kops.sched_stream_grid):
    """The whole (T[, C]) sweep, sharded over the sweep mesh.  Every rank
    of the world calls it with the same arguments.

    The arguments are `engine.run_stream_batch`'s (``states`` /
    ``works`` / ``keys`` with a ``(T,)`` or ``(T, C)`` leading batch,
    ``traces`` per trial; steps are grouped by object, as there);
    ``mesh_shape`` picks the sweep mesh (`launch.mesh.make_sweep_mesh`,
    on the device type of ``works``).  Returns ``(result, metrics,
    sweep_merge)`` on every rank: ``result`` and ``metrics`` as the
    single-device dispatch returns them (padded trials and clients
    stripped), and a `SweepMerge` for the (T, C) form (None for (T,),
    where there is nothing to merge).  ``stream_batch``/``stream_grid``
    go on to `engine.run_stream_batch`."""
    mesh = make_sweep_mesh(mesh_shape, works.object_ids.device.type)
    axes = mesh.mesh_dim_names
    t_dev = mesh.size(0)
    c_dev = mesh.size(1) if len(axes) == 2 else 1
    batch_shape = tuple(works.object_ids.shape[:-1])
    two_d = len(batch_shape) == 2
    if c_dev > 1 and not two_d:
        raise ValueError(
            f"mesh shape {tuple(mesh.shape)} shards a client axis but the "
            "batch has no client axis (pass (T, C) stacks or a (trials,) "
            "mesh)")
    t = batch_shape[0]
    if observe is None:
        observe = traces is not None
    kernel = backend == "kernel"

    # ---- trial padding: repeat trial 0 up to t_dev equal shards of at
    # least one trial tile, the tile pinned from the global T
    form = "sched_stream_grid" if two_d else "sched_stream"
    tt_eff = max(min(kkernel.resolve_warps(form, trial_tile), t), 1)
    t_loc = max(-(-t // t_dev), tt_eff) if kernel else -(-t // t_dev)
    t_pad = t_loc * t_dev

    # ---- client padding: phantoms up to c_dev equal shards of the width
    # the host oracle `policy_core.sharded_client_sum` derives
    c = c_pad = shard_w = batch_shape[1] if two_d else 1
    if two_d:
        shard_w = policy_core.resolve_shard_width(c, c_dev)
        c_pad = shard_w * c_dev
        if c_pad != c:
            states, keys, works = _edge_pad((states, keys, works), 1, c_pad)
            cmask = torch.arange(c_pad, device=works.valid.device) < c
            works = works._replace(valid=works.valid & cmask[None, :, None])
    states, works, keys, traces = _edge_pad((states, works, keys, traces), 0,
                                            t_pad)

    # ---- this rank's shard
    ti = mesh.get_local_rank("trials")
    ci = mesh.get_local_rank("clients") if c_dev > 1 else 0
    states, works, keys = _map(
        lambda a: a.narrow(0, ti * t_loc, t_loc), (states, works, keys))
    traces = _map(lambda a: a.narrow(0, ti * t_loc, t_loc), traces)
    if c_dev > 1:
        states, works, keys = _map(
            lambda a: a.narrow(1, ci * shard_w, shard_w),
            (states, works, keys))

    res, metrics, merged = engine.run_stream_batch(
        states, works, keys, policy=policy, log_cfg=log_cfg,
        window_size=window_size, traces=traces, window_dt=window_dt,
        observe=observe, trial_tile=tt_eff if kernel else trial_tile,
        client_tile=client_tile, merge_mean=False, backend=backend,
        stream_batch=stream_batch, stream_grid=stream_grid)

    smerge = None
    clients = mesh.get_group("clients") if len(axes) == 2 else None
    if two_d:
        # ---- cross-client merge: the local raw sums, folded across the
        # client axis of the mesh
        cvalid = works.valid.any(dim=-1)                   # (t_loc, c_loc)
        ct = policy_core.resolve_client_tile(cvalid.shape[1], client_tile)
        if merged is not None:
            # the merge kernel's raw sums and merged latency block
            wl_sum = merged.window_loads_mean
            n_real = merged.metrics[:, policy_core.MET_N_CLIENTS]
            phase = merged.metrics[:, policy_core.MET_MAKESPAN]
            lats, lval = merged.lats, merged.lats_valid != 0.0
        else:
            # the eager engine: the same fold as tensor code
            wl_sum = policy_core.masked_client_sum(
                res.window_loads.movedim(1, 0), cvalid.T, ct)
            n_real = policy_core.masked_client_sum(
                torch.ones(cvalid.T.shape, dtype=F32, device=cvalid.device),
                cvalid.T, ct)
            per = works.valid.shape[-1]
            w_open = ((torch.arange(per, device=cvalid.device)
                       // window_size).to(F32)
                      * f32(window_dt, res.latencies))
            phase = torch.where(works.valid, w_open + res.latencies,
                                f32(0.0, res.latencies)).amax(dim=(1, 2))
            lats, lval = engine.grouped_latency_block(works, res.latencies,
                                                      window_size)
        probes = torch.where(cvalid, res.probe_msgs, 0).sum(
            dim=-1, dtype=torch.int32)
        if clients is not None:
            wl_sum = policy_core.psum_tree(wl_sum, clients)
            n_real = policy_core.psum_tree(n_real, clients)
            phase = policy_core.all_gather_stack(phase, clients).amax(dim=0)
            probes = policy_core.all_gather_stack(probes, clients).sum(
                dim=0, dtype=torch.int32)
            # the global p99: every rank's block, bisected once (the
            # bisection does not depend on the block's order)
            lats = _gather_axis(lats, clients, 1)
            lval = _gather_axis(lval, clients, 1)
        p99 = policy_core.nearest_rank_p99(lats.reshape(t_loc, -1),
                                           lval.reshape(t_loc, -1))[:, 0]
        wl_mean = wl_sum / torch.clamp_min(n_real, 1.0)[:, None, None]
        smerge = SweepMerge(window_loads_mean=wl_mean, phase_time=phase,
                            probe_msgs=probes, p99=p99)

    # ---- gather the shards in mesh order on every rank, strip padding
    trials = mesh.get_group("trials")

    def gather(a, per_client: bool):
        if per_client and c_dev > 1:
            a = _gather_axis(a, clients, 1)
        a = _gather_axis(a, trials, 0)[:t]
        return a[:, :c] if per_client and two_d else a

    res = _map(lambda a: gather(a, True), res)
    metrics = _map(lambda a: gather(a, True), metrics)
    smerge = _map(lambda a: gather(a, False), smerge)
    return res, metrics, smerge
