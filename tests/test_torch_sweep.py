"""The sharded Monte-Carlo sweep of the port (`repro_torch.parallel.sweep`,
`repro_torch.launch.mesh`) on gloo CPU worlds, against the port's own
unsharded dispatch and the JAX package.

The worlds are spawned once per size (2 and 4 ranks, each rank a process
of tests/torch_sweep_worker.py joined through a ``FileStore`` under
``tmp_path``), beside one process that runs the JAX package's sharded
sweep under four forced host devices; each has its own timeout.  Every
case of ``torch_sweep_worker.CASES`` (``BASE`` of the reference's
tests/test_sharded_sweep.py, T=5 so every mesh pads trial shards, C=7
so every client shard pads with phantoms) is held bit for bit:

* every rank returns the same `TrialResult`;
* equal to the port's unsharded ``run_trials`` and to the JAX package's
  single-device ``run_trials`` (its eager engine, which its contract
  holds bitwise to its kernel for these settings), every field; under a
  client axis every field but the window loads, whose cross-client mean
  gains the rank axis as an association level (the reference's own
  contract): they equal the two-level host oracle
  `policy_core.sharded_client_mean` bit for bit, and the JAX package's
  sharded ``run_trials`` on the cases it runs;
* ``run_sweep`` on synthetic (T=5, C=7) inputs on a (2, 2) mesh: its
  `SweepMerge` and per-stream outputs equal the JAX package's
  ``run_sweep`` on the same inputs.

The host oracles (`resolve_shard_width`, `sharded_client_sum`/`_mean`)
equal the reference's with ``xp=np``; `make_sweep_mesh`'s validation is
held in this process's world of one."""

import os
import re
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_sweep_worker as worker
from repro.core import policy_core as jpc
from repro.core import simulate as jsim
from repro.core.policies import PolicyConfig as JPolicyConfig
from repro_torch import random
from repro_torch.core import engine
from repro_torch.core import policy_core as tpc
from repro_torch.core import simulate as tsim
from repro_torch.core.policies import PolicyConfig
from repro_torch.core.statlog import SchedState
from repro_torch.launch import mesh as tmesh
from repro_torch.parallel import sweep as tsweep
from torch_jax_release import release_compiled_programs  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_sweep_worker.py"
SPAWN_TIMEOUT = 300  # seconds, for each spawned process
FIELDS = tsim.TrialResult._fields

pytestmark = pytest.mark.filterwarnings("ignore:per_client window clamp")


def _combos():
    """(client model, backend, policy) of every case, once."""
    return sorted({c[2:] for c in worker.CASES})


def _port_unsharded():
    out = {}
    for model, backend, name in _combos():
        cfg = tsim.SimConfig(**worker.sim_fields(model, backend))
        out[model, backend, name] = tsim.run_trials(
            0, cfg, PolicyConfig(**worker.policy_fields(name)),
            tsim.default_log_cfg(cfg), device="cpu")
    return out


def _reference_single():
    """The JAX package's single-device trials on its eager engine, once
    per (client model, policy)."""
    out = {}
    for model, _, name in _combos():
        if (model, name) in out:
            continue
        cfg = jsim.SimConfig(**worker.sim_fields(model, "jax"))
        res = jsim.run_trials(jax.random.key(0), cfg,
                              JPolicyConfig(**worker.policy_fields(name)),
                              jsim.default_log_cfg(cfg))
        out[model, name] = {f: np.asarray(getattr(res, f)) for f in FIELDS}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn the gloo worlds and the reference's sharded run, compute the
    unsharded runs meanwhile, and collect every result."""
    out = tmp_path_factory.mktemp("sweep")
    np.savez(out / "inputs.npz", **worker.synthetic_grid())
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = {"reference": [sys.executable, str(WORKER), "reference",
                           str(out)]}
    for world in (2, 4):
        for rank in range(world):
            procs[f"w{world}-rank{rank}"] = [
                sys.executable, str(WORKER), "ranks", str(rank), str(world),
                str(out / f"store{world}"), str(out)]
    started = time.monotonic()
    running = {name: subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
               for name, cmd in procs.items()}
    try:
        port = _port_unsharded()
        reference = _reference_single()
        failed = []
        for name, proc in running.items():
            left = max(SPAWN_TIMEOUT - (time.monotonic() - started), 1.0)
            try:
                log, _ = proc.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                proc.kill()
                log, _ = proc.communicate()
                failed.append(f"{name} timed out after {SPAWN_TIMEOUT} s:\n"
                              f"{log[-3000:]}")
                continue
            if proc.returncode != 0:
                failed.append(f"{name} exited {proc.returncode}:\n"
                              f"{log[-3000:]}")
        assert not failed, "\n\n".join(failed)
    finally:
        for proc in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ranks = {w: [torch.load(out / f"w{w}-rank{r}.pt") for r in range(w)]
             for w in (2, 4)}
    return dict(ranks=ranks, port=port, reference=reference,
                sharded=dict(np.load(out / "reference.npz")))


def _client_sharded(case) -> bool:
    return len(case[1]) == 2 and case[1][1] > 1


def _eq(a, b, msg):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_array_equal(a, np.asarray(b), err_msg=msg)


def _two_level_loads(case):
    """`sharded_client_mean` over the unsharded per-client window loads of
    ``case``, at its mesh's client shards: what the sharded sweep's window
    loads must be under a client axis."""
    world, mesh, model, backend, name = case
    cfg = tsim.SimConfig(**worker.sim_fields(model, backend))
    log_cfg = tsim.default_log_cfg(cfg)
    _, _, works, states, traces, k_sched = tsim._prep_trials(
        tsim.trial_keys(0, cfg, "cpu"), cfg, log_cfg)
    c, per, pad, win = tsim._client_split_shape(cfg)
    t = works.object_ids.shape[0]
    run_works = tsim._split_clients(works, c, per, pad)
    run_states = SchedState(*(x[:, None].expand((t, c) + x.shape[1:])
                              for x in states))
    res, _, _ = engine.run_stream_batch(
        run_states, run_works, random.split(k_sched, c), window_size=win,
        policy=PolicyConfig(**worker.policy_fields(name)), log_cfg=log_cfg,
        traces=traces, window_dt=tsim._window_dt(cfg),
        observe=tsim._observe(cfg), backend=backend)
    cvalid = run_works.valid.any(dim=-1)
    return torch.stack([tpc.sharded_client_mean(res.window_loads[i],
                                                cvalid[i], None, mesh[1])
                        for i in range(t)])


@pytest.mark.parametrize("case", worker.CASES, ids=worker.case_id)
def test_sharded_run_trials_bitwise(runs, case):
    """Every rank alike; every field equal to the unsharded run and the JAX
    package's single-device run; under a client axis the window loads
    equal to the two-level fold (`_two_level_loads`) instead, and within
    1e-6 of the unsharded mean (the reference's own contract)."""
    world, _, model, backend, name = case
    key = worker.case_id(case)
    got = [r[key] for r in runs["ranks"][world]]
    for rank, res in enumerate(got[1:], 1):
        for f in FIELDS:
            _eq(res[f], got[0][f], f"{key}: rank {rank} vs rank 0: {f}")
    exact = [f for f in FIELDS
             if not (_client_sharded(case) and f == "window_loads")]
    want = runs["port"][model, backend, name]
    ref = runs["reference"][model, name]
    for f in exact:
        _eq(got[0][f], getattr(want, f), f"{key} vs unsharded: {f}")
        _eq(got[0][f], ref[f], f"{key} vs repro single-device: {f}")
    if _client_sharded(case):
        _eq(got[0]["window_loads"], _two_level_loads(case),
            f"{key}: window_loads vs the two-level fold")
        np.testing.assert_allclose(got[0]["window_loads"].numpy(),
                                   want.window_loads.numpy(), rtol=1e-6)


@pytest.mark.parametrize("case", worker.REFERENCE_CASES, ids=worker.case_id)
def test_client_sharded_run_trials_equals_reference_sharded(runs, case):
    key = worker.case_id(case)
    got = runs["ranks"][case[0]][0][key]
    for f in FIELDS:
        _eq(got[f], runs["sharded"][f"{key}/{f}"], f"{key}: {f}")


def test_run_sweep_equals_reference_sweep_merge(runs):
    """T=5 on 2 trial shards (one padded trial), C=7 on 2 client shards
    (one phantom client padded, one phantom and one half-valid client in
    the data): the `SweepMerge`, choices, latencies and window loads equal
    the JAX package's ``run_sweep`` on the same inputs, on every rank."""
    for rank, got in enumerate(runs["ranks"][4]):
        got = got["run_sweep"]
        for f in tsweep.SweepMerge._fields + ("chosen", "latencies",
                                              "window_loads"):
            _eq(got[f], runs["sharded"][f"run_sweep/{f}"],
                f"rank {rank}: {f}")
    assert got["probe_msgs"].dtype == torch.int32


@pytest.mark.parametrize("world", [2, 4])
def test_psum_tree_is_the_pinned_tree_over_ranks(runs, world):
    """`psum_tree` on every rank equals `tree_sum` of the rank partials
    stacked in rank order (and the reference's `tree_sum` with xp=np),
    where the partials' sum depends on the order of addition."""
    parts = torch.stack([worker.rank_partial(r) for r in range(world)])
    want = tpc.tree_sum(parts, 0)[0]
    _eq(want, jpc.tree_sum(parts.numpy(), 0, xp=np)[0], "host trees")
    for rank, got in enumerate(runs["ranks"][world]):
        _eq(got["psum_tree"], want, f"rank {rank}")


@pytest.mark.parametrize("c,shards", [(5, 2), (8, 4), (1, 4), (7, 3),
                                      (33, 2)])
def test_sharded_client_sum_and_mean_match_reference(c, shards):
    rng = np.random.default_rng(c * 10 + shards)
    x = (rng.standard_normal((c, 3, 4))
         * 10.0 ** rng.integers(-3, 4, (c, 3, 4))).astype(np.float32)
    cv = rng.random(c) < 0.8
    assert tpc.resolve_shard_width(c, shards) == \
        jpc.resolve_shard_width(c, shards)
    for ct in (None, 1, 2, 8):
        for tf, jf in ((tpc.sharded_client_sum, jpc.sharded_client_sum),
                       (tpc.sharded_client_mean, jpc.sharded_client_mean)):
            got = tf(torch.from_numpy(x), torch.from_numpy(cv), ct, shards)
            _eq(got, jf(x, cv, ct, shards, xp=np), f"{tf.__name__} ct={ct}")
    with pytest.raises(ValueError):
        tpc.resolve_shard_width(c, 0)


@pytest.fixture
def world_of_one(monkeypatch):
    """This process's world of one, torn down afterwards."""
    monkeypatch.setattr(tmesh, "_MESHES", {})
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_make_sweep_mesh_validation(world_of_one):
    """Shapes that cannot be meshes raise before any group starts; with
    no process group the world is one rank, so (1,) and (1, 1) mesh it
    and a larger shape raises naming the world size; the mesh is cached
    per shape."""
    for bad in ((0,), (1, 1, 1), (2, 0)):
        with pytest.raises(ValueError, match="positive rank counts"):
            tmesh.make_sweep_mesh(bad, "cpu")
    for big in ((2,), (1, 3), (4,)):
        with pytest.raises(ValueError, match="does not divide the world "
                           "size 1"):
            tmesh.make_sweep_mesh(big, "cpu")
    assert not dist.is_initialized()
    one = tmesh.make_sweep_mesh(None, "cpu")
    assert one.mesh_dim_names == ("trials",) and one.size(0) == 1
    two = tmesh.make_sweep_mesh((1, 1), "cpu")
    assert two.mesh_dim_names == ("trials", "clients")
    assert tmesh.make_sweep_mesh((1,), "cpu") is one
    assert dist.get_world_size() == 1


def test_no_collective_but_all_gather():
    """The sweep's collectives are ``all_gather``s (`all_gather_stack`):
    no ``all_reduce``, whose float sums are in the backend's order, and no
    other reduction on the wire.  Since the sharded LM stack, the port's
    other collectives live in two files and nowhere else: the reductions
    of `parallel/sharding.py` (``all_reduce``, ``reduce_scatter_tensor``
    and ``broadcast``, which the sharded train step and
    `train/compression.py` call: gradient sums, held to tolerances in
    tests/test_torch_sharding.py, and integer and max reductions, exact
    in any order), and `launch/train.py`'s world setup, checkpoint
    barriers and resume broadcast.  The dry run (`launch/dryrun.py`)
    starts its fake world and reads a counted collective's group ranks;
    it issues none."""
    sweep = {"all_gather", "get_backend", "get_world_size",
             "is_initialized", "init_process_group", "HashStore"}
    allowed = {
        "parallel/sharding.py": {"all_reduce", "reduce_scatter_tensor",
                                 "broadcast", "get_backend",
                                 "get_world_size"},
        "launch/train.py": {"init_process_group", "is_initialized",
                            "get_world_size", "get_rank", "barrier",
                            "broadcast_object_list",
                            "destroy_process_group"},
        "launch/dryrun.py": {"init_process_group", "is_initialized",
                             "get_backend", "get_world_size", "HashStore",
                             "get_process_group_ranks"}}
    src = ROOT / "src" / "repro_torch"
    seen = set()
    for p in src.rglob("*.py"):
        calls = {m.group(1)
                 for m in re.finditer(r"dist\.(\w+)\(", p.read_text())}
        assert calls <= allowed.get(p.relative_to(src).as_posix(), sweep), p
        seen |= calls
    assert "all_gather" in seen
