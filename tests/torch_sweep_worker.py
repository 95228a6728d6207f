"""Helper processes of tests/test_torch_sweep.py (not a test module).

``python tests/torch_sweep_worker.py ranks RANK WORLD STORE OUT`` is one
rank of a gloo world of WORLD CPU processes, joined through the
``FileStore`` at STORE: it runs every sharded case of `CASES` for its
world size through the port's ``run_trials(mesh_shape=...)`` and, in a
world of four, the port's ``run_sweep`` on `synthetic_grid`'s inputs,
and saves what it got, with a `psum_tree` of rank-made partials, to
``OUT/w<WORLD>-rank<RANK>.pt``.

``python tests/torch_sweep_worker.py reference OUT`` runs the JAX
package's sharded sweep under four forced host devices: its
``run_trials`` on the client-sharded cases of `REFERENCE_CASES` and its
``run_sweep`` on the same synthetic inputs (read from
``OUT/inputs.npz``), saved to ``OUT/reference.npz``.
"""

from __future__ import annotations

import datetime
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BASE = dict(n_servers=16, n_requests=48, n_trials=5, window_size=16)
N_CLIENTS = 7
# all six kernel policies; the randomized ones draw from the kernel's LCG
POLICY_SPECS = (("ect", "jax", 0.05), ("rr", "jax", 5.0),
                ("mlml", "jax", 5.0), ("trh", "lcg", 5.0),
                ("nltr", "lcg", 5.0), ("two_choice", "lcg", 5.0))
# backend -> policies: the eager engine for the policies whose sharded
# bits the reference itself holds on its eager engine
BACKEND_POLICIES = {"kernel": tuple(p[0] for p in POLICY_SPECS),
                    "jax": ("ect", "rr")}


def _cases():
    cases = []
    for world, mesh, model in ((2, (2,), "shared_log"),
                               (4, (4,), "shared_log"),
                               (4, (2, 2), "per_client"),
                               (4, (1, 4), "per_client")):
        for backend, names in BACKEND_POLICIES.items():
            cases += [(world, mesh, model, backend, n) for n in names]
    # a mesh smaller than the world (replicas) and a per_client sweep
    # sharded over trials alone
    cases += [(4, (2,), "shared_log", "kernel", "ect"),
              (4, (4,), "per_client", "kernel", "nltr"),
              (4, (4,), "per_client", "jax", "rr")]
    return tuple(cases)


# (world size, mesh shape, client model, backend, policy)
CASES = _cases()
# the client-sharded cases the JAX package's sharded run_trials also runs
REFERENCE_CASES = tuple(c for c in CASES if len(c[1]) == 2
                        and c[3] == "jax")
# run_sweep's synthetic (T, C) inputs: T=5 over 2 trial shards and C=7
# over 2 client shards, so both axes pad
GRID = dict(t=5, c=7, per=8, m=5, window_size=4, mesh_shape=(2, 2))


def case_id(case) -> str:
    world, mesh, model, backend, name = case
    return f"w{world}-{'x'.join(map(str, mesh))}-{model}-{backend}-{name}"


def policy_fields(name: str) -> dict:
    _, rng, thr = next(p for p in POLICY_SPECS if p[0] == name)
    return dict(name=name, threshold=thr, rng=rng)


def sim_fields(model: str, backend: str, mesh=None) -> dict:
    return dict(BASE, client_model=model, n_clients=N_CLIENTS,
                backend=backend, mesh_shape=mesh)


def synthetic_grid(seed: int = 7) -> dict:
    """run_sweep's inputs as numpy arrays: a fresh log per client holding
    random loads, random requests, a whole phantom client (the last) and a
    half-valid one, and threefry key data per client."""
    g = GRID
    t, c, per, m = g["t"], g["c"], g["per"], g["m"]
    rng = np.random.default_rng(seed)
    log = np.zeros((t, c, 4, m), np.float32)
    log[:, :, 0] = rng.uniform(10.0, 20.0, (t, 1, m)).astype(np.float32)
    log[:, :, 1] = np.float32(1.0 / m)
    log[:, :, 3] = 1.0
    valid = np.ones((t, c, per), bool)
    valid[:, -1] = False
    valid[:, 1, per // 2:] = False
    return dict(
        log=log, n_assigned=np.zeros((t, c, m), np.int32),
        rates=np.ones((t, c, m), np.float32),
        vclock=np.zeros((t, c), np.float32),
        free_at=np.zeros((t, c, m), np.float32),
        object_ids=rng.integers(0, 8 * m, (t, c, per)).astype(np.int32),
        lengths=rng.uniform(1.0, 4.0, (t, c, per)).astype(np.float32),
        valid=valid,
        keys=rng.integers(0, 2 ** 32, (t, c, 2), dtype=np.uint32))


def rank_partial(rank: int):
    """The float32 (3, 7) partial rank ``rank`` adds in the `psum_tree`
    check: values whose sum depends on the order of addition."""
    import torch
    g = np.random.default_rng(100 + rank)
    return torch.from_numpy(
        (g.standard_normal((3, 7)) * 10.0 ** g.integers(-4, 5, (3, 7)))
        .astype(np.float32))


def _ranks(rank: int, world: int, store: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.core import engine, policy_core, simulate
    from repro_torch.core.policies import PolicyConfig
    from repro_torch.core.statlog import LogConfig, SchedState
    from repro_torch.parallel import sweep

    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    got = {}
    for case in CASES:
        if case[0] != world:
            continue
        _, mesh, model, backend, name = case
        cfg = simulate.SimConfig(**sim_fields(model, backend, mesh))
        res = simulate.run_trials(0, cfg, PolicyConfig(**policy_fields(name)),
                                  simulate.default_log_cfg(cfg),
                                  device="cpu")
        got[case_id(case)] = res._asdict()
    got["psum_tree"] = policy_core.psum_tree(rank_partial(rank), None)
    if world == 4:
        a = {k: torch.from_numpy(v.astype(np.int64) if k == "keys" else v)
             for k, v in np.load(os.path.join(out, "inputs.npz")).items()}
        states = SchedState(*(a[f] for f in SchedState._fields))
        works = engine.Workload(a["object_ids"], a["lengths"], a["valid"])
        res, metrics, smerge = sweep.run_sweep(
            states, works, a["keys"],
            mesh_shape=GRID["mesh_shape"],
            policy=PolicyConfig(**policy_fields("ect")),
            log_cfg=LogConfig(n_servers=GRID["m"]),
            window_size=GRID["window_size"])
        got["run_sweep"] = dict(smerge._asdict(), chosen=res.chosen,
                                latencies=res.latencies,
                                window_loads=res.window_loads,
                                metrics=metrics)
    torch.save(got, os.path.join(out, f"w{world}-rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _reference(out: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp

    from repro.core import engine, simulate
    from repro.core.policies import PolicyConfig
    from repro.core.statlog import LogConfig, SchedState
    from repro.parallel import sweep

    assert jax.device_count() == 4
    saved = {}
    for case in REFERENCE_CASES:
        _, mesh, model, backend, name = case
        cfg = simulate.SimConfig(**sim_fields(model, backend, mesh))
        res = simulate.run_trials(jax.random.key(0), cfg,
                                  PolicyConfig(**policy_fields(name)),
                                  simulate.default_log_cfg(cfg))
        for f, v in res._asdict().items():
            saved[f"{case_id(case)}/{f}"] = np.asarray(v)
    a = dict(np.load(os.path.join(out, "inputs.npz")))
    states = SchedState(*(jnp.asarray(a[f]) for f in SchedState._fields))
    works = engine.Workload(jnp.asarray(a["object_ids"]),
                            jnp.asarray(a["lengths"]), jnp.asarray(a["valid"]))
    keys = jax.random.wrap_key_data(jnp.asarray(a["keys"]))
    # staged as the reference's simulate stages it (one program per
    # device, not op by op)
    res, metrics, smerge = jax.jit(lambda s, w, k: sweep.run_sweep(
        s, w, k, mesh_shape=GRID["mesh_shape"],
        policy=PolicyConfig(**policy_fields("ect")),
        log_cfg=LogConfig(n_servers=GRID["m"]),
        window_size=GRID["window_size"]))(states, works, keys)
    for f, v in dict(smerge._asdict(), chosen=res.chosen,
                     latencies=res.latencies, window_loads=res.window_loads,
                     metrics=metrics).items():
        saved[f"run_sweep/{f}"] = np.asarray(v)
    np.savez(os.path.join(out, "reference.npz"), **saved)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(ROOT, "src"))
    if sys.argv[1] == "ranks":
        _ranks(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    else:
        _reference(sys.argv[2])
