"""Helper processes of tests/test_torch_sharding.py (not a test module).

``python tests/torch_sharding_worker.py RANK WORLD STORE OUT
[DEVICE [STEPS]]`` is one rank of a gloo world of WORLD processes,
joined through the ``FileStore`` at STORE, on the CPU or on DEVICE
("cuda": the ranks share the card; tests/test_torch_gpu.py and
chip_smoke.py run it so).  From the train states and the batch in
``OUT/inputs.pt`` it runs one step (or STEPS, on the same batch) of the
port's sharded train step (`train.steps.make_sharded_train_step`) for every
arch of `ARCHS` on each mesh of `WORLD_MESHES[WORLD]`, and
`train.compression.compressed_psum`
over the world (two rounds, the residual carried) on `psum_inputs`; in a
world of four also over the 2x2 mesh's "data" dimension, and
``launch/train.py --mesh 2x2`` on the reduced gemma-2b: 3 steps with a
checkpoint every 2, and the same run with step 3's checkpoint removed,
resumed (on the CPU).  What it got goes to
``OUT/w<WORLD>-rank<RANK>.pt``.

The module imports torch and the port alone: the JAX package's side of
the comparison is tests/torch_sharding_reference.py.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import datetime
import io
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARCHS = ("gemma-2b", "mixtral-8x22b")
WORLD_MESHES = {2: ("2", "1x2"), 4: ("2x2",)}
MESHES = tuple(m for ms in WORLD_MESHES.values() for m in ms)
B, S = 4, 16
STEP_OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
GRAD_ATOL = 1e-4   # tests/test_torch_train.py's gradient tolerance
PSUM_WORLDS = (2, 4)
LAUNCH = ["--arch", "gemma-2b", "--reduced", "--steps", "3", "--batch", "4",
          "--seq-len", "16", "--ckpt-every", "2", "--log-every", "1",
          "--device", "cpu", "--mesh", "2x2"]


def case_fields(cfg):
    """A reduced configuration as the cases run it: float32 compute, and
    the local MoE pools (mixtral-8x22b's full configuration's)."""
    fields = dict(compute_dtype="float32")
    if cfg.moe is not None:
        fields["moe"] = dataclasses.replace(cfg.moe, dispatch="local")
    return dataclasses.replace(cfg, **fields)


def moment_errors(got_m, got_v, want_m, want_v, steps: int,
                  b1: float = 0.9, b2: float = 0.95):
    """(largest |m - m'|, largest |sqrt(v) - sqrt(v')|, and the bounds
    gradients each within `GRAD_ATOL` give them after ``steps`` Adam
    steps): m and v are the gradients' weighted mean and mean square, the
    weights summing to ``1 - b ** steps``, so m moves by at most
    ``GRAD_ATOL * (1 - b1 ** steps)`` and sqrt(v), a weighted root mean
    square, by at most ``GRAD_ATOL * sqrt(1 - b2 ** steps)``."""
    dm = max(float((got_m[k].cpu() - w.cpu()).abs().max())
             for k, w in want_m.items())
    dv = max(float((got_v[k].cpu().sqrt() - w.cpu().sqrt()).abs().max())
             for k, w in want_v.items())
    return dm, dv, GRAD_ATOL * (1 - b1 ** steps), \
        GRAD_ATOL * (1 - b2 ** steps) ** 0.5


ADAM_EPS = 1e-8    # OptConfig's eps
ILL_RMS = 1000     # an element is ill-conditioned below ILL_RMS * eps


def param_errors(got, want, want_v, steps: int, b2: float = 0.95,
                 eps: float = ADAM_EPS) -> dict:
    """Parameters ``got`` against ``want``, whose second moments after
    ``steps`` Adam steps are ``want_v``.  Adam moves an element by
    ``lr * m_hat / (sqrt(v_hat) + eps)``; where the root mean square
    gradient ``sqrt(v_hat) = sqrt(v / (1 - b2 ** steps))`` is near eps,
    that ratio turns on the gradient's last bits, which the order of
    summation over the ranks moves, by up to the whole update.  An
    element is ill-conditioned where its ``sqrt(v_hat)`` in ``want_v`` is
    below ``ILL_RMS * eps``: the rule reads the reference alone.  Returns
    ``rel`` (the largest |p - p'| over its leaf's largest |p'| among the
    well-conditioned elements, and ``rel_leaf`` that leaf), ``abs`` (the
    largest |p - p'| among them), ``n_ill`` and ``ill_abs`` (the
    ill-conditioned elements' count and largest |p - p'|) and ``n``."""
    out = dict(rel=0.0, rel_leaf=None, abs=0.0, n_ill=0, ill_abs=0.0, n=0)
    for k, w in want.items():
        w, g = w.cpu().float(), got[k].cpu().float()
        ill = (want_v[k].cpu().float() / (1 - b2 ** steps)).sqrt() \
            < ILL_RMS * eps
        err = (g - w).abs()
        if not bool(ill.all()):
            worst = float(err[~ill].max())
            rel = worst / max(float(w.abs().max()), 1e-30)
            if rel > out["rel"]:
                out.update(rel=rel, rel_leaf=k)
            out["abs"] = max(out["abs"], worst)
        if bool(ill.any()):
            out["ill_abs"] = max(out["ill_abs"], float(err[ill].max()))
        out["n_ill"] += int(ill.sum())
        out["n"] += w.numel()
    return out


def mesh_dims(spec: str):
    return tuple(int(x) for x in spec.split("x"))


def psum_inputs(rank: int, round_: int) -> dict:
    """Rank ``rank``'s float32 gradients for `compressed_psum`'s round
    ``round_``: two leaves over five decades of magnitude."""
    g = np.random.default_rng(100 * round_ + rank)
    return {"a": (g.standard_normal((8, 64))
                  * 10.0 ** g.integers(-2, 3, (8, 64))).astype(np.float32),
            "b": g.standard_normal((3, 5)).astype(np.float32)}


def _ranks(rank: int, world: int, store: str, out: str,
           device: str = "cpu", steps: int = 1) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import manifest as M
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.shardutil import state_shardings
    from repro_torch.models import moe as MOE
    from repro_torch.parallel import sharding as PS
    from repro_torch.train import OptConfig, abstract_state
    from repro_torch.train import compression as C
    from repro_torch.train import steps as ST
    from repro_torch.train.optimizer import OptState

    torch.set_num_threads(1)   # the ranks share the test machine's cores
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    dev = torch.device(device)
    inputs = torch.load(os.path.join(out, "inputs.pt"), map_location=dev)
    local_calls = [0]
    pool = MOE._apply_moe_local

    def counted(*args):
        local_calls[0] += 1
        return pool(*args)

    MOE._apply_moe_local = counted
    cpu = lambda tree: {k: t.cpu() for k, t in tree.items()}
    got = {}
    for spec in WORLD_MESHES[world]:
        rules = PS.make_rules(tmesh.make_mesh(mesh_dims(spec), dev.type))
        for arch in ARCHS:
            cfg = case_fields(get_config(arch, reduced=True))
            saved = copy.deepcopy(inputs[arch])   # the step takes it over
            state = ST.load_state(
                ST.init_state(torch.Generator(device=dev), cfg, dev),
                ST.TrainState(saved["params"], OptState(
                    saved["m"], saved["v"], saved["count"]), saved["step"]))
            state = ST.shard_state(
                state, state_shardings(abstract_state(cfg), rules))
            step = ST.make_sharded_train_step(cfg, OptConfig(**STEP_OPT),
                                              rules)
            local_calls[0] = 0
            by_step, walls = [], []
            for _ in range(steps):
                t0 = time.perf_counter()
                state, metrics = step(state, inputs["batch"])
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                by_step.append(cpu(metrics))
            whole = ST.gather_state(state)
            got[spec, arch] = dict(
                metrics=by_step[-1], by_step=by_step, walls=walls,
                params=cpu(whole.params),
                m=cpu(whole.opt.m), v=cpu(whole.opt.v),
                local_calls=local_calls[0],
                local_shapes={k: tuple(p.to_local().shape) for k, p in
                              state.params.state_dict().items()})
    psum = {}
    groups = {"world": None}
    if world == 4:
        groups["data"] = tmesh.make_mesh((2, 2), dev.type)["data"]
    for name, group in groups.items():
        ef = None
        for round_ in (0, 1):
            grads = {k: torch.from_numpy(v).to(dev)
                     for k, v in psum_inputs(rank, round_).items()}
            ef = C.init_ef(grads) if ef is None else ef
            mean, ef = C.compressed_psum(grads, ef, group)
            psum[name, round_] = dict(mean=cpu(mean),
                                      residual=cpu(ef.residual))
    got["psum"] = psum
    if world == 4 and dev.type == "cpu":
        got["launch"] = _launch(out, ttrain, M, dist)
    torch.save(got, os.path.join(out, f"w{world}-rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _launch(out, ttrain, M, dist) -> dict:
    """``launch/train.py --mesh 2x2``: uninterrupted, then killed after
    step 2's checkpoint and resumed; each run's result and rank 0's
    log."""
    runs = {}
    for name in ("full", "killed", "resumed"):
        root = os.path.join(out, "ckpt-full" if name == "full"
                            else "ckpt-killed")
        if name == "resumed":
            dist.barrier()
            if dist.get_rank() == 0:
                M.remove_step(os.path.join(root, "manifests"), 3)
            dist.barrier()
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            res = ttrain.train(ttrain.parse_args(LAUNCH + ["--ckpt-dir",
                                                           root]))
        runs[name] = dict(result=res, log=log.getvalue())
    return runs


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(ROOT, "src"))
    _ranks(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
           *sys.argv[5:6], *map(int, sys.argv[6:7]))
