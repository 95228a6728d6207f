"""The port's sharded serve steps and the checkpoint name map.

* `train.steps.make_sharded_prefill_step` / `make_sharded_decode_step`
  on a gloo world of two CPU processes (tests/torch_serve_shard_worker.py,
  spawned once by the module fixture), the reduced gemma-2b and the
  reduced mixtral-8x22b (local MoE pools, float32 compute), meshes "2"
  (the batch split over ``data``) and "1x2" (``model`` alone, no split),
  against the unsharded `make_prefill_step` / `make_decode_step` on the
  whole batch under the rules of the mesh's shape (so the MoE pools are
  the same): each rank's prefill logits and decode caches are its rows'
  of the unsharded run bit for bit, and so are its decode logits where
  the batch is not split; under the split (two rows of four) the CPU's
  matrix product of the head takes another blocking, and the decode
  logits are held to `LOGIT_RTOL` of the largest (the largest gap seen,
  1.5e-7 on 0.59, is one float32 ulp of it).
* `interop.restore_jax_train_state`: a checkpoint the JAX package's
  ``Checkpointer`` wrote of its ``TrainState`` (reduced dense, MoE, SSM
  and encoder-decoder configurations; m and v seeded numpy draws, the
  counters set) restores through the port's ``Checkpointer`` bit for bit
  as `interop.train_state_from_numpy` of the same arrays; and
  `interop.save_jax_train_state` writes the port's state under the JAX
  names, which the JAX package's ``Checkpointer.restore(target=...)``
  reads back bit for bit.
"""

import dataclasses
import fcntl
import os
import subprocess
import sys
import tempfile
import time
from collections import OrderedDict
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_serve_shard_worker as worker
import torch_sharding_worker as shard_worker
from repro.configs import get_config as jax_get_config
from repro.train import init_state as jax_init_state
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as PS
from repro_torch.train import steps as ST
from test_torch_checkpoint import _ckpt, _ref_ckpt
from torch_jax_release import release_compiled_programs  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_serve_shard_worker.py"
SPAWN_TIMEOUT = 240  # seconds, for each spawned process
WORLD = 2
CASES = [(m, a) for m in worker.MESHES for a in worker.ARCHS]
LOGIT_RTOL = 1e-6
CKPT_ARCHS = ("gemma-2b", "mixtral-8x22b", "jamba-v0.1-52b", "whisper-tiny")


# ------------------------------------------------------------ serve steps


def _inputs() -> dict:
    g = np.random.default_rng(7)
    inputs = {"prompt": torch.from_numpy(g.integers(
                  0, 512, (worker.B, worker.S)).astype(np.int32)),
              "decode": torch.from_numpy(g.integers(
                  0, 512, (worker.B, worker.STEPS)).astype(np.int32))}
    for i, arch in enumerate(worker.ARCHS):
        cfg = shard_worker.case_fields(get_config(arch, reduced=True))
        lm = T.init_lm(torch.Generator().manual_seed(i), cfg, "cpu")
        inputs[arch] = OrderedDict(lm.state_dict())
    return inputs


def _unsharded(inputs: dict, spec: str, arch: str) -> dict:
    """The unsharded steps on the whole batch, under the rules of the
    mesh's shape."""
    cfg = shard_worker.case_fields(get_config(arch, reduced=True))
    lm = T.build_lm(None, cfg, torch.device("meta"))
    lm.load_state_dict(inputs[arch], assign=True)
    dims = shard_worker.mesh_dims(spec)
    names = ("data", "model")[:len(dims)]
    with PS.use_mesh_rules(PS.make_rules(PS.MeshShape(names, dims))):
        logits = ST.make_prefill_step(cfg)(lm, {"tokens": inputs["prompt"]})
        caches = T.init_caches(cfg, worker.B, worker.CACHE, "cpu")
        decode = ST.make_decode_step(cfg)
        steps = []
        for t in range(worker.STEPS):
            out, caches = decode(lm, caches, inputs["decode"][:, t:t + 1], t)
            steps.append(out)
    return dict(prefill=logits, decode=steps, caches=caches)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn the gloo world of two (once: under ``pytest -n`` the first
    worker to need it spawns it under a lock, the others read its
    results) and collect what each rank got; the unsharded runs are
    computed where a test first asks for them (`_want`)."""
    base = tmp_path_factory.getbasetemp()
    shared = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    out = shared / "torch_serve_shard_runs"
    with open(shared / "torch_serve_shard_runs.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (out / "done").exists():
            out.mkdir(parents=True, exist_ok=True)
            torch.save(_inputs(), out / "inputs.pt")
            env = dict(os.environ, PYTHONPATH=os.pathsep.join(
                [str(ROOT / "src")]
                + [p for p in [os.environ.get("PYTHONPATH")] if p]))
            started = time.monotonic()
            procs = [subprocess.Popen(
                [sys.executable, str(WORKER), str(r), str(WORLD),
                 str(out / "store"), str(out)], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for r in range(WORLD)]
            failed = []
            try:
                for r, proc in enumerate(procs):
                    left = max(SPAWN_TIMEOUT - (time.monotonic() - started),
                               1.0)
                    try:
                        log, _ = proc.communicate(timeout=left)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        log, _ = proc.communicate()
                        failed.append(f"rank {r} timed out:\n{log[-3000:]}")
                        continue
                    if proc.returncode != 0:
                        failed.append(f"rank {r} exited {proc.returncode}:"
                                      f"\n{log[-3000:]}")
            finally:
                for proc in procs:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
            assert not failed, "\n\n".join(failed)
            (out / "done").touch()
    inputs = torch.load(out / "inputs.pt")
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return dict(inputs=inputs, ranks=ranks, want={})


def _want(runs, spec, arch):
    if (spec, arch) not in runs["want"]:
        runs["want"][spec, arch] = _unsharded(runs["inputs"], spec, arch)
    return runs["want"][spec, arch]


def _rows(spec: str, rank: int) -> slice:
    """The batch rows a rank computes: its half under the data split."""
    if shard_worker.mesh_dims(spec)[0] == 1:
        return slice(None)
    n = worker.B // WORLD
    return slice(rank * n, (rank + 1) * n)


@pytest.mark.parametrize("spec,arch", CASES)
def test_sharded_prefill_matches_unsharded(runs, spec, arch):
    want = _want(runs, spec, arch)["prefill"]
    for rank, got in enumerate(runs["ranks"]):
        got = got[spec, arch]
        assert got["prefill"].shape[0] == got["rows"]
        assert torch.equal(got["prefill"], want[_rows(spec, rank)]), rank


@pytest.mark.parametrize("spec,arch", CASES)
def test_sharded_decode_matches_unsharded(runs, spec, arch):
    """Every step's logits, then every layer's cache fields (a ring's
    ``slot_pos`` has no batch axis)."""
    want = _want(runs, spec, arch)
    for rank, got in enumerate(runs["ranks"]):
        got, rows = got[spec, arch], _rows(spec, rank)
        for t, (a, b) in enumerate(zip(got["decode"], want["decode"])):
            if rows == slice(None):
                assert torch.equal(a, b), (rank, t)
            else:
                gap = float((a - b[rows]).abs().max())
                assert gap <= LOGIT_RTOL * float(b.abs().max()), (rank, t,
                                                                  gap)
        for li, (a, b) in enumerate(zip(got["caches"], want["caches"])):
            for k in b:
                w = b[k] if k == "slot_pos" else b[k][rows]
                assert torch.equal(a[k], w), (rank, li, k)


def test_sharded_serve_steps_refuse_encdec():
    cfg = get_config("whisper-tiny", reduced=True)
    rules = PS.make_rules(PS.MeshShape(("data", "model"), (1, 1)))
    for make in (ST.make_sharded_prefill_step, ST.make_sharded_decode_step):
        with pytest.raises(ValueError, match="encoder-decoder"):
            make(cfg, rules)


# ---------------------------------------------------------- name map


def _jax_state(arch: str):
    """The JAX package's ``init_state`` of the reduced ``arch`` as numpy,
    its m and v seeded draws and its counters set."""
    jcfg = jax_get_config(arch, reduced=True)
    state = jax.tree.map(np.asarray,
                         jax_init_state(jax.random.key(0), jcfg))
    g = np.random.default_rng(CKPT_ARCHS.index(arch))
    draw = lambda a: g.standard_normal(a.shape).astype(a.dtype)  # noqa
    opt = state.opt._replace(m=jax.tree.map(draw, state.opt.m),
                             v=jax.tree.map(lambda a: np.abs(draw(a)),
                                            state.opt.v),
                             count=np.asarray(7, np.int32))
    state = state._replace(opt=opt, step=np.asarray(5, np.int32))
    cfg = interop.model_config_from_fields(dataclasses.asdict(jcfg))
    return jcfg, cfg, state


def _assert_states_equal(got, want):
    for tree_got, tree_want in ((got.params.state_dict(),
                                 want.params.state_dict()),
                                (got.opt.m, want.opt.m),
                                (got.opt.v, want.opt.v)):
        assert list(tree_got) == list(tree_want)
        for k, w in tree_want.items():
            assert tree_got[k].dtype == w.dtype and torch.equal(
                tree_got[k], w), k
    for a, b in ((got.opt.count, want.opt.count), (got.step, want.step)):
        assert a.dtype == torch.int32 and torch.equal(a, b)


@pytest.mark.parametrize("arch", CKPT_ARCHS)
def test_jax_checkpoint_restores_into_the_port(arch):
    _, cfg, state = _jax_state(arch)
    with tempfile.TemporaryDirectory() as d:
        ref = _ref_ckpt(d)
        ref.save(4, state)
        ref.wait_until_finished()
        got = interop.restore_jax_train_state(_ckpt(d), cfg, device="cpu")
    _assert_states_equal(got, interop.train_state_from_numpy(state, cfg,
                                                             device="cpu"))


@pytest.mark.parametrize("arch", CKPT_ARCHS)
def test_port_jax_layout_write_restores_in_jax(arch):
    _, cfg, state = _jax_state(arch)
    port = interop.train_state_from_numpy(state, cfg, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        interop.save_jax_train_state(_ckpt(d), 4, port, cfg)
        got = _ref_ckpt(d).restore(target=state)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(state)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


def test_name_map_round_trip():
    """`port_names` and `jax_leaf_name` are inverse on every parameter of
    every reduced configuration."""
    from repro_torch.configs import ARCH_IDS
    for arch in ARCH_IDS:
        cfg = get_config(arch, reduced=True)
        for name in ST.abstract_state(cfg).params.state_dict():
            path, entry = interop.jax_leaf_name(name, cfg)
            names = interop.port_names(path, cfg)
            assert names[0 if entry is None else entry] == name, (arch, name)
