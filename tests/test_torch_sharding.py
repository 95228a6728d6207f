"""The port's sharded LM stack against the JAX package: the sharding rules
(`parallel.sharding`, `launch.shardutil`), the production mesh
(`launch.mesh`), the int8 error-feedback collective
(`train.compression`), the MoE local pools (`models.moe`) and the
sharded train step (`train.steps.make_sharded_train_step`) with
``launch/train.py --mesh``.

* The rules, in this process, on meshes given by their names and sizes
  alone (a `sharding.MeshShape`; the reference's rule functions get a
  stand-in with only ``.shape`` and ``.axis_names``, all they read):
  `param_specs` leaf for leaf for every arch at full size (meta-device
  state against ``abstract_state``), on the production meshes (16 x 16;
  2 x 16 x 16, with and without ``fsdp_over_pod``) and on 2, 1 x 2 and
  2 x 2; `spec_bytes_per_device` alike; `roles_to_shardings` for every
  arch and assigned shape and `state_shardings` (the reference's
  ``NamedSharding``s on a JAX ``AbstractMesh``, a mesh of no devices).
  A port leaf's spec is the reference's spec of its group position less
  the leading, stacked ``None``.
* `quantize`/`dequantize` bit for bit on the same arrays, values at
  exactly half a step included (both round half to even).
* `_apply_moe_local` against the reference's, called directly with dp 2
  and 4 and no rules bound (its constraints are no-ops): outputs and aux
  terms within 1e-6 in float32, dropped shares equal.
* Gloo CPU worlds of 2 and 4 ranks (tests/torch_sharding_worker.py, one
  process a rank), spawned once per test run beside one process an arch
  running the JAX package's sharded step under four forced host devices
  (tests/torch_sharding_reference.py; its mesh built with
  ``repro.compat.make_mesh``): `compressed_psum` over
  the worlds against the reference's under ``shard_map``, bit for bit;
  one sharded step of the reduced gemma-2b and mixtral-8x22b (float32,
  local MoE pools) on meshes 2, 1x2 (world of 2) and 2x2 (world of 4)
  against (i) the port's unsharded step, run in this process under the
  same rules on a `MeshShape` (so the MoE pools are the same
  data-parallel pools), and (ii) the reference's sharded step, with the
  tolerances tests/test_torch_train.py applies: the loss and the grad
  norm to ``F32_LOSS_RTOL``; against (i) m and the square root of v
  (the gradient and its magnitude, Adam's weighted mean and root mean
  square of the gradients) to the bound ``GRAD_ATOL`` puts on them
  (`torch_sharding_worker.moment_errors`; the gradients, summed over
  the ranks in another order, differ by up to 8.8e-7 of a tensor's
  largest in v on the CPU, 1.04e-6 on the card); the parameters against
  both to ``OPT_RTOL`` of each leaf's largest value, except the
  ill-conditioned elements, where the reference's root mean square
  gradient ``sqrt(v_hat)`` is below 1000 times Adam's eps (1e-5), which
  are counted, printed and held to the update's own bound ``2 * lr``
  (`torch_sharding_worker.param_errors`: Adam moves an element by
  ``lr * m_hat / (sqrt(v_hat) + eps)``, and near eps the gradient's
  order of summation moves that ratio by more than its rounding).
  Measured on the CPU: 4,205 of gemma's 172,352 elements and 48,483 of
  mixtral's 287,552 are ill-conditioned; the others are within 1.2e-7
  of their leaf's largest against (i) and 2.3e-7 against (ii), where a
  threshold of 100 eps leaves 1.05e-6; the ill-conditioned ones within
  2.3e-5 (0.046 lr) against (ii);
  ``launch/train.py --mesh 2x2`` in the world of 4: 3 steps with a
  checkpoint every 2, rank 0 alone writing, resumed from step 2 equal to
  the uninterrupted run.
"""

import dataclasses
import fcntl
import os
import subprocess
import sys
import time
from collections import OrderedDict
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

import torch_sharding_worker as worker
from repro.compat import simple_keystr
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import shapes as JS
from repro.launch import shardutil as JSU
from repro.models import moe as JMOE
from repro.parallel import sharding as JPS
from repro.train import compression as JC
from repro.train import init_state as jax_init_state
from repro.train.steps import abstract_state as jax_abstract_state
from repro_torch import interop
from repro_torch.checkpoint import manifest as M
from repro_torch.configs import get_config
from repro_torch.configs import shapes as S
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shardutil as SU
from repro_torch.launch import train as ttrain
from repro_torch.models import moe as MOE
from repro_torch.parallel import sharding as PS
from repro_torch.train import OptConfig, abstract_state, make_train_step
from repro_torch.train import compression as C
from torch_jax_release import release_compiled_programs  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_sharding_worker.py"
REFERENCE = Path(__file__).resolve().parent / "torch_sharding_reference.py"
SPAWN_TIMEOUT = 240  # seconds, for each spawned process
F32_LOSS_RTOL, OPT_RTOL = 1e-5, 1e-6   # tests/test_torch_train.py's
MOE_TOL = 1e-6
# (dimension names, sizes, fsdp_over_pod)
MESHES = ((("data", "model"), (16, 16), False),
          (("pod", "data", "model"), (2, 16, 16), False),
          (("pod", "data", "model"), (2, 16, 16), True),
          (("data",), (2,), False),
          (("data", "model"), (1, 2), False),
          (("data", "model"), (2, 2), False))
CASES = [(m, a) for m in worker.MESHES for a in worker.ARCHS]


def _rules(names, sizes, fsdp_over_pod=False, abstract=False):
    """The port's rules and the reference's on one mesh shape.  The
    reference's rule functions get a stand-in with only ``.shape`` and
    ``.axis_names``; its ``NamedSharding``s (``abstract``) a JAX
    ``AbstractMesh``, a mesh of no devices."""
    port = PS.make_rules(PS.MeshShape(names, sizes),
                         fsdp_over_pod=fsdp_over_pod)
    stand_in = jax.sharding.AbstractMesh(sizes, names) if abstract else \
        SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes)))
    return port, JPS.make_rules(stand_in, fsdp_over_pod=fsdp_over_pod)


def _spec(p) -> tuple:
    """A JAX ``PartitionSpec`` as the port's tuple."""
    return tuple(p)


def _ref_by_port_name(tree, cfg, fn):
    """``fn(path, leaf)`` of every leaf of a reference pytree, keyed by the
    port's names, its stacked leading entry dropped."""
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        path = simple_keystr(kp)
        stacked = path.split("/")[0] in ("groups", "enc_groups")
        for name in interop.port_names(path, cfg):
            out[name] = fn(path, leaf, stacked)
    return out


# ----------------------------------------------------------------- rules


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_param_specs_match_jax(arch):
    """Every leaf's spec and per-device bytes, every mesh of `MESHES`."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    params = abstract_state(cfg).params
    jparams = jax_abstract_state(jcfg).params
    dtypes = {k: t.dtype for k, t in params.state_dict().items()}
    assert all(t.is_meta for t in params.state_dict().values())
    for names, sizes, over_pod in MESHES:
        rules, jrules = _rules(names, sizes, over_pod)
        jspecs = JPS.param_specs(jparams, jrules)
        want = _ref_by_port_name(
            jspecs, cfg, lambda _, s, st: _spec(s)[1:] if st else _spec(s))
        got = PS.param_specs(params, rules)
        assert got == want, (names, sizes)
        shapes = _ref_by_port_name(
            jparams, cfg, lambda _, a, st: (a.shape[1:] if st else a.shape,
                                            a.dtype))
        for k, spec in got.items():
            shape, jdtype = shapes[k]
            assert str(dtypes[k]).removeprefix("torch.") == str(jdtype)
            assert PS.spec_bytes_per_device(
                tuple(shape), dtypes[k], spec, rules) == \
                JPS.spec_bytes_per_device(shape, jdtype, P_(spec), jrules)
        assert set(PS.named_placements(params, rules)) == set(got)


def P_(spec):
    return jax.sharding.PartitionSpec(*spec)


def _unstacked(cfg, tree):
    """A reference decode-cache tree as the port keeps it: per layer."""
    if cfg.enc_dec:
        return {part: [tree[part] for _ in range(cfg.n_layers)]
                for part in ("self", "cross")}
    return [tree[f"pos_{li % cfg.group_size}"] for li in range(cfg.n_layers)]


def _drop_lead(tree):
    return jax.tree.map(lambda s: s[1:], tree,
                        is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_roles_to_shardings_and_state_shardings_match_jax(arch):
    """Every assigned shape that applies, on every mesh: the input
    shardings spec for spec (a decode cache leaf's less the reference's
    leading group entry); then `state_shardings`: the parameters, m and v
    by the parameter's spec, the counters replicated."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    specs = {}
    for name, spec in S.SHAPES.items():
        if S.shape_applies(cfg, spec)[0]:
            specs[name] = (S.input_specs(cfg, spec),
                           JS.input_specs(jcfg, JS.SHAPES[name]))
    state_abs, jstate_abs = abstract_state(cfg), jax_abstract_state(jcfg)
    for names, sizes, over_pod in MESHES:
        rules, jrules = _rules(names, sizes, over_pod, abstract=True)
        for name, ((args, roles), (jargs, jroles)) in specs.items():
            got = jax.tree.map(
                lambda s: s.spec, SU.roles_to_shardings(args, roles, rules),
                is_leaf=lambda x: isinstance(x, SU.Sharding))
            want = jax.tree.map(lambda s: _spec(s.spec),
                                JSU.roles_to_shardings(jargs, jroles, jrules))
            if S.SHAPES[name].kind == "decode":
                want = (_drop_lead(_unstacked(cfg, want[0])), *want[1:])
            assert got == tuple(want), (name, names, sizes)
        st = SU.state_shardings(state_abs, rules)
        jst = JSU.state_shardings(jstate_abs, jrules)
        for got_tree, want_tree in ((st.params, jst.params),
                                    (st.opt.m, jst.opt.m),
                                    (st.opt.v, jst.opt.v)):
            want = _ref_by_port_name(
                want_tree, cfg,
                lambda _, s, stk: _spec(s.spec)[1:] if stk else _spec(s.spec))
            assert {k: s.spec for k, s in got_tree.items()} == want
        for got, want in ((st.opt.count, jst.opt.count),
                          (st.step, jst.step)):
            assert got.spec == _spec(want.spec) == ()


def test_placements_constrain_and_meshes():
    """`placements` of specs with one and two mesh dimensions a tensor
    dim; `constrain` returns its tensor with or without rules and refuses
    an unknown role; `n_chips`, the production mesh refused in this world
    of one naming its size, the launcher's `build_mesh` giving None."""
    mesh = PS.MeshShape(("pod", "data", "model"), (2, 16, 16))
    assert PS.placements((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert PS.placements((), mesh) == (Replicate(),) * 3
    assert PS.placements((None, "data"), mesh) == \
        (Replicate(), Shard(1), Replicate())
    x = torch.ones(4, 6, 8)
    assert PS.constrain(x, ["batch", None, "model"]) is x
    rules = PS.make_rules(mesh)
    with PS.use_mesh_rules(rules):
        assert PS.current_rules() is rules
        assert PS.activations(x) is x
        assert PS.resolve_roles(x.shape, ["batch", None, "model"],
                                rules) == (None, None, None)
        assert PS.resolve_roles((64, 3, 32), ["batch", "fsdp", "model"],
                                rules) == (("pod", "data"), None, "model")
        with pytest.raises(ValueError):
            PS.constrain(x, ["bogus", None, None])
    assert PS.current_rules() is None
    assert (tmesh.n_chips(), tmesh.n_chips(multi_pod=True)) == (256, 512)
    assert tmesh.SINGLE_POD == (16, 16) and tmesh.MULTI_POD == (2, 16, 16)
    assert not dist.is_initialized()
    for multi_pod in (False, True):
        with pytest.raises(ValueError, match="the world size 1"):
            tmesh.make_production_mesh(multi_pod=multi_pod,
                                       device_type="cpu")
    assert ttrain.build_mesh("2x2", "cpu") is None
    assert not dist.is_initialized()


# ----------------------------------------------------------- compression


def _halves():
    """(g, e) whose sum lands on exact half steps of the scale: max 127,
    so the scale is 1 and x / scale is x."""
    x = np.array([127.0, -127.0, 0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 3.5,
                  126.5, -126.5, 0.0], np.float32)
    return x, np.zeros_like(x)


def _random(seed=0):
    g = np.random.default_rng(seed)
    return ((g.standard_normal((16, 33)) * 3).astype(np.float32),
            (g.standard_normal((16, 33)) * 0.01).astype(np.float32))


@pytest.mark.parametrize("case", ["random", "halves"])
def test_quantize_dequantize_bit_equal(case):
    g, e = _random() if case == "random" else _halves()
    q, scale, new_e = C.quantize(torch.from_numpy(g), torch.from_numpy(e))
    jq, jscale, jnew_e = JC.quantize(jnp.asarray(g), jnp.asarray(e))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(new_e.numpy(), np.asarray(jnew_e))
    np.testing.assert_array_equal(C.dequantize(q, scale).numpy(),
                                  np.asarray(JC.dequantize(jq, jscale)))
    if case == "halves":   # half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2
        assert q[2:9].tolist() == [0, 0, 2, -2, 2, -2, 4]
        assert q[9:11].tolist() == [126, -126]


def test_round_half_to_even_and_wire_bytes():
    x = np.arange(-8.5, 9.0, 0.5, dtype=np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(x))))
    grads = {"a": torch.ones(8, 64), "b": torch.ones(3, 5)}
    jgrads = {k: jnp.ones(v.shape) for k, v in grads.items()}
    for compressed in (False, True):
        assert C.wire_bytes(grads, compressed) == \
            JC.wire_bytes(jgrads, compressed)
    ef = C.init_ef(grads)
    assert all(torch.equal(r, torch.zeros_like(grads[k]))
               for k, r in ef.residual.items())


# -------------------------------------------------------------- MoE pools


@pytest.mark.parametrize("dp", [2, 4])
def test_apply_moe_local_matches_jax(dp):
    """The reduced mixtral's MoE layer in float32, B 4 x S 16 tokens in dp
    pools, no rules bound; then `apply_moe` under rules of dp data shards
    takes the same pools."""
    jcfg = dataclasses.replace(jax_get_config("mixtral-8x22b", reduced=True),
                               compute_dtype="float32")
    cfg = interop.model_config_from_fields(dataclasses.asdict(jcfg))
    jp = JMOE.init_moe(jax.random.key(3), jcfg)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(dp).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32)
    jy, jaux = JMOE._apply_moe_local(jp, jnp.asarray(x), jcfg, dp)
    y, aux = MOE._apply_moe_local(p, torch.from_numpy(x), cfg, dp)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                               atol=MOE_TOL * float(np.abs(jy).max()))
    for got, want in zip(aux[:2], jaux[:2]):
        assert float(got) == pytest.approx(float(want), rel=MOE_TOL)
    assert float(aux.dropped_fraction) == float(jaux.dropped_fraction)
    local = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch="local"))
    with PS.use_mesh_rules(PS.make_rules(PS.MeshShape(("data",), (dp,)))):
        y2, aux2 = MOE.apply_moe(p, torch.from_numpy(x), local)
    assert torch.equal(y2, y) and all(torch.equal(a, b)
                                      for a, b in zip(aux2, aux))


# ---------------------------------------------------------------- worlds


def _batch():
    return SyntheticTokens(DataConfig(vocab_size=512, seq_len=worker.S,
                                      global_batch=worker.B, seed=1)
                           ).batch_at(0, device="cpu")


def _port_state(arch):
    """The reference's ``init_state(key 0)`` of a case's config, as a port
    train state on the CPU."""
    jcfg = worker.case_fields(jax_get_config(arch, reduced=True))
    cfg = interop.model_config_from_fields(dataclasses.asdict(jcfg))
    jstate = jax.tree.map(np.asarray, jax_init_state(jax.random.key(0),
                                                     jcfg))
    return cfg, interop.train_state_from_numpy(jstate, cfg, device="cpu")


def _unsharded(arch, spec, batch):
    """The port's unsharded step under the rules of the mesh's shape."""
    cfg, state = _port_state(arch)
    dims = worker.mesh_dims(spec)
    names = ("data", "model")[:len(dims)]
    step = make_train_step(cfg, OptConfig(**worker.STEP_OPT))
    with PS.use_mesh_rules(PS.make_rules(PS.MeshShape(names, dims))):
        state, metrics = step(state, batch)
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                params=dict(state.params.state_dict()), m=state.opt.m,
                v=state.opt.v)


def _nest(flat: dict) -> dict:
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = v
    return out


def _start(out: Path, batch: dict) -> dict:
    """Start the gloo worlds and the reference's sharded runs (one process
    an arch) into ``out``; the running processes by name."""
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / "batch.npz", **{k: v.numpy() for k, v in batch.items()})
    inputs = {"batch": batch}
    for arch in worker.ARCHS:
        _, state = _port_state(arch)
        inputs[arch] = dict(params=OrderedDict(state.params.state_dict()),
                            m=state.opt.m, v=state.opt.v,
                            count=state.opt.count, step=state.step)
    torch.save(inputs, out / "inputs.pt")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = {f"reference-{arch}": [sys.executable, str(REFERENCE), str(out),
                                   arch] for arch in worker.ARCHS}
    for world in worker.WORLD_MESHES:
        for rank in range(world):
            procs[f"w{world}-rank{rank}"] = [
                sys.executable, str(WORKER), str(rank), str(world),
                str(out / f"store{world}"), str(out)]
    return {name: subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
            for name, cmd in procs.items()}


def _finish(out: Path, running: dict, started: float) -> None:
    """Wait for `_start`'s processes, each within SPAWN_TIMEOUT of the
    start; any failure fails the fixture."""
    try:
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
    (out / "done").touch()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn the gloo worlds and the reference's sharded runs, compute the
    unsharded runs (while those run, in the worker that spawned them),
    and collect every result.  Under ``pytest -n`` the workers'
    temporary directories share one parent: the first worker to need the
    worlds spawns them there, under a lock, and the others read its
    results rather than spawn their own."""
    base = tmp_path_factory.getbasetemp()
    shared = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    out = shared / "torch_sharding_runs"
    batch = _batch()
    unsharded = lambda: {(spec, arch): _unsharded(arch, spec, batch)
                         for spec, arch in CASES}
    want = None
    with open(shared / "torch_sharding_runs.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (out / "done").exists():
            started = time.monotonic()
            running = _start(out, batch)
            try:
                want = unsharded()
            finally:
                _finish(out, running, started)
    ranks = {w: [torch.load(out / f"w{w}-rank{r}.pt", weights_only=False)
                 for r in range(w)] for w in worker.WORLD_MESHES}
    reference = {}
    for arch in worker.ARCHS:
        reference.update(np.load(out / f"reference-{arch}.npz"))
    return dict(ranks=ranks, unsharded=want or unsharded(), out=out,
                reference=reference)


def _world(spec):
    return next(w for w, ms in worker.WORLD_MESHES.items() if spec in ms)


def _check_params(got, want, want_v, lr, what):
    """``got`` against ``want`` after one Adam step (`worker.param_errors`):
    the well-conditioned elements within OPT_RTOL of their leaf's largest
    value, the ill-conditioned ones (the reference's root mean square
    gradient below 1000 eps) within the update's own bound 2 * lr, and
    their count printed."""
    e = worker.param_errors(got, want, want_v, steps=1)
    print(f"{what}: parameters max rel {e['rel']:.3g} ({e['rel_leaf']}); "
          f"{e['n_ill']} of {e['n']} elements ill-conditioned, max abs "
          f"{e['ill_abs']:.3g}")
    assert e["rel"] <= OPT_RTOL and e["ill_abs"] <= 2 * lr, (what, e)


@pytest.mark.parametrize("spec,arch", CASES)
def test_sharded_step_matches_unsharded(runs, spec, arch):
    """Every rank's loss, metrics and grad norm within F32_LOSS_RTOL of
    the unsharded step's, its gathered m and sqrt(v) within the bounds
    GRAD_ATOL puts on them, its parameters within OPT_RTOL (`_check_params`);
    bit for bit where the batch is not split (1x2: the same sums in the
    same order)."""
    want = runs["unsharded"][spec, arch]
    lr = want["metrics"]["lr"]
    for rank, got in enumerate(runs["ranks"][_world(spec)]):
        got = got[spec, arch]
        for k, v in want["metrics"].items():
            assert float(got["metrics"][k]) == pytest.approx(
                v, rel=F32_LOSS_RTOL, abs=1e-12), (rank, k)
        dm, dv, m_tol, v_tol = worker.moment_errors(
            got["m"], got["v"], want["m"], want["v"], steps=1)
        assert dm <= m_tol and dv <= v_tol, (rank, dm, dv)
        _check_params(got["params"], want["params"], want["v"], lr,
                      f"{spec} {arch} rank {rank}")
        if worker.mesh_dims(spec)[0] == 1:
            for part in ("params", "m", "v"):
                assert all(torch.equal(got[part][k], w)
                           for k, w in want[part].items()), part


@pytest.mark.parametrize("spec,arch", CASES)
def test_sharded_step_matches_reference_sharded(runs, spec, arch):
    """Rank 0 against the JAX package's sharded step on the same mesh:
    the loss, nll and grad norm to F32_LOSS_RTOL, the parameters to
    OPT_RTOL (`_check_params`, ill-conditioned by the reference's v)."""
    ref = runs["reference"]
    key = f"{spec}/{arch}/"
    got = runs["ranks"][_world(spec)][0][spec, arch]
    for k in ("loss", "nll", "grad_norm", "lb_loss", "z_loss"):
        want = float(ref[key + "metrics/" + k])
        assert float(got["metrics"][k]) == pytest.approx(
            want, rel=F32_LOSS_RTOL, abs=1e-12), k
    assert float(got["metrics"]["moe_dropped"]) == pytest.approx(
        float(ref[key + "metrics/moe_dropped"]), abs=1e-7)
    cfg = worker.case_fields(get_config(arch, reduced=True))
    want, want_v = (interop.lm_state_dict_from_numpy(_nest(
        {k[len(key + part):]: v for k, v in ref.items()
         if k.startswith(key + part)}), cfg, "cpu")
        for part in ("params/", "v/"))
    assert set(want) == set(got["params"])
    _check_params(got["params"], want, want_v, float(got["metrics"]["lr"]),
                  f"{spec} {arch} against the reference")


def test_sharded_state_placed_by_the_specs_and_moe_pools(runs):
    """Every rank's local shard of every parameter is the whole divided
    by the mesh sizes its spec names; mixtral's local pools ran on the
    meshes whose data axis splits the batch, gemma's never."""
    for spec in worker.MESHES:
        dims = worker.mesh_dims(spec)
        names = ("data", "model")[:len(dims)]
        rules = PS.make_rules(PS.MeshShape(names, dims))
        for arch in worker.ARCHS:
            cfg = worker.case_fields(get_config(arch, reduced=True))
            whole = abstract_state(cfg).params.state_dict()
            specs = PS.param_specs(whole, rules)
            for got in runs["ranks"][_world(spec)]:
                got = got[spec, arch]
                for k, t in whole.items():
                    shape = list(t.shape)
                    for d, axis in enumerate(specs[k]):
                        shape[d] //= rules.axis_size(axis)
                    assert got["local_shapes"][k] == tuple(shape), k
                splits = dims[0] > 1 and cfg.moe is not None
                assert (got["local_calls"] > 0) == splits, (spec, arch)


@pytest.mark.parametrize("world", worker.PSUM_WORLDS)
def test_compressed_psum_matches_reference(runs, world):
    """Two rounds (the residual carried) over the world: every rank's
    mean bit-equal to the reference's shard of the same rank, its
    residual ``x - q * scale`` within one float32 ulp of ``x`` (XLA
    contracts the product and the difference into a fused multiply-add,
    rounding once; the port, built without contraction, rounds the
    product first); in round 2, whose ``x = g + e`` starts apart by the
    round-1 residual's difference, within that difference and two ulps
    of ``x`` (the sum's rounding, then the product's); the mean within
    the reference's bound (0.02 of the largest exact mean plus 1e-3) of
    the exact mean.  In the world of four, the 2x2 mesh's data dimension
    (a `DeviceMesh` in place of the group): the same on each pair of
    ranks, within the bound of the pair's exact mean."""
    ref = runs["reference"]
    rows = {k: v.shape[0] for k, v in worker.psum_inputs(0, 0).items()}
    for rank, got in enumerate(runs["ranks"][world]):
        for k, n in rows.items():
            e = carried = np.float32(0)
            for round_ in (0, 1):
                one = got["psum"]["world", round_]
                want = {part: ref[f"psum{world}/{round_}/{part}/{k}"][
                    rank * n:(rank + 1) * n] for part in ("mean", "residual")}
                np.testing.assert_array_equal(
                    one["mean"][k].numpy(), want["mean"],
                    err_msg=f"rank {rank} round {round_} mean {k}")
                x = worker.psum_inputs(rank, round_)[k] + e
                e = one["residual"][k].numpy()
                err = np.abs(e - want["residual"])
                ulps = 1 if round_ == 0 else 2
                assert (err <= ulps * np.spacing(np.abs(x)) + carried).all(), \
                    (rank, round_, k, float(err.max()))
                carried = err
    exact = {k: np.mean([worker.psum_inputs(r, 0)[k] for r in range(world)],
                        axis=0) for k in rows}
    for k, mean in exact.items():
        err = np.abs(runs["ranks"][world][0]["psum"]["world", 0]["mean"][k]
                     .numpy() - mean).max()
        assert err <= 0.02 * np.abs(mean).max() + 1e-3
    if world == 4:
        for pair in ((0, 2), (1, 3)):
            got = [runs["ranks"][4][r]["psum"]["data", 0]["mean"]
                   for r in pair]
            for k in rows:
                assert torch.equal(got[0][k], got[1][k])
                mean = np.mean([worker.psum_inputs(r, 0)[k] for r in pair],
                               axis=0)
                err = np.abs(got[0][k].numpy() - mean).max()
                assert err <= 0.02 * np.abs(mean).max() + 1e-3


def _launch(runs):
    return [r["launch"] for r in runs["ranks"][4]]


def test_launch_train_mesh_trains_and_checkpoints(runs):
    """``--mesh 2x2`` in the world of four: 3 steps, every rank the same
    finite metrics; checkpoints committed at steps 2 and 3."""
    launches = _launch(runs)
    full = launches[0]["full"]["result"]
    metrics = {k: v for k, v in full.items() if k != "ckpt_stats"}
    assert np.isfinite(metrics["loss"])
    for rank, one in enumerate(launches[1:], 1):
        assert one["full"]["result"] == metrics, rank
    assert "[train] step     3 loss=" in launches[0]["full"]["log"]
    assert M.committed_steps(str(runs["out"] / "ckpt-full" /
                                 "manifests")) == [2, 3]


def test_launch_train_mesh_resumes_as_uninterrupted(runs):
    """The same run with step 3's checkpoint removed resumes from step 2
    and ends with the uninterrupted run's metrics and checkpoint, bit for
    bit."""
    launches = _launch(runs)
    assert "[train] resumed from step 2" in launches[0]["resumed"]["log"]
    strip = lambda res: {k: v for k, v in res.items() if k != "ckpt_stats"}
    for one in launches:
        assert strip(one["resumed"]["result"]) == \
            strip(one["full"]["result"])
    a, b = (ttrain.make_checkpointer(ttrain.parse_args(
        worker.LAUNCH + ["--ckpt-dir", str(runs["out"] / d)])).restore(
            device="cpu") for d in ("ckpt-full", "ckpt-killed"))
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_launch_train_mesh_rank0_alone_writes(runs):
    """Rank 0's checkpointer wrote every checkpoint; no other rank had
    one; the checkpoint holds the whole, unsharded state."""
    launches = _launch(runs)
    for name in ("full", "killed", "resumed"):
        assert launches[0][name]["result"]["ckpt_stats"]["writes"] > 0
        assert all("ckpt_stats" not in one[name]["result"]
                   for one in launches[1:])
        assert all(one[name]["log"] == "" for one in launches[1:])
    cfg = get_config("gemma-2b", reduced=True)
    restored = ttrain.make_checkpointer(ttrain.parse_args(
        worker.LAUNCH + ["--ckpt-dir", str(runs["out"] / "ckpt-full")])
    ).restore(device="cpu")
    whole = abstract_state(cfg).params.state_dict()
    for k, t in whole.items():
        assert tuple(restored[f"params/{k}"].shape) == tuple(t.shape), k
