"""Parity of the port's training path with the JAX package.

The reduced gemma-2b, stablelm-1.6b and h2o-danube-3-4b configurations;
the JAX package's ``init_state(jax.random.key(0))`` draws the train
state, which is carried across as numpy arrays with
`interop.train_state_from_numpy`, and the batches come from
`SyntheticTokens` (the same tokens in both packages).  The JAX side runs
under ``jax.jit`` with its default XLA attention (``use_pallas_attn``
False: ``jax.grad`` cannot differentiate the Pallas kernel).

Tolerances:

* ``lm_loss`` at float32 compute: the loss and every metric to 1e-5
  relative (measured: 3e-7; the frameworks sum the products and the
  logsumexp in other orders).  At the default bfloat16 compute, 2e-3
  relative (measured: up to 4.7e-4): both round each product to bf16,
  a step of 2**-8, and an activation one step apart moves on through the
  later layers; the mean over the batch's tokens averages most of it out.
* Gradients, float32 compute: every parameter's to 1e-4 absolute
  (measured: 3e-6 at gradients up to 1.7).
* The optimizer alone, fed the same numpy gradients: parameters, m and v
  after 3 steps to 1e-6 of each tensor's largest magnitude, the grad norm
  and the learning rate to 1e-6 relative.  XLA contracts
  ``b1 * m + (1 - b1) * g`` into a fused multiply-add, which the port
  never does (one float32 rounding apart), and sums the global norm in
  another order.
* A whole ``make_train_step``, 3 steps: the loss to 1e-5 relative and the
  grad norm to 1e-5 relative at every step; the parameters to
  ``2 * sum(lr)`` absolute.  Adam's first steps move each parameter by
  about ``sign(m) * lr``: a gradient element near zero whose sign differs
  between the frameworks by a rounding moves by 2·lr in one and not the
  other (measured: 1.1e-4 on stablelm at lr 1e-3).
* Remat ``none`` / ``block`` / ``dots`` and resume from a checkpoint on
  the CPU: bit-equal (``torch.equal``), within the port.
"""

import collections
import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.compat import simple_keystr
from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro.train import OptConfig as JOptConfig
from repro.train import init_state as jax_init_state
from repro.train import make_train_step as jax_make_train_step
from repro.train import optimizer as JO
from repro.train.steps import eval_ppl as jax_eval_ppl
from repro_torch import interop
from repro_torch.checkpoint import CheckpointConfig, Checkpointer
from repro_torch.checkpoint import manifest as M
from repro_torch.configs import get_config
from repro_torch.core.policies import PolicyConfig
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.io import IOClientConfig
from repro_torch.io.striping import MB
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.train import (OptConfig, abstract_state, eval_ppl,
                               init_state, load_state, loss_fn_for,
                               make_prefill_step, make_train_step)
from repro_torch.train import optimizer as O

ARCHS = ["gemma-2b", "stablelm-1.6b", "h2o-danube-3-4b"]
B, S = 2, 24               # S past danube's reduced window (16)
F32_LOSS_RTOL, BF16_LOSS_RTOL, GRAD_ATOL = 1e-5, 2e-3, 1e-4
OPT_RTOL = 1e-6
STEP_OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)


@functools.lru_cache(maxsize=None)
def _setup(arch, compute_dtype="float32"):
    """(JAX cfg, JAX TrainState, port cfg, the state as numpy arrays)."""
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               compute_dtype=compute_dtype)
    jstate = jax_init_state(jax.random.key(0), jcfg)
    tcfg = interop.model_config_from_fields(dataclasses.asdict(jcfg))
    return jcfg, jstate, tcfg, jax.tree.map(np.asarray, jstate)


def _port_state(arch, compute_dtype="float32"):
    """A fresh port train state (the tests mutate it) from the JAX one."""
    *_, tcfg, np_state = _setup(arch, compute_dtype)
    return interop.train_state_from_numpy(np_state, tcfg, device="cpu")


def _batch(vocab, step, seq=S, batch=B, seed=1):
    return SyntheticTokens(DataConfig(vocab_size=vocab, seq_len=seq,
                                      global_batch=batch, seed=seed)
                           ).batch_at(step, device="cpu")


def _jax_batch(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def _loss_mask(seed=3):
    return torch.from_numpy(
        (np.random.default_rng(seed).random((B, S)) < 0.7).astype(
            np.float32))


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch, compute_dtype, masked=False):
    jcfg, jstate, _, _ = _setup(arch, compute_dtype)
    batch = _batch(jcfg.vocab_size, 0)
    if masked:
        batch["loss_mask"] = _loss_mask()
    fn = jax.jit(jax.value_and_grad(lambda p, b: JT.lm_loss(p, b, jcfg),
                                    has_aux=True))
    (loss, metrics), grads = fn(jstate.params, _jax_batch(batch))
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads))


def _port_loss_and_grads(params, batch, cfg):
    names, leaves = zip(*params.named_parameters())
    loss, metrics = T.lm_loss(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    return loss, metrics, dict(zip(names, grads))


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _leaf_err(got, want) -> float:
    """Largest difference over the largest magnitude of ``want``."""
    scale = max(float(want.abs().max()), 1e-30)
    return float((got - want).abs().max()) / scale


# ------------------------------------------------------------------- loss


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_matches_jax(arch, masked):
    want_loss, want_metrics, _ = _jax_value_and_grad(arch, "float32",
                                                     masked)
    *_, tcfg, _ = _setup(arch)
    params = _port_state(arch).params
    batch = _batch(tcfg.vocab_size, 0)
    if masked:
        batch["loss_mask"] = _loss_mask()
    loss, metrics = T.lm_loss(params, batch, tcfg)
    assert loss.dtype == torch.float32 and loss.requires_grad
    assert set(metrics) == set(want_metrics) == {"nll", "lb_loss", "z_loss",
                                                 "moe_dropped"}
    assert _rel(float(loss.detach()), want_loss) < F32_LOSS_RTOL
    assert _rel(float(metrics["nll"].detach()), want_metrics["nll"]) \
        < F32_LOSS_RTOL
    for k in ("lb_loss", "z_loss", "moe_dropped"):
        assert float(metrics[k]) == want_metrics[k] == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_bf16_matches_jax(arch):
    want_loss, _, _ = _jax_value_and_grad(arch, "bfloat16")
    *_, tcfg, _ = _setup(arch, "bfloat16")
    loss, _ = T.lm_loss(_port_state(arch, "bfloat16").params,
                        _batch(tcfg.vocab_size, 0), tcfg)
    assert _rel(float(loss.detach()), want_loss) < BF16_LOSS_RTOL


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax(arch):
    """Every parameter's gradient against ``jax.value_and_grad``, float32
    compute, mapped onto the port's names."""
    _, _, want = _jax_value_and_grad(arch, "float32")
    *_, tcfg, _ = _setup(arch)
    params = _port_state(arch).params
    _, _, grads = _port_loss_and_grads(params, _batch(tcfg.vocab_size, 0),
                                       tcfg)
    want = interop.lm_state_dict_from_numpy(want, tcfg, device="cpu")
    assert list(grads) == list(want) == list(params.state_dict())
    for name, g in grads.items():
        assert g.shape == want[name].shape and g.dtype == torch.float32
        assert float((g - want[name]).abs().max()) < GRAD_ATOL, name
    # the tied embedding takes both its gradients
    assert float(grads["embed.table"].abs().max()) > 0


# -------------------------------------------------------------- optimizer


OPT_CASES = {
    "warmup_clipped": dict(peak_lr=1e-2, warmup_steps=10, total_steps=100,
                           clip_norm=1.0),
    "cosine_unclipped": dict(peak_lr=1e-2, warmup_steps=0, total_steps=5,
                             clip_norm=1e9),
    "past_total_clipped": dict(peak_lr=1e-2, warmup_steps=1, total_steps=2,
                               clip_norm=0.5),
    "no_decay": dict(peak_lr=1e-2, warmup_steps=1, total_steps=10,
                     weight_decay=0.0, clip_norm=1e9),
}


@pytest.mark.parametrize("arch", ["gemma-2b", "stablelm-1.6b"])
@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_jax(arch, case):
    """`optimizer.update` alone, fed the same numpy gradients, 3 steps:
    warmup and cosine schedules, clipping on and off, the decay mask
    (stablelm's biases, the norms' scales) against ``optimizer.update``."""
    _, jstate, tcfg, np_state = _setup(arch)
    kw = OPT_CASES[case]
    jparams, jopt = jstate.params, JO.init(jstate.params)
    port = _port_state(arch)
    params, opt = port.params, O.init(port.params)
    rng = np.random.default_rng(7)
    for _ in range(3):
        np_grads = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * 0.3).astype(a.dtype),
            np_state.params)
        jparams, jopt, jm = JO.update(
            JOptConfig(**kw), jax.tree.map(jnp.asarray, np_grads), jopt,
            jparams)
        _, opt, tm = O.update(
            OptConfig(**kw),
            interop.lm_state_dict_from_numpy(np_grads, tcfg, device="cpu"),
            opt, params)
        assert _rel(float(tm["grad_norm"]), float(jm["grad_norm"])) < OPT_RTOL
        assert _rel(float(tm["lr"]), float(jm["lr"])) < OPT_RTOL
    assert opt.count.dtype == torch.int32 and int(opt.count) == 3
    for got, want in ((params.state_dict(), jparams), (opt.m, jopt.m),
                      (opt.v, jopt.v)):
        want = interop.lm_state_dict_from_numpy(
            jax.tree.map(np.asarray, want), tcfg, device="cpu")
        assert list(got) == list(want)
        for name in want:
            assert _leaf_err(got[name], want[name]) < OPT_RTOL, (case, name)


def test_lr_schedule_matches_jax():
    kw = dict(peak_lr=3e-3, warmup_steps=10, total_steps=100,
              min_lr_ratio=0.1)
    for step in range(0, 111, 3):
        want = float(JO.lr_at(JOptConfig(**kw), jnp.asarray(step)))
        got = float(O.lr_at(OptConfig(**kw), torch.tensor(step)))
        assert _rel(got, want) < OPT_RTOL or got == want == 0.0, step


@pytest.mark.parametrize("arch", ARCHS)
def test_decay_mask_name_for_name(arch):
    jcfg, jstate, tcfg, _ = _setup(arch)
    flat, _ = jax.tree_util.tree_flatten_with_path(jstate.params)
    decisions = {}
    for kp, _ in flat:
        path = simple_keystr(kp)
        for name in interop.port_names(path, tcfg):
            decisions[name] = JO._decay_mask(path)
    names = list(_port_state(arch).params.state_dict())
    assert sorted(decisions) == sorted(names)
    assert {n: O._decay_mask(n) for n in names} == decisions
    assert not all(decisions.values()) and any(decisions.values())


def test_clip_by_global_norm():
    """tests/test_optimizer.py's case: norm 10, clipped to 1."""
    g = {"a": torch.ones(4) * 3.0, "b": torch.ones(4) * 4.0}
    clipped, norm = O.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(10.0)
    assert float(O.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    jg = {"a": jnp.ones((4,)) * 3.0, "b": jnp.ones((4,)) * 4.0}
    jclipped, jnorm = JO.clip_by_global_norm(jg, 1.0)
    assert float(norm) == float(jnorm)
    for k in g:
        np.testing.assert_array_equal(clipped[k].numpy(),
                                      np.asarray(jclipped[k]))


# ------------------------------------------------------------- train step


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    jcfg, jstate, tcfg, _ = _setup(arch)
    jstep = jax.jit(jax_make_train_step(jcfg, JOptConfig(**STEP_OPT)))
    step = make_train_step(tcfg, OptConfig(**STEP_OPT))
    state = _port_state(arch)
    lr_sum = 0.0
    for i in range(3):
        batch = _batch(tcfg.vocab_size, i)
        jstate, jm = jstep(jstate, _jax_batch(batch))
        state, m = step(state, batch)
        assert not any(v.requires_grad for v in m.values())
        for k in ("loss", "nll", "grad_norm"):
            assert _rel(float(m[k]), float(jm[k])) < F32_LOSS_RTOL, (i, k)
        assert _rel(float(m["lr"]), float(jm["lr"])) < OPT_RTOL
        lr_sum += float(jm["lr"])
    assert int(state.step) == int(jstate.step) == 3
    want = interop.lm_state_dict_from_numpy(
        jax.tree.map(np.asarray, jstate.params), tcfg, device="cpu")
    got = state.params.state_dict()
    for name in want:
        err = float((got[name] - want[name]).abs().max())
        assert err <= 2 * lr_sum, (name, err)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_equal_and_recomputes_as_named(arch):
    """``remat`` none / block / dots: the same loss and gradients, bit for
    bit.  ``block`` recomputes each layer's weight products in the
    backward pass; ``dots`` saves them and recomputes only the attention
    products (``bmm``)."""
    *_, tcfg, _ = _setup(arch)
    batch = _batch(tcfg.vocab_size, 0)
    runs = {}
    for remat in ("none", "block", "dots"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        params = _port_state(arch).params
        with _CountOps() as ops:
            loss, _, grads = _port_loss_and_grads(params, batch, cfg)
        runs[remat] = (loss, grads, ops.counts)
    loss0, grads0, ops0 = runs["none"]
    for remat in ("block", "dots"):
        loss, grads, _ = runs[remat]
        assert torch.equal(loss, loss0), remat
        for name in grads0:
            assert torch.equal(grads[name], grads0[name]), (remat, name)
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert runs["block"][2][mm] > ops0[mm]
    assert runs["dots"][2][mm] == ops0[mm]
    assert runs["dots"][2][bmm] > ops0[bmm]
    assert runs["block"][2][bmm] == runs["dots"][2][bmm]


def test_flash_route_under_grad_raises_on_cpu():
    """``use_pallas_attn=True`` with gradients raises (the kernel has no
    backward); without grad mode, or with parameters that need none, the
    same forward runs."""
    *_, tcfg, _ = _setup("gemma-2b")
    cfg = dataclasses.replace(tcfg, use_pallas_attn=True)
    state = _port_state("gemma-2b")
    batch = _batch(cfg.vocab_size, 0)
    with pytest.raises(NotImplementedError, match="no backward|forward only"):
        T.lm_loss(state.params, batch, cfg)
    with pytest.raises(NotImplementedError, match="use_pallas_attn"):
        make_train_step(cfg, OptConfig())(state, batch)
    with torch.no_grad():
        want = T.forward_train(state.params, batch, tcfg)
        got = T.forward_train(state.params, batch, cfg)
    assert (got - want).abs().max().item() < 1e-4
    state.params.requires_grad_(False)
    got = T.forward_train(state.params, batch, cfg)
    assert got.grad_fn is None and (got - want).abs().max().item() < 1e-4


def test_serve_path_builds_no_autograd_graph():
    *_, tcfg, _ = _setup("h2o-danube-3-4b")
    params = _port_state("h2o-danube-3-4b").params
    assert all(p.requires_grad for p in params.parameters())
    tokens = _batch(tcfg.vocab_size, 0)["tokens"]
    logits = make_prefill_step(dataclasses.replace(
        tcfg, use_pallas_attn=True))(params, {"tokens": tokens})
    assert logits.grad_fn is None and not logits.requires_grad
    logits, caches = T.forward_prefill(params, {"tokens": tokens}, tcfg,
                                       cache_len=S + 2)
    assert logits.grad_fn is None
    assert not any(t.requires_grad for c in caches for t in c.values())
    out, _ = T.decode_step(params, caches, tokens[:, :1], S, tcfg)
    assert out.grad_fn is None
    gen, _, _ = tserve.generate(params, tokens, tcfg, 3)
    assert gen.shape == (B, 3) and not gen.requires_grad


# ------------------------------------------- checkpoints (tests/test_train_loop)


CFG = ModelConfig(name="itiny", n_layers=2, d_model=64, n_heads=4,
                  n_kv_heads=2, d_ff=128, vocab_size=256)
OPT = OptConfig(peak_lr=5e-3, warmup_steps=5, total_steps=60)


def _pipe():
    return SyntheticTokens(DataConfig(vocab_size=CFG.vocab_size, seq_len=32,
                                      global_batch=8, seed=1))


def _fresh():
    return init_state(torch.Generator().manual_seed(0), CFG, device="cpu")


def _assert_states_equal(a, b):
    for x, y in ((a.params.state_dict(), b.params.state_dict()),
                 (a.opt.m, b.opt.m), (a.opt.v, b.opt.v)):
        assert list(x) == list(y) or sorted(x) == sorted(y)
        for k in x:
            assert torch.equal(x[k], y[k]), k
    assert torch.equal(a.opt.count, b.opt.count)
    assert torch.equal(a.step, b.step)


def test_loss_decreases():
    state, step, pipe = _fresh(), make_train_step(CFG, OPT), _pipe()
    losses = []
    for i in range(25):
        state, m = step(state, pipe.batch_at(i, device="cpu"))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.2, losses


def test_checkpoint_restart_bitwise_resume(tmp_path):
    """Kill at step 10, restore, continue -> identical to uninterrupted,
    every parameter, moment and counter ``torch.equal``."""
    pipe, step = _pipe(), make_train_step(CFG, OPT)

    def run(n, state=None, start=0):
        state = state or _fresh()
        for i in range(start, n):
            state, _ = step(state, pipe.batch_at(i, device="cpu"))
        return state

    ref = run(20)
    ck = Checkpointer(str(tmp_path), n_servers=4, cfg=CheckpointConfig(
        shard_size_mb=0.5,
        io=IOClientConfig(policy=PolicyConfig(name="trh", threshold=0.1),
                          stripe_size=MB // 4)))
    state = run(10)
    ck.save(10, state)
    del state
    template = _fresh()
    restored = load_state(template, ck.restore(target=template))
    assert int(restored.step) == 10
    _assert_states_equal(run(20, state=restored, start=10), ref)
    ck.close()


def test_training_through_straggler_and_failure(tmp_path):
    """Checkpoint every few steps, asynchronously, against a store with a
    straggler AND a failed server; training completes and the last save
    restores equal to the live state."""
    ck = Checkpointer(str(tmp_path), n_servers=5, cfg=CheckpointConfig(
        shard_size_mb=0.25, async_save=True,
        io=IOClientConfig(policy=PolicyConfig(name="ect", threshold=0.05),
                          stripe_size=MB // 4)))
    ck.store.set_write_delay(2, 0.01)   # straggler
    ck.store.fail_server(4)             # dead server
    state, step, pipe = _fresh(), make_train_step(CFG, OPT), _pipe()
    for i in range(12):
        state, _ = step(state, pipe.batch_at(i, device="cpu"))
        if (i + 1) % 4 == 0:
            ck.save(i + 1, state, block=False)
    ck.wait_until_finished()
    assert ck.latest_step() == 12
    template = _fresh()
    back = load_state(template, ck.restore(target=template))
    assert int(back.step) == 12
    _assert_states_equal(back, state)
    stats = ck.client.stats()
    assert stats["probe_messages"] == 0  # log-assisted: no probes
    assert stats["failed_writes"] >= 1
    ck.close()


def test_eval_ppl_matches_jax():
    jcfg, jstate, tcfg, _ = _setup("gemma-2b")
    batches = [_batch(tcfg.vocab_size, i) for i in range(2)]
    want = jax_eval_ppl(jstate.params, [_jax_batch(b) for b in batches],
                        jcfg)
    got = eval_ppl(_port_state("gemma-2b").params, batches, tcfg)
    assert np.isfinite(got) and _rel(got, want) < F32_LOSS_RTOL


# --------------------------------------------------------- the launcher


def _train_args(ckpt_dir, steps):
    return ttrain.parse_args([
        "--arch", "gemma-2b", "--reduced", "--steps", str(steps),
        "--batch", "2", "--seq-len", "16", "--ckpt-every", "3",
        "--ckpt-dir", str(ckpt_dir), "--inject-straggler", "2",
        "--log-every", "3", "--device", "cpu"])


def test_launch_train_on_cpu_resumes_as_uninterrupted(tmp_path, capsys):
    """`launch.train.train` with ``--device cpu``: 9 steps uninterrupted,
    and the same job killed after step 6's checkpoint (the later commits
    removed) and resumed: the same final metrics and final checkpoint."""
    full = ttrain.train(_train_args(tmp_path / "full", 9))
    out = capsys.readouterr().out
    assert "[train] step     9 loss=" in out and "resumed" not in out
    assert np.isfinite(full["loss"]) and full["ckpt_stats"]["writes"] > 0

    killed = tmp_path / "killed"
    ttrain.train(_train_args(killed, 9))
    man_dir = str(killed / "manifests")
    assert M.committed_steps(man_dir) == [3, 6, 9]
    M.remove_step(man_dir, 9)
    resumed = ttrain.train(_train_args(killed, 9))
    assert "[train] resumed from step 6" in capsys.readouterr().out
    assert {k: v for k, v in resumed.items() if k != "ckpt_stats"} == \
        {k: v for k, v in full.items() if k != "ckpt_stats"}
    a, b = (ttrain.make_checkpointer(_train_args(d, 9)).restore(
        device="cpu") for d in (tmp_path / "full", killed))
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_launch_train_refuses_a_mesh_and_enc_dec():
    """In a world of one rank the launcher runs unsharded whatever
    ``--mesh`` names (`build_mesh` gives None, as the JAX launcher's does
    at one device); it refuses a malformed mesh spec and, up front, an
    encoder-decoder (its token batches carry no frames); the steps take
    the encoder-decoder (`init_state`, `loss_fn_for`).  The meshes of
    gloo worlds are held in tests/test_torch_sharding.py."""
    for spec in ("none", "2x4", "2x2x2", "4"):
        assert ttrain.build_mesh(spec, "cpu") is None
    for spec in ("2y4", "2x2x2x2", ""):
        with pytest.raises(ValueError):
            ttrain.build_mesh(spec, "cpu")
    enc = interop.model_config_from_fields(
        dataclasses.asdict(jax_get_config("whisper-tiny", reduced=True)))
    assert loss_fn_for(enc) is E.lm_loss
    state = init_state(torch.Generator(), enc, device="cpu")
    assert isinstance(state.params, E.EncDec) and int(state.step) == 0
    with pytest.raises(NotImplementedError, match="carry no frames"):
        ttrain.train(ttrain.parse_args(["--arch", "whisper-tiny",
                                        "--reduced", "--device", "cpu"]))


def test_abstract_state_allocates_nothing():
    """Shapes and dtypes of `init_state`'s, every tensor on the meta
    device: the reduced config against a real state, then gemma-2b at
    full size (30 GB if it allocated)."""
    *_, tcfg, _ = _setup("gemma-2b")
    real = _port_state("gemma-2b")
    abst = abstract_state(tcfg)
    flat = lambda s: M.flatten_with_paths(s)
    assert [(p, t.shape, t.dtype) for p, t in flat(abst)] == \
        [(p, t.shape, t.dtype) for p, t in flat(real)]
    assert all(t.is_meta for _, t in flat(abst))
    full_cfg = get_config("gemma-2b")
    full = abstract_state(full_cfg)
    leaves = [t for _, t in flat(full)]
    assert all(t.is_meta for t in leaves)
    assert sum(t.numel() for t in leaves) == 3 * full_cfg.param_count() + 2


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    for fn in (init_state, interop.train_state_from_numpy,
               interop.lm_state_dict_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    args = ttrain.parse_args(["--arch", "gemma-2b", "--reduced"])
    assert args.device == "cuda" and args.mesh == "none"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.train(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(torch.Generator(), get_config("gemma-2b", True))
