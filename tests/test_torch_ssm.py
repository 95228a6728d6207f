"""Parity of the port's state-space and recurrent blocks with the JAX
package.

`models.ssm` alone (Mamba, mLSTM in its sequential and chunkwise forms,
sLSTM) and the reduced jamba-v0.1-52b (mamba + one attention layer + MoE)
and xlstm-1.3b (sLSTM + mLSTM) LMs: ``forward_train``, ``lm_loss`` and
its gradients, a train step, ``forward_prefill``'s caches field by
field, decode steps, serving, remat, interop and both CLIs.  The JAX
package's ``init_*`` / ``init_lm`` / ``init_state`` draw the parameters,
carried across as numpy arrays with `interop`; inputs are made with
numpy.  The reduced xlstm's ``ssm.chunk`` is 128, past the test's
S = 24, so its mLSTM layers take the sequential route; the
``xlstm-chunk8`` case replaces the chunk by 8, so ``forward_train``
takes the chunkwise route (the prefill's replay and decode stay
sequential, at t = 1).  The JAX side runs its blocked attention route
on jamba (as `test_torch_moe.py` does); the port's prefill runs its
flash route's plain version (CPU tensors).

Tolerances: float32 compute, within 1e-4 of the largest value compared
(``F32_TOL``; the two frameworks sum every product and reduction in
another order, a few ulps an operation through the recurrences); the
blocks' bfloat16 outputs within 0.1 (``BF16_TOL``: both round each
product to bf16, a step of 2**-8 relative).  Copies (the rows of the
mamba conv context kept from the carried one) are held bit-equal.
Losses to 1e-5 relative (``LOSS_RTOL``), gradients to 1e-4
(``GRAD_ATOL``) of the largest gradient.  The reduced xlstm is so
ill-conditioned that three checks say how they depart from these
(whole-model bf16 logits, gradients, train steps): each test's
docstring gives the measurement behind its rule."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.train import OptConfig as JOptConfig
from repro.train import init_state as jax_init_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.train import OptConfig, make_train_step
from torch_jax_release import release_compiled_programs  # noqa: F401

ARCHS = ["jamba-v0.1-52b", "xlstm-1.3b"]
# case -> (arch, ssm.chunk replaced by, or None)
CASES = {"jamba": ("jamba-v0.1-52b", None), "xlstm": ("xlstm-1.3b", None),
         "xlstm-chunk8": ("xlstm-1.3b", 8)}
B, SEQ, GEN = 2, 24, 4
F32_TOL, BF16_TOL = 1e-4, 0.1
LOSS_RTOL, GRAD_ATOL = 1e-5, 1e-4
STEP_OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _err(a, b) -> float:
    return float(np.max(np.abs(_f32(a) - _f32(b))))


def _close(got, want, tol=F32_TOL) -> bool:
    """Within ``tol`` of the largest value compared (at least 1)."""
    return _err(got, want) <= tol * max(1.0, float(np.abs(_f32(want)).max()))


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _port_cfg(jcfg):
    return interop.model_config_from_fields(dataclasses.asdict(jcfg))


def _jax_cfg(case, compute_dtype="float32", **fields):
    arch, chunk = CASES[case]
    cfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                              compute_dtype=compute_dtype, **fields)
    if chunk is not None:
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, chunk=chunk))
    if cfg.moe is not None and "moe" not in fields:
        # headroom: no pair dropped, so the decode path routes as the
        # train path does
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return cfg


@functools.lru_cache(maxsize=None)
def _lm(case, compute_dtype="float32"):
    """(JAX cfg, JAX params, port cfg, port params, prompts (B, SEQ))."""
    jcfg = _jax_cfg(case, compute_dtype)
    jparams = JT.init_lm(jax.random.key(0), jcfg)
    tcfg = _port_cfg(jcfg)
    tparams = interop.lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    tparams.requires_grad_(False)
    prompts = np.random.default_rng(1).integers(
        1, jcfg.vocab_size, (B, SEQ)).astype(np.int32)
    return jcfg, jparams, tcfg, tparams, prompts


def _module(init, jcfg, seed=0):
    """(JAX params, port params) of one `ssm` module at ``jcfg``."""
    jp = init(jax.random.key(seed), jcfg)
    return jp, {k: _t(v) for k, v in jp.items()}


def _x(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_match_jax_field_by_field(arch, reduced):
    port, ref = get_config(arch, reduced), jax_get_config(arch, reduced)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert port.cdtype == torch.bfloat16 and port.pdtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_tensors_at_full_size(arch):
    """The meta-device LM at full size: as many elements as the JAX
    package's ``init_lm`` tree (``eval_shape``), every leaf's shape equal.
    jamba's ``param_count`` is that count less the padded vocabulary's
    rows; xlstm's is the JAX package's bookkeeping, which counts the sLSTM
    recurrence as 4·d² (it is 4·d²/H, block-diagonal), its FFN at 4/3·d
    rounded up to 128 and the mLSTM gates as 3·inner, so it overcounts."""
    cfg = get_config(arch)
    lm = T.build_lm(None, cfg, torch.device("meta"))
    sd = lm.state_dict()
    n = sum(t.numel() for t in sd.values())
    jtree = jax.eval_shape(lambda k: JT.init_lm(k, jax_get_config(arch)),
                           jax.random.key(0))
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jtree))
    padded = (cfg.padded_vocab - cfg.vocab_size) * cfg.d_model * 2
    if arch == "jamba-v0.1-52b":
        assert n == cfg.param_count() + padded == 51_570_085_888
    else:
        assert n == 1_986_785_616 and cfg.param_count() == 2_062_788_608
    for li, block in enumerate(lm.blocks):
        g, pos = divmod(li, cfg.group_size)
        ref = jtree["groups"][f"pos_{pos}"]
        for name, sub in block.named_children():
            for k, p in sub.items():
                assert tuple(p.shape) == ref[name][k].shape[1:], (li, name, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_leaves_match_jax(arch):
    """The port's own ``init_lm`` (a torch generator) makes every leaf of
    the JAX package's tree, with its shape and dtype; its forward is
    finite."""
    jcfg = jax_get_config(arch, reduced=True)
    tcfg = get_config(arch, reduced=True)
    own = T.init_lm(torch.Generator().manual_seed(0), tcfg, device="cpu")
    carried = interop.lm_params_from_numpy(
        jax.tree.map(np.asarray, JT.init_lm(jax.random.key(0), jcfg)), tcfg,
        device="cpu")
    a, b = own.state_dict(), carried.state_dict()
    assert list(a) == list(b)
    assert all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
               for k in a)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        1, tcfg.vocab_size, (B, 8)))
    with torch.no_grad():
        logits = T.forward_train(own, {"tokens": tokens}, tcfg)
    assert logits.shape == (B, 8, tcfg.padded_vocab)
    assert bool(torch.isfinite(logits.float()).all())


# ------------------------------------------------------------------ mamba


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_apply_mamba_matches_jax(compute_dtype):
    jcfg = _jax_cfg("jamba", compute_dtype)
    tcfg = _port_cfg(jcfg)
    jp, tp = _module(JS.init_mamba, jcfg)
    x = _x((B, 12, jcfg.d_model), 3)
    want, wst = JS.apply_mamba(jp, jnp.asarray(x), jcfg)
    got, gst = S.apply_mamba(tp, torch.from_numpy(x), tcfg)
    tol = F32_TOL if compute_dtype == "float32" else BF16_TOL
    assert got.dtype == tcfg.cdtype
    assert _close(got, want, tol)
    assert _close(gst.ssm, wst.ssm, tol)
    assert gst.conv.dtype == tcfg.cdtype
    assert _close(gst.conv, wst.conv, tol)


def test_apply_mamba_continues_through_its_state():
    """A sequence split in two and continued through the state equals the
    whole, in the port and in the JAX package."""
    jcfg = _jax_cfg("jamba")
    tcfg = _port_cfg(jcfg)
    jp, tp = _module(JS.init_mamba, jcfg)
    x = torch.from_numpy(_x((B, 13, jcfg.d_model), 4))
    whole, wst = S.apply_mamba(tp, x, tcfg)
    y1, st = S.apply_mamba(tp, x[:, :8], tcfg)
    y2, st = S.apply_mamba(tp, x[:, 8:], tcfg, st)
    assert _close(torch.cat([y1, y2], dim=1), whole)
    assert _close(st.ssm, wst.ssm)
    assert torch.equal(st.conv, wst.conv)
    j1, jst = JS.apply_mamba(jp, jnp.asarray(x[:, :8].numpy()), jcfg)
    j2, jst = JS.apply_mamba(jp, jnp.asarray(x[:, 8:].numpy()), jcfg, jst)
    assert _close(y2, j2) and _close(st.ssm, jst.ssm)


@pytest.mark.parametrize("t", [1, 2])
def test_mamba_decode_carries_the_conv_context(t):
    """From a finite state, t = 1 and 2 steps (both below d_conv - 1 = 3):
    the new conv context is the last d_conv - 1 rows of (context, input):
    the rows kept from the carried context bit-equal, the step's own
    projected rows within tolerance of the JAX package's."""
    jcfg = _jax_cfg("jamba")
    tcfg = _port_cfg(jcfg)
    jp, tp = _module(JS.init_mamba, jcfg)
    inner, _ = S.mamba_dims(tcfg)
    conv = _x((B, jcfg.ssm.d_conv - 1, inner), 5)
    ssm = _x((B, inner, jcfg.ssm.d_state), 6)
    x = _x((B, t, jcfg.d_model), 7)
    want, wst = JS.apply_mamba(jp, jnp.asarray(x), jcfg, JS.MambaState(
        jnp.asarray(conv), jnp.asarray(ssm)))
    got, gst = S.apply_mamba(tp, torch.from_numpy(x), tcfg, S.MambaState(
        torch.from_numpy(conv), torch.from_numpy(ssm)))
    assert _close(got, want) and _close(gst.ssm, wst.ssm)
    assert _close(gst.conv, wst.conv)
    np.testing.assert_array_equal(gst.conv[:, :3 - t].numpy(), conv[:, t:])


# ------------------------------------------------------------------ mLSTM


def _mlstm_inputs(seed, t=24, h=4, hd=8):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, t, h, hd)).astype(np.float32)
               for _ in "qkv")
    li = rng.standard_normal((B, t, h)).astype(np.float32)
    lf = -np.log1p(np.exp(-rng.standard_normal((B, t, h)) - 3.0))
    state = (rng.standard_normal((B, h, hd, hd)).astype(np.float32),
             rng.standard_normal((B, h, hd)).astype(np.float32),
             rng.standard_normal((B, h)).astype(np.float32))
    return (q, k, v, li, lf.astype(np.float32)), state


def test_mlstm_sequential_matches_jax():
    xs, st = _mlstm_inputs(10)
    want, wst = JS.mlstm_sequential(*map(jnp.asarray, xs),
                                    JS.MLSTMState(*map(jnp.asarray, st)))
    got, gst = S.mlstm_sequential(*map(torch.from_numpy, xs),
                                  S.MLSTMState(*map(torch.from_numpy, st)))
    assert _close(got, want)
    assert all(_close(a, b) for a, b in zip(gst, wst))


@pytest.mark.parametrize("chunk", [4, 8])
def test_mlstm_chunkwise_matches_jax_and_its_sequential(chunk):
    xs, st = _mlstm_inputs(11)
    want, wst = JS.mlstm_chunkwise(*map(jnp.asarray, xs),
                                   JS.MLSTMState(*map(jnp.asarray, st)),
                                   chunk)
    txs = [torch.from_numpy(a) for a in xs]
    tst = S.MLSTMState(*map(torch.from_numpy, st))
    got, gst = S.mlstm_chunkwise(*txs, tst, chunk)
    seq, sst = S.mlstm_sequential(*txs, tst)
    assert _close(got, want) and _close(got, seq)
    assert all(_close(a, b) for a, b in zip(gst, wst))
    assert all(_close(a, b) for a, b in zip(gst, sst))
    with pytest.raises(ValueError, match="multiple"):
        S.mlstm_chunkwise(*(a[:, :SEQ - 1] for a in txs), tst, chunk)


def test_mlstm_chunkwise_gradients_match_jax():
    """Gradients of a weighted sum of the chunkwise outputs and final
    state against ``jax.grad``, through the masked max reductions."""
    xs, st = _mlstm_inputs(12, t=16)
    wy = _x((B, 16, 4, 8), 13)

    def jloss(*a):
        y, s = JS.mlstm_chunkwise(*a[:5], JS.MLSTMState(*a[5:]), 4)
        return jnp.sum(y * wy) + jnp.sum(s.c) + jnp.sum(s.n) + jnp.sum(s.m)

    want = jax.grad(jloss, argnums=tuple(range(8)))(
        *map(jnp.asarray, xs + st))
    args = [torch.from_numpy(a).requires_grad_() for a in xs + st]
    y, s = S.mlstm_chunkwise(*args[:5], S.MLSTMState(*args[5:]), 4)
    loss = (torch.sum(y * torch.from_numpy(wy)) + s.c.sum() + s.n.sum()
            + s.m.sum())
    got = torch.autograd.grad(loss, args)
    for g, w in zip(got, want):
        assert _err(g, w) < GRAD_ATOL * max(1.0, float(np.abs(w).max()))


@pytest.mark.parametrize("chunk,compute_dtype", [
    (None, "float32"), (4, "float32"), (4, "bfloat16")])
def test_apply_mlstm_matches_jax(chunk, compute_dtype):
    """The block body at T = 12: chunk None takes the sequential route
    (12 is no multiple of the config's 128), chunk 4 the chunkwise one."""
    jcfg = _jax_cfg("xlstm", compute_dtype)
    tcfg = _port_cfg(jcfg)
    jp, tp = _module(JS.init_mlstm, jcfg)
    x = _x((B, 12, jcfg.d_model), 8)
    want, wst = JS.apply_mlstm(jp, jnp.asarray(x), jcfg, chunk=chunk)
    got, gst = S.apply_mlstm(tp, torch.from_numpy(x), tcfg, chunk=chunk)
    tol = F32_TOL if compute_dtype == "float32" else BF16_TOL
    assert got.dtype == tcfg.cdtype
    assert _close(got, want, tol)
    assert all(_close(a, b, tol) for a, b in zip(gst, wst))


# ------------------------------------------------------------------ sLSTM


def test_apply_slstm_cell_matches_jax():
    jcfg = _jax_cfg("xlstm")
    tcfg = _port_cfg(jcfg)
    jp, tp = _module(JS.init_slstm, jcfg)
    d = jcfg.d_model
    st = tuple(_x((B, d), 20 + i) for i in range(4))
    st = (st[0], np.abs(st[1]) + 0.5, st[2], st[3])
    x = _x((B, 12, d), 9)
    want, wst = JS.apply_slstm_cell(jp, jnp.asarray(x), jcfg,
                                    JS.SLSTMState(*map(jnp.asarray, st)))
    got, gst = S.apply_slstm_cell(tp, torch.from_numpy(x), tcfg,
                                  S.SLSTMState(*map(torch.from_numpy, st)))
    assert _close(got, want)
    assert all(_close(a, b) for a, b in zip(gst, wst))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_apply_slstm_matches_jax(compute_dtype):
    jcfg = _jax_cfg("xlstm", compute_dtype)
    tcfg = _port_cfg(jcfg)
    jp, tp = _module(JS.init_slstm, jcfg)
    x = _x((B, 12, jcfg.d_model), 14)
    want, wst = JS.apply_slstm(jp, jnp.asarray(x), jcfg)
    got, gst = S.apply_slstm(tp, torch.from_numpy(x), tcfg)
    tol = F32_TOL if compute_dtype == "float32" else BF16_TOL
    assert got.dtype == tcfg.cdtype
    assert _close(got, want, tol)
    assert all(_close(a, b) for a, b in zip(gst, wst))


# --------------------------------------------------------------- the LMs


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_train_matches_jax(case):
    jcfg, jparams, tcfg, tparams, prompts = _lm(case)
    want, _ = JT.forward_train(jparams, {"tokens": jnp.asarray(prompts)},
                               jcfg)
    got = T.forward_train(tparams, {"tokens": torch.from_numpy(prompts)},
                          tcfg)
    assert got.shape == (B, SEQ, tcfg.padded_vocab)
    assert _close(got, want)


@pytest.mark.parametrize("arch", ["jamba", "xlstm"])
def test_forward_train_bf16_is_as_close_to_f32_as_jax(arch):
    """At bfloat16 compute the whole reduced LM is not held to BF16_TOL
    against the JAX package's bf16 logits: the blocks alone are (the
    module tests above), but through 8 recurrent layers each framework's
    bf16 rounding moves the logits by O(1) from the float32 ones (jamba
    1.39, xlstm 2.21 for the JAX package at this seed), and jamba's bf16
    router can flip an expert.  So the port's bf16 logits are held to the
    JAX package's float32 logits no further than 1.5 times the JAX
    package's own bf16 logits are, at the largest and on the mean."""
    jcfg, jparams, _, _, prompts = _lm(arch)
    f32 = _f32(JT.forward_train(jparams, {"tokens": jnp.asarray(prompts)},
                                jcfg)[0])
    jcfg, jparams, tcfg, tparams, prompts = _lm(arch, "bfloat16")
    want = _f32(JT.forward_train(jparams, {"tokens": jnp.asarray(prompts)},
                                 jcfg)[0])
    got = T.forward_train(tparams, {"tokens": torch.from_numpy(prompts)},
                          tcfg)
    assert got.dtype == torch.bfloat16
    got, ref = np.abs(_f32(got) - f32), np.abs(want - f32)
    assert got.max() <= 1.5 * ref.max() and got.mean() <= 1.5 * ref.mean()


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_matches_train(case):
    """Decode logits, one token at a time from empty caches, equal the
    teacher-forced forward, as tests/test_models.py checks the JAX
    package (xlstm-chunk8: the chunkwise train route against the
    sequential decode)."""
    _, _, tcfg, tparams, prompts = _lm(case)
    tokens = torch.from_numpy(prompts)
    ref = T.forward_train(tparams, {"tokens": tokens}, tcfg)
    caches = T.init_caches(tcfg, B, SEQ, device="cpu")
    outs = []
    for t in range(SEQ):
        lg, caches = T.decode_step(tparams, caches, tokens[:, t:t + 1], t,
                                   tcfg)
        outs.append(lg)
    assert _close(torch.cat(outs, dim=1), ref)


@functools.lru_cache(maxsize=None)
def _jax_prefill(case):
    jcfg, jparams, *_, prompts = _lm(case)
    return jax.jit(lambda p, t: JT.forward_prefill(
        p, {"tokens": t}, jcfg, cache_len=SEQ + GEN))(jparams,
                                                      jnp.asarray(prompts))


def _port_prefill(case):
    _, _, tcfg, tparams, prompts = _lm(case)
    return T.forward_prefill(
        tparams, {"tokens": torch.from_numpy(prompts)},
        dataclasses.replace(tcfg, use_pallas_attn=True),
        cache_len=SEQ + GEN)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_prefill_logits_and_caches_match_jax(case):
    """The prefill's logits and every layer's cache, field by field: the
    ring cache of jamba's attention layer (slot positions equal), each
    recurrent layer's state."""
    want_logits, want_caches = _jax_prefill(case)
    got_logits, got_caches = _port_prefill(case)
    tcfg = _lm(case)[2]
    assert _close(got_logits, want_logits)
    assert len(got_caches) == tcfg.n_layers
    for li, cache in enumerate(got_caches):
        g, pos = divmod(li, tcfg.group_size)
        ref = {k: np.asarray(v[g])
               for k, v in want_caches[f"pos_{pos}"].items()}
        assert set(cache) == set(ref), li
        for name, got in cache.items():
            assert tuple(got.shape) == ref[name].shape, (li, name)
            if name == "slot_pos":
                np.testing.assert_array_equal(got.numpy(), ref[name])
            else:
                assert _close(got, ref[name]), (li, name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_steps_match_jax(case):
    """4 decode steps after the prefill, both fed the JAX package's
    greedy tokens: the logits of each step and the caches after."""
    jcfg, jparams, tcfg, tparams, prompts = _lm(case)
    logits, jcaches = _jax_prefill(case)
    _, caches = _port_prefill(case)
    dec = jax.jit(lambda p, c, t, i: JT.decode_step(p, c, t, i, jcfg))
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    for i in range(GEN):
        want, jcaches = dec(jparams, jcaches, tok, SEQ + i)
        got, caches = T.decode_step(tparams, caches, _t(tok).long(),
                                    SEQ + i, tcfg)
        assert _close(got, want), i
        tok = jnp.argmax(want[:, -1:], axis=-1).astype(jnp.int32)
    for li, cache in enumerate(caches):
        g, pos = divmod(li, tcfg.group_size)
        for name, got in cache.items():
            assert _close(got, jcaches[f"pos_{pos}"][name][g]), (li, name)


@pytest.mark.parametrize("arch", ["jamba", "xlstm"])
def test_serve_tokens_match_jax(arch):
    """`serve.generate` against the JAX package's serving composition:
    greedy tokens exactly."""
    jcfg, jparams, tcfg, tparams, prompts = _lm(arch)
    logits, caches = _jax_prefill(arch)
    dec = jax.jit(lambda p, c, t, i: JT.decode_step(p, c, t, i, jcfg))
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    want = [tok]
    for i in range(GEN - 1):
        logits, caches = dec(jparams, caches, tok, SEQ + i)
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        want.append(tok)
    tokens, _, _ = tserve.generate(tparams, torch.from_numpy(prompts), tcfg,
                                   GEN)
    np.testing.assert_array_equal(
        tokens.numpy(), np.asarray(jnp.concatenate(want, axis=1)))


# ------------------------------------------------------------------- train


@functools.lru_cache(maxsize=None)
def _train_setup(case):
    jcfg = _jax_cfg(case)
    jstate = jax_init_state(jax.random.key(0), jcfg)
    return jcfg, jstate, _port_cfg(jcfg), jax.tree.map(np.asarray, jstate)


def _port_state(case):
    *_, tcfg, np_state = _train_setup(case)
    return interop.train_state_from_numpy(np_state, tcfg, device="cpu")


def _batch(vocab, step):
    return SyntheticTokens(DataConfig(vocab_size=vocab, seq_len=SEQ,
                                      global_batch=B, seed=1)
                           ).batch_at(step, device="cpu")


def _jax_batch(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lm_loss_and_gradients_match_jax(case):
    """``lm_loss`` and every parameter's gradient against
    ``jax.value_and_grad`` in float32 compute, each gradient within
    GRAD_ATOL of the largest gradient value of the model (at least 1), or
    within twice what a 1e-7 relative perturbation of the parameters
    moves the port's own gradient, where that is larger.  xlstm's
    gradients reach 96 (the embedding) and its recurrences are that
    sensitive: the perturbation moves the embedding's gradient by about
    0.017, more than it differs from the JAX package's (about 0.012)."""
    jcfg, jstate, tcfg, _ = _train_setup(case)
    batch = _batch(tcfg.vocab_size, 0)
    (wloss, wmetrics), wgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(p, b, jcfg), has_aux=True))(
            jstate.params, _jax_batch(batch))
    params = _port_state(case).params
    names, leaves = zip(*params.named_parameters())
    loss, metrics = T.lm_loss(params, batch, tcfg)
    assert _rel(loss.detach(), wloss) < LOSS_RTOL
    for k in ("nll", "lb_loss", "z_loss"):
        assert abs(float(metrics[k].detach()) - float(wmetrics[k])) <= \
            LOSS_RTOL * max(abs(float(wmetrics[k])), 1e-30), k
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    want = interop.lm_state_dict_from_numpy(
        jax.tree.map(np.asarray, wgrads), tcfg, device="cpu")
    assert list(grads) == list(want)
    moved = _port_state(case).params
    with torch.no_grad():
        gen = torch.Generator().manual_seed(0)
        for p in moved.parameters():
            p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen))
    loss, _ = T.lm_loss(moved, batch, tcfg)
    noise = dict(zip(names, torch.autograd.grad(loss, list(
        moved.parameters()))))
    tol = GRAD_ATOL * max(1.0, max(float(w.abs().max())
                                   for w in want.values()))
    for name, g in grads.items():
        assert g.shape == want[name].shape
        moved_by = float((noise[name] - g).abs().max())
        assert float((g - want[name]).abs().max()) <= max(
            tol, 2 * moved_by), name
    kind = "mamba" if tcfg.moe is not None else "cell"
    assert any(f".{kind}." in n and float(g.abs().max()) > 0
               for n, g in grads.items())


@pytest.mark.parametrize("arch,steps,gnorm_rtol", [
    ("jamba", 3, LOSS_RTOL), ("xlstm", 1, 1e-4)])
def test_train_step_matches_jax(arch, steps, gnorm_rtol):
    """Train steps against the JAX package's: the loss and NLL to
    LOSS_RTOL, the grad norm to ``gnorm_rtol``, the parameters within
    2·sum(lr) (Adam moves a parameter at most lr a step).  xlstm's grad
    norm is dominated by its embedding's gradient (up to 96), which a
    1e-7 relative perturbation of the parameters moves the norm by 4e-5
    relative (the port against itself), so it is held to 1e-4.  xlstm
    takes one step: six of its first sLSTM's input-gate
    biases have gradients that are zero up to rounding (the stabilizer
    cancels them; the JAX package gets 3e-8, the port 0), which Adam's
    first step turns into updates of about lr in one framework and none
    in the other; the reduced xlstm then moves its gradient norm by 0.66
    relative two steps after a 1e-7 relative perturbation of its
    parameters, in the port against itself."""
    jcfg, jstate, tcfg, _ = _train_setup(arch)
    jstep = jax.jit(jax_make_train_step(jcfg, JOptConfig(**STEP_OPT)))
    step = make_train_step(tcfg, OptConfig(**STEP_OPT))
    state = _port_state(arch)
    lr_sum = 0.0
    for i in range(steps):
        batch = _batch(tcfg.vocab_size, i)
        jstate, jm = jstep(jstate, _jax_batch(batch))
        state, m = step(state, batch)
        for k in ("loss", "nll"):
            assert _rel(m[k], jm[k]) < LOSS_RTOL, (i, k)
        assert _rel(m["grad_norm"], jm["grad_norm"]) < gnorm_rtol, i
        lr_sum += float(jm["lr"])
    want = interop.lm_state_dict_from_numpy(
        jax.tree.map(np.asarray, jstate.params), tcfg, device="cpu")
    got = state.params.state_dict()
    for name in want:
        assert float((got[name] - want[name]).abs().max()) <= 2 * lr_sum, \
            name


@pytest.mark.parametrize("arch", ["jamba", "xlstm-chunk8"])
def test_remat_is_bit_equal(arch):
    """``remat`` none / block / dots return the same loss and gradients,
    bit for bit, through the recurrent layers' loops."""
    *_, tcfg, _ = _train_setup(arch)
    batch = _batch(tcfg.vocab_size, 0)
    runs = []
    for remat in ("none", "block", "dots"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        params = _port_state(arch).params
        names, leaves = zip(*params.named_parameters())
        loss, _ = T.lm_loss(params, batch, cfg)
        runs.append((loss, torch.autograd.grad(loss, leaves)))
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, runs[0][1]))


def test_interop_carries_ssm_leaves():
    """Each block kind's leaves (stacked over groups) land on the port's
    names, the moments too; a tree whose layer holds another kind's
    leaves is refused."""
    for case, layer, name, leaves in (
            ("jamba", 3, "mamba", ("in_proj", "conv_w", "A_log", "D")),
            ("xlstm", 1, "cell", ("wq", "w_f", "ln_scale")),
            ("xlstm", 0, "cell", ("w", "b", "r", "ff_out"))):
        *_, tcfg, np_state = _train_setup(case)
        state = interop.train_state_from_numpy(np_state, tcfg, device="cpu")
        g, pos = divmod(layer, tcfg.group_size)
        block = getattr(state.params.blocks[layer], name)
        for leaf in leaves:
            ref = np_state.params["groups"][f"pos_{pos}"][name][leaf][g]
            np.testing.assert_array_equal(block[leaf].detach().numpy(), ref)
            np.testing.assert_array_equal(
                state.opt.m[f"blocks.{layer}.{name}.{leaf}"].numpy(),
                np_state.opt.m["groups"][f"pos_{pos}"][name][leaf][g])
    jamba = jax.tree.map(np.asarray, _lm("jamba")[1])
    with pytest.raises(ValueError, match="cell"):
        interop.lm_params_from_numpy(jamba, _lm("xlstm")[2], device="cpu")


# ------------------------------------------------------------- the CLIs


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch, capsys):
    args = tserve.parse_args(["--arch", arch, "--reduced", "--batch", "2",
                              "--prompt-len", "16", "--gen", "3",
                              "--device", "cpu"])
    out = tserve.serve(args)
    assert out["tokens"].shape == (2, 3) and out["tok_per_s"] > 0
    assert ((out["tokens"] >= 0)
            & (out["tokens"] < get_config(arch, True).padded_vocab)).all()
    assert f"[serve] arch={arch}-reduced" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_on_cpu(arch, capsys):
    out = ttrain.train(ttrain.parse_args([
        "--arch", arch, "--reduced", "--steps", "3", "--batch", "2",
        "--seq-len", "16", "--log-every", "3", "--device", "cpu"]))
    assert "[train] step     3 loss=" in capsys.readouterr().out
    assert np.isfinite(out["loss"])
