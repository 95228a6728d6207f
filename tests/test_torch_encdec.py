"""Parity of the port's encoder-decoder (whisper-tiny) with the JAX
package.

`models.encdec` and the cross attention of `models.attention` on the
reduced whisper-tiny (2 + 2 layers, d_model 64, 4 heads, 24 frames):
the sinusoidal positions, ``encode``, ``forward_train`` on both
attention routes (the JAX side's flash kernel in Pallas interpret, as
its own tests run it on the CPU; the port's plain flash version on CPU
tensors), ``lm_loss`` and its gradients, ``init_caches``, decode steps,
the prefill, the served tokens, a train step, remat, interop, the
meta-device state and both launchers.  The JAX package's ``init_encdec``
/ ``init_state`` draw the parameters, carried across as numpy arrays
with `interop`; frames and tokens are made with numpy from a seed.

Tolerances: the sinusoid's angles bit-equal (the port rounds them as the
JAX package does) and its sin/cos within an ulp of 1 (``ULP``: XLA's
float32 sin/cos against the correctly rounded value).  Float32 compute
holds activations and logits within 1e-4 of the largest value compared
(``F32_TOL``; the frameworks sum every product and softmax in another
order, a few ulps an operation through four layers) and greedy tokens
exactly; losses to 1e-5 relative (``LOSS_RTOL``), gradients to 1e-4
(``GRAD_ATOL``) of the largest gradient; a train step's grad norm to
``LOSS_RTOL`` and its parameters within 2·lr (Adam moves a parameter at
most lr a step).  bfloat16 compute: the module outputs within 0.1
(``BF16_TOL``: both round each product to bf16, a step of 2**-8
relative), and the whole model's logits no further from the JAX
package's float32 ones than 1.5 times the JAX package's own bf16 logits
are."""

import argparse
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import train as jax_train
from repro.models import attention as JA
from repro.models import encdec as JE
from repro.train import OptConfig as JOptConfig
from repro.train import init_state as jax_init_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as TA
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.train import (OptConfig, abstract_state, init_state,
                               loss_fn_for, make_decode_step,
                               make_prefill_step, make_train_step)
from torch_jax_release import release_compiled_programs  # noqa: F401

ARCH = "whisper-tiny"
B, SEQ, GEN = 2, 24, 8
F32_TOL, BF16_TOL = 1e-4, 0.1
LOSS_RTOL, GRAD_ATOL = 1e-5, 1e-4
ULP = 2 ** -23
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


def _jax_cfg(compute_dtype="float32", **fields):
    return dataclasses.replace(jax_get_config(ARCH, reduced=True),
                               compute_dtype=compute_dtype, **fields)


def _port_cfg(jcfg):
    return interop.model_config_from_fields(dataclasses.asdict(jcfg))


def _inputs(cfg, seed=1):
    """(frames (B, enc_seq, d) float32, tokens (B, SEQ) int32) numpy."""
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)
                                 ).astype(np.float32)
    tokens = rng.integers(1, cfg.vocab_size, (B, SEQ)).astype(np.int32)
    return frames, tokens


@functools.lru_cache(maxsize=None)
def _model(compute_dtype="float32"):
    """(JAX cfg, JAX params, port cfg, port params, frames, tokens)."""
    jcfg = _jax_cfg(compute_dtype)
    jparams = JE.init_encdec(jax.random.key(0), jcfg)
    tcfg = _port_cfg(jcfg)
    tparams = interop.encdec_params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    tparams.requires_grad_(False)
    return (jcfg, jparams, tcfg, tparams) + _inputs(jcfg)


def _jbatch(frames, tokens):
    return {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)}


def _tbatch(frames, tokens):
    return {"frames": torch.from_numpy(frames),
            "tokens": torch.from_numpy(tokens)}


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_jax_field_by_field(reduced):
    port, ref = get_config(ARCH, reduced), jax_get_config(ARCH, reduced)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert port.enc_dec and port.cdtype == torch.bfloat16


def test_full_size_tree_matches_jax_on_meta():
    """The meta-device `EncDec` at full size: every leaf of the JAX
    package's ``init_encdec`` tree (``eval_shape``) with its shape, as
    many elements (36,496,896: ``param_count`` is the JAX package's
    bookkeeping, which counts the cross attention's biases and the
    padded vocabulary another way), and nothing allocated."""
    cfg = get_config(ARCH)
    model = E.build_encdec(None, cfg, torch.device("meta"))
    jtree = jax.eval_shape(lambda k: JE.init_encdec(k, jax_get_config(ARCH)),
                           jax.random.key(0))
    sd = model.state_dict()
    assert all(t.is_meta for t in sd.values())
    n = sum(t.numel() for t in sd.values())
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jtree))
    assert n == 36_496_896
    for stack, groups in (("enc_blocks", "enc_groups"), ("blocks", "groups")):
        for li, block in enumerate(getattr(model, stack)):
            ref = jtree[groups]["pos_0"]
            for name, sub in block.named_children():
                for k, p in sub.items():
                    assert tuple(p.shape) == ref[name][k].shape[1:], \
                        (stack, li, name, k)


def test_init_encdec_leaves_match_jax():
    """The port's own ``init_encdec`` (a torch generator) makes every
    leaf of the carried JAX tree, in the same ``state_dict`` order, shape
    and dtype; the cross attention holds no q/k/v bias; the forward is
    finite."""
    tcfg = get_config(ARCH, reduced=True)
    own = E.init_encdec(torch.Generator().manual_seed(0), tcfg, "cpu")
    carried = _model()[3]
    a, b = own.state_dict(), carried.state_dict()
    assert list(a) == list(b)
    assert all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
               for k in a)
    assert set(own.blocks[0].cross) == {"wq", "wk", "wv", "wo"}
    assert {"bq", "bk", "bv"} <= set(own.blocks[0].attn)
    frames, tokens = _inputs(tcfg)
    with torch.no_grad():
        logits = E.forward_train(own, _tbatch(frames, tokens), tcfg)
    assert logits.shape == (B, SEQ, tcfg.padded_vocab)
    assert bool(torch.isfinite(logits.float()).all())


# ------------------------------------------------------------- positions


@pytest.mark.parametrize("seq,d", [(1500, 384), (24, 64), (448, 384)])
def test_sinusoid_rounds_its_angles_as_jax(seq, d):
    """The angles ``pos / 10000**(2*dim/d)`` bit-equal to the JAX
    package's float32 ones (PyTorch's float32 power is an ulp off at
    d = 384, so the port rounds the power from float64), and the table
    within an ulp of 1 of ``sinusoid`` (XLA's sin/cos are an ulp off the
    correctly rounded values the port takes)."""
    pos = jnp.arange(seq, dtype=jnp.float32)[:, None]
    dim = jnp.arange(d // 2, dtype=jnp.float32)[None, :]
    want_ang = np.asarray(pos / jnp.power(10000.0, 2 * dim / d))
    got_ang = E._angles(torch.arange(seq, dtype=torch.float32), d)
    np.testing.assert_array_equal(got_ang.numpy(), want_ang)
    got = E.sinusoid(seq, d, torch.float32)
    want = JE.sinusoid(seq, d, jnp.float32)
    assert got.shape == (seq, d)
    assert _err(got, want) <= ULP


def test_pos_embed_at_matches_jax():
    """The decode step's position at 0, 7 and 1499: the angle bit-equal,
    the embedding within an ulp of 1 and equal to `sinusoid`'s row."""
    tcfg = _model()[2]
    jcfg = _jax_cfg()
    table = E.sinusoid(1500, tcfg.d_model, torch.float32)
    for pos in (0, 7, 1499):
        got = E._pos_embed_at(pos, tcfg)
        want = JE._pos_embed_at(jnp.asarray(pos), jcfg)
        assert got.shape == want.shape == (1, 1, tcfg.d_model)
        assert _err(got, want) <= ULP
        assert torch.equal(got[0, 0], table[pos])


# -------------------------------------------------------- cross attention


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cross_attend_matches_jax(compute_dtype):
    """`precompute_cross_kv` then `cross_attend` (no mask) against the
    JAX package's, on the JAX package's cross-attention parameters."""
    jcfg = _jax_cfg(compute_dtype)
    tcfg = _port_cfg(jcfg)
    jp = JA.init_attention(jax.random.key(3), jcfg, cross=True)
    assert set(jp) == {"wq", "wk", "wv", "wo"}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 5, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, jcfg.enc_seq, jcfg.d_model)
                              ).astype(np.float32)
    cdt = jcfg.cdtype
    jkv = JA.precompute_cross_kv(jp, jnp.asarray(enc), jcfg)
    want = JA.cross_attend(jp, jnp.asarray(x, cdt), jkv, jcfg)
    tkv = TA.precompute_cross_kv(tp, torch.from_numpy(enc), tcfg)
    got = TA.cross_attend(tp, torch.from_numpy(x).to(tcfg.cdtype), tkv, tcfg)
    tol = F32_TOL if compute_dtype == "float32" else BF16_TOL
    assert got.dtype == tcfg.cdtype
    for g, w in zip(tkv + (got,), jkv + (want,)):
        assert g.shape == w.shape and _close(g, w, tol)


# ---------------------------------------------------------------- encoder


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_encode_matches_jax(compute_dtype):
    jcfg, jparams, tcfg, tparams, frames, _ = _model(compute_dtype)
    want = JE.encode(jparams, jnp.asarray(frames), jcfg)
    got = E.encode(tparams, torch.from_numpy(frames), tcfg)
    assert got.shape == (B, tcfg.enc_seq, tcfg.d_model)
    assert got.dtype == tcfg.cdtype
    assert _close(got, want, F32_TOL if compute_dtype == "float32"
                  else BF16_TOL)


# ---------------------------------------------------------------- forward


@pytest.mark.parametrize("flash", [False, True])
def test_forward_train_matches_jax(flash):
    """The prefill step (`forward_train`) with both decoder attention
    routes: the JAX flash kernel in Pallas interpret against the port's
    plain flash version."""
    jcfg, jparams, tcfg, tparams, frames, tokens = _model()
    jcfg = dataclasses.replace(jcfg, use_pallas_attn=flash)
    tcfg = dataclasses.replace(tcfg, use_pallas_attn=flash)
    want, _ = JE.forward_train(jparams, _jbatch(frames, tokens), jcfg)
    got = make_prefill_step(tcfg)(tparams, _tbatch(frames, tokens))
    assert got.shape == (B, SEQ, tcfg.padded_vocab)
    assert _close(got, want)


def test_forward_train_bf16_is_as_close_to_f32_as_jax():
    """At bfloat16 compute the port's logits are no further from the JAX
    package's float32 logits than 1.5 times the JAX package's own bf16
    logits are, at the largest and on the mean."""
    jcfg, jparams, _, _, frames, tokens = _model()
    f32 = _f32(JE.forward_train(jparams, _jbatch(frames, tokens), jcfg)[0])
    jcfg, jparams, tcfg, tparams, frames, tokens = _model("bfloat16")
    want = _f32(JE.forward_train(jparams, _jbatch(frames, tokens), jcfg)[0])
    got = E.forward_train(tparams, _tbatch(frames, tokens), tcfg)
    assert got.dtype == torch.bfloat16
    got, ref = np.abs(_f32(got) - f32), np.abs(want - f32)
    assert got.max() <= 1.5 * ref.max() and got.mean() <= 1.5 * ref.mean()


# ------------------------------------------------------------------ decode


@functools.lru_cache(maxsize=None)
def _jax_caches():
    """The JAX package's encoder output and ``init_caches``."""
    jcfg, jparams, *_, frames, _ = _model()
    enc_out = JE.encode(jparams, jnp.asarray(frames), jcfg)
    return enc_out, JE.init_caches(jparams, enc_out, jcfg, B, SEQ + GEN)


def test_init_caches_match_jax():
    """Each decoder layer's cross keys and values of the encoder output,
    and empty ring caches of SEQ + GEN slots."""
    _, _, tcfg, tparams, frames, _ = _model()
    enc_out, want = _jax_caches()
    got = E.init_caches(tparams, E.encode(tparams, torch.from_numpy(frames),
                                          tcfg), tcfg, B, SEQ + GEN)
    assert len(got["self"]) == len(got["cross"]) == tcfg.n_layers
    for li in range(tcfg.n_layers):
        for name in ("ck", "cv"):
            ref = want["cross"][name][li]
            assert got["cross"][li][name].shape == ref.shape
            assert _close(got["cross"][li][name], ref), (li, name)
        for name in ("k", "v", "slot_pos"):
            np.testing.assert_array_equal(
                got["self"][li][name].numpy(),
                np.asarray(want["self"][name][li]))


def test_decode_matches_train():
    """Decode logits, one token at a time from empty caches, equal the
    teacher-forced forward (the port alone, as tests/test_models.py
    checks the JAX package)."""
    _, _, tcfg, tparams, frames, tokens = _model()
    batch = _tbatch(frames, tokens)
    ref = E.forward_train(tparams, batch, tcfg)
    enc_out = E.encode(tparams, batch["frames"], tcfg)
    caches = E.init_caches(tparams, enc_out, tcfg, B, SEQ)
    outs = []
    for t in range(SEQ):
        lg, caches = E.decode_step(tparams, caches,
                                   batch["tokens"][:, t:t + 1], t, tcfg)
        outs.append(lg)
    assert _close(torch.cat(outs, dim=1), ref)


@functools.lru_cache(maxsize=None)
def _jax_replay():
    """The JAX serve's prefill: the prompt replayed through its decode
    step from ``init_caches``; (last logits, caches)."""
    jcfg, jparams, *_, tokens = _model()
    _, caches = _jax_caches()
    dec = jax.jit(lambda p, c, t, i: JE.decode_step(p, c, t, i, jcfg))
    logits = None
    for t in range(SEQ):
        logits, caches = dec(jparams, caches, jnp.asarray(tokens[:, t:t + 1]),
                             t)
    return logits, caches


def _port_prefill():
    _, _, tcfg, tparams, frames, tokens = _model()
    return E.forward_prefill(tparams, _tbatch(frames, tokens),
                             dataclasses.replace(tcfg, use_pallas_attn=True),
                             cache_len=SEQ + GEN)


def test_forward_prefill_logits_and_caches_match_jax():
    """The prefill's logits against the JAX forward (its last row against
    the JAX serve's replay too) and every layer's ring cache and cross
    keys against the replay's: slot positions equal."""
    jcfg, jparams, tcfg, _, frames, tokens = _model()
    want, _ = JE.forward_train(jparams, _jbatch(frames, tokens), jcfg)
    last, jcaches = _jax_replay()
    logits, caches = _port_prefill()
    assert _close(logits, want) and _close(logits[:, -1:], last)
    for li in range(tcfg.n_layers):
        for name, got in caches["self"][li].items():
            ref = np.asarray(jcaches["self"][name][li])
            if name == "slot_pos":
                np.testing.assert_array_equal(got.numpy(), ref)
            else:
                assert _close(got, ref), (li, name)
        for name, got in caches["cross"][li].items():
            assert _close(got, jcaches["cross"][name][li]), (li, name)


def test_decode_steps_match_jax():
    """8 decode steps after the prefill, both fed the JAX package's
    greedy tokens: the logits of each step and the ring caches after."""
    jcfg, jparams, tcfg, tparams, *_ = _model()
    logits, jcaches = _jax_replay()
    _, caches = _port_prefill()
    dec = jax.jit(lambda p, c, t, i: JE.decode_step(p, c, t, i, jcfg))
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    for i in range(GEN):
        want, jcaches = dec(jparams, jcaches, tok, SEQ + i)
        got, caches = make_decode_step(tcfg)(
            tparams, caches, torch.from_numpy(np.array(tok)).long(),
            SEQ + i)
        assert _close(got, want), i
        tok = jnp.argmax(want[:, -1:], axis=-1).astype(jnp.int32)
    for li in range(tcfg.n_layers):
        for name in ("k", "v"):
            assert _close(caches["self"][li][name],
                          jcaches["self"][name][li]), (li, name)


def test_serve_tokens_match_jax():
    """`serve.generate` against the JAX serve's composition (encode,
    ``init_caches``, the prompt replayed, greedy decode) in float32:
    greedy tokens exactly."""
    jcfg, jparams, tcfg, tparams, frames, tokens = _model()
    logits, caches = _jax_replay()
    dec = jax.jit(lambda p, c, t, i: JE.decode_step(p, c, t, i, jcfg))
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    want = [tok]
    for i in range(GEN - 1):
        logits, caches = dec(jparams, caches, tok, SEQ + i)
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        want.append(tok)
    got, _, _ = tserve.generate(tparams, torch.from_numpy(tokens), tcfg, GEN,
                                torch.from_numpy(frames))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.concatenate(want, axis=1)))
    with pytest.raises(ValueError, match="frames"):
        tserve.generate(tparams, torch.from_numpy(tokens), tcfg, GEN)


# ------------------------------------------------------------------- train


@functools.lru_cache(maxsize=None)
def _train_setup():
    jcfg = _jax_cfg()
    jstate = jax_init_state(jax.random.key(0), jcfg)
    return jcfg, jstate, _port_cfg(jcfg), jax.tree.map(np.asarray, jstate)


def _port_state():
    *_, tcfg, np_state = _train_setup()
    return interop.train_state_from_numpy(np_state, tcfg, device="cpu")


def _batch(cfg, step):
    """{frames, tokens, targets} numpy of one train step."""
    frames, tokens = _inputs(cfg, seed=10 + step)
    targets = np.roll(tokens, -1, axis=1)
    return {"frames": frames, "tokens": tokens, "targets": targets}


def _as(batch, framework):
    if framework == "jax":
        return {k: jnp.asarray(v) for k, v in batch.items()}
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_lm_loss_and_gradients_match_jax():
    """``lm_loss`` and every parameter's gradient against
    ``jax.value_and_grad`` in float32 compute: the loss to LOSS_RTOL,
    each gradient within GRAD_ATOL of the largest gradient of the model
    (at least 1), through both stacks and the cross attention."""
    jcfg, jstate, tcfg, _ = _train_setup()
    batch = _batch(tcfg, 0)
    (wloss, wmetrics), wgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JE.lm_loss(p, b, jcfg), has_aux=True))(
            jstate.params, _as(batch, "jax"))
    params = _port_state().params
    names, leaves = zip(*params.named_parameters())
    loss, metrics = loss_fn_for(tcfg)(params, _as(batch, "torch"), tcfg)
    assert _rel(loss.detach(), wloss) < LOSS_RTOL
    assert _rel(metrics["nll"].detach(), wmetrics["nll"]) < LOSS_RTOL
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    want = interop.lm_state_dict_from_numpy(
        jax.tree.map(np.asarray, wgrads), tcfg, device="cpu")
    assert list(grads) == list(want)
    tol = GRAD_ATOL * max(1.0, max(float(w.abs().max())
                                   for w in want.values()))
    for name, g in grads.items():
        assert g.shape == want[name].shape
        assert float((g - want[name]).abs().max()) <= tol, name
    for part in ("enc_blocks.0.attn.wq", "blocks.1.cross.wk",
                 "blocks.0.attn.bv"):
        assert float(grads[part].abs().max()) > 0, part


def test_train_step_matches_jax():
    """Two `make_train_step` steps against the JAX package's: loss, NLL
    and grad norm to LOSS_RTOL, the parameters within 2·sum(lr), the
    step counter."""
    jcfg, jstate, tcfg, _ = _train_setup()
    jstep = jax.jit(jax_make_train_step(jcfg, JOptConfig(**STEP_OPT)))
    step = make_train_step(tcfg, OptConfig(**STEP_OPT))
    state = _port_state()
    lr_sum = 0.0
    for i in range(2):
        batch = _batch(tcfg, i)
        jstate, jm = jstep(jstate, _as(batch, "jax"))
        state, m = step(state, _as(batch, "torch"))
        for k in ("loss", "nll", "grad_norm"):
            assert _rel(m[k], jm[k]) < LOSS_RTOL, (i, k)
        lr_sum += float(jm["lr"])
    assert int(state.step) == 2
    want = interop.lm_state_dict_from_numpy(
        jax.tree.map(np.asarray, jstate.params), tcfg, device="cpu")
    got = state.params.state_dict()
    for name in want:
        assert float((got[name] - want[name]).abs().max()) <= 2 * lr_sum, \
            name


def test_remat_is_bit_equal():
    """``remat`` none / block / dots return the same loss and gradients,
    bit for bit."""
    *_, tcfg, _ = _train_setup()
    batch = _as(_batch(tcfg, 0), "torch")
    runs = []
    for remat in ("none", "block", "dots"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        params = _port_state().params
        loss, _ = E.lm_loss(params, batch, cfg)
        runs.append((loss, torch.autograd.grad(loss,
                                               list(params.parameters()))))
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, runs[0][1]))


def test_states_and_interop():
    """`init_state` and `abstract_state` take whisper (the meta state at
    full size allocates nothing: three copies of the parameters and two
    counters), and `train_state_from_numpy` lands each stack's leaves and
    moments on the port's names; a decoder-LM tree is refused."""
    *_, tcfg, np_state = _train_setup()
    own = init_state(torch.Generator().manual_seed(0), tcfg, device="cpu")
    state = _port_state()
    assert list(own.params.state_dict()) == list(state.params.state_dict())
    full = abstract_state(get_config(ARCH))
    leaves = list(full.params.parameters()) + list(full.opt.m.values()) \
        + list(full.opt.v.values())
    assert all(t.is_meta for t in leaves)
    assert sum(t.numel() for t in leaves) == 3 * 36_496_896
    for stack, groups, li, name, leaf in (
            ("enc_blocks", "enc_groups", 1, "attn", "bq"),
            ("blocks", "groups", 1, "cross", "wv"),
            ("blocks", "groups", 0, "mlp", "w_out")):
        ref = np_state.params[groups]["pos_0"][name][leaf][li]
        got = getattr(getattr(state.params, stack)[li], name)[leaf]
        np.testing.assert_array_equal(got.detach().numpy(), ref)
        np.testing.assert_array_equal(
            state.opt.m[f"{stack}.{li}.{name}.{leaf}"].numpy(),
            np_state.opt.m[groups]["pos_0"][name][leaf][li])
    bad = dict(np_state.params, groups={"pos_0": np_state.params[
        "enc_groups"]["pos_0"]})
    with pytest.raises(ValueError, match="cross"):
        interop.encdec_params_from_numpy(bad, tcfg, device="cpu")


# ------------------------------------------------------------- refusals


def test_launchers_on_cpu(capsys):
    """The serving CLI runs whisper on the CPU; the training launcher
    refuses it up front, saying why: its token batches carry no frames,
    and the JAX package's launcher fails on exactly that."""
    out = tserve.serve(tserve.parse_args([
        "--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "16",
        "--gen", "3", "--device", "cpu"]))
    assert out["tokens"].shape == (2, 3) and out["tok_per_s"] > 0
    assert "[serve] arch=whisper-tiny-reduced" in capsys.readouterr().out
    args = ttrain.parse_args(["--arch", ARCH, "--reduced", "--steps", "1",
                              "--batch", "2", "--seq-len", "16",
                              "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="carry no frames.*"
                       "make_train_step"):
        ttrain.train(args)
    jargs = argparse.Namespace(**{k: v for k, v in vars(args).items()
                                  if k != "device"})
    with pytest.raises(KeyError, match="frames"):
        jax_train.train(jargs)
