"""Parity of the port's qwen2 family with the JAX package.

qwen2-72b (dense GQA with q/k/v biases) and qwen2-vl-72b (the same
backbone with M-RoPE over (3, B, S) position streams and the stub patch
frontend: ``patch_embeds`` (B, P, d) over the first P token slots), each
reduced (4 layers, d_model 96, 8 heads over 2 kv heads, hd 12).  The JAX
package's ``init_lm`` / ``init_state`` draw the parameters, the q/k/v
biases then set to seeded normals (``init_lm`` makes them zero, which
would hide a bias the port dropped), carried across with `interop`;
tokens, patches and positions are made with numpy from a seed.  The VLM's
positions are three different streams: the patch slots laid out on an
h x w grid (temporal 0, height the row, width the column), the text after
them at one position on all three, as Qwen2-VL's rope index lays out one
image then text.  The JAX side's flash kernel runs in Pallas interpret,
as its own tests run it on the CPU; the port's runs its plain version.

Tolerances: `apply_mrope` within 1e-6 in float32 (``MROPE_TOL``: the
angles are one product per element in both; the inverse frequencies and
XLA's sin/cos differ from PyTorch's by an ulp at most).  Float32 compute
holds logits within 1e-5 of the largest logit (``F32_TOL``; at least 1:
the frameworks sum each product and softmax in another order, a few ulps
an operation through four layers) and greedy tokens exactly; losses to
1e-5 relative, gradients to 1e-4 of the largest gradient, a train step's
grad norm to 1e-5 relative and its parameters within 2·lr (as
tests/test_torch_train.py holds them).  bfloat16 compute: the port's
logits no further from the JAX package's float32 ones than 1.5 times the
JAX package's own bf16 logits are."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.train import OptConfig as JOptConfig
from repro.train import init_state as jax_init_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import (OptConfig, abstract_state, init_state,
                               make_decode_step, make_prefill_step,
                               make_train_step)
from torch_jax_release import release_compiled_programs  # noqa: F401

ARCHS = ["qwen2-72b", "qwen2-vl-72b"]
VL = ARCHS[1]
B, S, GEN = 2, 24, 4
N_PATCH, GRID = 12, (3, 4)          # min(1024, S // 2) patches, h x w
MROPE_TOL, F32_TOL = 1e-6, 1e-5
LOSS_RTOL, GRAD_ATOL = 1e-5, 1e-4
STEP_OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
# a qwen2 layer's tensors at full width: q/k/v/o (134,217,728 +
# 16,777,216), the q/k/v biases (10,240), the SwiGLU MLP (726,663,168)
# and two norms (16,384)
LAYER_PARAMS = 877_684_736


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


def vl_positions(b, s, n_patch=N_PATCH, grid=GRID, offset=0):
    """(3, b, s) int32: the patch slots on an h x w grid (temporal 0),
    the text after them at one position on every stream, starting past
    the grid's largest; row r shifted by ``offset * r``."""
    h, w = grid
    assert h * w == n_patch
    pos = np.zeros((3, b, s), np.int32)
    pos[1, :, :n_patch] = np.repeat(np.arange(h), w)
    pos[2, :, :n_patch] = np.tile(np.arange(w), h)
    text = np.arange(s - n_patch) + max(h, w)
    pos[:, :, n_patch:] = text
    return pos + offset * np.arange(b, dtype=np.int32)[None, :, None]


def _inputs(cfg, seed=1, b=B, s=S):
    """{tokens (b, s) int32[, patch_embeds (b, P, d) f32, positions
    (3, b, s) int32]} numpy: the VLM's batch carries all three."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.mrope:
        out["patch_embeds"] = rng.standard_normal(
            (b, min(1024, s // 2), cfg.d_model)).astype(np.float32)
        out["positions"] = vl_positions(b, s, offset=3)
    return out


def _as(batch, framework):
    if framework == "jax":
        return {k: jnp.asarray(v) for k, v in batch.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _jax_cfg(arch, compute_dtype="float32", **fields):
    return dataclasses.replace(jax_get_config(arch, reduced=True),
                               compute_dtype=compute_dtype, **fields)


def _port_cfg(jcfg):
    return interop.model_config_from_fields(dataclasses.asdict(jcfg))


def _with_biases(params, seed=7):
    """``params`` with every q/k/v bias a seeded normal times 0.1."""
    rng = np.random.default_rng(seed)
    attn = dict(params["groups"]["pos_0"]["attn"])
    for name in ("bq", "bk", "bv"):
        attn[name] = jnp.asarray(0.1 * rng.standard_normal(
            attn[name].shape).astype(np.float32), attn[name].dtype)
    groups = {"pos_0": dict(params["groups"]["pos_0"], attn=attn)}
    return dict(params, groups=groups)


@functools.lru_cache(maxsize=None)
def _model(arch, compute_dtype="float32"):
    """(JAX cfg, JAX params, port cfg, port params, batch numpy)."""
    jcfg = _jax_cfg(arch, compute_dtype)
    jparams = _with_biases(JT.init_lm(jax.random.key(0), jcfg))
    tcfg = _port_cfg(jcfg)
    tparams = interop.lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    tparams.requires_grad_(False)
    return jcfg, jparams, tcfg, tparams, _inputs(jcfg)


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_match_jax_field_by_field(arch, reduced):
    port, ref = get_config(arch, reduced), jax_get_config(arch, reduced)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port == interop.model_config_from_fields(dataclasses.asdict(ref))
    assert port.param_count() == ref.param_count()
    assert port.qkv_bias and port.mrope == (arch == VL)
    assert port.mrope_sections == ref.mrope_sections


def test_full_width_layer_and_tree_on_meta():
    """qwen2-72b's meta-device `LM` (nothing allocated): every leaf of the
    JAX package's ``init_lm`` tree (``eval_shape``) with its shape, and a
    layer's 877,684,736 parameters."""
    cfg = get_config(ARCHS[0])
    model = T.build_lm(None, cfg, torch.device("meta"))
    jtree = jax.eval_shape(lambda k: JT.init_lm(k, jax_get_config(ARCHS[0])),
                           jax.random.key(0))
    assert all(t.is_meta for t in model.parameters())
    assert sum(p.numel() for p in model.blocks[0].parameters()) == \
        LAYER_PARAMS
    assert sum(p.numel() for p in model.parameters()) == \
        sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jtree))
    ref = jtree["groups"]["pos_0"]
    for name, sub in model.blocks[7].named_children():
        for k, p in sub.items():
            assert tuple(p.shape) == ref[name][k].shape[1:], (name, k)
    assert set(model.blocks[0].attn) == {"wq", "wk", "wv", "wo", "bq", "bk",
                                         "bv"}


# ----------------------------------------------------------------- M-RoPE


@pytest.mark.parametrize("hd,sections,widths", [
    (128, (16, 24, 24), [16, 24, 24]),      # qwen2-vl-72b
    (12, (2, 2, 2), [2, 2, 2]),             # the reduced twin
    (24, (3, 5, 7), [2, 4, 6]),             # 2.4, 4.0, 5.6: rounded
    (20, (1, 1, 2), [2, 2, 6]),             # 2.5 rounds to even (2)
])
def test_apply_mrope_matches_jax(hd, sections, widths):
    """The widths (Python's ``round``, the last takes the rest) and the
    rotation against the JAX package's on three distinct position
    streams, float32 within MROPE_TOL; bf16 in and out."""
    assert L.mrope_widths(hd, sections) == widths
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((B, 30, 4, hd)).astype(np.float32)
    pos = rng.integers(0, 4096, (3, B, 30)).astype(np.int32)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = L.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                        sections)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert _err(got, want) <= MROPE_TOL
    got16 = L.apply_mrope(torch.from_numpy(x).bfloat16(),
                          torch.from_numpy(pos), 1e6, sections)
    want16 = JL.apply_mrope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos),
                            1e6, sections)
    assert got16.dtype == torch.bfloat16
    assert _err(got16, want16) <= 2 ** -7


def test_mrope_on_equal_streams_is_rope():
    """One position on all three streams turns as RoPE over the whole
    head dim does (the decode step's and the text's case)."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, 9, 4, 128)).astype(np.float32))
    pos = torch.arange(9).expand(B, 9) + 500
    got = L.apply_mrope(x, pos.expand(3, B, 9), 1e6, (16, 24, 24))
    assert torch.allclose(got, L.apply_rope(x, pos, 1e6), atol=1e-6)


# ---------------------------------------------------------------- forward


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("flash", [False, True])
def test_forward_train_matches_jax(arch, flash):
    """The prefill step (`forward_train`) on both attention routes, the
    VLM with its patches and distinct positions."""
    jcfg, jparams, tcfg, tparams, batch = _model(arch)
    jcfg = dataclasses.replace(jcfg, use_pallas_attn=flash)
    tcfg = dataclasses.replace(tcfg, use_pallas_attn=flash)
    want, _ = JT.forward_train(jparams, _as(batch, "jax"), jcfg)
    got = make_prefill_step(tcfg)(tparams, _as(batch, "torch"))
    assert got.shape == (B, S, tcfg.padded_vocab)
    assert _close(got, want)


def test_vlm_inputs_reach_the_logits():
    """The patches and each position stream move the VLM's logits (in
    both frameworks alike); without ``positions`` each stream is
    ``arange(S)``; qwen2-72b ignores a batch's ``positions``."""
    jcfg, jparams, tcfg, tparams, batch = _model(VL)
    base = T.forward_train(tparams, _as(batch, "torch"), tcfg)
    # the width stream turns the lowest frequencies (1e-4 and 1e-5 at the
    # reduced hd 12): the patch slots' moved by 1,000 positions (a shift
    # of every slot alike would leave attention as it is)
    far = np.zeros((3, 1, S), np.int32)
    far[2, :, :N_PATCH] = 1000
    for name, change in (("patch_embeds", lambda a: 2 * a),
                         ("positions", lambda a: a + far),
                         ("positions", lambda a: a[[1, 0, 2]])):
        moved = dict(batch, **{name: change(batch[name])})
        got = T.forward_train(tparams, _as(moved, "torch"), tcfg)
        want, _ = JT.forward_train(jparams, _as(moved, "jax"), jcfg)
        assert _err(got, base) > 1e-3 and _close(got, want), name
    plain = {"tokens": batch["tokens"]}
    default = dict(plain, positions=np.broadcast_to(
        np.arange(S, dtype=np.int32), (3, B, S)))
    assert torch.equal(T.forward_train(tparams, _as(plain, "torch"), tcfg),
                       T.forward_train(tparams, _as(default, "torch"), tcfg))
    _, _, qcfg, qparams, qbatch = _model(ARCHS[0])
    odd = dict(qbatch, positions=vl_positions(B, S))
    assert torch.equal(T.forward_train(qparams, _as(qbatch, "torch"), qcfg),
                       T.forward_train(qparams, _as(odd, "torch"), qcfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_bf16_is_as_close_to_f32_as_jax(arch):
    """At bfloat16 compute (the configs' own) the port's logits are no
    further from the JAX package's float32 logits than 1.5 times the JAX
    package's own bf16 logits are, at the largest and on the mean."""
    jcfg, jparams, _, _, batch = _model(arch)
    f32 = _f32(JT.forward_train(jparams, _as(batch, "jax"), jcfg)[0])
    jcfg, jparams, tcfg, tparams, batch = _model(arch, "bfloat16")
    want = _f32(JT.forward_train(jparams, _as(batch, "jax"), jcfg)[0])
    got = T.forward_train(tparams, _as(batch, "torch"), tcfg)
    assert got.dtype == torch.bfloat16
    got, ref = np.abs(_f32(got) - f32), np.abs(want - f32)
    assert got.max() <= 1.5 * ref.max() and got.mean() <= 1.5 * ref.mean()


# ------------------------------------------------------------------ decode


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_train(arch):
    """Decode logits, one token at a time from empty caches, equal the
    teacher-forced forward over the tokens alone (the VLM's decode step
    turns every stream by the token's position, the forward's default)."""
    _, _, tcfg, tparams, batch = _model(arch)
    tokens = torch.from_numpy(batch["tokens"])
    ref = T.forward_train(tparams, {"tokens": tokens}, tcfg)
    caches = T.init_caches(tcfg, B, S, device="cpu")
    outs = []
    for t in range(S):
        lg, caches = T.decode_step(tparams, caches, tokens[:, t:t + 1], t,
                                   tcfg)
        outs.append(lg)
    assert _close(torch.cat(outs, dim=1), ref)


@functools.lru_cache(maxsize=None)
def _jax_prefill(arch):
    jcfg, jparams, *_, batch = _model(arch)
    jcfg = dataclasses.replace(jcfg, use_pallas_attn=True)
    return jax.jit(lambda p, b: JT.forward_prefill(
        p, b, jcfg, cache_len=S + GEN))(jparams, _as(batch, "jax"))


def _port_prefill(arch, batch=None):
    _, _, tcfg, tparams, own = _model(arch)
    return T.forward_prefill(tparams, _as(batch or own, "torch"),
                             dataclasses.replace(tcfg, use_pallas_attn=True),
                             cache_len=S + GEN)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_logits_and_caches_match_jax(arch):
    """The prefill of the whole batch (the VLM's patches and positions
    too): the logits, and every layer's ring cache against the JAX
    package's, whose leaves stack the layers on a leading axis; slot
    positions equal."""
    want_logits, want = _jax_prefill(arch)
    logits, caches = _port_prefill(arch)
    tcfg = _model(arch)[2]
    assert _close(logits, want_logits)
    assert len(caches) == tcfg.n_layers
    for li, cache in enumerate(caches):
        ref = {k: np.asarray(v[li]) for k, v in want["pos_0"].items()}
        assert set(cache) == set(ref) == {"k", "v", "slot_pos"}
        np.testing.assert_array_equal(cache["slot_pos"].numpy(),
                                      ref["slot_pos"])
        for name in ("k", "v"):
            assert _close(cache[name], ref[name]), (li, name)


def test_vlm_prefill_caches_hold_the_text_alone():
    """The JAX package's replay re-embeds the tokens at position t on
    every stream, so a VLM prefill's caches are those of the text alone:
    the caches of the batch with patches and positions equal, bit for
    bit, those of its tokens alone, while the logits differ.  The JAX
    package's caches show the same."""
    _, _, _, _, batch = _model(VL)
    logits, caches = _port_prefill(VL)
    text_logits, text = _port_prefill(VL, {"tokens": batch["tokens"]})
    assert _err(logits, text_logits) > 1e-3
    for got, want in zip(caches, text):
        assert all(torch.equal(got[k], want[k]) for k in want)
    jcfg, jparams, *_ = _model(VL)
    _, jtext = JT.forward_prefill(
        jparams, {"tokens": jnp.asarray(batch["tokens"])},
        dataclasses.replace(jcfg, use_pallas_attn=True), cache_len=S + GEN)
    _, jcaches = _jax_prefill(VL)
    for name in ("k", "v", "slot_pos"):
        np.testing.assert_array_equal(np.asarray(jcaches["pos_0"][name]),
                                      np.asarray(jtext["pos_0"][name]))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_tokens_match_jax(arch):
    """`serve.generate` with the batch's positions and patches against
    the JAX package's composition (forward_prefill with the flash kernel,
    argmax of the last logits, greedy decode_step): each decode step's
    logits and the greedy tokens exactly, in float32."""
    jcfg, jparams, tcfg, tparams, batch = _model(arch)
    logits, caches = _jax_prefill(arch)
    dec = jax.jit(lambda p, c, t, i: JT.decode_step(p, c, t, i, jcfg))
    _, tcaches = _port_prefill(arch)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    want = [tok]
    for i in range(GEN - 1):
        logits, caches = dec(jparams, caches, tok, S + i)
        got, tcaches = make_decode_step(tcfg)(
            tparams, tcaches, torch.from_numpy(np.array(tok)).long(), S + i)
        assert _close(got, logits), i
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        want.append(tok)
    kw = {k: torch.from_numpy(v) for k, v in batch.items() if k != "tokens"}
    got, _, _ = tserve.generate(tparams, torch.from_numpy(batch["tokens"]),
                                tcfg, GEN, **kw)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.concatenate(want, axis=1)))


# ------------------------------------------------------------------- train


@functools.lru_cache(maxsize=None)
def _train_setup(arch):
    jcfg = _jax_cfg(arch)
    jstate = jax_init_state(jax.random.key(0), jcfg)
    return jcfg, jstate, _port_cfg(jcfg), jax.tree.map(np.asarray, jstate)


def _port_state(arch):
    *_, tcfg, np_state = _train_setup(arch)
    return interop.train_state_from_numpy(np_state, tcfg, device="cpu")


def _batch(cfg, step):
    """A train batch of step ``step``: `_inputs` and targets."""
    batch = _inputs(cfg, seed=10 + step)
    batch["targets"] = np.roll(batch["tokens"], -1, axis=1)
    return batch


def test_lm_loss_and_gradients_match_jax():
    """The VLM's ``lm_loss`` and every parameter's gradient against
    ``jax.value_and_grad`` with patches and positions, float32 compute:
    the loss to LOSS_RTOL, each gradient within GRAD_ATOL of the largest
    gradient (at least 1); the biases' gradients are not zero."""
    jcfg, jstate, tcfg, _ = _train_setup(VL)
    batch = _batch(tcfg, 0)
    (wloss, _), wgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(p, b, jcfg), has_aux=True))(
            jstate.params, _as(batch, "jax"))
    params = _port_state(VL).params
    names, leaves = zip(*params.named_parameters())
    loss, _ = T.lm_loss(params, _as(batch, "torch"), tcfg)
    assert _rel(loss.detach(), wloss) < LOSS_RTOL
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    want = interop.lm_state_dict_from_numpy(
        jax.tree.map(np.asarray, wgrads), tcfg, device="cpu")
    assert list(grads) == list(want)
    tol = GRAD_ATOL * max(1.0, max(float(w.abs().max())
                                   for w in want.values()))
    for name, g in grads.items():
        assert float((g - want[name]).abs().max()) <= tol, name
    for part in ("blocks.0.attn.bq", "blocks.3.attn.bk", "blocks.1.attn.bv"):
        assert float(grads[part].abs().max()) > 0, part


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """Two `make_train_step` steps against the JAX package's, the VLM's
    batches with patches and positions: loss, NLL and grad norm to
    LOSS_RTOL, the parameters within 2·sum(lr), the step counter."""
    jcfg, jstate, tcfg, _ = _train_setup(arch)
    jstep = jax.jit(jax_make_train_step(jcfg, JOptConfig(**STEP_OPT)))
    step = make_train_step(tcfg, OptConfig(**STEP_OPT))
    state = _port_state(arch)
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


def test_remat_carries_positions_and_patches():
    """``remat`` none / block / dots give the VLM's loss and gradients
    bit for bit with patches and positions, and the positions reach the
    recomputed layers: a batch without them gives another loss."""
    *_, tcfg, _ = _train_setup(VL)
    batch = _as(_batch(tcfg, 0), "torch")
    runs = []
    for remat in ("none", "block", "dots"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        params = _port_state(VL).params
        loss, _ = T.lm_loss(params, batch, cfg)
        runs.append((loss, torch.autograd.grad(loss,
                                               list(params.parameters()))))
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, runs[0][1]))
    with torch.no_grad():
        bare, _ = T.lm_loss(_port_state(VL).params,
                            {k: batch[k] for k in ("tokens", "targets")},
                            tcfg)
    assert abs(float(bare) - float(runs[0][0].detach())) > 1e-4


def test_states_and_interop():
    """`init_state` and `abstract_state` take qwen2-vl (at full size on
    meta: p, m and v of every tensor, nothing allocated), and
    `train_state_from_numpy` lands the biases and their moments on the
    port's names."""
    *_, tcfg, np_state = _train_setup(VL)
    own = init_state(torch.Generator().manual_seed(0), tcfg, device="cpu")
    state = _port_state(VL)
    assert list(own.params.state_dict()) == list(state.params.state_dict())
    full = abstract_state(get_config(VL))
    leaves = list(full.params.parameters()) + list(full.opt.m.values()) \
        + list(full.opt.v.values())
    assert all(t.is_meta for t in leaves)
    n = sum(p.numel() for p in full.params.parameters())
    assert sum(t.numel() for t in leaves) == 3 * n
    assert n == 80 * LAYER_PARAMS + 2 * 152_064 * 8_192 + 8_192
    for li, leaf in ((1, "bq"), (3, "bv"), (2, "wk")):
        ref = np_state.params["groups"]["pos_0"]["attn"][leaf][li]
        np.testing.assert_array_equal(
            state.params.blocks[li].attn[leaf].detach().numpy(), ref)
        np.testing.assert_array_equal(
            state.opt.m[f"blocks.{li}.attn.{leaf}"].numpy(),
            np_state.opt.m["groups"]["pos_0"]["attn"][leaf][li])


# -------------------------------------------------------------------- CLIs


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_on_cpu(arch, capsys):
    """Both CLIs run the reduced model on the CPU: the serve on its
    tokens alone (the JAX package's serve passes no patches either), the
    launcher on `SyntheticTokens` batches with the default positions, as
    the JAX package's launcher trains it."""
    out = tserve.serve(tserve.parse_args([
        "--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "16",
        "--gen", "3", "--device", "cpu"]))
    assert out["tokens"].shape == (2, 3) and out["tok_per_s"] > 0
    assert ((out["tokens"] >= 0)
            & (out["tokens"] < get_config(arch, True).padded_vocab)).all()
    assert f"[serve] arch={arch}-reduced" in capsys.readouterr().out
    out = ttrain.train(ttrain.parse_args([
        "--arch", arch, "--reduced", "--steps", "2", "--batch", "2",
        "--seq-len", "16", "--log-every", "2", "--device", "cpu"]))
    assert "[train] step     2 loss=" in capsys.readouterr().out
    assert np.isfinite(out["loss"]) and out["grad_norm"] > 0
