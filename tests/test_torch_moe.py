"""Parity of the port's Mixture-of-Experts slice with the JAX package.

`models.moe` alone (``capacity``, the router, ``apply_moe``) and the
reduced mixtral-8x22b and llama4-scout-17b-a16e LMs: ``forward_train``,
decode, prefill caches, serving, ``lm_loss``, gradients and a train
step.  The JAX package's ``init_moe`` / ``init_lm`` / ``init_state``
draw the parameters, carried across as numpy arrays with `interop`;
inputs are made with numpy.

The JAX side runs its blocked attention route (``use_pallas_attn``
False), never its Pallas route, on these configurations: under
``lax.scan`` the JAX package's per-layer ``is_global`` flag is a tracer,
and its Pallas route then passes ``is_global=False`` to the kernel, so
llama4's global layer runs the chunk mask there but the full causal mask
on the blocked route and in decode.  The port passes ``is_global`` as a
Python bool, so both its routes compute the blocked route's function
(`test_flash_route_equals_blocked_route`).

Tolerances, as the dense models' tests hold them: float32 compute, logits
to 1e-4 absolute (the frameworks sum every product and softmax in other
orders, a few ulps an operation), the aux terms and losses to 1e-5
relative, the dropped share to one float32 rounding (1e-6; the mean of
0/1 flags divides in another order), expert choices exactly; bfloat16
compute, logits to 0.1 (both round each product to bf16, a step of 2**-8
relative, and a one-step difference moves on through the layers).
Gradients, the train step and the optimizer as ``test_torch_train.py``
holds them."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.config import MoEConfig as JMoEConfig
from repro.train import OptConfig as JOptConfig
from repro.train import init_state as jax_init_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.config import MoEConfig
from repro_torch.train import OptConfig, abstract_state, make_train_step
from torch_jax_release import release_compiled_programs  # noqa: F401

ARCHS = ["mixtral-8x22b", "llama4-scout-17b-a16e"]
B, S, GEN = 2, 24, 4       # S past the reduced window and chunk (16)
F32_TOL, BF16_TOL = 1e-4, 0.1
LOSS_RTOL, GRAD_ATOL, OPT_RTOL, DROP_TOL = 1e-5, 1e-4, 1e-6, 1e-6
STEP_OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _err(a, b) -> float:
    return float(np.max(np.abs(_f32(a) - _f32(b))))


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _port_cfg(jcfg):
    return interop.model_config_from_fields(dataclasses.asdict(jcfg))


def _jax_cfg(arch, **fields):
    return dataclasses.replace(jax_get_config(arch, reduced=True), **fields)


def _with_capacity(cfg, factor):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))


@functools.lru_cache(maxsize=None)
def _lm(arch, compute_dtype="float32", capacity_factor=None):
    """(JAX cfg, JAX params, port cfg, port params, prompts (B, S))."""
    jcfg = _jax_cfg(arch, compute_dtype=compute_dtype)
    if capacity_factor is not None:
        jcfg = _with_capacity(jcfg, capacity_factor)
    jparams = JT.init_lm(jax.random.key(0), jcfg)
    tcfg = _port_cfg(jcfg)
    tparams = interop.lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    tparams.requires_grad_(False)
    prompts = np.random.default_rng(1).integers(
        1, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, jparams, tcfg, tparams, prompts


# ---------------------------------------------------------------- configs


def test_capacity_over_a_grid():
    for n_experts in (1, 4, 8, 16, 128):
        for top_k in (1, 2, 4):
            for factor in (0.5, 1.0, 1.25, 8.0):
                for t in (1, 2, 7, 48, 512, 2048, 4096):
                    kw = dict(n_experts=n_experts, top_k=top_k,
                              capacity_factor=factor)
                    c = M.capacity(MoEConfig(**kw), t)
                    assert c == JM.capacity(JMoEConfig(**kw), t), (kw, t)
                    assert c % 8 == 0 and c >= 8
    # llama4's prefill at batch 4 x prompt 512; mixtral's at 4 x 512
    assert M.capacity(get_config(ARCHS[1]).moe, 2048) == 160
    assert M.capacity(get_config(ARCHS[0]).moe, 2048) == 640


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_match_jax_field_by_field(arch, reduced):
    port, ref = get_config(arch, reduced), jax_get_config(arch, reduced)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert port.active_param_count() < port.param_count()


def test_other_architectures_still_raise_naming_roadmap():
    """The qwen2 family, refused here until it was ported, now comes with
    the JAX package's configs, field for field."""
    for arch in ("qwen2-72b", "qwen2-vl-72b"):
        for reduced in (False, True):
            port = get_config(arch, reduced)
            assert dataclasses.asdict(port) == \
                dataclasses.asdict(jax_get_config(arch, reduced))
            assert port.qkv_bias and port.moe is None


def test_every_n_layers_must_divide_group_size():
    cfg = dataclasses.replace(
        get_config(ARCHS[0], True),
        moe=MoEConfig(n_experts=4, top_k=2, every_n_layers=2))
    with pytest.raises(ValueError, match="every_n_layers"):
        T.init_lm(torch.Generator(), cfg, device="cpu")
    with pytest.raises(ValueError, match="every_n_layers"):
        T.init_caches(cfg, 1, 8, device="cpu")


def test_abstract_state_of_full_width_mixtral():
    """The meta-device train state at mixtral-8x22b's full size (about
    3.4 TB if it allocated): every MoE leaf's shape, and p, m and v."""
    cfg = get_config(ARCHS[0])
    state = abstract_state(cfg)
    sd = state.params.state_dict()
    e, d, ff = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    assert sd["blocks.0.moe.router"].shape == (d, e)
    assert sd["blocks.0.moe.router"].dtype == torch.float32
    for name, shape in (("w_in", (e, d, ff)), ("w_gate", (e, d, ff)),
                        ("w_out", (e, ff, d))):
        assert sd[f"blocks.55.moe.{name}"].shape == shape
    n = sum(t.numel() for t in sd.values())
    padded = (cfg.padded_vocab - cfg.vocab_size) * d * 2
    assert n == cfg.param_count() + padded
    assert all(t.is_meta for t in state.opt.m.values())


# ----------------------------------------------------------------- router


def _moe_case(n_experts, top_k, activation, compute_dtype, factor=1.25,
              zero_router=False, seed=0, t=(2, 12)):
    """(JAX cfg, JAX params, port cfg, port params, x numpy f32)."""
    jcfg = _jax_cfg("mixtral-8x22b", activation=activation,
                    compute_dtype=compute_dtype,
                    moe=JMoEConfig(n_experts=n_experts, top_k=top_k,
                                   capacity_factor=factor))
    jp = JM.init_moe(jax.random.key(seed), jcfg)
    if zero_router:
        jp["router"] = jnp.zeros_like(jp["router"])
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(seed + 1).standard_normal(
        (*t, jcfg.d_model)).astype(np.float32)
    return jcfg, jp, _port_cfg(jcfg), tp, x


def _jax_routing(jp, x, jcfg):
    """The JAX function's router, pos and fits, restated from
    ``repro.models.moe.apply_moe`` (which returns none of them)."""
    xt = jnp.asarray(x, jcfg.cdtype).reshape(-1, jcfg.d_model)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ jp["router"], axis=-1)
    _, gate_idx = jax.lax.top_k(probs, jcfg.moe.top_k)
    onehot = jax.nn.one_hot(gate_idx, jcfg.moe.n_experts,
                            dtype=jnp.float32)
    flat = onehot.reshape(-1, jcfg.moe.n_experts)
    pos = jnp.sum((jnp.cumsum(flat, axis=0) - flat) * flat, axis=-1)
    c = JM.capacity(jcfg.moe, xt.shape[0])
    return np.asarray(gate_idx), np.asarray(pos.reshape(gate_idx.shape) < c)


MOE_CASES = {
    "top1_swiglu_f32": (4, 1, "swiglu", "float32", 1.25, False),
    "top2_swiglu_f32": (4, 2, "swiglu", "float32", 1.25, False),
    "top2_geglu_f32": (8, 2, "geglu", "float32", 1.25, False),
    "top2_gelu_f32": (4, 2, "gelu", "float32", 1.25, False),
    "top1_gelu_f32": (16, 1, "gelu", "float32", 1.25, False),
    "top2_swiglu_bf16": (4, 2, "swiglu", "bfloat16", 1.25, False),
    "top1_geglu_bf16": (16, 1, "geglu", "bfloat16", 1.25, False),
    "top2_gelu_bf16": (8, 2, "gelu", "bfloat16", 1.25, False),
    "drops_top2_f32": (4, 2, "swiglu", "float32", 0.5, False),
    "drops_top1_bf16": (4, 1, "swiglu", "bfloat16", 0.25, False),
    "zero_router_top2": (4, 2, "swiglu", "float32", 1.25, True),
    "zero_router_top1": (8, 1, "geglu", "float32", 2.0, True),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_apply_moe_matches_jax(case):
    """``apply_moe`` against the JAX function on the same x and
    parameters: the output, the three aux terms, and (float32 compute)
    every token's experts and which of its pairs fit.  A capacity factor
    below 1 drops pairs; an all-zero router ties every probability, so
    JAX's lower-index rule alone decides the experts (0..k-1)."""
    n_experts, top_k, act, cdt, factor, zero = MOE_CASES[case]
    jcfg, jp, tcfg, tp, x = _moe_case(n_experts, top_k, act, cdt, factor,
                                      zero)
    want, waux = JM.apply_moe(jp, jnp.asarray(x, jcfg.cdtype), jcfg)
    xt = torch.from_numpy(x).to(tcfg.cdtype)
    got, gaux = M.apply_moe(tp, xt, tcfg)
    assert got.shape == x.shape and got.dtype == tcfg.cdtype
    assert _err(got, want) < (F32_TOL if cdt == "float32" else BF16_TOL)
    for g, w in zip(gaux[:2], waux[:2]):
        assert _rel(g, w) < LOSS_RTOL, case
    assert abs(float(gaux[2]) - float(waux[2])) <= DROP_TOL, case
    want_idx, want_fits = _jax_routing(jp, x, jcfg)
    r = M.route(tp, xt.reshape(-1, tcfg.d_model), tcfg)
    pos = np.zeros(want_idx.shape, np.int64)
    counts = {}
    for i, e in enumerate(r.gate_idx.numpy().reshape(-1)):
        pos.reshape(-1)[i] = counts.get(e, 0)
        counts[e] = counts.get(e, 0) + 1
    fits = pos < M.capacity(tcfg.moe, want_idx.shape[0])
    if cdt == "float32":
        np.testing.assert_array_equal(r.gate_idx.numpy(), want_idx)
        np.testing.assert_array_equal(fits, want_fits)
    assert float(gaux[2]) == pytest.approx(1.0 - fits.mean(), abs=DROP_TOL)
    if zero:
        assert (r.gate_idx.numpy() == np.arange(top_k)).all()
    if factor < 1.0:
        assert float(gaux[2]) > 0.0


def test_route_breaks_ties_to_the_lower_index():
    """Rows of probabilities with many exact ties (the router's softmax
    replaced by numpy rows of repeated values): the port's top-k order
    equals ``jax.lax.top_k``'s, index for index."""
    rng = np.random.default_rng(7)
    probs = rng.choice([0.0, 0.125, 0.25], size=(64, 16)).astype(np.float32)
    _, want = jax.lax.top_k(jnp.asarray(probs), 4)
    order = torch.sort(torch.from_numpy(probs), dim=-1, descending=True,
                       stable=True).indices[:, :4]
    np.testing.assert_array_equal(order.numpy(), np.asarray(want))
    # through the router itself: logits that tie in pairs
    jcfg, jp, tcfg, tp, _ = _moe_case(8, 2, "swiglu", "float32")
    x = np.eye(tcfg.d_model, dtype=np.float32)[:16]
    tp["router"] = torch.from_numpy(np.repeat(
        rng.standard_normal((tcfg.d_model, 4)).astype(np.float32), 2,
        axis=1))
    jp = dict(jp, router=jnp.asarray(tp["router"].numpy()))
    r = M.route(tp, torch.from_numpy(x), tcfg)
    want_idx, _ = _jax_routing(jp, x, jcfg)
    np.testing.assert_array_equal(r.gate_idx.numpy(), want_idx)
    assert (r.gate_idx[:, 0] % 2 == 0).all()   # the lower of each tie


def test_dispatch_local_equals_global():
    """``dispatch="local"`` runs the one global pool on one card, as the
    JAX package's local dispatch does at data-parallel size 1."""
    jcfg, jp, tcfg, tp, x = _moe_case(4, 2, "swiglu", "float32", 0.5)
    xt = torch.from_numpy(x)
    results = []
    for dispatch in ("global", "local"):
        jc = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, dispatch=dispatch))
        tc = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, dispatch=dispatch))
        want, waux = JM.apply_moe(jp, jnp.asarray(x), jc)
        got, gaux = M.apply_moe(tp, xt, tc)
        assert _err(got, want) < F32_TOL
        results.append((got, gaux))
    assert torch.equal(results[0][0], results[1][0])
    assert all(torch.equal(a, b) for a, b in zip(*(r[1] for r in results)))


# ------------------------------------------------------------------ model


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_forward_train_matches_jax_blocked_route(arch, compute_dtype):
    """Logits and the summed aux terms, S past the window and chunk, with
    llama4's global layer (layer 3) in the stack."""
    jcfg, jparams, tcfg, tparams, prompts = _lm(arch, compute_dtype)
    want, waux = jax.jit(lambda p, t: JT.forward_train(
        p, {"tokens": t}, jcfg))(jparams, jnp.asarray(prompts))
    got, gaux = T.forward_train_aux(tparams,
                                    {"tokens": torch.from_numpy(prompts)},
                                    tcfg)
    assert got.shape == (B, S, tcfg.padded_vocab)
    if compute_dtype == "float32":
        assert _err(got, want) < F32_TOL
        for g, w in zip(gaux[:2], waux[:2]):
            assert _rel(g, w) < LOSS_RTOL
        assert abs(float(gaux[2]) - float(waux[2])) <= \
            tcfg.n_layers * DROP_TOL
    else:
        assert _err(got, want) < BF16_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_flash_route_equals_blocked_route(arch):
    """The port's flash route (its plain version on the CPU) computes the
    blocked route's function past the window and chunk, with llama4's
    global layer attending plain causal on both."""
    _, _, tcfg, tparams, prompts = _lm(arch)
    batch = {"tokens": torch.from_numpy(prompts)}
    blocked = T.forward_train(tparams, batch, tcfg)
    flash = T.forward_train(tparams, batch, dataclasses.replace(
        tcfg, use_pallas_attn=True))
    assert _err(flash, blocked) < F32_TOL
    # the global layer's mask matters: the chunk mask there moves the rows
    # past the first chunk far past the tolerance
    if tcfg.global_every:
        chunked = dataclasses.replace(tcfg, global_every=None)
        other = T.forward_train(tparams, batch, chunked)
        assert _err(other[:, tcfg.chunk_attn:],
                    blocked[:, tcfg.chunk_attn:]) > 100 * F32_TOL


def test_jax_pallas_route_departs_from_its_blocked_route_on_llama4():
    """The reference-side divergence the module docstring names, held so
    that the port's choice of reference stays justified: on the reduced
    llama4 in f32 (B = 2, S = 40, capacity factor 8) the JAX package's
    Pallas route (interpret mode) runs the chunk mask on the global layer,
    so its logits leave the blocked route's past the first chunk and not
    inside it; the port's flash route stays on the blocked route."""
    jcfg = _with_capacity(_jax_cfg(ARCHS[1], compute_dtype="float32"), 8.0)
    jparams = JT.init_lm(jax.random.key(0), jcfg)
    prompts = np.random.default_rng(1).integers(
        1, jcfg.vocab_size, (2, 40)).astype(np.int32)
    batch = {"tokens": jnp.asarray(prompts)}
    blocked, _ = JT.forward_train(jparams, batch, jcfg)
    pallas, _ = JT.forward_train(jparams, batch, dataclasses.replace(
        jcfg, use_pallas_attn=True))
    c = jcfg.chunk_attn
    assert _err(pallas[:, :c], blocked[:, :c]) < F32_TOL
    assert _err(pallas[:, c:], blocked[:, c:]) > 0.1 * float(
        jnp.abs(blocked).max())
    tcfg = dataclasses.replace(_port_cfg(jcfg), use_pallas_attn=True)
    tparams = interop.lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    with torch.no_grad():
        got = T.forward_train(tparams, {"tokens": torch.from_numpy(prompts)},
                              tcfg)
    assert _err(got, blocked) < F32_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_train(arch):
    """Greedy decode logits equal the teacher-forced forward at capacity
    factor 8 (no pair dropped on either path), as tests/test_models.py
    checks the JAX package."""
    _, _, tcfg, tparams, prompts = _lm(arch, capacity_factor=8.0)
    tokens = torch.from_numpy(prompts)
    ref, aux = T.forward_train_aux(tparams, {"tokens": tokens}, tcfg)
    assert float(aux.dropped) == 0.0
    caches = T.init_caches(tcfg, B, S, device="cpu")
    outs = []
    for t in range(S):
        lg, caches = T.decode_step(tparams, caches, tokens[:, t:t + 1], t,
                                   tcfg)
        outs.append(lg)
    assert _err(torch.cat(outs, dim=1), ref) < F32_TOL


@functools.lru_cache(maxsize=None)
def _jax_prefill(arch):
    jcfg, jparams, *_, prompts = _lm(arch)
    return jax.jit(lambda p, t: JT.forward_prefill(
        p, {"tokens": t}, jcfg, cache_len=S + GEN))(jparams,
                                                    jnp.asarray(prompts))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_logits_and_caches_match_jax(arch):
    """The port's prefill (its flash route, as serving runs it) against
    the JAX package's on its blocked route: logits and every layer's ring
    cache, filled by the replay through the MoE decode path."""
    want_logits, want_caches = _jax_prefill(arch)
    _, _, tcfg, tparams, prompts = _lm(arch)
    got_logits, got_caches = T.forward_prefill(
        tparams, {"tokens": torch.from_numpy(prompts)},
        dataclasses.replace(tcfg, use_pallas_attn=True), cache_len=S + GEN)
    assert _err(got_logits, want_logits) < F32_TOL
    assert len(got_caches) == tcfg.n_layers
    for li, cache in enumerate(got_caches):
        g, pos = divmod(li, tcfg.group_size)
        ref = {k: np.asarray(v[g]) for k, v in want_caches[f"pos_{pos}"].items()}
        assert set(cache) == set(ref)
        np.testing.assert_array_equal(cache["slot_pos"].numpy(),
                                      ref["slot_pos"])
        for name in ("k", "v"):
            assert cache[name].shape == ref[name].shape, (li, name)
            assert _err(cache[name], ref[name]) < F32_TOL, (li, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_tokens_match_jax(arch):
    """`serve.generate` against the JAX package's serving composition on
    its blocked route: greedy tokens exactly."""
    jcfg, jparams, tcfg, tparams, prompts = _lm(arch)
    logits, caches = _jax_prefill(arch)
    dec = jax.jit(lambda p, c, t, i: JT.decode_step(p, c, t, i, jcfg))
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    want = [tok]
    for i in range(GEN - 1):
        logits, caches = dec(jparams, caches, tok, S + i)
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        want.append(tok)
    tokens, _, _ = tserve.generate(tparams, torch.from_numpy(prompts), tcfg,
                                   GEN)
    np.testing.assert_array_equal(
        tokens.numpy(), np.asarray(jnp.concatenate(want, axis=1)))


def test_moe_on_every_other_layer():
    """``every_n_layers=2`` in groups of two: dense and MoE layers mixed,
    the aux terms summed over the MoE layers only and averaged by
    `lm_loss` over them."""
    jcfg = _jax_cfg("mixtral-8x22b", compute_dtype="float32", n_layers=4,
                    group_pattern=("attn", "attn"))
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, every_n_layers=2))
    jparams = JT.init_lm(jax.random.key(3), jcfg)
    tcfg = _port_cfg(jcfg)
    tparams = interop.lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    assert [hasattr(b, "moe") for b in tparams.blocks] == \
        [False, True, False, True]
    batch = _batch(tcfg.vocab_size, 0)
    (wl, wm) = JT.lm_loss(jparams, _jax_batch(batch), jcfg)
    with torch.no_grad():
        gl, gm = T.lm_loss(tparams, batch, tcfg)
    assert _rel(gl, wl) < LOSS_RTOL
    for k in ("nll", "lb_loss", "z_loss"):
        assert _rel(gm[k], wm[k]) < LOSS_RTOL, k
    assert abs(float(gm["moe_dropped"]) - float(wm["moe_dropped"])) \
        <= DROP_TOL


# ------------------------------------------------------------------- train


@functools.lru_cache(maxsize=None)
def _train_setup(arch, compute_dtype="float32"):
    jcfg = _jax_cfg(arch, compute_dtype=compute_dtype)
    jstate = jax_init_state(jax.random.key(0), jcfg)
    return jcfg, jstate, _port_cfg(jcfg), jax.tree.map(np.asarray, jstate)


def _port_state(arch, compute_dtype="float32"):
    *_, tcfg, np_state = _train_setup(arch, compute_dtype)
    return interop.train_state_from_numpy(np_state, tcfg, device="cpu")


def _batch(vocab, step, seq=S, batch=B):
    return SyntheticTokens(DataConfig(vocab_size=vocab, seq_len=seq,
                                      global_batch=batch, seed=1)
                           ).batch_at(step, device="cpu")


def _jax_batch(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch, compute_dtype, masked=False):
    jcfg, jstate, _, _ = _train_setup(arch, compute_dtype)
    batch = _batch(jcfg.vocab_size, 0)
    if masked:
        batch["loss_mask"] = _loss_mask()
    fn = jax.jit(jax.value_and_grad(lambda p, b: JT.lm_loss(p, b, jcfg),
                                    has_aux=True))
    (loss, metrics), grads = fn(jstate.params, _jax_batch(batch))
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads))


def _loss_mask():
    return torch.from_numpy(
        (np.random.default_rng(3).random((B, S)) < 0.7).astype(np.float32))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_and_metrics_match_jax(arch, masked):
    want_loss, want_metrics, _ = _jax_value_and_grad(arch, "float32",
                                                     masked)
    *_, tcfg, _ = _train_setup(arch)
    batch = _batch(tcfg.vocab_size, 0)
    if masked:
        batch["loss_mask"] = _loss_mask()
    loss, metrics = T.lm_loss(_port_state(arch).params, batch, tcfg)
    assert loss.requires_grad
    assert set(metrics) == set(want_metrics)
    assert _rel(loss.detach(), want_loss) < LOSS_RTOL
    for k in ("nll", "lb_loss", "z_loss"):
        assert _rel(metrics[k].detach(), want_metrics[k]) < LOSS_RTOL, k
        assert want_metrics[k] > 0
    assert abs(float(metrics["moe_dropped"]) - want_metrics["moe_dropped"]) \
        <= DROP_TOL
    # the total adds the weighted load-balancing loss and the z-loss
    m = {k: float(v.detach()) for k, v in metrics.items()}
    aux_w = tcfg.moe.router_aux_weight
    assert float(loss.detach()) == pytest.approx(
        m["nll"] + aux_w * m["lb_loss"] + m["z_loss"], rel=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_bf16_matches_jax(arch):
    want_loss, _, _ = _jax_value_and_grad(arch, "bfloat16")
    *_, tcfg, _ = _train_setup(arch, "bfloat16")
    loss, _ = T.lm_loss(_port_state(arch, "bfloat16").params,
                        _batch(tcfg.vocab_size, 0), tcfg)
    assert _rel(loss.detach(), want_loss) < 2e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax(arch):
    """Every parameter's gradient against ``jax.value_and_grad`` in
    float32 compute, the router's and the experts' included."""
    _, _, want = _jax_value_and_grad(arch, "float32")
    *_, tcfg, _ = _train_setup(arch)
    params = _port_state(arch).params
    names, leaves = zip(*params.named_parameters())
    loss, _ = T.lm_loss(params, _batch(tcfg.vocab_size, 0), tcfg)
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    want = interop.lm_state_dict_from_numpy(want, tcfg, device="cpu")
    assert list(grads) == list(want)
    assert any(".moe.router" in n for n in grads)
    for name, g in grads.items():
        assert g.shape == want[name].shape
        assert float((g - want[name]).abs().max()) < GRAD_ATOL, name
    assert float(grads["blocks.0.moe.router"].abs().max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    jcfg, jstate, tcfg, _ = _train_setup(arch)
    jstep = jax.jit(jax_make_train_step(jcfg, JOptConfig(**STEP_OPT)))
    step = make_train_step(tcfg, OptConfig(**STEP_OPT))
    state = _port_state(arch)
    lr_sum = 0.0
    for i in range(3):
        batch = _batch(tcfg.vocab_size, i)
        jstate, jm = jstep(jstate, _jax_batch(batch))
        state, m = step(state, batch)
        for k in ("loss", "nll", "grad_norm", "lb_loss", "z_loss"):
            assert _rel(m[k], jm[k]) < LOSS_RTOL, (i, k)
        assert abs(float(m["moe_dropped"]) - float(jm["moe_dropped"])) \
            <= DROP_TOL
        lr_sum += float(jm["lr"])
    want = interop.lm_state_dict_from_numpy(
        jax.tree.map(np.asarray, jstate.params), tcfg, device="cpu")
    got = state.params.state_dict()
    for name in want:
        assert float((got[name] - want[name]).abs().max()) <= 2 * lr_sum, \
            name


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_equal_with_moe(arch):
    """``remat`` none / block / dots return the same loss, aux terms and
    gradients, bit for bit, through the MoE layers' tuple output."""
    *_, tcfg, _ = _train_setup(arch)
    batch = _batch(tcfg.vocab_size, 0)
    runs = []
    for remat in ("none", "block", "dots"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        params = _port_state(arch).params
        names, leaves = zip(*params.named_parameters())
        loss, metrics = T.lm_loss(params, batch, cfg)
        runs.append((loss, metrics, torch.autograd.grad(loss, leaves)))
    for loss, metrics, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        assert all(torch.equal(metrics[k], runs[0][1][k]) for k in metrics)
        assert all(torch.equal(a, b) for a, b in zip(grads, runs[0][2]))


def test_interop_carries_moe_leaves():
    """The JAX train state's MoE leaves (stacked over groups) land on the
    port's names; a tree whose layer lacks the MoE FFN is refused."""
    jcfg, jstate, tcfg, np_state = _train_setup(ARCHS[1])
    state = interop.train_state_from_numpy(np_state, tcfg, device="cpu")
    g, pos = divmod(3, tcfg.group_size)
    for name in ("router", "w_in", "w_gate", "w_out"):
        for got, tree in ((state.params.blocks[3].moe[name].detach(),
                           np_state.params),
                          (state.opt.m[f"blocks.3.moe.{name}"],
                           np_state.opt.m)):
            np.testing.assert_array_equal(
                got.numpy(), tree["groups"][f"pos_{pos}"]["moe"][name][g])
    dense = jax.tree.map(np.asarray, JT.init_lm(
        jax.random.key(0), _jax_cfg("gemma-2b")))
    with pytest.raises(ValueError, match="moe"):
        interop.lm_params_from_numpy(dense, _port_cfg(dataclasses.replace(
            _jax_cfg("gemma-2b"), moe=jcfg.moe)), device="cpu")


# ------------------------------------------------------------- the CLIs


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch, capsys):
    args = tserve.parse_args(["--arch", arch, "--reduced", "--batch", "2",
                              "--prompt-len", "20", "--gen", "3",
                              "--device", "cpu"])
    out = tserve.serve(args)
    assert out["tokens"].shape == (2, 3) and out["tok_per_s"] > 0
    assert ((out["tokens"] >= 0)
            & (out["tokens"] < get_config(arch, True).padded_vocab)).all()
    assert f"[serve] arch={arch}-reduced" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_on_cpu(arch, capsys):
    """`launch.train` on the reduced config: the loss finite and the
    step's metrics carrying the three MoE terms."""
    out = ttrain.train(ttrain.parse_args([
        "--arch", arch, "--reduced", "--steps", "3", "--batch", "2",
        "--seq-len", "16", "--log-every", "3", "--device", "cpu"]))
    assert "[train] step     3 loss=" in capsys.readouterr().out
    assert np.isfinite(out["loss"])
    assert out["lb_loss"] > 0 and out["z_loss"] > 0
    assert 0.0 <= out["moe_dropped"] < 1.0
