"""Parity of the port's LM serving path with the JAX package.

The reduced gemma-2b, stablelm-1.6b and h2o-danube-3-4b configurations;
the JAX package's ``init_lm`` draws the parameters, which are carried
across as numpy arrays with `interop.lm_params_from_numpy`, and the
prompts are made with numpy.  The JAX side's flash kernel runs as its own
tests run it (Pallas interpret on the CPU); the port's runs its plain
version (CPU tensors).

Tolerances: float32 compute (as tests/test_models.py's decode test runs
it) holds logits to 1e-4 absolute — the two frameworks sum every matrix
product and softmax in another order, a few float32 ulps per operation
through two layers at logits of order one — and greedy tokens exactly.
At the default bfloat16 compute the logits are held to 0.1: both round
each product to bf16 (a step of 2**-8 relative), and an activation that
lands one step apart moves on through the later layers.  int8 caches
are held to one quantization step (a float32 difference of one ulp can
move round() across a half), and their scales to 1e-5 relative."""

import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as TA
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import make_prefill_step
from torch_jax_release import release_compiled_programs  # noqa: F401

ARCHS = ["gemma-2b", "stablelm-1.6b", "h2o-danube-3-4b"]
# the MoE architectures: tests/test_torch_moe.py; the state-space and
# recurrent ones: tests/test_torch_ssm.py; the encoder-decoder:
# tests/test_torch_encdec.py; the qwen2 family: tests/test_torch_qwen2.py
PORTED = ARCHS + ["mixtral-8x22b", "llama4-scout-17b-a16e",
                  "jamba-v0.1-52b", "xlstm-1.3b", "whisper-tiny",
                  "qwen2-72b", "qwen2-vl-72b"]
B, S, GEN = 2, 24, 4       # S past danube's reduced window (16)
F32_TOL, BF16_TOL = 1e-4, 0.1


def _jax_cfg(arch, **fields):
    return dataclasses.replace(jax_get_config(arch, reduced=True), **fields)


@functools.lru_cache(maxsize=None)
def _setup(arch, compute_dtype, kv_cache_dtype="bfloat16"):
    """(JAX cfg, JAX params, port cfg, port params, prompts (B, S) numpy)."""
    jcfg = _jax_cfg(arch, compute_dtype=compute_dtype,
                    kv_cache_dtype=kv_cache_dtype)
    jparams = JT.init_lm(jax.random.key(0), jcfg)
    tcfg = interop.model_config_from_fields(dataclasses.asdict(jcfg))
    tparams = interop.lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    prompts = np.random.default_rng(1).integers(
        1, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, jparams, tcfg, tparams, prompts


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _err(a, b) -> float:
    return float(np.max(np.abs(_f32(a) - _f32(b))))


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_match_jax_field_by_field(arch, reduced):
    port, ref = get_config(arch, reduced), jax_get_config(arch, reduced)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert port.cdtype == torch.bfloat16 and port.pdtype == torch.float32


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_model_config_from_fields_carries_every_config(arch):
    ref = jax_get_config(arch)
    port = interop.model_config_from_fields(dataclasses.asdict(ref))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.hd == ref.hd and port.n_groups == ref.n_groups
    assert arch in PORTED
    for reduced in (False, True):
        assert dataclasses.asdict(get_config(arch, reduced)) == \
            dataclasses.asdict(jax_get_config(arch, reduced))


@pytest.mark.parametrize("arch", ["whisper-tiny"])
def test_unported_blocks_raise_naming_roadmap(arch):
    """The decoder-LM assembly refuses an encoder-decoder configuration,
    naming where it is built: `models.encdec`'s ``init_encdec`` and
    ``init_caches``."""
    cfg = interop.model_config_from_fields(
        dataclasses.asdict(jax_get_config(arch, reduced=True)))
    with pytest.raises(NotImplementedError, match="encdec.init_encdec"):
        T.init_lm(torch.Generator(), cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="encdec.init_caches"):
        T.init_caches(cfg, 1, 8, device="cpu")


# ----------------------------------------------------------------- layers


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32) * 3
    p = {"scale": rng.standard_normal(64, dtype=np.float32) * 0.1}
    if kind == "layernorm":
        p["bias"] = rng.standard_normal(64, dtype=np.float32) * 0.1
    want = JL.apply_norm(kind, {k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
    got = L.apply_norm(kind, {k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x))
    assert _err(got, want) < 1e-5


@pytest.mark.parametrize("pct", [1.0, 0.25])
def test_apply_rope(pct):
    x = np.random.default_rng(3).standard_normal((2, 7, 4, 32),
                                                  dtype=np.float32)
    pos = np.broadcast_to(np.arange(7) + 100, (2, 7))
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4, pct)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                       1e4, pct)
    assert _err(got, want) < 1e-4       # angles up to ~100 rad in float32


@pytest.mark.parametrize("activation", ["geglu", "swiglu", "gelu"])
def test_apply_mlp(activation):
    cfg = _jax_cfg("gemma-2b", compute_dtype="float32", activation=activation)
    p = JL.init_mlp(jax.random.key(4), 64, 256, activation, jnp.float32)
    x = np.random.default_rng(4).standard_normal((2, 5, 64), dtype=np.float32)
    want = JL.apply_mlp(p, jnp.asarray(x), cfg)
    tcfg = interop.model_config_from_fields(dataclasses.asdict(cfg))
    got = L.apply_mlp({k: torch.from_numpy(np.array(v))
                       for k, v in p.items()}, torch.from_numpy(x), tcfg)
    assert _err(got, want) < 1e-5


# ----------------------------------------------------------------- forward


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("flash", [False, True])
def test_forward_train_matches_jax(arch, flash):
    """The prefill step (`forward_train`) with both attention routes."""
    jcfg, jparams, tcfg, tparams, prompts = _setup(arch, "float32")
    jcfg = dataclasses.replace(jcfg, use_pallas_attn=flash)
    tcfg = dataclasses.replace(tcfg, use_pallas_attn=flash)
    want, _ = JT.forward_train(jparams, {"tokens": jnp.asarray(prompts)},
                               jcfg)
    got = make_prefill_step(tcfg)(tparams,
                                  {"tokens": torch.from_numpy(prompts)})
    assert got.shape == (B, S, tcfg.padded_vocab)
    assert _err(got, want) < F32_TOL, (arch, flash)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_train(arch):
    """Greedy decode logits equal the teacher-forced forward (the port
    alone, as tests/test_models.py checks the JAX package)."""
    _, _, tcfg, tparams, prompts = _setup(arch, "float32")
    tokens = torch.from_numpy(prompts)
    ref = T.forward_train(tparams, {"tokens": tokens}, tcfg)
    caches = T.init_caches(tcfg, B, S, device="cpu")
    outs = []
    for t in range(S):
        lg, caches = T.decode_step(tparams, caches, tokens[:, t:t + 1], t,
                                   tcfg)
        outs.append(lg)
    assert _err(torch.cat(outs, dim=1), ref) < F32_TOL


@torch.no_grad()   # a decode-path layer, run as `decode_step` runs it
def test_decode_attend_masks_ring_slots_past_the_window():
    """A ring with more slots than the sliding window (``init_kv_cache``
    with ``size`` > ``sliding_window``, which ``cache_size_for`` never
    builds): the slots older than the window must be masked.  The port's
    ``decode_attend`` against the JAX package's on the same cache, weights
    and token; without the mask the output moves far past the tolerance."""
    _, jparams, tcfg, tparams, _ = _setup("h2o-danube-3-4b", "float32")
    jcfg = _jax_cfg("h2o-danube-3-4b", compute_dtype="float32")
    win = tcfg.sliding_window
    size = win + 8
    pos = 2 * size + 3           # the ring holds pos - size .. pos - 1
    rng = np.random.default_rng(5)
    shape = (B, size, tcfg.n_kv_heads, tcfg.hd)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    first = pos - size
    slot_pos = np.array([first + (s - first) % size for s in range(size)],
                        np.int32)
    x1 = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)

    def port_cache():
        cache = TA.init_kv_cache(tcfg, B, size, device="cpu")
        cache.update(k=torch.from_numpy(k.copy()),
                     v=torch.from_numpy(v.copy()),
                     slot_pos=torch.from_numpy(slot_pos.copy()))
        return cache

    jcache = dict(JA.init_kv_cache(jcfg, B, size), k=jnp.asarray(k),
                  v=jnp.asarray(v), slot_pos=jnp.asarray(slot_pos))
    jp = jax.tree.map(lambda a: a[0], jparams["groups"]["pos_0"]["attn"])
    want, wcache = JA.decode_attend(jp, jnp.asarray(x1), jcache,
                                    jnp.int32(pos), jcfg)
    got, gcache = TA.decode_attend(tparams.blocks[0].attn,
                                   torch.from_numpy(x1), port_cache(), pos,
                                   tcfg)
    assert _err(got, want) < F32_TOL
    # slot positions and the slots the step did not write are copies:
    # bit-equal; the written slot's k and v come from a matrix product
    # in each framework: F32_TOL, as every prefill cache below
    np.testing.assert_array_equal(gcache["slot_pos"].numpy(),
                                  np.asarray(wcache["slot_pos"]))
    slot = pos % size
    kept = np.arange(size) != slot
    for name in ("k", "v"):
        g, w = gcache[name].numpy(), np.asarray(wcache[name])
        np.testing.assert_array_equal(g[:, kept], w[:, kept])
        assert _err(g[:, slot], w[:, slot]) < F32_TOL, name
    # the new token took the oldest slot; size - win slots lie past the window
    assert int((pos - gcache["slot_pos"] >= win).sum()) == size - win
    unmasked, _ = TA.decode_attend(
        tparams.blocks[0].attn, torch.from_numpy(x1), port_cache(), pos,
        dataclasses.replace(tcfg, sliding_window=None))
    assert _err(unmasked, want) > 100 * F32_TOL


@functools.lru_cache(maxsize=None)
def _jax_prefill(arch, compute_dtype, kv_cache_dtype="bfloat16"):
    jcfg, jparams, *_, prompts = _setup(arch, compute_dtype, kv_cache_dtype)
    jcfg = dataclasses.replace(jcfg, use_pallas_attn=True)
    return jax.jit(lambda p, t: JT.forward_prefill(
        p, {"tokens": t}, jcfg, cache_len=S + GEN))(jparams,
                                                    jnp.asarray(prompts))


def _port_prefill(arch, compute_dtype, kv_cache_dtype="bfloat16"):
    _, _, tcfg, tparams, prompts = _setup(arch, compute_dtype,
                                          kv_cache_dtype)
    tcfg = dataclasses.replace(tcfg, use_pallas_attn=True)
    return T.forward_prefill(tparams, {"tokens": torch.from_numpy(prompts)},
                             tcfg, cache_len=S + GEN)


def _assert_caches(got, want, tcfg, int8):
    """Every layer's cache tensors against the JAX package's, whose leaves
    stack the layers of a group position on a leading axis."""
    assert len(got) == tcfg.n_layers
    for li, cache in enumerate(got):
        g, pos = divmod(li, tcfg.group_size)
        ref = {k: np.asarray(v[g]) for k, v in want[f"pos_{pos}"].items()}
        assert set(cache) == set(ref)
        np.testing.assert_array_equal(cache["slot_pos"].numpy(),
                                      ref["slot_pos"])
        for name in ("k", "v"):
            if int8:
                assert cache[name].dtype == torch.int8
                diff = np.abs(cache[name].numpy().astype(np.int32)
                              - ref[name].astype(np.int32))
                assert diff.max() <= 1, (li, name)
                np.testing.assert_allclose(cache[f"{name}_scale"].numpy(),
                                           ref[f"{name}_scale"], rtol=1e-5)
            else:
                assert _err(cache[name], ref[name]) < F32_TOL, (li, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_logits_and_caches_match_jax(arch):
    want_logits, want_caches = _jax_prefill(arch, "float32")
    got_logits, got_caches = _port_prefill(arch, "float32")
    assert _err(got_logits, want_logits) < F32_TOL
    _assert_caches(got_caches, want_caches, _setup(arch, "float32")[2],
                   int8=False)


def test_forward_prefill_int8_cache_matches_jax():
    want_logits, want_caches = _jax_prefill("gemma-2b", "float32", "int8")
    got_logits, got_caches = _port_prefill("gemma-2b", "float32", "int8")
    assert _err(got_logits, want_logits) < F32_TOL
    _assert_caches(got_caches, want_caches,
                   _setup("gemma-2b", "float32", "int8")[2], int8=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_bf16_matches_jax(arch):
    """The default bfloat16 compute, through the flash path both sides."""
    want_logits, _ = _jax_prefill(arch, "bfloat16")
    got_logits, got_caches = _port_prefill(arch, "bfloat16")
    assert got_logits.dtype == torch.bfloat16
    assert got_caches[0]["k"].dtype == torch.bfloat16
    assert _err(got_logits, want_logits) < BF16_TOL


# ------------------------------------------------------------------ serve


def _jax_generate(arch, kv_cache_dtype):
    """The JAX package's serving composition: forward_prefill with the
    flash kernel, argmax of the last logits, then greedy decode_step."""
    jcfg, jparams, *_, prompts = _setup(arch, "float32", kv_cache_dtype)
    logits, caches = _jax_prefill(arch, "float32", kv_cache_dtype)
    dec = jax.jit(lambda p, c, t, i: JT.decode_step(p, c, t, i, jcfg))
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    out = [tok]
    for i in range(GEN - 1):
        logits, caches = dec(jparams, caches, tok, S + i)
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("arch,kv_cache_dtype",
                         [(a, "bfloat16") for a in ARCHS]
                         + [("gemma-2b", "int8")])
def test_serve_tokens_match_jax(arch, kv_cache_dtype):
    _, _, tcfg, tparams, prompts = _setup(arch, "float32", kv_cache_dtype)
    tokens, _, _ = tserve.generate(tparams, torch.from_numpy(prompts), tcfg,
                                   GEN)
    np.testing.assert_array_equal(tokens.numpy(),
                                  _jax_generate(arch, kv_cache_dtype))


def test_serve_entry_point_on_cpu(capsys):
    args = tserve.parse_args(["--arch", "h2o-danube-3-4b", "--reduced",
                              "--batch", "2", "--prompt-len", "20", "--gen",
                              "3", "--device", "cpu"])
    out = tserve.serve(args)
    assert out["tokens"].shape == (2, 3)
    assert out["tok_per_s"] > 0 and out["prefill_s"] > 0
    assert ((out["tokens"] >= 0)
            & (out["tokens"] < get_config("h2o-danube-3-4b",
                                          True).padded_vocab)).all()
    assert "[serve] arch=h2o-danube-3-4b-reduced" in capsys.readouterr().out


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    for fn in (T.init_lm, T.init_caches, interop.lm_params_from_numpy,
               interop.from_prep):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    args = tserve.parse_args(["--arch", "gemma-2b", "--reduced"])
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("gemma-2b", True)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.serve(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_lm(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_caches(cfg, 1, 8)
    tree = {"embed": {}, "final_norm": {}, "groups": {}}
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.lm_params_from_numpy(tree, cfg)
    t, m, r = 1, 4, 8
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.from_prep(
            init_loads=np.zeros((t, m)), straggler_mask=np.zeros((t, m)),
            object_ids=np.zeros((t, r)), lengths=np.ones((t, r)),
            valid=np.ones((t, r)), log=np.zeros((t, 4, m)),
            n_assigned=np.zeros((t, m)), rates=np.ones((t, m)),
            vclock=np.zeros(t), free_at=np.zeros((t, m)),
            keys=np.zeros((t, 2), np.uint32))
