"""Parity of the port's `configs.shapes` with the JAX package's.

For every architecture of the registry and each of the four assigned
shapes (and their smoke twins), `input_specs` against the reference's:
the batch inputs equal by name, shape and dtype, the decode caches leaf
by leaf once the reference's leading group (or layer) axis is unstacked
into the port's per-layer dicts, the token and position specs, and every
role, the cache roles less the reference's leading group entry; then
`shape_applies` and `is_subquadratic`, the shape tables, and the port's
path helper against JAX's ``keystr(simple=True, separator="/")``.
The port's specs are tensors on the ``meta`` device, the reference's
``ShapeDtypeStruct``s: both are shapes alone, so full size costs
nothing.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.compat import simple_keystr
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import shapes as JS
from repro.configs import get_config as jax_get_config
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs import shapes as S
from torch_jax_release import release_compiled_programs  # noqa: F401

SHAPE_NAMES = list(S.SHAPES)


def _dtype(x) -> str:
    """A spec's dtype by name: ``int32``, ``bfloat16``..."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.dtype(x.dtype))


def _same_spec(got, want):
    assert isinstance(got, torch.Tensor) and got.is_meta
    assert tuple(got.shape) == tuple(want.shape)
    assert _dtype(got) == _dtype(want)


def _assert_batch(got_args, got_roles, want_args, want_roles):
    assert list(got_args) == list(want_args)
    for name in want_args:
        _same_spec(got_args[name], want_args[name])
    assert got_roles == want_roles


def _unstacked(cfg, want):
    """The reference's cache tree as the port keeps it: per layer (LM:
    ``pos_<p>`` entry ``g`` is layer ``g * G + p``; enc-dec: each of
    ``self`` and ``cross`` stacks the decoder layers) -> {leaf name:
    (the leaf with its leading axis dropped, its roles less the first)}."""
    specs, roles = want
    if cfg.enc_dec:
        return {part: [{name: (specs[part][name], roles[part][name])
                        for name in specs[part]}
                       for _ in range(cfg.n_layers)]
                for part in ("self", "cross")}
    return [{name: (specs[f"pos_{li % cfg.group_size}"][name],
                    roles[f"pos_{li % cfg.group_size}"][name])
             for name in specs[f"pos_{li % cfg.group_size}"]}
            for li in range(cfg.n_layers)]


def _assert_layers(got, got_roles, want):
    assert len(got) == len(got_roles) == len(want)
    for li, (cache, roles, ref) in enumerate(zip(got, got_roles, want)):
        assert set(cache) == set(roles) == set(ref), li
        for name, (spec, role) in ref.items():
            assert cache[name].is_meta
            assert tuple(cache[name].shape) == tuple(spec.shape[1:]), \
                (li, name)
            assert _dtype(cache[name]) == _dtype(spec), (li, name)
            assert roles[name] == role[1:], (li, name)


def _check(arch, shape, table):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    spec, jspec = table[shape], JS.SMOKE_SHAPES[shape] \
        if table is S.SMOKE_SHAPES else JS.SHAPES[shape]
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    assert S.shape_applies(cfg, spec) == JS.shape_applies(jcfg, jspec)
    assert S.is_subquadratic(cfg) == JS.is_subquadratic(jcfg)
    got, got_roles = S.input_specs(cfg, spec)
    want, want_roles = JS.input_specs(jcfg, jspec)
    assert len(got) == len(want) and len(got_roles) == len(want_roles)
    if spec.kind != "decode":
        _assert_batch(got[0], got_roles[0], want[0], want_roles[0])
        return got
    (caches, tokens, pos), (c_roles, t_roles, p_roles) = got, got_roles
    ref = _unstacked(cfg, (want[0], want_roles[0]))
    if cfg.enc_dec:
        assert set(caches) == set(c_roles) == {"self", "cross"}
        for part in ("self", "cross"):
            _assert_layers(caches[part], c_roles[part], ref[part])
    else:
        _assert_layers(caches, c_roles, ref)
    _same_spec(tokens, want[1])
    _same_spec(pos, want[2])
    assert t_roles == want_roles[1] and p_roles is want_roles[2] is None
    return got


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_input_specs_match_jax(arch, shape):
    """Every architecture at each assigned shape, at full size."""
    got = _check(arch, shape, S.SHAPES)
    leaves = []
    S.map_with_path(lambda _, t: leaves.append(t), got)
    assert leaves and all(t.is_meta for t in leaves)


@pytest.mark.parametrize("shape", SHAPE_NAMES)
def test_smoke_shapes_match_jax(shape):
    """The smoke twins of the four shapes, for the VLM (its positions and
    patches), the encoder-decoder (frames, cross caches) and the hybrid
    (recurrent states beside ring caches)."""
    for arch in ("qwen2-vl-72b", "whisper-tiny", "jamba-v0.1-52b"):
        _check(arch, shape, S.SMOKE_SHAPES)


def test_vlm_batch_specs():
    """qwen2-vl-72b's train batch: positions (3, B, S) int32 and
    min(1024, S // 2) patch slots of d_model in float32 (at 4,096 the
    1,024 cap; at the smoke 64, 32)."""
    cfg = get_config("qwen2-vl-72b")
    for spec, n_patch in ((S.SHAPES["train_4k"], 1024),
                          (S.SMOKE_SHAPES["train_4k"], 32)):
        (batch,), (roles,) = S.input_specs(cfg, spec)
        b, s = spec.global_batch, spec.seq_len
        assert tuple(batch["positions"].shape) == (3, b, s)
        assert batch["positions"].dtype == torch.int32
        assert tuple(batch["patch_embeds"].shape) == (b, n_patch, 8192)
        assert batch["patch_embeds"].dtype == torch.float32
        assert roles["positions"] == [None, "batch", None]
    assert ARCH_IDS and set(ARCH_IDS) == set(JAX_ARCH_IDS)


def test_map_with_path_matches_jax_keystr():
    """`map_with_path`'s paths against JAX's flattening with paths and
    ``simple_keystr`` on one nested tree of dicts, lists and a tuple; the
    containers kept."""
    tree = {"self": [{"k": 1, "slot_pos": 2}, {"k": 3}],
            "cross": ({"ck": 4},), "x": 5}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    want = sorted((simple_keystr(kp), leaf) for kp, leaf in flat)
    seen = []
    mapped = S.map_with_path(lambda path, leaf: seen.append((path, leaf))
                             or (path, leaf), tree)
    assert sorted(seen) == want
    assert isinstance(mapped["cross"], tuple)
    assert mapped["cross"][0]["ck"] == ("cross/0/ck", 4)
    assert mapped["self"][1]["k"] == ("self/1/k", 3)
    assert mapped["x"] == ("x", 5)
