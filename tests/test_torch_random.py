"""Port parity of the threefry PRNG: `repro_torch.random` against the
installed ``jax.random`` (threefry2x32, ``jax_threefry_partitionable``
on, its defaults), and the plain threefry hash against jax's
``threefry_2x32``.

Tolerances: `key`, `split`, `fold_in`, `bits`, `randint`, `uniform`,
`permutation`, `choice`, `normal` and the hash bit for bit (`normal`
over 10**6 draws and more, at several shapes and with ``scale``:
XLA's ``ErfInv`` and ``log1p`` reproduced, multiply-adds contracted
where XLA's CPU backend contracts them).  `policy_core.exp_f32` and
`absorb_probs` bit for bit against the reference's compiled CPU ops."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax._src import prng

from repro.core import policy_core as jpc
from repro_torch import random
from repro_torch.core import policy_core as tpc
from repro_torch.kernels.threefry import kernel as tkernel
from repro_torch.kernels.threefry import ops as tops
from repro_torch.kernels.threefry.ref import threefry2x32

SEEDS = [0, 1, 2024, -3, 2 ** 31 + 7, 2 ** 40 + 11]


def _kd(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def _tk(key) -> torch.Tensor:
    return torch.from_numpy(_kd(key))


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                  np.asarray(b).astype(np.int64),
                                  err_msg=msg)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.astype(np.float32).view(np.int32).astype(np.int64)
                  - b.astype(np.float32).view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_bits(seed):
    k = jax.random.key(seed)
    t = random.key(seed, device="cpu")
    _eq(t.numpy(), _kd(k))
    for num in (1, 2, 3, 100):
        _eq(random.split(t, num).numpy(), _kd(jax.random.split(k, num)))
    for data in (0, 1, 0x7e3, 2 ** 32 - 1):
        _eq(random.fold_in(t, data).numpy(), _kd(jax.random.fold_in(k, data)))
    for shape in ((), (1,), (7,), (3, 5)):
        _eq(random.bits(t, shape).numpy(),
            jax.random.bits(k, shape, jnp.uint32), f"bits {shape}")


def test_batched_keys_replace_vmap():
    ks = jax.random.split(jax.random.key(9), 6).reshape(2, 3)
    tks = _tk(ks)
    flat = ks.reshape(-1)
    _eq(random.split(tks, 4).numpy().reshape(6, 4, 2),
        _kd(jax.vmap(lambda k: jax.random.split(k, 4))(flat)))
    _eq(random.fold_in(tks, 5).numpy().reshape(6, 2),
        _kd(jax.vmap(lambda k: jax.random.fold_in(k, 5))(flat)))
    _eq(random.randint(tks, (4,), 0, 37).numpy().reshape(6, 4),
        jax.vmap(lambda k: jax.random.randint(k, (4,), 0, 37))(flat))
    _eq(random.uniform(tks, (5,), 0.25, 4.0).numpy().reshape(6, 5).view(
        np.int32), np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, (5,), minval=0.25, maxval=4.0))(flat)).view(np.int32))
    _eq(random.choice(tks, 20, (4,)).numpy().reshape(6, 4),
        jax.vmap(lambda k: jax.random.choice(k, 20, (4,), replace=False))(
            flat))


# spans that are powers of two and not, of one, above 2**16 (where the
# reference's multiplier wraps to 0) and the whole int32 range
RANDINT_CASES = [(0, 3), (0, 800), (0, 50), (0, 64), (5, 6), (0, 1),
                 (-7, 1_000_003), (0, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1),
                 (3, 3), (10, 2), (0, 2 ** 16), (0, 2 ** 16 + 1)]


@pytest.mark.parametrize("lo,hi", RANDINT_CASES)
def test_randint(lo, hi):
    for seed in SEEDS[:3]:
        k = jax.random.key(seed)
        got = random.randint(random.key(seed, device="cpu"), (300,), lo, hi)
        assert got.dtype == torch.int32
        _eq(got.numpy(), jax.random.randint(k, (300,), lo, hi,
                                            dtype=jnp.int32),
            f"randint [{lo}, {hi}) seed {seed}")


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(-2 ** 40, 2 ** 40), lo=st.integers(-2 ** 31, 2 ** 20),
       span=st.integers(-3, 2 ** 31), n=st.integers(1, 40))
def test_randint_property(seed, lo, span, n):
    hi = min(lo + span, 2 ** 31 - 1)
    got = random.randint(random.key(seed, device="cpu"), (n,), lo, hi)
    _eq(got.numpy(), jax.random.randint(jax.random.key(seed), (n,), lo, hi,
                                        dtype=jnp.int32))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.25, 4.0), (4.0, 10.0),
                                   (10.0, 1024.0), (-1.0, 1.0),
                                   (-0.99999994, 1.0)])
def test_uniform(lo, hi):
    for seed in SEEDS[:4]:
        got = random.uniform(random.key(seed, device="cpu"), (20_000,), lo,
                             hi).numpy()
        want = np.asarray(jax.random.uniform(jax.random.key(seed), (20_000,),
                                             minval=lo, maxval=hi))
        assert got.dtype == np.float32
        _eq(got.view(np.int32), want.view(np.int32), f"[{lo}, {hi})")


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), lo=st.floats(-1e3, 1e3),
       width=st.floats(1e-3, 1e3), n=st.integers(1, 64))
def test_uniform_property(seed, lo, width, n):
    hi = lo + width
    got = random.uniform(random.key(seed, device="cpu"), (n,), lo, hi)
    want = jax.random.uniform(jax.random.key(seed), (n,), minval=lo,
                              maxval=hi)
    _eq(got.numpy().view(np.int32), np.asarray(want).view(np.int32))


@pytest.mark.parametrize("n", [1, 2, 5, 37, 100, 1000])
def test_permutation_and_choice(n):
    for seed in SEEDS[:3]:
        k = jax.random.key(seed)
        t = random.key(seed, device="cpu")
        _eq(random.permutation(t, n).numpy(), jax.random.permutation(k, n))
        for draws in {1, max(n // 10, 1), n}:
            _eq(random.choice(t, n, (draws,)).numpy(),
                jax.random.choice(k, n, (draws,), replace=False))
    with pytest.raises(ValueError, match="without replacement"):
        random.choice(random.key(0, device="cpu"), 3, (4,))


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), n=st.integers(1, 300),
       frac=st.floats(0.0, 1.0))
def test_choice_property(seed, n, frac):
    draws = max(int(frac * n), 1)
    got = random.choice(random.key(seed, device="cpu"), n, (draws,))
    _eq(got.numpy(), jax.random.choice(jax.random.key(seed), n, (draws,),
                                       replace=False))


@pytest.mark.parametrize("seed", SEEDS[:5])
def test_normal_within_ulp_bound(seed):
    """Jax's normal bit for bit (`NORMAL_ULP` is 0) over 200,000 draws a
    seed, 10**6 over these seeds, and ``scale`` folded as XLA folds
    ``scale * normal``'s constants."""
    assert random.NORMAL_ULP == 0
    k = jax.random.key(seed)
    t = random.key(seed, device="cpu")
    got = random.normal(t, (200_000,)).numpy()
    want = np.asarray(jax.random.normal(k, (200_000,)))
    assert _ulps(got, want).max() <= random.NORMAL_ULP
    _eq(got.view(np.int32), want.view(np.int32))
    assert np.isfinite(got).all() and abs(got.mean()) < 0.01
    scaled = random.normal(t, (200_000,), scale=5.0).numpy()
    want5 = np.asarray(jax.jit(lambda kk: jnp.float32(5.0)
                               * jax.random.normal(kk, (200_000,)))(k))
    assert _ulps(scaled, want5).max() <= random.NORMAL_ULP


def test_normal_bit_for_bit_at_shapes():
    """Every shape draws jax's bits, and a batch of keys draws each key's
    own (the leading axes replace the reference's ``vmap``)."""
    for seed, shape in ((3, (200, 150)), (2 ** 40 + 11, (5, 7, 11)),
                        (-3, (3,)), (9, (2, 1))):
        k = jax.random.key(seed)
        got = random.normal(random.key(seed, device="cpu"), shape).numpy()
        _eq(got.view(np.int32),
            np.asarray(jax.random.normal(k, shape)).view(np.int32),
            f"seed {seed} shape {shape}")
        ks = jax.random.split(k, 3)
        got = random.normal(_tk(ks), shape).numpy()
        want = np.asarray(jax.vmap(lambda kk: jax.random.normal(kk, shape))(
            ks))
        _eq(got.view(np.int32), want.view(np.int32),
            f"batched keys, seed {seed} shape {shape}")


def test_log1p_branches_against_xla():
    """`random._log1p` against XLA's compiled ``log1p`` on every normal
    float32 in (-1, -2**-126] spaced by 97 ulp (10.9 million), at the
    branches' edge and at -0.0.  XLA flushes subnormals to zero, which
    `normal` never feeds it (its smallest ``|u|`` is 2**-24)."""
    x = -np.arange(0x00800000, 0x3F800000, 97,
                   dtype=np.int32).view(np.float32)
    edge = np.float32(random._LOG1P_SMALL)
    below = np.nextafter(edge, np.float32(0))
    x = np.concatenate([x, np.array([-below, -edge, -0.0], np.float32)])
    got = random._log1p(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jnp.log1p)(x))
    _eq(got.view(np.int32), want.view(np.int32))

@settings(max_examples=30, deadline=None)
@given(k1=st.integers(0, 2 ** 32 - 1), k2=st.integers(0, 2 ** 32 - 1),
       counts=st.lists(st.integers(0, 2 ** 32 - 1), min_size=2, max_size=40))
def test_plain_hash_property(k1, k2, counts):
    if len(counts) % 2:
        counts = counts[:-1]
    cnt = np.asarray(counts, np.uint32)
    want = np.asarray(prng.threefry_2x32(
        (jnp.uint32(k1), jnp.uint32(k2)), jnp.asarray(cnt)))
    half = len(counts) // 2
    c = torch.from_numpy(cnt.astype(np.int64))
    y1, y2 = threefry2x32(torch.tensor(k1), torch.tensor(k2), c[:half],
                          c[half:])
    _eq(torch.cat([y1, y2]).numpy(), want)


def test_plain_hash_against_jax():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2 ** 32, (5, 2), dtype=np.uint64).astype(
        np.uint32)
    cnt = rng.integers(0, 2 ** 32, 64, dtype=np.uint64).astype(np.uint32)
    for kk in keys:
        want = np.asarray(prng.threefry_2x32(jnp.asarray(kk),
                                             jnp.asarray(cnt)))
        c = torch.from_numpy(cnt.astype(np.int64))
        y1, y2 = threefry2x32(torch.tensor(int(kk[0])),
                              torch.tensor(int(kk[1])), c[:32], c[32:])
        _eq(torch.cat([y1, y2]).numpy(), want)
    # the counter form the kernel computes: (0, count_lo + j)
    tk = torch.from_numpy(keys.astype(np.int64))
    got = tops.threefry_counters(tk, 9, 5)
    for i, kk in enumerate(keys):
        x1 = jnp.zeros(9, jnp.uint32)
        x2 = jnp.arange(5, 14, dtype=jnp.uint32)
        w1, w2 = prng.threefry2x32_p.bind(jnp.uint32(kk[0]), jnp.uint32(kk[1]),
                                          x1, x2)
        _eq(got[i].numpy(), np.stack([np.asarray(w1), np.asarray(w2)], -1))
    xor = tops.threefry_counters(tk, 9, 5, xor=True)
    assert torch.equal(xor, got[..., 0] ^ got[..., 1])
    assert torch.equal(tops.threefry_counters_plain(tk, 9, 5), got)


def test_kernel_wrapper_refuses_cpu_and_bad_keys():
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.threefry_counters_call(torch.zeros((3, 2),
                                                   dtype=torch.int64), 4)
    with pytest.raises(ValueError, match=r"\(\.\.\., 2\)"):
        tops.threefry_counters(torch.zeros(3, dtype=torch.int64), 4)
    with pytest.raises(ValueError, match=r"\(\.\.\., 2\)"):
        random.split(torch.zeros((2, 3), dtype=torch.int64))


def test_key_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        random.key(0)
    assert random.key(0, device="cpu").device.type == "cpu"


def test_exp_f32_is_the_reference_cpu_exp():
    x = torch.cat([torch.rand(200_000) * -80.0, torch.rand(50_000) * 80.0,
                   torch.rand(50_000) * -0.05])
    want = np.asarray(jax.jit(jnp.exp)(jnp.asarray(x.numpy())))
    _eq(tpc.exp_f32(x).numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("m", [17, 24, 37, 64, 100, 130, 300])
def test_absorb_probs_is_the_reference_row(m):
    """`absorb_probs` bit for bit the reference's compiled row, batched
    and per trial (widths above 8)."""
    rng = np.random.default_rng(m)
    for lam in (50.0, 300.0, 3507.5):
        loads = np.clip(rng.normal(50.0, 15.0, (12, m)), 0, None).astype(
            np.float32)
        got = tpc.absorb_probs(torch.from_numpy(loads), lam, m).numpy()
        want = np.asarray(jax.jit(jax.vmap(
            lambda r: jpc.absorb_probs(r, lam, m)))(jnp.asarray(loads)))
        _eq(got.view(np.int32), want.view(np.int32), f"M={m} lam={lam}")
        one = np.asarray(jax.jit(lambda r: jpc.absorb_probs(r, lam, m))(
            jnp.asarray(loads[0])))
        _eq(got[0].view(np.int32), one.view(np.int32))
