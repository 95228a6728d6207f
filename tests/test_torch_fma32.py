"""`repro_torch.random.uniform` where its multiply-add's float64 sum
rounds: a tiny ``lo`` beside a span of few mantissa bits, so that the
product ``u * span`` often lands on a float32 tie and ``lo`` decides the
rounding.  Bit for bit against ``jax.random.uniform`` (XLA's CPU backend
contracts the multiply-add and rounds it once).  The host test
`random._sum_exact` leaves the simulation's draws on the single cast."""

import jax
import numpy as np
import pytest
import torch

from repro_torch import random
from repro_torch.core import simulate
from torch_jax_release import release_compiled_programs  # noqa: F401

# a seeded grid: lo from 1e-38 to 1e-9 of both signs, spans of one to
# four mantissa bits (a cast of the float64 sum alone gets 225 of these
# 3,072 draws wrong)
_RNG = np.random.default_rng(0)
GRID = [(float(np.float32(10.0 ** _RNG.uniform(-38, -9)))
         * (1 if i % 2 else -1),
         float(_RNG.choice([3, 5, 7, 1.5, 0.75, 6, 11, 13, 2.5, 96])))
        for i in range(24)]


def _draws(seed, lo, hi, n=128):
    got = random.uniform(random.key(seed, device="cpu"), (n,), lo, hi)
    want = jax.random.uniform(jax.random.key(seed), (n,), minval=lo,
                              maxval=hi)
    return got.numpy().view(np.int32), np.asarray(want).view(np.int32)


@pytest.mark.parametrize("part", range(4))
def test_uniform_tiny_lo_bit_equal(part):
    for seed, (lo, span) in enumerate(GRID):
        if seed % 4 != part:
            continue
        got, want = _draws(seed, lo, lo + span)
        np.testing.assert_array_equal(got, want, err_msg=f"lo {lo} span "
                                      f"{span} seed {seed}")


def test_grid_reaches_the_rounded_sum():
    """Every grid case takes the rounding to odd, and the single cast
    would differ from jax on some of its draws."""
    wrong = 0
    for seed, (lo, span) in enumerate(GRID):
        f32 = random._f32
        s = f32(np.float32(f32(lo + span)) - np.float32(f32(lo)))
        assert not random._sum_exact(s, f32(lo))
        u = random._unit_floats(random.key(seed, device="cpu"), (128,))
        once = random._fma32(u, s, f32(lo)).numpy().view(np.int32)
        wrong += int((once != _draws(seed, lo, lo + span)[1]).sum())
    assert wrong > 0


def test_usual_draws_keep_one_cast(monkeypatch):
    """The simulation's uniforms (integer bounds of the size classes,
    [0, 1), the normal's [nextafter(-1, 0), 1)) are exact in float64,
    so `uniform` never reaches `_fma32_odd` for them."""
    odd = random._fma32_odd

    def refuse(*a):
        raise AssertionError("rounded to odd")

    monkeypatch.setattr(random, "_fma32_odd", refuse)
    key = random.key(3, device="cpu")
    lo_n = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    sim = simulate.SimConfig()
    for lo, hi in ((0.0, 1.0), (lo_n, 1.0), (sim.small_lo, sim.small_hi),
                   (sim.small_hi, sim.medium_hi),
                   (sim.medium_hi, sim.large_hi), (-1e3, 1e3)):
        random.uniform(key, (64,), lo, hi)
    random.normal(key, (64,))
    assert random._sum_exact(1.0, 0.0) and random._sum_exact(0.0, 5.0)
    assert not random._sum_exact(3.0, 7.6e-33)
    torch.testing.assert_close(
        odd(torch.tensor([0.5], dtype=torch.float32), 3.0,
                          0.25), torch.tensor([1.75]))
