"""Threefry keys and draws, bit for bit those of the JAX package.

Counterpart of ``jax.random`` as the JAX package uses it, with jax's
defaults: the ``threefry2x32`` implementation and
``jax_threefry_partitionable=True`` (the split, fold_in and random-bits
forms of jax ``_src/prng.py``; the samplers of jax ``_src/random.py``).
A key is an int64 tensor ``(..., 2)`` holding the two uint32 words of
``jax.random.key_data(jax.random.key(seed))``; every function takes any
leading batch axes of keys, which replace the reference's ``vmap``, and
puts the draw's own shape after them.  Every hash goes through
`repro_torch.kernels.threefry`: the CUDA kernel for keys on the card,
the plain version for keys on the CPU.

* `key`, `split`, `fold_in`, `bits`, `randint`, `uniform`, `permutation`
  and `choice` give jax's values bit for bit.
* `normal` is ``sqrt(2) * erfinv(u)`` with XLA's single-precision
  ``ErfInv`` (Giles' polynomial, its multiply-adds rounded once as XLA's
  CPU backend contracts them), but ``log1p`` is not XLA's: the normal is
  held to jax's within a few ulp (`NORMAL_ULP`), not bit for bit.  The
  transcendental steps run in float64 and round to float32, so the draw
  is the same on the CPU and on the card and at every batch shape.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.threefry import ops as tops

MASK32 = 0xFFFFFFFF
INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1
F32, F64 = torch.float32, torch.float64
# The most ulp by which `normal` was seen to differ from jax.random.normal
# (tests/test_torch_random.py holds it there).
NORMAL_ULP = 3

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> tuple:
    return (int(shape),) if isinstance(shape, (int, np.integer)) \
        else tuple(int(d) for d in shape)


def key(seed: int, device="cuda") -> torch.Tensor:
    """``jax.random.key(seed)``'s data: ``(0, seed mod 2**32)`` as a (2,)
    int64 tensor, on the card unless ``device="cpu"``.  It is made on the
    device (``arange(2) * seed``), with no copy from the host."""
    return torch.arange(2, dtype=torch.int64,
                        device=resolve_device(device)) * (int(seed) & MASK32)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (..., 2) keys -> (..., num, 2)."""
    return tops.threefry_counters(keys, int(num))


def fold_in(keys: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` with an integer datum: (..., 2) keys ->
    (..., 2), the hash of the counter pair ``(0, data mod 2**32)``."""
    return tops.threefry_counters(keys, 1, int(data))[..., 0, :]


def bits(keys: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: (..., *shape) int64
    holding uint32, the xor of the two words of each counter's hash."""
    shape = _shape(shape)
    out = tops.threefry_counters(keys, math.prod(shape), xor=True)
    return out.reshape(tuple(keys.shape[:-1]) + shape)


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values taken mod 2**32 as the int32 of that bit pattern."""
    return (((x - INT32_MIN) & MASK32) + INT32_MIN).to(torch.int32)


def randint(keys: torch.Tensor, shape: Shape, minval: int, maxval: int,
            dtype=torch.int32) -> torch.Tensor:
    """``jax.random.randint`` with int32 sampling and integer bounds:
    (..., *shape) values in ``[minval, maxval)``.  Two 32-bit draws per
    value, ``(hi mod span) * mult + lo mod span`` in uint32 arithmetic,
    as the reference (biased where span is not a power of two, as
    there)."""
    shape = _shape(shape)
    out_of_range = maxval > INT32_MAX
    lo = min(max(int(minval), INT32_MIN), INT32_MAX)
    hi = min(max(int(maxval), INT32_MIN), INT32_MAX)
    span = (hi - lo) & MASK32 if hi > lo else 1
    if out_of_range and hi > lo:
        span = (span + 1) & MASK32
    if span == 0:
        raise ValueError(f"randint over [{minval}, {maxval}) spans 2**32 "
                         "values, which the uint32 remainder cannot take")
    # 2**32 mod span as the reference computes it: the square wraps in
    # uint32, so a span above 2**16 gets a multiplier of 0
    mult = (((2 ** 16 % span) ** 2) & MASK32) % span
    both = bits(split(keys), shape)            # (..., 2, *shape)
    axis = -1 - len(shape)
    higher, lower = both.select(axis, 0), both.select(axis, 1)
    h = higher % span
    if span * span < 2 ** 63:
        prod = (h * mult) & MASK32
    else:
        # (h * mult) mod 2**32 in two 16-bit halves of mult: no int64
        # product can overflow
        prod = (h * (mult & 0xFFFF)
                + (((h * (mult >> 16)) & 0xFFFF) << 16)) & MASK32
    offset = ((prod + lower % span) & MASK32) % span
    return _to_int32(offset + lo).to(dtype)


def _unit_floats(keys: torch.Tensor, shape: tuple) -> torch.Tensor:
    """Floats in [0, 1): 23 random mantissa bits under the exponent of
    1.0, minus 1 (the reference's ``_uniform``)."""
    b = bits(keys, shape)
    one_bits = ((b >> 9) | 0x3F800000).to(torch.int32)
    return one_bits.view(F32) - 1.0


def _f32(x: float) -> float:
    return float(np.float32(x))


def uniform(keys: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: (..., *shape) in
    ``[minval, maxval)``, ``max(minval, u * (maxval - minval) + minval)``
    with the multiply-add rounded once, as XLA's CPU backend computes
    it."""
    shape = _shape(shape)
    lo, hi = _f32(minval), _f32(maxval)
    span = _f32(np.float32(hi) - np.float32(lo))
    u = _unit_floats(keys, shape)
    # the product of two float32 values is exact in float64, so the sum
    # rounds twice (float64, then float32) where XLA's multiply-add
    # rounds once; the two differ only where the float64 sum lands on a
    # float32 tie, which the held draws never reach
    return torch.clamp_min((u.to(F64) * span + lo).to(F32), lo)


# XLA's ErfInv for float32 (M. Giles, "Approximating the erfinv
# function"): one polynomial in w, coefficients picked per element by
# whether w = -log1p(-x*x) is below 5.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``ErfInv`` for ``|x| < 1`` (what `normal` feeds it:
    the reference's ``|x| == 1`` branch is never reached).  ``log1p`` and
    ``sqrt`` are taken in float64 and rounded to float32; each step of the
    polynomial is a multiply-add rounded as `uniform`'s is."""
    w = -torch.log1p((-(x * x)).to(F64)).to(F32)
    lt = w < 5.0
    w64 = torch.where(lt, w - 2.5,
                      torch.sqrt(w.to(F64)).to(F32) - 3.0).to(F64)
    p = torch.where(lt, _f32(_ERFINV_LT5[0]), _f32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, _f32(a), _f32(b))
        p = torch.addcmul(c, p, w64).to(F32)
    return p * x


def normal(keys: torch.Tensor, shape: Shape = (),
           scale: float = 1.0) -> torch.Tensor:
    """``scale * jax.random.normal(key, shape)`` in float32: ``sqrt(2) *
    erfinv(u)`` with ``u`` uniform in ``[nextafter(-1, 0), 1)``, within
    `NORMAL_ULP` of jax's.  ``scale`` is folded into the constant first,
    ``(f32(scale) * f32(sqrt(2))) * erfinv(u)``, as XLA folds the two
    constant factors of ``scale * normal`` where it compiles them
    together (the reference's initial loads)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(keys, shape, lo, 1.0)
    return _f32(np.float32(scale) * np.float32(math.sqrt(2.0))) * \
        _erf_inv(u)


def permutation(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: (..., n) int64, a stable sort
    of ``arange(n)`` by fresh 32-bit keys, ``ceil(3 ln n / ln(2**32 - 1))``
    rounds (the reference's ``_shuffle``)."""
    lead = tuple(keys.shape[:-1])
    x = torch.arange(n, device=keys.device).expand(lead + (n,))
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(MASK32)))
    for _ in range(rounds):
        pair = split(keys)
        keys, sub = pair[..., 0, :], pair[..., 1, :]
        order = torch.sort(bits(sub, (n,)), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x


def choice(keys: torch.Tensor, n: int, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.choice(key, n, shape, replace=False)`` without
    weights: (..., *shape) distinct int64 indices into ``arange(n)``, the
    first entries of `permutation`."""
    shape = _shape(shape)
    k = math.prod(shape)
    if k > n:
        raise ValueError(f"cannot take {k} of {n} without replacement")
    lead = tuple(keys.shape[:-1])
    return permutation(keys, n)[..., :k].reshape(lead + shape)
