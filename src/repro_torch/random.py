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
  ``ErfInv`` and ``log1p`` as its CPU backend compiles ``jax.random.normal``
  (Giles' polynomial for ``erfinv``; a rational for small ``|x|`` and
  XLA's own ``log`` polynomial for ``log1p``), each multiply-add rounded
  once where that backend contracts it: jax's values bit for bit.  The
  multiply-adds, the division and the square root run in float64 and
  round to float32 (`_fma32`), so the draw is the same on the CPU and on
  the card and at every batch shape.
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
# The most ulp by which `normal` may differ from jax.random.normal
# (tests/test_torch_random.py holds it there): none.
NORMAL_ULP = 0

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


def _fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """Float32 ``a * b + c`` as XLA's CPU backend computes a multiply-add it
    contracts: ``a`` and ``b`` are float32 (tensors or numbers), so their
    product is exact in float64, and the float64 sum is rounded to
    float32.  That is the single rounding of the exact value where the
    float64 sum is exact; where it is not, it may round twice (a float64
    sum that lands on a float32 tie the exact sum is not on).  The
    polynomials below keep it (`normal` is held bit for bit over 10**6
    draws); `uniform` takes `_fma32_odd` where its sum can round
    (`_sum_exact`)."""
    return (a.to(F64) * b + c).to(F32)


def _fma32_odd(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """`_fma32` rounded once whatever the float64 sum: the sum ``s`` of
    the exact product and ``c``, its error ``e`` by Knuth's two-sum (``s +
    e`` is the exact value), then ``s`` rounded to odd (moved one float64
    ulp towards ``e`` where ``e != 0`` and its last bit is even), then to
    float32.  53 bits rounded to odd, then to 24, is one correct
    rounding."""
    p = a.to(F64) * b
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, math.inf, -math.inf).to(F64)
    s = torch.where((e != 0) & even, torch.nextafter(s, toward), s)
    return s.to(F32)


def _exponents(x: float) -> tuple:
    """(e, u) of a nonzero float32 ``x``: ``|x| < 2**e`` and ``x`` a
    multiple of ``2**u`` (its ulp; ``2**-149`` below the normal range)."""
    e = math.frexp(x)[1]
    return e, max(e - 24, -149)


def _sum_exact(span: float, lo: float) -> bool:
    """Is the float64 sum ``u * span + lo`` exact for every unit float
    ``u`` (a multiple of ``2**-23`` below 1): the product a multiple of
    ``2**(u_span - 23)`` below ``2**e_span``, so the sum needs at most
    ``max(e_span, e_lo) + 1 - min(u_span - 23, u_lo)`` bits.  Decided on
    the host, once a draw."""
    if span == 0.0 or lo == 0.0:
        return True
    (es, us), (el, ul) = _exponents(span), _exponents(lo)
    return max(es, el) + 1 - min(us - 23, ul) <= 53


def uniform(keys: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: (..., *shape) in
    ``[minval, maxval)``, ``max(minval, u * (maxval - minval) + minval)``
    with the multiply-add rounded once, as XLA's CPU backend computes
    it: the float64 sum's one cast where it is exact (`_sum_exact`: every
    draw of the simulation), else rounded to odd first (`_fma32_odd`)."""
    shape = _shape(shape)
    lo, hi = _f32(minval), _f32(maxval)
    span = _f32(np.float32(hi) - np.float32(lo))
    u = _unit_floats(keys, shape)
    fma = _fma32 if _sum_exact(span, lo) else _fma32_odd
    return torch.clamp_min(fma(u, span, lo), lo)


# XLA's ErfInv for float32 (M. Giles, "Approximating the erfinv
# function"): one polynomial in w, coefficients picked per element by
# whether w = -log1p(-x*x) is below 5.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


# XLA's float32 log1p: a rational p(x)/q(x) for |x| < sqrt(2) - 1 (both
# in Horner form from the highest power; q's leading coefficient is 1),
# else XLA's log of 1 + x (Cephes' logf: a mantissa in [sqrt(1/2),
# sqrt(2)) and a degree-9 polynomial in three interleaved chains).
_LOG1P_SMALL = 0.4142135679721832
_LOG1P_P = (4.527000055531971e-05, 0.4985410273075104, 6.578732490539551,
            29.91191864013672, 60.949668884277344, 57.11296463012695,
            20.039552688598633)
_LOG1P_Q = (1.0, 15.062909126281738, 83.04756927490234, 221.7624053955078,
            309.0987243652344, 216.42788696289062, 60.11865997314453)
_LOG_CHAINS = ((0.07037683576345444, -0.11514610052108765,
                0.11676998436450958),
               (-0.12420140951871872, 0.14249323308467865,
                -0.16668057441711426),
               (0.2000071406364441, -0.24999994039535522,
                0.3333333134651184))
_LOG_SQRT_HALF = 0.7071067690849304
_LOG_E_LO, _LOG_E_HI = -0.00021219444170128554, 0.693359375
_MIN_NORMAL = 1.1754943508222875e-38


def _log_f32(y: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log`` for finite ``y > 0`` (what `_log1p` feeds
    it), its multiply-adds contracted as XLA's CPU backend contracts
    them: the polynomial's tail as ``t * x^3 + e * c_lo``, the product
    ``e * c_lo`` rounded first."""
    b = torch.clamp_min(y, _MIN_NORMAL).view(torch.int32)
    e = ((b >> 23) - 127).to(F32) + 1.0
    m = ((b & 0x7FFFFF) | 0x3F000000).view(F32)      # mantissa in [0.5, 1)
    low = m < _LOG_SQRT_HALF
    x = (m - 1.0) + torch.where(low, m, 0.0)
    e = e - torch.where(low, 1.0, 0.0)
    z = x * x
    z3 = z * x
    a, bq, c = ((_fma32(_fma32(x, k0, k1), x, k2) for k0, k1, k2 in
                 _LOG_CHAINS))
    t = _fma32(_fma32(_fma32(a, z3, bq), z3, c), z3, e * _LOG_E_LO)
    return _fma32(e, _LOG_E_HI, _fma32(-z, 0.5, x) + t)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p`` for ``-1 < x <= 0`` (what `_erf_inv` feeds
    it).  The small branch is ``x + (-0.5 * x^2 + (x * x^2) * p/q)``, its
    last multiply-add contracted on ``x^2``; the quotient is correctly
    rounded, as the CPU's division is."""
    x2 = x * x
    p = torch.full_like(x, _f32(_LOG1P_P[0]))
    q = torch.ones_like(x)
    for cp, cq in zip(_LOG1P_P[1:], _LOG1P_Q[1:]):
        p, q = _fma32(p, x, cp), _fma32(q, x, cq)
    ratio = (p.to(F64) / q.to(F64)).to(F32)
    small = x + _fma32(x2, -0.5, (x * x2) * ratio)
    return torch.where(x.abs() < _LOG1P_SMALL, small, _log_f32(x + 1.0))


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``ErfInv`` for ``|x| < 1`` (what `normal` feeds it:
    the reference's ``|x| == 1`` branch is never reached).  ``sqrt`` is
    taken in float64 and rounded to float32; each step of the polynomial
    is a multiply-add as `_fma32` rounds it."""
    w = -_log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w.to(F64)).to(F32) - 3.0)
    p = torch.where(lt, _f32(_ERFINV_LT5[0]), _f32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma32(p, w, torch.where(lt, _f32(a), _f32(b)))
    return p * x


def normal(keys: torch.Tensor, shape: Shape = (),
           scale: float = 1.0) -> torch.Tensor:
    """``scale * jax.random.normal(key, shape)`` in float32: ``sqrt(2) *
    erfinv(u)`` with ``u`` uniform in ``[nextafter(-1, 0), 1)``, jax's
    values bit for bit.  ``scale`` is folded into the constant first,
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
