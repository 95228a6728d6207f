"""Parity of the port's flash attention (its plain version, which is what
runs on the CPU) with the JAX package's ``flash_attention`` — the Pallas
kernel in interpret mode, as the JAX package's own tests run it — and its
``attention_ref``, on the same numpy-made inputs.

Tolerances as the JAX tests state them: 2e-5 in float32 (the two sides
sum the products and the softmax in another order) and 2e-2 in bfloat16
(both round the f32 result to bf16 once; an element near a rounding
boundary may land one bf16 step apart).  The port's dispatch rules (CPU
tensors take the plain version; the tiles clamped on the SIMT route
alone; the CUDA wrapper refusing CPU tensors and naming its domain) are
checked here too; the kernel itself
runs only on the card (tests/test_torch_gpu.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_attention import kernel as fkernel
from repro_torch.kernels.flash_attention import ops as fops
from test_kernels import FLASH_CASES as JAX_FLASH_CASES
from torch_flash_cases import DANUBE_CASE, FLASH_CASES, flash_inputs

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _both(arrays, dtype: str):
    """The numpy arrays as JAX arrays and torch CPU tensors of the dtype
    named ``dtype`` (the same round-to-nearest-even casts)."""
    jx = [jnp.asarray(a).astype(dtype) for a in arrays]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tt


def _err(port: torch.Tensor, ref) -> float:
    return float(np.max(np.abs(port.float().numpy()
                               - np.asarray(ref, np.float32))))


def test_shared_cases_are_the_jax_tests_cases():
    assert FLASH_CASES == [(*c[:7], jnp.dtype(c[7]).name)
                           for c in JAX_FLASH_CASES]


@pytest.mark.parametrize("case", FLASH_CASES + [DANUBE_CASE],
                         ids=lambda c: "-".join(map(str, c)))
def test_plain_flash_matches_jax(case):
    b, s, h, kv, hd, win, ck, dtype = case
    (jq, jk, jv), (tq, tk, tv) = _both(flash_inputs(b, s, h, kv, hd, seed=s),
                                       dtype)
    out = flash_attention(tq, tk, tv, window=win, chunk=ck, block_q=32,
                          block_k=32)
    assert out.dtype == tq.dtype and out.shape == (b, s, h, hd)
    tol = TOL[dtype]
    want = jax_flash(jq, jk, jv, window=win, chunk=ck, block_q=32,
                     block_k=32)
    assert _err(out, want.astype("float32")) < tol, case
    ref = jax_ref(jq, jk, jv, window=win, chunk=ck)
    assert _err(out, ref.astype("float32")) < tol, case


def test_plain_flash_noncausal_ignores_window():
    b, s, h, hd = 2, 64, 4, 32
    (jq, jk, jv), (tq, tk, tv) = _both(flash_inputs(b, s, h, h, hd, seed=0),
                                       "float32")
    out = flash_attention(tq, tk, tv, causal=False, window=8, block_q=32,
                          block_k=32)
    want = jax_flash(jq, jk, jv, causal=False, block_q=32, block_k=32)
    assert _err(out, want) < 2e-5


def test_plain_flash_block_sweep():
    """Tile sizes must not change the math."""
    b, s, h, kv, hd = 1, 128, 4, 2, 32
    (jq, jk, jv), (tq, tk, tv) = _both(flash_inputs(b, s, h, kv, hd, seed=3),
                                       "float32")
    ref = jax_ref(jq, jk, jv)
    for bq, bk in [(16, 16), (32, 64), (64, 32), (64, 64)]:
        out = flash_attention(tq, tk, tv, block_q=bq, block_k=bk)
        assert _err(out, ref) < 2e-5, (bq, bk)


def test_plain_flash_is_global_disables_locality():
    b, s, h, kv, hd = 1, 64, 4, 2, 32
    (jq, jk, jv), (tq, tk, tv) = _both(flash_inputs(b, s, h, kv, hd, seed=4),
                                       "float32")
    out = flash_attention(tq, tk, tv, window=8, chunk=16, is_global=True,
                          block_q=32, block_k=32)
    assert _err(out, jax_ref(jq, jk, jv)) < 2e-5
    assert torch.equal(out, attention_ref(tq, tk, tv))


def test_dispatch_and_tile_checks():
    (jq, jk, jv), (tq, tk, tv) = _both(flash_inputs(1, 200, 4, 2, 32, seed=5),
                                       "float32")
    assert torch.equal(flash_attention(tq, tk, tv, window=40),
                       flash_attention_plain(tq, tk, tv, window=40))
    # the JAX package's default tiles (128, past the SIMT kernel's 64) run
    # on the CPU route as in the JAX function (Pallas interpret mode)
    out = flash_attention(tq, tk, tv, block_q=128, block_k=128)
    want = jax_flash(jq, jk, jv, block_q=128, block_k=128)
    assert _err(out, want) < TOL["float32"]
    assert torch.equal(out, flash_attention(tq, tk, tv))
    # a short sequence clamps the tile to max(8, S), as the JAX ops does
    short = [x[:, :40] for x in (tq, tk, tv)]
    assert torch.equal(flash_attention(*short, block_q=128, block_k=128),
                       attention_ref(*short))
    with pytest.raises(ValueError, match="no flash attention"):
        flash_attention(tq.to("meta"), tk.to("meta"), tv.to("meta"))


@pytest.mark.parametrize("s,tiles,want", [
    (200, (128, 128), (64, 64)), (200, (32, 128), (32, 64)),
    (40, (128, 128), (40, 40)), (4, (128, 16), (8, 8))])
def test_simt_route_clamps_tiles_to_its_kernel(s, tiles, want, monkeypatch):
    """The SIMT route alone has a tile limit: ``flash_attention`` clamps the
    tiles to the sequence as the JAX function does, then the SIMT route to
    the kernel's 64 rows; the CUDA wrapper is stubbed here."""
    seen = {}

    def record(q, k, v, **kw):
        seen.update(kw)
        return q
    monkeypatch.setattr(fops, "flash_attention_call", record)
    _, (tq, tk, tv) = _both(flash_inputs(1, s, 4, 2, 32, seed=s), "float32")
    fops._run(fops._simt, tq, tk, tv, block_q=tiles[0], block_k=tiles[1])
    assert (seen["block_q"], seen["block_k"]) == want
    assert max(want) <= fkernel.MAX_BLOCK


def test_kernel_wrapper_refuses_what_the_kernel_cannot_take():
    """The CUDA wrapper raises before any build or launch."""
    _, (tq, tk, tv) = _both(flash_inputs(1, 16, 2, 1, 32, seed=6),
                            "float32")
    kw = dict(causal=True, window=None, chunk=None, block_q=16, block_k=16)
    with pytest.raises(ValueError, match="CUDA device"):
        fkernel.flash_attention_call(tq, tk, tv, **kw)
    big = torch.zeros((1, 16, 2, 264))
    with pytest.raises(ValueError, match="head_dim=264"):
        fkernel.flash_attention_call(big, big[:, :, :1], big[:, :, :1], **kw)
    with pytest.raises(ValueError, match="multiple of KV"):
        fkernel.flash_attention_call(tq, torch.cat([tk] * 3, 2),
                                     torch.cat([tv] * 3, 2), **kw)
    with pytest.raises(TypeError, match="float16"):
        fkernel.flash_attention_call(tq.half(), tk.half(), tv.half(), **kw)
    # each domain limit names itself and the reference's lack of one
    with pytest.raises(TypeError, match="JAX reference has none"):
        fkernel.flash_attention_call(tq.half(), tk.half(), tv.half(), **kw)
    with pytest.raises(ValueError, match="JAX reference has none"):
        fkernel.flash_attention_call(big, big[:, :, :1], big[:, :, :1], **kw)
    with pytest.raises(ValueError, match="block_k=65"):
        fkernel.flash_attention_call(tq, tk, tv, **dict(kw, block_k=65))
