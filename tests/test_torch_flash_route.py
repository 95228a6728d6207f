"""The flash attention routes of the port, checked on the CPU.

`ops.flash_attention` sends a CUDA tensor to one of two kernels: the wgmma
kernel (``csrc/flash_attn_wgmma.cu``: bf16, head dim a multiple of 8 up to
256, tiles of 128 query and 64 key rows) or the SIMT kernel
(``csrc/flash_attn.cu``: everything else); a CPU tensor takes the plain
version.  Neither kernel runs here, so this file checks what can be
checked without the card:

* the routing table (`ops._route`);
* that the wgmma kernel's tile tests are exact: a plain-Python copy of
  its ``tile_live`` (the JAX kernel's whole-tile test at 128/64 for the
  block, 64/64 for a warpgroup) never skips a tile holding an allowed
  (row, col) pair, and its ``tile_needs_mask`` never leaves the mask off
  a tile holding a masked pair;
* that its one rounding change fits the existing tolerances: its
  arithmetic emulated in plain torch (bf16 operands, f32 scores scaled
  after the product, an online softmax over 64-key tiles with l summed
  from the f32 p, P.V taking p as its bf16 rounding plus the rest rounded
  to bf16) against the JAX package's
  ``attention_ref`` at the bf16 tolerance 2e-2, and inside the reduced
  gemma-2b prefill against the serve check's 0.02 of the largest |logit|;
* the wgmma wrapper's refusals and the build's one-file rule.

The kernels themselves are held against the plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import dataclasses
import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_ref
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as fkernel
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.models import transformer as T
from test_torch_models import GEN, _jax_prefill, _setup
from torch_flash_cases import DANUBE_CASE, FLASH_CASES, flash_inputs

BQ, BK, WG_ROWS = fkernel.WGMMA_TILES[0], fkernel.WGMMA_TILES[1], 64

# -- routing --------------------------------------------------------------

ROUTES = [(dt, hd, dev,
           "plain" if dev == "cpu" else
           "wgmma" if dt == "bfloat16" and hd % 8 == 0 else "simt")
          for dt, hd, dev in itertools.product(
              ("bfloat16", "float32"), (8, 16, 24, 64, 120, 128, 250, 256),
              ("cpu", "cuda"))]


@pytest.mark.parametrize("dtype,hd,device,route", ROUTES,
                         ids=lambda x: str(x))
def test_route_table(dtype, hd, device, route):
    assert fops._route(getattr(torch, dtype), hd, device) == route


def test_route_names_its_kernels_and_refuses_other_devices():
    assert fops._route(torch.float16, 64, "cuda") == "simt"
    assert fops._ROUTES["wgmma"] is fops._wgmma
    assert fops._ROUTES["simt"] is fops._simt
    with pytest.raises(ValueError, match="no flash attention"):
        fops._route(torch.bfloat16, 64, "meta")
    assert set(fkernel.LAUNCHES) == {"flash_attention_wgmma",
                                     "flash_attention_simt"}


# -- the wgmma kernel's tile tests -----------------------------------------
# plain-Python copies of flash_attn_wgmma.cu's tile_live, tile_needs_mask
# and the block's live range [lo, hi]


def tile_live(q_start, rows, k_start, causal, window, chunk):
    if not causal:
        return True
    live = k_start <= q_start + rows - 1
    if window:
        live = live and k_start + BK - 1 >= q_start - (window - 1)
    if chunk:
        live = live and k_start + BK - 1 >= (q_start // chunk) * chunk
    return live


def tile_needs_mask(q_start, rows, k_start, s, causal, window, chunk):
    q_end, k_end = q_start + rows - 1, k_start + BK - 1
    if k_end >= s:
        return True
    if not causal:
        return False
    if k_end > q_start:
        return True
    if window and q_end - k_start >= window:
        return True
    if chunk and k_start // chunk != q_end // chunk:
        return True
    return False


def live_range(q_block, s, causal, window, chunk):
    lo, hi = 0, -(-s // BK) - 1
    while lo <= hi and not tile_live(q_block, BQ, lo * BK, causal, window,
                                     chunk):
        lo += 1
    while hi >= lo and not tile_live(q_block, BQ, hi * BK, causal, window,
                                     chunk):
        hi -= 1
    return lo, hi


def allowed_pairs(s, causal, window, chunk):
    rows = np.arange(s)[:, None]
    cols = np.arange(s)[None, :]
    ok = np.ones((s, s), bool)
    if causal:
        ok &= cols <= rows
        if window:
            ok &= rows - cols < window
        if chunk:
            ok &= rows // chunk == cols // chunk
    return ok


# (causal, window, chunk, is_global): ops clears window and chunk under
# is_global before the kernel sees them
MASKS = ([(True, None, None, False), (False, 8, None, False)]
         + [(True, w, None, False) for w in (1, 7, 64, 65, 100, 129, 300)]
         + [(True, None, c, False) for c in (16, 64, 100, 128, 200, 256)]
         + [(True, 50, 64, False), (True, 64, 16, True)])


@pytest.mark.parametrize("s", [1, 63, 127, 130, 1000])
@pytest.mark.parametrize("causal,window,chunk,is_global", MASKS,
                         ids=lambda x: str(x))
def test_wgmma_tile_tests_are_exact(s, causal, window, chunk, is_global):
    if is_global:
        window = chunk = None
    ok = allowed_pairs(s, causal, window, chunk)
    covered = np.zeros_like(ok)
    for q_block in range(0, s, BQ):
        lo, hi = live_range(q_block, s, causal, window, chunk)
        for kt in range(-(-s // BK)):
            cols = slice(kt * BK, kt * BK + BK)
            if not lo <= kt <= hi:    # skipped by the block
                assert not ok[q_block:q_block + BQ, cols].any(), (q_block, kt)
                continue
            assert tile_live(q_block, BQ, kt * BK, causal, window, chunk)
            for q_wg in (q_block, q_block + WG_ROWS):
                if q_wg >= s:          # a warpgroup with no real row
                    continue
                rows = slice(q_wg, q_wg + WG_ROWS)
                if not tile_live(q_wg, WG_ROWS, kt * BK, causal, window,
                                 chunk):
                    assert not ok[rows, cols].any(), (q_wg, kt)
                    continue
                covered[rows, cols] = True
                if not tile_needs_mask(q_wg, WG_ROWS, kt * BK, s, causal,
                                       window, chunk):
                    assert ok[rows, cols].all(), (q_wg, kt)
    assert covered[ok].all()


# -- the one rounding change ------------------------------------------------


def wgmma_route_emulated(q, k, v, *, causal=True, window=None, chunk=None,
                         block_q=None, block_k=None):
    """The wgmma kernel's arithmetic in plain torch, under the kernels'
    signature: bf16 q, k, v; f32 scores (exact bf16 products summed in
    f32) scaled by 1/sqrt(hd) after the product; an online softmax over
    key tiles of 64 rows with m, l and acc in f32 and l summed from the
    f32 p; P.V as two bf16 products, p's bf16 rounding and the rest
    (p less it) rounded to bf16; the output rounded to q's dtype."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qf = q.float().reshape(b, s, kvh, g, hd)
    kf, vf = k.float(), v.float()
    scale = torch.tensor(1.0 / hd ** 0.5, dtype=torch.float32)
    rows = torch.arange(s)[:, None]
    m = torch.full((b, kvh, g, s), NEG_INF)
    l = torch.zeros((b, kvh, g, s))
    acc = torch.zeros((b, kvh, g, s, hd))
    for k0 in range(0, s, BK):
        sc = torch.einsum("bqkgh,bskh->bkgqs", qf, kf[:, k0:k0 + BK]) * scale
        cols = torch.arange(k0, min(k0 + BK, s))[None, :]
        ok = torch.ones((s, cols.shape[1]), dtype=torch.bool)
        if causal:
            ok &= cols <= rows
            if window is not None:
                ok &= rows - cols < window
            if chunk is not None:
                ok &= rows // chunk == cols // chunk
        sc = sc.masked_fill(~ok, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        live = m_new > NEG_INF / 2
        alpha = torch.where(live, torch.exp(m - m_new), 1.0)
        p = torch.where(live[..., None], torch.exp(sc - m_new[..., None]),
                        0.0)
        l = l * alpha + p.sum(-1)
        hi = p.bfloat16().float()
        rest = (p - hi).bfloat16().float()
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bskh->bkgqh", hi + rest, vf[:, k0:k0 + BK])
        m = m_new
    out = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).to(q.dtype)


# the emulation behind ops' dispatch (is_global, tile clamps), as the
# kernel sits there
emulated_flash_attention = functools.partial(fops._run, wgmma_route_emulated)


@pytest.mark.parametrize("case", FLASH_CASES + [
    DANUBE_CASE, (2, 200, 8, 1, 64, None, None, "float32"),
    (1, 130, 8, 1, 256, None, None, "float32")],
    ids=lambda c: "-".join(map(str, c[:7])))
def test_bf16_p_emulation_matches_jax_ref(case):
    b, s, h, kv, hd, win, ck, _ = case
    arrays = flash_inputs(b, s, h, kv, hd, seed=s + 7)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    jq, jk, jv = (jnp.asarray(a).astype("bfloat16") for a in arrays)
    got = wgmma_route_emulated(tq, tk, tv, window=win, chunk=ck)
    want = np.asarray(jax_ref(jq, jk, jv, window=win, chunk=ck)
                      .astype("float32"))
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() < 2e-2, case


def test_bf16_p_emulation_matches_jax_ref_noncausal():
    arrays = flash_inputs(2, 100, 4, 2, 32, seed=11)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    jq, jk, jv = (jnp.asarray(a).astype("bfloat16") for a in arrays)
    got = wgmma_route_emulated(tq, tk, tv, causal=False)
    want = np.asarray(jax_ref(jq, jk, jv, causal=False).astype("float32"))
    assert np.abs(got.float().numpy() - want).max() < 2e-2


def test_bf16_p_emulation_in_reduced_gemma_prefill(monkeypatch):
    """The reduced gemma-2b prefill in bf16 compute with the emulated
    route in the flash kernel's place, against the JAX package's bf16
    prefill (its flash kernel in Pallas interpret): within 0.02 of the
    largest |logit| of the JAX f32 prefill, the serve check's bound."""
    want, _ = _jax_prefill("gemma-2b", "bfloat16")
    scale = float(np.abs(np.asarray(
        _jax_prefill("gemma-2b", "float32")[0], np.float32)).max())
    _, _, tcfg, tparams, prompts = _setup("gemma-2b", "bfloat16")
    monkeypatch.setattr(fops, "flash_attention", emulated_flash_attention)
    got, _ = T.forward_prefill(
        tparams, {"tokens": torch.from_numpy(prompts)},
        dataclasses.replace(tcfg, use_pallas_attn=True),
        cache_len=prompts.shape[1] + GEN)
    err = np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
    assert err <= 0.02 * scale, (err, scale)


def test_bf16_p_emulation_in_longer_gemma_forward(monkeypatch):
    """Over several key tiles (S = 200): the reduced gemma-2b forward in
    bf16 compute, emulated route against `attention_ref` in its place,
    within 0.02 of the largest |logit| of the f32 forward."""
    _, _, tcfg, tparams, _ = _setup("gemma-2b", "bfloat16")
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        1, tcfg.vocab_size, (2, 200)))
    cfg = dataclasses.replace(tcfg, use_pallas_attn=True)
    with torch.no_grad():   # the flash route is a forward-only route
        scale = T.forward_train(
            tparams, {"tokens": prompts},
            dataclasses.replace(cfg, compute_dtype="float32")
        ).abs().max().item()
        want = T.forward_train(tparams, {"tokens": prompts}, cfg).float()
        monkeypatch.setattr(fops, "flash_attention",
                            emulated_flash_attention)
        got = T.forward_train(tparams, {"tokens": prompts}, cfg).float()
    assert (got - want).abs().max().item() <= 0.02 * scale


# -- the wgmma wrapper and the build ----------------------------------------


def test_wgmma_wrapper_refuses_what_the_kernel_cannot_take():
    """The wrapper raises before any build or launch."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in flash_inputs(1, 16, 2, 1, 32, seed=6))
    kw = dict(causal=True, window=None, chunk=None)
    with pytest.raises(ValueError, match="CUDA device"):
        fkernel.flash_attention_wgmma_call(q, k, v, **kw)
    with pytest.raises(TypeError, match="bfloat16"):
        fkernel.flash_attention_wgmma_call(q.float(), k.float(), v.float(),
                                           **kw)
    odd = torch.zeros((1, 16, 2, 250), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        fkernel.flash_attention_wgmma_call(odd, odd[:, :, :1], odd[:, :, :1],
                                           **kw)
    big = torch.zeros((1, 16, 2, 264), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim=264"):
        fkernel.flash_attention_wgmma_call(big, big[:, :, :1], big[:, :, :1],
                                           **kw)
    with pytest.raises(ValueError, match="multiple of KV"):
        fkernel.flash_attention_wgmma_call(q, torch.cat([k] * 3, 2),
                                           torch.cat([v] * 3, 2), **kw)
    with pytest.raises(ValueError, match="window=0"):
        fkernel.flash_attention_wgmma_call(q, k, v, **dict(kw, window=0))


def test_build_names_each_source_by_its_own_bytes(tmp_path):
    names = {_build.library_path(src).name
             for src in (fkernel.SOURCE, fkernel.WGMMA_SOURCE)}
    assert len(names) == 2
    src = tmp_path / "k.cu"
    src.write_text("// a kernel\n#include <cuda_runtime.h>\n")
    first = _build.library_path(src)
    src.write_text("// a kernel, edited\n#include <cuda_runtime.h>\n")
    assert _build.library_path(src) != first
    src.write_text('#include <cuda_runtime.h>\n  # include "common.cuh"\n')
    with pytest.raises(ValueError, match="local header"):
        _build.library_path(src)
