"""State-space / recurrent blocks: Mamba (selective SSM), mLSTM, sLSTM.

The port's counterpart of the JAX package's ``models/ssm.py``, with the
same names.  The JAX package runs every scan as ``lax.scan``; the port
runs them as Python loops over time (Mamba, sLSTM, the sequential mLSTM)
or over chunks (the chunkwise mLSTM), each step the same tensor
arithmetic in the same order and dtypes:

* **Mamba**: the causal depthwise conv sums ``xc[:, i:i+t] * w[i]`` from
  0 in the activations' dtype (so it rounds in bf16 at bf16 compute); the
  dt projection runs in float32 with ``dt_proj`` cast to float32; the
  scan carries ``h`` (B, inner, d_state) in float32.  Decode is the
  single-step form with the carried conv context.
* **mLSTM**: the matrix-memory LSTM (gated linear attention), sequential
  when ``t == 1`` or ``t`` is no multiple of the chunk, else chunkwise
  (intra-chunk products and an inter-chunk (hd x hd) state carry); both
  share the xLSTM stabilizer m, so they agree to float tolerance.  The
  max reductions are ``torch.amax``, which splits the gradient evenly
  over ties as ``jnp.max`` does.
* **sLSTM**: scalar memory with exponential gating and a block-diagonal
  recurrence, in float32, gates in the order i, f, z, o.

No kernel of the JAX package lies under this module (it reaches no
``pl.pallas_call``), and the port writes none for it.  Every ``init_*``
draws from an explicit ``torch.Generator`` onto an explicit device; the
draws differ from the JAX package's threefry, so tests carry its
parameters across (`interop.lm_params_from_numpy`).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = Dict[str, torch.Tensor]
# the roles of an mLSTM (H, hd, hd) projection gathered at use
QKV_ROLES = [None, None, "model"]

F32 = torch.float32


def _inv_sqrt(n: int) -> float:
    """``1 / sqrt(n)`` as the JAX package computes it: both in float32."""
    root = torch.sqrt(torch.tensor(float(n), dtype=F32))
    return float(torch.tensor(1.0, dtype=F32) / root)


# ===========================================================================
# Mamba (selective SSM, diagonal state)
# ===========================================================================

def mamba_dims(cfg: ModelConfig) -> Tuple[int, int]:
    inner = cfg.ssm.expand * cfg.d_model
    dt_rank = cfg.ssm.dt_rank or -(-cfg.d_model // 16)
    return inner, dt_rank


def init_mamba(gen: Optional[torch.Generator], cfg: ModelConfig,
               device=None) -> Params:
    """Draws in the order in_proj, conv_w, x_proj, dt_proj, dt_bias,
    out_proj."""
    d, s = cfg.d_model, cfg.ssm
    inner, dtr = mamba_dims(cfg)
    pd = cfg.pdtype
    he = lambda shape, fan: L.he_init(gen, shape, pd, fan_in=fan,
                                      device=device)
    in_proj = he((d, 2 * inner), d)
    conv_w = he((s.d_conv, inner), s.d_conv)
    x_proj = he((inner, dtr + 2 * s.d_state), inner)
    dt_proj = he((dtr, inner), dtr)
    # softplus^-1 of U(1e-3, 1e-1)
    u = torch.rand((inner,), generator=gen, dtype=F32, device=device)
    dt_bias = torch.log(torch.expm1(u * (1e-1 - 1e-3) + 1e-3))
    # S4D-real initialization for A
    a = torch.arange(1, s.d_state + 1, dtype=F32, device=device)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "x_proj": x_proj,
        "dt_proj": dt_proj,
        "dt_bias": dt_bias,
        "A_log": torch.log(a).expand(inner, s.d_state).contiguous(),
        "D": torch.ones((inner,), dtype=F32, device=device),
        "out_proj": he((inner, d), inner),
    }


class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, d_conv-1, inner) last inputs for the causal conv
    ssm: torch.Tensor   # (B, inner, d_state) fp32


def init_mamba_state(cfg: ModelConfig, batch: int, device=None
                     ) -> MambaState:
    inner, _ = mamba_dims(cfg)
    return MambaState(
        conv=torch.zeros((batch, cfg.ssm.d_conv - 1, inner),
                         dtype=cfg.cdtype, device=device),
        ssm=torch.zeros((batch, inner, cfg.ssm.d_state), dtype=F32,
                        device=device))


def _mamba_inner(p: Params, xz: torch.Tensor, cfg: ModelConfig,
                 state: Optional[MambaState]
                 ) -> Tuple[torch.Tensor, MambaState]:
    """Core selective scan. xz: (B, S, 2*inner) already projected."""
    s = cfg.ssm
    inner, dtr = mamba_dims(cfg)
    b, t, _ = xz.shape
    x, z = torch.chunk(xz, 2, dim=-1)

    # causal depthwise conv (window d_conv) with carried context
    conv_ctx = (state.conv if state is not None
                else torch.zeros((b, s.d_conv - 1, inner), dtype=x.dtype,
                                 device=x.device))
    xc = torch.cat([conv_ctx, x], dim=1)                    # (B, T+dc-1, in)
    w = L.cast_to(p["conv_w"], x.dtype)                     # (dc, inner)
    xconv = 0
    for i in range(s.d_conv):     # from 0, in x.dtype, as Python's sum()
        xconv = xconv + xc[:, i:i + t, :] * w[i]
    new_conv = (xc[:, t:, :] if t >= s.d_conv - 1
                else xc[:, -(s.d_conv - 1):, :])
    xs = F.silu(xconv)

    # input-dependent dt, B, C
    proj = xs @ L.wcast(p, "x_proj", cfg, ["model", None])  # (B,T,dtr+2N)
    dt, bmat, cmat = torch.split(proj, [dtr, s.d_state, s.d_state], dim=-1)
    dt = F.softplus(dt.float() @ p["dt_proj"].float() + p["dt_bias"])
    a = -torch.exp(p["A_log"])                              # (inner, N)
    bmat = bmat.float()
    cmat = cmat.float()
    xs32 = xs.float()

    h = (state.ssm if state is not None
         else torch.zeros((b, inner, s.d_state), dtype=F32, device=xz.device))
    ys = []
    for i in range(t):
        dt_t, b_t, c_t, x_t = dt[:, i], bmat[:, i], cmat[:, i], xs32[:, i]
        da = torch.exp(dt_t[..., None] * a)                 # (B,in,N)
        dbx = (dt_t * x_t)[..., None] * b_t[:, None, :]     # (B,in,N)
        h = da * h + dbx
        ys.append(torch.einsum("bin,bn->bi", h, c_t))       # (B,in)
    y = torch.stack(ys, dim=1) + xs32 * p["D"]              # (B,T,inner)
    y = y.to(xz.dtype) * F.silu(z)
    return y, MambaState(conv=new_conv, ssm=h)


def apply_mamba(p: Params, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[MambaState] = None
                ) -> Tuple[torch.Tensor, MambaState]:
    """x: (B, S, d) -> (B, S, d). ``state`` enables decode continuation."""
    xz = L.cast_to(x, cfg.cdtype) @ L.wcast(p, "in_proj", cfg,
                                            [None, "model"])
    y, new_state = _mamba_inner(p, xz, cfg, state)
    return y @ L.wcast(p, "out_proj", cfg, ["model", None]), new_state


# ===========================================================================
# mLSTM (matrix memory; chunkwise-parallel = gated linear attention)
# ===========================================================================

def mlstm_dims(cfg: ModelConfig) -> Tuple[int, int]:
    inner = 2 * cfg.d_model
    hd = inner // cfg.n_heads
    return inner, hd


def init_mlstm(gen: Optional[torch.Generator], cfg: ModelConfig,
               device=None) -> Params:
    """Draws in the order up_proj, wq, wk, wv, w_i, w_f, down_proj."""
    d = cfg.d_model
    inner, hd = mlstm_dims(cfg)
    h = cfg.n_heads
    pd = cfg.pdtype
    he = lambda shape, dtype, fan: L.he_init(gen, shape, dtype, fan_in=fan,
                                             device=device)
    return {
        "up_proj": he((d, 2 * inner), pd, d),
        # q,k,v as block-diagonal per head: (H, hd, hd)
        "wq": he((h, hd, hd), pd, hd),
        "wk": he((h, hd, hd), pd, hd),
        "wv": he((h, hd, hd), pd, hd),
        # per-dim gate projections from the block input
        "w_i": he((inner, h), F32, inner),
        "w_f": he((inner, h), F32, inner),
        "b_i": torch.zeros((h,), dtype=F32, device=device),
        "b_f": torch.full((h,), 3.0, dtype=F32, device=device),
        "ln_scale": torch.zeros((inner,), dtype=F32, device=device),
        "down_proj": he((inner, d), pd, inner),
    }


class MLSTMState(NamedTuple):
    c: torch.Tensor  # (B, H, hd, hd) fp32 matrix memory
    n: torch.Tensor  # (B, H, hd) normalizer
    m: torch.Tensor  # (B, H) log-space stabilizer


def init_mlstm_state(cfg: ModelConfig, batch: int, device=None
                     ) -> MLSTMState:
    _, hd = mlstm_dims(cfg)
    h = cfg.n_heads
    return MLSTMState(
        c=torch.zeros((batch, h, hd, hd), dtype=F32, device=device),
        n=torch.zeros((batch, h, hd), dtype=F32, device=device),
        m=torch.full((batch, h), -1e30, dtype=F32, device=device))


def _mlstm_gates(p: Params, xin: torch.Tensor):
    """log input/forget gate pre-activations. xin: (B,T,inner) ->
    li, lf: (B,T,H) fp32."""
    xf = xin.float()
    li = xf @ p["w_i"] + p["b_i"]
    lf = F.logsigmoid(xf @ p["w_f"] + p["b_f"])
    return li, lf


def mlstm_sequential(q, k, v, li, lf, state: MLSTMState
                     ) -> Tuple[torch.Tensor, MLSTMState]:
    """Reference recurrence. q,k,v: (B,T,H,hd); li,lf: (B,T,H)."""
    scale = _inv_sqrt(q.shape[-1])
    q, k, v, li, lf = (a.float() for a in (q, k, v, li, lf))
    c, n, m = state
    ys = []
    for t in range(q.shape[1]):
        qt, kt, vt, lit, lft = q[:, t], k[:, t], v[:, t], li[:, t], lf[:, t]
        m_new = torch.maximum(lft + m, lit)
        fp = torch.exp(lft + m - m_new)
        ip = torch.exp(lit - m_new)
        kts = kt * scale
        c = fp[..., None, None] * c + ip[..., None, None] * \
            torch.einsum("bhk,bhv->bhkv", kts, vt)
        n = fp[..., None] * n + ip[..., None] * kts
        num = torch.einsum("bhk,bhkv->bhv", qt, c)
        den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", qt, n)),
                            torch.exp(-m_new))
        ys.append(num / den[..., None])
        m = m_new
    return torch.stack(ys, dim=1), MLSTMState(c, n, m)


def mlstm_chunkwise(q, k, v, li, lf, state: MLSTMState, chunk: int
                    ) -> Tuple[torch.Tensor, MLSTMState]:
    """Chunkwise-parallel mLSTM, exact w.r.t. the sequential form.

    Shapes as in :func:`mlstm_sequential`; T must be a multiple of chunk.
    """
    b, t, h, hd = q.shape
    if t % chunk:
        raise ValueError(f"T={t} is no multiple of chunk={chunk}")
    nc = t // chunk
    scale = _inv_sqrt(hd)

    def resh(a):
        return a.float().reshape(b, nc, chunk, *a.shape[2:])

    qc, kc, vc, lic, lfc = map(resh, (q, k, v, li, lf))     # (B,nc,L,H,...)
    lq = torch.arange(chunk, device=q.device)
    causal = (lq[:, None] >= lq[None, :])[None, :, :, None]
    c, n, m = state
    ys = []
    for j in range(nc):
        qt, kt, vt, lit, lft = (a[:, j] for a in (qc, kc, vc, lic, lfc))
        kt = kt * scale
        bcum = torch.cumsum(lft, dim=1)                     # (B,L,H) sum lf
        btot = bcum[:, -1]                                  # (B,H)
        # row stabilizers
        g = bcum + m[:, None, :]                            # (B,L,H) inter
        a_mat = (bcum[:, :, None, :] - bcum[:, None, :, :]
                 + lit[:, None, :, :])                      # (B,Lq,Ls,H)
        a_mat = torch.where(causal, a_mat, -math.inf)
        a_max = torch.amax(a_mat, dim=2)                    # (B,L,H)
        m_t = torch.maximum(g, a_max)                       # (B,L,H)

        inter_w = torch.exp(g - m_t)                        # (B,L,H)
        intra_w = torch.exp(a_mat - m_t[:, :, None, :])     # (B,Lq,Ls,H)
        s_qk = torch.einsum("blhk,bshk->blsh", qt, kt)      # (B,Lq,Ls,H)
        w = intra_w * s_qk
        num = (torch.einsum("blsh,bshv->blhv", w, vt)
               + inter_w[..., None] * torch.einsum("blhk,bhkv->blhv", qt, c))
        den_intra = torch.sum(w, dim=2)                     # (B,L,H)
        den_inter = inter_w * torch.einsum("blhk,bhk->blh", qt, n)
        den = torch.maximum(torch.abs(den_intra + den_inter),
                            torch.exp(-m_t))
        ys.append(num / den[..., None])                     # (B,L,H,hd)

        # chunk-final state
        m_out = torch.maximum(btot + m, torch.amax(
            btot[:, None] - bcum + lit, dim=1))
        carry_w = torch.exp(btot + m - m_out)               # (B,H)
        in_w = torch.exp(btot[:, None] - bcum + lit - m_out[:, None])
        c = (carry_w[..., None, None] * c
             + torch.einsum("blhk,blhv->bhkv", in_w[..., None] * kt, vt))
        n = carry_w[..., None] * n + torch.einsum("blh,blhk->bhk", in_w, kt)
        m = m_out
    return torch.stack(ys, dim=1).reshape(b, t, h, hd), MLSTMState(c, n, m)


def apply_mlstm(p: Params, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[MLSTMState] = None,
                chunk: Optional[int] = None
                ) -> Tuple[torch.Tensor, MLSTMState]:
    """Full mLSTM block body (pre-norm residual handled by caller).

    x: (B, S, d) -> (B, S, d).
    """
    b, t, d = x.shape
    inner, hd = mlstm_dims(cfg)
    h = cfg.n_heads
    cdt = cfg.cdtype
    up = L.cast_to(x, cdt) @ L.wcast(p, "up_proj", cfg, [None, "model"])
    xin, z = torch.chunk(up, 2, dim=-1)                     # (B,T,inner)x2
    xh = xin.reshape(b, t, h, hd)
    q = torch.einsum("bthi,hij->bthj", xh, L.wcast(p, "wq", cfg, QKV_ROLES))
    k = torch.einsum("bthi,hij->bthj", xh, L.wcast(p, "wk", cfg, QKV_ROLES))
    v = torch.einsum("bthi,hij->bthj", xh, L.wcast(p, "wv", cfg, QKV_ROLES))
    li, lf = _mlstm_gates(p, xin)
    if state is None:
        state = init_mlstm_state(cfg, b, x.device)
    ck = chunk or cfg.ssm.chunk
    if t == 1 or t % ck != 0:
        y, state = mlstm_sequential(q, k, v, li, lf, state)
    else:
        y, state = mlstm_chunkwise(q, k, v, li, lf, state, ck)
    y = y.reshape(b, t, inner)
    # per-dim RMS "group norm" then gate
    yn = L.apply_norm("rmsnorm", {"scale": p["ln_scale"]}, y.to(cdt))
    out = (yn * F.silu(z)) @ L.wcast(p, "down_proj", cfg,
                                     ["model", None])
    return out, state


# ===========================================================================
# sLSTM (scalar memory, exponential gating, block-diagonal recurrence)
# ===========================================================================

def init_slstm(gen: Optional[torch.Generator], cfg: ModelConfig,
               device=None) -> Params:
    """Draws in the order w, r, ff_in, ff_out."""
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    ff = -(-4 * d // 3)
    pd = cfg.pdtype
    he = lambda shape, fan: L.he_init(gen, shape, pd, fan_in=fan,
                                      device=device)
    w = he((d, 4 * d), d)                                   # i,f,z,o
    r = he((h, dh, 4 * dh), dh)
    bias = torch.cat([torch.zeros((d,), dtype=F32, device=device),
                      torch.full((d,), 3.0, dtype=F32, device=device),
                      torch.zeros((2 * d,), dtype=F32, device=device)])
    return {"w": w, "b": bias, "r": r, "ff_in": he((d, ff), d),
            "ff_out": he((ff, d), ff)}


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, d)
    n: torch.Tensor  # (B, d)
    h: torch.Tensor  # (B, d)
    m: torch.Tensor  # (B, d)


def init_slstm_state(cfg: ModelConfig, batch: int, device=None
                     ) -> SLSTMState:
    d = cfg.d_model
    z = lambda: torch.zeros((batch, d), dtype=F32, device=device)
    return SLSTMState(c=z(), n=z(), h=z(),
                      m=torch.full((batch, d), -1e30, dtype=F32,
                                   device=device))


def apply_slstm_cell(p: Params, x: torch.Tensor, cfg: ModelConfig,
                     state: Optional[SLSTMState] = None
                     ) -> Tuple[torch.Tensor, SLSTMState]:
    """Sequential sLSTM over x: (B, T, d) (cell only, no FFN)."""
    b, t, d = x.shape
    h_heads = cfg.n_heads
    dh = d // h_heads
    wx = x.float() @ p["w"].float() + p["b"]                # (B,T,4d)
    if state is None:
        state = init_slstm_state(cfg, b, x.device)
    r = p["r"].float()
    c, n, h, m = state
    ys = []
    for i in range(t):
        hh = h.reshape(b, h_heads, dh)
        rec = torch.einsum("bhi,hio->bho", hh, r).reshape(b, 4 * d)
        pre = wx[:, i] + rec
        li_, lf_, z_, o_ = torch.chunk(pre, 4, dim=-1)
        lf = F.logsigmoid(lf_)
        zg = torch.tanh(z_)
        o = torch.sigmoid(o_)
        m_new = torch.maximum(lf + m, li_)
        fp = torch.exp(lf + m - m_new)
        ip = torch.exp(li_ - m_new)
        c = fp * c + ip * zg
        n = torch.clamp(fp * n + ip, min=1e-6)
        h = o * c / n
        m = m_new
        ys.append(h)
    return torch.stack(ys, dim=1).to(x.dtype), SLSTMState(c, n, h, m)


def slstm_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The post-FFN (projection factor 4/3, tanh-approximate GELU) on the
    cell's ``ff_in``/``ff_out``."""
    hmid = F.gelu(L.cast_to(x, cfg.cdtype)
                  @ L.wcast(p, "ff_in", cfg, [None, "model"]),
                  approximate="tanh")
    return hmid @ L.wcast(p, "ff_out", cfg, ["model", None])


def apply_slstm(p: Params, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[SLSTMState] = None
                ) -> Tuple[torch.Tensor, SLSTMState]:
    """Cell + post-FFN (projection factor 4/3), as one residual body."""
    y, state = apply_slstm_cell(p, x, cfg, state)
    return slstm_ffn(p, y, cfg), state
