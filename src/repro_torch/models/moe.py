"""Mixture-of-Experts FFN: top-k router and capacity-bounded dispatch.

The port's counterpart of the JAX package's ``models/moe.py``
(GShard/Switch-style dispatch, no ragged operations):

    router logits (T, E) -> top-k experts and weights per token
    position in expert: an exclusive running count over the (token, slot)
    pairs in token-major, slot-minor order
    the kept pairs copied into an (E, C, d) buffer; a pair at or past its
    expert's capacity C is dropped and its token falls through on the
    residual path
    batched expert FFN over the stacked (E, d, ff) weights
    weighted combine back to (T, d)

Auxiliary terms: the load-balancing loss (mean probability times mean
assignment, Switch eq. 4), the router z-loss and the dropped share, for
the train step to add or report.

Where the JAX package leans on float sums, the port takes the exact form
of the same function:

* Top-k ties go to the lower expert index, as ``jax.lax.top_k`` breaks
  them (`route` takes the first k of a stable descending sort;
  ``torch.topk`` makes no promise about ties).
* The position in expert is an integer running count; the JAX package's
  float32 ``cumsum`` of one-hot rows is exact below 2**24 pairs, so the
  two are equal.
* Dispatch: every kept (expert, position) slot receives exactly one pair,
  so the buffer is written by an index copy, not a sum.  Dropped pairs
  all land in a sink row past the E * C slots, which is sliced off (the
  JAX package adds them into the same sink), so nothing a kept slot holds
  depends on the order of the writes.  The combine gathers back through
  the same indices from the expert outputs with a zero sink row appended.

``dispatch="local"`` (per data-parallel shard capacity pools) equals the
global pool when the data-parallel size is 1, as the JAX package states;
the port runs one card and no data-parallel LM, so both values run the
global pool.  The local pool comes with the sharded stack (ROADMAP Queue
A13).

The expert products run outside any kernel in the JAX package too: they
are ``torch.bmm`` in the compute dtype here.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, MoEConfig

Params = Dict[str, torch.Tensor]


class MoEAux(NamedTuple):
    load_balance_loss: torch.Tensor   # scalar
    router_z_loss: torch.Tensor       # scalar
    dropped_fraction: torch.Tensor    # scalar (monitoring)


class Routing(NamedTuple):
    logits: torch.Tensor     # (T, E) float32
    probs: torch.Tensor      # (T, E) float32
    gate_w: torch.Tensor     # (T, k) float32, each row summing to 1
    gate_idx: torch.Tensor   # (T, k) int64, by descending probability


def init_moe(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    """Draws in the order router, w_in, w_out, w_gate (the plain gelu
    experts skip w_gate), with the JAX package's fan-ins."""
    m = cfg.moe
    d, ff, e = cfg.d_model, cfg.d_ff, m.n_experts
    p = {"router": L.he_init(gen, (d, e), torch.float32, fan_in=d,
                             device=device),
         "w_in": L.he_init(gen, (e, d, ff), cfg.pdtype, fan_in=d,
                           device=device),
         "w_out": L.he_init(gen, (e, ff, d), cfg.pdtype, fan_in=ff,
                            device=device)}
    if cfg.activation in ("swiglu", "geglu"):
        p["w_gate"] = L.he_init(gen, (e, d, ff), cfg.pdtype, fan_in=d,
                                device=device)
    return p


def capacity(cfg: MoEConfig, n_tokens: int) -> int:
    """Slots per expert: ``capacity_factor * top_k * n_tokens /
    n_experts``, truncated, rounded up to a multiple of 8, at least 8."""
    c = int(cfg.capacity_factor * cfg.top_k * n_tokens / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def route(p: Params, xt: torch.Tensor, cfg: ModelConfig) -> Routing:
    """The router over tokens xt (T, d): float32 logits and softmax, the
    top-k experts of each token (ties to the lower index) and their
    weights renormalized to sum to 1."""
    logits = xt.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    gate_idx = order[:, :cfg.moe.top_k]
    gate_w = torch.gather(probs, -1, gate_idx)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    return Routing(logits, probs, gate_w, gate_idx)


def _experts(p: Params, expert_in: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """(E, C, d) -> (E, C, d) through each expert's FFN, in cfg.cdtype."""
    hin = torch.bmm(expert_in, L.wcast(p, "w_in", cfg))
    if cfg.activation == "swiglu":
        h = F.silu(torch.bmm(expert_in, L.wcast(p, "w_gate", cfg))) * hin
    elif cfg.activation == "geglu":
        h = F.gelu(torch.bmm(expert_in, L.wcast(p, "w_gate", cfg)),
                   approximate="tanh") * hin
    elif cfg.activation == "gelu":
        h = F.gelu(hin, approximate="tanh")
    else:
        raise ValueError(cfg.activation)
    return torch.bmm(h, L.wcast(p, "w_out", cfg))


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, MoEAux]:
    """x: (B, S, d) -> (B, S, d), aux terms.  One capacity pool over the
    B * S tokens for either ``dispatch`` (see the module docstring)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.n_experts, m.top_k
    xt = L.cast_to(x.reshape(t, d), cfg.cdtype)
    r = route(p, xt, cfg)

    # --- capacity: earlier (token, slot) pairs claim an expert's slots ----
    c = capacity(m, t)
    onehot = F.one_hot(r.gate_idx, e)                      # (T, k, E) int64
    flat = onehot.reshape(t * k, e)
    pos = ((torch.cumsum(flat, dim=0) - flat) * flat).sum(-1).reshape(t, k)
    fits = pos < c
    dropped = 1.0 - fits.float().mean()

    # --- dispatch: one pair per kept slot, dropped pairs to the sink -----
    dest = r.gate_idx * c + torch.clamp(pos, 0, c - 1)
    dest = torch.where(fits, dest, e * c).reshape(-1)      # (T*k,)
    buf = xt.new_zeros((e * c + 1, d)).index_copy(
        0, dest, xt.repeat_interleave(k, dim=0))
    expert_out = _experts(p, buf[:e * c].reshape(e, c, d), cfg)

    # --- combine, with a zero sink row for the dropped pairs -------------
    flat_out = torch.cat([expert_out.reshape(e * c, d),
                          expert_out.new_zeros((1, d))])
    gathered = flat_out[dest].reshape(t, k, d)
    yt = torch.sum(gathered * r.gate_w[..., None].to(gathered.dtype), dim=1)

    # --- aux terms (Switch Transformer eq. 4, z-loss) ----------------------
    me = r.probs.mean(dim=0)                                # (E,)
    ce = onehot.sum(dim=1).float().mean(dim=0)              # (E,) assignment
    lb = e * torch.sum(me * ce)
    z = torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2)
    return yt.reshape(b, s, d), MoEAux(lb, 1e-3 * z, dropped)
