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

``dispatch="local"`` runs per data-parallel shard capacity pools
(`_apply_moe_local`, the JAX package's): under bound mesh rules
(`parallel.sharding`) whose batch axes hold ``dp`` > 1 shards, the
tokens split into ``dp`` equal groups in order, each with its own
capacity (of its ``T / dp`` tokens), its own running position counts
and its own sink row; drops are per group.  With no rules bound, or a
data-parallel size of 1, it is the one global pool.  Under
`train.steps.make_sharded_train_step` a rank computes its slice of the
batch (`sharding.split_batch`), which holds its ``dp / n`` shards; the
auxiliary terms are means over the whole batch, so a rank returns its
share of them (its mean probabilities, z-loss and dropped share over
``n``, against the assignment shares summed over the slices), and the
shares sum over the ranks to the reference's terms and gradients.  The
global pool spans every rank's tokens, so the sharded step never splits
the batch of a model with ``dispatch="global"`` (and `apply_moe` raises
under such a split).

The expert products run outside any kernel in the JAX package too: they
are ``torch.bmm`` in the compute dtype here.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.parallel import sharding as PS

Params = Dict[str, torch.Tensor]
# the roles of an (E, d, ff) expert weight gathered at use
GATHER = [None, None, "model"]


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
    hin = torch.bmm(expert_in, L.wcast(p, "w_in", cfg, GATHER))
    if cfg.activation == "swiglu":
        h = F.silu(torch.bmm(expert_in,
                             L.wcast(p, "w_gate", cfg, GATHER))) * hin
    elif cfg.activation == "geglu":
        h = F.gelu(torch.bmm(expert_in, L.wcast(p, "w_gate", cfg, GATHER)),
                   approximate="tanh") * hin
    elif cfg.activation == "gelu":
        h = F.gelu(hin, approximate="tanh")
    else:
        raise ValueError(cfg.activation)
    return torch.bmm(h, L.wcast(p, "w_out", cfg, [None, "model", None]))


def _dp_shards() -> int:
    """Data-parallel shards in the tokens this process computes: the
    bound rules' batch axes' size (1 when no rules are bound), over the
    active batch split's slices."""
    rules = PS.current_rules()
    if rules is None or not rules.batch_axes:
        return 1
    return rules.axis_size(rules.batch_axes) // PS.split_ranks()


def _pools(p: Params, xt: torch.Tensor, r: Routing, cfg: ModelConfig,
           g: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Capacity dispatch, experts and combine over ``g`` equal groups of
    the tokens xt (T, d) in order, each group a pool of its own: its
    capacity, running position counts and sink row.  Returns (yt (T, d),
    the one-hot choices (T, k, E), which pairs fit)."""
    m = cfg.moe
    t, d = xt.shape
    e, k = m.n_experts, m.top_k
    tl = t // g

    # --- capacity: earlier (token, slot) pairs claim an expert's slots ----
    c = capacity(m, tl)
    onehot = F.one_hot(r.gate_idx, e)                      # (T, k, E) int64
    flat = onehot.reshape(g, tl * k, e)
    pos = ((torch.cumsum(flat, dim=1) - flat) * flat).sum(-1).reshape(t, k)
    fits = pos < c

    # --- dispatch: one pair per kept slot, dropped pairs to the sink -----
    rows = e * c + 1                          # a group's slots, then its sink
    dest = r.gate_idx * c + torch.clamp(pos, 0, c - 1)
    dest = torch.where(fits, dest, e * c).reshape(g, tl * k)
    if g > 1:
        dest = dest + rows * torch.arange(g, device=dest.device)[:, None]
    dest = dest.reshape(-1)                                # (T*k,)
    buf = xt.new_zeros((g * rows, d)).index_copy(
        0, dest, xt.repeat_interleave(k, dim=0))
    expert_in = buf.reshape(g, rows, d)[:, :e * c].reshape(g, e, c, d)
    expert_out = _experts(p, expert_in.transpose(0, 1).reshape(e, g * c, d),
                          cfg).reshape(e, g, c, d).transpose(0, 1)

    # --- combine, with a zero sink row for the dropped pairs -------------
    flat_out = torch.cat([expert_out.reshape(g, e * c, d),
                          expert_out.new_zeros((g, 1, d))], dim=1)
    gathered = flat_out.reshape(g * rows, d)[dest].reshape(t, k, d)
    yt = torch.sum(gathered * r.gate_w[..., None].to(gathered.dtype), dim=1)
    return yt, onehot, fits


def _aux(r: Routing, onehot: torch.Tensor, fits: torch.Tensor,
         e: int) -> MoEAux:
    """The load-balancing loss (Switch Transformer eq. 4), the z-loss and
    the dropped share over the tokens; under a batch split of n > 1
    slices, this slice's share of the whole batch's (the module
    docstring)."""
    me = r.probs.mean(dim=0)                                # (E,)
    ce = onehot.sum(dim=1).float().mean(dim=0)              # (E,) assignment
    z = torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2)
    dropped = 1.0 - fits.float().mean()
    n = PS.split_ranks()
    if n > 1:
        slices = me.new_tensor(float(n))
        ce = PS.split_sum(ce) / slices
        me, z, dropped = me / slices, z / slices, dropped / slices
    lb = e * torch.sum(me * ce)
    return MoEAux(lb, 1e-3 * z, dropped)


def _moe(p: Params, x: torch.Tensor, cfg: ModelConfig, g: int
         ) -> Tuple[torch.Tensor, MoEAux]:
    b, s, d = x.shape
    xt = L.cast_to(x.reshape(b * s, d), cfg.cdtype)
    r = route(p, xt, cfg)
    yt, onehot, fits = _pools(p, xt, r, cfg, g)
    return yt.reshape(b, s, d), _aux(r, onehot, fits, cfg.moe.n_experts)


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, MoEAux]:
    """x: (B, S, d) -> (B, S, d), aux terms: the local pools of
    `_apply_moe_local` where ``dispatch="local"`` meets more than one
    data-parallel shard that divides the tokens, or a rank's slice of a
    split batch (its own shards' pools), else one capacity pool over the
    B * S tokens (the module docstring)."""
    if cfg.moe.dispatch == "local":
        dp = _dp_shards()
        if (dp > 1 or PS.split_ranks() > 1) \
                and (x.shape[0] * x.shape[1]) % dp == 0:
            return _apply_moe_local(p, x, cfg, dp)
    elif PS.split_ranks() > 1:
        raise ValueError(
            "dispatch='global' pools every rank's tokens: a sharded step "
            "computes such a model on the whole batch, unsplit")
    return _moe(p, x, cfg, 1)


def _apply_moe_local(p: Params, x: torch.Tensor, cfg: ModelConfig,
                     dp: int) -> Tuple[torch.Tensor, MoEAux]:
    """Per-DP-shard capacity dispatch (GShard-style local groups): the
    position counts, the dispatch and the combine run within each of the
    ``dp`` shards' token slices, so no dispatch buffer crosses the DP
    axis.  Drop semantics are per group rather than global."""
    b, s, d = x.shape
    PS.constrain(x.reshape(dp, b * s // dp, d), ["batch", None, None])
    return _moe(p, x, cfg, dp)
