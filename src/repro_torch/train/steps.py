"""Train / prefill / decode step functions: the port's counterpart of the
JAX package's ``train/steps.py``.

``make_train_step`` builds the canonical step:

    loss and gradients (remat per config) -> clip -> AdamW -> new TrainState

The JAX step is a pure function that the caller jits; the port's runs
eagerly and updates the state's parameters and moments in place (its
returned `TrainState` holds the same `LM` and moment tensors, with the
step advanced).  Encoder-decoder configurations (``cfg.enc_dec``) take
`models.encdec`'s parameters, loss, forward and decode step, as the JAX
package's steps do; their batches carry ``frames`` beside ``tokens`` and
``targets``.

``make_sharded_train_step`` is the step under a mesh (the JAX package
jits the same step with ``state_shardings``).  The state lives as
DTensors (`shard_state`): every parameter and its moments m and v
placed by the reference's specs (`launch.shardutil.state_shardings`,
ZeRO-3 storage), the counters plain and alike on every rank.  The model
code never runs on DTensors; each step

* runs the loss on this rank's slice of the global batch along the
  batch axes (``("pod", "data")``), under the bound rules and a
  `parallel.sharding.split_batch`, so that the loss's token count and
  the MoE terms are the whole batch's and each rank's loss is its share
  of the whole batch's loss (their sum over the ranks);
* gathers each block's weights where the block uses them
  (`parallel.sharding.at_use`; the embedding, head and final norm at
  the top of the forward pass), as the JAX package's ``gather_weights``
  path gathers each weight at its use;
* in the backward pass sums each block's weight gradients over the batch
  axes and cuts them to the shards, in one reduce-scatter for each batch
  mesh dimension (an all-reduce for a weight that dimension replicates);
* runs AdamW on the local shards of p, m and v, clipped by the global
  norm: each element's square counted on one rank (the first along the
  mesh dimensions that replicate it), summed over the mesh.

Under remat (``cfg.remat`` "block", every configuration's) a block's
whole weights live while it runs, and again while its backward pass
recomputes it, so a rank holds its shards of p, m, v and their
gradients, the top level whole for the step, and one block's whole
weights and gradients at a time.  With ``remat="none"`` autograd keeps
every block's gathered weights until its backward pass.

Compute along ``model`` is replicated: every rank of a data slice
computes the same gradients, and tensor-parallel compute is later work
(ROADMAP).  The batch is not split (every rank computes the whole batch,
and the bound rules give `models.moe` its data-parallel pools) when its
rows do not divide over the batch axes, or when the model pools its MoE
tokens globally (``dispatch="global"``), which spans every rank's
tokens; the gradients then need no sum.  An encoder-decoder is not
trained sharded.  `gather_state` makes the whole, unsharded state of a
sharded one (the checkpoint's format).

``make_sharded_prefill_step`` and ``make_sharded_decode_step`` serve
under a mesh the same way, with no autograd: parameters placed by
`shard_params`, the batch split as the train step splits it, each
block's weights gathered whole at use; a rank returns its rows' logits,
and the decode step updates the caches of its rows (`local_rows`),
which the rank holds whole (the JAX package's cache roles put the
sequence on ``model``, along which the port replicates compute).  They
refuse an encoder-decoder too.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Iterable, NamedTuple, Optional, Tuple, \
    Union

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.policy_core import all_gather_stack
from repro_torch.device import resolve_device
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding as PS
from repro_torch.train import optimizer as O


class TrainState(NamedTuple):
    params: Union[T.LM, E.EncDec]
    opt: O.OptState
    step: torch.Tensor         # int32, 0-dim


def _state(params, dev: torch.device) -> TrainState:
    return TrainState(params=params, opt=O.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def init_state(gen: torch.Generator, cfg: ModelConfig,
               device="cuda") -> TrainState:
    """Random parameters from ``gen`` (a generator on ``device``; see
    `transformer.init_lm`, or `encdec.init_encdec` for an
    encoder-decoder), zero moments, step 0."""
    dev = resolve_device(device)
    init = E.init_encdec if cfg.enc_dec else T.init_lm
    return _state(init(gen, cfg, dev), dev)


def abstract_state(cfg: ModelConfig) -> TrainState:
    """The `TrainState` on the ``meta`` device: every shape and dtype,
    no allocation (the JAX package's ``jax.eval_shape`` of
    ``init_state``)."""
    meta = torch.device("meta")
    build = E.build_encdec if cfg.enc_dec else T.build_lm
    return _state(build(None, cfg, meta), meta)


def loss_fn_for(cfg: ModelConfig) -> Callable:
    return E.lm_loss if cfg.enc_dec else T.lm_loss


def load_state(state: TrainState, restored: TrainState) -> TrainState:
    """``state`` with a checkpoint's leaves: ``restored`` is
    `Checkpointer.restore(target=state)`, whose params' place holds a
    ``state_dict``, loaded here into ``state``'s `LM` in place."""
    state.params.load_state_dict(restored.params)
    return TrainState(params=state.params, opt=restored.opt,
                      step=restored.step)


def make_train_step(cfg: ModelConfig, opt_cfg: O.OptConfig
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    loss_fn = loss_fn_for(cfg)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        names, leaves = zip(*state.params.named_parameters())
        with torch.enable_grad():
            loss, metrics = loss_fn(state.params, batch, cfg)
            grads = torch.autograd.grad(loss, leaves)
        _, opt, opt_metrics = O.update(opt_cfg, dict(zip(names, grads)),
                                       state.opt, state.params)
        del grads
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics)
        metrics["loss"] = loss.detach()
        return TrainState(params=state.params, opt=opt,
                          step=state.step + 1), metrics

    return train_step


# ---------------------------------------------------------------- sharded

# a batch input's batch dimension, where it is not the first
BATCH_DIM = {"positions": 1}


def _local_chunk(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``full`` under ``placements`` on ``mesh``:
    each ``Shard(d)`` mesh dimension splits dim d in order, the first
    mesh dimension the major (DTensor's order, and a JAX
    ``PartitionSpec``'s)."""
    coord = mesh.get_coordinate()
    t = full
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard) and mesh.shape[i] > 1:
            t = torch.chunk(t, mesh.shape[i], dim=pl.dim)[coord[i]]
    return t


def _distribute(full: torch.Tensor, mesh, placements) -> DTensor:
    """A DTensor holding this rank's shard of ``full`` (a copy when it is
    a part of it), with no collective."""
    local = _local_chunk(full, mesh, placements)
    if local.numel() != full.numel():
        local = local.clone()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=full.shape, stride=full.stride())


@torch.no_grad()
def _gather(local: torch.Tensor, mesh, placements) -> torch.Tensor:
    """The whole tensor of the shard ``local``: the shards gathered over
    each sharded mesh dimension, the last first (a concatenation, so
    exact); ``local`` itself where this rank holds it whole."""
    t = local
    for i in reversed(range(mesh.ndim)):
        pl = placements[i]
        if isinstance(pl, Shard) and mesh.shape[i] > 1:
            t = torch.cat(all_gather_stack(t, mesh.get_group(i)).unbind(0),
                          dim=pl.dim)
    return t


def _whole(dt: DTensor) -> torch.Tensor:
    """A copy of the whole tensor of a DTensor, on every rank."""
    t = _gather(dt.to_local(), dt.device_mesh, dt.placements)
    return t.clone() if t is dt.to_local() else t


def shard_params(params: nn.Module, shardings: Dict) -> nn.Module:
    """``params`` (an `LM`, whole, alike on every rank) placed by
    ``shardings`` (`launch.shardutil.param_shardings`, or a
    `state_shardings`' params): its parameters become DTensors in the
    module itself, which it takes over; returns it."""
    dts = OrderedDict(
        (k, _distribute(p.detach(), shardings[k].mesh,
                        shardings[k].placements))
        for k, p in params.state_dict().items())
    params.load_state_dict(dts, assign=True)
    return params


def shard_state(state: TrainState, shardings: TrainState) -> TrainState:
    """``state`` (whole, alike on every rank) placed by ``shardings``
    (`launch.shardutil.state_shardings`): the parameters become DTensors
    in ``state``'s own module (which it takes over), m and v dicts of
    DTensors, the counters stay plain."""
    params = shard_params(state.params, shardings.params)
    # keyed in the parameters' order on every rank (a restored state's
    # moments come in another), so every rank gathers them alike
    moment = lambda tree: {k: _distribute(tree[k], shardings.params[k].mesh,
                                          shardings.params[k].placements)
                           for k in params.state_dict()}
    return TrainState(params=params,
                      opt=O.OptState(m=moment(state.opt.m),
                                     v=moment(state.opt.v),
                                     count=state.opt.count),
                      step=state.step)


def gather_state(state: TrainState) -> TrainState:
    """The whole state of a sharded one, a copy, on every rank (every
    rank must call it): the parameters as an ordered ``state_dict``, m and
    v as dicts, so that a checkpoint of it is an unsharded state's."""
    return TrainState(
        params=OrderedDict((k, _whole(p)) for k, p in
                           state.params.state_dict().items()),
        opt=O.OptState(m={k: _whole(t) for k, t in state.opt.m.items()},
                       v={k: _whole(t) for k, t in state.opt.v.items()},
                       count=state.opt.count.clone()),
        step=state.step.clone())


def _owned(dt: DTensor) -> bool:
    """Does this rank count ``dt``'s local elements in the global norm:
    the first rank along each mesh dimension that replicates it."""
    coord = dt.device_mesh.get_coordinate()
    return all(c == 0 for c, pl in zip(coord, dt.placements)
               if isinstance(pl, Replicate))


def batch_split(rules: PS.MeshRules, rows: int,
                cfg: ModelConfig) -> Optional[PS.BatchSplit]:
    """The split of a global batch of ``rows`` over the rules' batch
    axes, or None where the batch is computed whole (one slice; rows
    that do not divide; a global MoE pool)."""
    n = rules.axis_size(rules.batch_axes) if rules.batch_axes else 1
    if n == 1 or rows % n or (cfg.moe is not None
                              and cfg.moe.dispatch == "global"):
        return None
    mesh = rules.mesh
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index = 0
    for a in rules.batch_axes:
        index = index * rules.axis_size(a) + coord[a]
    return PS.BatchSplit(tuple(mesh.get_group(a) for a in rules.batch_axes),
                         n, index)


def local_rows(rules: PS.MeshRules, rows: int, cfg: ModelConfig) -> int:
    """The rows of a global batch of ``rows`` that this rank computes
    (and whose decode caches it holds) under the sharded steps."""
    split = batch_split(rules, rows, cfg)
    return rows if split is None else rows // split.n


def _slice(batch: Dict[str, torch.Tensor],
           split: Optional[PS.BatchSplit]) -> Dict[str, torch.Tensor]:
    if split is None:
        return batch
    return {k: torch.chunk(v, split.n, dim=BATCH_DIM.get(k, 0))[split.index]
            for k, v in batch.items()}


def _coalesced_sum(tensors, groups) -> list:
    """``tensors`` summed over ``groups`` (`sharding.reduce_over`) in one
    float32 buffer, as new tensors of their dtypes."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    PS.reduce_over(flat, groups)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


def _scatter(grads: list, dims: list, group, n: int, index: int) -> list:
    """Each gradient of ``grads`` summed over ``group`` (``n`` ranks, this
    one ``index``) and cut to this rank's chunk of its dimension in
    ``dims`` (None: kept whole), in two coalesced float32 collectives: a
    reduce-scatter of the chunks, laid out rank by rank, and an
    all-reduce of the gradients kept whole."""
    out = list(grads)
    cut = [j for j, d in enumerate(dims) if d is not None]
    if cut:
        parts = [torch.chunk(grads[j].float(), n, dim=dims[j]) for j in cut]
        buf = torch.cat([p[r].reshape(-1) for r in range(n) for p in parts])
        mine = PS.reduce_scatter(buf.new_empty(buf.numel() // n), buf, group)
        at = 0
        for j, p in zip(cut, parts):
            c = p[index]
            out[j] = mine[at:at + c.numel()].view(c.shape).to(grads[j].dtype)
            at += c.numel()
    whole = [j for j, d in enumerate(dims) if d is None]
    if whole:
        for j, t in zip(whole, _coalesced_sum([grads[j] for j in whole],
                                              (group,))):
            out[j] = t
    return out


def _shard_grads(grads: list, metas: tuple, batch_dims: frozenset) -> list:
    """Whole gradients (one for each ``(mesh, placements)`` of ``metas``)
    summed over the mesh dimensions in ``batch_dims`` (the batch split's)
    and cut to this rank's shards, mesh dimension by mesh dimension in
    order, as `_local_chunk` cuts: a batch dimension reduce-scatters the
    gradients it shards (an all-reduce where it replicates one, or its
    dimension does not divide), another keeps this rank's chunk."""
    mesh = metas[0][0]
    coord = mesh.get_coordinate()
    out = list(grads)
    for i in range(mesh.ndim):
        n = mesh.shape[i]
        if n == 1:
            continue
        dims = [pl[i].dim if isinstance(pl[i], Shard) else None
                for _, pl in metas]
        if i in batch_dims:
            dims = [d if d is not None and g.shape[d] % n == 0 else None
                    for d, g in zip(dims, out)]
            out = _scatter(out, dims, mesh.get_group(i), n, coord[i])
            for j, (_, pl) in enumerate(metas):
                if dims[j] is None and isinstance(pl[i], Shard):
                    out[j] = torch.chunk(out[j], n, dim=pl[i].dim)[coord[i]]
        else:
            out = [g if d is None else torch.chunk(g, n, dim=d)[coord[i]]
                   for g, d in zip(out, dims)]
    return out


class _GatherAtUse(torch.autograd.Function):
    """A module's weights whole from this rank's shards (forward), and
    their whole gradients summed over the batch split and cut back to
    the shards (backward: `_shard_grads`)."""

    @staticmethod
    def forward(ctx, metas, batch_dims, *shards):
        ctx.metas, ctx.batch_dims = metas, batch_dims
        whole = []
        for s, m in zip(shards, metas):
            t = _gather(s, *m)
            whole.append(t.view_as(t) if t is s else t)
        return tuple(whole)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        # (a weight the loss did not reach comes as zeros: autograd
        # materializes the gradients of a Function's outputs)
        return (None, None, *_shard_grads(grads, ctx.metas, ctx.batch_dims))


def _gatherer(params: nn.Module,
              whole: Callable[[list], Iterable[torch.Tensor]]
              ) -> Callable[[nn.Module], "_Gathered"]:
    """The gather that `parallel.sharding.gather_at_use` binds for a
    sharded step over ``params``: a module's leaf sets as dicts of whole
    weights, ``whole(keys)`` giving them for the ``state_dict`` names
    ``keys``, in order."""
    prefix = {id(m): name + "." if name else ""
              for name, m in params.named_modules()}

    def gather(module: nn.Module) -> _Gathered:
        sets = {c: list(m.keys()) for c, m in module.named_children()
                if isinstance(m, nn.ParameterDict)}
        it = iter(whole([f"{prefix[id(module)]}{c}.{k}"
                         for c, ks in sets.items() for k in ks]))
        return _Gathered(module, {c: {k: next(it) for k in ks}
                                  for c, ks in sets.items()})

    return gather


class _Gathered:
    """What the model code reads of a module under the sharded step: its
    leaf sets (``nn.ParameterDict``s) as dicts of whole weights, anything
    else (the block list, an absent head) the module's own."""

    def __init__(self, module: nn.Module, leaves: Dict[str, Dict]):
        self._module, self._leaves = module, leaves

    def __getattr__(self, name):
        leaves = self.__dict__["_leaves"]
        if name in leaves:
            return leaves[name]
        return getattr(self.__dict__["_module"], name)


def make_sharded_train_step(cfg: ModelConfig, opt_cfg: O.OptConfig,
                            rules: PS.MeshRules
                            ) -> Callable[[TrainState, Dict[str,
                                                            torch.Tensor]],
                                          Tuple[TrainState,
                                                Dict[str, torch.Tensor]]]:
    """The train step over a state placed by `shard_state` on
    ``rules.mesh`` (the module docstring).  Every rank of the mesh calls
    it with the same global batch and gets the same metrics; the state's
    shards are updated in place."""
    _refuse_encdec(cfg, "train step")
    loss_fn = loss_fn_for(cfg)
    mesh = rules.mesh
    mesh_groups = tuple(mesh.get_group(i) for i in range(mesh.ndim))

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        sharded = state.params.state_dict()
        # the local shards, leaves of this step's graph
        shards = {k: p.to_local().detach().requires_grad_()
                  for k, p in sharded.items()}
        split = batch_split(rules, batch["tokens"].shape[0], cfg)
        batch_dims = frozenset(() if split is None else
                               (mesh.mesh_dim_names.index(a)
                                for a in rules.batch_axes))
        gather = _gatherer(state.params, lambda keys: _GatherAtUse.apply(
            tuple((sharded[k].device_mesh, sharded[k].placements)
                  for k in keys), batch_dims, *(shards[k] for k in keys)))
        names = list(sharded)
        with PS.use_mesh_rules(rules), PS.split_batch(split), \
                PS.gather_at_use(gather), torch.enable_grad():
            loss, metrics = loss_fn(state.params, _slice(batch, split), cfg)
            grads = torch.autograd.grad(loss, [shards[k] for k in names])
        local = dict(zip(names, grads))
        del grads, shards
        metrics = dict(metrics, loss=loss)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if split is not None:
            metrics = dict(zip(metrics, _coalesced_sum(
                list(metrics.values()), split.groups)))
        owned = {k: _owned(sharded[k]) for k in names}

        def norm(tree):
            sq = torch.zeros((), device=state.step.device)
            for k, g in tree.items():
                if owned[k]:
                    sq = sq + torch.sum(torch.square(g.float()))
            return torch.sqrt(PS.reduce_over(sq, mesh_groups))

        with torch.no_grad():
            params = {k: p.to_local() for k, p in sharded.items()}
            opt = O.OptState(m={k: t.to_local()
                                for k, t in state.opt.m.items()},
                             v={k: t.to_local()
                                for k, t in state.opt.v.items()},
                             count=state.opt.count)
        _, opt, opt_metrics = O.update(opt_cfg, local, opt, params, norm)
        metrics.update(opt_metrics)
        return TrainState(params=state.params,
                          opt=O.OptState(m=state.opt.m, v=state.opt.v,
                                         count=opt.count),
                          step=state.step + 1), metrics

    return train_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """Prefill = full forward over the prompt, logits out (an
    encoder-decoder's batch carries ``frames``)."""
    fwd = E.forward_train if cfg.enc_dec else T.forward_train

    @torch.no_grad()
    def prefill_step(params, batch):
        return fwd(params, batch, cfg)

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """One-token serve step: (params, caches, tokens (B,1), pos) ->
    (logits, caches)."""
    step = E.decode_step if cfg.enc_dec else T.decode_step

    @torch.no_grad()
    def decode(params, caches, tokens, pos):
        return step(params, caches, tokens, pos, cfg)

    return decode


def _refuse_encdec(cfg: ModelConfig, what: str) -> None:
    if cfg.enc_dec:
        raise ValueError(f"{cfg.name} is an encoder-decoder: the sharded "
                         f"{what} runs decoder LMs (launch/train.py "
                         "refuses an encoder-decoder too)")


def _serve_gather(params: nn.Module) -> Callable[[nn.Module], _Gathered]:
    """`_gatherer` over ``params``' DTensors with no autograd: each leaf
    gathered whole from this rank's shard."""
    sharded = params.state_dict()
    return _gatherer(params, lambda keys: [
        _gather(sharded[k].to_local(), sharded[k].device_mesh,
                sharded[k].placements) for k in keys])


def make_sharded_prefill_step(cfg: ModelConfig, rules: PS.MeshRules
                              ) -> Callable:
    """`make_prefill_step` over parameters placed by `shard_params` on
    ``rules.mesh``: every rank calls it with the same global batch and
    gets the logits of its rows (`batch_split`: its slice along the
    batch axes, or the whole batch), each block's weights gathered whole
    at use, under ``torch.no_grad``."""
    _refuse_encdec(cfg, "prefill step")

    @torch.no_grad()
    def prefill_step(params: T.LM, batch: Dict[str, torch.Tensor]):
        split = batch_split(rules, batch["tokens"].shape[0], cfg)
        with PS.use_mesh_rules(rules), PS.split_batch(split), \
                PS.gather_at_use(_serve_gather(params)):
            return T.forward_train(params, _slice(batch, split), cfg)

    return prefill_step


def make_sharded_decode_step(cfg: ModelConfig, rules: PS.MeshRules
                             ) -> Callable:
    """`make_decode_step` over parameters placed by `shard_params`: every
    rank calls it with the same global tokens (B, 1) and the decode
    caches of its own rows (`local_rows` of B; `transformer.init_caches`
    of that many rows), which it updates in place, and gets its rows'
    logits and caches."""
    _refuse_encdec(cfg, "decode step")

    @torch.no_grad()
    def decode(params: T.LM, caches, tokens: torch.Tensor, pos: int):
        split = batch_split(rules, tokens.shape[0], cfg)
        with PS.use_mesh_rules(rules), PS.split_batch(split), \
                PS.gather_at_use(_serve_gather(params)):
            return T.decode_step(params, caches,
                                 _slice({"tokens": tokens}, split)["tokens"],
                                 pos, cfg)

    return decode


def eval_ppl(params, batches: Iterable[Dict[str, torch.Tensor]],
             cfg: ModelConfig) -> float:
    """Mean token NLL over a list of batches (examples/quickstart)."""
    loss_fn = loss_fn_for(cfg)
    with torch.no_grad():
        nlls = [loss_fn(params, b, cfg)[1]["nll"].cpu().numpy()
                for b in batches]
    return float(np.mean(nlls))
