"""Carry the JAX package's inputs across as plain numpy arrays.

Two kinds: a simulation's prepared inputs (`from_prep`), and a language
model's configuration, parameters and train state
(`model_config_from_fields`, `lm_params_from_numpy`,
`encdec_params_from_numpy`, `lm_state_dict_from_numpy`,
`train_state_from_numpy`).  A train state also crosses as a checkpoint
(`restore_jax_train_state`, `save_jax_train_state`) through the name map
between the JAX package's leaf paths and the port's ``state_dict`` names
(`port_names`, `jax_leaf_name`).

The port draws the same trials as the JAX package from the same seed
(`repro_torch.random` is its threefry, key for key), except that the
initial loads' normal may differ from the reference's by an ulp
(`random.NORMAL_ULP`).  To hold the port's scheduling and post stages
against the reference on exactly its inputs, a caller computes the
reference's prep, turns every array into numpy, and hands them to
`from_prep`: the result feeds `core.simulate._sched_trials` and
`_post_trials` directly.  Likewise a language model's parameters, drawn
by the reference's ``init_lm``, load into the port's `LM` so both compute
the same function.  This module takes numpy arrays, tensors and plain
Python values only and imports nothing of the JAX package.  Every
function lands its tensors on the card unless ``device="cpu"``.
"""

from __future__ import annotations

from collections import OrderedDict
from types import SimpleNamespace
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine import ClusterTrace, Workload
from repro_torch.core.statlog import SchedState
from repro_torch.device import resolve_device
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models.config import MoEConfig, ModelConfig, SSMConfig
from repro_torch.train import optimizer as O
from repro_torch.train import steps as S


class PrepInputs(NamedTuple):
    """The (T,)-batched prep outputs in the port's structures."""

    init_loads: torch.Tensor       # (T, M) float32
    straggler_mask: torch.Tensor   # (T, M) bool
    works: Workload                # (T, R) requests
    states: SchedState             # (T, ...) logs and cluster truth
    traces: Optional[ClusterTrace]  # (T, E) times, (T, E, M) rates
    keys: torch.Tensor             # (T, 2) or (T, C, 2) int64 holding
    #                                the uint32 words of threefry keys


def _t(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def _own(a, dev) -> torch.Tensor:
    """A copy of ``a`` (a numpy array or a tensor) on ``dev``."""
    if isinstance(a, torch.Tensor):
        return a.to(dev, copy=True)
    return torch.from_numpy(np.array(a)).to(dev)


def _tensors(group, dev, index=None) -> Dict[str, torch.Tensor]:
    """``group``'s arrays or tensors (entry ``index`` of each), copied to
    ``dev``."""
    pick = (lambda a: a) if index is None else (lambda a: a[index])
    return {k: _own(pick(a), dev) for k, a in group.items()}


def from_prep(*, init_loads, straggler_mask, object_ids, lengths, valid,
              log, n_assigned, rates, vclock, free_at, keys,
              trace_times=None, trace_rates=None,
              device="cuda") -> PrepInputs:
    """Build `PrepInputs` from numpy arrays with a leading trial axis:
    ``init_loads``/``straggler_mask`` (T, M); the workload's
    ``object_ids``/``lengths``/``valid`` (T, R); the state's ``log``
    (T, 4, M), ``n_assigned`` (T, M), ``rates`` (T, M), ``vclock`` (T,)
    and ``free_at`` (T, M); the optional trace's ``trace_times`` (T, E)
    and ``trace_rates`` (T, E, M); and ``keys``, the reference's
    ``jax.random.key_data`` (uint32, (T, 2) — the trials' scheduler keys
    ``k_sched`` that `core.simulate._sched_trials` takes — or (T, C, 2)
    for the streams of `core.engine.run_stream_batch`).  Lands on the card
    unless ``device="cpu"`` (`resolve_device`)."""
    device = resolve_device(device)
    f32, i32 = torch.float32, torch.int32
    works = Workload(object_ids=_t(object_ids, i32, device),
                     lengths=_t(lengths, f32, device),
                     valid=_t(valid, torch.bool, device))
    states = SchedState(log=_t(log, f32, device),
                        n_assigned=_t(n_assigned, i32, device),
                        rates=_t(rates, f32, device),
                        vclock=_t(vclock, f32, device),
                        free_at=_t(free_at, f32, device))
    traces = None
    if trace_times is not None:
        traces = ClusterTrace(times=_t(trace_times, f32, device),
                              rates=_t(trace_rates, f32, device))
    keys64 = _t(np.asarray(keys).astype(np.uint32).astype(np.int64),
                torch.int64, device)
    return PrepInputs(init_loads=_t(init_loads, f32, device),
                      straggler_mask=_t(straggler_mask, torch.bool, device),
                      works=works, states=states, traces=traces,
                      keys=keys64)


def model_config_from_fields(d: Mapping[str, Any]) -> ModelConfig:
    """The port's `ModelConfig` from ``dataclasses.asdict`` of the JAX
    package's: the nested ``moe``/``ssm`` dicts become `MoEConfig`/
    `SSMConfig`."""
    fields = dict(d)
    if fields.get("moe") is not None:
        fields["moe"] = MoEConfig(**fields["moe"])
    if "ssm" in fields:
        fields["ssm"] = SSMConfig(**fields["ssm"])
    return ModelConfig(**fields)


def lm_params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                         device="cuda") -> T.LM:
    """Load the JAX package's ``init_lm`` pytree, as numpy arrays, into
    the port's `LM`: ``embed``/``final_norm``/``head`` as they are, and
    each layer's block from ``groups/pos_<p>/...``, whose leaves carry a
    leading ``n_groups`` axis (layer ``g * G + p`` is entry ``g`` of
    position ``p``), with the leaf sets of the position's block kind
    (`transformer.block_names`): an attention or mamba block's norms, its
    ``attn`` or ``mamba``, and ``mlp``, or ``moe`` on the layers
    ``cfg.layer_is_moe`` names; an mLSTM or sLSTM block's norms and
    ``cell``.  dtypes are kept."""
    T._check_supported(cfg)
    dev = resolve_device(device)
    tensors = lambda group, index=None: _tensors(group, dev, index)
    groups = tree["groups"]
    blocks = []
    for li in range(cfg.n_layers):
        g, pos = divmod(li, cfg.group_size)
        block = groups[f"pos_{pos}"]
        want = set(T.block_names(cfg.block_kind(pos), cfg.layer_is_moe(li)))
        if set(block) != want:
            raise ValueError(f"layer {li} holds {sorted(block)}; the port "
                             f"loads {sorted(want)} there")
        blocks.append({name: tensors(sub, g) for name, sub in block.items()})
    head = tensors(tree["head"]) if "head" in tree else None
    return T.LM(tensors(tree["embed"]), tensors(tree["final_norm"]), head,
                blocks)


def encdec_params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                             device="cuda") -> E.EncDec:
    """Load the JAX package's ``init_encdec`` pytree, as numpy arrays,
    into the port's `encdec.EncDec`: ``embed``, ``enc_final_norm`` and
    ``final_norm`` as they are, the encoder's blocks from
    ``enc_groups/pos_0/...`` and the decoder's from ``groups/pos_0/...``,
    whose leaves carry a leading ``n_enc_layers`` / ``n_layers`` axis.
    dtypes are kept."""
    E._check_encdec(cfg)
    dev = resolve_device(device)

    def stack(group, n, names):
        if set(group) != set(names):
            raise ValueError(f"a block holds {sorted(group)}; the port "
                             f"loads {sorted(names)}")
        return [{name: _tensors(sub, dev, li) for name, sub in group.items()}
                for li in range(n)]

    return E.EncDec(
        _tensors(tree["embed"], dev),
        stack(tree["enc_groups"]["pos_0"], cfg.n_enc_layers, E.ENC_NAMES),
        _tensors(tree["enc_final_norm"], dev),
        stack(tree["groups"]["pos_0"], cfg.n_layers, E.DEC_NAMES),
        _tensors(tree["final_norm"], dev))


def params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                      device="cuda"):
    """`encdec_params_from_numpy` for an encoder-decoder, else
    `lm_params_from_numpy`."""
    load = encdec_params_from_numpy if cfg.enc_dec else lm_params_from_numpy
    return load(tree, cfg, device)


def lm_state_dict_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                             device="cuda") -> Dict[str, torch.Tensor]:
    """A pytree shaped as ``init_lm``'s or ``init_encdec``'s (the
    parameters, their gradients or an Adam moment of them), as numpy
    arrays, keyed by the port's ``state_dict`` names."""
    return dict(params_from_numpy(tree, cfg, device).state_dict())


def train_state_from_numpy(state, cfg: ModelConfig,
                           device="cuda") -> S.TrainState:
    """The JAX package's ``TrainState`` (``params``, ``opt.m``,
    ``opt.v``, ``opt.count``, ``step``), its leaves as numpy arrays, as
    the port's `train.TrainState` (an `encdec.EncDec` for an
    encoder-decoder): the moments keyed by ``state_dict`` names, the
    counters int32."""
    dev = resolve_device(device)
    m, v = (lm_state_dict_from_numpy(t, cfg, dev)
            for t in (state.opt.m, state.opt.v))
    counter = lambda a: _own(a, dev).to(torch.int32).reshape(())
    return S.TrainState(params=params_from_numpy(state.params, cfg, dev),
                        opt=O.OptState(m=m, v=v,
                                       count=counter(state.opt.count)),
                        step=counter(state.step))


# ------------------------------------------------------------- name map
#
# The JAX package's parameter pytree stacks each group position's layers
# on a leading axis: its leaf ``groups/pos_<p>/<set>/<leaf>`` holds layer
# ``g * G + p`` (G = ``cfg.group_size``) at entry ``g``, the port's
# ``blocks.<g*G+p>.<set>.<leaf>``; an encoder-decoder's
# ``enc_groups/pos_0/...`` holds encoder layer ``i`` at entry ``i``, the
# port's ``enc_blocks.<i>...``.  Every other leaf is the same name with
# "/" for ".".  A train state's paths put ``params/``, ``opt/m/`` or
# ``opt/v/`` before a parameter's; ``opt/count`` and ``step`` are the
# counters.

_STACKS = {"groups": "blocks", "enc_groups": "enc_blocks"}


def port_names(path: str, cfg: ModelConfig) -> List[str]:
    """The port's ``state_dict`` names of a JAX parameter path, one for
    each entry of its stacked leading axis (one name for a leaf that is
    not stacked)."""
    parts = path.split("/")
    if parts[0] not in _STACKS:
        return [".".join(parts)]
    pos = int(parts[1].removeprefix("pos_"))
    encoder = parts[0] == "enc_groups"
    n = cfg.n_enc_layers if encoder else cfg.n_groups
    size = 1 if encoder else cfg.group_size
    return [".".join([_STACKS[parts[0]], str(g * size + pos), *parts[2:]])
            for g in range(n)]


def jax_leaf_name(name: str, cfg: ModelConfig) -> Tuple[str, Optional[int]]:
    """The JAX parameter path of a port ``state_dict`` name and the entry
    of its stacked leading axis that holds it (None: not stacked); the
    inverse of `port_names`."""
    parts = name.split(".")
    for stack, blocks in _STACKS.items():
        if parts[0] == blocks:
            size = 1 if stack == "enc_groups" else cfg.group_size
            g, pos = divmod(int(parts[1]), size)
            return "/".join([stack, f"pos_{pos}", *parts[2:]]), g
    return "/".join(parts), None


def _nest(named: Mapping[str, Any]) -> Dict[str, Any]:
    """``{"a/b/c": x}`` as nested dicts ``{"a": {"b": {"c": x}}}``."""
    out: Dict[str, Any] = {}
    for path, leaf in named.items():
        node = out
        *head, last = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


def jax_leaves_from_train_state(state: S.TrainState, cfg: ModelConfig
                                ) -> Dict[str, torch.Tensor]:
    """A port train state as the JAX package's ``{path: leaf}``: each
    stacked leaf the port's layers stacked in order, on the CPU."""
    out: Dict[str, torch.Tensor] = OrderedDict()
    trees = (("params", state.params.state_dict()), ("opt/m", state.opt.m),
             ("opt/v", state.opt.v))
    for prefix, tree in trees:
        stacks: Dict[str, Dict[int, torch.Tensor]] = {}
        for name, t in tree.items():
            path, entry = jax_leaf_name(name, cfg)
            t = t.detach().cpu()
            if entry is None:
                out[f"{prefix}/{path}"] = t
            else:
                stacks.setdefault(f"{prefix}/{path}", {})[entry] = t
        for path, entries in stacks.items():
            out[path] = torch.stack([entries[g] for g in range(len(entries))])
    out["opt/count"] = state.opt.count.detach().cpu()
    out["step"] = state.step.detach().cpu()
    return out


def restore_jax_train_state(ckpt, cfg: ModelConfig, step: Optional[int] = None,
                            device="cuda") -> S.TrainState:
    """A checkpoint the JAX package wrote of its ``TrainState``, read by
    the port's `checkpoint.Checkpointer` ``ckpt`` (step ``step``, the
    latest when None), as the port's `train.TrainState` on ``device``:
    `train_state_from_numpy` of its leaves nested by their paths."""
    tree = _nest(ckpt.restore(step, device="cpu"))
    state = SimpleNamespace(params=tree["params"],
                            opt=SimpleNamespace(**tree["opt"]),
                            step=tree["step"])
    return train_state_from_numpy(state, cfg, device)


def save_jax_train_state(ckpt, step: int, state: S.TrainState,
                         cfg: ModelConfig, meta=None) -> None:
    """Write a port train state through the port's `checkpoint.Checkpointer`
    ``ckpt`` under the JAX package's leaf paths, its stacked leaves
    stacked, so that the JAX package's ``Checkpointer.restore(target=
    state)`` reads it; waits until it is written."""
    ckpt.save(step, _nest(jax_leaves_from_train_state(state, cfg)), meta)
    ckpt.wait_until_finished()
