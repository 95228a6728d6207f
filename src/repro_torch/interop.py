"""Carry the JAX package's inputs across as plain numpy arrays.

Two kinds: a simulation's prepared inputs (`from_prep`), and a language
model's configuration and parameters (`model_config_from_fields`,
`lm_params_from_numpy`).

The port draws the same trials as the JAX package from the same seed
(`repro_torch.random` is its threefry, key for key), except that the
initial loads' normal may differ from the reference's by an ulp
(`random.NORMAL_ULP`).  To hold the port's scheduling and post stages
against the reference on exactly its inputs, a caller computes the
reference's prep, turns every array into numpy, and hands them to
`from_prep`: the result feeds `core.simulate._sched_trials` and
`_post_trials` directly.  Likewise a language model's parameters, drawn
by the reference's ``init_lm``, load into the port's `LM` so both compute
the same function.  This module takes numpy arrays and plain Python
values only and imports nothing of the JAX package.  Every function lands
its tensors on the card unless ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.engine import ClusterTrace, Workload
from repro_torch.core.statlog import SchedState
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import MoEConfig, ModelConfig, SSMConfig


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
    position ``p``).  dtypes are kept."""
    T._check_supported(cfg)
    dev = resolve_device(device)

    def tensors(group, index=None) -> Dict[str, torch.Tensor]:
        """``group``'s arrays (entry ``index`` of each) on ``dev``."""
        pick = (lambda a: a) if index is None else (lambda a: a[index])
        return {k: torch.from_numpy(np.array(pick(a))).to(dev)
                for k, a in group.items()}

    groups = tree["groups"]
    blocks = []
    for li in range(cfg.n_layers):
        g, pos = divmod(li, cfg.group_size)
        block = groups[f"pos_{pos}"]
        if set(block) != {"attn_norm", "attn", "mlp_norm", "mlp"}:
            raise ValueError(f"layer {li} holds {sorted(block)}; the port "
                             "loads attention blocks with a dense MLP")
        blocks.append({name: tensors(sub, g) for name, sub in block.items()})
    head = tensors(tree["head"]) if "head" in tree else None
    return T.LM(tensors(tree["embed"]), tensors(tree["final_norm"]), head,
                blocks)
