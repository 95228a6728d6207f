"""Dispatch of the trial-grid stream kernel.

`sched_stream_batch` is the counterpart of the JAX package's
``kernels/sched_select/ops.sched_stream_batch``: it checks the policy,
pads the server axis to a multiple of 128 lanes, runs the kernel on a
CUDA tensor (or raises — there is no fallback) and the plain PyTorch
version on a CPU tensor, and slices the padding off again.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.policy_core import N_METRICS
from repro_torch.kernels.sched_select.kernel import (POLICY_CODES,
                                                     sched_stream_call)
from repro_torch.kernels.sched_select.ref import sched_stream_batch_ref

POLICIES = tuple(POLICY_CODES)


def _check_policy(policy: str, n_servers: int, nltr_n: int) -> None:
    if policy not in POLICIES:
        raise ValueError(f"kernel policy must be one of {POLICIES}")
    if policy == "nltr" and 2 ** nltr_n > n_servers:
        raise ValueError(
            f"nltr needs 2**nltr_n <= n_servers: nltr_n={nltr_n} gives "
            f"K={2 ** nltr_n} sections for n_servers={n_servers}")


def _pad_servers(m: int) -> int:
    return max(-(-m // 128) * 128, 128)


def pad_operands(object_ids, lengths, valid, tables, seeds, win_rates):
    """The operands as the kernel takes them: int32/float32/int32 request
    blocks and the table and rate stacks zero-padded to `_pad_servers`
    lanes, all contiguous."""
    m = tables.shape[-1]
    m_pad = _pad_servers(m)

    def pad(x):
        x = x.to(torch.float32)
        if m_pad != m:
            x = torch.nn.functional.pad(x, (0, m_pad - m))
        return x.contiguous()

    return (object_ids.to(torch.int32).contiguous(),
            lengths.to(torch.float32).contiguous(),
            valid.to(torch.int32).contiguous(), pad(tables), seeds,
            pad(win_rates))


def _run(fn, object_ids: torch.Tensor, lengths: torch.Tensor,
         valid: torch.Tensor, tables: torch.Tensor, seeds: torch.Tensor,
         win_rates: torch.Tensor, *, n_servers: int, window_size: int,
         threshold: float = 0.0, lam: float = 32.0, alpha: float = 0.25,
         window_dt: float = 0.0, policy: str = "ect", observe: bool = True,
         renorm: bool = True, nltr_n: int = 2, probe_choices: int = 2):
    _check_policy(policy, n_servers, nltr_n)
    m = tables.shape[-1]
    choices, lats, ftab, wloads, metrics = fn(
        *pad_operands(object_ids, lengths, valid, tables, seeds, win_rates),
        n_servers=n_servers, window_size=window_size, threshold=threshold,
        lam=lam, alpha=alpha, window_dt=window_dt, policy=policy,
        observe=observe, renorm=renorm, nltr_n=nltr_n,
        probe_choices=probe_choices)
    return (choices, lats, ftab[..., :m], wloads[..., :m],
            metrics[:, :N_METRICS])


def sched_stream_batch(object_ids: torch.Tensor, *args, **kw):
    """T whole windowed streams in one kernel launch.

    object_ids/lengths/valid: (T, N) with N = W * window_size (padding
    rows invalid); tables: (T, 4, M) packed logs; seeds: (T,) uint32 LCG
    states (any integer dtype); win_rates: (T, W, M) true per-window
    rates; then the keyword parameters of `_run` (``n_servers``,
    ``window_size``, ``threshold``, ``lam``, ``alpha``, ``window_dt``,
    ``policy``, ``observe``, ``renorm``, ``nltr_n``, ``probe_choices``),
    whose defaults live there once.  Returns (choices (T, N) int32,
    latencies (T, N), final_tables (T, 4, M), window_loads (T, W, M),
    metrics (T, N_METRICS) in `policy_core.MET_*` order).

    A CUDA tensor goes through the CUDA kernel, which raises if it cannot
    run; a CPU tensor goes through the plain PyTorch version."""
    if object_ids.device.type == "cuda":
        fn = sched_stream_call
    elif object_ids.device.type == "cpu":
        fn = sched_stream_batch_ref
    else:
        raise ValueError(f"no sched_stream implementation for "
                         f"{object_ids.device}")
    return _run(fn, object_ids, *args, **kw)


# `sched_stream_batch` through the plain PyTorch version on whatever device
# the tensors lie on: what the kernel is held against on the card.
sched_stream_batch_plain = functools.partial(_run, sched_stream_batch_ref)
