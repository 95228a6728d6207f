"""Dispatch of the stream kernels.

`sched_stream_batch`, `sched_stream_grid` and `sched_select` are the
counterparts of the JAX package's ``kernels/sched_select/ops`` entries of
the same names: each checks the policy, pads the server axis to a
multiple of 128 lanes, runs the kernel on a CUDA tensor (or raises —
there is no fallback) and the plain PyTorch version on a CPU tensor, and
slices the padding off again.  The ``*_plain`` twins run the plain
version on whatever device the tensors lie on: what the kernels are held
against on the card.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.policy_core import (N_CMETRICS, N_METRICS, ROW_LOADS,
                                          resolve_client_tile)
from repro_torch.kernels.sched_select.kernel import (POLICY_CODES,
                                                     SELECT_KW,
                                                     sched_select_call,
                                                     sched_stream_call,
                                                     sched_stream_grid_call,
                                                     select_operands)
from repro_torch.kernels.sched_select.ref import (sched_stream_batch_ref,
                                                  sched_stream_grid_ref)

POLICIES = tuple(POLICY_CODES)
# policies of the legacy static entry point
STATIC_POLICIES = ("minload", "two_random")


def _pick(x: torch.Tensor, kernel, plain):
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if x.device.type == "cuda":
        return kernel
    if x.device.type == "cpu":
        return plain
    raise ValueError(f"no sched_stream implementation for {x.device}")


def _check_policy(policy: str, n_servers: int, nltr_n: int) -> None:
    if policy not in POLICIES:
        raise ValueError(f"kernel policy must be one of {POLICIES}")
    if policy == "nltr" and 2 ** nltr_n > n_servers:
        raise ValueError(
            f"nltr needs 2**nltr_n <= n_servers: nltr_n={nltr_n} gives "
            f"K={2 ** nltr_n} sections for n_servers={n_servers}")


def _pad_servers(m: int) -> int:
    return max(-(-m // 128) * 128, 128)


def _pad_lanes(x: torch.Tensor) -> torch.Tensor:
    """float32, the server axis zero-padded to `_pad_servers` lanes."""
    m = x.shape[-1]
    x = x.to(torch.float32)
    if _pad_servers(m) != m:
        x = torch.nn.functional.pad(x, (0, _pad_servers(m) - m))
    return x.contiguous()


def pad_operands(object_ids, lengths, valid, tables, seeds, win_rates):
    """The operands as the kernel takes them: int32/float32/int32 request
    blocks and the table and rate stacks zero-padded to `_pad_servers`
    lanes, all contiguous."""
    return (object_ids.to(torch.int32).contiguous(),
            lengths.to(torch.float32).contiguous(),
            valid.to(torch.int32).contiguous(), _pad_lanes(tables), seeds,
            _pad_lanes(win_rates))


def _run(fn, object_ids: torch.Tensor, lengths: torch.Tensor,
         valid: torch.Tensor, tables: torch.Tensor, seeds: torch.Tensor,
         win_rates: torch.Tensor, *, n_servers: int, window_size: int,
         threshold: float = 0.0, lam: float = 32.0, alpha: float = 0.25,
         window_dt: float = 0.0, policy: str = "ect", observe: bool = True,
         renorm: bool = True, nltr_n: int = 2, probe_choices: int = 2,
         trial_tile=None, ablate: int = 0, **merge):
    """Pad, run ``fn``, slice the padding off.  ``trial_tile`` is the
    kernel's warps per block (a launch shape: `kernel.resolve_warps`),
    ``ablate`` one of `kernel.ABLATE_LEVELS` (the 1-D form only);
    ``merge`` holds the 2-D form's ``client_tile`` and ``merge_mean`` (see
    `_run_grid`)."""
    _check_policy(policy, n_servers, nltr_n)
    if ablate and merge:
        raise ValueError("ablate profiling levels support the trial-grid "
                         "(1-D) form only")
    m = tables.shape[-1]
    out = fn(
        *pad_operands(object_ids, lengths, valid, tables, seeds, win_rates),
        n_servers=n_servers, window_size=window_size, threshold=threshold,
        lam=lam, alpha=alpha, window_dt=window_dt, policy=policy,
        observe=observe, renorm=renorm, nltr_n=nltr_n,
        probe_choices=probe_choices, trial_tile=trial_tile, ablate=ablate,
        **merge)
    choices, lats, ftab, wloads, metrics = out[:5]
    per_stream = (choices, lats, ftab[..., :m], wloads[..., :m],
                  metrics[..., :N_METRICS])
    if not merge:
        return per_stream
    cm_wl, cm_met, cm_lats, cm_lval = out[5:]
    return per_stream + (cm_wl[..., :m], cm_met[:, :N_CMETRICS], cm_lats,
                         cm_lval)


def sched_stream_batch(object_ids: torch.Tensor, *args, **kw):
    """T whole windowed streams in one kernel launch.

    object_ids/lengths/valid: (T, N) with N = W * window_size (padding
    rows invalid); tables: (T, 4, M) packed logs; seeds: (T,) uint32 LCG
    states (any integer dtype); win_rates: (T, W, M) true per-window
    rates; then the keyword parameters of `_run` (``n_servers``,
    ``window_size``, ``threshold``, ``lam``, ``alpha``, ``window_dt``,
    ``policy``, ``observe``, ``renorm``, ``nltr_n``, ``probe_choices``,
    ``trial_tile``, ``ablate``), whose defaults live there once.
    Returns (choices (T, N) int32, latencies (T, N), final_tables
    (T, 4, M), window_loads (T, W, M), metrics (T, N_METRICS) in
    `policy_core.MET_*` order).

    A CUDA tensor goes through the CUDA kernel, which raises if it cannot
    run; a CPU tensor goes through the plain PyTorch version."""
    return _run(_pick(object_ids, sched_stream_call, sched_stream_batch_ref),
                object_ids, *args, **kw)


sched_stream_batch_plain = functools.partial(_run, sched_stream_batch_ref)


def sched_stream(object_ids: torch.Tensor, lengths: torch.Tensor,
                 valid: torch.Tensor, table: torch.Tensor, seed: torch.Tensor,
                 win_rates: torch.Tensor, **kw):
    """One client's whole windowed stream: object_ids/lengths/valid (N,)
    with N = W * window_size, table (4, M), seed () uint32 state, win_rates
    (W, M); or a (C, ...) batch of them.  The keywords of
    `sched_stream_batch`.  Returns (choices, latencies, final_table,
    window_loads), without the metric row.

    A wrapper over `sched_stream_batch` with the same rule: the CUDA
    kernel for a CUDA tensor (one launch), the plain version for a CPU
    one."""
    single = object_ids.ndim == 1
    args = (object_ids, lengths, valid, table, seed, win_rates)
    if single:
        args = tuple(x.unsqueeze(0) for x in args)
    choices, lats, ftab, wloads, _ = sched_stream_batch(*args, **kw)
    out = (choices, lats, ftab, wloads)
    return tuple(x[0] for x in out) if single else out


def _run_grid(fn, object_ids: torch.Tensor, *args, client_tile=None,
              merge_mean: bool = True, **kw):
    return _run(fn, object_ids, *args,
                client_tile=resolve_client_tile(object_ids.shape[1],
                                                client_tile),
                merge_mean=merge_mean, **kw)


def sched_stream_grid(object_ids: torch.Tensor, *args, **kw):
    """T trials of C private-log client streams (the per_client model) in
    one launch of the stream kernel plus one of the cross-client merge.

    object_ids/lengths/valid: (T, C, N) per-client slices (N = W *
    window_size, padding rows invalid; a client with no valid row is a
    phantom and is masked out of every merge); tables: (T, C, 4, M);
    seeds: (T, C) uint32 states; win_rates: (T, W, M) per trial (a
    trial's clients share its trace); then the keywords of
    `sched_stream_batch` (``ablate`` above 0 raises), plus
    ``client_tile`` (the merge's association width, resolved by
    `resolve_client_tile`) and ``merge_mean``.  Returns (choices
    (T, C, N) int32, latencies (T, C, N), final_tables (T, C, 4, M),
    window_loads (T, C, W, M), metrics (T, C, N_METRICS), cm_wloads
    (T, W, M) — the masked client mean, or the raw masked sum when
    ``merge_mean`` is False — cm_metrics (T, N_CMETRICS), cm_lats
    (T, C, N) masked latencies, cm_lval (T, C, N) 0/1 validity).

    A CUDA tensor goes through the CUDA kernels, which raise if they
    cannot run; a CPU tensor goes through the plain PyTorch version."""
    return _run_grid(_pick(object_ids, sched_stream_grid_call,
                           sched_stream_grid_ref), object_ids, *args, **kw)


sched_stream_grid_plain = functools.partial(_run_grid, sched_stream_grid_ref)


def _select_plain(object_ids, lengths, init_loads, seeds, *, n_servers,
                  threshold, lam, policy):
    """Plain version of `kernel.sched_select_call`."""
    n = object_ids.shape[1]
    tables, valid, rates = select_operands(object_ids, init_loads, n_servers)
    choices, _, ftab, _, _ = sched_stream_batch_ref(
        object_ids, lengths, valid, tables, seeds, rates,
        n_servers=n_servers, window_size=n, threshold=threshold, lam=lam,
        policy=policy, **SELECT_KW)
    return choices, ftab[:, ROW_LOADS]


def _select(fn, object_ids: torch.Tensor, lengths: torch.Tensor,
            init_loads: torch.Tensor, seeds: torch.Tensor, *, n_servers: int,
            threshold: float = 0.0, lam: float = 32.0,
            policy: str = "minload"):
    if policy not in STATIC_POLICIES:
        raise ValueError(f"kernel policy must be one of {STATIC_POLICIES}")
    choices, final = fn(object_ids.to(torch.int32).contiguous(),
                        lengths.to(torch.float32).contiguous(),
                        _pad_lanes(init_loads), seeds, n_servers=n_servers,
                        threshold=threshold, lam=lam, policy=policy)
    return choices, final[:, :init_loads.shape[-1]]


def sched_select(object_ids: torch.Tensor, *args, **kw):
    """C client streams under the paper's static-load model, each as one
    window: object_ids/lengths (C, N), init_loads (C, M) true loads known
    to each client's log, seeds (C,) uint32 states; keywords
    ``n_servers``, ``threshold``, ``lam``, ``policy`` (minload or
    two_random).  Returns (choices (C, N) int32, final_loads (C, M)).
    On the card the N requests are one window of the stream kernel, in
    its global-memory instance where a stream of them does not fit a
    block's shared memory (`kernel.check_stream_domain`)."""
    return _select(_pick(object_ids, sched_select_call, _select_plain),
                   object_ids, *args, **kw)


sched_select_plain = functools.partial(_select, _select_plain)
