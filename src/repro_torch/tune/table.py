"""Versioned on-disk launch-shape table and the one tile resolver.

Counterpart of the JAX package's ``tune/table.py``, with the same keys,
``TABLE_VERSION`` and failure modes.  The autotuner
(`repro_torch.tune.autotune`) times candidate (trial_tile, client_tile)
shapes per configuration and caches the winner in a flat JSON table at
the repository root, ``TUNE_sched_torch.json`` (``SCHED_TUNE_TORCH_PATH``
points tests and experiments at a private table).  ``TUNE_sched.json``
beside it holds the JAX package's winners and is never read here.

The two tiles mean here:

* ``client_tile`` — the association width of the per_client cross-client
  merge, as in the reference: it fixes the merge's float order, so every
  mode resolves it exactly as the reference's `resolve_sim_tiles` does
  for the same configuration and table entry;
* ``trial_tile`` — the CUDA counterpart of the reference's trials per
  Pallas program: the stream kernel's warps per block, a launch shape on
  which no result depends.  It is None (the kernel's own
  `kernel.WARPS_PER_BLOCK`) unless set explicitly or by a "tuned" table
  hit; the reference's TPU trial tile is never carried into a launch.

Entries carry the card's name and power limit beside the winner; the
loader keeps whatever keys an entry holds.  A missing, unreadable,
corrupt or stale-``version`` table reads as empty: tuning is an
optimisation, never a correctness dependency, so nothing here raises on
bad cache state.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

from repro_torch.core.policy_core import resolve_client_tile
from repro_torch.kernels.sched_select.kernel import clamp_warps

TABLE_VERSION = 1
TABLE_BASENAME = "TUNE_sched_torch.json"
ENV_PATH = "SCHED_TUNE_TORCH_PATH"

# simulate dispatch forms: "batch" = the 1-D trial grid (shared_log),
# "grid" = the 2-D trials x clients grid (per_client)
FORMS = ("batch", "grid")

TILE_MODES = ("default", "tuned", "fused")


def default_path() -> str:
    env = os.environ.get(ENV_PATH)
    if env:
        return env
    here = os.path.dirname(os.path.abspath(__file__))
    # src/repro_torch/tune -> repository root
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(here))), TABLE_BASENAME)


def config_key(*, policy: str, backend: str, n_servers: int,
               n_requests: int, n_clients: int, n_trials: int,
               window_size: int, device_count: int = 1,
               form: str = "batch") -> str:
    """Canonical string key of one tuning configuration."""
    if form not in FORMS:
        raise ValueError(f"form={form!r} must be one of {FORMS}")
    return (f"policy={policy}|backend={backend}|M={n_servers}"
            f"|R={n_requests}|C={n_clients}|T={n_trials}"
            f"|W={window_size}|D={device_count}|form={form}")


def load_table(path: Optional[str] = None) -> Dict[str, dict]:
    """The cached ``{key: entry}`` map; {} on any bad cache state
    (missing file, unreadable bytes, non-JSON, wrong schema, stale
    version) — never raises."""
    path = path or default_path()
    try:
        with open(path, "r", encoding="utf-8") as fh:
            raw = json.load(fh)
    except (OSError, ValueError):
        return {}
    if not isinstance(raw, dict) or raw.get("version") != TABLE_VERSION:
        return {}
    entries = raw.get("entries")
    if not isinstance(entries, dict):
        return {}
    return {key: dict(entry) for key, entry in sorted(entries.items())
            if isinstance(key, str) and isinstance(entry, dict)}


def save_table(entries: Dict[str, dict], path: Optional[str] = None) -> str:
    """Write the versioned table (sorted keys: byte-deterministic for a
    given entry map).  Returns the path written."""
    path = path or default_path()
    payload = {"version": TABLE_VERSION,
               "entries": {k: entries[k] for k in sorted(entries)}}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return path


def store(key: str, entry: dict, path: Optional[str] = None) -> str:
    entries = load_table(path)
    entries[key] = dict(entry)
    return save_table(entries, path)


def _entry_tiles(entry: Optional[dict]) -> Tuple[Optional[int],
                                                 Optional[int]]:
    if not isinstance(entry, dict):
        return None, None
    tt, ct = entry.get("trial_tile"), entry.get("client_tile")
    tt = int(tt) if isinstance(tt, (int, float)) and tt >= 1 else None
    ct = int(ct) if isinstance(ct, (int, float)) and ct >= 1 else None
    return tt, ct


def lookup(*, policy: str, backend: str, n_servers: int, n_requests: int,
           n_clients: int, n_trials: int, window_size: int,
           device_count: int = 1, form: str = "batch",
           path: Optional[str] = None) -> Optional[dict]:
    """The cached entry for a configuration, trying the exact backend
    first and falling back to the canonical ``kernel`` entry (a jax-backend
    run must resolve the same association as the kernel it shadows)."""
    entries = load_table(path)
    for be in (backend, "kernel"):
        entry = entries.get(config_key(
            policy=policy, backend=be, n_servers=n_servers,
            n_requests=n_requests, n_clients=n_clients, n_trials=n_trials,
            window_size=window_size, device_count=device_count, form=form))
        if entry is not None:
            return entry
    return None


def resolve_sim_tiles(*, mode: str, policy: str, backend: str,
                      n_servers: int, n_requests: int, n_clients: int,
                      n_trials: int, window_size: int, device_count: int = 1,
                      form: str = "batch", trial_tile=None, client_tile=None,
                      path: Optional[str] = None
                      ) -> Tuple[Optional[int], int]:
    """THE tile resolution point: `simulate._sched_trials` calls it once
    per dispatch and threads the pair through every layer.  Returns
    ``(trial_tile, client_tile)``: the warps per block (None: the
    kernel's default) and the merge's association width.  Explicit
    ``trial_tile``/``client_tile`` settings always win; ``mode``:

    * ``"default"`` — the static `resolve_client_tile`;
    * ``"fused"``   — the same here: the reference's fused block deepens
      only its TPU trial tile, which no launch of the port takes;
    * ``"tuned"``   — the cached autotuner winner, clamped through the
      resolvers; a cache miss degrades to ``"fused"``.
    """
    if mode not in TILE_MODES:
        raise ValueError(f"tiles mode {mode!r} must be one of {TILE_MODES}")
    tt = None if trial_tile is None else clamp_warps(trial_tile)
    if mode == "tuned":
        entry = lookup(policy=policy, backend=backend, n_servers=n_servers,
                       n_requests=n_requests, n_clients=n_clients,
                       n_trials=n_trials, window_size=window_size,
                       device_count=device_count, form=form, path=path)
        # a miss reads (None, None): "fused", which resolves as "default"
        tuned_tt, tuned_ct = _entry_tiles(entry)
        if tt is None and tuned_tt is not None:
            tt = clamp_warps(tuned_tt)
        if client_tile is None:
            client_tile = tuned_ct
    return tt, resolve_client_tile(n_clients, client_tile)
