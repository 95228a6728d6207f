"""Profiling and launch-shape tuning of the stream kernels.

Counterpart of the JAX package's ``repro.tune``:

* :mod:`repro_torch.tune.table` — the versioned on-disk tile table
  (``TUNE_sched_torch.json``) and :func:`~repro_torch.tune.table.
  resolve_sim_tiles`, the one resolution point of `simulate._sched_trials`;
* :mod:`repro_torch.tune.profile` — the stage hooks of `simulate` and
  `engine`, the timers, and the differential kernel phase profiler built
  on the stream kernel's ``ablate`` levels;
* :mod:`repro_torch.tune.autotune` — the candidate sweep that times
  launch shapes and caches the winner (imported lazily: it depends on
  `repro_torch.core.simulate`, which imports :mod:`~repro_torch.tune.table`).

``python -m repro_torch.tune --print`` dumps the cached table;
``python -m repro_torch.tune --tune <preset>`` re-tunes a named config.
"""

from repro_torch.tune import profile, table  # noqa: F401
from repro_torch.tune.table import (config_key, load_table,  # noqa: F401
                                    resolve_sim_tiles, save_table)
