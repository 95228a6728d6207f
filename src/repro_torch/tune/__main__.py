"""CLI for the launch-shape autotuner.

``python -m repro_torch.tune --print``          dump the cached tile table
``python -m repro_torch.tune --tune <preset>``  re-tune a named configuration
``python -m repro_torch.tune --tune all``       re-tune every preset

The presets are the reference's: the shared_log trial grid at the
paper's §4 size (ect and the sort policies) and the per_client grid at 4
and 64 clients.  Tuning runs on the card; the table is
``TUNE_sched_torch.json`` at the repository root unless ``--path`` or
``$SCHED_TUNE_TORCH_PATH`` names another.
"""

from __future__ import annotations

import argparse
import json
import sys


def _presets():
    from repro_torch.core.policies import PolicyConfig
    from repro_torch.core.simulate import SimConfig

    base = dict(n_servers=100, n_requests=2000, n_trials=100,
                window_size=100, backend="kernel")
    pol = lambda name, thr=5.0: PolicyConfig(  # noqa: E731
        name=name, threshold=thr)
    return {
        "batch_ect": (SimConfig(**base), pol("ect", 0.05)),
        "batch_mlml": (SimConfig(**base), pol("mlml")),
        "batch_nltr": (SimConfig(**base), pol("nltr")),
        "per_client_4c": (SimConfig(client_model="per_client", n_clients=4,
                                    **base), pol("ect", 0.05)),
        "per_client_64c": (SimConfig(client_model="per_client", n_clients=64,
                                     **base), pol("ect", 0.05)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tune",
                                 description=__doc__)
    ap.add_argument("--print", action="store_true", dest="print_table",
                    help="dump the cached tile table as JSON")
    ap.add_argument("--tune", metavar="PRESET",
                    help="re-tune a named config preset (or 'all')")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed repetitions per candidate (default 3)")
    ap.add_argument("--path", default=None,
                    help="table path override (default: repository-root "
                         "TUNE_sched_torch.json or $SCHED_TUNE_TORCH_PATH)")
    args = ap.parse_args(argv)

    from repro_torch.tune import table

    if not args.print_table and not args.tune:
        ap.print_help()
        return 2

    if args.tune:
        from repro_torch.tune import autotune

        presets = _presets()
        if args.tune != "all" and args.tune not in presets:
            print(f"unknown preset {args.tune!r}; choose from "
                  f"{sorted(presets)} or 'all'", file=sys.stderr)
            return 2
        names = sorted(presets) if args.tune == "all" else [args.tune]
        for name in names:
            cfg, pol = presets[name]
            key, entry = autotune.tune_config(cfg, pol, reps=args.reps,
                                              path=args.path)
            print(f"{name}: {key}\n  -> {json.dumps(entry, sort_keys=True)}")

    if args.print_table:
        print(json.dumps({"version": table.TABLE_VERSION,
                          "entries": table.load_table(args.path)},
                         indent=1, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
