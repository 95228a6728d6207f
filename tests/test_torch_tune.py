"""Port parity of `repro_torch.tune`: the launch-shape table, the tile
resolution and the autotuner, case for case as tests/test_tune.py holds
the JAX package's `repro.tune`, on the CPU.

The port's table is ``TUNE_sched_torch.json`` (``SCHED_TUNE_TORCH_PATH``
overrides it); its ``trial_tile`` is the stream kernel's warps per block,
clamped to [1, 8] and None unless set or tuned, and its ``client_tile``
the merge's association width, resolved exactly as the reference's
`resolve_sim_tiles` resolves it (held below over a grid of
configurations, table entries and modes).  The stage hooks are held inert
outside ``collect()``: no clock, no synchronize."""

import dataclasses
import itertools
import json
import time

import pytest
import torch

from repro.tune import table as jtable
from repro_torch.core import engine, simulate
from repro_torch.core.engine import KERNEL_POLICIES
from repro_torch.core.policies import PolicyConfig
from repro_torch.kernels.sched_select import kernel as tkernel
from repro_torch.tune import __main__ as tune_cli
from repro_torch.tune import autotune, profile, table

ENV = "SCHED_TUNE_TORCH_PATH"


def _key(policy="ect", backend="kernel", t=6, c=1, form="batch"):
    return table.config_key(policy=policy, backend=backend, n_servers=8,
                            n_requests=32, n_clients=c, n_trials=t,
                            window_size=8, form=form)


def _cfg(**kw):
    base = dict(n_servers=8, n_requests=32, n_trials=6, window_size=8,
                backend="kernel")
    base.update(kw)
    return simulate.SimConfig(**base)


# ------------------------------------------------------------ table cache

def test_load_table_missing_file_is_empty(monkeypatch, tmp_path):
    monkeypatch.setenv(ENV, str(tmp_path / "nope.json"))
    assert table.load_table() == {}


def test_load_table_corrupt_file_is_empty(monkeypatch, tmp_path):
    p = tmp_path / "TUNE.json"
    p.write_text('{"version": 1, "entries": {')      # interrupted write
    monkeypatch.setenv(ENV, str(p))
    assert table.load_table() == {}


def test_load_table_stale_version_is_empty(monkeypatch, tmp_path):
    p = tmp_path / "TUNE.json"
    p.write_text(json.dumps({"version": table.TABLE_VERSION + 1,
                             "entries": {_key(): {"trial_tile": 4,
                                                  "client_tile": 1}}}))
    monkeypatch.setenv(ENV, str(p))
    assert table.load_table() == {}


def test_load_table_wrong_schema_is_empty(monkeypatch, tmp_path):
    p = tmp_path / "TUNE.json"
    p.write_text(json.dumps(["not", "a", "table"]))
    monkeypatch.setenv(ENV, str(p))
    assert table.load_table() == {}


def test_store_roundtrip_and_backend_fallback(monkeypatch, tmp_path):
    monkeypatch.setenv(ENV, str(tmp_path / "TUNE.json"))
    entry = {"trial_tile": 6, "client_tile": 1, "sched_s": 0.5,
             "req_s": 384.0, "card": "NVIDIA H100 80GB HBM3",
             "power_limit": "700.00 W"}
    table.store(_key(backend="kernel"), entry)
    assert table.load_table()[_key(backend="kernel")] == entry
    # a jax-backend lookup falls back to the canonical kernel entry
    kw = dict(n_servers=8, n_requests=32, n_clients=1, n_trials=6,
              window_size=8)
    assert table.lookup(policy="ect", backend="jax", **kw) == entry
    assert table.lookup(policy="trh", backend="kernel", **kw) is None


def test_resolve_sim_tiles_tuned_miss_degrades_to_fused(monkeypatch,
                                                        tmp_path):
    monkeypatch.setenv(ENV, str(tmp_path / "empty.json"))
    kw = dict(policy="ect", backend="kernel", n_servers=8, n_requests=32,
              n_clients=1, n_trials=200, window_size=8)
    tuned = table.resolve_sim_tiles(mode="tuned", **kw)
    fused = table.resolve_sim_tiles(mode="fused", **kw)
    assert tuned == fused == (None, 1)
    # a populated cache takes over, clamped to the kernel's 8 warps
    table.store(table.config_key(form="batch", device_count=1, **kw),
                {"trial_tile": 999, "client_tile": 1})
    assert table.resolve_sim_tiles(mode="tuned", **kw) == (
        tkernel.MAX_WARPS_PER_BLOCK, 1)


def test_resolve_sim_tiles_explicit_params_win(monkeypatch, tmp_path):
    monkeypatch.setenv(ENV, str(tmp_path / "TUNE.json"))
    kw = dict(policy="ect", backend="kernel", n_servers=8, n_requests=32,
              n_clients=1, n_trials=200, window_size=8)
    table.store(table.config_key(form="batch", device_count=1, **kw),
                {"trial_tile": 8, "client_tile": 1})
    assert table.resolve_sim_tiles(mode="tuned", trial_tile=2, **kw) \
        == (2, 1)


def test_default_modes_keep_the_kernels_launch_shape():
    """Without an explicit or tuned trial tile the launch is the kernel's
    own WARPS_PER_BLOCK in either form: the reference's TPU trial tile is
    never carried into a launch."""
    for mode, form, c in itertools.product(("default", "fused"),
                                           ("batch", "grid"), (1, 4, 200)):
        tt, _ = table.resolve_sim_tiles(
            mode=mode, policy="ect", backend="kernel", n_servers=100,
            n_requests=2000, n_clients=c, n_trials=100, window_size=100,
            form=form)
        assert tt is None
    assert tkernel.resolve_warps("sched_stream") == 1
    assert tkernel.resolve_warps("sched_stream_grid") == 4
    assert [tkernel.resolve_warps("sched_stream", w)
            for w in (0, 1, 3, 8, 64)] == [1, 1, 3, 8, 8]


def test_default_path_is_the_ports_own_table(monkeypatch, tmp_path):
    monkeypatch.delenv(ENV, raising=False)
    assert table.default_path().endswith("TUNE_sched_torch.json")
    assert table.default_path() != jtable.default_path()
    monkeypatch.setenv(ENV, str(tmp_path / "x.json"))
    assert table.default_path() == str(tmp_path / "x.json")


def test_simconfig_rejects_unknown_tiles_mode():
    with pytest.raises(ValueError):
        _cfg(tiles="turbo")
    with pytest.raises(ValueError):
        _cfg(trial_tile=0)


# ---------------------------------------- client tile against the reference

def test_client_tile_matches_reference_resolver(monkeypatch, tmp_path):
    """Over (T, C, explicit tiles, table entry, mode), the port's
    client_tile is the reference's, both tables holding the same entry."""
    entries = (None, {"trial_tile": 16, "client_tile": 8},
               {"client_tile": 5}, {"trial_tile": 3}, {"client_tile": 0},
               {"trial_tile": "x", "client_tile": 300})
    for i, (t, c, form, ct, tt, entry, mode) in enumerate(itertools.product(
            (3, 100), (1, 4, 64, 200), ("batch", "grid"), (None, 2, 40),
            (None, 4), entries, table.TILE_MODES)):
        c = c if form == "grid" else 1
        kw = dict(policy="ect", backend="kernel", n_servers=100,
                  n_requests=2000, n_clients=c, n_trials=t,
                  window_size=100, form=form, trial_tile=tt,
                  client_tile=ct)
        paths = []
        for mod in (table, jtable):
            p = tmp_path / f"{mod.__name__}-{i}.json"
            if entry is not None:
                mod.store(mod.config_key(
                    policy="ect", backend="kernel", n_servers=100,
                    n_requests=2000, n_clients=c, n_trials=t,
                    window_size=100, form=form), entry, str(p))
            paths.append(str(p))
        got = table.resolve_sim_tiles(mode=mode, path=paths[0], **kw)
        want = jtable.resolve_sim_tiles(mode=mode, path=paths[1], **kw)
        assert got[1] == want[1], (mode, kw, entry)


# -------------------------------------------------------- tuner sweep

def test_candidate_tiles_clamped_and_deduped():
    cands = autotune.candidate_tiles(6, form="batch")
    assert cands == [(1, 1), (2, 1), (4, 1), (8, 1)]
    grid = autotune.candidate_tiles(100, 5, form="grid")
    assert grid == [(w, 5) for w in (1, 2, 4, 8)]
    grid = autotune.candidate_tiles(100, 64, form="grid")
    assert len(grid) == len(set(grid)) == 16
    assert all(1 <= tt <= tkernel.MAX_WARPS_PER_BLOCK and ct <= 64
               for tt, ct in grid)


def test_tune_config_deterministic_table_bytes(monkeypatch, tmp_path):
    """Same config + same injected timer -> byte-identical tables."""
    cfg = _cfg()
    pol = PolicyConfig(name="ect", threshold=0.05)

    def fake_timer():
        costs = iter(range(100))
        return lambda run: float(next(costs))     # first candidate wins

    blobs = []
    for name in ("a.json", "b.json"):
        p = tmp_path / name
        monkeypatch.setenv(ENV, str(p))
        key, entry = autotune.tune_config(cfg, pol, timer=fake_timer(),
                                          device="cpu")
        assert table.load_table()[key]["trial_tile"] == entry["trial_tile"]
        assert entry["card"] == "cpu" and entry["power_limit"] is None
        blobs.append(p.read_bytes())
    assert blobs[0] == blobs[1]


def test_tune_config_ties_within_spread_break_to_smaller_shape(
        monkeypatch, tmp_path):
    """A candidate whose least time reaches the fastest one's largest ties
    it, and the smaller shape of a tie wins; the entry keeps the winner's
    spread and the tied shapes."""
    per_shape = {1: [1.0, 1.1, 1.2], 2: [0.9, 1.0, 1.05], 4: [2.0] * 3,
                 8: [1.06, 1.5, 1.7]}
    calls = iter(sorted(per_shape))
    monkeypatch.setattr(autotune.profile, "device_times",
                        lambda run, reps, device: per_shape[next(calls)])
    _, entry = autotune.tune_config(
        _cfg(), PolicyConfig(name="ect", threshold=0.05),
        path=str(tmp_path / "t.json"), device="cpu")
    assert (entry["trial_tile"], entry["sched_s"]) == (1, 1.1)
    assert entry["spread_s"] == [1.0, 1.2]
    assert entry["ties"] == [[1, 1], [2, 1]]
    assert entry["candidates_s"] == [[1, 1, 1.1], [2, 1, 1.0], [4, 1, 2.0],
                                     [8, 1, 1.5]]


def test_tune_config_tie_keeps_the_default_association(monkeypatch,
                                                       tmp_path):
    """Per_client, a tie between client tiles goes to the configuration's
    own (the default 32 here), so tuning moves no result without a
    measured gain; a client tile faster beyond the spread still wins."""
    cfg = _cfg(client_model="per_client", n_clients=40, n_requests=80)
    pol = PolicyConfig(name="ect", threshold=0.05)
    cands = autotune.candidate_tiles(cfg.n_trials, 40, form="grid")
    assert {ct for _, ct in cands} == {8, 16, 32, 40}
    for fast, want in ((None, (1, 32)), ((2, 16), (2, 16))):
        shapes = iter(cands)
        monkeypatch.setattr(
            autotune.profile, "device_times",
            lambda run, reps, device: [0.5] * 3 if next(shapes) == fast
            else [1.0, 1.0, 1.01])
        _, entry = autotune.tune_config(cfg, pol, device="cpu",
                                        path=str(tmp_path / "t.json"))
        assert (entry["trial_tile"], entry["client_tile"]) == want


def test_device_times_on_cpu_are_sorted_walls():
    times = profile.device_times(lambda: torch.ones(8).sum(), reps=4,
                                 device="cpu")
    assert len(times) == 4 and times == sorted(times)
    assert all(t > 0.0 for t in times)


def test_cli_prints_the_table(tmp_path, capsys):
    p = tmp_path / "TUNE.json"
    table.store(_key(), {"trial_tile": 2, "client_tile": 1}, str(p))
    assert tune_cli.main(["--print", "--path", str(p)]) == 0
    assert json.loads(capsys.readouterr().out)["entries"] == {
        _key(): {"trial_tile": 2, "client_tile": 1}}
    assert tune_cli.main(["--tune", "no_such_preset"]) == 2
    assert set(tune_cli._presets()) == {"batch_ect", "batch_mlml",
                                        "batch_nltr", "per_client_4c",
                                        "per_client_64c"}


# ---------------------------------------- tuned tiles change no result

@pytest.mark.parametrize("policy", KERNEL_POLICIES)
def test_tuned_tiles_keep_results_bit_identical(monkeypatch, tmp_path,
                                                policy):
    """A tuned warps-per-block entry moves no result: run_trials under
    tiles="tuned" equals the default run field for field."""
    monkeypatch.setenv(ENV, str(tmp_path / "TUNE.json"))
    cfg = _cfg(n_trials=5, tiles="tuned")
    pol = PolicyConfig(name=policy, threshold=0.5)
    log_cfg = simulate.default_log_cfg(cfg)
    table.store(table.config_key(
        policy=policy, backend="kernel", n_servers=cfg.n_servers,
        n_requests=cfg.n_requests, n_clients=1, n_trials=cfg.n_trials,
        window_size=cfg.window_size), {"trial_tile": 3, "client_tile": 1})
    tuned = simulate.run_trials(0, cfg, pol, log_cfg, device="cpu")
    base = simulate.run_trials(0, dataclasses.replace(cfg, tiles="default"),
                               pol, log_cfg, device="cpu")
    for f in tuned._fields:
        assert torch.equal(getattr(tuned, f), getattr(base, f)), (policy, f)


# -------------------------------------------------------- stage hooks

def test_stage_outside_collect_reads_no_clock(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the main path read a clock or synchronized")

    monkeypatch.setattr(time, "perf_counter", boom)
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    with profile.stage("prep"):
        pass
    cfg = _cfg(n_trials=2)
    simulate.run_trials(0, cfg, PolicyConfig(name="rr"),
                        simulate.default_log_cfg(cfg), device="cpu")


def test_stage_inside_collect_accumulates(monkeypatch):
    """Under collect() the outermost stages are timed and a stage nested
    in a timed one stays inert (no clock, no synchronize): run_trials
    yields prep, sched and post, the engine called alone its own three."""
    cfg = _cfg(n_trials=2)
    pol = PolicyConfig(name="ect", threshold=0.05)
    log_cfg = simulate.default_log_cfg(cfg)
    with profile.collect() as stages:
        simulate.run_trials(0, cfg, pol, log_cfg, device="cpu")
        with profile.collect() as inner:
            with profile.stage("x"):
                pass
    assert set(stages) == {"prep", "sched", "post"}
    assert all(v >= 0.0 for v in stages.values())
    assert set(inner) == {"x"}

    _, _, works, states, traces, k_sched = simulate._prep_trials(
        simulate.trial_keys(0, cfg, "cpu"), cfg, log_cfg)
    with profile.collect() as engine_stages:
        engine.run_stream_batch(states, works, k_sched, policy=pol,
                                log_cfg=log_cfg, window_size=cfg.window_size,
                                traces=traces, window_dt=0.0)
    assert set(engine_stages) == {"engine_prep", "kernel", "book"}

    reads = []
    real = time.perf_counter
    monkeypatch.setattr(time, "perf_counter",
                        lambda: reads.append(1) or real())
    with profile.collect():
        with profile.stage("outer"):
            with profile.stage("inner"):
                pass
    assert len(reads) == 2


def test_pipeline_stage_profile_on_cpu():
    cfg = _cfg(n_trials=2)
    got = profile.pipeline_stage_profile(
        cfg, PolicyConfig(name="mlml"), simulate.default_log_cfg(cfg),
        reps=1, device="cpu")
    assert set(got) == {"prep_s", "sched_s", "post_s"}
    assert all(v > 0.0 for v in got.values())
