"""Tests that need the card (marker ``gpu``): the CUDA kernels against
their plain PyTorch versions on the same CUDA tensors.

Stream kernels: bit-exact on choices, latencies, loads, window loads,
metrics and the merged outputs (cm_wloads, cm_metrics, cm_lats, cm_lval);
probs to 1e-6 and ewma/est to 1e-6 relative (the contract the CPU tests
hold against the JAX package).  Flash attention: 2e-5 in float32 and
2e-2 in bfloat16, the JAX package's own tolerances; the reduced serving
path on the card against the same parameters on the CPU.  Without a card
every test skips with a reason; the file imports torch and numpy only, so
it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import simulate
from repro_torch.core.policies import PolicyConfig
from repro_torch.core.policy_core import MET_P99
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.flash_attention import kernel as fkernel
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.sched_select import kernel as tkernel
from repro_torch.kernels.sched_select import ops as tops
from repro_torch.kernels.sched_select import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as T
from torch_flash_cases import DANUBE_CASE, FLASH_CASES, flash_inputs
from torch_parity import (BATCH_CASES, GRID_CASES, KW, MERGE_CASES,
                          assert_grid_outputs, assert_stream_outputs,
                          batch_case, grid_case, merge_case, port_batch,
                          table_variant)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _check_stream_on_card(arrays, device, ctx, **kw):
    """One launch of the 1-D kernel against the plain version on the
    card, on the same operands."""
    before = tkernel.LAUNCHES["sched_stream"]
    got = port_batch(arrays, device, **kw)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES["sched_stream"] == before + 1
    want = port_batch(arrays, device, fn=tops.sched_stream_batch_plain, **kw)
    assert_stream_outputs(got, want, kw["window_size"], ctx)


@pytest.mark.parametrize("case", enumerate(BATCH_CASES),
                         ids=lambda c: "-".join(map(str, c[1])))
def test_cuda_kernel_matches_plain_on_card(case, cuda_device):
    idx, (t, m, n_win, win, policy) = case
    arrays = batch_case(t, m, n_win, win, seed=1000 + idx)
    _check_stream_on_card(arrays, cuda_device, f"cuda {policy} {case[1]}",
                          **dict(KW, n_servers=m, window_size=win,
                                 policy=policy))


# the stream kernel's edges (T, M, W, window): T above the 132 SMs (one
# warp per block in the 1-D form), the window and M_pad at their 1024 caps
EDGE_CASES = [(140, 37, 2, 16), (2, 1000, 1, 1024)]


@pytest.mark.parametrize("policy", tops.POLICIES)
@pytest.mark.parametrize("case", EDGE_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_kernel_edges_match_plain_on_card(case, policy, cuda_device):
    t, m, n_win, win = case
    arrays = batch_case(t, m, n_win, win, seed=2000 + t)
    _check_stream_on_card(arrays, cuda_device, f"cuda edge {policy} {case}",
                          **dict(KW, n_servers=m, window_size=win,
                                 policy=policy))


@pytest.mark.parametrize("policy", tops.POLICIES)
@pytest.mark.parametrize("table", ["signed_zeros", "warm", "pad_wins"])
def test_cuda_kernel_initial_tables_on_card(table, policy, cuda_device):
    """Loads of -0.0 and +0.0 with exactly tied scores (the argmin's key
    and tie break), an est row ewma does not give (the first request
    reads the table's row), and a padding lane winning ect's argmin."""
    t, m, n_win, win = 4, 37, 3, 16
    arrays = list(batch_case(t, m, n_win, win, seed=3000))
    arrays[3] = table_variant(arrays[3], table, m)
    _check_stream_on_card(arrays, cuda_device, f"cuda {table} {policy}",
                          **dict(KW, n_servers=m, window_size=win,
                                 policy=policy))


@pytest.mark.parametrize("policy", ["ect", "mlml", "nltr", "trh", "rr",
                                    "two_choice"])
def test_run_trials_on_card_matches_plain(policy, cuda_device):
    """The slice end to end on the card: one launch per `run_trials`, and
    the same prep through the plain version gives the same TrialResult."""
    cfg = simulate.SimConfig(
        n_servers=37, n_requests=250, n_trials=5, window_size=60,
        scenario=simulate.ScenarioConfig("transient"))
    log = simulate.default_log_cfg(cfg)
    pol = PolicyConfig(name=policy, threshold=0.05 if policy == "ect"
                       else 5.0)
    before = tkernel.LAUNCHES["sched_stream"]
    res = simulate.run_trials(3, cfg, pol, log)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES["sched_stream"] == before + 1
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    prep = simulate._prep_trials(gen, cfg, log, cuda_device)
    init, mask, works, states, traces, seeds = prep
    sched = simulate._sched_trials(cfg, pol, log, works, states, seeds,
                                   traces,
                                   stream_batch=tops.sched_stream_batch_plain)
    plain = simulate._post_trials(cfg, init, mask, works, traces, *sched)
    for f in res._fields:
        np.testing.assert_array_equal(getattr(res, f).cpu().numpy(),
                                      getattr(plain, f).cpu().numpy(),
                                      err_msg=f"{policy}/{f}")


# 2-D edges: N = 16 and 17 requests per stream, on either side of the
# 2-D form's p99 held one latency per lane in registers (N <= 16 lanes per
# stream); N = 32 and 33, the same edge for the 1-D form's 32 lanes; the
# window and M_pad at their 1024 caps, two streams to a warp
GRID_EDGE_CASES = [(2, 9, 37, 1, 16, 4, True, 1),
                   (2, 9, 37, 1, 17, 4, True, 1),
                   (2, 9, 37, 2, 16, 4, True, 1),
                   (2, 9, 37, 3, 11, 4, True, 1),
                   (2, 3, 1000, 1, 1024, 2, True, 1)]


@pytest.mark.parametrize("policy", tops.POLICIES)
@pytest.mark.parametrize("case", enumerate(GRID_CASES + GRID_EDGE_CASES),
                         ids=lambda c: "-".join(map(str, c[1])))
def test_cuda_grid_kernels_match_plain_on_card(case, policy, cuda_device):
    idx, (t, c, m, n_win, win, ct, merge_mean, n_phantom) = case
    arrays = grid_case(t, c, m, n_win, win, n_phantom, seed=idx)
    kw = dict(KW, n_servers=m, window_size=win, policy=policy,
              client_tile=ct, merge_mean=merge_mean)
    before = dict(tkernel.LAUNCHES)
    got = port_batch(arrays, cuda_device, fn=tops.sched_stream_grid, **kw)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES == dict(
        before, sched_stream_grid=before["sched_stream_grid"] + 1,
        client_merge=before["client_merge"] + 1)
    want = port_batch(arrays, cuda_device, fn=tops.sched_stream_grid_plain,
                      **kw)
    assert_grid_outputs(got, want, win, f"cuda grid {policy} {case[1]}")


@pytest.mark.parametrize("merge_mean", [True, False])
@pytest.mark.parametrize("case", enumerate(MERGE_CASES),
                         ids=lambda c: "-".join(map(str, c[1])))
def test_cuda_merge_matches_plain_on_card(case, merge_mean, cuda_device):
    """The merge kernel alone on operands made directly: the main path's
    shapes, C·N past its shared-memory staging, ct not dividing C and
    above 32, an all-phantom trial, and a p99 below the k-th valid
    latency; every output bit-exact with the plain version."""
    idx, (t, c, n, n_win, m_pad, ct, kind) = case
    args = [torch.from_numpy(a).to(cuda_device)
            for a in merge_case(t, c, n, n_win, m_pad, kind, seed=idx)]
    before = tkernel.LAUNCHES["client_merge"]
    got = tkernel.client_merge_call(*args, client_tile=ct,
                                    merge_mean=merge_mean)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES["client_merge"] == before + 1
    want = tref.client_merge_ref(*args, client_tile=ct, merge_mean=merge_mean)
    for name, a, b in zip(("cm_wloads", "cm_metrics", "cm_lats", "cm_lval"),
                          got, want):
        np.testing.assert_array_equal(a.cpu().numpy().view(np.uint32),
                                      b.cpu().numpy().view(np.uint32),
                                      err_msg=name)
    if kind == "far_max" and merge_mean:
        lat, val = args[2][0].flatten(), args[3][0].flatten() != 0
        k = int(np.ceil(np.float32(0.99) * np.float32(val.sum().item())))
        v_k = lat[val].sort().values[k - 1].item()
        assert got[1][0, MET_P99].item() < v_k


@pytest.mark.parametrize("policy", ["ect", "two_choice"])
def test_per_client_run_trials_on_card_matches_plain(policy, cuda_device):
    """per_client end to end on the card, with whole phantom clients and
    C not a multiple of the client tile: one launch of each kernel per
    `run_trials`, and the same prep through the plain version gives the
    same TrialResult."""
    cfg = simulate.SimConfig(
        n_servers=11, n_clients=7, n_requests=5, n_trials=2, window_size=4,
        client_model="per_client", client_tile=2,
        scenario=simulate.ScenarioConfig("transient"))
    log = simulate.default_log_cfg(cfg)
    pol = PolicyConfig(name=policy, threshold=0.05)
    before = dict(tkernel.LAUNCHES)
    with pytest.warns(UserWarning, match="window clamp"):
        res = simulate.run_trials(3, cfg, pol, log)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES["sched_stream_grid"] == \
        before["sched_stream_grid"] + 1
    assert tkernel.LAUNCHES["client_merge"] == before["client_merge"] + 1
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    init, mask, works, states, traces, seeds = simulate._prep_trials(
        gen, cfg, log, cuda_device)
    with pytest.warns(UserWarning, match="window clamp"):
        sched = simulate._sched_trials(
            cfg, pol, log, works, states, seeds, traces,
            stream_grid=tops.sched_stream_grid_plain)
    plain = simulate._post_trials(cfg, init, mask, works, traces, *sched)
    for f in res._fields:
        np.testing.assert_array_equal(getattr(res, f).cpu().numpy(),
                                      getattr(plain, f).cpu().numpy(),
                                      err_msg=f"{policy}/{f}")


@pytest.mark.parametrize("policy", ["minload", "two_random"])
def test_sched_select_on_card_matches_plain(policy, cuda_device):
    rng = np.random.default_rng(5)
    c, n, m = 5, 300, 37
    args = [torch.from_numpy(a).to(cuda_device) for a in (
        rng.integers(0, 8 * m, (c, n)).astype(np.int32),
        rng.uniform(1.0, 20.0, (c, n)).astype(np.float32),
        rng.uniform(0.0, 60.0, (c, m)).astype(np.float32),
        rng.integers(0, 2 ** 32, (c,)))]
    kw = dict(n_servers=m, threshold=2.0, lam=50.0, policy=policy)
    before = tkernel.LAUNCHES["sched_stream"]
    got = tops.sched_select(*args, **kw)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES["sched_stream"] == before + 1
    want = tops.sched_select_plain(*args, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# the ablate levels (1-D form only): a few streams, and T above the SMs
ABLATE_CASES = [(5, 37, 4, 32), (140, 37, 2, 16)]


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("policy", tops.POLICIES)
@pytest.mark.parametrize("case", ABLATE_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_ablate_levels_match_plain_on_card(case, policy, level,
                                                cuda_device):
    """An ablated launch against the plain version at the same level:
    every output bit for bit, the zeros past the dropped phase included;
    it counts as an ablated launch, never as the main path's."""
    t, m, n_win, win = case
    arrays = batch_case(t, m, n_win, win, seed=4000 + t)
    kw = dict(KW, n_servers=m, window_size=win, policy=policy, ablate=level)
    before = dict(tkernel.LAUNCHES)
    got = port_batch(arrays, cuda_device, **kw)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES == dict(
        before, sched_stream_ablate=before["sched_stream_ablate"] + 1)
    want = port_batch(arrays, cuda_device, fn=tops.sched_stream_batch_plain,
                      **kw)
    for name, a, b in zip(("choices", "latencies", "final_tables",
                           "window_loads", "metrics"), got, want):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=f"{policy} {level} {name}")
    assert not got[4].any() and (level < 2 or not (got[0].any()
                                                   or got[1].any()))


def test_cuda_ablate_level_zero_and_refusals(cuda_device):
    """Level 0 is the unablated launch; the 2-D form refuses a level, in
    the wrapper and in the C entry (which also refuses a level past 3)."""
    t, m, n_win, win = 5, 37, 4, 32
    arrays = batch_case(t, m, n_win, win, seed=9)
    kw = dict(KW, n_servers=m, window_size=win, policy="nltr")
    for a, b in zip(port_batch(arrays, cuda_device, ablate=0, **kw),
                    port_batch(arrays, cuda_device, **kw)):
        np.testing.assert_array_equal(a, b)
    garrays = grid_case(2, 3, m, n_win, win, 1, seed=9)
    with pytest.raises(ValueError, match="1-D"):
        port_batch(garrays, cuda_device, fn=tops.sched_stream_grid,
                   ablate=1, **kw)
    obj, lens, valid, tables, seeds, rates = (
        torch.from_numpy(x.astype(np.int64) if x.dtype == np.uint32 else x)
        .to(cuda_device) for x in garrays)
    operands = tops.pad_operands(obj, lens, valid, tables, seeds, rates)
    with pytest.raises(RuntimeError, match="invalid argument"):
        tkernel._launch_streams(*operands, form="sched_stream_grid",
                                lead=(2, 3), ablate=1, alpha=0.25, **kw)


@pytest.mark.parametrize("policy", ["ect", "mlml", "nltr", "trh", "rr",
                                    "two_choice"])
def test_trial_tile_is_a_launch_shape_on_card(policy, cuda_device):
    """run_trials with trial_tile (the stream kernel's warps per block)
    in 1, 2, 4, 8 equals the default launch, field for field, under the
    shared log and per_client."""
    pol = PolicyConfig(name=policy, threshold=0.05 if policy == "ect"
                       else 5.0)
    scn = simulate.ScenarioConfig("transient")
    for cfg in (simulate.SimConfig(n_servers=37, n_requests=250, n_trials=9,
                                   window_size=60, scenario=scn),
                simulate.SimConfig(n_servers=37, n_requests=250, n_trials=3,
                                   n_clients=25, window_size=10,
                                   client_model="per_client",
                                   scenario=scn)):
        log = simulate.default_log_cfg(cfg)
        base = simulate.run_trials(3, cfg, pol, log)
        for tt in (1, 2, 4, 8):
            res = simulate.run_trials(
                3, dataclasses.replace(cfg, trial_tile=tt), pol, log)
            for f in res._fields:
                assert torch.equal(getattr(res, f), getattr(base, f)), (
                    policy, cfg.client_model, tt, f)


def test_stream_wrappers_do_not_synchronize(cuda_device):
    """The stream kernels' wrappers queue their work and return: no call
    in them waits for the card (torch's sync debug mode raises on one)."""
    t, m, n_win, win = 5, 37, 4, 32
    kw = dict(KW, n_servers=m, window_size=win, policy="ect")
    ops_in = [torch.from_numpy(x.astype(np.int64) if x.dtype == np.uint32
                               else x).to(cuda_device)
              for x in batch_case(t, m, n_win, win, seed=12)]
    call_in = tops.pad_operands(*ops_in)
    g_in = [torch.from_numpy(x.astype(np.int64) if x.dtype == np.uint32
                             else x).to(cuda_device)
            for x in grid_case(2, 5, m, 2, 8, 1, seed=12)]
    gkw = dict(kw, window_size=8)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tkernel.sched_stream_call(*call_in, alpha=0.25, **kw)
        tkernel.sched_stream_call(*call_in, alpha=0.25, ablate=2, **kw)
        tops.sched_stream_batch(*ops_in, **kw)
        tops.sched_stream_grid(*g_in, client_tile=2, **gkw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_tune_cli_on_card_names_the_card(tmp_path, cuda_device):
    """`python -m repro_torch.tune --tune batch_ect` writes its winner with
    the card's name and power limit into the table it is pointed at."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    path = tmp_path / "TUNE.json"
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    subprocess.run([sys.executable, "-m", "repro_torch.tune", "--tune",
                    "batch_ect", "--reps", "1", "--path", str(path)],
                   check=True, env=env, timeout=600)
    entries = json.loads(path.read_text())["entries"]
    (key, entry), = entries.items()
    assert "policy=ect" in key and "form=batch" in key
    assert entry["card"] == torch.cuda.get_device_name(0)
    assert entry["power_limit"] and entry["trial_tile"] in (1, 2, 4, 8)


# the kernel's own shapes beyond the JAX tests' cases: gemma-2b's head
# (hd 256, MQA group 8) at a short S, and tiles below the 64-row maximum
CARD_FLASH_CASES = FLASH_CASES + [
    DANUBE_CASE, (2, 130, 8, 1, 256, None, None, "bfloat16"),
    (1, 70, 4, 2, 64, 16, None, "bfloat16")]


# the wgmma kernel: the bf16 twin of every case above, then gemma-2b's
# head (hd 256) at S past one query block, ragged and at the timed 2048,
# and danube's head dim 120 with a window of 64
WGMMA_CASES = [(*c[:7], "bfloat16") for c in CARD_FLASH_CASES] + [
    (1, 130, 8, 1, 256, None, None, "bfloat16"),
    (1, 1000, 8, 1, 256, None, None, "bfloat16"),
    (1, 2048, 8, 1, 256, None, None, "bfloat16"),
    (1, 1000, 8, 2, 120, 64, None, "bfloat16")]


def _card_flash(case, seed, device):
    b, s, h, kv, hd, _, _, dtype = case
    return [torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))
            for a in flash_inputs(b, s, h, kv, hd, seed)]


def _routed_launch(q, k, v, route, **kw):
    """``flash_attention`` on the card, which must launch the kernel of
    ``route`` once and the other kernel never."""
    before = dict(fkernel.LAUNCHES)
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    key = f"flash_attention_{route}"
    assert fkernel.LAUNCHES == dict(before, **{key: before[key] + 1})
    return got


@pytest.mark.parametrize("case", CARD_FLASH_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_kernel_matches_plain_on_card(case, cuda_device):
    assert not torch.backends.cuda.matmul.allow_tf32
    q, k, v = _card_flash(case, case[1], cuda_device)
    kw = dict(window=case[5], chunk=case[6])
    route = "wgmma" if case[7] == "bfloat16" else "simt"
    got = _routed_launch(q, k, v, route, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    tol = 2e-2 if case[7] == "bfloat16" else 2e-5
    assert got.dtype == q.dtype
    assert (got.float() - want.float()).abs().max().item() < tol


@pytest.mark.parametrize("case", WGMMA_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_wgmma_kernel_matches_plain_on_card(case, cuda_device):
    q, k, v = _card_flash(case, 100 + case[1], cuda_device)
    kw = dict(window=case[5], chunk=case[6])
    got = _routed_launch(q, k, v, "wgmma", **kw)
    want = flash_attention_plain(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    assert (got.float() - want.float()).abs().max().item() < 2e-2


@pytest.mark.parametrize("dtype,hd", [("float32", 256), ("float32", 64),
                                      ("bfloat16", 250), ("bfloat16", 20)])
def test_flash_simt_route_on_card(dtype, hd, cuda_device):
    """f32 operands and head dims that are not a multiple of 8 take the
    SIMT kernel."""
    case = (1, 130, 4, 2, hd, 64, None, dtype)
    q, k, v = _card_flash(case, 9, cuda_device)
    got = _routed_launch(q, k, v, "simt", window=64)
    want = flash_attention_plain(q, k, v, window=64)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    assert (got.float() - want.float()).abs().max().item() < tol


@pytest.mark.parametrize("kw", [
    dict(causal=False, window=8), dict(window=8, chunk=16, is_global=True),
    dict(block_q=16, block_k=16), dict(block_q=32, block_k=64),
    dict(block_q=64, block_k=32), dict(chunk=32, block_q=48, block_k=24)],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_flash_kernel_options_on_card(kw, cuda_device):
    q, k, v = _card_flash((1, 128, 4, 2, 32, None, None, "float32"), 7,
                          cuda_device)
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    assert (got - want).abs().max().item() < 2e-5


@pytest.mark.parametrize("arch", ["gemma-2b", "stablelm-1.6b",
                                  "h2o-danube-3-4b"])
def test_reduced_serve_on_card_matches_cpu(arch, cuda_device):
    """The serving path on the card (the flash kernel in the prefill)
    against the same parameters and prompts on the CPU (its plain
    version), in float32 compute: the prefill logits to 1e-4 and the
    greedy tokens exactly."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype="float32")
    params = T.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (2, 40)))
    flash_cfg = dataclasses.replace(cfg, use_pallas_attn=True)
    want_logits = T.forward_train(params, {"tokens": prompts}, flash_cfg)
    want_tokens, _, _ = tserve.generate(params, prompts, cfg, 6)
    params.to(cuda_device)
    prompts = prompts.to(cuda_device)
    before = dict(fkernel.LAUNCHES)
    tokens, _, _ = tserve.generate(params, prompts, cfg, 6)
    # float32 operands: the SIMT kernel, once per layer
    assert fkernel.LAUNCHES == dict(
        before, flash_attention_simt=before["flash_attention_simt"]
        + cfg.n_layers)
    logits = T.forward_train(params, {"tokens": prompts}, flash_cfg)
    assert (logits.cpu() - want_logits).abs().max().item() < 1e-4
    assert torch.equal(tokens.cpu(), want_tokens)


@pytest.mark.parametrize("arch", ["gemma-2b", "stablelm-1.6b",
                                  "h2o-danube-3-4b"])
def test_reduced_bf16_prefill_on_card_takes_wgmma(arch, cuda_device,
                                                  monkeypatch):
    """bf16 compute on the card: the prefill's attention goes through the
    wgmma kernel, once per layer, and its logits agree with the same
    forward pass with `attention_ref` in the kernel's place to 0.02 of
    the largest |logit| (chip_smoke's serve check)."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              use_pallas_attn=True)
    params = T.init_lm(torch.Generator(device=cuda_device).manual_seed(0),
                       cfg, device=cuda_device)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (2, 200))).to(cuda_device)
    before = dict(fkernel.LAUNCHES)
    got = T.forward_train(params, {"tokens": prompts}, cfg).float()
    torch.cuda.synchronize()
    assert fkernel.LAUNCHES == dict(
        before, flash_attention_wgmma=before["flash_attention_wgmma"]
        + cfg.n_layers)
    monkeypatch.setattr(fops, "flash_attention", flash_attention_plain)
    want = T.forward_train(params, {"tokens": prompts}, cfg).float()
    assert (got - want).abs().max().item() <= 0.02 * want.abs().max().item()


def test_flash_wgmma_refuses_misaligned_operands(cuda_device):
    """A TMA tensor map needs a 16-byte-aligned base: the wrapper raises
    for a contiguous view that starts off one."""
    q, k, v = _card_flash((1, 64, 2, 1, 32, None, None, "bfloat16"), 3,
                          cuda_device)
    flat = torch.zeros(q.numel() + 1, dtype=q.dtype, device=cuda_device)
    shifted = flat[1:].view(q.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte boundary"):
        flash_attention(shifted, k, v)
