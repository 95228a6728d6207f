"""Tests that need the card (marker ``gpu``): the CUDA kernels against
their plain PyTorch versions on the same CUDA tensors.

Stream kernels: bit-exact on choices, latencies, loads, window loads,
metrics and the merged outputs (cm_wloads, cm_metrics, cm_lats, cm_lval);
probs to 1e-6 and ewma/est to 1e-6 relative (the contract the CPU tests
hold against the JAX package).  Flash attention: 2e-5 in float32 and
2e-2 in bfloat16, the JAX package's own tolerances; the reduced serving
path on the card against the same parameters on the CPU.  Training: the
reduced train steps on the card against the CPU to
tests/test_torch_train.py's tolerances (the MoE configurations' too, and
`apply_moe` card against CPU), the state-space and recurrent models
(reduced jamba and xlstm) card against CPU within 1e-4 of the largest
value, the chunkwise mLSTM against the sequential one on the card and
jamba's bf16 prefill through the wgmma kernel, M-RoPE and the reduced
qwen2-vl (patches and positions) card against CPU and its bf16 prefill
through the wgmma kernel, the flash route's refusal under autograd, and
a resume on the card from a checkpoint, and the sharded train step (an
NCCL world of one bit-equal to the unsharded step; gloo worlds of 2 and
4 ranks sharing the card, tests/torch_sharding_worker.py).  The contract
checker with its SASS layer (it needs the CUDA toolkit).  Without a card
every test skips with a reason; the file imports torch and numpy only, so
it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch import random
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


def _check_stream_on_card(arrays, device, ctx, key="sched_stream", **kw):
    """One launch of the 1-D kernel (counted under ``key``: the shared or
    the global-memory instance) against the plain version on the card, on
    the same operands."""
    before = dict(tkernel.LAUNCHES)
    got = port_batch(arrays, device, **kw)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES == dict(before, **{key: before[key] + 1})
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
# warp per block in the 1-D form), the window and M_pad at 1024, and past
# 1024 up to a block's shared memory: M_pad 2048 with window 2048, M_pad
# 4096 with window 1024
EDGE_CASES = [(140, 37, 2, 16), (2, 1000, 1, 1024), (2, 2000, 1, 2048),
              (2, 4000, 1, 1024)]


@pytest.mark.parametrize("policy", tops.POLICIES)
@pytest.mark.parametrize("case", EDGE_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_kernel_edges_match_plain_on_card(case, policy, cuda_device):
    t, m, n_win, win = case
    arrays = batch_case(t, m, n_win, win, seed=2000 + t)
    _check_stream_on_card(arrays, cuda_device, f"cuda edge {policy} {case}",
                          **dict(KW, n_servers=m, window_size=win,
                                 policy=policy))


# (window, M_pad, policy, shared-memory words a stream needs): the CPU
# test's cases (tests/test_torch_kernel.py), here from the built library
BUDGET_CASES = [(2048, 2048, "mlml", 36928), (1024, 4096, "nltr", 46144),
                (1024, 8192, "ect", 78912), (4096, 128, "minload", 25664)]


@pytest.mark.parametrize("window,m_pad,policy,words", BUDGET_CASES)
def test_stream_budget_is_the_cards_opt_in_shared_memory(
        window, m_pad, policy, words, cuda_device):
    """The library counts a stream's words as `configure` sizes its
    shared memory and reads the budget from the device; a stream within
    it takes the shared instance, one past it the global-memory instance
    with a workspace of its bytes (nothing is refused), as
    `stream_occupancy` reports."""
    need, budget = tkernel.stream_budget(policy, m_pad, window)
    assert need == 4 * words
    props = torch.cuda.get_device_properties(cuda_device)
    assert budget == props.shared_memory_per_block_optin
    m = m_pad - 50
    occ = tkernel.stream_occupancy("sched_stream", policy, m, m_pad, window)
    if need <= budget:
        assert tkernel.check_stream_domain(policy, m_pad, window) == \
            ("shared", 0)
        assert occ[3] == "shared" and 0 < occ[2] <= budget
        return
    assert tkernel.check_stream_domain(policy, m_pad, window, 2) == \
        ("global", 2 * need)
    assert occ[3] == "global" and occ[2] == 0 and occ[0] > 0
    _check_stream_on_card(batch_case(2, m, 1, window, seed=5), cuda_device,
                          f"global {policy} M_pad={m_pad}",
                          key="sched_stream_global",
                          **dict(KW, n_servers=m, window_size=window,
                                 policy=policy))


# past every policy's shared-memory budget on the H100 (the global-memory
# instance): M_pad 8,192 with window 1,024, M_pad 16,384 with window 512
OVER_BUDGET_CASES = [(8142, 1024), (16334, 512)]


@pytest.mark.parametrize("policy", tops.POLICIES)
@pytest.mark.parametrize("case", OVER_BUDGET_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_global_instance_past_the_budget_matches_plain_on_card(
        case, policy, cuda_device):
    """Both forms and the merge at shapes no block's shared memory holds:
    the 1-D form at T = 2, the 2-D form at T = 1, C = 3 (one phantom
    client) with the merge, each one launch of its global instance,
    against the plain versions on the same operands."""
    m, win = case
    kw = dict(KW, n_servers=m, window_size=win, policy=policy)
    _check_stream_on_card(batch_case(2, m, 1, win, seed=41), cuda_device,
                          f"global {policy} {case}",
                          key="sched_stream_global", **kw)
    arrays = grid_case(1, 3, m, 1, win, 1, seed=42)
    gkw = dict(kw, client_tile=2, merge_mean=policy != "rr")
    before = dict(tkernel.LAUNCHES)
    got = port_batch(arrays, cuda_device, fn=tops.sched_stream_grid, **gkw)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES == dict(
        before, sched_stream_grid_global=before["sched_stream_grid_global"]
        + 1, client_merge=before["client_merge"] + 1)
    want = port_batch(arrays, cuda_device, fn=tops.sched_stream_grid_plain,
                      **gkw)
    assert_grid_outputs(got, want, win, f"global grid {policy} {case}")


@pytest.mark.parametrize("policy", tops.POLICIES)
def test_global_instance_equals_shared_instance_on_card(policy,
                                                        cuda_device):
    """Only the address space moves: at shapes that fit shared memory,
    the global-memory instance (``instance="global"`` of the private
    launch) returns every output bit for bit as the shared one, in the
    1-D form at ablate levels 0-3 and in the 2-D form (half-warp
    streams)."""
    t, m, n_win, win = 5, 300, 3, 40
    arrays = batch_case(t, m, n_win, win, seed=43)
    ops = tops.pad_operands(*(torch.from_numpy(
        x.astype(np.int64) if x.dtype == np.uint32 else x).to(cuda_device)
        for x in arrays))
    kw = dict(KW, alpha=0.25, n_servers=m, window_size=win, policy=policy)
    def both(operands, **kwargs):
        runs = [tkernel._launch_streams(*operands, instance=inst, **kwargs)
                for inst in (None, "global")]
        assert [r[0] for r in runs] == ["shared", "global"]
        return [r[1] for r in runs]

    for level in tkernel.ABLATE_LEVELS:
        shared, glob = both(ops, form="sched_stream", lead=(t,),
                            ablate=level, **kw)
        for a, b in zip(shared, glob):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
                (policy, level)
    garrays = grid_case(2, 3, m, n_win, win, 1, seed=44)
    gops = tops.pad_operands(*(torch.from_numpy(
        x.astype(np.int64) if x.dtype == np.uint32 else x).to(cuda_device)
        for x in garrays))
    shared, glob = both(gops, form="sched_stream_grid", lead=(2, 3), **kw)
    for a, b in zip(shared, glob):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), policy


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
    prep = simulate._prep_trials(
        simulate.trial_keys(3, cfg, cuda_device), cfg, log)
    init, mask, works, states, traces, k_sched = prep
    sched = simulate._sched_trials(cfg, pol, log, works, states, k_sched,
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
# window and M_pad at 1024, two streams to a warp; M_pad 2048 with window
# 2048 and M_pad 4096 with window 1024, where a sort policy's two streams
# (and at 4096 any policy's) no longer fit a block and a stream takes a
# whole warp
GRID_EDGE_CASES = [(2, 9, 37, 1, 16, 4, True, 1),
                   (2, 9, 37, 1, 17, 4, True, 1),
                   (2, 9, 37, 2, 16, 4, True, 1),
                   (2, 9, 37, 3, 11, 4, True, 1),
                   (2, 3, 1000, 1, 1024, 2, True, 1),
                   (1, 3, 2000, 1, 2048, 2, False, 1),
                   (1, 3, 4000, 1, 1024, 2, True, 1)]


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
    init, mask, works, states, traces, k_sched = simulate._prep_trials(
        simulate.trial_keys(3, cfg, cuda_device), cfg, log)
    with pytest.warns(UserWarning, match="window clamp"):
        sched = simulate._sched_trials(
            cfg, pol, log, works, states, k_sched, traces,
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


@pytest.mark.filterwarnings("ignore:per_client window clamp")
@pytest.mark.parametrize("client_model", ["shared_log", "per_client"])
@pytest.mark.parametrize("policy", ["ect", "mlml", "nltr", "trh", "rr",
                                    "two_choice"])
def test_eager_engine_on_card_equals_kernel_path(policy, client_model,
                                                 cuda_device):
    """`run_trials(backend="jax")` on the card, at a mid size, launches
    none of the port's kernels and gives the kernel path's TrialResult bit
    for bit on the same seed."""
    cfg = simulate.SimConfig(
        n_servers=100, n_requests=600, n_trials=8, window_size=100,
        n_clients=40, client_model=client_model,
        scenario=simulate.ScenarioConfig("transient"))
    log = simulate.default_log_cfg(cfg)
    pol = PolicyConfig(name=policy, threshold=0.05 if policy == "ect"
                       else 5.0, rng="lcg")
    kern = simulate.run_trials(4, cfg, pol, log)
    before = dict(tkernel.LAUNCHES)
    eager = simulate.run_trials(4, dataclasses.replace(cfg, backend="jax"),
                                pol, log)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES == before
    for f, a, b in zip(kern._fields, kern, eager):
        assert a.dtype == b.dtype and torch.equal(a, b), f"{policy}/{f}"


@pytest.mark.parametrize("policy", ["ect", "mlml", "nltr", "trh", "rr",
                                    "two_choice"])
def test_run_window_does_not_synchronize(policy, cuda_device):
    """The eager engine's per-request loop reads nothing back to the host
    (torch's sync debug mode raises on a read): `run_window` on grouped
    steps, (T,) and (T, C) states, with the completion feedback on, the
    randomized policies drawing from the LCG and from threefry keys."""
    from repro_torch.core import engine, statlog
    rng = np.random.default_rng(5)
    for lead in ((6,), (3, 4)):
        shape = lead + (40,)
        work = engine.Workload(
            torch.from_numpy(rng.integers(0, 30, shape).astype(
                np.int32)).to(cuda_device),
            torch.from_numpy(rng.uniform(1.0, 20.0, shape).astype(
                np.float32)).to(cuda_device),
            torch.from_numpy(rng.random(shape) > 0.1).to(cuda_device))
        steps, _ = engine.group_by_object_with_map(work)
        log_cfg = statlog.LogConfig(n_servers=37)
        state = statlog.init_state(log_cfg, batch=lead[0],
                                   device=cuda_device)
        if len(lead) == 2:
            state = statlog.SchedState(*(x[:, None].expand(
                lead + x.shape[1:]) for x in state))
        seeds = torch.arange(int(np.prod(lead)), device=cuda_device
                             ).reshape(lead)
        keys = random.split(random.key(0, cuda_device),
                            int(np.prod(lead))).reshape(lead + (2,))
        for rng_impl in ("lcg", "jax"):
            pol = PolicyConfig(name=policy, threshold=2.0, rng=rng_impl)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                res = engine.run_window(state, steps, keys, policy=pol,
                                        log_cfg=log_cfg, group_steps=False,
                                        observe=True, rng0=seeds)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            assert res.chosen.shape == shape
            assert int(res.state.n_assigned.sum()) == int(
                steps.valid.sum())


@pytest.mark.parametrize("policy", ["ect", "nltr", "two_choice"])
def test_sched_stream_on_card_matches_batch_rows(policy, cuda_device):
    """`ops.sched_stream` on one stream launches the stream kernel once
    and equals that stream's row of `sched_stream_batch`; the sequential
    kernel path `run_stream(backend="kernel")` likewise."""
    from repro_torch.core import engine, statlog
    t, m, n_win, win = 4, 37, 3, 32
    arrays = batch_case(t, m, n_win, win, seed=31)
    ops_in = [torch.from_numpy(x.astype(np.int64) if x.dtype == np.uint32
                               else x).to(cuda_device) for x in arrays]
    kw = dict(KW, n_servers=m, window_size=win, policy=policy)
    batch = tops.sched_stream_batch(*ops_in, **kw)
    for i in range(t):
        before = tkernel.LAUNCHES["sched_stream"]
        one = tops.sched_stream(*(x[i] for x in ops_in), **kw)
        torch.cuda.synchronize()
        assert tkernel.LAUNCHES["sched_stream"] == before + 1
        for a, b in zip(one, batch[:4]):
            assert torch.equal(a, b[i])
    log_cfg = statlog.LogConfig(n_servers=m, lam=KW["lam"])
    pol = PolicyConfig(name=policy, threshold=KW["threshold"])
    obj, lens, valid, tables, seeds, _ = ops_in
    state = statlog.SchedState(
        log=tables, n_assigned=torch.zeros((t, m), dtype=torch.int32,
                                           device=cuda_device),
        rates=torch.full((t, m), 100.0, device=cuda_device),
        vclock=torch.zeros(t, device=cuda_device),
        free_at=torch.zeros((t, m), device=cuda_device))
    works = engine.Workload(obj, lens, valid != 0)
    run = dict(policy=pol, log_cfg=log_cfg, window_size=win,
               window_dt=KW["window_dt"], observe=True)
    keys = random.split(random.key(31, cuda_device), t)
    rows, _, _ = engine.run_stream_batch(state, works, keys, **run)
    for i in range(t):
        before = tkernel.LAUNCHES["sched_stream"]
        one = engine.run_stream(
            statlog.SchedState(*(x[i] for x in state)),
            engine.Workload(*(x[i] for x in works)), keys[i],
            backend="kernel", **run)
        torch.cuda.synchronize()
        assert tkernel.LAUNCHES["sched_stream"] == before + 1
        for a, b in zip(one.state, rows.state):
            assert torch.equal(a, b[i])
        for a, b in zip(one[1:6], rows[1:6]):
            assert torch.equal(a, b[i])


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
# danube's head dim 120 with a window of 64, and whisper-tiny's decoder
# heads (MHA 6/6, hd 64) at its serve's prompt of 224 (a ragged last
# tile) and its 448-token context
WGMMA_CASES = [(*c[:7], "bfloat16") for c in CARD_FLASH_CASES] + [
    (1, 130, 8, 1, 256, None, None, "bfloat16"),
    (1, 1000, 8, 1, 256, None, None, "bfloat16"),
    (1, 2048, 8, 1, 256, None, None, "bfloat16"),
    (1, 1000, 8, 2, 120, 64, None, "bfloat16"),
    (16, 224, 6, 6, 64, None, None, "bfloat16"),
    (16, 448, 6, 6, 64, None, None, "bfloat16"),
    # qwen2's prefill heads (GQA 8, hd 128) at the serve's 4 x 512 and a
    # ragged S; jamba's (GQA 4) at the same shape
    (4, 512, 64, 8, 128, None, None, "bfloat16"),
    (1, 1000, 64, 8, 128, None, None, "bfloat16"),
    (4, 512, 32, 8, 128, None, None, "bfloat16")]


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
                                  "h2o-danube-3-4b", "mixtral-8x22b",
                                  "llama4-scout-17b-a16e"])
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
    with torch.no_grad():   # the flash route is a forward-only route
        want_logits = T.forward_train(params, {"tokens": prompts},
                                      flash_cfg)
    want_tokens, _, _ = tserve.generate(params, prompts, cfg, 6)
    params.to(cuda_device)
    prompts = prompts.to(cuda_device)
    before = dict(fkernel.LAUNCHES)
    tokens, _, _ = tserve.generate(params, prompts, cfg, 6)
    # float32 operands: the SIMT kernel, once per layer
    assert fkernel.LAUNCHES == dict(
        before, flash_attention_simt=before["flash_attention_simt"]
        + cfg.n_layers)
    with torch.no_grad():
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
    with torch.no_grad():   # the flash route is a forward-only route
        got = T.forward_train(params, {"tokens": prompts}, cfg).float()
    torch.cuda.synchronize()
    assert fkernel.LAUNCHES == dict(
        before, flash_attention_wgmma=before["flash_attention_wgmma"]
        + cfg.n_layers)
    monkeypatch.setattr(fops, "flash_attention", flash_attention_plain)
    with torch.no_grad():
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


# -- threefry -----------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 10 ** 6])
@pytest.mark.parametrize("lead", [(1,), (5,), (3, 4)],
                         ids=lambda x: "x".join(map(str, x)))
def test_threefry_kernel_matches_plain_on_card(n, lead, cuda_device):
    """The hash kernel against its plain version on the same CUDA keys,
    bit for bit: both output forms, a counter offset (fold_in's), and
    one launch per call."""
    from repro_torch.kernels.threefry import kernel as fkern
    from repro_torch.kernels.threefry import ops as fops3
    rng = np.random.default_rng(n)
    keys = torch.from_numpy(rng.integers(0, 2 ** 32, lead + (2,),
                                         dtype=np.int64)).to(cuda_device)
    for count_lo, xor in ((0, False), (0, True), (0x7e3, False),
                          (2 ** 32 - 3, True)):
        before = fkern.LAUNCHES["threefry"]
        got = fops3.threefry_counters(keys, n, count_lo, xor)
        torch.cuda.synchronize()
        assert fkern.LAUNCHES["threefry"] == before + 1
        want = fops3.threefry_counters_plain(keys, n, count_lo, xor)
        assert got.shape == want.shape and torch.equal(got, want)


def test_random_on_card_matches_cpu(cuda_device):
    """`repro_torch.random` on the card gives the CPU's draws (which the
    CPU tests hold against jax.random): keys, bits, randint, uniform,
    permutation and choice bit for bit, normal too (its float64 steps
    round the same on both)."""
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        k = random.split(random.key(2024, dev), 6)
        out[dev.type] = [
            k, random.fold_in(k, 0x7e3), random.bits(k, (3, 50)),
            random.randint(k, (500,), 0, 800), random.randint(k, (), 0, 3),
            random.uniform(k, (500,), 10.0, 1024.0),
            random.normal(k, (10_000,), scale=5.0),
            random.permutation(k, 100), random.choice(k, 100, (10,))]
    for i, (a, b) in enumerate(zip(out["cuda"], out["cpu"])):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b), i


@pytest.mark.filterwarnings("ignore:per_client window clamp")
@pytest.mark.parametrize("client_model", ["shared_log", "per_client"])
def test_prep_on_card_has_no_host_sync_and_matches_cpu(client_model,
                                                       cuda_device):
    """The §4 prep on the card under torch's sync debug mode (a read back
    to the host raises), with stragglers and every scenario's draws, and
    equal to the same prep on the CPU bit for bit, the initial loads
    included (the normal's multiply-adds round once on both devices)."""
    for scenario in simulate.SCENARIOS:
        cfg = simulate.SimConfig(client_model=client_model,
                                 straggler_frac=0.1,
                                 scenario=simulate.ScenarioConfig(scenario))
        log = simulate.default_log_cfg(cfg)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            prep = simulate._prep_trials(
                simulate.trial_keys(0, cfg, cuda_device), cfg, log)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        cpu = simulate._prep_trials(simulate.trial_keys(0, cfg, "cpu"), cfg,
                                    log)
        init, cinit = prep[0].cpu().numpy(), cpu[0].numpy()
        ulp = np.abs(init.view(np.int32).astype(np.int64)
                     - cinit.view(np.int32).astype(np.int64))
        assert ulp.max() == 0, scenario
        # the log's loads row holds the initial loads
        assert torch.equal(prep[3].log.cpu(), cpu[3].log)
        rest = lambda p: [p[1], *p[2], *p[3][1:], *(p[4] or ()),  # noqa
                          p[5]]
        for a, b in zip(rest(prep), rest(cpu)):
            assert torch.equal(a.cpu(), b), scenario


@pytest.mark.parametrize("policy", ["trh", "nltr", "two_choice"])
def test_eager_threefry_on_card_matches_cpu(policy, cuda_device):
    """The eager engine under ``rng="jax"`` on the card against the CPU,
    at init_load_std=0 (no normal): every `TrialResult` field."""
    cfg = simulate.SimConfig(n_servers=37, n_requests=250, n_trials=4,
                             window_size=60, init_load_std=0.0,
                             backend="jax",
                             scenario=simulate.ScenarioConfig("transient"))
    log = simulate.default_log_cfg(cfg)
    pol = PolicyConfig(name=policy, threshold=5.0)
    card = simulate.run_trials(7, cfg, pol, log)
    cpu = simulate.run_trials(7, cfg, pol, log, device="cpu")
    for f, a, b in zip(card._fields, card, cpu):
        assert torch.equal(a.cpu(), b), f"{policy}/{f}"


# ---------------------------------------------------------------------------
# the host path: the client's log, checkpoints and token batches on the card
# ---------------------------------------------------------------------------


def _busy_host_log(m=24):
    from repro_torch.core.statlog import HostStatLog, LogConfig
    log = HostStatLog(LogConfig(n_servers=m, lam=32.0))
    rng = np.random.default_rng(3)
    log.set_rates(np.linspace(25.0, 200.0, m))
    for _ in range(60):
        s = int(rng.integers(0, m))
        log.apply_assignment(s, float(rng.uniform(1, 16)))
        log.observe_completion(s, float(rng.uniform(20, 200)))
        if rng.random() < 0.2:
            log.advance_time(0.05)
    return log


def test_host_log_snapshot_on_card_matches_cpu(cuda_device):
    """`snapshot(device="cuda")` equals the CPU snapshot, and one window
    scheduled from it by the stream kernel equals the plain version's
    from the CPU snapshot (contract fields bit for bit)."""
    from repro_torch.core import engine
    log = _busy_host_log()
    card, cpu = log.snapshot(device=cuda_device), log.snapshot(device="cpu")
    for f, a, b in zip(card._fields, card, cpu):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b), f
    ids = np.random.default_rng(5).integers(0, 10 ** 6, 80)
    out = {}
    for dev, state in (("cuda", card), ("cpu", cpu)):
        work = engine.Workload(
            torch.tensor(ids, dtype=torch.int32, device=dev),
            torch.full((80,), 4.0, device=dev),
            torch.ones(80, dtype=torch.bool, device=dev))
        before = tkernel.LAUNCHES["sched_stream"]
        out[dev] = engine.run_stream(
            state, work, random.key(0, dev),
            policy=PolicyConfig(name="ect", threshold=0.05),
            log_cfg=log.cfg, window_size=80, backend="kernel")
        if dev == "cuda":
            torch.cuda.synchronize()
            assert tkernel.LAUNCHES["sched_stream"] == before + 1
    got, want = out["cuda"], out["cpu"]
    for f in ("chosen", "probe_msgs", "redirected", "latencies",
              "window_loads"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    assert torch.equal(got.state.loads.cpu(), want.state.loads)
    torch.testing.assert_close(got.state.log.cpu(), want.state.log,
                               rtol=1e-6, atol=1e-6)


def test_checkpoint_of_card_tensors_restores_on_card(cuda_device,
                                                     tmp_path):
    """Card tensors (a bfloat16 leaf, an int32 scalar, a list) saved
    asynchronously and mutated in place on the card right after `save`:
    the restore onto the card equals the tree as it was at `save`."""
    from repro_torch.checkpoint import CheckpointConfig, Checkpointer
    from repro_torch.io import IOClientConfig
    from repro_torch.io.striping import MB
    g = torch.Generator(device=cuda_device).manual_seed(0)
    tree = {"layer": {"w": torch.randn(300, 200, device=cuda_device,
                                       generator=g),
                      "b": torch.randn(200, device=cuda_device,
                                       generator=g).to(torch.bfloat16)},
            "step": torch.tensor(17, dtype=torch.int32, device=cuda_device),
            "nested": [torch.arange(5.0, device=cuda_device),
                       torch.ones(2, 3, 4, device=cuda_device)]}
    want = {"w": tree["layer"]["w"].clone(), "b": tree["layer"]["b"].clone()}
    ck = Checkpointer(str(tmp_path), n_servers=5, cfg=CheckpointConfig(
        shard_size_mb=0.25, async_save=True,
        io=IOClientConfig(policy=PolicyConfig(name="trh", threshold=0.1),
                          stripe_size=MB // 4)))
    ck.save(1, tree)
    tree["layer"]["w"].mul_(0)
    tree["layer"]["b"].zero_()
    ck.wait_until_finished()
    back = ck.restore()
    assert all(t.device.type == "cuda" for t in back.values())
    assert back["layer/b"].dtype == torch.bfloat16
    assert torch.equal(back["layer/w"], want["w"])
    assert torch.equal(back["layer/b"].view(torch.int16),
                       want["b"].view(torch.int16))
    assert torch.equal(back["step"], tree["step"])
    assert torch.equal(back["nested/1"], tree["nested"][1])
    onto = ck.restore(target={**tree, "layer": {
        "w": torch.zeros(300, 200), "b": tree["layer"]["b"]}})
    assert onto["layer"]["w"].device.type == "cpu"
    assert onto["layer"]["b"].device.type == "cuda"
    ck.close()


def test_batch_at_on_card_equals_cpu(cuda_device, tmp_path):
    from repro_torch.data import DataConfig, ObjectStoreTokens
    from repro_torch.data import SyntheticTokens
    from repro_torch.io import IOClient, LocalFSStore
    cfg = DataConfig(vocab_size=256000, seq_len=512, global_batch=4)
    ost = ObjectStoreTokens(cfg, IOClient(LocalFSStore(str(tmp_path), 8)),
                            rows_per_shard=4)
    ost.prepare(3)
    synth = SyntheticTokens(cfg)
    for step in range(3):
        for batch in (ost.batch_at(step), synth.batch_at(step)):
            want = synth.batch_at(step, device="cpu")
            for k in ("tokens", "targets"):
                assert batch[k].device.type == "cuda"
                assert torch.equal(batch[k].cpu(), want[k]), (step, k)


def test_sim_cluster_replays_card_trace_as_cpu(cuda_device):
    """`SimulatedCluster(trace=...)` fed `make_trace`'s card-resident
    trace equals the same replay of the CPU-drawn one."""
    from repro_torch.core import engine
    from repro_torch.io import IOClient, IOClientConfig, SimulatedCluster
    cfg = simulate.SimConfig(n_servers=40, n_requests=400, window_size=40,
                             scenario=simulate.ScenarioConfig("flapping"))
    out = []
    for dev in ("cuda", "cpu"):
        keys = simulate.trial_keys(0, cfg, dev)[:1]
        tr = simulate.make_trace(keys, cfg, cfg.scenario)
        assert tr.times.device.type == dev
        sim = SimulatedCluster(40, base_rate_mb_s=200.0, trace=engine.
                               ClusterTrace(tr.times[0], tr.rates[0]))
        cli = IOClient(sim, IOClientConfig(policy=PolicyConfig(
            name="ect", threshold=0.05)))
        for f in range(60):
            cli.write_file(f, size_mb=16.0)
            sim.advance_time(0.05)
        out.append((cli.flush(), sim.clock,
                    [r.server for r in cli.records], cli.log.table))
    assert out[0][:3] == out[1][:3]
    assert torch.equal(out[0][3], out[1][3])


# -- training (launch/train, train/steps, optimizer) -------------------------


def _fresh_train_state(cfg, device, seed=0):
    """A train state drawn on the CPU from ``seed``, moved to ``device``
    (zero moments, step 0)."""
    from repro_torch.train import TrainState, init_state, optimizer
    state = init_state(torch.Generator().manual_seed(seed), cfg,
                       device="cpu")
    params = state.params.to(device)
    return TrainState(params=params, opt=optimizer.init(params),
                      step=state.step.to(device))


def _train_batch(cfg, step, device):
    from repro_torch.data import DataConfig, SyntheticTokens
    return SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=24,
                                      global_batch=2, seed=1)
                           ).batch_at(step, device=device)


def test_train_steps_on_card_match_cpu(cuda_device):
    """The reduced gemma-2b in float32 compute, 3 train steps on the card
    against the same steps on the CPU: the loss and the grad norm to 1e-5
    relative, the parameters to 2·sum(lr) (tests/test_torch_train.py's
    tolerances against the JAX package), and no kernel of the port
    launched."""
    from repro_torch.train import OptConfig, make_train_step
    cfg = dataclasses.replace(get_config("gemma-2b", reduced=True),
                              compute_dtype="float32")
    step = make_train_step(cfg, OptConfig(peak_lr=1e-3, warmup_steps=2,
                                          total_steps=10))
    states = {d: _fresh_train_state(cfg, d) for d in ("cuda", "cpu")}
    before = {**tkernel.LAUNCHES, **fkernel.LAUNCHES}
    lr_sum = 0.0
    for i in range(3):
        metrics = {}
        for d in states:
            states[d], metrics[d] = step(states[d], _train_batch(cfg, i, d))
        for k in ("loss", "grad_norm"):
            got, want = float(metrics["cuda"][k]), float(metrics["cpu"][k])
            assert abs(got - want) <= 1e-5 * abs(want), (i, k)
        lr_sum += float(metrics["cpu"]["lr"])
    assert {**tkernel.LAUNCHES, **fkernel.LAUNCHES} == before
    got = states["cuda"].params.state_dict()
    for k, want in states["cpu"].params.state_dict().items():
        assert got[k].device.type == "cuda"
        assert (got[k].cpu() - want).abs().max().item() <= 2 * lr_sum, k


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "llama4-scout-17b-a16e"])
def test_moe_train_steps_on_card_match_cpu(arch, cuda_device):
    """The reduced MoE configurations in float32 compute, 3 train steps
    on the card against the CPU, as `test_train_steps_on_card_match_cpu`
    holds gemma-2b; the MoE terms to 1e-5 relative too."""
    from repro_torch.train import OptConfig, make_train_step
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype="float32")
    step = make_train_step(cfg, OptConfig(peak_lr=1e-3, warmup_steps=2,
                                          total_steps=10))
    states = {d: _fresh_train_state(cfg, d) for d in ("cuda", "cpu")}
    lr_sum = 0.0
    for i in range(3):
        metrics = {}
        for d in states:
            states[d], metrics[d] = step(states[d], _train_batch(cfg, i, d))
        for k in ("loss", "grad_norm", "lb_loss", "z_loss"):
            got, want = float(metrics["cuda"][k]), float(metrics["cpu"][k])
            assert abs(got - want) <= 1e-5 * abs(want), (i, k)
        assert abs(float(metrics["cuda"]["moe_dropped"])
                   - float(metrics["cpu"]["moe_dropped"])) <= 1e-6
        lr_sum += float(metrics["cpu"]["lr"])
    got = states["cuda"].params.state_dict()
    for k, want in states["cpu"].params.state_dict().items():
        assert (got[k].cpu() - want).abs().max().item() <= 2 * lr_sum, k


@pytest.mark.parametrize("n_experts,top_k", [(16, 1), (8, 2)])
def test_apply_moe_on_card_matches_cpu(n_experts, top_k, cuda_device):
    """`models.moe.apply_moe` on the card against the CPU on the same
    parameters and 2,048 tokens, float32 compute: the experts and the
    dropped share equal, the output to 1e-4 and the aux terms to 1e-5
    relative."""
    from repro_torch.models import moe as MOE
    from repro_torch.models.config import MoEConfig
    cfg = dataclasses.replace(
        get_config("mixtral-8x22b", reduced=True), d_model=256, d_ff=512,
        compute_dtype="float32",
        moe=MoEConfig(n_experts=n_experts, top_k=top_k))
    p = MOE.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((4, 512, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    want, waux = MOE.apply_moe(p, x, cfg)
    pc = {k: v.to(cuda_device) for k, v in p.items()}
    got, gaux = MOE.apply_moe(pc, x.to(cuda_device), cfg)
    xt = x.reshape(-1, cfg.d_model)
    assert torch.equal(MOE.route(pc, xt.to(cuda_device), cfg).gate_idx.cpu(),
                       MOE.route(p, xt, cfg).gate_idx)
    assert float(gaux.dropped_fraction) == float(waux.dropped_fraction)
    assert (got.cpu() - want).abs().max().item() < 1e-4
    for g, w in zip(gaux[:2], waux[:2]):
        assert abs(float(g) - float(w)) <= 1e-5 * abs(float(w))


# -- state-space and recurrent blocks (models/ssm.py) ------------------------

# (arch, ssm.chunk replaced by, or None): chunk 8 sends xlstm's
# forward_train through the chunkwise mLSTM at S = 24
SSM_CASES = {"jamba": ("jamba-v0.1-52b", None),
             "xlstm": ("xlstm-1.3b", None),
             "xlstm-chunk8": ("xlstm-1.3b", 8)}


def _ssm_cfg(case, compute_dtype="float32"):
    arch, chunk = SSM_CASES[case]
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype=compute_dtype)
    if chunk is not None:
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, chunk=chunk))
    return cfg


def _within(got, want, tol=1e-4) -> bool:
    """Within ``tol`` of the largest value of ``want`` (at least 1)."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return (got - want).abs().max().item() <= tol * max(
        1.0, want.abs().max().item())


@pytest.mark.parametrize("case", sorted(SSM_CASES))
def test_ssm_reduced_on_card_matches_cpu(case, cuda_device):
    """The reduced jamba / xlstm in float32 compute on the card against
    the same parameters and prompts on the CPU: `forward_train`, every
    `forward_prefill` cache field and the logits of 4 decode steps within
    1e-4 of the largest value; jamba's prefill launches the SIMT flash
    kernel once (its one attention layer, f32 operands), xlstm's none."""
    cfg = _ssm_cfg(case)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (2, 24)))
    n_attn = cfg.group_pattern.count("attn") * cfg.n_groups
    out = {}
    for dev in ("cpu", "cuda"):
        params = T.init_lm(torch.Generator().manual_seed(0), cfg,
                           device="cpu").to(dev)
        toks = prompts.to(dev)
        before = dict(fkernel.LAUNCHES)
        with torch.no_grad():
            train = T.forward_train(params, {"tokens": toks}, cfg)
        logits, caches = T.forward_prefill(
            params, {"tokens": toks},
            dataclasses.replace(cfg, use_pallas_attn=True), cache_len=28)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert fkernel.LAUNCHES == dict(
                before, flash_attention_simt=before["flash_attention_simt"]
                + n_attn)
        tok, steps = torch.argmax(logits[:, -1:], dim=-1), []
        for i in range(4):
            lg, caches = T.decode_step(params, caches, tok, 24 + i, cfg)
            steps.append(lg)
            tok = torch.argmax(lg, dim=-1)
        out[dev] = (train, logits, caches, torch.cat(steps, dim=1))
    (th, lh, ch, dh), (tc, lc, cc, dc) = out["cpu"], out["cuda"]
    assert _within(tc, th) and _within(lc, lh) and _within(dc, dh)
    for li, (a, b) in enumerate(zip(cc, ch)):
        assert set(a) == set(b)
        for name in b:
            assert a[name].device.type == "cuda"
            assert _within(a[name], b[name]), (li, name)


@pytest.mark.parametrize("arch,steps", [("jamba-v0.1-52b", 3),
                                        ("xlstm-1.3b", 1)])
def test_ssm_train_steps_on_card_match_cpu(arch, steps, cuda_device):
    """The reduced jamba / xlstm in float32 compute, ``steps`` train steps
    on the card against the CPU: the loss to 1e-5 and the grad norm to
    1e-4 relative, the parameters to 2·sum(lr).  Adam's normalized update
    turns rounding-level differences in gradients that nearly cancel into
    parameter differences of a fraction of lr (jamba's third step at seq
    64 gave grad norms 1.44e-5 apart on an H100 and its host's CPU, inside
    the 1.58e-5 by which a 1e-7 relative perturbation of the parameters
    moves the card's own third grad norm: chip_smoke.py's
    `ssm_gnorm_move`); xlstm takes one step
    (tests/test_torch_ssm.py::test_train_step_matches_jax says why)."""
    from repro_torch.train import OptConfig, make_train_step
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype="float32")
    step = make_train_step(cfg, OptConfig(peak_lr=1e-3, warmup_steps=2,
                                          total_steps=10))
    states = {d: _fresh_train_state(cfg, d) for d in ("cuda", "cpu")}
    lr_sum = 0.0
    for i in range(steps):
        metrics = {}
        for d in states:
            states[d], metrics[d] = step(states[d], _train_batch(cfg, i, d))
        for k, rtol in (("loss", 1e-5), ("grad_norm", 1e-4)):
            got, want = float(metrics["cuda"][k]), float(metrics["cpu"][k])
            assert abs(got - want) <= rtol * abs(want), (i, k)
        lr_sum += float(metrics["cpu"]["lr"])
    got = states["cuda"].params.state_dict()
    for k, want in states["cpu"].params.state_dict().items():
        assert (got[k].cpu() - want).abs().max().item() <= 2 * lr_sum, k


def _whisper_batch(cfg, step, device):
    """{frames, tokens, targets} of the reduced whisper-tiny, drawn on
    the CPU."""
    rng = np.random.default_rng(50 + step)
    rows = rng.integers(1, cfg.vocab_size, (2, 33))
    frames = rng.standard_normal((2, cfg.enc_seq, cfg.d_model),
                                 dtype=np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in
            (("frames", frames), ("tokens", rows[:, :-1]),
             ("targets", rows[:, 1:]))}


def test_whisper_reduced_serve_on_card_matches_cpu(cuda_device):
    """The reduced whisper-tiny's serve on the card (its decoder's flash
    calls on the SIMT kernel in float32, one a layer) against the same
    parameters, frames and prompts on the CPU: the prefill logits and
    every cache within 1e-4 of the largest value, greedy tokens
    exactly."""
    from repro_torch.models import encdec as E
    cfg = dataclasses.replace(get_config("whisper-tiny", reduced=True),
                              compute_dtype="float32")
    params = E.init_encdec(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = _whisper_batch(cfg, 0, "cpu")
    flash_cfg = dataclasses.replace(cfg, use_pallas_attn=True)
    want, want_caches = E.forward_prefill(params, batch, flash_cfg, 40)
    want_tokens, _, _ = tserve.generate(params, batch["tokens"], cfg, 6,
                                        batch["frames"])
    params.to(cuda_device)
    batch = {k: v.to(cuda_device) for k, v in batch.items()}
    before = dict(fkernel.LAUNCHES)
    tokens, _, _ = tserve.generate(params, batch["tokens"], cfg, 6,
                                   batch["frames"])
    assert fkernel.LAUNCHES == dict(
        before, flash_attention_simt=before["flash_attention_simt"]
        + cfg.n_layers)
    got, caches = E.forward_prefill(params, batch, flash_cfg, 40)
    assert _within(got, want)
    for part in ("self", "cross"):
        for a, b in zip(caches[part], want_caches[part]):
            for name in b:
                assert _within(a[name].float(), b[name].float()), \
                    (part, name)
    assert torch.equal(tokens.cpu(), want_tokens)


def test_whisper_train_steps_on_card_match_cpu(cuda_device):
    """The reduced whisper-tiny in float32 compute, 3 train steps on the
    card against the CPU: the loss and the grad norm to 1e-5 relative
    (tests/test_torch_train.py's tolerances), the parameters to
    2·sum(lr)."""
    from repro_torch.train import OptConfig, make_train_step
    cfg = dataclasses.replace(get_config("whisper-tiny", reduced=True),
                              compute_dtype="float32")
    step = make_train_step(cfg, OptConfig(peak_lr=1e-3, warmup_steps=2,
                                          total_steps=10))
    states = {d: _fresh_train_state(cfg, d) for d in ("cuda", "cpu")}
    lr_sum = 0.0
    for i in range(3):
        metrics = {}
        for d in states:
            states[d], metrics[d] = step(states[d],
                                         _whisper_batch(cfg, i, d))
        for k in ("loss", "grad_norm"):
            got, want = float(metrics["cuda"][k]), float(metrics["cpu"][k])
            assert abs(got - want) <= 1e-5 * abs(want), (i, k)
        lr_sum += float(metrics["cpu"]["lr"])
    got = states["cuda"].params.state_dict()
    for k, want in states["cpu"].params.state_dict().items():
        assert (got[k].cpu() - want).abs().max().item() <= 2 * lr_sum, k


def test_mlstm_chunkwise_on_card_matches_sequential(cuda_device):
    """`mlstm_chunkwise` (chunk 64) against `mlstm_sequential` on the card
    in float32, B 2, S 256, H 4, hd 256, from a finite state: the outputs
    and the final state within 1e-4 of their largest values."""
    from repro_torch.models import ssm as SSM
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    b, s, h, hd = 2, 256, 4, 256
    rnd = lambda *shape: torch.randn(shape, generator=gen,
                                     device=cuda_device)
    q, k, v = rnd(b, s, h, hd), rnd(b, s, h, hd), rnd(b, s, h, hd)
    li = rnd(b, s, h)
    lf = torch.nn.functional.logsigmoid(rnd(b, s, h) + 3)
    state = SSM.MLSTMState(rnd(b, h, hd, hd), rnd(b, h, hd), rnd(b, h))
    yc, sc = SSM.mlstm_chunkwise(q, k, v, li, lf, state, 64)
    ys, ss = SSM.mlstm_sequential(q, k, v, li, lf, state)
    assert yc.device.type == "cuda"
    assert _within(yc, ys)
    assert all(_within(a, w) for a, w in zip(sc, ss))


def test_jamba_bf16_prefill_on_card_takes_wgmma(cuda_device, monkeypatch):
    """The reduced jamba in bf16 compute on the card: the prefill's one
    attention layer goes through the wgmma kernel (no RoPE, full causal,
    GQA 2), once, and within 2e-2 of the plain version on the same q, k
    and v."""
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b", reduced=True),
                              use_pallas_attn=True)
    params = T.init_lm(torch.Generator(device=cuda_device).manual_seed(0),
                       cfg, device=cuda_device)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (2, 200))).to(cuda_device)
    kernel, errs = fops.flash_attention, []

    def held(q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        errs.append((out.float() - flash_attention_plain(q, k, v, **kw)
                     .float()).abs().max().item())
        return out

    monkeypatch.setattr(fops, "flash_attention", held)
    before = dict(fkernel.LAUNCHES)
    with torch.no_grad():
        logits = T.forward_train(params, {"tokens": prompts}, cfg)
    torch.cuda.synchronize()
    assert fkernel.LAUNCHES == dict(
        before, flash_attention_wgmma=before["flash_attention_wgmma"] + 1)
    assert len(errs) == 1 and errs[0] <= 2e-2
    assert bool(torch.isfinite(logits.float()).all())


# -- the qwen2 family: M-RoPE and the patch frontend ----------------------------


def _vl_batch(cfg, step, device, b=2, s=40):
    """A reduced qwen2-vl batch drawn on the CPU: tokens and targets,
    patch embeddings (b, s // 2, d) and (3, b, s) positions with the patch
    slots on an h x w grid (h the largest divisor up to the square root)
    and the text after them on every stream."""
    rng = np.random.default_rng(70 + step)
    rows = rng.integers(1, cfg.vocab_size, (b, s + 1))
    n_patch = s // 2
    h = max(d for d in range(1, int(n_patch ** 0.5) + 1) if n_patch % d == 0)
    w = n_patch // h
    pos = np.zeros((3, b, s), np.int64)
    pos[1, :, :n_patch] = np.repeat(np.arange(h), w)
    pos[2, :, :n_patch] = np.tile(np.arange(w), h)
    pos[:, :, n_patch:] = np.arange(s - n_patch) + max(h, w)
    patches = rng.standard_normal((b, n_patch, cfg.d_model),
                                  dtype=np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in
            (("tokens", rows[:, :-1]), ("targets", rows[:, 1:]),
             ("positions", pos.astype(np.int32)), ("patch_embeds", patches))}


@pytest.mark.parametrize("hd,sections", [(128, (16, 24, 24)), (12, (2, 2, 2)),
                                         (24, (3, 5, 7))])
def test_mrope_on_card_matches_cpu(hd, sections, cuda_device):
    """`apply_mrope` on the card against the CPU on three distinct
    position streams up to 4,096, float32: within 1e-4.  The angles are
    one product each on both; PyTorch's CUDA sin/cos reduce a large
    argument less exactly than the CPU's (2.05e-5 apart at angles up to
    4,096 rad on an H100)."""
    from repro_torch.models import layers as L
    rng = np.random.default_rng(hd)
    x = torch.from_numpy(rng.standard_normal((2, 64, 8, hd),
                                             dtype=np.float32))
    pos = torch.from_numpy(rng.integers(0, 4096, (3, 2, 64)).astype(np.int32))
    want = L.apply_mrope(x, pos, 1e6, sections)
    got = L.apply_mrope(x.to(cuda_device), pos.to(cuda_device), 1e6,
                        sections)
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert (got.cpu() - want).abs().max().item() <= 1e-4


def test_qwen2_vl_reduced_serve_on_card_matches_cpu(cuda_device):
    """The reduced qwen2-vl-72b served on the card with its patches and
    positions (the prefill's flash calls on the SIMT kernel in float32,
    one a layer) against the same parameters and batch on the CPU: the
    prefill logits and every cache within 1e-4 of the largest value,
    greedy tokens exactly."""
    cfg = dataclasses.replace(get_config("qwen2-vl-72b", reduced=True),
                              compute_dtype="float32")
    params = T.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = _vl_batch(cfg, 0, "cpu")
    extra = {k: batch[k] for k in ("positions", "patch_embeds")}
    prefill_batch = dict(extra, tokens=batch["tokens"])
    flash_cfg = dataclasses.replace(cfg, use_pallas_attn=True)
    want, want_caches = T.forward_prefill(params, prefill_batch, flash_cfg,
                                          46)
    want_tokens, _, _ = tserve.generate(params, batch["tokens"], cfg, 6,
                                        **extra)
    params.to(cuda_device)
    prefill_batch = {k: v.to(cuda_device) for k, v in prefill_batch.items()}
    before = dict(fkernel.LAUNCHES)
    tokens, _, _ = tserve.generate(
        params, prefill_batch["tokens"], cfg, 6,
        positions=prefill_batch["positions"],
        patch_embeds=prefill_batch["patch_embeds"])
    assert fkernel.LAUNCHES == dict(
        before, flash_attention_simt=before["flash_attention_simt"]
        + cfg.n_layers)
    got, caches = T.forward_prefill(params, prefill_batch, flash_cfg, 46)
    assert _within(got, want)
    for a, b in zip(caches, want_caches):
        for name in b:
            assert _within(a[name].float(), b[name].float()), name
    assert torch.equal(tokens.cpu(), want_tokens)


def test_qwen2_vl_bf16_prefill_on_card_takes_wgmma(cuda_device, monkeypatch):
    """The reduced qwen2-vl in bf16 compute on the card with its patches
    and positions, its head dim 12 widened to 16 (the wgmma kernel takes
    a multiple of 8; M-RoPE's widths become 3, 3, 2): the prefill's
    attention goes through the wgmma kernel once a layer (GQA 4), and
    its logits agree with the same forward with `attention_ref` in the
    kernel's place to 0.02 of the largest |logit| (chip_smoke's serve
    check)."""
    cfg = dataclasses.replace(get_config("qwen2-vl-72b", reduced=True),
                              head_dim=16, use_pallas_attn=True)
    params = T.init_lm(torch.Generator(device=cuda_device).manual_seed(0),
                       cfg, device=cuda_device)
    batch = _vl_batch(cfg, 1, cuda_device, s=200)
    del batch["targets"]
    before = dict(fkernel.LAUNCHES)
    with torch.no_grad():
        got = T.forward_train(params, batch, cfg).float()
    torch.cuda.synchronize()
    assert fkernel.LAUNCHES == dict(
        before, flash_attention_wgmma=before["flash_attention_wgmma"]
        + cfg.n_layers)
    monkeypatch.setattr(fops, "flash_attention", flash_attention_plain)
    with torch.no_grad():
        want = T.forward_train(params, batch, cfg).float()
    assert (got - want).abs().max().item() <= 0.02 * want.abs().max().item()


@pytest.mark.parametrize("arch", ["qwen2-72b", "qwen2-vl-72b"])
def test_qwen2_train_steps_on_card_match_cpu(arch, cuda_device):
    """The reduced qwen2 configurations in float32 compute, 3 train steps
    on the card against the CPU (the VLM's batches with patches and
    positions): the loss and the grad norm to 1e-5 relative
    (tests/test_torch_train.py's tolerances), the parameters to
    2·sum(lr), no kernel of the port launched."""
    from repro_torch.train import OptConfig, make_train_step
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype="float32")
    step = make_train_step(cfg, OptConfig(peak_lr=1e-3, warmup_steps=2,
                                          total_steps=10))
    states = {d: _fresh_train_state(cfg, d) for d in ("cuda", "cpu")}
    before = {**tkernel.LAUNCHES, **fkernel.LAUNCHES}
    lr_sum = 0.0
    for i in range(3):
        metrics = {}
        for d in states:
            batch = _vl_batch(cfg, i, d)
            if not cfg.mrope:
                batch = {k: batch[k] for k in ("tokens", "targets")}
            states[d], metrics[d] = step(states[d], batch)
        for k in ("loss", "grad_norm"):
            got, want = float(metrics["cuda"][k]), float(metrics["cpu"][k])
            assert abs(got - want) <= 1e-5 * abs(want), (i, k)
        lr_sum += float(metrics["cpu"]["lr"])
    assert {**tkernel.LAUNCHES, **fkernel.LAUNCHES} == before
    got = states["cuda"].params.state_dict()
    for k, want in states["cpu"].params.state_dict().items():
        assert (got[k].cpu() - want).abs().max().item() <= 2 * lr_sum, k


def test_flash_route_under_grad_raises_on_card(cuda_device):
    """``use_pallas_attn=True`` under autograd raises before any launch
    on the card as on the CPU; under ``torch.no_grad()`` the same
    forward launches the kernel once a layer."""
    from repro_torch.train import OptConfig, make_train_step
    cfg = dataclasses.replace(get_config("gemma-2b", reduced=True),
                              use_pallas_attn=True)
    state = _fresh_train_state(cfg, cuda_device)
    batch = _train_batch(cfg, 0, cuda_device)
    before = dict(fkernel.LAUNCHES)
    with pytest.raises(NotImplementedError, match="use_pallas_attn"):
        T.lm_loss(state.params, batch, cfg)
    with pytest.raises(NotImplementedError, match="use_pallas_attn"):
        make_train_step(cfg, OptConfig())(state, batch)
    assert fkernel.LAUNCHES == before
    with torch.no_grad():
        T.forward_train(state.params, batch, cfg)
    torch.cuda.synchronize()
    assert sum(fkernel.LAUNCHES.values()) == sum(before.values()) \
        + cfg.n_layers


def test_train_resume_on_card_from_checkpoint(cuda_device, tmp_path):
    """3 steps on the card, a save through `Checkpointer` with a straggler
    and a failed server, 3 more; a fresh state restored onto the card from
    the save takes the same 3: params, m and v within rtol 1e-5 / atol
    1e-6 of the uninterrupted run (CUDA's embedding backward may
    accumulate in another order), every leaf on the card."""
    from repro_torch.checkpoint import CheckpointConfig, Checkpointer
    from repro_torch.io import IOClientConfig
    from repro_torch.io.striping import MB
    from repro_torch.train import OptConfig, load_state, make_train_step
    cfg = get_config("gemma-2b", reduced=True)
    step = make_train_step(cfg, OptConfig(peak_lr=1e-3, warmup_steps=2,
                                          total_steps=10))
    ck = Checkpointer(str(tmp_path), n_servers=5, cfg=CheckpointConfig(
        shard_size_mb=0.25,
        io=IOClientConfig(policy=PolicyConfig(name="ect", threshold=0.05),
                          stripe_size=MB // 4)))
    ck.store.set_write_delay(2, 0.01)
    ck.store.fail_server(4)
    state = _fresh_train_state(cfg, cuda_device)
    for i in range(6):
        if i == 3:
            ck.save(3, state)
        state, _ = step(state, _train_batch(cfg, i, cuda_device))
    template = _fresh_train_state(cfg, cuda_device)
    back = load_state(template, ck.restore(target=template))
    assert int(back.step) == 3 and ck.client.stats()["failed_writes"] >= 1
    for i in range(3, 6):
        back, _ = step(back, _train_batch(cfg, i, cuda_device))
    for got, want in ((back.params.state_dict(), state.params.state_dict()),
                      (back.opt.m, state.opt.m), (back.opt.v, state.opt.v)):
        for k in want:
            assert got[k].device.type == "cuda"
            torch.testing.assert_close(got[k], want[k], rtol=1e-5,
                                       atol=1e-6)
    ck.close()


def test_contract_checker_all_layers_on_card(cuda_device):
    """`repro_torch.contractcheck` with its SASS layer over the shipped
    port: the stream kernel's source is built, every instantiation and
    the merge kernel read from ``cuobjdump -sass``, and no layer has a
    live finding."""
    from pathlib import Path

    from repro_torch.contractcheck import cudacheck, layer_of, run_check
    from repro_torch.kernels import _build

    findings = run_check(Path(__file__).resolve().parents[1], sass=True)
    assert [f.format() for f in findings if not f.suppressed] == []
    assert {layer_of(f) for f in findings} <= {"ast", "cuda", "sass"}
    funcs = cudacheck.read_sass(_build.build(tkernel.SOURCE))
    names = [fn.name for fn in funcs.values()]
    # each policy's level 0 at 16 lanes and levels 0-3 at 32, in the
    # shared and the global-memory instance
    assert sum(n.startswith("sched_stream_kernel<") for n in names) == \
        2 * len(tkernel.POLICY_CODES) * (1 + len(tkernel.ABLATE_LEVELS))
    assert "client_merge_kernel" in names
    assert all(fn.instructions > 0 and not fn.hazards
               for fn in funcs.values())


PROBE_CU = """
__global__ void probe_kernel(float* f, int* i, long long* t, int n) {
  __shared__ float s[32];
  __shared__ int h[32];
  s[threadIdx.x % 32] = 0.f;
  h[threadIdx.x % 32] = 0;
  __syncthreads();
  if (n > 0) atomicAdd(&f[0], 1.0f);
  if (n > 1) atomicAdd(&s[threadIdx.x % 32], 1.0f);
  if (n > 2) atomicAdd(&h[threadIdx.x % 32], 1);
  if (n > 3) t[0] = clock64();
  __syncthreads();
  f[1 + threadIdx.x] = s[threadIdx.x % 32] + h[threadIdx.x % 32];
}
"""


def test_contract_sass_layer_fires_on_card(cuda_device, tmp_path):
    """The SASS layer on a probe built with the port's own flags: the
    global float atomic (a REDG .F32), the shared-memory float atomic (a
    CAS loop) and the clock read are flagged; the integer shared-memory
    atomic is not."""
    from repro_torch.contractcheck import cudacheck
    from repro_torch.kernels import _build

    src = tmp_path / "probe.cu"
    src.write_text(PROBE_CU)
    (fn,) = cudacheck.read_sass(_build.build(src)).values()
    assert fn.name == "probe_kernel"
    assert sorted(rule for rule, _ in fn.hazards) == [
        "CU-RNG", "CU-SUM", "CU-SUM"], fn.hazards


# -------------------------------------------------------- the sharded stack


@pytest.fixture
def card_world_of_one(cuda_device, monkeypatch):
    """An NCCL world of one in this process, torn down afterwards."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as tmesh
    monkeypatch.setattr(tmesh, "_MESHES", {})
    assert not dist.is_initialized()
    yield cuda_device
    if dist.is_initialized():
        dist.destroy_process_group()


def _sharding_case(arch, device):
    """A tests/torch_sharding_worker.py case's config and a fresh state
    from seed 0 on ``device``."""
    import torch_sharding_worker as worker
    cfg = worker.case_fields(get_config(arch, reduced=True))
    return cfg, _fresh_train_state(cfg, device)


def test_sharded_step_world_of_one_on_card(card_world_of_one):
    """A (1, 1) mesh in an NCCL world of one: the reduced gemma-2b in
    float32, 3 sharded steps, each step's loss and grad norm and every
    shard (the whole tensor on a mesh of ones) bit-equal to the unsharded
    step's on the card, no kernel of the port launched; then
    `compressed_psum` over the world within the reference's bound of the
    exact mean."""
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch.shardutil import state_shardings
    from repro_torch.parallel import sharding as PS
    from repro_torch.train import OptConfig, abstract_state, make_train_step
    from repro_torch.train import compression as C
    from repro_torch.train import steps as ST
    import torch_sharding_worker as worker
    dev = card_world_of_one
    rules = PS.make_rules(tmesh.make_mesh((1, 1), "cuda"))
    cfg, plain = _sharding_case("gemma-2b", dev)
    _, sharded = _sharding_case("gemma-2b", dev)
    sharded = ST.shard_state(sharded, state_shardings(abstract_state(cfg),
                                                      rules))
    opt = OptConfig(**worker.STEP_OPT)
    step, sstep = make_train_step(cfg, opt), \
        ST.make_sharded_train_step(cfg, opt, rules)
    before = {**tkernel.LAUNCHES, **fkernel.LAUNCHES}
    for i in range(3):
        batch = _train_batch(cfg, i, dev)
        plain, want = step(plain, batch)
        sharded, got = sstep(sharded, batch)
        for k in ("loss", "grad_norm"):
            assert torch.equal(got[k], want[k]), (i, k)
        shards = sharded.params.state_dict()
        for k, p in plain.params.state_dict().items():
            assert torch.equal(shards[k].to_local(), p), (i, k)
            assert torch.equal(sharded.opt.m[k].to_local(), plain.opt.m[k])
    assert {**tkernel.LAUNCHES, **fkernel.LAUNCHES} == before
    g = {"g": torch.randn(8, 64, device=dev, generator=torch.Generator(
        device=dev).manual_seed(1))}
    mean, _ = C.compressed_psum(g, C.init_ef(g), None)
    err = float((mean["g"] - g["g"]).abs().max())
    assert err <= 0.02 * float(g["g"].abs().max()) + 1e-3


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_step_gloo_world_on_card(world, cuda_device, tmp_path):
    """tests/torch_sharding_worker.py's ranks on the card (gloo, the
    collectives through host memory): one sharded step of the reduced
    gemma-2b and mixtral-8x22b on each of the world's meshes, every rank
    against the unsharded step on the card under the same rules: the loss
    and metrics to 1e-5 relative, m and sqrt(v) within the bounds the
    gradient tolerance 1e-4 puts on them, the parameters to 1e-6 of each
    leaf's largest value where the unsharded step's root mean square
    gradient is 100 eps or more, to 2 * lr elsewhere (the CPU tests'
    tolerances, `torch_sharding_worker.param_errors`); `compressed_psum`
    alike on every rank."""
    import os
    import subprocess
    import sys
    from collections import OrderedDict
    from pathlib import Path

    from repro_torch.parallel import sharding as PS
    from repro_torch.train import OptConfig, make_train_step
    import torch_sharding_worker as worker
    from repro_torch.data import DataConfig, SyntheticTokens
    batch = SyntheticTokens(DataConfig(
        vocab_size=512, seq_len=worker.S, global_batch=worker.B, seed=1)
    ).batch_at(0, device="cpu")
    inputs = {"batch": batch}
    for arch in worker.ARCHS:
        _, state = _sharding_case(arch, "cpu")
        inputs[arch] = dict(params=OrderedDict(state.params.state_dict()),
                            m=state.opt.m, v=state.opt.v,
                            count=state.opt.count, step=state.step)
    torch.save(inputs, tmp_path / "inputs.pt")
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(Path(worker.__file__)), str(r),
         str(world), str(tmp_path / "store"), str(tmp_path), "cuda"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-2000:] for log in logs)
    ranks = [torch.load(tmp_path / f"w{world}-rank{r}.pt",
                        weights_only=False) for r in range(world)]
    for spec in worker.WORLD_MESHES[world]:
        dims = worker.mesh_dims(spec)
        rules = PS.make_rules(PS.MeshShape(("data", "model")[:len(dims)],
                                           dims))
        for arch in worker.ARCHS:
            cfg, state = _sharding_case(arch, "cuda")
            with PS.use_mesh_rules(rules):
                state, want = make_train_step(
                    cfg, OptConfig(**worker.STEP_OPT))(
                        state, {k: v.cuda() for k, v in batch.items()})
            lr = float(want["lr"])
            for rank, got in enumerate(ranks):
                got = got[spec, arch]
                for k, v in want.items():
                    assert float(got["metrics"][k]) == pytest.approx(
                        float(v), rel=1e-5, abs=1e-12), (rank, k)
                dm, dv, m_tol, v_tol = worker.moment_errors(
                    got["m"], got["v"], state.opt.m, state.opt.v, steps=1)
                assert dm <= m_tol and dv <= v_tol, (rank, dm, dv)
                e = worker.param_errors(got["params"],
                                        state.params.state_dict(),
                                        state.opt.v, steps=1)
                assert e["rel"] <= 1e-6 and e["ill_abs"] <= 2 * lr, (rank,
                                                                     e)
    for round_ in (0, 1):
        first = ranks[0]["psum"]["world", round_]["mean"]
        for got in ranks[1:]:
            assert all(torch.equal(got["psum"]["world", round_]["mean"][k],
                                   first[k]) for k in first)
