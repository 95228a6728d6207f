"""Tests that need the card (marker ``gpu``): the CUDA kernels against
their plain PyTorch versions on the same CUDA tensors.

Bit-exact on choices, latencies, loads, window loads, metrics and the
merged outputs (cm_wloads, cm_metrics, cm_lats, cm_lval); probs to 1e-6
and ewma/est to 1e-6 relative (the contract the CPU tests hold against
the JAX package).  Without a card every test skips with a
reason; the file imports torch and numpy only, so it runs where JAX is
not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import simulate
from repro_torch.core.policies import PolicyConfig
from repro_torch.kernels.sched_select import kernel as tkernel
from repro_torch.kernels.sched_select import ops as tops
from torch_parity import (BATCH_CASES, GRID_CASES, KW, assert_grid_outputs,
                          assert_stream_outputs, batch_case, grid_case,
                          port_batch)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("case", enumerate(BATCH_CASES),
                         ids=lambda c: "-".join(map(str, c[1])))
def test_cuda_kernel_matches_plain_on_card(case, cuda_device):
    idx, (t, m, n_win, win, policy) = case
    arrays = batch_case(t, m, n_win, win, seed=1000 + idx)
    kw = dict(KW, n_servers=m, window_size=win, policy=policy)
    before = tkernel.LAUNCHES["sched_stream"]
    got = port_batch(arrays, cuda_device, **kw)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES["sched_stream"] == before + 1
    want = port_batch(arrays, cuda_device, fn=tops.sched_stream_batch_plain,
                      **kw)
    assert_stream_outputs(got, want, win, f"cuda {policy} {case[1]}")


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


@pytest.mark.parametrize("policy", tops.POLICIES)
@pytest.mark.parametrize("case", enumerate(GRID_CASES),
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
