"""Tests that need the card (marker ``gpu``): the CUDA kernel against its
plain PyTorch version on the same CUDA tensors.

Bit-exact on choices, latencies, loads, window loads and metrics; probs
to 1e-6 and ewma/est to 1e-6 relative (the contract the CPU tests hold
against the JAX package).  Without a card every test skips with a
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
from torch_parity import (BATCH_CASES, KW, assert_stream_outputs,
                          batch_case, port_batch)

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
    before = tkernel.LAUNCHES
    got = port_batch(arrays, cuda_device, **kw)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES == before + 1
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
    before = tkernel.LAUNCHES
    res = simulate.run_trials(3, cfg, pol, log)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES == before + 1
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
