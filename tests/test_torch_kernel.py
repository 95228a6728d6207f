"""Port parity of the trial-grid stream kernel.

On the CPU: the port's plain PyTorch version (`sched_stream_batch_ref`,
reached through `ops.sched_stream_batch` on CPU tensors) against the JAX
package's oracle and, on one small case, its Pallas kernel in interpret
mode.  Bit-exact: choices, latencies, the loads row, window loads and the
fused metric rows.  Held to a tolerance: the probs, ewma and est rows —
``exp`` (kernel.py:389 of the reference) may differ by an ulp between XLA
and PyTorch, and XLA may contract the EWMA blend into an FMA where the
port never does (kernel.py:408, "1e-6-soft").  probs are held to
atol=1e-6; ewma/est are rates in MB/s (up to a few hundred, where one
ulp is 3e-5), so they are held to 1e-6 relative.

The CUDA kernel against the plain version on the card is in
tests/test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import statlog as jstatlog
from repro.kernels.sched_select import ops as jops
from repro.kernels.sched_select.ref import \
    sched_stream_batch_ref as jax_batch_ref
from repro_torch.kernels.sched_select import kernel as tkernel
from torch_parity import (BATCH_CASES, KW, assert_stream_outputs,
                          batch_case, port_batch)


def _case_jax(t, m, n_win, win, seed):
    """`batch_case`, whose fresh tables are checked against the JAX
    package's own `init_state`."""
    arrays = batch_case(t, m, n_win, win, seed)
    table = np.asarray(jstatlog.init_state(
        jstatlog.LogConfig(n_servers=m, lam=50.0)).log)
    np.testing.assert_array_equal(arrays[3][0], table)
    return arrays


@pytest.mark.parametrize("case", enumerate(BATCH_CASES),
                         ids=lambda c: "-".join(map(str, c[1])))
def test_plain_version_matches_jax_oracle(case):
    idx, (t, m, n_win, win, policy) = case
    arrays = _case_jax(t, m, n_win, win, seed=1000 + idx)
    kw = dict(KW, n_servers=m, window_size=win, policy=policy)
    got = port_batch(arrays, **kw)
    want = jax_batch_ref(*(jnp.asarray(a) for a in arrays), **kw)
    assert_stream_outputs(got, want, win, f"{policy} {case[1]}")


@pytest.mark.parametrize("policy", ["ect", "nltr"])
def test_plain_version_matches_pallas_interpret(policy):
    """The reference's Pallas kernel itself, run as its own CPU tests run
    it (interpret mode), on a small case."""
    t, m, n_win, win = 3, 24, 3, 30
    arrays = _case_jax(t, m, n_win, win, seed=77)
    kw = dict(KW, n_servers=m, window_size=win, policy=policy)
    got = port_batch(arrays, **kw)
    want = jops.sched_stream_batch(*(jnp.asarray(a) for a in arrays),
                                   trial_tile=2, interpret=True, **kw)
    assert_stream_outputs(got, want, win, f"pallas-interpret {policy}")


def test_dispatch_checks():
    arrays = _case_jax(2, 20, 2, 8, seed=1)
    with pytest.raises(ValueError, match="nltr needs"):
        port_batch(arrays, **dict(KW, n_servers=20, window_size=8,
                                  policy="nltr", nltr_n=5))
    with pytest.raises(ValueError, match="kernel policy"):
        port_batch(arrays, **dict(KW, n_servers=20, window_size=8,
                                  policy="fifo"))
    # the launch wrapper takes CUDA tensors only: no CPU path inside it
    obj, lens, valid, tables, seeds, rates = (torch.from_numpy(a)
                                              for a in arrays)
    pad = lambda x: torch.nn.functional.pad(x, (0, 108))  # noqa: E731
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.sched_stream_call(
            obj, lens, valid.to(torch.int32), pad(tables), seeds.long(),
            pad(rates), n_servers=20, window_size=8, threshold=2.0,
            lam=50.0, alpha=0.25, window_dt=0.02, policy="ect",
            observe=True, renorm=True)


def test_seed_bit_pattern():
    s = torch.tensor([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1])
    got = tkernel.seeds_as_int32(s)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy().view(np.uint32),
        np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1], np.uint32))


class _BudgetLibrary:
    """Stands in for the built library's ``sched_stream_budget``: reports
    ``words`` a stream and a ``budget`` of bytes, and records its calls."""

    def __init__(self, words, budget):
        self.words, self.budget, self.calls = words, budget, []

    def sched_stream_budget(self, policy, m_pad, window, words, budget):
        self.calls.append((policy, m_pad, window))
        words._obj.value, budget._obj.value = self.words, self.budget
        return 0


# (window, M_pad, policy, words the library reports, None or the message)
H100_OPTIN = 232448
DOMAIN_CASES = [
    (2048, 2048, "mlml", 36928, None),
    (1024, 4096, "nltr", 46144, None),
    (1024, 8192, "ect", 78912, "window_size=1024 with M_pad=8192 needs "
     "315648 bytes .78912 words. .*under ect, past the 232448 bytes .*"
     "JAX reference has no cap.*backend='jax'.* no cap"),
    (4096, 128, "minload", 25664, None),
]


@pytest.mark.parametrize("window,m_pad,policy,words,match", DOMAIN_CASES)
def test_stream_kernel_domain_is_stated(monkeypatch, window, m_pad, policy,
                                        words, match):
    """The CUDA stream kernel's one limit is a block's opt-in shared memory
    (README): the check asks the library's ``sched_stream_budget`` for the
    words a stream needs and the card's budget, and an input past it raises
    naming both, that the eager engine (backend='jax') schedules it with no
    cap and the reference has none.  The window and the server count have
    no cap of their own; nothing falls back to the CPU."""
    lib = _BudgetLibrary(words, H100_OPTIN)
    monkeypatch.setattr(tkernel, "_library", lambda: lib)
    assert tkernel.stream_budget(policy, m_pad, window) == (4 * words,
                                                            H100_OPTIN)
    if match is None:
        tkernel.check_stream_domain(policy, m_pad, window)
    else:
        with pytest.raises(ValueError, match=match):
            tkernel.check_stream_domain(policy, m_pad, window)
    code = tkernel.POLICY_CODES[policy]
    assert lib.calls == [(code, m_pad, window)] * 2


def test_stream_kernel_limit_is_the_shared_memory_budget():
    """No fixed cap is left: the wrappers hold no window or server limit,
    and the CUDA source accepts a shape when one stream fits the device's
    opt-in shared memory per block, read from the runtime."""
    assert not hasattr(tkernel, "MAX_WINDOW")
    assert not hasattr(tkernel, "MAX_M_PAD")
    src = tkernel.SOURCE.read_text()
    assert "cudaDevAttrMaxSharedMemoryPerBlockOptin" in src
    assert "227 * 1024" not in src
    launch = src[src.index('extern "C" int sched_stream_launch'):]
    launch = launch[:launch.index("Params p;")]
    assert "1024" not in launch
