"""The port's data pipeline against repro.data (tests/test_data.py): the
same batches, as int32 tensors, from `SyntheticTokens` and from
`ObjectStoreTokens` through both stores; the shards written through both
packages are byte-identical."""

import os
import tempfile

import numpy as np
import pytest
import torch

import repro.data as jdata
import repro.io as jio
import repro.io.objectstore as jstore
import repro_torch.io.objectstore as tstore
from repro.core.policies import PolicyConfig as JPolicy
from repro_torch.core.policies import PolicyConfig
from repro_torch.data import DataConfig, ObjectStoreTokens, SyntheticTokens
from repro_torch.io import IOClient, IOClientConfig, LocalFSStore
from test_torch_io import FakeClock, _tree_bytes


def _assert_batch(got, want):
    assert sorted(got) == ["targets", "tokens"]
    for k in got:
        assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), want[k], k)


@pytest.mark.parametrize("step", [0, 12, 13])
def test_synthetic_matches_reference(step):
    kw = dict(vocab_size=777, seq_len=16, global_batch=4, seed=9)
    got = SyntheticTokens(DataConfig(**kw)).batch_at(step, device="cpu")
    _assert_batch(got, jdata.SyntheticTokens(
        jdata.DataConfig(**kw)).batch_at(step))
    assert torch.equal(got["tokens"][:, 1:], got["targets"][:, :-1])


def test_deterministic_and_shifted():
    p = SyntheticTokens(DataConfig(vocab_size=100, seq_len=8,
                                   global_batch=2))
    a, b = p.batch_at(0, device="cpu"), p.batch_at(0, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], p.batch_at(1, "cpu")["tokens"])
    assert a["tokens"].min() >= 1 and a["tokens"].max() < 100
    with pytest.raises(ValueError):
        DataConfig(vocab_size=10, seq_len=4, global_batch=3, n_hosts=2)


def test_elastic_host_resharding_replays_global_batch():
    base = dict(vocab_size=500, seq_len=12, global_batch=6, seed=3)
    full = SyntheticTokens(DataConfig(**base)).batch_at(4, device="cpu")
    parts = [SyntheticTokens(DataConfig(**base, n_hosts=2, host_id=h))
             .batch_at(4, device="cpu")["tokens"] for h in (0, 1)]
    assert torch.equal(torch.cat(parts), full["tokens"])
    _assert_batch(SyntheticTokens(DataConfig(**base, n_hosts=2, host_id=1))
                  .batch_at(4, device="cpu"),
                  jdata.SyntheticTokens(jdata.DataConfig(
                      **base, n_hosts=2, host_id=1)).batch_at(4))


def test_batch_at_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SyntheticTokens(DataConfig(vocab_size=10, seq_len=4,
                                   global_batch=1)).batch_at(0)


@pytest.mark.parametrize("policy,delay", [("rr", None), ("ect", 0.02)])
def test_object_store_pipeline_matches_reference(policy, delay,
                                                 monkeypatch):
    """Shards prepared through both packages' clients (ect with a slow
    server, so reads follow redirects): byte-identical stores, and every
    batch equal to the reference's and to `SyntheticTokens`'."""
    for mod in (jstore, tstore):
        monkeypatch.setattr(mod, "time", FakeClock())
    kw = dict(vocab_size=333, seq_len=255, global_batch=4, seed=5)
    with tempfile.TemporaryDirectory() as d:
        stores = (LocalFSStore(os.path.join(d, "port"), 4),
                  jio.LocalFSStore(os.path.join(d, "ref"), 4))
        if delay:
            for s in stores:
                s.set_write_delay(1, delay)
        port = ObjectStoreTokens(DataConfig(**kw), IOClient(
            stores[0], IOClientConfig(
                policy=PolicyConfig(name=policy, threshold=0.0),
                stripe_size=8192)), rows_per_shard=64)
        ref = jdata.ObjectStoreTokens(jdata.DataConfig(**kw), jio.IOClient(
            stores[1], jio.IOClientConfig(
                policy=JPolicy(name=policy, threshold=0.0),
                stripe_size=8192)), rows_per_shard=64)
        assert port.prepare(n_steps=20) == ref.prepare(n_steps=20) == 2
        assert _tree_bytes(os.path.join(d, "port")) == \
            _tree_bytes(os.path.join(d, "ref"))
        if delay:
            assert stores[0].redirect_count() > 0
        synth = SyntheticTokens(DataConfig(**kw))
        for step in (0, 7, 15, 19):
            got = port.batch_at(step, device="cpu")
            _assert_batch(got, ref.batch_at(step))
            want = synth.batch_at(step, device="cpu")
            assert torch.equal(got["tokens"], want["tokens"])
            assert torch.equal(got["targets"], want["targets"])
