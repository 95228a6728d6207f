"""The port's checkpoint layer: the behaviours of tests/test_checkpoint.py
(atomic commit, async save with its barrier, GC, failure retry, checksum
verification, restore onto a device), plus parity with repro.checkpoint:
the same tree saves to JSON-equal manifests and byte-identical stores in
both packages, and a checkpoint written by either restores bit-exactly in
the other (the tree of tests/test_checkpoint.py, its bfloat16 leaf, int32
scalar and list, and an empty leaf)."""

import collections
import json
import os
import tempfile

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch import nn

import repro.checkpoint as jckpt
import repro.checkpoint.manifest as JM
import repro.io.objectstore as jstore
import repro_torch.checkpoint.manifest as M
import repro_torch.io.objectstore as tstore
from repro.core.policies import PolicyConfig as JPolicy
from repro.io import IOClientConfig as JIOConfig
from repro_torch.checkpoint import CheckpointConfig, Checkpointer
from repro_torch.core.policies import PolicyConfig
from repro_torch.io import IOClientConfig
from repro_torch.io.striping import MB
from test_torch_io import FakeClock, _tree_bytes


def _np_tree(seed=0):
    """Numpy leaves of tests/test_checkpoint.py's tree; the bfloat16 leaf
    as raw uint16 words (random bit patterns of finite values)."""
    rng = np.random.default_rng(seed)
    bf16 = rng.integers(0, 0x7F00, 200).astype(np.uint16)
    bf16[::2] |= 0x8000
    return {"layer": {"w": rng.standard_normal((300, 200)).astype(np.float32),
                      "b": bf16},
            "step": np.asarray(17 + seed, np.int32),
            "empty": np.zeros((0, 3), np.float32),
            "nested": [np.arange(5.0, dtype=np.float32),
                       np.ones((2, 3, 4), np.float32)]}


def _port_tree(seed=0):
    t = _np_tree(seed)
    return {"layer": {"w": torch.from_numpy(t["layer"]["w"]),
                      "b": torch.from_numpy(t["layer"]["b"].view(
                          np.int16)).view(torch.bfloat16)},
            "step": torch.from_numpy(t["step"]),
            "empty": torch.from_numpy(t["empty"]),
            "nested": [torch.from_numpy(a) for a in t["nested"]]}


def _ref_tree(seed=0):
    t = _np_tree(seed)
    return {"layer": {"w": jnp.asarray(t["layer"]["w"]),
                      "b": jnp.asarray(t["layer"]["b"].view(
                          ml_dtypes.bfloat16))},
            "step": jnp.asarray(t["step"]),
            "empty": jnp.asarray(t["empty"]),
            "nested": [jnp.asarray(a) for a in t["nested"]]}


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes (torch tensor or array of any dtype)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _assert_same_leaves(got, want):
    """Two port trees: equal paths, shapes, dtypes and bytes."""
    fg, fw = M.flatten_with_paths(got), M.flatten_with_paths(want)
    assert [p for p, _ in fg] == [p for p, _ in fw]
    for (p, a), (_, b) in zip(fg, fw):
        assert a.shape == b.shape and a.dtype == b.dtype, p
        np.testing.assert_array_equal(_bits(a), _bits(b), p)


def _ckpt(d, **kw):
    io = IOClientConfig(policy=PolicyConfig(name="trh", threshold=0.1),
                        stripe_size=MB // 4)
    cfg = CheckpointConfig(shard_size_mb=0.25, keep_n=2, io=io, **kw)
    return Checkpointer(d, n_servers=5, cfg=cfg)


def _ref_ckpt(d):
    io = JIOConfig(policy=JPolicy(name="trh", threshold=0.1),
                   stripe_size=MB // 4)
    cfg = jckpt.CheckpointConfig(shard_size_mb=0.25, keep_n=2, io=io)
    return jckpt.Checkpointer(d, n_servers=5, cfg=cfg)


def _zeros_like(tree):
    return {"layer": {k: torch.zeros_like(v)
                      for k, v in tree["layer"].items()},
            "step": torch.zeros_like(tree["step"]),
            "empty": torch.zeros_like(tree["empty"]),
            "nested": [torch.zeros_like(v) for v in tree["nested"]]}


def test_save_restore_exact_roundtrip():
    with tempfile.TemporaryDirectory() as d:
        ck = _ckpt(d)
        tree = _port_tree()
        ck.save(5, tree)
        back = ck.restore(target=_zeros_like(tree))
        _assert_same_leaves(back, tree)
        assert back["layer"]["b"].dtype == torch.bfloat16
        assert back["step"].dtype == torch.int32 and back["step"].dim() == 0
        assert isinstance(back["nested"], list)
        assert {leaf.path: leaf.dtype for leaf in ck.manifest(5).leaves}[
            "layer/b"] == "bfloat16"
        ck.close()


def test_restore_without_target_gives_named_dict():
    with tempfile.TemporaryDirectory() as d:
        ck = _ckpt(d)
        ck.save(1, _port_tree())
        named = ck.restore(device="cpu")
        assert named["layer/w"].shape == (300, 200)
        assert sorted(named) == ["empty", "layer/b", "layer/w", "nested/0",
                                 "nested/1", "step"]
        assert named["empty"].shape == (0, 3)


def test_restore_devices(monkeypatch):
    """Default: a target tensor's own device, else the card (raising
    without one); a callable picks per path."""
    with tempfile.TemporaryDirectory() as d:
        ck = _ckpt(d)
        ck.save(1, {"w": torch.arange(64.0).reshape(8, 8)})
        seen = []
        back = ck.restore(device=lambda p: seen.append(p) or "cpu")
        assert seen == ["w"] and back["w"].device.type == "cpu"
        back = ck.restore(target={"w": torch.zeros(8, 8)})
        assert torch.equal(back["w"], torch.arange(64.0).reshape(8, 8))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            ck.restore()


def test_gc_keeps_newest_n():
    with tempfile.TemporaryDirectory() as d:
        ck = _ckpt(d)
        for s in (10, 20, 30, 40):
            ck.save(s, _port_tree())
        assert M.committed_steps(ck.manifest_dir) == [30, 40]
        assert ck.latest_step() == 40
        _assert_same_leaves(ck.restore(step=40, target=_zeros_like(
            _port_tree())), _port_tree())


def test_uncommitted_save_is_invisible(monkeypatch):
    with tempfile.TemporaryDirectory() as d:
        ck = _ckpt(d)
        t1 = _port_tree(1)
        ck.save(1, t1)
        named = [(p, a.clone()) for p, a in
                 M.flatten_with_paths(_port_tree(2))]

        def crash(root, step):
            raise KeyboardInterrupt

        monkeypatch.setattr(M, "commit", crash)
        with pytest.raises(KeyboardInterrupt):
            ck._write_tree(2, named, {})
        monkeypatch.undo()
        assert ck.latest_step() == 1
        _assert_same_leaves(ck.restore(target=_zeros_like(t1)), t1)


def test_async_save_overlaps_and_barriers():
    """The snapshot is a copy taken at save(): an in-place mutation of the
    live tree afterwards does not reach it."""
    with tempfile.TemporaryDirectory() as d:
        ck = _ckpt(d, async_save=True)
        tree = _port_tree()
        want = tree["layer"]["w"].clone()
        ck.save(7, tree, block=False)
        ck.wait_until_finished()
        assert ck.latest_step() == 7
        ck.save(8, tree, block=False)
        tree["layer"]["w"].mul_(0)              # in place, on the host
        ck.wait_until_finished()
        assert torch.equal(ck.restore(step=8, device="cpu")["layer/w"],
                           want)


def test_async_save_surfaces_errors():
    with tempfile.TemporaryDirectory() as d:
        ck = _ckpt(d, async_save=True)
        for s in range(5):
            ck.store.fail_server(s)
        ck.save(1, {"x": torch.ones(10)})
        with pytest.raises(Exception):
            ck.wait_until_finished()
        ck.wait_until_finished()                # the error is consumed


def test_save_survives_server_failure():
    with tempfile.TemporaryDirectory() as d:
        ck = _ckpt(d)
        ck.store.fail_server(1)
        ck.store.fail_server(3)
        tree = _port_tree()
        ck.save(3, tree)
        _assert_same_leaves(ck.restore(target=_zeros_like(tree)), tree)
        assert ck.client.failed_writes > 0
        assert {1, 3} <= ck.client.sched.masked_servers


def test_checksum_detects_corruption():
    with tempfile.TemporaryDirectory() as d:
        ck = _ckpt(d)
        ck.save(1, {"x": torch.arange(100000.0)})
        victim = None
        for root, _, files in os.walk(os.path.join(d, "objects")):
            for f in files:
                if f.endswith(".bin"):
                    victim = os.path.join(root, f)
        with open(victim, "r+b") as f:
            f.seek(10)
            f.write(b"\xff\xff\xff\xff")
        with pytest.raises(IOError):
            ck.restore(step=1, target={"x": torch.zeros(100000)})


def test_module_tree_roundtrip():
    """An nn.Module stands for its state_dict: its paths keep the
    insertion order, and restore hands back a state_dict it loads."""
    torch.manual_seed(0)
    net = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))
    net[0].weight.data = net[0].weight.data.to(torch.bfloat16).float()
    with tempfile.TemporaryDirectory() as d:
        ck = _ckpt(d)
        ck.save(1, {"net": net, "opt": (torch.tensor(3), None)})
        paths = [p for p, _ in M.flatten_with_paths({"net": net})]
        assert paths == ["net/" + k for k in net.state_dict()]
        other = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))
        back = ck.restore(target={"net": other,
                                  "opt": (torch.tensor(0), None)})
        assert isinstance(back["net"], collections.OrderedDict)
        assert back["opt"][1] is None and int(back["opt"][0]) == 3
        other.load_state_dict(back["net"])
        for k, v in net.state_dict().items():
            assert torch.equal(other.state_dict()[k], v)


def test_paths_match_reference_keystr():
    Pair = collections.namedtuple("Pair", "lo hi")
    tree = {"b": [1, {"z": 2, "a": (3, 4)}], "a": Pair(5, 6), "c": None,
            "d": collections.OrderedDict([("y", 7), ("x", 8)])}
    want = [(p, v) for p, v in JM.flatten_with_paths(tree)]
    assert M.flatten_with_paths(tree) == want
    named = {p: v * 10 for p, v in want}
    assert M.unflatten_like(tree, named) == {
        "b": [10, {"z": 20, "a": (30, 40)}], "a": Pair(50, 60), "c": None,
        "d": collections.OrderedDict([("y", 70), ("x", 80)])}
    with pytest.raises(KeyError):
        M.unflatten_like(tree, {})


def test_scheduler_balances_checkpoint_objects(monkeypatch):
    for mod in (jstore, tstore):
        monkeypatch.setattr(mod, "time", FakeClock())

    def bytes_on(policy, straggler_delay):
        with tempfile.TemporaryDirectory() as d:
            thr = 0.001 if policy == "ect" else 0.05
            io = IOClientConfig(policy=PolicyConfig(name=policy,
                                                    threshold=thr),
                                stripe_size=MB // 4)
            ck = Checkpointer(d, n_servers=4,
                              cfg=CheckpointConfig(shard_size_mb=0.25,
                                                   io=io))
            ck.store.set_write_delay(0, straggler_delay)
            ck.save(1, {"w": torch.ones((1200, 1200))})
            sdir = os.path.join(d, "objects", "server_0000")
            return sum(os.path.getsize(os.path.join(sdir, f))
                       for f in os.listdir(sdir) if f.endswith(".bin"))

    assert bytes_on("ect", 0.05) < bytes_on("rr", 0.0)


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_clock(monkeypatch):
    for mod in (jstore, tstore):
        monkeypatch.setattr(mod, "time", FakeClock())


def test_same_tree_same_manifest_and_store(fake_clock):
    """Saved through both packages (one server failed, so the retry path
    runs): JSON-equal manifests, equal file ids and checksums, and
    byte-identical object stores."""
    with tempfile.TemporaryDirectory() as d:
        ports, refs = _ckpt(os.path.join(d, "port")), \
            _ref_ckpt(os.path.join(d, "ref"))
        for ck in (ports, refs):
            ck.store.fail_server(2)
        ports.save(4, _port_tree(), meta={"run": "x"})
        refs.save(4, _ref_tree(), meta={"run": "x"})
        got = json.loads(ports.manifest(4).to_json())
        want = json.loads(refs.manifest(4).to_json())
        assert got == want
        assert ports.client.failed_writes == refs.client.failed_writes > 0
        assert _tree_bytes(os.path.join(d, "port")) == \
            _tree_bytes(os.path.join(d, "ref"))
        assert M.file_id_for(4, 1, 0) == JM.file_id_for(4, 1, 0)


def test_port_checkpoint_restores_in_reference():
    with tempfile.TemporaryDirectory() as d:
        _ckpt(d).save(3, _port_tree())
        ref = _ref_ckpt(d)
        named = ref.restore(step=3)
        assert str(named["layer/b"].dtype) == "bfloat16"
        want = _np_tree()
        for p, leaf in JM.flatten_with_paths(want):
            np.testing.assert_array_equal(_bits(named[p]), _bits(leaf), p)
        back = ref.restore(step=3, target=_ref_tree(9))
        for (p, a), (_, b) in zip(JM.flatten_with_paths(back),
                                  JM.flatten_with_paths(_ref_tree())):
            np.testing.assert_array_equal(_bits(a), _bits(b), p)


def test_reference_checkpoint_restores_in_port():
    with tempfile.TemporaryDirectory() as d:
        _ref_ckpt(d).save(3, _ref_tree())
        back = _ckpt(d).restore(step=3, target=_zeros_like(_port_tree()))
        _assert_same_leaves(back, _port_tree())
        assert back["layer"]["b"].dtype == torch.bfloat16
