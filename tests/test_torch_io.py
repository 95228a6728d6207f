"""Port parity of the I/O substrate: repro_torch.io (striping, both stores,
the maintainer, the client) against repro.io, case for case with
tests/test_io.py.

Object ids, placements, phase times, per-server request counts, write
records and the client's log rows are bit-equal with the reference on the
same operations; the bytes of every object file and every
``_redirect.json`` of a `LocalFSStore` written through both packages are
identical.  Where a store's timing feeds the log (ect's observed rates),
both packages' stores read one deterministic clock, whose sleeps advance
it instead of waiting."""

import os
import tempfile
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, strategies as st

import repro.io as jio
import repro.io.objectstore as jstore
import repro_torch.io as tio
import repro_torch.io.objectstore as tstore
from repro.core.engine import ClusterTrace as JTrace
from repro.core.policies import PolicyConfig as JPolicy
from repro_torch.core.engine import ClusterTrace as TTrace
from repro_torch.core.policies import PolicyConfig as TPolicy
from repro_torch.io.striping import MB, StripingConfig, stripe_request

PKGS = {"ref": (jio, JPolicy), "port": (tio, TPolicy)}


class FakeClock:
    """`time` for a store: ``monotonic`` steps 1e-4 s a call and
    ``sleep`` advances the clock instead of waiting, so a store's write
    rates are a function of its calls alone."""

    def __init__(self):
        self.t = 0.0

    def monotonic(self):
        self.t += 1e-4
        return self.t

    def sleep(self, s):
        self.t += s


@pytest.fixture
def fake_clock(monkeypatch):
    for mod in (jstore, tstore):
        monkeypatch.setattr(mod, "time", FakeClock())


def _records(cli):
    return [(r.object_id, r.stripe_index, r.server, r.mb, r.seconds,
             r.redirected, r.retries, r.replicas) for r in cli.records]


def _assert_clients_equal(ref, port):
    assert _records(port) == _records(ref)
    assert port.probe_messages == ref.probe_messages
    assert port.failed_writes == ref.failed_writes
    assert port.sched.masked_servers == ref.sched.masked_servers
    np.testing.assert_array_equal(port.log.loads.numpy(), ref.log.loads)
    np.testing.assert_array_equal(port.log.n_assigned.numpy(),
                                  ref.log.n_assigned)
    assert port.log.request_log == ref.log.request_log
    np.testing.assert_allclose(port.log_table.numpy(), ref.log_table,
                               rtol=1e-12, atol=0)
    want, got = ref.stats(), port.stats()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), k


# ---------------------------------------------------------------------------
# striping
# ---------------------------------------------------------------------------


@given(offset=st.integers(0, 10 * MB), length=st.integers(0, 20 * MB),
       stripe=st.sampled_from([MB, 2 * MB, 4 * MB]),
       file_id=st.integers(0, 2 ** 62))
def test_striping_matches_reference(offset, length, stripe, file_id):
    got = stripe_request(StripingConfig(stripe_size=stripe), file_id,
                         offset, length)
    want = jio.stripe_request(jio.StripingConfig(stripe_size=stripe),
                              file_id, offset, length)
    assert [vars(r) for r in got] == [vars(r) for r in want]
    assert sum(r.length for r in got) == length
    pos = offset
    for r in got:
        assert r.file_offset == pos and r.offset == pos % stripe
        assert r.offset + r.length <= stripe
        pos += r.length
    assert tio.striping.n_stripes(StripingConfig(stripe_size=stripe),
                                  length) == \
        jio.striping.n_stripes(jio.StripingConfig(stripe_size=stripe),
                               length)


def test_boundary_split_example():
    reqs = stripe_request(StripingConfig(stripe_size=4 * MB), 1,
                          offset=3 * MB, length=2 * MB)
    assert [(r.length, r.stripe_index) for r in reqs] == [(MB, 0), (MB, 1)]
    with pytest.raises(ValueError):
        StripingConfig(stripe_size=0)


# ---------------------------------------------------------------------------
# stores and the maintainer
# ---------------------------------------------------------------------------


def test_localfs_roundtrip_redirect_and_maintainer():
    with tempfile.TemporaryDirectory() as d:
        store = tio.LocalFSStore(d, n_servers=4)
        data = np.random.default_rng(1).integers(
            0, 256, 3 * MB, dtype=np.uint8).tobytes()
        oid = 11  # default home = 3
        assert store.write_object(oid, data, server=1).server == 1
        assert store.get_redirect(3, oid) == 1 and store.locate(oid) == 1
        assert store.read_object(oid) == data
        # the reference reads the same store
        ref = jio.LocalFSStore(d, n_servers=4)
        assert ref.get_redirect(3, oid) == 1 and ref.read_object(oid) == data
        assert store.maintainer_tick() == 1
        assert store.locate(oid) == 3 and store.get_redirect(3, oid) is None
        assert store.read_object(oid) == data
        store.delete_object(oid)
        with pytest.raises(tio.ObjectMissingError):
            store.locate(oid)


def test_localfs_failure_injection():
    with tempfile.TemporaryDirectory() as d:
        store = tio.LocalFSStore(d, n_servers=2)
        store.fail_server(0)
        assert store.is_failed(0)
        with pytest.raises(tio.ServerFailedError):
            store.write_object(5, b"xx", 0)
        store.heal_server(0)
        store.write_object(5, b"xx", 0)


def test_maintainer_thread_runs():
    with tempfile.TemporaryDirectory() as d:
        store = tio.LocalFSStore(d, n_servers=3)
        store.write_object(4, b"abc", 2)  # home 1 -> redirect
        t = tio.MaintainerThread(store, interval_s=0.01)
        t.start()
        deadline = time.time() + 5
        while store.redirect_count() and time.time() < deadline:
            time.sleep(0.02)
        t.stop()
        assert store.redirect_count() == 0 and store.locate(4) == 1
        assert t.total_moved == 1


def test_redirect_table():
    t = tio.RedirectTable()
    t.set(7, 2)
    assert t.get(7) == 2 and len(t) == 1 and t.items() == [(7, 2)]
    assert t.pop(7) == 2 and t.pop(7) is None


def _sim_ops(sim):
    """A mixed op stream on a simulated cluster; returns what it saw."""
    seen = [sim.write_object(0, 100.0, 0).finished_at,
            sim.write_object(1, 400.0, 1).finished_at]
    sim.make_straggler(2, slow_factor=10.0)
    sim.add_external_load(3, 50.0)
    seen.append(sim.write_object(6, 100.0, 2).finished_at)
    seen.append(sim.write_object(7, 30.0, 3).finished_at)
    seen.append(sim.queued_mb(3))
    seen.append(sim.barrier())
    seen.append(sim.read_object(6)[2].finished_at)
    sim.fail_server(1)
    with pytest.raises(Exception):
        sim.write_object(9, 1.0, 1)
    sim.heal_server(1)
    seen.append(sim.advance_time(0.5))
    seen.append(sim.maintainer_tick())
    seen.append(sim.barrier())
    seen.append([(s.free_at, s.pending_mb, s.n_requests, s.total_written_mb)
                 for s in sim.servers])
    seen.append(sim.stats())
    return seen


def test_sim_cluster_matches_reference():
    got = _sim_ops(tio.SimulatedCluster(4, base_rate_mb_s=100.0,
                                        rate_jitter=0.2, seed=5))
    want = _sim_ops(jio.SimulatedCluster(4, base_rate_mb_s=100.0,
                                         rate_jitter=0.2, seed=5))
    assert got[:-1] == want[:-1]
    assert got[-1].keys() == want[-1].keys()
    for k in want[-1]:
        assert got[-1][k] == pytest.approx(want[-1][k], rel=1e-12), k


def test_sim_cluster_barrier_semantics():
    sim = tio.SimulatedCluster(4, base_rate_mb_s=100.0)
    sim.write_object(0, 100.0, 0)
    sim.write_object(1, 400.0, 1)
    assert sim.barrier() == 4.0 and sim.clock == 4.0
    sim.make_straggler(2, slow_factor=10.0)
    sim.write_object(0, 100.0, 2)
    assert sim.barrier() == pytest.approx(10.0)


# ---------------------------------------------------------------------------
# the client
# ---------------------------------------------------------------------------


def _fs_client_run(pkg, d, policy, threshold, *, n_servers=6, delay=None,
                   failed=(), replication=1, stripe=MB // 4, files=6):
    io, policy_cls = PKGS[pkg]
    store = io.LocalFSStore(d, n_servers=n_servers)
    for srv in failed:
        store.fail_server(srv)
    if delay is not None:
        store.set_write_delay(*delay)
    cli = io.IOClient(store, io.IOClientConfig(
        policy=policy_cls(name=policy, threshold=threshold),
        stripe_size=stripe, replication=replication))
    rng = np.random.default_rng(0)
    blobs = {f: rng.integers(0, 256, int(rng.integers(1, 3 * MB)),
                             dtype=np.uint8).tobytes() for f in range(files)}
    for f, b in blobs.items():
        cli.write_file(f, b)
    for f, b in blobs.items():
        assert cli.read_file(f, len(b)) == b
    return cli, store


def _tree_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("policy,threshold", [
    ("rr", 0.0), ("mlml", 0.05), ("ect", 0.001), ("trh", 0.05)])
def test_localfs_trees_are_byte_identical(policy, threshold, fake_clock):
    """The same writes through both packages, with a straggler (a write
    delay) and a failed server (the retry path), leave byte-identical
    store trees: every object file and every ``_redirect.json``; again
    after the maintainer moves objects home."""
    with tempfile.TemporaryDirectory() as d:
        clis, stores = {}, {}
        for pkg in PKGS:
            clis[pkg], stores[pkg] = _fs_client_run(
                pkg, os.path.join(d, pkg), policy, threshold,
                delay=(2, 0.05), failed=(4,))
        _assert_clients_equal(clis["ref"], clis["port"])
        trees = {pkg: _tree_bytes(os.path.join(d, pkg)) for pkg in PKGS}
        assert trees["port"] == trees["ref"]
        assert any(k.endswith(".bin") for k in trees["ref"])
        if policy != "rr":
            assert any(k.endswith("_redirect.json") for k in trees["ref"])
        for pkg in PKGS:
            stores[pkg].heal_server(4)
            stores[pkg].maintainer_tick(max_objects=5)
        assert _tree_bytes(os.path.join(d, "port")) == \
            _tree_bytes(os.path.join(d, "ref"))


def test_client_write_read_with_failures():
    with tempfile.TemporaryDirectory() as d:
        cli, _ = _fs_client_run("port", d, "trh", 0.1, failed=(2,),
                                stripe=MB // 2, files=5)
        st_ = cli.stats()
        assert st_["probe_messages"] == 0
        assert 2 in cli.sched.masked_servers or st_["failed_writes"] == 0


def test_client_replication_matches_reference(fake_clock):
    """Replicas on distinct servers, placed as the reference places
    them; a read survives the loss of every primary."""
    with tempfile.TemporaryDirectory() as d:
        clis = {pkg: _fs_client_run(pkg, os.path.join(d, pkg), "mlml", 0.0,
                                    n_servers=5, replication=2, stripe=MB,
                                    files=2)
                for pkg in PKGS}
        _assert_clients_equal(clis["ref"][0], clis["port"][0])
        cli, store = clis["port"]
        data = b"critical" * 1000
        recs = cli.write_file(9, data)
        for r in recs:
            assert len(set(r.replicas)) == 2
            store.fail_server(r.server)
            assert cli.read_file(9, len(data)) == data
            store.heal_server(r.server)


def test_client_async_flush():
    with tempfile.TemporaryDirectory() as d:
        store = tio.LocalFSStore(d, n_servers=4)
        cli = tio.IOClient(store, tio.IOClientConfig(stripe_size=MB,
                                                     async_writers=3))
        data = os.urandom(2 * MB + 17)
        futs = cli.write_file_async(9, data)
        assert len(futs) == 3
        cli.write_file(10, memoryview(data)[:MB + 5])
        assert cli.flush() == 0.0
        assert cli.read_file(9, len(data)) == data
        assert cli.read_file(10, MB + 5) == data[:MB + 5]
        cli.close()
    with pytest.raises(RuntimeError):
        tio.IOClient(tio.SimulatedCluster(2)).write_file_async(0, b"x")
    with pytest.raises(ValueError):
        tio.IOClient(tio.SimulatedCluster(2)).write_file(0)


def _completion_time(pkg, name, n_servers=24, n_files=120, file_mb=16.0):
    """benchmarks/paper_figs.py's completion_time for one policy."""
    io, policy_cls = PKGS[pkg]
    sim = io.SimulatedCluster(n_servers, base_rate_mb_s=200.0, seed=3)
    sim.make_straggler(1, 8.0)
    sim.add_external_load(1, 800.0)
    sim.add_external_load(5, 400.0)
    cli = io.IOClient(sim, io.IOClientConfig(
        policy=policy_cls(name=name, threshold=4.0)))
    for s in range(n_servers):
        cli.log.loads[s] = sim.queued_mb(s)
    for f in range(n_files):
        cli.write_file(f, size_mb=file_mb)
    phase = cli.flush()
    mb = cli.read_file_sim(3, file_mb)
    return cli, (phase, mb, sim.clock, [s.n_requests for s in sim.servers],
                 [s.free_at for s in sim.servers])


@pytest.mark.parametrize("policy", ["rr", "mlml", "trh", "nltr", "ect",
                                    "two_choice"])
def test_completion_time_matches_reference(policy):
    """paper_figs.completion_time's cluster (24 servers, a x8 straggler
    with 800 MB of foreign queue, 400 MB on server 5, 120 files x 16 MB):
    phase time, per-server request counts and every placement bit-equal."""
    ref, want = _completion_time("ref", policy)
    port, got = _completion_time("port", policy)
    assert got == want
    _assert_clients_equal(ref, port)
    if policy in ("trh", "nltr"):
        assert got[3][1] < 19       # fewer straggler hits than rr's 19


@pytest.mark.parametrize("policy,threshold", [("rr", 0.0), ("trh", 4.0),
                                              ("ect", 0.05)])
def test_trace_replay_matches_reference(policy, threshold):
    """The host half of paper_figs.fig_temporal: the port's ClusterTrace
    (torch tensors, copied to the host once) replays as the reference's
    jnp trace does."""
    m, base = 12, 200.0
    slow = np.full(m, base)
    slow[[1, 5]] = base / 8.0
    rates = np.stack([np.full(m, base), slow, np.full(m, base)])
    times = [0.0, 2.0, 6.0]
    traces = {"ref": JTrace(times=jnp.asarray(times, jnp.float32),
                            rates=jnp.asarray(rates, jnp.float32)),
              "port": TTrace(times=torch.tensor(times, dtype=torch.float32),
                             rates=torch.tensor(rates,
                                                dtype=torch.float32))}
    out = {}
    for pkg, (io, policy_cls) in PKGS.items():
        sim = io.SimulatedCluster(m, base_rate_mb_s=base, seed=3,
                                  trace=traces[pkg])
        cli = io.IOClient(sim, io.IOClientConfig(
            policy=policy_cls(name=policy, threshold=threshold)))
        for f in range(48):
            cli.write_file(f, size_mb=16.0)
            sim.advance_time(0.25)
            for s in range(m):
                cli.log.loads[s] = sim.queued_mb(s)
        out[pkg] = (cli, cli.flush(), sim.clock)
    assert out["port"][1:] == out["ref"][1:]
    _assert_clients_equal(out["ref"][0], out["port"][0])
    with pytest.raises(ValueError):
        tio.SimulatedCluster(m + 1, trace=traces["port"])


def test_sim_client_straggler_avoidance_beats_rr():
    def run(policy):
        sim = tio.SimulatedCluster(10, base_rate_mb_s=100.0, seed=1)
        sim.make_straggler(3, 8.0)
        sim.add_external_load(3, 300.0)
        cli = tio.IOClient(sim, tio.IOClientConfig(policy=TPolicy(
            name=policy, threshold=4.0)))
        cli.log.loads[3] = sim.queued_mb(3)
        for f in range(40):
            cli.write_file(f, size_mb=8.0)
        return cli.flush(), sim.servers[3].n_requests

    t_rr, hits_rr = run("rr")
    t_trh, hits_trh = run("trh")
    assert t_trh < t_rr and hits_trh < hits_rr
