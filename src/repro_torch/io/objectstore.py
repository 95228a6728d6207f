"""Object storage substrates: simulated OSS cluster + local-FS store.

Counterpart of the JAX package's ``io/objectstore.py``.  A
`LocalFSStore` keeps the same directory layout, ``.bin`` files and
``_redirect.json`` format, so a store written by either package reads in
the other.

Implements the server-side components of the paper's architecture (§3.1):

* **redirect table** — one per object storage server; remembers, for every
  object whose default home is this server, where its bytes actually live
  after a straggler-avoiding redirect (Fig. 6).
* **metadata maintainer** — migrates redirected objects back to their
  default home when the system is idle, deleting the redirect entry, so
  later reads go straight to the default server.

Two backends share that machinery:

* :class:`SimulatedCluster` — a virtual-clock queueing model (one FIFO
  queue per server, configurable service rate) used for latency /
  throughput evaluation of the scheduling policies, with straggler
  injection (slow-rate and extra-load) and fail/heal APIs.
* :class:`LocalFSStore` — a real-bytes store (one directory per server)
  used by the checkpoint layer end-to-end; stragglers are emulated with a
  per-server write delay, failures with a marker file.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.io.striping import MB


class ServerFailedError(RuntimeError):
    """The targeted object storage server is down."""


class ObjectMissingError(KeyError):
    """No server holds the requested object."""


@dataclasses.dataclass
class WriteResult:
    server: int
    mb: float
    issued_at: float
    finished_at: float

    @property
    def seconds(self) -> float:
        return max(self.finished_at - self.issued_at, 1e-9)

    @property
    def mb_per_s(self) -> float:
        return self.mb / self.seconds


class RedirectTable:
    """Per-server object_id -> actual_server map (paper Fig. 6)."""

    def __init__(self):
        self._entries: Dict[int, int] = {}
        self._lock = threading.Lock()

    def set(self, object_id: int, actual_server: int) -> None:
        with self._lock:
            self._entries[object_id] = actual_server

    def get(self, object_id: int) -> Optional[int]:
        with self._lock:
            return self._entries.get(object_id)

    def pop(self, object_id: int) -> Optional[int]:
        with self._lock:
            return self._entries.pop(object_id, None)

    def items(self) -> List[Tuple[int, int]]:
        with self._lock:
            return list(self._entries.items())

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# ---------------------------------------------------------------------------
# Simulated cluster (virtual clock, queueing model)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _SimServer:
    rate_mb_s: float
    free_at: float = 0.0
    pending_mb: float = 0.0
    total_written_mb: float = 0.0
    n_requests: int = 0
    failed: bool = False


class SimulatedCluster:
    """M object storage servers with FIFO queues on a shared virtual clock.

    The client issues writes at the current clock; each lands at the tail
    of its server's queue: ``finish = max(clock, free_at) + mb / rate``.
    ``barrier()`` implements the HPC synchronous I/O-phase semantics — it
    returns the phase's completion time (the max across servers touched
    since the last barrier) and advances the clock there.
    """

    def __init__(self, n_servers: int, base_rate_mb_s: float = 200.0,
                 rate_jitter: float = 0.0, seed: int = 0, trace=None):
        # numpy's seeded PCG64, as in the reference: torch has no PCG64,
        # and another generator would jitter the rates differently
        rng = np.random.default_rng(seed)
        self.n_servers = n_servers
        self.clock = 0.0
        self.servers = [
            _SimServer(rate_mb_s=float(
                base_rate_mb_s * (1.0 + rate_jitter * rng.standard_normal())))
            for _ in range(n_servers)
        ]
        for s in self.servers:
            s.rate_mb_s = max(s.rate_mb_s, 1e-3)
        self.redirects = [RedirectTable() for _ in range(n_servers)]
        self._locations: Dict[int, int] = {}      # object -> server actually holding it
        self._sizes: Dict[int, float] = {}        # object -> MB
        self._phase_finish = 0.0
        self._phase_touched: set = set()          # servers serving this phase
        self.migrated_objects = 0
        # Optional rate-event schedule: the SAME ClusterTrace the engine
        # consumes (repro_torch.core.engine.ClusterTrace, or anything with
        # .times (E,) / .rates (E, M)), so host-path and engine results
        # are comparable on identical scenarios.  Its tensors may lie on
        # the card: they are copied to the host as float64 once, here.
        # Events apply as the clock passes them (advance_time / barrier).
        self._trace_times = self._trace_rates = None
        self._next_event = 0
        if trace is not None:
            times = torch.as_tensor(trace.times).to("cpu", torch.float64)
            rates = torch.as_tensor(trace.rates).to("cpu", torch.float64)
            if tuple(rates.shape) != (len(times), n_servers):
                raise ValueError("trace.rates must be (n_events, n_servers)")
            self._trace_times = times.tolist()
            self._trace_rates = rates.tolist()
            self._apply_trace_events(0.0)

    # -- straggler / failure injection --------------------------------------
    def set_rate(self, server: int, rate_mb_s: float) -> None:
        """Change a server's service rate, preserving its queued WORK:
        bytes still pending keep their volume, their drain time rescales."""
        s = self.servers[server]
        remaining_mb = max(s.free_at - self.clock, 0.0) * s.rate_mb_s
        s.rate_mb_s = max(rate_mb_s, 1e-3)
        s.free_at = self.clock + remaining_mb / s.rate_mb_s
        if server in self._phase_touched:
            # re-derive: a slowdown extends the phase, a recovery SHORTENS
            # it (the raise-only update would leave a stale-high finish)
            self._phase_finish = self._projected_finish()

    def _apply_trace_events(self, up_to: float) -> None:
        """Apply all trace rate events with time <= ``up_to`` (in order,
        advancing the clock to each event so queues rescale correctly)."""
        if self._trace_times is None:
            return
        while (self._next_event < len(self._trace_times)
               and self._trace_times[self._next_event] <= up_to):
            ev_t = float(self._trace_times[self._next_event])
            self.clock = max(self.clock, ev_t)
            for srv, rate in enumerate(self._trace_rates[self._next_event]):
                self.set_rate(srv, float(rate))
            self._next_event += 1

    def advance_time(self, dt: float) -> float:
        """Temporal model: move the virtual clock forward ``dt`` seconds
        (queues drain implicitly — ``free_at`` is absolute), applying any
        trace rate events passed on the way.  Returns the new clock."""
        target = self.clock + max(dt, 0.0)
        self._apply_trace_events(target)
        self.clock = max(self.clock, target)
        self._phase_finish = max(self._phase_finish, self.clock)
        return self.clock

    def make_straggler(self, server: int, slow_factor: float = 5.0) -> None:
        """Slow-rate straggler: service rate divided by ``slow_factor``
        (queue-preserving: already-queued bytes rescale like set_rate)."""
        self.set_rate(server, self.servers[server].rate_mb_s / slow_factor)

    def add_external_load(self, server: int, mb: float) -> None:
        """Busy straggler: queue ``mb`` of foreign bytes on the server.

        Foreign work delays OUR requests behind it but is not part of our
        phase — the barrier only waits for requests we issued (Fig. 1
        semantics)."""
        s = self.servers[server]
        s.free_at = max(s.free_at, self.clock) + mb / s.rate_mb_s
        s.pending_mb += mb

    def fail_server(self, server: int) -> None:
        self.servers[server].failed = True

    def heal_server(self, server: int) -> None:
        self.servers[server].failed = False

    # -- log-visible state ---------------------------------------------------
    def queued_mb(self, server: int) -> float:
        """What a probing client would learn (used by two_choice baseline)."""
        s = self.servers[server]
        return max(s.free_at - self.clock, 0.0) * s.rate_mb_s

    def default_home(self, object_id: int) -> int:
        return object_id % self.n_servers

    def locate(self, object_id: int) -> int:
        """Default home, then its redirect table (read path, Fig. 6)."""
        if object_id in self._locations:
            return self._locations[object_id]
        raise ObjectMissingError(object_id)

    # -- data path -----------------------------------------------------------
    def write_object(self, object_id: int, mb: float, server: int) -> WriteResult:
        s = self.servers[server]
        if s.failed:
            raise ServerFailedError(f"server {server} is down")
        start = max(self.clock, s.free_at)
        finish = start + mb / s.rate_mb_s
        s.free_at = finish
        s.pending_mb += mb
        s.total_written_mb += mb
        s.n_requests += 1
        self._phase_finish = max(self._phase_finish, finish)
        self._phase_touched.add(server)
        home = self.default_home(object_id)
        prev = self._locations.get(object_id)
        self._locations[object_id] = server
        self._sizes[object_id] = mb
        if server != home:
            self.redirects[home].set(object_id, server)
        elif prev is not None and prev != home:
            self.redirects[home].pop(object_id)
        return WriteResult(server=server, mb=mb, issued_at=self.clock,
                           finished_at=finish)

    def read_object(self, object_id: int) -> Tuple[float, int, WriteResult]:
        server = self.locate(object_id)
        s = self.servers[server]
        if s.failed:
            raise ServerFailedError(f"server {server} is down")
        mb = self._sizes[object_id]
        start = max(self.clock, s.free_at)
        finish = start + mb / s.rate_mb_s
        s.free_at = finish
        s.n_requests += 1
        self._phase_finish = max(self._phase_finish, finish)
        self._phase_touched.add(server)
        return mb, server, WriteResult(server=server, mb=mb,
                                       issued_at=self.clock, finished_at=finish)

    def _projected_finish(self) -> float:
        """Latest completion among servers serving this phase's requests."""
        touched = [self.servers[i].free_at for i in self._phase_touched]
        return max(max(touched), self.clock) if touched else self.clock

    def barrier(self) -> float:
        """Synchronous I/O-phase end: advance the clock to the slowest
        server's finish (the paper's Fig. 1 semantics). Returns phase time.

        With a trace, rate events firing BEFORE the projected finish are
        stepped through in order (queues rescale at each event), so a
        mid-phase slowdown extends the phase exactly as the jitted engine
        models it — not just the next phase's rates."""
        t0 = self.clock
        if self._trace_times is not None:
            while self._next_event < len(self._trace_times):
                ev_t = float(self._trace_times[self._next_event])
                if ev_t > self._projected_finish():
                    break
                self.clock = max(self.clock, ev_t)
                for srv, rate in enumerate(self._trace_rates[self._next_event]):
                    self.set_rate(srv, float(rate))
                self._next_event += 1
            self._phase_finish = self._projected_finish()
        phase = max(self._phase_finish - t0, 0.0)
        self.clock = max(self.clock, self._phase_finish)
        for s in self.servers:
            if s.free_at <= self.clock:
                s.pending_mb = 0.0
        self._phase_finish = self.clock
        self._phase_touched.clear()
        return phase

    # -- metadata maintainer (§3.1) -------------------------------------------
    def maintainer_tick(self, max_objects: int = 16) -> int:
        """Migrate up to ``max_objects`` redirected objects back to their
        default homes, if both ends are idle.  Returns #migrated."""
        moved = 0
        for home, table in enumerate(self.redirects):
            if moved >= max_objects:
                break
            if self.servers[home].failed or self.servers[home].free_at > self.clock:
                continue
            for object_id, actual in table.items():
                if moved >= max_objects:
                    break
                src = self.servers[actual]
                if src.failed or src.free_at > self.clock:
                    continue
                mb = self._sizes.get(object_id, 0.0)
                # read at actual + write at home
                src.free_at = max(src.free_at, self.clock) + mb / src.rate_mb_s
                dst = self.servers[home]
                dst.free_at = max(dst.free_at, self.clock) + mb / dst.rate_mb_s
                self._locations[object_id] = home
                table.pop(object_id)
                self.migrated_objects += 1
                moved += 1
        return moved

    def stats(self) -> Dict[str, float]:
        written = torch.tensor([s.total_written_mb for s in self.servers],
                               dtype=torch.float64)
        mean = written.mean().item()
        return {
            "clock_s": self.clock,
            "max_written_mb": written.max().item(),
            "cv_written": (written.std(correction=0).item() / mean
                           if mean else 0.0),
            "redirect_entries": float(sum(len(t) for t in self.redirects)),
            "migrated": float(self.migrated_objects),
        }


# ---------------------------------------------------------------------------
# Local-FS store (real bytes; used by repro_torch.checkpoint end-to-end)
# ---------------------------------------------------------------------------


class LocalFSStore:
    """Object store backed by one directory per server.

    Layout::

        root/server_003/obj_<hex16>.bin     object bytes
        root/server_003/_redirect.json      that server's redirect table
        root/server_003/_FAILED             failure marker (injection)

    Stragglers are emulated with a per-server ``delay_s_per_mb`` (sleep on
    write/read), so tests exercise the ECT policy's rate observations with
    real wall-clock signal.
    """

    def __init__(self, root: str, n_servers: int):
        self.root = root
        self.n_servers = n_servers
        self._delay: Dict[int, float] = {}
        self._lock = threading.Lock()
        for srv in range(n_servers):
            os.makedirs(self._srv_dir(srv), exist_ok=True)

    # -- paths ----------------------------------------------------------------
    def _srv_dir(self, server: int) -> str:
        return os.path.join(self.root, f"server_{server:04d}")

    def _obj_path(self, server: int, object_id: int) -> str:
        return os.path.join(self._srv_dir(server), f"obj_{object_id:016x}.bin")

    def _redir_path(self, server: int) -> str:
        return os.path.join(self._srv_dir(server), "_redirect.json")

    # -- failure / straggler injection -----------------------------------------
    def fail_server(self, server: int) -> None:
        with open(os.path.join(self._srv_dir(server), "_FAILED"), "w"):
            pass

    def heal_server(self, server: int) -> None:
        try:
            os.remove(os.path.join(self._srv_dir(server), "_FAILED"))
        except FileNotFoundError:
            pass

    def is_failed(self, server: int) -> bool:
        return os.path.exists(os.path.join(self._srv_dir(server), "_FAILED"))

    def set_write_delay(self, server: int, delay_s_per_mb: float) -> None:
        self._delay[server] = delay_s_per_mb

    # -- redirect table ---------------------------------------------------------
    def _load_redir(self, server: int) -> Dict[str, int]:
        try:
            with open(self._redir_path(server)) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return {}

    def _save_redir(self, server: int, table: Dict[str, int]) -> None:
        tmp = self._redir_path(server) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(table, f)
        os.replace(tmp, self._redir_path(server))

    def set_redirect(self, home: int, object_id: int, actual: int) -> None:
        with self._lock:
            t = self._load_redir(home)
            t[str(object_id)] = actual
            self._save_redir(home, t)

    def get_redirect(self, home: int, object_id: int) -> Optional[int]:
        with self._lock:
            return self._load_redir(home).get(str(object_id))

    def pop_redirect(self, home: int, object_id: int) -> None:
        with self._lock:
            t = self._load_redir(home)
            if t.pop(str(object_id), None) is not None:
                self._save_redir(home, t)

    def redirect_count(self) -> int:
        with self._lock:
            return sum(len(self._load_redir(s)) for s in range(self.n_servers))

    # -- data path ----------------------------------------------------------------
    def default_home(self, object_id: int) -> int:
        return object_id % self.n_servers

    def write_object(self, object_id: int, data: bytes, server: int) -> WriteResult:
        if self.is_failed(server):
            raise ServerFailedError(f"server {server} is down")
        t0 = time.monotonic()
        mb = len(data) / MB
        delay = self._delay.get(server, 0.0)
        if delay:
            time.sleep(delay * max(mb, 0.001))
        tmp = self._obj_path(server, object_id) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, self._obj_path(server, object_id))
        home = self.default_home(object_id)
        if server != home:
            self.set_redirect(home, object_id, server)
        else:
            self.pop_redirect(home, object_id)
        return WriteResult(server=server, mb=mb, issued_at=t0,
                           finished_at=time.monotonic())

    def locate(self, object_id: int) -> int:
        """Default home -> redirect entry -> replica scan; failed servers
        are skipped so reads fall through to a surviving copy."""
        home = self.default_home(object_id)
        if not self.is_failed(home) and \
                os.path.exists(self._obj_path(home, object_id)):
            return home
        redir = self.get_redirect(home, object_id) \
            if not self.is_failed(home) else None
        if redir is not None and not self.is_failed(redir) and \
                os.path.exists(self._obj_path(redir, object_id)):
            return redir
        # scan as last resort (failed home / replica reads)
        for srv in range(self.n_servers):
            if not self.is_failed(srv) and \
                    os.path.exists(self._obj_path(srv, object_id)):
                return srv
        raise ObjectMissingError(object_id)

    def read_object(self, object_id: int, server: Optional[int] = None) -> bytes:
        server = self.locate(object_id) if server is None else server
        if self.is_failed(server):
            raise ServerFailedError(f"server {server} is down")
        delay = self._delay.get(server, 0.0)
        path = self._obj_path(server, object_id)
        with open(path, "rb") as f:
            data = f.read()
        if delay:
            time.sleep(delay * max(len(data) / MB, 0.001))
        return data

    def delete_object(self, object_id: int) -> None:
        for srv in range(self.n_servers):
            try:
                os.remove(self._obj_path(srv, object_id))
            except FileNotFoundError:
                pass
        self.pop_redirect(self.default_home(object_id), object_id)

    # -- metadata maintainer ---------------------------------------------------------
    def maintainer_tick(self, max_objects: int = 16) -> int:
        """Move redirected objects home and drop their entries (§3.1)."""
        moved = 0
        for home in range(self.n_servers):
            if self.is_failed(home):
                continue
            for oid_s, actual in list(self._load_redir(home).items()):
                if moved >= max_objects:
                    return moved
                oid = int(oid_s)
                if self.is_failed(actual):
                    continue
                try:
                    data = self.read_object(oid, actual)
                except (FileNotFoundError, ObjectMissingError):
                    self.pop_redirect(home, oid)
                    continue
                self.write_object(oid, data, home)
                try:
                    os.remove(self._obj_path(actual, oid))
                except FileNotFoundError:
                    pass
                moved += 1
        return moved


class MaintainerThread(threading.Thread):
    """Background metadata maintainer (§3.1's 'runs when idle' thread)."""

    def __init__(self, store, interval_s: float = 0.05, max_objects: int = 16):
        super().__init__(daemon=True)
        self.store = store
        self.interval_s = interval_s
        self.max_objects = max_objects
        # NB: must not be named _stop — threading.Thread.join() calls the
        # private Thread._stop() internally on CPython >= 3.10.
        self._stop_evt = threading.Event()
        self.total_moved = 0

    def run(self) -> None:
        while not self._stop_evt.is_set():
            try:
                self.total_moved += self.store.maintainer_tick(self.max_objects)
            except Exception:  # pragma: no cover - never kill the daemon
                pass
            self._stop_evt.wait(self.interval_s)

    def stop(self) -> None:
        self._stop_evt.set()
        self.join(timeout=5.0)
