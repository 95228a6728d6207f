"""Client-side I/O scheduler client (paper Fig. 5, left box).

Counterpart of the JAX package's ``io/client.py``.  ``IOClient`` is the
thing that runs on a compute node: it holds the client-side server
statistic log (:class:`~repro_torch.core.statlog.HostStatLog` — the
packed ``(4, M)`` log tensor, the SAME layout the engine carries and the
stream kernel keeps in shared memory, here in float64 on the CPU), a
scheduling policy (:class:`~repro_torch.core.policies.HostScheduler`),
and a handle to the object store.  Every file write is striped into
objects, scheduled as one *time window* through the log (zero probe
messages for the log-assisted policies), written — possibly redirected
away from the default home, recorded in the home's redirect table — and
observed back into the log: completion rates feed the ``ewma_lat`` /
``est_rates`` rows, the ONLY channel through which the client learns
about server speed (the stale-view contract, DESIGN.md §8).  ECT here
therefore ranks servers by the same client-estimated latency numbers as
the engine and the kernel backend.

Fault tolerance: a write that hits a failed server masks that server in the
scheduler and retries on the next-best target (up to ``max_retries``), which
is exactly the behaviour the checkpoint layer leans on at scale.  Optional
``replication`` writes each object to N distinct servers.

Works against both backends:

* :class:`~repro_torch.io.objectstore.LocalFSStore` — payloads are real
  ``bytes`` (or any bytes-like object, such as a ``memoryview``);
* :class:`~repro_torch.io.objectstore.SimulatedCluster` — payloads are MB floats
  (pass ``data_mb=`` instead of ``data=``).
"""

from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional

import torch

from repro_torch.core.policies import HostScheduler, PolicyConfig
from repro_torch.core.statlog import HostStatLog, LogConfig
from repro_torch.io import striping
from repro_torch.io.objectstore import (MB, ObjectMissingError,
                                        ServerFailedError, WriteResult)


@dataclasses.dataclass
class WriteRecord:
    object_id: int
    stripe_index: int
    server: int
    mb: float
    seconds: float
    redirected: bool
    retries: int
    replicas: List[int]


@dataclasses.dataclass(frozen=True)
class IOClientConfig:
    policy: PolicyConfig = PolicyConfig(name="trh", threshold=4.0)
    lam_mb: float = 32.0
    stripe_size: int = 4 * MB
    max_retries: int = 3
    replication: int = 1
    async_writers: int = 0          # 0 = synchronous writes
    observe_completions: bool = True
    drain_on_complete: bool = True  # drain log load when a write finishes
    # Recompute p_i ∝ e^{-l_i/λ} from CURRENT loads at each window start
    # instead of relying only on Eq. (2)'s incremental decay.  The paper's
    # repeated multiplicative decay makes the probability RANKING drift
    # from the load ranking over long runs (found in §Perf hillclimb C);
    # the memoryless refresh keeps the same exponential law. Beyond-paper.
    refresh_probs: bool = False


class IOClient:
    def __init__(self, store, cfg: IOClientConfig = IOClientConfig(),
                 seed: int = 0):
        self.store = store
        self.cfg = cfg
        self.log = HostStatLog(LogConfig(n_servers=store.n_servers,
                                         lam=cfg.lam_mb))
        self.sched = HostScheduler(cfg.policy, self.log, seed=seed)
        self.striping = striping.StripingConfig(stripe_size=cfg.stripe_size)
        self._lock = threading.RLock()
        self._pool = (ThreadPoolExecutor(max_workers=cfg.async_writers)
                      if cfg.async_writers > 0 else None)
        self._pending: List[Future] = []
        self.records: List[WriteRecord] = []
        self.failed_writes = 0

    # ------------------------------------------------------------------ utils
    @property
    def n_servers(self) -> int:
        return self.store.n_servers

    @property
    def probe_messages(self) -> int:
        return self.sched.probe_messages

    def _is_sim(self) -> bool:
        return hasattr(self.store, "clock")

    def _alive_min_load(self) -> int:
        masked = self.sched.masked_servers
        alive = [s for s in range(self.n_servers) if s not in masked]
        if not alive:
            raise ServerFailedError("all servers masked")
        loads = self.log.loads.tolist()
        return min(alive, key=loads.__getitem__)

    # ------------------------------------------------------------- write path
    def _write_one(self, req: striping.ObjectRequest,
                   payload, server: int) -> WriteRecord:
        """Write one object (with retry-on-failure), update the log."""
        mb = req.length / MB if isinstance(payload, (bytes, bytearray, memoryview)) \
            else float(payload)
        retries = 0
        replicas: List[int] = []
        current = server
        while True:
            try:
                res: WriteResult = self.store.write_object(
                    req.object_id, payload, current)
                break
            except ServerFailedError:
                with self._lock:
                    self.failed_writes += 1
                    self.sched.mask_server(current)
                    # undo the load we booked on the dead server, then pick
                    # the next-best target from the live log.
                    self.log.complete(current, mb)
                    retries += 1
                    if retries > self.cfg.max_retries:
                        raise
                    current = self._alive_min_load()
                    self.log.apply_assignment(current, mb)
        with self._lock:
            if self.cfg.observe_completions:
                self.log.observe_completion(res.server, res.mb_per_s)
            if self.cfg.drain_on_complete and not self._is_sim():
                self.log.complete(res.server, mb)
        replicas.append(res.server)
        # extra replicas on distinct servers (fault tolerance at scale)
        for _ in range(self.cfg.replication - 1):
            with self._lock:
                masked = set(self.sched.masked_servers) | set(replicas)
                alive = [s for s in range(self.n_servers) if s not in masked]
                if not alive:
                    break
                loads = self.log.loads.tolist()
                rep = min(alive, key=loads.__getitem__)
                self.log.apply_assignment(rep, mb)
            try:
                rres = self.store.write_object(req.object_id, payload, rep)
                replicas.append(rres.server)
            except ServerFailedError:
                with self._lock:
                    self.sched.mask_server(rep)
                    self.log.complete(rep, mb)
        home = req.object_id % self.n_servers
        rec = WriteRecord(object_id=req.object_id,
                          stripe_index=req.stripe_index,
                          server=res.server, mb=mb, seconds=res.seconds,
                          redirected=res.server != home, retries=retries,
                          replicas=replicas)
        with self._lock:
            self.records.append(rec)
        return rec

    def write_file(self, file_id: int, data=None, *,
                   size_mb: Optional[float] = None) -> List[WriteRecord]:
        """Stripe + schedule + write one file (one time window).

        ``data`` for real stores; ``size_mb`` for the simulated cluster.
        """
        if (data is None) == (size_mb is None):
            raise ValueError("pass exactly one of data / size_mb")
        size = len(data) if data is not None else int(size_mb * MB)
        reqs = striping.stripe_file(self.striping, file_id, max(size, 1))
        with self._lock:
            if self.cfg.refresh_probs:
                self.log.absorb_loads()
            self.sched.begin_window([r.length / MB for r in reqs])
            planned = []
            for r in reqs:
                server = self.sched.schedule(r.object_id, r.length / MB,
                                             offset=r.offset)
                planned.append((r, server))
        out: List[WriteRecord] = []
        futures: List[Future] = []
        for r, server in planned:
            payload = (data[r.file_offset:r.file_offset + r.length]
                       if data is not None else r.length / MB)
            if self._pool is not None:
                futures.append(self._pool.submit(self._write_one, r, payload,
                                                 server))
            else:
                out.append(self._write_one(r, payload, server))
        if futures:
            self._pending.extend(futures)
            out.extend(f.result() for f in futures)
        return out

    def write_file_async(self, file_id: int, data) -> List[Future]:
        """Schedule now, write in background; ``flush()`` is the barrier."""
        if self._pool is None:
            raise RuntimeError("configure async_writers > 0")
        reqs = striping.stripe_file(self.striping, file_id, max(len(data), 1))
        with self._lock:
            if self.cfg.refresh_probs:
                self.log.absorb_loads()
            self.sched.begin_window([r.length / MB for r in reqs])
            planned = [(r, self.sched.schedule(r.object_id, r.length / MB,
                                               offset=r.offset)) for r in reqs]
        futs = []
        for r, server in planned:
            payload = data[r.file_offset:r.file_offset + r.length]
            futs.append(self._pool.submit(self._write_one, r, payload, server))
        self._pending.extend(futs)
        return futs

    def flush(self) -> float:
        """Barrier: wait for async writes; advance the sim clock if any.
        Returns the sim phase time (0.0 for real stores)."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()
        if self._is_sim():
            phase = self.store.barrier()
            # phase end: outstanding queues drained -> forget booked loads
            for s in range(self.n_servers):
                self.log.loads[s] = self.store.queued_mb(s)
            return phase
        return 0.0

    # -------------------------------------------------------------- read path
    def read_file(self, file_id: int, size: int) -> bytes:
        """Read via default home -> redirect table -> replica scan."""
        buf = bytearray(size)
        self.read_file_into(file_id, memoryview(buf))
        return bytes(buf)

    def read_file_into(self, file_id: int, out: memoryview) -> None:
        """`read_file` of ``len(out)`` bytes into the writable buffer
        ``out``, one copy an object (the checkpoint restore's path)."""
        reqs = striping.stripe_file(self.striping, file_id, len(out))
        for r in reqs:
            data = self.store.read_object(r.object_id)
            if len(data) < r.offset + r.length:
                raise ObjectMissingError(
                    f"object {r.object_id:#x} truncated: "
                    f"{len(data)} < {r.offset + r.length}")
            out[r.file_offset:r.file_offset + r.length] = \
                memoryview(data)[r.offset:r.offset + r.length]

    def read_file_sim(self, file_id: int, size_mb: float) -> float:
        """Simulated read of a whole file; returns total MB touched."""
        reqs = striping.stripe_file(self.striping, file_id, int(size_mb * MB))
        total = 0.0
        for r in reqs:
            mb, _, _ = self.store.read_object(r.object_id)
            total += mb
        return total

    def close(self) -> None:
        if self._pool is not None:
            self.flush()
            self._pool.shutdown(wait=True)

    # ----------------------------------------------------------------- stats
    @property
    def log_table(self) -> torch.Tensor:
        """Snapshot of the packed (4, M) log tensor (loads / probs /
        ewma_lat / est_rates) — the client's whole scheduling state."""
        return self.log.table.clone()

    def stats(self) -> Dict[str, float]:
        if not self.records:
            return {"writes": 0}
        f64 = torch.float64
        mbs = torch.tensor([r.mb for r in self.records], dtype=f64)
        secs = torch.tensor([r.seconds for r in self.records], dtype=f64)
        redirected = torch.tensor([r.redirected for r in self.records],
                                  dtype=f64)
        est = self.log.est_rates
        return {
            "writes": len(self.records),
            "total_mb": mbs.sum().item(),
            "redirect_rate": redirected.mean().item(),
            "mean_write_mb_s": (mbs / secs).mean().item(),
            "p50_write_s": torch.quantile(secs, 0.5).item(),
            "p99_write_s": torch.quantile(secs, 0.99).item(),
            "probe_messages": float(self.probe_messages),
            "retries": float(sum(r.retries for r in self.records)),
            "failed_writes": float(self.failed_writes),
            # stale-view summary: the client's own rate estimates
            "est_rate_min_mb_s": est.min().item(),
            "est_rate_max_mb_s": est.max().item(),
            "est_slowest_server": int(torch.argmin(est)),
        }
