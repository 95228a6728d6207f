"""Deterministic, step-indexed, host-sharded data pipeline.

Counterpart of the JAX package's ``data/pipeline.py``: the same token
stream, delivered as int32 tensors on the card.  ``batch_at(step)`` is a
pure function of ``(seed, step, host)``, so a restarted (or re-sharded /
elastically scaled) job replays the exact token stream with no iterator
state to checkpoint:

* :class:`SyntheticTokens` — counter-based RNG (`np.random.default_rng`
  seeded with ``[seed, example]``), zero I/O.
* :class:`ObjectStoreTokens` — token shards prepared once into the object
  store *through the straggler-aware scheduler* and read back per step via
  the redirect-aware read path.  This is the data-loading face of the
  paper (reads hitting a straggler OSS gate the whole input pipeline).

The rows are drawn on the host by numpy's seeded PCG64, as in the
reference: torch has no PCG64, and a ``torch.Generator`` would give other
tokens.  Batches follow the model ``input_specs`` contract:
``{"tokens": (B_host, S) int32, "targets": (B_host, S) int32}`` where
targets are next-token shifted; padding id 0.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.io.client import IOClient


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.global_batch % self.n_hosts:
            raise ValueError("global_batch must divide evenly over hosts")
        if not (0 <= self.host_id < self.n_hosts):
            raise ValueError("bad host_id")

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.n_hosts


def _example_row(cfg: DataConfig, ex: int) -> np.ndarray:
    """Example ``ex``'s ``seq_len + 1`` tokens in [1, vocab)."""
    rng = np.random.default_rng([cfg.seed, ex])
    return rng.integers(1, cfg.vocab_size, cfg.seq_len + 1, dtype=np.int32)


def _split(rows: torch.Tensor, device) -> Dict[str, torch.Tensor]:
    """Shifted tokens/targets of a (B, S + 1) int32 block, moved to
    ``device`` in one copy (the card unless ``device="cpu"``)."""
    rows = rows.to(resolve_device(device))
    return {"tokens": rows[:, :-1], "targets": rows[:, 1:]}


class SyntheticTokens:
    """Deterministic synthetic LM tokens; exactly resumable at any step."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int, device="cuda") -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        out = np.empty((cfg.host_batch, cfg.seq_len + 1), np.int32)
        for row in range(cfg.host_batch):
            # global example index — independent of host count, so elastic
            # rescaling replays the identical global batch
            ex = step * cfg.global_batch + cfg.host_id * cfg.host_batch + row
            out[row] = _example_row(cfg, ex)
        return _split(torch.from_numpy(out), device)

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class ObjectStoreTokens:
    """Token shards stored as objects; reads scheduled via the log client.

    ``prepare()`` writes ``n_shards`` shard files (each holding
    ``rows_per_shard`` examples) through the straggler-aware scheduler.
    ``batch_at(step)`` gathers the step's rows from the owning shards using
    the redirect-aware read path.
    """

    FILE_BASE = 0x5EED_0000_0000

    def __init__(self, cfg: DataConfig, client: IOClient,
                 rows_per_shard: int = 64):
        self.cfg = cfg
        self.client = client
        self.rows_per_shard = rows_per_shard

    def _row_bytes(self) -> int:
        return (self.cfg.seq_len + 1) * 4

    def _shard_size(self) -> int:
        return self.rows_per_shard * self._row_bytes()

    def n_shards_for(self, n_steps: int) -> int:
        rows = n_steps * self.cfg.global_batch
        return -(-rows // self.rows_per_shard)

    def prepare(self, n_steps: int) -> int:
        """Write the first ``n_steps`` steps' rows into the store."""
        n_shards = self.n_shards_for(n_steps)
        row_b = self._row_bytes()
        for shard in range(n_shards):
            buf = bytearray(self._shard_size())
            for i in range(self.rows_per_shard):
                row = _example_row(self.cfg, shard * self.rows_per_shard + i)
                buf[i * row_b:(i + 1) * row_b] = row.tobytes()
            self.client.write_file(self.FILE_BASE + shard, bytes(buf))
        self.client.flush()
        return n_shards

    def batch_at(self, step: int, device="cuda") -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        row_b = self._row_bytes()
        rows = bytearray(cfg.host_batch * row_b)
        # cache whole shards across the rows of one batch
        cache: Dict[int, bytes] = {}
        for r in range(cfg.host_batch):
            ex = step * cfg.global_batch + cfg.host_id * cfg.host_batch + r
            shard, within = divmod(ex, self.rows_per_shard)
            if shard not in cache:
                cache[shard] = self.client.read_file(
                    self.FILE_BASE + shard, self._shard_size())
            rows[r * row_b:(r + 1) * row_b] = \
                cache[shard][within * row_b:(within + 1) * row_b]
        block = torch.frombuffer(rows, dtype=torch.int32).view(
            cfg.host_batch, cfg.seq_len + 1)
        return _split(block, device)
