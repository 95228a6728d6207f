"""Sharded, atomic, async checkpointing through the paper's I/O scheduler.

Counterpart of the JAX package's ``checkpoint/checkpointer.py``.  Every
checkpoint shard is a "file" handed to :class:`repro_torch.io.IOClient`:
it gets striped into objects, and each object is *scheduled* onto an
object storage server by the log-assisted straggler-aware policy —
checkpointing is exactly the HPC synchronous-write workload the paper
targets (thousands of hosts flushing state behind a barrier, gated by the
slowest OSS).

* **atomic commit** — shards, then manifest, then COMMIT marker; a save
  killed anywhere leaves the previous checkpoint authoritative;
* **async save** — leaves are copied to host memory synchronously (off
  the card, or out of a CPU tensor), bytes written on a background
  thread; ``wait_until_finished()`` is the barrier;
* **failure retry** — a write landing on a failed server is masked +
  re-scheduled by the client (next-best server per the log);
* **restore onto a device** — leaves are reassembled on the host and
  moved to ``device`` (the card by default, or a callable from path to
  device); with a ``target``, a leaf whose target is a tensor lands on
  that tensor's device;
* **GC** — ``keep_n`` newest committed steps are retained.

A leaf is written as its raw bytes under numpy's dtype name
(``"bfloat16"`` for a bfloat16 tensor: its two-byte words, never
upcast), so the bytes and the manifests equal the JAX package's.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Union

import torch

from repro_torch.checkpoint import manifest as M
from repro_torch.device import resolve_device
from repro_torch.io import striping
from repro_torch.io.client import IOClient, IOClientConfig
from repro_torch.io.objectstore import MB, LocalFSStore

# blake2b and file reads release the GIL: a save hashes its shards, and a
# restore reads and verifies them, on this many threads.  A save's writes
# stay in order, one at a time, so every placement is the reference's.
IO_THREADS = min(8, os.cpu_count() or 1)

_DTYPES = {str(d).removeprefix("torch."): d for d in (
    torch.float64, torch.float32, torch.float16, torch.bfloat16,
    torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
    torch.bool, torch.complex64, torch.complex128)}


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype ("float32", "bfloat16", "bool")."""
    name = str(dtype).removeprefix("torch.")
    if name not in _DTYPES:
        raise TypeError(f"no checkpoint dtype for {dtype}")
    return name


def host_copy(leaf) -> torch.Tensor:
    """A leaf as a contiguous tensor on the host, always a copy: taken
    synchronously off the card (a blocking copy, never a
    ``non_blocking`` view a later write could race), or copied out of a
    CPU tensor, so mutating the live tree after `Checkpointer.save`
    cannot reach the snapshot."""
    t = leaf.detach() if isinstance(leaf, torch.Tensor) \
        else torch.as_tensor(leaf)
    return t.to("cpu", copy=True).contiguous()


def leaf_bytes(t: torch.Tensor) -> memoryview:
    """The raw bytes of a contiguous CPU tensor, without a copy."""
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    shard_size_mb: float = 8.0     # split big leaves into this many MB
    keep_n: int = 3
    async_save: bool = False
    io: IOClientConfig = IOClientConfig()


class Checkpointer:
    """Save/restore trees of tensors against an object store via the
    scheduler."""

    def __init__(self, root: str, n_servers: int = 16,
                 cfg: CheckpointConfig = CheckpointConfig(),
                 store=None, seed: int = 0):
        self.root = root
        self.manifest_dir = os.path.join(root, "manifests")
        self.store = store if store is not None else LocalFSStore(
            os.path.join(root, "objects"), n_servers)
        self.cfg = cfg
        self.client = IOClient(self.store, cfg.io, seed=seed)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def _shard_bytes(self, buf) -> List:
        step_len = max(int(self.cfg.shard_size_mb * MB), 1 * MB)
        return [buf[i:i + step_len]
                for i in range(0, max(len(buf), 1), step_len)]

    def _write_tree(self, step: int, named_leaves, meta: Dict[str, Any]
                    ) -> None:
        leaves_meta: List[M.LeafEntry] = []
        with ThreadPoolExecutor(IO_THREADS) as pool:
            for li, (path, t) in enumerate(named_leaves):
                buf = leaf_bytes(t)
                chunks = self._shard_bytes(buf)
                sums = pool.map(M.checksum, chunks)   # hashed ahead
                shards: List[M.ShardEntry] = []
                pos = 0
                for si, (chunk, digest) in enumerate(zip(chunks, sums)):
                    fid = M.file_id_for(step, li, si)
                    self.client.write_file(fid, chunk if chunk else b"\x00")
                    shards.append(M.ShardEntry(
                        file_id=fid, byte_start=pos, byte_len=len(chunk),
                        checksum=digest))
                    pos += len(chunk)
                leaves_meta.append(M.LeafEntry(
                    path=path, shape=tuple(t.shape),
                    dtype=dtype_name(t.dtype), nbytes=len(buf),
                    shards=shards))
        self.client.flush()
        man = M.Manifest(step=step, leaves=leaves_meta, meta=meta)
        M.write_manifest(self.manifest_dir, man)
        M.commit(self.manifest_dir, step)
        self._gc()

    def save(self, step: int, tree, meta: Optional[Dict[str, Any]] = None,
             block: Optional[bool] = None) -> None:
        """Checkpoint ``tree`` at ``step``.  ``block=False`` (or
        ``cfg.async_save``) returns after the host snapshot; the bytes are
        written on a background thread."""
        self.wait_until_finished()
        meta = dict(meta or {})
        meta.setdefault("step", step)
        # snapshot to host memory synchronously (consistency point)
        named = [(p, host_copy(a)) for p, a in M.flatten_with_paths(tree)]
        asynchronous = self.cfg.async_save if block is None else not block
        if not asynchronous:
            self._write_tree(step, named, meta)
            return

        def run():
            try:
                self._write_tree(step, named, meta)
            except BaseException as e:  # surfaced at the next barrier
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait_until_finished(self) -> None:
        """Async-save barrier; re-raises any background failure."""
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = M.committed_steps(self.manifest_dir)
        for s in steps[:-self.cfg.keep_n] if self.cfg.keep_n > 0 else []:
            man = M.load_manifest(self.manifest_dir, s)
            M.remove_step(self.manifest_dir, s)
            for leaf in man.leaves:
                for sh in leaf.shards:
                    for req in self._stripe(sh):
                        try:
                            self.store.delete_object(req.object_id)
                        except Exception:
                            pass

    def _stripe(self, sh: M.ShardEntry):
        return striping.stripe_file(self.client.striping, sh.file_id,
                                    max(sh.byte_len, 1))

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = M.committed_steps(self.manifest_dir)
        return steps[-1] if steps else None

    def read_leaf(self, leaf: M.LeafEntry, strict_checksum: bool = True,
                  pool: Optional[ThreadPoolExecutor] = None) -> torch.Tensor:
        """One manifest leaf reassembled on the host from its shards,
        each shard's checksum verified (on ``pool``'s threads, if given)."""
        buf = bytearray(leaf.nbytes)
        view = memoryview(buf)

        def fetch(sh: M.ShardEntry) -> None:
            part = view[sh.byte_start:sh.byte_start + sh.byte_len]
            if sh.byte_len:
                self.client.read_file_into(sh.file_id, part)
            else:  # an empty leaf's shard holds one placeholder byte
                self.client.read_file(sh.file_id, 1)
            if strict_checksum and M.checksum(part) != sh.checksum:
                raise IOError(f"checksum mismatch for {leaf.path} "
                              f"shard {sh.file_id:#x}")

        list((pool.map if pool is not None else map)(fetch, leaf.shards))
        dtype = _DTYPES[leaf.dtype]
        if not buf:
            return torch.empty(leaf.shape, dtype=dtype)
        return torch.frombuffer(buf, dtype=torch.uint8).view(dtype).reshape(
            leaf.shape)

    def restore(self, step: Optional[int] = None, target=None,
                device: Union[None, str, torch.device,
                              Callable[[str], Any]] = None,
                strict_checksum: bool = True):
        """Restore a checkpoint.

        * ``target`` — a tree giving the structure to restore onto (an
          ``nn.Module``'s place gets its ``state_dict``).  With no
          target, returns ``{path: tensor}``.
        * ``device`` — where the leaves land: a device, or a callable
          ``path -> device``.  Left as None, a leaf whose target is a
          tensor keeps that tensor's device, and every other leaf goes
          to the card (`resolve_device` raises without one; pass
          ``device="cpu"`` to stay on the host).
        """
        self.wait_until_finished()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no committed checkpoint in {self.root}")
        man = M.load_manifest(self.manifest_dir, step)
        own = {}
        if target is not None:
            own = {p: t.device for p, t in M.flatten_with_paths(target)
                   if isinstance(t, torch.Tensor)}
        named: Dict[str, torch.Tensor] = {}
        with ThreadPoolExecutor(IO_THREADS) as pool:
            for leaf in man.leaves:
                if callable(device):
                    dev = device(leaf.path)
                elif device is None and leaf.path in own:
                    dev = own[leaf.path]
                else:
                    dev = "cuda" if device is None else device
                named[leaf.path] = self.read_leaf(
                    leaf, strict_checksum, pool).to(resolve_device(dev))
        if target is None:
            return named
        return M.unflatten_like(target, named)

    def manifest(self, step: int) -> M.Manifest:
        return M.load_manifest(self.manifest_dir, step)

    def close(self) -> None:
        self.wait_until_finished()
        self.client.close()
