"""File → object striping (paper §2.1, Fig. 3).

Counterpart of the JAX package's ``io/striping.py``, in plain Python:
object ids are bit-equal with it, because they decide an object's
default home ``object_id mod M``.

Object-based parallel file systems split each file into fixed-size objects
distributed over object storage servers.  An I/O request that crosses an
object boundary is split into per-object sub-requests, each scheduled
independently (Fig. 3's ``I/O_2`` example).

Object IDs are derived from ``(file_id, stripe_index)`` with a mixing hash
so that the default round-robin home ``object_id mod M`` spreads files
evenly (a linear id scheme would alias every file's stripe k onto the same
server for M | stripe_count).
"""

from __future__ import annotations

import dataclasses
from typing import List

MB = 1024 * 1024


def _mix64(x: int) -> int:
    """SplitMix64 finalizer — cheap, stable across runs/processes."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (x ^ (x >> 31)) & 0x7FFFFFFFFFFFFFFF  # keep it positive int63


def object_id_for(file_id: int, stripe_index: int) -> int:
    return _mix64((file_id << 20) ^ stripe_index)


@dataclasses.dataclass(frozen=True)
class ObjectRequest:
    """One scheduled unit: a contiguous byte range of one object (Fig. 8's
    I/O request table row: object id, offset, length)."""

    object_id: int
    offset: int          # bytes from the object's start
    length: int          # bytes
    file_id: int = -1
    stripe_index: int = -1
    file_offset: int = 0  # where these bytes live in the file

    @property
    def length_mb(self) -> float:
        return self.length / MB


@dataclasses.dataclass(frozen=True)
class StripingConfig:
    stripe_size: int = 4 * MB   # object size in bytes (Lustre-like default)

    def __post_init__(self):
        if self.stripe_size <= 0:
            raise ValueError("stripe_size must be positive")


def stripe_request(cfg: StripingConfig, file_id: int, offset: int,
                   length: int) -> List[ObjectRequest]:
    """Split a file-level (offset, length) request into object sub-requests."""
    if length < 0 or offset < 0:
        raise ValueError("offset/length must be non-negative")
    out: List[ObjectRequest] = []
    pos = offset
    end = offset + length
    while pos < end:
        stripe = pos // cfg.stripe_size
        within = pos - stripe * cfg.stripe_size
        take = min(cfg.stripe_size - within, end - pos)
        out.append(ObjectRequest(
            object_id=object_id_for(file_id, stripe),
            offset=within, length=take,
            file_id=file_id, stripe_index=stripe, file_offset=pos))
        pos += take
    return out


def stripe_file(cfg: StripingConfig, file_id: int, size: int) -> List[ObjectRequest]:
    """Full-file write/read plan: one request per stripe."""
    return stripe_request(cfg, file_id, 0, size)


def n_stripes(cfg: StripingConfig, size: int) -> int:
    return max(1, -(-size // cfg.stripe_size))
