"""Checkpoint manifests: the metadata side of sharded, atomic checkpoints.

A checkpoint at step ``s`` is a set of *shards* (each shard = one "file"
written through the straggler-aware I/O client, i.e. striped into objects
and scheduled via the statistic log) plus one JSON manifest describing how
to reassemble every pytree leaf.  Commit protocol (crash safety):

    1. write all shards;
    2. write ``manifest-<step>.json``;
    3. write the empty ``COMMIT-<step>`` marker  (atomic rename).

A restore only ever considers steps whose COMMIT marker exists, so a save
killed at any point is simply invisible (tests kill a save mid-flight).

Counterpart of the JAX package's ``checkpoint/manifest.py``: the same
file ids, checksums, JSON and leaf paths, so a checkpoint written by
either package restores in the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from torch import nn


def file_id_for(step: int, leaf_index: int, shard_index: int) -> int:
    """Stable 63-bit file id for a checkpoint shard."""
    h = hashlib.blake2b(f"ckpt/{step}/{leaf_index}/{shard_index}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big") & 0x7FFFFFFFFFFFFFFF


@dataclasses.dataclass
class ShardEntry:
    """One contiguous byte-range of one leaf's flattened buffer."""

    file_id: int
    byte_start: int
    byte_len: int
    checksum: str  # blake2b-64 hex of the shard bytes


@dataclasses.dataclass
class LeafEntry:
    path: str                  # '/'-joined pytree key path
    shape: Tuple[int, ...]
    dtype: str
    nbytes: int
    shards: List[ShardEntry]


@dataclasses.dataclass
class Manifest:
    step: int
    leaves: List[LeafEntry]
    meta: Dict[str, Any]       # free-form (mesh shape, config digest, ...)
    format_version: int = 1

    def to_json(self) -> str:
        return json.dumps({
            "format_version": self.format_version,
            "step": self.step,
            "meta": self.meta,
            "leaves": [{
                "path": l.path, "shape": list(l.shape), "dtype": l.dtype,
                "nbytes": l.nbytes,
                "shards": [dataclasses.asdict(s) for s in l.shards],
            } for l in self.leaves],
        }, indent=1)

    @staticmethod
    def from_json(text: str) -> "Manifest":
        d = json.loads(text)
        return Manifest(
            step=d["step"], meta=d.get("meta", {}),
            format_version=d.get("format_version", 1),
            leaves=[LeafEntry(
                path=l["path"], shape=tuple(l["shape"]), dtype=l["dtype"],
                nbytes=l["nbytes"],
                shards=[ShardEntry(**s) for s in l["shards"]],
            ) for l in d["leaves"]])


def checksum(data: bytes) -> str:
    return hashlib.blake2b(data, digest_size=8).hexdigest()


# --- manifest directory protocol (plain local dir next to the store) -------

def manifest_path(root: str, step: int) -> str:
    return os.path.join(root, f"manifest-{step:010d}.json")


def commit_path(root: str, step: int) -> str:
    return os.path.join(root, f"COMMIT-{step:010d}")


def write_manifest(root: str, m: Manifest) -> None:
    os.makedirs(root, exist_ok=True)
    tmp = manifest_path(root, m.step) + ".tmp"
    with open(tmp, "w") as f:
        f.write(m.to_json())
    os.replace(tmp, manifest_path(root, m.step))


def commit(root: str, step: int) -> None:
    tmp = commit_path(root, step) + ".tmp"
    with open(tmp, "w"):
        pass
    os.replace(tmp, commit_path(root, step))


def committed_steps(root: str) -> List[int]:
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        if name.startswith("COMMIT-"):
            try:
                s = int(name.split("-", 1)[1])
            except ValueError:
                continue
            if os.path.exists(manifest_path(root, s)):
                steps.append(s)
    return sorted(steps)


def load_manifest(root: str, step: int) -> Manifest:
    with open(manifest_path(root, step)) as f:
        return Manifest.from_json(f.read())


def remove_step(root: str, step: int) -> None:
    for p in (commit_path(root, step), manifest_path(root, step)):
        try:
            os.remove(p)
        except FileNotFoundError:
            pass


# --- tree <-> flat path helpers ----------------------------------------------
#
# A tree is nested dicts, lists and tuples (named tuples too) of leaves;
# an ``nn.Module`` stands for its ``state_dict()``.  Leaves are tensors
# (or anything else that is not a container; ``None`` holds no leaf).
# The order and the path strings are the JAX package's pytree ones: a
# plain dict's keys sorted, an OrderedDict's (a ``state_dict``'s) in
# insertion order, sequence items by index, a named tuple's by field
# name, joined by ``/`` ("layer/w", "nested/0").


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of a container, or None for a leaf."""
    if isinstance(node, nn.Module):
        node = node.state_dict()
    if isinstance(node, OrderedDict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    """Flatten a tree to [(path_str, leaf)] with stable, readable paths."""
    out: List[Tuple[str, Any]] = []

    def walk(node, prefix: str) -> None:
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append((prefix, node))
            return
        for k, v in kids:
            walk(v, f"{prefix}/{k}" if prefix else k)

    walk(tree, "")
    return out


def unflatten_like(target, named: Dict[str, Any]):
    """Map {path: leaf} back onto the structure of ``target``.  An
    ``nn.Module``'s place holds its restored ``state_dict`` (an
    OrderedDict, for ``load_state_dict``)."""

    def build(node, prefix: str):
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            if prefix not in named:
                raise KeyError(f"checkpoint missing leaf {prefix!r}")
            return named[prefix]
        vals = [build(v, f"{prefix}/{k}" if prefix else k) for k, v in kids]
        if isinstance(node, (nn.Module, OrderedDict)):
            return OrderedDict(zip((k for k, _ in kids), vals))
        if isinstance(node, dict):
            return dict(zip(sorted(node), vals))
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*vals)
        return type(node)(vals)

    return build(target, "")
