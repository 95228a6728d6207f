"""Checker configuration: scopes, allowlist, severities — data, not code.

The baseline lives in :data:`DEFAULTS` below.  When the repo-root
``pyproject.toml`` has a ``[tool.contractcheck_torch]`` table, each key
it holds *replaces* the matching default, so new scopes and allowances
are registered by editing TOML, not this module (DESIGN.md §15).  The
JAX package's ``[tool.contractcheck]`` table names that package's files
and is never read here.

TOML parsing uses stdlib ``tomllib`` (3.11+) and falls back to
``tomli``; with neither importable the defaults apply unchanged.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

try:                                  # 3.11+
    import tomllib as _toml
except ImportError:                   # pragma: no cover - version dependent
    try:
        import tomli as _toml         # type: ignore[no-redef]
    except ImportError:
        _toml = None                  # type: ignore[assignment]

TOML_TABLE = "contractcheck_torch"


@dataclasses.dataclass(frozen=True)
class Scope:
    """A named set of files and the rule IDs enforced over them.  A file
    in several scopes gets the union of their rules."""

    name: str
    files: List[str]
    rules: List[str]


@dataclasses.dataclass
class CheckConfig:
    root: str
    scopes: List[Scope]
    # "relpath::qualname" -> rule IDs deliberately allowed there (for the
    # SASS layer the qualname is the kernel's name, e.g.
    # "client_merge_kernel")
    allow: Dict[str, List[str]]
    severity: Dict[str, str]
    # function names whose bodies may touch association parameters
    resolvers: List[str]
    # identifiers treated as association/lowering parameters (CC-ASSOC)
    assoc_params: List[str]
    # the module whose NVCC_FLAGS every CUDA source is built with (CU-FMA)
    nvcc_flags: str

    def rules_for(self, relpath: str) -> List[str]:
        relpath = relpath.replace(os.sep, "/")
        out: List[str] = []
        for sc in self.scopes:
            if relpath in sc.files:
                out.extend(r for r in sc.rules if r not in out)
        return out

    def relpath(self, path: str) -> str:
        return os.path.relpath(os.path.abspath(path),
                               self.root).replace(os.sep, "/")

    def scoped(self, paths: Optional[Sequence[str]],
               suffixes: Tuple[str, ...]) -> List[str]:
        """The scoped files with one of ``suffixes`` (or their
        intersection with ``paths``), relative to the root."""
        out: List[str] = []
        for sc in self.scopes:
            out.extend(f for f in sc.files
                       if f.endswith(suffixes) and f not in out)
        if paths:
            want = {self.relpath(p) for p in paths}
            out = [f for f in out if f in want]
        return out

    def allowed(self, relpath: str, qualname: Optional[str],
                rule_id: str) -> bool:
        if not qualname:
            return False
        relpath = relpath.replace(os.sep, "/")
        # match the full qualname and every dotted prefix, so a class- or
        # function-level allowance covers nested helpers
        parts = qualname.split(".")
        for i in range(len(parts), 0, -1):
            key = f"{relpath}::{'.'.join(parts[:i])}"
            if rule_id in self.allow.get(key, ()):
                return True
        return False


# The port's §9–§14 surface.  "fused" files hold the plain versions the
# CUDA kernels are held against (and the policy_core helpers they run);
# "dispatch" files resolve launch parameters and drive the engine, where
# backend sorts stay deliberate (§10) but must be annotated; "cuda" holds
# the stream kernel's source, whose body is the fused surface itself.
DEFAULTS: Dict[str, object] = {
    "scopes": {
        "fused": {
            "files": [
                "src/repro_torch/kernels/sched_select/kernel.py",
                "src/repro_torch/kernels/sched_select/ref.py",
                "src/repro_torch/core/policy_core.py",
                "src/repro_torch/parallel/sweep.py",
            ],
            "rules": ["CC-SUM", "CC-SORT", "CC-CUMSUM", "CC-RNG",
                      "CC-TIME", "CC-FMA", "CC-TWIN", "CC-TILE"],
        },
        "dispatch": {
            "files": [
                "src/repro_torch/kernels/sched_select/ops.py",
                "src/repro_torch/parallel/sweep.py",
                "src/repro_torch/core/engine.py",
                "src/repro_torch/core/simulate.py",
                "src/repro_torch/core/policies.py",
                "src/repro_torch/core/statlog.py",
            ],
            "rules": ["CC-SORT", "CC-CUMSUM", "CC-RNG", "CC-TIME",
                      "CC-ASSOC", "CC-TILE"],
        },
        "cuda": {
            "files": [
                "src/repro_torch/kernels/sched_select/csrc/sched_stream.cu",
            ],
            "rules": ["CU-SUM", "CU-SORT", "CU-RNG", "CU-FAST", "CU-FMA"],
        },
    },
    # deliberate, §-documented deviations registered by scope (inline
    # `# contract-ok` comments cover single lines; this covers functions)
    "allow": {
        # host-side scheduler: its window-start snapshot keeps a stable
        # sort, pinned equal to the kernel's all-pairs rank (§10/§13), off
        # the fused path entirely (DESIGN.md §8), as in the reference
        "src/repro_torch/core/policies.py::HostScheduler": ["CC-RNG",
                                                            "CC-SORT"],
        # dataclass validation reads its own tile fields to reject
        # non-positive values before any resolver ever sees them (§16)
        "src/repro_torch/core/simulate.py::SimConfig": ["CC-TILE"],
    },
    "severity": {},
    "resolvers": ["resolve_client_tile", "resolve_shard_width",
                  "resolve_sim_tiles"],
    "assoc_params": ["trial_tile", "client_tile", "shard_width",
                     "DEFAULT_TRIAL_TILE", "DEFAULT_CLIENT_TILE"],
    "nvcc_flags": "src/repro_torch/kernels/_build.py",
}

_KEYS = ("scopes", "allow", "severity", "resolvers", "assoc_params",
         "nvcc_flags")


def _scopes_from(raw: Dict[str, dict]) -> List[Scope]:
    return [Scope(name=k, files=list(v.get("files", ())),
                  rules=list(v.get("rules", ())))
            for k, v in raw.items()]


def find_root(start: Optional[str] = None) -> str:
    """Repo root = nearest ancestor with pyproject.toml or .git."""
    d = os.path.abspath(start or os.getcwd())
    while True:
        if (os.path.exists(os.path.join(d, "pyproject.toml"))
                or os.path.exists(os.path.join(d, ".git"))):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return os.path.abspath(start or os.getcwd())
        d = parent


def load_config(root: Optional[str] = None,
                pyproject: Optional[str] = None) -> CheckConfig:
    root = find_root(root)
    raw = dict(DEFAULTS)
    path = pyproject or os.path.join(root, "pyproject.toml")
    if _toml is not None and os.path.exists(path):
        with open(path, "rb") as fh:
            table = _toml.load(fh).get("tool", {}).get(TOML_TABLE, {})
        for key in _KEYS:
            if key in table:
                raw[key] = table[key]
    return CheckConfig(
        root=root,
        scopes=_scopes_from(raw["scopes"]),          # type: ignore[arg-type]
        allow={k: list(v) for k, v in raw["allow"].items()},  # type: ignore
        severity=dict(raw["severity"]),              # type: ignore[arg-type]
        resolvers=list(raw["resolvers"]),            # type: ignore[arg-type]
        assoc_params=list(raw["assoc_params"]),      # type: ignore[arg-type]
        nvcc_flags=str(raw["nvcc_flags"]),
    )
