"""Static enforcement of the port's DESIGN.md §9–§14 bit-exactness
contract: the counterpart of the JAX package's ``repro.contractcheck``.

Two layers (DESIGN.md §15): `astcheck` lints the PyTorch surface for
banned primitives, FMA-hazard shapes, out-of-resolver association
parameters and xp-twin drift; `cudacheck` reads the CUDA kernel sources
and nvcc's flags (anywhere) and the built SASS (on a machine with the
CUDA toolkit).  ``python -m repro_torch.contractcheck --strict`` is the
gate; `run_check` is the library entry point.
"""

from repro_torch.contractcheck.astcheck import (check_file, check_source,
                                                check_tree)
from repro_torch.contractcheck.config import CheckConfig, load_config
from repro_torch.contractcheck.cudacheck import (check_sass, check_sources,
                                                 layer_of, parse_sass,
                                                 read_sass, source_findings)
from repro_torch.contractcheck.rules import RULES, Finding, Rule

__all__ = ["CheckConfig", "Finding", "Rule", "RULES", "check_file",
           "check_sass", "check_source", "check_sources", "check_tree",
           "layer_of", "load_config", "parse_sass", "read_sass",
           "run_check", "source_findings"]


def run_check(root=None, paths=None, sass=True, config=None):
    """Full checker run: the AST layer over every scoped Python file,
    the CUDA layer's source and flag checks, and (``sass=True``, the
    default) the SASS of every scoped CUDA source, built here.  Returns
    all findings."""
    cfg = config or load_config(root)
    findings = check_tree(cfg, paths)
    findings.extend(check_sources(cfg, paths))
    if sass:
        findings.extend(check_sass(cfg, paths))
    return findings
