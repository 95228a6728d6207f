"""Build the CUDA sources of this package with ``nvcc`` on first use.

Each ``csrc/*.cu`` file of a kernel directory becomes a shared library
with a plain C interface, loaded with ``ctypes``.  The library lands in
``src/repro_torch/_build/`` (listed in ``.gitignore``) under a name that
carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded.  The hash covers the one
file only, so a kernel source stands alone: a local ``#include "..."``
is refused (a header edited on its own would load a stale library).
nvcc's output (the ``-Xptxas -v`` register, shared-memory and spill
lines) is kept beside the library as ``<name>.log``.  Building takes
seconds; nothing is built when the package is imported.  Callers name a
source by its path, so every kernel directory shares this one helper and
one flag set.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

# No fast math, no FMA contraction: the stream kernels are held bit for
# bit against their plain PyTorch versions (the SIMT flash kernel writes
# its FMAs out as ``fmaf``, which this flag leaves alone, and the wgmma
# flash kernel's are the tensor cores').
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"', re.MULTILINE)


def library_path(source: Path) -> Path:
    text = source.read_bytes()
    if _LOCAL_INCLUDE.search(text):
        raise ValueError(f"{source.name} includes a local header; the build "
                         "hashes the source file alone, so keep each kernel "
                         "source in one file")
    digest = hashlib.sha256(text
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def build(source: Path) -> Path:
    """Compile the CUDA file ``source`` unless a library for this exact
    source and flag set exists; returns the library's path."""
    out = library_path(source)
    if out.exists() and out.with_suffix(".log").exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name}:\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_log(source: Path) -> str:
    """nvcc's output from the build of ``source``, building it if
    needed."""
    return build(source).with_suffix(".log").read_text()


def load(source: Path) -> ctypes.CDLL:
    """Load the library of ``source``, building it if needed."""
    return ctypes.CDLL(str(build(source)))
