"""The port's contract checker (`repro_torch.contractcheck`) on the CPU.

Four groups: parity with the JAX package's AST layer on a shared
numpy/stdlib fixture corpus (the same ``(rule_id, line, suppressed)``
findings); one bad/good PyTorch pair per ``CC-*`` rule, the
import-resolved ``CC-RNG`` among them; one CUDA fixture per ``CU-*`` rule
and the SASS parser on a canned ``cuobjdump -sass`` excerpt; and the
merge gate (the shipped port is strict-clean without the SASS layer,
whose run on the card is `tests/test_torch_gpu.py`'s), the TOML table and
the CLI.
"""

import os
import subprocess
import sys

import pytest

from repro.contractcheck import check_source as ref_check_source
from repro.contractcheck import load_config as ref_load_config
from repro_torch.contractcheck import (check_source, check_sources,
                                       check_tree, cudacheck, layer_of,
                                       load_config, parse_sass, run_check,
                                       source_findings)
from repro_torch.contractcheck.rules import RULES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = load_config(REPO)
REF_CFG = ref_load_config(REPO)

# a fused-scope path and a dispatch-scope path from each shipped config
FUSED = "src/repro_torch/core/policy_core.py"
DISPATCH = "src/repro_torch/core/engine.py"
CU = "src/repro_torch/kernels/sched_select/csrc/sched_stream.cu"
CU_RULES = CFG.rules_for(CU)


def lint(src, relpath=FUSED, rules=None, fused=None):
    return check_source(src, relpath, CFG, rules=rules, fused=fused)


def ids(findings, only_live=True):
    return {f.rule_id for f in findings if not (only_live and f.suppressed)}


# -------------------------------------------- parity: numpy/stdlib corpus

PARITY = {
    "sum_bad": ("""
import numpy as np
def drain(lat, valid):
    return np.sum(lat) + lat.sum()
""", "fused"),
    "sum_good": ("""
import numpy as np
from repro.core.policy_core import lane_sum
def drain(lat, valid):
    a = lane_sum(lat)
    b = np.sum(np.where(valid, lat, 0.0))           # masked: passes
    c = np.sum(valid.astype(np.int32))              # integer: passes
    d = np.sum((lat >= 0.0).astype(np.int32))       # compare: passes
    inside = (lat >= 1.0) & (lat < 2.0)
    return a + b + c + d + np.sum(inside)
""", "fused"),
    "sort": ("""
import numpy as np
from repro.core.policy_core import rank_desc
def pick(keys):
    return np.argsort(-keys), np.sort(keys), rank_desc(keys)
""", "fused"),
    "cumsum": ("""
import numpy as np
def prefix(x):
    return np.cumsum(x), np.cumprod(x)
""", "dispatch"),
    "rng": ("""
import random
import numpy as np
from repro.core.policy_core import lcg_step
def jitter(n, seed):
    return np.random.rand(n), random.random(), lcg_step(seed)
""", "fused"),
    "time": ("""
import time
import datetime
def stamp():
    return time.time(), time.perf_counter(), datetime.datetime.now()
""", "dispatch"),
    "fma": ("""
import numpy as np
def drain(load, rate, dt):
    dec = np.minimum(rate * dt, load)     # mul feeds a clamp, not a sub
    return load - rate * dt, load - dec

def index(window_size: int, n: int):
    for w in range(n):
        i = w * window_size + 1           # integer index math: passes
    pad = [(0, 0)] * (n - 1) + [(0, 2)]   # shape/list math: passes
    seed = np.uint32(7) * np.uint32(3) + 1
    return i, pad, seed
""", "fused"),
    "assoc": ("""
def dispatch(t, trial_tile):
    tile = min(trial_tile, t) if t else 1
    return tile + trial_tile
def defaulted(t, client_tile=None):
    if client_tile is None:
        client_tile = 8
    return client_tile
""", "dispatch"),
    "assoc_resolver": ("""
DEFAULT_CLIENT_TILE = 8
def resolve_client_tile(n_clients, client_tile=None):
    ct = DEFAULT_CLIENT_TILE if client_tile is None else client_tile
    return max(min(ct, n_clients), 1)
def dispatch(t, client_tile=None):
    return resolve_client_tile(t, client_tile)
""", "dispatch"),
    "tile": ("""
from repro.tune.table import resolve_sim_tiles
def raw(cfg):
    return kernel(tile=cfg.trial_tile)
def routed(cfg):
    tt, ct = resolve_sim_tiles(mode=cfg.tiles, trial_tile=cfg.trial_tile,
                               client_tile=cfg.client_tile)
    return tt, ct
""", "dispatch"),
    "twin": ("""
import numpy as np
def norm(p, xp=np):
    if xp is np:
        return p - np.max(p)
    return p / xp.max(p)
def same(p, xp=np):
    return p / np.max(p) if xp is np else p / xp.max(p)
""", "fused"),
    "suppressed": ("""
import numpy as np
def host_twin(p):
    # contract-ok: CC-SUM host twin sums in f64 — the reference (§9)
    return p / p.sum()
def unexplained(p):
    # contract-ok: CC-SUM
    return p / p.sum()
""", "fused"),
    "allowlisted": ("""
import random
class HostScheduler:
    def pick(self, n):
        return random.randrange(n)
def free(n):
    return random.randrange(n)
""", "policies"),
    "simconfig": ("""
class SimConfig:
    def __post_init__(self):
        if self.trial_tile is not None and self.trial_tile < 1:
            raise ValueError("bad tile")
def launch(cfg):
    return cfg.trial_tile
""", "simulate"),
}

_PATHS = {"fused": "core/policy_core.py", "dispatch": "core/engine.py",
          "policies": "core/policies.py", "simulate": "core/simulate.py"}


def _triples(findings):
    return {(f.rule_id, f.line, f.suppressed) for f in findings}


@pytest.mark.parametrize("name", sorted(PARITY))
def test_ast_layer_matches_reference_on_numpy_corpus(name):
    """Rule for rule and line for line, the JAX package's AST layer and
    the port's agree on numpy/stdlib code, each under its own package's
    scope table (the corpus fires every rule but CC-TWIN's other arm)."""
    src, scope = PARITY[name]
    rel = _PATHS[scope]
    want = _triples(ref_check_source(src, f"src/repro/{rel}", REF_CFG))
    got = _triples(check_source(src, f"src/repro_torch/{rel}", CFG))
    assert got == want
    assert bool(got) == (name not in ("sum_good", "assoc_resolver"))


def test_parity_corpus_fires_every_ast_rule():
    seen = set()
    for src, scope in PARITY.values():
        seen |= ids(check_source(src, f"src/repro_torch/{_PATHS[scope]}",
                                 CFG), only_live=False)
    assert seen == {r for r, rule in RULES.items() if rule.layer == "ast"}


# ------------------------------------------------ torch: one pair per rule

TORCH_PAIRS = {
    "CC-SUM": ("""
import torch
def drain(lat, valid):
    return torch.sum(lat) + lat.mean() + torch.nansum(lat) + lat.sum(-1)
""", """
import torch
def drain(lat, valid, probes):
    ok = valid != 0
    a = torch.where(ok, lat, 0.0).sum(dim=-1)     # masked select
    b = ok[:, 1:].sum(dim=-1)                     # slice of a bool
    c = valid.to(torch.int32).sum() + valid.long().sum()
    d = probes.sum(dim=0, dtype=torch.int32)      # integer accumulator
    e = (ok & (lat > 0)).sum() + (~ok).sum()
    return a, b, c, d, e
""", FUSED),
    "CC-SORT": ("""
import torch
def pick(keys):
    return torch.argsort(-keys, stable=True), keys.sort(), keys.topk(2)
""", """
from repro_torch.core.policy_core import rank_desc
def pick(keys):
    return rank_desc(keys)
""", DISPATCH),
    "CC-CUMSUM": ("""
import torch
def prefix(x):
    return torch.cummax(x, dim=-1).values + x.cumsum(-1) + x.logcumsumexp(0)
""", """
import torch
from repro_torch.core.policy_core import lane_sum
def prefix(x):
    return lane_sum(x)
""", DISPATCH),
    "CC-RNG": ("""
import torch
def jitter(n, x):
    g = torch.Generator().manual_seed(0)
    return torch.rand(n, generator=g), torch.randint(0, 9, (n,)), \\
        x.bernoulli(), x.uniform_()
""", """
import torch
from repro_torch.core.policy_core import lcg_mod, lcg_step
def jitter(seed, n):
    return lcg_mod(lcg_step(seed), n)
""", FUSED),
    "CC-TIME": ("""
import torch
from time import perf_counter
def stamp(fn):
    start, end = torch.cuda.Event(enable_timing=True), \\
        torch.cuda.Event(enable_timing=True)
    t0 = perf_counter()
    return start.elapsed_time(end), t0
""", """
def stamp(sim_time, dt):
    return sim_time + dt
""", DISPATCH),
    "CC-FMA": ("""
import torch
def blend(old, new, a, b):
    return torch.addcmul(old, new, a), old.lerp(new, a), \\
        torch.addmm(old, new, b), old.baddbmm(new, b), old.addcdiv_(new, a)
""", """
import torch
def blend(old, new, a):
    prod = a * new
    return old + prod, torch.minimum(a * old, new) - new
""", FUSED),
    "CC-ASSOC": ("""
def launch(t, trial_tile):
    return max(trial_tile, 1) * t
""", """
from repro_torch.tune.table import resolve_sim_tiles
def launch(cfg, t):
    tt, ct = resolve_sim_tiles(mode=cfg.tiles, trial_tile=cfg.trial_tile,
                               client_tile=cfg.client_tile)
    return tt, ct
""", DISPATCH),
    "CC-TILE": ("""
def launch(cfg, run):
    return run(warps=cfg.trial_tile)
""", """
from repro_torch.core.policy_core import resolve_client_tile
def launch(cfg, c):
    return resolve_client_tile(c, cfg.client_tile)
""", FUSED),
    "CC-TWIN": ("""
import numpy as np
import torch
def norm(p, xp=torch):
    if xp is np:
        return p - np.max(p)
    return p / torch.amax(p)
""", """
import numpy as np
import torch
def norm(p, xp=torch):
    if xp is np:
        return p / np.max(p)
    return p / torch.amax(p)
""", FUSED),
    "CC-NOREASON": ("""
import torch
def count(keys):
    # contract-ok: CC-SORT
    return torch.argsort(keys)
""", """
import torch
def count(keys):
    # contract-ok: CC-SORT the host twin's order, pinned to rank_desc (§10)
    return torch.argsort(keys)
""", DISPATCH),
}


# findings each bad fixture holds (1 where not listed)
TORCH_COUNTS = {"CC-SUM": 4, "CC-SORT": 3, "CC-CUMSUM": 3, "CC-RNG": 5,
                "CC-TIME": 4, "CC-FMA": 5}


@pytest.mark.parametrize("rule", sorted(TORCH_PAIRS))
def test_torch_pair_per_rule(rule):
    bad, good, path = TORCH_PAIRS[rule]
    found = lint(bad, path)
    assert ids(found) == {rule}, [f.format() for f in found]
    assert sum(not f.suppressed for f in found) == TORCH_COUNTS.get(rule, 1)
    assert ids(lint(good, path)) == set()


def test_torch_twin_is_a_warning():
    found = lint(TORCH_PAIRS["CC-TWIN"][0])
    assert {f.severity for f in found} == {"warning"}


PORT_RANDOM = """
from repro_torch import random
from repro_torch.random import split as sp
def draw(key, n):
    k1, k2 = random.split(key)
    return random.uniform(k1, (n,)), sp(k2)
"""


def test_cc_rng_resolves_the_ports_random_through_imports():
    """`repro_torch.random` is the port's jax.random: legal seeding in a
    dispatch scope, banned in a fused one; the stdlib `random` is banned
    in both — the name alone does not decide."""
    assert ids(lint(PORT_RANDOM, DISPATCH, rules=["CC-RNG"])) == set()
    fused = lint(PORT_RANDOM, FUSED)
    assert ids(fused) == {"CC-RNG"} and len(fused) == 3
    rel = PORT_RANDOM.replace("from repro_torch import random",
                              "from .. import random")
    assert len(lint(rel, FUSED)) == 3        # relative import, same module
    stdlib = PORT_RANDOM.replace("from repro_torch import random",
                                 "import random")
    assert [f.line for f in lint(stdlib, DISPATCH, rules=["CC-RNG"])] == \
        [5, 6]


# ------------------------------------------------------------- CUDA source

CU_PAIRS = {
    "CU-SUM": ("""
__global__ void k(float* out, const float* x, int n) {
  __shared__ float acc[32];
  atomicAdd(&out[0], x[threadIdx.x]);
  atomicAdd_block(acc + 1, 1.0f);
  float s = cub::BlockReduce<float, 128>(tmp).Sum(x[0]);
  asm volatile("red.global.add.f32 [%0], %1;" :: "l"(out), "f"(s));
}
""", """
__global__ void k(int* hist, unsigned long long* total, const float* x) {
  int* h = hist + 4;
  atomicAdd(&h[threadIdx.x & 3], 1);
  atomicAdd(total, 1ull);
  int c = cub::BlockReduce<int, 128>(tmp).Sum(threadIdx.x);
}
"""),
    "CU-SORT": ("""
void host(int* keys, int n) {
  thrust::sort(thrust::device, keys, keys + n);
  thrust::stable_sort_by_key(thrust::device, keys, keys + n, keys);
  cub::DeviceRadixSort::SortKeys(tmp, bytes, keys, keys, n);
}
""", """
__device__ int rank(const float* k, int i, int n) {
  int r = 0;
  for (int j = 0; j < n; ++j) r += k[j] > k[i] || (k[j] == k[i] && j < i);
  return r;
}
"""),
    "CU-RNG": ("""
__global__ void k(curandState* st, long long* t) {
  float u = curand_uniform(&st[0]);
  t[0] = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t[1]));
}
""", """
__device__ inline unsigned lcg(unsigned r) { return r * 1664525u + 1013904223u; }
// clock() in a comment is not a call
"""),
    "CU-FAST": ("""
__device__ float f(float x, float y) {
  float r;
  asm("ex2.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return __expf(x) + __fdividef(x, y) + __powf(x, y) + r;
}
""", """
__device__ float f(float x, float y) {
  return expf(x) + x / y + powf(x, y) + __fadd_rn(x, y);
}
"""),
    "CU-FMA": ("""
__device__ float f(float a, float b, float c) {
  float r;
  asm("fma.rn.f32 %0, %1, %2, %3;" : "=f"(r) : "f"(a), "f"(b), "f"(c));
  return fmaf(a, b, c) + __fmaf_rn(a, b, c) + r;
}
""", """
__device__ float f(float a, float b, float c) {
  return __fadd_rn(__fmul_rn(a, b), c);   /* fmaf( in a comment */
}
"""),
}


@pytest.mark.parametrize("rule", sorted(CU_PAIRS))
def test_cuda_source_pair_per_rule(rule):
    bad, good = CU_PAIRS[rule]
    found = source_findings(bad, CU, CU_RULES)
    assert ids(found) == {rule}, [f.format() for f in found]
    assert len(found) >= 3
    assert ids(source_findings(good, CU, CU_RULES)) == set()
    assert {layer_of(f) for f in found} == {"cuda"}


def test_cuda_suppression_and_line_numbers():
    src = """/* a block
   comment */
__device__ float f(float a, float r) {
  // contract-ok: CU-FMA Newton step, correctly rounded (DESIGN.md §9)
  float q = fmaf(a, r, 0.f);
  float p = a * r;
  p = fmaf(p, r, q);
  return fmaf(p, r, q);  // contract-ok: CU-FMA
}
"""
    found = source_findings(src, CU, CU_RULES)
    assert sorted((f.rule_id, f.line, f.suppressed) for f in found) == [
        ("CC-NOREASON", 8, False), ("CU-FMA", 5, True), ("CU-FMA", 7, False),
        ("CU-FMA", 8, True)]


BUILD = """
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              {flags})
"""


@pytest.mark.parametrize("flags,want", [
    ('"-fmad=false", "-shared"', []),
    ('"-shared",', ["lacks -fmad=false"]),
    ('"-fmad=false", "-use_fast_math"', ["-use_fast_math"]),
    ('"-fmad=false", "--ftz=true", "-prec-div=false", "-prec-sqrt=false"',
     ["--ftz=true", "-prec-div=false", "-prec-sqrt=false"]),
])
def test_cu_fma_reads_the_build_flags(flags, want):
    found = cudacheck.flag_findings(BUILD.format(flags=flags), "b.py")
    assert [f.rule_id for f in found] == ["CU-FMA"] * len(want)
    for f, w in zip(found, want):
        assert w in f.message and f.line == 2


def test_shipped_build_flags_pin_fmad_off():
    from repro_torch.kernels import _build
    flags, _ = cudacheck.nvcc_flags(
        open(os.path.join(REPO, CFG.nvcc_flags)).read())
    assert flags == _build.NVCC_FLAGS and "-fmad=false" in flags


# ------------------------------------------------------------------- SASS

SASS = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,8]

\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_119sched_stream_kernelILi2ELi32ELi0EEEvNS_6ParamsE
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                     /* 0x00000a00ff017b82 */
                                                                              /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                         /* 0x0000000000007919 */
        /*0020*/                   FFMA R5, R2, R3, R4 ;                      /* 0x0000000302057223 */
        /*0030*/               @P0 FFMA.FTZ R6, R2, R3, R4 ;                  /* 0x0000000302060223 */
        /*0040*/                   ATOMS.POPC.INC.32 RZ, [R11+UR10] ;         /* 0x000000000bff7f8c */
        /*0048*/                   ATOMS.CAST.SPIN R3, [R5], R2, R3 ;         /* 0x000000020503738d */
        /*0050*/                   RED.E.ADD.F32.FTZ.RN.STRONG.GPU desc[UR4][R2.64], R5 ;  /* 0x0 */
        /*0060*/                   NOP ;                                      /* 0x0000000000007918 */
        /*0070*/                   EXIT ;                                     /* 0x000000000000794d */
\t\t..........

\t\tFunction : _ZN12_GLOBAL__N_119client_merge_kernelENS_11MergeParamsE
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   CS2R R4, SR_CLOCKLO ;                      /* 0x0000000000047805 */
        /*0010*/              @!P1 ATOMG.E.ADD.STRONG.GPU PT, R3, desc[UR4][R2.64], R5 ;  /* 0x0 */
        /*0020*/                   REDUX.SUM UR5, R0 ;                        /* 0x00000000000573c4 */
        /*0030*/                   EXIT ;                                     /* 0x000000000000794d */
"""


def test_sass_parser_on_a_canned_listing():
    funcs = parse_sass(SASS)
    stream, merge = funcs.values()
    assert stream.name == "sched_stream_kernel<2, 32, 0>"
    assert merge.name == "client_merge_kernel"
    assert cudacheck.kernel_name("_Z19sched_stream_kernelILi0ELi16ELi3EEv6P") \
        == "sched_stream_kernel<0, 16, 3>"
    assert cudacheck.kernel_name("threefry_kernel") == "threefry_kernel"
    assert (stream.instructions, stream.ffma) == (8, 2)
    assert (merge.instructions, merge.ffma) == (4, 0)
    # the float RED and the CAS loop a shared-memory float atomicAdd
    # compiles to are flagged; the integer ATOMS.POPC.INC, ATOMG and
    # REDUX pass
    assert [r for r, _ in stream.hazards] == ["CU-SUM", "CU-SUM"]
    assert "ATOMS.CAST.SPIN" in stream.hazards[0][1]
    assert "RED.E.ADD.F32.FTZ.RN" in stream.hazards[1][1]
    assert [r for r, _ in merge.hazards] == ["CU-RNG"]
    found = cudacheck.sass_findings(funcs, CU, CFG)
    assert sorted(f.rule_id for f in found) == ["CU-RNG", "CU-SUM", "CU-SUM"]
    assert {layer_of(f) for f in found} == {"sass"}
    allow = load_config(REPO)
    allow.allow[f"{CU}::client_merge_kernel"] = ["CU-RNG"]
    assert [f.rule_id for f in cudacheck.sass_findings(funcs, CU, allow)] \
        == ["CU-SUM", "CU-SUM"]


def test_sass_layer_raises_without_the_toolkit(monkeypatch, tmp_path):
    """No cuobjdump, or a listing with no function, raises: the layer
    never returns an empty (clean-looking) result."""
    monkeypatch.setattr(cudacheck.shutil, "which", lambda name: None)
    monkeypatch.setattr(cudacheck, "CUDA_BIN", tmp_path)
    with pytest.raises(RuntimeError, match="cuobjdump not found"):
        cudacheck.read_sass(tmp_path / "lib.so")
    monkeypatch.setattr(cudacheck, "cuobjdump_path", lambda: "true")
    with pytest.raises(RuntimeError, match="listed no function"):
        cudacheck.read_sass(tmp_path / "lib.so")


# ----------------------------------------------------- config + merge gate

def test_toml_table_replaces_matching_keys(tmp_path):
    (tmp_path / "pyproject.toml").write_text("""
[tool.contractcheck]
resolvers = ["never_read"]

[tool.contractcheck_torch]
resolvers = ["resolve_mine"]
nvcc_flags = "build.py"

[tool.contractcheck_torch.scopes.only]
files = ["a.py"]
rules = ["CC-SUM"]
""")
    cfg = load_config(str(tmp_path))
    assert cfg.root == str(tmp_path)
    assert cfg.resolvers == ["resolve_mine"]
    assert cfg.nvcc_flags == "build.py"
    assert [(s.name, s.files, s.rules) for s in cfg.scopes] == [
        ("only", ["a.py"], ["CC-SUM"])]
    # keys the table leaves out keep their defaults
    assert cfg.assoc_params == CFG.assoc_params and cfg.allow == CFG.allow
    (tmp_path / "pyproject.toml").write_text("[project]\nname = 'x'\n")
    assert load_config(str(tmp_path)).scopes == CFG.scopes


def test_shipped_port_is_strict_clean():
    """Every scoped file of the port, the stream kernel's source and the
    build flags pass with zero live findings; every suppression carries
    a reason (CC-NOREASON would be live)."""
    findings = run_check(REPO, sass=False)
    live = [f.format() for f in findings if not f.suppressed]
    assert live == []
    assert {layer_of(f) for f in findings} == {"ast", "cuda"}
    assert check_tree(CFG) + check_sources(CFG) == findings


def test_cli_smoke():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.contractcheck", "--strict",
         "--no-sass"], cwd=REPO, env=env, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 failing" in out.stdout

    listing = subprocess.run(
        [sys.executable, "-m", "repro_torch.contractcheck", "--list-rules"],
        cwd=REPO, env=env, capture_output=True, text=True)
    assert listing.returncode == 0
    for rid in RULES:
        assert rid in listing.stdout
