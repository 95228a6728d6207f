"""Layer 2: the CUDA layer, the port's counterpart of the jaxpr layer.

The JAX package's second layer traces the Pallas entry points and walks
what lowers into the kernel body.  In the port the kernel body is CUDA
C++, so this layer reads it, in two parts.

**(a) Source and flags** (runs anywhere, no toolkit).  Each scoped
``.cu`` file is read with its comments stripped (string literals kept, so
inline PTX is read too), and nvcc's flags are read from the
``NVCC_FLAGS`` literal of the build module every source shares:

* **CU-SUM** — ``atomicAdd``/``atomicAdd_block``/``atomicAdd_system``
  whose target is not an integer (its type is looked up from the
  declarations above the call; a float literal operand or a float cast
  decides too, and an operand whose type is not found is flagged), PTX
  ``red``/``atom`` on a float type, and ``cub::``/``cooperative_groups::``
  reductions and scans over floats.
* **CU-SORT** — ``cub::…Sort…`` and ``thrust::sort``/``stable_sort``.
* **CU-RNG** — ``curand*``, ``clock()``/``clock64()``, ``%globaltimer``
  and ``%clock``.
* **CU-FAST** — the fast-math intrinsics (``__expf``, ``__logf``,
  ``__powf``, ``__fdividef``, ``__sinf``, ``__cosf``, ``__tanf`` …) and
  PTX with ``.approx`` or ``.ftz``.
* **CU-FMA** — an explicit ``fmaf``/``fma``/``__fmaf_r*``/PTX ``fma``,
  and flags without ``-fmad=false`` or with ``-use_fast_math``,
  ``--ftz=true``, ``-prec-div=false`` or ``-prec-sqrt=false``.

A ``// contract-ok: CU-ID[,CU-ID…] reason`` comment on the finding's line
or the line above suppresses it, as in Python; a ``# contract-ok`` does
so in the build module.

**(b) SASS** (needs the CUDA toolkit: the card's machine).  Each scoped
source is built with the package's own build (`kernels._build`) and its
library disassembled with ``cuobjdump -sass``; in every kernel function
(each ``sched_stream_kernel<P, L, A>`` instantiation and
``client_merge_kernel``) float atomics and reductions (``ATOM``/``ATOMS``/
``ATOMG``/``RED``/``REDG`` carrying ``.F16``/``.BF16``/``.F32``/``.F64``,
and the compare-and-swap loop ``ATOMS.CAST.SPIN``, which is how nvcc
emits a float ``atomicAdd`` on shared memory for sm_90a) are CU-SUM and
clock reads (``SR_CLOCKLO``/``SR_CLOCKHI``/
``SR_GLOBALTIMER*``) are CU-RNG.  Each function's ``FFMA`` count is
reported, not judged: explicit ``fmaf`` and libdevice's ``expf`` keep
``FFMA`` under ``-fmad=false``.  A missing ``nvcc`` or ``cuobjdump``
raises; this layer never skips itself.
"""

from __future__ import annotations

import ast
import dataclasses
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.contractcheck.astcheck import (collect_suppressions,
                                                suppressions)
from repro_torch.contractcheck.config import CheckConfig
from repro_torch.contractcheck.rules import Finding, apply_severity

FLOAT_TYPES = {"float", "double", "half", "__half", "half2", "__half2",
               "__nv_bfloat16", "__nv_bfloat162", "float2", "float4",
               "double2"}
INT_TYPES = {"int", "unsigned", "long", "short", "char", "bool", "size_t",
             "int8_t", "int16_t", "int32_t", "int64_t", "uint8_t",
             "uint16_t", "uint32_t", "uint64_t", "int2", "int4", "uint2",
             "uint4", "longlong2", "ulonglong2"}
_FLOAT_LITERAL = re.compile(r"^[-+]?(\d+\.\d*|\.\d+|\d+)([eE][-+]?\d+)?[fF]$"
                            r"|^[-+]?(\d+\.\d*|\.\d+)([eE][-+]?\d+)?$")
_INT_LITERAL = re.compile(r"^[-+]?(0[xX][0-9a-fA-F]+|\d+)[uUlL]*$")
_IDENT = r"[A-Za-z_]\w*"

ATOMIC_ADD = re.compile(r"\batomicAdd(?:_block|_system)?\s*\(")
CUB_REDUCE = re.compile(r"\bcub::(\w*(?:Reduce|Scan)\w*)\s*(<[^;{]*?>)?")
CG_REDUCE = re.compile(r"\b(?:cooperative_groups|cg)::(?:reduce|"
                       r"inclusive_scan|exclusive_scan)\s*\(")
PTX_FLOAT_ATOM = re.compile(r"\b(?:red|atom)(?:\.\w+)*?\.(?:f16|bf16|f32|f64)"
                            r"(?:x2)?\b")
SORTS = re.compile(r"\b(cub::\w*Sort\w*|thrust::(?:stable_)?sort"
                   r"(?:_by_key)?)\b")
RNG = re.compile(r"\b(curand\w*)|\b(clock64|clock)\s*\(|(%globaltimer\w*)"
                 r"|(%clock(?:64)?)\b")
FAST = re.compile(r"\b(__(?:expf|exp10f|logf|log2f|log10f|powf|fdividef|"
                  r"sinf|cosf|tanf|sincosf))\s*\(")
PTX_FAST = re.compile(r"\.(approx|ftz)\b")
FMA = re.compile(r"\b(fmaf|fma|__fmaf_\w+|__fma_\w+)\s*\(")
PTX_FMA = re.compile(r"\bfma\.\w+")

FMAD_OFF = ("-fmad=false", "--fmad=false")
BANNED_FLAGS = ("-use_fast_math", "--use_fast_math", "-fmad=true",
                "--fmad=true", "-ftz=true", "--ftz=true", "-prec-div=false",
                "--prec-div=false", "-prec-sqrt=false", "--prec-sqrt=false")


# -- (a) source and flags -----------------------------------------------------

@dataclasses.dataclass
class Source:
    """A CUDA source with its comments blanked (newlines and string
    literals kept), the spans of its string literals, and its
    suppression comments."""

    code: str
    strings: List[Tuple[int, int]]
    comments: List[Tuple[int, str]]     # (line, comment text)

    def line(self, offset: int) -> int:
        return self.code.count("\n", 0, offset) + 1


def strip_comments(text: str) -> Source:
    """Blank ``//`` and ``/* */`` comments, keeping every newline so
    offsets map to the original lines, and string/char literals as
    they are."""
    out = list(text)
    strings: List[Tuple[int, int]] = []
    comments: List[Tuple[int, str]] = []
    i, n, line = 0, len(text), 1
    while i < n:
        c = text[i]
        if c == "\n":
            line += 1
            i += 1
        elif text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            comments.append((line, text[i:j]))
            for k in range(i, j):
                out[k] = " "
            i = j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            comments.append((line, text[i:j]))
            for k in range(i, j):
                if text[k] != "\n":
                    out[k] = " "
            line += text.count("\n", i, j)
            i = j
        elif c in "\"'":
            j = i + 1
            while j < n and text[j] != c and text[j] != "\n":
                j += 2 if text[j] == "\\" else 1
            if c == '"':
                strings.append((i, min(j + 1, n)))
            i = j + 1
        else:
            i += 1
    return Source("".join(out), strings, comments)


def _call_args(code: str, open_paren: int) -> List[str]:
    """The top-level comma-separated arguments of the call whose ``(`` is
    at ``open_paren``."""
    depth, start, args = 0, open_paren + 1, []
    for i in range(open_paren, len(code)):
        c = code[i]
        if c in "([{":
            depth += 1
        elif c in ")]}":
            depth -= 1
            if depth == 0:
                args.append(code[start:i].strip())
                return args
        elif c == "," and depth == 1:
            args.append(code[start:i].strip())
            start = i + 1
    return args


def _declared_type(code: str, name: str, before: int) -> Optional[str]:
    """The base type of the last declaration of ``name`` above offset
    ``before`` ("float", "int" …), or None where none is found."""
    decl = re.compile(
        r"\b((?:unsigned\s+|signed\s+|long\s+)*" + _IDENT + r")"
        r"(?:\s+const)?\s*[*&]*\s*(?:const\s*)?(?:__restrict__\s*)?"
        r"\b" + re.escape(name) + r"\s*(?:\[|=|;|,|\))")
    found = None
    for m in decl.finditer(code, 0, before):
        base = m.group(1).split()[-1]
        if base in FLOAT_TYPES or base in INT_TYPES or \
                m.group(1).startswith(("unsigned", "long", "signed")):
            found = base if base in FLOAT_TYPES else "int"
    return found


def _operand_kind(code: str, arg: str, before: int) -> Optional[str]:
    """"float", "int" or None for an atomic's target or value."""
    a = arg.strip()
    cast = re.search(r"(?:\(\s*|_cast\s*<\s*)(?:const\s+)?(" + _IDENT +
                     r")\s*\*", a)
    if cast and (cast.group(1) in FLOAT_TYPES or cast.group(1) in INT_TYPES):
        return "float" if cast.group(1) in FLOAT_TYPES else "int"
    if _FLOAT_LITERAL.match(a):
        return "float"
    if _INT_LITERAL.match(a):
        return "int"
    # &x[i], x + i, p.member[i], p->member: the last name of the access
    # chain before any subscript or offset
    head = re.split(r"[\[+]", a.lstrip("&*( "), maxsplit=1)[0]
    names = re.findall(_IDENT, head)
    return _declared_type(code, names[-1], before) if names else None


def _in_strings(src: Source, pattern: re.Pattern):
    for lo, hi in src.strings:
        for m in pattern.finditer(src.code, lo, hi):
            yield m


def source_findings(text: str, relpath: str,
                    rules: Sequence[str]) -> List[Finding]:
    """The CU-* rules over one CUDA source blob."""
    src = strip_comments(text)
    code = src.code
    suppress, findings = suppressions(src.comments)
    for f in findings:
        f.path = relpath
    active = set(rules)

    def emit(rule_id: str, offset: int, message: str) -> None:
        if rule_id not in active:
            return
        ln = src.line(offset)
        findings.append(Finding(rule_id, relpath, ln, message,
                                suppressed=rule_id in suppress.get(ln, ())))

    for m in ATOMIC_ADD.finditer(code):
        args = _call_args(code, m.end() - 1)
        kinds = [_operand_kind(code, a, m.start()) for a in args[:2]]
        if kinds and kinds[0] == "int":
            continue
        if kinds and kinds[0] is None and "int" in kinds[1:]:
            continue
        what = "a float" if "float" in kinds else "an unresolved"
        emit("CU-SUM", m.start(),
             f"{m.group(0).rstrip('( ')} on {what} operand "
             f"({args[0] if args else '?'}) — float sums take the pinned "
             "halving tree; an atomic's order changes run to run (§9)")
    for m in _in_strings(src, PTX_FLOAT_ATOM):
        emit("CU-SUM", m.start(),
             f"PTX {m.group(0)} — a float atomic reduction (§9)")
    for m in CUB_REDUCE.finditer(code):
        targs = m.group(2) or ""
        if targs and not (set(re.findall(_IDENT, targs)) & FLOAT_TYPES):
            continue            # an integer block reduction or scan
        emit("CU-SUM", m.start(),
             f"cub::{m.group(1)} over floats (or an unstated type) — no "
             "pinned association (§9)")
    for m in CG_REDUCE.finditer(code):
        args = _call_args(code, m.end() - 1)
        if len(args) > 1 and _operand_kind(code, args[1],
                                           m.start()) == "int":
            continue
        emit("CU-SUM", m.start(),
             f"{m.group(0).rstrip('( ')} over a float (or unresolved) "
             "value — no pinned association (§9)")
    for m in SORTS.finditer(code):
        emit("CU-SORT", m.start(),
             f"{m.group(1)} — the kernels order by the all-pairs rank "
             "(§10)")
    for m in RNG.finditer(code):
        what = next(g for g in m.groups() if g)
        emit("CU-RNG", m.start(),
             f"{what} — kernel randomness is the shared LCG and time is "
             "simulated (§9)")
    for m in FAST.finditer(code):
        emit("CU-FAST", m.start(),
             f"{m.group(1)} — a fast-math intrinsic; the plain versions "
             "round as IEEE float32 (§9)")
    for lo, hi in src.strings:
        m = PTX_FAST.search(code, lo, hi)
        if m:
            emit("CU-FAST", lo,
                 f"PTX {code[lo:hi]} — approximate or flush-to-zero (§9)")
    for m in FMA.finditer(code):
        emit("CU-FMA", m.start(),
             f"{m.group(1)} — an explicit fused multiply-add; the plain "
             "versions round the product and the sum apart (§9/§11)")
    for m in _in_strings(src, PTX_FMA):
        emit("CU-FMA", m.start(),
             f"PTX {m.group(0)} — a fused multiply-add (§9/§11)")
    return findings


def nvcc_flags(text: str) -> Tuple[Tuple[str, ...], int]:
    """The ``NVCC_FLAGS`` literal of a build module, and its line."""
    for node in ast.parse(text).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "NVCC_FLAGS"
                for t in node.targets):
            return tuple(ast.literal_eval(node.value)), node.lineno
    raise ValueError("the build module defines no NVCC_FLAGS literal")


def flag_findings(text: str, relpath: str) -> List[Finding]:
    """CU-FMA over the nvcc flags every CUDA source is built with."""
    flags, ln = nvcc_flags(text)
    suppress, noreason = collect_suppressions(text)
    for f in noreason:
        f.path = relpath
    found: List[str] = []
    if not any(f in flags for f in FMAD_OFF):
        found.append("NVCC_FLAGS lacks -fmad=false: nvcc contracts a * b "
                     "+ c into an FMA by default (§9/§11)")
    for f in flags:
        if f in BANNED_FLAGS:
            found.append(f"NVCC_FLAGS holds {f}: fast math, flushed "
                         "subnormals or approximate division (§9)")
    end = ln + len(flags)
    return noreason + [
        Finding("CU-FMA", relpath, ln, msg,
                suppressed=any("CU-FMA" in suppress.get(k, ())
                               for k in range(ln, end + 1)))
        for msg in found]


def check_sources(cfg: CheckConfig,
                  paths: Optional[Sequence[str]] = None) -> List[Finding]:
    """Part (a): every scoped CUDA source, and the build's flags."""
    findings: List[Finding] = []
    for rel in cfg.scoped(paths, (".cu", ".cuh")):
        text = Path(cfg.root, rel).read_text(encoding="utf-8")
        findings.extend(source_findings(text, rel, cfg.rules_for(rel)))
    if not paths or cfg.nvcc_flags in {cfg.relpath(p) for p in paths}:
        text = Path(cfg.root, cfg.nvcc_flags).read_text(encoding="utf-8")
        findings.extend(flag_findings(text, cfg.nvcc_flags))
    return apply_severity(findings, cfg.severity)


# -- (b) SASS -----------------------------------------------------------------

@dataclasses.dataclass
class SassFunction:
    """One kernel function of a ``cuobjdump -sass`` listing."""

    mangled: str
    instructions: int = 0       # NOPs left out
    ffma: int = 0
    hazards: List[Tuple[str, str]] = dataclasses.field(default_factory=list)

    @property
    def name(self) -> str:
        return kernel_name(self.mangled)


_SASS_LINE = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_PRED = re.compile(r"^@!?U?P(?:\d+|T)\s+")
_FLOAT_MOD = re.compile(r"\.(?:F16|BF16|F32|F64)(?:X2)?\b", re.IGNORECASE)
CUDA_BIN = Path("/usr/local/cuda/bin")
ATOMIC_OPS = {"ATOM", "ATOMS", "ATOMG", "RED", "REDG"}
CLOCKS = re.compile(r"\bSR_(?:CLOCKLO|CLOCKHI|GLOBALTIMER\w*)\b")


def kernel_name(mangled: str) -> str:
    """A kernel's own name and integer template arguments, namespaces
    left out: ``_ZN12_GLOBAL__N_119sched_stream_kernelILi1ELi32ELi0EEEv…``
    -> ``sched_stream_kernel<1, 32, 0>``; a name that is not mangled as
    it is."""
    if not mangled.startswith("_Z"):
        return mangled
    nested = mangled.startswith("_ZN")
    i, name = 3 if nested else 2, None
    while True:
        m = re.match(r"(\d+)", mangled[i:])
        if not m:
            break
        i += m.end()
        name = mangled[i:i + int(m.group(1))]
        i += int(m.group(1))
        args = re.match(r"I((?:Li-?\d+E)+)E", mangled[i:])
        if args:
            name += "<" + ", ".join(re.findall(r"Li(-?\d+)E",
                                               args.group(1))) + ">"
            i += args.end()
        if not nested or mangled[i:i + 1] == "E":
            break
    return name or mangled


def parse_sass(listing: str) -> Dict[str, SassFunction]:
    """mangled name -> its `SassFunction`, for every function of a
    ``cuobjdump -sass`` listing, in listing order."""
    funcs: Dict[str, SassFunction] = {}
    cur: Optional[SassFunction] = None
    for line in listing.splitlines():
        if "Function :" in line:
            mangled = line.split("Function :", 1)[1].strip()
            cur = funcs.setdefault(mangled, SassFunction(mangled))
            continue
        m = _SASS_LINE.match(line)
        if cur is None or not m:
            continue
        body = _PRED.sub("", m.group(2))
        op = body.split(None, 1)[0]
        base = op.split(".", 1)[0]
        if base == "NOP":
            continue
        cur.instructions += 1
        if base == "FFMA":
            cur.ffma += 1
        if base in ATOMIC_OPS and (_FLOAT_MOD.search(op)
                                   or ".CAST.SPIN" in op):
            cur.hazards.append(("CU-SUM", f"/*{m.group(1)}*/ {body}"))
        if CLOCKS.search(body):
            cur.hazards.append(("CU-RNG", f"/*{m.group(1)}*/ {body}"))
    return funcs


def cuobjdump_path() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    default = CUDA_BIN / "cuobjdump"
    if default.exists():
        return str(default)
    raise RuntimeError("cuobjdump not found: the SASS layer runs on a "
                       "machine with the CUDA toolkit (pass sass=False / "
                       "--no-sass to leave it out)")


def read_sass(library: Path) -> Dict[str, SassFunction]:
    """`parse_sass` of ``cuobjdump -sass library``; raises where the
    tool is missing, fails, or finds no function."""
    out = subprocess.run([cuobjdump_path(), "-sass", str(library)],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    funcs = parse_sass(out)
    if not funcs:
        raise RuntimeError(f"cuobjdump -sass {library} listed no function")
    return funcs


def sass_findings(funcs: Dict[str, SassFunction], relpath: str,
                  cfg: CheckConfig) -> List[Finding]:
    """The SASS hazards of one source's functions as findings (path
    ``<sass:relpath>``); ``allow`` entries ``relpath::kernel`` apply."""
    findings = []
    for fn in funcs.values():
        base = fn.name.split("<", 1)[0]
        for rule_id, where in fn.hazards:
            if rule_id not in cfg.rules_for(relpath) or \
                    cfg.allowed(relpath, base, rule_id):
                continue
            kind = "float atomic" if rule_id == "CU-SUM" else "clock read"
            findings.append(Finding(
                rule_id, f"<sass:{relpath}>", 0,
                f"[{fn.name}] {kind} {where} (§9)", func=fn.name))
    return findings


def check_sass(cfg: CheckConfig,
               paths: Optional[Sequence[str]] = None) -> List[Finding]:
    """Part (b): build every scoped CUDA source and read its SASS."""
    from repro_torch.kernels import _build

    findings: List[Finding] = []
    for rel in cfg.scoped(paths, (".cu",)):
        funcs = read_sass(_build.build(Path(cfg.root, rel)))
        findings.extend(sass_findings(funcs, rel, cfg))
    return apply_severity(findings, cfg.severity)


def layer_of(finding: Finding) -> str:
    """"ast", "cuda" or "sass": the layer a finding came from."""
    if finding.path.startswith("<sass:"):
        return "sass"
    if finding.rule_id.startswith("CU-") or \
            finding.path.endswith((".cu", ".cuh")):
        return "cuda"
    return "ast"
