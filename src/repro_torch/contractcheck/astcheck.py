"""Layer 1: AST lint over the port's §9–§14 contract surface.

The JAX package's AST layer retargeted at PyTorch.  One
:class:`_FileChecker` pass per scoped file; the rules and the idioms they
deliberately admit:

* **CC-SUM** — backend sum/mean reductions (``torch.sum``/``x.sum()``/
  ``torch.mean``/``x.mean()``/``torch.nansum``, and ``np.sum``/
  ``jnp.sum``/``xp.sum``) are banned in fused scopes *except* the two
  association-free shapes the contract blesses: a masked select
  (``sum(where(mask, x, 0))`` — at most one non-zero term per lane or a
  0/1 count) and an integer/bool operand or accumulator (integer adds
  are exact under any association: a comparison, ``&``/``|``/``~``,
  ``.to(torch.int32)``/``.int()``/``.long()``/``.bool()``, a slice of
  such a tensor, or ``dtype=torch.int32``).  Operand classification
  follows single-assignment names within the function, so
  ``inside = (a >= lo) & (a < hi); inside.sum()`` passes without
  annotation.
* **CC-SORT / CC-CUMSUM** — backend sorts (``sort``/``argsort``/
  ``topk``/``msort``) and prefix reductions (``cumsum``/``cumprod``/
  ``cummax``/``cummin``/``logcumsumexp``), function and method forms.
* **CC-RNG** — call names resolve through the file's imports: stdlib
  ``random``, ``numpy.random`` and torch's generators are banned in
  every scope; ``repro_torch.random`` (the port's ``jax.random``) is
  legal in dispatch scopes (engine seeding) but not fused ones.
* **CC-TIME** — wall-clock reads, and ``torch.cuda.Event`` timing.
* **CC-FMA** — a multiply as a direct operand of ``+``/``-`` in the
  same expression, the shape a compiler may contract to an FMA (§9
  drain, §11 Eq. (3)), and the one-call multiply-adds ``addcmul``/
  ``addcdiv``/``lerp``/``addmm``/``baddbmm``.  Integer operands (the
  LCG's, index math) are exempt: integer FMA is exact.
* **CC-ASSOC** — association parameters may be *passed through* calls
  but never fed to ``min``/``max``/arithmetic or defaulted with
  ``x if p is None else p`` outside the shared resolvers.
* **CC-TILE** — attribute reads of tile association fields
  (``cfg.trial_tile`` …) outside resolver bodies are flagged unless the
  read is an argument of a resolver call (§16).
* **CC-TWIN** — for ``xp`` twin functions, the np arm and the other
  backend's arm of every ``if xp is np`` / ternary must use the same
  *set* of value-combining operations; relocations (where/take/pad/
  reshape) and bitwise ops are neutral.

On numpy/stdlib code the layer finds what the JAX package's finds; the
torch names, the import resolution of ``random`` and the integer kinds
above are what it adds.

Suppression: ``# contract-ok: RULE-ID[,RULE-ID…] <reason>`` on the
finding's line (or the line above) suppresses it; a missing reason
keeps the suppression but emits CC-NOREASON (§15).
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.contractcheck.config import CheckConfig
from repro_torch.contractcheck.rules import Finding, apply_severity

BACKEND_NAMES = {"torch", "jnp", "np", "numpy", "xp", "lax"}
# modules whose functions are backend reductions, sorts, scans
BACKEND_MODULES = {"torch", "numpy", "jax"}
SUM_ATTRS = {"sum"}
TORCH_SUM_ATTRS = {"sum", "mean", "nansum", "nanmean"}
SORT_ATTRS = {"sort", "argsort", "lexsort", "sort_key_val", "topk",
              "msort"}
CUMSUM_ATTRS = {"cumsum", "cumprod", "cummax", "cummin",
                "associative_scan", "logcumsumexp"}
FMA_CALLS = {"addcmul", "addcdiv", "lerp", "addmm", "baddbmm"}
TIME_CALLS = {"time.time", "time.perf_counter", "time.monotonic",
              "time.process_time", "time.time_ns", "time.perf_counter_ns",
              "time.monotonic_ns", "datetime.now", "datetime.datetime.now",
              "datetime.utcnow", "datetime.datetime.utcnow",
              "torch.cuda.Event"}
# module prefixes whose every call draws non-LCG randomness
STDLIB_RNG = ("random.", "numpy.random.", "np.random.", "secrets.")
# jax.random and its port: legal for seeding, banned inside a fused body
KEYED_RNG = ("jax.random.", "repro_torch.random.", "jrandom.", "jr.")
TORCH_RNG = {"rand", "rand_like", "randn", "randn_like", "randint",
             "randint_like", "randperm", "Generator", "manual_seed",
             "manual_seed_all", "seed", "bernoulli", "multinomial",
             "normal", "poisson", "fork_rng"}
TENSOR_RNG_METHODS = {"random_", "uniform_", "normal_", "bernoulli_",
                      "bernoulli", "multinomial", "exponential_",
                      "geometric_", "cauchy_", "log_normal_"}
INT_CAST_NAMES = re.compile(r"(int|uint|i32|i64|u32|bool)", re.IGNORECASE)
INT_CAST_FUNCS = {"int8", "int16", "int32", "int64",
                  "uint8", "uint16", "uint32", "uint64", "int"}
# torch's integer/bool dtypes, by their attribute names
INT_DTYPES = {"int8", "int16", "int32", "int64", "uint8", "uint16",
              "uint32", "uint64", "int", "long", "short", "bool"}
INT_CAST_METHODS = {"long", "short", "bool", "byte", "char"}
# value-combining vocabulary for CC-TWIN arm comparison
COMBINING_CALLS = {"exp", "log", "log1p", "expm1", "sqrt", "maximum",
                   "minimum", "clip", "ceil", "floor", "abs", "power",
                   "sum", "mean", "prod", "dot", "matmul", "cumsum",
                   "tanh", "rem", "fmod", "mod"}
_CALL_CANON = {"rem": "%", "fmod": "%", "mod": "%", "power": "**"}
_BINOP_SYM = {ast.Add: "+", ast.Sub: "-", ast.Mult: "*", ast.Div: "/",
              ast.FloorDiv: "//", ast.Mod: "%", ast.Pow: "**"}
_BITWISE = (ast.BitAnd, ast.BitOr, ast.BitXor, ast.LShift, ast.RShift)

# "# contract-ok: ..." in Python, "// contract-ok: ..." in CUDA C++
_SUPPRESS_RE = re.compile(
    r"(?:#|//)\s*contract-ok:\s*"
    r"([A-Z][A-Z0-9\-]*(?:\s*,\s*[A-Z][A-Z0-9\-]*)*)[ \t]*(.*)$")


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for an Attribute/Name chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _terminal(name: Optional[str]) -> Optional[str]:
    return name.rsplit(".", 1)[-1] if name else None


def suppressions(comments) -> Tuple[Dict[int, Set[str]], List[Finding]]:
    """line -> suppressed rule IDs over ``(line, comment text)`` pairs (a
    comment covers its own line and the next, so both trailing and
    line-above styles work), plus CC-NOREASON findings (path left
    empty) for reasonless suppressions."""
    lines: Dict[int, Set[str]] = {}
    noreason: List[Finding] = []
    for ln, text in comments:
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        ids = {s.strip() for s in m.group(1).split(",") if s.strip()}
        for line in (ln, ln + 1):
            lines.setdefault(line, set()).update(ids)
        if not m.group(2).strip():
            noreason.append(Finding(
                "CC-NOREASON", "", ln,
                f"suppression of {','.join(sorted(ids))} has no reason"))
    return lines, noreason


def collect_suppressions(src: str) -> Tuple[Dict[int, Set[str]],
                                            List[Finding]]:
    """`suppressions` over the comments of Python source ``src``."""
    try:
        toks = list(tokenize.generate_tokens(io.StringIO(src).readline))
    except tokenize.TokenizeError:      # pragma: no cover - defensive
        return {}, []
    return suppressions((tok.start[0], tok.string) for tok in toks
                        if tok.type == tokenize.COMMENT)


def _module_of(relpath: str) -> List[str]:
    """The dotted package a source file lies in ('src/' stripped), for
    relative imports."""
    parts = relpath.replace(os.sep, "/").split("/")
    if parts and parts[0] == "src":
        parts = parts[1:]
    return parts[:-1]


def import_map(tree: ast.AST, relpath: str) -> Dict[str, str]:
    """Local name -> the dotted module or object it is bound to, over
    every ``import`` of the file (function-level ones too)."""
    names: Dict[str, str] = {}
    package = _module_of(relpath)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    names[a.asname] = a.name
                else:
                    head = a.name.split(".", 1)[0]
                    names[head] = head
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level:
                keep = len(package) - (node.level - 1)
                base = ".".join(package[:max(keep, 0)])
                mod = ".".join(p for p in (base, mod) if p)
            for a in node.names:
                if a.name != "*":
                    names[a.asname or a.name] = f"{mod}.{a.name}"
    return names


def _is_int_dtype(node: Optional[ast.AST]) -> bool:
    """``torch.int32``/``np.int64``/``torch.bool``/"int32" …"""
    if node is None:
        return False
    name = _dotted(node)
    if name is None and isinstance(node, ast.Constant):
        name = str(node.value)
    return bool(name) and _terminal(name) in INT_DTYPES


def _dtype_kw(node: ast.Call) -> Optional[ast.AST]:
    return next((kw.value for kw in node.keywords if kw.arg == "dtype"),
                None)


def _is_int_cast_call(node: ast.AST) -> bool:
    """jnp.uint32(x) / x.astype(jnp.int32) / int(x) / x.to(torch.int32)
    / x.long() / x.bool() — integer-exact."""
    if not isinstance(node, ast.Call):
        return False
    attr = (node.func.attr if isinstance(node.func, ast.Attribute)
            else node.func.id if isinstance(node.func, ast.Name) else None)
    if attr in INT_CAST_FUNCS:
        return True
    if isinstance(node.func, ast.Attribute) and attr in INT_CAST_METHODS:
        return True
    if attr == "astype" and node.args:
        dt = _dotted(node.args[0])
        if dt is None and isinstance(node.args[0], ast.Constant):
            dt = str(node.args[0].value)
        return bool(dt and INT_CAST_NAMES.search(_terminal(dt) or dt))
    if attr in ("to", "type") and isinstance(node.func, ast.Attribute):
        return _is_int_dtype(node.args[0] if node.args else _dtype_kw(node))
    return False


def _is_where_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and _terminal(_dotted(node.func)) == "where")


def _classify(node: ast.AST, kinds: Dict[str, str],
              depth: int = 0) -> Optional[str]:
    """'int' (integer/bool/shape-valued — association-free), 'mask'
    (masked select), or None (assume float tensor)."""
    if depth > 8:
        return None
    if isinstance(node, ast.Compare):
        return "int"
    if _is_int_cast_call(node):
        return "int"
    if _is_where_call(node):
        return "mask"
    if isinstance(node, ast.Constant):
        return "int" if isinstance(node.value, (int, bool)) and \
            not isinstance(node.value, float) else None
    if isinstance(node, (ast.List, ast.Tuple, ast.Dict)):
        # container literals: python-level structure, not float math
        return "int"
    if isinstance(node, ast.Name):
        return kinds.get(node.id)
    if isinstance(node, ast.Attribute) and node.attr in ("ndim", "size"):
        return "int"
    if isinstance(node, ast.Subscript):
        chain = _dotted(node.value)
        if chain and chain.endswith(".shape"):
            return "int"
        # a slice or gather of an integer/bool tensor stays integer
        return "int" if _classify(node.value, kinds, depth + 1) == "int" \
            else None
    if isinstance(node, ast.Call):
        fname = _dotted(node.func)
        if _terminal(fname) in ("len", "ord", "range", "arange", "iota",
                                "broadcasted_iota"):
            return "int"
        return "int" if _is_int_dtype(_dtype_kw(node)) else None
    if isinstance(node, ast.BinOp):
        if isinstance(node.op, _BITWISE):
            # bitwise ops exist on integer/bool tensors only
            return "int"
        if isinstance(node.op, (ast.Add, ast.Sub, ast.Mult, ast.FloorDiv,
                                ast.Mod)):
            if (_classify(node.left, kinds, depth + 1) == "int"
                    and _classify(node.right, kinds, depth + 1) == "int"):
                return "int"
        return None
    if isinstance(node, ast.UnaryOp):
        if isinstance(node.op, (ast.Invert, ast.Not)):
            return "int"
        if isinstance(node.op, ast.USub):
            return _classify(node.operand, kinds, depth + 1)
    return None


def _ann_is_int(ann: Optional[ast.AST]) -> bool:
    return (isinstance(ann, ast.Name) and ann.id in ("int", "bool")) or \
        (isinstance(ann, ast.Constant) and ann.value in ("int", "bool"))


def _prepass_kinds(fn: ast.AST,
                   outer: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Name classification for one function: closure kinds, int/bool
    annotated params, range-loop targets, then single-assignment
    propagation to fixpoint (two passes)."""
    kinds: Dict[str, str] = dict(outer or {})
    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        every = (list(fn.args.posonlyargs) + list(fn.args.args)
                 + list(fn.args.kwonlyargs))
        for a in every:
            if _ann_is_int(a.annotation):
                kinds[a.arg] = "int"
            elif a.arg in kinds:
                del kinds[a.arg]       # param shadows an outer name
    for _ in range(2):
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                k = _classify(node.value, kinds)
                if k:
                    kinds[node.targets[0].id] = k
            elif (isinstance(node, ast.For)
                  and isinstance(node.target, ast.Name)
                  and isinstance(node.iter, ast.Call)
                  and _terminal(_dotted(node.iter.func)) == "range"):
                kinds[node.target.id] = "int"
    return kinds


def _has_xp_param(fn: ast.FunctionDef) -> bool:
    args = fn.args
    every = (list(args.posonlyargs) + list(args.args)
             + list(args.kwonlyargs))
    return any(a.arg == "xp" for a in every)


def _is_xp_test(test: ast.AST) -> bool:
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1):
        return False
    if not isinstance(test.ops[0], (ast.Is, ast.IsNot, ast.Eq, ast.NotEq)):
        return False
    names = {_dotted(test.left), _dotted(test.comparators[0])}
    return "xp" in names and bool(names & {"np", "jnp", "numpy", "torch"})


def _stmt_lists(fn: ast.AST):
    for node in ast.walk(fn):
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(node, field, None)
            if isinstance(stmts, list) and stmts and \
                    isinstance(stmts[0], ast.stmt):
                yield stmts


def _combining_ops(nodes: Sequence[ast.AST]) -> Set[str]:
    ops: Set[str] = set()
    for root in nodes:
        for node in ast.walk(root):
            if isinstance(node, (ast.BinOp, ast.AugAssign)):
                sym = _BINOP_SYM.get(type(node.op))
                if sym is None:
                    continue
                # shape/index arithmetic (len(x) - 1, ndim - 1, tuple
                # concat) is a relocation, not a value-combining op
                if isinstance(node, ast.BinOp) and \
                        _classify(node.left, {}) == "int" and \
                        _classify(node.right, {}) == "int":
                    continue
                ops.add(sym)
            elif isinstance(node, ast.Call):
                term = _terminal(_dotted(node.func))
                if term in COMBINING_CALLS:
                    ops.add(_CALL_CANON.get(term, term))
    return ops


class _FileChecker(ast.NodeVisitor):
    def __init__(self, relpath: str, src: str, cfg: CheckConfig,
                 active: Sequence[str], fused: bool,
                 imports: Dict[str, str]):
        self.relpath = relpath
        self.cfg = cfg
        self.active = set(active)
        self.fused = fused
        self.imports = imports
        self.findings: List[Finding] = []
        self.suppress, noreason = collect_suppressions(src)
        for f in noreason:
            f.path = relpath
            self.findings.append(f)
        self.func_stack: List[str] = []
        # innermost enclosing FunctionDef's name-kind map
        self.kind_stack: List[Dict[str, str]] = [{}]
        # Attribute nodes sanctioned for CC-TILE: tile-field reads that
        # are arguments of a resolver call (registered in visit_Call
        # before descent)
        self._tile_ok: Set[int] = set()

    # -- plumbing ---------------------------------------------------------

    def qualname(self) -> Optional[str]:
        return ".".join(self.func_stack) if self.func_stack else None

    def emit(self, rule_id: str, node: ast.AST, message: str) -> None:
        if rule_id not in self.active:
            return
        if self.cfg.allowed(self.relpath, self.qualname(), rule_id):
            return
        lo = getattr(node, "lineno", 0)
        hi = getattr(node, "end_lineno", lo) or lo
        suppressed = any(rule_id in self.suppress.get(line, ())
                         for line in range(lo, hi + 1))
        self.findings.append(Finding(rule_id, self.relpath, lo, message,
                                     suppressed=suppressed,
                                     func=self.qualname()))

    def resolve(self, name: str) -> str:
        """A dotted call name with its head replaced by what the file's
        imports bind it to."""
        head, _, rest = name.partition(".")
        full = self.imports.get(head, head)
        return f"{full}.{rest}" if rest else full

    def _is_module(self, node: ast.AST) -> bool:
        """Whether ``node`` names a backend namespace or an imported
        module, as opposed to a value (a tensor's method call)."""
        name = _dotted(node)
        if name is None:
            return False
        head = name.split(".", 1)[0]
        return head in BACKEND_NAMES or head in self.imports

    def _is_backend(self, node: ast.AST) -> bool:
        name = _dotted(node)
        if name is None:
            return False
        head = name.split(".", 1)[0]
        return head in BACKEND_NAMES or head == "jax" or \
            self.resolve(head).split(".", 1)[0] in BACKEND_MODULES

    # -- function scoping + CC-TWIN ---------------------------------------

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.func_stack.append(node.name)
        self.kind_stack.append(_prepass_kinds(node, self.kind_stack[-1]))
        if "CC-TWIN" in self.active and _has_xp_param(node):
            self._check_twin(node)
        self.generic_visit(node)
        self.kind_stack.pop()
        self.func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.func_stack.append(node.name)
        self.generic_visit(node)
        self.func_stack.pop()

    def _check_twin(self, fn: ast.FunctionDef) -> None:
        for stmts in _stmt_lists(fn):
            for idx, stmt in enumerate(stmts):
                if not isinstance(stmt, ast.If) or not _is_xp_test(stmt.test):
                    continue
                arm_a: Sequence[ast.AST] = stmt.body
                if stmt.orelse:
                    arm_b: Sequence[ast.AST] = stmt.orelse
                elif arm_a and isinstance(arm_a[-1], (ast.Return, ast.Raise)):
                    # `if xp is np: … return` with the other backend's
                    # path continuing after the If
                    arm_b = stmts[idx + 1:]
                else:
                    continue
                self._twin_diff(stmt, arm_a, arm_b)
        for node in ast.walk(fn):
            if isinstance(node, ast.IfExp) and _is_xp_test(node.test):
                self._twin_diff(node, [node.body], [node.orelse])

    def _twin_diff(self, at: ast.AST, arm_a: Sequence[ast.AST],
                   arm_b: Sequence[ast.AST]) -> None:
        ops_a = _combining_ops(arm_a)
        ops_b = _combining_ops(arm_b)
        if ops_a != ops_b:
            only_a = ",".join(sorted(ops_a - ops_b)) or "(none)"
            only_b = ",".join(sorted(ops_b - ops_a)) or "(none)"
            self.emit("CC-TWIN", at,
                      f"xp twin arms diverge: one arm only {{{only_a}}}, "
                      f"other arm only {{{only_b}}}")

    # -- call rules --------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        if isinstance(node.func, ast.Attribute):
            self._check_attr_call(node, node.func, name)
        if name:
            self._check_rng_time(node, name)
        self._check_assoc_call(node)
        if _terminal(name) in self.cfg.resolvers:
            # feeding a tile field TO a resolver is the sanctioned read
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                for sub in ast.walk(arg):
                    if isinstance(sub, ast.Attribute) and \
                            sub.attr in self.cfg.assoc_params:
                        self._tile_ok.add(id(sub))
        self.generic_visit(node)

    def _check_attr_call(self, node: ast.Call, func: ast.Attribute,
                         name: Optional[str]) -> None:
        """The backend-reduction rules on ``mod.f(x)`` (function form)
        and ``x.f()`` (a tensor's method)."""
        attr = func.attr
        namespace = isinstance(func.value, ast.Name) and \
            func.value.id in BACKEND_NAMES
        backend = self._is_backend(func.value)
        method = not self._is_module(func.value)
        torchy = method or (backend and
                            self.resolve(_dotted(func.value) or "")
                            .startswith("torch"))
        sums = TORCH_SUM_ATTRS if torchy else SUM_ATTRS
        if attr in sums:
            if namespace and node.args:
                self._check_sum(node, node.args[0], name or attr)
            elif not namespace:
                # method form x.sum(...): classify the receiver
                self._check_sum(node, func.value, name or f"<expr>.{attr}")
        if attr in SORT_ATTRS and (backend or method):
            self.emit("CC-SORT", node,
                      f"backend {attr} ({name or '<expr>.' + attr}) — "
                      "fused scopes use rank_desc/bitonic; engine sites "
                      "annotate (§10)")
        if attr in CUMSUM_ATTRS and (backend or method):
            self.emit("CC-CUMSUM", node,
                      f"backend {attr} ({name or '<expr>.' + attr}) — no "
                      "pinned association for prefix reductions (§9)")
        if attr.rstrip("_") in FMA_CALLS and (backend or method):
            self.emit("CC-FMA", node,
                      f"{name or '<expr>.' + attr} — a one-call "
                      "multiply-add, the FMA contraction hazard (§9/§11)")
        if attr in TENSOR_RNG_METHODS and method:
            self.emit("CC-RNG", node,
                      f"{name or '<expr>.' + attr} — torch's generator; "
                      "contract randomness is the shared LCG (§9)")
        if attr == "elapsed_time" and method:
            self.emit("CC-TIME", node,
                      f"{name or '<expr>.elapsed_time'} — clock reads are "
                      "banned on the contract surface (simulated time "
                      "only, §9)")

    def _check_sum(self, node: ast.Call, operand: ast.AST,
                   name: str) -> None:
        if "CC-SUM" not in self.active:
            return
        if _classify(operand, self.kind_stack[-1]) in ("int", "mask"):
            return
        if _is_int_dtype(_dtype_kw(node)):
            return          # an integer accumulator: association-free
        self.emit("CC-SUM", node,
                  f"backend sum ({name}) over a non-masked float operand "
                  "— use lane_sum/tree_sum or a torch.where mask (§9)")

    def _check_rng_time(self, node: ast.Call, name: str) -> None:
        full = self.resolve(name)
        if full.startswith(STDLIB_RNG):
            self.emit("CC-RNG", node,
                      f"{name} — contract randomness is the shared LCG "
                      "(np.random only off the contract surface, §9)")
        elif full.startswith("torch.") and _terminal(full) in TORCH_RNG:
            self.emit("CC-RNG", node,
                      f"{name} — torch's generator; contract randomness "
                      "is the shared LCG (§9)")
        elif self.fused and full.startswith(KEYED_RNG):
            self.emit("CC-RNG", node,
                      f"{name} in a fused scope — fused randomness goes "
                      "through lcg_step/lcg_mod (§9)")
        if name in TIME_CALLS or full in TIME_CALLS:
            self.emit("CC-TIME", node,
                      f"{name} — clock reads are banned on the contract "
                      "surface (simulated time only, §9)")

    # -- CC-FMA ------------------------------------------------------------

    def visit_BinOp(self, node: ast.BinOp) -> None:
        if isinstance(node.op, (ast.Add, ast.Sub)):
            self._check_fma(node, node.left, node.right)
        self._check_assoc_binop(node)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        if isinstance(node.op, (ast.Add, ast.Sub)):
            self._check_fma(node, node.target, node.value)
        self.generic_visit(node)

    def _check_fma(self, at: ast.AST, left: ast.AST, right: ast.AST) -> None:
        if "CC-FMA" not in self.active:
            return
        mul = None
        for side in (left, right):
            if isinstance(side, ast.BinOp) and isinstance(side.op, ast.Mult):
                mul = side
        if mul is None:
            return
        # integer context is exact (the LCG's uint32 arithmetic): any
        # direct operand that is an integer cast exempts the shape
        operands = [left, right, mul.left, mul.right]
        kinds = self.kind_stack[-1]
        if any(_is_int_cast_call(o) or _classify(o, kinds) == "int"
               for o in operands):
            return
        self.emit("CC-FMA", at,
                  "multiply feeding add/sub in one expression — FMA "
                  "contraction hazard; clamp (§9) or split (§11)")

    # -- CC-ASSOC ----------------------------------------------------------

    def _assoc_name(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Name) and node.id in self.cfg.assoc_params:
            return node.id
        if isinstance(node, ast.Attribute) and \
                node.attr in self.cfg.assoc_params:
            return node.attr
        return None

    def _in_resolver(self) -> bool:
        return any(f in self.cfg.resolvers for f in self.func_stack)

    def _check_assoc_call(self, node: ast.Call) -> None:
        if "CC-ASSOC" not in self.active or self._in_resolver():
            return
        if isinstance(node.func, ast.Name) and node.func.id in ("min",
                                                                "max"):
            for arg in node.args:
                p = self._assoc_name(arg)
                if p:
                    self.emit("CC-ASSOC", node,
                              f"{node.func.id}({p}, …) — tile resolution "
                              "outside the shared resolvers (§12)")

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if ("CC-TILE" in self.active and isinstance(node.ctx, ast.Load)
                and node.attr in self.cfg.assoc_params
                and not self._in_resolver()
                and id(node) not in self._tile_ok):
            self.emit("CC-TILE", node,
                      f"raw read of tile field .{node.attr} outside the "
                      "shared resolvers — route through resolve_*/"
                      "resolve_sim_tiles (§16)")
        self.generic_visit(node)

    def _check_assoc_binop(self, node: ast.BinOp) -> None:
        if "CC-ASSOC" not in self.active or self._in_resolver():
            return
        if not isinstance(node.op, (ast.Add, ast.Sub, ast.Mult, ast.Div,
                                    ast.FloorDiv, ast.Mod)):
            return
        for side in (node.left, node.right):
            p = self._assoc_name(side)
            if p:
                self.emit("CC-ASSOC", node,
                          f"arithmetic on {p} outside the shared "
                          "resolvers (§12)")

    def _assoc_default_subst(self, node: ast.AST, test: ast.AST,
                             has_assign: bool) -> None:
        if "CC-ASSOC" not in self.active or self._in_resolver():
            return
        if not (isinstance(test, ast.Compare) and len(test.ops) == 1
                and isinstance(test.ops[0], (ast.Is, ast.IsNot))
                and isinstance(test.comparators[0], ast.Constant)
                and test.comparators[0].value is None):
            return
        p = self._assoc_name(test.left)
        if p and has_assign:
            self.emit("CC-ASSOC", node,
                      f"default substitution of {p} outside the shared "
                      "resolvers (§12)")

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._assoc_default_subst(node, node.test, has_assign=True)
        self.generic_visit(node)

    def visit_If(self, node: ast.If) -> None:
        has_assign = any(isinstance(s, (ast.Assign, ast.AugAssign))
                         for s in node.body)
        self._assoc_default_subst(node, node.test, has_assign)
        self.generic_visit(node)


# -- public entry points ----------------------------------------------------

def check_source(src: str, relpath: str, cfg: CheckConfig,
                 rules: Optional[Sequence[str]] = None,
                 fused: Optional[bool] = None) -> List[Finding]:
    """Lint one source blob.  ``rules``/``fused`` default from the
    config's scope table for ``relpath``."""
    active = list(rules) if rules is not None else cfg.rules_for(relpath)
    if not active:
        return []
    if fused is None:
        fused = any(sc.name == "fused" and relpath in sc.files
                    for sc in cfg.scopes)
    tree = ast.parse(src, filename=relpath)
    checker = _FileChecker(relpath, src, cfg, active, fused,
                           import_map(tree, relpath))
    checker.visit(tree)
    return apply_severity(checker.findings, cfg.severity)


def check_file(path: str, cfg: CheckConfig) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as fh:
        src = fh.read()
    return check_source(src, cfg.relpath(path), cfg)


def check_tree(cfg: CheckConfig,
               paths: Optional[Sequence[str]] = None) -> List[Finding]:
    """Lint every scoped Python file (or the intersection with
    ``paths``)."""
    findings: List[Finding] = []
    for rel in cfg.scoped(paths, (".py",)):
        full = os.path.join(cfg.root, rel)
        if os.path.exists(full):
            findings.extend(check_file(full, cfg))
    return findings
