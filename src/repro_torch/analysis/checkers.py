"""AST checkers for the port's recurring bug classes.

Each checker emits :class:`Violation` records (``file:line CODE message``)
for one failure mode:

========  =============================================================
DET01     hidden constant-seed RNG in library code (``default_rng(0)``,
          ``np.random.seed``, bare stdlib ``random.*`` global state,
          torch's global generator: ``torch.manual_seed``,
          ``torch.randn(...)`` or ``x.normal_()`` without
          ``generator=``, ``Generator().manual_seed(0)``) — repeated
          calls silently share one stream.
MUT01     shared-mutable defaults in function signatures / dataclass
          fields (mutable literals, ``SomethingConfig()`` instances) —
          every caller mutates one shared object.
OVF01     node-id prefix shifts outside the ``descend`` capacity guards
          — int32 ids wrap silently past 31 bits.
TRC01     a kernel library built or loaded per call (``CudaLibrary(``,
          ``TorchOpLibrary(``, ``ctypes.CDLL(``,
          ``torch.ops.load_library(``, ``torch.compile(`` in a function
          that runs per call, outside ``__init__``, a memoized function
          or a lock-and-test once-per-object guard) — every call pays
          the build or the load.
OBS01     hot-path stage methods (ShardSource / ShardExecutor /
          ShardWriter / fit_engine) missing a ``tracer.span`` — stage
          time disappears from the run timeline and the overlap gates.
DEAD01    sampler backends registered but never exercised by any test.
========  =============================================================

Checkers are pure ``ast`` + ``pathlib`` (no torch import) so the lint
runs in a bare Python environment.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Set, Tuple


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding.  ``key`` (file, code, message — no line number) is
    the baseline-matching identity, so a file edit that only moves the
    finding does not churn the baseline."""
    file: str                   # repo-relative posix path
    line: int
    code: str
    message: str

    def render(self) -> str:
        return f"{self.file}:{self.line} {self.code} {self.message}"

    @property
    def key(self) -> Tuple[str, str, str]:
        return (self.file, self.code, self.message)


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _identifiers(node: ast.AST) -> Set[str]:
    """Every Name id / Attribute attr in a subtree."""
    out: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.add(sub.id)
        elif isinstance(sub, ast.Attribute):
            out.add(sub.attr)
    return out


def _is_constant(node: ast.AST) -> bool:
    """Literal-constant expression (incl. tuples/lists of constants)."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, (ast.Tuple, ast.List)):
        return all(_is_constant(e) for e in node.elts)
    if isinstance(node, ast.UnaryOp):
        return _is_constant(node.operand)
    if isinstance(node, ast.BinOp):
        return _is_constant(node.left) and _is_constant(node.right)
    return False


class Checker:
    """Per-file checker.  ``check`` gets the parsed module."""

    code = "?"
    title = "?"

    def check(self, tree: ast.Module, path: str) -> List[Violation]:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# DET01 — hidden constant-seed RNG
# ---------------------------------------------------------------------------

#: stdlib ``random`` module functions that touch the hidden global state
_STDLIB_RANDOM_FNS = {
    "seed", "random", "randint", "randrange", "uniform", "choice",
    "choices", "shuffle", "sample", "gauss", "normalvariate",
    "betavariate", "expovariate", "getrandbits", "triangular",
}

#: legacy numpy global-state samplers (np.random.<fn> without a Generator)
_NP_GLOBAL_FNS = {
    "seed", "rand", "randn", "randint", "random", "choice", "permutation",
    "shuffle", "uniform", "normal", "random_sample",
}

#: seeding torch's hidden global generators
_TORCH_GLOBAL_SEEDS = {"torch.manual_seed", "torch.random.manual_seed",
                       "torch.cuda.manual_seed", "torch.cuda.manual_seed_all"}

#: torch samplers that draw from the global generator without generator=
_TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "normal",
                   "bernoulli", "multinomial"}

#: in-place tensor samplers, same rule
_TORCH_INPLACE_SAMPLERS = {"uniform_", "normal_", "exponential_", "random_",
                           "bernoulli_"}


def _torch_det01(node: ast.Call, name: Optional[str]) -> Optional[str]:
    """The message for a torch flavour of DET01 at ``node``, else None."""
    if name in _TORCH_GLOBAL_SEEDS:
        return (f"{name}() seeds torch's hidden global generator — pass "
                f"generator= to each draw, or use repro_torch.random")
    func = node.func
    if isinstance(func, ast.Attribute) and func.attr == "manual_seed" \
            and node.args and all(_is_constant(a) for a in node.args):
        return ("Generator.manual_seed(<constant seed>) hides a fixed "
                "stream in library code — seed it from the caller")
    if any(k.arg == "generator" for k in node.keywords):
        return None
    tail = (name or "").split(".")
    if len(tail) == 2 and tail[0] == "torch" \
            and tail[1] in _TORCH_SAMPLERS:
        return (f"{name}() draws from torch's hidden global generator — "
                f"pass generator=, or use repro_torch.random")
    if isinstance(func, ast.Attribute) \
            and func.attr in _TORCH_INPLACE_SAMPLERS:
        return (f".{func.attr}() draws from torch's hidden global "
                f"generator — pass generator=, or use repro_torch.random")
    return None


class Det01HiddenSeed(Checker):
    code = "DET01"
    title = "hidden constant-seed RNG in library code"

    def check(self, tree: ast.Module, path: str) -> List[Violation]:
        out: List[Violation] = []
        stdlib_random = any(
            isinstance(n, ast.Import)
            and any(a.name == "random" for a in n.names)
            for n in ast.walk(tree))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            torch_msg = _torch_det01(node, name)
            if torch_msg is not None:
                out.append(Violation(path, node.lineno, self.code,
                                     torch_msg))
                continue
            if name is None:
                continue
            tail = name.split(".")
            # np.random.default_rng(<constant>) / RandomState(<constant>)
            if tail[-1] in ("default_rng", "RandomState") \
                    and "random" in tail and node.args \
                    and all(_is_constant(a) for a in node.args):
                out.append(Violation(
                    path, node.lineno, self.code,
                    f"{name}(<constant seed>) hides a fixed stream in "
                    f"library code — thread a caller-derived rng/key "
                    f"instead (see rmat.derive_thetas)"))
                continue
            # np.random.seed(...) / numpy.random.<legacy global sampler>
            if len(tail) >= 2 and tail[-2] == "random" \
                    and tail[0] in ("np", "numpy") \
                    and tail[-1] in _NP_GLOBAL_FNS:
                out.append(Violation(
                    path, node.lineno, self.code,
                    f"{name}() drives numpy's hidden global RNG state — "
                    f"use an explicit np.random.Generator"))
                continue
            # bare stdlib random.<fn>() — module-global Mersenne state
            if stdlib_random and len(tail) == 2 and tail[0] == "random" \
                    and tail[1] in _STDLIB_RANDOM_FNS:
                out.append(Violation(
                    path, node.lineno, self.code,
                    f"{name}() uses the stdlib global RNG — seed an "
                    f"explicit random.Random/np Generator instead"))
        return out


# ---------------------------------------------------------------------------
# MUT01 — shared-mutable defaults
# ---------------------------------------------------------------------------

_MUT_LITERALS = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
                 ast.SetComp)

#: call defaults that are safe (immutable result or dataclass machinery)
_MUT_ALLOW_CALLS = {"field", "dataclasses.field", "frozenset", "tuple",
                    "MappingProxyType", "types.MappingProxyType"}

#: call defaults that build one shared instance at def time
_MUT_SHARED_CALL = re.compile(r"(?:^|\.)(?:list|dict|set|bytearray)$"
                              r"|(?:Config|Spec|Options|Params)$")


class Mut01SharedMutableDefault(Checker):
    code = "MUT01"
    title = "shared-mutable default in signature/dataclass"

    def _flag_default(self, node: ast.AST, path: str,
                      where: str) -> Optional[Violation]:
        if isinstance(node, _MUT_LITERALS):
            return Violation(
                path, node.lineno, self.code,
                f"mutable literal default in {where} is shared across "
                f"every call — use None + construct inside, or "
                f"dataclasses.field(default_factory=...)")
        if isinstance(node, ast.Call):
            name = _dotted(node.func) or ""
            if name in _MUT_ALLOW_CALLS:
                return None
            if _MUT_SHARED_CALL.search(name):
                return Violation(
                    path, node.lineno, self.code,
                    f"default {name}(...) in {where} builds ONE shared "
                    f"instance at def time — every caller mutates the "
                    f"same object (use default_factory / None)")
        return None

    def check(self, tree: ast.Module, path: str) -> List[Violation]:
        out: List[Violation] = []
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defaults = list(node.args.defaults) + [
                    d for d in node.args.kw_defaults if d is not None]
                for d in defaults:
                    v = self._flag_default(d, path,
                                           f"def {node.name}(...)")
                    if v is not None:
                        out.append(v)
            elif isinstance(node, ast.ClassDef):
                is_dc = any("dataclass" in (_dotted(
                    d.func if isinstance(d, ast.Call) else d) or "")
                    for d in node.decorator_list)
                if not is_dc:
                    continue
                for stmt in node.body:
                    if isinstance(stmt, ast.AnnAssign) \
                            and stmt.value is not None:
                        v = self._flag_default(
                            stmt.value, path,
                            f"dataclass {node.name} field")
                        if v is not None:
                            out.append(v)
        return out


# ---------------------------------------------------------------------------
# OVF01 — unguarded node-id prefix shifts
# ---------------------------------------------------------------------------

#: calling one of these counts as overflow-guard evidence.  Deliberately
#: only the *capacity* guards: combine_ids/narrow_ids are representation
#: helpers — a function can call them on one branch and still push an
#: unguarded prefix shift on another (exactly how the fused narrow path
#: slipped through review).
_OVF_GUARDS = {"check_id_capacity", "id_capacity", "default_id_dtype",
               "_check_capacity", "_edge_dtype"}

_OVF_NAME = re.compile(r"prefix|node_id")


def _shift_operand_matches(node: ast.AST) -> bool:
    return any(_OVF_NAME.search(ident) for ident in _identifiers(node))


class Ovf01UnguardedIdShift(Checker):
    code = "OVF01"
    title = "node-id shift without a capacity guard"

    def check(self, tree: ast.Module, path: str) -> List[Violation]:
        if path.replace("\\", "/").endswith("core/descend.py"):
            return []           # the guard module itself
        out: List[Violation] = []
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name in _OVF_GUARDS:
                continue
            guarded = any(
                isinstance(n, ast.Call)
                and (_dotted(n.func) or "").split(".")[-1] in _OVF_GUARDS
                for n in ast.walk(fn))
            if guarded:
                continue
            for n in ast.walk(fn):
                if isinstance(n, ast.BinOp) \
                        and isinstance(n.op, ast.LShift) \
                        and (_shift_operand_matches(n.left)
                             or _shift_operand_matches(n.right)):
                    out.append(Violation(
                        path, n.lineno, self.code,
                        f"node-id prefix shift in {fn.name}() without a "
                        f"capacity guard — int32 ids wrap silently past "
                        f"31 bits; call descend.check_id_capacity or "
                        f"route through combine_ids/narrow_ids"))
        return out


# ---------------------------------------------------------------------------
# TRC01 — a kernel library built or loaded per call
# ---------------------------------------------------------------------------

#: calls that build, load or compile a kernel library
_TRC_BUILDERS = {"ctypes.CDLL", "CDLL", "torch.ops.load_library",
                 "torch.compile"}
_TRC_LIBRARY_TYPES = {"CudaLibrary", "TorchOpLibrary"}


def _is_builder(name: Optional[str]) -> bool:
    return name is not None and (
        name in _TRC_BUILDERS
        or name.split(".")[-1] in _TRC_LIBRARY_TYPES)


def _reads_self_attr(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
               and n.value.id == "self" for n in ast.walk(node))


def _is_lock(item: ast.withitem) -> bool:
    return "lock" in (_dotted(item.context_expr) or "").lower()


class Trc01PerCallBuild(Checker):
    """The port compiles nothing per call: its kernels are libraries that
    ``kernels/_build`` builds once with ``nvcc`` and loads once a
    process.  A library made or loaded inside a function that runs per
    call pays that on every call."""

    code = "TRC01"
    title = "kernel library built or loaded per call"

    def check(self, tree: ast.Module, path: str) -> List[Violation]:
        out: List[Violation] = []
        parents = {child: parent for parent in ast.walk(tree)
                   for child in ast.iter_child_nodes(parent)}

        def enclosing(node, kinds):
            cur = parents.get(node)
            while cur is not None and not isinstance(cur, kinds):
                cur = parents.get(cur)
            return cur

        def once_per_object(node: ast.AST, fn: ast.AST) -> bool:
            """Under an ``if`` that tests a ``self.`` attribute (``self._lib
            is None``, ``not self._loaded``) inside a ``with <lock>:``."""
            tested = False
            cur = parents.get(node)
            while cur is not None and cur is not fn:
                if isinstance(cur, ast.If) and _reads_self_attr(cur.test):
                    tested = True
                elif isinstance(cur, ast.With) and tested \
                        and any(_is_lock(i) for i in cur.items):
                    return True
                cur = parents.get(cur)
            return False

        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            if not _is_builder(name):
                continue
            fn = enclosing(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            if fn is None:
                continue        # module/class level: once per import
            # outermost enclosing function decides the call frequency
            outer = fn
            while True:
                nxt = enclosing(outer,
                                (ast.FunctionDef, ast.AsyncFunctionDef))
                if nxt is None:
                    break
                outer = nxt
            if outer.name == "__init__":
                continue        # once per object — not per call
            deco_names = " ".join(
                _dotted(d.func if isinstance(d, ast.Call) else d) or ""
                for d in outer.decorator_list)
            if "lru_cache" in deco_names or deco_names.endswith("cache"):
                continue        # memoized
            if once_per_object(node, fn):
                continue
            out.append(Violation(
                path, node.lineno, self.code,
                f"{name}() inside {outer.name}() builds or loads a kernel "
                f"library on every call — make it once (module level, "
                f"__init__, a memoized function, or a lock and a "
                f"once-per-object test as in kernels/_build.CudaLibrary."
                f"lib); the audit `python -m repro_torch.analysis.retrace` "
                f"measures this at runtime"))
        return out


# ---------------------------------------------------------------------------
# OBS01 — hot-path stage without a tracer span
# ---------------------------------------------------------------------------

#: default hot surface: (path suffix, method/function names that are a
#: pipeline stage and must report into the run timeline)
_OBS_HOT_DEFAULT: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("datastream/source.py", ("generate", "sample_for_shard",
                              "align_for_shard")),
    ("datastream/executor.py", ("run",)),
    ("datastream/writer.py", ("write_shard", "checkpoint")),
    ("core/fit_engine.py", ("accumulate",)),
)


class Obs01MissingSpan(Checker):
    code = "OBS01"
    title = "hot-path stage method without a tracer.span"

    def __init__(self, hot: Optional[Sequence[Tuple[str, Sequence[str]]]]
                 = None):
        self.hot = tuple((suf, tuple(names)) for suf, names in
                         (hot if hot is not None else _OBS_HOT_DEFAULT))

    @staticmethod
    def _has_span(fn: ast.AST) -> bool:
        return any(isinstance(n, ast.Call)
                   and isinstance(n.func, ast.Attribute)
                   and n.func.attr == "span"
                   for n in ast.walk(fn))

    @staticmethod
    def _is_abstract(fn: ast.FunctionDef) -> bool:
        body = [s for s in fn.body
                if not (isinstance(s, ast.Expr)
                        and isinstance(s.value, ast.Constant))]
        return len(body) <= 1 and all(
            isinstance(s, (ast.Raise, ast.Pass)) for s in body)

    def check(self, tree: ast.Module, path: str) -> List[Violation]:
        norm = path.replace("\\", "/")
        names: Tuple[str, ...] = ()
        for suffix, hot_names in self.hot:
            if norm.endswith(suffix):
                names = tuple(hot_names)
                break
        if not names:
            return []
        out: List[Violation] = []
        # span-reachability one class at a time: a hot method may
        # delegate to self._helper() that holds the actual span
        scopes: List[Tuple[Optional[ast.ClassDef], List[ast.FunctionDef]]]
        scopes = [(None, [n for n in tree.body
                          if isinstance(n, ast.FunctionDef)])]
        scopes += [(n, [m for m in n.body
                        if isinstance(m, ast.FunctionDef)])
                   for n in tree.body if isinstance(n, ast.ClassDef)]
        for cls, fns in scopes:
            by_name = {f.name: f for f in fns}

            def reachable_span(fn: ast.FunctionDef,
                               seen: Set[str]) -> bool:
                if self._has_span(fn):
                    return True
                seen.add(fn.name)
                for n in ast.walk(fn):
                    if not isinstance(n, ast.Call):
                        continue
                    callee = _dotted(n.func) or ""
                    tail = callee.split(".")[-1]
                    if callee.startswith("self.") or callee == tail:
                        nxt = by_name.get(tail)
                        if nxt is not None and nxt.name not in seen \
                                and reachable_span(nxt, seen):
                            return True
                return False

            for fn in fns:
                if fn.name not in names or self._is_abstract(fn):
                    continue
                if not reachable_span(fn, set()):
                    where = (f"{cls.name}.{fn.name}" if cls is not None
                             else fn.name)
                    out.append(Violation(
                        path, fn.lineno, self.code,
                        f"hot-path stage {where}() has no tracer.span — "
                        f"its time is invisible to the run timeline and "
                        f"the overlap gates"))
        return out


# ---------------------------------------------------------------------------
# DEAD01 — registered backends never exercised by tests (repo-level)
# ---------------------------------------------------------------------------

class Dead01UnexercisedBackend:
    """Repo-level checker (one run per lint invocation, not per file):
    every sampler backend registered in ``core/sampler.py`` must appear
    (quoted) somewhere under ``tests/`` — the weakest possible liveness
    bar (the port's backends: ``reference``, ``cuda_bits``,
    ``cuda_prng``)."""

    code = "DEAD01"
    title = "registered sampler backend never exercised by tests"

    def __init__(self,
                 registry_rel: str = "src/repro_torch/core/sampler.py",
                 tests_rel: str = "tests"):
        self.registry_rel = registry_rel
        self.tests_rel = tests_rel

    def _backend_names(self, tree: ast.Module) -> List[Tuple[str, int]]:
        names: List[Tuple[str, int]] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            bases = {(_dotted(b) or "").split(".")[-1]
                     for b in node.bases}
            if not any(b.endswith("Backend") for b in bases):
                continue
            for stmt in node.body:
                if isinstance(stmt, ast.Assign) \
                        and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name) \
                        and stmt.targets[0].id == "name" \
                        and isinstance(stmt.value, ast.Constant) \
                        and isinstance(stmt.value.value, str) \
                        and stmt.value.value not in ("?", "base"):
                    names.append((stmt.value.value, stmt.lineno))
        return names

    def check_repo(self, root: Path) -> List[Violation]:
        reg = root / self.registry_rel
        if not reg.exists():
            return []
        tree = ast.parse(reg.read_text(encoding="utf-8"))
        tests_dir = root / self.tests_rel
        corpus = "\n".join(
            p.read_text(encoding="utf-8", errors="replace")
            for p in sorted(tests_dir.rglob("*.py"))) \
            if tests_dir.exists() else ""
        out: List[Violation] = []
        for name, line in self._backend_names(tree):
            if f'"{name}"' in corpus or f"'{name}'" in corpus:
                continue
            out.append(Violation(
                self.registry_rel, line, self.code,
                f"backend '{name}' is registered but never exercised by "
                f"any test under {self.tests_rel}/ — dead code until a "
                f"smoke test runs it (its plain version on the CPU counts)"))
        return out


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def all_checkers() -> List[Checker]:
    """The per-file checker set (DEAD01 is repo-level, see lint.py)."""
    return [Det01HiddenSeed(), Mut01SharedMutableDefault(),
            Ovf01UnguardedIdShift(), Trc01PerCallBuild(),
            Obs01MissingSpan()]


RULES = {
    "DET01": Det01HiddenSeed.title,
    "MUT01": Mut01SharedMutableDefault.title,
    "OVF01": Ovf01UnguardedIdShift.title,
    "TRC01": Trc01PerCallBuild.title,
    "OBS01": Obs01MissingSpan.title,
    "DEAD01": Dead01UnexercisedBackend.title,
}


def check_file(path: Path, rel: str,
               checkers: Optional[Iterable[Checker]] = None
               ) -> List[Violation]:
    """Run the per-file checkers on one source file."""
    try:
        tree = ast.parse(path.read_text(encoding="utf-8"))
    except SyntaxError as e:
        return [Violation(rel, e.lineno or 0, "PARSE",
                          f"syntax error: {e.msg}")]
    out: List[Violation] = []
    for ch in (checkers if checkers is not None else all_checkers()):
        out.extend(ch.check(tree, rel))
    return sorted(out, key=lambda v: (v.line, v.code))
