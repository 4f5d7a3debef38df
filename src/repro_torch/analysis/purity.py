"""Purity / jit-safety lint: the repo-wide AST pass.

JAX traces a jitted function once and replays the jaxpr; anything the
Python body reads besides its arguments is frozen at trace time.  The
engine is built on that contract — this pass checks the whole source
tree stays inside it.  It is the reference's lint, rule for rule, so any
source gets the reference's verdict.  This package traces nothing (no
``jax.jit``, ``torch.compile`` or CUDA-graph capture), so over its own
tree PUR001, PUR002 and PUR004 have no subject and PUR003 is the rule that
applies: the ``*_int`` functions (``core/neuron.py`` ``neuron_step_int``,
the integer kernels' wrappers ``fused_lif_gemm_int`` and
``lif_step_fused_int``) stay closed under integer ops.

  * **PUR001** a jit-context function calls a host-side impure API —
    wall clocks (``time.*``), host randomness (``random.*``,
    ``numpy.random.*``, ``os.urandom``, ``secrets``/``uuid``) or
    ``datetime`` — whose value would be baked into the trace.
    ``jax.random`` is functional and explicitly safe; import aliases are
    resolved so ``from jax import random`` doesn't trip the stdlib rule.
  * **PUR002** a jit-context function reads a module-level *mutable*
    global (a ``list``/``dict``/``set`` binding): its contents at trace
    time silently become compile-time constants.
  * **PUR003** an integer-engine function (name ending ``_int`` — the
    bit-exact datapath convention) contains float arithmetic: a true
    division, a float literal, a float dtype reference or a ``float()``
    cast.  The integer engine must be closed under integer ops to stay
    bit-identical with the silicon.
  * **PUR004** a *leafless* pytree registration — flatten of the form
    ``lambda s: ((), s)``, which makes the whole object static/hashable
    trace metadata — of a class that is not a frozen dataclass with
    (recursively) immutable fields.  A mutable leafless pytree breaks
    jit caching: equal-looking schedules hash differently, or worse,
    mutate after being baked into a trace.

Jit contexts are found syntactically: functions decorated with
``jax.jit`` (bare or under ``functools.partial``) plus same-module
functions whose *names* are passed into a ``jax.jit(...)`` call
(covering the ``self._step = jax.jit(step)`` idiom in the streaming
engine).  The pass is deliberately intra-module — no cross-module call
graph — which keeps it fast and its findings exact.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterable, List, Optional

from .report import AnalysisReport, Violation

__all__ = [
    "check_purity",
    "check_module_purity",
]

#: Dotted-call prefixes whose results are host-side entropy or wall time.
IMPURE_PREFIXES = (
    "time.",
    "random.",
    "numpy.random.",
    "datetime.",
    "secrets.",
    "uuid.",
)
IMPURE_EXACT = ("os.urandom",)

#: Explicitly functional/safe namespaces (checked before the impure list).
SAFE_PREFIXES = ("jax.random.", "jax.")

_FLOAT_DTYPES = ("float16", "float32", "float64", "bfloat16")
_IMMUTABLE_NAMES = {
    "int", "float", "str", "bool", "bytes", "complex", "tuple", "Tuple",
    "frozenset", "FrozenSet", "None", "NoneType", "object", "Ellipsis",
}
_MUTABLE_NAMES = {
    "list", "List", "dict", "Dict", "set", "Set", "bytearray",
    "defaultdict", "OrderedDict", "deque", "Counter",
}
#: Generic wrappers whose type arguments carry the mutability question.
_TRANSPARENT_GENERICS = {
    "tuple", "Tuple", "Optional", "Union", "frozenset", "FrozenSet",
    "ClassVar", "Final",
}


def _dotted(node: ast.AST) -> Optional[str]:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _resolve(dotted: Optional[str], aliases: Dict[str, str]) -> Optional[str]:
    """Rewrite a dotted name's first segment through the import aliases."""
    if dotted is None:
        return None
    head, _, rest = dotted.partition(".")
    real = aliases.get(head, head)
    return f"{real}.{rest}" if rest else real


def _import_aliases(tree: ast.Module) -> Dict[str, str]:
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.partition(".")[0]] = (
                    a.name if a.asname else a.name.partition(".")[0])
        elif isinstance(node, ast.ImportFrom):
            # Relative imports resolve inside the package — they can never
            # be the stdlib entropy/time modules, so prefix with "." to
            # keep them out of the impure namespace.
            base = ("." * node.level) + (node.module or "")
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = (
                    f"{base}.{a.name}" if base else a.name)
    return aliases


# ---------------------------------------------------------------------------
# Jit-context discovery.
# ---------------------------------------------------------------------------
def _is_jit(dotted: Optional[str], aliases: Dict[str, str]) -> bool:
    return _resolve(dotted, aliases) in ("jax.jit", "jax.pmap")


def _decorated_jit(fn: ast.AST, aliases: Dict[str, str]) -> bool:
    for dec in getattr(fn, "decorator_list", ()):
        if _is_jit(_dotted(dec), aliases):
            return True
        if isinstance(dec, ast.Call):
            if _is_jit(_dotted(dec.func), aliases):
                return True
            # @functools.partial(jax.jit, static_argnames=...)
            if _resolve(_dotted(dec.func), aliases) in (
                    "functools.partial", "partial"):
                if any(_is_jit(_dotted(a), aliases) for a in dec.args):
                    return True
    return False


def _jit_call_names(tree: ast.Module, aliases: Dict[str, str]) -> set:
    """Names passed (possibly through ``partial``) into ``jax.jit(...)``."""
    names: set = set()

    def collect(node: ast.AST) -> None:
        if isinstance(node, ast.Name):
            names.add(node.id)
        elif isinstance(node, ast.Call):
            for a in node.args:
                collect(a)

    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _is_jit(_dotted(node.func), aliases):
            for a in node.args:
                collect(a)
    return names


# ---------------------------------------------------------------------------
# Mutable module globals.
# ---------------------------------------------------------------------------
def _mutable_globals(tree: ast.Module, aliases: Dict[str, str]) -> set:
    out: set = set()
    for stmt in tree.body:
        targets: List[ast.expr] = []
        value: Optional[ast.expr] = None
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        if value is None:
            continue
        mutable = isinstance(value, (ast.List, ast.Dict, ast.Set,
                                     ast.ListComp, ast.DictComp, ast.SetComp))
        if isinstance(value, ast.Call):
            callee = _resolve(_dotted(value.func), aliases)
            mutable = callee is not None and (
                callee.rpartition(".")[2] in _MUTABLE_NAMES)
        if mutable:
            for t in targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


# ---------------------------------------------------------------------------
# Per-function checks.
# ---------------------------------------------------------------------------
def _local_names(fn: ast.AST) -> set:
    """Parameter and locally-assigned names (shadow module globals)."""
    names: set = set()
    args = getattr(fn, "args", None)
    if args is not None:
        for a in (args.posonlyargs + args.args + args.kwonlyargs
                  + ([args.vararg] if args.vararg else [])
                  + ([args.kwarg] if args.kwarg else [])):
            names.add(a.arg)
    for node in ast.walk(fn):
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                for leaf in ast.walk(t):
                    if isinstance(leaf, ast.Name):
                        names.add(leaf.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, (ast.For, ast.comprehension)):
            for leaf in ast.walk(node.target):
                if isinstance(leaf, ast.Name):
                    names.add(leaf.id)
    return names


def _check_jit_body(fn: "ast.FunctionDef | ast.AsyncFunctionDef",
                    aliases: Dict[str, str], mutables: set,
                    filename: str, violations: list) -> None:
    locals_ = _local_names(fn)
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            callee = _resolve(_dotted(node.func), aliases)
            if callee is None:
                continue
            if any(callee.startswith(p) for p in SAFE_PREFIXES):
                continue
            if callee in IMPURE_EXACT or any(
                    callee.startswith(p) for p in IMPURE_PREFIXES):
                violations.append(Violation(
                    pass_name="purity", code="PUR001",
                    location=f"{filename}:{node.lineno}",
                    message=(
                        f"{fn.name} is traced under jax.jit but calls "
                        f"{callee}() — host-side time/randomness is frozen "
                        "into the trace at compile time")))
        elif (isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load)
                and node.id in mutables and node.id not in locals_):
            violations.append(Violation(
                pass_name="purity", code="PUR002",
                location=f"{filename}:{node.lineno}",
                message=(
                    f"{fn.name} is traced under jax.jit but reads the "
                    f"mutable module global {node.id!r} — its trace-time "
                    "contents silently become compile-time constants")))


def _check_int_fn(fn: "ast.FunctionDef | ast.AsyncFunctionDef",
                  aliases: Dict[str, str], filename: str,
                  violations: list) -> None:
    def flag(node: ast.AST, what: str) -> None:
        violations.append(Violation(
            pass_name="purity", code="PUR003",
            location=f"{filename}:{node.lineno}",
            message=(
                f"{fn.name} is an integer-engine function (``*_int``) but "
                f"contains {what} — the bit-exact datapath must be closed "
                "under integer arithmetic")))

    for node in ast.walk(fn):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            flag(node, "a true division (`/`)")
        elif isinstance(node, ast.Constant) and isinstance(node.value, float):
            flag(node, f"the float literal {node.value!r}")
        elif isinstance(node, ast.Attribute) and node.attr in _FLOAT_DTYPES:
            flag(node, f"a {node.attr} dtype reference")
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "float"):
            flag(node, "a float() cast")


# ---------------------------------------------------------------------------
# Leafless pytree registrations vs the dataclass registry.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _DataclassInfo:
    name: str
    filename: str
    lineno: int
    frozen: bool
    fields: tuple  # of (field_name, annotation ast | None)


def _dataclass_registry(trees: Dict[str, ast.Module]) -> Dict[str, _DataclassInfo]:
    registry: Dict[str, _DataclassInfo] = {}
    for filename, tree in trees.items():
        aliases = _import_aliases(tree)
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            frozen = None
            for dec in node.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                if _resolve(_dotted(target), aliases) in (
                        "dataclasses.dataclass", "dataclass"):
                    frozen = False
                    if isinstance(dec, ast.Call):
                        for kw in dec.keywords:
                            if kw.arg == "frozen" and isinstance(
                                    kw.value, ast.Constant):
                                frozen = bool(kw.value.value)
            if frozen is None:
                continue
            fields = tuple(
                (stmt.target.id, stmt.annotation)
                for stmt in node.body
                if isinstance(stmt, ast.AnnAssign)
                and isinstance(stmt.target, ast.Name))
            registry[node.name] = _DataclassInfo(
                node.name, filename, node.lineno, frozen, fields)
    return registry


def _annotation_mutable(ann: Optional[ast.AST],
                        registry: Dict[str, _DataclassInfo],
                        seen: set) -> Optional[str]:
    """Reason the annotation admits mutable values, or None if immutable.

    Unknown names are treated as immutable (lenient): the pass flags what
    it can prove, not what it cannot classify.
    """
    if ann is None:
        return None
    if isinstance(ann, ast.Constant):
        if isinstance(ann.value, str):
            try:
                ann = ast.parse(ann.value, mode="eval").body
            except SyntaxError:
                return None
        else:
            return None
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        return (_annotation_mutable(ann.left, registry, seen)
                or _annotation_mutable(ann.right, registry, seen))
    if isinstance(ann, ast.Subscript):
        base = _dotted(ann.value)
        base = base.rpartition(".")[2] if base else None
        if base in _MUTABLE_NAMES:
            return f"{base}[...]"
        if base in _TRANSPARENT_GENERICS:
            inner = ann.slice
            elts = inner.elts if isinstance(inner, ast.Tuple) else [inner]
            for e in elts:
                reason = _annotation_mutable(e, registry, seen)
                if reason:
                    return reason
        return None
    name = _dotted(ann)
    name = name.rpartition(".")[2] if name else None
    if name is None:
        return None
    if name in _MUTABLE_NAMES:
        return name
    if name in _IMMUTABLE_NAMES:
        return None
    info = registry.get(name)
    if info is not None and name not in seen:
        return _class_mutable(info, registry, seen | {name})
    return None


def _class_mutable(info: _DataclassInfo, registry: Dict[str, _DataclassInfo],
                   seen: set) -> Optional[str]:
    if not info.frozen:
        return f"{info.name} is not frozen"
    for fname, ann in info.fields:
        reason = _annotation_mutable(ann, registry, seen)
        if reason:
            return f"{info.name}.{fname}: {reason}"
    return None


def _check_pytree_registrations(filename: str, tree: ast.Module,
                                registry: Dict[str, _DataclassInfo],
                                violations: list) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or len(node.args) < 2:
            continue
        callee = _dotted(node.func)
        if callee is None or not callee.endswith("register_pytree_node"):
            continue
        cls_arg, flatten = node.args[0], node.args[1]
        # Leafless flatten: ``lambda s: ((), s)`` — no leaves, the whole
        # object rides in the static half of the pytree.
        leafless = (
            isinstance(flatten, ast.Lambda)
            and isinstance(flatten.body, ast.Tuple)
            and len(flatten.body.elts) == 2
            and isinstance(flatten.body.elts[0], ast.Tuple)
            and not flatten.body.elts[0].elts)
        if not leafless:
            continue
        dotted_cls = _dotted(cls_arg)
        cls_name = dotted_cls.rpartition(".")[2] if dotted_cls else "<unknown>"
        info = registry.get(cls_name)
        if info is None:
            violations.append(Violation(
                pass_name="purity", code="PUR004",
                location=f"{filename}:{node.lineno}",
                message=(
                    f"{cls_name} is registered as a leafless (static) "
                    "pytree but is not a dataclass this pass can verify — "
                    "static pytree nodes must be frozen dataclasses with "
                    "immutable fields")))
            continue
        reason = _class_mutable(info, registry, {cls_name})
        if reason:
            violations.append(Violation(
                pass_name="purity", code="PUR004",
                location=f"{filename}:{node.lineno}",
                message=(
                    f"{cls_name} is registered as a leafless (static) "
                    f"pytree but is mutable: {reason} — equal schedules "
                    "must hash equal and never change after tracing")))


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------
def check_module_purity(source: str, filename: str,
                        registry: Optional[Dict[str, _DataclassInfo]] = None,
                        ) -> AnalysisReport:
    """Lint one module (PUR001–PUR003; PUR004 too when given a registry)."""
    tree = ast.parse(source, filename=filename)
    aliases = _import_aliases(tree)
    mutables = _mutable_globals(tree, aliases)
    jit_names = _jit_call_names(tree, aliases)
    violations: list = []

    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if _decorated_jit(node, aliases) or node.name in jit_names:
            _check_jit_body(node, aliases, mutables, filename, violations)
        if node.name.endswith("_int"):
            _check_int_fn(node, aliases, filename, violations)

    if registry is None:
        registry = _dataclass_registry({filename: tree})
    _check_pytree_registrations(filename, tree, registry, violations)
    return AnalysisReport(
        subject=filename,
        passes=("purity",),
        violations=tuple(violations),
    )


def _package_sources(root: Optional[str]) -> Dict[str, str]:
    if root is None:
        # This package's root: the ``repro_torch`` tree.
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sources: Dict[str, str] = {}
    for dirpath, _dirnames, filenames in os.walk(root):
        for f in sorted(filenames):
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path, encoding="utf-8") as fh:
                    sources[os.path.relpath(path)] = fh.read()
    return sources


def check_purity(paths: Optional[Iterable[str]] = None,
                 root: Optional[str] = None) -> AnalysisReport:
    """Run the purity lint repo-wide (default: the ``repro_torch`` package).

    The dataclass registry is built over *all* scanned modules first so
    PUR004 can chase field annotations across files (``CoreSchedule`` →
    ``CoreGrid``/``QuantSpec``), then each module is linted against it.
    """
    if paths is not None:
        sources = {}
        for path in paths:
            with open(path, encoding="utf-8") as f:
                sources[os.path.relpath(path)] = f.read()
    else:
        sources = _package_sources(root)
    trees = {fn: ast.parse(src, filename=fn) for fn, src in sources.items()}
    registry = _dataclass_registry(trees)
    report = AnalysisReport(subject="repro_torch (purity)", passes=("purity",))
    for fn, src in sources.items():
        report = report.merge(check_module_purity(src, fn, registry))
    return report
