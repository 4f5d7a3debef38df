"""Concurrency lint for the serving tier: lock discipline + thread stress.

The fleet's threading contract (``repro_torch.serving.fleet``, the
reference's): :class:`Fleet` owns the single ``self._lock`` (an RLock);
every mutation of fleet state happens under it, either lexically (``with
self._lock:``) or inside a private helper whose *every* call site holds
the lock; and nothing blocks while holding it — the replica loop ticks the
engine *outside* the lock (its kernel launches release the GIL, each
replica on its own CUDA stream) precisely so replicas overlap.  ``SessionScheduler`` and the workers
deliberately carry no lock of their own: they are only ever touched under
the fleet's (or before its threads start), which is why the static check
scopes to lock-owning classes and the dynamic harness covers the rest.

Static pass (:func:`check_lock_discipline`) — pure AST, per class that
assigns ``self._lock``:

  * **CON001** a method (other than ``__init__``/``__post_init__``)
    writes a ``self.*`` field (attribute or ``self.x[...]`` subscript)
    without holding the lock — neither inside a lexical ``with
    self._lock`` nor in a private helper whose call sites all hold it
    (computed to a fixpoint over the intra-class call graph; a method
    referenced without being called, e.g. ``Thread(target=self._loop)``,
    counts as an unlocked entry point).
  * **CON002** a blocking call — ``time.sleep``, a thread ``join()``
    (zero positional args, distinguishing it from ``str.join``), or an
    event ``.wait()`` — is reachable while the lock is held.

Dynamic harness (:func:`stress_fleet`) — the seeded cross-check the
static pass cannot give: the same deterministic submissions are served
through a sync fleet and a threaded fleet, and every stream's readout and
cycle attribution must match byte for byte regardless of thread
interleaving.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Iterable, Optional

from .report import AnalysisReport, Violation

__all__ = [
    "StressResult",
    "check_lock_discipline",
    "check_serving",
    "stress_fleet",
]

LOCK_ATTR = "_lock"
_INIT_METHODS = ("__init__", "__post_init__")
_BLOCKING_DOTTED = ("time.sleep",)
_BLOCKING_ATTRS = ("wait",)        # Event.wait / Condition.wait


def _is_self_attr(node: ast.AST, attr: Optional[str] = None) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and (attr is None or node.attr == attr))


def _dotted(node: ast.AST) -> Optional[str]:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclasses.dataclass
class _Site:
    """One fact collected from a method body, with its lock context."""

    line: int
    locked: bool          # lexically inside ``with self._lock``
    detail: str


class _MethodFacts(ast.NodeVisitor):
    """Walk one method body tracking the lexical lock depth."""

    def __init__(self, method_names: set):
        self.method_names = method_names
        self.depth = 0
        self.writes: list = []        # _Site(detail=attr written)
        self.calls: list = []         # _Site(detail=self-method called)
        self.refs: list = []          # _Site(detail=self-method referenced)
        self.blocking: list = []      # _Site(detail=blocking call)

    # -- lock scoping ------------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        holds = any(_is_self_attr(item.context_expr, LOCK_ATTR)
                    for item in node.items)
        for item in node.items:
            self.visit(item)
        self.depth += 1 if holds else 0
        for stmt in node.body:
            self.visit(stmt)
        self.depth -= 1 if holds else 0

    # -- writes ------------------------------------------------------------
    def _record_write_target(self, target: ast.AST, line: int) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._record_write_target(elt, line)
            return
        if isinstance(target, ast.Starred):
            self._record_write_target(target.value, line)
            return
        node = target
        if isinstance(node, ast.Subscript):
            node = node.value
        if _is_self_attr(node) and node.attr != LOCK_ATTR:
            self.writes.append(_Site(line, self.depth > 0, node.attr))

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._record_write_target(t, node.lineno)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_write_target(node.target, node.lineno)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self._record_write_target(node.target, node.lineno)
        if node.value is not None:
            self.visit(node.value)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._record_write_target(t, node.lineno)

    # -- calls / refs ------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        locked = self.depth > 0
        if _is_self_attr(node.func) and node.func.attr in self.method_names:
            self.calls.append(_Site(node.lineno, locked, node.func.attr))
        dotted = _dotted(node.func)
        if dotted in _BLOCKING_DOTTED:
            self.blocking.append(_Site(node.lineno, locked, f"{dotted}()"))
        elif isinstance(node.func, ast.Attribute) \
                and not _is_self_attr(node.func):
            # ``x.join()`` with no positional args is a thread join;
            # ``sep.join(parts)`` (str.join) always passes the iterable.
            if node.func.attr == "join" and not node.args:
                self.blocking.append(
                    _Site(node.lineno, locked, ".join()"))
            elif node.func.attr in _BLOCKING_ATTRS:
                self.blocking.append(
                    _Site(node.lineno, locked, f".{node.func.attr}()"))
        # Arguments may reference methods (entry points) — visit children
        # but skip re-recording the func attribute as a bare reference.
        for child in list(node.args) + [kw.value for kw in node.keywords]:
            self.visit(child)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if _is_self_attr(node) and node.attr in self.method_names:
            self.refs.append(_Site(node.lineno, self.depth > 0, node.attr))
        self.visit(node.value)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        # A lambda body inherits the lock state at its definition site (the
        # fleet only defines them for immediate use).
        self.visit(node.body)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # Nested defs inherit the lexical lock state at the def site.
        for stmt in node.body:
            self.visit(stmt)


def _check_class(cls: ast.ClassDef, filename: str,
                 violations: list) -> None:
    methods = {n.name: n for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    owns_lock = any(
        _is_self_attr(t, LOCK_ATTR)
        for m in methods.values()
        for stmt in ast.walk(m)
        if isinstance(stmt, ast.Assign)
        for t in stmt.targets)
    if not owns_lock:
        return

    facts = {}
    for name, m in methods.items():
        f = _MethodFacts(set(methods))
        for stmt in m.body:
            f.visit(stmt)
        facts[name] = f

    # Fixpoint: a private helper is lock-held iff it has at least one call
    # site and every call site (and bare reference) holds the lock —
    # lexically or by being inside another lock-held helper.
    locked_methods: set = set()
    changed = True
    while changed:
        changed = False
        for name in methods:
            if name in locked_methods or not name.startswith("_") \
                    or name.startswith("__"):
                continue
            sites = []
            for caller, f in facts.items():
                for site in f.calls + f.refs:
                    if site.detail == name:
                        sites.append(site.locked
                                     or caller in locked_methods)
            if sites and all(sites):
                locked_methods.add(name)
                changed = True

    for name, f in facts.items():
        held = name in locked_methods
        if name not in _INIT_METHODS:
            for w in f.writes:
                if not (w.locked or held):
                    violations.append(Violation(
                        pass_name="concurrency", code="CON001",
                        location=f"{filename}:{w.line}",
                        message=(
                            f"{cls.name}.{name} writes self.{w.detail} "
                            f"without holding self.{LOCK_ATTR}")))
        for b in f.blocking:
            if b.locked or held:
                violations.append(Violation(
                    pass_name="concurrency", code="CON002",
                    location=f"{filename}:{b.line}",
                    message=(
                        f"{cls.name}.{name} calls {b.detail} while "
                        f"holding self.{LOCK_ATTR} — blocking under the "
                        "fleet lock stalls every replica")))


def check_lock_discipline(source: str, filename: str) -> AnalysisReport:
    """Lint one module's lock-owning classes (see module docstring)."""
    violations: list = []
    tree = ast.parse(source, filename=filename)
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            _check_class(node, filename, violations)
    return AnalysisReport(
        subject=filename,
        passes=("concurrency",),
        violations=tuple(violations),
    )


def check_serving(paths: Optional[Iterable[str]] = None) -> AnalysisReport:
    """Run the lock-discipline lint over ``repro_torch.serving`` (or
    ``paths``)."""
    if paths is None:
        from .. import serving

        pkg_dir = os.path.dirname(os.path.abspath(serving.__file__))
        paths = sorted(
            os.path.join(pkg_dir, f) for f in os.listdir(pkg_dir)
            if f.endswith(".py"))
    report = AnalysisReport(subject="repro_torch.serving",
                            passes=("concurrency",))
    for path in paths:
        with open(path, encoding="utf-8") as f:
            source = f.read()
        rel = os.path.relpath(path)
        report = report.merge(check_lock_discipline(source, rel))
    return report


# ---------------------------------------------------------------------------
# Seeded thread-stress harness: threaded vs sync fleets must agree.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class StressResult:
    """Outcome of one sync-vs-threaded cross-check."""

    n_streams: int
    ticks_sync: int
    ticks_threaded: int
    mismatches: tuple

    @property
    def ok(self) -> bool:
        return not self.mismatches


def _seeded_streams(compiled, n_streams: int, timesteps: Optional[int],
                    seed: int) -> list:
    """``n_streams`` binary ``(T, H, W, C)`` event streams from numpy's
    ``default_rng(seed)`` — the reference's draws, value for value."""
    import numpy as np

    h, w = compiled.spec.input_hw
    c = compiled.spec.in_channels
    t = timesteps or compiled.spec.timesteps
    rng = np.random.default_rng(seed)
    return [(rng.random((t, h, w, c)) < 0.1).astype(np.float32)
            for _ in range(n_streams)]


def _serve_seeded(compiled, streams: list, mode: str, n_replicas: int,
                  capacity: int, timeout_s: float):
    """Serve ``streams`` through one fleet in ``mode``; returns
    ``({rid: (readout, cycles)}, ticks, fleet)`` (the fleet shut down)."""
    import numpy as np

    from ..serving import serve

    fleet = serve(compiled, n_replicas=n_replicas, capacity=capacity,
                  mode=mode, max_queue=max(len(streams), 1))
    try:
        handles = [fleet.submit(ev, rid=i) for i, ev in enumerate(streams)]
        fleet.drain(timeout=timeout_s if mode == "threaded" else None)
        results = {hd.rid: (np.asarray(hd.readout), int(hd.cycles))
                   for hd in handles}
        return results, int(fleet.ticks), fleet
    finally:
        fleet.shutdown()


def stress_fleet(compiled, n_streams: int = 6, n_replicas: int = 2,
                 timesteps: Optional[int] = None, seed: int = 0,
                 capacity: int = 2, timeout_s: float = 120.0) -> StressResult:
    """Serve identical seeded streams sync and threaded; compare results.

    Every stream's computation is deterministic per chunk, so thread
    interleaving must not change any readout or per-stream cycle count —
    a divergence means fleet state was mutated outside the lock contract
    the static pass checks.  The streams come from numpy's
    ``default_rng(seed)`` as the reference's do, so both packages serve
    the same events; the fleets run on ``compiled``'s device (in threaded
    mode on the card, each replica on its own CUDA stream).
    """
    import numpy as np

    streams = _seeded_streams(compiled, n_streams, timesteps, seed)
    sync_res, sync_ticks, _ = _serve_seeded(
        compiled, streams, "sync", n_replicas, capacity, timeout_s)
    thr_res, thr_ticks, _ = _serve_seeded(
        compiled, streams, "threaded", n_replicas, capacity, timeout_s)
    mismatches = []
    for rid in sorted(sync_res):
        (r_s, c_s), (r_t, c_t) = sync_res[rid], thr_res[rid]
        if not np.array_equal(r_s, r_t):
            mismatches.append(f"stream {rid}: readout diverged")
        elif c_s != c_t:
            mismatches.append(
                f"stream {rid}: cycles diverged ({c_s} vs {c_t})")
    return StressResult(
        n_streams=n_streams,
        ticks_sync=sync_ticks,
        ticks_threaded=thr_ticks,
        mismatches=tuple(mismatches),
    )
