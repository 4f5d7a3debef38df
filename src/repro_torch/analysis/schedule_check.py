"""Schedule verification: structural lint of a compiled :class:`CoreSchedule`.

``compile_network`` emits schedules that satisfy these invariants by
construction — this pass re-proves them on the *artifact*, so a schedule
that was tampered with, deserialized from an old artifact, or produced by
a future search-based placer (ROADMAP "Compiler v2") is certified before
the engine bakes it into weights:

  * **capacity / coverage** — every slice lands inside the
    :class:`CoreGrid`; each layer's slices are contiguous, non-overlapping
    and cover exactly ``[0, out_channels)`` (the engine reassembles
    outputs by concatenation — a gap or overlap silently corrupts them).
  * **precision legality** — the schedule's ``qspec`` and every plan's
    spec must be a supported ``(B_w, B_vmem)`` pair
    (:data:`repro_torch.core.quant.PRECISION_PAIRS`); a plan precision differing
    from the schedule's is flagged as cost-model-only (warning).
  * **mode / stationarity consistency** — operating mode in {1, 2},
    stationarity in {weight, vmem}, and (given the spec) the plan's
    mapping must equal ``map_layer``'s re-derivation for the placed slice
    shape.
  * **AER routing soundness** — ``route_fractions`` replayed from the
    previous layer's slices (the compiler's local-share rule), fractions
    in [0, 1] and nonzero only on consumer cores, consumers exactly the
    slice-holders, stages in pipeline order, and the routing graph
    acyclic.  Together these give handshake-deadlock freedom: every
    (layer, core) stage waits only on strictly-earlier stages, and no
    core is ever sent spikes it does not consume (which would wedge the
    bufferless handshake).
  * **cycle conservation** — a static replay of
    ``estimate_multicore_cost`` on deterministic worst-case spike counts,
    with the per-core row-op and routing sums re-derived *independently*
    here: splitting a network across cores must conserve total row-op
    cycles exactly, up to the modeled duplication overhead (>= 0).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from ..compiler.ir import build_graph
from ..compiler.schedule import CoreSchedule, LayerSchedule
from ..core.modes import CoreConfig, map_layer
from ..core.network import SNNSpec
from ..core.pipeline import route_cycles
from ..core.quant import PRECISION_PAIRS
from .report import AnalysisReport, Violation

__all__ = ["check_schedule"]

_PAIRS_TEXT = ", ".join(f"{w}/{v}" for w, v in PRECISION_PAIRS)


def _pair_of(qspec: object) -> tuple:
    """(weight_bits, vmem_bits) of a (possibly duck-typed) spec object."""
    return (getattr(qspec, "weight_bits", None),
            getattr(qspec, "vmem_bits", None))


def _v(code: str, location: str, message: str,
       severity: str = "error") -> Violation:
    return Violation(pass_name="schedule", code=code, location=location,
                     message=message, severity=severity)


def _check_capacity(schedule: CoreSchedule, loc: str,
                    out: list) -> None:
    n = schedule.n_cores
    if n < 1 or schedule.grid.n_cores != n:
        out.append(_v("SCH001", loc,
                      f"schedule declares n_cores={n} but its grid has "
                      f"{schedule.grid.n_cores} cores"))
    for layer in schedule.layers:
        lloc = f"{loc}.L{layer.node}"
        if not layer.slices:
            out.append(_v("SCH004", lloc, "layer has no channel slices — "
                          "nothing would execute it"))
            continue
        for s in layer.slices:
            if not 0 <= s.core < n:
                out.append(_v(
                    "SCH002", lloc,
                    f"slice [{s.lo}:{s.hi}) placed on core {s.core}, "
                    f"outside the grid of {n} cores"))
        expect_lo = 0
        for s in layer.slices:
            if s.lo != expect_lo or s.hi <= s.lo:
                out.append(_v(
                    "SCH003", lloc,
                    f"channel slices must be contiguous over "
                    f"[0, {layer.out_channels}): slice [{s.lo}:{s.hi}) "
                    f"follows coverage up to {expect_lo}"))
                break
            expect_lo = s.hi
        else:
            if expect_lo != layer.out_channels:
                out.append(_v(
                    "SCH003", lloc,
                    f"channel slices must be contiguous over "
                    f"[0, {layer.out_channels}): coverage ends at "
                    f"{expect_lo}"))


def _check_precision(schedule: CoreSchedule, loc: str, out: list) -> None:
    pair = _pair_of(schedule.qspec)
    if pair not in PRECISION_PAIRS:
        out.append(_v(
            "SCH010", loc,
            f"illegal precision pair {pair[0]}/{pair[1]}: supported "
            f"pairs are {_PAIRS_TEXT}"))
    for layer in schedule.layers:
        lloc = f"{loc}.L{layer.node}"
        ppair = _pair_of(layer.plan.spec)
        if ppair not in PRECISION_PAIRS:
            out.append(_v(
                "SCH011", lloc,
                f"illegal plan precision pair {ppair[0]}/{ppair[1]}: "
                f"supported pairs are {_PAIRS_TEXT}"))
        elif ppair != pair and pair in PRECISION_PAIRS:
            out.append(_v(
                "SCH012", lloc,
                f"plan precision {ppair[0]}/{ppair[1]} differs from the "
                f"schedule's {pair[0]}/{pair[1]} — a design-space "
                "(cost-model-only) schedule; compile_engine would reject "
                "it", severity="warning"))


def _check_modes(schedule: CoreSchedule, spec: Optional[SNNSpec],
                 loc: str, out: list) -> None:
    shapes = {}
    if spec is not None:
        graph = build_graph(spec)
        shapes = {n.idx: n.shape for n in graph.weight_nodes}
    for layer in schedule.layers:
        lloc = f"{loc}.L{layer.node}"
        plan = layer.plan
        if plan.mode not in (1, 2):
            out.append(_v("SCH020", lloc,
                          f"operating mode must be 1 or 2, got "
                          f"{plan.mode!r}"))
            continue
        if plan.mapping.mode != plan.mode:
            out.append(_v(
                "SCH021", lloc,
                f"plan says mode {plan.mode} but its mapping was derived "
                f"for mode {plan.mapping.mode}"))
        if plan.stationarity not in ("weight", "vmem"):
            out.append(_v(
                "SCH022", lloc,
                f"stationarity must be 'weight' or 'vmem', got "
                f"{plan.stationarity!r}"))
        shape = shapes.get(layer.node)
        if shape is not None and layer.slices \
                and _pair_of(plan.spec) in PRECISION_PAIRS:
            widest = max(s.hi - s.lo for s in layer.slices)
            placed = dataclasses.replace(shape, out_channels=widest)
            derived = map_layer(placed, CoreConfig(plan.spec),
                                force_mode=plan.mode)
            if derived != plan.mapping:
                out.append(_v(
                    "SCH023", lloc,
                    f"plan mapping {plan.mapping} is not map_layer's "
                    f"derivation {derived} for the placed slice shape "
                    f"(widest slice {widest} channels)"))


def _check_routing(schedule: CoreSchedule, loc: str, out: list) -> None:
    n = schedule.n_cores
    prev: Optional[LayerSchedule] = None
    edges = []        # ((stage_idx, core) -> (stage_idx, core)) wait-for
    last_node = -1
    for stage, layer in enumerate(schedule.layers):
        lloc = f"{loc}.L{layer.node}"
        if layer.node <= last_node:
            out.append(_v(
                "SCH036", lloc,
                f"layers out of pipeline order: L{layer.node} scheduled "
                f"after L{last_node}"))
        last_node = max(last_node, layer.node)
        fr = layer.route_fractions
        if len(fr) != n:
            out.append(_v(
                "SCH030", lloc,
                f"route_fractions has {len(fr)} entries for {n} cores"))
            prev = layer
            continue
        slice_cores = tuple(sorted({s.core for s in layer.slices}))
        if tuple(layer.consumer_cores) != slice_cores:
            out.append(_v(
                "SCH032", lloc,
                f"consumer_cores {tuple(layer.consumer_cores)} != the "
                f"cores holding slices {slice_cores}"))
        for c, f in enumerate(fr):
            if not 0.0 <= f <= 1.0:
                out.append(_v(
                    "SCH031", lloc,
                    f"route fraction {f} on core {c} outside [0, 1]"))
            elif f > 0.0 and c not in layer.consumer_cores:
                out.append(_v(
                    "SCH033", lloc,
                    f"core {c} is sent {f:.3f} of the input spikes but "
                    "holds no slice of the layer — undeliverable spikes "
                    "wedge the bufferless AER handshake"))
        # Static replay of the compiler's local-share routing rule.
        expect = [0.0] * n
        if prev is None:
            for c in slice_cores[1:]:
                expect[c] = 1.0
        else:
            prev_ch = max(prev.out_channels, 1)
            for c in slice_cores:
                local = sum(s.hi - s.lo for s in prev.slices
                            if s.core == c)
                expect[c] = 1.0 - local / prev_ch
        got = [float(f) for f in fr]
        if any(abs(a - b) > 1e-9 for a, b in zip(got, expect)):
            out.append(_v(
                "SCH034", lloc,
                f"route_fractions {tuple(got)} do not replay from the "
                f"previous layer's slices (expected {tuple(expect)})"))
        if prev is not None:
            for p in {s.core for s in prev.slices}:
                for c in layer.consumer_cores:
                    if isinstance(c, int) and c != p:
                        edges.append(((stage - 1, p), (stage, c)))
        prev = layer
    # Acyclicity of the stage wait-for graph: consumers wait on producers.
    # With chain IR every edge advances the stage index, but a tampered or
    # future-DAG schedule is checked generally (iterative DFS).
    adj: dict = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
    state: dict = {}
    for root in adj:
        if root in state:
            continue
        stack = [(root, iter(adj.get(root, ())))]
        state[root] = 1
        while stack:
            node, it = stack[-1]
            for nxt in it:
                if state.get(nxt) == 1:
                    out.append(_v(
                        "SCH035", loc,
                        f"AER routing graph has a cycle through stage "
                        f"{nxt[0]} core {nxt[1]} — the handshake pipeline "
                        "can deadlock"))
                    state[nxt] = 2
                elif nxt not in state:
                    state[nxt] = 1
                    stack.append((nxt, iter(adj.get(nxt, ()))))
                    break
            else:
                state[node] = 2
                stack.pop()


def _replay_conservation(schedule: CoreSchedule, spec: SNNSpec,
                         loc: str, out: list) -> dict:
    """Re-derive the cost model's per-core attribution independently and
    cross-check the cycle-conservation identity on worst-case counts."""
    from ..engine.cost import estimate_multicore_cost

    graph = build_graph(spec)
    weight_nodes = graph.weight_nodes
    if len(weight_nodes) != len(schedule.layers):
        out.append(_v(
            "SCH040", loc,
            f"schedule has {len(schedule.layers)} weight layers but the "
            f"spec lowers to {len(weight_nodes)}"))
        return {}
    T = 2
    counts = np.tile(
        np.array([n.in_positions for n in weight_nodes],
                 dtype=np.float64), (T, 1))
    cost = estimate_multicore_cost(spec, schedule, counts)

    C = schedule.n_cores
    rcps = schedule.grid.route_cycles_per_spike
    compute = np.zeros(C, dtype=np.int64)
    routing = np.zeros(C, dtype=np.int64)
    single = 0
    for li, layer in enumerate(schedule.layers):
        m = layer.plan.mapping
        active = m.pipelines * m.macros_per_pipeline
        full_ct = max(1, math.ceil(layer.out_channels
                                   / m.parallel_channels))
        single += int(np.ceil(2.0 * counts[:, li] * full_ct).sum())
        for s in layer.slices:
            ct = max(1, math.ceil((s.hi - s.lo) / m.parallel_channels))
            per_macro = np.ceil(2.0 * counts[:, li] * ct / active)
            compute[s.core] += int(per_macro.sum()) * active
        for c, frac in enumerate(layer.route_fractions):
            if frac > 0.0:
                routing[c] += route_cycles(counts[:, li].sum() * frac, rcps)

    if not np.array_equal(compute, cost.compute_cycles):
        out.append(_v(
            "SCH040", loc,
            f"per-core compute cycles {cost.compute_cycles.tolist()} do "
            f"not replay from the schedule (expected {compute.tolist()})"))
    if single != cost.single_core_compute_cycles:
        out.append(_v(
            "SCH041", loc,
            f"single-core compute cycles {cost.single_core_compute_cycles}"
            f" do not replay from the schedule (expected {single})"))
    duplication = int(compute.sum()) - single
    if duplication < 0 or cost.duplication_cycles != duplication \
            or int(cost.compute_cycles.sum()) != \
            cost.single_core_compute_cycles + cost.duplication_cycles:
        out.append(_v(
            "SCH042", loc,
            "cycle conservation broken: sum(compute) "
            f"{int(cost.compute_cycles.sum())} != single-core "
            f"{cost.single_core_compute_cycles} + duplication "
            f"{cost.duplication_cycles} (replay gives duplication "
            f"{duplication})"))
    if not np.array_equal(routing, cost.routing_cycles):
        out.append(_v(
            "SCH043", loc,
            f"per-core AER routing cycles {cost.routing_cycles.tolist()} "
            f"do not replay from route_fractions (expected "
            f"{routing.tolist()})"))
    return {
        "worst_case_T": T,
        "compute_cycles": compute.tolist(),
        "routing_cycles": routing.tolist(),
        "single_core_compute_cycles": single,
        "duplication_cycles": duplication,
    }


def check_schedule(schedule: CoreSchedule,
                   spec: Optional[SNNSpec] = None) -> AnalysisReport:
    """Verify every structural invariant of a compiled ``CoreSchedule``.

    ``spec`` enables the two checks that need the network itself: the
    mapping re-derivation (SCH023) and the cycle-conservation replay
    against ``estimate_multicore_cost`` (SCH040-43).  Without it the
    purely-structural invariants still run.
    """
    pair = _pair_of(schedule.qspec)
    loc = schedule.name
    violations: list = []
    _check_capacity(schedule, loc, violations)
    _check_precision(schedule, loc, violations)
    _check_modes(schedule, spec, loc, violations)
    _check_routing(schedule, loc, violations)
    conservation = {}
    structural_ok = not any(v.severity == "error" for v in violations)
    if spec is not None and structural_ok:
        # The replay prices the schedule through the real cost model; only
        # meaningful once the structure itself is sound.
        conservation = _replay_conservation(schedule, spec, loc, violations)
    certificate = {
        "pass": "schedule",
        "network": schedule.name,
        "n_cores": schedule.n_cores,
        "precision": list(pair),
        "n_layers": len(schedule.layers),
        "n_split_layers": schedule.n_split_layers,
        "cores_used": list(schedule.cores_used),
        "route_factor_total": sum(
            layer.route_factor for layer in schedule.layers),
        "conservation": conservation,
        "ok": not any(v.severity == "error" for v in violations),
    }
    return AnalysisReport(
        subject=f"{schedule.name}@{pair[0]}/{pair[1]}b x{schedule.n_cores}",
        passes=("schedule",),
        violations=tuple(violations),
        certificates={"schedule": certificate},
    )
