"""Scheduler (stage 4 of 4): emit the executable :class:`CoreSchedule`.

``compile_network`` runs the full pipeline — IR -> partition -> select ->
schedule — and returns a :class:`CoreSchedule`: one :class:`LayerSchedule`
per weight layer carrying its channel slices, the selector's
:class:`LayerPlan`, and the routing model (which cores must receive the
layer's input spikes, and how many AER copies cross the fabric per input
spike).

The schedule is pure static metadata: frozen, hashable dataclasses that
compare by value, so two plans (say, of two replicas) can be compared
directly.  The engine consumes it via
``repro_torch.engine.compile_engine``, which bakes the channel slices into
stacked per-core weight tensors.

Routing model.  A layer's input spikes live on the core(s) that produced
them (the previous weight layer's slices; pools are core-transparent).
Every core holding a slice of the consuming layer needs the *full* input
plane, so each input spike is sent to every consumer core except the one
that already has it:

    copies/spike = n_consumers - overlap
    overlap      = fraction of producer channels whose core is a consumer

The network's first layer receives its events from the sensor/host feed,
which is charged one delivery per consumer core beyond the first.
"""
from __future__ import annotations

import dataclasses

from ..core.network import SNNSpec
from ..core.quant import QuantSpec
from .ir import build_graph
from .partition import ChannelSlice, CoreGrid, LayerPartition, partition_graph
from .select import LayerPlan, select_layer

__all__ = ["CoreSchedule", "LayerSchedule", "compile_network"]


@dataclasses.dataclass(frozen=True)
class LayerSchedule:
    """Everything the engine and the cost model need for one weight layer."""

    node: int                   # spec.layers / params index
    kind: str                   # "conv" | "fc"
    out_channels: int
    slices: tuple               # of ChannelSlice, contiguous, in lo order
    plan: LayerPlan             # selector verdict for the per-core slice
    split: bool                 # intra-layer channel split?
    route_fractions: tuple      # per-core fraction of input spikes received
                                # over the fabric (len n_cores; 0.0 = local
                                # or not a consumer) — the cost model's
                                # single source of routing truth
    consumer_cores: tuple       # cores that receive this layer's inputs

    @property
    def route_factor(self) -> float:
        """Total AER copies per input spike crossing cores (sum per core)."""
        return float(sum(self.route_fractions))

    def slice_of(self, core: int) -> ChannelSlice | None:
        """This layer's channel slice on ``core`` (None if idle there)."""
        for s in self.slices:
            if s.core == core:
                return s
        return None


@dataclasses.dataclass(frozen=True)
class CoreSchedule:
    """Executable multi-core plan for one network.

    ``layers`` holds one :class:`LayerSchedule` per *weight* layer in
    network order (pool layers need no placement — they follow their
    input's core(s) for free).
    """

    name: str
    n_cores: int
    grid: CoreGrid
    qspec: QuantSpec
    layers: tuple               # of LayerSchedule

    @property
    def n_split_layers(self) -> int:
        return sum(1 for l in self.layers if l.split)

    @property
    def cores_used(self) -> tuple:
        used = set()
        for l in self.layers:
            used.update(s.core for s in l.slices)
        return tuple(sorted(used))

    def describe(self) -> str:
        """Human-readable placement table (docs/serving logs)."""
        lines = [f"{self.name}: {len(self.layers)} weight layers "
                 f"on {self.n_cores} cores "
                 f"({self.n_split_layers} channel-split)"]
        for l in self.layers:
            placement = ", ".join(
                f"core{s.core}[{s.lo}:{s.hi}]" for s in l.slices)
            lines.append(
                f"  L{l.node} {l.kind:<4} mode={l.plan.mode} "
                f"{l.plan.spec.weight_bits}b {l.plan.stationarity}-stationary "
                f"route x{l.route_factor:.2f} -> {placement}")
        return "\n".join(lines)


def _route_fractions(prev: LayerPartition | None, part: LayerPartition,
                     prev_channels: int, n_cores: int) -> tuple:
    """(per-core routed fraction, consumer cores) for one weight layer.

    ``fractions[c]`` is the share of the layer's input spikes core ``c``
    receives over the fabric: 0 for non-consumers, ``1 - local_share`` for
    consumers (spikes produced on ``c`` itself arrive for free).
    """
    consumers = tuple(sorted({s.core for s in part.slices}))
    fractions = [0.0] * n_cores
    if prev is None:
        # Sensor/host feed: the first consumer core gets the events free,
        # every further consumer needs its own delivery.
        for c in consumers[1:]:
            fractions[c] = 1.0
        return tuple(fractions), consumers
    for c in consumers:
        local = sum(s.width for s in prev.slices if s.core == c)
        fractions[c] = 1.0 - local / max(prev_channels, 1)
    return tuple(fractions), consumers


def compile_network(
    spec: SNNSpec,
    n_cores: int = 1,
    qspec: QuantSpec | None = None,
    grid: CoreGrid | None = None,
    assumed_sparsity: float = 0.9,
    allowed_specs: tuple | None = None,
    force_mode: int | None = None,
    force_stationarity: str | None = None,
) -> CoreSchedule:
    """Partition, place and schedule ``spec`` across a grid of SpiDR cores.

    ``qspec`` is the precision the engine will execute (default 4/7-bit);
    by default the selector is pinned to it so the schedule is bit-exact
    with single-core execution.  Pass ``allowed_specs`` (a tuple of
    :class:`QuantSpec`) to let the selector explore precision for
    design-space analysis — such schedules are for cost modeling, not for
    ``compile_engine`` (which asserts the plan's precision matches the
    engine's).

    ``assumed_sparsity`` feeds the load-balancing and selection heuristics
    only; any returned schedule executes bit-exactly regardless.
    ``force_mode`` / ``force_stationarity`` pin the selector's per-layer
    operating-mode (1/2) and weight-vs-Vmem stationarity choices — the
    deployment API's reconfigurability overrides (``repro_torch.spidr``'s
    ``DeployTarget``); like sparsity they only move the modeled cost, never
    the computed spikes.
    """
    qspec = qspec or QuantSpec(4)
    grid = grid or CoreGrid(n_cores)
    assert grid.n_cores == n_cores or n_cores == 1, \
        "pass either n_cores or an explicit grid, not conflicting values"
    allowed = tuple(allowed_specs) if allowed_specs else (qspec,)
    density = 1.0 - assumed_sparsity

    graph = build_graph(spec)
    parts = partition_graph(graph, grid, qspec, assumed_density=density)
    weight_nodes = graph.weight_nodes

    layers = []
    prev_part, prev_channels = None, 0
    for node, part in zip(weight_nodes, parts):
        widest = max(part.slices, key=lambda s: s.width)
        placed_shape = dataclasses.replace(
            node.shape, out_channels=widest.width)
        plan = select_layer(node, placed_shape, allowed,
                            assumed_density=density,
                            force_mode=force_mode,
                            force_stationarity=force_stationarity)
        fractions, consumers = _route_fractions(prev_part, part,
                                                prev_channels, grid.n_cores)
        layers.append(LayerSchedule(
            node=node.idx,
            kind=node.kind,
            out_channels=node.shape.out_channels,
            slices=part.slices,
            plan=plan,
            split=part.split,
            route_fractions=fractions,
            consumer_cores=consumers,
        ))
        prev_part, prev_channels = part, node.shape.out_channels
    return CoreSchedule(
        name=spec.name,
        n_cores=grid.n_cores,
        grid=grid,
        qspec=qspec,
        layers=tuple(layers),
    )
