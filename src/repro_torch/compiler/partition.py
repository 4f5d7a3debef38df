"""Partitioner (stage 2 of 4): split or place every weight layer on cores.

Two placement regimes, chosen per layer (Chauvaux et al.'s observation that
the right level of parallelism is a *per-layer* decision):

* **intra-layer channel split** — a layer whose fan-in or fan-out exceeds
  what one core executes in a single weight-stationary pass
  (``fan_in_tiles > 1`` or ``channel_tiles > 1``) is split along its
  *output channels* across several cores.  Each core holds a contiguous
  channel slice of the weights and scans the full input spike plane into
  its own macros, so input spikes must be routed (AER, 2 cycles/spike) to
  every core holding a slice.  Channel-splitting divides the sequential
  channel tiles (the dominant term when ``channel_tiles > 1``) and divides
  weight storage (the constraint when ``fan_in_tiles > 1``).

* **inter-layer pipeline** — a layer that fits one core is assigned whole
  to the currently least-loaded core (greedy bin-packing on modeled
  row-op cycles at the assumed input density).  Consecutive layers on
  different cores form a core-to-core pipeline; the spikes between them
  are the routed traffic.

Output channels are always partitioned into *contiguous* slices covering
``[0, out_channels)`` in order — the engine reassembles a layer's output
by concatenating slice results, which keeps multi-core execution bit-exact
with the single-core path (an integer GEMM + per-channel neuron update is
column-independent).
"""
from __future__ import annotations

import dataclasses
import math

from ..core.modes import CoreConfig, map_layer
from ..core.pipeline import ROUTE_CYCLES_PER_SPIKE
from ..core.quant import QuantSpec
from .ir import NetworkGraph

__all__ = ["ChannelSlice", "CoreGrid", "LayerPartition", "partition_graph"]


@dataclasses.dataclass(frozen=True)
class CoreGrid:
    """A grid of identical SpiDR cores joined by an AER spike fabric."""

    n_cores: int = 1
    route_cycles_per_spike: int = ROUTE_CYCLES_PER_SPIKE

    def __post_init__(self):
        assert self.n_cores >= 1, self.n_cores


@dataclasses.dataclass(frozen=True)
class ChannelSlice:
    """Contiguous output-channel range ``[lo, hi)`` owned by ``core``."""

    core: int
    lo: int
    hi: int

    @property
    def width(self) -> int:
        return self.hi - self.lo


@dataclasses.dataclass(frozen=True)
class LayerPartition:
    """Placement of one weight layer: its channel slices, in ``lo`` order."""

    node: int                  # graph node index
    slices: tuple              # of ChannelSlice, contiguous, covering the layer
    split: bool                # True = intra-layer channel split

    @property
    def cores(self) -> tuple:
        return tuple(s.core for s in self.slices)


def _est_row_op_cycles(node, mapping, density: float) -> float:
    """Modeled per-timestep row-op cycles of a layer at ``density``.

    Mirrors ``engine/cost.py``: each input spike triggers 2 row ops per
    sequential channel tile (even+odd Vmem rows).
    """
    return 2.0 * density * node.in_positions * mapping.channel_tiles


def partition_graph(
    graph: NetworkGraph,
    grid: CoreGrid,
    qspec: QuantSpec,
    assumed_density: float = 0.1,
) -> tuple:
    """Place every weight layer of ``graph`` on the ``grid``.

    Returns a tuple of :class:`LayerPartition`, one per weight node in
    network order.  ``assumed_density`` (1 - expected input sparsity) only
    drives the load-balancing heuristic, never correctness: any partition
    executes bit-exactly.
    """
    core = CoreConfig(qspec)
    load = [0.0] * grid.n_cores          # modeled cycles already packed per core
    parts = []
    for node in graph.weight_nodes:
        mapping = map_layer(node.shape, core)
        too_big = mapping.channel_tiles > 1 or mapping.fan_in_tiles > 1
        if too_big and grid.n_cores > 1:
            # Channel split: enough cores to bring per-core channel tiles
            # down to 1 when possible, never more cores than channels.
            n_split = min(grid.n_cores,
                          max(mapping.channel_tiles, 2),
                          node.shape.out_channels)
            k = node.shape.out_channels
            width = math.ceil(k / n_split)
            slices = tuple(
                ChannelSlice(c, c * width, min((c + 1) * width, k))
                for c in range(n_split)
                if c * width < k
            )
            sub = dataclasses.replace(node.shape, out_channels=width)
            per_core = _est_row_op_cycles(node, map_layer(sub, core),
                                          assumed_density)
            for s in slices:
                load[s.core] += per_core
            parts.append(LayerPartition(node.idx, slices, split=True))
        else:
            # Whole layer -> least-loaded core (greedy inter-layer pipeline).
            c = min(range(grid.n_cores), key=lambda i: load[i])
            load[c] += _est_row_op_cycles(node, mapping, assumed_density)
            parts.append(LayerPartition(
                node.idx,
                (ChannelSlice(c, 0, node.shape.out_channels),),
                split=False,
            ))
    return tuple(parts)
