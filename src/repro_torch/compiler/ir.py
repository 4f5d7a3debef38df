"""Graph IR for the multi-core compiler (stage 1 of 4: IR -> partition ->
select -> schedule).

An :class:`SNNSpec` is a flat layer list; the compiler works on a small
explicit graph instead, because partitioning and routing are graph
questions: *which core produces the spikes that this layer consumes, and
how many of them cross a core boundary?*

Every spec layer becomes a :class:`LayerNode` (pool layers included — they
transform the spike plane between weight layers and determine routing
volumes).  Weight nodes carry their accelerator-view :class:`LayerShape`
plus the size of the spike plane they consume per timestep
(``in_positions`` — the routing-volume proxy: at input density ``d`` the
layer receives ``d * in_positions`` spikes per timestep).

The IR is deliberately a chain with explicit predecessor links rather than
a general DAG: both paper networks are chains, but everything downstream
(partitioner, router) only uses ``inputs``/``consumers``, so branching
topologies are an IR extension, not a rewrite.
"""
from __future__ import annotations

import dataclasses

from ..core.modes import LayerShape
from ..core.network import SNNSpec

__all__ = ["LayerNode", "NetworkGraph", "build_graph"]


@dataclasses.dataclass(frozen=True)
class LayerNode:
    """One spec layer as a graph node.

    ``idx``          position in ``spec.layers`` (== params index).
    ``kind``         "conv" | "fc" | "pool" | "adaptive_pool".
    ``shape``        accelerator-view :class:`LayerShape` (weight nodes only).
    ``inputs``       predecessor node indices (empty for the input layer).
    ``in_positions`` spike-plane positions consumed per timestep
                     (H*W*C_in for conv, N_in for fc) — routing volume.
    ``out_positions``spike-plane positions produced per timestep.
    """

    idx: int
    kind: str
    shape: LayerShape | None
    inputs: tuple
    in_positions: int = 0
    out_positions: int = 0

    @property
    def is_weight(self) -> bool:
        return self.kind in ("conv", "fc")


@dataclasses.dataclass(frozen=True)
class NetworkGraph:
    """Layer graph of one network, annotated for partitioning/routing."""

    name: str
    nodes: tuple  # of LayerNode, in execution order

    @property
    def weight_nodes(self) -> tuple:
        return tuple(n for n in self.nodes if n.is_weight)

    def producer_of(self, node: LayerNode) -> LayerNode | None:
        """Nearest *weight* ancestor — the layer whose output spikes this
        node consumes (pool nodes are transparent: they reshape the spike
        plane on whichever core produced it)."""
        seen = node
        while seen.inputs:
            seen = self.nodes[seen.inputs[0]]
            if seen.is_weight:
                return seen
        return None


def build_graph(spec: SNNSpec) -> NetworkGraph:
    """Lower an :class:`SNNSpec` into the compiler IR."""
    h, w = spec.input_hw
    c = spec.in_channels
    shapes = iter(spec.layer_shapes())
    nodes = []
    for i, l in enumerate(spec.layers):
        inputs = (i - 1,) if i else ()
        if l.kind == "conv":
            shape = next(shapes)
            in_pos = h * w * c
            p = l.conv
            h = (h + 2 * p.padding - p.kh) // p.stride + 1
            w = (w + 2 * p.padding - p.kw) // p.stride + 1
            c = l.c_out
            nodes.append(LayerNode(i, "conv", shape, inputs,
                                   in_positions=in_pos,
                                   out_positions=h * w * c))
        elif l.kind == "fc":
            shape = next(shapes)
            nodes.append(LayerNode(i, "fc", shape, inputs,
                                   in_positions=shape.fan_in,
                                   out_positions=shape.out_channels))
            c = l.c_out
        elif l.kind == "pool":
            in_pos = h * w * c
            h, w = h // 2, w // 2
            nodes.append(LayerNode(i, "pool", None, inputs,
                                   in_positions=in_pos,
                                   out_positions=h * w * c))
        elif l.kind == "adaptive_pool":
            in_pos = h * w * c
            h = w = l.target_hw
            nodes.append(LayerNode(i, "adaptive_pool", None, inputs,
                                   in_positions=in_pos,
                                   out_positions=h * w * c))
        else:  # pragma: no cover - spec validated upstream
            raise ValueError(l.kind)
    return NetworkGraph(name=spec.name, nodes=tuple(nodes))
