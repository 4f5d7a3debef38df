"""Multi-core CIM compiler: partition, place and schedule SNNs across a
grid of SpiDR cores (paper Sec II-E's ``n_cores`` extension, made real).

Four stages, one module each:

  ``ir``         lower an :class:`~repro_torch.core.network.SNNSpec` into a small
                 layer graph annotated with routing volumes
                 (:func:`build_graph`).
  ``partition``  split over-capacity layers across cores channel-wise
                 (intra-layer, with spike routing) or place whole layers on
                 the least-loaded core (inter-layer pipeline)
                 (:func:`partition_graph`).
  ``select``     pick per-layer operating mode (1/2), precision
                 (:class:`~repro_torch.core.quant.QuantSpec`) and weight- vs
                 Vmem-stationarity by minimizing the calibrated
                 cycle/energy models (:func:`select_layer`).
  ``schedule``   emit the executable :class:`CoreSchedule`
                 (:func:`compile_network`).

The engine runs a schedule via :func:`repro_torch.engine.compile_engine`
bit-exactly with the single-core path, and
``repro_torch.engine.cost.estimate_multicore_cost`` prices a run per core,
including the modeled spike-routing overhead and the load-imbalance
metric.  Pure Python over ``core.modes``, ``core.pipeline`` and
``core.energy``, the same code as ``repro.compiler``: every schedule,
cost and tie-break equals the reference's.

This package imports only ``repro_torch.core`` (never
``repro_torch.engine``), so the engine can depend on it without cycles.
"""
from .ir import LayerNode, NetworkGraph, build_graph
from .partition import ChannelSlice, CoreGrid, LayerPartition, partition_graph
from .schedule import CoreSchedule, LayerSchedule, compile_network
from .select import LayerPlan, select_layer

__all__ = [
    "ChannelSlice",
    "CoreGrid",
    "CoreSchedule",
    "LayerNode",
    "LayerPartition",
    "LayerPlan",
    "LayerSchedule",
    "NetworkGraph",
    "build_graph",
    "compile_network",
    "partition_graph",
    "select_layer",
]
