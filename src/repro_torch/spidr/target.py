"""The declarative deployment target: the knobs of a SpiDR deployment.

:class:`DeployTarget` holds the weight/Vmem precision pair, the core
count, the execution backend, the streaming chunk geometry and the fused
kernels' options and the multi-core compiler's overrides.
``spidr.compile(spec, params, target)`` turns a target plus a network into
a :class:`~repro_torch.spidr.CompiledSNN`.

Validation is eager and actionable: an unsupported setting raises
``ValueError`` naming the nearest supported alternative(s) — for example
``DeployTarget(weight_bits=5, vmem_bits=9)`` names ``(4, 7)`` and
``(6, 11)``.  Settings whose code is not ported yet raise
``NotImplementedError`` naming the ROADMAP item that ports it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..core.quant import PRECISION_PAIRS, QuantSpec
from ..kernels.ref import DEFAULT_BLOCK

__all__ = ["BACKENDS", "DeployTarget", "PRECISION_PAIRS"]

# Execution backends: the CUDA fused kernels, the plain integer torch
# datapath (the reference's "jnp" oracle), and the python-loop reference.
BACKENDS = ("fused", "torch", "reference")


def _nearest_pairs(w: int, v: int, n: int = 2) -> list:
    """The ``n`` supported precision pairs closest to ``(w, v)``."""
    return sorted(PRECISION_PAIRS, key=lambda p: abs(p[0] - w) + abs(p[1] - v))[:n]


def _require_positive_int(name: str, value, minimum: int = 1,
                          hint: str = "") -> None:
    if not isinstance(value, int) or isinstance(value, bool) or value < minimum:
        raise ValueError(
            f"{name}={value!r} unsupported — needs an integer >= {minimum}"
            + (f" ({hint})" if hint else ""))


@dataclasses.dataclass(frozen=True)
class DeployTarget:
    """Where and how a network deploys.

    Precision
        ``weight_bits`` (4/6/8) selects the weight/Vmem pair; ``vmem_bits``
        defaults to ``2*weight_bits - 1`` and is validated when given.

    Topology
        ``n_cores`` > 1 routes the build through the multi-core compiler
        (partition/place/schedule onto a core grid), bit-exact with
        single-core execution.  ``device_parallel=True`` asks for the
        cores on separate CUDA devices: it raises when the host has fewer
        than ``n_cores`` devices, and otherwise too, as that placement is
        not ported yet (ROADMAP A9); None or False run the plan on one
        device.  ``force_mode`` / ``stationarity`` pin the compiler's
        per-layer operating mode (1/2) and weight-vs-Vmem stationarity;
        ``assumed_sparsity`` feeds its load-balancing heuristics.  They
        move the modeled cost, never the computed spikes.

    Execution
        ``backend`` is ``"fused"`` (the CUDA kernels), ``"torch"`` (the
        plain integer datapath) or ``"reference"`` (the python-loop
        oracle).  ``skip_empty`` and ``block`` configure the fused kernels;
        ``t_block`` > 1 switches them to the Vmem-stationary multi-timestep
        kernel.  ``autotune`` (per-layer measured kernel configs) is not
        ported yet (ROADMAP A8) and must stay False.

    Streaming
        ``stream_capacity`` slots of persistent Vmem and ``chunk_T``
        timesteps per delivered chunk configure sessions opened with
        :meth:`~repro_torch.spidr.CompiledSNN.open_stream`.
    """

    weight_bits: int = 4
    vmem_bits: Optional[int] = None     # None -> 2*weight_bits - 1
    n_cores: int = 1
    backend: str = "fused"              # "fused" | "torch" | "reference"
    chunk_T: int = 2
    stream_capacity: int = 4
    skip_empty: bool = True
    block: tuple = DEFAULT_BLOCK
    t_block: int = 1
    autotune: bool = False
    # Multi-core compiler knobs.
    device_parallel: Optional[bool] = None
    force_mode: Optional[int] = None     # pin operating mode 1 | 2
    stationarity: Optional[str] = None   # pin "weight" | "vmem"
    assumed_sparsity: float = 0.9

    def __post_init__(self):
        w = self.weight_bits
        v = self.vmem_bits if self.vmem_bits is not None else (
            2 * w - 1 if isinstance(w, int) else None)
        if not isinstance(w, int) or not isinstance(v, int) \
                or (w, v) not in PRECISION_PAIRS:
            near = ", ".join(str(p) for p in _nearest_pairs(
                w if isinstance(w, int) else 0, v if isinstance(v, int) else 0))
            raise ValueError(
                f"weight/Vmem precision pair ({w}, {v}) unsupported — "
                f"nearest supported: {near}")
        object.__setattr__(self, "vmem_bits", v)
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend {self.backend!r} unsupported — supported "
                f"backends: {', '.join(BACKENDS)}")
        _require_positive_int(
            "n_cores", self.n_cores,
            hint="1 runs single-core, 4 matches the paper's grid ablations")
        _require_positive_int("chunk_T", self.chunk_T,
                              hint="timesteps delivered per streaming tick")
        _require_positive_int("stream_capacity", self.stream_capacity,
                              hint="concurrent persistent-Vmem stream slots")
        _require_positive_int(
            "t_block", self.t_block,
            hint="timesteps per Vmem-stationary kernel slab; 1 disables tiling")
        if self.autotune:
            raise NotImplementedError(
                "autotune=True: per-layer kernel-config autotuning is not "
                "ported yet — see ROADMAP.md A8; set t_block instead")
        if self.force_mode is not None and self.force_mode not in (1, 2):
            raise ValueError(
                f"force_mode={self.force_mode!r} unsupported — the macro "
                "has operating modes 1 (fan-in <= 128) and 2 (serialized "
                "high fan-in); pass 1, 2 or None (auto)")
        if self.stationarity is not None \
                and self.stationarity not in ("weight", "vmem"):
            raise ValueError(
                f"stationarity={self.stationarity!r} unsupported — pass "
                "'weight', 'vmem' or None (let the compiler's cost model "
                "choose per layer)")
        if not 0.0 <= self.assumed_sparsity < 1.0:
            raise ValueError(
                f"assumed_sparsity={self.assumed_sparsity!r} unsupported — "
                "needs 0.0 <= s < 1.0 (it feeds the compiler's load-"
                "balancing heuristics; 0.9 matches DVS event streams)")

    @property
    def qspec(self) -> QuantSpec:
        return QuantSpec(self.weight_bits)

    @property
    def multicore(self) -> bool:
        return self.n_cores > 1
