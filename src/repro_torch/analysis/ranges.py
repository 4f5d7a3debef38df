"""Overflow certification: abstract interpretation over the compiler IR.

The integer datapath has exactly one wide accumulation: the spike GEMM
``acc = dot(spikes.int32, w.int32)`` computed at int32 before its single
saturation into the (2W-1)-bit Vmem field (``engine/inference.py``,
``kernels/fused_lif_gemm.py``; see ``core/quant.sat_add``).  On the card
that is the int8 x int8 -> int32 tensor-core product of
``csrc/fused_lif_gemm.cu`` (B1/B2) and ``csrc/spike_gemm.cu`` (B4).  Everything
after that point is arithmetic on saturated (2W-1)-bit values whose
interim magnitudes are structurally bounded:

  * GEMM (pre-saturation)  : inputs are binary spikes, weights are
    ``[w_min, w_max]`` integers, so over a fan-in of F active inputs the
    accumulator lies in ``[F*w_min, F*w_max]`` — it can never wrap iff
    ``F * 2^(W-1) <= acc_max``.
  * leak ``v - (v >> k)``  : shrinks ``|v|`` (arithmetic shift rounds
    toward -inf, so the subtracted term has v's sign) — stays in
    ``[v_min, v_max]``.
  * accumulate ``v + partial`` : both operands saturated, so the interim
    sum lies in ``[2*v_min, 2*v_max]`` before re-saturation.
  * threshold              : ``requantize_threshold`` clips ``thr_int``
    into ``[v_min, v_max + 1]``.
  * soft reset ``v - s*thr`` : interim in ``[v_min - (v_max+1),
    v_max - v_min]`` before re-saturation.

This pass propagates those ranges per weight layer of a network (an
:class:`~repro_torch.compiler.ir.NetworkGraph` or the :class:`SNNSpec` it is
built from) and per :class:`QuantSpec`, and emits a *machine-checkable*
certificate: plain JSON holding the primitive facts (fan-in, precision,
accumulator width) and every derived bound, which
:func:`check_certificate` re-derives independently — a tampered or stale
certificate fails re-verification, not just inspection.

``acc_bits`` parameterizes the accumulator width (the silicon's is 32).
Narrower widths are how the negative path is exercised honestly: the
gesture network certifies at 32 bits but provably wraps at 16 — see
``docs/analysis.md``.
"""
from __future__ import annotations

from typing import Union

from ..compiler.ir import LayerNode, NetworkGraph, build_graph
from ..core.network import SNNSpec
from ..core.quant import QuantSpec
from .report import AnalysisReport, Violation

__all__ = [
    "certify_overflow",
    "check_certificate",
    "layer_overflow_facts",
]

#: The silicon's wide-accumulator width (int32 throughout the engine).
DEFAULT_ACC_BITS = 32


def _acc_max(acc_bits: int) -> int:
    return (1 << (acc_bits - 1)) - 1


def layer_overflow_facts(node_idx: int, kind: str, fan_in: int,
                         out_channels: int, qspec: QuantSpec,
                         acc_bits: int = DEFAULT_ACC_BITS) -> dict:
    """Derived integer ranges for one weight layer at one precision.

    Pure arithmetic on the primitive facts — shared by the certifier and
    by :func:`check_certificate`'s independent re-derivation.
    """
    acc_max = _acc_max(acc_bits)
    w_abs_max = 1 << (qspec.weight_bits - 1)          # |w_min| >= w_max
    # Pre-saturation GEMM range over F simultaneously-active binary inputs.
    acc_lo, acc_hi = fan_in * qspec.w_min, fan_in * qspec.w_max
    gemm_bound = fan_in * w_abs_max
    gemm_ok = gemm_bound <= acc_max
    # Smallest count of simultaneously-active inputs that can wrap.
    min_violating = None if gemm_ok else acc_max // w_abs_max + 1
    # Post-saturation neuron-step interims (leak keeps [v_min, v_max];
    # accumulate doubles it; soft reset subtracts thr_int <= v_max + 1).
    interim_max = max(2 * abs(qspec.v_min), 2 * qspec.v_max,
                      abs(qspec.v_min - (qspec.v_max + 1)),
                      qspec.v_max - qspec.v_min)
    neuron_ok = interim_max <= acc_max
    return {
        "node": node_idx,
        "kind": kind,
        "fan_in": fan_in,
        "out_channels": out_channels,
        "w_lo": qspec.w_min,
        "w_hi": qspec.w_max,
        "acc_lo": acc_lo,
        "acc_hi": acc_hi,
        "acc_headroom": acc_max - gemm_bound,
        "saturated_lo": qspec.v_min,
        "saturated_hi": qspec.v_max,
        "threshold_lo": qspec.v_min,
        "threshold_hi": qspec.v_max + 1,
        "neuron_interim_max": interim_max,
        "gemm_ok": gemm_ok,
        "neuron_ok": neuron_ok,
        "ok": gemm_ok and neuron_ok,
        "min_violating_active_inputs": min_violating,
    }


def _graph_of(network: Union[SNNSpec, NetworkGraph]) -> NetworkGraph:
    if isinstance(network, NetworkGraph):
        return network
    if isinstance(network, SNNSpec):
        return build_graph(network)
    raise TypeError(
        f"certify_overflow() takes an SNNSpec or a compiler NetworkGraph, "
        f"got {type(network).__name__}")


def certify_overflow(network: Union[SNNSpec, NetworkGraph],
                     qspec: QuantSpec,
                     acc_bits: int = DEFAULT_ACC_BITS) -> AnalysisReport:
    """Certify that the wide accumulator can never wrap pre-saturation.

    Walks every weight layer of ``network`` and propagates the integer
    value ranges above.  Returns an :class:`AnalysisReport` whose
    ``certificates["overflow"]`` is the machine-checkable certificate and
    whose violations pinpoint each offending layer with the minimal
    violating number of simultaneously-active inputs.
    """
    graph = _graph_of(network)
    acc_max = _acc_max(acc_bits)
    layers = []
    violations = []
    for node in graph.weight_nodes:
        assert isinstance(node, LayerNode) and node.shape is not None
        facts = layer_overflow_facts(node.idx, node.kind, node.shape.fan_in,
                                     node.shape.out_channels, qspec, acc_bits)
        layers.append(facts)
        loc = f"{graph.name}.L{node.idx}"
        if not facts["gemm_ok"]:
            w_abs = 1 << (qspec.weight_bits - 1)
            violations.append(Violation(
                pass_name="overflow", code="OVF001", location=loc,
                message=(
                    f"int{acc_bits} accumulator can wrap before its single "
                    f"saturation point: fan_in {node.shape.fan_in} x |w|_max "
                    f"{w_abs} = {node.shape.fan_in * w_abs} exceeds "
                    f"{acc_max}; any {facts['min_violating_active_inputs']} "
                    f"simultaneously-active inputs overflows at "
                    f"{qspec.weight_bits}/{qspec.vmem_bits}-bit precision")))
        if not facts["neuron_ok"]:
            violations.append(Violation(
                pass_name="overflow", code="OVF002", location=loc,
                message=(
                    f"neuron-step interim |v| can reach "
                    f"{facts['neuron_interim_max']} > int{acc_bits} max "
                    f"{acc_max} at {qspec.weight_bits}/{qspec.vmem_bits}-bit "
                    "precision — the post-saturation datapath itself wraps")))
    certificate = {
        "pass": "overflow",
        "network": graph.name,
        "weight_bits": qspec.weight_bits,
        "vmem_bits": qspec.vmem_bits,
        "acc_bits": acc_bits,
        "acc_max": acc_max,
        "saturation_points": 1,
        "layers": layers,
        "ok": all(f["ok"] for f in layers),
        # Advisory (not a datapath hazard): the engine's per-stream readout
        # accumulator is also int32; a rate readout adds at most one spike
        # per class per timestep, so it cannot wrap before acc_max
        # timesteps — far beyond any stream the serving tier admits.
        "readout_wrap_horizon_timesteps": acc_max,
    }
    return AnalysisReport(
        subject=f"{graph.name}@{qspec.weight_bits}/{qspec.vmem_bits}b",
        passes=("overflow",),
        violations=tuple(violations),
        certificates={"overflow": certificate},
    )


def check_certificate(certificate: dict) -> list:
    """Independently re-verify an overflow certificate.

    Re-derives every bound from the certificate's primitive facts alone
    (fan-in, weight_bits, acc_bits) and compares against the stored
    values.  Returns the list of discrepancies — empty means the
    certificate is arithmetically sound, tampered/stale certificates name
    the first field that fails.
    """
    problems = []
    try:
        qspec = QuantSpec(certificate["weight_bits"])
    except (KeyError, ValueError) as e:
        return [f"certificate has no valid weight_bits: {e}"]
    acc_bits = certificate.get("acc_bits", DEFAULT_ACC_BITS)
    if certificate.get("acc_max") != _acc_max(acc_bits):
        problems.append(
            f"acc_max {certificate.get('acc_max')} != 2^{acc_bits - 1}-1")
    if certificate.get("vmem_bits") != qspec.vmem_bits:
        problems.append(
            f"vmem_bits {certificate.get('vmem_bits')} breaks the "
            f"B_vmem = 2*B_w - 1 invariant (expected {qspec.vmem_bits})")
    ok_all = True
    for stored in certificate.get("layers", ()):
        derived = layer_overflow_facts(
            stored.get("node", -1), stored.get("kind", "?"),
            stored.get("fan_in", 0), stored.get("out_channels", 0),
            qspec, acc_bits)
        ok_all = ok_all and derived["ok"]
        for field, want in derived.items():
            if stored.get(field) != want:
                problems.append(
                    f"layer L{stored.get('node')}: {field} is "
                    f"{stored.get(field)!r}, re-derivation gives {want!r}")
    if certificate.get("ok") != ok_all:
        problems.append(
            f"certificate ok={certificate.get('ok')!r} but re-derivation "
            f"gives {ok_all}")
    return problems
