"""Deploy-time static verification for SpiDR deployments.

The reference's ``repro.analysis``, over this package's compiler, chip
models and serving tier.  Four passes over the artifacts ``spidr.compile``
produces — no card, no test vectors, just the compiler IR and the
schedule:

  * :mod:`~repro_torch.analysis.ranges` — **overflow certification**: abstract
    interpretation over the integer datapath proving the int32
    accumulator never wraps before its single saturation point, emitting
    a machine-checkable certificate (re-verifiable by
    :func:`check_certificate`).
  * :mod:`~repro_torch.analysis.schedule_check` — **schedule verification**:
    capacity, legal precision pairs, mode/stationarity consistency, AER
    routing acyclicity, and a static replay of cycle conservation
    against ``engine.cost.estimate_multicore_cost``.
  * :mod:`~repro_torch.analysis.concurrency` — **lock-discipline lint** over
    ``repro_torch.serving`` plus the seeded sync-vs-threaded stress harness.
  * :mod:`~repro_torch.analysis.purity` — **jit-safety lint**: host impurity
    in traced functions, float leakage into the integer engine, and
    leafless-pytree registrations that aren't frozen/immutable.  The port
    traces nothing, so over its own tree the float-leakage rule (PUR003)
    is the one that applies; the lint still gives the reference's verdict
    on any source.

Surfaces: ``spidr.compile(..., check="strict"|"warn"|"off")``,
``CompiledSNN.report()``, and the ``python -m repro_torch.analysis`` CLI
(``docs/analysis.md`` describes the reference's, which this one mirrors).
"""
from __future__ import annotations

from typing import Optional

from ..compiler.schedule import CoreSchedule
from ..core.network import SNNSpec
from ..core.quant import QuantSpec
from .concurrency import (
    StressResult,
    check_lock_discipline,
    check_serving,
    stress_fleet,
)
from .purity import check_module_purity, check_purity
from .ranges import certify_overflow, check_certificate, layer_overflow_facts
from .report import (
    AnalysisError,
    AnalysisReport,
    Violation,
    load_baseline,
    new_violations,
    write_baseline,
)
from .schedule_check import check_schedule

__all__ = [
    "AnalysisError",
    "AnalysisReport",
    "StressResult",
    "Violation",
    "analyze_deployment",
    "certify_overflow",
    "check_certificate",
    "check_lock_discipline",
    "check_module_purity",
    "check_purity",
    "check_schedule",
    "check_serving",
    "layer_overflow_facts",
    "load_baseline",
    "new_violations",
    "stress_fleet",
    "write_baseline",
]


def analyze_deployment(spec: SNNSpec, qspec: QuantSpec,
                       schedule: Optional[CoreSchedule] = None,
                       ) -> AnalysisReport:
    """The compile-time bundle: overflow certification + schedule checks.

    This is what ``spidr.compile(..., check=...)`` runs on every
    deployment — the network-shaped passes only.  The repo-wide lints
    (:func:`check_purity`, :func:`check_serving`) are source properties,
    not deployment properties; the CLI and CI run those.
    """
    report = certify_overflow(spec, qspec)
    if schedule is not None:
        report = report.merge(check_schedule(schedule, spec=spec))
    return report
