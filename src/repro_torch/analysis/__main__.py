"""CLI: certify the paper's deployments and lint the source tree.

``python -m repro_torch.analysis --all`` sweeps both paper networks (DVS
gesture, optical flow) across all three silicon precision pairs at one
and four cores, runs the repo-wide purity and serving-concurrency
lints, and exits nonzero on any error-level finding.

Options::

    --network {gesture,optical_flow}   restrict the sweep (repeatable)
    --bits {4,6,8}                     restrict precisions (repeatable)
    --cores N                          restrict core counts (repeatable)
    --skip-lints                       deployment passes only
    --json PATH                        write the full report (with the
                                       machine-checkable certificates)
    --baseline PATH                    ratchet: pre-existing findings in
                                       the baseline don't fail the run
    --write-baseline PATH              snapshot current findings and exit
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from ..compiler.schedule import compile_network
from ..core.network import SNNSpec, gesture_net, optical_flow_net
from ..core.quant import PRECISION_PAIRS, QuantSpec
from . import (
    AnalysisReport,
    Violation,
    analyze_deployment,
    check_certificate,
    check_purity,
    check_serving,
    load_baseline,
    new_violations,
    write_baseline,
)

NETWORKS = {
    "gesture": gesture_net,
    "optical_flow": optical_flow_net,
}
DEFAULT_BITS = tuple(w for w, _ in PRECISION_PAIRS)
DEFAULT_CORES = (1, 4)


def _analyze_config(spec: SNNSpec, bits: int, cores: int) -> AnalysisReport:
    qspec = QuantSpec(bits)
    schedule = compile_network(spec, n_cores=cores, qspec=qspec) \
        if cores > 1 else None
    report = analyze_deployment(spec, qspec, schedule)
    # Self-check: the emitted certificate must survive independent
    # re-derivation — a certifier bug shows up here, not in silence.
    problems = check_certificate(report.certificates["overflow"])
    for p in problems:
        report = report.merge(AnalysisReport(
            subject=report.subject,
            passes=("overflow",),
            violations=(Violation(
                pass_name="overflow", code="OVFCHK",
                location=report.subject,
                message=f"certificate failed re-verification: {p}"),),
        ))
    subject = f"{spec.name}@{bits}/{qspec.vmem_bits}b x{cores}core"
    return AnalysisReport(
        subject=subject,
        passes=report.passes,
        violations=report.violations,
        certificates={f"{subject}:{k}": v
                      for k, v in report.certificates.items()},
    )


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Deploy-time static verification for SpiDR deployments.")
    parser.add_argument("--all", action="store_true",
                        help="full sweep (the default when nothing is "
                             "restricted)")
    parser.add_argument("--network", action="append",
                        choices=sorted(NETWORKS))
    parser.add_argument("--bits", action="append", type=int,
                        choices=DEFAULT_BITS)
    parser.add_argument("--cores", action="append", type=int)
    parser.add_argument("--skip-lints", action="store_true",
                        help="skip the repo-wide purity/concurrency lints")
    parser.add_argument("--json", metavar="PATH",
                        help="write the full JSON report (certificates "
                             "included)")
    parser.add_argument("--baseline", metavar="PATH",
                        help="only findings absent from this baseline fail")
    parser.add_argument("--write-baseline", metavar="PATH",
                        help="snapshot current findings as the baseline")
    args = parser.parse_args(argv)

    networks = args.network or sorted(NETWORKS)
    bits = args.bits or list(DEFAULT_BITS)
    cores = args.cores or list(DEFAULT_CORES)

    merged = AnalysisReport(subject="repro_torch.analysis")
    for name in networks:
        spec = NETWORKS[name]()
        for b in bits:
            for c in cores:
                report = _analyze_config(spec, b, c)
                print(report.summary())
                merged = merged.merge(report)
    if not args.skip_lints:
        for report in (check_purity(), check_serving()):
            print(report.summary())
            merged = merged.merge(report)

    if args.write_baseline:
        data = write_baseline(args.write_baseline, merged.errors)
        print(f"wrote baseline with {len(data['waived'])} waived "
              f"finding(s) to {args.write_baseline}")
        return 0

    failing = merged.errors
    if args.baseline:
        waived = load_baseline(args.baseline)
        failing = new_violations(failing, waived)
        n_waived = len(merged.errors) - len(failing)
        if n_waived:
            print(f"baseline: {n_waived} pre-existing finding(s) waived")

    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            f.write(merged.to_json())
            f.write("\n")
        print(f"report written to {args.json}")

    n_cfg = len(networks) * len(bits) * len(cores)
    print(f"\n{n_cfg} deployment config(s), "
          f"{len(merged.passes)} pass(es), "
          f"{len(merged.errors)} error(s) "
          f"({len(failing)} failing), "
          f"{len(merged.warnings)} warning(s)")
    return 1 if failing else 0


if __name__ == "__main__":
    sys.exit(main())
