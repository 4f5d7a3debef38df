"""The control of a cell's check: the reference one precision step lower, in
the program's place, judged by the same comparison as the program.

    python perfbench/control.py --workload flow-run --seeds 1,2,3 [--calls 400]

For each seed it makes the cell's weights and samples or clips, runs the
reference at the stated precision and the control at the nearest precision
below it (the same 4-bit weights, the silicon's lowest; Vmem one bit
narrower: 6 bits for the stated 7), and judges, as a run does, every answer
of a window: ``--calls`` calls of a closed-loop cell (about as many as one
run makes), or every stream an open-loop cell's schedule offers in
``--seconds``.  Prints one JSON line per seed with the verdict and the
numbers compared beside their limits.  The control must come out not
correct; the benchmark's own runs never run it.
"""
import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from perfbench.harness import setup_env  # noqa: E402


def readings(workload: str, seed: int, *, calls: int, seconds: float, device,
             vmem_bits=None, config=None, traffic=None) -> tuple:
    """``check.verdict`` of the control in the program's place: ``(correct,
    {name: {"value", "limit"}})``.  ``vmem_bits`` replaces the control's
    precision (a test puts the stated one there to see the path read 0)."""
    from perfbench.harness import cell, check, found, inputs

    c = cell.resolve(cell.load_benchmark(), workload)
    config, mix = config or c["config"], traffic or c["traffic"]
    judge = found.module("checks", mix["kind"])
    d = config["deploy"]
    vb = d["vmem_bits"] - 1 if vmem_bits is None else vmem_bits
    params = inputs.make_weights(config, seed, device)
    work = judge.work(config, mix, seed, seconds, device)
    ref = judge.reference(config, mix, params, work, d["vmem_bits"], device)
    ctl = judge.reference(config, mix, params, work, vb, device)
    return check.verdict(judge.compare(judge.control_answers(ctl, work, calls), work, ref),
                         judge.LIMITS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--calls", type=int, default=400)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    setup_env.configure()
    import torch

    if not torch.cuda.is_available():
        print("control: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        correct, table = readings(args.workload, seed, calls=args.calls, seconds=args.seconds,
                                  device=torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": correct,
                          "check": table}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
