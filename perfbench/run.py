"""The port's benchmark: one run of one cell.

    python perfbench/run.py --workload flow-run --seed 7 --seconds 10 --trace 0

Run from the root of a checkout, on a machine with the card(s) the cell
asks for.  Prints the result as one JSON object, the last line of
standard output: the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics and the trace's breakdown (``--trace 1``), whether the
outputs were correct, and, under ``check``, each number compared with its
limit, which also end standard error.  Exits non-zero, printing no
result, without a card, when the cell cannot run, or when JAX or the JAX
package was loaded.
"""
import time

T_PROC = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from perfbench.harness import setup_env  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    setup_env.configure()
    from perfbench.harness import cell

    try:
        result, table = cell.run_cell(args.workload, args.seed, args.seconds,
                                      bool(args.trace), t_proc=T_PROC)
    except (cell.CellError, ImportError, FileNotFoundError, KeyError) as exc:
        print(f"perfbench: {type(exc).__name__}: {exc}", file=sys.stderr, flush=True)
        return 2
    for name, v in table.items():
        print(f"check {name} {v['value']} limit {v['limit']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
