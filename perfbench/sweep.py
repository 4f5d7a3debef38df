"""Find a serve cell's knee: the highest offered rate its fleet sustains.

    python perfbench/sweep.py --workload gesture-serve --seed 5 --seconds 10 \\
        --rates 100,200,300,400

Sets the cell up once (weights, clips, deployment, warm-up), then for each
rate serves a fresh fleet for ``--seconds`` on the cell's own traffic at
that rate and prints one JSON line: streams offered, shed and finished,
finished streams per second, latency percentiles from the due time, the
queue depth over the first and last third of the ticks, and the backlog
when arrivals stop.  A rate is sustained when the queue does not grow
over the window.  The chosen rate goes into the traffic file by hand; the
benchmark's runs never search for one.
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", required=True, help="comma-separated streams/s")
    args = ap.parse_args(argv)
    setup_env.configure()
    import torch

    from perfbench.harness import cell, found, inputs, port, stats, traffic
    from perfbench.harness import trace as tracing

    c = cell.resolve(cell.load_benchmark(), args.workload)
    config, mix = c["config"], c["traffic"]
    if mix["kind"] != "open_serve":
        print(f"sweep: {args.workload} is not a serve cell", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("sweep: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    loop, judge = found.module("loops", "open_serve"), found.module("checks", "open_serve")
    params = inputs.make_weights(config, args.seed, dev)
    clips_host = judge.work(config, mix, args.seed, args.seconds, dev)["clips_host"]
    compiled = loop.setup_serve(config, mix, params, clips_host, dev)
    print(json.dumps({"setup_s": time.monotonic() - T_PROC,
                      "card": torch.cuda.get_device_name(dev)}), flush=True)
    span = tracing.annotate(None)
    for rate in (float(r) for r in args.rates.split(",")):
        fleet = port.serve(compiled, mix)
        sched = traffic.schedule(mix, args.seed, args.seconds, rate)
        rec = loop.drive(fleet, clips_host, sched, args.seconds, span, port.overloaded())
        fleet.shutdown()
        done = [h.request.done_at - (rec.start + due) for due, _, _, h in rec.offered
                if h is not None and h.done]
        finished_in_window = sum(1 for *_, h in rec.offered
                                 if h is not None and h.done and h.request.done_at <= rec.end)
        third = max(1, len(rec.depths) // 3)
        row = {
            "rate": rate, "offered": len(rec.offered),
            "shed": sum(1 for *_, h in rec.offered if h is None),
            "finished": len(done), "finished_in_window": finished_in_window,
            "backlog_at_close": len(rec.offered) - finished_in_window,
            "streams_per_s": (len(done) / (max(h.request.done_at for *_, h in rec.offered
                                               if h is not None and h.done)
                                           - (rec.start + rec.offered[0][0]))
                              if done else None),
            "ms_p50": stats.percentile(done, 50) * 1e3 if done else None,
            "ms_p95": stats.percentile(done, 95) * 1e3 if done else None,
            "depth_first_third": sum(rec.depths[:third]) / third if rec.depths else None,
            "depth_last_third": sum(rec.depths[-third:]) / third if rec.depths else None,
            "depth_max": max(rec.depths) if rec.depths else None,
            "tick_ms_p50": stats.median(rec.ticks) * 1e3 if rec.ticks else None,
            "ticks": len(rec.ticks),
            "late_ms_max": max(rec.late) * 1e3 if rec.late else None,
        }
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
