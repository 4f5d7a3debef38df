#!/usr/bin/env python3
"""Zero-downtime upgrade drill for the PyTorch port: SIGKILL a streaming
server mid-tick, restore it in a fresh process, compare.

For every configuration of the matrix (gesture and optical flow, 1 and 4
cores, ``fused`` and ``torch`` backends) the drill:

  1. serves a deterministic multi-stream workload uninterrupted in-process
     through ``repro_torch.serving.StreamWorker`` and records every
     stream's final readout, cumulative spikes, cycles and energy (the
     reference);
  2. starts a child process that serves the same workload with a snapshot
     every tick and SIGKILLs *itself mid-tick* at a randomized tick — after
     the session stepped, before any bookkeeping or snapshot — from
     ``StreamWorker.mid_tick_hook``;
  3. starts a second child that restores the latest snapshot
     (``StreamWorker.restore``) and serves to completion;
  4. checks the restored results byte-identical to the reference for
     every stream: no stream lost state.

Usage:
  python tools/upgrade_drill_torch.py --smoke --device cpu     # CPU, 16x16
  python tools/upgrade_drill_torch.py                          # the card
  python tools/upgrade_drill_torch.py --full --task gesture --n-cores 4 --backend fused

``--full`` serves at the network's published geometry (gesture 64x64,
T=20; optical flow 288x384, T=10); ``--task``/``--n-cores``/``--backend``
pick part of the matrix.  ``--device`` defaults to the card; the children
load the kernels the parent built (``kernels/_build/``, named by a hash of
their sources) and rebuild nothing.  Exit status is non-zero if any
configuration mismatches; ``--out`` writes a JSON report with the kill
ticks, per-stream verdicts and each phase's seconds.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
sys.path.insert(0, SRC)

import numpy as np  # noqa: E402

TASKS = ("gesture", "optical-flow")
BACKENDS = ("fused", "torch")


def matrix(tasks=TASKS, cores=(1, 4), backends=BACKENDS) -> list:
    return [{"task": task, "n_cores": n, "backend": backend}
            for task in tasks for n in cores for backend in backends]


def geometry(task: str, smoke: bool, full: bool) -> dict:
    if full:
        from repro_torch.configs import spidr_gesture, spidr_optflow

        spec = (spidr_gesture if task == "gesture" else spidr_optflow).CONFIG
        capacity = 4 if task == "gesture" else 2
        return {"hw": list(spec.input_hw), "timesteps": spec.timesteps,
                "capacity": capacity, "chunk_T": 2, "n_streams": capacity + 2}
    if smoke:
        return {"hw": [16, 16], "timesteps": 6, "capacity": 2,
                "chunk_T": 2, "n_streams": 4}
    return {"hw": [32, 32], "timesteps": 10, "capacity": 3,
            "chunk_T": 2, "n_streams": 6}


def build(cfg: dict):
    """Deterministically compile the config's deployment (any process)."""
    import torch

    from repro_torch import spidr
    from repro_torch.configs import spidr_gesture, spidr_optflow
    from repro_torch.core.network import init_params

    mod = spidr_gesture if cfg["task"] == "gesture" else spidr_optflow
    spec = mod.reduced(hw=tuple(cfg["hw"]), timesteps=cfg["timesteps"])
    params = init_params(torch.Generator().manual_seed(0), spec)
    target = spidr.DeployTarget(
        weight_bits=4, n_cores=cfg["n_cores"], backend=cfg["backend"],
        chunk_T=cfg["chunk_T"], stream_capacity=cfg["capacity"])
    return spidr.compile(spec, params, target, device=cfg["device"])


def make_requests(cfg: dict, seed: int) -> dict:
    """The drill workload: streams of differing lengths (slot churn),
    regenerated identically in every process from the seed alone."""
    from repro_torch.serving import StreamRequest

    h, w = cfg["hw"]
    t_max = cfg["timesteps"]
    rng = np.random.default_rng(seed)
    reqs = {}
    for rid in range(cfg["n_streams"]):
        t = int(rng.integers(max(2, t_max // 2), t_max + 1))
        ev = (rng.random((t, h, w, 2)) < 0.1).astype(np.float32)
        reqs[rid] = StreamRequest(rid=rid, events=ev)
    return reqs


def results_of(server) -> dict:
    return {str(r.rid): {
        "readout": np.asarray(r.readout).tolist(),
        "cycles": int(r.cycles),
        "energy_uj": float(r.energy_uj),
        "spikes": int(r.spikes),
        "timesteps": int(r.cursor),
    } for r in server.done}


def serve_reference(cfg: dict, seed: int):
    """Uninterrupted run; returns (results, n_ticks)."""
    from repro_torch.serving import StreamWorker

    server = StreamWorker(build(cfg), capacity=cfg["capacity"],
                          chunk_T=cfg["chunk_T"])
    for _, req in sorted(make_requests(cfg, seed).items()):
        server.submit(req)
    while server.step():
        pass
    return results_of(server), server.ticks


# ---------------------------------------------------------------------------
# Child modes (each in its own process).
# ---------------------------------------------------------------------------
def child_serve(cfg: dict, seed: int, snap_dir: str, die_at: int) -> None:
    """Serve with per-tick snapshots; SIGKILL ourselves mid-tick at
    ``die_at`` — after the session stepped, before bookkeeping/snapshot.
    The span trace of the doomed run is exported from the hook, before the
    kill, so the parent can report the spans leading into it."""
    from repro_torch import obs
    from repro_torch.serving import StreamWorker

    obs.enable_tracing()
    tracer = obs.default_tracer()
    server = StreamWorker(build(cfg), capacity=cfg["capacity"],
                          chunk_T=cfg["chunk_T"], snapshot_dir=snap_dir,
                          snapshot_every=1)

    def kill_mid_tick(tick: int) -> None:
        if tick == die_at:
            os.makedirs(snap_dir, exist_ok=True)
            tracer.export(os.path.join(snap_dir, "kill_trace.json"))
            os.kill(os.getpid(), signal.SIGKILL)

    server.mid_tick_hook = kill_mid_tick
    for _, req in sorted(make_requests(cfg, seed).items()):
        server.submit(req)
    while server.step():
        pass
    raise SystemExit(3)  # reached only if the kill tick never arrived


def child_restore(cfg: dict, seed: int, snap_dir: str, out: str) -> None:
    """Fresh process: restore the latest snapshot, serve to completion."""
    from repro_torch.serving import StreamWorker

    t0 = time.perf_counter()
    server = StreamWorker.restore(snap_dir, make_requests(cfg, seed),
                                  device=cfg["device"])
    restore_s = time.perf_counter() - t0
    resumed_at = server.ticks
    while server.step():
        pass
    with open(out, "w") as f:
        json.dump({"results": results_of(server), "resumed_at_tick": resumed_at,
                   "final_tick": server.ticks, "restore_s": restore_s}, f)


# ---------------------------------------------------------------------------
# The drill.
# ---------------------------------------------------------------------------
def spawn(extra: list, timeout: int) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, os.path.abspath(__file__)] + extra,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def drill_config(cfg: dict, seed: int, timeout: int = 600) -> dict:
    t0 = time.monotonic()
    reference, n_ticks = serve_reference(cfg, seed)
    reference_s = time.monotonic() - t0
    # Randomized kill tick >= 2, so at least one snapshot exists on disk.
    kill_rng = np.random.default_rng(seed * 1000 + cfg["n_cores"])
    die_at = int(kill_rng.integers(2, max(n_ticks, 2) + 1))
    record = dict(cfg, ticks=n_ticks, die_at_tick=die_at,
                  streams=len(reference), reference_s=reference_s)

    with tempfile.TemporaryDirectory(prefix="spidr_drill_") as tmp:
        snap = os.path.join(tmp, "snap")
        cfg_json = json.dumps(cfg)
        t1 = time.monotonic()
        a = spawn(["--child", "serve", "--cfg", cfg_json, "--dir", snap,
                   "--seed", str(seed), "--die-at", str(die_at)], timeout)
        record["serve_child_s"] = time.monotonic() - t1
        record["serve_returncode"] = a.returncode
        if a.returncode != -signal.SIGKILL:
            record.update(ok=False, error=(
                f"serve child exited {a.returncode}, expected SIGKILL "
                f"({-signal.SIGKILL}): {a.stderr[-2000:]}"))
            return record
        trace_path = os.path.join(snap, "kill_trace.json")
        if os.path.exists(trace_path):
            with open(trace_path) as f:
                spans = [e for e in json.load(f)["traceEvents"]
                         if e.get("ph") == "X"]
            # The spans leading into the kill: the fatal tick's run_chunk
            # is the newest; its serve.tick parent never closed.
            record["kill_trace"] = {
                "total_spans": len(spans),
                "final_spans": [
                    {"name": e["name"], "cat": e.get("cat"),
                     "ts_us": e["ts"], "dur_us": e["dur"],
                     "args": e.get("args", {})}
                    for e in spans[-8:]],
            }
        out = os.path.join(tmp, "results.json")
        t2 = time.monotonic()
        b = spawn(["--child", "restore", "--cfg", cfg_json, "--dir", snap,
                   "--seed", str(seed), "--out", out], timeout)
        record["restore_child_s"] = time.monotonic() - t2
        if b.returncode != 0:
            record.update(ok=False, error=(
                f"restore child exited {b.returncode}: {b.stderr[-2000:]}"))
            return record
        with open(out) as f:
            restored = json.load(f)

    record["resumed_at_tick"] = restored["resumed_at_tick"]
    record["restore_s"] = restored["restore_s"]
    mismatches = []
    for rid, want in reference.items():
        got = restored["results"].get(rid)
        if got != want:
            mismatches.append({"rid": rid, "want_cycles": want["cycles"],
                               "got": None if got is None else got["cycles"]})
    lost = sorted(set(reference) - set(restored["results"]))
    record.update(ok=not mismatches and not lost, mismatches=mismatches,
                  lost_streams=lost, wall_s=time.monotonic() - t0)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny geometry (16x16, T=6): the same matrix")
    ap.add_argument("--full", action="store_true",
                    help="the networks' published geometry")
    ap.add_argument("--task", choices=TASKS, action="append",
                    help="run only this task (repeatable)")
    ap.add_argument("--n-cores", type=int, action="append", dest="n_cores",
                    help="run only this core count (repeatable)")
    ap.add_argument("--backend", choices=BACKENDS, action="append",
                    help="run only this backend (repeatable)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch kernels)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write a JSON report here")
    ap.add_argument("--child", choices=["serve", "restore"], default=None)
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--dir", default=None)
    ap.add_argument("--die-at", type=int, default=None, dest="die_at")
    args = ap.parse_args(argv)

    if args.child is not None:
        cfg = json.loads(args.cfg)
        if args.child == "serve":
            child_serve(cfg, args.seed, args.dir, args.die_at)
        else:
            child_restore(cfg, args.seed, args.dir, args.out)
        return 0

    from repro_torch import resolve_device

    device = str(resolve_device(args.device))
    records = []
    for cfg in matrix(args.task or TASKS, args.n_cores or (1, 4),
                      args.backend or BACKENDS):
        cfg = dict(cfg, device=device,
                   **geometry(cfg["task"], args.smoke, args.full))
        print(f"[drill] {cfg['task']} {cfg['hw'][0]}x{cfg['hw'][1]} "
              f"T={cfg['timesteps']} x {cfg['n_cores']} core(s) x "
              f"{cfg['backend']} on {device} ...", flush=True)
        rec = drill_config(cfg, args.seed)
        verdict = "OK" if rec["ok"] else f"FAIL ({rec.get('error', 'diff')})"
        print(f"[drill]   killed at tick {rec.get('die_at_tick')}/"
              f"{rec.get('ticks')}, resumed at "
              f"{rec.get('resumed_at_tick', '?')}: {verdict}", flush=True)
        records.append(rec)

    ok = bool(records) and all(r["ok"] for r in records)
    report = {"seed": args.seed, "smoke": bool(args.smoke),
              "full": bool(args.full), "device": device, "ok": ok,
              "configs": records}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"[drill] report -> {args.out}")
    print(f"[drill] {'ALL OK' if ok else 'FAILURES'}: "
          f"{sum(r['ok'] for r in records)}/{len(records)} configs "
          "restored with zero lost state", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
