"""Optical-flow SNN inference: bit-exact integer deployment on 1 and 4 cores.

    python -m repro_torch.launch.optical_flow                 # the card, full width
    python -m repro_torch.launch.optical_flow --device cpu --hw 16 16 --timesteps 3

The walk of the reference's ``examples/optical_flow_inference.py``, on
synthetic translating-texture event streams (``snn.data.make_flow_batch``)
and random weights from fixed seeds.  At full width (the paper's DSEC-flow
network, 288x384, T=10, batch 2) it runs:

  a. the float forward ``run_snn(mode="train")`` (on the card one fused
     float kernel launch per weight layer-timestep) and its average
     endpoint error (AEE) against the synthetic flow;
  b. ``spidr.compile`` of the same params on 1 core and on a compiled
     4-core plan, at 4-bit (whole layers placed on cores) and at 8-bit
     (seven of the eight layers channel-split across two cores), each at
     ``t_block`` 1 and 5: every run bit-exact (readout, spike and input
     counts) with the 1-core ``t_block=1`` run and with the plain integer
     datapath (``backend="torch"``);
  c. the params exported to per-channel 8-bit integers
     (``snn.export.export_network``), deployed on 4 cores, saved
     (``CompiledSNN.save``), loaded back (``spidr.load``) and run at
     ``t_block`` 1 and 5, bit-exact with the exported network on 1 core
     and on ``backend="torch"``;
  d. the chip cost of each plan (makespan, energy, load imbalance, routing
     cycles), the layer mapping and the timestep-pipeline simulation, as
     the reference's example prints them.

Each run records its host seconds (synchronized) and the CUDA kernel
launches it made (``kernels.LAUNCHES``; none on the CPU).  Prints a
readable log, then one JSON line with every number.  Exits
non-zero if a run of (b) or (c) is not bit-exact or the float readout is
not finite.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import tempfile
import time

import numpy as np
import torch

from .. import resolve_device, spidr
from ..configs import spidr_optflow
from ..core.energy import HW, cycles_per_chunk, gops, power_mw
from ..core.modes import CoreConfig, map_layer
from ..core.network import init_params, run_snn
from ..core.pipeline import simulate_pipeline
from ..core.quant import QuantSpec
from ..kernels import LAUNCHES
from ..snn.data import make_flow_batch
from ..snn.export import export_network

__all__ = ["inputs", "main", "run"]

FULL = {"hw": (288, 384), "timesteps": 10, "batch": 2}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, dev):
    """``(fn(), host seconds, CUDA kernel launches)`` of one call."""
    before = dict(LAUNCHES)
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    seconds = time.perf_counter() - t0
    return out, seconds, {k: n - before.get(k, 0) for k, n in LAUNCHES.items()
                          if n != before.get(k, 0)}


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in (
        (a.readout, b.readout), (a.spike_counts, b.spike_counts),
        (a.input_counts, b.input_counts)))


def _cost_row(compiled, out) -> dict:
    cost = compiled.cost(out)
    row = {"makespan_cycles": int(cost.makespan_cycles),
           "energy_uj": float(cost.energy_uj),
           "mean_sparsity": float(cost.mean_sparsity)}
    if compiled.schedule is not None:
        row.update(load_imbalance=float(cost.load_imbalance),
                   routing_cycles=int(cost.routing_cycles.sum()),
                   duplication_cycles=int(cost.duplication_cycles),
                   split_layers=compiled.schedule.n_split_layers)
    return row


def _deployments(make_compiled, events, dev, t_blocks, log, label) -> list:
    """Run one family of deployments (1 core and 4 cores, each t_block)
    and hold every run to the 1-core ``t_block=1`` run and to the plain
    datapath."""
    plain = make_compiled(1, 1, "torch").run(events)
    base = None
    rows = []
    for n_cores in (1, 4):
        for t_block in t_blocks:
            compiled = make_compiled(n_cores, t_block, "fused")
            out, seconds, launches = _timed(lambda: compiled.run(events), dev)
            if base is None:
                base = out
            row = {"deployment": label, "n_cores": n_cores, "t_block": t_block,
                   "weight_bits": compiled.target.weight_bits,
                   "bit_exact_vs_1core": _equal(out, base),
                   "bit_exact_vs_torch": _equal(out, plain),
                   "seconds": seconds, "launches": launches,
                   "spikes_per_layer": out.spike_counts.sum(dim=0).tolist(),
                   **_cost_row(compiled, out)}
            if compiled.schedule is not None:
                row["plan"] = compiled.schedule.describe()
            rows.append(row)
            log(f"{label} {row['weight_bits']}-bit, {n_cores} core(s), "
                f"t_block={t_block}: bit-exact vs 1 core {row['bit_exact_vs_1core']}, "
                f"vs backend='torch' {row['bit_exact_vs_torch']}; "
                f"{row['makespan_cycles']} cycles, {row['energy_uj']:.1f} uJ"
                + (f", load imbalance {row['load_imbalance']:.2f}x, routing "
                   f"{row['routing_cycles']} cycles" if n_cores > 1 else ""))
    return rows


def inputs(dev, hw=FULL["hw"], timesteps=FULL["timesteps"], batch=FULL["batch"]):
    """The walk's network, random params (seed 0, on the host) and events
    with their synthetic flow (seed 1, on ``dev``)."""
    spec = spidr_optflow.reduced(hw=tuple(hw), timesteps=timesteps)
    params = init_params(torch.Generator().manual_seed(0), spec)
    events, flow_gt = make_flow_batch(torch.Generator().manual_seed(1), batch=batch,
                                      timesteps=timesteps, hw=tuple(hw), device=dev)
    return spec, params, events, flow_gt


def run(device=None, hw=FULL["hw"], timesteps=FULL["timesteps"],
        batch=FULL["batch"], t_blocks=(1, 5), log=print) -> dict:
    """The walk's four steps; returns what each computed."""
    dev = resolve_device(device)
    spec, params, events, flow_gt = inputs(dev, hw, timesteps, batch)
    sparsity = float((events == 0).to(torch.float32).mean())
    out: dict = {"walk": "optical_flow", "device": str(dev), "hw": list(hw),
                 "T": timesteps, "batch": batch, "input_sparsity": sparsity}

    # a. the float forward --------------------------------------------------
    dev_params = [None if p is None else p.to(dev) for p in params]
    with torch.no_grad():
        (pred, counts), seconds, launches = _timed(lambda: run_snn(
            dev_params, events, spec, QuantSpec(4), record_spikes=True), dev)
    aee = float(torch.linalg.vector_norm(pred - flow_gt, dim=-1).mean())
    out["float_forward"] = {"seconds": seconds, "launches": launches, "aee": aee,
                            "readout_shape": list(pred.shape),
                            "finite": bool(torch.isfinite(pred).all()),
                            "spikes_per_layer": counts.sum(dim=0).tolist()}
    log(f"input sparsity {sparsity:.1%}; untrained AEE {aee:.2f} px/step "
        "(random weights)")

    # b. integer deployments: 1 core and a compiled 4-core plan --------------
    rows = []
    for bits in (4, 8):
        def make(n_cores, t_block, backend, bits=bits):
            return spidr.compile(spec, params, spidr.DeployTarget(
                weight_bits=bits, n_cores=n_cores, t_block=t_block,
                backend=backend), device=dev)
        rows += _deployments(make, events, dev, t_blocks, log, "per-tensor")

    # c. exported per-channel 8-bit integers, saved and loaded ---------------
    exported = export_network(params, spec, QuantSpec(8))
    with tempfile.TemporaryDirectory() as tmp:
        spidr.compile(exported, spec, spidr.DeployTarget(weight_bits=8, n_cores=4),
                      device=dev).save(tmp)

        def make_loaded(n_cores, t_block, backend):
            return spidr.load(tmp, target=spidr.DeployTarget(
                weight_bits=8, n_cores=n_cores, t_block=t_block,
                backend=backend), device=dev)
        rows += _deployments(make_loaded, events, dev, t_blocks, log, "exported")
    out["deployments"] = rows

    # d. the accelerator view: mapping and the timestep pipeline -------------
    core = CoreConfig(QuantSpec(4))
    out["mapping"] = []
    log("layer mapping:")
    for i, shape in enumerate(spec.layer_shapes()):
        m = map_layer(shape, core)
        out["mapping"].append({"layer": i, "fan_in": shape.fan_in, "mode": m.mode,
                               "passes": m.total_passes})
        log(f"  L{i}: fan_in={shape.fan_in:4d} mode={m.mode} passes={m.total_passes}")
    rng = np.random.default_rng(0)
    per_macro_cycles = rng.integers(
        int(2 * 2048 * (1 - sparsity) * 0.5),
        int(2 * 2048 * (1 - sparsity) * 1.5) + 2, (timesteps, 9))
    res = simulate_pipeline(per_macro_cycles)
    hw_point = HW(50e6, 0.9)
    out["pipeline"] = {"makespan_cycles": int(res.makespan),
                       "speedup_vs_sync": float(res.speedup_vs_sync),
                       "chunk_latency_us": cycles_per_chunk(sparsity) / hw_point.freq_hz * 1e6,
                       "power_mw": power_mw(hw_point), "gops": gops(sparsity, 4)}
    log(f"timestep pipeline (Fig 13): {res.makespan} cycles for {timesteps} "
        f"timesteps; {res.speedup_vs_sync:.2f}x vs rigid sync")
    log(f"per-chunk latency {out['pipeline']['chunk_latency_us']:.1f} us; core: "
        f"{out['pipeline']['power_mw']:.1f} mW, {out['pipeline']['gops']:.1f} GOPS "
        "@ measured sparsity")

    out["ok"] = bool(out["float_forward"]["finite"] and math.isfinite(aee) and all(
        r["bit_exact_vs_1core"] and r["bit_exact_vs_torch"] for r in rows))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.optical_flow",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch kernels)")
    ap.add_argument("--hw", type=int, nargs=2, default=list(FULL["hw"]),
                    metavar=("H", "W"), help="event frame size (default 288 384)")
    ap.add_argument("--timesteps", type=int, default=FULL["timesteps"])
    args = ap.parse_args(argv)
    out = run(args.device, hw=tuple(args.hw), timesteps=args.timesteps,
              log=lambda msg: print(msg, file=sys.stderr, flush=True))
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
