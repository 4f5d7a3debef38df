"""Where the time goes: one full-width network run on the card, profiled.

    python -m repro_torch.launch.profile --snn optical-flow --batch 2 --t-block 1
    python -m repro_torch.launch.profile --snn gesture --batch 4 --t-block 4

Compiles the paper network at full Table II width (4-bit, fused CUDA
kernels, random weights from a fixed seed), warms up, then

  * times ``--repeats`` runs on the host clock, each ending in
    ``torch.cuda.synchronize()`` (no profiler attached);
  * runs once more under ``torch.profiler`` and sums the device time of
    every CUDA kernel by name.

Prints one JSON object: host ms per run, device ms per run, the device's
busy share (device ms / host ms) and the kernels that took the device
time, largest first.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from .. import resolve_device, spidr
from ..configs import spidr_gesture, spidr_optflow
from ..core.network import init_params
from ..snn.data import make_flow_batch, make_gesture_batch


def profile_run(snn: str, batch: int, t_block: int, repeats: int,
                device=None) -> dict:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("profiling measures the card: pass a CUDA device")
    spec = (spidr_gesture if snn == "gesture" else spidr_optflow).CONFIG
    params = init_params(torch.Generator().manual_seed(0), spec)
    compiled = spidr.compile(spec, params, spidr.DeployTarget(
        weight_bits=4, backend="fused", t_block=t_block), device=dev)
    make = make_gesture_batch if snn == "gesture" else make_flow_batch
    events, _ = make(torch.Generator().manual_seed(1), batch=batch,
                     timesteps=spec.timesteps, hw=spec.input_hw, device=dev)

    compiled.run(events)  # warm-up: kernel build and load, allocator
    torch.cuda.synchronize(dev)
    host_ms = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        compiled.run(events)
        torch.cuda.synchronize(dev)
        host_ms.append((time.perf_counter() - t0) * 1e3)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        compiled.run(events)
        torch.cuda.synchronize(dev)
    by_kernel: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = by_kernel.get(e.name, (0, 0.0))
            by_kernel[e.name] = (n + 1, us + e.time_range.elapsed_us())
    device_ms = sum(us for _, us in by_kernel.values()) / 1e3
    host_med = sorted(host_ms)[len(host_ms) // 2]
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:12]
    return {
        "snn": snn, "hw": list(spec.input_hw), "T": spec.timesteps,
        "batch": batch, "t_block": t_block, "card": torch.cuda.get_device_name(dev),
        "host_ms": host_ms, "host_ms_median": host_med,
        "device_ms": device_ms if by_kernel else None,
        "device_busy_share": device_ms / host_med if by_kernel else None,
        "kernels": [{"name": name[:120], "launches": n, "ms": us / 1e3}
                    for name, (n, us) in top],
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.profile",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--snn", choices=["gesture", "optical-flow"], required=True)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--t-block", type=int, default=1, dest="t_block")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    print(json.dumps(profile_run(args.snn, args.batch, args.t_block,
                                 args.repeats)), flush=True)


if __name__ == "__main__":
    main()
