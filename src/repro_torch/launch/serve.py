"""Serve DVS event streams through the SNN engine on the card.

    python -m repro_torch.launch.serve --snn gesture --requests 8 --capacity 4
    python -m repro_torch.launch.serve --snn optical-flow --requests 2 --capacity 2 --t-block 5
    python -m repro_torch.launch.serve --snn gesture --torch --device cpu

The network is the paper's Table II configuration at full width with
random weights from a fixed seed.  One ``DeployTarget`` declares the
precision, backend and ``t_block``; the ``CompiledSNN`` serves whole
streams through a
:class:`~repro_torch.serving.BatchWorker`: requests are packed into
fixed-capacity batches and each batch is one engine run.

Flags of the JAX CLI whose code is not ported yet exit with an error that
names the ROADMAP item that ports them.
"""
from __future__ import annotations

import argparse
import logging
import sys
import time

import numpy as np
import torch

from .. import resolve_device, spidr
from ..configs import spidr_gesture, spidr_optflow
from ..core.network import init_params
from ..serving import BatchWorker, StreamRequest
from ..snn.data import make_flow_batch, make_gesture_batch

log = logging.getLogger("repro_torch.serve")

# Flags of ``repro.launch.serve`` that this port does not serve yet.
_NOT_PORTED = {
    "--streaming": "A7 (streaming sessions)",
    "--chunk-T": "A7 (streaming sessions)",
    "--watchdog-s": "A7 (streaming sessions)",
    "--snapshot-dir": "A7 (streaming sessions)",
    "--snapshot-every": "A7 (streaming sessions)",
    "--replicas": "A9 (serving fleet)",
    "--metrics-out": "A9 (serving fleet and obs)",
    "--metrics-every": "A9 (serving fleet and obs)",
    "--trace-out": "A9 (serving fleet and obs)",
    "--log-json": "A9 (serving fleet and obs)",
    "--n-cores": "A5 (multi-core compile)",
    "--arch": "A12 (LM stack)",
    "--prompt-len": "A12 (LM stack)",
    "--max-new": "A12 (LM stack)",
    "--jnp": "nothing: the port's plain backend is --torch",
}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--snn", choices=["gesture", "optical-flow"],
                    help="which paper network serves the event streams")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=4)
    ap.add_argument("--weight-bits", type=int, default=4, choices=[4, 6, 8],
                    dest="weight_bits")
    ap.add_argument("--torch", action="store_true",
                    help="plain integer torch backend instead of the CUDA kernels")
    ap.add_argument("--t-block", type=int, default=1, dest="t_block",
                    help="timesteps per Vmem-stationary kernel slab (fused backend)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch kernels)")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    ap = _parser()
    args, unknown = ap.parse_known_args(argv)
    for tok in unknown:
        flag = tok.split("=", 1)[0]
        if flag in _NOT_PORTED:
            ap.error(f"{flag} is not ported to repro_torch yet — see ROADMAP.md "
                     f"{_NOT_PORTED[flag]}")
    if unknown:
        ap.error(f"unrecognized arguments: {' '.join(unknown)}")
    if args.snn is None:
        ap.error("--snn is required: LM serving (--arch) is not ported yet — "
                 "see ROADMAP.md A12 (LM stack)")
    return args


def serve_snn(args: argparse.Namespace) -> BatchWorker:
    """Compile the network, submit ``args.requests`` streams, serve them."""
    dev = resolve_device(args.device)
    spec = (spidr_gesture if args.snn == "gesture" else spidr_optflow).CONFIG
    params = init_params(torch.Generator().manual_seed(0), spec)
    target = spidr.DeployTarget(weight_bits=args.weight_bits,
                                backend="torch" if args.torch else "fused",
                                t_block=args.t_block)
    compiled = spidr.compile(spec, params, target, device=dev)

    make = make_gesture_batch if args.snn == "gesture" else make_flow_batch
    ev, _ = make(torch.Generator().manual_seed(1), batch=args.requests,
                 timesteps=spec.timesteps, hw=spec.input_hw, device="cpu")
    worker = BatchWorker(compiled, capacity=args.capacity)
    for r in range(args.requests):
        worker.submit(StreamRequest(rid=r, events=ev[:, r].numpy()))
    t0 = time.monotonic()
    while worker.step():
        pass
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.monotonic() - t0
    lat = [r.done_at - r.submitted_at for r in worker.done]
    log.info("served %d %s streams (%dx%d, %d timesteps) in %.3fs "
             "(%.2f streams/s, %d batches); latency p50 %.3fs; backend=%s "
             "t_block=%d device=%s", len(worker.done), args.snn,
             spec.input_hw[0], spec.input_hw[1], spec.timesteps, dt,
             len(worker.done) / dt, worker.batches, float(np.median(lat)),
             compiled.engine.cfg.backend, args.t_block, dev)
    return worker


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(message)s")
    serve_snn(parse_args(argv))


if __name__ == "__main__":
    main()
