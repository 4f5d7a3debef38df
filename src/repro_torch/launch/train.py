"""Train -> export -> deploy for the paper's SNNs (the reference's
``repro.launch.train --snn``).

    python -m repro_torch.launch.train --snn gesture --weight-bits 4 --steps 200
    python -m repro_torch.launch.train --snn optical-flow --weight-bits 8 --reduced
    python -m repro_torch.launch.train --snn gesture --reduced --device cpu

Deploy-exact surrogate-gradient QAT on synthetic DVS streams
(``snn.train.fit``, checkpointing the float params every ``--ckpt-every``
steps), export into the engine's signed integers, ``CompiledSNN.save``,
then ``spidr.load`` of the saved artifact and ``verify`` with the trained
params on 1 core and on an ``--n-cores`` plan: the deployed engine must
reproduce the training graph's spike trains and readout bit for bit.
Exits non-zero unless every round trip is exact.  Runs on the card unless
``--device`` says otherwise.  Logs go to stderr; one JSON line with the
losses, the round trips, the host seconds and the CUDA kernel launches
goes to stdout.  ``--reduced`` trains at 32x32 (gesture) or 24x32 (flow)
and T=5, as the reference.

The LM path of the reference (``--arch``) is ROADMAP A12.2.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import tempfile
import time

import torch

from .. import resolve_device, spidr
from ..checkpoint.checkpoint import Checkpointer
from ..core.quant import QuantSpec
from ..kernels import LAUNCHES
from ..snn.export import export_network
from ..snn.train import TrainConfig, effective_spec, fit, make_batch_fn, spec_for

__all__ = ["main", "train_snn"]

log = logging.getLogger("repro_torch.train")


def train_snn(args) -> dict:
    """fit (deploy-exact QAT) -> export -> save -> load -> verify on 1 and
    ``args.n_cores`` cores.  Raises ``SystemExit`` if a round trip is not
    exact; returns the run's summary."""
    dev = resolve_device(args.device)
    launches0 = dict(LAUNCHES)
    t0 = time.perf_counter()
    task = args.snn or args.arch.removeprefix("spidr-")
    spec = spec_for(task)
    hw = None
    if args.reduced:
        hw = (32, 32) if spec.readout == "rate" else (24, 32)
    tcfg = TrainConfig(weight_bits=args.weight_bits, lr=args.lr, steps=args.steps,
                       batch=args.batch, seed=args.seed, hw=hw,
                       timesteps=5 if args.reduced else None,
                       ckpt_every=args.ckpt_every)
    state, history = fit(spec, tcfg, ckpt=Checkpointer(args.ckpt_dir), device=dev)

    # The integer artifact, persisted as the facade saves it.
    run_spec = effective_spec(spec, tcfg)
    exported = export_network(state.params, run_spec, QuantSpec(args.weight_bits))
    export_dir = os.path.join(args.ckpt_dir, "exported")
    spidr.compile(exported, run_spec, spidr.DeployTarget(weight_bits=args.weight_bits),
                  device=dev).save(export_dir, step=args.steps)

    # The round trip on a fresh stream, through the reloaded artifact.
    ev, _ = make_batch_fn(run_spec, tcfg, batch=2, device=dev)(
        torch.Generator().manual_seed(99))
    roundtrips = []
    for n_cores in sorted({1, args.n_cores}):
        target = spidr.DeployTarget(weight_bits=args.weight_bits, n_cores=n_cores)
        compiled = spidr.load(export_dir, spec=run_spec, target=target, device=dev)
        report = compiled.verify(ev, params=state.params)
        rt = report.roundtrip
        log.info("round-trip %d-core: exact=%s (readout_mismatch=%g, "
                 "spike_mismatch=%d)", n_cores, report.exact,
                 rt.readout_mismatch, rt.spike_mismatch)
        roundtrips.append({"n_cores": n_cores, "exact": report.exact,
                           "readout_mismatch": rt.readout_mismatch,
                           "spike_mismatch": rt.spike_mismatch})
        if not report.exact:
            raise SystemExit(
                f"train->deploy parity broken on {n_cores} core(s): {report}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    log.info("done: loss %.4f -> %.4f, %s=%.4f; exported %d-bit integers to %s",
             history["loss"][0], history["loss"][-1], history["metric"],
             history["final"], args.weight_bits, export_dir)
    return {"snn": task, "weight_bits": args.weight_bits, "device": str(dev),
            "hw": list(run_spec.input_hw), "timesteps": run_spec.timesteps,
            "loss": history["loss"], history["metric"]: history["final"],
            "roundtrips": roundtrips, "export_dir": export_dir,
            "seconds": time.perf_counter() - t0,
            "launches": {k: n - launches0.get(k, 0) for k, n in LAUNCHES.items()
                         if n != launches0.get(k, 0)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None,
                    help="spidr-gesture / spidr-optical-flow (LM archs: ROADMAP A12.2)")
    ap.add_argument("--snn", choices=("gesture", "optical-flow"), default=None,
                    help="train one of the paper's SNNs through the "
                         "train->export->deploy QAT pipeline")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--weight-bits", type=int, default=4, choices=(4, 6, 8))
    ap.add_argument("--n-cores", type=int, default=1,
                    help="also prove parity on a compiled n-core plan")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch kernels)")
    args = ap.parse_args(argv)
    if args.snn is None and args.arch is None:
        ap.error("pass --snn gesture|optical-flow or --arch spidr-<task>")
    if args.snn is None and not args.arch.startswith("spidr-"):
        raise NotImplementedError(
            f"--arch {args.arch}: training the LM stack is not ported "
            "(ROADMAP A12.2); --snn gesture|optical-flow trains the paper's SNNs")
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(message)s")
    print(json.dumps(train_snn(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
