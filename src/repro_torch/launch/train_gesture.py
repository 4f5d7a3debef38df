"""Train the paper's gesture SNN for a few hundred steps, then deploy it.

    python -m repro_torch.launch.train_gesture [--steps 200] [--bits 4]
    python -m repro_torch.launch.train_gesture --smoke --device cpu

The walk of the reference's ``examples/train_gesture_snn.py``:
surrogate-gradient BPTT with deploy-exact QAT at the chosen SpiDR
precision on synthetic DVS gesture streams (``snn.train.train_step``),
checkpoints of the float params every 100 steps, evaluation on held-out
batches, then deployment through the ``spidr`` facade: export ->
compile -> verify (the train->deploy round trip) -> cost on the chip
models.  ``--smoke`` (or ``SPIDR_SMOKE=1``) shrinks steps, frames and
timesteps.  Runs on the card unless ``--device`` says otherwise.  Exits
non-zero unless the round trip is exact.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np
import torch

from .. import resolve_device, spidr
from ..checkpoint.checkpoint import Checkpointer
from ..core.network import gesture_net
from ..core.quant import QuantSpec
from ..snn.data import make_gesture_batch
from ..snn.export import export_network
from ..snn.train import TrainConfig, evaluate, init_train_state, train_step

__all__ = ["main"]


# Defaults of --steps, --batch, --timesteps, --hw: (full, smoke).
_DEFAULTS = {"steps": (200, 5), "batch": (8, 2), "timesteps": (8, 2), "hw": (64, 16)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train_gesture",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="a few steps on small frames (as SPIDR_SMOKE=1)")
    for name, (full, small) in _DEFAULTS.items():
        ap.add_argument(f"--{name}", type=int, default=None,
                        help=f"default {full}, {small} with --smoke")
    ap.add_argument("--bits", type=int, default=4, choices=(4, 6, 8))
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "spidr_gesture_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch kernels)")
    args = ap.parse_args(argv)
    smoke = args.smoke or os.environ.get("SPIDR_SMOKE") == "1"
    for name, pair in _DEFAULTS.items():
        if getattr(args, name) is None:
            setattr(args, name, pair[smoke])
    dev = resolve_device(args.device)

    hw = (args.hw, args.hw)
    run_spec = dataclasses.replace(gesture_net(), input_hw=hw, timesteps=args.timesteps)
    cfg = TrainConfig(weight_bits=args.bits, lr=2e-3)
    state = init_train_state(torch.Generator(device=dev).manual_seed(0), run_spec, cfg)
    ckpt = Checkpointer(args.ckpt)
    g = torch.Generator().manual_seed(1)

    def batch(size):
        return make_gesture_batch(g, batch=size, timesteps=args.timesteps, hw=hw,
                                  device=dev)

    print(f"training gesture SNN (Table II) @ {args.bits}/{2 * args.bits - 1}-bit "
          f"for {args.steps} steps on {dev}")
    t0 = time.time()
    for step in range(args.steps):
        state, m = train_step(state, batch(args.batch), run_spec, cfg)
        if step % 20 == 0:
            print(f"  step {step:4d} loss {float(m['loss']):.4f} "
                  f"acc {float(m['accuracy']):.2f}")
        if (step + 1) % 100 == 0:
            ckpt.save_async(step + 1, state.params)
    ckpt.wait()
    dt = time.time() - t0

    accs = [evaluate(state.params, [batch(16)], run_spec, cfg)
            for _ in range(2 if smoke else 4)]
    print(f"\ntrained {args.steps} steps in {dt:.1f}s; eval acc "
          f"{np.mean(accs):.2f} (chance 1/11 = 0.09)")

    # Deploy: export the QAT integers, compile onto a target, prove the
    # round trip, and price an inference on the chip models.
    exported = export_network(state.params, run_spec, QuantSpec(args.bits))
    compiled = spidr.compile(exported, state.params,
                             spidr.DeployTarget(weight_bits=args.bits),
                             spec=run_spec, device=dev)
    ev, _ = batch(2)
    report = compiled.verify(ev)
    cost = compiled.cost(compiled.run(ev))
    print(f"deployed on SpiDR via {compiled!r}:\n"
          f"  train->deploy round trip exact={report.exact}; "
          f"{cost.makespan_cycles} cycles, {cost.energy_uj:.1f} uJ per "
          f"inference ({cost.mean_sparsity:.1%} measured sparsity)")
    return 0 if report.exact else 1


if __name__ == "__main__":
    sys.exit(main())
