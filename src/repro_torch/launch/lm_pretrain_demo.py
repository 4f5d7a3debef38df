"""LM-framework demo: train a reduced arch with the full substrate.

    python -m repro_torch.launch.lm_pretrain_demo [--arch qwen1.5-0.5b]
    SPIDR_SMOKE=1 python -m repro_torch.launch.lm_pretrain_demo --device cpu

The walk of the reference's ``examples/lm_pretrain_demo.py``: the config
system, the synthetic token pipeline, AdamW, checkpoint/restart (kill it
mid-run and run it again: it resumes from ``--ckpt-dir``), the watchdog
and the straggler stats, through ``launch.train.train_lm`` at the
``reduced()`` config, batch 8, 64 tokens, lr 1e-3.  ``SPIDR_SMOKE=1``
shrinks the step budget to 12.  Asserts that the loss falls on the
structured data.  Runs on the card unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys

from . import train as T

__all__ = ["main"]


def main(argv=None) -> int:
    smoke = os.environ.get("SPIDR_SMOKE") == "1"
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.lm_pretrain_demo",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=12 if smoke else 60)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: one per arch under the temp dir)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(message)s")
    ns = argparse.Namespace(
        arch=args.arch, steps=args.steps, batch=8, seq=64, lr=1e-3, seed=0,
        reduced=True, ckpt_dir=args.ckpt_dir or T.lm_ckpt_dir(args.arch, True),
        ckpt_every=25, watchdog_s=600.0, device=args.device,
    )
    history = T.train_lm(ns)["history"]
    if not history:
        print(f"nothing to train: {ns.ckpt_dir} already holds step {args.steps}")
        return 0
    print(f"loss: {history[0]:.3f} -> {history[-1]:.3f} over {len(history)} steps")
    if not history[-1] < history[0]:
        raise SystemExit("the loss should decrease on structured data")
    return 0


if __name__ == "__main__":
    sys.exit(main())
