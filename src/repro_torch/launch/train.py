"""The training entry point (the reference's ``repro.launch.train``): the
LMs on the synthetic token pipeline, and train -> export -> deploy for
the paper's SNNs.

    python -m repro_torch.launch.train --arch qwen1.5-0.5b --steps 50
    python -m repro_torch.launch.train --arch rwkv6-7b --reduced --device cpu --steps 3
    python -m repro_torch.launch.train --snn gesture --weight-bits 4 --steps 200
    python -m repro_torch.launch.train --snn optical-flow --weight-bits 8 --reduced
    python -m repro_torch.launch.train --snn gesture --reduced --device cpu

``--arch`` (any of the ten LMs; ``--reduced`` for the reference's small
config): float32 parameters from ``--seed``, AdamW moments, the train step
(``models.model.make_train_step``, remat on, in-place AdamW) over a
``TokenPipeline`` of ``--batch`` x ``--seq`` tokens (the stub frontends of
chameleon and musicgen get bfloat16 embeddings), run by ``TrainingLoop``:
a checkpoint every ``--ckpt-every`` steps into ``--ckpt-dir`` (default a
directory per arch under the temp dir), a ``--watchdog-s`` deadline per
step, resume from the latest checkpoint there.  Prints one JSON line:
arch, parameters, steps, first and last loss, seconds, peak GB (on the
card), restarts, stragglers and the kernel launches (B7 for rwkv6 on the
card: twice per layer per step, the forward and its remat recompute).

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
from ..configs.base import get_config, list_archs
from ..data.pipeline import TokenPipeline
from ..core.quant import QuantSpec
from ..kernels import LAUNCHES
from ..models import model as M
from ..runtime.loop import LoopConfig, TrainingLoop
from ..snn.export import export_network
from ..snn.train import TrainConfig, effective_spec, fit, make_batch_fn, spec_for

__all__ = ["main", "train_lm", "train_snn"]

log = logging.getLogger("repro_torch.train")


def _launch_delta(before: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in LAUNCHES.items() if n != before.get(k, 0)}


def lm_ckpt_dir(arch: str, reduced: bool) -> str:
    """The default checkpoint directory of an LM run (one per arch and size,
    so a run never resumes another model's checkpoint)."""
    return os.path.join(tempfile.gettempdir(),
                        f"repro_torch_lm_{arch}{'_reduced' if reduced else ''}")


def train_lm(args) -> dict:
    """Train an LM on the synthetic token pipeline through ``TrainingLoop``;
    returns the run's summary (``history``: the loss of every step run,
    replays included)."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    log.info("arch=%s params=%.2fM device=%s", cfg.name, cfg.param_count() / 1e6, dev)
    launches0 = dict(LAUNCHES)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = M.init_params(torch.Generator(device=dev).manual_seed(args.seed), cfg)
    opt_state = M.init_opt_state(params)
    train_step = M.make_train_step(cfg, lr=args.lr)
    pipe = TokenPipeline(batch=args.batch, seq_len=args.seq, vocab=cfg.vocab_size,
                         seed=args.seed, embeds_dim=0 if cfg.embed_inputs else cfg.d_model,
                         device=dev)
    ckpt_dir = args.ckpt_dir or lm_ckpt_dir(args.arch, args.reduced)
    loop = TrainingLoop(step_fn=train_step, batch_fn=pipe.batch_at,
                        checkpointer=Checkpointer(ckpt_dir),
                        cfg=LoopConfig(total_steps=args.steps,
                                       checkpoint_every=args.ckpt_every,
                                       watchdog_deadline_s=args.watchdog_s))
    t0 = time.perf_counter()
    params, opt_state, history = loop.run(params, opt_state)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    if history:
        log.info("done: %d steps in %.1fs; loss %.4f -> %.4f; stragglers=%d restarts=%d",
                 len(history), seconds, history[0], history[-1],
                 loop.stragglers.flagged, loop.restarts)
    return {"arch": cfg.name, "device": str(dev), "reduced": bool(args.reduced),
            "params": cfg.param_count(), "steps": args.steps, "batch": args.batch,
            "seq": args.seq, "history": history,
            "loss_first": history[0] if history else None,
            "loss_last": history[-1] if history else None, "seconds": seconds,
            "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else None),
            "restarts": loop.restarts, "stragglers": loop.stragglers.flagged,
            "ckpt_dir": ckpt_dir, "launches": _launch_delta(launches0)}


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
            "seconds": time.perf_counter() - t0, "launches": _launch_delta(launches0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None,
                    help="an LM (" + ", ".join(list_archs()) + ") or "
                         "spidr-gesture / spidr-optical-flow")
    ap.add_argument("--snn", choices=("gesture", "optical-flow"), default=None,
                    help="train one of the paper's SNNs through the "
                         "train->export->deploy QAT pipeline")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128, help="LM: tokens per sequence")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--weight-bits", type=int, default=4, choices=(4, 6, 8))
    ap.add_argument("--n-cores", type=int, default=1,
                    help="also prove parity on a compiled n-core plan")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: under the temp dir, one "
                         "per LM arch and size; repro_torch_ckpt for --snn)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--watchdog-s", type=float, default=3600.0, dest="watchdog_s",
                    help="LM: per-step watchdog deadline in seconds")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch kernels)")
    args = ap.parse_args(argv)
    if args.snn is None and args.arch is None:
        ap.error("pass --arch NAME, --snn gesture|optical-flow or --arch spidr-<task>")
    lm = args.snn is None and not args.arch.startswith("spidr-")
    if lm and args.arch not in list_archs():
        ap.error(f"unknown --arch {args.arch}; the LMs are: {', '.join(list_archs())}")
    if not lm and args.ckpt_dir is None:
        args.ckpt_dir = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(message)s")
    print(json.dumps(train_lm(args) if lm else train_snn(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
