"""Fault-tolerant training loop: checkpoint/restart + watchdog + stragglers.

The counterpart of ``repro.runtime.loop``: a crash (or watchdog timeout)
inside ``run()`` restores the latest checkpoint and REPLAYS from that step,
deterministic because the data pipeline is a pure function of the step.
This is the control loop ``launch/train.py --arch`` drives.

The step function updates the parameters and optimizer state in place
(``models.model.make_train_step``), so a restore copies the checkpoint's
leaves into the live tensors (same device and dtype) instead of handing
numpy arrays to the step as the reference's jitted step accepts.  After
a failure the loop waits for the checkpoint being written before it reads
the latest one, so the step it restores does not depend on the writer
thread's timing.  ``float(metrics["loss"])`` is the step's one host sync,
as in the reference.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import torch

from ..checkpoint.checkpoint import Checkpointer, tree_flatten
from .fault_tolerance import RestartableFailure, StepWatchdog, StragglerDetector

log = logging.getLogger("repro_torch.loop")

__all__ = ["LoopConfig", "TrainingLoop"]


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    checkpoint_every: int = 100
    watchdog_deadline_s: float = 3600.0
    max_restarts: int = 3
    log_every: int = 10


def _restore_into(ckpt: Checkpointer, step: int, tree) -> None:
    """Copy checkpoint ``step``'s leaves into ``tree``'s tensors in place."""
    restored = ckpt.restore(step, tree)
    with torch.no_grad():
        for dst, src in zip(tree_flatten(tree), tree_flatten(restored)):
            if dst is not None:
                dst.copy_(torch.from_numpy(src))


class TrainingLoop:
    def __init__(
        self,
        step_fn: Callable,        # (params, opt_state, step, batch) -> (p, o, metrics)
        batch_fn: Callable,       # step -> batch (pure)
        checkpointer: Checkpointer,
        cfg: LoopConfig,
        metrics_cb: Optional[Callable] = None,
    ):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.ckpt = checkpointer
        self.cfg = cfg
        self.metrics_cb = metrics_cb
        self.watchdog = StepWatchdog(cfg.watchdog_deadline_s)
        self.stragglers = StragglerDetector()
        self.restarts = 0

    def run(self, params, opt_state, start_step: int = 0):
        step = start_step
        # Resume from latest checkpoint if one exists past start_step.
        latest = self.ckpt.latest_step()
        if latest is not None and latest > step:
            log.info("resuming from checkpoint step %d", latest)
            _restore_into(self.ckpt, latest, (params, opt_state))
            step = latest

        history = []
        while step < self.cfg.total_steps:
            try:
                batch = self.batch_fn(step)
                self.watchdog.arm()
                t0 = time.monotonic()
                params, opt_state, metrics = self.step_fn(params, opt_state, step, batch)
                # Block on the loss so watchdog timing covers real execution.
                loss = float(metrics["loss"])
                dt = time.monotonic() - t0
                self.watchdog.disarm()
                self.watchdog.check()
                if self.stragglers.record(dt):
                    log.warning("straggler step %d: %.3fs", step, dt)
                if step % self.cfg.log_every == 0:
                    log.info("step %d loss %.4f (%.3fs)", step, loss, dt)
                if self.metrics_cb:
                    self.metrics_cb(step, metrics, dt)
                history.append(loss)
                step += 1
                if step % self.cfg.checkpoint_every == 0 or step == self.cfg.total_steps:
                    self.ckpt.save_async(step, (params, opt_state))
            except (RestartableFailure, RuntimeError) as e:
                self.watchdog.disarm()
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                log.warning("failure at step %d (%s); restoring step %s", step, e, latest)
                if latest is None:
                    raise
                _restore_into(self.ckpt, latest, (params, opt_state))
                step = latest
        self.ckpt.wait()
        return params, opt_state, history
