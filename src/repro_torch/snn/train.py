"""Surrogate-gradient BPTT training for the paper's SNNs (QAT at 4/6/8 bit).

The accelerator needs no modified training (Table III, "Modified Training:
No"): networks are trained offline by surrogate-gradient BPTT with
quantization-aware weights, then deployed bit-exactly.  This is that
offline trainer, as ``repro.snn.train``:

  loss = cross-entropy over rate-coded output spikes   (gesture)
         average endpoint error (AEE) on final Vmem    (optical flow)

The default mode is ``"qat"``, the deploy-exact forward (per-channel
power-of-two fake quant, scaled Vmem saturation, the digital leak shift),
whose spike trains equal the exported integer engine's (``snn.export``);
``mode="train"`` keeps the float-dynamics STE path, which on the card runs
the fused float kernel (B3) under autograd.

  * ``train_step`` / ``evaluate`` — one batched update / metric pass.
  * ``fit``                       — a training run on the synthetic DVS
    streams: warmup + cosine LR, periodic eval, optional checkpoints of
    the float params (``checkpoint.Checkpointer``, the reference's format).
  * ``precision_sweep``           — train + export at every weight/Vmem
    precision pair (4/7, 6/11, 8/15), the paper's Fig 16 driver.

Randomness comes from explicit ``torch.Generator``s, drawn on the CPU, so
a seed gives the same initial weights and batches on the CPU and the card.
The flow loss's gradient at a zero endpoint error is 0 here, where the
reference's ``jnp.linalg.norm`` gives NaN (ROADMAP C8).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import torch

from .. import resolve_device
from ..checkpoint.checkpoint import Checkpointer
from ..core.network import SNNSpec, gesture_net, init_params, optical_flow_net, run_snn
from ..core.quant import QuantSpec
from ..optim.optimizer import adamw, apply_updates, clip_by_global_norm, linear_warmup_cosine

__all__ = [
    "TrainConfig",
    "TrainState",
    "effective_spec",
    "evaluate",
    "fit",
    "init_train_state",
    "make_batch_fn",
    "precision_sweep",
    "spec_for",
    "train_step",
]

log = logging.getLogger("repro_torch.snn.train")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training configuration (the reference's fields and defaults)."""

    weight_bits: int = 4
    mode: str = "qat"            # "qat" (deploy-exact) | "train" (float STE)
    lr: float = 1e-3
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    # Schedule and loop shape (``fit``; ``train_step`` needs the schedule).
    steps: int = 100
    warmup: int = 10
    lr_final_frac: float = 0.1
    batch: int = 8
    timesteps: Optional[int] = None     # None -> spec.timesteps
    hw: Optional[tuple] = None          # None -> spec.input_hw
    eval_every: int = 0                 # 0 = eval only at the end
    eval_batch: int = 32
    eval_batches: int = 2
    ckpt_every: int = 0                 # 0 = no checkpointing
    seed: int = 0

    def __post_init__(self):
        if self.mode not in ("qat", "train"):
            raise ValueError(f"TrainConfig.mode must be 'qat' or 'train', got {self.mode!r}")


@dataclasses.dataclass
class TrainState:
    params: list       # float32 tensors, None per pool layer
    opt_state: dict    # AdamW's {"mu": [...], "nu": [...]}
    step: int


def _state_of(params: list, cfg: TrainConfig) -> TrainState:
    _, opt_state = adamw(lr=cfg.lr, weight_decay=cfg.weight_decay, params=params)
    return TrainState(params=params, opt_state=opt_state, step=0)


def init_train_state(generator: torch.Generator, spec: SNNSpec,
                     cfg: TrainConfig) -> TrainState:
    """Fresh parameters (``init_params``, on the generator's device) and a
    zero AdamW state."""
    return _state_of(init_params(generator, spec), cfg)


def _loss_fn(params, batch, spec: SNNSpec, cfg: TrainConfig):
    inputs, target = batch
    out, _ = run_snn(params, inputs, spec, QuantSpec(cfg.weight_bits), mode=cfg.mode)
    if spec.readout == "rate":
        logp = torch.log_softmax(out, dim=-1)  # spike counts as logits
        loss = -logp.gather(1, target[:, None].to(torch.int64)).mean()
        acc = (out.argmax(dim=-1) == target).to(torch.float32).mean()
        return loss, {"loss": loss, "accuracy": acc}
    aee = torch.linalg.vector_norm(out - target, dim=-1).mean()
    return aee, {"loss": aee, "aee": aee}


def train_step(state: TrainState, batch, spec: SNNSpec, cfg: TrainConfig):
    """One batched BPTT update (clip, warmup-cosine AdamW): ``(state',
    metrics)``, the metrics 0-d tensors (``loss``, ``accuracy`` or ``aee``,
    ``grad_norm``) where the batch lies."""
    params = [None if p is None else p.detach().requires_grad_(True)
              for p in state.params]
    with torch.enable_grad():
        loss, metrics = _loss_fn(params, batch, spec, cfg)
        leaves = torch.autograd.grad(loss, [p for p in params if p is not None])
    it = iter(leaves)
    grads = [None if p is None else next(it) for p in params]
    with torch.no_grad():
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        schedule = linear_warmup_cosine(cfg.lr, cfg.warmup, cfg.steps, cfg.lr_final_frac)
        update_fn, _ = adamw(lr=cfg.lr, weight_decay=cfg.weight_decay,
                             lr_schedule=schedule)
        updates, opt_state = update_fn(grads, state.opt_state, state.params, state.step)
        new_params = apply_updates(state.params, updates)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = gnorm
    return TrainState(new_params, opt_state, state.step + 1), metrics


def evaluate(params, batches, spec: SNNSpec, cfg: TrainConfig,
             metric: str = "accuracy") -> float:
    """The mean of ``metric`` over ``batches`` (no gradient)."""
    vals = []
    with torch.no_grad():
        for batch in batches:
            vals.append(float(_loss_fn(params, batch, spec, cfg)[1][metric]))
    return sum(vals) / len(vals)


# ---------------------------------------------------------------------------
# Training runs on the synthetic DVS streams.
# ---------------------------------------------------------------------------
def effective_spec(spec: SNNSpec, cfg: TrainConfig) -> SNNSpec:
    """``spec`` with the config's frame-size/timestep overrides applied: the
    spec training runs, and therefore the one to export and deploy."""
    return dataclasses.replace(
        spec,
        input_hw=tuple(cfg.hw) if cfg.hw else spec.input_hw,
        timesteps=cfg.timesteps or spec.timesteps,
    )


def make_batch_fn(spec: SNNSpec, cfg: TrainConfig, batch: Optional[int] = None,
                  device=None) -> Callable:
    """``generator -> (events, target)`` for ``spec``'s head, on ``device``
    (None: the card); the draws come from the generator's device."""
    from .data import make_flow_batch, make_gesture_batch

    spec = effective_spec(spec, cfg)
    make = make_gesture_batch if spec.readout == "rate" else make_flow_batch
    b, dev = batch or cfg.batch, resolve_device(device)
    return lambda g: make(g, batch=b, timesteps=spec.timesteps, hw=spec.input_hw,
                          device=dev)


def _eval_metric(spec: SNNSpec) -> str:
    return "accuracy" if spec.readout == "rate" else "aee"


def fit(spec: SNNSpec, cfg: TrainConfig, generator: Optional[torch.Generator] = None,
        ckpt: Optional[Checkpointer] = None, log_every: int = 20, device=None):
    """Train ``spec`` on synthetic DVS streams for ``cfg.steps`` updates.

    ``generator`` (a CPU generator; default seeded with ``cfg.seed``) gives
    three seeds: the initial weights, the training batches and the eval
    batches (the same ones at every eval).  Runs on ``device`` (None: the
    card, which raises without one).  Returns ``(state, history)``: the
    per-step losses, the periodic eval points and the final eval metric
    (``accuracy`` for rate heads, ``aee`` for flow heads).
    """
    dev = resolve_device(device)
    spec = effective_spec(spec, cfg)
    generator = torch.Generator().manual_seed(cfg.seed) if generator is None else generator
    s_init, s_data, s_eval = torch.randint(0, 2 ** 62, (3,), generator=generator).tolist()
    params = init_params(torch.Generator().manual_seed(s_init), spec)
    state = _state_of([None if p is None else p.to(dev) for p in params], cfg)
    g_data = torch.Generator().manual_seed(s_data)
    batch_fn = make_batch_fn(spec, cfg, device=dev)
    eval_fn = make_batch_fn(spec, cfg, batch=cfg.eval_batch, device=dev)
    metric = _eval_metric(spec)

    def run_eval():
        g = torch.Generator().manual_seed(s_eval)
        return evaluate(state.params, [eval_fn(g) for _ in range(max(cfg.eval_batches, 1))],
                        spec, cfg, metric)

    losses, evals = [], []
    t0 = time.time()
    for step in range(cfg.steps):
        state, m = train_step(state, batch_fn(g_data), spec, cfg)
        losses.append(float(m["loss"]))
        if log_every and step % log_every == 0:
            log.info("step %d/%d loss=%.4f grad_norm=%.2f", step, cfg.steps,
                     losses[-1], float(m["grad_norm"]))
        if cfg.eval_every and (step + 1) % cfg.eval_every == 0:
            evals.append((step + 1, run_eval()))
        if ckpt is not None and cfg.ckpt_every and (step + 1) % cfg.ckpt_every == 0:
            ckpt.save_async(step + 1, state.params)
    if ckpt is not None:
        ckpt.wait()
    final = run_eval()
    history = {"loss": losses, "evals": evals, "metric": metric, "final": final,
               "wall_s": time.time() - t0}
    log.info("fit(%s, %db): loss %.4f -> %.4f, %s=%.4f in %.1fs",
             spec.name, cfg.weight_bits,
             losses[0] if losses else float("nan"),
             losses[-1] if losses else float("nan"),
             metric, final, history["wall_s"])
    return state, history


def spec_for(task: str) -> SNNSpec:
    """``"gesture"`` / ``"optical-flow"`` -> the paper's network spec."""
    if task in ("gesture", "spidr-gesture"):
        return gesture_net()
    if task in ("optical-flow", "optical_flow", "flow", "spidr-optical-flow"):
        return optical_flow_net()
    raise ValueError(f"unknown SNN task {task!r}")


def precision_sweep(task: str = "gesture", bits: tuple = (4, 6, 8),
                    cfg: Optional[TrainConfig] = None, spec: Optional[SNNSpec] = None,
                    generator: Optional[torch.Generator] = None, device=None) -> dict:
    """Train + export one network per weight/Vmem precision pair.

    For each ``b`` in ``bits``: ``fit`` at ``b``-bit weights ((2b-1)-bit
    Vmem), every run from the same generator state (the reference reuses
    its key), then fold into the integer format.  Returns ``{bits:
    {"state", "history", "exported", "metric"}}``.
    """
    from .export import export_network

    base = cfg or TrainConfig()
    spec = spec or spec_for(task)
    out = {}
    for b in bits:
        bcfg = dataclasses.replace(base, weight_bits=b)
        g = None
        if generator is not None:
            g = torch.Generator().set_state(generator.get_state())
        state, history = fit(spec, bcfg, generator=g, device=device)
        exported = export_network(state.params, effective_spec(spec, bcfg), QuantSpec(b))
        out[b] = {"state": state, "history": history, "exported": exported,
                  "metric": history["final"]}
    return out
