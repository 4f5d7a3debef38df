"""Optimizers in plain PyTorch: AdamW, SGD-momentum, Lion.

The reference's functional optimizers (``repro.optim.optimizer``) over a
parameter list with ``None`` holes (the SNNs' pool layers): each returns
``(update_fn, init_state)``, ``update_fn(grads, state, params, step)``
returns ``(updates, state')``, and ``apply_updates`` adds them.  The state
mirrors the parameter list (AdamW's ``{"mu": [...], "nu": [...]}``), so a
reference state converted to numpy carries across
(``convert.train_state_from_jax``).  Nothing is updated in place, except
by :func:`adamw_inplace`, the LM train step's AdamW: the same formula,
written into the parameters and moments leaf by leaf, so a step holds no
second copy of them (the counterpart of the reference's
``donate_argnums``).

``step`` and the schedules are host numbers (the step counter of
``snn.train.TrainState`` is a Python int), so no update waits on the card.
As in the reference, ``adamw`` evaluates the schedule and the bias
corrections at ``step + 1``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

__all__ = [
    "adamw",
    "adamw_inplace",
    "apply_updates",
    "clip_by_global_norm",
    "cosine_schedule",
    "global_norm",
    "linear_warmup_cosine",
    "lion",
    "sgd",
]


def global_norm(tree: list) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every tensor of the list (None skipped)."""
    return torch.sqrt(sum(torch.sum(torch.square(x)) for x in tree if x is not None))


def clip_by_global_norm(grads: list, max_norm: float):
    """Scale ``grads`` so their global norm is at most ``max_norm``:
    ``(clipped, norm)``, with the reference's ``max_norm / (norm + 1e-9)``."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return [None if g is None else g * scale for g in grads], norm


def apply_updates(params: list, updates: list) -> list:
    return [p if u is None else p + u for p, u in zip(params, updates)]


def _zeros_like(params: list) -> list:
    return [None if p is None else torch.zeros_like(p) for p in params]


def _map(upd, n_out: int, *lists) -> tuple:
    """``upd`` over the aligned lists (the gradients first), ``None`` where
    the gradient is None; its ``n_out`` results per leaf as ``n_out`` lists."""
    out = [(None,) * n_out if xs[0] is None else upd(*xs) for xs in zip(*lists)]
    return tuple([o[i] for o in out] for i in range(n_out))


def adamw(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0, params=None,
          lr_schedule: Optional[Callable] = None):
    """Returns ``(update_fn, init_state)``; ``update_fn(grads, state, params,
    step)``.  Decoupled weight decay; ``lr_schedule(step + 1)`` when given."""
    state = None
    if params is not None:
        state = {"mu": _zeros_like(params), "nu": _zeros_like(params)}

    def update_fn(grads, state, params, step):
        step_f = float(step) + 1.0
        cur_lr = lr_schedule(step_f) if lr_schedule is not None else lr
        bc1, bc2 = 1 - b1 ** step_f, 1 - b2 ** step_f

        def upd(g, mu, nu, p):
            mu = b1 * mu + (1 - b1) * g
            nu = b2 * nu + (1 - b2) * torch.square(g)
            u = -cur_lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + eps)
                           + weight_decay * p)
            return u, mu, nu

        updates, mus, nus = _map(upd, 3, grads, state["mu"], state["nu"], params)
        return updates, {"mu": mus, "nu": nus}

    return update_fn, state


@torch.no_grad()
def adamw_inplace(params: list, grads: list, mu: list, nu: list, step, lr: float,
                  b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0) -> None:
    """:func:`adamw`'s update applied in place: ``mu``, ``nu`` and ``params``
    (aligned lists, ``None`` skipped) are overwritten.

    Each value is the functional one bit for bit: the same operations in
    the same order, only into reused buffers (``mu.mul_(b1).add_(g * (1 -
    b1))``, never ``add_(g, alpha=...)``, which fuses a multiply-add and
    rounds once where :func:`adamw` rounds twice).  Two temporaries of
    one leaf's size live at a time.
    """
    step_f = float(step) + 1.0
    bc1, bc2 = 1 - b1 ** step_f, 1 - b2 ** step_f
    for p, g, m, v in zip(params, grads, mu, nu):
        if g is None:
            continue
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(torch.square(g).mul_(1 - b2))
        den = torch.div(v, bc2).sqrt_().add_(eps)
        u = torch.div(m, bc1).div_(den)
        torch.mul(p, weight_decay, out=den)
        p.add_(u.add_(den).mul_(-lr))
        del den, u


def sgd(lr=1e-2, momentum=0.9, nesterov=False, params=None):
    state = _zeros_like(params) if params is not None else None

    def update_fn(grads, state, params, step):
        def upd(g, v):
            v = momentum * v + g
            return (-(lr * (g + momentum * v)) if nesterov else -(lr * v)), v

        return _map(upd, 2, grads, state)

    return update_fn, state


def lion(lr=1e-4, b1=0.9, b2=0.99, weight_decay=0.0, params=None):
    state = _zeros_like(params) if params is not None else None

    def update_fn(grads, state, params, step):
        def upd(g, m, p):
            u = -lr * (torch.sign(b1 * m + (1 - b1) * g) + weight_decay * p)
            return u, b2 * m + (1 - b2) * g

        return _map(upd, 2, grads, state, params)

    return update_fn, state


def cosine_schedule(base_lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = min(max(step / total_steps, 0.0), 1.0)
        return base_lr * (final_frac + (1 - final_frac) * 0.5
                          * (1 + math.cos(math.pi * t)))

    return fn


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), final_frac)

    def fn(step):
        if step < warmup:
            return base_lr * step / max(warmup, 1)
        return cos(step - warmup)

    return fn
