"""Gradient compression with error feedback, the counterpart of
``repro.optim.compression``.

  * int8 quantization with a per-tensor scale and error feedback (the
    residual is carried to the next step: the standard EF-SGD
    construction), or
  * top-k sparsification (a dense mask).

:func:`ef_int8_allreduce` sums the dequantized payloads over a
``torch.distributed`` process group, where the reference ``psum``\\ s over a
mesh axis; without a group there is one member and the sum is the
identity, as ``psum`` over an axis of size 1 is.  ``torch.round`` rounds
half to even as ``jnp.round`` does, and the top-k threshold is a value, so
ties pick the same mask.  Trees are the checkpoint's (dicts, lists,
tuples, NamedTuples; ``None`` leaves stay ``None``).
"""
from __future__ import annotations

from typing import Any

import torch

from ..checkpoint.checkpoint import tree_flatten, tree_unflatten

__all__ = [
    "ef_int8_allreduce",
    "init_error_state",
    "int8_compress",
    "int8_decompress",
    "topk_compress",
]

Tree = Any


def int8_compress(x: torch.Tensor):
    """``(q int8, scale)`` with ``scale = max|x| / 127`` (1 for an all-zero x)."""
    scale = torch.max(torch.abs(x)) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_state(params: Tree) -> Tree:
    return tree_unflatten(params, [None if p is None else torch.zeros_like(p)
                                   for p in tree_flatten(params)])


def ef_int8_allreduce(grads: Tree, error: Tree, group=None):
    """Error-feedback int8 all-reduce: ``(reduced grads, new error)``.

    ``g_hat = Q(g + e)``; ``e' = (g + e) - dequant(g_hat)``; the dequantized
    payloads are summed over ``group`` (on the wire: the int8 tensor and
    one float32 scale).
    """
    def one(g, e):
        if g is None:
            return None, None
        corrected = g + e
        deq = int8_decompress(*int8_compress(corrected))
        new_e = corrected - deq
        if group is not None:
            torch.distributed.all_reduce(deq, group=group)
        return deq, new_e

    out = [one(g, e) for g, e in zip(tree_flatten(grads), tree_flatten(error))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))


def topk_compress(x: torch.Tensor, k_frac: float = 0.01):
    """Keep the top-k |x| entries: ``(x * mask, mask)``."""
    flat = x.reshape(-1)
    k = max(1, int(flat.shape[0] * k_frac))
    thresh = torch.topk(torch.abs(flat), k).values[-1]
    mask = (torch.abs(x) >= thresh).to(x.dtype)
    return x * mask, mask
