"""Dense FFN: SwiGLU (3 matrices) or GELU (2 matrices).

The counterpart of ``repro.models.ffn``.  The reference names a
``spidr_quant`` flag for a quantized serving path that it never wires in;
like the reference, the FFN here is plain matrix products.  ``jax.nn.gelu``
is the tanh approximation, so this one is too.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .common import dense_init

__all__ = ["FFNParams", "ffn_forward", "init_ffn"]

#: The leaves used in float32 whatever ``x.dtype`` (none: all cast to it).
FLOAT32_LEAVES = ()


class FFNParams(NamedTuple):
    w_gate: Optional[torch.Tensor]  # (D, F) -- None for the gelu variant
    w_up: torch.Tensor              # (D, F)
    w_down: torch.Tensor            # (F, D)


def init_ffn(generator: torch.Generator, d_model: int, d_ff: int,
             variant: str = "swiglu") -> FFNParams:
    return FFNParams(
        w_gate=dense_init(generator, (d_model, d_ff)) if variant == "swiglu" else None,
        w_up=dense_init(generator, (d_model, d_ff)),
        w_down=dense_init(generator, (d_ff, d_model)),
    )


def ffn_forward(p: FFNParams, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    up = x @ p.w_up.to(dt)
    if p.w_gate is not None:  # SwiGLU
        h = F.silu(x @ p.w_gate.to(dt)) * up
    else:  # GELU
        h = F.gelu(up, approximate="tanh")
    return h @ p.w_down.to(dt)
