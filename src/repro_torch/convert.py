"""Carry the JAX package's float parameters into this package.

``repro.core.network.init_params`` returns a list with one float32
``(fan_in, c_out)`` array per weight layer and ``None`` per pool layer.
Converted to numpy, that list becomes the same list of torch tensors here;
``engine.build_engine`` then quantizes them itself and reproduces the JAX
engine's ``w_q`` and ``thr_int`` bit for bit.  Nothing of JAX is imported:
the caller hands over numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device

__all__ = ["params_from_jax"]


def params_from_jax(np_params, device=None) -> list:
    """Numpy parameter list (``None`` for pools) -> float32 tensors on device."""
    dev = resolve_device(device)
    return [None if p is None
            else torch.tensor(np.array(p, np.float32), device=dev)
            for p in np_params]
