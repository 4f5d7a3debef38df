"""Carry the JAX package's parameters into this package.

``repro.core.network.init_params`` returns a list with one float32
``(fan_in, c_out)`` array per weight layer and ``None`` per pool layer.
Converted to numpy, that list becomes the same list of torch tensors here;
``engine.build_engine`` then quantizes them itself and reproduces the JAX
engine's ``w_q`` and ``thr_int`` bit for bit.

``repro.snn.train.TrainState`` holds such a list, AdamW's ``{"mu", "nu"}``
lists of the same structure and the step; :func:`train_state_from_jax`
turns it into the port's ``TrainState``, so both packages can step from
the same state.

``repro.models.model.init_params`` returns the LM's parameter pytree:
nested dicts whose block leaves sit in NamedTuples (``AttentionParams``,
``FFNParams``, ``MoEParams``, ``Mamba2Params``, ``RWKV6Params``), each leaf
layer-stacked, with ``None`` for the leaves a config leaves out (biases,
qk-norm scales, the GELU FFN's gate, the hybrid's missing tail).
The LM parameter tree, with numpy leaves, becomes the port's with
:func:`lm_params_from_jax` (same keys, same field names, same layouts), and
a train state ``(params, {"mu", "nu"})`` with :func:`lm_train_state_from_jax`.

Nothing of JAX is imported: the caller hands over numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device

__all__ = ["lm_params_from_jax", "lm_train_state_from_jax", "params_from_jax",
           "train_state_from_jax"]


def params_from_jax(np_params, device=None) -> list:
    """Numpy parameter list (``None`` for pools) -> float32 tensors on device."""
    dev = resolve_device(device)
    return [None if p is None
            else torch.tensor(np.array(p, np.float32), device=dev)
            for p in np_params]


def train_state_from_jax(state, device=None):
    """The reference's ``TrainState`` (``params``, ``opt_state`` with
    ``mu``/``nu`` lists, ``step``; leaves anything ``numpy.asarray`` takes)
    -> the port's ``snn.train.TrainState`` with float32 tensors on
    ``device``."""
    from .snn.train import TrainState

    opt = state.opt_state
    return TrainState(
        params=params_from_jax(state.params, device),
        opt_state={"mu": params_from_jax(opt["mu"], device),
                   "nu": params_from_jax(opt["nu"], device)},
        step=int(state.step))


def lm_params_from_jax(np_tree, device=None):
    """The LM parameter tree with numpy leaves -> the same tree of tensors
    on ``device``; a NamedTuple with the fields of one of the port's
    parameter groups becomes that group.  Leaves keep their dtype; ``None``
    stays ``None``; any other NamedTuple raises ``TypeError``."""
    from .models.attention import AttentionParams
    from .models.ffn import FFNParams
    from .models.mamba2 import Mamba2Params
    from .models.moe import MoEParams
    from .models.rwkv6 import RWKV6Params

    dev = resolve_device(device)
    groups = {tuple(g._fields): g for g in (AttentionParams, FFNParams, MoEParams,
                                            Mamba2Params, RWKV6Params)}

    def conv(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if hasattr(x, "_fields"):
            group = groups.get(tuple(x._fields))
            if group is None:
                raise TypeError(f"unknown parameter group {type(x).__name__}")
            return group(*(conv(v) for v in x))
        return torch.tensor(np.array(x), device=dev)

    return conv(np_tree)


def lm_train_state_from_jax(np_params, np_opt_state, device=None):
    """The LM train state of the reference (``init_params`` /
    ``init_opt_state`` or a restored checkpoint; numpy leaves) -> the
    port's ``(params, {"mu", "nu"})`` on ``device``, ready for
    ``models.model.make_train_step``.  The moments have the parameters'
    tree."""
    return (lm_params_from_jax(np_params, device),
            {k: lm_params_from_jax(np_opt_state[k], device) for k in ("mu", "nu")})
