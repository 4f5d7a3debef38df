"""Shared fixtures of the ``test_torch_*`` parity tests.

The JAX package is imported inside a session fixture, never at module
level: importing ``repro.engine`` warns that ``jax.experimental.shard_map``
is deprecated, and the repository's pytest settings turn a deprecation
attributed to a ``repro`` module into an error.  The fixture silences
exactly that message while it imports, so the reference is available to
these tests without changing how any other test file collects.
"""
from __future__ import annotations

import types
import warnings

import numpy as np
import pytest
import torch


@pytest.fixture(scope="session")
def jax_ref():
    """The JAX reference modules, as one namespace."""
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message="jax.experimental.shard_map is deprecated")
        import jax
        import jax.numpy as jnp

        from repro import analysis, compiler, spidr, serving
        from repro.analysis import __main__ as analysis_cli
        from repro.checkpoint import checkpoint
        from repro.configs import base as lm_configs
        from repro.configs import spidr_gesture, spidr_optflow
        from repro.core import (cim_macro, energy, layers, modes, network, neuron,
                                pipeline, quant, s2a, zero_skip)
        from repro.engine import cost, inference, streaming
        from repro.kernels import (autotune, fused_lif_gemm, lif_step, quant_matmul,
                                   ref, spike_gemm, wkv_chunk)
        from repro.launch import serve as lm_serve
        from repro.models import common as lm_common
        from repro.models import model as lm_model
        from repro.models import rwkv6, transformer
        from repro.optim import optimizer
        from repro.obs import logs as obs_logs
        from repro.obs import metrics as obs_metrics
        from repro.obs import timeline
        from repro.obs import trace as obs_trace
        from repro.roofline import analysis as roofline
        from repro.runtime import fault_tolerance
        from repro.snn import data, export, train
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, analysis=analysis, analysis_cli=analysis_cli,
        spidr=spidr, serving=serving, quant=quant,
        neuron=neuron, layers=layers, network=network, engine=inference,
        kernels=fused_lif_gemm, ref=ref, data=data,
        spike_gemm=spike_gemm, lif_step=lif_step, modes=modes, energy=energy,
        pipeline=pipeline, cost=cost, cim_macro=cim_macro,
        spidr_gesture=spidr_gesture, spidr_optflow=spidr_optflow,
        lm_configs=lm_configs, lm_common=lm_common, rwkv6=rwkv6,
        transformer=transformer, lm_model=lm_model, wkv_chunk=wkv_chunk,
        quant_matmul=quant_matmul, lm_serve=lm_serve, compiler=compiler,
        s2a=s2a, zero_skip=zero_skip, timeline=timeline, export=export,
        checkpoint=checkpoint, streaming=streaming, obs_metrics=obs_metrics,
        obs_trace=obs_trace, obs_logs=obs_logs, fault_tolerance=fault_tolerance,
        autotune=autotune, roofline=roofline, optimizer=optimizer, train=train)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import or collection."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def np_of(x) -> np.ndarray:
    """Any tensor or array -> numpy (for comparisons across frameworks)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_same(a, b) -> None:
    """Exact equality of values and shape (tolerance 0)."""
    a, b = np_of(a), np_of(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)
