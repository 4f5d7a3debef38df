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

        from repro import spidr, serving
        from repro.configs import spidr_gesture, spidr_optflow
        from repro.core import layers, network, neuron, quant
        from repro.engine import inference
        from repro.kernels import fused_lif_gemm, ref
        from repro.snn import data
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, spidr=spidr, serving=serving, quant=quant,
        neuron=neuron, layers=layers, network=network, engine=inference,
        kernels=fused_lif_gemm, ref=ref, data=data,
        spidr_gesture=spidr_gesture, spidr_optflow=spidr_optflow)


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
