"""The port's public surface equals the reference's.

``repro_torch.__all__`` and ``repro_torch.spidr.__all__`` name exactly the
objects ``repro.__all__`` and ``repro.spidr.__all__`` name, each resolves,
the top-level names alias the ``spidr`` package's objects, and
``resolve_device`` stays a module attribute outside ``__all__``.  Plus the
fleet's lock contract: the lock-discipline lint finds nothing in
``repro_torch.serving``.
"""
import importlib

import pytest

import repro_torch
from _torch_parity import jax_ref  # noqa: F401
from repro_torch import spidr
from repro_torch.analysis import check_serving


@pytest.mark.parametrize("module", ["", ".spidr"])
def test_all_equals_the_reference(jax_ref, module):
    got = importlib.import_module("repro_torch" + module)
    want = importlib.import_module("repro" + module)
    assert set(got.__all__) == set(want.__all__)
    assert len(got.__all__) == len(set(got.__all__))


@pytest.mark.parametrize("module", ["repro_torch", "repro_torch.spidr"])
def test_every_exported_name_resolves(module):
    mod = importlib.import_module(module)
    for name in mod.__all__:
        assert getattr(mod, name) is not None, name


def test_facade_symbols_are_the_same_objects():
    for name in ("CompiledSNN", "DeployTarget", "Fleet", "ServeConfig",
                 "StreamSession", "VerifyReport"):
        assert getattr(repro_torch, name) is getattr(spidr, name)
    assert repro_torch.spidr is spidr


def test_resolve_device_stays_outside_the_surface():
    assert "resolve_device" not in repro_torch.__all__
    assert str(repro_torch.resolve_device("cpu")) == "cpu"
    for name in ("SessionScheduler", "StreamProgress"):
        assert name not in spidr.__all__
        assert getattr(importlib.import_module("repro_torch.serving"), name)


def test_fleet_lock_contract_holds():
    """No write of fleet state outside ``self._lock`` (CON001) and no
    blocking call under it (CON002)."""
    report = check_serving()
    assert not report.errors, report.summary()
