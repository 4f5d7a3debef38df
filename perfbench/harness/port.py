"""The system under test: the PyTorch and CUDA port, ``repro_torch``.

The one module of the harness that imports the program.  It builds the
program's network from a configuration file, deploys it as users do
(``spidr.compile`` with ``DeployTarget``'s defaults but for the stated
precision, core count and backend), serves it (``spidr.serve``), and
reads the program's counter (``kernels.LAUNCHES``) and the names of its
CUDA kernels.  It hands the program the benchmark's float weights and
events and nothing else.
"""
from __future__ import annotations

import pathlib
import re

from .setup_env import ROOT

PACKAGE = "repro_torch"
CSRC = ROOT / "src" / PACKAGE / "kernels" / "csrc"
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def build_spec(config: dict):
    """The program's ``SNNSpec`` for a configuration file."""
    from repro_torch.core.layers import SpikingConvParams, SpikingDenseParams
    from repro_torch.core.network import SNNLayer, SNNSpec
    from repro_torch.core.neuron import NeuronConfig

    n = config["neuron"]
    neuron = NeuronConfig(model=n["model"], reset=n["reset"], threshold=n["threshold"],
                          leak=n["leak"], leak_shift=n["leak_shift"])
    layers = []
    for l in config["layers"]:
        kind = l["kind"]
        if kind == "conv":
            layers.append(SNNLayer("conv", l["c_in"], l["c_out"], conv=SpikingConvParams(
                l["kernel"], l["kernel"], l["stride"], l["padding"], neuron)))
        elif kind == "fc":
            layers.append(SNNLayer("fc", l["c_in"], l["c_out"], fc=SpikingDenseParams(neuron)))
        elif kind == "pool":
            if l["window"] != 2:
                raise ValueError("the program pools 2x2 windows only")
            layers.append(SNNLayer("pool"))
        elif kind == "adaptive_pool":
            layers.append(SNNLayer("adaptive_pool", target_hw=l["target_hw"]))
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
    return SNNSpec(name=config["name"], input_hw=tuple(config["input_hw"]),
                   in_channels=config["in_channels"], timesteps=config["timesteps"],
                   layers=tuple(layers), readout=config["readout"])


def deploy(config: dict, params: list, device):
    """``spidr.compile`` of the configuration at its stated deployment."""
    from repro_torch import spidr

    d = config["deploy"]
    target = spidr.DeployTarget(weight_bits=d["weight_bits"], vmem_bits=d["vmem_bits"],
                                n_cores=d["n_cores"], backend=d["backend"])
    return spidr.compile(build_spec(config), params, target, device=device)


def serve(compiled, traffic: dict):
    """A ``spidr.serve`` fleet with the traffic's geometry and, where the mix
    names one, its admission bound (``max_queue``)."""
    from repro_torch import spidr

    bound = {"max_queue": traffic["max_queue"]} if "max_queue" in traffic else {}
    return spidr.serve(compiled, n_replicas=traffic["replicas"], capacity=traffic["capacity"],
                       chunk_T=traffic["chunk_T"], mode=traffic["mode"], **bound)


def overloaded():
    """The exception ``Fleet.submit`` sheds a stream with."""
    from repro_torch.spidr import FleetOverloaded

    return FleetOverloaded


def launches() -> int:
    """Kernel launches of the program so far (all entry points)."""
    from repro_torch.kernels import LAUNCHES

    return sum(LAUNCHES.values())


def kernel_names() -> dict:
    """``{source stem: [__global__ function names]}`` of the program's CUDA sources."""
    out = {}
    for src in sorted(pathlib.Path(CSRC).glob("*.cu")):
        out[src.stem] = _GLOBAL.findall(src.read_text())
    return out
