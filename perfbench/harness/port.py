"""The system under test: the PyTorch and CUDA port, ``repro_torch``.

The one module of ``harness/`` that imports the program, inside its
functions; the layer kinds (``layers/``) import it inside theirs, and the
loops (``loops/``) reach it through here.  It builds the program's network
from a configuration file through its layer kinds, deploys it as users do
(``spidr.compile`` with ``DeployTarget``'s defaults but for the stated
precision, core count and backend), serves it (``spidr.serve``), and reads
the program's counter (``kernels.LAUNCHES``) and the names of its CUDA
kernels.  It hands the program the benchmark's float weights and
events and nothing else.
"""
from __future__ import annotations

import pathlib
import re

from . import found
from .setup_env import ROOT

PACKAGE = "repro_torch"
CSRC = ROOT / "src" / PACKAGE / "kernels" / "csrc"
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def program(config: dict, params: list) -> tuple:
    """The program's ``SNNSpec`` for a configuration file, and the float weights
    laid out by the program's layers: each layer's kind (``layers/<kind>.py``)
    gives its program layers and where its weights go."""
    from repro_torch.core.network import SNNSpec
    from repro_torch.core.neuron import NeuronConfig

    n = config["neuron"]
    neuron = NeuronConfig(model=n["model"], reset=n["reset"], threshold=n["threshold"],
                          leak=n["leak"], leak_shift=n["leak_shift"])
    layers, weights = [], []
    for l, w in zip(config["layers"], params):
        for layer, weight in found.module("layers", l["kind"]).program(l, neuron, w):
            layers.append(layer)
            weights.append(weight)
    spec = SNNSpec(name=config["name"], input_hw=tuple(config["input_hw"]),
                   in_channels=config["in_channels"], timesteps=config["timesteps"],
                   layers=tuple(layers), readout=config["readout"])
    return spec, weights


def deploy(config: dict, params: list, device):
    """``spidr.compile`` of the configuration at its stated deployment."""
    from repro_torch import spidr

    d = config["deploy"]
    target = spidr.DeployTarget(weight_bits=d["weight_bits"], vmem_bits=d["vmem_bits"],
                                n_cores=d["n_cores"], backend=d["backend"])
    spec, weights = program(config, params)
    return spidr.compile(spec, weights, target, device=device)


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
