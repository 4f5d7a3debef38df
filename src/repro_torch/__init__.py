"""SpiDR in PyTorch + CUDA on an NVIDIA H100: the deployed integer SNN and
the RWKV6 LM serving path.

The PyTorch counterpart of ``repro`` (the JAX + Pallas reference, which
stays in the repository as the oracle this package is tested against).
The layout mirrors ``repro`` so each module's counterpart is easy to find:

    core/      integer numerics (QuantSpec, neuron step), im2col/maxpool,
               the paper's two network specs
    kernels/   hand-written CUDA kernels for Hopper (``csrc/*.cu``), their
               wrappers, the plain PyTorch versions beside them, and the
               ``t_block`` autotuner (``autotune``)
    engine/    the fused timestep loop (``run_chunk`` / ``run_engine``),
               multi-core plans (``compile_engine``) and the chip cost models
    compiler/  partition / place / schedule a network onto SpiDR cores
    snn/       synthetic event streams; ``export`` folds float weights into
               per-channel integers
    checkpoint/ atomic, checksummed checkpoints in the reference's format
    obs/       the multi-core pipeline timeline as a Chrome trace
    spidr/     the ``DeployTarget`` -> ``CompiledSNN`` facade (``save`` /
               ``load``, ``snapshot`` / ``restore``, ``serve``)
    serving/   the fleet (``spidr.serve``, ``ServeConfig``, the session
               scheduler) over ``StreamWorker`` / ``BatchWorker`` replicas;
               ``launch/serve.py`` is its CLI
    roofline/  ``PerfModel``: the analytic bound of a deployment at the
               H100's peaks (``CompiledSNN.roofline``)
    analysis/  deploy-time static analysis: the overflow certificate,
               schedule verification, the fleet's lock lint and
               ``stress_fleet``, the purity lint (``spidr.compile(...,
               check=...)``, ``CompiledSNN.report()``,
               ``python -m repro_torch.analysis``)
    models/    the LM stack's ``ssm`` family (RWKV6): prefill on the wkv
               kernel, decode by the recurrence; ``launch/serve.py --arch``
               serves it through ``Server``

    from repro_torch import spidr
    from repro_torch.configs import spidr_gesture
    from repro_torch.core.network import init_params

    params = init_params(torch.Generator().manual_seed(0), spidr_gesture.CONFIG)
    compiled = spidr.compile(spidr_gesture.CONFIG, params,
                             spidr.DeployTarget(backend="fused"))
    out = compiled.run(events)            # (T, B, H, W, C) on the card

Entry points run on the card: ``device=None`` means ``"cuda"`` and raises
when no CUDA device is present.  Pass ``device="cpu"`` explicitly to run
the plain PyTorch versions of the kernels on the CPU.
"""
from __future__ import annotations

import torch

# The public surface is the reference's (``repro.__all__``): the facade and
# the objects that build its inputs.  ``resolve_device`` stays a module
# attribute outside it; it is defined before the re-exports below, because
# the modules they import take it from here.
__all__ = [
    # The deployment facade (the primary public API).
    "spidr",
    "CompiledSNN",
    "DeployTarget",
    "StreamSession",
    "VerifyReport",
    # The serving fleet (spidr.serve).
    "Fleet",
    "ServeConfig",
    # Network construction.
    "SNNSpec",
    "gesture_net",
    "optical_flow_net",
    "init_params",
    # Precision configuration.
    "QuantSpec",
    "SUPPORTED_PRECISIONS",
    # Trained integer artifact (deploys via spidr.compile / spidr.load).
    "ExportedNetwork",
]


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card; a CUDA device without a card raises.

    There is no silent CPU fallback: a caller that wants the plain
    PyTorch path on the CPU asks for it with ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False — run on a machine with an NVIDIA GPU, or pass "
            "device='cpu' to use the plain PyTorch kernels")
    return dev


from . import spidr  # noqa: E402  (after resolve_device: see above)
from .core.network import SNNSpec, gesture_net, init_params, optical_flow_net  # noqa: E402
from .core.quant import SUPPORTED_PRECISIONS, QuantSpec  # noqa: E402
from .snn.export import ExportedNetwork  # noqa: E402
from .spidr import (  # noqa: E402
    CompiledSNN,
    DeployTarget,
    Fleet,
    ServeConfig,
    StreamSession,
    VerifyReport,
)
