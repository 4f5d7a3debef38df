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

__all__ = ["resolve_device"]


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
