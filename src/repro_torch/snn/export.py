"""Bit-exact export: fold trained float params into the integer engine.

The train->deploy seam, as ``repro.snn.export``:

  * ``export_network``  — fold float weights into the engine's signed
    integers: per-output-channel power-of-two scales
    (``core.quant.po2_quantize``), int8 weight matrices, and per-channel
    integer thresholds requantized onto each layer's Vmem grid
    (``B_vmem = 2*B_w - 1``).  Runs on the host in float32, so the
    integers equal the reference's.
  * ``deploy``          — build an executable :class:`SNNEngine` from the
    exported integers, optionally compiled across ``n_cores`` SpiDR cores
    through ``compiler.compile_network``.
  * ``save_exported`` / ``load_exported`` — persist the integer artifact
    through ``checkpoint.Checkpointer`` (atomic, validated on reload) in the
    reference's layout: a checkpoint written by either package loads in
    the other.

  * ``verify_roundtrip`` — the proof: the QAT training graph
    (``run_snn(mode="qat")``) and the deployed engine give equal per-layer
    spike counts at every timestep and equal readouts.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..checkpoint.checkpoint import CheckpointError, Checkpointer
from ..compiler import compile_network
from ..core.network import SNNSpec, run_snn
from ..core.quant import (
    PRECISION_PAIRS,
    QuantSpec,
    po2_quantize,
    requantize_threshold,
)
from ..engine.inference import (
    EngineConfig,
    EngineLayer,
    SNNEngine,
    compile_engine,
    run_engine,
)

__all__ = [
    "ExportedLayer",
    "ExportedNetwork",
    "RoundTrip",
    "deploy",
    "dequantize_readout",
    "export_network",
    "load_exported",
    "read_export_meta",
    "save_exported",
    "verify_roundtrip",
]


@dataclasses.dataclass(frozen=True)
class ExportedLayer:
    """One weight layer in deployable integer form (host numpy)."""

    w_q: np.ndarray      # (F, K) int8 signed weights
    scale: np.ndarray    # (K,) float32 power-of-two per-channel scales
    thr_int: np.ndarray  # (K,) int32 thresholds on the layer's Vmem grid


@dataclasses.dataclass(frozen=True)
class ExportedNetwork:
    """A trained network folded into SpiDR's integer weight format.

    ``layers`` is aligned with ``spec.layers``: an :class:`ExportedLayer`
    per weight layer, ``None`` per pool layer.
    """

    name: str
    weight_bits: int
    layers: tuple

    @property
    def qspec(self) -> QuantSpec:
        return QuantSpec(self.weight_bits)


def _host_f32(p) -> torch.Tensor:
    if isinstance(p, torch.Tensor):
        return p.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(p, np.float32))


def export_network(params, spec: SNNSpec, qspec: QuantSpec) -> ExportedNetwork:
    """Fold float params into the engine's signed-integer format.

    Per weight layer: symmetric per-output-channel power-of-two quantization
    of the ``(fan_in, K)`` weights, and the float firing threshold
    requantized onto the layer's integer Vmem grid.  ``params`` may be
    tensors on any device or arrays; the folding runs on the host.
    """
    layers = []
    for layer, p in zip(spec.layers, params):
        if layer.kind not in ("conv", "fc"):
            layers.append(None)
            continue
        neuron = layer.conv.neuron if layer.kind == "conv" else layer.fc.neuron
        q, scale = po2_quantize(_host_f32(p), qspec, axis=0)
        scale_k = scale[0]  # (1, K) -> (K,)
        thr_int, _ = requantize_threshold(neuron.threshold, scale_k, qspec)
        layers.append(ExportedLayer(w_q=q.numpy(), scale=scale_k.numpy(),
                                    thr_int=thr_int.numpy()))
    return ExportedNetwork(name=spec.name, weight_bits=qspec.weight_bits,
                           layers=tuple(layers))


def deploy(
    exported: ExportedNetwork,
    spec: SNNSpec,
    cfg: Optional[EngineConfig] = None,
    n_cores: int = 1,
    device_parallel: Optional[bool] = None,
    device=None,
) -> SNNEngine:
    """Build an executable integer engine from an exported network.

    ``n_cores > 1`` compiles the network across a SpiDR core grid
    (``compiler.compile_network`` -> ``engine.compile_engine``); the result
    is bit-exact with single-core execution under any chunking.  ``cfg``
    defaults to the plain torch backend at the exported precision;
    ``device=None`` means the card.
    """
    cfg = cfg or EngineConfig(exported.qspec, backend="torch")
    if cfg.qspec.weight_bits != exported.weight_bits:
        raise ValueError(
            f"engine executes {cfg.qspec} but the checkpoint was exported "
            f"at {exported.weight_bits}-bit weights; re-export or change "
            "the EngineConfig")
    dev = resolve_device(device)
    layers = []
    for layer, ex in zip(spec.layers, exported.layers):
        if layer.kind in ("conv", "fc"):
            geometry = {}
            if layer.kind == "conv":
                c = layer.conv
                geometry = dict(kh=c.kh, kw=c.kw, stride=c.stride, padding=c.padding)
            neuron = layer.conv.neuron if layer.kind == "conv" else layer.fc.neuron
            layers.append(EngineLayer(
                kind=layer.kind, neuron=neuron,
                w_q=torch.tensor(np.asarray(ex.w_q, np.int8), device=dev),
                w_scale=np.asarray(ex.scale, np.float32),
                thr_int=torch.tensor(np.asarray(ex.thr_int, np.int32), device=dev),
                **geometry))
        elif layer.kind == "pool":
            layers.append(EngineLayer(kind="pool"))
        elif layer.kind == "adaptive_pool":
            layers.append(EngineLayer(kind="adaptive_pool",
                                      target_hw=layer.target_hw))
        else:
            raise ValueError(f"unknown layer kind {layer.kind!r}")
    engine = SNNEngine(spec=spec, cfg=cfg, layers=tuple(layers), device=dev)
    if n_cores > 1:
        schedule = compile_network(spec, n_cores=n_cores, qspec=cfg.qspec)
        engine = compile_engine(engine, schedule, device_parallel=device_parallel)
    return engine


def dequantize_readout(exported: ExportedNetwork, spec: SNNSpec, readout):
    """Map an integer engine readout back onto the training graph's scale.

    ``"rate"`` readouts are plain spike counts (scale-free); ``"vmem"``
    readouts are integers on the last weight layer's grid and dequantize by
    its per-channel power-of-two scale, exactly.  Float32, where
    ``readout`` lies.
    """
    readout = torch.as_tensor(readout)
    if spec.readout == "rate":
        return readout.to(torch.float32)
    last = next(ex for ex in reversed(exported.layers) if ex is not None)
    return readout.to(torch.float32) * torch.as_tensor(
        np.asarray(last.scale, np.float32), device=readout.device)


# ---------------------------------------------------------------------------
# The round-trip proof.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RoundTrip:
    """The QAT training graph against the deployed engine."""

    exact: bool
    readout_mismatch: float      # max |qat - dequantized engine readout|
    spike_mismatch: int          # max |per-timestep per-layer spike counts|

    def __bool__(self) -> bool:
        return self.exact


def verify_roundtrip(params, spec: SNNSpec, engine: SNNEngine, events,
                     exported: Optional[ExportedNetwork] = None,
                     engine_out=None) -> RoundTrip:
    """Prove train->deploy bit-exactness on ``events``.

    Runs the post-STE training graph (``run_snn(mode="qat")`` on the float
    ``params``, without gradient) and the deployed integer ``engine`` on
    the same ``(T, B, H, W, C)`` event streams, on the engine's device,
    and compares the per-timestep per-layer output spike counts and the
    readout (the engine's dequantized through the exported scales).  Exact
    means equal, not close.  ``params`` may be tensors on any device or
    arrays; ``engine_out`` takes a ``run_engine(engine, events)`` result
    already computed.
    """
    exported = exported or export_network(params, spec, engine.cfg.qspec)
    dev = engine.device
    events = torch.as_tensor(events, device=dev)
    params = [None if p is None else torch.as_tensor(
        p.detach() if isinstance(p, torch.Tensor) else np.array(p, np.float32),
        dtype=torch.float32, device=dev) for p in params]
    with torch.no_grad():
        qat_out, qat_counts = run_snn(params, events, spec, engine.cfg.qspec,
                                      mode="qat", record_spikes=True)
    eng = engine_out if engine_out is not None else run_engine(engine, events)
    eng_out = dequantize_readout(exported, spec, eng.readout)
    readout_mismatch = float((qat_out - eng_out).abs().max())
    spike_mismatch = int((qat_counts.to(torch.int64)
                          - eng.spike_counts.to(torch.int64)).abs().max())
    return RoundTrip(exact=readout_mismatch == 0.0 and spike_mismatch == 0,
                     readout_mismatch=readout_mismatch,
                     spike_mismatch=spike_mismatch)


# ---------------------------------------------------------------------------
# Persistence: one Checkpointer step per exported artifact.
# ---------------------------------------------------------------------------
_EXPORT_META_KEY = "exported_snn"


def _as_tree(exported: ExportedNetwork) -> list:
    return [None if ex is None
            else {"w_q": ex.w_q, "scale": ex.scale, "thr_int": ex.thr_int}
            for ex in exported.layers]


def read_export_meta(ckpt: Checkpointer, step: int) -> dict:
    """The ``exported_snn`` metadata of one checkpoint step ({} if absent)."""
    path = os.path.join(ckpt.directory, f"step_{step:09d}", "meta.json")
    with open(path) as f:
        meta = json.load(f)
    return meta.get(_EXPORT_META_KEY) or {}


def save_exported(ckpt: Checkpointer, step: int, exported: ExportedNetwork,
                  spec: Optional[SNNSpec] = None) -> None:
    """Persist an exported network (atomic, one ``step_*`` directory).

    Pass the ``spec`` the network was exported at to record its event
    geometry (``input_hw``/``timesteps``), which ``spidr.load`` restores.
    """
    info = {"name": exported.name, "weight_bits": exported.weight_bits}
    if spec is not None:
        info["input_hw"] = list(spec.input_hw)
        info["timesteps"] = int(spec.timesteps)
    ckpt.save(step, _as_tree(exported), extra_meta={_EXPORT_META_KEY: info})


def _template(spec: SNNSpec) -> list:
    """The exported tree's structure, with the shapes ``spec`` dictates."""
    like = []
    for layer in spec.layers:
        if layer.kind == "conv":
            f, k = layer.conv.kh * layer.conv.kw * layer.c_in, layer.c_out
        elif layer.kind == "fc":
            f, k = layer.c_in, layer.c_out
        else:
            like.append(None)
            continue
        like.append({"w_q": np.zeros((f, k), np.int8),
                     "scale": np.zeros((k,), np.float32),
                     "thr_int": np.zeros((k,), np.int32)})
    return like


def load_exported(ckpt: Checkpointer, spec: SNNSpec,
                  step: Optional[int] = None) -> ExportedNetwork:
    """Reload an exported network, validating the artifact.

    Raises ``ValueError`` on a checkpoint that was not written by
    ``save_exported``, lacks the export metadata fields, or does not match
    ``spec``'s layer structure; :class:`CheckpointError` on a damaged leaf;
    ``FileNotFoundError`` on a missing one.
    """
    if step is None:
        step = ckpt.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint steps under {ckpt.directory}")
    info = read_export_meta(ckpt, step)
    if not info:
        raise ValueError(
            f"checkpoint step {step} in {ckpt.directory} carries no "
            f"'{_EXPORT_META_KEY}' metadata — not an exported network "
            "(was it written by save_exported?)")
    for field in ("name", "weight_bits"):
        if field not in info:
            raise ValueError(
                f"exported checkpoint step {step} is corrupted: metadata "
                f"field '{field}' is missing")
    if info["weight_bits"] not in {w for w, _ in PRECISION_PAIRS}:
        raise ValueError(
            f"exported checkpoint step {step} is corrupted: weight_bits="
            f"{info['weight_bits']!r} is not a supported precision")
    like = _template(spec)
    try:
        tree = ckpt.restore(step, like)
    except CheckpointError:
        raise
    except ValueError as e:
        raise ValueError(
            f"exported checkpoint step {step} does not match the "
            f"'{spec.name}' layer structure: {e}") from e
    layers = []
    for idx, (template, d) in enumerate(zip(like, tree)):
        if d is None:
            layers.append(None)
            continue
        # restore() checks only the leaf count: hold each leaf to the shape
        # and dtype the spec dictates.
        for field, want in template.items():
            got = np.asarray(d[field])
            if got.shape != want.shape or got.dtype != want.dtype:
                raise ValueError(
                    f"exported checkpoint step {step} is corrupted: layer "
                    f"{idx} field '{field}' is {got.dtype}{got.shape}, "
                    f"expected {want.dtype}{want.shape} for '{spec.name}'")
        layers.append(ExportedLayer(w_q=np.asarray(d["w_q"], np.int8),
                                    scale=np.asarray(d["scale"], np.float32),
                                    thr_int=np.asarray(d["thr_int"], np.int32)))
    return ExportedNetwork(name=info["name"], weight_bits=info["weight_bits"],
                           layers=tuple(layers))
