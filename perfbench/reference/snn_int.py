"""Plain PyTorch reference of the deployed integer SNN (SpiDR's datapath).

Works out, from the float weights and the events alone, what a deployment
at ``(weight_bits, vmem_bits)`` computes:

* per-tensor symmetric quantization: ``scale = max|w| / w_max`` in float32,
  ``q = clamp(round_half_even(w / scale))``, the threshold folded to
  ``round(threshold / scale)`` (Python's rounding, in float64);
* a convolution as an NCHW ``unfold`` (its own fan-in order, the weights
  permuted to match) and a float32 product with TF32 off, exact because
  every partial sum is an integer far below 2**24;
* the partial saturated to the Vmem range, then the neuron: leak
  ``V - floor(V / 2**k)`` (LIF), saturating add, fire at ``V >= thr``,
  hard reset ``V * (1 - s)`` or saturating soft reset ``V - s * thr``;
* max pooling on the spike planes, the FC input flattened in
  ``(h, w, c)`` order, a rate readout (summed output spikes) or a Vmem
  readout (the last layer's Vmem, NHWC).

Imports nothing of the program; the semantics are the paper's as the
configuration files state them.  :func:`run` walks all samples of a clip
tensor at once, so callers pass blocks that fit.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass
class Layer:
    kind: str                 # "conv" | "fc" | "pool" | "adaptive_pool"
    w: torch.Tensor = None    # conv: (c_out, c_in*k*k) float32; fc: (c_out, c_in)
    thr: int = 0
    kernel: int = 0
    stride: int = 1
    padding: int = 0
    c_out: int = 0
    window: int = 0
    target_hw: int = 0


def quantize(w: torch.Tensor, weight_bits: int):
    """``(q float32 integers, scale float, w_max)`` of one float weight tensor."""
    w_max = (1 << (weight_bits - 1)) - 1
    w = w.to(torch.float32)
    amax = w.abs().amax()
    amax = torch.where(amax == 0, torch.ones_like(amax), amax)
    scale = amax / w_max
    q = torch.clamp(torch.round(w / scale), -w_max - 1, w_max)
    return q, float(scale)


def prepare(config: dict, params: list, weight_bits: int) -> list:
    """The config's layers with quantized weights and integer thresholds."""
    threshold = float(config["neuron"]["threshold"])
    layers = []
    for spec, p in zip(config["layers"], params):
        kind = spec["kind"]
        if kind in ("conv", "fc"):
            q, scale = quantize(p, weight_bits)
            thr = int(round(threshold / scale))
            if kind == "conv":
                k, c_in = spec["kernel"], spec["c_in"]
                # (k, k, c_in, c_out) fan-in rows -> unfold's (c_in, k, k) order.
                w = q.reshape(k, k, c_in, spec["c_out"]).permute(3, 2, 0, 1)
                layers.append(Layer("conv", w.reshape(spec["c_out"], -1).contiguous(), thr,
                                    k, spec["stride"], spec["padding"], spec["c_out"]))
            else:
                layers.append(Layer("fc", q.t().contiguous(), thr, c_out=spec["c_out"]))
        elif kind == "pool":
            layers.append(Layer("pool", window=spec["window"]))
        elif kind == "adaptive_pool":
            layers.append(Layer("adaptive_pool", target_hw=spec["target_hw"]))
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
    return layers


@contextlib.contextmanager
def _exact_float32():
    """Full float32 products (no TF32) for the duration of a reference run."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _neuron(v, partial, thr, neuron: dict, v_min: int, v_max: int):
    partial = torch.clamp(partial, v_min, v_max)
    if neuron["model"] == "lif" and neuron["leak_shift"] > 0:
        v = v - torch.div(v, 1 << neuron["leak_shift"], rounding_mode="floor")
    v = torch.clamp(v + partial, v_min, v_max)
    s = (v >= thr).to(torch.int32)
    if neuron["reset"] == "hard":
        v = v * (1 - s)
    else:
        v = torch.clamp(v - s * thr, v_min, v_max)
    return v, s


def run(config: dict, layers: list, clips: torch.Tensor, vmem_bits: int,
        readout_at=None) -> dict:
    """Run ``clips`` ``(T, N, H, W, C)`` {0,1} through the prepared layers.

    Returns per sample, as int64 tensors on the clips' device:

    ``out_counts`` / ``in_counts``  ``(T, L, N)`` output spikes and nonzero
                                    inputs of each weight layer per timestep
    ``cols_nnz``                    ``(T, L, N)`` nonzeros of each weight
                                    layer's spike matrix (im2col rows)
    ``readouts``                    ``{t: readout after timestep t}`` for
                                    every ``t`` in ``readout_at`` (default:
                                    the last): ``(N, c_out)`` rate counts or
                                    ``(N, H, W, c_out)`` Vmem, int32
    """
    v_min, v_max = -(1 << (vmem_bits - 1)), (1 << (vmem_bits - 1)) - 1
    neuron = config["neuron"]
    t_steps, n = clips.shape[:2]
    readout_at = {t_steps - 1} if readout_at is None else set(readout_at)
    dev = clips.device
    vmem = [None] * len(layers)
    acc = None
    out_counts, in_counts, cols_nnz, readouts = [], [], [], {}
    with torch.no_grad(), _exact_float32():
        for t in range(t_steps):
            act = clips[t].permute(0, 3, 1, 2).to(torch.float32)   # NCHW {0, 1}
            oc, ic, nz = [], [], []
            for i, l in enumerate(layers):
                if l.kind == "pool":
                    act = F.max_pool2d(act, l.window, l.window)
                    continue
                if l.kind == "adaptive_pool":
                    k = act.shape[2] // l.target_hw
                    act = F.max_pool2d(act, k, k)
                    continue
                ic.append((act != 0).flatten(1).sum(1))
                if l.kind == "conv":
                    h, w = act.shape[2:]
                    cols = F.unfold(act, l.kernel, padding=l.padding, stride=l.stride)
                    nz.append((cols != 0).flatten(1).sum(1))
                    partial = torch.matmul(l.w, cols).transpose(1, 2)  # (N, P, c_out)
                    h_out = (h + 2 * l.padding - l.kernel) // l.stride + 1
                    w_out = (w + 2 * l.padding - l.kernel) // l.stride + 1
                    shape = (n, h_out, w_out, l.c_out)
                else:
                    flat = act.permute(0, 2, 3, 1).reshape(n, -1)    # (h, w, c) order
                    nz.append((flat != 0).sum(1))
                    partial = flat @ l.w.t()                          # (N, c_out)
                    shape = (n, l.c_out)
                partial = partial.round().to(torch.int32).reshape(shape)
                if vmem[i] is None:
                    vmem[i] = torch.zeros(shape, dtype=torch.int32, device=dev)
                vmem[i], s = _neuron(vmem[i], partial, l.thr, neuron, v_min, v_max)
                oc.append(s.flatten(1).sum(1))
                last_v, last_s = vmem[i], s
                act = s.to(torch.float32)
                if l.kind == "conv":
                    act = act.permute(0, 3, 1, 2)
            out_counts.append(torch.stack(oc))
            in_counts.append(torch.stack(ic))
            cols_nnz.append(torch.stack(nz))
            if config["readout"] == "rate":
                acc = last_s.to(torch.int32) if acc is None else acc + last_s
                if t in readout_at:
                    readouts[t] = acc.clone()
            elif t in readout_at:
                readouts[t] = last_v.clone()
    return {"out_counts": torch.stack(out_counts).to(torch.int64),
            "in_counts": torch.stack(in_counts).to(torch.int64),
            "cols_nnz": torch.stack(cols_nnz).to(torch.int64),
            "readouts": readouts}
