"""Where the time goes: one full-width run on the card, profiled.

    python -m repro_torch.launch.profile --snn optical-flow --batch 2 --t-block 1
    python -m repro_torch.launch.profile --snn optical-flow --n-cores 1 4 --weight-bits 4 8 --t-block 1 5
    python -m repro_torch.launch.profile --snn gesture --batch 4 --t-block 4
    python -m repro_torch.launch.profile --snn optical-flow --stream --batch 2 --chunk-T 5 --t-block 5 1
    python -m repro_torch.launch.profile --arch rwkv6-7b --prompt-len 512 --batch 4
    python -m repro_torch.launch.profile --arch moonshot-v1-16b-a3b --prompt-len 64 --batch 4
    python -m repro_torch.launch.profile --arch qwen1.5-0.5b --train --batch 8
    python -m repro_torch.launch.profile --arch rwkv6-7b --train --batch 8 --layers 12
    python -m repro_torch.launch.profile --float-forward gesture
    python -m repro_torch.launch.profile --float-forward optical-flow

``--snn``: compiles the paper network at full Table II width (fused CUDA
kernels, random weights from a fixed seed) and profiles one
``CompiledSNN.run`` for every combination of ``--n-cores`` (a compiled
multi-core plan above 1), ``--weight-bits`` and ``--t-block`` given
(default: 1 core, 4-bit, ``t_block=1``), one line each; with ``--stream``
one steady-state tick of a ``StreamWorker`` instead (``--batch`` live
streams in as many slots, ``--chunk-T`` timesteps per tick, the per-tick
rewind mark included), with the device time of the host copies and the
host time of one ``state_dict``.  ``--arch`` (any of the reference's ten
LMs): builds the LM at full published width (random weights from a fixed
seed, bfloat16 serving copies drawn layer by layer,
``init_serving_params``) and profiles one prefill of ``--prompt-len``
tokens (one request, as the server admits them) and one decode step over
``--batch`` slots against a context of ``--prompt-len``.
With ``--train``: the LM's train step instead (float32 masters from a
fixed seed, ``--layers`` cutting the depth, ``--batch`` sequences of the
train CLI's 128 tokens from the synthetic pipeline, remat on, in-place
AdamW): ``--repeats`` steps
on the host clock, one line each (host ms, peak GB, loss), then one more
step under ``torch.profiler``, one line with its device ms, the busy
share (device ms over the median host ms), and the shares of B7 (the wkv
kernel), of B7's plain backward (``models.rwkv6._wkv_backward``), of
AdamW (``optim.optimizer.adamw_inplace``) and of the matrix products.
``--float-forward gesture``: the quickstart's float
forward (``run_snn(mode="train")`` on the gesture net at 64x64, T=10,
batch 4, random weights and events from fixed seeds; one fused float
kernel launch per weight layer-timestep); ``--float-forward
optical-flow``: the same forward on the flow net at full width (288x384,
T=10, batch 2, the optical-flow walk's step a).  Each workload is
warmed up, then

  * timed ``--repeats`` times on the host clock, each run ending in
    ``torch.cuda.synchronize()`` (no profiler attached);
  * run once more under ``torch.profiler``, summing the device time of
    every CUDA kernel by name.

Prints one JSON object per workload: host ms per run, device ms per run,
the device's busy share (device ms / host ms) and the kernels that took
the device time, largest first; for the LM also the share of the wkv
kernel, of the matrix products, of the attention blocks (projections
included) and of the MoE layers (router, dispatch, experts, combine);
for the float forward the share of the fused float kernel (B3).  Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time

import torch

from .. import resolve_device, spidr
from ..configs import spidr_gesture, spidr_optflow
from ..core.network import init_params
from ..snn.data import make_flow_batch, make_gesture_batch

# Substrings of the device kernels that are matrix products (cuBLAS,
# cuBLASLt, CUTLASS) in a profile.
_GEMM_NAMES = ("gemm", "nvjet", "cutlass", "xmma", "gemv")

# The block functions whose device time the LM profile reports apart:
# ``transformer``'s names -> the profiler range their calls run in.
_LM_RANGES = {"attention_forward": "attention", "decode_attention": "attention",
              "moe_forward": "moe"}
TRAIN_SEQ = 128  # tokens per sequence of a profiled train step (the train CLI's)

# Every profiler range label a profile reads (the train step adds B7's
# plain backward and the in-place AdamW).
_RANGE_LABELS = frozenset({*_LM_RANGES.values(), "wkv_backward", "adamw"})


def _card(device):
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("profiling measures the card: pass a CUDA device")
    return dev


def _measure(fn, dev, repeats: int) -> dict:
    """Host-clock repeats of ``fn`` (synchronized), then one profiled run
    summed by kernel name."""
    fn()  # warm-up: kernel build and load, allocator
    torch.cuda.synchronize(dev)
    host_ms = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    res = _measure_once(fn, dev)
    host_med = sorted(host_ms)[len(host_ms) // 2]
    return {"card": res.pop("card"), "host_ms": host_ms, "host_ms_median": host_med,
            **res, "device_busy_share": (res["device_ms"] / host_med
                                         if res["device_ms"] is not None else None)}


def _measure_once(fn, dev) -> dict:
    """One run of ``fn`` under ``torch.profiler``: device ms, the kernels
    by device time (``by_kernel``: name -> (launches, us)) and the
    device time of each profiler range of ``_RANGE_LABELS``
    (``by_range``)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize(dev)
    by_kernel: dict = {}
    kernel_sums: dict = {}   # a ``_ranges`` range: the device time of its kernels
    spans: dict = {}         # its span on the device timeline, where traced
    for e in prof.events():
        cuda = e.device_type == torch.autograd.DeviceType.CUDA
        if e.name in _RANGE_LABELS:
            into, us = (spans, e.time_range.elapsed_us()) if cuda else \
                (kernel_sums, e.device_time_total)
            into[e.name] = into.get(e.name, 0.0) + us
        elif cuda:
            n, us = by_kernel.get(e.name, (0, 0.0))
            by_kernel[e.name] = (n + 1, us + e.time_range.elapsed_us())
    by_range = kernel_sums if any(kernel_sums.values()) else spans
    device_ms = sum(us for _, us in by_kernel.values()) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:12]
    return {
        "card": torch.cuda.get_device_name(dev),
        "device_ms": device_ms if by_kernel else None,
        "by_kernel": by_kernel, "by_range": by_range,
        "kernels": [{"name": name[:120], "launches": n, "ms": us / 1e3}
                    for name, (n, us) in top],
    }


@contextlib.contextmanager
def _ranges(module, ranges: dict):
    """Run each named function of ``module`` inside a profiler range of
    its label while the block is open (nothing is wrapped outside it)."""
    saved = {name: getattr(module, name) for name in ranges}

    def wrap(fn, label):
        def inner(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return inner

    for name, label in ranges.items():
        setattr(module, name, wrap(saved[name], label))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def profile_lm(arch: str, prompt_len: int, batch: int, repeats: int,
               device=None) -> list:
    """One prefill (B=1, ``prompt_len`` tokens) and one decode step over
    ``batch`` slots of the full-width LM, against ``prompt_len`` cached
    positions."""
    from ..configs.base import get_config
    from ..models import model as M
    from ..models import transformer
    from ..models.transformer import init_decode_state

    dev = _card(device)
    cfg = get_config(arch)
    params = M.init_serving_params(torch.Generator(device=dev).manual_seed(0), cfg)
    g = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=g, device=dev)
    prefill, decode = M.make_prefill_step(cfg), M.make_decode_step(cfg)
    cache = init_decode_state(cfg, batch, prompt_len + 1, device=dev)
    cache["len"] = torch.tensor(prompt_len, dtype=torch.int32, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (batch, 1), generator=g, device=dev)
    out = []
    for name, fn in (("prefill", lambda: prefill(params, {"tokens": prompt})),
                     ("decode", lambda: decode(params, cache, {"tokens": tokens}))):
        with torch.no_grad(), _ranges(transformer, _LM_RANGES):
            res = _measure(fn, dev, repeats)
        by_kernel = res.pop("by_kernel")
        by_range = res.pop("by_range")
        total = sum(us for _, us in by_kernel.values()) or 1.0

        def share(pred):
            return sum(us for k, (_, us) in by_kernel.items() if pred(k.lower())) / total

        out.append({"arch": arch, "workload": name, "layers": cfg.n_layers,
                    "d_model": cfg.d_model,
                    "tokens": prompt_len if name == "prefill" else batch,
                    "batch": 1 if name == "prefill" else batch, **res,
                    "wkv_share": share(lambda k: "wkv" in k),
                    "gemm_share": share(lambda k: any(s in k for s in _GEMM_NAMES)),
                    "attention_share": by_range.get("attention", 0.0) / total,
                    "moe_share": by_range.get("moe", 0.0) / total})
    return out


def profile_lm_train(arch: str, batch: int, seq: int, repeats: int,
                     n_layers: int | None = None, device=None) -> list:
    """``repeats`` timed train steps of the LM, then one profiled step."""
    from ..configs.base import get_config
    from ..data.pipeline import TokenPipeline
    from ..models import model as M
    from ..models import rwkv6
    from ..optim import optimizer

    dev = _card(device)
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    opt_state = M.init_opt_state(params)
    step_fn = M.make_train_step(cfg, lr=1e-3)
    pipe = TokenPipeline(batch, seq, cfg.vocab_size, seed=0,
                         embeds_dim=0 if cfg.embed_inputs else cfg.d_model, device=dev)
    head = {"arch": arch, "workload": "train_step", "layers": cfg.n_layers,
            "d_model": cfg.d_model, "params": cfg.param_count(), "batch": batch,
            "seq": seq, "card": torch.cuda.get_device_name(dev)}
    state = {"params": params, "opt": opt_state, "step": 0}

    def one():
        state["params"], state["opt"], metrics = step_fn(
            state["params"], state["opt"], state["step"], pipe.batch_at(state["step"]))
        state["step"] += 1
        return float(metrics["loss"])

    rows, host = [], []
    one()  # warm-up: kernel build and load, allocator
    for _ in range(repeats):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        loss = one()
        torch.cuda.synchronize(dev)
        host.append((time.perf_counter() - t0) * 1e3)
        rows.append({**head, "step": state["step"] - 1, "host_ms": host[-1], "loss": loss,
                     "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
    with _ranges(rwkv6, {"_wkv_backward": "wkv_backward"}), \
            _ranges(optimizer, {"adamw_inplace": "adamw"}):
        res = _measure_once(one, dev)
    by_kernel, by_range = res.pop("by_kernel"), res.pop("by_range")
    total = sum(us for _, us in by_kernel.values()) or 1.0
    med = sorted(host)[len(host) // 2] if host else None

    def share(pred):
        return sum(us for k, (_, us) in by_kernel.items() if pred(k.lower())) / total

    rows.append({**head, "step": state["step"] - 1, "profiled": True, **res,
                 "device_busy_share": (res["device_ms"] / med
                                       if med and res["device_ms"] else None),
                 "host_ms_median": med,
                 "b7_share": share(lambda k: "wkv_kernel" in k),
                 "b7_launches": sum(n for k, (n, _) in by_kernel.items()
                                    if "wkv_kernel" in k.lower()),
                 "wkv_backward_share": by_range.get("wkv_backward", 0.0) / total,
                 "adamw_share": by_range.get("adamw", 0.0) / total,
                 "gemm_share": share(lambda k: any(s in k for s in _GEMM_NAMES))})
    return rows


def profile_run(snn: str, batch: int, t_block: int, repeats: int,
                device=None, n_cores: int = 1, weight_bits: int = 4) -> dict:
    dev = _card(device)
    spec = (spidr_gesture if snn == "gesture" else spidr_optflow).CONFIG
    params = init_params(torch.Generator().manual_seed(0), spec)
    compiled = spidr.compile(spec, params, spidr.DeployTarget(
        weight_bits=weight_bits, n_cores=n_cores, backend="fused",
        t_block=t_block), device=dev)
    make = make_gesture_batch if snn == "gesture" else make_flow_batch
    events, _ = make(torch.Generator().manual_seed(1), batch=batch,
                     timesteps=spec.timesteps, hw=spec.input_hw, device=dev)

    res = _measure(lambda: compiled.run(events), dev, repeats)
    res.pop("by_kernel")
    res.pop("by_range")
    return {"snn": snn, "hw": list(spec.input_hw), "T": spec.timesteps,
            "batch": batch, "t_block": t_block, "n_cores": n_cores,
            "weight_bits": weight_bits, **res}


def profile_stream(snn: str, capacity: int, chunk_T: int, t_block: int,
                   repeats: int, device=None) -> dict:
    """Steady-state ticks of a :class:`~repro_torch.serving.StreamWorker`
    on the full-width network: ``capacity`` streams, all live for every
    measured tick (each stream is the event batch repeated in time)."""
    import numpy as np

    from ..serving import StreamRequest, StreamWorker

    dev = _card(device)
    spec = (spidr_gesture if snn == "gesture" else spidr_optflow).CONFIG
    params = init_params(torch.Generator().manual_seed(0), spec)
    compiled = spidr.compile(spec, params, spidr.DeployTarget(
        backend="fused", t_block=t_block, chunk_T=chunk_T,
        stream_capacity=capacity), device=dev)
    make = make_gesture_batch if snn == "gesture" else make_flow_batch
    events, _ = make(torch.Generator().manual_seed(1), batch=capacity,
                     timesteps=spec.timesteps, hw=spec.input_hw, device="cpu")
    ticks = repeats + 3   # warm-up, repeats, the profiled tick, one spare
    events = np.concatenate([events.numpy()] * -(-ticks * chunk_T // spec.timesteps))
    worker = StreamWorker(compiled, capacity=capacity, chunk_T=chunk_T)
    for rid in range(capacity):
        worker.submit(StreamRequest(rid=rid, events=events[:, rid]))
    res = _measure(worker.step, dev, repeats)
    by_kernel = res.pop("by_kernel")
    res.pop("by_range")
    sd_ms = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        sd = worker.sessions.state_dict()
        sd_ms.append((time.perf_counter() - t0) * 1e3)
    sd_bytes = sum(getattr(v, "nbytes", 0) for v in (
        sd["engine_state"]["vmem"] + [sd["engine_state"]["readout_acc"]]))
    copies = [(n, us) for k, (n, us) in by_kernel.items() if "memcpy" in k.lower()]
    return {"snn": snn, "workload": "stream_tick", "hw": list(spec.input_hw),
            "capacity": capacity, "chunk_T": chunk_T, "t_block": t_block, **res,
            "copies": sum(n for n, _ in copies),
            "copy_ms": sum(us for _, us in copies) / 1e3,
            "state_dict_ms": sd_ms, "state_dict_mb": sd_bytes / 1e6}


def profile_float_forward(repeats: int, device=None, snn: str = "gesture") -> dict:
    """The float forward at full width: the quickstart's (gesture net,
    64x64, T=10, batch 4) or the optical-flow walk's (288x384, T=10,
    batch 2)."""
    from ..core.network import gesture_net, optical_flow_net, run_snn
    from ..core.quant import QuantSpec

    dev = _card(device)
    gesture = snn == "gesture"
    net = gesture_net() if gesture else optical_flow_net()
    params = [None if p is None else p.to(dev)
              for p in init_params(torch.Generator().manual_seed(0), net)]
    hw, batch = ((64, 64), 4) if gesture else (net.input_hw, 2)
    make = make_gesture_batch if gesture else make_flow_batch
    events, _ = make(torch.Generator().manual_seed(1), batch=batch,
                     timesteps=10, hw=hw, device=dev)
    with torch.no_grad():
        res = _measure(lambda: run_snn(params, events, net, QuantSpec(4),
                                       record_spikes=True), dev, repeats)
    by_kernel = res.pop("by_kernel")
    res.pop("by_range")
    total = sum(us for _, us in by_kernel.values()) or 1.0
    b3 = [(n, us) for k, (n, us) in by_kernel.items() if "lif_gemm_f32" in k]
    return {"workload": "float_forward", "net": snn, "hw": list(hw), "T": 10,
            "batch": batch, **res, "b3_launches": sum(n for n, _ in b3),
            "b3_ms": sum(us for _, us in b3) / 1e3,
            "b3_share": sum(us for _, us in b3) / total}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.profile",
                                 description=__doc__.split("\n\n")[0])
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--snn", choices=["gesture", "optical-flow"])
    what.add_argument("--arch", help="an LM at full width (any of the reference's "
                                     "ten, e.g. rwkv6-7b, chameleon-34b)")
    what.add_argument("--float-forward", choices=["gesture", "optical-flow"],
                      dest="float_forward",
                      help="the float forward at full width: the quickstart's "
                           "(gesture) or the optical-flow walk's")
    ap.add_argument("--batch", type=int, default=2,
                    help="streams per run (--snn), decode slots (--arch) or "
                         "sequences per step (--train)")
    ap.add_argument("--t-block", type=int, nargs="+", default=[1], dest="t_block")
    ap.add_argument("--n-cores", type=int, nargs="+", default=[1], dest="n_cores")
    ap.add_argument("--weight-bits", type=int, nargs="+", default=[4],
                    dest="weight_bits")
    ap.add_argument("--stream", action="store_true",
                    help="--snn: profile a StreamWorker tick, not a run")
    ap.add_argument("--chunk-T", type=int, default=2, dest="chunk_T",
                    help="--stream: timesteps per tick")
    ap.add_argument("--prompt-len", type=int, default=512, dest="prompt_len")
    ap.add_argument("--train", action="store_true",
                    help="--arch: profile the train step, not prefill and decode")
    ap.add_argument("--layers", type=int, default=None,
                    help="--train: cut the depth to this many layers")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    if args.float_forward is not None:
        print(json.dumps(profile_float_forward(args.repeats, snn=args.float_forward)),
              flush=True)
    elif args.arch is not None and args.train:
        for row in profile_lm_train(args.arch, args.batch, TRAIN_SEQ, args.repeats,
                                    n_layers=args.layers):
            print(json.dumps(row), flush=True)
    elif args.arch is not None:
        for row in profile_lm(args.arch, args.prompt_len, args.batch, args.repeats):
            print(json.dumps(row), flush=True)
    elif args.stream:
        for t_block in args.t_block:
            print(json.dumps(profile_stream(args.snn, args.batch, args.chunk_T,
                                            t_block, args.repeats)), flush=True)
    else:
        for bits in args.weight_bits:
            for t_block in args.t_block:
                for n_cores in args.n_cores:
                    print(json.dumps(profile_run(
                        args.snn, args.batch, t_block, args.repeats,
                        n_cores=n_cores, weight_bits=bits)), flush=True)


if __name__ == "__main__":
    main()
