#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on the card and check it.

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels build for sm_90a) and ``nvcc``.
Phases, each printing one JSON line:

  1. build      compile ``src/repro_torch/kernels/csrc/*.cu`` (one nvcc per
                source, in parallel) and print ptxas' register/smem report
  2. kernels    each CUDA kernel against its plain PyTorch version on the
                card, bit-exact, at the main path's real shapes (gesture conv
                layer M=4*4096 K=144 N=16; optical-flow middle layer
                M=2*110592 K=288 N=32), scalar and per-channel thresholds,
                skip_empty on and off, hard and soft reset, T=4 and T=3
                slabs, all-zero spikes; then CUDA-event timings
  3. gesture    the Table II gesture network at full width (64x64, T=20,
                4-bit) serving 8 requests through BatchWorker at capacity 4,
                t_block 1 and 4, bit-exact with backend="torch" on the card
  4. flow       the optical-flow network at full width (288x384, T=10),
                B=2, through CompiledSNN.run, t_block 1 and 5, bit-exact
                with backend="torch"
  5. a ``kernels`` line: launches on phases 3-4, max error, kernel / plain /
     bound times per kernel

then the card's name and power limit (nvidia-smi) and, last, the line
``{"ok": true, "device": {...}}``.  Any mismatch, a kernel that does not
build or launch, or a kernel the main path never launched exits non-zero
without that line.  Weights are random from a fixed seed.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, int8 tensor ops/s.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

KERNEL_INFO = {
    "fused_lif_gemm_int": {
        "source": "src/repro_torch/kernels/csrc/fused_lif_gemm.cu",
        "replaces": "src/repro/kernels/fused_lif_gemm.py:182",
    },
    "fused_lif_gemm_int_tblk": {
        "source": "src/repro_torch/kernels/csrc/fused_lif_gemm.cu",
        "replaces": "src/repro/kernels/fused_lif_gemm.py:400",
    },
}
LIBRARY_NOTE = ("no single PyTorch call computes the fused integer GEMM + "
                "saturating neuron step")


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "runs only on a machine with an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found — run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()

    kernels = phase_build(card)
    results = phase_kernels(torch, dev, kernels)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()  # the main path starts here
    phase_gesture(torch, dev)
    phase_flow(torch, dev)
    launches = dict(kernels.LAUNCHES)
    for name, n in launches.items():
        check(n > 0, f"the main path never launched {name}")
    emit({"kernels": [dict(name=name, route="cuda", launches=launches[name],
                           **KERNEL_INFO[name], **results[name])
                      for name in KERNEL_INFO]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# ---------------------------------------------------------------------------
# 1. build
# ---------------------------------------------------------------------------
def phase_build(card: str):
    from repro_torch.kernels import _build, fused_lif_gemm

    t0 = time.perf_counter()
    logs = _build.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    fused_lif_gemm._fn("spidr_fused_lif_gemm_int")  # load + bind the library
    emit({"phase": "build", "card": card,
          "seconds": round(time.perf_counter() - t0, 3), "ptxas": ptxas})
    return fused_lif_gemm


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions, then timings
# ---------------------------------------------------------------------------
SHAPES = {  # name: (M, K, N) as the main path gives them
    "gesture_conv": (4 * 64 * 64, 144, 16),
    "flow_middle": (2 * 288 * 384, 288, 32),
}


def _inputs(torch, dev, m, k, n, vmem_bits, t=None, density=0.1, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (m, k) if t is None else (t, m, k)
    s = (torch.rand(shape, generator=g, device=dev) < density).to(torch.int8)
    w_max = (1 << ((vmem_bits + 1) // 2 - 1)) - 1
    v_max = (1 << (vmem_bits - 1)) - 1
    w = torch.randint(-w_max - 1, w_max + 1, (k, n), generator=g, device=dev,
                      dtype=torch.int8)
    v = torch.randint(-v_max - 1, v_max + 1, (m, n), generator=g, device=dev,
                      dtype=torch.int32)
    thr_vec = torch.randint(1, max(2, v_max // 4), (n,), generator=g, device=dev,
                            dtype=torch.int32)
    return s, w, v, thr_vec


def _time_ms(torch, fn, iters: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _bound(s, m, k, n, t) -> dict:
    """Least time for the work: each input read once, each output written
    once; the operations this data needs (2 per spike per output channel)."""
    t = t or 1
    nbytes = t * m * k + k * n + 4 * n + 4 * m * n + 2 * 4 * t * m * n
    ops = 2 * int((s != 0).sum()) * n
    mem_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
    return {"bound_ms": max(mem_ms, ops_ms),
            "bound_by": "bytes" if mem_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": ops}


def phase_kernels(torch, dev, fk):
    from repro_torch.kernels import ref

    plain = {"fused_lif_gemm_int": ref.fused_lif_gemm_int_ref,
             "fused_lif_gemm_int_tblk": ref.fused_lif_gemm_int_tblk_ref}
    kernel = {"fused_lif_gemm_int": fk.fused_lif_gemm_int,
              "fused_lif_gemm_int_tblk": fk.fused_lif_gemm_int_tblk}
    max_err = {name: 0 for name in kernel}
    checked = {name: 0 for name in kernel}
    t0 = time.perf_counter()
    for shape_name, (m, k, n) in SHAPES.items():
        for name, ts in (("fused_lif_gemm_int", (None,)),
                         ("fused_lif_gemm_int_tblk", (4, 3))):
            for t in ts:
                for density in (0.1, 0.0):
                    s, w, v, thr_vec = _inputs(torch, dev, m, k, n, 7, t=t,
                                               density=density)
                    for thr in (5, thr_vec):
                        for soft, leak in ((False, 3), (True, 0)):
                            for skip in (True, False):
                                kw = dict(leak_shift=leak, soft_reset=soft,
                                          vmem_bits=7)
                                got = kernel[name](s, w, v, thr, skip_empty=skip, **kw)
                                want = plain[name](s, w, v, thr, **kw)
                                torch.cuda.synchronize()
                                for g_, w_ in zip(got, want):
                                    err = int((g_.long() - w_.long()).abs().max())
                                    max_err[name] = max(max_err[name], err)
                                    check(err == 0, f"{name} != plain at {shape_name} "
                                          f"t={t} thr={'vec' if thr is thr_vec else thr} "
                                          f"soft={soft} skip={skip} density={density}: "
                                          f"max abs err {err}")
                                checked[name] += 1
    small = _small_engine_check(torch, dev)
    emit({"phase": "kernels_vs_plain", "bit_exact": True, "cases": checked,
          "max_abs_err": max_err, "engine_small_cpu_vs_card": small,
          "seconds": round(time.perf_counter() - t0, 3)})

    # Timings at the main path's shapes: the network's neuron program
    # (4-bit: 7-bit Vmem), scalar threshold, skip_empty on, 10% random spikes.
    results = {name: {"max_abs_err": max_err[name], "library_ms": None,
                      "library_note": LIBRARY_NOTE, "shapes": []}
               for name in kernel}
    for shape_name, (m, k, n) in SHAPES.items():
        for name, t in (("fused_lif_gemm_int", None), ("fused_lif_gemm_int_tblk", 4)):
            s, w, v, _ = _inputs(torch, dev, m, k, n, 7, t=t, seed=1)
            kw = dict(leak_shift=3, soft_reset=False, vmem_bits=7)
            k_ms = _time_ms(torch, lambda: kernel[name](s, w, v, 5, **kw), 20)
            p_ms = _time_ms(torch, lambda: plain[name](s, w, v, 5, **kw), 5)
            row = {"shape": shape_name, "T": t, "M": m, "K": k, "N": n,
                   "ms": k_ms, "plain_ms": p_ms, **_bound(s, m, k, n, t)}
            results[name]["shapes"].append(row)
            emit({"phase": "kernel_timing", "kernel": name, **row})
            del s, w, v
    for name, r in results.items():
        # The headline numbers are the optical-flow middle layer's, the
        # main path's largest shape.
        main = next(x for x in r["shapes"] if x["shape"] == "flow_middle")
        r.update(ms=main["ms"], plain_ms=main["plain_ms"],
                 bound_ms=main["bound_ms"], bound_by=main["bound_by"])
    return results


def _small_engine_check(torch, dev) -> bool:
    """A reduced network through the fused engine: card == CPU, exactly."""
    from repro_torch.configs import spidr_gesture
    from repro_torch.core.network import init_params
    from repro_torch.core.quant import QuantSpec
    from repro_torch.engine import EngineConfig, build_engine, run_engine
    from repro_torch.snn.data import make_gesture_batch

    spec = spidr_gesture.reduced(hw=(16, 16), timesteps=4)
    params = init_params(torch.Generator().manual_seed(0), spec)
    ev, _ = make_gesture_batch(torch.Generator().manual_seed(2), batch=3,
                               timesteps=4, hw=(16, 16), device="cpu")
    for t_block in (1, 3):
        cfg = EngineConfig(QuantSpec(4), backend="fused", t_block=t_block)
        cpu = run_engine(build_engine(spec, params, cfg, device="cpu"), ev)
        gpu = run_engine(build_engine(spec, params, cfg, device=dev), ev)
        for a, b in ((gpu.readout, cpu.readout), (gpu.spike_counts, cpu.spike_counts),
                     (gpu.input_counts, cpu.input_counts)):
            check(torch.equal(a.cpu(), b), f"reduced gesture t_block={t_block}: "
                  "card != CPU")
    return True


# ---------------------------------------------------------------------------
# 3. gesture at full width, served through BatchWorker
# ---------------------------------------------------------------------------
def phase_gesture(torch, dev):
    from repro_torch import spidr
    from repro_torch.configs import spidr_gesture
    from repro_torch.core.network import init_params
    from repro_torch.serving import BatchWorker, StreamRequest
    from repro_torch.snn.data import make_gesture_batch

    spec = spidr_gesture.CONFIG
    params = init_params(torch.Generator().manual_seed(0), spec)
    events, _ = make_gesture_batch(torch.Generator().manual_seed(1), batch=8,
                                   timesteps=spec.timesteps, hw=spec.input_hw,
                                   device="cpu")
    plain = spidr.compile(spec, params, spidr.DeployTarget(backend="torch"),
                          device=dev)
    for t_block in (1, 4):
        compiled = spidr.compile(spec, params, spidr.DeployTarget(
            weight_bits=4, backend="fused", t_block=t_block), device=dev)
        worker = BatchWorker(compiled, capacity=4)
        for rid in range(8):
            worker.submit(StreamRequest(rid=rid, events=events[:, rid].numpy()))
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        while worker.step():
            pass
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        check(len(worker.done) == 8 and worker.batches == 2,
              "gesture: 8 requests in 2 batches")
        spikes = inputs = None
        for b0 in (0, 4):
            want = plain.run(events[:, b0:b0 + 4])
            for i in range(4):
                got = worker.done[b0 + i]
                check(got.rid == b0 + i and got.readout.shape == (11,),
                      "gesture: readout shape")
                check(bool((got.readout == want.readout[i].cpu().numpy()).all()),
                      f"gesture t_block={t_block}: request {b0 + i} readout "
                      "differs from backend='torch'")
            spikes = want.spike_counts if spikes is None else spikes + want.spike_counts
            inputs = want.input_counts if inputs is None else inputs + want.input_counts
        check((worker.total_spike_counts == spikes.cpu().numpy()).all(),
              f"gesture t_block={t_block}: spike counts differ from backend='torch'")
        check((worker.total_input_counts == inputs.cpu().numpy()).all(),
              f"gesture t_block={t_block}: input counts differ from backend='torch'")
        emit({"phase": "gesture", "t_block": t_block, "requests": 8,
              "capacity": 4, "hw": list(spec.input_hw), "T": spec.timesteps,
              "weight_bits": 4, "serve_seconds": seconds,
              "spikes_per_layer": spikes.sum(dim=0).tolist(),
              "bit_exact_vs_torch": True})


# ---------------------------------------------------------------------------
# 4. optical flow at full width, through CompiledSNN.run
# ---------------------------------------------------------------------------
def phase_flow(torch, dev):
    from repro_torch import spidr
    from repro_torch.configs import spidr_optflow
    from repro_torch.core.network import init_params
    from repro_torch.snn.data import make_flow_batch

    spec = spidr_optflow.CONFIG
    params = init_params(torch.Generator().manual_seed(0), spec)
    events, _ = make_flow_batch(torch.Generator().manual_seed(1), batch=2,
                                timesteps=spec.timesteps, hw=spec.input_hw,
                                device=dev)
    want = spidr.compile(spec, params, spidr.DeployTarget(backend="torch"),
                         device=dev).run(events)
    h, w = spec.input_hw
    check(tuple(want.readout.shape) == (2, h, w, 2), "flow: readout shape")
    for t_block in (1, 5):
        compiled = spidr.compile(spec, params, spidr.DeployTarget(
            weight_bits=4, backend="fused", t_block=t_block), device=dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = compiled.run(events)
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        for a, b, what in ((out.readout, want.readout, "readout"),
                           (out.spike_counts, want.spike_counts, "spike counts"),
                           (out.input_counts, want.input_counts, "input counts")):
            check(a.shape == b.shape and torch.equal(a, b),
                  f"flow t_block={t_block}: {what} differ from backend='torch'")
        emit({"phase": "flow", "t_block": t_block, "batch": 2, "hw": [h, w],
              "T": spec.timesteps, "weight_bits": 4, "run_seconds": seconds,
              "spikes_per_layer": out.spike_counts.sum(dim=0).tolist(),
              "readout_abs_sum": int(out.readout.abs().sum()),
              "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
              "bit_exact_vs_torch": True})


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
