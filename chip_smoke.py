#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on the card and check it.

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels build for sm_90a) and ``nvcc``.
Phases, each printing JSON lines:

  1. build      compile ``src/repro_torch/kernels/csrc/*.cu`` (one nvcc per
                source, in parallel) and print ptxas' register/smem report
  2. kernels    each CUDA kernel against its plain PyTorch version on the
                card at the main paths' real shapes (gesture conv layers
                M=4*4096 K=18 and K=144 N=16; optical-flow middle and last
                layers M=2*110592 K=288 N=32 and N=2): the integer kernels
                bit-exact, the
                float ones within the float tolerance (Vmem atol=rtol=1e-5,
                spikes equal except where the pre-reset Vmem lies within
                1e-5 of the threshold, each such spot counted); scalar and
                per-channel thresholds, every skip mode, hard and soft
                reset, T=4 and T=3 slabs, 0 % and 10 % random spikes.  Then
                timings: CUDA events over eager launches (``ms``, host
                overhead included) and over a CUDA-graph replay of 100
                launches (``graph_ms``, the device time per launch), and
                the library yardstick the same two ways where one exists
                (``library_ms``, ``library_graph_ms``)
  3. gesture    the Table II gesture network at full width (64x64, T=20,
                4-bit) serving 8 requests through BatchWorker at capacity 4,
                t_block 1 and 4, bit-exact with backend="torch" on the card
  4. flow       the optical-flow network at full width (288x384, T=10),
                B=2, through CompiledSNN.run, t_block 1 and 5, bit-exact
                with backend="torch"
  5. quickstart ``repro_torch.launch.quickstart`` at full width (gesture
                64x64, T=10, batch 4 through the float forward; the unfused
                kernels on its spike matrices; the facade on 32x32, T=4),
                then checked: the float forward against the plain float
                path on the card, layer by layer; unfused == fused; the
                chip cost equal to the CPU's for the same network; and the
                zero-skipping spike GEMM timed on the clustered DVS spikes
  6. lm kernels the LM stack's kernels against their plain versions on the
                card: the RWKV6 wkv (B7) at H=64, N=64, chunk 32, S in
                {32, 64, 512}, B in {1, 4}, rtol 2e-4 / atol 2e-5 on y and
                the state; quant_matmul (B6, int8 and int4) at the rwkv6-7b
                channel-mix shape (K=4096, N=14336), M in {4, 512}, weights
                quantized per output channel, rtol = atol = 1e-4, plus
                ragged shapes at M in {1, 4, 8, 16, 17}, each through both
                of B6's regimes where M allows (decode M <= 16, tiled).
                Timed as in phase 2, with the library yardstick for B6
                (``torch.matmul`` on the dequantized weight), and both
                regimes timed on each side of the cut-over
  7. lm         rwkv6-7b at full published width (32 layers, d_model 4096,
                random weights from a seed, bfloat16 serving copies) serving
                8 requests of 64 tokens (8 new each) through the port's
                Server at capacity 4; every prefill launches B7 once per
                layer.  Then the served model's layer-0 channel-mix key
                projection on the 4 slots' last inputs through
                ``ops.quant_matmul_op`` (int8 and int4, per-channel scales)
  8. lm check   one 512-token prefill layer by layer: each layer's r, k, v,
                lw through B7 and the plain wkv, held to B7's tolerance, the
                walk going on with the plain one; the logits of the kernel
                route against the plain route's; the served tokens against
                a plain-route Server's (a difference is allowed only where
                the plain route's top-2 logit gap is within twice the two
                routes' largest bfloat16 logit difference); in float32
                compute, the two routes' logits within 1e-3 of the largest
  9. a ``kernels`` line: launches on phases 3-5 and 7, max error, kernel /
     plain / bound / library times per kernel

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

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, int8 tensor
# ops/s, fp32 flop/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 67e12

_CSRC = "src/repro_torch/kernels/csrc/"
KERNEL_INFO = {
    "fused_lif_gemm_int": {
        "source": _CSRC + "fused_lif_gemm.cu",
        "replaces": "src/repro/kernels/fused_lif_gemm.py:182",
    },
    "fused_lif_gemm_int_tblk": {
        "source": _CSRC + "fused_lif_gemm.cu",
        "replaces": "src/repro/kernels/fused_lif_gemm.py:400",
    },
    "fused_lif_gemm": {
        "source": _CSRC + "fused_lif_gemm.cu",
        "replaces": "src/repro/kernels/fused_lif_gemm.py:182",
    },
    "spike_gemm": {
        "source": _CSRC + "spike_gemm.cu",
        "replaces": "src/repro/kernels/spike_gemm.py:134",
    },
    "lif_step_fused": {
        "source": _CSRC + "lif_step.cu",
        "replaces": "src/repro/kernels/lif_step.py:72",
    },
    "lif_step_fused_int": {
        "source": _CSRC + "lif_step.cu",
        "replaces": "src/repro/kernels/lif_step.py:72",
    },
    "quant_matmul_int8": {
        "source": _CSRC + "quant_matmul.cu",
        "replaces": "src/repro/kernels/quant_matmul.py:123",
    },
    "quant_matmul_int4": {
        "source": _CSRC + "quant_matmul.cu",
        "replaces": "src/repro/kernels/quant_matmul.py:123",
    },
    "wkv_sequence": {
        "source": _CSRC + "wkv_chunk.cu",
        "replaces": "src/repro/kernels/wkv_chunk.py:91",
    },
}
LIBRARY_NOTE = {
    "fused_lif_gemm_int": "no single PyTorch call computes the fused integer "
                          "GEMM + saturating neuron step",
    "fused_lif_gemm_int_tblk": "no single PyTorch call computes the fused "
                               "integer GEMM + saturating neuron step",
    "fused_lif_gemm": "no single PyTorch call computes the float GEMM + "
                      "leak/fire/reset neuron step",
    "spike_gemm": "torch._int_mm (int8 x int8 -> int32, cuBLASLt)",
    "lif_step_fused": "no single PyTorch call computes leak, integrate, fire "
                      "and reset with two outputs",
    "lif_step_fused_int": "no single PyTorch call computes the saturating "
                          "integer neuron step with two outputs",
    "quant_matmul_int8": "torch.matmul(x, w_deq) on a pre-dequantized fp32 weight",
    "quant_matmul_int4": "torch.matmul(x, w_deq) on a pre-dequantized fp32 weight",
    "wkv_sequence": "no single PyTorch call computes the chunked RWKV6 wkv",
}


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

    # A kernel's tensors go through full-fp32 matrix products on the card:
    # the plain float versions must not run in TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kernels = phase_build(card)
    results = phase_kernels(torch, dev, kernels)
    results.update(phase_unfused_kernels(torch, dev))
    torch.cuda.reset_peak_memory_stats(dev)
    # Each path runs with the launch counts set to 0 just before it and read
    # just after; the comparisons with the plain versions come later.
    kernels.reset_launches()
    phase_gesture(torch, dev)
    phase_flow(torch, dev)
    launches = dict(kernels.LAUNCHES)
    kernels.reset_launches()
    quick = phase_quickstart(torch, dev)
    launches = {k: n + kernels.LAUNCHES[k] for k, n in launches.items()}
    check_quickstart(torch, dev, quick, results)
    results.update(phase_lm_kernels(torch, dev))
    lm = lm_model(torch, dev)
    kernels.reset_launches()
    phase_lm(torch, dev, kernels, lm)
    launches = {k: n + kernels.LAUNCHES[k] for k, n in launches.items()}
    emit({"phase": "launches", "paths": "gesture + flow + quickstart + lm",
          "launches": launches})
    check_lm(torch, dev, lm)
    for name in KERNEL_INFO:
        check(launches[name] > 0, f"no path launched {name}")
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
    from repro_torch import kernels
    from repro_torch.kernels import (_build, fused_lif_gemm, lif_step, quant_matmul,
                                     spike_gemm, wkv_chunk)

    t0 = time.perf_counter()
    logs = _build.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    sources = {os.path.basename(i["source"])[:-len(".cu")] for i in KERNEL_INFO.values()}
    check(sources <= set(logs), f"CUDA sources {sorted(sources)} not all built: {sorted(logs)}")
    for mod, name in ((fused_lif_gemm, "fused_lif_gemm"), (spike_gemm, "spike_gemm"),
                      (lif_step, "lif_step"), (quant_matmul, "quant_matmul"),
                      (wkv_chunk, "wkv_chunk")):
        _build.bind(name, mod._SIGNATURES)  # load + bind every library
    emit({"phase": "build", "card": card,
          "seconds": round(time.perf_counter() - t0, 3), "ptxas": ptxas})
    return kernels


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions, then timings
# ---------------------------------------------------------------------------
SHAPES = {  # name: (M, K, N) as the main path gives them
    "gesture_first": (4 * 64 * 64, 18, 16),
    "gesture_conv": (4 * 64 * 64, 144, 16),
    "flow_middle": (2 * 288 * 384, 288, 32),
    "flow_last": (2 * 288 * 384, 288, 2),
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


def _graph_ms(torch, fn, launches: int = 100) -> float:
    """Device time per launch: CUDA events around the replay of a CUDA
    graph that holds ``launches`` launches (no host overhead inside)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up: build, load, allocator
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / launches


def _roofline(nbytes: int, ops: int, ops_per_s: float) -> dict:
    """Least time for the work: the larger of bytes over HBM's rate and
    operations over the card's peak for their type."""
    mem_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return {"bound_ms": max(mem_ms, ops_ms),
            "bound_by": "bytes" if mem_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": ops}


def _bound(s, m, k, n, t) -> dict:
    """B1/B2: each input read once, each output written once; the
    operations this data needs (2 per spike per output channel)."""
    t = t or 1
    nbytes = t * m * k + k * n + 4 * n + 4 * m * n + 2 * 4 * t * m * n
    return _roofline(nbytes, 2 * int((s != 0).sum()) * n, INT8_OPS_PER_S)


def phase_kernels(torch, dev, fk):
    from repro_torch.kernels import fused_lif_gemm as fl
    from repro_torch.kernels import ref

    # B1's launch plan sizes shared memory as the kernel lays it out.
    for shape_name, (m, k, n) in SHAPES.items():
        for stages in (2, 3, 4):
            c_bytes = fl._fn("spidr_fused_lif_gemm_int_smem")(k, n, stages)
            check(c_bytes == fl.tc_smem(k, n, stages), f"B1 at {shape_name}: the "
                  f"wrapper's shared memory {fl.tc_smem(k, n, stages)} != the "
                  f"kernel's {c_bytes}")

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
                      "library_graph_ms": None, "library_note": LIBRARY_NOTE[name],
                      "shapes": []}
               for name in kernel}
    for shape_name, (m, k, n) in SHAPES.items():
        for name, t in (("fused_lif_gemm_int", None), ("fused_lif_gemm_int_tblk", 4)):
            s, w, v, _ = _inputs(torch, dev, m, k, n, 7, t=t, seed=1)
            kw = dict(leak_shift=3, soft_reset=False, vmem_bits=7)
            # B1 takes an int threshold as a kernel argument; B2's wrapper
            # fills an (N,) vector for one, so its graph gets the vector.
            thr = 5 if name == "fused_lif_gemm_int" else torch.full(
                (n,), 5, dtype=torch.int32, device=dev)
            k_ms = _time_ms(torch, lambda: kernel[name](s, w, v, 5, **kw), 20)
            g_ms = _graph_ms(torch, lambda: kernel[name](s, w, v, thr, **kw))
            p_ms = _time_ms(torch, lambda: plain[name](s, w, v, 5, **kw), 5)
            row = {"shape": shape_name, "T": t, "M": m, "K": k, "N": n,
                   "ms": k_ms, "graph_ms": g_ms, "plain_ms": p_ms,
                   **_bound(s, m, k, n, t)}
            if t is None:  # B1's persistent grid and ring
                row["grid_x"], row["stages"] = fl.tc_plan(
                    m, k, n, torch.cuda.get_device_properties(dev).multi_processor_count)
            results[name]["shapes"].append(row)
            emit({"phase": "kernel_timing", "kernel": name, **row})
            del s, w, v
    return _headline(results)


def _headline(results: dict) -> dict:
    """The headline numbers are the optical-flow middle layer's, the main
    paths' largest shape (B5 at that layer's (M, N))."""
    for r in results.values():
        main = next(x for x in r["shapes"] if x["shape"] == "flow_middle")
        r.update(ms=main["ms"], graph_ms=main["graph_ms"],
                 plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                 bound_by=main["bound_by"])
        for key in ("library_ms", "library_graph_ms"):
            if key in main:
                r[key] = main[key]
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
# 2b. the unfused kernels (B4, B5) and the float fused kernel (B3)
# ---------------------------------------------------------------------------
SKIPS = ((True, "reduce"), (True, "bitmap"), (False, "reduce"))


def _float_inputs(torch, dev, m, k, n, density=0.1, seed=0):
    """0/1 float spikes, network-scaled weights, Vmem around the threshold."""
    g = torch.Generator(device=dev).manual_seed(seed)
    s = (torch.rand((m, k), generator=g, device=dev) < density).to(torch.float32)
    w = (torch.rand((k, n), generator=g, device=dev) * 2 - 1) * (3.0 / k ** 0.5)
    v = torch.randn((m, n), generator=g, device=dev) * 0.3
    return s, w, v


def _pre_reset(v, current, leak):
    return (v * leak if leak != 1.0 else v) + current


def phase_unfused_kernels(torch, dev):
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_lif_gemm import fused_lif_gemm
    from repro_torch.kernels.lif_step import lif_step_fused, lif_step_fused_int
    from repro_torch.kernels.spike_gemm import spike_gemm

    t0 = time.perf_counter()
    names = ("fused_lif_gemm", "spike_gemm", "lif_step_fused", "lif_step_fused_int")
    max_err = dict.fromkeys(names, 0)
    cases = dict.fromkeys(names, 0)
    flips = {"fused_lif_gemm": 0, "lif_step_fused": 0}

    def hold_float(name, res, what):
        check(res["ok"], f"{name} disagrees with plain {what}: {res}")
        max_err[name] = max(max_err[name], res["max_abs_err"])
        flips[name] += res["spikes_flipped"]
        cases[name] += 1

    for shape_name, (m, k, n) in SHAPES.items():
        for density in (0.1, 0.0):
            s8, w8, _, _ = _inputs(torch, dev, m, k, n, 7, density=density)
            want = ref.spike_gemm_ref(s8, w8)
            for skip_empty, mode in SKIPS:
                got = spike_gemm(s8, w8, skip_empty=skip_empty, skip_mode=mode)
                torch.cuda.synchronize()
                err = int((got.long() - want.long()).abs().max())
                max_err["spike_gemm"] = max(max_err["spike_gemm"], err)
                check(err == 0, f"spike_gemm != plain at {shape_name} density="
                      f"{density} skip_empty={skip_empty} mode={mode}: {err}")
                cases["spike_gemm"] += 1
            s, w, v = _float_inputs(torch, dev, m, k, n, density)
            current = s @ w
            for leak, soft in ((0.95, False), (1.0, True)):
                vw, sw = ref.fused_lif_gemm_ref(s, w, v, 0.5, leak, soft)
                for skip in (True, False):
                    vg, sg = fused_lif_gemm(s, w, v, 0.5, leak, soft, skip_empty=skip)
                    torch.cuda.synchronize()
                    hold_float("fused_lif_gemm", ref.compare_float_step(
                        vg, sg, vw, sw, _pre_reset(v, current, leak), 0.5),
                        f"at {shape_name} density={density} leak={leak} "
                        f"soft={soft} skip={skip}")
            del s8, w8, s, w, v, current
        g = torch.Generator(device=dev).manual_seed(7)
        vf = torch.randn((m, n), generator=g, device=dev) * 0.5
        cur = torch.randn((m, n), generator=g, device=dev) * 0.5
        for leak, soft in ((0.95, False), (1.0, True)):
            vw, sw = ref.lif_step_ref(vf, cur, 0.5, leak, soft)
            vg, sg = lif_step_fused(vf, cur, 0.5, leak, soft)
            torch.cuda.synchronize()
            hold_float("lif_step_fused", ref.compare_float_step(
                vg, sg, vw, sw, _pre_reset(vf, cur, leak), 0.5),
                f"at {shape_name} leak={leak} soft={soft}")
        vi = torch.randint(-64, 64, (m, n), generator=g, device=dev, dtype=torch.int32)
        pi = torch.randint(-128, 128, (m, n), generator=g, device=dev, dtype=torch.int32)
        for shift, soft in ((3, False), (0, True), (3, True), (0, False)):
            want = ref.lif_step_int_ref(vi, pi, 5, shift, soft, 7)
            got = lif_step_fused_int(vi, pi, 5, shift, soft, 7)
            torch.cuda.synchronize()
            for g_, w_ in zip(got, want):
                err = int((g_.long() - w_.long()).abs().max())
                max_err["lif_step_fused_int"] = max(max_err["lif_step_fused_int"], err)
                check(err == 0, f"lif_step_fused_int != plain at {shape_name} "
                      f"shift={shift} soft={soft}: {err}")
            cases["lif_step_fused_int"] += 1
    emit({"phase": "unfused_kernels_vs_plain", "cases": cases,
          "max_abs_err": max_err, "spikes_flipped_near_threshold": flips,
          "tolerance": {"int": 0, "float_vmem_atol_rtol": 1e-5,
                        "float_spike_flip_band": 1e-5},
          "seconds": round(time.perf_counter() - t0, 3)})

    # Timings at the main paths' shapes, 10 % random spikes.
    results = {name: {"max_abs_err": max_err[name], "library_ms": None,
                      "library_graph_ms": None, "library_note": LIBRARY_NOTE[name],
                      "shapes": []}
               for name in names}
    for shape_name, (m, k, n) in SHAPES.items():
        s8, w8, _, _ = _inputs(torch, dev, m, k, n, 7, seed=1)
        nnz = int((s8 != 0).sum())
        row = {"shape": shape_name, "M": m, "K": k, "N": n,
               "ms": _time_ms(torch, lambda: spike_gemm(s8, w8), 20),
               "graph_ms": _graph_ms(torch, lambda: spike_gemm(s8, w8)),
               "graph_ms_by_mode": {
                   (m_ if skip else "dense"):
                   _graph_ms(torch, lambda: spike_gemm(s8, w8, skip_empty=skip,
                                                         skip_mode=m_))
                   for skip, m_ in SKIPS},
               "plain_ms": _time_ms(torch, lambda: ref.spike_gemm_ref(s8, w8), 5),
               **_roofline(m * k + k * n + 4 * m * n, 2 * nnz * n, INT8_OPS_PER_S)}
        try:
            lib = torch._int_mm(s8, w8)
            row["library_max_abs_err"] = int((lib.long() - ref.spike_gemm_ref(
                s8, w8).long()).abs().max())
            row["library_ms"] = _time_ms(torch, lambda: torch._int_mm(s8, w8), 20)
            row["library_graph_ms"] = _graph_ms(torch, lambda: torch._int_mm(s8, w8))
            # The spread of repeated runs: kernel and library in turns.
            turns = {"kernel": [], "library": []}
            for who in ("kernel", "library", "library", "kernel") * 2:
                turns[who].append(_graph_ms(torch, (lambda: spike_gemm(s8, w8)) if
                                            who == "kernel" else
                                            (lambda: torch._int_mm(s8, w8))))
            row["graph_ms_turns"] = turns["kernel"]
            row["library_graph_ms_turns"] = turns["library"]
        except RuntimeError as e:  # a timing yardstick only, never used by the port
            row["library_error"] = str(e).splitlines()[0][:200]
        results["spike_gemm"]["shapes"].append(row)
        emit({"phase": "kernel_timing", "kernel": "spike_gemm", **row})

        s, w, v = _float_inputs(torch, dev, m, k, n, seed=1)
        nnz = int((s != 0).sum())
        row = {"shape": shape_name, "M": m, "K": k, "N": n,
               "ms": _time_ms(torch, lambda: fused_lif_gemm(s, w, v, 0.5, 0.95), 20),
               "graph_ms": _graph_ms(torch, lambda: fused_lif_gemm(s, w, v, 0.5, 0.95)),
               "plain_ms": _time_ms(torch, lambda: ref.fused_lif_gemm_ref(
                   s, w, v, 0.5, 0.95), 5),
               **_roofline(4 * m * k + 4 * k * n + 3 * 4 * m * n, 2 * nnz * n,
                           FP32_OPS_PER_S)}
        results["fused_lif_gemm"]["shapes"].append(row)
        emit({"phase": "kernel_timing", "kernel": "fused_lif_gemm", **row})
        del s8, w8, s, w

        cur = torch.randn((m, n), device=dev)
        vi = torch.randint(-64, 64, (m, n), device=dev, dtype=torch.int32)
        pi = torch.randint(-64, 64, (m, n), device=dev, dtype=torch.int32)
        for name, fn, plain, ops, peak in (
                ("lif_step_fused", lambda: lif_step_fused(v, cur, 0.5, 0.95),
                 lambda: ref.lif_step_ref(v, cur, 0.5, 0.95), 4, FP32_OPS_PER_S),
                ("lif_step_fused_int", lambda: lif_step_fused_int(vi, pi, 5, 3),
                 lambda: ref.lif_step_int_ref(vi, pi, 5, 3), 7, INT8_OPS_PER_S)):
            row = {"shape": shape_name, "M": m, "N": n,
                   "ms": _time_ms(torch, fn, 20), "graph_ms": _graph_ms(torch, fn),
                   "plain_ms": _time_ms(torch, plain, 5),
                   **_roofline(16 * m * n, ops * m * n, peak)}
            results[name]["shapes"].append(row)
            emit({"phase": "kernel_timing", "kernel": name, **row})
        del v, cur, vi, pi
    return _headline(results)


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


# ---------------------------------------------------------------------------
# 5. the quickstart at full width, then its checks
# ---------------------------------------------------------------------------
def phase_quickstart(torch, dev):
    from repro_torch.launch import quickstart

    t0 = time.perf_counter()
    out = quickstart.run(dev, smoke=False,
                         log=lambda msg: print(msg, file=sys.stderr, flush=True))
    torch.cuda.synchronize(dev)
    cost = out["cost"]
    emit({"phase": "quickstart", "seconds": time.perf_counter() - t0,
          "events": list(out["events"].shape), "input_sparsity": out["sparsity"],
          "logits_shape": list(out["logits"].shape),
          "spikes_per_layer": out["spike_counts"].sum(dim=0).tolist(),
          "layer_checks": out["layer_checks"],
          "cost": {"makespan_cycles": cost.makespan_cycles,
                   "latency_ms_on_chip_model": cost.latency_ms,
                   "energy_uj_on_chip_model": cost.energy_uj,
                   "mean_sparsity": cost.mean_sparsity,
                   "async_speedup": cost.async_speedup},
          "verify_exact": out["verify_exact"]})
    check(out["ok"], "quickstart: a step-5 or step-6 check failed")
    return out


def _lockstep_forward(torch, params, events, spec, qspec) -> dict:
    """The float forward layer by layer: at every layer-timestep the fused
    kernel and the plain composition take the same input and Vmem, are
    held to the float tolerance, and the walk goes on with the plain one."""
    from repro_torch.core import layers as L
    from repro_torch.core.network import _init_state
    from repro_torch.core.quant import ste_quantize
    from repro_torch.kernels.ref import compare_float_step

    state = _init_state(spec, events.shape[1], events.device)
    tot = {"layer_steps": 0, "outputs": 0, "spikes_flipped": 0,
           "flipped_off_threshold": 0, "near_threshold": 0, "max_abs_err": 0.0,
           "ok": True}
    for x_t in events.to(torch.float32):
        act, new = x_t, []
        for i, l in enumerate(spec.layers):
            if l.kind in ("pool", "adaptive_pool"):
                kk = 2 if l.kind == "pool" else act.shape[1] // l.target_hw
                act = L.maxpool2d(act, kk, kk)
                new.append(None)
                continue
            if l.kind == "conv":
                p, x, fn = l.conv, act, L.spiking_conv
                cols = L.im2col(x, p.kh, p.kw, p.stride, p.padding)
            else:
                p, x, fn = l.fc, act.reshape(act.shape[0], -1), L.spiking_dense
                cols = x
            vk, sk = fn(x, params[i], state[i], p, qspec)
            vp, sp = fn(x, params[i], state[i], p, qspec, matmul=torch.matmul)
            n = p.neuron
            current = (cols.reshape(-1, params[i].shape[0])
                       @ ste_quantize(params[i], qspec.weight_bits)).reshape(vp.shape)
            res = compare_float_step(vk, sk, vp, sp, _pre_reset(
                state[i], current, n.leak if n.model == "lif" else 1.0), n.threshold)
            tot["layer_steps"] += 1
            tot["outputs"] += vp.numel()
            for key in ("spikes_flipped", "flipped_off_threshold", "near_threshold"):
                tot[key] += res[key]
            tot["max_abs_err"] = max(tot["max_abs_err"], res["max_abs_err"])
            tot["ok"] = tot["ok"] and res["ok"]
            new.append(vp)
            act = sp
        state = new
    return tot


def check_quickstart(torch, dev, out, results) -> None:
    import dataclasses

    from repro_torch import spidr
    from repro_torch.core.network import init_params, run_snn
    from repro_torch.core.quant import QuantSpec, quantize
    from repro_torch.kernels.ref import spike_gemm_ref, spike_tile_bitmap
    from repro_torch.kernels.spike_gemm import CUDA_TILE, spike_gemm

    t0 = time.perf_counter()
    spec4 = QuantSpec(4)
    # 1. The full-width float forward against the plain float path (full
    #    fp32 matmul + neuron_step) on the card: free-running, then layer by
    #    layer, where every spike flip must sit within 1e-5 of the threshold.
    logits_p, counts_p = run_snn(out["params"], out["events"], out["run_net"],
                                 spec4, record_spikes=True, matmul=torch.matmul)
    free_equal = bool(torch.equal(logits_p, out["logits"])
                      and torch.equal(counts_p, out["spike_counts"]))
    lock = _lockstep_forward(torch, out["params"], out["events"], out["run_net"], spec4)
    check(lock["ok"], f"quickstart float forward: fused kernel vs plain {lock}")
    check(free_equal or lock["spikes_flipped"] > 0,
          "quickstart float forward differs from the plain path with no "
          "near-threshold spike flip to explain it")
    # 2. unfused == fused (step 5) was checked inside the quickstart (ok).
    # 3. The chip cost: the same network on the CPU gives the same counts,
    #    and CompiledSNN.cost on them equals the card run's.
    compiled = out["compiled"]
    small = compiled.spec
    cpu = spidr.compile(small, init_params(torch.Generator().manual_seed(0), small),
                        compiled.target, device="cpu")
    cpu_out = cpu.run(out["facade_events"].cpu())
    check(torch.equal(cpu_out.input_counts, out["facade_result"].input_counts.cpu())
          and torch.equal(cpu_out.readout, out["facade_result"].readout.cpu()),
          "quickstart facade: card run != CPU run")
    cpu_cost = cpu.cost(input_counts=cpu_out.input_counts.numpy() / 2)
    card_cost = out["cost"]
    for f in dataclasses.fields(card_cost):
        if f.name != "pipeline_state":
            check(getattr(cpu_cost, f.name) == getattr(card_cost, f.name),
                  f"CompiledSNN.cost.{f.name}: card {getattr(card_cost, f.name)} "
                  f"!= CPU {getattr(cpu_cost, f.name)}")
    emit({"phase": "quickstart_check", "float_forward_free_running_equal": free_equal,
          "float_forward_readout_max_abs_diff": float((logits_p - out["logits"]).abs().max()),
          "float_forward_layer_by_layer": lock,
          "unfused_eq_fused": [
              {"layer": c["layer"], "int": c["int_unfused_eq_fused"],
               "float": c["float_unfused_vs_fused"]} for c in out["layer_checks"]],
          "cost_card_eq_cpu": True, "seconds": round(time.perf_counter() - t0, 3)})

    # 4. Zero skipping on clustered DVS spikes: the im2col of the gesture
    #    events (layer 1) and of layer 1's output spikes (layer 2).
    dvs = []
    for i, (name, s) in enumerate(out["spike_matrices"].items()):
        w, _ = quantize(out["params"][i], spec4)
        want = spike_gemm_ref(s, w)
        for skip, mode in SKIPS:
            check(torch.equal(spike_gemm(s, w, skip_empty=skip, skip_mode=mode), want),
                  f"spike_gemm on DVS {name} ({mode}, skip={skip}) != plain")
        bitmap = spike_tile_bitmap(s, CUDA_TILE)
        row = {"layer": name, "M": s.shape[0], "K": s.shape[1], "N": w.shape[1],
               "spike_density": float((s != 0).to(torch.float32).mean()),
               "tiles": bitmap.numel(),
               "empty_tile_share": 1.0 - float(bitmap.to(torch.float32).mean()),
               "graph_ms": {("dense" if not skip else mode):
                            _graph_ms(torch, lambda: spike_gemm(
                                s, w, skip_empty=skip, skip_mode=mode))
                            for skip, mode in SKIPS}}
        dvs.append(row)
        emit({"phase": "dvs_tile_skip", **row})
    results["spike_gemm"]["dvs"] = dvs


# ---------------------------------------------------------------------------
# 6. the LM stack's kernels (B6, B7) against their plain versions, timed
# ---------------------------------------------------------------------------
WKV_TOL = {"rtol": 2e-4, "atol": 2e-5}
QMM_TOL = {"rtol": 1e-4, "atol": 1e-4}
# Float32 compute, kernel route against plain route, 32 layers: B7's fp32
# differences (within WKV_TOL) carried through the layers.
FP32_LOGIT_REL = 1e-3
LM_HEADS, LM_HEAD_SIZE, LM_CHUNK = 64, 64, 32
CM_SHAPE = (4096, 14336)  # rwkv6-7b channel-mix key projection (K, N)
QMM_SWEEP_M = (1, 4, 8, 16, 17)  # each side of B6's regime cut-over


def _tol_ratio(torch, got, want, tol) -> float:
    """max |got - want| / (atol + rtol |want|): <= 1 is within tolerance."""
    err = (got - want).abs()
    return float((err / (tol["atol"] + tol["rtol"] * want.abs())).max())


def _wkv_inputs(torch, dev, seed, b, s, h=LM_HEADS, n=LM_HEAD_SIZE):
    """tests/test_wkv_kernel.py's draws at full width."""
    import numpy as np

    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, h, n)).astype(np.float32) for _ in range(3))
    lw = -rng.uniform(0.01, 1.0, (b, s, h, n)).astype(np.float32)
    u = rng.normal(size=(h, n)).astype(np.float32)
    s0 = rng.normal(size=(b, h, n, n)).astype(np.float32) * np.float32(0.1)
    return [torch.from_numpy(a).to(dev) for a in (r, k, v, lw, u, s0)]


def _wkv_bound(b, s, h, n, c) -> dict:
    """Bytes: r, k, v, lw and y once, u, S0 and S1 once.  fp32 operations
    per chunk-head: 2CN^2 inter, ~1.5C^2N for the decay matrix, 2C^2N for
    A v, 2CN^2 for the state."""
    nbytes = 4 * (5 * b * s * h * n + h * n + 2 * b * h * n * n)
    ops = (b * h * (s // c)) * (4 * c * n * n + 3.5 * c * c * n)
    return _roofline(nbytes, int(ops), FP32_OPS_PER_S)


def _qmm_bound(m, k, n, bits) -> dict:
    nbytes = 4 * m * k + (k * n if bits == 8 else k * n // 2) + 4 * n + 4 * m * n
    return _roofline(nbytes, 2 * m * k * n, FP32_OPS_PER_S)


def phase_lm_kernels(torch, dev):
    from repro_torch.core.quant import QuantSpec, quantize
    from repro_torch.kernels import quant_matmul as qmm
    from repro_torch.kernels import ref
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.kernels.wkv_chunk import wkv_sequence

    t0 = time.perf_counter()
    results = {name: {"max_abs_err": 0.0, "library_ms": None, "library_graph_ms": None,
                      "library_note": LIBRARY_NOTE[name], "shapes": []}
               for name in ("wkv_sequence", "quant_matmul_int8", "quant_matmul_int4")}
    worst = dict.fromkeys(results, 0.0)
    for b, s in ((1, 32), (1, 64), (1, 512), (4, 32), (4, 512)):
        ins = _wkv_inputs(torch, dev, b * 1000 + s, b, s)
        got = wkv_sequence(*ins, chunk=LM_CHUNK)
        want = ref.wkv_sequence_ref(*ins, LM_CHUNK)
        torch.cuda.synchronize()
        ratio = max(_tol_ratio(torch, g, w, WKV_TOL) for g, w in zip(got, want))
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        check(ratio <= 1.0, f"wkv_sequence != plain at B={b} S={s}: max abs err "
              f"{err}, {ratio:.3f} x the tolerance {WKV_TOL}")
        results["wkv_sequence"]["max_abs_err"] = max(results["wkv_sequence"]["max_abs_err"], err)
        worst["wkv_sequence"] = max(worst["wkv_sequence"], ratio)
        row = {"shape": f"B={b} S={s}", "B": b, "S": s, "H": LM_HEADS,
               "N": LM_HEAD_SIZE, "chunk": LM_CHUNK, "max_abs_err": err,
               "tol_ratio": ratio,
               "ms": _time_ms(torch, lambda: wkv_sequence(*ins, chunk=LM_CHUNK), 20),
               "graph_ms": _graph_ms(torch, lambda: wkv_sequence(*ins, chunk=LM_CHUNK)),
               "plain_ms": _time_ms(torch, lambda: ref.wkv_sequence_ref(*ins, LM_CHUNK), 3),
               **_wkv_bound(b, s, LM_HEADS, LM_HEAD_SIZE, LM_CHUNK)}
        results["wkv_sequence"]["shapes"].append(row)
        emit({"phase": "kernel_timing", "kernel": "wkv_sequence", **row})
        del ins, got, want

    g = torch.Generator(device=dev).manual_seed(3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # Ragged shapes (every edge masked in the kernels), full-range weights,
    # on each side of the regime cut-over: the decode kernel where M <= 16
    # and the tiled one at every M.
    qmm_cases = 0
    for m, k, n in ((16, 64, 32), (130, 514, 258), (33, 96, 1000)) + tuple(
            (m, k, n) for m in QMM_SWEEP_M for k, n in ((514, 1000), (96, 258))):
        x = torch.randn((m, k), generator=g, device=dev)
        sc = torch.rand((n,), generator=g, device=dev) * 0.01 + 1e-4
        for bits in (8, 4):
            lo = -(1 << (bits - 1))
            w = torch.randint(lo, -lo, (k, n), generator=g, device=dev, dtype=torch.int8)
            wq = w if bits == 8 else ref.pack_int4(w)
            want = ref.quant_matmul_ref(x, wq, sc, bits)
            for regime in _qmm_regimes(qmm, m, k, n, bits, sms):
                got = qmm.launch(x, wq, sc, bits, regime)
                torch.cuda.synchronize()
                ratio = _tol_ratio(torch, got, want, QMM_TOL)
                check(ratio <= 1.0, f"quant_matmul int{bits} != plain at {(m, k, n)} "
                      f"regime {regime}: {ratio:.3f} x the tolerance {QMM_TOL}")
                worst[f"quant_matmul_int{bits}"] = max(worst[f"quant_matmul_int{bits}"], ratio)
                qmm_cases += 1
    # The channel-mix shape: a dense_init weight quantized per output channel.
    k, n = CM_SHAPE
    w = torch.randn((k, n), generator=g, device=dev) / k ** 0.5
    for bits in (8, 4):
        name = f"quant_matmul_int{bits}"
        q, sc = quantize(w, QuantSpec(bits), axis=0)
        sc = sc.reshape(-1)
        wq = q if bits == 8 else ref.pack_int4(q)
        w_deq = q.to(torch.float32) * sc  # the library yardstick's weight
        # The cut-over: each regime's device time on each side of it, and
        # the tiled kernel as its tiles fill the card.
        for m in QMM_SWEEP_M + (32, 128, 256):
            x = torch.randn((m, k), generator=g, device=dev)
            want = ref.quant_matmul_ref(x, wq, sc, bits)
            row = {"bits": bits, "M": m, "chosen": "decode" if m <= qmm.DECODE_MAX_M
                   else "tiled"}
            for regime in _qmm_regimes(qmm, m, k, n, bits, sms):
                label = "decode" if regime[0] else "tiled"
                got = qmm.launch(x, wq, sc, bits, regime)
                torch.cuda.synchronize()
                ratio = _tol_ratio(torch, got, want, QMM_TOL)
                check(ratio <= 1.0, f"{name} {label} != plain at M={m}: {ratio:.3f} x "
                      f"the tolerance {QMM_TOL}")
                worst[name] = max(worst[name], ratio)
                row[f"{label}_graph_ms"] = _graph_ms(
                    torch, lambda: qmm.launch(x, wq, sc, bits, regime))
            row["library_graph_ms"] = _graph_ms(torch, lambda: torch.matmul(x, w_deq))
            results[name].setdefault("regimes", []).append(row)
            emit({"phase": "qmm_regime", **row})
        for m in (4, 512):
            x = torch.randn((m, k), generator=g, device=dev)
            got = quant_matmul(x, wq, sc, bits)
            want = ref.quant_matmul_ref(x, wq, sc, bits)
            lib = torch.matmul(x, w_deq)
            torch.cuda.synchronize()
            ratio = _tol_ratio(torch, got, want, QMM_TOL)
            err = float((got - want).abs().max())
            check(ratio <= 1.0, f"{name} != plain at M={m}: max abs err {err}, "
                  f"{ratio:.3f} x the tolerance {QMM_TOL}")
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
            worst[name] = max(worst[name], ratio)
            row = {"shape": f"M={m}", "M": m, "K": k, "N": n, "bits": bits,
                   "max_abs_err": err, "tol_ratio": ratio,
                   "ms": _time_ms(torch, lambda: quant_matmul(x, wq, sc, bits), 20),
                   "graph_ms": _graph_ms(torch, lambda: quant_matmul(x, wq, sc, bits)),
                   "plain_ms": _time_ms(torch, lambda: ref.quant_matmul_ref(
                       x, wq, sc, bits), 5),
                   "library_ms": _time_ms(torch, lambda: torch.matmul(x, w_deq), 20),
                   "library_graph_ms": _graph_ms(torch, lambda: torch.matmul(x, w_deq)),
                   "library_max_abs_err": float((lib - want).abs().max()),
                   **_qmm_bound(m, k, n, bits)}
            results[name]["shapes"].append(row)
            emit({"phase": "kernel_timing", "kernel": name, **row})
        del q, wq, w_deq
    emit({"phase": "lm_kernels_vs_plain", "tolerance": {"wkv": WKV_TOL,
                                                        "quant_matmul": QMM_TOL},
          "quant_matmul_ragged_cases": qmm_cases, "worst_tol_ratio": worst,
          "seconds": round(time.perf_counter() - t0, 3)})
    # Headlines at the main path's shapes: a served prompt's prefill (B=1,
    # S=64) for B7, the decode slots' channel-mix (M=4) for B6.
    for name, shape in (("wkv_sequence", "B=1 S=64"), ("quant_matmul_int8", "M=4"),
                        ("quant_matmul_int4", "M=4")):
        main = next(x for x in results[name]["shapes"] if x["shape"] == shape)
        results[name].update({key: main[key] for key in (
            "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by")})
        if name != "wkv_sequence":
            results[name]["library_ms"] = main["library_ms"]
            results[name]["library_graph_ms"] = main["library_graph_ms"]
    return results


def _qmm_regimes(qmm, m, k, n, bits, sms) -> list:
    """The tiled regime, and the decode regime where M allows it."""
    return [qmm.TILED] + ([qmm.plan(m, k, n, bits, sms)] if m <= qmm.DECODE_MAX_M else [])


# ---------------------------------------------------------------------------
# 7. rwkv6-7b at full width, served through the port's Server
# ---------------------------------------------------------------------------
LM_REQUESTS, LM_CAPACITY, LM_PROMPT, LM_NEW, LM_CTX = 8, 4, 64, 8, 128


def _lm_requests(cfg):
    import numpy as np

    from repro_torch.launch.serve import Request

    rng = np.random.default_rng(1)
    return [Request(rid=i, max_new=LM_NEW, prompt=rng.integers(
        0, cfg.vocab_size, LM_PROMPT).astype(np.int32)) for i in range(LM_REQUESTS)]


def _serve_lm(torch, dev, cfg, params, use_kernel=None):
    from repro_torch.launch.serve import Server

    server = Server(cfg, params, capacity=LM_CAPACITY, ctx_len=LM_CTX,
                    use_kernel=use_kernel)
    for req in _lm_requests(cfg):
        server.submit(req)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    while server.step():
        pass
    torch.cuda.synchronize(dev)
    return server, time.perf_counter() - t0


def lm_model(torch, dev) -> dict:
    """rwkv6-7b at full width: float32 masters from a seed, their bfloat16
    serving copies, and one short request served to warm the caches up
    (kernel loads, cuBLAS heuristics) before the timed run."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import model as M

    cfg = get_config("rwkv6-7b")
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    masters = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    params = M.serving_params(masters)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    warm = Server(cfg, params, capacity=LM_CAPACITY, ctx_len=LM_CTX)
    warm.submit(Request(rid=0, max_new=2, prompt=np.arange(LM_PROMPT, dtype=np.int32)))
    while warm.step():
        pass
    return {"cfg": cfg, "masters": masters, "params": params, "init_s": init_s,
            "n_params": sum(t.numel() for t in _leaves(masters))}


def phase_lm(torch, dev, kernels, lm) -> None:
    from repro_torch.core.quant import QuantSpec, quantize
    from repro_torch.kernels import ops, ref

    cfg, params, init_s, n_params = lm["cfg"], lm["params"], lm["init_s"], lm["n_params"]
    torch.cuda.reset_peak_memory_stats(dev)
    server, seconds = _serve_lm(torch, dev, cfg, params)
    done = {r.rid: r.generated for r in server.done}
    check(sorted(done) == list(range(LM_REQUESTS)), "lm: not every request served")
    check(all(len(t) == LM_NEW and all(0 <= x < cfg.vocab_size for x in t)
              for t in done.values()), "lm: a request's tokens are wrong in number or range")
    lm["server"] = server
    wkv = kernels.LAUNCHES["wkv_sequence"]
    check(wkv == cfg.n_layers * server.prefills,
          f"lm: wkv_sequence launched {wkv} times for {server.prefills} prefills "
          f"of {cfg.n_layers} layers")
    tokens = sum(len(t) for t in done.values())
    emit({"phase": "lm_serve", "arch": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
          "params": n_params, "init_and_cast_seconds": init_s,
          "requests": LM_REQUESTS, "capacity": LM_CAPACITY, "prompt_len": LM_PROMPT,
          "max_new": LM_NEW, "tokens": tokens, "serve_seconds": seconds,
          "tokens_per_s": tokens / seconds, "prefills": server.prefills,
          "prefill_seconds": server.prefill_seconds,
          "prefill_ms_each": 1e3 * server.prefill_seconds / server.prefills,
          "decode_steps": server.decode_steps, "decode_seconds": server.decode_seconds,
          "decode_ms_each": 1e3 * server.decode_seconds / server.decode_steps,
          "wkv_launches": wkv, "max_memory_allocated": torch.cuda.max_memory_allocated(dev)})

    # The served model's layer-0 channel-mix key projection, on the decode
    # slots' last channel-mix inputs, through quant_matmul_op.
    x = server.cache["x_cm"][0].to(torch.float32)          # (capacity, d_model)
    w = params["blocks"]["layers"]["rwkv"].cm_wk[0].to(torch.float32)
    dense = x @ w
    cm = {}
    for bits in (8, 4):
        q, sc = quantize(w, QuantSpec(bits), axis=0)
        wq = q if bits == 8 else ops.pack_int4(q)
        out = ops.quant_matmul_op(x, wq, sc.reshape(-1), bits=bits)
        want = ref.quant_matmul_ref(x, wq, sc.reshape(-1), bits)
        torch.cuda.synchronize(dev)
        ratio = _tol_ratio(torch, out, want, QMM_TOL)
        check(ratio <= 1.0 and bool(torch.isfinite(out).all()),
              f"lm channel-mix int{bits}: quant_matmul_op != plain ({ratio:.3f} x tol)")
        cm[f"int{bits}"] = {"tol_ratio": ratio, "rel_err_vs_bf16_weight": float(
            (out - dense).abs().max() / dense.abs().max())}
    # Per-channel rounding noise: max error over max |product| stays near
    # (amax / (2^(bits-1) - 1)) / sqrt(12) per unit of the weights' spread.
    check(cm["int8"]["rel_err_vs_bf16_weight"] < 0.03
          and cm["int4"]["rel_err_vs_bf16_weight"] < 0.25,
          f"lm channel-mix: quantized product outside quantization noise {cm}")
    emit({"phase": "lm_channel_mix_quant", "M": x.shape[0], "K": w.shape[0],
          "N": w.shape[1], **cm})


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


# ---------------------------------------------------------------------------
# 8. the full-width model: kernel route against plain route
# ---------------------------------------------------------------------------
def _lockstep_prefill(torch, cfg, params, tokens) -> dict:
    """A prefill layer by layer: each layer's r, k, v, lw go through B7 and
    the plain wkv, are held to B7's tolerance, and the walk goes on with
    the plain one (so its logits are the plain route's)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.wkv_chunk import wkv_sequence
    from repro_torch.models import model as M
    from repro_torch.models import rwkv6 as R
    from repro_torch.models import transformer as T
    from repro_torch.models.common import rmsnorm

    f32 = torch.float32
    h = M._embed(params, tokens)
    b, s, d = h.shape
    x0 = h.new_zeros((b, d))
    s0 = torch.zeros((b, d // LM_HEAD_SIZE, LM_HEAD_SIZE, LM_HEAD_SIZE), dtype=f32,
                     device=h.device)
    tot = {"layers": 0, "max_abs_dy": 0.0, "max_abs_ds": 0.0, "tol_ratio": 0.0}
    for i in range(cfg.n_layers):
        lp = T.layer(params["blocks"], i)
        tm_in = rmsnorm(h, lp["ln1"].to(f32), cfg.rmsnorm_eps)
        r, k, v, lw, g = R._time_mix_inputs(lp["rwkv"], tm_in, x0)
        u = lp["rwkv"].bonus_u.to(f32).reshape(d // LM_HEAD_SIZE, LM_HEAD_SIZE)
        r, k, v, lw = R._pad_to_chunk(r.to(f32), k.to(f32), v.to(f32), lw, LM_CHUNK)
        yk, sk = wkv_sequence(r, k, v, lw, u, s0, chunk=LM_CHUNK)
        yp, sp = ref.wkv_sequence_ref(r, k, v, lw, u, s0, LM_CHUNK)
        tot["layers"] += 1
        tot["max_abs_dy"] = max(tot["max_abs_dy"], float((yk - yp).abs().max()))
        tot["max_abs_ds"] = max(tot["max_abs_ds"], float((sk - sp).abs().max()))
        tot["tol_ratio"] = max(tot["tol_ratio"], _tol_ratio(torch, yk, yp, WKV_TOL),
                               _tol_ratio(torch, sk, sp, WKV_TOL))
        h = h + R._time_mix_output(lp["rwkv"], yp[:, :s], g, tm_in.dtype)
        cm_in = rmsnorm(h, lp["ln2"].to(f32), cfg.rmsnorm_eps)
        h = h + R.rwkv6_channel_mix(lp["rwkv"], cm_in, x0)[0]
    h = rmsnorm(h, params["final_norm"].to(f32), cfg.rmsnorm_eps)
    tot["logits"] = M._head_logits(params, cfg, h)
    return tot


def check_lm(torch, dev, lm) -> None:
    import numpy as np

    from repro_torch.models import model as M

    cfg, params, served = lm["cfg"], lm["params"], lm["server"]
    t0 = time.perf_counter()
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 512))).to(dev)
    with torch.no_grad():
        lock = _lockstep_prefill(torch, cfg, params, tokens)
        plain, _, _ = M.forward(params, cfg, tokens=tokens, use_kernel=False)
        kern, _, _ = M.forward(params, cfg, tokens=tokens, use_kernel=True)
    torch.cuda.synchronize(dev)
    walk_is_plain = bool(torch.equal(lock.pop("logits"), plain))
    check(walk_is_plain, "lm lockstep: the layer walk differs from the plain forward")
    check(lock["tol_ratio"] <= 1.0, f"lm lockstep: B7 outside its tolerance {lock}")
    check(bool(torch.isfinite(kern).all()) and tuple(kern.shape) == (1, 512, cfg.padded_vocab),
          "lm: kernel-route logits not finite or of the wrong shape")
    # As served (bfloat16), the two routes' logits drift apart: B7's fp32
    # differences flip bfloat16 roundings, and 32 layers of random weights
    # amplify them.  In float32 compute they must stay close.
    dlogit = float((kern - plain).abs().max())
    top = float(plain.abs().max())
    del plain, kern
    M.COMPUTE_DTYPE = torch.float32
    try:
        with torch.no_grad():
            plain32, _, _ = M.forward(lm["masters"], cfg, tokens=tokens, use_kernel=False)
            kern32, _, _ = M.forward(lm["masters"], cfg, tokens=tokens, use_kernel=True)
    finally:
        M.COMPUTE_DTYPE = torch.bfloat16
    dlogit32 = float((kern32 - plain32).abs().max())
    top32 = float(plain32.abs().max())
    del plain32, kern32
    check(dlogit32 <= FP32_LOGIT_REL * top32, f"lm float32: kernel-route logits differ "
          f"from the plain route's by {dlogit32} (largest logit {top32})")
    # The served tokens against a plain-route Server's: a token may differ
    # only where the plain route's top-2 gap is within twice the routes'
    # largest logit difference (each of the two logits may move by it).
    ref_server, ref_seconds = _serve_lm(torch, dev, cfg, params, use_kernel=False)
    got = {r.rid: r.generated for r in served.done}
    want = {r.rid: r.generated for r in ref_server.done}
    prompts = {r.rid: r.prompt for r in _lm_requests(cfg)}
    prefill = M.make_prefill_step(cfg, use_kernel=False)
    tol = 2 * dlogit
    differ = []
    for rid, toks in want.items():
        diff = [i for i, (a, b) in enumerate(zip(got[rid], toks)) if a != b]
        if diff:
            i = diff[0]
            seq = np.concatenate([prompts[rid], np.asarray(toks[:i], np.int64)])
            with torch.no_grad():
                logits, _ = prefill(params, {"tokens": torch.from_numpy(seq[None]).to(dev)})
            top2 = torch.topk(logits[0], 2).values
            gap = float(top2[0] - top2[1])
            differ.append({"rid": rid, "token": i, "plain_top2_gap": gap, "tol": tol})
            check(gap <= tol, f"lm: request {rid} token {i} differs between the "
                  f"kernel and plain routes with a top-2 gap of {gap} > {tol}")
    emit({"phase": "lm_check", "prefill_tokens": 512, "lockstep": lock,
          "tolerance": WKV_TOL, "walk_equals_plain_forward": walk_is_plain,
          "bf16_logits_max_abs_diff_kernel_vs_plain": dlogit, "bf16_largest_logit": top,
          "fp32_logits_max_abs_diff_kernel_vs_plain": dlogit32,
          "fp32_largest_logit": top32, "fp32_logits_tolerance_rel": FP32_LOGIT_REL,
          "served_requests_equal": sum(got[r] == want[r] for r in want),
          "served_requests_differing": differ, "token_gap_tolerance": tol,
          "plain_route_serve_seconds": ref_seconds,
          "seconds": round(time.perf_counter() - t0, 3)})

if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
