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
                layers M=2*110592 K=288 N=32 and N=2), and for B1, B2 and
                B4 also N=33 and a ragged (4097, 145, 16), and for B2 and
                B4 a fan-in beyond the tensor-core ring (4096, 2000, 32),
                and for B3 the optical-flow first layer (K=18, N=32),
                so both routes of each plan run: the integer kernels
                bit-exact, the
                float ones within the float tolerance (Vmem atol=rtol=1e-5,
                spikes equal except where the pre-reset Vmem lies within
                1e-5 of the threshold, each such spot counted); scalar and
                per-channel thresholds, every skip mode, hard and soft
                reset, T in {1, 3, 4, 5}, 0 % and
                10 % random spikes.  Then timings: CUDA events over eager
                launches (``ms``, host overhead included) and over a
                CUDA-graph replay of 100 launches (``graph_ms``, the device
                time per launch), each row with its launch plan, and the
                library yardstick the same two ways where one exists
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
  6. optical_flow  ``repro_torch.launch.optical_flow`` at full width
                (288x384, T=10, B=2): the float forward through B3 (80
                launches) and its AEE; ``spidr.compile`` of the same params
                on 1 core and on a compiled 4-core plan at 4-bit (whole
                layers on cores) and 8-bit (seven layers channel-split
                over two cores), and the params exported to per-channel
                8-bit integers, saved, loaded and deployed on 1 and 4
                cores; each at t_block 1 and 5.  Checked: every integer
                run bit-exact (readout, spike and input counts) with the
                1-core run and with backend="torch", every 4-core run
                making exactly the 1-core run's B1/B2 launches; then (after
                the launch counts are read) the float forward on the walk's
                inputs against the plain float path on the card, layer by
                layer as in phase 5, and free-running (equal spike counts,
                the Vmem readout within atol = rtol = T * 1e-5)
  6c. train    training (ROADMAP A10) at full width: gesture (64x64, T=20,
                batch 8) trained by deploy-exact QAT on one fixed batch
                for 12 steps (the loss must drop), exported, saved,
                ``spidr.load``ed and verified with its float params on 1
                and 4 cores (``VerifyReport.roundtrip`` exact), again with
                TF32 switched on; ``precision_sweep`` at 4/6/8 bit, each
                export round-tripping exactly; ``python -m
                repro_torch.launch.train --snn gesture --steps 3 --n-cores 4``
                in a child process; optical flow (288x384, T=10, batch 2)
                for 3 QAT steps, its export round-tripping exactly at
                ``t_block`` 1 (B1) and 5 (B2); one legacy ``mode="train"``
                step on B3 under autograd, whose input, weight and Vmem
                gradients are then held layer by layer against the plain
                path's (within 1e-4 of the largest; a spike flip only
                within 1e-5 of the threshold).  Each run prints its host
                ms per step, peak memory and launches (QAT training makes
                none: it runs on no kernel), each exactly as predicted
 6d. analysis  the deploy-time static analysis (ROADMAP A11) at full width:
                ``python -m repro_torch.analysis --all --json`` in a child
                (exit 0; every overflow certificate re-verifies, one with a
                changed ``acc_hi`` does not); ``spidr.compile(...,
                check="strict")`` of gesture (64x64, T=20, B=4) at 6/11 and
                8/15 bits and optical flow (288x384, T=10, B=2) at 8/15, on
                1 and 4 cores (the 4-core report with the schedule pass),
                run at ``t_block`` 1 and 4 (flow 1 and 5) bit-exact with
                backend="torch"; ``analysis.stress_fleet`` on full-width
                gesture (2 replicas on the card, 6 streams at capacity 2,
                sync against threaded, each threaded replica on its own
                CUDA stream, no mismatch); ``core.cim_macro.accumulate`` on
                CUDA tensors through B4 (M=16, K=128, N=48/W_b) at 4/7,
                6/11 and 8/15 bits.  Then, after the launch counts are
                read: the certificate's extremes (all-one spikes on
                all-``w_min`` and all-``w_max`` weights, flow's layers at
                8/15 bits and K=2000): B4's raw sums equal ``acc_lo`` /
                ``acc_hi``, B1 and B2 equal their plain versions and
                saturate to ``v_min`` / ``v_max``; ``accumulate`` on the
                card equal to the CPU's, within range, and equal to
                ``accumulate_sequential`` wherever no silicon-order partial
                sum leaves the range.  Every ``spidr.compile`` of every
                phase (and of the launch modules they drive) is held to
                ``report().errors == ()``, and the analysis' warning is an
                error in this process and its children
  7. lm kernels the LM stack's kernels against their plain versions on the
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
  8. lm         rwkv6-7b at full published width (32 layers, d_model 4096,
                random weights from a seed, bfloat16 serving copies) serving
                8 requests of 64 tokens (8 new each) through the port's
                Server at capacity 4; every prefill launches B7 once per
                layer.  Then the served model's layer-0 channel-mix key
                projection on the 4 slots' last inputs through
                ``ops.quant_matmul_op`` (int8 and int4, per-channel scales)
  9. lm check   one 512-token prefill layer by layer: each layer's r, k, v,
                lw through B7 and the plain wkv, held to B7's tolerance, the
                walk going on with the plain one; the logits of the kernel
                route against the plain route's; the served tokens against
                a plain-route Server's (a difference is allowed only where
                the plain route's top-2 logit gap is within twice the two
                routes' largest bfloat16 logit difference); in float32
                compute, the two routes' logits within 1e-3 of the largest,
                and the 8 requests served again in float32 through both
                routes: a token may differ only where the plain route's
                float32 top-2 gap is within 2e-3 of its largest logit (a
                bound fixed before the run); the bfloat16 residual stream
                of one served prefill, both routes side by side, layer by
                layer
 10. lm families  (ROADMAP A12.1; no kernel of the port runs here, and the
                phase checks that no launch count moves) (a) each of the nine
                attention / MoE / hybrid architectures in registry order at
                full published width, bfloat16 serving copies drawn layer
                by layer (``init_serving_params``, seed 0; no float32
                masters on the card), serving 8 requests of 64 tokens (8
                new each) at capacity 4 through the port's Server: every
                logit row finite, every token below ``vocab_size``, 8
                tokens per request; outside MoE the decode of token 65
                after a 64-token prefill against a 65-token prefill's last
                logits, within 0.05 of its largest logit; one JSON line per
                arch (parameters, GB, peak memory, init seconds, prefill
                and decode host ms, tokens/s, MoE drop fraction); the card
                freed between archs.  (b) each arch's ``reduced()`` config,
                the same parameters on the card and on the CPU (TF32 off):
                teacher-forced logits of a prefill and 4 decode steps
                within 0.05 of the largest logit, and ragged prompts (8,
                12, 8, 40 tokens at capacity 2) served on both with equal
                tokens except at a near tie of the CPU's top-2 gap (by the
                same bound)
 11. lm train   (ROADMAP A12.2; B1-B6 must not launch, B7 launches in the
                forward and the remat recompute of every rwkv6 layer) (a)
                qwen1.5-0.5b at full published width and depth, float32
                masters from seed 0: one ``accum_steps=2`` step against
                ``accum_steps=1`` from the same params and batch (loss rtol
                1e-3; params rtol 2e-2, atol 2.5e-3: the reference's
                ``tests/test_grad_accum.py``), then 12 steps of the token
                pipeline (batch 8, 128 tokens, lr 1e-3) through
                ``TrainingLoop`` with a checkpoint every 6 steps in a temp
                directory; step 6 runs and then fails once
                (``RestartableFailure``): restarts == 1, every loss finite,
                the last below the first; host ms per step, peak GB.  (b)
                rwkv6-7b at full width, 12 of 32 layers: 3 steps, B7 exactly
                24 launches per step.  (c) granite-moe-3b-a800m at full
                width, 16 of 32 layers: 3 steps, every metric finite, the
                MoE layers' drop fraction.  Then, after the launch counts
                are read: rwkv6-7b at 4 layers in float32 compute, one
                batch's gradients through B7 (``_WkvSequenceTrain``) and
                through the plain wkv, every leaf within 1e-3 of its
                largest; (d) each of the ten ``reduced()`` configs, one
                train step from the same params and batch on the card and
                on the CPU (float32 compute, TF32 off): loss and grad_norm
                within 1e-4 relative, every gradient leaf within 1e-3 of
                its largest
 12. a ``kernels`` line: launches on phases 3-6, 6c, 6d, 8 and 11, max error,
     kernel / plain / bound / library times per kernel

then the card's name and power limit (nvidia-smi) and, last, the line
``{"ok": true, "device": {...}}``.  Any mismatch, a kernel that does not
build or launch, or a kernel the main path never launched exits non-zero
without that line.  Weights are random from a fixed seed.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import statistics
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
    if sys.argv[1:2] == ["--flow-restore-child"]:
        return _flow_restore_child(torch, sys.argv[2:])
    _guard_compiles()
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
    streams = phase_streaming(torch, dev, kernels)
    launches = {k: n + kernels.LAUNCHES[k] for k, n in launches.items()}
    check_streaming(torch, dev, kernels, streams)
    del streams
    kernels.reset_launches()
    quick = phase_quickstart(torch, dev)
    launches = {k: n + kernels.LAUNCHES[k] for k, n in launches.items()}
    check_quickstart(torch, dev, quick, results)
    kernels.reset_launches()
    flow_walk = phase_optical_flow(torch, dev)
    launches = {k: n + kernels.LAUNCHES[k] for k, n in launches.items()}
    check_optical_flow(torch, dev, flow_walk)
    del flow_walk
    kernels.reset_launches()
    fleet_runs = phase_fleet(torch, dev, kernels)
    launches = {k: n + kernels.LAUNCHES[k] for k, n in launches.items()}
    check_fleet(torch, dev, fleet_runs)
    del fleet_runs
    kernels.reset_launches()
    tuned_runs = phase_autotune(torch, dev, kernels)
    launches = {k: n + kernels.LAUNCHES[k] for k, n in launches.items()}
    check_autotune(torch, dev, tuned_runs)
    del tuned_runs
    kernels.reset_launches()
    train_runs = phase_train(torch, dev, kernels, card)
    launches = {k: n + kernels.LAUNCHES[k] for k, n in launches.items()}
    check_train(torch, dev, train_runs)
    del train_runs
    kernels.reset_launches()
    analysis_runs = phase_analysis(torch, dev)
    phase_launches = {k: kernels.LAUNCHES[k] for k in
                      ("fused_lif_gemm_int", "fused_lif_gemm_int_tblk", "spike_gemm")}
    launches = {k: n + kernels.LAUNCHES[k] for k, n in launches.items()}
    check_analysis(torch, dev, analysis_runs, phase_launches)
    del analysis_runs
    results.update(phase_lm_kernels(torch, dev))
    lm = lm_model(torch, dev)
    kernels.reset_launches()
    phase_lm(torch, dev, kernels, lm)
    launches = {k: n + kernels.LAUNCHES[k] for k, n in launches.items()}
    emit({"phase": "launches",
          "paths": "gesture + flow + streaming + quickstart + optical_flow walk + "
                   "fleet + autotune + train + analysis + lm",
          "launches": launches})
    check_lm(torch, dev, lm)
    del lm
    kernels.reset_launches()
    phase_lm_families(torch, dev, card)
    moved = {k: n for k, n in kernels.LAUNCHES.items() if n}
    check(not moved, f"lm_families: the LM families launched kernels {moved}")
    kernels.reset_launches()
    train_runs = phase_lm_train(torch, dev, kernels)
    phase_launches = dict(kernels.LAUNCHES)
    launches = {k: n + phase_launches[k] for k, n in launches.items()}
    emit({"phase": "launches", "paths": "all of the above + lm_train",
          "lm_train": phase_launches, "launches": launches})
    check_lm_train(torch, dev, card, train_runs, phase_launches)
    del train_runs
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
# Checked beside SHAPES: a fan-in whose two ring stages do not fit in a
# block's shared memory (the tile-loop route of B1, B2 and B4), one past the
# tile loop's resident weight slice (its fan-in walked in chunks), N = 33
# (two slabs), and a ragged M with an odd K (a short last tile, and B2's
# planes starting off 16 bytes).
EDGE_SHAPES = {
    "wide_fan_in": (4096, 2000, 32),
    "chunked_fan_in": (1024, 7105, 32),
    "n33": (4096, 288, 33),
    "ragged": (4097, 145, 16),
}
# B3's shapes on its main path, the quickstart's float forward (gesture
# net, 64x64, B=4, T=10): 10, 20, 20 and 10 launches per walk.
FLOAT_SHAPES = {
    "gesture_first": (4 * 64 * 64, 18, 16),
    "gesture_conv": (4 * 64 * 64, 144, 16),
    "gesture_conv_pooled": (4 * 32 * 32, 144, 16),
    "gesture_fc": (4, 64, 11),
}
# And on the optical-flow walk's float forward (288x384, B=2, T=10): 10
# launches at the first layer (K = 3*3*2, where N = 32 takes the slab
# route), 60 in the middle and 10 at the last layer.
B3_TIMED = {**FLOAT_SHAPES, "flow_first": (2 * 288 * 384, 18, 32),
            "flow_middle": SHAPES["flow_middle"], "flow_last": SHAPES["flow_last"]}
B3_CHECKED = {**B3_TIMED, **EDGE_SHAPES}


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


def _plan_row(plan) -> dict:
    return {"route": plan.route, "grid_x": plan.grid_x, "stages": plan.stages}


def _check_smem() -> None:
    """The wrappers' plans size shared memory as the kernels lay it out."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_lif_gemm as fl
    from repro_torch.kernels import spike_gemm as sk
    from repro_torch.kernels import wkv_chunk as wk

    sg = _build.bind("spike_gemm", sk._SIGNATURES)
    for shape_name, (m, k, n) in {**SHAPES, **EDGE_SHAPES, **B3_TIMED}.items():
        pairs = [("B2 tile loop", fl._fn("spidr_fused_lif_gemm_int_tblk_tile_smem")(k)
                  + fl._TILE_STATIC, fl.tblk_tile_smem(k))]
        for stages in range(2, 9):
            if stages <= 4:
                pairs.append((f"B1 stages={stages}", fl._fn(
                    "spidr_fused_lif_gemm_int_smem")(k, n, stages), fl.tc_smem(k, n, stages)))
                pairs.append((f"B3 stages={stages}", fl._fn(
                    "spidr_fused_lif_gemm_f32_smem")(k, n, stages), fl.f32_smem(k, n, stages)))
            pairs.append((f"B2 stages={stages}", fl._fn(
                "spidr_fused_lif_gemm_int_tblk_smem")(k, n, stages), fl.tblk_smem(k, n, stages)))
            pairs.append((f"B4 stages={stages}", sg["spidr_spike_gemm_smem"](
                k, n, stages), sk.ring_smem(k, n, stages)))
        for what, c_bytes, py_bytes in pairs:
            check(c_bytes == py_bytes, f"{what} at {shape_name}: the wrapper's "
                  f"shared memory {py_bytes} != the kernel's {c_bytes}")
    wkv = _build.bind("wkv_chunk", wk._SIGNATURES)["spidr_wkv_smem"]
    for c in wk.SIZES:
        for n in wk.SIZES:
            for per_block in (1, 2):
                check(wkv(c, n, per_block) == wk.smem_bytes(c, n, per_block),
                      f"B7 C={c} N={n} per_block={per_block}: the wrapper's shared "
                      f"memory {wk.smem_bytes(c, n, per_block)} != the kernel's "
                      f"{wkv(c, n, per_block)}")


def phase_kernels(torch, dev, fk):
    from repro_torch.kernels import fused_lif_gemm as fl
    from repro_torch.kernels import ref

    _check_smem()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    plain = {"fused_lif_gemm_int": ref.fused_lif_gemm_int_ref,
             "fused_lif_gemm_int_tblk": ref.fused_lif_gemm_int_tblk_ref}
    kernel = {"fused_lif_gemm_int": fk.fused_lif_gemm_int,
              "fused_lif_gemm_int_tblk": fk.fused_lif_gemm_int_tblk}
    max_err = {name: 0 for name in kernel}
    checked = {name: 0 for name in kernel}
    routes = {name: set() for name in kernel}
    t0 = time.perf_counter()
    for shape_name, (m, k, n) in {**SHAPES, **EDGE_SHAPES}.items():
        for name, ts in (("fused_lif_gemm_int", (None,)),
                         ("fused_lif_gemm_int_tblk", (4, 3, 1, 5))):
            plan = (fl.tc_plan if name == "fused_lif_gemm_int" else fl.tblk_plan)(
                m, k, n, sms)
            routes[name].add(plan.route)
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
    check(all(r == {"ring", "tile"} for r in routes.values()),
          f"B1's and B2's checks ran the routes {routes}, not both of each")
    small = _small_engine_check(torch, dev)
    wide = _wide_engine_check(torch, dev)
    emit({"phase": "kernels_vs_plain", "bit_exact": True, "cases": checked,
          "max_abs_err": max_err, "routes": {k: sorted(r) for k, r in routes.items()},
          "engine_small_cpu_vs_card": small, "engine_wide_fan_in_vs_torch": wide,
          "seconds": round(time.perf_counter() - t0, 3)})

    # Timings at the main path's shapes: the network's neuron program
    # (4-bit: 7-bit Vmem), scalar threshold (a kernel argument for both),
    # skip_empty on, 10% random spikes.
    results = {name: {"max_abs_err": max_err[name], "library_ms": None,
                      "library_graph_ms": None, "library_note": LIBRARY_NOTE[name],
                      "shapes": []}
               for name in kernel}
    for shape_name, (m, k, n) in SHAPES.items():
        for name, t in (("fused_lif_gemm_int", None), ("fused_lif_gemm_int_tblk", 4),
                        ("fused_lif_gemm_int_tblk", 5)):
            s, w, v, _ = _inputs(torch, dev, m, k, n, 7, t=t, seed=1)
            kw = dict(leak_shift=3, soft_reset=False, vmem_bits=7)
            k_ms = _time_ms(torch, lambda: kernel[name](s, w, v, 5, **kw), 20)
            g_ms = _graph_ms(torch, lambda: kernel[name](s, w, v, 5, **kw))
            p_ms = _time_ms(torch, lambda: plain[name](s, w, v, 5, **kw), 5)
            row = {"shape": shape_name, "T": t, "M": m, "K": k, "N": n,
                   "ms": k_ms, "graph_ms": g_ms, "plain_ms": p_ms,
                   **_bound(s, m, k, n, t)}
            row.update(_plan_row((fl.tc_plan if t is None else fl.tblk_plan)(
                m, k, n, sms)))
            results[name]["shapes"].append(row)
            emit({"phase": "kernel_timing", "kernel": name, **row})
            del s, w, v
    return _headline(results)


def _headline(results: dict) -> dict:
    """The headline numbers are the optical-flow middle layer's, the main
    paths' largest shape (B5 at that layer's (M, N)); B3's are the
    quickstart's gesture conv layer's, the largest shape on its path."""
    for name, r in results.items():
        shape = "gesture_conv" if name == "fused_lif_gemm" else "flow_middle"
        main = next(x for x in r["shapes"] if x["shape"] == shape)
        r.update(ms=main["ms"], graph_ms=main["graph_ms"],
                 plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                 bound_by=main["bound_by"])
        for key in ("library_ms", "library_graph_ms"):
            if key in main:
                r[key] = main[key]
    return results


def _wide_fan_in_net(k):
    """A 1x1 conv of fan-in ``k`` at 8x8 into an FC layer: past B1's ring
    (K >= 1,345 at N = 32); 7,105 is past the tile loop's resident slice."""
    from repro_torch.core.layers import SpikingConvParams, SpikingDenseParams
    from repro_torch.core.network import SNNLayer, SNNSpec
    from repro_torch.core.neuron import NeuronConfig

    n = NeuronConfig(model="lif", reset="hard", threshold=0.5, leak=0.95)
    return SNNSpec(name="wide", input_hw=(8, 8), in_channels=k, timesteps=4,
                   layers=(SNNLayer("conv", k, 32, conv=SpikingConvParams(1, 1, 1, 0, n)),
                           SNNLayer("fc", 8 * 8 * 32, 11, fc=SpikingDenseParams(n))),
                   readout="rate")


def _wide_engine_check(torch, dev) -> dict:
    """Fan-ins the reference takes and the ring cannot hold, through
    ``spidr.compile`` (8-bit weights, 15-bit Vmem) on the card: the fused
    engine equals backend="torch" bit for bit; returns the spikes seen."""
    from repro_torch import spidr
    from repro_torch.core.network import init_params

    seen = {}
    for k, t_block in ((1345, 1), (7105, 1), (7105, 4)):
        spec = _wide_fan_in_net(k)
        params = init_params(torch.Generator().manual_seed(0), spec)
        ev = (torch.rand((4, 2, 8, 8, k), generator=torch.Generator().manual_seed(1))
              < 0.1).to(torch.float32).to(dev)
        want = spidr.compile(spec, params, spidr.DeployTarget(
            weight_bits=8, backend="torch"), device=dev).run(ev)
        got = spidr.compile(spec, params, spidr.DeployTarget(
            weight_bits=8, backend="fused", t_block=t_block), device=dev).run(ev)
        for a, b, what in ((got.readout, want.readout, "readout"),
                           (got.spike_counts, want.spike_counts, "spike counts"),
                           (got.input_counts, want.input_counts, "input counts")):
            check(torch.equal(a, b), f"wide fan-in K={k} t_block={t_block}: {what} "
                  "differ from backend='torch'")
        seen[f"K={k} t_block={t_block}"] = int(want.spike_counts.sum())
    check(all(seen.values()), f"wide fan-in: a run without spikes {seen}")
    return seen


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
    from repro_torch.kernels import fused_lif_gemm as fk
    from repro_torch.kernels import ref
    from repro_torch.kernels import spike_gemm as sk
    from repro_torch.kernels.fused_lif_gemm import fused_lif_gemm
    from repro_torch.kernels.lif_step import lif_step_fused, lif_step_fused_int
    from repro_torch.kernels.spike_gemm import spike_gemm

    t0 = time.perf_counter()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    names = ("fused_lif_gemm", "spike_gemm", "lif_step_fused", "lif_step_fused_int")
    max_err = dict.fromkeys(names, 0)
    cases = dict.fromkeys(names, 0)
    flips = {"fused_lif_gemm": 0, "lif_step_fused": 0}
    b4_routes = set()

    def hold_b4(s8, w8, what):
        """B4 in every skip mode."""
        want = ref.spike_gemm_ref(s8, w8)
        (m, k), n = s8.shape, w8.shape[1]
        plan = sk.plan(m, k, n, sms)
        b4_routes.add(plan.route)
        for skip_empty, mode in SKIPS:
            got = spike_gemm(s8, w8, skip_empty=skip_empty, skip_mode=mode)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            max_err["spike_gemm"] = max(max_err["spike_gemm"], err)
            check(err == 0, f"spike_gemm != plain {what} skip_empty="
                  f"{skip_empty} mode={mode} plan={plan}: {err}")
            cases["spike_gemm"] += 1

    def hold_float(name, res, what):
        check(res["ok"], f"{name} disagrees with plain {what}: {res}")
        max_err[name] = max(max_err[name], res["max_abs_err"])
        flips[name] += res["spikes_flipped"]
        cases[name] += 1

    for shape_name, (m, k, n) in EDGE_SHAPES.items():
        for density in (0.1, 0.0):
            s8, w8, _, _ = _inputs(torch, dev, m, k, n, 7, density=density)
            hold_b4(s8, w8, f"at {shape_name} density={density}")
    for shape_name, (m, k, n) in B3_CHECKED.items():
        for density in (0.1, 0.0):
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
            del s, w, v, current
    for shape_name, (m, k, n) in SHAPES.items():
        for density in (0.1, 0.0):
            s8, w8, _, _ = _inputs(torch, dev, m, k, n, 7, density=density)
            hold_b4(s8, w8, f"at {shape_name} density={density}")
            del s8, w8
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
    check(b4_routes == {"ring", "tile"}, f"B4's checks ran the routes {b4_routes}, "
          "not both")
    emit({"phase": "unfused_kernels_vs_plain", "cases": cases,
          "max_abs_err": max_err, "b4_routes": sorted(b4_routes),
          "spikes_flipped_near_threshold": flips,
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
        plan = sk.plan(m, k, n, sms)
        row = {"shape": shape_name, "M": m, "K": k, "N": n, **_plan_row(plan),
               "ms": _time_ms(torch, lambda: spike_gemm(s8, w8), 20),
               "graph_ms": _graph_ms(torch, lambda: spike_gemm(s8, w8)),
               "graph_ms_by_mode": {
                   (m_ if skip else "dense"):
                   _graph_ms(torch, lambda: spike_gemm(s8, w8, skip_empty=skip,
                                                         skip_mode=m_))
                   for skip, m_ in SKIPS},
               # The bitmap mode's prologue alone (plain PyTorch).
               "bitmap_prologue_graph_ms": _graph_ms(
                   torch, lambda: ref.spike_tile_bitmap(s8, sk.CUDA_TILE)),
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

        del s8, w8
        v = torch.randn((m, n), device=dev) * 0.3
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
    for shape_name, (m, k, n) in B3_TIMED.items():
        s, w, v = _float_inputs(torch, dev, m, k, n, seed=1)
        nnz = int((s != 0).sum())
        row = {"shape": shape_name, "M": m, "K": k, "N": n,
               **_plan_row(fk.f32_plan(m, k, n, sms)),
               "ms": _time_ms(torch, lambda: fused_lif_gemm(s, w, v, 0.5, 0.95), 20),
               "graph_ms": _graph_ms(torch, lambda: fused_lif_gemm(s, w, v, 0.5, 0.95)),
               "plain_ms": _time_ms(torch, lambda: ref.fused_lif_gemm_ref(
                   s, w, v, 0.5, 0.95), 5),
               **_roofline(4 * m * k + 4 * k * n + 3 * 4 * m * n, 2 * nnz * n,
                           FP32_OPS_PER_S)}
        results["fused_lif_gemm"]["shapes"].append(row)
        emit({"phase": "kernel_timing", "kernel": "fused_lif_gemm", **row})
        del s, w, v
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
# 4b. streaming at full width: StreamWorker, snapshots, migration, the drill
# ---------------------------------------------------------------------------
STREAM_SEED = 1
# (net, t_block, chunk_T): gesture at capacity 4 with 6 streams (slots
# retire and are reused), optical flow at capacity 2 with 3 streams, each
# once on B1 (t_block 1) and once on B2.
STREAM_RUNS = (("gesture", 1, 2), ("gesture", 4, 4),
               ("optical-flow", 5, 5), ("optical-flow", 1, 5))
STREAM_GEOMETRY = {"gesture": {"capacity": 4, "streams": 6},
                   "optical-flow": {"capacity": 2, "streams": 3}}


def _stream_inputs(torch, net):
    """The net's spec, random params (seed 0) and ``(T, N, H, W, 2)`` events."""
    from repro_torch.configs import spidr_gesture, spidr_optflow
    from repro_torch.core.network import init_params
    from repro_torch.snn.data import make_flow_batch, make_gesture_batch

    spec = (spidr_gesture if net == "gesture" else spidr_optflow).CONFIG
    make = make_gesture_batch if net == "gesture" else make_flow_batch
    events, _ = make(torch.Generator().manual_seed(STREAM_SEED),
                     batch=STREAM_GEOMETRY[net]["streams"],
                     timesteps=spec.timesteps, hw=spec.input_hw, device="cpu")
    return spec, init_params(torch.Generator().manual_seed(0), spec), events.numpy()


def _stream_compile(dev, net, spec, params, backend, t_block, chunk_T):
    from repro_torch import spidr

    return spidr.compile(spec, params, spidr.DeployTarget(
        weight_bits=4, backend=backend, t_block=t_block, chunk_T=chunk_T,
        stream_capacity=STREAM_GEOMETRY[net]["capacity"]), device=dev)


def _serve_streams(kernels, compiled, events, snapshot_dir=None, on_tick=None):
    """Every stream through one StreamWorker; returns the worker, each
    tick's host ms (the step, its rewind mark included) and the B1/B2
    launches of the worker's own ticks."""
    from repro_torch.serving import StreamRequest, StreamWorker

    worker = StreamWorker(compiled, capacity=compiled.target.stream_capacity,
                          chunk_T=compiled.target.chunk_T,
                          snapshot_dir=snapshot_dir)
    for rid in range(events.shape[1]):
        worker.submit(StreamRequest(rid=rid, events=events[:, rid]))
    tick_ms, launches = [], dict.fromkeys(INT_KERNELS, 0)
    while True:
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        alive = worker.step()
        tick_ms.append(1e3 * (time.perf_counter() - t0))
        for k in INT_KERNELS:
            launches[k] += kernels.LAUNCHES[k] - before[k]
        if not alive:
            break
        if on_tick is not None:
            on_tick(worker)
    return worker, tick_ms[:-1], launches


def _same_streams(a: dict, b: dict, what: str) -> None:
    """Two ``{rid: StreamRequest}`` results, byte for byte."""
    check(sorted(a) == sorted(b), f"{what}: streams {sorted(a)} != {sorted(b)}")
    for rid, x in a.items():
        y = b[rid]
        check(x.readout.dtype == y.readout.dtype
              and x.readout.tobytes() == y.readout.tobytes(),
              f"{what}: stream {rid} readout differs")
        check((x.spikes, x.cycles, x.energy_uj) == (y.spikes, y.cycles, y.energy_uj),
              f"{what}: stream {rid} spikes/cycles/energy "
              f"{(x.spikes, x.cycles, x.energy_uj)} != {(y.spikes, y.cycles, y.energy_uj)}")


def _flow_restore_child(torch, argv) -> int:
    """``chip_smoke.py --flow-restore-child SNAP OUT DEVICE``: in a fresh
    process, ``StreamWorker.restore`` the snapshot on ``DEVICE`` and serve
    to the end; the readouts go to ``OUT`` (.npz), the rest to stdout as
    JSON."""
    import numpy as np

    from repro_torch.serving import StreamRequest, StreamWorker

    snap, out, device = argv
    _, _, events = _stream_inputs(torch, "optical-flow")
    reqs = {rid: StreamRequest(rid=rid, events=events[:, rid])
            for rid in range(events.shape[1])}
    t0 = time.perf_counter()
    worker = StreamWorker.restore(snap, reqs, device=device)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    resumed = worker.ticks
    while worker.step():
        pass
    np.savez(out, **{str(r.rid): r.readout for r in worker.done})
    print(json.dumps({"restore_s": restore_s, "resumed_at_tick": resumed,
                      "final_tick": worker.ticks,
                      "streams": {str(r.rid): [r.spikes, r.cycles, r.energy_uj]
                                  for r in worker.done}}), flush=True)
    return 0


def _restore_in_child(torch, dev, snap: str, ref: dict) -> dict:
    """Resume the flow snapshot in a child process; its results must be
    byte-identical with the uninterrupted run's ``ref``."""
    import tempfile

    import numpy as np

    with tempfile.TemporaryDirectory(prefix="spidr_restore_") as tmp:
        out = os.path.join(tmp, "readouts.npz")
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--flow-restore-child", snap, out, str(dev)],
                             capture_output=True, text=True, timeout=300)
        child_s = time.perf_counter() - t0
        check(res.returncode == 0, f"flow restore child exited {res.returncode}: "
              f"{res.stderr[-2000:]}")
        info = json.loads(res.stdout.strip().splitlines()[-1])
        with np.load(out) as readouts:
            got = {int(rid): readouts[rid] for rid in readouts.files}
    check(sorted(got) == sorted(ref), f"flow restore: streams {sorted(got)}")
    for rid, req in ref.items():
        check(got[rid].dtype == req.readout.dtype
              and got[rid].tobytes() == req.readout.tobytes(),
              f"flow restore: stream {rid} readout differs from the "
              "uninterrupted run")
        check(info["streams"][str(rid)] == [req.spikes, req.cycles, req.energy_uj],
              f"flow restore: stream {rid} spikes/cycles/energy "
              f"{info['streams'][str(rid)]} != "
              f"{[req.spikes, req.cycles, req.energy_uj]}")
    return {"restore_s": info["restore_s"], "child_s": child_s,
            "resumed_at_tick": info["resumed_at_tick"],
            "final_tick": info["final_tick"]}


def phase_streaming(torch, dev, kernels) -> list:
    """Serve every run of ``STREAM_RUNS`` through a StreamWorker at full
    width; flow runs also snapshot after tick 1 and migrate a live stream
    (``export_slot`` -> ``import_slot``) into a second session that serves
    it to the end beside the first.  Returns one record per run; the checks
    (whole-stream runs, backend="torch", the child restore) come after the
    launch counts are read."""
    import tempfile

    runs = []
    for net, t_block, chunk_T in STREAM_RUNS:
        spec, params, events = _stream_inputs(torch, net)
        compiled = _stream_compile(dev, net, spec, params, "fused", t_block, chunk_T)
        rec = {"net": net, "t_block": t_block, "chunk_T": chunk_T,
               "capacity": compiled.target.stream_capacity,
               "streams": events.shape[1], "hw": list(spec.input_hw),
               "T": spec.timesteps, "compiled": compiled, "events": events,
               "spec": spec, "params": params}
        migration = {}
        snap = None
        if net == "optical-flow":
            snap = tempfile.mkdtemp(prefix="spidr_flow_snap_")

            def on_tick(worker, migration=migration):
                if worker.ticks == 1:
                    t0 = time.perf_counter()
                    worker.save_snapshot()
                    migration["snapshot_s"] = time.perf_counter() - t0
                    slot = max(worker.slots)
                    req = worker.slots[slot]
                    twin = compiled.open_stream()
                    migration.update(
                        rid=req.rid, twin=twin, cursor=req.cursor,
                        slot=twin.import_slot(worker.sessions.export_slot(slot)))
                elif "twin" in migration and migration["cursor"] < spec.timesteps:
                    lo = migration["cursor"]
                    chunk = events[lo:lo + chunk_T, migration["rid"]]
                    migration["last"] = migration["twin"].step(
                        {migration["slot"]: chunk})[migration["slot"]]
                    migration["cursor"] += chunk.shape[0]
        else:
            on_tick = None
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        worker, tick_ms, launches = _serve_streams(
            kernels, compiled, events, snapshot_dir=snap, on_tick=on_tick)
        torch.cuda.synchronize(dev)
        rec.update(serve_s=time.perf_counter() - t0, worker=worker,
                   tick_ms=tick_ms, launches=launches, snap=snap,
                   migration=migration)
        runs.append(rec)
    return runs


def _tick_events(run):
    """One tick's packed ``(chunk_T, capacity, H, W, C)`` int8 events: the
    first chunk of the first ``capacity`` streams."""
    import numpy as np

    cap, ct = run["capacity"], run["chunk_T"]
    return np.ascontiguousarray(run["events"][:ct, :cap]).astype(np.int8)


def check_streaming(torch, dev, kernels, runs) -> None:
    """Every run: each stream equal to a whole-stream ``CompiledSNN.run`` +
    ``cost`` of that stream alone (readout, spikes, cycles; energy, which
    the session sums chunk by chunk, within 1e-12 relative) and byte-equal
    to the same serving on backend="torch"; B1/B2 launches equal to the
    whole-stream batches' and to ticks x layers x (timesteps or slabs) per
    tick.  Flow runs: the snapshot resumed in a child process and the
    migrated stream, byte-identical.  Then the times, and the drill."""
    from repro_torch.engine import init_state, run_chunk

    for run in runs:
        net, t_block, chunk_T = run["net"], run["t_block"], run["chunk_T"]
        compiled, events, worker = run["compiled"], run["events"], run["worker"]
        what = f"streaming {net} t_block={t_block} chunk_T={chunk_T}"
        t0 = time.perf_counter()
        done = {r.rid: r for r in worker.done}
        check(len(done) == run["streams"] and not worker.slots,
              f"{what}: {len(done)} of {run['streams']} streams served")
        max_rel = 0.0
        for rid, req in done.items():
            out = compiled.run(torch.from_numpy(events[:, rid:rid + 1]))
            cost = compiled.cost(out)
            want = out.readout[0].cpu().numpy()
            check(req.readout.shape == want.shape
                  and req.readout.tobytes() == want.tobytes(),
                  f"{what}: stream {rid} readout differs from the whole-stream run")
            check(req.spikes == int(out.spike_counts.sum()),
                  f"{what}: stream {rid} spikes {req.spikes} != whole-stream "
                  f"{int(out.spike_counts.sum())}")
            check(req.cycles == cost.makespan_cycles,
                  f"{what}: stream {rid} cycles {req.cycles} != whole-stream "
                  f"{cost.makespan_cycles}")
            rel = abs(req.energy_uj - cost.energy_uj) / cost.energy_uj
            max_rel = max(max_rel, rel)
            check(rel <= 1e-12, f"{what}: stream {rid} energy {req.energy_uj} vs "
                  f"whole-stream {cost.energy_uj}")
        plain = _stream_compile(dev, net, run["spec"], run["params"], "torch",
                                t_block, chunk_T)
        plain_worker, _, _ = _serve_streams(kernels, plain, events)
        _same_streams(done, {r.rid: r for r in plain_worker.done},
                      f"{what} vs backend='torch'")
        # Launches: the whole-stream batches of `capacity` streams.
        cap = run["capacity"]
        before = dict(kernels.LAUNCHES)
        for b0 in range(0, run["streams"], cap):
            compiled.run(torch.from_numpy(events[:, b0:b0 + cap]))
        batch_launches = {k: kernels.LAUNCHES[k] - before[k] for k in INT_KERNELS}
        layers = sum(1 for el in compiled.engine.layers if el.kind in ("conv", "fc"))
        per_tick = chunk_T if t_block == 1 else -(-chunk_T // t_block)
        kernel = INT_KERNELS[0] if t_block == 1 else INT_KERNELS[1]
        expect = {k: 0 for k in INT_KERNELS}
        expect[kernel] = worker.ticks * layers * per_tick
        check(run["launches"] == batch_launches == expect,
              f"{what}: launches {run['launches']}, whole-stream batches "
              f"{batch_launches}, expected {expect}")
        record = {"phase": "streaming", "net": net, "t_block": t_block,
                  "chunk_T": chunk_T, "capacity": cap, "streams": run["streams"],
                  "hw": run["hw"], "T": run["T"], "ticks": worker.ticks,
                  "weight_layers": layers, "launches": run["launches"],
                  "whole_stream_batch_launches": batch_launches,
                  "serve_s": run["serve_s"],
                  "host_ms_per_tick_median": statistics.median(run["tick_ms"]),
                  "host_ms_per_tick": run["tick_ms"],
                  "energy_max_rel_diff_vs_whole_stream": max_rel,
                  "bit_exact_vs_whole_stream": True, "bit_exact_vs_torch": True}
        if net == "optical-flow":
            mig = run["migration"]
            check(mig.get("cursor") == run["T"] and "last" in mig,
                  f"{what}: the migrated stream did not run to its end")
            last, req = mig["last"], done[mig["rid"]]
            check(last.readout.tobytes() == req.readout.tobytes()
                  and (last.spikes, last.cycles, last.energy_uj)
                  == (req.spikes, req.cycles, req.energy_uj),
                  f"{what}: the migrated stream {mig['rid']} differs from the "
                  "never-migrated one")
            try:
                record.update(
                    snapshot_write_s=mig["snapshot_s"], migrated_stream=mig["rid"],
                    migration_bit_exact=True,
                    snapshot_bytes=sum(os.path.getsize(os.path.join(d, f))
                                       for d, _, fs in os.walk(run["snap"])
                                       for f in fs),
                    child_restore=_restore_in_child(torch, dev, run["snap"], done))
            finally:
                shutil.rmtree(run["snap"], ignore_errors=True)
        # Device time of one tick (CUDA events around run_chunk at the
        # tick's shapes) and the per-tick rewind mark's state_dict.
        ev = torch.from_numpy(_tick_events(run)).to(dev)
        state = init_state(compiled.engine, cap)
        record["device_ms_per_tick"] = _time_ms(torch, lambda: run_chunk(
            compiled.engine, state, ev, collect_counts=True,
            collect_readouts=True), 5)
        sd_ms = []
        for _ in range(5):
            t1 = time.perf_counter()
            sd = worker.sessions.state_dict()
            sd_ms.append(1e3 * (time.perf_counter() - t1))
        record.update(state_dict_ms_median=statistics.median(sd_ms),
                      state_dict_ms=sd_ms, state_dict_mb=_tree_bytes(sd) / 1e6,
                      check_s=time.perf_counter() - t0)
        emit(record)
        del run["worker"], run["compiled"], plain, plain_worker, state, ev
    emit(_drill(torch))


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return 0 if tree is None else int(getattr(tree, "nbytes", 0))


def _drill(torch) -> dict:
    """``tools/upgrade_drill_torch.py`` on gesture at full width, 4 cores,
    fused, on the card: SIGKILL mid-tick, restore, compare."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="spidr_drill_report_") as tmp:
        out = os.path.join(tmp, "drill.json")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools", "upgrade_drill_torch.py"),
             "--full", "--task", "gesture", "--n-cores", "4", "--backend", "fused",
             "--out", out], capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        check(res.returncode == 0, f"drill exited {res.returncode}: "
              f"{res.stdout[-1500:]} {res.stderr[-1500:]}")
        with open(out) as f:
            report = json.load(f)
    check(report["ok"] and len(report["configs"]) == 1, "drill: not ok")
    cfg = report["configs"][0]
    return {"phase": "streaming_drill", "seconds": seconds,
            **{k: cfg[k] for k in ("task", "n_cores", "backend", "device", "hw",
                                   "timesteps", "capacity", "chunk_T",
                                   "n_streams", "ticks", "die_at_tick",
                                   "resumed_at_tick", "serve_returncode",
                                   "reference_s", "serve_child_s",
                                   "restore_child_s", "restore_s")},
            "streams_bit_exact": cfg["streams"], "lost_streams": cfg["lost_streams"]}


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


# ---------------------------------------------------------------------------
# 6. the optical-flow walk at full width: 1 core against 4-core plans
# ---------------------------------------------------------------------------
INT_KERNELS = ("fused_lif_gemm_int", "fused_lif_gemm_int_tblk")


def phase_optical_flow(torch, dev):
    from repro_torch.launch import optical_flow

    t0 = time.perf_counter()
    out = optical_flow.run(dev, log=lambda msg: print(msg, file=sys.stderr, flush=True))
    seconds = time.perf_counter() - t0
    ff = out["float_forward"]
    h, w = optical_flow.FULL["hw"]
    check(ff["finite"] and ff["readout_shape"] == [2, h, w, 2],
          "optical_flow: the float readout is not finite (2, 288, 384, 2)")
    check(ff["launches"].get("fused_lif_gemm", 0) == 8 * out["T"],
          f"optical_flow: the float forward made {ff['launches']} launches, "
          "not one B3 launch per layer-timestep")
    rows = out["deployments"]
    check(len(rows) == 12, f"optical_flow: {len(rows)} deployments, not 12")
    one_core = {(r["deployment"], r["weight_bits"], r["t_block"]): r
                for r in rows if r["n_cores"] == 1}
    for r in rows:
        what = (f"optical_flow {r['deployment']} {r['weight_bits']}-bit "
                f"{r['n_cores']} core(s) t_block={r['t_block']}")
        check(r["bit_exact_vs_1core"], f"{what}: differs from 1 core")
        check(r["bit_exact_vs_torch"], f"{what}: differs from backend='torch'")
        int_launches = {k: r["launches"].get(k, 0) for k in INT_KERNELS}
        check(sum(int_launches.values()) > 0, f"{what}: launched no B1/B2")
        base = one_core[(r["deployment"], r["weight_bits"], r["t_block"])]
        check(r["launches"] == base["launches"],
              f"{what}: launches {r['launches']} differ from 1 core's "
              f"{base['launches']}")
    splits = {(r["deployment"], r["weight_bits"]): r["split_layers"]
              for r in rows if r["n_cores"] == 4}
    check(splits[("per-tensor", 8)] == 7 and splits[("per-tensor", 4)] == 0
          and splits[("exported", 8)] == 7,
          f"optical_flow: channel-split layers {splits}, expected 7 at 8-bit, 0 at 4-bit")
    emit({"phase": "optical_flow", "seconds": seconds, "hw": out["hw"], "T": out["T"],
          "batch": out["batch"], "input_sparsity": out["input_sparsity"],
          "float_forward": ff,
          "deployments": [{k: v for k, v in r.items() if k != "plan"} for r in rows],
          "plans": {f"{r['deployment']} {r['weight_bits']}-bit": r["plan"]
                    for r in rows if r["n_cores"] == 4 and r["t_block"] == 1},
          "pipeline": out["pipeline"], "bit_exact": True,
          "launches_equal_1core": True})
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


def check_optical_flow(torch, dev, walk) -> None:
    """The walk's float forward against the plain float path on the same
    params and events: layer by layer (every spike flip within 1e-5 of the
    threshold), as the quickstart's is checked, then free-running.  The
    flow readout is the last layer's Vmem, a float: where no spike count
    differs it must agree within T times the per-step tolerance (the
    layer's Vmem carries one step's rounding per timestep)."""
    from repro_torch.core.network import run_snn
    from repro_torch.core.quant import QuantSpec
    from repro_torch.kernels.ref import FLOAT_TOL
    from repro_torch.launch import optical_flow

    t0 = time.perf_counter()
    spec, params, events, flow_gt = optical_flow.inputs(dev)
    params = [None if p is None else p.to(dev) for p in params]
    with torch.no_grad():
        pred, counts = run_snn(params, events, spec, QuantSpec(4), record_spikes=True)
        pred_p, counts_p = run_snn(params, events, spec, QuantSpec(4),
                                   record_spikes=True, matmul=torch.matmul)
        lock = _lockstep_forward(torch, params, events, spec, QuantSpec(4))
    aee = float(torch.linalg.vector_norm(pred - flow_gt, dim=-1).mean())
    counts_equal = bool(torch.equal(counts_p, counts))
    tol = FLOAT_TOL * spec.timesteps
    err = (pred - pred_p).abs()
    readout_close = bool((err <= tol + tol * pred_p.abs()).all())
    emit({"phase": "optical_flow_check", "float_forward_spike_counts_equal": counts_equal,
          "float_forward_readout_max_abs_diff": float(err.max()),
          "readout_tolerance": tol, "readout_close": readout_close,
          "plain_aee": float(torch.linalg.vector_norm(pred_p - flow_gt, dim=-1).mean()),
          "aee": aee, "float_forward_layer_by_layer": lock,
          "seconds": round(time.perf_counter() - t0, 3)})
    check(aee == walk["float_forward"]["aee"],
          f"optical_flow: the float forward on the walk's inputs gives AEE {aee}, "
          f"the walk {walk['float_forward']['aee']}")
    check(lock["ok"], f"optical_flow float forward: fused kernel vs plain {lock}")
    check((counts_equal and readout_close) or lock["spikes_flipped"] > 0,
          "optical_flow float forward differs from the plain path with no "
          "near-threshold spike flip to explain it")


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
               # What the ring skips: 64-row tiles whose flags are all zero.
               "empty_row_tile_share": 1.0 - float(
                   bitmap.any(dim=1).to(torch.float32).mean()),
               "graph_ms": {("dense" if not skip else mode):
                            _graph_ms(torch, lambda: spike_gemm(
                                s, w, skip_empty=skip, skip_mode=mode))
                            for skip, mode in SKIPS}}
        dvs.append(row)
        emit({"phase": "dvs_tile_skip", **row})
    results["spike_gemm"]["dvs"] = dvs


# ---------------------------------------------------------------------------
# 6b. the serving fleet at full width: spidr.serve over two replicas
# ---------------------------------------------------------------------------
FLEET_STREAMS = {"gesture": 12, "optical-flow": 5}
# Launches of B1 (t_block 1) or B2 per replica tick: weight layers x
# (timesteps or slabs) per chunk.
GESTURE_FLEET = {"n_replicas": 2, "capacity": 4, "chunk_T": 2}
FLOW_FLEET = {"n_replicas": 2, "capacity": 2, "chunk_T": 5}


def _fleet_inputs(torch, net):
    """The net's spec, random params (seed 0) and ``(T, N, H, W, 2)`` events
    of ``FLEET_STREAMS[net]`` streams (seed ``STREAM_SEED``)."""
    from repro_torch.configs import spidr_gesture, spidr_optflow
    from repro_torch.core.network import init_params
    from repro_torch.snn.data import make_flow_batch, make_gesture_batch

    spec = (spidr_gesture if net == "gesture" else spidr_optflow).CONFIG
    make = make_gesture_batch if net == "gesture" else make_flow_batch
    events, _ = make(torch.Generator().manual_seed(STREAM_SEED),
                     batch=FLEET_STREAMS[net], timesteps=spec.timesteps,
                     hw=spec.input_hw, device="cpu")
    return spec, init_params(torch.Generator().manual_seed(0), spec), events.numpy()


def _fleet_compile(dev, spec, params, backend, t_block, chunk_T, capacity):
    from repro_torch import spidr

    return spidr.compile(spec, params, spidr.DeployTarget(
        weight_bits=4, backend=backend, t_block=t_block, chunk_T=chunk_T,
        stream_capacity=capacity), device=dev)


def _drive_fleet(compiled, events, cfg: dict, hooks=None) -> dict:
    """Submit every stream in rid order to ``spidr.serve(compiled, **cfg)``
    and step the sync fleet to the end; ``hooks[tick](fleet)`` runs after
    fleet tick ``tick``.  Returns the shut-down fleet, its handles and the
    host ms of each fleet tick (each ends in the ticks' copies to the
    host, which wait for the card)."""
    from repro_torch import spidr

    fleet = spidr.serve(compiled, **cfg)
    handles = {rid: fleet.submit(events[:, rid], rid=rid)
               for rid in range(events.shape[1])}
    tick_ms = []
    t0 = time.perf_counter()
    while True:
        t1 = time.perf_counter()
        alive = fleet.step()
        tick_ms.append(1e3 * (time.perf_counter() - t1))
        if not alive:
            break
        hook = (hooks or {}).get(fleet.ticks)
        if hook is not None:
            hook(fleet)
    seconds = time.perf_counter() - t0
    fleet.shutdown()
    return {"fleet": fleet, "handles": handles, "tick_ms": tick_ms[:-1],
            "seconds": seconds}


def _migrate_once(fleet):
    """The default migration: the lowest slot of the most-loaded replica to
    the least-loaded one with a free slot."""
    fleet.migrate()


def _gesture_fleet_runs(compiled):
    """(name, ServeConfig overrides, hooks) of the gesture sync runs: 12
    streams over 2 x 4 slots.  The first wave of 8 ends at fleet tick 10,
    tick 11 places the last 4 (2 + 2); ``migrate`` runs after tick 12,
    which leaves 1 + 3, and ``migrate_every=3`` moves one back at tick 15;
    ``kill`` kills replica 1 after tick 3, whose 4 streams replay on
    replica 0."""
    return (("migrate", {}, {12: _migrate_once}),
            ("migrate_every", {"migrate_every": 3}, {12: _migrate_once}),
            ("kill", {}, {3: lambda fleet: fleet.kill_replica(1)}))


def phase_fleet(torch, dev, kernels) -> dict:
    """Drive the fleet's runs (the checks come after the launch counts are
    read): gesture sync (an explicit migration, ``migrate_every=3``, a
    killed replica), gesture threaded (each replica on its own CUDA
    stream), optical flow sync (one migration), a batch fleet, and the
    CLI's ``--replicas 2``.  Each run records its B1/B2 launches."""
    from repro_torch.launch import serve as launch_serve

    out = {"runs": []}

    def counted(fn):
        before = dict(kernels.LAUNCHES)
        res = fn()
        res["launches"] = {k: kernels.LAUNCHES[k] - before[k] for k in INT_KERNELS}
        return res

    spec, params, events = _fleet_inputs(torch, "gesture")
    gesture = _fleet_compile(dev, spec, params, "fused", 1, 2, 4)
    out["gesture"] = {"spec": spec, "params": params, "events": events,
                      "compiled": gesture}
    torch.cuda.synchronize(dev)
    for name, extra, hooks in _gesture_fleet_runs(gesture):
        run = counted(lambda: _drive_fleet(gesture, events, dict(GESTURE_FLEET, **extra),
                                           hooks))
        run.update(net="gesture", name=name, mode="sync", t_block=1, chunk_T=2)
        out["runs"].append(run)

    def threaded():
        from repro_torch import spidr

        fleet = spidr.serve(gesture, mode="threaded", **GESTURE_FLEET)
        t0 = time.perf_counter()
        handles = {rid: fleet.submit(events[:, rid], rid=rid)
                   for rid in range(events.shape[1])}
        fleet.drain(timeout=600)
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        fleet.shutdown()
        return {"fleet": fleet, "handles": handles, "seconds": seconds,
                "tick_ms": []}

    run = counted(threaded)
    run.update(net="gesture", name="threaded", mode="threaded", t_block=1, chunk_T=2)
    out["runs"].append(run)

    def batch():
        from repro_torch import spidr

        fleet = spidr.serve(gesture, n_replicas=2, capacity=4, batch=True)
        t0 = time.perf_counter()
        handles = {rid: fleet.submit(events[:, rid], rid=rid)
                   for rid in range(events.shape[1])}
        fleet.drain()
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        fleet.shutdown()
        return {"fleet": fleet, "handles": handles, "seconds": seconds, "tick_ms": []}

    run = counted(batch)
    run.update(net="gesture", name="batch", mode="sync", t_block=1, chunk_T=None)
    out["runs"].append(run)

    fspec, fparams, fevents = _fleet_inputs(torch, "optical-flow")
    flow = _fleet_compile(dev, fspec, fparams, "fused", 5, 5, 2)
    out["optical-flow"] = {"spec": fspec, "params": fparams, "events": fevents,
                           "compiled": flow}
    # Streams 0-3 fill 2 x 2 slots for ticks 1-2; tick 3 places stream 4 on
    # replica 0, and the migration moves it, mid-stream, to replica 1.
    run = counted(lambda: _drive_fleet(flow, fevents, FLOW_FLEET, {3: _migrate_once}))
    run.update(net="optical-flow", name="migrate", mode="sync", t_block=5, chunk_T=5)
    out["runs"].append(run)

    argv = ["--snn", "gesture", "--streaming", "--replicas", "2"]

    def cli():
        t0 = time.perf_counter()
        fleet = launch_serve.serve_snn(launch_serve.parse_args(argv))
        return {"fleet": fleet, "handles": None, "seconds": time.perf_counter() - t0,
                "tick_ms": []}

    run = counted(cli)
    run.update(net="gesture", name="cli", mode="sync", t_block=1, chunk_T=2, argv=argv)
    out["runs"].append(run)
    return out


def _hold_stream(h, want_readout, cost, what) -> float:
    """One handle against its stream's whole-stream run + cost; returns the
    energy's relative difference (the session sums it chunk by chunk)."""
    check(h.done and h.readout.shape == want_readout.shape
          and h.readout.tobytes() == want_readout.tobytes(),
          f"{what}: stream {h.rid} readout differs from the whole-stream run")
    check(h.cycles == cost.makespan_cycles,
          f"{what}: stream {h.rid} cycles {h.cycles} != whole-stream "
          f"{cost.makespan_cycles}")
    rel = abs(h.energy_uj - cost.energy_uj) / cost.energy_uj
    check(rel <= 1e-12, f"{what}: stream {h.rid} energy {h.energy_uj} vs "
          f"whole-stream {cost.energy_uj}")
    return rel


def _handle_results(handles) -> dict:
    return {rid: (h.readout.tobytes(), h.cycles, h.energy_uj, list(h.placements))
            for rid, h in handles.items()}


def check_fleet(torch, dev, fleet_runs) -> None:
    """Every stream of every run bit-exact with its whole-stream ``run`` +
    ``cost`` and with a ``backend="torch"`` fleet in the same scenario
    (placements included: two sync fleets fed the same arrival order place
    identically); B1/B2 launches equal to what the replicas' ticks
    predict; the threaded replicas on two distinct non-default streams."""
    from repro_torch.snn.data import make_gesture_batch

    whole = {}
    for net in ("gesture", "optical-flow"):
        d = fleet_runs[net]
        compiled, events = d["compiled"], d["events"]
        whole[net] = []
        for rid in range(events.shape[1]):
            out = compiled.run(torch.from_numpy(events[:, rid:rid + 1]))
            whole[net].append((out.readout[0].cpu().numpy(), compiled.cost(out)))
    layers = {net: sum(1 for el in fleet_runs[net]["compiled"].engine.layers
                       if el.kind in ("conv", "fc")) for net in whole}
    torch_fleets = {}
    for run in fleet_runs["runs"]:
        net, name, fleet = run["net"], run["name"], run["fleet"]
        what = f"fleet {net} {name}"
        d = fleet_runs[net]
        T = d["spec"].timesteps
        workers = fleet.workers
        if name == "batch":
            expect = sum(w.batches for w in workers) * T * layers[net]
            kernel = INT_KERNELS[0]
        else:
            per_tick = (run["chunk_T"] if run["t_block"] == 1
                        else -(-run["chunk_T"] // run["t_block"]))
            expect = sum(w.ticks for w in workers) * layers[net] * per_tick
            kernel = INT_KERNELS[0] if run["t_block"] == 1 else INT_KERNELS[1]
        want = {k: (expect if k == kernel else 0) for k in INT_KERNELS}
        check(run["launches"] == want,
              f"{what}: launches {run['launches']}, the replicas' ticks predict {want}")
        rec = {"phase": "fleet", "net": net, "run": name, "mode": run["mode"],
               "replicas": fleet.n_replicas, "t_block": run["t_block"],
               "chunk_T": run["chunk_T"], "hw": list(d["spec"].input_hw), "T": T,
               "streams": len(fleet.done), "fleet_ticks": fleet.ticks,
               "replica_ticks": [getattr(w, "ticks", getattr(w, "batches", 0))
                                 for w in workers],
               "migrations": fleet.migrations, "crashes": fleet.crashes,
               "launches": run["launches"], "serve_s": run["seconds"],
               "streams_per_s": len(fleet.done) / run["seconds"]}
        if run["tick_ms"]:
            rec.update(host_ms_per_fleet_tick_median=statistics.median(run["tick_ms"]),
                       host_ms_per_fleet_tick=run["tick_ms"])
        if name == "cli":
            ev, _ = make_gesture_batch(torch.Generator().manual_seed(1),
                                       batch=len(fleet.done), timesteps=T,
                                       hw=d["spec"].input_hw, device="cpu")
            out = d["compiled"].run(ev)
            got = {r.rid: r for r in fleet.done}
            check(sorted(got) == list(range(ev.shape[1])) and fleet.n_replicas == 2
                  and all(w.done for w in workers),
                  f"{what}: {len(got)} streams over {fleet.n_replicas} replicas")
            for rid, r in got.items():
                check(r.readout.tobytes() == out.readout[rid].cpu().numpy().tobytes(),
                      f"{what}: stream {rid} readout differs from the whole-stream run")
            rec.update(argv=run["argv"], bit_exact_vs_whole_stream=True)
            emit(rec)
            continue
        handles = run["handles"]
        check(len(handles) == FLEET_STREAMS[net] and all(h.done for h in handles.values()),
              f"{what}: {sum(h.done for h in handles.values())} of "
              f"{FLEET_STREAMS[net]} streams done")
        max_rel = 0.0
        for rid, h in handles.items():
            readout, cost = whole[net][rid]
            if name == "batch":
                check(h.readout.tobytes() == readout.tobytes(),
                      f"{what}: stream {rid} readout differs from the whole-stream run")
            else:
                max_rel = max(max_rel, _hold_stream(h, readout, cost, what))
        if name == "migrate" or name == "migrate_every":
            check(fleet.migrations == (1 if name == "migrate" else 2),
                  f"{what}: {fleet.migrations} migrations")
        if name == "kill":
            check(fleet.crashes == 1 and all(h.placements[-1][0] == 0
                                              for h in handles.values()),
                  f"{what}: streams after the crash not all on replica 0")
        if name == "threaded":
            s0, s1 = fleet.tick_streams[0], fleet.tick_streams[1]
            default = torch.cuda.default_stream(dev).cuda_stream
            check(s0 == {fleet.replica_streams[0].cuda_stream}
                  and s1 == {fleet.replica_streams[1].cuda_stream}
                  and default not in s0 | s1 and not s0 & s1,
                  f"{what}: replica streams {s0}, {s1}, default {default}")
            rec["replica_streams_distinct"] = True
            rec["wall_ms_per_replica_tick"] = (1e3 * run["seconds"]
                                               / max(w.ticks for w in workers))
        if run["mode"] == "sync" and name != "batch":
            # The same scenario on backend="torch": results and placements.
            key = (net, name)
            plain = _fleet_compile(dev, d["spec"], d["params"], "torch",
                                   run["t_block"], run["chunk_T"],
                                   d["compiled"].target.stream_capacity)
            cfg = dict(GESTURE_FLEET if net == "gesture" else FLOW_FLEET)
            hooks = {3: _migrate_once} if net == "optical-flow" else None
            if net == "gesture":
                for n, extra, hk in _gesture_fleet_runs(plain):
                    if n == name:
                        cfg.update(extra)
                        hooks = hk
            torch_fleets[key] = _drive_fleet(plain, d["events"], cfg, hooks)
            check(_handle_results(torch_fleets[key]["handles"]) == _handle_results(handles),
                  f"{what}: results or placements differ from the backend='torch' fleet")
            rec["bit_exact_vs_torch_fleet"] = rec["placements_equal_torch_fleet"] = True
            del plain
        rec.update(energy_max_rel_diff_vs_whole_stream=max_rel,
                   bit_exact_vs_whole_stream=True,
                   placements={rid: h.placements for rid, h in handles.items()}
                   if net == "optical-flow" or name == "migrate" else None)
        emit(rec)


# ---------------------------------------------------------------------------
# 6c. the autotuner at full width, with the roofline bound
# ---------------------------------------------------------------------------
AUTOTUNE_BATCH = {"gesture": 4, "optical-flow": 2}


def phase_autotune(torch, dev, kernels) -> dict:
    """``spidr.compile(..., DeployTarget(autotune=True))`` on gesture and
    flow at full width: the sweep (B2 at each weight layer's shape, CUDA
    events), the cache written to a temporary ``SPIDR_AUTOTUNE_CACHE``,
    cleared in memory and compiled again (no sweep launches), and the
    autotuned deployment's run.  The comparisons come after the launch
    counts are read."""
    import tempfile

    from repro_torch import spidr
    from repro_torch.kernels import autotune
    from repro_torch.snn.data import make_flow_batch, make_gesture_batch

    out = {}
    tmp = tempfile.mkdtemp(prefix="spidr_autotune_")
    prev = os.environ.get(autotune.CACHE_ENV)
    os.environ[autotune.CACHE_ENV] = os.path.join(tmp, "cache.json")
    try:
        for net in ("gesture", "optical-flow"):
            spec, params, _ = _fleet_inputs(torch, net)
            make = make_gesture_batch if net == "gesture" else make_flow_batch
            events, _ = make(torch.Generator().manual_seed(2), batch=AUTOTUNE_BATCH[net],
                             timesteps=spec.timesteps, hw=spec.input_hw, device=dev)
            autotune.clear_cache()
            before = dict(kernels.LAUNCHES)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            tuned = spidr.compile(spec, params, spidr.DeployTarget(autotune=True),
                                  device=dev)
            torch.cuda.synchronize(dev)
            sweep_s = time.perf_counter() - t0
            sweep = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
            timings = autotune.sweep_timings()
            autotune.clear_cache()
            before = dict(kernels.LAUNCHES)
            t0 = time.perf_counter()
            again = spidr.compile(spec, params, spidr.DeployTarget(autotune=True),
                                  device=dev)
            reload_s = time.perf_counter() - t0
            reload = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
            result = tuned.run(events)
            torch.cuda.synchronize(dev)
            out[net] = {"spec": spec, "params": params, "events": events,
                        "tuned": tuned, "again": again, "result": result,
                        "sweep_launches": sweep, "sweep_s": sweep_s,
                        "timings": timings, "reload_launches": reload,
                        "reload_s": reload_s}
    finally:
        if prev is None:
            os.environ.pop(autotune.CACHE_ENV, None)
        else:
            os.environ[autotune.CACHE_ENV] = prev
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def check_autotune(torch, dev, tuned_runs) -> None:
    """The sweep made only B2 launches, the reloaded cache none and the same
    configs; the autotuned run bit-exact with ``backend="torch"`` and with
    the untuned deployment; its device ms per batch beside
    ``CompiledSNN.roofline``'s bound."""
    from repro_torch import spidr
    from repro_torch.kernels import autotune

    for net, d in tuned_runs.items():
        what = f"autotune {net}"
        tuned, spec, params, events = d["tuned"], d["spec"], d["params"], d["events"]
        kcfgs = [el.kcfg for el in tuned.engine.layers if el.kind in ("conv", "fc")]
        again = [el.kcfg for el in d["again"].engine.layers if el.kind in ("conv", "fc")]
        check(all(k is not None for k in kcfgs) and kcfgs == again,
              f"{what}: configs {kcfgs}, after the cache reload {again}")
        check(d["sweep_launches"]["fused_lif_gemm_int_tblk"] > 0
              and sum(d["sweep_launches"].values())
              == d["sweep_launches"]["fused_lif_gemm_int_tblk"],
              f"{what}: the sweep made {d['sweep_launches']}")
        check(not any(d["reload_launches"].values()),
              f"{what}: the reloaded cache launched {d['reload_launches']}")
        # Each distinct layer shape raced once: warm-up + one timed run of
        # each candidate's slabs.
        T = min(spec.timesteps, 8)
        shapes = spec.layer_shapes()
        keys = {autotune.cache_key(sh.out_positions if sh.kind == "conv" else 1,
                                   sh.fan_in, sh.out_channels, 4, 7) for sh in shapes}
        slabs = sum(-(-T // tb) for tb in sorted({1, 2, min(4, T), T}))
        check(d["sweep_launches"]["fused_lif_gemm_int_tblk"] == 2 * slabs * len(keys)
              and set(d["timings"]) == keys,
              f"{what}: {d['sweep_launches']} sweep launches for {len(keys)} shapes")
        result = d["result"]
        plain = spidr.compile(spec, params, spidr.DeployTarget(backend="torch"), device=dev)
        untuned = spidr.compile(spec, params, spidr.DeployTarget(), device=dev)
        for other, who in ((plain, "backend='torch'"), (untuned, "the untuned run")):
            o = other.run(events)
            for f in ("readout", "spike_counts", "input_counts"):
                check(torch.equal(getattr(result, f), getattr(o, f)),
                      f"{what}: {f} differ from {who}")
        batch = events.shape[1]
        tuned_ms = _time_ms(torch, lambda: tuned.run(events), 5)
        untuned_ms = _time_ms(torch, lambda: untuned.run(events), 5)
        roof = tuned.roofline(batch=batch)
        layers = []
        for sh, k, lb in zip(shapes, kcfgs, roof["layers"]):
            key = autotune.cache_key(sh.out_positions if sh.kind == "conv" else 1,
                                     sh.fan_in, sh.out_channels, 4, 7)
            layers.append({"kind": sh.kind, "rows": lb.rows, "fan_in": sh.fan_in,
                           "channels": sh.out_channels, "t_block": k[3],
                           "candidates_ms": {str(tb): 1e3 * s for tb, s in
                                             sorted(d["timings"][key].items())},
                           "bound_us": lb.bound_s * 1e6, "bottleneck": lb.bottleneck})
        emit({"phase": "autotune", "net": net, "hw": list(spec.input_hw),
              "T": spec.timesteps, "batch": batch, "sweep_timesteps": T,
              "layers": layers, "sweep_launches": d["sweep_launches"],
              "sweep_s": d["sweep_s"], "reload_launches": d["reload_launches"],
              "reload_s": d["reload_s"], "bit_exact_vs_torch": True,
              "bit_exact_vs_untuned": True,
              # CUDA events around eager runs: device time plus any host gap.
              "event_ms_per_batch": tuned_ms, "untuned_event_ms_per_batch": untuned_ms,
              "roofline_bound_us": roof["bound_us"],
              "event_ms_over_bound": tuned_ms * 1e3 / roof["bound_us"]})
        del plain, untuned


# ---------------------------------------------------------------------------
# 5c. training: deploy-exact QAT, export, deploy, the round trip (A10)
# ---------------------------------------------------------------------------
TRAIN_STEPS = 12            # gesture QAT steps on one fixed batch
FLOW_TRAIN = {"batch": 2, "steps": 3}
SWEEP_BITS, SWEEP_STEPS = (4, 6, 8), 2
VERIFY_BATCH = 2
# B1/B2/B3 launches each run must make (weight layers x timesteps or slabs
# per engine run; verify on a plan also runs the single-core engine).
GESTURE_LAYERS, FLOW_LAYERS = 6, 8


def _launch_delta(kernels, before: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in kernels.LAUNCHES.items()
            if n != before.get(k, 0)}


def _train_steps(torch, dev, state, batch, spec, cfg, steps: int) -> dict:
    """``steps`` train_steps on one batch: losses, synchronized host ms per
    step, peak memory (and what was allocated before the first step)."""
    from repro_torch.snn.train import train_step

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    allocated = torch.cuda.memory_allocated(dev)
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = train_step(state, batch, spec, cfg)
        losses.append(float(m["loss"]))  # synchronizes
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"state": state, "losses": losses, "ms_per_step": ms,
            "memory_allocated_before": allocated,
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}


def _roundtrip(torch, dev, kernels, exported, params, spec, events, **target) -> dict:
    """``CompiledSNN.verify(params=...)`` of an exported net: the report and
    the run's launches."""
    from repro_torch import spidr

    compiled = spidr.compile(exported, params, spidr.DeployTarget(
        weight_bits=exported.weight_bits, **target), spec=spec, device=dev)
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    report = compiled.verify(events)
    torch.cuda.synchronize(dev)
    rt = report.roundtrip
    return {**target, "weight_bits": exported.weight_bits, "exact": report.exact,
            "roundtrip_exact": rt is not None and rt.exact,
            "readout_mismatch": None if rt is None else rt.readout_mismatch,
            "spike_mismatch": None if rt is None else rt.spike_mismatch,
            "seconds": time.perf_counter() - t0,
            "launches": _launch_delta(kernels, before)}


def phase_train(torch, dev, kernels, card: str) -> dict:
    """Train -> export -> deploy at full width (ROADMAP A10).

    Gesture (64x64, T=20, batch 8): deploy-exact QAT on one fixed batch;
    the trained net exported, saved, ``spidr.load``ed and verified with its
    float params on 1 and 4 cores; ``precision_sweep`` at 4/6/8 bit, each
    export verified; ``launch.train --snn gesture`` in a child process;
    the QAT round trip with TF32 switched on.  Optical flow (288x384,
    T=10, batch 2): QAT steps, then the round trip at ``t_block`` 1 (B1)
    and 5 (B2).  One legacy ``mode="train"`` step through B3 under
    autograd.  Each run's launches are counted here; the B3 gradients are
    held against the plain path in ``check_train``."""
    import dataclasses
    import tempfile

    from repro_torch import spidr
    from repro_torch.configs import spidr_gesture, spidr_optflow
    from repro_torch.core.network import run_snn
    from repro_torch.core.quant import QuantSpec
    from repro_torch.snn import export
    from repro_torch.snn.train import (TrainConfig, init_train_state, make_batch_fn,
                                       precision_sweep)

    out = {"card": card}
    tmp = tempfile.mkdtemp(prefix="spidr_train_")
    try:
        # Gesture: QAT on a fixed batch, then export -> save -> load -> verify.
        spec = spidr_gesture.CONFIG
        cfg = TrainConfig(steps=TRAIN_STEPS)
        state = init_train_state(torch.Generator(device=dev).manual_seed(0), spec, cfg)
        batch = make_batch_fn(spec, cfg, device=dev)(torch.Generator().manual_seed(1))
        before = dict(kernels.LAUNCHES)
        run = _train_steps(torch, dev, state, batch, spec, cfg, TRAIN_STEPS)
        run["launches"] = _launch_delta(kernels, before)
        run.update(hw=list(spec.input_hw), T=spec.timesteps, batch=cfg.batch)
        params = run.pop("state").params
        exported = export.export_network(params, spec, QuantSpec(cfg.weight_bits))
        spidr.compile(exported, spec, spidr.DeployTarget(), device=dev).save(
            os.path.join(tmp, "gesture"), step=TRAIN_STEPS)
        events, _ = make_batch_fn(spec, cfg, batch=VERIFY_BATCH, device=dev)(
            torch.Generator().manual_seed(2))
        run["roundtrips"] = []
        for n_cores in (1, 4):
            loaded = spidr.load(os.path.join(tmp, "gesture"),
                                target=spidr.DeployTarget(n_cores=n_cores), device=dev)
            check(loaded.spec == spec, "train: the loaded spec is not the trained one")
            run["roundtrips"].append(_roundtrip(
                torch, dev, kernels, loaded.exported, params, spec, events,
                n_cores=n_cores))
        # TF32 switched on: the QAT product must not notice.
        with torch.no_grad():
            qat_off = run_snn(params, events, spec, QuantSpec(4), mode="qat",
                              record_spikes=True)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            with torch.no_grad():
                qat_on = run_snn(params, events, spec, QuantSpec(4), mode="qat",
                                 record_spikes=True)
            tf32 = _roundtrip(torch, dev, kernels, exported, params, spec, events)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        tf32["qat_forward_equal_to_tf32_off"] = all(
            torch.equal(a, b) for a, b in zip(qat_on, qat_off))
        run["tf32_on"] = tf32
        out["gesture"] = run

        # precision_sweep at full width, a few steps each.
        scfg = TrainConfig(steps=SWEEP_STEPS, warmup=1, eval_batch=8, eval_batches=1)
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        sweep = precision_sweep("gesture", bits=SWEEP_BITS, cfg=scfg,
                                generator=torch.Generator().manual_seed(3), device=dev)
        torch.cuda.synchronize(dev)
        out["sweep"] = {"seconds": time.perf_counter() - t0,
                        "launches": _launch_delta(kernels, before), "bits": {}}
        for b, r in sweep.items():
            out["sweep"]["bits"][b] = {
                "loss": r["history"]["loss"], "accuracy": r["metric"],
                **_roundtrip(torch, dev, kernels, r["exported"], r["state"].params,
                             spec, events)}
        del sweep

        # The train CLI in a child process: full width, 3 steps, 4 cores.
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--snn", "gesture",
             "--steps", "3", "--n-cores", "4", "--ckpt-dir", os.path.join(tmp, "cli")],
            capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": SRC})
        lines = proc.stdout.strip().splitlines()
        out["cli"] = {"rc": proc.returncode, "seconds": time.perf_counter() - t0,
                      "result": json.loads(lines[-1]) if proc.returncode == 0 and lines
                      else proc.stderr[-2000:]}

        # Optical flow at the full frame: QAT steps, the round trip on B1 and B2.
        fspec = spidr_optflow.CONFIG
        fcfg = TrainConfig(steps=FLOW_TRAIN["steps"], batch=FLOW_TRAIN["batch"])
        fstate = init_train_state(torch.Generator(device=dev).manual_seed(4), fspec, fcfg)
        fbatch = make_batch_fn(fspec, fcfg, device=dev)(torch.Generator().manual_seed(5))
        before = dict(kernels.LAUNCHES)
        frun = _train_steps(torch, dev, fstate, fbatch, fspec, fcfg, FLOW_TRAIN["steps"])
        frun["launches"] = _launch_delta(kernels, before)
        frun.update(hw=list(fspec.input_hw), T=fspec.timesteps, batch=fcfg.batch)
        fparams = frun.pop("state").params
        del fstate
        fexported = export.export_network(fparams, fspec, QuantSpec(fcfg.weight_bits))
        frun["roundtrips"] = [
            _roundtrip(torch, dev, kernels, fexported, fparams, fspec, fbatch[0],
                       t_block=t_block) for t_block in (1, 5)]
        out["flow"] = frun
        del fbatch

        # One legacy mode="train" step: every layer-timestep on B3 under autograd.
        lcfg = dataclasses.replace(cfg, mode="train")
        lstate = init_train_state(torch.Generator(device=dev).manual_seed(6), spec, lcfg)
        before = dict(kernels.LAUNCHES)
        lrun = _train_steps(torch, dev, lstate, batch, spec, lcfg, 1)
        lrun["launches"] = _launch_delta(kernels, before)
        lrun.update(hw=list(spec.input_hw), T=spec.timesteps, batch=lcfg.batch)
        lrun.pop("state")
        out["legacy"] = {**lrun, "params": lstate.params, "events": batch[0], "spec": spec}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()  # the flow steps' ~33 GB of saved tensors
    return out


def check_train(torch, dev, runs) -> None:
    """Every check of the train phase, after its launches were read: the
    losses, each round trip exact with the predicted launches, the CLI, the
    TF32 run; then B3's autograd against the plain path layer by layer."""
    card = runs["card"]
    g = runs["gesture"]
    check(all(math.isfinite(x) for x in g["losses"]) and g["losses"][-1] < g["losses"][0],
          f"train gesture: the loss did not drop on a fixed batch {g['losses']}")
    check(not g["launches"], f"train gesture: QAT training launched {g['launches']}")
    b1 = GESTURE_LAYERS * g["T"]
    for rt, want in zip(g["roundtrips"], (b1, 2 * b1)):
        check(rt["exact"] and rt["roundtrip_exact"],
              f"train gesture {rt['n_cores']} core(s): round trip {rt}")
        check(rt["launches"] == {"fused_lif_gemm_int": want},
              f"train gesture {rt['n_cores']} core(s): launches {rt['launches']}")
    tf = g["tf32_on"]
    check(tf["exact"] and tf["qat_forward_equal_to_tf32_off"]
          and tf["launches"] == {"fused_lif_gemm_int": b1},
          f"train gesture with TF32 on: {tf}")
    emit({"phase": "train_gesture", "card": card, **g})
    s = runs["sweep"]
    for b, r in s["bits"].items():
        check(r["exact"] and r["roundtrip_exact"] and all(
            math.isfinite(x) for x in r["loss"]),
              f"train sweep {b}-bit: {r}")
        check(r["launches"] == {"fused_lif_gemm_int": b1},
              f"train sweep {b}-bit: launches {r['launches']}")
    check(not s["launches"], f"train sweep: training launched {s['launches']}")
    emit({"phase": "train_sweep", "card": card, **s})
    c = runs["cli"]
    check(c["rc"] == 0 and isinstance(c["result"], dict),
          f"train CLI exited {c['rc']}: {c['result']}")
    check([r["n_cores"] for r in c["result"]["roundtrips"]] == [1, 4]
          and all(r["exact"] for r in c["result"]["roundtrips"])
          and c["result"]["launches"] == {"fused_lif_gemm_int": 3 * b1},
          f"train CLI: {c['result']}")
    emit({"phase": "train_cli", "card": card, **c})
    f = runs["flow"]
    check(all(math.isfinite(x) for x in f["losses"]),
          f"train flow: loss {f['losses']}")
    check(not f["launches"], f"train flow: QAT training launched {f['launches']}")
    want = ({"fused_lif_gemm_int": FLOW_LAYERS * f["T"]},
            {"fused_lif_gemm_int_tblk": FLOW_LAYERS * -(-f["T"] // 5)})
    for rt, w in zip(f["roundtrips"], want):
        check(rt["exact"] and rt["roundtrip_exact"],
              f"train flow t_block={rt['t_block']}: round trip {rt}")
        check(rt["launches"] == w,
              f"train flow t_block={rt['t_block']}: launches {rt['launches']}")
    emit({"phase": "train_flow", "card": card, **f})
    leg = runs["legacy"]
    check(leg["launches"] == {"fused_lif_gemm": b1} and math.isfinite(leg["losses"][0]),
          f"train legacy: {leg['losses']} with launches {leg['launches']}")
    t0 = time.perf_counter()
    lock = _lockstep_backward(torch, leg["params"], leg["events"], leg["spec"])
    emit({"phase": "train_legacy", "card": card,
          **{k: leg[k] for k in ("hw", "T", "batch", "losses", "ms_per_step",
                                 "memory_allocated_before", "max_memory_allocated",
                                 "launches")},
          "b3_backward_layer_by_layer": lock,
          "check_seconds": round(time.perf_counter() - t0, 3)})
    check(lock["ok"], f"train legacy: B3 autograd against the plain path {lock}")


#: B3 autograd's gradients against the plain composition's, per
#: layer-timestep: max |diff| <= GRAD_TOL * max |plain gradient| (float32
#: sums in another order; the backward's recomputed Vmem in float64).
GRAD_TOL = 1e-4


def _lockstep_backward(torch, params, events, spec) -> dict:
    """``mode="train"`` layer by layer: at every layer-timestep B3 under
    autograd (``_FusedLifGemmTrain``) and the plain ``matmul`` +
    ``neuron_step`` take the same input and Vmem and the same random
    cotangents, zeroed where a spike flipped (which must lie within 1e-5 of
    the threshold); their input, weight and Vmem gradients are held to
    ``GRAD_TOL``, and the walk goes on with the plain one."""
    from repro_torch.core import layers as L
    from repro_torch.core.network import _init_state
    from repro_torch.core.neuron import neuron_step
    from repro_torch.core.quant import ste_quantize

    gen = torch.Generator(device=events.device).manual_seed(7)
    state = _init_state(spec, events.shape[1], events.device)
    tot = {"layer_steps": 0, "spikes_flipped": 0, "flipped_off_threshold": 0,
           "max_rel_grad_err": 0.0, "ok": True}
    for x_t in events.to(torch.float32):
        act, new = x_t, []
        for i, l in enumerate(spec.layers):
            if l.kind in ("pool", "adaptive_pool"):
                kk = 2 if l.kind == "pool" else act.shape[1] // l.target_hw
                act = L.maxpool2d(act, kk, kk)
                new.append(None)
                continue
            if l.kind == "conv":
                p = l.conv
                cols = L.im2col(act, p.kh, p.kw, p.stride, p.padding)
                cols = cols.reshape(-1, params[i].shape[0])
            else:
                p, cols = l.fc, act.reshape(act.shape[0], -1)
            n = p.neuron
            wq = ste_quantize(params[i], 4)
            v0 = state[i].reshape(cols.shape[0], -1)
            outs = []
            for fn in (lambda c, w, v: L._FusedLifGemmTrain.apply(c, w, v, n),
                       lambda c, w, v: neuron_step(v, c @ w, n)):
                leaves = [x.detach().clone().requires_grad_(True) for x in (cols, wq, v0)]
                outs.append((leaves, fn(*leaves)))
            (_, (vk, sk)), (_, (vp, sp)) = outs
            leak = n.leak if n.model == "lif" else 1.0
            flipped = sk != sp
            v_pre = v0 * leak + cols @ wq
            off = int(((v_pre - n.threshold).abs() > 1e-5)[flipped].sum())
            keep = (~flipped).to(torch.float32)
            gv, gs = (torch.randn(vp.shape, generator=gen, device=vp.device) * keep
                      for _ in range(2))
            for leaves, (vv, ss) in outs:
                torch.autograd.backward([vv, ss], [gv, gs])
            rel = max(float((a.grad - b.grad).abs().max())
                      / max(float(b.grad.abs().max()), 1e-30)
                      for a, b in zip(outs[0][0], outs[1][0]))
            tot["layer_steps"] += 1
            tot["spikes_flipped"] += int(flipped.sum())
            tot["flipped_off_threshold"] += off
            tot["max_rel_grad_err"] = max(tot["max_rel_grad_err"], rel)
            tot["ok"] = tot["ok"] and off == 0 and rel <= GRAD_TOL
            new.append(vp.detach().reshape(state[i].shape))
            act = sp.detach().reshape(state[i].shape)
        state = new
    return tot


# ---------------------------------------------------------------------------
# 6d. deploy-time static analysis at full width (ROADMAP A11)
# ---------------------------------------------------------------------------
# (net, weight_bits, t_blocks): each compiled with check="strict" on 1 and
# 4 cores and run at every t_block, bit-exact with backend="torch".
ANALYSIS_DEPLOYS = (("gesture", 6, (1, 4)), ("gesture", 8, (1, 4)),
                    ("optical-flow", 8, (1, 5)))
ANALYSIS_BATCH = {"gesture": 4, "optical-flow": 2}
# stress_fleet: full-width gesture, both replicas on the one card.
STRESS = {"n_streams": 6, "n_replicas": 2, "capacity": 2, "seed": 3}
STRESS_TARGET = {"chunk_T": 4, "t_block": 4}
# The certificate's extremes: flow's weight layers at 8/15 bits, and B2's
# tile loop at a fan-in no paper layer has (facts derived at that fan-in).
EXTREME_BITS, EXTREME_M, EXTREME_T, EXTREME_WIDE = 8, 4096, 5, (2000, 32)
# cim_macro.accumulate on B4: one IFspad (128 x 16) per precision and
# spike density, weights over the precision's whole range.
MACRO_BITS, MACRO_DENSITIES, MACRO_SEED = (4, 6, 8), (0.05, 0.3, 1.0), 5
COMPILES = {"checked": 0}


def _guard_compiles() -> None:
    """Hold every deployment this script makes to its static analysis.

    ``spidr.compile``, which the phases and the launch modules they drive
    call, is wrapped: each compile's ``report().errors`` must be empty
    (counted in ``COMPILES``).  The analysis' own warning (``check="warn"``,
    the default, as under ``spidr.load``) is an error here and in every
    child process."""
    import warnings

    from repro_torch import spidr

    compile_ = spidr.compile

    def compile(*args, **kwargs):
        compiled = compile_(*args, **kwargs)
        errors = compiled.report().errors
        check(not errors, f"spidr.compile: static analysis found {errors}")
        COMPILES["checked"] += 1
        return compiled

    spidr.compile = compile
    warnings.filterwarnings("error", message="static analysis found",
                            category=RuntimeWarning)
    os.environ["PYTHONWARNINGS"] = "error:static analysis found:RuntimeWarning"


def _analysis_inputs(torch, dev, net):
    from repro_torch.configs import spidr_gesture, spidr_optflow
    from repro_torch.core.network import init_params
    from repro_torch.snn.data import make_flow_batch, make_gesture_batch

    spec = spidr_gesture.CONFIG if net == "gesture" else spidr_optflow.CONFIG
    make = make_gesture_batch if net == "gesture" else make_flow_batch
    params = init_params(torch.Generator().manual_seed(0), spec)
    events, _ = make(torch.Generator().manual_seed(1), batch=ANALYSIS_BATCH[net],
                     timesteps=spec.timesteps, hw=spec.input_hw, device=dev)
    return spec, params, events


def _analysis_cli() -> dict:
    """``python -m repro_torch.analysis --all --json`` in a child: exit 0,
    12 configurations and both lints; every overflow certificate
    re-verifies, one with a changed ``acc_hi`` does not."""
    import tempfile

    from repro_torch.analysis import check_certificate

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "analysis.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", "--all", "--json", path],
            capture_output=True, text=True, timeout=300, cwd=ROOT,
            env={**os.environ, "PYTHONPATH": SRC})
        seconds = time.perf_counter() - t0
        check(proc.returncode == 0, f"analysis CLI exited {proc.returncode}: "
              f"{proc.stdout[-1500:]} {proc.stderr[-1500:]}")
        with open(path, encoding="utf-8") as f:
            report = json.load(f)
    certs = {k: c for k, c in report["certificates"].items() if c["pass"] == "overflow"}
    check(report["ok"] and len(certs) == 12
          and set(report["passes"]) == {"overflow", "schedule", "purity", "concurrency"},
          f"analysis CLI: ok={report['ok']}, {len(certs)} overflow certificates, "
          f"passes {report['passes']}")
    failing = {k: p for k, c in certs.items() if (p := check_certificate(c))}
    check(not failing, f"analysis CLI: certificates fail re-verification {failing}")
    name, cert = sorted(certs.items())[-1]
    tampered = json.loads(json.dumps(cert))
    tampered["layers"][1]["acc_hi"] += 1
    problems = check_certificate(tampered)
    check(bool(problems), f"analysis CLI: {name} with acc_hi changed re-verifies")
    return {"rc": proc.returncode, "seconds": seconds, "configs": len(certs),
            "passes": sorted(report["passes"]), "violations": len(report["violations"]),
            "tampered": name, "tampered_problems": problems}


def _macro_blocks(bits: int):
    """Seeded (spikes (128, 16), weights (128, 48/W_b), vmem (16, 48/W_b))
    per density, as numpy."""
    import numpy as np

    from repro_torch.core.quant import QuantSpec

    q = QuantSpec(bits)
    rng = np.random.default_rng(MACRO_SEED + bits)
    for density in MACRO_DENSITIES:
        spikes = (rng.random((128, 16)) < density).astype(np.int8)
        w = rng.integers(q.w_min, q.w_max + 1, (128, q.neurons_per_row)).astype(np.int8)
        v0 = rng.integers(q.v_min // 2, q.v_max // 2 + 1,
                          (16, q.neurons_per_row)).astype(np.int32)
        yield density, spikes, w, v0


def phase_analysis(torch, dev) -> dict:
    """The deploy-time analysis on the card (ROADMAP A11): the CLI in a
    child; strict deployments at full width (gesture 6/11 and 8/15 bits,
    flow 8/15) on 1 and 4 cores, at two ``t_block`` each, bit-exact with
    ``backend="torch"``; ``stress_fleet`` (sync against threaded, each
    replica on its own CUDA stream); ``cim_macro.accumulate`` on CUDA
    tensors (B4).  The certificate's extremes on B1, B2 and B4 and the
    comparisons with the plain versions come after the launch counts are
    read (``check_analysis``)."""
    from repro_torch import spidr
    from repro_torch.analysis import concurrency
    from repro_torch.core import cim_macro
    from repro_torch.core.quant import QuantSpec

    t0 = time.perf_counter()
    out = {"cli": _analysis_cli(), "deploys": [], "macro": []}
    for net, bits, t_blocks in ANALYSIS_DEPLOYS:
        spec, params, events = _analysis_inputs(torch, dev, net)
        for n_cores in (1, 4):
            target = {"weight_bits": bits, "n_cores": n_cores}
            want = spidr.compile(spec, params, spidr.DeployTarget(backend="torch", **target),
                                 device=dev, check="strict").run(events)
            for t_block in t_blocks:
                c = spidr.compile(spec, params, spidr.DeployTarget(t_block=t_block, **target),
                                  device=dev, check="strict")
                rep = c.report()
                check(not rep.errors and ("schedule" in rep.passes) == (n_cores > 1),
                      f"analysis {net} {bits}b x{n_cores}: report {rep.summary()}")
                got = c.run(events)
                for a, b, what in ((got.readout, want.readout, "readout"),
                                   (got.spike_counts, want.spike_counts, "spike counts"),
                                   (got.input_counts, want.input_counts, "input counts")):
                    check(a.shape == b.shape and torch.equal(a, b),
                          f"analysis {net} {bits}b x{n_cores} t_block={t_block}: "
                          f"{what} differ from backend='torch'")
                out["deploys"].append({"net": net, "bits": bits, "n_cores": n_cores,
                                       "t_block": t_block, "passes": list(rep.passes),
                                       "certificates": sorted(rep.certificates)})
            if net == "optical-flow" and n_cores == 1:
                out["flow_certificate"] = rep.certificates["overflow"]

    # stress_fleet: the two fleets it serves, kept for the stream check.
    spec, params, _ = _analysis_inputs(torch, dev, "gesture")
    compiled = spidr.compile(spec, params, spidr.DeployTarget(**STRESS_TARGET),
                             device=dev, check="strict")
    fleets, serve_seeded = [], concurrency._serve_seeded

    def recorded(*args, **kwargs):
        res = serve_seeded(*args, **kwargs)
        fleets.append(res[2])
        return res

    concurrency._serve_seeded = recorded
    try:
        t1 = time.perf_counter()
        result = concurrency.stress_fleet(compiled, **STRESS)
        stress_s = time.perf_counter() - t1
    finally:
        concurrency._serve_seeded = serve_seeded
    check(result.ok and result.n_streams == STRESS["n_streams"],
          f"stress_fleet: mismatches {result.mismatches}")
    fleet = fleets[1]
    s0, s1 = fleet.tick_streams.get(0, set()), fleet.tick_streams.get(1, set())
    default = torch.cuda.default_stream(dev).cuda_stream
    check(fleet.config.mode == "threaded" and len(fleet.replica_streams) == 2
          and s0 == {fleet.replica_streams[0].cuda_stream}
          and s1 == {fleet.replica_streams[1].cuda_stream}
          and default not in s0 | s1 and not s0 & s1,
          f"stress_fleet: replica streams {s0}, {s1}, default {default}")
    out["stress"] = {**STRESS, **STRESS_TARGET, "ticks_sync": result.ticks_sync,
                     "ticks_threaded": result.ticks_threaded, "mismatches": 0,
                     "replica_streams_distinct": True, "seconds": stress_s}

    # The macro model on the card: accumulate through B4.
    for bits in MACRO_BITS:
        for density, spikes, w, v0 in _macro_blocks(bits):
            got = cim_macro.accumulate(
                torch.from_numpy(spikes).to(dev), torch.from_numpy(w).to(dev),
                torch.from_numpy(v0).to(dev), QuantSpec(bits))
            out["macro"].append({"bits": bits, "density": density,
                                 "got": got.cpu().numpy()})
    torch.cuda.synchronize(dev)
    out["seconds"] = time.perf_counter() - t0
    return out


def check_analysis(torch, dev, runs, launches: dict) -> None:
    """The certificate's extremes on the kernels, and the macro model
    against the CPU and the silicon order."""
    import numpy as np

    from repro_torch.analysis import layer_overflow_facts
    from repro_torch.core import cim_macro
    from repro_torch.core.quant import QuantSpec
    from repro_torch.kernels import fused_lif_gemm as fl
    from repro_torch.kernels import ref
    from repro_torch.kernels import spike_gemm as sk

    t0 = time.perf_counter()
    q = QuantSpec(EXTREME_BITS)
    cert = runs["flow_certificate"]
    check(cert["weight_bits"] == EXTREME_BITS, "analysis: flow certificate precision")
    layers = {(f["fan_in"], f["out_channels"]): f for f in cert["layers"]}
    k, n = EXTREME_WIDE
    layers[(k, n)] = layer_overflow_facts(-1, "conv", k, n, q)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    extremes = []
    for (k, n), facts in sorted(layers.items()):
        s = torch.ones((EXTREME_T, EXTREME_M, k), dtype=torch.int8, device=dev)
        thr = facts["threshold_hi"]
        for w_val, acc, v_end in ((q.w_min, facts["acc_lo"], q.v_min),
                                  (q.w_max, facts["acc_hi"], q.v_max)):
            w = torch.full((k, n), w_val, dtype=torch.int8, device=dev)
            raw = sk.spike_gemm(s[0], w)
            check(bool((raw == acc).all()), f"extremes K={k} N={n}: B4's raw sums "
                  f"{int(raw.min())}..{int(raw.max())} != the certificate's {acc}")
            v0 = torch.full((EXTREME_M, n), v_end, dtype=torch.int32, device=dev)
            v1, s1 = fl.fused_lif_gemm_int(s[0], w, v0, thr, vmem_bits=q.vmem_bits)
            v1p, s1p = ref.fused_lif_gemm_int_ref(s[0], w, v0, thr, vmem_bits=q.vmem_bits)
            vt, st = fl.fused_lif_gemm_int_tblk(s, w, v0, thr, vmem_bits=q.vmem_bits)
            vtp, stp = ref.fused_lif_gemm_int_tblk_ref(s, w, v0, thr,
                                                       vmem_bits=q.vmem_bits)
            check(torch.equal(v1, v1p) and torch.equal(s1, s1p)
                  and torch.equal(vt, vtp) and torch.equal(st, stp),
                  f"extremes K={k} N={n} w={w_val}: B1/B2 differ from their plain versions")
            check(bool((v1 == v_end).all()) and bool((vt == v_end).all())
                  and not bool(s1.any()) and not bool(st.any()),
                  f"extremes K={k} N={n} w={w_val}: B1/B2 did not saturate to {v_end}")
        extremes.append({"K": k, "N": n, "M": EXTREME_M, "T": EXTREME_T,
                         "acc_lo": facts["acc_lo"], "acc_hi": facts["acc_hi"],
                         "saturated": [q.v_min, q.v_max],
                         "b1_route": fl.tc_plan(EXTREME_M, k, n, sms).route,
                         "b2_route": fl.tblk_plan(EXTREME_M, k, n, sms).route,
                         "b4_route": sk.plan(EXTREME_M, k, n, sms).route,
                         "bit_exact": True})
        del s

    macro, blocks = [], {b: list(_macro_blocks(b)) for b in MACRO_BITS}
    for row in runs["macro"]:
        bits, got = row["bits"], row["got"]
        spec = QuantSpec(bits)
        _, spikes, w, v0 = next(b for b in blocks[bits] if b[0] == row["density"])
        cpu = cim_macro.accumulate(torch.from_numpy(spikes), torch.from_numpy(w),
                                   torch.from_numpy(v0), spec).numpy()
        seq = cim_macro.accumulate_sequential(spikes, w, v0, spec)
        # Elements whose silicon-order partial sums all stay in range.
        path = v0[None].astype(np.int64) + np.cumsum(
            spikes[:, :, None].astype(np.int64) * w[:, None, :], axis=0)
        inside = ((path >= spec.v_min) & (path <= spec.v_max)).all(axis=0)
        check(np.array_equal(got, cpu), f"macro {bits}b density {row['density']}: "
              "accumulate on the card != on the CPU")
        check(got.min() >= spec.v_min and got.max() <= spec.v_max,
              f"macro {bits}b density {row['density']}: outside [v_min, v_max]")
        check(np.array_equal(got[inside], seq[inside]),
              f"macro {bits}b density {row['density']}: != accumulate_sequential "
              "where no intermediate sum leaves the range")
        macro.append({"bits": bits, "density": row["density"], "M": 16, "K": 128,
                      "N": spec.neurons_per_row,
                      "b4_route": sk.plan(16, 128, spec.neurons_per_row, sms).route,
                      "in_range_elements": int(inside.sum()),
                      "elements": int(inside.size), "equal_cpu": True})
    check(launches["fused_lif_gemm_int"] > 0 and launches["fused_lif_gemm_int_tblk"] > 0
          and launches["spike_gemm"] == len(runs["macro"]),
          f"analysis: launches {launches}")
    emit({"phase": "analysis", "host_seconds": runs["seconds"],
          "check_seconds": round(time.perf_counter() - t0, 3),
          "launches": launches, "compiles_checked": COMPILES["checked"],
          "cli": runs["cli"], "deploys": runs["deploys"], "stress": runs["stress"],
          "extremes": extremes, "macro": macro})


# ---------------------------------------------------------------------------
# 6. the LM stack's kernels (B6, B7) against their plain versions, timed
# ---------------------------------------------------------------------------
WKV_TOL = {"rtol": 2e-4, "atol": 2e-5}
QMM_TOL = {"rtol": 1e-4, "atol": 1e-4}
# Float32 compute, kernel route against plain route, 32 layers: B7's fp32
# differences (within WKV_TOL) carried through the layers.
FP32_LOGIT_REL = 1e-3
LM_HEADS, LM_HEAD_SIZE, LM_CHUNK = 64, 64, 32
WKV_TIMED = ((1, 64), (1, 512), (4, 512))  # (B, S): a served prompt; prefills
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
    from repro_torch.kernels import wkv_chunk as wk
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
               "N": LM_HEAD_SIZE, "chunk": LM_CHUNK,
               "plan": wk.plan(b, s, LM_HEADS, LM_CHUNK, LM_HEAD_SIZE,
                               torch.cuda.get_device_properties(dev).multi_processor_count
                               )._asdict(), "max_abs_err": err,
               "tol_ratio": ratio,
               "ms": _time_ms(torch, lambda: wkv_sequence(*ins, chunk=LM_CHUNK), 20),
               "graph_ms": _graph_ms(torch, lambda: wkv_sequence(*ins, chunk=LM_CHUNK)),
               "plain_ms": _time_ms(torch, lambda: ref.wkv_sequence_ref(*ins, LM_CHUNK), 3),
               **_wkv_bound(b, s, LM_HEADS, LM_HEAD_SIZE, LM_CHUNK)}
        results["wkv_sequence"]["shapes"].append(row)
        emit({"phase": "kernel_timing", "kernel": "wkv_sequence", **row})
        del ins, got, want

    # Every (C, N) instance of B7, B in {1, 4}, over 4 and 12 chunks (one
    # and two windows where the cluster allows), the second head with
    # decays down to -20 per token in steps of 2^-10 (their running sums
    # exact in float32 in any order: at these magnitudes the plain
    # version's own float32 rounding of lw_incl would exceed the tolerance).
    instances = 0
    for c in wk.SIZES:
        for n in wk.SIZES:
            for b, s in ((1, 4 * c), (4, 12 * c)):
                ins = _wkv_inputs(torch, dev, c * n + b, b, s, h=2, n=n)
                ins[3][:, :, 1] = torch.round(ins[3][:, :, 1] * 20 * 1024) / 1024
                got = wkv_sequence(*ins, chunk=c)
                want = ref.wkv_sequence_ref(*ins, c)
                torch.cuda.synchronize()
                ratio = max(_tol_ratio(torch, g_, w_, WKV_TOL) for g_, w_ in zip(got, want))
                check(ratio <= 1.0, f"wkv_sequence != plain at C={c} N={n} B={b} S={s}: "
                      f"{ratio:.3f} x the tolerance {WKV_TOL}")
                worst["wkv_sequence"] = max(worst["wkv_sequence"], ratio)
                instances += 1

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
          "quant_matmul_ragged_cases": qmm_cases, "wkv_instances": instances,
          "worst_tol_ratio": worst,
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


def _lockstep_routes(torch, cfg, params, tokens) -> dict:
    """One prefill walked by both routes side by side, each from its own
    residual stream: after each layer, the largest difference of the two
    residual streams and the largest residual (where the routes part)."""
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T

    h = M._embed(params, tokens)
    b, _, d = h.shape
    x0 = h.new_zeros((b, d))
    s0 = torch.zeros((b, d // LM_HEAD_SIZE, LM_HEAD_SIZE, LM_HEAD_SIZE),
                     dtype=torch.float32, device=h.device)
    hk = hp = h
    diff, top = [], []
    for i in range(cfg.n_layers):
        lp = T.layer(params["blocks"], i)
        hk, _ = T._rwkv_block(lp, hk, (x0, x0, s0), cfg, use_kernel=True)
        hp, _ = T._rwkv_block(lp, hp, (x0, x0, s0), cfg, use_kernel=False)
        diff.append(float((hk.float() - hp.float()).abs().max()))
        top.append(float(hp.float().abs().max()))
    return {"dtype": str(h.dtype), "tokens": int(tokens.shape[1]),
            "residual_max_abs_diff": diff, "residual_max_abs": top}


def _served_fp32(torch, dev, cfg, masters) -> dict:
    """The 8 requests served through the kernel and the plain routes in
    float32 compute (the float32 masters).  A token may differ only where
    the plain route's float32 top-2 gap is within ``2 * FP32_LOGIT_REL``
    of the largest float32 logit: the bound the routes' logits are held
    to, on each of the two logits."""
    import numpy as np

    from repro_torch.models import model as M

    M.COMPUTE_DTYPE = torch.float32
    try:
        kern, kern_s = _serve_lm(torch, dev, cfg, masters, use_kernel=True)
        plain, plain_s = _serve_lm(torch, dev, cfg, masters, use_kernel=False)
        got = {r.rid: r.generated for r in kern.done}
        want = {r.rid: r.generated for r in plain.done}
        prompts = {r.rid: r.prompt for r in _lm_requests(cfg)}
        prefill = M.make_prefill_step(cfg, use_kernel=False)
        differ = []
        for rid, toks in sorted(want.items()):
            diff = [i for i, (a, b) in enumerate(zip(got[rid], toks)) if a != b]
            if not diff:
                continue
            i = diff[0]
            seq = np.concatenate([prompts[rid], np.asarray(toks[:i], np.int64)])
            with torch.no_grad():
                logits, _ = prefill(masters, {"tokens": torch.from_numpy(seq[None]).to(dev)})
            row = logits[0, :cfg.vocab_size]
            top2 = torch.topk(row, 2).values
            gap = float(top2[0] - top2[1])
            bound = 2 * FP32_LOGIT_REL * float(row.abs().max())
            differ.append({"rid": rid, "token": i, "plain_top2_gap": gap, "bound": bound})
            check(gap <= bound, f"lm float32: request {rid} token {i} differs between "
                  f"the kernel and plain routes with a top-2 gap of {gap} > {bound}")
    finally:
        M.COMPUTE_DTYPE = torch.bfloat16
    check(sorted(got) == sorted(want) == list(range(LM_REQUESTS)),
          "lm float32: not every request served")
    return {"requests_equal": sum(got[r] == want[r] for r in want),
            "requests_differing": differ, "kernel_serve_seconds": kern_s,
            "plain_serve_seconds": plain_s}


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
    with torch.no_grad():
        routes16 = _lockstep_routes(torch, cfg, params, torch.from_numpy(
            prompts[0][None].astype(np.int64)).to(dev))
    served32 = _served_fp32(torch, dev, cfg, lm["masters"])
    emit({"phase": "lm_check", "prefill_tokens": 512, "lockstep": lock,
          "tolerance": WKV_TOL, "walk_equals_plain_forward": walk_is_plain,
          "bf16_logits_max_abs_diff_kernel_vs_plain": dlogit, "bf16_largest_logit": top,
          "fp32_logits_max_abs_diff_kernel_vs_plain": dlogit32,
          "fp32_largest_logit": top32, "fp32_logits_tolerance_rel": FP32_LOGIT_REL,
          "served_requests_equal": sum(got[r] == want[r] for r in want),
          "served_requests_differing": differ, "token_gap_tolerance": tol,
          "plain_route_serve_seconds": ref_seconds,
          "bf16_lockstep_served_prefill": routes16,
          "fp32_served": served32,
          "seconds": round(time.perf_counter() - t0, 3)})


# ---------------------------------------------------------------------------
# 10. the LM families: nine architectures at full width, then card vs CPU
# ---------------------------------------------------------------------------
FAMILY_ARCHS = ("qwen1.5-0.5b", "starcoder2-3b", "qwen3-14b", "stablelm-3b",
                "granite-moe-3b-a800m", "moonshot-v1-16b-a3b", "musicgen-large",
                "chameleon-34b", "zamba2-7b")
FAMILY_REL = 0.05          # the reference's bar for two bfloat16 computations
FAMILY_RAGGED = (8, 12, 8, 40)


def _free(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _watch_logits(torch, server) -> list:
    """Wrap a Server's prefill and decode steps to keep, on the device and
    without a sync, whether each logits row they return is finite."""
    flags = []
    prefill, decode = server.prefill, server.decode_step

    def watched_prefill(params, batch):
        logits, cache = prefill(params, batch)
        flags.append(torch.isfinite(logits).all())
        return logits, cache

    def watched_decode(params, cache, batch):
        logits, cache, aux = decode(params, cache, batch)
        flags.append(torch.isfinite(logits).all())
        return logits, cache, aux

    server.prefill, server.decode_step = watched_prefill, watched_decode
    return flags


def _record_rows(server) -> dict:
    """Wrap a Server's steps to keep each request's logits rows in order
    (prefills run in submission order, the rids counted from 0)."""
    rows, admitted = {}, []
    prefill, decode = server.prefill, server.decode_step

    def rec_prefill(params, batch):
        logits, cache = prefill(params, batch)
        rows.setdefault(len(admitted), []).append(logits[0].float().cpu())
        admitted.append(True)
        return logits, cache

    def rec_decode(params, cache, batch):
        active = [(i, r.rid) for i, r in enumerate(server.slots) if r is not None]
        logits, cache, aux = decode(params, cache, batch)
        for i, rid in active:
            rows[rid].append(logits[i].float().cpu())
        return logits, cache, aux

    server.prefill, server.decode_step = rec_prefill, rec_decode
    return rows


def _decode_cache(torch, cfg, c1, ctx: int, device) -> dict:
    """A decode cache of context ``ctx`` holding a prefill's cache ``c1``
    (every slot at the prefill's length)."""
    from repro_torch.models import transformer as T

    plen = c1["k"].shape[3]
    batch = c1["k"].shape[1]
    cache = T.init_decode_state(cfg, batch, ctx, device=device)
    for key, dst in cache.items():
        if key in ("k", "v"):
            dst[:, :, :, :plen] = c1[key]
        elif key != "len":
            dst.copy_(c1[key])
    cache["len"] = torch.tensor(plen, dtype=torch.int32, device=device)
    return cache


def _decode_after_prefill(torch, dev, cfg, params, seq) -> float:
    """Decode token 65 after a 64-token prefill against the last logits of
    a 65-token prefill: max |difference| over the largest logit."""
    from repro_torch.models import model as M

    prefill = M.make_prefill_step(cfg)
    with torch.no_grad():
        full, _ = prefill(params, {"tokens": seq})
        _, c1 = prefill(params, {"tokens": seq[:, :-1]})
        cache = _decode_cache(torch, cfg, c1, LM_CTX, dev)
        step, _ = M.make_decode_step(cfg)(params, cache, {"tokens": seq[:, -1:]})
    return float((step - full).abs().max() / full.abs().max())


def _family_full_width(torch, dev, card, name) -> dict:
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import model as M

    cfg = get_config(name)
    _free(torch)
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    params = M.init_serving_params(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    leaves = list(_leaves(params))
    n_tree = sum(t.numel() for t in leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    warm = Server(cfg, params, capacity=LM_CAPACITY, ctx_len=LM_CTX)
    warm.submit(Request(rid=0, max_new=2, prompt=np.arange(LM_PROMPT, dtype=np.int32)))
    while warm.step():
        pass
    del warm
    server = Server(cfg, params, capacity=LM_CAPACITY, ctx_len=LM_CTX)
    finite = _watch_logits(torch, server)
    requests = _lm_requests(cfg)
    for req in requests:
        server.submit(req)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    while server.step():
        pass
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    done = {r.rid: r.generated for r in server.done}
    check(bool(torch.stack(finite).all()), f"lm_families {name}: a logits row is not finite")
    check(sorted(done) == list(range(LM_REQUESTS)), f"lm_families {name}: not every request served")
    check(all(len(t) == LM_NEW for t in done.values()),
          f"lm_families {name}: a request did not get {LM_NEW} tokens")
    check(all(0 <= x < cfg.vocab_size for t in done.values() for x in t),
          f"lm_families {name}: a token at or past vocab_size {cfg.vocab_size}")
    tokens = sum(len(t) for t in done.values())
    row = {"phase": "lm_families", "arch": name, "card": card, "family": cfg.family,
           "layers": cfg.n_layers, "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "params_tree": n_tree, "params_analytic": cfg.param_count(),
           "active_params_analytic": cfg.active_param_count(),
           "serving_gb": nbytes / 1e9, "bf16_gb": 2 * n_tree / 1e9,
           "resident_before_gb": resident / 1e9, "init_seconds": init_s,
           "requests": LM_REQUESTS, "capacity": LM_CAPACITY, "prompt_len": LM_PROMPT,
           "max_new": LM_NEW, "tokens": tokens, "serve_seconds": seconds,
           "tokens_per_s": tokens / seconds, "prefills": server.prefills,
           "prefill_ms_each": 1e3 * server.prefill_seconds / server.prefills,
           "decode_steps": server.decode_steps,
           "decode_ms_each": 1e3 * server.decode_seconds / server.decode_steps,
           "drop_fraction_mean": (float(np.mean(server.drop_fractions))
                                  if server.drop_fractions else None)}
    if cfg.family != "moe":
        # MoE is left out: a prefill's capacity can drop the last token's
        # routing (token-major priority), which the decode step never does.
        seq = torch.from_numpy(np.concatenate([requests[0].prompt, done[0][:1]])[None]
                               .astype(np.int64)).to(dev)
        rel = _decode_after_prefill(torch, dev, cfg, params, seq)
        row["decode_vs_prefill_rel"] = rel
        check(rel <= FAMILY_REL, f"lm_families {name}: decode of token 65 differs from "
              f"the 65-token prefill by {rel} of the largest logit")
    row["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del params, server
    _free(torch)
    return row


def _to_device(tree, dev):
    from repro_torch.models.transformer import _map_tree

    return {k: (v.to(dev) if hasattr(v, "to") else _map_tree(lambda g, f, t: t.to(dev), v))
            for k, v in tree.items()}


def _family_card_vs_cpu(torch, dev, card, name) -> dict:
    """The reduced config, the same serving parameters on the card and on
    the CPU: teacher-forced logits, then ragged prompts served on both."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import model as M

    cfg = get_config(name).reduced()
    cpu = M.init_serving_params(torch.Generator().manual_seed(0), cfg)
    gpu = _to_device(cpu, dev)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 16 + 4)).astype(np.int64)
    worst = 0.0
    logits = {}
    with torch.no_grad():
        for where, params, d in (("cpu", cpu, torch.device("cpu")), ("card", gpu, dev)):
            t = torch.from_numpy(toks).to(d)
            lg, c1 = M.make_prefill_step(cfg)(params, {"tokens": t[:, :16]})
            cache = _decode_cache(torch, cfg, c1, 32, d)
            rows = [lg.float().cpu()]
            for j in range(4):
                lg, cache = M.make_decode_step(cfg)(params, cache,
                                                     {"tokens": t[:, 16 + j:17 + j]})
                rows.append(lg.float().cpu())
            logits[where] = rows
    for a, b in zip(logits["cpu"], logits["card"]):
        worst = max(worst, float((a - b).abs().max() / a.abs().max()))
    check(worst <= FAMILY_REL, f"lm_families {name} reduced: card logits differ from the "
          f"CPU's by {worst} of the largest logit")
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in FAMILY_RAGGED]
    served, rows = {}, {}
    for where, params in (("cpu", cpu), ("card", gpu)):
        server = Server(cfg, params, capacity=2, ctx_len=64)
        rows[where] = _record_rows(server)
        for i, p in enumerate(prompts):
            server.submit(Request(rid=i, prompt=p, max_new=5))
        while server.step():
            pass
        served[where] = {r.rid: r.generated for r in server.done}
    ties = []
    for rid, want in served["cpu"].items():
        got = served["card"][rid]
        check(len(got) == len(want) == 5, f"lm_families {name} reduced: request {rid} length")
        diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        if diff:
            top2 = torch.topk(rows["cpu"][rid][diff[0]], 2).values
            gap = float(top2[0] - top2[1])
            bound = FAMILY_REL * float(rows["cpu"][rid][diff[0]].abs().max())
            ties.append({"rid": rid, "token": diff[0], "cpu_top2_gap": gap, "bound": bound})
            check(gap <= bound, f"lm_families {name} reduced: request {rid} token {diff[0]} "
                  f"differs between card and CPU with a top-2 gap {gap} > {bound}")
    return {"arch": name, "teacher_forced_rel": worst,
            "requests_equal": sum(served["card"][r] == served["cpu"][r] for r in served["cpu"]),
            "near_ties": ties}


def phase_lm_families(torch, dev, card) -> None:
    # The MoE router, the attention scores and the SSD are float32 in the
    # reference: no TF32 (the train phase switches it on for one check).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    for name in FAMILY_ARCHS:
        emit(_family_full_width(torch, dev, card, name))
    full_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = [_family_card_vs_cpu(torch, dev, card, name) for name in FAMILY_ARCHS]
    emit({"phase": "lm_families_card_vs_cpu", "card": card, "bound_rel": FAMILY_REL,
          "ragged_prompts": list(FAMILY_RAGGED), "capacity": 2, "archs": rows,
          "full_width_seconds": full_s, "seconds": time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# 11. lm_train (ROADMAP A12.2)
# ---------------------------------------------------------------------------
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 128, 1e-3   # the reference CLI's batch and seq
QWEN_TRAIN = {"steps": 12, "ckpt_every": 6, "fail_at": 6}
CUT_TRAIN = {"rwkv6-7b": 12, "granite-moe-3b-a800m": 16}   # layers kept of 32
CUT_STEPS = 3
WKV_GRAD_LAYERS = 4        # the kernel-vs-plain gradient check's depth
ACCUM_LOSS_RTOL = 1e-3     # tests/test_grad_accum.py's bounds
ACCUM_PARAM_TOL = {"rtol": 2e-2, "atol": 2.5e-3}
GRAD_LEAF_REL = 1e-3       # each gradient leaf, of its largest |gradient|
CARD_CPU_REL = 1e-4        # loss and grad_norm, card against CPU (float32)


def _clone_tree(tree):
    from repro_torch.checkpoint import tree_flatten, tree_unflatten

    return tree_unflatten(tree, [None if t is None else t.clone()
                                 for t in tree_flatten(tree)])


def _leaf_rel(got, want) -> float:
    """Largest, over the gradient leaves, of max |got - want| over the
    leaf's largest |want|."""
    from repro_torch.checkpoint import tree_flatten

    worst = 0.0
    for a, b in zip(tree_flatten(got), tree_flatten(want)):
        if b is not None:
            top = float(b.abs().max())
            worst = max(worst, float((a.to(b.device) - b).abs().max()) / (top or 1.0))
    return worst


def _train_batch(cfg, dev, step=0, batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    from repro_torch.data import TokenPipeline

    return TokenPipeline(batch, seq, cfg.vocab_size, seed=0, device=dev,
                         embeds_dim=0 if cfg.embed_inputs else cfg.d_model).batch_at(step)


def _train_qwen(torch, dev) -> dict:
    """(a) qwen1.5-0.5b at full width and depth: ``accum_steps=2`` against 1
    from the seed's params, then 12 steps through ``TrainingLoop`` with a
    checkpoint every 6 steps; step 6 runs (the parameters move in place)
    and then fails once, so the loop restores step 6's checkpoint and
    replays it."""
    import tempfile

    from repro_torch.checkpoint import Checkpointer, tree_flatten
    from repro_torch.configs.base import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import model as M
    from repro_torch.runtime import LoopConfig, RestartableFailure, TrainingLoop

    cfg = get_config("qwen1.5-0.5b")
    torch.cuda.reset_peak_memory_stats(dev)
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    opt = M.init_opt_state(params)
    batch = _train_batch(cfg, dev)
    p1, o1, m1 = M.make_train_step(cfg, lr=TRAIN_LR)(
        _clone_tree(params), _clone_tree(opt), 0, batch)
    p2, o2, m2 = M.make_train_step(cfg, lr=TRAIN_LR, accum_steps=2)(
        _clone_tree(params), _clone_tree(opt), 0, batch)
    accum_loss_rel = abs(float(m2["loss"]) - float(m1["loss"])) / abs(float(m1["loss"]))
    accum_ok = all(torch.allclose(b, a, **ACCUM_PARAM_TOL)
                   for a, b in zip(tree_flatten(p1), tree_flatten(p2)) if a is not None)
    accum_worst = max(float(((b - a).abs() - ACCUM_PARAM_TOL["rtol"] * a.abs()).max())
                      for a, b in zip(tree_flatten(p1), tree_flatten(p2)) if a is not None)
    del p1, o1, p2, o2
    _free(torch)

    step_fn = M.make_train_step(cfg, lr=TRAIN_LR)
    failed, host_ms, grad_norms = [], [], []

    def flaky(p, o, step, b):
        out = step_fn(p, o, step, b)
        if step == QWEN_TRAIN["fail_at"] and not failed:
            failed.append(float(out[2]["loss"]))
            raise RestartableFailure(f"injected after step {step}")
        return out

    def on_metrics(step, metrics, dt):
        host_ms.append(dt * 1e3)
        grad_norms.append(float(metrics["grad_norm"]))

    ckdir = tempfile.mkdtemp(prefix="chip_smoke_lm_train_")
    pipe = TokenPipeline(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size, seed=0, device=dev)
    try:
        loop = TrainingLoop(flaky, pipe.batch_at, Checkpointer(ckdir),
                            LoopConfig(total_steps=QWEN_TRAIN["steps"],
                                       checkpoint_every=QWEN_TRAIN["ckpt_every"],
                                       log_every=1000),
                            metrics_cb=on_metrics)
        t0 = time.perf_counter()
        params, opt, history = loop.run(params, opt)
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        saved = sorted(os.listdir(ckdir))
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    return {"arch": cfg.name, "layers": cfg.n_layers, "params": cfg.param_count(),
            "loss_first": history[0], "loss_last": history[-1],
            "history": history, "restarts": loop.restarts, "checkpoints": saved,
            "failed_step_loss": failed[0] if failed else None,
            "grad_norms": grad_norms, "host_ms": host_ms, "seconds": seconds,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "accum_loss_rel": accum_loss_rel, "accum_params_ok": accum_ok,
            "accum_worst_excess": accum_worst}


def _drop_fractions():
    """Record every MoE layer's drop fraction while the block is open."""
    import contextlib

    from repro_torch.models import transformer

    @contextlib.contextmanager
    def recording():
        real, fracs = transformer.moe_forward, []

        def wrapped(*args, **kwargs):
            out, aux = real(*args, **kwargs)
            fracs.append(aux["drop_fraction"].detach())
            return out, aux

        transformer.moe_forward = wrapped
        try:
            yield fracs
        finally:
            transformer.moe_forward = real

    return recording()


def _train_cut(torch, dev, kernels, name) -> dict:
    """(b), (c): the arch at full width with its depth cut, ``CUT_STEPS``
    train steps of the reference CLI's batch; per step the loss, the
    metrics, host ms (synchronized), peak GB, B7 launches and (MoE) the
    mean drop fraction."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M

    full = get_config(name)
    cfg = dataclasses.replace(full, n_layers=CUT_TRAIN[name])
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    opt = M.init_opt_state(params)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    step_fn = M.make_train_step(cfg, lr=TRAIN_LR)
    steps = []
    for step in range(CUT_STEPS):
        batch = _train_batch(cfg, dev, step)
        before = kernels.LAUNCHES["wkv_sequence"]
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with _drop_fractions() as fracs:
            t0 = time.perf_counter()
            params, opt, metrics = step_fn(params, opt, step, batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) * 1e3
        row = {"step": step, "loss": loss, "host_ms": ms,
               "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
               "b7_launches": kernels.LAUNCHES["wkv_sequence"] - before,
               "metrics": {k: float(v) for k, v in metrics.items()}}
        if fracs:
            row["drop_fraction"] = float(torch.stack(fracs).mean())
        steps.append(row)
    del params, opt
    _free(torch)
    return {"arch": name, "layers": cfg.n_layers, "layers_published": full.n_layers,
            "d_model": cfg.d_model, "params": cfg.param_count(), "init_s": init_s,
            "steps": steps}


def phase_lm_train(torch, dev, kernels) -> dict:
    """Phase 11 (ROADMAP A12.2): the main path's training runs; every
    comparison waits for ``check_lm_train``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    out = {"qwen": _train_qwen(torch, dev)}
    _free(torch)
    for name in CUT_TRAIN:
        out[name] = _train_cut(torch, dev, kernels, name)
    out["seconds"] = time.perf_counter() - t0
    return out


def _wkv_grad_check(torch, dev) -> dict:
    """(b) rwkv6-7b at full width, ``WKV_GRAD_LAYERS`` layers, float32
    compute: one batch's gradients through B7 (under ``_WkvSequenceTrain``)
    and through the plain wkv, from the same params."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config("rwkv6-7b"), n_layers=WKV_GRAD_LAYERS)
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    batch = _train_batch(cfg, dev)
    M.COMPUTE_DTYPE = torch.float32
    try:
        lk, _, gk = M.loss_and_grads(cfg, params, batch, use_kernel=True)
        lp, _, gp = M.loss_and_grads(cfg, params, batch, use_kernel=False)
    finally:
        M.COMPUTE_DTYPE = torch.bfloat16
    worst = _leaf_rel(gk, gp)
    del params, gk, gp
    _free(torch)
    return {"layers": cfg.n_layers, "loss_kernel": float(lk), "loss_plain": float(lp),
            "grad_leaf_rel": worst}


def _card_vs_cpu_step(torch, dev, name) -> dict:
    """(d) the reduced config, the same params and batch, one train step on
    the card and on the CPU, float32 compute."""
    from repro_torch.checkpoint import tree_flatten
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.optim import optimizer

    cfg = get_config(name).reduced()
    cpu = M.init_params(torch.Generator().manual_seed(0), cfg)
    batch = _train_batch(cfg, "cpu", batch=2, seq=32)
    res = {}
    M.COMPUTE_DTYPE = torch.float32
    try:
        for where, d in (("cpu", torch.device("cpu")), ("card", dev)):
            params = _to_device(cpu, d) if where == "card" else _clone_tree(cpu)
            b = {k: v.to(d) for k, v in batch.items()}
            loss, _, grads = M.loss_and_grads(cfg, params, b)
            gnorm = float(optimizer.global_norm(tree_flatten(grads)))
            _, _, metrics = M.make_train_step(cfg, lr=TRAIN_LR)(
                params, M.init_opt_state(params), 0, b)
            res[where] = (float(loss), gnorm, grads, {k: float(v) for k, v in metrics.items()})
    finally:
        M.COMPUTE_DTYPE = torch.bfloat16
    (lc, nc, gc, mc), (lg, ng, gg, mg) = res["cpu"], res["card"]
    return {"arch": name, "loss_rel": abs(lg - lc) / abs(lc),
            "grad_norm_rel": abs(ng - nc) / abs(nc),
            "step_loss_rel": abs(mg["loss"] - mc["loss"]) / abs(mc["loss"]),
            "step_grad_norm_rel": abs(mg["grad_norm"] - mc["grad_norm"]) / abs(mc["grad_norm"]),
            "grad_leaf_rel": _leaf_rel(gg, gc), "metrics": sorted(mg)}


def check_lm_train(torch, dev, card, runs, launches: dict) -> None:
    """Phase 11's checks, after its launches were read: the runs' losses
    and launches, then the comparisons (which launch B7 again)."""
    import math

    from repro_torch.configs.base import list_archs

    moved = {k: n for k, n in launches.items() if n and k != "wkv_sequence"}
    check(not moved, f"lm_train: B1-B6 launched {moved}")
    q = runs["qwen"]
    check(all(math.isfinite(x) for x in q["history"]), f"lm_train qwen: loss {q['history']}")
    check(q["history"][-1] < q["history"][0], f"lm_train qwen: loss did not fall "
          f"({q['history'][0]} -> {q['history'][-1]})")
    check(q["restarts"] == 1, f"lm_train qwen: {q['restarts']} restarts, expected 1")
    check(len(q["history"]) == QWEN_TRAIN["steps"], "lm_train qwen: steps")
    check(q["accum_loss_rel"] <= ACCUM_LOSS_RTOL and q["accum_params_ok"],
          f"lm_train qwen: accum_steps=2 against 1: loss rel {q['accum_loss_rel']}, "
          f"params within bounds {q['accum_params_ok']} ({q['accum_worst_excess']})")
    emit({"phase": "lm_train_qwen", "card": card, **q})
    total_b7 = 0
    for name in CUT_TRAIN:
        r = runs[name]
        for st in r["steps"]:
            check(all(math.isfinite(v) for v in st["metrics"].values()),
                  f"lm_train {name}: step {st['step']} metrics {st['metrics']}")
            want = 2 * r["layers"] if name == "rwkv6-7b" else 0
            check(st["b7_launches"] == want, f"lm_train {name}: step {st['step']} launched "
                  f"B7 {st['b7_launches']} times, expected {want}")
            total_b7 += st["b7_launches"]
        emit({"phase": "lm_train_cut", "card": card,
              "cut": f"n_layers {r['layers_published']} -> {r['layers']}", **r})
    check(launches["wkv_sequence"] == total_b7,
          f"lm_train: B7 launched {launches['wkv_sequence']} times, the steps {total_b7}")
    t0 = time.perf_counter()
    wkv = _wkv_grad_check(torch, dev)
    check(wkv["grad_leaf_rel"] <= GRAD_LEAF_REL, f"lm_train rwkv6-7b: kernel-route "
          f"gradients differ from the plain route's: {wkv}")
    rows = [_card_vs_cpu_step(torch, dev, name) for name in list_archs()]
    for r in rows:
        check(max(r["loss_rel"], r["grad_norm_rel"], r["step_loss_rel"],
                  r["step_grad_norm_rel"]) <= CARD_CPU_REL
              and r["grad_leaf_rel"] <= GRAD_LEAF_REL,
              f"lm_train {r['arch']} reduced: card against CPU {r}")
    emit({"phase": "lm_train_check", "card": card, "wkv_grad": wkv,
          "grad_leaf_rel_bound": GRAD_LEAF_REL, "card_vs_cpu_rel_bound": CARD_CPU_REL,
          "card_vs_cpu": rows, "seconds": time.perf_counter() - t0})


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
