"""Quickstart: the SpiDR stack on the card, step by step.

    python -m repro_torch.launch.quickstart              # the card, full width
    python -m repro_torch.launch.quickstart --device cpu --smoke

The walk of the reference's ``examples/quickstart.py``, on synthetic DVS
events:

  1. the precision pair (4-bit weights, 7-bit Vmem);
  2. the gesture SNN (Table II) at full width, 64x64, T=10, batch 4,
     through the float forward ``run_snn(mode="train")``: on the card one
     fused float kernel launch per weight layer-timestep;
  3. every layer mapped onto the accelerator (modes, Sec II-E);
  4. throughput and energy from the calibrated Table I model at the
     measured input sparsity;
  5. the unfused kernels on real spike matrices: the im2col of the
     step-2 events for the first conv layer (M = 4*64*64, K = 18, N = 16)
     and of the first layer's output spikes for the second (K = 144).
     ``spike_gemm_op`` against its plain version, then the unfused
     integer layer step ``lif_step_int_op(v, saturate(spike_gemm_op(S, W)))``
     against the fused ``fused_lif_gemm_int(S, W, v, thr)`` (equal
     exactly), and the float pair ``lif_step_op(v, S @ Wq)`` against the
     fused ``fused_lif_gemm`` (within the float tolerance);
  6. the ``spidr`` facade: a reduced gesture network (32x32, T=4) compiled
     onto the fused integer engine, run, priced on the chip cost model
     (``CompiledSNN.cost``) and verified against the python-loop reference.

``--smoke`` (or ``SPIDR_SMOKE=1``) shrinks steps 2, 5 and 6 for the CPU:
32x32, T=4, batch 2 and a 16x16, T=2 network.  Weights are random from a
fixed seed.  Exits non-zero if a check of step 5 or 6 fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch

from .. import resolve_device, spidr
from ..configs import spidr_gesture
from ..core.energy import HW, gops, power_mw, tops_per_watt
from ..core.layers import im2col, spiking_conv
from ..core.modes import CoreConfig, map_layer
from ..core.network import gesture_net, init_params, run_snn
from ..core.quant import QuantSpec, quantize, saturate, ste_quantize
from ..kernels.fused_lif_gemm import fused_lif_gemm, fused_lif_gemm_int
from ..kernels.ops import lif_step_int_op, lif_step_op, spike_gemm_op
from ..kernels.ref import compare_float_step, spike_gemm_ref
from ..snn.data import make_gesture_batch

__all__ = ["main", "run"]


def _first_layer_spikes(params, events, net, qspec):
    """Output spikes of the first conv layer at the last timestep: the
    layer alone over the stream, as step 2's forward computes it."""
    layer = net.layers[0]
    t, b, h, w, _ = events.shape
    v = torch.zeros((b, h, w, layer.c_out), dtype=torch.float32, device=events.device)
    for x_t in events.to(torch.float32):
        v, s = spiking_conv(x_t, params[0], v, layer.conv, qspec)
    return s


def _layer_checks(name, spikes, w_float, qspec, neuron, gen):
    """Step 5 on one spike matrix: the unfused kernels against their plain
    version and the unfused layer step against the fused one."""
    m, k = spikes.shape
    dev = spikes.device
    w_q, scale = quantize(w_float, qspec)
    n = w_q.shape[1]
    thr = int(round(neuron.threshold / float(scale)))
    partial = spike_gemm_op(spikes, w_q)
    gemm_exact = torch.equal(partial, spike_gemm_ref(spikes, w_q))

    v = torch.randint(qspec.v_min, qspec.v_max + 1, (m, n), generator=gen,
                      dtype=torch.int32).to(dev)
    kw = dict(leak_shift=neuron.leak_shift, soft_reset=neuron.reset == "soft",
              vmem_bits=qspec.vmem_bits)
    v_u, s_u = lif_step_int_op(v, saturate(partial, qspec), thr, **kw)
    v_f, s_f = fused_lif_gemm_int(spikes, w_q, v, thr, **kw)
    int_identity = torch.equal(v_u, v_f) and torch.equal(s_u, s_f)

    w_fq = ste_quantize(w_float, qspec.weight_bits)
    s_float = spikes.to(torch.float32)
    v_fl = (torch.rand((m, n), generator=gen) * 2 - 1).to(dev)
    current = s_float @ w_fq
    leak = neuron.leak if neuron.model == "lif" else 1.0
    fkw = dict(threshold=neuron.threshold, leak=leak,
               soft_reset=neuron.reset == "soft")
    vu, su = lif_step_op(v_fl, current, **fkw)
    vf, sf = fused_lif_gemm(s_float, w_fq, v_fl, **fkw)
    v_pre = (v_fl * leak if leak != 1.0 else v_fl) + current
    float_pair = compare_float_step(vf, sf, vu, su, v_pre, neuron.threshold)
    return {"layer": name, "M": m, "K": k, "N": n,
            "density": float((spikes != 0).float().mean()),
            "spike_gemm_exact": gemm_exact, "int_unfused_eq_fused": int_identity,
            "float_unfused_vs_fused": float_pair}


def run(device=None, smoke: bool = False, log=print) -> dict:
    """The quickstart's six steps; returns what each step computed."""
    dev = resolve_device(device)
    out: dict = {"device": str(dev), "smoke": smoke}

    # 1. precision ------------------------------------------------------------
    spec4 = QuantSpec(4)
    log(f"precision: {spec4.weight_bits}/{spec4.vmem_bits}-bit "
        f"(B_vmem = 2*B_w - 1 = {spec4.vmem_bits})")

    # 2. network + float inference -------------------------------------------
    net = gesture_net()
    params = [None if p is None else p.to(dev)
              for p in init_params(torch.Generator().manual_seed(0), net)]
    hw, steps, batch = ((32, 32), 4, 2) if smoke else ((64, 64), 10, 4)
    events, _ = make_gesture_batch(torch.Generator().manual_seed(1), batch=batch,
                                   timesteps=steps, hw=hw, device=dev)
    sparsity = float((events == 0).to(torch.float32).mean())
    run_net = dataclasses.replace(net, input_hw=hw, timesteps=steps) if smoke else net
    logits, counts = run_snn(params, events, run_net, spec4, record_spikes=True)
    log(f"input sparsity {sparsity:.1%}; rate-coded logits shape "
        f"{tuple(logits.shape)}; output spikes per layer "
        f"{[int(c) for c in counts.sum(dim=0).tolist()]}")
    out.update(sparsity=sparsity, logits=logits, spike_counts=counts,
               events=events, params=params, run_net=run_net)

    # 3. accelerator mapping ---------------------------------------------------
    core = CoreConfig(spec4)
    log("layer mapping (Sec II-E):")
    out["mapping"] = []
    for i, shape in enumerate(net.layer_shapes()):
        m = map_layer(shape, core)
        out["mapping"].append(m)
        log(f"  L{i}: {shape.kind} fan_in={shape.fan_in:4d} -> mode {m.mode}, "
            f"{m.parallel_channels} parallel ch, {m.total_passes} passes")

    # 4. throughput / energy (Table I model) ------------------------------------
    hw_point = HW(50e6, 0.9)
    out["energy"] = {"power_mw": power_mw(hw_point), "gops": gops(sparsity, 4),
                     "tops_per_watt": tops_per_watt(sparsity, 4, hw_point)}
    log(f"@50MHz/0.9V: {out['energy']['power_mw']:.1f} mW, "
        f"{out['energy']['gops']:.1f} GOPS, "
        f"{out['energy']['tops_per_watt']:.2f} TOPS/W at measured sparsity "
        f"{sparsity:.2%}")

    # 5. the unfused kernels on the step-2 spike matrices --------------------------
    conv = net.layers[0].conv
    s1 = im2col(events[-1].to(torch.int8), conv.kh, conv.kw, conv.stride,
                conv.padding).reshape(-1, conv.kh * conv.kw * net.in_channels)
    spikes1 = _first_layer_spikes(params, events, run_net, spec4)
    s2 = im2col(spikes1.to(torch.int8), conv.kh, conv.kw, conv.stride,
                conv.padding).reshape(-1, conv.kh * conv.kw * net.layers[1].c_in)
    gen = torch.Generator().manual_seed(3)
    out["spike_matrices"] = {"conv1": s1.contiguous(), "conv2": s2.contiguous()}
    out["layer_checks"] = [
        _layer_checks(name, s.contiguous(), params[i], spec4, net.layers[i].conv.neuron, gen)
        for i, (name, s) in enumerate(out["spike_matrices"].items())]
    for c in out["layer_checks"]:
        f = c["float_unfused_vs_fused"]
        log(f"{c['layer']}: S ({c['M']}x{c['K']}, density {c['density']:.2%}) @ W "
            f"(Kx{c['N']}): spike_gemm == plain: {c['spike_gemm_exact']}; "
            f"lif_step_int(saturate(spike_gemm)) == fused int: "
            f"{c['int_unfused_eq_fused']}; lif_step(S @ Wq) vs fused float: "
            f"ok={f['ok']} (max |dV| {f['max_abs_err']:.2e}, "
            f"{f['spikes_flipped']} spikes flipped within 1e-5 of threshold)")

    # 6. the unified deployment facade -----------------------------------------
    small = spidr_gesture.reduced(hw=(16, 16) if smoke else (32, 32),
                                  timesteps=2 if smoke else 4)
    sparams = init_params(torch.Generator().manual_seed(0), small)
    compiled = spidr.compile(small, sparams,
                             spidr.DeployTarget(weight_bits=4, backend="fused"),
                             device=dev)
    log(repr(compiled))
    sev, _ = make_gesture_batch(torch.Generator().manual_seed(2), batch=2,
                                timesteps=small.timesteps, hw=small.input_hw,
                                device=dev)
    result = compiled.run(sev)
    # Per-stream chip cost: the engine records whole-batch spike counts, so
    # normalize by the batch size before pricing.
    counts6 = result.input_counts.cpu().numpy() / sev.shape[1]
    cost = compiled.cost(input_counts=counts6)
    log(f"fused engine: rate readout {result.readout.cpu().tolist()}")
    log(f"chip estimate/stream: {cost.latency_ms:.2f} ms, {cost.energy_uj:.1f} uJ "
        f"at {cost.mean_sparsity:.1%} sparsity (async speedup "
        f"{cost.async_speedup:.2f}x)")
    report = compiled.verify(sev)
    log(f"round-trip parity proof: exact={report.exact}")
    out.update(compiled=compiled, facade_events=sev, facade_result=result,
               cost_counts=counts6, cost=cost, verify_exact=report.exact)

    out["ok"] = bool(report.exact and all(
        c["spike_gemm_exact"] and c["int_unfused_eq_fused"]
        and c["float_unfused_vs_fused"]["ok"] for c in out["layer_checks"]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.quickstart",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch kernels)")
    ap.add_argument("--smoke", action="store_true",
                    help="CPU-sized run (also SPIDR_SMOKE=1)")
    args = ap.parse_args(argv)
    out = run(args.device, smoke=args.smoke or os.environ.get("SPIDR_SMOKE") == "1")
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
