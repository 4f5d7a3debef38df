#!/usr/bin/env python3
"""Device time of the port's kernels in a checkout of this repository.

    python3 tools/torch_kernel_times.py [TREE] [--kernels int,b3,b7]

TREE is the root of a checkout (default: this one); its
``src/repro_torch`` is imported, so two commits can be timed in one run on
one card, in turns (for example the parent unpacked with ``git archive``
into an ignored directory).  Prints a JSON line with the card's name and
power limit, then one JSON line per shape, all CUDA-graph device ms per
launch:

  int  B1, B2 and B4 (``fused_lif_gemm_int``, its T_blk form and
       ``spike_gemm``) at ``chip_smoke.SHAPES``: B1 with an int and with an
       (N,) threshold (and its eager ms), B2 at T=4 and T=5 with an (N,)
       threshold, B4 in its default mode; 10 % random spikes, the 4-bit
       networks' neuron program
  b3   the float ``fused_lif_gemm`` at ``chip_smoke.FLOAT_SHAPES`` (the
       quickstart's float forward) and flow-middle, 10 % random spikes
  b7   ``wkv_sequence`` at ``chip_smoke.WKV_TIMED`` (H=64, N=64, chunk 32)

Needs a CUDA device.
"""
import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=HERE)
    ap.add_argument("--kernels", default="int,b3,b7")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    which = set(args.kernels.split(","))
    sys.path[:0] = [os.path.join(tree, "src"), HERE]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import fused_lif_gemm as fk
    from repro_torch.kernels.spike_gemm import spike_gemm
    from repro_torch.kernels.wkv_chunk import wkv_sequence

    if not torch.cuda.is_available():
        print("torch_kernel_times: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"tree": tree, "card": smi.stdout.strip()}), flush=True)
    kw = dict(leak_shift=3, soft_reset=False, vmem_bits=7)
    for name, (m, k, n) in cs.SHAPES.items() if "int" in which else ():
        s, w, v, _ = cs._inputs(torch, dev, m, k, n, 7, seed=1)
        thr = torch.full((n,), 5, dtype=torch.int32, device=dev)
        row = {"tree": tree, "kernel": "int", "shape": name, "M": m, "K": k, "N": n,
               "graph_ms": cs._graph_ms(torch, lambda: fk.fused_lif_gemm_int(s, w, v, 5, **kw)),
               "graph_ms_vector_thr": cs._graph_ms(
                   torch, lambda: fk.fused_lif_gemm_int(s, w, v, thr, **kw)),
               "ms": cs._time_ms(torch, lambda: fk.fused_lif_gemm_int(s, w, v, 5, **kw), 20)}
        row["spike_gemm_graph_ms"] = cs._graph_ms(torch, lambda: spike_gemm(s, w))
        for t in (4, 5):
            st, _, _, _ = cs._inputs(torch, dev, m, k, n, 7, t=t, seed=1)
            row[f"tblk_t{t}_graph_ms"] = cs._graph_ms(
                torch, lambda: fk.fused_lif_gemm_int_tblk(st, w, v, thr, **kw))
            del st
        print(json.dumps(row), flush=True)
        del s, w, v
    b3_shapes = {**cs.FLOAT_SHAPES, "flow_middle": cs.SHAPES["flow_middle"]}
    for name, (m, k, n) in b3_shapes.items() if "b3" in which else ():
        s, w, v = cs._float_inputs(torch, dev, m, k, n, seed=1)
        print(json.dumps({
            "tree": tree, "kernel": "fused_lif_gemm", "shape": name, "M": m, "K": k,
            "N": n, "graph_ms": cs._graph_ms(
                torch, lambda: fk.fused_lif_gemm(s, w, v, 0.5, 0.95))}), flush=True)
        del s, w, v
    for b, s_len in cs.WKV_TIMED if "b7" in which else ():
        ins = cs._wkv_inputs(torch, dev, b * 1000 + s_len, b, s_len)
        print(json.dumps({
            "tree": tree, "kernel": "wkv_sequence", "shape": f"B={b} S={s_len}",
            "graph_ms": cs._graph_ms(torch, lambda: wkv_sequence(*ins, chunk=cs.LM_CHUNK))}),
            flush=True)
        del ins
    return 0


if __name__ == "__main__":
    sys.exit(main())
