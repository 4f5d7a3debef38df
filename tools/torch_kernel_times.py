#!/usr/bin/env python3
"""Device time of B1, B2 and B4 (``fused_lif_gemm_int``, its T_blk form and
``spike_gemm``) of a checkout of this repository, at ``chip_smoke.SHAPES``.

    python3 tools/torch_kernel_times.py [TREE]

TREE is the root of a checkout (default: this one); its
``src/repro_torch`` is imported, so two commits can be timed in one run on
one card, in turns (for example the parent unpacked with ``git archive``
into an ignored directory).  Prints one JSON line per shape: B1's CUDA-graph
device ms per launch with an int and with an (N,) threshold and its eager
ms; B2's graph ms at T=4 and T=5 with an (N,) threshold (the kernel alone,
whichever way a tree passes an int); B4's graph ms in its default mode.
10 % random spikes, the 4-bit networks' neuron program.  Needs a CUDA
device.
"""
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    sys.path[:0] = [os.path.join(tree, "src"), HERE]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import fused_lif_gemm as fk
    from repro_torch.kernels.spike_gemm import spike_gemm

    if not torch.cuda.is_available():
        print("torch_kernel_times: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    kw = dict(leak_shift=3, soft_reset=False, vmem_bits=7)
    for name, (m, k, n) in cs.SHAPES.items():
        s, w, v, _ = cs._inputs(torch, dev, m, k, n, 7, seed=1)
        thr = torch.full((n,), 5, dtype=torch.int32, device=dev)
        row = {"tree": tree, "shape": name, "M": m, "K": k, "N": n,
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
