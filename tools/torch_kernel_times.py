#!/usr/bin/env python3
"""Device time of B1 and B2 (``fused_lif_gemm_int`` and its T_blk form) of
a checkout of this repository, at ``chip_smoke.SHAPES``.

    python3 tools/torch_kernel_times.py [TREE]

TREE is the root of a checkout (default: this one); its
``src/repro_torch`` is imported, so two commits can be timed in one run on
one card, in turns (for example the parent unpacked with ``git archive``
into an ignored directory).  Prints one JSON line per shape: CUDA-graph
device ms per launch with an int and with an (N,) threshold, eager ms, and
B2 at T=4.  10 % random spikes, the 4-bit networks' neuron program.  Needs
a CUDA device.
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
        st, _, _, _ = cs._inputs(torch, dev, m, k, n, 7, t=4, seed=1)
        row["tblk_t4_graph_ms"] = cs._graph_ms(
            torch, lambda: fk.fused_lif_gemm_int_tblk(st, w, v, thr, **kw))
        print(json.dumps(row), flush=True)
        del s, w, v, st
    return 0


if __name__ == "__main__":
    sys.exit(main())
