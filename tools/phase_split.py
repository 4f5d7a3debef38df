#!/usr/bin/env python3
"""Where a block of a kernel spends its time, phase by phase.

    python3 tools/phase_split.py [TREE] [--b B] [--s S] [--out DIR]
    python3 tools/phase_split.py [TREE] --b3 M,K,N [--out DIR]

Builds an instrumented copy of TREE's ``src/repro_torch/kernels/csrc/
wkv_chunk.cu`` (B7; with ``--b3``, ``fused_lif_gemm.cu``) into DIR
(default: a temporary directory; TREE default: this checkout): at the
entry of every ``__global__`` function and after every block or cluster
barrier and every mbarrier wait in it, thread 0 of each block records the
line's number, ``clock64()`` and ``%globaltimer``.  The tree's own wrapper
then launches it once: ``wkv_sequence`` at the rwkv6-7b layer shape (H=64,
N=64, chunk 32) with B and S tokens, or ``fused_lif_gemm`` at (M, K, N)
with 10 % random spikes.  Prints one JSON line: for each pair of
consecutive stamps, the mean over blocks and passes of the cycles and
nanoseconds between them (the phase that ends at the second), each
block's mean span from entry to its last stamp, and the stamped build's
CUDA-graph time per launch.  The stamps cost a few
instructions each; the split is a picture of where the time goes, not a
timing.  Needs a CUDA device.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_STAMPS = 512

_PRELUDE = r"""#include <cuda_runtime.h>
__device__ long long* g_wkv_stamps;
__device__ int g_wkv_max, g_wkv_blocks;
#define WKV_STAMP(site) do { if (threadIdx.x == 0 && nst_ < g_wkv_max) { \
  const long long blk_ = ((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x; \
  if (blk_ < g_wkv_blocks) { long long* p_ = g_wkv_stamps + (blk_ * g_wkv_max + nst_) * 3; \
    unsigned long long gt_; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gt_)); \
    p_[0] = site; p_[1] = clock64(); p_[2] = (long long)gt_; } } ++nst_; } while (0)
"""
_EPILOGUE = r"""
extern "C" int wkv_stamps_set(void* p, int max_per_block, int blocks) {
  cudaMemcpyToSymbol(g_wkv_stamps, &p, sizeof(p));
  cudaMemcpyToSymbol(g_wkv_max, &max_per_block, sizeof(int));
  cudaMemcpyToSymbol(g_wkv_blocks, &blocks, sizeof(int));
  return int(cudaGetLastError());
}
"""
_BARRIER = re.compile(r"(__syncthreads\(\);|cluster\.sync\(\);|mbar_wait\([^;]*\);)")


def instrument(src: str) -> str:
    """``src`` with a stamp at each kernel's entry and after each barrier."""
    out, pos = [], 0
    for m in re.finditer(r"__global__[^{;]*\{", src):
        if m.start() < pos:
            continue
        depth, end = 1, m.end()
        while depth:
            depth += {"{": 1, "}": -1}.get(src[end], 0)
            end += 1
        body = src[m.end():end]
        first = src.count("\n", 0, m.end()) + 1

        def stamp(b):
            line = first + body.count("\n", 0, b.start())
            return f"{b.group(1)} WKV_STAMP({line});"

        out += [src[pos:m.end()], f" int nst_ = 0; WKV_STAMP({first});",
                _BARRIER.sub(stamp, body)]
        pos = end
    return _PRELUDE + "".join(out) + src[pos:] + _EPILOGUE


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=HERE)
    ap.add_argument("--b", type=int, default=1)
    ap.add_argument("--s", type=int, default=512)
    ap.add_argument("--b3", default=None, help="M,K,N: instrument B3 instead")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [os.path.join(tree, "src"), HERE]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_lif_gemm as fk
    from repro_torch.kernels import wkv_chunk as wk

    if not torch.cuda.is_available():
        print("phase_split: needs a CUDA device", file=sys.stderr)
        return 2
    out_dir = args.out or tempfile.mkdtemp(prefix="phase_split_")
    os.makedirs(out_dir, exist_ok=True)
    name = "fused_lif_gemm" if args.b3 else "wkv_chunk"
    src_path = os.path.join(tree, f"src/repro_torch/kernels/csrc/{name}.cu")
    with open(src_path) as f:
        src = f.read()
    patched = os.path.join(os.path.dirname(src_path), f".{name}_stamped.cu")
    lib_path = os.path.join(out_dir, f"lib{name}_stamped.so")
    with open(patched, "w") as f:  # beside the original: its includes resolve
        f.write(instrument(src))
    try:
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib_path, patched],
                       check=True, capture_output=True, text=True)
    finally:
        os.remove(patched)
    lib = ctypes.CDLL(lib_path)
    lib.wkv_stamps_set.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    _build._LOADED[name] = lib
    _build._BOUND.pop(name, None)

    dev = torch.device("cuda", 0)
    if args.b3:
        m, k, n = (int(x) for x in args.b3.split(","))
        s, w, v = cs._float_inputs(torch, dev, m, k, n, seed=1)
        run = lambda: fk.fused_lif_gemm(s, w, v, 0.5, 0.95)  # noqa: E731
        blocks, shape = 4 * (-(-m // 64)) * (-(-n // 32)), {"M": m, "K": k, "N": n}
    else:
        ins = cs._wkv_inputs(torch, dev, 0, args.b, args.s)
        run = lambda: wk.wkv_sequence(*ins, chunk=cs.LM_CHUNK)  # noqa: E731
        blocks = 8 * args.b * cs.LM_HEADS * max(1, args.s // cs.LM_CHUNK)
        shape = {"B": args.b, "S": args.s, "H": cs.LM_HEADS, "N": cs.LM_HEAD_SIZE,
                 "chunk": cs.LM_CHUNK}
    run()  # warm-up
    graph_ms = cs._graph_ms(torch, run)  # with the stamps: a rough time only
    buf = torch.full((blocks, MAX_STAMPS, 3), -1, dtype=torch.int64, device=dev)
    lib.wkv_stamps_set(buf.data_ptr(), MAX_STAMPS, blocks)
    torch.cuda.synchronize()
    run()
    torch.cuda.synchronize()
    stamps = buf.cpu()
    sites: dict = {}
    spans = []
    for blk in stamps:
        rows = blk[blk[:, 0] >= 0]
        if len(rows) < 2:
            continue
        spans.append(int(rows[-1, 2] - rows[0, 2]))
        for prev, cur in zip(rows[:-1], rows[1:]):
            key = (int(prev[0]), int(cur[0]))
            n, cyc, ns = sites.get(key, (0, 0, 0))
            sites[key] = (n + 1, cyc + int(cur[1] - prev[1]), ns + int(cur[2] - prev[2]))
    lines = src.splitlines()
    print(json.dumps({
        "tree": tree, "kernel": name, **shape, "stamped_graph_ms": graph_ms, "blocks_stamped": len(spans),
        "block_span_ns_mean": sum(spans) / max(1, len(spans)),
        "block_span_ns_max": max(spans, default=0),
        "phases": [{"from_line": a, "to_line": b, "to_source": lines[b - 1].strip()[:60],
                    "passes_per_block": n / max(1, len(spans)),
                    "mean_cycles": cyc / n, "mean_ns": ns / n}
                   for (a, b), (n, cyc, ns) in sorted(sites.items(), key=lambda kv: kv[0])]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
