#!/usr/bin/env python3
"""Compare the machine code (SASS) of a kernel in two checkouts.

    python3 tools/sass_diff.py TREE_A TREE_B [--source fused_lif_gemm]
                               [--kernel lif_gemm_tc_kernel]

Builds ``csrc/<source>.cu`` in each tree with that tree's own build
(``repro_torch.kernels._build``, one process per tree), disassembles both
libraries with ``cuobjdump -sass`` and prints one JSON line per function
whose name contains KERNEL: its instruction count in each tree and whether
the two instruction streams are identical (addresses and the anonymous
namespace's hash left out).  Exits 1 if any differs or is missing.  Needs
``nvcc`` and ``cuobjdump`` (the CUDA toolkit), not a card.
"""
import argparse
import json
import os
import re
import shutil
import subprocess
import sys

_BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
          "from repro_torch.kernels import _build; "
          "print(_build.load(sys.argv[2])._name)")


def functions(lib: str) -> dict:
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                         check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_G_", m.group(1))
            funcs[name] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s*([^;]*;)", line)
        if m and name:
            funcs[name].append(m.group(1).strip())
    return funcs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree_a")
    ap.add_argument("tree_b")
    ap.add_argument("--source", default="fused_lif_gemm")
    ap.add_argument("--kernel", default="lif_gemm_tc_kernel")
    args = ap.parse_args()
    libs = [subprocess.run([sys.executable, "-c", _BUILD,
                            os.path.join(os.path.abspath(t), "src"), args.source],
                           capture_output=True, text=True, check=True).stdout.strip()
            for t in (args.tree_a, args.tree_b)]
    a, b = (functions(lib) for lib in libs)
    names = sorted(n for n in set(a) | set(b) if args.kernel in n)
    same = bool(names)
    for name in names:
        row = {"function": name, "a_instructions": len(a.get(name, [])),
               "b_instructions": len(b.get(name, [])),
               "identical": name in a and name in b and a[name] == b[name]}
        same = same and row["identical"]
        print(json.dumps(row), flush=True)
    print(json.dumps({"kernel": args.kernel, "functions": len(names),
                      "all_identical": same}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
