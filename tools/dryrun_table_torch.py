#!/usr/bin/env python3
"""Markdown table of the port's dry-run records (``repro_torch.launch.dryrun``).

    python3 tools/dryrun_table_torch.py [DIR]   (default experiments/dryrun_torch)

One row per (arch, shape), pod1 and pod2 side by side ("p1 / p2"):
variant, per-device GiB (arguments + outputs + temp, the temp in
brackets), the roofline's compute, memory and collective terms in ms, the
bottleneck and the useful-FLOPs ratio -- model outputs at
``roofline.analysis.HW_PEAK`` (the H100's data-sheet peaks), not
timings.  A skipped (arch, shape) is one row; the last line counts ok,
skipped and error cells.
"""
from __future__ import annotations

import glob
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER = ["qwen1.5-0.5b", "starcoder2-3b", "qwen3-14b", "stablelm-3b", "rwkv6-7b",
         "granite-moe-3b-a800m", "moonshot-v1-16b-a3b", "musicgen-large", "chameleon-34b",
         "zamba2-7b"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def _pair(recs, fmt) -> str:
    return " / ".join(fmt(r) if r and r["status"] == "ok" else (r or {}).get("status", "-")
                      for r in recs)


def main(argv) -> int:
    d = argv[0] if argv else os.path.join(ROOT, "experiments", "dryrun_torch")
    recs = {}
    for f in glob.glob(os.path.join(d, "*.json")):
        r = json.load(open(f))
        recs[(r["arch"], r["shape"], r["multi_pod"])] = r
    count: dict = {}
    for r in recs.values():
        count[r["status"]] = count.get(r["status"], 0) + 1
    gib = 2 ** 30

    def mem(r):
        m = r["memory_analysis"]
        return f"{sum(m.values()) / gib:.2f} ({m['temp_size_in_bytes'] / gib:.2f})"

    def term(k):
        return lambda r: f"{r['roofline'][k] * 1e3:.4g}"

    print("| Arch, shape | Variant p1 / p2 | GiB (temp) p1 / p2 | compute ms | memory ms "
          "| collective ms | Bottleneck | Useful |")
    print("|---|---|---|---|---|---|---|---|")
    archs = sorted({a for a, _, _ in recs}, key=lambda a: ORDER.index(a) if a in ORDER else 99)
    for arch in archs:
        for shape in SHAPES:
            pair = [recs.get((arch, shape, mp)) for mp in (False, True)]
            if not any(pair):
                continue
            if all(r and r["status"] == "skipped" for r in pair):
                print(f"| {arch} {shape} | skipped: {pair[0]['reason']} | | | | | | |")
                continue
            print(f"| {arch} {shape} | {_pair(pair, lambda r: r['resolved_variant'])} "
                  f"| {_pair(pair, mem)} | {_pair(pair, term('compute_s'))} "
                  f"| {_pair(pair, term('memory_s'))} | {_pair(pair, term('collective_s'))} "
                  f"| {_pair(pair, lambda r: r['roofline']['bottleneck'])} "
                  f"| {_pair(pair, lambda r: format(r['roofline']['useful_flops_ratio'], '.3f'))} |")
    print(f"\n{count.get('ok', 0)} ok, {count.get('skipped', 0)} skipped, "
          f"{count.get('error', 0)} errors")
    return 1 if count.get("error") else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
