"""Process set-up before the program is imported: paths, caches, guards.

The benchmark runs from the root of a checkout.  Every build and kernel
cache goes to a fixed directory inside it (``.perfbench_cache/``, which
``.gitignore`` lists), so only a cell's first run in a checkout builds;
the program's own nvcc builds go to its fixed ``src/repro_torch/kernels/
_build/``.  Nothing is written outside the checkout, ``HOME``,
``XDG_CACHE_HOME`` and ``TMPDIR``.
"""
from __future__ import annotations

import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
CACHE = ROOT / ".perfbench_cache"

#: Top-level module names that no process of the benchmark may hold: JAX
#: and the JAX package the port was made from.  Compared whole, since the
#: port's own name begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def configure() -> None:
    """Fix the cache directories and make the checkout's packages importable."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list:
    """The forbidden top-level names present in ``sys.modules``."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))
