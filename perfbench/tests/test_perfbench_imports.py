"""What the benchmark may load: no JAX, no JAX package, a reference of its own."""
import ast
import json
import pathlib
import subprocess
import sys
import types

from perfbench.harness import setup_env

BENCH = setup_env.ROOT / "perfbench"
FOUND = ("reference", "checks", "events", "loops", "layers")


def _imported_tops(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_forbidden_names_are_compared_whole(monkeypatch):
    """``repro_torch`` is the port; ``repro`` (the JAX package) and ``jax`` are not."""
    before = setup_env.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", types.ModuleType("x"))
    assert setup_env.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", types.ModuleType("x"))
    assert {"repro", "jaxlib"} <= set(setup_env.forbidden_modules())


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not _imported_tops(path) & set(setup_env.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    """The reference, the checks, the event generators and the metrics import
    nothing of the program; loading them, ``harness/check.py``, ``control.py``,
    the loops and the layer kinds (which reach the program only inside their
    functions) loads nothing of it either."""
    for folder in ("reference", "checks", "events", "metrics"):
        for path in (BENCH / folder).rglob("*.py"):
            assert "repro_torch" not in _imported_tops(path), path
    code = ("import sys; sys.path.insert(0, %r); from perfbench.harness import setup_env; "
            "setup_env.configure(); import perfbench.reference.snn_int, "
            "perfbench.harness.check, perfbench.control; "
            "from perfbench.harness import found; "
            "[found.module(p.parent.name, p.stem) for d in %r "
            "for p in sorted((found.BENCH / d).glob('*.py')) if p.stem != '__init__']; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % (str(setup_env.ROOT), FOUND))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    tops = set(json.loads(out.stdout.replace("'", '"')))
    assert "perfbench_checks_closed_run" in tops
    assert not tops & {"repro_torch", *setup_env.FORBIDDEN}


def test_a_whole_run_loads_no_forbidden_module():
    """A small CPU run in a fresh process: the port, and nothing of JAX."""
    code = ("import sys; sys.path.insert(0, %r); from perfbench.harness import setup_env; "
            "setup_env.configure(); from perfbench.tests import _cells; "
            "r, _ = _cells.run_small('gesture-serve', seconds=0.5); "
            "print(r['correct'], 'repro_torch' in sys.modules, setup_env.forbidden_modules())"
            % str(setup_env.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.split("\n")[-2] == "True True []", out.stdout + out.stderr
