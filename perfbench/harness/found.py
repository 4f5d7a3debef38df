"""The parts of a cell that are files found by name, so a later PR adds them
without editing the harness.

==========  ===========================  ===========================================
folder      file                         named by
==========  ===========================  ===========================================
loops       ``loops/<kind>.py``          a traffic mix's ``kind``: how the window
                                         drives the program, and what it reports
checks      ``checks/<kind>.py``         the same ``kind``: the work a run is given
                                         and how its answers are judged
layers      ``layers/<kind>.py``         a configuration layer's ``kind``
events      ``events/<events>.py``       a configuration's ``events``
reference   ``reference/<name>.py``      a configuration's ``reference``
metrics     ``metrics/<metric>.py``      a per-layer metric's ``name``
==========  ===========================  ===========================================
"""
from __future__ import annotations

import importlib.util
import re
import sys

from .setup_env import ROOT

BENCH = ROOT / "perfbench"
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]*\Z")
_loaded = {}


class CellError(RuntimeError):
    """A run that cannot report: no card, a forbidden module, a bad cell."""


def module(folder: str, name: str):
    """``perfbench/<folder>/<name>.py``, loaded once per process."""
    path = BENCH / folder / f"{name}.py"
    if path not in _loaded:
        if not _NAME.match(str(name)) or not path.is_file():
            raise CellError(f"nothing in {folder}/ for {name!r}: no file {path}")
        spec = importlib.util.spec_from_file_location(f"perfbench_{folder}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod          # dataclasses look their module up there
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    return _loaded[path]
