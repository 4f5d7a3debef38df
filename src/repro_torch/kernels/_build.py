"""Build the CUDA sources in ``csrc/`` at first use, load and bind them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Libraries go to ``_build/`` beside
this file (listed in ``.gitignore``), named by a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source
rebuilds and an unchanged one is reused.  :func:`build_all` starts one
``nvcc`` per source, all at once.

The wrappers' shared plumbing lives here too: :func:`bind` sets each C
function's ``ctypes`` signature, :func:`kernel_device` picks the route
(None for CPU tensors, which take the plain version; the CUDA device
otherwise; anything else raises) and refuses, through :func:`no_detach`, a
CUDA launch whose outputs autograd would lose, :func:`check` validates an
operand, and
:func:`raise_on` turns a non-zero ``cudaError_t`` into an exception.  The
package's one launch counter is :data:`LAUNCHES`: per CUDA entry point,
the kernel launches since :func:`reset_launches`.  Each wrapper adds one
(:func:`count_launch`, under a lock: replica threads launch at once) where
it launches its kernel, and nowhere else.  Launches captured into a CUDA
graph have not run: :func:`recording_launches` collects them for the
capturing thread, and :func:`add_launches` counts them on each replay.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

__all__ = ["BuildError", "LAUNCHES", "add_launches", "bind", "build_all", "check",
           "count_launch", "kernel_device", "load", "no_detach", "raise_on",
           "recording_launches", "reset_launches", "sm_count"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict = {}   # source name -> ctypes.CDLL
_BOUND: dict = {}    # source name -> {symbol: ctypes function}
_SM_COUNT: dict = {}  # CUDA device -> its number of SMs

#: Kernel launches per CUDA entry point since the last :func:`reset_launches`.
LAUNCHES = {name: 0 for name in (
    "fused_lif_gemm_int", "fused_lif_gemm_int_tblk", "fused_lif_gemm",
    "spike_gemm", "lif_step_fused", "lif_step_fused_int",
    "quant_matmul_int8", "quant_matmul_int4", "wkv_sequence")}


# Replica threads of a threaded fleet launch at once: ``+= 1`` on a dict
# entry is a read-modify-write that loses counts without the lock.
_LAUNCH_LOCK = threading.Lock()
# Per thread: the dict that :func:`recording_launches` collects into, if any.
_RECORDING = threading.local()


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    recording = getattr(_RECORDING, "launches", None)
    if recording is not None:
        recording[name] = recording.get(name, 0) + 1
        return
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1


def add_launches(counts: dict) -> None:
    """Count ``{entry point: launches}`` at once (a graph's replay)."""
    with _LAUNCH_LOCK:
        for name, n in counts.items():
            LAUNCHES[name] += n


@contextlib.contextmanager
def recording_launches():
    """Inside, this thread's launches go to the yielded dict, not to
    :data:`LAUNCHES`: a stream capture enqueues kernels that do not run.
    Other threads count as usual."""
    if getattr(_RECORDING, "launches", None) is not None:
        raise RuntimeError("recording_launches does not nest")
    _RECORDING.launches = recorded = {}
    try:
        yield recorded
    finally:
        _RECORDING.launches = None


class BuildError(RuntimeError):
    """``nvcc`` is missing or refused a source."""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise BuildError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _target(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; None when the library is current."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    stdout, stderr = proc.communicate()
    log = stdout + stderr
    if proc.returncode != 0:
        raise BuildError(f"nvcc failed on csrc/{name}.cu "
                         f"(exit {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build_all() -> dict:
    """Compile every ``csrc/*.cu`` in parallel (one ``nvcc`` each).

    Returns ``{name: nvcc output}``, which holds ptxas' register, shared
    memory and spill report (kept beside the library, so a cached build
    reports it too).
    """
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    jobs = {n: _start(n) for n in names}
    for n, job in jobs.items():
        if job is not None:
            _finish(n, job)
    logs = {n: _target(n).with_suffix(".log") for n in names}
    return {n: p.read_text() if p.exists() else "" for n, p in logs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(str(_target(name)))
        _LOADED[name] = lib
    return lib


def bind(name: str, signatures: dict) -> dict:
    """``{symbol: function}`` of ``csrc/<name>.cu`` with ``argtypes`` set
    from ``signatures`` and an int (``cudaError_t``) result."""
    fns = _BOUND.get(name)
    if fns is None:
        lib = load(name)
        fns = {}
        for sym, argtypes in signatures.items():
            f = getattr(lib, sym)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            fns[sym] = f
        _BOUND[name] = fns
    return fns


def no_detach(what: str, *tensors: torch.Tensor) -> None:
    """Raise if grad mode is on and a tensor requires grad.

    A kernel fills its outputs through ``ctypes``: they carry no
    ``grad_fn``, so a gradient through them would silently be cut.  The
    calls that pass are those with grad mode off, which includes the
    forward of an autograd ``Function`` that supplies the backward
    (``core.layers._FusedLifGemmTrain`` for B3,
    ``models.rwkv6._WkvSequenceTrain`` for B7).
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel's outputs would carry no gradient, but an "
            "input requires grad; call it under torch.no_grad() or through "
            "its autograd Function")


def kernel_device(what: str, *tensors: torch.Tensor):
    """None when every tensor lies on the CPU; else their CUDA device.

    A tensor on any other device raises: there is no fallback.  So does a
    CUDA launch under grad (:func:`no_detach`); the plain version on CPU
    tensors is differentiable and passes.
    """
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return None
    for d in devices:
        if d.type != "cuda":
            raise ValueError(f"{what} runs on CPU or CUDA tensors, got {d}")
    no_detach(what, *tensors)
    return next(d for d in devices if d.type == "cuda")


def check(name: str, x: torch.Tensor, dtype, shape, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def sm_count(dev: torch.device) -> int:
    """The device's number of SMs (the wrappers size their grids by it)."""
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SM_COUNT[dev]


def raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
