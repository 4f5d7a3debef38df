"""Low-precision-weight matmul with in-kernel dequantization: wrapper of a
Hopper kernel (``csrc/quant_matmul.cu``).

``(x @ dequant(w_q)) * scale`` in float32, with weights stored at 8 bits
(int8, (K, N)) or 4 bits (two per byte along K, (K/2, N) uint8, even K
rows in the low nibble: ``pack_int4``) and a per-output-channel scale.  It
replaces the Pallas ``quant_matmul``.  The weights cross device memory at
their stored width and are dequantized inside the kernel.

For CPU tensors the wrapper returns the plain version
(``kernels.ref.quant_matmul_ref``); for CUDA tensors it launches the kernel
or raises.  :func:`plan` picks the regime from the shape: up to
``DECODE_MAX_M`` rows of x go to the streaming decode kernel (bound by the
weight bytes), more rows to the tiled kernel (bound by fp32 FMAs).
``block`` is accepted for signature parity and is not used.  A bfloat16
``x`` is taken in float32 (the reference casts it too).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import bind, check, count_launch, kernel_device, raise_on, sm_count
from .ref import pack_int4, quant_matmul_ref, unpack_int4

__all__ = ["DECODE_MAX_M", "DEFAULT_BLOCK", "TILED", "launch", "pack_int4", "plan",
           "quant_matmul", "unpack_int4"]

DEFAULT_BLOCK = (128, 128, 256)  # (bm, bn, bk), the reference's default

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, w, scale, out, M, N, K, mt, rpb, stream
    "spidr_quant_matmul_int8": [_P] * 4 + [_I] * 5 + [_P],
    "spidr_quant_matmul_int4": [_P] * 4 + [_I] * 5 + [_P],
}
DECODE_MAX_M = 16  # the decode kernel's largest row tile
TILED = (0, 0)     # the tiled kernel's regime
# The decode kernel (csrc/quant_matmul.cu): 64 fp32 accumulators and
# 64-byte load groups per thread, 2 blocks per SM, at most 8 K ranges per
# column block (one thread-block cluster, which adds their partials).
_ACC, _GROUP_BYTES, _BLOCKS_PER_SM, _MAX_SPLITS = 64, 64, 2, 8


@functools.lru_cache(maxsize=256)  # per launch, from a handful of shapes
def plan(m: int, k: int, n: int, bits: int, sms: int) -> tuple:
    """``(mt, rpb)`` for ``x (m, k) @ w (k, n)`` on a card with ``sms`` SMs.

    Above ``DECODE_MAX_M`` rows, :data:`TILED`: the tiled kernel.  Up to
    it, the decode kernel: ``mt`` (4, 8 or 16 >= m) rows of x, and weight
    rows (packed rows at 4 bits) in blocks of ``rpb``, a whole number of
    load groups; K is split into ``ceil(rows / rpb)`` ranges, at most 8, as
    many as one wave of ``_BLOCKS_PER_SM`` blocks per SM holds (a second,
    part-full wave would cost as much as the first).
    """
    if m > DECODE_MAX_M:
        return TILED
    mt = 4 if m <= 4 else 8 if m <= 8 else 16
    cpt = _ACC // mt                       # columns per thread
    group = _GROUP_BYTES // cpt            # weight rows per load group
    rows = k // (2 if bits == 4 else 1)    # packed rows at 4 bits
    col_blocks = -(-n // (32 * cpt))
    splits = max(1, min(_MAX_SPLITS, _BLOCKS_PER_SM * sms // col_blocks,
                        -(-rows // group)))
    return mt, -(-(-(-rows // splits)) // group) * group


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                 bits: int = 8, block: tuple = DEFAULT_BLOCK) -> torch.Tensor:
    """float32 ``(M, N)`` = ``(x @ dequant(w_q)) * scale``."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if x.ndim != 2 or w_q.ndim != 2 or scale.ndim != 1:
        raise ValueError(f"quant_matmul takes x (M, K), w_q 2-D, scale (N,); got "
                         f"{tuple(x.shape)}, {tuple(w_q.shape)}, {tuple(scale.shape)}")
    m, k = x.shape
    n = w_q.shape[1]
    k_w = w_q.shape[0] * (2 if bits == 4 else 1)
    if k_w != k or scale.shape[0] != n:
        raise ValueError(f"shapes do not fit: x {tuple(x.shape)}, w_q "
                         f"{tuple(w_q.shape)} ({bits}-bit), scale {tuple(scale.shape)}")
    dev = kernel_device("quant_matmul", x, w_q, scale)
    if dev is None:
        return quant_matmul_ref(x, w_q, scale, bits)
    return launch(x, w_q, scale, bits, plan(m, k, n, bits, sm_count(dev)))


def launch(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor, bits: int,
           regime: tuple) -> torch.Tensor:
    """Run the CUDA kernel with the regime ``(mt, rpb)`` of :func:`plan`
    (any regime valid for the shape, so a measurement can set it)."""
    dev = kernel_device("quant_matmul", x, w_q, scale)
    x = x.to(torch.float32).contiguous()
    m, k = x.shape
    n = w_q.shape[1]
    check("x", x, torch.float32, (m, k), dev)
    check("w_q", w_q, torch.int8 if bits == 8 else torch.uint8, w_q.shape, dev)
    check("scale", scale, torch.float32, (n,), dev)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    if k == 0:
        raise ValueError("quant_matmul needs K > 0")
    mt, rpb = regime
    name = f"quant_matmul_int{bits}"
    with torch.cuda.device(dev):
        err = bind("quant_matmul", _SIGNATURES)[f"spidr_{name}"](
            x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(), m, n, k,
            mt, rpb, torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, name)
    count_launch(name)
    return out
