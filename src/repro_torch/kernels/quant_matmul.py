"""Low-precision-weight matmul with in-kernel dequantization: wrapper of a
Hopper kernel (``csrc/quant_matmul.cu``).

``(x @ dequant(w_q)) * scale`` in float32, with weights stored at 8 bits
(int8, (K, N)) or 4 bits (two per byte along K, (K/2, N) uint8, even K
rows in the low nibble: ``pack_int4``) and a per-output-channel scale.  It
replaces the Pallas ``quant_matmul``.  The weights cross device memory at
their stored width and are dequantized inside the kernel.

For CPU tensors the wrapper returns the plain version
(``kernels.ref.quant_matmul_ref``); for CUDA tensors it launches the kernel
or raises.  When the 64x64 output tiles are too few to keep the card's
memory busy (a decode batch), the wrapper splits K into ranges and the
kernel adds their partials in order in a second pass.  ``block`` is
accepted for signature parity and is not used: the CUDA tile is fixed
(64x64 outputs, 64-deep k tiles).  A bfloat16 ``x`` is taken in float32
(the reference casts it too).
"""
from __future__ import annotations

import ctypes

import torch

from ._build import bind, check, count_launch, kernel_device, raise_on, sm_count
from .ref import pack_int4, quant_matmul_ref, unpack_int4

__all__ = ["DEFAULT_BLOCK", "pack_int4", "quant_matmul", "unpack_int4"]

DEFAULT_BLOCK = (128, 128, 256)  # (bm, bn, bk), the reference's default

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, w, scale, out, part, M, N, K, ksplit, stream
    "spidr_quant_matmul_int8": [_P] * 5 + [_I] * 4 + [_P],
    "spidr_quant_matmul_int4": [_P] * 5 + [_I] * 4 + [_P],
}
_TILE = 64            # the kernel's output tile (square) and k-tile depth
_BLOCKS_PER_SM = 8    # split K until the grid has this many blocks per SM


def _ksplit(dev: torch.device, m: int, n: int, k: int) -> int:
    """K ranges per output tile: doubled while the grid has fewer than
    ``_BLOCKS_PER_SM`` blocks per SM, at most one range per k-tile."""
    tiles = -(-m // _TILE) * -(-n // _TILE)
    ks = 1
    while tiles * ks < _BLOCKS_PER_SM * sm_count(dev) and 2 * ks * _TILE <= k:
        ks *= 2
    return ks


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
    x = x.to(torch.float32).contiguous()
    check("x", x, torch.float32, (m, k), dev)
    check("w_q", w_q, torch.int8 if bits == 8 else torch.uint8, w_q.shape, dev)
    check("scale", scale, torch.float32, (n,), dev)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    if k == 0:
        raise ValueError("quant_matmul needs K > 0")
    name = f"quant_matmul_int{bits}"
    ks = _ksplit(dev, m, n, k)
    part = torch.empty((ks, m, n), dtype=torch.float32, device=dev) if ks > 1 else None
    with torch.cuda.device(dev):
        err = bind("quant_matmul", _SIGNATURES)[f"spidr_{name}"](
            x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), m, n, k, ks,
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, name)
    count_launch(name)
    return out
