"""RWKV6 chunked wkv: wrapper of a Hopper kernel (``csrc/wkv_chunk.cu``).

Replaces the Pallas ``wkv_chunk`` and the ``wkv_sequence`` scan around it.
The CUDA kernel loops over every chunk of the sequence inside one launch,
carrying the (N, N) state per head in shared memory, so a layer's prefill
is one launch (the reference launches once per chunk).

    wkv_sequence(r, k, v, lw, u, s0, chunk)   r/k/v/lw (B, S, H, N), u (H, N),
                                              s0 (B, H, N, N)
    wkv_chunk(r, k, v, lw, u, s0)             one chunk, the TPU kernel's own
                                              signature: (BH, C, N), u (BH, 1, N)

For CPU tensors each function returns its plain version (``kernels.ref``);
for CUDA tensors it launches the kernel or raises.  Both launch the same
kernel and count under ``LAUNCHES["wkv_sequence"]``.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import bind, check, count_launch, kernel_device, raise_on, sm_count
from .ref import wkv_chunk_ref, wkv_sequence_ref

__all__ = ["wkv_chunk", "wkv_sequence"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # r, k, v, lw, u, s0, y, s1, B, S, H, N, C, u_bstride, nsplit, stream
    "spidr_wkv_sequence": [_P] * 8 + [_I] * 7 + [_P],
}
#: The chunk lengths and head sizes the kernel is built for (template
#: instances of ``csrc/wkv_chunk.cu``).
SIZES = (8, 16, 32, 64)


def _nsplit(dev: torch.device, blocks: int, n: int) -> int:
    """Value-column slices per head: the most (4, 2 or 1) that still fit
    one block per SM, so a small batch fills the card; each slice
    recomputes the chunk's decay matrix."""
    for ns in (4, 2):
        if n % ns == 0 and blocks * ns <= sm_count(dev):
            return ns
    return 1


def _launch(dev, r, k, v, lw, u, s0, b, s, h, n, chunk, u_bstride):
    if chunk not in SIZES or n not in SIZES:
        raise ValueError(f"the CUDA wkv kernel takes chunk and head size in {SIZES}, "
                         f"got chunk {chunk}, head size {n}")
    y = torch.empty((b, s, h, n), dtype=torch.float32, device=dev)
    s1 = torch.empty((b, h, n, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = bind("wkv_chunk", _SIGNATURES)["spidr_wkv_sequence"](
            r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(), u.data_ptr(),
            s0.data_ptr(), y.data_ptr(), s1.data_ptr(), b, s, h, n, chunk,
            u_bstride, _nsplit(dev, b * h, n), torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "wkv_sequence")
    count_launch("wkv_sequence")
    return y, s1


def wkv_sequence(r, k, v, lw, u, s0, chunk: int = 32):
    """RWKV6 wkv over a sequence -> (y (B, S, H, N), s_final (B, H, N, N)).

    r/k/v/lw (B, S, H, N) float32 with S a multiple of ``chunk``; u (H, N);
    s0 (B, H, N, N).  The caller pads a ragged sequence (``rwkv6_time_mix``).
    """
    b, s, h, n = r.shape
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of chunk {chunk}")
    dev = kernel_device("wkv_sequence", r, k, v, lw, u, s0)
    if dev is None:
        return wkv_sequence_ref(r, k, v, lw, u, s0, chunk)
    f32 = torch.float32
    for name, t in (("r", r), ("k", k), ("v", v), ("lw", lw)):
        check(name, t, f32, (b, s, h, n), dev)
    check("u", u, f32, (h, n), dev)
    check("s0", s0, f32, (b, h, n, n), dev)
    return _launch(dev, r, k, v, lw, u, s0, b, s, h, n, chunk, 0)


def wkv_chunk(r, k, v, lw, u, s0):
    """One chunk for every (batch, head) row -> (y (BH, C, N), s1 (BH, N, N)).

    r/k/v/lw (BH, C, N) float32; u (BH, 1, N); s0 (BH, N, N).
    """
    bh, c, n = r.shape
    dev = kernel_device("wkv_chunk", r, k, v, lw, u, s0)
    if dev is None:
        return wkv_chunk_ref(r, k, v, lw, u, s0)
    f32 = torch.float32
    for name, t in (("r", r), ("k", k), ("v", v), ("lw", lw)):
        check(name, t, f32, (bh, c, n), dev)
    check("u", u, f32, (bh, 1, n), dev)
    check("s0", s0, f32, (bh, n, n), dev)
    # (BH, C, N) is the sequence layout with B = BH, S = C, H = 1; each row
    # has its own bonus (u_bstride = N).
    y, s1 = _launch(dev, r, k, v, lw, u, s0, bh, c, 1, n, c, n)
    return y.reshape(bh, c, n), s1.reshape(bh, n, n)
