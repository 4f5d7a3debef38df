"""RWKV6 chunked wkv: wrapper of a Hopper kernel (``csrc/wkv_chunk.cu``).

Replaces the Pallas ``wkv_chunk`` and the ``wkv_sequence`` scan around it.
One launch covers the whole sequence (the reference launches once per
chunk): a thread-block cluster per (batch, head) computes its chunks'
intra-chunk terms in parallel and passes only the (N, N) state chain
between its blocks, through distributed shared memory.  :func:`plan`
sizes the cluster and the chunks per block; it is pure, and the CPU tests
check it.

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
from typing import NamedTuple

import torch

from ._build import bind, check, count_launch, kernel_device, raise_on, sm_count
from .ref import wkv_chunk_ref, wkv_sequence_ref

__all__ = ["Plan", "plan", "smem_bytes", "wkv_chunk", "wkv_sequence"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # r, k, v, lw, u, s0, y, s1, B, S, H, N, C, u_bstride, cluster,
    # per_block, stream
    "spidr_wkv_sequence": [_P] * 8 + [_I] * 8 + [_P],
    "spidr_wkv_smem": [_I] * 3,  # C, N, per_block
}
#: The chunk lengths and head sizes the kernel is built for (template
#: instances of ``csrc/wkv_chunk.cu``).
SIZES = (8, 16, 32, 64)
MAX_CLUSTER = 8  # blocks per (b, h): a portable thread-block cluster
PER_BLOCK = 2    # the most chunks a block owns per window


class Plan(NamedTuple):
    """How one ``wkv_sequence`` call launches: ``cluster`` blocks per
    (b, h), each owning ``per_block`` chunks of every window of
    ``cluster * per_block`` chunks; ``windows`` such windows cover the
    sequence, one after another; grid (cluster, H, B); ``smem`` bytes of
    dynamic shared memory per block."""
    cluster: int
    per_block: int
    windows: int
    smem: int


def smem_bytes(chunk: int, n: int, per_block: int) -> int:
    """The kernel's shared memory (``Layout`` in ``csrc/wkv_chunk.cu``):
    r, r', k, lw_excl, lw_incl and the per-chunk r'' at row stride N + 4;
    Q, k' and v at N + 8; the (C, C + 4) decay matrix; T at (N, N + 8);
    u, d and D."""
    na, nb = n + 4, n + 8
    floats = (5 * chunk * na + 3 * chunk * nb + chunk * (chunk + 4) + n * nb
              + 3 * n + per_block * chunk * na)
    return 4 * floats


def plan(b: int, s: int, h: int, chunk: int, n: int, sms: int) -> Plan:
    """The cluster is the largest power of two up to 8 that has a chunk for
    every block and keeps the grid (B H cluster blocks, one per SM) within
    one wave of ``sms``; each block takes up to two chunks per window, and
    a longer sequence runs in several windows.  A block's fixed costs (the
    loads, the exchange) are paid once per window, so once the card is full
    fewer, longer-lived blocks win (rwkv6-7b, C=32: B=1 S=64, 2 blocks of
    one chunk per head; B=1 S=512, 2 blocks of two chunks, four windows;
    B=4, one block per head)."""
    nc = s // chunk
    cluster = 1
    while (cluster * 2 <= min(MAX_CLUSTER, nc)
           and b * h * cluster * 2 <= max(sms, b * h)):
        cluster *= 2
    per_block = min(PER_BLOCK, -(-nc // cluster))
    windows = -(-nc // (cluster * per_block))
    return Plan(cluster, per_block, windows, smem_bytes(chunk, n, per_block))


def _launch(dev, r, k, v, lw, u, s0, b, s, h, n, chunk, u_bstride):
    if chunk not in SIZES or n not in SIZES:
        raise ValueError(f"the CUDA wkv kernel takes chunk and head size in {SIZES}, "
                         f"got chunk {chunk}, head size {n}")
    y = torch.empty((b, s, h, n), dtype=torch.float32, device=dev)
    s1 = torch.empty((b, h, n, n), dtype=torch.float32, device=dev)
    p = plan(b, s, h, chunk, n, sm_count(dev))
    # 16-byte loads and stores: a view that starts off 16 bytes is copied.
    r, k, v, lw, s0 = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (r, k, v, lw, s0))
    with torch.cuda.device(dev):
        err = bind("wkv_chunk", _SIGNATURES)["spidr_wkv_sequence"](
            r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(), u.data_ptr(),
            s0.data_ptr(), y.data_ptr(), s1.data_ptr(), b, s, h, n, chunk,
            u_bstride, p.cluster, p.per_block, torch.cuda.current_stream(dev).cuda_stream)
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
