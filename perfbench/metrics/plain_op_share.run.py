"""plain_op_share.run: device time of operations that are not the program's
own CUDA kernels (PyTorch's copies, reductions, casts, pads, sets and
memory copies: im2col, pooling, counts, cat) over all device time inside
the traced window (%)."""
from perfbench.metrics._shared import port_matcher


def read(ctx):
    t = ctx.trace
    if ctx.kind != "closed_run" or t is None or not t.device_ops:
        return None
    is_port = port_matcher(ctx)
    total = plain = 0
    for s, e, name in t.device_ops:
        total += e - s
        if is_port is None or not is_port(name):
            plain += e - s
    return 100.0 * plain / total if total else None
