"""stream_ms_p95.serve: the 95th percentile over every stream offered in the
window, from its due time on the open-loop schedule to its readout on the
host, as the loop of the mix's kind reads it (ms).  gesture-serve's tail:
its runs on a shared host spread by more than half of the largest bound an
end-to-end metric may have, so it is read here, in the traced run, and the
cell is held end to end to ``streams_per_s``.  Nothing where the loop reads
no tail, or where a stream was shed or never finished (that run is already
not correct)."""
import math

from perfbench.harness import found


def read(ctx):
    value = found.module("loops", ctx.kind).end_to_end(ctx.record, ctx.traffic).get(
        "stream_ms_p95")
    return value if value is not None and math.isfinite(value) else None
