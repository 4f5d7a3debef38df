"""launches_per_sample.run: the program's kernel launches over the window
(kernels.LAUNCHES, all entry points) per sample the window completed."""
from perfbench.metrics._shared import samples_in_window


def read(ctx):
    if ctx.kind != "closed_run":
        return None
    n = samples_in_window(ctx)
    return ctx.launches / n if n else None
