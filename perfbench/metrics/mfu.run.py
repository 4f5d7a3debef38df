"""mfu.run: the whole network's dense int8 operations (2 M K N per weight
layer per timestep per sample, whatever implements it) for the samples the
traced window completed, over the window's seconds at the H100's 1,979
TOP/s int8 peak (%)."""
from perfbench.harness import roofline
from perfbench.metrics._shared import samples_in_window


def read(ctx):
    t = ctx.trace
    if ctx.kind != "closed_run" or t is None or t.window_s <= 0:
        return None
    ops = roofline.dense_ops_per_sample(ctx.config, ctx.config["timesteps"])
    return 100.0 * ops * samples_in_window(ctx) / (t.window_s * roofline.INT8_OPS_PER_S)
