"""lif_gemm_roofline.run: B1 (the fused integer spike-GEMM + neuron step,
``kernels/fused_lif_gemm.py`` -> ``csrc/fused_lif_gemm.cu``) against its
roofline, over every launch of the traced window (%).

Sum over launches of each launch's bound, over the sum of their profiled
device times.  A call of ``CompiledSNN.run`` launches B1 once per weight
layer per timestep, timestep-major, and calls run one after the other, so
the reader takes the profile's B1 launches in device order, calls x
timesteps x weight layers of them, and gives each its call, timestep and
layer.  Each launch's bound is ``roofline.bound_s`` of the bytes its
shapes move and the operations the spikes of these inputs need (the
reference's count of the spike matrix's nonzeros for the call's samples).
A profile whose B1 launches do not number that (another path, such as B2
slabs) leaves the metric out.
"""
from perfbench.harness import roofline
from perfbench.metrics._shared import port_matcher

B1_KERNELS = ("lif_gemm_tc_kernel", "fused_lif_gemm_int_tblk_kernel")


def read(ctx):
    t = ctx.trace
    if ctx.kind != "closed_run" or t is None:
        return None
    match = port_matcher(ctx, sources=("fused_lif_gemm",), names=B1_KERNELS)
    if match is None:
        return None
    launches = [(s, e) for s, e, name in t.profiled if match(name)]
    gemms = roofline.layer_gemms(ctx.config)
    n_layers, steps = len(gemms), ctx.config["timesteps"]
    per_call = steps * n_layers
    calls = ctx.record.calls
    if not calls or len(launches) != len(calls) * per_call:
        return None
    nnz = ctx.ref["cols_nnz"]                      # (T, L, pool)
    bound = busy = 0.0
    for i, (s, e) in enumerate(launches):
        c, k = divmod(i, per_call)
        step, layer = divmod(k, n_layers)
        idx = list(ctx.batches[calls[c][0]])
        _, m, fan_in, n = gemms[layer]
        ops = roofline.lif_gemm_ops(int(nnz[step, layer, idx].sum()), n)
        bound += roofline.bound_s(roofline.lif_gemm_bytes(len(idx) * m, fan_in, n), ops)
        busy += (e - s) / 1e9
    return 100.0 * bound / busy if busy else None
