"""conv: a spiking ``kernel`` x ``kernel`` convolution, ``c_in`` -> ``c_out``.

Weights ``(kernel * kernel * c_in, c_out)``: the program's im2col fan-in
order ``(kh, kw, c_in)``.  One GEMM per timestep over every output
position.
"""


def weight_shape(layer: dict):
    return layer["kernel"] * layer["kernel"] * layer["c_in"], layer["c_out"]


def out_hw(layer: dict, hw: tuple) -> tuple:
    k, p, s = layer["kernel"], layer["padding"], layer["stride"]
    return tuple((x + 2 * p - k) // s + 1 for x in hw)


def gemm(layer: dict, hw: tuple):
    h, w = out_hw(layer, hw)
    return h * w, layer["kernel"] * layer["kernel"] * layer["c_in"], layer["c_out"]


def program(layer: dict, neuron, weight) -> list:
    from repro_torch.core.layers import SpikingConvParams
    from repro_torch.core.network import SNNLayer

    return [(SNNLayer("conv", layer["c_in"], layer["c_out"], conv=SpikingConvParams(
        layer["kernel"], layer["kernel"], layer["stride"], layer["padding"], neuron)), weight)]
