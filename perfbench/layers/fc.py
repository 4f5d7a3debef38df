"""fc: a spiking fully connected layer, ``c_in`` -> ``c_out``, on its input
flattened in ``(h, w, c)`` order.  Weights ``(c_in, c_out)``."""


def weight_shape(layer: dict):
    return layer["c_in"], layer["c_out"]


def out_hw(layer: dict, hw: tuple) -> tuple:
    return hw


def gemm(layer: dict, hw: tuple):
    return 1, layer["c_in"], layer["c_out"]


def program(layer: dict, neuron, weight) -> list:
    from repro_torch.core.layers import SpikingDenseParams
    from repro_torch.core.network import SNNLayer

    return [(SNNLayer("fc", layer["c_in"], layer["c_out"], fc=SpikingDenseParams(neuron)),
             weight)]
