"""adaptive_pool: max pooling of the spike planes to ``target_hw`` x
``target_hw``.  No weights, no GEMM."""


def weight_shape(layer: dict):
    return None


def out_hw(layer: dict, hw: tuple) -> tuple:
    return layer["target_hw"], layer["target_hw"]


def gemm(layer: dict, hw: tuple):
    return None


def program(layer: dict, neuron, weight) -> list:
    from repro_torch.core.network import SNNLayer

    return [(SNNLayer("adaptive_pool", target_hw=layer["target_hw"]), weight)]
