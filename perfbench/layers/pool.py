"""pool: ``window`` x ``window`` max pooling of the spike planes, stride
``window``.  No weights, no GEMM; the program pools 2x2 windows only."""


def weight_shape(layer: dict):
    return None


def out_hw(layer: dict, hw: tuple) -> tuple:
    return tuple(x // layer["window"] for x in hw)


def gemm(layer: dict, hw: tuple):
    return None


def program(layer: dict, neuron, weight) -> list:
    from repro_torch.core.network import SNNLayer

    if layer["window"] != 2:
        raise ValueError("the program pools 2x2 windows only")
    return [(SNNLayer("pool"), weight)]
