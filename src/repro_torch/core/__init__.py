"""Integer numerics, functional layers and network specs (torch)."""
from .layers import SpikingConvParams, SpikingDenseParams, im2col, maxpool2d
from .network import SNNLayer, SNNSpec, gesture_net, init_params, optical_flow_net
from .neuron import NeuronConfig, neuron_step_int
from .quant import (
    PRECISION_PAIRS,
    SUPPORTED_PRECISIONS,
    QuantSpec,
    dequantize,
    quantize,
    sat_add,
    saturate,
)
