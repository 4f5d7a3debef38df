"""The paper's optical-flow SNN (Table II)."""
import dataclasses

from ..core.network import SNNSpec, optical_flow_net

CONFIG = optical_flow_net()


def reduced(hw: tuple = (24, 32), timesteps: int = 4) -> SNNSpec:
    """CPU-sized variant: the all-conv stack is shape-agnostic, so only the
    frame size and timestep count shrink."""
    return dataclasses.replace(CONFIG, input_hw=tuple(hw), timesteps=timesteps)
