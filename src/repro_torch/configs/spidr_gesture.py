"""The paper's gesture-recognition SNN (Table II)."""
import dataclasses

from ..core.network import SNNSpec, gesture_net

CONFIG = gesture_net()


def reduced(hw: tuple = (32, 32), timesteps: int = 6) -> SNNSpec:
    """CPU-sized variant: same topology, smaller frames, fewer timesteps.

    Two stride-2 pools then an adaptive pool to 2x2 need ``hw`` divisible
    by 8 (the FC fan-in is fixed by the adaptive pool).
    """
    if hw[0] % 8 or hw[1] % 8:
        raise ValueError(f"hw must be multiples of 8: {hw}")
    return dataclasses.replace(CONFIG, input_hw=tuple(hw), timesteps=timesteps)
