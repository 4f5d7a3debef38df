"""Analytic performance bounds (``PerfModel``) at the H100's peaks."""
from .analysis import HW_PEAK, LayerBound, PerfModel

__all__ = ["HW_PEAK", "LayerBound", "PerfModel"]
