"""Runtime support: the watchdog, rewind-and-replay, and the fault-tolerant
training loop."""
from .fault_tolerance import (RestartableFailure, StepWatchdog, StragglerDetector,
                              StragglerStats, retrying)
from .loop import LoopConfig, TrainingLoop

__all__ = ["LoopConfig", "RestartableFailure", "StepWatchdog", "StragglerDetector",
           "StragglerStats", "TrainingLoop", "retrying"]
