"""Runtime support: the stream worker's watchdog and rewind-and-replay."""
from .fault_tolerance import (RestartableFailure, StepWatchdog, StragglerDetector,
                              StragglerStats, retrying)

__all__ = ["RestartableFailure", "StepWatchdog", "StragglerDetector",
           "StragglerStats", "retrying"]
