"""Small cells: the configured networks on frames and timesteps a CPU test holds."""
import copy
import time

from perfbench.harness import cell

# Sizes at which a whole run fits a CPU test: the networks' widths and
# depths as configured, smaller frames and fewer timesteps.
SMALL_HW = {"gesture": [16, 16], "flow": [16, 24]}
SMALL_T = {"gesture": 4, "flow": 3}


def small(workload: str, **traffic):
    """``(config, traffic)`` of a cell cut to a CPU test's size."""
    c = cell.resolve(cell.load_benchmark(), workload)
    config, mix = copy.deepcopy(c["config"]), copy.deepcopy(c["traffic"])
    config["input_hw"] = SMALL_HW[config["events"]]
    config["timesteps"] = SMALL_T[config["events"]]
    if mix["kind"] == "open_serve":
        # Well below what a CPU serves, so every stream finishes.
        mix.update(rate=40 if config["events"] == "gesture" else 10, pool=8, capacity=4)
        mix["lengths"] = [mix["chunk_T"], 2 * mix["chunk_T"]]
    mix.update(traffic)
    return config, mix


def run_small(workload: str, seconds: float = 1.0, trace: bool = False, seed: int = 4242,
              **traffic):
    """A whole run of a small cell on the CPU: ``(result, check table)``."""
    config, mix = small(workload, **traffic)
    return cell.run_cell(workload, seed, seconds, trace, t_proc=time.monotonic(),
                         device="cpu", config=config, traffic=mix, log=lambda m: None)
