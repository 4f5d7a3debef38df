"""The general traffic generator: a mix's data file plus the seed -> work.

A mix's ``kind`` names the loop that drives it (``loops/<kind>.py``) and
the check that gives it its work (``checks/<kind>.py``).  The two kinds of
today draw their work here:

``closed_run``  one caller in a closed loop: the next ``CompiledSNN.run``
                starts when the last returned.  Batches of ``batch``
                distinct samples from a pool of ``pool`` seeded samples.
``open_serve``  independent cameras in an open loop: streams arrive by a
                Poisson process at ``rate`` streams/s whether or not the
                fleet keeps up; each is the first ``length`` frames of one
                of ``pool`` seeded clips.  An optional ``max_queue`` is
                the fleet's admission bound (the program's default
                otherwise).

Every seed gets the same amount of work, in another order: the pool's
samples are used equally often; a serve window offers the same number of
streams over the same span, their lengths and clips a balanced multiset,
the gaps between arrivals the quantiles of the exponential distribution at
the mix's rate, shuffled.  So seeds change which events flow and in what
order, not how much work a run does.
"""
from __future__ import annotations

import json

import numpy as np

from . import seeds
from .setup_env import ROOT

TRAFFIC_DIR = ROOT / "perfbench" / "traffic"


def load(name: str) -> dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def batches(traffic: dict, seed: int) -> list:
    """``pool`` batches of ``batch`` distinct pool indices, each index used
    ``batch`` times in all; calls cycle through them in this order."""
    pool, b = traffic["pool"], traffic["batch"]
    if not 1 <= b <= pool:
        raise ValueError(f"a batch of {b} distinct samples needs a pool of at least {b}")
    perm = seeds.rng(seed, seeds.ORDER).permutation(pool)
    return [tuple(int(perm[(j + i) % pool]) for i in range(b)) for j in range(pool)]


def schedule(traffic: dict, seed: int, seconds: float, rate: float = None) -> list:
    """Arrivals ``(due offset s, clip index, length)`` over ``seconds`` at
    ``rate`` (the mix's own by default), due in order.

    Every seed offers the same ``round(rate * seconds)`` streams over the
    same span: the first is due at 0, the gaps are the exponential's
    quantiles scaled to fill the window, the gap after the last arrival is
    always the median one, and the seed shuffles the other gaps, the
    lengths and the clips.
    """
    rate = float(traffic["rate"] if rate is None else rate)
    if rate <= 0:
        raise ValueError("an open_serve mix needs a rate > 0 (streams/s)")
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q)
    gaps *= seconds / gaps.sum()
    median = n // 2
    r = seeds.rng(seed, seeds.ORDER)
    inner = r.permutation(np.delete(gaps, median))
    due = np.concatenate([[0.0], np.cumsum(inner)])
    lengths = r.permutation(np.resize(np.asarray(traffic["lengths"]), n))
    clips = r.permutation(np.arange(n) % traffic["pool"])
    return [(float(d), int(c), int(l)) for d, c, l in zip(due, clips, lengths)]
