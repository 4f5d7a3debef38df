"""A whole run with the timed path broken underneath reads ``correct: false``.

Each cell is driven as a run drives it, past the look for a card, at a
small size on the CPU, once sound and once with each fault the cell can
have planted in the program: a layer step that returns its state
unchanged, half of the batch (or of the slots) left out, and an answer
altered where it is produced.  The cells run on one chip, so there is no
exchange between chips to leave out.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from perfbench.tests._cells import run_small

RUN_CELLS = ["flow-run", "gesture-run"]
SERVE_CELLS = ["gesture-serve", "flow-serve"]


@pytest.mark.parametrize("workload", RUN_CELLS + SERVE_CELLS)
def test_sound_run_is_correct(workload):
    result, table = run_small(workload)
    assert result["correct"], table
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "check"


@pytest.mark.parametrize("workload", RUN_CELLS + SERVE_CELLS)
def test_state_left_unchanged_is_caught(workload, monkeypatch):
    from repro_torch.engine import inference

    monkeypatch.setattr(inference, "_layer_update",
                        lambda el, s2, v2, cfg: (v2.clone(), torch.zeros_like(v2)))
    result, _ = run_small(workload)
    assert result["correct"] is False


@pytest.mark.parametrize("workload", RUN_CELLS)
def test_half_batch_left_out_is_caught(workload, monkeypatch):
    from repro_torch.spidr import compiled

    real = compiled.run_engine

    def half(engine, events, *a, **k):
        out = real(engine, events[:, : events.shape[1] // 2], *a, **k)
        return dataclasses.replace(out, readout=torch.cat([out.readout, out.readout]),
                                   spike_counts=2 * out.spike_counts,
                                   input_counts=2 * out.input_counts)

    monkeypatch.setattr(compiled, "run_engine", half)
    result, _ = run_small(workload)
    assert result["correct"] is False


@pytest.mark.parametrize("workload", SERVE_CELLS)
def test_half_the_slots_left_out_is_caught(workload, monkeypatch):
    from repro_torch.engine.streaming import StreamSessionManager

    real = StreamSessionManager._pack

    def half(self, chunks):
        ev, valid, ending = real(self, chunks)
        ev[:, self.capacity // 2:] = 0
        return ev, valid, ending

    monkeypatch.setattr(StreamSessionManager, "_pack", half)
    # A burst of 48 streams fills every slot and stays under the fleet's
    # admission bound of 64 waiting, so none is shed.
    result, _ = run_small(workload, seconds=0.12, rate=400)
    assert result["correct"] is False


@pytest.mark.parametrize("workload", RUN_CELLS)
def test_altered_answer_is_caught(workload, monkeypatch):
    from repro_torch.spidr import compiled

    real = compiled.run_engine

    def altered(*a, **k):
        out = real(*a, **k)
        out.readout.view(-1)[0] += 1
        return out

    monkeypatch.setattr(compiled, "run_engine", altered)
    result, table = run_small(workload)
    assert result["correct"] is False and table["readout_mismatch"]["value"] > 0


@pytest.mark.parametrize("workload", SERVE_CELLS)
def test_altered_stream_answer_is_caught(workload, monkeypatch):
    from repro_torch.engine.streaming import StreamSessionManager

    real = StreamSessionManager.step

    def altered(self, chunks):
        updates = real(self, chunks)
        for up in updates.values():
            up.readout = np.array(up.readout, copy=True)
            up.readout.reshape(-1)[0] += 1
            break
        return updates

    monkeypatch.setattr(StreamSessionManager, "step", altered)
    result, table = run_small(workload)
    assert result["correct"] is False and table["readout_mismatch"]["value"] > 0


def _serve_record(late_ms, shed):
    """100 streams of 10 steps due at 0, finished ``late_ms`` later; ``shed`` not admitted."""
    from perfbench.harness import found

    offered = []
    for i, ms in enumerate(late_ms):
        h = None if i in shed else types.SimpleNamespace(
            done=True, request=types.SimpleNamespace(done_at=ms / 1e3))
        offered.append((0.0, i, 10, h))
    return found.module("loops", "open_serve").ServeRecord(0.0, 1.0, offered, [], [], [], True)


def test_shed_streams_count_in_the_tail():
    """A shed stream is infinitely late: shedding the fastest five of 100 raises
    the tail (96 ms over the rest alone, 100 ms over all); a sixth leaves it
    unbounded, and the run reports no tail at all."""
    from perfbench.harness import cell, found

    loop = found.module("loops", "open_serve")
    wanted = [{"name": "stream_ms_p95", "unit": "ms"}, {"name": "stream_steps_per_s",
                                                         "unit": "steps/s"}]
    late = list(range(1, 101))
    out = cell._end_to_end(loop, _serve_record(late, set()), {}, wanted, 1.0)
    assert out["stream_ms_p95"]["value"] == pytest.approx(95.0)
    assert out["stream_steps_per_s"]["value"] == pytest.approx(1000 / 0.1)
    out = cell._end_to_end(loop, _serve_record(late, set(range(5))), {}, wanted, 1.0)
    assert out["stream_ms_p95"]["value"] == pytest.approx(100.0)
    assert out["stream_steps_per_s"]["value"] == pytest.approx(950 / 0.1)
    with pytest.raises(cell.CellError, match="stream_ms_p95 is unbounded"):
        cell._end_to_end(loop, _serve_record(late, set(range(6))), {}, wanted, 1.0)


class _SlowFleet:
    """A fleet whose tick takes ``tick_s``; admits ``max_queue`` waiting streams."""

    def __init__(self, tick_s, max_queue):
        self.tick_s, self.max_queue, self.queue = tick_s, max_queue, []

    @property
    def queue_depth(self):
        return len(self.queue)

    def submit(self, events):
        if len(self.queue) >= self.max_queue:
            raise OverflowError
        h = types.SimpleNamespace(done=False)
        self.queue.append(h)
        return h

    def step(self):
        import time

        time.sleep(self.tick_s)
        if self.queue:
            self.queue.pop(0).done = True


def test_every_scheduled_stream_is_offered_and_none_shed():
    """A tick that overruns the window's end still offers the streams due
    before it, and an admission bound that holds the whole schedule sheds
    none: every run offers, and finishes, the same work."""
    from perfbench.harness import found, traffic
    from perfbench.harness.trace import annotate

    mix = {"rate": 60, "lengths": [1], "pool": 2}
    sched = traffic.schedule(mix, 7, 0.5)
    clips = np.zeros((2, 1))
    rec = found.module("loops", "open_serve").drive(
        _SlowFleet(0.2, len(sched)), clips, sched, 0.5, annotate(None), OverflowError,
        drain_s=30.0)
    assert len(rec.offered) == len(sched) == 30
    assert all(h is not None and h.done for *_, h in rec.offered) and rec.drained
