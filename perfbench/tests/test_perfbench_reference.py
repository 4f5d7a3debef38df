"""The frozen reference against the port's plain twin, at reduced sizes."""
import pytest
import torch

from perfbench.harness import check, inputs, port
from perfbench.tests._cells import small


def _port_run(config, params, events, weight_bits, vmem_bits):
    from repro_torch import spidr

    target = spidr.DeployTarget(weight_bits=weight_bits, vmem_bits=vmem_bits, backend="torch")
    spec, weights = port.program(config, params)
    out = spidr.compile(spec, weights, target, device="cpu").run(events)
    return out.readout, out.spike_counts, out.input_counts


@pytest.mark.parametrize("workload", ["gesture-run", "flow-run"])
@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_reference_equals_plain_twin(workload, seed):
    """Rate (gesture) and Vmem (flow) readouts and every per-layer count agree."""
    config, mix = small(workload)
    params = inputs.make_weights(config, seed, "cpu")
    clips = inputs.make_clips(config, mix, 3, config["timesteps"], seed, "cpu")
    ref = check.run_reference(config, params, clips, 7, 4)
    readout, spikes, ins = _port_run(config, params, clips, 4, 7)
    last = max(ref["readouts"])
    assert torch.equal(readout.to(torch.int64), ref["readouts"][last].to(torch.int64))
    assert torch.equal(spikes.to(torch.int64), ref["out_counts"].sum(dim=2))
    assert torch.equal(ins.to(torch.int64), ref["in_counts"].sum(dim=2))
    assert int(ref["out_counts"].sum()) > 0, "the inputs make no spike: the check would be empty"


@pytest.mark.parametrize("workload", ["gesture-run", "flow-run"])
def test_reference_tells_precisions_apart(workload):
    """A 6/11-bit deployment equals the reference at 6/11 and differs from it at 4/7."""
    config, mix = small(workload)
    params = inputs.make_weights(config, 5, "cpu")
    clips = inputs.make_clips(config, mix, 3, config["timesteps"], 5, "cpu")
    readout, spikes, _ = _port_run(config, params, clips, 6, 11)
    at_6_11 = check.run_reference(config, params, clips, 11, 6)
    at_4_7 = check.run_reference(config, params, clips, 7, 4)
    last = max(at_6_11["readouts"])
    assert torch.equal(readout.to(torch.int64), at_6_11["readouts"][last].to(torch.int64))
    assert torch.equal(spikes.to(torch.int64), at_6_11["out_counts"].sum(dim=2))
    assert not (torch.equal(readout.to(torch.int64), at_4_7["readouts"][last].to(torch.int64))
                and torch.equal(spikes.to(torch.int64), at_4_7["out_counts"].sum(dim=2)))


def test_stream_prefixes_equal_whole_runs():
    """A readout the reference keeps at timestep t is that of the clip cut to t + 1."""
    config, mix = small("flow-serve")
    params = inputs.make_weights(config, 9, "cpu")
    clips = inputs.make_clips(config, mix, 2, 6, 9, "cpu")
    whole = check.run_reference(config, params, clips, 7, 4, readout_at=[2, 5])
    cut = check.run_reference(config, params, clips[:3], 7, 4)
    assert torch.equal(whole["readouts"][2], cut["readouts"][2])
    assert torch.equal(whole["out_counts"][:3], cut["out_counts"])
