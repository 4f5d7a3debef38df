"""Port parity, the quickstart: ``python -m repro_torch.launch.quickstart``
runs to its end on the CPU, and its mapping and energy numbers are the
JAX package's (``examples/quickstart.py`` steps 3-4) at the same sparsity.
"""
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from _torch_parity import assert_same, jax_ref  # noqa: F401
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.ref import spike_gemm_ref
from repro_torch.launch import quickstart

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke_run():
    before = dict(LAUNCHES)
    out = quickstart.run("cpu", smoke=True, log=lambda *a: None)
    assert LAUNCHES == before  # CPU tensors: no kernel launched
    return out


def test_quickstart_smoke_runs_to_its_end(smoke_run):
    out = smoke_run
    assert out["ok"] and out["verify_exact"]
    assert tuple(out["logits"].shape) == (2, 11)
    assert tuple(out["spike_counts"].shape) == (4, 6)
    assert float(out["spike_counts"].sum()) > 0
    assert [c["K"] for c in out["layer_checks"]] == [18, 144]
    assert all(c["M"] == 2 * 32 * 32 for c in out["layer_checks"])


def test_quickstart_mapping_and_energy_match_jax(jax_ref, smoke_run):
    out = smoke_run
    net_j = jax_ref.network.gesture_net()
    core_j = jax_ref.modes.CoreConfig(jax_ref.quant.QuantSpec(4))
    want = [jax_ref.modes.map_layer(s, core_j) for s in net_j.layer_shapes()]
    assert [dataclasses.asdict(m) for m in out["mapping"]] == \
        [dataclasses.asdict(m) for m in want]
    e, hw = jax_ref.energy, jax_ref.energy.HW(50e6, 0.9)
    s = out["sparsity"]
    assert out["energy"] == {"power_mw": e.power_mw(hw), "gops": e.gops(s, 4),
                             "tops_per_watt": e.tops_per_watt(s, 4, hw)}


def test_quickstart_forward_matches_jax(jax_ref, smoke_run):
    """Step 2's float forward equals the reference's run_snn on the same
    events and weights; step 6's cost equals the reference's."""
    out = smoke_run
    jnp = jax_ref.jnp
    net_j = dataclasses.replace(jax_ref.network.gesture_net(), input_hw=(32, 32),
                                timesteps=4)
    params_j = [None if p is None else jnp.asarray(p.numpy()) for p in out["params"]]
    logits_j, counts_j = jax_ref.network.run_snn(
        params_j, jnp.asarray(out["events"].numpy()), net_j,
        jax_ref.quant.QuantSpec(4), mode="train", record_spikes=True)
    assert_same(out["logits"], logits_j)  # rate counts: integers in float32
    assert_same(out["spike_counts"], counts_j)
    small_j = jax_ref.spidr_gesture.reduced(hw=(16, 16), timesteps=2)
    want = jax_ref.cost.estimate_cost(small_j, jax_ref.quant.QuantSpec(4),
                                      out["cost_counts"])
    assert out["cost"].makespan_cycles == want.makespan_cycles
    assert out["cost"].energy_uj == want.energy_uj


def test_quickstart_spike_matrices(smoke_run):
    """Step 5 runs on the real im2col of the events and of layer 1's spikes."""
    s1, s2 = smoke_run["spike_matrices"].values()
    assert s1.dtype == torch.int8 and tuple(s1.shape) == (2048, 18)
    assert tuple(s2.shape) == (2048, 144)
    assert 0 < int(s1.sum()) < s1.numel() and 0 < int(s2.sum()) < s2.numel()
    ev = smoke_run["events"][-1]
    assert int(s1.sum()) == int(spike_gemm_ref(s1, torch.ones((18, 1),
                                                              dtype=torch.int8)).sum())
    assert int(s1.sum()) <= 9 * int(ev.sum())


def test_quickstart_cli_cpu_smoke():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.quickstart",
                        "--device", "cpu", "--smoke"], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "round-trip parity proof: exact=True" in r.stdout
    assert "layer mapping" in r.stdout and "TOPS/W" in r.stdout


def test_quickstart_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        quickstart.run(log=lambda *a: None)
