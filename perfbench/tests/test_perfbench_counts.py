"""The frozen operation and byte counts against shapes worked by hand."""
import json

import pytest
import torch

from perfbench.harness import check, roofline, setup_env


def _config(name):
    return json.loads((setup_env.ROOT / "perfbench" / "configs" / f"{name}.json").read_text())


def test_b1_bytes_and_bound_of_the_flow_middle_layer():
    # B = 2 at 288 x 384: M = 221184 rows, K = 3*3*32 = 288, N = 32.
    m, k, n = 221184, 288, 32
    want = m * k + k * n + 4 * m * n + 4 * m * n + 4 * m * n
    assert roofline.lif_gemm_bytes(m, k, n) == want == 148_644_864
    assert roofline.lif_gemm_bytes(m, k, n, per_channel_thr=True) == want + 4 * n
    # B2 slab of 5 steps: spikes and both outputs per step, weights and Vmem in once.
    assert roofline.lif_gemm_bytes(m, k, n, t=5) == 5 * m * k + k * n + 4 * m * n + 40 * m * n
    # Bytes bound it: 148.6 MB at 3.35 TB/s is 44.4 us; even dense operations are 2.1 us.
    assert roofline.bound_s(want, roofline.lif_gemm_ops(m * k, n)) == pytest.approx(44.372e-6, rel=1e-4)
    assert roofline.lif_gemm_ops(1000, 32) == 64_000


def test_layer_shapes_and_dense_operations():
    g = roofline.layer_gemms(_config("gesture"))
    assert g == [("conv", 4096, 18, 16), ("conv", 4096, 144, 16), ("conv", 4096, 144, 16),
                 ("conv", 1024, 144, 16), ("conv", 1024, 144, 16), ("fc", 1, 64, 11)]
    per_step = 2 * (4096 * 18 * 16 + 2 * 4096 * 144 * 16 + 2 * 1024 * 144 * 16 + 64 * 11)
    assert roofline.dense_ops_per_sample(_config("gesture"), 20) == 20 * per_step == 990_932_480
    f = roofline.layer_gemms(_config("optical_flow"))
    assert f == [("conv", 110592, 18, 32)] + [("conv", 110592, 288, 32)] * 6 \
        + [("conv", 110592, 288, 2)]
    assert roofline.dense_ops_per_sample(_config("optical_flow"), 10) == \
        10 * 2 * 110592 * (18 * 32 + 6 * 288 * 32 + 288 * 2) == 124_853_944_320


def test_reference_counts_spike_matrix_nonzeros_by_hand():
    """One spike at a corner lands in 4 rows of the 3x3 spike matrix, one inside in 9."""
    config = {"input_hw": [5, 6], "in_channels": 1, "readout": "vmem",
              "reference": "snn_int", "neuron": {"model": "if", "reset": "soft",
                                                "threshold": 0.5, "leak_shift": 0},
              "layers": [{"kind": "conv", "c_in": 1, "c_out": 3, "kernel": 3, "stride": 1,
                          "padding": 1}]}
    params = [torch.linspace(-1, 1, 27).reshape(9, 3)]
    clips = torch.zeros((2, 2, 5, 6, 1), dtype=torch.int8)
    clips[0, 0, 0, 0, 0] = 1          # corner
    clips[1, 0, 2, 3, 0] = 1          # inside
    clips[1, 1, 0, 3, 0] = 1          # edge: 6 rows
    out = check.run_reference(config, params, clips, 7, 4)
    assert out["cols_nnz"][:, 0, :].tolist() == [[4, 0], [9, 6]]
    assert out["in_counts"][:, 0, :].tolist() == [[1, 0], [1, 1]]
