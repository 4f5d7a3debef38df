"""Port parity, export and checkpoints: core.quant's power-of-two
quantizers, snn.export, checkpoint and spidr.save/load against the JAX
package's.

Quantized integers and scales are compared exactly (tolerance 0),
including ratios at exactly a power of two and one and two ulps either
side of it.  A ``CompiledSNN.save`` of either package loads in the other
and runs bit-exact with the original.
"""
import json
import os
import zlib

import numpy as np
import pytest
import torch

from _torch_parity import assert_same, cuda_device, jax_ref  # noqa: F401
from repro_torch import spidr
from repro_torch.checkpoint import FORMAT_VERSION, CheckpointError, Checkpointer
from repro_torch.configs import spidr_gesture, spidr_optflow
from repro_torch.convert import params_from_jax
from repro_torch.core import quant
from repro_torch.core.network import init_params
from repro_torch.core.quant import QuantSpec
from repro_torch.engine import inference as E
from repro_torch.snn import export
from repro_torch.snn.data import make_flow_batch

HW, T = (16, 16), 3
NETS = ("gesture", "flow")
BITS = (4, 6, 8)


def _specs(jax_ref, net):
    if net == "gesture":
        return (spidr_gesture.reduced(hw=HW, timesteps=T),
                jax_ref.spidr_gesture.reduced(hw=HW, timesteps=T))
    return (spidr_optflow.reduced(hw=HW, timesteps=T),
            jax_ref.spidr_optflow.reduced(hw=HW, timesteps=T))


def _params(jax_ref, net):
    _, spec_j = _specs(jax_ref, net)
    return [None if p is None else np.asarray(p)
            for p in jax_ref.network.init_params(jax_ref.jax.random.PRNGKey(0), spec_j)]


def _events(batch=2, seed=0):
    rng = np.random.default_rng([seed, batch])
    return (rng.random((T, batch) + HW + (2,)) < 0.25).astype(np.float32)


def _near_powers_of_two(bits, lo, hi) -> np.ndarray:
    """Per channel: amax at exactly w_max * 2**k and 1-2 ulps either side."""
    cols = []
    for k in range(lo, hi):
        base = np.float32(2.0 ** k * QuantSpec(bits).w_max)
        down = np.nextafter(base, np.float32(0))
        up = np.nextafter(base, np.float32(np.inf))
        cols += [base, down, np.nextafter(down, np.float32(0)), up,
                 np.nextafter(up, np.float32(np.inf))]
    amax = np.array(cols, np.float32)
    return np.stack([amax, -0.25 * amax, np.float32(0.5) * amax])


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("lo,hi", [(-24, -9), (-9, 6), (6, 25)])
def test_po2_scale_matches_reference_near_powers_of_two(jax_ref, bits, lo, hi):
    w = _near_powers_of_two(bits, lo, hi)
    for axis in (0, None):
        got = quant.po2_scale(torch.from_numpy(w), QuantSpec(bits), axis=axis)
        want = jax_ref.quant.po2_scale(jax_ref.jnp.asarray(w),
                                       jax_ref.quant.QuantSpec(bits), axis=axis)
        assert got.dtype == torch.float32
        assert_same(got, want)


def test_po2_scale_keeps_the_references_rounding(jax_ref):
    """ROADMAP C6: the reference's scale is not always the exact power of
    two, and the port returns the reference's answer."""
    spec = QuantSpec(4)
    at = np.array([[7 * 2.0 ** -15]], np.float32)  # amax / w_max == 2**-15
    big = np.array([[7 * 2.0 ** 13]], np.float32)  # amax / w_max == 2**13
    for w, exact in ((at, 2.0 ** -15), (big, 2.0 ** 13)):
        got = quant.po2_scale(torch.from_numpy(w), spec, axis=0).item()
        want = np.asarray(jax_ref.quant.po2_scale(
            jax_ref.jnp.asarray(w), jax_ref.quant.QuantSpec(4), axis=0)).item()
        assert got == want != exact


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_po2_quantize_matches_reference(jax_ref, bits, axis):
    rng = np.random.default_rng(bits)
    w = (rng.standard_normal((40, 24)) * rng.uniform(1e-3, 5, 24)).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero channel gets scale 1
    q, scale = quant.po2_quantize(torch.from_numpy(w), QuantSpec(bits), axis=axis)
    q_j, scale_j = jax_ref.quant.po2_quantize(jax_ref.jnp.asarray(w),
                                              jax_ref.quant.QuantSpec(bits), axis=axis)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    assert_same(q, q_j)
    assert_same(scale, scale_j)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("threshold", [0.5, 1e-7, 3e5, -3e5, 0.0])
def test_requantize_threshold_matches_reference(jax_ref, bits, threshold):
    scale = np.float32(2.0) ** np.arange(-12, 4, dtype=np.float32)
    t, t_scaled = quant.requantize_threshold(threshold, torch.from_numpy(scale),
                                             QuantSpec(bits))
    t_j, t_scaled_j = jax_ref.quant.requantize_threshold(
        threshold, jax_ref.jnp.asarray(scale), jax_ref.quant.QuantSpec(bits))
    assert t.dtype == torch.int32
    assert_same(t, t_j)
    assert_same(t_scaled, t_scaled_j)
    spec = QuantSpec(bits)
    assert int(t.min()) >= spec.v_min and int(t.max()) <= spec.v_max + 1


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("bits", BITS)
def test_export_network_matches_reference(jax_ref, net, bits):
    spec, spec_j = _specs(jax_ref, net)
    params = _params(jax_ref, net)
    mine = export.export_network(params_from_jax(params, "cpu"), spec, QuantSpec(bits))
    theirs = jax_ref.export.export_network(
        [None if p is None else jax_ref.jnp.asarray(p) for p in params], spec_j,
        jax_ref.quant.QuantSpec(bits))
    assert (mine.name, mine.weight_bits) == (theirs.name, theirs.weight_bits)
    for a, b in zip(mine.layers, theirs.layers, strict=True):
        if b is None:
            assert a is None
            continue
        for field in ("w_q", "scale", "thr_int"):
            x, y = getattr(a, field), np.asarray(getattr(b, field))
            assert x.dtype == y.dtype and x.shape == y.shape, field
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("net", NETS)
def test_dequantize_readout_matches_reference(jax_ref, net):
    spec, spec_j = _specs(jax_ref, net)
    params = _params(jax_ref, net)
    ex = export.export_network(params, spec, QuantSpec(8))
    ex_j = jax_ref.export.export_network(
        [None if p is None else jax_ref.jnp.asarray(p) for p in params], spec_j,
        jax_ref.quant.QuantSpec(8))
    n_out = spec.layers[-1].c_out
    shape = (2, n_out) if spec.readout == "rate" else (2,) + HW + (n_out,)
    readout = np.random.default_rng(1).integers(-2000, 2000, shape).astype(np.int32)
    assert_same(export.dequantize_readout(ex, spec, torch.from_numpy(readout)),
                jax_ref.export.dequantize_readout(ex_j, spec_j, readout))


def _run_both(compiled, compiled_j, jax_ref):
    ev = _events()
    out = compiled.run(ev)
    want = compiled_j.run(jax_ref.jnp.asarray(ev))
    assert int(out.spike_counts.sum()) > 0
    for a, b in ((out.readout, want.readout), (out.spike_counts, want.spike_counts),
                 (out.input_counts, want.input_counts)):
        assert_same(a, b)


def _jax_exported(jax_ref, net):
    _, spec_j = _specs(jax_ref, net)
    return jax_ref.export.export_network(
        [None if p is None else jax_ref.jnp.asarray(p) for p in _params(jax_ref, net)],
        spec_j, jax_ref.quant.QuantSpec(8))


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("n_cores", [1, 4])
def test_reference_checkpoint_loads_in_port(jax_ref, net, n_cores, tmp_path):
    spec, spec_j = _specs(jax_ref, net)
    compiled_j = jax_ref.spidr.compile(_jax_exported(jax_ref, net), spec_j,
                                       jax_ref.spidr.DeployTarget(weight_bits=8,
                                                                  n_cores=n_cores),
                                       check="off")
    compiled_j.save(tmp_path)
    compiled = spidr.load(tmp_path, target=spidr.DeployTarget(weight_bits=8,
                                                              n_cores=n_cores),
                          device="cpu")
    assert compiled.spec == spec and compiled.exported is not None
    _run_both(compiled, compiled_j, jax_ref)


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("n_cores", [1, 4])
def test_port_checkpoint_loads_in_reference(jax_ref, net, n_cores, tmp_path):
    spec, _ = _specs(jax_ref, net)
    ex = export.export_network(_params(jax_ref, net), spec, QuantSpec(8))
    compiled = spidr.compile(ex, spec, spidr.DeployTarget(weight_bits=8,
                                                          n_cores=n_cores),
                             device="cpu")
    compiled.save(tmp_path, step=3)
    compiled_j = jax_ref.spidr.load(tmp_path, target=jax_ref.spidr.DeployTarget(
        weight_bits=8, n_cores=n_cores))
    _run_both(compiled, compiled_j, jax_ref)


def test_checkpoint_files_equal_the_references(jax_ref, tmp_path):
    """Same leaves in the same order: every .npy file and the manifest."""
    ex_j = _jax_exported(jax_ref, "gesture")
    spec, spec_j = _specs(jax_ref, "gesture")
    ex = export.ExportedNetwork(ex_j.name, 8, tuple(
        None if l is None else export.ExportedLayer(np.asarray(l.w_q),
                                                    np.asarray(l.scale),
                                                    np.asarray(l.thr_int))
        for l in ex_j.layers))
    export.save_exported(Checkpointer(tmp_path / "p"), 0, ex, spec=spec)
    jax_ref.export.save_exported(jax_ref.checkpoint.Checkpointer(str(tmp_path / "j")),
                                 0, ex_j, spec=spec_j)
    pd, jd = tmp_path / "p" / "step_000000000", tmp_path / "j" / "step_000000000"
    meta_p, meta_j = (json.loads((d / "meta.json").read_text()) for d in (pd, jd))
    meta_p.pop("treedef"), meta_j.pop("treedef")
    assert meta_p == meta_j and meta_p["format_version"] == FORMAT_VERSION
    assert sorted(os.listdir(pd)) == sorted(os.listdir(jd))
    for name in os.listdir(pd):
        if name == "meta.json":  # compared above, without the treedef outline
            continue
        assert (pd / name).read_bytes() == (jd / name).read_bytes(), name


def test_checkpoint_leaf_order_is_the_references(jax_ref, tmp_path):
    tree = {"zeta": [np.arange(3), None, (np.float64(2.5), {"b": np.ones((2, 2)),
                                                           "a": np.int8(-3)})],
            "alpha": np.zeros((0,), np.float32), "mid": None}
    Checkpointer(tmp_path / "p").save(1, tree)
    jax_ref.checkpoint.Checkpointer(str(tmp_path / "j")).save(1, tree)
    meta = [json.loads((tmp_path / d / "step_000000001" / "meta.json").read_text())
            for d in ("p", "j")]
    assert meta[0]["manifest"] == meta[1]["manifest"]
    assert meta[0]["n_leaves"] == meta[1]["n_leaves"] == 7
    back = Checkpointer(tmp_path / "j").restore(1, tree)
    assert back["mid"] is None and back["zeta"][1] is None
    assert isinstance(back["zeta"][2], tuple)
    np.testing.assert_array_equal(back["zeta"][2][1]["b"], np.ones((2, 2)))
    assert back["zeta"][2][1]["a"].dtype == np.int8


def _damage(step_dir, how):
    leaf = step_dir / "0.npy"
    if how == "bit_flip":
        raw = bytearray(leaf.read_bytes())
        raw[-1] ^= 0x01
        leaf.write_bytes(bytes(raw))
    elif how == "dtype":
        np.save(leaf, np.load(leaf).astype(np.float64))
    elif how == "shape":
        np.save(leaf, np.load(leaf)[:-1])
    elif how == "truncated":
        leaf.write_bytes(leaf.read_bytes()[:40])
    elif how == "version":
        meta = json.loads((step_dir / "meta.json").read_text())
        meta["format_version"] = FORMAT_VERSION + 1
        (step_dir / "meta.json").write_text(json.dumps(meta))
    elif how == "meta":
        (step_dir / "meta.json").write_text("{not json")


@pytest.mark.parametrize("how", ["bit_flip", "dtype", "shape", "truncated",
                                 "version", "meta"])
def test_damaged_checkpoint_raises(jax_ref, tmp_path, how):
    spec, spec_j = _specs(jax_ref, "flow")
    ex = export.export_network(_params(jax_ref, "flow"), spec, QuantSpec(8))
    export.save_exported(Checkpointer(tmp_path), 0, ex, spec=spec)
    _damage(tmp_path / "step_000000000", how)
    with pytest.raises(CheckpointError):
        if how == "meta":
            Checkpointer(tmp_path).restore(0, export._template(spec))
        else:
            spidr.load(tmp_path, device="cpu")
    with pytest.raises(jax_ref.checkpoint.CheckpointError):
        jax_ref.checkpoint.Checkpointer(str(tmp_path)).restore(
            0, jax_ref.export._as_tree(_jax_exported(jax_ref, "flow")))


def test_save_async_and_latest_step(tmp_path):
    ckpt = Checkpointer(tmp_path)
    assert ckpt.latest_step() is None
    x = torch.arange(6, dtype=torch.int32)
    ckpt.save_async(2, {"x": x})
    x += 100  # the async save copied the leaves already
    ckpt.wait()
    ckpt.save(5, {"x": x})
    assert ckpt.latest_step() == 5
    np.testing.assert_array_equal(ckpt.restore(2, {"x": x})["x"],
                                  np.arange(6, dtype=np.int32))
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore(2, {"x": x, "y": x})


def test_load_exported_validates_the_artifact(jax_ref, tmp_path):
    spec, _ = _specs(jax_ref, "flow")
    gesture, _ = _specs(jax_ref, "gesture")
    ckpt = Checkpointer(tmp_path)
    ckpt.save(0, [np.zeros(3)])
    with pytest.raises(ValueError, match="exported_snn"):
        export.load_exported(ckpt, spec)
    ex = export.export_network(_params(jax_ref, "flow"), spec, QuantSpec(8))
    export.save_exported(ckpt, 1, ex, spec=spec)
    with pytest.raises(ValueError, match="layer structure"):
        export.load_exported(ckpt, gesture, 1)
    with pytest.raises(FileNotFoundError):
        export.load_exported(Checkpointer(tmp_path / "empty"), spec)
    loaded = spidr.load(tmp_path, step=1, device="cpu")
    assert loaded.target.weight_bits == 8 and loaded.n_cores == 1
    assert loaded.spec.input_hw == HW and loaded.spec.timesteps == T


def test_verify_roundtrip_names_roadmap_a10(jax_ref):
    """ROADMAP A10's round trip, ported: the QAT training graph against an
    exported 8-bit flow net on a 4-core plan, exact, as the reference's."""
    spec, spec_j = _specs(jax_ref, "flow")
    params, ev = _params(jax_ref, "flow"), _events()
    ex = export.export_network(params, spec, QuantSpec(8))
    rt = export.verify_roundtrip(params, spec,
                                 export.deploy(ex, spec, n_cores=4, device="cpu"), ev, ex)
    ex_j = jax_ref.export.export_network(params, spec_j, jax_ref.quant.QuantSpec(8))
    rt_j = jax_ref.export.verify_roundtrip(
        params, spec_j, jax_ref.export.deploy(ex_j, spec_j, n_cores=4),
        jax_ref.jnp.asarray(ev), ex_j)
    assert rt == export.RoundTrip(True, 0.0, 0)
    assert (rt.exact, rt.readout_mismatch, rt.spike_mismatch) == \
        (rt_j.exact, rt_j.readout_mismatch, rt_j.spike_mismatch)


def test_compile_validates_its_inputs(jax_ref, tmp_path):
    spec, _ = _specs(jax_ref, "flow")
    params = _params(jax_ref, "flow")
    ex = export.export_network(params, spec, QuantSpec(8))
    with pytest.raises(ValueError, match="weight_bits=8"):
        spidr.compile(ex, spec, spidr.DeployTarget(weight_bits=4), device="cpu")
    with pytest.raises(ValueError, match="SNNSpec"):
        spidr.compile(ex, device="cpu")
    with pytest.raises(TypeError, match="SNNSpec or an ExportedNetwork"):
        spidr.compile("flow", device="cpu")
    with pytest.raises(ValueError, match="per-tensor"):
        spidr.compile(spec, params_from_jax(params, "cpu"), device="cpu").save(tmp_path)
    kept = spidr.compile(ex, params, spidr.DeployTarget(weight_bits=8), spec=spec,
                         device="cpu")
    assert kept.params is params and kept.exported is ex
    report = kept.verify(_events())
    assert report.exact and report.single_core_exact is None
    with pytest.raises(ValueError, match="exported at 8-bit"):
        export.deploy(ex, spec, E.EngineConfig(QuantSpec(4)), device="cpu")


# ---------------------------------------------------------------------------
# On the card: per-channel thresholds at the ends of their range.
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("t_block", [1, 5])
def test_exported_plan_on_card_with_extreme_thresholds(cuda_device, t_block):
    """Thresholds at v_max + 1 (never fires) and v_min (always fires) in
    every layer, 8-bit on 4 cores, full width, against backend='torch'."""
    spec = spidr_optflow.CONFIG
    ex = export.export_network(init_params(torch.Generator().manual_seed(0), spec),
                               spec, QuantSpec(8))
    q = QuantSpec(8)
    layers = []
    for layer in ex.layers:
        thr = layer.thr_int.copy()
        thr[0::3] = q.v_max + 1
        thr[1::3] = q.v_min
        layers.append(export.ExportedLayer(layer.w_q, layer.scale, thr))
    ex = export.ExportedNetwork(ex.name, 8, tuple(layers))
    events, _ = make_flow_batch(torch.Generator().manual_seed(1), batch=2,
                                timesteps=spec.timesteps, hw=spec.input_hw,
                                device=cuda_device)
    want = spidr.compile(ex, spec, spidr.DeployTarget(weight_bits=8, backend="torch"),
                         device=cuda_device).run(events)
    got = spidr.compile(ex, spec, spidr.DeployTarget(weight_bits=8, n_cores=4,
                                                     t_block=t_block),
                        device=cuda_device).run(events)
    for a, b in ((got.readout, want.readout), (got.spike_counts, want.spike_counts),
                 (got.input_counts, want.input_counts)):
        assert torch.equal(a, b)
