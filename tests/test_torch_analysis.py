"""Deploy-time static analysis of the port (``repro_torch.analysis``) against
the JAX package's (``repro.analysis``).

Each case of ``tests/test_analysis.py`` becomes a parity case: the same
network, precision, schedule, forged schedule or lint fixture goes through
both packages and the reports must agree — the deployment reports and
certificates byte for byte as JSON, the lint findings by key (``pass:code:
location``) and message.  Then the port's own wiring: ``spidr.compile(...,
check=...)``, ``CompiledSNN.report()``, the seeded sync-vs-threaded
``stress_fleet`` (held to the reference's sync readouts and cycles) and the
``python -m repro_torch.analysis`` CLI.  The ``gpu`` cases run phase
``analysis`` of ``chip_smoke.py`` at reduced size on the card.
"""
import dataclasses
import functools
import json
import os
import types
import warnings

import numpy as np
import pytest
import torch

from _torch_parity import assert_same, cuda_device, jax_ref  # noqa: F401
from repro_torch import analysis, spidr
from repro_torch.analysis import (
    AnalysisError,
    AnalysisReport,
    Violation,
    analyze_deployment,
    certify_overflow,
    check_certificate,
    check_lock_discipline,
    check_module_purity,
    check_purity,
    check_schedule,
    check_serving,
    layer_overflow_facts,
    stress_fleet,
)
from repro_torch.analysis import __main__ as analysis_cli
from repro_torch.analysis import concurrency
from repro_torch.compiler import compile_network, ir
from repro_torch.configs import spidr_gesture
from repro_torch.convert import params_from_jax
from repro_torch.core import modes, network, quant
from repro_torch.core.quant import PRECISION_PAIRS, QuantSpec

HW, T = (16, 16), 6
BITS = [w for w, _ in PRECISION_PAIRS]
NETS = ["gesture_net", "optical_flow_net"]


def _port():
    """The port's modules under the names the reference's tests use."""
    return types.SimpleNamespace(
        analysis=analysis, compile_network=compile_network, ir=ir,
        LayerShape=modes.LayerShape, network=network, QuantSpec=quant.QuantSpec)


def _ref(jax_ref):
    return types.SimpleNamespace(
        analysis=jax_ref.analysis, compile_network=jax_ref.compiler.compile_network,
        ir=jax_ref.compiler.ir, LayerShape=jax_ref.modes.LayerShape,
        network=jax_ref.network, QuantSpec=jax_ref.quant.QuantSpec)


def _keys(report) -> list:
    return [(v.key, v.message, v.severity) for v in report.violations]


# ---------------------------------------------------------------------------
# Overflow certification and the deployment bundle.
# ---------------------------------------------------------------------------
def _deployment(pkg, net, bits, cores):
    spec = getattr(pkg.network, net)()
    qspec = pkg.QuantSpec(bits)
    schedule = (pkg.compile_network(spec, n_cores=cores, qspec=qspec)
                if cores > 1 else None)
    return pkg.analysis.analyze_deployment(spec, qspec, schedule)


@pytest.mark.parametrize("cores", [1, 4])
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("net", NETS)
def test_deployment_report_byte_equal(jax_ref, net, bits, cores):
    got = _deployment(_port(), net, bits, cores)
    want = _deployment(_ref(jax_ref), net, bits, cores)
    assert got.ok and not got.violations
    assert got.to_json() == want.to_json()
    assert set(got.passes) == ({"overflow", "schedule"} if cores > 1 else {"overflow"})
    cert = got.certificates["overflow"]
    assert cert["ok"] and cert["saturation_points"] == 1
    if cores > 1:
        assert got.certificates["schedule"]["conservation"]


def _synthetic(pkg):
    # fan_in * |w_min| = 2^28 * 2^7 = 2^35 >> int32.
    return pkg.ir.NetworkGraph("synthetic", (pkg.ir.LayerNode(
        0, "fc", pkg.LayerShape.fc(1 << 28, 4), (),
        in_positions=1 << 28, out_positions=4),))


@pytest.mark.parametrize("case", ["synthetic_int32", "gesture_acc16_8bit",
                                  "gesture_acc11_4bit"])
def test_overflow_violations_equal(jax_ref, case):
    """OVF001 on a synthetic IR and on an 11-bit accumulator, OVF002 (the
    16-bit accumulator wrap) on gesture: equal reports in both packages."""
    reports = []
    for pkg in (_port(), _ref(jax_ref)):
        if case == "synthetic_int32":
            reports.append(pkg.analysis.certify_overflow(_synthetic(pkg), pkg.QuantSpec(8)))
        elif case == "gesture_acc16_8bit":
            reports.append(pkg.analysis.certify_overflow(
                pkg.network.gesture_net(), pkg.QuantSpec(8), acc_bits=16))
        else:
            reports.append(pkg.analysis.certify_overflow(
                pkg.network.gesture_net(), pkg.QuantSpec(4), acc_bits=11))
    got, want = reports
    assert not got.ok
    assert got.to_json() == want.to_json()
    codes = {v.code for v in got.violations}
    assert codes == {"OVF002" if case == "gesture_acc16_8bit" else "OVF001"}
    assert check_certificate(got.certificates["overflow"]) == []
    if case == "synthetic_int32":
        (v,) = got.violations
        assert v.location == "synthetic.L0"
        assert got.certificates["overflow"]["layers"][0][
            "min_violating_active_inputs"] == 16777216


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("net", NETS)
def test_certificates_cross_verify(jax_ref, net, bits):
    """Each package's checker accepts the other's certificate."""
    port_cert = json.loads(json.dumps(certify_overflow(
        getattr(network, net)(), QuantSpec(bits)).certificates["overflow"]))
    ref_cert = json.loads(json.dumps(jax_ref.analysis.certify_overflow(
        getattr(jax_ref.network, net)(), jax_ref.quant.QuantSpec(bits)
    ).certificates["overflow"]))
    assert check_certificate(ref_cert) == []
    assert jax_ref.analysis.check_certificate(port_cert) == []


@pytest.mark.parametrize("tamper", ["ok_flag", "fan_in", "acc_hi", "vmem_bits",
                                    "acc_max"])
def test_tampered_certificate_rejected_by_both(jax_ref, tamper):
    if tamper == "ok_flag":
        cert = certify_overflow(_synthetic(_port()), QuantSpec(8)).certificates["overflow"]
    else:
        cert = certify_overflow(network.gesture_net(), QuantSpec(4)).certificates["overflow"]
    cert = json.loads(json.dumps(cert))
    if tamper == "ok_flag":
        cert["ok"] = True
    elif tamper == "fan_in":
        cert["layers"][0]["fan_in"] = 7
    elif tamper == "acc_hi":
        cert["layers"][1]["acc_hi"] += 1
    else:
        cert[tamper] += 1
    got = check_certificate(cert)
    assert got and got == jax_ref.analysis.check_certificate(cert)
    if tamper == "ok_flag":
        assert any("re-derivation gives False" in p for p in got)


@pytest.mark.parametrize("fan_in", [18, 288, 2000])
def test_layer_facts_equal(jax_ref, fan_in):
    """The facts the card's extremes are held to, at flow's fan-ins and at
    K = 2000 (B2's tile loop, which no paper layer has)."""
    got = layer_overflow_facts(0, "conv", fan_in, 32, QuantSpec(8))
    assert got == jax_ref.analysis.layer_overflow_facts(
        0, "conv", fan_in, 32, jax_ref.quant.QuantSpec(8))
    assert (got["acc_lo"], got["acc_hi"]) == (fan_in * -128, fan_in * 127)


def test_rejects_non_network(jax_ref):
    with pytest.raises(TypeError) as got:
        certify_overflow(object(), QuantSpec(4))
    with pytest.raises(TypeError) as want:
        jax_ref.analysis.certify_overflow(object(), jax_ref.quant.QuantSpec(4))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Schedule verification.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cores", [1, 4])
@pytest.mark.parametrize("net", NETS)
def test_compiled_schedules_verify(jax_ref, net, cores):
    reports = []
    for pkg in (_port(), _ref(jax_ref)):
        spec = getattr(pkg.network, net)()
        sched = pkg.compile_network(spec, n_cores=cores, qspec=pkg.QuantSpec(4))
        reports.append(pkg.analysis.check_schedule(sched, spec=spec))
    got, want = reports
    assert got.ok and got.certificates["schedule"]["n_cores"] == cores
    assert got.to_json() == want.to_json()


def _forged(pkg, kind):
    """(schedule, spec or None) forged as in the reference's tests."""
    spec = pkg.network.gesture_net()
    if kind == "over_capacity":
        sched = pkg.compile_network(spec, n_cores=4, qspec=pkg.QuantSpec(4))
        return dataclasses.replace(sched, n_cores=2), None
    if kind == "illegal_pair":
        sched = pkg.compile_network(spec, n_cores=2, qspec=pkg.QuantSpec(4))
        fake = types.SimpleNamespace(weight_bits=5, vmem_bits=9)
        return dataclasses.replace(sched, qspec=fake), None
    sched = pkg.compile_network(spec, n_cores=4, qspec=pkg.QuantSpec(4))
    layers = list(sched.layers)
    if kind == "route_fractions":
        victim = next(i for i, l in enumerate(layers)
                      if any(f > 0 for f in l.route_fractions))
        fr = list(layers[victim].route_fractions)
        fr[0] = 2.0
        layers[victim] = dataclasses.replace(layers[victim], route_fractions=tuple(fr))
        return dataclasses.replace(sched, layers=tuple(layers)), None
    donor = next(l for l in layers if l.plan.mapping != layers[0].plan.mapping)
    forged = dataclasses.replace(layers[0], plan=dataclasses.replace(
        layers[0].plan, mapping=donor.plan.mapping))
    return dataclasses.replace(sched, layers=tuple([forged] + layers[1:])), spec


@pytest.mark.parametrize("kind,codes", [
    ("over_capacity", {"SCH001", "SCH002"}),
    ("illegal_pair", {"SCH010"}),
    ("route_fractions", {"SCH031"}),
    ("conservation", {"SCH023", "SCH040", "SCH041", "SCH042", "SCH043"}),
])
def test_forged_schedules_give_equal_violations(jax_ref, kind, codes):
    got_sched, got_spec = _forged(_port(), kind)
    want_sched, want_spec = _forged(_ref(jax_ref), kind)
    got = check_schedule(got_sched, spec=got_spec)
    want = jax_ref.analysis.check_schedule(want_sched, spec=want_spec)
    assert not got.ok
    assert _keys(got) == _keys(want)
    assert {v.code for v in got.violations} & codes
    if kind == "illegal_pair":
        v = next(v for v in got.violations if v.code == "SCH010")
        assert v.message == ("illegal precision pair 5/9: supported pairs are "
                             "4/7, 6/11, 8/15")


# ---------------------------------------------------------------------------
# Concurrency lint + stress harness.
# ---------------------------------------------------------------------------
_RACY = '''\
import threading
import time


class Racy:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0

    def bump(self):
        self.count += 1

    def slow(self):
        with self._lock:
            time.sleep(0.1)
'''
_LOCKED_HELPER = _RACY.replace(
    "    def bump(self):\n        self.count += 1\n",
    "    def bump(self):\n"
    "        with self._lock:\n"
    "            self._inc()\n\n"
    "    def _inc(self):\n"
    "        self.count += 1\n")
_START_THREADS = '''\
import threading


class Fleet:
    def __init__(self):
        self._lock = threading.RLock()
        self.streams = {}

    def _start(self):
        self.streams[0] = object()
'''


@pytest.mark.parametrize("source,codes", [
    (_RACY, {"CON001", "CON002"}),
    (_LOCKED_HELPER, {"CON002"}),
    (_START_THREADS, {"CON001"}),
])
def test_lock_discipline_fixtures_equal(jax_ref, source, codes):
    got = check_lock_discipline(source, "fixture.py")
    want = jax_ref.analysis.check_lock_discipline(source, "fixture.py")
    assert {v.code for v in got.violations} == codes
    assert _keys(got) == _keys(want)


def test_serving_lint_equals_the_references_on_the_port(jax_ref):
    """The port's ``check_serving()`` lints ``repro_torch/serving`` and gives
    the reference's lint's verdict over the same files."""
    from repro_torch import serving

    got = check_serving()
    serving_dir = os.path.dirname(os.path.abspath(serving.__file__))
    paths = sorted(os.path.join(serving_dir, f) for f in os.listdir(serving_dir)
                   if f.endswith(".py"))
    want = jax_ref.analysis.check_serving(paths)
    assert got.subject == "repro_torch.serving"
    assert _keys(got) == _keys(want) == []
    assert got.passes == want.passes == ("concurrency",)


_PARAMS: list = []


def _pair(jax_ref, **target):
    """Reduced gesture in both packages from the reference's seed-0 params."""
    if not _PARAMS:
        spec_j = jax_ref.spidr_gesture.reduced(hw=HW, timesteps=T)
        _PARAMS.extend(None if p is None else np.asarray(p) for p in
                       jax_ref.network.init_params(jax_ref.jax.random.PRNGKey(0), spec_j))
    kw = dict(weight_bits=4, chunk_T=3, stream_capacity=2, **target)
    port = spidr.compile(spidr_gesture.reduced(hw=HW, timesteps=T),
                         params_from_jax(list(_PARAMS), "cpu"),
                         spidr.DeployTarget(backend="torch", **kw), device="cpu")
    ref = jax_ref.spidr.compile(
        jax_ref.spidr_gesture.reduced(hw=HW, timesteps=T),
        [None if p is None else jax_ref.jnp.asarray(p) for p in _PARAMS],
        jax_ref.spidr.DeployTarget(backend="jnp", **kw), check="off")
    return port, ref


def _ref_sync(jax_ref, ref, streams, n_replicas, capacity):
    fleet = jax_ref.spidr.serve(ref, n_replicas=n_replicas, capacity=capacity,
                                mode="sync", max_queue=len(streams))
    try:
        hs = [fleet.submit(ev, rid=i) for i, ev in enumerate(streams)]
        fleet.drain()
        return {h.rid: (np.asarray(h.readout), int(h.cycles)) for h in hs}, fleet.ticks
    finally:
        fleet.shutdown()


@pytest.mark.parametrize("n_cores", [1, 4])
def test_stress_sync_vs_threaded_and_reference(jax_ref, n_cores):
    port, ref = _pair(jax_ref, n_cores=n_cores)
    result = stress_fleet(port, n_streams=4, n_replicas=2, seed=7)
    assert result.ok, result.mismatches
    assert result.n_streams == 4
    assert result.ticks_sync > 0 and result.ticks_threaded > 0
    # The sync run against the reference's fleet on the same seeded streams.
    streams = concurrency._seeded_streams(port, 4, None, 7)
    got, ticks, _ = concurrency._serve_seeded(port, streams, "sync", 2, 2, 60.0)
    want, want_ticks = _ref_sync(jax_ref, ref, streams, 2, 2)
    assert ticks == want_ticks == result.ticks_sync
    for rid, (readout, cycles) in want.items():
        assert_same(got[rid][0], readout)
        assert got[rid][1] == cycles


# ---------------------------------------------------------------------------
# Purity lint.
# ---------------------------------------------------------------------------
_IMPURE = '''\
import functools
import random
import time

import jax
from dataclasses import dataclass
from jax.tree_util import register_pytree_node

_CACHE = {}


@functools.partial(jax.jit, static_argnames=("n",))
def step(x, n):
    t0 = time.perf_counter()
    return x * _CACHE["scale"] + random.random() + t0


def scale_int(x):
    return float(x / 2) + 0.5


@dataclass
class BadSched:
    slices: list


register_pytree_node(BadSched, lambda s: ((), s), lambda s, _: s)
'''
_JAX_RANDOM = ("import jax\n"
               "from jax import random\n"
               "@jax.jit\n"
               "def step(key, x):\n"
               "    return x + random.normal(key, x.shape)\n")
_FROZEN_LEAFLESS = ("from dataclasses import dataclass\n"
                    "from jax.tree_util import register_pytree_node\n"
                    "@dataclass(frozen=True)\n"
                    "class Sched:\n"
                    "    name: str\n"
                    "    cores: tuple\n"
                    "register_pytree_node(Sched, lambda s: ((), s), lambda s, _: s)\n")
_LEAFY = ("from dataclasses import dataclass\n"
          "from jax.tree_util import register_pytree_node\n"
          "@dataclass\n"
          "class State:\n"
          "    v: list\n"
          "register_pytree_node(State, lambda s: ((s.v,), None), "
          "lambda _, c: State(list(c)))\n")
# The port's integer neuron step with a float leaked into it.
_TORCH_INT = ("import torch\n"
              "def neuron_step_int(v, partial, thr):\n"
              "    v = v + partial\n"
              "    return v - (v >= thr).to(torch.float32) * 0.5\n")


@pytest.mark.parametrize("source,codes", [
    (_IMPURE, {"PUR001", "PUR002", "PUR003", "PUR004"}),
    (_JAX_RANDOM, set()),
    (_FROZEN_LEAFLESS, set()),
    (_LEAFY, set()),
    (_TORCH_INT, {"PUR003"}),
])
def test_purity_fixtures_equal(jax_ref, source, codes):
    got = check_module_purity(source, "fixture.py")
    want = jax_ref.analysis.check_module_purity(source, "fixture.py")
    assert {v.code for v in got.violations} == codes
    assert _keys(got) == _keys(want)


def test_port_tree_is_pure(jax_ref):
    """The port's tree is clean, and the reference's lint over the same
    files says so too."""
    got = check_purity()
    assert got.subject == "repro_torch (purity)"
    assert got.ok and not got.violations, got.summary()
    root = os.path.dirname(os.path.dirname(os.path.abspath(analysis.__file__)))
    assert jax_ref.analysis.check_purity(root=root).ok


# ---------------------------------------------------------------------------
# Facade wiring: spidr.compile(check=...) + CompiledSNN.report().
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _compiled(n_cores=1, check="warn"):
    from repro_torch.core.network import init_params

    spec = spidr_gesture.reduced(hw=HW, timesteps=T)
    params = init_params(torch.Generator().manual_seed(0), spec)
    return spidr.compile(spec, params, spidr.DeployTarget(
        weight_bits=4, backend="torch", chunk_T=3, stream_capacity=2,
        n_cores=n_cores), device="cpu", check=check)


@pytest.mark.parametrize("n_cores", [1, 4])
def test_compile_populates_report(jax_ref, n_cores):
    rep = _compiled(n_cores=n_cores).report()
    assert isinstance(rep, AnalysisReport) and rep.ok
    assert set(rep.passes) == ({"overflow", "schedule"} if n_cores > 1 else {"overflow"})
    assert check_certificate(rep.certificates["overflow"]) == []
    _, ref = _pair(jax_ref, n_cores=n_cores)
    assert rep.to_json() == ref.report().to_json()


def test_check_off_is_lazy():
    c = _compiled(check="off")
    assert c._analysis is None
    assert c.report().ok
    assert c._analysis is not None


def test_invalid_mode_rejected(jax_ref):
    spec = spidr_gesture.reduced(hw=HW, timesteps=T)
    with pytest.raises(ValueError, match="check must be one of") as got:
        spidr.compile(spec, [], check="nope", device="cpu")
    with pytest.raises(ValueError) as want:
        jax_ref.spidr.compile(jax_ref.spidr_gesture.reduced(hw=HW, timesteps=T), [],
                              check="nope")
    assert str(got.value) == str(want.value)


def _seeded(pkg_analysis):
    return pkg_analysis.AnalysisReport(
        subject="seeded", passes=("overflow",),
        violations=(pkg_analysis.Violation(
            pass_name="overflow", code="OVF001",
            location="seeded.L0", message="seeded failure"),))


@pytest.mark.parametrize("mode", ["strict", "warn"])
def test_strict_raises_and_warn_warns(jax_ref, monkeypatch, mode):
    from repro_torch.core.network import init_params

    spec = spidr_gesture.reduced(hw=HW, timesteps=T)
    params = init_params(torch.Generator().manual_seed(0), spec)
    seeded, seeded_ref = _seeded(analysis), _seeded(jax_ref.analysis)
    monkeypatch.setattr(analysis, "analyze_deployment", lambda *a, **k: seeded)
    if mode == "strict":
        with pytest.raises(AnalysisError) as err:
            spidr.compile(spec, params, check="strict", device="cpu")
        assert err.value.report is seeded
        assert str(err.value) == str(jax_ref.analysis.AnalysisError(seeded_ref))
        return
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        c = spidr.compile(spec, params, check="warn", device="cpu")
    (w,) = [w for w in caught if issubclass(w.category, RuntimeWarning)]
    assert str(w.message) == (
        "static analysis found 1 violation(s) in seeded — see "
        "CompiledSNN.report() (compile with check='strict' to fail the build)")
    assert c.report() is seeded


# ---------------------------------------------------------------------------
# Report plumbing, baseline ratchet, CLI.
# ---------------------------------------------------------------------------
def test_violation_key_excludes_message(jax_ref):
    a = Violation("overflow", "OVF001", "net.L0", "run-dependent 123")
    b = Violation("overflow", "OVF001", "net.L0", "run-dependent 456")
    assert a.key == b.key == "overflow:OVF001:net.L0"
    assert str(a) == str(jax_ref.analysis.Violation(
        "overflow", "OVF001", "net.L0", "run-dependent 123"))
    with pytest.raises(ValueError, match="severity") as got:
        Violation("overflow", "OVF001", "net.L0", "m", severity="fatal")
    with pytest.raises(ValueError) as want:
        jax_ref.analysis.Violation("overflow", "OVF001", "net.L0", "m", severity="fatal")
    assert str(got.value) == str(want.value)


def test_report_json_roundtrip_across_packages(jax_ref):
    rep = certify_overflow(network.gesture_net(), QuantSpec(4))
    back = jax_ref.analysis.AnalysisReport.from_dict(json.loads(rep.to_json()))
    again = AnalysisReport.from_dict(json.loads(back.to_json()))
    assert again.to_json() == rep.to_json()
    assert back.summary() == rep.summary()


def test_baseline_ratchet_files_equal(jax_ref, tmp_path):
    old = Violation("schedule", "SCH001", "net", "old finding")
    new = Violation("schedule", "SCH002", "net.L0", "new finding")
    analysis.write_baseline(str(tmp_path / "port.json"), [old, new])
    jax_ref.analysis.write_baseline(str(tmp_path / "ref.json"), [
        jax_ref.analysis.Violation(**v.to_dict()) for v in (old, new)])
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    analysis.write_baseline(str(tmp_path / "b.json"), [old])
    waived = analysis.load_baseline(str(tmp_path / "b.json"))
    assert analysis.new_violations([old, new], waived) == (new,)


def _cli(mod, argv, capsys):
    rc = mod.main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--network", "gesture", "--bits", "4", "--cores", "1", "--skip-lints"],
    ["--network", "optical_flow", "--bits", "8", "--cores", "4", "--skip-lints"],
    ["--all"],
])
def test_cli_json_equals_reference(jax_ref, tmp_path, capsys, argv):
    rc, out = _cli(analysis_cli, argv + ["--json", str(tmp_path / "p.json")], capsys)
    rc_ref, _ = _cli(jax_ref.analysis_cli, argv + ["--json", str(tmp_path / "r.json")],
                     capsys)
    assert rc == rc_ref == 0
    got = json.loads((tmp_path / "p.json").read_text())
    want = json.loads((tmp_path / "r.json").read_text())
    assert got.pop("subject") == "repro_torch.analysis"
    want.pop("subject")
    assert got == want and got["ok"] is True
    assert "certified" in out
    for cert in got["certificates"].values():
        if cert["pass"] == "overflow":
            assert check_certificate(cert) == []


def test_cli_baseline_ratchet(jax_ref, tmp_path, capsys, monkeypatch):
    """A seeded finding fails the CLI (exit 1) until a written baseline
    waives it (exit 0), in both packages alike."""
    argv = ["--network", "gesture", "--bits", "4", "--cores", "1", "--skip-lints"]
    rcs = []
    for mod, pkg in ((analysis_cli, _port()), (jax_ref.analysis_cli, _ref(jax_ref))):
        # The seeded finding beside an honest certificate (the CLI re-checks it).
        cert = pkg.analysis.certify_overflow(pkg.network.gesture_net(), pkg.QuantSpec(4))
        seeded = dataclasses.replace(_seeded(pkg.analysis),
                                     certificates=cert.certificates)
        monkeypatch.setattr(mod, "analyze_deployment", lambda *a, **k: seeded)
        base = tmp_path / f"{pkg.analysis.__name__}.json"
        rcs.append((_cli(mod, argv, capsys)[0],
                    _cli(mod, argv + ["--write-baseline", str(base)], capsys)[0],
                    _cli(mod, argv + ["--baseline", str(base)], capsys)[0]))
        assert json.loads(base.read_text()) == {
            "waived": ["overflow:OVF001:seeded.L0"]}
    assert rcs[0] == rcs[1] == (1, 0, 0)


def test_analyze_deployment_merges_passes():
    spec = network.gesture_net()
    sched = compile_network(spec, n_cores=4, qspec=QuantSpec(4))
    rep = analyze_deployment(spec, QuantSpec(4), sched)
    assert set(rep.passes) == {"overflow", "schedule"}
    assert {"overflow", "schedule"} <= set(rep.certificates)


# ---------------------------------------------------------------------------
# On the card: the analysis phase of chip_smoke.py at reduced size.
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("n_cores", [1, 4])
def test_strict_deployment_on_the_card(cuda_device, n_cores):
    """``check="strict"`` compiles on the card, at t_block 1 and 4, bit-exact
    with ``backend="torch"``."""
    from repro_torch.core.network import init_params

    spec = spidr_gesture.reduced(hw=(32, 32), timesteps=8)
    params = init_params(torch.Generator().manual_seed(0), spec)
    g = torch.Generator().manual_seed(1)
    ev = (torch.rand((8, 2, 32, 32, 2), generator=g) < 0.1).float().to(cuda_device)
    target = dict(weight_bits=8, n_cores=n_cores)
    want = spidr.compile(spec, params, spidr.DeployTarget(backend="torch", **target),
                         device=cuda_device, check="strict").run(ev)
    for t_block in (1, 4):
        c = spidr.compile(spec, params, spidr.DeployTarget(t_block=t_block, **target),
                          device=cuda_device, check="strict")
        assert not c.report().errors
        assert ("schedule" in c.report().passes) == (n_cores > 1)
        out = c.run(ev)
        assert_same(out.readout, want.readout)
        assert_same(out.spike_counts, want.spike_counts)


@pytest.mark.gpu
@pytest.mark.parametrize("fan_in", [18, 288, 2000])
def test_certificate_extremes_on_the_card(cuda_device, fan_in):
    """All-one spikes on all-``w_min`` then all-``w_max`` weights: B4's raw
    sums equal the certificate's ``acc_lo`` / ``acc_hi``; B1 and B2 equal
    their plain versions and saturate to ``v_min`` / ``v_max``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_lif_gemm import (fused_lif_gemm_int,
                                                    fused_lif_gemm_int_tblk)
    from repro_torch.kernels.spike_gemm import spike_gemm

    q = QuantSpec(8)
    facts = layer_overflow_facts(0, "conv", fan_in, 32, q)
    m, n, t = 4096, 32, 5
    s = torch.ones((t, m, fan_in), dtype=torch.int8, device=cuda_device)
    for w_val, acc, v_end in ((q.w_min, facts["acc_lo"], q.v_min),
                              (q.w_max, facts["acc_hi"], q.v_max)):
        w = torch.full((fan_in, n), w_val, dtype=torch.int8, device=cuda_device)
        raw = spike_gemm(s[0], w)
        assert bool((raw == acc).all())
        v0 = torch.full((m, n), v_end, dtype=torch.int32, device=cuda_device)
        thr = facts["threshold_hi"]
        v1, s1 = fused_lif_gemm_int(s[0], w, v0, thr, vmem_bits=q.vmem_bits)
        v1p, s1p = ref.fused_lif_gemm_int_ref(s[0], w, v0, thr, vmem_bits=q.vmem_bits)
        assert_same(v1, v1p)
        assert_same(s1, s1p)
        assert bool((v1 == v_end).all())
        vt, st = fused_lif_gemm_int_tblk(s, w, v0, thr, vmem_bits=q.vmem_bits)
        vtp, stp = ref.fused_lif_gemm_int_tblk_ref(s, w, v0, thr, vmem_bits=q.vmem_bits)
        assert_same(vt, vtp)
        assert_same(st, stp)
        assert bool((vt == v_end).all())


@pytest.mark.gpu
def test_stress_fleet_on_the_card(cuda_device):
    from repro_torch.core.network import init_params

    spec = spidr_gesture.reduced(hw=(32, 32), timesteps=8)
    params = init_params(torch.Generator().manual_seed(0), spec)
    c = spidr.compile(spec, params, spidr.DeployTarget(chunk_T=4, t_block=4),
                      device=cuda_device, check="strict")
    result = stress_fleet(c, n_streams=6, n_replicas=2, capacity=2, seed=3)
    assert result.ok, result.mismatches
    assert result.ticks_sync > 0 and result.ticks_threaded > 0
