"""Serving on the card: LM continuous batching and DVS event streams.

    python -m repro_torch.launch.serve --arch rwkv6-7b --requests 8 --capacity 4 --prompt-len 64
    python -m repro_torch.launch.serve --arch rwkv6-7b --reduced --device cpu
    python -m repro_torch.launch.serve --snn gesture --requests 8 --capacity 4
    python -m repro_torch.launch.serve --snn optical-flow --requests 2 --capacity 2 --t-block 5
    python -m repro_torch.launch.serve --snn gesture --torch --device cpu
    python -m repro_torch.launch.serve --snn gesture --streaming --chunk-T 2 --snapshot-dir snap --snapshot-every 1
    python -m repro_torch.launch.serve --snn gesture --streaming --device cpu --metrics-out m.prom --trace-out t.json
    python -m repro_torch.launch.serve --snn gesture --streaming --replicas 2 --requests 12

LM (``--arch``): the model with random weights from a fixed seed, at its
full published width unless ``--reduced`` asks for the CPU-sized config
(the reference's ``--reduced`` is always on; here it is opt-in).  A
:class:`Server` does continuous batching with slot reuse: one prefill per
admitted request (the wkv kernel B7 in every layer on the card), then one
batched decode step per tick over every slot, idle slots riding along.
Only ``rwkv6-7b`` (the ``ssm`` family) is ported.

SNN (``--snn``): the paper's Table II network at full width with random
weights from a fixed seed.  One ``DeployTarget`` declares the precision,
backend and ``t_block``, and the ``CompiledSNN`` serves through
``spidr.serve`` on a fleet of ``--replicas`` replicas (one by default).
Without ``--streaming`` the fleet serves whole streams (``batch=True``):
each replica packs requests into fixed-capacity batches, one engine run
per batch.  With ``--streaming`` each replica serves live streams:
``--capacity`` persistent-Vmem slots advanced ``--chunk-T`` timesteps per
tick, incremental replies, ``--watchdog-s`` rewind-and-replay and
``--snapshot-dir``/``--snapshot-every`` snapshots (under
``snapshot-dir/replica<i>``).  ``--metrics-out`` (``--metrics-every``),
``--trace-out`` and ``--log-json`` switch on the ``repro_torch.obs``
telemetry.  The pre-fleet names ``SNNServer``, ``StreamingSNNServer`` and
``SNNRequest`` remain as deprecated aliases of the serving workers.

The JAX CLI's ``--jnp`` is this CLI's ``--torch``, and it exits naming it.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
import time
import warnings
from typing import Optional

import numpy as np
import torch

from .. import obs, resolve_device, spidr
from ..configs import spidr_gesture, spidr_optflow
from ..configs.base import get_config
from ..core.network import init_params
from ..models import model as M
from ..models.transformer import init_decode_state
from ..serving import BatchWorker, StreamRequest, StreamWorker
from ..snn.data import make_flow_batch, make_gesture_batch

log = logging.getLogger("repro_torch.serve")

# Flags of ``repro.launch.serve`` that this port spells otherwise.
_NOT_PORTED = {
    "--jnp": "nothing: the port's plain backend is --torch",
}


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    generated: list = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None


class Server:
    """Fixed-capacity continuous-batching LM server (the reference's).

    Runs on the device of ``params`` (pass :func:`models.model.serving_params`
    to skip the per-call weight casts).  ``use_kernel`` picks the prefill's
    wkv route: None is the CUDA kernel on the card.  ``prefill_seconds`` and
    ``decode_seconds`` add up the host-clock time of the prefills and of
    the decode steps; each ends in the argmax's copy to the host, which
    waits for the device.
    """

    def __init__(self, cfg, params, capacity: int = 8, ctx_len: int = 256,
                 use_kernel: Optional[bool] = None):
        self.cfg, self.params = cfg, params
        self.capacity, self.ctx_len = capacity, ctx_len
        self.device = params["embed"].device
        self.decode_step = M.make_decode_step(cfg)
        self.prefill = M.make_prefill_step(cfg, use_kernel=use_kernel)
        # Batched cache: slot i belongs to active request i (or is empty).
        # Its token-shift rows are kept in the compute dtype (bfloat16 as
        # served, the reference's; float32 when the model computes in it).
        self.cache = init_decode_state(cfg, capacity, ctx_len, dtype=M.COMPUTE_DTYPE,
                                       device=self.device)
        self.slots: list = [None] * capacity
        self.slot_len = np.zeros(capacity, np.int32)
        self.next_tok = np.zeros((capacity, 1), np.int64)
        self.waiting: list = []
        self.done: list = []
        self.prefills = 0
        self.decode_steps = 0
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0

    def submit(self, req: Request) -> None:
        req.submitted_at = time.monotonic()
        self.waiting.append(req)

    @torch.no_grad()
    def _admit(self) -> None:
        for i in range(self.capacity):
            if self.slots[i] is None and self.waiting:
                req = self.waiting.pop(0)
                t0 = time.perf_counter()
                tokens = torch.as_tensor(req.prompt[None, :], dtype=torch.long,
                                         device=self.device)
                logits, cache1 = self.prefill(self.params, {"tokens": tokens})
                tok = int(torch.argmax(logits[0]))
                self.prefills += 1
                self.prefill_seconds += time.perf_counter() - t0
                req.generated.append(tok)
                req.first_token_at = time.monotonic()
                self._copy_into_slot(i, cache1)
                self.slots[i] = req
                self.slot_len[i] = len(req.prompt)
                self.next_tok[i, 0] = tok

    def _copy_into_slot(self, i: int, cache1: dict) -> None:
        """The prefill's layer-stacked state (L, 1, ...) into slot i."""
        for key in ("x_tm", "x_cm", "s"):
            dst = self.cache[key]
            dst[:, i:i + 1] = cache1[key].to(dst.dtype)

    @torch.no_grad()
    def step(self) -> bool:
        self._admit()
        active = [i for i in range(self.capacity) if self.slots[i] is not None]
        if not active:
            return False
        # One batched decode step for every slot (idle slots ride along).
        t0 = time.perf_counter()
        self.cache["len"] = torch.tensor(int(self.slot_len.max()), dtype=torch.int32,
                                         device=self.device)
        tokens = torch.as_tensor(self.next_tok, device=self.device)
        logits, self.cache = self.decode_step(self.params, self.cache,
                                              {"tokens": tokens})
        toks = torch.argmax(logits, dim=-1).cpu().numpy()
        self.decode_steps += 1
        self.decode_seconds += time.perf_counter() - t0
        for i in active:
            req = self.slots[i]
            tok = int(toks[i])
            req.generated.append(tok)
            self.slot_len[i] += 1
            self.next_tok[i, 0] = tok
            if len(req.generated) >= req.max_new or self.slot_len[i] >= self.ctx_len - 1:
                req.done_at = time.monotonic()
                self.done.append(req)
                self.slots[i] = None  # free slot: continuous batching
                self.slot_len[i] = 0
        return True


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--snn", choices=["gesture", "optical-flow"],
                    help="which paper network serves the event streams")
    ap.add_argument("--arch", default=None,
                    help="serve an LM instead (ported: rwkv6-7b)")
    ap.add_argument("--reduced", action="store_true",
                    help="LM: the CPU-sized config of the same family instead "
                         "of the full published width (the reference's "
                         "--reduced is always on; here it is opt-in)")
    ap.add_argument("--prompt-len", type=int, default=16, dest="prompt_len")
    ap.add_argument("--max-new", type=int, default=8, dest="max_new")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=4)
    ap.add_argument("--weight-bits", type=int, default=4, choices=[4, 6, 8],
                    dest="weight_bits")
    ap.add_argument("--torch", action="store_true",
                    help="plain integer torch backend instead of the CUDA kernels")
    ap.add_argument("--n-cores", type=int, default=1, dest="n_cores",
                    help="SNN path: compile the network across a grid of N "
                         "SpiDR cores (repro_torch.compiler): bit-exact "
                         "outputs, per-core cost attribution, on one device")
    ap.add_argument("--t-block", type=int, default=1, dest="t_block",
                    help="timesteps per Vmem-stationary kernel slab (fused backend)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch kernels)")
    ap.add_argument("--streaming", action="store_true",
                    help="SNN path: stateful streaming serving — events "
                         "arrive in chunks, Vmem persists per slot between "
                         "chunks, replies are incremental")
    ap.add_argument("--chunk-T", type=int, default=2, dest="chunk_T",
                    help="timesteps per delivered chunk in --streaming mode")
    ap.add_argument("--replicas", type=int, default=1,
                    help="SNN path: serve through a fleet of N engine "
                         "replicas (spidr.serve) — streams are scheduled "
                         "across them")
    ap.add_argument("--watchdog-s", type=float, default=None,
                    dest="watchdog_s",
                    help="--streaming: per-tick watchdog deadline; a hung "
                         "tick rewinds to the last completed tick and replays")
    ap.add_argument("--snapshot-dir", default=None, dest="snapshot_dir",
                    help="--streaming: persist the full serving state here "
                         "(weights + live sessions + cursors)")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    dest="snapshot_every",
                    help="--streaming: snapshot every N ticks (0 = never)")
    ap.add_argument("--metrics-out", default=None, dest="metrics_out",
                    help="enable metrics and write the final dump here "
                         "(.json -> JSON, else Prometheus text)")
    ap.add_argument("--metrics-every", type=int, default=0,
                    dest="metrics_every",
                    help="--streaming: also rewrite --metrics-out every N "
                         "ticks (0 = only at the end)")
    ap.add_argument("--trace-out", default=None, dest="trace_out",
                    help="enable span tracing and export a Chrome-trace/"
                         "Perfetto JSON (serving spans; multi-core runs add "
                         "per-stream pipeline timelines)")
    ap.add_argument("--log-json", action="store_true", dest="log_json",
                    help="one JSON object per log record (each carries the "
                         "stream request id)")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    ap = _parser()
    args, unknown = ap.parse_known_args(argv)
    for tok in unknown:
        flag = tok.split("=", 1)[0]
        if flag in _NOT_PORTED:
            ap.error(f"{flag} is not ported to repro_torch yet — see ROADMAP.md "
                     f"{_NOT_PORTED[flag]}")
    if unknown:
        ap.error(f"unrecognized arguments: {' '.join(unknown)}")
    if (args.snn is None) == (args.arch is None):
        ap.error("give one of --snn (event streams) or --arch (LM serving; "
                 "ROADMAP.md A12 ports the LM stack: rwkv6-7b so far)")
    if args.arch is not None:
        try:
            get_config(args.arch)
        except (KeyError, NotImplementedError) as e:
            ap.error(str(e).strip("'\""))
    return args


def serve_lm(args: argparse.Namespace) -> Server:
    """Random-weight LM (seed 0), ``args.requests`` random prompts (seed 0)."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = M.serving_params(M.init_params(
        torch.Generator(device=dev).manual_seed(0), cfg))
    # A slot's context: the reference's 64, or enough for the prompt and
    # every new token (the reference's fixed 64 cuts longer requests short).
    ctx_len = max(64, args.prompt_len + args.max_new + 1)
    server = Server(cfg, params, capacity=args.capacity, ctx_len=ctx_len)
    rng = np.random.default_rng(0)
    for r in range(args.requests):
        server.submit(Request(rid=r, max_new=args.max_new, prompt=rng.integers(
            0, cfg.vocab_size, args.prompt_len).astype(np.int32)))
    t0 = time.monotonic()
    while server.step():
        pass
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.monotonic() - t0
    lat = [r.done_at - r.submitted_at for r in server.done]
    ttft = [r.first_token_at - r.submitted_at for r in server.done]
    toks = sum(len(r.generated) for r in server.done)
    log.info("served %d requests (%s, %d layers, d_model %d), %d tokens in "
             "%.3fs (%.1f tok/s); TTFT p50 %.3fs; latency p50 %.3fs; "
             "prefills %d (%.3fs), decode steps %d (%.3fs); device=%s",
             len(server.done), cfg.name, cfg.n_layers, cfg.d_model, toks, dt,
             toks / dt, float(np.median(ttft)), float(np.median(lat)),
             server.prefills, server.prefill_seconds, server.decode_steps,
             server.decode_seconds, dev)
    return server


# ---------------------------------------------------------------------------
# SNN event-stream serving.
# ---------------------------------------------------------------------------
#: Deprecated alias -- the request object lives in ``repro_torch.serving``.
SNNRequest = StreamRequest


def _warn_deprecated(old: str) -> None:
    warnings.warn(
        f"repro_torch.launch.serve.{old} is deprecated; serve through "
        "spidr.serve(compiled, spidr.ServeConfig(...)) instead",
        DeprecationWarning, stacklevel=3)


class SNNServer(BatchWorker):
    """Deprecated shim: use ``spidr.serve(compiled, batch=True)``.

    The whole-stream batching loop lives in
    :class:`repro_torch.serving.BatchWorker`; this subclass only adds the
    ``DeprecationWarning``.
    """

    def __init__(self, compiled, capacity: int = 4):
        _warn_deprecated("SNNServer")
        super().__init__(compiled, capacity)


class StreamingSNNServer(StreamWorker):
    """Deprecated shim: use ``spidr.serve(compiled, spidr.ServeConfig(...))``.

    The stateful continuous-batching loop lives in
    :class:`repro_torch.serving.StreamWorker`; this subclass only adds the
    ``DeprecationWarning``.  ``restore`` is inherited and returns this
    class.
    """

    def __init__(self, *args, **kwargs):
        _warn_deprecated("StreamingSNNServer")
        super().__init__(*args, **kwargs)


def serve_snn(args: argparse.Namespace):
    """Compile the network, submit ``args.requests`` streams to a fleet of
    ``args.replicas`` replicas (``spidr.serve``) and serve them.

    Returns the :class:`~repro_torch.serving.Fleet`, shut down, with every
    finished request on ``done`` and each replica's worker on ``workers``.
    """
    dev = resolve_device(args.device)
    spec = (spidr_gesture if args.snn == "gesture" else spidr_optflow).CONFIG
    # Telemetry opt-in precedes compile, so every span lands in one trace.
    if args.metrics_out:
        obs.enable_metrics()
    if args.trace_out:
        obs.enable_tracing()
    params = init_params(torch.Generator().manual_seed(0), spec)
    target = spidr.DeployTarget(weight_bits=args.weight_bits,
                                backend="torch" if args.torch else "fused",
                                n_cores=args.n_cores, t_block=args.t_block,
                                chunk_T=args.chunk_T,
                                stream_capacity=args.capacity)
    compiled = spidr.compile(spec, params, target, device=dev)
    if compiled.schedule is not None:
        log.info("compiled %s onto %d cores (%d channel-split layers, "
                 "device_parallel=%s)\n%s", spec.name, args.n_cores,
                 compiled.schedule.n_split_layers,
                 compiled.engine.device_parallel,
                 compiled.schedule.describe())

    make = make_gesture_batch if args.snn == "gesture" else make_flow_batch
    ev, _ = make(torch.Generator().manual_seed(1), batch=args.requests,
                 timesteps=spec.timesteps, hw=spec.input_hw, device="cpu")
    ev = ev.numpy()
    # Per-stream pipeline timelines need per-chunk input counts, which only
    # a multi-core plan prices per core.
    want_timeline = bool(args.trace_out) and compiled.schedule is not None
    if args.streaming:
        return _serve_streams(args, compiled, ev, dev, want_timeline)

    fleet = spidr.serve(compiled, spidr.ServeConfig(
        n_replicas=args.replicas, capacity=args.capacity, batch=True,
        max_queue=max(64, args.requests)))
    for r in range(args.requests):
        fleet.submit(ev[:, r], rid=r)
    t0 = time.monotonic()
    fleet.drain()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.monotonic() - t0
    done = fleet.done
    lat = [r.done_at - r.submitted_at for r in done]
    total_counts = None
    batches = 0
    for w in fleet.workers:
        batches += w.batches
        if w.total_input_counts is not None:
            total_counts = (w.total_input_counts if total_counts is None
                            else total_counts + w.total_input_counts)
    mean_counts = total_counts / max(len(done), 1)
    cost = compiled.cost(input_counts=mean_counts)
    log.info(
        "served %d %s streams (%d timesteps each) over %d replica(s) in "
        "%.2fs (%.1f streams/s, %d batches); latency p50 %.3fs; backend=%s "
        "t_block=%d device=%s", len(done), args.snn, spec.timesteps,
        fleet.n_replicas, dt, len(done) / dt, batches, float(np.median(lat)),
        compiled.engine.cfg.backend, args.t_block, dev)
    if compiled.schedule is None:
        log.info(
            "chip estimate/stream: %.2f ms @%dMHz, %.1f uJ, sparsity "
            "%.1f%%, async speedup %.2fx", cost.latency_ms, 50,
            cost.energy_uj, 100 * cost.mean_sparsity, cost.async_speedup)
    else:
        log.info(
            "multi-core attribution/stream: makespan %d cycles, per-core "
            "busy %s, routing %s, load imbalance %.2fx, energy %.1f uJ "
            "(%.2f uJ routing)", cost.makespan_cycles,
            cost.busy_cycles.tolist(), cost.routing_cycles.tolist(),
            cost.load_imbalance, cost.energy_uj, cost.routing_energy_uj)
    _export_telemetry(compiled, args.metrics_out, args.trace_out,
                      [("batch-mean", mean_counts)] if want_timeline else [])
    fleet.shutdown()
    return fleet


def _serve_streams(args, compiled, ev, dev, want_timeline):
    """``--streaming``: every request through a fleet of stream workers."""
    spec = compiled.spec
    fleet = spidr.serve(compiled, spidr.ServeConfig(
        n_replicas=args.replicas, capacity=args.capacity,
        chunk_T=args.chunk_T, max_queue=max(64, args.requests),
        watchdog_s=args.watchdog_s, snapshot_dir=args.snapshot_dir,
        snapshot_every=args.snapshot_every,
        collect_chunk_counts=want_timeline))
    for r in range(args.requests):
        fleet.submit(ev[:, r], rid=r)
    t0 = time.monotonic()
    ticks = 0
    while fleet.step():
        ticks += 1
        if args.metrics_out and args.metrics_every \
                and ticks % args.metrics_every == 0:
            obs.default_registry().write(args.metrics_out)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.monotonic() - t0
    done = fleet.done
    lat = [r.done_at - r.submitted_at for r in done]
    ttfr = [r.first_reply_at - r.submitted_at for r in done]
    log.info(
        "streamed %d %s streams (%d timesteps, chunk_T=%d) over %d "
        "replica(s) in %.2fs (%.1f streams/s, %d fleet ticks, %d rewinds); "
        "first-reply p50 %.3fs; latency p50 %.3fs; backend=%s t_block=%d "
        "device=%s", len(done), args.snn, spec.timesteps, args.chunk_T,
        fleet.n_replicas, dt, len(done) / dt, ticks,
        sum(w.restarts for w in fleet.workers), float(np.median(ttfr)),
        float(np.median(lat)), compiled.engine.cfg.backend, args.t_block, dev)
    log.info("chip estimate/stream (cumulative): %.0f cycles p50, %.1f uJ p50",
             float(np.median([r.cycles for r in done])),
             float(np.median([r.energy_uj for r in done])))
    _export_telemetry(compiled, args.metrics_out, args.trace_out,
                      [(r.rid, r.input_counts) for r in done]
                      if want_timeline else [])
    fleet.shutdown()
    return fleet


def _export_telemetry(compiled, metrics_out, trace_out, stream_counts) -> None:
    """Final metrics dump + Chrome-trace export for the serving run.

    ``stream_counts``: (label, per-timestep input counts) pairs, each
    re-priced through the multi-core pipeline model and merged into the
    trace as its own process row (pid 100+i), beside the host spans.
    """
    if metrics_out:
        obs.default_registry().write(metrics_out)
        log.info("metrics written to %s", metrics_out)
    if not trace_out:
        return
    extra = []
    for i, (label, counts) in enumerate(stream_counts):
        if counts is None:
            continue
        extra.extend(compiled.pipeline_trace(
            input_counts=counts, label=f"stream {label}", pid=100 + i))
    obs.default_tracer().export(trace_out, extra_events=extra)
    log.info("chrome trace written to %s (%d pipeline-timeline events)",
             trace_out, len(extra))


def main(argv=None) -> None:
    args = parse_args(argv)
    obs.logging_setup(json_mode=args.log_json, stream=sys.stderr)
    if args.arch is not None:
        serve_lm(args)
    else:
        serve_snn(args)


if __name__ == "__main__":
    main()
