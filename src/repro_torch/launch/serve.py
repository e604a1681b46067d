"""Serving launcher: batched requests through the continuous-batching runtime.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm-2b --smoke \
        --requests 8 --max-new 16 [--device cpu]

By default requests run through
:class:`repro_torch.runtime.engine.ServingRuntime` (chunked prefill +
bucketed decode + metrics) on the card; ``--device cpu`` serves on the
CPU.  ``--legacy`` serves through the fixed-slot
:class:`~repro_torch.serving.engine.ServeEngine` wrapper instead (the
token-identical oracle).  The weights are random, drawn from a
``torch.Generator`` seeded 0 on the serving device.

``--paged`` serves off the paged KV-cache (``--page-size``, ``--pages``,
``--no-prefix-share``).

``--mesh DATAxMODEL`` serves sharded (``ServingRuntime(mesh=)``): ``1x1``
in this process; more ranks under ``python -m torch.distributed.run``
(gloo with ``--device cpu``, NCCL on the card), every rank serving the
same requests; only rank 0 prints.  ``--paged`` does not serve sharded.

The port of ``repro.launch.serve``, with its flags plus ``--device``.  The
JAX package simulates a multi-device mesh in one process; the port runs
one process per rank.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.interop import resolve_device
from repro_torch.launch.mesh import cli_mesh
from repro_torch.models.transformer import Model
from repro_torch.runtime.engine import ServingRuntime
from repro_torch.serving.engine import Request, ServeEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default: the card; 'cpu' runs "
                         "the kernels' plain versions)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=64,
                    help="max prefill chunk (power-of-two lattice below it); "
                         "auto-disabled for SSM/hybrid archs")
    ap.add_argument("--legacy", action="store_true",
                    help="serve through the old fixed-slot ServeEngine "
                         "(whole-prompt prefill, full-slot decode)")
    ap.add_argument("--paged", action="store_true",
                    help="serve off the paged KV-cache: fixed-size pages, "
                         "per-request page tables, admission capped by free "
                         "pages, content-hash prefix sharing")
    ap.add_argument("--page-size", type=int, default=16,
                    help="token rows per KV page (paged mode)")
    ap.add_argument("--pages", type=int, default=None,
                    help="total pool pages incl. the reserved null page "
                         "(default: null page + slots*max_len rows worth)")
    ap.add_argument("--no-prefix-share", action="store_true",
                    help="disable content-hash prefix sharing (paged mode)")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="serve sharded over a data×model mesh, e.g. '2x4' "
                         "(more than one rank runs under python -m "
                         "torch.distributed.run)")
    ap.add_argument("--pretune", action="store_true",
                    help="autotune the model's contraction working set "
                         "before serving (warm start for strategy='tuned')")
    ap.add_argument("--tuning-cache", default=None,
                    help="tuning-cache JSON path (default: the "
                         "dispatcher's, repro_torch.tuning.dispatch."
                         "default_cache_path)")
    ap.add_argument("--tune-policy", default=None,
                    choices=["off", "cached", "measure", "predict"],
                    help="dispatcher policy for pretune + serving; "
                         "'predict' answers cache misses from the learned "
                         "cost model when confident, so --pretune only "
                         "measures low-confidence keys (default: measure)")
    ap.add_argument("--cache-import", action="append", default=[],
                    metavar="JSON", dest="cache_imports",
                    help="merge a tuning cache exported by another machine "
                         "(repro_torch.tuning.federate) into this one before "
                         "pretune; repeatable")
    ap.add_argument("--trace", default=None, metavar="OUT_JSON",
                    help="record a span trace of warm-up + serving and "
                         "write it as Chrome-trace JSON (open in "
                         "https://ui.perfetto.dev)")
    ap.add_argument("--trace-jsonl", default=None, metavar="OUT_JSONL",
                    help="also write the trace as flat JSONL records "
                         "(one event per line, span attrs hoisted)")
    ap.add_argument("--trace-capacity", type=int, default=65536,
                    help="trace ring-buffer size in events (oldest "
                         "events drop beyond it)")
    ap.add_argument("--metrics-every", type=int, default=0, metavar="TICKS",
                    help="print a metrics-registry snapshot every N "
                         "serving ticks (runtime mode only)")
    ap.add_argument("--metrics-jsonl", default=None, metavar="OUT_JSONL",
                    help="sample the metrics registry every serving tick "
                         "and append one flat JSON record per sample "
                         "(runtime mode only)")
    ap.add_argument("--metrics-prom", default=None, metavar="OUT_TXT",
                    help="write a Prometheus text-exposition dump of the "
                         "sampled series (gauges + quantile summaries) "
                         "after serving")
    ap.add_argument("--metrics-interval", type=float, default=1.0,
                    metavar="SECONDS",
                    help="minimum seconds between metric samples "
                         "(default 1.0; 0 = sample every tick — a full "
                         "registry snapshot per tick is measurable on "
                         "the hot loop)")
    ap.add_argument("--watchdogs", action="store_true",
                    help="run the SLO watchdog pack (decode stall, "
                         "recompile storm, page-pool pressure) over the "
                         "sampled series; alerts print and, when tracing "
                         "is on, land as trace instants")
    ap.add_argument("--numerics-every", type=int, default=0, metavar="N",
                    help="probe every Nth decode step's logits for "
                         "NaN/Inf (one device sync per probe; 0 = off)")
    ap.add_argument("--drift-check", action="store_true",
                    help="after serving, compare traced contraction "
                         "durations against the tuning cache, evict + "
                         "re-measure drifted keys and refit the cost "
                         "model past the drift gate (enables tracing)")
    args = ap.parse_args()
    if args.paged and args.legacy:
        ap.error("--paged serves through the runtime; drop --legacy")
    if args.paged and args.mesh:
        ap.error("--paged does not serve sharded; drop --mesh")
    want_health = bool(args.metrics_jsonl or args.metrics_prom
                       or args.watchdogs or args.numerics_every > 0)
    if args.legacy and (want_health or args.drift_check):
        ap.error("fleet-health options serve through the runtime; "
                 "drop --legacy")

    tracer = None
    if args.trace or args.trace_jsonl or args.drift_check:
        from repro_torch.obs import trace as obs_trace

        tracer = obs_trace.enable_tracing(capacity=args.trace_capacity)

    device = resolve_device(args.device)
    with cli_mesh(args.mesh, device.type) as mesh:
        serve(args, device, mesh, tracer, want_health)


def serve(args, device, mesh, tracer, want_health):
    if mesh is not None:
        print(f"mesh: {args.mesh} over {mesh.size()} {device.type} ranks")
    cfg = get_config(args.arch, smoke=args.smoke)
    model = Model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0))

    tuner = None
    if args.cache_imports:
        from repro_torch.tuning.dispatch import (
            Dispatcher, default_cache_path, set_dispatcher,
        )
        from repro_torch.tuning.federate import import_into

        tuner = Dispatcher(args.tuning_cache or default_cache_path(),
                           policy=args.tune_policy or "measure")
        for src in args.cache_imports:
            st = import_into(tuner.cache, src)
            print(f"cache-import {src}: +{st['added']} added, "
                  f"{st['merged']} merged ({st['imported']} read)")
        set_dispatcher(tuner)

    t0 = time.perf_counter()
    if args.legacy:
        engine = ServeEngine(
            cfg, params, slots=args.slots, max_len=args.max_len,
            pretune=args.pretune, tuner=tuner,
            tuning_cache=args.tuning_cache,
            tune_policy=args.tune_policy, mesh=mesh,
        )
        runtime = engine.runtime
    else:
        engine = runtime = ServingRuntime(
            cfg, params, slots=args.slots, max_len=args.max_len,
            prefill_chunk=args.chunk,
            paged=args.paged, page_size=args.page_size, pages=args.pages,
            prefix_sharing=not args.no_prefix_share,
            pretune=args.pretune, tuner=tuner,
            tuning_cache=args.tuning_cache,
            tune_policy=args.tune_policy, mesh=mesh,
        )
        print(f"runtime buckets: {runtime.lattice.describe()}")
        if args.paged:
            print(f"page pool: {runtime.pool.usable} usable pages x "
                  f"{runtime.pool.page_size} rows "
                  f"(prefix sharing {'off' if args.no_prefix_share else 'on'})")
    if args.pretune:
        print(f"pretune: {runtime.pretune_stats} "
              f"({time.perf_counter() - t0:.1f}s, "
              f"dispatcher {runtime.tuner.stats})")

    rng = np.random.default_rng(0)
    reqs = [
        Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size, size=rng.integers(4, 24)).astype(np.int32),
            max_new_tokens=args.max_new,
        )
        for i in range(args.requests)
    ]
    registry = runtime.register_metrics()

    monitor = None
    if want_health:
        from repro_torch.obs.health import HealthMonitor, default_watchdogs
        from repro_torch.obs.timeseries import MetricsSampler

        sampler = MetricsSampler(
            registry, interval_s=args.metrics_interval,
            jsonl_path=args.metrics_jsonl,
        )
        monitor = HealthMonitor(
            sampler,
            watchdogs=default_watchdogs() if args.watchdogs else [],
            on_alert=lambda a: print(
                f"ALERT [{a.severity}] {a.name}: {a.message}"),
        )
        monitor.attach(runtime, numerics_every=args.numerics_every)
        monitor.register()

    printers = []
    if args.metrics_every > 0 and not args.legacy:
        every = args.metrics_every

        def print_cb(step):
            if step % every == 0:
                snap = registry.snapshot()
                s = snap.get("serving", {})
                d = snap.get("dispatcher", {})
                print(f"[tick {step}] tokens_out={s.get('tokens_out')} "
                      f"done={s.get('requests_done')} "
                      f"occupancy={s.get('slot_occupancy', 0.0):.2f} "
                      f"dispatcher_hits={d.get('hits')} "
                      f"misses={d.get('misses')}")

        printers.append(print_cb)
    if monitor is not None:
        printers.append(lambda step: monitor.tick())

    tick_cb = None
    if printers:
        def tick_cb(step):
            for p in printers:
                p(step)

    t0 = time.perf_counter()
    if args.legacy:
        engine.serve(reqs)
    else:
        engine.serve(reqs, tick_callback=tick_cb)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.output) for r in reqs)
    print(f"served {len(reqs)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens / dt:.1f} tok/s)")
    snap = runtime.metrics.snapshot(runtime.buckets)
    print("metrics: " + ", ".join(
        f"{k}={v:.3g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in snap.items()
    ))
    if args.paged:
        print("pages: " + ", ".join(
            f"{k}={v:.3g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in runtime.pool.stats().items()
        ))
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt[:8]={r.prompt[:8].tolist()} -> {r.output}")

    if monitor is not None:
        st = monitor.stats()
        print(f"health: {st['checks']} checks, {st['alerts_total']} alerts"
              + ("".join(f", {k[len('alerts_'):]}={v}"
                         for k, v in sorted(st.items())
                         if k.startswith("alerts_") and k != "alerts_total")))
        if args.metrics_prom:
            monitor.sampler.write_prometheus(args.metrics_prom)
            print(f"metrics: prometheus text -> {args.metrics_prom}")
        if args.metrics_jsonl:
            print(f"metrics: {monitor.sampler.samples} samples -> "
                  f"{args.metrics_jsonl}")

    if args.drift_check:
        from repro_torch.tuning.dispatch import get_dispatcher
        from repro_torch.tuning.drift import DriftDetector

        disp = runtime.tuner if runtime.tuner is not None else get_dispatcher()
        report = DriftDetector(disp).run(tracer.events())
        print("drift: " + ", ".join(
            f"{k}={v}" for k, v in report.summary().items()))
        for key in report.drifted:
            kd = report.keys[key]
            print(f"  drifted {key}: live={kd.live_us:.1f}us "
                  f"cached={kd.cached_us:.1f}us score={kd.score:.2f} "
                  f"({'re-measured' if key in report.remeasured else 'evicted'})")

    if tracer is not None:
        from repro_torch.obs import export as obs_export

        if args.trace:
            n = obs_export.write_chrome_trace(args.trace, tracer)
            print(f"trace: {n} events -> {args.trace} "
                  f"({tracer.dropped} dropped)")
        if args.trace_jsonl:
            n = obs_export.write_jsonl(args.trace_jsonl, tracer)
            print(f"trace: {n} records -> {args.trace_jsonl}")


if __name__ == "__main__":
    main()
