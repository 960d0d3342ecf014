#!/usr/bin/env python3
"""The program's spans in the benchmark's cells, on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/probe_spans_cuda.py [--cells a,b] [--seed N] [--cost-rounds K]

For each cell of ``BENCHMARK.json`` (all by default), made as
``portbench/harness.py:run_cell`` makes it (the graph and requests from
the seed, the configuration's driver), it records the program's spans
around the driver's build (``build_s`` on the host clock, as the harness
takes it), warms up, runs the driver's two traced stretches (device alone,
then host ranges), and then a third, the span stretch: the device alone
again, for the traffic's ``trace_seconds``, with the program's spans
recorded (``portbench/spans.py:SpanTracer``). It prints one JSON line a
cell: the build's spans by try and stage; the span stretch's readings
(``build_refused_s``, ``build_encode_s``, ``step_idle_us``,
``flag_idle_us``, ``entry_idle_us``, ``fold_device_us``), its
``idle_spans`` beside the range stretch's ``idle_gaps``, the device time
of the ops by the span that launched them, the alignment of spans and
trace (ops tied inside the request span, idle charged against the
stretch's idle, the clock drift), each stretch's wall seconds and µs a
step or call; the same readings without the correction for the trace
clock's drift (``stretch_uncorrected``, beside each mark's bounds,
``marks_us``) and of a span stretch run before the driver's two
(``stretch_before_traced``).
With ``--cost-rounds K`` it also times, on a solve cell, K rounds of whole
solves (on an SpMV cell of 64-call bursts from an idle queue) with
recording off and on, each with no profiler and under a device-only one,
in turns: the cost of recording a step, a call and a span; and at the end
an empty span's cost in each mode. The card's name and power limit come
first, from nvidia-smi.

``--device cpu --bench DIR`` rehearses it on the CPU over a benchmark tree
at DIR (a ``BENCHMARK.json`` and ``portbench/``, its configurations cut
small); the CPU has no device ops, so the stretch readings are null there.
Imports only the port and the benchmark.
"""

import argparse
import gc
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def nvidia_smi() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def build_summary(rec, build_s: float) -> dict:
    """The build's spans: each try, the encode's stages under the built
    try, the compiles, and the accounting of build.auto."""
    from portbench import spans

    auto = [s for s in rec if s.name == "build.auto"]
    tries = [(i, s) for i, s in enumerate(rec) if s.name == "build.try"]
    built = [s for _, s in tries if s.attrs.get("outcome") == "built"]
    stages = {}
    for s in rec:
        if s.name == "build.encode":
            stages[s.attrs["stage"]] = stages.get(s.attrs["stage"], 0.0) + s.seconds
    refused = spans.build_refused_s(rec)
    out = {"build_s": build_s,
           "build_auto_s": auto[0].seconds if auto else None,
           "variant": auto[0].attrs.get("variant") if auto else None,
           "tries": [[s.attrs["variant"], s.attrs.get("outcome"), s.seconds] for _, s in tries],
           "build_refused_s": refused, "build_encode_s": spans.build_encode_s(rec),
           "encode_stages_s": stages,
           "nvcc": [[s.attrs["source"], s.seconds] for s in rec if s.name == "kernels.nvcc"],
           "spans": len(rec)}
    if auto and built:
        out["auto_over_build_s"] = auto[0].seconds / build_s
        out["tries_over_auto"] = (refused + built[0].seconds) / auto[0].seconds
    return out


def stretch_summary(st, request: str, unit: str) -> dict:
    from portbench import spans

    return {"step_idle_us": spans.step_idle_us(st), "flag_idle_us": spans.flag_idle_us(st),
            "entry_idle_us": spans.entry_idle_us(st),
            "fold_device_us": spans.fold_device_us(st),
            "steps": spans.count(st, "fixpoint.step"), "calls": spans.count(st, "spmv"),
            "spans": len(st.spans), "idle_spans": spans.idle_spans(st),
            "ops_by_span": ops_by_span(st),
            "alignment": spans.alignment(st, request, unit), "window_s": st.window_s}


def _modes(k: int):
    """The four ways a measurement runs, rotated each round: recording off
    or on, each with no profiler or a device-only one."""
    modes = [("off", False), ("on", False), ("off", True), ("on", True)]
    return modes[k % 4:] + modes[:k % 4]


def _timed(d, mode, fn):
    """fn() timed by the host clock to a synchronise, under ``mode``, the
    garbage collected first; returns (seconds, fn's result, the recording
    or None)."""
    from sparseharness_tpu_torch.utils import timing
    from portbench import trace as tracing
    from portbench.harness import now, sync

    (rec, prof) = mode
    tracer = tracing.Tracer() if prof else None
    gc.collect()
    sync(d.device)
    if tracer is not None:
        tracer.start()
    if rec == "on":
        timing.start_recording()
    t = now()
    out = fn()
    sync(d.device)
    dt = now() - t
    spans = timing.stop_recording() if rec == "on" else None
    if tracer is not None:
        tracer.stop()
    return dt, out, spans


def _summary(per: dict, unit: str) -> dict:
    med = {k: statistics.median(v) for k, v in per.items()}
    return {f"{unit}_us": per, f"median_{unit}_us": med,
            "cost_us": med["on"] - med["off"],
            "cost_us_profiled": med["on+profiler"] - med["off+profiler"]}


def cost_solve(d, rounds: int) -> dict:
    """Whole solves under the four modes in turns: µs a step in each, the
    cost of recording a step and a span, without and with a device-only
    profiler running."""
    per = {}
    spans_a_step = None
    for k in range(rounds):
        for mode in _modes(k):
            root = d.roots[(k * 7 + 1) % len(d.roots)]
            dt, res, spans = _timed(d, mode, lambda: d._solve(root))
            key = mode[0] + ("+profiler" if mode[1] else "")
            per.setdefault(key, []).append(dt / max(res.iterations, 1) * 1e6)
            if spans is not None:
                spans_a_step = len(spans) / max(res.iterations, 1)
    out = _summary(per, "step")
    out["spans_a_step"] = spans_a_step
    out["cost_us_a_span"] = out["cost_us"] / spans_a_step
    out["cost_us_a_span_profiled"] = out["cost_us_profiled"] / spans_a_step
    return out


def cost_spmv(d, rounds: int, burst: int = 64) -> dict:
    """Bursts of calls from an idle queue under the four modes in turns:
    the host's µs a call in each (3 spans a call)."""
    per = {}
    for k in range(rounds):
        for mode in _modes(k):
            def burst_calls():
                for i in range(burst):
                    d._call(d.xs[i % len(d.xs)])

            dt, _, _ = _timed(d, mode, burst_calls)
            key = mode[0] + ("+profiler" if mode[1] else "")
            per.setdefault(key, []).append(dt / burst * 1e6)
    out = _summary(per, "call")
    out["cost_us_a_span"] = out["cost_us"] / 3
    out["cost_us_a_span_profiled"] = out["cost_us_profiled"] / 3
    return out


def span_cost_us(n: int = 20000) -> dict:
    """µs of one empty span: off, recorded, recorded under a device-only
    profiler, and so with the garbage collector off."""
    from sparseharness_tpu_torch.utils import timing
    from sparseharness_tpu_torch.utils.timing import span
    from portbench import trace as tracing
    from portbench.harness import now

    def loop():
        gc.collect()
        t = now()
        for _ in range(n):
            with span("x"):
                pass
        return (now() - t) / n * 1e6

    out = {"off": loop()}
    for prof in (False, True):
        for collect in (True, False):
            tracer = tracing.Tracer() if prof else None
            if tracer is not None:
                tracer.start()
            if not collect:
                gc.disable()
            timing.start_recording()
            us = loop()
            timing.stop_recording()
            gc.enable()
            if tracer is not None:
                tracer.stop()
            out["on" + ("+profiler" if prof else "") + ("" if collect else "+nogc")] = us
    return out


def ops_by_span(st, k: int = 12) -> list:
    """[[innermost span of the launch, op, count, device us]], most time first."""
    from portbench import spans, trace as tracing

    by = {}
    for op, i in zip(st.ops, spans.tied(st)):
        where = "no launch" if i is None else (st.spans[i].name if i >= 0 else spans.OUTSIDE)
        key = (where, tracing.short_name(op.name)[:60])
        c, us = by.get(key, (0, 0.0))
        by[key] = (c + 1, us + op.dur)
    top = sorted(by.items(), key=lambda kv: -kv[1][1])[:k]
    return [[w, name, c, us] for (w, name), (c, us) in top]


def mark_bounds(tracer) -> list:
    """[event start − first stamp, second stamp − event end] µs of each
    mark's synchronisation, by the recording's own mapping."""
    data = tracer.trace()
    base = int(data.get("baseTimeNanoseconds", 0))
    syncs = sorted((e["ts"], e.get("dur", 0.0)) for e in data.get("traceEvents", [])
                   if e.get("ph") == "X" and e.get("name") == "cudaDeviceSynchronize")
    out = []
    for a, b in tracer.marks:
        lo, hi = tracer.recording.trace_us(a, base), tracer.recording.trace_us(b, base)
        ts, dur = min(syncs, key=lambda sd: abs(sd[0] - lo)) if syncs else (None, None)
        out.append(None if ts is None else [round(ts - lo, 2), round(hi - ts - dur, 2)])
    return out


def _device_units(d, traffic, ctx) -> int:
    """Calls or steps of the device stretch: the range stretch counted
    them; the device stretch's are counted again, as its ops over the
    range stretch's ops a unit."""
    units = ctx.traced_calls or ctx.traced_steps
    return round(len(ctx.trace.ops) * units / max(len(ctx.range_trace.ops), 1)) if units else 0


def run_config(bench, config: str, cells, seed: int, device, cost_rounds: int):
    import torch

    from portbench import harness, spans, trace as tracing
    from portbench.harness import Ctx, load_module, log, now, sync
    from sparseharness_tpu_torch.formats.sparse import COO
    from sparseharness_tpu_torch.ops import Geometry
    from sparseharness_tpu_torch.utils import timing

    cfg = bench.config(config)
    gen = load_module(bench.here / "graphs" / f"{cfg['generator']}.py")
    tg = now()
    rows, cols, vals, n = gen.make(cfg["params"], seed, device)
    folded = int(torch.unique(rows * n + cols).numel())
    per_cell = {}
    for name in cells:
        traffic = bench.traffic(bench.cell(name)["traffic"])
        driver = load_module(bench.here / "drivers" / f"{traffic['op']}.py")
        per_cell[name] = (traffic, driver, driver.requests(traffic, seed, n, rows, cols, device))
    coo = COO(rows.to(torch.int32).cpu().numpy(), cols.to(torch.int32).cpu().numpy(),
              vals.cpu().numpy(), (n, n))
    del rows, cols, vals
    log(f"{config}: graph of {n} vertices, {coo.nnz} entries in {now() - tg:.3f} s")
    for name in cells:
        traffic, driver, requests = per_cell[name]
        reference = load_module(bench.here / "reference" /
                                f"{driver.reference_name(traffic)}.py")
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ctx = Ctx(name, traffic, n, folded)
        d = driver.Driver(ctx, coo, requests, Geometry(), device, seed, reference)
        sync(device)
        timing.start_recording()
        tb = now()
        d.build()
        sync(device)
        ctx.build_s = now() - tb
        build_rec = timing.stop_recording()
        tw = now()
        d.warm_up()
        sync(device)
        warm_s = now() - tw
        request = "spmv" if traffic["op"] == "spmv" else "fixpoint.solve"
        unit = "spmv" if traffic["op"] == "spmv" else "fixpoint.step"
        pre, pre_units = d._stretch(traffic, spans.SpanTracer())
        t1 = now()
        d.traced(traffic)
        t2 = now()
        units_dev = len(ctx.trace.ops) and _device_units(d, traffic, ctx)
        tracer = spans.SpanTracer()
        st, units = d._stretch(traffic, tracer)
        t3 = now()
        raw = tracer.read(marks=False)
        units_s = st.window_s / units if units else None
        line = {"cell": name, "seed": seed, "device": str(device),
                "build": build_summary(build_rec, ctx.build_s), "warm_up_s": warm_s,
                "traced_s": t2 - t1, "span_stretch_s": t3 - t2, "span_stretch_units": units,
                "span_stretch_us_a_unit": units_s * 1e6 if units_s else None,
                "device_stretch_us_a_unit": (ctx.trace.window_s / units_dev * 1e6
                                             if units_dev else None),
                "idle_gaps": tracing.idle_gaps(ctx.range_trace),
                "device_idle_pct": (100.0 * (1.0 - tracing.busy_s(ctx.trace) /
                                             ctx.trace.window_s)
                                    if ctx.trace.ops else None),
                "stretch": stretch_summary(st, request, unit),
                "marks_us": mark_bounds(tracer),
                "stretch_uncorrected": {
                    k: v for k, v in stretch_summary(raw, request, unit).items()
                    if k.endswith("_us") or k in ("idle_spans", "alignment")},
                "stretch_before_traced": {
                    "us_a_unit": pre.window_s / pre_units * 1e6 if pre_units else None,
                    **{k: v for k, v in stretch_summary(pre, request, unit).items()
                       if k.endswith("_us") or k == "idle_spans"}}}
        if cost_rounds:
            line["cost"] = (cost_spmv(d, cost_rounds) if traffic["op"] == "spmv"
                            else cost_solve(d, cost_rounds))
        d.release()
        del d
        print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cells", default=None, help="comma-separated cells (default: all)")
    p.add_argument("--seed", type=int, default=2**31 + 1717)
    p.add_argument("--cost-rounds", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--bench", default=str(ROOT), help="a tree with BENCHMARK.json and portbench/")
    args = p.parse_args(argv)
    import torch

    from portbench import harness

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("probe_spans_cuda: no CUDA device is available", file=sys.stderr)
        return 1
    print(nvidia_smi() if device.type == "cuda" else "cpu", flush=True)
    bench = harness.Bench(Path(args.bench), Path(args.bench) / "portbench")
    names = (args.cells.split(",") if args.cells
             else [w["name"] for w in bench.spec["workloads"]])
    by_config = {}
    for name in names:
        by_config.setdefault(bench.cell(name)["config"], []).append(name)
    for config, cells in by_config.items():
        run_config(bench, config, cells, args.seed, device, args.cost_rounds)
    if args.cost_rounds:
        print(json.dumps({"span_cost_us": span_cost_us()}), flush=True)
    found = harness.forbidden_modules()
    if found:
        print(f"modules that may not be loaded were loaded: {found}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
