"""Run one cell of ``BENCHMARK.json`` once: set-up, the measured window,
the traced stretch, and the comparison with the plain reference.

A cell names a configuration (``configs/<config>.json``, whose
``generator`` is ``graphs/<generator>.py``) and a traffic mix
(``traffic/<traffic>.json``, read by ``generator.py``). The mix's ``op``
names its request driver, ``drivers/<op>.py``, and the driver names the
plain reference, ``reference/<name>.py``, from the mix (its semiring or
its algorithm). The cell's comparison limits are ``limits/<cell>.json``
and its per-layer metrics ``metrics/<metric>.py``. Nothing here names a
cell, a configuration, a traffic mix, a reference or a metric.

So a configuration is added by new files and entries alone:

- ``configs/<config>.json``: its ``generator``, the ``params`` it runs at,
  its ``route``, and ``tiny``, the ``params`` that the benchmark's CPU
  tests cut it to (a run never reads ``tiny``);
- ``graphs/<generator>.py``, where no configuration uses that generator yet;
- ``limits/<cell>.json`` for each of its cells;
- its entries in ``BENCHMARK.json``: the configuration, its cells, and the
  cells in the ``workloads`` lists of the metrics they report.

A traced run records the program's spans (``utils/timing.py``) around the
build, and adds three stretches after the window: the device alone, the
host's ranges, and then the program's spans over the device alone
(``spans.py``). The untraced run records nothing.

The program is driven as a user drives it, with ``variant="auto"``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import random
import sys
import time
from pathlib import Path
from typing import List, Optional

import torch

from portbench import spans, trace as tracing, work

HERE = Path(__file__).resolve().parent
#: modules that may not be loaded in a run, by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "sparseharness_tpu")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_module(path: Path):
    """A module from its file, under a name of its own."""
    name = f"portbench_{path.parent.name}_{path.stem}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root`` (the
    checkout) and ``here`` (this folder)."""

    def __init__(self, root: Path, here: Path = HERE):
        self.root, self.here = Path(root), Path(here)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for c in self.spec["workloads"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.here / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.here / "limits" / f"{cell}.json").read_text())

    def metrics(self, kind: str, cell: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
        return [m for m in self.spec[kind] if cell in m.get("workloads", [cell])]


def route_record(cfg: dict, d, held: Optional[int]) -> dict:
    """The route a run took: the variant ``auto`` resolved where the
    program returns it (``build_operand_auto``), else the configuration's
    ``route`` where one of its ``route_launches`` ran (``_build.LAUNCHES``,
    counted over the window), else the launches' names; the device bytes
    that the build left allocated; the launches per call or step."""
    from sparseharness_tpu_torch.ops import _build

    launched = {k: v / max(d.units, 1) for k, v in _build.LAUNCHES.items() if v}
    route = d.variant
    if route is None:
        route = (cfg["route"] if set(launched) & set(cfg["route_launches"])
                 else "+".join(sorted(launched)) or None)
    return {"route": route, "expected": cfg["route"], "as_expected": route == cfg["route"],
            "operand_device_bytes": held, f"launches_per_{d.unit}": launched}


class Reservoir:
    """A uniform sample of k items of a stream of unknown length, drawn
    from the seed (Algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k, self.items, self.seen = k, [], 0
        self._rng = random.Random(seed)

    def offer(self, item) -> None:
        if self.seen < self.k:
            self.items.append(item)
        else:
            j = self._rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


@dataclasses.dataclass
class Ctx:
    """What a run measured, for the per-layer metric readers."""

    cell: str
    traffic: dict
    n: int
    folded: int                 # distinct (row, col) entries of the matrix
    build_s: float = 0.0        # host clock around the program's build
    window_s: float = 0.0
    calls: int = 0              # SpMV calls completed in the window
    solve_s: List[float] = dataclasses.field(default_factory=list)
    iterations: List[int] = dataclasses.field(default_factory=list)
    enqueue_s: List[float] = dataclasses.field(default_factory=list)  # a call, per burst
    trace: Optional[tracing.Trace] = None        # the device stretch
    range_trace: Optional[tracing.Trace] = None  # the range stretch
    traced_calls: int = 0       # SpMV calls of the range stretch
    traced_steps: int = 0       # fixpoint steps of the range stretch
    build_spans: Optional[list] = None                # the build's spans (a timing.Recording)
    span_trace: Optional[spans.SpanTrace] = None      # the span stretch

    @property
    def bound_s(self) -> float:
        return work.spmv_bound_s(self.n, self.n, self.folded)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def now() -> float:
    return time.perf_counter()


def run_cell(bench: Bench, name: str, seed: int, seconds: float, trace: bool,
             *, device="cuda", t0: Optional[float] = None, geometry=None) -> dict:
    """One run of cell ``name``. Returns ``{"result": <the result line>,
    "route": <the route record>, "checks": {name: (value, limit)}}``.
    ``geometry`` (a ``Geometry``) replaces the program's default, for the
    precision control."""
    from sparseharness_tpu_torch.formats.sparse import COO
    from sparseharness_tpu_torch.ops import Geometry, _build
    from sparseharness_tpu_torch.utils import timing

    t0 = now() if t0 is None else t0
    device = torch.device(device)
    cell = bench.cell(name)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    limits = bench.limits(name)
    geometry = Geometry() if geometry is None else geometry
    on_cuda = device.type == "cuda"

    # the graph, made on the device from the seed, handed over as a COO
    gen = load_module(bench.here / "graphs" / f"{cfg['generator']}.py")
    driver = load_module(bench.here / "drivers" / f"{traffic['op']}.py")
    reference = load_module(bench.here / "reference" / f"{driver.reference_name(traffic)}.py")
    tg = now()
    rows, cols, vals, n = gen.make(cfg["params"], seed, device)
    folded = int(torch.unique(rows * n + cols).numel())
    requests = driver.requests(traffic, seed, n, rows, cols, device)
    coo = COO(rows.to(torch.int32).cpu().numpy(), cols.to(torch.int32).cpu().numpy(),
              vals.cpu().numpy(), (n, n))
    del rows, cols, vals
    log(f"set-up: graph of {n} vertices, {coo.nnz} entries ({folded} distinct) made and "
        f"copied to the host in {now() - tg:.3f} s")
    if on_cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ctx = Ctx(name, traffic, n, folded)
    d = driver.Driver(ctx, coo, requests, geometry, device, seed, reference)
    held = torch.cuda.memory_allocated(device) if on_cuda else 0
    if trace:
        timing.start_recording()
    tb = now()
    try:
        d.build()
        sync(device)
    finally:
        ctx.build_spans = timing.stop_recording() if trace else None
    ctx.build_s = now() - tb
    held = torch.cuda.memory_allocated(device) - held if on_cuda else None
    tw = now()
    d.warm_up()
    sync(device)
    log(f"set-up: build {ctx.build_s:.3f} s, warm-up {now() - tw:.3f} s")
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0
    setup_s = now() - t0

    d.window(seconds)
    mem_peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
    route = route_record(cfg, d, held)
    if trace:
        tt = now()
        d.traced(traffic)
        tr = ctx.range_trace
        log(f"trace: {now() - tt:.3f} s for the three stretches and their reading; "
            f"device stretch {len(ctx.trace.ops)} device ops, {ctx.trace.window_s:.3f} s; "
            f"range stretch {len(tr.ops)} device ops, {sum(not op.range for op in tr.ops)} not "
            f"tied to a launch, {sum(op.range == tracing.OUTSIDE for op in tr.ops)} launched "
            f"outside the ranges, {len(tr.ranges)} ranges, {tr.window_s:.3f} s; "
            f"span stretch {len(ctx.span_trace.ops)} device ops, {len(ctx.span_trace.spans)} "
            f"spans, {ctx.span_trace.window_s:.3f} s")
    d.release()
    if on_cuda:
        torch.cuda.empty_cache()

    tc = now()
    checks, failed = d.check(limits)
    log(f"check: {now() - tc:.3f} s")
    correct = bool(checks) and all(v <= lim for v, lim in checks.values())

    if trace:
        metrics = {}
        for m in bench.metrics("per_layer", name):
            v = load_module(bench.here / "metrics" / f"{m['name']}.py").read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {"setup_s": setup_s, "device_mem_gib": mem_peak / 2 ** 30}
        e2e.update(d.end_to_end())
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in bench.metrics("end_to_end", name) if m["name"] in e2e}
    dev = {"platform": "gpu" if on_cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if on_cuda else device.type,
           "count": 1, "memory_peak_bytes": int(mem_peak)}
    result = {"correct": correct, "attempted": d.requests, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and ctx.trace is not None and ctx.trace.ops:
        dev["busy_s"] = tracing.busy_s(ctx.trace)
        dev["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": tracing.top_ops(ctx.trace),
                               "idle_gaps": tracing.idle_gaps(ctx.range_trace),
                               "idle_spans": spans.idle_spans(ctx.span_trace)}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return {"result": result, "route": route, "checks": checks}
