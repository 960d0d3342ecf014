"""One fixpoint solve after another, each from the next root, of the
traffic's ``algorithm``: ``fixpoint_components(algorithm, ...)`` once,
then one ``run_fixpoint`` after another, each from the app's x0 moved to
its own root. The window is whole solves: it ends when the last solve
that started before the time ran out has converged.

Its reference is ``reference/<algorithm>.py``: ``prepare(n, rows, cols,
vals, device) -> graph`` and ``solve(graph, root, max_iter) -> (x,
steps, converged)``. A solve's x is compared exactly (``dist_mismatch``:
entries that differ, over the solves checked), and so are its steps
(``steps_mismatch``: solves whose count differs); ``unconverged`` counts
the window's solves that hit the app's step limit.
"""

from __future__ import annotations

import statistics
from typing import List

import torch

from portbench import generator, spans, trace as tracing
from portbench.harness import Reservoir, log, now, sync

#: the benchmark's ranges around the step and the convergence test that
#: it hands the fixpoint loop in the range stretch
RANGES = ("fixpoint.step", "fixpoint.converged")


def reference_name(traffic: dict) -> str:
    return traffic["algorithm"]


def requests(traffic: dict, seed: int, n: int, rows, cols, device):
    return generator.roots(traffic, seed, n, rows, cols, device)


class Driver:
    unit = "step"
    variant = None  # fixpoint_components does not return the variant auto resolved

    def __init__(self, ctx, coo, roots, geometry, device, seed: int, reference):
        self.ctx, self.coo, self.roots, self.geometry, self.device = ctx, coo, roots, geometry, device
        self.ref = reference
        self.sample = Reservoir(int(ctx.traffic["check_solves"]), seed)
        self.longest = None
        self.converged: List[bool] = []
        self.requests = self.units = 0

    def build(self) -> None:
        from sparseharness_tpu_torch.algorithms import apps

        self.root0 = self.roots[0]
        self.comp = apps.fixpoint_components(
            self.ctx.traffic["algorithm"], self.coo, self.root0, variant="auto",
            geometry=self.geometry, device=self.device)
        self.limit = self.comp.limit

    def _x0(self, root: int):
        """The app's x0 moved to ``root``: its entries at root0 and root
        swapped."""
        x0 = self.comp.x0
        x = x0.clone()
        idx = torch.tensor([self.root0, root], device=x0.device)
        x[idx] = x0[idx.flip(0)]
        return x

    def _solve(self, root: int, step=None, convergence=None):
        from sparseharness_tpu_torch.algorithms.fixpoint import run_fixpoint

        return run_fixpoint(step or self.comp.step, self._x0(root),
                            convergence=convergence or self.comp.convergence,
                            max_iter=self.limit)

    def warm_up(self) -> None:
        from sparseharness_tpu_torch.algorithms.fixpoint import run_fixpoint

        run_fixpoint(self.comp.step, self._x0(self.root0),
                     convergence=self.comp.convergence, max_iter=3)

    def window(self, seconds: float) -> None:
        i, t_start = 0, now()
        deadline = t_start + seconds
        while True:
            root = self.roots[i % len(self.roots)]
            ts = now()
            res = self._solve(root)
            te = now()
            self.ctx.solve_s.append(te - ts)
            self.ctx.iterations.append(res.iterations)
            self.converged.append(bool(res.converged))
            self.sample.offer((root, res))
            if self.longest is None or res.iterations > self.longest[1].iterations:
                self.longest = (root, res)
            i += 1
            if te >= deadline:
                break
        sync(self.device)
        self.ctx.window_s = now() - t_start
        self.requests = len(self.ctx.iterations)
        self.units = sum(self.ctx.iterations)
        log(f"window: {self.requests} solves, {self.units / self.requests:.3f} steps a solve, "
            f"{self.ctx.window_s / self.units * 1e6:.2f} us a step, {self.ctx.window_s:.3f} s")

    def traced(self, traffic: dict) -> None:
        self.ctx.trace, _ = self._stretch(traffic, tracing.Tracer())
        self.ctx.range_trace, self.ctx.traced_steps = self._stretch(
            traffic, tracing.Tracer(RANGES, host=True))
        self.ctx.span_trace, _ = self._stretch(spans.stretch_traffic(traffic),
                                               spans.SpanTracer())

    def _stretch(self, traffic: dict, tracer):
        from torch.profiler import record_function

        budget = float(traffic["trace_seconds"])
        comp, steps = self.comp, [0]

        def step(x):
            # the step is called with the device idle: the convergence test
            # before it read its flag back
            if tracer.active and now() - t >= budget:
                tracer.stop()
            if not tracer.active:
                return comp.step(x)
            steps[0] += 1
            if not tracer.host:
                return comp.step(x)
            with record_function("fixpoint.step"):
                return comp.step(x)

        def convergence(a, b):
            if not (tracer.active and tracer.host):
                return comp.convergence(a, b)
            with record_function("fixpoint.converged"):
                return bool(comp.convergence(a, b))

        sync(self.device)
        tracer.start()
        t, i = now(), 1
        while tracer.active:
            self._solve(self.roots[i % len(self.roots)], step, convergence)
            i += 1
            if tracer.active and now() - t >= budget:
                tracer.stop()
        return tracer.read(), steps[0]

    def release(self) -> None:
        self.comp = None

    def end_to_end(self) -> dict:
        ms = [s * 1e3 for s in self.ctx.solve_s]
        out = {"solve_ms": self.ctx.window_s * 1e3 / len(ms)}
        if len(ms) >= 2:
            out["solve_p95_ms"] = statistics.quantiles(ms, n=20)[-1]
        return out

    def check(self, limits: dict):
        coo, ref = self.coo, self.ref
        graph = ref.prepare(self.ctx.n, torch.from_numpy(coo.rows), torch.from_numpy(coo.cols),
                            torch.from_numpy(coo.vals), self.device)
        picked = {id(r[1]): r for r in self.sample.items + [self.longest]}
        dist, steps, failed = 0, 0, 0
        for root, res in picked.values():
            x_ref, it_ref, _ = ref.solve(graph, root, self.limit)
            bad = int((res.x.to(x_ref.dtype) != x_ref).sum())
            dist += bad
            steps += res.iterations != it_ref
            failed += bool(bad) or res.iterations != it_ref
        unconverged = self.converged.count(False)
        checks = {"dist_mismatch": (dist, limits["dist_mismatch"]),
                  "steps_mismatch": (int(steps), limits["steps_mismatch"]),
                  "unconverged": (unconverged, limits["unconverged"])}
        return checks, int(failed) + unconverged
