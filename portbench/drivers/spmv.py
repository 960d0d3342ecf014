"""Back-to-back SpMVs of one caller over a ring of x vectors, in the
traffic's ``semiring``: ``build_operand_auto`` once, then
``registry.spmv`` calls with no synchronise between them, and one
``torch.cuda.synchronize()`` at the end of the window.

Its reference is ``reference/<semiring>.py``: ``product(n_rows, rows,
cols, vals, x) -> (y_ref, scale)`` and ``rel_err(y, y_ref, scale) ->
float``, the number compared as ``spmv_rel_err``.
"""

from __future__ import annotations

import torch

from portbench import generator, spans, trace as tracing
from portbench.harness import Reservoir, log, now, sync

#: the benchmark's range around each call of the range stretch
RANGES = ("spmv",)


def reference_name(traffic: dict) -> str:
    return traffic["semiring"]


def requests(traffic: dict, seed: int, n: int, rows, cols, device):
    return generator.spmv_vectors(traffic, seed, n, device)


class Driver:
    unit = "call"

    def __init__(self, ctx, coo, xs, geometry, device, seed: int, reference):
        from sparseharness_tpu_torch.semiring import get_semiring

        self.ctx, self.coo, self.xs, self.geometry, self.device = ctx, coo, xs, geometry, device
        self.ref = reference
        self.sr = get_semiring(ctx.traffic["semiring"])
        self.sample = Reservoir(int(ctx.traffic["check_calls"]), seed)
        self.last = None
        self.requests = self.units = 0

    def build(self) -> None:
        from sparseharness_tpu_torch.ops import registry

        self.variant, self.operand = registry.build_operand_auto(
            self.coo, self.sr, self.geometry, device=self.device)

    def _call(self, x):
        from sparseharness_tpu_torch.ops import registry

        return registry.spmv(self.operand, x, None, sr=self.sr, variant=self.variant,
                             n_rows=self.ctx.n)

    def warm_up(self) -> None:
        for x in self.xs:
            self._call(x)

    def window(self, seconds: float) -> None:
        ring = len(self.xs)
        calls, t_start = 0, now()
        deadline = t_start + seconds
        while True:
            y = self._call(self.xs[calls % ring])
            self.sample.offer((calls % ring, y))
            calls += 1
            if now() >= deadline:
                break
        self.last = (calls - 1) % ring, y
        sync(self.device)
        self.ctx.window_s = now() - t_start
        self.ctx.calls = self.requests = self.units = calls
        log(f"window: {calls} calls, {self.ctx.window_s / calls * 1e6:.2f} us a call, "
            f"{self.ctx.window_s:.3f} s")

    def traced(self, traffic: dict) -> None:
        ring = len(self.xs)
        burst = int(traffic["burst_calls"])
        for _ in range(int(traffic["enqueue_bursts"])):
            sync(self.device)
            t = now()
            for i in range(burst):
                self._call(self.xs[i % ring])
            self.ctx.enqueue_s.append((now() - t) / burst)
        self.ctx.trace, _ = self._stretch(traffic, tracing.Tracer())
        self.ctx.range_trace, self.ctx.traced_calls = self._stretch(
            traffic, tracing.Tracer(RANGES, host=True))
        self.ctx.span_trace, _ = self._stretch(spans.stretch_traffic(traffic),
                                               spans.SpanTracer())

    def _stretch(self, traffic: dict, tracer):
        from torch.profiler import record_function

        ring = len(self.xs)
        sync(self.device)
        tracer.start()
        t, k = now(), 0
        while k < int(traffic["trace_calls"]) and now() - t < float(traffic["trace_seconds"]):
            if tracer.host:
                with record_function("spmv"):
                    self._call(self.xs[k % ring])
            else:
                self._call(self.xs[k % ring])
            k += 1
        tracer.stop()
        return tracer.read(), k

    def release(self) -> None:
        self.operand = None

    def end_to_end(self) -> dict:
        return {"spmv_gnnz_s": self.ctx.folded * self.ctx.calls / self.ctx.window_s / 1e9}

    def check(self, limits: dict):
        coo, dev, ref = self.coo, self.device, self.ref
        rows, cols, vals = (torch.from_numpy(a).to(dev) for a in (coo.rows, coo.cols, coo.vals))
        refs, worst, failed = {}, 0.0, 0
        for slot, y in self.sample.items + [self.last]:
            if slot not in refs:
                refs[slot] = ref.product(self.ctx.n, rows, cols, vals, self.xs[slot])
            err = ref.rel_err(y, *refs[slot])
            failed += err > limits["spmv_rel_err"]
            worst = max(worst, err)
        return {"spmv_rel_err": (worst, limits["spmv_rel_err"])}, int(failed)
