#!/usr/bin/env python3
"""Compare the designs of the port's fused sell depth-0 kernel on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/probe_sell_fused_cuda.py

On sell's full-width band, banded_coo(1 << 18, 63, seed=1), in f32
plus_times, it builds the operand (timed), then for each way of cutting
the fused launch's blocks (ops/sell.py:regroup) — staged windows as built,
two other group sizes, and every block gathering in place — checks the
fused kernel against fused_plain bit for bit and prints one JSON line: the
bytes by design (fused_traffic), the launch's device ms (CUDA events, the
median of five 20-call windows, the designs timed in turns: each in
order, then again in reverse) and its bound. Then the whole dp (checked
against dp_sell_plain), the level launch alone, and torch.mv on a CSR
tensor of the same matrix. Then the level launch's two paths under the
shared-memory limits of level_paths (ops/sell.py:relevel) on the band, on
two matrices of one chain of about 800 rows (a power-law matrix of 3
levels, and deep_hub_coo's 4,100-entry hub row of 4 levels), and on the
band and the hub matrix joined in one operand, the hub's slab last and
first: each dp checked against dp_sell_plain bit for bit, then the level
launch alone, the dp's trace and its ms, in turns. Last, the sell2 bench
operand's plan entries, built on the CPU and on the card.
The card's name and power limit come first, from nvidia-smi. Imports only
the port and chip_smoke.py's timing helpers.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HBM_BPS = 3.35e12  # H100 SXM device memory (data sheet)


def windows_ms(torch, fn, windows: int = 5, n: int = 20) -> float:
    fn()
    fn()
    out = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / n)
    return float(np.median(out))


def joined(sell, first, second):
    """One operand whose slabs are ``first``'s, then ``second``'s with their
    rows moved past ``first``'s, over one x2d of the wider of the two: a
    level launch that holds both matrices' chains."""
    slabs = [{k: v.cpu().numpy() for k, v in slab.items()}
             for slab in first.slabs + second.slabs]
    layouts = list(first.layouts) + [lay._replace(row0=lay.row0 + first.n_pad)
                                     for lay in second.layouts]
    return sell.assemble(slabs, layouts, max(first.xrows, second.xrows),
                         first.n_pad + second.n_rows, first.table.device)


def level_paths(torch, sell, sr, cases) -> None:
    """The level launch under each shared-memory limit (0: every slab on the
    work path; 512 rows, at most three blocks an SM; LEVEL_ROWS_MAX, as
    built), each dp checked against dp_sell_plain, then timed in
    turns (each limit in order, then again in reverse): the level launch
    alone, back to back (torch.profiler's device ms a launch), the dp's
    trace (chip_smoke.py's call_trace: ``tail_ms`` is how far the level
    launch ends past the fused launch's end) and the dp by CUDA events."""
    from chip_smoke import call_trace, stage_ms

    limits = (0, 512, sell.LEVEL_ROWS_MAX)
    runs = {}
    for name, (op, x) in cases.items():
        ref = sell.dp_sell_plain(op, x, sr, n_rows=op.n_rows)
        x2d = sell.pad_x2d(op, x, sr)
        for limit in limits:
            lop = sell.relevel(op, limit)
            got = sell.sell_dp_cuda(lop, x2d, sr)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
                raise AssertionError(f"sell dp ({name}, level_rows {limit}) != dp_sell_plain")
            runs[name, limit] = (lop, x2d, {
                "matrix": name, "limit": limit, "level_rows": lop.level_rows,
                "work_rows": lop.work_rows, **sell.level_traffic(lop), "alone_ms": [],
                "trace": [], "dp_ms": []})
        del ref
    order = list(runs) + list(reversed(list(runs)))
    for key in order:
        lop, x2d, row = runs[key]
        work = torch.empty((lop.work_rows, 128), dtype=torch.float32, device="cuda")
        dp = torch.empty(lop.n_pad, dtype=torch.float32, device="cuda")
        sell.fused_cuda(lop, x2d, sr, work, dp)
        alone = stage_ms(torch, lambda: sell.levels_cuda(lop, sr, work, dp),
                         r"sell_level_kernel")
        row["alone_ms"].append(alone.get("sell_level_kernel", {}).get("ms"))
        row["trace"].append(call_trace(torch, lambda: sell.sell_dp_cuda(lop, x2d, sr),
                                       "sell_fused"))
        row["dp_ms"].append(windows_ms(torch, lambda: sell.sell_dp_cuda(lop, x2d, sr)))
    for _, _, row in runs.values():
        row["bound_ms"] = row["bound_bytes"] / HBM_BPS * 1e3
        emit(row)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_sell_fused_cuda: no CUDA device is available", file=sys.stderr)
        return 1
    from sparseharness_tpu_torch.formats import banded_coo, deep_hub_coo, power_law_coo
    from sparseharness_tpu_torch.ops import sell, sell2
    from sparseharness_tpu_torch.semiring import PLUS_TIMES

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip(), flush=True)
    sr = PLUS_TIMES
    coo = banded_coo(1 << 18, 63, seed=1)
    t0 = time.perf_counter()
    op = sell.build_sell(coo, sr, device="cuda")
    torch.cuda.synchronize()
    emit({"build_seconds": time.perf_counter() - t0, "nnz": coo.nnz,
          "slabs": len(op.layouts), "max_levels": op.max_levels,
          "stream_rows": int(op.lanesel.shape[0]), "work_rows": op.work_rows})
    x = torch.from_numpy(np.random.default_rng(16).uniform(0.1, 1.0, coo.shape[1])
                         .astype(np.float32)).cuda()
    x2d = sell.pad_x2d(op, x, sr)
    work_ref, dp_ref = sell.fused_plain(op, x2d, sr)

    designs = {"staged": op,
               "staged_256": sell.regroup(op, group_slots=256, stage_rows=320),
               "staged_1024": sell.regroup(op, group_slots=1024, stage_rows=1100),
               "in_place": sell.regroup(op, stage_rows=0)}
    work, dp = torch.zeros_like(work_ref), torch.zeros_like(dp_ref)
    rows = {}
    for name, dop in designs.items():
        work.zero_()
        dp.zero_()
        sell.fused_cuda(dop, x2d, sr, work, dp)
        torch.cuda.synchronize()
        if not (torch.equal(work.view(torch.int32), work_ref.view(torch.int32))
                and torch.equal(dp.view(torch.int32), dp_ref.view(torch.int32))):
            raise AssertionError(f"fused kernel ({name}) != fused_plain")
        traffic = sell.fused_traffic(dop)
        rows[name] = {"design": name, "stage_rows": dop.stage_rows, **traffic,
                      "bound_ms": traffic["bound_bytes"] / HBM_BPS * 1e3, "ms": []}
    order = list(designs) + list(reversed(designs))
    for name in order:
        dop = designs[name]
        rows[name]["ms"].append(windows_ms(
            torch, lambda: sell.fused_cuda(dop, x2d, sr, work, dp)))
    for row in rows.values():
        emit(row)

    whole = sell.sell_dp_cuda(op, x2d, sr)
    torch.cuda.synchronize()
    if not torch.equal(whole.view(torch.int32),
                       sell.dp_sell_plain(op, x, sr, n_rows=coo.shape[0]).view(torch.int32)):
        raise AssertionError("sell dp != dp_sell_plain")
    sell.fused_cuda(op, x2d, sr, work, dp)
    n = coo.shape[0]
    counts = np.bincount(coo.rows, minlength=n)
    crow = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))
    order_ = np.lexsort((coo.cols, coo.rows))
    csr = torch.sparse_csr_tensor(crow, torch.from_numpy(coo.cols[order_]),
                                  torch.from_numpy(coo.vals[order_]), size=coo.shape).cuda()
    emit({"dp_ms": windows_ms(torch, lambda: sell.sell_dp_cuda(op, x2d, sr)),
          "levels_ms": windows_ms(torch, lambda: sell.levels_cuda(op, sr, work, dp)),
          "torch_mv_ms": windows_ms(torch, lambda: torch.mv(csr, x)),
          "depth_rows": list(op.depth_rows)})
    del designs, csr, work, dp, work_ref, dp_ref, whole

    def case(m):
        return (sell.build_sell(m, sr, device="cuda"),
                torch.from_numpy(np.random.default_rng(17).uniform(0.1, 1.0, m.shape[1])
                                 .astype(np.float32)).cuda())

    hub = case(deep_hub_coo())
    level_paths(torch, sell, sr, {
        "band": (op, x), "power_law": case(power_law_coo(1500, 9000, seed=4)),
        "hub4100": hub, "band+hub4100": (joined(sell, op, hub[0]), x),
        "hub4100+band": (joined(sell, hub[0], op), x)})
    del op, hub

    rcoo = power_law_coo(500_000, 2_000_000, alpha=1.5, seed=13)
    digest = hashlib.sha256()
    for a, dtype in ((rcoo.rows, np.int64), (rcoo.cols, np.int64), (rcoo.vals, np.float32)):
        digest.update(np.ascontiguousarray(a, dtype).tobytes())
    cpu_op = sell2.build_sell2(rcoo, sr, device="cpu")
    emit({"sell2_coo_nnz": rcoo.nnz, "sell2_coo_sha256_16": digest.hexdigest()[:16],
          "sell2_coo_row_sum": int(rcoo.rows.astype(np.int64).sum()),
          "sell2_coo_col_sum": int(rcoo.cols.astype(np.int64).sum()),
          "numpy": np.__version__, "cpu_plan_entries": cpu_op.plan.n_entries,
          "card_build_entries": sell2.build_sell2(rcoo, sr, device="cuda").plan.n_entries})
    return 0


if __name__ == "__main__":
    sys.exit(main())
