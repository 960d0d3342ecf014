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
against dp_sell_plain), the later levels alone, and torch.mv on a CSR
tensor of the same matrix. Last, the sell2 bench operand's plan: built on
the CPU and carried to the card, against the same plan made on the CPU.
The card's name and power limit come first, from nvidia-smi. Imports only
the port.
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_sell_fused_cuda: no CUDA device is available", file=sys.stderr)
        return 1
    from sparseharness_tpu_torch.formats import banded_coo, power_law_coo
    from sparseharness_tpu_torch.ops import sell, sell2
    from sparseharness_tpu_torch.ops.interop import sell2_operand_from_numpy
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
    del op, designs, csr, work, dp, work_ref, dp_ref, whole

    rcoo = power_law_coo(500_000, 2_000_000, alpha=1.5, seed=13)
    digest = hashlib.sha256()
    for a, dtype in ((rcoo.rows, np.int64), (rcoo.cols, np.int64), (rcoo.vals, np.float32)):
        digest.update(np.ascontiguousarray(a, dtype).tobytes())
    cpu_op = sell2.build_sell2(rcoo, sr, device="cpu")
    arrays = [None if s is None else {k: v.numpy() for k, v in s.items()} for s in cpu_op.slabs]
    owned = [None if t is None else t.numpy() for t in (cpu_op.piece_owner, cpu_op.virt_blocks)]
    card_op = sell2_operand_from_numpy(arrays, cpu_op.layouts, cpu_op.n_chunks,
                                       cpu_op.n_rows, cpu_op.base_pad, *owned, device="cuda")
    emit({"sell2_coo_nnz": rcoo.nnz, "sell2_coo_sha256_16": digest.hexdigest()[:16],
          "sell2_coo_row_sum": int(rcoo.rows.astype(np.int64).sum()),
          "sell2_coo_col_sum": int(rcoo.cols.astype(np.int64).sum()),
          "numpy": np.__version__, "cpu_plan_runs": cpu_op.plan.n_runs,
          "card_plan_runs": card_op.plan.n_runs,
          "card_build_runs": sell2.build_sell2(rcoo, sr, device="cuda").plan.n_runs})
    return 0


if __name__ == "__main__":
    sys.exit(main())
