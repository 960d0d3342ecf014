#!/usr/bin/env python3
"""Split the time of the port's sell2 kernel on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/probe_sell2_stages_cuda.py [--matrix ragged|kron20]

``ragged`` is bench.py's ragged matrix, power_law_coo(500000, 2000000,
alpha=1.5, seed=13); ``kron20`` the benchmark's Graph500 Kronecker graph
at scale 20 (portbench/configs/g500-kron-s20.json), made on the card. In
f32 plus_times it checks the kernel against its plain version once, then
prints one JSON line: the call's device ms (CUDA events, the median of
five 20-call windows) and the host's enqueue ms per call,
torch.profiler's device ms per launch of the panel and row stages, and
the stages again from copies of the plan's launch: the row stage with no
overflow pieces (the plain output rows alone) and with 1,024 output rows
(the pieces and their owners' folds alone). Those runs write scratch,
not a dp. Then the plan's counts: runs, pieces and owners. The card's
name and power limit come first, from nvidia-smi. Imports only the port
and, for ``kron20``, the benchmark's graph generator.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def stage_ms(torch, fn, n: int = 20) -> dict:
    """Device ms per launch of each sell2 kernel that fn launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
        for name in ("sell2_panel_kernel", "sell2_row_kernel"):
            if us and name in evt.key and evt.count:
                out[name] = us / evt.count / 1e3
    return out


def matrix(name: str):
    from sparseharness_tpu_torch.formats import coo_from_arrays, power_law_coo

    if name == "ragged":
        return "power_law_coo(500000, 2000000, alpha=1.5, seed=13)", power_law_coo(
            500_000, 2_000_000, alpha=1.5, seed=13)
    from portbench.graphs import kronecker

    cfg = json.loads((ROOT / "portbench" / "configs" / "g500-kron-s20.json").read_text())
    rows, cols, vals, n = kronecker.make(cfg["params"], 0, "cuda")
    coo = coo_from_arrays(rows.cpu().numpy(), cols.cpu().numpy(), vals.cpu().numpy(), (n, n))
    return "g500-kron-s20", coo


def main() -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--matrix", choices=("ragged", "kron20"), default="ragged")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("probe_sell2_stages_cuda: no CUDA device is available", file=sys.stderr)
        return 1
    from sparseharness_tpu_torch.ops import _build, sell2
    from sparseharness_tpu_torch.semiring import PLUS_TIMES

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip(), flush=True)
    label, coo = matrix(args.matrix)
    op = sell2.build_sell2(coo, PLUS_TIMES, device="cuda")
    x = torch.from_numpy(np.random.default_rng(13).uniform(0.1, 1.0, coo.shape[1])
                         .astype(np.float32)).cuda()
    call = lambda: sell2.sell2_dp_cuda(op, x, PLUS_TIMES)  # noqa: E731
    if not torch.equal(call(), sell2.dp_sell2_plain(op, x, PLUS_TIMES, n_rows=coo.shape[0])):
        raise AssertionError("sell2 kernel != plain")
    dev, host = [], []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(20):
            call()
        end.record()
        host.append((time.perf_counter() - t0) * 1e3 / 20)
        end.synchronize()
        dev.append(start.elapsed_time(end) / 20)

    plan = op.plan
    fn = _build.function("sell2", "sh_sell2_dp", sell2._DP_ARGTYPES)
    scratch = torch.empty(plan.n_final + plan.n_runs + plan.launch.n_pieces, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def part(**fields):
        launch = sell2._Launch.from_buffer_copy(plan.launch)
        for k, v in fields.items():
            setattr(launch, k, v)
        return lambda: _build.check_launch("sell2", fn(
            ctypes.byref(launch), x.data_ptr(), x.numel(), scratch.data_ptr(),
            _build.SR_CODES["plus_times"], stream))

    print(json.dumps({
        "matrix": label, "value": "float32",
        "ms": float(np.median(dev)), "ms_windows": dev, "enqueue_ms": float(np.median(host)),
        "stages": stage_ms(torch, call),
        "row_stage_plain_rows_only": stage_ms(torch, part(n_pieces=0)).get("sell2_row_kernel"),
        "row_stage_pieces_only": stage_ms(torch, part(n_final=1024)).get("sell2_row_kernel"),
        "runs": plan.n_runs, "pieces": plan.launch.n_pieces, "owners": int(plan.owners.shape[0]),
        "pieces_per_owner_max": int((plan.owners[:, 2] - plan.owners[:, 1]).max())
        if plan.owners.numel() else 0,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
