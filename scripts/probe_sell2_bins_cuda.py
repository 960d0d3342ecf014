#!/usr/bin/env python3
"""Time the port's sell2 kernel, and the bounds of its bins, on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/probe_sell2_bins_cuda.py [--matrix ragged|kron20 ...]
        [--bins 64,32,16,8,4 ...] [--seed N]

``ragged`` is bench.py's ragged matrix, power_law_coo(500000, 2000000,
alpha=1.5, seed=13); ``kron20`` the benchmark's Graph500 Kronecker graph
at scale 20 (portbench/configs/g500-kron-s20.json), made on the card from
``--seed``. For each matrix, in f32 plus_times, it builds the operand
(the build's seconds, its ``build.encode`` span at stage ``plan`` with
the plan's counts, and the card's peak memory from the build's start),
checks the kernel against its plain version (within 1e-5 · max(1,
|plain|, Σ|a·x|)) and min_plus bit for bit, then prints one JSON line: the
call's device ms (CUDA events, the median of five 20-call windows) and
the host's enqueue ms per call, torch.profiler's device ms per launch,
the plan's counts (with the share of entries whose column is among the
1,024, 8,192 and 65,536 most used), and the library yardstick: torch.mv
on a CSR tensor of the matrix, duplicates summed (cuSPARSE; the port
never calls it). Each ``--bins`` (the longest row of bins 1–5,
ops/sell2.py:BIN_MAX_LEN) remakes the plan with those bounds and times
it again, in turns with the shipped bounds. The card's name and power limit
come first, from nvidia-smi. Imports only the port and, for ``kron20``,
the benchmark's graph generator.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def kernel_ms(torch, fn, n: int = 20) -> float:
    """Device ms per launch of the sell2 kernel that fn launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
        if us and "sell2_dp_kernel" in evt.key and evt.count:
            return us / evt.count / 1e3
    return float("nan")


def windows(torch, fn) -> dict:
    fn()
    fn()
    dev, host = [], []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(20):
            fn()
        end.record()
        host.append((time.perf_counter() - t0) * 1e3 / 20)
        end.synchronize()
        dev.append(start.elapsed_time(end) / 20)
    return {"ms": float(np.median(dev)), "ms_windows": dev, "enqueue_ms": float(np.median(host))}


def matrix(name: str, seed: int):
    from sparseharness_tpu_torch.formats import coo_from_arrays, power_law_coo

    if name == "ragged":
        return power_law_coo(500_000, 2_000_000, alpha=1.5, seed=13)
    from portbench.graphs import kronecker

    cfg = json.loads((ROOT / "portbench" / "configs" / "g500-kron-s20.json").read_text())
    rows, cols, vals, n = kronecker.make(cfg["params"], seed, "cuda")
    return coo_from_arrays(rows.cpu().numpy(), cols.cpu().numpy(), vals.cpu().numpy(), (n, n))


def library_ms(torch, coo, x) -> float:
    """torch.mv on a CUDA CSR tensor of coo, duplicates summed (f32)."""
    from sparseharness_tpu_torch.formats import fold_duplicates

    s = fold_duplicates(coo, np.add).sorted_by_row()
    crow = np.concatenate([[0], np.cumsum(np.bincount(s.rows, minlength=coo.shape[0]))])
    csr = torch.sparse_csr_tensor(torch.from_numpy(crow.astype(np.int32)),
                                  torch.from_numpy(s.cols.astype(np.int32)),
                                  torch.from_numpy(s.vals.astype(np.float32)),
                                  size=coo.shape).cuda()
    return windows(torch, lambda: torch.mv(csr, x))["ms"]


def plain(sell2, coo, x, sr):
    """The plain dp on x's card, over the panels of a CPU build (a card
    build keeps only the kernel's plan)."""
    op = sell2.build_sell2(coo, sr, device="cpu").to(x.device)
    return sell2.dp_sell2_plain(op, x, sr, n_rows=coo.shape[0])


def remade(torch, sell2, op):
    """The operand with its plan made again, under the bins set now, from
    the plan's own entries (plus_times' 0̄ pads them)."""
    plan = op.plan
    rp, dest = plan.row_ptr.long(), plan.row_dest.long()
    rows = torch.where(dest < plan.n_final, dest, op.base_pad + dest - plan.n_final)
    rows = torch.repeat_interleave(rows, rp[1:] - rp[:-1]).to(torch.int32)
    k, q = plan.n_entries, plan.n_pieces
    owner = plan.owners[plan.piece_slot.long(), 0] if q else None
    n_pad = -(-(op.base_pad + q) // 1024) * 1024 if q else plan.n_final
    zero = torch.zeros(1, dtype=plan.store, device=plan.device)
    return sell2.Sell2Operand(op.n_rows, op.base_pad, sell2.make_plan(
        rows, plan.cols[:k], plan.vals[:k], zero, owner, op.base_pad, n_pad), None)


def check(torch, sell2, coo, op, x, sr, bound) -> float:
    """Fails unless the kernel gives the plain version's values; returns
    the largest |kernel − plain|."""
    got = sell2.sell2_dp_cuda(op, x, sr)
    ref = plain(sell2, coo, x, sr)
    torch.cuda.synchronize()
    if bound is None:
        if not torch.equal(got, ref):
            raise AssertionError(f"sell2 {sr.name}: kernel != plain")
        return 0.0
    tol = 1e-5 * torch.clamp(torch.maximum(ref.abs(), bound), min=1.0)
    if not bool(((got - ref).abs() <= tol).all()):
        raise AssertionError(f"sell2 {sr.name}: kernel outside the tolerance")
    return float((got - ref).abs().max())


def main() -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--matrix", choices=("ragged", "kron20"), action="append")
    p.add_argument("--bins", action="append", default=[],
                   help="five decreasing row lengths: the longest row of bins 1-5")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("probe_sell2_bins_cuda: no CUDA device is available", file=sys.stderr)
        return 1
    from sparseharness_tpu_torch.ops import sell2
    from sparseharness_tpu_torch.semiring import MIN_PLUS, PLUS_TIMES
    from sparseharness_tpu_torch.utils import timing

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip(), flush=True)
    shipped = sell2.BIN_MAX_LEN
    alternatives = [tuple(int(v) for v in b.split(",")) for b in args.bins]
    for name in args.matrix or ["ragged"]:
        coo = matrix(name, args.seed)
        rng = np.random.default_rng(13)
        x = torch.from_numpy(rng.uniform(0.1, 1.0, coo.shape[1]).astype(np.float32)).cuda()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        timing.start_recording()
        try:
            op = sell2.build_sell2(coo, PLUS_TIMES, device="cuda")
            torch.cuda.synchronize()
        finally:
            rec = timing.stop_recording()
        build_s = time.perf_counter() - t0
        plan_span = [s.attrs for s in rec
                     if s.name == "build.encode" and s.attrs.get("stage") == "plan"]
        peak = torch.cuda.max_memory_allocated() - held
        kept = torch.cuda.memory_allocated() - held
        plan = op.plan
        plan_bytes = sum(t.numel() * t.element_size() for t in (
            plan.row_ptr, plan.row_dest, plan.cols, plan.vals, plan.owners, plan.piece_slot))
        bound = plain(sell2, coo.with_values(np.abs(coo.vals)), x.abs(), PLUS_TIMES)
        err = check(torch, sell2, coo, op, x, PLUS_TIMES, bound)
        mop = sell2.build_sell2(coo, MIN_PLUS, device="cuda")
        check(torch, sell2, coo, mop, x, MIN_PLUS, None)
        del mop, bound
        uses = torch.bincount(plan.cols[:plan.n_entries].long()).sort(descending=True).values
        hot = {k: float(uses[:k].sum()) / plan.n_entries for k in (1024, 8192, 65536)}
        call = lambda op=op: sell2.sell2_dp_cuda(op, x, PLUS_TIMES)  # noqa: E731
        line = {"matrix": name, "rows": coo.shape[0], "nnz": coo.nnz, "value": "float32",
                "entries": plan.n_entries, "pieces": plan.n_pieces,
                "owners": int(plan.owners.shape[0]),
                "pieces_per_owner_max": int((plan.owners[:, 2] - plan.owners[:, 1]).max())
                if plan.owners.numel() else 0,
                "bins": {"max_len": list(shipped), "rows": list(plan.bin_rows),
                         "entries": list(plan.bin_entries)},
                "plan_span_attrs": plan_span, "build_s": build_s,
                "build_peak_bytes": peak, "operand_bytes": kept,
                "plan_bytes": plan_bytes, "max_abs_err": err, "hot_column_share": hot,
                **windows(torch, call), "kernel_ms": kernel_ms(torch, call),
                "library_ms": library_ms(torch, coo, x)}
        turns = []
        for bins in alternatives:
            for b in (bins, shipped):
                sell2.BIN_MAX_LEN = b
                alt = remade(torch, sell2, op)
                sell2.BIN_MAX_LEN = shipped
                fn = lambda alt=alt: sell2.sell2_dp_cuda(alt, x, PLUS_TIMES)  # noqa: E731
                turns.append({"max_len": list(b), "rows": list(alt.plan.bin_rows),
                              **windows(torch, fn), "kernel_ms": kernel_ms(torch, fn)})
                del alt
        line["turns"] = turns
        print(json.dumps(line), flush=True)
        del op, plan
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
