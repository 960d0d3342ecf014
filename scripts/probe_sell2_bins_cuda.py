#!/usr/bin/env python3
"""Time the port's sell2 kernel, the bounds of its bins and its degree
order of x, on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/probe_sell2_bins_cuda.py [--matrix ragged|kron20|kronSeE ...]
        [--bins 64,32,16,8,4 ...] [--x-order [--hot-cols H ...]] [--shards S ...]
        [--seed N]

``ragged`` is bench.py's ragged matrix, power_law_coo(500000, 2000000,
alpha=1.5, seed=13); ``kron20`` the benchmark's Graph500 Kronecker graph
at scale 20 (portbench/configs/g500-kron-s20.json), made on the card from
``--seed``, and ``kronSeE`` the same generator at scale S and edgefactor E
(``kron18`` keeps the edgefactor 16). For each matrix, in f32 plus_times, it
builds the operand (the build's seconds, its ``build.encode`` span at
stage ``plan`` with the plan's counts and its order of x, and the card's
peak memory from the build's start), checks the kernel against its plain
version (within 1e-5 · max(1, |plain|, Σ|a·x|)) and min_plus bit for bit,
then prints one JSON line: the call's device ms (CUDA events, the median
of five 20-call windows) and the host's enqueue ms per call,
torch.profiler's device ms per launch of each kernel, the plan's counts
(with the share of entries whose column is among the 1,024, 8,192 and
65,536 most used), and the library yardstick: torch.mv on a CSR tensor
of the matrix, duplicates summed (cuSPARSE; the port never calls it).
Each ``--bins`` (the longest row of bins 1–5, ops/sell2.py:BIN_MAX_LEN)
remakes the plan with those bounds and times it again, in turns with the
shipped bounds. ``--x-order`` remakes the plan with x in degree order and
with x as it is, whatever the rule says, checks each against the other,
and times them in turns (degree, as is, then back), with each one's
share of entries in x's first 65,536 columns; each ``--hot-cols H`` adds
to the turns the degree order with its H hottest columns dealt over lines
(ops/sell2.py:HOT_COLS; 0 keeps plain rank order). Each ``--shards S``
builds the row-block partition over S ranks as parallel/sharded_sell.py
does, and gives each rank's order of x, hot share and its call held to
the whole operand's rows, timed in turns with x as it is where the rank
takes the order. The card's name and
power limit come first, from nvidia-smi. Imports only the port and, for
the Kronecker graphs, the benchmark's graph generator.
"""

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def kernel_ms(torch, fn, n: int = 20) -> dict:
    """Device ms per launch of each sell2 kernel that fn launches
    (``sell2_dp_kernel``, ``sell2_x_kernel``)."""
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
        name = re.search(r"sell2_\w+?_kernel", evt.key)
        if us and name and evt.count:
            out[name.group(0)] = us / evt.count / 1e3
    return out


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
    scale, ef = re.fullmatch(r"kron(\d+)(?:e(\d+))?", name).groups()
    params = dict(cfg["params"], scale=int(scale))
    if ef is not None:
        params["edgefactor"] = int(ef)
    rows, cols, vals, n = kronecker.make(params, seed, "cuda")
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


def hot_share(plan) -> float:
    """The share of the plan's entries whose column (in the plan's order)
    lies in x's first L1_COLS."""
    from sparseharness_tpu_torch.ops import sell2

    cols = plan.cols[:plan.n_entries]
    return int((cols < sell2.L1_COLS).sum()) / max(cols.numel(), 1)


def remade(torch, sell2, op, n_cols: int):
    """The operand with its plan made again, under the bins and the order
    of x as the module sets them now, from the plan's own entries in x's
    columns (plus_times' 0̄ pads them)."""
    plan = op.plan
    rp, dest = plan.row_ptr.long(), plan.row_dest.long()
    rows = torch.where(dest < plan.n_final, dest, op.base_pad + dest - plan.n_final)
    rows = torch.repeat_interleave(rows, rp[1:] - rp[:-1]).to(torch.int32)
    k, q = plan.n_entries, plan.n_pieces
    cols = plan.cols[:k]
    if plan.col_perm is not None:
        cols = plan.col_perm.index_select(0, cols)
    owner = plan.owners[plan.piece_slot.long(), 0] if q else None
    n_pad = -(-(op.base_pad + q) // 1024) * 1024 if q else plan.n_final
    zero = torch.zeros(1, dtype=plan.store, device=plan.device)
    return sell2.Sell2Operand(op.n_rows, op.base_pad, sell2.make_plan(
        rows, cols, plan.vals[:k], zero, owner, op.base_pad, n_pad, n_cols), None)


def ordered(torch, sell2, op, n_cols: int, degree: bool, hot_cols=None):
    """The operand's plan made again with x in degree order (its hottest
    ``hot_cols`` dealt over lines, by default ``HOT_COLS``) or as it is,
    whatever the rule (ops/sell2.py:degree_rank) says."""
    def rank(cols, n):
        counts = torch.bincount(cols, minlength=n)
        return torch.sort(counts, descending=True, stable=True).indices if degree else None

    saved = sell2.degree_rank, sell2.HOT_COLS
    sell2.degree_rank = rank
    if hot_cols is not None:
        sell2.HOT_COLS = hot_cols
    try:
        return remade(torch, sell2, op, n_cols)
    finally:
        sell2.degree_rank, sell2.HOT_COLS = saved


def shard_lines(torch, sell2, coo, x, whole, shards: int) -> list:
    """Each rank's plan of a row-block partition over ``shards`` ranks,
    built on the card as parallel/sharded_sell.py builds it: its order of
    x, its entries a column and hot share, its call held to the whole
    operand's rows (plus_times, within 1e-5 · max(1, |whole|)) with its
    launches, and its call's device ms, in turns with its plan remade with
    x as it is where the rank takes the order."""
    from sparseharness_tpu_torch.ops import LAUNCHES
    from sparseharness_tpu_torch.parallel import sharded_sell as tss
    from sparseharness_tpu_torch.semiring import PLUS_TIMES

    op, chunk = tss.build_sharded_sell(coo, PLUS_TIMES, shards, device="cuda")
    n, n_cols = coo.shape
    out = []
    for d, rank in enumerate(op.ranks):
        plan = rank.plan
        before = dict(LAUNCHES)
        got = sell2.sell2_dp_cuda(rank, x, PLUS_TIMES)[:min(chunk, n - d * chunk)]
        torch.cuda.synchronize()
        ref = whole[d * chunk:d * chunk + got.numel()]
        # x > 0 and values > 0, so Σ|a·x| is the value itself
        if not bool(((got - ref).abs() <= 1e-5 * ref.abs().clamp(min=1.0)).all()):
            raise AssertionError(f"sell2: rank {d} of {shards} and the whole operand differ")
        runs = {plan.x_order: rank}
        if plan.x_order == "degree":
            runs["as_is"] = ordered(torch, sell2, rank, n_cols, False)
        turns = []
        for label in list(runs) + list(runs)[::-1]:
            fn = lambda o=runs[label]: sell2.sell2_dp_cuda(o, x, PLUS_TIMES)  # noqa: E731
            turns.append({"x_order": label, **windows(torch, fn),
                          "kernel_ms": kernel_ms(torch, fn)})
        out.append({"rank": d, "x_order": plan.x_order, "entries": plan.n_entries,
                    "entries_per_col": plan.n_entries / n_cols, "hot_share": hot_share(plan),
                    "launches": {k: LAUNCHES[k] - before[k] for k in ("sell2", "sell2_x")},
                    "max_abs_err": float((got - ref).abs().max()), "turns": turns})
    return out


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
    p.add_argument("--matrix", action="append", help="ragged, kron20 or kronSeE")
    p.add_argument("--bins", action="append", default=[],
                   help="five decreasing row lengths: the longest row of bins 1-5")
    p.add_argument("--x-order", action="store_true",
                   help="time the plan with x in degree order and as it is, in turns")
    p.add_argument("--hot-cols", type=int, action="append", default=[],
                   help="with --x-order, also the degree order with this HOT_COLS")
    p.add_argument("--shards", type=int, action="append", default=[],
                   help="also each rank's plan of this many row blocks")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    for name in args.matrix or ():
        if name != "ragged" and not re.fullmatch(r"kron\d+(e\d+)?", name):
            p.error(f"unknown matrix {name!r}")
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
        plan_bytes = sum(getattr(plan, f).numel() * getattr(plan, f).element_size()
                         for f in sell2._LAUNCH_TENSORS if getattr(plan, f) is not None)
        bound = plain(sell2, coo.with_values(np.abs(coo.vals)), x.abs(), PLUS_TIMES)
        err = check(torch, sell2, coo, op, x, PLUS_TIMES, bound)
        mop = sell2.build_sell2(coo, MIN_PLUS, device="cuda")
        check(torch, sell2, coo, mop, x, MIN_PLUS, None)
        del mop, bound
        uses = torch.bincount(plan.cols[:plan.n_entries].long()).sort(descending=True).values
        n_cols = coo.shape[1]
        hot = {k: float(uses[:k].sum()) / plan.n_entries for k in (1024, 8192, 65536)}
        call = lambda op=op: sell2.sell2_dp_cuda(op, x, PLUS_TIMES)  # noqa: E731
        line = {"matrix": name, "rows": coo.shape[0], "cols": n_cols, "nnz": coo.nnz,
                "value": "float32", "entries": plan.n_entries,
                "entries_per_col": plan.n_entries / n_cols, "x_order": plan.x_order,
                "hot_share": hot_share(plan), "pieces": plan.n_pieces,
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
        if args.x_order:
            runs = {"degree": ordered(torch, sell2, op, n_cols, True),
                    "as_is": ordered(torch, sell2, op, n_cols, False)}
            for h in args.hot_cols:
                runs[f"degree_hot{h}"] = ordered(torch, sell2, op, n_cols, True, h)
            b = sell2.sell2_dp_cuda(runs["as_is"], x, PLUS_TIMES)
            for label, o in runs.items():
                a = sell2.sell2_dp_cuda(o, x, PLUS_TIMES)
                torch.cuda.synchronize()
                # x > 0 and values > 0, so Σ|a·x| is the value itself
                if not bool(((a - b).abs() <= 1e-5 * b.abs().clamp(min=1.0)).all()):
                    raise AssertionError(f"sell2 {name}: {label} and x as is differ")
            order_turns = []
            for label in list(runs) + list(runs)[::-1]:
                fn = lambda o=runs[label]: sell2.sell2_dp_cuda(o, x, PLUS_TIMES)  # noqa: E731
                order_turns.append({"x_order": label, **windows(torch, fn),
                                    "kernel_ms": kernel_ms(torch, fn)})
            line["x_order_turns"] = order_turns
            line["x_order_hot_share"] = {k: hot_share(o.plan) for k, o in runs.items()}
            del runs, a, b
        turns = []
        for bins in alternatives:
            for b in (bins, shipped):
                sell2.BIN_MAX_LEN = b
                alt = remade(torch, sell2, op, n_cols)
                sell2.BIN_MAX_LEN = shipped
                fn = lambda alt=alt: sell2.sell2_dp_cuda(alt, x, PLUS_TIMES)  # noqa: E731
                turns.append({"max_len": list(b), "rows": list(alt.plan.bin_rows),
                              **windows(torch, fn), "kernel_ms": kernel_ms(torch, fn)})
                del alt
        line["turns"] = turns
        whole = call()
        for shards in args.shards:
            line[f"shards{shards}"] = shard_lines(torch, sell2, coo, x, whole, shards)
        print(json.dumps(line), flush=True)
        del op, plan, whole
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
