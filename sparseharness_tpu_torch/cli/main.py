"""Per-algorithm command-line entry points, the JAX package's ``cli/main.py``.

Run as ``python -m sparseharness_tpu_torch.cli <app> [flags]`` with app
one of spmv, sssp, bfs, pr, scc, eigenvector, cc, widest_path and
just_parser. The flags and their defaults are the JAX commands':

  -m/--matrix        .mtx file          -n/--trials        trials (10)
  -f/--matrix-name   record label       -t/--timeout       seconds per trial
  -k/--kernel        variant (ell)      -c/--delta         gold tolerance
  -r/--runfile       runfile sweep      -e/--experiment-id record id
  --sweep            variant × geometry grid
  --jsonl / --sql    append records     --no-gold          skip the gold gate
  --trace            PROFILING_DATUM lines on stderr
  --profile DIR      a torch.profiler trace of the solve into DIR, with
                     the program's spans (category ``program``) in it
  --reorder rcm      solve in RCM-permuted space
  --root / --roots / --max-iter / --stepped (fixpoint commands)

plus ``--device`` (default ``cuda``), the CLI's form of the port's
``device=`` keyword: without a card and without ``--device cpu`` a command
exits nonzero.

``--mesh N`` (N > 1), ``--devices i,j`` and ``--frontier`` run the
row-sharded solvers (``parallel/``) as the JAX commands do: the command
starts a world of ranks (``parallel/launch.py:run_world``; NCCL, a card a
rank, with ``--device cuda``, where N above the cards is refused as JAX's
``make_mesh`` refuses it; N gloo ranks with ``--device cpu``), each rank
runs the sharded solve, and rank 0 alone prints and writes the records.
``--sharded-mode`` picks the exchange and local compute (auto, band, sell,
halo, gather; tiles for --roots), ``--frontier --budget`` the compressed
all_to_all exchange.

Outputs: a summary on stdout and, with --jsonl / --sql, the records. The
exit code is 0 when the gold gate passes (or is skipped), else 1.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
import types
from typing import Optional

import numpy as np
import torch

def _common_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-m", "--matrix", required=True, help=".mtx file")
    p.add_argument("-f", "--matrix-name", default=None,
                   help="matrix label for result records; defaults to the -m path")
    p.add_argument("--hostname", default=None,
                   help="host label for result records; defaults to platform.node()")
    p.add_argument("-k", "--kernel", default="ell",
                   help="kernel variant (auto|ell|coo_seg|dense|dia|sell|sell2|"
                        "bsr_pallas|bsr_ell|bsr_fused|bsr_band); 'auto' walks the "
                        "structure-aware chain")
    p.add_argument("-r", "--runfile", default=None,
                   help="runfile CSV (reference format) for a geometry sweep")
    p.add_argument("--sweep", action="store_true",
                   help="sweep the default variant×geometry grid")
    p.add_argument("-n", "--trials", type=int, default=10)
    p.add_argument("-t", "--timeout", type=float, default=10.0,
                   help="per-trial timeout seconds (adaptive ratchet applies)")
    p.add_argument("-c", "--delta", type=float, default=1e-4)
    p.add_argument("-e", "--experiment-id", default="")
    p.add_argument("--mesh", type=int, default=1,
                   help="number of ranks (row-sharded execution if >1)")
    p.add_argument("--devices", default=None,
                   help="comma-separated card indices of the ranks, e.g. --devices 2,3; "
                        "implies the sharded path; --mesh, when also given, must match "
                        "the list length")
    p.add_argument("--device", default="cuda",
                   help="torch device of the solve (default cuda; 'cpu' runs the "
                        "plain PyTorch versions of the kernels)")
    p.add_argument("--jsonl", default=None, help="append JSONL records here")
    p.add_argument("--sql", default=None, help="append SQL INSERT rows here")
    p.add_argument("--no-gold", action="store_true",
                   help="skip the gold correctness check")
    p.add_argument("--trace", action="store_true",
                   help="emit PROFILING_DATUM scoped-timer lines")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler trace of the solve to DIR "
                        "(trace.json, Chrome trace format)")
    p.add_argument("--reorder", choices=["rcm"], default=None,
                   help="bandwidth-reducing symmetric reordering before the "
                        "solve; results are mapped back to the original "
                        "vertex numbering")
    return p


def _device_idxs(args) -> Optional[list]:
    s = getattr(args, "devices", None)
    if not s:
        return None
    try:
        idxs = [int(d) for d in s.split(",") if d.strip() != ""]
    except ValueError:
        raise SystemExit(f"--devices: not a comma-separated int list: {s!r}")
    if not idxs:
        return None
    if len(set(idxs)) != len(idxs):
        raise SystemExit(f"--devices has duplicate indices: {s}")
    return idxs


def _mesh_requested(args) -> bool:
    """--mesh N > 1 or an explicit --devices list selects the sharded path
    (one explicit device, --devices 2, is still a selection)."""
    return args.mesh > 1 or _device_idxs(args) is not None


def _launch(command, argv, args, device: torch.device) -> int:
    """Run ``command(argv)`` on every rank of a world of --mesh (or
    len(--devices)) ranks; rank 0's exit code. On cards each rank takes
    its own card over NCCL, and more ranks than cards raise as JAX's
    make_mesh does."""
    from sparseharness_tpu_torch.parallel import mesh as mesh_mod
    from sparseharness_tpu_torch.parallel.launch import run_world

    idxs = _device_idxs(args)
    if idxs is not None:
        if device.type == "cuda":
            bad = [i for i in idxs if i < 0 or i >= mesh_mod.device_count()]
            if bad:
                raise SystemExit(f"--devices {bad} out of range (have "
                                 f"{mesh_mod.device_count()} devices)")
        if args.mesh > 1 and args.mesh != len(idxs):
            raise SystemExit(f"--mesh {args.mesh} contradicts --devices (length {len(idxs)})")
    n = len(idxs) if idxs is not None else args.mesh
    devices = idxs if device.type == "cuda" else None
    mesh_mod.rank_devices(n, devices, device=device)  # refuses as JAX's make_mesh
    return run_world(_rank_command, n, device=device, devices=devices,
                     args=(command, argv))[0]


def _rank_command(mesh, command, argv) -> int:
    """One rank of a command's world."""
    return command(argv, mesh=mesh)


def _world_time(mesh):
    """A trial's seconds as the world's slowest rank took them."""
    from sparseharness_tpu_torch.parallel import comm

    def agree(dt: float) -> float:
        t = torch.tensor([dt], dtype=torch.float64, device=mesh.device)
        return float(comm.all_reduce(mesh, t, "max")[0])

    return agree


def _device(args) -> torch.device:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to run the "
                         "plain PyTorch path on the CPU")
    return device


def _setup(args):
    """(coo, device): the matrix, read after the device check."""
    if args.trace:
        from sparseharness_tpu_torch.utils import timing

        timing.set_trace_stream(timing.STDERR)
    device = _device(args)
    from sparseharness_tpu_torch.formats import read_mtx

    return read_mtx(args.matrix), device


@contextlib.contextmanager
def _profile_ctx(args, device: torch.device):
    """A torch.profiler trace of the wrapped solve into --profile DIR (CPU
    and, on a card, CUDA activity), with the program's spans recorded over
    it and written into the trace on its clock, else nothing."""
    if not getattr(args, "profile", None):
        yield
        return
    import json

    from torch.profiler import ProfilerActivity, profile

    from sparseharness_tpu_torch.utils import timing

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(args.profile, exist_ok=True)
    with profile(activities=activities) as prof:
        timing.start_recording()
        try:
            yield
        finally:
            spans = timing.stop_recording()
    path = os.path.join(args.profile, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"].extend(
        spans.chrome_events(int(trace.get("baseTimeNanoseconds", 0)), pid=os.getpid()))
    with open(path, "w") as f:
        json.dump(trace, f)


def _emit(records, args) -> None:
    from sparseharness_tpu_torch.harness import write_records

    if getattr(args, "hostname", None):
        for r in records:
            r.host = args.hostname
    jf = open(args.jsonl, "a") if args.jsonl else None
    sf = open(args.sql, "a") if args.sql else None
    try:
        write_records(records, jsonl=jf, sql=sf)
    finally:
        for f in (jf, sf):
            if f:
                f.close()


def _sharded_spmv_main(args, coo, mesh) -> int:
    """One rank of the --mesh SpMV one-shot: rows sharded over the ranks, x
    all-gathered (parallel.sharded.sharded_spmv), gold-checked on rank 0,
    the time of a step the slowest rank's, records tagged
    ``sharded{N}:ell``."""
    from sparseharness_tpu_torch.gold import Correctness, check_result, spmv_abs_bound, spmv_gold
    from sparseharness_tpu_torch.harness.stats import BenchRecord, Statistic, median_record
    from sparseharness_tpu_torch.parallel.sharded import build_sharded_ell, sharded_spmv
    from sparseharness_tpu_torch.semiring import PLUS_TIMES
    from sparseharness_tpu_torch.utils.device import device_name

    sr = PLUS_TIMES
    n, d = coo.shape[0], mesh.size
    op, _ = build_sharded_ell(coo, sr, d, device=mesh.device)
    x = np.random.default_rng(0).uniform(0.2, 1.0, coo.shape[1]).astype(np.float32)
    kernel = f"sharded{d}:ell"
    out = sharded_spmv(mesh, op, x, sr, n_rows=n).cpu().numpy()
    correctness = Correctness.NOT_CHECKED
    if not args.no_gold and mesh.rank == 0:
        gold = spmv_gold(coo, x, np.zeros(n, np.float32), sr)
        correctness = check_result(out, gold, delta=args.delta, scale=spmv_abs_bound(coo, x))
        print(f"{kernel}: gold {correctness.value}")

    # square operands chain x ← A ⊗ x; the time of a step is the best
    # trial's mean, the slowest rank's
    k = 32 if mesh.device.type == "cuda" else 2
    square = coo.shape[1] == n
    xt = torch.from_numpy(x).to(mesh.device)

    def trial() -> float:
        t0 = time.perf_counter()
        c = xt
        for _ in range(k if square else 1):
            c = sharded_spmv(mesh, op, c, sr, n_rows=n)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        return (time.perf_counter() - t0) / (k if square else 1)

    trial()
    per_op = min(trial() for _ in range(max(args.trials, 1)))
    per_op = max(_world_time(mesh)(per_op), 1e-9)
    records = [BenchRecord(
        time_ns=per_op * 1e9, correctness=correctness, kernel=kernel, geometry=f"mesh{d}",
        trial=0, iteration=0, statistic=Statistic.RAW_RESULT,
        matrix=args.matrix_name or args.matrix, experiment_id=args.experiment_id,
        device=device_name(mesh.device), nnz=coo.nnz).finalize()]
    records.append(median_record(records))
    if mesh.rank == 0:
        print(f"{kernel}: {per_op * 1e3:.3f} ms/op  {coo.nnz / per_op / 1e9:.3f} Gnnz/s  "
              f"{correctness.value}")
        _emit(records, args)
    return 0 if correctness.value in ("correct", "not_checked") else 1


def spmv_main(argv: Optional[list] = None, *, mesh=None) -> int:
    """The SpMV command; ``mesh`` runs it as that rank of a --mesh world."""
    argv = list(sys.argv[1:] if argv is None else argv)
    p = _common_parser("semiring SpMV benchmark")
    args = p.parse_args(argv)
    if _mesh_requested(args):
        if args.sweep or args.runfile:
            p.error("--mesh does not compose with --sweep/--runfile")
        if args.reorder:
            p.error("--mesh does not compose with --reorder for spmv")
        if args.kernel != "ell":
            # the sharded one-shot runs the sharded ELL path: another -k would
            # mislabel the result
            p.error("--mesh spmv runs the sharded ELL path; -k/--kernel must be left at "
                    "the default 'ell'")
        if mesh is None:
            return _launch(spmv_main, argv, args, _device(args))
    coo, device = _setup(args)
    if mesh is not None:
        return _sharded_spmv_main(args, coo, mesh)
    if args.reorder:
        # benchmark P·A·Pᵀ: problem, gold and sweep all live in permuted
        # space; the point is the kernel the reordered structure routes to
        from sparseharness_tpu_torch.formats import bandwidth, reorder_rcm

        bw0 = bandwidth(coo)
        coo, _ = reorder_rcm(coo)
        print(f"rcm: bandwidth {bw0} -> {bandwidth(coo)}")
    from sparseharness_tpu_torch.algorithms import make_spmv_problem
    from sparseharness_tpu_torch.gold import spmv_abs_bound, spmv_gold
    from sparseharness_tpu_torch.harness import (
        BenchmarkConfig, benchmark_spmv, best_per_matrix, default_sweep, load_runfile,
        run_sweep,
    )
    from sparseharness_tpu_torch.semiring import PLUS_TIMES

    config = BenchmarkConfig(trials=args.trials, timeout_s=args.timeout, delta=args.delta,
                             experiment_id=args.experiment_id)
    if args.sweep or args.runfile:
        points = (load_runfile(args.runfile, args.kernel) if args.runfile
                  else default_sweep())
        with _profile_ctx(args, device):
            results = run_sweep({args.matrix_name or args.matrix: coo}, points,
                                config=config, check_gold=not args.no_gold, device=device)
        for mname, per_point in results.items():
            for pname, res in per_point.items():
                print(f"{mname} {pname}: {res.summary()}")
                _emit(res.records, args)
        for mname, bestp in best_per_matrix(results).items():
            print(f"BEST {mname}: {bestp}")
        return 0

    prob = make_spmv_problem(coo, sr=PLUS_TIMES, variant=args.kernel, device=device)
    if args.kernel == "auto" and not args.reorder and prob.variant in ("ell", "coo_seg"):
        print(f"note: structure too scattered for blocked kernels (auto picked "
              f"{prob.variant}); --reorder rcm usually recovers the banded fast path")
    gold = scale = None
    if not args.no_gold:
        x_np = prob.x0.cpu().numpy()
        gold = spmv_gold(coo, x_np, prob.y.cpu().numpy(), PLUS_TIMES)
        scale = spmv_abs_bound(coo, x_np)
    with _profile_ctx(args, device):
        res = benchmark_spmv(prob, gold=gold, config=config,
                             matrix_name=args.matrix_name or args.matrix, nnz=coo.nnz,
                             gold_scale=scale)
    print(res.summary())
    _emit(res.records, args)
    return 0 if res.correctness.value in ("correct", "not_checked") else 1


def _roots_list(args) -> list:
    return [int(r) for r in args.roots.split(",") if r.strip() != ""]


def _x0_builder(algo: str):
    """The app's initial vector (original numbering), for the liveness
    check of a whole-solve run; None for batched --roots and scc --full."""
    flt_max = float(np.finfo(np.float32).max)

    def build(coo, a):
        if getattr(a, "roots", None) or getattr(a, "full", False):
            return None
        n = coo.shape[0]
        root = getattr(a, "root", 0)
        if algo == "sssp":
            x0 = np.full(n, flt_max, np.float32)
            x0[root] = 0.0
            return x0
        if algo == "bfs":
            x0 = np.zeros(n, np.bool_)
            x0[root] = True
            return x0
        if algo == "pagerank":
            return np.full(n, 1.0 / n, np.float32)
        if algo in ("scc", "cc"):
            return np.arange(n, dtype=np.int32)
        if algo == "eigenvector":
            return np.full(n, 1.0 / np.sqrt(n), np.float32)
        if algo == "widest_path":
            x0 = np.full(n, -flt_max, np.float32)
            x0[root] = flt_max
            return x0
        return None

    return build


def _fixpoint_main(description, solve, gold_fn, needs_root, argv, exact=False,
                   kernel_name="fixpoint", sharded_solve=None, frontier_solve=None,
                   algo=None, reorderable=True, supports_roots=False, add_args=None,
                   post_check=None, x0_fn=None, command=None, mesh=None):
    """The shared fixpoint command. ``solve(coo, args, device)`` returns a
    zero-arg solver; ``sharded_solve(coo, args, mesh)`` and
    ``frontier_solve(coo, args, mesh)`` the sharded ones, which add the
    --sharded-mode and --frontier/--budget flags. A --mesh, --devices or
    --frontier run starts a world that runs ``command`` on every rank
    (``mesh`` is the rank's)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    p = _common_parser(description)
    if add_args is not None:
        add_args(p)
    if needs_root:
        p.add_argument("--root", type=int, default=0)
        p.add_argument("--roots", default=None,
                       help="comma-separated roots: solve all sources in one "
                            "SpMM-batched fixpoint (sssp/bfs only)")
    p.add_argument("--max-iter", type=int, default=None)
    p.add_argument("--stepped", action="store_true",
                   help="host-stepped per-iteration timing records")
    if sharded_solve is not None:
        p.add_argument("--sharded-mode", dest="sharded_mode",
                       choices=["auto", "band", "sell", "tiles", "halo", "gather"],
                       default="auto",
                       help="--mesh exchange and local compute: band = the band kernel "
                            "and the ring halo exchange, sell = the sell2 kernel and an "
                            "all-gather, tiles = the tile SpMM kernel and an all-gather "
                            "(batched --roots solves only), halo = the ELL gather and the "
                            "neighbour window, gather = the ELL gather and an all-gather; "
                            "auto prefers the first the structure permits")
    if frontier_solve is not None:
        p.add_argument("--frontier", action="store_true",
                       help="frontier-compressed all_to_all exchange: send only the "
                            "changed (index, value) entries each step instead of the "
                            "dense all-gather (monotone semirings; composes with --mesh)")
        p.add_argument("--budget", type=int, default=1024,
                       help="--frontier: max changed entries sent per (src, dst) pair per "
                            "step; overflow takes a dense all-gather for that step")
    args = p.parse_args(argv)
    if args.reorder and not reorderable:
        p.error(f"--reorder is not supported for {kernel_name}")
    if getattr(args, "roots", None):
        if not supports_roots:
            p.error(f"--roots is not supported for {kernel_name}")
        if args.stepped:
            p.error("--roots is not supported with --stepped")
    frontier = getattr(args, "frontier", False)
    if frontier:
        if getattr(args, "roots", None):
            p.error("--frontier is single-source (no --roots)")
        if args.stepped:
            p.error("--frontier runs the whole-solve loop (no --stepped)")
        if args.reorder:
            p.error("--frontier does not compose with --reorder")
    if not frontier and _mesh_requested(args) and sharded_solve is None:
        p.error(f"--mesh not supported for {kernel_name}")
    if mesh is None and (frontier or _mesh_requested(args)):
        return _launch(command, argv, args, _device(args))
    coo, device = _setup(args)
    from sparseharness_tpu_torch.harness import (
        BenchmarkConfig, benchmark_fixpoint, benchmark_fixpoint_stepped,
    )

    config = BenchmarkConfig(trials=args.trials, timeout_s=args.timeout, delta=args.delta,
                             experiment_id=args.experiment_id)
    lead = mesh is None or mesh.rank == 0  # the rank that checks, prints and writes
    gold = None if args.no_gold or not lead else gold_fn(coo, args)
    x0 = x0_fn(coo, args) if x0_fn is not None else None
    profile = _profile_ctx(args, device) if lead else contextlib.nullcontext()
    if frontier:
        held = {}
        solver = frontier_solve(coo, args, mesh)

        def solve_frontier():
            held["res"] = solver()
            return held["res"]

        with profile:
            res = benchmark_fixpoint(
                solve_frontier, gold=gold, config=config,
                matrix_name=args.matrix_name or args.matrix,
                kernel_name=f"{kernel_name}:frontier{args.mesh}", nnz=coo.nnz, exact=exact,
                x0=x0, world_time=_world_time(mesh))
        fr = held["res"]
        # the measured exchange saving rides in every JSONL row
        for r in res.records:
            r.kernel = f"{kernel_name}:frontier{args.mesh}:{fr.local}"
            r.extra = {
                "frontier_local": fr.local,
                "sent_entries": fr.sent_entries,
                "exchanged_bytes": fr.exchanged_bytes(),
                "allgather_bytes": fr.allgather_bytes(coo.shape[0]),
                "dense_fallbacks": fr.dense_fallbacks,
                "dense_phase_iters": fr.dense_phase_iters,
                "budget": args.budget,
            }
        if lead:
            print(f"frontier[{fr.local}]: {fr.sent_entries} entries "
                  f"({fr.exchanged_bytes()} B) exchanged vs "
                  f"{fr.allgather_bytes(coo.shape[0])} B all-gather; "
                  f"{fr.dense_phase_iters} dense-phase iters, "
                  f"{fr.dense_fallbacks} post-switch fallbacks")
    elif mesh is not None:
        with profile:
            res = benchmark_fixpoint(
                sharded_solve(coo, args, mesh), gold=gold, config=config,
                matrix_name=args.matrix_name or args.matrix,
                kernel_name=f"{kernel_name}:sharded{mesh.size}:{args.sharded_mode}",
                nnz=coo.nnz, exact=exact, x0=x0, world_time=_world_time(mesh))
    elif args.stepped and algo is not None:
        from sparseharness_tpu_torch.algorithms import fixpoint_components

        comp = fixpoint_components(algo, coo, root=getattr(args, "root", 0),
                                   variant=args.kernel, max_iter=args.max_iter,
                                   reorder=args.reorder, device=device)
        with profile:
            res = benchmark_fixpoint_stepped(
                comp, gold=gold, config=config,
                matrix_name=args.matrix_name or args.matrix,
                kernel_name=f"{kernel_name}:{args.kernel}", exact=exact)
    else:
        with profile:
            res = benchmark_fixpoint(
                solve(coo, args, device), gold=gold, config=config,
                matrix_name=args.matrix_name or args.matrix,
                kernel_name=f"{kernel_name}:{args.kernel}", nnz=coo.nnz,
                exact=exact, x0=x0)
    if not lead:
        return 0
    print(f"{res.summary()} | {res.iterations} iterations")
    _emit(res.records, args)
    rc = 0 if res.correctness.value in ("correct", "not_checked") else 1
    if rc == 0 and post_check is not None:
        err = post_check(coo, args, res)
        if err:
            print(f"post-check FAILED: {err}", file=sys.stderr)
            rc = 1
    return rc


def sssp_main(argv: Optional[list] = None, *, mesh=None) -> int:
    from sparseharness_tpu_torch.algorithms import multi_sssp, sssp
    from sparseharness_tpu_torch.gold import sssp_gold
    from sparseharness_tpu_torch.parallel import (
        frontier_sssp, sharded_multi_sssp, sharded_sssp,
    )

    def _solve(coo, a, device):
        if a.roots:
            return multi_sssp(coo, _roots_list(a), variant=a.kernel, max_iter=a.max_iter,
                              reorder=a.reorder, return_solver=True, device=device)
        return sssp(coo, a.root, variant=a.kernel, max_iter=a.max_iter,
                    reorder=a.reorder, return_solver=True, device=device)

    def _gold(coo, a):
        if a.roots:
            return np.stack([sssp_gold(coo, r) for r in _roots_list(a)], axis=1)
        return sssp_gold(coo, a.root)

    def _sharded(coo, a, m):
        if a.roots:
            return sharded_multi_sssp(coo, _roots_list(a), mesh=m, max_iter=a.max_iter,
                                      reorder=a.reorder, mode=a.sharded_mode,
                                      return_solver=True)
        return sharded_sssp(coo, a.root, mesh=m, max_iter=a.max_iter, reorder=a.reorder,
                            mode=a.sharded_mode, return_solver=True)

    def _frontier(coo, a, m):
        return frontier_sssp(coo, a.root, mesh=m, budget=a.budget, max_iter=a.max_iter,
                             return_solver=True)

    return _fixpoint_main(
        "SSSP min-plus fixpoint; --roots batches sources into one SpMM fixpoint "
        "(composes with --mesh: row-sharded SpMM)",
        _solve, _gold, needs_root=True, argv=argv, kernel_name="sssp", algo="sssp",
        x0_fn=_x0_builder("sssp"), supports_roots=True, sharded_solve=_sharded,
        frontier_solve=_frontier, command=sssp_main, mesh=mesh,
    )


def bfs_main(argv: Optional[list] = None, *, mesh=None) -> int:
    from sparseharness_tpu_torch.algorithms import bfs, multi_bfs
    from sparseharness_tpu_torch.gold import bfs_reach_gold
    from sparseharness_tpu_torch.parallel import (
        frontier_bfs, sharded_bfs, sharded_multi_bfs,
    )

    def _solve(coo, a, device):
        if a.roots:
            return multi_bfs(coo, _roots_list(a), variant=a.kernel, max_iter=a.max_iter,
                             reorder=a.reorder, return_solver=True, device=device)
        return bfs(coo, a.root, variant=a.kernel, max_iter=a.max_iter,
                   reorder=a.reorder, return_solver=True, device=device)

    def _gold(coo, a):
        if a.roots:
            return np.stack([bfs_reach_gold(coo, r) for r in _roots_list(a)], axis=1)
        return bfs_reach_gold(coo, a.root)

    def _sharded(coo, a, m):
        if a.roots:
            return sharded_multi_bfs(coo, _roots_list(a), mesh=m, max_iter=a.max_iter,
                                     reorder=a.reorder, mode=a.sharded_mode,
                                     return_solver=True)
        return sharded_bfs(coo, a.root, mesh=m, max_iter=a.max_iter, reorder=a.reorder,
                           mode=a.sharded_mode, return_solver=True)

    def _frontier(coo, a, m):
        return frontier_bfs(coo, a.root, mesh=m, budget=a.budget, max_iter=a.max_iter,
                            return_solver=True)

    return _fixpoint_main(
        "BFS or/and fixpoint; --roots batches sources into one SpMM fixpoint "
        "(composes with --mesh: row-sharded SpMM)",
        _solve, _gold, needs_root=True, argv=argv, exact=True, kernel_name="bfs",
        algo="bfs", x0_fn=_x0_builder("bfs"), supports_roots=True, sharded_solve=_sharded,
        frontier_solve=_frontier, command=bfs_main, mesh=mesh,
    )


def pr_main(argv: Optional[list] = None, *, mesh=None) -> int:
    from sparseharness_tpu_torch.algorithms import pagerank
    from sparseharness_tpu_torch.gold import pagerank_gold
    from sparseharness_tpu_torch.parallel import sharded_pagerank

    return _fixpoint_main(
        "PageRank power iteration",
        lambda coo, a, device: pagerank(coo, variant=a.kernel, max_iter=a.max_iter or 1000,
                                        reorder=a.reorder, return_solver=True,
                                        device=device),
        lambda coo, a: pagerank_gold(coo),
        needs_root=False, argv=argv, kernel_name="pagerank", algo="pagerank",
        x0_fn=_x0_builder("pagerank"),
        sharded_solve=lambda coo, a, m: sharded_pagerank(
            coo, mesh=m, max_iter=a.max_iter or 1000, reorder=a.reorder,
            mode=a.sharded_mode, return_solver=True),
        command=pr_main, mesh=mesh,
    )


def _canon_partition(labels: np.ndarray) -> np.ndarray:
    """Relabel a component labelling to first-occurrence dense ids, so any
    two labellings of the same partition compare equal exactly."""
    _, idx, inv = np.unique(labels, return_index=True, return_inverse=True)
    rank = np.argsort(np.argsort(idx))
    return rank[inv].astype(np.int32)


def scc_main(argv: Optional[list] = None, *, mesh=None) -> int:
    """SCC command: forward max-label propagation by default; --full runs
    the forward-and-backward SCC and checks the partition against the
    classical gold."""
    from sparseharness_tpu_torch.algorithms.apps import _label_propagate, scc
    from sparseharness_tpu_torch.gold import scc_gold, scc_labels_gold
    from sparseharness_tpu_torch.ops import Geometry
    from sparseharness_tpu_torch.parallel import sharded_scc, sharded_scc_forward

    def _full_result(labels, fwd, bwd):
        return types.SimpleNamespace(
            x=torch.from_numpy(_canon_partition(labels)).to(fwd.x.device),
            iterations=fwd.iterations + bwd.iterations,
            converged=fwd.converged and bwd.converged,
        )

    def _solve(coo, a, device):
        if a.full:
            # two fixpoints and a host intersection: the solver rebuilds
            return lambda: _full_result(*scc(coo, variant=a.kernel, max_iter=a.max_iter,
                                             device=device))
        return _label_propagate(coo, a.kernel, Geometry(), a.max_iter, return_solver=True,
                                device=device)

    def _sharded(coo, a, m):
        if a.full:
            return lambda: _full_result(*sharded_scc(coo, mesh=m, max_iter=a.max_iter,
                                                     mode=a.sharded_mode))
        return sharded_scc_forward(coo, mesh=m, max_iter=a.max_iter, mode=a.sharded_mode,
                                   return_solver=True)

    def _gold(coo, a):
        if a.full:
            return _canon_partition(scc_gold(coo))
        return scc_labels_gold(coo)

    return _fixpoint_main(
        "SCC max-label propagation (forward pass by default, --full for the "
        "forward-and-backward components)",
        _solve, _gold, needs_root=False, argv=argv, exact=True, kernel_name="scc",
        algo="scc", x0_fn=_x0_builder("scc"),
        reorderable=False,  # raw labels depend on the numbering
        sharded_solve=_sharded, command=scc_main, mesh=mesh,
        add_args=lambda p: p.add_argument(
            "--full", action="store_true",
            help="full SCC: forward-and-backward label propagation intersection"),
    )


def _sign_canon(x: np.ndarray) -> np.ndarray:
    """Flip an eigenvector so that its largest-magnitude component (the
    first on ties) is positive."""
    x = np.asarray(x)
    if x.size == 0:
        return x
    i = int(np.argmax(np.abs(x)))
    return -x if x[i] < 0 else x


def eigenvector_main(argv: Optional[list] = None, *, mesh=None) -> int:
    """Eigenvector command: the sign-canonical solve against
    eigenvector_gold, then a Rayleigh-residual post-check
    ||Ax − λx|| ≤ tol·||A||_F, so a wrong result exits nonzero."""
    from sparseharness_tpu_torch.algorithms import eigenvector
    from sparseharness_tpu_torch.gold import eigenvector_gold
    from sparseharness_tpu_torch.parallel import sharded_eigenvector

    held = {}

    def _canon_res(res):
        x = _sign_canon(res.x.cpu().numpy())
        held["x"] = x
        return types.SimpleNamespace(x=torch.from_numpy(x).to(res.x.device),
                                     iterations=res.iterations, converged=res.converged)

    def _solve(coo, a, device):
        s = eigenvector(coo, variant=a.kernel, max_iter=a.max_iter or 1000,
                        reorder=a.reorder, return_solver=True, device=device)
        return lambda: _canon_res(s()[0])

    def _sharded(coo, a, m):
        s = sharded_eigenvector(coo, mesh=m, max_iter=a.max_iter or 1000, reorder=a.reorder,
                                mode=a.sharded_mode, return_solver=True)
        return lambda: _canon_res(s())

    def _post(coo, a, res):
        x = held.get("x")
        if x is None:  # the stepped path: the gold compare already gates
            return None
        x = x.astype(np.float64)
        nrm = np.linalg.norm(x)
        if nrm == 0:
            return "solve returned the zero vector"
        x = x / nrm
        ax = np.zeros(coo.shape[0], np.float64)
        np.add.at(ax, coo.rows, coo.vals.astype(np.float64) * x[coo.cols])
        lam = float(x @ ax)
        resid = float(np.linalg.norm(ax - lam * x))
        tol = max(a.delta, 1e-4) * max(float(np.linalg.norm(coo.vals.astype(np.float64))),
                                       1.0)
        if resid > tol:
            return f"Rayleigh residual ||Ax-λx|| = {resid:.3e} > {tol:.3e} (λ = {lam:.6g})"
        print(f"rayleigh: λ = {lam:.6g}, residual {resid:.3e} (tol {tol:.3e})")
        return None

    return _fixpoint_main(
        "Dominant eigenvector power iteration, gold-checked with sign "
        "canonicalisation and a Rayleigh residual",
        _solve, lambda coo, a: _sign_canon(eigenvector_gold(coo)),
        needs_root=False, argv=argv, kernel_name="eigenvector", algo="eigenvector",
        sharded_solve=_sharded, post_check=_post, x0_fn=_x0_builder("eigenvector"),
        command=eigenvector_main, mesh=mesh,
    )


def cc_main(argv: Optional[list] = None, *, mesh=None) -> int:
    from sparseharness_tpu_torch.algorithms import connected_components
    from sparseharness_tpu_torch.gold import connected_components_gold

    return _fixpoint_main(
        "Connected components via min-label propagation",
        lambda coo, a, device: connected_components(
            coo, variant=a.kernel, max_iter=a.max_iter, reorder=a.reorder,
            return_solver=True, device=device),
        lambda coo, a: connected_components_gold(coo),
        needs_root=False, argv=argv, exact=True, kernel_name="cc",
        x0_fn=_x0_builder("cc"), command=cc_main, mesh=mesh,
    )


def widest_path_main(argv: Optional[list] = None, *, mesh=None) -> int:
    from sparseharness_tpu_torch.algorithms import widest_path
    from sparseharness_tpu_torch.gold import widest_path_gold

    return _fixpoint_main(
        "Widest (bottleneck) path via the max-min semiring",
        lambda coo, a, device: widest_path(
            coo, a.root, variant=a.kernel, max_iter=a.max_iter, reorder=a.reorder,
            return_solver=True, device=device),
        lambda coo, a: widest_path_gold(coo, a.root),
        needs_root=True, argv=argv, exact=True, kernel_name="widest_path",
        x0_fn=_x0_builder("widest_path"), command=widest_path_main, mesh=mesh,
    )


def just_parser_main(argv: Optional[list] = None) -> int:
    """Preprocessing-only benchmark: N trials of .mtx parse and operand
    build, with no SpMV."""
    p = argparse.ArgumentParser(description="parser/encode micro-benchmark")
    p.add_argument("-m", "--matrix", required=True)
    p.add_argument("-k", "--kernel", default="ell")
    p.add_argument("-n", "--trials", type=int, default=5)
    p.add_argument("--no-native", action="store_true",
                   help="parse with NumPy instead of the native library")
    p.add_argument("--device", default="cuda",
                   help="torch device the operand is built on (default cuda)")
    args = p.parse_args(argv)
    device = _device(args)
    from sparseharness_tpu_torch.formats import read_mtx
    from sparseharness_tpu_torch.ops import build_operand
    from sparseharness_tpu_torch.semiring import PLUS_TIMES
    from sparseharness_tpu_torch.utils.timing import report_timing

    for trial in range(args.trials):
        t0 = time.perf_counter()
        coo = read_mtx(args.matrix, use_native=not args.no_native)
        t1 = time.perf_counter()
        build_operand(coo, PLUS_TIMES, args.kernel, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t2 = time.perf_counter()
        report_timing("parse", "just_parser", (t1 - t0) * 1e3)
        report_timing("encode", "just_parser", (t2 - t1) * 1e3)
        print(f"trial {trial}: parse {1e3 * (t1 - t0):.2f} ms "
              f"({coo.nnz / max(t1 - t0, 1e-9) / 1e6:.1f} Mnnz/s), "
              f"encode[{args.kernel}] {1e3 * (t2 - t1):.2f} ms")
    return 0


COMMANDS = {
    "spmv": spmv_main, "sssp": sssp_main, "bfs": bfs_main, "pr": pr_main,
    "scc": scc_main, "eigenvector": eigenvector_main, "cc": cc_main,
    "widest_path": widest_path_main, "just_parser": just_parser_main,
}


def main(argv: Optional[list] = None) -> int:
    """``<app> [flags]``: run the app's command on the flags."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m sparseharness_tpu_torch.cli {{{','.join(COMMANDS)}}} "
              "[flags]", file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:])
