#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout of the repository, on a machine with as many
CUDA cards as the cell asks for. It makes the cell's graph and traffic
from the seed, builds the program's operand (set-up, ``setup_s``),
drives the traffic for ``--seconds`` (the window), and with ``--trace 1``
a short stretch more under torch.profiler. It then compares what the
window produced with the plain reference. Standard output ends with the
route line (the route ``auto`` took, the device bytes the build kept,
launches per call or step) and then the result line; standard error ends with
each number compared beside its limit.

It exits 2 when the checkout lacks the program or the cell, 3 without
enough CUDA cards, 4 when JAX or the JAX package was loaded, and prints
no result then.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    if not (ROOT / "sparseharness_tpu_torch").is_dir():
        print("the program (sparseharness_tpu_torch) is not in this checkout", file=sys.stderr)
        return 2
    # kernel caches at fixed paths inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    bench = harness.Bench(ROOT)
    try:
        cell = bench.cell(args.workload)
    except KeyError as e:
        print(e, file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = harness.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t0=T0)
    found = harness.forbidden_modules()
    if found:
        print(f"modules that a run may not load were loaded: {found}", file=sys.stderr)
        return 4
    print(json.dumps(out["route"]), flush=True)
    print(json.dumps(out["result"]), flush=True)
    for k, (v, lim) in out["checks"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
