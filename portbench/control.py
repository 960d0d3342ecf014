#!/usr/bin/env python3
"""Readings for the limits of ``correct``: the numbers that a cell
compares, for several seeds in one process, from the program as it runs
(``--mode program``) or from the precision control (``--mode control``):
the program with its own bfloat16 path switched on (``Geometry(
value_dtype="bfloat16")``: the matrix's values stored in bfloat16), the
nearest precision below the float32 that every configuration states.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 --seconds 3 --mode control

Each seed prints one JSON line ``{"seed", "mode", "correct", "checks"}``;
a run that raises prints its error under ``"error"`` (a control that
crashes has failed and sets no upper reading). The benchmark's own runs
never run this.
"""

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--mode", choices=("program", "control"), required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness
    from sparseharness_tpu_torch.ops import Geometry

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    bench = harness.Bench(ROOT)
    geometry = Geometry(value_dtype="bfloat16") if args.mode == "control" else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        line = {"workload": args.workload, "seed": seed, "mode": args.mode}
        try:
            out = harness.run_cell(bench, args.workload, seed, args.seconds, False,
                                   geometry=geometry)
            line.update(correct=out["result"]["correct"], route=out["route"]["route"],
                        checks={k: v for k, (v, _) in out["checks"].items()})
        except Exception as e:  # a control that crashes has failed: record why
            line["error"] = f"{type(e).__name__}: {e}"
            traceback.print_exc()
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
