"""Build the port's CUDA sources into shared libraries at first use.

Each ``ops/csrc/<name>.cu`` becomes ``lib<name>.so`` with a plain C
interface, loaded with ctypes. The libraries go to ``build/sh_kernels/
<digest>/`` beside the package, keyed by a hash of every source and the
nvcc flags, so an edit rebuilds and an unchanged tree reuses the build.
Only the sources in the checkout are compiled; a failed build raises.

It also holds what every kernel library shares: the semiring and strip
type codes of the C interface (as ``csrc/semiring.cuh``), the launch
counters, and the check of a launch's return code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "sh_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}

#: launches of each kernel since the last reset; a wrapper adds one where it
#: launches its kernel and nowhere else, so a run that resets the counts
#: shows which kernels its work went through
LAUNCHES: Dict[str, int] = {"staged": 0, "streamed": 0, "bsr_fused": 0,
                            "bsr_ell": 0, "bsr_pallas": 0, "sell2": 0,
                            "spmm_band": 0, "spmm_tiles": 0, "sell_phase_a": 0,
                            "sell_level": 0}

#: semiring codes of the C interface, as csrc/semiring.cuh:SrCode
SR_CODES = {"plus_times": 0, "min_plus": 1, "or_and": 2, "max_min": 3,
            "max_times": 4, "max_right": 5, "min_right": 6}
#: strip (tile) type codes, as csrc/semiring.cuh:StripCode
STRIP_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def library_path(name: str) -> Path:
    return BUILD_ROOT / _digest() / f"lib{name}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named sources (all by default) that are not built yet,
    one nvcc each, all started together. Returns nvcc's report (ptxas
    registers, shared memory and spills) per source built."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """``symbol`` of library ``name`` with its argument types set and an int
    (cudaError_t) result."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check_launch(name: str, rc: int) -> None:
    """Raise on a kernel library's non-zero return code, with CUDA's text."""
    if rc != 0:
        fn = load(name).sh_error_string
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{name} kernel launch failed: {fn(rc).decode()}")

