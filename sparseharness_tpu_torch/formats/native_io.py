"""ctypes bindings to the port's native host library (``csrc/fast_mtx.cpp``).

The library holds the host-side stages that NumPy runs slowly: the
MatrixMarket body parse, a CSR encode, the symmetrized pattern and the
traversal of reverse Cuthill-McKee, and the sell2 encode (the sort and
duplicate fold, the heavy-row split, the two-shelf packer and the whole
per-slab encode). Each gives the same result as the port's NumPy code, bit
for bit (the parse: the same indices, values within rounding).

The source is compiled with g++ at first use into ``build/fastmtx/
<digest>/libfastmtx.so`` beside the package, keyed by a hash of the source
and the flags, and loaded with ctypes. Nothing else is built or loaded.
When the library cannot be built or loaded every function raises
:class:`NativeUnavailable`: the callers do not fall back to NumPy on their
own. ``SPARSEHARNESS_TPU_NATIVE=0`` (or a caller's ``use_native=False``)
is the one way to the NumPy path. The one refusal that depends on the data
is :func:`sell2_encode_slab`'s (a slab past the align budget), whose caller
runs the NumPy body for that slab.

Loading makes the process-wide ``fastmtx_tune_malloc`` call (large buffers
stay in the heap arena, so a repeated encode does not refault its pages);
``SPARSEHARNESS_TPU_MALLOC_TUNE=0`` skips it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from sparseharness_tpu_torch.formats.sparse import COO

SOURCE = Path(__file__).resolve().parent / "csrc" / "fast_mtx.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "fastmtx"
CXX_FLAGS = ("-O3", "-Wall", "-Wextra", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeUnavailable(RuntimeError):
    """The native library could not be built or loaded, or refused an input."""


def enabled() -> bool:
    """Whether the environment asks for the native path (the default)."""
    return os.environ.get("SPARSEHARNESS_TPU_NATIVE", "1") != "0"


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libfastmtx.so"


def build() -> Path:
    """Compile the source if it is not built yet; returns the library path."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise NativeUnavailable("no C++ compiler (g++) to build the native library")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeUnavailable(f"native build failed ({cxx} exited {proc.returncode}):\n"
                                f"{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises NativeUnavailable."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
        except (OSError, AttributeError, subprocess.SubprocessError) as e:
            raise NativeUnavailable(f"native library unavailable: {e}") from e
        if os.environ.get("SPARSEHARNESS_TPU_MALLOC_TUNE", "1") != "0":
            lib.fastmtx_tune_malloc()
        _lib = lib
        return lib


def _bind(lib: ctypes.CDLL) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64
    sigs = {
        "fastmtx_parse": (i64, [ctypes.c_char_p, i64, i64, ctypes.c_int, i32p, i32p,
                                ctypes.POINTER(ctypes.c_double)]),
        "fastmtx_csr_encode": (None, [i64, ctypes.c_int32, i32p, i32p,
                                      ctypes.POINTER(ctypes.c_double), i32p, i32p,
                                      ctypes.POINTER(ctypes.c_float)]),
        "fastmtx_rcm": (None, [ctypes.c_int32, i32p, i32p, i32p]),
        "fastmtx_sym_pattern": (i64, [ctypes.c_int32, i64, i32p, i32p, i32p, i32p]),
        "sell2_twoshelf_pack": (None, [i64p, i64, i64, i64, i64, i64p, i64p,
                                       ctypes.POINTER(ctypes.c_int8), i64p, i64p]),
        "sell2_encode_slab": (ctypes.c_void_p, [i64p, i64p, u8p, i64, i64, u8p, i64, i64,
                                                i64, ctypes.c_int32, i64, i64, i64, i64]),
        "sell2_slab_meta": (None, [ctypes.c_void_p, i64p, i64p, i32p, i32p, i32p]),
        "sell2_slab_fetch": (None, [ctypes.c_void_p, i32p, i32p, u8p, i32p, i32p, u8p,
                                    u8p, i32p, ctypes.c_int32]),
        "sell2_slab_free": (None, [ctypes.c_void_p]),
        "sell2_heavy_split": (i64, [i32p, i32p, u8p, i64, i64, i64, i64, i64, i64p, i64p,
                                    u8p, i32p]),
        "sell2_sort_fold": (i64, [i32p, i32p, u8p, i64, i64, i64, i64, ctypes.c_int32,
                                  ctypes.c_int32, i32p, i32p, u8p]),
        "fastmtx_tune_malloc": (None, []),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _check_bounds(rows: np.ndarray, cols: np.ndarray, n_rows: int, n_cols: int) -> None:
    """Refuse an entry outside the shape: a parsed file's, or one the C code
    would index a table with."""
    if len(rows) and (rows.min() < 0 or cols.min() < 0
                      or rows.max() >= n_rows or cols.max() >= n_cols):
        raise ValueError("entry index out of bounds")


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        load()
        return True
    except NativeUnavailable:
        return False


def _body_offset(path: str) -> int:
    """Byte offset of the first entry line (after banner, comments and size)."""
    offset = 0
    with open(path, "rb") as f:
        for line in f:
            offset += len(line)
            s = line.strip()
            if s and not s.startswith(b"%"):
                return offset  # the size line
    raise ValueError("missing size line")


def parse_entries(path: str, header) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(rows, cols, vals) of the file's entries, 0-based int64 indices and
    float64 values. Raises ValueError on a short or out-of-bounds body."""
    lib = load()
    nnz = header.nnz
    rows = np.empty(nnz, np.int32)
    cols = np.empty(nnz, np.int32)
    vals = np.empty(nnz, np.float64)
    got = lib.fastmtx_parse(path.encode(), _body_offset(path), nnz,
                            1 if header.field == "pattern" else 0,
                            _ptr(rows, ctypes.c_int32), _ptr(cols, ctypes.c_int32),
                            _ptr(vals, ctypes.c_double))
    if got != nnz:
        raise ValueError(f"expected {nnz} entries, the native parser read {got}")
    _check_bounds(rows, cols, header.rows, header.cols)
    return rows.astype(np.int64), cols.astype(np.int64), vals


def csr_encode(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
               n_rows: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(indptr, cols, f32 vals): a histogram and stable scatter by row, so
    a row keeps its entries in input order."""
    lib = load()
    nnz = len(rows)
    rows32 = np.ascontiguousarray(rows, np.int32)
    cols32 = np.ascontiguousarray(cols, np.int32)
    vals64 = np.ascontiguousarray(vals, np.float64)
    indptr = np.empty(n_rows + 1, np.int32)
    out_cols = np.empty(nnz, np.int32)
    out_vals = np.empty(nnz, np.float32)
    lib.fastmtx_csr_encode(nnz, n_rows, _ptr(rows32, ctypes.c_int32),
                           _ptr(cols32, ctypes.c_int32), _ptr(vals64, ctypes.c_double),
                           _ptr(indptr, ctypes.c_int32), _ptr(out_cols, ctypes.c_int32),
                           _ptr(out_vals, ctypes.c_float))
    return indptr, out_cols, out_vals


def rcm(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee over a symmetrized, de-duplicated,
    diagonal-free CSR pattern: the permutation (new → old, int32) of
    formats/reorder.py's NumPy traversal, bit for bit."""
    lib = load()
    n = len(indptr) - 1
    if len(indices) >= 2**31 or n >= 2**31:
        raise NativeUnavailable("pattern too large for int32 indexing")
    indptr32 = np.ascontiguousarray(indptr, np.int32)
    indices32 = np.ascontiguousarray(indices, np.int32)
    perm = np.empty(max(n, 1), np.int32)
    lib.fastmtx_rcm(n, _ptr(indptr32, ctypes.c_int32), _ptr(indices32, ctypes.c_int32),
                    _ptr(perm, ctypes.c_int32))
    return perm[:n]


def sym_pattern(n: int, rows: np.ndarray, cols: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(indptr, indices) int32 of the symmetrized, de-duplicated,
    diagonal-free pattern: reorder._sym_pattern_csr's."""
    lib = load()
    nnz = len(rows)
    if n >= 2**31 or 2 * nnz >= 2**31:
        raise NativeUnavailable("pattern too large for int32 indexing")
    _check_bounds(rows, cols, n, n)
    rows32 = np.ascontiguousarray(rows, np.int32)
    cols32 = np.ascontiguousarray(cols, np.int32)
    indptr = np.empty(n + 1, np.int32)
    indices = np.empty(max(2 * nnz, 1), np.int32)
    got = lib.fastmtx_sym_pattern(n, nnz, _ptr(rows32, ctypes.c_int32),
                                  _ptr(cols32, ctypes.c_int32), _ptr(indptr, ctypes.c_int32),
                                  _ptr(indices, ctypes.c_int32))
    if got < 0:
        raise NativeUnavailable("sym_pattern allocation failure")
    return indptr, indices[:got].copy()


def rcm_from_coo(n: int, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """The whole RCM: native symmetrization, then the native traversal."""
    indptr, indices = sym_pattern(n, rows, cols)
    return rcm(indptr, indices)


def sell2_pack(cnt: np.ndarray, max_push: int, max_holes: int, hole_tries: int):
    """The two-shelf packer (ops/sell2._twoshelf_pack's contract and bits):
    ``(n_sub, bind0, bind1, way, flat_sub)``."""
    lib = load()
    cnt = np.ascontiguousarray(cnt, dtype=np.int64)
    nb = cnt.shape[0]
    cap = (int(cnt.max(axis=1).sum()) if nb else 0) + max_push + 1
    bind0 = np.empty(cap, np.int64)
    bind1 = np.empty(cap, np.int64)
    way = np.empty(max(nb, 1), np.int8)
    flat = np.empty(max(int(cnt.sum()), 1), np.int64)
    n_sub = np.zeros(1, np.int64)
    lib.sell2_twoshelf_pack(_ptr(cnt, ctypes.c_int64), nb, max_push, max_holes, hole_tries,
                            _ptr(bind0, ctypes.c_int64), _ptr(bind1, ctypes.c_int64),
                            _ptr(way, ctypes.c_int8), _ptr(flat, ctypes.c_int64),
                            _ptr(n_sub, ctypes.c_int64))
    ns = int(n_sub[0])
    if ns < 0:
        raise NativeUnavailable("sell2_twoshelf_pack: placement bounds invariant breached")
    return ns, bind0[:ns], bind1[:ns], way[:nb], flat[:int(cnt.sum())]


def sell2_encode_slab(rows_e, cols_e, vals_store, zero_store, n_chunks: int,
                      virt_base: int, rows_slab: int, virtual_chunks: bool, max_push: int,
                      max_holes: int, hole_tries: int, virt_demand_t: int,
                      bucket_order: bool = False):
    """One slab's sell2 encode, the NumPy slab body's arrays bit for bit:
    ``(wordA, wordB, vals, chunk_of_panel, p_depth, p_two, p_hi, virt_rows,
    bf_depth, two_tiles, has_hi, P)``. ``vals_store`` and ``zero_store``
    hold the values as stored (any 2- or 4-byte type: bf16 as its bits).
    Virtual chunk ids start at ``virt_base``. With ``bucket_order`` the
    panels come sorted by (depth group, two tiles), stable. Returns None
    when the slab's layout breaks an invariant (the align budget): the
    caller runs the NumPy body for it."""
    lib = load()
    rows_e = np.ascontiguousarray(rows_e, np.int64)
    cols_e = np.ascontiguousarray(cols_e, np.int64)
    vals_store = np.ascontiguousarray(vals_store)
    zero_store = np.ascontiguousarray(zero_store)
    if zero_store.dtype != vals_store.dtype:
        raise ValueError("zero and values must share a dtype")
    h = lib.sell2_encode_slab(
        _ptr(rows_e, ctypes.c_int64), _ptr(cols_e, ctypes.c_int64),
        _ptr(vals_store, ctypes.c_uint8), len(rows_e), vals_store.dtype.itemsize,
        _ptr(zero_store, ctypes.c_uint8), n_chunks, virt_base, rows_slab,
        1 if virtual_chunks else 0, max_push, max_holes, hole_tries, virt_demand_t)
    if not h:
        return None
    try:
        P, n_virt = ctypes.c_int64(), ctypes.c_int64()
        bf, two, hi = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
        lib.sell2_slab_meta(h, ctypes.byref(P), ctypes.byref(n_virt), ctypes.byref(bf),
                            ctypes.byref(two), ctypes.byref(hi))
        P_, nv, L = int(P.value), int(n_virt.value), 128
        wordA = np.empty((P_ * L, L), np.int32)
        wordB = np.empty((P_ * L, L), np.int32)
        vals = np.empty((P_ * L, L), vals_store.dtype)
        cop = np.empty((P_, 2), np.int32)
        p_depth = np.empty(P_, np.int32)
        p_two = np.empty(P_, np.uint8)
        p_hi = np.empty(P_, np.uint8)
        vrows = np.empty((max(nv, 1), L), np.int32)
        lib.sell2_slab_fetch(h, _ptr(wordA, ctypes.c_int32), _ptr(wordB, ctypes.c_int32),
                             _ptr(vals, ctypes.c_uint8), _ptr(cop, ctypes.c_int32),
                             _ptr(p_depth, ctypes.c_int32), _ptr(p_two, ctypes.c_uint8),
                             _ptr(p_hi, ctypes.c_uint8), _ptr(vrows, ctypes.c_int32),
                             1 if bucket_order else 0)
    finally:
        lib.sell2_slab_free(h)
    return (wordA, wordB, vals, cop, p_depth, p_two.astype(bool), p_hi.astype(bool),
            vrows[:nv], int(bf.value), bool(two.value), bool(hi.value), P_)


_VAL_KINDS = {"float32": 0, "float64": 1, "int32": 2, "int64": 3, "bool": 4}
_FOLD_OPS = {"add": 0, "minimum": 1, "maximum": 2}


def sell2_sort_fold(coo: COO, fold_name: str) -> COO:
    """The (row, col)-sorted COO with duplicates ⊕-folded in input order:
    ``fold_duplicates(coo, fold).sorted_by_row()``, the same bits.
    ``fold_name`` is the NumPy ufunc's name (add, minimum, maximum); bool
    values fold with or."""
    lib = load()
    kind = _VAL_KINDS.get(np.dtype(coo.vals.dtype).name)
    if kind is None:
        raise NativeUnavailable(f"unsupported value dtype {coo.vals.dtype}")
    nnz = coo.nnz
    if nnz > 2**31 - 1:
        raise NativeUnavailable("nnz out of native range")
    _check_bounds(coo.rows, coo.cols, *coo.shape)
    rows = np.ascontiguousarray(coo.rows, np.int32)
    cols = np.ascontiguousarray(coo.cols, np.int32)
    vals = np.ascontiguousarray(coo.vals)
    if nnz == 0:
        return COO(rows, cols, vals, coo.shape)
    out_rows = np.empty(nnz, np.int32)
    out_cols = np.empty(nnz, np.int32)
    out_vals = np.empty(nnz, vals.dtype)
    got = lib.sell2_sort_fold(
        _ptr(rows, ctypes.c_int32), _ptr(cols, ctypes.c_int32), _ptr(vals, ctypes.c_uint8),
        nnz, coo.shape[0], coo.shape[1], vals.dtype.itemsize, kind,
        _FOLD_OPS[fold_name], _ptr(out_rows, ctypes.c_int32), _ptr(out_cols, ctypes.c_int32),
        _ptr(out_vals, ctypes.c_uint8))
    if got < 0:
        raise NativeUnavailable("sell2_sort_fold refused the input")
    return COO(out_rows[:got], out_cols[:got], out_vals[:got], coo.shape)


def sell2_heavy_split(s_coo: COO, vals_all: np.ndarray, base_pad: int, split_t: int):
    """Rows longer than ``split_t`` striped over overflow pieces past
    ``base_pad``, in the final (row, col) order: ops/sell2._heavy_split's
    ``(k_rows, k_cols, k_vals, piece_owner, n_pieces)``, piece_owner None
    without pieces. ``s_coo`` is (row, col)-sorted and duplicate-free;
    ``vals_all`` its values in the carrier type."""
    lib = load()
    nnz = s_coo.nnz
    if nnz > 2**31 - 1:
        raise NativeUnavailable("nnz out of native range")
    vals = np.ascontiguousarray(vals_all)
    if nnz == 0:
        empty = np.empty(0, np.int64)
        return empty, empty, vals, None, 0
    rows = np.ascontiguousarray(s_coo.rows, np.int32)
    cols = np.ascontiguousarray(s_coo.cols, np.int32)
    if rows[0] < 0 or rows[-1] >= s_coo.shape[0]:  # sorted by row
        raise ValueError("entry index out of bounds")
    k_rows = np.empty(nnz, np.int64)
    k_cols = np.empty(nnz, np.int64)
    k_vals = np.empty(nnz, vals.dtype)
    owner = np.empty(nnz // max(split_t // 2, 1) + 2, np.int32)
    got = lib.sell2_heavy_split(
        _ptr(rows, ctypes.c_int32), _ptr(cols, ctypes.c_int32), _ptr(vals, ctypes.c_uint8),
        nnz, vals.dtype.itemsize, s_coo.shape[0], base_pad, split_t,
        _ptr(k_rows, ctypes.c_int64), _ptr(k_cols, ctypes.c_int64),
        _ptr(k_vals, ctypes.c_uint8), _ptr(owner, ctypes.c_int32))
    if got < 0:
        raise NativeUnavailable("sell2_heavy_split refused the input")
    return k_rows, k_cols, k_vals, (owner[:got] if got else None), int(got)
