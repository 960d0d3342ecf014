"""MatrixMarket coordinate-format I/O (NumPy parse and write).

- banner: ``%%MatrixMarket matrix coordinate {real|integer|pattern} {general|symmetric|skew-symmetric}``
- ``%`` comment lines, then ``rows cols nnz``, then one entry per line
- field ``pattern`` ⇒ no value column, values default to 1
- symmetry ``symmetric`` ⇒ off-diagonal entries mirrored; ``skew-symmetric``
  ⇒ mirrored negated
- 1-based indices converted to 0-based
"""

from __future__ import annotations

import dataclasses
import io
from typing import Tuple

import numpy as np

from sparseharness_tpu_torch.formats.sparse import COO

_FIELDS = ("real", "integer", "pattern", "complex")
_SYMMETRIES = ("general", "symmetric", "skew-symmetric", "hermitian")


@dataclasses.dataclass(frozen=True)
class MtxHeader:
    rows: int
    cols: int
    nnz: int  # entries stored in the file (before symmetric expansion)
    field: str
    symmetry: str


class MtxFormatError(ValueError):
    pass


def _parse_banner(line: str) -> Tuple[str, str]:
    parts = line.strip().split()
    if (
        len(parts) != 5
        or parts[0] != "%%MatrixMarket"
        or parts[1].lower() != "matrix"
        or parts[2].lower() != "coordinate"
    ):
        raise MtxFormatError(f"unsupported MatrixMarket banner: {line.strip()!r}")
    field = parts[3].lower()
    symmetry = parts[4].lower()
    if field not in _FIELDS:
        raise MtxFormatError(f"unknown field {field!r}")
    if field == "complex":
        raise MtxFormatError("complex matrices are not supported")
    if symmetry not in _SYMMETRIES:
        raise MtxFormatError(f"unknown symmetry {symmetry!r}")
    if symmetry == "hermitian":
        raise MtxFormatError("hermitian matrices are not supported")
    return field, symmetry


def read_mtx_header(path: str) -> MtxHeader:
    with open(path, "r") as f:
        field, symmetry = _parse_banner(f.readline())
        for line in f:
            s = line.strip()
            if not s or s.startswith("%"):
                continue
            dims = s.split()
            if len(dims) != 3:
                raise MtxFormatError(f"bad size line: {s!r}")
            rows, cols, nnz = (int(d) for d in dims)
            return MtxHeader(rows, cols, nnz, field, symmetry)
    raise MtxFormatError("missing size line")


def read_mtx(path: str, dtype=np.float32, expand_symmetric: bool = True) -> COO:
    """Read a .mtx file → COO with 0-based int32 indices and ``dtype`` values.

    Duplicate entries are kept; the semiring reduction folds them."""
    header = read_mtx_header(path)
    rows, cols, vals = _parse_entries_numpy(path, header)
    vals = vals.astype(dtype, copy=False)

    if header.symmetry in ("symmetric", "skew-symmetric") and expand_symmetric:
        off_diag = rows != cols
        mr, mc, mv = cols[off_diag], rows[off_diag], vals[off_diag]
        if header.symmetry == "skew-symmetric":
            mv = -mv
        rows = np.concatenate([rows, mr])
        cols = np.concatenate([cols, mc])
        vals = np.concatenate([vals, mv])

    return COO(
        rows=rows.astype(np.int32, copy=False),
        cols=cols.astype(np.int32, copy=False),
        vals=vals,
        shape=(header.rows, header.cols),
    )


def _parse_entries_numpy(path: str, header: MtxHeader):
    with open(path, "rb") as f:
        buf = io.BytesIO(f.read())
    # consume banner, comments and the size line
    while True:
        line = buf.readline()
        if not line:
            raise MtxFormatError("missing size line")
        s = line.strip()
        if not s or s.startswith(b"%"):
            continue
        break  # `s` was the size line
    body = buf.read()
    ncols = 2 if header.field == "pattern" else 3
    if body.strip():
        arr = np.loadtxt(io.BytesIO(body), dtype=np.float64, ndmin=2)
    else:
        arr = np.zeros((0, ncols))
    if arr.shape[1] < ncols:
        raise MtxFormatError(
            f"expected {ncols} columns for field {header.field!r}, got {arr.shape[1]}"
        )
    rows = arr[:, 0].astype(np.int64) - 1
    cols = arr[:, 1].astype(np.int64) - 1
    if header.field == "pattern":
        vals = np.ones(len(rows), dtype=np.float64)
    else:
        vals = arr[:, 2]
    if len(rows) != header.nnz:
        raise MtxFormatError(f"expected {header.nnz} entries, found {len(rows)}")
    if len(rows) and (
        rows.min() < 0 or cols.min() < 0
        or rows.max() >= header.rows or cols.max() >= header.cols
    ):
        raise MtxFormatError("entry index out of bounds")
    return rows, cols, vals


def _mirror_key(rows, cols, vals):
    """The entries sorted by (row, col, value as float64): an exact
    multiset key for the symmetry check of write_mtx."""
    order = np.lexsort((np.asarray(vals, np.float64),
                        np.asarray(cols), np.asarray(rows)))
    return (np.asarray(rows)[order], np.asarray(cols)[order],
            np.asarray(vals, np.float64)[order])


def write_mtx(path: str, coo: COO, field: str = "real",
              symmetry: str = "general") -> None:
    """Write a COO as a MatrixMarket coordinate file, the inverse of
    :func:`read_mtx`.

    ``symmetry="symmetric"`` / ``"skew-symmetric"`` stores only the lower
    triangle (row ≥ col; row > col for skew, whose zero diagonal stays
    implicit). The dropped upper triangle must mirror the kept one exactly
    (negated for skew), else ``ValueError``, so read_mtx's expansion gives
    the input back. Values print with enough digits to round-trip: 9
    significant for float32, 17 for wider types."""
    if field not in ("real", "integer", "pattern"):
        raise ValueError(f"unsupported field {field!r}")
    if symmetry not in ("general", "symmetric", "skew-symmetric"):
        raise ValueError(f"unsupported symmetry {symmetry!r}")
    rows = np.asarray(coo.rows)
    cols = np.asarray(coo.cols)
    vals = np.asarray(coo.vals)
    if symmetry != "general":
        if coo.shape[0] != coo.shape[1]:
            raise ValueError(f"{symmetry} requires a square matrix")
        diag = rows == cols
        lower = rows > cols
        upper = rows < cols
        sign = -1.0 if symmetry == "skew-symmetric" else 1.0
        lo = _mirror_key(rows[lower], cols[lower], vals[lower])
        up = _mirror_key(cols[upper], rows[upper], sign * vals[upper])
        if not (lo[0].shape == up[0].shape
                and all(np.array_equal(a, b) for a, b in zip(lo, up))):
            raise ValueError(
                f"matrix is not {symmetry}: upper triangle does not mirror "
                "the lower (write with symmetry='general' instead)")
        if symmetry == "skew-symmetric":
            if np.any(diag & (vals.astype(np.float64) != 0.0)):
                raise ValueError("skew-symmetric matrices have a zero "
                                 "diagonal; found nonzero diagonal entries")
            keep = lower
        else:
            keep = lower | diag
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
    vfmt = "%.9g" if vals.dtype == np.float32 else "%.17g"
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} {symmetry}\n")
        f.write(f"{coo.shape[0]} {coo.shape[1]} {len(vals)}\n")
        if field == "pattern":
            body = np.column_stack([rows + 1, cols + 1])
            np.savetxt(f, body, fmt="%d")
        elif field == "integer":
            body = np.column_stack([rows + 1, cols + 1,
                                    vals.astype(np.int64)])
            np.savetxt(f, body, fmt="%d")
        else:
            body = np.column_stack([(rows + 1).astype(np.float64),
                                    (cols + 1).astype(np.float64),
                                    vals.astype(np.float64)])
            np.savetxt(f, body, fmt=["%d", "%d", vfmt])
