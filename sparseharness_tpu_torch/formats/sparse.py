"""Sparse matrix containers on the host.

- :class:`COO` — the load format: coordinate triples, duplicates allowed;
- :class:`CSR` — indptr/indices/data, the step from COO to ELL;
- :class:`ELL` — rows padded to a common width, rounded up to the
  geometry's row and width multiples.

All containers are plain NumPy. Operands move to a torch device when a
variant builds them (``ops``), outside any timed region.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# default ELL padding multiples, the (8, 128) block shape of the default
# Geometry
SUBLANE = 8
LANE = 128


@dataclasses.dataclass(frozen=True)
class COO:
    """Coordinate triples; duplicates allowed (folded by ⊕ downstream)."""

    rows: np.ndarray  # int32 (nnz,)
    cols: np.ndarray  # int32 (nnz,)
    vals: np.ndarray  # (nnz,)
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(len(self.vals))

    @property
    def dtype(self):
        return self.vals.dtype

    def sorted_by_row(self) -> "COO":
        order = np.lexsort((self.cols, self.rows))
        return COO(self.rows[order], self.cols[order], self.vals[order], self.shape)

    def with_values(self, vals: np.ndarray) -> "COO":
        if len(vals) != self.nnz:
            raise ValueError(f"{len(vals)} values for {self.nnz} entries")
        return COO(self.rows, self.cols, vals, self.shape)

    def to_csr(self) -> "CSR":
        s = self.sorted_by_row()
        indptr = np.zeros(self.shape[0] + 1, dtype=np.int32)
        np.cumsum(np.bincount(s.rows, minlength=self.shape[0]), out=indptr[1:])
        return CSR(indptr=indptr, indices=s.cols, data=s.vals, shape=self.shape)

    def to_ell(self, width_multiple: int = LANE, row_multiple: int = SUBLANE) -> "ELL":
        return self.to_csr().to_ell(width_multiple, row_multiple)


def fold_duplicates(coo: COO, add=None) -> COO:
    """⊕-fold duplicate (row, col) entries into single entries.

    MatrixMarket permits duplicates. The ELL path folds them through its
    reduction; the banded layout's build scatters into dense strips, where a plain
    assignment would overwrite, so it calls this first and every variant
    agrees. ``add`` is a NumPy ufunc (default np.add): the semiring's ⊕
    mirror."""
    if add is None:
        add = np.add
    key = coo.rows.astype(np.int64) * max(coo.shape[1], 1) + coo.cols
    if np.all(key[1:] > key[:-1]):
        # strictly increasing keys (the generators' row-major output) hold
        # no duplicate: skip the sort that np.unique would do
        return coo
    uniq, inverse = np.unique(key, return_inverse=True)
    if len(uniq) == len(key):
        return coo
    first = np.full(len(uniq), len(key), np.int64)
    np.minimum.at(first, inverse, np.arange(len(key), dtype=np.int64))
    rows = coo.rows[first]
    cols = coo.cols[first]
    dt = coo.vals.dtype
    if np.issubdtype(dt, np.bool_):
        vals = np.zeros(len(uniq), dtype=dt)
        np.logical_or.at(vals, inverse, coo.vals)
        return COO(rows, cols, vals, coo.shape)
    if add is np.minimum:
        fill = np.inf if np.issubdtype(dt, np.floating) else np.iinfo(dt).max
    elif add is np.maximum:
        fill = -np.inf if np.issubdtype(dt, np.floating) else np.iinfo(dt).min
    else:
        fill = 0
    vals = np.full(len(uniq), fill, dtype=dt)
    add.at(vals, inverse, coo.vals)
    return COO(rows, cols, vals, coo.shape)


def coo_from_arrays(rows, cols, vals, shape) -> COO:
    return COO(
        np.asarray(rows, dtype=np.int32),
        np.asarray(cols, dtype=np.int32),
        np.asarray(vals),
        (int(shape[0]), int(shape[1])),
    )


@dataclasses.dataclass(frozen=True)
class CSR:
    indptr: np.ndarray  # int32 (rows+1,)
    indices: np.ndarray  # int32 (nnz,) column ids, row-major order
    data: np.ndarray  # (nnz,)
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(len(self.data))

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    def to_ell(self, width_multiple: int = LANE, row_multiple: int = SUBLANE) -> "ELL":
        lengths = self.row_lengths()
        max_len = int(lengths.max()) if len(lengths) else 0
        width = max(round_up(max(max_len, 1), width_multiple), width_multiple)
        n_rows = round_up(max(self.shape[0], 1), row_multiple)
        cols = np.zeros((n_rows, width), dtype=np.int32)
        vals = np.zeros((n_rows, width), dtype=self.data.dtype)
        mask = np.zeros((n_rows, width), dtype=bool)
        r_idx = np.repeat(np.arange(self.shape[0], dtype=np.int64), lengths)
        # position within a row = global position - row start
        pos = np.arange(self.nnz, dtype=np.int64) - np.repeat(
            self.indptr[:-1].astype(np.int64), lengths
        )
        cols[r_idx, pos] = self.indices
        vals[r_idx, pos] = self.data
        mask[r_idx, pos] = True
        return ELL(cols=cols, vals=vals, mask=mask, lengths=lengths,
                   shape=self.shape)


@dataclasses.dataclass(frozen=True)
class ELL:
    """Padded ELLPACK. Arrays are (padded_rows, padded_width)."""

    cols: np.ndarray  # int32, pad → 0
    vals: np.ndarray  # pad → 0 (re-filled per semiring by vals_filled)
    mask: np.ndarray  # bool, True at real entries
    lengths: np.ndarray  # int32 (true_rows,)
    shape: Tuple[int, int]  # logical (rows, cols)

    def vals_filled(self, zero) -> np.ndarray:
        """Values with pad slots set to the semiring ⊕-identity."""
        return np.where(self.mask, self.vals, np.asarray(zero, self.vals.dtype))
