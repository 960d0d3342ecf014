"""Sparse matrix containers on the host.

- :class:`COO` — the load format: coordinate triples, duplicates allowed;
- :class:`CSR` — indptr/indices/data, the step from COO to ELL;
- :class:`ELL` — rows padded to a common width, rounded up to the
  geometry's row and width multiples;
- :class:`BSR` — the nonzero (bm, bn) tiles, stored densely.

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


@dataclasses.dataclass(frozen=True)
class BSR:
    """Block-sparse rows: only nonzero (bm, bn) tiles are stored, densely.

    ``tiles[t]`` is the dense tile at block-row ``tile_rows[t]`` / block-col
    ``tile_cols[t]``; tiles are sorted by (row, col). ``block_ptr`` is the
    CSR-style indptr over block rows. Pad slots inside a tile hold
    ``fill_zero`` (a semiring ⊕-identity chosen at construction).
    """

    tiles: np.ndarray  # (ntiles, bm, bn)
    tile_rows: np.ndarray  # int32 (ntiles,)
    tile_cols: np.ndarray  # int32 (ntiles,)
    block_ptr: np.ndarray  # int32 (nblockrows+1,)
    shape: Tuple[int, int]  # logical
    fill_zero: float

    @property
    def bm(self) -> int:
        return self.tiles.shape[1]

    @property
    def bn(self) -> int:
        return self.tiles.shape[2]

    @property
    def ntiles(self) -> int:
        return int(self.tiles.shape[0])

    @property
    def padded_shape(self) -> Tuple[int, int]:
        return (round_up(self.shape[0], self.bm), round_up(self.shape[1], self.bn))


def bsr_tile_key_base(n_cols: int, bn: int) -> int:
    """The multiplier of the block-row in a tile key, row·base + col: one
    more than the block-column count, as the JAX package keys its tiles."""
    return round_up(max(n_cols, 1), bn) // bn + 1


def bsr_from_coo(coo: COO, bm: int, bn: int, zero=0.0) -> BSR:
    """The BSR of a duplicate-free COO; an empty matrix gets one tile of
    ``zero`` at block (0, 0)."""
    n_rows_p = round_up(max(coo.shape[0], 1), bm)
    n_block_rows = n_rows_p // bm
    base = bsr_tile_key_base(coo.shape[1], bn)
    tile_key = (coo.rows // bm).astype(np.int64) * base + coo.cols // bn
    uniq, inverse = np.unique(tile_key, return_inverse=True)
    ntiles = len(uniq)
    tile_rows = (uniq // base).astype(np.int32)
    tile_cols = (uniq % base).astype(np.int32)
    tiles = np.full((max(ntiles, 1), bm, bn), zero, dtype=coo.vals.dtype)
    if ntiles:
        tiles[inverse, coo.rows % bm, coo.cols % bn] = coo.vals
    else:
        tile_rows = np.zeros(1, dtype=np.int32)
        tile_cols = np.zeros(1, dtype=np.int32)
    block_ptr = np.zeros(n_block_rows + 1, dtype=np.int32)
    np.cumsum(np.bincount(tile_rows, minlength=n_block_rows), out=block_ptr[1:])
    return BSR(
        tiles=tiles, tile_rows=tile_rows, tile_cols=tile_cols,
        block_ptr=block_ptr, shape=coo.shape,
        fill_zero=float(zero) if np.issubdtype(coo.vals.dtype, np.floating) else zero,
    )
