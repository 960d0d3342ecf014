"""The ``bsr_pallas`` variant (gen-1 BSR), and the tile layout that every
blocked variant builds on.

Gen-1 stores the nonzero (bm, bn) tiles densely, sorted by (block-row,
block-col), in S slabs of ``rows_per_slab`` block-rows and ``slab_tiles``
tiles each. Every block-row has at least one tile (a pad tile at block-col
0 where it has none), and each slab's tile count is padded to a multiple of
8 with pad tiles that target the slab's last row. The slabs exist for the
TPU's scalar-prefetch memory (``DEFAULT_TILES_PER_SLAB``); the port keeps
them, so that its arrays equal the JAX package's, and reads them flat.

On a CUDA tensor :func:`dp_bsr` launches the tile kernel of
``csrc/bsr_tiles.cu``: a warp per row walks the row's run of tiles,
``seg[s, r]`` to ``seg[s, r + 1]``, which the build derives once from the
slab-local ``tile_rows``. On a CPU tensor it runs :func:`dp_bsr_plain`.

:func:`device_tiles` finds the tiles of a matrix on the target device: the
duplicate check, the tile keys and the per-entry positions run in torch
there, and the arrays the blocked build functions make from them equal
the JAX package's, which does the same work in NumPy on the host.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from sparseharness_tpu_torch.formats.sparse import (
    COO, bsr_tile_key_base, fold_duplicates, round_up,
)
from sparseharness_tpu_torch.ops import _build
from sparseharness_tpu_torch.semiring import Semiring
from sparseharness_tpu_torch.semiring.core import _carrier, _np_fold_for
from sparseharness_tpu_torch.utils.device import DeviceLike, resolve_device

#: tiles per slab: the TPU kernel's scalar-prefetch cap, kept so that the
#: slabs (and with them the arrays) equal the JAX package's
DEFAULT_TILES_PER_SLAB = 1024

#: torch scatter reductions by the carrier's ⊕-reduce
_SCATTER = {torch.sum: "sum", torch.amin: "amin", torch.amax: "amax"}


@dataclasses.dataclass(frozen=True)
class DeviceTiles:
    """A duplicate-free matrix's nonzero (bm, bn) tiles on a device.

    Tiles are sorted by (block-row, block-col), as ``bsr_from_coo`` sorts
    them; an empty matrix has one tile at block (0, 0). Each entry has its
    tile, its row and column, and its value in the carrier type. ``pad`` is
    the value of an empty tile slot as the JAX package stores it: the
    semiring zero in the matrix's value type, cast to the carrier."""

    tile_rows: torch.Tensor   # int64 (ntiles,)
    tile_cols: torch.Tensor   # int64 (ntiles,)
    entry_tile: torch.Tensor  # int64 (nnz,)
    rows: torch.Tensor        # int64 (nnz,)
    cols: torch.Tensor        # int64 (nnz,)
    vals: torch.Tensor        # (nnz,) carrier dtype
    pad: object
    n_block_rows: int

    @property
    def nnz(self) -> int:
        return int(self.vals.numel())

    @property
    def ntiles(self) -> int:
        return int(self.tile_rows.numel())


def fold_on_device(coo: COO, add, device: torch.device) -> COO:
    """``coo`` itself when a check on ``device`` finds no duplicate entry,
    else :func:`fold_duplicates` with ``add`` on the host. The check is one
    sort on the device; the host fold sorts in NumPy, which takes seconds
    at tens of millions of entries, so it runs only where it changes
    something."""
    if coo.nnz < 2:
        return coo
    key = (torch.from_numpy(coo.rows).to(device=device, dtype=torch.int64)
           * max(coo.shape[1], 1)
           + torch.from_numpy(coo.cols).to(device=device, dtype=torch.int64))
    if torch.unique(key).numel() == coo.nnz:
        return coo
    return fold_duplicates(coo, add)


def device_tiles(coo: COO, sr: Semiring, bm: int, bn: int,
                 device: torch.device) -> DeviceTiles:
    """The tiles of ``coo`` under ``sr``'s carrier, found on ``device``.

    or_and's values become {0, 1} in int32. Duplicates are ⊕-folded on the
    host, in the JAX package's order, only when the check on the
    device finds some. The value cast to the carrier runs in NumPy, as the
    JAX package's does (float matrix values under an int32 semiring
    truncate, and min_right's INT_MAX pad overflows through float32 as it
    does there)."""
    carrier, _, _, _, zero, as_int = _carrier(sr)
    vals = (coo.vals != 0).astype(np.int32) if as_int else coo.vals
    coo = fold_on_device(COO(coo.rows, coo.cols, np.asarray(vals), coo.shape),
                         _np_fold_for(sr, as_int), device)
    n, c = coo.shape
    rows = torch.from_numpy(coo.rows).to(device=device, dtype=torch.int64)
    cols = torch.from_numpy(coo.cols).to(device=device, dtype=torch.int64)
    carrier_np = np.dtype(np.int32) if carrier == torch.int32 else np.dtype(np.float32)
    with np.errstate(invalid="ignore"):
        cast = np.ascontiguousarray(coo.vals.astype(carrier_np))
        pad = np.full(1, zero, dtype=coo.vals.dtype).astype(carrier_np)[0].item()
    base = bsr_tile_key_base(c, bn)
    if coo.nnz:
        uniq, entry_tile = torch.unique((rows // bm) * base + cols // bn,
                                        sorted=True, return_inverse=True)
    else:
        uniq = torch.zeros(1, dtype=torch.int64, device=device)
        entry_tile = torch.zeros(0, dtype=torch.int64, device=device)
    return DeviceTiles(
        tile_rows=uniq // base, tile_cols=uniq % base, entry_tile=entry_tile,
        rows=rows, cols=cols, vals=torch.from_numpy(cast).to(device), pad=pad,
        n_block_rows=round_up(max(n, 1), bm) // bm,
    )


#: bytes of the ⊗ products that a plain SpMM version holds at once
PLAIN_CHUNK_BYTES = 1 << 30


def pad_x_block(x_block: torch.Tensor, bn: int, sr: Semiring,
                min_rows: int = 0) -> torch.Tensor:
    """X (n_cols, m) padded with 0̄ to whole bn-blocks of rows (at least
    ``min_rows``), row-major, in the carrier type (bool → int32); the
    columns are not padded. X itself when it is that already."""
    n, m = x_block.shape
    carrier, *_ = _carrier(sr)
    c_pad = max(round_up(max(n, 1), bn), min_rows)
    if c_pad == n and x_block.dtype == carrier and x_block.is_contiguous():
        return x_block
    x_pad = torch.full((c_pad, m), sr.zero, dtype=sr.dtype, device=x_block.device)
    x_pad[:n] = x_block.to(sr.dtype)
    return x_pad.to(carrier)


def pad_x2d(x: torch.Tensor, bn: int, sr: Semiring) -> torch.Tensor:
    """x padded with 0̄ to a whole number of bn-blocks, as (c_blocks, bn) in
    the carrier type (bool → int32)."""
    c_pad = round_up(max(x.shape[0], 1), bn)
    x_pad = torch.full((c_pad,), sr.zero, dtype=sr.dtype, device=x.device)
    x_pad[: x.shape[0]] = x.to(sr.dtype)
    carrier, *_ = _carrier(sr)
    return x_pad.view(c_pad // bn, bn).to(carrier)


class BsrOperand(NamedTuple):
    """Slab s owns block-rows [s·rps, (s+1)·rps), rps = ceil(n_block_rows /
    S); tile_rows are slab-local, sorted, and row_start is 1 at the first
    tile of each block-row. ``seg`` (not in the JAX operand) holds each
    local row's first tile, seg[s, r], with seg[s, rps] closing the last."""

    tiles: torch.Tensor      # (S, T, bm, bn) carrier dtype; pads = the pad value
    tile_rows: torch.Tensor  # int32 (S, T)
    tile_cols: torch.Tensor  # int32 (S, T) global block-col; pads = 0
    row_start: torch.Tensor  # int32 (S, T)
    seg: torch.Tensor        # int32 (S, rps + 1)


def segments(tile_rows: torch.Tensor, rows_per_slab: int) -> torch.Tensor:
    """seg[s, r]: the first tile of slab s whose local row is ≥ r, for
    r ≤ rows_per_slab (int32, (S, rps + 1)). With sorted rows a row's run
    of tiles is [seg[s, r], seg[s, r + 1])."""
    s = tile_rows.shape[0]
    want = torch.arange(rows_per_slab + 1, dtype=tile_rows.dtype,
                        device=tile_rows.device).expand(s, -1).contiguous()
    return torch.searchsorted(tile_rows.contiguous(), want, out_int32=True)


def _rows_per_slab(counts: np.ndarray, tiles_per_slab: int) -> int:
    """The JAX package's slab partition: the most consecutive block-rows
    whose tiles fit ``max(tiles_per_slab, most tiles of a row)``, then
    evened to the fixpoint rps = ceil(nbr / S), S = ceil(nbr / rps), so
    that dp_bsr can re-derive rps from the slab count."""
    n_block_rows = len(counts)
    t_slab = max(tiles_per_slab, int(counts.max()))
    cum = np.concatenate([[0], np.cumsum(counts)])
    rows_per_slab = n_block_rows
    if cum[-1] > t_slab:
        rows_per_slab = 1
        lo, hi = 1, n_block_rows
        while lo <= hi:
            mid = (lo + hi) // 2
            if (cum[mid:] - cum[:-mid]).max() <= t_slab:
                rows_per_slab = mid
                lo = mid + 1
            else:
                hi = mid - 1
    n_slabs = -(-n_block_rows // rows_per_slab)
    while True:
        rows_per_slab = -(-n_block_rows // n_slabs)
        s2 = -(-n_block_rows // rows_per_slab)
        if s2 == n_slabs:
            return rows_per_slab
        n_slabs = s2


def build_bsr(coo: COO, sr: Semiring, bm: int = 8, bn: int = 128,
              tiles_per_slab: int = DEFAULT_TILES_PER_SLAB, *,
              device: DeviceLike = None) -> BsrOperand:
    """Gen-1 tiles in slabs. Tiles stay in the carrier type: the variant
    takes no value_dtype, as in the JAX package. The per-entry scatter runs
    on the target device; the tile-level index arrays on the host."""
    device = resolve_device(device)
    t = device_tiles(coo, sr, bm, bn, device)
    if t.nnz and t.ntiles * bm * bn * 4 > max(32 * t.nnz * 8, 1 << 30):
        # refuse pathological scatter (≈1 nnz per dense tile) before any
        # large allocation
        raise NotImplementedError(
            f"BSR tile blowup: {t.ntiles * bm * bn * 4 / 1e9:.1f} GB of tiles "
            f"for {t.nnz} nonzeros; use ell/coo_seg or reorder ('rcm')")
    nbr = t.n_block_rows
    real_rows = t.tile_rows.cpu().numpy()
    real_cols = t.tile_cols.cpu().numpy().astype(np.int32)
    counts_real = np.bincount(real_rows, minlength=nbr)
    # every block-row gets ≥ 1 tile: a pad tile at block-col 0 where it has
    # none, in its row's place of the (row, col) order
    counts = np.maximum(counts_real, 1)
    cum = np.concatenate([[0], np.cumsum(counts)])
    first_real = np.concatenate([[0], np.cumsum(counts_real)])[:-1]
    merged = cum[real_rows] + np.arange(len(real_rows)) - first_real[real_rows]
    m_rows = np.repeat(np.arange(nbr), counts)
    m_cols = np.zeros(cum[-1], np.int32)
    m_cols[merged] = real_cols

    rps = _rows_per_slab(counts, tiles_per_slab)
    n_slabs = -(-nbr // rps)
    bounds = np.minimum(np.arange(n_slabs + 1) * rps, nbr)
    per_slab = cum[bounds[1:]] - cum[bounds[:-1]]
    slab_tiles = round_up(max(int(per_slab.max()), 1), 8)

    slab = m_rows // rps
    pos = np.arange(cum[-1]) - cum[slab * rps]
    local = (m_rows - slab * rps).astype(np.int32)
    s_rows = np.zeros((n_slabs, slab_tiles), np.int32)
    s_cols = np.zeros((n_slabs, slab_tiles), np.int32)
    s_start = np.zeros((n_slabs, slab_tiles), np.int32)
    s_rows[slab, pos] = local
    s_cols[slab, pos] = m_cols
    s_start[slab, pos] = (np.arange(cum[-1]) == cum[m_rows]).astype(np.int32)
    # padding tiles accumulate the pad's products into the last real row
    # (start = 0, no re-zeroing); an empty slab targets local row 0
    last = np.where(per_slab > 0, bounds[1:] - bounds[:-1] - 1, 0)
    is_pad = np.arange(slab_tiles)[None, :] >= per_slab[:, None]
    s_rows = np.where(is_pad, last[:, None], s_rows).astype(np.int32)
    s_start[per_slab == 0, 0] = 1

    carrier = t.vals.dtype
    tiles = torch.full((n_slabs * slab_tiles * bm * bn,), t.pad, dtype=carrier,
                       device=device)
    flat_tile = torch.from_numpy(slab * slab_tiles + pos).to(device)
    e_tile = flat_tile[torch.from_numpy(merged).to(device)][t.entry_tile]
    tiles[(e_tile * bm + t.rows % bm) * bn + t.cols % bn] = t.vals
    tile_rows = torch.from_numpy(s_rows).to(device)
    return BsrOperand(
        tiles=tiles.view(n_slabs, slab_tiles, bm, bn),
        tile_rows=tile_rows,
        tile_cols=torch.from_numpy(s_cols).to(device),
        row_start=torch.from_numpy(s_start).to(device),
        seg=segments(tile_rows, rps),
    )


def _rows_per_slab_for(op: BsrOperand, n_rows: int) -> int:
    """rps re-derived from n_rows as the JAX dp does; it must match seg."""
    n_slabs, _, bm, _ = op.tiles.shape
    rps = -(-(round_up(max(n_rows, 1), bm) // bm) // n_slabs)
    if op.seg.shape != (n_slabs, rps + 1):
        raise ValueError(f"seg {tuple(op.seg.shape)} does not fit {n_slabs} "
                         f"slabs of {rps} block-rows (n_rows={n_rows})")
    return rps


def dp_bsr(op: BsrOperand, x: torch.Tensor, sr: Semiring, *,
           n_rows: int) -> torch.Tensor:
    """⊕-reduced row dot-products over the padded row space
    (S·rps·bm ≥ n_rows); callers slice. On a CUDA tensor this launches the
    kernel; on a CPU tensor it runs the plain version."""
    if op.tiles.device.type == "cpu":
        return dp_bsr_plain(op, x, sr, n_rows=n_rows)
    _rows_per_slab_for(op, n_rows)
    x2d = pad_x2d(x, op.tiles.shape[3], sr)
    dp = tile_dp_cuda(op.tiles, x2d, op.tile_cols, op.seg, sr)
    return dp > 0 if sr.dtype == torch.bool else dp


def dp_bsr_plain(op: BsrOperand, x: torch.Tensor, sr: Semiring, *,
                 n_rows: int) -> torch.Tensor:
    """The plain torch version of :func:`dp_bsr`, on any device."""
    _rows_per_slab_for(op, n_rows)
    x2d = pad_x2d(x, op.tiles.shape[3], sr)
    dp = tile_dp_plain(op.tiles, x2d, op.tile_cols, op.seg, sr)
    return dp > 0 if sr.dtype == torch.bool else dp


def tile_dp_plain(tiles: torch.Tensor, x2d: torch.Tensor, cols: torch.Tensor,
                  seg: torch.Tensor, sr: Semiring) -> torch.Tensor:
    """Carrier-typed padded dp: each tile's rows ⊕-reduced against its x
    block, then ⊕-accumulated in tile order into its segment's row, which
    starts at 0̄. A row with an empty segment stays 0̄."""
    n_slabs, slab_tiles, bm, _ = tiles.shape
    rps = seg.shape[1] - 1
    _, _, mul, reduce_, zero, _ = _carrier(sr)
    t = tiles.float() if tiles.dtype == torch.bfloat16 else tiles
    xb = x2d[cols.long()]                                    # (S, T, bn)
    contrib = reduce_(mul(xb[:, :, None, :], t), dim=-1)     # (S, T, bm)
    pos = torch.arange(slab_tiles, dtype=seg.dtype, device=seg.device)
    row_of = torch.searchsorted(seg, pos.expand(n_slabs, -1).contiguous(),
                                right=True) - 1
    # a tile outside every segment lands in a spare row that is dropped
    row_of = torch.where((row_of >= 0) & (row_of < rps), row_of, rps)
    out = torch.full((n_slabs, rps + 1, bm), zero, dtype=contrib.dtype,
                     device=contrib.device)
    out.scatter_reduce_(1, row_of[..., None].expand(-1, -1, bm), contrib,
                        _SCATTER[reduce_], include_self=True)
    return out[:, :rps].reshape(-1)


def tile_dp_cuda(tiles: torch.Tensor, x2d: torch.Tensor, cols: torch.Tensor,
                 seg: torch.Tensor, sr: Semiring) -> torch.Tensor:
    """Launch the gen-1 tile kernel: the carrier-typed padded dp
    (S·rps·bm,). Raises on what the kernel does not take and on a refused
    launch."""
    if tiles.device.type != "cuda" or any(
            t.device != tiles.device for t in (x2d, cols, seg)):
        raise ValueError("tile_dp_cuda needs tiles, x, cols and seg on one "
                         "CUDA device")
    carrier, *_ = _carrier(sr)
    if tiles.dim() != 4 or x2d.dim() != 2:
        raise ValueError("tiles must be (S, T, bm, bn) and x (c_blocks, bn)")
    n_slabs, slab_tiles, bm, bn = tiles.shape
    if bn % 4 or x2d.shape[1] != bn or x2d.dtype != carrier:
        raise ValueError(f"x must be (c_blocks, {bn}) {carrier} with bn % 4 == 0, "
                         f"got {tuple(x2d.shape)} {x2d.dtype}")
    if cols.shape != (n_slabs, slab_tiles) or cols.dtype != torch.int32:
        raise ValueError(f"cols must be int32 {(n_slabs, slab_tiles)}")
    if seg.dim() != 2 or seg.shape[0] != n_slabs or seg.dtype != torch.int32:
        raise ValueError(f"seg must be int32 ({n_slabs}, rps + 1)")
    _check_strip_dtype(tiles, sr)
    _check_layout(tiles, x2d, cols, seg)
    rps = seg.shape[1] - 1
    out = torch.empty(n_slabs * rps * bm, dtype=carrier, device=tiles.device)
    fn = _build.function("bsr_tiles", "sh_tile_dp",
                         [ctypes.c_int] + [ctypes.c_void_p] * 5
                         + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    _build.check_launch("bsr_tiles", fn(
        tiles.device.index, tiles.data_ptr(), x2d.data_ptr(), cols.data_ptr(),
        seg.data_ptr(), out.data_ptr(), n_slabs, slab_tiles, rps, bm, bn,
        _build.SR_CODES[sr.name], _build.STRIP_CODES[tiles.dtype],
        torch.cuda.current_stream(tiles.device).cuda_stream,
    ))
    _build.LAUNCHES["bsr_pallas"] += 1
    return out


def _check_strip_dtype(strips: torch.Tensor, sr: Semiring) -> None:
    """The float semirings take f32 or bf16 strips, the int32 carriers
    int32 strips, as csrc/semiring.cuh:dispatch does."""
    carrier, *_ = _carrier(sr)
    ok = ((torch.float32, torch.bfloat16) if carrier == torch.float32
          else (torch.int32,))
    if strips.dtype not in ok:
        raise ValueError(f"{sr.name} takes strips of {ok}, got {strips.dtype}")


def _check_layout(*tensors: torch.Tensor) -> None:
    """Contiguous, and 16-byte aligned for the kernels' vector loads."""
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")
