"""Sharded batched (multi-source) fixpoints whose local compute is the
tile SpMM kernel (``ops/spmm_tiles.py:spmm_bsr_ell``).

The JAX package's ``parallel/sharded_spmm.py``: the rows are
block-partitioned over the ranks, each rank's block takes the bsr_ell
strip layout, and each step's local compute is the strip SpMM (the
``spmm_tiles`` kernel on a card) over the all-gathered (chunk, m) X block.
This is the ``tiles`` mode of ``--roots --mesh``.

The ranks' strips have one K (the most tiles a block-row has on any
rank): shorter strips are padded with identity tiles at block column 0,
whose 0̄ values annihilate whatever x block they read, as in-strip
padding does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from sparseharness_tpu_torch.formats.sparse import COO, round_up
from sparseharness_tpu_torch.ops.bsr_ell import BsrEllOperand, build_bsr_ell
from sparseharness_tpu_torch.ops.spmm_tiles import spmm_bsr_ell
from sparseharness_tpu_torch.parallel import comm, fixcore
from sparseharness_tpu_torch.parallel.fixcore import ShardedFixpointResult
from sparseharness_tpu_torch.parallel.mesh import Mesh
from sparseharness_tpu_torch.semiring import Semiring
from sparseharness_tpu_torch.semiring.core import _carrier
from sparseharness_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedSpmmTiles:
    """Every rank's strip operand, leading dim = rank: tiles (size,
    R_blocks, bm, K·bn) and tile_cols (size, R_blocks, K), K unioned over
    the ranks (identity-padded)."""

    tiles: torch.Tensor
    tile_cols: torch.Tensor
    chunk_rows: int
    n_cols: int


def build_sharded_spmm_tiles(coo: COO, sr: Semiring, n_shards: int, *,
                             device: DeviceLike = None) -> ShardedSpmmTiles:
    """Row-block partition and each block's strip build, K unioned, on
    ``device``. Raises NotImplementedError when a block's strip layout
    blows up (scattered structure); callers fall back to the halo and
    gather ELL modes, as the single-device AUTO_CHAIN does."""
    device = resolve_device(device)
    n, c = coo.shape
    bm, bn = 8, 128
    chunk = round_up(max(n, 1), n_shards * bm) // n_shards
    order = np.argsort(coo.rows, kind="stable")
    rows_s, cols_s, vals_s = coo.rows[order], coo.cols[order], coo.vals[order]
    bounds = np.searchsorted(rows_s, np.arange(n_shards + 1) * chunk)
    shard_ops = []
    for s in range(n_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        if lo == hi:
            shard_ops.append(None)
            continue
        local = COO((rows_s[lo:hi] - s * chunk).astype(np.int32), cols_s[lo:hi],
                    vals_s[lo:hi], (chunk, c))
        shard_ops.append(build_bsr_ell(local, sr, bm=bm, bn=bn, device=device))  # may raise
    built = [op for op in shard_ops if op is not None]
    k_max = max([1] + [op.tile_cols.shape[1] for op in built])
    # build_bsr_ell pads each block's rows to its row groups: union that too
    r_blocks = max([chunk // bm] + [op.tiles.shape[0] for op in built])
    _, _, _, _, zero, as_int = _carrier(sr)
    tiles = torch.full((n_shards, r_blocks, bm, k_max * bn), zero,
                       dtype=torch.int32 if as_int else sr.dtype, device=device)
    tcols = torch.zeros((n_shards, r_blocks, k_max), dtype=torch.int32, device=device)
    for s, op in enumerate(shard_ops):
        if op is None:
            continue
        rb, _, kbn = op.tiles.shape
        tiles[s, :rb, :, :kbn] = op.tiles
        tcols[s, :rb, :op.tile_cols.shape[1]] = op.tile_cols
    return ShardedSpmmTiles(tiles=tiles, tile_cols=tcols, chunk_rows=chunk, n_cols=c)


def place_spmm_shard(mesh: Mesh, op: ShardedSpmmTiles) -> BsrEllOperand:
    """This rank's strips as a bsr_ell operand on its device."""
    if op.tiles.shape[0] != mesh.size:
        raise ValueError(f"operand of {op.tiles.shape[0]} shards on a mesh of "
                         f"{mesh.size} ranks")
    # a view of the tiles (whole 16-byte rows); a copy of the column ids,
    # which at rank > 0 may start off the 16 bytes the kernel's loads need
    return BsrEllOperand(tiles=op.tiles[mesh.rank].to(mesh.device),
                         tile_cols=op.tile_cols[mesh.rank].to(mesh.device).clone())


def spmm_local_dp(mesh: Mesh, op: ShardedSpmmTiles, sr: Semiring) -> Callable:
    """This rank's step: all-gather the (chunk, m) X block, then the strip
    tile SpMM over the rank's rows."""
    local = fixcore.cached(op, ("spmm_shard", fixcore.mesh_key(mesh)),
                           lambda: place_spmm_shard(mesh, op))
    chunk_rows, n_cols = op.chunk_rows, op.n_cols
    return lambda x_local: spmm_bsr_ell(local, comm.all_gather(mesh, x_local)[:n_cols], sr,
                                        n_rows=chunk_rows)


def sharded_fixpoint_spmm_tiles(
    mesh: Mesh,
    op: ShardedSpmmTiles,
    x0,
    sr: Semiring,
    *,
    n_rows: int,
    combine: Callable,
    exact: bool = True,
    delta: float = 0.0,
    max_iter: int = 10_000,
    norm: bool = False,
    aux0=None,
    aux_update: Optional[Callable] = None,
) -> ShardedFixpointResult:
    """The whole batched fixpoint (x0 (n, m)) with tile SpMM local
    compute; the result contract of ``sharded.sharded_fixpoint``."""
    solver = fixcore.make_fixpoint_solver(
        mesh, op, spmm_local_dp(mesh, op, sr), combine=combine, exact=exact, delta=delta,
        max_iter=max_iter, norm=norm, with_aux=aux_update is not None,
        aux_update=aux_update, key=(sr.name,))
    return fixcore.run_solver(mesh, solver, x0, sr, chunk=op.chunk_rows, n_rows=n_rows,
                              aux0=aux0 if aux_update is not None else None)
