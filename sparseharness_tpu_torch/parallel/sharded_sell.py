"""Sharded SpMV and fixpoints whose local compute is the sell2 kernel.

The JAX package's ``parallel/sharded_sell.py``, for the structures the
band mode refuses (power-law and scattered graphs): the rows are
block-partitioned over the ranks, each rank's block is packed by the
port's ``build_sell2`` (its native encode), and each step's local compute
is ``dp_sell2`` over an all-gathered x (the sell2 kernel on a card).

The exchange is a dense all-gather (O(n) a step): scattered columns
reference the whole vector, so there is no halo window. The frontier path
(``parallel/frontier.py``) is the sparse-step alternative.

Each rank runs the kernel's plan of its own block, as ``build_sell2``
made it. On the CPU ``build_sharded_sell`` also stacks the ranks' panels
as the JAX package does, for the plain version: each rank's layouts are
unioned over the ranks (most panels per slab index, the deepest
butterfly, the OR of the tile flags) and its streams padded with
identity panels, whose index words route every output row to a lane
that no run captures, so padding adds nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from sparseharness_tpu_torch.formats.sparse import COO, round_up
from sparseharness_tpu_torch.ops.sell2 import (
    LANES, Sell2Operand, Sell2Panels, _SlabLayout, build_sell2, dp_sell2,
)
from sparseharness_tpu_torch.parallel import comm, fixcore
from sparseharness_tpu_torch.parallel.fixcore import ShardedFixpointResult
from sparseharness_tpu_torch.parallel.mesh import Mesh
from sparseharness_tpu_torch.semiring import Semiring
from sparseharness_tpu_torch.semiring.core import _carrier
from sparseharness_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedSellOperand:
    """Every rank's sell2 operand, and on the CPU their panels stacked.

    ``ranks[d]``: rank d's block of ``chunk_rows`` rows as build_sell2
    made it. ``panels``: on the CPU, the ranks' panels with leading dim =
    rank: per slab index None (no rank has panels there) or a dict of
    ``chunk`` (size, P, 2), ``wordA``, ``wordB`` and ``vals`` (size, P·128,
    128); the unioned layouts, the same for every rank; ``piece_owner``
    (size, Q) and ``virt_blocks`` (size, n_v, 128), padded with 0 (a padded
    piece holds 0̄, a padded virtual chunk is never read), or None. None on
    a card, whose operands hold no panels."""

    ranks: Tuple[Sell2Operand, ...]
    panels: Optional[Sell2Panels]
    n_cols: int
    chunk_rows: int
    base_pad: int
    n_rows: int


def _identity_words(two_tiles: bool):
    """wordA and wordB of an identity slot, as ops/sell2.py's defaults (the
    cap = 0, identity-route encoding: a1 = a2 = 127, route_hi lane 126)."""
    id_tile = 1 if two_tiles else 0
    wa = 127 | (127 << 7) | (126 << 22) | (id_tile << 29)
    wb = (126 << 7) | (id_tile << 14)
    return wa, wb


def build_sharded_sell(
    coo: COO,
    sr: Semiring,
    n_shards: int,
    value_dtype: str = "float32",
    *,
    device: DeviceLike = None,
) -> Tuple[ShardedSellOperand, int]:
    """Row-block partition, each rank's block packed by build_sell2 on
    ``device``; where the blocks keep their panels (on the CPU), the
    layouts unioned and the streams padded with identity panels. Raises
    NotImplementedError when any block's packing passes the sell2 padding
    guard; callers fall back to the ELL modes. Returns (operand, chunk)."""
    device = resolve_device(device)
    n, c = coo.shape
    chunk = round_up(max(-(-n // n_shards), 1), 1024)
    shard_idx = (coo.rows // chunk).astype(np.int64)
    ops: List[Sell2Operand] = []
    for d in range(n_shards):
        sel = shard_idx == d
        sub = COO((coo.rows[sel] - d * chunk).astype(np.int32), coo.cols[sel],
                  coo.vals[sel], (chunk, c))
        # one layout per slab index: the union below matches slabs by position
        ops.append(build_sell2(sub, sr, value_dtype=value_dtype, split_calls=False,
                               device=device))
    panels = None
    if ops[0].panels is not None:
        panels = _stacked_panels([op.panels for op in ops], _carrier(sr)[4], device)
    return ShardedSellOperand(ranks=tuple(ops), panels=panels, n_cols=c, chunk_rows=chunk,
                              base_pad=ops[0].base_pad, n_rows=n), chunk


def _stacked_panels(ranks: List[Sell2Panels], zero, device: torch.device) -> Sell2Panels:
    """The ranks' panels stacked as the JAX package stacks them."""
    n_shards = len(ranks)
    n_slabs = max(len(p.layouts) for p in ranks)
    layouts: List[_SlabLayout] = []
    for s in range(n_slabs):
        ls = [p.layouts[s] for p in ranks if s < len(p.layouts)]
        rows = max(lay.rows for lay in ls)
        layouts.append(_SlabLayout(
            s * (2 * LANES * LANES), rows, max(lay.panels for lay in ls),
            max(lay.depth for lay in ls), any(lay.two_tiles for lay in ls),
            any(lay.has_hi for lay in ls) or rows > LANES * LANES))

    slabs = []
    for s, lay in enumerate(layouts):
        if lay.panels == 0:
            slabs.append(None)
            continue
        wa_id, wb_id = _identity_words(lay.two_tiles)
        p_s = lay.panels
        store = next(p.slabs[s]["vals"].dtype for p in ranks
                     if s < len(p.layouts) and p.layouts[s].panels)
        out = {"chunk": torch.zeros((n_shards, p_s, 2), dtype=torch.int32, device=device),
               "wordA": torch.full((n_shards, p_s * LANES, LANES), wa_id, dtype=torch.int32,
                                   device=device),
               "wordB": torch.full((n_shards, p_s * LANES, LANES), wb_id, dtype=torch.int32,
                                   device=device),
               "vals": torch.full((n_shards, p_s * LANES, LANES), zero, dtype=store,
                                  device=device)}
        for d, p in enumerate(ranks):
            if s >= len(p.layouts) or p.layouts[s].panels == 0:
                continue
            p_d = p.layouts[s].panels
            out["chunk"][d, :p_d] = p.slabs[s]["chunk"]
            for k in ("wordA", "wordB", "vals"):
                out[k][d, :p_d * LANES] = p.slabs[s][k]
        slabs.append(out)

    def stacked(arrays, width):
        """The per-rank arrays (or None) padded with 0 to one length."""
        longest = max((0 if a is None else a.shape[0]) for a in arrays)
        if not longest:
            return None
        t = torch.zeros((n_shards, longest) + width, dtype=torch.int32, device=device)
        for d, a in enumerate(arrays):
            if a is not None:
                t[d, :a.shape[0]] = a
        return t

    return Sell2Panels(slabs, tuple(layouts), ranks[0].n_chunks,
                       stacked([p.virt_blocks for p in ranks], (LANES,)),
                       stacked([p.piece_owner for p in ranks], ()))


def place_sell_shard(mesh: Mesh, op: ShardedSellOperand) -> Sell2Operand:
    """This rank's operand on its device: its block's plan and, where the
    panels were kept, its slice of the stacked panels (identity padding
    included), which the plain version sweeps."""
    if len(op.ranks) != mesh.size:
        raise ValueError(f"operand of {len(op.ranks)} shards on a mesh of {mesh.size} ranks")
    local = op.ranks[mesh.rank]
    if op.panels is not None:
        p = op.panels

        def mine(t):
            return None if t is None else t[mesh.rank]

        local = dataclasses.replace(local, panels=Sell2Panels(
            [None if s is None else {k: mine(v) for k, v in s.items()} for s in p.slabs],
            p.layouts, p.n_chunks, mine(p.virt_blocks), mine(p.piece_owner)))
    return local.to(mesh.device)


def sell_shard(mesh: Mesh, op: ShardedSellOperand) -> Sell2Operand:
    """:func:`place_sell_shard`, made once per (operand, rank)."""
    return fixcore.cached(op, ("sell_shard", fixcore.mesh_key(mesh)),
                          lambda: place_sell_shard(mesh, op))


def sell_dp_full(local: Sell2Operand, chunk_rows: int, x_full: torch.Tensor,
                 sr: Semiring) -> torch.Tensor:
    """One rank's sell2 dp against a whole x (all-gathered, or the frontier
    path's cache), ⊕-clamped, in the semiring's type."""
    dp = dp_sell2(local, x_full, sr, n_rows=chunk_rows)[:chunk_rows].to(sr.dtype)
    # ⊕-identity clamp (saturates float overflow on padded slots)
    return sr.add(dp, torch.full_like(dp, sr.zero))


def sell_local_dp(mesh: Mesh, op: ShardedSellOperand, sr: Semiring) -> Callable:
    """This rank's step: all-gather x, then the sell2 panel sweep."""
    local, chunk_rows, n_cols = sell_shard(mesh, op), op.chunk_rows, op.n_cols
    return lambda x_local: sell_dp_full(
        local, chunk_rows, comm.all_gather(mesh, x_local)[:n_cols], sr)


def sharded_spmv_sell(mesh: Mesh, op: ShardedSellOperand, x, sr: Semiring,
                      n_rows: int) -> torch.Tensor:
    """One y = A ⊗ x with the sell2 kernel as each rank's local compute."""
    x_pad = fixcore.pad_rows(x, mesh.size * op.chunk_rows, sr.zero, sr.dtype, mesh.device)
    solver = fixcore.make_spmv_solver(mesh, op, sell_local_dp(mesh, op, sr),
                                      key=(sr.name,))
    dp = solver(fixcore.local_rows(mesh, x_pad, op.chunk_rows))
    return comm.all_gather(mesh, dp)[:n_rows]


def sharded_fixpoint_sell(
    mesh: Mesh,
    op: ShardedSellOperand,
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
    """The whole fixpoint with sell2 local compute over an all-gathered x
    each step; the result contract of ``sharded.sharded_fixpoint``."""
    solver = fixcore.make_fixpoint_solver(
        mesh, op, sell_local_dp(mesh, op, sr), combine=combine, exact=exact, delta=delta,
        max_iter=max_iter, norm=norm, with_aux=aux_update is not None,
        aux_update=aux_update, key=(sr.name,))
    return fixcore.run_solver(mesh, solver, x0, sr, chunk=op.chunk_rows, n_rows=n_rows,
                              aux0=aux0 if aux_update is not None else None)
