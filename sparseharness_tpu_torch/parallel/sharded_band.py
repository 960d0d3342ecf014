"""Sharded SpMV and fixpoints whose local compute is the band kernel.

The JAX package's ``parallel/sharded_band.py``: the matrix's rows are
block-partitioned over the ranks, and each rank's block is encoded as a
*window-local* ``bsr_band`` strip array over its x window
[rank·chunk − halo, (rank + 1)·chunk + halo), so each step's local compute
is the port's band kernel (``ops/bsr_band.py:dp_bsr_band``, which picks
the staged or the streamed path as on one card).

The overlap: each rank's block-row groups are split at build time into a
contiguous *interior* range, whose x window lies inside the rank's own
x block, and the *head* and *tail* groups that reach into the halo. A step
issues the two ring edge exchanges first, launches the interior on the
current stream (it reads only the rank's own x), then waits for the edges
and launches head and tail against the whole window. Each of the three
parts is an operand of its own, with its own span table
(``ops/bsr_band.py:with_spans``), since the kernel takes a table only with
the strips it was made from. A part of no groups (``g_lo == 0``, or
``g_hi == ng``) makes no launch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from sparseharness_tpu_torch.formats.sparse import COO, round_up
from sparseharness_tpu_torch.ops.bsr import fold_on_device
from sparseharness_tpu_torch.ops.bsr_band import (
    MAX_WINDOW_BLOCKS, BsrBandOperand, band_spans, dp_bsr_band,
)
from sparseharness_tpu_torch.parallel import comm, fixcore
from sparseharness_tpu_torch.parallel.fixcore import ShardedFixpointResult
from sparseharness_tpu_torch.parallel.mesh import Mesh
from sparseharness_tpu_torch.semiring import Semiring
from sparseharness_tpu_torch.semiring.core import _carrier, _np_fold_for
from sparseharness_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedBandOperand:
    """Every rank's window-local band strips, leading dim = rank.

    The strips are split at build time into the overlap split's three
    ranges: head groups [0, g_lo), interior groups [g_lo, g_hi), tail
    groups [g_hi, ng), each (size, groups·gs, bm, K·bn) with gs = bn/bm
    block-rows a group. Lane slot k of group g holds the x block at
    window-local block index base(g) + k, base(g) = clamp(g + c0, 0,
    wblocks − K). ``windowed`` is the kernel path of every part (None: the
    rule of ``dp_bsr_band``; True streamed; False staged)."""

    strips_head: torch.Tensor
    strips_int: torch.Tensor
    strips_tail: torch.Tensor
    c0: int        # window offset (window-local block units)
    k_win: int     # window width in x blocks
    halo: int      # halo rows each side (multiple of bn)
    chunk: int     # rows per rank (multiple of bn)
    bn: int
    g_lo: int      # first interior group
    g_hi: int      # one past the last interior group
    windowed: Optional[bool] = None

    @property
    def n_shards(self) -> int:
        return int(self.strips_int.shape[0])


def band_arrays(op: ShardedBandOperand) -> dict:
    """The operand's non-empty parts, by name."""
    parts = {"head": op.strips_head, "interior": op.strips_int, "tail": op.strips_tail}
    return {k: v for k, v in parts.items() if v.shape[1]}


def without_overlap_split(op: ShardedBandOperand) -> ShardedBandOperand:
    """The same operand with the overlap split turned off: every group is a
    tail group (g_lo = g_hi = 0), so each step makes one full-window launch
    that waits for both edges. The foil for measuring what the split
    buys."""
    all_strips = torch.cat(list(band_arrays(op).values()), dim=1)
    empty = all_strips[:, :0]
    return dataclasses.replace(op, strips_head=empty, strips_int=empty,
                               strips_tail=all_strips, g_lo=0, g_hi=0)


def build_sharded_band(
    coo: COO,
    sr: Semiring,
    n_shards: int,
    bm: int = 8,
    bn: int = 128,
    value_dtype: str = "float32",
    max_window: int = MAX_WINDOW_BLOCKS,
    *,
    device: DeviceLike = None,
) -> Tuple[ShardedBandOperand, int]:
    """Row-block partition with a window-local affine band structure, the
    JAX package's arrays, built with torch on ``device``.

    Rank d owns rows [d·chunk, (d + 1)·chunk) and the x window
    [d·chunk − halo, (d + 1)·chunk + halo). Raises NotImplementedError when
    the matrix is not banded enough for a neighbour-only window (halo >
    chunk, or a window wider than ``max_window`` blocks); callers fall back
    to the ELL halo and gather modes. Returns (operand, chunk)."""
    device = resolve_device(device)
    if bn % bm != 0:
        raise NotImplementedError("sharded band requires bn % bm == 0")
    n = coo.shape[0]
    _, _, _, _, zero, as_int = _carrier(sr)
    coo = fold_on_device(coo, _np_fold_for(sr, as_int), device)
    # chunk a multiple of bn: x_local is whole bn-blocks and each group
    # (bn rows) lines up with one x block
    chunk = round_up(max(-(-n // n_shards), 1), bn)

    rows = torch.from_numpy(coo.rows).to(device=device, dtype=torch.int64)
    cols = torch.from_numpy(coo.cols).to(device=device, dtype=torch.int64)
    shard_idx = rows // chunk
    starts = shard_idx * chunk
    reach_left = int((starts - cols).clamp(min=0).max()) if coo.nnz else 0
    reach_right = int((cols - (starts + chunk - 1)).clamp(min=0).max()) if coo.nnz else 0
    halo = round_up(max(reach_left, reach_right, 1), bn)
    if halo > chunk:
        raise NotImplementedError(
            f"halo {halo} exceeds chunk {chunk}: matrix is not banded enough "
            "for neighbour-only exchange")

    wblocks = (chunk + 2 * halo) // bn
    ng = chunk // bn                  # groups per rank
    gs = bn // bm                     # block-rows per group
    local_row = rows - starts
    wcol = cols - starts + halo       # ≥ 0
    bc = wcol // bn                   # window-local x block
    # one (c0, K) for every rank, over (rank, group) jointly
    key = shard_idx * ng + local_row // bn
    n_keys = n_shards * ng
    min_bc = torch.full((n_keys,), np.iinfo(np.int64).max, dtype=torch.int64,
                        device=device).scatter_reduce_(0, key, bc, "amin")
    max_bc = torch.full((n_keys,), -1, dtype=torch.int64,
                        device=device).scatter_reduce_(0, key, bc, "amax")
    occupied = max_bc >= 0
    if not bool(occupied.any()):
        raise NotImplementedError("empty matrix; use another sharded mode")
    g_of_key = torch.arange(n_keys, device=device) % ng
    c0 = int((min_bc - g_of_key)[occupied].min())
    base_k = (g_of_key + c0).clamp(min=0)
    k_win = int((max_bc - base_k + 1)[occupied].max())
    if k_win > max_window:
        raise NotImplementedError(
            f"window of {k_win} x-blocks exceeds {max_window}: "
            "matrix is not banded enough for the sharded band kernel")
    base_k = (g_of_key + c0).clamp(0, max(wblocks - k_win, 0))

    def out_of_window(base):
        b = base[key]
        return bool(((bc < b) | (bc >= b + k_win)).any())

    if out_of_window(base_k):
        k_win += int((bc - (base_k[key] + k_win - 1)).max().clamp(min=0))
        if k_win > max_window:
            raise NotImplementedError("edge clamping exceeds window limit")
        base_k = (g_of_key + c0).clamp(0, max(wblocks - k_win, 0))
        if out_of_window(base_k):
            raise NotImplementedError("window structure not affine enough")

    # interior groups: x window inside x_local (blocks [h, h + cb)); base(g)
    # is monotone in g, so the interior is one contiguous range
    h, cb = halo // bn, chunk // bn
    base_of_g = np.clip(np.arange(ng) + c0, 0, max(wblocks - k_win, 0))
    interior = (base_of_g >= h) & (base_of_g + k_win <= h + cb)
    if interior.any():
        g_lo = int(np.argmax(interior))
        g_hi = int(ng - np.argmax(interior[::-1]))
    else:
        g_lo = g_hi = 0  # every group reaches the halo (tiny chunks)

    np_store = np.dtype(np.int32) if as_int else sr.np_dtype
    with np.errstate(invalid="ignore"):
        vals = (coo.vals != 0).astype(np.int32) if as_int else coo.vals.astype(np_store)
    kbn = k_win * bn
    strips = torch.full((n_shards * chunk * kbn,), zero,
                        dtype=torch.int32 if as_int else sr.dtype, device=device)
    lane = (bc - base_k[key]) * bn + wcol % bn
    # rank d's row r sits at strip row d·chunk + r
    strips[rows * kbn + lane] = torch.from_numpy(np.ascontiguousarray(vals)).to(device)
    strips = strips.view(n_shards, chunk // bm, bm, kbn)
    if (value_dtype == "bfloat16" and not as_int
            and np.issubdtype(sr.np_dtype, np.floating)):
        strips = strips.to(torch.bfloat16)  # round to nearest even
    i0, i1 = g_lo * gs, g_hi * gs
    return ShardedBandOperand(
        strips_head=strips[:, :i0].contiguous(), strips_int=strips[:, i0:i1].contiguous(),
        strips_tail=strips[:, i1:].contiguous(), c0=c0, k_win=k_win, halo=halo,
        chunk=chunk, bn=bn, g_lo=g_lo, g_hi=g_hi), chunk


@dataclasses.dataclass(frozen=True)
class _Geometry:
    """The static numbers of a band shard's step."""

    halo: int
    bn: int
    ng: int
    g_lo: int
    g_hi: int


@dataclasses.dataclass(frozen=True)
class BandShard:
    """One rank's three parts as band operands (None where a part has no
    groups), each with the span table of its own strips."""

    head: Optional[BsrBandOperand]
    interior: Optional[BsrBandOperand]
    tail: Optional[BsrBandOperand]


def place_band_shard(mesh: Mesh, op: ShardedBandOperand, sr: Semiring) -> BandShard:
    """This rank's parts on its device: the interior indexes x_local alone
    (its base shifted by −h), head and tail the whole window."""
    if op.n_shards != mesh.size:
        raise ValueError(f"operand of {op.n_shards} shards on a mesh of {mesh.size} ranks")
    h, cb = op.halo // op.bn, op.chunk // op.bn
    wb = cb + 2 * h

    def part(strips, c0, n_cols):
        if not strips.shape[1]:
            return None
        s = strips[mesh.rank].to(mesh.device)
        return BsrBandOperand(strips=s, c0=c0, k_win=op.k_win, n_cols=n_cols,
                              windowed=op.windowed, spans=band_spans(s, sr))

    return BandShard(head=part(op.strips_head, op.c0, wb * op.bn),
                     interior=part(op.strips_int, op.c0 + op.g_lo - h, cb * op.bn),
                     tail=part(op.strips_tail, op.c0 + op.g_hi, wb * op.bn))


def _local_band_dp(mesh: Mesh, shard: BandShard, geo: _Geometry, x_local: torch.Tensor,
                   sr: Semiring) -> torch.Tensor:
    """The rank's ⊕-clamped dp (chunk,): the edges' exchange issued, the
    interior launched against x_local, then head and tail against the
    window once the edges are in."""
    wait = comm.start_ring_exchange(mesh, x_local[-geo.halo:], x_local[:geo.halo])
    parts = {}
    if shard.interior is not None:
        parts["interior"] = dp_bsr_band(shard.interior, x_local, sr,
                                        n_rows=(geo.g_hi - geo.g_lo) * geo.bn)
    from_left, from_right = wait()
    if shard.head is not None or shard.tail is not None:
        window = torch.cat([from_left, x_local, from_right])
        if shard.head is not None:
            parts["head"] = dp_bsr_band(shard.head, window, sr, n_rows=geo.g_lo * geo.bn)
        if shard.tail is not None:
            parts["tail"] = dp_bsr_band(shard.tail, window, sr,
                                        n_rows=(geo.ng - geo.g_hi) * geo.bn)
    dp = torch.cat([parts[k] for k in ("head", "interior", "tail") if k in parts])
    dp = dp.to(sr.dtype)
    # ⊕-identity clamp (saturates float overflow on padded slots)
    return sr.add(dp, torch.full_like(dp, sr.zero))


def band_local_dp(mesh: Mesh, op: ShardedBandOperand, sr: Semiring) -> Callable:
    """This rank's step ``x_local -> dp_local`` over its placed shard,
    made once per (operand, rank, semiring)."""
    shard = fixcore.cached(op, ("band_shard", fixcore.mesh_key(mesh), sr.name),
                           lambda: place_band_shard(mesh, op, sr))
    geo = _Geometry(op.halo, op.bn, op.chunk // op.bn, op.g_lo, op.g_hi)
    return lambda x_local: _local_band_dp(mesh, shard, geo, x_local, sr)


def _spmv_solver(mesh: Mesh, op: ShardedBandOperand, sr: Semiring) -> Callable:
    """The cached one-shot dp of this (mesh, operand, semiring): repeated
    calls return the same solver."""
    return fixcore.make_spmv_solver(mesh, op, band_local_dp(mesh, op, sr), key=(sr.name,))


def sharded_spmv_band(mesh: Mesh, op: ShardedBandOperand, x, sr: Semiring,
                      n_rows: int) -> torch.Tensor:
    """One y = A ⊗ x with the band kernel as each rank's local compute and
    the O(halo) ring exchange; the whole y on every rank."""
    x_pad = fixcore.pad_rows(x, mesh.size * op.chunk, sr.zero, sr.dtype, mesh.device)
    dp = _spmv_solver(mesh, op, sr)(fixcore.local_rows(mesh, x_pad, op.chunk))
    return comm.all_gather(mesh, dp)[:n_rows]


def sharded_fixpoint_band(
    mesh: Mesh,
    op: ShardedBandOperand,
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
    """The whole fixpoint with band local compute: two edge exchanges a
    step, overlapped with the interior launch, and the all-reduced changed
    flag. The result contract of ``sharded.sharded_fixpoint``, the aux
    channel (BFS levels) included."""
    solver = fixcore.make_fixpoint_solver(
        mesh, op, band_local_dp(mesh, op, sr), combine=combine, exact=exact, delta=delta,
        max_iter=max_iter, norm=norm, with_aux=aux_update is not None,
        aux_update=aux_update, key=(sr.name,))
    return fixcore.run_solver(mesh, solver, x0, sr, chunk=op.chunk, n_rows=n_rows,
                              aux0=aux0 if aux_update is not None else None)
