"""The ``sell`` variant: the JAX package's gen-5 design record.

The operand is the JAX package's: per row slab of at most ``slab_nnz``
nonzeros, a phase-A stream that packs entries column-block-major (each
stream sublane holds entries of one 128-wide x block, an entry at lane
``row % 128``) and a chain of gather-reduce levels whose final level puts
the slab's rows in canonical order. The build makes JAX's arrays with
array arithmetic where JAX loops over entries, so its arrays equal JAX's,
and it refuses what JAX refuses but for the TPU backend guard, which names
a Mosaic limit a CUDA kernel does not have.

- **Phase A** (JAX ``_phase_a_call``): ``contrib[s, j] = x2d[blocksel[s],
  lanesel[s, j]] ⊗ vals[s, j]``.
- **Levels** (JAX ``_level_call``): a lane-preserving gather ``z[s, j] =
  src_p[idx[s, j], j]`` from the level's source, padded with 0̄ to t_src
  rows, then per region (w, s0, s1) the ⊕ of each run of w rows in order
  t = 0..w−1, the regions' outputs concatenated.

On a CUDA tensor :func:`dp_sell` launches the two kernels of
``csrc/sell.cu``: one fused launch computes every slab's level 0 straight
from the phase-A stream, so the contrib stream is never written, then one
level launch covers every later depth of every slab, a block per (slab,
32-lane slice) chaining its depths in shared memory. Both are driven by
tables built once with the operand. On a CPU tensor it runs
:func:`dp_sell_plain`, which does the same arithmetic slab by slab in
torch with the same ⊕ order.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from sparseharness_tpu_torch.formats.sparse import COO, fold_duplicates, round_up
from sparseharness_tpu_torch.ops import _build
from sparseharness_tpu_torch.semiring import Semiring
from sparseharness_tpu_torch.semiring.core import _carrier, _np_fold_for
from sparseharness_tpu_torch.utils.device import DeviceLike, resolve_device

LANES = 128
#: max padded x sublanes (256k f32 columns = 1 MB), the TPU's VMEM budget;
#: kept so that the port refuses the matrices JAX refuses
XROWS_MAX = 2048
#: target nonzeros per row slab
SLAB_NNZ = 400_000
#: max contrib sublanes per slab (≈ SLAB_NNZ/128 with packing slack)
TB_MAX = 4608
#: run widths per level (pow2); rows longer than W_MAX chain across levels
W_SET = (1, 4, 16, 64)
W_MAX = W_SET[-1]
#: refuse layouts whose packed slots exceed this multiple of nnz
PAD_BLOWUP_LIMIT = 8.0
#: int32 words of one launch-table entry, as csrc/sell.cu:EntryField
ENTRY_WORDS = 24
#: int32 words of one fused-launch block, as csrc/sell.cu:GroupField
GROUP_WORDS = 12
G_WIN, G_WIN_ROWS = 8, 9
#: lanes of one fused-launch block, as csrc/sell.cu:kGroupLanes; every
#: level keeps the lane, so lane slices are independent
GROUP_LANES = 32
#: idx rows of one fused-launch block, a run's slots times its output rows
GROUP_SLOTS = 512
#: most stream rows a fused-launch block stages (72 KB of f32 products)
STAGE_ROWS = 576
#: int32 words of one level-launch chain, as csrc/sell.cu:ChainField
CHAIN_WORDS = 8
C_LATER, C_SHARED, C_ENTRIES = 0, 1, 2
#: most levels past 0 a chain row holds; a slab's phase-A stream has at most
#: TB_MAX rows, so a row has at most TB_MAX slots and chains through 3
MAX_LATER = CHAIN_WORDS - C_ENTRIES
#: most rows of GROUP_LANES 4-byte words a level block may keep in shared
#: memory (227 KB less 1 KB of table entries), as csrc/sell.cu:kMaxLevelRows.
#: A slab's level block keeps its later levels' idx rows, its level-0 rows
#: and its intermediate rows there when they fit, else takes the work path.
#: Every block of a launch gets the largest shared slab's rows, but on the
#: H100 a launch of the band's slabs (208 rows) and one of 825 rows ran no
#: slower with that slab shared than on the work path
LEVEL_ROWS_MAX = (232448 - 1024) // (GROUP_LANES * 4)


class _LevelLayout(NamedTuple):
    """One gather-reduce level."""

    regions: Tuple[Tuple[int, int, int], ...]  # (w, sublane_start, sublane_end)
    t_src: int       # padded source sublanes (== idx sublanes)
    d_out: int       # output sublanes (sum of region_rows / w)
    final: bool      # output is the canonical (rows/128, 128) block


class _SlabLayout(NamedTuple):
    row0: int        # first row of the slab (multiple of 128)
    rows: int        # rows covered (multiple of 128)
    t_a: int         # phase-A stream sublanes
    levels: Tuple[_LevelLayout, ...]


class SellOperand(NamedTuple):
    """Per-slab streams (views of the flat tensors below), the layouts, and
    the launch tables of csrc/sell.cu.

    ``slabs[i]`` maps lanesel (t_a, 128) int32, vals (t_a, 128) in the
    carrier type, blocksel (t_a, 1) int32 and idx{li} (t_src, 128) int32
    per level, as the JAX package's SellOperand holds them. The kernels
    read them flat: ``lanesel``, ``vals``, ``blocksel`` are every slab's
    phase-A stream concatenated, ``idx`` every (slab, level) idx array
    ordered by level depth, then slab. ``table`` holds one ENTRY_WORDS row
    per (slab, level), same order, and ``depth_entries`` the first entry
    of each depth (one more than the depths). ``groups`` holds one
    GROUP_WORDS row per block of the fused depth-0 launch, and
    ``stage_rows`` the most stream rows one of them stages. ``chains``
    holds one CHAIN_WORDS row per slab with a later level (the level
    launch takes four blocks of each), and ``level_rows`` the most rows of
    GROUP_LANES words one of those blocks keeps in shared memory."""

    slabs: List[dict]
    layouts: Tuple[_SlabLayout, ...]
    xrows: int
    n_rows: int
    lanesel: torch.Tensor       # int32 (TA, 128)
    vals: torch.Tensor          # carrier (TA, 128)
    blocksel: torch.Tensor      # int32 (TA, 1)
    idx: torch.Tensor           # int32 (sum t_src, 128)
    table: torch.Tensor         # int32 (E, ENTRY_WORDS)
    depth_entries: Tuple[int, ...]
    depth_rows: Tuple[int, ...]  # output rows of each depth
    work_rows: int              # level 0's and the work path's non-final rows
    groups: torch.Tensor        # int32 (G, GROUP_WORDS)
    stage_rows: int
    chains: torch.Tensor        # int32 (C, CHAIN_WORDS)
    level_rows: int

    @property
    def n_pad(self) -> int:
        return sum(lay.rows for lay in self.layouts)

    @property
    def max_levels(self) -> int:
        return max(len(lay.levels) for lay in self.layouts)


def _run_width(length: int) -> int:
    for w in W_SET:
        if length <= w:
            return w
    return W_MAX


def build_sell(coo: COO, sr: Semiring, xrows_max: int = XROWS_MAX,
               slab_nnz: int = SLAB_NNZ, value_dtype: str = "float32", *,
               device: DeviceLike = None) -> SellOperand:
    """The JAX package's NumPy build (``pallas_sell.build_sell``), its
    arrays moved to ``device`` with the launch tables. ``value_dtype`` is
    accepted and unused, as in JAX: the stream holds the carrier type."""
    device = resolve_device(device)
    n, c = coo.shape
    _, _, _, _, zero, as_int = _carrier(sr)
    np_dtype = np.int32 if as_int else sr.np_dtype
    zero = np.asarray(zero, np_dtype)
    xrows = round_up(max(round_up(max(c, 1), LANES) // LANES, 8), 8)
    if xrows > xrows_max:
        raise NotImplementedError(
            f"sell needs x resident in VMEM: {c} cols > {xrows_max * LANES}"
        )
    coo = fold_duplicates(coo, _np_fold_for(sr, as_int))
    s = coo.sorted_by_row()
    vals = s.vals if not as_int else (s.vals != 0).astype(np.int32)
    vals = vals.astype(np_dtype)
    lens = np.bincount(s.rows, minlength=n).astype(np.int64)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=indptr[1:])
    if lens.max(initial=0) > slab_nnz:
        raise NotImplementedError("a single row exceeds the slab capacity")

    # ---- row slabs (boundaries multiples of 128, ≤ slab_nnz each) -------
    n_pad = round_up(max(n, 1), LANES)
    slab_bounds: List[Tuple[int, int]] = []
    r0 = 0
    while r0 < n_pad:
        r1 = r0 + LANES
        while r1 < n_pad:
            nxt = r1 + LANES
            if indptr[min(nxt, n)] - indptr[min(r0, n)] > slab_nnz:
                break
            r1 = nxt
        slab_bounds.append((r0, r1))
        r0 = r1

    slabs = []
    layouts = []
    total_slots = 0
    for (r0, r1) in slab_bounds:
        e0, e1 = int(indptr[min(r0, n)]), int(indptr[min(r1, n)])
        rows_e = s.rows[e0:e1]
        cols_e = s.cols[e0:e1]
        vals_e = vals[e0:e1]
        m = e1 - e0

        # ---- phase A packing: sublane ↔ (column block), lane = row%128
        blk = cols_e // LANES
        lane = (rows_e % LANES).astype(np.int64)
        order = np.lexsort((lane, blk))
        ob, ol = blk[order], lane[order]
        group = ob * LANES + ol
        grp_starts = np.r_[0, 1 + np.nonzero(np.diff(group))[0]]
        grp_id = np.zeros(m, np.int64)
        grp_id[grp_starts[1:]] = 1
        grp_id = np.cumsum(grp_id)
        pos = np.arange(m, dtype=np.int64) - grp_starts[grp_id]
        counts = np.bincount(group, minlength=(ob.max(initial=0) + 1 if m else 1) * LANES)
        counts2d = counts.reshape(-1, LANES)
        s_per_block = counts2d.max(axis=1)
        block_off = np.zeros(len(s_per_block) + 1, np.int64)
        np.cumsum(s_per_block, out=block_off[1:])
        t_real = int(block_off[-1])
        t_a = round_up(max(t_real, 8), 8)
        if t_a > xrows:
            t_a = round_up(t_a, xrows)
        if t_a > TB_MAX:
            raise NotImplementedError(
                f"phase-A stream {t_a} sublanes exceeds {TB_MAX}: "
                "(block, lane) histogram too skewed for sell"
            )
        sub = block_off[ob] + pos      # entry sublane in the contrib stream
        lanesel = np.zeros((t_a, LANES), np.int32)
        vals_a = np.full((t_a, LANES), zero, np_dtype)
        blocksel = np.repeat(np.arange(len(s_per_block), dtype=np.int32),
                             s_per_block)[:, None]
        blocksel = np.concatenate([blocksel, np.zeros((t_a - t_real, 1), np.int32)])
        lanesel[sub, ol] = (cols_e[order] % LANES).astype(np.int32)
        vals_a[sub, ol] = vals_e[order]
        total_slots += t_a * LANES

        arrays = {"lanesel": lanesel, "vals": vals_a, "blocksel": blocksel}
        levels = _build_levels(rows_e[order] - r0, sub, r1 - r0, t_a, arrays)
        total_slots += sum(lv.t_src for lv in levels) * LANES
        slabs.append(arrays)
        layouts.append(_SlabLayout(
            row0=r0, rows=r1 - r0, t_a=t_a, levels=tuple(levels),
        ))

    nnz = max(coo.nnz, 1)
    if total_slots > PAD_BLOWUP_LIMIT * nnz and total_slots > 1 << 20:
        raise NotImplementedError(
            f"sell padding blowup: {total_slots} packed slots for {nnz} "
            "nonzeros; use coo_seg/ell"
        )
    return assemble(slabs, tuple(layouts), xrows, n, device)


def _build_levels(row_local: np.ndarray, sub: np.ndarray, rows: int, t_a: int,
                  arrays: dict) -> Tuple[_LevelLayout, ...]:
    """The gather-reduce levels of one slab, as the JAX build's per-row
    loops make them, in array arithmetic: ``row_local`` and ``sub`` give
    each entry's row in the slab and its contrib sublane, in phase-A order.
    Adds ``idx{li}`` to ``arrays``.

    A row's slots are its entries' sublanes in phase-A order (a stable sort
    by row). Each level cuts every row with slots into runs of its width w
    (the least of W_SET that holds the row, else W_MAX); a run's rank p
    among the runs of its width and lane, in row order, places it at
    sublanes start_w + p·w of its region, and its output, out_w + p,
    becomes the row's slot in the next level. The level where no row holds
    more than one slot is final: it puts each row's slot at (row / 128,
    row % 128)."""
    by_row = np.argsort(row_local, kind="stable")
    slot = sub[by_row].astype(np.int64)
    count = np.bincount(row_local, minlength=rows)
    lane_of_row = np.arange(rows) % LANES
    widths = np.asarray(W_SET)
    levels = []
    src_sublanes = t_a
    li = 0
    while True:
        if count.max(initial=0) <= 1:
            d_out = rows // LANES
            t_src = round_up(max(round_up(src_sublanes + 1, 8), d_out), 8)
            idx = np.full((t_src, LANES), t_src - 1, np.int32)
            has = np.nonzero(count)[0]
            idx[has // LANES, has % LANES] = slot
            levels.append(_LevelLayout(regions=((1, 0, d_out),), t_src=t_src, d_out=d_out,
                                       final=True))
            arrays[f"idx{li}"] = idx
            return tuple(levels)

        wi_row = np.minimum(np.searchsorted(widths, count), len(W_SET) - 1)
        w_row = widths[wi_row]
        n_runs = np.where(count > 0, -(-count // w_row), 0)
        run_row = np.repeat(np.arange(rows), n_runs)          # runs in row order
        run_key = wi_row[run_row] * LANES + lane_of_row[run_row]
        per_key = np.bincount(run_key, minlength=len(W_SET) * LANES)
        key_start = np.zeros(len(per_key) + 1, np.int64)
        np.cumsum(per_key, out=key_start[1:])
        by_key = np.argsort(run_key, kind="stable")
        rank = np.empty(len(run_key), np.int64)
        rank[by_key] = np.arange(len(run_key)) - key_start[run_key[by_key]]

        regions = []
        region_start = np.zeros(len(W_SET), np.int64)
        out_start = np.zeros(len(W_SET), np.int64)
        sub_cursor, oc = 0, 0
        for wi, w in enumerate(W_SET):
            depth = int(per_key[wi * LANES:(wi + 1) * LANES].max())
            if depth == 0:
                continue
            region_rows = round_up(depth * w, 8 * w)
            regions.append((w, sub_cursor, sub_cursor + region_rows))
            region_start[wi], out_start[wi] = sub_cursor, oc
            sub_cursor += region_rows
            oc += region_rows // w
        t_src = round_up(max(src_sublanes + 1, max(sub_cursor, 8)), 8)
        idx = np.full((t_src, LANES), t_src - 1, np.int32)

        # each slot's run (the row's first run + position // w) and place in it
        first_run = np.zeros(rows + 1, np.int64)
        np.cumsum(n_runs, out=first_run[1:])
        slot_row = np.repeat(np.arange(rows), count)
        row_ptr = np.zeros(rows + 1, np.int64)
        np.cumsum(count, out=row_ptr[1:])
        pos = np.arange(len(slot)) - row_ptr[slot_row]
        w_slot = w_row[slot_row]
        run = first_run[slot_row] + pos // w_slot
        wi_slot = wi_row[slot_row]
        idx[region_start[wi_slot] + rank[run] * w_slot + pos % w_slot,
            lane_of_row[slot_row]] = slot
        levels.append(_LevelLayout(regions=tuple(regions), t_src=t_src, d_out=oc, final=False))
        arrays[f"idx{li}"] = idx
        slot = out_start[wi_row[run_row]] + rank     # next level: one slot per run
        count = n_runs
        src_sublanes = oc
        li += 1


class LaunchTables(NamedTuple):
    table: np.ndarray               # int32 (E, ENTRY_WORDS)
    depth_entries: Tuple[int, ...]  # first entry of each depth, and E
    depth_rows: Tuple[int, ...]     # output rows of each depth
    work_rows: int
    order: List[Tuple[int, int]]    # (slab, level) of each entry
    chains: np.ndarray              # int32 (C, CHAIN_WORDS)
    level_rows: int                 # most shared rows of a level block


def chain_rows(lay: _SlabLayout) -> Tuple[int, int]:
    """(idx rows, value rows) that a level block of this slab keeps in
    shared memory on the shared path, per lane slice: every later level's
    region rows of idx (its rows past the last region are padding that no
    output reads), then level 0's output rows and those of every later
    level but the final one."""
    idx_rows = sum(lv.regions[-1][2] for lv in lay.levels[1:])
    return idx_rows, sum(lv.d_out for lv in lay.levels[:-1])


def launch_table(layouts, level_rows: int = LEVEL_ROWS_MAX) -> LaunchTables:
    """The launch tables of csrc/sell.cu, from the layouts alone.

    Entries are (slab, level) pairs ordered by level depth, then slab, so
    entry si is slab si's level 0. A level-0 entry's source is the slab's
    phase-A stream: its first row in the flat lanesel / vals / blocksel and
    its t_a rows; a final level writes the slab's rows at row0 / 128 of the
    dp. The level-0 rows of non-final levels open the work buffer of
    128-wide rows, in slab order. Each slab with a later level is a chain
    row: its count of later levels, whether its level block keeps them in
    shared memory, and their entries. It does when its :func:`chain_rows`
    total at most ``level_rows``; then a later non-final level's rows sit
    in the block's intermediate rows (after its idx rows and its copy of
    the level-0 rows), and its entry's offsets point there. Otherwise they
    follow level 0's in the work buffer, in entry order."""
    if not 0 <= level_rows <= LEVEL_ROWS_MAX:
        raise ValueError(f"level_rows must lie in [0, {LEVEL_ROWS_MAX}]")
    a_off = np.concatenate([[0], np.cumsum([lay.t_a for lay in layouts])]).astype(int)
    depths = max(len(lay.levels) for lay in layouts)
    order = [(si, li) for li in range(depths) for si, lay in enumerate(layouts)
             if li < len(lay.levels)]
    shared = {}
    for si, lay in enumerate(layouts):
        if len(lay.levels) > 1:
            if len(lay.levels) - 1 > MAX_LATER:
                raise NotImplementedError(f"a slab chains through {len(lay.levels) - 1} levels "
                                          f"past 0; the level launch takes {MAX_LATER}")
            shared[si] = sum(chain_rows(lay)) <= level_rows
    out_of, work, inter = {}, 0, {}
    for si, li in order:
        level = layouts[si].levels[li]
        if level.final:
            continue
        if li > 0 and shared[si]:
            out_of[si, li] = inter.get(si, 0)
            inter[si] = out_of[si, li] + level.d_out
        else:
            out_of[si, li] = work
            work += level.d_out
    table = np.zeros((len(order), ENTRY_WORDS), np.int32)
    entry_of = {}
    depth_entries, depth_rows = [0], []
    idx_off = 0
    rows_in_depth, cur = 0, 0
    for e, (si, li) in enumerate(order):
        entry_of[si, li] = e
        if li != cur:
            depth_entries.append(e)
            depth_rows.append(rows_in_depth)
            rows_in_depth, cur = 0, li
        lay = layouts[si]
        level = lay.levels[li]
        if li == 0:
            src_off, src_rows = a_off[si], lay.t_a
        else:
            src_off, src_rows = out_of[si, li - 1], lay.levels[li - 1].d_out
        out_off = lay.row0 // LANES if level.final else out_of[si, li]
        regions = []
        oc = 0
        for (w, s0, s1) in level.regions:
            regions += [w, s0, oc, oc + (s1 - s0) // w]
            oc += (s1 - s0) // w
        table[e, :8] = (rows_in_depth, level.d_out, src_off, src_rows, idx_off,
                        out_off, int(level.final), len(level.regions))
        table[e, 8:8 + len(regions)] = regions
        rows_in_depth += level.d_out
        idx_off += level.t_src
    depth_entries.append(len(order))
    depth_rows.append(rows_in_depth)
    chains = np.zeros((len(shared), CHAIN_WORDS), np.int32)
    most = 0
    for c, si in enumerate(sorted(shared)):
        later = len(layouts[si].levels) - 1
        chains[c, :C_ENTRIES + later] = [later, int(shared[si])] + [
            entry_of[si, li] for li in range(1, later + 1)]
        if shared[si]:
            most = max(most, sum(chain_rows(layouts[si])))
    return LaunchTables(table, tuple(depth_entries), tuple(depth_rows), work, order, chains,
                        most)


def fused_groups(table: np.ndarray, idx0s, group_slots: int = GROUP_SLOTS,
                 stage_rows: int = STAGE_ROWS) -> Tuple[np.ndarray, int]:
    """The blocks of the fused depth-0 launch of csrc/sell.cu, from the
    launch table and each slab's idx0 array (NumPy).

    Each level-0 region (w, s0, s1) is cut into groups of
    max(1, group_slots // w) consecutive output rows, and each group into
    GROUP_LANES-wide lane slices: one block each. A block's window is the
    span of stream rows its valid idx slots (those below t_a) name. It is
    staged in shared memory when it holds at most ``stage_rows`` rows and
    at most twice the block's slots per lane (else staging would read more
    than the gather); otherwise the block gathers in place. Returns the
    (blocks, GROUP_WORDS) table and the most rows any block stages."""
    rows = []
    for si, idx0 in enumerate(idx0s):
        e = table[si]
        t_a, src = int(e[3]), int(e[2])
        for k in range(int(e[7])):
            w, s0, oc0, oc1 = (int(v) for v in e[8 + 4 * k:12 + 4 * k])
            nq_max = max(1, group_slots // w)
            for q0 in range(0, oc1 - oc0, nq_max):
                nq = min(nq_max, oc1 - oc0 - q0)
                block = idx0[s0 + q0 * w:s0 + (q0 + nq) * w].reshape(
                    nq * w, LANES // GROUP_LANES, GROUP_LANES)
                valid = block < t_a
                lo = np.where(valid, block, t_a).min(axis=(0, 2))
                hi = np.where(valid, block, -1).max(axis=(0, 2))
                for sl in range(LANES // GROUP_LANES):
                    span = int(hi[sl] - lo[sl] + 1)
                    staged = 0 < span <= min(stage_rows, 2 * nq * w)
                    rows.append((int(e[4]) + s0 + q0 * w, w, nq, int(e[5]) + oc0 + q0,
                                 int(e[6]), sl * GROUP_LANES, src, t_a,
                                 src + int(lo[sl]) if staged else 0, span if staged else 0,
                                 0, 0))
    groups = np.asarray(rows, np.int32).reshape(-1, GROUP_WORDS)
    return groups, int(groups[:, G_WIN_ROWS].max(initial=0))


def assemble(slab_arrays, layouts, xrows: int, n_rows: int,
             device: torch.device) -> SellOperand:
    """The operand from per-slab NumPy arrays (int32 indices, values in the
    carrier type): the flat tensors on ``device``, each slab's arrays as
    views of them, and the launch tables."""
    lt = launch_table(layouts)
    groups, stage_rows = fused_groups(lt.table, [a["idx0"] for a in slab_arrays])

    def flat(parts):
        return torch.from_numpy(np.concatenate([np.asarray(a) for a in parts])).to(device)

    lanesel, vals, blocksel = (flat([a[key] for a in slab_arrays])
                               for key in ("lanesel", "vals", "blocksel"))
    idx = flat([slab_arrays[si][f"idx{li}"] for si, li in lt.order])
    idx_off = {key: int(lt.table[e, 4]) for e, key in enumerate(lt.order)}
    slabs, a0 = [], 0
    for si, lay in enumerate(layouts):
        slab = {key: t[a0:a0 + lay.t_a]
                for key, t in (("lanesel", lanesel), ("vals", vals), ("blocksel", blocksel))}
        for li, level in enumerate(lay.levels):
            i0 = idx_off[si, li]
            slab[f"idx{li}"] = idx[i0:i0 + level.t_src]
        slabs.append(slab)
        a0 += lay.t_a
    return SellOperand(
        slabs=slabs, layouts=layouts, xrows=int(xrows), n_rows=int(n_rows),
        lanesel=lanesel, vals=vals, blocksel=blocksel, idx=idx,
        table=torch.from_numpy(lt.table).to(device), depth_entries=lt.depth_entries,
        depth_rows=lt.depth_rows, work_rows=lt.work_rows,
        groups=torch.from_numpy(groups).to(device), stage_rows=stage_rows,
        chains=torch.from_numpy(lt.chains).to(device), level_rows=lt.level_rows,
    )


def regroup(op: SellOperand, group_slots: int = GROUP_SLOTS,
            stage_rows: int = STAGE_ROWS) -> SellOperand:
    """``op`` with its fused-launch blocks cut anew: ``stage_rows`` 0 makes
    every block gather in place. For measuring the kernel's designs."""
    groups, most = fused_groups(op.table.cpu().numpy(),
                                [slab["idx0"].cpu().numpy() for slab in op.slabs],
                                group_slots, stage_rows)
    return op._replace(groups=torch.from_numpy(groups).to(op.table.device), stage_rows=most)


def relevel(op: SellOperand, level_rows: int = LEVEL_ROWS_MAX) -> SellOperand:
    """``op`` with its level launch planned anew under another shared-memory
    limit: ``level_rows`` 0 puts every slab on the work path. Level 0's
    entries, and so the fused launch's blocks, do not change. A seam for
    the tests and the probes, which drive each matrix through both of the
    kernel's paths; the package itself plans only with LEVEL_ROWS_MAX."""
    lt = launch_table(op.layouts, level_rows)
    dev = op.table.device
    return op._replace(table=torch.from_numpy(lt.table).to(dev), work_rows=lt.work_rows,
                       chains=torch.from_numpy(lt.chains).to(dev), level_rows=lt.level_rows)


def pad_x2d(op: SellOperand, x: torch.Tensor, sr: Semiring) -> torch.Tensor:
    """x padded with 0̄ to xrows·128 in the semiring type, as (xrows, 128),
    in the carrier type (int32 for or_and)."""
    carrier = _carrier(sr)[0]
    x_pad = torch.full((op.xrows * LANES,), sr.zero, dtype=sr.dtype, device=x.device)
    x_pad[: x.shape[0]] = x.to(sr.dtype)
    return x_pad.view(op.xrows, LANES).to(carrier)


def dp_sell(op: SellOperand, x: torch.Tensor, sr: Semiring, *,
            n_rows: int) -> torch.Tensor:
    """⊕-reduced row dot-products over the padded row space, in canonical
    row order (``dp > 0`` for or_and), as the JAX package's dp_sell. On a
    CUDA tensor this launches the kernels; on a CPU tensor it runs the
    plain version."""
    if op.table.device.type == "cpu":
        return dp_sell_plain(op, x, sr, n_rows=n_rows)
    dp = sell_dp_cuda(op, pad_x2d(op, x, sr), sr)
    return dp > 0 if _carrier(sr)[5] else dp


def level_plain(src: torch.Tensor, idx: torch.Tensor, level: _LevelLayout,
                sr: Semiring) -> torch.Tensor:
    """One gather-reduce level in torch: src padded with 0̄ to t_src rows,
    z = src_p[idx[s, j], j], then per region the ⊕ of runs of w rows in
    order, the regions concatenated."""
    _, add, _, _, zero, _ = _carrier(sr)
    pad = torch.full((level.t_src - src.shape[0], LANES), zero, dtype=src.dtype,
                     device=src.device)
    z = torch.take_along_dim(torch.cat([src, pad]), idx.long(), dim=0)
    parts = []
    for (w, s0, s1) in level.regions:
        zr = z[s0:s1]
        acc = zr[0::w]
        for t in range(1, w):
            acc = add(acc, zr[t::w])
        parts.append(acc)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def phase_a_plain(slab: dict, x2d: torch.Tensor, sr: Semiring) -> torch.Tensor:
    """One slab's contrib stream in torch: x2d[blocksel[s], lanesel[s, j]]
    ⊗ vals[s, j]."""
    rows = x2d[slab["blocksel"][:, 0].long()]
    return _carrier(sr)[2](torch.take_along_dim(rows, slab["lanesel"].long(), dim=1),
                           slab["vals"])


def dp_sell_plain(op: SellOperand, x: torch.Tensor, sr: Semiring, *,
                  n_rows: int) -> torch.Tensor:
    """The plain torch version of :func:`dp_sell`, on any device: per slab
    the phase-A products, then its levels in order."""
    x2d = pad_x2d(op, x, sr)
    outs = []
    for slab, lay in zip(op.slabs, op.layouts):
        src = phase_a_plain(slab, x2d, sr)
        for li, level in enumerate(lay.levels):
            src = level_plain(src, slab[f"idx{li}"], level, sr)
        outs.append(src.reshape(-1))
    dp = outs[0] if len(outs) == 1 else torch.cat(outs)
    return dp > 0 if _carrier(sr)[5] else dp


def _check(op: SellOperand, sr: Semiring, *tensors: torch.Tensor) -> torch.dtype:
    dev = op.table.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("the sell kernels need the operand and their tensors on one CUDA "
                         "device")
    carrier = _carrier(sr)[0]
    if op.vals.dtype != carrier or any(t.dtype != carrier or not t.is_contiguous()
                                       for t in tensors):
        raise ValueError(f"{sr.name} takes contiguous {carrier} values, x and buffers")
    return carrier


def _launch_args(op: SellOperand, sr: Semiring):
    dev = op.table.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    codes = (_build.SR_CODES[sr.name], _build.STRIP_CODES[_carrier(sr)[0]])
    return index, codes, torch.cuda.current_stream(dev).cuda_stream


def fused_plain(op: SellOperand, x2d: torch.Tensor,
                sr: Semiring) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the fused launch writes, in torch: each slab's level 0 of its
    phase-A products, ``level_plain(phase_a_plain(slab), idx0)``, at the
    rows the launch table gives it in a zeroed work buffer and dp."""
    carrier = _carrier(sr)[0]
    work = torch.zeros((op.work_rows, LANES), dtype=carrier, device=x2d.device)
    dp = torch.zeros((op.n_pad // LANES, LANES), dtype=carrier, device=x2d.device)
    for si, (slab, lay) in enumerate(zip(op.slabs, op.layouts)):
        level = lay.levels[0]
        out0 = int(op.table[si, 5])
        (dp if level.final else work)[out0:out0 + level.d_out] = level_plain(
            phase_a_plain(slab, x2d, sr), slab["idx0"], level, sr)
    return work, dp.reshape(-1)


def fused_traffic(op: SellOperand) -> dict:
    """Bytes of the fused depth-0 launch, counted from the operand.

    ``bound_bytes``: what the function must move for this operand's data,
    each input once: the level-0 idx rows it reads, the 32-byte sectors of
    lanesel and vals that hold a slot some valid idx names, the blocksel
    entries of those rows (not the stream's pad rows and lanes), x2d, and
    the level-0 outputs. ``array_bytes``: the same with every stream row. ``staged_bytes`` and ``in_place_bytes``: what the launch moves
    by its access pattern, as the blocks are cut (``staged_bytes``) and with
    every block gathering in place (``in_place_bytes``), in 32-byte sectors
    where a load is not a whole row: idx and the outputs as rows; a staged
    block its window's lanesel, vals and blocksel rows once; a block in
    place, per warp step (one idx row of 32 lanes), each distinct sector of
    lanesel, vals and blocksel that its valid slots touch. x2d (at most 1 MB,
    L2-resident) is counted once in each. Also the distinct stream rows and
    lanesel sectors per warp step, the staged windows' rows, and the
    level-0 outputs with at least one valid slot."""
    idx = op.idx.cpu().numpy()
    groups = op.groups.cpu().numpy().astype(np.int64)
    item = op.vals.element_size()
    x_bytes = op.xrows * LANES * item
    idx_b = out_b = staged = in_place = 0
    steps = rows = sectors = live_out = 0
    for i0, w, nq, _, _, lane0, _, t_a, _, win_rows, _, _ in groups:
        ix = idx[i0:i0 + nq * w, lane0:lane0 + GROUP_LANES].astype(np.int64)
        valid = ix < t_a
        idx_b += ix.size * 4
        out_b += nq * GROUP_LANES * item
        # distinct (row, sector) keys per warp step; invalid slots sort last
        key = np.sort(np.where(valid, ix * 4 + np.arange(GROUP_LANES) // 8, -1), axis=1)
        n_sec = ((np.diff(key, axis=1) != 0) & (key[:, 1:] >= 0)).sum(1) + (key[:, 0] >= 0)
        rkey = np.sort(np.where(valid, ix, -1), axis=1)
        n_row = ((np.diff(rkey, axis=1) != 0) & (rkey[:, 1:] >= 0)).sum(1) + (rkey[:, 0] >= 0)
        bkey = np.sort(np.where(valid, ix // 8, -1), axis=1)
        n_blk = ((np.diff(bkey, axis=1) != 0) & (bkey[:, 1:] >= 0)).sum(1) + (bkey[:, 0] >= 0)
        gathered = int(n_sec.sum()) * 32 * 2 + int(n_blk.sum()) * 32
        live = valid.any(1)
        live_out += int(valid.reshape(nq, w, -1).any(1).sum())
        steps += int(live.sum())
        rows += int(n_row.sum())
        sectors += int(n_sec.sum())
        in_place += gathered
        staged += win_rows * (GROUP_LANES * (4 + item) + 4) if win_rows else gathered
    named = np.zeros((op.lanesel.shape[0], LANES // 8), bool)   # 8 lanes a sector
    for si, lay in enumerate(op.layouts):
        src, i0 = int(op.table[si, 2]), int(op.table[si, 4])
        for (_, s0, s1) in lay.levels[0].regions:
            ix = idx[i0 + s0:i0 + s1]
            valid = ix < lay.t_a
            named[src + ix[valid], np.nonzero(valid)[1] // 8] = True
    needed = int(named.sum()) * 32 * 2 + int(named.any(1).sum()) * 4
    stream = op.lanesel.numel() * 4 + op.vals.numel() * item + op.blocksel.numel() * 4
    wins = groups[groups[:, G_WIN_ROWS] > 0, G_WIN_ROWS]
    return {
        "bound_bytes": int(idx_b + needed + x_bytes + out_b),
        "array_bytes": int(idx_b + stream + x_bytes + out_b),
        "staged_bytes": int(idx_b + staged + x_bytes + out_b),
        "in_place_bytes": int(idx_b + in_place + x_bytes + out_b),
        "blocks": len(groups), "staged_blocks": len(wins), "live_outputs": live_out,
        "window_rows": [int(wins.min()), float(np.median(wins)), int(wins.max())]
        if len(wins) else None,
        "rows_per_warp_step": rows / max(steps, 1),
        "sectors_per_warp_step": sectors / max(steps, 1),
    }


def level_traffic(op: SellOperand) -> dict:
    """Bytes and operations of the level launch, counted from the operand.

    ``bound_bytes``: what the function must move, each input once: the
    level-0 rows it reads, the later levels' idx region rows (the rows past
    a level's last region are padding no output reads) and the final rows
    of the slabs with a later level written (the other slabs' final rows
    come from the fused launch). ``operations``: one ⊕ per valid idx slot (below its level's
    source rows) past the first valid one of its run. ``design_bytes``:
    what the launch moves by its design: each block's table entries, the
    later levels' idx region rows (staged on the shared path, read in
    place on the work path), the level-0 rows, the work path's
    intermediates written and read back, and the chained slabs' dp rows.
    Also the chains on each path and the shared rows a block holds."""
    item = op.vals.element_size()
    lanes_bytes = LANES * item
    chains = op.chains.cpu().numpy()
    on_work = {int(e) for c in chains if not c[C_SHARED]
               for e in c[C_ENTRIES:C_ENTRIES + c[C_LATER]]}
    level0 = region_rows = inter_work = final_rows = ops = 0
    table = op.table.cpu().numpy()
    for si, (slab, lay) in enumerate(zip(op.slabs, op.layouts)):
        if len(lay.levels) == 1:
            continue
        level0 += lay.levels[0].d_out
        final_rows += lay.levels[-1].d_out
        region_rows += chain_rows(lay)[0]
        for li in range(1, len(lay.levels)):
            arr = slab[f"idx{li}"].cpu().numpy()
            for (w, s0, s1) in lay.levels[li].regions:
                valid = arr[s0:s1] < lay.levels[li - 1].d_out
                ops += int(valid.sum()) - int(valid.reshape(-1, w, LANES).any(1).sum())
    for e in on_work:
        if not table[e, 6]:
            inter_work += int(table[e, 1])
    entries = sum(int(c[C_LATER]) for c in chains) * (LANES // GROUP_LANES) * ENTRY_WORDS * 4
    return {
        "bound_bytes": (level0 + final_rows) * lanes_bytes + region_rows * LANES * 4,
        "operations": ops,
        "design_bytes": entries + region_rows * LANES * 4 + level0 * lanes_bytes
        + 2 * inter_work * lanes_bytes + final_rows * lanes_bytes,
        "shared_chains": int(chains[:, C_SHARED].sum()) if len(chains) else 0,
        "work_chains": int((chains[:, C_SHARED] == 0).sum()) if len(chains) else 0,
        "level_rows": op.level_rows,
    }


def fused_cuda(op: SellOperand, x2d: torch.Tensor, sr: Semiring, work: torch.Tensor,
               dp: torch.Tensor) -> None:
    """Launch the fused depth-0 kernel once over every slab: each slab's
    level-0 rows from its phase-A stream, into ``work`` (non-final) or
    ``dp`` (final)."""
    _check(op, sr, x2d, work, dp)
    if (x2d.shape != (op.xrows, LANES) or work.shape != (op.work_rows, LANES)
            or dp.numel() != op.n_pad):
        raise ValueError(f"x2d must be ({op.xrows}, {LANES}), work ({op.work_rows}, {LANES}) "
                         f"and dp hold {op.n_pad} rows")
    index, codes, stream = _launch_args(op, sr)
    fn = _build.function("sell", "sh_sell_fused",
                         [ctypes.c_int] + [ctypes.c_void_p] * 8
                         + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    _build.check_launch("sell", fn(
        index, op.groups.data_ptr(), x2d.data_ptr(), op.lanesel.data_ptr(),
        op.vals.data_ptr(), op.blocksel.data_ptr(), op.idx.data_ptr(), work.data_ptr(),
        dp.data_ptr(), op.groups.shape[0], op.stage_rows, *codes, stream))
    _build.LAUNCHES["sell_fused"] += 1


def levels_plain(op: SellOperand, sr: Semiring, work: torch.Tensor,
                 dp: torch.Tensor) -> None:
    """What the level launch writes, in torch, from its tables, on any
    device; a model of its schedule for the tests, never on the card's path.

    Per chain row and 32-lane slice (one block): on the shared path the
    later levels' idx region rows and the slab's level-0 rows are first
    copied into the block's rows, and each later non-final level writes the
    block's intermediate rows; on the work path idx and the level-0 rows
    are read in place and the intermediates go to ``work``. Depth 1 gathers
    from the level-0 rows, each later depth from the previous one's rows; a
    source row at or past the level's source rows reads 0̄; each output is
    the left-to-right ⊕ of its run's w gathered rows; the final depth
    writes ``dp``."""
    _, add, _, _, zero, _ = _carrier(sr)
    table = op.table.tolist()
    dp2d = dp.view(-1, LANES)
    for chain in op.chains.tolist():
        later, shared = chain[C_LATER], bool(chain[C_SHARED])
        entries = [table[e] for e in chain[C_ENTRIES:C_ENTRIES + later]]
        ends = []   # idx rows of each later level: s0 + runs · w of its last region
        for e in entries:
            w, s0, oc0, oc1 = e[4 + 4 * e[7]:8 + 4 * e[7]]
            ends.append(s0 + (oc1 - oc0) * w)
        base = np.concatenate([[0], np.cumsum(ends)]).astype(int)
        inter_rows = sum(e[1] for e in entries if not e[6])
        for lane0 in range(0, LANES, GROUP_LANES):
            lanes = slice(lane0, lane0 + GROUP_LANES)
            if shared:
                sidx = torch.cat([op.idx[e[4]:e[4] + n, lanes] for e, n in zip(entries, ends)])
                level0 = work[entries[0][2]:entries[0][2] + entries[0][3], lanes].clone()
                inter = torch.zeros((inter_rows, GROUP_LANES), dtype=work.dtype,
                                    device=work.device)
            for d, e in enumerate(entries):
                d_out, src_off, src_rows, idx_off, out_off, final = e[1:7]
                if shared:
                    src = level0 if d == 0 else inter[src_off:src_off + src_rows]
                else:
                    src = work[src_off:src_off + src_rows, lanes]
                ix_all = sidx[base[d]:base[d + 1]] if shared else op.idx[idx_off:, lanes]
                for k in range(e[7]):
                    w, s0, oc0, oc1 = e[8 + 4 * k:12 + 4 * k]
                    ix = ix_all[s0:s0 + (oc1 - oc0) * w].long()
                    valid = ix < src_rows
                    z = torch.gather(src, 0, torch.where(valid, ix, 0))
                    z = torch.where(valid, z, torch.full_like(z, zero)).view(oc1 - oc0, w, -1)
                    acc = z[:, 0]
                    for t in range(1, w):
                        acc = add(acc, z[:, t])
                    rows = slice(out_off + oc0, out_off + oc1)
                    if final:
                        dp2d[rows, lanes] = acc
                    elif shared:
                        inter[rows] = acc
                    else:
                        work[rows, lanes] = acc


def levels_cuda(op: SellOperand, sr: Semiring, work: torch.Tensor,
                dp: torch.Tensor) -> None:
    """Launch the level kernel once over every level past 0 of every slab:
    from the level-0 rows in ``work`` to ``dp``. Launched with
    programmatic dependent launch, so it may start while the launch before
    it on the stream drains. Nothing to launch when no slab has a later
    level."""
    _check(op, sr, work, dp)
    if work.shape != (op.work_rows, LANES) or dp.numel() != op.n_pad:
        raise ValueError(f"work must be ({op.work_rows}, {LANES}) and dp hold {op.n_pad} "
                         "rows")
    if op.chains.shape[0] == 0:
        return
    index, codes, stream = _launch_args(op, sr)
    fn = _build.function("sell", "sh_sell_level",
                         [ctypes.c_int] + [ctypes.c_void_p] * 5
                         + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    _build.check_launch("sell", fn(
        index, op.chains.data_ptr(), op.table.data_ptr(), op.idx.data_ptr(), work.data_ptr(),
        dp.data_ptr(), op.chains.shape[0], op.level_rows, *codes, stream))
    _build.LAUNCHES["sell_level"] += 1


def sell_dp_cuda(op: SellOperand, x2d: torch.Tensor, sr: Semiring) -> torch.Tensor:
    """The carrier-typed dp (n_pad rows): the fused depth-0 launch, then the
    level launch (none when every slab is one level): two launches a call
    whatever the depth. Raises on what the kernels do not take and on a
    refused launch."""
    carrier = _check(op, sr, x2d)
    work = torch.empty((op.work_rows, LANES), dtype=carrier, device=x2d.device)
    dp = torch.empty(op.n_pad, dtype=carrier, device=x2d.device)
    fused_cuda(op, x2d, sr, work, dp)
    levels_cuda(op, sr, work, dp)
    return dp
