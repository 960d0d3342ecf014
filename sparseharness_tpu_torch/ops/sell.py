"""The ``sell`` variant: the JAX package's gen-5 design record.

The operand is the JAX package's: per row slab of at most ``slab_nnz``
nonzeros, a phase-A stream that packs entries column-block-major (each
stream sublane holds entries of one 128-wide x block, an entry at lane
``row % 128``) and a chain of gather-reduce levels whose final level puts
the slab's rows in canonical order. The build is a copy of the JAX NumPy
body, so its arrays equal JAX's, and it refuses what JAX refuses but for
the TPU backend guard, which names a Mosaic limit a CUDA kernel does not
have.

- **Phase A** (JAX ``_phase_a_call``): ``contrib[s, j] = x2d[blocksel[s],
  lanesel[s, j]] ⊗ vals[s, j]``.
- **Levels** (JAX ``_level_call``): a lane-preserving gather ``z[s, j] =
  src_p[idx[s, j], j]`` from the level's source, padded with 0̄ to t_src
  rows, then per region (w, s0, s1) the ⊕ of each run of w rows in order
  t = 0..w−1, the regions' outputs concatenated.

On a CUDA tensor :func:`dp_sell` launches the two kernels of
``csrc/sell.cu``: one phase-A launch over every slab's stream, then one
launch per level depth over every slab that has that level, driven by a
launch table built once with the operand. On a CPU tensor it runs
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
    of each depth (one more than the depths)."""

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
    depth_rows: Tuple[int, ...]  # output rows of each depth's launch
    work_rows: int              # contrib rows + every non-final level's rows

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
        counts = np.zeros((ob.max(initial=0) + 1 if m else 1) * LANES, np.int64)
        np.add.at(counts, group, 1)
        counts2d = counts.reshape(-1, LANES)
        s_per_block = counts2d.max(axis=1)
        blocks_used = np.nonzero(s_per_block)[0]
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
        blocksel = np.zeros((t_a, 1), np.int32)
        for b in blocks_used:
            blocksel[block_off[b]:block_off[b + 1], 0] = b
        lanesel[sub, ol] = (cols_e[order] % LANES).astype(np.int32)
        vals_a[sub, ol] = vals_e[order]
        total_slots += t_a * LANES

        # ---- phase B: per-row slot lists (contrib sublanes), lane = r%128
        row_local = rows_e[order] - r0
        slots = [[] for _ in range(r1 - r0)]
        for rl, sb in zip(row_local, sub):
            slots[rl].append(int(sb))

        levels = []
        arrays = {"lanesel": lanesel, "vals": vals_a, "blocksel": blocksel}
        src_sublanes = t_a
        li = 0
        while True:
            n_slots = [len(sl) for sl in slots]
            done = all(k <= 1 for k in n_slots)
            if done:
                d_out = (r1 - r0) // LANES
                t_src = max(round_up(src_sublanes + 1, 8), d_out)
                t_src = round_up(t_src, 8)
                idx = np.full((t_src, LANES), t_src - 1, np.int32)
                for rl, sl in enumerate(slots):
                    if sl:
                        idx[rl // LANES, rl % LANES] = sl[0]
                levels.append(_LevelLayout(
                    regions=((1, 0, d_out),), t_src=t_src, d_out=d_out,
                    final=True,
                ))
                arrays[f"idx{li}"] = idx
                total_slots += t_src * LANES
                break

            runs = []  # (row_local, [slot sublanes], w)
            for rl, sl in enumerate(slots):
                if not sl:
                    continue
                k = len(sl)
                w = _run_width(k)
                for q in range(0, k, w):
                    runs.append((rl, sl[q:q + w], w))
            regions = []
            sub_cursor = 0
            for w in W_SET:
                w_runs = [r for r in runs if r[2] == w]
                if not w_runs:
                    continue
                per_lane = np.zeros(LANES, np.int64)
                for (rl, _, _) in w_runs:
                    per_lane[rl % LANES] += 1
                depth = int(per_lane.max())
                region_rows = round_up(depth * w, 8 * w)
                regions.append((w, sub_cursor, sub_cursor + region_rows))
                sub_cursor += region_rows
            t_idx = max(sub_cursor, 8)
            t_src = round_up(max(src_sublanes + 1, t_idx), 8)
            idx = np.full((t_src, LANES), t_src - 1, np.int32)
            reg_of_w = {w: (start, end) for (w, start, end) in regions}
            out_of_w = {}
            oc = 0
            for (w, start, end) in regions:
                out_of_w[w] = oc
                oc += (end - start) // w
            per_lane = {w: np.zeros(LANES, np.int64) for (w, _, _) in regions}
            new_slots = [[] for _ in range(r1 - r0)]
            for (rl, sl, w) in runs:
                j = rl % LANES
                p = int(per_lane[w][j])
                per_lane[w][j] += 1
                start, _ = reg_of_w[w]
                s0 = start + p * w
                for t, sb in enumerate(sl):
                    idx[s0 + t, j] = sb
                new_slots[rl].append(out_of_w[w] + p)
            levels.append(_LevelLayout(
                regions=tuple(regions), t_src=t_src, d_out=oc, final=False,
            ))
            arrays[f"idx{li}"] = idx
            total_slots += t_src * LANES
            slots = new_slots
            src_sublanes = oc
            li += 1

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


def launch_table(layouts) -> Tuple[np.ndarray, Tuple[int, ...], Tuple[int, ...], int,
                                   List[Tuple[int, int]]]:
    """The level launch table of csrc/sell.cu, from the layouts alone.

    Entries are (slab, level) pairs ordered by level depth, then slab. The
    sources and outputs of non-final levels live in one work buffer of
    128-wide rows: every slab's contrib stream first (slab order), then
    each non-final level's output in entry order; a final level writes the
    slab's rows at row0 / 128 of the dp. Returns (table, first entry of
    each depth, output rows of each depth, work rows, and per entry its
    (slab, level))."""
    a_off, off = [], 0
    for lay in layouts:
        a_off.append(off)
        off += lay.t_a
    depths = max(len(lay.levels) for lay in layouts)
    out_of, work = {}, off
    order = [(si, li) for li in range(depths) for si, lay in enumerate(layouts)
             if li < len(lay.levels)]
    for si, li in order:
        level = layouts[si].levels[li]
        if not level.final:
            out_of[si, li] = work
            work += level.d_out
    table = np.zeros((len(order), ENTRY_WORDS), np.int32)
    depth_entries, depth_rows = [0], []
    idx_off = 0
    rows_in_depth, cur = 0, 0
    for e, (si, li) in enumerate(order):
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
    return table, tuple(depth_entries), tuple(depth_rows), work, order


def assemble(slab_arrays, layouts, xrows: int, n_rows: int,
             device: torch.device) -> SellOperand:
    """The operand from per-slab NumPy arrays (int32 indices, values in the
    carrier type): the flat tensors on ``device``, each slab's arrays as
    views of them, and the launch table."""
    table, depth_entries, depth_rows, work, order = launch_table(layouts)

    def flat(parts):
        return torch.from_numpy(np.concatenate([np.asarray(a) for a in parts])).to(device)

    lanesel, vals, blocksel = (flat([a[key] for a in slab_arrays])
                               for key in ("lanesel", "vals", "blocksel"))
    idx = flat([slab_arrays[si][f"idx{li}"] for si, li in order])
    idx_off = {key: int(table[e, 4]) for e, key in enumerate(order)}
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
        table=torch.from_numpy(table).to(device), depth_entries=depth_entries,
        depth_rows=depth_rows, work_rows=work,
    )


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


def phase_a_cuda(op: SellOperand, x2d: torch.Tensor, sr: Semiring,
                 work: torch.Tensor) -> None:
    """Launch the phase-A kernel once over every slab's stream: the first
    rows of ``work`` become the contrib stream."""
    _check(op, sr, x2d, work)
    if x2d.shape != (op.xrows, LANES) or work.shape != (op.work_rows, LANES):
        raise ValueError(f"x2d must be ({op.xrows}, {LANES}) and work ({op.work_rows}, "
                         f"{LANES}), got {tuple(x2d.shape)} and {tuple(work.shape)}")
    index, codes, stream = _launch_args(op, sr)
    fn = _build.function("sell", "sh_sell_phase_a",
                         [ctypes.c_int] + [ctypes.c_void_p] * 5
                         + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    _build.check_launch("sell", fn(
        index, x2d.data_ptr(), op.lanesel.data_ptr(), op.vals.data_ptr(),
        op.blocksel.data_ptr(), work.data_ptr(), op.lanesel.shape[0], *codes, stream))
    _build.LAUNCHES["sell_phase_a"] += 1


def levels_cuda(op: SellOperand, sr: Semiring, work: torch.Tensor,
                dp: torch.Tensor) -> None:
    """Launch the level kernel once per level depth, over every slab that
    has that level: from the contrib stream in ``work`` to ``dp``."""
    _check(op, sr, work, dp)
    if work.shape != (op.work_rows, LANES) or dp.numel() != op.n_pad:
        raise ValueError(f"work must be ({op.work_rows}, {LANES}) and dp hold {op.n_pad} "
                         "rows")
    index, codes, stream = _launch_args(op, sr)
    fn = _build.function("sell", "sh_sell_level",
                         [ctypes.c_int] + [ctypes.c_void_p] * 4
                         + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    for d, rows in enumerate(op.depth_rows):
        e0, e1 = op.depth_entries[d], op.depth_entries[d + 1]
        _build.check_launch("sell", fn(
            index, op.table.data_ptr(), op.idx.data_ptr(), work.data_ptr(), dp.data_ptr(),
            e0, e1 - e0, rows, *codes, stream))
        _build.LAUNCHES["sell_level"] += 1


def sell_dp_cuda(op: SellOperand, x2d: torch.Tensor, sr: Semiring) -> torch.Tensor:
    """The carrier-typed dp (n_pad rows): one phase-A launch, then one level
    launch per depth. Raises on what the kernels do not take and on a
    refused launch."""
    carrier = _check(op, sr, x2d)
    work = torch.empty((op.work_rows, LANES), dtype=carrier, device=x2d.device)
    dp = torch.empty(op.n_pad, dtype=carrier, device=x2d.device)
    phase_a_cuda(op, x2d, sr, work)
    levels_cuda(op, sr, work, dp)
    return dp
