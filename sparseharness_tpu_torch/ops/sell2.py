"""The ``sell2`` variant: ragged and power-law rows, for any width of x.

:func:`build_sell2` runs the JAX package's gen-6 encoder: by default its
native core (formats/native_io.py: the sort and fold, the heavy-row split
and each slab's encode, two slabs at a time on a thread pool), else
(``SPARSEHARNESS_TPU_NATIVE=0``) the NumPy one; both give the same arrays
bit for bit, and the encode's padding guards refuse what JAX refuses. The
operand holds what the dp on its own device reads. :func:`make_plan`
makes the kernel's plan (:class:`Sell2Plan`) on the device from the
entries the encoder packs: every dp row's (column, value) pairs in row
order, rows longer than ``SPLIT_T`` striped over overflow pieces past
``base_pad``, and, where that brings more of the gathers into an SM's L1
(:func:`degree_rank`), the columns numbered by how many entries read them
(:func:`degree_order`). On a CUDA tensor
:func:`dp_sell2` launches ``csrc/sell2.cu`` over it: one launch, or two
where the plan orders x by degree. A CPU build also keeps the panels
(:class:`Sell2Panels`), which :func:`dp_sell2_plain`, a literal torch
replica of the TPU kernel's panel body, sweeps on any device.

Each row slab of up to ``SLAB_ROWS`` rows holds panels of 128 stream
sublanes × 128 lanes, one layout per (slab, bucket). Per panel, three
int32 words and one value per slot:

- ``chunk[p, 0:2]``: the two 16,384-column x chunks (or virtual chunks,
  ids ≥ ``n_chunks``) the panel's sublanes read;
- ``wordB[p·128 + s, l]``: lanesel (bits 0–6) and way (bit 29) of stream
  slot (s, l); blk1 (15–21), blk0 (22–28) and the chunk select (30) of
  sublane s in column s of every row; the lo route (lane 7–13, tile 14) of
  row-class s, out slot l;
- ``wordA[p·128 + l, j]``: the align sublanes a1 (0–6) and a2 (7–13) and
  the capture levels cap1 (14–17) and cap2 (18–21) of row-class l,
  aligned slot j; the hi route (lane 22–28, tile 29) of out slot 128 + j;
- ``vals[p·128 + s, l]``: the matrix value of slot (s, l), 0̄ on padding.

Slot (s, l) computes contrib = x ⊗ val with x taken from block
``blk_way`` of chunk ``chunk[p, csel]`` at lane ``lanesel``. A run of
row-class l is the ⊕ of contrib over an aligned block of ``2^(cap−1)``
slots, in the pairwise order of the TPU kernel's XOR butterfly, and each
out row (row0 + o·128 + l) ⊕-accumulates the run its route names, layout
by layout and panel by panel; the pieces are ⊕-folded into their owner
rows after the sweep.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sparseharness_tpu_torch.formats import native_io
from sparseharness_tpu_torch.formats.sparse import COO, fold_duplicates, round_up
from sparseharness_tpu_torch.ops import _build
from sparseharness_tpu_torch.ops.torch_ops import _SEGMENT_IDENTITY, _SEGMENT_REDUCE
from sparseharness_tpu_torch.semiring import Semiring
from sparseharness_tpu_torch.semiring.core import _carrier, _np_fold_for
from sparseharness_tpu_torch.utils.device import DeviceLike, resolve_device
from sparseharness_tpu_torch.utils.timing import add_span

LANES = 128
#: columns per x chunk (one (128, 128) tile of x)
CHUNK_COLS = LANES * LANES
#: usable stream sublanes per panel (127; sublane 127 is the identity row)
USABLE = LANES - 1
#: rows per output slab: out tile is (SLAB_ROWS/128, 128), ≤ 256 sublanes
SLAB_ROWS = 2 * LANES * LANES
#: per-(panel, lane) aligned-slot budget (slots 254/255 stay identity)
ALIGN_BUDGET = 254
#: refuse layouts whose packed slots exceed this multiple of nnz
PAD_BLOWUP_LIMIT = 24.0
#: absolute operand size cap (12 B/slot): refuse > 2 GiB of packed stream
SLOT_BYTE_CAP = 2 << 30
#: rows longer than this split into col-striped overflow pieces
SPLIT_T = 256
#: two-shelf packer: max forward pushes before placing on fresh ground
SHELF_MAX_PUSH = 64
#: two-shelf packer: holes remembered per shelf for backfilling
SHELF_MAX_HOLES = 64
#: two-shelf packer: placements probed inside one hole before giving up
SHELF_HOLE_TRIES = 32
#: chunks whose per-slab 1-way sublane demand is at most this are
#: virtualized: their blocks regroup into synthetic chunks so that light
#: segments from many chunks share panels
VIRT_DEMAND_T = 100
#: the kernel's bins, widest first: the lanes that take one dp row in each
#: (csrc/sell2.cu:kBinLanes), and the longest row each bin but the first
#: takes; the first takes the longer rows and every overflow piece
BIN_LANES = (32, 16, 8, 4, 2, 1)
BIN_MAX_LEN = (64, 32, 16, 8, 4)
#: threads of a block of the kernel (csrc/sell2.cu:kRowThreads)
ROW_THREADS = 256
#: the carrier values (4 B) that an SM's L1 holds at most: 256 KB
L1_COLS = 1 << 16
#: what the x copy costs a column, in the kernel's gathers: the order of x
#: pays where it brings more entries than this a column into x's first
#: L1_COLS columns (csrc/sell2.cu's note has the runs that set it)
X_COPY_GATHERS = 2
#: the most read columns of the ordered x, dealt over its first HOT_COLS / 32
#: cache lines of 128 bytes: rank r at line r mod (HOT_COLS / 32), word
#: r div (HOT_COLS / 32), so that the hottest each lead a line of their own
#: (csrc/sell2.cu's note has the runs that set it)
HOT_COLS = 1 << 14


class _SlabLayout(NamedTuple):
    row0: int       # first row (multiple of SLAB_ROWS)
    rows: int       # rows covered (multiple of 1024; out tile rows/128×128)
    panels: int     # panels of this layout (0 = empty slab)
    depth: int      # butterfly levels = log2(max run width)
    two_tiles: bool  # any aligned offset > 126 (align tile 2 in play)
    has_hi: bool    # any out slot ≥ 128 (hi route set in play)


#: the plan's tensors that the kernel reads, in csrc/sell2.cu:Sell2Plan's order
_LAUNCH_TENSORS = ("row_ptr", "row_dest", "cols", "vals", "owners", "piece_slot",
                   "owner_done", "col_perm")
_N_BINS = len(BIN_LANES)


class _Launch(ctypes.Structure):
    """The call's fixed arguments, as csrc/sell2.cu:Sell2Plan takes them."""

    _fields_ = ([(f, ctypes.c_void_p) for f in _LAUNCH_TENSORS]
                + [(f, ctypes.c_int * (_N_BINS + 1)) for f in ("bin_pos", "bin_block")]
                + [(f, ctypes.c_int) for f in ("n_final", "n_pieces", "n_perm", "val_dtype",
                                                "device")])


@dataclasses.dataclass(frozen=True, eq=False)
class Sell2Plan:
    """The kernel's plan: every dp row's entries in row order.

    The kernel walks positions: position i is dp row ``row_dest[i]`` or,
    where that is n_final or more, overflow piece ``row_dest[i] − n_final``,
    and its entries are ``cols[row_ptr[i]:row_ptr[i + 1]]`` (x columns)
    and the same stretch of ``vals`` (store type), in column order. The
    positions come in the kernel's bins, widest first (``bin_rows[k]``
    positions and ``bin_entries[k]`` entries in bin k; pieces first in bin
    0), each bin's rows ascending; then owner i's own row at position
    ``sum(bin_rows) + i``, in no bin. ``cols`` and ``vals`` are padded with
    column 0 and 0̄ to a multiple of 4, which no row reads. Owner row
    ``owners[i, 0]`` folds pieces [owners[i, 1], owners[i, 2]) after its
    own row, piece k belongs to ``owners[piece_slot[k]]``, and
    ``owner_done`` counts each owner's pieces during a call and is 0
    between calls, so calls on one operand run in stream order.

    Where the plan orders x by degree (:func:`degree_rank`), ``cols``
    are new column ids, ``col_perm[new] = old``, and a call first gathers
    x into that order; else ``col_perm`` is None and ``cols`` are x's."""

    row_ptr: torch.Tensor      # int32 (n_positions + O + 1,)
    row_dest: torch.Tensor     # int32 (n_positions + O,)
    cols: torch.Tensor         # int32 (n_slots,)
    vals: torch.Tensor         # store type (n_slots,)
    owners: torch.Tensor       # int32 (O, 3)
    piece_slot: torch.Tensor   # int32 (n_pieces,)
    owner_done: torch.Tensor   # int32 (O,), zeros
    col_perm: Optional[torch.Tensor]  # int32 (the matrix's columns,), or None
    bin_rows: Tuple[int, ...]
    bin_entries: Tuple[int, ...]
    n_entries: int             # the binned rows' entries and the owners' own
    n_final: int               # output rows: base_pad with pieces, else every slab's rows
    launch: _Launch

    @property
    def n_pieces(self) -> int:
        return int(self.piece_slot.numel())

    @property
    def store(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def x_order(self) -> str:
        """"degree" where a call gathers x into the plan's column order, else "as_is"."""
        return "as_is" if self.col_perm is None else "degree"

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    def to(self, device: DeviceLike) -> "Sell2Plan":
        """The same plan on ``device``, with the launch's arguments made there."""
        return _plan({f: _moved(getattr(self, f), device) for f in _LAUNCH_TENSORS},
                     self.bin_rows, self.bin_entries, self.n_entries, self.n_final)

    def __reduce__(self):
        # the launch holds this process's pointers: a pickled plan remakes it
        return _plan, ({f: getattr(self, f) for f in _LAUNCH_TENSORS}, self.bin_rows,
                       self.bin_entries, self.n_entries, self.n_final)


def _moved(t, device: DeviceLike):
    """``t.to(device)``, or None for None."""
    return None if t is None else t.to(device)


@dataclasses.dataclass(frozen=True, eq=False)
class Sell2Panels:
    """The JAX package's panel stream, which the plain version sweeps.

    ``slabs[i]`` is None for an empty slab, else a dict of ``chunk`` (P, 2)
    int32, ``wordA`` and ``wordB`` (P·128, 128) int32 and ``vals``
    (P·128, 128) in the store type, with ``layouts[i]``. ``virt_blocks``
    (n_virt, 128) int32 holds the global 128-column blocks of each virtual
    chunk, and ``piece_owner`` (Q,) int32 the owner row of each overflow
    piece."""

    slabs: list
    layouts: Tuple[_SlabLayout, ...]
    n_chunks: int
    virt_blocks: Optional[torch.Tensor]
    piece_owner: Optional[torch.Tensor]

    def to(self, device: DeviceLike) -> "Sell2Panels":
        slabs = [None if s is None else {k: v.to(device) for k, v in s.items()}
                 for s in self.slabs]
        return dataclasses.replace(self, slabs=slabs,
                                   virt_blocks=_moved(self.virt_blocks, device),
                                   piece_owner=_moved(self.piece_owner, device))


@dataclasses.dataclass(frozen=True, eq=False)
class Sell2Operand:
    """What the sell2 dp on the operand's device reads: the kernel's
    ``plan`` (None only where JAX's arrays were carried over by interop)
    and, built on the CPU, the ``panels`` (None on a card). ``n_rows`` is
    the matrix's, ``base_pad`` the dp row of the first overflow piece."""

    n_rows: int
    base_pad: int
    plan: Optional[Sell2Plan]
    panels: Optional[Sell2Panels]

    def to(self, device: DeviceLike) -> "Sell2Operand":
        """The same operand on ``device``: tensors moved, the launch made there."""
        return dataclasses.replace(self, plan=_moved(self.plan, device),
                                   panels=_moved(self.panels, device))


def _next_pow2(k: np.ndarray) -> np.ndarray:
    """Elementwise run width: next pow2 ≥ k (singletons stay width 1 —
    they capture before the butterfly, cap level 0)."""
    k = np.maximum(k, 1)
    return (1 << np.ceil(np.log2(k)).astype(np.int64)).astype(np.int64)


def _grouped_exclusive_cumsum(vals: np.ndarray, group_key: np.ndarray):
    """Exclusive cumsum of `vals` restarting at each change of (sorted)
    `group_key`."""
    cum = np.cumsum(vals) - vals
    starts = np.r_[0, 1 + np.nonzero(np.diff(group_key))[0]]
    start_of = np.zeros(len(vals), np.int64)
    start_of[starts] = np.r_[cum[starts][:1], np.diff(cum[starts])]
    return cum - np.cumsum(start_of)


def _twoshelf_pack(cnt: np.ndarray, native: bool = False):
    """Two-shelf interval packing of one chunk-pool's block lane histograms
    (cnt: n_blocks × 128) onto stream sublanes.

    Each block gets one contiguous interval of ``demand = max_l cnt[b, l]``
    sublanes on one of two shelves; a sublane is covered by at most one
    interval per shelf, so it carries at most two block bindings. Blocks
    are placed by demand descending at the shorter shelf's frontier, pushed
    forward until their per-lane piles fit the free cells; skipped spans
    are remembered as holes that later, smaller blocks backfill.

    Returns ``(n_sub, bind0, bind1, way, flat_sub)``: per-sublane local
    block ids per shelf (−1 = uncovered), per-block shelf bit, and the
    per-entry sublane ids in (block, lane, pile-pos) order. ``native``
    packs in the native library, with the same result."""
    if native:
        return native_io.sell2_pack(cnt, SHELF_MAX_PUSH, SHELF_MAX_HOLES, SHELF_HOLE_TRIES)
    demand = cnt.max(axis=1)
    order = np.argsort(-demand, kind="stable")
    order = order[demand[order] > 0]
    cap = int(demand.sum()) + SHELF_MAX_PUSH + 1
    occ = np.zeros((cap, LANES), bool)
    bind = [np.full(cap, -1, np.int64), np.full(cap, -1, np.int64)]
    way = np.zeros(cnt.shape[0], np.int8)
    placements: list = []
    frontier = [0, 0]
    holes: List[List[Tuple[int, int]]] = [[], []]

    def fits(o, d, h):
        return bool(np.all(d - occ[o:o + d].sum(axis=0) >= h))

    def place(bi, sh, o, d, h):
        for l in np.nonzero(h)[0]:
            rows = np.nonzero(~occ[o:o + d, l])[0][: h[l]]
            occ[o + rows, l] = True
            placements.append((bi, l, o + rows))
        bind[sh][o:o + d] = bi
        way[bi] = sh

    for bi in order:
        h = cnt[bi]
        d = int(demand[bi])
        placed = False
        for sh in (0, 1):
            hl = holes[sh]
            for k in range(len(hl)):
                h0, h1 = hl[k]
                if h1 - h0 < d:
                    continue
                o = h0
                tries = 0
                while o + d <= h1 and tries < SHELF_HOLE_TRIES:
                    if fits(o, d, h):
                        break
                    o += 1
                    tries += 1
                else:
                    continue
                place(bi, sh, o, d, h)
                new = []
                if o > h0:
                    new.append((h0, o))
                if o + d < h1:
                    new.append((o + d, h1))
                hl[k:k + 1] = new
                placed = True
                break
            if placed:
                break
        if placed:
            continue
        sh = 0 if frontier[0] <= frontier[1] else 1
        o = frontier[sh]
        pushes = 0
        while pushes < SHELF_MAX_PUSH:
            if fits(o, d, h):
                break
            o += 1
            pushes += 1
        else:
            o = max(frontier[0], frontier[1])   # fresh ground always fits
        if o > frontier[sh] and len(holes[sh]) < SHELF_MAX_HOLES:
            holes[sh].append((frontier[sh], o))
        place(bi, sh, o, d, h)
        frontier[sh] = o + d
    n_sub = max(frontier)
    flat = np.empty(int(cnt.sum()), np.int64)
    pstart = np.zeros(cnt.size + 1, np.int64)
    np.cumsum(cnt.reshape(-1), out=pstart[1:])
    for bi, l, rows in placements:
        s0 = int(pstart[bi * LANES + l])
        flat[s0:s0 + len(rows)] = rows
    return n_sub, bind[0][:n_sub], bind[1][:n_sub], way, flat


def _blowup_guard(slots: int, m: int, where: str = "") -> None:
    if (slots > PAD_BLOWUP_LIMIT * m and slots > (1 << 20)) or slots * 12 > SLOT_BYTE_CAP:
        raise NotImplementedError(
            f"sell2 padding blowup: {slots} packed slots for {m} nonzeros"
            f"{where}; use coo_seg/ell")


def _heavy_split(s: COO, vals_all: np.ndarray, n: int, base_pad: int):
    """(k_rows, k_cols, k_vals, piece_owner, n_tot): rows longer than
    SPLIT_T striped over overflow pieces past base_pad, in the final
    (row, col) order."""
    lens = np.bincount(s.rows, minlength=n).astype(np.int64)
    heavy = np.nonzero(lens > SPLIT_T)[0]
    if not heavy.size:
        return (s.rows.astype(np.int64), s.cols.astype(np.int64), vals_all, None, n)
    indptr0 = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=indptr0[1:])
    p_r = -(-lens[heavy] // SPLIT_T)                # pieces per row
    ov_off = np.cumsum(p_r) - p_r
    n_pieces = int(p_r.sum())
    piece_owner = np.repeat(heavy, p_r).astype(np.int32)
    rank = np.arange(s.nnz, dtype=np.int64) - indptr0[s.rows]
    is_h = lens[s.rows] > SPLIT_T
    hidx = np.searchsorted(heavy, s.rows[is_h])
    # entry j of a heavy row (col-sorted) → piece j % p_r: consecutive piece
    # ids cycle lanes mod 128 and stripe every block's pile
    rows_k_h = base_pad + ov_off[hidx] + rank[is_h] % p_r[hidx]
    # the (rows_k, col) order without a sort: light entries keep their
    # order and come first; rank r of a heavy row of length len over p
    # pieces (q = len // p, rr = len % p) lands at in-row position
    # (r % p)·q + min(r % p, rr) + r // p
    rk = rank[is_h]
    pe = p_r[hidx]
    le = lens[s.rows[is_h]]
    qe, rre = le // pe, le % pe
    j = rk % pe
    pos_in_row = j * qe + np.minimum(j, rre) + rk // pe
    hlens = lens[heavy]
    before = (np.cumsum(hlens) - hlens)[hidx]
    n_light = int(s.nnz - is_h.sum())
    target_h = n_light + before + pos_in_row
    k_rows = np.empty(s.nnz, np.int64)
    k_cols = np.empty(s.nnz, np.int64)
    k_vals = np.empty(s.nnz, vals_all.dtype)
    light = ~is_h
    k_rows[:n_light] = s.rows[light]
    k_cols[:n_light] = s.cols[light]
    k_vals[:n_light] = vals_all[light]
    k_rows[target_h] = rows_k_h
    k_cols[target_h] = s.cols[is_h]
    k_vals[target_h] = vals_all[is_h]
    return k_rows, k_cols, k_vals, piece_owner, base_pad + n_pieces


def _encode_slab(rows_e, cols_e, vals_e, n_chunks: int, virt_base: int, rows_slab: int,
                 virtual_chunks: bool, zero, vals_np_dtype, bucket_order: bool,
                 native: bool):
    """One slab's panels, as native_io.sell2_encode_slab gives them:
    ``(wordA, wordB, vals_arr, chunk_of_panel, p_depth, p_two, p_hi,
    virt_rows, bf_depth, two_tiles, has_hi, P)``, the slab's virtual chunks
    numbered from ``virt_base`` and the panels sorted stably by (depth
    group, two tiles) if ``bucket_order``."""
    m = len(rows_e)
    lane = rows_e % LANES
    chunk = cols_e // CHUNK_COLS
    blkc = (cols_e % CHUNK_COLS) // LANES
    col_lane = cols_e % LANES
    virt_rows: List[np.ndarray] = []

    # ---- virtual chunks: light chunk segments regroup under synthetic
    # chunk ids (light chunks have ≤ VIRT_DEMAND_T blocks by construction)
    if virtual_chunks:
        gb = cols_e // LANES                     # global block id
        gbu, gbi = np.unique(gb, return_inverse=True)
        cnt_b = np.zeros((len(gbu), LANES), np.int64)
        np.add.at(cnt_b, (gbi, lane), 1)
        dem_b = cnt_b.max(axis=1)                # per-block demand
        chu = gbu // LANES
        dem_c = np.zeros(int(chu.max()) + 1, np.int64)
        np.add.at(dem_c, chu, dem_b)
        light_b = dem_c[chu] <= VIRT_DEMAND_T
        if np.unique(chu[light_b]).size >= 2:
            lb = np.nonzero(light_b)[0]
            # deal blocks demand-desc round-robin across the pools, so every
            # pool gets the full heavy→light spectrum
            lb = lb[np.argsort(-dem_b[lb], kind="stable")]
            npools = -(-lb.size // LANES)
            pool_of = np.arange(lb.size) % npools
            lb = lb[np.argsort(pool_of, kind="stable")]
            sizes = np.bincount(pool_of, minlength=npools)
            vid_pool = np.repeat(np.arange(npools), sizes)
            echunk = chu.copy()
            eblk = (gbu % LANES).astype(np.int64)
            echunk[lb] = virt_base + vid_pool
            eblk[lb] = np.concatenate([np.arange(c, dtype=np.int64) for c in sizes])
            o = 0
            for c in sizes:
                row = np.zeros(LANES, np.int32)
                ids = gbu[lb[o:o + int(c)]]
                row[: len(ids)] = ids.astype(np.int32)
                virt_rows.append(row)
                o += int(c)
            chunk = echunk[gbi]
            blkc = eblk[gbi]

    # ---- phase A packing: entries sorted (chunk, blk, lane) --------------
    order = np.lexsort((lane, blkc, chunk))
    och, obl, oln = chunk[order], blkc[order], lane[order]
    key_cb = och * LANES + obl
    cb_u, cb_inv = np.unique(key_cb, return_inverse=True)
    cnt_cbl = np.zeros((len(cb_u), LANES), np.int64)
    np.add.at(cnt_cbl, (cb_inv, oln), 1)
    cb_chunk = cb_u // LANES

    # two-shelf interval packing per chunk-pool
    pool_ids = np.unique(cb_chunk)
    packs = []
    pool_nsub = np.zeros(len(pool_ids), np.int64)
    for ci, ch in enumerate(pool_ids):
        sel = np.nonzero(cb_chunk == ch)[0]
        pk = _twoshelf_pack(cnt_cbl[sel], native)
        packs.append((sel,) + pk)
        pool_nsub[ci] = pk[0]

    # chunk-major stream packed contiguously across chunk boundaries: a
    # panel mixes sublanes of at most two chunks, so a segment start moves
    # to the next panel only when its start panel already touches two;
    # segments are laid longest first
    seg_start = np.zeros(len(pool_ids), np.int64)
    panel_touch: List[List[int]] = []
    q = 0
    for ci in np.argsort(-pool_nsub, kind="stable"):
        if pool_nsub[ci] == 0:
            seg_start[ci] = q
            continue
        p0 = q // USABLE
        if p0 < len(panel_touch) and len(panel_touch[p0]) >= 2:
            q = (p0 + 1) * USABLE
        seg_start[ci] = q
        q_end = q + int(pool_nsub[ci])
        for pp in range(q // USABLE, (q_end - 1) // USABLE + 1):
            while len(panel_touch) <= pp:
                panel_touch.append([])
            panel_touch[pp].append(int(pool_ids[ci]))
        q = q_end
    P = (q + USABLE - 1) // USABLE
    while len(panel_touch) < P:
        panel_touch.append([])

    # per entry: stream slot from the packer's pile placements
    ent_pool = np.searchsorted(pool_ids, cb_chunk)[cb_inv]
    pool_cnt = np.bincount(ent_pool, minlength=len(pool_ids))
    pool_start = np.zeros(len(pool_ids) + 1, np.int64)
    np.cumsum(pool_cnt, out=pool_start[1:])
    g_abs = np.empty(m, np.int64)
    way_e = np.empty(m, np.int8)
    for ci, (sel, n_sub, b0, b1, way_b, flat) in enumerate(packs):
        e0p, e1p = int(pool_start[ci]), int(pool_start[ci + 1])
        g_abs[e0p:e1p] = seg_start[ci] + flat
        lb_e = np.searchsorted(sel, cb_inv[e0p:e1p])
        way_e[e0p:e1p] = way_b[lb_e]
    panel = g_abs // USABLE
    s_sub = g_abs % USABLE

    slots = P * LANES * LANES
    _blowup_guard(slots, m, " in a slab")

    # ---- phase B: runs = (panel, row) groups -----------------------------
    orow = rows_e[order]
    key_pr = panel * SLAB_ROWS + orow
    order2 = np.argsort(key_pr, kind="stable")
    kpr2 = key_pr[order2]
    rstarts = np.r_[0, 1 + np.nonzero(np.diff(kpr2))[0]]
    rid2 = np.zeros(m, np.int64)
    rid2[rstarts[1:]] = 1
    rid2 = np.cumsum(rid2)
    t_in_run = np.arange(m, dtype=np.int64) - rstarts[rid2]
    n_runs = len(rstarts)
    run_len = np.diff(np.r_[rstarts, m])
    run_panel = panel[order2][rstarts]
    run_row = orow[order2][rstarts]
    run_lane = run_row % LANES
    run_out = run_row // LANES
    run_w = _next_pow2(run_len)
    run_level = np.log2(run_w).astype(np.int32)    # capture level 0..7

    # aligned offsets: per (panel, lane), runs sorted by width desc
    order3 = np.lexsort((-run_w, run_lane, run_panel))
    key_pl3 = run_panel[order3] * LANES + run_lane[order3]
    off3 = _grouped_exclusive_cumsum(run_w[order3], key_pl3)
    if n_runs and int((off3 + run_w[order3]).max()) > ALIGN_BUDGET:
        raise AssertionError("sell2 internal: aligned budget exceeded")
    run_off = np.zeros(n_runs, np.int64)
    run_off[order3] = off3
    bf_depth = int(run_level.max(initial=0))
    # lane 126/127 of the identity-route tile must stay un-captured
    two_tiles = bool((run_off + run_w).max(initial=0) > 126)
    has_hi = bool(run_out.max(initial=0) >= 128) or rows_slab > 16384

    # ---- array fills -----------------------------------------------------
    vals_arr = np.full((P * LANES, LANES), zero, vals_np_dtype)
    # wordA default: align → identity sublane 127, cap 0 (never capture),
    # hi route = identity (lane 126 of the last align tile)
    id_tile = 1 if two_tiles else 0
    wordA = np.full((P * LANES, LANES),
                    127 | (127 << 7) | (126 << 22) | (id_tile << 29), np.int32)
    # wordB default: lanesel 0, lo route = identity, blk 0, way 0
    wordB = np.full((P * LANES, LANES), (126 << 7) | (id_tile << 14), np.int32)
    # the ≤ 2 chunks touching each panel (single-chunk panels twice)
    chunk_of_panel = np.zeros((P, 2), np.int32)
    for pp, touch in enumerate(panel_touch):
        if touch:
            chunk_of_panel[pp, 0] = touch[0]
            chunk_of_panel[pp, 1] = touch[1] if len(touch) > 1 else touch[0]

    flatA = panel * LANES + s_sub                  # stream row index
    vals_arr[flatA, oln] = vals_e[order]
    # lanesel (bits 0-6) + way (bit 29) at [stream-sublane, lane]
    wordB[flatA, oln] |= (col_lane[order].astype(np.int32)
                          | (way_e.astype(np.int32) << 29))
    # blk0/blk1 (bits 22-28 / 15-21) + chunk select (bit 30) at
    # [*, stream-sublane], from the packer's per-sublane shelf bindings
    blk0_of_sub = np.zeros((P, LANES), np.int32)
    blk1_of_sub = np.zeros((P, LANES), np.int32)
    csel_of_sub = np.zeros((P, LANES), np.int32)
    for ci, (sel, n_sub, b0, b1, _w, _flat) in enumerate(packs):
        if n_sub == 0:
            continue
        g = seg_start[ci] + np.arange(n_sub)
        sp_panel = g // USABLE
        sp_sub = g % USABLE
        blks = (cb_u[sel] % LANES).astype(np.int32)
        v0 = np.where(b0 >= 0, blks[np.maximum(b0, 0)], -1)
        v1 = np.where(b1 >= 0, blks[np.maximum(b1, 0)], -1)
        blk0_of_sub[sp_panel, sp_sub] = np.where(v0 >= 0, v0, np.maximum(v1, 0))
        blk1_of_sub[sp_panel, sp_sub] = np.where(v1 >= 0, v1, np.maximum(v0, 0))
        csel_of_sub[sp_panel, sp_sub] = (
            pool_ids[ci] == chunk_of_panel[sp_panel, 1]).astype(np.int32)
    wordB |= np.repeat(
        ((blk0_of_sub << 22) | (blk1_of_sub << 15) | (csel_of_sub << 30))[:, None, :],
        LANES, axis=1).reshape(P * LANES, LANES)

    # align: aligned slot j of a row-class ← stream sublane
    j = run_off[rid2] + t_in_run                   # per entry (order2)
    lane2 = lane[order][order2]
    s2 = s_sub[order2]
    p2 = panel[order2]
    lo = j < LANES
    rowA = p2 * LANES + lane2
    iA1 = (rowA[lo], j[lo])
    wordA[iA1] = (wordA[iA1] & ~np.int32(127)) | s2[lo].astype(np.int32)
    hi = ~lo
    iA2 = (rowA[hi], j[hi] - LANES)
    wordA[iA2] = (wordA[iA2] & ~np.int32(127 << 7)) | (s2[hi].astype(np.int32) << 7)

    # capture levels at [row-class, run offset], stored as level + 1
    rowR = run_panel * LANES + run_lane
    f_lo = run_off < LANES
    iC1 = (rowR[f_lo], run_off[f_lo])
    wordA[iC1] |= (run_level[f_lo] + 1) << 14
    f_hi = ~f_lo
    iC2 = (rowR[f_hi], run_off[f_hi] - LANES)
    wordA[iC2] |= (run_level[f_hi] + 1) << 18

    # routes at [row-class, out-slot]: lo in wordB (o < 128), hi in wordA
    route_lane = (run_off % LANES).astype(np.int32)
    route_tile = (run_off // LANES).astype(np.int32)
    o_lo = run_out < LANES
    iRlo = (rowR[o_lo], run_out[o_lo])
    wordB[iRlo] = (wordB[iRlo] & ~np.int32((127 << 7) | (1 << 14))) | (
        (route_lane[o_lo] << 7) | (route_tile[o_lo] << 14))
    o_hi = ~o_lo
    iRhi = (rowR[o_hi], run_out[o_hi] - LANES)
    wordA[iRhi] = (wordA[iRhi] & ~np.int32((127 << 22) | (1 << 29))) | (
        (route_lane[o_hi] << 22) | (route_tile[o_hi] << 29))

    # each panel's static needs: butterfly depth, two align tiles, hi routes
    p_depth = np.zeros(P, np.int64)
    np.maximum.at(p_depth, run_panel, run_level.astype(np.int64))
    p_end = np.zeros(P, np.int64)
    np.maximum.at(p_end, run_panel, run_off + run_w)
    p_two = p_end > 126
    p_hi = np.zeros(P, bool)
    np.logical_or.at(p_hi, run_panel, run_out >= LANES)
    if bucket_order:
        order = np.argsort(_bucket_key(p_depth, p_two), kind="stable")
        rows = (order[:, None] * LANES + np.arange(LANES)).reshape(-1)
        wordA, wordB, vals_arr = wordA[rows], wordB[rows], vals_arr[rows]
        chunk_of_panel = chunk_of_panel[order]
        p_depth, p_two, p_hi = p_depth[order], p_two[order], p_hi[order]
    vrows = np.stack(virt_rows) if virt_rows else np.zeros((0, LANES), np.int32)
    return (wordA, wordB, vals_arr, chunk_of_panel, p_depth, p_two, p_hi, vrows,
            bf_depth, two_tiles, has_hi, P)


def _bucket_key(p_depth: np.ndarray, p_two: np.ndarray) -> np.ndarray:
    """A panel's call bucket: depth group {0}, {1, 2}, {3+} × two tiles."""
    dgrp = np.where(p_depth == 0, 0, np.where(p_depth <= 2, 1, 2))
    return dgrp * 2 + p_two.astype(np.int64)


def _stored(vals: np.ndarray, store: torch.dtype) -> np.ndarray:
    """Values as the slabs store them, for the native encode: bf16 as its
    16-bit patterns (rounded in torch, to nearest even), others as they are."""
    if store != torch.bfloat16:
        return vals
    t = torch.from_numpy(np.ascontiguousarray(vals, np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy()


def _as_store(vals: np.ndarray, store: torch.dtype) -> torch.Tensor:
    """Host values as a tensor of the store type, rounded as :func:`_stored`
    rounds them; int16 values are the bf16 patterns of the native encode."""
    v = torch.from_numpy(np.ascontiguousarray(vals))
    return v.view(store) if v.dtype == torch.int16 else v.to(store)


def _device_slab(chunk, wordA, wordB, vals, store: torch.dtype,
                 device: torch.device) -> dict:
    return {"chunk": torch.from_numpy(np.ascontiguousarray(chunk)).to(device),
            "wordA": torch.from_numpy(np.ascontiguousarray(wordA)).to(device),
            "wordB": torch.from_numpy(np.ascontiguousarray(wordB)).to(device),
            "vals": _as_store(vals, store).to(device)}


@dataclasses.dataclass
class EncodeRecord:
    """What a :func:`build_sell2` call did on the host: whether it took
    the native path, its seconds by stage (``fold+rowsort``,
    ``heavy-split``, ``native-submit``, ``native-slab`` waiting on the pool,
    ``numpy-slab``, ``bucket+upload``, ``plan``), and the slabs the native
    encode refused, which ran the NumPy body."""

    native: bool = False
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    numpy_slabs: int = 0

    def mark(self, stage: str, t0: int, **attrs) -> int:
        """Add the time since ``t0`` (``perf_counter_ns``) to ``stage``, and
        record that stretch as a ``build.encode`` span with ``attrs``;
        returns now."""
        now = time.perf_counter_ns()
        self.seconds[stage] = self.seconds.get(stage, 0.0) + (now - t0) / 1e9
        add_span("build.encode", t0, now, stage=stage, **attrs)
        return now


def build_sell2(coo: COO, sr: Semiring, value_dtype: str = "float32",
                split_calls: bool = True, virtual_chunks: bool = True, *,
                device: DeviceLike = None,
                record: Optional[EncodeRecord] = None) -> Sell2Operand:
    """Pack a COO matrix into the panel stream, as the JAX package's encoder
    does, and make the kernel's plan on ``device`` from the entries packed.
    The panels are kept only for a CPU operand: the kernel reads the plan.

    ``split_calls``: bucket each slab's panels by (butterfly depth group
    {0}, {1, 2}, {3+}; two align tiles), one layout per bucket, so that
    layouts share a row0. ``virtual_chunks``: regroup blocks of light chunk
    segments into virtual chunks. bf16 values are rounded from float32 in
    torch, to nearest even, as ml_dtypes rounds them. The encode is native
    unless SPARSEHARNESS_TPU_NATIVE=0 (a library that cannot be built
    raises NativeUnavailable). A ``record`` passed in is filled with the
    host seconds by stage and the slabs the native encode refused."""
    device = resolve_device(device)
    native = native_io.enabled()
    if native:
        native_io.load()  # builds the library on first use, outside the stage clocks
    keep_panels = device.type == "cpu"
    rec = EncodeRecord() if record is None else record
    rec.native = native
    t = time.perf_counter_ns()
    n, c = coo.shape
    _, _, _, _, zero, as_int = _carrier(sr)
    np_dtype = np.dtype(np.int32) if as_int else sr.np_dtype
    bf16 = not as_int and value_dtype == "bfloat16"
    store = torch.bfloat16 if bf16 else (torch.int32 if as_int else sr.dtype)
    zero = np.asarray(zero, np_dtype)

    fold = _np_fold_for(sr, as_int)
    if native:
        s = native_io.sell2_sort_fold(coo, fold.__name__)
    else:
        s = fold_duplicates(coo, fold).sorted_by_row()
    with np.errstate(invalid="ignore"):
        vals_all = s.vals if not as_int else (s.vals != 0).astype(np.int32)
        vals_all = vals_all.astype(np_dtype)
    t = rec.mark("fold+rowsort", t)

    base_pad = round_up(max(n, 1), 1024)
    if native:
        k_rows, k_cols, k_vals, piece_owner, n_pieces = native_io.sell2_heavy_split(
            s, vals_all, base_pad, SPLIT_T)
        n_tot = base_pad + n_pieces if n_pieces else n
    else:
        k_rows, k_cols, k_vals, piece_owner, n_tot = _heavy_split(s, vals_all, n, base_pad)
    t = rec.mark("heavy-split", t)
    n_pad = round_up(max(n_tot, 1), 1024)
    n_chunks = round_up(max(c, 1), CHUNK_COLS) // CHUNK_COLS
    indptr = np.zeros(n_tot + 1, np.int64)
    np.cumsum(np.bincount(k_rows, minlength=n_tot), out=indptr[1:])
    slab_ranges = []  # (row0, rows, first entry, end entry)
    for r0 in range(0, n_pad, SLAB_ROWS):
        rows_slab = min(SLAB_ROWS, n_pad - r0)
        slab_ranges.append((r0, rows_slab, int(indptr[min(r0, n_tot)]),
                      int(indptr[min(r0 + rows_slab, n_tot)])))

    slabs: list = []
    layouts: List[_SlabLayout] = []
    total_slots = 0
    virt_rows: List[np.ndarray] = []
    # the native encode runs two slabs at a time (the ctypes call drops the
    # GIL); each slab numbers its virtual chunks from n_chunks, and they are
    # moved past the earlier slabs' ones as the results come in slab order
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=2) if native else None
    try:
        futures = {}
        if native:
            vals_store, zero_store = _stored(k_vals, store), _stored(zero.reshape(1), store)
            for r0, rows_slab, e0, e1 in slab_ranges:
                if e1 > e0:
                    futures[r0] = pool.submit(
                        native_io.sell2_encode_slab, k_rows[e0:e1] - r0, k_cols[e0:e1],
                        vals_store[e0:e1], zero_store, n_chunks, n_chunks, rows_slab,
                        virtual_chunks, SHELF_MAX_PUSH, SHELF_MAX_HOLES, SHELF_HOLE_TRIES,
                        VIRT_DEMAND_T, split_calls)
            t = rec.mark("native-submit", t)
        for r0, rows_slab, e0, e1 in slab_ranges:
            if e1 == e0:
                layouts.append(_SlabLayout(r0, rows_slab, 0, 1, False, False))
                slabs.append(None)
                continue
            res = futures[r0].result() if native else None
            if res is not None:
                t = rec.mark("native-slab", t)
            else:
                # the NumPy body: SPARSEHARNESS_TPU_NATIVE=0, or a slab
                # that the native encode refused (past the align budget)
                if native:
                    rec.numpy_slabs += 1
                res = _encode_slab(k_rows[e0:e1] - r0, k_cols[e0:e1], k_vals[e0:e1],
                                   n_chunks, n_chunks, rows_slab, virtual_chunks, zero,
                                   np_dtype, split_calls, native)
                t = rec.mark("numpy-slab", t)
            (wordA, wordB, vals_arr, chunk_of_panel, p_depth, p_two, p_hi, vrows, bf_depth,
             two_tiles, has_hi, P) = res
            if len(vrows):
                chunk_of_panel[chunk_of_panel >= n_chunks] += len(virt_rows)
                virt_rows.extend(vrows)
            total_slots += P * LANES * LANES
            _blowup_guard(P * LANES * LANES, e1 - e0, " in a slab")
            if keep_panels and not split_calls:
                slabs.append(_device_slab(chunk_of_panel, wordA, wordB, vals_arr, store,
                                          device))
                layouts.append(_SlabLayout(r0, rows_slab, P, bf_depth, two_tiles, has_hi))
            elif keep_panels:
                # panels come bucket-ordered: one layout per run of a bucket
                bounds = np.flatnonzero(np.diff(_bucket_key(p_depth, p_two))) + 1
                for p0, p1 in zip(np.r_[0, bounds], np.r_[bounds, P]):
                    p0, p1 = int(p0), int(p1)
                    rows = slice(p0 * LANES, p1 * LANES)
                    slabs.append(_device_slab(chunk_of_panel[p0:p1], wordA[rows],
                                              wordB[rows], vals_arr[rows], store, device))
                    layouts.append(_SlabLayout(
                        r0, rows_slab, p1 - p0, int(p_depth[p0:p1].max()),
                        bool(p_two[p0:p1].any()),
                        bool(p_hi[p0:p1].any()) or rows_slab > 16384))
            t = rec.mark("bucket+upload", t)
    finally:
        if pool is not None:
            # a guard that raises mid-build cancels the slabs not yet started
            pool.shutdown(wait=False, cancel_futures=True)

    _blowup_guard(total_slots, max(s.nnz, 1))
    if k_cols.size and int(k_cols.max()) >= 1 << 31:
        raise ValueError("sell2: x is too long for the kernel's int32 columns")
    owner = (torch.from_numpy(piece_owner).to(device)
             if piece_owner is not None else None)
    # the entries go to the device as arguments alone, so that make_plan frees them
    plan = make_plan(torch.from_numpy(k_rows.astype(np.int32)).to(device),
                     torch.from_numpy(k_cols.astype(np.int32)).to(device),
                     _as_store(k_vals, store).to(device),
                     _as_store(zero.reshape(1), store).to(device), owner, base_pad, n_pad, c)
    panels = None
    if keep_panels:
        virt = torch.from_numpy(np.stack(virt_rows)).to(device) if virt_rows else None
        panels = Sell2Panels(slabs, tuple(layouts), n_chunks, virt, owner)
    # how often each of the kernel's paths engages, and the share of the
    # entries whose column lies in the first 256 KB of the x that they read
    n_hot = int((plan.cols[:plan.n_entries] < L1_COLS).sum())
    rec.mark("plan", t, bin_rows=list(plan.bin_rows),
             bin_entries=list(plan.bin_entries), pieces=plan.n_pieces,
             x_order=plan.x_order, hot_share=n_hot / max(plan.n_entries, 1))
    return Sell2Operand(n, base_pad, plan, panels)


def degree_rank(cols: torch.Tensor, n_cols: int) -> Optional[torch.Tensor]:
    """x's columns by how many of the int32 ``cols`` (each below
    ``n_cols``) read each, the most read first and ties in column order
    (int64), where the plan gathers x in that order; else None. The order
    pays where it brings more than ``X_COPY_GATHERS`` entries a column of
    x into x's first ``L1_COLS`` columns, which an SM's L1 can hold: more
    of the kernel's gathers than the copy costs. So never where x fits in
    L1, nor where the columns are numbered by how often they are read
    already, nor where they are read too few times to pay for the copy."""
    if n_cols <= L1_COLS:
        return None
    counts = torch.bincount(cols, minlength=n_cols)
    by_rank = torch.sort(counts, descending=True, stable=True).indices
    moved = int(counts[by_rank[:L1_COLS]].sum()) - int(counts[:L1_COLS].sum())
    return by_rank if moved > X_COPY_GATHERS * n_cols else None


def hot_layout(n_cols: int, device: Optional[torch.device] = None) -> torch.Tensor:
    """The new column of each degree rank (int64, a permutation of
    ``n_cols``, on ``device``, by default the CPU): the first ``HOT_COLS``
    ranks (fewer where x is shorter) dealt one to a 32-column line in
    turn, the rest in rank order."""
    lines = min(HOT_COLS, n_cols) // 32
    pos = torch.arange(n_cols, device=device)
    if lines:
        hot = pos[:lines * 32]
        pos[:lines * 32] = hot % lines * 32 + hot // lines
    return pos


def degree_order(cols: torch.Tensor, by_rank: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(new_cols, col_perm)``: the int32 columns ``cols`` renumbered by
    their rank in ``by_rank`` (:func:`degree_rank`), laid out by
    :func:`hot_layout`, with ``col_perm[new] = old`` (int32). The map stays
    in int32, so no 64-bit copy of the entries is made beside them."""
    device, n_cols = cols.device, by_rank.numel()
    pos = hot_layout(n_cols, device)
    col_perm = torch.empty(n_cols, dtype=torch.int32, device=device)
    col_perm[pos] = by_rank.to(torch.int32)
    new_id = torch.empty(n_cols, dtype=torch.int32, device=device)
    new_id[by_rank] = pos.to(torch.int32)
    return new_id.index_select(0, cols), col_perm


def make_plan(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
              zero: torch.Tensor, piece_owner: Optional[torch.Tensor], base_pad: int,
              n_pad: int, n_cols: int) -> Sell2Plan:
    """The kernel's plan, made once in torch on the entries' device, with
    the launch's arguments. The entries are each (dp row, x column) once:
    ``rows`` int32 below ``n_pad``, row ``base_pad + k`` being overflow
    piece k of owner row ``piece_owner[k]``; ``cols`` int32 below
    ``n_cols``, the matrix's columns, renumbered by :func:`degree_order`
    where :func:`degree_rank` says so; ``vals`` in the store type, whose 0̄ is
    ``zero`` (one element). Each temporary is dropped once used: on the
    card they set the build's peak memory."""
    device = rows.device
    n_entries = rows.numel()
    if n_entries >= (1 << 31) - 4:
        raise ValueError("sell2: too many entries for the kernel's int32 row pointers")
    col_perm = None
    by_rank = degree_rank(cols, n_cols)
    if by_rank is not None:
        cols, col_perm = degree_order(cols, by_rank)
        del by_rank
    counts = torch.bincount(rows.long(), minlength=n_pad)

    # the positions: pieces, then every output row that is no owner, in
    # bins; then the owners' own rows, which their folds reduce
    if piece_owner is not None:
        n_final, n_pieces = base_pad, int(piece_owner.numel())
        owner_rows = piece_owner.long()
        piece_ptr = torch.zeros(base_pad + 1, dtype=torch.int64, device=device)
        torch.cumsum(torch.bincount(owner_rows, minlength=base_pad), 0, out=piece_ptr[1:])
        own = torch.nonzero(piece_ptr[1:] > piece_ptr[:-1]).flatten()
        owners = torch.stack([own, piece_ptr[own], piece_ptr[own + 1]], 1)
        piece_slot = torch.repeat_interleave(torch.arange(own.numel(), device=device),
                                             owners[:, 2] - owners[:, 1])
        kept = torch.ones(n_final, dtype=torch.bool, device=device)
        kept[own] = False
        out_rows = torch.nonzero(kept).flatten()
        pieces = torch.arange(n_pieces, device=device)
        pos_row = torch.cat([base_pad + pieces, out_rows])
        dest = torch.cat([n_final + pieces, out_rows])
        del piece_ptr, kept, out_rows, pieces
    else:
        n_final, n_pieces = n_pad, 0
        pos_row = dest = torch.arange(n_pad, device=device)
        own = torch.zeros(0, dtype=torch.int64, device=device)
        owners = torch.zeros((0, 3), dtype=torch.int64, device=device)
        piece_slot = torch.zeros(0, dtype=torch.int64, device=device)
    plen = counts[pos_row]
    bins = torch.zeros_like(plen)
    for m in BIN_MAX_LEN:
        bins += plen <= m
    bins[:n_pieces] = 0
    order = torch.sort(bins, stable=True).indices
    pos_row, dest, plen, bins = pos_row[order], dest[order], plen[order], bins[order]
    bin_rows = torch.bincount(bins, minlength=_N_BINS).tolist()
    bin_entries = torch.zeros(_N_BINS, dtype=torch.int64, device=device).index_add_(
        0, bins, plen).tolist()
    del order, bins
    pos_row, dest = torch.cat([pos_row, own]), torch.cat([dest, own])
    plen = torch.cat([plen, counts[own]])
    del counts, own
    rank = torch.full((n_pad,), -1, dtype=torch.int64, device=device)
    rank[pos_row] = torch.arange(pos_row.numel(), device=device)
    del pos_row

    # the entries in position order, each row's by column
    key = rank[rows.long()]
    del rows, rank
    if n_entries and int(key.min()) < 0:
        raise ValueError("sell2: an entry lies in a row that no position holds")
    key.bitwise_left_shift_(31).bitwise_or_(cols)
    del cols
    key, idx = torch.sort(key)
    vals = vals[idx]
    del idx
    cols = (key & 0x7FFFFFFF).to(torch.int32)
    del key
    pad = -n_entries % 4
    if pad:
        cols = torch.cat([cols, torch.zeros(pad, dtype=torch.int32, device=device)])
        vals = torch.cat([vals, zero.expand(pad)])
    row_ptr = torch.zeros(plen.numel() + 1, dtype=torch.int64, device=device)
    torch.cumsum(plen, 0, out=row_ptr[1:])
    del plen
    tensors = dict(
        row_ptr=row_ptr.to(torch.int32),
        row_dest=dest.to(torch.int32),
        cols=cols,
        vals=vals,
        owners=owners.to(torch.int32).contiguous(),
        piece_slot=piece_slot.to(torch.int32),
        owner_done=torch.zeros(owners.shape[0], dtype=torch.int32, device=device),
        col_perm=col_perm,
    )
    return _plan(tensors, bin_rows, bin_entries, n_entries, n_final)


def _plan(tensors: Dict[str, torch.Tensor], bin_rows, bin_entries, n_entries: int,
          n_final: int) -> Sell2Plan:
    """The plan of ``tensors`` (``_LAUNCH_TENSORS``, on one device), with the
    launch's arguments made for them."""
    bin_pos, bin_block = [0], [0]
    for k, lanes in enumerate(BIN_LANES):
        bin_pos.append(bin_pos[-1] + bin_rows[k])
        bin_block.append(bin_block[-1] + -(-bin_rows[k] * lanes // ROW_THREADS))
    device = tensors["row_ptr"].device
    n_bins = ctypes.c_int * (_N_BINS + 1)
    perm = tensors["col_perm"]
    launch = _Launch(*(None if tensors[f] is None else tensors[f].data_ptr()
                       for f in _LAUNCH_TENSORS), n_bins(*bin_pos),
                     n_bins(*bin_block), n_final, int(tensors["piece_slot"].numel()),
                     0 if perm is None else int(perm.numel()),
                     _build.STRIP_CODES[tensors["vals"].dtype], device.index or 0)
    return Sell2Plan(bin_rows=tuple(bin_rows), bin_entries=tuple(bin_entries),
                     n_entries=n_entries, n_final=n_final, launch=launch, **tensors)


def dp_sell2(op: Sell2Operand, x: torch.Tensor, sr: Semiring, *,
             n_rows: int) -> torch.Tensor:
    """⊕-reduced row dot-products over the padded row space (``base_pad``
    rows when heavy rows were split, else every slab's rows), in the
    carrier type (int32 for or_and), as the JAX package's dp_sell2. On a
    CUDA tensor this launches the kernel; on a CPU tensor it runs the plain
    version."""
    if x.device.type == "cpu":
        return dp_sell2_plain(op, x, sr, n_rows=n_rows)
    return sell2_dp_cuda(op, x, sr)


def _x_tiles(panels: Sell2Panels, x: torch.Tensor, sr: Semiring) -> torch.Tensor:
    """x padded with 0̄ to whole chunks in the carrier type, as
    (chunks + virtual chunks, 128, 128) tiles with tile[c, l, b] = x of
    block b, lane l."""
    carrier = _carrier(sr)[0]
    c_pad = panels.n_chunks * CHUNK_COLS
    x_pad = torch.full((c_pad,), sr.zero, dtype=sr.dtype, device=x.device)
    x_pad[: x.shape[0]] = x.to(sr.dtype)
    x_pad = x_pad.to(carrier)
    tiles = x_pad.view(panels.n_chunks, LANES, LANES).transpose(1, 2)
    if panels.virt_blocks is not None:
        vt = x_pad.view(-1, LANES)[panels.virt_blocks.long()]     # (n_v, blocks, lanes)
        tiles = torch.cat([tiles, vt.transpose(1, 2)])
    return tiles


def _panel_sweep(slab: dict, lay: _SlabLayout, xt: torch.Tensor,
                 sr: Semiring) -> torch.Tensor:
    """The TPU kernel's panel body, batched over the layout's panels, then
    its out tile ⊕-accumulated panel by panel from 0̄: (rows/128, 128)."""
    _, add, mul, _, zero, _ = _carrier(sr)
    P, d_out = lay.panels, lay.rows // LANES
    wb = slab["wordB"].view(P, LANES, LANES)
    wa = slab["wordA"].view(P, LANES, LANES)
    vals = slab["vals"].view(P, LANES, LANES)
    chunk = slab["chunk"].long()
    xa, xb = xt[chunk[:, 0]], xt[chunk[:, 1]]

    def take(src, idx):
        return torch.take_along_dim(src, idx.long(), dim=2)

    # staging: staged_w[s, l'] = x tile of the sublane's chunk at (l', blk_w)
    csel = (wb >> 30) & 1
    staged = [torch.where(csel == 0, take(xa, b), take(xb, b)).transpose(1, 2)
              for b in ((wb >> 22) & 127, (wb >> 15) & 127)]
    # phase A: per-way x element pick, way select, ⊗
    lanesel = wb & 127
    w = torch.where(((wb >> 29) & 1) == 0, take(staged[0], lanesel),
                    take(staged[1], lanesel))
    contrib = mul(w, vals.float() if vals.dtype == torch.bfloat16 else vals)
    # phase B: class-major transpose, align, XOR butterfly with captures
    tc = contrib.transpose(1, 2)
    czero = torch.full_like(tc, zero)
    t1 = take(tc, wa & 127)
    cap1 = (wa >> 14) & 15
    f1 = torch.where(cap1 == 1, t1, czero)
    if lay.two_tiles:
        t2 = take(tc, (wa >> 7) & 127)
        cap2 = (wa >> 18) & 15
        f2 = torch.where(cap2 == 1, t2, czero)
    iota = torch.arange(LANES, device=tc.device)
    for k in range(1, lay.depth + 1):
        idx = iota ^ (1 << (k - 1))
        t1 = add(t1, t1[:, :, idx])
        f1 = torch.where(cap1 == k + 1, t1, f1)
        if lay.two_tiles:
            t2 = add(t2, t2[:, :, idx])
            f2 = torch.where(cap2 == k + 1, t2, f2)
    # route: per (row-class, out-slot) the run's captured value
    q_lo = take(f1, (wb >> 7) & 127)
    if lay.two_tiles:
        q_lo = torch.where(((wb >> 14) & 1) == 0, q_lo, take(f2, (wb >> 7) & 127))
    out = torch.full((d_out, LANES), zero, dtype=tc.dtype, device=tc.device)
    lo_rows = min(d_out, LANES)
    q_lo = q_lo.transpose(1, 2)[:, :lo_rows]
    q_hi = None
    if lay.has_hi and d_out > LANES:
        q_hi = take(f1, (wa >> 22) & 127)
        if lay.two_tiles:
            q_hi = torch.where(((wa >> 29) & 1) == 0, q_hi, take(f2, (wa >> 22) & 127))
        q_hi = q_hi.transpose(1, 2)[:, :d_out - LANES]
    for p in range(P):
        out[:lo_rows] = add(out[:lo_rows], q_lo[p])
        if q_hi is not None:
            out[LANES:] = add(out[LANES:], q_hi[p])
    return out


def dp_sell2_plain(op: Sell2Operand, x: torch.Tensor, sr: Semiring, *,
                   n_rows: int) -> torch.Tensor:
    """The plain torch version of :func:`dp_sell2`, over the operand's
    panels on whatever device they are: x staged as per-chunk tiles, each
    layout's panels swept as the TPU kernel does, layouts sharing a row0
    ⊕-combined in order, then the piece fold. A card build keeps no panels:
    build the operand on the CPU (and move it with ``to``) for this."""
    panels = op.panels
    if panels is None:
        raise ValueError("the sell2 operand holds no panels, as a card build keeps only the "
                         "kernel's plan: build it on the CPU for the plain version")
    carrier, add, _, _, zero, _ = _carrier(sr)
    xt = _x_tiles(panels, x, sr)
    acc: dict = {}
    for slab, lay in zip(panels.slabs, panels.layouts):
        if lay.panels == 0:
            acc.setdefault(lay.row0, None)
            continue
        tile = _panel_sweep(slab, lay, xt, sr).reshape(-1)
        prev = acc.get(lay.row0)
        acc[lay.row0] = tile if prev is None else add(prev, tile)
    rows = {lay.row0: lay.rows for lay in panels.layouts}
    outs = [t if t is not None else torch.full((rows[r0],), zero, dtype=carrier,
                                               device=x.device)
            for r0, t in acc.items()]
    dp = torch.cat(outs) if len(outs) > 1 else outs[0]
    return _fold_pieces_plain(panels.piece_owner, op.base_pad, dp, sr)


def _fold_pieces_plain(piece_owner: Optional[torch.Tensor], base_pad: int, dp: torch.Tensor,
                       sr: Semiring) -> torch.Tensor:
    """dp[:base_pad] ⊕ (each owner's pieces reduced from the reduction's
    identity, one piece after another, as the kernel does)."""
    if piece_owner is None:
        return dp
    add = _carrier(sr)[1]
    ident = _SEGMENT_IDENTITY[_SEGMENT_REDUCE[add], dp.dtype]
    counts = torch.bincount(piece_owner.long(), minlength=base_pad)
    ptr = torch.zeros(base_pad + 1, dtype=torch.int64, device=dp.device)
    torch.cumsum(counts, 0, out=ptr[1:])
    owners = torch.nonzero(counts).flatten()
    seg = torch.full((base_pad,), ident, dtype=dp.dtype, device=dp.device)
    n_pieces = int(piece_owner.shape[0])
    # each owner's pieces in their order: a rank's stacked owners (the
    # sharded operand's) end in padding owned by row 0
    by_owner = torch.sort(piece_owner.long(), stable=True).indices
    pieces = dp[base_pad:base_pad + n_pieces][by_owner]
    acc = torch.full((owners.numel(),), ident, dtype=dp.dtype, device=dp.device)
    first = ptr[owners]
    for k in range(int(counts.max())):
        has = counts[owners] > k
        val = pieces[torch.where(has, first + k, first)]
        acc = torch.where(has, add(acc, val), acc)
    seg[owners] = acc
    return add(dp[:base_pad], seg)


#: the value types a carrier's kernel takes
_TAKES = {torch.float32: (torch.float32, torch.bfloat16), torch.int32: (torch.int32,)}
#: csrc/sell2.cu:sh_sell2_dp(plan, x, n_x, buf, semiring, stream)
_DP_ARGTYPES = [ctypes.POINTER(_Launch), ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def sell2_dp_cuda(op: Sell2Operand, x: torch.Tensor, sr: Semiring) -> torch.Tensor:
    """The sell2 dp in one call of the kernel library over the operand's
    plan, with the arguments made once beside it: the carrier-typed dp of
    :func:`dp_sell2`, pieces folded. The call launches the kernel, after a
    copy of x into the plan's column order where the plan has one.
    Raises on an operand without a plan on x's CUDA device, on what the
    kernel does not take and on a refused launch."""
    plan = op.plan
    if plan is None or plan.device.type != "cuda" or x.device != plan.device:
        raise ValueError("sell2_dp_cuda needs the operand's plan and x on one CUDA device")
    dev = plan.device
    carrier = _carrier(sr)[0]
    if plan.store not in _TAKES[carrier]:
        raise ValueError(f"{sr.name} takes values of {_TAKES[carrier]}, got {plan.store}")
    if x.dtype != sr.dtype or sr.dtype != carrier:
        x = x.to(sr.dtype).to(carrier)
    x = x.contiguous()
    # the output rows, then scratch for the piece values and x in the plan's order
    launch = plan.launch
    buf = torch.empty(launch.n_final + launch.n_pieces + launch.n_perm, dtype=carrier,
                      device=dev)
    fn = _build.function("sell2", "sh_sell2_dp", _DP_ARGTYPES)
    # the raw current stream: torch.cuda.current_stream builds a Stream object
    # on every call, which costs more host time than the rest of the enqueue
    _build.check_launch("sell2", fn(
        ctypes.byref(launch), x.data_ptr(), x.numel(), buf.data_ptr(),
        _build.SR_CODES[sr.name], torch._C._cuda_getCurrentRawStream(dev.index)))
    _build.LAUNCHES["sell2"] += 1
    if launch.n_perm:
        _build.LAUNCHES["sell2_x"] += 1
    return buf[:launch.n_final]
