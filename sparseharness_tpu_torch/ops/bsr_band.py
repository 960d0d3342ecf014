"""The ``bsr_band`` variant: banded SpMV over affine x windows, no gather.

For matrices whose nonzeros sit in a fixed-width window around an
affine-in-row position (banded systems, stencils, the bench's band), the x
blocks that a group of gs = bn/bm block-rows needs are a predictable
slice: group g reads x blocks [base(g), base(g) + K) with
base(g) = clamp(g + c0, 0, c_blocks − K). The strips are the only large
stream; x is read once per group.

The build detects the window offset c0 and width K from the data and
raises NotImplementedError when the matrix does not fit (K would exceed
MAX_WINDOW_BLOCKS), so ``auto`` falls back to the next variant.

On a CUDA tensor :func:`dp_bsr_band` launches the hand-written kernel of
``csrc/bsr_band.cu``, in one of two paths:

- **staged** (the counterpart of the JAX package's x-resident
  ``dp_bsr_band``): each block copies its group's K·bn-element x window
  into shared memory, then streams its strips;
- **streamed** (the counterpart of ``_dp_windowed``): x is read from
  global memory (L1/L2) in chunks of kc window slots whose partials are
  ⊕-combined in registers.

Both read only each row's occupied span of the strips (:class:`BandSpans`,
made once per operand from the strips): the pad slots outside it hold 0̄,
and their products ⊗(x, 0̄) come from two scans of the group's x window
instead, so the dp is the plain version's whatever x holds.

On a CPU tensor it runs :func:`dp_bsr_band_plain`, the plain torch
version of the same padded dp, which the tests and ``chip_smoke.py`` hold
the kernel against.

:func:`spmm_band` is the band's plus_times SpMM, Y = A·X for an (n_cols, m)
X: on a CUDA tensor it launches the FP32 product of ``csrc/spmm_band.cu``
(the counterpart of the JAX package's ``spmm_band``), which multiplies only
each 16-row warp tile's union of the rows' spans and makes NaN where a
skipped pad meets a non-finite X value (:func:`band_spmm_spans_plain` is
that arithmetic in torch); on a CPU tensor :func:`spmm_band_plain`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from sparseharness_tpu_torch.formats.sparse import COO, round_up
from sparseharness_tpu_torch.ops import _build, bsr
from sparseharness_tpu_torch.ops.bsr import _check_layout, _check_strip_dtype, fold_on_device
from sparseharness_tpu_torch.semiring import PLUS_TIMES, Semiring
from sparseharness_tpu_torch.semiring.core import _carrier, _np_fold_for
from sparseharness_tpu_torch.utils.device import DeviceLike, resolve_device

MAX_WINDOW_BLOCKS = 8
#: a group's full-window strip block above which the streamed path splits
#: the window into kc-slot chunks — the JAX package's rule, kept so that both
#: packages chunk the same windows (here it only orders plus_times' sum)
_MAX_GROUP_BYTES = 3 * 1024 * 1024
#: the static shared memory a block may use without opting in; windowed=None
#: picks the staged path whenever the x window fits, which with K ≤ 8 and
#: bn = 128 (≤ 4 KB) it always does on this card
_SMEM_WINDOW_BYTES = 48 * 1024

#: the shared launch counters; this kernel counts its two paths as
#: "staged" and "streamed"
LAUNCHES = _build.LAUNCHES


@dataclasses.dataclass(frozen=True, eq=False)
class BandSpans:
    """Each padded row's occupied span of the strips, in 16-byte chunks.

    A chunk is ``16 // itemsize`` lanes (4 in f32 and int32, 8 in bf16).
    Row R's span is chunks [lo, hi) = ``table[R]``: the chunks from the one
    that holds its first lane whose stored bits differ from ``pad`` to the
    one that holds its last; a row with no such lane has lo = hi = 0. ``pad``
    is 0̄ as the strips store it (bf16(FLT_MAX) rounds to +inf), and
    ``pad_bits`` its 32 bits in the kernel's compute type. ``lanes`` is the
    sum over rows of last − first + 1: the values a dp must read.
    ``strips`` is the tensor the table was made from, and the kernel takes
    the table with no other."""

    strips: torch.Tensor
    table: torch.Tensor  # int16 (r_rows·bm, 2): lo, hi
    pad: Union[int, float]
    pad_bits: int
    lanes: int
    max_chunks: int

    @property
    def chunk_lanes(self) -> int:
        return 16 // self.strips.element_size()


@dataclasses.dataclass(frozen=True)
class BsrBandOperand:
    """strips (R_blocks, bm, K·bn): slot k ↔ x block base(g) + k.

    ``windowed`` picks the kernel path for every dp over this operand:
    None by the rule of :func:`dp_bsr_band`, True streamed, False staged.
    ``spans``, the rows' occupied spans that the kernel reads, is made by
    :func:`build_bsr_band` (or :func:`with_spans`); the plain version does
    not need it."""

    strips: torch.Tensor
    c0: int
    k_win: int
    n_cols: int
    windowed: Optional[bool] = None
    spans: Optional[BandSpans] = None


def build_bsr_band(coo: COO, sr: Semiring, bm: int = 8, bn: int = 128,
                   value_dtype: str = "float32", *,
                   device: DeviceLike = None) -> BsrBandOperand:
    """Detect the band window and scatter the entries into dense strips.

    The per-entry work (window bounds, slots, scatter) runs in torch on the
    target device; duplicates, where the device finds any, are ⊕-folded on
    the host first."""
    device = resolve_device(device)
    if bn % bm != 0:
        raise NotImplementedError("bsr_band requires bn % bm == 0")
    gs = bn // bm  # block-rows per x-block-aligned group
    n, c = coo.shape
    _, _, _, _, zero, as_int = _carrier(sr)
    coo = fold_on_device(coo, _np_fold_for(sr, as_int), device)
    c_blocks = round_up(max(c, 1), bn) // bn
    n_block_rows = round_up(max(n, 1), bm) // bm
    n_groups = round_up(n_block_rows, gs) // gs

    rows = torch.from_numpy(coo.rows).to(device=device, dtype=torch.int64)
    cols = torch.from_numpy(coo.cols).to(device=device, dtype=torch.int64)
    g_of = (rows // bm) // gs
    bc = cols // bn
    # per-group column-block span
    min_bc = torch.full((n_groups,), np.iinfo(np.int32).max, dtype=torch.int64,
                        device=device).scatter_reduce_(0, g_of, bc, "amin")
    max_bc = torch.full((n_groups,), -1, dtype=torch.int64,
                        device=device).scatter_reduce_(0, g_of, bc, "amax")
    occupied = max_bc >= 0
    if not bool(occupied.any()):
        raise NotImplementedError("empty matrix; use another variant")
    groups = torch.arange(n_groups, device=device)
    # window offset: make base(g) = clamp(g + c0) cover [min_bc, max_bc]
    c0 = int((min_bc - groups)[occupied].min())
    base = (groups + c0).clamp(min=0)
    k_win = int((max_bc - base + 1)[occupied].max())
    if k_win > MAX_WINDOW_BLOCKS:
        raise NotImplementedError(
            f"window of {k_win} x-blocks exceeds {MAX_WINDOW_BLOCKS}: "
            "matrix is not banded enough for bsr_band"
        )
    base = base.clamp(max=max(c_blocks - k_win, 0))

    def out_of_window(base_g):
        return bool(((bc < base_g) | (bc >= base_g + k_win)).any())

    if out_of_window(base[g_of]):
        # clamping at the right edge pushed some entries out of window
        k_win += int((bc - (base[g_of] + k_win - 1)).max().clamp(min=0))
        if k_win > MAX_WINDOW_BLOCKS:
            raise NotImplementedError("edge clamping exceeds window limit")
        base = (groups + c0).clamp(0, max(c_blocks - k_win, 0))
        if out_of_window(base[g_of]):
            raise NotImplementedError("window structure not affine enough")

    r_rows = n_groups * gs  # padded block rows (gs multiple)
    kbn = k_win * bn
    carrier_np = np.dtype(np.int32) if as_int else sr.np_dtype
    vals = (coo.vals != 0) if as_int else coo.vals
    vals = torch.from_numpy(np.ascontiguousarray(vals.astype(carrier_np))).to(device)
    strips = torch.full((r_rows * bm * kbn,), zero, dtype=vals.dtype, device=device)
    # row r = (r // bm)·bm + r % bm, so the strip entry (r // bm, r % bm, lane)
    # sits at r·kbn + lane
    lane = (bc - base[g_of]) * bn + cols % bn
    strips[rows * kbn + lane] = vals
    strips = strips.view(r_rows, bm, kbn)
    if (value_dtype == "bfloat16" and not as_int
            and np.issubdtype(sr.np_dtype, np.floating)):
        strips = strips.to(torch.bfloat16)  # round to nearest even
    return BsrBandOperand(strips=strips, c0=c0, k_win=k_win, n_cols=c,
                          spans=band_spans(strips, sr))


#: the bits of each strip type, to compare stored values with the pad
_BITS = {4: torch.int32, 2: torch.int16}
#: elements of the strips whose span mask is made at once
_SPAN_SLICE = 1 << 26


def band_spans(strips: torch.Tensor, sr: Semiring) -> BandSpans:
    """The span table of ``strips`` under ``sr``'s pad, made where the
    strips lie, a slice of rows at a time."""
    r_rows, bm, kbn = strips.shape
    item = strips.element_size()
    cw = 16 // item
    if kbn % cw or kbn // cw >= 1 << 15:
        raise ValueError(f"a strip row of {kbn} lanes must be whole 16-byte chunks, "
                         f"fewer than 2^15 of them")
    zero = _carrier(sr)[4]
    pad_t = torch.tensor(zero, dtype=strips.dtype)
    stored = int(pad_t.view(_BITS[item]).item())  # the pad's bits as stored
    pad = pad_t.item()
    compute = np.float32 if strips.dtype.is_floating_point else np.int32
    rows = r_rows * bm
    flat = strips.reshape(rows, kbn).view(_BITS[item])
    table = torch.zeros((rows, 2), dtype=torch.int16, device=strips.device)
    lanes = torch.zeros((), dtype=torch.int64, device=strips.device)
    longest = torch.zeros((), dtype=torch.int64, device=strips.device)
    step = max(1, _SPAN_SLICE // max(kbn, 1))
    for r0 in range(0, rows, step):
        held = flat[r0:r0 + step] != stored
        occupied = held.any(dim=1)
        first = held.to(torch.uint8).argmax(dim=1)  # argmax takes the first
        last = kbn - 1 - held.flip(1).to(torch.uint8).argmax(dim=1)
        span = torch.stack((first // cw, last // cw + 1), dim=1)
        table[r0:r0 + step] = torch.where(occupied[:, None], span, 0).to(torch.int16)
        lanes += torch.where(occupied, last - first + 1, 0).sum()
        longest = torch.maximum(longest, torch.where(occupied, span[:, 1] - span[:, 0], 0).max())
    return BandSpans(strips=strips, table=table, pad=pad,
                     pad_bits=int(np.array(pad, compute).view(np.int32)),
                     lanes=int(lanes), max_chunks=int(longest))


def with_spans(op: BsrBandOperand, sr: Semiring) -> BsrBandOperand:
    """``op`` with the span table of its strips under ``sr``'s pad."""
    return dataclasses.replace(op, spans=band_spans(op.strips, sr))


def band_traffic(op: BsrBandOperand) -> dict:
    """The bytes one dp of the kernel moves by design, counted from the
    operand: the 16-byte chunks of every row's span (``chunk_bytes``), the
    4-byte span table (``table_bytes``), the padded x once (``x_bytes``)
    and the padded output once (``out_bytes``); ``bytes`` is their sum. The
    least traffic these inputs need counts each span's values instead of
    its chunks and no table (harness/roofline.py:variant_bytes)."""
    table = op.spans.table
    kbn = op.strips.shape[2]
    bn = kbn // op.k_win
    parts = {
        "chunk_bytes": int((table[:, 1].int() - table[:, 0].int()).sum()) * 16,
        "table_bytes": table.numel() * table.element_size(),
        "x_bytes": max(round_up(max(op.n_cols, 1), bn), kbn) * 4,
        "out_bytes": table.shape[0] * 4,
    }
    return {**parts, "bytes": sum(parts.values())}


def pad_x(op: BsrBandOperand, x: torch.Tensor, sr: Semiring) -> torch.Tensor:
    """x padded with 0̄ to max(round_up(n, bn), K·bn), as (c_blocks, bn) in
    the carrier type (bool → int32)."""
    _, _, kbn = op.strips.shape
    k = op.k_win
    bn = kbn // k
    # the window indexes x in whole blocks up to base + K: keep ≥ K blocks
    c_pad = max(round_up(max(x.shape[0], 1), bn), k * bn)
    x_pad = torch.full((c_pad,), sr.zero, dtype=sr.dtype, device=x.device)
    x_pad[: x.shape[0]] = x.to(sr.dtype)
    dtype, *_ = _carrier(sr)
    return x_pad.view(c_pad // bn, bn).to(dtype)


def chunk_slots(op: BsrBandOperand, staged: bool) -> int:
    """kc: window slots per ⊕-partial, a divisor of K (a single slot always
    fits, so one exists). The staged path takes the whole window at once."""
    k = op.k_win
    if staged:
        return k
    strips = op.strips
    _, bm, kbn = strips.shape
    bn = kbn // k
    gs = bn // bm
    item = strips.element_size()
    kc = k
    while gs * bm * kc * bn * item > _MAX_GROUP_BYTES or kc > 32:
        kc -= 1
        while k % kc:
            kc -= 1
    return kc


def _staged(op: BsrBandOperand, x2d: torch.Tensor, windowed) -> bool:
    if windowed is None:
        windowed = op.windowed
    if windowed is None:
        return op.strips.shape[2] * x2d.element_size() <= _SMEM_WINDOW_BYTES
    return not windowed


def dp_bsr_band(op: BsrBandOperand, x: torch.Tensor, sr: Semiring, *,
                n_rows: int, windowed: Optional[bool] = None) -> torch.Tensor:
    """⊕-reduced row dot-products over the padded row space (r_rows·bm,).

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs the
    plain version. ``windowed`` (default: the operand's) forces the
    streamed (True) or staged (False) path; None stages x whenever its
    window fits in shared memory."""
    if op.strips.device.type == "cpu":
        return dp_bsr_band_plain(op, x, sr, n_rows=n_rows, windowed=windowed)
    x2d = pad_x(op, x, sr)
    staged = _staged(op, x2d, windowed)
    dp = band_dp_cuda(op.strips, x2d, sr, c0=op.c0, k_win=op.k_win,
                      stage_x=staged, kc=chunk_slots(op, staged), spans=op.spans)
    return dp > 0 if sr.dtype == torch.bool else dp


def dp_bsr_band_plain(op: BsrBandOperand, x: torch.Tensor, sr: Semiring, *,
                      n_rows: int, windowed: Optional[bool] = None) -> torch.Tensor:
    """The plain torch version of :func:`dp_bsr_band`, on any device: same
    padding, carrier and ``dp > 0`` rules. ``windowed`` is accepted for
    parity and changes nothing but plus_times' summation order."""
    x2d = pad_x(op, x, sr)
    kc = chunk_slots(op, _staged(op, x2d, windowed))
    dp = band_dp_plain(op.strips, x2d, sr, c0=op.c0, k_win=op.k_win, kc=kc)
    return dp > 0 if sr.dtype == torch.bool else dp


def band_dp_plain(strips: torch.Tensor, x2d: torch.Tensor, sr: Semiring, *,
                  c0: int, k_win: int, kc: int) -> torch.Tensor:
    """Carrier-typed padded dp from strips and a padded (c_blocks, bn) x:
    each group's x window is gathered, broadcast against the group's strips,
    ⊗-ed, then ⊕-reduced per kc-slot chunk and across the chunks."""
    r_rows, bm, kbn = strips.shape
    k = k_win
    bn = kbn // k
    gs = bn // bm
    n_groups = r_rows // gs
    _, _, mul, reduce_, _, _ = _carrier(sr)
    max_base = max(x2d.shape[0] - k, 0)
    base = (torch.arange(n_groups, device=x2d.device) + c0).clamp(0, max_base)
    win = x2d[base[:, None] + torch.arange(k, device=x2d.device)]  # (G, K, bn)
    st = strips.view(n_groups, gs, bm, kbn)
    if st.dtype == torch.bfloat16:
        st = st.float()
    prod = mul(win.reshape(n_groups, 1, 1, kbn), st)
    part = reduce_(prod.view(n_groups, gs, bm, k // kc, kc * bn), dim=-1)
    return reduce_(part, dim=-1).reshape(-1)


def ieee_reduce(sr: Semiring, t: torch.Tensor, dim: int) -> torch.Tensor:
    """⊕ over ``dim`` as the kernel takes it: for the float min and max the
    IEEE 754-2019 minimum and maximum (NaN propagates, −0 < +0), by the
    order of the floats' bits, so the result does not depend on the order;
    the carrier's reduction otherwise. torch's amax and amin, which the
    plain version uses, leave the sign of a ±0 tie to their order."""
    carrier, _, _, reduce_, _, _ = _carrier(sr)
    if carrier != torch.float32 or sr.name == "plus_times":
        return reduce_(t, dim=dim)
    bits = t.contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)  # monotone in the float's value
    key = key.amin(dim=dim) if sr.name == "min_plus" else key.amax(dim=dim)
    out = (key ^ ((key >> 31) & 0x7FFFFFFF)).view(torch.float32)
    return torch.where(t.isnan().any(dim=dim), out.new_tensor(float("nan")), out)


def ieee_mul(sr: Semiring, x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """⊗ as the kernel takes it: max_min's min is the IEEE minimum."""
    if sr.name != "max_min":
        return _carrier(sr)[2](x, a)
    return -ieee_reduce(sr, torch.stack(torch.broadcast_tensors(-x, -a)), 0)


def band_dp_ieee(strips: torch.Tensor, x2d: torch.Tensor, sr: Semiring, *,
                 c0: int, k_win: int) -> torch.Tensor:
    """:func:`band_dp_plain`'s dp (whole windows, kc = K) with ⊗ and ⊕ as
    :func:`ieee_mul` and :func:`ieee_reduce`: for the six exact semirings
    the kernel's result bit for bit, zero signs included."""
    r_rows, bm, kbn = strips.shape
    bn = kbn // k_win
    n_groups = r_rows * bm // bn
    base = (torch.arange(n_groups, device=x2d.device) + c0).clamp(
        0, max(x2d.shape[0] - k_win, 0))
    win = x2d[base[:, None] + torch.arange(k_win, device=x2d.device)].reshape(n_groups, 1, kbn)
    st = strips.reshape(n_groups, bn, kbn)
    st = st.float() if st.dtype == torch.bfloat16 else st
    return ieee_reduce(sr, ieee_mul(sr, win, st), -1).reshape(-1)


#: the kinds of x that :func:`band_x` makes
X_KINDS = ("uniform", "specials", "negative")


def band_x(sr: Semiring, n: int, kind: str, rng: np.random.Generator) -> np.ndarray:
    """n values of x, drawn from ``rng``, to hold the kernel against the
    plain version where the pads matter.

    ``uniform``: in (0.1, 1); integers in [0, 50); bool true at 30%.
    ``specials``: in (−1, 1) (integers in [−50, 50)), and a third of the
    first eighth of the columns ±inf, ±FLT_MAX or ±0 (INT_MIN, INT_MAX, 0
    or −1 for the int semirings): the rows whose window reaches there meet
    them in their pad lanes; the rows whose window lies beyond keep a
    finite Σ|a·x|, on which plus_times' tolerance is checked.
    ``negative``: every value below zero, where max_times' pads (0·x = −0)
    set the dp; bool all false. Bool x has no specials."""
    if kind not in X_KINDS:
        raise ValueError(f"kind must be one of {X_KINDS}, got {kind!r}")
    if sr.dtype == torch.bool:
        return rng.random(n) < 0.3 if kind != "negative" else np.zeros(n, bool)
    is_int = sr.dtype == torch.int32
    if kind == "uniform":
        return (rng.integers(0, 50, n).astype(np.int32) if is_int
                else rng.uniform(0.1, 1.0, n).astype(np.float32))
    if is_int:
        info = np.iinfo(np.int32)
        specials = np.array([info.min, info.max, 0, -1], np.int32)
        x = rng.integers(-50, 50, n).astype(np.int32)
    else:
        fmax = np.finfo(np.float32).max
        specials = np.array([np.inf, -np.inf, fmax, -fmax, 0.0, -0.0], np.float32)
        x = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    if kind == "negative":
        return -np.abs(x) - x.dtype.type(1 if is_int else 0.1)
    at = (rng.random(n) < 1 / 3) & (np.arange(n) < n // 8)
    x[at] = specials[rng.integers(0, specials.size, int(at.sum()))]
    return x


def band_dp_cuda(strips: torch.Tensor, x2d: torch.Tensor, sr: Semiring, *,
                 c0: int, k_win: int, stage_x: bool, kc: int,
                 spans: Optional[BandSpans]) -> torch.Tensor:
    """Launch the CUDA kernel: the carrier-typed padded dp (r_rows·bm,),
    reading each row's span of the strips from ``spans``.

    Raises on what the kernel does not take, on a span table made for
    other strips and on a refused launch."""
    if spans is None:
        raise ValueError("the operand has no span table: make it with with_spans")
    if spans.strips is not strips:
        raise ValueError("the span table was made for other strips: remake it with with_spans")
    if strips.device.type != "cuda" or x2d.device != strips.device:
        raise ValueError("band_dp_cuda needs strips and x on one CUDA device")
    carrier, *_ = _carrier(sr)
    if strips.dim() != 3 or x2d.dim() != 2:
        raise ValueError("strips must be (r_rows, bm, K·bn) and x (c_blocks, bn)")
    r_rows, bm, kbn = strips.shape
    k = k_win
    if k <= 0 or kbn % k or kc <= 0 or k % kc:
        raise ValueError(f"bad window: K·bn={kbn}, K={k}, kc={kc}")
    bn = kbn // k
    if bn % bm or bn % 4 or r_rows % (bn // bm):
        raise ValueError(f"kernel needs bn % bm == 0, bn % 4 == 0 and whole "
                         f"groups: bm={bm}, bn={bn}, r_rows={r_rows}")
    if x2d.dtype != carrier or x2d.shape[1] != bn or x2d.shape[0] < k:
        raise ValueError(f"x must be ({k}+, {bn}) {carrier}, got "
                         f"{tuple(x2d.shape)} {x2d.dtype}")
    _check_strip_dtype(strips, sr)
    if stage_x and kbn * x2d.element_size() > _SMEM_WINDOW_BYTES:
        raise ValueError(f"x window of {kbn} elements exceeds the staged "
                         f"path's {_SMEM_WINDOW_BYTES} bytes")
    _check_layout(strips, x2d, spans.table)
    out = torch.empty(r_rows * bm, dtype=carrier, device=strips.device)
    # the raw current stream: torch.cuda.current_stream builds a Stream
    # object on every call
    stream = torch._C._cuda_getCurrentRawStream(strips.device.index)
    fn = _build.function("bsr_band", "sh_band_dp",
                         [ctypes.c_int] + [ctypes.c_void_p] * 4
                         + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    _build.check_launch("bsr_band", fn(
        strips.device.index, strips.data_ptr(), x2d.data_ptr(), spans.table.data_ptr(),
        out.data_ptr(), r_rows, bm, kbn, k, kc, c0, x2d.shape[0],
        _build.SR_CODES[sr.name], _build.STRIP_CODES[strips.dtype], int(stage_x),
        spans.pad_bits, spans.max_chunks, stream,
    ))
    LAUNCHES["staged" if stage_x else "streamed"] += 1
    return out


# ------------------------------------------------------------------ SpMM


def pad_x_block(op: BsrBandOperand, x_block: torch.Tensor) -> torch.Tensor:
    """X (n_cols, m) in float32, padded with zero rows to whole bn-blocks
    and at least the K blocks of one window (as :func:`pad_x`)."""
    bn = op.strips.shape[2] // op.k_win
    return bsr.pad_x_block(x_block, bn, PLUS_TIMES, min_rows=op.k_win * bn)


def spmm_band(op: BsrBandOperand, x_block: torch.Tensor, *, n_rows: int) -> torch.Tensor:
    """Y = A·X (plus_times only): (n_rows, m) float32 from X (n_cols, m).

    On a CUDA tensor this launches the kernel of ``csrc/spmm_band.cu``,
    which reads the operand's span table; on a CPU tensor it runs
    :func:`spmm_band_plain`. Other semirings go through ``spmm_tiles`` (see
    ``ops.spmm``)."""
    if op.strips.device.type == "cpu":
        return spmm_band_plain(op, x_block, n_rows=n_rows)
    y = band_spmm_cuda(op.strips, pad_x_block(op, x_block), c0=op.c0, k_win=op.k_win,
                       spans=op.spans)
    return y[:n_rows]


def spmm_band_plain(op: BsrBandOperand, x_block: torch.Tensor, *,
                    n_rows: int) -> torch.Tensor:
    """The plain torch version of :func:`spmm_band`, on any device."""
    y = band_spmm_plain(op.strips, pad_x_block(op, x_block), c0=op.c0, k_win=op.k_win)
    return y[:n_rows]


def _band_groups(strips: torch.Tensor, x2d: torch.Tensor, k_win: int):
    """(n_groups, rows a group, K·bn, bn, the group chunk of the plain
    versions) of a band SpMM."""
    r_rows, bm, kbn = strips.shape
    bn = kbn // k_win
    rows = bn // bm * bm
    step = max(1, bsr.PLAIN_CHUNK_BYTES // max(rows * kbn * x2d.shape[1] * 4, 1))
    return r_rows * bm // rows, rows, kbn, bn, step


def _band_windows(x2d: torch.Tensor, groups: torch.Tensor, c0: int, k_win: int,
                  bn: int) -> torch.Tensor:
    """The X windows (len(groups), K·bn, m) of those groups."""
    xb = x2d.view(-1, bn, x2d.shape[1])
    base = (groups + c0).clamp(0, max(xb.shape[0] - k_win, 0))
    win = xb[base[:, None] + torch.arange(k_win, device=x2d.device)]
    return win.reshape(len(groups), k_win * bn, x2d.shape[1])


def band_spmm_plain(strips: torch.Tensor, x2d: torch.Tensor, *, c0: int,
                    k_win: int) -> torch.Tensor:
    """Padded Y (r_rows·bm, m) from strips and a padded (c_blocks·bn, m) X:
    each group's X window is gathered, multiplied with the group's strips by
    broadcast and summed over the window, a chunk of groups at a time so
    that the products stay within bsr.PLAIN_CHUNK_BYTES."""
    n_groups, rows, kbn, bn, step = _band_groups(strips, x2d, k_win)
    out = torch.empty((n_groups, rows, x2d.shape[1]), dtype=torch.float32, device=x2d.device)
    st_all = strips.view(n_groups, rows, kbn)
    for g0 in range(0, n_groups, step):
        groups = torch.arange(g0, min(g0 + step, n_groups), device=x2d.device)
        win = _band_windows(x2d, groups, c0, k_win, bn)
        st = st_all[g0:g0 + step].float()
        out[g0:g0 + step] = (win[:, None] * st[..., None]).sum(dim=2)
    return out.view(-1, x2d.shape[1])


#: rows of a warp tile of the SpMM kernel, which multiplies only their union
#: of spans
SPMM_TILE_ROWS = 16


def band_spmm_spans_plain(strips: torch.Tensor, x2d: torch.Tensor, spans: BandSpans, *,
                          c0: int, k_win: int) -> torch.Tensor:
    """The SpMM kernel's arithmetic in torch: :func:`band_spmm_plain`'s Y
    with each 16-row tile of a group summing only the window lanes of the
    union of its rows' spans (``spans.table``, in chunks of
    ``spans.chunk_lanes``; a tile with no stored value sums nothing), and
    NaN in a column where a lane outside that union meets a non-finite X
    value (0 · ±inf and 0 · NaN are NaN in the full sum). Elsewhere it
    differs from band_spmm_plain only by the order of the sum and the sign
    of a zero."""
    n_groups, rows, kbn, bn, step = _band_groups(strips, x2d, k_win)
    tiles = rows // SPMM_TILE_ROWS
    m = x2d.shape[1]
    table = spans.table.long() * spans.chunk_lanes
    empty = table[:, 0] >= table[:, 1]
    lo = torch.where(empty, kbn, table[:, 0]).view(-1, SPMM_TILE_ROWS).amin(dim=1)
    hi = torch.where(empty, 0, table[:, 1]).view(-1, SPMM_TILE_ROWS).amax(dim=1)
    lane = torch.arange(kbn, device=x2d.device)
    kept = ((lane >= lo[:, None]) & (lane < hi[:, None])).view(n_groups, tiles, 1, kbn)
    out = torch.empty((n_groups, rows, m), dtype=torch.float32, device=x2d.device)
    st_all = strips.view(n_groups, tiles, SPMM_TILE_ROWS, kbn)
    for g0 in range(0, n_groups, step):
        groups = torch.arange(g0, min(g0 + step, n_groups), device=x2d.device)
        win = _band_windows(x2d, groups, c0, k_win, bn)  # (G, K·bn, m)
        keep = kept[g0:g0 + step]  # (G, tiles, 1, K·bn)
        # (G, tiles, 16, K·bn, m)
        prod = win[:, None, None] * st_all[g0:g0 + step, ..., None].float()
        y = torch.where(keep[..., None], prod, 0.0).sum(dim=3)
        skipped_bad = ((~keep[:, :, 0, :, None]) & ~win[:, None].isfinite()).any(dim=2)
        y = torch.where(skipped_bad[:, :, None], float("nan"), y)
        out[g0:g0 + step] = y.reshape(len(groups), rows, m)
    return out.view(-1, m)


def band_spmm_cuda(strips: torch.Tensor, x2d: torch.Tensor, *, c0: int, k_win: int,
                   spans: Optional[BandSpans]) -> torch.Tensor:
    """Launch the SpMM kernel: padded Y (r_rows·bm, m) float32, computing
    only each warp tile's union of the rows' spans in ``spans``.

    Raises ValueError on an operand without a span table, with one made for
    other strips or under a pad other than +0 (another semiring's), and on
    what the kernel does not take; RuntimeError on a refused launch."""
    if spans is None:
        raise ValueError("the operand has no span table: make it with with_spans")
    if spans.strips is not strips:
        raise ValueError("the span table was made for other strips: remake it with with_spans")
    if spans.pad_bits != 0:
        raise ValueError(f"the span table was made under the pad {spans.pad}, not plus_times' "
                         f"+0: remake it with with_spans(op, PLUS_TIMES)")
    if strips.device.type != "cuda" or x2d.device != strips.device:
        raise ValueError("band_spmm_cuda needs strips and X on one CUDA device")
    if strips.dim() != 3 or x2d.dim() != 2:
        raise ValueError("strips must be (r_rows, bm, K·bn) and X (c_pad, m)")
    r_rows, bm, kbn = strips.shape
    k = k_win
    if k <= 0 or kbn % k:
        raise ValueError(f"bad window: K·bn={kbn}, K={k}")
    bn = kbn // k
    if bn % bm or bn % SPMM_TILE_ROWS or r_rows % (bn // bm):
        raise ValueError(f"kernel needs bn % bm == 0, bn % {SPMM_TILE_ROWS} == 0 and whole "
                         f"groups: bm={bm}, bn={bn}, r_rows={r_rows}")
    if x2d.dtype != torch.float32 or x2d.shape[0] % bn or x2d.shape[0] < k * bn:
        raise ValueError(f"X must be (c_blocks·{bn}, m) float32 with c_blocks ≥ {k}, "
                         f"got {tuple(x2d.shape)} {x2d.dtype}")
    if strips.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"spmm_band takes f32 or bf16 strips, got {strips.dtype}")
    _check_layout(strips, x2d, spans.table)
    m = x2d.shape[1]
    out = torch.empty((r_rows * bm, m), dtype=torch.float32, device=strips.device)
    fn = _build.function("spmm_band", "sh_spmm_band",
                         [ctypes.c_int] + [ctypes.c_void_p] * 4
                         + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    _build.check_launch("spmm_band", fn(
        strips.device.index, strips.data_ptr(), x2d.data_ptr(), spans.table.data_ptr(),
        out.data_ptr(), r_rows, bm, kbn, k, c0, x2d.shape[0] // bn, m,
        _build.STRIP_CODES[strips.dtype],
        torch.cuda.current_stream(strips.device).cuda_stream,
    ))
    LAUNCHES["spmm_band"] += 1
    return out
