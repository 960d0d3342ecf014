"""The ``bsr_ell`` variant: ELL-of-tiles strips over pre-gathered x strips,
and the strip kernel it shares with ``bsr_fused``.

Each block-row is padded to K tiles (K = the most tiles of any block-row)
and stored as a dense (bm, K·bn) strip whose k-th bn-slice is the tile at
block-col ``tile_cols[r, k]``. The row count is padded to a multiple of the
TPU kernel's rows per grid step (``_rows_per_step``), so that the arrays
equal the JAX package's; the kernel here ignores that step.

:func:`dp_bsr_ell` gathers the x strips ``x2d[tile_cols]`` with one
``index_select`` before the kernel, as the JAX package does in XLA, then
on a CUDA tensor launches the strip kernel of ``csrc/bsr_strips.cu``
(``GATHER = false``). On a CPU tensor it runs :func:`dp_bsr_ell_plain`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from sparseharness_tpu_torch.formats.sparse import COO, round_up
from sparseharness_tpu_torch.ops import _build
from sparseharness_tpu_torch.ops.bsr import (
    _check_layout, _check_strip_dtype, device_tiles, pad_x2d,
)
from sparseharness_tpu_torch.semiring import Semiring
from sparseharness_tpu_torch.semiring.core import _carrier
from sparseharness_tpu_torch.utils.device import DeviceLike, resolve_device

#: strip bytes per TPU grid step, which fixes the row padding (a TPU rule,
#: kept so that the arrays equal the JAX package's)
_TARGET_STEP_BYTES = 4 * 1024 * 1024

#: padded-tile bytes may exceed the raw nnz bytes by at most this factor;
#: beyond it the build refuses, so that variant="auto" moves on to an
#: index-based layout instead of running out of memory
MAX_PAD_BLOWUP = 32
_MIN_GUARD_BYTES = 1 << 30  # never refuse operands under 1 GiB


class BsrEllOperand(NamedTuple):
    """Block-row r is a dense (bm, K·bn) strip whose k-th bn-slice is the
    tile at block-col tile_cols[r, k]."""

    tiles: torch.Tensor      # (R_blocks, bm, K·bn); pads = the pad value
    tile_cols: torch.Tensor  # int32 (R_blocks, K) global block-col; pads = 0


def _rows_per_step(k: int, bm: int, bn: int, itemsize: int = 4) -> int:
    rg = _TARGET_STEP_BYTES // max(k * bm * bn * itemsize, 1)
    return int(max(8, min(512, round_up(max(rg, 1), 8))))


def _guard_tile_blowup(nnz: int, n_block_rows: int, k: int, bm: int,
                       bn: int) -> None:
    """Refuse a layout whose padded tiles would dwarf the nonzeros, before
    any tile array exists."""
    if nnz == 0:
        return
    padded_bytes = n_block_rows * k * bm * bn * 4
    nnz_bytes = nnz * 8  # value + index, the raw-COO floor
    if padded_bytes > max(MAX_PAD_BLOWUP * nnz_bytes, _MIN_GUARD_BYTES):
        raise NotImplementedError(
            f"ELL-of-tiles padding blowup: {padded_bytes / 1e9:.1f} GB of "
            f"tiles for {nnz_bytes / 1e9:.2f} GB of nonzeros (K={k}); "
            "structure too scattered for blocked layouts — use ell/coo_seg "
            "or reorder ('rcm') first")


def build_bsr_ell(coo: COO, sr: Semiring, bm: int = 8, bn: int = 128,
                  value_dtype: str = "float32", *,
                  device: DeviceLike = None) -> BsrEllOperand:
    """Scatter the tiles into ELL-of-tiles strips on the target device."""
    device = resolve_device(device)
    t = device_tiles(coo, sr, bm, bn, device)
    nbr = t.n_block_rows
    counts = torch.bincount(t.tile_rows, minlength=nbr)
    k = max(int(counts.max()), 1)
    _guard_tile_blowup(t.nnz, nbr, k, bm, bn)
    # the step is clamped to the matrix, so a small matrix is not padded to
    # 512 block-rows
    rg = min(_rows_per_step(k, bm, bn), round_up(nbr, 8))
    r_pad = round_up(nbr, rg)
    kbn = k * bn
    # a tile's slot is its place among its block-row's tiles
    slot = (torch.arange(t.ntiles, device=device)
            - (torch.cumsum(counts, 0) - counts)[t.tile_rows])
    strips = torch.full((r_pad * bm * kbn,), t.pad, dtype=t.vals.dtype,
                        device=device)
    # entry (row, col) sits at strip (row // bm, row % bm, slot·bn + col % bn)
    strips[t.rows * kbn + slot[t.entry_tile] * bn + t.cols % bn] = t.vals
    cols = torch.zeros(r_pad * k, dtype=torch.int32, device=device)
    cols[t.tile_rows * k + slot] = t.tile_cols.to(torch.int32)
    strips = strips.view(r_pad, bm, kbn)
    if value_dtype == "bfloat16" and sr.dtype == torch.float32:
        strips = strips.to(torch.bfloat16)  # round to nearest even
    return BsrEllOperand(tiles=strips, tile_cols=cols.view(r_pad, k))


def gather_x_strips(x2d: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The x strips x2d[cols] of (R, K) block-columns, as (R, K·bn)."""
    r, k = cols.shape
    return x2d.index_select(0, cols.reshape(-1)).view(r, k * x2d.shape[1])


def dp_bsr_ell(op: BsrEllOperand, x: torch.Tensor, sr: Semiring, *,
               n_rows: int) -> torch.Tensor:
    """⊕-reduced row dot-products over the padded row space
    (R_blocks·bm ≥ n_rows); callers slice. On a CUDA tensor this launches
    the kernel; on a CPU tensor it runs the plain version."""
    if op.tiles.device.type == "cpu":
        return dp_bsr_ell_plain(op, x, sr, n_rows=n_rows)
    k = op.tile_cols.shape[1]
    xt = gather_x_strips(pad_x2d(x, op.tiles.shape[2] // k, sr), op.tile_cols)
    dp = strip_dp_cuda(op.tiles, xt, sr, k=k)
    return dp > 0 if sr.dtype == torch.bool else dp


def dp_bsr_ell_plain(op: BsrEllOperand, x: torch.Tensor, sr: Semiring, *,
                     n_rows: int) -> torch.Tensor:
    """The plain torch version of :func:`dp_bsr_ell`, on any device."""
    k = op.tile_cols.shape[1]
    xt = gather_x_strips(pad_x2d(x, op.tiles.shape[2] // k, sr), op.tile_cols)
    dp = strip_dp_plain(op.tiles, xt, sr)
    return dp > 0 if sr.dtype == torch.bool else dp


def strip_dp_plain(strips: torch.Tensor, xt: torch.Tensor,
                   sr: Semiring) -> torch.Tensor:
    """Carrier-typed padded dp of (R, bm, K·bn) strips against (R, K·bn)
    x strips: ⊗ broadcast over the bm rows, then a lane ⊕-reduce."""
    _, _, mul, reduce_, _, _ = _carrier(sr)
    st = strips.float() if strips.dtype == torch.bfloat16 else strips
    return reduce_(mul(xt[:, None, :], st), dim=-1).reshape(-1)


def strip_dp_cuda(strips: torch.Tensor, x: torch.Tensor, sr: Semiring, *,
                  k: int, cols: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the strip kernel: the carrier-typed padded dp (R·bm,) of
    (R, bm, K·bn) strips.

    With ``cols`` (int32, R·K block-columns) it is bsr_fused's kernel and x
    is the padded (c_blocks, bn) vector, gathered in the kernel; without,
    it is bsr_ell's and x holds the (R, K·bn) x strips. Raises on what the
    kernel does not take and on a refused launch."""
    gather = cols is not None
    tensors = (strips, x) + ((cols,) if gather else ())
    if strips.device.type != "cuda" or any(t.device != strips.device for t in tensors):
        raise ValueError("strip_dp_cuda needs its tensors on one CUDA device")
    carrier, *_ = _carrier(sr)
    if strips.dim() != 3:
        raise ValueError("strips must be (R, bm, K·bn)")
    r_blocks, bm, kbn = strips.shape
    if k <= 0 or kbn % k or (kbn // k) % 4:
        raise ValueError(f"K·bn={kbn} must be K={k} blocks of a multiple of 4")
    bn = kbn // k
    want = (x.shape[0], bn) if gather else (r_blocks, kbn)
    if x.dtype != carrier or x.dim() != 2 or tuple(x.shape) != want:
        raise ValueError(f"x must be {want} {carrier}, got {tuple(x.shape)} {x.dtype}")
    if gather and (cols.dtype != torch.int32 or cols.numel() != r_blocks * k):
        raise ValueError(f"cols must be {r_blocks * k} int32 block-columns")
    _check_strip_dtype(strips, sr)
    _check_layout(*tensors)
    out = torch.empty(r_blocks * bm, dtype=carrier, device=strips.device)
    fn = _build.function("bsr_strips", "sh_strip_dp",
                         [ctypes.c_int] + [ctypes.c_void_p] * 4
                         + [ctypes.c_longlong] + [ctypes.c_int] * 6
                         + [ctypes.c_void_p])
    _build.check_launch("bsr_strips", fn(
        strips.device.index, strips.data_ptr(), x.data_ptr(),
        cols.data_ptr() if gather else None, out.data_ptr(), r_blocks, bm, kbn,
        k, _build.SR_CODES[sr.name], _build.STRIP_CODES[strips.dtype],
        int(gather), torch.cuda.current_stream(strips.device).cuda_stream,
    ))
    _build.LAUNCHES["bsr_fused" if gather else "bsr_ell"] += 1
    return out
