"""Semiring SpMM over the ELL-of-tiles layout: dp = A ⊗ X for a block of m
right-hand sides.

A rides the strip layout of ``bsr_ell`` (:class:`BsrEllOperand`): block-row
r is a dense (bm, K·bn) strip whose slot k is the tile at block-column
``tile_cols[r, k]``. X is (n_cols, m), padded with the semiring zero to
whole bn-blocks of rows and kept row-major, so the X rows of a tile are
contiguous along m.

On a CUDA tensor :func:`spmm_bsr_ell` launches the hand-written kernel of
``csrc/spmm_tiles.cu`` (all seven semirings, or_and on its int32 carrier;
a thread to 8 rows × 8 columns wherever m and bm are multiples of 8, a
block to a block-row's column tile otherwise);
on a CPU tensor it runs :func:`spmm_bsr_ell_plain`, the plain torch version
that the tests and ``chip_smoke.py`` hold the kernel against. The JAX
package's K-chunk and slab padding are rules of the TPU's grid and have no
counterpart here.

:func:`ell_operand_from_band` and :func:`ell_operand_from_fused` present
``bsr_band`` and ``bsr_fused`` operands in this layout, so that ``spmm``
takes them through the same kernel.
"""

from __future__ import annotations

import ctypes

import torch

from sparseharness_tpu_torch.formats.sparse import round_up
from sparseharness_tpu_torch.ops import _build, bsr
from sparseharness_tpu_torch.ops.bsr import _check_layout, _check_strip_dtype, pad_x_block
from sparseharness_tpu_torch.ops.bsr_ell import BsrEllOperand
from sparseharness_tpu_torch.semiring import Semiring
from sparseharness_tpu_torch.semiring.core import _carrier


def spmm_bsr_ell(op: BsrEllOperand, x_block: torch.Tensor, sr: Semiring, *,
                 n_rows: int) -> torch.Tensor:
    """⊕-reduced row dot-products for every column: (n_rows, m), in the
    semiring's dtype, not folded (callers apply ``fold_dp``, which
    broadcasts over 2-D). On a CUDA tensor this launches the kernel; on a
    CPU tensor it runs the plain version."""
    if op.tiles.device.type == "cpu":
        return spmm_bsr_ell_plain(op, x_block, sr, n_rows=n_rows)
    bn = op.tiles.shape[2] // op.tile_cols.shape[1]
    dp = spmm_tiles_cuda(op.tiles, op.tile_cols, pad_x_block(x_block, bn, sr), sr)
    dp = dp[:n_rows]
    return dp > 0 if sr.dtype == torch.bool else dp


def spmm_bsr_ell_plain(op: BsrEllOperand, x_block: torch.Tensor, sr: Semiring, *,
                       n_rows: int) -> torch.Tensor:
    """The plain torch version of :func:`spmm_bsr_ell`, on any device."""
    bn = op.tiles.shape[2] // op.tile_cols.shape[1]
    dp = spmm_tiles_plain(op.tiles, op.tile_cols, pad_x_block(x_block, bn, sr), sr)
    dp = dp[:n_rows]
    return dp > 0 if sr.dtype == torch.bool else dp


def spmm_tiles_plain(tiles: torch.Tensor, tile_cols: torch.Tensor, x2d: torch.Tensor,
                     sr: Semiring) -> torch.Tensor:
    """Carrier-typed padded dp (R·bm, m) of (R, bm, K·bn) strips against a
    padded (c_blocks·bn, m) X: each block-row's X rows are gathered, ⊗-ed
    with its strip by broadcast, and ⊕-reduced over the K·bn slots, a chunk
    of block-rows at a time so that the products stay within
    bsr.PLAIN_CHUNK_BYTES."""
    r_blocks, bm, kbn = tiles.shape
    k = tile_cols.shape[1]
    bn = kbn // k
    m = x2d.shape[1]
    _, _, mul, reduce_, _, _ = _carrier(sr)
    xb = x2d.view(-1, bn, m)
    step = max(1, bsr.PLAIN_CHUNK_BYTES // max(bm * kbn * m * 4, 1))
    out = torch.empty((r_blocks, bm, m), dtype=x2d.dtype, device=x2d.device)
    for r0 in range(0, r_blocks, step):
        cols = tile_cols[r0:r0 + step].long().clamp(0, xb.shape[0] - 1)
        xg = xb[cols].reshape(-1, kbn, m)  # (rc, K·bn, m)
        st = tiles[r0:r0 + step]
        if st.dtype == torch.bfloat16:
            st = st.float()
        out[r0:r0 + step] = reduce_(mul(xg[:, None], st[..., None]), dim=2)
    return out.view(r_blocks * bm, m)


def spmm_tiles_cuda(tiles: torch.Tensor, tile_cols: torch.Tensor, x2d: torch.Tensor,
                    sr: Semiring) -> torch.Tensor:
    """Launch the CUDA kernel: the carrier-typed padded dp (R·bm, m).

    Raises on what the kernel does not take and on a refused launch."""
    tensors = (tiles, tile_cols, x2d)
    if tiles.device.type != "cuda" or any(t.device != tiles.device for t in tensors):
        raise ValueError("spmm_tiles_cuda needs its tensors on one CUDA device")
    carrier, *_ = _carrier(sr)
    if tiles.dim() != 3 or tile_cols.dim() != 2 or x2d.dim() != 2:
        raise ValueError("tiles must be (R, bm, K·bn), tile_cols (R, K) and X (c_pad, m)")
    r_blocks, bm, kbn = tiles.shape
    k = tile_cols.shape[1]
    if k <= 0 or kbn % k or tile_cols.shape[0] != r_blocks or tile_cols.dtype != torch.int32:
        raise ValueError(f"tile_cols must be int32 ({r_blocks}, K) with K | {kbn}")
    bn = kbn // k
    if bm * bn * 4 > 48 * 1024:
        raise ValueError(f"a ({bm}, {bn}) tile exceeds the kernel's 48 KB of shared memory")
    if x2d.dtype != carrier or x2d.shape[0] % bn or x2d.shape[0] == 0:
        raise ValueError(f"X must be (c_blocks·{bn}, m) {carrier}, got "
                         f"{tuple(x2d.shape)} {x2d.dtype}")
    _check_strip_dtype(tiles, sr)
    _check_layout(*tensors)
    m = x2d.shape[1]
    out = torch.empty((r_blocks * bm, m), dtype=carrier, device=tiles.device)
    fn = _build.function("spmm_tiles", "sh_spmm_tiles",
                         [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                         + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    _build.check_launch("spmm_tiles", fn(
        tiles.device.index, tiles.data_ptr(), tile_cols.data_ptr(), x2d.data_ptr(),
        out.data_ptr(), r_blocks, bm, kbn, k, m, x2d.shape[0] // bn,
        _build.SR_CODES[sr.name], _build.STRIP_CODES[tiles.dtype],
        torch.cuda.current_stream(tiles.device).cuda_stream,
    ))
    _build.LAUNCHES["spmm_tiles"] += 1
    return out


def ell_operand_from_band(op) -> BsrEllOperand:
    """A ``BsrBandOperand`` as strip tiles with its affine columns made
    explicit, tile_cols[r, k] = clip(clip(r // gs + c0, 0, c_blocks − K) + k,
    0, c_blocks − 1), on the operand's device. Slots past the matrix edge
    hold ⊕-identity pads, so clipping their column into range is
    harmless."""
    r_rows, bm, kbn = op.strips.shape
    k = op.k_win
    bn = kbn // k
    gs = bn // bm
    c_blocks = round_up(max(op.n_cols, 1), bn) // bn
    dev = op.strips.device
    base = (torch.arange(r_rows, device=dev) // gs + op.c0).clamp(0, max(c_blocks - k, 0))
    cols = (base[:, None] + torch.arange(k, device=dev)[None, :]).clamp(0, c_blocks - 1)
    return BsrEllOperand(tiles=op.strips, tile_cols=cols.to(torch.int32))


def ell_operand_from_fused(op) -> BsrEllOperand:
    """A ``BsrFusedOperand``'s slabs as one flat strip layout (views)."""
    s, r_s, bm, kbn = op.strips.shape
    k = op.cols.shape[1] // r_s
    return BsrEllOperand(tiles=op.strips.view(s * r_s, bm, kbn),
                         tile_cols=op.cols.view(s * r_s, k))
