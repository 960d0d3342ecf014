"""Kernel-variant registry and the public spmv entry point.

A *variant* is a named (build, dp) pair, and a :class:`Geometry` carries
the block-shape knobs — the analogue of the reference's runfile sweep axis.
PyTorch runs eagerly, so there is no jitted form of :func:`spmv`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from sparseharness_tpu_torch.formats.sparse import COO
from sparseharness_tpu_torch.ops import (
    bsr, bsr_band, bsr_ell, bsr_fused, dia, sell, sell2, torch_ops,
)
from sparseharness_tpu_torch.semiring import Semiring
from sparseharness_tpu_torch.utils.device import DeviceLike


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Block-shape sweep point.

    block_m/block_n: tile shape for blocked variants and the row/width
    padding multiples for ELL. value_dtype: storage dtype for matrix values
    ("float32" or "bfloat16" — bf16 halves the bytes per slot; kernels
    compute in f32)."""

    block_m: int = 8
    block_n: int = 128
    value_dtype: str = "float32"

    def __str__(self) -> str:
        s = f"{self.block_m}x{self.block_n}"
        if self.value_dtype != "float32":
            s += f"@{self.value_dtype}"
        return s


@dataclasses.dataclass(frozen=True)
class KernelVariant:
    name: str
    # (coo, sr, geometry, device) → operand on that device
    build: Callable[[COO, Semiring, Geometry, DeviceLike], Any]
    # (operand, x, sr, *, n_rows) → ⊕-reduced dp over the padded rows
    dp: Callable[..., torch.Tensor]
    description: str = ""


VARIANTS: Dict[str, KernelVariant] = {}


def register_variant(v: KernelVariant) -> KernelVariant:
    VARIANTS[v.name] = v
    return v


def get_variant(name: str) -> KernelVariant:
    try:
        return VARIANTS[name]
    except KeyError:
        raise KeyError(f"unknown kernel variant {name!r}; known: {sorted(VARIANTS)}") from None


#: structure-aware fallback chain for variant="auto", the JAX package's:
#: the streaming band kernel when the window is affine, the fused gather
#: kernel when the structure blocks well and x fits the TPU's VMEM cap, the
#: sell2 panel kernel for ragged and power-law rows (no cap on x), the
#: pre-gathered strips when sell2's padding guard refuses, ELL as the
#: universal fallback
AUTO_CHAIN = ("bsr_band", "bsr_fused", "sell2", "bsr_ell", "ell")


def build_operand(coo: COO, sr: Semiring, variant: str = "ell",
                  geometry: Geometry = Geometry(), *, device: DeviceLike = None):
    return get_variant(variant).build(coo, sr, geometry, device)


def build_operand_auto(coo: COO, sr: Semiring, geometry: Geometry = Geometry(),
                       *, device: DeviceLike = None):
    """(variant_name, operand) for the first buildable AUTO_CHAIN entry."""
    last = None
    for name in AUTO_CHAIN:
        try:
            return name, get_variant(name).build(coo, sr, geometry, device)
        except NotImplementedError as e:
            last = e
    raise NotImplementedError(f"no variant in {AUTO_CHAIN} applies: {last}")


def spmv(
    operand,
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    *,
    sr: Semiring,
    variant: str = "ell",
    n_rows: int,
    alpha=None,
    beta=None,
) -> torch.Tensor:
    """y_out[:n_rows] = (α ⊗ (⊕_j A[i,j] ⊗ x[j])) ⊕ (β ⊗ y[i]), on the
    operand's device."""
    dp = get_variant(variant).dp(operand, x, sr, n_rows=n_rows)[:n_rows]
    if y is not None:
        y = y[:n_rows]
    return torch_ops.fold_dp(dp, y, sr, alpha, beta)


def _dp_ell(op, x, sr, *, n_rows):
    return torch_ops.dp_ell(op, x, sr)


register_variant(KernelVariant(
    name="ell",
    build=lambda coo, sr, g, device: torch_ops.build_ell(
        coo, sr, width_multiple=g.block_n, row_multiple=g.block_m,
        device=device),
    dp=_dp_ell,
    description="Padded-ELL gather + row ⊕-reduce in plain torch; the "
                "universal fallback and the tests' oracle",
))

register_variant(KernelVariant(
    name="bsr_band",
    build=lambda coo, sr, g, device: bsr_band.build_bsr_band(
        coo, sr, bm=g.block_m, bn=g.block_n, value_dtype=g.value_dtype,
        device=device),
    dp=bsr_band.dp_bsr_band,
    description="Block-banded CUDA kernel: affine x windows (no gather), "
                "x staged in shared memory or streamed; pure strip "
                "streaming for banded/stencil structure",
))

register_variant(KernelVariant(
    name="coo_seg",
    build=lambda coo, sr, g, device: torch_ops.build_coo_seg(coo, sr, device=device),
    dp=lambda op, x, sr, *, n_rows: torch_ops.dp_coo_seg(op, x, sr, num_rows=n_rows),
    description="Row-sorted segmented ⊕ over COO in plain torch; no padding "
                "blow-up on power-law rows",
))

register_variant(KernelVariant(
    name="dense",
    build=lambda coo, sr, g, device: torch_ops.build_dense(
        coo, sr, row_multiple=g.block_m, col_multiple=g.block_n, device=device),
    dp=lambda op, x, sr, *, n_rows: torch_ops.dp_dense(op, x, sr),
    description="Densified operand in plain torch (a gemv for plus_times); "
                "roofline foil",
))

register_variant(KernelVariant(
    name="dia",
    build=lambda coo, sr, g, device: dia.build_dia(coo, sr, device=device),
    dp=dia.dp_dia,
    description="Diagonal layout in plain torch: shifted slices of x, no "
                "gather; auto routes banded structure to bsr_band instead",
))

register_variant(KernelVariant(
    name="bsr_fused",
    build=lambda coo, sr, g, device: bsr_fused.build_bsr_fused(
        coo, sr, bm=g.block_m, bn=g.block_n, value_dtype=g.value_dtype,
        device=device),
    dp=bsr_fused.dp_bsr_fused,
    description="Blocked CUDA strip kernel with the x block gather in the "
                "kernel; the strips are the only large stream",
))

register_variant(KernelVariant(
    name="bsr_ell",
    build=lambda coo, sr, g, device: bsr_ell.build_bsr_ell(
        coo, sr, bm=g.block_m, bn=g.block_n, value_dtype=g.value_dtype,
        device=device),
    dp=bsr_ell.dp_bsr_ell,
    description="ELL-of-tiles strips over x strips gathered before the CUDA "
                "strip kernel",
))

register_variant(KernelVariant(
    name="bsr_pallas",
    build=lambda coo, sr, g, device: bsr.build_bsr(
        coo, sr, bm=g.block_m, bn=g.block_n, device=device),
    dp=bsr.dp_bsr,
    description="Gen-1 BSR: slabbed (bm, bn) tiles, a CUDA warp per row "
                "walking its tile run; the JAX package's name kept",
))

register_variant(KernelVariant(
    name="sell",
    build=lambda coo, sr, g, device: sell.build_sell(coo, sr, device=device),
    dp=sell.dp_sell,
    description="The JAX package's gen-5 design record: a phase-A contrib "
                "stream packed column-block-major, then gather-reduce "
                "levels; two CUDA kernels, one phase-A launch and one "
                "launch per level depth over every row slab. Not in the "
                "auto chain, as in JAX",
))

register_variant(KernelVariant(
    name="sell2",
    build=lambda coo, sr, g, device: sell2.build_sell2(
        coo, sr, value_dtype=g.value_dtype, device=device),
    dp=sell2.dp_sell2,
    description="Ragged/power-law panels: one CUDA launch over every "
                "(slab, bucket) layout, products in shared memory, runs "
                "reduced in the TPU butterfly's order, rows ⊕-reduced from "
                "a run table; no cap on x",
))
