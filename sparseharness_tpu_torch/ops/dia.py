"""The ``dia`` (diagonal) variant: gather-free by construction.

For matrices whose nonzeros sit on few diagonals (stencils above all)::

    dp[i] = ⊕_j  vals[j, i] ⊗ x[i + off_j]

with x taken as 0̄ outside [0, n). The operand is the JAX package's: the
(D, n) values, 0̄ in every slot off the matrix, and the D offsets.

On a CUDA tensor :func:`dp_dia` launches the kernel of ``csrc/dia.cu``, a
thread a row, which checks the bounds of ``i + off_j`` itself, so x is
never padded or copied. An SpMV with no y or α is that one launch: with
``fold`` the kernel applies ``torch_ops.fold_dp``'s ⊕-clamp itself. On a
CPU tensor it runs :func:`dp_dia_plain`, the plain torch version: each
term an elementwise ⊗ against a shifted slice of a padded x, the terms
⊕-combined in a balanced tree, in the JAX package's order.

``variant="auto"`` tries ``dia`` after ``bsr_band`` (whose affine window a
stencil's far diagonals overflow), behind :func:`auto_guard`, which admits
only square matrices of few, well-filled diagonals and refuses the rest
without folding or sorting them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from sparseharness_tpu_torch.formats.sparse import COO
from sparseharness_tpu_torch.ops import _build, torch_ops
from sparseharness_tpu_torch.ops.bsr import fold_on_device
from sparseharness_tpu_torch.semiring import Semiring
from sparseharness_tpu_torch.semiring.core import _np_fold_for
from sparseharness_tpu_torch.utils.device import DeviceLike, resolve_device
from sparseharness_tpu_torch.utils.timing import span

# beyond this many distinct diagonals the format degrades to dense-like
# traffic; the build refuses so that other variants take the matrix
MAX_DIAGONALS = 512

#: auto's cap on distinct diagonals. A 2-D 9-point stencil has 9, a 3-D
#: 27-point one (HPCG's) 27; a band of more than 64 well-filled diagonals
#: is bsr_band's, which auto tries first. Under the cap a strided sample
#: decides most refusals, so a power-law graph is refused in microseconds.
AUTO_MAX_DIAGONALS = 64
#: auto's least share of the D × n value slots that stored entries fill:
#: below a half the kernel would read more 0̄ than entries
AUTO_MIN_FILL = 0.5
#: entries of the strided sample that :func:`auto_guard` looks at first
GUARD_SAMPLE = 4096


@dataclasses.dataclass(frozen=True)
class DiaOperand:
    """vals[j, :] holds diagonal off_j: vals[j, i] = A[i, i + off_j]."""

    vals: torch.Tensor
    offsets: Tuple[int, ...]


def _offset_counts(coo: COO) -> np.ndarray:
    """How many entries lie on each of the 2n − 1 diagonals, from −(n − 1),
    counted without a sort."""
    n = coo.shape[0]
    offs = np.subtract(coo.cols, coo.rows, dtype=np.int64)
    offs += n - 1
    return np.bincount(offs, minlength=max(2 * n - 1, 1))


def auto_guard(coo: COO) -> Tuple[Optional[str], dict]:
    """(why ``auto`` refuses ``coo`` for dia, or None; the ``diagonals``
    and ``fill`` found, for the ``build.try`` span).

    Admits a square matrix of at most :data:`AUTO_MAX_DIAGONALS` distinct
    diagonals whose stored entries fill at least :data:`AUTO_MIN_FILL` of
    the D × n slots. Entries are counted before any fold: duplicates can
    only overstate the fill, and the build folds them anyway. A strided
    sample of :data:`GUARD_SAMPLE` entries is counted first; only a matrix
    that passes it is counted in full, by a bincount of its offsets."""
    n, c = coo.shape
    if n != c:
        return "not square", {}
    if coo.nnz == 0:
        return "no entries", {"diagonals": 0}
    step = max(1, coo.nnz // GUARD_SAMPLE)
    # a set, not np.unique, whose first call in a process took 0.08–0.1 s
    # with NumPy 2.3
    sample = set((coo.cols[::step].astype(np.int64) - coo.rows[::step]).tolist())
    if len(sample) > AUTO_MAX_DIAGONALS:
        return (f"{len(sample)} diagonals in a sample exceed auto's {AUTO_MAX_DIAGONALS}",
                {"diagonals": len(sample)})
    d = int(np.count_nonzero(_offset_counts(coo)))
    attrs = {"diagonals": d, "fill": coo.nnz / (d * n)}
    if d > AUTO_MAX_DIAGONALS:
        return f"{d} diagonals exceed auto's {AUTO_MAX_DIAGONALS}", attrs
    if attrs["fill"] < AUTO_MIN_FILL:
        return f"entries fill {attrs['fill']:.3f} of the slots, under {AUTO_MIN_FILL}", attrs
    return None, attrs


def build_dia(coo: COO, sr: Semiring, value_dtype: str = "float32", *,
              device: DeviceLike = None) -> DiaOperand:
    """The JAX package's operand, built on ``device``; with ``value_dtype``
    "bfloat16" a float semiring's values are stored in bfloat16 (rounded
    to nearest even). Duplicates are ⊕-folded on the host, in the JAX
    package's order, only where a check on the device finds some; the
    diagonals are counted and the values placed on the device. Each stage
    is a ``build.encode`` span."""
    device = resolve_device(device)
    if coo.shape[0] != coo.shape[1]:
        raise NotImplementedError("dia variant requires a square matrix")
    n = coo.shape[0]
    with span("build.encode", stage="fold"):
        coo = fold_on_device(coo, _np_fold_for(sr, False), device)
    # in place where it can be: three int64 arrays of the entries at most
    with span("build.encode", stage="offsets"):
        rows = torch.from_numpy(coo.rows).to(device=device, dtype=torch.int64)
        diag = torch.from_numpy(coo.cols).to(device=device, dtype=torch.int64)
        diag -= rows
        diag += n - 1  # the diagonal's index from −(n − 1)
        counts = torch.bincount(diag, minlength=max(2 * n - 1, 1))
        present = torch.nonzero(counts).flatten()  # ascending
        d = present.numel()
        if d > MAX_DIAGONALS:
            raise NotImplementedError(f"{d} diagonals exceeds DIA limit {MAX_DIAGONALS}")
        slot = torch.zeros_like(counts)
        slot[present] = torch.arange(d, device=device)
        del counts
    with span("build.encode", stage="fill+upload"):
        place = slot[diag]
        del diag, slot
        place *= n
        place += rows  # the entry's place in the flat (D, n) values
        del rows
        vals = torch.full((max(d, 1) * n,), sr.zero, dtype=sr.dtype, device=device)
        vals[place] = torch.from_numpy(
            np.ascontiguousarray(coo.vals.astype(sr.np_dtype))).to(device)
        del place
        vals = vals.view(max(d, 1), n)
        if value_dtype == "bfloat16" and sr.dtype == torch.float32:
            vals = vals.to(torch.bfloat16)
    return DiaOperand(vals, tuple((present - (n - 1)).tolist()))


def dp_dia(op: DiaOperand, x: torch.Tensor, sr: Semiring, *,
           n_rows: int, fold: bool = False) -> torch.Tensor:
    """The dp of the first n_rows rows, in the semiring's type; with
    ``fold``, ⊕-combined with 0̄ as :func:`torch_ops.fold_dp` does with no
    y or α, which makes it an SpMV's answer. On a CUDA tensor this launches
    the kernel, which folds in the same launch; on a CPU tensor it runs the
    plain version."""
    if op.vals.is_cuda:
        return dia_dp_cuda(op, x, sr, n_rows=n_rows, fold=fold)
    dp = dp_dia_plain(op, x, sr, n_rows=n_rows)
    return torch_ops.fold_dp(dp, None, sr, None, None) if fold else dp


@functools.lru_cache(maxsize=64)
def _c_offsets(offsets: Tuple[int, ...]):
    return (ctypes.c_int * len(offsets))(*offsets)


_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
             + [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def dia_dp_cuda(op: DiaOperand, x: torch.Tensor, sr: Semiring, *,
                n_rows: int, fold: bool = False) -> torch.Tensor:
    """Launch the diagonal kernel: the dp (n_rows,) in the semiring's type,
    ⊕-combined with 0̄ in the kernel where ``fold`` is set. Raises on what
    the kernel does not take and on a refused launch.

    The host's work here is a share of a call: a stencil's call takes
    about 45 µs on the card. So the device is an index (``get_device``,
    not a ``torch.device``) and the stream the raw handle of PyTorch's
    current stream (``_cuda_getCurrentRawStream``, which PyTorch's own
    kernel launchers read), without a ``torch.cuda.Stream`` made a call."""
    vals = op.vals
    if not op.offsets:
        return torch.full((n_rows,), sr.zero, dtype=sr.dtype, device=vals.device)
    if x.dtype != sr.dtype:
        x = x.to(sr.dtype)
    dev = vals.get_device()
    if x.get_device() != dev or not (x.is_contiguous() and vals.is_contiguous()):
        raise ValueError("dia_dp_cuda needs contiguous tensors on one CUDA device")
    out = torch.empty(n_rows, dtype=sr.dtype, device=vals.device)
    fn = _build.function("dia", "sh_dia_dp", _ARGTYPES)
    _build.check_launch("dia", fn(
        dev, vals.data_ptr(), x.data_ptr(), out.data_ptr(), n_rows, vals.shape[1],
        x.shape[0], _c_offsets(op.offsets), len(op.offsets), _build.SR_CODES[sr.name],
        _build.STRIP_CODES[vals.dtype], int(fold), torch._C._cuda_getCurrentRawStream(dev),
    ))
    _build.LAUNCHES["dia"] += 1
    return out


def dp_dia_plain(op: DiaOperand, x: torch.Tensor, sr: Semiring, *,
                 n_rows: int) -> torch.Tensor:
    """The plain torch version of :func:`dp_dia`, on any device."""
    n = n_rows
    offs = op.offsets
    if not offs:
        return torch.full((n,), sr.zero, dtype=sr.dtype, device=x.device)
    span_lo = max(0, -min(offs))
    span_hi = max(0, max(offs))
    x_pad = torch.full((span_lo + x.shape[0] + span_hi,), sr.zero,
                       dtype=sr.dtype, device=x.device)
    x_pad[span_lo: span_lo + x.shape[0]] = x.to(sr.dtype)
    terms = [sr.mul(x_pad[span_lo + o: span_lo + o + n], op.vals[j, :n])
             for j, o in enumerate(offs)]
    # a balanced ⊕ tree, as the JAX package combines them
    while len(terms) > 1:
        terms = [sr.add(terms[i], terms[i + 1]) if i + 1 < len(terms) else terms[i]
                 for i in range(0, len(terms), 2)]
    return terms[0]
