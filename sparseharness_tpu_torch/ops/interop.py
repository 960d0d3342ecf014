"""Operands from NumPy arrays made elsewhere.

These take the arrays of an operand built elsewhere (the JAX package
builds the same layout) and return the port's operand on a device,
so both packages can be fed identical strips or column ids. bfloat16 arrays
(NumPy's ml_dtypes type) are carried over bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from sparseharness_tpu_torch.ops.bsr_band import BsrBandOperand
from sparseharness_tpu_torch.ops.torch_ops import EllOperand
from sparseharness_tpu_torch.utils.device import DeviceLike, resolve_device


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: JAX hands out read-only views
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def bsr_band_operand_from_numpy(strips: np.ndarray, c0: int, k_win: int,
                                n_cols: int, device: DeviceLike = None) -> BsrBandOperand:
    return BsrBandOperand(strips=_tensor(strips, resolve_device(device)),
                          c0=int(c0), k_win=int(k_win), n_cols=int(n_cols))


def ell_operand_from_numpy(cols: np.ndarray, vals: np.ndarray,
                           device: DeviceLike = None) -> EllOperand:
    device = resolve_device(device)
    return EllOperand(cols=_tensor(cols, device), vals=_tensor(vals, device))
