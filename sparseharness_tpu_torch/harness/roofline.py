"""Speed-of-light (device-memory roofline) model per kernel variant.

Semiring SpMV does one ⊗ and one ⊕ per stored slot against ≥ 2 bytes of
operand traffic, far below any GPU's operations-per-byte balance, so its
bound is bytes moved over the card's memory bandwidth.
"""

from __future__ import annotations

import dataclasses

import torch

#: peak device-memory bandwidth, bytes/s, by a substring of
#: torch.cuda.get_device_name() (NVIDIA's data sheets)
_HBM_BW = {
    "H100 80GB HBM3": 3.35e12,  # H100 SXM
    "H100 PCIe": 2.0e12,
}


def device_hbm_bandwidth(device_name: str) -> float:
    """Bytes/s for a card by name; an unknown card raises."""
    for key, bw in _HBM_BW.items():
        if key in device_name:
            return bw
    raise KeyError(f"no published memory bandwidth for {device_name!r}; "
                   f"known: {sorted(_HBM_BW)}")


def _operand_tensors(operand):
    """Every tensor of an operand, walking into dataclasses, named tuples,
    lists, tuples and dicts."""
    if isinstance(operand, torch.Tensor):
        return [operand]
    if dataclasses.is_dataclass(operand):
        parts = [getattr(operand, f.name) for f in dataclasses.fields(operand)]
    elif isinstance(operand, dict):
        parts = list(operand.values())
    elif isinstance(operand, (list, tuple)):
        parts = list(operand)
    else:
        return []
    return [t for part in parts for t in _operand_tensors(part)]


def variant_bytes(variant: str, operand, x_bytes: int, out_bytes: int) -> int:
    """Least device-memory traffic for one SpMV with this operand, by the
    JAX package's rules, so that roofline_frac means the same in both.

    Blocked kernels (bsr_*): every operand array once + x once + the output
    once. ``ell`` gathers one x element per operand slot, with no reuse to
    count on, so it is charged that gather instead of one x pass;
    ``coo_seg`` one x element per nonzero plus the segment reduction's
    read-modify-write of dp per nonzero.

    ``sell2``: every array of its kernel's plan once (each entry's column
    and value, the row pointers and destinations, the owners' tables), x
    once and the output once: what the CUDA kernel reads. The JAX package
    charges its panel stream, 3× padded, and three x passes, for the
    transposed x tiles that XLA writes before its TPU kernel; the CUDA
    kernel reads neither.

    ``sell``: every array of its slabs (lanesel, vals, blocksel and each
    level's idx) once, x once and the output once. The level outputs are
    intermediates (the fused depth-0 kernel writes no contrib stream), and
    the launch tables are the kernels' own bookkeeping.

    ``bsr_band``: the values of each row's occupied span of the strips
    (``spans.lanes``, from its first to its last stored value), x once and
    the output once. The JAX package charges every strip slot, pads
    included; the CUDA kernel reads only the spans and takes the pads'
    products from a scan of x, so the spans are the least traffic for the
    same work. The span table is the kernel's bookkeeping, and the chunks it
    reads by design are ``ops.bsr_band.band_traffic``'s."""
    if variant == "bsr_band":
        if operand.spans is None:
            raise ValueError("a bsr_band operand without a span table: make it with with_spans")
        return operand.spans.lanes * operand.strips.element_size() + x_bytes + out_bytes
    if variant == "sell2":
        operand = operand.plan
    elif variant == "sell":
        operand = operand.slabs
    tensors = _operand_tensors(operand)
    operand_bytes = sum(t.numel() * t.element_size() for t in tensors)
    itemsize = max((t.element_size() for t in tensors), default=4)
    if variant == "ell":
        slots = max(t.numel() for t in tensors)
        return operand_bytes + slots * itemsize + out_bytes
    if variant == "coo_seg":
        nnz_pad = max(t.shape[0] for t in tensors)
        return operand_bytes + 2 * nnz_pad * itemsize + out_bytes
    return operand_bytes + x_bytes + out_bytes


def roofline_seconds(variant: str, operand, x_bytes: int, out_bytes: int,
                     device_name: str) -> float:
    return variant_bytes(variant, operand, x_bytes, out_bytes) / (
        device_hbm_bandwidth(device_name))
