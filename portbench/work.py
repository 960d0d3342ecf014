"""The yardstick of the kernel rooflines: the least bytes one SpMV over a
matrix must move, counted from the matrix and never from an operand that a
variant built, over the card's published memory bandwidth.

One SpMV reads each stored value once (4 bytes in float32, after duplicate
entries are folded into one), reads x once and writes the output once.
Indices of any format are left out on purpose: the count is the same
whatever layout implements the product, so a change of format cannot make
it stale, and no kernel can read above 100% of it.
"""

from __future__ import annotations

#: published peak device-memory bandwidth of one NVIDIA H100 SXM (80 GB
#: HBM3), bytes/s, at its full 700 W power limit (NVIDIA's data sheet)
H100_HBM_BYTES_PER_S = 3.35e12

VALUE_BYTES = 4  # float32


def spmv_bytes(n_rows: int, n_cols: int, folded_entries: int) -> int:
    """Bytes of one float32 SpMV: the folded values, x and the output."""
    return VALUE_BYTES * (int(folded_entries) + int(n_cols) + int(n_rows))


def spmv_bound_s(n_rows: int, n_cols: int, folded_entries: int) -> float:
    """The least seconds one SpMV can take on an H100 at 700 W."""
    return spmv_bytes(n_rows, n_cols, folded_entries) / H100_HBM_BYTES_PER_S
