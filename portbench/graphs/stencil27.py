"""HPCG's matrix (``src/GenerateProblem_ref.cpp`` of the reference code
3.1): the 27-point stencil on one process's nx × ny × nz local grid, with
no neighbouring process, so no external column.

Row ``iz·nx·ny + iy·nx + ix`` holds a column for each (sx, sy, sz) in
{−1, 0, 1}³ whose point stays inside the grid, in the reference code's
loop order (sz, then sy, then sx: columns ascending), so the entries come
row-major with no duplicate. HPCG's values (26 on the diagonal, −1
elsewhere) are replaced by float32 U[lo, hi), one per entry, drawn on the
device from the run's seed, as ``band.py`` draws its own."""

from __future__ import annotations

import torch


def offsets(nx: int, ny: int) -> torch.Tensor:
    """The 27 column offsets col − row, in the reference code's loop
    order."""
    s = torch.tensor([-1, 0, 1], dtype=torch.int64)
    sz, sy, sx = torch.meshgrid(s, s, s, indexing="ij")
    return (sz * nx * ny + sy * nx + sx).flatten()


def make(params: dict, seed: int, device):
    nx, ny, nz = (int(params[k]) for k in ("nx", "ny", "nz"))
    lo, hi = (float(v) for v in params["values"])
    n = nx * ny * nz
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    s = torch.tensor([-1, 0, 1], dtype=torch.int64, device=device)
    sz, sy, sx = (t.flatten() for t in torch.meshgrid(s, s, s, indexing="ij"))
    rows = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    ix, iy, iz = rows % nx, rows // nx % ny, rows // (nx * ny)
    inside = ((ix + sx >= 0) & (ix + sx < nx) & (iy + sy >= 0) & (iy + sy < ny)
              & (iz + sz >= 0) & (iz + sz < nz))
    del ix, iy, iz
    cols = (rows + offsets(nx, ny).to(device)[None, :])[inside]
    rows = rows.expand_as(inside)[inside]
    vals = torch.rand(cols.numel(), generator=g, device=device) * (hi - lo) + lo
    return rows, cols, vals, n
