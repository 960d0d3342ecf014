"""The automatically sharded SpMV: the operand placed as a DTensor.

The JAX package's ``parallel/auto.py`` places a rows-divisible ELL operand
row-sharded and x replicated, and lets XLA's partitioner run the ordinary
single-device ``spmv``. Here the operand's rows become a DTensor with
``Shard(0)`` over a 1-D device mesh of the world, x one with
``Replicate()``, and each rank runs the port's ordinary ``spmv`` on
``to_local()`` of its rows: DTensor's propagation through the semiring
gather and reduce is not relied on. The rank blocks of y are joined into
one DTensor whose ``full_tensor()`` is the result, whole on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch

from sparseharness_tpu_torch.formats.sparse import COO
from sparseharness_tpu_torch.ops import Geometry, build_operand, spmv
from sparseharness_tpu_torch.ops.torch_ops import EllOperand
from sparseharness_tpu_torch.parallel.mesh import Mesh
from sparseharness_tpu_torch.semiring import Semiring


def _device_mesh(mesh: Mesh):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(mesh.device.type, (mesh.size,))


def _dtensor():
    # the public module since torch 2.4; the private one before it
    try:
        from torch.distributed import tensor
    except ImportError:  # pragma: no cover - older torch
        from torch.distributed import _tensor as tensor
    return tensor


def shard_operand_rows(op: EllOperand, mesh: Mesh) -> EllOperand:
    """``op`` (built whole on every rank, rows divisible by the world's
    size) with its cols and vals as DTensors of this rank's rows,
    ``Shard(0)``."""
    t = _dtensor()
    dmesh = _device_mesh(mesh)
    rows = op.cols.shape[0] // mesh.size
    sl = slice(mesh.rank * rows, (mesh.rank + 1) * rows)
    return EllOperand(
        cols=t.DTensor.from_local(op.cols[sl].to(mesh.device), dmesh, [t.Shard(0)],
                                  run_check=False),
        vals=t.DTensor.from_local(op.vals[sl].to(mesh.device), dmesh, [t.Shard(0)],
                                  run_check=False))


def auto_sharded_spmv(mesh: Mesh, coo: COO, sr: Semiring, x, y=None, alpha=None,
                      beta=None) -> torch.Tensor:
    """Build the rows-divisible ELL operand (``Geometry(block_m=8·size)``),
    place its rows with ``Shard(0)`` and x with ``Replicate()``, and run
    the ordinary ``spmv`` on each rank's rows; y whole on every rank."""
    t = _dtensor()
    d = mesh.size
    op = build_operand(coo, sr, "ell", Geometry(block_m=8 * d, block_n=128),
                       device=mesh.device)
    sharded = shard_operand_rows(op, mesh)
    dmesh = sharded.cols.device_mesh
    x_rep = t.DTensor.from_local(torch.as_tensor(x).to(mesh.device, sr.dtype), dmesh,
                                 [t.Replicate()], run_check=False)
    rows = sharded.cols.to_local().shape[0]
    row0 = mesh.rank * rows
    n_rows = coo.shape[0]
    local_n = max(min(rows, n_rows - row0), 0)
    y_loc: Optional[torch.Tensor] = None
    if y is not None:
        y_loc = torch.as_tensor(y).to(mesh.device, sr.dtype)[row0:row0 + local_n]
    local = EllOperand(cols=sharded.cols.to_local(), vals=sharded.vals.to_local())
    out = spmv(local, x_rep.to_local(), y_loc, sr=sr, variant="ell", n_rows=local_n,
               alpha=alpha, beta=beta)
    # a block of the padded rows, whole (rows,) on every rank, so that the
    # Shard(0) DTensor is even
    block = torch.full((rows,), sr.zero, dtype=out.dtype, device=mesh.device)
    block[:out.shape[0]] = out
    return t.DTensor.from_local(block, dmesh, [t.Shard(0)],
                                run_check=False).full_tensor()[:n_rows]
