"""The solver core that every sharded mode shares.

Each rank runs the same loop over its own row block: one step is the
mode's local dot-product step (``local_dp(x_local) -> dp_local``, which
issues its own exchanges: the ring edge exchange, the all-gather), then
``combine``, then, for the eigenvector, the L2 norm over every rank (an
``all_reduce`` of the float32 sum of squares). The changed flag is an
``all_reduce`` of each rank's flag, read back once a step as the port's
single-device ``run_fixpoint`` reads its flag, so ``x``, ``iterations``
and ``converged`` are those of the JAX package's ``lax.while_loop``: the
loop stops at the first step where no rank changed, or at ``max_iter``.
An optional per-row aux channel (the BFS levels) rides along.

What a mode builds for a rank (its shard of the operand on its device,
span tables and plans included) is kept per sharded operand, so a second
solve over the same operand reuses it (:func:`cached`): the counterpart of
the JAX package's solver cache, which saves a retrace there.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Optional

import numpy as np
import torch

from sparseharness_tpu_torch.parallel import comm
from sparseharness_tpu_torch.parallel.mesh import Mesh

#: sharded operand → {key: what was built for it}; an entry goes with its
#: operand
_SOLVER_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


@dataclasses.dataclass(frozen=True)
class ShardedFixpointResult:
    """A sharded solve's result, whole on every rank: ``x`` (n_rows, ...)
    and ``aux`` on the rank's device."""

    x: torch.Tensor
    iterations: int
    converged: bool
    aux: Optional[torch.Tensor] = None


def cached(op, key, build: Callable):
    """``build()`` made once per (``op``, ``key``) while ``op`` lives."""
    per_op = _SOLVER_CACHE.get(op)
    if per_op is None:
        per_op = _SOLVER_CACHE[op] = {}
    if key not in per_op:
        per_op[key] = build()
    return per_op[key]


def mesh_key(mesh: Mesh) -> tuple:
    return (mesh.rank, mesh.size, str(mesh.device), mesh.backend)


def pad_rows(a, rows: int, fill, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``a`` (n, ...) as a tensor of ``rows`` rows, the new ones ``fill``."""
    t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
    t = t.to(device=device, dtype=dtype)
    out = torch.full((rows,) + tuple(t.shape[1:]), fill, dtype=dtype, device=device)
    out[: t.shape[0]] = t
    return out


def local_rows(mesh: Mesh, t: torch.Tensor, chunk: int) -> torch.Tensor:
    """This rank's row block of a padded (size·chunk, ...) tensor."""
    return t[mesh.rank * chunk:(mesh.rank + 1) * chunk].contiguous()


def make_spmv_solver(mesh: Mesh, op, local_dp: Callable, key) -> Callable:
    """The one-shot dp ``x_local -> dp_local`` of a mode, cached per
    operand and configuration."""
    return cached(op, ("spmv", mesh_key(mesh)) + tuple(key), lambda: local_dp)


def make_fixpoint_solver(
    mesh: Mesh,
    op,
    local_dp: Callable,
    *,
    combine: Callable,
    exact: bool,
    delta: float,
    max_iter: int,
    norm: bool,
    with_aux: bool,
    aux_update,
    key,
) -> Callable:
    """The whole-fixpoint solver of a mode: ``fn(x_local[, aux_local]) ->
    (x_fin, aux_fin, iterations, converged)`` on this rank's rows."""

    def build():
        def solve(x_loc, aux=None):
            it, done = 0, False
            while not done and it < max_iter:
                x_new = combine(x_loc, local_dp(x_loc))
                if norm:
                    sq = comm.all_reduce(mesh, (x_new.to(torch.float32) ** 2).sum())
                    nrm = sq.sqrt()
                    x_new = torch.where(nrm > 0, x_new / nrm.to(x_new.dtype), x_new)
                if exact:
                    changed = (x_loc != x_new).any()
                else:
                    changed = ((x_loc - x_new).abs() >= delta).any()
                total = comm.all_reduce(mesh, changed.to(torch.int32))
                if with_aux:
                    aux = aux_update(aux, x_loc, x_new, it)
                x_loc, it = x_new, it + 1
                done = int(total) == 0  # the one readback a step
            return x_loc, aux, it, done

        return solve

    return cached(op, ("fix", mesh_key(mesh), combine, exact, float(delta), int(max_iter),
                       norm, aux_update if with_aux else None) + tuple(key), build)


def run_solver(mesh: Mesh, solver: Callable, x0, sr, *, chunk: int, n_rows: int,
               aux0=None) -> ShardedFixpointResult:
    """Pad x0 (and aux0) to size·chunk rows (x with 0̄, aux with 0), run
    ``solver`` on this rank's block, and gather the result on every rank."""
    r_pad = mesh.size * chunk
    x_pad = pad_rows(x0, r_pad, sr.zero, sr.dtype, mesh.device)
    aux_loc = None
    if aux0 is not None:
        aux_t = torch.as_tensor(np.asarray(aux0)) if not isinstance(aux0, torch.Tensor) else aux0
        aux_loc = local_rows(mesh, pad_rows(aux_t, r_pad, 0, aux_t.dtype, mesh.device), chunk)
    x_fin, aux_fin, iters, done = solver(local_rows(mesh, x_pad, chunk), aux_loc)
    x = comm.all_gather(mesh, x_fin)[:n_rows]
    aux = None if aux_fin is None else comm.all_gather(mesh, aux_fin)[:n_rows]
    return ShardedFixpointResult(x=x, iterations=int(iters), converged=bool(done), aux=aux)
