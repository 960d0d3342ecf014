"""Frontier-compressed exchange for sparse-frontier fixpoints (BFS, SSSP).

The JAX package's ``parallel/frontier.py``. Mid-solve, a BFS or SSSP step
changes few vertices, so all-gathering the whole x every step wastes the
interconnect. Here only the changed entries travel:

- every rank keeps a whole view of x (the cache) beside its own rows;
- each step computes the rank's dp from the cache, through a local
  compute plug: the sell2 kernel by default (``sharded_sell``), the ELL
  gather where sell2's packing refuses the matrix;
- each rank packs its changed (index, value) pairs into fixed-budget
  buffers, one per destination, filtered by a build-time mask of the
  columns each destination's rows reference, and swaps them with one
  ``all_to_all``; the received values are ⊕-applied to the cache (a
  monotone scatter);
- a step exchanges sparsely when every rank's frontier fits the budget,
  else it all-gathers x densely (so the result never depends on the
  budget). A sticky phase bit, set at the first step where every rank
  fits, only sorts the dense steps into the expected warm-up
  (``dense_phase_iters``) and the later overflows (``dense_fallbacks``);
- convergence is the all-reduced changed count.

Each step's counts (changed entries, whether a rank overflowed) are one
``all_reduce`` read back once, since the host chooses the sparse or the
dense exchange; the sent entries add up on each rank and are summed once
at the end.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from sparseharness_tpu_torch.formats.sparse import COO
from sparseharness_tpu_torch.parallel import comm, fixcore
from sparseharness_tpu_torch.parallel.mesh import Mesh, make_mesh
from sparseharness_tpu_torch.parallel.sharded import (
    _ell_shard, _local_dp, bfs_level_stamp, build_sharded_ell, combine_min, combine_or,
)
from sparseharness_tpu_torch.parallel.sharded_sell import (
    build_sharded_sell, sell_dp_full, sell_shard,
)
from sparseharness_tpu_torch.semiring import MIN_PLUS, OR_AND, Semiring
from sparseharness_tpu_torch.utils.device import DeviceLike

FLT_MAX = float(np.finfo(np.float32).max)
INT_MIN, INT_MAX = int(np.iinfo(np.int32).min), int(np.iinfo(np.int32).max)


@dataclasses.dataclass(frozen=True)
class FrontierResult:
    x: torch.Tensor
    iterations: int
    converged: bool
    sent_entries: int           # Σ over steps of exchanged entries
    dense_fallbacks: int        # steps after the switch that overflowed
    aux: Optional[torch.Tensor] = None
    local: str = "ell"          # which local compute ran (sell or ell)
    dense_phase_iters: int = 0  # dense steps before the switch

    def exchanged_bytes(self) -> int:
        """8 B per exchanged (int32 index, 4-byte value) entry."""
        return int(self.sent_entries) * 8

    def allgather_bytes(self, n_rows: int, dtype_bytes: int = 4) -> int:
        """What the dense all-gather would have moved for the same solve."""
        return int(self.iterations) * n_rows * dtype_bytes


def build_needed_cols(coo: COO, n_shards: int, chunk: int, *,
                      device: DeviceLike = "cpu") -> torch.Tensor:
    """(n_shards, n_shards·chunk) bool: does rank d's row block reference
    column j? The all_to_all's filter: entry j goes to d only when d needs
    it. Made once per (matrix, world size)."""
    mask = np.zeros((n_shards, n_shards * chunk), bool)
    mask[coo.rows // chunk, coo.cols] = True
    return torch.from_numpy(mask).to(device)


def _monotone_apply(sr: Semiring) -> str:
    """How received values fold into the cache: the semiring's ⊕ (monotone
    fixpoints only improve entries)."""
    if sr.add is torch.minimum:
        return "amin"
    if sr.add in (torch.maximum, torch.logical_or):
        return "amax"  # bool carried as max on {0, 1}
    raise NotImplementedError(
        f"frontier exchange needs a monotone idempotent ⊕; {sr.name!r} is not "
        "(use the all-gather fixpoint)")


@dataclasses.dataclass(frozen=True, eq=False)
class FrontierSetup:
    """The frontier loop's local-compute plug: the sharded operand, its
    block's rows (``chunk``), which kind it is (``sell`` or ``ell``) and
    ``dp_full(mesh, cache) -> dp_local``."""

    op: object
    chunk: int
    kind: str
    dp_full: Callable


def _sell_dp_full(op, sr):
    def dp_full(mesh, cache):
        return sell_dp_full(sell_shard(mesh, op), op.chunk_rows, cache[:op.n_cols], sr)
    return dp_full


def _ell_dp_full(op, sr):
    def dp_full(mesh, cache):
        cols, vals = _ell_shard(mesh, op)
        return _local_dp(cols, vals, cache, sr)
    return dp_full


def _frontier_setup(coo: COO, sr: Semiring, n_shards: int, local: str = "auto", *,
                    device: DeviceLike = None) -> FrontierSetup:
    """The local compute of a frontier solve: "auto" prefers the sell2
    kernel over the cached x and falls back to the ELL gather when sell2's
    packing refuses the structure; "sell" and "ell" force one."""
    if local not in ("auto", "sell", "ell"):
        raise ValueError(f"unknown frontier local mode {local!r}")
    if local in ("auto", "sell"):
        try:
            op, chunk = build_sharded_sell(coo, sr, n_shards, device=device)
            return FrontierSetup(op, chunk, "sell", _sell_dp_full(op, sr))
        except NotImplementedError:
            if local == "sell":
                raise
    op, chunk = build_sharded_ell(coo, sr, n_shards, device=device)
    return FrontierSetup(op, chunk, "ell", _ell_dp_full(op, sr))


def sharded_fixpoint_frontier(
    mesh: Mesh,
    setup: FrontierSetup,
    needed: torch.Tensor,
    x0,
    sr: Semiring,
    *,
    n_rows: int,
    combine: Callable,
    budget: int = 1024,
    max_iter: int = 10_000,
    aux0=None,
    aux_update: Optional[Callable] = None,
) -> FrontierResult:
    """The fixpoint with the frontier-compressed all_to_all exchange.

    ``setup`` is the local compute (:func:`_frontier_setup`); ``needed``
    the column mask (:func:`build_needed_cols`); ``budget`` the most
    changed entries a rank sends a destination a step (overflow takes the
    dense all-gather for that step)."""
    apply = _monotone_apply(sr)
    d_size, chunk = mesh.size, setup.chunk
    r_pad = d_size * chunk
    carrier = torch.int32 if sr.dtype == torch.bool else sr.dtype
    # the value a masked-out update carries: the fold's identity
    ident = {("amin", torch.float32): float("inf"), ("amax", torch.float32): float("-inf"),
             ("amin", torch.int32): INT_MAX, ("amax", torch.int32): INT_MIN}[(apply, carrier)]
    need = needed.to(mesh.device)
    row0 = mesh.rank * chunk
    x_loc = fixcore.local_rows(
        mesh, fixcore.pad_rows(x0, r_pad, sr.zero, sr.dtype, mesh.device), chunk)
    aux = None
    if aux_update is not None:
        aux_t = torch.as_tensor(np.asarray(aux0))
        aux = fixcore.local_rows(mesh, fixcore.pad_rows(aux_t, r_pad, 0, aux_t.dtype,
                                                        mesh.device), chunk)

    def exchange_sparse(cache, x_new, changed):
        idx = torch.nonzero(changed).flatten()  # fits the budget: no rank overflowed
        gidx = torch.full((budget,), r_pad, dtype=torch.int64, device=mesh.device)
        gidx[:idx.numel()] = idx + row0
        vals = torch.full((budget,), sr.zero, dtype=sr.dtype, device=mesh.device)
        vals[:idx.numel()] = x_new[idx]
        valid = gidx < r_pad
        # send entry j to rank d only if d's rows reference column j
        wanted = need[:, gidx.clamp(max=r_pad - 1)] & valid[None, :]
        send_idx = torch.where(wanted, gidx[None, :], r_pad).to(torch.int32)
        send_val = vals.to(carrier)[None, :].expand(d_size, budget)
        recv_idx = comm.all_to_all(mesh, send_idx).reshape(-1).long()
        recv_val = comm.all_to_all(mesh, send_val).reshape(-1)
        ok = recv_idx < r_pad
        upd = torch.where(ok, recv_val, torch.full_like(recv_val, ident))
        cache_c = cache.to(carrier).scatter_reduce(0, recv_idx.clamp(max=r_pad - 1), upd, apply)
        return cache_c.to(sr.dtype), int((send_idx < r_pad).sum())

    cache = comm.all_gather(mesh, x_loc)
    it, done, sent, dense_n, dense_ph, phase = 0, False, 0, 0, 0, False
    while not done and it < max_iter:
        x_new = combine(x_loc, setup.dp_full(mesh, cache))
        changed = x_new != x_loc
        count = changed.sum()
        totals = comm.all_reduce(mesh, torch.stack([count, (count > budget).long()]))
        total, overflow = (int(v) for v in totals.tolist())  # the one readback a step
        overflow = overflow > 0
        if overflow:
            cache = comm.all_gather(mesh, x_new)
            dense_n += int(phase)
            dense_ph += int(not phase)
        else:
            cache, n_sent = exchange_sparse(cache, x_new, changed)
            sent += n_sent
        phase = phase or not overflow
        if aux_update is not None:
            aux = aux_update(aux, x_loc, x_new, it)
        x_loc, it, done = x_new, it + 1, total == 0
    sent_all = int(comm.all_reduce(mesh, torch.tensor(sent, dtype=torch.int64,
                                                      device=mesh.device)))
    x = comm.all_gather(mesh, x_loc)[:n_rows]
    aux_out = None if aux is None else comm.all_gather(mesh, aux)[:n_rows]
    return FrontierResult(x=x, iterations=it, converged=done, sent_entries=sent_all,
                          dense_fallbacks=dense_n, aux=aux_out, local=setup.kind,
                          dense_phase_iters=dense_ph)


# -------------------------------------------------------- algorithm wrappers


def frontier_sssp(coo: COO, root: int, mesh: Optional[Mesh] = None, budget: int = 1024,
                  max_iter: Optional[int] = None, local: str = "auto",
                  return_solver: bool = False, *, device: DeviceLike = None):
    """SSSP over the mesh with the frontier exchange."""
    mesh = mesh or make_mesh(device=device)
    setup = _frontier_setup(coo, MIN_PLUS, mesh.size, local, device=mesh.device)
    needed = build_needed_cols(coo, mesh.size, setup.chunk, device=mesh.device)
    n = coo.shape[0]
    x0 = np.full(n, FLT_MAX, np.float32)
    x0[root] = 0.0

    def run():
        return sharded_fixpoint_frontier(
            mesh, setup, needed, x0, MIN_PLUS, n_rows=n, combine=combine_min, budget=budget,
            max_iter=max_iter if max_iter is not None else n)

    return run if return_solver else run()


def frontier_bfs(coo: COO, root: int, mesh: Optional[Mesh] = None, budget: int = 1024,
                 max_iter: Optional[int] = None, local: str = "auto",
                 return_solver: bool = False, *, device: DeviceLike = None):
    """BFS over the mesh with the frontier exchange: .x reachability and
    .aux levels."""
    mesh = mesh or make_mesh(device=device)
    setup = _frontier_setup(coo, OR_AND, mesh.size, local, device=mesh.device)
    needed = build_needed_cols(coo, mesh.size, setup.chunk, device=mesh.device)
    n = coo.shape[0]
    x0 = np.zeros(n, bool)
    x0[root] = True
    levels0 = np.full(n, -1, np.int32)
    levels0[root] = 0

    def run():
        return sharded_fixpoint_frontier(
            mesh, setup, needed, x0, OR_AND, n_rows=n, combine=combine_or, budget=budget,
            max_iter=max_iter or n + 1, aux0=levels0, aux_update=bfs_level_stamp)

    return run if return_solver else run()
