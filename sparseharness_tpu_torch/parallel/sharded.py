"""Row-sharded semiring SpMV and fixpoints on ``torch.distributed``.

The JAX package's ``parallel/sharded.py``, where ``shard_map`` becomes one
process a rank and every function here runs on every rank of a world
(``parallel/launch.py:run_world``, or the caller's own):

- rows are block-partitioned over the ranks: each owns a contiguous row
  block of a padded ELL operand (the gather and halo modes here), of a
  window-local band operand (``sharded_band``), of a sell2 operand
  (``sharded_sell``) or of tile strips (``sharded_spmm``);
- x lives row-sharded between steps and is all-gathered at the top of
  each step (gather mode), or the ring exchanges the halo edges (halo and
  band modes);
- the fixpoint's changed flag is an ``all_reduce`` read back once a step
  (``parallel/fixcore.py``).

Every result is whole on every rank. The builders are the JAX package's,
with the arrays on a torch device; the local dot-products of the gather
and halo modes are plain torch (the JAX package's are XLA gathers).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from sparseharness_tpu_torch.formats.preprocess import pagerank_normalise, scc_normalise
from sparseharness_tpu_torch.formats.sparse import COO, round_up
from sparseharness_tpu_torch.parallel import comm, fixcore
from sparseharness_tpu_torch.parallel.fixcore import ShardedFixpointResult
from sparseharness_tpu_torch.parallel.mesh import Mesh, make_mesh
from sparseharness_tpu_torch.parallel.sharded_band import (
    build_sharded_band, sharded_fixpoint_band,
)
from sparseharness_tpu_torch.parallel.sharded_sell import (
    build_sharded_sell, sharded_fixpoint_sell,
)
from sparseharness_tpu_torch.semiring import (
    MAX_RIGHT, MIN_PLUS, OR_AND, PLUS_TIMES, Semiring,
)
from sparseharness_tpu_torch.utils.device import DeviceLike, resolve_device

FLT_MAX = float(np.finfo(np.float32).max)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedEll:
    """Every rank's padded-ELL block, leading dim = rank.

    cols, vals: (size, chunk, width); column ids are global (they index the
    all-gathered x). Pad slots: column 0, value 0̄."""

    cols: torch.Tensor
    vals: torch.Tensor


def _ell_arrays(coo: COO, sr: Semiring, n_shards: int, chunk: int, width: int,
                device: torch.device, halo: Optional[int] = None):
    """(cols, vals) (n_shards, chunk, width) on ``device``: each row's
    entries in column order at its first slots; with ``halo`` the columns
    are window-local, less rank·chunk − halo. The JAX package's NumPy
    build, with the per-entry work in torch."""
    n, c = coo.shape
    with np.errstate(invalid="ignore"):
        vals_np = np.ascontiguousarray(coo.vals.astype(sr.np_dtype))
    rows = torch.from_numpy(coo.rows).to(device=device, dtype=torch.int64)
    cols = torch.from_numpy(coo.cols).to(device=device, dtype=torch.int64)
    vals = torch.from_numpy(vals_np).to(device)
    key = rows * max(c, 1) + cols
    if coo.nnz > 1 and not bool((key[1:] >= key[:-1]).all()):
        # by (row, col), stable: the order of COO.sorted_by_row's lexsort
        order = torch.sort(key, stable=True).indices
        rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(torch.bincount(rows, minlength=n), 0, out=indptr[1:])
    pos = torch.arange(coo.nnz, device=device) - indptr[rows]
    shard_idx, local_row = rows // chunk, rows % chunk
    if halo is not None:
        cols = cols - (shard_idx * chunk - halo)
    out_cols = torch.zeros((n_shards, chunk, width), dtype=torch.int32, device=device)
    out_vals = torch.full((n_shards, chunk, width), sr.zero, dtype=sr.dtype, device=device)
    out_cols[shard_idx, local_row, pos] = cols.to(torch.int32)
    out_vals[shard_idx, local_row, pos] = vals
    return out_cols, out_vals


def _width(coo: COO, width_multiple: int) -> int:
    lengths = np.bincount(coo.rows, minlength=coo.shape[0])
    longest = int(lengths.max()) if len(lengths) else 1
    return max(round_up(max(longest, 1), width_multiple), width_multiple)


def build_sharded_ell(
    coo: COO,
    sr: Semiring,
    n_shards: int,
    width_multiple: int = 128,
    row_multiple: int = 8,
    *,
    device: DeviceLike = None,
) -> Tuple[ShardedEll, int]:
    """Row-block partition: rank d owns rows [d·chunk, (d + 1)·chunk).

    Every rank has one width (the longest row, padded), so the stacked
    arrays are rectangular. Returns (operand, chunk); the padded row count
    is n_shards · chunk."""
    device = resolve_device(device)
    chunk = round_up(max(-(-coo.shape[0] // n_shards), 1), row_multiple)
    cols, vals = _ell_arrays(coo, sr, n_shards, chunk, _width(coo, width_multiple), device)
    return ShardedEll(cols=cols, vals=vals), chunk


def _local_dp(cols: torch.Tensor, vals: torch.Tensor, x_full: torch.Tensor,
              sr: Semiring) -> torch.Tensor:
    """One rank's dp over its row block from the gathered x (r_pad,), or an
    (r_pad, m) block of m right-hand sides (the batched multi-source
    fixpoint), then the ⊕-identity clamp (saturates min_plus overflow,
    normalises empty rows)."""
    gathered = x_full[cols.long()]            # (rows, W) or (rows, W, m)
    v = vals if gathered.dim() == vals.dim() else vals[..., None]
    dp = sr.add_reduce(sr.mul(gathered, v), dim=1)
    return sr.add(dp, torch.full_like(dp, sr.zero))


# hashable-by-value combine functions (their identity keys the cache)


def combine_min(x, dp):
    return torch.minimum(x, dp)


def combine_max(x, dp):
    return torch.maximum(x, dp)


def combine_or(x, dp):
    return torch.logical_or(x, dp)


def combine_keep_dp(x, dp):
    return dp


@dataclasses.dataclass(frozen=True)
class CombineAddConst:
    """dp + const (PageRank's teleport): equal constants hash equal, so the
    cache hits across calls."""

    const: float

    def __call__(self, x, dp):
        return dp + torch.full((), self.const, dtype=dp.dtype, device=dp.device)


def bfs_level_stamp(levels, x_old, x_new, it):
    """Stamp the step on newly reached vertices (the single-device bfs aux)."""
    return torch.where(x_new & ~x_old, it + 1, levels)


def _ell_shard(mesh: Mesh, op) -> tuple:
    """This rank's (cols, vals) block on its device, made once per operand."""
    if op.cols.shape[0] != mesh.size:
        raise ValueError(f"operand of {op.cols.shape[0]} shards on a mesh of "
                         f"{mesh.size} ranks")
    return fixcore.cached(op, ("ell_shard", fixcore.mesh_key(mesh)), lambda: (
        op.cols[mesh.rank].to(mesh.device),
        op.vals[mesh.rank].to(mesh.device)))


def _ell_local_dp(mesh: Mesh, op, sr: Semiring, halo: Optional[int]) -> Callable:
    """The gather (halo None) or halo mode's step ``x_local -> dp_local``."""
    cols, vals = _ell_shard(mesh, op)
    if halo is None:
        return lambda x_loc: _local_dp(cols, vals, comm.all_gather(mesh, x_loc), sr)
    return lambda x_loc: _local_dp(cols, vals, _halo_window(mesh, x_loc, halo), sr)


def sharded_spmv(mesh: Mesh, op: ShardedEll, x, sr: Semiring, n_rows: int) -> torch.Tensor:
    """One y = A ⊗ x with rows sharded and x all-gathered; the whole y on
    every rank."""
    chunk = op.cols.shape[1]
    x_pad = fixcore.pad_rows(x, mesh.size * chunk, sr.zero, sr.dtype, mesh.device)
    solver = fixcore.make_spmv_solver(mesh, op, _ell_local_dp(mesh, op, sr, None),
                                      key=("gather", sr.name))
    dp = solver(fixcore.local_rows(mesh, x_pad, chunk))
    return comm.all_gather(mesh, dp)[:n_rows]


# ---------------------------------------------------------------- halo mode


@dataclasses.dataclass(frozen=True, eq=False)
class HaloEll:
    """Row-sharded ELL whose columns are *window-local*: rank d's entries
    index [d·chunk − halo, (d + 1)·chunk + halo), so each step exchanges
    only the halo edges with the ring neighbours instead of all-gathering
    x. The build refuses a matrix that is not banded enough."""

    cols: torch.Tensor  # int32 (size, chunk, width), window-local; pads → 0
    vals: torch.Tensor  # (size, chunk, width)
    halo: int


def build_sharded_ell_halo(
    coo: COO,
    sr: Semiring,
    n_shards: int,
    width_multiple: int = 128,
    row_multiple: int = 8,
    halo_multiple: int = 8,
    *,
    device: DeviceLike = None,
) -> Tuple[HaloEll, int]:
    """:func:`build_sharded_ell` with window-local columns. Raises
    ValueError when the halo needed exceeds the chunk (entries reach past
    the ring neighbours)."""
    device = resolve_device(device)
    n = coo.shape[0]
    chunk = round_up(max(-(-n // n_shards), 1), row_multiple)
    rows = torch.from_numpy(coo.rows).to(device=device, dtype=torch.int64)
    cols = torch.from_numpy(coo.cols).to(device=device, dtype=torch.int64)
    starts = rows // chunk * chunk
    reach_left = int((starts - cols).clamp(min=0).max()) if coo.nnz else 0
    reach_right = int((cols - (starts + chunk - 1)).clamp(min=0).max()) if coo.nnz else 0
    del rows, cols, starts
    halo = round_up(max(reach_left, reach_right, 1), halo_multiple)
    if halo > chunk:
        raise ValueError(
            f"halo {halo} exceeds chunk {chunk}: matrix is not banded enough "
            "for neighbour-only exchange; use build_sharded_ell (all-gather)")
    cols, vals = _ell_arrays(coo, sr, n_shards, chunk, _width(coo, width_multiple), device,
                             halo=halo)
    return HaloEll(cols=cols, vals=vals, halo=halo), chunk


def _halo_window(mesh: Mesh, x_local: torch.Tensor, halo: int) -> torch.Tensor:
    """[left neighbour's right edge | x_local | right neighbour's left
    edge] by the two ring exchanges (the wrapped edges hold other rows, but
    only pad slots, whose ⊗ annihilates, index them)."""
    from_left, from_right = comm.start_ring_exchange(mesh, x_local[-halo:], x_local[:halo])()
    return torch.cat([from_left, x_local, from_right])


def sharded_spmv_halo(mesh: Mesh, op: HaloEll, x, sr: Semiring, n_rows: int) -> torch.Tensor:
    """One y = A ⊗ x with the halo exchange instead of the all-gather:
    O(halo) traffic a rank."""
    chunk = op.cols.shape[1]
    x_pad = fixcore.pad_rows(x, mesh.size * chunk, sr.zero, sr.dtype, mesh.device)
    solver = fixcore.make_spmv_solver(mesh, op, _ell_local_dp(mesh, op, sr, op.halo),
                                      key=("halo", sr.name))
    dp = solver(fixcore.local_rows(mesh, x_pad, chunk))
    return comm.all_gather(mesh, dp)[:n_rows]


# ------------------------------------------------------------------ fixpoint


def _run_ell_fixpoint(mesh: Mesh, op, x0, sr: Semiring, *, halo: Optional[int],
                      n_rows: int, combine: Callable, exact: bool, delta: float,
                      max_iter: int, norm: bool, aux0, aux_update) -> ShardedFixpointResult:
    """The gather and halo modes' fixpoint. ``x0`` may be (n,), one
    source, or (n, m): m sources in one SpMM fixpoint (rows sharded, the
    source axis whole on every rank)."""
    solver = fixcore.make_fixpoint_solver(
        mesh, op, _ell_local_dp(mesh, op, sr, halo), combine=combine, exact=exact,
        delta=delta, max_iter=max_iter, norm=norm, with_aux=aux_update is not None,
        aux_update=aux_update, key=("ell", halo, sr.name))
    return fixcore.run_solver(mesh, solver, x0, sr, chunk=op.cols.shape[1], n_rows=n_rows,
                              aux0=aux0 if aux_update is not None else None)


def sharded_fixpoint(mesh: Mesh, op: ShardedEll, x0, sr: Semiring, *, n_rows: int,
                     combine: Callable, exact: bool = True, delta: float = 0.0,
                     max_iter: int = 10_000, norm: bool = False, aux0=None,
                     aux_update: Optional[Callable] = None) -> ShardedFixpointResult:
    """The whole fixpoint over the mesh: x all-gathered each step, the
    changed flag all-reduced. ``norm`` L2-normalises x over every rank
    (the eigenvector)."""
    return _run_ell_fixpoint(mesh, op, x0, sr, halo=None, n_rows=n_rows, combine=combine,
                             exact=exact, delta=delta, max_iter=max_iter, norm=norm,
                             aux0=aux0, aux_update=aux_update)


def sharded_fixpoint_halo(mesh: Mesh, op: HaloEll, x0, sr: Semiring, *, n_rows: int,
                          combine: Callable, exact: bool = True, delta: float = 0.0,
                          max_iter: int = 10_000, norm: bool = False, aux0=None,
                          aux_update: Optional[Callable] = None) -> ShardedFixpointResult:
    """The fixpoint with the halo exchange each step: O(halo) traffic a
    rank a step. Banded operands only (:func:`build_sharded_ell_halo`);
    ``sharded_band`` has the kernel's local compute with the overlap."""
    return _run_ell_fixpoint(mesh, op, x0, sr, halo=op.halo, n_rows=n_rows, combine=combine,
                             exact=exact, delta=delta, max_iter=max_iter, norm=norm,
                             aux0=aux0, aux_update=aux_update)


def _leaf_shapes(obj) -> tuple:
    """The shapes of an operand's tensors in the JAX package's pytree order
    (dataclass fields in order, dict keys sorted, lists in order)."""
    if isinstance(obj, torch.Tensor):
        return (tuple(obj.shape),)
    if dataclasses.is_dataclass(obj):
        return sum((_leaf_shapes(getattr(obj, f.name)) for f in dataclasses.fields(obj)), ())
    if isinstance(obj, dict):
        return sum((_leaf_shapes(obj[k]) for k in sorted(obj)), ())
    if isinstance(obj, (list, tuple)):
        return sum((_leaf_shapes(v) for v in obj), ())
    return ()


def _fingerprint(x0, op) -> str:
    """The problem's fingerprint: the length and a hash of x0 and the
    operand's shapes, as the JAX package writes it, so that a checkpoint of
    another matrix or root is refused."""
    x0 = x0.cpu().numpy() if isinstance(x0, torch.Tensor) else np.asarray(x0)
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(x0).tobytes())
    return f"{len(x0)}|{_leaf_shapes(op)}|{h.hexdigest()}"


def sharded_fixpoint_checkpointed(
    solver: Callable,
    mesh: Mesh,
    op,
    x0,
    sr: Semiring,
    *,
    n_rows: int,
    combine: Callable,
    ckpt_path: str,
    every: int = 100,
    exact: bool = True,
    delta: float = 0.0,
    max_iter: int = 10_000,
    keep_on_converged: bool = False,
    **solver_kw,
) -> ShardedFixpointResult:
    """A long sharded solve in chunks of ``every`` steps through ``solver``
    (:func:`sharded_fixpoint` or :func:`sharded_fixpoint_halo`), resumable.

    After each chunk rank 0 writes (x, total iterations, the problem's
    fingerprint) to ``ckpt_path`` (``.npz`` added when missing) by an
    atomic rename, and every rank waits for it; a run that finds the file
    resumes from it. A checkpoint whose fingerprint is not this problem's
    raises ValueError. Once the solve converges rank 0 removes it, unless
    ``keep_on_converged``."""
    if not ckpt_path.endswith(".npz"):
        ckpt_path += ".npz"
    x = x0.cpu().numpy() if isinstance(x0, torch.Tensor) else np.asarray(x0)
    fp = _fingerprint(x, op)
    total = 0
    if os.path.exists(ckpt_path):
        with np.load(ckpt_path, allow_pickle=False) as data:
            stored = str(data["fingerprint"]) if "fingerprint" in data else None
            if stored != fp:
                raise ValueError(
                    f"checkpoint {ckpt_path} belongs to a different problem "
                    f"(fingerprint {stored!r} != {fp!r}); remove it or use a "
                    "different ckpt_path")
            x = data["x"][: len(x)]
            total = int(data["iteration"])
    converged = False
    while total < max_iter and not converged:
        res = solver(mesh, op, x, sr, n_rows=n_rows, combine=combine, exact=exact,
                     delta=delta, max_iter=min(every, max_iter - total), **solver_kw)
        x = res.x.cpu().numpy()
        total += res.iterations
        converged = res.converged
        if mesh.rank == 0:
            tmp = ckpt_path[:-4] + ".tmp.npz"
            with open(tmp, "wb") as f:
                np.savez(f, x=x, iteration=total, fingerprint=fp)
            os.replace(tmp, ckpt_path)
        comm.barrier(mesh)
    if converged and not keep_on_converged:
        if mesh.rank == 0 and os.path.exists(ckpt_path):
            os.remove(ckpt_path)
        comm.barrier(mesh)
    return ShardedFixpointResult(x=torch.from_numpy(x).to(mesh.device), iterations=total,
                                 converged=converged)


# -------------------------------------------------------- algorithm wrappers


MODES = ("auto", "band", "sell", "halo", "gather")


def _build_sharded_auto(coo: COO, sr: Semiring, n_shards: int, mode: str = "auto", *,
                        device: DeviceLike = None):
    """(operand, solver): the best mode the structure permits.

    "auto" prefers the band operand (the band kernel, O(halo) exchange and
    the overlap), then sell2 (the sell2 kernel over an all-gathered
    x: the power-law and scattered path), then the halo ELL (O(halo)
    exchange, plain torch gather), then the all-gather ELL (any
    structure). "band", "sell" and "halo" require theirs (NotImplementedError,
    NotImplementedError and ValueError otherwise); "gather" takes the
    all-gather ELL. reorder="rcm" on the wrappers is what makes a general
    matrix band- or halo-eligible."""
    if mode not in MODES:
        raise ValueError(f"unknown sharded mode {mode!r}")
    if mode in ("auto", "band"):
        try:
            return build_sharded_band(coo, sr, n_shards, device=device)[0], sharded_fixpoint_band
        except NotImplementedError:
            if mode == "band":
                raise
    if mode in ("auto", "sell"):
        try:
            return build_sharded_sell(coo, sr, n_shards, device=device)[0], sharded_fixpoint_sell
        except NotImplementedError:
            if mode == "sell":
                raise
    if mode in ("auto", "halo"):
        try:
            return (build_sharded_ell_halo(coo, sr, n_shards, device=device)[0],
                    sharded_fixpoint_halo)
        except ValueError:
            if mode == "halo":
                raise
    return build_sharded_ell(coo, sr, n_shards, device=device)[0], sharded_fixpoint


def _sharded_reorder_pre(coo: COO, reorder, root=None):
    # shared with the single-device apps; imported here so that parallel/
    # does not load the apps at import
    from sparseharness_tpu_torch.algorithms.apps import _reorder_pre

    return _reorder_pre(coo, reorder, root)


def _sharded_unpermute(res, inv):
    if inv is None:
        return res
    idx = torch.as_tensor(inv, dtype=torch.int64, device=res.x.device)
    aux = None if res.aux is None else res.aux[idx]
    return dataclasses.replace(res, x=res.x[idx], aux=aux)


def _solve(mesh: Mesh, coo: COO, sr: Semiring, mode: str, x0, inv, return_solver: bool,
           build=_build_sharded_auto, **kw):
    op, solver = build(coo, sr, mesh.size, mode, device=mesh.device)

    def run():
        return _sharded_unpermute(solver(mesh, op, x0, sr, n_rows=coo.shape[0], **kw), inv)

    return run if return_solver else run()


def sharded_sssp(coo: COO, root: int, mesh: Optional[Mesh] = None,
                 max_iter: Optional[int] = None, mode: str = "auto",
                 reorder: Optional[str] = None, return_solver: bool = False,
                 *, device: DeviceLike = None):
    """SSSP over the mesh: .x the min-plus distances from ``root``. The
    default cap is n steps, as apps.sssp and gold.sssp_gold, so inputs that
    do not converge (negative cycles) still compare bit for bit."""
    mesh = mesh or make_mesh(device=device)
    coo, inv, root = _sharded_reorder_pre(coo, reorder, root)
    n = coo.shape[0]
    x0 = np.full(n, FLT_MAX, np.float32)
    x0[root] = 0.0
    return _solve(mesh, coo, MIN_PLUS, mode, x0, inv, return_solver, combine=combine_min,
                  exact=True, max_iter=max_iter if max_iter is not None else n)


def sharded_bfs(coo: COO, root: int, mesh: Optional[Mesh] = None,
                max_iter: Optional[int] = None, mode: str = "auto",
                reorder: Optional[str] = None, return_solver: bool = False,
                *, device: DeviceLike = None):
    """BFS over the mesh: .x reachability and .aux int32 levels (−1
    unreachable, 0 the root), as the single-device bfs gives them."""
    mesh = mesh or make_mesh(device=device)
    coo, inv, root = _sharded_reorder_pre(coo, reorder, root)
    n = coo.shape[0]
    x0 = np.zeros(n, bool)
    x0[root] = True
    levels0 = np.full(n, -1, np.int32)
    levels0[root] = 0
    return _solve(mesh, coo, OR_AND, mode, x0, inv, return_solver, combine=combine_or,
                  exact=True, max_iter=max_iter or n + 1, aux0=levels0,
                  aux_update=bfs_level_stamp)


def sharded_pagerank(coo: COO, damping: float = 0.85, mesh: Optional[Mesh] = None,
                     delta: float = 1e-6, max_iter: int = 1000, mode: str = "auto",
                     reorder: Optional[str] = None, return_solver: bool = False,
                     *, device: DeviceLike = None):
    """PageRank power iteration over the mesh."""
    mesh = mesh or make_mesh(device=device)
    coo, inv, _ = _sharded_reorder_pre(coo, reorder)
    n = coo.shape[0]
    x0 = np.full(n, 1.0 / n, np.float32)
    return _solve(mesh, pagerank_normalise(coo, damping), PLUS_TIMES, mode, x0, inv,
                  return_solver, combine=CombineAddConst(float((1.0 - damping) / n)),
                  exact=False, delta=delta, max_iter=max_iter)


def sharded_scc_forward(coo: COO, mesh: Optional[Mesh] = None,
                        max_iter: Optional[int] = None, mode: str = "auto",
                        return_solver: bool = False, *, device: DeviceLike = None):
    """Forward max-label propagation over the mesh (the reference's scc
    pass); :func:`sharded_scc` intersects it with the transpose's."""
    mesh = mesh or make_mesh(device=device)
    n = coo.shape[0]
    return _solve(mesh, scc_normalise(coo), MAX_RIGHT, mode, np.arange(n, dtype=np.int32),
                  None, return_solver, combine=combine_max, exact=True,
                  max_iter=max_iter or n + 1)


def sharded_scc(coo: COO, mesh: Optional[Mesh] = None, max_iter: Optional[int] = None,
                mode: str = "auto", *, device: DeviceLike = None):
    """Full SCC over the mesh: forward ∧ backward max-label propagation,
    each component named by its least vertex, as algorithms.apps.scc.
    Returns (labels, forward result, backward result)."""
    from sparseharness_tpu_torch.algorithms.apps import _relabel_components

    mesh = mesh or make_mesh(device=device)
    fwd = sharded_scc_forward(coo, mesh=mesh, max_iter=max_iter, mode=mode)
    bwd = sharded_scc_forward(coo.transpose(), mesh=mesh, max_iter=max_iter, mode=mode)
    f = fwd.x.cpu().numpy().astype(np.int64)
    b = bwd.x.cpu().numpy().astype(np.int64)
    return _relabel_components(f * coo.shape[0] + b), fwd, bwd


def sharded_eigenvector(coo: COO, mesh: Optional[Mesh] = None, delta: float = 1e-6,
                        max_iter: int = 1000, mode: str = "auto",
                        reorder: Optional[str] = None, return_solver: bool = False,
                        *, device: DeviceLike = None):
    """Dominant eigenvector by power iteration over the mesh, L2-normalised
    over every rank each step."""
    mesh = mesh or make_mesh(device=device)
    coo, inv, _ = _sharded_reorder_pre(coo, reorder)
    n = coo.shape[0]
    x0 = np.full(n, 1.0 / np.sqrt(n), np.float32)
    return _solve(mesh, coo, PLUS_TIMES, mode, x0, inv, return_solver,
                  combine=combine_keep_dp, exact=False, delta=delta, max_iter=max_iter,
                  norm=True)


# ------------------------------------------------------ batched multi-source


def _build_sharded_spmm(coo: COO, sr: Semiring, n_shards: int, mode: str, *,
                        device: DeviceLike = None):
    """Operand and solver of the batched (n, m) SpMM fixpoint: "auto"
    prefers the tile-SpMM local compute (spmm_tiles over an all-gathered
    X), then the halo ELL, then the all-gather ELL."""
    if mode in ("band", "sell"):
        raise NotImplementedError(
            f"mode={mode!r} is single-source only; multi-source fixpoints run "
            "the tile/ELL SpMM paths (mode auto/tiles/halo/gather)")
    if mode not in ("auto", "tiles", "halo", "gather"):
        raise ValueError(f"unknown sharded mode {mode!r}")
    if mode in ("auto", "tiles"):
        from sparseharness_tpu_torch.parallel.sharded_spmm import (
            build_sharded_spmm_tiles, sharded_fixpoint_spmm_tiles,
        )

        try:
            return (build_sharded_spmm_tiles(coo, sr, n_shards, device=device),
                    sharded_fixpoint_spmm_tiles)
        except NotImplementedError:
            if mode == "tiles":
                raise
    if mode in ("auto", "halo"):
        try:
            return (build_sharded_ell_halo(coo, sr, n_shards, device=device)[0],
                    sharded_fixpoint_halo)
        except ValueError:
            if mode == "halo":
                raise
    return build_sharded_ell(coo, sr, n_shards, device=device)[0], sharded_fixpoint


def sharded_multi_sssp(coo: COO, roots, mesh: Optional[Mesh] = None,
                       max_iter: Optional[int] = None, mode: str = "auto",
                       reorder: Optional[str] = None, return_solver: bool = False,
                       *, device: DeviceLike = None):
    """Batched SSSP over the mesh: .x[:, j] == sharded_sssp(coo, roots[j]).x,
    from one min-plus SpMM fixpoint over a row-sharded (n, m) block."""
    from sparseharness_tpu_torch.algorithms.apps import _as_roots

    mesh = mesh or make_mesh(device=device)
    r = _as_roots(coo, roots)
    coo, inv, r = _sharded_reorder_pre(coo, reorder, r)
    n, m = coo.shape[0], len(r)
    x0 = np.full((n, m), FLT_MAX, np.float32)
    x0[r, np.arange(m)] = 0.0
    return _solve(mesh, coo, MIN_PLUS, mode, x0, inv, return_solver,
                  build=_build_sharded_spmm, combine=combine_min, exact=True,
                  max_iter=max_iter if max_iter is not None else n)


def sharded_multi_bfs(coo: COO, roots, mesh: Optional[Mesh] = None,
                      max_iter: Optional[int] = None, mode: str = "auto",
                      reorder: Optional[str] = None, return_solver: bool = False,
                      *, device: DeviceLike = None):
    """Batched BFS over the mesh: .x[:, j] reachability and .aux[:, j]
    int32 levels from roots[j]."""
    from sparseharness_tpu_torch.algorithms.apps import _as_roots

    mesh = mesh or make_mesh(device=device)
    r = _as_roots(coo, roots)
    coo, inv, r = _sharded_reorder_pre(coo, reorder, r)
    n, m = coo.shape[0], len(r)
    x0 = np.zeros((n, m), bool)
    x0[r, np.arange(m)] = True
    levels0 = np.full((n, m), -1, np.int32)
    levels0[r, np.arange(m)] = 0
    return _solve(mesh, coo, OR_AND, mode, x0, inv, return_solver,
                  build=_build_sharded_spmm, combine=combine_or, exact=True,
                  max_iter=max_iter or n + 1, aux0=levels0, aux_update=bfs_level_stamp)
