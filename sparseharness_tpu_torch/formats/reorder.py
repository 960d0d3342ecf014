"""Bandwidth-reducing row/column reordering (reverse Cuthill-McKee).

RCM permutes a general sparse matrix so that its nonzeros cluster near the
diagonal, which routes it onto the streaming ``bsr_band`` kernel. Graph
solves run entirely in permuted space (a symmetric permutation P·A·Pᵀ
keeps the path structure) and un-permute once at the end, so the cost per
step is untouched.

It runs on the host, as preprocessing, never on the device clock: by
default in the native library (formats/native_io.py: the symmetrized
pattern and the traversal in C++), otherwise (``use_native=False`` or
``SPARSEHARNESS_TPU_NATIVE=0``) in NumPy, vectorised level by level
(George & Liu's CM with a per-level (parent rank, degree) order). The two
give the same permutation bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from sparseharness_tpu_torch.formats import native_io
from sparseharness_tpu_torch.formats.sparse import COO


def bandwidth(coo: COO) -> int:
    """max |i − j| over stored entries (0 for an empty matrix)."""
    if coo.nnz == 0:
        return 0
    return int(np.max(np.abs(coo.rows.astype(np.int64) - coo.cols)))


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)
    return inv


def permute_coo(coo: COO, perm: np.ndarray) -> COO:
    """Symmetric permutation A' = A[perm][:, perm] (A'[i,j] = A[p(i),p(j)]).

    ``perm`` maps new index → old index, so a solve on A' with
    x'[j] = x[perm[j]] yields y'[i] = y[perm[i]].
    """
    n, c = coo.shape
    if n != c:
        raise ValueError("symmetric permutation requires a square matrix")
    inv = inverse_permutation(np.asarray(perm))
    return COO(
        rows=inv[coo.rows].astype(np.int32),
        cols=inv[coo.cols].astype(np.int32),
        vals=coo.vals,
        shape=coo.shape,
    )


def _sym_pattern_csr(coo: COO) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(indptr, indices, degree) of the symmetrized, de-duplicated,
    diagonal-free adjacency pattern."""
    n = coo.shape[0]
    r = np.concatenate([coo.rows, coo.cols]).astype(np.int64)
    c = np.concatenate([coo.cols, coo.rows]).astype(np.int64)
    off = r != c
    key = np.unique(r[off] * n + c[off])
    r, c = key // n, key % n
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(r, minlength=n))
    deg = np.diff(indptr)
    return indptr, c.astype(np.int64), deg


def _neighbors_of(frontier, indptr, indices):
    """Concatenated neighbor lists + the rank of each neighbor's parent
    within the frontier — a vectorised CSR multi-row gather."""
    starts = indptr[frontier]
    counts = indptr[frontier + 1] - starts
    total = int(counts.sum())
    if total == 0:
        e = np.empty(0, np.int64)
        return e, e
    cum0 = np.cumsum(counts) - counts  # exclusive prefix
    idx = np.arange(total) + np.repeat(starts - cum0, counts)
    parent_rank = np.repeat(np.arange(len(frontier)), counts)
    return indices[idx], parent_rank


def _bfs_levels(seed, indptr, indices, visited):
    """(levels_list, eccentricity) of the component of ``seed``, not
    crossing already-visited nodes. Marks nothing."""
    seen = visited.copy()
    seen[seed] = True
    frontier = np.asarray([seed], np.int64)
    levels = [frontier]
    while True:
        nbr, _ = _neighbors_of(frontier, indptr, indices)
        nbr = np.unique(nbr[~seen[nbr]])
        if nbr.size == 0:
            return levels, len(levels) - 1
        seen[nbr] = True
        levels.append(nbr)
        frontier = nbr


def _pseudo_peripheral(seed, indptr, indices, deg, visited) -> int:
    """George-Liu: re-seed at a min-degree node of the deepest BFS level
    until the eccentricity stops growing (≤ 4 sweeps)."""
    _, ecc = _bfs_levels(seed, indptr, indices, visited)
    for _ in range(4):
        levels, ecc2 = _bfs_levels(seed, indptr, indices, visited)
        last = levels[-1]
        cand = int(last[np.argmin(deg[last])])
        if ecc2 <= ecc and cand != seed:
            if ecc2 < ecc:
                break
        levels_c, ecc_c = _bfs_levels(cand, indptr, indices, visited)
        if ecc_c <= ecc2:
            break
        seed, ecc = cand, ecc_c
    return int(seed)


def rcm_permutation(coo: COO, use_native: bool = True) -> np.ndarray:
    """Reverse Cuthill-McKee ordering; returns ``perm`` (new → old) for
    :func:`permute_coo`. Components are processed smallest-degree-seed
    first; within a BFS level, nodes order by (parent rank, degree, id).
    Native unless ``use_native`` is False or SPARSEHARNESS_TPU_NATIVE=0."""
    n = coo.shape[0]
    if coo.shape[0] != coo.shape[1]:
        raise ValueError("rcm requires a square matrix")
    if n == 0:
        return np.empty(0, np.int32)
    if use_native and native_io.enabled():
        return native_io.rcm_from_coo(n, coo.rows, coo.cols)
    indptr, indices, deg = _sym_pattern_csr(coo)
    visited = np.zeros(n, bool)
    order = np.empty(n, np.int64)
    pos = 0
    for s in np.argsort(deg, kind="stable"):
        if visited[s]:
            continue
        if deg[s] > 0:
            s = _pseudo_peripheral(int(s), indptr, indices, deg, visited)
        visited[s] = True
        order[pos] = s
        pos += 1
        frontier = np.asarray([s], np.int64)
        while frontier.size:
            nbr, prank = _neighbors_of(frontier, indptr, indices)
            live = ~visited[nbr]
            nbr, prank = nbr[live], prank[live]
            if nbr.size == 0:
                break
            # min parent rank per distinct neighbor
            o = np.lexsort((prank, nbr))
            nbr, prank = nbr[o], prank[o]
            first = np.ones(len(nbr), bool)
            first[1:] = nbr[1:] != nbr[:-1]
            un, upr = nbr[first], prank[first]
            nxt = un[np.lexsort((un, deg[un], upr))]
            visited[nxt] = True
            order[pos:pos + len(nxt)] = nxt
            pos += len(nxt)
            frontier = nxt
    assert pos == n
    return order[::-1].astype(np.int32).copy()


def reorder_rcm(coo: COO) -> Tuple[COO, np.ndarray]:
    """(P·A·Pᵀ, perm) — one-call RCM reordering."""
    perm = rcm_permutation(coo)
    return permute_coo(coo, perm), perm
