"""The collectives of the sharded solvers, each on a mesh's process group.

These are the only collectives the JAX package's ``parallel/`` uses:

- :func:`all_gather`: ``lax.all_gather(x, tiled=True)``, the rank blocks
  concatenated along dim 0;
- :func:`start_ring_exchange`: the two ring ``ppermute``s of the halo
  edges (right edge to rank + 1, left edge to rank − 1), issued without
  waiting, so that the caller can compute while they travel;
- :func:`all_reduce`: ``psum``, with ``min`` and ``max`` beside ``sum``;
- :func:`all_to_all`: the fixed-shape ``lax.all_to_all(split_axis=0,
  concat_axis=0, tiled=True)``;
- :func:`barrier`.

At world size 1 a ring's partner is the rank itself, where torch's
point-to-point calls refuse a send; the ring is then the identity
permutation, which is what ``ppermute`` computes there.

Where the backend cannot take the rank's tensors (gloo with ranks on a
card, :attr:`Mesh.host_copy`) every exchanged buffer goes to the host and
back. Bool tensors travel as uint8.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch
import torch.distributed as dist

from sparseharness_tpu_torch.parallel.mesh import Mesh

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}
#: tags of the two ring directions (gloo matches point-to-point by tag)
_TO_RIGHT, _TO_LEFT = 1, 2


def _out(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the backend takes it: contiguous, bool as uint8, on the
    host where the mesh copies through it."""
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if mesh.host_copy:
        t = t.cpu()
    return t.contiguous()


def _back(mesh: Mesh, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if mesh.host_copy:
        t = t.to(mesh.device)
    return t.to(dtype) if t.dtype != dtype else t


def all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0, in rank order."""
    xs = _out(mesh, x)
    parts = [torch.empty_like(xs) for _ in range(mesh.size)]
    dist.all_gather(parts, xs, group=mesh.group)
    return _back(mesh, torch.cat(parts), x.dtype)


def all_reduce(mesh: Mesh, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over the ranks with ``op`` (sum, min or max), as a new
    tensor on the rank's device."""
    ts = _out(mesh, t)
    if ts is t:
        ts = t.clone()
    dist.all_reduce(ts, op=_OPS[op], group=mesh.group)
    return _back(mesh, ts, t.dtype)


def all_to_all(mesh: Mesh, send: torch.Tensor) -> torch.Tensor:
    """``send`` (size, ...): block d goes to rank d; returns (size, ...) with
    block s from rank s."""
    ss = _out(mesh, send)
    recv = torch.empty_like(ss)
    dist.all_to_all_single(recv, ss, group=mesh.group)
    return _back(mesh, recv, send.dtype)


def start_ring_exchange(mesh: Mesh, right_edge: torch.Tensor, left_edge: torch.Tensor
                        ) -> Callable[[], Tuple[torch.Tensor, torch.Tensor]]:
    """Issue the two ring exchanges and return their wait: it gives
    (from_left, from_right), the left neighbour's right edge and the right
    neighbour's left edge (ranks wrap around). Over NCCL the wait only
    orders the current stream after the transfers; over gloo it blocks."""
    if mesh.size == 1:
        return lambda: (right_edge, left_edge)
    right, left = (mesh.rank + 1) % mesh.size, (mesh.rank - 1) % mesh.size
    r_out, l_out = _out(mesh, right_edge), _out(mesh, left_edge)
    from_left, from_right = torch.empty_like(r_out), torch.empty_like(l_out)
    ops = [dist.P2POp(dist.isend, r_out, right, group=mesh.group, tag=_TO_RIGHT),
           dist.P2POp(dist.isend, l_out, left, group=mesh.group, tag=_TO_LEFT),
           dist.P2POp(dist.irecv, from_left, left, group=mesh.group, tag=_TO_RIGHT),
           dist.P2POp(dist.irecv, from_right, right, group=mesh.group, tag=_TO_LEFT)]
    works: List = dist.batch_isend_irecv(ops)

    def wait():
        for w in works:
            w.wait()
        return (_back(mesh, from_left, right_edge.dtype),
                _back(mesh, from_right, left_edge.dtype))

    return wait


def barrier(mesh: Mesh) -> None:
    dist.barrier(group=mesh.group)
