"""Start a world of ranks on this host and collect what each returns.

:func:`run_world` spawns one process per rank (the ``spawn`` start
method: the caller may run threads, which ``fork`` would copy half-made),
joins them in a process group over a ``FileStore`` in a temporary
directory (no port to pick, so several worlds may start at once), builds
each rank's :class:`~parallel.mesh.Mesh` and calls ``fn(mesh, *args)``
there. ``fn`` and ``args`` are pickled, so ``fn`` is a module-level
function of a module that the child can import.

The first rank that raises, dies or outlives ``timeout_s`` ends the
world: every rank is killed and :func:`run_world` raises with that rank's
traceback. A rank stuck in a collective never holds up the caller longer
than the timeout.
"""

from __future__ import annotations

import dataclasses
import datetime
import inspect
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch

from sparseharness_tpu_torch.parallel import mesh as mesh_mod
from sparseharness_tpu_torch.utils.device import DeviceLike, resolve_device


class RankFailed(RuntimeError):
    """A rank of a world raised, died or timed out."""


def to_numpy(obj):
    """``obj`` with every tensor in it as a NumPy array: through
    dataclasses (kept as their type), NamedTuples, tuples, lists and dicts."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: to_numpy(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_numpy(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_numpy(v) for v in obj)
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    return obj


def _rank_main(fn, rank: int, world: int, backend: str, device: str,
               devices: Optional[List[int]], store_path: str, timeout_s: float,
               args: tuple, results) -> None:
    import torch.distributed as dist

    try:
        dev = torch.device(device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        store = dist.FileStore(store_path, world)
        bind = {}
        if dev.type == "cuda":
            mine = mesh_mod.rank_devices(world, devices, device=dev, backend=backend)[rank]
            torch.cuda.set_device(mine)
            if backend == "nccl" and "device_id" in inspect.signature(
                    dist.init_process_group).parameters:
                bind["device_id"] = mine  # NCCL binds the rank's card (torch ≥ 2.3)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s), **bind)
        try:
            mesh = mesh_mod.make_mesh(world, devices, device=dev)
            out = to_numpy(fn(mesh, *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # reported to the parent, which ends the world
        results.put((rank, False, traceback.format_exc()))


def run_world(fn: Callable, world_size: int, *, backend: Optional[str] = None,
              device: DeviceLike = None, devices: Optional[Sequence[int]] = None,
              args: tuple = (), timeout_s: float = 600.0) -> List[Any]:
    """``fn(mesh, *args)`` on each of ``world_size`` spawned ranks; returns
    each rank's result, tensors as NumPy arrays, in rank order.

    ``device`` is where the ranks' tensors live (default ``cuda``; without a
    card it raises unless ``"cpu"`` is asked for); ``backend`` defaults to
    the device's (:func:`mesh.default_backend`);
    ``devices`` are the card indices the ranks take. On cards, more NCCL
    ranks than cards raise before any rank starts."""
    dev = resolve_device(device)
    backend = backend or mesh_mod.default_backend(dev)
    mesh_mod.rank_devices(world_size, devices, device=dev, backend=backend)
    ctx = mp.get_context("spawn")
    devices = None if devices is None else [int(d) for d in devices]
    with tempfile.TemporaryDirectory(prefix="sh_world_") as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(fn, r, world_size, backend, str(dev), devices, os.path.join(tmp, "store"),
                  timeout_s, tuple(args), results)) for r in range(world_size)]
        for p in procs:
            p.start()
        out = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(out) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    missing = sorted(set(range(world_size)) - set(out))
                    raise RankFailed(f"ranks {missing} did not finish within {timeout_s} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 0.5))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode is not None]
                    if not dead:
                        continue
                    try:  # a rank that reported before it exited
                        rank, ok, payload = results.get(timeout=1.0)
                    except queue.Empty:
                        raise RankFailed(f"rank {dead[0]} exited with code "
                                         f"{procs[dead[0]].exitcode}") from None
                if not ok:
                    raise RankFailed(f"rank {rank} failed:\n{payload}")
                out[rank] = payload
        finally:
            for p in procs:
                if p.is_alive() and len(out) < world_size:
                    p.kill()
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5)
            results.close()
            results.join_thread()
    return [out[r] for r in range(world_size)]


@dataclasses.dataclass(frozen=True)
class Call:
    """One call of :func:`run_calls`: ``fn(mesh=mesh, **kwargs)``."""

    fn: Callable
    kwargs: dict = dataclasses.field(default_factory=dict)


def run_calls(mesh: mesh_mod.Mesh, calls: Sequence[Call]) -> list:
    """Each call's result in turn on this rank (a :func:`run_world` target
    that lets one world run many solves of the package's functions)."""
    return [c.fn(mesh=mesh, **c.kwargs) for c in calls]
