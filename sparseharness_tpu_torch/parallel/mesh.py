"""The row mesh of the sharded solvers, on ``torch.distributed``.

The JAX package builds a 1-D ``Mesh`` over the ``"rows"`` axis and lets
``shard_map`` run one program on every device. Here every rank is a
process of its own (started by :func:`parallel.launch.run_world`, or by
the caller's own launcher), and :class:`Mesh` is one rank's view of the
world: its rank, the world's size, its device and the backend that moves
its tensors. Rows are block-partitioned over the ranks in rank order, as
the JAX mesh partitions them over its devices.

A rank on a card talks over NCCL, which needs a card of its own for every
rank; ranks on the CPU talk over gloo. Gloo may also carry ranks that
share one card, and then exchanges go through the host
(:attr:`Mesh.host_copy`).
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from sparseharness_tpu_torch.utils.device import DeviceLike, resolve_device

ROWS_AXIS = "rows"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of the 1-D row mesh.

    ``rank`` owns row block ``rank`` of every sharded operand; ``size`` is
    the number of ranks (the JAX mesh's device count); ``device`` holds the
    rank's tensors; ``backend`` is the process group's (``nccl`` or
    ``gloo``); ``group`` is the process group (None: the default one)."""

    rank: int
    size: int
    device: torch.device
    backend: str
    group: Optional[object] = None

    @property
    def host_copy(self) -> bool:
        """True where the backend cannot take the rank's tensors: gloo with
        ranks on a card. The communication layer then copies each
        exchanged buffer to the host and back (the rule is the backend's,
        never a retry after a failure)."""
        return self.backend == "gloo" and self.device.type == "cuda"


def device_count() -> int:
    """The cards this process can see."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def default_backend(device: torch.device) -> str:
    """``nccl`` for ranks on cards, ``gloo`` on the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device: DeviceLike = None,
    timeout_s: float = 600.0,
) -> None:
    """Join this process to the world: ``init_process_group`` at
    ``coordinator_address`` (``host:port`` or any init-method URL such as
    ``tcp://localhost:29500`` or ``file:///path``) as rank ``process_id``
    of ``num_processes``. The backend is ``backend`` or the device's
    (:func:`default_backend`). A no-op for a single process with no
    address, as in JAX."""
    if num_processes in (None, 1) and coordinator_address is None:
        return
    if coordinator_address is not None and "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    device = resolve_device(device)
    dist.init_process_group(
        backend or default_backend(device), init_method=coordinator_address,
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))


def rank_devices(n: int, devices: Optional[Sequence[int]] = None, *,
                 device: DeviceLike = None,
                 backend: Optional[str] = None) -> List[torch.device]:
    """The device of each of ``n`` ranks.

    On cards the ranks take ``devices`` (card indices; default every card)
    in order, one card each, and asking for more ranks than cards raises
    as JAX's ``make_mesh`` does. Over gloo, ranks may share cards: rank r
    takes ``devices[r % len(devices)]``. On the CPU every rank takes the
    CPU."""
    device = resolve_device(device)
    if device.type != "cuda":
        return [device] * n
    cards = list(range(device_count())) if devices is None else [int(d) for d in devices]
    bad = [d for d in cards if not 0 <= d < device_count()]
    if bad:
        raise ValueError(f"devices {bad} out of range (have {device_count()} devices)")
    backend = backend or default_backend(device)
    if n > len(cards) and backend == "nccl":
        raise ValueError(f"requested {n} devices, have {len(cards)}")
    if not cards:
        raise ValueError(f"requested {n} devices, have 0")
    return [torch.device("cuda", cards[r % len(cards)]) for r in range(n)]


def make_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence[int]] = None,
    *,
    device: DeviceLike = None,
) -> Mesh:
    """This rank's view of the row mesh over the current world.

    ``n_devices`` (default: the world's size) must equal the world's size;
    ``devices`` are the card indices the ranks take, in rank order (see
    :func:`rank_devices`). With no process group set up, the world is this
    process alone, a group of one rank over a store in memory."""
    device = resolve_device(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            rank_devices(n_devices, devices, device=device)  # refuses as JAX does
            raise ValueError(
                f"a mesh of {n_devices} ranks needs a world of {n_devices} processes: "
                "start them with parallel.launch.run_world")
        backend = default_backend(device)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"requested {n_devices} devices, the world has {size} ranks")
    backend = dist.get_backend()
    mine = rank_devices(size, devices, device=device, backend=backend)[rank]
    if mine.type == "cuda":
        torch.cuda.set_device(mine)
    return Mesh(rank=rank, size=size, device=mine, backend=backend)
