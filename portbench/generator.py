"""The one traffic generator: it reads a traffic mix's data file
(``traffic/<name>.json``) and makes that mix's requests from the seed.

Two kinds of request stream, by the file's ``op``:

- ``spmv``: a closed loop of one caller issuing back-to-back SpMVs over a
  ring of ``ring`` vectors x, uniform in ``x_range``, made at set-up.
- ``solve``: a closed loop of one client solving one fixpoint after
  another, each from the next root of a sequence of ``roots_drawn`` roots:
  ``nonisolated`` draws them uniformly among the vertices that have an
  edge (Graph500's search keys), ``head`` uniformly in [0, ``head``).
"""

from __future__ import annotations

import torch

#: the traffic's generator seed is the run's seed plus this, so that it
#: draws apart from the graph's
SEED_OFFSET = 1


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed + SEED_OFFSET)
    return g


def spmv_vectors(traffic: dict, seed: int, n: int, device):
    """The ring of x vectors, float32 on ``device``."""
    lo, hi = (float(v) for v in traffic["x_range"])
    g = _generator(seed, device)
    ring = torch.rand((int(traffic["ring"]), n), generator=g, device=device)
    return list((ring * (hi - lo) + lo).unbind(0))


def roots(traffic: dict, seed: int, n: int, rows, cols, device) -> list:
    """The sequence of solve roots, as Python ints."""
    g = _generator(seed, device)
    k = int(traffic["roots_drawn"])
    rule = traffic["roots"]
    if rule == "nonisolated":
        degree = torch.bincount(rows, minlength=n) + torch.bincount(cols, minlength=n)
        keys = torch.nonzero(degree > 0).flatten()
        pick = torch.randint(keys.numel(), (k,), generator=g, device=device)
        return keys[pick].tolist()
    if rule == "head":
        head = min(int(traffic["head"]), n)
        return torch.randint(head, (k,), generator=g, device=device).tolist()
    raise ValueError(f"unknown root rule {rule!r}")
