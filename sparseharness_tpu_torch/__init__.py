"""sparseharness_tpu_torch — the PyTorch/CUDA port of sparseharness_tpu.

The same semiring sparse linear algebra as the JAX package beside it, with
its module layout and names, for one NVIDIA GPU:

- sparse formats, seeded generators and MatrixMarket I/O (``formats``)
- semirings as torch ops (``semiring``)
- SpMV variants: plain-torch ``ell``, ``coo_seg``, ``dense`` and ``dia``,
  and hand-written CUDA kernels for ``bsr_band``, the blocked variants,
  ``sell2`` and ``sell``; semiring SpMM (``spmm``) with CUDA kernels for
  band and strip operands (``ops``, sources in ``ops/csrc``, built with
  nvcc at first use)
- RCM reordering (``formats.reorder``)
- NumPy golds and correctness checks (``gold``)
- the benchmark harness, timed with CUDA events (``harness``)
- the fixpoint loop (whole-solve, host-stepped and checkpointed), the sssp /
  bfs / pagerank / scc / eigenvector / connected_components / widest_path
  apps and the multi-source multi_sssp / multi_bfs (``algorithms``)
- the sweep and the JSONL / SQL result sinks (``harness``)
- the command-line entry points, ``python -m sparseharness_tpu_torch.cli
  <app>`` (``cli``)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise rather than fall back. It imports neither JAX
nor the JAX package.
"""

__version__ = "0.1.0"

from sparseharness_tpu_torch.semiring import (  # noqa: F401
    MAX_MIN,
    MAX_RIGHT,
    MAX_TIMES,
    MIN_PLUS,
    MIN_RIGHT,
    OR_AND,
    PLUS_TIMES,
    Semiring,
    get_semiring,
)
from sparseharness_tpu_torch.ops import (  # noqa: F401
    Geometry,
    build_operand,
    build_operand_auto,
    spmm,
    spmv,
)
from sparseharness_tpu_torch.formats import (  # noqa: F401
    COO,
    banded_coo,
    coo_from_arrays,
    random_coo,
    random_graph_coo,
    read_mtx,
)
from sparseharness_tpu_torch.algorithms import (  # noqa: F401
    bfs,
    connected_components,
    eigenvector,
    multi_bfs,
    multi_sssp,
    pagerank,
    scc,
    sssp,
    widest_path,
)
