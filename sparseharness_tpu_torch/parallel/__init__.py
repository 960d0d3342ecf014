"""The row-sharded solvers on ``torch.distributed``: the JAX package's
``parallel/`` with one process a rank in place of ``shard_map``.

A world of ranks is started with :func:`run_world` (or by the caller's own
launcher and :func:`init_distributed`); on each rank :func:`make_mesh`
gives its :class:`Mesh`, which every function here takes.
"""

from sparseharness_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    device_count,
    init_distributed,
)
from sparseharness_tpu_torch.parallel.launch import (  # noqa: F401
    Call,
    RankFailed,
    run_calls,
    run_world,
)
from sparseharness_tpu_torch.parallel.sharded import (  # noqa: F401
    ShardedEll,
    HaloEll,
    build_sharded_ell_halo,
    sharded_spmv_halo,
    sharded_fixpoint_halo,
    sharded_fixpoint_checkpointed,
    build_sharded_ell,
    sharded_spmv,
    sharded_fixpoint,
    sharded_pagerank,
    sharded_sssp,
    sharded_bfs,
    sharded_eigenvector,
    sharded_scc,
    sharded_scc_forward,
    sharded_multi_sssp,
    sharded_multi_bfs,
)
from sparseharness_tpu_torch.parallel.sharded_band import (  # noqa: F401
    ShardedBandOperand,
    build_sharded_band,
    sharded_spmv_band,
    sharded_fixpoint_band,
)
from sparseharness_tpu_torch.parallel.frontier import (  # noqa: F401
    FrontierResult,
    build_needed_cols,
    sharded_fixpoint_frontier,
    frontier_bfs,
    frontier_sssp,
)
from sparseharness_tpu_torch.parallel.auto import (  # noqa: F401
    shard_operand_rows,
    auto_sharded_spmv,
)
