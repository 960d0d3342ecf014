from sparseharness_tpu_torch.algorithms.fixpoint import (  # noqa: F401
    FixpointResult,
    delta_converged,
    exact_converged,
    run_fixpoint,
    run_fixpoint_checkpointed,
    run_fixpoint_stepped,
)
from sparseharness_tpu_torch.algorithms.apps import (  # noqa: F401
    FixpointComponents,
    Problem,
    bfs,
    connected_components,
    eigenvector,
    fixpoint_components,
    make_spmv_problem,
    multi_bfs,
    multi_sssp,
    pagerank,
    scc,
    spmv_once,
    sssp,
    widest_path,
)
