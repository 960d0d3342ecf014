from sparseharness_tpu_torch.algorithms.fixpoint import (  # noqa: F401
    FixpointResult,
    delta_converged,
    exact_converged,
    run_fixpoint,
)
from sparseharness_tpu_torch.algorithms.apps import (  # noqa: F401
    Problem,
    bfs,
    connected_components,
    make_spmv_problem,
    multi_bfs,
    multi_sssp,
    pagerank,
    spmv_once,
    sssp,
    widest_path,
)
