from sparseharness_tpu_torch.gold.spmv import (  # noqa: F401
    spmv_abs_bound,
    spmv_gold,
    spmv_gold_reference_quirk,
)
from sparseharness_tpu_torch.gold.check import Correctness, check_result  # noqa: F401
from sparseharness_tpu_torch.gold.algorithms import (  # noqa: F401
    bfs_levels_gold,
    bfs_reach_gold,
    connected_components_gold,
    eigenvector_gold,
    pagerank_gold,
    scc_gold,
    scc_labels_gold,
    sssp_gold,
    widest_path_gold,
)
