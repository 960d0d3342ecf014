from sparseharness_tpu_torch.formats.sparse import (  # noqa: F401
    BSR,
    COO,
    CSR,
    ELL,
    bsr_from_coo,
    coo_from_arrays,
    fold_duplicates,
    round_up,
)
from sparseharness_tpu_torch.formats.generate import (  # noqa: F401
    banded_coo,
    block_random_coo,
    chained_power_law_coo,
    power_law_coo,
    random_coo,
    random_graph_coo,
)
from sparseharness_tpu_torch.formats.mtx import (  # noqa: F401
    MtxFormatError,
    MtxHeader,
    read_mtx,
    read_mtx_header,
    write_mtx,
)
from sparseharness_tpu_torch.formats.preprocess import (  # noqa: F401
    ensure_self_loops,
    pagerank_normalise,
    scc_normalise,
)
from sparseharness_tpu_torch.formats.reorder import (  # noqa: F401
    bandwidth,
    inverse_permutation,
    permute_coo,
    rcm_permutation,
    reorder_rcm,
)
