from sparseharness_tpu_torch.formats.sparse import (  # noqa: F401
    COO,
    CSR,
    ELL,
    coo_from_arrays,
    fold_duplicates,
    round_up,
)
from sparseharness_tpu_torch.formats.generate import (  # noqa: F401
    banded_coo,
    random_coo,
    random_graph_coo,
)
from sparseharness_tpu_torch.formats.mtx import (  # noqa: F401
    MtxFormatError,
    MtxHeader,
    read_mtx,
    read_mtx_header,
)
from sparseharness_tpu_torch.formats.preprocess import pagerank_normalise  # noqa: F401
