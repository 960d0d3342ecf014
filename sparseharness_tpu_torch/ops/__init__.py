from sparseharness_tpu_torch.ops.registry import (  # noqa: F401
    AUTO_CHAIN,
    VARIANTS,
    Geometry,
    KernelVariant,
    build_operand,
    build_operand_auto,
    get_variant,
    register_variant,
    spmv,
)
from sparseharness_tpu_torch.ops.torch_ops import (  # noqa: F401
    CooOperand,
    DenseOperand,
    EllOperand,
    build_coo_seg,
    build_dense,
    build_ell,
    dp_coo_seg,
    dp_dense,
    dp_ell,
    fold_dp,
)
from sparseharness_tpu_torch.ops._build import LAUNCHES  # noqa: F401
from sparseharness_tpu_torch.ops.bsr import (  # noqa: F401
    BsrOperand,
    build_bsr,
    dp_bsr,
    dp_bsr_plain,
)
from sparseharness_tpu_torch.ops.bsr_ell import (  # noqa: F401
    BsrEllOperand,
    build_bsr_ell,
    dp_bsr_ell,
    dp_bsr_ell_plain,
)
from sparseharness_tpu_torch.ops.bsr_fused import (  # noqa: F401
    BsrFusedOperand,
    build_bsr_fused,
    dp_bsr_fused,
    dp_bsr_fused_plain,
)
from sparseharness_tpu_torch.ops.dia import DiaOperand, build_dia, dp_dia  # noqa: F401
from sparseharness_tpu_torch.ops.bsr_band import (  # noqa: F401
    BsrBandOperand,
    build_bsr_band,
    dp_bsr_band,
    dp_bsr_band_plain,
)
from sparseharness_tpu_torch.ops.sell import (  # noqa: F401
    SellOperand,
    build_sell,
    dp_sell,
    dp_sell_plain,
)
from sparseharness_tpu_torch.ops.sell2 import (  # noqa: F401
    Sell2Operand,
    build_sell2,
    dp_sell2,
    dp_sell2_plain,
)
from sparseharness_tpu_torch.ops.bsr_band import spmm_band, spmm_band_plain  # noqa: F401
from sparseharness_tpu_torch.ops.spmm_tiles import (  # noqa: F401
    ell_operand_from_band,
    ell_operand_from_fused,
    spmm_bsr_ell,
    spmm_bsr_ell_plain,
)
from sparseharness_tpu_torch.ops.spmm import spmm  # noqa: F401
from sparseharness_tpu_torch.ops.verify import (  # noqa: F401
    OperandInitError,
    verify_operand_initialized,
)
