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
    EllOperand,
    build_ell,
    dp_ell,
    fold_dp,
)
from sparseharness_tpu_torch.ops.bsr_band import (  # noqa: F401
    LAUNCHES,
    BsrBandOperand,
    build_bsr_band,
    dp_bsr_band,
    dp_bsr_band_plain,
)
