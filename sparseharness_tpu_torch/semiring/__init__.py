from sparseharness_tpu_torch.semiring.core import (  # noqa: F401
    MAX_MIN,
    MAX_RIGHT,
    MAX_TIMES,
    MIN_PLUS,
    MIN_RIGHT,
    OR_AND,
    PLUS_TIMES,
    REGISTRY,
    Semiring,
    get_semiring,
    register_semiring,
)
