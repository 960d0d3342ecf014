from sparseharness_tpu_torch.harness.stats import (  # noqa: F401
    BenchRecord,
    Statistic,
    median_record,
)
from sparseharness_tpu_torch.harness.roofline import (  # noqa: F401
    device_hbm_bandwidth,
    roofline_seconds,
    variant_bytes,
)
from sparseharness_tpu_torch.harness.runner import (  # noqa: F401
    BenchmarkConfig,
    BenchmarkResult,
    benchmark_fixpoint,
    benchmark_spmv,
)
