from sparseharness_tpu_torch.harness.stats import (  # noqa: F401
    BenchRecord,
    Statistic,
    median_record,
    to_jsonl,
    to_sql,
    write_records,
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
    benchmark_fixpoint_stepped,
    benchmark_spmv,
)
from sparseharness_tpu_torch.harness.sweep import (  # noqa: F401
    SweepPoint,
    best_per_matrix,
    default_sweep,
    load_runfile,
    run_sweep,
)
