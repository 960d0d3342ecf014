from sparseharness_tpu_torch.utils.device import device_name, resolve_device  # noqa: F401
from sparseharness_tpu_torch.utils.logging import get_logger, set_log_level  # noqa: F401
from sparseharness_tpu_torch.utils.timing import (  # noqa: F401
    ScopedTimer,
    report_timing,
    set_trace_stream,
    timed,
)
