"""Severity-leveled logging with file:line headers.

Per-module loggers under ``sparseharness_tpu_torch``, a severity gate read
from ``SPARSEHARNESS_TPU_LOG`` and ``file:line`` in the header.
"""

from __future__ import annotations

import logging
import os
import sys

_ROOT = "sparseharness_tpu_torch"
_FORMAT = "[%(levelname)s] %(name)s %(filename)s:%(lineno)d: %(message)s"
_configured = False


def _configure() -> None:
    global _configured
    if _configured:
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    root = logging.getLogger(_ROOT)
    root.addHandler(handler)
    root.propagate = False
    level = os.environ.get("SPARSEHARNESS_TPU_LOG", "WARNING").upper()
    root.setLevel(getattr(logging, level, logging.WARNING))
    _configured = True


def get_logger(name: str) -> logging.Logger:
    _configure()
    if not name.startswith(_ROOT):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)


def set_log_level(level: str) -> None:
    _configure()
    logging.getLogger(_ROOT).setLevel(getattr(logging, level.upper()))
