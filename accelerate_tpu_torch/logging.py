"""Logging for the port (counterpart of ``accelerate_tpu/logging.py``'s
``get_logger``). The port is single-process so far, so there is no rank
filtering yet: this is a plain :mod:`logging` logger with the same
``ACCELERATE_LOG_LEVEL`` environment switch."""

from __future__ import annotations

import logging
import os
from typing import Optional

__all__ = ["get_logger"]


def get_logger(name: str, log_level: Optional[str] = None) -> logging.Logger:
    logger = logging.getLogger(name)
    if log_level is None:
        log_level = os.environ.get("ACCELERATE_LOG_LEVEL", None)
    if log_level is not None:
        logger.setLevel(log_level.upper())
    return logger
