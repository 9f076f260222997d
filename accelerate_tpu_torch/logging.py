"""Rank-aware logging (counterpart of ``accelerate_tpu/logging.py``).

:func:`get_logger` returns a :class:`MultiProcessAdapter`: a record is
emitted on the main process only unless ``main_process_only=False``;
``in_order=True`` emits process by process with a barrier between them;
with several processes each line is prefixed with the rank; with one,
every record is emitted once, unprefixed. The adapter reads the process layout without building ``PartialState``, so
logging never picks a device. ``ACCELERATE_LOG_LEVEL`` sets the level and
``ACCELERATE_LOG_ON_ALL_PROCESSES=1`` turns ``main_process_only`` off.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

from .state import process_layout

__all__ = ["MultiProcessAdapter", "get_logger"]


class MultiProcessAdapter(logging.LoggerAdapter):
    """``log(..., main_process_only=True, in_order=False)``."""

    def log(self, level, msg, *args, **kwargs):
        if os.environ.get("ACCELERATE_LOG_ON_ALL_PROCESSES") == "1":
            kwargs.setdefault("main_process_only", False)
        main_process_only = kwargs.pop("main_process_only", True)
        in_order = kwargs.pop("in_order", False)
        if not self.isEnabledFor(level):
            return
        index, count = process_layout()
        if in_order:
            from .state import PartialState

            for i in range(count):
                if i == index:
                    msg_i, kw = self.process(msg, kwargs)
                    self.logger.log(level, msg_i, *args, **kw)
                if count > 1:
                    PartialState().wait_for_everyone("accelerate_tpu_torch.logging.in_order")
        elif not main_process_only or index == 0:
            msg, kwargs = self.process(msg, kwargs)
            self.logger.log(level, msg, *args, **kwargs)

    def process(self, msg, kwargs):
        index, count = process_layout()
        return (f"[rank {index}] {msg}" if count > 1 else msg), kwargs


def get_logger(name: str, log_level: Optional[str] = None) -> MultiProcessAdapter:
    logger = logging.getLogger(name)
    if log_level is None:
        log_level = os.environ.get("ACCELERATE_LOG_LEVEL", None)
    if log_level is not None:
        logger.setLevel(log_level.upper())
        logger.root.setLevel(log_level.upper())
    return MultiProcessAdapter(logger, {})
