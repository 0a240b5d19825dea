"""Leveled, coloured, seconds-since-start logger (counterpart of
aqp_tpu/utils/logging.py).

Each line reads `[seconds since start] LEVEL message`; the level is
coloured only when standard error is a terminal.
"""

from __future__ import annotations

import logging
import sys
import time

_START = time.perf_counter()
_COLORS = {"DEBUG": "\033[36m", "INFO": "\033[32m", "WARNING": "\033[33m",
           "ERROR": "\033[31m"}
_RESET = "\033[0m"


class _RelativeFormatter(logging.Formatter):
    def format(self, record):
        rel = time.perf_counter() - _START
        color = (_COLORS.get(record.levelname, "") if sys.stderr.isatty()
                 else "")
        reset = _RESET if color else ""
        return (f"{color}[{rel:10.6f}] {record.levelname:7s}{reset} "
                f"{record.getMessage()}")


def get_logger(name: str = "aqp_tpu_torch",
               level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(_RelativeFormatter())
        logger.addHandler(h)
        logger.setLevel(level)
        logger.propagate = False
    return logger
