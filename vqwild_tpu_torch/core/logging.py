"""Stdlib logging for the PyTorch port (a copy of vqwild_tpu.core.logging's
``get_logger``; the port imports nothing of the JAX package)."""

from __future__ import annotations

import logging
import sys
from typing import Optional

_LOGGER_NAME = "vqwild_tpu_torch"
_initialized = False


class _ColorFormatter(logging.Formatter):
    COLORS = {
        logging.DEBUG: "\033[37m",
        logging.INFO: "",
        logging.WARNING: "\033[33m",
        logging.ERROR: "\033[31m",
    }
    RESET = "\033[0m"

    def format(self, record):
        msg = super().format(record)
        color = self.COLORS.get(record.levelno, "")
        if color and sys.stderr.isatty():
            return f"{color}{msg}{self.RESET}"
        return msg


def get_logger(name: Optional[str] = None) -> logging.Logger:
    global _initialized
    logger = logging.getLogger(_LOGGER_NAME)
    if not _initialized:
        logger.setLevel(logging.INFO)
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            _ColorFormatter("[%(asctime)s %(levelname).1s] %(message)s", "%m%d %H:%M:%S")
        )
        logger.addHandler(handler)
        logger.propagate = False
        _initialized = True
    return logger.getChild(name) if name else logger
