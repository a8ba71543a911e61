"""Structured logging + run-directory artifact contract.

A copy of vqwild_tpu.core.logging (the port imports nothing of the JAX
package): stdlib logging in place of the reference's tensorpack-style logger
(misc_utils/pytorchgo_logger.py), and an explicit RunDir object. The run dir
is the single artifact root for a run: checkpoints, feature caches, metrics
JSON, log file — the contract the reference's ``logger.get_logger_dir()``
provided (pytorchgo_logger.py:188-194; checkpoints at main.py:596-604).
"""

from __future__ import annotations

import datetime
import json
import logging
import os
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


class RunDir:
    """Artifact directory for one run.

    Layout:
      {root}/{run_name}/
        log.log               console mirror
        config.json           frozen ExperimentConfig
        checkpoints/          train/checkpoint.py checkpoints (best + last)
        cache/                eval feature caches
        metrics/              per-eval metric JSON dumps
    """

    def __init__(self, path: str, backup_existing: bool = True, write: bool = True):
        """``write=False`` (a rank other than 0 of a data-parallel run):
        the same paths, but nothing is created or written."""
        self.path = path
        self.write = write
        self._file_handler = None
        if not write:
            return
        os.makedirs(path, exist_ok=True)
        for sub in ("checkpoints", "cache", "metrics"):
            os.makedirs(os.path.join(path, sub), exist_ok=True)
        log_path = os.path.join(path, "log.log")
        if backup_existing and os.path.isfile(log_path):
            # timestamp-backup instead of clobbering (pytorchgo_logger.py:82-95)
            stamp = datetime.datetime.now().strftime("%m%d-%H%M%S")
            os.rename(log_path, log_path + "." + stamp)
        handler = logging.FileHandler(log_path)
        handler.setFormatter(
            logging.Formatter("[%(asctime)s %(levelname).1s] %(message)s", "%m%d %H:%M:%S")
        )
        logging.getLogger(_LOGGER_NAME).addHandler(handler)
        self._file_handler = handler

    @classmethod
    def create(cls, cfg, root: str = "train_log", write: bool = True) -> "RunDir":
        path = cfg.run_dir or os.path.join(root, cfg.run_name())
        rd = cls(path, write=write)
        if write:
            with open(os.path.join(path, "config.json"), "w") as f:
                f.write(cfg.to_json())
        return rd

    def checkpoint_dir(self) -> str:
        return os.path.join(self.path, "checkpoints")

    def cache_path(self, name: str) -> str:
        return os.path.join(self.path, "cache", name)

    def write_metrics(self, name: str, metrics: dict) -> str:
        out = os.path.join(self.path, "metrics", name + ".json")
        if not self.write:
            return out

        def _default(o):
            tolist = getattr(o, "tolist", None)  # ndarray / np scalar / tensor
            return tolist() if tolist is not None else float(o)

        with open(out, "w") as f:
            json.dump(metrics, f, indent=2, default=_default)
        return out

    def close(self):
        if self._file_handler is None:
            return
        logging.getLogger(_LOGGER_NAME).removeHandler(self._file_handler)
        self._file_handler.close()
