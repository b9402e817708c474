"""Rotating-file + console logger (capability parity: reference utils/logger.py:26-85)."""
from __future__ import annotations

import logging
import logging.handlers
import os
from typing import Optional

_FMT = "%(asctime)s %(levelname)s [%(name)s] %(message)s"
_LOGGERS = {}


def get_logger(name: str = "recflow",
               level: int = logging.INFO,
               log_file: Optional[str] = None,
               max_bytes: int = 64 << 20,
               backup_count: int = 5) -> logging.Logger:
    key = (name, log_file)
    if key in _LOGGERS:
        return _LOGGERS[key]
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    if not logger.handlers:
        console = logging.StreamHandler()
        console.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(console)
        if log_file:
            os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
            fh = logging.handlers.RotatingFileHandler(
                log_file, maxBytes=max_bytes, backupCount=backup_count)
            fh.setFormatter(logging.Formatter(_FMT))
            logger.addHandler(fh)
    _LOGGERS[key] = logger
    return logger
