"""Logging setup mirroring the reference's FFSLogger behaviour.

Equivalent of the reference's spdlog singleton (reference:
include/ffs_logger.hpp:20-123) and the Python service's rich/plain switch
(src/ffs/service.py:156-181): a terminal (TTY) gets colourised output, a
container plain single-line records for Graylog, and a rotating file
sink (`ffs_log.txt`) is attached when writable.  `LOG_LEVEL` env controls
the threshold.

The port's copy of :mod:`ffs_tpu.utils.logging` (it uses no framework); the
default logger is ``ffs_tpu_torch``.
"""

from __future__ import annotations

import logging
import logging.handlers
import os
import sys

_LEVELS = {
    "trace": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


def setup_logging(
    name: str = "ffs_tpu_torch",
    log_file: str | None = "ffs_log.txt",
    level: str | None = None,
) -> logging.Logger:
    level_name = (level or os.getenv("LOG_LEVEL") or "info").lower()
    lvl = _LEVELS.get(level_name, logging.INFO)

    logger = logging.getLogger(name)
    logger.setLevel(lvl)
    if logger.handlers:
        return logger

    is_tty = sys.stdout.isatty()
    handler: logging.Handler
    if is_tty:
        try:
            from rich.logging import RichHandler

            handler = RichHandler(level=lvl, log_time_format="[%Y-%m-%d %H:%M:%S]")
        except ImportError:
            handler = logging.StreamHandler(sys.stdout)
            handler.setFormatter(
                logging.Formatter("[%(asctime)s] %(levelname)s %(message)s")
            )
    else:
        # container mode: bare messages for the log collector
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("%(message)s"))
    handler.setLevel(lvl)
    logger.addHandler(handler)

    if log_file:
        try:
            fh = logging.handlers.RotatingFileHandler(
                log_file, maxBytes=10 * 1024 * 1024, backupCount=3
            )
            fh.setFormatter(
                logging.Formatter("[%(asctime)s] %(levelname)s %(message)s")
            )
            fh.setLevel(lvl)
            logger.addHandler(fh)
        except OSError:
            pass
    return logger
