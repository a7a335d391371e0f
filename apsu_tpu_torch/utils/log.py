"""Logging facade (port of ``apsu_tpu/utils/log.py``): levels
all/debug/info/warning/error/off with console and file sinks, the C++
reference's Log over log4cplus."""

from __future__ import annotations

import logging
import sys

_LOGGER = logging.getLogger("apsu_tpu_torch")
_LEVELS = {
    "all": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "off": logging.CRITICAL + 10,
}


def configure(level: str = "info", log_file: str | None = None, silent: bool = False):
    _LOGGER.handlers.clear()
    _LOGGER.setLevel(_LEVELS.get(level, logging.INFO))
    fmt = logging.Formatter("%(asctime)s %(levelname)s [%(name)s] %(message)s")
    if not silent:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(fmt)
        _LOGGER.addHandler(h)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        _LOGGER.addHandler(fh)
    return _LOGGER


def get() -> logging.Logger:
    if not _LOGGER.handlers:
        configure()
    return _LOGGER
