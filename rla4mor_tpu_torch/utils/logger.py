"""Logging with per-object levels.

Counterpart of ``rla4mor_tpu/utils/logger.py``: plain :mod:`logging` under
the ``rla4mor_tpu_torch`` root logger.
"""

from __future__ import annotations

import logging

_FORMAT = "%(asctime)s %(name)s %(levelname)s: %(message)s"
_ROOT = "rla4mor_tpu_torch"


def _root() -> logging.Logger:
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root.addHandler(handler)
        root.setLevel(logging.WARNING)
        root.propagate = False
    return root


def get_logger(name: str, level: int | None = None) -> logging.Logger:
    _root()
    logger = logging.getLogger(f"{_ROOT}.{name}")
    if level is not None:
        logger.setLevel(level)
    return logger
