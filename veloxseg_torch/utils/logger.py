"""File and stdout logger: the port's own copy of
``veloxseg_tpu/utils/logger.py:1-28`` (reference
``utils/get_logger.py``), for one process."""

from __future__ import annotations

import logging
import os


def get_logger(log_path: str) -> logging.Logger:
    """The ``veloxseg`` logger, writing ``%(asctime)s %(message)s`` lines to
    ``log_path`` and stderr; earlier handlers are closed and replaced."""
    logger = logging.getLogger("veloxseg")
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s %(message)s")
    os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
    fh = logging.FileHandler(log_path)
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    logger.propagate = False
    return logger
