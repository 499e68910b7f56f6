"""Process-wide logger factory (counterpart of
``deeplio_tpu/utils/logger.py``; reference: ``deeplio/common/logger.py``).

One named app logger, ``deeplio_tpu_torch``, with an optional file sink
and its level from the first call, on top of stdlib logging.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

APP_LOGGER_NAME = "deeplio_tpu_torch"


def get_app_logger(filename: Optional[str] = None,
                   level: str = "info") -> logging.Logger:
    """Return the framework logger, configuring it on the first call;
    later calls return it whatever their arguments."""
    logger = logging.getLogger(APP_LOGGER_NAME)
    if logger.handlers:
        return logger
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    fmt = logging.Formatter("[%(asctime)s][%(levelname)s] %(message)s",
                            datefmt="%H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if filename:
        os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
        fh = logging.FileHandler(filename)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger
