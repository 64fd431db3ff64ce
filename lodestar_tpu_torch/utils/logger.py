"""Module-scoped loggers of the port's chain modules.

The counterpart of ``lodestar_tpu/utils/logger.py``'s ``get_logger``:
children of the ``lodestar_tpu_torch`` logger, whose stderr handler and
line format (text or JSON, with the batch id) ``cli.py`` sets; the level
comes from ``LODESTAR_LOG_LEVEL`` when it is set.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

_ROOT_NAME = "lodestar_tpu_torch"


def get_logger(module: str = "", level: Optional[str] = None) -> logging.Logger:
    """The logger ``lodestar_tpu_torch.<module>`` (the root one for "")."""
    root = logging.getLogger(_ROOT_NAME)
    env = os.environ.get("LODESTAR_LOG_LEVEL")
    if env and root.level == logging.NOTSET:
        root.setLevel(env.upper())
    logger = root.getChild(module) if module else root
    if level:
        logger.setLevel(level.upper())
    return logger
