"""Logging gated by debug level (port of the JAX package's
`utils/logging.py`).  Level 0 = errors only, 1 = info, 2 = per-step timing
chatter.  Both packages read the same ``ARC_TPU_DEBUG_LEVEL`` variable, so
one setting serves either."""

from __future__ import annotations

import os
import sys

_LEVEL = int(os.environ.get("ARC_TPU_DEBUG_LEVEL", "1"))


def set_level(level: int) -> None:
    global _LEVEL
    _LEVEL = level


def log(msg: str, level: int = 1) -> None:
    if level <= _LEVEL:
        print(msg, file=sys.stderr, flush=True)
