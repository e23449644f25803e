"""Logger (counterpart of raft_tpu/core/logger.py; `raft::logger`
core/logger.hpp:118): stdlib logging under the name "raft_tpu_torch",
with RAFT's level numbers, a pattern setter and a callback sink
(core/detail/callback_sink.hpp) so callers can capture the records.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

# RAFT level numbers (logger.hpp: RAFT_LEVEL_TRACE=6 .. RAFT_LEVEL_OFF=0)
RAFT_LEVEL_OFF = 0
RAFT_LEVEL_CRITICAL = 1
RAFT_LEVEL_ERROR = 2
RAFT_LEVEL_WARN = 3
RAFT_LEVEL_INFO = 4
RAFT_LEVEL_DEBUG = 5
RAFT_LEVEL_TRACE = 6

_RAFT_TO_PY = {
    RAFT_LEVEL_OFF: logging.CRITICAL + 10,
    RAFT_LEVEL_CRITICAL: logging.CRITICAL,
    RAFT_LEVEL_ERROR: logging.ERROR,
    RAFT_LEVEL_WARN: logging.WARNING,
    RAFT_LEVEL_INFO: logging.INFO,
    RAFT_LEVEL_DEBUG: logging.DEBUG,
    RAFT_LEVEL_TRACE: 5,
}

logger = logging.getLogger("raft_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(levelname)s] [%(asctime)s] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.WARNING)


def set_level(level: int) -> None:
    """Set verbosity using RAFT level numbers (0=off .. 6=trace)."""
    logger.setLevel(_RAFT_TO_PY.get(level, logging.WARNING))


def set_pattern(fmt: str) -> None:
    """Set the log format string (python logging format syntax)."""
    for h in logger.handlers:
        h.setFormatter(logging.Formatter(fmt))


class _CallbackHandler(logging.Handler):
    def __init__(self, cb: Callable[[int, str], None], flush_cb: Optional[Callable] = None):
        super().__init__()
        self._cb = cb
        self._flush_cb = flush_cb

    def emit(self, record):
        self._cb(record.levelno, self.format(record))

    def flush(self):
        if self._flush_cb is not None:
            self._flush_cb()


def set_callback(cb: Optional[Callable[[int, str], None]], flush_cb=None) -> None:
    """Install a callback sink (parity with callback_sink.hpp); None removes."""
    for h in list(logger.handlers):
        if isinstance(h, _CallbackHandler):
            logger.removeHandler(h)
    if cb is not None:
        logger.addHandler(_CallbackHandler(cb, flush_cb))
