"""The package's logger (counterpart of ``deepspeed_tpu/utils/logging.py``).

One ``logging.Logger`` named ``deepspeed_tpu_torch`` that the telemetry
modules warn through.  It writes to standard error, so a process whose
standard output carries a protocol (a fleet replica's handshake, the
smoke's last JSON lines) keeps it clean.  ``DS_LOG_LEVEL`` sets the level
(default ``info``).
"""

from __future__ import annotations

import logging
import os
import sys

_LEVELS = {"debug": logging.DEBUG, "info": logging.INFO,
           "warning": logging.WARNING, "error": logging.ERROR,
           "critical": logging.CRITICAL}


def _create_logger(name: str, level: int) -> logging.Logger:
    lg = logging.getLogger(name)
    lg.setLevel(level)
    lg.propagate = False
    if not lg.handlers:
        handler = logging.StreamHandler(stream=sys.stderr)
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
            datefmt="%Y-%m-%d %H:%M:%S"))
        lg.addHandler(handler)
    return lg


logger = _create_logger(
    "deepspeed_tpu_torch",
    _LEVELS.get(os.environ.get("DS_LOG_LEVEL", "info").lower(), logging.INFO))
