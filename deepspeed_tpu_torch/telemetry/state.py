"""Process-wide telemetry on/off switch.

Counterpart of ``deepspeed_tpu/telemetry/state.py``.  A single attribute
read (``state.enabled``) is the whole disabled-path cost of every span,
flight-recorder and journey site, so the flag lives in its own module
that imports nothing but the standard library.

Enabled via ``DS_TELEMETRY=1`` (read once at import), the engine
config's ``telemetry.enabled``, or :func:`deepspeed_tpu_torch.telemetry.
enable`.
"""

from __future__ import annotations

import os


class _TelemetryState:
    __slots__ = ("enabled", "generation")

    def __init__(self, enabled: bool):
        self.enabled = enabled
        #: bumped on every off->on transition, so a latency stamp taken
        #: in an earlier enabled window is recognised as stale (an
        #: inter-token latency must not span a disabled gap)
        self.generation = 1


state = _TelemetryState(
    os.environ.get("DS_TELEMETRY", "") not in ("", "0"))
