"""Hostfile parsing and resource filtering.

Counterpart of ``deepspeed_tpu/launcher/hostfile.py`` (the reference
launcher's ``fetch_hostfile`` / ``_parse_hostfile`` and its
``--include`` / ``--exclude`` filters).

Format (one host per line)::

    worker-0 slots=4
    worker-1 slots=4

``slots`` is the GPUs of a host: the launcher starts one rank process
per slot (``--proc_per_chip``), or ``--num_gpus N`` rank processes on a
host whatever its cards.
"""

from __future__ import annotations

import os
import re
from collections import OrderedDict
from typing import Dict, Optional

from ..utils.logging import logger

_HOST_RE = re.compile(r"^(?P<host>[\w.\-]+)(\s+slots=(?P<slots>\d+))?\s*(#.*)?$")


def parse_hostfile(text: str) -> "OrderedDict[str, int]":
    """Parse hostfile text into ``{hostname: slots}`` (insertion-ordered)."""
    resources: "OrderedDict[str, int]" = OrderedDict()
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = _HOST_RE.match(line)
        if m is None:
            raise ValueError(f"hostfile line {lineno} is malformed: {raw!r}")
        host = m.group("host")
        slots = int(m.group("slots") or 1)
        if host in resources:
            raise ValueError(f"hostfile line {lineno}: duplicate host {host!r}")
        resources[host] = slots
    return resources


def fetch_hostfile(path: Optional[str]) -> Optional["OrderedDict[str, int]"]:
    """Read + parse a hostfile; ``None`` (single-node) if absent."""
    if path is None or not os.path.isfile(path):
        if path:
            logger.warning("hostfile %s not found - assuming single node", path)
        return None
    with open(path, "r", encoding="utf-8") as fh:
        return parse_hostfile(fh.read())


def _parse_filter(spec: str) -> Dict[str, Optional[list]]:
    """Parse ``host1@host2:0,2`` style include/exclude specs.

    ``host`` alone selects every slot; ``host:0,2`` selects slots 0 and 2.
    """
    out: Dict[str, Optional[list]] = {}
    for part in spec.split("@"):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            host, idx = part.split(":", 1)
            out[host] = sorted({int(i) for i in idx.split(",") if i != ""})
        else:
            out[part] = None
    return out


def filter_resources(resources: "OrderedDict[str, int]",
                     include: str = "",
                     exclude: str = "") -> "OrderedDict[str, int]":
    """Apply ``--include``/``--exclude`` to a parsed hostfile.

    Mirrors the reference semantics (``runner.py:255`` ``parse_resource_filter``):
    the two flags are mutually exclusive; slot lists narrow a host; an
    excluded host with no slot list is dropped entirely.
    """
    if include and exclude:
        raise ValueError("--include and --exclude are mutually exclusive")
    if not include and not exclude:
        return resources

    spec = _parse_filter(include or exclude)
    for host in spec:
        if host not in resources:
            raise ValueError(f"filter references unknown host {host!r}")

    filtered: "OrderedDict[str, int]" = OrderedDict()
    if include:
        for host, slots in spec.items():
            avail = resources[host]
            if slots is None:
                filtered[host] = avail
            else:
                bad = [s for s in slots if s >= avail]
                if bad:
                    raise ValueError(f"host {host!r} has {avail} slots; "
                                     f"cannot include {bad}")
                filtered[host] = len(slots)
    else:
        for host, slots in spec.items():
            if slots is not None:
                avail = resources[host]
                bad = [s for s in slots if s >= avail]
                if bad:
                    raise ValueError(f"host {host!r} has {avail} slots; "
                                     f"cannot exclude {bad}")
        for host, avail in resources.items():
            if host not in spec:
                filtered[host] = avail
            else:
                slots = spec[host]
                if slots is not None and len(slots) < avail:
                    filtered[host] = avail - len(slots)
                # whole host excluded -> dropped
    if not filtered:
        raise ValueError("resource filter removed every host")
    return filtered
