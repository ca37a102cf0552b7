"""Capacity bins (counterpart of ``deepspeed_tpu/moe/capacity_bins.py``;
reference HabanaAI ``moe/capacity_bins.py:14`` ``CapacityBins``).

Capacities are bucketed into a few precomputed bin sizes so that the
shapes stay static (for the port: so that a CUDA graph per step key
serves every capacity a key can see).  Bins grow geometrically from
``min_capacity`` to the no-drop maximum.
"""

from __future__ import annotations

import math
from typing import List


def build_capacity_bins(cfg, num_tokens: int) -> List[int]:
    """Geometric bins covering [min_capacity, num_tokens]."""
    n = max(cfg.num_capacity_bins, 1)
    lo = max(cfg.min_capacity, 1)
    hi = max(num_tokens, lo + 1)
    base = max(cfg.capacity_bins_exp_base, 1.01)
    bins = []
    v = float(lo)
    while v < hi and len(bins) < n - 1:
        bins.append(int(math.ceil(v)))
        v *= base
    bins.append(hi)
    return sorted(set(bins))
