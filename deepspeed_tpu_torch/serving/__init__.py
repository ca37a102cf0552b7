"""Fleet serving: N scheduler replicas behind a prefix-affinity router
with live migration (:class:`ReplicaPool`), and disaggregated prefill /
decode engines with a committed-page KV handoff (:class:`DisaggPool`).
Counterpart of ``deepspeed_tpu/serving``; the in-process mode only."""

from .disagg import DisaggPool
from .pool import PoolRequest, ReplicaPool
from .router import (POLICIES, PrefixAffinityRouter, RouteDecision,
                     fetch_remote_hints)

__all__ = ["ReplicaPool", "PoolRequest", "PrefixAffinityRouter",
           "RouteDecision", "POLICIES", "fetch_remote_hints",
           "DisaggPool"]
