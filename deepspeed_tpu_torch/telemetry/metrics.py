"""Central metric catalog: every ``ds_*`` name the serving stack emits.

Counterpart of ``deepspeed_tpu/telemetry/metrics.py`` with the same
names, kinds and buckets, so a scraper reads the same series from either
package.  All names are minted here (components import the objects,
never call ``registry.counter(...)`` with a novel name).  Families whose
producers are not ported yet (training, the watchdog, the memory ledger,
sharded serving) are minted all the same and stay at zero.

Naming convention: ``ds_<area>_<name>`` with area one of
{serving, comm, kv, train, fastgen, chaos, fleet, slo, telemetry,
pool, disagg, journey, mem};
counters end in ``_total``.
"""

from __future__ import annotations

from .registry import get_registry

registry = get_registry()

# -- serving transfer/program accounting --------------------------------------
SERVING_PROGRAMS = registry.counter(
    "ds_serving_programs_total", "compiled-step program dispatches")
SERVING_STEPS = registry.counter(
    "ds_serving_steps_total", "scheduler steps")
SERVING_H2D_BYTES = registry.counter(
    "ds_serving_h2d_bytes_total",
    "host->device bytes of batch/sampling arrays fed to programs")
SERVING_D2H_BYTES = registry.counter(
    "ds_serving_d2h_bytes_total", "device->host bytes actually synced")
SERVING_LOGITS_BYTES = registry.counter(
    "ds_serving_logits_bytes_total",
    "vocab-wide [n,V] logits buffers materialized across put()")
SERVING_PREFIX_LOOKUP_TOKENS = registry.counter(
    "ds_serving_prefix_lookup_tokens_total",
    "prompt tokens offered for prefix-cache matching")
SERVING_PREFIX_HIT_TOKENS = registry.counter(
    "ds_serving_prefix_hit_tokens_total",
    "prompt tokens served from cached pages")
SERVING_PREFIX_EVICTED_PAGES = registry.counter(
    "ds_serving_prefix_evicted_pages_total",
    "prefix-cache pages LRU-evicted under pool pressure")
SERVING_PREFILL_TOKENS = registry.counter(
    "ds_serving_prefill_tokens_total", "prompt tokens actually prefilled")

# -- gradient-collective wire plan (CollectiveScheduler) --------------------
COMM_BUCKET_COUNT = registry.gauge(
    "ds_comm_bucket_count", "gradient-collective buckets per step")
COMM_WIRE_BYTES = registry.gauge(
    "ds_comm_wire_bytes_per_step", "bytes on the wire per train step")
COMM_FP32_BYTES = registry.gauge(
    "ds_comm_fp32_bytes_per_step",
    "fp32-equivalent gradient bytes per train step")
COMM_QUANTIZED_FRACTION = registry.gauge(
    "ds_comm_quantized_fraction",
    "fraction of gradient wire volume riding the quantized path")

# -- KV-pool page states (bound to the live allocator at engine build) ------
KV_FREE_PAGES = registry.gauge(
    "ds_kv_free_pages", "KV pool free-list pages")
KV_LIVE_PAGES = registry.gauge(
    "ds_kv_live_pages", "KV pool pages referenced by block tables")
KV_PARKED_PAGES = registry.gauge(
    "ds_kv_parked_pages",
    "KV pool refcount-0 pages retained by the prefix cache")
KV_TOTAL_PAGES = registry.gauge(
    "ds_kv_total_pages", "KV pool size in pages")

# -- tiered KV prefix store ---------------------------------------
KV_TIER_HOST_PAGES = registry.gauge(
    "ds_kv_tier_host_pages",
    "prefix pages resident in the host DRAM tier ring")
KV_TIER_DISK_PAGES = registry.gauge(
    "ds_kv_tier_disk_pages",
    "prefix pages resident in the disk tier")
KV_TIER_DEMOTED = registry.counter(
    "ds_kv_tier_demoted_total",
    "parked prefix pages demoted device -> host tier instead of being "
    "freed under pool pressure")
KV_TIER_PROMOTED = registry.counter(
    "ds_kv_tier_promoted_total",
    "prefix pages promoted from the host/disk tier back onto device "
    "at prefix-match time")
KV_TIER_IO_ERRORS = registry.counter(
    "ds_kv_tier_io_errors_total",
    "tier demotion/promotion I/O failures degraded to a clean miss "
    "(torn entries dropped, never served)")
KV_TIER_PROMOTE_MS = registry.histogram(
    "ds_kv_tier_promote_ms",
    "wall time of one tier promotion batch (host/disk read + device "
    "scatter), overlapped behind the uncached-suffix prefill")

# -- training throughput ----------------------------------------------------
TRAIN_SAMPLES_PER_SEC = registry.gauge(
    "ds_train_samples_per_sec", "ThroughputTimer samples/s")
TRAIN_STEP_TIME_MS = registry.histogram(
    "ds_train_step_time_ms", "train_batch wall time per global step")

# -- health watchdog ----------------------------------------------
TRAIN_NONFINITE = registry.counter(
    "ds_train_nonfinite_total",
    "host-fetched loss/grad-norm values that came back non-finite")
TRAIN_OVERFLOW_SKIP = registry.counter(
    "ds_train_overflow_skip_total",
    "fp16 dynamic-loss-scale overflow steps skipped")
TRAIN_ANOMALY = registry.counter(
    "ds_train_anomaly_total",
    "step-time anomalies flagged by the EWMA watchdog (train + fastgen)")
TRAIN_MONITOR_DROP = registry.counter(
    "ds_train_monitor_drop_total",
    "monitor write batches dropped because a writer raised")

# -- goodput accounting (callback gauges fed by the watchdog) ----------------
TRAIN_GOODPUT_RATIO = registry.gauge(
    "ds_train_goodput_ratio",
    "fraction of wallclock spent in the fused train step")
TRAIN_COMPILE_FRACTION = registry.gauge(
    "ds_train_compile_fraction",
    "fraction of wallclock spent compiling (first-trace steps)")
TRAIN_INPUT_WAIT_FRACTION = registry.gauge(
    "ds_train_input_wait_fraction",
    "fraction of wallclock spent placing/waiting on input batches")
TRAIN_STEP_FRACTION = registry.gauge(
    "ds_train_step_fraction",
    "fraction of wallclock spent in dispatched train steps")
TRAIN_CHECKPOINT_FRACTION = registry.gauge(
    "ds_train_checkpoint_fraction",
    "fraction of wallclock spent saving/loading checkpoints")
TRAIN_IDLE_FRACTION = registry.gauge(
    "ds_train_idle_fraction",
    "fraction of wallclock in none of the tracked phases")

# -- serving step-cache / recompile accounting ---------------------
FASTGEN_STEP_CACHE_HIT = registry.counter(
    "ds_fastgen_step_cache_hit_total",
    "serving step-cache lookups served by a compiled program")
FASTGEN_STEP_CACHE_MISS = registry.counter(
    "ds_fastgen_step_cache_miss_total",
    "serving step-cache lookups that missed the compiled lattice")
FASTGEN_COMPILE_ON_PATH = registry.counter(
    "ds_fastgen_compile_on_path_total",
    "step programs built (graphs captured) on the serving request path")

# -- persistent compile cache -------------------------------------
FASTGEN_COMPILE_CACHE_HIT = registry.counter(
    "ds_fastgen_compile_cache_hit_total",
    "serving executables LOADED from the persistent compile cache "
    "(a load instead of a build)")
FASTGEN_COMPILE_CACHE_MISS = registry.counter(
    "ds_fastgen_compile_cache_miss_total",
    "cache-eligible compiles the persistent compile cache could not "
    "serve (true builds, written back to the cache)")

# -- fault injection + self-healing --------------------------------
CHAOS_INJECTED = registry.counter(
    "ds_chaos_injected_total",
    "faults fired by the fault-injection registry")
TRAIN_ROLLBACK = registry.counter(
    "ds_train_rollback_total",
    "self-healing rollbacks to the last good checkpoint/snapshot after "
    "a non-finite applied step")
TRAIN_RETRY = registry.counter(
    "ds_train_retry_total",
    "train_batch attempts retried after a transient (retry-safe) fault")
TRAIN_CKPT_RETRY = registry.counter(
    "ds_train_ckpt_retry_total",
    "checkpoint I/O operations retried after an OSError")
FASTGEN_SHED = registry.counter(
    "ds_fastgen_shed_total",
    "requests shed by admission control (queue depth / queue-wait SLO / "
    "unservable demand)")
FASTGEN_EXPIRED = registry.counter(
    "ds_fastgen_expired_total",
    "requests terminated because their deadline/TTL passed")
FASTGEN_REQUEST_ERROR = registry.counter(
    "ds_fastgen_request_error_total",
    "requests evicted by per-request error isolation (poisoned/oom)")
KV_ALLOC_FAIL = registry.counter(
    "ds_kv_alloc_fail_total",
    "KV-page allocation failures absorbed by the degradation ladder")

# -- preemption-tolerant serving -----------------------------------
FASTGEN_SNAPSHOT_MS = registry.histogram(
    "ds_fastgen_snapshot_ms",
    "drain + serialize wall time of a serving state snapshot")
FASTGEN_RESTORE = registry.counter(
    "ds_fastgen_restore_total",
    "serving snapshot bundles restored into a fresh engine")
FASTGEN_MIGRATED = registry.counter(
    "ds_fastgen_migrated_total",
    "requests terminated with code=migrated because the preemption "
    "grace budget expired before a snapshot was written")

# -- workload observatory ------------------------------------------
FASTGEN_TRACE_RECORDS = registry.counter(
    "ds_fastgen_trace_records_total",
    "request records appended to the workload-trace ledger")
FASTGEN_QUEUE_DEPTH = registry.gauge(
    "ds_fastgen_queue_depth",
    "requests waiting for first admission on the live scheduler")
FASTGEN_RUNNING = registry.gauge(
    "ds_fastgen_running",
    "requests currently running on the live scheduler")
FASTGEN_PREEMPTED = registry.gauge(
    "ds_fastgen_preempted",
    "requests preempted to host (KV offloaded) on the live scheduler")
FASTGEN_PROGRAM_FLOPS = registry.gauge(
    "ds_fastgen_program_flops",
    "FLOPs of the most recently dispatched serving program (the "
    "analytic cost of its step key)")
FASTGEN_PROGRAM_BYTES = registry.gauge(
    "ds_fastgen_program_bytes",
    "bytes accessed by the most recently dispatched serving program "
    "(the analytic cost of its step key)")
FASTGEN_MFU = registry.gauge(
    "ds_fastgen_mfu",
    "serving model-FLOPs utilization: dispatched program FLOPs / wall "
    "since the cost window opened / peak (DS_PEAK_FLOPS)")
FASTGEN_BYTES_PER_S = registry.gauge(
    "ds_fastgen_bytes_per_s",
    "serving HBM traffic rate: dispatched program bytes accessed / "
    "wall since the cost window opened")

# -- sharded fused serving ----------------------------------------
FASTGEN_SHARD_COUNT = registry.gauge(
    "ds_fastgen_shard_count",
    "tensor-parallel degree of the fused serving program (1 = "
    "unsharded; set at engine build from serving.tp_degree)")
FASTGEN_SHARD_MFU = registry.gauge(
    "ds_fastgen_shard_mfu",
    "per-shard serving MFU: dispatched program FLOPs / tp / wall / "
    "one device's peak (cost_analysis covers the whole logical "
    "program, each shard executes 1/tp of it)")
FASTGEN_SHARD_BYTES_PER_S = registry.gauge(
    "ds_fastgen_shard_bytes_per_s",
    "per-shard HBM traffic rate: dispatched program bytes / tp / "
    "wall since the cost window opened")
FASTGEN_SHARD_COLLECTIVE_BYTES = registry.counter(
    "ds_fastgen_shard_collective_bytes_total",
    "analytic interconnect bytes moved by the in-program logits "
    "all-gather at its configured encoding (int8 codes + fp32 "
    "scales, or fp32 when tp_collective_quantization=none)")
FASTGEN_SHARD_COLLECTIVE_FP_BYTES = registry.counter(
    "ds_fastgen_shard_collective_fp_bytes_total",
    "fp32-equivalent interconnect bytes of the same logits "
    "all-gathers — the denominator for the encoding's compression "
    "ratio")

# -- speculative decoding -----------------------------------------
FASTGEN_SPEC_DRAFTED = registry.counter(
    "ds_fastgen_spec_drafted_total",
    "draft tokens proposed by the prompt-lookup drafter and dispatched "
    "for fused verification")
FASTGEN_SPEC_ACCEPTED = registry.counter(
    "ds_fastgen_spec_accepted_total",
    "draft tokens accepted by on-device verification and committed")
FASTGEN_SPEC_ACCEPT_RATE = registry.gauge(
    "ds_fastgen_spec_accept_rate",
    "cumulative accepted/drafted ratio of speculative decoding")

# -- model-drafted speculation ------------------------------------
FASTGEN_SPEC_DRAFT_DRAFTED = registry.counter(
    "ds_fastgen_spec_draft_drafted_total",
    "draft tokens produced by the device-resident draft trunk inside "
    "fused draft_spec steps")
FASTGEN_SPEC_DRAFT_ACCEPTED = registry.counter(
    "ds_fastgen_spec_draft_accepted_total",
    "model-drafted tokens accepted by on-device verification and "
    "committed")
FASTGEN_SPEC_DRAFT_ACCEPT_RATE = registry.gauge(
    "ds_fastgen_spec_draft_accept_rate",
    "cumulative accepted/drafted ratio of the model drafter alone")
FASTGEN_SPEC_DRAFT_FILL = registry.counter(
    "ds_fastgen_spec_draft_fill_tokens_total",
    "committed-history tokens replayed through the draft trunk in "
    "token-less catch-up steps (restore/handoff/ngram-phase lag)")

# -- fleet observatory --------------------------------------------
FASTGEN_TOKENS = registry.counter(
    "ds_fastgen_tokens_total",
    "committed tokens delivered host-side across all requests (the "
    "windowed tok/s numerator; counted even telemetry-off, like "
    "ServingCounters)")
TELEMETRY_PORT = registry.gauge(
    "ds_telemetry_port",
    "TCP port the local metrics endpoint actually bound (ephemeral "
    "under DS_METRICS_PORT=0 — federation discovers replicas by it)")
FLEET_REPLICAS_LIVE = registry.gauge(
    "ds_fleet_replicas_live",
    "federation replicas answering scrapes within the staleness bound")
FLEET_REPLICAS_STALE = registry.gauge(
    "ds_fleet_replicas_stale",
    "federation replicas whose last successful scrape is stale (their "
    "last-good snapshot stays in the merge)")
SLO_STATUS = registry.gauge(
    "ds_slo_status",
    "worst current SLO verdict across objectives (0 ok, 1 warn, "
    "2 page)")
SLO_WORST_BURN = registry.gauge(
    "ds_slo_worst_fast_burn",
    "highest fast-window burn rate across configured objectives")
SLO_PAGES = registry.counter(
    "ds_slo_pages_total",
    "SLO objective transitions into the page verdict")
SLO_WARNS = registry.counter(
    "ds_slo_warns_total",
    "SLO objective transitions into the warn verdict (from ok)")

# -- replica pool --------------------------------------------------
POOL_REPLICAS = registry.gauge(
    "ds_pool_replicas",
    "live replicas fronted by the ReplicaPool router")
POOL_ROUTED = registry.counter(
    "ds_pool_routed_total",
    "requests placed on a replica by the pool router")
POOL_AFFINITY_ROUTED = registry.counter(
    "ds_pool_affinity_routed_total",
    "requests placed by prefix-digest affinity (the rest fell back to "
    "least-backlog / round-robin)")
POOL_MIGRATED = registry.counter(
    "ds_pool_migrated_requests_total",
    "in-flight requests re-homed to a peer replica (drain-and-migrate "
    "scale-down or abrupt replica death), partial tokens kept")
POOL_SCALE_UP = registry.counter(
    "ds_pool_scale_up_total", "replicas added to the pool")
POOL_SCALE_DOWN = registry.counter(
    "ds_pool_scale_down_total",
    "replicas drained, migrated away, and removed from the pool")
POOL_REBALANCE = registry.counter(
    "ds_pool_rebalance_total",
    "hot digest groups re-homed to a colder replica")
POOL_REPLICA_DEATHS = registry.counter(
    "ds_pool_replica_deaths_total",
    "replicas that died abruptly (preemption/kill) and had their "
    "tracked requests resubmitted to survivors")

# -- cross-replica page fetch --------------------------------------
POOL_PAGE_FETCHES = registry.counter(
    "ds_pool_page_fetches_total",
    "affinity-miss placements that streamed matched prefix pages from "
    "the best-match peer replica instead of recomputing prefill")
POOL_PAGE_FETCH_PAGES = registry.counter(
    "ds_pool_page_fetch_pages_total",
    "KV pages streamed replica-to-replica by cross-replica page fetch")
POOL_PAGE_FETCH_BYTES = registry.counter(
    "ds_pool_page_fetch_bytes_total",
    "bytes of page payload + scales crossing the cross-replica fetch "
    "seam")
POOL_PAGE_FETCH_MS = registry.histogram(
    "ds_pool_page_fetch_ms",
    "wall time of one cross-replica page fetch (peer export -> local "
    "import)")

# -- disaggregated prefill/decode serving --------------------------
DISAGG_HANDOFFS = registry.counter(
    "ds_disagg_handoffs_total",
    "sequences streamed from the prefill pool to the decode pool "
    "(committed pages + residual request state)")
DISAGG_HANDOFF_BYTES = registry.counter(
    "ds_disagg_handoff_bytes_total",
    "bytes of KV page blobs + residual arrays crossing the prefill -> "
    "decode handoff seam")
DISAGG_HANDOFF_MS = registry.histogram(
    "ds_disagg_handoff_ms",
    "wall time of one handoff batch: selective export -> merge import "
    "-> prefill-side flush")
DISAGG_PAGES_STREAMED = registry.counter(
    "ds_disagg_pages_streamed_total",
    "KV pages physically copied across the handoff seam")
DISAGG_PAGES_SHARED = registry.counter(
    "ds_disagg_pages_shared_total",
    "KV pages the decode pool already held (chain-digest dedup against "
    "its prefix cache) — attached by reference, never copied")
DISAGG_HANDOFF_RETRY = registry.counter(
    "ds_disagg_handoff_retry_total",
    "handoff imports deferred by decode-pool KV backpressure")
DISAGG_MISROUTED = registry.counter(
    "ds_disagg_misrouted_total",
    "requests rejected by a role-restricted scheduler's admission "
    "(structured RequestError code=misrouted)")
DISAGG_HANDOFF_BACKLOG = registry.gauge(
    "ds_disagg_handoff_backlog",
    "requests parked handoff-ready on the prefill pool awaiting "
    "collection")
DISAGG_PREFILL_MFU = registry.gauge(
    "ds_disagg_prefill_mfu",
    "prefill pool model-FLOPs utilization over its cost window (per-program "
    "accounting, read per pool)")
DISAGG_DECODE_HBM_GB_S = registry.gauge(
    "ds_disagg_decode_hbm_gb_s",
    "decode pool HBM traffic rate (GB/s of bytes accessed) over its "
    "cost window")

# -- request journeys ----------------------------------------------
JOURNEY_FLUSHED = registry.counter(
    "ds_journey_flushed_total",
    "completed request journeys published to the journey log at "
    "drain/error (one per request, on its final scheduler)")
JOURNEY_FRAGMENTS = registry.counter(
    "ds_journey_fragments_total",
    "journey fragments exported at a pool/process boundary (handoff "
    "export) — a fragment whose jid never completes is an orphan")
JOURNEY_SEGMENT_MS = registry.histogram(
    "ds_journey_segment_ms",
    "duration of one typed journey segment (queue_wait, placement, "
    "prefill, handoff_*, migrate, decode, ...), observed at flush")

# -- memory observatory --------------------------------------------
MEM_WEIGHTS_BYTES = registry.gauge(
    "ds_mem_weights_bytes",
    "model weight bytes resident in this process (per-shard slice "
    "footprint under tensor parallelism, not the global array size)")
MEM_KV_PAGES_BYTES = registry.gauge(
    "ds_mem_kv_pages_bytes",
    "device KV page pool bytes at the true quantized bytes_per_page "
    "footprint (codes + scales)")
MEM_DRAFT_KV_BYTES = registry.gauge(
    "ds_mem_draft_kv_bytes",
    "draft-model KV page pool bytes (0 when model-drafted speculation "
    "is off)")
MEM_TIER_HOST_BYTES = registry.gauge(
    "ds_mem_tier_host_bytes",
    "KV tier host DRAM ring bytes (evicted page blobs parked in host "
    "memory)")
MEM_TIER_DISK_BYTES = registry.gauge(
    "ds_mem_tier_disk_bytes",
    "KV tier disk directory bytes (spilled page files, byte-audited "
    "against the kv_tier_disk_pages bound)")
MEM_OFFLOAD_BYTES = registry.gauge(
    "ds_mem_offload_bytes",
    "offloaded host KV blob bytes held by the state manager")
MEM_STAGING_BYTES = registry.gauge(
    "ds_mem_staging_bytes",
    "snapshot/handoff staging bytes: committed KV held for "
    "handoff-ready sequences awaiting collection")
MEM_TELEMETRY_BYTES = registry.gauge(
    "ds_mem_telemetry_bytes",
    "approximate footprint of the telemetry rings themselves (span "
    "buffer, flight events, time-series ring)")
MEM_ACCOUNTED_BYTES = registry.gauge(
    "ds_mem_accounted_bytes",
    "sum of every registered memory-ledger accountant")
MEM_PEAK_ACCOUNTED_BYTES = registry.gauge(
    "ds_mem_peak_accounted_bytes",
    "watermark peak of ds_mem_accounted_bytes since ledger arm/reset")
MEM_MEASURED_BYTES = registry.gauge(
    "ds_mem_measured_bytes",
    "resident bytes from the truth ladder: device memory_stats, live "
    "tensors (CPU-debug), process RSS")
MEM_UNACCOUNTED_BYTES = registry.gauge(
    "ds_mem_unaccounted_bytes",
    "measured bytes minus device-resident accounted bytes — the "
    "residual that makes accounting drift visible instead of silent")
MEM_HEADROOM_SEQS = registry.gauge(
    "ds_mem_headroom_seqs",
    "admissible additional sequences at the observed per-sequence "
    "page distribution (free + parked pages over the mined p90 "
    "pages-per-seq)")
MEM_PRESSURE = registry.counter(
    "ds_mem_pressure_total",
    "memory-pressure events: tier disk byte-bound LRU evictions and "
    "KV allocation failures entering the degrade ladder")
MEM_DRIFT_ANOMALY = registry.counter(
    "ds_mem_drift_anomaly_total",
    "resident-bytes samples flagged by the watchdog memory-drift "
    "detector (EWMA growth, storm semantics like step-time anomalies)")
MEM_DEGRADE_FREED_PAGES = registry.counter(
    "ds_mem_degrade_freed_pages_total",
    "KV pages freed by degrade-ladder rungs (reclaim/preempt/shed), "
    "accounted per lever in the mem.breakdown flight event")

# -- serving SLO histograms (recorded per request at drain time) ------------
FASTGEN_TTFT_MS = registry.histogram(
    "ds_fastgen_ttft_ms", "time to first token, submit -> host-visible")
FASTGEN_ITL_MS = registry.histogram(
    "ds_fastgen_itl_ms", "inter-token latency between host-visible tokens")
FASTGEN_QUEUE_WAIT_MS = registry.histogram(
    "ds_fastgen_queue_wait_ms", "submit -> first scheduled admission")
FASTGEN_STEP_MS = registry.histogram(
    "ds_fastgen_step_ms", "scheduler step wall time")
