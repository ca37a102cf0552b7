#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``deepspeed_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is ignored):

1. card and software: ``nvidia-smi`` name and power limit, torch / CUDA;
2. build: every hand-written kernel of the serving and training paths
   from ``deepspeed_tpu_torch/csrc`` (one ``nvcc`` per source, in
   parallel) into the serving compile cache's directory
   (``build/compile_cache/<digest>``); ptxas's report of each kernel's
   registers, and a failure if any kernel spills;
3. each kernel against its plain PyTorch version at the shapes its path
   gives it (bf16; the optimizers and the quantiser's input in fp32):
   error relative to the case's own reference scale against stated
   tolerances (the blockwise quantisation bit for bit), kernel / plain /
   library-yardstick times (CUDA events; null where no one PyTorch call
   computes the function) and the bound (the larger of bytes / 3.35
   TB/s and operations / 989 TFLOP/s bf16 or 67 fp32, H100 SXM data
   sheet); the flash backward also bit-equal over two calls, and its
   dK/dV and dQ kernels and the wrapper's delta timed apart, each with
   its own bound, at D = 128 and at the families' training head dims
   (Falcon-7B's 71 query heads over one kv head at D = 64, B = 1;
   Phi-2's at 80; Phi-3-mini's at 96 under its 2047-token window; S =
   2048), each bound counted at D, not at the padded tile's width; the norms also split each call of the wrapper and of
   the library call into ``host_us`` (a host clock around 1000 calls,
   nothing waiting inside: the enqueue cost) and ``device_us`` (the
   kernels' durations per call from torch.profiler over 200 calls);
   the paged kernel also at the speculative verify shapes (Q=4: Llama
   S=16, H=K=32, the split-KV path; Mistral H=32, K=8, window 4096 over
   contexts to 8192, the tile); the serving kernels also at the Q tops
   ``fit_buckets`` fits to phase 6g's prompt lengths (flash at B=2, the
   paged kernel over bf16 and int8 pages at S=2, the norms at N = 2·Q);
   and the attention kernels at head dims 64, 80 and 96 (phases 9b-9d):
   the paged kernel's split-KV decode, Falcon-7B's multi-query decode on
   the tile, a prefill chunk and Phi-3-mini's window over bf16 and int8
   pages, the flash forward at B=4, S=1024 with each model's heads; the
   weight dequantise kernel (``fp_dequant``, replacing no Pallas kernel:
   the JAX package's ``_wval``, which XLA fuses into the einsum) bit for
   bit at Mixtral-8x7B's expert leaf [8, 4096, 14336] (fp8 and int8
   codes) and an attention leaf [4096, 32, 128];
4. FastGen serving of Llama-2-7B at full width (32 layers, random seeded
   bf16 weights, 256 KV pages of 64 tokens) in the default serving
   configuration (one CUDA graph per step key, the async chained decode,
   prefix caching): 8 greedy and 2 sampled requests through
   ``FastGenScheduler``, a warm-up pass that captures the graphs the
   traffic needs, then a timed pass of the same traffic that must capture
   nothing and replay a graph at every step, with every kernel's launch
   count (counted per replay) held exactly to the segments of the keys it
   dispatched; graph count, capture seconds and pool bytes; a third pass
   in which every dispatch also runs its key's step body eagerly on the
   same inputs before the key's graph replays (greedy tokens bit-equal
   for every key the timed pass dispatched); four profiled decode steps;
5. graph against eager at one decode key of that traffic: 20 eager steps
   (the step body called directly) against 20 replays, host ms, device
   ms and busy share;
6. prefix caching at full width: one cold request with a 1024-token
   prefix, then 7 warm requests sharing it (each must hit 1024 tokens),
   warm against cold TTFT, the prefill tokens computed, the page audit
   and exact launch counts; each warm request against the same request
   after ``reset_prefix_cache()``: free-running (agreement reported, and
   where it parts, the eager logits of the two picks within the logit
   limit) and teacher-forced on the eager forward (greedy agreement
   held to its floor);
6a. preemption at full width and 16 of the 32 layers: an engine over
   the first 16 layers of the same weights on 48 pages (0.81 GB) for 10
   greedy requests of 768-1024
   prompt tokens and 128 new tokens (about 180 pages of full context):
   a warm-up and a timed pass as in phase 4 (the page audit after every
   warm-up step), then a third pass of the same traffic; at least one
   preemption and as many restores in each pass; every restored page
   read back bit-equal to its host blob (warm-up pass); offload and
   restore ms and GB/s, each synchronised, against a plain pinned
   ``copy_`` of the same bytes (third pass, so that the timed pass
   waits on neither); the tokens against
   the same requests on a 256-page engine of the same 16 layers, free-running (reported,
   with the logit gap where they part) and teacher-forced on its eager
   forward (greedy agreement held to its floor);
6b. the split step: phase 4's traffic on engines with
   ``fused_step=False`` and with ``on_device_sampling=False`` (the
   logits are sampled on the card outside the step, one call per
   parameter group, and only tokens reach the host), as phase 4 (logits
   keys captured in the warm-up pass, none in the timed pass, exact
   launch counts, every logits key's replay against its eager body:
   greedy picks bit-equal), the greedy requests' tokens teacher-forced
   through the fused engine (agreement held to its floor), decode step
   ms and busy share beside phase 4's;
6c. KV pool sizing: a Llama engine built with no ``kv_config``, its
   pool sized from free device memory (held to ``memory_fraction`` of
   it), serving phase 4's traffic once; then the same with
   ``speculative=True, spec_drafter="model"``, the target pool and the
   self-draft's pool held together to that budget;
6d. speculative decoding at full width and 16 of the 32 layers
   (``spec_max_draft=3``; 6e-6h also run the first 16 layers): the
   Llama-2-7B weights on 256 pages, phase 4's traffic with each prompt a
   seeded 32-token motif repeated to its length, on three engines:
   ``spec_drafter="ngram"``, ``"model"`` (the self-draft over all 16
   layers, a second pool) and ``"auto"`` (an 8-layer draft
   trunk).  The first two as phase 4 (a warm-up pass with the page audit
   after every step, a timed pass that captures nothing, launch counts
   held to the segments of the keys dispatched: a spec key L paged
   layers, a draft_spec key Q * L_draft + L, a draft_fill key L_draft;
   every spec and draft_spec verdict of a third pass bit-equal to its
   eager body) and four profiled steps; "auto" one pass with the audit.
   Each engine's greedy tokens, teacher-forced through a spec-off
   engine's eager forward, agree at or above the floor; the self-draft's
   accept rate is at or above SPEC_ACCEPT_MIN (derived beside it); the
   n-gram engine verifies drafted rows.  Drafted, accepted, tokens a
   dispatch, ms a dispatch and tokens/s after the prompts are reported
   beside phase 4's;
6e. keyed sampling at full width: the Llama-2-7B weights on 256 pages
   with ``keyed_sampling=True``, phase 4's prompts with 4 greedy and 6
   sampled requests (temperature 0.8; three with top_k=50, three with
   top_p=0.95), as phase 4 (a warm-up and a timed pass that captures
   nothing, exact launch counts, every key's replay bit-equal to its
   eager body, sampled rows included); the keyed draw of 4 recorded
   steps made on the card and on the CPU from the same fp32 logits and
   keys (row keys and random bits bit-equal, gumbel noise within 2 ulp,
   tokens equal except at near-ties within that noise, counted); the six
   sampled requests again with staggered submits (free-running against
   the timed pass reported; teacher-forced keyed agreement held to
   KEYED_AGREE_MIN, derived beside it); one profiled keyed decode step,
   the keyed draw's own device µs against the generator draw's, and
   decode ms and tokens/s beside phase 4's;
6f. snapshot and restore: the same weights on a 64-page keyed engine
   serve 2 greedy and 2 keyed-sampled requests (prompts 128-512, 64 new
   tokens) uninterrupted, then again with one ``snapshot(path)`` in a
   temporary directory once each has 16 tokens and ``restore(path)``
   into a fresh scheduler over a second engine: restored pages bit-equal
   to the bundle's, the resumed run's launch counts exact, tokens held
   against the uninterrupted run (free-running reported,
   teacher-forced keyed agreement held to its floor); bundle bytes and
   pages, snapshot, write, read and restore ms, write GB/s and the first
   token after the restore beside a pinned ``copy_`` of the page bytes;
6g. a mined bucket lattice: the same weights on 256 pages with phase 4's
   settings serve 10 requests (prompts of 1040-1100 and 300-340 tokens,
   64 new) as phase 4 with the workload trace on; the trace is mined into
   an artifact; a fresh engine under ``lattice="auto:<artifact>"``
   captures the lattice's keys, then serves the traffic as phase 4 (the
   timed pass captures nothing, launch counts exact); graphs, capture
   seconds, pool bytes, prompt tokens against prefill rows computed, TTFT,
   decode ms and the captures on the request path of both; the mined
   engine's greedy tokens teacher-forced through the power engine's eager
   forward (held to the floor);
6h. the host/disk page tier: the same weights on 48 pages with a 64-page
   host ring and 64 pages of disk files, two sequences at a time, 10
   greedy requests with distinct 1024-token prefixes and 64-token tails
   (32 new tokens) served twice on one scheduler (the second wave
   reversed), the page and tier audit after every step: every promoted
   page bit-equal to its device bytes at demotion, wave-2 hits from the
   host and the disk, wave-2 launch counts exact, wave-2 tokens
   teacher-forced (held to the floor); demote and promote ms a page, the
   disk's GB/s, the wait for demotion's copies against a pinned
   ``copy_``;
6i. graph warmth: a child process with ``DS_COMPILE_CACHE`` at phase 2's
   directory loads every kernel library it needs and builds none; the
   seconds from its start to its first token;
6j. a replica pool (16 of the 32 layers): the same weights on two
   engines of 256 pages behind
   ``serving.ReplicaPool`` (policy "affinity"), 16 greedy requests (8
   behind one 1024-token prefix with tails of 64-256 tokens, 8 cold of
   128-1024 tokens, 64 new): a warm-up pass, a timed pass with the step
   loop (every warm request after the first on the digest holder,
   nothing captured, launch counts exact over both replicas) and a
   threaded pass (``start`` / ``serve_until_idle``, nothing captured);
   then, with telemetry on, a page fetch (the fetched pages bit-equal to
   the holder's), a warm spawn, ``scale_down`` of a loaded replica and a
   death through the ``serving.preempt`` fault site (every committed
   prefix kept), the flight recorder's bundle written and read back;
   greedy agreement teacher-forced on one engine (held to the floor);
   TTFT and tokens/s beside phase 4's, migrate ms a request, page-fetch
   ms and GB/s against a pinned ``copy_``, the ``ds_pool_*`` counters;
6k. disaggregated prefill/decode: a ``role="prefill"`` and a
   ``role="decode"`` engine of 256 pages, keyed, one base key, behind
   ``serving.DisaggPool``; the decode engine captures its role lattice
   (``precompile(kinds=("decode", "chain"))``); phase 6e's traffic plus
   two requests sharing a 1024-token prefix: first tokens from the
   prefill engine, imported pages bit-equal to the exported blob, pages
   shared on the decode side, no Q>1 key on the decode engine and no
   chain or spec key on the prefill engine, nothing captured in the
   timed pass, launch counts exact; greedy and keyed agreement
   teacher-forced (held to the floor); TTFT, handoff ms a request and
   GB/s (cold and warm) against a pinned ``copy_``, decode ms and
   tokens/s beside phase 4's, graphs per role, the ``ds_disagg_*``
   counters;
6l. the fleet's subprocess mode: two replica processes
   (``python -m deepspeed_tpu_torch.tools.fleet_replica --model 7b``,
   spawned by ``fleetctl.ReplicaProc``), each Llama-2-7B at full width
   and depth in bf16 from phase 4's seed over 128 pages of 64 tokens,
   loading phase 2's libraries, serving two rounds of 8 greedy requests
   (4 on a 1024-token prefix with 64-256-token tails, 4 cold of
   128-1024 tokens, 64 new): seconds to ready and to the first token,
   decode ms, tokens/s and each kernel's launches per child (paged
   attention, RMSNorm and the flash forward > 0); each child's
   ``/snapshot?digests=1`` equal to its ``export_digests``, a warm
   request routed to the digest holder, the federated TTFT buckets the
   sum of the children's, ``ds_fleet_replicas_live`` 2, the ms of a
   scrape; a latency objective that must page and a capacity objective
   over the merged ring, each child's ``/memory`` breakdown; r1 again
   under ``DS_CHAOS="serving.preempt:at=40"``: exit 17, flagged stale
   within ``stale_after_s`` plus a scrape, the route stays on r0; then
   telemetry's cost in this process: phase 4's traffic in turns with
   telemetry off and on (watchdog, time series at 0.1 s, the ledger's
   tick, the metrics server scraped every 50 ms, also while the warm-up
   pass captures), decode ms and tokens/s, no capture in a timed pass;
7. the same weights with the registry pinned to the plain versions:
   ten teacher-forced serving steps of 3 requests on the eager forward
   (fresh prefill, decode, and two mixed steps, one with a Q=1024 prefill
   chunk over history, each segment its own ``put``), every segment's
   logits and greedy picks compared;
8. FastGen serving of OPT-6.7B at full width and depth (its published
   shape through ``opt_config_from_hf``: LayerNorm, learned positions,
   relu, biases; random seeded bf16 weights) over 256 int8 KV pages
   (``kv_quantization="int8"``), as phase 4, with exact launch counts:
   LayerNorm and the int8 paged kernel run, RMSNorm and the bf16 paged
   kernel do not;
8a. phase 6h's checks over OPT-6.7B's int8 pages (24 pages, an 8-page
   host ring, 16 pages of disk, 6 requests with 512-token prefixes);
9. the OPT weights on the plain path, both paths over int8 pages, the
   teacher-forced steps of phase 7, logits per segment compared; and the
   kernel path over bf16 pages, for the greedy agreement of int8 pages
   with bf16 pages;
9a. Mistral-7B-v0.1 at its published configuration (8 kv heads, a
   4096-token sliding window; ``llama_config_from_hf``, random seeded
   bf16 weights) at 16 of its 32 layers over 288 pages: four greedy requests of 6144-token
   prompts and 64 new tokens, whose full contexts need 388 pages, as
   phase 4 with the page audit after every warm-up step and each
   sequence's live pages held to ceil((4096 + 64) / 64) + 1 after every
   step; then the kernel path
   against the plain path, teacher-forced, over prefill chunks and
   decode steps past the window (evicted tables), logits compared;
9b. Falcon-7B at its published configuration (``falcon_config_from_hf``:
   head_dim 64, 71 query heads over one kv head, the parallel block;
   16 of its 32 layers, seeded random bf16 weights, norms and biases
   drawn) over
   256 pages of 64 tokens: ``serve`` as phase 4 (its multi-query decode
   folds 71 rows onto the tensor-core tile, so it has no split-KV
   segment), the kernel path against the plain path as phase 7; then
   the same weights over 256 int8 pages, as phases 8 and 9;
9c. Phi-2 (``phi_config_from_hf``: head_dim 80, partial rotary over 32
   lanes, the parallel block), 16 of its 32 layers, 256 bf16 pages, as
   9b;
9d. Phi-3-mini-4k-instruct (``phi3_config_from_hf``: head_dim 96, a
   2047-token window), 16 of its 32 layers, 256 bf16 pages, phase 4's
   traffic and two
   requests of 3072 + 64 tokens that cross the window, as 9b, and the
   kernel path against the plain path past the window as 9a (prompts of
   3072 in chunks of 1024); in each of 9b-9d both attention op classes
   must resolve to their kernels;
9e. Mixtral-8x7B at its published configuration
   (``mixtral_config_from_hf``: 8 experts, top-2, the MoE mlp self-wired
   in every layer; seeded random weights, 256 pages): (a) bf16 at 4 of
   32 layers, ``serve`` as phase 4 and the kernel path against the plain
   path as phase 7, the plain path routed to the kernel path's experts
   (``moe_routes``: a hard top-k turns rounding into another expert; the
   routes whose own choice differed are counted); (c) an engine
   quantising the same weights to fp8_e4m3 at build, the bf16 engine's
   greedy tokens teacher-forced through it (agreement reported, not
   held); (b) all 32 layers with fp8_e4m3 weights, drawn and quantised
   layer by layer so that the bf16 tree (93 GB) never exists, handed to
   an engine with ``quantization`` on: as (a), the dequantise kernel's
   launches held to 7 a layer of every segment, one decode step split
   into dequantisation, expert GEMMs, other GEMMs, attention, norms and
   the rest, weights GB and the phase's peak memory (held under 75 GB);
10. training at Llama-2-7B width cut to 8 layers (fp32 masters built on
    the card from a seed, bf16 compute, micro-batch 2 x 2048 tokens,
    gas 2, AdamW, WarmupDecayLR, clipping 1.0): 4 ``train_batch`` calls
    through ``deepspeed_tpu_torch.initialize`` on one fixed seeded batch,
    with every kernel's launch count read from a run that starts at zero;
11. the training path with the flash kernels against the plain einsum
    path from the same masters and micro-batch (loss and every leaf's
    gradient), then the AdamW kernel against its plain version on those
    gradients and the optimizer's state;
12. the same training at 2 of the 32 layers with Lion and ZeRO++
    quantised weights (stage 3,
    ``zero_quantized_weights``): launch counts exact (Lion once per leaf
    per step, quantise and dequantise once per leaf of two or more
    dimensions per step), then the engine's quantised compute tree
    against the plain versions' bit for bit, and one micro-batch's loss
    on it against the unquantised bf16 cast;
13. the same training at 2 layers with LAMB at stage 0, launch counts
    exact;
14. GPT-1.3B (``gpt_config("1.3b")``: learned positions, tied
    embeddings, D = 128) at full width and depth, 3 ``train_batch``
    calls (AdamW at lr 1e-4, bf16, micro-batch 2 x 2048, gas 2; norms
    and biases drawn) with exact launch counts (the flash forward twice a layer a
    micro-batch, dK/dV and dQ once, AdamW once a leaf a step, every
    other kernel idle), peak memory, one profiled step; then one
    right-padded micro-batch of a full row and a 1337-token row (the
    einsum path, no flash launch) against its rows unpadded (the flash
    kernels): loss and every leaf's gradient; and one micro-batch on the
    flash kernels against the plain einsum path, as 16;
15. Phi-2 (``phi_config_from_hf``: D = 80, partial rotary, the parallel
    block, an ``lm_head_bias`` leaf) at full width and depth, as 14,
    its peak held under 75 GB;
16. Falcon-7B (D = 64, 71 query heads over one kv head) at 4 of 32
    layers, and 17. Phi-3-mini-4k (D = 96, window 2047) at 8 of 32, two
    ``train_batch`` calls each with exact launch counts, then one
    micro-batch's loss and gradients on the flash kernels against the
    plain einsum path;
18. BERT-large masked LM (S = 512, 15% of the real tokens masked, rows
    right-padded, bidirectional: the einsum path) through
    ``initialize(training_data=...)`` and ``train_batch(data_iter=
    RepeatingLoader(loader))``: 4 steps, every sample read once in
    order, AdamW the only kernel;
19. checkpoints at Llama-2-7B width cut to 1 layer (0.46 B params,
    5.6 GB an AdamW checkpoint) in a fresh temporary directory that
    needs 20 GB free (the free space printed first): (a) 4
    ``train_batch`` calls straight through against 2, a save, a fresh
    engine's load and 2 more, with ``async_save`` off and on (the saving
    engine steps on while the writer runs): losses, masters and moments
    bit-equal; (b) ``ds_to_universal`` of that checkpoint loaded into a
    fresh engine with ``checkpoint.load_universal``, then the same 2
    steps, bit-equal, for AdamW, and for Lion (stage 3, qwZ) and LAMB
    with phases 12-13's configs; (c) ``get_fp32_state_dict_from_zero_
    checkpoint`` bit-equal to the saving engine's ``get_fp32_state_dict``,
    ``convert_zero_checkpoint_to_fp32_state_dict`` and
    ``save_16bit_model`` timed; (d) ``comm.collective_failure`` at call
    1 retries the same batch (losses and state bit-equal to the
    unfaulted run) and, on a 33.6 M-parameter MLP, ``ckpt.io_error`` at
    call 1 of a save is retried (``latest`` names the new tag) and at
    every call the save raises (``latest`` kept), ``train.nan_grad``
    rolls back to the checkpoint, then (its pointer cleared) to the host
    snapshot, masters and moments bit-equal to the last good state;
    save and load GB/s, the seconds from ``save()`` returning to
    ``latest``, the conversions, peak host and device memory, each
    beside the card line; launch counts per path;
20. training past the card's memory: (a) the host kernels (the port's
    copies of the C++ Adam in AdamW and L2 mode, Adagrad and Lion, built
    by ``ops/op_builder``) against their plain PyTorch versions on one
    4096x11008 fp32 leaf over 3 steps, host ms against the plain version,
    ``torch.optim``'s foreach step and the bound (the bytes a step moves
    over the host's peak memory rate, the fastest of streaming probes on
    every core; a kernel faster than its bound fails), and an
    ``AsyncIOHandle`` write and read of 1 GiB, bit-equal, MB/s, beside
    its bound (the bytes over the host's peak streaming rate) and one
    thread's ``os.pwrite`` / ``os.pread`` of the same bytes; (b) phase
    10's configuration at 4 layers on the device and with
    ``offload_optimizer`` cpu at ratio 1.0 and 0.5, and at 2 layers on
    the device, with nvme and
    with three planted faults (the host optimizer with a wrong beta2, no
    weight decay, L2 decay), 4 ``train_batch`` calls each: losses and
    ``get_fp32_state_dict()``'s masters within the offload limits of the
    device run's (each planted fault must fail them), losses falling,
    AdamW launched once per device leaf per step (never for an offloaded
    leaf), the step split (forward and backward, device to host, host
    step, host to device, NVMe wait), device and host state and peaks;
    (c) every remat policy at phase 10's configuration cut to 4 layers,
    each in an
    engine that ``initialize`` built from its config section (``tpu``
    or ``activation_checkpointing``, ``cpu_checkpointing`` twice): one
    micro-batch through ``engine.forward`` / ``backward``, loss and
    accumulated gradients bit-equal to ``nothing_saveable``'s, the bytes
    the forward leaves on the card (the ``offload_*`` policies fewer than
    the policies whose values they offload), flash forward launches, then
    one timed ``train_batch`` each, step ms and peak; (d) Llama-2-7B at
    full width and depth (6.74 B parameters, ZeRO-3, bf16 over fp32
    masters, micro 1 x 2048) with the optimizer offloaded, ratio 1.0 when
    the host has 92 GB available (else 0.9, said), 2 ``train_batch``
    calls in a child process that counts every kernel's launches: losses
    finite and falling, device peak under 75 GB, host peak RSS, step
    split, the host step against its bound, and tokens/s;
21. the rest of one-GPU training at Llama-2-7B width and 2 of 32 layers
    (0.667 B parameters), micro 2 x 2048, gas 2, each engine built by
    ``initialize`` from one seeded weight tree: first the pure-bf16
    instance of each optimizer kernel (bf16 p, fp32 g and moments) held
    to its plain version at one 4096 x 11008 leaf, with ms, bound, plain
    ms and (AdamW) ``torch.optim.AdamW(fused=True)`` over bf16
    parameters; (a) fp16 with the dynamic scale from ``2 ** 125``
    (hysteresis 2, window 4), telemetry and self-healing on, 16 or more
    ``train_batch`` calls on a fixed batch: the scale and hysteresis
    equal JAX's rule recomputed on the host from the overflow flags,
    masters, moments and counts bit-equal across every skip, AdamW once
    per leaf per applied step, ``ds_train_overflow_skip_total`` equal to
    the skips, no non-finite verdict and no rollback, the loss falling
    once the scale settles; (b) fp16 at a static scale of 1024 against
    the same run in bf16 (no skip, losses within 1e-3); (c) fp16 with
    ``offload_optimizer`` cpu at ratio 0.5: the host masters bit-equal
    across each skip; (d) the three non-default mixes of
    ``bf16.master_weights`` and ``accumulate_grads_in_fp32`` with AdamW,
    Lion and LAMB, 3 steps each: the instance for the dtypes launched
    once per leaf per step and no other, the loss falling, state bytes a
    parameter against both flags on; (e) SGD with momentum, Adagrad,
    coupled-L2 Adam, 1-bit Adam, 1-bit LAMB and 0/1 Adam, 3 steps each
    (the fused optimizer kernels idle, flash launched, the loss
    falling), Adafactor and Muon refused by the engine as by JAX's, and
    one update of real leaves of each of the eight on the card against
    the CPU's (three at ``freeze_step`` 2 for the 1-bit family); (f)
    ``set_lr``, a forced partial boundary equal to a gas-1 step,
    ``set_train_micro_batch_size`` / ``set_train_batch_size`` and
    ``destroy`` (device memory back under its value before the build);
    (g) Random-LTD's gather and scatter of a ``[2, 2048, 4096]`` bf16
    activation at keep 1024, bit-equal to the CPU's with the same
    indices, and the flops profiler at ``profile_step`` 1 within 2% of
    the analytic count (6 N + 6 L S E a token, plus remat's recompute);
22. the trace toolchain through ``deepspeed_tpu_torch.tools`` on
    ``tools/traces/sample_200.jsonl`` (16-token pages): (a)
    ``replay_trace.run_replay`` of its first 32 ok requests at Llama-2-7B
    width and depth in bf16 with the n-gram spec pass, its measured pass
    recorded into a private workload ledger: structural parity, every
    generated length exact, no capture in the measured pass, RMSNorm,
    paged attention (and its combine) and flash forward launches equal to
    what the dispatched keys imply, tokens/s, TTFT p50 / p99 and the
    accept rate; (b) at 8 layers over one weight tree, the fused keyed
    replay and the disaggregated replay with journeys: every token equal,
    no lost request, no orphan journey, handoff p50 ms; (c)
    ``run_tier_smoke`` with 4 device pages asked for, at 8 layers: every
    promoted page bit-equal to its device bytes at demotion, the store's
    audit clean, hits by tier, every disk read and write through the
    async I/O handle (plain-path count 0), promote-batch p50 ms; (d)
    ``analyze_trace.analyze`` over (a)'s ledger (the recommended keys
    cover every observed key), then ``plan_capacity.validate`` and
    ``oom_smoke`` at 2 layers through its command line in a child
    process loading phase 2's libraries (every ``ds_mem_*`` accountant
    readable, the residual within 10% of the card's measured bytes, the
    injected OOM's forensics); (e) ``fleetctl.run_pool_smoke`` with two replicas
    of 2 layers: every generated length exact, none lost;
23. the one-card public API: (a) ``initialize`` with
    ``hybrid_engine.enabled`` on GPT-1.3B at full width and depth (bf16,
    AdamW, micro-batch 4 x 512): greedy rollouts of 8 prompts of 64-256
    tokens, 32 new tokens each, then 3 ``train_batch`` steps, the
    rollouts again, one more step and one more rollout; after each
    refresh the rollouts equal a separately built ``init_inference``
    engine's over the same bf16 weights (a row that parts must part at a
    near-tie of that engine's top-two logits), the rollout weights are
    the masters' bf16 cast in the rollout model's own tensors (data
    pointers kept), no rollout after the first captures a graph; refresh
    s, rollout tokens/s, step ms, peak memory, the step's transient
    bytes that the first rollout measures (one forward and backward at 4
    x 2048 tokens) and holds back while it sizes the KV pool, launch
    counts (the serving kernels in the rollouts, that probe's flash
    backward in the first, the flash pair and AdamW in the steps); (b)
    ``init_inference`` on GPT-1.3B: ``forward``'s logits within
    LOGIT_REL_TOL of the einsum attention path, ``generate``'s first
    greedy token against ``forward``'s argmax but at near-ties, the
    ``max_out_tokens`` guard, fp16 served as bf16, and the serving
    forward on those weights, kernel path against plain path as phase 7
    (the paged kernel at H = K = 16, LayerNorm at E = 2048; phase 3
    checks LayerNorm at E = 2048 at the rollouts' row counts); (c)
    ``OptimizedLinear`` at Llama-2-7B's MLP shape (4096 -> 11008, int8
    base, LoRA rank 16):
    the quantise and dequantise kernels against their plain versions
    (codes and scales bit-equal, the forward within the kernel rows'
    tolerances), no gradient on the base, the merged weight; (d)
    ``sparse_gradients`` on GPT-1.3B at 4 layers against the dense
    embedding backward: the embedding gradient (``index_add_``'s atomics
    against the dense scatter), then 2 steps' losses and the embedding's
    update; (e) ``comm`` at one rank with the comms logger on and the CUDA
    accelerator's name and memory;
24. training across four rank processes that share the card: the
    parent runs the one-rank reference (Llama-2-7B width at 2 of 32
    layers, 0.67 B parameters, bf16 compute over fp32 masters, AdamW,
    2 steps of 4 rows x 1024 tokens) and starts ``chip_smoke.py
    --ranks-plan`` four times through ``deepspeed_tpu_torch.launcher.
    launch --num_gpus=4``; each rank joins over gloo, takes 0.21 of the
    card's memory, loads the libraries phase 2 built (no nvcc), probes
    gloo's all-reduce, and trains the same weights (from the seed) on
    its row of the same batch at ZeRO stages 0 (data 4), 2, 3 (fsdp
    4), hpZ (fsdp 2 x hpz 2), MiCS (data 2 x fsdp 2), stage 3 with qwZ,
    stage 2 with qgZ and stage 2 with ``comm_optimization`` (error
    feedback; stage 1 takes stage 2's path in the port); each run's
    losses, gradient norms, and each leaf's update norm, update and
    first moment projected on seeded random directions and second
    moment norm against the reference's (bf16 limits; the quantised
    runs within the int8 wire's limit), every rank's loss equal, each
    rank's launches exact
    (flash forward at least 2 L a micro-batch, dK/dV and dQ L, AdamW a
    leaf a step, qwZ's quantise and dequantise a two-dim leaf a step,
    the wire's 2 quantises and 2 + W dequantises a bucket), the state
    (masters and moments) one shard of fsdp x hpz of stage 0's, stage
    3's weights held, peak memory, step ms, and rank 0's first bucket
    through the quantise and dequantise kernels bit-equal to their
    plain versions; each run's launches summed over the ranks join the
    kernels line; then two planted faults in stage 2's gradient
    reduction (a mean where the engine sums; one rank keeping its own
    gradient), each of which must fail a check that sees the gradient;
25. tensor and sequence parallelism in the same four rank processes,
    held against phase 24's one-rank reference (the same weights and
    global batch) with phase 24's checks and limits (the update
    directions' set from phase 25's own readings): ``tp2_sp2``
    (tensor 2 x seq 2, Ulysses, stage 1: 8 heads a rank at S = 1024
    through the flash kernels), ``tp2_sp2_ring`` (the same mesh, ring
    attention: seq rank s runs the flash pair on its s + 1 visible
    blocks), ``tp2_fsdp2`` (tensor 2 x fsdp 2, stage 3) and ``tp4``
    (tensor 4: 8 heads, F 2752 and a vocab shard of 8000 a rank); each
    run's step ms, the bytes a step moved over ``tensor``, over ``seq``
    and in the gradient reduction (the comms logger), peak memory a rank
    and the state against its tensor-and-ZeRO share; then the planted
    faults: a row-parallel output left unsummed over tensor in each of
    the four runs, and seq rank 1's gradient left out of the seq sum in
    the tensor 2 x seq 2 run, each of which must fail a check that sees
    the gradient.  Phase
    3 holds the flash pair at the head-sharded shape (B = 4, H = 8, S =
    1024, D = 128);
26. a ``{"kernels": [...]}`` JSON line (the flash backward at D = 64,
    80 and 96 and the optimizers' bf16 instances in rows of their own),
    the card line, and last the ``{"ok": true, "device": {...}}``
    line.

Without a GPU, or outside the repository, it exits non-zero before
printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor core
FP32_FLOPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores
SEED = 0

# Kernel vs plain version, bf16 outputs, each case held against the
# scale of its own reference (attention outputs over N(0,1) keys at
# contexts of 10^3 are ~0.05, so an absolute limit would be as large as
# the values).  The attention kernels and the plain versions both round
# P to bf16 before P . V, the kernels unnormalised (dividing by the fp32
# sum at the end), the plain versions after the softmax; over int8 pages
# the tensor-core path rounds p * v_scale to bf16 and the decode path
# keeps p and V in fp32.  On the CPU stand-ins (tests/test_torch_kernels
# .py, the decode shape at contexts up to 2048) that rounding measures
# rms 3.3e-3..5.2e-3 and max <= 5.7e-3 of max|ref|, while one key too
# many moves the rms by 2.3e-2 or more.
#   rms_rel = rms(kernel - plain) / rms(plain)
#   max_rel = max|kernel - plain| / max|plain|
RMS_REL_TOL = 1e-2
MAX_REL_TOL = 2.5e-2
# full-width kernel vs plain path: max |logit difference| over the
# largest |logit| of the segment (32 layers of bf16 rounding differences)
LOGIT_REL_TOL = 5e-2
# greedy picks that agree between the two paths: bf16 rounding flips
# only near-tied argmaxes (a wrong kernel also fails the logit check)
GREEDY_AGREE_MIN = 0.75
# Over int8 pages the two paths also quantise at append from K and V that
# differ by rounding, so a code may flip.  CPU stand-in (tests/
# test_torch_families.py::test_int8_serving_limits_pass_rounding_and_fail_
# a_wrong_scale, a bf16 OPT at E = 128, with the decode path's fp32 p and
# V on decode segments and the tile's bf16(p * v_scale) against the codes
# on prefill chunks): rounding gives 1.09e-2 of the largest logit at 2
# layers and 1.12e-2 at 8, scales read from the neighbouring kv head 0.37
# to 0.51.
# The int8 phase is held to about 3x
# the stand-in's largest reading; greedy picks over int8 pages are held to
# the same floor against bf16 pages (the JAX suite's own agreement bound
# for int8 pages).  Neither limit sees one key past the causal limit at
# this level: phase 3's per-kernel cases hold that.
INT8_LOGIT_REL_TOL = 3e-2

# facebook/opt-6.7b config.json, the fields opt_config_from_hf reads
OPT_6_7B = dict(vocab_size=50272, hidden_size=4096, ffn_dim=16384,
                num_hidden_layers=32, num_attention_heads=32,
                max_position_embeddings=2048, activation_function="relu",
                do_layer_norm_before=True, word_embed_proj_dim=4096,
                tie_word_embeddings=True)
PLAIN_PATH = {"norm": "plain", "ragged_attention": "dense_gather",
              "fresh_prefill_attention": "mha_reference"}
# AdamW, Lion and LAMB kernels vs plain versions, all fp32: max |delta| /
# max |ref| of p, m, v (LAMB: of u, m, v) (fused multiply-adds and the
# order of a division move a value by an ulp or two, 1.2e-7 each).
# Lion's signs must agree on every element.  LAMB's sums of p^2 and u^2
# (fp64 partials per CTA in the kernel, fp32 sums in the plain version)
# within LAMB_NORM_REL_TOL, and p after the trust-ratio step within
# LAMB_P_MAX_REL_TOL of max |p|.
OPT_MAX_REL_TOL = 1e-6
LAMB_NORM_REL_TOL = 1e-5
LAMB_P_MAX_REL_TOL = 1e-5
# full-width training, flash kernels vs the plain einsum path, one
# micro-batch from the same masters: |delta loss| / loss, and each leaf's
# rms(grad delta) / rms(grad).  CPU stand-in (tests/
# test_torch_training_ops.py::test_training_parity_limits_pass_rounding_
# and_fail_an_extra_key, a bf16 llama at E = 128, the plain flash path
# against the einsum path): rounding alone gives loss 7.6e-6..2.2e-4 and
# gradients 1.7e-2 at 2 layers, 2.8e-2 at 8, while attending one key
# past the causal limit moves the gradients by 0.42..0.89 (the loss by
# 1.6e-3..3.3e-3).
LOSS_REL_TOL = 1e-3
GRAD_RMS_REL_TOL = 5e-2
# qwZ: one micro-batch's loss on the quantised compute tree against the
# plain bf16 cast of the same masters, 0 < |delta loss| / loss <= this.
# CPU stand-in (tests/test_torch_quantization.py::test_qwz_loss_limit_
# passes_rounding_and_fails_faults, a bf16 llama at E = 128): the int8
# grid moves the loss by 5.7e-4 at 2 layers and 2.8e-4 at 8, a skipped
# quantisation by 0, scales twice too large by 0.21-0.22.
QWZ_LOSS_REL_TOL = 1e-2

# the training phase: Llama-2-7B width, depth cut to 8 of 32 layers so
# fp32 masters, Adam moments and the fp32 gradient sum fit one card
TRAIN_LAYERS = 8
TRAIN_SEQ = 2048
TRAIN_MICRO = 2
TRAIN_GAS = 2
TRAIN_STEPS = 4
TRAIN_CONFIG = {
    "train_micro_batch_size_per_gpu": TRAIN_MICRO,
    "gradient_accumulation_steps": TRAIN_GAS,
    "bf16": {"enabled": True},
    "gradient_clipping": 1.0,
    "optimizer": {"type": "adamw",
                  "params": {"lr": 3e-4, "betas": [0.9, 0.95],
                             "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupDecayLR",
                  "params": {"warmup_min_lr": 3e-5, "warmup_num_steps": 2,
                             "total_num_steps": 100}},
}


def _warmup_decay(min_lr):
    return {"type": "WarmupDecayLR",
            "params": {"warmup_min_lr": min_lr, "warmup_num_steps": 2,
                       "total_num_steps": 100}}


# the training paths: AdamW at stage 0; Lion at ZeRO stage 3 with
# quantised weights (lr 1e-4, a third of AdamW's as usual for Lion: at
# 3e-4 every weight moves by the full lr each step and the loss rose on
# the third step on the card before falling); LAMB at stage 0 (lr 1e-2:
# LAMB moves each leaf by lr * ||p||, i.e. ~1.6e-4 per weight of std
# 0.0156 at lr 1e-2, where AdamW moves it by 3e-4)
TRAIN_PATHS = {
    "training": TRAIN_CONFIG,
    "training_lion_qwz": dict(
        TRAIN_CONFIG,
        optimizer={"type": "lion",
                   "params": {"lr": 1e-4, "betas": [0.9, 0.99],
                              "weight_decay": 0.1}},
        scheduler=_warmup_decay(1e-5),
        zero_optimization={"stage": 3, "zero_quantized_weights": True}),
    "training_lamb": dict(
        TRAIN_CONFIG,
        optimizer={"type": "lamb",
                   "params": {"lr": 1e-2, "betas": [0.9, 0.999],
                              "weight_decay": 0.01}},
        scheduler=_warmup_decay(1e-3)),
}
# phases 12 and 13 (Lion + qwZ, LAMB) at 2 of 32 layers: every kernel of
# theirs launches as at 8 (the launches per leaf do not depend on depth)
OPTIMIZER_PATH_LAYERS = 2
# the optimizer kernel each training path runs
PATH_OPTIMIZER = {"training": "fused_adamw", "training_lion_qwz": "fused_lion",
                  "training_lamb": "fused_lamb"}

# phases 14-18, the families' training: (label, path, preset or published
# config, layers kept (None: all), micro-batch, train_batch calls, seed).
# AdamW as phase 10 but at lr 1e-4 (AdamW's first steps move every weight
# by about lr: at phase 10's 3e-4 Phi-2's loss rose on the fourth step on
# the card, 10.39 to 12.52, on its fixed batch), gas 2, S = 2048.
# Falcon-7B and Phi-3-mini at full depth (7.2 B and 3.8 B parameters) need
# 20 bytes a parameter before activations (fp32 masters, gradient sum and
# Adam moments, the bf16 compute copy and its gradient: 144 and 76 GB), more
# than one card, so they keep 4 and 8 of 32 layers; GPT-1.3B and Phi-2
# train at full depth, Phi-2 (2.8 B: 55.6 GB) at micro-batch 2, its peak
# held under FAMILY_PEAK_GB
FAMILY_PATHS = (
    ("GPT-1.3B", "training_gpt_1.3b", "gpt 1.3b", None, 2, 3, SEED + 31),
    ("Phi-2", "training_phi2", "microsoft/phi-2", None, 2, 3, SEED + 33),
    ("Falcon-7B", "training_falcon_7b", "tiiuae/falcon-7b", 4, 2, 2,
     SEED + 35),
    ("Phi-3-mini-4k", "training_phi3_mini", "microsoft/Phi-3-mini-4k-instruct",
     8, 2, 2, SEED + 37))
FAMILY_TRAIN_CONFIG = dict(
    TRAIN_CONFIG,
    optimizer={"type": "adamw",
               "params": {"lr": 1e-4, "betas": [0.9, 0.95],
                          "weight_decay": 0.1}},
    scheduler=_warmup_decay(1e-5))
FAMILY_PEAK_GB = 75.0
# the right-padded micro-batch of GPT-1.3B's and Phi-2's phases: a full row
# and one of PADDED_SHORT tokens
PADDED_SHORT = 1337
# BERT-large masked LM (phase 18): S = 512, 15% of the real tokens masked,
# rows right-padded to lengths drawn from [128, 512], through
# initialize(training_data=...) and train_batch(data_iter=...)
BERT_SEQ = 512
BERT_MICRO = 16
BERT_STEPS = 4
BERT_MASK_RATE = 0.15


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls: int = 1000) -> float:
    """Host time per call of ``fn``: a host clock around ``calls`` calls
    after a ``synchronize()``, with none inside the loop (the enqueue
    cost; once the launch queue fills, which happens when a call's
    kernels outlast its enqueue, it reads the device's time instead)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt * 1e6 / calls


def device_us(fn, calls: int = 200, sessions: int = 4):
    """(device us per call, kernels recorded per call) of ``fn``, from
    the CUDA kernels torch.profiler records over ``calls`` calls (the
    source ``device_ms_by_kind`` reads): each kernel name's mean duration
    times its launches per call, summed.  The profiler sometimes drops
    records (one session of 200 calls kept none, one kept 45% of a
    kernel's), so a session that recorded some name fewer than ``calls``
    times is run again, up to ``sessions`` in all; the last session that
    recorded anything counts each of its names at least once a call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    kept = None
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                by_name.setdefault(ev.name, []).append(
                    ev.time_range.elapsed_us())
        if by_name:
            kept = by_name
            if min(map(len, by_name.values())) >= calls:
                break
    if kept is None:
        raise RuntimeError(f"torch.profiler recorded no device kernel in "
                           f"{sessions} sessions")
    us = sum(sum(t) / len(t) * max(1, round(len(t) / calls))
             for t in kept.values())
    return us, sum(map(len, kept.values())) / calls


SPLIT_KEYS = ("host_us", "host_us_blocks", "device_us", "kernels_per_call",
              "library_host_us", "library_host_us_blocks",
              "library_device_us", "library_kernels_per_call")
HOST_BLOCKS = 5


def split_times(kernel, library) -> dict:
    """Host and device time per call of a kernel's wrapper and of its
    library call.  ``host_us`` is the median of ``HOST_BLOCKS`` blocks
    of :func:`host_us`, the two calls' blocks alternating (the host's
    clock swings between blocks on a shared machine); ``device_us`` and
    the kernels per call come from :func:`device_us`."""
    fns = {"": kernel, "library_": library}
    blocks = {prefix: [] for prefix in fns}
    for i in range(HOST_BLOCKS):
        for prefix in (fns if i % 2 == 0 else list(fns)[::-1]):
            blocks[prefix].append(host_us(fns[prefix]))
    out = {}
    for prefix, fn in fns.items():
        us, per_call = device_us(fn)
        out.update({f"{prefix}host_us": statistics.median(blocks[prefix]),
                    f"{prefix}host_us_blocks": blocks[prefix],
                    f"{prefix}device_us": us,
                    f"{prefix}kernels_per_call": per_call})
    return out


def norm_host_parts(x, vectors, launch) -> dict:
    """Host us per call of each step of a norm wrapper on ``x`` (the
    median of ``HOST_BLOCKS`` blocks of :func:`host_us` each): the
    operand checks, the output's allocation, the stream handle, and the
    launch through the bound C entry point (``cudaLaunchKernel`` and
    the error check included; ``launch`` is a prepared call)."""
    import torch
    from deepspeed_tpu_torch.ops import kernel_loader
    from deepspeed_tpu_torch.ops import normalization as N
    e = x.shape[-1]
    parts = {"checks": lambda: N._takes(x, e, vectors),
             "allocation": lambda: torch.empty_like(x),
             "stream": lambda: kernel_loader.stream_of(x),
             "launch": launch}
    return {name: statistics.median(host_us(fn) for _ in range(HOST_BLOCKS))
            for name, fn in parts.items()}


def bound(n_bytes: float, n_flops: float,
          flops_per_s: float = BF16_FLOPS_PER_S):
    t_b, t_f = n_bytes / HBM_BYTES_PER_S, n_flops / flops_per_s
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def parity(out, ref) -> dict:
    """Absolute and reference-relative errors of ``out`` against
    ``ref``."""
    out, ref = out.float(), ref.float()
    d = out - ref
    return dict(max_abs_err=float(d.abs().max()),
                max_rel_err=float(d.abs().max() / ref.abs().max()),
                rms_rel_err=float(d.pow(2).mean().sqrt()
                                  / ref.pow(2).mean().sqrt()))


def ptxas_kernels(build_log: str, nvcc: str) -> dict:
    """Registers, stack and spills of each kernel in an ``nvcc -Xptxas -v``
    log, by name: the entry symbol as ``cu++filt -p`` (beside ``nvcc``)
    demangles it, or as ptxas prints it where there is no ``cu++filt``."""
    import re
    import subprocess
    from pathlib import Path
    symbols = re.findall(r"Compiling entry function '([^']+)'", build_log)
    filt = Path(nvcc).with_name("cu++filt")
    names = dict(zip(symbols, symbols))
    if symbols and filt.exists():
        names = dict(zip(symbols, subprocess.run(
            [str(filt), "-p", *symbols], capture_output=True, text=True,
            check=True).stdout.splitlines()))
    out, name = {}, None
    for ln in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = names[m.group(1)]
            out[name] = dict(registers=0, stack=0, spill_stores=0,
                             spill_loads=0)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def _bf16_entries(kernel) -> tuple:
    """An optimizer kernel's instances over bf16 operands (every entry
    point but the all-fp32 one)."""
    return tuple(fn for fn in kernel.functions if "bf16" in fn)


def kernel_counters() -> dict:
    """Every hand-written kernel of the main paths: name -> (its
    library, its C entry points where the source holds more than one
    kernel, or None).  Shared with the full-depth child process."""
    from deepspeed_tpu_torch.ops import flash_attention as FA
    from deepspeed_tpu_torch.ops import fp_quantizer as FQ
    from deepspeed_tpu_torch.ops import fused_optimizer as FO
    from deepspeed_tpu_torch.ops import normalization as N
    from deepspeed_tpu_torch.ops import paged_attention as PA
    from deepspeed_tpu_torch.ops import quantization as Q
    # (the paged kernel's decode path is two launches: the split-KV kernel,
    # counted under the page format's name, and the combine)
    return {
        "paged_attention": (PA.KERNEL, ("paged_attention_bf16",)),
        "paged_attention_int8": (PA.KERNEL, ("paged_attention_int8",)),
        "paged_attention_combine": (PA.KERNEL, ("paged_attention_combine",)),
        "rmsnorm": (N.KERNEL, ("rmsnorm_bf16",)),
        "rmsnorm_res": (N.KERNEL, ("rmsnorm_res_bf16",)),
        "layernorm": (N.LN_KERNEL, None),
        "flash_fwd": (FA.KERNEL, None),
        "flash_bwd": (FA.BWD_KERNEL, None),
        "flash_bwd_dkv": (FA.BWD_KERNEL, ("flash_bwd_dkv_bf16",)),
        "flash_bwd_dq": (FA.BWD_KERNEL, ("flash_bwd_dq_bf16",)),
        "fused_adamw": (FO.KERNEL, ("fused_adamw_f32",)),
        "fused_adamw_bf16": (FO.KERNEL, _bf16_entries(FO.KERNEL)),
        "quantize": (Q.KERNEL, ("quantize_blockwise_f32",)),
        "dequantize": (Q.KERNEL, ("dequantize_blockwise_f32",
                                  "dequantize_blockwise_bf16")),
        "fused_lion": (FO.LION_KERNEL, ("fused_lion_f32",)),
        "fused_lion_bf16": (FO.LION_KERNEL, _bf16_entries(FO.LION_KERNEL)),
        "fused_lamb": (FO.LAMB_KERNEL, ("fused_lamb_stage1_f32",)),
        "fused_lamb_bf16": (FO.LAMB_KERNEL, _bf16_entries(FO.LAMB_KERNEL)),
        "fp_dequant": (FQ.KERNEL, None)}


def read_launches(counters) -> dict:
    """Launches of each hand-written kernel since the counts were last
    set to 0.  ``counters``: name -> (CudaKernel, the C entry points that
    are this kernel, or None for every entry point of the source)."""
    return {name: (k.launches if fns is None
                   else sum(k.launches_by_fn[fn] for fn in fns))
            for name, (k, fns) in counters.items()}


def reset_launches(counters) -> None:
    for k, _ in counters.values():
        k.reset_counts()


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions
# ---------------------------------------------------------------------------

def _norm_inputs(dev, g, n, e=4096):
    import torch
    x = torch.randn(n, e, generator=g, device=dev, dtype=torch.bfloat16)
    w = torch.rand(e, generator=g, device=dev) + 0.5
    b = 0.1 * torch.randn(e, generator=g, device=dev)
    return x, w, b


# the hidden widths of the serving phases' norms and the row counts their
# steps give them (checked and timed by CUDA events; the host/device split
# stays at E = 4096, which keeps the smoke inside its time).  Phases
# 9b-9d: decode steps of 10 (9b, 9c) and 12 (9d) rows, 16 rows, prefill
# steps of up to 2048 rows, and a full 4096-row budget.  Phase 23's
# GPT-1.3B: the rollouts' decode step of 8 rows, one prompt of 64 or 256
# rows, (b)'s two 256-token prompts, and a full step of the rollout
# engine's 768-token budget
FAMILY_NORM_ROWS = (10, 12, 16, 2048, 4096)
GPT_NORM_ROWS = (8, 64, 256, 512, 768)
LAYERNORM_WIDTHS = {4544: ("Falcon-7B", FAMILY_NORM_ROWS),
                    2560: ("Phi-2", FAMILY_NORM_ROWS),
                    2048: ("GPT-1.3B", GPT_NORM_ROWS)}
RMSNORM_WIDTHS = {3072: "Phi-3-mini-4k"}


def check_layernorm(dev, mined_q=()):
    """N=16: the serving decode step's rows; N=4096: a full prefill
    budget.  The third case's rows have a mean (1000) far above their
    spread, where a one-pass variance would cancel.  Then N = 2 * Q for
    each mined Q top (two prompts' rows at a mined bucket), and the
    widths of phases 9b-9d (E=4544 is no multiple of 128) and of phase
    23 (E=2048) at their rows."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import normalization as N
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    rows = []
    cases = ((16, 0.0, 4096, ""), (4096, 0.0, 4096, ""),
             (4096, 1000.0, 4096, "")) + tuple(
        (2 * q, 0.0, 4096, " (mined Q)") for q in mined_q) + tuple(
        (n, 0.0, e, f" ({model})")
        for e, (model, ns) in LAYERNORM_WIDTHS.items() for n in ns)
    for n, mean, e, tag in cases:
        x, w, b = _norm_inputs(dev, g, n, e)
        if mean:
            x = (mean + 0.85 * x.float()).bfloat16()
        err = parity(N.layernorm(x, w, b, 1e-5),
                     N.layernorm_reference(x, w, b, 1e-5))
        wb, bb = w.bfloat16(), b.bfloat16()
        b_ms, b_by = bound(2 * n * e * 2 + 2 * e * 4, 8 * n * e)
        rows.append(dict(
            shape=f"N={n} E={e}" + (f" row mean {mean:g}" if mean else "")
            + tag,
            **err,
            ms=cuda_ms(lambda: N.layernorm(x, w, b, 1e-5), 200),
            plain_ms=cuda_ms(lambda: N.layernorm_reference(x, w, b, 1e-5),
                             50),
            library_ms=cuda_ms(lambda: F.layer_norm(x, (e,), wb, bb, 1e-5),
                               200),
            bound_ms=b_ms, bound_by=b_by,
            **(split_times(lambda: N.layernorm(x, w, b, 1e-5),
                           lambda: F.layer_norm(x, (e,), wb, bb, 1e-5))
               if e == 4096 else {})))
        if (n, e) == (16, 4096):
            out, stream = torch.empty_like(x), torch.cuda.current_stream()
            rows[-1]["host_parts_us"] = norm_host_parts(x, (w, b), lambda: (
                N.LN_KERNEL.launch("layernorm_bf16", x.data_ptr(),
                                   w.data_ptr(), b.data_ptr(),
                                   out.data_ptr(), n, e, 1e-5,
                                   stream.cuda_stream)))
    return rows


def check_rmsnorm_res(dev):
    """The fused residual form: both outputs against the plain version
    (the new residual bit for bit); library yardstick: an add, then
    ``F.rms_norm`` (two calls)."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import normalization as N
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    rows = []
    for n in (16, 4096):
        x, w, _ = _norm_inputs(dev, g, n)
        r, _, _ = _norm_inputs(dev, g, n)
        e = x.shape[1]
        out, res = N.rmsnorm(x, w, 1e-5, residual=r)
        ref_out, ref_res = N.rmsnorm_res_reference(x, r, w, 1e-5)
        if not torch.equal(res, ref_res):
            raise RuntimeError("rmsnorm_res: the new residual is not "
                               "bf16(x + residual)")
        err = parity(out, ref_out)
        wb = w.bfloat16()
        b_ms, b_by = bound(4 * n * e * 2 + e * 4, 5 * n * e)
        rows.append(dict(
            shape=f"N={n} E={e}", **err,
            ms=cuda_ms(lambda: N.rmsnorm(x, w, 1e-5, residual=r), 200),
            plain_ms=cuda_ms(lambda: N.rmsnorm_res_reference(x, r, w, 1e-5),
                             50),
            library_ms=cuda_ms(lambda: F.rms_norm(x + r, (e,), wb, 1e-5),
                               200),
            bound_ms=b_ms, bound_by=b_by,
            **split_times(lambda: N.rmsnorm(x, w, 1e-5, residual=r),
                          lambda: F.rms_norm(x + r, (e,), wb, 1e-5))))
    return rows


def check_rmsnorm(dev, mined_q=()):
    """N=8: the Llama serving decode step's rows (first: the main path's
    shape); N=1: one request decoding; N=16: the OPT decode step's row
    count; N=1024 and N=4096: prefill chunks; N = 2 * Q for each mined Q
    top; then the widths of phases 9b-9d at their rows."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import normalization as N
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    cases = tuple((n, 4096, "") for n in (8, 1, 16, 1024, 4096)) + tuple(
        (2 * q, 4096, " (mined Q)") for q in mined_q) + tuple(
        (n, e, f" ({model})") for e, model in RMSNORM_WIDTHS.items()
        for n in FAMILY_NORM_ROWS)
    for n, e, tag in cases:
        x = torch.randn(n, e, generator=g, device=dev, dtype=torch.bfloat16)
        w = torch.rand(e, generator=g, device=dev) + 0.5
        err = parity(N.rmsnorm(x, w, 1e-5), N.rmsnorm_reference(x, w, 1e-5))
        wb = w.bfloat16()
        b_ms, b_by = bound(2 * n * e * 2 + e * 4, 4 * n * e)
        rows.append(dict(
            shape=f"N={n} E={e}" + tag,
            **err,
            ms=cuda_ms(lambda: N.rmsnorm(x, w, 1e-5), 200),
            plain_ms=cuda_ms(lambda: N.rmsnorm_reference(x, w, 1e-5), 50),
            library_ms=cuda_ms(lambda: F.rms_norm(x, (e,), wb, 1e-5), 200),
            bound_ms=b_ms, bound_by=b_by,
            **(split_times(lambda: N.rmsnorm(x, w, 1e-5),
                           lambda: F.rms_norm(x, (e,), wb, 1e-5))
               if e == 4096 else {})))
        if (n, e) == (8, 4096):
            out, stream = torch.empty_like(x), torch.cuda.current_stream()
            rows[-1]["host_parts_us"] = norm_host_parts(x, (w,), lambda: (
                N.KERNEL.launch("rmsnorm_bf16", x.data_ptr(), w.data_ptr(),
                                out.data_ptr(), n, e, 1e-5,
                                stream.cuda_stream)))
    return rows


def _paged_inputs(dev, S, Q, H, K, ctx_max, g, page=64, D=128):
    import torch
    P = ctx_max // page
    n_pages = S * P
    kv = torch.randn(n_pages + 1, page, 2, K, D, generator=g, device=dev,
                     dtype=torch.bfloat16)
    perm = torch.randperm(n_pages, generator=g, device=dev) + 1
    table = perm.reshape(S, P).to(torch.int32).contiguous()
    # at least 128 tokens of history (a short context: half of it)
    start = torch.randint(min(128, (ctx_max - Q) // 2), ctx_max - Q + 1,
                          (S,), generator=g, device=dev, dtype=torch.int32)
    q = torch.randn(S, Q, H, D, generator=g, device=dev,
                    dtype=torch.bfloat16)
    return q, kv, table, start


def _sdpa_paged(q, kv, table, start, slopes, window):
    """Library yardstick: scaled_dot_product_attention over the slot's
    context gathered into dense [S, H, C, D] (gather done outside).  Over
    int8 pages it is two calls: dequantise the gathered codes to bf16,
    then scaled_dot_product_attention."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import paged_attention as PA
    S, Q, H, D = q.shape
    page, K = kv.shape[1], kv.shape[3]
    C = table.shape[1] * page

    def split(pages):
        return (pages[..., 0, :, :].reshape(S, C, K, D).transpose(1, 2),
                pages[..., 1, :, :].reshape(S, C, K, D).transpose(1, 2))

    pos = start[:, None].long() + torch.arange(Q, device=q.device)
    ctx = torch.arange(C, device=q.device)
    keep = ctx[None, None, :] <= pos[:, :, None]
    if window:
        keep &= ctx[None, None, :] > pos[:, :, None] - window
    mask = torch.where(keep, 0.0, -math.inf)[:, None].to(q.dtype)
    if slopes is not None:
        mask = mask + (slopes[None, :, None, None]
                       * ctx.float()).to(q.dtype)
    qt = q.transpose(1, 2)
    if isinstance(kv, PA.KVPages):
        codes, scales = kv.payload[table.long()], kv.scale[table.long()]

        def run():
            k, v = split(PA.dequantize_kv_blocks(codes, scales, q.dtype))
            return F.scaled_dot_product_attention(
                qt, k, v, attn_mask=mask, enable_gqa=K != H)
        return run
    k, v = split(kv[table.long()])
    return lambda: F.scaled_dot_product_attention(
        qt, k, v, attn_mask=mask, enable_gqa=K != H)


def check_paged(dev, int8=False, mined_q=()):
    """The paged kernel over bf16 pages or, with ``int8``, over int8
    codes with per-(token, kv head) scales quantised from the same
    N(0, 1) pages; also two slots' continued prefill chunks at each
    mined Q top (neither a multiple of 64 nor of the tile's 16-row
    block), and the head dims of phases 9b-9d: at D = 64, 80 and 96 a
    decode on the split-KV path (H = K = 32), Falcon-7B's multi-query
    decode (H = 71, K = 1: 71 folded rows, the tile), a prefill chunk
    (Falcon's heads at D = 64), and at D = 96 Phi-3-mini's 2047-token
    window over contexts of 4096 (a decode and a chunk); and the trace
    replay's geometry (phase 22): 16-token pages over contexts of 128, a
    decode of 32 slots and a 64-token chunk of 16 (bf16; the decode over
    int8 pages too)."""
    import torch
    from deepspeed_tpu_torch.models.transformer import alibi_slopes
    from deepspeed_tpu_torch.ops import paged_attention as PA
    g = torch.Generator(device=dev).manual_seed(SEED)
    # the serving run's decode steps carry 16 slots and its mixed steps
    # Q=1024-bucket prefill chunks over up to 1024 tokens of history; one
    # slot at a full 2048-token context takes the most decode splits
    cases = [("serving decode", 16, 1, 32, 32, None, False),
             ("decode", 8, 1, 32, 32, None, False),
             ("prefill chunk", 8, 64, 32, 32, None, False),
             ("serving prefill chunk", 4, 1024, 32, 32, None, False),
             ("GQA decode", 8, 1, 32, 8, None, False),
             ("window decode", 8, 1, 32, 32, 512, False),
             ("ALiBi decode", 8, 1, 32, 32, None, True),
             ("single-slot decode", 1, 1, 32, 32, None, False),
             ("GQA prefill chunk", 4, 1024, 32, 8, None, False),
             # the speculative verify (Q = 1 + spec_max_draft): Llama's 4
             # folded rows take the split-KV path with a causal limit a
             # row; Mistral's 16 (G = 4) the tile, at contexts past its
             # window
             ("spec verify", 16, 4, 32, 32, None, False),
             ("Mistral spec verify", 16, 4, 32, 8, 4096, False)]
    cases += [(f"mined prefill chunk Q={q}", 2, q, 32, 32, None, False)
              for q in mined_q]
    cases = [c + (128,) for c in cases]
    for d in HEAD_DIM_MODELS:
        chunk_heads = (71, 1) if d == 64 else (32, 32)
        cases += [(f"D={d} decode", 16, 1, 32, 32, None, False, d),
                  (f"D={d} MQA decode", 16, 1, 71, 1, None, False, d),
                  (f"D={d} prefill chunk", 4, 1024, *chunk_heads, None,
                   False, d)]
    cases += [("D=96 window decode", 16, 1, 32, 32, 2047, False, 96),
              ("D=96 window chunk", 2, 1024, 32, 32, 2047, False, 96),
              ("page-16 decode", 32, 1, 32, 32, None, False, 128),
              ("page-16 prefill chunk", 16, 64, 32, 32, None, False, 128)]
    ctx_of = {"Mistral spec verify": 8192, "D=96 window decode": 4096,
              "D=96 window chunk": 4096, "page-16 decode": 128,
              "page-16 prefill chunk": 128}
    page_of = {"page-16 decode": 16, "page-16 prefill chunk": 16}
    # the int8 cases quantise the very pages, tables and positions of the
    # bf16 cases (every case draws, fewer run)
    skip = (("decode", "prefill chunk", "page-16 prefill chunk") if int8
            else ())
    rows = []
    for name, S, Q, H, K, window, alibi, D in cases:
        # bytes a context token takes per kv head: K and V rows of D values
        token_bytes = 2 * (D + 4) if int8 else 2 * D * 2
        ctx = ctx_of.get(name, 2048)
        page = page_of.get(name, 64)
        q, kv, table, start = _paged_inputs(dev, S, Q, H, K, ctx, g,
                                            page=page, D=D)
        if name in skip:
            continue
        if name == "single-slot decode":
            start.fill_(2047)
        if int8:
            kv = PA.KVPages(*PA.quantize_kv_blocks(kv))
        slopes = (torch.as_tensor(alibi_slopes(H), device=dev)
                  if alibi else None)
        kw = dict(window=window, alibi_slopes=slopes)
        out = PA.paged_decode_attention(q, kv, table, start, **kw)
        ref = PA.paged_attention(q, kv, table, start, **kw)
        err = parity(out, ref)
        del out, ref
        # what this data needs: row i of a slot sees keys (pos - window,
        # pos] with pos = start + i; the slot reads the union once
        pos = start.long()[:, None] + torch.arange(Q, device=dev)
        lo = (pos - window + 1).clamp(min=0) if window else 0 * pos
        n_keys = int((pos[:, -1] + 1 - lo[:, 0]).sum())
        kv_bytes = n_keys * K * token_bytes
        io_bytes = 2 * q.numel() * 2 + table.numel() * 4 + S * 4
        flops = 4 * D * H * int((pos + 1 - lo).sum())
        b_ms, b_by = bound(kv_bytes + io_bytes, flops)
        rows.append(dict(
            shape=f"{name}: S={S} Q={Q} H={H} K={K} D={D} page={page} "
                  f"ctx<={ctx}" + (f" window={window}" if window else "")
                  + (" int8 pages" if int8 else ""),
            path=("split-KV decode + combine"
                  if Q * (H // K) < PA.DECODE_ROWS else "tensor-core tile"),
            **err,
            ms=cuda_ms(lambda: PA.paged_decode_attention(
                q, kv, table, start, **kw), 20),
            plain_ms=cuda_ms(lambda: PA.paged_attention(
                q, kv, table, start, **kw), 5, warmup=1),
            library_ms=cuda_ms(_sdpa_paged(q, kv, table, start, slopes,
                                           window), 20),
            bound_ms=b_ms, bound_by=b_by))
    return rows


def _bshd(dev, g, B, S, H, D=128):
    """[B, H, S, D] views of [B, S, H, D] activations, as the training
    forward passes them (read through their strides)."""
    import torch
    return torch.randn(B, S, H, D, generator=g, device=dev,
                       dtype=torch.bfloat16).transpose(1, 2)


def _attended_pairs(S, window=None):
    """(query, key) pairs a causal (+ window) head attends: what this
    run's masks need, per batch row and head."""
    if not window:
        return S * (S + 1) // 2
    return sum(min(t + 1, window) for t in range(S))


def _sdpa_forward(q, k, v, window):
    """Library yardstick: scaled_dot_product_attention, causal (a band
    mask with a window)."""
    import torch
    import torch.nn.functional as F
    gqa = q.shape[1] != k.shape[1]
    if window:
        S = q.shape[2]
        pos = torch.arange(S, device=q.device)
        band = (pos[:, None] >= pos[None, :]) & (
            pos[:, None] - pos[None, :] < window)
        return lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=band, enable_gqa=gqa)
    return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=gqa)


def check_flash(dev, mined_q=()):
    import torch
    from deepspeed_tpu_torch.ops import flash_attention as FA
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    # the serving case (contiguous [B, H, S, D]) first, then the training
    # shape as the training forward passes it ([B, S, H, D] views), an
    # uneven S, GQA and a window at the training width, a fresh prefill of
    # two prompts at each mined Q top (contiguous, as serving), and the
    # fresh prefill of phases 9b-9d at each of their head dims ([S, Q, H,
    # D] views, as the serving step passes them: Falcon-7B's 71 query heads
    # over one kv head at D = 64, Phi-2's and Phi-3-mini's 32 at 80 and 96)
    cases = [("", 4, 1024, 32, 32, None, 128),
             ("training: ", 2, TRAIN_SEQ, 32, 32, None, 128),
             ("Ulysses head shard: ", 4, 1024, 8, 8, None, 128),
             ("uneven S=1000: ", 2, 1000, 32, 32, None, 128),
             ("GQA: ", 2, TRAIN_SEQ, 32, 8, None, 128),
             ("window 512: ", 2, TRAIN_SEQ, 32, 32, 512, 128)]
    cases += [(f"mined Q={q}: ", 2, q, 32, 32, None, 128) for q in mined_q]
    cases += [(f"D={d}: ", 4, 1024, *((71, 1) if d == 64 else (32, 32)),
               None, d) for d in HEAD_DIM_MODELS]
    for name, B, S, H, K, window, D in cases:
        if name and not name.startswith("mined"):
            q, k, v = (_bshd(dev, g, B, S, n, D) for n in (H, K, K))
        else:
            q, k, v = (torch.randn(B, n, S, D, generator=g, device=dev,
                                   dtype=torch.bfloat16) for n in (H, K, K))
        out, lse = FA.flash_fwd(q, k, v, causal=True, window=window)
        ref, ref_lse = FA.flash_reference(q, k, v, causal=True, window=window)
        err = parity(out, ref)
        lse_err = parity(lse, ref_lse)
        del out, lse, ref, ref_lse
        flops = 4 * B * H * D * _attended_pairs(S, window)
        b_ms, b_by = bound(2 * B * (H + K) * S * D * 2 + B * H * S * 4, flops)
        rows.append(dict(
            shape=f"{name}B={B} H={H} K={K} S={S} D={D} causal"
                  + (f" window={window}" if window else ""), **err,
            lse_max_rel_err=lse_err["max_rel_err"],
            lse_rms_rel_err=lse_err["rms_rel_err"],
            ms=cuda_ms(lambda: FA.flash_fwd(q, k, v, causal=True,
                                            window=window), 20),
            plain_ms=cuda_ms(lambda: FA.flash_reference(
                q, k, v, causal=True, window=window), 3),
            library_ms=cuda_ms(_sdpa_forward(q, k, v, window), 20),
            bound_ms=b_ms, bound_by=b_by))
        del q, k, v
    return rows


def _sdpa_backward(q, k, v, do, window):
    """Library yardstick: the backward of scaled_dot_product_attention
    (its graph built once; each call is torch.autograd.grad alone)."""
    import torch
    import torch.nn.functional as F
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    gqa = q.shape[1] != k.shape[1]
    if window:
        S = q.shape[2]
        pos = torch.arange(S, device=q.device)
        band = (pos[:, None] >= pos[None, :]) & (
            pos[:, None] - pos[None, :] < window)
        out = F.scaled_dot_product_attention(*leaves, attn_mask=band,
                                             enable_gqa=gqa)
    else:
        out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                             enable_gqa=gqa)
    return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)


def check_flash_bwd(dev):
    """dq, dk, dv of the backward kernels against the plain backward, on
    the forward kernel's out and lse (transposed [B, S, H, D] views, as
    autograd hands them over in training); two calls bit-equal; the two
    kernels and the wrapper's delta timed apart, each with its own
    bound."""
    import torch
    from deepspeed_tpu_torch.ops import flash_attention as FA
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    # the training shapes at D = 128, then the head dims the families'
    # training phases give the backward: Falcon-7B's 71 query heads over
    # one kv head at D = 64 (B = 1), Phi-2's 32 at 80, Phi-3-mini's 32
    # under its 2047-token window at 96
    cases = [("training", 2, 32, 32, TRAIN_SEQ, None, 128),
             ("Ulysses head shard", 4, 8, 8, 1024, None, 128),
             ("GQA", 2, 32, 8, 1024, None, 128),
             ("window 512", 2, 32, 32, TRAIN_SEQ, 512, 128),
             ("uneven S=1000", 2, 32, 32, 1000, None, 128),
             ("D=64 Falcon-7B", 1, 71, 1, TRAIN_SEQ, None, 64),
             ("D=80 Phi-2", 2, 32, 32, TRAIN_SEQ, None, 80),
             ("D=96 Phi-3-mini", 2, 32, 32, TRAIN_SEQ, 2047, 96)]
    rows = []
    for name, B, H, K, S, window, D in cases:
        q, do = _bshd(dev, g, B, S, H, D), _bshd(dev, g, B, S, H, D)
        k, v = _bshd(dev, g, B, S, K, D), _bshd(dev, g, B, S, K, D)
        out, lse = FA.flash_fwd(q, k, v, causal=True, window=window)
        copies = FA.BWD_KERNEL.copies
        got = FA.flash_bwd(q, k, v, out, lse, do, True, None, window)
        again = FA.flash_bwd(q, k, v, out, lse, do, True, None, window)
        ref = FA.flash_bwd_reference(q, k, v, out, lse, do, True, None,
                                     window)
        if FA.BWD_KERNEL.copies != copies:
            raise RuntimeError("the backward copied a strided operand")
        bit_equal = all(torch.equal(a, b) for a, b in zip(got, again))
        if not bit_equal:
            raise RuntimeError(f"two backward calls differ at [{name}]")
        errs = [parity(a, b) for a, b in zip(got, ref)]
        err = {key: max(e[key] for e in errs) for key in errs[0]}
        del got, again, ref
        # the kernels apart, on the wrapper's own arguments
        delta = FA.bwd_delta(do, out)
        dq, dk, dv = (torch.empty(x.shape, dtype=x.dtype, device=dev)
                      for x in (q, k, v))
        args = FA.bwd_launch_args(q, k, v, do, lse, delta, dq, dk, dv, True,
                                  None, window)

        def launch(fn):
            return lambda: FA.BWD_KERNEL.launch(fn, *args[fn])

        # S x S products over the attended pairs, 2 D flops per pair each:
        # dK/dV four (s, dP, dV, dK), dQ three (s, dP, dQ), the function
        # five (s and dP once).  Bytes: q, dO at H heads and k, v at K
        # heads read, lse and delta read; dk, dv or dq written
        pair_flops = 2 * D * B * H * _attended_pairs(S, window)
        operands = 2 * B * (H + K) * S * D * 2 + 2 * B * H * S * 4
        dkv_bound = bound(operands + 2 * B * K * S * D * 2, 4 * pair_flops)
        dq_bound = bound(operands + B * H * S * D * 2, 3 * pair_flops)
        # delta reads dO and O and writes [B, H, S] fp32
        delta_bound = bound(2 * B * H * S * D * 2 + B * H * S * 4,
                            2 * B * H * S * D, FP32_FLOPS_PER_S)
        b_ms, b_by = bound(4 * B * (H + K) * S * D * 2 + 2 * B * H * S * 4,
                           5 * pair_flops)
        rows.append(dict(
            shape=f"{name}: B={B} H={H} K={K} S={S} D={D} causal"
                  + (f" window={window}" if window else ""), **err,
            head_dim=D, bit_equal=bit_equal,
            ms=cuda_ms(lambda: FA.flash_bwd(q, k, v, out, lse, do, True,
                                            None, window), 20),
            parts={
                "flash_bwd_dkv_bf16": dict(
                    ms=cuda_ms(launch("flash_bwd_dkv_bf16"), 20),
                    bound_ms=dkv_bound[0], bound_by=dkv_bound[1]),
                "flash_bwd_dq_bf16": dict(
                    ms=cuda_ms(launch("flash_bwd_dq_bf16"), 20),
                    bound_ms=dq_bound[0], bound_by=dq_bound[1]),
                "delta": dict(
                    ms=cuda_ms(lambda: FA.bwd_delta(do, out), 20),
                    bound_ms=delta_bound[0], bound_by=delta_bound[1])},
            plain_ms=cuda_ms(lambda: FA.flash_bwd_reference(
                q, k, v, out, lse, do, True, None, window), 2, warmup=1),
            library_ms=cuda_ms(_sdpa_backward(q, k, v, do, window), 10),
            bound_ms=b_ms, bound_by=b_by))
        del q, k, v, do, out, lse, delta, dq, dk, dv, args
        torch.cuda.empty_cache()
    return rows


def _train_leaf_sizes(cfg):
    """Element counts of the training model's 12 parameter leaves
    (scan layout: each layer leaf stacked over L)."""
    e, f, v, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.num_layers)
    h, k, d = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head
    per_layer = [e * h * d, e * k * d, e * k * d, h * d * e,
                 e * f, e * f, f * e, e, e]
    return [L * n for n in per_layer] + [v * e, e * v, e]


def check_adamw(dev, cfg):
    """The AdamW kernel against its plain version (fp32, in place on
    clones), at one 4096 x 11008 leaf and over the training model's whole
    parameter set; library yardstick torch.optim.AdamW(fused=True)."""
    import torch
    from deepspeed_tpu_torch.ops import fused_optimizer as FO
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    hp = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, wd=0.1)

    def buffers(n):
        p, grad, m = (torch.randn(n, generator=g, device=dev)
                      for _ in range(3))
        return [p, grad, m, torch.rand(n, generator=g, device=dev)]

    def errors(bufs, step):
        ref = [x.clone() for x in bufs]
        FO.fused_adamw_flat(*bufs, **hp, step=step)
        FO.adamw_reference(*ref, **hp, step=step)
        errs = [parity(bufs[i], ref[i]) for i in (0, 2, 3)]
        return {key: max(e[key] for e in errs) for key in errs[0]}

    rows = []
    e, f = cfg.hidden_size, cfg.intermediate_size
    for name, sizes in ((f"one leaf {e}x{f}", [e * f]),
                        (f"{cfg.num_layers}-layer model, 12 leaves",
                         _train_leaf_sizes(cfg))):
        leaves = [buffers(n) for n in sizes]
        err = {}
        for bufs in leaves:
            for key, val in errors(bufs, step=3).items():
                err[key] = max(err.get(key, 0.0), val)
        n = sum(sizes)

        def kernel():
            for bufs in leaves:
                FO.fused_adamw_flat(*bufs, **hp, step=3)

        def plain():
            for bufs in leaves:
                FO.adamw_reference(*bufs, **hp, step=3)
        ms = cuda_ms(kernel, 10 if n < 1e8 else 3)
        plain_ms = cuda_ms(plain, 5 if n < 1e8 else 1, warmup=1)
        for p, grad, _, _ in leaves:
            p.grad = grad
        lib = torch.optim.AdamW([bufs[0] for bufs in leaves], lr=hp["lr"],
                                betas=(hp["b1"], hp["b2"]), eps=hp["eps"],
                                weight_decay=hp["wd"], fused=True)
        library_ms = cuda_ms(lib.step, 10 if n < 1e8 else 3)
        # p, g, m, v read and p, m, v written; ~15 fp32 flops each
        b_ms, b_by = bound(28 * n, 15 * n, FP32_FLOPS_PER_S)
        rows.append(dict(shape=f"{name}: {n} fp32 elements", **err,
                         ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=b_ms, bound_by=b_by))
        del leaves, lib
        torch.cuda.empty_cache()
    return rows


def _opt_cases(cfg, two_dim=False):
    """(name, leaf sizes): one 4096 x 11008 leaf, and the training
    model's 12 leaves (the 11 of two or more dimensions for qwZ)."""
    e, f = cfg.hidden_size, cfg.intermediate_size
    sizes = _train_leaf_sizes(cfg)
    if two_dim:
        return [(f"one leaf {e}x{f}", [e * f]),
                (f"{cfg.num_layers}-layer model, 11 leaves of ndim >= 2",
                 sizes[:-1])]
    return [(f"one leaf {e}x{f}", [e * f]),
            (f"{cfg.num_layers}-layer model, 12 leaves", sizes)]


def _max_errors(pairs):
    errs = [parity(a, b) for a, b in pairs]
    return {key: max(e[key] for e in errs) for key in errs[0]}


NO_LIBRARY = "no single PyTorch call computes this function"


def check_quantization(dev, cfg):
    """The quantise and dequantise kernels against their plain versions
    at qwZ's shapes, fp32 leaves: codes, scales and outputs (bf16, the
    compute copy, and fp32) bit for bit.  Returns the quantise and the
    dequantise rows."""
    import torch
    from deepspeed_tpu_torch.ops import quantization as Q
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    q_rows, d_rows = [], []
    for name, sizes in _opt_cases(cfg, two_dim=True):
        leaves = [torch.randn(n, generator=g, device=dev) for n in sizes]
        coded = []
        for x in leaves:
            got, ref = Q.quantize_blockwise(x), Q.quantize_blockwise_reference(x)
            if not (got[2] == ref[2] and torch.equal(got[0], ref[0])
                    and torch.equal(got[1], ref[1])):
                raise RuntimeError(f"quantize: codes or scales differ from "
                                   f"the plain version at [{name}]")
            for dt in (torch.bfloat16, torch.float32):
                out = Q.dequantize_blockwise(*got, x.shape, dt)
                if not torch.equal(out, Q.dequantize_blockwise_reference(
                        *ref, x.shape, dt)):
                    raise RuntimeError(f"dequantize to {dt}: output differs "
                                       f"from the plain version at [{name}]")
                del out
            coded.append(got)
            del ref
        n = sum(sizes)
        rows = sum(q.shape[0] for q, _, _ in coded)
        iters = 10 if n < 1e8 else 3

        def quant():
            for x in leaves:
                Q.quantize_blockwise(x)

        def quant_plain():
            for x in leaves:
                Q.quantize_blockwise_reference(x)

        def deq(fn):
            def run():
                for x, (q, sc, pad) in zip(leaves, coded):
                    fn(q, sc, pad, x.shape, torch.bfloat16)
            return run
        # x read once; codes (padding included) and scales written once;
        # ~6 fp32 operations per element (abs, max, divide, round, clip)
        b_ms, b_by = bound(4 * n + 512 * rows + 4 * rows, 6 * n,
                           FP32_FLOPS_PER_S)
        shape = f"{name}: {n} fp32 elements, {rows} blocks of 512"
        exact = dict(max_abs_err=0.0, max_rel_err=0.0, rms_rel_err=0.0,
                     bit_equal=True, library_ms=None,
                     library_note=NO_LIBRARY)
        q_rows.append(dict(shape=shape, **exact, ms=cuda_ms(quant, iters),
                           plain_ms=cuda_ms(quant_plain, max(1, iters // 3),
                                            warmup=1),
                           bound_ms=b_ms, bound_by=b_by))
        # codes and scales read once, bf16 written once; one multiply
        b_ms, b_by = bound(512 * rows + 4 * rows + 2 * n, n,
                           FP32_FLOPS_PER_S)
        d_rows.append(dict(
            shape=shape + ", bf16 out", **exact,
            ms=cuda_ms(deq(Q.dequantize_blockwise), iters),
            plain_ms=cuda_ms(deq(Q.dequantize_blockwise_reference),
                             max(1, iters // 3), warmup=1),
            bound_ms=b_ms, bound_by=b_by))
        del leaves, coded
        torch.cuda.empty_cache()
    return q_rows, d_rows


# the dequantise kernel's main-path leaves: Mixtral-8x7B's experts (one
# [X, E, F] leaf a layer per expert projection) and an attention leaf
FP_DEQUANT_CASES = (("expert wi [8, 4096, 14336]", (8, 4096, 14336), 1,
                     "fp8_e4m3"),
                    ("expert wi [8, 4096, 14336]", (8, 4096, 14336), 1,
                     "int8"),
                    ("attention wq [4096, 32, 128]", (4096, 32, 128), 0,
                     "fp8_e4m3"))


def check_fp_dequant(dev):
    """The channelwise dequantise kernel against its plain version at
    the leaves phase 9e's steps read (bf16 out): bit for bit, kernel and
    plain ms, the bytes bound (1 byte in, 2 out an element, the scales
    once)."""
    import torch
    from deepspeed_tpu_torch.ops import fp_quantizer as FQ
    g = torch.Generator(device=dev).manual_seed(SEED + 31)
    rows = []
    for name, shape, batch_dims, fmt in FP_DEQUANT_CASES:
        w = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
        leaf = FQ.quantize_channelwise(w, fmt, batch_dims)
        del w
        out = FQ.dequantize_channelwise(leaf)
        ref = FQ.dequantize_channelwise_reference(leaf)
        if not torch.equal(out, ref):
            raise RuntimeError(f"fp_dequant differs from its plain version "
                               f"at [{name}, {fmt}]")
        del out, ref
        n = leaf["q"].numel()
        b_ms, b_by = bound(n + 2 * n + 4 * leaf["scale"].numel(), n,
                           FP32_FLOPS_PER_S)
        rows.append(dict(
            shape=f"{name} {fmt}", max_abs_err=0.0, max_rel_err=0.0,
            rms_rel_err=0.0, bit_equal=True, library_ms=None,
            library_note=NO_LIBRARY,
            ms=cuda_ms(lambda: FQ.dequantize_channelwise(leaf), 20),
            plain_ms=cuda_ms(lambda: FQ.dequantize_channelwise_reference(
                leaf), 5, warmup=1),
            bound_ms=b_ms, bound_by=b_by))
        del leaf
        torch.cuda.empty_cache()
    return rows


def lion_signs(p_old, p_new, lr, wd):
    """The sign u that a Lion step applied, recovered from
    p_new = p_old - lr (u + wd p_old)."""
    import torch
    return torch.round((p_old - p_new) / lr - wd * p_old)


def check_lion(dev, cfg):
    """The Lion kernel against its plain version (fp32, in place on
    clones): signs on every element, p and m."""
    import torch
    from deepspeed_tpu_torch.ops import fused_optimizer as FO
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    hp = dict(lr=3e-4, b1=0.9, b2=0.99, wd=0.1)
    rows = []
    for name, sizes in _opt_cases(cfg):
        leaves = [[torch.randn(n, generator=g, device=dev) for _ in range(3)]
                  for n in sizes]
        err, flips = {}, 0
        for bufs in leaves:
            p0 = bufs[0].clone()
            ref = [x.clone() for x in bufs]
            FO.fused_lion_flat(*bufs, **hp)
            FO.lion_reference(*ref, **hp)
            flips += int((lion_signs(p0, bufs[0], hp["lr"], hp["wd"])
                          != lion_signs(p0, ref[0], hp["lr"], hp["wd"])).sum())
            for key, val in _max_errors([(bufs[0], ref[0]),
                                         (bufs[2], ref[2])]).items():
                err[key] = max(err.get(key, 0.0), val)
            bufs[0].copy_(p0)
            del p0, ref
        if flips:
            raise RuntimeError(f"Lion kernel: {flips} signs differ from the "
                               f"plain version at [{name}]")
        n = sum(sizes)

        def kernel():
            for bufs in leaves:
                FO.fused_lion_flat(*bufs, **hp)

        def plain():
            for bufs in leaves:
                FO.lion_reference(*bufs, **hp)
        # p, g, m read and p, m written; ~10 fp32 operations each
        b_ms, b_by = bound(20 * n, 10 * n, FP32_FLOPS_PER_S)
        rows.append(dict(shape=f"{name}: {n} fp32 elements", **err,
                         sign_mismatches=flips,
                         ms=cuda_ms(kernel, 10 if n < 1e8 else 3),
                         plain_ms=cuda_ms(plain, 5 if n < 1e8 else 1,
                                          warmup=1),
                         library_ms=None, library_note=NO_LIBRARY,
                         bound_ms=b_ms, bound_by=b_by))
        del leaves
        torch.cuda.empty_cache()
    return rows


def check_lamb(dev, cfg):
    """The LAMB stage-1 kernel against its plain version (fp32, in place
    on clones): u, m, v, the squared norms, and p after the trust-ratio
    step (torch ops, the same for both).  ``ms`` times the kernel
    (stage 1); ``step_ms`` the whole update with the trust ratio."""
    import torch
    from deepspeed_tpu_torch.ops import fused_optimizer as FO
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    hp = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
    lr, step = 1e-2, 3
    rows = []
    for name, sizes in _opt_cases(cfg):
        leaves = []
        for n in sizes:
            p, grad, m = (torch.randn(n, generator=g, device=dev)
                          for _ in range(3))
            leaves.append([p, grad, m, torch.rand(n, generator=g, device=dev)])
        err, norm_err, p_err = {}, 0.0, 0.0
        for bufs in leaves:
            ref = [x.clone() for x in bufs]
            work = [bufs[0].clone(), bufs[1], bufs[2].clone(), bufs[3].clone()]
            u, norms = FO.lamb_stage1(*work, **hp, step=step)
            ru, rnorms = FO.lamb_stage1_reference(*ref, **hp, step=step)
            for key, val in _max_errors([(u, ru), (work[2], ref[2]),
                                         (work[3], ref[3])]).items():
                err[key] = max(err.get(key, 0.0), val)
            sums, rsums = norms.sum(0), rnorms.sum(0)
            norm_err = max(norm_err, float(((sums - rsums).abs()
                                            / rsums).max()))
            FO.lamb_trust_step(work[0], u, norms, lr)
            FO.lamb_trust_step(ref[0], ru, rnorms, lr)
            p_err = max(p_err, parity(work[0], ref[0])["max_rel_err"])
            del ref, work, u, ru
        n = sum(sizes)

        def kernel():
            for bufs in leaves:
                FO.lamb_stage1(*bufs, **hp, step=step)

        def whole():
            for bufs in leaves:
                FO.fused_lamb_flat(*bufs, lr, **hp, step=step)

        def plain():
            for bufs in leaves:
                FO.lamb_stage1_reference(*bufs, **hp, step=step)
        iters = 10 if n < 1e8 else 3
        # p, g, m, v read and u, m, v written; ~20 fp32 operations each
        b_ms, b_by = bound(28 * n, 20 * n, FP32_FLOPS_PER_S)
        rows.append(dict(shape=f"{name}: {n} fp32 elements", **err,
                         norm_rel_err=norm_err, p_max_rel_err=p_err,
                         ms=cuda_ms(kernel, iters),
                         step_ms=cuda_ms(whole, iters),
                         plain_ms=cuda_ms(plain, max(1, iters // 3),
                                          warmup=1),
                         library_ms=None, library_note=NO_LIBRARY,
                         bound_ms=b_ms, bound_by=b_by))
        del leaves
        torch.cuda.empty_cache()
        if norm_err > LAMB_NORM_REL_TOL or p_err > LAMB_P_MAX_REL_TOL:
            raise RuntimeError(f"LAMB kernel at [{name}]: norms {norm_err:.3e}"
                               f" (tol {LAMB_NORM_REL_TOL}), stepped p "
                               f"{p_err:.3e} (tol {LAMB_P_MAX_REL_TOL})")
    return rows


# ---------------------------------------------------------------------------
# phases 4 to 9: serving (Llama-2-7B, then OPT-6.7B)
# ---------------------------------------------------------------------------

def build_engine(cfg, params, num_pages, implementations=None,
                 kv_quantization="none", model_type="llama",
                 state_manager=None, quantization=None, **serving):
    """The family's model class -> engine, as a user builds them;
    ``serving`` sets ServingOptimizationConfig's other fields and
    ``state_manager`` StateManagerConfig's (16 sequences and a 2048-token
    budget by default); ``quantization`` (a format) turns on the engine's
    weight-only quantisation."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import (
        InferenceEngineV2, KVCacheConfig, QuantizationConfig,
        RaggedInferenceEngineConfig, ServingOptimizationConfig,
        StateManagerConfig, implementation_for)
    kv_cfg = KVCacheConfig(num_layers=cfg.num_layers, kv_heads=cfg.kv_heads,
                           head_dim=cfg.dims_per_head, page_size=64,
                           num_pages=num_pages, dtype=torch.bfloat16)
    model = implementation_for(model_type)(
        cfg, params, kv_config=kv_cfg, device="cuda",
        implementations=implementations)
    econf = RaggedInferenceEngineConfig(
        state_manager=StateManagerConfig(**dict(
            dict(max_tracked_sequences=16, max_ragged_sequence_count=16,
                 max_ragged_batch_size=2048), **(state_manager or {}))),
        quantization=QuantizationConfig(enabled=quantization is not None,
                                        fmt=quantization or "fp8_e4m3"),
        serving=ServingOptimizationConfig(kv_quantization=kv_quantization,
                                          **serving))
    return InferenceEngineV2(model, econf)


def randomize_norms_and_biases(params, seed):
    """The initialiser leaves norm scales at 1 and every bias at 0; draw
    them from a seed instead (scales 1 + 0.1 N(0,1), biases 0.02 N(0,1))
    so that the LayerNorm bias and the projection biases count."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def visit(node):
        for key, leaf in node.items():
            if isinstance(leaf, dict):
                visit(leaf)
            elif key == "scale" or key.startswith("b"):
                noise = torch.randn(leaf.shape, generator=g, device="cuda")
                node[key] = ((1 + 0.1 * noise) if key == "scale"
                             else 0.02 * noise).to(leaf.dtype)
    visit(params)
    return params


def key_kind(key) -> str:
    """A step key's kind: a bare (S, Q, P, fresh) is a logits forward
    (the split path's ``put``)."""
    return key[4] if len(key) > 4 else "logits"


def key_segments(key, layers, draft_layers=0):
    """The segments one dispatch of a step key runs, as (kind, S, Q, P,
    layers): kind "fresh" (flash) or "paged"; a mixed key runs its decode
    segment and then its prefill segment; a draft_spec key runs Q draft
    iterations at Q=1 over the draft trunk's ``draft_layers`` and then
    the verify, a draft_fill key one segment of the draft trunk."""
    S, Q, P = key[:3]
    kind = key_kind(key)
    if kind == "draft_spec":
        return ([("paged", S, 1, P, draft_layers)] * Q
                + [("paged", S, Q, P, layers)])
    if kind == "draft_fill":
        return [("paged", S, Q, P, draft_layers)]
    first = ("fresh" if key[3] else "paged", S, Q, P, layers)
    if kind == "mixed":
        return [first, ("fresh" if key[8] else "paged",) + tuple(key[5:8])
                + (layers,)]
    return [first]


def segment_counts(cfg, dispatches, draft_layers=0) -> dict:
    """Fresh, paged and split-KV segments of ``dispatches`` ({step key:
    dispatches}), and the layers they run (``*_layers``; ``norms``: the
    2 * layers + 1 norm launches of every segment): a paged segment whose
    folded rows (Q * H / K) take the paged kernel's split-KV decode path
    with more than one split adds one combine launch per layer."""
    import torch
    from deepspeed_tpu_torch.ops import paged_attention as PA
    groups = cfg.num_heads // cfg.kv_heads
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    seg = {"fresh": 0, "paged": 0, "split_kv": 0, "fresh_layers": 0,
           "paged_layers": 0, "split_kv_layers": 0, "norms": 0}
    for key, n in dispatches.items():
        for kind, S, Q, P, layers in key_segments(key, cfg.num_layers,
                                                  draft_layers):
            seg[kind] += n
            seg[f"{kind}_layers"] += n * layers
            seg["norms"] += n * (2 * layers + 1)
            if kind == "paged" and Q * groups < PA.DECODE_ROWS and \
                    PA.decode_splits(S, cfg.kv_heads, P, sms) > 1:
                seg["split_kv"] += n
                seg["split_kv_layers"] += n * layers
    return seg


def launch_checks(cfg, kv_quantization, launches, seg,
                  dequant_leaves=0) -> dict:
    """Exact launch counts of the serving kernels for the segments run:
    the family's norm 2 * layers + 1 per segment, its page format's
    kernel one per layer of a paged segment, flash one per layer of a
    fresh segment, combine one per layer of a split-KV segment, the
    weight dequantise kernel ``dequant_leaves`` (a layer's quantised
    leaves) per layer of every segment, every other kernel 0."""
    norm, other_norm = (("rmsnorm", "layernorm") if cfg.norm == "rmsnorm"
                        else ("layernorm", "rmsnorm"))
    paged, other_paged = (("paged_attention_int8", "paged_attention")
                          if kv_quantization == "int8"
                          else ("paged_attention", "paged_attention_int8"))
    return {
        norm: launches[norm] == seg["norms"],
        paged: launches[paged] == seg["paged_layers"],
        "flash_fwd": launches["flash_fwd"] == seg["fresh_layers"],
        "paged_attention_combine": launches["paged_attention_combine"]
        == seg["split_kv_layers"],
        "fp_dequant": launches["fp_dequant"] == dequant_leaves * (
            seg["fresh_layers"] + seg["paged_layers"]),
        "idle kernels": all(launches[k] == 0 for k in (
            other_norm, other_paged, "rmsnorm_res", "flash_bwd",
            "fused_adamw", "fused_lion", "fused_lamb", "quantize",
            "dequantize"))}


def quantized_leaves(model) -> int:
    """The weight-only quantised leaves of one layer of ``model``: each
    one a dequantise launch per layer of every segment."""
    from deepspeed_tpu_torch.models.transformer import layer_params
    lp = layer_params(model.cfg, model.params, 0)
    return sum(isinstance(v, dict) and "q" in v
               for block in ("attn", "mlp") for v in lp[block].values())


def graph_report(model) -> dict:
    """The model's captured graphs: how many, the host seconds their
    captures took (an eager warm-up run each, then the capture), and the
    bytes the shared graph pool holds (its segments in the caching
    allocator's snapshot)."""
    import torch
    shared = model._graph_shared            # (pool, stream, generator)
    pool_bytes = 0 if shared is None else sum(
        seg["total_size"] for seg in torch.cuda.memory_snapshot()
        if tuple(seg.get("segment_pool_id", ())) == tuple(shared[0]))
    return dict(graphs=sum(g is not None for g in model._step_cache.values()),
                capture_s=model.capture_seconds, pool_bytes=pool_bytes)


def step_kind(key) -> str:
    if key is None:
        return "drain"            # dispatched nothing: tokens reach host
    if isinstance(key[0], tuple):
        return "mixed"            # split: one forward per Q bucket
    if key_kind(key) in ("mixed", "spec", "draft_spec", "draft_fill"):
        return key_kind(key)      # mixed: decode + prefill segment
    if key[3]:
        return "fresh"            # pure fresh prefill
    return "decode" if key[1] == 1 else "prefill"


def drive(engine, reqs, uid_base=0, record=False, audit=False,
          after_step=None):
    """Submit ``reqs`` ({uid: (prompt, SamplingParams)}) at once under
    uids ``uid_base + uid`` and step a new FastGenScheduler until it is
    done.  Returns ({uid: tokens}, {uid: TTFT s}, per-step records: host
    ms, requests and tokens delivered, rows scheduled and the key
    dispatched: one key, or on the split path a tuple of the logits keys
    of a step's forwards).
    ``audit`` runs the page audit after every step; ``after_step(sched)``
    runs after every step."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import FastGenScheduler
    model = engine.model
    sched = FastGenScheduler(engine, seed=SEED)
    first_token, generated, steps = {}, {uid: [] for uid in reqs}, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for uid, (prompt, sp) in reqs.items():
        sched.submit(uid_base + uid, prompt, sp)

    def on_token(uid, tok):
        first_token.setdefault(uid - uid_base, time.perf_counter() - t0)
        generated[uid - uid_base].append(tok)

    while sched.has_work:
        before = dict(model.dispatch_counts) if record else None
        n_before = sum(len(t) for t in generated.values())
        ts = time.perf_counter()
        out = sched.step(on_token=on_token)
        dt = time.perf_counter() - ts
        if record:
            # one key a step; none for an async drain that dispatched
            # nothing (the last tokens reaching the host)
            keys = [k for k, n in model.dispatch_counts.items()
                    if n != before.get(k, 0)]
            split = len(keys) > 1 and all(key_kind(k) == "logits"
                                          for k in keys)
            if (len(keys) > 1 and not split) or any(
                    model.dispatch_counts[k] - before.get(k, 0) != 1
                    for k in keys):
                raise RuntimeError(f"one step dispatched {keys}")
            steps.append(dict(ms=dt * 1e3, tokens=len(out),
                              delivered=sum(len(t) for t in generated.values())
                              - n_before,
                              scheduled=(sched.last_step_scheduled
                                         if keys else 0),
                              key=(tuple(keys) if split
                                   else keys[0] if keys else None),
                              dispatches=len(keys)))
        if audit:
            engine.state_manager.check_invariants()
        if after_step is not None:
            after_step(sched)
        if sched.last_step_scheduled == 0 and not out \
                and not sched._preempted_this_step:
            raise RuntimeError("serving stalled: nothing schedulable")
    torch.cuda.synchronize()
    for uid, (prompt, sp) in reqs.items():
        toks = generated[uid]
        if len(toks) != sp.max_new_tokens:
            raise RuntimeError(f"request {uid}: {len(toks)} tokens, "
                               f"expected {sp.max_new_tokens}")
        if not all(0 <= t < engine.model.cfg.vocab_size for t in toks):
            raise RuntimeError(f"request {uid}: token outside the vocab")
    return generated, first_token, steps


def serving_requests(cfg, n=10, lo=128, hi=1025, new_tokens=64,
                     sampled_from=8, seed=SEED):
    """The serving traffic: ``n`` requests with prompts of ``lo`` to
    ``hi - 1`` tokens, ``new_tokens`` each; from uid ``sampled_from`` on
    sampled (temperature 0.8, top-p 0.9), greedy before it."""
    import numpy as np
    from deepspeed_tpu_torch.inference.v2 import SamplingParams
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi, n)
    reqs = {}
    for uid, length in enumerate(lens):
        sampled = uid >= sampled_from
        reqs[uid] = (rng.integers(0, cfg.vocab_size, int(length)),
                     SamplingParams(max_new_tokens=new_tokens,
                                    temperature=0.8 if sampled else 0.0,
                                    top_p=0.9 if sampled else 1.0))
    return reqs


def tail_tok_s(steps):
    """Tokens reaching the host over the steps that carry no prompt
    tokens (a chained or plain decode, a spec verify, a draft loop, a
    draft fill, the last drain), over those steps' host seconds."""
    tail = [st for st in steps if step_kind(st["key"]) in (
        "decode", "drain", "spec", "draft_spec", "draft_fill")]
    seconds = sum(st["ms"] for st in tail) / 1e3
    return sum(st["delivered"] for st in tail) / seconds if seconds else None


def two_passes(engine, reqs, cfg, counters, card, label,
               kv_quantization="none", audit=False, after_step=None,
               before_pass=None):
    """A warm-up pass of ``reqs`` captures every key the traffic needs,
    the prefix cache is reset, and a timed pass of the same traffic must
    capture nothing and replay a graph at every dispatch; launch counts
    of the timed pass (counters set to 0 just before it) are held to the
    segments its dispatched keys run.  ``audit`` runs the page audit
    after every step of the warm-up pass only, so the timed pass's step
    ms compare with phase 4's.  ``before_pass(name)`` runs before each
    pass ("warm-up", "timed").  Returns (summary, launches,
    {uid: tokens} of the timed pass, its dispatches by key)."""
    import torch
    model = engine.model
    kv_pool_bytes = model.kv_config.total_bytes()
    sv = engine._config.serving
    log(f"{label} serving: {type(model).__name__}, implementations "
        f"{model.implementations}, kv pages {model.kv_config.quantization}"
        f", kv pool {model.kv_config.num_pages} pages, "
        f"{kv_pool_bytes / 1e9:.2f} GB, fused_step {sv.fused_step}, "
        f"on_device_sampling {sv.on_device_sampling}, async_scheduling "
        f"{sv.async_scheduling}, prefix_caching {sv.prefix_caching}")
    if before_pass is not None:
        before_pass("warm-up")
    t = time.perf_counter()
    drive(engine, reqs, uid_base=1000, audit=audit,   # the warm-up pass
          after_step=after_step)
    warm = dict(graph_report(model), pass_s=time.perf_counter() - t)
    engine.reset_prefix_cache()               # the timed pass starts cold
    cached, capture_s = dict(model._step_cache), model.capture_seconds
    dispatched = dict(model.dispatch_counts)
    if before_pass is not None:
        before_pass("timed")
    reset_launches(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    generated, first_token, steps = drive(engine, reqs, record=True,
                                          after_step=after_step)
    total_s = time.perf_counter() - t0
    launches = read_launches(counters)
    peak = torch.cuda.max_memory_allocated()
    dispatches = {k: n - dispatched.get(k, 0)
                  for k, n in model.dispatch_counts.items()
                  if n != dispatched.get(k, 0)}
    if model._step_cache.keys() != cached.keys() \
            or model.capture_seconds != capture_s:
        raise RuntimeError("the timed pass captured a graph: "
                           f"{set(model._step_cache) - set(cached)}")
    if any(model._step_cache[k] is None for k in dispatches) \
            or sum(dispatches.values()) != sum(st["dispatches"]
                                               for st in steps):
        raise RuntimeError("a timed serving step was not one graph replay")
    seg = segment_counts(cfg, dispatches, engine._draft_layers)
    checks = launch_checks(cfg, kv_quantization, launches, seg,
                           quantized_leaves(model))
    by_kind = {}
    for st in steps:
        by_kind.setdefault(step_kind(st["key"]), []).append(st["ms"])
    decode_steps = [st for st in steps if step_kind(st["key"]) == "decode"]
    dec_tokens = sum(st["scheduled"] for st in decode_steps)
    dec_s = sum(st["ms"] for st in decode_steps) / 1e3
    ttft = sorted(first_token.values())
    summary = dict(
        card=card, model=label, kv_pages=kv_quantization,
        kv_pool_pages=model.kv_config.num_pages,
        kv_pool_gb=kv_pool_bytes / 1e9,
        requests=len(reqs), prompt_lens=[len(p) for p, _ in reqs.values()],
        new_tokens=[sp.max_new_tokens for _, sp in reqs.values()],
        steps=len(steps), total_s=total_s,
        ttft_ms_mean=1e3 * sum(ttft) / len(ttft),
        ttft_ms_max=1e3 * ttft[-1],
        decode_steps=len(decode_steps),
        chained_steps=sum(st["key"] is not None
                          and step_kind(st["key"]) != "mixed"
                          and key_kind(st["key"]) == "chain" for st in steps),
        decode_tok_s=dec_tokens / dec_s if dec_s else None,
        tail_tok_s=tail_tok_s(steps),
        decode_step_ms_mean=(1e3 * dec_s / len(decode_steps)
                             if decode_steps else None),
        decode_step_ms_median=(statistics.median(
            st["ms"] for st in decode_steps) if decode_steps else None),
        step_ms_mean=sum(st["ms"] for st in steps) / len(steps),
        step_ms_by_kind={k: dict(count=len(v), mean=sum(v) / len(v),
                                 total=sum(v))
                         for k, v in by_kind.items()},
        tokens_generated=sum(len(t) for t in generated.values()),
        max_memory_allocated_gb=peak / 1e9,
        warm_up_pass=warm, timed_pass_captures=0,
        keys_dispatched={repr(k): n for k, n in sorted(
            dispatches.items(), key=repr)},
        segments=seg, launches=launches, launch_checks=checks)
    log(f"{label} serving:", json.dumps(summary))
    if not all(checks.values()):
        raise RuntimeError(f"{label}: launch counts do not match the steps "
                           f"taken: {checks}")
    return summary, launches, generated, dispatches


def serve(cfg, params, counters, card, model_type="llama",
          kv_quantization="none", label=None, reqs=None, quantization=None,
          **serving):
    """10 requests (or ``reqs``) through FastGenScheduler in the default
    serving configuration (a CUDA graph per step key, the async chain,
    prefix caching), or with ``serving``'s flags: ``two_passes``, every
    segment kind run (a model whose decode rows fold to the tile, as
    multi-query Falcon's 71, has no split-KV segment), then every key's
    replay against its eager body and four profiled decode steps.
    Returns (summary, launches, engine, the requests, {uid: tokens} of
    the timed pass)."""
    from deepspeed_tpu_torch.ops import paged_attention as PA
    label = label or model_type
    engine = build_engine(cfg, params, num_pages=256, model_type=model_type,
                          kv_quantization=kv_quantization,
                          quantization=quantization, **serving)
    reqs = reqs or serving_requests(cfg)
    summary, launches, generated, dispatches = two_passes(
        engine, reqs, cfg, counters, card, label, kv_quantization)
    decode_tiles = cfg.num_heads // cfg.kv_heads >= PA.DECODE_ROWS
    if not all(n for kind, n in summary["segments"].items()
               if not (decode_tiles and kind.startswith("split_kv"))):
        raise RuntimeError(f"{label}: a segment kind never ran: "
                           f"{summary['segments']}")
    engine.reset_prefix_cache()
    summary["replay_vs_eager"] = replay_vs_eager(engine, reqs, dispatches,
                                                 label)
    engine.reset_prefix_cache()
    summary["decode_profile"] = profile_decode_steps(
        engine, reqs, label, summary["decode_step_ms_median"])
    return summary, launches, engine, reqs, generated


def replay_vs_eager(engine, reqs, timed, label):
    """A third pass of the serving traffic in which every dispatch runs
    twice on the same inputs: first its key's step body eagerly
    (``model._call`` on a copy of the scheduler's generator), then the
    key's own graph through ``model._dispatch`` (the static-buffer loads
    of ``_input_specs``' order, the replay and the output clone).  Both
    write the same KV positions from the same history, the replay last,
    so the pass serves as the timed pass did.  The live greedy rows'
    tokens must be bit-equal; the sampled rows (same generator state)
    are reported.  A logits key's live rows must be bit-equal logits.
    Every key of the timed pass (``timed``) must be checked, and the
    pass may capture nothing."""
    import numpy as np
    import torch
    model = engine.model
    dispatch = model._dispatch
    captured = model.capture_seconds
    by_kind, checked, logit_diff, logits_unequal = {}, set(), {}, []

    def kind_of(key):
        kind = key_kind(key)
        return kind if kind in ("chain", "mixed") else (
            "logits " if kind == "logits" else "") + step_kind(key)

    def compared(key, kv, generator, inputs):
        if model._step_cache.get(key) is None:
            raise RuntimeError(f"step key {key} has no graph to replay")
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(model.device)
             if isinstance(a, np.ndarray) else a for a in inputs]
        gen = None                  # a logits step takes no generator
        if generator is not None:
            gen = torch.Generator(device=model.device)
            gen.set_state(generator.get_state())
        ref = model._call(key, kv, gen, *t)
        out = dispatch(key, kv, generator, inputs)
        if key_kind(key) == "draft_fill":
            # writes the draft pool and returns nothing; its KV feeds the
            # draft_spec verdicts held below
            row = by_kind.setdefault("draft_fill", dict(dispatches=0))
            row["dispatches"] += 1
            checked.add(key)
            return out
        if key_kind(key) == "logits":
            # the split path: logits, held bit-equal on the live rows,
            # and their greedy picks
            live = t[1] > 0
            greedy = torch.ones_like(live)
            same = out.argmax(-1) == ref.argmax(-1)
            row = logit_diff.setdefault(key_kind(key), [0.0])
            row[0] = max(row[0], float((out - ref)[live].abs().max()))
            if not torch.equal(out[live], ref[live]):
                logits_unequal.append(key)
        elif key_kind(key) in ("spec", "draft_spec"):
            # the verdict: accepted count, corrected token (and the
            # drafts), every column of a live row bit-equal
            live, greedy = t[1] > 0, t[-3] <= 0
            same = (out == ref).all(dim=1)
        else:
            q_lens = {"sample": t[1], "chain": t[2]}.get(key[4])
            if q_lens is None:                        # mixed: both segments
                q_lens = torch.cat([t[1], t[5]])
            n = q_lens.shape[0]             # a mixed step pads past it
            live, greedy = q_lens > 0, t[-3] <= 0
            same = out[:n] == ref[:n]
        row = by_kind.setdefault(kind_of(key), dict(
            dispatches=0, greedy_rows=0, greedy_equal=0, sampled_rows=0,
            sampled_equal=0))
        row["dispatches"] += 1
        for name, rows in (("greedy", live & greedy),
                           ("sampled", live & ~greedy)):
            row[f"{name}_rows"] += int(rows.sum())
            row[f"{name}_equal"] += int((same & rows).sum())
        checked.add(key)
        return out

    model._dispatch = compared
    try:
        drive(engine, reqs, uid_base=2000)
    finally:
        del model._dispatch
    res = dict(model=label, by_kind=by_kind,
               logits_max_abs_diff=(logit_diff["logits"][0]
                                    if logit_diff else None),
               logits_bit_equal=not logits_unequal,
               keys_checked=len(checked), timed_keys=len(timed),
               greedy_bit_equal=all(r["greedy_equal"] == r["greedy_rows"]
                                    for r in by_kind.values()
                                    if "greedy_rows" in r))
    log(f"{label} replay vs eager, every key:", json.dumps(res))
    if model.capture_seconds != captured:
        raise RuntimeError("the replay-vs-eager pass captured a graph")
    if set(timed) - checked:
        raise RuntimeError(f"keys of the timed pass not checked: "
                           f"{set(timed) - checked}")
    if not res["greedy_bit_equal"]:
        raise RuntimeError(f"replayed greedy tokens differ from the eager "
                           f"step body: {by_kind}")
    if logits_unequal:
        raise RuntimeError(f"replayed logits differ from the eager step "
                           f"body at keys {sorted(set(logits_unequal))} "
                           f"(max |diff| {res['logits_max_abs_diff']})")
    return res


def graph_vs_eager(engine, reqs, label, n_steps=20):
    """At one decode key of the serving traffic (its 10 requests, their
    prompts and sampling, all decoding, one token each): ``n_steps``
    eager steps (``model._sample_step_impl``
    called directly, the body a graph captures) against ``n_steps``
    replays of the key's graph, over the same batch (each step writes
    the same KV positions).  Host ms: a host clock around one step and
    its synchronize; enqueue ms: until the call returns; device ms: the
    kernels torch.profiler records, per step (for the replays, CUDA
    events around each replay where the profiler records none).  The
    serving phase's ``replay_vs_eager`` holds every key's tokens, this
    one among them, against its eager body."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.inference.v2 import FastGenScheduler
    from deepspeed_tpu_torch.inference.v2 import SamplingParams
    from torch.profiler import ProfilerActivity, profile
    model = engine.model
    sched = FastGenScheduler(engine, seed=SEED)
    params_ = []
    for uid, (prompt, sp) in reqs.items():
        params_.append(SamplingParams(max_new_tokens=n_steps + 8,
                                      temperature=sp.temperature,
                                      top_p=sp.top_p))
        sched.submit(500 + uid, prompt, params_[-1])
    while len(sched.step()) < len(reqs):     # until all of them decode
        pass
    # a decode batch at each sequence's next position, never committed:
    # the scheduler's next step writes that position again before any
    # step reads it
    state = engine.state_manager
    uids = [500 + uid for uid in reqs]
    descs = [state.get_sequence(u) for u in uids]
    batch = engine._build_batch(descs, [np.array([7], np.int32)] * len(uids))
    kv = state.kv_cache.data
    temps, top_ks, top_ps = engine._pad_sample_params(params_,
                                                      batch.num_slots)
    greedy = not bool((temps > 0).any())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    key = model._normalize_key(batch.shape_key) + ("sample", greedy)
    tensors = [torch.from_numpy(a).cuda()
               for a in model._batch_arrays(batch)]
    rows = [torch.from_numpy(a).cuda()
            for a in model._sample_arrays(temps, top_ks, top_ps)]

    def eager():
        with torch.no_grad():
            return model._sample_step_impl(model.params, kv, *tensors, gen,
                                           *rows, fresh=False,
                                           greedy_only=greedy)

    def replay():
        return model.sample_step(batch, kv, gen, temps, top_ks, top_ps,
                                 greedy)

    def measure(fn):
        fn()
        torch.cuda.synchronize()
        host, enq, ev_ms = [], [], []
        for _ in range(n_steps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            e0.record()
            fn()
            e1.record()
            enq.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t) * 1e3)
            ev_ms.append(e0.elapsed_time(e1))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_steps):
                fn()
            torch.cuda.synchronize()
        n_kernels, by_kind = device_ms_by_kind(prof)
        dev = sum(by_kind.values()) / n_steps
        return dict(host_ms=statistics.median(host),
                    host_ms_range=[min(host), max(host)],
                    enqueue_ms=statistics.median(enq),
                    event_ms=statistics.median(ev_ms),
                    device_ms_profiler=dev,
                    kernels_per_step_profiler=n_kernels / n_steps,
                    busy_share=(dev if n_kernels else
                                statistics.median(ev_ms))
                    / statistics.median(host))

    a = measure(eager)
    b = measure(replay)
    c = measure(eager)
    d = measure(replay)
    sched.run_to_completion()
    res = dict(model=label, key=repr(key), steps=n_steps,
               eager=[a, c], graph=[b, d])
    log(f"{label} graph vs eager:", json.dumps(res))
    return res


def prefix_phase(engine, cfg, counters, card):
    """Prefix caching at full width: chat traffic with a shared system
    prompt.  One cold request (a 1024-token prefix + 128 tokens), then 7
    warm requests (the same prefix + distinct suffixes of 64-384 tokens)
    submitted together; 64 greedy tokens each.  A first pass of the same
    traffic captures the graphs it needs; the cache is reset, and in the
    measured pass each warm request must hit 1024 tokens and nothing may
    be captured.  Warm against cold TTFT and the prefill tokens computed
    are reported; the page accounting audit passes; launch counts of the
    warm requests are exact.  Each warm request is then run alone after
    ``reset_prefix_cache()`` (a free-running cold twin: its agreement
    with the served tokens is reported) and, after another reset, on the
    eager forward (``put``), teacher-forced with the served tokens: its
    greedy agreement must reach GREEDY_AGREE_MIN, and where a twin first
    parts from the served tokens, the eager logits of the two picks must
    lie within LOGIT_REL_TOL of the largest logit (the top-2 margin
    there, and its median over every position, are reported)."""
    import numpy as np
    from deepspeed_tpu_torch.inference.v2 import SamplingParams
    model = engine.model
    rng = np.random.default_rng(SEED + 3)
    V = cfg.vocab_size
    prefix = rng.integers(0, V, 1024)
    sp = SamplingParams(max_new_tokens=64)
    cold = {0: (np.concatenate([prefix, rng.integers(0, V, 128)]), sp)}
    suffixes = rng.integers(64, 385, 7)
    warm = {i + 1: (np.concatenate([prefix, rng.integers(0, V, int(n))]), sp)
            for i, n in enumerate(suffixes)}
    hits = {}
    match = engine.match_prefix

    def recorded(uid, prompt):
        hits[uid] = match(uid, prompt)
        return hits[uid]

    engine.match_prefix = recorded
    try:
        for base in (2000, 3000):           # capture pass, measured pass
            engine.reset_prefix_cache()
            capture_s = model.capture_seconds
            _, cold_ttft, _ = drive(engine, cold, uid_base=base)
            dispatched = dict(model.dispatch_counts)
            reset_launches(counters)
            warm_out, warm_ttft, steps = drive(engine, warm, uid_base=base,
                                               record=True)
            launches = read_launches(counters)
            dispatches = {k: n - dispatched.get(k, 0)
                          for k, n in model.dispatch_counts.items()
                          if n != dispatched.get(k, 0)}
            # one warm request alone, its prefix cached (the batch above
            # pads 7 suffixes to 8 slots of the longest one's Q bucket)
            _, alone_ttft, _ = drive(engine, {1: warm[1]},
                                     uid_base=base + 500)
            engine.state_manager.check_invariants()
        if model.capture_seconds != capture_s:
            raise RuntimeError("the measured prefix pass captured a graph")
        twins = {}
        for u in warm:                      # may capture single-slot keys
            engine.reset_prefix_cache()
            twins[u] = drive(engine, {u: warm[u]}, uid_base=5000)[0][u]
    finally:
        engine.match_prefix = match
    seg = segment_counts(cfg, dispatches)
    checks = launch_checks(cfg, "none", launches, seg)
    parted = {u: next(t for t, (a, b) in enumerate(zip(warm_out[u], twins[u]))
                      if a != b)
              for u in warm if warm_out[u] != twins[u]}
    agree, margins, witness = teacher_forced_agreement(
        engine, warm, warm_out, uid_base=4000,
        parted={u: (t, twins[u][t]) for u, t in parted.items()})
    engine.state_manager.check_invariants()
    warm_hits = [hits.get(3000 + u, 0) for u in warm]
    res = dict(
        card=card, model="llama", prefix_tokens=1024,
        cold_prompt=len(cold[0][0]),
        warm_suffixes=[int(n) for n in suffixes],
        hit_tokens_cold=hits.get(3000, 0), hit_tokens_warm=warm_hits,
        hit_tokens_twins=[hits.get(5000 + u, 0) for u in warm],
        cold_ttft_ms=1e3 * cold_ttft[0],
        warm_ttft_ms=[1e3 * warm_ttft[u] for u in warm],
        warm_ttft_ms_mean=1e3 * float(np.mean([warm_ttft[u] for u in warm])),
        warm_alone_ttft_ms=1e3 * alone_ttft[1],
        prefill_tokens_computed_cold=len(cold[0][0]) - hits.get(3000, 0),
        prefill_tokens_computed_warm=sum(len(p) for p, _ in warm.values())
        - sum(warm_hits),
        prefill_tokens_warm_without_cache=sum(len(p)
                                              for p, _ in warm.values()),
        warm_step_ms=[st["ms"] for st in steps[:3]],
        greedy_agreement_vs_cold=agree, greedy_min=GREEDY_AGREE_MIN,
        free_running_agreement_vs_cold=[
            float(np.mean(np.equal(warm_out[u], twins[u]))) for u in warm],
        first_parting=witness, top2_margin_median=float(np.median(margins)),
        top2_margin_min=float(np.min(margins)), tol=LOGIT_REL_TOL,
        steps=len(steps), keys_dispatched={repr(k): n for k, n in sorted(
            dispatches.items(), key=repr)},
        segments=seg, launches=launches, launch_checks=checks)
    log("prefix caching at full width:", json.dumps(res))
    if any(h != 1024 for h in warm_hits) or hits.get(3000, 0) \
            or any(res["hit_tokens_twins"]):
        raise RuntimeError(f"prefix hits {hits}: expected 0 cold and 1024 "
                           f"for every warm request")
    if min(agree) < GREEDY_AGREE_MIN:
        raise RuntimeError(f"warm requests agree with their cold run on "
                           f"{min(agree):.3f} of the tokens, below "
                           f"{GREEDY_AGREE_MIN}")
    wide = {u: w for u, w in witness.items() if w["pick_gap_rel"] > LOGIT_REL_TOL}
    if wide:
        raise RuntimeError(f"a cold twin parts from the served tokens at a "
                           f"pick that is no near-tie: {wide}")
    if not all(checks.values()):
        raise RuntimeError(f"prefix phase launch counts: {checks}")
    return res


@contextlib.contextmanager
def eager_steps(*engines):
    """Every dispatch of the engines' models runs its key's step body
    eagerly (``model._call``), capturing nothing: the teacher-forced
    ``put`` calls, one forward each, compare paths and are not served."""
    import numpy as np
    import torch

    def eager(model):
        def run(key, kv, generator, inputs):
            return model._call(key, kv, generator, *(
                torch.from_numpy(np.ascontiguousarray(a)).to(model.device)
                if isinstance(a, np.ndarray) else a for a in inputs))
        return run

    for e in engines:
        e.model._dispatch = eager(e.model)
    try:
        yield
    finally:
        for e in engines:
            del e.model._dispatch


def teacher_forced_agreement(engine, reqs, served, uid_base, parted,
                             picks_by=None):
    """Each request run again after ``reset_prefix_cache()`` on the eager
    forward (``put``: its whole prompt, then its served tokens one at a
    time, all requests together).  Returns the share of positions whose
    greedy pick (or ``picks_by[uid](position, logits)``: a keyed draw) is
    the served token, per request; the top-2 logit margin
    at every position; and for each request in ``parted`` ({uid:
    (position, the other token)}) the eager logits there: the top-2
    margin, the gap between the served and the other token, the largest
    |logit| and the gap over it."""
    import numpy as np
    import torch
    engine.reset_prefix_cache()
    uids = [uid_base + u for u in reqs]
    picks = {u: [] for u in reqs}
    margins, witness = [], {}

    def read(u, t, row):
        top = torch.topk(row, 2).values
        margins.append(float(top[0] - top[1]))
        picks[u].append(int(row.argmax()) if picks_by is None
                        else picks_by[u](t, row))
        if u in parted and parted[u][0] == t:
            a, b = served[u][t], parted[u][1]
            gap = float((row[a] - row[b]).abs())
            big = float(row.abs().max())
            witness[u] = dict(position=t, served=a, twin=b,
                              top2_margin=margins[-1], pick_gap=gap,
                              max_abs_logit=big, pick_gap_rel=gap / big)

    with eager_steps(engine):
        for u, (prompt, _) in reqs.items():
            read(u, 0, engine.put([uid_base + u], [prompt])[0])
        for t in range(1, min(len(served[u]) for u in reqs)):
            logits = engine.put(uids, [np.array([served[u][t - 1]], np.int32)
                                       for u in reqs])
            for row, u in enumerate(reqs):
                read(u, t, logits[row])
    for uid in uids:
        engine.flush(uid)
    agree = [float(np.mean(np.equal(picks[u], served[u][:len(picks[u])])))
             for u in reqs]
    return agree, margins, witness


@contextlib.contextmanager
def moe_routes(cfg, mode, routes, flips):
    """A MoE model's routing during one teacher-forced ``put``: "record"
    appends each layer's top-k experts to ``routes``; "force" routes each
    layer to the next recorded entry (``topk_routing``'s
    ``route_logits``: the same experts in the same order, weighted by
    this path's own gate), and counts in ``flips`` the token routes whose
    own top-k differs (a hard top-k turns a rounding difference in the
    router's input into another expert, and a logit gap of the size of
    the logits: held apart, the comparison isolates the kernels).  A
    dense model is left alone."""
    if not cfg.moe_num_experts:
        yield
        return
    import torch
    from deepspeed_tpu_torch.moe import layer as ML
    real, it = ML.topk_routing, iter(list(routes))

    def record(logits, k, *a, **kw):
        r = real(logits, k, *a, **kw)
        routes.append(r.experts)
        return r

    def force(logits, k, *a, **kw):
        experts = next(it)
        rank = torch.zeros(logits.shape, dtype=torch.float32,
                           device=logits.device)
        for i in range(k):
            rank.scatter_(-1, experts[i][..., None], float(k - i))
        own = real(logits, k, *a, **kw).experts
        flips[0] += int((own != experts).sum())
        flips[1] += own.numel()
        return real(logits, k, *a, route_logits=rank, **kw)

    ML.topk_routing = record if mode == "record" else force
    try:
        yield
    finally:
        ML.topk_routing = real


def plain_vs_kernel(cfg, params, model_type="llama", kv_quantization="none",
                    quantization=None):
    """The serving forward on the kernel path and on the plain path,
    both over the same page encoding, teacher-forced with the kernel
    path's greedy picks (a MoE model's other paths also with its expert
    choices, ``moe_routes``), every segment's logits compared.  Each step
    runs as the fused step runs its segments, one eager ``put`` each: the
    decode rows, then the prefill rows.  The schedule covers each segment
    kind the serving run takes: a fresh prefill (flash), decode (paged,
    Q=1), a mixed step whose prefill segment is fresh, and a mixed step
    whose prefill segment is a Q=1024-bucket chunk over 1024 tokens of
    history (paged).  Over int8 pages a third engine runs the kernel path
    over bf16 pages, and the greedy picks of the two encodings are
    compared."""
    import numpy as np
    import torch
    kw = dict(num_pages=64, model_type=model_type, quantization=quantization)
    tol = LOGIT_REL_TOL if kv_quantization == "none" else INT8_LOGIT_REL_TOL
    engines = {"kernel": build_engine(cfg, params, **kw,
                                      kv_quantization=kv_quantization),
               "plain": build_engine(cfg, params, **kw,
                                     kv_quantization=kv_quantization,
                                     implementations=PLAIN_PATH)}
    if kv_quantization != "none":
        engines["kernel, bf16 pages"] = build_engine(cfg, params, **kw)
    segments = {name: [] for name in engines}

    def segment_kind(e, uids, feed):
        seen = [e.state_manager.get_sequence(u).seen_tokens
                if e.state_manager.get_sequence(u) else 0 for u in uids]
        q = max(len(f) for f in feed)
        if q == 1:
            return "decode"
        if not any(seen):
            return "fresh"
        return f"chunk Q={1 << (q - 1).bit_length()} history<={max(seen)}"

    route_flips = [0, 0]       # (routes the plain path would choose
    #                             otherwise, routes forced)
    rng = np.random.default_rng(SEED + 1)
    p0, p1, p2 = (rng.integers(0, cfg.vocab_size, n) for n in (700, 300, 2000))
    last = {}
    # (uids, inputs) per step; None stands for the uid's last token
    schedule = ([([0, 1], [p0, p1])] + [([0, 1], [None, None])] * 2
                + [([0, 1, 2], [None, None, p2[:1024]]),
                   ([0, 1, 2], [None, None, p2[1024:]])]
                + [([0, 1, 2], [None] * 3)] * 5)
    mixed_steps = 0
    for uids, inputs in schedule:
        feed = [np.array([last[u]], np.int32) if x is None else x
                for u, x in zip(uids, inputs)]
        dec = [i for i, f in enumerate(feed) if len(f) == 1]
        pre = [i for i, f in enumerate(feed) if len(f) > 1]
        mixed_steps += bool(dec and pre)
        for group in (dec, pre):
            if not group:
                continue
            g_uids = [uids[i] for i in group]
            g_feed = [feed[i] for i in group]
            routes = []           # the kernel path's MoE choices
            for name, e in engines.items():
                kind = segment_kind(e, g_uids, g_feed)
                with eager_steps(e), moe_routes(
                        cfg, "record" if name == "kernel" else "force",
                        routes, route_flips):
                    logits = e.put(g_uids, g_feed)
                segments[name].append((kind, logits))
                if name == "kernel":
                    # teacher-force every path with the kernel path's picks
                    picks = logits.argmax(-1).tolist()
                    last.update(zip(g_uids, picks))

    worst, agree, total, kinds = 0.0, 0, 0, []
    for (kind, a), (kind_b, b) in zip(segments["kernel"], segments["plain"]):
        if kind != kind_b or a.shape != b.shape:
            raise RuntimeError(f"segments differ: {kind} vs {kind_b}")
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise RuntimeError(f"non-finite logits in a {kind} segment")
        worst = max(worst, float((a - b).abs().max() / b.abs().max()))
        agree += int((a.argmax(-1) == b.argmax(-1)).sum())
        total += a.shape[0]
        kinds.append(kind)
    res = dict(model=model_type, kv_pages=kv_quantization,
               weights=quantization or str(cfg.dtype), steps=len(schedule),
               mixed_steps=mixed_steps, segments=kinds, max_rel_logit_err=worst, tol=tol,
               greedy_agreement=agree / total, greedy_rows=total,
               greedy_min=GREEDY_AGREE_MIN)
    if cfg.moe_num_experts:
        res.update(moe_routes_forced=route_flips[1],
                   moe_routes_own_choice_differs=route_flips[0])
    if kv_quantization != "none":
        # the same kernel path over the two page encodings
        pairs = list(zip(segments["kernel"], segments["kernel, bf16 pages"]))
        same = sum(int((a.argmax(-1) == b.argmax(-1)).sum())
                   for (_, a), (_, b) in pairs)
        res["greedy_agreement_vs_bf16_pages"] = same / total
        res["max_rel_logit_err_vs_bf16_pages"] = max(
            float((a - b).abs().max() / b.abs().max())
            for (_, a), (_, b) in pairs)
    log("kernel vs plain at full width:", json.dumps(res))
    if len(segments["kernel"]) != len(segments["plain"]):
        raise RuntimeError("the two paths ran different segment counts")
    if mixed_steps != 2 or not any(k.startswith("chunk Q=1024") for k in kinds):
        raise RuntimeError(f"the schedule missed a segment kind: {kinds}")
    if worst > tol:
        raise RuntimeError(f"kernel path logits differ from the plain path "
                           f"by {worst:.3e} > {tol}")
    if agree / total < GREEDY_AGREE_MIN:
        raise RuntimeError(f"greedy agreement {agree}/{total} below "
                           f"{GREEDY_AGREE_MIN}")
    if res.get("greedy_agreement_vs_bf16_pages", 1.0) < GREEDY_AGREE_MIN:
        raise RuntimeError(
            f"greedy picks over {kv_quantization} pages agree with bf16 "
            f"pages on {res['greedy_agreement_vs_bf16_pages']:.3f} of the "
            f"rows, below {GREEDY_AGREE_MIN}")
    return res


# ---------------------------------------------------------------------------
# the serving engine under pressure, the split step, pool sizing, and
# Mistral-7B's sliding window
# ---------------------------------------------------------------------------

def copy_yardstick(n_bytes, reps=3):
    """A plain pinned ``copy_`` of ``n_bytes``, device to host and back
    (CUDA events, the median of ``reps``): the host link's rate on this
    machine, against which offload and restore are read.  Also the host
    clock of allocating that many pinned bytes with PyTorch's host
    cache emptied first (``fresh``) and again once the block is back in
    the cache (``cached``): what an offload pays for its blob."""
    import torch
    dev = torch.empty(n_bytes, dtype=torch.uint8, device="cuda")
    alloc_ms = {}
    empty_host_cache = getattr(torch._C, "_host_emptyCache", None)
    for name in ("fresh", "cached"):
        if name == "fresh" and empty_host_cache is not None:
            empty_host_cache()
        t = time.perf_counter()
        host = torch.empty(n_bytes, dtype=torch.uint8, pin_memory=True)
        alloc_ms[name] = (time.perf_counter() - t) * 1e3
        if name == "fresh":
            del host
    res = {"pinned_alloc_ms": alloc_ms}
    for name, dst, src in (("d2h", host, dev), ("h2d", dev, host)):
        ms = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            dst.copy_(src, non_blocking=True)
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
        res[name] = dict(ms=statistics.median(ms),
                         gb_s=n_bytes / statistics.median(ms) / 1e6)
    return res


def preemption_phase(cfg, params, counters, card, ref_engine):
    """Llama-2-7B at full width (``cfg``'s layers) in the default serving
    configuration on a pool too small for its traffic: 48 pages of 64 tokens for 10 greedy
    requests (prompts of 768-1024 tokens, 128 new tokens each: about 180
    pages of full context).  The scheduler must preempt (the sequence's
    private pages to a pinned host blob) and restore, and every request
    completes at full length; ``two_passes`` holds captures and launch
    counts and runs the page audit after every warm-up step.  In the
    warm-up pass every restored page is read back and must equal its
    blob bit for bit; the timed pass neither reads back nor waits; a
    third pass of the same traffic times each offload and restore
    (synchronised) against a plain pinned copy of the same bytes.  The
    tokens are held
    to the same requests on a 256-page engine of the same weights
    (``ref_engine``):
    free-running agreement reported with the logit gap where it parts,
    teacher-forced agreement held to GREEDY_AGREE_MIN."""
    import torch
    engine = build_engine(cfg, params, num_pages=48)
    reqs = serving_requests(cfg, lo=768, hi=1025, new_tokens=128,
                            sampled_from=10, seed=SEED + 9)
    state = engine.state_manager
    offload, restore = engine.offload_sequence, engine.restore_sequence
    events, verify, sync, mismatched = [], [True], [True], []

    def timed(fn):
        if not sync[0]:
            fn()
            return None
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    def host_allocs():
        st = torch.cuda.host_memory_stats()
        return (st.get("num_host_alloc", 0),
                st.get("host_alloc_time.total", 0))

    def offload_hook(uid):
        before = host_allocs()
        ms = timed(lambda: offload(uid))
        after = host_allocs()
        blob = state.get_sequence(uid).host_blob
        events.append(("offload", ms, blob.nbytes, blob.shape[1],
                       after[0] - before[0], (after[1] - before[1]) / 1e3))

    def restore_hook(uid):
        sd = state.get_sequence(uid)
        blob, slots = sd.host_blob, list(sd.live_slots)
        ms = timed(lambda: restore(uid))
        events.append(("restore", ms, blob.nbytes, blob.shape[1]))
        if verify[0]:
            pages = [sd.pages[i] for i in slots]
            data = state.kv_cache.data
            stores = ([data.payload, data.scale] if hasattr(data, "payload")
                      else [data])
            parts = ([blob.payload, blob.scale] if hasattr(blob, "payload")
                     else [blob])
            for store, part in zip(stores, parts):
                if not torch.equal(store[:, pages].cpu(), part):
                    mismatched.append(uid)

    engine.offload_sequence, engine.restore_sequence = (offload_hook,
                                                        restore_hook)
    passes, current = {}, [None]

    def count_pass(name):
        if current[0] is not None:
            passes[current[0]] = list(events)
        current[0] = name
        verify[0], sync[0] = name == "warm-up", name != "timed"
        events.clear()

    try:
        summary, launches, generated, _ = two_passes(
            engine, reqs, cfg, counters, card, "llama, 48 pages",
            audit=True, before_pass=count_pass)
        engine.reset_prefix_cache()
        count_pass("offload timing")
        t = time.perf_counter()
        drive(engine, reqs, uid_base=5000)
        timing_pass_s = time.perf_counter() - t
    finally:
        del engine.offload_sequence, engine.restore_sequence
    count_pass(None)
    counts = {name: dict(preemptions=sum(e[0] == "offload" for e in ev),
                         restores=sum(e[0] == "restore" for e in ev))
              for name, ev in passes.items()}
    timed_ev = passes["offload timing"]
    largest = max((e[2] for e in timed_ev), default=0)
    yard = copy_yardstick(largest) if largest else None

    def rates(kind):
        ev = [e for e in timed_ev if e[0] == kind]
        if not ev:
            return None
        res = dict(count=len(ev), pages=[e[3] for e in ev],
                   ms=[e[1] for e in ev], bytes=[e[2] for e in ev],
                   gb_s=[e[2] / e[1] / 1e6 for e in ev],
                   ms_median=statistics.median(e[1] for e in ev))
        if kind == "offload":
            # new pinned blocks the host allocator made for the blob, and
            # the ms it spent in the CUDA call that made them
            res.update(new_pinned_blocks=[e[4] for e in ev],
                       pinned_alloc_ms=[e[5] for e in ev])
        return res
    # the same requests on the 256-page engine: free-running, then the
    # preempted engine's tokens teacher-forced through its eager forward
    ref_engine.reset_prefix_cache()
    ref_tokens = drive(ref_engine, reqs, uid_base=6000)[0]
    parted = {u: next(t for t, (a, b) in enumerate(zip(generated[u],
                                                         ref_tokens[u]))
                      if a != b)
              for u in reqs if generated[u] != ref_tokens[u]}
    agree, margins, witness = teacher_forced_agreement(
        ref_engine, reqs, generated, uid_base=7000,
        parted={u: (t, ref_tokens[u][t]) for u, t in parted.items()})
    res = dict(summary, pool_pages=48, pool_gb=engine.model.kv_config
               .total_bytes() / 1e9, passes=counts,
               offload=rates("offload"), restore=rates("restore"),
               pinned_copy_yardstick=yard,
               offload_timing_pass_s=timing_pass_s,
               restored_pages_bit_equal=not mismatched,
               free_running_agreement_vs_256_pages=[
                   float(sum(a == b for a, b in zip(generated[u],
                                                    ref_tokens[u]))
                         / len(ref_tokens[u])) for u in reqs],
               first_parting=witness,
               top2_margin_median=float(statistics.median(margins)),
               greedy_agreement_teacher_forced=agree,
               greedy_min=GREEDY_AGREE_MIN)
    log("preemption at full width:", json.dumps(res))
    for name, c in counts.items():
        if c["preemptions"] < 1 or c["restores"] != c["preemptions"]:
            raise RuntimeError(f"{name} pass: {c}: expected at least one "
                               "preemption and as many restores")
    if mismatched:
        raise RuntimeError(f"restored pages differ from their blobs: "
                           f"{mismatched}")
    if min(agree) < GREEDY_AGREE_MIN:
        raise RuntimeError(f"the preempted engine's tokens agree with the "
                           f"256-page engine's picks on {min(agree):.3f}, "
                           f"below {GREEDY_AGREE_MIN}")
    wide = {u: w for u, w in witness.items()
            if w["pick_gap_rel"] > LOGIT_REL_TOL}
    if wide:
        raise RuntimeError(f"a parting from the 256-page engine is no "
                           f"near-tie: {wide}")
    return res, launches


def split_phase(cfg, params, counters, card, fused_engine, fused_tokens,
                fused_summary, flags):
    """The Llama engine on the split escape hatch (``flags``:
    ``fused_step=False``, or ``on_device_sampling=False``) serving phase
    4's traffic: ``serve`` (the warm-up pass captures the logits keys,
    the timed pass none; launch counts exact; every logits key's replay
    against its eager body, greedy picks bit-equal; profiled decode
    steps).  The greedy requests' tokens, teacher-forced through the
    fused engine's eager forward, must agree on GREEDY_AGREE_MIN."""
    import gc
    import torch
    label = "llama, " + ", ".join(f"{k}={v}" for k, v in flags.items())
    summary, launches, engine, reqs, generated = serve(
        cfg, params, counters, card, label=label, **flags)
    kinds = {key_kind(k) for k in engine.model.dispatch_counts}
    if kinds != {"logits"}:
        raise RuntimeError(f"{label}: dispatched {kinds}, not logits keys")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    greedy = {u: r for u, r in reqs.items() if r[1].temperature <= 0.0}
    agree, _, _ = teacher_forced_agreement(
        fused_engine, greedy, generated, uid_base=8000, parted={})
    res = dict(model=label, card=card,
               decode_step_ms_median=summary["decode_step_ms_median"],
               decode_busy_share=summary["decode_profile"][
                   "device_busy_share"],
               fused_decode_step_ms_median=fused_summary[
                   "decode_step_ms_median"],
               fused_decode_busy_share=fused_summary["decode_profile"][
                   "device_busy_share"],
               logits_graphs=summary["warm_up_pass"]["graphs"],
               free_running_agreement_vs_fused=[
                   float(sum(a == b for a, b in zip(generated[u],
                                                    fused_tokens[u]))
                         / len(fused_tokens[u])) for u in greedy],
               greedy_agreement_teacher_forced=agree,
               greedy_min=GREEDY_AGREE_MIN)
    log("split step:", json.dumps(res))
    if min(agree) < GREEDY_AGREE_MIN:
        raise RuntimeError(f"{label}: greedy agreement with the fused path "
                           f"{min(agree):.3f} below {GREEDY_AGREE_MIN}")
    return res, launches


def sizing_phase(cfg, params, counters, card, reqs, **serving):
    """One Llama engine built with no ``kv_config``: the pool is sized
    from free device memory (``memory_fraction`` of it), held to that
    budget, then serves phase 4's traffic once, which shows the graphs
    and activations fit beside it.  ``serving`` sets the engine's
    ServingOptimizationConfig; with a draft trunk (``spec_drafter``
    "model") the target pool and the draft pool together are held to
    the budget."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import (
        InferenceEngineV2, RaggedInferenceEngineConfig,
        ServingOptimizationConfig, StateManagerConfig, implementation_for)
    read = []
    free_device_memory = InferenceEngineV2._free_device_memory

    def recorded(device):
        read.append(free_device_memory(device))
        return read[-1]

    model = implementation_for("llama")(cfg, params, device="cuda")
    InferenceEngineV2._free_device_memory = staticmethod(recorded)
    try:
        engine = InferenceEngineV2(model, RaggedInferenceEngineConfig(
            state_manager=StateManagerConfig(
                max_tracked_sequences=16, max_ragged_sequence_count=16,
                max_ragged_batch_size=2048),
            serving=ServingOptimizationConfig(**serving)))
    finally:
        InferenceEngineV2._free_device_memory = staticmethod(
            free_device_memory)
    kv = model.kv_config
    fraction = engine._config.state_manager.memory_fraction
    budget = fraction * read[0]
    draft = engine.draft_kv
    # bytes a page takes in the draft pool (0 without a draft trunk)
    draft_bpp = 0 if draft is None else (draft[:, 0].numel()
                                         * draft.element_size())
    reset_launches(counters)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    generated, _, _ = drive(engine, reqs, uid_base=9000)
    launches = read_launches(counters)
    res = dict(card=card, serving=serving, free_bytes_at_build=read[0],
               memory_fraction=fraction, pages=kv.num_pages,
               bytes_per_page=kv.bytes_per_page,
               pool_gb=kv.num_pages * kv.bytes_per_page / 1e9,
               pool_gb_with_null_page=kv.total_bytes() / 1e9,
               draft_layers=engine._draft_layers,
               draft_pool_gb=kv.num_pages * draft_bpp / 1e9,
               draft_pool_gb_with_null_page=(kv.num_pages + 1) * draft_bpp
               / 1e9,
               budget_gb=budget / 1e9, serve_s=time.perf_counter() - t,
               graphs=graph_report(model)["graphs"],
               max_memory_allocated_gb=torch.cuda.max_memory_allocated()
               / 1e9, tokens=sum(len(v) for v in generated.values()))
    log("KV pool sizing:", json.dumps(res))
    if model.kv_config_explicit \
            or kv.num_pages * (kv.bytes_per_page + draft_bpp) > budget:
        raise RuntimeError(
            f"pools {res['pool_gb'] + res['draft_pool_gb']:.2f} GB over the "
            f"budget {res['budget_gb']:.2f} GB")
    return res, launches


# ---------------------------------------------------------------------------
# phase 6d: speculative decoding at full width
# ---------------------------------------------------------------------------

SPEC_MAX_DRAFT = 3
SPEC_MOTIF = 32                # tokens of the motif a spec prompt repeats
# Floor of the self-draft's accept rate.  If each of a row's k drafts is
# the target's own pick with probability p (the teacher-forced greedy
# agreement), the verify commits the leading run: p + p^2 + ... + p^k
# drafts on average, an accept rate of that over k.  At the agreement
# floor p = GREEDY_AGREE_MIN = 0.75 and k = 3: (0.75 + 0.5625 +
# 0.421875) / 3 = 0.578.
SPEC_ACCEPT_MIN = sum(GREEDY_AGREE_MIN ** i
                      for i in range(1, SPEC_MAX_DRAFT + 1)) / SPEC_MAX_DRAFT
# the three engines: (label, serving flags, passes)
SPEC_ENGINES = (("ngram", dict(spec_drafter="ngram"), 2),
                ("model", dict(spec_drafter="model", spec_draft_layers=0), 2),
                ("auto", dict(spec_drafter="auto", spec_draft_layers=8), 1))


def spec_requests(cfg):
    """Phase 4's traffic (prompt lengths, 64 new tokens, 8 greedy and 2
    sampled) with each prompt a seeded 32-token motif repeated to its
    length, so that the n-gram drafter has something to draft."""
    import numpy as np
    rng = np.random.default_rng(SEED + 6)
    return {uid: (np.resize(rng.integers(0, cfg.vocab_size, SPEC_MOTIF),
                            len(prompt)), sp)
            for uid, (prompt, sp) in serving_requests(cfg).items()}


def spec_profile(engine, reqs, label, n_steps=4):
    """The requests again (new uids, 32 new tokens), stepped until each
    has two tokens, then ``n_steps`` steps under torch.profiler: the keys
    they dispatched and the device ms per step by kernel kind."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import (FastGenScheduler,
                                                  SamplingParams)
    from torch.profiler import ProfilerActivity, profile
    model = engine.model
    sched = FastGenScheduler(engine, seed=SEED)
    got = {}
    for uid, (prompt, sp) in reqs.items():
        sched.submit(100 + uid, prompt, SamplingParams(
            max_new_tokens=32, temperature=sp.temperature, top_p=sp.top_p))
    while min((len(got.get(100 + u, ())) for u in reqs), default=0) < 2:
        sched.step(on_token=lambda u, t: got.setdefault(u, []).append(t))
    torch.cuda.synchronize()
    before, capture_s = dict(model.dispatch_counts), model.capture_seconds
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            sched.step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    keys = {repr(k): n - before.get(k, 0)
            for k, n in model.dispatch_counts.items() if n != before.get(k, 0)}
    if model.capture_seconds != capture_s:
        raise RuntimeError("a profiled spec step captured a graph")
    sched.run_to_completion()
    n_kernels, by_kind = device_ms_by_kind(prof)
    res = dict(model=label, steps=n_steps, keys=keys,
        device_kernels_per_step=n_kernels / n_steps,
        device_ms_per_step=sum(by_kind.values()) / n_steps,
        wall_ms_per_step_profiled=wall_ms / n_steps,
        device_ms_per_step_by_kind={k: v / n_steps
                                    for k, v in by_kind.items()})
    log(f"{label} spec step profile:", json.dumps(res))
    return res


def spec_phase(cfg, params, counters, card, phase4):
    """Speculative decoding at full width: the Llama-2-7B weights on 256
    pages, ``spec_max_draft=3``, ``spec_requests``' traffic, on three
    engines: the n-gram drafter, the self-draft (``spec_drafter="model"``
    over all 32 layers, a second 256-page pool) and "auto" with an
    8-layer draft trunk.  The first two take a warm-up and a timed pass
    (``two_passes``: no capture in the timed pass, a replay at every
    step, launch counts held to the segments of the keys dispatched,
    the page audit after every warm-up step) and the replay-vs-eager
    pass (every spec and draft_spec key's verdict bit-equal to its eager
    body); "auto" serves one pass with the audit.  Each engine's greedy
    tokens, teacher-forced through a spec-off engine's eager forward,
    agree at or above GREEDY_AGREE_MIN; the self-draft's accept rate is
    at or above SPEC_ACCEPT_MIN; the n-gram engine verifies at least one
    drafted row.  Returns ({label: summary}, {path: launches})."""
    import gc
    import torch
    reqs = spec_requests(cfg)
    greedy = {u: r for u, r in reqs.items() if r[1].temperature <= 0.0}
    teacher = build_engine(cfg, params, num_pages=256)
    results, launches_by_path = {}, {}
    for label, flags, passes in SPEC_ENGINES:
        engine = build_engine(cfg, params, num_pages=256, speculative=True,
                              spec_max_draft=SPEC_MAX_DRAFT, **flags)
        scheds = []

        def after(sched, _s=scheds):
            if not _s or _s[-1] is not sched:
                _s.append(sched)

        name = f"llama spec {label}"
        if passes == 2:
            summary, launches, generated, dispatches = two_passes(
                engine, reqs, cfg, counters, card, name, audit=True,
                after_step=after)
            launches_by_path[f"serving_llama_spec_{label}"] = launches
            steps = None
        else:
            reset_launches(counters)
            t = time.perf_counter()
            generated, _, steps = drive(engine, reqs, uid_base=1000,
                                        record=True, audit=True,
                                        after_step=after)
            summary = dict(card=card, model=name, pass_s=time.perf_counter()
                           - t, graphs=graph_report(engine.model),
                           launches=read_launches(counters))
            dispatches = {}
            for st in steps:
                if st["key"] is not None:
                    dispatches[st["key"]] = dispatches.get(st["key"], 0) + 1
        sched = scheds[-1]
        kinds = {}
        for k, n in dispatches.items():
            kinds[key_kind(k)] = kinds.get(key_kind(k), 0) + n
        res = dict(card=card, model=name, serving=flags,
                   spec_max_draft=SPEC_MAX_DRAFT,
                   draft_layers=engine._draft_layers,
                   draft_pool_gb=(0.0 if engine.draft_kv is None else
                                  engine.draft_kv.numel()
                                  * engine.draft_kv.element_size() / 1e9),
                   drafted=sched._spec_drafted_cum,
                   accepted=sched._spec_accepted_cum,
                   accept_rate=(sched._spec_accepted_cum
                                / sched._spec_drafted_cum
                                if sched._spec_drafted_cum else None),
                   draft_trunk_drafted=sched._spec_draft_drafted_cum,
                   draft_trunk_accepted=sched._spec_draft_accepted_cum,
                   spec_dispatches=sched._spec_steps,
                   committed_per_spec_dispatch=(
                       sched._spec_committed_cum / sched._spec_steps
                       if sched._spec_steps else None),
                   dispatches_by_kind=kinds,
                   drafter_switches={f"{a}->{b}": n for (a, b), n
                                     in sched.spec_switches.items()},
                   phase4_tail_tok_s=phase4["tail_tok_s"])
        if steps is None:
            res.update({k: summary[k] for k in (
                "steps", "total_s", "ttft_ms_mean", "tail_tok_s",
                "decode_step_ms_median", "step_ms_by_kind", "warm_up_pass",
                "keys_dispatched", "segments", "launch_checks")})
            engine.reset_prefix_cache()
            res["replay_vs_eager"] = replay_vs_eager(engine, reqs,
                                                     dispatches, name)
            engine.reset_prefix_cache()
            res["profile"] = spec_profile(engine, reqs, name)
        else:
            by = {}
            for st in steps:
                by.setdefault(step_kind(st["key"]), []).append(st["ms"])
            res.update(summary, steps=len(steps), step_ms_by_kind={
                k: dict(count=len(v), mean=sum(v) / len(v))
                for k, v in by.items()})
            res["tail_tok_s"] = tail_tok_s(steps)
        res["ms_per_spec_dispatch"] = {
            k: v["mean"] for k, v in res["step_ms_by_kind"].items()
            if k in ("spec", "draft_spec")}
        agree, _, _ = teacher_forced_agreement(
            teacher, greedy, {u: generated[u] for u in greedy},
            uid_base=7000, parted={})
        res["greedy_agreement_vs_spec_off"] = agree
        res["greedy_min"] = GREEDY_AGREE_MIN
        res["accept_min"] = SPEC_ACCEPT_MIN if label == "model" else None
        results[label] = res
        log(f"speculative serving, {label}:", json.dumps(res))
        if min(agree) < GREEDY_AGREE_MIN:
            raise RuntimeError(f"{name}: greedy agreement with the spec-off "
                               f"engine {min(agree):.3f} < "
                               f"{GREEDY_AGREE_MIN}")
        if label == "ngram" and not (kinds.get("spec")
                                     and sched._spec_drafted_cum):
            raise RuntimeError(f"{name}: no drafted n-gram verify dispatch")
        if label == "model" and not (res["accept_rate"] or 0.0) \
                >= SPEC_ACCEPT_MIN:
            raise RuntimeError(f"{name}: accept rate {res['accept_rate']} "
                               f"below {SPEC_ACCEPT_MIN:.3f}")
        if label != "ngram" and not kinds.get("draft_spec"):
            raise RuntimeError(f"{name}: the draft trunk never drafted")
        del engine, sched, scheds
        gc.collect()
        torch.cuda.empty_cache()
    del teacher
    gc.collect()
    torch.cuda.empty_cache()
    return results, launches_by_path


# ---------------------------------------------------------------------------
# phases 6e and 6f: keyed sampling and snapshots at full width
# ---------------------------------------------------------------------------

# Floor of the teacher-forced agreement of keyed picks.  A keyed pick is
# the argmax of l / T + g over the row's support (g: the row key's gumbel
# noise), and the eager forward that teacher-forces it runs at other row
# counts than the served step, so l differs by bf16 rounding; a pick
# flips only where the top two perturbed scores lie within that
# difference.  The gap between the largest two of i.i.d. standard
# gumbels is Exp(1) whatever their number, so the noise keeps the top two
# apart even where the logits tie (the worst case of a greedy pick, whose
# top-2 logit gap can be 0): at T = 0.8 a rounding difference d flips a
# keyed pick with probability about d / 0.8 at most, no more often than
# a greedy pick of near-tied logits.  The greedy floor holds it.
KEYED_AGREE_MIN = GREEDY_AGREE_MIN
KEYED_TOP_K, KEYED_TOP_P = 50, 0.95
KEYED_RECORDED_STEPS = 4
SNAP_PAGES = 64                # phase 6f's pools: 2.15 GB each


def keyed_requests(cfg):
    """Phase 4's prompts and lengths with 4 greedy and 6 sampled requests
    (temperature 0.8): uids 4-6 with top_k=50, uids 7-9 with top_p=0.95."""
    from deepspeed_tpu_torch.inference.v2 import SamplingParams
    reqs = {}
    for uid, (prompt, sp) in serving_requests(cfg, sampled_from=4).items():
        if uid >= 4:
            sp = SamplingParams(
                max_new_tokens=sp.max_new_tokens, temperature=0.8,
                top_k=KEYED_TOP_K if uid < 7 else 0,
                top_p=1.0 if uid < 7 else KEYED_TOP_P)
        reqs[uid] = (prompt, sp)
    return reqs


def keyed_picks(reqs, uid_base=0):
    """{uid: pick(position, logits row)}: the keyed draw that serving
    makes for the request's token at that generation index (the argmax
    for a greedy request), from the scheduler's base key ``key(SEED)``
    and the request's served uid ``uid_base + uid``."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import sampling as S
    from deepspeed_tpu_torch.inference.v2 import threefry

    def pick_for(uid, sp):
        def pick(t, row):
            dev = row.device

            def one(v, dtype):
                return torch.tensor([v], dtype=dtype, device=dev)

            keys = S.derive_row_keys(threefry.key_from_seed(SEED, dev),
                                     one(uid_base + uid, torch.int32),
                                     one(t, torch.int32))
            return int(S.sample_keyed(
                row[None].float(), keys, one(sp.temperature, torch.float32),
                one(sp.top_k, torch.int32), one(sp.top_p, torch.float32))[0])
        return pick

    return {uid: pick_for(uid, sp) for uid, (_, sp) in reqs.items()}


def free_running(served, ref):
    """Per request: the tokens equal to ``ref``'s before they part, and
    where they part (None: never)."""
    res = {}
    for u, toks in served.items():
        n = next((i for i, (a, b) in enumerate(zip(toks, ref[u])) if a != b),
                 None)
        res[u] = dict(agree_before_parting=(n if n is not None
                                            else len(toks)) / len(toks),
                      parts_at=n)
    return res


def keyed_draw_vs_cpu(engine, reqs):
    """The keyed draw of ``KEYED_RECORDED_STEPS`` sampling steps of the
    traffic (run on the eager bodies, each step's fp32 logits, base key,
    uids, positions and sampling rows recorded) made on the card and by
    the CPU on the same inputs: row keys and random bits bit-equal,
    gumbel noise within 2 ulp of max(|g|, 1), tokens equal except at a
    near-tie (the top two perturbed CPU scores within twice the largest
    difference between the card's and the CPU's perturbed scores of that
    row), whose count is reported."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.inference.v2 import FastGenScheduler
    from deepspeed_tpu_torch.inference.v2 import SamplingParams
    from deepspeed_tpu_torch.inference.v2 import sampling as S
    from deepspeed_tpu_torch.inference.v2 import threefry as TF
    model = engine.model
    recorded, draw = [], model._sample_tokens

    def record(logits, rng, temps, top_ks, top_ps, row_uids, row_pos,
               greedy_only):
        if row_uids is not None and not greedy_only \
                and len(recorded) < KEYED_RECORDED_STEPS:
            recorded.append([x.clone() for x in (
                logits, rng, temps, top_ks, top_ps, row_uids, row_pos)])
        return draw(logits, rng, temps, top_ks, top_ps, row_uids, row_pos,
                    greedy_only)

    engine.reset_prefix_cache()
    model._sample_tokens = record
    try:
        with eager_steps(engine):
            sched = FastGenScheduler(engine, seed=SEED)
            for uid, (prompt, sp) in reqs.items():
                sched.submit(4000 + uid, prompt, SamplingParams(
                    max_new_tokens=KEYED_RECORDED_STEPS,
                    temperature=sp.temperature, top_k=sp.top_k,
                    top_p=sp.top_p))
            sched.run_to_completion()
    finally:
        del model._sample_tokens
    if len(recorded) < KEYED_RECORDED_STEPS:
        raise RuntimeError(f"recorded {len(recorded)} keyed sampling steps")
    res = dict(steps=len(recorded), rows=0, sampled_rows=0, keys_equal=True,
               bits_equal=True, gumbel_max_ulp=0.0, tokens_equal=0,
               near_tie_partings=[], other_partings=[])
    for logits, base, temps, top_ks, top_ps, uids, pos in recorded:
        V = logits.shape[1]
        kd = S.derive_row_keys(base, uids, pos)
        kc = S.derive_row_keys(base.cpu(), uids.cpu(), pos.cpu())
        res["keys_equal"] &= torch.equal(kd.cpu(), kc)
        res["bits_equal"] &= torch.equal(TF.random_bits(kd, V).cpu(),
                                         TF.random_bits(kc, V))
        gd, gc = TF.gumbel(kd, V).cpu(), TF.gumbel(kc, V)
        spacing = torch.from_numpy(np.spacing(
            torch.clamp(gc.abs(), min=1.0).numpy()))
        res["gumbel_max_ulp"] = max(res["gumbel_max_ulp"], float(
            ((gd - gc).abs() / spacing).max()))
        td = S.sample_keyed(logits, kd, temps, top_ks, top_ps).cpu()
        args_c = [x.cpu() for x in (logits, kc, temps, top_ks, top_ps)]
        tc = S.sample_keyed(*args_c)
        res["rows"] += len(td)
        res["sampled_rows"] += int((temps > 0).sum())
        res["tokens_equal"] += int((td == tc).sum())
        ld = S._filter_rows(logits, temps, top_ks, top_ps)[0].cpu()
        lc = S._filter_rows(*[args_c[0]] + args_c[2:])[0]
        for r in torch.nonzero(td != tc).flatten().tolist():
            sd, sc = gd[r] + ld[r], gc[r] + lc[r]
            both = torch.isfinite(sd) & torch.isfinite(sc)
            noise = float((sd - sc)[both].abs().max())
            top2 = torch.topk(sc, 2).values
            gap = float(top2[0] - top2[1])
            row = dict(card=int(td[r]), cpu=int(tc[r]), top2_gap=gap,
                       noise=noise)
            ok = gap <= 2 * noise and bool(torch.isfinite(sc[td[r]]))
            res["near_tie_partings" if ok else "other_partings"].append(row)
    return res


def keyed_draw_cost(S_rows=16, V=32000):
    """The keyed draw alone at the decode step's shape (16 rows, Llama's
    vocab, the phase's sampling mix), each captured as a CUDA graph as a
    step captures it: device µs a replay (torch.profiler's kernel time
    over 20 replays) and kernels a replay, for the whole keyed draw
    (filter, row keys, noise, argmax), its keys and noise alone, and the
    generator draw it replaces (``sample_dynamic``)."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import sampling as S
    from deepspeed_tpu_torch.inference.v2 import threefry as TF
    from deepspeed_tpu_torch.ops.kernel_loader import CountedGraph
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device="cuda").manual_seed(SEED)
    logits = torch.randn(S_rows, V, generator=g, device="cuda") * 3
    temps = torch.full((S_rows,), 0.8, device="cuda")
    temps[:4] = 0.0
    top_ks = torch.zeros(S_rows, dtype=torch.int32, device="cuda")
    top_ks[4:7] = KEYED_TOP_K
    top_ps = torch.ones(S_rows, device="cuda")
    top_ps[7:10] = KEYED_TOP_P
    base = TF.key_from_seed(SEED, "cuda")
    uids = torch.arange(S_rows, dtype=torch.int32, device="cuda")
    pos = torch.full((S_rows,), 100, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bodies = {
        "keyed_draw": (None, lambda: S.sample_keyed(
            logits, S.derive_row_keys(base, uids, pos), temps, top_ks,
            top_ps)),
        "keyed_noise": (None, lambda: TF.gumbel(
            S.derive_row_keys(base, uids, pos), V)),
        "generator_draw": (gen, lambda: S.sample_dynamic(
            logits, gen, temps, top_ks, top_ps))}
    res = {}
    for name, (generator, body) in bodies.items():
        graph = CountedGraph(generator=generator)
        graph.capture(body)
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                graph.replay()
            torch.cuda.synchronize()
        n_kernels, by_kind = device_ms_by_kind(prof)
        res[name] = dict(device_us=1e3 * sum(by_kind.values()) / 20,
                         kernels=n_kernels / 20,
                         event_ms=cuda_ms(graph.replay, 20))
        del graph
    return res


def keyed_phase(cfg, params, counters, card, phase4):
    """Keyed sampling at full width: the Llama-2-7B weights on 256 pages
    with ``keyed_sampling=True``, ``keyed_requests``' traffic, as phase 4
    (``two_passes``: no capture in the timed pass, launch counts exact;
    every key's replay against its eager body, sampled rows included,
    bit-equal), then the keyed draw on the card against the CPU's over
    recorded steps, the six sampled requests again with staggered submits
    (free-running against the timed pass reported, teacher-forced keyed
    agreement held to KEYED_AGREE_MIN), one profiled keyed decode step
    and the keyed draw's own device µs.  Returns (summary, launches)."""
    import gc
    import torch
    from deepspeed_tpu_torch.inference.v2 import FastGenScheduler
    reqs = keyed_requests(cfg)
    engine = build_engine(cfg, params, num_pages=256, keyed_sampling=True)
    summary, launches, generated, dispatches = two_passes(
        engine, reqs, cfg, counters, card, "llama keyed")
    res = dict(card=card, model="llama keyed", **{k: summary[k] for k in (
        "steps", "total_s", "ttft_ms_mean", "decode_steps", "chained_steps",
        "decode_tok_s", "tail_tok_s", "decode_step_ms_median",
        "decode_step_ms_mean", "step_ms_by_kind", "warm_up_pass",
        "keys_dispatched", "segments", "launch_checks")})
    res["phase4"] = {k: phase4[k] for k in (
        "decode_step_ms_median", "decode_tok_s", "tail_tok_s",
        "ttft_ms_mean")}
    engine.reset_prefix_cache()
    rve = replay_vs_eager(engine, reqs, dispatches, "llama keyed")
    res["replay_vs_eager"] = rve
    if not all(r["sampled_equal"] == r["sampled_rows"]
               for r in rve["by_kind"].values() if "sampled_rows" in r):
        raise RuntimeError(f"llama keyed: a replayed keyed draw differs "
                           f"from its eager body: {rve['by_kind']}")
    draws = keyed_draw_vs_cpu(engine, reqs)
    res["draw_vs_cpu"] = draws
    log("llama keyed draw, card against CPU:", json.dumps(draws))
    if not (draws["keys_equal"] and draws["bits_equal"]) \
            or draws["gumbel_max_ulp"] > 2.0 or draws["other_partings"]:
        raise RuntimeError(f"llama keyed: the keyed draw on the card is not "
                           f"the CPU's: {draws}")
    # the sampled requests again, one submitted every other step (last
    # first), under the timed pass's uids: other batches, steps and slots
    sampled = {u: r for u, r in reqs.items() if r[1].temperature > 0.0}
    engine.reset_prefix_cache()
    sched = FastGenScheduler(engine, seed=SEED)
    queue, stagger, step = sorted(sampled, reverse=True), {}, 0
    while queue or sched.has_work:
        if queue and step % 2 == 0:
            u = queue.pop(0)
            sched.submit(u, *sampled[u])
        sched.step(on_token=lambda u, t: stagger.setdefault(u, []).append(t))
        step += 1
    torch.cuda.synchronize()
    free = free_running(stagger, generated)
    parted = {u: (f["parts_at"], generated[u][f["parts_at"]])
              for u, f in free.items() if f["parts_at"] is not None}
    agree, _, witness = teacher_forced_agreement(
        engine, sampled, stagger, uid_base=7000, parted=parted,
        picks_by=keyed_picks(sampled))
    res["staggered"] = dict(steps=step, free_running=free,
                            parted_logits=witness,
                            teacher_forced_keyed_agreement=agree,
                            floor=KEYED_AGREE_MIN)
    log("llama keyed, staggered submits:", json.dumps(res["staggered"]))
    if min(agree) < KEYED_AGREE_MIN:
        raise RuntimeError(f"llama keyed: teacher-forced keyed agreement "
                           f"{min(agree):.3f} < {KEYED_AGREE_MIN}")
    engine.reset_prefix_cache()
    res["decode_profile"] = profile_decode_steps(
        engine, reqs, "llama keyed", summary["decode_step_ms_median"],
        n_steps=1)
    res["draw_cost"] = keyed_draw_cost()
    log("llama keyed serving:", json.dumps(res))
    del engine, sched
    gc.collect()
    torch.cuda.empty_cache()
    return res, launches


def snapshot_phase(cfg, params, counters, card):
    """Snapshot and restore at full width: the Llama-2-7B weights on a
    ``SNAP_PAGES`` keyed engine serve 2 greedy and 2 keyed-sampled
    requests (prompts 128-512, 64 new tokens) once uninterrupted, then
    again with one ``snapshot(path)`` once every request has 16 tokens
    (a temporary directory, deleted after), ``restore(path)`` into a
    fresh scheduler over a second engine on the same weights and the run
    to completion.  The restored pages are held bit-equal to the bundle's;
    the resumed run's launch counts exactly to its keys' segments (a key
    captured in it adds its eager warm-up); the tokens against the
    uninterrupted run free-running (reported, with the logits where they
    part) and teacher-forced (keyed picks, held to KEYED_AGREE_MIN).
    Reports bundle bytes and pages, snapshot ms (the drain and export,
    then the write), write GB/s, read and restore ms (the restore
    captures the bundle's keys), the first token after the restore, and
    a pinned ``copy_`` of the page bytes.  Returns (summary, launches)."""
    import gc
    import os
    import tempfile
    import torch
    from deepspeed_tpu_torch.inference.v2 import FastGenScheduler
    from deepspeed_tpu_torch.inference.v2 import scheduler as SCH
    reqs = serving_requests(cfg, n=4, lo=128, hi=513, sampled_from=2,
                            seed=SEED + 11)
    a = build_engine(cfg, params, num_pages=SNAP_PAGES, keyed_sampling=True)
    ref, _, _ = drive(a, reqs)
    a.reset_prefix_cache()
    sched = FastGenScheduler(a, seed=SEED)
    for uid, (prompt, sp) in reqs.items():
        sched.submit(uid, prompt, sp)
    got = {u: [] for u in reqs}

    def on_token(u, t):
        got[u].append(t)

    while min(len(v) for v in got.values()) < 16:
        sched.step(on_token=on_token)
    times = {}

    def timed(name, fn):
        def run(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            times[name] = (time.perf_counter() - t) * 1e3
            return out
        return run

    b = build_engine(cfg, params, num_pages=SNAP_PAGES, keyed_sampling=True)
    restored = FastGenScheduler(b, seed=SEED)
    write, read = SCH.write_bundle, SCH.read_bundle
    SCH.write_bundle = timed("write_ms", write)
    SCH.read_bundle = timed("read_ms", read)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "serving.snap")
            torch.cuda.synchronize()
            t = time.perf_counter()
            bundle = sched.snapshot(path, on_token=on_token)
            snapshot_ms = (time.perf_counter() - t) * 1e3
            at_snapshot = {u: len(v) for u, v in got.items()}
            n_bytes = os.path.getsize(path)
            t = time.perf_counter()
            restored.restore(path)
            torch.cuda.synchronize()
            restore_ms = (time.perf_counter() - t) * 1e3
    finally:
        SCH.write_bundle, SCH.read_bundle = write, read
    eng_meta = bundle["meta"]["engine"]
    blob = bundle["arrays"]["page_blob"]
    col = {p: i for i, p in enumerate(eng_meta["page_ids"])}
    kv = b.state_manager.kv_cache.data
    pages_checked = pages_unequal = 0
    for m in eng_meta["sequences"]:
        sd = b.state_manager.get_sequence(m["uid"])
        for old, new in zip(m["pages"], sd.pages):
            if old:
                pages_checked += 1
                pages_unequal += not torch.equal(kv[:, new].cpu(),
                                                 blob[:, col[old]])
    # the resumed run, its launches counted from 0
    model = b.model
    keys_before = set(model._step_cache)
    before = dict(model.dispatch_counts)
    reset_launches(counters)
    first = []
    t = time.perf_counter()
    while restored.has_work:
        restored.step(on_token=lambda u, tok: (
            first or first.append(time.perf_counter() - t), on_token(u, tok)))
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t
    launches = read_launches(counters)
    counted = {k: n - before.get(k, 0) for k, n in model.dispatch_counts.items()
               if n != before.get(k, 0)}
    captured = set(model._step_cache) - keys_before
    for k in captured:                 # a capture's eager warm-up run
        counted[k] = counted.get(k, 0) + 1
    checks = launch_checks(cfg, "none", launches,
                           segment_counts(cfg, counted))
    for u, (_, sp) in reqs.items():
        if len(got[u]) != sp.max_new_tokens:
            raise RuntimeError(f"snapshot phase: request {u} has "
                               f"{len(got[u])} tokens")
    free = free_running(got, ref)
    parted = {u: (f["parts_at"], ref[u][f["parts_at"]])
              for u, f in free.items() if f["parts_at"] is not None}
    # the second engine teacher-forces: the first still holds the
    # snapshotted sequences
    agree, _, witness = teacher_forced_agreement(
        b, reqs, got, uid_base=7000, parted=parted,
        picks_by=keyed_picks(reqs))
    page_bytes = blob.numel() * blob.element_size()
    res = dict(card=card, model="llama snapshot", kv_pool_pages=SNAP_PAGES,
               requests=len(reqs), prompt_lens=[len(p) for p, _ in
                                                reqs.values()],
               tokens_at_snapshot=at_snapshot,
               bundle_bytes=n_bytes, bundle_pages=len(eng_meta["page_ids"]),
               page_bytes=page_bytes, snapshot_ms=snapshot_ms,
               write_ms=times["write_ms"],
               export_ms=snapshot_ms - times["write_ms"],
               write_gb_s=n_bytes / times["write_ms"] / 1e6,
               read_ms=times["read_ms"],
               read_gb_s=n_bytes / times["read_ms"] / 1e6,
               read_and_restore_ms=restore_ms,
               restore_capture_s=model.capture_seconds,
               restore_keys_captured=len(keys_before),
               first_token_ms_after_restore=(first[0] * 1e3 if first
                                             else None),
               resumed_run_s=resume_s, keys_captured_resuming=len(captured),
               # the first step after a restore runs on the host path and
               # forms a decode key the chained run never dispatched (the
               # JAX scheduler compiles the same key there)
               keys_captured_resuming_list=sorted(map(repr, captured)),
               pages_checked=pages_checked, pages_bit_equal=not pages_unequal,
               pinned_copy_yardstick=copy_yardstick(page_bytes),
               free_running=free, parted_logits=witness,
               teacher_forced_keyed_agreement=agree, floor=KEYED_AGREE_MIN,
               launches=launches, launch_checks=checks)
    log("llama snapshot and restore:", json.dumps(res))
    if pages_unequal or not pages_checked:
        raise RuntimeError(f"snapshot phase: {pages_unequal} of "
                           f"{pages_checked} restored pages differ from the "
                           "bundle's")
    if not all(checks.values()):
        raise RuntimeError(f"snapshot phase launch counts: {checks}")
    if min(agree) < KEYED_AGREE_MIN:
        raise RuntimeError(f"snapshot phase: teacher-forced agreement "
                           f"{min(agree):.3f} < {KEYED_AGREE_MIN}")
    del a, b, sched, restored, bundle
    gc.collect()
    torch.cuda.empty_cache()
    return res, launches


# ---------------------------------------------------------------------------
# phase 6g: a mined bucket lattice; phase 6h: the host/disk page tier;
# graph warmth across processes
# ---------------------------------------------------------------------------

LATTICE_MODES = ((1040, 1101), (300, 341))   # prompt lengths, two modes
LATTICE_BATCH = 2048         # phase 4's token budget, the miner's too
TIER_PAGES = 48              # 6h's device pool: 1.61 GB of Llama pages
TIER_HOST, TIER_DISK = 64, 64
TIER_PREFIX, TIER_SUFFIX, TIER_NEW = 1024, 64, 32
TIER_REQUESTS = 10


def lattice_requests(cfg, seed=SEED + 13):
    """6g's traffic: phase 4's shape (10 requests, 64 new tokens, uids 8
    and 9 sampled) with prompts from two modes, alternating."""
    import numpy as np
    from deepspeed_tpu_torch.inference.v2 import SamplingParams
    rng = np.random.default_rng(seed)
    reqs = {}
    for uid in range(10):
        lo, hi = LATTICE_MODES[uid % 2]
        sampled = uid >= 8
        reqs[uid] = (rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi))),
                     SamplingParams(max_new_tokens=64,
                                    temperature=0.8 if sampled else 0.0,
                                    top_p=0.9 if sampled else 1.0))
    return reqs


def mined_q_tops(cfg):
    """The Q tops ``fit_buckets`` fits to 6g's prompt lengths: the shapes
    phase 3 adds for the serving kernels."""
    from deepspeed_tpu_torch.inference.v2.lattice import fit_buckets
    return fit_buckets([len(p) for p, _ in lattice_requests(cfg).values()])


def prefill_rows(dispatches):
    """Rows the prefill segments of ``dispatches`` ({key: n}) computed,
    padding included: S * Q of every segment with Q > 1."""
    rows = 0
    for key, n in dispatches.items():
        for _, S, Q, _, _ in key_segments(key, 1):
            if Q > 1:
                rows += n * S * Q
    return rows


def lattice_phase(cfg, params, counters, card):
    """A mined bucket lattice at full width: the Llama-2-7B weights on
    256 pages with phase 4's engine settings serve 6g's traffic
    (``two_passes``) on the power-of-two lattice with the workload trace
    on; the trace is mined (``mine_lattice``, ``write_artifact``); a fresh
    engine with ``lattice="auto:<artifact>"`` captures the lattice's keys
    up front (``precompile(sampling=True)``) and serves the same traffic
    (``two_passes``: the timed pass captures nothing, launch counts
    exact).  Strict shapes are not set: a fresh step of several prompts
    pads S * Q past the token budget, a key the enumeration leaves out
    in both packages, so it is captured in the warm-up pass and
    counted.  The mined engine's greedy tokens teacher-forced through
    the power engine's eager forward are held to GREEDY_AGREE_MIN.
    Reports for both: graphs, capture seconds and pool bytes, prompt
    tokens against prefill rows computed, TTFT mean, decode step ms and
    the captures on the request path.  Returns (summary, launches)."""
    import gc
    import os
    import tempfile
    import torch
    from deepspeed_tpu_torch.inference.v2 import lattice as LAT
    from deepspeed_tpu_torch.telemetry.workload_trace import (
        get_workload_trace)
    reqs = lattice_requests(cfg)
    prompt_tokens = sum(len(p) for p, _ in reqs.values())
    res = dict(card=card, model="llama mined lattice",
               prompt_lens=[len(p) for p, _ in reqs.values()],
               prompt_tokens=prompt_tokens)
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.jsonl")
        get_workload_trace().configure(trace)
        try:
            power = build_engine(cfg, params, num_pages=256)
            p_sum, _, p_gen, p_disp = two_passes(
                power, reqs, cfg, counters, card, "llama, power lattice")
        finally:
            get_workload_trace().close()
        t = time.perf_counter()
        art = LAT.mine_lattice(LAT.load_trace_facts(trace),
                               max_ragged_batch_size=LATTICE_BATCH,
                               source=trace)
        path = LAT.write_artifact(art, os.path.join(tmp, "lattice.json"))
        mine_ms = (time.perf_counter() - t) * 1e3
        mined = build_engine(cfg, params, num_pages=256,
                             lattice=f"auto:{path}")
    model = mined.model
    t = time.perf_counter()
    keys = mined.precompile(max_prompt=max(res["prompt_lens"]),
                            sampling=True)
    torch.cuda.synchronize()
    precompile_s = time.perf_counter() - t
    path_before = {}

    def before_pass(name):
        path_before[name] = model.path_captures
    m_sum, launches, m_gen, m_disp = two_passes(
        mined, reqs, cfg, counters, card, "llama, mined lattice",
        before_pass=before_pass)
    warm_path = path_before["timed"] - path_before["warm-up"]
    timed_path = model.path_captures - path_before["timed"]
    greedy = {u: r for u, r in reqs.items() if r[1].temperature <= 0.0}
    agree, _, _ = teacher_forced_agreement(
        power, greedy, m_gen, uid_base=9000, parted={})

    def report(summary, disp, eng):
        return dict(graphs=summary["warm_up_pass"]["graphs"],
                    capture_s=summary["warm_up_pass"]["capture_s"],
                    pool_bytes=summary["warm_up_pass"]["pool_bytes"],
                    prefill_rows=prefill_rows(disp),
                    ttft_ms_mean=summary["ttft_ms_mean"],
                    decode_step_ms_median=summary["decode_step_ms_median"],
                    tail_tok_s=summary["tail_tok_s"],
                    steps=summary["steps"],
                    keys_dispatched=summary["keys_dispatched"],
                    launch_checks=summary["launch_checks"],
                    path_captures=eng.model.path_captures)
    res.update(
        power=report(p_sum, p_disp, power),
        mined=dict(report(m_sum, m_disp, mined),
                   precompiled_keys=len(keys), precompile_s=precompile_s,
                   warm_up_path_captures=warm_path,
                   timed_path_captures=timed_path),
        artifact=dict(s=art["s_buckets"], q=art["q_buckets"],
                      p=art["p_buckets"], keys=len(art["keys"]),
                      requests=art["requests"],
                      dispatches=art["dispatches"], mine_ms=mine_ms,
                      digest=mined.lattice_digest),
        free_running_agreement=[
            float(sum(a == b for a, b in zip(m_gen[u], p_gen[u]))
                  / len(p_gen[u])) for u in greedy],
        greedy_agreement_teacher_forced=agree, greedy_min=GREEDY_AGREE_MIN)
    log("llama mined lattice:", json.dumps(res))
    if timed_path:
        raise RuntimeError(f"mined lattice: the timed pass captured "
                           f"{timed_path} keys")
    if not any(q & (q - 1) for q in mined.lattice.q_tops):
        raise RuntimeError(f"mined lattice: no mined Q top "
                           f"{mined.lattice.q_tops}")
    if min(agree) < GREEDY_AGREE_MIN:
        raise RuntimeError(f"mined lattice: greedy agreement with the power "
                           f"lattice {min(agree):.3f} < {GREEDY_AGREE_MIN}")
    del power, mined, model
    gc.collect()
    torch.cuda.empty_cache()
    return res, launches


def tier_requests(cfg, n, prefix, suffix, new_tokens, seed=SEED + 17):
    """Greedy requests each with a distinct ``prefix``-token prefix (a
    shared one would keep one chain parked on the device and the tier
    would never engage) and a ``suffix``-token tail."""
    import numpy as np
    from deepspeed_tpu_torch.inference.v2 import SamplingParams
    rng = np.random.default_rng(seed)
    return {u: (rng.integers(0, cfg.vocab_size, prefix + suffix),
                SamplingParams(max_new_tokens=new_tokens))
            for u in range(n)}


def tier_phase(cfg, params, counters, card, label="llama",
               model_type="llama", kv_quantization="none",
               num_pages=TIER_PAGES, host=TIER_HOST, disk=TIER_DISK,
               n=TIER_REQUESTS, prefix=TIER_PREFIX, suffix=TIER_SUFFIX,
               new_tokens=TIER_NEW):
    """The host/disk page tier at full width: an engine on ``num_pages``
    pages with ``kv_tier_host_pages=host``, ``kv_tier_disk_pages=disk``
    (files in a temporary directory) and two sequences at a time (the
    pool holds two sequences' pages and a page of headroom each:
    admitted sequences pin their matched pages) serves ``n`` greedy
    requests with distinct prefixes twice on one scheduler (the second
    wave in reverse order), the page and tier audit after every step.  Every evicted page's device bytes
    are kept at demotion; every promoted page read back bit-equal to
    them.  Wave 2 must hit the host and the disk; its launch counts
    are held to its keys' segments (a key captured in it adds its eager
    warm-up run); its tokens, teacher-forced on the eager forward, to
    GREEDY_AGREE_MIN.  Reports demote and promote ms a page, the host
    copies and the disk's GB/s against a pinned ``copy_`` of a page, the
    host's wait for demotion's copies (the chain stall) and hit tokens by
    tier.  Returns (summary, launches of wave 2)."""
    import gc
    import tempfile
    import torch
    from deepspeed_tpu_torch.inference.v2 import FastGenScheduler
    from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import PageBlob
    reqs = tier_requests(cfg, n, prefix, suffix, new_tokens)
    tmp = tempfile.TemporaryDirectory()
    engine = build_engine(
        cfg, params, num_pages=num_pages, model_type=model_type,
        kv_quantization=kv_quantization,
        state_manager=dict(max_tracked_sequences=2,
                           max_ragged_sequence_count=2),
        kv_tier_host_pages=host, kv_tier_disk_pages=disk,
        kv_tier_dir=tmp.name)
    state = engine.state_manager
    store, cache = state.tiers, state.kv_cache
    stores = cache._stores()
    from deepspeed_tpu_torch.inference.v2.ragged import manager as MGR
    times = {k: 0.0 for k in ("demote", "promote", "read_pages", "write",
                              "read", "split", "concat", "restore",
                              "demote_in_promote")}
    counts = {k: 0 for k in ("demote_calls", "demote_pages",
                             "promote_pages", "write_bytes", "read_bytes",
                             "verified", "unequal")}
    saved = {}                 # digest -> the device bytes at demotion
    taken = []
    in_promote = []

    def sync_timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            times[name] += time.perf_counter() - t
            return out
        return run

    demote, promote = state._demote, state._promote_chain
    read_pages = cache.read_pages
    write_file = store._write_file
    # the disk reads run through the store's async I/O handle: a chain's
    # reads are submitted together and waited on (the time in both)
    aio = store._get_aio()
    if aio is None:
        raise RuntimeError(f"{label} tier: the async I/O handle did not "
                           "build")
    pread, aio_wait = aio.pread, aio.wait

    def demote_kept(entries):
        for d, p in entries:
            saved[d] = [s[:, p].clone() for s in stores]
        counts["demote_calls"] += 1
        counts["demote_pages"] += len(entries)
        before = times["demote"]
        out = sync_timed("demote", demote)(entries)
        if in_promote:       # a promotion's ensure_free demoted these
            times["demote_in_promote"] += times["demote"] - before
        return out

    def host_timed(name, fn):
        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            times[name] += time.perf_counter() - t
            return out
        return run

    def take_recorded(digests):
        blobs, tiers = take_many(digests)
        taken[:] = digests[:len(blobs)]
        return blobs, tiers

    def promote_checked(*a):
        taken.clear()
        in_promote.append(1)
        try:
            pages, cursor = sync_timed("promote", promote)(*a)
        finally:
            in_promote.clear()
        counts["promote_pages"] += len(pages)
        for d, p in zip(taken, pages):
            want = saved.pop(d)
            counts["verified"] += 1
            counts["unequal"] += not all(
                torch.equal(s[:, p], w) for s, w in zip(stores, want))
        return pages, cursor

    def write_timed(path, parts):
        counts["write_bytes"] += sum(t.nbytes for t in parts)
        return sync_timed("write", write_file)(path, parts)

    def pread_timed(arr, path, offset=0):
        counts["read_bytes"] += arr.nbytes
        return host_timed("read", pread)(arr, path, offset)

    def wait_timed(req):
        return host_timed("read", aio_wait)(req)

    def read_pages_timed(pages):
        t = time.perf_counter()
        out = read_pages(pages)
        times["read_pages"] += time.perf_counter() - t   # enqueue + alloc
        return out

    take_many = store.take_many
    state._demote, state._promote_chain = demote_kept, promote_checked
    store.take_many = take_recorded
    store._write_file = write_timed
    aio.pread, aio.wait = pread_timed, wait_timed
    cache.read_pages = read_pages_timed
    split, concat = MGR.blob_columns, MGR.concat_blobs
    restore_pages = cache.restore_pages
    MGR.blob_columns = host_timed("split", split)
    MGR.concat_blobs = host_timed("concat", concat)
    cache.restore_pages = sync_timed("restore", restore_pages)
    hits = {}
    tier_hits = engine.tier_hits

    def hits_recorded(uid):
        hits[uid] = tier_hits(uid)
        return hits[uid]
    engine.tier_hits = hits_recorded
    sched = FastGenScheduler(engine, seed=SEED)
    model = engine.model
    tokens = {}
    wave_s = []
    launches = None
    for wave in (0, 1):
        if wave:
            keys_before = set(model._step_cache)
            before = dict(model.dispatch_counts)
            reset_launches(counters)
        # wave 2 in reverse order: the last requests of wave 1 find their
        # pages still parked on the device or in the host ring, the first
        # ones on the disk
        for u in (sorted(reqs, reverse=True) if wave else sorted(reqs)):
            sched.submit(wave * 100 + u, *reqs[u])
        torch.cuda.synchronize()
        t = time.perf_counter()
        while sched.has_work:
            out = sched.step()
            for u, tok in out.items():
                tokens.setdefault(u, []).append(tok)
            state.check_invariants()
            if sched.last_step_scheduled == 0 and not out \
                    and not sched._preempted_this_step:
                raise RuntimeError(f"{label} tier phase: stalled")
        torch.cuda.synchronize()
        wave_s.append(time.perf_counter() - t)
    launches = read_launches(counters)
    counted = {k: c - before.get(k, 0) for k, c in
               model.dispatch_counts.items() if c != before.get(k, 0)}
    captured = set(model._step_cache) - keys_before
    for k in captured:                 # a capture's eager warm-up run
        counted[k] = counted.get(k, 0) + 1
    checks = launch_checks(cfg, kv_quantization, launches,
                           segment_counts(cfg, counted))
    by_tier = {w: {t: sum((hits.get(w * 100 + u) or {}).get(t, 0)
                          for u in reqs) for t in ("device", "host", "disk")}
               for w in (0, 1)}
    for u, (_, sp) in reqs.items():
        for w in (0, 1):
            if len(tokens.get(w * 100 + u, [])) != sp.max_new_tokens:
                raise RuntimeError(f"{label} tier phase: request {u} wave "
                                   f"{w} did not complete")
    wave2 = {u: tokens[100 + u] for u in reqs}
    agree = []
    engine.reset_prefix_cache()
    for pair in range(0, n, 2):       # two sequences' pages at a time
        sub = {u: reqs[u] for u in list(reqs)[pair:pair + 2]}
        agree += teacher_forced_agreement(engine, sub, wave2,
                                          uid_base=5000 + pair * 10,
                                          parted={})[0]
    st = store.stats()
    MGR.blob_columns, MGR.concat_blobs = split, concat
    page_bytes = cache.cfg.bytes_per_page
    demoted_bytes = counts["demote_pages"] * page_bytes
    promoted_bytes = counts["promote_pages"] * page_bytes
    promote_own = times["promote"] - times["demote_in_promote"]

    def per_page(seconds, pages):
        return 1e3 * seconds / pages if pages else None

    def gb_s(n_bytes, seconds):
        return n_bytes / seconds / 1e9 if seconds > 0 else None
    res = dict(
        card=card, model=f"{label} tier", kv_pages=kv_quantization,
        kv_pool_pages=num_pages, tier_host_pages=host, tier_disk_pages=disk,
        requests=n, prompt_tokens=prefix + suffix, new_tokens=new_tokens,
        page_bytes=page_bytes, tier=st, wave_s=wave_s,
        hit_tokens_by_tier={"wave_1": by_tier[0], "wave_2": by_tier[1]},
        demote_calls=counts["demote_calls"],
        demote_ms_a_page=per_page(times["demote"], counts["demote_pages"]),
        # a demotion's parts: the blob's allocation and the copies'
        # enqueue, the host's wait for the copies (the chain stall: the
        # stream may still run a step), one page's host copy out of the
        # batch blob each, and the host ring's overflow written to disk
        demote_parts_ms_a_page=dict(
            read_pages_enqueue=per_page(times["read_pages"],
                                        counts["demote_pages"]),
            chain_stall=per_page(state.demote_wait_s,
                                 counts["demote_pages"]),
            split_host_copy=per_page(times["split"],
                                     counts["demote_pages"]),
            disk_spill=per_page(times["write"], counts["demote_pages"])),
        demote_host_gb_s=gb_s(demoted_bytes,
                              times["demote"] - times["write"]),
        chain_stall_ms=1e3 * state.demote_wait_s,
        # a promotion, less the demotions its ensure_free made
        promote_ms_a_page=per_page(promote_own, counts["promote_pages"]),
        promote_parts_ms_a_page=dict(
            disk_read=per_page(times["read"], counts["promote_pages"]),
            concat_host_copy=per_page(times["concat"],
                                      counts["promote_pages"]),
            restore_h2d=per_page(times["restore"],
                                 counts["promote_pages"])),
        promote_gb_s=gb_s(promoted_bytes, promote_own),
        restore_h2d_gb_s=gb_s(promoted_bytes, times["restore"]),
        disk_write_gb_s=gb_s(counts["write_bytes"], times["write"]),
        disk_read_gb_s=gb_s(counts["read_bytes"], times["read"]),
        pinned_copy_yardstick=copy_yardstick(page_bytes),
        promoted_pages_verified=counts["verified"],
        promoted_pages_unequal=counts["unequal"],
        free_running_wave2_vs_wave1=[
            float(sum(a == b for a, b in zip(tokens[100 + u], tokens[u]))
                  / len(tokens[u])) for u in reqs],
        greedy_agreement_teacher_forced=agree, greedy_min=GREEDY_AGREE_MIN,
        wave_2_keys_captured=len(captured), launches=launches,
        launch_checks=checks)
    log(f"{label} host/disk page tier:", json.dumps(res))
    if counts["unequal"] or counts["verified"] != st["promoted_pages"] \
            or not counts["verified"]:
        raise RuntimeError(f"{label} tier phase: {counts['unequal']} of "
                           f"{counts['verified']} promoted pages differ "
                           f"({st['promoted_pages']} promoted)")
    if not (by_tier[1]["host"] and by_tier[1]["disk"]):
        raise RuntimeError(f"{label} tier phase: wave 2 hits {by_tier[1]}: "
                           "none from the host or none from the disk")
    if st["io_errors"] or st["plain_io"]:
        raise RuntimeError(f"{label} tier phase: {st['io_errors']} I/O "
                           f"errors, {st['plain_io']} plain file "
                           "operations (the async I/O handle took none)")
    if not all(checks.values()):
        raise RuntimeError(f"{label} tier phase launch counts: {checks}")
    if min(agree) < GREEDY_AGREE_MIN:
        raise RuntimeError(f"{label} tier phase: teacher-forced agreement "
                           f"{min(agree):.3f} < {GREEDY_AGREE_MIN}")
    state.close()
    del engine, sched, state, store, cache, stores, saved, model
    tmp.cleanup()
    gc.collect()
    torch.cuda.empty_cache()
    return res, launches


WARMTH_CHILD = r"""
import json, sys, time
t0 = float(sys.argv[1])
import torch
from deepspeed_tpu_torch.inference.v2 import (
    FastGenScheduler, InferenceEngineV2, KVCacheConfig,
    RaggedInferenceEngineConfig, RaggedInferenceModel, SamplingParams)
from deepspeed_tpu_torch.models.llama import llama_config
from deepspeed_tpu_torch.models.transformer import init_params
from deepspeed_tpu_torch.ops import kernel_loader
cfg = llama_config("7b")
params = init_params(cfg, seed=0, device="cuda")
torch.cuda.synchronize()
t_weights = time.time()
kv = KVCacheConfig(num_layers=cfg.num_layers, kv_heads=cfg.kv_heads,
                   head_dim=cfg.dims_per_head, page_size=64, num_pages=16,
                   dtype=torch.bfloat16)
engine = InferenceEngineV2(RaggedInferenceModel(cfg, params, kv_config=kv,
                                                device="cuda"),
                           RaggedInferenceEngineConfig())
sched = FastGenScheduler(engine)
sched.submit(0, list(range(1, 129)), SamplingParams(max_new_tokens=2))
first = None
while sched.has_work:
    if sched.step() and first is None:
        first = time.time()
print(json.dumps(dict(library_counts=kernel_loader.library_counts,
                      library_dir=str(kernel_loader.library_dir()),
                      weights_s=t_weights - t0, first_token_s=first - t0,
                      path_captures=engine.model.path_captures)))
"""


def warmth_phase(cache_dir, card):
    """Graph warmth across processes: a child process with
    ``DS_COMPILE_CACHE`` set to the directory phase 2 built into
    (``cache_dir`` is its namespaced path, ``<base>/<digest>``) builds a
    Llama-2-7B engine (weights from the seed, 16 pages) and serves one
    128-token prompt.  It must load every kernel library (hits) and build
    none (misses 0); reports the seconds from its start to its first
    token (its graphs are captured anew: a CUDA graph lives in its
    process)."""
    import os
    # the child namespaces the directory by the same digest
    env = dict(os.environ, DS_COMPILE_CACHE=os.path.dirname(cache_dir))
    t0 = time.time()
    out = subprocess.run([sys.executable, "-c", WARMTH_CHILD, repr(t0)],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=os.path.dirname(
                             os.path.abspath(__file__)))
    if out.returncode != 0:
        raise RuntimeError(f"warmth child failed:\n{out.stderr[-4000:]}")
    child = json.loads(out.stdout.strip().splitlines()[-1])
    res = dict(card=card, **child)
    log("graph warmth:", json.dumps(res))
    counts = child["library_counts"]
    if counts["misses"] or not counts["hits"] \
            or child["library_dir"] != cache_dir:
        raise RuntimeError(f"warmth child built libraries: {child}")
    return res


MISTRAL_7B = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                  num_hidden_layers=32, num_attention_heads=32,
                  num_key_value_heads=8, max_position_embeddings=32768,
                  rms_norm_eps=1e-5, rope_theta=10000.0, sliding_window=4096,
                  tie_word_embeddings=False, hidden_act="silu")
MISTRAL_LAYERS = 16            # of its 32 (phase 24's room)
MISTRAL_PAGES = 288
MISTRAL_PROMPT = 6144
MISTRAL_CHUNK = 2048           # the token budget of a step


# ---------------------------------------------------------------------------
# phases 6j and 6k: the serving fleet (a replica pool; disaggregated
# prefill/decode) at full width
# ---------------------------------------------------------------------------

# both at 16 of Llama-2-7B's 32 layers (phase 21's room: the full-depth
# serving paths are phases 4-6, 6b and 6c)
FLEET_LAYERS = 16
FLEET_PAGES = 256              # each engine of 6j and 6k: 4.31 GB
FLEET_PREFIX = 1024            # the shared prefix of the warm requests


# phases 6a and 6d-6h run at 16 of the 32 layers, on views of phase 4's
# weights (phase 21's and phase 24's room; phases 4-6, 6b and 6c serve
# all 32)
SERVING_CUT_LAYERS = 16


def depth_cut(cfg, params, layers):
    """The config and weights of the first ``layers`` layers: views of the
    stacked ``[L, ...]`` leaves, no copy."""
    from deepspeed_tpu_torch.tree import tree_map
    return (dataclasses.replace(cfg, num_layers=layers),
            {**params, "layers": tree_map(lambda t: t[:layers],
                                          params["layers"])})


def fleet_requests(cfg, seed=SEED + 19):
    """Phase 6j's traffic: 16 greedy requests, 64 new tokens each; uids
    0-7 share a 1024-token prefix with tails of 64-256 tokens, uids 8-15
    are cold prompts of 128-1024 tokens."""
    import numpy as np
    from deepspeed_tpu_torch.inference.v2 import SamplingParams
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, FLEET_PREFIX)
    reqs = {}
    for uid in range(16):
        if uid < 8:
            prompt = np.concatenate([prefix, rng.integers(
                0, cfg.vocab_size, int(rng.integers(64, 257)))])
        else:
            prompt = rng.integers(0, cfg.vocab_size,
                                  int(rng.integers(128, 1025)))
        reqs[uid] = (prompt, SamplingParams(max_new_tokens=64,
                                            temperature=0.0))
    return reqs


def halves_agreement(engine, reqs, served, uid_base, picks_by=None):
    """``teacher_forced_agreement`` over two halves of ``reqs`` (every
    request's whole context at once would not fit one pool)."""
    uids = sorted(reqs)
    agree = []
    for part in (uids[:len(uids) // 2], uids[len(uids) // 2:]):
        sub = {u: reqs[u] for u in part}
        a, _, _ = teacher_forced_agreement(
            engine, sub, {u: served[u] for u in part}, uid_base, {},
            picks_by=None if picks_by is None
            else {u: picks_by[u] for u in part})
        agree += a
    return agree


def pool_pass(pool, reqs, threaded=False):
    """One pass of ``reqs`` through a fresh ReplicaPool: uid 0 served
    alone first, the replicas' hints published, then the other 15
    submitted together and served by the step loop (or by ``start()`` /
    ``serve_until_idle()``).  Returns ({uid: tokens}, the seconds of the
    15-request part)."""
    import torch
    pool.submit(0, *reqs[0])
    pool.run_to_completion()
    pool.publish_hints()
    for uid in sorted(reqs)[1:]:
        if pool.submit(uid, *reqs[uid]) is not None:
            raise RuntimeError(f"pool refused request {uid}")
    torch.cuda.synchronize()
    t = time.perf_counter()
    if threaded:
        pool.start()
        try:
            if not pool.serve_until_idle(timeout_s=300.0):
                raise RuntimeError("pool: the threaded serve timed out")
        finally:
            pool.stop()
        if any(th.is_alive() for th in pool._threads.values()):
            raise RuntimeError("pool: a stepper thread outlived stop()")
    else:
        pool.run_to_completion()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    if pool.errors:
        raise RuntimeError(f"pool errors: {pool.errors}")
    out = pool.results()
    for uid, (_, sp) in reqs.items():
        if len(out.get(uid, ())) != sp.max_new_tokens:
            raise RuntimeError(f"pool: request {uid} has "
                               f"{len(out.get(uid, ()))} tokens")
    return out, seconds


def pool_metrics(pool, reqs, seconds):
    reqs_ = [pool.request(u) for u in sorted(reqs)[1:]]
    ttft = [(r.first_token_mono - r.submit_mono) * 1e3 for r in reqs_]
    return dict(ttft_ms_mean=sum(ttft) / len(ttft), ttft_ms_max=max(ttft),
                seconds=seconds,
                tok_s=sum(len(r.tokens) for r in reqs_) / seconds,
                placements={r.uid: (r.replica, r.matched_pages)
                            for r in reqs_})


def registry_family(prefix) -> dict:
    from deepspeed_tpu_torch.telemetry import get_registry
    return {k: v for k, v in get_registry().snapshot().items()
            if k.startswith(prefix)}


def pool_phase(cfg, params, counters, card, phase4):
    """Phase 6j: two replicas of 256 pages behind the prefix-affinity
    router (``serving.ReplicaPool``, policy "affinity").  A warm-up pass
    of ``fleet_requests`` captures the keys, then a timed pass with the
    step loop (launch counts exact over both replicas, nothing captured)
    and a threaded pass (``start`` / ``serve_until_idle``: nothing
    captured, every request's tokens equal to the step loop's); every
    warm request after the first is affinity-routed to the digest
    holder.  Then the fleet events, with telemetry on: a page fetch
    (margin 0; the fetched pages bit-equal to the holder's, ms and GB/s
    against a pinned ``copy_``), a warm spawn (``scale_up``: every key
    of the fleet's manifest captured), ``scale_down`` of a loaded
    replica (drain and migrate) and a death through the
    ``serving.preempt`` fault site with a fixed seed; every committed
    prefix survives verbatim; the flight recorder's postmortem bundle,
    written to a temporary directory, is read back.  The page audit
    (``check_invariants``, as under ``DS_KV_DEBUG=1``) runs after every
    step and import of the warm-up pass and of the fleet events, on
    every live replica after each fleet event, and after the timed and
    threaded passes.  Greedy tokens are teacher-forced on one engine's eager
    forward (held to GREEDY_AGREE_MIN).  Returns (summary, launches of the
    timed pass)."""
    import gc
    import os
    import tempfile
    import torch
    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.inference.v2 import FastGenScheduler
    from deepspeed_tpu_torch.runtime.fault_injection import get_fault_injector
    from deepspeed_tpu_torch.serving import ReplicaPool
    from deepspeed_tpu_torch.telemetry import metrics as tm
    reqs = fleet_requests(cfg)
    engines = {}

    def engine_of(label):
        if label not in engines:
            engines[label] = build_engine(cfg, params, FLEET_PAGES)
        return engines[label]

    def pool_of(audit=False, **kw):
        """A pool over the engines; ``audit``: its schedulers run the
        page audit after every step and import (``DS_KV_DEBUG=1``)."""
        for eng in engines.values():
            eng.reset_prefix_cache()

        def scheduler_of(label):
            sched = FastGenScheduler(engine_of(label), seed=SEED)
            sched._kv_debug = sched._kv_debug or audit
            return sched
        return ReplicaPool(scheduler_of, replicas=2, policy="affinity",
                           **kw)

    def audit_replicas(pool):
        for lb in pool.labels:
            pool._replicas[lb].engine.state_manager.check_invariants()

    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    pool_pass(pool_of(audit=True), reqs)                # the warm-up pass
    warm_s = time.perf_counter() - t
    labels = sorted(engines)
    # a pool built over engines that served already warms each replica
    # with the others' keys (a warm spawn, with the compile cache on):
    # that happens at the pool's build, before its pass
    before_build = {lb: len(engines[lb].model._step_cache) for lb in labels}
    pool = pool_of()
    warmed = {lb: len(engines[lb].model._step_cache) - before_build[lb]
              for lb in labels}
    cached = {lb: set(engines[lb].model._step_cache) for lb in labels}
    dispatched = {lb: dict(engines[lb].model.dispatch_counts)
                  for lb in labels}
    pool_before = registry_family("ds_pool_")
    reset_launches(counters)
    timed, timed_s = pool_pass(pool, reqs)
    launches = read_launches(counters)
    audit_replicas(pool)
    seg = None
    for lb in labels:
        model = engines[lb].model
        if set(model._step_cache) != cached[lb]:
            raise RuntimeError(
                f"pool: the timed pass captured on {lb}: "
                f"{sorted(map(repr, set(model._step_cache) - cached[lb]))}")
        d = {k: n - dispatched[lb].get(k, 0)
             for k, n in model.dispatch_counts.items()
             if n != dispatched[lb].get(k, 0)}
        if any(model._step_cache[k] is None for k in d):
            raise RuntimeError("pool: a timed step was not a replay")
        s = segment_counts(cfg, d)
        seg = s if seg is None else {k: seg[k] + s[k] for k in seg}
    checks = launch_checks(cfg, "none", launches, seg)
    timed_metrics = pool_metrics(pool, reqs, timed_s)
    holder = pool.request(0).replica
    routed = {u: (pool.request(u).replica, pool.request(u).matched_pages)
              for u in range(1, 8)}
    if any(r != (holder, FLEET_PREFIX // 64) for r in routed.values()):
        raise RuntimeError(f"pool: a warm request missed the digest holder "
                           f"{holder}: {routed}")
    counters_timed = {k: v - pool_before.get(k, 0)
                      for k, v in registry_family("ds_pool_").items()}
    del pool
    # the threaded pass: the same traffic, one stepper thread a replica
    threaded_pool = pool_of()
    cached = {lb: set(engines[lb].model._step_cache) for lb in labels}
    threaded, threaded_s = pool_pass(threaded_pool, reqs, threaded=True)
    threaded_metrics = pool_metrics(threaded_pool, reqs, threaded_s)
    audit_replicas(threaded_pool)
    differ = sorted(u for u in reqs if threaded[u] != timed[u])
    if differ:
        raise RuntimeError(f"pool: the threaded pass's tokens differ from "
                           f"the step loop's for uids {differ}")
    for lb in labels:
        new = set(engines[lb].model._step_cache) - cached[lb]
        if new:
            raise RuntimeError(f"pool: the threaded pass captured on {lb}: "
                               f"{sorted(map(repr, new))}")
    del threaded_pool
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # -- the fleet events, telemetry on --------------------------------------
    telemetry.enable()
    telemetry.get_flight_recorder().clear()
    fetch_before = {k: getattr(tm, k).value for k in (
        "POOL_PAGE_FETCHES", "POOL_PAGE_FETCH_PAGES", "POOL_PAGE_FETCH_BYTES")}
    fetch_ms_before = (tm.POOL_PAGE_FETCH_MS.sum, tm.POOL_PAGE_FETCH_MS.count)
    pool = pool_of(audit=True, page_fetch_margin=0, max_replicas=3)
    pool.submit(0, *reqs[0])
    pool.run_to_completion()
    pool.publish_hints()
    holder = pool.request(0).replica
    # cold fillers land holder, peer, holder (least backlog, then label):
    # the holder ends one request deeper, past the margin, and the next
    # warm request goes to the peer with the holder's pages fetched
    for uid in (8, 9, 10):
        pool.submit(uid, *reqs[uid])
    pool.submit(1, *reqs[1])
    fetched = pool.request(1)
    router = pool.router
    digests = router.prompt_digests(reqs[1][0])[:FLEET_PREFIX // 64]

    def pages_of(label):
        sm = pool._replicas[label].engine.state_manager
        return [sm.prefix_cache.lookup(bytes.fromhex(d)) for d in digests]

    peer = fetched.replica
    src_pages, dst_pages = pages_of(holder), pages_of(peer)
    src_kv = pool._replicas[holder].engine.state_manager.kv_cache.data
    dst_kv = pool._replicas[peer].engine.state_manager.kv_cache.data
    fetch_equal = (peer != holder and None not in src_pages
                   and None not in dst_pages and all(
                       torch.equal(src_kv[:, a], dst_kv[:, b])
                       for a, b in zip(src_pages, dst_pages)))
    fetch = {k: getattr(tm, k).value - v for k, v in fetch_before.items()}
    fetch_ms = ((tm.POOL_PAGE_FETCH_MS.sum - fetch_ms_before[0])
                / max(tm.POOL_PAGE_FETCH_MS.count - fetch_ms_before[1], 1))
    fetch["ms"] = fetch_ms
    fetch["gb_s"] = (fetch["POOL_PAGE_FETCH_BYTES"] / fetch_ms / 1e6
                     if fetch_ms else None)
    fetch["pinned_copy_yardstick"] = copy_yardstick(
        max(int(fetch["POOL_PAGE_FETCH_BYTES"] // 2), 1))
    fetch["from"], fetch["to"], fetch["bit_equal"] = holder, peer, fetch_equal
    if not fetch_equal or fetch["POOL_PAGE_FETCHES"] != 1:
        raise RuntimeError(f"pool: the page fetch failed: {fetch}")
    audit_replicas(pool)
    for uid in sorted(reqs):
        if uid not in (0, 1, 8, 9, 10):
            pool.submit(uid, *reqs[uid])
    for _ in range(6):
        pool.step()
    manifest = pool.compiled_manifest()
    t = time.perf_counter()
    spawned = pool.scale_up()                  # a warm spawn: r2
    spawn_s = time.perf_counter() - t
    spawn_keys = len(engines[spawned].model._step_cache)
    missing = set(manifest) - set(engines[spawned].model._step_cache)
    if not manifest or missing:
        raise RuntimeError(f"pool: the warm spawn did not capture "
                           f"{len(missing)} of the manifest's "
                           f"{len(manifest)} keys: "
                           f"{sorted(map(repr, missing))}")
    audit_replicas(pool)
    committed = {u: list(pool.request(u).tokens) for u in reqs}
    migrated_before = tm.POOL_MIGRATED.value
    victim = max(pool.labels, key=lambda lb: (
        pool._replicas[lb].scheduler.backlog, lb))
    t = time.perf_counter()
    if pool.scale_down(victim) != victim:
        raise RuntimeError("pool: scale_down refused")
    drain_s = time.perf_counter() - t
    migrated = tm.POOL_MIGRATED.value - migrated_before
    audit_replicas(pool)
    for _ in range(4):
        pool.step()
    committed_before_death = {u: list(pool.request(u).tokens)
                              for u in reqs}
    inj = get_fault_injector()
    deaths_before = tm.POOL_REPLICA_DEATHS.value
    inj.configure({"serving.preempt": {"at": "3", "max": "1"}}, seed=SEED)
    try:
        while tm.POOL_REPLICA_DEATHS.value == deaths_before:
            pool.step()
            if pool.idle:
                raise RuntimeError("pool: the preempt fault never fired")
    finally:
        inj.disarm()
    audit_replicas(pool)
    pool.run_to_completion()
    audit_replicas(pool)
    if pool.errors:
        raise RuntimeError(f"pool errors after the fleet events: "
                           f"{pool.errors}")
    events = pool.results()
    kept = all(events[u][:len(committed[u])] == committed[u]
               and events[u][:len(committed_before_death[u])]
               == committed_before_death[u] for u in reqs)
    with tempfile.TemporaryDirectory() as tmp:
        paths = telemetry.dump_postmortem(os.path.join(tmp, "pm"))
        with open(paths["events.json"]) as f:
            kinds = [e["kind"] for e in json.load(f)["events"]]
        with open(paths["registry.json"]) as f:
            reg = json.load(f)
    telemetry.disable()
    death_dump = dict(artifacts=sorted(paths), events=len(kinds),
                      replica_deaths=kinds.count("pool.replica_death"),
                      scale_down=kinds.count("pool.scale_down"),
                      page_fetch=kinds.count("pool.page_fetch"),
                      warm_spawn=kinds.count("pool.warm_spawn"),
                      ds_pool_replica_deaths_total=reg.get(
                          "ds_pool_replica_deaths_total"))
    if not kept or death_dump["replica_deaths"] != 1 \
            or not death_dump["scale_down"]:
        raise RuntimeError(f"pool: the fleet events lost a committed token "
                           f"or an event: kept {kept}, {death_dump}")
    live = sorted(pool.labels)
    del pool
    gc.collect()
    # teacher-forced greedy agreement on one engine's eager forward
    ref = engines["r0"]
    for eng in engines.values():
        for uid in list(eng.state_manager._seqs):
            eng.flush(uid)
    agree = halves_agreement(ref, reqs, timed, uid_base=7000)
    agree_events = halves_agreement(ref, reqs, events, uid_base=7100)
    res = dict(card=card, model="llama pool", replicas=2, policy="affinity",
               kv_pool_pages=FLEET_PAGES, requests=len(reqs),
               prompt_lens=[len(p) for p, _ in reqs.values()],
               warm_up_pass_s=warm_s, keys_warmed_at_pool_build=warmed,
               timed=timed_metrics,
               threaded=threaded_metrics,
               threaded_tokens_equal_timed=len(reqs),
               phase4={k: phase4[k] for k in (
                   "ttft_ms_mean", "decode_tok_s", "tail_tok_s",
                   "decode_step_ms_median")},
               graphs={lb: graph_report(engines[lb].model)
                       for lb in labels},
               max_memory_allocated_gb=peak_gb,
               affinity_routed=routed, digest_holder=holder,
               pool_counters_timed=counters_timed,
               page_fetch=fetch, warm_spawn=dict(label=spawned,
                                                 seconds=spawn_s,
                                                 keys=spawn_keys,
                                                 manifest_keys=len(manifest)),
               scale_down=dict(label=victim, migrated=migrated,
                               ms=drain_s * 1e3,
                               ms_a_request=(drain_s * 1e3 / migrated
                                             if migrated else None)),
               committed_prefixes_kept=kept, live_after_events=live,
               flight_recorder_dump=death_dump,
               ds_pool=registry_family("ds_pool_"),
               teacher_forced_agreement=agree,
               teacher_forced_agreement_events=agree_events,
               floor=GREEDY_AGREE_MIN, segments=seg, launches=launches,
               launch_checks=checks)
    log("llama replica pool:", json.dumps(res))
    if not all(checks.values()):
        raise RuntimeError(f"pool launch counts: {checks}")
    if min(agree + agree_events) < GREEDY_AGREE_MIN:
        raise RuntimeError(f"pool: teacher-forced agreement "
                           f"{min(agree + agree_events):.3f} < "
                           f"{GREEDY_AGREE_MIN}")
    engines.clear()
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    return res, launches


def disagg_requests(cfg):
    """Phase 6e's traffic (4 greedy, 6 keyed-sampled requests) and two
    greedy requests (uids 10, 11) sharing a 1024-token prefix."""
    import numpy as np
    from deepspeed_tpu_torch.inference.v2 import SamplingParams
    reqs = keyed_requests(cfg)
    rng = np.random.default_rng(SEED + 23)
    prefix = rng.integers(0, cfg.vocab_size, FLEET_PREFIX)
    for uid, tail in ((10, 64), (11, 128)):
        reqs[uid] = (np.concatenate([prefix, rng.integers(
            0, cfg.vocab_size, tail)]), SamplingParams(max_new_tokens=64))
    return reqs


def disagg_pass(pool, reqs, uid_base, on_first=None):
    """``reqs`` through a DisaggPool's step loop under uids ``uid_base +
    uid``: uids 0-10 at once, uid 11 once uid 10 is on the decode engine
    (so its prefix pages are shared there).  Returns ({uid: tokens},
    {uid: TTFT ms}, seconds)."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    late = max(reqs)
    for uid in sorted(reqs):
        if uid != late:
            pool.submit(uid_base + uid, *reqs[uid])
    first = pool.request(uid_base + late - 1)
    while first.replica != "decode" and not first.finalized:
        pool.step()
    pool.submit(uid_base + late, *reqs[late])
    pool.run_to_completion()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    if pool.errors:
        raise RuntimeError(f"disagg errors: {pool.errors}")
    out, ttft = {}, {}
    for uid, (_, sp) in reqs.items():
        r = pool.request(uid_base + uid)
        if not r.done or len(r.tokens) != sp.max_new_tokens:
            raise RuntimeError(f"disagg: request {uid} has {len(r.tokens)} "
                               "tokens")
        out[uid] = list(r.tokens)
        ttft[uid] = (r.first_token_mono - r.submit_mono) * 1e3
    return out, ttft, seconds


def disagg_phase(cfg, params, counters, card, phase4):
    """Phase 6k: a "prefill" and a "decode" engine of 256 pages each,
    ``keyed_sampling`` on both and one base key, behind
    ``serving.DisaggPool``.  The decode engine first captures its role's
    lattice (``precompile(kinds=("decode", "chain"))``); a warm-up pass
    of ``disagg_requests`` captures the rest, then a timed pass: the
    first token of every request comes from the prefill engine, every
    imported page is bit-equal to the exported blob, ``pages_shared`` > 0
    for the shared prefix, the decode engine holds no Q>1 key and the
    prefill engine no chain or spec key, nothing is captured, launch
    counts exact over both engines; greedy and keyed tokens
    teacher-forced on one engine's eager forward (held to the floors).
    The page audit (``check_invariants``, as under ``DS_KV_DEBUG=1``)
    runs on both engines after every step and import of the warm-up
    pass and after the timed pass.  The pool's rate gauges (prefill MFU,
    decode GB/s, over each engine's busy seconds) stay below the card's
    peaks.
    Reports TTFT, handoff ms a request and its GB/s against a pinned
    ``copy_`` (cold: the warm-up pass; warm: the timed pass), decode ms
    and tokens/s beside phase 4's, graphs per role and the ``ds_disagg_*``
    counters.  Returns (summary, launches of the timed pass)."""
    import gc
    import torch
    from deepspeed_tpu_torch.inference.v2 import FastGenScheduler
    from deepspeed_tpu_torch.inference.v2.engine import lattice_kind_of
    from deepspeed_tpu_torch.serving import DisaggPool
    reqs = disagg_requests(cfg)
    engines = {role: build_engine(cfg, params, FLEET_PAGES, role=role,
                                  keyed_sampling=True)
               for role in ("prefill", "decode")}
    t = time.perf_counter()
    decode_keys = engines["decode"].precompile(
        max(len(p) for p, _ in reqs.values()) + 64, max_concurrency=16,
        max_new_tokens=64, sampling=True, kinds=("decode", "chain"))
    precompile_s = time.perf_counter() - t
    imported = []

    def audited(sched):
        """Each import keeps (the exported blob's columns, a device copy
        of the pages they landed in), compared after the pass: the
        handoff's time holds one device gather, not the comparison."""
        imp = sched.import_handoff

        def run(bundle):
            stats = imp(bundle)
            meta, arrays = bundle["meta"]["engine"], bundle["arrays"]
            col = {p: i for i, p in enumerate(meta["page_ids"])}
            pairs = [(col[old], new) for m in meta["sequences"]
                     for old, new in zip(m["pages"], sched._engine
                                         .state_manager.get_sequence(
                                             m["uid"]).pages) if old and new]
            kv = sched._engine.state_manager.kv_cache.data
            idx = torch.tensor([n for _, n in pairs], device=kv.device)
            imported.append((arrays["page_blob"], [c for c, _ in pairs],
                             kv.index_select(1, idx)))
            return stats
        sched.import_handoff = run
        return sched

    handoff_ms = []
    first_on = {}

    def pool_of(audit=False):
        """A pool over the two engines; ``audit``: both schedulers run
        the page audit after every step and import."""
        for eng in engines.values():
            eng.reset_prefix_cache()
        ref = []

        def spy(uid, tok):
            if uid not in first_on:
                first_on[uid] = ref[0].request(uid).replica

        def scheduler_of(role):
            sched = FastGenScheduler(engines[role], seed=SEED)
            sched._kv_debug = sched._kv_debug or audit
            return sched

        pool = DisaggPool(lambda: scheduler_of("prefill"),
                          lambda: audited(scheduler_of("decode")),
                          on_token=spy)
        pool._on_handoff_ms = handoff_ms.append
        ref.append(pool)
        return pool

    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    _, _, _ = disagg_pass(pool_of(audit=True), reqs, uid_base=1000)
    warm_s = time.perf_counter() - t
    cold_handoff_ms = list(handoff_ms)
    handoff_ms.clear()
    cached = {r: set(e.model._step_cache) for r, e in engines.items()}
    dispatched = {r: dict(e.model.dispatch_counts)
                  for r, e in engines.items()}
    before = registry_family("ds_disagg_")
    imported.clear()
    pool = pool_of()
    reset_launches(counters)
    served, ttft, seconds = disagg_pass(pool, reqs, uid_base=0)
    launches = read_launches(counters)
    for eng in engines.values():
        eng.state_manager.check_invariants()
    rates = pool.refresh_cost_gauges()
    pages_checked = pages_unequal = 0
    for blob, cols, landed in imported:
        pages_checked += len(cols)
        pages_unequal += not torch.equal(landed.cpu(), blob[:, cols])
    imported.clear()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counters_timed = {k: v - before.get(k, 0)
                      for k, v in registry_family("ds_disagg_").items()
                      if k.endswith("_total")}
    seg, role_kinds, role_dispatches = None, {}, {}
    for role, eng in engines.items():
        model = eng.model
        if set(model._step_cache) != cached[role]:
            raise RuntimeError(f"disagg: the timed pass captured on {role}")
        d = {k: n - dispatched[role].get(k, 0)
             for k, n in model.dispatch_counts.items()
             if n != dispatched[role].get(k, 0)}
        if any(model._step_cache[k] is None for k in d):
            raise RuntimeError("disagg: a timed step was not a replay")
        s = segment_counts(cfg, d)
        seg = s if seg is None else {k: seg[k] + s[k] for k in seg}
        role_dispatches[role] = sum(d.values())
        role_kinds[role] = sorted({lattice_kind_of(k)
                                   for k in model._step_cache})
    checks = launch_checks(cfg, "none", launches, seg)
    checks["first token on the prefill engine"] = all(
        first_on.get(u) == "prefill" for u in reqs)
    checks["imported pages bit-equal"] = (pages_unequal == 0
                                          and pages_checked > 0)
    checks["pages shared"] = counters_timed.get(
        "ds_disagg_pages_shared_total", 0) > 0
    checks["decode engine: no Q>1 key"] = "prefill" not in role_kinds[
        "decode"]
    checks["prefill engine: no chain or spec key"] = not (
        {"chain", "spec"} & set(role_kinds["prefill"]))
    checks["rates below the card's peaks"] = (
        0 < rates["prefill_mfu"] < 1
        and 0 < rates["decode_hbm_gb_s"] * 1e9 < HBM_BYTES_PER_S)
    n_handoffs = counters_timed.get("ds_disagg_handoffs_total", 0)
    n_bytes = counters_timed.get("ds_disagg_handoff_bytes_total", 0)
    decode_tokens = sum(len(v) - 1 for v in served.values())
    t_ho = sum(handoff_ms)
    res = dict(
        card=card, model="llama disagg", kv_pool_pages=FLEET_PAGES,
        requests=len(reqs), prompt_lens=[len(p) for p, _ in reqs.values()],
        warm_up_pass_s=warm_s, timed_s=seconds,
        ttft_ms_mean=sum(ttft.values()) / len(ttft),
        ttft_ms_max=max(ttft.values()),
        handoffs=n_handoffs, handoff_bytes=n_bytes,
        handoff_ms_a_request=t_ho / n_handoffs if n_handoffs else None,
        handoff_gb_s=n_bytes / t_ho / 1e6 if t_ho else None,
        handoff_ms_warm=handoff_ms, handoff_ms_cold=cold_handoff_ms,
        pinned_copy_yardstick=copy_yardstick(
            max(int(n_bytes // max(len(handoff_ms), 1)), 1)),
        decode_busy_s=pool.decode_busy_s, prefill_busy_s=pool.prefill_busy_s,
        decode_tok_s=decode_tokens / pool.decode_busy_s,
        decode_dispatches=role_dispatches["decode"],
        decode_ms_a_dispatch=(pool.decode_busy_s * 1e3
                          / max(role_dispatches["decode"], 1)),
        phase4={k: phase4[k] for k in (
            "ttft_ms_mean", "decode_tok_s", "tail_tok_s",
            "decode_step_ms_median")},
        phase4_graphs=phase4["warm_up_pass"]["graphs"],
        graphs={role: graph_report(e.model) for role, e in engines.items()},
        decode_precompiled_keys=len(decode_keys),
        decode_precompile_s=precompile_s, key_kinds=role_kinds,
        pages_checked=pages_checked, max_memory_allocated_gb=peak_gb,
        ds_disagg=counters_timed, rates=rates, segments=seg,
        launches=launches, launch_checks=checks)
    del pool
    gc.collect()
    for eng in engines.values():
        for uid in list(eng.state_manager._seqs):
            eng.flush(uid)
    agree = halves_agreement(engines["prefill"], reqs, served,
                             uid_base=7000, picks_by=keyed_picks(reqs))
    res.update(teacher_forced_agreement=agree, floor=KEYED_AGREE_MIN)
    log("llama disaggregated prefill/decode:", json.dumps(res))
    if not all(checks.values()):
        raise RuntimeError(f"disagg checks: {checks}")
    if min(agree) < KEYED_AGREE_MIN:
        raise RuntimeError(f"disagg: teacher-forced agreement "
                           f"{min(agree):.3f} < {KEYED_AGREE_MIN}")
    engines.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return res, launches


# ---------------------------------------------------------------------------
# phase 6l: the fleet's subprocess mode and the cost of telemetry
# ---------------------------------------------------------------------------

FLEET_PROC_PAGES = 128         # each replica process: 4.29 GB of pages
FLEET_PROC_PAGE = 64
FLEET_PROC_ROUNDS = 2
FLEET_PROC_STALE_S = 2.0       # the federation's stale_after_s
FLEET_PROC_KILL_AT = 40        # r1's restart dies at its 40th step
#: the arguments of both replica processes: Llama-2-7B at full width and
#: depth (weights from phase 4's seed), 8 greedy requests a round (4 on a
#: 1024-token prefix with 64-256-token tails, 4 cold of 128-1024 tokens),
#: 64 new tokens each
FLEET_PROC_ARGS = ["--model", "7b", "--device", "cuda", "--seed", str(SEED),
                   "--page-size", str(FLEET_PROC_PAGE),
                   "--num-pages", str(FLEET_PROC_PAGES),
                   "--requests", "8", "--shared-prefix", str(FLEET_PREFIX),
                   "--max-new", "64", "--token-budget", "2048",
                   "--rounds", str(FLEET_PROC_ROUNDS), "--linger-s", "900"]
#: the workload seed of each replica: two different shared prefixes
FLEET_PROC_WORKLOAD = {"r0": SEED + 31, "r1": SEED + 32}


def _median_ms(fn, n=5):
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def _child_launches(counters, child) -> dict:
    """A replica's launches (``{source: {entry point: n}}``) by kernel
    name, as ``read_launches`` reads the parent's."""
    out = {}
    for name, (k, fns) in counters.items():
        by_fn = child.get(k.source.name, {})
        out[name] = sum(by_fn.get(fn, 0) for fn in (fns or by_fn))
    return out


def fleet_proc_phase(counters, card, cache_dir):
    """Phase 6l (a)-(d): two replica processes on the card
    (``python -m deepspeed_tpu_torch.tools.fleet_replica``, spawned by
    ``fleetctl.ReplicaProc``), each Llama-2-7B at full width and depth in
    bf16 over 128 pages of 64 tokens, loading phase 2's kernel libraries
    (``DS_COMPILE_CACHE``, no ``nvcc``).  (a) Each serves
    ``FLEET_PROC_ROUNDS`` rounds of 8 greedy requests and reports the
    seconds from its spawn to ready and to its first token, its decode
    median ms and tokens/s (the rounds after the first) and its kernel
    launches: paged attention, RMSNorm and the flash forward each > 0.
    (b) ``fetch_remote_hints`` of each equals the digests it printed; a
    warm request on r0's prefix is routed to r0 by a
    ``PrefixAffinityRouter`` over both; the federation's merged
    ``ds_fastgen_ttft_ms`` buckets equal the sum of the two raw
    snapshots at one scrape after both are done, every merged counter
    the sum of its parts, ``ds_fleet_replicas_live`` 2; the ms of one
    ``/snapshot?raw=1`` scrape and of one ``fetch_remote_hints``.  (c) A
    ``TimeSeries`` over the federation's merged view, sampled after
    each round of both replicas, judged by a latency objective on
    ``ds_fastgen_ttft_ms`` at 1 ms (below every TTFT, so it must page)
    and a capacity objective on ``ds_mem_headroom_seqs``; each
    replica's ``/memory`` breakdown.  (d) r1 started again under
    ``DS_CHAOS="serving.preempt:at=40"`` exits with status 17, is
    flagged stale within ``stale_after_s`` plus one scrape interval,
    r0 stays up and keeps the route.  Every child is reaped.  Returns
    (summary, launches by child)."""
    import os
    import urllib.request
    from deepspeed_tpu_torch.serving import (PrefixAffinityRouter,
                                             fetch_remote_hints)
    import numpy as np
    from deepspeed_tpu_torch.telemetry import federation
    from deepspeed_tpu_torch.telemetry import metrics as tm
    from deepspeed_tpu_torch.telemetry.slo import SLOEvaluator
    from deepspeed_tpu_torch.telemetry.timeseries import TimeSeries
    from deepspeed_tpu_torch.tools import fleetctl
    from deepspeed_tpu_torch.models.llama import llama_config
    from deepspeed_tpu_torch.tools.fleet_replica import (
        EXIT_PREEMPTED, HINT_TOP_K, synthetic_workload)
    log_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "fleet_proc")
    os.makedirs(log_dir, exist_ok=True)
    env = {"DS_COMPILE_CACHE": os.path.dirname(cache_dir), "DS_CHAOS": ""}

    def spawn(label, chaos=""):
        return fleetctl.ReplicaProc(
            label, FLEET_PROC_ARGS + ["--workload-seed",
                                      str(FLEET_PROC_WORKLOAD[label])],
            dict(env, DS_CHAOS=chaos),
            log_path=os.path.join(
                log_dir, f"{label}{'_chaos' if chaos else ''}.log"))

    def child_log(rep):
        path = os.path.join(log_dir, f"{rep.label}.log")
        try:
            with open(path) as f:
                return f.read()[-3000:]
        except OSError:
            return ""

    t_phase = time.perf_counter()
    reps = {lb: spawn(lb) for lb in ("r0", "r1")}
    try:
        ports = {}
        for lb, rep in reps.items():
            try:
                ports[lb] = rep.port(timeout=300.0)
            except RuntimeError as e:
                raise RuntimeError(f"{e}\n{child_log(rep)}") from None
        fed = fleetctl._federation(sorted(ports.items()),
                                   stale_after_s=FLEET_PROC_STALE_S)
        ts = TimeSeries(source=fed.merged_raw)
        ts.configure(interval_s=1.0, retention_s=3600.0)
        ev = SLOEvaluator()
        ev.configure([
            {"name": "ttft", "kind": "latency", "hist": "ds_fastgen_ttft_ms",
             "threshold_ms": 1.0, "fast_window_s": 600.0,
             "slow_window_s": 1200.0},
            {"name": "capacity", "kind": "capacity",
             "min_headroom_seqs": 4, "fast_window_s": 600.0,
             "slow_window_s": 1200.0}])
        ev.attach(timeseries=ts, federation=fed)
        ts.sample_now()
        statuses = [{v["objective"]: v["status"]
                     for v in ev.current()["objectives"].values()}]
        for rnd in range(FLEET_PROC_ROUNDS):
            for lb, rep in reps.items():
                if rep.wait_line(f"round={rnd} done", 600.0) is None:
                    raise RuntimeError(
                        f"replica {lb} never finished round {rnd} "
                        f"(exit {rep.proc.poll()}):\n{child_log(rep)}")
            ts.sample_now()
            statuses.append({v["objective"]: v["status"]
                             for v in ev.current()["objectives"].values()})
        for lb, rep in reps.items():
            if rep.wait_line("FLEET_REPLICA done", 120.0) is None:
                raise RuntimeError(f"replica {lb} never finished")
        stats = {lb: rep.report("stats") for lb, rep in reps.items()}
        digests = {lb: rep.report("digests") for lb, rep in reps.items()}
        launches = {lb: _child_launches(counters, s["launches"])
                    for lb, s in stats.items()}
        children = {}
        for lb, s in stats.items():
            children[lb] = dict(
                ready_s=s["ready_unix"] - reps[lb].spawn_unix,
                first_token_s=s["first_token_unix"] - reps[lb].spawn_unix,
                decode_ms_median=s["decode_ms_median"],
                decode_steps=s["decode_steps"], tok_s=s["tok_s"],
                path_captures=s["path_captures"],
                launches={k: n for k, n in launches[lb].items() if n})
            for name in ("paged_attention", "rmsnorm", "flash_fwd"):
                if not launches[lb][name]:
                    raise RuntimeError(f"replica {lb}: {name} never "
                                       f"launched: {launches[lb]}")
        # (b) hints, the route and the exact merge
        router = PrefixAffinityRouter(FLEET_PROC_PAGE, top_k=HINT_TOP_K)
        for lb, port in ports.items():
            hint = fetch_remote_hints(f"127.0.0.1:{port}",
                                      top_k=HINT_TOP_K)
            if hint["digests"] != digests[lb] or not digests[lb]:
                raise RuntimeError(f"replica {lb}: /snapshot?digests=1 "
                                   "differs from its export_digests")
            router.publish(lb, hint["digests"])
        vocab = llama_config("7b").vocab_size
        warm_prompt = synthetic_workload(
            vocab, 8, 0, FLEET_PREFIX, FLEET_PROC_WORKLOAD["r0"], 64)[0][0]
        warm = np.asarray(warm_prompt[:FLEET_PREFIX] + list(range(7, 107)))
        route = router.decide(warm, {"r0": 0, "r1": 0})
        if (route.label, route.matched_pages) \
                != ("r0", FLEET_PREFIX // FLEET_PROC_PAGE):
            raise RuntimeError(f"the warm request went to {route}")
        parts = {lb: fleetctl.fetch_raw(port) for lb, port in ports.items()}
        view = fed.scrape()
        merged = view["hists"]["ds_fastgen_ttft_ms"]
        want = [a + b for a, b in zip(*(parts[lb]["hists"][
            "ds_fastgen_ttft_ms"]["counts"] for lb in ("r0", "r1")))]
        if merged["counts"] != want or merged["count"] != sum(
                p["hists"]["ds_fastgen_ttft_ms"]["count"]
                for p in parts.values()):
            raise RuntimeError("the merged TTFT histogram is not the sum "
                               "of the replicas' buckets")
        for name, v in view["counters"].items():
            if v != sum(p["counters"].get(name, 0) for p in parts.values()):
                raise RuntimeError(f"merged counter {name} is not the sum")
        if tm.FLEET_REPLICAS_LIVE.value != 2 or view["stale"]:
            raise RuntimeError(f"live replicas {tm.FLEET_REPLICAS_LIVE.value}")
        ttft_count = merged["count"]
        scrape_ms = _median_ms(lambda: fleetctl.fetch_raw(ports["r0"]))
        hints_ms = _median_ms(lambda: fetch_remote_hints(
            f"127.0.0.1:{ports['r0']}", top_k=HINT_TOP_K))
        # (c) the verdicts and each replica's memory breakdown
        ts.sample_now()
        verdicts = ev.current()
        statuses.append({v["objective"]: v["status"]
                         for v in verdicts["objectives"].values()})
        transitions = [(i, name, statuses[i - 1].get(name, "ok"), st)
                       for i in range(1, len(statuses))
                       for name, st in statuses[i].items()
                       if st != statuses[i - 1].get(name, "ok")]
        min_ttft_ms = 1e3 * min(c["first_token_s"] - c["ready_s"]
                                for c in children.values())
        if verdicts["objectives"]["ttft"]["status"] != "page" \
                or min_ttft_ms <= 1.0:
            raise RuntimeError(f"the latency objective did not page: "
                               f"{verdicts}")
        memory = {}
        for lb, port in ports.items():
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/memory?json=1",
                    timeout=5) as r:
                doc = json.loads(r.read().decode())
            if doc["measured_source"] != "device":
                raise RuntimeError(f"replica {lb} measured {doc}")
            memory[lb] = {k: doc[k] for k in (
                "subsystems", "accounted_bytes", "device_accounted_bytes",
                "measured_bytes", "measured_source", "unaccounted_bytes",
                "dominant", "headroom_seqs")}
        # (d) r1 again, killed through the fault site
        reps["r1"].terminate()
        reps["r1"] = spawn("r1", f"serving.preempt:at={FLEET_PROC_KILL_AT}")
        fed.remove("r1")
        fed.add_http("r1", f"127.0.0.1:{reps['r1'].port(timeout=300.0)}")
        if fed.scrape()["replicas"]["r1"]["stale"]:
            raise RuntimeError("the restarted r1 did not answer a scrape")
        # scraped every interval while it serves, so its last good scrape
        # is at most one interval before it dies
        interval = 0.25
        deadline = time.monotonic() + 600.0
        while reps["r1"].proc.poll() is None \
                and time.monotonic() < deadline:
            fed.scrape()
            time.sleep(interval)
        code = reps["r1"].proc.wait(timeout=60)
        t_exit = time.monotonic()
        if code != EXIT_PREEMPTED:
            raise RuntimeError(f"the killed r1 exited {code}, not "
                               f"{EXIT_PREEMPTED}")
        stale_after = None
        while time.monotonic() - t_exit < FLEET_PROC_STALE_S + 10.0:
            if fed.scrape()["replicas"]["r1"]["stale"]:
                stale_after = time.monotonic() - t_exit
                break
            time.sleep(interval)
        scrape_budget = (FLEET_PROC_STALE_S + interval
                         + federation.SCRAPE_TIMEOUT_S)
        if stale_after is None or stale_after > scrape_budget:
            raise RuntimeError(f"r1 not flagged stale in time "
                               f"({stale_after} s)")
        final = fed.scrape()
        route_after = router.decide(warm, {"r0": 0}).label
        if reps["r0"].proc.poll() is not None or route_after != "r0" \
                or (final["live"], final["stale"]) != (1, 1):
            raise RuntimeError(f"after the kill: r0 exit "
                               f"{reps['r0'].proc.poll()}, route "
                               f"{route_after}, view {final['live']} live")
    finally:
        for rep in reps.values():
            rep.terminate()
    res = dict(card=card, children=children, route=route.label,
               matched_pages=route.matched_pages,
               merged_ttft_count=ttft_count, scrape_raw_ms=scrape_ms,
               fetch_remote_hints_ms=hints_ms,
               slo_statuses=statuses, slo_transitions=transitions,
               verdicts={k: {f: v[f] for f in ("status", "fast_burn",
                                               "slow_burn", "value")}
                         for k, v in verdicts["objectives"].items()},
               memory=memory, killed_exit=code,
               stale_flagged_after_s=stale_after,
               stale_budget_s=scrape_budget, route_after_kill=route_after,
               phase_s=time.perf_counter() - t_phase)
    log("fleet subprocess mode:", json.dumps(res))
    return res, launches


def telemetry_cost_phase(cfg, params, counters, card):
    """Phase 6l (e): phase 4's traffic in one engine of 256 pages, with
    telemetry off and on.  A warm-up pass captures the keys with
    telemetry on and a thread scraping ``/metrics`` every 50 ms (the
    scrapes run beside the captures); then timed passes in turns (off,
    on, off, on).  "On" is the watchdog, the time series sampling every
    0.1 s (its thread and the step tick), the memory ledger's tick every
    step, the metrics server up and the scraper running.  Reports each
    pass's decode median ms and decode tokens/s; no timed pass captures
    a graph, every step-cache miss is a capture, no scrape fails, and
    the greedy requests' tokens are the same in every pass.  Returns
    (summary, launches of the last "on" pass)."""
    import threading
    import urllib.request
    import torch
    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.telemetry import metrics as tm
    engine = build_engine(cfg, params, num_pages=256)
    model = engine.model
    reqs = serving_requests(cfg)
    port = telemetry.start_http_server(0).server_address[1]
    scraping, stop = threading.Event(), threading.Event()
    scrapes, errors = [], []

    def scraper():
        while not stop.is_set():
            if scraping.wait(0.05) and not stop.is_set():
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}/metrics",
                            timeout=10) as r:
                        r.read()
                        scrapes.append(r.status)
                except Exception as e:  # noqa: BLE001 (reported below)
                    errors.append(repr(e))
                time.sleep(0.05)

    def mode(on):
        ts = telemetry.get_timeseries()
        if on:
            telemetry.enable()
            ts.configure(interval_s=0.1, retention_s=600.0)
            ts.start_thread()
            scraping.set()
        else:
            scraping.clear()
            ts.disable()
            telemetry.disable()

    thread = threading.Thread(target=scraper, daemon=True)
    thread.start()
    misses0 = tm.FASTGEN_STEP_CACHE_MISS.value
    captures0 = model.path_captures
    passes, greedy = [], None
    try:
        mode(True)
        drive(engine, reqs, uid_base=1000)             # the warm-up pass
        warm_scrapes = len(scrapes)
        engine.reset_prefix_cache()
        for name in ("off", "on", "off", "on"):
            mode(name == "on")
            caps, cap_s = model.path_captures, model.capture_seconds
            reset_launches(counters)
            generated, _, steps = drive(engine, reqs, record=True)
            launches = read_launches(counters)
            engine.reset_prefix_cache()
            dec = [st for st in steps if step_kind(st["key"]) == "decode"]
            dec_s = sum(st["ms"] for st in dec) / 1e3
            passes.append(dict(
                telemetry=name,
                decode_ms_median=statistics.median(st["ms"] for st in dec),
                decode_tok_s=sum(st["scheduled"] for st in dec) / dec_s,
                steps=len(steps), captures=model.path_captures - caps,
                capture_s=model.capture_seconds - cap_s))
            picks = {u: t for u, t in generated.items() if u < 8}
            if greedy is None:
                greedy = picks
            elif picks != greedy:
                raise RuntimeError(f"telemetry {name} changed greedy tokens")
    finally:
        stop.set()
        scraping.set()
        thread.join(timeout=30)
        mode(False)
        telemetry.stop_http_server()
        telemetry.get_watchdog().reset()
    misses = tm.FASTGEN_STEP_CACHE_MISS.value - misses0
    captures = model.path_captures - captures0
    res = dict(card=card, passes=passes, warm_up_scrapes=warm_scrapes,
               scrapes=len(scrapes), scrape_errors=errors[:3],
               step_cache_misses=misses, captures=captures,
               health=telemetry.get_watchdog().health()["step_cache"])
    log("telemetry on/off:", json.dumps(res))
    if errors or not warm_scrapes:
        raise RuntimeError(f"scrapes failed or never ran: {errors[:3]}")
    if any(p["captures"] for p in passes) or misses != captures:
        raise RuntimeError(f"a timed pass captured, or misses {misses} != "
                           f"captures {captures}")
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return res, launches


def mistral_phase(counters, card):
    """Mistral-7B-v0.1 at its published configuration (``config.json``'s
    fields through ``llama_config_from_hf``: 8 kv heads, a 4096-token
    sliding window; random seeded bf16 weights) at MISTRAL_LAYERS of its
    32 layers over 288 pages: four
    greedy requests of 6144-token prompts, 64 new tokens each, whose
    full contexts would need 4 x 97 = 388 pages but whose windows need
    at most 4 x 67.  ``two_passes`` with the page audit after every
    warm-up step; live pages per sequence held to ceil((4096 + 64) / 64) + 1
    after every step.  Then the kernel path against the plain path,
    teacher-forced, at contexts past the window (prefill chunks of 2048,
    then decode steps over evicted tables), logits held to
    LOGIT_REL_TOL."""
    import gc
    import numpy as np
    import torch
    from deepspeed_tpu_torch.checkpoint.hf import llama_config_from_hf
    from deepspeed_tpu_torch.inference.v2 import SamplingParams
    from deepspeed_tpu_torch.models.transformer import init_params
    cfg = dataclasses.replace(llama_config_from_hf(
        types.SimpleNamespace(**MISTRAL_7B)), num_layers=MISTRAL_LAYERS)
    t = time.perf_counter()
    params = init_params(cfg, seed=SEED + 11, device="cuda")
    torch.cuda.synchronize()
    log(f"Mistral-7B-v0.1 params: {cfg.n_params() / 1e9:.2f} B, window "
        f"{cfg.sliding_window}, kv heads {cfg.kv_heads}, bf16 init "
        f"{time.perf_counter() - t:.1f} s")
    engine = build_engine(cfg, params, num_pages=MISTRAL_PAGES,
                          model_type="mistral")
    rng = np.random.default_rng(SEED + 12)
    reqs = {u: (rng.integers(0, cfg.vocab_size, MISTRAL_PROMPT),
                SamplingParams(max_new_tokens=64)) for u in range(4)}
    limit = -(-(cfg.sliding_window + 64) // 64) + 1
    live_max, preempted_max = [0], [0]

    def live_pages(sched):
        preempted_max[0] = max(preempted_max[0], len(sched._preempted))
        for sd in engine.state_manager._seqs.values():
            live = sum(p != 0 for p in sd.pages)
            live_max[0] = max(live_max[0], live)
            if live > limit:
                raise RuntimeError(f"sequence {sd.uid} holds {live} live "
                                   f"pages > {limit}")

    summary, launches, generated, _ = two_passes(
        engine, reqs, cfg, counters, card, "mistral", audit=True,
        after_step=live_pages)
    summary.update(live_pages_max=live_max[0], live_pages_limit=limit,
                   preempted_max=preempted_max[0],
                   full_context_pages=4 * -(-(MISTRAL_PROMPT + 64) // 64))
    log("Mistral window:", json.dumps({k: summary[k] for k in (
        "live_pages_max", "live_pages_limit", "preempted_max",
        "full_context_pages", "kv_pool_pages")}))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    summary["kernel_vs_plain"] = window_kernel_vs_plain(cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return summary, launches


def window_kernel_vs_plain(cfg, params, n_decode=6, prompt=MISTRAL_PROMPT,
                           chunk=MISTRAL_CHUNK, model_type="mistral",
                           label="Mistral"):
    """Two sequences of a windowed model on the kernel path and on the
    plain path, teacher-forced with the kernel path's picks, each step
    one eager ``put`` per prefill chunk (the step's token budget) or of
    both decode rows: ``prompt``-token prompts in chunks of ``chunk``
    (Mistral: 6144 in chunks of 2048, a fresh chunk, then chunks over
    2048 and 4096 tokens of history), then ``n_decode`` decode steps over
    tables whose first slots the window has evicted (null; Mistral: 32).
    Every put's logits compared."""
    import numpy as np
    import torch
    kw = dict(num_pages=200, model_type=model_type)
    engines = {"kernel": build_engine(cfg, params, **kw),
               "plain": build_engine(cfg, params, **kw,
                                     implementations=PLAIN_PATH)}
    rng = np.random.default_rng(SEED + 13)
    prompts = [rng.integers(0, cfg.vocab_size, prompt) for _ in range(2)]
    uids, last, rows = [0, 1], {}, []
    puts = [([u], [p[i:i + chunk]])
            for i in range(0, prompt, chunk)
            for u, p in zip(uids, prompts)] + [(uids, None)] * n_decode
    for g_uids, feed in puts:
        feed = feed or [np.array([last[u]], np.int32) for u in g_uids]
        logits = {}
        for name, e in engines.items():
            with eager_steps(e):
                logits[name] = e.put(g_uids, feed)
        state = engines["kernel"].state_manager
        a, b = logits["kernel"], logits["plain"]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise RuntimeError(f"non-finite logits at put {len(rows)}")
        rows.append(dict(uids=g_uids, q=len(feed[0]),
                         context=[state.get_sequence(u).seen_tokens
                                  for u in g_uids],
                         evicted_slots=[sum(p == 0 for p in state
                                            .get_sequence(u).pages)
                                        for u in g_uids],
                         max_rel_logit_err=float((a - b).abs().max()
                                                 / b.abs().max()),
                         greedy_agree=int((a.argmax(-1)
                                           == b.argmax(-1)).sum())))
        last.update(zip(g_uids, a.argmax(-1).tolist()))
    worst = max(r["max_rel_logit_err"] for r in rows)
    res = dict(puts=rows, max_rel_logit_err=worst, tol=LOGIT_REL_TOL,
               greedy_agreement=sum(r["greedy_agree"] for r in rows)
               / sum(len(r["uids"]) for r in rows))
    log(f"{label} kernel vs plain past the window:", json.dumps(res))
    if not any(min(r["evicted_slots"]) for r in rows):
        raise RuntimeError("no step ran over an evicted table")
    if worst > LOGIT_REL_TOL:
        raise RuntimeError(f"{label} kernel path logits differ from the "
                           f"plain path by {worst:.3e} > {LOGIT_REL_TOL}")
    if res["greedy_agreement"] < GREEDY_AGREE_MIN:
        raise RuntimeError(f"{label} greedy agreement "
                           f"{res['greedy_agreement']:.3f} below "
                           f"{GREEDY_AGREE_MIN}")
    return res


# ---------------------------------------------------------------------------
# phases 9b to 9d: the published Hugging Face families at head dims 64, 80
# and 96
# ---------------------------------------------------------------------------

# head dim -> the model of phases 9b-9d that serves at it
HEAD_DIM_MODELS = {64: "Falcon-7B", 80: "Phi-2", 96: "Phi-3-mini-4k"}
#: phase 9b serves Falcon-7B's published width at 16 of its 32 layers
#: (the cut that pays for phase 22)
FALCON_SERVING_LAYERS = 16
# Phi-3-mini's two requests that cross its 2047-token window, and the
# window check's prompts (chunks of the step budget's half)
PHI3_LONG_PROMPT = 3072
PHI3_CHUNK = 1024


def hf_family_phase(counters, card, label, model_type, config_from_hf,
                    fields, seed, int8=False, layers=0):
    """One published family at full width and depth (its ``config.json``
    fields through the port's ``*_config_from_hf``; seeded random bf16
    weights, norm scales and biases drawn too; ``layers`` > 0 cuts the
    depth) on 256 pages of 64 tokens:
    ``serve`` (phase 4's traffic, warm-up then timed pass, exact launch
    counts, no capture in the timed pass, every replay against its eager
    body, profiled decode steps), with the two attention op classes
    resolved to their kernels (never a plain version); then the kernel
    path against the plain path at full width (``plain_vs_kernel``).
    ``int8``: the same weights again over 256 int8 pages.  A windowed
    model also serves two requests of 3072 + 64 tokens that cross the
    window, and its kernel path is held to the plain path past the
    window.  Returns ({path: launches}, {path: summary})."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.inference.v2 import SamplingParams
    from deepspeed_tpu_torch.models.transformer import init_params
    cfg = config_from_hf(types.SimpleNamespace(**fields))
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    t = time.perf_counter()
    params = randomize_norms_and_biases(
        init_params(cfg, seed=seed, device="cuda"), seed + 1)
    torch.cuda.synchronize()
    log(f"{label} params: {cfg.n_params() / 1e9:.2f} B, {cfg.num_layers} "
        f"layers, head_dim {cfg.dims_per_head}, heads {cfg.num_heads} / kv "
        f"{cfg.kv_heads}, window {cfg.sliding_window}, bf16 init "
        f"{time.perf_counter() - t:.1f} s")
    reqs = serving_requests(cfg)
    if cfg.sliding_window:
        rng = np.random.default_rng(seed + 2)
        for uid in (len(reqs), len(reqs) + 1):
            reqs[uid] = (rng.integers(0, cfg.vocab_size, PHI3_LONG_PROMPT),
                         SamplingParams(max_new_tokens=64))
    launches, summaries = {}, {}
    for quant in ("none", "int8") if int8 else ("none",):
        path = f"serving_{model_type}" + ("_int8" if quant == "int8" else "")
        name = label + (" int8" if quant == "int8" else "")
        summary, launches[path], engine, _, _ = serve(
            cfg, params, counters, card, model_type=model_type,
            kv_quantization=quant, label=name, reqs=reqs)
        impls = engine.model.implementations
        if (impls["ragged_attention"], impls["fresh_prefill_attention"]) \
                != ("cuda_paged", "cuda_flash"):
            raise RuntimeError(f"{name}: attention resolved to {impls}")
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        summary["kernel_vs_plain"] = plain_vs_kernel(
            cfg, params, model_type=model_type, kv_quantization=quant)
        summaries[path] = summary
        gc.collect()
        torch.cuda.empty_cache()
    if cfg.sliding_window:
        summaries[f"serving_{model_type}"]["window_kernel_vs_plain"] = \
            window_kernel_vs_plain(cfg, params, prompt=PHI3_LONG_PROMPT,
                                   chunk=PHI3_CHUNK, model_type=model_type,
                                   label=label)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, summaries


# ---------------------------------------------------------------------------
# phase 9e: Mixtral-8x7B, MoE serving with weight-only fp8 weights
# ---------------------------------------------------------------------------

MIXTRAL_SOURCE = "mistralai/Mixtral-8x7B-v0.1"
MIXTRAL_SHORT_LAYERS = 4       # (a) and (c): bf16 at 4 of 32 layers
MIXTRAL_FMT = "fp8_e4m3"       # (b): the full depth's weights
MIXTRAL_PEAK_GB = 75.0
MIXTRAL_SEED = SEED + 41


def mixtral_params(cfg, seed, fmt=None):
    """Seeded random Mixtral weights on the card, per-layer layout
    (``scan_layers=False``): layer i drawn from its own generator (seed
    + 1 + i, so a shallower model's layers are a deeper one's first), its
    bf16 leaves quantised into ``fmt`` by the serving model's per-layer
    helper (``quantize_layer_weights``, which ``quantize_weights`` runs:
    attention scales per channel, expert scales per expert) before the
    next layer is drawn, so that the bf16 tree (93 GB at full depth)
    never exists whole.  Matrices N(0, 1) * fan_in ** -0.5 as
    ``init_params`` draws them, the router likewise, embeddings * 0.02,
    norm scales 1 + 0.1 N(0, 1)."""
    import torch
    from deepspeed_tpu_torch.inference.v2.model import quantize_layer_weights
    from deepspeed_tpu_torch.moe.layer import MoEConfig, init_moe_params
    e, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    h, k, d = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head
    bf16 = torch.bfloat16
    moe_cfg = MoEConfig(num_experts=cfg.moe_num_experts, top_k=cfg.moe_top_k,
                        activation=cfg.activation)

    def dense(g, shape, fan_in, scale=None):
        w = torch.randn(shape, generator=g, device="cuda", dtype=bf16)
        return w.mul_(fan_in ** -0.5 if scale is None else scale)

    def norm(g):
        return {"scale": 1 + 0.1 * torch.randn(e, generator=g,
                                               device="cuda")}

    layers = {}
    for i in range(cfg.num_layers):
        g = torch.Generator(device="cuda").manual_seed(seed + 1 + i)
        layer = {"attn": {"wq": dense(g, (e, h, d), e),
                          "wk": dense(g, (e, k, d), e),
                          "wv": dense(g, (e, k, d), e),
                          "wo": dense(g, (h, d, e), h * d)},
                 "mlp": init_moe_params(moe_cfg, e, f, g, bf16, "cuda"),
                 "norm1": norm(g), "norm2": norm(g)}
        if fmt is not None:
            layer = quantize_layer_weights(layer, fmt)
        layers[f"layer_{i}"] = layer
    g = torch.Generator(device="cuda").manual_seed(seed)
    return {"embed": {"tokens": dense(g, (v, e), 1, 0.02)}, "layers": layers,
            "final_norm": norm(g), "lm_head": dense(g, (e, v), e)}


def tree_bytes(tree, bf16=False) -> int:
    """Bytes of a param tree's leaves, or (``bf16``) of the same weights
    held in bf16 (a quantised leaf's codes at 2 bytes, no scales)."""
    if isinstance(tree, dict):
        if bf16 and "q" in tree:
            return 2 * tree["q"].numel()
        return sum(tree_bytes(v, bf16) for v in tree.values())
    return tree.numel() * (2 if bf16 else tree.element_size())


def mixtral_decode_split(engine, reqs, label, n_steps=2):
    """One decode step's device time by what it runs: the same requests
    again (new uids, 16 new tokens), stepped until every one decodes,
    then ``n_steps`` decode steps through their keys' eager step bodies
    (the kernels a replay runs; a replay hides which op launched a
    kernel) under torch.profiler.  cuBLAS kernels launched by
    ``aten::bmm`` are the expert GEMMs (only the MoE layer calls
    ``torch.bmm`` on this path), the rest the attention projections, the
    router and the lm head."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import (FastGenScheduler,
                                                  SamplingParams)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sched = FastGenScheduler(engine, seed=SEED)
    for uid, (prompt, sp) in reqs.items():
        sched.submit(200 + uid, prompt, SamplingParams(
            max_new_tokens=16, temperature=sp.temperature, top_p=sp.top_p))
    while len(sched.step()) < len(reqs):
        if not sched.has_work:
            raise RuntimeError("profiled serving run ended before decoding")
    torch.cuda.synchronize()
    with eager_steps(engine):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_steps):
                if len(sched.step()) != len(reqs):
                    raise RuntimeError("a profiled step was not a decode "
                                       "step")
            torch.cuda.synchronize()
    sched.run_to_completion()
    n_kernels, by_kind = device_ms_by_kind(prof)
    gemm = "GEMM (cuBLAS)"
    expert_us = sum(
        kern.duration for ev in prof.events()
        if ev.device_type == DeviceType.CPU and ev.name == "aten::bmm"
        for kern in ev.kernels
        if any(frag in kern.name for frag, kind in _KERNEL_KINDS
               if kind == gemm))
    split = {k: v / n_steps for k, v in by_kind.items() if k != gemm}
    split["expert GEMMs (torch.bmm)"] = expert_us / 1e3 / n_steps
    split["other GEMMs (projections, router, lm head)"] = (
        by_kind.get(gemm, 0.0) - expert_us / 1e3) / n_steps
    res = dict(model=label, decode_rows=len(reqs), steps=n_steps,
               note="eager step bodies: the graph's kernels, launched one "
                    "by one",
               device_kernels_per_step=n_kernels / n_steps,
               device_ms_per_step=sum(by_kind.values()) / n_steps,
               device_ms_per_step_by_part=dict(sorted(
                   split.items(), key=lambda kv: -kv[1])))
    log(f"{label} decode step split:", json.dumps(res))
    if expert_us <= 0:
        raise RuntimeError(f"{label}: no expert GEMM in the profiled step")
    return res


def mixtral_phase(counters, card):
    """Phase 9e: Mixtral-8x7B at its published configuration
    (``mixtral_config_from_hf``: 8 experts, top-2, 32 heads over 8 kv
    heads, D = 128), seeded random weights.  (a) bf16 at 4 of 32 layers:
    ``serve`` (phase 4's traffic, exact launch counts, no capture in the
    timed pass, every replay against its eager body) and the kernel path
    against the plain path (phase 7's limits); (c) on the same weights an
    engine that quantises them to fp8_e4m3 at build: the bf16 engine's
    served greedy tokens teacher-forced through it (agreement reported,
    not held to a floor); (b) all 32 layers with fp8_e4m3 weights,
    built layer by layer and handed to an engine with ``quantization``
    on, as (a), with the dequantise kernel's launches held exactly, one
    decode step split by part, and the phase's peak memory held under
    MIXTRAL_PEAK_GB.  Returns ({path: launches}, {path: summary})."""
    import torch
    from deepspeed_tpu_torch.checkpoint import hf as HF
    cfg32 = HF.mixtral_config_from_hf(types.SimpleNamespace(
        **HF.PUBLISHED_CONFIGS[MIXTRAL_SOURCE]))
    cfg32 = dataclasses.replace(cfg32, scan_layers=False)
    cfg4 = dataclasses.replace(cfg32, num_layers=MIXTRAL_SHORT_LAYERS)
    reqs = serving_requests(cfg32)
    launches, summaries = {}, {}

    def kernels_resolved(engine, name):
        impls = engine.model.implementations
        if (impls["ragged_attention"], impls["fresh_prefill_attention"],
                impls["norm"]) != ("cuda_paged", "cuda_flash",
                                   "cuda_rmsnorm"):
            raise RuntimeError(f"{name}: op classes resolved to {impls}")

    # (a) bf16 at 4 of 32 layers
    t = time.perf_counter()
    params4 = mixtral_params(cfg4, MIXTRAL_SEED)
    torch.cuda.synchronize()
    log(f"Mixtral-8x7B {MIXTRAL_SHORT_LAYERS} of 32 layers: bf16 "
        f"{tree_bytes(params4) / 1e9:.2f} GB, init "
        f"{time.perf_counter() - t:.1f} s")
    name = f"Mixtral-8x7B bf16, {MIXTRAL_SHORT_LAYERS} layers"
    path = f"serving_mixtral_bf16_{MIXTRAL_SHORT_LAYERS}_layers"
    summary, launches[path], engine, _, served = serve(
        cfg4, params4, counters, card, model_type="mixtral", label=name,
        reqs=reqs)
    kernels_resolved(engine, name)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    summary["kernel_vs_plain"] = plain_vs_kernel(cfg4, params4,
                                                 model_type="mixtral")
    gc.collect()
    torch.cuda.empty_cache()

    # (c) fp8 against bf16 on the same weights
    fp8 = build_engine(cfg4, params4, num_pages=256, model_type="mixtral",
                       quantization=MIXTRAL_FMT)
    greedy = {u: r for u, r in reqs.items() if r[1].temperature == 0}
    agree, margins, _ = teacher_forced_agreement(fp8, greedy, served, 3000,
                                                 {})
    summary["fp8_vs_bf16"] = dict(
        weights=MIXTRAL_FMT, greedy_agreement=sum(agree) / len(agree),
        by_request=agree, top2_margin_median=statistics.median(margins),
        top2_margin_quartiles=statistics.quantiles(margins, n=4),
        note="the bf16 engine's served greedy tokens teacher-forced "
             "through the fp8 engine's eager forward; reported, not held")
    log(f"{name}: fp8 against bf16:", json.dumps(summary["fp8_vs_bf16"]))
    summaries[path] = summary
    del fp8, params4
    gc.collect()
    torch.cuda.empty_cache()

    # (b) fp8 weights at full depth
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params32 = mixtral_params(cfg32, MIXTRAL_SEED, fmt=MIXTRAL_FMT)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    build_s = time.perf_counter() - t
    weights_gb = tree_bytes(params32) / 1e9
    log(f"Mixtral-8x7B 32 layers: {MIXTRAL_FMT} weights {weights_gb:.2f} GB "
        f"(in bf16 {tree_bytes(params32, bf16=True) / 1e9:.2f} GB), built "
        f"layer by layer in {build_s:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    name = f"Mixtral-8x7B {MIXTRAL_FMT}, 32 layers"
    path = "serving_mixtral_fp8"
    summary, launches[path], engine, _, _ = serve(
        cfg32, params32, counters, card, model_type="mixtral", label=name,
        reqs=reqs, quantization=MIXTRAL_FMT)
    kernels_resolved(engine, name)
    if engine.model.quantized_fmt != MIXTRAL_FMT or \
            quantized_leaves(engine.model) != 7:
        raise RuntimeError(f"{name}: the served tree is not {MIXTRAL_FMT} in "
                           f"its 7 projection leaves a layer")
    summary["decode_split"] = mixtral_decode_split(engine, reqs, name)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    summary["kernel_vs_plain"] = plain_vs_kernel(
        cfg32, params32, model_type="mixtral", quantization=MIXTRAL_FMT)
    peak = torch.cuda.max_memory_allocated() / 1e9
    summary.update(weights_gb=weights_gb, weights_build_s=build_s,
                   phase_peak_gb=peak, peak_limit_gb=MIXTRAL_PEAK_GB)
    log(f"{name}: weights {weights_gb:.2f} GB, phase peak {peak:.2f} GB "
        f"(limit {MIXTRAL_PEAK_GB})")
    if peak > MIXTRAL_PEAK_GB:
        raise RuntimeError(f"{name}: peak {peak:.2f} GB above "
                           f"{MIXTRAL_PEAK_GB}")
    summaries[path] = summary
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    return launches, summaries


# ---------------------------------------------------------------------------
# phases 10 to 13: training at Llama-2-7B width, 8 layers
# ---------------------------------------------------------------------------

def train(counters, card, path="training", layers=TRAIN_LAYERS):
    """4 train_batch calls through deepspeed_tpu_torch.initialize on one
    fixed seeded batch, with the config of ``TRAIN_PATHS[path]`` at
    ``layers`` layers; launch counts from a run that starts at zero."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    from deepspeed_tpu_torch.tree import tree_leaves
    model = LlamaForCausalLM("7b", num_layers=layers)
    cfg = model.cfg
    config = TRAIN_PATHS[path]
    t = time.perf_counter()
    engine, _, _, _ = dtt.initialize(model=model, config=config)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(engine.params))
    log(f"{path}: Llama-2-7B width, {cfg.num_layers} layers, "
        f"{n_params / 1e9:.3f} B params, optimizer "
        f"{type(engine.optimizer).__name__} {config['optimizer']['params']}"
        f", zero {config.get('zero_optimization', {})}, fp32 masters built "
        f"in {time.perf_counter() - t:.1f} s")
    rng = np.random.default_rng(SEED + 2)
    tokens = TRAIN_GAS * TRAIN_MICRO * TRAIN_SEQ
    batch = {"input_ids": rng.integers(
        0, cfg.vocab_size, (TRAIN_GAS * TRAIN_MICRO, TRAIN_SEQ)
    ).astype(np.int32)}

    reset_launches(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for _ in range(TRAIN_STEPS):
        lr = engine.get_lr()[0]
        t = time.perf_counter()
        loss = engine.train_batch(batch)     # ends in a host sync
        torch.cuda.synchronize()
        steps.append(dict(ms=(time.perf_counter() - t) * 1e3, loss=loss,
                          grad_norm=engine.get_global_grad_norm(), lr=lr))
    launches = read_launches(counters)
    flash_bwd = counters["flash_bwd"][0]
    by_fn = flash_bwd.launches_by_fn
    peak = torch.cuda.max_memory_allocated()

    L = cfg.num_layers
    micro_batches = TRAIN_STEPS * TRAIN_GAS
    leaves = tree_leaves(engine.params)
    n_leaves = len(leaves)
    n_two_dim = sum(p.dim() >= 2 for p in leaves)
    qwz_launches = n_two_dim * TRAIN_STEPS \
        if engine.config.quantized_weights else 0
    optimizer = PATH_OPTIMIZER[path]
    # remat runs each layer's forward twice: forward and recompute
    checks = {
        "finite": all(math.isfinite(st["loss"])
                      and math.isfinite(st["grad_norm"]) for st in steps),
        "first loss near ln V + 0.5": abs(
            steps[0]["loss"] - (math.log(cfg.vocab_size) + 0.5)) <= 1.5,
        "loss falls": steps[-1]["loss"] < steps[0]["loss"],
        "flash_fwd": launches["flash_fwd"] >= 2 * L * micro_batches,
        "flash_bwd": by_fn["flash_bwd_dkv_bf16"] == L * micro_batches
        and by_fn["flash_bwd_dq_bf16"] == L * micro_batches,
        optimizer: launches[optimizer] == n_leaves * TRAIN_STEPS,
        "other optimizers idle": all(launches[k] == 0 for k in set(
            PATH_OPTIMIZER.values()) - {optimizer}),
        "quantize, dequantize": launches["quantize"] == qwz_launches
        and launches["dequantize"] == qwz_launches,
        "11 of 12 leaves have ndim >= 2": n_two_dim == n_leaves - 1 == 11,
        "no operand copies": flash_bwd.copies == 0,
        "serving kernels idle": all(launches[k] == 0 for k in (
            "rmsnorm", "rmsnorm_res", "layernorm", "paged_attention",
            "paged_attention_int8", "paged_attention_combine")),
    }
    steady = [st["ms"] for st in steps[1:]]
    step_ms = sum(steady) / len(steady)
    # model flops per token: 6 N for the weights (forward + backward) with
    # N leaving out the input embedding (a gather, no flops; the lm head
    # is a GEMM and stays), 6 L S E for causal attention (QK^T and PV over
    # half the pairs); the remat recompute is not counted
    n_matmul = n_params - cfg.vocab_size * cfg.hidden_size
    flops_per_token = 6 * n_matmul + 6 * L * TRAIN_SEQ * cfg.hidden_size
    summary = dict(
        path=path, card=card, optimizer=config["optimizer"],
        zero_optimization=config.get("zero_optimization", {}),
        scheduler=config["scheduler"], layers=L, params=n_params,
        matmul_params=n_matmul,
        micro_batch=TRAIN_MICRO,
        seq=TRAIN_SEQ, gas=TRAIN_GAS, tokens_per_step=tokens,
        steps=steps, step_ms_steady=step_ms,
        tokens_per_s=tokens / (step_ms / 1e3),
        mfu=flops_per_token * tokens / (step_ms / 1e3) / BF16_FLOPS_PER_S,
        max_memory_allocated_gb=peak / 1e9, launches=launches,
        flash_bwd_launches_by_fn=dict(by_fn), checks=checks)
    log(f"{path}:", json.dumps(summary))
    if not all(checks.values()):
        raise RuntimeError(f"{path} checks failed: {checks}")
    profile_step(engine, batch, path)
    return engine, batch, launches


# kernel name fragment -> what it is, for the training step's breakdown
# (the first fragment found names the kind: "dequantize_blockwise" before
# "quantize_blockwise")
_KERNEL_KINDS = (("flash_fwd", "flash forward"),
                 ("flash_bwd_dkv", "flash backward dK/dV"),
                 ("flash_bwd_dq", "flash backward dQ"),
                 ("fused_adamw", "AdamW"),
                 ("fused_lion", "Lion"),
                 ("fused_lamb", "LAMB stage 1"),
                 ("dequantize_blockwise", "dequantise (qwZ)"),
                 ("fp_dequant", "dequantise (weights)"),
                 ("quantize_blockwise", "quantise (qwZ)"),
                 ("paged_split", "paged attention, split-KV decode"),
                 ("paged_combine", "paged attention, combine"),
                 ("paged_tile", "paged attention, tensor-core tile"),
                 ("layernorm_kernel", "LayerNorm"),
                 ("rmsnorm", "RMSNorm"),
                 ("gemm", "GEMM (cuBLAS)"), ("nvjet", "GEMM (cuBLAS)"),
                 ("xmma", "GEMM (cuBLAS)"), ("cutlass", "GEMM (cuBLAS)"))


def device_ms_by_kind(prof):
    """(device kernels, {kind: device ms}) of a torch.profiler run, the
    largest kind first.  Read from the profiler's raw results, with the
    names ``prof.events()`` gives them: building that list (every host
    operator as a Python event, then their tree) takes seconds a run at
    thousands of kernels a step, and the device events need none of it."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _rewrite_name
    by_kind, n_kernels = {}, 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA or ev.is_hidden_event():
            continue
        name = _rewrite_name(name=ev.name(), with_wildcard=True)
        n_kernels += 1
        kind = next((k for frag, k in _KERNEL_KINDS if frag in name),
                    "other (elementwise, reductions, copies)")
        by_kind[kind] = by_kind.get(kind, 0.0) + (
            ev.end_ns() - ev.start_ns()) / 1e3
    return n_kernels, {k: v / 1e3 for k, v in sorted(
        by_kind.items(), key=lambda kv: -kv[1])}


def profile_decode_steps(engine, reqs, label, step_ms, n_steps=4):
    """After the counted run: the same requests again (new uids, 16 new
    tokens), stepped until every one decodes, then ``n_steps`` decode
    steps (graph replays of the timed pass's keys; the profiler records
    the kernels inside a replay) under torch.profiler: device time per
    step by kernel kind, and the device's busy share of the unprofiled
    decode step (``step_ms``, from the counted run; the profiler
    stretches the host's share)."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import (FastGenScheduler,
                                                  SamplingParams)
    from torch.profiler import ProfilerActivity, profile
    sched = FastGenScheduler(engine, seed=SEED)
    for uid, (prompt, sp) in reqs.items():
        sched.submit(100 + uid, prompt, SamplingParams(
            max_new_tokens=16, temperature=sp.temperature, top_p=sp.top_p))
    while len(sched.step()) < len(reqs):
        if not sched.has_work:
            raise RuntimeError("profiled serving run ended before decoding")
    torch.cuda.synchronize()
    capture_s = engine.model.capture_seconds
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            if len(sched.step()) != len(reqs):
                raise RuntimeError("a profiled step was not a decode step")
        torch.cuda.synchronize()
    if engine.model.capture_seconds != capture_s:
        raise RuntimeError("a profiled decode step captured a graph")
    sched.run_to_completion()
    n_kernels, by_kind = device_ms_by_kind(prof)
    device_ms = sum(by_kind.values()) / n_steps
    res = dict(model=label, decode_rows=len(reqs), steps=n_steps,
               device_kernels_per_step=n_kernels / n_steps,
               device_ms_per_step=device_ms,
               decode_step_ms_unprofiled=step_ms,
               device_busy_share=device_ms / step_ms if n_kernels else None,
               device_ms_per_step_by_kind={k: v / n_steps
                                           for k, v in by_kind.items()})
    log(f"{label} decode step profile:", json.dumps(res))
    return res


def profile_step(engine, batch, path):
    """One more train_batch under torch.profiler (after the launch counts
    were read): device time by kernel kind and the device's busy share of
    the step's wall time (one stream, so kernels do not overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.train_batch(batch)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    n_kernels, by_kind = device_ms_by_kind(prof)
    device_ms = sum(by_kind.values())
    res = dict(path=path, step_wall_ms_profiled=wall_ms,
               device_kernels=n_kernels,
               device_ms=device_ms,
               device_busy_share=device_ms / wall_ms if n_kernels else None,
               device_ms_by_kind=by_kind)
    log(f"{path} step profile:", json.dumps(res))
    return res


def train_kernel_vs_plain(engine, batch):
    """One micro-batch's loss and gradients with the flash kernels and
    with the plain einsum path, from the engine's masters cast to bf16 as
    the engine casts them; then the AdamW kernel and its plain version
    on the kernel path's gradients and the optimizer's state."""
    import torch
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    from deepspeed_tpu_torch.ops import fused_optimizer as FO
    from deepspeed_tpu_torch.tree import tree_leaves, tree_map
    mb = {"input_ids": torch.as_tensor(batch["input_ids"][:TRAIN_MICRO],
                                       device=engine.device)}
    masters = tree_leaves(engine.params)

    def grads(attention_impl):
        model = LlamaForCausalLM("7b", num_layers=TRAIN_LAYERS,
                                 attention_impl=attention_impl)
        params_c = tree_map(
            lambda t: t.detach().to(torch.bfloat16).requires_grad_(),
            engine.params)
        loss = model.loss(params_c, mb)
        loss.backward()
        return float(loss.detach()), [c.grad for c in tree_leaves(params_c)]

    loss_k, grads_k = grads("auto")
    loss_p, grads_p = grads("einsum")
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_rms = [parity(a, b)["rms_rel_err"] for a, b in zip(grads_k, grads_p)]
    del grads_p
    torch.cuda.empty_cache()

    group = engine.optimizer.param_groups[0]
    hp = dict(lr=engine.get_lr()[0], b1=group["betas"][0],
              b2=group["betas"][1], eps=group["eps"],
              wd=group["weight_decay"])
    opt_err = 0.0
    for p, grad in zip(masters, grads_k):
        state = engine.optimizer.state[p]
        bufs = [p.detach().clone(), grad.float(), state["exp_avg"].clone(),
                state["exp_avg_sq"].clone()]
        ref = [x.clone() for x in bufs]
        FO.fused_adamw_flat(*bufs, **hp, step=state["step"] + 1)
        FO.adamw_reference(*ref, **hp, step=state["step"] + 1)
        opt_err = max(opt_err, *(parity(bufs[i], ref[i])["max_rel_err"]
                                 for i in (0, 2, 3)))
        del bufs, ref
    res = dict(loss_kernel=loss_k, loss_plain=loss_p, loss_rel_err=loss_rel,
               loss_rel_tol=LOSS_REL_TOL, grad_rms_rel_err_max=max(grad_rms),
               grad_rms_rel_err=grad_rms, grad_rms_rel_tol=GRAD_RMS_REL_TOL,
               adamw_max_rel_err=opt_err, adamw_max_rel_tol=OPT_MAX_REL_TOL)
    log("training kernel vs plain at full width:", json.dumps(res))
    if loss_rel > LOSS_REL_TOL or max(grad_rms) > GRAD_RMS_REL_TOL:
        raise RuntimeError(f"training: kernel path differs from the plain "
                           f"path: loss {loss_rel:.3e}, gradients "
                           f"{max(grad_rms):.3e}")
    if opt_err > OPT_MAX_REL_TOL:
        raise RuntimeError(f"AdamW kernel differs from its plain version on "
                           f"the model's gradients by {opt_err:.3e}")
    return res


def qwz_kernel_vs_plain(engine, batch):
    """The engine's qwZ compute tree (the quantise and dequantise kernels,
    fp32 masters straight into bf16) against the plain versions' bit for
    bit, leaf by leaf; then one micro-batch's loss on it against the loss
    on the plain bf16 cast of the same masters."""
    import torch
    from deepspeed_tpu_torch.ops import quantization as Q
    from deepspeed_tpu_torch.tree import tree_leaves, tree_map
    mb = {"input_ids": torch.as_tensor(batch["input_ids"][:TRAIN_MICRO],
                                       device=engine.device)}
    with torch.no_grad():
        params_q = engine._compute_params()
        engine._params_c = None          # leave the engine between steps
        differ = []
        for i, (p, c) in enumerate(zip(tree_leaves(engine.params),
                                       tree_leaves(params_q))):
            if p.dim() < 2:
                continue
            ref = Q.dequantize_blockwise_reference(
                *Q.quantize_blockwise_reference(p), p.shape, torch.bfloat16)
            if not torch.equal(c, ref):
                differ.append(i)
            del ref
        loss_q = float(engine.module.loss(params_q, mb))
        del params_q
        plain = tree_map(lambda p: p.to(torch.bfloat16), engine.params)
        loss_p = float(engine.module.loss(plain, mb))
        del plain
    rel = abs(loss_q - loss_p) / abs(loss_p)
    res = dict(leaves_differing_from_plain=differ, loss_qwz=loss_q,
               loss_unquantised=loss_p, loss_rel_diff=rel,
               loss_rel_tol=QWZ_LOSS_REL_TOL)
    log("qwZ compute tree, kernels vs plain:", json.dumps(res))
    if differ:
        raise RuntimeError(f"qwZ: leaves {differ} of the kernel tree differ "
                           f"from the plain versions'")
    if not 0 < rel <= QWZ_LOSS_REL_TOL:
        raise RuntimeError(f"qwZ moved the loss by {rel:.3e}, outside "
                           f"(0, {QWZ_LOSS_REL_TOL}]")
    return res



# ---------------------------------------------------------------------------
# phases 14 to 18: training the other families
# ---------------------------------------------------------------------------

def family_config(source, layers):
    """The training config of a family phase: a preset (``"gpt 1.3b"``)
    or a published ``config.json`` through the port's loader, bf16,
    depth cut to ``layers`` where given."""
    import dataclasses
    import torch
    from deepspeed_tpu_torch.checkpoint import hf as HF
    from deepspeed_tpu_torch.models.gpt import gpt_config
    if source.startswith("gpt "):
        cfg = gpt_config(source.split()[1])
    else:
        convert = {"tiiuae/falcon-7b": HF.falcon_config_from_hf,
                   "microsoft/phi-2": HF.phi_config_from_hf,
                   "microsoft/Phi-3-mini-4k-instruct":
                   HF.phi3_config_from_hf}[source]
        cfg = convert(types.SimpleNamespace(**HF.PUBLISHED_CONFIGS[source]))
    over = dict(dtype=torch.bfloat16, attention_impl="auto")
    if layers is not None:
        over["num_layers"] = layers
    return dataclasses.replace(cfg, **over)


def model_flops_per_token(cfg, n_params, seq):
    """6 N for the weights (N without the input embedding, a gather) and
    6 L S E for causal attention (QK^T and PV over half the pairs; the
    remat recompute is not counted): the MFU numerator of phase 10."""
    n_matmul = n_params - cfg.vocab_size * cfg.hidden_size
    if cfg.pos_emb == "learned":
        n_matmul -= cfg.max_seq_len * cfg.hidden_size
    return 6 * n_matmul + 6 * cfg.num_layers * seq * cfg.hidden_size


def family_train(counters, card, label, path, cfg, micro, steps, seed,
                 lm_head_bias=False, profile=False):
    """``steps`` train_batch calls through deepspeed_tpu_torch.initialize
    (AdamW, bf16 over fp32 masters built on the card from a seed, norms
    and biases drawn, gas 2, S = 2048) on one fixed seeded batch; every
    kernel's launch count from a run that starts at zero, held exactly:
    the flash forward twice a layer a micro-batch (remat), dK/dV and dQ
    once, AdamW once a leaf a step, every other kernel idle."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.transformer import CausalLM, init_params
    from deepspeed_tpu_torch.tree import tree_leaves
    model = CausalLM(cfg)
    config = dict(FAMILY_TRAIN_CONFIG, train_micro_batch_size_per_gpu=micro)
    t = time.perf_counter()
    params = randomize_norms_and_biases(
        init_params(cfg, seed=seed, device="cuda", dtype=torch.float32),
        seed + 1)
    if lm_head_bias:                 # the phi family ships one
        g = torch.Generator(device="cuda").manual_seed(seed + 2)
        params["lm_head_bias"] = 0.02 * torch.randn(
            cfg.vocab_size, generator=g, device="cuda")
    engine, _, _, _ = dtt.initialize(model=model, config=config,
                                     model_parameters=params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(engine.params))
    log(f"{path}: {label}, {cfg.num_layers} layers, head_dim "
        f"{cfg.dims_per_head}, heads {cfg.num_heads} / kv {cfg.kv_heads}, "
        f"window {cfg.sliding_window}, pos_emb {cfg.pos_emb}, "
        f"{n_params / 1e9:.3f} B params, fp32 masters built in "
        f"{time.perf_counter() - t:.1f} s")
    rng = np.random.default_rng(seed + 3)
    tokens = TRAIN_GAS * micro * TRAIN_SEQ
    batch = {"input_ids": rng.integers(
        0, cfg.vocab_size, (TRAIN_GAS * micro, TRAIN_SEQ)).astype(np.int32)}

    reset_launches(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    records = []
    for _ in range(steps):
        lr = engine.get_lr()[0]
        t = time.perf_counter()
        loss = engine.train_batch(batch)
        torch.cuda.synchronize()
        records.append(dict(ms=(time.perf_counter() - t) * 1e3, loss=loss,
                            grad_norm=engine.get_global_grad_norm(), lr=lr))
    launches = read_launches(counters)
    flash_bwd = counters["flash_bwd"][0]
    by_fn = dict(flash_bwd.launches_by_fn)
    peak = torch.cuda.max_memory_allocated()
    L, mbs = cfg.num_layers, steps * TRAIN_GAS
    n_leaves = len(tree_leaves(engine.params))
    ran = {"flash_fwd": 2 * L * mbs, "flash_bwd": 2 * L * mbs,
           "flash_bwd_dkv": L * mbs, "flash_bwd_dq": L * mbs,
           "fused_adamw": n_leaves * steps}
    checks = {
        "finite": all(math.isfinite(r["loss"])
                      and math.isfinite(r["grad_norm"]) for r in records),
        "launches exact": all(launches[k] == ran.get(k, 0)
                              for k in launches),
        "no operand copies": flash_bwd.copies == 0,
        f"peak under {FAMILY_PEAK_GB} GB": peak / 1e9 < FAMILY_PEAK_GB,
    }
    if steps >= 4:
        checks["loss falls"] = records[-1]["loss"] < records[0]["loss"]
    steady = [r["ms"] for r in records[1:]]
    step_ms = sum(steady) / len(steady)
    flops = model_flops_per_token(cfg, n_params, TRAIN_SEQ)
    summary = dict(
        path=path, model=label, card=card, layers=L, params=n_params,
        head_dim=cfg.dims_per_head, heads=cfg.num_heads,
        kv_heads=cfg.kv_heads, window=cfg.sliding_window,
        micro_batch=micro, seq=TRAIN_SEQ, gas=TRAIN_GAS,
        tokens_per_step=tokens, steps=records, step_ms_steady=step_ms,
        tokens_per_s=tokens / (step_ms / 1e3),
        mfu=flops * tokens / (step_ms / 1e3) / BF16_FLOPS_PER_S,
        first_loss_minus_ln_v=records[0]["loss"] - math.log(cfg.vocab_size),
        max_memory_allocated_gb=peak / 1e9, launches=launches,
        launches_expected=ran, flash_bwd_launches_by_fn=by_fn,
        checks=checks)
    log(f"{path}:", json.dumps(summary))
    if not all(checks.values()):
        raise RuntimeError(f"{path} checks failed: {checks}")
    if profile:
        summary["profile"] = profile_step(engine, batch, path)
    return engine, batch, launches, summary


def _path_parity(loss_a, grads_a, loss_b, grads_b, names):
    """|delta loss| / loss and each leaf's rms(grad delta) / rms(grad),
    b the reference; the key bias ``bk`` is reported apart: its gradient
    is zero but for rounding (a softmax row is invariant to the constant
    q . b_k adds to it), so its relative error measures noise."""
    rms = {n: parity(a, b)["rms_rel_err"]
           for n, a, b in zip(names, grads_a, grads_b)}
    held = {n: r for n, r in rms.items() if not n.endswith("['bk']")}
    return dict(loss_a=loss_a, loss_b=loss_b,
                loss_rel_err=abs(loss_a - loss_b) / abs(loss_b),
                loss_rel_tol=LOSS_REL_TOL,
                grad_rms_rel_err_max=max(held.values()),
                grad_rms_rel_tol=GRAD_RMS_REL_TOL,
                grad_rms_rel_err=rms)


def leaf_names(tree, prefix=""):
    """Leaf paths of a nested dict in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in leaf_names(v, f"{prefix}['{k}']")]
    return [prefix]


def padded_vs_unpadded(cfg, params_c, label, seed):
    """One right-padded micro-batch of mixed lengths (a full row and one
    of PADDED_SHORT tokens) through the training loss: the mask takes
    the einsum path (no flash launch); against it, each row alone and
    unpadded through the flash kernels, the losses weighted by their
    token counts (the padded loss is the mean over every real token):
    loss and every leaf's gradient."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.models.transformer import CausalLM
    from deepspeed_tpu_torch.ops import flash_attention as FA
    from deepspeed_tpu_torch.tree import tree_leaves
    model = CausalLM(cfg)
    rng = np.random.default_rng(seed)
    lengths = (TRAIN_SEQ, PADDED_SHORT)
    am = (np.arange(TRAIN_SEQ)[None] < np.asarray(lengths)[:, None]
          ).astype(np.int32)
    ids = np.where(am == 1, rng.integers(0, cfg.vocab_size, am.shape), 0)
    ids = torch.as_tensor(ids.astype(np.int32), device="cuda")
    am = torch.as_tensor(am, device="cuda")
    leaves = tree_leaves(params_c)
    for c in leaves:
        c.requires_grad_()
    fa, fwd = FA.BWD_KERNEL, FA.KERNEL
    before = (fa.launches, fwd.launches)
    loss_p = model.loss(params_c, {"input_ids": ids, "attention_mask": am})
    loss_p.backward()
    padded_flash = (fa.launches - before[0], fwd.launches - before[1])
    grads_p = [c.grad for c in leaves]
    for c in leaves:
        c.grad = None
    counts = [n - 1 for n in lengths]
    before = (fa.launches, fwd.launches)
    loss_u = 0.0
    for i, n in enumerate(lengths):
        li = model.loss(params_c, {"input_ids": ids[i:i + 1, :n]})
        (li * (counts[i] / sum(counts))).backward()
        loss_u += float(li.detach()) * counts[i] / sum(counts)
    unpadded_flash = (fa.launches - before[0], fwd.launches - before[1])
    grads_u = [c.grad for c in leaves]
    res = _path_parity(float(loss_p.detach()), grads_p, loss_u, grads_u,
                       leaf_names(params_c))
    L = cfg.num_layers
    res.update(model=label, lengths=lengths,
               padded_flash_launches=padded_flash,
               unpadded_flash_launches=unpadded_flash)
    del grads_p, grads_u
    for c in leaves:
        c.grad = None
    log(f"{label} right-padded micro-batch (einsum) against its rows "
        f"unpadded (flash kernels):", json.dumps(res))
    if padded_flash != (0, 0) or unpadded_flash != (2 * L * 2, 2 * L * 2):
        raise RuntimeError(f"{label}: flash launches padded {padded_flash},"
                           f" unpadded {unpadded_flash}")
    if res["loss_rel_err"] > LOSS_REL_TOL \
            or res["grad_rms_rel_err_max"] > GRAD_RMS_REL_TOL:
        raise RuntimeError(f"{label}: the padded micro-batch differs from "
                           f"its rows unpadded: {res}")
    return res


def family_kernel_vs_plain(cfg, params_c, batch, label):
    """One micro-batch's loss and every leaf's gradient with the flash
    kernels ("auto") and with the plain einsum path, from one bf16 copy
    of the masters (phase 11's check at the family's head dim)."""
    import dataclasses
    import torch
    from deepspeed_tpu_torch.models.transformer import CausalLM
    from deepspeed_tpu_torch.tree import tree_leaves
    mb = {"input_ids": torch.as_tensor(batch["input_ids"][:2],
                                       device="cuda")}
    leaves = tree_leaves(params_c)
    out = []
    for impl in ("auto", "einsum"):
        for c in leaves:
            c.grad = None
            c.requires_grad_()
        model = CausalLM(dataclasses.replace(cfg, attention_impl=impl))
        loss = model.loss(params_c, mb)
        loss.backward()
        out.append((float(loss.detach()), [c.grad for c in leaves]))
    res = _path_parity(out[0][0], out[0][1], out[1][0], out[1][1],
                       leaf_names(params_c))
    res["model"] = label
    del out
    for c in leaves:
        c.grad = None
    log(f"{label} training, kernel path against the plain einsum path:",
        json.dumps(res))
    if res["loss_rel_err"] > LOSS_REL_TOL \
            or res["grad_rms_rel_err_max"] > GRAD_RMS_REL_TOL:
        raise RuntimeError(f"{label}: the kernel path differs from the "
                           f"plain path: {res}")
    return res


def families_phase(counters, card):
    """Phases 14-17: each family of FAMILY_PATHS trained, then GPT-1.3B's
    and Phi-2's masters through the padded check, and every family's
    through the kernel-vs-plain check, each engine freed before the next
    is built.  Returns ({path: launches}, {path:
    summary})."""
    import torch
    from deepspeed_tpu_torch.tree import tree_map
    launches, summaries = {}, {}
    for label, path, source, layers, micro, steps, seed in FAMILY_PATHS:
        cfg = family_config(source, layers)
        full = layers is None
        engine, batch, launches[path], summary = family_train(
            counters, card, label, path, cfg, micro, steps, seed,
            lm_head_bias=source == "microsoft/phi-2", profile=full)
        params_c = tree_map(lambda t: t.detach().to(torch.bfloat16),
                            engine.params)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        if full:
            summary["padded"] = padded_vs_unpadded(cfg, params_c, label,
                                                   seed + 5)
        summary["kernel_vs_plain"] = family_kernel_vs_plain(
            cfg, params_c, batch, label)
        summaries[path] = summary
        del params_c
        gc.collect()
        torch.cuda.empty_cache()
    return launches, summaries


def bert_samples(n, vocab, seed):
    """n masked-LM samples of BERT_SEQ tokens, right-padded: lengths from
    [128, BERT_SEQ], BERT_MASK_RATE of the real tokens labelled (at least
    one), -100 elsewhere (the Hugging Face convention)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lengths = rng.integers(128, BERT_SEQ + 1, n)
    pos = np.arange(BERT_SEQ)[None]
    am = (pos < lengths[:, None]).astype(np.int32)
    ids = np.where(am == 1, rng.integers(0, vocab, am.shape), 0)
    chosen = (am == 1) & (rng.random(am.shape) < BERT_MASK_RATE)
    chosen[:, 0] = True
    labels = np.where(chosen, rng.integers(0, vocab, am.shape), -100)
    return [{"input_ids": ids[i].astype(np.int32), "attention_mask": am[i],
             "labels": labels[i].astype(np.int32)} for i in range(n)]


class RecordedSamples:
    """A list of samples that records each index the loader reads."""

    def __init__(self, samples):
        self.samples, self.reads = samples, []

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        self.reads.append(int(i))
        return self.samples[i]


def bert_phase(counters, card):
    """Phase 18: BERT-large masked LM at full width and depth through
    ``initialize(training_data=...)`` (the engine's loader) and
    ``train_batch(data_iter=RepeatingLoader(loader))``: BERT_STEPS steps
    of gas 2, every sample read once in order, bidirectional attention
    under a padding mask on the einsum path (no flash launch), AdamW
    once a leaf a step, every other kernel idle."""
    import torch
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.bert import BertForMaskedLM
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader
    from deepspeed_tpu_torch.tree import tree_leaves
    model = BertForMaskedLM("large")
    cfg = model.cfg
    n = BERT_STEPS * TRAIN_GAS * BERT_MICRO
    data = RecordedSamples(bert_samples(n, cfg.vocab_size, SEED + 41))
    config = dict(FAMILY_TRAIN_CONFIG,
                  train_micro_batch_size_per_gpu=BERT_MICRO)
    t = time.perf_counter()
    engine, _, loader, _ = dtt.initialize(model=model, config=config,
                                          training_data=data)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(engine.params))
    log(f"training_bert_large: {n_params / 1e9:.3f} B params, fp32 masters "
        f"built in {time.perf_counter() - t:.1f} s, loader of {len(loader)}"
        f" batches of {BERT_MICRO}")
    it = RepeatingLoader(loader)
    reset_launches(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    records = []
    for _ in range(BERT_STEPS):
        t = time.perf_counter()
        loss = engine.train_batch(data_iter=it)
        torch.cuda.synchronize()
        records.append(dict(ms=(time.perf_counter() - t) * 1e3, loss=loss,
                            grad_norm=engine.get_global_grad_norm()))
    launches = read_launches(counters)
    peak = torch.cuda.max_memory_allocated()
    ran = {"fused_adamw": len(tree_leaves(engine.params)) * BERT_STEPS}
    masked = sum(int((s["labels"] >= 0).sum()) for s in data.samples)
    real = sum(int(s["attention_mask"].sum()) for s in data.samples)
    checks = {
        "finite": all(math.isfinite(r["loss"])
                      and math.isfinite(r["grad_norm"]) for r in records),
        "every sample read once, in order": data.reads == list(range(n)),
        "launches exact": all(launches[k] == ran.get(k, 0)
                              for k in launches),
    }
    steady = [r["ms"] for r in records[1:]]
    step_ms = sum(steady) / len(steady)
    tokens = TRAIN_GAS * BERT_MICRO * BERT_SEQ
    summary = dict(
        path="training_bert_large", model="BERT-large", card=card,
        layers=cfg.num_layers, params=n_params, micro_batch=BERT_MICRO,
        seq=BERT_SEQ, gas=TRAIN_GAS, steps=records, step_ms_steady=step_ms,
        tokens_per_s=tokens / (step_ms / 1e3), real_token_share=real / (
            n * BERT_SEQ), masked_share_of_real=masked / real,
        first_loss_minus_ln_v=records[0]["loss"] - math.log(cfg.vocab_size),
        max_memory_allocated_gb=peak / 1e9, launches=launches,
        launches_expected=ran, checks=checks)
    log("training_bert_large:", json.dumps(summary))
    if not all(checks.values()):
        raise RuntimeError(f"training_bert_large checks failed: {checks}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches, summary


# ---------------------------------------------------------------------------

# phase 19: checkpoints, the universal format, the offline tools and
# self-healing, at Llama-2-7B width cut to 1 layer (0.46 B params: 1.9 GB
# of fp32 masters and 3.7 GB of AdamW moments a checkpoint; cut from 2 to
# make room for phase 20)
CKPT_LAYERS = 1
CKPT_STEPS = 2                 # train_batch calls before and after a save
CKPT_DISK_GB = 20.0            # the phase's peak on disk: two AdamW tags
                               # or one and its universal atoms, plus room
CKPT_SIMPLE_HIDDEN = 4096      # the MLP of the NaN rollback (33.6 M params)
CKPT_PATHS = {"training_checkpoint": "training",
              "training_checkpoint_lion": "training_lion_qwz",
              "training_checkpoint_lamb": "training_lamb"}


class HostPeak:
    """The process's peak resident set while the context is open, sampled
    every 20 ms from /proc/self/statm (ru_maxrss is the peak since the
    process began)."""

    def __init__(self):
        import os
        import threading
        self._page = os.sysconf("SC_PAGE_SIZE")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self.peak = 0

    def _rss(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self._page

    def _run(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, self._rss())
            self._stop.wait(0.02)

    def __enter__(self):
        self.peak = self._rss()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        return False


def dir_bytes(path) -> int:
    import os
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def ckpt_tensors(engine):
    """The state a checkpoint holds, in a fixed order: every master, then
    each master's moments."""
    out = list(engine.masters)
    for p in engine.masters:
        st = engine.optimizer.state[p]
        out += [st[k] for k in sorted(st) if k != "step"]
    return out


def same_tensors(a, b) -> bool:
    import torch
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def checkpoint_phase(counters, card):
    """Phase 19 (module docstring).  Returns (launches by path, summary)."""
    import os
    import shutil
    import tempfile
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.checkpoint import universal as U
    from deepspeed_tpu_torch.checkpoint import zero_to_fp32 as Z
    from deepspeed_tpu_torch.models.base import SimpleModel
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    from deepspeed_tpu_torch.runtime import fault_injection as FI
    from deepspeed_tpu_torch.telemetry import metrics as tm
    from deepspeed_tpu_torch.tree import tree_leaves

    root = tempfile.mkdtemp(prefix="ds_ckpt_")
    free_bytes = shutil.disk_usage(root).free
    log(f"checkpoints: {root}, {free_bytes / 1e9:.1f} GB free; {card}")
    if free_bytes < CKPT_DISK_GB * 1e9:
        shutil.rmtree(root, ignore_errors=True)
        raise RuntimeError(f"phase 19 needs {CKPT_DISK_GB:.0f} GB free under "
                           f"{root}; {free_bytes / 1e9:.1f} GB are")
    rng = np.random.default_rng(SEED + 51)
    vocab = LlamaForCausalLM("7b", num_layers=CKPT_LAYERS).cfg.vocab_size
    batches = [{"input_ids": rng.integers(
        0, vocab, (TRAIN_GAS * TRAIN_MICRO, TRAIN_SEQ)).astype(np.int32)}
        for _ in range(2 * CKPT_STEPS)]
    fi = FI.get_fault_injector()
    steps = {path: 0 for path in CKPT_PATHS}
    leaves = {}

    def engine_for(path, **over):
        config = dict(TRAIN_PATHS[CKPT_PATHS[path]], **over)
        engine, *_ = dtt.initialize(
            model=LlamaForCausalLM("7b", num_layers=CKPT_LAYERS),
            config=config)
        leaves[path] = len(tree_leaves(engine.params))
        return engine

    def run(engine, path, bs):
        steps[path] += len(bs)
        out = [engine.train_batch(b) for b in bs]
        torch.cuda.synchronize()
        return out

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    summary, checks, launches_by_path = {"card": card}, {}, {}
    head, tail = batches[:CKPT_STEPS], batches[CKPT_STEPS:]
    torch.cuda.reset_peak_memory_stats()
    try:
        with HostPeak() as host:
            # (a) resume is exact, with async_save off and on
            path = "training_checkpoint"
            reset_launches(counters)
            straight = engine_for(path)
            ref_losses = run(straight, path, batches)
            ref = [t.clone() for t in ckpt_tensors(straight)]
            n_params = sum(p.numel() for p in straight.masters)
            del straight
            free()
            for mode in ("sync", "async"):
                d = os.path.join(root, mode)
                a = engine_for(path, checkpoint={"async_save": mode ==
                                                 "async"})
                losses = run(a, path, head)
                tag = f"global_step{CKPT_STEPS}"
                if mode == "sync":
                    # (c) the engine's own export at the state it saves
                    live = a.get_fp32_state_dict()
                _, save_s = timed(lambda: a.save_checkpoint(
                    d, save_latest=False))
                t_ret = time.perf_counter()
                # the next steps update the masters in place while the
                # writer persists its host copy
                cont = run(a, path, tail)
                t_steps = time.perf_counter()
                a.checkpoint_engine.wait()
                t_wait = time.perf_counter()
                a.checkpoint_engine.write_latest(d, tag)
                t_latest = time.perf_counter()
                nbytes = dir_bytes(os.path.join(d, tag))
                saver_ok = same_tensors(ckpt_tensors(a), ref)
                if mode == "sync":
                    fp32, z_s = timed(
                        lambda: Z.get_fp32_state_dict_from_zero_checkpoint(d))
                    checks["(c) zero_to_fp32 equals get_fp32_state_dict"] = \
                        all(np.array_equal(x, y) for x, y in zip(
                            tree_leaves(live), tree_leaves(fp32)))
                    del live, fp32
                del a
                free()
                b = engine_for(path)
                (tag_b, _), load_s = timed(lambda: b.load_checkpoint(d))
                resumed = run(b, path, tail)
                checks[f"(a) {mode}: resumed losses bit-equal"] = (
                    losses + resumed == ref_losses and
                    losses + cont == ref_losses)
                checks[f"(a) {mode}: masters and moments bit-equal"] = (
                    saver_ok and same_tensors(ckpt_tensors(b), ref))
                checks[f"(a) {mode}: latest names the tag"] = tag_b == tag
                summary[f"save_{mode}"] = dict(
                    bytes=nbytes, save_returned_s=save_s,
                    save_returned_gb_s=nbytes / save_s / 1e9,
                    steps_during_write_s=t_steps - t_ret,
                    wait_s=t_wait - t_steps,
                    returned_to_latest_s=t_latest - t_ret,
                    load_s=load_s, load_gb_s=nbytes / load_s / 1e9)
                if mode == "sync":
                    summary["zero_to_fp32_read_s"] = z_s
                del b
                free()
                if mode == "async":
                    shutil.rmtree(d)
            d = os.path.join(root, "sync")
            # (b) the universal round trip, AdamW: from (a)'s tag
            u, conv_s = timed(lambda: U.ds_to_universal(d))
            c = engine_for(path, checkpoint={"load_universal": True})
            _, uload_s = timed(lambda: c.load_checkpoint(d))
            checks["(b) adamw: universal losses bit-equal"] = (
                run(c, path, tail) == ref_losses[CKPT_STEPS:])
            checks["(b) adamw: masters and moments bit-equal"] = \
                same_tensors(ckpt_tensors(c), ref)
            summary["universal_adamw"] = dict(
                atoms_bytes=dir_bytes(u), convert_s=conv_s, load_s=uload_s)
            shutil.rmtree(u)
            # (c) the offline converters, timed
            out = os.path.join(root, "fp32.npz")
            _, conv32_s = timed(
                lambda: Z.convert_zero_checkpoint_to_fp32_state_dict(d, out))
            _, s16_s = timed(lambda: c.save_16bit_model(root))
            summary["offline"] = dict(
                zero_to_fp32_convert_s=conv32_s,
                fp32_npz_bytes=os.path.getsize(out),
                save_16bit_model_s=s16_s, bf16_npz_bytes=os.path.getsize(
                    os.path.join(root, "model_weights.npz")))
            os.remove(out)
            os.remove(os.path.join(root, "model_weights.npz"))
            del c
            free()
            shutil.rmtree(d)
            # (d) comm.collective_failure at call 1: the same batch again
            g = engine_for(path, fault_tolerance={"self_healing": True,
                                                  "backoff_s": 0.001})
            tries = tm.TRAIN_RETRY.value
            fi.configure({"comm.collective_failure": {"at_calls": [1]}})
            faulted = run(g, path, batches[:1])
            fi.disarm()
            checks["(d) collective_failure retried, bit-equal"] = (
                faulted + run(g, path, batches[1:]) == ref_losses
                and tm.TRAIN_RETRY.value == tries + 1
                and same_tensors(ckpt_tensors(g), ref))
            del g, ref
            free()
            # (d) train.nan_grad on the MLP: rollback to the checkpoint,
            # then (its pointer cleared) to the host snapshot
            model = SimpleModel(CKPT_SIMPLE_HIDDEN)
            s_engine, *_ = dtt.initialize(model=model, config=dict(
                TRAIN_CONFIG, scheduler=None, bf16={"enabled": False},
                fault_tolerance={"self_healing": True, "backoff_s": 0.001,
                                 "snapshot_interval": 1}))
            x = torch.Generator().manual_seed(SEED + 53)

            def mlp_batch():
                return {k: torch.randn(TRAIN_GAS * TRAIN_MICRO,
                                       CKPT_SIMPLE_HIDDEN, generator=x)
                        for k in ("x", "y")}
            rollbacks = tm.TRAIN_ROLLBACK.value
            nan_steps = 0
            for _ in range(2):
                s_engine.train_batch(mlp_batch())
            d = os.path.join(root, "mlp")
            s_engine.save_checkpoint(d)
            # (d) ckpt.io_error: retried at call 1 (latest names the new
            # tag), then armed at every call (the save raises, latest
            # stays)
            retries = tm.TRAIN_CKPT_RETRY.value
            fi.configure({"ckpt.io_error": {"at_calls": [1]}})
            s_engine.save_checkpoint(d, tag="io_retried")
            checks["(d) io_error at call 1 retried, latest names it"] = (
                s_engine.checkpoint_engine.read_latest(d) == "io_retried"
                and tm.TRAIN_CKPT_RETRY.value == retries + 1)
            fi.configure({"ckpt.io_error": {"p": 1.0}})
            try:
                s_engine.save_checkpoint(d, tag="io_failed")
                raised = False
            except OSError:
                raised = True
            fi.disarm()
            checks["(d) io_error every call raises, latest kept"] = (
                raised and s_engine.checkpoint_engine.read_latest(d) ==
                "io_retried")
            good_ckpt = [t.clone() for t in ckpt_tensors(s_engine)]
            s_engine.train_batch(mlp_batch())
            good_snap = [t.clone() for t in ckpt_tensors(s_engine)]
            verdicts = []
            for target in (good_ckpt, good_snap):
                fi.configure({"train.nan_grad": {"at_calls": [1]}})
                loss = s_engine.train_batch(mlp_batch())
                fi.disarm()
                nan_steps += 1
                verdicts.append(not math.isfinite(loss) and same_tensors(
                    ckpt_tensors(s_engine), target))
                s_engine._last_good_ckpt = None
            checks["(d) nan_grad rolled back to the checkpoint, bit-equal"] \
                = verdicts[0]
            checks["(d) nan_grad rolled back to the snapshot, bit-equal"] = \
                verdicts[1]
            checks["(d) two rollbacks counted"] = (
                tm.TRAIN_ROLLBACK.value == rollbacks + 2
                and s_engine.global_steps == 3)
            mlp_leaves = len(s_engine.masters)
            del s_engine, good_ckpt, good_snap
            shutil.rmtree(d)
            launches_by_path[path] = read_launches(counters)
            mlp_adamw = mlp_leaves * (3 + nan_steps)
            summary["universal"] = {}
            # (b) Lion (stage 3, qwZ) and LAMB: a save mid-run against the
            # run going on, then the universal round trip into a fresh
            # engine
            for path in ("training_checkpoint_lion",
                         "training_checkpoint_lamb"):
                reset_launches(counters)
                d = os.path.join(root, path)
                e = engine_for(path)
                losses = run(e, path, head)
                e.save_checkpoint(d)
                losses += run(e, path, tail)
                want = [t.clone() for t in ckpt_tensors(e)]
                del e
                free()
                u, conv_s = timed(lambda: U.ds_to_universal(d))
                f = engine_for(path, checkpoint={"load_universal": True})
                _, uload_s = timed(lambda: f.load_checkpoint(d))
                kind = f.optimizer_kind
                checks[f"(b) {kind}: universal losses bit-equal"] = (
                    run(f, path, tail) == losses[CKPT_STEPS:])
                checks[f"(b) {kind}: masters and moments bit-equal"] = \
                    same_tensors(ckpt_tensors(f), want)
                summary["universal"][kind] = dict(
                    checkpoint_bytes=dir_bytes(os.path.join(
                        d, f"global_step{CKPT_STEPS}")),
                    atoms_bytes=dir_bytes(u), convert_s=conv_s,
                    load_s=uload_s)
                del f, want
                free()
                shutil.rmtree(d)
                launches_by_path[path] = read_launches(counters)
    finally:
        fi.disarm()
        shutil.rmtree(root, ignore_errors=True)
    # launch counts: every training step of a path runs the flash pair
    # and its optimizer once a leaf; the MLP's steps add AdamW only
    L = CKPT_LAYERS
    for path, launches in launches_by_path.items():
        opt = PATH_OPTIMIZER[CKPT_PATHS[path]]
        mb = steps[path] * TRAIN_GAS
        want = leaves[path] * steps[path] + (
            mlp_adamw if path == "training_checkpoint" else 0)
        checks[f"{path}: launches"] = (
            launches["flash_fwd"] >= 2 * L * mb
            and launches["flash_bwd_dkv"] == L * mb
            and launches["flash_bwd_dq"] == L * mb
            and launches[opt] == want)
    summary.update(
        params=n_params, layers=CKPT_LAYERS, steps=steps,
        peak_host_gb=host.peak / 1e9,
        peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launches_by_path, checks=checks)
    log("checkpoints:", json.dumps(summary))
    for mode in ("sync", "async"):
        r = summary[f"save_{mode}"]
        log(f"checkpoints {mode}: {r['bytes'] / 1e9:.3f} GB, save() "
            f"returned in {r['save_returned_s']:.2f} s "
            f"({r['save_returned_gb_s']:.2f} GB/s), latest written "
            f"{r['returned_to_latest_s']:.2f} s after it (two steps "
            f"{r['steps_during_write_s']:.2f} s, wait {r['wait_s']:.2f} s), "
            f"load {r['load_s']:.2f} s ({r['load_gb_s']:.2f} GB/s, a warm "
            f"read); {card}")
    log(f"checkpoints: peak host {host.peak / 1e9:.2f} GB, peak device "
        f"{summary['peak_device_gb']:.2f} GB; {card}")
    if not all(checks.values()):
        raise RuntimeError(f"phase 19 checks failed: "
                           f"{[k for k, v in checks.items() if not v]}")
    return launches_by_path, summary


# ---------------------------------------------------------------------------
# phase 20: training past the card's memory (ZeRO-Offload to the host and
# NVMe, the host kernels, the remat policies, Llama-2-7B at full depth)
# ---------------------------------------------------------------------------

# (a) the host kernels on one Llama-2-7B MLP leaf, fp32, HOST_STEPS steps
HOST_LEAF = (4096, 11008)
HOST_STEPS = 3
# host kernel vs its plain PyTorch version (fp32 on the CPU): max |delta| /
# max |ref| of p and of each state slot after HOST_STEPS steps.  The plain
# versions take the decayed gradient g + wd * p and Lion's b1 * m +
# (1 - b1) * g as the kernels' fused multiply-adds give them (fp64, then
# one rounding); elsewhere the order of operations moves a value by a few
# ulp.  CPU stand-in (this function on the CPU): p and slots within
# 1.4e-7..9.1e-7.  Lion's sign of a near-tie (|b1 m + (1 - b1) g| within
# 1e-6 of its largest) follows m's last ulp: counted, not held (1 of
# 45.1 M elements on the stand-in); every other element is held.
HOST_OPT_MAX_REL_TOL = 1e-5
HOST_AIO_BYTES = 1 << 30
# the host's memory rate for the host kernels' bound: streaming probes
# over two buffers of HOST_PROBE_BYTES, the best of HOST_PROBE_REPS each,
# once before the kernels and once after, and in (d)'s child before its
# steps (host_stream_gb_s; the host is shared, and its rate drifts by a
# tenth or more within a run)
HOST_PROBE_BYTES = 1 << 30
HOST_PROBE_REPS = 8
# (b) phase 10's configuration with the optimizer offloaded, held to the
# device run on the same weights and batch after TRAIN_STEPS steps: the
# losses (largest |delta| over the steps), and get_fp32_state_dict()'s
# masters against the device run's, leaf by leaf: the update gap
# rms(run - device) / rms(device - initial) and the decay gap
# |<device - run, device>| / <device, device> (a weight decay the host
# dropped moves every master by sum(lr) * wd = 9.3e-5 along itself).
# The host Adam and the device AdamW kernel differ in rounding only.
# Each limit lies near the geometric mean of the sound runs' largest
# reading and the smallest planted fault's it is to catch (OFFLOAD_FAULTS:
# the host optimizer given a wrong beta2, no weight decay, or L2 in place
# of decoupled decay, at OFFLOAD_NVME_LAYERS layers with every leaf
# offloaded), which the phase requires each to fail.  NVIDIA H100 80GB
# HBM3, 700 W, 8 host cores: sound runs (cpu at 1.0 and 0.5, nvme) loss
# gap <= 8.2e-4, update gap <= 0.019, decay gap <= 4.7e-7; beta2 0.999
# 3.6e-2 / 0.024 / 2.1e-5; weight decay 0 1.4e-3 / 0.26 / 9.3e-5; L2
# 9.27 / 3.16 / 8.2e-2.  Every fault fails at least two of the three.
OFFLOAD_LOSS_MAX = 5e-3
# and JAX tests/test_offload.py's own loss tolerance, held as well
OFFLOAD_LOSS_RTOL = 2e-3
OFFLOAD_LOSS_ATOL = 2e-4
OFFLOAD_UPDATE_GAP = 0.07
OFFLOAD_DECAY_GAP = 3e-6
OFFLOAD_FAULTS = {
    "fault_beta2_0.999": {"betas": [0.9, 0.999]},
    "fault_weight_decay_0": {"weight_decay": 0.0},
    "fault_l2_not_decoupled": {"type": "adam", "adam_w_mode": False},
}
OFFLOAD_RATIOS = (1.0, 0.5)
# the device reference and the runs at OFFLOAD_RATIOS: 4 of 32 layers
# (8 before phase 21 needed the room)
OFFLOAD_LAYERS = 4
OFFLOAD_NVME_LAYERS = 2
# (d) Llama-2-7B at full depth: micro 1 x 2048, gas 1, 3 steps; ratio 1.0
# when the host has FULL_DEPTH_HOST_GB available (fp32 masters and Adam
# moments of 6.74 B parameters, 80.9 GB, and the 5.77 GB staging buffer
# of the largest leaf), else 0.9
FULL_DEPTH_STEPS = 2
FULL_DEPTH_HOST_GB = 92.0
FULL_DEPTH_PEAK_GB = 75.0


def _offload_config(ratio, device="cpu", nvme_path=None, fault=None):
    """TRAIN_CONFIG with the optimizer offloaded; ``fault``: optimizer
    keys to change (``type`` among them) for a planted fault."""
    off = {"device": device, "ratio": ratio}
    if nvme_path:
        off["nvme_path"] = nvme_path
    opt = TRAIN_CONFIG["optimizer"]
    if fault:
        fault = dict(fault)
        opt = {"type": fault.pop("type", opt["type"]),
               "params": dict(opt["params"], **fault)}
    return dict(TRAIN_CONFIG, optimizer=opt, zero_optimization={
        "stage": 0, "offload_optimizer": off})


def host_stream_gb_s(n_bytes=HOST_PROBE_BYTES,
                     reps=HOST_PROBE_REPS) -> dict:
    """The host's peak memory rate: streaming passes of PyTorch's CPU
    kernels on every core (``torch.set_num_threads(os.cpu_count())``)
    over fp32 buffers of ``n_bytes``, far past the last-level cache, each
    the best of ``reps``, its bytes counted as each input read once and
    each output written once: ``read`` (a sum), ``scale`` (a multiply in
    place), ``add`` (an add in place: two reads, one write; the host
    optimizers' pattern) and ``copy`` (whose write-allocate traffic goes
    uncounted).  Returns GB/s by probe and ``peak``, the fastest."""
    import os
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count())
    try:
        a = torch.full((n_bytes // 4,), 1.0)
        b = torch.full_like(a, 0.5)
        probes = {"read": (a.sum, 1),
                  "scale": (lambda: a.mul_(-1.0), 2),
                  "add": (lambda: a.add_(b), 3),
                  "copy": (lambda: b.copy_(a), 2)}
        rates = {}
        for name, (fn, passes) in probes.items():
            best = math.inf
            for _ in range(reps):
                t = time.perf_counter()
                fn()
                best = min(best, time.perf_counter() - t)
            rates[name] = passes * n_bytes / best / 1e9
        del a, b
    finally:
        torch.set_num_threads(threads)
    rates["peak"] = max(rates.values())
    return rates


def _fma_grad(g, p, wd):
    """g + wd * p as the kernels' fused multiply-add rounds it."""
    import numpy as np
    return (g.double() + float(np.float32(wd)) * p.double()).float()


def _plain_adam(p, g, m, v, step, lr, b1, b2, eps, wd, adamw):
    if not adamw and wd:
        g = _fma_grad(g, p, wd)
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    bc1, bc2 = 1 - b1 ** step, math.sqrt(1 - b2 ** step)
    if adamw and wd:
        p.mul_(1 - lr * wd)
    p.addcdiv_(m, v.sqrt().div_(bc2).add_(eps), value=-lr / bc1)


def _plain_adagrad(p, g, v, lr, eps, wd):
    if wd:
        g = _fma_grad(g, p, wd)
    v.addcmul_(g, g)
    p.addcdiv_(g, v.sqrt().add_(eps), value=-lr)


def _lion_direction(m, g, b1):
    """b1 * m + (1 - b1) * g as the kernel's fused multiply-add rounds it
    (fp64 here), whose sign is Lion's update."""
    import numpy as np
    b1f = float(np.float32(b1))
    b1m = np.float32(1) - np.float32(b1)
    return b1f * m.double() + (g * float(b1m)).double()


def _plain_lion(p, g, m, lr, b1, b2, wd):
    u = _lion_direction(m, g, b1).sign().float()
    if wd:
        p.mul_(1 - lr * wd)
    p.add_(u, alpha=-lr)
    m.mul_(b2).add_(g, alpha=1 - b2)


# name -> (host optimizer kwargs, state slots, library call or None)
HOST_CASES = {
    "cpu_adamw": dict(kind="adam", adamw=True, lr=3e-4, betas=(0.9, 0.95),
                      eps=1e-8, wd=0.1),
    "cpu_adam_l2": dict(kind="adam", adamw=False, lr=3e-4, betas=(0.9, 0.95),
                        eps=1e-8, wd=0.1),
    "cpu_adagrad": dict(kind="adagrad", lr=1e-2, eps=1e-10, wd=0.1),
    "cpu_lion": dict(kind="lion", lr=1e-4, betas=(0.9, 0.99), wd=0.1),
}


def host_kernels_phase(card):
    """Phase 20 (a): each host kernel against its plain PyTorch version on
    one fp32 leaf of HOST_LEAF, HOST_STEPS steps from the same seeded
    weights and gradients; host ms per step (steady: the first step also
    touches the state's fresh pages), the plain version's and the library
    call's (``torch.optim`` with ``foreach=True`` on CPU tensors; none for
    Lion), the bound (the bytes a step moves over the host's peak memory
    rate: ``host_stream_gb_s``, the fastest probe of a run before the
    kernels and one after; a kernel faster than it fails the phase);
    then an ``AsyncIOHandle`` write and read of HOST_AIO_BYTES, bit-equal,
    MB/s.  Returns the rows and the host's peak rate in GB/s."""
    import os
    import tempfile
    import numpy as np
    import torch
    from deepspeed_tpu_torch.ops import adam as H
    from deepspeed_tpu_torch.ops.aio import AsyncIOHandle
    from concurrent.futures import ThreadPoolExecutor
    from deepspeed_tpu_torch.ops.op_builder import ALL_OPS
    t = time.perf_counter()
    builders = [ALL_OPS[name]() for name in ("cpu_adam", "cpu_adagrad",
                                              "cpu_lion", "async_io")]
    with ThreadPoolExecutor(len(builders)) as pool:    # one g++ each
        list(pool.map(lambda b: b.build(), builders))
    log(f"host ops built in {time.perf_counter() - t:.1f} s")
    n = HOST_LEAF[0] * HOST_LEAF[1]
    probe_before = host_stream_gb_s()
    gen = torch.Generator().manual_seed(SEED + 61)
    p0 = torch.randn(n, generator=gen) * 0.02
    grads = [torch.randn(n, generator=gen) * 1e-3 for _ in range(HOST_STEPS)]
    rows = []
    for name, c in HOST_CASES.items():
        kind = c["kind"]
        if kind == "adam":
            opt = H.DeepSpeedCPUAdam(lr=c["lr"], betas=c["betas"],
                                     eps=c["eps"], weight_decay=c["wd"],
                                     adamw_mode=c["adamw"])
            n_bytes = 7 * 4 * n      # p, g, m, v read; p, m, v written
        elif kind == "adagrad":
            opt = H.DeepSpeedCPUAdagrad(lr=c["lr"], eps=c["eps"],
                                        weight_decay=c["wd"])
            n_bytes = 5 * 4 * n
        else:
            opt = H.DeepSpeedCPULion(lr=c["lr"], betas=c["betas"],
                                     weight_decay=c["wd"])
            n_bytes = 5 * 4 * n
        p = p0.clone()
        ms = []
        for g in grads:
            t = time.perf_counter()
            opt.step(0, p.numpy(), g.numpy())
            ms.append((time.perf_counter() - t) * 1e3)
        q = p0.clone()
        state = {slot: torch.zeros(n) for slot in opt.SLOTS}
        near = torch.zeros(n, dtype=torch.bool)
        plain_ms = []
        for step, g in enumerate(grads, 1):
            if kind == "lion":
                u = _lion_direction(state["exp_avg"], g, c["betas"][0]).abs()
                near |= u <= 1e-6 * u.max()
            t = time.perf_counter()
            if kind == "adam":
                _plain_adam(q, g, state["exp_avg"], state["exp_avg_sq"],
                            step, c["lr"], *c["betas"], c["eps"], c["wd"],
                            c["adamw"])
            elif kind == "adagrad":
                _plain_adagrad(q, g, state["exp_avg_sq"], c["lr"], c["eps"],
                               c["wd"])
            else:
                _plain_lion(q, g, state["exp_avg"], c["lr"], *c["betas"],
                            c["wd"])
            plain_ms.append((time.perf_counter() - t) * 1e3)
        held = ~near
        err = {"p": float((p - q).abs()[held].max() / q.abs().max())}
        for slot in opt.SLOTS:
            ref = state[slot]
            got = torch.from_numpy(opt._state[0][slot])
            err[slot] = float((got - ref).abs().max() / ref.abs().max())
        library_ms = None
        if kind != "lion":
            lp = p0.clone()
            if kind == "adagrad":
                lib = torch.optim.Adagrad([lp], lr=c["lr"], eps=c["eps"],
                                          weight_decay=c["wd"], foreach=True)
            else:
                cls = torch.optim.AdamW if c["adamw"] else torch.optim.Adam
                lib = cls([lp], lr=c["lr"], betas=c["betas"], eps=c["eps"],
                          weight_decay=c["wd"], foreach=True)
            lms = []
            for g in grads:
                lp.grad = g
                t = time.perf_counter()
                lib.step()
                lms.append((time.perf_counter() - t) * 1e3)
            library_ms = statistics.median(lms[1:])
            del lib, lp
        row = dict(
            name=name, route="host C++ (g++ -O3 -march=native)",
            source=f"deepspeed_tpu_torch/csrc/host/"
                   f"{'adam/cpu_adam' if kind == 'adam' else kind + '/cpu_' + kind}.cpp",
            replaces="none (a host kernel; no pl.pallas_call)",
            shape=f"{HOST_LEAF[0]}x{HOST_LEAF[1]} fp32",
            ms=statistics.median(ms[1:]), first_step_ms=ms[0],
            plain_ms=statistics.median(plain_ms[1:]), library_ms=library_ms,
            bytes=n_bytes, bound_by="bytes",
            max_rel_err=err, near_ties=int(near.sum()),
            tol=HOST_OPT_MAX_REL_TOL)
        if not all(e <= HOST_OPT_MAX_REL_TOL for e in err.values()):
            raise RuntimeError(f"host kernel {name} disagrees with its plain "
                               f"version: {row}")
        rows.append(row)
        del opt
    probe_after = host_stream_gb_s()
    probes = {k: max(probe_before[k], probe_after[k]) for k in probe_before}
    host_gb_s = probes["peak"]
    log(f"host: {os.cpu_count()} CPUs, streaming probes (GB/s, best of "
        f"{HOST_PROBE_REPS} before and after the kernels) "
        f"{json.dumps({'before': probe_before, 'after': probe_after})}; "
        f"peak {host_gb_s:.2f} GB/s; {card}")
    for row in rows:
        row["bound_ms"] = row.pop("bytes") / (host_gb_s * 1e9) * 1e3
        log(f"host kernel {row['name']}: {json.dumps(row)}; {card}")
    fast = [r["name"] for r in rows if r["ms"] < r["bound_ms"]]
    if fast:
        raise RuntimeError(f"host kernels {fast} beat the bound of the "
                           f"host's peak rate {host_gb_s:.2f} GB/s: the "
                           f"probe under-reads the host")
    # the async I/O: one 1 GiB buffer out and back
    root = tempfile.mkdtemp(prefix="ds_aio_")
    try:
        data = np.frombuffer(np.random.default_rng(SEED + 62).bytes(
            HOST_AIO_BYTES), np.uint8)
        back = np.empty_like(data)
        h = AsyncIOHandle(num_threads=8, block_size=1 << 20)
        path = os.path.join(root, "aio.bin")
        t = time.perf_counter()
        h.sync_pwrite(data, path)
        write_s = time.perf_counter() - t
        t = time.perf_counter()
        h.sync_pread(back, path)
        read_s = time.perf_counter() - t
        h.close()
        # the plain version: the same bytes through one thread's
        # os.pwrite and os.pread
        plain_path = os.path.join(root, "plain.bin")
        fd = os.open(plain_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
        t = time.perf_counter()
        done = 0
        while done < HOST_AIO_BYTES:
            done += os.pwrite(fd, memoryview(data)[done:], done)
        plain_write_s = time.perf_counter() - t
        os.close(fd)
        fd = os.open(plain_path, os.O_RDONLY)
        t = time.perf_counter()
        chunks, done = [], 0
        while done < HOST_AIO_BYTES:
            chunks.append(os.pread(fd, HOST_AIO_BYTES - done, done))
            done += len(chunks[-1])
        plain_read_s = time.perf_counter() - t
        os.close(fd)
        plain_equal = b"".join(chunks) == data.tobytes()
        del chunks
        # the bound: the bytes once through the host's memory at its peak
        # streaming rate (each direction)
        bound_s = HOST_AIO_BYTES / (host_gb_s * 1e9)
        aio = dict(name="async_io", route="host C++ (g++ -O3 -march=native)",
                   source="deepspeed_tpu_torch/csrc/host/aio/ds_aio.cpp",
                   bytes=HOST_AIO_BYTES, bit_equal=bool(np.array_equal(
                       data, back)),
                   write_ms=write_s * 1e3, read_ms=read_s * 1e3,
                   write_mb_s=HOST_AIO_BYTES / write_s / 1e6,
                   read_mb_s=HOST_AIO_BYTES / read_s / 1e6,
                   bound_ms=bound_s * 1e3, bound_by="bytes",
                   plain_write_ms=plain_write_s * 1e3,
                   plain_read_ms=plain_read_s * 1e3,
                   plain_bit_equal=plain_equal,
                   note="page-cache writes and a warm read (no drop_caches); "
                   "bound: the bytes over the host's peak streaming rate; "
                   "plain: one thread's os.pwrite / os.pread")
    finally:
        import shutil
        shutil.rmtree(root, ignore_errors=True)
    log(f"host kernel async_io: {json.dumps(aio)}; {card}")
    if not (aio["bit_equal"] and aio["plain_bit_equal"]):
        raise RuntimeError("the async I/O or its plain version read back "
                           "other bytes")
    rows.append(aio)
    log("host kernels:", json.dumps({"host_kernels": rows,
                                     "cpu_count": os.cpu_count(),
                                     "host_probe_gb_s": probes,
                                     "card": card}))
    return rows, host_gb_s


def _rss_gb() -> float:
    """This process's resident set now, from /proc/self/status."""
    with open("/proc/self/status") as f:
        for ln in f:
            if ln.startswith("VmRSS:"):
                return int(ln.split()[1]) * 1024 / 1e9
    return 0.0


def _host_state_bytes(engine) -> int:
    """The offload engine's host state: masters, moments (in RAM) and
    the staging buffer."""
    off = engine.offload
    n = sum(m.nbytes for m in off.masters)
    n += sum(buf.nbytes for st in off.host_opt._state.values()
             for buf in st.values())
    if engine._staging is not None:
        n += engine._staging.numel() * 4
    return n


def _masters_on_card(engine, public=True):
    """The fp32 masters in tree order, flat, on the card: from
    ``get_fp32_state_dict()`` (host copies; an offloaded leaf's from its
    host master), or with ``public`` False clones of a device run's."""
    import torch
    from deepspeed_tpu_torch.tree import tree_leaves
    if not public:
        return [p.detach().float().reshape(-1).clone()
                for p in tree_leaves(engine.params)]
    return [torch.from_numpy(x).reshape(-1).to("cuda")
            for x in tree_leaves(engine.get_fp32_state_dict())]


def _master_gaps(run, ref, init) -> dict:
    """Largest over the leaves of the update gap rms(run - ref) /
    rms(ref - init) and of the decay gap |<ref - run, ref>| / <ref, ref>."""
    import torch
    upd = dec = 0.0
    for a, b, c in zip(run, ref, init):
        d = (b - a).double()
        bb = b.double()
        u = float(torch.linalg.vector_norm(b - c, dtype=torch.float64))
        upd = max(upd, float(torch.linalg.vector_norm(d)) / max(u, 1e-30))
        dec = max(dec, abs(float((d * bb).sum())) / float((bb * bb).sum()))
        del d, bb
    return {"update_gap": upd, "decay_gap": dec}


def _train_run(label, layers, config, batch, counters, steps=TRAIN_STEPS,
               ref=None):
    """``steps`` train_batch calls of Llama-2-7B width at ``layers`` layers
    (seeded weights, one fixed batch); launch counts from zero, the step
    split of each offloaded step, the peaks.  Without ``ref`` (a device
    run) its initial and final masters are kept on the card; with it
    (ref's masters), the run's final masters from get_fp32_state_dict()
    are held against them.  Returns (summary, launches, masters or
    None)."""
    import torch
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    from deepspeed_tpu_torch.tree import tree_leaves
    from deepspeed_tpu_torch.utils.memory import host_peak_rss_bytes
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    engine, *_ = dtt.initialize(model=LlamaForCausalLM("7b", num_layers=layers),
                                config=config)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    device_state = torch.cuda.memory_allocated()
    init = _masters_on_card(engine, public=False) if ref is None else None
    reset_launches(counters)
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for _ in range(steps):
        t = time.perf_counter()
        loss = engine.train_batch(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        row = dict(ms=ms, loss=loss, lr=engine._last_lr)
        if engine.offload is not None:
            split = {k: v * 1e3 for k, v in engine.offload_times.items()}
            row.update({f"{k}_ms": v for k, v in split.items()})
            row["fwd_bwd_ms"] = ms - sum(v for k, v in split.items()
                                         if k != "device_wait")
        rows.append(row)
    launches = read_launches(counters)
    leaves = tree_leaves(engine.params)
    n_device = (len(engine._device_index) if engine.optimizer is not None
                else 0)
    summary = dict(
        label=label, layers=layers, steps=rows, build_s=build_s,
        params=sum(p.numel() for p in leaves), leaves=len(leaves),
        device_leaves=n_device,
        offloaded_leaves=len(leaves) - n_device,
        device_state_gb=device_state / 1e9,
        device_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        host_state_gb=(_host_state_bytes(engine) / 1e9
                       if engine.offload is not None else 0.0),
        host_rss_gb=_rss_gb(), host_peak_rss_gb=host_peak_rss_bytes() / 1e9,
        launches=launches)
    masters = None
    if ref is None:
        masters = {"init": init, "final": _masters_on_card(engine, False)}
    if engine.offload is not None:
        summary["offload_paths"] = engine.offload.offload_paths
    if engine.offload is not None and engine.offload.swapper is not None:
        engine.offload.swapper.close()
    if ref is not None:
        t = time.perf_counter()
        run = _masters_on_card(engine)
        del engine
        summary.update(_master_gaps(run, ref["final"], ref["init"]))
        summary["masters_compare_s"] = time.perf_counter() - t
        del run
    else:
        del engine
    gc.collect()
    torch.cuda.empty_cache()
    return summary, launches, masters


def _path_checks(s, ref, L, micro_batches, steps):
    """Launch counts, losses and masters of an offload run against its
    device reference: AdamW once per device leaf per step, the flash
    kernels as phase 10's, losses and masters within the offload limits,
    losses falling."""
    la = s["launches"]
    losses = [r["loss"] for r in s["steps"]]
    ref_losses = [r["loss"] for r in ref["steps"]]
    s["loss_gap"] = max(abs(a - b) for a, b in zip(losses, ref_losses))
    return {
        "finite": all(math.isfinite(x) for x in losses),
        "loss falls": losses[-1] < losses[0],
        "losses near the device run's": all(
            abs(a - b) <= min(OFFLOAD_LOSS_MAX, OFFLOAD_LOSS_ATOL
                              + OFFLOAD_LOSS_RTOL * abs(b))
            for a, b in zip(losses, ref_losses)),
        "masters' update gap": s["update_gap"] <= OFFLOAD_UPDATE_GAP,
        "masters' decay gap": s["decay_gap"] <= OFFLOAD_DECAY_GAP,
        "fused_adamw once per device leaf per step":
            la["fused_adamw"] == s["device_leaves"] * steps,
        "flash_fwd": la["flash_fwd"] >= 2 * L * micro_batches,
        "flash_bwd": la["flash_bwd_dkv"] == L * micro_batches
        and la["flash_bwd_dq"] == L * micro_batches,
        "other training kernels idle": all(la[k] == 0 for k in (
            "fused_lion", "fused_lamb", "quantize", "dequantize")),
    }


def offload_phase(counters, card):
    """Phase 20 (b): phase 10's configuration (Llama-2-7B width at
    OFFLOAD_LAYERS layers, micro 2 x 2048, gas 2, AdamW, clipping 1.0) on
    the device, then with ``offload_optimizer`` cpu at each ratio of
    OFFLOAD_RATIOS; at OFFLOAD_NVME_LAYERS layers on the device, with
    nvme, and with each planted fault of OFFLOAD_FAULTS (cpu, ratio 1.0),
    which must fail the checks the sound runs pass.  Returns (launches by
    path, summary)."""
    import shutil
    import tempfile
    import numpy as np
    rng = np.random.default_rng(SEED + 2)          # phase 10's batch
    batch = {"input_ids": rng.integers(
        0, 32000, (TRAIN_GAS * TRAIN_MICRO, TRAIN_SEQ)).astype(np.int32)}
    mbs = TRAIN_STEPS * TRAIN_GAS
    runs, checks, launches_by_path = {}, {}, {}
    ref, launches_by_path["training_offload_ref"], ref_m = _train_run(
        "device", OFFLOAD_LAYERS, TRAIN_CONFIG, batch, counters)
    runs["device"] = ref
    for ratio in OFFLOAD_RATIOS:
        path = f"training_offload_cpu_{ratio:g}"
        s, launches_by_path[path], _ = _train_run(
            path, OFFLOAD_LAYERS, _offload_config(ratio), batch, counters,
            ref=ref_m)
        runs[path] = s
        checks[path] = _path_checks(s, ref, OFFLOAD_LAYERS, mbs,
                                    TRAIN_STEPS)
        checks[path]["no device optimizer at ratio 1"] = (
            ratio < 1.0 or s["device_leaves"] == 0)
    del ref_m
    nvme_root = tempfile.mkdtemp(prefix="ds_nvme_")
    faults = {}
    try:
        ref2, launches_by_path["training_offload_ref_nvme"], ref_m = \
            _train_run("device", OFFLOAD_NVME_LAYERS, TRAIN_CONFIG, batch,
                       counters)
        runs["device_nvme_layers"] = ref2
        path = "training_offload_nvme"
        s, launches_by_path[path], _ = _train_run(
            path, OFFLOAD_NVME_LAYERS,
            _offload_config(1.0, "nvme", nvme_root), batch, counters,
            ref=ref_m)
        runs[path] = s
        checks[path] = _path_checks(s, ref2, OFFLOAD_NVME_LAYERS, mbs,
                                    TRAIN_STEPS)
        for name, fault in OFFLOAD_FAULTS.items():
            s, _, _ = _train_run(
                name, OFFLOAD_NVME_LAYERS,
                _offload_config(1.0, fault=fault), batch, counters,
                ref=ref_m)
            runs[name] = s
            faults[name] = _path_checks(s, ref2, OFFLOAD_NVME_LAYERS, mbs,
                                        TRAIN_STEPS)
        del ref_m
    finally:
        shutil.rmtree(nvme_root, ignore_errors=True)
    readings = {label: {k: s[k] for k in ("loss_gap", "update_gap",
                                          "decay_gap")}
                for label, s in runs.items() if "loss_gap" in s}
    summary = dict(card=card, runs=runs, checks=checks, faults=faults,
                   readings=readings,
                   limits=dict(loss_max=OFFLOAD_LOSS_MAX,
                               loss_rtol=OFFLOAD_LOSS_RTOL,
                               loss_atol=OFFLOAD_LOSS_ATOL,
                               update_gap=OFFLOAD_UPDATE_GAP,
                               decay_gap=OFFLOAD_DECAY_GAP))
    log("offload:", json.dumps(summary))
    log(f"offload readings (loss gap, masters' update gap, decay gap) "
        f"against limits {OFFLOAD_LOSS_MAX:g}, {OFFLOAD_UPDATE_GAP:g}, "
        f"{OFFLOAD_DECAY_GAP:g}: {json.dumps(readings)}; {card}")
    for label, s in runs.items():
        st = s["steps"][-1]
        log(f"offload {label}: {s['layers']} layers, {s['params'] / 1e9:.3f} "
            f"B params, {s['offloaded_leaves']}/{s['leaves']} leaves "
            f"offloaded; last step {st['ms']:.1f} ms"
            + ("".join(f", {k[:-3]} {st[k]:.1f}" for k in (
                "fwd_bwd_ms", "device_wait_ms", "d2h_ms", "host_step_ms",
                "h2d_ms", "nvme_wait_ms") if k in st))
            + f"; device state {s['device_state_gb']:.2f} GB, peak "
            f"{s['device_peak_gb']:.2f} GB; host state "
            f"{s['host_state_gb']:.2f} GB, RSS {s['host_rss_gb']:.2f} GB; "
            f"losses {[round(r['loss'], 5) for r in s['steps']]}; {card}")
    bad = {p: {k: v for k, v in c.items() if not v}
           for p, c in checks.items() if not all(c.values())}
    missed = [name for name, c in faults.items() if all(c.values())]
    if bad or missed:
        raise RuntimeError(f"phase 20 (b) checks failed: {bad}; planted "
                           f"faults the checks passed: {missed}")
    return launches_by_path, summary


# (c) each remat policy reached through the config sections a user sets
# (JAX engine.py:300-345's mapping), two of them by cpu_checkpointing;
# an offload_* policy's bytes moved to the host are the device bytes its
# saving counterpart keeps after the forward less its own
# the remat policies at 4 of 32 layers (8 before phase 21 needed the room)
REMAT_LAYERS = 4
REMAT_CONFIGS = {
    "nothing_saveable": {"activation_checkpointing": {"policy": "full"}},
    "dots_saveable": {"activation_checkpointing": {"policy": "dots"}},
    "dots_with_no_batch_dims_saveable": {"tpu": {
        "remat": True, "remat_policy": "dots_with_no_batch_dims_saveable"}},
    "everything_saveable": {"activation_checkpointing": {"policy": "nothing"}},
    "save_attn_out": {"tpu": {"remat_policy": "save_attn_out"}},
    "offload_attn_out": {"tpu": {"remat_policy": "save_attn_out"},
                         "activation_checkpointing": {
                             "cpu_checkpointing": True}},
    "offload_dots": {"activation_checkpointing": {
        "policy": "dots_with_no_batch_dims", "cpu_checkpointing": True}},
}
REMAT_COUNTERPART = {"offload_attn_out": "save_attn_out",
                     "offload_dots": "dots_with_no_batch_dims_saveable"}


def remat_phase(counters, card):
    """Phase 20 (c): every remat policy at phase 10's configuration, each
    in an engine of its own built by ``initialize`` from its config
    section (REMAT_CONFIGS).  One micro-batch through ``engine.forward``
    and ``engine.backward``: loss and accumulated gradients against
    ``nothing_saveable``'s (bit-equal, else the largest difference), the
    bytes the forward leaves saved on the card, flash forward launches (a
    policy that saves the attention output skips its recomputation); the
    step's second micro-batch and ``step()``, then one timed train_batch:
    step ms and peak.  The ``offload_*`` policies must leave fewer bytes
    on the card than the policies whose values they offload."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    rng = np.random.default_rng(SEED + 2)          # phase 10's batch
    batch = {"input_ids": rng.integers(
        0, 32000, (TRAIN_GAS * TRAIN_MICRO, TRAIN_SEQ)).astype(np.int32)}
    micro = [{"input_ids": batch["input_ids"][i:i + TRAIN_MICRO]}
             for i in range(0, TRAIN_GAS * TRAIN_MICRO, TRAIN_MICRO)]
    L = REMAT_LAYERS
    order = ["nothing_saveable"] + [p for p in T.REMAT_POLICY_NAMES
                                    if p != "nothing_saveable"]
    def pinned():       # bytes of pinned host blocks handed out now
        return torch.cuda.host_memory_stats()["active_bytes.current"]

    rows, ref = {}, None
    for pol in order:
        gc.collect()
        torch.cuda.empty_cache()
        engine, *_ = dtt.initialize(
            model=LlamaForCausalLM("7b", num_layers=L),
            config=dict(TRAIN_CONFIG, **REMAT_CONFIGS[pol]))
        if engine.module.cfg.remat_policy != pol:
            raise RuntimeError(f"config {REMAT_CONFIGS[pol]} gave policy "
                               f"{engine.module.cfg.remat_policy}, not {pol}")
        engine._compute_params()      # the step's compute copy, made first
        torch.cuda.synchronize()
        reset_launches(counters)
        mem0, pin0 = torch.cuda.memory_allocated(), pinned()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        loss = engine.forward(micro[0])
        torch.cuda.synchronize()
        saved = torch.cuda.memory_allocated() - mem0
        pinned_saved = pinned() - pin0
        engine.backward(loss)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        la = read_launches(counters)
        row = dict(config=REMAT_CONFIGS[pol], loss=loss.item(),
                   fwd_saved_gb=saved / 1e9,
                   fwd_pinned_gb=pinned_saved / 1e9,
                   fwd_bwd_peak_gb=(torch.cuda.max_memory_allocated()
                                    - mem0) / 1e9,
                   micro_batch_ms=ms, flash_fwd=la["flash_fwd"],
                   flash_bwd_dkv=la["flash_bwd_dkv"])
        grads = engine._grads                # fp32 sums of the micro-batch
        if ref is None:
            ref = (loss.item(), [g.clone() for g in grads])
        else:
            row["loss_equal"] = loss.item() == ref[0]
            row["grads_bit_equal"] = all(torch.equal(a, b)
                                         for a, b in zip(grads, ref[1]))
            row["grad_max_abs_diff"] = max(
                float((a - b).abs().max()) for a, b in zip(grads, ref[1]))
        del loss, grads
        # the rest of the first step, untimed (it also grows the pool)
        for mb in micro[1:]:
            engine.backward(engine.forward(mb))
        engine.step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        loss = engine.train_batch(batch)
        torch.cuda.synchronize()
        row.update(step_ms=(time.perf_counter() - t) * 1e3, step_loss=loss,
                   step_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        rows[pol] = row
        del engine
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    for pol, other in REMAT_COUNTERPART.items():
        rows[pol]["offloaded_gb"] = (rows[other]["fwd_saved_gb"]
                                     - rows[pol]["fwd_saved_gb"])
    saves_attn = ("save_attn_out", "offload_attn_out", "everything_saveable")
    checks = {
        "loss and gradients bit-equal to nothing_saveable": all(
            r.get("loss_equal", True) and r.get("grads_bit_equal", True)
            for r in rows.values()),
        "flash forward recomputed unless the attention output is saved":
            all(r["flash_fwd"] == (L if pol in saves_attn else 2 * L)
                for pol, r in rows.items()),
        "flash backward once a layer": all(r["flash_bwd_dkv"] == L
                                           for r in rows.values()),
    }
    for pol, other in REMAT_COUNTERPART.items():
        checks[f"{pol} leaves less on the card than {other}"] = (
            rows[pol]["offloaded_gb"] > 0)
    checks["pinned host memory holds the offload policies' saves only"] = all(
        (r["fwd_pinned_gb"] > 0) == (pol in REMAT_COUNTERPART)
        for pol, r in rows.items())
    checks["finite"] = all(math.isfinite(r["step_loss"])
                           for r in rows.values())
    summary = dict(card=card, layers=L, micro_batch=TRAIN_MICRO,
                   seq=TRAIN_SEQ, policies=rows, checks=checks)
    log("remat:", json.dumps(summary))
    for pol, r in rows.items():
        moved = (f", moved to the host {r['offloaded_gb']:.3f} GB (pinned "
                 f"{r['fwd_pinned_gb']:.3f} GB, blocks rounded to powers "
                 f"of two)" if "offloaded_gb" in r else "")
        log(f"remat {pol} ({json.dumps(r['config'])}): saved after the "
            f"forward {r['fwd_saved_gb']:.3f} GB, fwd+bwd peak "
            f"{r['fwd_bwd_peak_gb']:.3f} GB above the state{moved}, "
            f"micro-batch {r['micro_batch_ms']:.1f} ms, flash fwd "
            f"{r['flash_fwd']}; train_batch {r['step_ms']:.1f} ms, peak "
            f"{r['step_peak_gb']:.2f} GB; {card}")
    if not all(checks.values()):
        raise RuntimeError(f"phase 20 (c) checks failed: "
                           f"{[k for k, v in checks.items() if not v]}")
    return {}, summary


FULL_DEPTH_CHILD = r"""
import json, sys, time
import numpy as np
import torch
cache_dir, config = sys.argv[1], json.loads(sys.argv[2])
steps, seed = int(sys.argv[3]), int(sys.argv[4])
from deepspeed_tpu_torch.ops import kernel_loader
kernel_loader.set_library_dir(cache_dir)
import chip_smoke as S
import deepspeed_tpu_torch as dtt
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.tree import tree_leaves
from deepspeed_tpu_torch.utils.memory import host_peak_rss_bytes
t0 = time.perf_counter()
model = LlamaForCausalLM("7b")
engine, *_ = dtt.initialize(model=model, config=config)
torch.cuda.synchronize()
build_s = time.perf_counter() - t0
probe = S.host_stream_gb_s()        # this process, just before its steps
n_params = sum(p.numel() for p in tree_leaves(engine.params))
device_state = torch.cuda.memory_allocated()
rng = np.random.default_rng(seed)
micro = config["train_micro_batch_size_per_gpu"]
batch = {"input_ids": rng.integers(0, model.cfg.vocab_size,
                                   (micro, 2048)).astype(np.int32)}
counters = S.kernel_counters()
S.reset_launches(counters)
torch.cuda.reset_peak_memory_stats()
rows = []
for _ in range(steps):
    t = time.perf_counter()
    loss = engine.train_batch(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    split = {k + "_ms": v * 1e3 for k, v in engine.offload_times.items()}
    rows.append(dict(ms=ms, loss=loss, lr=engine._last_lr, **split,
                     fwd_bwd_ms=ms - sum(v for k, v in split.items()
                                         if k != "device_wait_ms")))
print(json.dumps(dict(
    build_s=build_s, params=n_params, layers=model.cfg.num_layers,
    leaves=len(engine.masters), device_leaves=len(engine._device_index),
    offload_paths=engine.offload.offload_paths, steps=rows,
    offloaded_params=sum(int(m.size) for m in engine.offload.masters),
    host_probe_gb_s=probe,
    device_state_gb=device_state / 1e9,
    device_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
    host_peak_rss_gb=host_peak_rss_bytes() / 1e9,
    launches=S.read_launches(counters))))
"""


def _host_available_bytes() -> Tuple[int, str]:
    """Memory a child can take: MemAvailable, capped by the cgroup's
    limit less its usage where one is set; and ``free -g``'s line."""
    avail = 0
    with open("/proc/meminfo") as f:
        for ln in f:
            if ln.startswith("MemAvailable:"):
                avail = int(ln.split()[1]) * 1024
    try:
        with open("/sys/fs/cgroup/memory.max") as f:
            limit = f.read().strip()
        with open("/sys/fs/cgroup/memory.current") as f:
            used = int(f.read().strip())
        if limit != "max":
            avail = min(avail, int(limit) - used)
    except OSError:
        pass
    free = subprocess.run(["free", "-g"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    return avail, free


def full_depth_phase(counters, card, cache_dir, host_gb_s):
    """Phase 20 (d): Llama-2-7B at full width and depth (32 layers, 6.74 B
    parameters, ZeRO-3, bf16 over fp32 masters, micro 1 x 2048, gas 1,
    AdamW with ``offload_optimizer`` cpu) for FULL_DEPTH_STEPS
    train_batch calls on one seeded batch, in a child process whose host
    memory is its own; every kernel's launches counted there.  The host
    step against its bound: the bytes the host Adam moves (p, g, m, v
    read, p, m, v written: 28 a parameter) over the host's peak rate,
    the faster of ``host_gb_s`` (from (a)) and the child's own probe.
    Returns (launches by path, summary)."""
    import os
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    empty_host_cache = getattr(torch._C, "_host_emptyCache", None)
    if empty_host_cache is not None:
        empty_host_cache()     # earlier phases' pinned blocks
    avail, free = _host_available_bytes()
    ratio = 1.0 if avail >= FULL_DEPTH_HOST_GB * 1e9 else 0.9
    log(f"full depth: {avail / 1e9:.1f} GB available to the child, this "
        f"process's RSS {_rss_gb():.1f} GB (free -g:\n{free}\n) -> offload "
        f"ratio {ratio:g}; {card}")
    config = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=1,
                  gradient_accumulation_steps=1,
                  zero_optimization={"stage": 3, "offload_optimizer": {
                      "device": "cpu", "ratio": ratio}})
    t = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", FULL_DEPTH_CHILD, cache_dir,
         json.dumps(config), str(FULL_DEPTH_STEPS), str(SEED + 71)],
        capture_output=True, text=True, timeout=900,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    wall_s = time.perf_counter() - t
    if out.returncode != 0:
        raise RuntimeError(f"full-depth child failed (rc {out.returncode}):"
                           f"\n{out.stderr[-4000:]}")
    child = json.loads(out.stdout.strip().splitlines()[-1])
    steps = child["steps"]
    losses = [st["loss"] for st in steps]
    L = child["layers"]
    la = child["launches"]
    missing = sorted(set(counters) - set(la))
    if missing:
        raise RuntimeError(f"the full-depth child counted no launches of "
                           f"{missing}")
    steady = [st["ms"] for st in steps[1:]]
    summary = dict(card=card, ratio=ratio, host_available_gb=avail / 1e9,
                   child_wall_s=wall_s,
                   tokens_per_s=2048 / (statistics.mean(steady) / 1e3),
                   **child)
    checks = {
        "32 layers, 6.74 B params": L == 32 and abs(
            child["params"] / 1e9 - 6.74) < 0.01,
        "losses finite": all(math.isfinite(x) for x in losses),
        "loss falls": losses[-1] < losses[0],
        f"device peak under {FULL_DEPTH_PEAK_GB:g} GB":
            child["device_peak_gb"] < FULL_DEPTH_PEAK_GB,
        "flash kernels": la["flash_fwd"] >= 2 * L * FULL_DEPTH_STEPS
        and la["flash_bwd_dkv"] == L * FULL_DEPTH_STEPS
        and la["flash_bwd_dq"] == L * FULL_DEPTH_STEPS,
        "fused_adamw once per device leaf per step":
            la["fused_adamw"] == child["device_leaves"] * FULL_DEPTH_STEPS,
        "no other kernel": all(n == 0 for k, n in la.items() if k not in (
            "flash_fwd", "flash_bwd", "flash_bwd_dkv", "flash_bwd_dq",
            "fused_adamw")),
    }
    summary["checks"] = checks
    host_gb_s = max(host_gb_s, child["host_probe_gb_s"]["peak"])
    summary["host_step_bound_ms"] = (28 * child["offloaded_params"]
                                     / (host_gb_s * 1e9) * 1e3)
    summary["host_gb_s"] = host_gb_s
    log("full depth:", json.dumps(summary))
    for i, st in enumerate(steps):
        log(f"full depth step {i}: {st['ms']:.0f} ms (fwd+bwd "
            f"{st['fwd_bwd_ms']:.0f}, d2h {st['d2h_ms']:.0f}, host step "
            f"{st['host_step_ms']:.0f} against its bound "
            f"{summary['host_step_bound_ms']:.0f} at {host_gb_s:.1f} GB/s, "
            f"h2d {st['h2d_ms']:.0f}), loss {st['loss']:.5f}; {card}")
    log(f"full depth: {child['params'] / 1e9:.3f} B params, ratio {ratio:g} "
        f"({child['leaves'] - child['device_leaves']}/{child['leaves']} "
        f"leaves offloaded), device peak {child['device_peak_gb']:.2f} GB, "
        f"host peak RSS {child['host_peak_rss_gb']:.2f} GB, "
        f"{summary['tokens_per_s']:.1f} tokens/s; {card}")
    if not all(checks.values()):
        raise RuntimeError(f"phase 20 (d) checks failed: "
                           f"{[k for k, v in checks.items() if not v]}")
    return {"training_full_depth_offload": {
        name: la[name] for name in counters}}, summary


# ---------------------------------------------------------------------------
# phase 21: the rest of one-GPU training
# ---------------------------------------------------------------------------

# Llama-2-7B width at 2 of 32 layers (0.667 B parameters: every phase-21
# engine and its fp32 state, ~15 GB, fits beside the next one's build),
# micro 2 x 2048, gas 2, through deepspeed_tpu_torch.initialize
P21_LAYERS = 2
# the device phase 21 builds its engines on (the functions also run on
# "cpu" at a debug size, where nothing is timed)
P21_DEVICE = "cuda"
# (a): 2 ** 125 makes the fp32 scaled loss inf at a loss of ~10.4, so the
# first steps overflow and the scale walks down by JAX's rule (hysteresis
# 2: every second overflow halves it) until the gradients are finite too;
# 16 train_batch calls, or more (up to 24) until 6 steps have applied
P21_FP16 = {"enabled": True, "initial_scale_power": 125, "hysteresis": 2,
            "loss_scale_window": 4}
P21_FP16_STEPS = 16
P21_FP16_MAX_STEPS = 24
P21_FP16_APPLIED = 6
P21_STATIC_SCALE = 1024.0
P21_STATIC_LOSS_REL = 1e-3
# (c): hysteresis 1, so every overflow halves the scale; 6 calls, or more
# (up to 12) until 3 steps have applied
P21_OFFLOAD_FP16 = {"enabled": True, "initial_scale_power": 125,
                    "hysteresis": 1, "loss_scale_window": 1000}
P21_OFFLOAD_STEPS = 6
P21_OFFLOAD_MAX_STEPS = 12
P21_OFFLOAD_APPLIED = 3
P21_STEPS = 3
# (d): the three non-default mixes of the two bf16 flags
P21_BF16_FLAGS = ((False, True), (True, False), (False, False))
P21_BF16_OPTIMIZERS = {
    "adamw": TRAIN_CONFIG["optimizer"],
    "lion": TRAIN_PATHS["training_lion_qwz"]["optimizer"],
    "lamb": TRAIN_PATHS["training_lamb"]["optimizer"]}
# (e): the factory's other names; the lr each needs to move the loss of a
# fixed batch in 3 steps under clipping at 1.0 (SGD and Adagrad step by
# about lr times the clipped gradient, not by about lr as Adam does)
P21_OTHER = {
    "sgd": {"lr": 1.0, "momentum": 0.9},
    "adagrad": {"lr": 0.1},
    "adam": {"lr": 3e-4, "adam_w_mode": False, "weight_decay": 0.1},
    "onebitadam": {"lr": 3e-4},
    "onebitlamb": {"lr": 1e-2},
    "zerooneadam": {"lr": 3e-4, "weight_decay": 0.1}}
# the JAX engine refuses these at build (ROADMAP Queue 3): the optimizer
# runs outside the engine only
P21_REFUSED = ("adafactor", "muon")
# one update of real leaves on the card against the same update on the
# CPU, from the same state: max |p card - p cpu| / max |p cpu| (fp32
# both, the reductions in another order: an update may round each weight
# the other way, 1.2e-7 of a weight near 1).  Three updates of the 1-bit
# family at freeze_step 2 (the third compressed): the compression's sign
# takes an element whose x sits at a reduction's rounding either way, so
# those runs hold the share of weights that part by more than
# P21_UPDATE_REL_TOL to P21_FLIP_SHARE_MAX
P21_UPDATE_REL_TOL = 1e-5
P21_FLIP_SHARE_MAX = 1e-3
P21_UPDATE_LEAVES = ("final_norm/scale", "layers/norm1/scale",
                     "layers/attn/wq")
P21_PARTIAL_ATOL = 1e-6
P21_LTD_KEEP = 1024


def _p21_config(**over):
    cfg = dict(TRAIN_CONFIG)
    cfg.update(over)
    return cfg


def _p21_batches(vocab, n, rows=TRAIN_GAS * TRAIN_MICRO, seed=SEED + 71):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, (rows, TRAIN_SEQ)).astype(
        np.int32)} for _ in range(n)]


def _p21_engine(params, config):
    import torch
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    gc.collect()
    torch.cuda.empty_cache()
    engine, *_ = dtt.initialize(
        model=LlamaForCausalLM("7b", num_layers=P21_LAYERS), config=config,
        model_parameters=params, device=P21_DEVICE)
    return engine


def _p21_state(engine):
    """A device copy of masters, moments and counts."""
    opt = engine.optimizer
    return ([p.detach().clone() for p in engine.masters],
            [{k: (v.clone() if hasattr(v, "clone") else v)
              for k, v in opt.state[p].items()} if opt.state.get(p) else {}
             for p in engine.masters])


def _p21_same_state(a, b) -> bool:
    import torch
    (pa, sa), (pb, sb) = a, b
    return (all(torch.equal(x, y) for x, y in zip(pa, pb))
            and all(x.keys() == y.keys() and all(
                torch.equal(x[k], y[k]) if hasattr(x[k], "dtype")
                else x[k] == y[k] for k in x) for x, y in zip(sa, sb)))


def _scale_rule(flags, fp16):
    """JAX's dynamic loss-scale rule recomputed on the host from the
    overflow flags (True: the step overflowed): the scale after each
    step (fp32) and the hysteresis."""
    import numpy as np
    scale = np.float32(2.0 ** fp16["initial_scale_power"])
    hyst, good, out = fp16["hysteresis"], 0, []
    for overflow in flags:
        good = 0 if overflow else good + 1
        if overflow and hyst <= 1:
            scale = np.maximum(scale / np.float32(2), np.float32(1.0))
            hyst = fp16["hysteresis"]
        elif overflow:
            hyst -= 1
        if not overflow and good % fp16["loss_scale_window"] == 0:
            scale = scale * np.float32(2)
            hyst = fp16["hysteresis"]
        out.append((float(scale), hyst))
    return out


def _p21_fp16_dynamic(params, batches, counters, card):
    """(a) fp16 with the dynamic scale, telemetry and self-healing on."""
    import torch
    from deepspeed_tpu_torch.telemetry import metrics as tm
    from deepspeed_tpu_torch.tree import tree_leaves
    config = _p21_config(fp16=P21_FP16, bf16={"enabled": False},
                         telemetry={"enabled": True},
                         fault_tolerance={"self_healing": True})
    engine = _p21_engine(params, config)
    n_leaves = len(tree_leaves(engine.params))
    skips0, nonfinite0 = tm.TRAIN_OVERFLOW_SKIP.value, \
        tm.TRAIN_NONFINITE.value
    rollbacks0 = tm.TRAIN_ROLLBACK.value
    reset_launches(counters)
    rows, frozen = [], []
    i = 0
    while i < P21_FP16_STEPS or (
            sum(r["applied"] for r in rows) < P21_FP16_APPLIED
            and i < P21_FP16_MAX_STEPS):
        before = _p21_state(engine)
        loss = engine.train_batch(batches[0])
        applied = engine.was_step_applied()
        if not applied:
            frozen.append(_p21_same_state(before, _p21_state(engine)))
        del before
        rows.append(dict(loss=loss, scale=engine.loss_scale,
                         hysteresis=engine._hysteresis, applied=applied,
                         skipped=engine.skipped_steps))
        log(f"phase 21 (a) step {i}: loss {loss:.5f}, scale "
            f"{engine.loss_scale:.6g}, hysteresis {engine._hysteresis}, "
            f"applied {applied}, skipped {engine.skipped_steps}")
        i += 1
    torch.cuda.synchronize()
    launches = read_launches(counters)
    rule = _scale_rule([not r["applied"] for r in rows], P21_FP16)
    applied = [r for r in rows if r["applied"]]
    skips = sum(not r["applied"] for r in rows)
    checks = {
        "scale follows the rule": [(r["scale"], r["hysteresis"])
                                   for r in rows] == rule,
        "first steps overflow": not rows[0]["applied"],
        "steps apply once the scale settles":
            len(applied) >= P21_FP16_APPLIED,
        "skips freeze masters, moments and counts": all(frozen),
        "fused_adamw: leaves x applied steps":
            launches["fused_adamw"] == n_leaves * len(applied),
        "bf16 instances idle": launches["fused_adamw_bf16"] == 0,
        "ds_train_overflow_skip_total = skips":
            tm.TRAIN_OVERFLOW_SKIP.value - skips0 == skips,
        "no non-finite verdict": tm.TRAIN_NONFINITE.value == nonfinite0,
        "no rollback": tm.TRAIN_ROLLBACK.value == rollbacks0,
        "loss falls once settled": len(applied) > 1
        and applied[-1]["loss"] < applied[0]["loss"],
        "flash launched": launches["flash_fwd"] > 0
        and launches["flash_bwd"] > 0}
    summary = dict(card=card, fp16=P21_FP16, steps=rows, skips=skips,
                   launches=launches, checks=checks)
    del engine
    return summary, launches


def _p21_fp16_static(params, batches, counters, card):
    """(b) fp16 at a static scale against the same run in bf16."""
    out, launches = {}, {}
    for label, over in (("fp16_static", dict(
            fp16={"enabled": True, "loss_scale": P21_STATIC_SCALE},
            bf16={"enabled": False})), ("bf16", {})):
        engine = _p21_engine(params, _p21_config(**over))
        reset_launches(counters)
        losses = [engine.train_batch(b) for b in batches[:P21_STEPS]]
        out[label] = dict(losses=losses, skipped=engine.skipped_steps,
                          scale=engine.loss_scale)
        launches[label] = read_launches(counters)
        del engine
    a, b = out["fp16_static"]["losses"], out["bf16"]["losses"]
    checks = {
        "no skips": out["fp16_static"]["skipped"] == 0,
        "scale static": out["fp16_static"]["scale"] == P21_STATIC_SCALE,
        "losses near bf16's": all(abs(x - y) <= P21_STATIC_LOSS_REL * abs(y)
                                  for x, y in zip(a, b))}
    return dict(card=card, runs=out, checks=checks), launches["fp16_static"]


def _p21_fp16_offload(params, batches, counters, card):
    """(c) fp16 with half the elements offloaded: an overflow skips the
    host step too."""
    import numpy as np
    config = _p21_config(
        fp16=P21_OFFLOAD_FP16, bf16={"enabled": False},
        zero_optimization={"stage": 1, "offload_optimizer": {
            "device": "cpu", "ratio": 0.5}})
    engine = _p21_engine(params, config)
    reset_launches(counters)
    rows, frozen = [], []
    while len(rows) < P21_OFFLOAD_STEPS or (
            sum(r["applied"] for r in rows) < P21_OFFLOAD_APPLIED
            and len(rows) < P21_OFFLOAD_MAX_STEPS):
        host = [m.copy() for m in engine.offload.masters]
        loss = engine.train_batch(batches[0])
        applied = engine.was_step_applied()
        if not applied:
            frozen.append(all(np.array_equal(a, b) for a, b in
                              zip(host, engine.offload.masters)))
        del host
        rows.append(dict(loss=loss, scale=engine.loss_scale,
                         applied=applied,
                         host_step_ms=engine.offload_times.get(
                             "host_step", 0.0) * 1e3 if applied else 0.0))
    launches = read_launches(counters)
    n_device = len(engine._device_index)
    applied = [r for r in rows if r["applied"]]
    checks = {
        "scale follows the rule": [r["scale"] for r in rows] == [
            s for s, _ in _scale_rule([not r["applied"] for r in rows],
                                      P21_OFFLOAD_FP16)],
        "some steps skip, some apply":
            P21_OFFLOAD_APPLIED <= len(applied) < len(rows),
        "host masters frozen across skips": all(frozen) and bool(frozen),
        "fused_adamw: device leaves x applied steps":
            launches["fused_adamw"] == n_device * len(applied),
        "loss falls once settled": len(applied) > 1
        and applied[-1]["loss"] < applied[0]["loss"]}
    summary = dict(card=card, fp16=P21_OFFLOAD_FP16, steps=rows,
                   offloaded=engine.offload.offload_paths, checks=checks)
    del engine
    return summary, launches


def _state_bytes(engine) -> int:
    """Bytes a parameter of state holds on the card: the masters, the
    optimizer's state, the gradient accumulators and, over fp32 masters,
    the step's bf16 compute copy."""
    import torch
    n = sum(p.numel() for p in engine.masters)
    total = sum(p.numel() * p.element_size() for p in engine.masters)
    total += sum(g.numel() * g.element_size() for g in engine._grads)
    total += sum(v.numel() * v.element_size()
                 for st in engine.optimizer.state.values()
                 for v in st.values() if torch.is_tensor(v))
    if engine.master_dtype != engine.compute_dtype:
        total += 2 * n
    return total / n


def _p21_pure_bf16(params, batches, counters, card):
    """(d) the three non-default mixes of the bf16 flags with AdamW, Lion
    and LAMB: each through its bf16 instance."""
    import torch
    from deepspeed_tpu_torch.ops import fused_optimizer as FO
    from deepspeed_tpu_torch.tree import tree_leaves
    kernels = {"adamw": ("fused_adamw", FO.KERNEL),
               "lion": ("fused_lion", FO.LION_KERNEL),
               "lamb": ("fused_lamb_stage1", FO.LAMB_KERNEL)}
    names = {"adamw": "fused_adamw", "lion": "fused_lion",
             "lamb": "fused_lamb"}
    runs, paths = {}, {}
    baseline = _p21_engine(params, _p21_config())
    baseline.train_batch(batches[0])
    default_bytes = _state_bytes(baseline)
    del baseline
    for mw, acc in P21_BF16_FLAGS:
        for opt, opt_cfg in P21_BF16_OPTIMIZERS.items():
            label = (f"bf16_master_weights_{str(mw).lower()}_"
                     f"acc_fp32_{str(acc).lower()}_{opt}")
            engine = _p21_engine(params, _p21_config(
                optimizer=opt_cfg, bf16={"enabled": True,
                                         "master_weights": mw,
                                         "accumulate_grads_in_fp32": acc}))
            reset_launches(counters)
            losses = [engine.train_batch(batches[0])
                      for _ in range(P21_STEPS)]
            torch.cuda.synchronize()
            launches = read_launches(counters)
            base, kernel = kernels[opt]
            p, g = engine.masters[0], engine._grads[0]
            st = engine.optimizer.state[p]
            instance = FO.entry_point(base, p, g)
            n_leaves = len(tree_leaves(engine.params))
            by_fn = dict(kernel.launches_by_fn)
            checks = {
                "loss falls": losses[-1] < losses[0],
                "finite": all(math.isfinite(x) for x in losses),
                "a bf16 instance": instance != f"{base}_f32",
                "the instance: leaves x steps":
                    by_fn[instance] == n_leaves * P21_STEPS,
                "no other instance": sum(by_fn.values()) == by_fn[instance],
                "counted under the kernel's bf16 row":
                    launches[names[opt] + "_bf16"] == by_fn[instance]
                    and launches[names[opt]] == 0,
                "other optimizers idle": all(
                    launches[k] == launches[k + "_bf16"] == 0
                    for k in names.values() if k != names[opt]),
                "flash launched": launches["flash_fwd"] > 0}
            runs[label] = dict(
                losses=losses, instance=instance,
                master_dtype=str(engine.master_dtype),
                acc_dtype=str(engine.acc_dtype),
                state_bytes_per_param=_state_bytes(engine), checks=checks)
            paths[f"training_{label}"] = launches
            log(f"phase 21 (d) {label}: losses {losses}, {instance} "
                f"{by_fn[instance]} launches, state "
                f"{runs[label]['state_bytes_per_param']:.2f} B a parameter "
                f"against {default_bytes:.2f} with both flags on; {card}")
            del engine, p, g, st
    return dict(card=card, default_state_bytes_per_param=default_bytes,
                runs=runs), paths


#: the bf16 p check: the plain step must move at least this share of
#: the elements, and at most this share may round the other way
BF16_MOVED_MIN = 0.5
BF16_ULP_SHARE_MAX = 1e-4


def bf16_ulps(p0, p, ref):
    """|p - ref| of two bf16 results of one step from ``p0``, in bf16
    ulps of the larger of |p0| and |ref|: a rounding the other way is
    one ulp, also where the step cancels most of a weight."""
    import torch
    scale = torch.maximum(p0.float().abs(), ref.float().abs())
    ulp = torch.ldexp(torch.ones_like(scale), torch.frexp(scale).exponent - 8)
    return (p.float() - ref.float()).abs() / ulp


def bf16_update_errors(p0, p, ref):
    """A bf16 p that the kernel and its plain version updated from the
    same ``p0``: the share of elements the plain step moved, the largest
    gap in ulps (:func:`bf16_ulps`), the share of elements that differ,
    and the rms gap of the two updates ``p - p0`` relative to the plain
    one's."""
    d, rd = p.float() - p0.float(), ref.float() - p0.float()
    return dict(moved_share=float((ref != p0).float().mean()),
                max_ulps=float(bf16_ulps(p0, p, ref).max()),
                ulp_share=float((p != ref).float().mean()),
                update_rms_rel_err=float((d - rd).pow(2).mean().sqrt()
                                         / rd.pow(2).mean().sqrt()))


def check_bf16_instances(dev, cfg):
    """The pure-bf16 instance of each optimizer kernel (bf16 p, fp32 g
    and fp32 moments: ``bf16.master_weights`` false) against its plain
    version on the card, at one 4096 x 11008 leaf with p at a trained
    weight's scale (0.02), where an update of 1e-4 is a few bf16 ulps.
    AdamW's p: the plain step moves most elements, every element is
    within one ulp (:func:`bf16_ulps`) of the plain result and at most
    BF16_ULP_SHARE_MAX differ, the updates agree at RMS_REL_TOL; Lion's p and m bit for
    bit; the fp32 moments and LAMB's fp32 update at the kernel rows'
    tolerances.  Also ms, bound (bytes), plain ms and, for AdamW,
    ``torch.optim.AdamW(fused=True)`` over bf16 parameters."""
    import torch
    from deepspeed_tpu_torch.ops import fused_optimizer as FO
    g = torch.Generator(device=dev).manual_seed(SEED + 73)
    n = cfg.hidden_size * cfg.intermediate_size

    def buffers(count):
        bufs = [torch.randn(n, generator=g, device=dev)
                for _ in range(count)]
        bufs[0] = (0.02 * bufs[0]).to(torch.bfloat16)
        if count == 4:
            bufs[3] = bufs[3].abs()
        return bufs
    rows = {}
    hp = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, step=3)
    lhp = dict(lr=1e-4, b1=0.9, b2=0.99, wd=0.1)
    shp = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01, step=3)
    cases = {
        # p 2 + 2, g 4, m and v 4 + 4 each: 24 B an element
        "fused_adamw_bf16": (4, lambda b: FO.fused_adamw_flat(*b, **hp),
                             lambda b: FO.adamw_reference(*b, **hp), 24, 15),
        # p 2 + 2, g 4, m 4 + 4: 16 B
        "fused_lion_bf16": (3, lambda b: FO.fused_lion_flat(*b, **lhp),
                            lambda b: FO.lion_reference(*b, **lhp), 16, 10),
        # p 2, g 4, m and v 4 + 4 each, u 4: 26 B
        "fused_lamb_bf16": (4, lambda b: FO.lamb_stage1(*b, **shp),
                            lambda b: FO.lamb_stage1_reference(*b, **shp),
                            26, 20)}
    for name, (count, kernel, plain, per_elem, flops) in cases.items():
        bufs = buffers(count)
        p0, ref = bufs[0].clone(), [x.clone() for x in bufs]
        out, rout = kernel(bufs), plain(ref)
        pairs = list(zip(bufs, ref))
        if name == "fused_lamb_bf16":
            pairs = [(out[0], rout[0])] + pairs[2:]
            extra = {}
        else:
            extra = bf16_update_errors(p0, bufs[0], ref[0])
            extra["bit_equal"] = all(torch.equal(a, b) for a, b in pairs)
            pairs = pairs[2:]   # the fp32 moments
        err = _max_errors(pairs)
        if name != "fused_lamb_bf16":
            err["max_abs_err"] = max(err["max_abs_err"], float(
                (bufs[0].float() - ref[0].float()).abs().max()))
        ms = cuda_ms(lambda: kernel(bufs), 10)
        plain_ms = cuda_ms(lambda: plain(ref), 5)
        library_ms = None
        if name == "fused_adamw_bf16":
            p = bufs[0].clone().requires_grad_()
            p.grad = bufs[1].to(torch.bfloat16)
            lib = torch.optim.AdamW([p], lr=hp["lr"],
                                    betas=(hp["b1"], hp["b2"]),
                                    eps=hp["eps"], weight_decay=hp["wd"],
                                    fused=True)
            library_ms = cuda_ms(lib.step, 10)
            del lib, p
        b_ms, b_by = bound(per_elem * n, flops * n, FP32_FLOPS_PER_S)
        rows[name] = [dict(shape=f"one leaf {cfg.hidden_size}x"
                           f"{cfg.intermediate_size}: bf16 p (scale 0.02), "
                           f"fp32 g and moments", **err, **extra, ms=ms,
                           plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=b_ms, bound_by=b_by)]
        del bufs, ref, pairs, out, rout, p0
        torch.cuda.empty_cache()
    for name, (row,) in rows.items():
        bad = []
        if not (row["rms_rel_err"] <= RMS_REL_TOL
                and row["max_rel_err"] <= MAX_REL_TOL):
            bad.append("the fp32 outputs exceed the kernel rows' tolerances")
        if "moved_share" in row:
            if row["moved_share"] < BF16_MOVED_MIN:
                bad.append("the plain step moves too few elements of p for "
                           "the check to see the update")
            if row["max_ulps"] > 1 or row["ulp_share"] > BF16_ULP_SHARE_MAX \
                    or row["update_rms_rel_err"] > RMS_REL_TOL:
                bad.append("p's update differs from the plain version's")
        if name == "fused_lion_bf16" and not row["bit_equal"]:
            bad.append("Lion's p or m is not bit-equal to the plain version")
        if bad:
            raise RuntimeError(f"{name} disagrees with its plain version "
                               f"({'; '.join(bad)}): {row}")
        log(f"kernel {name} [{row['shape']}]: rms_rel_err "
            f"{row['rms_rel_err']:.3e}, max_rel_err {row['max_rel_err']:.3e}"
            + (f", p: moved {row['moved_share']:.4f}, max ulps "
               f"{row['max_ulps']}, ulp share {row['ulp_share']:.3e}, "
               f"update rms {row['update_rms_rel_err']:.3e}"
               if "moved_share" in row else "")
            + f"; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"library {row['library_ms']}, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})")
    return rows


def _p21_update_check(name, params_cfg, leaves, states, grads, steps,
                      freeze_step=None):
    """``steps`` updates of real leaves on the card and on the CPU from
    the same state and gradients: (the largest gap of the weights
    relative to the leaf's largest, the share of weights whose gap
    passes P21_UPDATE_REL_TOL)."""
    import torch
    from deepspeed_tpu_torch.runtime.comm.compressed import onebit_optimizer
    from deepspeed_tpu_torch.runtime.optimizers import get_optimizer
    out = {}
    for dev in (P21_DEVICE, "cpu"):
        ps = [p.detach().to(dev, copy=True) for p in leaves]
        if freeze_step is not None:
            opt = onebit_optimizer(name, ps, params_cfg.lr,
                                   freeze_step=freeze_step)
        else:
            opt = get_optimizer(name, params_cfg, ps)
        for p, st in zip(ps, states):
            if st:
                opt.state[p] = {k: (v.to(dev, copy=True)
                                    if torch.is_tensor(v) else v)
                                for k, v in st.items()}
        for k in range(steps):
            opt.step(grads=[g.to(dev) * (1 + k) for g in grads])
        out[dev] = [p.float().cpu() for p in ps]
    gaps = [(a - b).abs() / b.abs().max() for a, b in
            zip(out[P21_DEVICE], out["cpu"])]
    return (max(float(g.max()) for g in gaps),
            sum(int((g > P21_UPDATE_REL_TOL).sum()) for g in gaps)
            / sum(g.numel() for g in gaps))


def _p21_other_optimizers(params, batches, counters, card):
    """(e) every other optimizer name: 3 steps each through the engine
    (the fused optimizer kernels idle), Adafactor and Muon refused as the
    JAX engine refuses them, and one update of real leaves on the card
    against the CPU (three for the 1-bit family, also at freeze_step 2)."""
    import torch
    from deepspeed_tpu_torch.runtime.config import OptimizerParams
    runs, paths, real = {}, {}, {}
    for name, opt_params in P21_OTHER.items():
        over = dict(optimizer={"type": name, "params": opt_params})
        if name in ("onebitadam", "onebitlamb", "zerooneadam"):
            over["scheduler"] = {"type": "WarmupLR", "params": {
                "warmup_min_lr": 0.0, "warmup_max_lr": opt_params["lr"],
                "warmup_num_steps": 2}}
        else:
            over["scheduler"] = None
        config = _p21_config(**over)
        if config["scheduler"] is None:
            config.pop("scheduler")
        engine = _p21_engine(params, config)
        reset_launches(counters)
        losses = [engine.train_batch(batches[0]) for _ in range(P21_STEPS)]
        torch.cuda.synchronize()
        launches = read_launches(counters)
        idx = [engine.param_paths.index(p) for p in P21_UPDATE_LEAVES]
        leaves = [engine.masters[i].detach().clone() for i in idx]
        states = [{k: (v.detach().clone() if torch.is_tensor(v) else v)
                   for k, v in engine.optimizer.state[engine.masters[i]]
                   .items()} for i in idx]
        grads = [engine._grads[i].detach().clone() for i in idx]
        real[name] = (leaves, states, grads)
        checks = {
            "finite": all(math.isfinite(x) for x in losses),
            "loss falls": losses[-1] < losses[0],
            "fused optimizer kernels idle": all(
                launches[k] == 0 for k in (
                    "fused_adamw", "fused_lion", "fused_lamb",
                    "fused_adamw_bf16", "fused_lion_bf16",
                    "fused_lamb_bf16")),
            "flash launched": launches["flash_fwd"] > 0
            and launches["flash_bwd"] > 0}
        runs[name] = dict(losses=losses, optimizer=type(
            engine.optimizer).__name__, checks=checks)
        paths[f"training_{name}"] = launches
        del engine
    refused = {}
    for name in P21_REFUSED:
        try:
            _p21_engine(params, _p21_config(
                optimizer={"type": name, "params": {"lr": 1e-3}}))
            refused[name] = False
        except ValueError as e:
            refused[name] = name in str(e)
    gc.collect()
    # one update of the real leaves (the SGD run's gradients for the
    # refused two, from a fresh state)
    updates = {}
    for name, opt_params in {**P21_OTHER, "adafactor": {"lr": 1e-3},
                             "muon": {"lr": 1e-3}}.items():
        leaves, states, grads = real.get(name, (
            real["sgd"][0], [{}] * len(P21_UPDATE_LEAVES), real["sgd"][2]))
        cfg = OptimizerParams(**opt_params)
        updates[name] = _p21_update_check(name, cfg, leaves, states, grads, 1)
        if name in ("onebitadam", "onebitlamb", "zerooneadam"):
            # the norm scales only: each compression's sign makes an
            # element at a reduction's rounding flip, so the large leaf
            # adds flips, not coverage
            updates[f"{name} freeze_step 2"] = _p21_update_check(
                name, cfg, leaves[:2], states[:2], grads[:2], 3,
                freeze_step=2)
    checks = {"engine refuses Adafactor and Muon": all(refused.values()),
              "updates on the card match the CPU's": all(
                  gap <= P21_UPDATE_REL_TOL for k, (gap, _) in updates.items()
                  if "freeze_step" not in k),
              "compressed updates part only at sign ties": all(
                  share <= P21_FLIP_SHARE_MAX
                  for k, (_, share) in updates.items()
                  if "freeze_step" in k)}
    return dict(card=card, runs=runs, refused=refused,
                update_rel_gap={k: v[0] for k, v in updates.items()},
                update_flip_share={k: v[1] for k, v in updates.items()},
                update_rel_tol=P21_UPDATE_REL_TOL,
                flip_share_max=P21_FLIP_SHARE_MAX, checks=checks), paths


def _p21_api(params, batches, counters, card):
    """(f) set_lr, a forced partial boundary, the batch-size setters and
    destroy."""
    import torch
    mem0 = torch.cuda.memory_allocated()
    gas2 = _p21_engine(params, _p21_config())
    gas1 = _p21_engine(params, _p21_config(gradient_accumulation_steps=1))
    reset_launches(counters)
    ids = batches[0]["input_ids"]
    mb = {"input_ids": ids[:TRAIN_MICRO]}
    gas2.set_gradient_accumulation_boundary(True)
    gas2.backward(gas2.forward(mb))
    gas2.step()
    gas2.set_gradient_accumulation_boundary(None)
    gas1.train_batch(mb)
    partial_gap = max(float((a - b).abs().max())
                      for a, b in zip(gas2.masters, gas1.masters))
    del gas1
    gas2.set_lr(1e-5)
    gas2.train_batch(batches[1])
    lr_set = gas2._last_lr
    gas2.set_train_micro_batch_size(1)
    info_micro = gas2.get_batch_info()
    gas2.train_batch({"input_ids": ids[:2]})
    gas2.set_train_batch_size(4)
    info_batch = gas2.get_batch_info()
    gas2.train_batch({"input_ids": ids[:4]})
    launches = read_launches(counters)
    gas2.destroy()
    try:
        gas2.train_batch(batches[0])
        refused = False
    except RuntimeError:
        refused = True
    del gas2
    gc.collect()
    torch.cuda.empty_cache()
    mem1 = torch.cuda.memory_allocated()
    checks = {
        "a forced boundary equals a gas-1 step": partial_gap
        <= P21_PARTIAL_ATOL,
        "set_lr is the next step's lr": lr_set == 1e-5,
        "set_train_micro_batch_size": info_micro == (2, 1, 2),
        "set_train_batch_size": info_batch == (4, 1, 4),
        "destroy refuses later calls": refused,
        "destroy returns the memory": mem1 <= mem0}
    return dict(card=card, partial_gap=partial_gap, lr=lr_set,
                batch_info=[info_micro, info_batch],
                memory_before_build_gb=mem0 / 1e9,
                memory_after_destroy_gb=mem1 / 1e9, checks=checks), launches


def _p21_ltd_and_profiler(params, batches, counters, card):
    """(g) Random-LTD's gather and scatter at a training shape, and the
    flops profiler at profile_step 1 beside the analytic count."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import threefry
    from deepspeed_tpu_torch.runtime.data_pipeline import data_routing as R
    from deepspeed_tpu_torch.tree import tree_leaves
    g = torch.Generator(device=P21_DEVICE).manual_seed(SEED + 79)
    x = torch.randn(TRAIN_MICRO, TRAIN_SEQ, 4096, generator=g,
                    device=P21_DEVICE).to(torch.bfloat16)
    key = threefry.key_from_seed(SEED + 79)
    kept, _ = R.token_sort_indices(key.to(P21_DEVICE), TRAIN_MICRO,
                                   TRAIN_SEQ, P21_LTD_KEEP)
    kept_cpu, _ = R.token_sort_indices(key, TRAIN_MICRO, TRAIN_SEQ,
                                       P21_LTD_KEEP)
    sub = R.gather_tokens(x, kept)
    back = R.scatter_tokens(x, sub * 2, kept)
    xc = x.cpu()
    sub_c = R.gather_tokens(xc, kept_cpu)
    back_c = R.scatter_tokens(xc, sub_c * 2, kept_cpu)
    ltd = {"indices equal": torch.equal(kept.cpu(), kept_cpu),
           "gather bit-equal": torch.equal(sub.cpu(), sub_c),
           "scatter bit-equal": torch.equal(back.cpu(), back_c)}
    del x, sub, back, xc, sub_c, back_c

    engine = _p21_engine(params, _p21_config(flops_profiler={
        "enabled": True, "profile_step": 1}))
    reset_launches(counters)
    losses = [engine.train_batch(b) for b in batches[:2]]
    launches = read_launches(counters)
    prof = engine.flops_profile
    cfg = engine.module.cfg
    n_params = sum(p.numel() for p in tree_leaves(engine.params))
    # matrix products by weight: every parameter but the input embedding
    # (a gather) and the norm scales (elementwise)
    n_matmul = n_params - cfg.vocab_size * cfg.hidden_size - (
        2 * cfg.num_layers + 1) * cfg.hidden_size
    # remat recomputes a layer's forward up to the last tensor its
    # backward reads, so not the MLP's down projection (PyTorch's
    # non-reentrant checkpoint stops there)
    n_recomputed = (n_matmul - cfg.vocab_size * cfg.hidden_size
                    - cfg.num_layers * cfg.intermediate_size
                    * cfg.hidden_size)
    tokens = TRAIN_GAS * TRAIN_MICRO * TRAIN_SEQ
    attn = cfg.num_layers * TRAIN_SEQ * cfg.hidden_size
    # forward + backward (6 N + 6 L S E a token, attention over the causal
    # half), plus remat's recomputed products (2 N_recomputed + 2 L S E)
    analytic = tokens * (6 * n_matmul + 6 * attn + 2 * n_recomputed
                         + 2 * attn)
    counted = prof.get_total_flops()
    summary = dict(card=card, losses=losses, ltd=ltd,
                   profiler_flops=counted, analytic_flops=analytic,
                   gap=counted / analytic - 1,
                   top_ops=prof.summary()["top_ops"],
                   checks=dict(ltd, **{
                       "profiler within 2% of the analytic count":
                           abs(counted / analytic - 1) <= 0.02,
                       "losses finite": all(math.isfinite(x)
                                            for x in losses)}))
    del engine
    return summary, launches


def training_rest_phase(counters, card):
    """Phase 21 (module docstring): fp16 with dynamic and static loss
    scaling and offload, pure bf16, every other optimizer, the engine's
    API, Random-LTD and the flops profiler at Llama-2-7B width and
    P21_LAYERS layers.  Returns (launches by path, kernel rows of the
    bf16 instances)."""
    import torch
    from deepspeed_tpu_torch.models.llama import llama_config
    from deepspeed_tpu_torch.models.transformer import init_params
    gc.collect()
    torch.cuda.empty_cache()
    cfg = llama_config("7b", num_layers=P21_LAYERS)
    t0 = time.perf_counter()
    rows = check_bf16_instances(torch.device("cuda"), cfg)
    params = init_params(cfg, SEED + 67, P21_DEVICE, dtype=torch.float32)
    batches = _p21_batches(cfg.vocab_size, 4)
    paths, report = {}, {}
    parts = (("a", "training_fp16_dynamic", _p21_fp16_dynamic),
             ("b", "training_fp16_static", _p21_fp16_static),
             ("c", "training_fp16_offload", _p21_fp16_offload),
             ("d", None, _p21_pure_bf16),
             ("e", None, _p21_other_optimizers),
             ("f", "training_api", _p21_api),
             ("g", "training_profiler", _p21_ltd_and_profiler))
    for part, path, fn in parts:
        t = time.perf_counter()
        summary, launches = fn(params, batches, counters, card)
        if path is None:
            paths.update(launches)
        else:
            paths[path] = launches
        checks = dict(summary.get("checks", {}))
        for name, run in summary.get("runs", {}).items():
            checks.update({f"{name}: {k}": v
                           for k, v in run.get("checks", {}).items()})
        summary["seconds"] = time.perf_counter() - t
        report[part] = summary
        log(f"phase 21 ({part}): {json.dumps(summary, default=str)}")
        if not all(checks.values()):
            raise RuntimeError(f"phase 21 ({part}) checks failed: "
                               f"{ {k: v for k, v in checks.items() if not v} }")
    log(f"phase 21: {time.perf_counter() - t0:.1f} s; {card}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return paths, rows


# ---------------------------------------------------------------------------
# phase 22: the trace toolchain (deepspeed_tpu_torch.tools) on the card
# ---------------------------------------------------------------------------

#: the in-repo recorded trace (16-token pages, vocabulary 128)
TRACE_PATH = "tools/traces/sample_200.jsonl"
TRACE_LIMIT = 32               # (a), (b), (e): the JAX smoke's limit
TRACE_TIER_LIMIT = 24          # (c): the JAX tier smoke's
TRACE_PLAN_LIMIT = 20          # (d): the JAX capacity smoke's
TRACE_CUT_LAYERS = 8           # (b), (c)
TRACE_SMALL_LAYERS = 2         # (d), (e)
#: JAX ``plan_capacity``'s residual limit (a fraction of the measured)
TRACE_RESIDUAL_TOL = 0.10


def _trace_dispatches(*reports, captured=None) -> dict:
    """{step key: dispatches} summed over replay reports of fresh
    engines, plus one for each key a graph was captured for (its eager
    run before the capture launches the kernels once more):
    ``captured``, a list of each engine's captured keys; by default the
    reports' distinct keys (one engine)."""
    out = {}
    for rep in reports:
        for key, n in rep["dispatches"]:
            key = tuple(key)
            out[key] = out.get(key, 0) + n
    for keys in (captured if captured is not None else [list(out)]):
        for key in keys:
            out[tuple(key)] = out.get(tuple(key), 0) + 1
    return out


def _trace_replay(counters, card, root):
    """(a): ``run_replay`` over the trace's first TRACE_LIMIT ok requests
    at Llama-2-7B width and depth (bf16, 16-token pages), the shape
    warm-up and the measured pass, then the n-gram spec pass; its
    measured pass records into a private workload ledger (returned for
    (d))."""
    import tempfile
    from deepspeed_tpu_torch.models.llama import llama_config
    from deepspeed_tpu_torch.telemetry.workload_trace import get_workload_trace
    from deepspeed_tpu_torch.tools import replay_trace as RT
    ledger_dir = tempfile.mkdtemp(prefix="ds_trace_phase_")
    ledger = f"{ledger_dir}/replay.jsonl"
    wt = get_workload_trace()
    wt.configure(ledger)
    reset_launches(counters)
    try:
        out = RT.run_replay(f"{root}/{TRACE_PATH}", limit=TRACE_LIMIT,
                            model_size="7b", spec=True, drafter="ngram",
                            device="cuda", capture=True)
    finally:
        wt.close()
    launches = read_launches(counters)
    rep, spec = out["replay"], out["spec"]
    seg = segment_counts(llama_config("7b"), _trace_dispatches(
        out["warmup"], rep, spec["warmup"], spec["replay"]))
    requests = RT._replayable(RT.load_trace(f"{root}/{TRACE_PATH}"),
                              TRACE_PATH, TRACE_LIMIT, False)
    checks = launch_checks(llama_config("7b"), "none", launches, seg)
    checks.update({
        "structural parity": out["diff"]["structural_ok"],
        "spec pass structural parity": spec["diff"]["structural_ok"],
        "every generated length exact": all(
            rep["gen_lens"].get(i) == max(1, int(r["gen_len"]))
            for i, r in enumerate(requests)),
        "no capture in the measured pass": (
            rep["path_captures"] == 0 and rep["compile_on_path"] == 0),
        "no structured error": not rep["errors"]})
    summary = dict(
        card=card, model="Llama-2-7B bf16, 32 layers, 16-token pages",
        requests=out["requests"], tok_s=rep["decode_tok_s"],
        ttft_p50_ms=rep["ttft_p50_ms"], ttft_p99_ms=rep["ttft_p99_ms"],
        wall_s=rep["wall_s"], warm_up_captures=out["warmup"]["path_captures"],
        measured_captures=rep["path_captures"],
        spec_measured_captures=spec["replay"]["path_captures"],
        accept_rate=spec["accept_rate"], spec_drafted=spec["drafted"],
        spec_tok_s=spec["tok_s_on"], spec_tok_s_ratio=spec["tok_s_ratio"],
        slo=out["diff"]["slo"], segments=seg, launches=launches,
        checks=checks)
    return summary, launches, ledger


def _parting_witness(engine, uid, prompt, sp, ours, theirs):
    """Where two served rows of one request part: the first position t
    where ``ours`` and ``theirs`` differ, and the row's keyed draw there
    recomputed on ``engine``'s eager forward over the prompt and the
    shared tokens: the perturbed scores (the filtered logits plus the
    draw's gumbel noise; the logits alone for a greedy row) of both
    tokens, their gap over the largest |logit| (``gap_rel``) and the
    token the draw picks.  None when the rows are equal."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.inference.v2 import sampling as S
    from deepspeed_tpu_torch.inference.v2 import threefry as TF
    t = next((i for i, (a, b) in enumerate(zip(ours, theirs)) if a != b),
             None)
    if t is None:
        return None
    engine.reset_prefix_cache()
    with eager_steps(engine):
        row = engine.put([9000 + uid], [np.concatenate(
            [np.asarray(prompt, np.int32),
             np.asarray(ours[:t], np.int32)])])[0].float()
    engine.flush(9000 + uid)
    dev = row.device

    def one(v, dtype):
        return torch.tensor([v], dtype=dtype, device=dev)
    temps, ks, ps = (one(sp.temperature, torch.float32),
                     one(sp.top_k, torch.int32), one(sp.top_p, torch.float32))
    scores = row
    if sp.temperature > 0:
        keys = S.derive_row_keys(TF.key_from_seed(SEED, dev),
                                 one(uid, torch.int32), one(t, torch.int32))
        scores = (S._filter_rows(row[None], temps, ks, ps)[0][0]
                  + TF.gumbel(keys, row.numel())[0])
    a, b = int(ours[t]), int(theirs[t])
    pick = int(S.sample_keyed(row[None], S.derive_row_keys(
        TF.key_from_seed(SEED, dev), one(uid, torch.int32),
        one(t, torch.int32)), temps, ks, ps)[0])
    gap = float((scores[a] - scores[b]).abs())
    return dict(position=t, ours=a, theirs=b, pick=pick,
                sampled=sp.temperature > 0, score_gap=gap,
                gap_rel=gap / float(row.abs().max()))


def _trace_disagg(counters, card, root):
    """(b): at TRACE_CUT_LAYERS layers over one weight tree, the fused
    keyed replay (warm-up, then measured) and the disaggregated replay
    (warm-up, then measured with ``journeys``): every token of the
    disaggregated pass against the fused pass's, lost and orphaned
    journeys, handoff p50 ms."""
    from deepspeed_tpu_torch.inference.v2 import ServingOptimizationConfig
    from deepspeed_tpu_torch.tools import replay_trace as RT
    trace = RT.load_trace(f"{root}/{TRACE_PATH}")
    requests = RT._replayable(trace, TRACE_PATH, TRACE_LIMIT, False)
    meta = trace["meta"]
    parts = RT._replay_model_parts(meta, requests, "7b", "cuda",
                                   layers=TRACE_CUT_LAYERS)
    cfg, page = parts[0], parts[2]
    prompts = RT.synthesize_prompts(requests, page, RT._vocab(meta, cfg))
    reset_launches(counters)
    fused = RT.build_replay_engine(
        meta, requests, serving=ServingOptimizationConfig(
            keyed_sampling=True), device="cuda", parts=parts)
    fused_warm = RT.replay(fused, requests, prompts)
    RT._reset_engine(fused)
    fused_tok = {}
    fused_rep = RT.replay(fused, requests, prompts, on_token=lambda u, t:
                          fused_tok.setdefault(u, []).append(int(t)))
    captured = [list(fused.model._step_cache)]
    pre, dec = RT.build_disagg_engines(meta, requests, keyed=True,
                                       device="cuda", parts=parts)
    warm = RT.replay_disagg(pre, dec, requests, prompts)
    RT._reset_engine(pre)
    RT._reset_engine(dec)
    tok = {}
    rep = RT.replay_disagg(pre, dec, requests, prompts, journeys=True,
                           on_token=lambda u, t:
                           tok.setdefault(u, []).append(int(t)))
    launches = read_launches(counters)
    captured += [list(pre.model._step_cache), list(dec.model._step_cache)]
    seg = segment_counts(cfg, _trace_dispatches(
        fused_warm, fused_rep, warm, rep, captured=captured))
    equal = sum(tok.get(u) == fused_tok.get(u) for u in fused_tok)
    n_tokens = sum(len(v) for v in fused_tok.values())
    same_tokens = sum(a == b for u, v in fused_tok.items()
                      for a, b in zip(v, tok.get(u, [])))
    # bf16 GEMMs at the two engines' other batch shapes round a row's
    # logits differently: a parting must be a near-tie of its keyed draw,
    # recomputed on the fused engine's eager forward
    params = RT._sampling_params(requests)
    partings = {u: w for u in sorted(fused_tok) if (w := _parting_witness(
        fused, u, prompts[u], params[u], tok.get(u, []), fused_tok[u]))}
    wide = {u: w for u, w in partings.items()
            if w["gap_rel"] > LOGIT_REL_TOL
            or w["pick"] not in (w["ours"], w["theirs"])}
    del fused
    j = rep["journeys"]
    checks = launch_checks(cfg, "none", launches, seg)
    checks.update({
        "every row equal to the fused keyed replay's or parted at a "
        "near-tie": not wide and len(tok) == len(requests),
        "structural parity": RT.diff_replay(requests, prompts, page,
                                            rep)["structural_ok"],
        "no request lost": rep["lost"] == 0,
        "no orphan journey": j["orphans"] == 0,
        "journeys complete and gap-free": (
            not j["problems"] and j["completed_journeys"] == len(requests)),
        "no capture in the measured passes": (
            rep["path_captures"] == 0 and fused_rep["path_captures"] == 0),
        "handoffs": rep["handoffs"] == len(requests)})
    summary = dict(
        card=card, model=f"Llama-2-7B width, {TRACE_CUT_LAYERS} layers, bf16",
        requests=len(requests), rows_equal=equal,
        tokens_equal=f"{same_tokens} of {n_tokens}", partings=partings,
        near_tie_rel_tol=LOGIT_REL_TOL,
        handoff_p50_ms=rep["handoff_p50_ms"], handoffs=rep["handoffs"],
        handoff_bytes=rep["handoff_bytes"],
        pages_streamed=rep["pages_streamed"],
        pages_shared=rep["pages_shared"], tok_s=rep["decode_tok_s"],
        fused_tok_s=fused_rep["decode_tok_s"],
        ttft_p50_ms=rep["ttft_p50_ms"],
        fused_ttft_p50_ms=fused_rep["ttft_p50_ms"],
        journeys={k: j[k] for k in ("completed_journeys", "fragments",
                                    "orphans")},
        lost=rep["lost"], segments=seg, launches=launches, checks=checks)
    return summary, launches


def _trace_tier(counters, card, root):
    """(c): ``run_tier_smoke`` with 4 device pages asked for at
    TRACE_CUT_LAYERS layers: every promoted page read back bit-equal to
    the device bytes it had at demotion, the store's audit, hits by tier,
    every disk read and write through the async I/O handle (the plain
    path counts 0), promote-batch p50 ms (synchronised)."""
    import torch
    from deepspeed_tpu_torch.models.llama import llama_config
    from deepspeed_tpu_torch.tools import replay_trace as RT
    seen = {"verified": 0, "unequal": 0, "preads": 0, "pwrites": 0}
    promote_ms, hits = [], {}

    def instrument(engine):
        state = engine.state_manager
        store, stores = state.tiers, state.kv_cache._stores()
        aio = store._get_aio()
        if aio is None:
            raise RuntimeError("tier: the async I/O handle did not build")
        saved, taken = {}, []
        demote, promote = state._demote, state._promote_chain
        take_many, tier_hits = store.take_many, engine.tier_hits
        pread, pwrite = aio.pread, aio.pwrite

        def demote_kept(entries):
            for d, p in entries:
                saved[d] = [st[:, p].clone() for st in stores]
            return demote(entries)

        def take_recorded(digests):
            blobs, tiers = take_many(digests)
            taken[:] = digests[:len(blobs)]
            return blobs, tiers

        def promote_checked(*a):
            taken.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            pages, cursor = promote(*a)
            torch.cuda.synchronize()
            if pages:
                promote_ms.append((time.perf_counter() - t) * 1e3)
            for d, p in zip(taken, pages):
                want = saved.pop(d)
                seen["verified"] += 1
                seen["unequal"] += not all(
                    torch.equal(st[:, p], w) for st, w in zip(stores, want))
            return pages, cursor

        def hits_counted(uid):
            h = tier_hits(uid)
            for k, v in (h or {}).items():
                hits[k] = hits.get(k, 0) + v
            return h

        def pread_counted(*a, **k):
            seen["preads"] += 1
            return pread(*a, **k)

        def pwrite_counted(*a, **k):
            seen["pwrites"] += 1
            return pwrite(*a, **k)
        state._demote, state._promote_chain = demote_kept, promote_checked
        store.take_many, engine.tier_hits = take_recorded, hits_counted
        aio.pread, aio.pwrite = pread_counted, pwrite_counted

    reset_launches(counters)
    out = RT.run_tier_smoke(f"{root}/{TRACE_PATH}", limit=TRACE_TIER_LIMIT,
                            device_pages=4, model_size="7b",
                            layers=TRACE_CUT_LAYERS, device="cuda",
                            on_engine=instrument)
    launches = read_launches(counters)
    cfg = llama_config("7b", num_layers=TRACE_CUT_LAYERS)
    seg = segment_counts(cfg, _trace_dispatches(out["wave1"], out["replay"]))
    st = out["tier"]
    tok1, tok2 = out["tokens"]["wave1"], out["tokens"]["wave2"]
    # a warm wave prefills only the suffix over promoted pages: in bf16
    # its logits may part from the cold wave's on a near-tie, so the
    # tokens are reported here, and the promoted pages held bit-equal
    other = [p for p in out["diff"]["problems"]
             if not p.startswith("[tier] warm-from-tier tokens differ")]
    checks = launch_checks(cfg, "none", launches, seg)
    checks.update({
        "promoted pages bit-equal": (seen["unequal"] == 0
                                     and seen["verified"] > 0
                                     and seen["verified"]
                                     == st["promoted_pages"]),
        "structure, demotion, spill, promotion and audit clean": not other,
        "hits from host and disk": (hits.get("host", 0) > 0
                                    and hits.get("disk", 0) > 0),
        "disk I/O through the async I/O handle": (
            st["plain_io"] == 0 and seen["pwrites"] >= st["spilled_pages"]
            and seen["preads"] > 0)})
    summary = dict(
        card=card, model=f"Llama-2-7B width, {TRACE_CUT_LAYERS} layers, bf16",
        requests=out["requests"], device_pages=out["device_pages"],
        tier=st, hit_tokens_by_tier=hits, pages_verified=seen["verified"],
        aio_preads=seen["preads"], aio_pwrites=seen["pwrites"],
        promote_batches=len(promote_ms),
        promote_batch_p50_ms=(statistics.median(promote_ms)
                              if promote_ms else None),
        wave2_rows_equal_to_wave1=sum(tok2.get(u) == v
                                      for u, v in tok1.items()),
        problems=out["diff"]["problems"], segments=seg, launches=launches,
        checks=checks)
    return summary, launches


def _trace_plan(card, root, ledger, cache_dir):
    """(d): ``analyze`` over the ledger (a)'s measured pass captured (the
    recommended key set covers every observed key), then ``python -m
    deepspeed_tpu_torch.tools.plan_capacity --validate --oom-smoke
    --check`` at TRACE_SMALL_LAYERS layers in a child process (the
    ledger's measured bytes are the process's: this one holds the
    earlier phases' leftovers), loading phase 2's libraries: every
    ``ds_mem_*`` accountant readable, the residual within JAX's limit of
    the card's measured bytes, the injected OOM's forensics."""
    import os
    import tempfile
    from deepspeed_tpu_torch.tools import analyze_trace as AT
    from deepspeed_tpu_torch.tools import replay_trace as RT
    trace = RT.load_trace(ledger)
    report = AT.analyze(trace)
    observed = {tuple(k) for k in AT.observed_keys(trace)}
    recommended = {tuple(k) for k in report["recommended_lattice"]["keys"]}
    out_json = os.path.join(tempfile.mkdtemp(prefix="ds_trace_plan_"),
                            "plan.json")
    env = dict(os.environ, DS_COMPILE_CACHE=os.path.dirname(cache_dir))
    child = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.tools.plan_capacity",
         "--trace", f"{root}/{TRACE_PATH}", "--limit",
         str(TRACE_PLAN_LIMIT), "--model-size", "7b", "--layers",
         str(TRACE_SMALL_LAYERS), "--tolerance", str(TRACE_RESIDUAL_TOL),
         "--validate", "--oom-smoke", "--check", "--device", "cuda",
         "--json", out_json],
        capture_output=True, text=True, env=env, timeout=300, cwd=root)
    if not os.path.exists(out_json):
        raise RuntimeError(f"plan_capacity child failed:\n"
                           f"{child.stderr[-4000:]}")
    with open(out_json) as f:
        plan = json.load(f)
    v, s = plan["validate"], plan["oom_smoke"]
    bd = v["pass2"]
    checks = {
        "the ledger recorded the measured pass": (
            len(trace["requests"]) == TRACE_LIMIT and len(observed) > 0),
        "recommended keys cover every observed key": observed <= recommended,
        "no uncovered on-path key": not report["recommended_lattice"][
            "uncovered_on_path_compile_keys"],
        "plan_capacity --check exits 0": child.returncode == 0,
        "validate": v["ok"], "residual measured on the card": (
            v["residual_checked"] and bd["measured_source"] == "device"),
        "oom smoke": s["ok"]}
    return dict(
        card=card, observed_keys=len(observed),
        recommended_keys=len(recommended),
        q_buckets=report["recommended_lattice"]["q_buckets"],
        plan=plan["plan"], measured_bytes=bd["measured_bytes"],
        unaccounted_bytes=bd["unaccounted_bytes"],
        residual_share=(abs(bd["unaccounted_bytes"]) / bd["measured_bytes"]
                        if bd["measured_bytes"] else None),
        subsystems=bd["subsystems"],
        live_capacity_seqs=v["live_capacity_seqs"],
        predicted_capacity_seqs=v["predicted_capacity_seqs"],
        oom=dict((k, s[k]) for k in ("injected_fires", "breakdown_events",
                                     "dominant")),
        problems=v["problems"] + s["problems"], checks=checks)


def _trace_pool(card):
    """(e): ``fleetctl.run_pool_smoke`` on the card: two replicas of
    Llama-2-7B width at TRACE_SMALL_LAYERS layers (the debug Llama's head
    dim, 16, has no kernel instance: item 11k) replay the trace's first
    TRACE_LIMIT ok requests, one drain-migrated mid-run; it raises unless
    every generated length is exact and none is lost."""
    from deepspeed_tpu_torch.tools import fleetctl
    engines = {}
    with contextlib.redirect_stdout(sys.stderr):
        rc = fleetctl.run_pool_smoke(limit=TRACE_LIMIT, device="cuda",
                                     engines=engines, model_size="7b",
                                     layers=TRACE_SMALL_LAYERS)
    checks = {"pool smoke": rc == 0,
              "both replicas on the card": all(
                  e.model.device.type == "cuda" for e in engines.values())}
    return dict(card=card, replicas=sorted(engines), checks=checks)


def trace_phase(counters, card, cache_dir):
    """Phase 22 (module docstring): the port's trace tools on the card,
    parts (a)-(e), each a JSON line with its checks and seconds.  Returns
    {path: launches} of (a)-(c)."""
    import os
    import torch
    root = os.path.dirname(os.path.abspath(__file__))
    paths = {}
    t0 = time.perf_counter()

    def done(part, summary):
        summary["seconds"] = time.perf_counter() - t
        log(f"phase 22 ({part}): {json.dumps(summary, default=str)}")
        if not all(summary["checks"].values()):
            raise RuntimeError(f"phase 22 ({part}) checks: "
                               f"{summary['checks']}")
        gc.collect()
        torch.cuda.empty_cache()

    t = time.perf_counter()
    summary, paths["serving_trace_replay"], ledger = _trace_replay(
        counters, card, root)
    done("a", summary)
    t = time.perf_counter()
    summary, paths["serving_trace_disagg"] = _trace_disagg(counters, card,
                                                           root)
    done("b", summary)
    t = time.perf_counter()
    summary, paths["serving_trace_tier"] = _trace_tier(counters, card, root)
    done("c", summary)
    t = time.perf_counter()
    done("d", _trace_plan(card, root, ledger, cache_dir))
    t = time.perf_counter()
    done("e", _trace_pool(card))
    log(f"phase 22: {time.perf_counter() - t0:.1f} s")
    return paths


# ---------------------------------------------------------------------------
# phase 23: the one-card public API (the RLHF hybrid engine, init_inference,
# OptimizedLinear, sparse gradients, comm and the accelerator)
# ---------------------------------------------------------------------------

HYBRID_MICRO = 4
HYBRID_SEQ = 512
HYBRID_PROMPTS = 8
HYBRID_PROMPT_LENS = (64, 256)
HYBRID_NEW = 32
HYBRID_STEPS = (3, 1)            # train_batch calls between the rollouts
HYBRID_CONFIG = {
    "train_micro_batch_size_per_gpu": HYBRID_MICRO,
    "gradient_accumulation_steps": 1,
    "bf16": {"enabled": True},
    "gradient_clipping": 1.0,
    "optimizer": {"type": "adamw",
                  "params": {"lr": 1e-4, "betas": [0.9, 0.95],
                             "weight_decay": 0.1}},
    "hybrid_engine": {"enabled": True},
}
# a rollout row that parts from the fresh engine's must part at a near-tie:
# the fresh engine's top-two logits at the parting position within this
# share of the largest (a stale weight or KV page parts rows by whole
# logits; the two engines' pools differ in size, so the paged kernel's
# split count, and with it its rounding, may differ)
NEAR_TIE_REL = 1e-2
# the fresh engine's pool: the prompts' pages and their new tokens
FRESH_PAGES = 64
LORA_SHAPE = (4096, 11008)       # Llama-2-7B's MLP up-projection
LORA_R = 16
LORA_ROWS = 512
# (d): sparse against dense embedding gradients, GPT-1.3B at 4 layers
SPARSE_LAYERS = 4
SPARSE_STEPS = 2


def _p23_gpt(**over):
    from deepspeed_tpu_torch.models.gpt import GPTForCausalLM
    return GPTForCausalLM("1.3b", **over)


def _rollout_witness(fresh, prompt, ours, theirs) -> dict:
    """Where a hybrid rollout row parts from the fresh engine's: the
    position and the fresh engine's top-two logits there (its dense
    forward over the prompt and the tokens the two rows share)."""
    import torch
    j = next(i for i, (a, b) in enumerate(zip(ours, theirs)) if a != b)
    logits = fresh.forward([list(prompt) + list(theirs[:j])])[0, -1]
    top = torch.topk(logits.float(), 2).values
    gap = float(top[0] - top[1]) / float(logits.float().abs().max())
    return dict(at=j, gap_rel=gap, near_tie=gap <= NEAR_TIE_REL)


def _p23_hybrid(counters, card):
    """(a): the hybrid engine on GPT-1.3B at full width and depth."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.tree import tree_leaves
    rng = np.random.default_rng(SEED + 91)
    model = _p23_gpt()
    cfg = model.cfg
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in
               rng.integers(HYBRID_PROMPT_LENS[0], HYBRID_PROMPT_LENS[1] + 1,
                            HYBRID_PROMPTS)]
    ids = rng.integers(0, cfg.vocab_size, (HYBRID_MICRO, HYBRID_SEQ + 1))
    batch = {"input_ids": ids[:, :-1].astype(np.int32),
             "labels": ids[:, 1:].astype(np.int32)}
    torch.cuda.reset_peak_memory_stats()
    engine, *_ = dtt.initialize(model=model, config=HYBRID_CONFIG,
                                device="cuda")
    peak = [0]

    def mark():
        torch.cuda.synchronize()
        peak[0] = max(peak[0], torch.cuda.max_memory_allocated())

    rollouts, steps, train_launches, roll_launches = [], [], [], []
    ptrs = None
    for k in range(len(HYBRID_STEPS) + 1):
        inflight = engine._inflight_engine
        captures0 = (inflight.model.path_captures
                     + inflight.model.precompile_captures
                     if inflight is not None else 0)
        reset_launches(counters)
        t = time.perf_counter()
        outs = engine.generate(prompts, max_new_tokens=HYBRID_NEW,
                               do_sample=False)
        mark()
        roll_s = time.perf_counter() - t
        roll_launches.append(read_launches(counters))
        m = engine._inflight_engine.model
        leaves = tree_leaves(m.params)
        now = [t.data_ptr() for t in leaves]
        ptrs = ptrs or now
        # a separately built engine over the same bf16 weights
        weights = engine._cast_masters()
        fresh = dtt.init_inference(
            model=(engine.module.cfg, weights), device="cuda", config={
                "dtype": "bf16", "max_out_tokens": HYBRID_NEW,
                "kv_cache_pages": FRESH_PAGES})
        ref = fresh.generate(prompts, max_new_tokens=HYBRID_NEW)
        partings = [_rollout_witness(fresh, p, a, b)
                    for p, a, b in zip(prompts, outs, ref) if a != b]
        rollouts.append(dict(
            refresh_s=engine.refresh_seconds, rollout_s=roll_s,
            tokens=sum(map(len, outs)),
            tokens_per_s=sum(map(len, outs)) / roll_s,
            rows_equal=sum(a == b for a, b in zip(outs, ref)),
            partings=partings,
            captures=m.path_captures + m.precompile_captures - captures0,
            pointers_kept=now == ptrs,
            weights_equal=all(torch.equal(a, b) for a, b in zip(
                leaves, tree_leaves(weights)))))
        del fresh, weights
        gc.collect()
        torch.cuda.empty_cache()
        if k == len(HYBRID_STEPS):
            break
        reset_launches(counters)
        for _ in range(HYBRID_STEPS[k]):
            retries = torch.cuda.memory_stats()["num_alloc_retries"]
            t = time.perf_counter()
            loss = engine.train_batch(batch)
            mark()
            steps.append(dict(
                ms=(time.perf_counter() - t) * 1e3, loss=loss,
                # the caching allocator freed its cache and retried
                alloc_retries=torch.cuda.memory_stats()["num_alloc_retries"]
                - retries))
        train_launches.append(read_launches(counters))
    L, leaves = cfg.num_layers, len(tree_leaves(engine.params))
    train = {k: sum(la[k] for la in train_launches) for k in counters}
    roll = {k: sum(la[k] for la in roll_launches) for k in counters}
    n_steps = sum(HYBRID_STEPS)
    losses = [s["loss"] for s in steps]
    checks = {
        "rollouts equal the fresh engine's but at near-ties": all(
            p["near_tie"] for r in rollouts for p in r["partings"]),
        "the rollout weights are the masters' bf16 cast": all(
            r["weights_equal"] for r in rollouts),
        "no capture after the first rollout": all(
            r["captures"] == 0 for r in rollouts[1:]),
        "the rollout model's pointers kept": all(
            r["pointers_kept"] for r in rollouts),
        "refreshed at every step": engine._inference_params_step
        == engine.global_steps == n_steps,
        "every row generated": all(r["tokens"] == HYBRID_PROMPTS
                                   * HYBRID_NEW for r in rollouts),
        "finite losses": all(math.isfinite(x) for x in losses),
        "rollouts ran the serving kernels": all(
            roll[k] > 0 for k in ("paged_attention", "layernorm",
                                  "flash_fwd")),
        # the first rollout builds the pool after one probe forward and
        # backward (``train_transient_bytes``); the others train nothing
        "rollouts ran no training kernel but the first's probe": all(
            la[k] == (L if (i, k) == (0, "flash_bwd_dkv") else 0)
            for i, la in enumerate(roll_launches)
            for k in ("fused_adamw", "flash_bwd_dkv", "rmsnorm",
                      "paged_attention_int8")),
        "fused_adamw once a leaf a step": train["fused_adamw"]
        == leaves * n_steps,
        "flash kernels every layer": train["flash_fwd"] >= 2 * L * n_steps
        and train["flash_bwd_dkv"] == train["flash_bwd_dq"] == L * n_steps,
    }
    summary = dict(
        card=card, model="GPT-1.3B", layers=L, params=sum(
            p.numel() for p in tree_leaves(engine.params)),
        rollouts=rollouts, steps=steps,
        step_ms_median=float(np.median([s["ms"] for s in steps])),
        train_transient_gb=(engine.train_transient_bytes or 0) / 1e9,
        kv_pool_pages=engine._inflight_engine.model.kv_config.num_pages,
        peak_gb=peak[0] / 1e9, checks=checks)
    del engine
    return summary, {"hybrid_rollout": roll, "hybrid_train": train}


def _p23_init_inference(counters, card):
    """(b): init_inference on GPT-1.3B: forward's logits against the
    plain path (the einsum attention, every norm a torch op in both),
    generate's first greedy token against forward's argmax, the
    max_out_tokens guard; then the serving forward on the same weights,
    kernel path against plain path as phase 7 (``plain_vs_kernel``): the
    paged kernel at H = K = 16 and the LayerNorm kernel at E = 2048, the
    rollouts' kernels, against their plain versions."""
    import dataclasses
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models import transformer as T
    cfg = _p23_gpt().cfg
    params = randomize_norms_and_biases(T.init_params(
        cfg, SEED + 92, "cuda", dtype=torch.bfloat16), SEED + 96)
    eng = dtt.init_inference(model=(cfg, params), device="cuda",
                             config={"dtype": "fp16", "max_out_tokens": 8,
                                     "kv_cache_pages": FRESH_PAGES})
    rng = np.random.default_rng(SEED + 93)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (256, 256)]
    reset_launches(counters)
    logits = eng.forward(np.asarray(prompts, np.int32))
    first = eng.generate(prompts, max_new_tokens=1)
    launches = read_launches(counters)
    plain_cfg = dataclasses.replace(eng.module.cfg, attention_impl="einsum")
    with torch.no_grad():
        plain = T.forward(plain_cfg, eng.module.params,
                          torch.as_tensor(prompts, device="cuda"))
    err = parity(logits, plain)
    partings = []
    for i, p in enumerate(prompts):
        row = logits[i, -1].float()
        if first[i][0] != int(row.argmax()):
            top = torch.topk(row, 2).values
            partings.append(float(top[0] - top[1]) / float(row.abs().max()))
    try:
        eng.generate(prompts[:1], max_new_tokens=9)
        guard = False
    except ValueError:
        guard = True
    # the generic core, which init_inference and the rollouts build
    serving = plain_vs_kernel(eng.module.cfg, eng.module.params,
                              model_type="gpt")
    checks = {"logits within LOGIT_REL_TOL of the plain path":
              err["max_rel_err"] <= LOGIT_REL_TOL,
              "serving kernel path within LOGIT_REL_TOL of the plain path":
              serving["max_rel_logit_err"] <= LOGIT_REL_TOL,
              "first token is forward's argmax but at near-ties": all(
                  g <= NEAR_TIE_REL for g in partings),
              "fp16 maps to bf16": eng.module_config.dtype == torch.bfloat16,
              "max_out_tokens guard raises": guard,
              "the flash forward ran": launches["flash_fwd"] >= cfg.num_layers,
              "the serving kernels ran": launches["layernorm"] > 0}
    summary = dict(card=card, shape=list(logits.shape), **err,
                   tol=LOGIT_REL_TOL, first_token_partings=partings,
                   plain="attention_impl einsum (torch attention)",
                   kernel_vs_plain=serving, checks=checks)
    del eng, params, logits, plain
    return summary, {"init_inference": launches}


def _p23_lora(counters, card):
    """(c): OptimizedLinear at Llama-2-7B's MLP shape, int8 base, LoRA
    rank 16, bf16: the kernel path against the plain versions of the
    quantise and dequantise kernels on the card."""
    import torch
    from deepspeed_tpu_torch.linear import (LoRAConfig, OptimizedLinear,
                                            QuantizationConfig)
    from deepspeed_tpu_torch.ops import quantization as Q
    dev = torch.device("cuda")
    lin = OptimizedLinear(*LORA_SHAPE, lora_config=LoRAConfig(lora_r=LORA_R),
                          quantization_config=QuantizationConfig(),
                          dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(SEED + 94)
    base = (torch.rand(LORA_SHAPE, generator=g, device=dev) - 0.5) / 32
    reset_launches(counters)
    params = lin.init(SEED + 94, base_weight=base, device=dev)
    with torch.no_grad():
        params["lora_b"].normal_(0, 0.02, generator=g)
    x = torch.randn(LORA_ROWS, LORA_SHAPE[0], generator=g, device=dev,
                    dtype=torch.bfloat16)
    y = lin.apply(params, x)
    y.float().square().mean().backward()
    launches = read_launches(counters)
    # the plain versions of both kernels, on the card
    rq, rs, pad = Q.quantize_blockwise_reference(base)
    w = Q.dequantize_blockwise_reference(rq, rs, pad, LORA_SHAPE,
                                         torch.bfloat16)
    scaling = lin.lora.lora_alpha / lin.lora.lora_r
    with torch.no_grad():
        ref = x @ w + (x @ params["lora_a"]) @ params["lora_b"] * scaling
        merged = lin.merge(params)
        want = w.float() + params["lora_a"].float() \
            @ params["lora_b"].float() * scaling
    err = parity(y.detach(), ref)
    merge_err = float((merged - want).abs().max())
    with torch.no_grad():
        ms = cuda_ms(lambda: lin.apply(params, x), 20)
        plain_ms = cuda_ms(lambda: x @ Q.dequantize_blockwise_reference(
            rq, rs, pad, LORA_SHAPE, torch.bfloat16)
            + (x @ params["lora_a"]) @ params["lora_b"] * scaling, 20)
    checks = {
        "codes and scales bit-equal": torch.equal(params["base_q"], rq)
        and torch.equal(params["base_scale"], rs),
        "forward within the kernel rows' tolerances":
            err["rms_rel_err"] <= RMS_REL_TOL
            and err["max_rel_err"] <= MAX_REL_TOL,
        "the base gets no gradient": params["base_q"].grad is None
        and params["base_scale"].grad is None,
        "the adapters do": params["lora_a"].grad is not None
        and params["lora_b"].grad is not None,
        "merged is base + scaled B·A": merge_err <= 1e-6,
        "quantised once, dequantised at the forward":
            launches["quantize"] == 1 and launches["dequantize"] == 1,
    }
    summary = dict(card=card, shape=list(LORA_SHAPE), lora_r=LORA_R,
                   rows=LORA_ROWS, **err, merge_max_abs_err=merge_err,
                   forward_ms=ms, plain_forward_ms=plain_ms, checks=checks)
    return summary, {"optimized_linear": launches}


def _p23_sparse(counters, card):
    """(d): GPT-1.3B at SPARSE_LAYERS layers, ``sparse_gradients`` against
    the dense embedding backward from the same masters on the same batch:
    the first micro-batch's embedding gradient, then SPARSE_STEPS steps'
    losses and the embedding's update."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dtt
    rng = np.random.default_rng(SEED + 95)
    vocab = _p23_gpt().cfg.vocab_size
    ids = rng.integers(0, vocab, (HYBRID_MICRO, HYBRID_SEQ + 1))
    ids[:, ::16] = 11                      # ids that repeat in the batch
    batch = {"input_ids": ids[:, :-1].astype(np.int32),
             "labels": ids[:, 1:].astype(np.int32)}
    runs = {}
    for sparse in (True, False):
        config = dict(HYBRID_CONFIG, sparse_gradients=sparse,
                      hybrid_engine={"enabled": False})
        engine, *_ = dtt.initialize(
            model=_p23_gpt(num_layers=SPARSE_LAYERS), config=config,
            device="cuda")
        emb = engine.param_paths.index("embed/tokens")
        init = engine.masters[emb].detach().clone()
        reset_launches(counters)
        engine.backward(engine.forward({k: v[:HYBRID_MICRO]
                                        for k, v in batch.items()}))
        grad = engine._grads[emb].detach().clone()
        for g in engine._grads:
            g.zero_()
        engine._pending = 0
        engine._params_c = None
        losses = [engine.train_batch(batch) for _ in range(SPARSE_STEPS)]
        runs[sparse] = dict(grad=grad, losses=losses,
                            update=engine.masters[emb].detach() - init,
                            launches=read_launches(counters),
                            sparse=engine.module.cfg.sparse_gradients)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    s, d = runs[True], runs[False]
    grad_err = parity(s["grad"], d["grad"])
    upd_err = parity(s["update"], d["update"])
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(s["losses"],
                                                         d["losses"]))
    checks = {
        "the sparse backward ran": s["sparse"] and not d["sparse"],
        "embedding gradient within GRAD_RMS_REL_TOL":
            grad_err["rms_rel_err"] <= GRAD_RMS_REL_TOL,
        "losses within LOSS_REL_TOL": loss_gap <= LOSS_REL_TOL,
        "embedding update within GRAD_RMS_REL_TOL":
            upd_err["rms_rel_err"] <= GRAD_RMS_REL_TOL,
        "flash kernels on both": all(
            r["launches"]["flash_bwd_dkv"] > 0 for r in runs.values()),
    }
    summary = dict(card=card, layers=SPARSE_LAYERS,
                   grad_err=grad_err, update_err=upd_err,
                   loss_rel_gap=loss_gap, losses_sparse=s["losses"],
                   losses_dense=d["losses"], checks=checks)
    return summary, {"training_sparse_gradients": s["launches"]}


def _p23_comm(card):
    """(e): ``comm`` at one rank with the comms logger on, and the CUDA
    accelerator."""
    import torch
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch import comm
    dtt.init_distributed()
    comm.configure_comms_logger()
    x = torch.randn(1024, 1024, device="cuda")
    outs = [comm.all_reduce(x), comm.all_gather(x), comm.reduce_scatter(x),
            comm.broadcast(x), comm.all_to_all_single(x)]
    text = comm.log_summary()
    comm.comm._comms_logger = None
    acc = dtt.get_accelerator()
    stats = acc.memory_stats()
    checks = {
        "identity over one rank": all(o is x for o in outs),
        "summary lists every op": all(
            op in text for op in ("all_reduce", "all_gather",
                                  "reduce_scatter", "broadcast",
                                  "all_to_all")),
        "rank 0 of 1": (comm.get_rank(), comm.get_world_size()) == (0, 1),
        "the CUDA accelerator": acc.device_name() == "cuda"
        and acc.communication_backend_name() == "nccl",
        "its memory": stats["bytes_limit"] > 0
        and stats["bytes_in_use"] == torch.cuda.memory_allocated(),
    }
    return dict(card=card, device=torch.cuda.get_device_name(0),
                accelerator=acc.device_name(0),
                total_memory_gb=acc.total_memory() / 1e9,
                available_memory_gb=acc.available_memory() / 1e9,
                summary_rows=len(text.splitlines()), checks=checks)


def public_api_phase(counters, card):
    """Phase 23 (module docstring): parts (a)-(e), each a JSON line with
    its checks and seconds.  Returns {path: launches}."""
    import torch
    paths = {}
    t0 = time.perf_counter()

    def done(part, summary):
        summary["seconds"] = time.perf_counter() - t
        log(f"phase 23 ({part}): {json.dumps(summary, default=str)}")
        if not all(summary["checks"].values()):
            raise RuntimeError(f"phase 23 ({part}) checks: "
                               f"{summary['checks']}")
        gc.collect()
        torch.cuda.empty_cache()

    for part, fn in (("a", _p23_hybrid), ("b", _p23_init_inference),
                     ("c", _p23_lora), ("d", _p23_sparse)):
        t = time.perf_counter()
        summary, launches = fn(counters, card)
        paths.update(launches)
        done(part, summary)
    t = time.perf_counter()
    done("e", _p23_comm(card))
    log(f"phase 23: {time.perf_counter() - t0:.1f} s")
    return paths


# ---------------------------------------------------------------------------
# phase 24: training across four rank processes on the card
# ---------------------------------------------------------------------------

RANK_WORLD = 4
RANK_LAYERS = 2          # of Llama-2-7B's 32: ~0.67 B parameters
RANK_SEQ = 1024
RANK_GAS = 1
RANK_STEPS = 2
RANK_MEMORY_FRACTION = 0.21
RANK_TIMEOUT_S = 400
RANK_BASE = {
    "train_micro_batch_size_per_gpu": 1,
    "gradient_accumulation_steps": RANK_GAS,
    "bf16": {"enabled": True},
    "gradient_clipping": 1.0,
    "optimizer": {"type": "adamw",
                  "params": {"lr": 3e-4, "betas": [0.9, 0.95],
                             "weight_decay": 0.1}},
    "checkpoint": {"async_save": False},
}
#: run -> its zero_optimization (and comm_optimization) sections
RANK_RUNS = {
    "stage0": {"zero_optimization": {"stage": 0}},
    "stage2": {"zero_optimization": {"stage": 2}},
    "stage3": {"zero_optimization": {"stage": 3}},
    "hpz": {"zero_optimization": {"stage": 3, "zero_hpz_partition_size": 2}},
    "mics": {"zero_optimization": {"stage": 3, "mics_shard_size": 2}},
    "stage3_qwz": {"zero_optimization": {"stage": 3,
                                         "zero_quantized_weights": True}},
    "stage2_qgz": {"zero_optimization": {"stage": 2,
                                         "zero_quantized_gradients": True}},
    "comm_ef": {"zero_optimization": {"stage": 2},
                "comm_optimization": {"enabled": True}},
}
#: phase 25: run -> its sections over RANK_BASE.  Each takes the same
#: global batch of RANK_WORLD rows: a batch shard's rows are RANK_WORLD
#: over the mesh's batch shards (data x fsdp)
MP_RUNS = {
    "tp2_sp2": {"train_micro_batch_size_per_gpu": 4,
                "zero_optimization": {"stage": 1},
                "tpu": {"mesh": {"tensor": 2, "seq": 2}}},
    "tp2_sp2_ring": {"train_micro_batch_size_per_gpu": 4,
                     "zero_optimization": {"stage": 1},
                     "sequence_parallel": {"enabled": True, "sp_size": 2,
                                           "mode": "ring"},
                     "tpu": {"mesh": {"tensor": 2}}},
    "tp2_fsdp2": {"train_micro_batch_size_per_gpu": 2,
                  "zero_optimization": {"stage": 3},
                  "tpu": {"mesh": {"tensor": 2, "fsdp": 2}}},
    "tp4": {"train_micro_batch_size_per_gpu": 4,
            "zero_optimization": {"stage": 0},
            "tpu": {"mesh": {"tensor": 4}}},
}
#: the negative controls: run -> (the run it plants a fault in, the
#: fault); phase 25's: a row-parallel output left unsummed over tensor
#: in each run, and seq rank 1's gradient left out of the seq sum
RANK_FAULTS = {"fault_mean": ("stage2", "mean"),
               "fault_skip": ("stage2", "skip")}
MP_FAULTS = {"fault_unsummed": ("tp2_sp2", "unsummed"),
             "fault_seq_skip": ("tp2_sp2", "seq_skip"),
             "fault_unsummed_ring": ("tp2_sp2_ring", "unsummed"),
             "fault_unsummed_fsdp2": ("tp2_fsdp2", "unsummed"),
             "fault_unsummed_tp4": ("tp4", "unsummed")}
#: the runs whose numbers an int8 projection or wire changes
RANK_QUANTIZED = ("stage3_qwz", "stage2_qgz", "comm_ef")
# against the one-rank stage-0 run of the same weights and batch (bf16
# compute; the ranks' GEMMs see one row where the one-rank run sees four,
# so cuBLAS may sum in another order, and the gradients are summed over
# the ranks in bf16 on the wire, as JAX's psum): each step's loss within rtol
# RANK_LOSS_TOL and each leaf's update norm ||m_2 - m_0|| within
# RANK_UPDATE_TOL of the reference's; the quantised runs within the int8
# wire's limit of the JAX package's CPU test (tests/
# test_collective_scheduler.py::test_converges_close_to_fp32_psum_baseline,
# rtol 0.05 on the losses)
RANK_LOSS_TOL = 1e-2
RANK_UPDATE_TOL = 5e-2
RANK_QUANT_LOSS_TOL = 5e-2
RANK_QUANT_UPDATE_TOL = 0.2
# what sees the gradient (AdamW's update is close to lr sign(g) a leaf,
# so its norm hardly does, and the first loss is taken before any
# update): each step's gradient norm before clipping (rtol), and per
# leaf the update u and the first moment m projected on RANK_PROBES
# seeded standard normal directions r (|<r, x> - <r, x_ref>| / |x_ref|,
# which estimates |x - x_ref| / |x_ref|) and the second moment's norm
# (rtol).  The limits are about 3x the largest reading on an H100
# (2.7e-5, 0.052, 0.012, 4.3e-4 in bf16; 9.0e-4, 0.49, 0.10, 6.9e-3 on
# the int8 paths, which read the same in every call), far below the
# planted faults' (0.75 on the gradient norm alone for a mean; 0.099,
# 1.3, 0.72, 0.33 for a rank keeping its own gradient)
RANK_PROBES = 2
RANK_GRAD_TOL = 1e-3
RANK_DIR_TOL = 0.15
RANK_MOMENT_TOL = 4e-2
RANK_V_TOL = 2e-3
RANK_QUANT_GRAD_TOL = 5e-3
RANK_QUANT_DIR_TOL = 0.75
RANK_QUANT_MOMENT_TOL = 0.2
RANK_QUANT_V_TOL = 2e-2
# phase 25's update directions, set by the same rule from its own
# readings on an H100 (0.112-0.166 healthy, the ring's the largest: its
# blocks merge in fp32 in ring order, and the tensor ranks' GEMMs take
# other shapes than one rank's), far below the planted faults' (2.66-3.13
# for a row-parallel output left unsummed in any of the four runs, 1.48
# for a seq rank's gradient left out); its other readings are inside
# phase 24's limits
MP_DIR_TOL = 0.5
#: gloo's all-reduce probe: fp32 elements
RANK_PROBE_ELEMS = 16 * 1024 * 1024


def _rank_batch(vocab):
    import numpy as np
    rng = np.random.default_rng(SEED + 91)
    rows = RANK_GAS * RANK_WORLD
    return {"input_ids": rng.integers(0, vocab, (rows, RANK_SEQ)
                                      ).astype(np.int32)}


def _leaf_probes(engine, init_leaves):
    """Per leaf [|u|^2, <r_k, u>..., |m|^2, <r_k, m>..., |v|^2]: the
    update u = master - initial, AdamW's moments m and v, and
    RANK_PROBES seeded standard normal directions r_k of the whole
    leaf's shape.  Across ranks each rank takes its pieces of u, m, v
    and r_k, and sums the entries over the master's group."""
    import torch
    from deepspeed_tpu_torch import comm
    out = []
    for i, p in enumerate(engine.masters):
        lay = engine._mlayouts[i] if engine._multi else None
        tlay = engine._tlayouts[i] if engine._multi else None

        def piece(x):
            """The rank's piece of a whole leaf: its tensor shard's
            ZeRO chunk."""
            return x if lay is None else lay.shard(tlay.shard(x))
        st = engine.optimizer.state[p]
        u = p.float() - piece(init_leaves[i]).float()
        mom, v = st["exp_avg"].float(), st["exp_avg_sq"].float()
        dots_u, dots_m = [], []
        for k in range(RANK_PROBES):
            gen = torch.Generator(device=p.device)
            gen.manual_seed(SEED + 7919 * i + k)
            r = piece(torch.randn(engine.param_shapes[i], generator=gen,
                                  device=p.device))
            dots_u.append((r * u).sum())
            dots_m.append((r * mom).sum())
            del r
        row = torch.stack([u.square().sum(), *dots_u, mom.square().sum(),
                           *dots_m, v.square().sum()]).double()
        if lay is not None and engine._shard_axes(i):
            row = comm.all_reduce(row, engine.topology.group(
                engine._shard_axes(i)))
        out.append(row.tolist())
        del u
    torch.cuda.synchronize()
    return out


def _probe_errors(probes, ref):
    """(update norm, update direction, first moment, second moment)
    errors, each the largest over the leaves, against the reference's
    probes (``_leaf_probes``)."""
    k = RANK_PROBES
    norm = direction = moment = second = 0.0
    #: each leaf's update-direction error (the noisiest reading)
    per_leaf = []
    for got, want in zip(probes, ref):
        u, m, v = math.sqrt(want[0]), math.sqrt(want[k + 1]), math.sqrt(
            want[2 * k + 2])
        norm = max(norm, abs(math.sqrt(got[0]) - u) / max(u, 1e-30))
        per_leaf.append(max(abs(got[1 + j] - want[1 + j])
                            for j in range(k)) / max(u, 1e-30))
        direction = max(direction, per_leaf[-1])
        moment = max(moment, max(
            abs(got[k + 2 + j] - want[k + 2 + j]) for j in range(k))
            / max(m, 1e-30))
        second = max(second, abs(math.sqrt(got[2 * k + 2]) - v)
                     / max(v, 1e-30))
    return dict(update_norm=norm, update_direction=direction,
                first_moment=moment, second_moment=second,
                direction_by_leaf=per_leaf)


def _plant(engine, kind):
    """A planted fault, a negative control of phase 24's and 25's checks
    (returns what undoes it): ``mean`` divides every reduced piece by
    the world size (a mean where the engine sums); ``skip`` makes rank 1
    keep its own gradient piece (it still joins the collective, so the
    ranks stay in step); ``unsummed`` leaves every row-parallel output
    (``attn.wo``, ``mlp.wo``) unsummed over tensor; ``seq_skip`` sends
    zeros for seq rank 1's gradients into the reduction over the seq
    (and batch) ranks."""
    import torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel import tensor_parallel as TP
    reduce = engine._reduce_full
    world, rank = comm.get_world_size(), comm.get_rank()
    if kind == "unsummed":
        kept = TP.row_parallel

        def unsummed(a, w, mp, n_in=1):
            """This rank's partial product alone."""
            k = math.prod(w.shape[:n_in])
            out = a.reshape(-1, k) @ w.reshape(k, -1)
            return out.reshape(a.shape[:a.dim() - n_in] + w.shape[n_in:])
        TP.row_parallel = unsummed

        def undo():
            TP.row_parallel = kept
        return undo
    if kind == "seq_skip":
        seq = engine.topology.coords["seq"]
        engine._reduce_full = lambda i, g: reduce(
            i, torch.zeros_like(g) if seq == 1 else g)
        return lambda: None

    class Planted:
        def __init__(self, red, own):
            self.red, self.own = red, own

        def wait(self):
            out = self.red.wait()
            if kind == "mean":
                return out / world
            return self.own if rank == 1 else out

    def planted(i, g):
        return Planted(reduce(i, g),
                       engine._mlayouts[i].shard(g).contiguous())
    engine._reduce_full = planted
    return lambda: None


def _rank_state_bytes(engine):
    """A rank's training state: masters, optimizer moments, gradient
    accumulators, and the compute copy a step builds where it does not
    share a master's storage (bf16 whole leaves below stage 3; at stage
    3 the fp32 pieces, the master itself where the layouts agree and no
    qwZ projection makes a new one)."""
    import math as _math
    import torch

    def nbytes(t):
        return t.numel() * t.element_size()
    masters = sum(nbytes(m) for m in engine.masters)
    moments = sum(nbytes(v) for st in engine.optimizer.state.values()
                  for v in st.values()
                  if isinstance(v, torch.Tensor) and v.dim())
    grads = sum(nbytes(g) for g in engine._grads)
    compute = 0
    qwz = engine.config.quantized_weights
    # masters and moments by the layouts: fp32 master and two moments of
    # each leaf's tensor shard's ZeRO chunk
    share = 0
    for shape, play, mlay in zip(engine._local_shapes, engine._playouts,
                                 engine._mlayouts):
        if not engine._pieces:
            compute += 2 * _math.prod(shape)
        elif play != mlay or (qwz and len(shape) >= 2):
            compute += 4 * _math.prod(play.local_shape(shape))
        share += 12 * _math.prod(mlay.local_shape(shape))
    return dict(masters=masters, moments=moments, grads=grads,
                compute=compute, state=masters + moments, layout=share)


def _rank_run(name, counters, batch, captured):
    """One run on this rank: build, RANK_STEPS steps (the counted main
    path), then the checks' numbers."""
    import torch
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    from deepspeed_tpu_torch.tree import tree_leaves
    from deepspeed_tpu_torch import comm
    base, fault = {**RANK_FAULTS, **MP_FAULTS}.get(name, (name, None))
    config = {**RANK_BASE, **{**RANK_RUNS, **MP_RUNS}[base]}
    if base in MP_RUNS:
        # the bytes each collective moves, by op and by mesh axis
        config["comms_logger"] = {"enabled": True}
    model = LlamaForCausalLM("7b", num_layers=RANK_LAYERS)
    t = time.perf_counter()
    engine, *_ = dtt.initialize(model=model, config=config)
    undo = _plant(engine, fault) if fault is not None else None
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    captured.clear()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(counters)
    comms = comm.get_comms_logger()
    if comms is not None:
        comms.reset()
    steps = []
    for _ in range(RANK_STEPS):
        t = time.perf_counter()
        loss = engine.train_batch(batch)
        torch.cuda.synchronize()
        steps.append(dict(ms=(time.perf_counter() - t) * 1e3, loss=loss,
                          grad_norm=engine.get_global_grad_norm()))
    launches = read_launches(counters)
    if undo is not None:
        undo()
    step_bytes = None
    if base in MP_RUNS:
        # a step's bytes into the collectives: the model-parallel ones by
        # axis, the gradient reduction's (reduce-scatters and
        # all-reduces: the loss and norm scalars are a few bytes of it)
        grad = sum(size * count[0] for op in ("all_reduce", "reduce_scatter")
                   for size, count in comms.comms_dict.get(op, {}).items())
        step_bytes = dict(tensor=comms.axis_bytes.get("tensor", 0),
                          seq=comms.axis_bytes.get("seq", 0),
                          grad_reduction=grad)
        step_bytes = {k: v / RANK_STEPS for k, v in step_bytes.items()}
    peak = torch.cuda.max_memory_allocated()
    state = _rank_state_bytes(engine)
    init = tree_leaves(model.init_params(0, engine.device))
    probes = _leaf_probes(engine, init)
    del init
    sched = engine.comm_scheduler
    out = dict(
        run=name, mesh=dict(zip(("pipe", "data", "expert", "fsdp", "hpz",
                                 "seq", "tensor"), engine.topology.shape)),
        build_s=build_s, steps=steps, peak_bytes=peak,
        state_bytes=state, probes=probes, launches=launches,
        step_bytes=step_bytes, sp_mode=engine.module.cfg.sp_mode,
        paths=list(engine.param_paths),
        seq_index=engine.topology.coords["seq"],
        n_leaves=len(engine.masters),
        n_two_dim=sum(len(s) >= 2 for s in engine.param_shapes),
        buckets=(sched.stats(RANK_GAS) if sched is not None else None))
    if captured:
        out["bucket_check"] = _bucket_kernel_check(captured[0])
    engine.destroy()
    return out


def _bucket_kernel_check(x):
    """Rank 0's first bucket through the quantise and dequantise kernels
    against their plain versions: codes, scales and values bit-equal."""
    import torch
    from deepspeed_tpu_torch.ops import quantization as Q
    q, s, pad = Q.quantize_blockwise(x)
    qr, sr, padr = Q.quantize_blockwise_reference(x)
    d = Q.dequantize_blockwise(q, s, pad, x.shape)
    dr = Q.dequantize_blockwise_reference(q, s, pad, x.shape)
    torch.cuda.synchronize()
    return dict(elems=x.numel(), codes_equal=bool(torch.equal(q, qr)),
                scales_equal=bool(torch.equal(s, sr)) and pad == padr,
                values_equal=bool(torch.equal(d, dr)))


def _gloo_probe():
    """gloo's all-reduce of RANK_PROBE_ELEMS fp32 on the card between the
    ranks: ms a call and the bus rate (2 (n-1)/n of the bytes a rank
    sends), a property of the host transport."""
    import torch
    from deepspeed_tpu_torch import comm
    x = torch.ones(RANK_PROBE_ELEMS, device="cuda")
    comm.all_reduce(x)
    torch.cuda.synchronize()
    comm.barrier()
    t = time.perf_counter()
    for _ in range(3):
        comm.all_reduce(x)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / 3
    n = comm.get_world_size()
    busbw = x.numel() * 4 * 2 * (n - 1) / n / (ms / 1e3) / 1e9
    return dict(elems=x.numel(), ms=ms, bus_gb_s=busbw)


def ranks_worker(plan_path) -> int:
    """A rank process of phase 24 (``chip_smoke.py --ranks-plan <json>``,
    started by ``deepspeed_tpu_torch.launcher.launch``): join over gloo,
    load the kernels phase 2 built, run every run in order and write
    ``rank<r>.json``."""
    import torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.ops import kernel_loader
    from deepspeed_tpu_torch.runtime.comm import collective_scheduler as CS
    with open(plan_path) as f:
        plan = json.load(f)
    comm.init_distributed(dist_backend="gloo", timeout=300)
    torch.cuda.set_per_process_memory_fraction(RANK_MEMORY_FRACTION)
    kernel_loader.set_library_dir(plan["library_dir"])
    rank = comm.get_rank()
    counters = kernel_counters()
    for k, _ in counters.values():
        # load what phase 2 built: four ranks never run nvcc at once
        if not k.library_path.exists():
            raise RuntimeError(f"{k.library_path} is missing: phase 2 "
                               "builds the libraries the ranks load")
        k.lib()
    batch = _rank_batch(32000)
    captured = []
    wire_fn = CS.quantized_allreduce_ef

    def capture(x, *a, **kw):
        if rank == 0 and not captured:
            captured.append(x.detach().float().clone())
        return wire_fn(x, *a, **kw)
    CS.quantized_allreduce_ef = capture
    out = {"rank": rank, "device": torch.cuda.current_device(),
           "probe": _gloo_probe(), "runs": {}}
    if rank == 0:
        log(f"phase 24 rank 0: probe {json.dumps(out['probe'])}")
    for name in plan["runs"]:
        t = time.perf_counter()
        out["runs"][name] = _rank_run(name, counters, batch, captured)
        torch.cuda.empty_cache()
        # written after every run: a run cut by the time limit leaves the
        # earlier ones readable
        with open(os.path.join(plan["out"], f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        if rank == 0:
            run = out["runs"][name]
            log(f"{_rank_phase(name)} rank 0: {name} "
                f"{time.perf_counter() - t:.1f} s, "
                f"build {run['build_s']:.1f} s, steps "
                f"{[round(st['ms']) for st in run['steps']]} ms")
    comm.barrier()
    comm.destroy_process_group()
    return 0


def _rank_reference(batch):
    """The one-rank stage-0 run of the same weights and global batch
    (four rows a micro-batch): losses, gradient norms and each leaf's
    probes."""
    import torch
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    from deepspeed_tpu_torch.tree import tree_leaves
    config = dict(RANK_BASE, train_micro_batch_size_per_gpu=RANK_WORLD)
    model = LlamaForCausalLM("7b", num_layers=RANK_LAYERS)
    engine, *_ = dtt.initialize(model=model, config=config)
    steps = []
    for _ in range(RANK_STEPS):
        t = time.perf_counter()
        loss = engine.train_batch(batch)
        torch.cuda.synchronize()
        steps.append(dict(ms=(time.perf_counter() - t) * 1e3, loss=loss,
                          grad_norm=engine.get_global_grad_norm()))
    init = tree_leaves(model.init_params(0, engine.device))
    probes = _leaf_probes(engine, init)
    n_params = sum(m.numel() for m in engine.masters)
    del init
    engine.destroy()
    return dict(steps=steps, probes=probes, params=n_params)


def _rank_expected(res, name, world):
    """The launches a rank's run must show: the flash forward at least
    twice over the layers a micro-batch (remat recomputes it), the two
    backward kernels once, AdamW once a
    leaf a step, qwZ a quantise and a dequantise a leaf of two or more
    dims a step, the int8 wire 2 quantises and 2 + world dequantises a
    bucket a reduction."""
    L, mb = RANK_LAYERS, RANK_STEPS * RANK_GAS
    if res["mesh"]["seq"] > 1 and res["sp_mode"] == "ring":
        # the ring's blocks through the flash pair: seq rank s sees s + 1
        # blocks under the causal mask
        L *= res["seq_index"] + 1
    q = dq = 0
    if name == "stage3_qwz":
        q = dq = res["n_two_dim"] * RANK_STEPS
    if res["buckets"] is not None:
        rounds = res["buckets"]["bucket_count"] * RANK_STEPS * (
            RANK_GAS if res["buckets"]["overlap"] else 1)
        q, dq = 2 * rounds, (2 + world) * rounds
    return {"flash_fwd": 2 * L * mb, "flash_bwd_dkv": L * mb,
            "flash_bwd_dq": L * mb,
            "fused_adamw": res["n_leaves"] * RANK_STEPS,
            "quantize": q, "dequantize": dq}


def _rank_checks(name, runs, ref, stage0):
    """Phase 24's checks of one run (``runs``: every rank's), and the
    readings they compare."""
    quant = name in RANK_QUANTIZED
    base = {**RANK_FAULTS, **MP_FAULTS}.get(name, (name,))[0]
    loss_tol = RANK_QUANT_LOSS_TOL if quant else RANK_LOSS_TOL
    upd_tol = RANK_QUANT_UPDATE_TOL if quant else RANK_UPDATE_TOL
    grad_tol = RANK_QUANT_GRAD_TOL if quant else RANK_GRAD_TOL
    dir_tol = (RANK_QUANT_DIR_TOL if quant else
               MP_DIR_TOL if base in MP_RUNS else RANK_DIR_TOL)
    mom_tol = RANK_QUANT_MOMENT_TOL if quant else RANK_MOMENT_TOL
    v_tol = RANK_QUANT_V_TOL if quant else RANK_V_TOL
    losses = [st["loss"] for st in runs[0]["steps"]]
    ref_losses = [st["loss"] for st in ref["steps"]]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    grad_err = max(abs(st["grad_norm"] - rs["grad_norm"]) / rs["grad_norm"]
                   for st, rs in zip(runs[0]["steps"], ref["steps"]))
    errs = _probe_errors(runs[0]["probes"], ref["probes"])
    by_leaf = dict(zip(runs[0]["paths"], errs.pop("direction_by_leaf")))
    want = _rank_expected(runs[0], name, RANK_WORLD)
    wants = [_rank_expected(run, name, RANK_WORLD) for run in runs]
    launches = {k: sum(run["launches"][k] for run in runs)
                for k in runs[0]["launches"]}
    # what sees the gradient: the checks a planted fault must fail
    gradient = {
        f"gradient norms within {grad_tol} of one rank": grad_err <= grad_tol,
        f"update directions within {dir_tol} of one rank":
            errs["update_direction"] <= dir_tol,
        f"first moments within {mom_tol} of one rank":
            errs["first_moment"] <= mom_tol,
        f"second moments within {v_tol} of one rank":
            errs["second_moment"] <= v_tol,
    }
    checks = {
        "every rank's losses equal": all(
            [st["loss"] for st in run["steps"]] == losses for run in runs),
        "probes equal on every rank": all(
            run["probes"] == runs[0]["probes"] for run in runs),
        "finite": all(math.isfinite(x) for x in losses),
        f"losses within {loss_tol} of one rank": loss_err <= loss_tol,
        f"update norms within {upd_tol} of one rank":
            errs["update_norm"] <= upd_tol,
        **gradient,
        "launches per rank": all(
            (run["launches"][k] >= v if k == "flash_fwd"
             else run["launches"][k] == v)
            for run, w in zip(runs, wants) for k, v in w.items()),
        "no serving kernel": all(launches[k] == 0 for k in (
            "paged_attention", "paged_attention_int8", "rmsnorm",
            "layernorm", "fused_lion", "fused_lamb")),
    }
    state = runs[0]["state_bytes"]
    mesh = runs[0]["mesh"]
    if base in MP_RUNS:
        # masters and moments: each leaf's tensor shard's ZeRO chunk
        # (fp32, three copies), on every rank
        checks["state the tensor-and-ZeRO share"] = all(
            0.98 <= run["state_bytes"]["state"]
            / run["state_bytes"]["layout"] <= 1.02 for run in runs)
        checks["state below stage 0's"] = all(
            run["state_bytes"]["state"] < stage0["state"] for run in runs)
    elif base != "stage0":
        # masters and moments: one piece of fsdp x hpz (1/4; MiCS 1/2)
        shards = mesh["fsdp"] * mesh["hpz"]
        ratio = state["state"] * shards / stage0["state"]
        checks[f"state 1/{shards} of stage 0's"] = 0.98 <= ratio <= 1.02
    if base.startswith("stage3") or base in ("hpz", "mics"):
        # the weights a rank holds: the master piece, and the compute
        # piece (fp32, over hpz alone under hpZ) where it is not the
        # master's own storage; stage 0 holds the fp32 masters whole
        pieces = mesh["hpz"] if mesh["hpz"] > 1 else mesh["fsdp"]
        held = state["masters"] + state["compute"]
        checks["weights held at stage 3"] = held <= (
            stage0["masters"] * (1 / shards + 1 / pieces) * 1.02)
    if "bucket_check" in runs[0]:
        bc = runs[0]["bucket_check"]
        checks["bucket kernels bit-equal"] = (
            bc["codes_equal"] and bc["scales_equal"] and bc["values_equal"])
    readings = dict(losses=losses, ref_losses=ref_losses,
                    loss_rel_err=loss_err, grad_norm_rel_err=grad_err,
                    grad_norms=[st["grad_norm"] for st in runs[0]["steps"]],
                    ref_grad_norms=[st["grad_norm"] for st in ref["steps"]],
                    **{f"{k}_err": v for k, v in errs.items()},
                    direction_by_leaf=by_leaf)
    return checks, gradient, readings, launches, want


def _rank_phase(name):
    """The phase a rank run reports under: 25 for tensor and sequence
    parallelism (MP_RUNS and their faults), else 24."""
    base = {**RANK_FAULTS, **MP_FAULTS}.get(name, (name,))[0]
    return "phase 25" if base in MP_RUNS else "phase 24"


def ranks_phase(counters, card, cache_dir):
    """Phases 24 and 25 (module docstring), in one launch of the rank
    processes.  Returns {path: launches}, each run's launches summed over
    the ranks (the planted faults, run last, are no main path)."""
    import tempfile
    import torch
    t0 = time.perf_counter()
    batch = _rank_batch(32000)
    ref = _rank_reference(batch)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 24 (reference): one rank, stage 0: "
        f"{json.dumps(ref['steps'])}")
    from deepspeed_tpu_torch.launcher.launch import free_port
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="ranks_",
                               dir=os.path.join(root, "build"))
    names = (list(RANK_RUNS) + list(MP_RUNS) + list(RANK_FAULTS)
             + list(MP_FAULTS))
    plan = {"runs": names, "out": out_dir, "library_dir": cache_dir}
    plan_path = os.path.join(out_dir, "plan.json")
    with open(plan_path, "w") as f:
        json.dump(plan, f)
    cmd = [sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch",
           f"--num_gpus={RANK_WORLD}", f"--master_port={free_port()}",
           f"--timeout={RANK_TIMEOUT_S}", os.path.abspath(__file__), "--",
           "--ranks-plan", plan_path]
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=root,
                          timeout=RANK_TIMEOUT_S + 60)
    launch_s = time.perf_counter() - t
    log(proc.stdout[-6000:])
    if proc.returncode != 0:
        log(proc.stderr[-8000:])
        raise RuntimeError(f"phase 24: the ranks exited {proc.returncode}")
    ranks = []
    for r in range(RANK_WORLD):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    paths = {}
    stage0 = ranks[0]["runs"]["stage0"]["state_bytes"]
    failed = []
    for name in names:
        runs = [rk["runs"][name] for rk in ranks]
        checks, gradient, readings, launches, want = _rank_checks(
            name, runs, ref, stage0)
        state = runs[0]["state_bytes"]
        phase = _rank_phase(name)
        summary = dict(
            run=name, card=card, mesh=runs[0]["mesh"], **readings,
            step_ms=[[st["ms"] for st in run["steps"]] for run in runs],
            build_s=[run["build_s"] for run in runs],
            peak_gb=[run["peak_bytes"] / 1e9 for run in runs],
            state_gb={k: v / 1e9 for k, v in state.items()},
            launches_rank0=runs[0]["launches"], expected=want,
            buckets=(None if runs[0]["buckets"] is None else {
                k: runs[0]["buckets"][k] for k in (
                    "bucket_count", "comm_bytes_per_step",
                    "comm_fp32_equiv_bytes_per_step", "overlap",
                    "error_feedback")}),
            bucket_check=runs[0].get("bucket_check"), checks=checks)
        if runs[0]["step_bytes"] is not None:
            summary["step_bytes"] = [run["step_bytes"] for run in runs]
        log(f"{phase} ({name}): {json.dumps(summary)}")
        if name in RANK_FAULTS or name in MP_FAULTS:
            # a negative control: some gradient check must catch it
            if all(gradient.values()):
                failed.append(name)
            continue
        paths[("mp_" if phase == "phase 25" else "ranks_") + name] = launches
        if not all(checks.values()):
            failed.append(name)
    log(f"phase 24 (transport): {json.dumps(dict(card=card, ranks=RANK_WORLD, launch_s=launch_s, probe=ranks[0]['probe'], devices=[rk['device'] for rk in ranks], reference_params=ref['params']))}")
    if failed:
        raise RuntimeError(f"phases 24-25 checks failed: {failed}")
    log(f"phases 24-25: {time.perf_counter() - t0:.1f} s")
    return paths


def main() -> int:
    import torch
    if "--ranks-plan" in sys.argv:
        # a rank process of phase 24
        return ranks_worker(sys.argv[sys.argv.index("--ranks-plan") + 1])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; the port's smoke test "
              "runs on the GPU only", file=sys.stderr)
        return 2
    t_main = time.perf_counter()

    def clock(phase):
        log(f"{phase} done at {time.perf_counter() - t_main:.1f} s")

    # phase 1
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    dev = torch.device("cuda")

    clock("phase 1")
    # phase 2
    from deepspeed_tpu_torch.checkpoint.hf import opt_config_from_hf
    from deepspeed_tpu_torch.models.llama import llama_config
    from deepspeed_tpu_torch.ops import flash_attention as FA
    from deepspeed_tpu_torch.ops import fp_quantizer as FQ
    from deepspeed_tpu_torch.ops import fused_optimizer as FO
    from deepspeed_tpu_torch.ops import kernel_loader
    from deepspeed_tpu_torch.ops import normalization as N
    from deepspeed_tpu_torch.ops import paged_attention as PA
    from deepspeed_tpu_torch.ops import quantization as Q
    # kernel -> its library and entry points (kernel_counters), its source
    # and the TPU kernel it replaces
    counters = kernel_counters()
    replaces = {
        "paged_attention": "deepspeed_tpu/ops/paged_attention.py:240",
        "paged_attention_int8": "deepspeed_tpu/ops/paged_attention.py:240",
        "rmsnorm": "deepspeed_tpu/ops/normalization.py:20",
        "rmsnorm_res": "deepspeed_tpu/ops/normalization.py:27",
        "layernorm": "deepspeed_tpu/ops/normalization.py:35",
        "flash_fwd": "deepspeed_tpu/ops/flash_attention.py:79",
        "flash_bwd": "deepspeed_tpu/ops/flash_attention.py:164",
        "flash_bwd_dkv": "deepspeed_tpu/ops/flash_attention.py:164",
        "flash_bwd_dq": "deepspeed_tpu/ops/flash_attention.py:214",
        "fused_adamw": "deepspeed_tpu/ops/fused_optimizer.py:29",
        "quantize": "deepspeed_tpu/ops/quantization.py:31",
        "dequantize": "deepspeed_tpu/ops/quantization.py:40",
        "fused_lion": "deepspeed_tpu/ops/fused_optimizer.py:91",
        "fused_lamb": "deepspeed_tpu/ops/fused_optimizer.py:183",
        # no pl.pallas_call: XLA fuses this jnp function into the einsum
        "fp_dequant": "deepspeed_tpu/models/transformer.py:233"}
    libraries = list({id(k): k for k, _ in counters.values()}.values())
    # the libraries go to the serving compile cache's directory, which a
    # second process (the graph-warmth phase) loads them from
    from deepspeed_tpu_torch.inference.v2 import compile_cache
    cache_dir = compile_cache.enable_compile_cache(str(
        kernel_loader.BUILD_DIR.parent / "compile_cache"))
    if cache_dir is None:
        raise RuntimeError("the compile cache directory is not writable")
    t = time.perf_counter()
    build_logs = kernel_loader.build_all(libraries)
    for k in libraries:
        k.lib()
    log(f"build: {time.perf_counter() - t:.1f} s "
        f"({', '.join(k.library_path.name for k in libraries)})")
    for k, text in zip(libraries, build_logs):
        kernels = ptxas_kernels(text, kernel_loader._nvcc())
        regs = sorted({v["registers"] for v in kernels.values()})
        spills = {name: v for name, v in kernels.items()
                  if v["spill_stores"] or v["spill_loads"]}
        log(f"ptxas {k.name}: {len(kernels)} kernels, registers {regs}, "
            f"spills: {json.dumps(spills) if spills else 'none'}")
        if spills:
            raise RuntimeError(f"{k.name}: {len(spills)} kernels spill "
                               f"registers: {sorted(spills)}")
        if k in (PA.KERNEL, FA.KERNEL, FA.BWD_KERNEL):
            log(f"ptxas {k.name} by kernel: {json.dumps(kernels)}")
        # ptxas says when it had to serialise the asynchronous wgmma
        for ln in text.splitlines():
            if "wgmma" in ln:
                log(f"ptxas {k.name}: {ln.strip()}")

    clock("phase 2")
    # phase 3 (the serving kernels also at the Q tops 6g's mined lattice
    # fits to its prompt lengths: S * Q rows for the norms)
    train_cfg = llama_config("7b", num_layers=TRAIN_LAYERS)
    mined_q = mined_q_tops(llama_config("7b"))
    log(f"mined Q tops of 6g's traffic: {mined_q}")
    quant_rows, dequant_rows = check_quantization(dev, train_cfg)
    checks = {"paged_attention": check_paged(dev, mined_q=mined_q),
              "paged_attention_int8": check_paged(dev, int8=True,
                                                  mined_q=mined_q),
              "rmsnorm": check_rmsnorm(dev, mined_q=mined_q),
              "rmsnorm_res": check_rmsnorm_res(dev),
              "layernorm": check_layernorm(dev, mined_q=mined_q),
              "flash_fwd": check_flash(dev, mined_q=mined_q),
              "flash_bwd": check_flash_bwd(dev),
              "fused_adamw": check_adamw(dev, train_cfg),
              "quantize": quant_rows, "dequantize": dequant_rows,
              "fused_lion": check_lion(dev, train_cfg),
              "fused_lamb": check_lamb(dev, train_cfg),
              "fp_dequant": check_fp_dequant(dev)}
    for name, rows in checks.items():
        for r in rows:
            lib = (f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None
                   else "null")
            log(f"kernel {name} [{r['shape']}]: rms_rel_err "
                f"{r['rms_rel_err']:.3e} (tol {RMS_REL_TOL}), max_rel_err "
                f"{r['max_rel_err']:.3e} (tol {MAX_REL_TOL}), max_abs_err "
                f"{r['max_abs_err']:.3e}; kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, library {lib}, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
                + (f", whole LAMB step {r['step_ms']:.4f} ms"
                   if "step_ms" in r else "")
                + "".join(f", {fn} {part['ms']:.4f} ms (bound "
                          f"{part['bound_ms']:.4f} ms, {part['bound_by']})"
                          for fn, part in r.get("parts", {}).items())
                + (f"; host_us kernel {r['host_us']:.2f}, library "
                   f"{r['library_host_us']:.2f}; device_us kernel "
                   f"{r['device_us']:.3f}, library "
                   f"{r['library_device_us']:.3f} "
                   f"({r['library_kernels_per_call']:g} kernels a call)"
                   if "host_us" in r else "")
                + ("; host_us by part " + ", ".join(
                    f"{k} {v:.2f}" for k, v in r["host_parts_us"].items())
                   if "host_parts_us" in r else ""))
            rel = [(r[k], RMS_REL_TOL) for k in r if k.endswith("rms_rel_err")]
            rel += [(r[k], MAX_REL_TOL) for k in r if k.endswith("max_rel_err")]
            if name in PATH_OPTIMIZER.values():
                rel.append((r["max_rel_err"], OPT_MAX_REL_TOL))
            if not all(err <= tol for err, tol in rel):
                raise RuntimeError(f"{name} kernel disagrees with its plain "
                                   f"version at [{r['shape']}]: {r}")
    clock("phase 3")
    # phase 4
    from deepspeed_tpu_torch.models.transformer import init_params
    cfg = llama_config("7b")
    t = time.perf_counter()
    params = init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"Llama-2-7B params: {cfg.n_params() / 1e9:.2f} B, bf16 init "
        f"{time.perf_counter() - t:.1f} s")
    llama_summary, llama_launches, engine, reqs, llama_tokens = serve(
        cfg, params, counters, card)

    clock("phase 4")
    # phase 5: graph against eager at one decode key
    graph_vs_eager(engine, reqs, "llama")

    clock("phase 5")
    # phase 6: prefix caching at full width
    prefix_phase(engine, cfg, counters, card)
    launches_by_path = {"serving_llama": llama_launches}

    clock("phase 6")
    # phase 6a: preemption on a 48-page pool, held to a 256-page engine,
    # both at SERVING_CUT_LAYERS of the 32 layers (phase 24's room)
    cut_cfg, cut_params = depth_cut(cfg, params, SERVING_CUT_LAYERS)
    cut_engine = build_engine(cut_cfg, cut_params, num_pages=256)
    _, launches_by_path["serving_llama_preemption"] = preemption_phase(
        cut_cfg, cut_params, counters, card, cut_engine)
    del cut_engine
    gc.collect()
    torch.cuda.empty_cache()

    clock("phase 6a")
    # phase 6b: the split step, each flag, held to the fused engine
    for path, flags in (("serving_llama_split_fused_step",
                         dict(fused_step=False)),
                        ("serving_llama_split_on_device_sampling",
                         dict(on_device_sampling=False))):
        _, launches_by_path[path] = split_phase(
            cfg, params, counters, card, engine, llama_tokens, llama_summary,
            flags)
        gc.collect()
        torch.cuda.empty_cache()
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    clock("phase 6b")
    # phase 6c: a pool sized from free device memory, then the target and
    # draft pools of a self-drafting engine sized together
    _, launches_by_path["serving_llama_pool_sized"] = sizing_phase(
        cfg, params, counters, card, reqs)
    gc.collect()
    torch.cuda.empty_cache()
    _, launches_by_path["serving_llama_pool_sized_draft"] = sizing_phase(
        cfg, params, counters, card, reqs, speculative=True,
        spec_drafter="model")
    gc.collect()
    torch.cuda.empty_cache()

    clock("phase 6c")
    # phases 6d-6h at SERVING_CUT_LAYERS of the 32 layers (cut_params)
    # phase 6d: speculative decoding with the three drafters
    _, spec_launches = spec_phase(cut_cfg, cut_params, counters, card,
                                  llama_summary)
    launches_by_path.update(spec_launches)

    clock("phase 6d")
    # phase 6e: keyed sampling at full width
    _, launches_by_path["serving_llama_keyed"] = keyed_phase(
        cut_cfg, cut_params, counters, card, llama_summary)

    clock("phase 6e")
    # phase 6f: snapshot and restore into a second engine
    _, launches_by_path["serving_llama_snapshot"] = snapshot_phase(
        cut_cfg, cut_params, counters, card)

    clock("phase 6f")
    # phase 6g: a mined bucket lattice against the power-of-two lattice
    _, launches_by_path["serving_llama_mined_lattice"] = lattice_phase(
        cut_cfg, cut_params, counters, card)

    clock("phase 6g")
    # phase 6h: the host/disk page tier (bf16 pages)
    _, launches_by_path["serving_llama_tier"] = tier_phase(
        cut_cfg, cut_params, counters, card)
    del cut_params

    clock("phase 6h")
    # phase 6i: graph warmth, a second process loads phase 2's libraries
    warmth_phase(cache_dir, card)

    clock("phase 6i")
    # phase 6j: a replica pool of two engines; 6k: disaggregated
    # prefill/decode engines
    gc.collect()
    torch.cuda.empty_cache()
    fleet_cfg, fleet_params = depth_cut(cfg, params, FLEET_LAYERS)
    _, launches_by_path["serving_llama_pool"] = pool_phase(
        fleet_cfg, fleet_params, counters, card, llama_summary)
    _, launches_by_path["serving_llama_disagg"] = disagg_phase(
        fleet_cfg, fleet_params, counters, card, llama_summary)
    del fleet_params

    clock("phases 6j-6k")
    # phase 6l: the fleet's subprocess mode (two replica processes on the
    # card), then telemetry's cost on phase 4's traffic in this process
    gc.collect()
    torch.cuda.empty_cache()
    _, fleet_launches = fleet_proc_phase(counters, card, cache_dir)
    for label, launches in fleet_launches.items():
        launches_by_path[f"serving_llama_fleet_{label}"] = launches
    _, launches_by_path["serving_llama_telemetry"] = telemetry_cost_phase(
        cfg, params, counters, card)

    clock("phase 6l")
    # phase 7
    plain_vs_kernel(cfg, params)

    clock("phase 7")
    # phase 8: the Llama weights and caches go first
    del params
    gc.collect()
    torch.cuda.empty_cache()
    opt_cfg = opt_config_from_hf(types.SimpleNamespace(**OPT_6_7B))
    t = time.perf_counter()
    opt_params = randomize_norms_and_biases(
        init_params(opt_cfg, seed=SEED, device="cuda"), SEED + 8)
    torch.cuda.synchronize()
    log(f"OPT-6.7B params: {opt_cfg.n_params() / 1e9:.2f} B, "
        f"{opt_cfg.num_layers} layers, bf16 init "
        f"{time.perf_counter() - t:.1f} s")
    _, opt_launches, engine, _, _ = serve(opt_cfg, opt_params, counters, card,
                                       model_type="opt",
                                       kv_quantization="int8")
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    clock("phase 8")
    # phase 8a: int8 pages through the host/disk tier
    _, launches_by_path["serving_opt_tier"] = tier_phase(
        opt_cfg, opt_params, counters, card, label="opt int8",
        model_type="opt", kv_quantization="int8", num_pages=24, host=8,
        disk=16, n=6, prefix=512, suffix=32, new_tokens=16)

    clock("phase 8a")
    # phase 9
    plain_vs_kernel(opt_cfg, opt_params, model_type="opt",
                    kv_quantization="int8")

    clock("phase 9")
    # phase 9a: Mistral-7B-v0.1 and its sliding window, once the OPT
    # weights are gone
    del opt_params
    gc.collect()
    torch.cuda.empty_cache()
    launches_by_path["serving_opt"] = opt_launches
    _, launches_by_path["serving_mistral"] = mistral_phase(counters, card)
    gc.collect()
    torch.cuda.empty_cache()

    clock("phase 9a")
    # phases 9b-9d: Falcon-7B (head_dim 64, multi-query; bf16 then int8
    # pages; at FALCON_SERVING_LAYERS of its 32 layers, phase 22's room),
    # Phi-2 (80, partial rotary), Phi-3-mini-4k (96, a 2047-token window)
    # at their published widths and SERVING_CUT_LAYERS of their 32
    # layers (phase 24's room)
    from deepspeed_tpu_torch.checkpoint import hf as HF
    for label, model_type, convert, name, seed, int8, layers in (
            ("Falcon-7B", "falcon", HF.falcon_config_from_hf,
             "tiiuae/falcon-7b", SEED + 21, True, FALCON_SERVING_LAYERS),
            ("Phi-2", "phi", HF.phi_config_from_hf, "microsoft/phi-2",
             SEED + 23, False, SERVING_CUT_LAYERS),
            ("Phi-3-mini-4k", "phi3", HF.phi3_config_from_hf,
             "microsoft/Phi-3-mini-4k-instruct", SEED + 25, False,
             SERVING_CUT_LAYERS)):
        paths, _ = hf_family_phase(counters, card, label, model_type,
                                   convert, HF.PUBLISHED_CONFIGS[name],
                                   seed, int8=int8, layers=layers)
        launches_by_path.update(paths)

    clock("phases 9b-9d")
    # phase 9e: Mixtral-8x7B, bf16 at 4 layers, then fp8 weights at 32
    paths, _ = mixtral_phase(counters, card)
    launches_by_path.update(paths)

    clock("phase 9e")
    # phase 10: the serving weights and caches are gone
    engine, batch, launches_by_path["training"] = train(counters, card)

    clock("phase 10")
    # phase 11
    train_kernel_vs_plain(engine, batch)

    clock("phase 11")
    # phases 12 and 13: each engine goes before the next is built
    for path in ("training_lion_qwz", "training_lamb"):
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        engine, batch, launches_by_path[path] = train(
            counters, card, path, layers=OPTIMIZER_PATH_LAYERS)
        if engine.config.quantized_weights:
            qwz_kernel_vs_plain(engine, batch)
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    clock("phases 12-13")
    # phases 14-17: GPT-1.3B and Phi-2 at full width and depth, Falcon-7B
    # at 4 and Phi-3-mini at 8 of 32 layers; phase 18: BERT-large MLM
    # through the data loader
    family_launches, _ = families_phase(counters, card)
    launches_by_path.update(family_launches)
    launches_by_path["training_bert_large"], _ = bert_phase(counters, card)
    # the head dim each training path gives the flash backward
    path_head_dim = {path: family_config(source, layers).dims_per_head
                     for _, path, source, layers, *_ in FAMILY_PATHS}
    path_head_dim.update({path: train_cfg.dims_per_head
                          for path in TRAIN_PATHS})

    clock("phases 14-18")
    # phase 19: checkpoints and self-healing at 1 layer
    ckpt_launches, _ = checkpoint_phase(counters, card)
    launches_by_path.update(ckpt_launches)
    path_head_dim.update({path: train_cfg.dims_per_head
                          for path in CKPT_PATHS})

    clock("phase 19")
    # phase 20: training past the card's memory
    gc.collect()
    torch.cuda.empty_cache()
    _, host_gb_s = host_kernels_phase(card)
    offload_launches, _ = offload_phase(counters, card)
    launches_by_path.update(offload_launches)
    remat_phase(counters, card)
    depth_launches, _ = full_depth_phase(counters, card, cache_dir,
                                         host_gb_s)
    launches_by_path.update(depth_launches)
    path_head_dim.update({path: train_cfg.dims_per_head
                          for path in {**offload_launches, **depth_launches}})

    clock("phase 20")
    # phase 21: fp16, pure bf16, every other optimizer, the engine's API,
    # Random-LTD and the flops profiler
    p21_launches, bf16_rows = training_rest_phase(counters, card)
    launches_by_path.update(p21_launches)
    path_head_dim.update({path: train_cfg.dims_per_head
                          for path in p21_launches})

    clock("phase 21")
    # phase 22: the trace toolchain (replay, disaggregated, tier, analyse
    # and capacity plan, the pool smoke) through the port's tools
    launches_by_path.update(trace_phase(counters, card, cache_dir))

    clock("phase 22")
    # phase 23: the one-card public API (the hybrid engine, init_inference,
    # OptimizedLinear, sparse gradients, comm and the accelerator)
    launches_by_path.update(public_api_phase(counters, card))

    clock("phase 23")
    # phases 24-25: training across four rank processes sharing the card
    # (gloo): every ZeRO stage, hpZ, MiCS and the int8 wire, then tensor
    # and sequence parallelism (Ulysses and ring)
    gc.collect()
    torch.cuda.empty_cache()
    launches_by_path.update(ranks_phase(counters, card, cache_dir))

    clock("phases 24-25")
    # the kernels line
    line = {"kernels": []}
    for name, rows in checks.items():
        head = rows[0]       # the main path's shape (serving step: decode)
        by_path = {path: launches[name]
                   for path, launches in launches_by_path.items()}
        entry = dict(
            name=name, route="cuda",
            source="deepspeed_tpu_torch/csrc/" + counters[name][0].source.name,
            replaces=replaces[name],
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(r["max_abs_err"] for r in rows),
            max_rel_err=max(r["max_rel_err"] for r in rows),
            rms_rel_err=max(r["rms_rel_err"] for r in rows),
            max_rel_tol=MAX_REL_TOL, rms_rel_tol=RMS_REL_TOL,
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], shape=head["shape"])
        if "host_us" in head:
            # host and device time per call, kernel and library, at every
            # shape (the first is the main path's)
            entry.update({k: head[k] for k in SPLIT_KEYS})
            entry["host_parts_us"] = head.get("host_parts_us")
            entry["by_shape"] = {r["shape"]: {
                k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                  *SPLIT_KEYS) if k in r} for r in rows}
        if name == "flash_bwd":
            # one wrapper, two kernels: dK/dV (:164) and dQ (:214), each
            # with its own launches, time and bound; delta is the
            # wrapper's rowsum(dO * O)
            entry["replaces_also"] = replaces["flash_bwd_dq"]
            entry["bit_equal"] = all(r["bit_equal"] for r in rows)
            entry["parts"] = dict(head["parts"])
            for part, fn in (("flash_bwd_dkv", "flash_bwd_dkv_bf16"),
                             ("flash_bwd_dq", "flash_bwd_dq_bf16")):
                entry["parts"][fn] = dict(
                    head["parts"][fn], replaces=replaces[part],
                    launches=sum(launches[part]
                                 for launches in launches_by_path.values()))
            entry["note"] = ("ms, plain_ms and library_ms (SDPA backward) "
                             "are the whole function; parts gives each "
                             "kernel's ms, bound and launches")
        if name == "flash_bwd":
            entry["launches_by_head_dim"] = {
                d: sum(launches_by_path[path]["flash_bwd"]
                       for path, pd in path_head_dim.items() if pd == d)
                for d in sorted(set(path_head_dim.values()))}
            entry["by_shape"] = {r["shape"]: {k: r[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "parts")} for r in rows}
            # this row is D = 128's instances; each other head dim has its
            # own row below (parts: launches over every head dim)
            entry["launches"] = entry["launches_by_head_dim"][128]
        if name in ("paged_attention", "paged_attention_int8", "flash_fwd"):
            # every shape phase 3 timed: the head dims of phases 9b-9d too
            entry["by_shape"] = {r["shape"]: {k: r[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
                for r in rows}
        if name in ("paged_attention", "paged_attention_int8"):
            # the combine runs on the paths where this page format ran
            entry["combine_launches"] = sum(
                launches["paged_attention_combine"]
                for launches in launches_by_path.values() if launches[name])
            entry["ms_by_path"] = {r["shape"]: (r["path"], r["ms"])
                                   for r in rows}
            entry["note"] = ("ms is one wrapper call: with fewer than 16 "
                             "folded rows the split-KV kernel and its "
                             "combine (combine_launches), else the "
                             "tensor-core tile")
        if name == "paged_attention_int8":
            entry["note"] += ("; the has_scale specialisation of the TPU "
                              "kernel; library_ms is two calls (dequantise "
                              "the gathered pages, then SDPA)")
        if name == "rmsnorm_res":
            entry["note"] = ("an op entry point that no model path calls, "
                             "in this package as in the JAX one: 0 launches"
                             " on every path; library_ms is two calls (add,"
                             " then F.rms_norm)")
        if head["library_ms"] is None:
            entry["note"] = NO_LIBRARY
        if name in ("quantize", "dequantize", "fp_dequant"):
            entry["bit_equal"] = all(r["bit_equal"] for r in rows)
        if name == "fp_dequant":
            entry["by_shape"] = {r["shape"]: {k: r[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by")} for r in rows}
            entry["note"] = ("replaces no pl.pallas_call: the JAX package "
                             "dequantises with jnp ops (replaces names its "
                             "_wval) that XLA fuses into the einsum; "
                             + NO_LIBRARY)
        if name == "fused_lion":
            entry["sign_mismatches"] = sum(r["sign_mismatches"] for r in rows)
        if name == "fused_lamb":
            entry.update(norm_rel_err=max(r["norm_rel_err"] for r in rows),
                         p_max_rel_err=max(r["p_max_rel_err"] for r in rows),
                         note=NO_LIBRARY + "; ms is stage 1 (the kernel), "
                         "step_ms the whole update with the trust ratio",
                         step_ms=head["step_ms"])
        line["kernels"].append(entry)
        if name == "flash_bwd":
            # each head dim's instances of the two kernels: their own row,
            # launches from the training paths at that head dim
            for r in rows:
                d = r["head_dim"]
                if d == 128:
                    continue
                line["kernels"].append(dict(
                    name=f"flash_bwd @ D={d}", route="cuda",
                    source=entry["source"], replaces=replaces["flash_bwd"],
                    replaces_also=replaces["flash_bwd_dq"],
                    launches=entry["launches_by_head_dim"].get(d, 0),
                    max_abs_err=r["max_abs_err"],
                    max_rel_err=r["max_rel_err"],
                    rms_rel_err=r["rms_rel_err"], max_rel_tol=MAX_REL_TOL,
                    rms_rel_tol=RMS_REL_TOL, bit_equal=r["bit_equal"],
                    ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"], shape=r["shape"],
                    parts=r["parts"], note=entry["note"]))
    # the pure-bf16 instances of the three optimizer kernels (phase 21 (d);
    # bf16 p, fp32 g and moments; launches: every bf16 instance)
    for name, rows in bf16_rows.items():
        head = rows[0]
        base = name.removesuffix("_bf16")
        by_path = {path: launches[name]
                   for path, launches in launches_by_path.items()}
        if not sum(by_path.values()):
            raise RuntimeError(f"{name}: no launch on any path")
        line["kernels"].append(dict(
            name=f"{base} @ bf16", route="cuda",
            source="deepspeed_tpu_torch/csrc/"
            + counters[name][0].source.name,
            replaces=replaces[base], launches=sum(by_path.values()),
            launches_by_path={k: v for k, v in by_path.items() if v},
            max_abs_err=head["max_abs_err"], max_rel_err=head["max_rel_err"],
            rms_rel_err=head["rms_rel_err"], max_rel_tol=MAX_REL_TOL,
            rms_rel_tol=RMS_REL_TOL, ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            shape=head["shape"], **{k: head[k] for k in (
                "bit_equal", "moved_share", "max_ulps", "ulp_share",
                "update_rms_rel_err") if k in head},
            **({} if head["library_ms"] is not None
               else {"note": NO_LIBRARY})))
    print(json.dumps(line))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
