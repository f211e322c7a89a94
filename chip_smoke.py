#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. Device: torch/CUDA versions and the card's name and power limit.
2. Build: the CUDA kernels from ``src/repro_torch/csrc`` (ptxas report;
   the registers and spills of K5's bulk-copy kernel, K6's and K7's
   register kernels, K2's tensor-core kernel and the bulk-copy kernels of
   K1 and K8).
3. Kernel parity at the main path's head geometry (Hq 24, Hkv 8, D 128,
   block 16): each kernel against its plain PyTorch version; K1 on both
   routes (the bulk-copy kernel against its live-lane split version and
   the earlier kernel against its padded-table one), zombie rows exactly
   0.
4. Engine parity at reduced llama3.2-3b in float32: the engine on the card
   (kernels) emits the same greedy streams as the engine on the CPU (plain
   versions); the launch counters equal layers x decode steps (decode
   kernel) and layers x chunks (prefill kernel).
5. Full-width serving of llama3.2-3b in bfloat16 with random weights:
   one-shot prefill, chunked prefill, a shared-prefix resubmit and an int8
   pool; every request finishes and the pool invariants hold; every K2
   launch of the bf16 chunked runs on the tensor-core route, of the int8
   run on the earlier kernel; every K1 launch of every run (bf16 and int8
   pools) on the bulk-copy route. A profile of one chunked run (K2's share of
   its device time); the chunked run once more on the earlier K2 kernel,
   its greedy streams against the tensor-core route's (near-tie audit) and
   each against the one-shot run's.
6. Kernel times at the main path's shapes (CUDA events, L2 flushed between
   launches) beside their bound and their plain versions; for K1, the
   bulk-copy route beside the earlier kernel on the same inputs, the int8
   pool on both, the wrapper's host enqueue time (mean with the garbage
   collector on, median with it off: ``benchmarks/decode_host.py``) and
   the bulk-copy route over a sweep of lane counts, at this shape (bf16
   and int8) and at eight 8,192-token rows; for K2, the tensor-core route
   beside the earlier kernel on the same inputs, the int8 pool (earlier
   kernel), SDPA on K/V gathered beforehand (a yardstick, gather not
   timed) and the wrapper's host enqueue time.
7. Flash-attention kernel parity: K3 (o, m, d) and K4 (dq, dk, dv) against
   their plain versions, bf16 (the tensor-core kernels) and fp32 (the
   CUDA-core kernels), IntMax on and off, causal and not, GQA groups 1 and
   3, Sq = Sk and Sq < Sk, lengths off every tile, D 128, 64 and 16; the
   route each case took; under IntMax m equal to the plain version's.
8. Training parity at reduced llama3.2-3b in float32, attention_impl
   "flash": three steps on the card (kernels) against the same steps on
   the CPU (plain versions), through the CUDA-core K3/K4 (fp32).
9. Full-width training of llama3.2-3b: 28 layers, bf16 compute, fp32
   master weights and AdamW state, remat "full", seq 4096, batch 1, random
   weights; one step with the plain chunked attention, then three steps
   through K3/K4 from the same weights and batch, every launch on the
   tensor-core kernels; step time, tokens/s, peak memory, launches per
   step and a profile of one step.
10. K3 and K4 times at the full-width shape beside their bound, their
   plain versions, the CUDA-core kernels on the same bf16 inputs (their
   earlier route) and PyTorch's scaled_dot_product_attention (forward,
   and its autograd backward), which computes the same function up to
   rounding and is timed here only as a yardstick; achieved TFLOP/s and
   the new kernels' registers and spills. The CUDA-core kernels' own
   route (fp32) is timed at the same shape.
11. Contiguous decode kernel parity: K5 against its plain version, bf16
   and fp32, IntMax on and off, GQA groups 1, 3, 4 and 8, caches of 37 and
   1056 rows, lengths 1, the chunk and pass boundaries +-1 and the whole
   cache, every case on the bulk-copy route; a bf16 cache of D 36 on the
   earlier kernel; the route's tile rows equal to the wrapper's mirror.
12. Static engine parity at reduced llama3.2-3b in float32: the static
   engine on the card (K5) emits the greedy streams of the same engine on
   the CPU and of the paged engine on the card; an int8 cache on the card
   equals the CPU's.
13. Full-width static serving of llama3.2-3b in bf16 with random weights:
   8 prompts of 1024 tokens, 32 new tokens, with a bf16 and an int8
   cache; tok/s, ms per decode step, K5 launches (every one on the
   bulk-copy route) and a profile of 5 decode steps; the same prompts
   through the paged engine (one-shot prefill, and 256-token chunks with
   K2 on the tensor-core route and on the earlier kernel), each with a
   near-tie audit of the first greedy token that differs, every K1 launch
   on the bulk-copy route.
14. K5's time at the full-width decode shape beside its bound, its plain
   version, the earlier kernel on the same inputs and
   scaled_dot_product_attention.
15. (A) Softermax row kernel (K6) and fixed-point kernel (K7) parity: K6
   against its plain version (float32 math) within ``kernels/parity.py``'s
   rule, f32 and bf16, IntMax on and off; K7 EQUAL (``torch.equal``) to its
   mirror ``softermax_quant_plain`` and within 2^-7 of ``softermax_fixed``;
   masked and pad columns, rows whose max is <= -17, V off the 16-wide
   slice, V one short of, at and one past the register routes' cap (4096
   and 8192 for K6 alone), and both full-width shapes of phase 20; the
   route each K6 and K7 case took.
16. (B) Fixed-point parity at reduced size, float32: the static engine on
   the card (K7 prefill, K5 decode) against the same engine on the CPU and
   the paged engine on the card, a first differing token held to the
   near-tie audit of phase 13; three Softermax-aware finetuning steps
   (``softermax_fixed``, K7) of reduced bert-base on the card against the
   CPU.
17. (C) Full-width fixed-point serving of llama3.2-3b in bf16
   (``softmax_impl="softermax_fixed"``: every one-shot prefill on the naive
   path through K7): 8 prompts of 1024 tokens, 32 new tokens, through the
   static and then the paged engine, with the near-tie audit between them;
   prefill ms, tok/s, K7 launches (28 per prefill call, every one on the
   register route) and a profile of the prefill by kernel.
18. (D) Full-width naive float path: the same prompts through the static
   engine with ``attention_impl="naive"``, ``softmax_impl="softermax"`` (K6,
   28 launches per prefill, every one on the register route), audited
   against ``attention_impl="flash"`` (K3), which computes the same
   function.
19. (E) Full-width Softermax-aware finetuning of bert-base (12 layers, d
   768, seq 512, batch 16, fp32 master weights, bf16 compute, remat
   "full"): the Table III workflow at 10 pretrain and 5 finetune steps per
   variant, every eval loss finite; ms per ``softermax_fixed`` and per
   ``softmax`` step, K7 launches per step (every one on the register
   route), peak memory.
20. (F) K6 and K7 times at the full-width prefill shape (rows 8 x 24 x
   1024, V 1024, f32) and the bert shape (rows 16 x 12 x 512, V 512) beside
   their byte bound, their plain versions, the two-pass kernels on the same
   inputs (their earlier routes; K7's EQUAL to the mirror on both) and,
   for K6, ``torch.softmax`` of the scores already scaled by ln 2 as the
   library yardstick (the factor folds into q in use, so it is not timed;
   no PyTorch call computes K7's function).

21. (G) Per-head paged decode kernel (K8) parity: K8 against its plain
   version ``paged_decode_single_plain`` for f32, bf16 and int8 pools,
   IntMax on and off, GQA groups 1, 3, 4, 8 and 12, blocks of 8 and 16,
   lengths 0, 1, on block edges and odd, garbage table tails; the same at
   the full-width llama3.2-3b geometry (Hq 24, Hkv 8, D 128, block 16);
   and K8 against K1 on the same inputs at (tile, split) (1, 1) and (4, 2);
   every case on the bulk-copy routes of both, and the earlier kernels of
   both on the same inputs against the same plain versions.
22. (H) The ported ``decode_paged_bench`` (its measuring function, not its
   gated CLI) at the reference's defaults and at the full-width geometry
   (8 requests, Hq 24, Hkv 8, D 128, one 16,384-token request): per-head
   (K8) and grouped (K1) tok/s, their ratio, the modeled gather-bytes
   ratio; K8 and K1 launches of each run (all on the bulk-copy routes);
   each kernel's device time per launch and its wrapper's host enqueue
   time per call (mean and median) at step 0, both routes of each on the
   same inputs; at full width, K1's bulk-copy route over a sweep of lane
   counts (the long row over more lanes).
23. (I) Autotune at full width: the paged engine with phase 13's weights
   and phase 5's prompts under ``autotune`` off, static and per-step,
   greedy streams held equal or each first difference to the near-tie
   audit, the planner's decisions; then a replay of ``autotune_bench``'s
   full-width trajectory timing K1 at every candidate grid per sampled
   step: on how many steps the modeled argmin is the measured fastest (a
   reading, not a gate).
24. (J) K8's time at the phase-22 full-width shape beside its byte bound
   (K/V read once, as for K1), its plain version and its earlier kernel on
   the same inputs; no PyTorch call computes paged IntMax base-2
   attention, so no library time.
25. (K) The four ported serving benches' own functions at their default
   workloads, at llama3.2-3b's full width in bf16 with phase 13's weights
   (attention projections at their true fan-in), each bench's rounds cut
   to 2 (printed): ``prefill_paged_bench`` (4 documents, shared 576, body
   3,072, chunk 256, block 32: the dense suffix prefill against K2's
   chunks, then a one-shot and a chunked engine), ``kv_int8_bench`` (10
   requests, prompt 40, 56 new tokens, block 16, 18 bf16 blocks' bytes, at
   the model's head_dim 128), ``prefix_cache_bench`` (16 requests, shared
   480, unique 16, 8 new tokens, block 32, 160 blocks, batch 8) and
   ``serve_throughput`` (32 requests at rate 4,000/s, prompts 16-128, 12
   new tokens, block 8, 64 blocks, batch 12: paged K1 against static K5).
   Every K1, K2 and K5 launch on its redesigned route (bulk copy, tensor
   cores, bulk copy); prefill savings and int8 capacity >= 1.8; the greedy
   streams each bench compares (one-shot against chunked, bf16 against
   int8, cache off against on every round, and every paged
   ``serve_throughput`` round against the first) equal, or each first
   difference excused by the near-tie audit of phase 13 (each sampled
   row's logits copied: during the rounds of the prefix-cache and
   throughput benches, in an untimed replay of the int8 bench's engines).
   The speed ratios are printed beside each bench's gate, not gated here;
   a profile of one more cache-on, paged and static drive each (device
   busy share, kernel time by name), and the phase's time.
26. (L) The paper's tables and figures on the card: Table IV and Fig. 5's
   energy model, Fig. 5's measured rows (two-pass ``softmax_e`` against
   the one-pass scan, plain) beside K6 on the same rows (CUDA events; K6
   held to its plain version), Fig. 1's matmul and softmax times, the
   Table-I bitwidth ablation (beside the CPU's rows), and the quickstart
   (K6 and K3 against their plain versions, both launched).

27. (M) Serving telemetry at llama3.2-3b's full width in bf16 with phase
   13's weights and phase 5's prompts: (a) the paged engine with
   chunked-256 prefill, per-step grid planning and
   ``Telemetry(timeline=True, trace_requests=True)``, then a shared-prefix
   resubmit, once with the telemetry detached and once attached: streams
   equal, the registry's decode steps, chunks and tokens equal to
   ``EngineMetrics``, the planner's decisions to the decode steps, the
   modeled DMA bytes to the timeline's sum, the Chrome trace loads with one
   decode slice per decode step, the Prometheus text parses back; TTFT,
   TPOT, e2e and step p50/p90/p99 (host dispatch stamps), the summed step
   durations beside the synced wall time, ``autotune_pred_over_measured``;
   (b) an int8 pool with one-shot prefill and the numerics monitor on every
   prefill (64-token probes): probes equal to prefills, the logit-error
   maximum and the IntMax, clip and saturation counters; (c)
   ``serve_throughput``'s telemetry-overhead rounds (paged engine, 9
   rounds after one untimed drive): ``telemetry_on_over_off`` (best-of)
   beside its >= 0.95 gate (read, not gated), the median of the paired
   ratios and the quantile lines. Every K1 launch on the bulk-copy route,
   every K2 launch on the tensor cores.
28. (N) The serving engine's resilience layer at llama3.2-3b's full width
   with the depth cut to its first ``RESILIENCE_LAYERS`` layers (each
   drive's thresholds come from its own clean audit), in bf16 with phase
   13's weights and phase 5's prompts, 32 new tokens:
   (a) the clean readback-audit deltas of every request, one-shot and
   chunked-256 prefill, bf16 and int8 pools, with how many clean requests
   the reference's default ``GuardConfig`` would quarantine; (b) the
   canned fault plan with the guard at thresholds derived from (a)
   (``resilience_bench.guard_config_for``, printed), chunked-256, bf16
   pool: the kv_corrupt victim quarantined and its tree nodes purged,
   every other greedy stream equal to the fault-free drive's, the
   invariants after every step, no leaked block, every engine fault kind
   in the log, the seven resilience counters and the guard's transitions;
   (c) the same storm unguarded: a stream diverges; (d)
   ``resilience_bench``'s rounds at that width (its other three gates
   asserted, the guarded/fault-free tok/s ratio read beside its 0.70
   gate) and its CLI at the reference's reduced defaults in a child
   process (a gate it misses is printed, not fatal). Every K1 launch on
   the bulk-copy route, every K2 launch on the tensor cores.
29. (O) Fleet and durability at llama3.2-3b's full width in bf16 with
   phase 13's weights (the fleet drives (a)-(b) with the depth cut to the
   first ``FLEET_LAYERS`` layers: their gates are counts, which depth does
   not move), one copy shared by every replica: (a)
   ``fleet_bench``'s default workload (3 replicas, 8 tenants x 6 requests,
   prefix 16 + tail 8, 48 new tokens, block 8, 64 blocks, batch 4)
   through the bench's own functions: one replica, the affinity fleet
   (replicas stepping in threads; ticks 20-39 profiled: the card's busy
   share), the round-robin fleet (one thread) and the chaos drive under
   ``canned_fleet_plan`` with the journal and the invariants every tick;
   the bench's gates (tok/tick >= 1.6x, affinity's hit rate above
   round-robin's, every chaos request ``length`` with a failover, no leak,
   the journal in memory and from its file replaying to the tracker),
   each stream equal to the fault-free fleet's or its first difference
   excused by phase 13's near-tie audit, ``c_crashed``/``c_hung`` equal
   to the plan's crash and hang and no replica dying otherwise; (b) the
   chaos drive on one thread: streams and journal records (``t`` and
   ``crc`` excepted) equal the threaded drive's; (c) ``restore_bench``'s
   three kill cases in process (a snapshot every tick and a journal,
   abandoned unflushed at the kill condition, a warm restore driven to
   drain): fsck clean, no leak, streams equal or audited, each snapshot's
   bytes and write/read/restore times, a bf16 pool's bits through the
   round trip; the corrupted snapshot's cold fallback; warm against cold
   (fewer prefill tokens, fewer ticks to first token); (d) both benches'
   CLIs at the reference's reduced defaults in child processes (their
   gates are counts: a gate they miss ends the run). Every K1 launch on
   the bulk-copy route, every bf16 K2 launch on the tensor cores.
30. (P) The MoE family at moonshot-v1-16b-a3b's full width (48 layers, d
   2048, 16/16 heads of 128, 64 experts of 1408, top-6, vocab 163,840):
   (a) K1 and K2 on both routes and K5 at G = 1 (Hq = Hkv = 16, D 128,
   block 16), K6 forward and backward at the router's rows (8, 64) and
   (1024, 64), each against its plain version; (b) 28.06 B random bf16
   parameters (56.1 GB) drawn on the card one layer slice at a time,
   attention projections at true fan-in; (c) the paged engine on 8
   prompts of 128-1024 tokens, 32 new: one-shot, chunked-256 with a
   shared-prefix resubmit, an int8 pool; every request finishes, the pool
   invariants hold, K1 = 48 x decode steps (bulk copy), bf16 K2 = 48 x
   chunks (tensor cores), K6 = the MoE calls, dropped assignments
   printed; (d) the static engine on 8 x 1024 tokens (K5 = 48 x 31, bulk
   copy); (e) one 1024-token prompt through the paged one-shot engine
   and the static engine, each MoE call on the same token set: streams
   equal, or the first difference excused by a router near tie (the
   k-th/(k+1)-th selection swapped within twice the runs' probability
   noise) or by phase 13's logit near-tie audit; its prefill logits
   against ``lm_forward`` within 2e-2 of the largest; chunked against
   one-shot and static B = 8 against paged printed, not gated (other
   token sets a call, other drops); (f) ms per synced decode step, a
   profile of 5 paged and 5 static decode steps, K6 at the router's rows
   beside ``torch.softmax`` and its byte bound, K1/K2/K5 at G = 1; (g)
   training at full width with the depth cut to 2 MoE layers (fp32
   master weights, AdamW, bf16, remat, flash, seq 4096, batch 1): three
   steps, ce and aux finite, aux > 0, K3, K4 and K6 each 4 a step; (h)
   ``launch.serve --arch moonshot-v1-16b-a3b --reduced``, static and
   paged, print the same greedy tokens, and ``launch.train`` takes 3
   steps.
31. (Q) The MLA, hybrid and RWKV-6 families through the static engine: (a)
   reduced deepseek-v2-236b, hymba-1.5b and rwkv6-7b in float32, the card's
   greedy streams equal the CPU's; (b) deepseek-v2-236b at full width (d
   5120, 128 heads, q_lora 1536, kv_lora 512, qk 128+64, v 128, 160
   experts of 1536, top-6, 2 shared, vocab 102,400) with the depth cut to
   its dense head block + 4 MoE layers (5 of 60, 17.3 B bf16 parameters),
   8 x 1024 tokens, 32 new, expanded and ``opt_mla_absorbed``: every
   request finishes, K6 = the MoE calls, no attention kernel; the forms'
   streams equal or each difference excused by a router near tie or the
   logit near-tie audit; ms per synced decode step, a profile of 5 decode
   steps, dropped assignments, the latent cache's bytes per token; (c)
   hymba-1.5b at full width and depth (32 layers, d 1600, 25/5 heads of
   64, window 1024, SSM state 16, d_inner 3200), 8 x 1024, 32 new, the
   ring wrapping from the first decode step, prefill under ``chunked`` and
   ``flash``: K3 = 32 under flash (tensor cores), 0 under chunked; the
   streams audited as in (b); (d) rwkv6-7b at full width and depth (32
   layers, d 4096, 64 heads of 64, d_ff 14,336), 8 x 1024, 32 new, in
   bf16: the prefill's logits within ``BF16_ATOL`` of the largest logit of
   ``lm_forward`` over the grown sequence (the decode steps' read); then
   the same weights in float32: every step's served logits within
   ``RWKV_F32_TOL`` of the largest logit of ``lm_forward``; K6 at the router's
   rows (8, 160) and (8192, 160) and K3 at hymba's prefill shape beside
   their plain versions, bounds and library calls; (e) for each of the
   three, in this process: ``launch.serve --reduced --engine static`` on
   the card prints the greedy tokens of the static engine on the CPU over
   its weights and prompts, ``--engine paged`` refuses,
   ``launch.train --reduced`` takes 3 steps.

32. (R) whisper-base, whole, at full width (6 + 6 layers, d 512, 8/8
   heads of 64, d_ff 2048, vocab 51,865 padded to 51,968, 1,500 frames),
   random bf16 weights at true fan-in, random normal stub frames (8,
   1500, 512), 64 greedy tokens from ``<|startoftranscript|>`` into a
   448-slot self cache through ``model_fns(cfg).prefill`` and
   ``decode_step``: (a) under ``flash`` (K3 6 per encode, tensor cores)
   and ``chunked`` (none), K5 6 a decode step (bulk copy), no other
   kernel; prefill ms, ms per synced decode step, a profile of 5 decode
   steps with K5's and the plain cross decode's shares of the busy time;
   the two streams audited (``_forms_audit``); (b) every served step's
   logits against ``whisper_forward`` over the grown sequence, bf16
   within ``WHISPER_BF16_TOL`` and the same weights in float32 (K3 on
   the CUDA cores, K5 in f32; the forward under ``chunked``) within
   ``WHISPER_F32_TOL`` of the largest logit; (c) K3 and K4 at the
   encoder's (1500 x 1500, non-causal), the cross attention's (448 over
   1500, non-causal) and the decoder's (448, causal) shapes, K5 at G = 1,
   D 64 over 448 slots, each held to its plain version within
   ``tolerance(bf16)`` on its redesigned route, K3 at the encoder's and
   K5 at G = 1 also in float32 within ``tolerance(float32)``, each timed
   beside its bound and SDPA; (d) one AdamW step (fp32 master weights,
   bf16, remat "full", B 8, 448 tokens) under ``chunked`` and ``flash``:
   finite, the losses and gradient norms within ``WHISPER_TRAIN_TOL``,
   each layer's attention weight gradients within ``WHISPER_GRAD_TOL``,
   K3 36 and K4 36 under flash (tensor cores), the step time and peak
   memory.

33. (S) ``parallel/``: (a) on a one-rank NCCL group
   (``make_host_mesh()``): one ``make_ddp_train_step`` step with
   ``grad_compression`` at llama3.2-3b's full width cut to
   ``PARALLEL_LAYERS`` layers (flash, bf16, ``PARALLEL_ROWS`` x
   ``PARALLEL_SEQ``): K3 and K4 2 a layer on the tensor cores, every
   leaf's int8 codes and residual EQUAL to the plain quantization, the
   step's time and the compressed all-reduce's share; K3 and K4 at that
   step's attention shape (24/8 heads, D 128, causal) against their plain
   versions within ``tolerance(dtype)``, in bf16 on the tensor cores and
   in float32 (what (b) runs) on the CUDA cores, timed; ``ring_attention`` at llama3.2-3b's attention shape
   (24/8 heads, D 128, S 4096, bf16, causal) against ``chunked_attention``,
   output and gradients within ``RING_TOL``; ``moe_apply_shard_map`` on
   each MoE layer of phase 30's training cut of moonshot-v1-16b-a3b (8 x
   128 tokens) against ``_moe_apply_global`` within ``MOE_EP_TOL``, K6
   once a call; (b) two gloo ranks sharing the card, spawned by the phase:
   the DDP step at full width cut to ``PARALLEL_LAYERS`` layers in float32
   (``PARALLEL_ROWS`` rows a rank) against the one-rank step on the whole
   batch (loss, grad norm, every parameter leaf and every first-moment
   leaf within 1e-5), the compressed step within 2 lr
   of it, each rank's step time and all-reduce share, and whether gloo
   takes CUDA tensors for send/recv and all_to_all (NCCL refuses two ranks
   on one device; gloo's CUDA all_reduce is what the DDP step needs).

34. (T) Training of the MLA, hybrid and RWKV-6 families on the card
   (``phase_family_train``): (a) three AdamW steps of reduced deepseek
   (expanded and absorbed MLA), hymba (chunked and flash) and rwkv6 in
   float32 on the card against the CPU from the same weights and batches
   (``tests/test_torch_moe.py``'s tolerances, the first grad norm within
   ``FT_GN0_TOL``), launches a step against the layer counts; (b)
   deepseek-v2-236b at full width cut to its dense head block + 2 MoE
   layers of 32 routed experts (``DEEPSEEK_TRAIN_*``), S 4096, B 1, bf16,
   fp32 master weights and AdamW, remat "full": two steps in each MLA form
   from the same weights, finite, aux > 0, K6 4 a step (forward + remat
   recompute) and no other kernel, the forms' first losses within
   ``DEEPSEEK_FORMS_TOL``, step time, tokens/s, parameters, peak memory;
   (c) hymba-1.5b whole, flash, B 8 x 1024 (its window): a chunked
   gradient pass and two flash steps from the same weights, the first
   step's loss, grad norm and every layer's attention-weight gradients
   against the chunked pass (``WHISPER_TRAIN_TOL``,
   ``WHISPER_GRAD_TOL``), K3 and K4 64 a step on the tensor cores, the
   second step profiled (busy share), the scan loop's share of a step
   (``_scan_share``); (d) rwkv6-7b cut to 8 of 32 layers, B 4 x 1024, two
   steps, no kernel, the same readings; (e) K3/K4 at hymba's training
   shape (bf16, G 5, D 64) within ``tolerance(bf16)`` and K6 forward and
   backward at deepseek's router rows (4096, 32) within 1e-5 of their
   plain versions, timed beside the bound, the plain version and SDPA /
   ``torch.softmax``; (f) ``launch.train`` at hymba-1.5b's full width (B
   1 x 1024, 2 steps) and on the reduced deepseek and rwkv6, the port's
   ``examples/train_lm.py`` (tiny, 5 steps) and ``examples/serve_lm.py``
   (reduced; its streams those of a CPU engine on the same weights).
   ``family_train_reading`` runs (c)/(d)'s readings alone at any S (the
   S 4096 readings of ``PERF.md``).

35. (A) The analytic layer on the card (``phase_analytic``): no drive and
   no allocation. For every step an earlier phase timed (phase 9's llama
   training steps, phase 5's one-shot paged decode steps, phase 34's
   deepseek in both MLA forms, hymba and rwkv6 steps, phase 32's flash
   training step of whisper-base), its config cut as the phase ran it and
   a ``ShapeConfig`` of its measured batch and length: analytic and model
   FLOPs (``repro_torch.launch``), the compute term against the roofline's
   H100 entry at bf16, the measured seconds (min-max of the timed steps),
   ``mfu`` = model FLOPs / (seconds x the bf16 peak) and the analytic
   FLOPs' share of the peak the same way. A step no earlier phase timed
   fails the phase. Then ``input_specs`` and ``model_fns(cfg).abstract()``
   of every grid cell that ``cell_supported`` lets run, all on the meta
   device, with ``torch.cuda.memory_allocated()`` unchanged.

36. (P) parallel/'s implicit placement on the card (``phase_placement``):
   on the one-rank NCCL ``(1, 1)`` mesh of ``make_host_mesh()`` (every
   spec still takes its ``Shard`` placements there, on mesh dims of size
   1), phase 9's llama3.2-3b (flash, B 1 x 4096, true fan-in weights) for
   ``PLACEMENT_STEPS`` plain steps, then, from the same weights drawn
   again, as many steps with the parameters placed by ``param_sharding``
   under ``DEFAULT_RULES`` (DTensors; the batch distributed by the rules'
   ``("batch", "seq")`` spec): each placed step's loss and grad norm
   within ``PLACEMENT_TOL`` of the plain one's, K3/K4 56 launches a step
   on either route, all on the tensor cores; each route's ms per synced
   step, their ratio (DTensor's dispatch on the host) and peak memory,
   read, not gated; K3 on DTensors at ``PERF.md`` §6's K3 shape EQUAL,
   bit for bit, to K3 on their ``to_local()`` shards, timed. The multi-
   rank placements are held on the CPU (``tests/test_torch_placement.py``:
   8 gloo ranks on a (4, 2) mesh against the reference's ``Auto`` mesh).

37. (D) The dry run on the card machine's torch (``phase_dryrun``; no
   kernel launches, nothing on the card): (a) ``launch.dryrun.lower_cell
   ("llama3.2-3b", "train_4k")`` on a fake 256-rank 16 x 16 group, its
   per-rank bytes, collectives and terms at ``H100_SXM`` printed (host
   work in a process of its own, started before phase 29, ~50 s); (b)
   phase 36's placed llama3.2-3b step recorded on a fake one-rank (1, 1)
   group: its argument bytes EQUAL to the parameters, AdamW state and
   batch phase 36 held on the card before its first step, its peak live
   bytes within ``DRYRUN_PEAK_TOL`` of phase 36's ``max_memory_allocated``
   (both count the same tensors; the card adds allocator rounding, cuBLAS
   workspace and K3's saved statistics, which the dry run's one-call
   kernels leave out), no collective; (c) the vocab-parallel loss and
   embedding on two gloo CPU ranks (``python -c``, a FileStore in a temp
   dir) within ``VOCAB_TOL`` of one rank, gradients placed as their
   operands.

Phase 4 also runs one engine with ``attention_impl="flash"``, whose one-shot
prefill goes through K3.

Prints the ``{"kernels": [...]}`` line and then, last, one JSON line with
``ok`` and the device. Without a card it exits non-zero and prints no
result.
"""
from __future__ import annotations

import atexit
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch.roofline import H100_SXM  # noqa: E402

HBM_BYTES_PER_S = H100_SXM.hbm_bw
PEAK_FLOPS = {dt: H100_SXM.peak(dt) for dt in ("bfloat16", "float32")}
BF16_ATOL, F32_ATOL = 2e-2, 1e-5


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _rand(rng, shape, scale=1.0):
    import numpy as np
    import torch
    return torch.from_numpy((rng.normal(size=shape) * scale)
                            .astype(np.float32))


def _pools(rng, N, Hkv, BS, D, kv, dev):
    """(k, v, k_scale, v_scale) pools of one layer: bf16, f32 or int8."""
    import torch
    from repro_torch.models.attention import quantize_kv
    k, v = _rand(rng, (N, Hkv, BS, D)), _rand(rng, (N, Hkv, BS, D))
    if kv == "int8":
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        return [t.to(dev) for t in (kq, vq, ks, vs)]
    dt = getattr(torch, kv)
    return [k.to(dev, dt), v.to(dev, dt), None, None]


def phase_kernel_parity(dev):
    """Each kernel against its plain version on the card."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_decode_paged import (
        flash_decode_paged, paged_decode_live_split_ref,
        paged_decode_split_ref)
    from repro_torch.kernels.flash_decode_paged import ops as k1_ops
    from repro_torch.kernels.flash_prefill_paged import (
        flash_prefill_paged, paged_prefill_ref)
    rng = np.random.default_rng(0)
    Hq, Hkv, D, BS = 24, 8, 128, 16
    worst = {}
    lens = np.array([0, 1, 17, 1000], np.int32)
    W = -(-int(lens.max()) // BS)
    N = len(lens) * W + 1
    cases = [(kv, T, S) for kv in ("bfloat16", "int8") for T in (1, 2)
             for S in (1, 2, 3)] + [("float32", 1, 2)]
    for kv, T, S in cases:
        kp, vp, ks, vs = _pools(rng, N, Hkv, BS, D, kv, dev)
        bt = rng.permutation(np.arange(1, N))[:len(lens) * W]
        bt = torch.from_numpy(bt.reshape(len(lens), W).astype(np.int32))
        bt[0] = 0                                   # zombie row
        bt, ln = bt.to(dev), torch.from_numpy(lens).to(dev)
        qdt = torch.float32 if kv == "float32" else torch.bfloat16
        q = _rand(rng, (len(lens), Hq, D), D ** -0.5).to(dev, qdt)
        bulk0 = flash_decode_paged.launches_bulk
        got = flash_decode_paged(q, kp, vp, bt, ln, k_scale=ks, v_scale=vs,
                                 kv_tile_blocks=T, split_k=S)
        torch.cuda.synchronize()
        check(flash_decode_paged.launches_bulk == bulk0 + 1,
              f"decode kernel {kv} T={T} S={S}: not on the bulk-copy route")
        # the bulk-copy route against its live-lane split version, the
        # earlier kernel on the same inputs against its padded-table one
        early = k1_ops._launch(q, kp, vp, bt, ln, ks, vs, True, T, S,
                               bulk=False)[0]
        torch.cuda.synchronize()
        tol = F32_ATOL if qdt == torch.float32 else BF16_ATOL
        for name, out, want in (
                ("decode", got, paged_decode_live_split_ref(
                    q, kp, vp, bt, ln, k_scale=ks, v_scale=vs,
                    n_lanes=k1_ops.bulk_lanes(q, kp, bt, T, S))),
                ("decode (earlier kernel)", early, paged_decode_split_ref(
                    q, kp, vp, bt, ln, k_scale=ks, v_scale=vs,
                    kv_tile_blocks=T, split_k=S))):
            err = (out.float() - want.float()).abs().max().item()
            check(err <= tol, f"{name} kernel {kv} T={T} S={S}: err {err}")
            check(bool(torch.all(out[0] == 0)), f"{name} kernel: zombie row")
            worst[(name, kv)] = max(worst.get((name, kv), 0.0), err)
    for kv, C, pos0 in [("bfloat16", 64, 0), ("bfloat16", 64, 768),
                        ("bfloat16", 256, 0), ("bfloat16", 256, 768),
                        ("int8", 256, 768), ("float32", 64, 768)]:
        W = -(-(pos0 + C) // BS)
        kp, vp, ks, vs = _pools(rng, W + 1, Hkv, BS, D, kv, dev)
        bt = torch.from_numpy(rng.permutation(np.arange(1, W + 1))
                              .astype(np.int32)[None]).to(dev)
        p0 = torch.tensor([pos0], dtype=torch.int32, device=dev)
        qdt = torch.float32 if kv == "float32" else torch.bfloat16
        q = _rand(rng, (1, Hq, C, D), D ** -0.5).to(dev, qdt)
        got = flash_prefill_paged(q, kp, vp, bt, p0, k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        want = paged_prefill_ref(q, kp, vp, bt, p0, k_scale=ks, v_scale=vs)
        err = (got.float() - want.float()).abs().max().item()
        tol = F32_ATOL if qdt == torch.float32 else BF16_ATOL
        check(err <= tol, f"prefill kernel {kv} C={C} pos0={pos0}: "
                          f"err {err}")
        worst[("prefill", kv)] = max(worst.get(("prefill", kv), 0.0), err)
    for (name, kv), err in sorted(worst.items()):
        print(f"[3] {name} kernel vs plain, {kv}: max |err| {err:.3g}")


def _drive(eng, prompts, max_new):
    """Submit, step to the end with a sync per step. Returns the results,
    the wall time, the decode-only step times (steps that ran no prefill
    work) and this drive's decode steps and prefill chunks."""
    import torch
    handles = [eng.submit(p, max_new) for p in prompts]
    steps0 = (eng.metrics.decode_steps, eng.metrics.prefill_chunks)
    decode_ms = []
    t0 = time.perf_counter()
    while eng.sched.has_work():
        before = (eng.metrics.prefills, eng.metrics.prefill_chunks)
        ts = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        if (eng.metrics.prefills, eng.metrics.prefill_chunks) == before:
            decode_ms.append((time.perf_counter() - ts) * 1e3)
    eng.drain()
    wall = time.perf_counter() - t0
    res = eng.pop_finished()
    return ([res[h.req_id] for h in handles], wall, decode_ms,
            eng.metrics.decode_steps - steps0[0],
            eng.metrics.prefill_chunks - steps0[1])


def _reset_counts():
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_decode_paged import (
        flash_decode_paged, flash_decode_paged_single)
    from repro_torch.kernels.flash_prefill_paged import flash_prefill_paged
    from repro_torch.kernels.softermax import softermax_rows
    from repro_torch.kernels.softermax_quant import softermax_quant_rows
    flash_decode_paged.launches = 0
    flash_decode_paged.launches_bulk = 0
    flash_decode_paged_single.launches = 0
    flash_decode_paged_single.launches_bulk = 0
    flash_prefill_paged.launches = 0
    flash_prefill_paged.launches_tc = 0
    flash_attention.launches = 0
    flash_attention_bwd.launches = 0
    flash_attention.launches_tc = 0
    flash_attention_bwd.launches_tc = 0
    flash_decode.launches = 0
    flash_decode.launches_bulk = 0
    softermax_rows.launches = 0
    softermax_rows.launches_reg = 0
    softermax_quant_rows.launches = 0
    softermax_quant_rows.launches_reg = 0


def _all_counts():
    """(K1, K2, K3, K4, K5, K6, K7) launch counts."""
    from repro_torch.kernels.flash_decode import flash_decode
    return (*_counts(), *_flash_counts(), flash_decode.launches,
            *_softermax_counts())


def _route_counts():
    """(K5 on the bulk-copy route, K6 on the register route, K7 on the
    register route) launches."""
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.softermax import softermax_rows
    from repro_torch.kernels.softermax_quant import softermax_quant_rows
    return (flash_decode.launches_bulk, softermax_rows.launches_reg,
            softermax_quant_rows.launches_reg)


def _softermax_counts():
    """(K6, K7) launch counts."""
    from repro_torch.kernels.softermax import softermax_rows
    from repro_torch.kernels.softermax_quant import softermax_quant_rows
    return softermax_rows.launches, softermax_quant_rows.launches


def _flash_counts():
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    return flash_attention.launches, flash_attention_bwd.launches


def _flash_tc_counts():
    """(K3, K4) launches on the tensor-core route alone."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    return flash_attention.launches_tc, flash_attention_bwd.launches_tc


def _check_k1_bulk(label):
    """Every K1 launch since the counts were reset took the bulk-copy
    route; returns the launches."""
    from repro_torch.kernels.flash_decode_paged import flash_decode_paged
    k1, bulk = flash_decode_paged.launches, flash_decode_paged.launches_bulk
    check(k1 > 0 and bulk == k1, f"{label}: {bulk} of {k1} K1 launches on "
                                 "the bulk-copy route")
    return k1


def _counts():
    from repro_torch.kernels.flash_decode_paged import flash_decode_paged
    from repro_torch.kernels.flash_prefill_paged import flash_prefill_paged
    return flash_decode_paged.launches, flash_prefill_paged.launches


def phase_engine_parity(dev):
    """Reduced llama3.2-3b, float32: the card's engine against the CPU's."""
    import numpy as np
    import torch
    from repro_torch.models.registry import (get_config, init_lm_params,
                                             reduce_config)
    from repro_torch.serve import ContinuousEngine, check_invariants
    cfg = reduce_config(get_config("llama3.2-3b"))
    params = init_lm_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (13, 21, 9, 30)]
    for chunk, kv in ((0, None), (8, None), (8, "int8"), (0, "int8")):
        kw = dict(block_size=8, num_blocks=40, max_batch=4, max_len=64,
                  prefill_chunk=chunk, kv_dtype=kv)
        streams = {}
        for d in ("cpu", dev):
            eng = ContinuousEngine(cfg, params, device=d, **kw)
            _reset_counts()
            res, _, _, n_dec, n_chunk = _drive(eng, prompts, 8)
            k1, k2 = _counts()
            check_invariants(eng.pool, eng.prefix_cache)
            streams[str(d)] = [r.tokens for r in res]
            if d != "cpu":
                check(k1 == cfg.n_layers * n_dec,
                      f"decode launches {k1} != {cfg.n_layers} x {n_dec}")
                check(k2 == cfg.n_layers * n_chunk,
                      f"prefill launches {k2} != {cfg.n_layers} x "
                      f"{n_chunk}")
                check(k1 > 0 and (k2 > 0) == (chunk > 0),
                      "a kernel of the path did not launch")
            else:
                check(_counts() == (0, 0), "the CPU engine launched a kernel")
        check(streams["cpu"] == streams[str(dev)],
              f"chunk={chunk} kv={kv}: card and CPU greedy streams differ: "
              f"{streams}")
        print(f"[4] reduced llama3.2-3b f32 chunk={chunk} kv={kv or 'auto'}:"
              f" card == cpu greedy streams, launches decode={k1} "
              f"prefill={k2}")

    # one-shot prefill through the flash-attention kernel (K3)
    fcfg = cfg.replace(attention_impl="flash")
    kw = dict(block_size=8, num_blocks=40, max_batch=4, max_len=64)
    streams = {}
    for d in ("cpu", dev):
        eng = ContinuousEngine(fcfg, params, device=d, **kw)
        _reset_counts()
        p0 = eng.metrics.prefills
        res, _, _, n_dec, _ = _drive(eng, prompts, 8)
        k1, _ = _counts()
        k3, k4 = _flash_counts()
        check_invariants(eng.pool, eng.prefix_cache)
        streams[str(d)] = [r.tokens for r in res]
        n_pre = eng.metrics.prefills - p0
        if d != "cpu":
            check(eng.metrics.prefix_hit_tokens == 0,
                  "flash engine: unexpected prefix hit")
            check(k3 == cfg.n_layers * n_pre and k3 > 0 and k4 == 0,
                  f"flash engine: K3 launches {k3} != {cfg.n_layers} x "
                  f"{n_pre} one-shot prefills (K4 {k4})")
            check(k1 == cfg.n_layers * n_dec, f"flash engine: decode "
                                              f"launches {k1}")
        else:
            check((k1, k3, k4) == (0, 0, 0), "the CPU engine launched a "
                                             "kernel")
    check(streams["cpu"] == streams[str(dev)],
          f"flash one-shot: card and CPU greedy streams differ: {streams}")
    print(f"[4] reduced llama3.2-3b f32 attention_impl=flash one-shot: card "
          f"== cpu greedy streams, launches flash_attention={k3} "
          f"decode={k1}")


def _chunked_on_earlier_k2(cfg, params, prompts, max_new, dev, **kw):
    """The prompts through the paged engine with 256-token chunks, every
    K2 launch on the earlier (CUDA-core) kernel: the route rule is switched
    off for this run alone. Returns the greedy tokens (B, T) and the
    logits behind them by (prompt index, step)."""
    import numpy as np
    from repro_torch.kernels.flash_prefill_paged import flash_prefill_paged
    from repro_torch.kernels.flash_prefill_paged import ops as k2_ops
    from repro_torch.serve import ContinuousEngine
    rule = k2_ops.tc_route
    k2_ops.tc_route = lambda *args: False
    try:
        eng = ContinuousEngine(cfg, params, device=dev, prefill_chunk=256,
                               **kw)
        rec = _paged_logits(eng)
        _reset_counts()
        res = _drive(eng, prompts, max_new)[0]
        k2, k2_tc = _counts()[1], flash_prefill_paged.launches_tc
        _check_k1_bulk("chunked-256 on the earlier K2 kernel")
    finally:
        k2_ops.tc_route = rule
    check(k2 > 0 and k2_tc == 0, f"chunked-256 on the earlier K2 kernel: "
                                 f"launches {k2}, {k2_tc} on the tensor "
                                 f"cores")
    logits = {(i, t): rec[r.req_id, t] for i, r in enumerate(res)
              for t in range(max_new)}
    return np.array([r.tokens for r in res]), logits


def _stream_share(a, b):
    """Share of equal greedy tokens and of equal streams of two runs."""
    return float((a == b).mean()), int((a == b).all(axis=1).sum())


def _timed_step(name, cfg, kind, B, S, seconds):
    """A step an earlier phase timed, for phase 35: its config as the phase
    ran it, a ``ShapeConfig`` of the measured batch and length, and the
    synced seconds of each timed step."""
    from repro_torch.configs.base import ShapeConfig
    return {"name": name, "cfg": cfg,
            "shape": ShapeConfig(name, kind, int(S), int(B)),
            "seconds": [float(t) for t in seconds]}


def phase_full_width(dev):
    """Full-width llama3.2-3b in bf16: one-shot, chunked, shared-prefix
    resubmit, int8 pool; every K2 launch of the bf16 chunked runs on the
    tensor-core route, of the int8 run on the earlier kernel. Then the
    chunked run profiled (K2's share of its device time) and once more on
    the earlier K2 kernel, the greedy streams of the three runs compared.
    Under the reference's init the logits are decisive at every step and
    flip between any two summation orders (PERF.md), so the shares
    are read, not gated; phase 13's weights gate chunked against static
    streams. Returns the chunked run's launch counts and the one-shot
    run's decode steps (``_timed_step``: all 8 rows decode in each)."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_prefill_paged import flash_prefill_paged
    from repro_torch.models.lm import cast_matrix_params
    from repro_torch.models.registry import get_config, init_lm_params
    from repro_torch.serve import ContinuousEngine, check_invariants
    cfg = get_config("llama3.2-3b")
    t0 = time.perf_counter()
    params = cast_matrix_params(
        init_lm_params(cfg, torch.Generator(device=dev).manual_seed(0)),
        cfg.compute_dtype_)
    torch.cuda.synchronize()
    print(f"[5] llama3.2-3b random weights (bf16) on the card in "
          f"{time.perf_counter() - t0:.2f}s")
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 1025, 8)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    max_new = 32
    base = dict(block_size=16, num_blocks=2048, max_batch=8,
                max_len=1024 + max_new)
    runs = [("one-shot", dict(prefill_chunk=0), prompts),
            ("chunked-256", dict(prefill_chunk=256), prompts),
            ("int8-chunked-256", dict(prefill_chunk=256, kv_dtype="int8"),
             prompts)]
    main_counts = decode = None
    streams = {}
    for name, kw, ps in runs:
        eng = ContinuousEngine(cfg, params, device=dev, **base, **kw)
        passes = [(name, ps)]
        if name == "chunked-256":
            # shared-prefix resubmit: half of each prompt plus a new tail
            passes.append(("prefix-resubmit", [
                np.concatenate([p[:len(p) // 2 + 3],
                                rng.integers(1, cfg.vocab_size, 40)
                                .astype(np.int32)]) for p in ps]))
        for label, batch in passes:
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            hits0 = eng.metrics.prefix_hit_tokens
            res, wall, dec_ms, n_dec, n_chunk = _drive(eng, batch, max_new)
            k1, k2 = _counts()
            k2_tc = flash_prefill_paged.launches_tc
            _check_k1_bulk(label)
            want_tc = 0 if "int8" in label else k2
            check(k2_tc == want_tc, f"{label}: {k2_tc} of {k2} K2 launches "
                                    f"on the tensor-core route, not "
                                    f"{want_tc}")
            check(all(len(r.tokens) == max_new for r in res),
                  f"{label}: a request did not finish with {max_new} tokens")
            check_invariants(eng.pool, eng.prefix_cache)
            hits = eng.metrics.prefix_hit_tokens - hits0
            check(k1 == cfg.n_layers * n_dec and k1 > 0,
                  f"{label}: decode launches {k1}")
            check(k2 == cfg.n_layers * n_chunk and
                  (k2 > 0) == bool(eng.prefill_chunk),
                  f"{label}: prefill launches {k2}")
            if label == "prefix-resubmit":
                check(hits > 0 and eng.metrics.cow_copies > 0,
                      "prefix-resubmit: no prefix hit / copy-on-write")
            toks = sum(len(r.tokens) for r in res)
            ttft = np.array([r.ttft for r in res]) * 1e3
            print(f"[5] {label}: {len(res)} requests x {max_new} tokens, "
                  f"{toks / wall:.1f} tok/s ({wall:.2f}s incl. prefill), "
                  f"TTFT p50 {np.median(ttft):.0f} ms max {ttft.max():.0f} "
                  f"ms (host stamps), "
                  f"{np.mean(dec_ms):.2f} ms per decode step "
                  f"(n={len(dec_ms)}), peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
                  f"prefix hits {hits} tokens, launches "
                  f"decode={k1} (all on the bulk-copy route) prefill={k2} "
                  f"(tensor cores {k2_tc})")
            if label == "chunked-256":
                main_counts = (k1, k2)
            if label == "one-shot":
                # the cache holds each prompt and the tokens generated so
                # far, max_new // 2 on average over the decode steps
                decode = _timed_step(
                    "llama3.2-3b paged decode", cfg, "decode", len(batch),
                    round(np.mean(lens)) + max_new // 2,
                    [t / 1e3 for t in dec_ms])
            if label in ("one-shot", "chunked-256"):
                streams[label] = np.array([r.tokens for r in res])
        del eng
        torch.cuda.empty_cache()

    # K2's share of the chunked run's device time
    eng = ContinuousEngine(cfg, params, device=dev, **base,
                           prefill_chunk=256)
    print("[5] " + step_profile(lambda: _drive(eng, prompts, max_new), 1,
                                "chunked-256 run (one run)",
                                watch=("paged_prefill_tc_kernel",)))
    del eng
    # the same run on the earlier K2 kernel: the tensor-core route leaves
    # the one-shot and the chunked streams as (un)equal as the earlier
    # kernel does
    earlier = _chunked_on_earlier_k2(cfg, params, prompts, max_new, dev,
                                     **base)[0]
    one, tc = streams["one-shot"], streams["chunked-256"]
    for a, b, what in ((one, tc, "one-shot vs chunked-256 (tensor cores)"),
                       (one, earlier, "one-shot vs chunked-256 (earlier K2 "
                                      "kernel)"),
                       (tc, earlier, "chunked-256, tensor cores vs earlier "
                                     "K2 kernel")):
        share, n_eq = _stream_share(a, b)
        print(f"[5] {what}: {share:.3f} of greedy tokens equal, "
              f"{n_eq}/{len(a)} streams equal (reference init: read, not "
              f"gated)")
    del streams

    # where a decode step's time goes: a profiled window once every
    # request is decoding
    eng = ContinuousEngine(cfg, params, device=dev, **base)
    for p in prompts:
        eng.submit(p, max_new)
    while eng.sched.waiting or eng.metrics.decode_steps < 1 or any(
            r.state == "prefill" for r in eng.sched.running):
        eng.step()
    print("[5] " + step_profile(eng.step, 5, "decode"))
    while eng.sched.has_work():
        eng.step()
    eng.drain()
    return main_counts, decode


def _kernel_us(step, n_steps: int):
    """(host wall seconds over ``n_steps`` calls of ``step``, {kernel name:
    summed device µs}) from the profiler's CUDA activity alone."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = {}
    # the raw activity records: ``prof.events()`` first builds a Python
    # event for every record, which takes longer than the step it traced
    # when an eager scan launches a kernel per op per time step
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            name = e.name().replace("void ", "").replace(
                "(anonymous namespace)::", "").split("<")[0].split("(")[0]
            kern[name] = kern.get(name, 0.0) + e.duration_ns() / 1e3
    return wall, kern


def step_profile(step, n_steps: int, label: str, watch=()) -> str:
    """Device-busy share and kernel time by name over ``n_steps`` calls of
    ``step``, from the profiler's CUDA activity; with ``watch`` (kernel-name
    prefixes), also those kernels' summed time and share of the busy
    time. Only the card's activity is traced: the host's op records would
    cost the eager loop's ~1,500 ops a step their overhead and their
    processing, and nothing here reads them."""
    return _profile_line(*_kernel_us(step, n_steps), n_steps, label, watch)


def _profile_line(wall, kern, n_steps, label, watch=()) -> str:
    """``step_profile``'s line from ``_kernel_us``' readings."""
    if not kern:
        return f"{label} profile: device time not measured (no CUDA events)"
    busy = sum(kern.values()) / 1e3 / n_steps
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
    line = (f"{label} profile over {n_steps} steps: "
            f"{wall * 1e3 / n_steps:.2f} ms per step, device busy "
            f"{busy:.2f} ms per step "
            f"({100 * busy / (wall * 1e3 / n_steps):.0f}%), by kernel (ms "
            f"per step): " + ", ".join(f"{k} {v / 1e3 / n_steps:.3f}"
                                       for k, v in top))
    if watch:
        w = sum(v for k, v in kern.items()
                if k.startswith(tuple(watch))) / 1e3 / n_steps
        line += (f"; {' + '.join(watch)}: {w:.3f} ms per step "
                 f"({100 * w / busy:.1f}% of busy)")
    return line


def _time_ms(fn, flush, iters=20):
    """Mean device time of ``fn`` over ``iters`` launches, L2 flushed
    before each (the serving path reads every layer's pool cold). A device
    wait of ~0.5 ms after the flush keeps the card busy while the host
    enqueues ``fn``, so the host's own time stays out of the interval."""
    import torch
    fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in evs) / iters


LANE_SWEEP_SHORT = (1, 2, 3, 4, 5, 6, 8, 12)
LANE_SWEEP_LONG = (2, 4, 6, 8, 12, 16, 24, 32, 64)


def _lane_sweep(q, kp, vp, bt, ln, T, S, counts, flush, ks=None, vs=None):
    """K1's bulk-copy route at each count of lanes a pair (a layout knob:
    each count held to the rule's count on the same inputs):
    {lanes: device ms}."""
    from repro_torch.kernels.flash_decode_paged import ops as k1_ops
    from repro_torch.kernels.parity import parity_error, tolerance

    def run(n=None):
        return k1_ops._launch(q, kp, vp, bt, ln, ks, vs, True, T, S,
                              bulk=True, lanes=n)[0]

    want = run()
    out = {}
    for n in counts:
        if n > bt.shape[1]:
            continue
        held = parity_error(run(n), want)[1]
        check(held <= tolerance(q.dtype), f"K1 at {n} lanes: checked error "
                                          f"{held} against the rule's count")
        out[n] = _time_ms(lambda: run(n), flush, iters=10)
    return out


def _sweep_text(sweep):
    return ", ".join(f"{n} {ms:.4f}" for n, ms in sweep.items()) + " ms"


def phase_kernel_times(dev, main_counts, n_layers):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode_paged import (flash_decode_paged,
                                                        gather_kv,
                                                        paged_decode_ref)
    from repro_torch.kernels.flash_prefill_paged import (flash_prefill_paged,
                                                         paged_prefill_ref)
    from repro_torch.benchmarks.decode_host import host_times
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_decode_paged import ops as k1_ops
    from repro_torch.kernels.flash_prefill_paged import ops as k2_ops
    from repro_torch.kernels.parity import parity_error, tolerance
    rng = np.random.default_rng(1)
    Hq, Hkv, D, BS = 24, 8, 128, 16
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    out = []

    # K1: B = 8 rows of length 1024, T = 1, split 1, bf16 pool
    B, L = 8, 1024
    W = L // BS
    kp, vp, _, _ = _pools(rng, B * W + 1, Hkv, BS, D, "bfloat16", dev)
    bt = torch.from_numpy(rng.permutation(np.arange(1, B * W + 1))
                          .reshape(B, W).astype(np.int32)).to(dev)
    ln = torch.full((B,), L, dtype=torch.int32, device=dev)
    q = _rand(rng, (B, Hq, D), D ** -0.5).to(dev, torch.bfloat16)
    saved = flash_decode_paged.launches, flash_decode_paged.launches_bulk
    got = flash_decode_paged(q, kp, vp, bt, ln)
    check(flash_decode_paged.launches_bulk == saved[1] + 1,
          "K1 phase-6 shape: not on the bulk-copy route")
    err = (got.float() - paged_decode_ref(q, kp, vp, bt, ln).float()) \
        .abs().max().item()

    def earlier_k1(*pools):
        return k1_ops._launch(q, *pools[:2], bt, ln, *pools[2:], True, 1, 1,
                              bulk=False)[0]

    err_early = (earlier_k1(kp, vp, None, None).float() - got.float()) \
        .abs().max().item()
    ms = _time_ms(lambda: flash_decode_paged(q, kp, vp, bt, ln), flush)
    earlier = _time_ms(lambda: earlier_k1(kp, vp, None, None), flush)
    plain = _time_ms(lambda: paged_decode_ref(q, kp, vp, bt, ln), flush)
    ms2 = _time_ms(lambda: flash_decode_paged(q, kp, vp, bt, ln), flush)
    host = host_times(lambda: flash_decode_paged(q, kp, vp, bt, ln))
    host_early = host_times(lambda: earlier_k1(kp, vp, None, None))
    # the int8 pool at the same shape, on both routes
    kq, vq, ks, vs = _pools(rng, B * W + 1, Hkv, BS, D, "int8", dev)
    bulk0 = flash_decode_paged.launches_bulk
    got8 = flash_decode_paged(q, kq, vq, bt, ln, k_scale=ks, v_scale=vs)
    check(flash_decode_paged.launches_bulk == bulk0 + 1,
          "K1 int8 pool: not on the bulk-copy route")
    err8 = (got8.float() - paged_decode_ref(
        q, kq, vq, bt, ln, k_scale=ks, v_scale=vs).float()).abs().max().item()
    check(err8 <= BF16_ATOL, f"K1 int8 pool: err {err8}")
    int8_ms = _time_ms(lambda: flash_decode_paged(
        q, kq, vq, bt, ln, k_scale=ks, v_scale=vs), flush)
    int8_early = _time_ms(lambda: earlier_k1(kq, vq, ks, vs), flush)
    lanes = k1_ops.bulk_lanes(q, kp, bt)
    sweep = _lane_sweep(q, kp, vp, bt, ln, 1, 1, LANE_SWEEP_SHORT, flush)
    sweep8 = _lane_sweep(q, kq, vq, bt, ln, 1, 1, LANE_SWEEP_SHORT, flush,
                         ks, vs)
    del kq, vq, ks, vs
    # eight rows of 8,192 tokens: every row long, a 512-block table
    L2 = 8192
    W2 = L2 // BS
    kl, vl, _, _ = _pools(rng, B * W2 + 1, Hkv, BS, D, "bfloat16", dev)
    bt2 = torch.from_numpy(rng.permutation(np.arange(1, B * W2 + 1))
                           .reshape(B, W2).astype(np.int32)).to(dev)
    ln2 = torch.full((B,), L2, dtype=torch.int32, device=dev)
    lanes2 = k1_ops.bulk_lanes(q, kl, bt2)
    sweep2 = _lane_sweep(q, kl, vl, bt2, ln2, 1, 1, LANE_SWEEP_LONG, flush)
    del kl, vl
    flash_decode_paged.launches, flash_decode_paged.launches_bulk = saved
    nbytes = (2 * B * L * Hkv * D * 2 + 2 * q.numel() * 2 + bt.numel() * 4
              + B * 4)
    nbytes8 = nbytes - 2 * B * L * Hkv * D + 2 * B * L * Hkv * 4
    flops = 4 * B * Hq * L * D
    row = _row("flash_decode_paged", "flash_decode_paged_bulk.cu",
               "src/repro/kernels/flash_decode_paged/"
               "flash_decode_paged.py:150", main_counts[0], n_layers,
               err, ms, plain, nbytes, flops)
    bound8 = nbytes8 / HBM_BYTES_PER_S * 1e3
    print(f"[6] K1 at B {B}, len {L}, Hq {Hq}, Hkv {Hkv}, D {D}, BS {BS} "
          f"(tile 1, split 1; {row['bound_ms']:.4f} ms bound by bytes): "
          f"bulk-copy route {ms:.4f} / {ms2:.4f} ms (max |err| vs plain "
          f"{err:.3g}), earlier kernel on the same inputs {earlier:.4f} ms "
          f"(vs the bulk-copy route {err_early:.3g}); int8 pool bulk-copy "
          f"{int8_ms:.4f} ms (earlier {int8_early:.4f}; bound "
          f"{bound8:.4f}; vs plain {err8:.3g}); plain {plain:.4f} ms; "
          f"wrapper host enqueue per call: mean of 20 {host[0] * 1e3:.1f} "
          f"us (collector on), median {host[1] * 1e3:.1f} us (collector "
          f"off); the earlier kernel through the same wrapper "
          f"{host_early[0] * 1e3:.1f} / {host_early[1] * 1e3:.1f} us")
    print(f"[6] K1 bulk-copy route by lanes a pair at this shape (the rule "
          f"gives {lanes}): bf16 {_sweep_text(sweep)}; int8 "
          f"{_sweep_text(sweep8)}")
    print(f"[6] K1 bulk-copy route by lanes a pair at {B} rows of {L2} "
          f"tokens (table {W2} blocks, bf16; the rule gives {lanes2}): "
          f"{_sweep_text(sweep2)}")
    row.update(earlier_ms=earlier, int8_ms=int8_ms,
               int8_earlier_ms=int8_early, int8_bound_ms=bound8,
               host_enqueue_ms=host[0], host_enqueue_median_ms=host[1],
               host_enqueue_earlier_ms=host_early[0],
               host_enqueue_earlier_median_ms=host_early[1], lanes=lanes,
               ms_by_lanes=sweep, int8_ms_by_lanes=sweep8)
    out.append(row)

    # K2: one 256-token chunk at pos0 = 768, bf16 pool: the tensor-core
    # route, the earlier kernel on the same inputs, the int8 pool (earlier
    # kernel) and SDPA on K/V gathered beforehand (a yardstick only: no
    # PyTorch call computes paged attention)
    C, pos0 = 256, 768
    W = (pos0 + C) // BS
    kp, vp, _, _ = _pools(rng, W + 1, Hkv, BS, D, "bfloat16", dev)
    bt = torch.from_numpy(rng.permutation(np.arange(1, W + 1))
                          .astype(np.int32)[None]).to(dev)
    p0 = torch.tensor([pos0], dtype=torch.int32, device=dev)
    q = _rand(rng, (1, Hq, C, D), D ** -0.5).to(dev, torch.bfloat16)
    saved = flash_prefill_paged.launches, flash_prefill_paged.launches_tc
    got = flash_prefill_paged(q, kp, vp, bt, p0)
    check(flash_prefill_paged.launches_tc == saved[1] + 1,
          "K2 phase-6 shape: not on the tensor-core route")
    want = paged_prefill_ref(q, kp, vp, bt, p0)
    err, held = parity_error(got, want)
    tol = tolerance(torch.bfloat16)
    check(held <= tol, f"K2 tensor-core route: max |err| {err}, checked "
                       f"error {held} > {tol}")

    def earlier_k2(*pools):
        return k2_ops._launch(q, *pools[:2], bt, p0, *pools[2:], True, 1,
                              tc=False)[0]

    err_early = parity_error(earlier_k2(kp, vp, None, None), want)[0]
    ms = _time_ms(lambda: flash_prefill_paged(q, kp, vp, bt, p0), flush)
    earlier = _time_ms(lambda: earlier_k2(kp, vp, None, None), flush)
    plain = _time_ms(lambda: paged_prefill_ref(q, kp, vp, bt, p0), flush)
    ms2 = _time_ms(lambda: flash_prefill_paged(q, kp, vp, bt, p0), flush)
    host = host_times(lambda: flash_prefill_paged(q, kp, vp, bt, p0))
    # of which the C entry alone: three tensor maps encoded, the launch
    out_c = torch.empty_like(q)
    c_args = [build.ptr(t) for t in (q, kp, vp, bt, p0, out_c)] + [
        1, Hq, Hkv, C, D, BS, W, W + 1, 1, build.stream_ptr(q.device)]
    host_c = host_times(lambda: build.check(
        build.load_library().smx_paged_prefill_tc(*c_args), "K2 C entry"))
    # the int8 pool at the same shape: the earlier kernel's route
    kq, vq, ks, vs = _pools(rng, W + 1, Hkv, BS, D, "int8", dev)
    tc0 = flash_prefill_paged.launches_tc
    got8 = flash_prefill_paged(q, kq, vq, bt, p0, k_scale=ks, v_scale=vs)
    check(flash_prefill_paged.launches_tc == tc0,
          "K2 int8 pool: took the tensor-core route")
    err8, held8 = parity_error(got8, paged_prefill_ref(
        q, kq, vq, bt, p0, k_scale=ks, v_scale=vs))
    check(held8 <= tol, f"K2 int8 pool: {err8} ({held8})")
    int8_ms = _time_ms(lambda: flash_prefill_paged(
        q, kq, vq, bt, p0, k_scale=ks, v_scale=vs), flush)
    flash_prefill_paged.launches, flash_prefill_paged.launches_tc = saved
    # SDPA with scale ln 2 on the pre-gathered K/V and the positional mask
    kg, vg = gather_kv(kp, bt), gather_kv(vp, bt)
    mask = (torch.arange(W * BS, device=dev)[None] <=
            pos0 + torch.arange(C, device=dev)[:, None])

    def sdpa():
        return F.scaled_dot_product_attention(q, kg, vg, attn_mask=mask,
                                              scale=math.log(2),
                                              enable_gqa=True)

    sdpa_err = parity_error(sdpa(), got)[0]
    sdpa_ms = _time_ms(sdpa, flush)
    keys = sum(pos0 + i + 1 for i in range(C))   # causal: what the data needs
    nbytes = 2 * (pos0 + C) * Hkv * D * 2 + 2 * q.numel() * 2 + W * 4 + 4
    flops = 4 * Hq * keys * D
    print(f"[6] K2 at one 256-token chunk at pos0 {pos0} (Hq {Hq}, Hkv "
          f"{Hkv}, D {D}, BS {BS}, bf16): tensor-core route {ms:.4f} / "
          f"{ms2:.4f} ms, max |err| vs plain {err:.3g} (checked {held:.3g} "
          f"<= {tol}), {8 * Hq * keys * D / ms / 1e9:.1f} TFLOP/s of "
          f"tensor-core work (8·D per visible pair); earlier kernel on the "
          f"same inputs {earlier:.4f} ms (vs plain {err_early:.3g}); int8 "
          f"pool (earlier kernel) {int8_ms:.4f} ms (checked {held8:.3g}); "
          f"plain {plain:.4f} ms; SDPA on pre-gathered K/V (gather not "
          f"timed) {sdpa_ms:.4f} ms (vs K2 {sdpa_err:.3g}); wrapper host "
          f"enqueue per call {host[0] * 1e3:.1f} us mean (collector on), "
          f"{host[1] * 1e3:.1f} us median (collector off), of which the C "
          f"entry (three tensor maps encoded, the launch) "
          f"{host_c[0] * 1e3:.1f} / {host_c[1] * 1e3:.1f} us")
    row = _row("flash_prefill_paged", "flash_prefill_paged_tc.cu",
               "src/repro/kernels/flash_prefill_paged/"
               "flash_prefill_paged.py:136", main_counts[1], n_layers,
               err, ms, plain, nbytes, flops)
    row.update(earlier_ms=earlier, int8_earlier_ms=int8_ms,
               sdpa_pregathered_ms=sdpa_ms, host_enqueue_ms=host[0],
               host_enqueue_median_ms=host[1], host_c_entry_ms=host_c[0])
    out.append(row)
    return out


def _lse_err(m, d, pm, pd):
    """max |(m + log2 d) - (pm + log2 pd)|: the row statistics are fp32 in
    every dtype, and their log-sum is what the backward reads."""
    import torch
    return (m + torch.log2(d) - pm - torch.log2(pd)).abs().max().item()


def phase_flash_parity(dev):
    """K3 and K4 against their plain versions on the card, on both routes."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain)
    from repro_torch.kernels.parity import parity_error, tolerance
    worst, worst_lse, routes = {}, 0.0, {}
    # (B, Hkv, G, Sq, Sk, D)
    shapes = [(2, 2, 1, 77, 77, 128), (1, 2, 3, 50, 130, 128),
              (1, 8, 3, 200, 200, 128), (2, 1, 3, 33, 70, 64),
              (2, 2, 3, 77, 130, 16)]
    for shape in shapes:
        B, Hkv, G, Sq, Sk, D = shape
        rng = np.random.default_rng(Sq + Sk)
        for dtn in ("float32", "bfloat16"):
            dt = getattr(torch, dtn)

            def rand(*shp):
                return _rand(rng, shp).to(dev, dt)

            q = rand(B, Hkv * G, Sq, D) * D ** -0.5
            k, v = rand(B, Hkv, Sk, D), rand(B, Hkv, Sk, D)
            do = rand(B, Hkv * G, Sq, D)
            tol = tolerance(dt)
            for causal in (True, False):
                for intmax in (True, False):
                    tag = f"{shape} {dtn} causal={causal} intmax={intmax}"
                    tc0 = _flash_tc_counts()
                    o, m, d = flash_attention(q, k, v, causal=causal,
                                              intmax=intmax,
                                              return_stats=True)
                    torch.cuda.synchronize()
                    po, pm, pd = flash_attention_plain(
                        q, k, v, causal=causal, intmax=intmax,
                        return_stats=True)
                    errs = {"o": parity_error(o, po),
                            "lse": _lse_err(m, d, pm, pd)}
                    worst_lse = max(worst_lse, errs["lse"])
                    check(errs["o"][1] <= tol and errs["lse"] <= F32_ATOL,
                          f"K3 {tag}: {errs}")
                    if intmax:
                        check(bool(torch.equal(m, torch.ceil(m))),
                              f"K3 {tag}: IntMax m not integral")
                        check(bool(torch.equal(m, pm)),
                              f"K3 {tag}: IntMax m differs from plain")
                    grads = flash_attention_bwd(q, k, v, o, do, m, d,
                                                causal=causal)
                    torch.cuda.synchronize()
                    tc = [a - b for a, b in zip(_flash_tc_counts(), tc0)]
                    routes[shape, dtn] = tuple(
                        "tensor cores" if n else "CUDA cores" for n in tc)
                    want = (1, 2) if dtn == "bfloat16" else (0, 0)
                    check(tuple(tc) == want, f"{tag}: tensor-core launches "
                                             f"{tc}, want {want}")
                    plain = flash_attention_bwd_plain(q, k, v, o, do, m, d,
                                                      causal=causal)
                    for name, g, w in zip(("dq", "dk", "dv"), grads, plain):
                        check(g.dtype == w.dtype and g.shape == w.shape,
                              f"K4 {tag} {name}: dtype/shape")
                        errs[name] = parity_error(g, w)
                        check(errs[name][1] <= tol, f"K4 {tag}: {errs}")
                    for key in ("o", "dq", "dk", "dv"):
                        kern = "K3" if key == "o" else "K4"
                        w = worst.get((kern, dtn), (0.0, 0.0))
                        worst[kern, dtn] = (max(w[0], errs[key][0]),
                                            max(w[1], errs[key][1]))
    for (shape, dtn), (r3, r4) in routes.items():
        print(f"[7] {shape} {dtn}: K3 on the {r3}, K4 on the {r4}")
    for (kern, dtn), (err, held) in sorted(worst.items()):
        tol = tolerance(getattr(torch, dtn))
        print(f"[7] {kern} vs plain, {dtn}: max |err| {err:.3g}, checked "
              f"error {held:.3g} <= {tol} ({len(shapes) * 4} cases)")
    print(f"[7] K3 row statistics m + log2(d) vs plain: max |err| "
          f"{worst_lse:.3g} <= {F32_ATOL}; IntMax m equal to plain")
    return worst["K3", "float32"][0], worst["K4", "float32"][0]


def _train_run(cfg, params, tc, steps, data):
    """``steps`` train steps; per step (metrics as floats, seconds, K3 and K4
    launches), each step ending in a sync."""
    import torch
    from repro_torch.models.registry import model_fns
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step
    step = make_train_step(model_fns(cfg).loss, tc)
    opt = adamw.init_state(params)
    rows = []
    for _ in range(steps):
        batch = next(data)
        c0 = _flash_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        c1 = _flash_counts()
        rows.append(({k: float(v) for k, v in m.items()}, dt,
                     (c1[0] - c0[0], c1[1] - c0[1])))
    return params, rows


def phase_train_parity(dev):
    """Reduced llama3.2-3b, flash, three steps: card against CPU."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.registry import (get_config, init_lm_params,
                                             reduce_config)
    from repro_torch.models.schema import tree_leaves, tree_map
    cfg = reduce_config(get_config("llama3.2-3b")).replace(
        attention_impl="flash")
    init = init_lm_params(cfg, torch.Generator().manual_seed(0))
    # lr 1e-4: AdamW's per-element normalization turns float32 gradient
    # noise into trajectory noise proportional to the step size
    tc = TrainConfig(total_steps=3, warmup_steps=1, learning_rate=1e-4)
    out = {}
    for d in ("cpu", dev):
        _reset_counts()
        params = tree_map(lambda a: a.to(d, copy=True), init)
        data = SyntheticLMData(cfg.vocab_size, 32, 4, seed=0)
        out[str(d)] = _train_run(cfg, params, tc, 3, data)
    (cparams, crows), (gparams, grows) = out["cpu"], out[str(dev)]
    L = cfg.n_layers
    k3_per_step = (2 if cfg.remat == "full" else 1) * L
    for s, (c, g) in enumerate(zip(crows, grows)):
        for key in ("loss", "ce", "grad_norm", "lr"):
            rel = abs(g[0][key] - c[0][key]) / abs(c[0][key])
            check(rel <= 1e-4, f"train step {s} {key}: card {g[0][key]} "
                               f"cpu {c[0][key]}")
        check(c[2] == (0, 0), "the CPU training run launched a kernel")
        check(g[2] == (k3_per_step, 2 * L),
              f"train step {s}: launches K3/K4 {g[2]}")
    worst = 0.0
    for c, g in zip(tree_leaves(cparams), tree_leaves(gparams)):
        rel = (torch.linalg.vector_norm(g.cpu() - c) /
               torch.linalg.vector_norm(c)).item()
        worst = max(worst, rel)
    check(worst <= 1e-4, f"train: final parameters differ by {worst}")
    check(_flash_tc_counts() == (0, 0),
          "f32 training launched the tensor-core kernels")
    print(f"[8] reduced llama3.2-3b f32 flash, 3 steps: card == cpu within "
          f"1e-4 (losses {[round(r[0]['loss'], 5) for r in grows]}, grad "
          f"norms {[round(r[0]['grad_norm'], 4) for r in grows]}, worst "
          f"parameter leaf rel L2 {worst:.3g}), launches K3/K4 per step "
          f"{grows[0][2]}, all on the CUDA cores")
    return _flash_counts()


# the mixers' 3-D projections, whose true fan-in the reference's init misses
_PROJECTIONS = ("wq", "wk", "wv", "wo", "wq_b", "wk_b", "wv_b", "wr")
# the dicts that hold them: the LM's mixer, hymba's and whisper's encoder
# attention, whisper's decoder self and cross attention
_MIXERS = ("mixer", "attn", "self_attn", "cross_attn")


def _fan_in(path, shape):
    """The true fan-in of a mixer's 3-D projection (``shape`` without the
    layer dim; ``path`` its keys), or None for any other leaf: the input
    dims, (d, H, k) → d for queries, keys, values and rwkv's receptance,
    (H, k, d) → H·k for an output projection."""
    if len(shape) == 3 and len(path) >= 2 and \
            path[-2] in _MIXERS and path[-1] in _PROJECTIONS:
        return shape[0] * (shape[1] if path[-1] == "wo" else 1)
    return None


def _true_fan_in(params):
    """Rescale the mixers' 3-D projections of a stacked parameter tree (both
    layer stacks), in place, to std 1/sqrt(true fan-in). The reference's
    init reads a matrix's fan-in from shape[-2], which for wq/wk/wv (d, H,
    dh) is the head count and for wo (H, dh, d) the head dim (MLA's
    wq_b/wk_b/wv_b and rwkv's wr/wk/wv the same): at d 3072 those weights
    are 5-11x too large (a property of the reference, see ROADMAP Queue
    3)."""
    def walk(tree, path):
        for k, w in tree.items():
            if isinstance(w, dict):
                walk(w, path + (k,))
                continue
            fan = _fan_in(path + (k,), w.shape[1:])
            if fan:
                w.mul_(math.sqrt(w.shape[-2] / fan))

    for name in ("head_blocks", "blocks"):
        if name in params:
            walk(params[name], ())
    return params


def phase_train_full_width(dev):
    """Full-width llama3.2-3b training: one chunked (plain) step, then three
    flash steps through train() from the same weights and batch. Returns
    the K3/K4 launches and the flash steps (``_timed_step``)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import TRAIN_4K, TrainConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.registry import get_config, model_fns
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step, train
    base = get_config("llama3.2-3b")
    S, B = TRAIN_4K.seq_len, 1
    tc = TrainConfig(total_steps=3, warmup_steps=1, learning_rate=3e-4)
    torch.cuda.empty_cache()

    def init():
        """The model's own init, then the attention projections rescaled to
        their true fan-in: at full width the reference's init makes the
        fp32 gradient norm of one step overflow (``_true_fan_in``)."""
        t0 = time.perf_counter()
        p = _true_fan_in(model_fns(base).init(
            torch.Generator(device=dev).manual_seed(0)))
        torch.cuda.synchronize()
        return p, time.perf_counter() - t0

    # one step with the plain chunked attention
    cfg = base.replace(attention_impl="chunked")
    params, t_init = init()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    _, rows = _train_run(cfg, params, tc, 1,
                         SyntheticLMData(cfg.vocab_size, S, B, seed=0))
    chunked, t_chunked = rows[0][0], rows[0][1]
    peak_chunked = torch.cuda.max_memory_allocated()
    check(_flash_counts() == (0, 0), "chunked step launched K3/K4")
    del params
    torch.cuda.empty_cache()
    print(f"[9] llama3.2-3b fp32 master weights on the card in {t_init:.2f}s;"
          f" chunked step 0: loss {chunked['loss']:.5f} grad norm "
          f"{chunked['grad_norm']:.4f}, {t_chunked:.2f}s, peak memory "
          f"{peak_chunked / 2 ** 30:.2f} GiB")

    # three steps through K3 / K4, driven by train()
    cfg = base.replace(attention_impl="flash")
    params, _ = init()
    torch.cuda.reset_peak_memory_stats()
    inner = make_train_step(model_fns(cfg).loss, tc)
    rows = []

    def step(p, o, batch):
        c0 = _flash_counts() + _flash_tc_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, m = inner(p, o, batch)
        torch.cuda.synchronize()
        c1 = _flash_counts() + _flash_tc_counts()
        rows.append(({k: float(v) for k, v in m.items()},
                     time.perf_counter() - t0,
                     tuple(b - a for a, b in zip(c0, c1))))
        return p, o, m

    _reset_counts()
    out = train(train_step=step, params=params,
                data=SyntheticLMData(cfg.vocab_size, S, B, seed=0), tc=tc,
                opt_state=adamw.init_state(params), log_every=1)
    k3, k4 = _flash_counts()
    peak = torch.cuda.max_memory_allocated()
    L = cfg.n_layers
    check(len(out["history"]) == 3 and np.isfinite(out["history"]).all(),
          f"full-width flash: losses {out['history']}")
    for s, (m, dt, (a, b, a_tc, b_tc)) in enumerate(rows):
        check(np.isfinite(m["grad_norm"]), f"step {s}: grad norm {m}")
        check((a, b) == (2 * L, 2 * L),
              f"step {s}: launches K3 {a}, K4 {b} != {2 * L}, {2 * L}")
        check((a_tc, b_tc) == (a, b),
              f"step {s}: K3/K4 launches {a}/{b}, of which on the tensor "
              f"cores {a_tc}/{b_tc}")
    check((k3, k4) == (6 * L, 6 * L), f"launches K3 {k3} K4 {k4}")
    check(_flash_tc_counts() == (k3, k4),
          f"tensor-core launches {_flash_tc_counts()} != {(k3, k4)}")
    rel = abs(rows[0][0]["loss"] - chunked["loss"]) / abs(chunked["loss"])
    check(rel <= 2e-2, f"flash step-0 loss {rows[0][0]['loss']} vs chunked "
                       f"{chunked['loss']}")
    # the loss is dominated by the tied logits' scale; the gradient norm
    # reads every layer's attention backward
    rel_gn = abs(rows[0][0]["grad_norm"] - chunked["grad_norm"]) / \
        chunked["grad_norm"]
    check(rel_gn <= 1e-3, f"flash step-0 grad norm {rows[0][0]['grad_norm']}"
                          f" vs chunked {chunked['grad_norm']}")
    for s, (m, dt, (a, b, a_tc, b_tc)) in enumerate(rows):
        print(f"[9] flash step {s}: loss {m['loss']:.5f} grad norm "
              f"{m['grad_norm']:.4f} lr {m['lr']:.3g}, {dt:.3f}s "
              f"({B * S / dt:.0f} tokens/s), launches K3 {a} K4 {b}, on "
              f"the tensor cores K3 {a_tc} K4 {b_tc}")
    print(f"[9] full-width flash vs chunked step 0: loss rel diff {rel:.3g} "
          f"<= 2e-2, grad norm rel diff {rel_gn:.3g} <= 1e-3; flash peak "
          f"memory {peak / 2 ** 30:.2f} GiB; launches over 3 "
          f"steps K3 {k3} K4 {k4}")
    # where a step's time goes: one more step, profiled, after the counts
    # were read
    state = [out["params"], out["opt_state"]]
    batch = next(SyntheticLMData(cfg.vocab_size, S, B, seed=1))

    def profiled():
        state[0], state[1], _ = inner(state[0], state[1], batch)

    print("[9] " + step_profile(profiled, 1, "training step", watch=(
        "flash_fwd_tc_kernel", "flash_bwd_dkv_tc_kernel",
        "flash_bwd_dq_tc_kernel")))
    del out, params, state
    torch.cuda.empty_cache()
    return (k3, k4), _timed_step("llama3.2-3b train", cfg, "train", B, S,
                                 [dt for _, dt, _ in rows])


def _ptxas_kernels(report, sources):
    """(kernel, registers, spill line) of each kernel ptxas compiled from
    ``sources``."""
    out = []
    for sec in report.split("== ")[1:]:
        if sec.split("\n", 1)[0].strip() not in sources:
            continue
        name = spill = None
        for line in sec.splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
                short = re.search(r"(decode_bulk_kernel|softermax_rows_reg_"
                                  r"kernel|softermax_quant_reg_kernel)I"
                                  r"(13__nv_bfloat16|f)Li(\d+)ELi(\d+)E",
                                  name)
                if short:
                    kern, dt, a, b = short.groups()
                    name = (f"{kern}<{'bf16' if dt != 'f' else 'f32'}, {a}, "
                            f"{b}>")
                short = re.search(r"paged_decode_bulk_kernelI(13__nv_bfloat16"
                                  r"|f|a)Li(\d+)E", name)
                if short:
                    dt, gb = short.groups()
                    dt = {"f": "f32", "a": "int8"}.get(dt, "bf16")
                    name = (f"{sec.split(chr(10), 1)[0].strip()}: "
                            f"paged_decode_bulk_kernel<{dt}, {gb}>")
                for short in ("flash_fwd_tc_kernel", "flash_bwd_dkv_tc_kernel",
                              "flash_bwd_dq_tc_kernel",
                              "paged_prefill_tc_kernel"):
                    if short in name:
                        dp = name.split("ILi")[1].split("E")[0]
                        name = f"{short}<{dp}>"
            elif "spill stores" in line:
                spill = line.strip()
            elif "registers" in line and name:
                regs = line.split("Used ")[1].split(" registers")[0]
                out.append((name, int(regs), spill))
                name = None
    return out


def phase_flash_times(dev, counts, f32_counts, f32_errs, n_layers):
    """K3 / K4 at the full-width training shape, causal: the tensor-core
    kernels (bf16, the training path) beside the CUDA-core kernels on the
    same inputs (their earlier route), SDPA and the bounds; then the
    CUDA-core kernels on their own route (f32)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain, ops)
    from repro_torch.kernels.parity import parity_error, tolerance
    rng = np.random.default_rng(2)
    B, Hq, Hkv, S, D = 1, 24, 8, 4096, 128
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    pairs = S * (S + 1) // 2 * Hq                  # causal, Sq = Sk

    def inputs(dt):
        return (_rand(rng, (B, Hq, S, D), D ** -0.5).to(dev, dt),
                _rand(rng, (B, Hkv, S, D)).to(dev, dt),
                _rand(rng, (B, Hkv, S, D)).to(dev, dt),
                _rand(rng, (B, Hq, S, D)).to(dev, dt))

    # the library yardstick: SDPA with scale ln 2 is the base-2 softmax of
    # the pre-scaled scores (the normalization ignores the max it subtracts)
    def sdpa(a, b, c):
        return F.scaled_dot_product_attention(a, b, c, is_causal=True,
                                              scale=math.log(2),
                                              enable_gqa=True)

    def library(q, k, v, do):
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        lo = sdpa(ql, kl, vl)
        return (_time_ms(lambda: sdpa(q, k, v), flush, iters=10),
                _time_ms(lambda: torch.autograd.grad(lo, (ql, kl, vl), do,
                                                     retain_graph=True),
                         flush, iters=10))

    def nbytes(el):
        """What the function moves: q, k, v in, o and (m, d) out; q, k, v,
        o, dO, (m, d) in and dq, dk, dv out in the inputs' dtype."""
        qb, kvb = B * Hq * S * D * el, B * Hkv * S * D * el
        stats = 2 * B * Hq * S * 4
        return 2 * qb + 2 * kvb + stats, 4 * qb + 4 * kvb + stats

    saved = _flash_counts() + _flash_tc_counts()
    q, k, v, do = inputs(torch.bfloat16)
    o, m, d = flash_attention(q, k, v, return_stats=True)
    po, pm, pd = flash_attention_plain(q, k, v, return_stats=True)
    err3, held3 = parity_error(o, po)
    lse3 = _lse_err(m, d, pm, pd)
    grads = flash_attention_bwd(q, k, v, o, do, m, d)
    plain = flash_attention_bwd_plain(q, k, v, o, do, m, d)
    err4, held4 = map(max, zip(*(parity_error(g, w) for g, w in zip(grads,
                                                                    plain))))
    tol = tolerance(torch.bfloat16)
    check(held3 <= tol and lse3 <= F32_ATOL and held4 <= tol,
          f"full-width shape: K3 o {err3} ({held3}), m + log2(d) {lse3}; "
          f"K4 {err4} ({held4})")
    check(bool(torch.equal(m, torch.ceil(m))), "K3: IntMax m not integral")
    check(bool(torch.equal(m, pm)), "K3: IntMax m differs from plain")
    ms3 = _time_ms(lambda: flash_attention(q, k, v, return_stats=True),
                   flush, iters=10)
    ms4 = _time_ms(lambda: flash_attention_bwd(q, k, v, o, do, m, d), flush,
                   iters=10)
    plain3 = _time_ms(lambda: flash_attention_plain(q, k, v,
                                                    return_stats=True),
                      flush, iters=3)
    plain4 = _time_ms(lambda: flash_attention_bwd_plain(q, k, v, o, do, m,
                                                        d),
                      flush, iters=3)
    # the CUDA-core kernels on the same bf16 inputs: K3/K4's earlier route
    delta = torch.sum(do.float() * o.float(), dim=-1).contiguous()
    core3 = _time_ms(lambda: ops._forward_cuda_cores(q, k, v, True, True),
                     flush, iters=5)
    core4 = _time_ms(lambda: ops._backward_cuda_cores(q, k, v, do, m, d,
                                                      delta, True),
                     flush, iters=3)
    lib_err = parity_error(sdpa(q, k, v), o)[0]
    lib3, lib4 = library(q, k, v, do)
    bytes3, bytes4 = nbytes(2)
    print(f"[10] full-width shape, bf16, tensor cores: K3 vs plain max "
          f"|err| {err3:.3g} (held {held3:.3g} <= {tol}), m + log2(d) "
          f"{lse3:.3g} <= {F32_ATOL}, IntMax m equal to plain; K4 vs plain "
          f"{err4:.3g} (held {held4:.3g} <= {tol}); SDPA vs K3 {lib_err:.3g}")
    print(f"[10] K3 {ms3:.4f} ms: {4 * pairs * D / ms3 / 1e9:.1f} TFLOP/s "
          f"of the function (4·D per visible pair), "
          f"{8 * pairs * D / ms3 / 1e9:.1f} on the tensor cores (8·D); K4 "
          f"{ms4:.4f} ms: {10 * pairs * D / ms4 / 1e9:.1f} TFLOP/s of the "
          f"function (10·D), {26 * pairs * D / ms4 / 1e9:.1f} on the tensor "
          f"cores (26·D); CUDA-core kernels on the same inputs K3 "
          f"{core3:.4f} ms, K4 {core4:.4f} ms; SDPA {lib3:.4f} / "
          f"{lib4:.4f} ms")
    for name, regs, spill in _ptxas_kernels(
            build.ptxas_report(),
            ("flash_attention_tc.cu", "flash_backward_tc.cu")):
        print(f"[10] ptxas {name}: {regs} registers at launch (consumers "
              f"raise theirs to 232 by setmaxnreg), {spill}")
    rows = [
        _row("flash_attention", "flash_attention_tc.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:99",
             counts[0], 2 * n_layers, err3, ms3, plain3, bytes3,
             4 * pairs * D, lib3),
        _row("flash_attention_bwd", "flash_backward_tc.cu",
             "src/repro/kernels/flash_attention/flash_backward.py:119",
             counts[1], 2 * n_layers, err4, ms4, plain4, bytes4,
             10 * pairs * D, lib4)]   # s, dP, dV, dK, dQ: 2·D each
    rows[0]["earlier_ms"], rows[1]["earlier_ms"] = core3, core4

    # the CUDA-core kernels on their own route, f32 (phase 8's training);
    # their parity is phase 7's (the f32 gate is an absolute 1e-5, which
    # sums of 4096 rows in another order do not keep)
    q, k, v, do = inputs(torch.float32)
    o, m, d = flash_attention(q, k, v, return_stats=True)
    f3 = _time_ms(lambda: flash_attention(q, k, v, return_stats=True), flush,
                  iters=5)
    f4 = _time_ms(lambda: flash_attention_bwd(q, k, v, o, do, m, d), flush,
                  iters=3)
    fp3 = _time_ms(lambda: flash_attention_plain(q, k, v, return_stats=True),
                   flush, iters=2)
    fp4 = _time_ms(lambda: flash_attention_bwd_plain(q, k, v, o, do, m, d),
                   flush, iters=2)
    fl3, fl4 = library(q, k, v, do)
    # timing and comparison launches do not count
    flash_attention.launches, flash_attention_bwd.launches = saved[:2]
    flash_attention.launches_tc, flash_attention_bwd.launches_tc = saved[2:]
    print(f"[10] CUDA-core kernels, f32 inputs: K3 {f3:.4f} ms, K4 "
          f"{f4:.4f} ms (plain {fp3:.2f} / {fp4:.2f}, SDPA {fl3:.4f} / "
          f"{fl4:.4f})")
    bytes3, bytes4 = nbytes(4)
    for name, src, line, n, err, ms, pl, nb, flops, lib in (
            ("flash_attention_f32", "flash_attention.cu",
             "flash_attention.py:99", f32_counts[0], f32_errs[0], f3, fp3,
             bytes3, 4 * pairs * D, fl3),
            ("flash_attention_bwd_f32", "flash_backward.cu",
             "flash_backward.py:119", f32_counts[1], f32_errs[1], f4, fp4,
             bytes4, 10 * pairs * D, fl4)):
        rows.append(_row(name, src,
                         "src/repro/kernels/flash_attention/" + line, n,
                         n // 3, err, ms, pl, nb, flops, lib,
                         peak="float32"))      # phase 8 ran 3 steps
    return rows


def phase_decode_parity(dev):
    """K5 against its plain version on the card, at the main path's head
    geometry (Hkv 8, D 128)."""
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_decode import (bulk_tile_rows, decode_ref,
                                                  flash_decode)
    from repro_torch.kernels.parity import parity_error, tolerance
    saved = flash_decode.launches, flash_decode.launches_bulk
    lib = build.load_library()
    for D in (4, 8, 36, 40, 64, 128, 256):
        for elem in (2, 4):
            if D * elem % 16 == 0:
                check(lib.smx_decode_bulk_tile(D, elem) ==
                      bulk_tile_rows(D, elem),
                      f"K5 tile rows at D {D}, {elem}-byte cache")
    Hkv, D = 8, 128
    worst, n = {}, 0
    for S in (37, 1056):
        lens = [x for x in (1, 31, 32, 33, 127, 128, 129, S) if x <= S]
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        for G in (1, 3, 4, 8):
            rng = np.random.default_rng(S + G)
            q = _rand(rng, (len(lens), G * Hkv, D), D ** -0.5)
            k = _rand(rng, (len(lens), Hkv, S, D))
            v = _rand(rng, (len(lens), Hkv, S, D))
            for dtn in ("float32", "bfloat16"):
                dt = getattr(torch, dtn)
                qd, kd, vd = (t.to(dev, dt) for t in (q, k, v))
                for intmax in (True, False):
                    bulk0 = flash_decode.launches_bulk
                    got = flash_decode(qd, kd, vd, ln, intmax=intmax)
                    torch.cuda.synchronize()
                    want = decode_ref(qd, kd, vd, ln, intmax=intmax)
                    err, held = parity_error(got, want)
                    check(got.dtype == dt and held <= tolerance(dt),
                          f"K5 S={S} G={G} {dtn} intmax={intmax}: max "
                          f"|err| {err}, held {held}")
                    check(flash_decode.launches_bulk == bulk0 + 1,
                          f"K5 S={S} G={G} {dtn}: not on the bulk route")
                    w = worst.get(dtn, (0.0, 0.0))
                    worst[dtn] = (max(w[0], err), max(w[1], held))
                    n += 1
    # off the rule: a bf16 row of 72 bytes takes the earlier kernel
    rng = np.random.default_rng(36)
    lens = [1, 31, 129, 300]
    q36 = _rand(rng, (len(lens), 3 * Hkv, 36), 36 ** -0.5).to(dev,
                                                               torch.bfloat16)
    k36, v36 = (_rand(rng, (len(lens), Hkv, 300, 36)).to(dev, torch.bfloat16)
                for _ in range(2))
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    bulk0 = flash_decode.launches_bulk
    got = flash_decode(q36, k36, v36, ln)
    torch.cuda.synchronize()
    err36, held36 = parity_error(got, decode_ref(q36, k36, v36, ln))
    check(flash_decode.launches_bulk == bulk0 and
          held36 <= tolerance(torch.bfloat16),
          f"K5 bf16 D 36: bulk launches {flash_decode.launches_bulk - bulk0}"
          f", held {held36}")
    # comparison launches do not count
    flash_decode.launches, flash_decode.launches_bulk = saved
    for dtn, (err, held) in sorted(worst.items()):
        print(f"[11] K5 vs plain, {dtn}: max |err| {err:.3g}, checked error "
              f"{held:.3g} <= {tolerance(getattr(torch, dtn))} ({n // 2} "
              f"cases, all on the bulk-copy route)")
    print(f"[11] K5 bf16 D 36 (off the rule) on the earlier kernel: max "
          f"|err| {err36:.3g}, checked {held36:.3g}; tile rows equal to "
          f"the wrapper's mirror")


def phase_static_parity(dev):
    """Reduced llama3.2-3b, float32: the static engine on the card against
    the same engine on the CPU and the paged engine on the card."""
    import numpy as np
    import torch
    from repro_torch.models.registry import (get_config, init_lm_params,
                                             reduce_config)
    from repro_torch.serve import ContinuousEngine, ServeEngine
    cfg = reduce_config(get_config("llama3.2-3b"))
    params = init_lm_params(cfg, torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(2).integers(
        1, cfg.vocab_size, (4, 20)).astype(np.int32)
    max_new = 10
    for kv, c in (("f32", cfg), ("int8", cfg.replace(opt_int8_kv=True))):
        streams = {}
        for d in ("cpu", dev):
            _reset_counts()
            res = ServeEngine(c, params, max_len=30, device=d).generate(
                prompts, max_new)
            counts = _all_counts()
            streams[str(d)] = res.tokens.tolist()
            want = (0, 0, 0, 0, c.n_layers * (max_new - 1)
                    if d != "cpu" and kv == "f32" else 0, 0, 0)
            check(counts == want, f"static {kv} on {d}: launches "
                                  f"K1-K7 {counts} != {want}")
        check(streams["cpu"] == streams[str(dev)],
              f"static {kv}: card and CPU greedy streams differ: {streams}")
        if kv == "f32":
            eng = ContinuousEngine(c, params, block_size=8, num_blocks=40,
                                   max_batch=4, max_len=32, device=dev)
            handles = [eng.submit(p, max_new) for p in prompts]
            res = eng.run()
            paged = [res[h.req_id].tokens for h in handles]
            check(paged == streams["cpu"],
                  f"static and paged greedy streams differ: {streams}, "
                  f"{paged}")
        print(f"[12] reduced llama3.2-3b static {kv}: card == cpu"
              f"{' == paged engine' if kv == 'f32' else ''} greedy streams,"
              f" K5 launches {counts[4]}")


class _StaticRecorder:
    """Wraps a ServeEngine's model steps: each step synced and timed on the
    host clock, its logits kept for the near-tie audit."""

    def __init__(self, eng):
        import torch
        self.eng, self.logits, self.prefill_ms, self.decode_ms = eng, [], 0, []

        def timed(fn, label):
            def run(*a):
                t0 = time.perf_counter()
                lg, cache = fn(*a)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                if label == "prefill":
                    self.prefill_ms = ms
                else:
                    self.decode_ms.append(ms)
                self.logits.append(lg.clone())
                return lg, cache
            return run

        eng._prefill = timed(eng._prefill, "prefill")
        eng._decode = timed(eng._decode, "decode")

    def close(self):
        del self.eng._prefill, self.eng._decode


def _paged_logits(eng):
    """Keep the logits behind every greedy token the paged engine samples,
    by (request id, token index): a prefill joining decode samples token 0
    of the newest row, a decode step token n_generated of every row."""
    rec, greedy = {}, eng._greedy

    def keep(lg):
        occ = [(i, r) for i, r in enumerate(eng._rows) if r is not None]
        if lg.shape[0] == 1:
            req = next(r for _, r in occ if r.n_generated == 0)
            rec[req.req_id, 0] = lg[0].clone()
        else:
            for i, r in occ:
                rec[r.req_id, r.n_generated] = lg[i].clone()
        return greedy(lg)

    eng._greedy = keep
    return rec


def _near_tie_audit(static, paged, s_logits, p_logits, vocab):
    """The static and paged greedy streams of each request, token by token.
    At the first token that differs both engines saw the same context; the
    flip is excused as a near-tie when, in each engine's own logits, the two
    diverging tokens lie within ``band`` of each other, where ``band`` is
    twice the largest |logit difference| between the engines at the steps
    before any divergence (the noise of their two summation orders).
    Returns (share of equal tokens, report lines); raises on a decisive
    flip."""
    import torch
    B, T = static.shape
    first = []
    noise = 0.0
    for b in range(B):
        t = next((i for i in range(T) if static[b, i] != paged[b][i]), T)
        first.append(t)
        for i in range(t):
            d = (s_logits[i][b, :vocab] - p_logits[b, i][:vocab]).abs()
            noise = max(noise, d.max().item())
    band = 2 * noise
    lines = [f"logit noise between the engines before any divergence "
             f"{noise:.4g} (band {band:.4g})"]
    equal = sum(int(static[b, i] == paged[b][i]) for b in range(B)
                for i in range(T))
    for b, t in enumerate(first):
        if t == T:
            continue
        ls, lp = s_logits[t][b, :vocab], p_logits[b, t][:vocab]
        a, c = int(static[b, t]), int(paged[b][t])
        gap_s, gap_p = (ls[a] - ls[c]).item(), (lp[c] - lp[a]).item()
        top_s, top_p = (torch.topk(x, 2).values for x in (ls, lp))
        lines.append(
            f"request {b}: first differing token at step {t} (static {a}, "
            f"paged {c}); top-2 gap static {(top_s[0] - top_s[1]).item():.4g}"
            f" paged {(top_p[0] - top_p[1]).item():.4g}; gap of the two "
            f"tokens static {gap_s:.4g} paged {gap_p:.4g}; max |logit diff| "
            f"at the step {(ls - lp).abs().max().item():.4g}")
        check(gap_s <= band and gap_p <= band,
              f"request {b} step {t}: a flip at a decisive logit gap "
              f"({gap_s:.4g}, {gap_p:.4g} > band {band:.4g})")
    return equal / (B * T), lines


def phase_static_full_width(dev):
    """Full-width llama3.2-3b in bf16, static engine: bf16 and int8 caches,
    then the same prompts through the paged engine. Returns the bf16 run's
    K5 launches.

    The attention projections are rescaled to their true fan-in
    (``_true_fan_in``): under the reference's init the attention scores
    reach a spread of ~200 (log2 units), each head attends to its top key
    alone, and a one-rounding difference between two keys' scores switches
    the key, so two summation orders give decisively different logits (a
    run with that init failed the near-tie audit: PERF.md, PR 13)."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_prefill_paged import flash_prefill_paged
    from repro_torch.models.lm import cast_matrix_params
    from repro_torch.models.registry import get_config, init_lm_params
    from repro_torch.serve import ContinuousEngine, ServeEngine
    cfg = get_config("llama3.2-3b")
    L = cfg.n_layers
    torch.cuda.empty_cache()
    params = cast_matrix_params(_true_fan_in(
        init_lm_params(cfg, torch.Generator(device=dev).manual_seed(0))),
        cfg.compute_dtype_)
    rng = np.random.default_rng(0)
    B, P, max_new = 8, 1024, 32
    max_len = P + max_new
    prompts = rng.integers(1, cfg.vocab_size, (B, P)).astype(np.int32)
    out = {}
    for kv, c in (("bf16", cfg), ("int8", cfg.replace(opt_int8_kv=True))):
        eng = ServeEngine(c, params, max_len=max_len, device=dev)
        rec = _StaticRecorder(eng)
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        res = eng.generate(prompts, max_new)
        wall = time.perf_counter() - t0
        counts = _all_counts()
        bulk = _route_counts()[0]
        rec.close()
        want = (0, 0, 0, 0, L * (max_new - 1) if kv == "bf16" else 0, 0, 0)
        check(counts == want, f"static {kv}: launches K1-K7 {counts} != "
                              f"{want}")
        check(bulk == counts[4], f"static {kv}: {bulk} of {counts[4]} K5 "
                                 "launches on the bulk-copy route")
        check(res.tokens.shape == (B, max_new) and
              ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all(),
              f"static {kv}: tokens {res.tokens}")
        check(all(torch.isfinite(lg).all().item() for lg in rec.logits),
              f"static {kv}: non-finite logits")
        print(f"[13] static {kv} cache: {B} requests x {max_new} tokens, "
              f"{B * max_new / wall:.1f} tok/s ({wall:.2f}s incl. prefill "
              f"{rec.prefill_ms:.0f} ms), {np.mean(rec.decode_ms):.2f} ms "
              f"per decode step (n={len(rec.decode_ms)}, synced), K5 "
              f"launches {counts[4]} ({counts[4] / (max_new - 1):.0f} per "
              f"decode step; {bulk} on the bulk-copy route), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        # where a decode step's time goes: 5 profiled steps after a prefill
        lg, cache = eng._prefill(torch.as_tensor(prompts, device=dev))
        state = [eng._sample(lg, None, 0.0), cache]

        def step():
            lg, state[1] = eng._decode(state[0], state[1])
            state[0] = eng._sample(lg, None, 0.0)

        print(f"[13] static {kv} cache " + step_profile(step, 5, "decode"))
        out[kv] = (res.tokens, rec.logits, counts[4])
        del eng, cache, state
        torch.cuda.empty_cache()

    # the same prompts and weights through the paged engine, one-shot
    eng = ContinuousEngine(cfg, params, block_size=16,
                           num_blocks=B * (max_len // 16 + 1) + 1,
                           max_batch=B, max_len=max_len, device=dev)
    p_logits = _paged_logits(eng)
    _reset_counts()
    handles = [eng.submit(p, max_new) for p in prompts]
    res = eng.run()
    k1 = _check_k1_bulk("paged one-shot (phase 13)")
    paged = [res[h.req_id].tokens for h in handles]
    p_logits = {(i, t): p_logits[h.req_id, t] for i, h in enumerate(handles)
                for t in range(max_new)}
    tokens, s_logits, k5 = out["bf16"]
    share, lines = _near_tie_audit(tokens, paged, s_logits, p_logits,
                                   cfg.vocab_size)
    n_equal = sum(tokens[b].tolist() == paged[b] for b in range(B))
    print(f"[13] static vs paged engine (bf16, one-shot prefill): "
          f"{share:.3f} of greedy tokens equal, {n_equal}/{B} streams "
          f"equal; K1 launches {k1}, all on the bulk-copy route")
    for line in lines:
        print("[13] near-tie audit: " + line)
    del eng, p_logits

    # the same prompts through the paged engine in 256-token chunks (K2),
    # on the tensor-core route and on the earlier kernel, each held to the
    # static engine's streams by the near-tie audit
    kw = dict(block_size=16, num_blocks=B * (max_len // 16 + 1) + 1,
              max_batch=B, max_len=max_len)
    eng = ContinuousEngine(cfg, params, prefill_chunk=256, device=dev, **kw)
    rec = _paged_logits(eng)
    _reset_counts()
    res = _drive(eng, prompts, max_new)[0]
    k2, k2_tc = _counts()[1], flash_prefill_paged.launches_tc
    _check_k1_bulk("paged chunked-256 (phase 13)")
    check(k2 == k2_tc == L * B * (P // 256),
          f"paged chunked-256: K2 launches {k2}, {k2_tc} on the tensor "
          f"cores")
    chunked = {"tensor cores": (
        np.array([r.tokens for r in res]),
        {(i, t): rec[r.req_id, t] for i, r in enumerate(res)
         for t in range(max_new)})}
    del eng, rec
    chunked["earlier K2 kernel"] = _chunked_on_earlier_k2(
        cfg, params, prompts, max_new, dev, **kw)
    for label, (toks, lg) in chunked.items():
        share, lines = _near_tie_audit(tokens, [list(t) for t in toks],
                                       s_logits, lg, cfg.vocab_size)
        n_equal = sum(tokens[b].tolist() == list(toks[b]) for b in range(B))
        print(f"[13] static vs paged engine (bf16, chunked-256, K2 on the "
              f"{label}): {share:.3f} of greedy tokens equal, {n_equal}/{B} "
              f"streams equal, K2 launches {k2}")
        for line in lines:
            print("[13] near-tie audit: " + line)
    del out, chunked, params
    torch.cuda.empty_cache()
    return k5


def phase_decode_times(dev, launches, n_layers):
    """K5 at the full-width decode shape: B 8, Hq 24, Hkv 8, 1056 cached
    rows, D 128, bf16."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import (bulk_tile_rows, decode_ref,
                                                  flash_decode, ops,
                                                  split_lanes)
    from repro_torch.kernels.parity import parity_error, tolerance
    rng = np.random.default_rng(3)
    B, Hq, Hkv, S, D = 8, 24, 8, 1056, 128
    bf = torch.bfloat16
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    q = _rand(rng, (B, Hq, D), D ** -0.5).to(dev, bf)
    k = _rand(rng, (B, Hkv, S, D)).to(dev, bf)
    v = _rand(rng, (B, Hkv, S, D)).to(dev, bf)
    ln = torch.full((B,), S, dtype=torch.int32, device=dev)
    saved = flash_decode.launches, flash_decode.launches_bulk
    got = flash_decode(q, k, v, ln)
    check(flash_decode.launches_bulk == saved[1] + 1,
          "K5 full-width shape: not on the bulk-copy route")
    err, held = parity_error(got, decode_ref(q, k, v, ln))
    check(held <= tolerance(bf), f"K5 full-width shape: {err} ({held})")
    # the earlier kernel on the same inputs (its route before the bulk copy)
    early, _ = ops._launch(q, k, v, ln, True, bulk=False)
    err_early = parity_error(early, got)[0]
    ms = _time_ms(lambda: flash_decode(q, k, v, ln), flush)
    earlier = _time_ms(lambda: ops._launch(q, k, v, ln, True, bulk=False),
                       flush)
    plain = _time_ms(lambda: decode_ref(q, k, v, ln), flush)
    ms2 = _time_ms(lambda: flash_decode(q, k, v, ln), flush)
    # timing launches do not count
    flash_decode.launches, flash_decode.launches_bulk = saved

    # the library yardstick: SDPA with scale ln 2 is the base-2 softmax of
    # the pre-scaled scores (IntMax changes no result in exact arithmetic;
    # every length is the cache's)
    def sdpa():
        return F.scaled_dot_product_attention(
            q[:, :, None], k, v, scale=math.log(2), enable_gqa=True)

    lib_err = parity_error(sdpa()[:, :, 0], got)[0]
    lib = _time_ms(sdpa, flush)
    nbytes = 2 * B * Hkv * S * D * 2 + 2 * q.numel() * 2 + B * 4
    lane_rows, n = split_lanes(B * Hkv, S, bulk_tile_rows(D, 2))
    print(f"[14] full-width decode shape, bf16: K5 vs plain max |err| "
          f"{err:.3g} (held {held:.3g} <= {tolerance(bf)}); SDPA vs K5 "
          f"{lib_err:.3g}; earlier kernel vs K5 {err_early:.3g}; {n} split "
          f"lanes of {lane_rows} rows")
    print(f"[14] K5 bulk-copy route {ms:.4f} / {ms2:.4f} ms, earlier kernel "
          f"{earlier:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} ms")
    row = _row("flash_decode", "flash_decode_bulk.cu",
               "src/repro/kernels/flash_decode/flash_decode.py:71",
               launches, n_layers, err, ms, plain, nbytes,
               4 * B * Hq * S * D, lib)
    row["earlier_ms"] = earlier
    return [row]


def _score_rows(shape, seed, scale, dev):
    """Scores (rows, V) with a fully masked row, a half-masked row, a row
    whose max is <= -17 and a row masked up front: masked and pad entries
    enter the fixed-point PowSum."""
    import numpy as np
    import torch
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    x *= scale
    if shape[0] > 3:
        x[0] = -1e9
        x[1, shape[1] // 2:] = -1e9
        x[2] -= 30.0
        x[3, :shape[1] // 3] = -1e9
    return torch.from_numpy(x).to(dev)


# K6 / K7 row shapes: the CPU tests', V off the 16-wide slice, and the two
# full-width shapes (llama3.2-3b prefill: 8 x 24 x 1024 rows of 1024;
# bert-base at seq 512, batch 16: 16 x 12 x 512 rows of 512)
PREFILL_ROWS = (8 * 24 * 1024, 1024)
BERT_ROWS = (16 * 12 * 512, 512)


def phase_softermax_parity(dev):
    """K6 and K7 against their plain versions on the card."""
    import torch
    from repro_torch.kernels.parity import parity_error, tolerance
    from repro_torch.kernels.softermax import (REG_CAP, softermax_rows,
                                               softermax_rows_ref)
    from repro_torch.kernels.softermax_quant import (softermax_quant_plain,
                                                     softermax_quant_ref,
                                                     softermax_quant_rows)
    saved = _softermax_counts(), _route_counts()
    # the route boundary (K6 and K7 share REG_CAP)
    shapes = [(4, 128), (8, 1024), (5, 300), (16, 64), (21, 130), (8, 37),
              (2, 16), (12, 200), (3, 1), PREFILL_ROWS, BERT_ROWS,
              (6, REG_CAP - 1), (6, REG_CAP), (6, REG_CAP + 1)]
    # the two-pass kernel's longer rows (K6 alone)
    k6_only = [(4, 4096), (4, 8192)]
    routes = {True: 0, False: 0}
    routes7 = {True: 0, False: 0}
    worst6, worst7, n7 = {}, 0.0, 0
    for shape in shapes + k6_only:
        x = _score_rows(shape, sum(shape), 4.0, dev)
        for dtn in ("float32", "bfloat16"):
            dt = getattr(torch, dtn)
            xd = x.to(dt)
            for intmax in (True, False):
                reg0 = softermax_rows.launches_reg
                got = softermax_rows(xd, intmax=intmax)
                torch.cuda.synchronize()
                reg = softermax_rows.launches_reg - reg0
                check(reg == int(shape[1] <= REG_CAP),
                      f"K6 {shape}: register-route launches {reg}")
                routes[bool(reg)] += 1
                want = softermax_rows_ref(xd.float(), intmax).to(dt)
                err, held = parity_error(got, want)
                check(held <= tolerance(dt) and
                      bool(torch.isfinite(got).all()),
                      f"K6 {shape} {dtn} intmax={intmax}: max |err| {err}, "
                      f"held {held}")
                w = worst6.get(dtn, (0.0, 0.0))
                worst6[dtn] = (max(w[0], err), max(w[1], held))
                del got, want
            if shape in k6_only:
                continue
            reg0 = softermax_quant_rows.launches_reg
            got = softermax_quant_rows(xd)
            torch.cuda.synchronize()
            reg = softermax_quant_rows.launches_reg - reg0
            check(reg == int(shape[1] <= REG_CAP),
                  f"K7 {shape}: register-route launches {reg}")
            routes7[bool(reg)] += 1
            check(bool(torch.equal(got, softermax_quant_plain(xd))),
                  f"K7 {shape} {dtn}: differs from softermax_quant_plain")
            ref_err = (got.float() - softermax_quant_ref(xd.float())) \
                .abs().max().item()
            check(ref_err <= 2 ** -7, f"K7 {shape} {dtn}: {ref_err} from "
                                      "softermax_fixed")
            worst7 = max(worst7, ref_err)
            n7 += 1
            del got, xd
        del x
        torch.cuda.empty_cache()
    # comparison launches do not count
    _set_softermax_counts(saved[0])
    _set_route_counts(saved[1])
    for dtn, (err, held) in sorted(worst6.items()):
        print(f"[15] K6 vs plain, {dtn}: max |err| {err:.3g}, checked error "
              f"{held:.3g} <= {tolerance(getattr(torch, dtn))} "
              f"({2 * len(shapes + k6_only)} cases)")
    print(f"[15] K6 routes: {routes[True]} cases on the register kernel (V "
          f"<= {REG_CAP}), {routes[False]} on the two-pass kernel")
    print(f"[15] K7 == softermax_quant_plain in all {n7} cases (f32, bf16; "
          f"up to {PREFILL_ROWS[0]} x {PREFILL_ROWS[1]}); max |K7 - "
          f"softermax_fixed| {worst7:.3g} <= 2^-7; {routes7[True]} cases on "
          f"the register kernel (V <= {REG_CAP}), {routes7[False]} on the "
          f"two-pass kernel")


def _set_softermax_counts(counts):
    from repro_torch.kernels.softermax import softermax_rows
    from repro_torch.kernels.softermax_quant import softermax_quant_rows
    softermax_rows.launches, softermax_quant_rows.launches = counts


def _set_route_counts(counts):
    """Restore ``_route_counts()``."""
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.softermax import softermax_rows
    from repro_torch.kernels.softermax_quant import softermax_quant_rows
    (flash_decode.launches_bulk, softermax_rows.launches_reg,
     softermax_quant_rows.launches_reg) = counts


def _logit_list_audit(a_tokens, b_tokens, a_logits, b_logits, vocab):
    """The near-tie audit of two static engines' runs (token arrays and the
    per-step logits of each)."""
    B, T = a_tokens.shape
    p_logits = {(b, t): b_logits[t][b] for b in range(B) for t in range(T)}
    return _near_tie_audit(a_tokens, [r.tolist() for r in b_tokens],
                           a_logits, p_logits, vocab)


def phase_fixed_reduced(dev):
    """Reduced llama3.2-3b, float32, softermax_fixed: the static engine on
    the card against the CPU's and the paged engine's; then three QAT steps
    of reduced bert-base on the card against the CPU."""
    import numpy as np
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.registry import (get_config, init_lm_params,
                                             reduce_config)
    from repro_torch.models.schema import tree_leaves, tree_map
    from repro_torch.serve import ServeEngine
    cfg = reduce_config(get_config("llama3.2-3b")).replace(
        softmax_impl="softermax_fixed")
    params = init_lm_params(cfg, torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(2).integers(
        1, cfg.vocab_size, (4, 20)).astype(np.int32)
    max_new = 10
    runs = {}
    for d in ("cpu", dev):
        eng = ServeEngine(cfg, params, max_len=30, device=d)
        rec = _StaticRecorder(eng)
        _reset_counts()
        res = eng.generate(prompts, max_new)
        counts = _all_counts()
        rec.close()
        want = (0, 0, 0, 0, 0, 0, 0) if d == "cpu" else \
            (0, 0, 0, 0, cfg.n_layers * (max_new - 1), 0, cfg.n_layers)
        check(counts == want, f"fixed-point static on {d}: launches K1-K7 "
                              f"{counts} != {want}")
        runs[str(d)] = (res.tokens, [lg.cpu() for lg in rec.logits])
    (ct, cl), (gt, gl) = runs["cpu"], runs[str(dev)]
    share, lines = _logit_list_audit(gt, ct, gl, cl, cfg.vocab_size)
    paged, p_logits, (k7, k7_reg) = _paged_run(
        cfg, params, prompts, max_new, dev, block_size=8, num_blocks=40)
    check(k7 == k7_reg == cfg.n_layers * len(prompts),
          f"paged fixed-point: K7 launches {k7} ({k7_reg} on the register "
          f"route) != {cfg.n_layers} x {len(prompts)} one-shot prefills")
    p_share, p_lines = _near_tie_audit(gt, paged, gl, p_logits,
                                       cfg.vocab_size)
    print(f"[16] reduced llama3.2-3b f32 softermax_fixed: card vs cpu static "
          f"engine {share:.3f} of greedy tokens equal, card static vs card "
          f"paged {p_share:.3f}; K7 launches {cfg.n_layers} per static "
          f"prefill, {k7} over {len(prompts)} paged prefills")
    for line in lines:
        print("[16] near-tie audit (card vs cpu): " + line)
    for line in p_lines:
        print("[16] near-tie audit (static vs paged): " + line)

    # three Softermax-aware finetuning steps of reduced bert-base
    bcfg = reduce_config(get_config("bert-base")).replace(
        causal=True, softmax_impl="softermax_fixed")
    init = init_lm_params(bcfg, torch.Generator().manual_seed(0))
    tc = TrainConfig(total_steps=3, warmup_steps=1, learning_rate=1e-4)
    out = {}
    for d in ("cpu", dev):
        _reset_counts()
        p = tree_map(lambda a: a.to(d, copy=True), init)
        data = SyntheticLMData(bcfg.vocab_size, 64, 16, seed=0)
        out[str(d)] = _train_run(bcfg, p, tc, 3, data), _softermax_counts()
    ((cp, crows), c_counts), ((gp, grows), g_counts) = \
        out["cpu"], out[str(dev)]
    check(c_counts == (0, 0) and g_counts == (0, 3 * bcfg.n_layers),
          f"bert QAT: K6/K7 launches cpu {c_counts} card {g_counts}")
    # The card's forward is K7, the CPU's softermax_fixed: they differ by
    # one Q(1,7) step where the running-max quantization ties
    # (kernels/softermax_quant/ref.py), and the STE gradient follows the
    # forward. On the CPU alone, swapping softermax_fixed's forward for
    # K7's mirror moves this run's losses and grad norms within the bounds
    # below (tests/test_torch_naive.py::test_qat_with_the_kernels_forward):
    # losses within 1e-3 at every step, the grad norm within 1e-3 at step 0
    # (same weights) and 2e-2 after, every parameter leaf within 1e-3 in
    # relative L2.
    rels = {}
    for s, (c, g) in enumerate(zip(crows, grows)):
        for key in ("loss", "ce", "grad_norm"):
            rel = abs(g[0][key] - c[0][key]) / abs(c[0][key])
            tol = 2e-2 if key == "grad_norm" and s > 0 else 1e-3
            rels[f"{key}[{s}]"] = rel
            check(rel <= tol, f"bert QAT step {s} {key}: card {g[0][key]}"
                              f" cpu {c[0][key]} (rel {rel} > {tol})")
    worst = max((torch.linalg.vector_norm(g.cpu() - c) /
                 torch.linalg.vector_norm(c)).item()
                for c, g in zip(tree_leaves(cp), tree_leaves(gp)))
    check(worst <= 1e-3, f"bert QAT: parameters differ by {worst}")
    print(f"[16] reduced bert-base softermax_fixed QAT, 3 steps: card vs cpu "
          f"relative differences " +
          ", ".join(f"{k} {v:.3g}" for k, v in rels.items()) +
          f" (losses {[round(r[0]['loss'], 5) for r in grows]}, grad norms "
          f"card {[round(r[0]['grad_norm'], 4) for r in grows]} cpu "
          f"{[round(r[0]['grad_norm'], 4) for r in crows]}), worst "
          f"parameter leaf rel L2 {worst:.3g} <= 1e-3, K7 launches "
          f"{g_counts[1]} ({bcfg.n_layers} per step)")


def _paged_run(cfg, params, prompts, max_new, dev, **kw):
    """The prompts through the paged engine (one-shot prefill): greedy
    streams, the logits behind each token by (prompt index, step), and the
    K7 launches of the run (all, and on the register route)."""
    from repro_torch.serve import ContinuousEngine
    B = len(prompts)
    max_len = len(prompts[0]) + max_new
    kw.setdefault("block_size", 16)
    kw.setdefault("num_blocks", B * (max_len // kw["block_size"] + 1) + 1)
    eng = ContinuousEngine(cfg, params, max_batch=B, max_len=max_len,
                           device=dev, **kw)
    rec = _paged_logits(eng)
    _reset_counts()
    handles = [eng.submit(p, max_new) for p in prompts]
    res = eng.run()
    k7 = _softermax_counts()[1], _route_counts()[2]
    paged = [res[h.req_id].tokens for h in handles]
    logits = {(i, t): rec[h.req_id, t].cpu() for i, h in enumerate(handles)
              for t in range(max_new)}
    return paged, logits, k7


def _full_width_llama(dev):
    """llama3.2-3b in bf16 with weights from torch.Generator("cuda") seed 0,
    the attention projections at their true fan-in (``_true_fan_in``: the
    reference's init would put every score past Q(6,2)'s range), and the
    prompts of phase 13."""
    import numpy as np
    import torch
    from repro_torch.models.lm import cast_matrix_params
    from repro_torch.models.registry import get_config, init_lm_params
    cfg = get_config("llama3.2-3b")
    params = cast_matrix_params(_true_fan_in(
        init_lm_params(cfg, torch.Generator(device=dev).manual_seed(0))),
        cfg.compute_dtype_)
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab_size, (8, 1024)).astype(np.int32)
    return cfg, params, prompts


def _static_run(cfg, params, prompts, max_new, dev, label, tag):
    """The prompts through the static engine: tokens, per-step logits (on
    the host) and the K1-K7 launches; prints a profile of one more prefill
    by kernel."""
    import numpy as np
    import torch
    from repro_torch.serve import ServeEngine
    B, P = prompts.shape
    eng = ServeEngine(cfg, params, max_len=P + max_new, device=dev)
    rec = _StaticRecorder(eng)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    res = eng.generate(prompts, max_new)
    wall = time.perf_counter() - t0
    counts = _all_counts()
    routes = _route_counts()
    rec.close()
    check(res.tokens.shape == (B, max_new) and
          ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all(),
          f"{label}: tokens {res.tokens}")
    check(all(torch.isfinite(lg).all().item() for lg in rec.logits),
          f"{label}: non-finite logits")
    print(f"[{tag}] {label}: {B} requests x {max_new} tokens, "
          f"{B * max_new / wall:.1f} tok/s ({wall:.2f}s incl. prefill "
          f"{rec.prefill_ms:.1f} ms), {np.mean(rec.decode_ms):.2f} ms per "
          f"decode step, launches K1-K7 {counts} (K5 on the bulk-copy route "
          f"{routes[0]}, K6 on the register route {routes[1]}, K7 on the "
          f"register route {routes[2]}), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    tokens = torch.as_tensor(prompts, device=dev)
    print(f"[{tag}] {label} " + step_profile(lambda: eng._prefill(tokens), 1,
                                              "prefill"))
    del eng
    torch.cuda.empty_cache()
    return res.tokens, [lg.cpu() for lg in rec.logits], counts, routes


def phase_fixed_full_width(dev):
    """Full-width llama3.2-3b, bf16, softermax_fixed: the static engine
    (K7 prefill, K5 decode), then the paged engine (one-shot prefills
    through K7, K1 decode), with the near-tie audit between them. Returns
    the static run's K7 launches."""
    import torch
    cfg, params, prompts = _full_width_llama(dev)
    cfg = cfg.replace(softmax_impl="softermax_fixed")
    L, max_new = cfg.n_layers, 32
    tokens, s_logits, counts, routes = _static_run(
        cfg, params, prompts, max_new, dev, "static softermax_fixed", 17)
    check(counts == (0, 0, 0, 0, L * (max_new - 1), 0, L),
          f"static softermax_fixed: launches K1-K7 {counts}")
    check(routes[2] == counts[6], f"static softermax_fixed: {routes[2]} of "
                                  f"{counts[6]} K7 launches on the register "
                                  "route")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    paged, p_logits, (k7, k7_reg) = _paged_run(cfg, params, prompts,
                                               max_new, dev)
    wall = time.perf_counter() - t0
    check(k7 == k7_reg == L * len(prompts),
          f"paged softermax_fixed: K7 launches {k7} ({k7_reg} on the "
          f"register route) != {L} x {len(prompts)} prefills")
    share, lines = _near_tie_audit(tokens, paged, s_logits, p_logits,
                                   cfg.vocab_size)
    n_equal = sum(tokens[b].tolist() == paged[b] for b in range(len(paged)))
    print(f"[17] paged softermax_fixed: {len(paged)} requests x {max_new} "
          f"tokens, {len(paged) * max_new / wall:.1f} tok/s, K7 launches "
          f"{k7} ({L} per one-shot prefill, {k7_reg} on the register "
          f"route), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    print(f"[17] static vs paged engine (softermax_fixed, bf16): {share:.3f} "
          f"of greedy tokens equal, {n_equal}/{len(paged)} streams equal")
    for line in lines:
        print("[17] near-tie audit: " + line)
    del params, s_logits, p_logits
    torch.cuda.empty_cache()
    return counts[6]


def phase_naive_full_width(dev):
    """Full-width llama3.2-3b, bf16: the naive attention path with the float
    Softermax (K6) against the flash path (K3), static engine. Returns the
    naive run's K6 launches."""
    import torch
    cfg, params, prompts = _full_width_llama(dev)
    L, max_new = cfg.n_layers, 32
    naive = cfg.replace(attention_impl="naive", softmax_impl="softermax")
    tokens, n_logits, counts, routes = _static_run(
        naive, params, prompts, max_new, dev, "static naive softermax", 18)
    check(counts == (0, 0, 0, 0, L * (max_new - 1), L, 0),
          f"static naive: launches K1-K7 {counts}")
    check(routes == (counts[4], counts[5], 0),
          f"static naive: K5 / K6 launches {counts[4:6]}, on the bulk-copy "
          f"and register routes {routes}")
    flash = cfg.replace(attention_impl="flash", softmax_impl="softermax")
    f_tokens, f_logits, f_counts, _ = _static_run(
        flash, params, prompts, max_new, dev, "static flash softermax", 18)
    check(f_counts == (0, 0, L, 0, L * (max_new - 1), 0, 0),
          f"static flash: launches K1-K7 {f_counts}")
    share, lines = _logit_list_audit(tokens, f_tokens, n_logits, f_logits,
                                     cfg.vocab_size)
    print(f"[18] naive (K6) vs flash (K3) static engine, bf16: {share:.3f} "
          f"of greedy tokens equal")
    for line in lines:
        print("[18] near-tie audit: " + line)
    del params, n_logits, f_logits
    torch.cuda.empty_cache()
    return counts[5]


def phase_bert_finetune(dev):
    """Full-width bert-base: the Table III workflow at seq 512, batch 16,
    then timed steps of the softermax_fixed and the softmax variant."""
    import numpy as np
    import torch
    from repro_torch.benchmarks.table3_accuracy import (finetune_variants,
                                                        report)
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.registry import get_config, model_fns
    from repro_torch.models.schema import tree_map
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step
    seq, batch = 512, 16
    base = get_config("bert-base").replace(causal=True,
                                           softmax_impl="softmax")
    torch.cuda.empty_cache()
    init = _true_fan_in(model_fns(base).init(
        torch.Generator(device=dev).manual_seed(0)))
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    res = finetune_variants(base, init, pretrain_steps=10, finetune_steps=5,
                            seq=seq, batch=batch)
    wall = time.perf_counter() - t0
    counts = _all_counts()
    k7_reg = _route_counts()[2]
    check(all(np.isfinite(v) for v in res.values()),
          f"bert-base Table III: losses {res}")
    check(counts[5] == 0 and counts[6] > 0 and k7_reg == counts[6],
          f"bert-base Table III: launches K1-K7 {counts}, K7 on the "
          f"register route {k7_reg}")
    print(f"[19] bert-base Table III workflow (seq {seq}, batch {batch}, 10 "
          f"pretrain + 3 x 5 finetune steps, 5 evals) in {wall:.1f}s, peak "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
          f"launches K1-K7 {counts} (K7 on the register route {k7_reg})")
    for line in report(res).splitlines():
        if line.strip():
            print("[19] " + line)

    # ms per step of each variant, from the same weights
    per_step = {}
    for impl in ("softermax_fixed", "softmax"):
        cfg = base.replace(softmax_impl=impl)
        tc = TrainConfig(total_steps=4, warmup_steps=1, learning_rate=1e-4)
        step = make_train_step(model_fns(cfg).loss, tc)
        params = tree_map(lambda a: a.clone(), init)
        opt = adamw.init_state(params)
        data = SyntheticLMData(cfg.vocab_size, seq, batch, seed=3)
        torch.cuda.reset_peak_memory_stats()
        ms, k7 = [], []
        for _ in range(4):
            b = next(data)
            c0 = _softermax_counts()[1], _route_counts()[2]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            k7.append(_softermax_counts()[1] - c0[0])
            check(_route_counts()[2] - c0[1] == k7[-1],
                  f"{impl} step: {_route_counts()[2] - c0[1]} of {k7[-1]} "
                  "K7 launches on the register route")
            check(np.isfinite(float(m["loss"])), f"{impl} step: {m}")
        per_step[impl] = (ms, k7, torch.cuda.max_memory_allocated())
        print(f"[19] bert-base {impl} step: {np.mean(ms[1:]):.1f} ms (steps "
              f"1-3; step 0 {ms[0]:.1f} ms), K7 launches per step {k7[1:]}, "
              f"peak memory {per_step[impl][2] / 2 ** 30:.2f} GiB")
        if impl == "softermax_fixed":
            state = [params, opt]
            b = next(data)

            def profiled():
                state[0], state[1], _ = step(state[0], state[1], b)

            print("[19] softermax_fixed " + step_profile(profiled, 1,
                                                         "training step"))
        del params, opt
        torch.cuda.empty_cache()
    k7 = per_step["softermax_fixed"][1]
    L = base.n_layers
    want = (2 if base.remat == "full" else 1) * L
    check(all(n == want for n in k7), f"softermax_fixed step: K7 launches "
                                      f"{k7} != {want} per step")
    check(all(n == 0 for n in per_step["softmax"][1]),
          "softmax step launched K7")
    del init
    torch.cuda.empty_cache()


def phase_softermax_times(dev, k6_launches, k7_launches, n_layers):
    """K6 and K7 at the full-width prefill shape and the bert shape, f32."""
    import torch
    from repro_torch.kernels.parity import parity_error
    from repro_torch.kernels.softermax import (ops, softermax_rows,
                                               softermax_rows_ref)
    from repro_torch.kernels.softermax_quant import ops as ops7
    from repro_torch.kernels.softermax_quant import (softermax_quant_plain,
                                                     softermax_quant_rows)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    saved = _softermax_counts(), _route_counts()
    rows = {}
    for label, shape in (("prefill", PREFILL_ROWS), ("bert", BERT_ROWS)):
        x = torch.randn(shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(4)) * 3
        x[:, shape[1] // 2:][::2] = -1e9      # causal-like masked halves
        nbytes = 2 * x.numel() * 4            # read once, written once
        reg0 = softermax_rows.launches_reg
        got = softermax_rows(x)
        check(softermax_rows.launches_reg == reg0 + 1,
              f"K6 {shape}: not on the register route")
        err6 = parity_error(got, softermax_rows_ref(x))[0]
        # the two-pass kernel on the same inputs (its route before)
        err_two = parity_error(ops._launch(x, True, reg=False)[0], got)[0]
        ms6 = _time_ms(lambda: softermax_rows(x), flush)
        two6 = _time_ms(lambda: ops._launch(x, True, reg=False), flush)
        plain6 = _time_ms(lambda: softermax_rows_ref(x), flush, iters=5)
        ms6b = _time_ms(lambda: softermax_rows(x), flush)
        # the library's row softmax on scores already in base 2 (the path
        # folds ln 2 into q): the factor costs no pass of its own in use
        xs = x * math.log(2)
        lib6 = _time_ms(lambda: torch.softmax(xs, dim=-1), flush)
        del xs
        reg0 = softermax_quant_rows.launches_reg
        got = softermax_quant_rows(x)
        check(softermax_quant_rows.launches_reg == reg0 + 1,
              f"K7 {shape}: not on the register route")
        mirror = softermax_quant_plain(x)
        err7 = (got - mirror).abs().max().item()
        check(err7 == 0.0, f"K7 {shape}: differs from its mirror by {err7}")
        # the two-pass kernel on the same inputs (its route before)
        err7_two = (ops7._launch(x, reg=False)[0] - mirror).abs().max() \
            .item()
        check(err7_two == 0.0, f"K7 two-pass kernel {shape}: differs from "
                               f"the mirror by {err7_two}")
        del mirror
        ms7 = _time_ms(lambda: softermax_quant_rows(x), flush)
        two7 = _time_ms(lambda: ops7._launch(x, reg=False), flush)
        plain7 = _time_ms(lambda: softermax_quant_plain(x), flush, iters=2)
        ms7b = _time_ms(lambda: softermax_quant_rows(x), flush)
        rows[label] = (
            dict(_row("softermax_rows", "softermax.cu",
                      "src/repro/kernels/softermax/softermax.py:81",
                      k6_launches, n_layers, err6, ms6, plain6, nbytes,
                      5 * x.numel(), lib6), earlier_ms=two6),
            dict(_row("softermax_quant_rows", "softermax_quant.cu",
                      "src/repro/kernels/softermax_quant/softermax_quant.py"
                      ":67", k7_launches, n_layers, err7, ms7, plain7,
                      nbytes, 20 * x.numel()), earlier_ms=two7))
        print(f"[20] {label} shape {shape}: K6 register route {ms6:.4f} / "
              f"{ms6b:.4f} ms (bound {rows[label][0]['bound_ms']:.4f}, "
              f"two-pass kernel {two6:.4f} (vs K6 {err_two:.3g}), plain "
              f"{plain6:.4f}, torch.softmax {lib6:.4f}); K7 register route "
              f"{ms7:.4f} / {ms7b:.4f} ms (bound "
              f"{rows[label][1]['bound_ms']:.4f}, two-pass kernel "
              f"{two7:.4f}, both EQUAL to the mirror; plain {plain7:.4f}, "
              f"no library call)")
        del x, got
        torch.cuda.empty_cache()
    # timing launches do not count
    _set_softermax_counts(saved[0])
    _set_route_counts(saved[1])
    out = []
    for i in (0, 1):
        row = dict(rows["prefill"][i])
        bert = rows["bert"][i]
        row["bert_shape"] = {k: bert[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err", "earlier_ms") if k in bert}
        out.append(row)
    return out


def _paged_counts():
    """(K1, K8) launch counts."""
    from repro_torch.kernels.flash_decode_paged import (
        flash_decode_paged, flash_decode_paged_single)
    return flash_decode_paged.launches, flash_decode_paged_single.launches


def _set_paged_counts(counts):
    from repro_torch.kernels.flash_decode_paged import (
        flash_decode_paged, flash_decode_paged_single)
    flash_decode_paged.launches, flash_decode_paged_single.launches = counts


def _paged_bulk_counts():
    """(K1, K8) launches on the bulk-copy routes."""
    from repro_torch.kernels.flash_decode_paged import (
        flash_decode_paged, flash_decode_paged_single)
    return (flash_decode_paged.launches_bulk,
            flash_decode_paged_single.launches_bulk)


def _set_paged_bulk_counts(counts):
    from repro_torch.kernels.flash_decode_paged import (
        flash_decode_paged, flash_decode_paged_single)
    (flash_decode_paged.launches_bulk,
     flash_decode_paged_single.launches_bulk) = counts


def _single_case(rng, dev, B, Hq, Hkv, D, BS, W, lens, kv, qdt):
    """Inputs of one K8 case: pools, a table whose entries past each row's
    block cover are garbage (other rows' blocks), lengths and queries."""
    import numpy as np
    import torch
    N = B * W + 1
    kp, vp, ks, vs = _pools(rng, N, Hkv, BS, D, kv, dev)
    bt = rng.permutation(np.arange(1, N)).reshape(B, W).astype(np.int32)
    for b, ln in enumerate(lens):             # garbage past the cover
        cover = -(-ln // BS)
        bt[b, cover:] = rng.integers(0, N, W - cover)
    q = _rand(rng, (B, Hq, D), D ** -0.5).to(dev, qdt)
    return (q, kp, vp, torch.from_numpy(bt).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev), ks, vs)


def phase_single_parity(dev):
    """K8 against its plain version and against K1, on the card."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_decode_paged import (
        flash_decode_paged, flash_decode_paged_single,
        paged_decode_single_plain)
    from repro_torch.kernels.flash_decode_paged import ops as paged_ops
    from repro_torch.kernels.parity import parity_error, tolerance
    saved = _paged_counts()
    bulk0 = _paged_bulk_counts()
    rng = np.random.default_rng(21)
    worst, n, n_k1 = {}, 0, 0
    kinds = [("float32", torch.float32), ("bfloat16", torch.bfloat16),
             ("int8", torch.float32), ("int8", torch.bfloat16)]
    cases = [(kv, qdt, G, BS, 2, 128, 7)
             for kv, qdt in kinds for G in (1, 3, 4, 8, 12) for BS in (8, 16)]
    cases += [(kv, qdt, 3, 16, 8, 128, 128) for kv, qdt in kinds]
    for kv, qdt, G, BS, Hkv, D, W in cases:
        if W == 7:
            lens = [0, 1, BS, 2 * BS + 5, 3 * BS, W * BS - 3]
        else:                                 # the full-width geometry
            lens = [0, 1, 16, 1023, 1024, 1025, 777, W * BS]
        B = len(lens)
        for intmax in (True, False):
            q, kp, vp, bt, ln, ks, vs = _single_case(
                rng, dev, B, G * Hkv, Hkv, D, BS, W, lens, kv, qdt)
            got = flash_decode_paged_single(q, kp, vp, bt, ln, k_scale=ks,
                                            v_scale=vs, intmax=intmax)
            early = paged_ops._launch_single(q, kp, vp, bt, ln, ks, vs,
                                             intmax, bulk=False)[0]
            torch.cuda.synchronize()
            want = paged_decode_single_plain(q, kp, vp, bt, ln, k_scale=ks,
                                             v_scale=vs, intmax=intmax)
            label = f"{kv}/q {str(qdt)[6:]}"
            for route, out in (("", got), (" (earlier kernel)", early)):
                err, held = parity_error(out, want)
                check(out.dtype == qdt and held <= tolerance(qdt),
                      f"K8{route} {label} G={G} BS={BS} W={W} intmax="
                      f"{intmax}: max |err| {err}, held {held}")
                check(bool(torch.all(out[0] == 0)), f"K8{route}: a row of "
                                                    "length 0 is not 0")
                w = worst.get(label + route, (0.0, 0.0))
                worst[label + route] = (max(w[0], err), max(w[1], held))
            n += 1
            if G > 8:                         # K1 holds groups up to 8
                continue
            for T, S in ((1, 1), (4, 2)):
                k1 = flash_decode_paged(q, kp, vp, bt, ln, k_scale=ks,
                                        v_scale=vs, intmax=intmax,
                                        kv_tile_blocks=T, split_k=S)
                err1, held1 = parity_error(got, k1)
                check(held1 <= tolerance(qdt) and
                      bool(torch.all(k1[0] == 0)),
                      f"K8 vs K1 {label} G={G} BS={BS} T={T} S={S}: max "
                      f"|err| {err1}, held {held1}")
                w = worst.get(label + " vs K1", (0.0, 0.0))
                worst[label + " vs K1"] = (max(w[0], err1), max(w[1], held1))
                n_k1 += 1
    bulk = [a - b for a, b in zip(_paged_bulk_counts(), bulk0)]
    check(bulk == [n_k1, n], f"K8 cases: {bulk} of K1 {n_k1} and K8 {n} "
                             "launches on the bulk-copy routes")
    _set_paged_counts(saved)              # comparison launches do not count
    _set_paged_bulk_counts(bulk0)
    for label, (err, held) in sorted(worst.items()):
        print(f"[21] K8 {'' if 'K1' in label else 'vs plain '}{label}: max "
              f"|err| {err:.3g}, checked error {held:.3g}")
    print(f"[21] {n} K8 cases against its plain version on both routes "
          f"(every one on the bulk-copy route, and the earlier kernel on the "
          f"same inputs), {n_k1} against K1 on its bulk-copy route "
          f"(tile, split) (1, 1) and (4, 2); tolerances: fp32 outputs "
          f"{tolerance(torch.float32)} absolute, bf16 outputs "
          f"{tolerance(torch.bfloat16)} of each element's size")


def phase_decode_bench(dev, card):
    """The ported decode_paged_bench's measuring function at the
    reference's defaults and at the full-width geometry, then each
    kernel's device time per launch and host enqueue time per call at the
    first step (the bench's events time whichever is longer). Returns the
    full-width run's (args, K8 launches)."""
    import numpy as np
    import torch
    from repro_torch.benchmarks import decode_paged_bench as bench
    from repro_torch.benchmarks.decode_host import FULL_BENCH, host_times
    from repro_torch.kernels.flash_decode_paged import (
        bulk_lanes, flash_decode_paged, flash_decode_paged_single)
    from repro_torch.kernels.flash_decode_paged import ops as paged_ops
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    out = None
    for label, argv in (("defaults", []), ("full-width", FULL_BENCH)):
        args = bench.parse_args(argv + ["--device", "cuda"])
        _reset_counts()
        single_s, grouped_s, meta = bench.time_kernels(
            args, np.random.default_rng(args.seed), dev)
        k1, k8 = _paged_counts()
        want = args.steps * (1 + args.repeats)
        check(k8 == want and k1 == want,
              f"decode bench {label}: launches K8 {k8}, K1 {k1} != {want}")
        check(_paged_bulk_counts() == (k1, k8),
              f"decode bench {label}: bulk-copy launches "
              f"{_paged_bulk_counts()} of K1 {k1}, K8 {k8}")
        toks = args.requests * args.steps
        dma = meta["gather_bytes_per_token_per_layer"]
        print(f"[22] decode_paged_bench {label} (hq {args.hq}, hkv "
              f"{args.hkv}, D {args.head_dim}, long row "
              f"{args.long_blocks * args.block_size} tokens, table width "
              f"{meta['table_width']}, tile {args.tile_blocks}, split "
              f"{args.split_k}, {args.steps} steps, best of "
              f"{args.repeats}): per-head K8 {toks / single_s:.1f} tok/s "
              f"({single_s * 1e3:.4f} ms), grouped K1 "
              f"{toks / grouped_s:.1f} tok/s ({grouped_s * 1e3:.4f} ms), "
              f"ratio {single_s / grouped_s:.3f}, modeled gather-bytes ratio "
              f"{dma['ratio']}; launches K8 {k8}, K1 {k1}; {card}")
        wl = bench.workload(args, np.random.default_rng(args.seed), dev)
        q, kp, vp, bt = wl["q"], wl["kp"], wl["vp"], wl["bt"]
        ln = wl["lens_steps"][0]
        saved, saved_bulk = _paged_counts(), _paged_bulk_counts()
        T, S = args.tile_blocks, args.split_k
        for name, fn in (
                ("K8", lambda: flash_decode_paged_single(q, kp, vp, bt, ln)),
                ("K8 earlier kernel", lambda: paged_ops._launch_single(
                    q, kp, vp, bt, ln, None, None, True, bulk=False)),
                ("K1", lambda: flash_decode_paged(
                    q, kp, vp, bt, ln, kv_tile_blocks=T, split_k=S)),
                ("K1 earlier kernel", lambda: paged_ops._launch(
                    q, kp, vp, bt, ln, None, None, True, T, S,
                    bulk=False))):
            host = host_times(fn)
            print(f"[22] decode_paged_bench {label} step 0: {name} device "
                  f"{_time_ms(fn, flush):.4f} ms per launch (L2 flushed, "
                  f"device wait before), host enqueue per call {host[0]:.4f} "
                  f"ms mean of 20 (collector on), {host[1]:.4f} ms median "
                  f"(collector off)")
        if label == "full-width":
            # the long row over more lanes: a layout knob
            sweep = _lane_sweep(q, kp, vp, bt, ln, T, S, LANE_SWEEP_LONG,
                                flush)
            print(f"[22] decode_paged_bench {label} step 0: K1 bulk-copy "
                  f"route by lanes a pair (the rule gives "
                  f"{bulk_lanes(q, kp, bt, T, S)}): {_sweep_text(sweep)}")
        _set_paged_counts(saved)          # timing launches do not count
        _set_paged_bulk_counts(saved_bulk)
        del wl, q, kp, vp, bt
        if label == "full-width":
            out = (args, k8)
    return out


def _autotune_engine(cfg, params, prompts, max_new, dev, mode):
    """The prompts through the paged engine under one autotune mode: greedy
    streams, the logits behind each token by (prompt index, step) on the
    host, K1/K8 launches, the decode steps and the engine."""
    from repro_torch.serve import ContinuousEngine, check_invariants
    eng = ContinuousEngine(cfg, params, block_size=16, num_blocks=2048,
                           max_batch=len(prompts),
                           max_len=max(len(p) for p in prompts) + max_new,
                           kv_tile_blocks=4, decode_split_k=2,
                           autotune=mode, device=dev)
    rec = _paged_logits(eng)
    _reset_counts()
    t0 = time.perf_counter()
    handles = [eng.submit(p, max_new) for p in prompts]
    res = eng.run()
    wall = time.perf_counter() - t0
    counts = _paged_counts()
    check_invariants(eng.pool, eng.prefix_cache)
    streams = [res[h.req_id].tokens for h in handles]
    logits = {(i, t): rec[h.req_id, t].float().cpu()
              for i, h in enumerate(handles) for t in range(max_new)}
    return streams, logits, counts, eng.metrics.decode_steps, wall, eng


def phase_autotune(dev, card):
    """Full-width autotune: off / static / per-step engines, then the
    modeled argmin against the measured fastest grid on a replay of
    autotune_bench's full-width trajectory."""
    import numpy as np
    import torch
    from repro_torch.benchmarks import autotune_bench
    from repro_torch.benchmarks.decode_host import FULL_GEOMETRY
    from repro_torch.kernels.flash_decode_paged import flash_decode_paged
    from repro_torch.serve.autotune import GridPlanner
    cfg, params, _ = _full_width_llama(dev)
    rng = np.random.default_rng(0)            # phase 5's prompts
    lens = rng.integers(128, 1025, 8)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    max_new, V = 32, cfg.vocab_size
    runs = {}
    for mode in ("off", "static", "per-step"):
        streams, logits, (k1, k8), n_dec, wall, eng = _autotune_engine(
            cfg, params, prompts, max_new, dev, mode)
        check(k1 == cfg.n_layers * n_dec and k1 > 0 and k8 == 0,
              f"autotune {mode}: launches K1 {k1} (decode steps {n_dec}), "
              f"K8 {k8}")
        check(all(len(s) == max_new for s in streams),
              f"autotune {mode}: a request did not finish")
        dec = "" if eng.planner is None else \
            f", decisions {eng.planner.summary()}"
        print(f"[23] autotune {mode}: grid (tile {eng.kv_tile_blocks}, "
              f"split {eng.decode_split_k}){dec}; {len(prompts)} requests x "
              f"{max_new} tokens in {wall:.2f}s, K1 launches {k1} "
              f"({n_dec} decode steps)")
        runs[mode] = (streams, logits)
        del eng
        torch.cuda.empty_cache()
    off, off_logits = runs["off"]
    tokens = np.array(off)
    s_logits = [torch.stack([off_logits[b, t] for b in range(len(off))])
                for t in range(max_new)]
    for mode in ("static", "per-step"):
        streams, logits = runs[mode]
        share, lines = _near_tie_audit(tokens, streams, s_logits, logits, V)
        print(f"[23] off vs {mode}: {share:.3f} of greedy tokens equal, "
              f"{sum(a == b for a, b in zip(off, streams))}/{len(off)} "
              f"streams equal")
        for line in lines:
            print(f"[23] off ('static') vs {mode} ('paged') near-tie audit: "
                  + line)
    del params, runs
    torch.cuda.empty_cache()

    # modeled argmin against the measured fastest grid
    args = autotune_bench.parse_args(FULL_GEOMETRY + ["--device", "cuda"])
    steps = autotune_bench.trajectory(args)
    cands = autotune_bench.candidates(args)
    planner = GridPlanner(cands, cost_params=autotune_bench.cost_params(args),
                          n_q_heads=args.hq, n_kv_heads=args.hkv,
                          head_dim=args.head_dim, block_size=args.block_size,
                          kv_dtype=args.kv_dtype)
    BS, B = args.block_size, args.requests
    blocks = [-(-int(max(ln[b] for ln, _ in steps)) // BS) for b in range(B)]
    W_max = max(w for _, w in steps)
    N = sum(blocks) + 1
    rng = np.random.default_rng(23)
    kp = _rand(rng, (N, args.hkv, BS, args.head_dim)).to(dev)
    vp = _rand(rng, (N, args.hkv, BS, args.head_dim)).to(dev)
    table = np.zeros((B, W_max), np.int32)
    nxt = 1
    for b, nb in enumerate(blocks):
        table[b, :nb] = np.arange(nxt, nxt + nb)
        nxt += nb
    table = torch.from_numpy(table).to(dev)
    q = _rand(rng, (B, args.hq, args.head_dim),
              args.head_dim ** -0.5).to(dev)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    saved = _paged_counts()
    sample = list(range(0, len(steps), 4))
    agree, picks, lines = 0, {}, []
    for i in sample:
        ln_np, w = steps[i]
        dec = planner.rank(ln_np, w)
        bt = table[:, :w].contiguous()
        ln = torch.from_numpy(ln_np.astype(np.int32)).to(dev)
        ms = {}
        for T, S in cands:
            ms[T, S] = _time_ms(lambda: flash_decode_paged(
                q, kp, vp, bt, ln, kv_tile_blocks=T, split_k=S), flush,
                iters=5)
        fastest = min(ms, key=ms.get)
        chosen = (dec.kv_tile_blocks, dec.split_k)
        agree += int(ms[chosen] == ms[fastest])
        key = f"t{chosen[0]}_s{chosen[1]}"
        picks[key] = picks.get(key, 0) + 1
        lines.append(f"step {i} (width {w}, longest {int(ln_np.max())}): "
                     f"modeled t{chosen[0]}_s{chosen[1]} "
                     f"{ms[chosen]:.4f} ms, measured fastest "
                     f"t{fastest[0]}_s{fastest[1]} {ms[fastest]:.4f} ms; "
                     + ", ".join(f"t{t}_s{s} {v:.4f}"
                                 for (t, s), v in sorted(ms.items())))
    _set_paged_counts(saved)              # timing launches do not count
    for line in lines:
        print("[23] trajectory " + line)
    print(f"[23] autotune_bench full-width trajectory ({len(steps)} steps, "
          f"{len(sample)} sampled, candidates {args.candidates}, machine "
          f"model cores {args.cores} flops/s {args.flops_per_s:g}): modeled "
          f"argmin is the measured fastest on {agree}/{len(sample)} steps; "
          f"modeled picks {picks}; {card}")


def phase_single_times(dev, bench_args, launches):
    """K8 at the phase-22 full-width shape (the first timed step)."""
    import numpy as np
    import torch
    from repro_torch.benchmarks import decode_paged_bench as bench
    from repro_torch.kernels.flash_decode_paged import (
        flash_decode_paged_single, paged_decode_single_plain)
    from repro_torch.kernels.flash_decode_paged import ops as paged_ops
    from repro_torch.kernels.parity import parity_error, tolerance
    wl = bench.workload(bench_args, np.random.default_rng(bench_args.seed),
                        dev)
    q, kp, vp, bt = wl["q"], wl["kp"], wl["vp"], wl["bt"]
    ln = wl["lens_steps"][0]
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    saved, saved_bulk = _paged_counts(), _paged_bulk_counts()
    got = flash_decode_paged_single(q, kp, vp, bt, ln)
    check(_paged_bulk_counts()[1] == saved_bulk[1] + 1,
          "K8 full-width shape: not on the bulk-copy route")
    want = paged_decode_single_plain(q, kp, vp, bt, ln)
    err, held = parity_error(got, want)
    check(held <= tolerance(q.dtype), f"K8 full-width shape: {err}")

    def earlier_k8():
        return paged_ops._launch_single(q, kp, vp, bt, ln, None, None, True,
                                        bulk=False)[0]

    err_early = parity_error(earlier_k8(), want)[0]
    ms = _time_ms(lambda: flash_decode_paged_single(q, kp, vp, bt, ln),
                  flush)
    earlier = _time_ms(earlier_k8, flush, iters=10)
    plain = _time_ms(lambda: paged_decode_single_plain(q, kp, vp, bt, ln),
                     flush, iters=2)
    ms2 = _time_ms(lambda: flash_decode_paged_single(q, kp, vp, bt, ln),
                   flush)
    _set_paged_counts(saved)              # timing launches do not count
    _set_paged_bulk_counts(saved_bulk)
    B, Hq, D = q.shape
    Hkv = kp.shape[1]
    rows = int(ln.sum().item())
    # K/V rows within the lengths read once per KV head (the least any
    # kernel of this function moves), q read and the output written once,
    # the tables and lengths
    nbytes = (2 * rows * Hkv * D * 4 + 2 * q.numel() * 4 + bt.numel() * 4
              + B * 4)
    row = _row("flash_decode_paged_single",
               "flash_decode_paged_single_bulk.cu",
               "src/repro/kernels/flash_decode_paged/"
               "flash_decode_paged.py:302", launches, 1, err, ms, plain,
               nbytes, 4 * Hq * rows * D)
    row.update(earlier_ms=earlier)
    print(f"[24] K8 at the full-width bench shape (B {B}, Hq {Hq}, Hkv "
          f"{Hkv}, D {D}, {rows} cached rows, table width {bt.shape[1]}, "
          f"f32 pool): bulk-copy route {ms:.4f} / {ms2:.4f} ms (bound "
          f"{row['bound_ms']:.4f} ms by {row['bound_by']}, earlier kernel on "
          f"the same inputs {earlier:.4f} ms, plain {plain:.4f} ms), max "
          f"|err| vs plain {err:.3g} (earlier kernel {err_early:.3g})")
    return [row]


BENCH_REPEATS = 2        # phase 25: rounds of each bench, cut from its
#                          default (3 until phase 30 joined the run)
FLEET_PROFILE_TICKS = 20  # phase 29: the fleet drive's profiled window is
#                          ticks [20, 40), full batches while requests
#                          still arrive (the drive takes 244 ticks)
FLEET_LAYERS = 4         # phase 29 (a)-(b): llama3.2-3b's first 4 of 28
#                          layers, to keep the whole smoke in its limit
#                          (8 until the smoke took 1,298 s on a slow host)
RESILIENCE_LAYERS = 8    # phase 28: llama3.2-3b's first 8 of 28 layers,
#                          for the same reason
OVERHEAD_ROUNDS = 5      # phase 27 (c): on/off rounds of the overhead check,
#                          the bench's default (9 until phase 37 joined)


def _prompt_logits(eng):
    """``_paged_logits`` of an engine that a bench's own function drives
    (the handles stay inside it): returns take(prompts, T), the logits
    behind each token by (index in ``prompts``, step) of the requests
    submitted since the last take, on the host."""
    import numpy as np
    rec = _paged_logits(eng)
    keys = {}
    submit = eng.submit

    def recording_submit(prompt, *a, **kw):
        req = submit(prompt, *a, **kw)
        keys[req.req_id] = np.asarray(prompt, np.int32).tobytes()
        return req

    eng.submit = recording_submit

    def take(prompts, T):
        by = {(keys[rid], t): lg for (rid, t), lg in rec.items()}
        out = {(i, t): by[np.asarray(p, np.int32).tobytes(), t].float().cpu()
               for i, p in enumerate(prompts) for t in range(T)}
        rec.clear()
        keys.clear()
        return out

    return take


def _stream_audit(tag, names, a, b, a_logits, b_logits, vocab):
    """Two runs' greedy streams (lists of token lists, one per request),
    named ``names``, held equal, or each first difference excused as a
    near-tie by ``_near_tie_audit`` on the logits behind them ((request,
    step) -> logits); raises on a decisive flip."""
    import numpy as np
    import torch
    T = len(a[0])
    s_logits = [torch.stack([a_logits[i, t] for i in range(len(a))])
                for t in range(T)]
    share, lines = _near_tie_audit(np.array(a), b, s_logits, b_logits, vocab)
    label = f"{names[0]} vs {names[1]}"
    print(f"{tag} {label}: {share:.3f} of greedy tokens equal, "
          f"{sum(x == y for x, y in zip(a, b))}/{len(a)} streams equal")
    for line in lines:      # the audit names its sides static and paged
        line = line.replace("static", "A").replace("paged", "B")
        print(f"{tag} {label} near-tie audit (A {names[0]}, B {names[1]}): "
              f"{line}")


def _check_k2_tc(label):
    from repro_torch.kernels.flash_prefill_paged import flash_prefill_paged
    k2, tc = flash_prefill_paged.launches, flash_prefill_paged.launches_tc
    check(k2 > 0 and tc == k2, f"{label}: {tc} of {k2} K2 launches on the "
                               "tensor-core route")
    return k2


def _check_k5_bulk(label):
    from repro_torch.kernels.flash_decode import flash_decode
    k5, bulk = flash_decode.launches, flash_decode.launches_bulk
    check(k5 > 0 and bulk == k5, f"{label}: {bulk} of {k5} K5 launches on "
                                 "the bulk-copy route")
    return k5


def _met(ok: bool) -> str:
    return "met" if ok else "missed"


def _bench_reps(tag, name, default):
    reps = min(default, BENCH_REPEATS)
    if reps < default:
        print(f"{tag} {name}: {reps} rounds (the bench's default "
              f"{default}, cut)")
    return reps


def phase_serving_benches(dev, card):
    """The four ported serving benches' own functions at their default
    workloads, at llama3.2-3b's full width in bf16 with the weights of
    ``_true_fan_in``: routes of every K1/K2/K5 launch, savings and
    capacity gated, streams equal or near-ties; speed ratios read."""
    import numpy as np
    import torch
    from repro_torch.benchmarks import (kv_int8_bench, prefill_paged_bench,
                                        prefix_cache_bench, serve_throughput)
    from repro_torch.serve import check_invariants
    tag = "[25]"
    t_phase = time.perf_counter()
    cfg, params, _ = _full_width_llama(dev)
    V = cfg.vocab_size

    # -- prefill_paged_bench: dense suffix against chunked (K2) ------------
    a = prefill_paged_bench.parse_args(["--device", "cuda"])
    reps = _bench_reps(tag, "prefill_paged_bench", a.repeats)
    prompts = prefill_paged_bench.make_docs(a.requests, a.shared_len,
                                            a.doc_len, V, a.seed)
    _reset_counts()
    dense_s, chunked_s, argmax_eq = prefill_paged_bench._time_op_paths(
        cfg, params, prompts[0], shared_len=a.shared_len,
        block_size=a.block_size, chunk=a.chunk, repeats=reps, device=dev)
    k2 = _check_k2_tc("prefill_paged_bench op paths")
    n_chunks = -(-a.doc_len // a.chunk)
    check(k2 == n_chunks * cfg.n_layers * (1 + reps),
          f"prefill_paged_bench op paths: {k2} K2 launches")
    ratio = dense_s / chunked_s
    print(f"{tag} prefill_paged_bench (requests {a.requests}, shared "
          f"{a.shared_len}, doc {a.doc_len}, chunk {a.chunk}, block "
          f"{a.block_size}, bf16): dense {dense_s:.4f} s "
          f"({a.doc_len / dense_s:.0f} tok/s), chunked {chunked_s:.4f} s "
          f"({a.doc_len / chunked_s:.0f} tok/s), ratio dense/chunked "
          f"{ratio:.3f} (the bench's >= 2 gate {_met(ratio >= 2)}: read "
          f"here, not gated), next-token argmax equal {argmax_eq}, "
          f"K2 launches {k2} (all on the tensor cores); {card}")
    S = a.shared_len + a.doc_len
    takes = {}
    _reset_counts()
    eq, metrics, outs = prefill_paged_bench._engine_equality(
        cfg, params, prompts, block_size=a.block_size,
        num_blocks=a.requests * ((S + a.max_new) // a.block_size + 2),
        max_batch=max(2, a.requests // 2), max_len=S + a.max_new,
        max_new=a.max_new, chunk=a.chunk, device=dev,
        on_engine=lambda eng, c: takes.__setitem__(c, _prompt_logits(eng)))
    k1 = _check_k1_bulk("prefill_paged_bench engines")
    k2 = _check_k2_tc("prefill_paged_bench engines")
    check(k2 == cfg.n_layers * metrics.prefill_chunks,
          f"prefill_paged_bench engines: {k2} K2 launches, "
          f"{metrics.prefill_chunks} chunks")
    print(f"{tag} prefill_paged_bench engines: one-shot and chunked-"
          f"{a.chunk} streams equal {eq}, prefill chunks "
          f"{metrics.prefill_chunks}, prefix hit tokens "
          f"{metrics.prefix_hit_tokens}, launches K1 {k1} K2 {k2}")
    _stream_audit(tag, ("prefill_paged_bench one-shot", "chunked"), outs[0],
                  outs[a.chunk], takes[0](prompts, a.max_new),
                  takes[a.chunk](prompts, a.max_new), V)
    del takes, outs
    torch.cuda.empty_cache()

    # -- kv_int8_bench: bf16 against int8 pools at one byte budget ---------
    a = kv_int8_bench.parse_args(["--device", "cuda", "--head-dim",
                                  str(cfg.head_dim_)])
    reps = _bench_reps(tag, "kv_int8_bench", a.repeats)
    budget, int8_blocks, cap = kv_int8_bench.equal_budget(
        cfg, a.block_size, a.bf16_blocks)
    check(cap >= 1.8, f"kv_int8_bench: capacity ratio {cap:.3f} < 1.8")
    engines, traj, conc = kv_int8_bench.make_engines(cfg, params, a,
                                                     int8_blocks, dev)
    prompts = kv_int8_bench.make_prompts(a.requests, a.prompt_len, V,
                                         a.seed)
    _reset_counts()
    walls, toks = kv_int8_bench.serve_rounds(engines, prompts, a.max_new,
                                             reps)
    k1 = _check_k1_bulk("kv_int8_bench")
    check(engines["int8"].metrics.preemptions == 0,
          "kv_int8_bench: the int8 engine preempted")
    total = a.requests * a.max_new
    tok_s = {kv: total / min(w) for kv, w in walls.items()}
    ratio = tok_s["int8"] / tok_s["bf16"]
    err = max(kv_int8_bench._logit_error_probe(cfg, params, p, dev)
              for p in prompts[:3])
    print(f"{tag} kv_int8_bench (requests {a.requests}, prompt "
          f"{a.prompt_len}, max_new {a.max_new}, block {a.block_size}, "
          f"head_dim {cfg.head_dim_}): budget {budget} bytes, bf16 "
          f"{a.bf16_blocks} blocks, int8 {int8_blocks}, capacity ratio "
          f"{cap:.3f}, trajectory {traj} blocks, concurrency {conc}; bf16 "
          f"{tok_s['bf16']:.1f} tok/s ({min(walls['bf16']):.3f} s), int8 "
          f"{tok_s['int8']:.1f} tok/s ({min(walls['int8']):.3f} s), ratio "
          f"int8/bf16 {ratio:.3f} (the bench's >= 1.3 gate "
          f"{_met(ratio >= 1.3)}: read here), max prefill "
          f"logit error {err:.4f} (the bench's <= {a.logit_tol} gate "
          f"{_met(err <= a.logit_tol)}: read here), K1 "
          f"launches {k1} (all on the bulk-copy route); {card}")
    logits = {}
    for kv, eng in engines.items():
        take = _prompt_logits(eng)
        _, again = kv_int8_bench._serve_once(eng, prompts, a.max_new)
        check(again == toks[kv], f"kv_int8_bench {kv}: a replay changed "
                                 "the streams")
        logits[kv] = take(prompts, a.max_new)
    _stream_audit(tag, ("kv_int8_bench bf16", "int8"), toks["bf16"],
                  toks["int8"], logits["bf16"], logits["int8"], V)
    del engines, logits
    torch.cuda.empty_cache()

    # -- prefix_cache_bench: cache on against off --------------------------
    a = prefix_cache_bench.parse_args(["--device", "cuda"])
    reps = _bench_reps(tag, "prefix_cache_bench", a.repeats)
    prompts = prefix_cache_bench.make_prompts(a.requests, a.shared_len,
                                              a.unique_len, V, a.seed)
    common = dict(block_size=a.block_size, num_blocks=a.num_blocks,
                  max_batch=a.max_batch,
                  max_len=a.shared_len + a.unique_len + a.max_new,
                  max_new=a.max_new, device=dev)
    eng_on, drive_on = prefix_cache_bench.make_driver(
        cfg, params, prompts, prefix_cache=True, **common)
    eng_off, drive_off = prefix_cache_bench.make_driver(
        cfg, params, prompts, prefix_cache=False, **common)
    take_on, take_off = _prompt_logits(eng_on), _prompt_logits(eng_off)
    _reset_counts()
    on_tok_s, off_tok_s, on_c, off_c = [], [], [], []
    for rnd in range(reps):
        t_off, d_off, e_off, c_off = drive_off()
        t_on, d_on, e_on, c_on = drive_on()
        off_tok_s.append(d_off / e_off)
        on_tok_s.append(d_on / e_on)
        off_c.append(c_off)
        on_c.append(c_on)
        n = len(prompts)
        _stream_audit(tag, (f"prefix_cache_bench round {rnd} off", "on"),
                      [t_off[i] for i in range(n)],
                      [t_on[i] for i in range(n)],
                      take_off(prompts, a.max_new),
                      take_on(prompts, a.max_new), V)
    k1 = _check_k1_bulk("prefix_cache_bench")
    check_invariants(eng_on.pool, eng_on.prefix_cache)
    savings = float(np.median(off_c) / np.median(on_c))
    ratio = float(np.median(on_tok_s) / np.median(off_tok_s))
    check(savings >= 1.8, f"prefix_cache_bench: savings {savings:.3f}")
    cs, m = eng_on.prefix_cache.stats, eng_on.metrics
    print(f"{tag} prefix_cache_bench (requests {a.requests}, shared "
          f"{a.shared_len}, unique {a.unique_len}, max_new {a.max_new}, "
          f"block {a.block_size}, {a.num_blocks} blocks, batch "
          f"{a.max_batch}): off {np.median(off_tok_s):.1f} tok/s, "
          f"{np.median(off_c):.0f} prefill tokens a round; on "
          f"{np.median(on_tok_s):.1f} tok/s, {np.median(on_c):.0f} prefill "
          f"tokens a round; prefill savings {savings:.3f} (engine "
          f"{m.prefill_savings:.3f}), hit rate {cs.hit_rate:.3f}, hit "
          f"tokens {cs.hit_tokens}, evictions {cs.evictions}, COW "
          f"{m.cow_copies}, shared-block peak {m.shared_blocks_peak}; "
          f"ratio on/off {ratio:.3f} (the bench's >= 1.3 gate "
          f"{_met(ratio >= 1.3)}: read here), K1 launches "
          f"{k1} (all on the bulk-copy route); {card}")
    print(f"{tag} prefix_cache_bench cache-on " + step_profile(
        drive_on, 1, "round (one drive, after the timed rounds)"))
    del eng_on, eng_off, drive_on, drive_off, take_on, take_off
    torch.cuda.empty_cache()

    # -- serve_throughput: paged (K1) against static slots (K5) ------------
    a = serve_throughput.parse_args(["--device", "cuda",
                                     "--no-overhead-check"])
    reps = _bench_reps(tag, "serve_throughput", a.repeats)
    budget = a.num_blocks * a.block_size
    slot_width = a.max_prompt + a.max_new
    slots = max(budget // slot_width, 1)
    wl = serve_throughput.make_workload(a.requests, a.rate, a.min_prompt,
                                        a.max_prompt, V, a.seed)
    static = serve_throughput.make_static_driver(
        cfg, params, wl, slots=slots, pad_len=a.max_prompt,
        max_new=a.max_new, device=dev)
    paged, peng = serve_throughput.make_paged_driver(
        cfg, params, wl, block_size=a.block_size, num_blocks=a.num_blocks,
        max_batch=a.max_batch, max_len=slot_width, max_new=a.max_new,
        device=dev)
    rec = _paged_logits(peng)
    _reset_counts()
    s_rounds, p_rounds, _, ratios, m, reqs = serve_throughput.run_rounds(
        static, paged, reps)
    k1 = _check_k1_bulk("serve_throughput paged")
    k5 = _check_k5_bulk("serve_throughput static")
    print(f"{tag} serve_throughput (requests {a.requests} at rate "
          f"{a.rate:g}/s, prompts {a.min_prompt}-{a.max_prompt}, max_new "
          f"{a.max_new}, block {a.block_size}, {a.num_blocks} blocks, batch "
          f"{a.max_batch}; budget {budget} tokens, {slots} static slots): "
          f"static {np.median(s_rounds):.1f} tok/s, paged "
          f"{np.median(p_rounds):.1f} tok/s, ratio paged/static "
          f"{np.median(ratios):.3f} (rounds "
          + ", ".join(f"{r:.3f}" for r in ratios) +
          f"); paged peak blocks {m.peak_blocks}, decode steps "
          f"{m.decode_steps}, preemptions {m.preemptions}; launches K1 {k1} "
          f"(all on the bulk-copy route), K5 {k5} (all on the bulk-copy "
          f"route); {card}")
    T = a.max_new
    logits = [{(i, t): rec[r.req_id, t].float().cpu() for i, r in
               enumerate(rs) for t in range(T)} for rs in reqs]
    for rnd in range(1, reps):
        _stream_audit(tag, ("serve_throughput paged round 0", f"round {rnd}"),
                      [r.tokens for r in reqs[0]],
                      [r.tokens for r in reqs[rnd]], logits[0],
                      logits[rnd], V)
    for name, drive in (("paged", paged), ("static", static)):
        print(f"{tag} serve_throughput {name} " + step_profile(
            drive, 1, "round (one drive, after the timed rounds)"))
    del static, paged, peng, rec, logits, params
    torch.cuda.empty_cache()
    print(f"{tag} phase time {time.perf_counter() - t_phase:.1f} s")


def phase_paper_tables(dev, card):
    """The paper's tables and figures on the card: Table IV and Fig. 5's
    model, Fig. 5's and Fig. 1's measured rows, the Table-I ablation, K6
    timed on Fig. 5's rows, and the quickstart (K6 and K3 against their
    plain versions)."""
    import torch
    from repro_torch.benchmarks import (fig1_breakdown, fig5_sweep,
                                        table1_bitwidth_ablation,
                                        table4_efficiency)
    from repro_torch.examples import quickstart
    from repro_torch.kernels.parity import F32_ATOL, parity_error
    from repro_torch.kernels.softermax import (softermax_rows,
                                               softermax_rows_ref)
    tag = "[26]"
    t_phase = time.perf_counter()
    for unit, r in table4_efficiency.run().items():
        print(f"{tag} table4 {unit}: area {r['area_ratio']:.3f} (paper "
              f"{r['paper_area']:.2f}), energy {r['energy_ratio']:.3f} "
              f"(paper {r['paper_energy']:.2f})")
    for r in fig5_sweep.run_model():
        print(f"{tag} fig5 model width {r['width']} seq {r['seq_len']}: "
              f"baseline {r['baseline_uj']:.2f} uJ, softermax "
              f"{r['softermax_uj']:.2f} uJ, ratio {r['ratio']:.3f}")
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    for r in fig5_sweep.run_measured(device=dev):
        x = fig5_sweep.rows_for(r["seq_len"], dev)
        _reset_counts()
        err = parity_error(softermax_rows(x), softermax_rows_ref(x))[1]
        check(err <= F32_ATOL, f"fig5 rows seq {r['seq_len']}: K6 error "
                               f"{err:.3g}")
        k6 = _time_ms(lambda: softermax_rows(x), flush)
        print(f"{tag} fig5 measured seq {r['seq_len']} (64 rows, f32): "
              f"two-pass softmax_e {r['two_pass_us']:.1f} us, softermax "
              f"scan {r['softermax_us']:.1f} us (plain, host clock around a "
              f"synced call); K6 {k6 * 1e3:.1f} us (CUDA events, L2 "
              f"flushed), error {err:.3g}; {card}")
    for r in fig1_breakdown.run(device=dev):
        print(f"{tag} fig1 seq {r['seq_len']} (H 16, D 64, f32): matmuls "
              f"{r['matmul_us']:.1f} us, softmax_e {r['softmax_e_us']:.1f} "
              f"us, softermax {r['softermax_us']:.1f} us, softmax share "
              f"{r['softmax_frac_baseline']:.3f} baseline, "
              f"{r['softmax_frac_softermax']:.3f} softermax; {card}")
    rows = table1_bitwidth_ablation.run(device=dev)
    cpu = table1_bitwidth_ablation.run(device="cpu")
    diff = max(abs(r[k] - c[k]) for r, c in zip(rows, cpu)
               for k in ("max_err", "mean_err"))
    for r in rows:
        print(f"{tag} table1 out_bits {r['out_bits']} unnormed_bits "
              f"{r['unnormed_bits']}: max_err {r['max_err']:.5f}, mean_err "
              f"{r['mean_err']:.6f}")
    print(f"{tag} table1 card rows against the CPU's: max difference "
          f"{diff:.3g}")
    _reset_counts()
    errs = quickstart.run(dev)
    k3, k6 = _flash_counts()[0], _softermax_counts()[0]
    check(k3 > 0 and k6 > 0, f"quickstart: launches K3 {k3}, K6 {k6}")
    check(errs["kernel"] <= F32_ATOL and errs["flash"] <= F32_ATOL,
          f"quickstart errors {errs}")
    print(f"{tag} quickstart: K6 error {errs['kernel']:.3g}, K3 error "
          f"{errs['flash']:.3g}, launches K3 {k3}, K6 {k6}; {card}")
    print(f"{tag} phase time {time.perf_counter() - t_phase:.1f} s")


def _telemetry_drive(eng, batches, max_new):
    """Each batch of prompts through ``submit`` and ``run``, the card
    synced after each; returns the streams in submission order and the
    synced wall time of the drive."""
    import torch
    streams = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches:
        handles = [eng.submit(p, max_new) for p in batch]
        res = eng.run()
        streams += [res[h.req_id].tokens for h in handles]
    torch.cuda.synchronize()
    return streams, time.perf_counter() - t0


def _quantile_text(tel, names=("ttft", "tpot", "e2e", "step")) -> str:
    parts = []
    for nm in names:
        q = tel.quantiles(nm)
        parts.append(f"{nm} p50/p90/p99 {q['p50'] * 1e3:.2f}/"
                     f"{q['p90'] * 1e3:.2f}/{q['p99'] * 1e3:.2f} ms "
                     f"(n={q['count']})")
    return ", ".join(parts)


def phase_telemetry(dev, card):
    """(M) Serving telemetry at llama3.2-3b's full width in bf16 with phase
    13's weights and phase 5's prompts: (a) a chunked-256 bf16 engine with
    per-step grid planning, telemetry off then on, streams equal, the
    registry held to EngineMetrics, the planner and the timeline, the
    Chrome trace and the exposition round trip; (b) an int8 one-shot
    engine with the numerics monitor on every prefill; (c)
    ``serve_throughput``'s telemetry-overhead rounds. Every K1 launch on
    the bulk-copy route, every K2 launch on the tensor cores."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.benchmarks import serve_throughput
    from repro_torch.serve import (ContinuousEngine, Telemetry,
                                   check_invariants, parse_prometheus_text)
    tag = "[27]"
    t_phase = time.perf_counter()
    cfg, params, _ = _full_width_llama(dev)
    V = cfg.vocab_size
    rng = np.random.default_rng(0)           # phase 5's prompts
    lens = rng.integers(128, 1025, 8)
    prompts = [rng.integers(1, V, n).astype(np.int32) for n in lens]
    resubmit = [np.concatenate([p[:len(p) // 2 + 3],
                                rng.integers(1, V, 40).astype(np.int32)])
                for p in prompts]
    max_new = 32
    base = dict(block_size=16, num_blocks=2048, max_batch=8,
                max_len=1024 + max_new)

    # -- (a) bf16 pool, chunked-256 prefill, per-step planning ------------
    tel = Telemetry(timeline=True, trace_requests=True)
    eng = ContinuousEngine(cfg, params, device=dev, prefill_chunk=256,
                           kv_tile_blocks=4, decode_split_k=2,
                           autotune="per-step", telemetry=tel, **base)
    eng.warmup()
    eng.telemetry = None
    _reset_counts()
    off, wall_off = _telemetry_drive(eng, (prompts, resubmit), max_new)
    _check_k1_bulk("telemetry off")
    _check_k2_tc("telemetry off")
    eng.telemetry = tel
    eng.reset()                  # the tree flushed, the telemetry zeroed
    _reset_counts()
    on, wall = _telemetry_drive(eng, (prompts, resubmit), max_new)
    k1 = _check_k1_bulk("telemetry on")
    k2 = _check_k2_tc("telemetry on")
    check_invariants(eng.pool, eng.prefix_cache)
    check(on == off, "telemetry changed a greedy stream: "
                     f"{sum(a == b for a, b in zip(on, off))}/{len(on)} "
                     "equal")
    m = eng.metrics
    check(m.prefix_hit_tokens > 0, "no prefix hit on the resubmit")
    check(k1 == cfg.n_layers * m.decode_steps and
          k2 == cfg.n_layers * m.prefill_chunks,
          f"launches K1 {k1}, K2 {k2}, decode steps {m.decode_steps}, "
          f"chunks {m.prefill_chunks}")
    snap = tel.registry.snapshot()
    for name, want in (("serve_decode_steps", m.decode_steps),
                       ("serve_prefill_chunks", m.prefill_chunks),
                       ("serve_tokens_out", m.tokens_out),
                       ("autotune_decisions_total", m.decode_steps),
                       ("serve_requests_finished_total", 2 * len(prompts))):
        check(snap[name] == want, f"{name} {snap[name]} != {want}")
    events = tel.timeline.events
    dma = sum(e["args"].get("dma_bytes", 0) for e in events)
    check(snap["kernel_dma_bytes_total"] == dma,
          f"kernel_dma_bytes_total {snap['kernel_dma_bytes_total']} != "
          f"the timeline's {dma}")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        tel.save_chrome_trace(str(path), meta={"arch": cfg.name})
        trace = json.loads(path.read_text())
    n_decode = sum(e["name"] == "decode" for e in trace["traceEvents"])
    check(n_decode == m.decode_steps and tel.timeline.dropped == 0,
          f"trace: {n_decode} decode slices, {m.decode_steps} steps")
    fams = parse_prometheus_text(tel.registry.prometheus_text())
    for mt in tel.registry:
        fam = fams[mt.name]
        if mt.kind == "histogram":
            got = [v for n, _, v in fam["samples"]
                   if n == f"{mt.name}_count"]
            check(got == [mt.count], f"exposition of {mt.name}")
        else:
            check(fam["samples"][0][2] == mt.value,
                  f"exposition of {mt.name}")
    step_sum = tel.h_step.sum
    ratio = tel.registry.get("autotune_pred_over_measured").value
    meas = tel.registry.get("autotune_measured_step_seconds")
    print(f"{tag} (a) chunked-256 bf16, per-step planning, {len(prompts)} "
          f"prompts of {lens.min()}-{lens.max()} tokens then a "
          f"shared-prefix resubmit, {max_new} new tokens: streams with "
          f"telemetry on equal off ({len(on)}/{len(on)}); launches K1 {k1} "
          f"(all on the bulk-copy route), K2 {k2} (all on the tensor "
          f"cores); decode steps {m.decode_steps}, chunks "
          f"{m.prefill_chunks}, prefix hit tokens {m.prefix_hit_tokens}; "
          f"trace {len(trace['traceEvents'])} events, {n_decode} decode "
          f"slices; exposition round trip over {len(fams)} families; "
          f"{card}")
    print(f"{tag} (a) " + _quantile_text(tel) + " (host dispatch stamps)")
    print(f"{tag} (a) summed step durations {step_sum:.3f} s, synced wall "
          f"time of the run {wall:.3f} s (telemetry off {wall_off:.3f} s); "
          f"planner: {int(snap['autotune_decisions_total'])} decisions ("
          + ", ".join(f"{k[len('autotune_choice_'):-len('_total')]} "
                      f"{int(v)}" for k, v in snap.items()
                      if k.startswith("autotune_choice_")) +
          f"), autotune_pred_over_measured {ratio:.3g} "
          f"(latest), predicted p50 "
          f"{snap['autotune_predicted_step_seconds']['p50'] * 1e6:.1f} us "
          f"against measured host step p50 {meas.quantile(0.5) * 1e3:.2f} "
          f"ms; kernel_dma_bytes_total {dma / 2 ** 20:.1f} MiB, "
          f"kernel_flops_total {snap['kernel_flops_total'] / 1e9:.2f} GFLOP")
    del eng, tel
    torch.cuda.empty_cache()

    # -- (b) int8 pool, one-shot prefill, numerics monitor ----------------
    tel = Telemetry(numerics_every=1, numerics_max_tokens=64)
    probes = []
    probe = tel.numerics_probe

    def keep_probe(engine, prompt):
        probes.append(probe(engine, prompt))
        return probes[-1]

    tel.numerics_probe = keep_probe
    eng = ContinuousEngine(cfg, params, device=dev, kv_dtype="int8",
                           telemetry=tel, **base)
    _reset_counts()
    streams, wall = _telemetry_drive(eng, (prompts,), max_new)
    k1 = _check_k1_bulk("int8 numerics run")
    check_invariants(eng.pool, eng.prefix_cache)
    m = eng.metrics
    n_tok = tel.registry.get("numerics_probe_tokens").value
    check(tel.c_probes.value == m.prefills == len(prompts) == len(probes),
          f"probes {tel.c_probes.value}, prefills {m.prefills}")
    check(n_tok <= 64 and int(n_tok) & (int(n_tok) - 1) == 0,
          f"numerics_probe_tokens {n_tok}")
    err = tel.registry.get("numerics_logit_error_max").value
    print(f"{tag} (b) int8 one-shot, numerics_every 1 over {int(n_tok)} "
          f"tokens: {int(tel.c_probes.value)} probes for {m.prefills} "
          f"prefills; max |full - int8| logit delta {err:.4f} (the "
          f"reference's reduced-model <= 0.1: read, not gated); "
          f"IntMax max "
          f"{tel.registry.get('numerics_score_intmax_max').value:.0f}, "
          f"IntMax overflow rows "
          f"{int(tel.c_intmax_overflow.value)}, Q(6,2) input clips "
          f"{int(sum(p['score_inp_clip_vals'] for p in probes))}, static "
          f"int8 scale saturated rows {int(tel.c_scale_sat.value)}, K/V "
          f"amax max {tel.registry.get('numerics_kv_amax_max').value:.2f}; "
          f"launches K1 {k1} (all on the bulk-copy route); "
          + _quantile_text(tel, ("ttft", "tpot")) + f"; {card}")
    del eng, tel
    torch.cuda.empty_cache()

    # -- (c) serve_throughput's telemetry-overhead rounds -----------------
    a = serve_throughput.parse_args(["--device", "cuda", "--engine",
                                     "paged"])
    # more rounds than the bench's default: single on/off pairs spread
    # wider than the gate's 5% budget, so the median is printed beside the
    # best-of
    reps = OVERHEAD_ROUNDS
    print(f"{tag} serve_throughput overhead check: {reps} rounds (the "
          f"bench's default {a.repeats})")
    wl = serve_throughput.make_workload(a.requests, a.rate, a.min_prompt,
                                        a.max_prompt, V, a.seed)
    paged, _ = serve_throughput.make_paged_driver(
        cfg, params, wl, block_size=a.block_size, num_blocks=a.num_blocks,
        max_batch=a.max_batch, max_len=a.max_prompt + a.max_new,
        max_new=a.max_new, device=dev)
    tel = Telemetry()
    _reset_counts()
    _, p_rounds, t_rounds, _, m, _ = serve_throughput.run_rounds(
        None, paged, reps, tel)
    k1 = _check_k1_bulk("serve_throughput overhead rounds")
    ratio = serve_throughput.report_telemetry(tel, t_rounds, p_rounds)
    print(f"{tag} (c) serve_throughput (requests {a.requests} at rate "
          f"{a.rate:g}/s, prompts {a.min_prompt}-{a.max_prompt}, max_new "
          f"{a.max_new}, block {a.block_size}, {a.num_blocks} blocks, batch "
          f"{a.max_batch}): telemetry_on_over_off {ratio:.3f} (the bench's "
          f">= 0.95 gate {_met(ratio >= 0.95)}: read here, not gated), "
          f"median of the paired ratios "
          f"{np.median([t / p for t, p in zip(t_rounds, p_rounds)]):.3f}, "
          f"rounds on/off tok/s "
          + ", ".join(f"{t:.1f}/{p:.1f}" for t, p in zip(t_rounds, p_rounds))
          + f"; K1 launches {k1} (all on the bulk-copy route); {card}")
    del paged, tel, params
    torch.cuda.empty_cache()
    print(f"{tag} phase time {time.perf_counter() - t_phase:.1f} s")


def _deltas_text(deltas) -> str:
    """Per-request readback deltas (workload order) with their max and
    p50."""
    import numpy as np
    errs = [e for _, e in sorted(deltas)]
    return (f"[{', '.join(f'{e:.3f}' for e in errs)}] max {max(errs):.3f} "
            f"p50 {float(np.median(errs)):.3f}")


def _bench_cli(tag, name, args, what, card, cwd=ROOT, tolerate=()):
    """The CLI of ``repro_torch.benchmarks.<name>`` with ``args`` (the
    reference's reduced defaults, ``what``) in a child process on the card.
    A gate it misses is printed (and recorded in ``ROADMAP.md``) when every
    miss starts with one of the prefixes in ``tolerate``; any other miss,
    or any other failure, ends the run."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", f"repro_torch.benchmarks.{name}", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=900)
    missed = out.stderr.rsplit("gates failed: ", 1)[-1].strip().split(
        "; ") if out.returncode else []
    check(out.returncode == 0 or (
        "gates failed: " in out.stderr and (
            tolerate and
            all(m.startswith(tuple(tolerate)) for m in missed))),
          f"{name} CLI exited {out.returncode}: {out.stderr[-3000:]}")
    prefix = name.split("_")[0] + ","
    for ln in out.stdout.splitlines():
        if ln.startswith(prefix):
            print(f"{tag} (d) CLI {ln}")
    verdict = "every gate met" if out.returncode == 0 else (
        "GATE MISSED: " + out.stderr.strip().splitlines()[-1])
    print(f"{tag} (d) {name} CLI {' '.join(args)} at the reference's "
          f"reduced defaults ({what}): {verdict}; "
          f"{time.perf_counter() - t0:.1f} s with its build; {card}")


def phase_resilience(dev, card):
    """(N) The serving engine's resilience layer at llama3.2-3b's full
    width, depth cut to ``RESILIENCE_LAYERS`` layers, in bf16 with phase
    13's weights and phase 5's prompts: (a) the
    clean readback audit deltas (one-shot and chunked-256, bf16 and int8
    pools) and what the reference's default thresholds would do with
    them; (b) the canned fault plan under the guard with thresholds
    derived from (a), chunked-256, bf16 pool; (c) the same storm
    unguarded; (d) ``resilience_bench``'s rounds at full width and its CLI
    at the reference's reduced defaults. Every K1 launch on the bulk-copy
    route, every K2 launch on the tensor cores (bf16 pools)."""
    import numpy as np
    import torch
    from repro_torch.benchmarks import resilience_bench as rb
    from repro_torch.serve import (ENGINE_FAULT_KINDS, ContinuousEngine,
                                   EngineGuard, FaultInjector, GuardConfig,
                                   canned_plan)
    from repro_torch.models.schema import tree_map
    tag = "[28]"
    t_phase = time.perf_counter()
    cfg, params, _ = _full_width_llama(dev)
    V = cfg.vocab_size
    # every drive depth cut: its thresholds come from its own clean audit
    print(f"{tag} llama3.2-3b at full width, depth cut to its first "
          f"{RESILIENCE_LAYERS} of {cfg.n_layers} layers")
    cfg = cfg.replace(n_layers=RESILIENCE_LAYERS)
    params = {**params, "blocks": tree_map(lambda a: a[:RESILIENCE_LAYERS],
                                           params["blocks"])}
    rng = np.random.default_rng(0)           # phase 5's prompts
    lens = rng.integers(128, 1025, 8)
    prompts = [rng.integers(1, V, n).astype(np.int32) for n in lens]
    max_new = 32
    base = dict(block_size=16, num_blocks=2048, max_batch=8,
                max_len=1024 + max_new, device=dev)
    default = GuardConfig()

    # -- (a) the clean audit ----------------------------------------------
    clean = {}
    for kv in ("bf16", "int8"):
        for chunk in (0, 256):
            eng = ContinuousEngine(
                cfg, params, prefill_chunk=chunk,
                kv_dtype=None if kv == "bf16" else kv,
                guard=EngineGuard(GuardConfig(**rb.NO_QUARANTINE)), **base)
            _reset_counts()
            deltas, _ = rb.audit_deltas(eng, prompts, max_new)
            k1 = _check_k1_bulk(f"clean audit {kv} chunk {chunk}")
            k2 = _check_k2_tc(f"clean audit {kv}") if chunk and \
                kv == "bf16" else None
            errs = [e for _, e in deltas]
            check(len(deltas) == len(prompts) and
                  all(math.isfinite(e) for e in errs),
                  f"clean audit {kv} chunk {chunk}: {deltas}")
            clean[kv, chunk] = errs
            n_q = sum(e >= default.quarantine_error for e in errs)
            n_d = sum(e >= default.logit_error_degraded for e in errs)
            print(f"{tag} (a) clean readback deltas, {kv} pool, "
                  f"{'chunked-256' if chunk else 'one-shot'}: "
                  f"{_deltas_text(deltas)}; the default GuardConfig "
                  f"(quarantine {default.quarantine_error}, degraded "
                  f"{default.logit_error_degraded}) would quarantine {n_q} "
                  f"of {len(errs)} clean requests and degrade on {n_d}; "
                  f"K1 {k1}" + (f", K2 {k2}" if k2 else "") + f"; {card}")
            del eng
            torch.cuda.empty_cache()
    clean_max = max(clean["bf16", 0] + clean["bf16", 256])
    config = rb.guard_config_for(clean_max)
    print(f"{tag} thresholds for the bf16 deployment (guard_config_for: "
          f"degraded at 2x and quarantine at 4x the largest clean bf16 "
          f"delta {clean_max:.3f}, never below the defaults): "
          f"logit_error_degraded {config.logit_error_degraded:.3f}, "
          f"quarantine_error {config.quarantine_error:.3f}")

    # -- (b) the canned plan under the guard, chunked-256, bf16 pool ------
    chunked = dict(base, prefill_chunk=256)
    eng = ContinuousEngine(cfg, params, **chunked)
    ff_logits = _paged_logits(eng)
    fault_free, reasons, dt_ff, _, _ = rb.drive(eng, prompts, max_new)
    check(set(reasons) == {"length"}, f"fault-free reasons {reasons}")
    del eng
    eng = ContinuousEngine(cfg, params, guard=EngineGuard(config),
                           **chunked)
    inj = FaultInjector(canned_plan())
    eng.attach_faults(inj)
    _reset_counts()
    streams, reasons, dt_g, checks, _ = rb.drive(eng, prompts, max_new,
                                                 check_each_step=True)
    k1 = _check_k1_bulk("guarded canned plan")
    k2 = _check_k2_tc("guarded canned plan")
    m = eng.metrics
    check(k1 == cfg.n_layers * m.decode_steps and
          k2 == cfg.n_layers * m.prefill_chunks,
          f"launches K1 {k1}, K2 {k2}, decode steps {m.decode_steps}, "
          f"chunks {m.prefill_chunks}")
    victims = [i for i, r in enumerate(reasons) if r == "quarantined"]
    corrupted = [e for e in inj.log if e["kind"] == "kv_corrupt" and
                 "req_id" in e]
    quarantines = [e for e in inj.log if e["kind"] == "quarantine"]
    check(len(victims) == 1 and m.quarantined == 1 and len(corrupted) == 1
          and quarantines[0]["req_id"] == corrupted[0]["req_id"],
          f"victims {victims}, corrupted {corrupted}, quarantines "
          f"{quarantines}")
    v = victims[0]
    check(quarantines[0]["purged_nodes"] > 0 and
          eng.prefix_cache.lookup(prompts[v]) == 0,
          f"victim {v}: {quarantines[0]['purged_nodes']} nodes purged, "
          f"lookup {eng.prefix_cache.lookup(prompts[v])}")
    mismatched = [i for i, (s, b) in enumerate(zip(streams, fault_free))
                  if i != v and s != b]
    check(not mismatched, f"guarded non-victim streams differ from the "
                          f"fault-free drive's: {mismatched}")
    kinds = {e["kind"] for e in inj.log}
    check(kinds >= set(ENGINE_FAULT_KINDS),
          f"fault kinds missing from the log: "
          f"{set(ENGINE_FAULT_KINDS) - kinds}")
    print(f"{tag} (b) canned plan + guard, chunked-256 bf16: victim "
          f"{v} (prompt {lens[v]} tokens, corrupted blocks "
          f"{len(corrupted[0]['blocks'])}, audited logit error "
          f"{quarantines[0]['logit_error']:.3f} against the bound "
          f"{config.quarantine_error:.3f}) quarantined, "
          f"{quarantines[0]['purged_nodes']} tree nodes purged; "
          f"{len(prompts) - 1}/{len(prompts) - 1} other streams equal the "
          f"fault-free drive's; invariants after each of {checks} steps, "
          f"0 leaked blocks; counters "
          + ", ".join(f"{k} {getattr(m, k)}" for k in (
              "cancelled", "deadline_misses", "quarantined", "shed",
              "faults_injected", "transient_retries", "readback_audits"))
          + f", preemptions {m.preemptions}; launches K1 {k1} (all on "
          f"the bulk-copy route), K2 {k2} (all on the tensor cores); "
          f"fault-free {dt_ff:.2f} s, guarded {dt_g:.2f} s; {card}")
    print(f"{tag} (b) guard transitions {eng.guard.transitions}; fault "
          f"log kinds {sorted(kinds)}")
    del eng

    # -- (c) the same storm unguarded --------------------------------------
    eng = ContinuousEngine(cfg, params, **chunked)
    inj = FaultInjector(canned_plan())
    eng.attach_faults(inj)
    pl_logits = _paged_logits(eng)
    _reset_counts()
    plain, _, _, checks, _ = rb.drive(eng, prompts, max_new,
                                      check_each_step=True)
    _check_k1_bulk("unguarded canned plan")
    _check_k2_tc("unguarded canned plan")
    divergent = [i for i, (s, b) in enumerate(zip(plain, fault_free))
                 if s != b]
    (cv,) = inj.corrupted_req_ids()   # fresh engines: id == position
    # the corrupted request's served logits at each decode step its stream
    # still agrees with the fault-free run's (the same context), against
    # the fault-free top-1 margin
    same = next((t for t, (a, b) in enumerate(zip(plain[cv],
                                                  fault_free[cv])) if a != b),
                max_new)
    deltas, margins = [], []
    for t in range(1, same):
        a, b = pl_logits[cv, t][:V].float(), ff_logits[cv, t][:V].float()
        deltas.append((a - b).abs().max().item())
        top = torch.topk(b, 2).values
        margins.append((top[0] - top[1]).item())
    print(f"{tag} (c) the same storm unguarded: corrupted request "
          f"{cv}, divergent workload positions {divergent} (first "
          f"differing token of each at " + ", ".join(
              str(next(t for t, (a, b) in enumerate(zip(
                  plain[i], fault_free[i])) if a != b)) for i in divergent)
          + f"; a stream diverges: {_met(bool(divergent))}, read); the "
          f"corrupted request's served decode logits against the "
          f"fault-free run's over its {len(deltas)} agreeing decode steps: "
          f"max |delta| min/median/max "
          + (f"{min(deltas):.1f}/{float(np.median(deltas)):.1f}/"
             f"{max(deltas):.1f}, the fault-free top-1 over top-2 margin "
             f"min/median {min(margins):.1f}/{float(np.median(margins)):.1f}"
             if deltas else "none")
          + f"; invariants after each of {checks} steps")
    check(divergent or min(deltas) >= config.quarantine_error,
          f"the unguarded corruption reached neither a stream nor the "
          f"served logits past the bound {config.quarantine_error:.3f}: "
          f"{deltas}")
    del eng
    torch.cuda.empty_cache()

    # -- (d) resilience_bench at the cut depth, then its CLI --------------
    a = rb.parse_args(["--device", "cuda", "--smoke"])
    bench_prompts = rb.make_workload(a.pairs, V, a.seed)
    eng = rb.build_engine(cfg, params, max_new=a.max_new, device=dev,
                          guard=EngineGuard(GuardConfig(**rb.NO_QUARANTINE)))
    deltas, _ = rb.audit_deltas(eng, bench_prompts, 1)
    del eng
    bench_config = rb.guard_config_for(
        max(clean_max, max(e for _, e in deltas)))
    print(f"{tag} (d) the bench's {len(bench_prompts)} prompts of "
          f"{rb.PREFIX_LEN + rb.TAIL_LEN} tokens, clean deltas "
          f"{_deltas_text(deltas)}; its thresholds: degraded "
          f"{bench_config.logit_error_degraded:.3f}, quarantine "
          f"{bench_config.quarantine_error:.3f}")
    engines = rb.build_engines(cfg, params, max_new=a.max_new, device=dev,
                               guard_config=bench_config)
    eng_base, eng_guard, _, eng_plain, inj_plain = engines
    _reset_counts()
    ratios, base_toks, tok_b, tok_g = rb.run_rounds(
        eng_base, eng_guard, bench_prompts, a.max_new, a.repeats)
    ver = rb.verify(eng_guard, eng_plain, inj_plain, bench_prompts,
                    a.max_new, base_toks)
    k1 = _check_k1_bulk("resilience_bench at the cut depth")
    # the ratio is read here; the unguarded-divergence gate is read too
    # (at full width the random weights' top-1 margin can exceed what the
    # corruption moves the logits, (c)); the other two are asserted
    failures = [f for f in rb.gate_failures(max(ratios), 0.0, ver)
                if not f.startswith("unguarded drive did not diverge")]
    best, med = max(ratios), float(np.median(ratios))
    print(f"{tag} (d) resilience_bench at {RESILIENCE_LAYERS} layers "
          f"({a.pairs} pairs, "
          f"{a.max_new} new tokens, block {rb.BLOCK_SIZE}, "
          f"{rb.NUM_BLOCKS} blocks, batch {rb.MAX_BATCH}, {a.repeats} "
          f"rounds, the bench's --smoke count): guarded/fault-free tok/s best-of {best:.3f}, median "
          f"{med:.3f} (the {a.min_ratio} gate {_met(best >= a.min_ratio)}: "
          f"read, not gated here), rounds "
          + ", ".join(f"{r:.3f}" for r in ratios)
          + f", last round {tok_b:.1f}/{tok_g:.1f} tok/s; victims "
          f"{ver['victims']}, non-victim mismatches {ver['mismatched']}, "
          f"unguarded divergent {ver['divergent']} (gate "
          f"{_met(bool(ver['divergent']))}: read), invariant checks "
          f"{ver['checks']}; K1 launches {k1} (all on the bulk-copy "
          f"route); {card}")
    check(not failures, f"resilience_bench at the cut depth: {failures}")
    del engines, eng_base, eng_guard, eng_plain, params
    torch.cuda.empty_cache()
    _bench_cli(tag, "resilience_bench", [], "qwen3-4b reduced, float32, 8 "
               "pairs, 96 new tokens, 3 rounds", card,
               tolerate=("guarded tok/s ratio",))
    print(f"{tag} phase time {time.perf_counter() - t_phase:.1f} s")


class _FleetLogits:
    """The logits behind every greedy token each replica of a fleet
    samples (``_paged_logits`` on each engine), mapped to FLEET stream
    positions: a submission whose prompt is a workload prompt plus ``k``
    emitted tokens (a failover's or a restore's recompute) samples
    positions ``k`` on. ``take(prompts, T)`` returns (index in ``prompts``,
    position) -> logits for the submissions since the last take, later
    submissions overriding earlier ones, and clears the record."""

    def __init__(self):
        self.subs, self.recs = [], []

    def install(self, eng):
        import numpy as np
        k = len(self.recs)
        self.recs.append(_paged_logits(eng))
        submit = eng.submit

        def recording_submit(prompt, *a, **kw):
            req = submit(prompt, *a, **kw)
            self.subs.append((k, req.req_id, np.asarray(prompt, np.int32)))
            return req

        eng.submit = recording_submit
        return eng

    def take(self, prompts, T):
        import numpy as np
        out = {}
        for k, rid, sp in self.subs:
            for i, p in enumerate(prompts):
                n0 = len(p)
                if len(sp) >= n0 and np.array_equal(sp[:n0], p):
                    base = len(sp) - n0
                    for t in range(T - base):
                        lg = self.recs[k].get((rid, t))
                        if lg is not None:
                            out[i, base + t] = lg
                    break
        for rec in self.recs:
            rec.clear()
        self.subs.clear()
        return out


def _streams_audit(tag, names, a, b, a_logits, b_logits, vocab):
    """``_stream_audit`` over the streams of full length (the others, and
    the finish reasons, must be equal); returns the streams that
    differ."""
    T = max(len(s) for s in a)
    idx = [i for i in range(len(a)) if len(a[i]) == T == len(b[i])]
    check(all(a[i] == b[i] for i in range(len(a)) if i not in idx),
          f"{tag} {names}: short streams differ")
    differ = [i for i in idx if a[i] != b[i]]
    if differ:
        _stream_audit(tag, names, [a[i] for i in idx], [b[i] for i in idx],
                      {(j, t): a_logits[i, t] for j, i in enumerate(idx)
                       for t in range(T)},
                      {(j, t): b_logits[i, t] for j, i in enumerate(idx)
                       for t in range(T) if (i, t) in b_logits}, vocab)
    else:
        print(f"{tag} {names[0]} vs {names[1]}: {len(a)}/{len(a)} streams "
              f"equal")
    return differ


def _k2_tc_if_any(label):
    """Every K2 launch since the counts were reset (if any) on the tensor
    cores; returns the launches."""
    from repro_torch.kernels.flash_prefill_paged import flash_prefill_paged
    return _check_k2_tc(label) if flash_prefill_paged.launches else 0


class _TickWindowProfile:
    """Profile the card (CUDA activity only) over supervision ticks
    [lo, hi) of the next fleet drive: ``FleetSupervisor.tick`` is wrapped
    while the context is open. ``line()`` gives the window's wall time a
    tick and the device-busy share."""

    def __init__(self, lo, hi):
        self.lo, self.hi, self.prof, self.wall = lo, hi, None, None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.serve import FleetSupervisor
        self.cls, self.orig = FleetSupervisor, FleetSupervisor.tick
        win = self

        def tick(sup):
            if sup.ticks == win.lo:
                torch.cuda.synchronize()
                win.prof = profile(activities=[ProfilerActivity.CUDA])
                win.prof.start()
                win.t0 = time.perf_counter()
            win.orig(sup)
            if sup.ticks == win.hi and win.prof is not None:
                torch.cuda.synchronize()
                win.wall = time.perf_counter() - win.t0
                win.prof.stop()

        FleetSupervisor.tick = tick
        return self

    def __exit__(self, *exc):
        self.cls.tick = self.orig

    def line(self, label):
        from torch.autograd import DeviceType
        if self.wall is None:
            return f"{label}: the drive ended before tick {self.hi}"
        busy = sum(e.time_range.elapsed_us() for e in self.prof.events()
                   if e.device_type == DeviceType.CUDA) / 1e6
        n = self.hi - self.lo
        if not busy:
            return f"{label}: device busy not measured (no CUDA events)"
        return (f"{label}, ticks {self.lo}-{self.hi - 1} under the profiler: "
                f"{1e3 * self.wall / n:.1f} ms a tick, device busy "
                f"{1e3 * busy / n:.2f} ms a tick "
                f"({100 * busy / self.wall:.1f}%)")


def _restore_case(rb, cfg, params, dev, case, tmp, max_new, n_req, seed,
                  guard_config, logits):
    """One of ``restore_bench``'s kill cases at full width, in process: the
    uninterrupted run, then a run with a snapshot a tick and a journal up
    to the kill condition, abandoned there unflushed, then the warm
    restore from its files driven to drain. Returns what the phase
    prints and checks."""
    import os
    import torch
    from repro_torch.serve import Journal, Snapshot, apply_snapshot
    vocab = cfg.vocab_size
    adir = os.path.join(tmp, case)
    os.makedirs(adir)
    arrivals = rb.case_workload(case, vocab, seed, n_req)
    prompts = [p for _, p in sorted(arrivals, key=lambda a: a[0])]
    base = rb.make_factory(cfg, params, case, max_new, device=dev,
                           guard_config=guard_config)

    def factory():
        return logits.install(base())

    ref_sup = rb.drive(rb.build_fleet(factory, case), arrivals, max_new)
    ref = rb.streams_of(ref_sup)
    ref_logits = logits.take(prompts, max_new)
    check(ref_sup.c_crashed.value == 0 and ref_sup.c_hung.value == 0,
          f"{case}: a replica died in the uninterrupted run")
    sup = rb.build_fleet(
        factory, case, journal=Journal(
            path=os.path.join(adir, "journal.jsonl"),
            fsync="always" if case == "postquarantine" else "interval",
            fsync_every=4),
        snapshot_dir=os.path.join(adir, "snaps"), snapshot_every=1)
    writes = []
    save = sup.save_snapshots

    def timed_save():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        infos = save()
        writes.append((time.perf_counter() - t0, infos[0]["nbytes"]))
        return infos

    sup.save_snapshots = timed_save
    rb.drive(sup, arrivals, max_new, kill_case=case, stop_at_kill=True)
    check(rb.kill_condition(case, sup) and sup.c_crashed.value == 0,
          f"{case}: the kill condition does not hold")
    eng = sup.replicas[0].engine
    bits = [getattr(eng.pool, n).view(torch.int16).cpu() for n in ("k", "v")
            ] if eng.pool.k.dtype == torch.bfloat16 else None
    killed_at = sup.ticks
    del sup, eng                                  # abandoned, unflushed
    kill_logits = logits.take(prompts, max_new)
    spath = os.path.join(adir, "snaps", "replica0.snap")
    t0 = time.perf_counter()
    snap = Snapshot.read(spath)
    t_read = time.perf_counter() - t0
    fresh = base()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    apply_snapshot(fresh, snap)
    torch.cuda.synchronize()
    t_apply = time.perf_counter() - t0
    if bits is not None:
        check(all(torch.equal(getattr(fresh.pool, n).view(torch.int16).cpu(),
                              b) for n, b in zip(("k", "v"), bits)) and
              all(torch.equal(snap.sections[f"pool.{n}"].view(torch.int16),
                              b) for n, b in zip(("k", "v"), bits)),
              f"{case}: the bf16 pool's bits changed in the round trip")
    del fresh, snap
    got_sup, info = rb.recover(
        factory, case, adir, arrivals, max_new,
        snapshot_dir=os.path.join(adir, "snaps"),
        journal_out=os.path.join(adir, "recovered.jsonl"))
    check(got_sup.c_crashed.value == 0, f"{case}: a replica died")
    got = rb.streams_of(got_sup)
    # requests terminal before the kill keep the killed run's logits
    got_logits = {**kill_logits, **logits.take(prompts, max_new)}
    check(info["mode"] == "warm" and info["leaked"] == 0 and
          info["journal_matches_streams"] and set(got) == set(ref) and
          all(got[r][1] == ref[r][1] for r in ref),
          f"{case}: restore {info['mode']} ({info['reason']}), leaked "
          f"{info['leaked']}, journal {info['journal_matches_streams']}, "
          f"reasons {[(ref[r][1], got.get(r, (0, ''))[1]) for r in ref]}")
    rids = sorted(ref)
    differ = _streams_audit(f"[29] (c) {case}", ("uninterrupted",
                                                 "restored"),
                            [ref[r][0] for r in rids],
                            [got[r][0] for r in rids], ref_logits,
                            got_logits, vocab)
    return {"ref": ref, "ref_logits": ref_logits, "info": info,
            "kill_logits": kill_logits,
            "writes": writes, "t_read": t_read, "t_apply": t_apply,
            "killed_at": killed_at, "differ": differ, "adir": adir,
            "arrivals": arrivals, "prompts": prompts,
            "reasons": sorted({w for _, w in ref.values()})}


def phase_fleet(dev, card):
    """(O) Fleet and durability at llama3.2-3b's full width in bf16 with
    phase 13's weights (depth cut to ``FLEET_LAYERS`` in (a) and (b)), one
    copy shared by every replica: (a)
    ``fleet_bench``'s default workload through the bench's own functions
    (single, fleet, round-robin, chaos under the canned fleet plan with
    the journal and the invariants every tick), its gates, streams equal
    or excused by the near-tie audit, the plan's crash and hang and no
    other death, wall tok/s and the card's busy share; (b) the chaos drive
    on one thread against the threaded one; (c) ``restore_bench``'s three
    kill cases in process (snapshot a tick, journal, abandon at the kill
    condition, warm restore), the corrupted snapshot's cold fallback, warm
    against cold, snapshot bytes and write/read/restore times, a bf16
    pool's bits through the round trip; (d) the two CLIs at the
    reference's reduced defaults in child processes. Every K1 launch on
    the bulk-copy route, every bf16 K2 launch on the tensor cores."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.benchmarks import fleet_bench as fb
    from repro_torch.benchmarks import resilience_bench as rsb
    from repro_torch.benchmarks import restore_bench as rb
    from repro_torch.models.schema import tree_map
    from repro_torch.serve import (FaultInjector, GuardConfig, Journal,
                                   requeue_inflight)
    tag = "[29]"
    t_phase = time.perf_counter()
    cfg, params, _ = _full_width_llama(dev)
    V = cfg.vocab_size
    # the fleet drives, depth cut: their gates are counts
    fcfg = cfg.replace(n_layers=FLEET_LAYERS)
    fparams = {**params, "blocks": tree_map(lambda a: a[:FLEET_LAYERS],
                                            params["blocks"])}
    print(f"{tag} (a)-(b) llama3.2-3b at full width, depth cut to its "
          f"first {FLEET_LAYERS} of {cfg.n_layers} layers")

    # -- (a) fleet_bench at its default workload ---------------------------
    a = fb.parse_args(["--device", "cuda"])
    arrivals = fb.make_workload(a.tenants, a.per_tenant, a.mean_gap, V,
                                a.seed)
    prompts = [p for _, p in arrivals]
    n_req, T = len(arrivals), a.max_new
    logits = _FleetLogits()
    engines = [logits.install(e) for e in fb.build_engines(
        fcfg, fparams, a.replicas, a.max_new, device=dev)]

    def reset():
        for e in engines:
            if e.sched.has_work():       # a crashed replica's abandoned work
                requeue_inflight(e)
            e.reset()

    def alive(sup, label):
        check(sup.c_crashed.value == 0 and sup.c_hung.value == 0,
              f"{label}: a replica died ({sup.c_crashed.value} crashed, "
              f"{sup.c_hung.value} hung) without a plan")

    sup_1, treqs_1, dt_1 = fb.drive(engines[:1], arrivals, T)
    alive(sup_1, "single")
    logits.take(prompts, T)
    engines[0].reset()
    _reset_counts()
    with _TickWindowProfile(FLEET_PROFILE_TICKS, 2 * FLEET_PROFILE_TICKS
                            ) as window:
        sup_n, treqs_n, dt_n = fb.drive(engines, arrivals, T)
    alive(sup_n, "fleet")
    k1 = _check_k1_bulk("fleet drive")
    k2 = _k2_tc_if_any("fleet drive")
    steps = sum(e.metrics.decode_steps for e in engines)
    check(k1 == fcfg.n_layers * steps,
          f"fleet drive: K1 {k1} launches, {steps} decode steps")
    fleet_logits = logits.take(prompts, T)
    toks_1, toks_n = fb.delivered(treqs_1), fb.delivered(treqs_n)
    tpt_1, tpt_n = toks_1 / sup_1.ticks, toks_n / sup_n.ticks
    scaling = tpt_n / tpt_1
    ref_streams = [list(t.result.tokens) for t in treqs_n]
    aff_hits = fb.hit_rate(sup_n)
    print(f"{tag} (a) fleet_bench default workload ({a.replicas} replicas, "
          f"{a.tenants} tenants x {a.per_tenant}, prefix {fb.PREFIX_LEN} + "
          f"tail {fb.TAIL_LEN}, {T} new, block {fb.BLOCK_SIZE}, "
          f"{fb.NUM_BLOCKS} blocks, batch {fb.MAX_BATCH}): tok/tick single "
          f"{tpt_1:.3f} ({sup_1.ticks} ticks), fleet {tpt_n:.3f} "
          f"({sup_n.ticks} ticks), ratio {scaling:.3f} (gate >= "
          f"{a.min_scaling}); wall tok/s single {toks_1 / dt_1:.1f}, fleet "
          f"{toks_n / dt_n:.1f} (read; the fleet drive's wall includes "
          f"its profiled window); K1 {k1} launches (all on the bulk-copy "
          f"route), K2 {k2}; {card}")
    print(window.line(f"{tag} (a) fleet drive") + f"; {card}")
    del window
    reset()
    # one thread: the routing and the streams do not depend on it ((b)),
    # and threaded ticks cost the host more than serial ones
    sup_rr, treqs_rr, dt_rr = fb.drive(engines, arrivals, T,
                                       policy="round-robin",
                                       step_parallel=False)
    alive(sup_rr, "round-robin")
    rr_logits = logits.take(prompts, T)
    rr_hits = fb.hit_rate(sup_rr)
    rr_streams = [list(t.result.tokens) for t in treqs_rr]
    print(f"{tag} (a) routing: affinity hit rate {aff_hits:.4f}, "
          f"round-robin {rr_hits:.4f}; round-robin (one thread) wall tok/s "
          f"{fb.delivered(treqs_rr) / dt_rr:.1f}")
    rr_differ = _streams_audit(f"{tag} (a)", ("fleet affinity",
                                              "fleet round-robin"),
                               ref_streams, rr_streams, fleet_logits,
                               rr_logits, V)
    reset()
    plan, mid = fb.chaos_plan(sup_n.ticks, a.replicas)
    n_crash = sum(s.kind == "replica_crash" for s in plan.specs)
    n_hang = sum(s.kind == "replica_hang" for s in plan.specs)
    tmp = tempfile.mkdtemp(prefix="smx_fleet_")
    jpath = f"{tmp}/chaos.jsonl"
    journal = Journal(path=jpath)
    _reset_counts()
    sup_c, treqs_c, dt_c = fb.drive(engines, arrivals, T,
                                    faults=FaultInjector(plan),
                                    journal=journal, check_each_tick=True)
    journal.close()
    k1c = _check_k1_bulk("chaos drive")
    chaos_logits = logits.take(prompts, T)
    chaos = fb.chaos_verdict(sup_c, treqs_c, journal, ref_streams, jpath)
    check(sup_c.c_crashed.value == n_crash and
          sup_c.c_hung.value == n_hang,
          f"chaos: {sup_c.c_crashed.value} crashed (plan {n_crash}), "
          f"{sup_c.c_hung.value} hung (plan {n_hang})")
    ttft = sup_c.tracker.h_ttft
    failures = [f for f in fb.gate_failures(
        scaling, a.min_scaling, aff_hits, rr_hits, rr_streams, ref_streams,
        chaos, ttft.count, n_req)
        if not f.startswith(("chaos streams diverged",
                             "round-robin streams diverged"))]
    chaos_differ = _streams_audit(f"{tag} (a)", ("fault-free fleet",
                                                 "chaos fleet"),
                                  ref_streams, chaos["streams"],
                                  fleet_logits, chaos_logits, V)
    print(f"{tag} (a) chaos (canned fleet plan: replica 0 crashes at tick "
          f"{mid}, replica 1 hangs at {mid + 4} for 4): events "
          f"{chaos['events']}, crashed {int(sup_c.c_crashed.value)}, hung "
          f"{int(sup_c.c_hung.value)} (the plan's {n_crash} and {n_hang}, "
          f"no other death), {chaos['failovers']} failovers, not ok "
          f"{chaos['not_ok']}, leaked {chaos['leaks']}, invariants every "
          f"tick of {sup_c.ticks}, journal {len(journal.records)} records, "
          f"replay exact (memory and file) {chaos['replay_exact']}, streams "
          f"differing from the fault-free fleet {chaos_differ} (audited), "
          f"round-robin's {rr_differ} (audited); TTFT p50/p99 "
          f"{ttft.quantile(0.5) * 1e3:.1f}/{ttft.quantile(0.99) * 1e3:.1f} "
          f"ms over {ttft.count}; wall {dt_c:.2f} s; K1 {k1c} launches; "
          f"{card}")
    check(not failures, f"fleet_bench gates at full width: {failures}")

    # -- (b) the chaos drive on one thread ---------------------------------
    reset()
    journal1 = Journal()
    t0 = time.perf_counter()
    sup_s, treqs_s, dt_s = fb.drive(engines, arrivals, T,
                                    faults=FaultInjector(plan),
                                    journal=journal1, check_each_tick=True,
                                    step_parallel=False)
    logits.take(prompts, T)
    strip = [[{k: v for k, v in r.items() if k not in ("t", "crc")}
              for r in j.records] for j in (journal, journal1)]
    same = [list(t.result.tokens) for t in treqs_s] == chaos["streams"]
    check(same and strip[0] == strip[1] and sup_s.ticks == sup_c.ticks and
          sup_s.c_crashed.value == n_crash and sup_s.c_hung.value == n_hang,
          f"one-thread chaos drive differs from the threaded one: streams "
          f"equal {same}, records equal (t, crc excepted) "
          f"{strip[0] == strip[1]}, ticks {sup_s.ticks}/{sup_c.ticks}")
    print(f"{tag} (b) the chaos drive on one thread: {n_req}/{n_req} "
          f"streams and {len(journal1.records)}/{len(journal.records)} "
          f"journal records equal the threaded drive's (t and crc "
          f"excepted), ticks {sup_s.ticks}; wall one thread {dt_s:.2f} s, "
          f"threads {dt_c:.2f} s (read)")
    t_ab = time.perf_counter() - t_phase
    del engines, sup_1, sup_n, sup_rr, sup_c, sup_s
    del fleet_logits, rr_logits, chaos_logits
    torch.cuda.empty_cache()

    # -- (c) recovery at full width, in process ----------------------------
    r = rb.parse_args(["--device", "cuda"])
    q_arr = rb.case_workload("postquarantine", V, r.seed, r.n_req)
    eng = rb.make_factory(cfg, params, "postquarantine", 1, device=dev,
                          guard_config=GuardConfig(**rsb.NO_QUARANTINE))()
    deltas, _ = rsb.audit_deltas(eng, [p for _, p in q_arr], 1)
    del eng
    qconfig = rsb.guard_config_for(max(e for _, e in deltas))
    print(f"{tag} (c) restore_bench workload ({r.n_req} requests a case, "
          f"{r.max_new} new, block {rb.BLOCK_SIZE}, {rb.NUM_BLOCKS} blocks, "
          f"batch {rb.MAX_BATCH}, chunk {rb.PREFILL_CHUNK} for midprefill); "
          f"the quarantine case's clean readback deltas "
          f"{_deltas_text(deltas)}, its thresholds (guard_config_for): "
          f"degraded {qconfig.logit_error_degraded:.3f}, quarantine "
          f"{qconfig.quarantine_error:.3f}")
    logits = _FleetLogits()
    results = {}
    for case in rb.KILL_CASES:
        _reset_counts()
        res = _restore_case(rb, cfg, params, dev, case, tmp, r.max_new,
                            r.n_req, r.seed, qconfig, logits)
        k1 = _check_k1_bulk(f"restore {case}")
        k2 = _k2_tc_if_any(f"restore {case}")
        check(case != "midprefill" or k2 > 0,
              "midprefill: no K2 launch")
        check(case != "postquarantine" or "quarantined" in res["reasons"],
              f"postquarantine: no request quarantined ({res['reasons']})")
        w = [t for t, _ in res["writes"]]
        info = res["info"]
        print(f"{tag} (c) {case}: killed after tick {res['killed_at']} "
              f"({len(w)} snapshots of {res['writes'][-1][1]:,} bytes, "
              f"write {1e3 * min(w):.1f}-{1e3 * max(w):.1f} ms, median "
              f"{1e3 * float(np.median(w)):.1f}; read "
              f"{1e3 * res['t_read']:.1f} ms, restore (apply + fsck) "
              f"{1e3 * res['t_apply']:.1f} ms); restored {info['mode']}, "
              f"{info['adopted']} adopted, tail lost {info['tail_lost']}, "
              f"fsck clean, {info['leaked']} leaked, new journal replays "
              f"to the streams, finish reasons {res['reasons']}, streams "
              f"differing from the uninterrupted run {res['differ']} "
              f"(audited); bf16 pool bits equal through the round trip; "
              f"K1 {k1} (bulk copy), K2 {k2} (tensor cores); {card}")
        results[case] = res

    # the corrupted snapshot: cold, and still the streams
    cow = results["midcow"]
    cdir = f"{tmp}/corrupted"
    shutil.copytree(cow["adir"], cdir)
    rb.corrupt_snapshot(f"{cdir}/snaps/replica0.snap")
    base = rb.make_factory(cfg, params, "midcow", r.max_new, device=dev)
    factory = lambda: logits.install(base())      # noqa: E731
    got_sup, info = rb.recover(factory, "midcow", cdir, cow["arrivals"],
                               r.max_new, snapshot_dir=f"{cdir}/snaps")
    got = rb.streams_of(got_sup)
    got_logits = {**cow["kill_logits"], **logits.take(cow["prompts"],
                                                       r.max_new)}
    rids = sorted(cow["ref"])
    check(info["mode"] == "cold" and "checksum" in info["reason"] and
          info["leaked"] == 0 and set(got) == set(cow["ref"]),
          f"corrupted snapshot: {info['mode']} ({info['reason']})")
    differ = _streams_audit(f"{tag} (c) corrupted", ("uninterrupted",
                                                     "cold"),
                            [cow["ref"][x][0] for x in rids],
                            [got[x][0] for x in rids], cow["ref_logits"],
                            got_logits, V)
    print(f"{tag} (c) corrupted midcow snapshot: restore {info['mode']} "
          f"({info['reason'].rsplit(': ', 1)[-1]}), streams differing "
          f"{differ} "
          f"(audited), {info['leaked']} leaked")

    # warm against cold, chunked measurement engines
    factory = rb.make_factory(cfg, params, "midcow", r.max_new, device=dev,
                              prefill_chunk=rb.PREFILL_CHUNK)
    fresh = rb.fresh_batch(cow["arrivals"][:2], V, r.seed, r.fresh)
    wc = {}
    _reset_counts()
    for kind, sdir in (("cold", None), ("warm", f"{cow['adir']}/snaps")):
        _, wc[kind] = rb.recover(factory, "midcow", cow["adir"],
                                 cow["arrivals"], r.max_new,
                                 snapshot_dir=sdir, extra_prompts=fresh)
    _check_k1_bulk("warm vs cold")
    k2 = _check_k2_tc("warm vs cold")
    ratio, warm_ttft, cold_ttft, wc_fail = rb.warm_vs_cold(wc["warm"],
                                                           wc["cold"])
    print(f"{tag} (c) warm vs cold ({r.fresh} fresh requests extending "
          f"the first wave, chunk {rb.PREFILL_CHUNK}): prefill tokens warm "
          f"{wc['warm']['prefill_tokens']}, cold "
          f"{wc['cold']['prefill_tokens']} (cold/warm {ratio:.3f}); ticks "
          f"to first token warm {wc['warm']['ttft_ticks']} (p50 "
          f"{warm_ttft}), cold {wc['cold']['ttft_ticks']} (p50 "
          f"{cold_ttft}); prefix-hit tokens warm "
          f"{wc['warm']['prefix_hit_tokens']}, cold "
          f"{wc['cold']['prefix_hit_tokens']}; K2 {k2} (tensor cores); "
          f"{card}")
    check(not wc_fail, f"warm vs cold: {wc_fail}")
    del got_sup, results, cow, logits, params
    torch.cuda.empty_cache()
    t_c = time.perf_counter() - t_phase - t_ab

    # -- (d) the two CLIs ---------------------------------------------------
    for name, args in (("fleet_bench", ["--smoke"]),
                       ("restore_bench", ["--smoke", "--artifacts",
                                          f"{tmp}/restore_cli"])):
        _bench_cli(tag, name, args, "qwen3-4b reduced, float32", card,
                   cwd=tmp)
    shutil.rmtree(tmp, ignore_errors=True)
    total = time.perf_counter() - t_phase
    print(f"{tag} phase time {total:.1f} s ((a)+(b) {t_ab:.1f}, (c) "
          f"{t_c:.1f}, (d) {total - t_ab - t_c:.1f})")


MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_TRAIN_LAYERS = 2     # phase 30 (g): full width, depth cut to 2 MoE layers


def _kernel_fns():
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_decode_paged import (
        flash_decode_paged, flash_decode_paged_single)
    from repro_torch.kernels.flash_prefill_paged import flash_prefill_paged
    from repro_torch.kernels.softermax import softermax_rows
    from repro_torch.kernels.softermax_quant import softermax_quant_rows
    return (flash_decode_paged, flash_decode_paged_single,
            flash_prefill_paged, flash_attention, flash_attention_bwd,
            flash_decode, softermax_rows, softermax_quant_rows)


def _save_counts():
    """Every kernel wrapper's launch counters, to put back after launches
    made for a comparison or a timing (those do not count)."""
    return [(fn, name, getattr(fn, name)) for fn in _kernel_fns()
            for name in vars(fn) if name.startswith("launches")]


def _restore_counts(saved):
    for fn, name, value in saved:
        setattr(fn, name, value)


class _MoeCalls:
    """Inside a ``with`` block, wraps ``models/moe.py::route`` (which every
    MoE call looks up at call time): counts the MoE calls and sums their
    dropped assignments on the card (read once, at the end); with
    ``keep_routes`` it also keeps each call's selection and probabilities
    for ``_routing_flip``."""

    def __init__(self, keep_routes=False):
        self.calls, self._dropped, self.routes = 0, [], []
        self.keep_routes = keep_routes

    def __enter__(self):
        from repro_torch.models import moe
        self._route = route = moe.route

        def observed(*args):
            r = route(*args)
            self.calls += 1
            self._dropped.append((~r.keep).sum())
            if self.keep_routes:
                self.routes.append((r.sel.clone(), r.probs.detach().clone()))
            return r

        moe.route = observed
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self._route

    def dropped(self) -> int:
        import torch
        return int(torch.stack(self._dropped).sum()) if self._dropped else 0


def _routing_flip(a_routes, b_routes):
    """The first MoE call whose selections differ between two runs of the
    same token sequence, calls aligned one to one: (call index, [(row,
    gap in a, gap in b)], band), or None. A row's gap in run a is, over
    the positions where the selections differ, the largest margin by which
    a's own probabilities prefer a's expert to b's (and the reverse for
    b); a near tie has both within ``band``: twice the largest |probability
    difference| between the runs over every earlier call and this call's
    unflipped rows (the noise of the two runs' arithmetic, as in
    ``_near_tie_audit``)."""
    noise = 0.0
    for i, ((sa, pa), (sb, pb)) in enumerate(zip(a_routes, b_routes)):
        check(sa.shape == sb.shape, f"MoE call {i}: {tuple(sa.shape)} "
                                    f"against {tuple(sb.shape)} rows")
        diff = (sa != sb).any(-1)
        if not bool(diff.any()):
            noise = max(noise, (pa - pb).abs().max().item())
            continue
        if bool((~diff).any()):
            noise = max(noise, (pa - pb)[~diff].abs().max().item())
        rows = []
        for r in diff.nonzero()[:, 0].tolist():
            pos = (sa[r] != sb[r]).nonzero()[:, 0]
            ea, eb = sa[r, pos], sb[r, pos]
            rows.append((r, (pa[r, ea] - pa[r, eb]).max().item(),
                         (pb[r, eb] - pb[r, ea]).max().item()))
        return i, rows, 2 * noise
    return None


def _moe_stream_audit(tag, label, a, b, a_logits, b_logits, a_routes,
                      b_routes, calls_per_token, vocab):
    """Two runs' greedy streams of one prompt (a, b: token lists): equal,
    or the first differing token excused by a routing near tie at or
    before it (``_routing_flip``) or by ``_near_tie_audit`` on the logits;
    raises otherwise. Returns the report's first line."""
    import numpy as np
    a, b = [int(x) for x in a], [int(x) for x in b]
    if a == b:
        return f"{label}: streams equal ({len(a)} tokens)"
    t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
    flip = _routing_flip(a_routes, b_routes)
    if flip is not None and flip[0] // calls_per_token <= t:
        i, rows, band = flip
        print(f"{tag} routing near-tie audit ({label}): first routing "
              f"difference at MoE call {i} (token {i // calls_per_token}, "
              f"layer {i % calls_per_token}), first differing token {t}; "
              f"(row, gap a, gap b) {rows}; band {band:.4g}")
        check(all(ga <= band and gb <= band for _, ga, gb in rows),
              f"{label}: a routing flip at a decisive probability gap "
              f"({rows}, band {band:.4g})")
        return (f"{label}: streams differ from token {t}, after a routing "
                f"near tie at MoE call {i} (excused)")
    share, lines = _near_tie_audit(
        np.array([a]), [list(b)], a_logits,
        {(0, s): lg[0] for s, lg in enumerate(b_logits)}, vocab)
    for line in lines:
        print(f"{tag} near-tie audit ({label}): {line}")
    return (f"{label}: streams differ from token {t}, routing equal "
            f"before it, logits at a near tie (excused); {share:.3f} of "
            f"tokens equal")


def _record_samplings(eng):
    """Keep the logits of every sampling of an engine serving one request
    on one row, in order: the t-th is token t's."""
    rec, greedy = [], eng._greedy

    def keep(lg):
        rec.append(lg.clone())
        return greedy(lg)

    eng._greedy = keep
    return rec


def _card_params(cfg, dev, seed=0):
    """Random bf16 weights of ``cfg``'s model (``model_fns(cfg).schema``:
    the LM's, or whisper's) on the card, drawn from
    ``torch.Generator(dev)`` seeded ``seed``, one layer slice at a time
    directly in bf16 (``init_params`` draws a whole leaf in f32 and then
    scales it: moonshot's stacked ``wi`` alone would take 35.4 GB, twice).
    Each leaf has its schema's distribution, the mixers' projections at
    their true fan-in (``_fan_in``), layernorm scales at 1 and biases at
    0."""
    import torch
    from repro_torch.models.registry import model_fns
    g = torch.Generator(device=dev).manual_seed(seed)

    def std(path, ps):
        if ps.std is not None:
            return ps.std
        if ps.init == "embed":
            return 1.0
        shape = ps.shape[1:] if ps.logical[0] == "layers" else ps.shape
        fan = _fan_in(path, shape) or (
            shape[-2] if len(shape) >= 2 else shape[-1])
        return max(fan, 1) ** -0.5

    def leaf(path, ps):
        t = torch.empty(ps.shape, dtype=torch.bfloat16, device=dev)
        if ps.init in ("zeros", "ones"):
            return t.fill_(float(ps.init == "ones"))
        s = std(path, ps)
        for part in (t if ps.logical[0] == "layers" else [t]):
            part.normal_(0.0, s, generator=g)
        return t

    def walk(schema, path):
        if isinstance(schema, dict):
            return {k: walk(schema[k], path + (k,)) for k in sorted(schema)}
        return leaf(path, schema)

    return walk(model_fns(cfg).schema, ())


def _moe_kernel_parity(tag, dev):
    """(a) K1 and K2 on both routes, K5, K6 forward and backward at
    moonshot's geometry: Hq = Hkv = 16 (G = 1), D 128, block 16."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_decode import decode_ref, flash_decode
    from repro_torch.kernels.flash_decode import ops as k5_ops
    from repro_torch.kernels.flash_decode_paged import (
        flash_decode_paged, paged_decode_live_split_ref,
        paged_decode_split_ref)
    from repro_torch.kernels.flash_decode_paged import ops as k1_ops
    from repro_torch.kernels.flash_prefill_paged import (
        flash_prefill_paged, paged_prefill_ref)
    from repro_torch.kernels.flash_prefill_paged import ops as k2_ops
    from repro_torch.kernels.parity import parity_error, tolerance
    from repro_torch.kernels.softermax import (softermax_op, softermax_rows,
                                               softermax_rows_ref)
    saved = _save_counts()
    rng = np.random.default_rng(30)
    H, D, BS = 16, 128, 16
    worst = {}

    def hold(name, got, want, dt):
        err, held = parity_error(got, want)
        check(held <= tolerance(dt), f"{name}: error {err} ({held})")
        worst[name] = max(worst.get(name, 0.0), err)

    lens = np.array([0, 1, 17, 1000, 1056, 300, 64, 999], np.int32)
    W = -(-int(lens.max()) // BS)
    N = len(lens) * W + 1
    for kv in ("bfloat16", "int8"):
        for T, S in ((1, 1), (2, 3)):
            kp, vp, ks, vs = _pools(rng, N, H, BS, D, kv, dev)
            bt = torch.from_numpy(rng.permutation(np.arange(1, N))
                                  .reshape(len(lens), W).astype(np.int32))
            bt[0] = 0                                 # zombie row
            bt, ln = bt.to(dev), torch.from_numpy(lens).to(dev)
            q = _rand(rng, (len(lens), H, D), D ** -0.5).to(dev,
                                                            torch.bfloat16)
            bulk0 = flash_decode_paged.launches_bulk
            got = flash_decode_paged(q, kp, vp, bt, ln, k_scale=ks,
                                     v_scale=vs, kv_tile_blocks=T, split_k=S)
            check(flash_decode_paged.launches_bulk == bulk0 + 1,
                  f"K1 {kv} G=1: not on the bulk-copy route")
            early = k1_ops._launch(q, kp, vp, bt, ln, ks, vs, True, T, S,
                                   bulk=False)[0]
            hold(f"K1 bulk-copy {kv}", got, paged_decode_live_split_ref(
                q, kp, vp, bt, ln, k_scale=ks, v_scale=vs,
                n_lanes=k1_ops.bulk_lanes(q, kp, bt, T, S)), torch.bfloat16)
            hold(f"K1 earlier {kv}", early, paged_decode_split_ref(
                q, kp, vp, bt, ln, k_scale=ks, v_scale=vs,
                kv_tile_blocks=T, split_k=S), torch.bfloat16)
            check(bool(torch.all(got[0] == 0)) and
                  bool(torch.all(early[0] == 0)), "K1 G=1: zombie row")
    for kv, C, pos0 in (("bfloat16", 256, 0), ("bfloat16", 256, 768),
                        ("bfloat16", 64, 1000), ("int8", 256, 768)):
        W = -(-(pos0 + C) // BS)
        kp, vp, ks, vs = _pools(rng, W + 1, H, BS, D, kv, dev)
        bt = torch.from_numpy(rng.permutation(np.arange(1, W + 1))
                              .astype(np.int32)[None]).to(dev)
        p0 = torch.tensor([pos0], dtype=torch.int32, device=dev)
        q = _rand(rng, (1, H, C, D), D ** -0.5).to(dev, torch.bfloat16)
        want = paged_prefill_ref(q, kp, vp, bt, p0, k_scale=ks, v_scale=vs)
        tc0 = flash_prefill_paged.launches_tc
        got = flash_prefill_paged(q, kp, vp, bt, p0, k_scale=ks, v_scale=vs)
        check(flash_prefill_paged.launches_tc == tc0 + (kv != "int8"),
              f"K2 {kv} G=1: route")
        hold(f"K2 {'tensor cores' if kv != 'int8' else 'earlier'} {kv}",
             got, want, torch.bfloat16)
        if kv != "int8":
            early = k2_ops._launch(q, kp, vp, bt, p0, ks, vs, True, 1,
                                   tc=False)[0]
            hold(f"K2 earlier {kv}", early, want, torch.bfloat16)
    for S in (37, 1056):
        B = 8
        k = _rand(rng, (B, H, S, D)).to(dev, torch.bfloat16)
        v = _rand(rng, (B, H, S, D)).to(dev, torch.bfloat16)
        q = _rand(rng, (B, H, D), D ** -0.5).to(dev, torch.bfloat16)
        ln = torch.from_numpy(rng.integers(1, S + 1, B).astype(np.int32)) \
            .to(dev)
        bulk0 = flash_decode.launches_bulk
        got = flash_decode(q, k, v, ln)
        check(flash_decode.launches_bulk == bulk0 + 1,
              "K5 G=1: not on the bulk-copy route")
        want = decode_ref(q, k, v, ln)
        hold("K5 bulk-copy", got, want, torch.bfloat16)
        hold("K5 earlier", k5_ops._launch(q, k, v, ln, True, bulk=False)[0],
             want, torch.bfloat16)
    for rows in (8, 1024):
        x = _rand(rng, (rows, 64)).to(dev)
        reg0 = softermax_rows.launches_reg
        got = softermax_rows(x)
        check(softermax_rows.launches_reg == reg0 + 1,
              f"K6 ({rows}, 64): not on the register route")
        hold("K6 forward", got, softermax_rows_ref(x), torch.float32)
        g = _rand(rng, (rows, 64)).to(dev)
        a = x.clone().requires_grad_()
        softermax_op(a).backward(g)
        b = x.cpu().requires_grad_()
        softermax_op(b).backward(g.cpu())
        err = (a.grad.cpu() - b.grad).abs().max().item()
        check(err <= 1e-5 * b.grad.abs().max().item(),
              f"K6 backward ({rows}, 64): error {err}")
        worst["K6 backward"] = max(worst.get("K6 backward", 0.0), err)
    _restore_counts(saved)
    print(f"{tag} (a) kernel parity at Hq = Hkv = 16, D 128, block 16 (K6 "
          f"at router rows (8, 64) and (1024, 64)), max |err| against the "
          f"plain versions: " + ", ".join(f"{k} {v:.3g}"
                                          for k, v in sorted(worst.items())))


def _moe_kernel_times(tag, dev):
    """(f) K6 at the router's rows, and K1, K2, K5 at G = 1 (moonshot's
    16/16 heads, D 128): device ms beside the plain version, the bound and
    a library call where one computes the same function."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import decode_ref, flash_decode
    from repro_torch.kernels.flash_decode_paged import (
        flash_decode_paged, gather_kv_dequant, paged_decode_ref)
    from repro_torch.kernels.flash_prefill_paged import (flash_prefill_paged,
                                                         paged_prefill_ref)
    from repro_torch.kernels.parity import parity_error
    from repro_torch.kernels.softermax import (softermax_rows,
                                               softermax_rows_ref)
    saved = _save_counts()
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rng = np.random.default_rng(31)
    H, D, BS, B, L = 16, 128, 16, 8, 1056
    bf = torch.bfloat16
    out = {}

    def entry(name, err, ms, plain, nbytes, flops, lib, peak="bfloat16"):
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_o = flops / PEAK_FLOPS[peak] * 1e3
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": max(t_b, t_o),
                     "bound_by": "bytes" if t_b >= t_o else "operations",
                     "library_ms": lib}

    # K6 at the router's rows: 8 (a decode step) and 1024 (a prefill)
    for rows in (8, 1024):
        x = _rand(rng, (rows, 64), 3.0).to(dev)
        err = parity_error(softermax_rows(x), softermax_rows_ref(x))[0]
        xs = x * math.log(2)
        entry(f"softermax_rows ({rows}, 64)", err,
              _time_ms(lambda: softermax_rows(x), flush),
              _time_ms(lambda: softermax_rows_ref(x), flush),
              2 * x.numel() * 4, 5 * x.numel(),
              _time_ms(lambda: torch.softmax(xs, dim=-1), flush),
              peak="float32")
    # K1: 8 rows of 1056 cached tokens
    W = L // BS
    kp, vp, _, _ = _pools(rng, B * W + 1, H, BS, D, "bfloat16", dev)
    bt = torch.from_numpy(rng.permutation(np.arange(1, B * W + 1)).reshape(
        B, W).astype(np.int32)).to(dev)
    ln = torch.full((B,), L, dtype=torch.int32, device=dev)
    q = _rand(rng, (B, H, D), D ** -0.5).to(dev, bf)
    kg, vg = (gather_kv_dequant(p, None, bt) for p in (kp, vp))
    err = parity_error(flash_decode_paged(q, kp, vp, bt, ln),
                       paged_decode_ref(q, kp, vp, bt, ln))[0]
    nbytes = 2 * B * H * L * D * 2 + 2 * q.numel() * 2
    entry("flash_decode_paged", err,
          _time_ms(lambda: flash_decode_paged(q, kp, vp, bt, ln), flush),
          _time_ms(lambda: paged_decode_ref(q, kp, vp, bt, ln), flush),
          nbytes, 4 * B * H * L * D,
          _time_ms(lambda: F.scaled_dot_product_attention(
              q[:, :, None], kg, vg, scale=math.log(2)), flush))
    # K5 on the same rows, contiguous
    err = parity_error(flash_decode(q, kg, vg, ln),
                       decode_ref(q, kg, vg, ln))[0]
    entry("flash_decode", err,
          _time_ms(lambda: flash_decode(q, kg, vg, ln), flush),
          _time_ms(lambda: decode_ref(q, kg, vg, ln), flush),
          nbytes, 4 * B * H * L * D,
          _time_ms(lambda: F.scaled_dot_product_attention(
              q[:, :, None], kg, vg, scale=math.log(2)), flush))
    del kp, vp, kg, vg
    # K2: one 256-token chunk at pos0 768
    C, pos0 = 256, 768
    W = (pos0 + C) // BS
    kp, vp, _, _ = _pools(rng, W + 1, H, BS, D, "bfloat16", dev)
    bt = torch.from_numpy(rng.permutation(np.arange(1, W + 1))
                          .astype(np.int32)[None]).to(dev)
    p0 = torch.tensor([pos0], dtype=torch.int32, device=dev)
    q = _rand(rng, (1, H, C, D), D ** -0.5).to(dev, bf)
    kg, vg = (gather_kv_dequant(p, None, bt) for p in (kp, vp))
    mask = (torch.arange(pos0 + C, device=dev)[None, :] <=
            pos0 + torch.arange(C, device=dev)[:, None])
    err = parity_error(flash_prefill_paged(q, kp, vp, bt, p0),
                       paged_prefill_ref(q, kp, vp, bt, p0))[0]
    pairs = C * pos0 + C * (C + 1) // 2
    entry("flash_prefill_paged", err,
          _time_ms(lambda: flash_prefill_paged(q, kp, vp, bt, p0), flush),
          _time_ms(lambda: paged_prefill_ref(q, kp, vp, bt, p0), flush),
          2 * H * (pos0 + C) * D * 2 + 2 * q.numel() * 2, 4 * D * H * pairs,
          _time_ms(lambda: F.scaled_dot_product_attention(
              q, kg, vg, attn_mask=mask, scale=math.log(2)), flush))
    _restore_counts(saved)
    for name, e in out.items():
        where = "the router's rows" if name.startswith("softermax") else \
            "G = 1"
        print(f"{tag} (f) {name} at {where}: {e['ms']:.4f} ms (plain "
              f"{e['plain_ms']:.4f}, bound {e['bound_ms']:.4f} by "
              f"{e['bound_by']}, library {e['library_ms']:.4f}; max |err| "
              f"{e['max_abs_err']:.3g})")
    k6 = out.pop("softermax_rows (1024, 64)")
    out["softermax_rows"] = {**k6, "rows_8": out.pop(
        "softermax_rows (8, 64)")}
    return out


def _launcher(tag, module, argv):
    """``python -m repro_torch.launch.MODULE ARGV`` run in this process on
    the card, its launches kept out of the counts: (its ``seqN: [...]``
    lines, the lines its logger took, ``main``'s return). What ``main``
    raises propagates."""
    import importlib
    import logging
    mod = importlib.import_module(f"repro_torch.launch.{module}")
    saved = _save_counts()
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    keep = Keep()
    mod.log.addHandler(keep)
    t0 = time.perf_counter()
    try:
        ret = mod.main(argv)
    finally:
        mod.log.removeHandler(keep)
        _restore_counts(saved)
    print(f"{tag} launch.{module} {' '.join(argv)}: "
          f"{time.perf_counter() - t0:.1f} s")
    return [ln for ln in lines if ln.startswith("seq")], lines, ret


def phase_moe(dev, card):
    """30. (P) The MoE family at moonshot-v1-16b-a3b's full width (48
    layers, d 2048, 16/16 heads of 128, 64 experts of 1408, top-6, vocab
    163,840; bf16 weights, 56.1 GB). Returns the MoE path's readings of
    K1, K2, K5 and K6 for the ``kernels`` line."""
    import numpy as np
    import torch
    from repro_torch.configs.base import TRAIN_4K, TrainConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import moe
    from repro_torch.models.lm import lm_forward
    from repro_torch.models.registry import get_config, model_fns
    from repro_torch.models.schema import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.serve import (ContinuousEngine, ServeEngine,
                                   check_invariants)
    from repro_torch.train import make_train_step
    tag = "[30]"
    t_phase = time.perf_counter()
    cfg = get_config(MOE_ARCH)
    L, V = cfg.n_layers, cfg.vocab_size
    _moe_kernel_parity(tag, dev)

    # -- (b) weights ----------------------------------------------------------
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = _card_params(cfg, dev)
    torch.cuda.synchronize()
    n_param = sum(t.numel() for t in tree_leaves(params))
    print(f"{tag} (b) {MOE_ARCH} random bf16 weights, {n_param / 1e9:.2f} B "
          f"parameters ({n_param * 2 / 1e9:.1f} GB) drawn layer slice by "
          f"layer slice in {time.perf_counter() - t0:.2f} s; "
          f"memory_allocated {before / 2 ** 30:.2f} -> "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")

    # -- (c) paged serving ----------------------------------------------------
    rng = np.random.default_rng(30)
    lens = rng.integers(128, 1025, 8)
    prompts = [rng.integers(1, V, n).astype(np.int32) for n in lens]
    max_new = 32
    base = dict(block_size=16, num_blocks=1200, max_batch=8,
                max_len=1024 + max_new)
    streams, drops, dec_ms = {}, {}, {}
    k6_main, k1_main, k2_main = 0, 0, 0
    for name, kw in (("one-shot", {}), ("chunked-256",
                                         {"prefill_chunk": 256}),
                     ("int8 one-shot", {"kv_dtype": "int8"})):
        eng = ContinuousEngine(cfg, params, device=dev, **base, **kw)
        passes = [(name, prompts)]
        if name == "chunked-256":
            passes.append(("prefix-resubmit", [
                np.concatenate([p[:len(p) // 2 + 3],
                                rng.integers(1, V, 40).astype(np.int32)])
                for p in prompts]))
        for label, batch in passes:
            obs = _MoeCalls()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            hits0 = eng.metrics.prefix_hit_tokens
            with obs:
                res, wall, d_ms, n_dec, n_chunk = _drive(eng, batch,
                                                         max_new)
            k1 = _check_k1_bulk(f"{tag} {label}")
            k2, k6 = _counts()[1], _softermax_counts()[0]
            check(all(len(r.tokens) == max_new for r in res),
                  f"{label}: a request did not finish")
            check_invariants(eng.pool, eng.prefix_cache)
            check(k1 == L * n_dec, f"{label}: K1 launches {k1} != "
                                   f"{L} x {n_dec} decode steps")
            check(k2 == L * n_chunk and (k2 > 0) == bool(eng.prefill_chunk),
                  f"{label}: K2 launches {k2} != {L} x {n_chunk} chunks")
            if k2:
                _check_k2_tc(f"{tag} {label}")
            check(k6 == obs.calls > 0, f"{label}: K6 launches {k6}, MoE "
                                       f"calls {obs.calls}")
            if label == "prefix-resubmit":
                check(eng.metrics.prefix_hit_tokens > hits0 and
                      eng.metrics.cow_copies > 0,
                      "prefix-resubmit: no prefix hit / copy-on-write")
            drops[label] = obs.dropped()
            dec_ms[label] = float(np.mean(d_ms))
            k6_main += k6
            k1_main += k1
            k2_main += k2
            toks = sum(len(r.tokens) for r in res)
            print(f"{tag} (c) {label}: {len(res)} requests x {max_new} "
                  f"tokens, {toks / wall:.1f} tok/s ({wall:.2f} s incl. "
                  f"prefill), {dec_ms[label]:.2f} ms per synced decode step "
                  f"(n={len(d_ms)}), launches K1 {k1} (= {L} x {n_dec}, "
                  f"bulk-copy route) K2 {k2} (= {L} x {n_chunk}"
                  f"{', tensor cores' if k2 else ''}) K6 {k6} (= MoE calls)"
                  f", dropped assignments {drops[label]}, prefix hits "
                  f"{eng.metrics.prefix_hit_tokens - hits0} tokens, peak "
                  f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
                  f" GiB")
            if label in ("one-shot", "chunked-256"):
                streams[label] = np.array([r.tokens for r in res])
        del eng
        torch.cuda.empty_cache()
    share, n_eq = _stream_share(streams["one-shot"], streams["chunked-256"])
    print(f"{tag} (e) chunked-256 vs one-shot (other token sets a MoE call: "
          f"printed, not gated): {share:.3f} of greedy tokens equal, "
          f"{n_eq}/8 streams equal; dropped assignments one-shot "
          f"{drops['one-shot']}, chunked-256 {drops['chunked-256']}")

    # -- (f) where a decode step's time goes ---------------------------------
    eng = ContinuousEngine(cfg, params, device=dev, **base)
    for p in prompts:
        eng.submit(p, max_new)
    while eng.sched.waiting or eng.metrics.decode_steps < 1 or any(
            r.state == "prefill" for r in eng.sched.running):
        eng.step()
    print(f"{tag} (f) " + step_profile(eng.step, 5, "paged decode, batch 8",
                                       watch=("paged_decode",
                                              "softermax_rows")))
    while eng.sched.has_work():
        eng.step()
    eng.drain()
    del eng
    torch.cuda.empty_cache()

    # -- (d) static serving, 8 x 1024 tokens, and the paged engine on them ----
    P = 1024
    fixed = rng.integers(1, V, (8, P)).astype(np.int32)
    kw = dict(block_size=16, num_blocks=8 * ((P + max_new) // 16 + 1) + 1,
              max_batch=8, max_len=P + max_new)
    eng = ServeEngine(cfg, params, max_len=P + max_new, device=dev)
    rec = _StaticRecorder(eng)
    obs = _MoeCalls()
    _reset_counts()
    t0 = time.perf_counter()
    with obs:
        res = eng.generate(fixed, max_new)
    wall = time.perf_counter() - t0
    rec.close()
    k5 = _check_k5_bulk(f"{tag} static")
    k6 = _softermax_counts()[0]
    check(k5 == L * (max_new - 1), f"static: K5 launches {k5}")
    check(k6 == obs.calls == L * max_new, f"static: K6 launches {k6}, MoE "
                                          f"calls {obs.calls}")
    check(_counts() == (0, 0), "static: a paged kernel launched")
    check(((res.tokens >= 0) & (res.tokens < V)).all() and
          all(torch.isfinite(lg).all().item() for lg in rec.logits),
          "static: tokens out of the vocabulary or non-finite logits")
    k5_main, k6_main = k5, k6_main + k6
    static_drops = obs.dropped()
    print(f"{tag} (d) static engine, 8 x {P} tokens, {max_new} new: "
          f"{8 * max_new / wall:.1f} tok/s ({wall:.2f} s incl. prefill "
          f"{rec.prefill_ms:.0f} ms), {np.mean(rec.decode_ms):.2f} ms per "
          f"synced decode step, K5 {k5} (= {L} x {max_new - 1}, bulk-copy "
          f"route), K6 {k6} (= MoE calls), dropped assignments "
          f"{static_drops}")
    _profile_static(f"{tag} (f) static", eng, fixed, "decode, batch 8")
    del eng, rec
    torch.cuda.empty_cache()
    eng = ContinuousEngine(cfg, params, device=dev, **kw)
    obs = _MoeCalls()
    with obs:
        handles = [eng.submit(p, max_new) for p in fixed]
        got = eng.run()
    paged8 = np.array([got[h.req_id].tokens for h in handles])
    share, n_eq = _stream_share(res.tokens, paged8)
    print(f"{tag} (e) static B = 8 vs paged one-shot on the same prompts "
          f"(T = 8 x {P} against {P} a call: printed, not gated): "
          f"{share:.3f} of greedy tokens equal, {n_eq}/8 streams equal; "
          f"dropped assignments static {static_drops}, paged "
          f"{obs.dropped()}")
    del eng, got
    torch.cuda.empty_cache()

    # -- (e) one prompt alone: the same token set in every MoE call -----------
    one = fixed[:1]
    runs = {}
    eng = ServeEngine(cfg, params, max_len=P + max_new, device=dev)
    rec = _StaticRecorder(eng)
    obs = _MoeCalls(keep_routes=True)
    with obs:
        res1 = eng.generate(one, max_new)
    rec.close()
    runs["static"] = (list(res1.tokens[0]), [lg for lg in rec.logits],
                      obs.routes)
    del eng, rec
    eng = ContinuousEngine(cfg, params, device=dev, **{**kw,
                                                      "max_batch": 1})
    rec = _record_samplings(eng)
    obs = _MoeCalls(keep_routes=True)
    with obs:
        h = eng.submit(one[0], max_new)
        got = eng.run()
    check(len(rec) == max_new, f"paged single prompt: {len(rec)} samplings")
    runs["paged"] = (got[h.req_id].tokens, rec, obs.routes)
    del eng, rec
    line = _moe_stream_audit(
        tag, "paged one-shot vs static, one prompt of 1024 tokens",
        runs["static"][0], runs["paged"][0], runs["static"][1],
        runs["paged"][1], runs["static"][2], runs["paged"][2], L, V)
    print(f"{tag} (e) {line} (gated)")
    with torch.no_grad():
        fwd = lm_forward(params, torch.as_tensor(one, device=dev), cfg)[0]
    ref = fwd[0, -1, :V].float()
    got = runs["paged"][1][0][0, :V].float()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    check(err <= BF16_ATOL * scale, f"paged prefill logits vs lm_forward: "
                                    f"{err} > {BF16_ATOL} x {scale}")
    print(f"{tag} (e) paged one-shot prefill logits vs lm_forward of the "
          f"same {P} tokens: max |diff| {err:.4g} (gate {BF16_ATOL} x max "
          f"|logit| {scale:.4g}), greedy token {int(got.argmax())} / "
          f"{int(ref.argmax())}")
    del runs, fwd, ref, got, obs
    torch.cuda.empty_cache()
    times = _moe_kernel_times(tag, dev)
    # the recorders' closures tie engines (views of the weights) in cycles
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t_serve = time.perf_counter() - t_phase
    print(f"{tag} (g) memory_allocated after the serving weights are "
          f"freed: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")

    # -- (g) training, 2 MoE layers at full width -----------------------------
    tcfg = cfg.replace(n_layers=MOE_TRAIN_LAYERS, attention_impl="flash")
    Lt = tcfg.n_layers
    t0 = time.perf_counter()
    tparams = _true_fan_in(model_fns(tcfg).init(
        torch.Generator(device=dev).manual_seed(0)))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    tc = TrainConfig(total_steps=3, warmup_steps=1, learning_rate=3e-4)
    step_fn = make_train_step(model_fns(tcfg).loss, tc)
    opt = adamw.init_state(tparams)
    S = TRAIN_4K.seq_len
    data = SyntheticLMData(V, S, 1, seed=0)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    for s in range(3):
        c0 = _all_counts()
        tc0 = _flash_tc_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tparams, opt, m = step_fn(tparams, opt, next(data))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        c1 = _all_counts()
        k3, k4, k6 = (c1[i] - c0[i] for i in (2, 3, 5))
        tc1 = _flash_tc_counts()
        m = {k: float(v) for k, v in m.items()}
        check(all(np.isfinite(m[k]) for k in ("loss", "ce", "aux",
                                              "grad_norm")) and m["aux"] > 0,
              f"MoE training step {s}: {m}")
        check((k3, k4, k6) == (2 * Lt, 2 * Lt, 2 * Lt),
              f"MoE training step {s}: launches K3 {k3} K4 {k4} K6 {k6}, "
              f"want {2 * Lt} each")
        check((tc1[0] - tc0[0], tc1[1] - tc0[1]) == (k3, k4),
              f"MoE training step {s}: K3/K4 not all on the tensor cores")
        print(f"{tag} (g) train step {s}: loss {m['loss']:.5f} ce "
              f"{m['ce']:.5f} aux {m['aux']:.6f} grad norm "
              f"{m['grad_norm']:.4f}, {dt:.3f} s ({S / dt:.0f} "
              f"tokens/s), launches K3 {k3} K4 {k4} (tensor cores) K6 {k6}")
    print(f"{tag} (g) {MOE_ARCH} at full width, depth cut to {Lt} MoE "
          f"layers, seq {S}, batch 1 (C = {moe.capacity(S, tcfg)}): fp32 "
          f"master weights "
          f"({sum(t.numel() for t in tree_leaves(tparams)) / 1e9:.2f} B) in "
          f"{t_init:.2f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    del tparams, opt, step_fn
    torch.cuda.empty_cache()

    # -- (h) the launchers, reduced -------------------------------------------
    outs = {}
    for engine in ("static", "paged"):
        outs[engine] = _launcher(tag, "serve", [
            "--arch", MOE_ARCH, "--reduced", "--engine", engine])[0]
    check(outs["static"] and outs["static"] == outs["paged"],
          f"launch.serve static and paged greedy tokens differ: {outs}")
    print(f"{tag} (h) launch.serve --arch {MOE_ARCH} --reduced: static and "
          f"paged print the same greedy tokens ({len(outs['static'])} "
          f"sequences)")
    _, lines, out = _launcher(tag, "train", ["--arch", MOE_ARCH, "--reduced",
                                             "--steps", "3"])
    done = [ln for ln in lines if ln.startswith("done on cuda")]
    check(len(out["history"]) == 3 and done and
          all(math.isfinite(h) for h in out["history"]),
          f"launch.train: {out['history']}, {lines[-5:]}")
    print(f"{tag} (h) launch.train --arch {MOE_ARCH} --reduced --steps 3: "
          f"{done[0]}")
    print(f"{tag} phase time {time.perf_counter() - t_phase:.1f} s "
          f"(serving and kernels {t_serve:.1f}); {card}")
    for name, launches in (("flash_decode_paged", k1_main),
                           ("flash_prefill_paged", k2_main),
                           ("flash_decode", k5_main)):
        times[name]["launches"] = launches
    times["softermax_rows"]["launches"] = k6_main
    return times


FAMILY_ARCHS = ("deepseek-v2-236b", "hymba-1.5b", "rwkv6-7b")
DEEPSEEK_MOE_LAYERS = 4  # phase 31 (b): the dense head block + 4 MoE layers
RWKV_F32_TOL = 5e-3      # phase 31 (d): served logits vs lm_forward, f32
RWKV_BF16_LAYERS = 4     # phase 31 (d): the bf16 decode gate's depth cut
RWKV_BF16_TOL = 0.1      # its served logits vs lm_forward, bf16
DECODE_COPIES = 8        # phase 31 (d): rows of the row-count reading


def _request_routes(routes, r, P, calls_per_token):
    """Request r's rows of each MoE call of a static run over prompts of P
    tokens: its P prompt rows in the prefill's calls, its one row in each
    decode call."""
    return [(s[r * P:(r + 1) * P], p[r * P:(r + 1) * P])
            if i < calls_per_token else (s[r:r + 1], p[r:r + 1])
            for i, (s, p) in enumerate(routes)]


def _forms_audit(tag, label, a, b, a_logits, b_logits, vocab, a_routes=None,
                 b_routes=None, calls_per_token=1, P=0):
    """Two static runs of the same prompts, a and b ((B, T) tokens, logits
    (B, V) per step): each request's streams equal, or its first differing
    token excused by a router near tie in its own rows at or before that
    token (``_routing_flip``), or else, over the requests left, by
    ``_near_tie_audit`` on the logits (its band from their steps before
    any divergence); raises otherwise. Returns the report's line."""
    import numpy as np
    B, T = a.shape
    left = []
    for r in range(B):
        t = next((i for i in range(T) if a[r, i] != b[r, i]), T)
        if t < T and a_routes is not None:
            flip = _routing_flip(
                *(_request_routes(x, r, P, calls_per_token)
                  for x in (a_routes, b_routes)))
            if flip is not None and flip[0] // calls_per_token <= t:
                i, rows, band = flip
                print(f"{tag} routing near-tie audit ({label}, request {r})"
                      f": first routing difference at MoE call {i} (token "
                      f"{i // calls_per_token}), first differing token {t};"
                      f" (row, gap a, gap b) {rows[:4]}; band {band:.4g}")
                check(all(ga <= band and gb <= band for _, ga, gb in rows),
                      f"{label}, request {r}: a routing flip at a decisive "
                      f"probability gap ({rows[:4]}, band {band:.4g})")
                continue
        left.append(r)
    if left:
        _, lines = _near_tie_audit(
            a[left], [list(b[r]) for r in left],
            [lg[left] for lg in a_logits],
            {(j, s): lg[r] for s, lg in enumerate(b_logits)
             for j, r in enumerate(left)}, vocab)
        for line in lines:
            print(f"{tag} near-tie audit ({label}, requests {left}): "
                  f"{line}")
    n_eq = sum(bool(np.array_equal(x, y)) for x, y in zip(a, b))
    return (f"{label}: {(a == b).mean():.3f} of greedy tokens equal, "
            f"{n_eq}/{B} streams equal (each difference excused)")


def _static_drive(tag, label, cfg, params, prompts, max_new, dev,
                  keep_routes=False):
    """The static engine over ``prompts`` with its model steps synced and
    timed, the launch counts set to 0 just before: (engine, result,
    recorder, MoE calls)."""
    import torch
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg, params, max_len=prompts.shape[1] + max_new,
                      device=dev)
    rec = _StaticRecorder(eng)
    obs = _MoeCalls(keep_routes=keep_routes)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    with obs:
        res = eng.generate(prompts, max_new)
    wall = time.perf_counter() - t0
    rec.close()
    check(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all() and
          res.tokens.shape == (len(prompts), max_new) and
          all(torch.isfinite(lg).all().item() for lg in rec.logits),
          f"{label}: a request did not finish, tokens out of the "
          "vocabulary or non-finite logits")
    print(f"{tag} {label}: {res.tokens.size / wall:.1f} tok/s ({wall:.2f} s"
          f" incl. prefill {rec.prefill_ms:.0f} ms), "
          f"{sum(rec.decode_ms) / len(rec.decode_ms):.2f} ms per synced "
          f"decode step, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return eng, res, rec, obs


def _profile_static(tag, eng, prompts, label, watch=()):
    """``step_profile`` over 5 decode steps after a fresh prefill."""
    import torch
    lg, cache = eng._prefill(torch.as_tensor(prompts, device=eng.device))
    state = [eng._sample(lg, None, 0.0), cache]

    def step():
        lg, state[1] = eng._decode(state[0], state[1])
        state[0] = eng._sample(lg, None, 0.0)

    print(f"{tag} " + step_profile(step, 5, label, watch=watch))


def _forward_errors(params, cfg, prompts, res, rec, dev):
    """Each served step's logits (``rec``: the prefill's, then each decode
    step's) against ``lm_forward`` over the prompts grown by the served
    tokens, at the same position: max |diff| over the largest |logit|."""
    import numpy as np
    import torch
    from repro_torch.models.lm import lm_forward
    P, V = prompts.shape[1], cfg.vocab_size
    grown = np.concatenate([prompts, res.tokens[:, :-1]], 1)
    with torch.no_grad():
        fwd = lm_forward(params, torch.as_tensor(grown, device=dev), cfg)[0]
    errs = []
    for s, lg in enumerate(rec.logits):
        ref = fwd[:, P - 1 + s, :V]
        errs.append((lg[:, :V] - ref).abs().max().item() /
                    ref.abs().max().item())
    return errs


def _rel(got, want):
    """max |got - want| over the largest |want|."""
    return ((got.float() - want.float()).abs().max() /
            want.float().abs().max()).item()


def _mla_layer_check(tag, params, cfg, prompts, dev):
    """The first layer's MLA (the dense head block's) at full width on its
    prefill input: ``mla_apply``'s absorbed form against its expanded
    form; ``mla_decode`` of the last prompt token against the latent cache
    of the others (``mla_prefill_cache``'s rows) against both forms' last
    row; the latent row it writes against ``mla_prefill_cache``'s; each
    within ``BF16_ATOL`` of the reference's largest magnitude. No router
    is on this path."""
    import torch
    from repro_torch.models import mla
    from repro_torch.models.layers import embed, rmsnorm
    from repro_torch.models.schema import layer_params
    bp = layer_params(params["head_blocks"], 0)
    mp = bp["mixer"]
    tok = torch.as_tensor(prompts, device=dev)
    B, P = tok.shape
    pos = torch.arange(P, dtype=torch.int32, device=dev).expand(B, P)
    with torch.no_grad():
        h = rmsnorm(bp["ln1"], embed(params["embed"], tok, cfg),
                    cfg.norm_eps)
        y = {form: mla.mla_apply(mp, h, cfg.replace(
            opt_mla_absorbed=form == "absorbed"), positions=pos,
            window=cfg.window) for form in ("expanded", "absorbed")}
        ckv, krope = mla.mla_prefill_cache(mp, h, cfg, pos)
        c_ckv, c_krope = torch.zeros_like(ckv), torch.zeros_like(krope)
        c_ckv[:, :P - 1], c_krope[:, :P - 1] = ckv[:, :P - 1], \
            krope[:, :P - 1]
        y1, c_ckv, c_krope = mla.mla_decode(
            mp, h[:, -1], cfg, cache_ckv=c_ckv, cache_krope=c_krope,
            cache_len=torch.full((B,), P - 1, dtype=torch.int32,
                                 device=dev))
    errs = {"absorbed vs expanded": _rel(y["absorbed"], y["expanded"]),
            "decode vs expanded": _rel(y1, y["expanded"][:, -1]),
            "decode vs absorbed": _rel(y1, y["absorbed"][:, -1]),
            "written c_kv row": _rel(c_ckv[:, -1], ckv[:, -1]),
            "written k_rope row": _rel(c_krope[:, -1], krope[:, -1])}
    check(torch.equal(c_ckv[:, :P - 1], ckv[:, :P - 1]) and
          torch.equal(c_krope[:, :P - 1], krope[:, :P - 1]),
          "mla_decode changed a cache row before cache_len")
    for name, e in errs.items():
        check(e <= BF16_ATOL, f"deepseek MLA layer, {name}: {e} of the "
                              f"largest magnitude > {BF16_ATOL}")
    print(f"{tag} (b) one MLA layer at full width (kv_lora "
          f"{cfg.mla.kv_lora}, {cfg.n_heads} heads, 8 x {P} prefill input, "
          f"bf16), max |diff| over the reference's largest magnitude (gate "
          f"{BF16_ATOL} each): " + ", ".join(
              f"{k} {v:.4g}" for k, v in errs.items()))


def _row_count_noise(params, cfg, prompts, dev):
    """Position 0's logits from the same layers over the prompts (every
    product over the prefill's B x P rows) and over their first tokens
    alone (B rows, as in a decode step): by causality the same function of
    the same token, through the same code, so the two differ only by how
    the products round at the two row counts. Returns {depth: max |diff|
    over the largest |logit|} after 1, 2, 4, ... and all the layers."""
    import torch
    from repro_torch.models.layers import embed, logits, rmsnorm
    from repro_torch.models.lm import _block_apply
    from repro_torch.models.schema import layer_params, n_stacked
    tok = torch.as_tensor(prompts, device=dev)
    B, P = tok.shape
    pos = torch.arange(P, dtype=torch.int32, device=dev).expand(B, P)
    L, V = n_stacked(params["blocks"]), cfg.vocab_size
    xs = [embed(params["embed"], t, cfg) for t in (tok, tok[:, :1])]
    out = {}
    with torch.no_grad():
        for layer in range(L):
            bp = layer_params(params["blocks"], layer)
            xs = [_block_apply(bp, x, cfg, pos[:, :x.shape[1]])[0]
                  for x in xs]
            if layer & (layer + 1) == 0 or layer == L - 1:
                many, few = (logits(params["embed"], rmsnorm(
                    params["final_norm"], x[:, 0], cfg.norm_eps),
                    cfg)[:, :V] for x in xs)
                out[layer + 1] = _rel(few, many)
    return out


def _decode_rows_noise(params, cfg, prompts, res, rec, dev):
    """The static run ``res``/``rec`` again through ``lm_prefill`` and
    ``lm_decode_step`` with each request ``DECODE_COPIES`` times over, each
    step fed the served tokens: the same code on the same tokens, only the
    row count of every product differs. Returns each step's max |diff| of
    the first B rows' logits from the served ones over the largest
    |logit|."""
    import numpy as np
    import torch
    from repro_torch.models.lm import lm_decode_step, lm_prefill
    B, P = prompts.shape
    V, n = cfg.vocab_size, DECODE_COPIES
    fed = torch.as_tensor(np.tile(res.tokens, (n, 1)), device=dev)
    errs = []
    with torch.no_grad():
        lg, cache = lm_prefill(params, torch.as_tensor(
            np.tile(prompts, (n, 1)), device=dev), cfg,
            P + res.tokens.shape[1])
        for s, served in enumerate(rec.logits):
            errs.append(_rel(lg[:B, :V], served[:, :V]))
            if s + 1 < len(rec.logits):
                lg, cache = lm_decode_step(params, fed[:, s], cache, cfg)
    return errs


def _drawn(tag, label, cfg, dev):
    """``_card_params`` of ``cfg``, timed and counted in a printed line."""
    import torch
    from repro_torch.models.schema import tree_leaves
    t0 = time.perf_counter()
    params = _card_params(cfg, dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"{tag} {label}: {n / 1e9:.2f} B random bf16 parameters "
          f"({n * 2 / 1e9:.1f} GB) in {time.perf_counter() - t0:.2f} s")
    return params


def _free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _family_kernel_times(tag, dev):
    """K6 at deepseek's router rows (8, 160) and (8192, 160) and K3 at
    hymba's prefill (B 8, 25/5 heads, S 1024, D 64, causal, the tensor-core
    route): each held to its plain version (``tolerance`` of its output's
    dtype), its device ms beside the plain version's, the bound and a
    library call computing the same function."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.parity import parity_error, tolerance
    from repro_torch.kernels.softermax import (softermax_rows,
                                               softermax_rows_ref)
    saved = _save_counts()
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rng = np.random.default_rng(41)
    out = {}

    def entry(name, got, want, ms, plain, nbytes, flops, lib, peak):
        err, held = parity_error(got, want)
        check(held <= tolerance(want.dtype),
              f"{name}: max |err| {err}, checked error {held} > "
              f"{tolerance(want.dtype)}")
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_o = flops / PEAK_FLOPS[peak] * 1e3
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": max(t_b, t_o),
                     "bound_by": "bytes" if t_b >= t_o else "operations",
                     "library_ms": lib}

    for rows in (8, 8 * 1024):
        x = _rand(rng, (rows, 160), 3.0).to(dev)
        xs = x * math.log(2)
        entry(f"softermax_rows ({rows}, 160)", softermax_rows(x),
              softermax_rows_ref(x),
              _time_ms(lambda: softermax_rows(x), flush),
              _time_ms(lambda: softermax_rows_ref(x), flush),
              2 * x.numel() * 4, 5 * x.numel(),
              _time_ms(lambda: torch.softmax(xs, dim=-1), flush), "float32")
    B, Hq, Hkv, S, D = 8, 25, 5, 1024, 64
    q = _rand(rng, (B, Hq, S, D), D ** -0.5).to(dev, torch.bfloat16)
    k = _rand(rng, (B, Hkv, S, D)).to(dev, torch.bfloat16)
    v = _rand(rng, (B, Hkv, S, D)).to(dev, torch.bfloat16)
    pairs = B * Hq * S * (S + 1) // 2
    tc0 = _flash_tc_counts()[0]
    got = flash_attention(q, k, v)
    check(_flash_tc_counts()[0] == tc0 + 1,
          "K3 at hymba's prefill shape: not on the tensor-core route")
    entry("flash_attention", got, flash_attention_plain(q, k, v),
          _time_ms(lambda: flash_attention(q, k, v), flush, iters=10),
          _time_ms(lambda: flash_attention_plain(q, k, v), flush, iters=3),
          (2 * q.numel() + 2 * k.numel()) * 2 + 2 * B * Hq * S * 4,
          4 * D * pairs,
          _time_ms(lambda: F.scaled_dot_product_attention(
              q, k, v, is_causal=True, scale=math.log(2), enable_gqa=True),
              flush, iters=10), "bfloat16")
    _restore_counts(saved)
    for name, e in out.items():
        print(f"{tag} {name}: {e['ms']:.4f} ms (plain {e['plain_ms']:.4f}, "
              f"bound {e['bound_ms']:.4g} by {e['bound_by']}, library "
              f"{e['library_ms']:.4f}; max |err| {e['max_abs_err']:.3g})")
    k6 = out.pop("softermax_rows (8192, 160)")
    return {"softermax_rows": {**k6, "rows_8": out.pop(
        "softermax_rows (8, 160)")}, "flash_attention": out[
        "flash_attention"]}


def _family_launchers(tag, arch):
    """``launch.serve --arch ARCH --reduced --engine static`` on the card,
    its greedy tokens those of the static engine on the CPU over the same
    weights (the launcher's draw from ``torch.Generator("cuda")`` seeded 0,
    moved to the CPU) and prompts; ``--engine paged`` refused;
    ``launch.train --reduced --steps 3`` on the card."""
    import numpy as np
    import torch
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.registry import (get_config, init_lm_params,
                                             reduce_config)
    from repro_torch.models.schema import tree_map
    from repro_torch.serve import ServeEngine
    got = _launcher(tag, "serve", ["--arch", arch, "--reduced", "--engine",
                                   "static"])[0]
    args = launch_serve.parse_args([])
    cfg = reduce_config(get_config(arch))
    params = tree_map(lambda a: a.cpu(), init_lm_params(
        cfg, torch.Generator(device="cuda").manual_seed(args.seed)))
    prompts = np.random.default_rng(args.seed).integers(
        1, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    want = ServeEngine(cfg, params, max_len=args.prompt_len + args.max_new,
                       device="cpu").generate(prompts, args.max_new).tokens
    want = [f"seq{i}: {row.tolist()}" for i, row in enumerate(want[:2])]
    check(got == want, f"launch.serve --arch {arch}: the card's tokens "
                       f"{got} differ from the CPU's {want}")
    try:
        _launcher(tag, "serve", ["--arch", arch, "--reduced", "--engine",
                                 "paged"])
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None and "paged serving" in refused,
          f"launch.serve --arch {arch} --engine paged did not refuse")
    hist = _launcher(tag, "train", ["--arch", arch, "--reduced", "--steps",
                                    "3"])[2]["history"]
    check(len(hist) == 3 and all(math.isfinite(h) for h in hist),
          f"launch.train --arch {arch}: {hist}")
    print(f"{tag} (e) {arch} --reduced: launch.serve static prints the "
          f"CPU's greedy tokens on its weights ({len(got)} sequences); "
          f"--engine paged refuses ({refused}); launch.train took 3 steps, "
          f"loss {hist[0]:.4f} -> {hist[-1]:.4f}")


def phase_families(dev, card):
    """31. (Q) The MLA, hybrid and RWKV-6 families through the static
    engine. Returns this path's readings of K6 and K3 for the ``kernels``
    line."""
    import numpy as np
    import torch
    from repro_torch.models.registry import (get_config, init_lm_params,
                                             reduce_config)
    from repro_torch.models.schema import tree_map
    from repro_torch.serve import ServeEngine
    tag = "[31]"
    t_phase = time.perf_counter()

    # -- (a) the reduced configs, card against CPU, float32 ------------------
    for arch in FAMILY_ARCHS:
        cfg = reduce_config(get_config(arch))
        params = init_lm_params(cfg, torch.Generator().manual_seed(0))
        prompts = np.random.default_rng(31).integers(
            1, cfg.vocab_size, (3, 20)).astype(np.int32)
        got = {d: ServeEngine(cfg, params, max_len=30, device=d).generate(
            prompts, 10).tokens for d in ("cpu", dev)}
        check(np.array_equal(got["cpu"], got[dev]),
              f"reduced {arch}: card and CPU streams differ")
        print(f"{tag} (a) reduced {arch}, float32: the static engine's 3 "
              f"greedy streams of 10 tokens on the card equal the CPU's")
    P, max_new = 1024, 32
    rng = np.random.default_rng(31)
    k6_main, k3_main = 0, 0

    # -- (b) deepseek-v2-236b, depth cut to its head block + 4 MoE layers -----
    cfg = get_config("deepseek-v2-236b").replace(
        n_layers=1 + DEEPSEEK_MOE_LAYERS)
    V, n_moe = cfg.vocab_size, DEEPSEEK_MOE_LAYERS
    params = _drawn(tag, f"(b) deepseek-v2-236b cut to {cfg.n_layers} of 60 "
                    f"layers (the dense head block + {n_moe} MoE layers)",
                    cfg, dev)
    prompts = rng.integers(1, V, (8, P)).astype(np.int32)
    _mla_layer_check(tag, params, cfg, prompts, dev)
    runs = {}
    for form in ("expanded", "absorbed"):
        c = cfg.replace(opt_mla_absorbed=form == "absorbed")
        eng, res, rec, obs = _static_drive(
            tag, f"(b) {form} MLA, 8 x {P} tokens, {max_new} new", c,
            params, prompts, max_new, dev, keep_routes=True)
        k6, k5 = _softermax_counts()[0], _all_counts()[4]
        check(k6 == obs.calls == n_moe * max_new,
              f"deepseek {form}: K6 launches {k6}, MoE calls {obs.calls}, "
              f"want {n_moe} x {max_new}")
        check(k5 == 0 and _counts() == (0, 0) and _flash_counts()[0] == 0,
              f"deepseek {form}: an attention kernel launched")
        k6_main += k6
        print(f"{tag} (b) {form}: K6 {k6} (= MoE calls, {n_moe} x "
              f"{max_new}), dropped assignments {obs.dropped()}")
        _profile_static(tag, eng, prompts, f"(b) {form} decode, batch 8",
                        watch=("softermax_rows",))
        runs[form] = (res.tokens, rec.logits, obs.routes)
        del eng, rec, obs
        _free()
    print(f"{tag} (b) " + _forms_audit(
        tag, "absorbed vs expanded", runs["expanded"][0],
        runs["absorbed"][0], runs["expanded"][1], runs["absorbed"][1], V,
        runs["expanded"][2], runs["absorbed"][2], n_moe, P))
    a = cfg.mla
    mla_b = (a.kv_lora + a.qk_rope) * 2
    gqa_b = cfg.n_heads * (a.qk_nope + a.qk_rope + a.v_head) * 2
    print(f"{tag} (b) latent cache: {mla_b} bytes per token a layer "
          f"(kv_lora {a.kv_lora} + qk_rope {a.qk_rope}, bf16), against "
          f"{gqa_b} for {cfg.n_heads} heads' expanded K ({a.qk_nope} + "
          f"{a.qk_rope}) and V ({a.v_head}): {gqa_b / mla_b:.1f}x; "
          f"{cfg.n_layers} layers x 8 x {P + max_new} tokens "
          f"{cfg.n_layers * 8 * (P + max_new) * mla_b / 2 ** 20:.1f} MiB")
    del runs, params
    _free()

    # -- (c) hymba-1.5b, full depth: chunked and flash prefills ---------------
    cfg = get_config("hymba-1.5b")
    V, L = cfg.vocab_size, cfg.n_layers
    params = _drawn(tag, f"(c) hymba-1.5b, {L} layers, window {cfg.window} "
                    "(the ring wraps from the first decode step)", cfg, dev)
    prompts = rng.integers(1, V, (8, P)).astype(np.int32)
    runs = {}
    for impl in ("chunked", "flash"):
        c = cfg.replace(attention_impl=impl)
        eng, res, rec, _ = _static_drive(
            tag, f"(c) {impl} prefill, 8 x {P} tokens, {max_new} new", c,
            params, prompts, max_new, dev)
        k3, k3_tc = _flash_counts()[0], _flash_tc_counts()[0]
        want = L if impl == "flash" else 0
        check(k3 == k3_tc == want and _all_counts()[4] == 0 and
              _counts() == (0, 0),
              f"hymba {impl}: K3 launches {k3} ({k3_tc} on the tensor "
              f"cores), want {want}; K5 {_all_counts()[4]}")
        k3_main += k3
        print(f"{tag} (c) {impl}: K3 {k3} (tensor cores {k3_tc}; want "
              f"{want}), no decode kernel (the ring's plain decode)")
        if impl == "flash":
            _profile_static(tag, eng, prompts, "(c) decode, batch 8")
        runs[impl] = (res.tokens, rec.logits)
        del eng, rec
        _free()
    print(f"{tag} (c) " + _forms_audit(
        tag, "flash vs chunked prefill", runs["chunked"][0],
        runs["flash"][0], runs["chunked"][1], runs["flash"][1], V))
    del runs, params
    _free()

    # -- (d) rwkv6-7b, full depth ---------------------------------------------
    cfg = get_config("rwkv6-7b")
    V, L = cfg.vocab_size, cfg.n_layers
    params = _drawn(tag, f"(d) rwkv6-7b, {L} layers", cfg, dev)
    prompts = rng.integers(1, V, (8, P)).astype(np.int32)
    eng, res, rec, _ = _static_drive(
        tag, f"(d) bf16, 8 x {P} tokens, {max_new} new", cfg, params, prompts,
        max_new, dev)
    check(_all_counts() == (0,) * 7, "rwkv: a kernel launched")
    _profile_static(tag, eng, prompts, "(d) decode, batch 8")
    del eng
    _free()
    errs = _forward_errors(params, cfg, prompts, res, rec, dev)
    check(errs[0] <= BF16_ATOL,
          f"rwkv prefill logits vs lm_forward: {errs[0]} of the largest "
          f"logit > {BF16_ATOL}")
    noise = _row_count_noise(params, cfg, prompts, dev)
    rows = _decode_rows_noise(params, cfg, prompts, res, rec, dev)
    print(f"{tag} (d) bf16: prefill logits vs lm_forward over the grown "
          f"{P + max_new - 1} tokens {errs[0]:.4g} of the largest logit "
          f"(gate {BF16_ATOL}); the {max_new - 1} decode steps' "
          f"{min(errs[1:]):.4g}-{max(errs[1:]):.4g} (gated below at "
          f"{RWKV_BF16_LAYERS} layers). Row counts alone: the served run "
          f"again at {DECODE_COPIES} x 8 rows, fed the served tokens, its "
          f"first 8 rows' logits vs the served ones: prefill {rows[0]:.4g}, "
          f"decode steps {min(rows[1:]):.4g}-{max(rows[1:]):.4g}; position 0"
          f" (an empty state) over {8 * P} rows and over 8: "
          + ", ".join(f"{k} layers {v:.4g}" for k, v in noise.items()))
    del rec
    _free()
    n = RWKV_BF16_LAYERS
    cut = cfg.replace(n_layers=n)
    cparams = {**params, "blocks": tree_map(lambda a: a[:n],
                                            params["blocks"])}
    eng, res, rec, _ = _static_drive(
        tag, f"(d) bf16 cut to {n} layers, 8 x {P} tokens, {max_new} new",
        cut, cparams, prompts, max_new, dev)
    del eng
    errs = _forward_errors(cparams, cut, prompts, res, rec, dev)
    worst = max(range(len(errs)), key=errs.__getitem__)
    check(errs[worst] <= RWKV_BF16_TOL,
          f"rwkv bf16 at {n} layers: served logits vs lm_forward at step "
          f"{worst}: {errs[worst]} of the largest logit > {RWKV_BF16_TOL}")
    rows = _decode_rows_noise(cparams, cut, prompts, res, rec, dev)
    print(f"{tag} (d) bf16 at {n} layers: every step's served logits vs "
          f"lm_forward within {errs[worst]:.4g} of the largest logit (step "
          f"{worst}; gate {RWKV_BF16_TOL}), prefill step {errs[0]:.4g}; at "
          f"{DECODE_COPIES} x 8 rows vs 8: prefill {rows[0]:.4g}, decode "
          f"steps {min(rows[1:]):.4g}-{max(rows[1:]):.4g}")
    del rec, cparams
    # the same weights in float32 hold the decode path at full width
    params = tree_map(lambda a: a.float(), params)
    _free()
    c32 = cfg.replace(compute_dtype="float32")
    eng, res, rec, _ = _static_drive(
        tag, f"(d) float32, 8 x {P} tokens, {max_new} new", c32, params,
        prompts, max_new, dev)
    del eng
    errs = _forward_errors(params, c32, prompts, res, rec, dev)
    worst = max(range(len(errs)), key=errs.__getitem__)
    check(errs[worst] <= RWKV_F32_TOL,
          f"rwkv float32 served logits vs lm_forward at step {worst}: "
          f"{errs[worst]} of the largest logit > {RWKV_F32_TOL}")
    print(f"{tag} (d) float32: every step's served logits vs lm_forward "
          f"over the grown sequence within {errs[worst]:.4g} of the largest "
          f"logit (step {worst}; gate {RWKV_F32_TOL}), prefill step "
          f"{errs[0]:.4g}")
    del rec, params
    _free()
    times = _family_kernel_times(tag, dev)

    # -- (e) the launchers, reduced -------------------------------------------
    for arch in FAMILY_ARCHS:
        _family_launchers(tag, arch)
    print(f"{tag} phase time {time.perf_counter() - t_phase:.1f} s; {card}")
    times["softermax_rows"]["launches"] = k6_main
    times["flash_attention"]["launches"] = k3_main
    return times


WHISPER_NEW = 64         # phase 32: greedy tokens decoded per request
WHISPER_SLOTS = 448      # its self cache: whisper's decoder context
WHISPER_START = 50258    # <|startoftranscript|>, every request's first token
WHISPER_F32_TOL = 1e-4   # (b): served logits vs whisper_forward, float32
WHISPER_BF16_TOL = BF16_ATOL   # (b): the same in bf16
# (d): flash vs chunked, the loss and the gradient norm (relative; they
# read 2.24e-5 and 4.0e-5 on the H100), and each layer's attention weight
# gradient (relative L2, every leaf of the three attention stacks)
WHISPER_TRAIN_TOL = 1e-3
WHISPER_GRAD_TOL = 5e-2
# (stack, mixer) of whisper's three attention kinds
_WHISPER_ATTN = (("enc_blocks", "attn"), ("dec_blocks", "self_attn"),
                 ("dec_blocks", "cross_attn"))


def _whisper_serve(tag, label, cfg, params, frames, dev, card):
    """The serving loop over ``model_fns(cfg)``: ``prefill`` (encode, cross
    K/V), then ``WHISPER_NEW`` greedy ``decode_step``s from the start token
    into ``WHISPER_SLOTS`` self-cache slots, each synced and timed, the
    launch counts set to 0 just before (after an untimed prefill and step
    at the same shapes: the first calls' set-up stays out of the times).
    Returns (tokens (B, T) numpy, each step's logits, the cache, the last
    tokens)."""
    import numpy as np
    import torch
    from repro_torch.models.registry import model_fns
    fns = model_fns(cfg)
    B, V = frames.shape[0], cfg.vocab_size
    start = torch.full((B,), WHISPER_START, dtype=torch.int32, device=dev)
    with torch.no_grad():
        fns.decode_step(params, start, fns.prefill(
            params, {"frames": frames}, WHISPER_SLOTS)[1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        _, cache = fns.prefill(params, {"frames": frames}, WHISPER_SLOTS)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        tok, toks, logits, ms = start, [], [], []
        for _ in range(WHISPER_NEW):
            t0 = time.perf_counter()
            lg, cache = fns.decode_step(params, tok, cache)
            tok = lg[:, :V].argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            toks.append(tok)
            logits.append(lg)
    tokens = torch.stack(toks, 1).cpu().numpy()
    check(tokens.shape == (B, WHISPER_NEW) and
          all(torch.isfinite(lg).all().item() for lg in logits),
          f"whisper {label}: tokens {tokens.shape}, or non-finite logits")
    print(f"{tag} {label}: prefill (encode + cross K/V) {prefill_ms:.1f} ms;"
          f" {WHISPER_NEW} decode steps {np.mean(ms):.2f} ms per synced step "
          f"(min {min(ms):.2f}, max {max(ms):.2f}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; {card}")
    return tokens, logits, cache, tok


def _whisper_forward_errors(params, cfg, frames, tokens, logits, dev):
    """Each served step's logits against ``whisper_forward`` over the start
    token and the served tokens, at the same position: max |diff| over
    the largest |logit| of the step."""
    import numpy as np
    import torch
    from repro_torch.models.whisper import whisper_forward
    V = cfg.vocab_size
    grown = np.concatenate([np.full((len(tokens), 1), WHISPER_START,
                                    np.int32), tokens[:, :-1]], 1)
    with torch.no_grad():
        fwd = whisper_forward(params, frames, torch.as_tensor(
            grown, device=dev), cfg)
    return [_rel(lg[:, :V], fwd[:, s, :V]) for s, lg in enumerate(logits)]


def _reading(err, ms, plain, nbytes, flops, lib, peak="bfloat16"):
    """A kernel's reading at one shape of a phase's path: its error and
    times beside the bound (``nbytes`` moved, ``flops`` at ``peak``)."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / PEAK_FLOPS[peak] * 1e3
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": lib}


def _whisper_kernels(tag, dev, card):
    """(c) K3 and K4 at the encoder's (8 x 8 heads, 1500 x 1500, D 64,
    non-causal), the cross attention's (448 queries over 1500 keys,
    non-causal) and the decoder's (448 x 448, causal) shapes, K5 at G = 1,
    D 64 over 448 slots, in bf16: each against its plain version within
    ``tolerance(bf16)``, on its redesigned route (tensor cores, bulk copy).
    The float32 serve of (b) runs K3 on the CUDA cores at the encoder's
    shape and K5 at G = 1 in float32: both held the same way within
    ``tolerance(float32)``, K3 off the tensor cores, K5 on the bulk copy.
    Each one's device ms (CUDA events, L2 flushed) beside the plain
    version's, the bound (at its dtype's peak) and SDPA with scale ln 2
    (autograd's backward for K4). Timing and comparison launches do not
    count."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain)
    from repro_torch.kernels.flash_decode import decode_ref, flash_decode
    from repro_torch.kernels.parity import parity_error, tolerance
    saved = _save_counts()
    bf, f32 = torch.bfloat16, torch.float32
    tol = tolerance(bf)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rng = np.random.default_rng(32)
    B, H, D, F_, S = 8, 8, 64, 1500, WHISPER_SLOTS
    out = {"flash_attention": {}, "flash_attention_bwd": {},
           "flash_decode": {}}

    for name, sq, sk, causal in (("encoder", F_, F_, False),
                                 ("cross", S, F_, False),
                                 ("decoder", S, S, True)):
        q = _rand(rng, (B, H, sq, D), D ** -0.5).to(dev, bf)
        k = _rand(rng, (B, H, sk, D)).to(dev, bf)
        v = _rand(rng, (B, H, sk, D)).to(dev, bf)
        do = _rand(rng, (B, H, sq, D)).to(dev, bf)
        tc0 = _flash_tc_counts()
        o, m, d = flash_attention(q, k, v, causal=causal, return_stats=True)
        grads = flash_attention_bwd(q, k, v, o, do, m, d, causal=causal)
        check(tuple(b - a for a, b in zip(tc0, _flash_tc_counts())) ==
              (1, 2), f"whisper {name} shape: K3/K4 not on the tensor cores")
        err3, held3 = parity_error(o, flash_attention_plain(
            q, k, v, causal=causal))
        err4, held4 = map(max, zip(*(parity_error(g, w) for g, w in zip(
            grads, flash_attention_bwd_plain(q, k, v, o, do, m, d,
                                             causal=causal)))))
        check(held3 <= tol and held4 <= tol,
              f"whisper {name} shape: K3 {err3} ({held3}), K4 {err4} "
              f"({held4}) > {tol}")
        pairs = B * H * (sq * (sq + 1) // 2 if causal else sq * sk)

        def sdpa(a, b_, c, causal=causal):
            return F.scaled_dot_product_attention(a, b_, c, is_causal=causal,
                                                  scale=math.log(2))

        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        lo = sdpa(ql, kl, vl)
        qb, kvb = q.numel() * 2, k.numel() * 2
        stats = 2 * B * H * sq * 4
        out["flash_attention"][name] = _reading(
            err3, _time_ms(lambda: flash_attention(
                q, k, v, causal=causal, return_stats=True), flush, iters=10),
            _time_ms(lambda: flash_attention_plain(q, k, v, causal=causal),
                     flush, iters=3),
            2 * qb + 2 * kvb + stats, 4 * D * pairs,
            _time_ms(lambda: sdpa(q, k, v), flush, iters=10))
        out["flash_attention_bwd"][name] = _reading(
            err4, _time_ms(lambda: flash_attention_bwd(
                q, k, v, o, do, m, d, causal=causal), flush, iters=10),
            _time_ms(lambda: flash_attention_bwd_plain(
                q, k, v, o, do, m, d, causal=causal), flush, iters=3),
            4 * qb + 4 * kvb + stats, 10 * D * pairs,
            _time_ms(lambda: torch.autograd.grad(lo, (ql, kl, vl), do,
                                                 retain_graph=True),
                     flush, iters=10))
        del q, k, v, do, o, m, d, grads, ql, kl, vl, lo
    # K3 in float32 at the encoder's shape: the CUDA-core kernel
    q = _rand(rng, (B, H, F_, D), D ** -0.5).to(dev, f32)
    k = _rand(rng, (B, H, F_, D)).to(dev, f32)
    v = _rand(rng, (B, H, F_, D)).to(dev, f32)
    k3_0, tc0 = _flash_counts()[0], _flash_tc_counts()[0]
    got = flash_attention(q, k, v, causal=False)
    check(_flash_counts()[0] == k3_0 + 1 and _flash_tc_counts()[0] == tc0,
          "whisper float32 encoder shape: K3 not on the CUDA cores")
    err3, held3 = parity_error(got, flash_attention_plain(q, k, v,
                                                          causal=False))
    check(held3 <= tolerance(f32), f"whisper float32 encoder shape: K3 "
                                   f"{err3} > {tolerance(f32)}")
    pairs = B * H * F_ * F_
    out["flash_attention"]["encoder_f32"] = _reading(
        err3, _time_ms(lambda: flash_attention(q, k, v, causal=False), flush,
                       iters=5),
        _time_ms(lambda: flash_attention_plain(q, k, v, causal=False), flush,
                 iters=3),
        2 * q.numel() * 4 + 2 * k.numel() * 4, 4 * D * pairs,
        _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=math.log(2)), flush, iters=5), peak="float32")
    del q, k, v, got
    # K5: one token a row over the self cache, G = 1, in bf16 and float32
    n = WHISPER_NEW       # the main path's last step reads 64 rows a row
    for name, dt in (("bf16", bf), ("float32", f32)):
        q = _rand(rng, (B, H, D), D ** -0.5).to(dev, dt)
        k = _rand(rng, (B, H, S, D)).to(dev, dt)
        v = _rand(rng, (B, H, S, D)).to(dev, dt)
        errs = []
        for lens in ([1, 2, 63, 64, 65, 200, 447, 448], [n] * B):
            ln = torch.tensor(lens, dtype=torch.int32, device=dev)
            b0 = _route_counts()[0]
            got = flash_decode(q, k, v, ln)
            check(_route_counts()[0] == b0 + 1,
                  f"whisper K5 {name}: not on the bulk-copy route")
            errs.append(parity_error(got, decode_ref(q, k, v, ln)))
        err5, held5 = map(max, zip(*errs))
        check(held5 <= tolerance(dt),
              f"whisper K5 {name}: {err5} ({held5}) > {tolerance(dt)}")

        def sdpa5(q=q, k=k, v=v):
            return F.scaled_dot_product_attention(
                q[:, :, None], k[:, :, :n], v[:, :, :n], scale=math.log(2))

        size = k.element_size()
        out["flash_decode"][name] = _reading(
            err5, _time_ms(lambda: flash_decode(q, k, v, ln), flush),
            _time_ms(lambda: decode_ref(q, k, v, ln), flush),
            2 * B * H * n * D * size + 2 * q.numel() * size + B * 4,
            4 * B * H * n * D, _time_ms(sdpa5, flush),
            peak="bfloat16" if dt == bf else "float32")
        del q, k, v, got
    _restore_counts(saved)
    for kname, shapes in out.items():
        for shape, e in shapes.items():
            where = f"{n} of {S} rows, {shape}" if kname == "flash_decode" \
                else f"the {shape} shape"
            t = tolerance(f32 if shape in ("encoder_f32", "float32") else bf)
            print(f"{tag} (c) {kname} at {where}: {e['ms']:.4f} ms"
                  f" (plain {e['plain_ms']:.4f}, bound {e['bound_ms']:.4f} by"
                  f" {e['bound_by']}, SDPA {e['library_ms']:.4f}; max |err| "
                  f"{e['max_abs_err']:.3g}, within {t}); {card}")
    return out


def phase_whisper(dev, card):
    """32. (R) whisper-base, whole, at full width. Returns this path's
    readings of K3, K4 and K5 for the ``kernels`` line and its flash
    training step (``_timed_step``)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.registry import get_config, model_fns
    from repro_torch.models.schema import tree_map
    from repro_torch.models.whisper import _cross_decode
    from repro_torch.optim import adamw
    from repro_torch.train import make_loss_and_grad, make_train_step
    tag = "[32]"
    t_phase = time.perf_counter()
    cfg = get_config("whisper-base")
    V, L, B = cfg.vocab_size, cfg.n_layers, 8
    check(L == cfg.n_enc_layers == 6 and cfg.d_model == 512 and
          cfg.padded_vocab == 51968 and cfg.enc_positions == 1500,
          f"whisper-base config: {cfg}")
    params = _drawn(tag, f"(a) whisper-base, {cfg.n_enc_layers} + {L} "
                    f"layers, d {cfg.d_model}, vocab {V} (padded "
                    f"{cfg.padded_vocab})", cfg, dev)
    g = torch.Generator(device=dev).manual_seed(32)
    # the stub frontend's output: random frame embeddings
    frames = torch.randn((B, cfg.enc_positions, cfg.d_model), generator=g,
                         device=dev)

    # -- (a) encode and serve, under flash and chunked ----------------------
    runs = {}
    k3_tc = k5_bf16 = 0
    for impl in ("flash", "chunked"):
        c = cfg.replace(attention_impl=impl)
        toks, logits, cache, tok = _whisper_serve(
            tag, f"(a) {impl}, 8 x {cfg.enc_positions} frames, "
            f"{WHISPER_NEW} new tokens", c, params, frames, dev, card)
        counts = _all_counts()
        k3 = L if impl == "flash" else 0
        want = (0, 0, k3, 0, L * WHISPER_NEW, 0, 0)
        check(counts == want and _flash_tc_counts()[0] == k3 and
              _route_counts()[0] == counts[4],
              f"whisper {impl}: launches (K1..K7) {counts}, want {want}; K3 "
              f"on the tensor cores {_flash_tc_counts()[0]}, K5 on the "
              f"bulk-copy route {_route_counts()[0]}")
        print(f"{tag} (a) {impl}: K3 {counts[2]} (the encoder's {L} layers,"
              f" tensor cores {_flash_tc_counts()[0]}), K5 {counts[4]} ("
              f"{L} a decode step, bulk copy {_route_counts()[0]}), no other "
              f"kernel")
        runs[impl] = (toks, logits, counts)
        k3_tc += counts[2]
        k5_bf16 += counts[4]
        if impl == "flash":
            fns = model_fns(c)
            state = [tok, cache]

            def step():
                lg, state[1] = fns.decode_step(params, state[0], state[1])
                state[0] = lg[:, :V].argmax(-1).to(torch.int32)

            hx = torch.randn((B, cfg.d_model), generator=g, device=dev
                             ).to(c.compute_dtype_)
            blocks = params["dec_blocks"]["cross_attn"]

            def cross():
                for i in range(L):
                    _cross_decode({k: w[i] for k, w in blocks.items()}, hx,
                                  cache["xk"][i], cache["xv"][i], c)

            with torch.no_grad():
                wall, kern = _kernel_us(step, 5)
                _, ckern = _kernel_us(cross, 5)
            ms_step = wall * 1e3 / 5
            busy = sum(kern.values()) / 1e3 / 5
            k5_ms = sum(v for n, v in kern.items() if n.startswith(
                ("decode_bulk_kernel", "decode_kernel"))) / 1e3 / 5
            cbusy = sum(ckern.values()) / 1e3 / 5
            top = sorted(kern.items(), key=lambda kv: -kv[1])[:5]
            print(f"{tag} (a) decode profile over 5 steps (batch 8, self "
                  f"cache at {WHISPER_NEW}-{WHISPER_NEW + 5} of "
                  f"{WHISPER_SLOTS}): {ms_step:.2f} ms per step, device busy "
                  f"{busy:.3f} ms ({100 * busy / ms_step:.0f}%); K5 "
                  f"{k5_ms:.3f} ms ({100 * k5_ms / busy:.1f}% of busy); the "
                  f"plain cross decode's {L} layers alone (8 x 1500 static "
                  f"rows a layer) {cbusy:.3f} ms busy "
                  f"({100 * cbusy / busy:.1f}% of a step's busy time); by "
                  f"kernel (ms per step): " + ", ".join(
                      f"{n} {v / 5e3:.3f}" for n, v in top) + f"; {card}")
        del cache, logits
        _free()
    print(f"{tag} (a) " + _forms_audit(
        tag, "flash vs chunked encoder", runs["chunked"][0],
        runs["flash"][0], runs["chunked"][1], runs["flash"][1], V))

    # -- (b) served logits against the teacher-forced forward ---------------
    c = cfg.replace(attention_impl="flash")
    errs = _whisper_forward_errors(params, c, frames, runs["flash"][0],
                                   runs["flash"][1], dev)
    worst = max(range(len(errs)), key=errs.__getitem__)
    check(errs[worst] <= WHISPER_BF16_TOL,
          f"whisper bf16: served logits vs whisper_forward at step {worst}: "
          f"{errs[worst]} of the largest logit > {WHISPER_BF16_TOL}")
    del runs
    p32 = tree_map(lambda a: a.float(), params)
    c32 = c.replace(compute_dtype="float32")
    toks, logits, _, _ = _whisper_serve(
        tag, "(b) float32, flash", c32, p32, frames, dev, card)
    counts = _all_counts()
    check(counts == (0, 0, L, 0, L * WHISPER_NEW, 0, 0) and
          _flash_tc_counts()[0] == 0 and _route_counts()[0] == counts[4],
          f"whisper float32: launches (K1..K7) {counts}, K3 on the tensor "
          f"cores {_flash_tc_counts()[0]} (want 0: f32 takes the CUDA "
          f"cores), K5 on the bulk-copy route {_route_counts()[0]}")
    k3_f32, k5_f32 = counts[2], counts[4]
    # the float32 reference runs chunked: no kernel, so the served path's
    # encoder (K3 on the CUDA cores) is held to code that shares none
    errs32 = _whisper_forward_errors(
        p32, c32.replace(attention_impl="chunked"), frames, toks, logits, dev)
    w32 = max(range(len(errs32)), key=errs32.__getitem__)
    check(errs32[w32] <= WHISPER_F32_TOL,
          f"whisper float32: served logits vs whisper_forward (chunked) at "
          f"step {w32}: {errs32[w32]} of the largest logit > "
          f"{WHISPER_F32_TOL}")
    print(f"{tag} (b) every served step's logits vs whisper_forward over the "
          f"grown sequence: bf16 (forward under flash) within "
          f"{errs[worst]:.4g} of the largest logit (step {worst}; gate "
          f"{WHISPER_BF16_TOL}), float32 (forward under chunked, no kernel)"
          f" within {errs32[w32]:.4g} (step {w32}; gate {WHISPER_F32_TOL});"
          f" {card}")
    del p32, logits
    _free()

    # -- (c) the kernels at this path's shapes ------------------------------
    out = _whisper_kernels(tag, dev, card)

    # -- (d) one training step at full width ---------------------------------
    seq = torch.randint(0, V, (B, WHISPER_SLOTS + 1), generator=g,
                        device=dev, dtype=torch.int32)
    batch = {"frames": frames, "tokens": seq[:, :-1], "labels": seq[:, 1:]}
    tc = TrainConfig(total_steps=2, warmup_steps=1, learning_rate=3e-4)
    master = tree_map(lambda a: a.float(), params)      # fp32 master weights
    del params
    _free()
    rows, attn_grads = {}, {}
    for impl in ("chunked", "flash"):
        c = cfg.replace(attention_impl=impl, remat="full")
        p = tree_map(torch.clone, master)
        step = make_train_step(model_fns(c).loss, tc)
        opt = adamw.init_state(p)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        p, opt, met = step(p, opt, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rows[impl] = ({k: float(v) for k, v in met.items()}, dt,
                      torch.cuda.max_memory_allocated(), _flash_counts(),
                      _flash_tc_counts())
        check(all(math.isfinite(v) for v in rows[impl][0].values()),
              f"whisper training, {impl}: {rows[impl][0]}")
        del p, opt, step
        # the gradients of the same step's master weights, for (d)'s gate
        grads = make_loss_and_grad(model_fns(c).loss, tc)(master, batch)[2]
        attn_grads[impl] = {(stack, mixer, w): grads[stack][mixer][w]
                            for stack, mixer in _WHISPER_ATTN
                            for w in ("wq", "wk", "wv", "wo")}
        del grads
        _free()
    m_c, m_f = rows["chunked"][0], rows["flash"][0]
    k34, k34_tc = rows["flash"][3], rows["flash"][4]
    n_att = 3 * L               # encoder, decoder self and cross, a forward
    check(k34 == (2 * n_att, 2 * n_att) and k34_tc == k34 and
          rows["chunked"][3] == (0, 0),
          f"whisper training: K3/K4 {k34} (tensor cores {k34_tc}), want "
          f"{2 * n_att} each (a forward and its remat recompute; two "
          f"backward kernels per attention); chunked {rows['chunked'][3]}")
    rel_l = abs(m_f["loss"] - m_c["loss"]) / abs(m_c["loss"])
    rel_g = abs(m_f["grad_norm"] - m_c["grad_norm"]) / m_c["grad_norm"]
    check(rel_l <= WHISPER_TRAIN_TOL and rel_g <= WHISPER_TRAIN_TOL,
          f"whisper training: flash loss {m_f['loss']} / grad norm "
          f"{m_f['grad_norm']} vs chunked {m_c['loss']} / "
          f"{m_c['grad_norm']} > {WHISPER_TRAIN_TOL}")
    # each layer's attention weight gradient, flash against chunked
    leaf_errs = {}
    for key, gc in attn_grads["chunked"].items():
        gf = attn_grads["flash"][key]
        for i in range(L):
            leaf_errs[key + (i,)] = ((gf[i] - gc[i]).norm() /
                                     gc[i].norm()).item()
    worst_leaf = max(leaf_errs, key=leaf_errs.get)
    check(leaf_errs[worst_leaf] <= WHISPER_GRAD_TOL,
          f"whisper training: flash vs chunked gradient of "
          f"{'.'.join(map(str, worst_leaf))}: relative L2 "
          f"{leaf_errs[worst_leaf]} > {WHISPER_GRAD_TOL}")
    for impl, (met, dt, peak, k, _) in rows.items():
        print(f"{tag} (d) one AdamW step, {impl}, B {B}, {WHISPER_SLOTS} "
              f"decoder tokens, {cfg.enc_positions} frames, remat full: loss "
              f"{met['loss']:.5f}, grad norm {met['grad_norm']:.4f}, "
              f"{dt:.3f} s, peak memory {peak / 2 ** 30:.2f} GiB, K3 {k[0]}, "
              f"K4 {k[1]}; {card}")
    by_stack = {sm: max(e for k, e in leaf_errs.items() if k[:2] == sm)
                for sm in _WHISPER_ATTN}
    print(f"{tag} (d) flash vs chunked: loss rel diff {rel_l:.3g}, grad norm "
          f"rel diff {rel_g:.3g} (gate {WHISPER_TRAIN_TOL} each); the "
          f"attention weights' gradients, largest relative L2 of a layer's "
          f"leaf: " + ", ".join(f"{'.'.join(sm)} {e:.3g}"
                                for sm, e in by_stack.items()) +
          f" (worst {'.'.join(map(str, worst_leaf))}; gate "
          f"{WHISPER_GRAD_TOL}); {card}")
    del master, batch, frames
    _free()
    print(f"{tag} phase time {time.perf_counter() - t_phase:.1f} s; {card}")
    # the tensor-core launches (bf16 serve and training) and the float32
    # serve's CUDA-core ones, each beside the readings of its own route
    out["flash_attention"]["launches"] = k3_tc + k34[0]
    out["flash_attention"]["encoder_f32"]["launches"] = k3_f32
    out["flash_attention_bwd"]["launches"] = k34[1]
    out["flash_decode"]["bf16"]["launches"] = k5_bf16
    out["flash_decode"]["float32"]["launches"] = k5_f32
    return out, _timed_step("whisper-base train", cfg, "train", B,
                            WHISPER_SLOTS, [rows["flash"][1]])


PARALLEL_LAYERS = 2      # phase 33: llama3.2-3b's depth cut for the DDP steps
PARALLEL_SEQ = 1024      # phase 33: tokens a row of the DDP steps' batches
PARALLEL_ROWS = 2        # phase 33: rows a rank of the DDP steps' batches
PARALLEL_LR = 1e-5       # phase 33 (b): AdamW's first step moves ~lr an element
RING_TOL = BF16_ATOL     # phase 33 (a): the ring against chunked, bf16
MOE_EP_TOL = 1e-2        # phase 33 (a): y of the EP path, relative, bf16


def _timed_spy(module, name, seen=None):
    """Replace ``module.name`` by a wrapper that synchronizes the card
    around each call and adds its seconds to the returned list's first
    entry and counts the call in its second; with ``seen`` each call's
    arguments and a copy of its result (a tuple of tensors) are appended.
    Returns (the list, a function putting the original back)."""
    import torch
    inner = getattr(module, name)
    spent = [0.0, 0]

    def spy(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = inner(*args, **kw)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        spent[1] += 1
        if seen is not None:      # copies: the caller may change them
            seen.append((args, [t.clone() for t in r]))
        return r

    setattr(module, name, spy)
    return spent, lambda: setattr(module, name, inner)


def _plain_quantization(x):
    """The int8 codes' mean over one rank and the residual of ``x``, by
    the reference's arithmetic without a collective."""
    import torch
    from repro_torch.parallel.collectives import _INV127
    xf = x.float()
    scale = torch.clamp(torch.amax(torch.abs(xf)), min=1e-12) * _INV127
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    resid = (xf.double() - q.double() * scale.double()).float()
    return (q.to(torch.int32).float() * scale) / 1.0, resid


def _parallel_ddp(tag, mesh, dev, card):
    """(a) one compressed DDP step of llama3.2-3b (depth cut) on the
    one-rank group: K3/K4 launched and counted, the int8 codes and the
    residuals equal to the plain quantization, the step's time and the
    compressed all-reduce's share; then K3/K4 held to their plain versions
    at the step's attention shape (``_parallel_flash``)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.registry import get_config, model_fns
    from repro_torch.models.schema import tree_leaves, tree_map
    from repro_torch.optim import adamw
    from repro_torch.parallel import collectives
    from repro_torch.train.step import make_ddp_train_step
    L, S, B = PARALLEL_LAYERS, PARALLEL_SEQ, PARALLEL_ROWS
    cfg = get_config("llama3.2-3b").replace(n_layers=L,
                                            attention_impl="flash")
    tc = TrainConfig(grad_compression=True, total_steps=3, warmup_steps=1,
                     learning_rate=3e-4)
    params = _true_fan_in(model_fns(cfg).init(
        torch.Generator(device=dev).manual_seed(0)))
    errors = tree_map(torch.zeros_like, params)
    batch = next(SyntheticLMData(cfg.vocab_size, S, B, seed=0))
    seen, times = [], []
    spent, restore = _timed_spy(collectives, "compressed_psum", seen)
    try:
        step = make_ddp_train_step(model_fns(cfg).loss, tc, mesh)
        opt = adamw.init_state(params)
        for i in range(2):     # the first call carries the set-up
            if i:
                seen.clear()
                spent[:] = [0.0, 0]
                _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, errors, m = step(params, opt, errors, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    finally:
        restore()
    dt = times[1]
    k34, k34_tc = _flash_counts(), _flash_tc_counts()
    check(k34 == (2 * L, 2 * L) and k34_tc == k34,
          f"{tag} (a) DDP step: K3/K4 launches {k34}, on the tensor cores "
          f"{k34_tc}, expected {2 * L} each")
    check(np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"])), f"{tag} (a) DDP step metrics {m}")
    leaves = tree_leaves(errors)
    check(len(seen) == len(leaves), f"{tag} (a) {len(seen)} compressed "
                                    f"all-reduces for {len(leaves)} leaves")
    n_codes = 0
    for ((x, *_), (mean, resid)), e in zip(seen, leaves):
        want_mean, want_resid = _plain_quantization(x)
        check(torch.equal(mean, want_mean) and torch.equal(resid, want_resid)
              and torch.equal(e, resid),
              f"{tag} (a) int8 codes or residuals differ from the plain "
              f"quantization at a leaf of shape {tuple(x.shape)}")
        n_codes += x.numel()
    print(f"{tag} (a) DDP step, llama3.2-3b at full width cut to {L} "
          f"layers, flash, bf16, B {B} x {S}, grad_compression, one-rank "
          f"NCCL group: loss {float(m['loss']):.5f}, grad norm "
          f"{float(m['grad_norm']):.4f} (step 2); K3 {k34[0]}, K4 {k34[1]} "
          f"(tensor cores) a step; {n_codes} int8 codes and residuals EQUAL "
          f"to the plain quantization (step 2, its gradients fed with step "
          f"1's residuals); step 1 {times[0]:.3f} s (set-up inside), step 2 "
          f"{dt:.3f} s, compressed all-reduce "
          f"(quantize, MAX and SUM all-reduces, dequantize) {spent[0]:.3f} "
          f"s = {100 * spent[0] / dt:.1f}% of it (card synchronized around "
          f"each of its {len(seen)} calls); {card}")
    del params, opt, errors, seen, leaves
    _free()
    return {"launches": k34, "step_s": dt, "allreduce_s": spent[0],
            "shapes": _parallel_flash(tag, dev, card)}


def _parallel_flash(tag, dev, card):
    """(a) K3 and K4 at the DDP steps' attention shape (llama3.2-3b's
    24/8 heads, D 128, causal, ``PARALLEL_SEQ`` keys, two rows): in bf16
    as (a)'s step runs them, on the tensor cores, and in float32 as each
    rank of (b) runs them, on the CUDA cores; each against its plain
    version, with its device ms beside the plain version's, the bound and
    SDPA (autograd's backward for K4). bf16 outputs are held within
    ``tolerance(bf16)`` of each element's size; float32 outputs within
    ``tolerance(float32)`` times max(1, the output's largest magnitude):
    dK and dV sum 1024 rows of 3 query heads, and another order of those
    f32 sums moves their largest elements by more than 1e-5 absolute.
    Comparison and timing launches do not count."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain)
    from repro_torch.kernels.parity import parity_error, tolerance
    saved = _save_counts()
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rng = np.random.default_rng(33)
    B, Hq, Hkv, S, D = 2, 24, 8, PARALLEL_SEQ, 128
    pairs = B * Hq * S * (S + 1) // 2
    out = {"flash_attention": {}, "flash_attention_bwd": {}}
    helds = {}

    def sdpa(a, b, c):
        return F.scaled_dot_product_attention(a, b, c, is_causal=True,
                                              scale=math.log(2),
                                              enable_gqa=True)

    for name, dt, on_tc in (("ddp_bf16", torch.bfloat16, True),
                            ("ddp_f32", torch.float32, False)):
        q = _rand(rng, (B, Hq, S, D), D ** -0.5).to(dev, dt)
        k = _rand(rng, (B, Hkv, S, D)).to(dev, dt)
        v = _rand(rng, (B, Hkv, S, D)).to(dev, dt)
        do = _rand(rng, (B, Hq, S, D)).to(dev, dt)
        c0, tc0 = _flash_counts(), _flash_tc_counts()
        o, m, d = flash_attention(q, k, v, return_stats=True)
        grads = flash_attention_bwd(q, k, v, o, do, m, d)
        ran = tuple(b - a for a, b in zip(c0, _flash_counts()))
        ran_tc = tuple(b - a for a, b in zip(tc0, _flash_tc_counts()))
        check(ran == (1, 2) and ran_tc == ((1, 2) if on_tc else (0, 0)),
              f"{tag} (a) {name}: K3/K4 launches {ran}, on the tensor "
              f"cores {ran_tc}; expected (1, 2) on "
              f"{'the tensor' if on_tc else 'the CUDA'} cores")
        def held(got, want):
            err, h = parity_error(got, want)
            if not on_tc:
                h = err / max(1.0, float(want.abs().max()))
            return err, h

        err3, held3 = held(o, flash_attention_plain(q, k, v))
        err4, held4 = map(max, zip(*(held(g, w) for g, w in zip(
            grads, flash_attention_bwd_plain(q, k, v, o, do, m, d)))))
        tol = tolerance(dt)
        check(held3 <= tol and held4 <= tol,
              f"{tag} (a) {name}: K3 {err3} (held {held3}), K4 {err4} (held "
              f"{held4}) > {tol}")
        helds[name] = (held3, held4)
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        lo = sdpa(ql, kl, vl)
        el = q.element_size()
        qb, kvb, stats = q.numel() * el, k.numel() * el, 2 * B * Hq * S * 4
        peak = "bfloat16" if on_tc else "float32"
        out["flash_attention"][name] = _reading(
            err3, _time_ms(lambda: flash_attention(q, k, v,
                                                   return_stats=True),
                           flush, iters=10),
            _time_ms(lambda: flash_attention_plain(q, k, v), flush, iters=3),
            2 * qb + 2 * kvb + stats, 4 * D * pairs,
            _time_ms(lambda: sdpa(q, k, v), flush, iters=10), peak=peak)
        out["flash_attention_bwd"][name] = _reading(
            err4, _time_ms(lambda: flash_attention_bwd(q, k, v, o, do, m, d),
                           flush, iters=10),
            _time_ms(lambda: flash_attention_bwd_plain(q, k, v, o, do, m, d),
                     flush, iters=3),
            4 * qb + 4 * kvb + stats, 10 * D * pairs,
            _time_ms(lambda: torch.autograd.grad(lo, (ql, kl, vl), do,
                                                 retain_graph=True),
                     flush, iters=10), peak=peak)
        del q, k, v, do, o, m, d, grads, ql, kl, vl, lo
    _restore_counts(saved)
    for i, (kname, shapes) in enumerate(out.items()):
        for name, e in shapes.items():
            if name == "ddp_bf16":
                route, rule = "tensor cores", "of each element's size"
                t = tolerance(torch.bfloat16)
            else:
                route, rule = "CUDA cores", "x max(1, max |want|)"
                t = tolerance(torch.float32)
            print(f"{tag} (a) {kname} at the DDP step's shape ({name}, B "
                  f"{B}, {Hq}/{Hkv} heads, S {S}, D {D}, causal, {route}): "
                  f"{e['ms']:.4f} ms (plain {e['plain_ms']:.4f}, bound "
                  f"{e['bound_ms']:.4f} by {e['bound_by']}, SDPA "
                  f"{e['library_ms']:.4f}); max |err| vs plain "
                  f"{e['max_abs_err']:.3g}, held {helds[name][i]:.3g} <= "
                  f"{t} {rule}; {card}")
    del flush
    _free()
    return out


def _parallel_ring(tag, mesh, dev, card):
    """(a) ring_attention at llama3.2-3b's attention shape on the one-rank
    group against chunked_attention, forward and gradients."""
    import torch
    from repro_torch.models.attention import chunked_attention
    from repro_torch.parallel.ring_attention import ring_attention
    B, Hq, Hkv, S, D = 1, 24, 8, 4096, 128
    g = torch.Generator(device=dev).manual_seed(33)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale) \
            .bfloat16().requires_grad_()

    q, k, v = rnd(B, Hq, S, D, scale=D ** -0.5), rnd(B, Hkv, S, D), \
        rnd(B, Hkv, S, D)
    do = torch.randn(B, Hq, S, D, generator=g, device=dev).bfloat16()
    grads = {}
    for name, fn in (("ring", lambda q, k, v: ring_attention(
            q, k, v, mesh, causal=True)),
                     ("chunked", lambda q, k, v: chunked_attention(
            q, k, v, causal=True, intmax=True, chunk=512))):
        for t in (q, k, v):
            t.grad = None
        o = fn(q, k, v)
        o.backward(do)
        grads[name] = (o.detach().float(), *(t.grad.float()
                                             for t in (q, k, v)))
    errs = [float((a - b).abs().max()) / (1.0 if i == 0 else
                                          float(b.abs().max()))
            for i, (a, b) in enumerate(zip(grads["ring"],
                                           grads["chunked"]))]
    check(errs[0] <= RING_TOL and max(errs[1:]) <= RING_TOL,
          f"{tag} (a) ring vs chunked: |o| err {errs[0]:.3g}, dq/dk/dv "
          f"relative {errs[1:]} (gate {RING_TOL})")
    with torch.no_grad():
        ms = {n: _time_ms(f, torch.empty(0, device=dev), iters=5)
              for n, f in (("ring", lambda: ring_attention(
                  q, k, v, mesh, causal=True)),
                           ("chunked", lambda: chunked_attention(
                  q, k, v, causal=True, intmax=True, chunk=512)))}
    print(f"{tag} (a) ring_attention, B {B}, {Hq}/{Hkv} heads, D {D}, S {S}, "
          f"bf16, causal, one-rank NCCL group (one block in its ring) vs "
          f"chunked_attention (chunk 512): max |o err| {errs[0]:.3g}, "
          f"dq/dk/dv max err / max |grad| {errs[1]:.3g} / {errs[2]:.3g} / "
          f"{errs[3]:.3g} (gate {RING_TOL}); forward {ms['ring']:.3f} ms "
          f"vs chunked {ms['chunked']:.3f} ms; no kernel (the reference "
          f"computes the ring outside any Pallas kernel); {card}")
    del q, k, v, do, grads
    _free()


def _parallel_moe(tag, mesh, dev, card):
    """(a) moe_apply_shard_map at moonshot-v1-16b-a3b's width (phase 30's
    training cut, 2 MoE layers) on the one-rank group against
    _moe_apply_global, K6 counted."""
    import torch
    from repro_torch.kernels.softermax import softermax_rows
    from repro_torch.models import moe
    from repro_torch.models.registry import get_config
    from repro_torch.models.schema import layer_params, n_stacked
    cfg = get_config(MOE_ARCH).replace(n_layers=MOE_TRAIN_LAYERS)
    params = _drawn(tag, f"(a) {MOE_ARCH} cut to {MOE_TRAIN_LAYERS} MoE "
                    "layers", cfg, dev)
    B, S, d = 8, 128, cfg.d_model
    x = torch.randn(B, S, d, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(34)) \
        .bfloat16()
    rows, k6 = [], 0
    for i in range(n_stacked(params["blocks"])):
        fp = layer_params(params["blocks"], i)["ffn"]
        with torch.no_grad():
            y_g, aux_g = moe._moe_apply_global(fp, x, cfg)
            c0 = softermax_rows.launches
            y_e, aux_e = moe.moe_apply_shard_map(fp, x, cfg, mesh)
            k6 += softermax_rows.launches - c0
            saved = _save_counts()
            t_g = _time_ms(lambda: moe._moe_apply_global(fp, x, cfg),
                           torch.empty(0, device=dev), iters=5)
            t_e = _time_ms(lambda: moe.moe_apply_shard_map(fp, x, cfg, mesh),
                           torch.empty(0, device=dev), iters=5)
            _restore_counts(saved)
        err = float((y_e.float() - y_g.float()).abs().max()) / \
            float(y_g.float().abs().max())
        err_aux = abs(float(aux_e) - float(aux_g)) / abs(float(aux_g))
        check(err <= MOE_EP_TOL and err_aux <= MOE_EP_TOL,
              f"{tag} (a) layer {i}: EP y err {err:.3g}, aux {err_aux:.3g} "
              f"(gate {MOE_EP_TOL})")
        rows.append((err, err_aux, t_e, t_g))
    n = len(rows)
    check(k6 == n, f"{tag} (a) K6 launches {k6} for {n} EP calls")
    for i, (err, err_aux, t_e, t_g) in enumerate(rows):
        print(f"{tag} (a) moe_apply_shard_map, layer {i}, B {B} x {S} "
              f"tokens, bf16, one-rank NCCL group vs _moe_apply_global: y "
              f"max err / max |y| {err:.3g}, aux rel {err_aux:.3g} (gate "
              f"{MOE_EP_TOL}); {t_e:.3f} ms vs {t_g:.3f} ms; {card}")
    print(f"{tag} (a) K6 {k6} launches for {n} EP calls (router rows "
          f"({B * S}, {cfg.moe.n_experts})); {card}")
    del params, x
    _free()
    return k6


_DDP_RANK = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
import chip_smoke
chip_smoke._ddp_rank({rank}, 2, {store!r}, {out!r})
"""

# (b)'s gloo facts, each exchange in two processes of its own: a CUDA
# tensor handed to gloo's send aborts the process (it writes the device
# pointer to its socket), so no rank that matters may try it
_GLOO_PROBE = """
import datetime, sys, torch, torch.distributed as dist
op, rank, store = sys.argv[1], int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank,
                        world_size=2, timeout=datetime.timedelta(seconds=30))
t = torch.full((4,), float(rank), device="cuda")
if op == "send/recv":
    dist.send(t, 1) if rank == 0 else dist.recv(t, 0)
else:
    dist.all_to_all(list(torch.empty(2, device="cuda").chunk(2)),
                    list(t[:2].chunk(2)))
print("ok", float(t[0]))
"""


def _ddp_rank(rank, world, store, out_path):
    """(b) one rank of the two-rank gloo group on the shared card: after
    an untimed compressed step (set-up), the uncompressed DDP step at full
    width cut to ``PARALLEL_LAYERS`` layers in float32, ``PARALLEL_ROWS``
    rows a rank, against the one-rank step on the whole batch (rank 0:
    loss, grad norm, every parameter and first-moment leaf), the
    compressed step against the uncompressed one; each from the same
    fresh weights."""
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_host_mesh, mesh_shape
    from repro_torch.models.registry import get_config, model_fns
    from repro_torch.models.schema import tree_leaves, tree_map
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod
    from repro_torch.train.step import make_ddp_train_step, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    build.load_library()
    dev = torch.device("cuda")
    mesh = make_host_mesh()
    res = {"rank": rank, "mesh": mesh_shape(mesh),
           "backend": dist.get_backend()}
    L, S, B = PARALLEL_LAYERS, PARALLEL_SEQ, PARALLEL_ROWS * world
    cfg = get_config("llama3.2-3b").replace(
        n_layers=L, attention_impl="flash", compute_dtype="float32")
    batch = next(SyntheticLMData(cfg.vocab_size, S, B, seed=0))

    def init():
        return _true_fan_in(model_fns(cfg).init(
            torch.Generator(device=dev).manual_seed(0)))

    def ddp(comp):
        tc = TrainConfig(grad_compression=comp, total_steps=3,
                         warmup_steps=1, learning_rate=PARALLEL_LR)
        params = init()
        # the names the step looks up at call time (its module's globals)
        spent, restore = _timed_spy(
            step_mod, "compressed_psum_tree" if comp else "pmean_tree")
        try:
            step = make_ddp_train_step(model_fns(cfg).loss, tc, mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, o, _, m = step(params, adamw.init_state(params),
                              tree_map(torch.zeros_like, params), batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            restore()
        check(spent[1] > 0, f"rank {rank}: the step made no all-reduce "
                            "call that the timing saw")
        return p, o, m, dt, spent[0], tc

    def rel_l2(a, b):
        return max(float(torch.linalg.vector_norm(x - y) /
                         torch.linalg.vector_norm(y))
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    ddp(True)            # set-up (cuBLAS, the kernels' first calls) untimed
    _free()
    p_u, o_u, m_u, res["step_s"], res["allreduce_s"], tc = ddp(False)
    res["loss"], res["grad_norm"] = float(m_u["loss"]), \
        float(m_u["grad_norm"])
    if rank == 0:
        params = init()
        p1, o1, m1 = make_train_step(model_fns(cfg).loss, tc)(
            params, adamw.init_state(params), batch)
        res["one_loss"], res["one_grad_norm"] = float(m1["loss"]), \
            float(m1["grad_norm"])
        res["leaf_rel_l2"] = rel_l2(p_u, p1)
        # the first moment, (1 - b1) x the mean gradient: unlike the first
        # step's update, it scales with the gradient
        res["moment_rel_l2"] = rel_l2(o_u.m, o1.m)
        del params, p1, o1
        _free()
    del o_u
    p_c, _, m_c, res["step_c_s"], res["allreduce_c_s"], _ = ddp(True)
    res["loss_c"] = float(m_c["loss"])
    res["max_dp_c"] = max(float((a - b).abs().max())
                          for a, b in zip(tree_leaves(p_c),
                                          tree_leaves(p_u)))
    # every rank holds the same parameters
    flat = torch.cat([t.reshape(-1)[:4096] for t in tree_leaves(p_u)])
    other = flat.clone()
    dist.broadcast(other, 0)
    res["same_params"] = bool(torch.equal(flat, other))
    del p_u, p_c
    _free()
    dist.barrier()
    dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(res, f)


def _parallel_two_ranks(tag, card):
    """(b) two gloo ranks sharing the card, spawned here."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        probes = {op: [subprocess.Popen(
            [sys.executable, "-c", _GLOO_PROBE, op, str(r),
             f"{tmp}/probe{i}"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
            for i, op in enumerate(("send/recv", "all_to_all"))}
        procs, outs, logs = [], [], []
        for r in range(2):
            outs.append(f"{tmp}/rank{r}.json")
            logs.append(open(f"{tmp}/rank{r}.log", "w+"))
            code = _DDP_RANK.format(root=str(ROOT), src=str(ROOT / "src"),
                                    rank=r, store=f"{tmp}/store",
                                    out=outs[-1])
            procs.append(subprocess.Popen([sys.executable, "-c", code],
                                          stdout=logs[-1],
                                          stderr=subprocess.STDOUT))
        try:
            for p in procs:
                p.wait(timeout=240)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            log.seek(0)
            check(p.returncode == 0, f"{tag} (b) rank {r} exited "
                                     f"{p.returncode}:\n{log.read()[-3000:]}")
            log.close()
        res = []
        for o in outs:
            with open(o) as f:
                res.append(json.load(f))
        facts = {}
        for op, ps in probes.items():
            said = []
            for p in ps:
                try:
                    text = p.communicate(timeout=60)[0]
                except subprocess.TimeoutExpired:
                    p.kill()
                    text = p.communicate()[0] + "\n(timed out)"
                last = [l for l in text.splitlines()
                        if l.strip() and "arn" not in l][-1:] or [""]
                said.append(f"exit {p.returncode}: {last[0].strip()[:150]}")
            facts[op] = "; ".join(said)
    r0, r1 = res
    check(r0["mesh"] == r1["mesh"] == {"data": 2, "model": 1} and
          r0["backend"] == "gloo", f"{tag} (b) meshes {r0['mesh']}")
    rel_loss = abs(r0["loss"] - r0["one_loss"]) / abs(r0["one_loss"])
    rel_gn = abs(r0["grad_norm"] - r0["one_grad_norm"]) / \
        abs(r0["one_grad_norm"])
    bound = 2 * PARALLEL_LR * 1.001
    check(r0["loss"] == r1["loss"] and rel_loss <= 1e-5 and
          r0["grad_norm"] == r1["grad_norm"] and rel_gn <= 1e-5 and
          r0["leaf_rel_l2"] <= 1e-5 and r0["moment_rel_l2"] <= 1e-5 and
          r1["same_params"],
          f"{tag} (b) two ranks vs one: loss {r0['loss']} / {r1['loss']} vs "
          f"{r0['one_loss']} (rel {rel_loss:.3g}), grad norm "
          f"{r0['grad_norm']} / {r1['grad_norm']} vs {r0['one_grad_norm']} "
          f"(rel {rel_gn:.3g}), worst leaf rel L2: parameters "
          f"{r0['leaf_rel_l2']:.3g}, first moment {r0['moment_rel_l2']:.3g} "
          f"(gates 1e-5), same params {r1['same_params']}")
    check(max(r0["max_dp_c"], r1["max_dp_c"]) <= bound,
          f"{tag} (b) compressed vs uncompressed step: max |dp| "
          f"{r0['max_dp_c']}, {r1['max_dp_c']} > 2 lr = {bound}")
    print(f"{tag} (b) DDP step on two gloo ranks sharing the card, "
          f"llama3.2-3b at full width cut to {PARALLEL_LAYERS} layers, "
          f"float32, flash, B {2 * PARALLEL_ROWS} x {PARALLEL_SEQ} "
          f"({PARALLEL_ROWS} rows a rank), lr {PARALLEL_LR}: loss "
          f"{r0['loss']:.6f} vs the one-rank step on the whole batch "
          f"{r0['one_loss']:.6f} (rel {rel_loss:.3g}, gate 1e-5), grad norm "
          f"{r0['grad_norm']:.6f} vs {r0['one_grad_norm']:.6f} (rel "
          f"{rel_gn:.3g}, gate 1e-5), every parameter leaf within "
          f"{r0['leaf_rel_l2']:.3g} and every first-moment leaf within "
          f"{r0['moment_rel_l2']:.3g} relative L2 (gates 1e-5); compressed "
          f"step: every parameter "
          f"within {max(r0['max_dp_c'], r1['max_dp_c']):.3g} of the "
          f"uncompressed step's (gate 2 lr = {bound:.3g}); {card}")
    for r in res:
        print(f"{tag} (b) rank {r['rank']}: step {r['step_s']:.3f} s, "
              f"all-reduces of the loss and the gradients (gloo, CUDA "
              f"tensors) {r['allreduce_s']:.3f} s = "
              f"{100 * r['allreduce_s'] / r['step_s']:.1f}%; compressed "
              f"step {r['step_c_s']:.3f} s, its all-reduce "
              f"{r['allreduce_c_s']:.3f} s = "
              f"{100 * r['allreduce_c_s'] / r['step_c_s']:.1f}%; {card}")
    print(f"{tag} (b) gloo with CUDA tensors: all_reduce and broadcast "
          f"ok (the steps above); send/recv, ranks {facts['send/recv']}; "
          f"all_to_all, ranks {facts['all_to_all']}; {card}")


def phase_parallel(dev, card):
    """33. (S) parallel/ on the card. Returns this path's readings of K3,
    K4 and K6 for the ``kernels`` line."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh, mesh_shape
    tag = "[33]"
    t_phase = time.perf_counter()
    mesh = make_host_mesh()
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1 and
          mesh_shape(mesh) == {"data": 1, "model": 1},
          f"{tag} host mesh {mesh_shape(mesh)} over {dist.get_backend()}")
    ddp = _parallel_ddp(tag, mesh, dev, card)
    _parallel_ring(tag, mesh, dev, card)
    k6 = _parallel_moe(tag, mesh, dev, card)
    dist.destroy_process_group()
    _parallel_two_ranks(tag, card)
    print(f"{tag} phase time {time.perf_counter() - t_phase:.1f} s; {card}")
    k3, k4 = ddp["launches"]
    step = {"ddp_step_s": ddp["step_s"],
            "compressed_allreduce_s": ddp["allreduce_s"]}
    return {"flash_attention": {"launches": k3, **step,
                                **ddp["shapes"]["flash_attention"]},
            "flash_attention_bwd": {"launches": k4, **step,
                                    **ddp["shapes"]["flash_attention_bwd"]},
            "softermax_rows": {"launches": k6}}


# ---------------------------------------------------------------------------
# Phase 34: training of the MLA, hybrid and RWKV-6 families on the card
# ---------------------------------------------------------------------------

# (a): each case's reduced config, with its config overrides
FAMILY_TRAIN_CASES = {
    "deepseek-expanded": ("deepseek-v2-236b", {}),
    "deepseek-absorbed": ("deepseek-v2-236b", {"opt_mla_absorbed": True}),
    "hymba-chunked": ("hymba-1.5b", {"attention_impl": "chunked"}),
    "hymba-flash": ("hymba-1.5b", {"attention_impl": "flash"}),
    "rwkv6": ("rwkv6-7b", {}),
}
FT_GN0_TOL = 1e-4             # (a): first step's grad norm, card vs CPU
DEEPSEEK_TRAIN_MOE_LAYERS = 2  # (b): the dense head block + 2 MoE layers
DEEPSEEK_TRAIN_EXPERTS = 32    # (b): routed experts kept of 160
DEEPSEEK_FORMS_TOL = 1e-2      # (b): absorbed vs expanded step-0 loss, bf16
HYMBA_TRAIN_SEQ = 1024         # (c): hymba's window, so flash == chunked
HYMBA_TRAIN_ROWS = 8           # (c): rows a batch
RWKV_TRAIN_LAYERS = 8          # (d): rwkv6-7b's first 8 of 32 layers
RWKV_TRAIN_SEQ = 1024          # (d)
RWKV_TRAIN_ROWS = 4            # (d)


def _ft_steps(cfg, params, tc, data, n, dev, opt=None, profile=None):
    """``n`` AdamW steps through ``make_train_step``, each synced: (the
    parameters and AdamW state after, per step (metrics as floats,
    seconds, launches of K1..K7, (K3, K4) on the tensor cores)). With
    ``profile`` (label, watch) the last step runs under the profiler
    (``_kernel_us``: its seconds are the profiled wall) and its
    ``step_profile`` line is the row's fifth entry."""
    from repro_torch.models.registry import model_fns
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step
    from repro_torch.utils.device import synchronize
    step = make_train_step(model_fns(cfg).loss, tc)
    opt = adamw.init_state(params) if opt is None else opt
    rows = []
    for i in range(n):
        batch = next(data)
        c0, t0c = _all_counts(), _flash_tc_counts()
        line = None
        synchronize(dev)
        t0 = time.perf_counter()
        if profile is not None and i == n - 1:
            out = []
            wall, kern = _kernel_us(
                lambda: out.append(step(params, opt, batch)), 1)
            (params, opt, m), = out
            line = _profile_line(wall, kern, 1, *profile)
        else:
            params, opt, m = step(params, opt, batch)
            synchronize(dev)
            wall = time.perf_counter() - t0
        rows.append(({k: float(v) for k, v in m.items()}, wall,
                     tuple(b - a for a, b in zip(c0, _all_counts())),
                     tuple(b - a for a, b in zip(t0c, _flash_tc_counts())),
                     line))
    return params, opt, rows


def _ft_master(cfg, dev):
    """fp32 master weights of ``cfg`` on the card: the model's own init
    from ``torch.Generator(dev)`` seeded 0, the mixers' projections at
    their true fan-in (``_true_fan_in``); (params, seconds)."""
    import torch
    from repro_torch.models.registry import model_fns
    t0 = time.perf_counter()
    p = _true_fan_in(model_fns(cfg).init(
        torch.Generator(device=dev).manual_seed(0)))
    torch.cuda.synchronize()
    return p, time.perf_counter() - t0


def _ft_want(cfg, passes):
    """Launches of (K1..K7) one training step should make: K3 once a
    flash attention layer and forward pass, K4 twice a flash attention
    layer (dK/dV, dQ), K6 once a MoE layer and forward pass."""
    attn = cfg.n_layers if (cfg.attention_impl == "flash" and
                            cfg.family == "hybrid") else 0
    moe = cfg.n_layers - cfg.moe.first_dense if cfg.family == "moe" else 0
    return (0, 0, passes * attn, 2 * attn, 0, passes * moe, 0)


def _ft_card_vs_cpu(tag, dev):
    """(a) Three AdamW steps of each reduced case on the CPU (plain
    versions) and on the card (kernels) from the same weights and batches,
    float32: loss, ce, aux and lr within 1e-5 relative at every step,
    every final leaf within 2e-4 relative L2 (``tests/test_torch_moe.py``'s),
    grad_norm within 1e-3 after the first step (the same) and within
    ``FT_GN0_TOL`` at the first: reduced rwkv6's first grad norm, 2,120,
    read 1.46e-5 apart on the card and the CPU (cuBLAS and the CPU's BLAS
    sum its f32 gradients in other orders), past the test's 1e-5."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.registry import (get_config, init_lm_params,
                                             reduce_config)
    from repro_torch.models.schema import tree_leaves, tree_map
    tc = TrainConfig(total_steps=3, warmup_steps=1, learning_rate=1e-3)
    for case, (arch, kw) in FAMILY_TRAIN_CASES.items():
        cfg = reduce_config(get_config(arch)).replace(**kw)
        init = init_lm_params(cfg, torch.Generator().manual_seed(0))
        out = {}
        for d in ("cpu", dev):
            params = tree_map(lambda a: a.to(d, copy=True), init)
            out[str(d)] = _ft_steps(cfg, params, tc, SyntheticLMData(
                cfg.vocab_size, 32, 4, seed=0), 3, d)
        (cp, _, crows), (gp, _, grows) = out["cpu"], out[str(dev)]
        want = _ft_want(cfg, 2 if cfg.remat == "full" else 1)
        worst = {}
        for s, (c, g) in enumerate(zip(crows, grows)):
            check(c[2] == (0,) * 7, f"{tag} (a) {case}: the CPU launched")
            check(g[2] == want and g[3] == (0, 0),
                  f"{tag} (a) {case} step {s}: launches (K1..K7) {g[2]}, "
                  f"want {want}; on the tensor cores {g[3]} (float32 takes "
                  f"the CUDA cores)")
            for key in ("loss", "ce", "aux", "grad_norm", "lr"):
                tol = 1e-5 if key != "grad_norm" else (
                    1e-3 if s else FT_GN0_TOL)
                err = abs(g[0][key] - c[0][key])
                check(math.isfinite(g[0][key]) and
                      err <= tol * abs(c[0][key]),
                      f"{tag} (a) {case} step {s} {key}: card "
                      f"{g[0][key]} cpu {c[0][key]} (tol {tol})")
                worst[key] = max(worst.get(key, 0.0),
                                 err / max(abs(c[0][key]), 1e-30))
        leaf = max((torch.linalg.vector_norm(g.cpu() - c) /
                    torch.linalg.vector_norm(c)).item()
                   for c, g in zip(tree_leaves(cp), tree_leaves(gp)))
        check(leaf <= 2e-4, f"{tag} (a) {case}: final leaves differ by "
                            f"{leaf} relative L2 > 2e-4")
        print(f"{tag} (a) reduced {case}, float32, 3 AdamW steps: card == "
              f"cpu (largest relative diff " + ", ".join(
                  f"{k} {v:.3g}" for k, v in worst.items()) +
              f"; worst final leaf {leaf:.3g} rel L2), launches (K1..K7) "
              f"per step {grows[0][2]}, losses "
              f"{[round(r[0]['loss'], 5) for r in grows]}")


def _ft_deepseek(tag, dev, card):
    """(b) deepseek-v2-236b cut to its dense head block + 2 MoE layers of
    32 routed experts, every width as published, S 4096, B 1, bf16
    compute, fp32 master weights and AdamW, remat full: two steps in each
    MLA form from the same weights. Returns the K6 launches and each
    form's steps (``_timed_step``)."""
    import dataclasses
    import torch
    from repro_torch.configs.base import TRAIN_4K, TrainConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import moe
    from repro_torch.models.registry import get_config, model_fns
    from repro_torch.models.schema import num_params
    base = get_config("deepseek-v2-236b")
    n_moe = DEEPSEEK_TRAIN_MOE_LAYERS
    cfg = base.replace(n_layers=base.moe.first_dense + n_moe,
                       moe=dataclasses.replace(
                           base.moe, n_experts=DEEPSEEK_TRAIN_EXPERTS))
    S, V = TRAIN_4K.seq_len, cfg.vocab_size
    n = num_params(model_fns(cfg).schema)
    tc = TrainConfig(total_steps=2, warmup_steps=1, learning_rate=3e-4)
    want = _ft_want(cfg, 2)
    first, k6, timed = {}, 0, []
    for form in ("expanded", "absorbed"):
        c = cfg.replace(opt_mla_absorbed=form == "absorbed")
        params, t_init = _ft_master(c, dev)
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        params, opt, rows = _ft_steps(c, params, tc,
                                      SyntheticLMData(V, S, 1, seed=0), 2, dev)
        peak = torch.cuda.max_memory_allocated()
        for s, (m, dt, launched, _, _) in enumerate(rows):
            check(all(math.isfinite(m[k]) for k in ("loss", "ce", "aux",
                                                    "grad_norm"))
                  and m["aux"] > 0, f"{tag} (b) {form} step {s}: {m}")
            check(launched == want,
                  f"{tag} (b) {form} step {s}: launches (K1..K7) "
                  f"{launched}, want {want} (K6 once a MoE layer in the "
                  f"forward and in its recompute; MLA runs no kernel)")
            k6 += launched[5]
            print(f"{tag} (b) {form} MLA step {s}: loss {m['loss']:.5f} ce "
                  f"{m['ce']:.5f} aux {m['aux']:.6f} grad norm "
                  f"{m['grad_norm']:.4f}, {dt:.3f} s ({S / dt:.0f} "
                  f"tokens/s), K6 {launched[5]}")
        first[form] = rows[0][0]["loss"]
        timed.append(_timed_step(f"deepseek-v2-236b {form} train", c,
                                 "train", 1, S, [r[1] for r in rows]))
        print(f"{tag} (b) deepseek-v2-236b, {form} MLA, cut to "
              f"{cfg.n_layers} of 60 layers (the dense head block + {n_moe}"
              f" MoE layers) and {DEEPSEEK_TRAIN_EXPERTS} of 160 routed "
              f"experts, seq {S}, batch 1 (C = {moe.capacity(S, c)}): "
              f"{n / 1e9:.3f} B fp32 master parameters ({16 * n / 1e9:.1f} "
              f"GB with gradients and both AdamW moments) drawn in "
              f"{t_init:.2f} s, peak memory {peak / 2 ** 30:.2f} GiB "
              f"({peak / 1e9:.1f} GB); {card}")
        del params, opt
        _free()
    rel = abs(first["absorbed"] - first["expanded"]) / first["expanded"]
    check(rel <= DEEPSEEK_FORMS_TOL,
          f"{tag} (b) step-0 loss absorbed {first['absorbed']} vs expanded "
          f"{first['expanded']}: {rel} > {DEEPSEEK_FORMS_TOL}")
    print(f"{tag} (b) absorbed vs expanded step-0 loss: relative diff "
          f"{rel:.3g} (gate {DEEPSEEK_FORMS_TOL}, bf16)")
    return k6, timed


def _scan_share(tag, label, kind, cfg, B, S, layers, step_s):
    """The scan loop alone at a training step's per-layer shape, as the
    remat step runs it: a no-grad forward, then a forward and its backward
    (the recompute), each synced, after one warm call of each; times the
    layer count against the step's seconds. Returns the line it prints."""
    import torch
    from repro_torch.models import hymba, rwkv6
    g = torch.Generator(device="cuda").manual_seed(7)

    def t(shape, lo=0.0, hi=1.0):
        return (torch.rand(shape, generator=g, device="cuda") * (hi - lo)
                + lo).requires_grad_()

    if kind == "hymba":
        di, st = cfg.ssm.d_inner, cfg.ssm.state
        ins = (t((B, S, di, st), 0.5, 1.0), t((B, S, di, st), -0.1, 0.1))
        h0 = torch.zeros((B, di, st), device="cuda")

        def run():
            return hymba.selective_scan(*ins, h0)[0]
    else:
        n = cfg.ssm.head_size
        H = cfg.d_model // n
        ins = tuple(t((B, S, H, n), -1.0, 1.0) for _ in range(3)) + (
            t((B, S, H, n), 0.5, 1.0), t((H, n), -0.1, 0.1))
        s0 = torch.zeros((B, H, n, n), device="cuda")

        def run():
            return rwkv6._wkv_scan(*ins, s0)[0]

    def fwd():
        with torch.no_grad():
            run()

    def fwd_bwd():
        y = run()
        torch.autograd.grad(y, ins, torch.ones_like(y))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    timed(fwd), timed(fwd_bwd)                       # warm
    t_fwd, t_bwd = timed(fwd), timed(fwd_bwd)
    total = layers * (t_fwd + t_bwd)
    line = (f"{tag} {label}: the scan loop alone at the step's per-layer "
            f"shape (B {B}, S {S}): no-grad forward {t_fwd * 1e3:.1f} ms, "
            f"forward + backward {t_bwd * 1e3:.1f} ms a layer; x {layers} "
            f"layers {total:.2f} s against the {step_s:.2f} s step "
            f"({100 * total / step_s:.0f}%)")
    print(line)
    return line


def _ft_report(tag, label, cfg, B, S, rows, want, n, t_init, peak, card):
    """Checks and prints ``_ft_steps``' rows of a full-width run: finite
    metrics, launches (K1..K7) ``want`` a step, K3/K4 on the tensor
    cores; the profiled last step's line."""
    for s, (m, dt, launched, on_tc, line) in enumerate(rows):
        check(all(math.isfinite(m[k]) for k in ("loss", "ce", "grad_norm")),
              f"{tag} {label} step {s}: {m}")
        check(launched == want and on_tc == launched[2:4],
              f"{tag} {label} step {s}: launches (K1..K7) {launched}, want "
              f"{want}; K3/K4 on the tensor cores {on_tc}")
        print(f"{tag} {label} step {s}: loss {m['loss']:.5f} grad norm "
              f"{m['grad_norm']:.4f}, {dt:.3f} s ({B * S / dt:.0f} "
              f"tokens/s{', profiled' if line else ''}), launches K3 "
              f"{launched[2]} K4 {launched[3]} (tensor cores "
              f"{on_tc[0]}/{on_tc[1]})")
        if line:
            print(f"{tag} {line}")
    print(f"{tag} {label}: {n / 1e9:.3f} B fp32 master parameters "
          f"({16 * n / 1e9:.1f} GB with gradients and both AdamW moments) "
          f"drawn in {t_init:.2f} s, peak memory {peak / 2 ** 30:.2f} GiB "
          f"({peak / 1e9:.1f} GB), batch {B} x {S}; {card}")


def _ft_long(tag, label, cfg, B, S, dev, card, steps=2, kind=None,
             watch=()):
    """``steps`` AdamW steps of ``cfg`` at full width (fp32 master weights
    at true fan-in, bf16 compute, remat full) on B x S tokens, each synced
    and its launches checked against ``_ft_want``, the last one under the
    profiler (the card's busy share); then the scan loop's share
    (``_scan_share``). Returns the step rows."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.registry import model_fns
    from repro_torch.models.schema import num_params
    tc = TrainConfig(total_steps=steps, warmup_steps=1, learning_rate=3e-4)
    params, t_init = _ft_master(cfg, dev)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    params, opt, rows = _ft_steps(
        cfg, params, tc, SyntheticLMData(cfg.vocab_size, S, B, seed=0),
        steps, dev, profile=(f"{label}, one step", watch))
    peak = torch.cuda.max_memory_allocated()
    _ft_report(tag, label, cfg, B, S, rows,
               _ft_want(cfg, 2 if cfg.remat == "full" else 1),
               num_params(model_fns(cfg).schema), t_init, peak, card)
    del params, opt
    _free()
    if kind is not None:
        _scan_share(tag, label, kind, cfg, B, S, cfg.n_layers,
                    rows[0][1] if len(rows) == 1 else min(
                        r[1] for r in rows[:-1]))
        _free()
    return rows


def _ft_hymba(tag, dev, card):
    """(c) hymba-1.5b whole, bf16, S 1024 (its window: flash and chunked
    compute the same function), B 8: a chunked gradient pass, then two
    flash AdamW steps from the same master weights, the first one's loss,
    grad norm and every layer's attention-weight gradients held against
    the chunked pass (``WHISPER_TRAIN_TOL``, ``WHISPER_GRAD_TOL``), the
    second profiled; the scan loop's share. Returns (K3, K4) launches of
    the two flash steps and the unprofiled one (``_timed_step``)."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.registry import get_config, model_fns
    from repro_torch.models.schema import num_params, tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_loss_and_grad
    cfg = get_config("hymba-1.5b")
    L, S, B = cfg.n_layers, HYMBA_TRAIN_SEQ, HYMBA_TRAIN_ROWS
    check(S <= cfg.window, "(c) flash ignores the window: S must not pass it")
    label = "(c) hymba-1.5b flash"
    params, t_init = _ft_master(cfg, dev)
    data = SyntheticLMData(cfg.vocab_size, S, B, seed=0)
    batch = next(data)
    tc = TrainConfig(total_steps=2, warmup_steps=1, learning_rate=3e-4)
    flash = cfg.replace(attention_impl="flash")
    torch.cuda.reset_peak_memory_stats()
    res, attn, rows = {}, {}, []
    for impl in ("chunked", "flash"):
        c = cfg.replace(attention_impl=impl)
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, met, grads = make_loss_and_grad(model_fns(c).loss, tc)(
            params, batch)
        res[impl] = (float(loss), float(torch.sqrt(sum(
            torch.sum(torch.square(x)) for x in
            torch._foreach_norm(tree_leaves(grads))))))
        attn[impl] = {w: grads["blocks"]["mixer"]["attn"][w].clone()
                      for w in ("wq", "wk", "wv", "wo")}
        if impl == "chunked":
            check(_all_counts() == (0,) * 7,
                  f"{tag} (c) chunked pass: launches {_all_counts()}")
            del grads
            _free()
            continue
        # flash: this pass is step 0, as make_train_step takes it
        opt = adamw.init_state(params)
        params, opt, info = adamw.apply_updates(params, grads, opt, tc)
        torch.cuda.synchronize()
        rows.append(({"loss": float(loss), "ce": float(met["ce"]),
                      **{k: float(v) for k, v in info.items()}},
                     time.perf_counter() - t0, _all_counts(),
                     _flash_tc_counts(), None))
        del grads
    _reset_counts()
    params, opt, more = _ft_steps(
        flash, params, tc, data, 1, dev, opt=opt,
        profile=(f"{label}, one step", ("flash_fwd_tc_kernel",
                                        "flash_bwd_dkv_tc_kernel",
                                        "flash_bwd_dq_tc_kernel")))
    rows += more
    peak = torch.cuda.max_memory_allocated()
    _ft_report(tag, label, flash, B, S, rows, _ft_want(flash, 2),
               num_params(model_fns(cfg).schema), t_init, peak, card)
    (lc, gc_), (lf, gf) = res["chunked"], res["flash"]
    rel_l, rel_g = abs(lf - lc) / abs(lc), abs(gf - gc_) / gc_
    check(abs(rows[0][0]["grad_norm"] - gf) <= 1e-6 * gf,
          f"{tag} (c) step 0's grad norm {rows[0][0]['grad_norm']} is not "
          f"its gradients' {gf}")
    check(rel_l <= WHISPER_TRAIN_TOL and rel_g <= WHISPER_TRAIN_TOL,
          f"{tag} (c) flash loss {lf} / grad norm {gf} vs chunked {lc} / "
          f"{gc_} > {WHISPER_TRAIN_TOL}")
    errs = {(w, i): ((attn["flash"][w][i] - attn["chunked"][w][i]).norm() /
                     attn["chunked"][w][i].norm()).item()
            for w in attn["chunked"] for i in range(L)}
    worst = max(errs, key=errs.get)
    check(errs[worst] <= WHISPER_GRAD_TOL,
          f"{tag} (c) flash vs chunked gradient of attn.{worst[0]} layer "
          f"{worst[1]}: relative L2 {errs[worst]} > {WHISPER_GRAD_TOL}")
    print(f"{tag} (c) hymba-1.5b, {L} layers, B {B} x S {S}, flash step 0 "
          f"against a chunked gradient pass from the same weights: loss rel "
          f"diff {rel_l:.3g}, grad norm rel diff {rel_g:.3g} (gate "
          f"{WHISPER_TRAIN_TOL} each); attention weights' gradients, "
          f"largest relative L2 of a layer's leaf: " + ", ".join(
              f"{w} {max(e for k, e in errs.items() if k[0] == w):.3g}"
              for w in attn["chunked"]) + f" (gate {WHISPER_GRAD_TOL})")
    del params, opt, attn
    _free()
    _scan_share(tag, label, "hymba", cfg, B, S, L, rows[0][1])
    _free()
    return (tuple(sum(r[2][i] for r in rows) for i in (2, 3)),
            _timed_step("hymba-1.5b train", flash, "train", B, S,
                        [r[1] for r in rows if r[4] is None]))


def _ft_rwkv(tag, dev, card):
    """(d) rwkv6-7b cut to its first 8 of 32 layers, every width as
    published, bf16, S 1024, two steps (the second profiled): finite
    metrics, no kernel. Returns the unprofiled step (``_timed_step``)."""
    from repro_torch.models.registry import get_config
    cfg = get_config("rwkv6-7b").replace(n_layers=RWKV_TRAIN_LAYERS)
    rows = _ft_long(tag, f"(d) rwkv6-7b cut to {RWKV_TRAIN_LAYERS} of 32 "
                    f"layers", cfg, RWKV_TRAIN_ROWS, RWKV_TRAIN_SEQ, dev,
                    card, kind="rwkv")
    return _timed_step("rwkv6-7b train", cfg, "train", RWKV_TRAIN_ROWS,
                       RWKV_TRAIN_SEQ, [r[1] for r in rows if r[4] is None])


def family_train_reading(arch, seq, rows, layers=None):
    """One-off reading outside the smoke: ``_ft_long`` for ``arch`` (cut to
    ``layers``) at ``rows`` x ``seq``. Run alone with

        PYTHONPATH=src python -c 'import sys; sys.path.insert(0, "."); \\
            import chip_smoke as cs; \\
            cs.family_train_reading("hymba-1.5b", 4096, 1)'
    """
    import torch
    from repro_torch.kernels import build
    from repro_torch.models.registry import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load_library()
    card = card_line()
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    if cfg.family == "hybrid":
        cfg = cfg.replace(attention_impl="flash")
    kind = {"hybrid": "hymba", "rwkv": "rwkv"}.get(cfg.family)
    _ft_long("[34*]", f"{arch} ({cfg.n_layers} layers, "
             f"{cfg.attention_impl})", cfg, rows, seq, torch.device("cuda"),
             card, kind=kind)


def _ft_kernels(tag, dev, card):
    """(e) K3/K4 at hymba's training shape (B 8, 25/5 heads, S 1024, D 64,
    causal, bf16: the tensor cores) against their plain versions within
    ``tolerance(bf16)`` of each element's size, SDPA forward and autograd
    backward as the library calls; K6 at deepseek's training router rows
    (4096, 32) in float32, forward and autograd backward against
    ``softermax_rows_ref`` and its autograd within 1e-5, ``torch.softmax``
    as the library call. Comparison and timing launches do not count."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain)
    from repro_torch.kernels.parity import parity_error, tolerance
    from repro_torch.kernels.softermax import (softermax_op, softermax_rows,
                                               softermax_rows_ref)
    saved = _save_counts()
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rng = np.random.default_rng(34)
    B, Hq, Hkv, S, D = HYMBA_TRAIN_ROWS, 25, 5, HYMBA_TRAIN_SEQ, 64
    pairs = B * Hq * S * (S + 1) // 2
    q = _rand(rng, (B, Hq, S, D), D ** -0.5).to(dev, torch.bfloat16)
    k = _rand(rng, (B, Hkv, S, D)).to(dev, torch.bfloat16)
    v = _rand(rng, (B, Hkv, S, D)).to(dev, torch.bfloat16)
    do = _rand(rng, (B, Hq, S, D)).to(dev, torch.bfloat16)
    tc0 = _flash_tc_counts()
    o, m, d = flash_attention(q, k, v, return_stats=True)
    grads = flash_attention_bwd(q, k, v, o, do, m, d)
    ran_tc = tuple(b - a for a, b in zip(tc0, _flash_tc_counts()))
    check(ran_tc == (1, 2), f"{tag} (e) K3/K4 at hymba's training shape: "
                            f"tensor-core launches {ran_tc}, want (1, 2)")
    err3, held3 = parity_error(o, flash_attention_plain(q, k, v))
    err4, held4 = map(max, zip(*(parity_error(g, w) for g, w in zip(
        grads, flash_attention_bwd_plain(q, k, v, o, do, m, d)))))
    tol = tolerance(torch.bfloat16)
    check(held3 <= tol and held4 <= tol,
          f"{tag} (e) K3 {err3} (held {held3}), K4 {err4} (held {held4}) "
          f"> {tol}")

    def sdpa(a, b, c):
        return F.scaled_dot_product_attention(a, b, c, is_causal=True,
                                              scale=math.log(2),
                                              enable_gqa=True)

    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    lo = sdpa(ql, kl, vl)
    qb, kvb, stats = q.numel() * 2, k.numel() * 2, 2 * B * Hq * S * 4
    k3 = _reading(err3, _time_ms(lambda: flash_attention(
        q, k, v, return_stats=True), flush, iters=10),
        _time_ms(lambda: flash_attention_plain(q, k, v), flush, iters=3),
        2 * qb + 2 * kvb + stats, 4 * D * pairs,
        _time_ms(lambda: sdpa(q, k, v), flush, iters=10))
    k4 = _reading(err4, _time_ms(lambda: flash_attention_bwd(
        q, k, v, o, do, m, d), flush, iters=10),
        _time_ms(lambda: flash_attention_bwd_plain(q, k, v, o, do, m, d),
                 flush, iters=3),
        4 * qb + 4 * kvb + stats, 10 * D * pairs,
        _time_ms(lambda: torch.autograd.grad(lo, (ql, kl, vl), do,
                                             retain_graph=True),
                 flush, iters=10))
    del q, k, v, do, o, m, d, grads, ql, kl, vl, lo
    # K6 at the router's rows of one MoE layer of (b): B·S x E
    rows, E = 4096, DEEPSEEK_TRAIN_EXPERTS
    x = _rand(rng, (rows, E), 3.0).to(dev).requires_grad_()
    xp = x.detach().clone().requires_grad_()
    gy = _rand(rng, (rows, E)).to(dev)
    y = softermax_op(x)
    yp = softermax_rows_ref(xp)
    (gx,) = torch.autograd.grad(y, x, gy)
    (gxp,) = torch.autograd.grad(yp, xp, gy)
    err6 = (y - yp).abs().max().item()
    err6b = (gx - gxp).abs().max().item()
    check(err6 <= 1e-5 and err6b <= 1e-5,
          f"{tag} (e) K6 at ({rows}, {E}): forward {err6}, backward "
          f"{err6b} > 1e-5")
    xd = x.detach()
    xs = xd * math.log(2)
    k6 = _reading(err6, _time_ms(lambda: softermax_rows(xd), flush),
                  _time_ms(lambda: softermax_rows_ref(xd), flush),
                  2 * xd.numel() * 4, 5 * xd.numel(),
                  _time_ms(lambda: torch.softmax(xs, dim=-1), flush),
                  peak="float32")
    k6["backward_max_abs_err"] = err6b
    _restore_counts(saved)
    for name, e, what in (
            ("flash_attention", k3, f"B {B}, {Hq}/{Hkv} heads, S {S}, D {D}"
             f", causal, bf16, tensor cores; SDPA"),
            ("flash_attention_bwd", k4, "the same; SDPA's autograd "
             "backward"),
            ("softermax_rows", k6, f"({rows}, {E}) f32, backward max |err| "
             f"{err6b:.3g}; torch.softmax")):
        print(f"{tag} (e) {name} at this path's shape ({what} "
              f"{e['library_ms']:.4f} ms): {e['ms']:.4f} ms (plain "
              f"{e['plain_ms']:.4f}, bound {e['bound_ms']:.4g} by "
              f"{e['bound_by']}); max |err| vs plain {e['max_abs_err']:.3g}"
              f"; {card}")
    del flush
    _free()
    return {"flash_attention": k3, "flash_attention_bwd": k4,
            "softermax_rows": k6}


def _ft_entry_points(tag, dev, card):
    """(f) The entry points on the card: ``launch.train`` at hymba-1.5b's
    full width (B 1, S 1024, 2 steps) and on the reduced deepseek and
    rwkv6; ``examples/train_lm.py --preset tiny`` for 5 steps;
    ``examples/serve_lm.py`` at its reduced default, its greedy streams
    those of a CPU engine over the same weights (drawn on the card, moved
    to the CPU) and prompts. Their launches do not count."""
    import torch
    from repro_torch.examples import serve_lm, train_lm
    from repro_torch.models.registry import (get_config, model_fns,
                                             reduce_config)
    from repro_torch.models.schema import tree_map
    from repro_torch.serve import ContinuousEngine
    for argv in (["--arch", "hymba-1.5b", "--batch", "1", "--seq", "1024",
                  "--steps", "2"],
                 ["--arch", "deepseek-v2-236b", "--reduced", "--steps", "3"],
                 ["--arch", "rwkv6-7b", "--reduced", "--steps", "3"]):
        _, lines, out = _launcher(tag, "train", argv)
        h = out["history"]
        done = [ln for ln in lines if ln.startswith("done on cuda")]
        check(len(h) == int(argv[-1]) and done and
              all(math.isfinite(x) for x in h),
              f"{tag} (f) launch.train {' '.join(argv)}: {h}, {lines[-3:]}")
        print(f"{tag} (f) launch.train {' '.join(argv)}: {done[0]}")
        del out
        _free()
    saved = _save_counts()
    try:
        t0 = time.perf_counter()
        out = train_lm.main(["--preset", "tiny", "--steps", "5"])
        t_train = time.perf_counter() - t0
        t0 = time.perf_counter()
        srv = serve_lm.main([])
        t_serve = time.perf_counter() - t0
    finally:
        _restore_counts(saved)
    h = out["history"]
    check(len(h) == 5 and all(math.isfinite(x) for x in h),
          f"{tag} (f) examples/train_lm.py: {h}")
    cfg = reduce_config(get_config("qwen3-4b"))
    params = tree_map(lambda a: a.cpu(), model_fns(cfg).init(
        torch.Generator(device=dev).manual_seed(0)))
    eng = ContinuousEngine(cfg, params, block_size=16, num_blocks=64,
                           max_batch=4, max_len=48, device="cpu")
    hs = [eng.submit(p, 16) for p in srv["prompts"]]
    got = eng.run()
    want = {h_.req_id: list(got[h_.req_id].tokens) for h_ in hs}
    check(srv["tokens"] == want,
          f"{tag} (f) examples/serve_lm.py: the card's streams "
          f"{srv['tokens']} differ from the CPU's {want}")
    print(f"{tag} (f) examples/train_lm.py --preset tiny --steps 5: loss "
          f"{h[0]:.4f} -> {h[-1]:.4f} ({t_train:.1f} s); "
          f"examples/serve_lm.py: {len(want)} greedy streams of 16 tokens "
          f"equal to a CPU engine's on the same weights ({t_serve:.1f} s)")


def phase_family_train(dev, card):
    """34. (T) Training of the MLA, hybrid and RWKV-6 families on the card.
    Returns this path's readings of K3, K4 and K6 for the ``kernels``
    line and the timed training steps (``_timed_step``)."""
    import torch
    tag = "[34]"
    t_phase = time.perf_counter()
    _free()
    print(f"{tag} memory_allocated at the phase's start: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    _ft_card_vs_cpu(tag, dev)
    _free()
    k6, timed = _ft_deepseek(tag, dev, card)
    (k3, k4), hymba_step = _ft_hymba(tag, dev, card)
    timed += [hymba_step, _ft_rwkv(tag, dev, card)]
    out = _ft_kernels(tag, dev, card)
    _ft_entry_points(tag, dev, card)
    print(f"{tag} phase time {time.perf_counter() - t_phase:.1f} s; {card}")
    out["flash_attention"]["launches"] = k3
    out["flash_attention_bwd"]["launches"] = k4
    out["softermax_rows"]["launches"] = k6
    return out, timed


ANALYTIC_STEPS = ("llama3.2-3b train", "llama3.2-3b paged decode",
                  "deepseek-v2-236b expanded train",
                  "deepseek-v2-236b absorbed train", "hymba-1.5b train",
                  "rwkv6-7b train", "whisper-base train")


def _span(values, fmt):
    """``min–max`` of ``values`` in ``fmt``, one number when they agree."""
    lo, hi = format(min(values), fmt), format(max(values), fmt)
    return lo if lo == hi else f"{lo}–{hi}"


def phase_analytic(steps, card):
    """35. (A) The analytic layer on the card: each of ``ANALYTIC_STEPS``
    (``_timed_step`` readings of phases 5, 9, 32 and 34) against the
    roofline's H100 entry; every supported grid cell's inputs and
    parameters as meta tensors. Runs no model and allocates nothing."""
    import torch
    from repro_torch.configs.base import ALL_SHAPES
    from repro_torch.launch.analytic import analytic_flops
    from repro_torch.launch.roofline import Roofline, model_flops
    from repro_torch.models.registry import (GRID_ARCHS, cell_supported,
                                             get_config, input_specs,
                                             model_fns)
    from repro_torch.models.schema import tree_leaves
    tag = "[35]"
    t_phase = time.perf_counter()
    peak = H100_SXM.peak("bfloat16")
    by_name = {s["name"]: s for s in steps if s is not None}
    check(set(by_name) <= set(ANALYTIC_STEPS),
          f"{tag} readings of unknown steps: "
          f"{sorted(set(by_name) - set(ANALYTIC_STEPS))}")
    for name in ANALYTIC_STEPS:
        step = by_name.get(name)
        check(step is not None and len(step["seconds"]) > 0 and all(
            math.isfinite(t) and t > 0 for t in step["seconds"]),
            f"{tag} {name}: no earlier phase timed this step in the run")
        cfg, shape, secs = step["cfg"], step["shape"], step["seconds"]
        af, mf = analytic_flops(cfg, shape), model_flops(cfg, shape)
        roof = Roofline(flops_per_chip=0.0, bytes_per_chip=0.0,
                        collective_per_chip=0.0, chips=1, model_flops=mf,
                        collective_breakdown={}, analytic_flops=af,
                        chip=H100_SXM)
        print(f"{tag} {name}, {cfg.n_layers} layers, B {shape.global_batch}"
              f" x S {shape.seq_len}: analytic {af:.4g} FLOPs, model "
              f"{mf:.4g} FLOPs, compute term {roof.compute_s * 1e3:.3f} ms "
              f"at the {H100_SXM.name} bf16 peak ({peak / 1e12:.0f} "
              f"TFLOP/s; the memory term waits for the dry run); measured "
              f"{_span(secs, '.4f')} s over {len(secs)} timed step(s); mfu "
              f"{_span([100 * mf / (t * peak) for t in secs], '.3g')}%, "
              f"analytic-FLOPs share "
              f"{_span([100 * af / (t * peak) for t in secs], '.3g')}%; "
              f"{card}")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    n_cells = n_leaves = n_bytes = 0
    for arch in GRID_ARCHS:
        cfg = get_config(arch)
        params = tree_leaves(model_fns(cfg).abstract())
        for shape in ALL_SHAPES:
            if cell_supported(arch, shape) is not None:
                continue
            leaves = params + tree_leaves(input_specs(cfg, shape))
            check(all(x.is_meta for x in leaves),
                  f"{tag} {arch} x {shape.name}: a tensor off the meta "
                  f"device")
            n_cells += 1
            n_leaves += len(leaves)
            n_bytes += sum(x.numel() * x.element_size() for x in leaves)
    after = torch.cuda.memory_allocated()
    check(after == before and n_cells == 3 * len(GRID_ARCHS) + 2,
          f"{tag} meta specs of {n_cells} cells: memory_allocated {before} "
          f"-> {after}")
    print(f"{tag} input_specs and model_fns(cfg).abstract() of the {n_cells}"
          f" supported grid cells (deepseek-v2-236b whole, the 524,288-"
          f"token caches): {n_leaves} meta tensors standing for "
          f"{n_bytes / 1e12:.2f} TB, memory_allocated unchanged at "
          f"{after} bytes")
    print(f"{tag} phase time {time.perf_counter() - t_phase:.2f} s; {card}")


def _row(name, src, replaces, launches, per_step, err, ms, plain, nbytes,
         flops, library=None, peak="bfloat16"):
    """One kernel's entry of the ``kernels`` line; ``peak`` names the rate
    its operations run at (the dtype of its inputs)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[peak] * 1e3
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}", "replaces": replaces,
            "launches": launches, "launches_per_step": per_step,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_ms_f32_peak": max(
                t_bytes, flops / PEAK_FLOPS["float32"] * 1e3),
            "library_ms": library}


# ---------------------------------------------------------------------------
# Phase 36: parallel/'s implicit placement on the card
# ---------------------------------------------------------------------------

PLACEMENT_STEPS = 2     # phase 36: steps of each route
PLACEMENT_TOL = 1e-5    # phase 36: placed vs plain loss and grad norm, rel.


def _placement_steps(cfg, dev, mesh, placed):
    """``PLACEMENT_STEPS`` training steps of phase 9's llama3.2-3b (B 1 x
    4096, true fan-in weights drawn from seed 0) under ``DEFAULT_RULES``
    on ``mesh``, the parameters placed by ``param_sharding`` where
    ``placed``. Returns per step (loss, grad norm, seconds to the sync,
    (K3, K4, K3 on the tensor cores, K4 on the tensor cores) launches),
    the peak memory, the parameters' types and the embedding's
    placements."""
    import torch
    from repro_torch.configs.base import TRAIN_4K, TrainConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.registry import model_fns
    from repro_torch.models.schema import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import (DEFAULT_RULES, place,
                                               sharding_context)
    from repro_torch.train import make_train_step
    fns = model_fns(cfg)
    tc = TrainConfig(total_steps=3, warmup_steps=1, learning_rate=3e-4)
    data = SyntheticLMData(cfg.vocab_size, TRAIN_4K.seq_len, 1, seed=0)
    torch.cuda.reset_peak_memory_stats()
    rows = []
    with sharding_context(mesh, DEFAULT_RULES):
        params = _true_fan_in(fns.init(
            torch.Generator(device=dev).manual_seed(0)))
        if placed:
            params = place(params, fns.specs)
        kinds = sorted({type(p).__name__ for p in tree_leaves(params)})
        emb = getattr(params["embed"]["embedding"], "placements", None)
        opt = adamw.init_state(params)
        step = make_train_step(fns.loss, tc)
        held = None
        for _ in range(PLACEMENT_STEPS):
            batch = next(data)
            if held is None:     # what the first step takes, on the card
                held = sum(
                    (t.to_local() if hasattr(t, "to_local") else t).nbytes
                    for t in tree_leaves(params) + tree_leaves(opt.m)
                    + tree_leaves(opt.v) + [opt.step]) + sum(
                    a.nbytes for a in batch.values())
            c0 = _flash_counts() + _flash_tc_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            c1 = _flash_counts() + _flash_tc_counts()
            rows.append((float(m["loss"]), float(m["grad_norm"]), dt,
                         tuple(b - a for a, b in zip(c0, c1))))
    peak = torch.cuda.max_memory_allocated()
    del params, opt, step, m
    _free()
    return rows, peak, kinds, emb, held


def _placement_k3(tag, mesh, dev, card):
    """K3 through ``flash_attention_op`` on DTensors placed by the
    attention's activation spec at ``PERF.md`` §6's K3 shape (B 1, 24/8
    heads, S 4096, D 128, causal, bf16) against the same op on their
    ``to_local()`` shards: EQUAL, bit for bit. Device ms of each beside
    the bound, the plain version and SDPA. Its launches do not count."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor
    from repro_torch.kernels.flash_attention import (flash_attention_op,
                                                     flash_attention_plain)
    from repro_torch.parallel.sharding import (DEFAULT_RULES, NamedSharding,
                                               distribute,
                                               logical_to_physical)
    saved = _save_counts()
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rng = np.random.default_rng(36)
    B, Hq, Hkv, S, D = 1, 24, 8, 4096, 128
    logical = ("batch", "act_heads", "seq", "head_dim")
    q = _rand(rng, (B, Hq, S, D), D ** -0.5).to(dev, torch.bfloat16)
    k = _rand(rng, (B, Hkv, S, D)).to(dev, torch.bfloat16)
    v = _rand(rng, (B, Hkv, S, D)).to(dev, torch.bfloat16)
    placed = [distribute(t, NamedSharding(mesh, logical_to_physical(
        logical, t.shape, DEFAULT_RULES, mesh))) for t in (q, k, v)]
    local = [t.to_local() for t in placed]
    with torch.no_grad():
        c0 = _flash_tc_counts()[0]
        od = flash_attention_op(*placed)
        ol = flash_attention_op(*local)
        ran = _flash_tc_counts()[0] - c0
    check(isinstance(od, DTensor) and od.placements == placed[0].placements
          and torch.equal(od.to_local(), ol) and ran == 2,
          f"{tag} K3 on DTensors {placed[0].placements}: "
          f"{type(od).__name__} {getattr(od, 'placements', None)}, equal "
          f"to the local shards' {torch.equal(od.to_local(), ol)}, "
          f"{ran} tensor-core launches")
    pairs = B * Hq * S * (S + 1) // 2
    el = q.element_size()
    with torch.no_grad():
        ms_dt = _time_ms(lambda: flash_attention_op(*placed), flush,
                         iters=10)
        ms_local = _time_ms(lambda: flash_attention_op(*local), flush,
                            iters=10)
        plain = _time_ms(lambda: flash_attention_plain(q, k, v), flush,
                         iters=3)
        lib = _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=math.log(2), enable_gqa=True),
            flush, iters=10)
    reading = _reading(0.0, ms_dt, plain,
                       2 * q.numel() * el + 2 * k.numel() * el
                       + 2 * B * Hq * S * 4, 4 * D * pairs, lib)
    print(f"{tag} K3 on DTensors placed {placed[0].placements} (B {B}, "
          f"{Hq}/{Hkv} heads, S {S}, D {D}, causal, bf16, tensor cores): "
          f"EQUAL to K3 on their to_local() shards; {ms_dt:.4f} ms (on "
          f"the shards {ms_local:.4f}; plain {plain:.4f}, bound "
          f"{reading['bound_ms']:.4f} by {reading['bound_by']}, SDPA "
          f"{lib:.4f}); {card}")
    del q, k, v, placed, local, od, ol, flush
    _restore_counts(saved)
    _free()
    return {**reading, "shards_ms": ms_local}


def phase_placement(dev, card):
    """36. (P) parallel/'s implicit placement on the card. Returns this
    path's readings of K3 and K4 for the ``kernels`` line."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh, mesh_shape
    from repro_torch.models.registry import get_config
    tag = "[36]"
    t_phase = time.perf_counter()
    mesh = make_host_mesh()
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1 and
          mesh_shape(mesh) == {"data": 1, "model": 1},
          f"{tag} host mesh {mesh_shape(mesh)} over {dist.get_backend()}")
    cfg = get_config("llama3.2-3b").replace(attention_impl="flash")
    L = cfg.n_layers
    runs = {}
    for placed in (False, True):
        _reset_counts()
        runs[placed] = _placement_steps(cfg, dev, mesh, placed)
    (plain, peak0, kinds0, _, _), (rows, peak1, kinds1, emb, held) = \
        runs[False], runs[True]
    check(kinds0 == ["Tensor"] and kinds1 == ["DTensor"],
          f"{tag} parameter types: plain {kinds0}, placed {kinds1}")
    for s, (a, b) in enumerate(zip(plain, rows)):
        rl = abs(b[0] - a[0]) / abs(a[0])
        rg = abs(b[1] - a[1]) / abs(a[1])
        check(rl <= PLACEMENT_TOL and rg <= PLACEMENT_TOL,
              f"{tag} step {s}: placed loss {b[0]} grad norm {b[1]} vs "
              f"plain {a[0]} {a[1]} (rel {rl:.3g}, {rg:.3g})")
        check(b[3] == a[3] == (2 * L,) * 4,
              f"{tag} step {s}: K3/K4 launches (all, tensor cores) placed "
              f"{b[3]}, plain {a[3]}; expected {2 * L} each")
        print(f"{tag} step {s}: plain loss {a[0]:.6f} grad norm "
              f"{a[1]:.5f}, {a[2] * 1e3:.1f} ms; placed loss {b[0]:.6f} "
              f"grad norm {b[1]:.5f}, {b[2] * 1e3:.1f} ms (rel diffs "
              f"{rl:.3g}, {rg:.3g} <= {PLACEMENT_TOL}); placed / plain "
              f"{b[2] / a[2]:.3f}; K3/K4 {b[3][0]}/{b[3][1]} a step, all "
              f"on the tensor cores; {card}")
    print(f"{tag} llama3.2-3b B 1 x 4096 on the (1, 1) mesh under "
          f"DEFAULT_RULES, embedding placed {emb}: peak memory plain "
          f"{peak0 / 2 ** 30:.2f} GiB, placed {peak1 / 2 ** 30:.2f} GiB; "
          f"{card}")
    k3 = _placement_k3(tag, mesh, dev, card)
    dist.destroy_process_group()
    print(f"{tag} phase time {time.perf_counter() - t_phase:.1f} s; {card}")
    steps = {"plain_step_s": [r[2] for r in plain],
             "placed_step_s": [r[2] for r in rows],
             "peak_gib": [peak0 / 2 ** 30, peak1 / 2 ** 30]}
    path = {"flash_attention": {"launches": sum(r[3][0] for r in rows),
                                **steps, "dtensor_k3": k3},
            "flash_attention_bwd": {"launches": sum(r[3][1] for r in rows),
                                    **steps}}
    return path, {"cfg": cfg, "held_bytes": held, "peak_bytes": peak1}


# ---------------------------------------------------------------------------
# Phase 37: the dry run on the card machine
# ---------------------------------------------------------------------------

DRYRUN_PEAK_TOL = 0.05   # phase 37 (b): dry-run peak vs the card's, rel.
VOCAB_TOL = 1e-5         # phase 37 (c): two ranks vs one, relative

# (a) in a process of its own, beside (b) and (c)
_DRYRUN_CELL = """
import json, sys, time
sys.path[:0] = [{src!r}]
from repro_torch.launch import dryrun
from repro_torch.launch.roofline import H100_SXM
t0 = time.perf_counter()
_, rep = dryrun.lower_cell("llama3.2-3b", "train_4k", chip=H100_SXM)
rep["wall_s"] = time.perf_counter() - t0
with open({out!r}, "w") as f:
    json.dump(rep, f)
"""

_VOCAB_RANK = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
import chip_smoke
chip_smoke._vocab_rank({rank}, {store!r}, {out!r})
"""


def _vocab_rank(rank, store, out_path):
    """(c) one of two gloo CPU ranks on a (1, 2) ``("data", "model")``
    mesh: the vocab-parallel loss (z-loss, padded vocab, ignored labels)
    and embedding on vocab-sharded DTensors, and their gradients, against
    the same functions on the whole plain tensors."""
    import datetime
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models.layers import cross_entropy_loss, embed_rows
    from repro_torch.parallel.sharding import placed_scope
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    g = torch.Generator().manual_seed(37)
    B, S, V, d, vocab = 4, 64, 512, 48, 500
    lg = torch.randn(B, S, V, generator=g) * 3
    labels = torch.randint(-1, vocab, (B, S), generator=g)
    table = torch.randn(V, d, generator=g)
    tokens = torch.randint(0, vocab, (B, S), generator=g)
    w = torch.randn(B, S, d, generator=g)

    def run(lg, table):
        loss = cross_entropy_loss(lg, labels, z_loss=1e-4, vocab_size=vocab)
        rows = embed_rows(table, tokens)
        total = loss + (rows * w).sum()
        total.backward()
        return loss, rows

    want = [t.clone().requires_grad_() for t in (lg, table)]
    w_loss, w_rows = run(*want)
    got = [distribute_tensor(t, mesh, [Replicate(), Shard(dim)])
           .requires_grad_() for t, dim in ((lg, 2), (table, 0))]
    with placed_scope():
        g_loss, g_rows = run(*got)
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t

    def rel(a, b):
        return float((full(a) - b).norm() / b.norm())
    res = {"placements": [repr(tuple(t.placements)) for t in got],
           "grad_placements": [repr(tuple(t.grad.placements))
                               for t in got],
           "loss": float(full(g_loss)), "one_loss": float(w_loss),
           "rows_equal": bool(torch.equal(full(g_rows), w_rows)),
           "dlogits_rel": rel(got[0].grad, want[0].grad),
           "dtable_rel": rel(got[1].grad, want[1].grad),
           "torch": torch.__version__}
    with open(out_path, "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def _start_vocab_ranks(tmp):
    """(c) the two gloo CPU ranks, started here: (processes, out files)."""
    procs, outs = [], []
    for r in range(2):
        outs.append(f"{tmp}/rank{r}.json")
        code = _VOCAB_RANK.format(root=str(ROOT), src=str(ROOT / "src"),
                                  rank=r, store=f"{tmp}/store", out=outs[-1])
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs, outs


def _vocab_ranks_reading(tag, card, procs, outs):
    """(c) the two ranks' results, each held to one rank's."""
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=120)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            logs.append(p.communicate()[0] + "\n(timed out)")
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0,
              f"{tag} (c) rank {r} exited {p.returncode}:\n{log[-3000:]}")
    res = []
    for o in outs:
        with open(o) as f:
            res.append(json.load(f))
    rel = [abs(r["loss"] - r["one_loss"]) / abs(r["one_loss"]) for r in res]
    for r, rl in zip(res, rel):
        check(rl <= VOCAB_TOL and r["dlogits_rel"] <= VOCAB_TOL and
              r["dtable_rel"] <= VOCAB_TOL and r["rows_equal"] and
              r["grad_placements"] == r["placements"],
              f"{tag} (c) vocab-parallel loss/embedding on two ranks: {r}")
    r = res[0]
    print(f"{tag} (c) two gloo CPU ranks (torch {r['torch']}), logits "
          f"{r['placements'][0]} and table {r['placements'][1]} "
          f"vocab-sharded: loss {r['loss']:.7f} vs one rank "
          f"{r['one_loss']:.7f} (rel {max(rel):.3g}), gathered rows EQUAL, "
          f"gradients rel L2 <= {max(x['dlogits_rel'] for x in res):.3g} "
          f"(logits), {max(x['dtable_rel'] for x in res):.3g} (table), gate "
          f"{VOCAB_TOL}, each placed as its operand, on both ranks; {card}")


def start_dryrun_cell():
    """Phase 37 (a), started early (``main`` starts it before phase 29,
    whose bench CLIs gate nothing on time): the dry run of llama3.2-3b at
    ``train_4k`` in a process of its own, pure host work on one core.
    Returns (its process, its log, its temp dir)."""
    import tempfile
    tmp = tempfile.TemporaryDirectory()
    log = open(f"{tmp.name}/cell.log", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-c", _DRYRUN_CELL.format(
            src=str(ROOT / "src"), out=f"{tmp.name}/cell.json")],
        stdout=log, stderr=subprocess.STDOUT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, log, tmp


def phase_dryrun(step, card, started=None):
    """37. (D) The dry run on the card machine's torch. (a) llama3.2-3b at
    ``train_4k`` on a fake 256-rank 16 x 16 group (``start_dryrun_cell``,
    or started here); (b) phase 36's one-rank step recorded on a fake
    one-rank (1, 1) group, held to what the card held and peaked at; (c)
    the vocab-parallel loss and embedding on two gloo CPU ranks."""
    import torch.distributed as dist
    tag = "[37]"
    t_phase = time.perf_counter()
    check(not dist.is_initialized(), f"{tag} a process group is left over")
    # (a) and (c) run in processes of their own, beside (b)
    cell, cell_log, tmp = started or start_dryrun_cell()
    ranks = _start_vocab_ranks(tmp.name)
    try:
        _dryrun_one_rank(tag, step, card)
        try:
            cell.wait(timeout=300)
        except subprocess.TimeoutExpired:
            cell.kill()
        cell_log.seek(0)
        check(cell.returncode == 0, f"{tag} (a) exited {cell.returncode}:"
                                    f"\n{cell_log.read()[-3000:]}")
        with open(f"{tmp.name}/cell.json") as f:
            rep = json.load(f)
        _vocab_ranks_reading(tag, card, *ranks)
    finally:
        for p in [cell, *ranks[0]]:
            if p.poll() is None:
                p.kill()
                p.wait()
        cell_log.close()
        tmp.cleanup()
    rf, ma = rep["roofline"], rep["memory_analysis"]
    check(rep["chips"] == 256 and rf["compute_s"] > 0 and
          rf["memory_s"] > 0 and rf["collective_s"] > 0,
          f"{tag} (a) report {rep}")
    print(f"{tag} (a) llama3.2-3b train_4k on a fake 256-rank 16 x 16 group "
          f"({rep['rules']}), per rank: arguments "
          f"{ma['argument_size_in_bytes'] / 2 ** 30:.3f} GiB, peak live "
          f"{ma['peak_live_bytes'] / 2 ** 30:.3f} GiB, bytes accessed "
          f"{rep['cost_analysis']['bytes accessed']:.4g}, collectives "
          + ", ".join(f"{k} {v:.4g} B" for k, v in
                      rf["collective_breakdown"].items() if v) +
          f"; at the {H100_SXM.name} rates: compute {rf['compute_s']:.4g} s, "
          f"memory {rf['memory_s']:.4g} s, collective "
          f"{rf['collective_s']:.4g} s, dominant {rf['dominant']}, roofline "
          f"fraction {rf['roofline_fraction']:.4g}; recorded in "
          f"{rep['wall_s']:.1f} s (placement {rep['lower_s']} s, step "
          f"{rep['compile_s']} s) in a process of its own; {card}")
    print(f"{tag} phase time {time.perf_counter() - t_phase:.1f} s; {card}")


def _dryrun_one_rank(tag, step, card):
    """(b) phase 36's step on a fake one-rank (1, 1) group."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_process_group, make_host_mesh
    from repro_torch.parallel.sharding import DEFAULT_RULES
    cfg = step["cfg"]
    shape = ShapeConfig("train_b1", "train", 4096, 1)
    tc = TrainConfig(total_steps=3, warmup_steps=1, learning_rate=3e-4)
    t0 = time.perf_counter()
    with fake_process_group(1):
        mesh = make_host_mesh(device="cpu")
        rec, _, _ = dryrun.record_step(cfg, shape, mesh, DEFAULT_RULES, tc)
    wall = time.perf_counter() - t0
    n_coll = sum(rec.collective_counts.values())
    rel = rec.peak_live_bytes / step["peak_bytes"] - 1
    check(rec.argument_bytes == step["held_bytes"],
          f"{tag} (b) dry-run argument bytes {rec.argument_bytes} vs "
          f"{step['held_bytes']} held on the card before the step")
    check(n_coll == 0 and not any(rec.collective_bytes.values()),
          f"{tag} (b) collectives on one rank: {rec.collective_counts}")
    check(abs(rel) <= DRYRUN_PEAK_TOL,
          f"{tag} (b) dry-run peak live {rec.peak_live_bytes} vs the card's "
          f"peak {step['peak_bytes']} (rel {rel:+.4f}, tolerance "
          f"{DRYRUN_PEAK_TOL})")
    print(f"{tag} (b) phase 36's placed llama3.2-3b step (B 1 x 4096, "
          f"flash) recorded on a fake one-rank (1, 1) group in {wall:.1f} s:"
          f" arguments {rec.argument_bytes} B EQUAL to the "
          f"{step['held_bytes']} B of parameters, AdamW state and batch the "
          f"card held; peak live "
          f"{rec.peak_live_bytes / 2 ** 30:.3f} GiB vs the card's max "
          f"allocated {step['peak_bytes'] / 2 ** 30:.3f} GiB (rel "
          f"{rel:+.4f}, tolerance {DRYRUN_PEAK_TOL}); no collective; kernel "
          f"calls {dict(rec.kernel_calls)}; {card}")


def step_memory_terms():
    """The dry run's record of each step of phase 35's MFU table, its
    config cut as its phase runs it, on a fake one-rank (1, 1) group:
    bytes accessed, the memory term at ``H100_SXM``'s HBM rate, peak live
    bytes, collectives. Pure host work (no card needed, no kernel
    launched); ``main`` does not call it, ``PERF.md`` §5 reads it."""
    import dataclasses
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_process_group, make_host_mesh
    from repro_torch.models.registry import get_config
    from repro_torch.parallel.sharding import DEFAULT_RULES
    ds = get_config("deepseek-v2-236b")
    ds = ds.replace(n_layers=ds.moe.first_dense + DEEPSEEK_TRAIN_MOE_LAYERS,
                    moe=dataclasses.replace(
                        ds.moe, n_experts=DEEPSEEK_TRAIN_EXPERTS))
    llama = get_config("llama3.2-3b")
    steps = {
        "llama3.2-3b train": (llama.replace(attention_impl="flash"),
                              "train", 1, 4096),
        "llama3.2-3b decode (static, 447 cached)": (llama, "decode", 8, 447),
        "deepseek-v2-236b expanded train": (ds, "train", 1, 4096),
        "deepseek-v2-236b absorbed train": (
            ds.replace(opt_mla_absorbed=True), "train", 1, 4096),
        "hymba-1.5b train": (get_config("hymba-1.5b").replace(
            attention_impl="flash"), "train", HYMBA_TRAIN_ROWS,
            HYMBA_TRAIN_SEQ),
        "rwkv6-7b train": (get_config("rwkv6-7b").replace(
            n_layers=RWKV_TRAIN_LAYERS), "train", RWKV_TRAIN_ROWS,
            RWKV_TRAIN_SEQ),
        "whisper-base train": (get_config("whisper-base").replace(
            attention_impl="flash"), "train", 8, WHISPER_SLOTS)}
    for name, (cfg, kind, B, S) in steps.items():
        t0 = time.perf_counter()
        try:
            with fake_process_group(1):
                rec, _, _ = dryrun.record_step(
                    cfg, ShapeConfig(name, kind, S, B),
                    make_host_mesh(device="cpu"), DEFAULT_RULES)
        except Exception as e:          # a DTensor rule of this torch
            print(f"[terms] {name}, B {B} x S {S}: not recorded: "
                  f"{type(e).__name__}: {str(e).splitlines()[0][:200]}")
            continue
        print(f"[terms] {name}, B {B} x S {S}: bytes accessed "
              f"{rec.bytes_accessed:.4g}, memory term "
              f"{rec.bytes_accessed / H100_SXM.hbm_bw * 1e3:.2f} ms at "
              f"{H100_SXM.hbm_bw / 1e12:.2f} TB/s, peak live "
              f"{rec.peak_live_bytes / 2 ** 30:.2f} GiB, collectives "
              f"{sum(rec.collective_counts.values())}, kernel calls "
              f"{dict(rec.kernel_calls)}; recorded in "
              f"{time.perf_counter() - t0:.1f} s")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import platform
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[1] python {platform.python_version()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    print(f"[1] {card}")

    t0 = time.perf_counter()
    build.load_library()
    print(f"[2] kernels built and loaded in {time.perf_counter() - t0:.1f}s")
    for line in build.ptxas_report().splitlines():
        if "entry function" in line or "registers" in line or \
                "spill" in line:
            print("[2] " + line.strip())
    for name, regs, spill in _ptxas_kernels(
            build.ptxas_report(), ("flash_decode_bulk.cu", "softermax.cu",
                                   "softermax_quant.cu",
                                   "flash_prefill_paged_tc.cu",
                                   "flash_decode_paged_bulk.cu",
                                   "flash_decode_paged_single_bulk.cu")):
        print(f"[2] ptxas {name}: {regs} registers, {spill}")

    phase_kernel_parity(dev)
    phase_engine_parity(dev)
    main_counts, decode_step = phase_full_width(dev)
    from repro_torch.models.registry import get_config
    print("[6] sm clock, power draw, temperature: " +
          card_line("clocks.sm,power.draw,temperature.gpu"))
    n_layers = get_config("llama3.2-3b").n_layers
    kernels = phase_kernel_times(dev, main_counts, n_layers)
    flash_errs = phase_flash_parity(dev)
    f32_counts = phase_train_parity(dev)
    train_counts, train_step = phase_train_full_width(dev)
    print("[10] sm clock, power draw, temperature: " +
          card_line("clocks.sm,power.draw,temperature.gpu"))
    kernels += phase_flash_times(dev, train_counts, f32_counts, flash_errs,
                                 n_layers)
    phase_decode_parity(dev)
    phase_static_parity(dev)
    k5_launches = phase_static_full_width(dev)
    print("[14] sm clock, power draw, temperature: " +
          card_line("clocks.sm,power.draw,temperature.gpu"))
    kernels += phase_decode_times(dev, k5_launches, n_layers)
    phase_softermax_parity(dev)
    phase_fixed_reduced(dev)
    k7_launches = phase_fixed_full_width(dev)
    k6_launches = phase_naive_full_width(dev)
    phase_bert_finetune(dev)
    print("[20] sm clock, power draw, temperature: " +
          card_line("clocks.sm,power.draw,temperature.gpu"))
    kernels += phase_softermax_times(dev, k6_launches, k7_launches, n_layers)
    phase_single_parity(dev)
    bench_args, k8_launches = phase_decode_bench(dev, card)
    phase_autotune(dev, card)
    print("[24] sm clock, power draw, temperature: " +
          card_line("clocks.sm,power.draw,temperature.gpu"))
    kernels += phase_single_times(dev, bench_args, k8_launches)
    phase_serving_benches(dev, card)
    print("[25] sm clock, power draw, temperature: " +
          card_line("clocks.sm,power.draw,temperature.gpu"))
    phase_paper_tables(dev, card)
    phase_telemetry(dev, card)
    phase_resilience(dev, card)
    dryrun_cell = start_dryrun_cell()          # phase 37 (a), on the host
    phase_fleet(dev, card)
    moe_path = phase_moe(dev, card)
    family_path = phase_families(dev, card)
    whisper_path, whisper_step = phase_whisper(dev, card)
    parallel_path = phase_parallel(dev, card)
    family_train_path, family_steps = phase_family_train(dev, card)
    phase_analytic([train_step, decode_step, *family_steps, whisper_step],
                   card)
    placement_path, placement_step = phase_placement(dev, card)
    phase_dryrun(placement_step, card, dryrun_cell)
    for k in kernels:
        k["card"] = card
        if k["name"] in moe_path:
            k["moe"] = moe_path[k["name"]]
        if k["name"] in family_path:
            k["families"] = family_path[k["name"]]
        if k["name"] in whisper_path:
            k["whisper"] = whisper_path[k["name"]]
        if k["name"] in parallel_path:
            k["parallel"] = parallel_path[k["name"]]
        if k["name"] in family_train_path:
            k["families_train"] = family_train_path[k["name"]]
        if k["name"] in placement_path:
            k["placement"] = placement_path[k["name"]]
        lib = "" if k["library_ms"] is None else \
            f", library {k['library_ms']:.4f} ms"
        if "earlier_ms" in k:
            lib += f", earlier route {k['earlier_ms']:.4f} ms"
        print(f"[kernels] {k['name']}: {k['ms']:.4f} ms (plain "
              f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms by "
              f"{k['bound_by']}{lib}), {card}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
