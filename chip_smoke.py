#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``skypilot_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero). Depth cuts, widths untouched, so
that phases 18 and 19 fit the script's time limit: phases 7-8, 12-14,
15b, 16a-16b, 18a, 18c-18g and 19a-19b run bench-1b and moe-8x1b at
``SERVE_LAYERS`` (4) of their 18 layers; phases 9 and 11 serve
llama3-1b at ``RECIPE_LAYERS`` (4) of its 16 and phase 10 trains it at
``FINETUNE_LAYERS`` (4); 18b serves llama3-8b at ``TP8_LAYERS`` (4) of
its 32; 19d trains moe-8x1b at ``MOE_MESH_LAYERS`` (4) and 19e bench-1b
at ``STAGE_LAYERS`` (4) and ``UNEVEN_LAYERS`` (6). Phase 6 trains
bench-1b, phase 15a boots it and phase 17 serves it at all 18 layers. A
``sitecustomize`` cuts the preset in the subprocesses of phases 10, 18
and 19 (18f's and 18g's ranks cut it themselves):

1. Build: compiles both kernel libraries of ``skypilot_tpu_torch/csrc``
   (flash-decode K4, flash-attention K1-K3), one nvcc each, started
   together; prints the seconds and the compiler's register report.
2. K4 against its plain version at BENCH_1B decode shapes (Hq=16,
   Hkv=8, D=128, M=1024, B in {1, 32}; M=1000; a D=64 case), at the edges
   of the kernel's split of the cache (lengths of a chunk and one either
   side, 1, 0 and M, at B=7 and at B=32), with one chunk longer than M
   (M=48, group 1) and a group that is no power of two (3), and the
   continuous engine's decode batch (B=16, M=1024, lengths 0, 1, M and
   past M, as free slots' junk rows reach), the serve-llama recipe's
   (llama3-1b: B=16, Hq 32, Hkv 8, D=64, M=2048, the same lengths), one
   tensor-parallel rank's (phase 18: bench-1b at tp 2, Hq 8 Hkv 4 M=1024;
   llama3-8b at tp 8, Hq 4 Hkv 1 M=2048), the
   speculative engine's draft (bench-draft: B=16, Hq 8, Hkv 8, D=64,
   M=1024, the same lengths), serve-disagg's decode replica (bench-1b:
   B=16, Hq 16, Hkv 8, D=128, M=2048, the same lengths) and one rank's
   block of the slots on data=2,tensor=2 (phase 18f: B=8, Hq 8, Hkv 4,
   M=1024, lengths 0, 1, M and past M), bf16 and int8
   caches, bf16 and fp32
   queries. Tolerances: bf16 2e-2 (bf16 output
   rounding, sums in another order), fp32 1e-4. Every case is also held
   against ``flash_decode_split_reference`` at the kernel's own chunk
   (``decode_split``), the same partials and merge, so only the order of
   sums differs: fp32 to 1e-5, bf16 to ||got - want|| / ||want|| of each
   (row, head) within SPLIT_REL_TOL. Prints kernel, plain, library (SDPA)
   and bound ms per bf16 case, from CUDA events around calls issued one
   after another after warm-up; where the host takes longer to issue a
   call than the device to run it (K4 at small B), that is the host's
   time per call.
3. K1, K2, K3 against their plain versions: the training shape (B=2,
   Hq 16, Hkv 8, D 128, S=4096, bf16, causal), B=1, non-causal, ragged
   S=1000 and S=65, D=64 with group 4, fp32 inputs (the CUDA-core
   bodies; bf16 runs the tensor-core ones), and the edges of the 128-row
   tiles of K1 and K3 (S=4032, a multiple of 64 but not of 128; S=129;
   S=1; D=64 with group 2 at S=4096), the llama-finetune recipe's
   shape (llama3-1b: B=8, Hq 32, Hkv 8, D 64, S=2048), the
   lora-finetune recipe's (BENCH_1B: B=16, Hq 16, Hkv 8, D 128,
   S=2048) and train-moe's (moe-8x1b: B=2, Hq 16, Hkv 8, D 128,
   S=2048), walks of the persistent K1 with more work tiles than SMs, a
   ragged last round and B*Hq no multiple of the SM count (B=3, Hq 12,
   Hkv 4, S=1000, D 64; B=5, Hq 16, Hkv 8, S=1537, D 128), and D=64
   non-causal at a ragged S=1000 (keys past S masked in K1's last key
   tile, rows past S in K3's 128-row tiles). Each bf16 case
   prints K1's grid beside the SM count; the library's own account of
   every bf16 launch (``attention.plan``: blocks, tile, stages, shared
   memory) must equal ``ops/flash_schedule``'s, which the CPU tests
   check. Absolute
   tolerances: bf16 o 2e-2,
   grads 5e-2; fp32 1e-4 and 1e-3 (lse always 1e-3). Those are near the
   size of a bf16 value at S=4096, so each of o, dq, dk, dv is also held
   to a relative limit on every tile of 64 rows along S:
   ||got - want|| / ||want|| over the tile (REL_TOL). Prints kernel,
   plain, library (SDPA forward for K1, SDPA's backward for K2+K3
   together) and bound ms for the four training shapes (train-s4096's,
   llama-finetune's, lora-finetune's and train-moe's), with TFLOP/s and
   the share of the bound. Fails
   unless every instance of the wgmma bodies of K1, K2 and K3 (12: D
   64/128, causal or not; two of each body at D=64, whose K1 and K3
   tiles differ from D=128's) shows HGMMA and UTMALDG in the library's
   SASS and ptxas reports 0 spill bytes for it.
4. Serving end to end on a small model (head_dim 64, float32): prefill
   and decode logits on the card (through K4) against the CPU; then the
   continuous engine (4 slots, max_len 48, 7 requests, full and int8 KV)
   on the card against the same engine on the CPU, token for token, and
   the same again with the paged layout (blocks of 16, a pool of 6 usable
   blocks, block sharing and KV tiers on; requests on repeated 16- and
   32-token heads in 4 waves: share hits, a copy-on-write fork, evictions
   demoted to the host tier and promoted back); then the speculative
   engine (k 3, a one-layer divergent draft and the target as its own
   draft; slot layout full and int8 KV, paged layout), tokens and
   proposal counts equal card against CPU. Then
   ``quantization.mm`` on the card (bf16 x bf16 -> float32 GEMM) against
   the CPU's float32 einsum for each projection of BENCH_1B and llama3-1b:
   int8 weights' bf16 outputs within one ulp, at most MM_BF16_DIFF_SHARE
   of them differing, float32 logits within MM_F32_REL_TOL.
5. Training end to end on a small model (head_dim 64, float32): 3 steps
   of the port's ``Trainer`` on the card (K1-K3) and on the CPU from the
   same weights and batches; losses and params compared. Then 3 LoRA
   steps (rank 4, every target, float32 adapters) card against CPU:
   losses and adapters within 1e-4, the base bit for bit unchanged.
6. Training BENCH_1B, the training main path: ``train.run.main`` at seq
   4096, global batch 2, Adafactor, remat 'full', 4 steps, warmup 1.
   Every loss must be finite, the weights must move, and the launch
   counts must be K1 = 2 * 18 * 4 (remat runs the forward again) and
   K2 = K3 = 18 * 4.
7. Serving through the window path: ``LlmServer('bench-1b',
   max_len=1024, engine='off')`` over HTTP, bf16 weights + bf16 KV, then
   int8 weights + int8 KV. A few
   concurrent requests (greedy and seeded-sampled); checks status, token
   counts and ids, repeat determinism, agreement with a direct
   ``generate`` call, and that K4 was called n_layers * (max_new - 1)
   times for each generate call (a call is two launches: the split
   kernel and the merge). Prints decode tokens/s.
8. Serving, the serving main path: ``LlmServer('bench-1b', max_len=1024)``
   with its default continuous engine (16 slots, chunks of 8 steps,
   pipelined) over HTTP, bf16 + bf16 KV, then int8 + int8 KV. 24
   concurrent requests (prompts 17-300, max_new 8-64, greedy, top-k and
   top-p sampled, no seed), then one streamed request. Checks status, ids,
   lengths, that the NDJSON lines add up to the same request's tokens
   when not streamed, that K4 was called n_layers x chunk_steps x
   dispatches times in that window (``stats()['pipeline']``), and that
   each greedy answer equals a direct ``generate`` or parts from it only
   where the direct path's top-2 logit gap is below GREEDY_GAP_LIMIT.
   Then a second engine with max_len 128 serves requests one after
   another for more than 128 decode steps while 15 slots idle past
   max_len: no fault. Prints tokens/s, the host's ms per decode step and
   the pipeline counters.
9. The serve-llama recipe (``examples/llm/serve-llama/serve.yaml``):
   ``LlmServer('llama3-1b', max_len=2048, quantize='int8',
   kv_cache='int8', prefix_cache=8)`` over HTTP, at full width and 8 of
   its 16 layers (``RECIPE_LAYERS``, as in phase 11). 4 preambles of 256
   random ids; a warm-up of 8 requests (each preamble twice, storing 4
   pool entries), then 32 concurrent requests (a preamble + 16-200 ids,
   max_new 16-64, greedy, top-k and top-p, no seed): 32 pool hits and
   8,192 hit and saved tokens in that window, K4 launched n_layers x
   chunk_steps x dispatches times, greedy answers under the gap rule,
   and the device busy share of one more such round. The same rounds on
   a replica without the pool, printed beside it. Then a replica with
   SKYTPU_LLM_PREFILL_CHUNK=256: a 1,500-token prompt arrives while 15
   short requests decode; >= 6 prefill chunks, decode chunks run
   meanwhile, its greedy answer under the gap rule.
10. The llama-finetune recipe (``examples/llama_finetune.yaml``):
   ``train.run.main`` with llama3-1b, global batch 8, seq 2048, Adafactor,
   remat 'full', checkpoints under ``_ckpt_smoke/`` (removed at the end),
   telemetry to a spool read back with ``read_records``. A: 4 steps,
   async saves at 2 and 4. B: the same dir to 6 steps; it must print
   ``resumed from checkpoint step 4``. C: 6 steps in a fresh dir with
   ``--ckpt-sync``, saves at 3 and 6. A's losses must equal C's first four,
   B's C's last two, and B's final state C's, bit for bit; K1/K2/K3
   launches over A, B and C = 2L / L / L per step (L = 4). Then the recipe
   in a subprocess (``--steps 10 --save-every 3``, with
   ``--ckpt-local-dir``) gets SIGTERM after its line ``step 4/10``: exit
   143 with step 3 or later durable; a relaunch with ``--steps 5`` must
   print the resumed line and exit 0. Every committed step passes
   ``verify_step(deep=True)``. Prints step ms, tokens/s, MFU, peak device
   memory, snapshot bytes, the stall of each async and sync save, persist,
   restore and emergency-persist seconds. The preempted run's SIGTERM
   handler also dumps a ``sigterm`` incident bundle (checked in 16d).
11. The paged layout at full width: ``LlmServer('llama3-1b',
   max_len=2048, quantize='int8', kv_cache='int8', kv_layout='paged')``
   over HTTP, 8 of 16 layers, the engine's defaults (16 slots, chunks of
   8, pipelined, blocks of 16, sharing and tiers on). P1, the
   full-capacity pool (2,049 blocks): a warm-up of one request per
   preamble of phase 9's traffic, its 32-request window (32 share hits,
   8,192 hit tokens), then 4 requests that copy an earlier one's first
   264 tokens and diverge (>= 4 copy-on-write forks). P2, ``kv_blocks``
   257 with SKYTPU_KV_HOST_BYTES=5,000,000 (two 256-token chains of
   int8 blocks at 8 layers) and a temporary spill directory (removed at
   the end): round 1 the same window, round 2 8 new preambles x 2
   requests, round 3 the first 4 preambles again; evictions, demotes and
   spills >= 1, promotes + fetches >= 1 in round 3, nothing corrupt. In
   every window K4 is launched n_layers x chunk_steps x dispatches
   times, answers are whole and greedy ones meet the gap rule; after
   each drain the block accounts reconcile exactly (owned 0, used ==
   cached, free + cached == usable). Prints P1's figures beside phase
   9's slot layout, and each P2 round's.
12. The lora-finetune recipe
   (``examples/llm/lora-finetune/lora_finetune.yaml``): ``train.run.main``
   with bench-1b, global batch 16, seq 2048, ``--mesh fsdp=-1``, rank 16,
   alpha 32, targets wq,wk,wv,wo, Adafactor, remat 'full', checkpoints
   under ``_ckpt_lora_smoke/`` (removed at the end). A: 4 steps, saves at
   2 and 4; B: the same dir to 6 (must print ``resumed from checkpoint
   step 4``); C: 6 steps in a fresh dir (sync saves at 3 and 6). A's
   losses equal C's first four, B's C's last two, B's final state C's
   bit for bit; the base after 6 steps equals the initial weights bit
   for bit; the adapters hold 229,376 values a layer; the optimizer
   state is under half the base's size; K1/K2/K3 launches = 2L / L / L
   per step (L = 9). Prints step ms, tokens/s, MFU and peak device
   memory.
13. Speculative decoding at full width, SKYTPU_LLM_SPEC_K=4:
   ``LlmServer('bench-1b', max_len=1024, draft_model='bench-draft')``
   over HTTP (bf16 + bf16 KV, the engine's defaults) with phase 8's
   traffic, then one stream: answers whole, the stream equal to the
   request not streamed, greedy answers under the gap rule against a
   direct target ``generate``, /health's speculative block, K4 launched 4
   draft layers x (k+1) x rounds times. Then the window path
   (``engine='off'``) with the draft: 4 greedy rows of 128 tokens, 64
   new, through ``generate_speculative`` (gap rule, verifies > 0, K4 = 4
   x (k+1) x verifies). Then an engine whose draft is its target
   (bench-draft): acceptance >= 0.9. Prints the pair's acceptance (near
   0 with random weights), tok/s and host ms a round beside phase 8's
   bf16 figures of the same call.
14. Mixture of experts. 14a: a small MoE model (4 experts, top-2,
   head_dim 64, float32, capacity factor 1.0 so that choices drop), card
   against CPU: ``forward_cached`` prefill and decode logits within 1e-4;
   the engine with 16 slots (a decode step's capacity of 8 binds), slot
   and paged, full and int8 KV, 24 requests queued before its loop
   starts, token for token; 3 ``Trainer`` steps, losses, ``moe_aux`` and
   params within 1e-4; a failure prints the smallest gap between a
   token's top-2 and top-3 router probabilities. 14b:
   ``LlmServer('moe-8x1b', max_len=1024, prefix_cache=8)`` over HTTP,
   bf16 + bf16 KV, then int8 + int8 KV: /health shows the engine serial
   and the pool off; phase 8's traffic and one stream (answers whole,
   the stream equal to the request not streamed), K4 = n_layers x
   chunk_steps x dispatches; co-batched greedy answers against a direct
   ``generate`` are printed in bf16 (capacity per call may part them),
   and a
   lone 64-token greedy request after the traffic must meet the gap
   rule; tok/s, host ms a step, kernels a step, device busy share and
   peak memory. 14c: the window path (``engine='off'``), 4 greedy rows
   of 17-300 tokens x 64 new in one request: equal to a direct
   ``generate`` of the batch, K4 = n_layers x (max_new - 1), each row
   against its solo ``generate`` under the gap rule. 14d:
   ``train.run.main`` with moe-8x1b, global batch 2, seq 2048 (the
   moe-finetune recipe runs batch 16 on ``fsdp=2,expert=8``), Adafactor,
   remat 'full', 3 steps: finite losses and ``moe_aux``, the router and
   every expert leaf moved, K1 = 2 x L x 3, K2 = K3 = L x 3 (L = 9);
   step ms, tokens/s, the printed mfu and the active-parameter share.
15. The replica's boot and fleet contract, bench-1b. 15a: three fresh
   replicas through ``python -m skypilot_tpu_torch.serve.llm_server
   --model bench-1b`` (subprocesses, SKYTPU_PROFILE=1, one empty
   temporary SKYTPU_COMPILE_CACHE shared by all three): A with warm-up
   off and the kernel-build cache cold, B with warm-up off and the cache
   warm, C with SKYTPU_WARMUP=1. Each: /health polled until 200, one
   greedy request (prompt 128, 16 new), then a second (the steady
   state), then SIGTERM, which must drain to exit 0. Checks:
   ``compile_cache.warm`` false in A, true in B and C; C's ``warmup``
   covered with no error; the cold-start ledger's phases in their
   declared order, non-negative, summing to the wall time from spawn to
   the first answer within 5%; ``profile`` program names the JAX
   package's. Prints each boot's first and steady TTFT and its ledger.
   15b: ``LlmServer('bench-1b', qos='on')`` behind ``make_httpd`` with
   SKYTPU_QOS_MAX_QUEUE=16: the warm-up (covered), then 48 requests of
   phase 8's mix, 36 batch, 6 standard and 6 interactive, sent in that
   order: answers whole, greedy ones under the gap rule, every 429 with
   ``Retry-After``, sheds on batch first and none on interactive, served
   + shed + evicted = 48 and equal to /health's ``qos`` counters, a
   mid-flood /health with ``depth_total`` = pending + overflow +
   ``qos.queue_depth_total`` > 0, ``ttft_ms.count`` = requests served,
   interactive's mean queue wait (of those that queued) below batch's,
   /metrics parsed by a small parser with exactly the port's families,
   /metrics and /debug/profile 401 without SKYTPU_METRICS_TOKEN's bearer
   and 200 with it, K4 = n_layers x chunk_steps x dispatches. Phase 15's
   kernel-build cache stays for phase 16.
16. serve-traced, bench-1b. 16a: ``LlmServer('bench-1b')`` (bf16 + bf16
   KV, max_len 1024, the engine's defaults) behind ``make_httpd``,
   tracing on, SKYTPU_TRACE_TAIL_LATENCY_MS=standard:1 and
   SKYTPU_METRICS_TOKEN set: phase 8's 24 requests at once, each with its
   own ``X-SkyTPU-Trace``, 4 of them streamed and 2 with
   ``X-SkyTPU-Trace-Resume``, plus 2 malformed bodies. Answers whole (the
   malformed ones 400), greedy ones under the gap rule; each id's
   /debug/traces holds one ``serve.generate`` root joined to its header,
   children of JAX's names inside it, ``serve.stream`` exactly on the
   streams; retained as ``slow`` / ``resumed`` / ``error`` (the 400s),
   ``X-SkyTPU-Trace-Verdict`` on each answer not streamed; /health
   ``trace`` = those counts; every /debug/exemplars trace id resolves;
   /metrics in OpenMetrics parses, ends in ``# EOF``, with exemplars on
   ``skytpu_serve_ttft_seconds`` buckets; /debug/alerts in JAX's shape;
   the four /debug routes 401 without the bearer, 200 with it; K4 =
   n_layers x chunk_steps x dispatches. 16b: 4 lone greedy requests
   (128 + 32), each with SKYTPU_TRACE 1, then 0: byte-identical; 16 x
   (128 + 64) greedy at once, tracing off, on, off, on, off, on: tok/s,
   host ms a decode step and rows equal to the first run's, of each (no
   limit). 16c:
   /debug/blackbox?dump=1 (admit, dispatch, retire in order on the ring,
   /health with ``trace``, the token nowhere in the file); a small engine
   on the card whose chunk dispatch raises (every waiter fails, one
   ``engine_failure`` bundle); ``python -m
   skypilot_tpu_torch.serve.llm_server --model bench-1b`` on phase 15's
   kernel cache: after one request SIGQUIT writes the threads' stacks
   (the engine's too) to ``sigquit-<pid>-llm_server:colocated.txt`` and
   it answers after,
   SIGTERM exits 0 with a ``sigterm`` bundle whose ring ends with
   ``server.drain``. 16d: phase 10's preempted trainer's ``sigterm``
   bundle holds ``ckpt.snapshot`` / ``ckpt.commit`` and was written after
   the durable step's commit marker. 16e: ``python -m
   skypilot_tpu_torch.utils.cuda_doctor`` on the card (completed, the
   ladder in order with its seconds), with ``CUDA_VISIBLE_DEVICES=``
   (``no_device``, the diagnosis names the missing device), and held at
   ``python-started`` past a 1 s phase deadline (a timeout naming it,
   inside 60 s).
17. serve-disagg, bench-1b: three replicas in this process, each
   ``make_httpd`` on its own port, with the same options: colocated (the
   reference), ``role='prefill'`` and ``role='decode'``. The script runs
   the load balancer's legs itself over HTTP: ``/v1/kv/export`` ->
   ``/v1/kv/prepare`` -> ``/v1/kv/fetch?skip_blocks=`` ->
   ``/v1/kv/import?stream=1``. 17a (``--kv-layout paged``, blocks of 16,
   max_len 2048, bf16 + bf16 KV, sharing on): 4 lone greedy requests
   (prompts 17, 128, 300, 1,984, 64 new) colocated and through the
   handoff, byte-identical; the decode replica's installed blocks, read
   back through ``paged._export_blocks_impl`` right after the install,
   equal the exported planes bit for bit at the prompt's positions; K4
   does not move across an export; then 4 preambles of 256 ids warmed
   into the decode trie and 16 concurrent handoffs of preamble + 16-200
   ids (greedy, top-k 50, top-p 0.9): ``skip_blocks`` 16 each, payloads
   at least 16 blocks' planes smaller, answers whole, greedy ones under
   the gap rule; K4 = n_layers x chunk_steps x the decode replica's
   dispatches, with none on the prefill and colocated replicas; /health
   ``role`` and ``disagg`` and the engines' counters equal the traffic
   (no fallbacks, no ``import_errors``). 17c: 2 handoffs through a
   staging directory; a payload with a flipped byte gets 400 (imports
   unchanged, the next handoff served: equal to colocated, or else each
   parts from a direct ``generate`` only where its top-2 logit gap is
   under GREEDY_GAP_LIMIT, its position and gap printed); a negotiated
   prefix evicted
   before its import gets 409 before any line. 17b (slot layout, int8
   weights + int8 KV, max_len 1024): 4 lone greedy requests (17, 128,
   300, 900 x 64) with the scale planes, byte-identical; K4 as in 17a.
   Prints each handoff's export, fetch and import ms, bytes and GB/s,
   TTFT through the handoff and colocated, decode tok/s and the phase's
   seconds, each beside the card's name and power limit.
18. serve-tp: tensor-parallel serving, every rank a process on the one
   card (NCCL refuses two ranks on one device, checked first; the ranks
   reduce through gloo staged through host memory). 18a and 18b run side
   by side, then 18c, 18d and 18e (``_side_by_side``: each waits on its
   ranks' startup and the host more than on the card; their speeds are
   not those of a replica alone). 18a: ``python -m
   skypilot_tpu_torch.serve.llm_server --model bench-1b --tp 2`` (rank 0
   starts its follower): /health ``tp`` 2 and ``tp_backend`` gloo, a
   seeded request refused with a 400 in JAX's words, 4 lone greedy
   requests (17, 128, 300, 900 x 64), 16 concurrent mixed ones whole, the
   stream = the request not streamed, SIGTERM drains both ranks to exit
   0; each rank's K4 calls = n_layers x chunk_steps x dispatches at Hkv
   4; the
   lone answers against a tp 1 replica of the same seed under the gap
   rule; the ranks' weight bytes sum to tp 1's plus the replicated
   norms' copies, neither holding the whole model. 18b: the
   serve-multihost recipe's command (``python -m
   skypilot_tpu_torch.serve.spmd --model llama3-8b --max-len 2048 --tp 8
   --quantize int8 --kv-cache int8``) as two hosts of four ranks under
   the gang launcher's env, full width at ``TP8_LAYERS`` (4) of 32
   layers (a ``sitecustomize`` cuts the preset in every rank): a stop
   before the first
   request exits all eight ranks 0; then 4 greedy requests sent together
   (17, 128, 300, 900 x 16, decoded one step a chunk: eight ranks share
   the card) against a tp 1 llama3-8b int8 replica under the gap rule,
   K4 int8 at Hkv 1 on every rank. In both, every rank prints the crc32
   of every token it sampled (free slots' included), and the phase fails
   unless all ranks' are equal. Prints tok/s, host ms a decode step,
   collectives a step and their host ms, the backend, the ranks' peak
   memory, each beside the card's name and power limit. K4 at both shard
   shapes, and at ``--nccl``'s tp 4 shards, is held to its plain version
   and timed in phase 2. Then every option at tp 2, the decode kernel
   per head shard in each. 18c: ``--model bench-1b --tp 2 --kv-layout
   paged --role decode --kv-blocks 257`` (256 usable blocks of 16, a
   quarter of the slot layout's positions), sharing and KV tiers on
   (``SKYTPU_KV_HOST_BYTES`` about 17 whole-head blocks, a temporary
   spill directory):
   a warm-up of 4 preambles of 256 ids, 16 concurrent requests of a
   preamble + 16-200 ids x 32 new (a third greedy, top-k 50, top-p
   0.9), 8 new preambles x 2, the first 4 preambles again (greedy, served
   from share hits and promoted blocks: equal a direct ``generate`` of
   the tp 1 replica below or part under the gap rule), every answer
   whole and the head's block accounts reconciled after each drain;
   share hits, evictions, demotes and spills >= 1, fetches + promotes
   >= 1, none corrupt; then 4 handoffs (17, 128, 300, 900 x 64, greedy)
   from a tp 1 ``--role prefill`` paged bf16 replica of the same seed in
   this process over the ``/v1/kv/*`` legs, /health ``role`` decode, 4
   imports and no fallback, the answers (and the tp 1 replica's own)
   equal a direct ``generate`` or part under the gap rule; every rank's
   block accounts (reconciled), share counters and tier decisions equal.
   18d: ``--model bench-1b --tp 2 --draft-model bench-draft``
   (``SKYTPU_LLM_SPEC_K`` 4): phase 8's traffic, 4 lone greedy requests
   against a tp 1 replica without a draft under the gap rule, rounds > 0,
   the speculative counters equal on both ranks, K4 = 4 draft layers x 5
   x rounds a rank at the draft's shard (Hq 4, Hkv 4, D 64). 18e:
   ``--model moe-8x1b --tp 2`` at ``SERVE_LAYERS`` (4) of 18 layers:
   phase 8's traffic and a lone greedy request against a tp 1 moe-8x1b
   replica under the gap rule, the ranks' weight bytes tp 1's split in
   two plus the router's and norms' copies, K4 = 4 x 8 x dispatches a
   rank. In all three the digests are equal and SIGTERM exits every
   rank 0. 18f (beside 18a-18e): ``serve.spmd.SpmdEngine`` on
   ``data=2,tensor=2`` (no flag reaches the data axis: the engine's
   ``mesh=``), four ranks of one gang, bench-1b at ``SERVE_LAYERS``,
   16 slots, max_len 1024, bf16 + bf16 KV: the slot layout, then the
   paged layout (blocks of 16, 257 blocks, sharing and tiers on), each
   with phase 8's 24 requests whole, its stream of 40 adding up to its
   answer (= the request not streamed, on the slot layout; on the paged
   one that request is a share hit, another order of sums), and 4 lone
   greedy requests (17, 128, 300, 900 x 64) against
   a tp 1 replica under the gap rule; then moe-8x1b (8 of the requests,
   a lone greedy one against tp 1), bench-1b with bench-draft (the lone
   requests at once, rounds > 0, against tp 1) and the prefill and
   decode roles (the lone prompts exported with whole heads and
   imported: against tp 1 under the gap rule). In every run
   every rank's digest and engine state are equal and its K4 calls =
   n_layers x chunk_steps x dispatches (the draft's: its layers x (k+1)
   x rounds) at its block, B=8 Hq 8 Hkv 4; a slot-layout rank holds a
   quarter of tp 1's cache; the paged block accounts reconcile and the
   pools but the junk sink are equal across the data ranks of a tensor
   index. 18g (its own gang of four ranks, started before phase 17 and
   serving beside it and 18a-18f): the same
   engine on fsdp=2,tensor=2, pipe=2,tensor=2 and seq=2,tensor=2
   (bench-1b) and expert=2,tensor=2 (moe-8x1b), each mesh's slot and
   paged runs in turn with 18f's traffic (8 of its 24 requests, as
   18f's MoE run): the same answer, stream,
   lone-request, digest, engine-state, block-account and pool checks
   (the pools equal on the ranks of one layer block and head shard), K4
   calls = the layers the rank holds x chunk_steps x dispatches at its
   shard (B=8 on fsdp, B=16 elsewhere, Hq 8 Hkv 4), and every rank's
   weights exactly its slices (its layers, embed columns, heads and
   experts) and their bytes; tok/s, host ms a step, collectives a step,
   peak memory, weight and cache bytes a rank by run.
19. Sharded training, every rank a process on the one card, gloo staged
   through the host. 19a: the multislice-train recipe (``python -m
   skypilot_tpu_torch.train.run --model bench-1b --global-batch-size 32
   --seq-len 2048 --mesh data=2,fsdp=2``, 3 steps, warmup 1) as two hosts of two
   ranks under the gang launcher's env (``MEGASCALE_NUM_SLICES`` 2), then
   the same global batch on one rank in this process: each
   step's loss within 2e-2 and grad_norm within 1e-2, the gang's final
   weights (its checkpoint) within 1e-2 in relative L2 and their updates
   within 0.5, limits that a batch of 16 on one rank (a lost data shard)
   must exceed; every rank's grad_norm bits equal, K1/K2/K3 = 2L/L/L a
   step on every rank, a rank's weight bytes half the whole plus the
   norms. 19b: the lora-finetune recipe on ``--mesh fsdp=2`` (two ranks):
   2 steps saved, resumed to 4, against 4 uninterrupted: every array of
   step 4 equal bit for bit, the losses too, the base = the initial
   weights. 19a and 19b run side by side. 19c (beside 19d): the small
   fp32 model of phase 5 in one gang of eight ranks on JAX's programs A
   (``data=2,fsdp=2,tensor=2``), B (MoE, 4 experts top-2, 2 pipeline
   stages of 2 microbatches, on ``pipe=2,expert=2,tensor=2``), C
   (``data=2,seq=2,tensor=2``, ring attention) and B4 (B with 4 layers in
   4 stages, two a pipe rank), two steps each on the card and on the CPU
   over the same process group: losses and params within 1e-4 on every
   rank, K1-K3 8 / 4 / 4 a rank for A and B (B: one layer a stage, two
   microbatches), 16 / 8 / 8 for B4 and none for C (ring attention is an
   einsum). 19d: the moe-finetune
   recipe (``--model moe-8x1b --mesh fsdp=2,expert=8 --global-batch-size
   16``, cut to ``fsdp=2,expert=2``, batch 4, seq 2048, 3 steps, warmup
   1, saves at 2 and 3) as four ranks, and beside it the same batch on
   one rank: loss and moe_aux within 2e-2, grad_norm within 1e-2, the
   weights within 1e-2 and their updates within 0.5, limits one rank on
   2 rows must exceed; every rank's metric bits equal, K1/K2/K3 2L/L/L a
   step a rank, a rank's weight bytes its quarter of the experts and half
   of the rest; the router and every expert of every layer moved; then a
   relaunch resumed from step 2 writes a step 3 equal to the
   uninterrupted one bit for bit. 19e (after 19d, beside 19c): bench-1b at
   ``STAGE_LAYERS`` (4) layers in 4 pipeline stages of 4 microbatches
   through ``train.run --mesh pipe=2,fsdp=1`` (two stages a rank, global
   batch 8, seq 2048, 2 steps), then the same batch on one rank: 19a's
   limits, K1-K3 2 x 8 / 8 / 8 a step a rank; then, its gang run beside
   the first, ``UNEVEN_LAYERS`` (6) layers in ``UNEVEN_STAGES`` (3)
   stages, which pipe=2 does not divide (rank 0 runs layers 0-3 and
   holds 0-2, rank 1 runs 4-5 of its 3-5): the same checks, K1-K3 2 x 16
   / 16 / 16 and 2 x 8 / 8 / 8 a step by rank, and one exchange each way
   a step: one bench-1b layer (113,254,400 B) from rank 1 to rank 0,
   its gradient back, and no all-gather or reduce-scatter. Prints each
   rank's step ms, collectives a step (calls, bytes, host s by kind),
   weight bytes and peak memory. K1-K3 at a rank's rows of 19a (B=8,
   S=2048) are timed in phase 3; 19d's ranks run train-moe's shape (B=2,
   ``MOE_CASE``).
20. Summary: the card's name and power limit again, one JSON line of
   kernels (K1-K3's launches are phases 6, 10, 12, 14, 19a, 19b, 19c's
   programs A, B and B4, 19d and 19e (every rank's; 19c's program C
   launches none), K4's phase
   8's, 13's, 14's, 15's, 16's, 17a's and 18a's, 18c's, 18d's, 18e's,
   18f's and 18g's (by run) for the bf16 cache,
   phases 8's, 9's, 11's, 14's, 17b's and 18b's for the int8 cache, each
   path's count in ``launches_by_path``, 18's summed over the ranks;
   K4's times are the engine-shape case of phase 2, K1-K3's the
   train-s4096 shape, each named in ``timed_at``, with the
   llama-finetune, lora-finetune, train-moe and one 19a rank's shapes
   (K1-K3) and the serve-llama, draft, serve-disagg and per-rank tp 2, 8
   and 4 shapes, the draft's tp 2 shard and the data block's (K4) under
   ``by_shape``),
   then the last line ``{"ok":
   true, "device": {...}}``.

It exits with an error, printing no result, when CUDA is absent or when
the ``skypilot_tpu_torch`` package is not beside it.

``python3 chip_smoke.py --nccl`` runs, on a machine with four cards, phase
18's checks over NCCL with one rank a card: K4 at the tp 4 shards (Hkv 2)
against its plain version, bench-1b at ``--tp 4`` on one host, and the
serve-multihost recipe at ``--tp 4`` as two hosts of two cards each
(``CUDA_VISIBLE_DEVICES`` splits them, as two machines would), then 19a's
checks for the multislice-train recipe as two hosts of two cards, a rank
a card, nothing staged through the host; then 19d's checks for the
moe-finetune recipe at all 18 layers on ``fsdp=2,expert=2`` as two hosts
of two cards (no checkpoint: ``fsdp`` crosses the hosts, whose views of
a leaf split over it are not whole), 19c's programs B and B4 over NCCL
on ``pipe=2,expert=2`` (four ranks, one host), held to one process on
the rank's card, 19e's checks (both gangs) on two cards and 18f's on
four (data=2, tensor=2, a card a rank); then 18c at ``--tp 4`` on one
host (the KV tiers' and handoffs' gathers and scatters to the head on
the model's NCCL groups beside the gloo arrival broadcast); last, 18g's
on four cards (moe-8x1b on expert=4 at all 18 layers, whose lone answer
must equal a one-device engine's token for token, and bench-1b on
pipe=2,tensor=2).
"""
import collections
import concurrent.futures
import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import unittest.mock
import urllib.error
import urllib.request

import numpy as np
import torch

from skypilot_tpu_torch.ops import flash_schedule
from skypilot_tpu_torch.utils.device import H100_BF16_DENSE_FLOPS

H100_BYTES_PER_S = 3.35e12        # HBM3, SXM data sheet
H100_OPS_PER_S = {torch.bfloat16: H100_BF16_DENSE_FLOPS,
                  torch.float32: 67e12}     # fp32 outside tensor cores
# K1-K3: largest ||got - want|| / ||want|| allowed on any 64-row tile, for
# (o, grads); about 4x the largest that sound kernels read on an H100 (bf16
# o 2.4e-3, dq 2.7e-4, dk 1.3e-4, dv 8.6e-5; fp32 4.2e-7).
REL_TOL = {torch.bfloat16: (1e-2, 1e-3), torch.float32: (2e-6, 2e-6)}
# K4 in bf16: largest ||got - want|| / ||want|| allowed of any (row, head)
# against the split plain version at the kernel's chunk; about 4x the
# largest that a sound kernel reads on an H100 (5.0e-3, mostly the output's
# bf16 rounding).
SPLIT_REL_TOL = 2e-2
L2_BYTES = 50 * 2 ** 20
MODES = {'bf16': ('skypilot_tpu/ops/decode_attention.py:147', False),
         'int8': ('skypilot_tpu/ops/decode_attention.py:162', True)}
CSRC = 'skypilot_tpu_torch/csrc/'
ENGINE_CASE = 'engine B=16 M=1024'  # K4 at the engine's shape
LLAMA_CASE = 'llama3-1b B=16 M=2048 D=64'  # K4 at the serve-llama recipe's
DRAFT_CASE = 'bench-draft B=16 M=1024 D=64'  # K4 at the serve-spec draft's
DISAGG_CASE = 'bench-1b B=16 M=2048 D=128'  # K4 at serve-disagg's decode batch
# K4 per head shard (phase 18): bench-1b at tp 2, llama3-8b at tp 8.
TP2_CASE = 'bench-1b tp2 B=16 Hq=8 Hkv=4 M=1024'
TP8_CASE = 'llama3-8b tp8 B=16 Hq=4 Hkv=1 M=2048'
# ... and at tp 4 (``--nccl``'s shards, timed here on the one card).
TP4_BENCH_CASE = 'bench-1b tp4 B=16 Hq=4 Hkv=2 M=1024'
TP4_RECIPE_CASE = 'llama3-8b tp4 B=16 Hq=8 Hkv=2 M=2048'
# ... and the draft's shard under tp 2 (phase 18d: bench-draft, group 1).
DRAFT_TP2_CASE = 'bench-draft tp2 B=16 Hq=4 Hkv=4 M=1024 D=64'
# ... and one rank's block of the slots on data=2,tensor=2 (phase 18f:
# bench-1b, 8 of the 16 slots, half the heads).
DP_CASE = 'bench-1b data2 tp2 B=8 Hq=8 Hkv=4 M=1024'
TRAIN_CASE = 'train B=2 S=4096'  # K1-K3 at train-s4096 (BENCH_1B)
FINETUNE_CASE = 'llama3-1b B=8 S=2048'  # K1-K3 at llama-finetune's shape
LORA_CASE = 'bench-1b B=16 S=2048'  # K1-K3 at the lora-finetune recipe's
MOE_CASE = 'moe-8x1b B=2 S=2048'  # K1-K3 at train-moe's shape (phase 14d)
# K1-K3 at one rank's rows of train-multislice (phase 19a: 32 rows over
# data=2,fsdp=2).
SHARD_CASE = 'bench-1b rank B=8 S=2048'
# K2's and K3's work lists over several L2 sections, GQA group 4 (phase 3).
WALK_CASE = 'walk G=4 B=3 S=3000'
# The int8 ``mm`` on the card against the CPU's. Float32 sums taken in
# another order differ by up to ~1e-6 of the output's scale: that moves a
# rounded bf16 output across a rounding boundary now and then (one ulp),
# and a value near zero, whose ulp is tiny, by several of its ulps. So
# each bf16 output is held to one ulp plus MM_F32_REL_TOL of the largest
# |output|, and at most MM_BF16_DIFF_SHARE of them may differ at all;
# float32 outputs (logits) to MM_F32_REL_TOL of the largest |logit|.
MM_BF16_DIFF_SHARE = 1e-2
MM_F32_REL_TOL = 1e-5
# The serve-llama recipe (examples/llm/serve-llama/serve.yaml) on the port.
RECIPE = dict(max_len=2048, quantize='int8', kv_cache='int8')
# Phases 9 and 11 serve llama3-1b at full width and RECIPE_LAYERS of its 16
# layers, so that the whole script stays well inside its time limit;
# phase 10 trains it at FINETUNE_LAYERS.
RECIPE_LAYERS = 4
FINETUNE_LAYERS = 4
# Phases 7-8, 12-14 and 16a-16b, 18a, 18c-18e and 19a-19b run bench-1b
# and moe-8x1b at SERVE_LAYERS of their 18 layers, widths untouched, to
# make room for phases 18-19 inside the script's time limit.
SERVE_LAYERS = 4
# A greedy engine stream may part from a direct generate() only where the
# direct path's two largest logits were closer than this: the engine's
# prefill group and 16-slot decode batch are other GEMM shapes, and bf16
# sums in another order move a logit by a few hundredths.
GREEDY_GAP_LIMIT = 0.1
FLASH = {  # K1-K3: wrapper name -> (TPU kernel, launch counter, source)
    'flash_fwd': ('skypilot_tpu/ops/attention.py:106', 'fwd_launches',
                  CSRC + 'flash_attention_sm90.cuh'),
    'flash_bwd_dq': ('skypilot_tpu/ops/attention.py:206',
                     'bwd_dq_launches', CSRC + 'flash_attention_sm90.cuh'),
    'flash_bwd_dkv': ('skypilot_tpu/ops/attention.py:257',
                      'bwd_dkv_launches', CSRC + 'flash_attention_sm90.cuh')}
# The wgmma + TMA bodies of K1, K2 and K3 (D 64 and 128, causal or not each).
SM90_BODIES = ('flash_fwd_sm90_kernel', 'flash_bwd_dq_sm90_kernel',
               'flash_bwd_dkv_sm90_kernel')


def _card() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


_T0 = time.perf_counter()


def _share_bytecode() -> None:
    """One bytecode cache for this script's processes, removed at exit.
    Each rank, replica and probe it starts imports torch, and where the
    interpreter cannot keep bytecode beside torch's sources each process
    compiles them again: on the card's machine a fresh process's first
    training step spent ~9 s compiling ``torch._dynamo``, which torch's
    non-reentrant checkpoint imports (a cProfile of that step: PERF.md
    section 6)."""
    import atexit
    cache = tempfile.mkdtemp(prefix='skytpu-pycache-')
    atexit.register(shutil.rmtree, cache, True)
    os.environ['PYTHONPYCACHEPREFIX'] = sys.pycache_prefix = cache
    os.environ.pop('PYTHONDONTWRITEBYTECODE', None)
    sys.dont_write_bytecode = False


def _phase(title: str) -> None:
    """Print a phase's title with the seconds since the script started."""
    print(f'{title} (at {time.perf_counter() - _T0:.1f} s)', flush=True)


def _time_ms(fn, iters: int) -> float:
    """Mean ms per call from CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 2: the kernel against its plain version ------------------------------


def _make_case(gen, b, hq, hkv, d, m, lengths, dtype, quant):
    dev = 'cuda'
    q = torch.randn(b, hq, d, generator=gen, device=dev).to(dtype)
    kf = torch.randn(b, hkv, m, d, generator=gen, device=dev)
    vf = torch.randn(b, hkv, m, d, generator=gen, device=dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    if not quant:
        return [q, kf.to(dtype), vf.to(dtype), lens, None, None]
    k_s = torch.clamp_min(kf.abs().amax(-1) / 127.0, 1e-8)
    v_s = torch.clamp_min(vf.abs().amax(-1) / 127.0, 1e-8)
    k8 = torch.clamp(torch.round(kf / k_s[..., None]), -127, 127)
    v8 = torch.clamp(torch.round(vf / v_s[..., None]), -127, 127)
    return [q, k8.to(torch.int8), v8.to(torch.int8), lens, k_s, v_s]


def _bound(args):
    """Least time for the work this call needs: each input byte it must
    read (K/V and scales up to each row's length; an empty row reads all
    M) and each output byte written once, over HBM bandwidth; or its
    flops over the peak rate for q's type; whichever is larger."""
    q, k, v, lens, k_s, _ = args
    b, hq, d = q.shape
    hkv, m = k.shape[1], k.shape[2]
    span = [x if x > 0 else m for x in (min(int(y), m) for y in lens.tolist())]
    pos = sum(span) * hkv
    nbytes = (2 * q.numel() * q.element_size() + lens.numel() * 4
              + 2 * pos * d * k.element_size()
              + (2 * pos * 4 if k_s is not None else 0))
    ops = 4 * pos * (hq // hkv) * d
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_OPS_PER_S[q.dtype] * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def _row_head_rel(got, want):
    """Largest ||got - want|| / ||want|| over D, of any (row, head)."""
    got, want = got.float(), want.float()
    return float(((got - want).norm(dim=-1)
                  / want.norm(dim=-1).clamp_min(1e-30)).max())


def _copies(args):
    """Enough copies of the inputs to exceed L2, so that timed launches
    read device memory the way a decode step (which streams every layer's
    cache and all weights between two reads of one layer) finds it."""
    nbytes = sum(t.numel() * t.element_size() for t in args
                 if t is not None)
    n = max(1, -(-2 * L2_BYTES // nbytes))
    return [args] + [[None if t is None else t.clone() for t in args]
                     for _ in range(n - 1)]


def _sdpa_ms(args, iters):
    """One PyTorch call computing the same function (bf16 cache only):
    scaled_dot_product_attention with GQA and a length mask."""
    q, k, v, lens, _, _ = args
    m = k.shape[2]
    mask = (torch.arange(m, device='cuda')[None, :]
            < torch.clamp_min(lens, 1)[:, None].long())[:, None, None, :]
    sets = [(q[:, :, None], a[1], a[2]) for a in _copies(args)]
    it = itertools.count()

    def call():
        qq, kk, vv = sets[next(it) % len(sets)]
        torch.nn.functional.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mask, enable_gqa=True)
    return _time_ms(call, iters)


def kernel_phase(da):
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    rng = np.random.default_rng(0)
    mixed = rng.integers(1, 1025, 32).tolist()
    mixed[:3] = [1024, 1, 33]  # full, one position, a mid-tile end

    def edges(b, m):  # lengths at the edges of the split of the cache
        c = da.decode_split(b, 8, m)[1]
        return ([c - 1, c, c + 1, 1, 0, m, 2 * c + 1]
                + rng.integers(1, m + 1, b - 7).tolist())
    shapes = [  # (label, b, hq, hkv, d, m, lengths)
        ('B=32 M=1024', 32, 16, 8, 128, 1024, mixed),
        ('B=1 M=1024', 1, 16, 8, 128, 1024, [700]),
        ('B=4 M=1000', 4, 16, 8, 128, 1000, [1000, 999, 517, 0]),
        ('B=8 M=1024 D=64', 8, 32, 8, 64, 1024,
         rng.integers(1, 1025, 8).tolist()),
        ('edges B=7 M=1024', 7, 16, 8, 128, 1024, edges(7, 1024)),
        ('edges B=32 M=1024', 32, 16, 8, 128, 1024, edges(32, 1024)),
        ('M=48 G=1', 3, 8, 8, 64, 48, [48, 0, 17]),
        ('M=256 G=3', 2, 24, 8, 128, 256, [200, 5]),
        # The engine's decode batch: 16 slots over max_len 1024, free
        # slots at length 0 and junk rows whose lengths ran past M.
        (ENGINE_CASE, 16, 16, 8, 128, 1024,
         [0, 1, 1024, 1025, 1500, 4096, 2 ** 20]
         + rng.integers(1, 1025, 9).tolist()),
        # The serve-llama recipe's decode batch: llama3-1b's heads over
        # max_len 2048.
        (LLAMA_CASE, 16, 32, 8, 64, 2048,
         [0, 1, 2048, 2049, 3000, 8192, 2 ** 20]
         + rng.integers(1, 2049, 9).tolist()),
        # The draft's decode batch in the speculative engine (serve-spec):
        # bench-draft's heads (group 1, D 64) over max_len 1024.
        (DRAFT_CASE, 16, 8, 8, 64, 1024,
         [0, 1, 1024, 1025, 1500, 4096, 2 ** 20]
         + rng.integers(1, 1025, 9).tolist()),
        # The decode replica's batch in serve-disagg (phase 17a): bench-1b
        # over max_len 2048.
        (DISAGG_CASE, 16, 16, 8, 128, 2048,
         [0, 1, 2048, 2049, 3000, 8192, 2 ** 20]
         + rng.integers(1, 2049, 9).tolist()),
        # One rank's decode batch under tensor parallelism (phase 18): its
        # shard of the heads, the kernel launched per head shard.
        (TP2_CASE, 16, 8, 4, 128, 1024,
         [0, 1, 1024, 1025, 1500, 4096, 2 ** 20]
         + rng.integers(1, 1025, 9).tolist()),
        (TP8_CASE, 16, 4, 1, 128, 2048,
         [0, 1, 2048, 2049, 3000, 8192, 2 ** 20]
         + rng.integers(1, 2049, 9).tolist()),
        (TP4_BENCH_CASE, 16, 4, 2, 128, 1024,
         [0, 1, 1024, 1025, 1500, 4096, 2 ** 20]
         + rng.integers(1, 1025, 9).tolist()),
        (TP4_RECIPE_CASE, 16, 8, 2, 128, 2048,
         [0, 1, 2048, 2049, 3000, 8192, 2 ** 20]
         + rng.integers(1, 2049, 9).tolist()),
        # The draft's decode batch on one rank of the speculative replica
        # at tp 2 (phase 18d): bench-draft's heads halved, group 1.
        (DRAFT_TP2_CASE, 16, 4, 4, 64, 1024,
         [0, 1, 1024, 1025, 1500, 4096, 2 ** 20]
         + rng.integers(1, 1025, 9).tolist()),
        # One rank's block of the slots on data=2,tensor=2 (phase 18f):
        # 8 of bench-1b's 16 slots, half its heads.
        (DP_CASE, 8, 8, 4, 128, 1024,
         [0, 1, 1024, 1025, 2 ** 20] + rng.integers(1, 1025, 3).tolist()),
    ]
    results = {mode: {'max_abs_err': 0.0, 'cases': []} for mode in MODES}
    for mode, (_, quant) in MODES.items():
        for label, b, hq, hkv, d, m, lengths in shapes:
            for dtype in (torch.bfloat16, torch.float32):
                args = _make_case(gen, b, hq, hkv, d, m, lengths, dtype,
                                  quant)
                out = da.flash_decode(*args)
                torch.cuda.synchronize()
                ref = da.flash_decode_reference(*args)
                tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
                err = float((out.float() - ref.float()).abs().max())
                if not torch.allclose(out.float(), ref.float(), atol=tol,
                                      rtol=tol):
                    raise AssertionError(
                        f'flash_decode {mode} {label} {dtype}: max abs err '
                        f'{err} beyond {tol}')
                results[mode]['max_abs_err'] = max(
                    results[mode]['max_abs_err'], err)
                row = {'case': label, 'dtype': str(dtype).split('.')[-1],
                       'max_abs_err': err, 'tol': tol,
                       'split': da.decode_split(b, hkv, m)}
                # The kernel's own order of work: fp32 to 1e-5; bf16 (the
                # output rounded to bf16) per (row, head) to SPLIT_REL_TOL.
                split = da.flash_decode_split_reference(
                    *args, chunk=row['split'][1])
                if dtype == torch.float32:
                    row['split_err'] = float((out - split).abs().max())
                    if not torch.allclose(out, split, atol=1e-5, rtol=1e-5):
                        raise AssertionError(
                            f'flash_decode {mode} {label}: max abs err '
                            f'{row["split_err"]} against the split plain '
                            'version beyond 1e-5')
                else:
                    row['split_rel'] = _row_head_rel(out, split)
                    if not row['split_rel'] <= SPLIT_REL_TOL:
                        raise AssertionError(
                            f'flash_decode {mode} {label} bf16: '
                            f'||got - want|| / ||want|| of a (row, head) '
                            f'{row["split_rel"]} against the split plain '
                            f'version beyond {SPLIT_REL_TOL}')
                if dtype == torch.bfloat16:  # the serving type: time it
                    sets = _copies(args)
                    it = itertools.count()
                    row['ms'] = _time_ms(
                        lambda: da.flash_decode(
                            *sets[next(it) % len(sets)]), 200)
                    row['plain_ms'] = _time_ms(
                        lambda: da.flash_decode_reference(*args), 20)
                    row['library_ms'] = (None if quant
                                         else _sdpa_ms(args, 100))
                    row['bound_ms'], row['bound_by'] = _bound(args)
                results[mode]['cases'].append(row)
                print(f'  {mode:4s} {label:16s} {row["dtype"]:8s} '
                      + ' '.join(f'{k}={v}' for k, v in row.items()
                                 if k not in ('case', 'dtype')), flush=True)
    for mode in MODES:
        for key, case in (('head', ENGINE_CASE), ('llama', LLAMA_CASE),
                          ('draft', DRAFT_CASE), ('disagg', DISAGG_CASE),
                          ('tp2', TP2_CASE), ('tp8', TP8_CASE),
                          ('tp4a', TP4_BENCH_CASE),
                          ('tp4b', TP4_RECIPE_CASE),
                          ('draft_tp2', DRAFT_TP2_CASE), ('dp', DP_CASE)):
            results[mode][key] = next(c for c in results[mode]['cases']
                                      if c['case'] == case
                                      and c['dtype'] == 'bfloat16')
    return results


# -- phase 3: K1-K3 against their plain versions ----------------------------------


def _attn_case(gen, b, hq, hkv, s, d, dtype):
    def r(*shape):
        return torch.randn(*shape, generator=gen, device='cuda').to(dtype)
    return r(b, hq, s, d), r(b, hkv, s, d), r(b, hkv, s, d), r(b, hq, s, d)


def _attn_flops(q, causal, n_matmuls):
    """Flops of n_matmuls products over the (query, key) pairs; causal
    counts the pairs of the lower triangle only."""
    b, hq, s, d = q.shape
    pairs = s * (s + 1) // 2 if causal else s * s
    return 2 * n_matmuls * d * pairs * b * hq


def _attn_bound(q, k, causal, n_matmuls, nbytes):
    """max(flops / peak for q's type, bytes / HBM rate), in ms."""
    t_ops = _attn_flops(q, causal, n_matmuls) / H100_OPS_PER_S[q.dtype]
    t_bytes = nbytes / H100_BYTES_PER_S
    return ((t_ops * 1e3, 'operations') if t_ops >= t_bytes
            else (t_bytes * 1e3, 'bytes'))


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _tile_rel_err(got, want, tile=64):
    """Largest ||got - want|| / ||want|| over tiles of ``tile`` rows
    along S (dim -2; every batch and head of the tile together), so that a
    fault confined to a few tiles, such as late rows, shows at full size."""
    def per_tile(x):
        sq = (x.double() ** 2).transpose(-2, 0).reshape(x.shape[-2], -1)
        sq = torch.nn.functional.pad(sq.sum(1), (0, -x.shape[-2] % tile))
        return sq.reshape(-1, tile).sum(1).sqrt()
    return float((per_tile(got - want) / per_tile(want)).max())


def attention_phase(fa):
    gen = torch.Generator(device='cuda')
    gen.manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (label, b, hq, hkv, s, d, dtype, causal)
        (TRAIN_CASE, 2, 16, 8, 4096, 128, bf16, True),
        ('B=1 S=4096', 1, 16, 8, 4096, 128, bf16, True),
        ('full S=2048', 1, 16, 8, 2048, 128, bf16, False),
        ('ragged S=1000', 1, 16, 8, 1000, 128, bf16, True),
        ('D=64 G=4 S=1024', 1, 32, 8, 1024, 64, bf16, True),
        ('G=4 full S=65', 2, 4, 1, 65, 128, bf16, False),
        ('fp32 S=1000', 1, 16, 8, 1000, 128, f32, True),
        ('fp32 full S=517', 2, 8, 2, 517, 64, f32, False),
        ('S=4032', 1, 16, 8, 4032, 128, bf16, True),
        ('S=129', 1, 16, 8, 129, 128, bf16, True),
        ('S=1', 1, 16, 8, 1, 128, bf16, True),
        ('D=64 G=2 S=4096', 1, 16, 8, 4096, 64, bf16, True),
        (FINETUNE_CASE, 8, 32, 8, 2048, 64, bf16, True),
        (LORA_CASE, 16, 16, 8, 2048, 128, bf16, True),
        (MOE_CASE, 2, 16, 8, 2048, 128, bf16, True),
        (SHARD_CASE, 8, 16, 8, 2048, 128, bf16, True),
        ('walk D=64 B=3 S=1000', 3, 12, 4, 1000, 64, bf16, True),
        ('walk B=5 S=1537', 5, 16, 8, 1537, 128, bf16, True),
        ('D=64 full S=1000', 2, 8, 2, 1000, 64, bf16, False),
        # K2's and K3's lists over several L2 sections, the last partial
        # (K2: 96 heads in sections of 84; K3: 24 kv heads in sections of
        # 5), GQA group 4 at D=128.
        (WALK_CASE, 3, 32, 8, 3000, 128, bf16, True),
    ]
    # K2 and K3 run twice on these and must give the same bits: blocks
    # take work tiles from a counter in any order, but each tile is
    # computed by one block in a fixed order.
    twice = {'walk D=64 B=3 S=1000', 'walk B=5 S=1537', WALK_CASE,
             LORA_CASE}
    worst = {name: 0.0 for name in FLASH}
    timed = {TRAIN_CASE: {}, FINETUNE_CASE: {}, LORA_CASE: {},
             MOE_CASE: {}, SHARD_CASE: {}}
    for label, b, hq, hkv, s, d, dtype, causal in cases:
        q, k, v, do = _attn_case(gen, b, hq, hkv, s, d, dtype)
        o, lse = fa.flash_fwd(q, k, v, causal)
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        if label in twice:
            dq2 = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
            dk2, dv2 = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
            torch.cuda.synchronize()
            for name, a, b2 in (('dq', dq, dq2), ('dk', dk, dk2),
                                ('dv', dv, dv2)):
                if not torch.equal(a, b2):
                    raise AssertionError(
                        f'{label}: two runs of {name} differ by '
                        f'{float((a.float() - b2.float()).abs().max())}')
            del dq2, dk2, dv2
        ro, rlse = fa.flash_fwd_reference(q, k, v, causal)
        rdq = fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
        rdk, rdv = fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                              causal)
        fwd_tol, grad_tol = (2e-2, 5e-2) if dtype == bf16 else (1e-4, 1e-3)
        errs, rels = {}, {}
        for name, got, want, tol in (
                ('o', o, ro, fwd_tol), ('lse', lse, rlse, 1e-3),
                ('dq', dq, rdq, grad_tol), ('dk', dk, rdk, grad_tol),
                ('dv', dv, rdv, grad_tol)):
            got, want = got.float(), want.float()
            err = float((got - want).abs().max())
            if not (torch.isfinite(got).all()
                    and torch.allclose(got, want, atol=tol, rtol=tol)):
                raise AssertionError(f'{label} {dtype}: {name} max abs err '
                                     f'{err} beyond {tol}')
            # One key: the softmax's gradient is exactly zero and both sides
            # hold rounding noise, which only the absolute limit bounds.
            zero_grad = s == 1 and name in ('dq', 'dk')
            if float(want.abs().max()) == 0.0 and not zero_grad:
                raise AssertionError(f'{label}: {name} is all zero')
            errs[name] = err
            if zero_grad:
                continue
            if name != 'lse':  # lse ~ log S: the abs limit is relative
                rel_tol = REL_TOL[dtype][name != 'o']
                rels[name] = _tile_rel_err(got, want)
                if not rels[name] <= rel_tol:
                    raise AssertionError(
                        f'{label} {dtype}: {name} tile relative err '
                        f'{rels[name]} beyond {rel_tol}')
        worst['flash_fwd'] = max(worst['flash_fwd'], errs['o'], errs['lse'])
        worst['flash_bwd_dq'] = max(worst['flash_bwd_dq'], errs['dq'])
        worst['flash_bwd_dkv'] = max(worst['flash_bwd_dkv'], errs['dk'],
                                     errs['dv'])
        grid = ''
        if dtype == bf16:
            got_plan = {kern: fa.plan(kern, d, b, hq, hkv, s)
                        for kern in flash_schedule.KERNELS}
            for kern, got in got_plan.items():
                want = flash_schedule.plan(kern, d, b, hq, hkv, s, got[1])
                if got != want:
                    raise AssertionError(f'{label}: {kern} launches {got}, '
                                         f'ops/flash_schedule says {want}')
            grid = ('grids K1/K2/K3=' + '/'.join(
                str(got_plan[kern][0]) for kern in flash_schedule.KERNELS)
                + f' SMs={got_plan["fwd"][1]} '
                + ('same-bits-twice ' if label in twice else ''))
        print(f'  {label:18s} {str(dtype).split(".")[-1]:8s} causal={causal} '
              + grid
              + ' '.join(f'{k}_err={v:.3g}' for k, v in errs.items())
              + ' ' + ' '.join(f'{k}_tile_rel={v:.3g}'
                               for k, v in rels.items()), flush=True)
        if label not in timed:
            continue
        # The training shapes: time each kernel, its plain version, the
        # library call and the bound.
        head = timed[label]
        calls = {
            'flash_fwd': (lambda: fa.flash_fwd(q, k, v, causal),
                          lambda: fa.flash_fwd_reference(q, k, v, causal),
                          2, _nbytes(q, k, v, o, lse)),
            'flash_bwd_dq': (
                lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal),
                lambda: fa.flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                                  causal),
                3, _nbytes(q, k, v, do, lse, delta, dq)),
            'flash_bwd_dkv': (
                lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal),
                lambda: fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                   causal),
                4, _nbytes(q, k, v, do, lse, delta, dk, dv)),
        }
        sdpa = _sdpa_train_ms(q, k, v, do, causal)
        for name, (kernel, plain, n_mm, nbytes) in calls.items():
            bound, by = _attn_bound(q, k, causal, n_mm, nbytes)
            head[name] = {
                'ms': _time_ms(kernel, 10), 'plain_ms': _time_ms(plain, 2),
                'library_ms': sdpa['fwd' if name == 'flash_fwd' else 'bwd'],
                'bound_ms': bound, 'bound_by': by}
            tflops = _attn_flops(q, causal, n_mm) / head[name]['ms'] / 1e9
            print(f'    {name}: ' + ' '.join(
                f'{k}={v}' for k, v in head[name].items())
                + f' tflops={tflops:.1f} bound_share='
                f'{bound / head[name]["ms"]:.1%}', flush=True)
        # SDPA's work: 2 products forward; 5 backward (S and dP again,
        # dV, dK, dQ).
        print(f'    sdpa: fwd {sdpa["fwd"]} ms '
              f'{_attn_flops(q, causal, 2) / sdpa["fwd"] / 1e9:.1f} TFLOP/s,'
              f' bwd {sdpa["bwd"]} ms '
              f'{_attn_flops(q, causal, 5) / sdpa["bwd"] / 1e9:.1f} TFLOP/s',
              flush=True)
        del calls
    return {name: dict(timed[TRAIN_CASE][name], max_abs_err=worst[name],
                       timed_at=TRAIN_CASE,
                       by_shape={FINETUNE_CASE: timed[FINETUNE_CASE][name],
                                 LORA_CASE: timed[LORA_CASE][name],
                                 MOE_CASE: timed[MOE_CASE][name],
                                 SHARD_CASE: timed[SHARD_CASE][name]})
            for name in FLASH}


def check_sm90_bodies(fa):
    """Every instance of the K1, K2 and K3 bodies for bf16 must run wgmma
    (HGMMA) on TMA loads (UTMALDG), and ptxas must report no spill bytes
    for it."""
    report = fa.compiler_report().splitlines()
    spills = {}
    for line, nxt in zip(report, report[1:] + ['']):
        m = re.search(r'Function properties for (\S+)', line)
        n = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      nxt)
        if m and n:
            spills[m.group(1)] = int(n.group(1)) + int(n.group(2))
    functions = {chunk.split()[0]: chunk
                 for chunk in fa.sass().split('Function : ')[1:]}
    for body in SM90_BODIES:  # 3 bodies x 4 instances
        names = sorted(f for f in functions if body in f)
        by_dim = [sum(f'ILi{d}E' in f for f in names) for d in (64, 128)]
        if len(names) != 4 or by_dim != [2, 2]:
            raise AssertionError(f'{body}: {len(names)} instances in the '
                                 f'SASS ({by_dim} at D 64/128), expected 4 '
                                 '(D 64/128, causal or not)')
        for name in names:
            missing = [op for op in ('HGMMA', 'UTMALDG')
                       if op not in functions[name]]
            if missing or spills.get(name) != 0:
                raise AssertionError(f'{name}: missing {missing} in SASS, '
                                     f'spill bytes {spills.get(name)}')
        print(f'  {body}: {len(names)} instances ({by_dim[0]} at D=64, '
              f'{by_dim[1]} at D=128), each with HGMMA and UTMALDG in its '
              'SASS and 0 spill bytes', flush=True)


def _sdpa_train_ms(q, k, v, do, causal):
    """One PyTorch call computing the same function: SDPA forward, and
    SDPA's backward (dq, dk, dv together)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd = _time_ms(lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True),
                   10)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = sdpa(*leaves, is_causal=causal, enable_gqa=True)
    bwd = _time_ms(lambda: torch.autograd.grad(out, leaves, do,
                                               retain_graph=True), 10)
    return {'fwd': fwd, 'bwd': bwd}


# -- phase 4: serving a small model, card against CPU --------------------------------


def small_model_phase(llama, gen_lib):
    cfg = dataclasses.replace(llama.TINY, d_model=128, n_heads=4,
                              n_kv_heads=2, head_dim=64, dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
    on_card = _tree_to(params, 'cuda')
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 12)
                                           ).astype(np.int32))
    row_lens = torch.tensor([12, 5, 9], dtype=torch.int32)
    worst = 0.0
    for kv_quant in (False, True):
        caches = {dev: gen_lib.init_cache(cfg, 3, 32, quantize=kv_quant,
                                          device=dev)
                  for dev in ('cpu', 'cuda')}
        toks, lens = tokens, row_lens
        for _ in range(8):
            logits = {}
            for dev, p in (('cpu', params), ('cuda', on_card)):
                logits[dev], caches[dev] = gen_lib.forward_cached(
                    p, toks.to(dev), caches[dev], cfg, lens.to(dev))
            err = float((logits['cuda'].cpu() - logits['cpu']).abs().max())
            worst = max(worst, err)
            if not err <= 1e-3:
                raise AssertionError(f'small model logits: card vs CPU '
                                     f'max abs err {err} > 1e-3')
            toks = torch.argmax(logits['cpu'], -1).to(torch.int32)[:, None]
            lens = torch.ones(3, dtype=torch.int32)
    print(f'  small model (d_model 128, head_dim 64, fp32), prefill + 7 '
          f'decode steps, full and int8 KV: max abs logit err card vs CPU '
          f'{worst} (limit 1e-3)', flush=True)


def small_engine_phase(llama, engine_lib):
    """The continuous engine on the small fp32 model, on the card and on
    the CPU from the same weights: greedy tokens equal, token for token,
    with more requests than slots (slots are reused) and max_len 48, so
    the free slots' junk rows run past max_len on both."""
    cfg = dataclasses.replace(llama.TINY, d_model=128, n_heads=4,
                              n_kv_heads=2, head_dim=64, dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
    rng = np.random.default_rng(4)
    rows = [rng.integers(0, cfg.vocab_size, n).tolist()
            for n in (3, 17, 9, 30, 5, 12, 21)]
    out = {}
    for dev, p in (('cpu', params), ('cuda', _tree_to(params, 'cuda'))):
        for kv_quant in (False, True):
            eng = engine_lib.ContinuousEngine(
                p, cfg, slots=4, max_len=48, chunk_steps=4,
                kv_quantize=kv_quant, device=dev)
            try:
                futs = [eng.submit(r, 16) for r in rows]
                out[dev, kv_quant] = [f.result(timeout=300) for f in futs]
                lengths = eng._cache.lengths.cpu().tolist()  # noqa: SLF001
            finally:
                eng.stop()
    for kv_quant in (False, True):
        if out['cuda', kv_quant] != out['cpu', kv_quant]:
            raise AssertionError(f'small engine (int8 KV {kv_quant}): card '
                                 f'{out["cuda", kv_quant]} != CPU '
                                 f'{out["cpu", kv_quant]}')
    print(f'  small engine (4 slots, max_len 48, 7 requests x 16 tokens), '
          f'full and int8 KV: card == CPU token for token; slot lengths at '
          f'the end {lengths}', flush=True)


def small_paged_engine_phase(llama, engine_lib):
    """The paged engine on the small fp32 model, on the card and on the
    CPU from the same weights: 4 slots, max_len 48, blocks of 16 and a
    pool of 6 usable blocks (of 12 at full capacity), block sharing and
    KV tiers on. Four waves: prompts on a 16- and a 32-token head, then
    on the same heads (share hits, a copy-on-write fork of a partly
    matched block), then prompts that overflow the pool (backpressure;
    idle chains evicted and demoted to the host tier), then the heads
    again (promoted back). Greedy tokens equal,
    token for token, full and int8 KV: the scatter, gather, fork and
    import indices mean on CUDA what they mean on the CPU."""
    cfg = dataclasses.replace(llama.TINY, d_model=128, n_heads=4,
                              n_kv_heads=2, head_dim=64, dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
    rng = np.random.default_rng(5)
    h16 = rng.integers(0, cfg.vocab_size, 16).tolist()
    h32 = rng.integers(0, cfg.vocab_size, 32).tolist()

    def tail(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()
    waves = [[h16 + tail(5), h32 + tail(3)],
             [h32[:24] + tail(4), h16 + tail(9)],
             [tail(30) for _ in range(4)],
             [h16 + tail(7), h32 + tail(2), h32 + tail(6)]]
    out, stats = {}, {}
    for dev, p in (('cpu', params), ('cuda', _tree_to(params, 'cuda'))):
        for kv_quant in (False, True):
            eng = engine_lib.ContinuousEngine(
                p, cfg, slots=4, max_len=48, chunk_steps=4,
                kv_quantize=kv_quant, kv_layout='paged', kv_block=16,
                kv_blocks=7, prefix_share=True, kv_tiers=True, device=dev)
            try:
                got = []
                for rows in waves:
                    futs = [eng.submit(r, 10) for r in rows]
                    got += [f.result(timeout=300) for f in futs]
                    if not eng._kv_tiers.quiesce(60):  # noqa: SLF001
                        raise AssertionError('tier worker did not drain')
                out[dev, kv_quant] = got
                st = eng.stats()
                stats[dev, kv_quant] = (st['kv_blocks'], st['prefix_share'],
                                        st['kv_tiers'])
            finally:
                eng.stop()
    for kv_quant in (False, True):
        if out['cuda', kv_quant] != out['cpu', kv_quant]:
            raise AssertionError(f'small paged engine (int8 KV {kv_quant}): '
                                 f'card {out["cuda", kv_quant]} != CPU '
                                 f'{out["cpu", kv_quant]}')
        kb, share, tiers = stats['cuda', kv_quant]
        if (share['hits'] < 1 or share['cow_forks'] < 1
                or share['evictions'] < 1 or tiers['demotes'] < 1
                or tiers['promotes'] < 1 or tiers['corrupt']
                or kb['owned'] or kb['shared']
                or kb['free'] + kb['cached'] != kb['usable']):
            raise AssertionError(f'small paged engine (int8 KV {kv_quant}) '
                                 f'on the card: {stats["cuda", kv_quant]}')
    print(f'  small paged engine (4 slots, max_len 48, blocks of 16, 6 '
          f'usable, sharing and tiers on, 11 requests x 10 tokens in 4 '
          f'waves), full and int8 KV: card == CPU token for token; card '
          f'int8: prefix_share {stats["cuda", True][1]}, kv_tiers demotes '
          f'{stats["cuda", True][2]["demotes"]} promotes '
          f'{stats["cuda", True][2]["promotes"]}', flush=True)


def small_spec_engine_phase(llama, engine_lib):
    """The speculative engine on the small fp32 model, on the card and on
    the CPU from the same weights: a divergent draft (one layer, other
    weights) and an identical one (the target itself), k 3, 4 slots,
    max_len 48, 7 greedy requests; slot layout with full and int8 KV,
    paged layout (blocks of 16) with both drafts. Tokens and the
    speculative counts equal, card against CPU: the draft's K4 steps, the
    k+1-position verify (einsum, or paged scatter and gather) and the
    per-row rewind mean on CUDA what they mean on the CPU."""
    cfg = dataclasses.replace(llama.TINY, d_model=128, n_heads=4,
                              n_kv_heads=2, head_dim=64, dtype=torch.float32)
    d_cfg = dataclasses.replace(cfg, n_layers=1, d_model=64, n_heads=2,
                                n_kv_heads=2, d_ff=128)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
    d_params = llama.init_params(d_cfg, torch.Generator().manual_seed(9),
                                 'cpu')
    rng = np.random.default_rng(7)
    rows = [rng.integers(0, cfg.vocab_size, n).tolist()
            for n in (3, 17, 9, 20, 5, 12, 21)]
    runs = [  # (label, layout, int8 KV, identical draft)
        ('slot, divergent draft', 'slot', False, False),
        ('slot, divergent draft, int8 KV', 'slot', True, False),
        ('paged, divergent draft', 'paged', False, False),
        ('paged, identical draft', 'paged', False, True)]
    out = {}
    for dev, p, dp in (('cpu', params, d_params),
                       ('cuda', _tree_to(params, 'cuda'),
                        _tree_to(d_params, 'cuda'))):
        for label, layout, kv_quant, same in runs:
            eng = engine_lib.ContinuousEngine(
                p, cfg, slots=4, max_len=48, kv_quantize=kv_quant,
                kv_layout=layout, kv_block=16, spec_k=3,
                draft_params=p if same else dp,
                draft_cfg=cfg if same else d_cfg, device=dev)
            try:
                futs = [eng.submit(r, 16) for r in rows]
                toks = [f.result(timeout=300) for f in futs]
                st = eng.stats()['speculative']
                out[dev, label] = (toks, st['proposals'], st['accepted'])
            finally:
                eng.stop()
    for label, *_ in runs:
        if out['cuda', label] != out['cpu', label]:
            raise AssertionError(f'small spec engine ({label}): card '
                                 f'{out["cuda", label]} != CPU '
                                 f'{out["cpu", label]}')
    rates = {label: round(out['cuda', label][2] / out['cuda', label][1], 3)
             for label, *_ in runs}
    if rates['paged, identical draft'] != 1.0:
        raise AssertionError(f'identical draft accepted {rates}')
    print(f'  small spec engine (k 3, 4 slots, max_len 48, 7 greedy '
          f'requests x 16 tokens): card == CPU token for token and in '
          f'proposals/accepted for each of {[r[0] for r in runs]}; '
          f'acceptance {rates}', flush=True)


def _bf16_ulp(t):
    """The spacing of bf16 values at each element of ``t`` (8 bits of
    significand)."""
    t = t.float()
    return torch.ldexp(torch.ones_like(t), torch.frexp(t).exponent - 8)


def mm_phase(quant_lib, llama):
    """``quantization.mm`` on the card (a bf16 x bf16 -> float32 GEMM,
    scaled, rounded once) against the same call on the CPU (a float32
    einsum), for each projection of BENCH_1B and llama3-1b at the engine's
    decode batch of 16 rows: int8 weights, bf16 outputs within one ulp and
    at most MM_BF16_DIFF_SHARE of them differing, and no difference beyond
    that ulp larger than MM_F32_REL_TOL of the largest |output|; the
    lm_head's float32 logits, from int8 and from bf16 weights, within
    MM_F32_REL_TOL of the largest |logit|. Prints the lm_head product's ms against the float32
    copies the port multiplied before."""
    gen = torch.Generator().manual_seed(5)
    for cfg in (llama.BENCH_1B, llama.LLAMA3_1B):
        d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
        f, v = cfg.d_ff, cfg.vocab_size
        worst = {'excess': 0.0, 'share': 0.0, 'rel': 0.0}
        for name, spec, xs, ws, n_c, out in (
                ('wq', 'bsd,dhk->bshk', (16, 1, d), (d, h, hd), 1, None),
                ('wo', 'bshk,hkd->bsd', (16, 1, h, hd), (h, hd, d), 2, None),
                ('w_gate', 'bsd,df->bsf', (16, 1, d), (d, f), 1, None),
                ('w_down', 'bsf,fd->bsd', (16, 1, f), (f, d), 1, None),
                ('lm_head', 'bd,dv->bv', (16, d), (d, v), 1, torch.float32)):
            x = torch.randn(*xs, generator=gen).to(torch.bfloat16)
            wf = torch.randn(*ws, generator=gen) * 0.02
            weights = [quant_lib._quantize(wf, n_c, stacked=False)]  # noqa: SLF001
            if out is not None:  # the lm_head's bf16 weights too
                weights.append(wf.to(torch.bfloat16))
            for w in weights:
                want = quant_lib.mm(x, w, spec, out)
                got = quant_lib.mm(x.cuda(), _tree_to(w, 'cuda'), spec,
                                   out).cpu()
                if got.dtype != want.dtype or got.shape != want.shape:
                    raise AssertionError(f'mm {name}: {got.dtype} '
                                         f'{tuple(got.shape)} != {want.dtype} '
                                         f'{tuple(want.shape)}')
                if out is None:
                    diff = (got.float() - want.float()).abs()
                    share = float((diff > 0).float().mean())
                    excess = float((diff - _bf16_ulp(want)).clamp_min(0).max()
                                   / want.float().abs().max())
                    worst['share'] = max(worst['share'], share)
                    worst['excess'] = max(worst['excess'], excess)
                    if excess > MM_F32_REL_TOL or share > MM_BF16_DIFF_SHARE:
                        raise AssertionError(
                            f'mm {name} ({cfg.d_model} wide): {share} of '
                            f'values differ, by up to {excess} of the '
                            'largest beyond one bf16 ulp (limits '
                            f'{MM_BF16_DIFF_SHARE}, {MM_F32_REL_TOL})')
                else:
                    rel = float((got - want).abs().max()
                                / want.abs().max())
                    worst['rel'] = max(worst['rel'], rel)
                    if not rel <= MM_F32_REL_TOL:
                        raise AssertionError(f'mm {name}: float32 logits off '
                                             f'by {rel} of the largest')
        # The lm_head product at this width: the float32 sums from bf16
        # weights, against the float32 copies multiplied before.
        xc, wc = x.cuda(), wf.to(torch.bfloat16).cuda()
        ms = _time_ms(lambda: quant_lib.mm(xc, wc, 'bd,dv->bv',
                                           torch.float32), 20)
        copies_ms = _time_ms(lambda: torch.einsum('bd,dv->bv', xc.float(),
                                                  wc.float()), 20)
        print(f'  mm d_model {d} vocab {v}: int8 projections against the '
              f'CPU: at most {worst["share"]:.2e} of values differing (limit '
              f'{MM_BF16_DIFF_SHARE}), by one bf16 ulp plus at most '
              f'{worst["excess"]:.2e} of the largest (limit '
              f'{MM_F32_REL_TOL}); lm_head float32 logits within '
              f'{worst["rel"]:.2e} of the largest (limit {MM_F32_REL_TOL}); '
              f'lm_head bf16 -> float32 product {ms:.4f} ms, float32 '
              f'copies {copies_ms:.4f} ms', flush=True)
        del xc, wc
        torch.cuda.empty_cache()


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# -- phase 5: training a small model, card against CPU -------------------------------


def small_train_phase(llama, trainer_lib, data_lib):
    """3 Adafactor steps (warmup 1, lr 1e-2 so the weights move) of a
    head_dim-64 fp32 model on the card and on the CPU from the same
    weights. Tolerances: loss 1e-4, params 1e-4 (fp32; sums in another
    order, then three Adafactor normalisations)."""
    model = dataclasses.replace(llama.TINY, d_model=128, n_heads=4,
                                n_kv_heads=2, head_dim=64, d_ff=256,
                                dtype=torch.float32)
    cfg = trainer_lib.TrainerConfig(model=model, global_batch_size=2,
                                    seq_len=200, warmup_steps=1,
                                    learning_rate=1e-2)
    init = llama.init_params(model, torch.Generator().manual_seed(0), 'cpu')
    runs = {}
    for dev in ('cpu', 'cuda'):
        trainer = trainer_lib.Trainer(cfg, device=dev)
        state = trainer.init_state_from_numpy(_tree_to_numpy(init))
        losses = []
        for batch in data_lib.synthetic_batches(2, 200, model.vocab_size,
                                                seed=3, num_batches=3):
            state, metrics = trainer.step(state, batch)
            losses.append(float(metrics['loss']))
        runs[dev] = (losses, _flat(state['params']))
    loss_err = max(abs(a - b) for a, b in zip(runs['cpu'][0],
                                              runs['cuda'][0]))
    param_err = max(float((a - b.cpu()).abs().max()) for a, b in zip(
        runs['cpu'][1], runs['cuda'][1]))
    moved = max(float((a - b).abs().max()) for a, b in zip(
        runs['cpu'][1], _flat(init)))
    if not (loss_err <= 1e-4 and param_err <= 1e-4 and moved > 1e-3):
        raise AssertionError(f'small model training: card vs CPU loss err '
                             f'{loss_err}, param err {param_err} (limits '
                             f'1e-4), weights moved {moved}')
    print(f'  small model (d_model 128, head_dim 64, fp32), 3 Adafactor '
          f'steps: losses {runs["cuda"][0]}; card vs CPU max loss err '
          f'{loss_err}, max param err {param_err} (limits 1e-4); weights '
          f'moved up to {moved}', flush=True)


def small_lora_phase(llama, trainer_lib, lora_lib):
    """3 LoRA steps (Adafactor, warmup 1, lr 1e-2, rank 4, every target)
    of the small fp32 model on the card and on the CPU from the same
    weights and float32 adapters (B made nonzero, so both factors learn).
    Losses and adapters within 1e-4, as the full finetune of phase 5; the
    base params bit for bit unchanged on both."""
    model = dataclasses.replace(llama.TINY, d_model=128, n_heads=4,
                                n_kv_heads=2, head_dim=64, d_ff=256,
                                dtype=torch.float32)
    lcfg = lora_lib.LoraConfig(rank=4, targets=lora_lib.ALL_TARGETS)
    cfg = trainer_lib.TrainerConfig(model=model, global_batch_size=2,
                                    seq_len=200, warmup_steps=1,
                                    learning_rate=1e-2, lora=lcfg)
    init = llama.init_params(model, torch.Generator().manual_seed(0), 'cpu')
    adapters = lora_lib.init_lora(torch.Generator().manual_seed(1), init,
                                  lcfg, dtype=torch.float32, device='cpu')
    for ab in adapters.values():
        ab['b'] = torch.randn(ab['b'].shape,
                              generator=torch.Generator().manual_seed(2)
                              ) * 0.01
    rng = np.random.default_rng(8)
    batches = [rng.integers(0, model.vocab_size, (2, 200)).astype(np.int32)
               for _ in range(3)]
    runs = {}
    for dev in ('cpu', 'cuda'):
        trainer = trainer_lib.Trainer(cfg, device=dev)
        state = trainer.init_state_from_numpy(_tree_to_numpy(init),
                                              lora=_tree_to_numpy(adapters))
        losses = []
        for batch in batches:
            state, metrics = trainer.step(state, batch)
            losses.append(float(metrics['loss']))
        runs[dev] = (losses, _flat(state['lora']), _flat(state['params']))
    loss_err = max(abs(a - b) for a, b in zip(runs['cpu'][0],
                                              runs['cuda'][0]))
    lora_err = max(float((a - b.cpu()).abs().max()) for a, b in zip(
        runs['cpu'][1], runs['cuda'][1]))
    moved = max(float((a - b).abs().max()) for a, b in zip(
        runs['cuda'][1], [t.cuda() for t in _flat(adapters)]))
    frozen = all(torch.equal(a.cpu(), b) for dev in runs
                 for a, b in zip(runs[dev][2], _flat(init)))
    if not (loss_err <= 1e-4 and lora_err <= 1e-4 and moved > 1e-3
            and frozen):
        raise AssertionError(f'small LoRA training: card vs CPU loss err '
                             f'{loss_err}, adapter err {lora_err} (limits '
                             f'1e-4), adapters moved {moved}, base frozen '
                             f'{frozen}')
    print(f'  small model LoRA (rank 4, all 7 targets, fp32), 3 Adafactor '
          f'steps: losses {runs["cuda"][0]}; card vs CPU max loss err '
          f'{loss_err}, max adapter err {lora_err} (limits 1e-4); adapters '
          f'moved up to {moved}; base bit for bit unchanged', flush=True)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree.detach()]


def _tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


# -- phase 6: training BENCH_1B through the entry point -------------------------------


def train_phase(llama, fa, train_run):
    steps, layers = 4, llama.BENCH_1B.n_layers
    for counter in ('fwd_launches', 'bwd_dq_launches', 'bwd_dkv_launches'):
        setattr(fa.flash_attention, counter, 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train_run.main(['--model', 'bench-1b', '--seq-len', '4096',
                          '--global-batch-size', '2', '--steps', str(steps),
                          '--warmup-steps', '1', '--optimizer', 'adafactor',
                          '--remat-policy', 'full', '--log-every', '1'])
    wall = time.perf_counter() - t0
    launches = {name: getattr(fa.flash_attention, counter)
                for name, (_, counter, _) in FLASH.items()}
    expected = {'flash_fwd': 2 * layers * steps,
                'flash_bwd_dq': layers * steps,
                'flash_bwd_dkv': layers * steps}
    if launches != expected:
        raise AssertionError(f'training launches {launches}, expected '
                             f'{expected}')
    losses = out['losses']
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f'training losses {losses}')
    init = llama.init_params(llama.BENCH_1B, torch.Generator(
        device='cuda').manual_seed(0), 'cuda')
    changed = total = 0
    for a, b in zip(_flat(out['state']['params']), _flat(init)):
        changed += int((a != b).sum())
        total += a.numel()
    del init
    if changed == 0:
        raise AssertionError('training left every weight unchanged')
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'  bench-1b seq 4096 batch 2, {steps} steps in {wall:.1f} s: '
          f'losses {losses}; step ms by window {out["window_step_ms"]}; '
          f'{changed / total:.2%} of weights changed (bf16 weights keep '
          f'updates below half an ulp); peak device memory {peak:.1f} GiB; '
          f'launches {launches} = expected', flush=True)
    del out
    torch.cuda.empty_cache()
    return launches


# -- phase 7: the serving replica ---------------------------------------------------


@contextlib.contextmanager
def _served(server):
    """``server`` over HTTP on a free local port; yields its URL and stops
    the HTTP server and the replica on exit."""
    httpd = server.make_httpd('127.0.0.1', 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f'http://127.0.0.1:{httpd.server_address[1]}'
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()
        thread.join(30)


def _idle(engine):
    while engine.busy():
        time.sleep(0.01)


def _post_all(url, reqs):
    with concurrent.futures.ThreadPoolExecutor(len(reqs)) as pool:
        return list(pool.map(lambda r: _post(url, r), reqs))


def _post(url, body, timeout=600):
    req = urllib.request.Request(
        f'{url}/generate', data=json.dumps(body).encode(),
        headers={'Content-Type': 'application/json'}, method='POST')
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def serving_phase(srv_lib, gen_lib, da, quantize, kv_cache):
    server = srv_lib.LlmServer('bench-1b', max_len=1024, quantize=quantize,
                               kv_cache=kv_cache, engine='off')
    cfg = server.cfg
    with _served(server) as url:
        rng = np.random.default_rng(2)

        def prompt(n):
            return rng.integers(0, cfg.vocab_size, n).tolist()
        greedy = {'tokens': [prompt(17)], 'max_new_tokens': 32}
        reqs = [greedy,
                {'tokens': [prompt(128)], 'max_new_tokens': 48},
                {'tokens': [prompt(300)], 'max_new_tokens': 64},
                {'tokens': [prompt(64)], 'max_new_tokens': 40,
                 'temperature': 0.8, 'seed': 7, 'top_k': 50, 'top_p': 0.95}]
        _post(url, {'tokens': [prompt(8)], 'max_new_tokens': 2})  # warm-up
        server.generate_calls.clear()
        da.flash_decode.launches = 0
        answers = _post_all(url, reqs)
        launches = da.flash_decode.launches
        calls = list(server.generate_calls)
        expected = sum(cfg.n_layers * (max_new - 1) for _, max_new in calls)
        if launches != expected or not calls:
            raise AssertionError(f'flash_decode launched {launches} times '
                                 f'for generate calls {calls}; expected '
                                 f'{expected}')
        for req, (status, body) in zip(reqs, answers):
            rows = body['tokens']
            if status != 200 or len(rows) != 1 \
                    or len(rows[0]) != req['max_new_tokens'] \
                    or not all(0 <= t < cfg.vocab_size for t in rows[0]):
                raise AssertionError(f'bad answer {status} {body}')
        if _post(url, greedy)[1] != _post(url, greedy)[1]:
            raise AssertionError('repeated greedy request changed tokens')
        if _post(url, reqs[3])[1] != answers[3][1]:
            raise AssertionError('repeated seeded request changed tokens')
        tokens, lens = gen_lib.pad_prompts(greedy['tokens'],
                                           device=server.device)
        direct = gen_lib.generate(server.params, cfg, tokens, 32,
                                  max_len=1024, prompt_lengths=lens,
                                  kv_quantize=kv_cache == 'int8').tolist()
        if _post(url, greedy)[1]['tokens'] != direct:
            raise AssertionError('served tokens differ from generate()')
        rates = {}
        for rows in (1, 32):
            body = {'tokens': [prompt(128) for _ in range(rows)],
                    'max_new_tokens': 64}
            _post(url, body)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _post(url, body)
            rates[rows] = rows * 64 / (time.perf_counter() - t0)
        label = f'{quantize or "bf16"} weights + {kv_cache} KV'
        print(f'  bench-1b {label}: {len(reqs)} concurrent requests in '
              f'{len(calls)} generate calls {calls}, flash_decode launches '
              f'{launches} = n_layers x sum(max_new - 1); request tok/s '
              f'(prompt 128 + 64 new): B=1 {rates[1]:.1f}, '
              f'B=32 {rates[32]:.1f}', flush=True)
    del server
    torch.cuda.empty_cache()
    return launches


# -- phase 8: the replica's default path, the continuous engine ---------------------


def _post_stream(url, body, timeout=600):
    """(status, NDJSON lines) of one streamed request."""
    req = urllib.request.Request(
        f'{url}/generate', data=json.dumps(dict(body, stream=True)).encode(),
        headers={'Content-Type': 'application/json'}, method='POST')
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, [json.loads(line) for line in
                          r.read().decode().splitlines() if line.strip()]


def _check_stream(url, stream_req, status, lines):
    """A streamed answer (``_post_stream``'s) is whole: HTTP 200, row 0's
    lines adding up to ``max_new_tokens`` ids, then ``{"done": true}``;
    and the same request, not streamed, gives the same tokens. Returns
    the streamed ids."""
    streamed = [t for ln in lines[:-1] for t in ln['tokens']]
    if status != 200 or lines[-1] != {'done': True} \
            or len(streamed) != stream_req['max_new_tokens'] \
            or any(ln.get('row') != 0 for ln in lines[:-1]):
        raise AssertionError(f'bad stream {status} {lines}')
    if _post(url, stream_req)[1]['tokens'] != [streamed]:
        raise AssertionError('streamed tokens differ from the same request '
                             'not streamed')
    return streamed


def _direct_gaps(gen_lib, server, prompt, tokens, kv_int8):
    """The direct path (``generate``'s calls, batch 1) fed ``tokens``:
    for each of them, the gap between the two largest logits of the step
    that chose it, and whether it was a largest logit of that step."""
    params, cfg, dev = server.params, server.cfg, server.device
    cache = gen_lib.init_cache(cfg, 1, server.max_len, quantize=kv_int8,
                               device=dev)
    toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
    gaps, argmax_ok = [], []
    with torch.inference_mode():
        for t in tokens:
            logits, cache = gen_lib.forward_cached(params, toks, cache, cfg)
            top = torch.topk(logits[0].float(), 2)
            gaps.append(float(top.values[0] - top.values[1]))
            argmax_ok.append(float(logits[0, t]) == float(top.values[0]))
            toks = torch.tensor([[t]], dtype=torch.int32, device=dev)
    return gaps, argmax_ok


def _greedy_part(gen_lib, server, prompt, got, kv_int8):
    """Where a greedy stream parts from a direct ``generate`` of its
    prompt alone: (position, the direct path's top-2 logit gap there,
    whether replaying the direct path's tokens gave its argmax at every
    step up to it), or None where it does not part."""
    tokens, lens = gen_lib.pad_prompts([prompt], device=server.device)
    direct = gen_lib.generate(server.params, server.cfg, tokens, len(got),
                              max_len=server.max_len, prompt_lengths=lens,
                              kv_quantize=kv_int8)[0].tolist()
    if got == direct:
        return None
    j = next(i for i, (a, b) in enumerate(zip(got, direct)) if a != b)
    gaps, argmax_ok = _direct_gaps(gen_lib, server, prompt, direct[:j + 1],
                                   kv_int8)
    return j, gaps[j], all(argmax_ok)


def _check_greedy(gen_lib, server, prompt, got, kv_int8):
    """A greedy engine stream equals a direct ``generate``, or parts from
    it where the direct path's top-2 logit gap is below GREEDY_GAP_LIMIT.
    Returns (parting position or None, its gap)."""
    part = _greedy_part(gen_lib, server, prompt, got, kv_int8)
    if part is None:
        return None, None
    j, gap, replayed = part
    if not replayed or not gap < GREEDY_GAP_LIMIT:
        raise AssertionError(f'engine tokens part from generate() at {j} '
                             f'where the top-2 logit gap is {gap} (limit '
                             f'{GREEDY_GAP_LIMIT}); argmax replayed '
                             f'{replayed}')
    return j, gap


def _check_answers(reqs, answers, vocab):
    """Every answer is HTTP 200 with one row of ``max_new_tokens`` ids in
    [0, vocab)."""
    for req, (code, body) in zip(reqs, answers):
        rows = body.get('tokens') or [[]]
        if code != 200 or len(rows) != 1 \
                or len(rows[0]) != req['max_new_tokens'] \
                or not all(0 <= t < vocab for t in rows[0]):
            raise AssertionError(f'bad answer {code} {body}')


def _idle_slot_check(engine_lib, server):
    """A second bench-1b engine with max_len 128: requests one after
    another keep slot 0 busy for more than 128 decode steps while the 15
    other slots idle, their lengths running past max_len. No fault (the
    device is synchronised after), and each answer is whole."""
    eng = engine_lib.ContinuousEngine(
        server.params, server.cfg, max_len=128,
        kv_quantize=server.kv_cache == 'int8')
    rng = np.random.default_rng(6)
    try:
        for _ in range(5):
            row = rng.integers(0, server.cfg.vocab_size, 24).tolist()
            out = eng.submit(row, 48).result(timeout=600)
            if len(out) != 48 or not all(0 <= t < server.cfg.vocab_size
                                         for t in out):
                raise AssertionError(f'idle-slot engine answered {out}')
        torch.cuda.synchronize()
        lengths = eng._cache.lengths.cpu().tolist()  # noqa: SLF001
        stats = eng.stats()
    finally:
        eng.stop()
    steps = stats['pipeline']['dispatches'] * stats['chunk_steps']
    if steps <= 128 or min(lengths[1:]) <= 128:  # slot 0 took each one
        raise AssertionError(f'idle-slot check did not run past max_len: '
                             f'{steps} decode steps, lengths {lengths}')
    return steps, lengths


def _engine_traffic(vocab):
    """Phase 8's traffic: 24 requests (prompts 17-300, max_new 8-64, a
    third greedy, a third top-k 50, a third top-p 0.9, no seed) and one
    request to stream."""
    rng = np.random.default_rng(3)
    reqs = []
    for i in range(24):
        body = {'tokens': [rng.integers(0, vocab, int(
                    rng.integers(17, 301))).tolist()],
                'max_new_tokens': int(rng.integers(8, 65))}
        if i % 3 == 1:
            body.update(temperature=0.8, top_k=50)
        elif i % 3 == 2:
            body.update(temperature=1.0, top_p=0.9)
        reqs.append(body)
    stream_req = {'tokens': [rng.integers(0, vocab, 40).tolist()],
                  'max_new_tokens': 40}
    return reqs, stream_req


def engine_phase(srv_lib, gen_lib, engine_lib, da, quantize, kv_cache):
    """``LlmServer('bench-1b')`` with its default engine over HTTP: 24
    concurrent requests (more than the 16 slots; prompts 17-300, max_new
    8-64, greedy and sampled), then one streamed request; K4 launched
    n_layers x chunk_steps x dispatches times in that window. Returns the
    launches and the window's tok/s and host ms per decode step."""
    server = srv_lib.LlmServer('bench-1b', max_len=1024, quantize=quantize,
                               kv_cache=kv_cache)
    cfg, engine = server.cfg, server.engine
    kv_int8 = kv_cache == 'int8'
    label = f'{quantize or "bf16"} weights + {kv_cache} KV'
    with _served(server) as url:
        reqs, stream_req = _engine_traffic(cfg.vocab_size)
        for body in ({'tokens': [[1] * 8], 'max_new_tokens': 2},
                     dict(reqs[0], max_new_tokens=9)):  # warm-up
            _post(url, body)
        _idle(engine)
        if any(r.get('seed') is not None for r in reqs):
            raise AssertionError('a seeded request would take the window '
                                 'path and launch K4 there')
        d0 = engine.stats()['pipeline']['dispatches']
        da.flash_decode.launches = 0
        t0 = time.perf_counter()
        answers = _post_all(url, reqs)
        wall = time.perf_counter() - t0
        _idle(engine)
        window = engine.stats()['pipeline']['dispatches'] - d0
        status, lines = _post_stream(url, stream_req)
        _idle(engine)
        launches = da.flash_decode.launches
        stats = engine.stats()
        dispatches = stats['pipeline']['dispatches'] - d0
        expected = cfg.n_layers * stats['chunk_steps'] * dispatches
        if launches != expected or dispatches == 0:
            raise AssertionError(f'flash_decode launched {launches} times '
                                 f'over {dispatches} chunks; expected '
                                 f'{expected}')
        _check_answers(reqs, answers, cfg.vocab_size)
        streamed = _check_stream(url, stream_req, status, lines)
        parted = [_check_greedy(gen_lib, server, r['tokens'][0],
                                a[1]['tokens'][0], kv_int8)
                  for r, a in zip(reqs, answers) if 'temperature' not in r]
        tokens = sum(len(a[1]['tokens'][0]) for a in answers)
        step_ms = wall * 1e3 / (window * stats['chunk_steps'])
        steps, lengths = _idle_slot_check(engine_lib, server)
        print(f'  bench-1b {label}, default engine (16 slots, chunk 8, '
              f'pipelined): {len(reqs)} concurrent requests, {tokens} '
              f'tokens in {wall:.2f} s = {tokens / wall:.1f} tok/s, '
              f'{window} chunks ({step_ms:.2f} ms per decode step on the '
              f'host clock, admission included); '
              f'stream of {len(lines) - 1} lines adds up to '
              f'{len(streamed)} tokens = the request not streamed; '
              f'flash_decode launches {launches} = n_layers x chunk_steps x '
              f'dispatches; greedy vs generate(): '
              f'{sum(p[0] is None for p in parted)} of {len(parted)} equal, '
              f'parted at (position, top-2 gap) '
              f'{[p for p in parted if p[0] is not None]} (limit '
              f'{GREEDY_GAP_LIMIT}); pipeline {stats["pipeline"]}; '
              f'idle-slot engine (max_len 128): {steps} decode steps, no '
              f'fault, slot lengths {lengths}', flush=True)
    del server
    torch.cuda.empty_cache()
    return launches, {'tok_s': tokens / wall, 'step_ms': step_ms}


# -- phase 9: the serve-llama recipe -----------------------------------------------


@contextlib.contextmanager
def _cut_depth(llama, name, n_layers, **fields):
    """``llama.PRESETS[name]`` at ``n_layers`` layers (and ``fields``:
    its pipeline stages, say), its widths untouched, while open."""
    full = llama.PRESETS[name]
    llama.PRESETS[name] = dataclasses.replace(full, n_layers=n_layers,
                                              **fields)
    try:
        yield
    finally:
        llama.PRESETS[name] = full


def _recipe_traffic(vocab):
    """Phase 9's requests, from a numpy seed: 4 system preambles of 256
    ids; each request is one preamble and a user suffix of 16-200 ids
    (272-456 in all, so 256 is the stored bucket prefix), max_new 16-64, a
    third greedy, a third top-k 50, a third top-p 0.9, no seed. Returns
    (warm-up: 8, each preamble twice; measured: 32)."""
    rng = np.random.default_rng(9)
    preambles = [rng.integers(0, vocab, 256).tolist() for _ in range(4)]

    def body(i):
        suffix = rng.integers(0, vocab, int(rng.integers(16, 201))).tolist()
        req = {'tokens': [preambles[i % 4] + suffix],
               'max_new_tokens': int(rng.integers(16, 65))}
        if i % 3 == 1:
            req.update(temperature=0.8, top_k=50)
        elif i % 3 == 2:
            req.update(temperature=1.0, top_p=0.9)
        return req
    return [body(i) for i in range(8)], [body(i) for i in range(32)]


def _window(url, server, da, reqs):
    """Serve ``reqs`` at once on an idle replica: (answers, the window's
    figures). K4 must be launched n_layers x chunk_steps x dispatches
    times in the window."""
    engine, cfg = server.engine, server.cfg
    _idle(engine)
    s0 = engine.stats()
    da.flash_decode.launches = 0
    t0 = time.perf_counter()
    answers = _post_all(url, reqs)
    wall = time.perf_counter() - t0
    _idle(engine)
    launches = da.flash_decode.launches
    s1 = engine.stats()
    _check_answers(reqs, answers, cfg.vocab_size)
    dispatches = s1['pipeline']['dispatches'] - s0['pipeline']['dispatches']
    expected = cfg.n_layers * s1['chunk_steps'] * dispatches
    if launches != expected or dispatches == 0:
        raise AssertionError(f'flash_decode launched {launches} times over '
                             f'{dispatches} chunks; expected {expected}')
    tokens = sum(len(a[1]['tokens'][0]) for a in answers)

    def delta(*keys):
        a, b = s0, s1
        for k in keys:
            a, b = a[k], b[k]
        return b - a
    return answers, {
        'tok_s': tokens / wall, 'tokens': tokens, 'wall_s': wall,
        'host_ms_per_step': wall * 1e3 / (dispatches * s1['chunk_steps']),
        'dispatches': dispatches, 'launches': launches,
        'prefill_ms': delta('prefill_ms'),
        'prefill_bubble_ms': delta('prefill_bubble_ms'),
        'prefill_tokens': delta('prefill_tokens'),
        'prefill_tokens_saved': delta('prefill_tokens_saved'),
        'prefix_hits': delta('prefix_cache', 'hits'),
        'prefix_hit_tokens': delta('prefix_cache', 'hit_tokens'),
        'prefix_entries': s1['prefix_cache']['entries'],
        'share_hits': delta('prefix_share', 'hits'),
        'share_hit_tokens': delta('prefix_share', 'hit_tokens'),
        'cow_forks': delta('prefix_share', 'cow_forks'),
        'evictions': delta('prefix_share', 'evictions')}


def _device_busy(fn):
    """Device time of all kernels over the wall time of ``fn``
    (``_device_trace``)."""
    return _device_trace(fn)[0]


def _device_trace(fn):
    """(device busy share, device kernels) over ``fn``: device time of all
    kernels over the wall time of ``fn``, from a ``torch.profiler`` trace
    of the device alone (CUPTI sees the engine thread's launches), summed
    over the profiler's raw events: building its Python event tree for a
    round's ~300,000 events takes minutes. The raw events are a private
    API of torch's profiler (``prof.profiler.kineto_results.events()``,
    ``e.device_type()``): where it is missing, or the trace holds no
    device events, this raises rather than report a share it did not
    measure."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ns = (time.perf_counter() - t0) * 1e9
    try:
        events = [e for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA]
        busy = sum(e.duration_ns() if hasattr(e, 'duration_ns')
                   else e.duration_us() * 1e3 for e in events)
    except AttributeError as e:
        raise RuntimeError('device busy share: torch.profiler has no raw '
                           f'event API here ({e})') from e
    if not busy:
        raise AssertionError('device busy share: the trace holds no device '
                             'events')
    return busy / wall_ns, len(events)


def _recipe_round(srv_lib, gen_lib, da, prefix_cache):
    """Warm-up and measured rounds of phase 9's traffic on a fresh
    recipe replica with ``prefix_cache`` pool slots. With the pool: all
    32 measured requests hit (8,192 tokens), and the greedy answers meet
    the gap rule; then the device busy share of one more such round."""
    server = srv_lib.LlmServer('llama3-1b', prefix_cache=prefix_cache,
                               **RECIPE)
    warm, measured = _recipe_traffic(server.cfg.vocab_size)
    with _served(server) as url:
        _check_answers(warm, _post_all(url, warm), server.cfg.vocab_size)
        answers, fig = _window(url, server, da, measured)
        hits = (fig['prefix_hits'], fig['prefix_hit_tokens'],
                fig['prefill_tokens_saved'])
        if prefix_cache:
            if hits != (32, 8192, 8192) or fig['prefix_entries'] > 8:
                raise AssertionError(f'prefix pool in the measured window: '
                                     f'{fig}; expected 32 hits, 8,192 hit '
                                     'and saved tokens, <= 8 entries')
            fig['greedy_parted'] = [
                _check_greedy(gen_lib, server, r['tokens'][0],
                              a[1]['tokens'][0], True)
                for r, a in zip(measured, answers)
                if 'temperature' not in r]
            _phase('  greedy checks done')
            fig['device_busy'] = _device_busy(
                lambda: (_post_all(url, measured), _idle(server.engine)))
        elif hits != (0, 0, 0):
            raise AssertionError(f'no pool, yet {hits}')
    del server
    torch.cuda.empty_cache()
    fig['greedy_answers'] = [a[1]['tokens'][0] for r, a in zip(measured, answers)
                             if 'temperature' not in r]
    return fig


def _chunked_round(srv_lib, gen_lib, da):
    """A fresh recipe replica with SKYTPU_LLM_PREFILL_CHUNK=256: one
    prompt of 1,500 tokens arrives while 15 short requests decode. It
    takes >= 6 prefill chunks, decode chunks run while it prefills, and
    its greedy answer meets the gap rule."""
    os.environ['SKYTPU_LLM_PREFILL_CHUNK'] = '256'
    try:
        server = srv_lib.LlmServer('llama3-1b', prefix_cache=8, **RECIPE)
    finally:
        del os.environ['SKYTPU_LLM_PREFILL_CHUNK']
    engine, vocab = server.engine, server.cfg.vocab_size
    rng = np.random.default_rng(10)
    shorts = [{'tokens': [rng.integers(0, vocab, 32).tolist()],
               'max_new_tokens': 96} for _ in range(15)]
    long_req = {'tokens': [rng.integers(0, vocab, 1500).tolist()],
                'max_new_tokens': 32}
    with _served(server) as url:
        _post(url, {'tokens': [[1] * 8], 'max_new_tokens': 2})  # warm-up
        _idle(engine)
        s0 = engine.stats()
        da.flash_decode.launches = 0
        samples = []  # (prefilling, chunks_run) while the long one runs
        with concurrent.futures.ThreadPoolExecutor(16) as pool:
            futs = [pool.submit(_post, url, b) for b in shorts]
            deadline = time.monotonic() + 300
            while (engine.stats()['active_slots'] < 15
                   and time.monotonic() < deadline):
                time.sleep(0.001)
            long_fut = pool.submit(_post, url, long_req)
            while not long_fut.done():
                st = engine.stats()
                samples.append((st['prefilling'], st['chunks_run']))
                time.sleep(0.002)
            answers = [f.result() for f in futs] + [long_fut.result()]
        _idle(engine)
        launches = da.flash_decode.launches
        s1 = engine.stats()
        _check_answers(shorts + [long_req], answers, vocab)
        dispatches = (s1['pipeline']['dispatches']
                      - s0['pipeline']['dispatches'])
        expected = server.cfg.n_layers * s1['chunk_steps'] * dispatches
        if launches != expected or dispatches == 0:
            raise AssertionError(f'flash_decode launched {launches} times '
                                 f'over {dispatches} chunks; expected '
                                 f'{expected}')
        chunks = s1['prefill_chunks'] - s0['prefill_chunks']
        during = [c for p, c in samples if p > 0]
        if chunks < 6 or not during or max(during) <= min(during):
            raise AssertionError(f'{chunks} prefill chunks (>= 6 expected); '
                                 f'chunks_run while prefilling {during}')
        parted = _check_greedy(gen_lib, server, long_req['tokens'][0],
                               answers[-1][1]['tokens'][0], True)
    del server
    torch.cuda.empty_cache()
    return {'prefill_chunks': chunks, 'decode_chunks_while_prefilling':
            max(during) - min(during), 'launches': launches,
            'long_greedy_parted': parted}


def recipe_phase(srv_lib, gen_lib, da):
    """The serve-llama recipe: ``LlmServer('llama3-1b', max_len=2048,
    quantize='int8', kv_cache='int8', prefix_cache=8)`` over HTTP, then
    the same traffic on a replica without the pool, then chunked prefill.
    Returns K4's launches in the three checked windows."""
    figs = {}
    for pool in (8, 0):
        figs[pool] = _recipe_round(srv_lib, gen_lib, da, pool)
        _phase(f'  pool {pool} rounds done')
    chunked = _chunked_round(srv_lib, gen_lib, da)
    keys = ('tok_s', 'host_ms_per_step', 'prefill_ms', 'prefill_bubble_ms',
            'prefill_tokens', 'prefill_tokens_saved', 'tokens', 'wall_s',
            'dispatches', 'launches')
    print('  llama3-1b int8 weights + int8 KV, max_len 2048, 32 concurrent '
          'requests (4 preambles of 256 + suffixes 16-200; max_new 16-64), '
          'measured window, --prefix-cache 8 | 0:', flush=True)
    for key in keys:
        print(f'    {key:22s} {figs[8][key]} | {figs[0][key]}', flush=True)
    parted = figs[8]['greedy_parted']
    same = sum(a == b for a, b in zip(figs[8]['greedy_answers'],
                                      figs[0]['greedy_answers']))
    print(f'    greedy answers equal with and without the pool: {same} of '
          f'{len(parted)}', flush=True)
    print(f'    prefix hits 32, hit tokens 8192, entries '
          f'{figs[8]["prefix_entries"]}; K4 launches = n_layers x '
          f'chunk_steps x '
          f'dispatches in each window; greedy vs generate(): '
          f'{sum(p[0] is None for p in parted)} of {len(parted)} equal, '
          f'parted at (position, top-2 gap) '
          f'{[p for p in parted if p[0] is not None]} (limit '
          f'{GREEDY_GAP_LIMIT}); device busy (profiled round, pool) '
          f'{figs[8]["device_busy"]}', flush=True)
    print(f'  chunked prefill (SKYTPU_LLM_PREFILL_CHUNK=256): {chunked}',
          flush=True)
    return (figs[8]['launches'] + figs[0]['launches'] + chunked['launches'],
            figs)


# -- phase 11: the paged layout at full width ----------------------------------------


PAGED = dict(RECIPE, kv_layout='paged')
P2_BLOCKS = 257  # 256 usable: 4,096 positions, an eighth of 16 x 2048
# About two 256-token chains of int8 blocks (139,264 bytes at 8 layers).
P2_HOST_BYTES = 10_000_000 * RECIPE_LAYERS // 16


def _diverging(measured, vocab):
    """4 requests that copy an earlier request's first 264 tokens (its
    256-token preamble and 8 of its own) and then diverge: each forks the
    partly matched 17th block."""
    rng = np.random.default_rng(11)
    return [{'tokens': [measured[i]['tokens'][0][:264]
                        + rng.integers(0, vocab, 24).tolist()],
             'max_new_tokens': 16} for i in (0, 5, 10, 15)]


def _greedy_parted(gen_lib, server, reqs, answers):
    return [_check_greedy(gen_lib, server, r['tokens'][0], a[1]['tokens'][0],
                          True)
            for r, a in zip(reqs, answers) if 'temperature' not in r]


def _reconciled(engine):
    """The block accounts after a drain: nothing owned or referenced,
    used == cached, free + cached == usable, and the tier counts equal
    the tiers' own."""
    _idle(engine)
    st = engine.stats()
    kb, tiers = st['kv_blocks'], st['kv_tiers']
    if (kb['owned'] or kb['shared'] or kb['used'] != kb['cached']
            or kb['free'] + kb['cached'] != kb['usable']
            or kb['host'] != tiers['host_blocks']
            or kb['spilled'] != tiers['spilled_blocks']):
        raise AssertionError(f'block accounts do not reconcile: {kb} '
                             f'{tiers}')
    return kb


def _paged_p1(srv_lib, gen_lib, da):
    """P1: a full-capacity pool (2,049 blocks). Warm-up of one request
    per preamble (committing the chains), the 32-request window (32
    share hits, 8,192 hit tokens), then 4 diverging requests (>= 4
    copy-on-write forks)."""
    server = srv_lib.LlmServer('llama3-1b', **PAGED)
    vocab = server.cfg.vocab_size
    warm, measured = _recipe_traffic(vocab)
    with _served(server) as url:
        _check_answers(warm[:4], _post_all(url, warm[:4]), vocab)
        answers, fig = _window(url, server, da, measured)
        if (fig['share_hits'], fig['share_hit_tokens']) != (32, 8192):
            raise AssertionError(f'share hits in the measured window: {fig}'
                                 '; expected 32 hits and 8,192 hit tokens')
        fig['greedy_parted'] = _greedy_parted(gen_lib, server, measured,
                                              answers)
        div = _diverging(measured, vocab)
        div_answers, div_fig = _window(url, server, da, div)
        if div_fig['cow_forks'] < 4:
            raise AssertionError(f'diverging requests: {div_fig}; expected '
                                 '>= 4 copy-on-write forks')
        fig['div_greedy_parted'] = _greedy_parted(gen_lib, server, div,
                                                  div_answers)
        fig['div_cow_forks'] = div_fig['cow_forks']
        fig['launches'] += div_fig['launches']
        fig['kv_blocks'] = _reconciled(server.engine)
    del server
    torch.cuda.empty_cache()
    return fig


def _paged_p2(srv_lib, gen_lib, da):
    """P2: a pool of 256 usable blocks and a host tier of about two
    chains, spilling to a temporary directory. Round 1: the warm-up and
    the 32-request window; round 2: 8 new preambles x 2 requests; round
    3: the first 4 preambles again. Evictions, demotes and spills; round
    3 promotes or fetches with nothing corrupt; the accounts reconcile."""
    spill = tempfile.mkdtemp(prefix='kvspill-')
    env = {'SKYTPU_KV_HOST_BYTES': str(P2_HOST_BYTES),
           'SKYTPU_KV_SPILL_DIR': spill}
    os.environ.update(env)
    try:
        server = srv_lib.LlmServer('llama3-1b', kv_blocks=P2_BLOCKS,
                                   **PAGED)
    finally:
        for var in env:
            del os.environ[var]
    vocab, engine = server.cfg.vocab_size, server.engine
    warm, measured = _recipe_traffic(vocab)
    rng = np.random.default_rng(12)
    fresh = [rng.integers(0, vocab, 256).tolist() for _ in range(8)]
    round2 = [{'tokens': [fresh[i % 8] + rng.integers(
                   0, vocab, int(rng.integers(16, 201))).tolist()],
               'max_new_tokens': int(rng.integers(16, 65))}
              for i in range(16)]
    round3 = [{'tokens': [measured[i]['tokens'][0][:256] + rng.integers(
                   0, vocab, 40).tolist()], 'max_new_tokens': 32}
              for i in range(4)]
    figs = {}
    try:
        with _served(server) as url:
            _check_answers(warm[:4], _post_all(url, warm[:4]), vocab)
            for name, reqs in (('round 1', measured), ('round 2', round2),
                               ('round 3', round3)):
                t0 = engine.stats()['kv_tiers']
                answers, fig = _window(url, server, da, reqs)
                if not engine._kv_tiers.quiesce(120):  # noqa: SLF001
                    raise AssertionError('tier worker did not drain')
                t1 = engine.stats()['kv_tiers']
                fig['tiers'] = {k: t1[k] - t0[k] for k in (
                    'demotes', 'spills', 'promotes', 'fetches', 'reloads',
                    'corrupt', 'dropped')}
                fig['greedy_parted'] = _greedy_parted(gen_lib, server, reqs,
                                                      answers)
                figs[name] = fig
            tiers = engine.stats()['kv_tiers']
            total = {k: sum(f[k] for f in figs.values())
                     for k in ('evictions', 'launches')}
            r3 = figs['round 3']['tiers']
            if (total['evictions'] < 1 or tiers['demotes'] < 1
                    or tiers['spills'] < 1
                    or r3['promotes'] + r3['fetches'] < 1
                    or tiers['corrupt'] or tiers['quarantined']):
                raise AssertionError(f'tiers under pressure: {figs} '
                                     f'{tiers}')
            kb = _reconciled(engine)
    finally:
        shutil.rmtree(spill, ignore_errors=True)
    del server
    torch.cuda.empty_cache()
    return figs, total, tiers, kb


def paged_phase(srv_lib, gen_lib, da, slot_fig):
    """The paged layout at full width: ``LlmServer('llama3-1b',
    max_len=2048, quantize='int8', kv_cache='int8', kv_layout='paged')``
    with the engine's defaults (16 slots, chunks of 8, pipelined, blocks
    of 16, sharing and tiers on), P1 then P2. Returns K4's launches in
    their checked windows."""
    t0 = time.perf_counter()
    p1 = _paged_p1(srv_lib, gen_lib, da)
    _phase('  P1 done')
    figs, total, tiers, kb = _paged_p2(srv_lib, gen_lib, da)
    keys = ('tok_s', 'host_ms_per_step', 'prefill_ms', 'prefill_bubble_ms',
            'prefill_tokens', 'prefill_tokens_saved', 'tokens', 'wall_s',
            'dispatches', 'launches')
    print('  llama3-1b int8 weights + int8 KV, max_len 2048, the 32-request '
          'window of phase 9: paged P1 (full pool, sharing) | slot layout '
          'with --prefix-cache 8 (phase 9):', flush=True)
    for key in keys:
        print(f'    {key:22s} {p1[key]} | {slot_fig[key]}', flush=True)

    def parted(fig, key='greedy_parted'):
        return (f'{sum(p[0] is None for p in fig[key])} of {len(fig[key])} '
                f'equal, parted at {[p for p in fig[key] if p[0] is not None]}')
    print(f'    share hits {p1["share_hits"]}, hit tokens '
          f'{p1["share_hit_tokens"]}; diverging 4: cow_forks '
          f'{p1["div_cow_forks"]}; greedy vs generate(): window '
          f'{parted(p1)}, diverging {parted(p1, "div_greedy_parted")} '
          f'(limit {GREEDY_GAP_LIMIT}); accounts after drain '
          f'{p1["kv_blocks"]}', flush=True)
    print(f'  P2: --kv-blocks {P2_BLOCKS}, SKYTPU_KV_HOST_BYTES '
          f'{P2_HOST_BYTES}, spill to a temporary directory:', flush=True)
    for name, fig in figs.items():
        print(f'    {name}: {len(fig["greedy_parted"])} greedy '
              f'({parted(fig)}), tok_s {fig["tok_s"]}, host_ms_per_step '
              f'{fig["host_ms_per_step"]}, share hits {fig["share_hits"]} '
              f'({fig["share_hit_tokens"]} tokens), evictions '
              f'{fig["evictions"]}, prefill_tokens {fig["prefill_tokens"]}, '
              f'saved {fig["prefill_tokens_saved"]}, tiers {fig["tiers"]}',
              flush=True)
    print(f'    tiers at the end {tiers}; accounts after drain {kb}; K4 '
          f'launches = n_layers x chunk_steps x dispatches in every '
          f'window; phase '
          f'11 took {time.perf_counter() - t0:.1f} s', flush=True)
    return p1['launches'] + total['launches']


# -- phase 10: the llama-finetune recipe --------------------------------------

# examples/llama_finetune.yaml's command line on the port (llama3-1b, global
# batch 8, seq 2048, Adafactor, remat 'full' by default); its --steps 2000
# and --save-every 50 are cut per call below.
FINETUNE_ARGV = ['--model', 'llama3-1b', '--global-batch-size', '8',
                 '--seq-len', '2048', '--log-every', '1']
CKPT_DIR = '_ckpt_smoke'  # under the checkout; removed when phase 10 ends


class _Tee:
    """Echo stdout and keep what was written."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def _recipe_main(train_run, argv):
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        out = train_run.main(FINETUNE_ARGV + argv)
    return out, ''.join(tee.parts)


def _same_state(a, b):
    """Leaves not bit-equal between two train states, and each state's
    checksum (float64 sum over every leaf)."""
    from skypilot_tpu_torch.ckpt import snapshot
    la, _ = snapshot.flatten_named(a)
    lb, _ = snapshot.flatten_named(b)
    if [x.name for x in la] != [x.name for x in lb]:
        raise AssertionError('train states of different layouts')
    differ = [x.name for x, y in zip(la, lb)
              if not (torch.equal(x.value, y.value)
                      if isinstance(x.value, torch.Tensor)
                      else x.value == y.value)]

    def checksum(leaves):
        return sum(float(x.value.detach().double().sum())
                   if isinstance(x.value, torch.Tensor)
                   else float(x.value or 0) for x in leaves)
    return differ, checksum(la), checksum(lb)


def _ckpt_records(spool, op):
    from skypilot_tpu_torch.observability import train_telemetry
    return [r for r in train_telemetry.read_records(spool)
            if r.get('kind') == 'ckpt' and r['op'] == op]


def _windows(spool):
    from skypilot_tpu_torch.observability import train_telemetry
    return [(r['step'], r['step_time_s'] * 1e3, r['tokens_per_s'],
             r.get('mfu')) for r in train_telemetry.read_records(spool)
            if 'kind' not in r]


def _preempt_and_relaunch(manifest, root, env, layers=None):
    """The recipe in a subprocess, SIGTERM after the line 'step 4/10',
    then a relaunch to 5 steps. Returns the newest committed step after
    the exit, what the SIGTERM handler reported (durable step or None,
    seconds), and the seconds from SIGTERM to exit."""
    here = os.path.dirname(os.path.abspath(__file__))
    spool = os.path.join(root, 'blackbox')
    env = dict(env, PYTHONPATH=here, SKYTPU_BLACKBOX_DIR=spool)
    if layers is not None:
        env.update(_depth_env(root, 'llama3-1b', layers))
    bucket = os.path.join(root, 'd3')
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.train.run',
           *FINETUNE_ARGV, '--save-every', '3', '--ckpt-dir', bucket,
           '--ckpt-local-dir', os.path.join(root, 'd3_local')]
    proc = subprocess.Popen(cmd + ['--steps', '10'], cwd=here, env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    watchdog = threading.Timer(420, proc.kill)
    watchdog.start()
    lines, sent = [], None
    try:
        for line in proc.stdout:
            lines.append(line)
            print('    | ' + line.rstrip(), flush=True)
            if sent is None and '[train] step 4/10' in line:
                proc.send_signal(signal.SIGTERM)
                sent = time.perf_counter()
        rc = proc.wait(timeout=60)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
    exit_s = time.perf_counter() - sent if sent else None
    if sent is None or rc != 143:
        raise AssertionError(f'preempted recipe: exit {rc} (want 143), '
                             f'SIGTERM sent: {sent is not None}')
    m = re.search(r'emergency persist returned step (\w+) in ([\d.]+) s',
                  ''.join(lines))
    if m is None:
        raise AssertionError('preempted recipe: no line from the SIGTERM '
                             'handler')
    committed = manifest.committed_steps(bucket)
    if not committed or committed[-1][0] < 3:
        raise AssertionError(f'preempted recipe: newest committed step in '
                             f'{bucket} is {committed}, want 3 or later')
    durable = committed[-1][0]
    # The handler's sigterm bundle (checked in phase 16d), and when the
    # durable step's commit marker landed.
    names = sorted(n for n in os.listdir(spool) if n.startswith('incident-')
                   and n.endswith('-sigterm.json'))
    if len(names) != 1:
        raise AssertionError(f'preempted recipe: sigterm bundles {names}')
    with open(os.path.join(spool, names[0]), encoding='utf-8') as f:
        bundle = json.load(f)
    bundle_fig = {'bundle': bundle, 'step': durable,
                  'commit_mtime': os.path.getmtime(os.path.join(
                      committed[-1][1], manifest.COMMIT_FILE))}
    relaunch = subprocess.run(cmd + ['--steps', '5'], cwd=here, env=env,
                              capture_output=True, text=True, timeout=420,
                              check=False)
    for line in relaunch.stdout.splitlines():
        print('    | ' + line, flush=True)
    if relaunch.returncode != 0 or \
            f'[train] resumed from checkpoint step {durable}' \
            not in relaunch.stdout:
        raise AssertionError(f'relaunch: exit {relaunch.returncode}, '
                             f'stderr {relaunch.stderr[-2000:]}')
    return durable, (m.group(1), float(m.group(2))), exit_s, bundle_fig


def finetune_phase(llama, fa, train_run, manifest, layers=None):
    """The llama-finetune recipe through train.run with checkpoints: A
    trains 4 steps saving at 2 and 4 (async); B resumes to 6; C runs 6
    uninterrupted with --ckpt-sync, saving at 3 and 6. B's losses and
    final state must equal C's bit for bit, A's losses C's first four.
    Then the recipe in a subprocess is preempted and relaunched, and
    every committed step passes a deep verify. Returns K1-K3's launches
    over A, B and C, and the preempted run's sigterm bundle (phase
    16d). ``layers``: llama3-1b at that depth in the subprocesses too
    (the caller cuts the preset in this one)."""
    root = os.path.abspath(CKPT_DIR)
    shutil.rmtree(root, ignore_errors=True)
    spool = os.path.join(root, 'telemetry')
    saved_env = {k: os.environ.get(k) for k in
                 ('SKYTPU_TRAIN_TELEMETRY_DIR', 'SKYTPU_PEAK_FLOPS')}
    os.environ.update(SKYTPU_TRAIN_TELEMETRY_DIR=spool,
                      SKYTPU_PEAK_FLOPS=str(H100_BF16_DENSE_FLOPS))
    d1, d2 = os.path.join(root, 'd1'), os.path.join(root, 'd2')
    try:
        for counter in ('fwd_launches', 'bwd_dq_launches',
                        'bwd_dkv_launches'):
            setattr(fa.flash_attention, counter, 0)
        torch.cuda.reset_peak_memory_stats()
        a, _ = _recipe_main(train_run, ['--steps', '4', '--save-every', '2',
                                        '--ckpt-dir', d1])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        a_losses = a['losses']
        del a
        b, text = _recipe_main(train_run, ['--steps', '6', '--save-every',
                                           '2', '--ckpt-dir', d1])
        if '[train] resumed from checkpoint step 4' not in text:
            raise AssertionError('call B did not resume from step 4')
        c, _ = _recipe_main(train_run, ['--steps', '6', '--save-every', '3',
                                        '--ckpt-sync', '--ckpt-dir', d2])
        launches = {name: getattr(fa.flash_attention, counter)
                    for name, (_, counter, _) in FLASH.items()}
        model = FINETUNE_ARGV[FINETUNE_ARGV.index('--model') + 1]
        layers, steps = llama.PRESETS[model].n_layers, 4 + 2 + 6
        expected = {'flash_fwd': 2 * layers * steps,
                    'flash_bwd_dq': layers * steps,
                    'flash_bwd_dkv': layers * steps}
        if launches != expected:
            raise AssertionError(f'finetune launches {launches}, expected '
                                 f'{expected}')
        if a_losses != c['losses'][:4] or b['losses'] != c['losses'][4:]:
            raise AssertionError(f'losses: A {a_losses}, B {b["losses"]}, '
                                 f'C {c["losses"]}')
        if not all(math.isfinite(x) for x in c['losses']):
            raise AssertionError(f'losses {c["losses"]}')
        differ, sum_b, sum_c = _same_state(b['state'], c['state'])
        if differ:
            raise AssertionError(f'resumed state differs from the '
                                 f'uninterrupted one in {differ[:8]}')
        b_losses = b['losses']
        del b, c
        torch.cuda.empty_cache()
        print(f'  A/B/C: losses {a_losses} + resumed at 4 {b_losses} '
              f'equal C bit for bit; state '
              f'checksum {sum_b!r} = {sum_c!r}; peak device memory '
              f'{peak:.2f} GiB; launches {launches} = expected', flush=True)
        for step, ms, tok_s, mfu in _windows(spool):
            print(f'    window step {step}: {ms:.1f} ms, {tok_s:.0f} '
                  f'tokens/s, mfu {mfu}', flush=True)
        for rec in _ckpt_records(spool, 'save'):
            print(f'    save step {rec["step"]}: async {rec["async"]}, '
                  f'{rec["nbytes"]} bytes, stall {rec["stall_s"]} s, '
                  f'persist {rec["seconds"]} s', flush=True)
        for rec in _ckpt_records(spool, 'restore'):
            print(f'    restore step {rec["step"]} ({rec["source"]}): '
                  f'{rec["seconds"]} s', flush=True)
        verified = _verify_all(manifest, (d1, d2))
        shutil.rmtree(d1)
        shutil.rmtree(d2)
        _phase('  preempt and relaunch')
        sub_spool = os.path.join(root, 'telemetry_sub')
        durable, handler, exit_s, bundle_fig = _preempt_and_relaunch(
            manifest, root,
            dict(os.environ, SKYTPU_TRAIN_TELEMETRY_DIR=sub_spool), layers)
        for rec in _ckpt_records(sub_spool, 'save'):
            print(f'    subprocess save step {rec["step"]}: stall '
                  f'{rec["stall_s"]} s, persist and mirror '
                  f'{rec["seconds"]} s', flush=True)
        restores = _ckpt_records(sub_spool, 'restore')
        verified += _verify_all(manifest, (os.path.join(root, 'd3'),
                                           os.path.join(root, 'd3_local')))
        print(f'  preempted after step 4: exit 143, step {durable} '
              f'committed; the handler\'s emergency persist returned step '
              f'{handler[0]} in {handler[1]} s; SIGTERM to exit '
              f'{exit_s:.3f} s; relaunch resumed at {durable} (restore '
              f'{[(r["step"], r["source"], r["seconds"]) for r in restores]}'
              f'); {verified} committed steps pass verify_step(deep=True)',
              flush=True)
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
    return launches, bundle_fig


def _verify_all(manifest, roots):
    n = 0
    for root in roots:
        for step, path in manifest.committed_steps(root):
            t0 = time.perf_counter()
            report = manifest.verify_step(path, deep=True)
            if not report['ok']:
                raise AssertionError(f'verify_step {path}: '
                                     f'{report["errors"]}')
            print(f'    verify_step(deep=True) {path}: ok, '
                  f'{report["nbytes"]} bytes in '
                  f'{time.perf_counter() - t0:.2f} s', flush=True)
            n += 1
    return n


# -- phase 12: the lora-finetune recipe ------------------------------------

# examples/llm/lora-finetune/lora_finetune.yaml's command line on the port
# (BENCH_1B, global batch 16, seq 2048, --mesh fsdp=-1, rank 16, alpha 32,
# targets wq,wk,wv,wo; Adafactor and remat 'full' by default); its --steps
# 2000 and --save-every 50 are cut per call below.
LORA_ARGV = ['--model', 'bench-1b', '--global-batch-size', '16',
             '--seq-len', '2048', '--mesh', 'fsdp=-1', '--lora-rank', '16',
             '--lora-alpha', '32', '--lora-targets', 'wq,wk,wv,wo',
             '--log-every', '1']
LORA_CKPT_DIR = '_ckpt_lora_smoke'  # under the checkout; removed at the end
LORA_LAYER_VALUES = 229_376  # a layer's adapters at rank 16 on BENCH_1B


def lora_phase(llama, fa, train_run, lora_lib, trainer_lib):
    """The lora-finetune recipe through train.run with checkpoints: A
    trains 4 steps saving at 2 and 4 (async); B resumes to 6; C runs 6
    uninterrupted in a fresh dir (sync saves at 3 and 6). A's losses must
    equal C's first four, B's C's last two, B's final state (adapters,
    optimizer state, base) C's bit for bit; the base after 6 steps equals
    the initial weights bit for bit; the adapters hold 229,376 values a
    layer (4,128,768 at all 18) and the optimizer state is under half the
    base's size. Returns K1-K3's launches over A, B and C (2 x L / L / L
    per step, L the preset's layers)."""
    from skypilot_tpu_torch.ckpt import snapshot
    root = os.path.abspath(LORA_CKPT_DIR)
    shutil.rmtree(root, ignore_errors=True)
    spool = os.path.join(root, 'telemetry')
    d1, d2 = os.path.join(root, 'd1'), os.path.join(root, 'd2')

    def run(argv):
        tee = _Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            out = train_run.main(LORA_ARGV + argv)
        return out, ''.join(tee.parts)
    with _env(SKYTPU_TRAIN_TELEMETRY_DIR=spool,
              SKYTPU_PEAK_FLOPS=H100_BF16_DENSE_FLOPS):
        try:
            for counter in ('fwd_launches', 'bwd_dq_launches',
                            'bwd_dkv_launches'):
                setattr(fa.flash_attention, counter, 0)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            a, _ = run(['--steps', '4', '--save-every', '2', '--ckpt-dir', d1])
            a_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            a_losses, a_ms = a['losses'], a['window_step_ms']
            del a
            b, text = run(['--steps', '6', '--save-every', '2', '--ckpt-dir',
                           d1])
            if '[train] resumed from checkpoint step 4' not in text:
                raise AssertionError('call B did not resume from step 4')
            c, _ = run(['--steps', '6', '--save-every', '3', '--ckpt-sync',
                        '--ckpt-dir', d2])
            launches = {name: getattr(fa.flash_attention, counter)
                        for name, (_, counter, _) in FLASH.items()}
            layers, steps = llama.PRESETS['bench-1b'].n_layers, 4 + 2 + 6
            expected = {'flash_fwd': 2 * layers * steps,
                        'flash_bwd_dq': layers * steps,
                        'flash_bwd_dkv': layers * steps}
            if launches != expected:
                raise AssertionError(f'lora launches {launches}, expected '
                                     f'{expected}')
            if a_losses != c['losses'][:4] or b['losses'] != c['losses'][4:]:
                raise AssertionError(f'losses: A {a_losses}, B {b["losses"]}, '
                                     f'C {c["losses"]}')
            if not all(math.isfinite(x) for x in c['losses']):
                raise AssertionError(f'losses {c["losses"]}')
            differ, sum_b, sum_c = _same_state(b['state'], c['state'])
            if differ:
                raise AssertionError(f'resumed LoRA state differs from the '
                                     f'uninterrupted one in {differ[:8]}')
            # The initial state, as Trainer.init_state(seed=0) draws it.
            init = llama.init_params(llama.PRESETS['bench-1b'], torch.Generator(
                device='cuda').manual_seed(0), 'cuda')
            lora0 = lora_lib.init_lora(
                torch.Generator(device='cuda').manual_seed(
                    trainer_lib.fold_in(0, 1)), init,
                lora_lib.LoraConfig(rank=16, alpha=32.0,
                                    targets=('wq', 'wk', 'wv', 'wo')),
                device='cuda')
            if not all(torch.equal(x, y) for x, y in zip(
                    _flat(c['state']['params']), _flat(init))):
                raise AssertionError('LoRA moved base weights')
            lora_moved = max(float((x.float() - y.float()).abs().max())
                             for x, y in zip(_flat(c['state']['lora']),
                                             _flat(lora0)))
            if not lora_moved > 0:
                raise AssertionError('LoRA left the adapters unchanged')
            del init, lora0
            adapter_values = lora_lib.param_count(c['state']['lora'])
            base_values = sum(x.numel() for x in _flat(c['state']['params']))
            opt_values = sum(int(np.prod(lf.shape)) for lf in
                             snapshot.flatten_named(c['state'])[0]
                             if lf.name.startswith("['opt_state']"))
            if adapter_values != LORA_LAYER_VALUES * layers or \
                    not opt_values < base_values / 2:
                raise AssertionError(f'adapters {adapter_values} values (want '
                                     f'{LORA_LAYER_VALUES * layers}), optimizer state '
                                     f'{opt_values} against base {base_values}')
            b_losses = b['losses']
            del b, c
            torch.cuda.empty_cache()
            windows = _windows(spool)
            # The median window: saves (a sync one stalls a step) land in
            # a few of them.
            median = sorted(windows, key=lambda w: w[1])[len(windows) // 2]
            print(f'  A/B/C: losses {a_losses} + resumed at 4 {b_losses} '
                  f'equal C bit for bit; state checksum {sum_b!r} = {sum_c!r}; '
                  f'base bit for bit the initial weights; adapters '
                  f'{adapter_values} values, moved up to {lora_moved} (warmup '
                  f'100: the LR is still small), '
                  f'optimizer state {opt_values} values against a base of '
                  f'{base_values}; A took {a_s:.1f} s (step ms {a_ms}); peak '
                  f'device memory {peak:.2f} GiB; launches {launches} = '
                  'expected', flush=True)
            for step, ms, tok_s, mfu in windows:
                print(f'    window step {step}: {ms:.1f} ms, {tok_s:.0f} '
                      f'tokens/s, mfu {mfu} (6 N T accounting of the JAX '
                      'trainer)', flush=True)
            for rec in _ckpt_records(spool, 'save'):
                print(f'    save step {rec["step"]}: async {rec["async"]}, '
                      f'{rec["nbytes"]} bytes, stall {rec["stall_s"]} s, '
                      f'persist {rec["seconds"]} s', flush=True)
            print(f'  lora-finetune median step of {len(windows)}: '
                  f'{median[1]:.1f} ms, {median[2]:.0f} tokens/s, mfu '
                  f'{median[3]}', flush=True)
        finally:
            shutil.rmtree(root, ignore_errors=True)
    return launches


# -- phase 13: speculative decoding, bench-1b with the bench-draft --------------


SPEC_K = 4  # SKYTPU_LLM_SPEC_K, the replica's default


@contextlib.contextmanager
def _env(**values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _get(url, path):
    with urllib.request.urlopen(f'{url}{path}', timeout=60) as r:
        return json.loads(r.read())


def _spec_engine_window(srv_lib, gen_lib, da, engine_fig):
    """bench-1b with --draft-model bench-draft in the default engine, over
    HTTP: phase 8's traffic, then one stream. K4 launched 4 x (k+1) x
    rounds times (the draft's steps; the verify is the einsum path);
    greedy answers under the gap rule; /health's speculative block."""
    server = srv_lib.LlmServer('bench-1b', max_len=1024,
                               draft_model='bench-draft')
    cfg, engine = server.cfg, server.engine
    d_layers = server.draft_cfg.n_layers
    with _served(server) as url:
        reqs, stream_req = _engine_traffic(cfg.vocab_size)
        for body in ({'tokens': [[1] * 8], 'max_new_tokens': 2},
                     dict(reqs[0], max_new_tokens=9)):  # warm-up
            _post(url, body)
        _idle(engine)
        r0 = engine.stats()['speculative']['rounds']
        da.flash_decode.launches = 0
        t0 = time.perf_counter()
        answers = _post_all(url, reqs)
        wall = time.perf_counter() - t0
        _idle(engine)
        window = engine.stats()['speculative']['rounds'] - r0
        status, lines = _post_stream(url, stream_req)
        _idle(engine)
        launches = da.flash_decode.launches
        health = _get(url, '/health')
        spec = health['engine']['speculative']
        rounds = spec['rounds'] - r0
        expected = d_layers * (SPEC_K + 1) * rounds
        if launches != expected or rounds == 0:
            raise AssertionError(f'flash_decode launched {launches} times '
                                 f'over {rounds} rounds; expected '
                                 f'{expected}')
        if not (spec['k'] == SPEC_K and spec['proposals'] > 0
                and spec['accepted'] >= 0
                and health['draft_model'] == 'bench-draft'
                and health['engine']['pipeline']['pipeline_depth'] == 0):
            raise AssertionError(f'/health: {health}')
        _check_answers(reqs, answers, cfg.vocab_size)
        streamed = _check_stream(url, stream_req, status, lines)
        parted = [_check_greedy(gen_lib, server, r['tokens'][0],
                                a[1]['tokens'][0], False)
                  for r, a in zip(reqs, answers) if 'temperature' not in r]
        tokens = sum(len(a[1]['tokens'][0]) for a in answers)
        print(f'  bench-1b + bench-draft (k {SPEC_K}), bf16 + bf16 KV, '
              f'default engine (16 slots, serial rounds): {len(reqs)} '
              f'concurrent requests, {tokens} tokens in {wall:.2f} s = '
              f'{tokens / wall:.1f} tok/s, {window} rounds '
              f'({wall * 1e3 / max(window, 1):.2f} host ms a round); '
              f'acceptance {spec["acceptance_rate"]:.4f} ({spec["accepted"]}'
              f' of {spec["proposals"]} proposals, random weights); phase 8 '
              f'bf16 in this call: {engine_fig["tok_s"]:.1f} tok/s, '
              f'{engine_fig["step_ms"]:.2f} host ms a decode step; stream '
              f'of {len(lines) - 1} lines = the request not streamed; '
              f'flash_decode launches {launches} = {d_layers} draft layers '
              f'x (k+1) x {rounds} rounds; greedy vs generate(): '
              f'{sum(p[0] is None for p in parted)} of {len(parted)} equal, '
              f'parted at (position, top-2 gap) '
              f'{[p for p in parted if p[0] is not None]} (limit '
              f'{GREEDY_GAP_LIMIT}); /health speculative {spec}',
              flush=True)
    del server
    torch.cuda.empty_cache()
    return launches


def _spec_window_path(srv_lib, gen_lib, da):
    """--engine off with the draft: one request of 4 greedy rows of 128
    tokens, 64 new each, through generate_speculative; each row under the
    gap rule against generate(), verifies > 0, K4 = 4 x (k+1) x verifies."""
    server = srv_lib.LlmServer('bench-1b', max_len=1024, engine='off',
                               draft_model='bench-draft')
    cfg = server.cfg
    rng = np.random.default_rng(11)
    rows = [rng.integers(0, cfg.vocab_size, 128).tolist() for _ in range(4)]
    with _served(server) as url:
        _post(url, {'tokens': [[1] * 8], 'max_new_tokens': 4})  # warm-up
        before = _get(url, '/health')['speculative']
        da.flash_decode.launches = 0
        t0 = time.perf_counter()
        status, body = _post(url, {'tokens': rows, 'max_new_tokens': 64})
        wall = time.perf_counter() - t0
        launches = da.flash_decode.launches
        spec = _get(url, '/health')['speculative']
        verifies = spec['verifies'] - before['verifies']
        if status != 200 or verifies <= 0 or \
                spec['requests'] - before['requests'] != 1:
            raise AssertionError(f'window path with a draft: {status}, '
                                 f'speculative {before} -> {spec}')
        expected = server.draft_cfg.n_layers * (SPEC_K + 1) * verifies
        if launches != expected:
            raise AssertionError(f'flash_decode launched {launches} times '
                                 f'over {verifies} verifies; expected '
                                 f'{expected}')
        _check_answers([{'max_new_tokens': 64}] * 4,
                       [(status, {'tokens': [r]}) for r in body['tokens']],
                       cfg.vocab_size)
        parted = [_check_greedy(gen_lib, server, row, got, False)
                  for row, got in zip(rows, body['tokens'])]
    print(f'  window path (--engine off) + bench-draft: 4 greedy rows x '
          f'(128 + 64) in {wall:.2f} s = {4 * 64 / wall:.1f} tok/s, '
          f'{verifies} verifies, acceptance {spec["acceptance_rate"]}; '
          f'flash_decode launches {launches} = '
          f'{server.draft_cfg.n_layers} draft layers x (k+1) x verifies; vs '
          f'generate(): {sum(p[0] is None for p in parted)} of 4 equal, '
          f'parted at {[p for p in parted if p[0] is not None]}',
          flush=True)
    del server
    torch.cuda.empty_cache()


def _spec_identical_draft(llama, engine_lib):
    """An engine whose draft is its target (bench-draft as both, bf16):
    8 greedy requests of 128 + 64; acceptance at least 0.9 (not 1: the
    draft's K4 steps and the verify's einsum round bf16 differently)."""
    cfg = llama.BENCH_DRAFT
    params = llama.init_params(cfg, torch.Generator(
        device='cuda').manual_seed(0), 'cuda')
    eng = engine_lib.ContinuousEngine(params, cfg, max_len=1024,
                                      draft_params=params, draft_cfg=cfg,
                                      spec_k=SPEC_K)
    rng = np.random.default_rng(12)
    try:
        t0 = time.perf_counter()
        futs = [eng.submit(rng.integers(0, cfg.vocab_size, 128).tolist(), 64)
                for _ in range(8)]
        outs = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        spec = eng.stats()['speculative']
    finally:
        eng.stop()
    if not all(len(o) == 64 for o in outs) or \
            not spec['acceptance_rate'] >= 0.9:
        raise AssertionError(f'identical draft: speculative {spec}')
    print(f'  bench-draft as its own draft (k {SPEC_K}): 8 x (128 + 64) '
          f'in {wall:.2f} s, {spec["rounds"]} rounds, acceptance '
          f'{spec["acceptance_rate"]:.4f} (limit 0.9)', flush=True)
    del params
    torch.cuda.empty_cache()


def spec_phase(srv_lib, gen_lib, engine_lib, llama, da, engine_fig):
    """Speculative decoding at full width: the engine window, the window
    path, an identical draft. Returns K4's launches in the engine window
    (bf16 cache)."""
    with _env(SKYTPU_LLM_SPEC_K=SPEC_K):
        launches = _spec_engine_window(srv_lib, gen_lib, da, engine_fig)
        _phase('  engine window done')
        _spec_window_path(srv_lib, gen_lib, da)
        _spec_identical_draft(llama, engine_lib)
    return launches


# -- phase 14: mixture of experts (moe-8x1b) ---------------------------------

MOE_TRAIN_STEPS = 3
MOE_TRAIN_ARGV = ['--model', 'moe-8x1b', '--global-batch-size', '2',
                  '--seq-len', '2048', '--steps', str(MOE_TRAIN_STEPS),
                  '--warmup-steps', '1', '--optimizer', 'adafactor',
                  '--remat-policy', 'full', '--log-every', '1']


def _small_moe_cfg(llama):
    """MOE_TINY widened to head_dim 64, float32, capacity factor 1.0: the
    prefill groups and a 16-slot decode step drop choices."""
    return dataclasses.replace(llama.MOE_TINY, d_model=128, n_heads=4,
                               n_kv_heads=2, head_dim=64,
                               dtype=torch.float32,
                               expert_capacity_factor=1.0)


@contextlib.contextmanager
def _router_gaps(moe_lib):
    """Record, over every ``moe_mlp`` call while open, the smallest gap
    between a routed token's k-th and (k+1)-th router probabilities: where
    that gap is within float32 noise, the card and the CPU may route a
    token to different experts. Yields a list whose ``min`` is the gap."""
    mlp, gaps = moe_lib.moe_mlp, []

    def recording(x, params, num_experts, top_k, capacity_factor,
                  token_mask=None, **mesh):
        with torch.no_grad():
            probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                                  @ params['router'], dim=-1)
            top = torch.topk(probs, top_k + 1, dim=-1).values
            gap = top[:, top_k - 1] - top[:, top_k]
            if token_mask is not None:
                gap = gap[token_mask.reshape(-1) > 0]
            if gap.numel():
                gaps.append(gap.min())
        return mlp(x, params, num_experts, top_k, capacity_factor,
                   token_mask=token_mask, **mesh)

    moe_lib.moe_mlp = recording
    try:
        yield gaps
    finally:
        moe_lib.moe_mlp = mlp


def _min_gap(gaps):
    return min(float(g) for g in gaps) if gaps else None


def _run_preloaded(eng, reqs):
    """Every request of ``reqs`` queued before the engine's loop starts,
    so the first admission sees them all and both devices admit the same
    groups into the same slots; returns their tokens."""
    with unittest.mock.patch.object(type(eng), 'start', lambda self: None):
        futs = [eng.submit(row, n) for row, n in reqs]
    type(eng).start(eng)
    try:
        return [f.result(timeout=300) for f in futs]
    finally:
        eng.stop()


def small_moe_phase(llama, moe_lib, gen_lib, engine_lib, trainer_lib,
                    data_lib):
    """14a: a small MoE model (4 experts, top-2, head_dim 64, float32,
    capacity factor 1.0), card against CPU from the same weights:
    ``forward_cached`` prefill and decode logits within 1e-4; the engine
    (16 slots, so a decode step's capacity of 8 binds; slot and paged
    layouts, full and int8 KV; 24 requests that mostly finish mid-chunk)
    token for token; 3 ``Trainer`` steps, losses, ``moe_aux`` and params
    within 1e-4. A failure prints the smallest top-2/top-3 router gap."""
    cfg = _small_moe_cfg(llama)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
    on_card = _tree_to(params, 'cuda')
    rng = np.random.default_rng(5)
    with _router_gaps(moe_lib) as gaps:
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 40)
                                               ).astype(np.int32))
        row_lens = torch.tensor([40, 13, 27], dtype=torch.int32)
        worst = {}
        for kv_quant in (False, True):
            # int8 KV: a value on a rounding boundary may take the next
            # code on one device, which moves a logit by ~1e-4 (phase 4's
            # limit for the dense model is 1e-3 in both modes).
            limit = 1e-3 if kv_quant else 1e-4
            caches = {dev: gen_lib.init_cache(cfg, 3, 64, quantize=kv_quant,
                                              device=dev)
                      for dev in ('cpu', 'cuda')}
            toks, lens = tokens, row_lens
            for _ in range(8):
                logits = {}
                for dev, p in (('cpu', params), ('cuda', on_card)):
                    logits[dev], caches[dev] = gen_lib.forward_cached(
                        p, toks.to(dev), caches[dev], cfg, lens.to(dev))
                err = float((logits['cuda'].cpu() - logits['cpu']
                             ).abs().max())
                worst[kv_quant] = max(worst.get(kv_quant, 0.0), err)
                if not err <= limit:
                    raise AssertionError(
                        f'small MoE logits (int8 KV {kv_quant}): card vs '
                        f'CPU max abs err {err} > {limit}; smallest router '
                        f'top-2/top-3 gap {_min_gap(gaps)}')
                toks = torch.argmax(logits['cpu'], -1).to(torch.int32)[:, None]
                lens = torch.ones(3, dtype=torch.int32)
        reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(2, 40))
                              ).tolist(), int(rng.integers(2, 20)))
                for _ in range(24)]
        out = {}
        for layout in ('slot', 'paged'):
            for kv_quant in (False, True):
                for dev, p in (('cpu', params), ('cuda', on_card)):
                    out[dev] = _run_preloaded(engine_lib.ContinuousEngine(
                        p, cfg, slots=16, max_len=64, chunk_steps=4,
                        kv_layout=layout, kv_quantize=kv_quant,
                        device=dev), reqs)
                if out['cuda'] != out['cpu']:
                    bad = [i for i, (a, b) in enumerate(zip(out['cuda'],
                                                            out['cpu']))
                           if a != b]
                    raise AssertionError(
                        f'small MoE engine ({layout}, int8 KV {kv_quant}): '
                        f'card != CPU for requests {bad}; smallest router '
                        f'top-2/top-3 gap {_min_gap(gaps)}')
        tcfg = trainer_lib.TrainerConfig(model=cfg, global_batch_size=2,
                                         seq_len=200, warmup_steps=1,
                                         learning_rate=1e-2)
        runs = {}
        for dev in ('cpu', 'cuda'):
            trainer = trainer_lib.Trainer(tcfg, device=dev)
            state = trainer.init_state_from_numpy(_tree_to_numpy(params))
            losses, aux = [], []
            for batch in data_lib.synthetic_batches(
                    2, 200, cfg.vocab_size, seed=3, num_batches=3):
                state, metrics = trainer.step(state, batch)
                losses.append(float(metrics['loss']))
                aux.append(float(metrics['moe_aux']))
            runs[dev] = (losses, aux, _flat(state['params']))
    loss_err = max(abs(a - b) for a, b in zip(
        runs['cpu'][0] + runs['cpu'][1], runs['cuda'][0] + runs['cuda'][1]))
    param_err = max(float((a - b.cpu()).abs().max()) for a, b in zip(
        runs['cpu'][2], runs['cuda'][2]))
    if not (loss_err <= 1e-4 and param_err <= 1e-4):
        raise AssertionError(
            f'small MoE training: card vs CPU loss/moe_aux err {loss_err}, '
            f'param err {param_err} (limits 1e-4); smallest router '
            f'top-2/top-3 gap {_min_gap(gaps)}')
    print(f'  small MoE (4 experts, top-2, capacity factor 1.0, head_dim 64, '
          f'fp32): prefill + 7 decode steps, max abs logit err card vs CPU '
          f'{worst[False]} with the float32 KV cache (limit 1e-4), '
          f'{worst[True]} with int8 KV (limit 1e-3); engine (16 slots, '
          f'chunk 4, '
          f'24 requests), slot and paged, full and int8 KV: card == CPU '
          f'token for token; 3 Adafactor steps: losses {runs["cuda"][0]} '
          f'moe_aux {runs["cuda"][1]}, max loss/aux err {loss_err}, max '
          f'param err {param_err} (limits 1e-4); smallest router '
          f'top-2/top-3 probability gap {_min_gap(gaps)}', flush=True)


def moe_engine_phase(srv_lib, gen_lib, da, quantize, kv_cache):
    """14b: ``LlmServer('moe-8x1b', max_len=1024, prefix_cache=8)`` with
    its default engine over HTTP: phase 8's traffic, then one streamed
    request, then a lone greedy request after the traffic left junk in the
    slots. Returns K4's launches and the window's figures."""
    torch.cuda.reset_peak_memory_stats()
    server = srv_lib.LlmServer('moe-8x1b', max_len=1024, quantize=quantize,
                               kv_cache=kv_cache, prefix_cache=8)
    cfg, engine = server.cfg, server.engine
    kv_int8 = kv_cache == 'int8'
    label = f'{quantize or "bf16"} weights + {kv_cache} KV'
    health = server.health()[1]['engine']
    if (health['pipeline']['pipeline_depth'] != 0
            or health['prefix_cache']['slots'] != 0
            or health['prefix_share']['enabled']):
        raise AssertionError(f'moe-8x1b engine: /health shows pipeline '
                             f'{health["pipeline"]}, prefix pool '
                             f'{health["prefix_cache"]}; expected serial and '
                             'no pool')
    with _served(server) as url:
        reqs, stream_req = _engine_traffic(cfg.vocab_size)
        for body in ({'tokens': [[1] * 8], 'max_new_tokens': 2},
                     dict(reqs[0], max_new_tokens=9)):  # warm-up
            _post(url, body)
        answers, fig = _window(url, server, da, reqs)
        # The stream, the same request not streamed, and a lone greedy
        # request: K4 counted over the three.
        d0 = engine.stats()['pipeline']['dispatches']
        da.flash_decode.launches = 0
        status, lines = _post_stream(url, stream_req)
        _idle(engine)
        streamed = _check_stream(url, stream_req, status, lines)
        # A 64-token prompt fills its prefill bucket, so the engine's
        # prefill has the direct path's capacity, and one real token a
        # decode step cannot fill an expert: the gap rule binds.
        rng = np.random.default_rng(8)
        lone = rng.integers(0, cfg.vocab_size, 64).tolist()
        got = _post(url, {'tokens': [lone], 'max_new_tokens': 32})[1]
        _idle(engine)
        dispatches = engine.stats()['pipeline']['dispatches'] - d0
        launches = da.flash_decode.launches
        if launches != cfg.n_layers * engine.chunk_steps * dispatches:
            raise AssertionError(f'flash_decode launched {launches} times '
                                 f'over {dispatches} chunks after the '
                                 'window')
        launches += fig['launches']
        lone_part = _check_greedy(gen_lib, server, lone, got['tokens'][0],
                                  kv_int8)
        parted = 'not compared in int8 mode'
        if not kv_int8:
            parted = [_greedy_part(gen_lib, server, r['tokens'][0],
                                   a[1]['tokens'][0], kv_int8)
                      for r, a in zip(reqs, answers)
                      if 'temperature' not in r]
            parted = (f'{sum(p is None for p in parted)} of {len(parted)} '
                      'equal, parted at (step, top-2 gap) '
                      f'{[(p[0], round(p[1], 4)) for p in parted if p]}')
        s0 = engine.stats()['pipeline']['dispatches']
        busy, kernels = _device_trace(lambda: _post_all(url, reqs))
        steps = (engine.stats()['pipeline']['dispatches'] - s0) \
            * engine.chunk_steps
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f'  moe-8x1b {label}, default engine (16 slots, chunk 8, '
              f'serial; /health pipeline_depth 0, prefix pool 0 slots of 8 '
              f'asked): {len(reqs)} concurrent requests, {fig["tokens"]} '
              f'tokens in {fig["wall_s"]:.2f} s = {fig["tok_s"]:.1f} tok/s, '
              f'{fig["dispatches"]} chunks, {fig["host_ms_per_step"]:.2f} ms '
              f'per decode step on the host clock (admission included); '
              f'stream of {len(lines) - 1} lines = the request not '
              f'streamed; flash_decode launches {launches} = n_layers x '
              f'chunk_steps x dispatches; co-batched greedy vs generate(): '
              f'{parted}; lone greedy '
              f'request after the traffic: parted at {lone_part} (None = '
              f'equal; limit {GREEDY_GAP_LIMIT}); one more window traced: '
              f'device busy share {busy:.1%}, {kernels} device kernels over '
              f'{steps} decode steps ({kernels / max(steps, 1):.0f} a step, '
              f'prefills included); peak device memory {peak:.1f} GiB',
              flush=True)
    del server
    torch.cuda.empty_cache()
    return launches, fig


def moe_window_phase(srv_lib, gen_lib, da):
    """14c: the window path, ``engine='off'``: 4 greedy rows of mixed
    length (17-300) x 64 new tokens in one request. The answer must equal
    a direct ``generate`` of the same padded batch, and K4 must be
    launched n_layers x (max_new - 1) times a generate call. Each row's
    parting from its solo ``generate`` is printed, not held to the gap
    rule: expert capacity is per call (the batch's prefill routes 1,200
    positions, a solo one its own), and a bf16 difference too small to
    matter in a dense model can move a token across a near-tied router
    choice. Returns K4's launches."""
    server = srv_lib.LlmServer('moe-8x1b', max_len=1024, engine='off')
    cfg = server.cfg
    rng = np.random.default_rng(9)
    rows = [rng.integers(0, cfg.vocab_size, n).tolist()
            for n in (17, 300, 96, 211)]
    with _served(server) as url:
        _post(url, {'tokens': [[1] * 8], 'max_new_tokens': 2})  # warm-up
        server.generate_calls.clear()
        da.flash_decode.launches = 0
        t0 = time.perf_counter()
        status, body = _post(url, {'tokens': rows, 'max_new_tokens': 64})
        wall = time.perf_counter() - t0
        launches = da.flash_decode.launches
        calls = list(server.generate_calls)
        expected = sum(cfg.n_layers * (max_new - 1) for _, max_new in calls)
        if status != 200 or launches != expected or not calls:
            raise AssertionError(f'window path: status {status}, '
                                 f'flash_decode launched {launches} times '
                                 f'for generate calls {calls}')
        tokens, lens = gen_lib.pad_prompts(rows, device=server.device)
        direct = gen_lib.generate(server.params, cfg, tokens, 64,
                                  max_len=1024, prompt_lengths=lens).tolist()
        if body['tokens'] != direct:
            raise AssertionError('served rows differ from a direct '
                                 'generate() of the same batch')
        parts = [_greedy_part(gen_lib, server, row, got, False)
                 for row, got in zip(rows, body['tokens'])]
        parts = [None if p is None else (p[0], round(p[1], 4))
                 for p in parts]
    print(f'  moe-8x1b window path (engine off), 4 greedy rows of '
          f'{[len(r) for r in rows]} tokens x 64 new in {len(calls)} '
          f'generate call(s) {calls}: {4 * 64 / wall:.1f} tok/s; equal to a '
          f'direct generate() of the batch; flash_decode launches '
          f'{launches} = n_layers x sum(max_new - 1); each row vs its solo '
          f'generate(): parted at (step, top-2 gap) {parts} (None = '
          f'equal)', flush=True)
    del server
    torch.cuda.empty_cache()
    return launches


def moe_train_phase(llama, fa, train_run, trainer_lib):
    """14d: ``train.run.main`` on moe-8x1b at global batch 2, seq 2048,
    Adafactor, remat 'full', 3 steps: finite losses and ``moe_aux``, the
    router and every expert leaf moved, K1 = 2 x L x 3 and K2 = K3 = L x
    3, L the preset's layers. Returns the launches."""
    cfg = llama.PRESETS['moe-8x1b']
    steps, layers = MOE_TRAIN_STEPS, cfg.n_layers
    for counter in ('fwd_launches', 'bwd_dq_launches', 'bwd_dkv_launches'):
        setattr(fa.flash_attention, counter, 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train_run.main(MOE_TRAIN_ARGV)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {name: getattr(fa.flash_attention, counter)
                for name, (_, counter, _) in FLASH.items()}
    expected = {'flash_fwd': 2 * layers * steps,
                'flash_bwd_dq': layers * steps,
                'flash_bwd_dkv': layers * steps}
    if launches != expected:
        raise AssertionError(f'moe training launches {launches}, expected '
                             f'{expected}')
    losses, aux = out['losses'], out['moe_aux']
    if len(losses) != steps or len(aux) != steps \
            or not all(math.isfinite(x) for x in losses + aux):
        raise AssertionError(f'moe training losses {losses}, moe_aux {aux}')
    windows = out['window_step_ms']  # one step each (--log-every 1)
    trained = out['state']['params']['layers']['moe']
    del out
    torch.cuda.empty_cache()
    init = llama.init_params(cfg, torch.Generator(
        device='cuda').manual_seed(0), 'cuda')['layers']['moe']
    moved = {name: float((trained[name].detach().float()
                          - init[name].float()).abs().max())
             for name in sorted(init)}
    del init, trained
    torch.cuda.empty_cache()
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f'moe training left a leaf unchanged: {moved}')
    tcfg = trainer_lib.TrainerConfig(model=cfg, global_batch_size=2,
                                     seq_len=2048)
    step_s = windows[-1] / 1e3  # the last step, past the warm-up
    mfu = trainer_lib.mfu(tcfg, step_s)
    share = cfg.active_param_count / cfg.param_count
    print(f'  moe-8x1b batch 2 seq 2048 (one card; the recipe runs batch 16 '
          f'on fsdp=2,expert=8), {steps} steps in {wall:.1f} s: losses '
          f'{losses}, moe_aux {aux}; step ms by step {windows}; last step '
          f'{trainer_lib.tokens_per_step(tcfg) / step_s:.0f} tokens/s, '
          f'printed mfu={mfu:.2%} (6 x all {cfg.param_count} params x '
          f'tokens, JAX\'s formula); a token runs through {share:.1%} of the '
          f'params ({cfg.active_param_count}), which gives '
          f'{mfu * share:.2%}; peak device memory {peak:.1f} GiB; router and '
          f'experts moved (max |change| {moved}); launches {launches} = '
          f'expected', flush=True)
    return launches


# -- phase 15: the replica's boot and fleet contract -------------------------------


# 15a boots the replica the way a service starts it. A CPU rehearsal swaps
# in a command that passes device='cpu' and a smaller model.
BOOT_CMD = [sys.executable, '-m', 'skypilot_tpu_torch.serve.llm_server']
BOOT_ARGV = ['--model', 'bench-1b']
BOOT_PROMPT, BOOT_NEW = 128, 16
BOOT_TIMEOUT_S = 300
BOOT_PHASES = ('imports', 'backend_init.plugin_discovery',
               'backend_init.device_enumeration', 'weights_load',
               'jit_warmup', 'ready', 'first_token')
# 15b's flood: the classes in the order sent, batch first, and how many of
# each. 16 slots and a queue of 16: 16 batch requests take the slots, 16
# queue, 4 batch arrivals are refused, and the 12 standard and
# interactive arrivals each displace the newest queued batch request, so
# 4 batch requests are served from the queue, after the others.
FLOOD = (('batch', 36), ('standard', 6), ('interactive', 6))
FLOOD_QUEUE = 16
METRICS_TOKEN = 'phase-15-scrape'


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _http(url, path, body=None, headers=None, timeout=600):
    """(status, headers, body bytes) of one request; HTTP errors too."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f'{url}{path}', data=data,
                                 headers=dict(headers or {}),
                                 method='GET' if body is None else 'POST')
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _boot(label, env, log_dir, vocab):
    """One fresh replica process: poll /health until 200, one greedy
    request (BOOT_PROMPT ids, BOOT_NEW new), then one more as the steady
    state, then SIGTERM, which must drain to exit 0. Returns the
    figures."""
    port = _free_port()
    url = f'http://127.0.0.1:{port}'
    log = open(os.path.join(log_dir, f'boot-{label}.log'), 'w')
    t_spawn = time.monotonic()
    proc = subprocess.Popen(
        BOOT_CMD + BOOT_ARGV + ['--host', '127.0.0.1', '--port', str(port)],
        env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        while True:
            if proc.poll() is not None:
                raise AssertionError(f'boot {label} exited {proc.returncode}'
                                     ' before /health answered')
            if time.monotonic() - t_spawn > BOOT_TIMEOUT_S:
                raise AssertionError(f'boot {label}: no 200 on /health in '
                                     f'{BOOT_TIMEOUT_S} s')
            try:
                if _http(url, '/health', timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            time.sleep(0.05)
        t_ready = time.monotonic()
        rng = np.random.default_rng(15)
        prompts = [rng.integers(0, vocab, BOOT_PROMPT).tolist()
                   for _ in range(2)]
        first = _http(url, '/generate', {'tokens': [prompts[0]],
                                         'max_new_tokens': BOOT_NEW})
        t_first = time.monotonic()
        body = json.loads(first[2])
        if first[0] != 200 or len(body['tokens'][0]) != BOOT_NEW:
            raise AssertionError(f'boot {label}: first answer {first}')
        health = json.loads(_http(url, '/health')[2])
        ttft_first = health['ttft_ms']['p50']
        if _http(url, '/generate', {'tokens': [prompts[1]],
                                    'max_new_tokens': BOOT_NEW})[0] != 200:
            raise AssertionError(f'boot {label}: second request failed')
        steady = json.loads(_http(url, '/health')[2])
        ttft_steady = min(steady['ttft_ms']['p50'], ttft_first)
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=120)
        if code != 0:
            raise AssertionError(f'boot {label}: SIGTERM ended it with '
                                 f'{code}, not a clean drain')
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    return {'health': health, 'wall_to_first_token_s': t_first - t_spawn,
            'wall_to_ready_s': t_ready - t_spawn, 'ttft_first_ms': ttft_first,
            'ttft_steady_ms': ttft_steady}


def _check_boot(label, fig, warm, warmed, program_names):
    health = fig['health']
    cache, report = health['compile_cache'], health['warmup']
    if not cache.get('enabled') or cache['warm'] is not warm:
        raise AssertionError(f'boot {label}: compile_cache {cache}, '
                             f'expected warm {warm}')
    if warmed and (not report.get('covered') or 'error' in report):
        raise AssertionError(f'boot {label}: warm-up {report}')
    if not warmed and report.get('ran'):
        raise AssertionError(f'boot {label}: warm-up ran: {report}')
    cold = health['profile']['cold_start']
    phases = list(cold['phases'])
    want = [p for p in BOOT_PHASES if warmed or p != 'jit_warmup']
    if phases != want or min(cold['phases'].values()) < 0:
        raise AssertionError(f'boot {label}: phases {cold["phases"]}, '
                             f'expected {want} in that order')
    total, wall = sum(cold['phases'].values()), fig['wall_to_first_token_s']
    if abs(total - cold['total_s']) > 1e-2 or abs(total - wall) > 0.05 * wall:
        raise AssertionError(f'boot {label}: phases sum to {total:.3f} s '
                             f'(total_s {cold["total_s"]}), the wall from '
                             f'spawn to the first answer is {wall:.3f} s')
    prof = health['profile']
    names = set(prof['compile']) | set(prof['calls'])
    if not names <= program_names or 'generate.prefill' not in names:
        raise AssertionError(f'boot {label}: profile programs {names} are '
                             'not the JAX package\'s')
    return cold, report


def boot_phase(cache):
    """15a: three fresh replicas through ``python -m
    skypilot_tpu_torch.serve.llm_server`` sharing one empty kernel-build
    cache (``cache``, which phase 16 boots from again), SKYTPU_PROFILE=1:
    A cold, B warm, C warm with SKYTPU_WARMUP=1."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.observability import profiler
    vocab = llama.PRESETS[BOOT_ARGV[BOOT_ARGV.index('--model') + 1]] \
        .vocab_size
    figs = {}
    with tempfile.TemporaryDirectory(prefix='skytpu-boot-') as tmp:
        for label, warm, warmed in (('A', False, False), ('B', True, False),
                                    ('C', True, True)):
            env = dict(os.environ, SKYTPU_PROFILE='1',
                       SKYTPU_COMPILE_CACHE=cache,
                       SKYTPU_WARMUP='1' if warmed else '0',
                       PYTHONPATH=os.pathsep.join(
                           [os.getcwd(), os.environ.get('PYTHONPATH', '')]))
            try:
                fig = _boot(label, env, tmp, vocab)
            except Exception:
                with open(os.path.join(tmp, f'boot-{label}.log')) as f:
                    print(f.read()[-4000:], flush=True)
                raise
            cold, report = _check_boot(label, fig, warm, warmed,
                                       profiler.PROGRAM_NAMES)
            figs[label] = fig
            extra = (f'; warm-up {report["wall_s"]} s, rounds '
                     f'{report["rounds"]}, buckets {report["buckets"]}, '
                     f'covered, new signatures {report["cache_entries"]}, '
                     f'canary {report.get("cache_canary")}'
                     if warmed else '')
            print(f'  boot {label} (kernel cache '
                  f'{"warm" if warm else "cold"}, warm-up '
                  f'{"on" if warmed else "off"}): first request TTFT '
                  f'{fig["ttft_first_ms"]} ms, then {fig["ttft_steady_ms"]} '
                  f'ms; spawn to READY {fig["wall_to_ready_s"]:.2f} s, to '
                  f'the first answer {fig["wall_to_first_token_s"]:.2f} s = '
                  f'ledger {cold["total_s"]} s; phases {cold["phases"]}; '
                  f'compiles {fig["health"]["profile"]["compiles_total"]} '
                  f'({fig["health"]["profile"]["compile_ms_total"]} ms)'
                  f'{extra}; SIGTERM drained to exit 0', flush=True)
    print('  first-request TTFT ms: A (cold cache) '
          f'{figs["A"]["ttft_first_ms"]}, B (warm cache) '
          f'{figs["B"]["ttft_first_ms"]}, C (warm-up) '
          f'{figs["C"]["ttft_first_ms"]}; steady state '
          f'{[figs[k]["ttft_steady_ms"] for k in "ABC"]}', flush=True)
    return figs


def _scrape_families(text):
    """{family: type} of a Prometheus text exposition, by a small parser:
    every sample line must belong to a declared family."""
    families, current = {}, None
    for line in text.splitlines():
        if line.startswith('# TYPE '):
            _, _, name, kind = line.split(' ', 3)
            families[name], current = kind, name
        elif line.startswith('#') or not line.strip():
            continue
        else:
            name = re.match(r'[a-zA-Z_:][a-zA-Z0-9_:]*', line).group(0)
            float(line.rsplit(' ', 1)[1].replace('Inf', 'inf'))
            if current is None or not (
                    name == current or families[current] == 'histogram'
                    and name in (f'{current}_bucket', f'{current}_count',
                                 f'{current}_sum')):
                raise AssertionError(f'/metrics: sample {line!r} outside '
                                     f'its family ({current})')
    return families


def _queue_means(text):
    """{qos_class: (mean s, mean s over the requests that queued)} of
    skytpu_serve_queue_wait_seconds: an immediate grant waits < 1 ms."""
    sums, counts, instant = {}, {}, {}
    for line in text.splitlines():
        m = re.match(r'skytpu_serve_queue_wait_seconds_(sum|count|bucket)'
                     r'\{(.*)\} (\S+)$', line)
        if not m:
            continue
        labels = dict(re.findall(r'(\w+)="([^"]*)"', m.group(2)))
        cls, value = labels['qos_class'], float(m.group(3))
        if m.group(1) == 'sum':
            sums[cls] = value
        elif m.group(1) == 'count':
            counts[cls] = value
        elif labels['le'] == '0.001':
            instant[cls] = value
    return {c: (sums[c] / counts[c], sums[c] / (counts[c] - instant[c])
                if counts[c] > instant[c] else None) for c in counts}


def qos_phase(srv_lib, gen_lib, da, metrics_lib, warmup_lib):
    """15b: ``LlmServer('bench-1b', qos='on')`` behind ``make_httpd`` with
    SKYTPU_QOS_MAX_QUEUE=16: warm-up, then a flood of 48 requests (phase
    8's mix over the classes of FLOOD, batch first). Returns K4's
    launches over the flood."""
    with _env(SKYTPU_QOS_MAX_QUEUE=FLOOD_QUEUE):
        server = srv_lib.LlmServer('bench-1b', max_len=1024, qos='on')
    cfg, engine = server.cfg, server.engine
    report = warmup_lib.run(server)
    if not report['covered'] or 'error' in report:
        raise AssertionError(f'warm-up: {report}')
    classes = [c for c, n in FLOOD for _ in range(n)]
    rng = np.random.default_rng(16)
    reqs = []
    for i, cls in enumerate(classes):
        body = {'tokens': [rng.integers(0, cfg.vocab_size, int(
                    rng.integers(17, 301))).tolist()],
                'max_new_tokens': int(rng.integers(8, 65)),
                'priority': cls}
        if i % 3 == 1:
            body.update(temperature=0.8, top_k=50)
        elif i % 3 == 2:
            body.update(temperature=1.0, top_p=0.9)
        reqs.append(body)
    with _served(server) as url:
        d0 = engine.stats()['pipeline']['dispatches']
        da.flash_decode.launches = 0
        mid = {}
        with concurrent.futures.ThreadPoolExecutor(len(reqs)) as pool:
            futs = []
            for body in reqs:  # in order: batch first
                futs.append(pool.submit(_http, url, '/generate', body))
                time.sleep(0.002)
            # /health while the flood is queued: every body polled must
            # add up, and one must show a queue.
            while not all(f.done() for f in futs):
                polled = json.loads(_http(url, '/health')[2])
                q = polled['queue']
                if q['depth_total'] != (q['pending'] + q['overflow'] +
                                        polled['qos']['queue_depth_total']):
                    raise AssertionError(f'/health queue {q}, qos depth '
                                         f'{polled["qos"]["queue_depth_total"]}')
                if q['depth_total'] > 0 and 'health' not in mid:
                    mid['health'] = polled
                time.sleep(0.01)
            answers = [f.result() for f in futs]
        _idle(engine)
        dispatches = engine.stats()['pipeline']['dispatches'] - d0
        launches = da.flash_decode.launches
        if launches != cfg.n_layers * engine.chunk_steps * dispatches \
                or dispatches == 0:
            raise AssertionError(f'flash_decode launched {launches} times '
                                 f'over {dispatches} chunks')
        health = json.loads(_http(url, '/health')[2])
        qos = health['qos']
        by_class = {c: collections.Counter() for c, _ in FLOOD}
        parted = []
        for req, (status, headers, raw) in zip(reqs, answers):
            body = json.loads(raw)
            by_class[req['priority']][status] += 1
            if status == 200:
                _check_answers([req], [(status, body)], cfg.vocab_size)
                if 'temperature' not in req:
                    parted.append(_check_greedy(
                        gen_lib, server, req['tokens'][0],
                        body['tokens'][0], False))
            elif status == 429:
                if int(headers.get('Retry-After', 0)) < 1 \
                        or not body.get('shed'):
                    raise AssertionError(f'429 without Retry-After: '
                                         f'{headers} {body}')
            elif status != 504:
                raise AssertionError(f'flood answer {status} {body}')
        served = sum(c[200] for c in by_class.values())
        shed = {c: by_class[c][429] for c in by_class}
        evicted = {c: by_class[c][504] for c in by_class}
        if served + sum(shed.values()) + sum(evicted.values()) != len(reqs) \
                or any(qos['classes'][c]['shed'] != shed[c]
                       or qos['classes'][c]['evicted'] != evicted[c]
                       for c in by_class):
            raise AssertionError(f'flood accounts: answers {by_class}, '
                                 f'/health qos {qos}')
        if shed['interactive'] or not shed['batch'] \
                or shed['standard'] > shed['batch']:
            raise AssertionError(f'sheds {shed}: batch must take them first')
        if 'health' not in mid:
            raise AssertionError('no /health polled mid-flood showed a '
                                 'queue')
        q = mid['health']['queue']
        if health['ttft_ms']['count'] != served:
            raise AssertionError(f'ttft_ms {health["ttft_ms"]} after '
                                 f'{served} requests served')
        status, _, text = _http(url, '/metrics')
        families = _scrape_families(text.decode())
        created = {f'{h}_created' for h in metrics_lib.HISTOGRAMS}
        if status != 200 or set(families) - created != set(
                metrics_lib.FAMILY_NAMES) or not set(families) >= created:
            raise AssertionError(f'/metrics {status}: families '
                                 f'{sorted(families)}')
        means = _queue_means(text.decode())
        if not means['interactive'][1] < means['batch'][1]:
            raise AssertionError(f'queue wait means (all, queued) {means}: '
                                 'interactive must wait less than batch')
        with _env(SKYTPU_METRICS_TOKEN=METRICS_TOKEN):
            for path in ('/metrics', '/debug/profile'):
                codes = (_http(url, path)[0], _http(url, path, headers={
                    'Authorization': f'Bearer {METRICS_TOKEN}'})[0])
                if codes != (401, 200):
                    raise AssertionError(f'{path} answered {codes} without '
                                         'and with the scrape token')
        # The gate's own host cost: admit and release one request.
        gate = srv_lib.qos_lib.QosScheduler(max_inflight=16, max_queue=256,
                                            sweep_s=0, tenant_rps=0,
                                            tenant_tps=0)
        t0 = time.perf_counter()
        for _ in range(2000):
            ticket = gate.submit('standard', 'anonymous', est_tokens=64.0)
            gate.release(ticket, generated_tokens=64)
        gate_us = (time.perf_counter() - t0) / 2000 * 1e6
        print(f'  bench-1b, QoS on (16 slots, queue {FLOOD_QUEUE}): '
              f'warm-up {report["wall_s"]} s, {report["rounds"]} rounds, '
              f'covered; flood of {len(reqs)} ({FLOOD}, batch first): '
              f'{served} served, shed {shed}, evicted {evicted}, every 429 '
              f'with Retry-After; mid-flood queue {q}; queue wait s (mean, '
              f'mean of those queued) {means}; ttft_ms {health["ttft_ms"]}; '
              f'/metrics {len(families)} families; scrape token 401/200; '
              f'greedy vs generate(): {sum(p[0] is None for p in parted)} '
              f'of {len(parted)} equal, parted at '
              f'{[p for p in parted if p[0] is not None]}; flash_decode '
              f'launches {launches} = n_layers x chunk_steps x dispatches; '
              f'the gate admits and releases a request in {gate_us:.1f} us '
              'of host time', flush=True)
    del server
    torch.cuda.empty_cache()
    return launches


# -- phase 16: serve-traced: tracing, the recorder, the doctor ---------------

TRACE_TOKEN = 'phase-16-scrape'
DEBUG_ROUTES = ('/debug/traces', '/debug/blackbox', '/debug/exemplars',
                '/debug/alerts')
# Of phase 8's 24 requests, these go streamed and these carry the resume
# header; two malformed bodies ride along.
STREAMED, RESUMED = (1, 6, 11, 16), (4, 9)
MALFORMED = (b'{"tokens": [[1, 2, 3]], "max_new_tokens": ', b'\xff\xfe')
# JAX's child span names under a serve.generate root.
CHILD_SPANS = {'qos.queue_wait', 'serve.prefill', 'serve.decode',
               'serve.decode.chunk', 'serve.stream', 'serve.window'}
LONE_PROMPT, LONE_NEW = 128, 32
OVERHEAD_ROWS, OVERHEAD_PROMPT, OVERHEAD_NEW = 16, 128, 64
DOCTOR_CMD = [sys.executable, '-m', 'skypilot_tpu_torch.utils.cuda_doctor']
LADDER = ('python-started', 'torch-imported', 'backend-init',
          'devices-enumerated', 'first-launch-done')


def _openmetrics(text):
    """Check an OpenMetrics exposition with a small parser: every line a
    HELP/TYPE comment or a sample of the family declared above it, an
    exemplar only on a bucket line, '# EOF' last. Returns {family: trace
    ids of its exemplars}."""
    lines = text.rstrip('\n').split('\n')
    if lines[-1] != '# EOF':
        raise AssertionError(f'OpenMetrics body ends with {lines[-1]!r}')
    kinds, current, exemplars = {}, None, {}
    for line in lines[:-1]:
        if line.startswith('# TYPE '):
            _, _, current, kind = line.split(' ', 3)
            kinds[current] = kind
            continue
        if line.startswith('# HELP '):
            continue
        sample, _, exemplar = line.partition(' # ')
        m = re.match(r'([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$',
                     sample)
        if m is None or current is None:
            raise AssertionError(f'OpenMetrics line {line!r}')
        float(m.group(3).replace('Inf', 'inf'))
        name = m.group(1)
        if name != current and not (kinds[current] == 'histogram' and name in
                                    {f'{current}_{s}' for s in (
                                        'bucket', 'count', 'sum',
                                        'created')}):
            raise AssertionError(f'sample {line!r} outside {current}')
        if exemplar:
            em = re.match(r'\{trace_id="([0-9a-f]{32})"\} (\S+) (\S+)$',
                          exemplar)
            if em is None or not name.endswith('_bucket'):
                raise AssertionError(f'exemplar on {line!r}')
            exemplars.setdefault(current, []).append(em.group(1))
    return exemplars


def _traced_post(url, body, header, resume=False, raw=None):
    """(status, headers, tokens or NDJSON lines or error body) of one
    /generate carrying its own trace header."""
    headers = {'X-SkyTPU-Trace': header, 'Content-Type': 'application/json'}
    if resume:
        headers['X-SkyTPU-Trace-Resume'] = '1'
    data = raw if raw is not None else json.dumps(body).encode()
    req = urllib.request.Request(f'{url}/generate', data=data,
                                 headers=headers, method='POST')
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            status, hdrs, text = r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())
    if body is not None and body.get('stream'):
        return status, hdrs, [json.loads(ln) for ln in text.decode()
                              .splitlines() if ln.strip()]
    return status, hdrs, json.loads(text)


def _check_trace(url, tid, span_id, streamed, auth):
    """The trace of one request: one serve.generate root joined to the
    header's span, children of JAX's names, each inside the root,
    serve.stream exactly when streamed."""
    status, _, raw = _http(url, f'/debug/traces?trace_id={tid}',
                           headers=auth)
    traces = json.loads(raw)['traces'] if status == 200 else None
    if not traces or len(traces) != 1:
        raise AssertionError(f'trace {tid}: {status} {raw[:300]}')
    tr = traces[0]
    roots = [s for s in tr['spans'] if s['name'] == 'serve.generate']
    if len(roots) != 1 or roots[0]['parent_id'] != span_id:
        raise AssertionError(f'trace {tid}: roots {roots}')
    root = roots[0]
    children = [s for s in tr['spans'] if s is not root]
    names = {s['name'] for s in children}
    if not names <= CHILD_SPANS or ('serve.stream' in names) != streamed:
        raise AssertionError(f'trace {tid}: children {sorted(names)}, '
                             f'streamed {streamed}')
    for s in children:
        if s['end'] is None or not (root['start'] - 1e-6 <= s['start']
                                    <= s['end'] <= root['end'] + 1e-6):
            raise AssertionError(f'trace {tid}: {s} outside its root')
    return tr


def traced_phase(srv_lib, gen_lib, da, metrics_lib, trace_lib, blackbox):
    """16a-16c on ``LlmServer('bench-1b')`` with its default engine over
    HTTP, tracing on, SKYTPU_TRACE_TAIL_LATENCY_MS=standard:1 and the
    scrape token set. Returns K4's launches over 16a and 16b."""
    spool = tempfile.mkdtemp(prefix='skytpu-traced-')
    auth = {'Authorization': f'Bearer {TRACE_TOKEN}'}
    try:
        with _env(SKYTPU_TRACE='1', SKYTPU_METRICS_TOKEN=TRACE_TOKEN,
                  SKYTPU_BLACKBOX_DIR=os.path.join(spool, 'blackbox'),
                  SKYTPU_TRACE_EXPORT_DIR=os.path.join(spool, 'traces')):
            server = srv_lib.LlmServer('bench-1b', max_len=1024)
            with _served(server) as url:
                launches = _traced_traffic(srv_lib, gen_lib, da,
                                           metrics_lib, trace_lib, server,
                                           url, auth)
                _lone_requests(server, url)
                launches += _tracing_overhead(server, url, da, blackbox)
                _dump_check(url, auth, spool)
                print(f'  16b: the tracer builds and judges one request\'s '
                      f'trace (a root, 10 spans, 4 exemplars) in '
                      f'{_tracer_us(trace_lib, metrics_lib):.1f} us of host '
                      'time', flush=True)
            del server
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(spool, ignore_errors=True)
    return launches


def _traced_traffic(srv_lib, gen_lib, da, metrics_lib, trace_lib, server,
                    url, auth):
    cfg, engine = server.cfg, server.engine
    reqs, _ = _engine_traffic(cfg.vocab_size)
    for body in ({'tokens': [[1] * 8], 'max_new_tokens': 2},
                 dict(reqs[0], max_new_tokens=9)):  # warm-up
        _post(url, body)
    _idle(engine)
    trace_lib.reset()
    metrics_lib.reset()
    headers = [trace_lib.make_header() for _ in range(len(reqs) +
                                                      len(MALFORMED))]
    bodies = [dict(r, stream=True) if i in STREAMED else r
              for i, r in enumerate(reqs)]
    d0 = engine.stats()['pipeline']['dispatches']
    da.flash_decode.launches = 0
    with _env(SKYTPU_TRACE_TAIL_LATENCY_MS='standard:1'):
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(headers)) as pool:
            futs = [pool.submit(_traced_post, url, b, h, i in RESUMED)
                    for i, (b, h) in enumerate(zip(bodies, headers))]
            futs += [pool.submit(_traced_post, url, None, h, raw=raw)
                     for raw, h in zip(MALFORMED, headers[len(reqs):])]
            answers = [f.result() for f in futs]
        wall = time.perf_counter() - t0
        _idle(engine)
    dispatches = engine.stats()['pipeline']['dispatches'] - d0
    launches = da.flash_decode.launches
    if launches != cfg.n_layers * engine.chunk_steps * dispatches \
            or dispatches == 0:
        raise AssertionError(f'flash_decode launched {launches} times over '
                             f'{dispatches} chunks')
    parted, want = [], collections.Counter()
    for i, (body, header, (status, hdrs, out)) in enumerate(
            zip(bodies + [None] * len(MALFORMED), headers, answers)):
        tid, span_id, _ = trace_lib.parse_header(header)
        if body is None:
            verdict = 'error'
            if status != 400:
                raise AssertionError(f'malformed body answered {status}')
        else:
            verdict = 'resumed' if i in RESUMED else 'slow'
            if body.get('stream'):
                toks = [t for ln in out[:-1] for t in ln['tokens']]
                if status != 200 or out[-1] != {'done': True} \
                        or len(toks) != body['max_new_tokens']:
                    raise AssertionError(f'bad stream {status} {out}')
                out = {'tokens': [toks]}
            _check_answers([body], [(status, out)], cfg.vocab_size)
            if 'temperature' not in body:
                parted.append(_check_greedy(gen_lib, server,
                                            body['tokens'][0],
                                            out['tokens'][0], False))
        tr = _check_trace(url, tid, span_id,
                          bool(body and body.get('stream')), auth)
        got = hdrs.get('X-SkyTPU-Trace-Verdict')
        if tr.get('retained') != verdict or got != (
                None if body and body.get('stream') else verdict):
            raise AssertionError(f'request {i}: retained '
                                 f'{tr.get("retained")}, header {got}, '
                                 f'want {verdict}')
        want[verdict] += 1
    health = json.loads(_http(url, '/health')[2])['trace']
    stats = trace_lib.tail_stats()
    if health.keys() != stats.keys() or health['verdicts'] != dict(want) \
            or health['kept'] != len(answers) or health['pending'] != 0:
        raise AssertionError(f'/health trace {health}, want verdicts '
                             f'{dict(want)}; tail_stats {stats}')
    exemplars = json.loads(_http(url, '/debug/exemplars',
                                 headers=auth)[2])['exemplars']
    ids = {e['trace_id'] for e in exemplars}
    for tid in ids:
        found = json.loads(_http(url, f'/debug/traces?trace_id={tid}',
                                 headers=auth)[2])['count']
        if found != 1:
            raise AssertionError(f'exemplar {tid} resolves to {found}')
    status, hdrs, text = _http(url, '/metrics', headers=dict(
        auth, Accept='application/openmetrics-text; version=1.0.0'))
    om = _openmetrics(text.decode())
    if status != 200 or not hdrs['Content-Type'].startswith(
            'application/openmetrics-text') \
            or not set(om.get('skytpu_serve_ttft_seconds', ())) <= ids \
            or not om.get('skytpu_serve_ttft_seconds'):
        raise AssertionError(f'/metrics OpenMetrics {status} {hdrs}: '
                             f'exemplars {om}')
    alerts = json.loads(_http(url, '/debug/alerts', headers=auth)[2])
    if set(alerts) != {'enabled', 'alerts', 'firing', 'history'}:
        raise AssertionError(f'/debug/alerts {alerts}')
    for path in DEBUG_ROUTES:
        codes = (_http(url, path)[0], _http(url, path, headers=auth)[0])
        if codes != (401, 200):
            raise AssertionError(f'{path} answered {codes} without and '
                                 'with the scrape token')
    tokens = sum(len(o['tokens'][0]) for _, _, o in answers
                 if isinstance(o, dict) and 'tokens' in o)
    print(f'  16a: {len(reqs)} requests ({len(STREAMED)} streamed, '
          f'{len(RESUMED)} resumed) + {len(MALFORMED)} malformed, each with '
          f'its own X-SkyTPU-Trace, in {wall:.2f} s; every answer whole, '
          f'the malformed 400; one serve.generate root each, JAX\'s child '
          f'names inside it, serve.stream on the {len(STREAMED)} streams; '
          f'retained {dict(want)} = /health trace; X-SkyTPU-Trace-Verdict '
          f'on every answer not streamed; {len(ids)} exemplar trace ids '
          f'all resolve; OpenMetrics /metrics parses, # EOF, '
          f'{len(om["skytpu_serve_ttft_seconds"])} exemplars on '
          f'skytpu_serve_ttft_seconds buckets; /debug/alerts '
          f'{alerts}; {DEBUG_ROUTES} 401/200 on the token; greedy vs '
          f'generate(): {sum(p[0] is None for p in parted)} of '
          f'{len(parted)} equal, parted at '
          f'{[p for p in parted if p[0] is not None]}; flash_decode '
          f'launches {launches} = n_layers x chunk_steps x dispatches '
          f'({dispatches}); {tokens} tokens not streamed', flush=True)
    return launches


def _lone_requests(server, url):
    """16b first half: 4 lone greedy requests one at a time, each with
    tracing on, then off: byte-identical answers; prints the mean seconds
    a request took, on and off."""
    rng = np.random.default_rng(161)
    prompts = [rng.integers(0, server.cfg.vocab_size,
                            LONE_PROMPT).tolist() for _ in range(4)]
    answers = {'1': [], '0': []}
    secs = {'1': 0.0, '0': 0.0}
    for p in prompts:
        for flag in ('1', '0'):
            with _env(SKYTPU_TRACE=flag):
                t0 = time.perf_counter()
                answers[flag].append(_http(url, '/generate', {
                    'tokens': [p], 'max_new_tokens': LONE_NEW})[2])
                secs[flag] += (time.perf_counter() - t0) / len(prompts)
    if answers['1'] != answers['0']:
        raise AssertionError('greedy answers differ with tracing on and off')
    print(f'  16b: 4 lone greedy requests ({LONE_PROMPT} + {LONE_NEW}) '
          f'byte-identical with SKYTPU_TRACE 1 and 0; {secs["1"]:.4f} / '
          f'{secs["0"]:.4f} s a request', flush=True)


def _tracing_overhead(server, url, da, blackbox):
    """16b second half: 16 x (128 + 64) greedy at once, tracing off, on,
    off, on, off, on. Prints tok/s and host ms per decode step of each run, and
    how many rows equal the first run's, beside the run's admission groups
    (the sizes of its ``engine.admit`` events on the recorder's ring): in
    bf16 the groups that concurrent arrivals form, and with them the
    prefill's GEMM shapes, differ between runs, so byte identity is the
    lone requests' check. Returns K4's launches."""
    cfg, engine = server.cfg, server.engine
    rng = np.random.default_rng(162)
    reqs = [{'tokens': [rng.integers(0, cfg.vocab_size,
                                     OVERHEAD_PROMPT).tolist()],
             'max_new_tokens': OVERHEAD_NEW} for _ in range(OVERHEAD_ROWS)]
    runs, launches, first = [], 0, None
    for flag in ('0', '1') * 3:
        with _env(SKYTPU_TRACE=flag):
            _idle(engine)
            d0 = engine.stats()['pipeline']['dispatches']
            da.flash_decode.launches = 0
            t_wall = time.time()
            t0 = time.perf_counter()
            answers = _post_all(url, reqs)
            wall = time.perf_counter() - t0
            _idle(engine)
        groups = [e['attrs']['n'] for e in blackbox.events()
                  if e['name'] == 'engine.admit' and e['ts'] >= t_wall]
        if sum(groups) != OVERHEAD_ROWS:
            raise AssertionError(f'admission groups {groups} do not add up '
                                 f'to {OVERHEAD_ROWS} rows')
        chunks = engine.stats()['pipeline']['dispatches'] - d0
        n = da.flash_decode.launches
        if n != cfg.n_layers * engine.chunk_steps * chunks or chunks == 0:
            raise AssertionError(f'flash_decode launched {n} times over '
                                 f'{chunks} chunks')
        launches += n
        _check_answers(reqs, answers, cfg.vocab_size)
        toks = [a[1]['tokens'] for a in answers]
        first = first or toks
        tokens = sum(len(t[0]) for t in toks)
        runs.append((flag, tokens / wall,
                     wall * 1e3 / (chunks * engine.chunk_steps),
                     sum(a == b for a, b in zip(toks, first)), groups))
    print('  16b: 16 x (128 + 64) greedy, tracing ' + '; '.join(
        f'{"on" if f == "1" else "off"} {tok_s:.1f} tok/s, {ms:.2f} host ms '
        f'a decode step, {same} of 16 rows = run 1\'s, admission groups '
        f'{groups}' for f, tok_s, ms, same, groups in runs), flush=True)
    return launches


def _tracer_us(trace_lib, metrics_lib, n=500):
    """The host's cost of one request's tracing, as the replica does it
    after the fact: a joined root, a prefill, a decode and 8 chunk spans,
    four exemplar observations, the root's finalize and retention
    verdict. Microseconds a request."""
    t0 = time.perf_counter()
    for _ in range(n):
        with trace_lib.start_trace('serve.generate', headers={
                'X-SkyTPU-Trace': trace_lib.make_header()}) as root:
            trace_lib.set_attr(rows=1, max_new=64, stream=False)
            now = time.time()
            trace_lib.add_span('serve.prefill', now, now, tokens=1)
            decode = trace_lib.add_span('serve.decode', now, now,
                                        tokens=64, bubble_ms=0.0)
            for _ in range(8):
                trace_lib.add_span('serve.decode.chunk', now, now,
                                   parent=decode, row=0, tokens=8)
            for name, labels in (
                    ('skytpu_serve_ttft_seconds', {}),
                    ('skytpu_serve_phase_seconds', {'phase': 'prefill'}),
                    ('skytpu_serve_phase_seconds', {'phase': 'decode'}),
                    ('skytpu_serve_decode_tok_s', {})):
                metrics_lib.observe_serving(name, 0.1,
                                            trace_id=root.trace_id,
                                            qos_class='standard', **labels)
            trace_lib.set_attr(status=200)
    return (time.perf_counter() - t0) / n * 1e6


def _dump_check(url, auth, spool):
    """16c first part: /debug/blackbox?dump=1 on the traced server."""
    t0 = time.perf_counter()
    status, _, raw = _http(url, '/debug/blackbox?dump=1', headers=auth)
    dump_ms = (time.perf_counter() - t0) * 1e3
    payload = json.loads(raw)
    bundle = payload.get('bundle') or {}
    names = [e['name'] for e in bundle.get('events', ())]
    try:
        admit = names.index('engine.admit')
        dispatch = names.index('engine.dispatch', admit)
        names.index('engine.retire', dispatch)
    except ValueError:
        raise AssertionError(f'bundle ring {names[-20:]}') from None
    with open(payload['dumped'], encoding='utf-8') as f:
        text = f.read()
    if status != 200 or 'trace' not in (bundle.get('health') or {}) \
            or TRACE_TOKEN in text or os.path.dirname(
                payload['dumped']) != os.path.join(spool, 'blackbox'):
        raise AssertionError(f'/debug/blackbox?dump=1: {status}, health '
                             f'{sorted(bundle.get("health") or ())}')
    print(f'  16c: /debug/blackbox?dump=1 in {dump_ms:.1f} ms: '
          f'{len(names)} events (admit, dispatch, retire in order), '
          f'{len(text)} bytes, /health with trace, the scrape token '
          'redacted', flush=True)


def failure_dump_phase(llama, engine_lib, blackbox):
    """16c second part: a separate small engine on the card whose chunk
    dispatch raises: every waiter fails and an engine_failure bundle is
    written."""
    spool = tempfile.mkdtemp(prefix='skytpu-fail-')
    try:
        with _env(SKYTPU_BLACKBOX_DIR=spool):
            gen = torch.Generator(device='cuda').manual_seed(0)
            params = llama.init_params(llama.TINY, gen, 'cuda')
            eng = engine_lib.ContinuousEngine(params, llama.TINY, slots=4,
                                              max_len=64, device='cuda')

            def boom(*_a, **_k):
                raise RuntimeError('injected dispatch fault (phase 16c)')

            eng._dispatch_chunk = boom  # noqa: SLF001
            try:
                futs = [eng.submit([5 + i, 6, 7], 8) for i in range(3)]
                failed = 0
                for fut in futs:
                    try:
                        fut.result(timeout=120)
                    except RuntimeError as e:
                        failed += 'injected' in str(e)
            finally:
                eng.stop()
            bundles = [b for b in blackbox.list_bundles()
                       if b['trigger'] == 'engine_failure']
            if failed != len(futs) or len(bundles) != 1:
                raise AssertionError(f'{failed} of {len(futs)} waiters '
                                     f'failed, bundles {bundles}')
            print(f'  16c: a small engine whose dispatch raises: '
                  f'{failed} of {len(futs)} waiters failed, one '
                  f'engine_failure bundle ({bundles[0]["events"]} events, '
                  f'reason {bundles[0]["reason"]!r})', flush=True)
    finally:
        shutil.rmtree(spool, ignore_errors=True)


def sigquit_phase(kernel_cache, vocab):
    """16c last part: ``python -m skypilot_tpu_torch.serve.llm_server
    --model bench-1b`` on phase 15's warm kernel cache: after one request,
    SIGQUIT writes every thread's stack (the engine's too) and the
    replica keeps serving; SIGTERM drains to exit 0
    with a sigterm bundle whose ring ends with server.drain."""
    from skypilot_tpu_torch.observability import blackbox
    with tempfile.TemporaryDirectory(prefix='skytpu-sigquit-') as tmp:
        spool = os.path.join(tmp, 'blackbox')
        env = dict(os.environ, SKYTPU_BLACKBOX_DIR=spool,
                   SKYTPU_COMPILE_CACHE=kernel_cache,
                   PYTHONPATH=os.pathsep.join(
                       [os.getcwd(), os.environ.get('PYTHONPATH', '')]))
        port = _free_port()
        url = f'http://127.0.0.1:{port}'
        log = open(os.path.join(tmp, 'replica.log'), 'w')
        t0 = time.monotonic()
        proc = subprocess.Popen(
            BOOT_CMD + BOOT_ARGV + ['--host', '127.0.0.1', '--port',
                                    str(port)],
            env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            while True:
                if proc.poll() is not None:
                    raise AssertionError(f'replica exited {proc.returncode}')
                if time.monotonic() - t0 > BOOT_TIMEOUT_S:
                    raise AssertionError('replica: no /health 200')
                try:
                    if _http(url, '/health', timeout=5)[0] == 200:
                        break
                except OSError:
                    pass
                time.sleep(0.05)
            ready_s = time.monotonic() - t0
            prompt = {'tokens': [[int(t) for t in np.arange(16) % vocab]],
                      'max_new_tokens': 8}
            if _http(url, '/generate', prompt)[0] != 200:
                raise AssertionError('replica: first request failed')
            stacks = os.path.join(
                spool, f'sigquit-{proc.pid}-llm_server:colocated.txt')
            proc.send_signal(signal.SIGQUIT)
            deadline = time.monotonic() + 30
            while True:
                text = open(stacks).read() if os.path.exists(stacks) else ''
                if text.count('hread 0x') >= 2 and 'File "' in text:
                    break  # the HTTP loop's and the engine's threads
                if time.monotonic() > deadline:
                    raise AssertionError(f'no thread stacks in {stacks}')
                time.sleep(0.1)
            answer = _http(url, '/generate', prompt)
            if proc.poll() is not None or answer[0] != 200:
                raise AssertionError(f'after SIGQUIT: {answer[0]}')
            t_term = time.monotonic()
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=120)
            exit_s = time.monotonic() - t_term
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        with _env(SKYTPU_BLACKBOX_DIR=spool):
            drains = [b for b in blackbox.list_bundles()
                      if b['trigger'] == 'sigterm' and b['pid'] == proc.pid]
            bundle = blackbox.read_bundle(drains[0]['file']) if drains \
                else {}
        ring = [e['name'] for e in bundle.get('events', ())]
        if code != 0 or len(drains) != 1 or ring[-1:] != ['server.drain']:
            with open(os.path.join(tmp, 'replica.log')) as f:
                print(f.read()[-4000:], flush=True)
            raise AssertionError(f'SIGTERM: exit {code}, sigterm bundles '
                                 f'{drains}, ring ends {ring[-3:]}')
        threads = text.count('hread 0x')
        print(f'  16c: python -m ...llm_server --model bench-1b (warm kernel '
              f'cache) READY in {ready_s:.2f} s; SIGQUIT wrote {threads} '
              f'thread stacks ({len(text)} bytes) and it answered after; '
              f'SIGTERM exit 0 in {exit_s:.2f} s with a sigterm bundle '
              f'whose ring ends with server.drain ({len(ring)} events)',
              flush=True)


def _check_trainer_bundle(fig):
    """16d: phase 10's preempted trainer left a sigterm bundle holding
    ckpt.snapshot / ckpt.commit edges, written after the durable step's
    commit marker."""
    names = [e['name'] for e in fig['bundle']['events']]
    if not {'ckpt.snapshot', 'ckpt.commit'} <= set(names) \
            or fig['bundle']['ts'] < fig['commit_mtime']:
        raise AssertionError(f'trainer sigterm bundle: ring {names}, '
                             f'ts {fig["bundle"]["ts"]} vs commit marker '
                             f'{fig["commit_mtime"]}')
    print(f'  16d: phase 10\'s preempted trainer left one sigterm bundle '
          f'({collections.Counter(names)}), written '
          f'{fig["bundle"]["ts"] - fig["commit_mtime"]:.3f} s after step '
          f'{fig["step"]}\'s commit marker', flush=True)


def doctor_phase():
    """16e: ``python -m skypilot_tpu_torch.utils.cuda_doctor`` on the card,
    with no visible device, and held at a phase past a 1 s deadline."""
    here = os.path.dirname(os.path.abspath(__file__))
    base = dict(os.environ, PYTHONPATH=here)
    with tempfile.TemporaryDirectory(prefix='skytpu-doctor-run-') as tmp:
        cases = (
            ('card', {}),
            ('no device', {'CUDA_VISIBLE_DEVICES': ''}),
            ('held', {'SKYTPU_PROBE_HOLD_FILE': os.path.join(tmp, 'never'),
                      'SKYTPU_PROBE_HOLD_MAX_S': '30',
                      'SKYTPU_PROBE_PHASE_DEADLINE_S': '1'}),
        )
        out = {}
        for label, extra in cases:
            t0 = time.perf_counter()
            r = subprocess.run(DOCTOR_CMD, cwd=here, env=dict(base, **extra),
                               capture_output=True, text=True, timeout=120,
                               check=False)
            secs = time.perf_counter() - t0
            try:
                probe = json.loads(r.stdout)['probe']
            except (ValueError, KeyError):
                raise AssertionError(f'doctor {label}: rc {r.returncode} '
                                     f'{r.stdout[-1000:]} '
                                     f'{r.stderr[-2000:]}') from None
            out[label] = (r.returncode, probe, secs)
    rc, probe, secs = out['card']
    crossed = [p.split(':')[0] for p in probe['phases']]
    if rc != 0 or not probe['ok'] or probe['outcome'] != 'completed' \
            or crossed != list(LADDER) \
            or not probe['phases'][3].endswith(':cuda'):
        raise AssertionError(f'doctor on the card: rc {rc}, {probe}')
    rc, missing, _ = out['no device']
    if rc != 1 or missing['outcome'] != 'no_device' \
            or 'no CUDA device' not in missing['diagnosis'] \
            or 'hung' in missing['diagnosis']:
        raise AssertionError(f'doctor with no device: rc {rc}, {missing}')
    rc, held, held_s = out['held']
    if rc != 1 or held['outcome'] != 'timeout' \
            or 'python-started' not in held['diagnosis'] or held_s > 60:
        raise AssertionError(f'doctor held: rc {rc}, {held_s:.1f} s, {held}')
    print(f'  16e: cuda_doctor on the card: completed in '
          f'{out["card"][2]:.2f} s, ladder {probe["phase_s"]}; with '
          f'CUDA_VISIBLE_DEVICES= : {missing["outcome"]} in '
          f'{out["no device"][2]:.2f} s ({missing["diagnosis"]!r}); held '
          f'past a 1 s phase deadline: {held["outcome"]} in {held_s:.2f} s '
          f'({held["diagnosis"]!r})', flush=True)


# -- phase 17: serve-disagg, the prefill and decode roles ------------------------

DISAGG_LONE = (17, 128, 300, 1984)   # 17a: lone prompts, DISAGG_NEW new each
DISAGG_LONE_INT8 = (17, 128, 300, 900)  # 17b (max_len 1024)
DISAGG_NEW = 64
DISAGG_PREAMBLE = 256   # 16 blocks of 16
DISAGG_PREAMBLES = 4
DISAGG_CONCURRENT = 16
DISAGG_NEG_NEW = 32
JSON_CT = {'Content-Type': 'application/json'}
OCTET_CT = {'Content-Type': 'application/octet-stream'}


def _stream_timed(url, path, data, headers):
    """POST ``data`` to a route that answers NDJSON: (status, lines, seconds
    to the first line, seconds to the end); a refusal's one JSON body is
    its only line."""
    t0 = time.perf_counter()
    req = urllib.request.Request(f'{url}{path}', data=data,
                                 headers=headers, method='POST')
    try:
        resp = urllib.request.urlopen(req, timeout=600)
    except urllib.error.HTTPError as e:
        return e.code, [json.loads(e.read())], None, time.perf_counter() - t0
    lines, first = [], None
    with resp:
        for raw in resp:
            if raw.strip():
                first = first or time.perf_counter() - t0
                lines.append(json.loads(raw))
    return resp.status, lines, first, time.perf_counter() - t0


def _streamed_tokens(status, lines, what):
    if status != 200 or not lines or lines[-1] != {'done': True} \
            or any('error' in ln for ln in lines):
        raise AssertionError(f'{what}: {status} {lines[-2:]}')
    return [t for ln in lines[:-1] for t in ln['tokens']]


def _colocated(url, body):
    """A streamed /generate on the colocated replica: (tokens, TTFT s)."""
    status, lines, first, _ = _stream_timed(
        url, '/generate', json.dumps(dict(body, stream=True)).encode(),
        JSON_CT)
    return _streamed_tokens(status, lines, 'colocated'), first


def _export_fetch(pre_url, dec_url, body):
    """The load balancer's first legs: export, prepare (paged, when the
    prompt has full blocks), fetch with the negotiated ``skip_blocks``.
    Returns (import body, its headers, figures); a failed leg raises."""
    t0 = time.perf_counter()
    status, _, raw = _http(pre_url, '/v1/kv/export', body, JSON_CT)
    if status != 200:
        raise AssertionError(f'export {status}: {raw[:200]!r}')
    exp = json.loads(raw)
    fig = {'t0': t0, 'export_ms': (time.perf_counter() - t0) * 1e3,
           'full_bytes': exp['nbytes'], 'full_blocks': exp['full_blocks'],
           'skip': 0, 'fetch_ms': 0.0}
    if 'staging_ref' in exp:
        fig['bytes'] = exp['nbytes']
        return (json.dumps({'staging_ref': exp['staging_ref']}).encode(),
                JSON_CT, fig)
    if exp['full_blocks']:
        status, _, raw = _http(dec_url, '/v1/kv/prepare',
                               {'tokens': body['tokens']}, JSON_CT)
        if status != 200:
            raise AssertionError(f'prepare {status}: {raw[:200]!r}')
        fig['skip'] = min(int(json.loads(raw)['skip_blocks']),
                          exp['full_blocks'])
    t1 = time.perf_counter()
    status, _, data = _http(pre_url, f'/v1/kv/fetch?handoff='
                            f'{exp["handoff"]}&skip_blocks={fig["skip"]}')
    if status != 200:
        raise AssertionError(f'fetch {status}: {data[:200]!r}')
    fig['fetch_ms'] = (time.perf_counter() - t1) * 1e3
    fig['bytes'] = len(data)
    return data, OCTET_CT, fig


def _handoff(pre_url, dec_url, body):
    """export -> prepare -> fetch(skip_blocks) -> import?stream=1, as the
    load balancer runs them. Returns (tokens, figures): each leg's ms
    (import: to its first line, i.e. parse, checks, install and the first
    token), the payload bytes, the handoff rate over fetch + import, TTFT
    from the export's start, and the decode seconds after the first
    line. Any failed leg raises: there is no colocated retry here."""
    return _import_leg(dec_url, *_export_fetch(pre_url, dec_url, body))


def _import_leg(dec_url, data, headers, fig):
    """The last leg, ``/v1/kv/import?stream=1``: (tokens, figures)."""
    status, lines, first, end = _stream_timed(
        dec_url, '/v1/kv/import?stream=1', data, headers)
    tokens = _streamed_tokens(status, lines, 'import')
    fig['import_ms'] = first * 1e3
    fig['ttft_ms'] = (time.perf_counter() - end + first - fig['t0']) * 1e3
    fig['decode_s'] = end - first
    fig['gb_s'] = fig['bytes'] / ((fig['fetch_ms'] + fig['import_ms'])
                                  * 1e6)
    fig['payload'] = data if headers is OCTET_CT else None
    return tokens, fig


def _words(t):
    """A device plane's storage, on the host (bf16 as uint16 words)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _prompt_positions(arr, n):
    """Paged planes [L, nb, H, P, ...] as [L, H, n, ...]: the prompt's
    positions."""
    arr = np.swapaxes(np.asarray(arr), 1, 2)
    l, h, nb, p = arr.shape[:4]
    return arr.reshape(l, h, nb * p, *arr.shape[4:])[:, :, :n]


def _check_installed(disagg_lib, payload, installed, n):
    """The planes the decode replica installed (read back through
    ``paged._export_blocks_impl`` at the slot's table, right after the
    install) equal the planes the prefill replica exported, bit for bit,
    at the prompt's positions."""
    _, arrays = disagg_lib.parse(payload)
    for name, got in zip(('k', 'v', 'k_s', 'v_s'), installed):
        if got is None:
            continue
        sent = arrays[name]
        sent = getattr(sent, 'words', sent)
        if not np.array_equal(_prompt_positions(_words(got), n),
                              _prompt_positions(sent, n)):
            raise AssertionError(f'installed {name} planes differ from '
                                 f'the exported ones (prompt {n})')


def _disagg_replicas(stack, srv_lib, **kw):
    """Colocated, prefill and decode bench-1b replicas with the same
    options (the colocated one is the reference), each on its own port,
    warmed up: {role: (server, url)}."""
    out = {}
    for role in ('colocated', 'prefill', 'decode'):
        server = srv_lib.LlmServer('bench-1b', role=role, **kw)
        out[role] = (server, stack.enter_context(_served(server)))
        _post(out[role][1], {'tokens': [[1] * 8], 'max_new_tokens': 2})
        _idle(server.engine)
    return out


def _dispatches(servers):
    return {role: s.engine.stats()['pipeline']['dispatches']
            for role, (s, _) in servers.items()}


def _lone_references(servers, prompts, vocab, seed):
    """One greedy body (DISAGG_NEW new) per prompt length and the
    colocated replica's answers: [(body, tokens, TTFT s)]."""
    colo_srv, colo = servers['colocated']
    rng = np.random.default_rng(seed)
    out = []
    for n in prompts:
        body = {'tokens': [rng.integers(0, vocab, n).tolist()],
                'max_new_tokens': DISAGG_NEW}
        out.append((body, *_colocated(colo, body)))
    _idle(colo_srv.engine)
    return out


def _lone_handoffs(servers, refs, da, capture=None):
    """Each reference request through the handoff: tokens byte-identical
    to colocated; K4's counter does not move across the export and fetch
    legs (only the prefill replica works then). Returns the figures by
    prompt length."""
    (_, pre_url), (dec, dec_url) = servers['prefill'], servers['decode']
    figs = {}
    for body, ref, colo_ttft in refs:
        n = len(body['tokens'][0])
        _idle(dec.engine)
        before = da.flash_decode.launches
        if capture is not None:
            capture.clear()
        exported = _export_fetch(pre_url, dec_url, body)
        if da.flash_decode.launches != before:
            raise AssertionError(f'flash_decode launched during the export '
                                 f'of prompt {n}')
        tokens, fig = _import_leg(dec_url, *exported)
        if tokens != ref:
            raise AssertionError(f'prompt {n}: handoff tokens {tokens} '
                                 f'differ from colocated {ref}')
        if capture is not None:
            if len(capture) != 1:
                raise AssertionError(f'{len(capture)} installs captured')
            _check_installed(capture.disagg_lib, fig['payload'], capture[0],
                             n)
        fig['colo_ttft_ms'] = colo_ttft * 1e3
        figs[n] = fig
    return figs


class _InstallCapture(list):
    """Wraps the decode engine's ``paged.import_blocks``: right after each
    install into its pool, on the engine thread and before any decode
    chunk, the installed prompt blocks are read back through
    ``paged._export_blocks_impl`` at the slot's table."""

    def __init__(self, engine_lib, paged_lib, disagg_lib, engine):
        super().__init__()
        self.disagg_lib = disagg_lib
        self._orig = engine_lib._import_blocks  # noqa: SLF001
        self._paged = paged_lib
        self._engine = engine

    def __call__(self, pool, k, v, k_s, v_s, blocks, table_row, slot,
                 length):
        self._orig(pool, k, v, k_s, v_s, blocks, table_row, slot, length)
        if pool is self._engine._cache:  # noqa: SLF001
            nb = -(-int(length) // pool.block)
            self.append(self._paged._export_blocks_impl(  # noqa: SLF001
                pool, table_row[:nb]))


def _print_figs(label, figs):
    card = _card()
    for n, f in figs.items():
        print(f'  [{card}] {label} prompt {n}: export {f["export_ms"]:.2f} '
              f'ms, payload {f["bytes"]} B, fetch {f["fetch_ms"]:.2f} ms, '
              f'import {f["import_ms"]:.2f} ms (to its first line), '
              f'handoff {f["gb_s"]:.3f} GB/s over fetch + import; TTFT '
              f'{f["ttft_ms"]:.2f} ms through the handoff, '
              f'{f["colo_ttft_ms"]:.2f} ms colocated; decode '
              f'{(DISAGG_NEW - 1) / f["decode_s"]:.1f} tok/s on the decode '
              'replica', flush=True)


def _negotiation_traffic(servers, vocab):
    """Four 256-id preambles warmed into the decode replica's trie, then 16
    concurrent handoffs of preamble + 16-200 ids (a third greedy, a third
    top-k 50, a third top-p 0.9). Returns (bodies, [(tokens, figures)],
    wall s)."""
    (_, pre_url), (dec, dec_url) = servers['prefill'], servers['decode']
    rng = np.random.default_rng(170)
    heads = [rng.integers(0, vocab, DISAGG_PREAMBLE).tolist()
             for _ in range(DISAGG_PREAMBLES)]
    for head in heads:
        status, body = _post(dec_url, {'tokens': [head + [1, 2, 3]],
                                       'max_new_tokens': 4})
        if status != 200:
            raise AssertionError(f'warm-up {status} {body}')
    _idle(dec.engine)
    reqs = []
    for i in range(DISAGG_CONCURRENT):
        body = {'tokens': [heads[i % DISAGG_PREAMBLES] + rng.integers(
            0, vocab, int(rng.integers(16, 201))).tolist()],
                'max_new_tokens': DISAGG_NEG_NEW}
        if i % 3 == 1:
            body.update(temperature=0.8, top_k=50)
        elif i % 3 == 2:
            body.update(temperature=1.0, top_p=0.9)
        reqs.append(body)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(reqs)) as pool:
        out = list(pool.map(lambda b: _handoff(pre_url, dec_url, b), reqs))
    return reqs, out, time.perf_counter() - t0


def _check_negotiation(servers, gen_lib, vocab, reqs, out, wall):
    """``skip_blocks`` 16 for each, each payload smaller than the whole one
    by at least 16 blocks' planes, the answers whole, the greedy ones
    under the gap rule against ``generate`` on the colocated replica's
    weights. Returns the window's tok/s."""
    colo_srv, dec = servers['colocated'][0], servers['decode'][0]
    cfg = dec.cfg
    block_bytes = (2 * cfg.n_layers * cfg.n_kv_heads * dec.engine.kv_block
                   * cfg.head_dim * 2)
    full = DISAGG_PREAMBLE // dec.engine.kv_block
    parted = []
    for body, (tokens, fig) in zip(reqs, out):
        if fig['skip'] != full:
            raise AssertionError(f'prepare answered skip_blocks '
                                 f'{fig["skip"]}, not {full}')
        if fig['full_bytes'] - fig['bytes'] < full * block_bytes:
            raise AssertionError(f'payload {fig["bytes"]} B is not {full} '
                                 f'blocks smaller than {fig["full_bytes"]}')
        if len(tokens) != DISAGG_NEG_NEW \
                or not all(0 <= t < vocab for t in tokens):
            raise AssertionError(f'bad answer {tokens}')
        if 'temperature' not in body:
            parted.append(_check_greedy(gen_lib, colo_srv,
                                        body['tokens'][0], tokens, False))
    tokens = sum(len(t) for t, _ in out)
    skipped = sum(f['full_bytes'] - f['bytes'] for _, f in out)
    print(f'  [{_card()}] 17a negotiation: {len(reqs)} concurrent handoffs '
          f'on {DISAGG_PREAMBLES} warmed preambles, skip_blocks {full} each, '
          f'{skipped} payload bytes not sent; {tokens} tokens in {wall:.2f} '
          f's = {tokens / wall:.1f} tok/s; greedy vs generate(): '
          f'{sum(p[0] is None for p in parted)} of {len(parted)} equal, '
          f'parted at {[p for p in parted if p[0] is not None]} (limit '
          f'{GREEDY_GAP_LIMIT})', flush=True)
    return tokens / wall


def _role_health(servers, want):
    """/health ``role`` and ``disagg``, and the engines' ``disagg``, agree
    with the traffic sent: ``want`` {role: {counter: value}}, the engine's
    ``import_errors`` and ``queued_imports`` among them."""
    for role, (_, url) in servers.items():
        body = _get(url, '/health')
        eng = body['engine']['disagg']
        if body['role'] != role:
            raise AssertionError(f'{role} replica reports {body["role"]}')
        for key, value in want[role].items():
            got = (eng if key in ('import_errors', 'queued_imports')
                   else body['disagg'])[key]
            if got != value:
                raise AssertionError(f'{role} /health {key} {got}, expected '
                                     f'{value}: {body["disagg"]} {eng}')
        if (eng['exports'], eng['imports']) != (body['disagg']['exports'],
                                                body['disagg']['imports']):
            raise AssertionError(f'{role}: engine {eng} against replica '
                                 f'{body["disagg"]}')


def _held_to_colocated(gen_lib, colo_server, body, got, want):
    """A handoff's greedy answer ``got`` equals the colocated ``want``, or
    each parts from a direct ``generate`` where its top-2 logit gap is
    below GREEDY_GAP_LIMIT (``_check_greedy``, which raises otherwise).
    Returns None when equal, else (where the two part, [(parting
    position, gap) of got, of want])."""
    if got == want:
        return None
    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    return j, [_check_greedy(gen_lib, colo_server, body['tokens'][0], t,
                             False) for t in (got, want)]


def _transports_and_failures(servers, vocab, gen_lib):
    """17c: two handoffs through a staging directory (the replicas'
    ``staging_dir``, which ``SKYTPU_DISAGG_STAGING`` sets at construction),
    a payload with one byte flipped (400, no import, the next handoff
    served: equal to colocated, or parted under the gap rule), and a
    negotiated prefix evicted from the decode replica's trie before the
    import (409, before any line). Returns the exports and imports it
    made."""
    colo = servers['colocated'][1]
    (pre, pre_url), (dec, dec_url) = servers['prefill'], servers['decode']
    rng = np.random.default_rng(171)
    staging = tempfile.mkdtemp(prefix='skytpu-staging-')
    pre.staging_dir = dec.staging_dir = staging
    try:
        for n in (40, 300):
            body = {'tokens': [rng.integers(0, vocab, n).tolist()],
                    'max_new_tokens': 16}
            tokens, fig = _handoff(pre_url, dec_url, body)
            if fig['payload'] is not None \
                    or tokens != _colocated(colo, body)[0]:
                raise AssertionError(f'staged handoff of prompt {n}')
        staged = len(os.listdir(staging))
    finally:
        pre.staging_dir = dec.staging_dir = None
        shutil.rmtree(staging, ignore_errors=True)
    if staged != 2:
        raise AssertionError(f'{staged} staged payloads, expected 2')
    body = {'tokens': [rng.integers(0, vocab, 60).tolist()],
            'max_new_tokens': 8}
    data, _, _ = _export_fetch(pre_url, dec_url, body)
    bad = bytearray(data)
    bad[-100] ^= 0x01
    imports = dec.engine.imports
    status, lines, _, _ = _stream_timed(dec_url, '/v1/kv/import?stream=1',
                                        bytes(bad), OCTET_CT)
    if status != 400 or 'crc32' not in lines[0].get('error', ''):
        raise AssertionError(f'corrupt payload answered {status} {lines}')
    if dec.engine.imports != imports:
        raise AssertionError('a corrupt payload reached the engine')
    tokens, _ = _handoff(pre_url, dec_url, body)
    after = _held_to_colocated(gen_lib, servers['colocated'][0], body,
                               tokens, _colocated(colo, body)[0])
    head = rng.integers(0, vocab, DISAGG_PREAMBLE).tolist()
    _post(dec_url, {'tokens': [head + [5]], 'max_new_tokens': 2})
    _idle(dec.engine)
    body = {'tokens': [head + [6, 7, 8]], 'max_new_tokens': 8}
    data, headers, fig = _export_fetch(pre_url, dec_url, body)
    eng = dec.engine
    with eng._lock:  # noqa: SLF001 -- evict as the allocator does
        pairs = eng._trie.evict_nodes(eng._trie.reclaimable)  # noqa: SLF001
        eng._free_blocks.extend(b for b, _ in pairs)  # noqa: SLF001
        eng.share_evictions += len(pairs)
    status, lines, _, _ = _stream_timed(dec_url, '/v1/kv/import?stream=1',
                                        data, headers)
    full = DISAGG_PREAMBLE // eng.kv_block
    if fig['skip'] != full or status != 409:
        raise AssertionError(f'evicted prefix (skip {fig["skip"]}) answered '
                             f'{status} {lines}')
    print(f'  [{_card()}] 17c: 2 staged handoffs equal colocated; a flipped '
          f'byte: 400, imports unchanged, the next handoff served ('
          f'{"equal to colocated" if after is None else after}); '
          f'{len(pairs)} blocks evicted under a negotiated prefix of {full}: '
          f'409 before any line ({lines[0]["error"][:60]})', flush=True)
    return {'exports': 5, 'imports': 3}


def disagg_phase(srv_lib, gen_lib, engine_lib, paged_lib, disagg_lib, da):
    """Phase 17 (see the module docstring). Returns the K4 launches of the
    handoff traffic of 17a (bf16 cache) and 17b (int8 cache)."""
    t_phase = time.perf_counter()
    launches = {}
    with contextlib.ExitStack() as stack:
        servers = _disagg_replicas(stack, srv_lib, max_len=2048,
                                   kv_layout='paged', prefix_share='on')
        cfg = servers['decode'][0].cfg
        dec = servers['decode'][0].engine
        refs = _lone_references(servers, DISAGG_LONE, cfg.vocab_size, 17)
        d0 = _dispatches(servers)
        da.flash_decode.launches = 0
        capture = _InstallCapture(engine_lib, paged_lib, disagg_lib, dec)
        with unittest.mock.patch.object(engine_lib, '_import_blocks',
                                        capture):
            figs = _lone_handoffs(servers, refs, da, capture)
        neg = _negotiation_traffic(servers, cfg.vocab_size)
        _idle(dec)
        launches['bf16'] = da.flash_decode.launches
        d1 = _dispatches(servers)
        _check_dispatches('17a', launches['bf16'], d0, d1, cfg, dec)
        tok_s = _check_negotiation(servers, gen_lib, cfg.vocab_size, *neg)
        _print_figs('17a paged bf16', figs)
        n17a = len(DISAGG_LONE) + DISAGG_CONCURRENT
        _role_health(servers, {
            'prefill': {'exports': n17a, 'imports': 0, 'parked': 0,
                        'fallbacks_served': 0},
            'decode': {'exports': 0, 'imports': n17a, 'import_rejects': 0,
                       'import_errors': 0, 'fallbacks_served': 0,
                       'queued_imports': 0},
            'colocated': {'exports': 0, 'imports': 0,
                          'fallbacks_served': 0}})
        print(f'  17a: {len(DISAGG_LONE)} lone handoffs byte-identical to '
              f'colocated, installed planes = exported planes bit for bit; '
              f'flash_decode launches {launches["bf16"]} = n_layers x '
              f'chunk_steps x {d1["decode"] - d0["decode"]} decode-replica '
              f'dispatches, none on the prefill replica; 16 concurrent '
              f'handoffs: {tok_s:.1f} tok/s', flush=True)
        _phase('  17a done')
        more = _transports_and_failures(servers, cfg.vocab_size, gen_lib)
        _role_health(servers, {
            'prefill': {'exports': n17a + more['exports'], 'parked': 0},
            'decode': {'imports': n17a + more['imports'],
                       'import_rejects': 2, 'import_errors': 1,
                       'fallbacks_served': 0},
            'colocated': {'exports': 0, 'imports': 0}})
        _phase('  17c done')
    torch.cuda.empty_cache()
    with contextlib.ExitStack() as stack:
        servers = _disagg_replicas(stack, srv_lib, max_len=1024,
                                   quantize='int8', kv_cache='int8')
        dec = servers['decode'][0].engine
        refs = _lone_references(servers, DISAGG_LONE_INT8, cfg.vocab_size,
                                172)
        d0 = _dispatches(servers)
        da.flash_decode.launches = 0
        figs = _lone_handoffs(servers, refs, da)
        _idle(dec)
        launches['int8'] = da.flash_decode.launches
        _check_dispatches('17b', launches['int8'], d0, _dispatches(servers),
                          cfg, dec)
        _, arrays = disagg_lib.parse(figs[DISAGG_LONE_INT8[0]]['payload'])
        if set(arrays) != {'k', 'v', 'k_s', 'v_s'} \
                or arrays['k'].dtype != np.int8:
            raise AssertionError(f'int8 payload planes {set(arrays)}')
        _print_figs('17b slot int8', figs)
        print(f'  17b: {len(DISAGG_LONE_INT8)} lone handoffs carrying the '
              f'scale planes, byte-identical to colocated; flash_decode '
              f'launches {launches["int8"]} = n_layers x chunk_steps x '
              f'decode-replica dispatches', flush=True)
    torch.cuda.empty_cache()
    print(f'  [{_card()}] phase 17: {time.perf_counter() - t_phase:.1f} s',
          flush=True)
    return launches


# -- phase 18: tensor-parallel serving (serve-tp) -----------------------------

TP_SERVER = [sys.executable, '-m', 'skypilot_tpu_torch.serve.llm_server']
TP_SPMD = [sys.executable, '-m', 'skypilot_tpu_torch.serve.spmd']
# 18a: bench-1b at tp 2, the replica's defaults (engine, slot layout, bf16,
# 16 slots, max_len 1024); rank 0 starts its follower.
TP_BENCH_ARGV = ['--model', 'bench-1b', '--tp', '2']
# 18b: the serve-multihost recipe's command
# (examples/llm/serve-multihost/serve.yaml), as two hosts of four ranks.
TP_RECIPE_ARGV = ['--model', 'llama3-8b', '--max-len', '2048', '--tp', '8',
                  '--quantize', 'int8', '--kv-cache', 'int8']
TP_HOSTS = 2
TP_LONE = (17, 128, 300, 900)  # greedy prompts, TP_NEW new ids each
TP_NEW = 64
# 18b sends its four greedy requests together, decoded one step a chunk:
# its eight ranks share the one card, and each of a step's 66 collectives
# waits for the card's time slice (2.3-2.8 s a step, PERF.md §5), so the
# four share their steps.
TP8_NEW = 16
TP8_CHUNK = 1
# 18b serves llama3-8b at TP8_LAYERS of its 32 layers, widths untouched,
# to make room for phase 19 (each of its checks holds at any depth).
TP8_LAYERS = 4
TP_UP_S = 600      # spawn to a healthy head
TP_EXIT_S = 180    # SIGTERM to every rank's exit
TP_SEEDED_ERROR = ('seeded sampling is unavailable with '
                   'SKYTPU_DECODE_KERNEL=pallas on a --tp > 1 replica')
_NCCL_PAIR = r'''
import datetime, sys, torch, torch.distributed as dist
torch.cuda.set_device(0)
dist.init_process_group('nccl', init_method=sys.argv[1], world_size=2,
                        rank=int(sys.argv[2]),
                        timeout=datetime.timedelta(seconds=60))
x = torch.ones(4, device='cuda')
dist.all_reduce(x)
torch.cuda.synchronize()
print('NCCL_PAIR_OK', flush=True)
'''


def _nccl_refusal():
    """Two NCCL ranks on the one card: NCCL refuses them (so ranks that
    share a card reduce through gloo). Returns NCCL's line."""
    tmp = tempfile.mkdtemp(prefix='skytpu-nccl-')
    procs = [subprocess.Popen(
        [sys.executable, '-c', _NCCL_PAIR, f'file://{tmp}/rendezvous',
         str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=180)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    text = '\n'.join(outs)
    line = next((ln for ln in text.splitlines() if 'Duplicate GPU' in ln),
                None)
    if line is None or 'NCCL_PAIR_OK' in text:
        raise AssertionError(f'two NCCL ranks on one card were not refused '
                             f'as expected:\n{text[-3000:]}')
    return line.strip()


def _rank_summaries(paths, world):
    """The ``tp-rank-summary`` lines of every rank, by rank."""
    found = {}
    for path in paths:
        with open(path, encoding='utf-8', errors='replace') as f:
            for m in re.findall(r'tp-rank-summary (\{[^{}]*\})', f.read()):
                summ = json.loads(m)
                found[summ['rank']] = summ
    if sorted(found) != list(range(world)):
        raise AssertionError(f'rank summaries of {sorted(found)}, not of '
                             f'all {world} ranks')
    return [found[r] for r in range(world)]


def _depth_env(log_dir, name, n_layers, **fields):
    """PYTHONPATH for processes (and every rank they spawn) that see
    ``llama.PRESETS[name]`` at ``n_layers`` layers (and ``fields``): a
    ``sitecustomize`` that cuts it when the interpreter starts."""
    more = ''.join(f', {k}={v!r}' for k, v in sorted(fields.items()))
    cut = os.path.join(log_dir, f'depth-{name}-{n_layers}' + ''.join(
        f'-{k}-{v}' for k, v in sorted(fields.items())))
    os.makedirs(cut, exist_ok=True)
    # Whole or not at all: phases side by side may write it at once while
    # a rank of either starts.
    fd, tmp = tempfile.mkstemp(dir=cut)
    with os.fdopen(fd, 'w') as f:
        f.write('import dataclasses\n'
                'from skypilot_tpu_torch.models import llama\n'
                f'llama.PRESETS[{name!r}] = dataclasses.replace('
                f'llama.PRESETS[{name!r}], n_layers={n_layers}{more})\n')
    os.replace(tmp, os.path.join(cut, 'sitecustomize.py'))
    return {'PYTHONPATH': os.pathsep.join(
        [cut, os.getcwd(), os.environ.get('PYTHONPATH', '')])}


def _tp_replica(argv, hosts, log_dir, label, host_env=None, layers=None,
                **env_vars):
    """Start the replica's host processes (one: ``llm_server --tp``, which
    starts its followers; more: ``serve.spmd`` under the gang launcher's
    env; ``host_env``: each host's own variables; ``layers``: the model
    at that depth in every rank) and wait for the head's /health.
    Returns (procs, logs, url, seconds to healthy)."""
    port = _free_port()
    # Each rank's SIGQUIT stacks land here (``_tp_stacks``).
    env = dict(os.environ, SKYTPU_BLACKBOX_DIR=os.path.join(
        log_dir, 'blackbox'), **env_vars)
    if layers is not None:
        env.update(_depth_env(log_dir, argv[argv.index('--model') + 1],
                              layers))
    if hosts > 1:
        env.update(JAX_COORDINATOR_ADDRESS=f'127.0.0.1:{_free_port()}',
                   JAX_NUM_PROCESSES=str(hosts))
    procs, logs = [], []
    t0 = time.monotonic()
    for h in range(hosts):
        logs.append(os.path.join(log_dir, f'{label}-host{h}.log'))
        with open(logs[-1], 'w') as log:
            procs.append(subprocess.Popen(
                (TP_SPMD if hosts > 1 else TP_SERVER) + argv
                + ['--host', '127.0.0.1', '--port', str(port)],
                env=dict(env, **(host_env[h] if host_env else {}),
                         **({'JAX_PROCESS_ID': str(h)} if hosts > 1
                            else {})),
                stdout=log, stderr=subprocess.STDOUT))
    url = f'http://127.0.0.1:{port}'
    while True:
        for h, proc in enumerate(procs):
            if proc.poll() is not None:
                time.sleep(2)  # the other hosts' last words
                _tp_kill(procs)
                raise AssertionError(f'{label}: host {h} exited '
                                     f'{proc.returncode} before /health '
                                     f'answered:\n{_tp_logs(logs)}')
        if time.monotonic() - t0 > TP_UP_S:
            raise AssertionError(f'{label}: no /health in {TP_UP_S} s')
        try:
            if _http(url, '/health', timeout=5)[0] == 200:
                return procs, logs, url, time.monotonic() - t0
        except OSError:
            pass
        time.sleep(0.2)


def _tp_stop(procs, logs, label, world):
    """SIGTERM to the head: every host process exits 0 (the head drains
    and broadcasts stop) within TP_EXIT_S. Returns the rank summaries and
    the seconds it took."""
    t0 = time.monotonic()
    procs[0].send_signal(signal.SIGTERM)
    try:
        for h, proc in enumerate(procs):
            try:
                code = proc.wait(max(TP_EXIT_S - (time.monotonic() - t0),
                                     1))
            except subprocess.TimeoutExpired:
                raise AssertionError(
                    f'{label}: host {h} still running {TP_EXIT_S} s after '
                    f'SIGTERM:\n{_tp_logs(logs)}\n{_tp_stacks(procs, logs)}'
                ) from None
            if code != 0:
                raise AssertionError(f'{label}: host {h} exited {code} '
                                     'after SIGTERM, not a clean drain:\n'
                                     + _tp_logs(logs))
    finally:
        _tp_kill(procs)
    return _rank_summaries(logs, world), time.monotonic() - t0


def _tp_logs(logs):
    """Each host's first error lines and its last lines."""
    out = []
    for path in logs:
        with open(path, encoding='utf-8', errors='replace') as f:
            lines = f.read().splitlines()
        errors = [ln for ln in lines if 'Error' in ln or 'error' in ln]
        out.append(f'--- {os.path.basename(path)}: first errors\n'
                   + '\n'.join(errors[:8]) + '\n--- last lines\n'
                   + '\n'.join(lines[-15:]))
    return '\n'.join(out)[-12000:]


def _tp_stacks(procs, logs):
    """SIGQUIT to every rank still running (the host processes and the
    ranks they spawned): each writes its threads' stacks to the
    recorder's spool beside the logs. Returns the stacks' tails."""
    pids = []
    for proc in procs:
        if proc.poll() is None:
            pids.append(proc.pid)
            try:
                with open(f'/proc/{proc.pid}/task/{proc.pid}/children',
                          encoding='utf-8') as f:
                    pids += [int(p) for p in f.read().split()]
            except OSError:
                pass
    for pid in pids:
        try:
            os.kill(pid, signal.SIGQUIT)
        except OSError:
            pass
    time.sleep(5)
    spool = os.path.join(os.path.dirname(logs[0]), 'blackbox')
    out = []
    for name in sorted(os.listdir(spool)) if os.path.isdir(spool) else []:
        if name.startswith('sigquit-'):
            with open(os.path.join(spool, name), encoding='utf-8',
                      errors='replace') as f:
                out.append(f'--- {name}\n{f.read()[-2500:]}')
    return '\n'.join(out)[-10000:] or f'no stacks from {pids}'


def _tp_kill(procs):
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _check_rank_launches(label, summaries, cfg, chunk_steps,
                         backend='gloo'):
    """Each rank ran the same dispatches, sampled the same tokens (the
    digest of every token it read back, free slots' included) and
    launched K4 n_layers x chunk_steps x dispatches times, per head
    shard, over ``backend`` (gloo: staged through host memory). Returns
    the launches per rank."""
    dispatches = {s['dispatches'] for s in summaries}
    digests = {s['sampled_digest'] for s in summaries}
    if len(digests) != 1 or 0 in digests:
        raise AssertionError(f'{label}: the ranks sampled different tokens '
                             f'(digests by rank '
                             f'{[s["sampled_digest"] for s in summaries]})')
    for s in summaries:
        want = cfg.n_layers * chunk_steps * s['dispatches']
        if s['flash_decode_launches'] != want or not s['dispatches'] \
                or len(dispatches) != 1 or s['backend'] != backend \
                or s['staged'] != (backend == 'gloo'):
            raise AssertionError(f'{label}: rank {s["rank"]} {s} (K4 '
                                 f'expected {want}, dispatches across '
                                 f'ranks {sorted(dispatches)})')
    return [s['flash_decode_launches'] for s in summaries]


def _lone_greedy(url, prompts, new, together=False):
    """Greedy answers to ``prompts``, one request at a time, or all sent
    at once (``together``)."""
    reqs = [{'tokens': [p], 'max_new_tokens': new} for p in prompts]
    answers = (_post_all(url, reqs) if together
               else [_post(url, r) for r in reqs])
    for code, body in answers:
        if code != 200 or len(body['tokens'][0]) != new:
            raise AssertionError(f'greedy request answered {code} {body}')
    return [body['tokens'][0] for _, body in answers]


def _tp_reference(srv_lib, gen_lib, model, prompts, outs, kv_int8, **kw):
    """A tp 1 replica of the same seed (window path only: its weights and
    ``generate``): each tp answer equals its direct generation or parts
    from it where the top-2 logit gap is below GREEDY_GAP_LIMIT (TP
    reorders sums). Returns (its parameter bytes, the replicated leaves'
    bytes, the partings)."""
    from skypilot_tpu_torch.models import quantization as quant_lib
    from skypilot_tpu_torch.observability import profiler
    from skypilot_tpu_torch.parallel import sharding as sharding_lib
    server = srv_lib.LlmServer(model, engine='off', **kw)
    try:
        parts = [_check_greedy(gen_lib, server, p, got, kv_int8)
                 for p, got in zip(prompts, outs)]
        # Leaves no rule splits over the tensor axis: the norms, and the
        # scales of the row-split int8 weights.
        rules = sharding_lib.ShardingRules()
        replicated = []
        sharding_lib.map_logical(
            lambda la, leaf: replicated.append(leaf)
            if 'tensor' not in rules.mesh_axes(la) else None,
            quant_lib.logical_axes_for(server.params, server.cfg),
            server.params)
        replicated = profiler.tree_nbytes(replicated)
        whole = profiler.tree_nbytes(server.params)
    finally:
        server.stop()
        del server
        torch.cuda.empty_cache()
    return whole, replicated, parts


def _check_param_bytes(label, summaries, whole, replicated):
    """The ranks' weight bytes sum to the tp 1 replica's plus the
    replicated leaves' extra copies, and no rank holds the whole model."""
    per_rank = [s['param_bytes'] for s in summaries]
    want = whole + (len(per_rank) - 1) * replicated
    if sum(per_rank) != want or max(per_rank) >= whole:
        raise AssertionError(f'{label}: ranks hold {per_rank} bytes of '
                             f'weights (sum {sum(per_rank)}, expected '
                             f'{want}; tp 1 holds {whole})')
    return per_rank


def _tp_figs(label, summaries, boot_s, stop_s, steps, wall, tokens,
             backend, chunk_steps):
    """The window's tok/s and host ms a decode step; each rank's
    collectives and their host ms over its life, per decode step of its
    life (prefills and start-up included)."""
    card = _card()
    life = [s['dispatches'] * chunk_steps for s in summaries]
    coll = [round(s['collectives'] / n, 1)
            for s, n in zip(summaries, life)]
    coll_ms = [round(s['collective_s'] * 1e3 / n, 2)
               for s, n in zip(summaries, life)]
    print(f'  [{card}] {label}: {tokens / wall:.2f} tok/s over {wall:.2f} '
          f's ({tokens} tokens), {wall * 1e3 / steps:.2f} host ms a decode '
          f'step ({steps} steps); collectives by rank {coll} a decode step '
          f'of its life ({life[0]} steps), {coll_ms} host ms of them a '
          f'step; backend {backend}; peak memory by rank '
          f'{[s["peak_bytes"] for s in summaries]} B; healthy '
          f'{boot_s:.1f} s after spawn, every rank out {stop_s:.1f} s '
          'after SIGTERM', flush=True)


def _tp_traffic(vocab):
    """16 concurrent requests (prompts 17-300, max_new 8-64, a third
    greedy, a third top-k 50, a third top-p 0.9) and one to stream."""
    rng = np.random.default_rng(18)
    reqs = []
    for i in range(16):
        body = {'tokens': [rng.integers(0, vocab, int(
                    rng.integers(17, 301))).tolist()],
                'max_new_tokens': int(rng.integers(8, 65))}
        if i % 3 == 1:
            body.update(temperature=0.8, top_k=50)
        elif i % 3 == 2:
            body.update(temperature=1.0, top_p=0.9)
        reqs.append(body)
    stream_req = {'tokens': [rng.integers(0, vocab, 40).tolist()],
                  'max_new_tokens': 40}
    return reqs, stream_req


def _with_tp(argv, tp):
    i = argv.index('--tp')
    return argv[:i + 1] + [str(tp)] + argv[i + 2:]


def tp_bench_phase(srv_lib, gen_lib, llama, log_dir, tp=2, backend='gloo',
                   label='18a', layers=None):
    """18a: ``llm_server --model bench-1b --tp 2`` (rank 0 starts its
    follower): /health ``tp`` 2 over gloo, a seeded request refused in
    JAX's words, 4 lone greedy requests, 16 concurrent mixed ones whole,
    the stream = the request not streamed, SIGTERM drains both ranks to
    exit 0; K4 on each rank = n_layers x chunk_steps x dispatches; every
    rank samples the same tokens; the lone answers against a tp 1
    replica of the same seed under the gap rule; the ranks' weight
    bytes. ``tp`` and ``backend``: the same checks at another degree and
    over another backend (``--nccl``); ``layers``: bench-1b at that depth
    in every rank (the caller cuts the preset for the reference). Returns
    K4's launches per rank."""
    cfg = llama.PRESETS['bench-1b']
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in TP_LONE]
    procs, logs, url, boot_s = _tp_replica(_with_tp(TP_BENCH_ARGV, tp), 1,
                                           log_dir, label, layers=layers)
    try:
        health = json.loads(_http(url, '/health')[2])
        if (health['tp'], health['tp_backend']) != (tp, backend):
            raise AssertionError(f'{label} /health tp {health["tp"]} '
                                 f'{health["tp_backend"]}')
        code, _, body = _http(url, '/generate', {
            'tokens': [[1, 2, 3]], 'max_new_tokens': 4, 'temperature': 0.8,
            'seed': 1})
        if code != 400 or json.loads(body)['error'] != TP_SEEDED_ERROR:
            raise AssertionError(f'{label} seeded request: {code} {body}')
        lone = _lone_greedy(url, prompts, TP_NEW)
        reqs, stream_req = _tp_traffic(cfg.vocab_size)
        d0 = json.loads(_http(url, '/health')[2])['engine']['pipeline'][
            'dispatches']
        t0 = time.monotonic()
        answers = _post_all(url, reqs)
        wall = time.monotonic() - t0
        eng = json.loads(_http(url, '/health')[2])['engine']
        steps = (eng['pipeline']['dispatches'] - d0) * eng['chunk_steps']
        _check_answers(reqs, answers, cfg.vocab_size)
        _check_stream(url, stream_req, *_post_stream(url, stream_req))
        summaries, stop_s = _tp_stop(procs, logs, label, tp)
    finally:
        _tp_kill(procs)
    launches = _check_rank_launches(label, summaries, cfg,
                                    eng['chunk_steps'], backend)
    whole, replicated, parts = _tp_reference(
        srv_lib, gen_lib, 'bench-1b', prompts, lone, False, max_len=1024)
    per_rank = _check_param_bytes(label, summaries, whole, replicated)
    _tp_figs(f'{label} bench-1b tp {tp}, 16 concurrent', summaries, boot_s,
             stop_s, steps, wall, sum(r['max_new_tokens'] for r in reqs),
             health['tp_backend'], eng['chunk_steps'])
    print(f'  {label}: lone greedy {TP_LONE} x {TP_NEW} against tp 1: '
          f'partings (position, top-2 gap) {parts}; weights by rank '
          f'{per_rank} B, tp 1 {whole} B, replicated leaves {replicated} B; '
          f'K4 launches by rank {launches} (Hkv {cfg.n_kv_heads // tp} per '
          f'rank); sampled digest {summaries[0]["sampled_digest"]} on every '
          'rank', flush=True)
    return launches


def tp_recipe_phase(srv_lib, gen_lib, llama, log_dir, tp=8,
                    backend='gloo', label='18b', host_env=None,
                    layers=None):
    """18b: the serve-multihost recipe's command through ``serve.spmd`` as
    two hosts of four ranks each under the gang launcher's env, all eight
    on the one card: a stop before the first request exits every rank 0;
    then 4 greedy requests sent together agree with a tp 1 llama3-8b int8
    replica under the gap rule, every rank samples the same tokens, and
    K4 int8 runs at Hkv 1 on every rank. ``tp``, ``backend`` and
    ``host_env`` (each host's variables): the same checks at another
    degree, over another backend, with each host's own cards
    (``--nccl``); ``layers``: llama3-8b at that depth in every rank (the
    caller cuts the preset for the reference). Returns K4's launches per
    rank."""
    cfg = llama.PRESETS['llama3-8b']
    argv = _with_tp(TP_RECIPE_ARGV, tp)
    chunk = {'SKYTPU_LLM_CHUNK_STEPS': str(TP8_CHUNK)}
    procs, logs, url, boot0_s = _tp_replica(argv, TP_HOSTS, log_dir,
                                            f'{label}-stop', host_env,
                                            layers, **chunk)
    try:
        stop_first, stop0_s = _tp_stop(procs, logs, f'{label} stop before '
                                       'the first request', tp)
    finally:
        _tp_kill(procs)
    _phase(f'  {label} stop before the first request: healthy after '
           f'{boot0_s:.1f} s')
    if any(s['dispatches'] for s in stop_first):
        raise AssertionError(f'{label}: a replica stopped before any '
                             f'request dispatched {stop_first}')
    rng = np.random.default_rng(19)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in TP_LONE]
    procs, logs, url, boot_s = _tp_replica(argv, TP_HOSTS, log_dir, label,
                                           host_env, layers, **chunk)
    try:
        health = json.loads(_http(url, '/health')[2])
        if (health['tp'], health['tp_backend']) != (tp, backend):
            raise AssertionError(f'{label} /health tp {health["tp"]} '
                                 f'{health["tp_backend"]}')
        _phase(f'  {label} healthy after {boot_s:.1f} s')
        t0 = time.monotonic()
        greedy = _lone_greedy(url, prompts, TP8_NEW, together=True)
        wall = time.monotonic() - t0
        _phase(f'  {label} the 4 greedy requests took {wall:.1f} s')
        eng = json.loads(_http(url, '/health')[2])['engine']
        steps = eng['pipeline']['dispatches'] * eng['chunk_steps']
        summaries, stop_s = _tp_stop(procs, logs, label, tp)
    finally:
        _tp_kill(procs)
    launches = _check_rank_launches(label, summaries, cfg,
                                    eng['chunk_steps'], backend)
    _phase(f'  {label} replica done; the tp 1 reference')
    whole, replicated, parts = _tp_reference(
        srv_lib, gen_lib, 'llama3-8b', prompts, greedy, True, max_len=2048,
        quantize='int8', kv_cache='int8')
    per_rank = _check_param_bytes(label, summaries, whole, replicated)
    _tp_figs(f'{label} llama3-8b int8 tp {tp} ({TP_HOSTS} hosts x '
             f'{tp // TP_HOSTS}), 4 greedy at once', summaries, boot_s,
             stop_s, steps, wall, len(TP_LONE) * TP8_NEW,
             health['tp_backend'], eng['chunk_steps'])
    print(f'  {label}: stop before the first request: healthy '
          f'{boot0_s:.1f} s after spawn, all {tp} ranks out {stop0_s:.1f} s '
          f'after SIGTERM; greedy {TP_LONE} x {TP8_NEW} at once against tp '
          f'1: partings (position, top-2 gap) {parts}; weights by rank '
          f'{per_rank} B, tp 1 {whole} B; K4 int8 launches by rank '
          f'{launches} (Hkv {cfg.n_kv_heads // tp} per rank); sampled '
          f'digest {summaries[0]["sampled_digest"]} on every rank',
          flush=True)
    return launches


# 18c: bench-1b at tp 2 on the paged layout as a decode replica, block
# sharing and the KV tiers on: a pool of 256 usable blocks (4,096
# positions, a quarter of the slot layout's 16 x 1024), a host tier of
# about 17 whole-head bf16 blocks (10 MB at 9 layers, where a block is
# 589,824 bytes, scaled to the depth served) and a temporary spill
# directory.
TP_PAGED_ARGV = ['--model', 'bench-1b', '--tp', '2', '--kv-layout', 'paged',
                 '--role', 'decode', '--kv-blocks', '257', '--max-len',
                 '1024']
TP_PAGED_HOST_BYTES = 10_000_000  # at 9 layers
TP_PAGED_NEW = 32
TP_QUIET_S = 0.5  # the head's tier counters unchanged this long: quiet
# 18d: bench-1b with bench-draft at tp 2 (k SPEC_K), the slot layout.
TP_SPEC_ARGV = ['--model', 'bench-1b', '--tp', '2', '--draft-model',
                'bench-draft']
# 18e: moe-8x1b at tp 2, at SERVE_LAYERS of its 18 layers.
TP_MOE_ARGV = ['--model', 'moe-8x1b', '--tp', '2']


def _health(url):
    return json.loads(_http(url, '/health')[2])


def _tp_drained(url):
    """The head's /health once its engine is drained (no request queued,
    prefilling, parked on a tier fetch or holding a slot) and its KV tier
    thread quiet (the tier counters unchanged for TP_QUIET_S)."""
    deadline = time.monotonic() + 300
    last = None
    while time.monotonic() < deadline:
        health = _health(url)
        eng = health['engine']
        tiers = eng['kv_tiers'] or {}
        busy = (eng['active_slots'] or eng['queued'] or eng['prefilling']
                or tiers.get('waiting')
                or eng['disagg']['queued_imports'])
        now = {k: v for k, v in tiers.items() if k not in (
            'demote_ms', 'promote_ms')}
        if not busy and now == last:
            return health
        last = None if busy else now
        time.sleep(TP_QUIET_S)
    raise AssertionError(f'the replica did not drain: {health}')


def _tp_reconciled(label, what, health):
    """The head's block accounts after a drain: nothing owned or
    referenced, used == cached, free + cached == usable, and the host and
    spilled counts equal the tier's own."""
    eng = health['engine']
    kb, tiers = eng['kv_blocks'], eng['kv_tiers']
    if (kb['owned'] or kb['shared'] or kb['used'] != kb['cached']
            or kb['free'] + kb['cached'] != kb['usable']
            or kb['host'] != tiers['host_blocks']
            or kb['spilled'] != tiers['spilled_blocks']):
        raise AssertionError(f'{label} {what}: block accounts do not '
                             f'reconcile: {kb} {tiers}')
    return kb


def _ranks_agree(label, summaries, keys):
    """Every rank holds the same engine state under ``keys`` (its rank
    summary's block accounts, counters and tier decisions)."""
    for key in keys:
        values = [s[key] for s in summaries]
        if any(v != values[0] for v in values):
            raise AssertionError(f'{label}: the ranks disagree on {key}: '
                                 f'{values}')


def _with_logs(label, logs, exc):
    """An AssertionError for a failure while a replica ran: what failed
    (an HTTP error's body too) and each host's first errors and last
    lines."""
    what = repr(exc)
    if isinstance(exc, urllib.error.HTTPError):
        what += f' {exc.read()[:2000]!r}'
    return AssertionError(f'{label}: {what}\n{_tp_logs(logs)}')


def _tp_paged_traffic(vocab):
    """18c's requests, from a numpy seed: a warm-up of 4 preambles of 256
    ids (each with 16 more), 16 concurrent requests of a preamble and
    16-200 ids (a third greedy, a third top-k 50, a third top-p 0.9), 8
    new preambles twice each, then the first 4 preambles again, each
    TP_PAGED_NEW new; and the 4 handoff prompts (TP_LONE)."""
    rng = np.random.default_rng(21)
    pre = [rng.integers(0, vocab, 256).tolist() for _ in range(4)]
    fresh = [rng.integers(0, vocab, 256).tolist() for _ in range(8)]

    def body(head, i, lo=16, hi=201):
        req = {'tokens': [head + rng.integers(0, vocab, int(
                   rng.integers(lo, hi))).tolist()],
               'max_new_tokens': TP_PAGED_NEW}
        if i % 3 == 1:
            req.update(temperature=0.8, top_k=50)
        elif i % 3 == 2:
            req.update(temperature=1.0, top_p=0.9)
        return req
    rounds = (('warm-up', [body(p, 0, 16, 17) for p in pre]),
              ('window', [body(pre[i % 4], i) for i in range(16)]),
              ('new preambles', [body(fresh[i % 8], i) for i in range(16)]),
              ('preambles again', [body(p, 0, 40, 41) for p in pre]))
    handoffs = [rng.integers(0, vocab, n).tolist() for n in TP_LONE]
    return rounds, handoffs


def tp_paged_phase(srv_lib, gen_lib, llama, log_dir, tp=2, backend='gloo',
                   label='18c', layers=None):
    """18c: ``llm_server --model bench-1b --tp 2 --kv-layout paged --role
    decode --kv-blocks 257`` with block sharing and the KV tiers on (a
    10 MB host tier and a spill directory; the tier on the head, whole).
    Four rounds of traffic (``_tp_paged_traffic``): every answer whole,
    share hits, evictions demoted and spilled, the preambles asked again
    fetched or promoted with nothing corrupt, the head's block accounts
    reconciled after each drain; the last round's greedy answers equal a
    direct ``generate`` of the tp 1 replica below or part where its top-2
    gap < GREEDY_GAP_LIMIT. Then 4 handoffs from a tp 1 prefill
    replica (paged bf16, the same seed) in this process over the
    ``/v1/kv/*`` legs: /health ``role`` decode, 4 imports, no fallback;
    the answers, and the tp 1 replica's own for the same prompts, equal a
    direct ``generate`` or part where its top-2 gap < GREEDY_GAP_LIMIT.
    SIGTERM exits every rank 0; every rank's block accounts (reconciled),
    share counters, tier decisions and digest are equal, and its K4 calls
    n_layers x chunk_steps x dispatches at its shard. Returns K4's
    launches per rank."""
    cfg = llama.PRESETS['bench-1b']
    vocab = cfg.vocab_size
    rounds, prompts = _tp_paged_traffic(vocab)
    spill = tempfile.mkdtemp(prefix='kvspill-', dir=log_dir)
    procs, logs, url, boot_s = _tp_replica(
        _with_tp(TP_PAGED_ARGV, tp), 1, log_dir, label, layers=layers,
        SKYTPU_KV_HOST_BYTES=str(TP_PAGED_HOST_BYTES * cfg.n_layers // 9),
        SKYTPU_KV_SPILL_DIR=spill)
    figs, kbs = {}, {}
    try:
        health = _health(url)
        if (health['tp'], health['tp_backend'], health['role']) != (
                tp, backend, 'decode'):
            raise AssertionError(f'{label} /health {health["tp"]} '
                                 f'{health["tp_backend"]} {health["role"]}')
        pre_srv = srv_lib.LlmServer('bench-1b', role='prefill',
                                    kv_layout='paged', max_len=1024)
        with _served(pre_srv) as pre_url:
            for name, reqs in rounds:
                d0 = health['engine']['pipeline']['dispatches']
                t0 = time.monotonic()
                answers = _post_all(url, reqs)
                wall = time.monotonic() - t0
                _check_answers(reqs, answers, vocab)
                last = (reqs, answers)
                health = _tp_drained(url)
                kbs[name] = _tp_reconciled(label, name, health)
                figs[name] = {
                    'wall_s': round(wall, 3),
                    'dispatches': health['engine']['pipeline']['dispatches']
                    - d0, 'tokens': sum(r['max_new_tokens'] for r in reqs)}
            _phase(f'  {label} traffic done')
            handoff_figs, got = {}, []
            for p in prompts:
                tokens, fig = _handoff(pre_url, url, {
                    'tokens': [p], 'max_new_tokens': TP_NEW})
                got.append(tokens)
                handoff_figs[len(p)] = fig
            health = _tp_drained(url)
            kbs['handoffs'] = _tp_reconciled(label, 'handoffs', health)
            colo = [_post(pre_url, {'tokens': [p], 'max_new_tokens': TP_NEW}
                          )[1]['tokens'][0] for p in prompts]
            parts = [_check_greedy(gen_lib, pre_srv, p, g, False)
                     for p, g in zip(prompts, got)]
            colo_parts = [_check_greedy(gen_lib, pre_srv, p, c, False)
                          for p, c in zip(prompts, colo)]
            # The last round (greedy) was served from share hits and
            # promoted blocks: the heads the tier gathered and scattered.
            again_parts = [_check_greedy(gen_lib, pre_srv, r['tokens'][0],
                                         a[1]['tokens'][0], False)
                           for r, a in zip(*last)]
        # The tp 1 replica's weights and pool leave the card now: the
        # phases after this one (--nccl's 19d on one rank) need it whole.
        del pre_srv
        gc.collect()
        torch.cuda.empty_cache()
        eng = health['engine']
        tiers, share = eng['kv_tiers'], eng['prefix_share']
        if (share['hits'] < 1 or share['evictions'] < 1
                or tiers['demotes'] < 1 or tiers['spills'] < 1
                or tiers['fetches'] + tiers['promotes'] < 1
                or tiers['corrupt'] or tiers['quarantined']):
            raise AssertionError(f'{label}: sharing and tiers under '
                                 f'pressure: {share} {tiers}')
        disagg = health['disagg']
        if (health['role'], disagg['imports'],
                disagg['fallbacks_served']) != ('decode', len(prompts), 0):
            raise AssertionError(f'{label} /health role {health["role"]} '
                                 f'disagg {disagg}')
        summaries, stop_s = _tp_stop(procs, logs, label, tp)
    except (AssertionError, OSError, KeyError) as exc:
        raise _with_logs(label, logs, exc) from exc
    finally:
        _tp_kill(procs)
        shutil.rmtree(spill, ignore_errors=True)
    launches = _check_rank_launches(label, summaries, cfg,
                                    eng['chunk_steps'], backend)
    _ranks_agree(label, summaries, ('kv_blocks', 'share', 'tier_counts',
                                    'disagg', 'prefill_tokens'))
    free, owned, shared, cached = summaries[0]['kv_blocks']
    if owned or shared or free + cached != eng['kv_blocks']['usable']:
        raise AssertionError(f'{label}: the ranks\' accounts at exit '
                             f'{summaries[0]["kv_blocks"]}')
    card = _card()
    for name, f in figs.items():
        print(f'  [{card}] {label} {name}: {f["tokens"]} tokens in '
              f'{f["wall_s"]} s = {f["tokens"] / f["wall_s"]:.1f} tok/s, '
              f'{f["dispatches"]} dispatches; blocks after the drain '
              f'{kbs[name]}', flush=True)
    for n, f in handoff_figs.items():
        print(f'  [{card}] {label} handoff (tp 1 prefill -> tp {tp} decode)'
              f' prompt {n}: export {f["export_ms"]:.2f} ms, payload '
              f'{f["bytes"]} B ({f["skip"]} blocks skipped), fetch '
              f'{f["fetch_ms"]:.2f} ms, import {f["import_ms"]:.2f} ms (to '
              f'its first line), TTFT {f["ttft_ms"]:.2f} ms, decode '
              f'{(TP_NEW - 1) / f["decode_s"]:.1f} tok/s', flush=True)
    print(f'  {label}: share {share}; tiers {tiers}; tier decisions '
          f'(evicted, promoted, parked, fetches done) '
          f'{summaries[0]["tier_counts"]} on every rank; the preambles '
          f'again against generate(): partings {again_parts}; handoffs '
          f'{TP_LONE} x {TP_NEW} against generate(): partings (position, '
          f'top-2 gap) {parts}, the tp 1 paged replica\'s own {colo_parts},'
          f' equal to it {sum(a == b for a, b in zip(got, colo))} of '
          f'{len(got)}; K4 launches by rank {launches} (Hkv '
          f'{cfg.n_kv_heads // tp} per rank); healthy {boot_s:.1f} s after '
          f'spawn, every rank out {stop_s:.1f} s after SIGTERM',
          flush=True)
    return launches


def tp_spec_phase(srv_lib, gen_lib, llama, log_dir, label='18d',
                  layers=None):
    """18d: ``llm_server --model bench-1b --tp 2 --draft-model
    bench-draft`` (k SPEC_K, slot layout, bf16): phase 8's 24 concurrent
    requests whole and its stream = the request not streamed, then 4 lone
    greedy requests equal a tp 1 replica without a draft or part where its
    top-2 gap < GREEDY_GAP_LIMIT; rounds > 0; every rank's speculative
    counters and digest equal, and its K4 calls = the draft's layers x
    (k + 1) x rounds at the draft's shard (B=16, Hq 4, Hkv 4, D 64): the
    target's verify is the k+1-position einsum. Returns K4's launches per
    rank."""
    cfg, d_cfg = llama.PRESETS['bench-1b'], llama.PRESETS['bench-draft']
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in TP_LONE]
    procs, logs, url, boot_s = _tp_replica(
        TP_SPEC_ARGV, 1, log_dir, label, layers=layers,
        SKYTPU_LLM_SPEC_K=str(SPEC_K))
    try:
        health = _health(url)
        if (health['tp'], health['draft_model']) != (2, 'bench-draft'):
            raise AssertionError(f'{label} /health {health}')
        reqs, stream_req = _engine_traffic(cfg.vocab_size)
        t0 = time.monotonic()
        answers = _post_all(url, reqs)
        wall = time.monotonic() - t0
        _check_answers(reqs, answers, cfg.vocab_size)
        _check_stream(url, stream_req, *_post_stream(url, stream_req))
        # Sent together: with random weights the draft accepts nothing,
        # so each lone request would take TP_NEW rounds of its own.
        lone = _lone_greedy(url, prompts, TP_NEW, together=True)
        spec = _health(url)['engine']['speculative']
        summaries, stop_s = _tp_stop(procs, logs, label, 2)
    except (AssertionError, OSError, KeyError) as exc:
        raise _with_logs(label, logs, exc) from exc
    finally:
        _tp_kill(procs)
    _ranks_agree(label, summaries, ('sampled_digest', 'speculative',
                                    'dispatches'))
    rounds = summaries[0]['speculative'][0]
    if not rounds or rounds != spec['rounds']:
        raise AssertionError(f'{label}: rounds {summaries[0]} {spec}')
    want = d_cfg.n_layers * (SPEC_K + 1) * rounds
    launches = [s['flash_decode_launches'] for s in summaries]
    if launches != [want] * 2:
        raise AssertionError(f'{label}: K4 launched {launches} times by '
                             f'rank; expected {want} (draft layers x (k + '
                             f'1) x rounds)')
    _, _, parts = _tp_reference(srv_lib, gen_lib, 'bench-1b', prompts,
                                lone, False, max_len=1024)
    tokens = sum(r['max_new_tokens'] for r in reqs)
    print(f'  [{_card()}] {label} bench-1b + bench-draft tp 2, k {SPEC_K}:'
          f' {tokens} tokens of 24 concurrent requests in {wall:.2f} s = '
          f'{tokens / wall:.1f} tok/s; speculative {spec}; lone greedy '
          f'{TP_LONE} x {TP_NEW} against tp 1 without a draft: partings '
          f'(position, top-2 gap) {parts}; K4 launches by rank {launches} '
          f'= {d_cfg.n_layers} x {SPEC_K + 1} x {rounds} rounds (Hq '
          f'{d_cfg.n_heads // 2}, Hkv {d_cfg.n_kv_heads // 2} per rank); '
          f'healthy {boot_s:.1f} s after spawn, every rank out '
          f'{stop_s:.1f} s after SIGTERM', flush=True)
    return launches


def tp_moe_phase(srv_lib, gen_lib, llama, log_dir, label='18e',
                 layers=None):
    """18e: ``llm_server --model moe-8x1b --tp 2`` (bf16 + bf16 KV):
    phase 8's 24 concurrent requests whole and its stream, then a lone
    greedy request equal to a tp 1 moe-8x1b replica or parted where its
    top-2 gap < GREEDY_GAP_LIMIT; the ranks' weight bytes sum to tp 1's
    plus the replicated leaves' copies (the router, the norms) with no
    rank holding the whole model, so each rank holds half of every
    expert's mlp columns; digests equal; K4 = n_layers x chunk_steps x
    dispatches a rank. Returns K4's launches per rank."""
    cfg = llama.PRESETS['moe-8x1b']
    rng = np.random.default_rng(24)
    prompt = rng.integers(0, cfg.vocab_size, 128).tolist()
    procs, logs, url, boot_s = _tp_replica(TP_MOE_ARGV, 1, log_dir, label,
                                           layers=layers)
    try:
        if _health(url)['tp'] != 2:
            raise AssertionError(f'{label} /health tp')
        reqs, stream_req = _engine_traffic(cfg.vocab_size)
        t0 = time.monotonic()
        answers = _post_all(url, reqs)
        wall = time.monotonic() - t0
        _check_answers(reqs, answers, cfg.vocab_size)
        _check_stream(url, stream_req, *_post_stream(url, stream_req))
        lone = _lone_greedy(url, [prompt], TP_NEW)
        eng = _health(url)['engine']
        summaries, stop_s = _tp_stop(procs, logs, label, 2)
    except (AssertionError, OSError, KeyError) as exc:
        raise _with_logs(label, logs, exc) from exc
    finally:
        _tp_kill(procs)
    launches = _check_rank_launches(label, summaries, cfg,
                                    eng['chunk_steps'])
    whole, replicated, parts = _tp_reference(
        srv_lib, gen_lib, 'moe-8x1b', [prompt], lone, False, max_len=1024)
    per_rank = _check_param_bytes(label, summaries, whole, replicated)
    tokens = sum(r['max_new_tokens'] for r in reqs)
    print(f'  [{_card()}] {label} moe-8x1b tp 2 at {cfg.n_layers} of 18 '
          f'layers: {tokens} tokens of 24 concurrent requests in '
          f'{wall:.2f} s = {tokens / wall:.1f} tok/s, pipeline depth '
          f'{eng["pipeline"]["pipeline_depth"]}; lone greedy 128 x '
          f'{TP_NEW} against tp 1: parting (position, top-2 gap) {parts}; '
          f'weights by rank {per_rank} B, tp 1 {whole} B, replicated '
          f'leaves {replicated} B; K4 launches by rank {launches}; healthy '
          f'{boot_s:.1f} s after spawn, every rank out {stop_s:.1f} s '
          'after SIGTERM', flush=True)
    return launches


def tp_phase(srv_lib, gen_lib, llama, axes_gang):
    """Phase 18. 18f's gang runs beside all the others, and 18g's
    (``axes_gang``, started before phase 17) is checked beside them: 18a
    beside 18b, then 18c-18e beside each other. Returns K4's launches per
    rank of 18a (bf16) and 18b (int8), and of 18c-18g."""
    print(f'  two NCCL ranks on one card: {_nccl_refusal()}', flush=True)
    log_dir = tempfile.mkdtemp(prefix='skytpu-tp-')
    t0 = time.perf_counter()
    try:
        with _cut_depth(llama, 'bench-1b', SERVE_LAYERS), \
                _cut_depth(llama, 'moe-8x1b', SERVE_LAYERS), \
                _cut_depth(llama, 'llama3-8b', TP8_LAYERS), \
                concurrent.futures.ThreadPoolExecutor(2) as pool:
            data = pool.submit(_side_by_side, '18f', {
                '18f': lambda: tp_data_phase(srv_lib, gen_lib, llama,
                                             log_dir)})
            axes = pool.submit(_side_by_side, '18g', {
                '18g': lambda: serve_axes_phase(srv_lib, gen_lib, llama,
                                                axes_gang)})
            bench, recipe = _side_by_side('18a-18b', {
                '18a': lambda: tp_bench_phase(srv_lib, gen_lib, llama,
                                              log_dir, layers=SERVE_LAYERS),
                '18b': lambda: tp_recipe_phase(srv_lib, gen_lib, llama,
                                               log_dir, layers=TP8_LAYERS)})
            more = tp_options_phase(srv_lib, gen_lib, llama, log_dir)
            more['18f'] = data.result()[0]
            more['18g'] = axes.result()[0]
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    _phase(f'  18a-18g: {time.perf_counter() - t0:.1f} s')
    return bench, recipe, more


def _side_by_side(what, jobs):
    """Run ``jobs`` (label -> callable) at once, each on a thread of its
    own, so that the script's time limit holds them all: phases whose
    replicas are processes of their own, which wait on their ranks'
    startup and on the host more than on the card. Returns their results
    in order once all have ended, or raises the first failure then."""
    t0 = time.perf_counter()

    def timed(label, job):
        t1 = time.perf_counter()
        out = job()
        _phase(f'  {label} done ({time.perf_counter() - t1:.1f} s)')
        return out
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = [pool.submit(timed, label, job)
                   for label, job in jobs.items()]
    out = [f.result() for f in futures]
    _phase(f'  {what} side by side: {time.perf_counter() - t0:.1f} s')
    return out


def tp_options_phase(srv_lib, gen_lib, llama, log_dir):
    """18c-18e side by side: the paged layout with sharing, tiers and the
    decode role, a draft, and an MoE model on a tp 2 replica each.
    Returns K4's launches per rank of each."""
    with _cut_depth(llama, 'bench-1b', SERVE_LAYERS), \
            _cut_depth(llama, 'moe-8x1b', SERVE_LAYERS):
        out = _side_by_side('18c-18e', {
            label: lambda phase=phase: phase(srv_lib, gen_lib, llama,
                                             log_dir, layers=SERVE_LAYERS)
            for label, phase in (('18c', tp_paged_phase),
                                 ('18d', tp_spec_phase),
                                 ('18e', tp_moe_phase))})
    return dict(zip(('18c', '18d', '18e'), out))


# 18f: the continuous engine on data=2,tensor=2 (no flag reaches the
# data axis in serving: ``SpmdEngine(mesh=)`` in a gang, as JAX's
# ``ContinuousEngine(mesh=)``), every rank a process.
DP_SPEC = {'data': 2, 'fsdp': 1, 'tensor': 2}
DP_WORLD = 4
DP_SLOTS, DP_MAX_LEN = 16, 1024
DP_RUN_S = 900
_DATA_SERVE_SCRIPT = r"""
import dataclasses, json, os, sys, tempfile, time, zlib
import torch
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import decode_attention as da
from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.parallel import gang as gang_lib
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.serve import disagg, llm_server, spmd

with open(sys.argv[2]) as f:  # the plan: too long for a command line
    plan = json.load(f)
world, out_dir, label = int(sys.argv[1]), sys.argv[3], sys.argv[4]
for name, n_layers in plan['layers'].items():  # depth cuts, widths whole
    llama.PRESETS[name] = dataclasses.replace(llama.PRESETS[name],
                                              n_layers=n_layers)
gang = gang_lib.initialize(world, 'cuda', sys.argv[1:],
                           [sys.executable, __file__], label)
dev = gang.device
torch.cuda.set_device(dev)
meshes = {}

def mesh_for(spec):
    # Built once for each spec, in the plan's order on every rank.
    key = json.dumps(spec, sort_keys=True)
    if key not in meshes:
        meshes[key] = mesh_lib.build_mesh(mesh_lib.MeshSpec(**spec),
                                          device=dev)
    return meshes[key]
kernel = da.flash_decode
shapes = set()

def recording(q, k, *args, **kw):
    shapes.add((q.shape[0], q.shape[1], k.shape[1]))
    return kernel(q, k, *args, **kw)
# generate.py looks it up at each call, and the wrapper counts its
# launches on the module's name, so on this one.
recording.launches = 0
da.flash_decode = recording

def weights(name, seed, mesh):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return llama.init_params_sharded(llama.PRESETS[name], gen, mesh,
                                     device=dev)

def leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    return [tree]

def submit(eng, r, **kw):
    return eng.submit(r['tokens'][0], r['max_new_tokens'],
                      temperature=r.get('temperature', 0.0),
                      top_k=r.get('top_k', 0), top_p=r.get('top_p', 1.0),
                      **kw)

def drive(eng, run, got):
    if run.get('reqs'):
        t0 = time.perf_counter()
        futs = [submit(eng, r) for r in run['reqs']]
        got['answers'] = [list(f.result(timeout=900)) for f in futs]
        got['wall'] = time.perf_counter() - t0
        lines = []
        sreq = run['stream']
        streamed = list(submit(eng, sreq, on_tokens=lambda t: lines.append(
            list(t))).result(timeout=900))
        again = list(submit(eng, sreq).result(timeout=900))
        got['stream'] = [len(lines), sum(lines, []) == streamed,
                         streamed == again, len(streamed)]
    if run.get('lone') and not run.get('export'):
        futs = [eng.submit(p, run['new']) for p in run['lone']]
        got['lone'] = [list(f.result(timeout=900)) for f in futs]
    if run.get('export'):
        # At once, as the slot run sent them: one prefill group of the
        # same shape, so the planes and first tokens are its bits.
        futs = [eng.submit_prefill(p, run['new']) for p in run['lone']]
        got['payloads'] = []
        for f in futs:
            h = f.result(timeout=900)
            got['payloads'].append(disagg.serialize_bytes(
                h, disagg.build_header(h, model=run['model'],
                                       kv_cache='bf16')))
    if run.get('import'):
        futs = []
        for data in handoffs:
            header, arrays = disagg.parse(data)
            futs.append(eng.submit_import(**disagg.import_kwargs(
                header, arrays)))
            got['heads'] = int(arrays['k'].shape[2])
        got['lone'] = [list(f.result(timeout=900)) for f in futs]

handoffs = []
records = []
for run in plan['runs']:
    t_run = time.perf_counter()
    os.environ.update(run.get('env', {}))
    spill = None
    if run.get('spill'):
        spill = tempfile.mkdtemp(prefix='kvspill-', dir=out_dir)
        os.environ['SKYTPU_KV_SPILL_DIR'] = spill
    mesh = mesh_for(run.get('mesh', plan['mesh']))
    params = weights(run['model'], 0, mesh)
    kw = dict(run.get('kw', {}))
    if run.get('draft'):
        kw.update(draft_params=weights(run['draft'], 1, mesh),
                  draft_cfg=llama.PRESETS[run['draft']])
    torch.cuda.empty_cache()
    collectives.reset_stats()
    recording.launches = 0
    shapes.clear()
    eng = spmd.SpmdEngine(params, llama.PRESETS[run['model']],
                          slots=plan['slots'], max_len=plan['max_len'],
                          mesh=mesh, device=dev, **kw)
    layers = eng.params['layers']
    got = {'name': run['name'], 'rank': gang.rank,
           'coords': [mesh.axis_index('data'), mesh.axis_index('tensor')],
           'at': {a: mesh.axis_index(a) for a in mesh.axis_names},
           'param_bytes': sum(t.numel() * t.element_size()
                              for t in leaves(eng.params)),
           'shapes': {'wq': list(layers['wq'].shape),
                      'embed': list(eng.params['embed'].shape),
                      'we_gate': list(layers['moe']['we_gate'].shape)
                      if 'moe' in layers else None},
           'backend': gang.backend,
           'cache_bytes': sum(t.numel() * t.element_size()
                              for t in (eng._cache.k, eng._cache.v)),
           'cache_shape': list(eng._cache.k.shape)}
    if gang.rank == 0:
        drive(eng, run, got)
        if eng._kv_tiers is not None:
            eng._kv_tiers.quiesce(60)
            got['tiers'] = eng._kv_tiers.stats()
        eng.stop()
    else:
        eng.start()
        eng._thread.join()
    if eng.fatal is not None:
        raise SystemExit(f'{label} {run["name"]} rank {gang.rank}: '
                         f'{eng.fatal}')
    torch.cuda.synchronize(dev)
    st = eng.stats()
    got.update(digest=eng.sampled_digest, dispatches=eng.dispatches,
               gap_ms=st['pipeline']['dispatch_gap_ms'],
               k4=recording.launches, k4_shapes=sorted(shapes),
               state=llm_server._rank_engine_state(eng),
               kv_blocks=st['kv_blocks'], spec=st['speculative'],
               collectives=collectives.STATS['calls'],
               collective_s=collectives.STATS['seconds'],
               peak=torch.cuda.max_memory_allocated(dev),
               run_s=time.perf_counter() - t_run)
    if eng.kv_layout == 'paged':  # block 0 is the junk sink: no request's
        got['pool_crc'] = zlib.crc32(b''.join(
            t[:, 1:].contiguous().view(torch.uint8).cpu().numpy().tobytes()
            for t in (eng._cache.k, eng._cache.v)))
    if run.get('export') and gang.rank == 0:
        handoffs = got.pop('payloads')
    records.append(got)
    for k in list(run.get('env', {})) + ['SKYTPU_KV_SPILL_DIR']:
        os.environ.pop(k, None)
    del eng, params, kw
    torch.cuda.empty_cache()
with open(os.path.join(out_dir, f'{label}.{gang.rank}.json'), 'w') as f:
    json.dump(records, f)
gang.close(60)
sys.stdout.flush()
os._exit(0)
"""


def _dp_plan(llama, layers):
    """18f's runs: the slot layout, the paged layout (blocks of 16,
    ``--kv-blocks`` 257, sharing and tiers on), then MoE, a draft and the
    prefill and decode roles; bench-1b, moe-8x1b at ``layers`` layers."""
    cfg = llama.PRESETS['bench-1b']
    reqs, stream = _engine_traffic(cfg.vocab_size)
    rng = np.random.default_rng(17)
    lone = [rng.integers(0, cfg.vocab_size, n).tolist() for n in TP_LONE]
    moe_prompt = np.random.default_rng(24).integers(
        0, llama.PRESETS['moe-8x1b'].vocab_size, 128).tolist()
    host = str(TP_PAGED_HOST_BYTES * layers // 9)
    return {'mesh': DP_SPEC, 'slots': DP_SLOTS, 'max_len': DP_MAX_LEN,
            'layers': {'bench-1b': layers, 'moe-8x1b': layers},
            'runs': [
                {'name': 'slot', 'model': 'bench-1b', 'reqs': reqs,
                 'stream': stream, 'lone': lone, 'new': TP_NEW},
                {'name': 'paged', 'model': 'bench-1b', 'reqs': reqs,
                 'stream': stream, 'lone': lone, 'new': TP_NEW,
                 'kw': {'kv_layout': 'paged', 'kv_blocks': 257},
                 'env': {'SKYTPU_KV_HOST_BYTES': host}, 'spill': True},
                # Run-length cuts (PERF.md section 4): the lone requests
                # go at once; the options serve 8 of the 24 requests
                # (MoE), the lone requests alone (a draft), the lone
                # requests handed off (the roles).
                {'name': 'moe', 'model': 'moe-8x1b', 'reqs': reqs[:8],
                 'stream': stream, 'lone': [moe_prompt], 'new': TP_NEW},
                {'name': 'spec', 'model': 'bench-1b', 'draft': 'bench-draft',
                 'lone': lone, 'new': TP_NEW,
                 'env': {'SKYTPU_LLM_SPEC_K': str(SPEC_K)}},
                {'name': 'prefill', 'model': 'bench-1b', 'export': True,
                 'lone': lone, 'new': TP_NEW, 'kw': {'role': 'prefill'}},
                {'name': 'decode', 'model': 'bench-1b', 'import': True,
                 'kw': {'role': 'decode'}}]}


def _dp_spawn(plan, log_dir, label, world=DP_WORLD):
    """Start ``_DATA_SERVE_SCRIPT`` as ``world`` ranks, in a session of
    their own; returns the handle that ``_dp_collect`` reads."""
    script = os.path.join(log_dir, f'serve_{label}.py')
    with open(script, 'w') as f:
        f.write(_DATA_SERVE_SCRIPT)
    plan_path = os.path.join(log_dir, f'{label}.plan.json')
    with open(plan_path, 'w') as f:
        json.dump(plan, f)
    log = os.path.join(log_dir, f'{label}.log')
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    with open(log, 'a') as out:  # O_APPEND: the ranks write to it
        proc = subprocess.Popen([sys.executable, script, str(world),
                                 plan_path, log_dir, label],
                                stdout=out, stderr=subprocess.STDOUT,
                                env=env, start_new_session=True)
    return {'proc': proc, 'plan': plan, 'log_dir': log_dir, 'log': log,
            'label': label, 'world': world, 't0': time.monotonic()}


def _dp_stop(gang):
    """Kill what is left of a gang's session and reap its head."""
    try:
        os.killpg(gang['proc'].pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    gang['proc'].wait()


def _dp_collect(gang):
    """Wait for a gang (at most ``DP_RUN_S`` from its start), stop what is
    left of it, and return each run's records by rank."""
    proc = gang['proc']
    try:
        proc.wait(max(1.0, gang['t0'] + DP_RUN_S - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        _dp_stop(gang)
    text = open(gang['log'], errors='replace').read()
    if proc.returncode:
        raise AssertionError(f'{gang["label"]} exited {proc.returncode}:\n'
                             f'{text[-6000:]}')
    ranks = []
    for r in range(gang['world']):
        with open(os.path.join(gang['log_dir'],
                               f'{gang["label"]}.{r}.json')) as f:
            ranks.append(json.load(f))
    return {run['name']: [recs[i] for recs in ranks]
            for i, run in enumerate(gang['plan']['runs'])}


def _dp_gang(plan, log_dir, label, world=DP_WORLD):
    """``_DATA_SERVE_SCRIPT`` as ``world`` ranks; returns each run's
    records by rank."""
    return _dp_collect(_dp_spawn(plan, log_dir, label, world))


def _dp_check(label, name, ranks, cfg, want_k4, shape):
    """Every rank of run ``name`` read the same tokens and took the same
    decisions, and launched K4 ``want_k4(rank record)`` times at
    ``shape`` (B, Hq, Hkv)."""
    if len({r['digest'] for r in ranks}) != 1 or not ranks[0]['digest']:
        raise AssertionError(f'{label} {name}: digests by rank '
                             f'{[r["digest"] for r in ranks]}')
    if len({json.dumps(r['state'], sort_keys=True) for r in ranks}) != 1:
        raise AssertionError(f'{label} {name}: rank states '
                             f'{[r["state"] for r in ranks]}')
    for r in ranks:
        want = want_k4(r)
        if r['k4'] != want or not want \
                or r['k4_shapes'] != [list(shape)]:
            raise AssertionError(f'{label} {name}: rank {r["rank"]} K4 '
                                 f'{r["k4"]} at {r["k4_shapes"]}, '
                                 f'expected {want} at {list(shape)}')
    return [r['k4'] for r in ranks]


def tp_data_phase(srv_lib, gen_lib, llama, log_dir, label='18f',
                  layers=SERVE_LAYERS, world=DP_WORLD):
    """18f: ``serve.spmd.SpmdEngine`` on data=2,tensor=2, four ranks in
    one gang (gloo on the one card; NCCL a card a rank under
    ``--nccl``), bench-1b at ``layers`` layers, 16 slots, max_len 1024,
    bf16 + bf16 KV. The slot layout, then the paged layout (blocks of 16,
    257 blocks, sharing and tiers on), each with phase 8's 24 requests
    whole, its stream adding up to its answer (= the request not
    streamed, but on the paged layout, where it is a share hit), and 4
    lone greedy requests (17, 128, 300, 900 x 64) against a tp 1 replica
    of the same
    seed under the gap rule; then moe-8x1b (8 of the requests and a lone
    greedy one against tp 1), bench-1b with bench-draft (the lone
    requests at once, rounds > 0, against tp 1) and the prefill and
    decode roles (the lone prompts exported with whole heads and
    imported: against tp 1 under the gap rule). In every run
    every rank's digest and engine state equal and K4 calls = n_layers x
    chunk_steps x dispatches (the draft's: its layers x (k+1) x rounds)
    at the rank's block, B=8 Hq 8 Hkv 4 (the draft's Hq 4 Hkv 4); a
    slot-layout rank holds a quarter of tp 1's cache; the paged block
    accounts reconcile and the pools (but the junk sink) are equal across
    the data ranks of one tensor index. Returns K4's launches per rank
    by run."""
    cfg = dataclasses.replace(llama.PRESETS['bench-1b'], n_layers=layers)
    moe_cfg = dataclasses.replace(llama.PRESETS['moe-8x1b'],
                                  n_layers=layers)
    d_cfg = llama.PRESETS['bench-draft']
    plan = _dp_plan(llama, layers)
    t0 = time.monotonic()
    runs = _dp_gang(plan, log_dir, label, world)
    wall = time.monotonic() - t0
    out = {}
    b = DP_SLOTS // DP_SPEC['data']
    shape = (b, cfg.n_heads // 2, cfg.n_kv_heads // 2)
    chunk = 8  # SKYTPU_LLM_CHUNK_STEPS's default
    for name in ('slot', 'paged', 'moe', 'decode'):
        c = moe_cfg if name == 'moe' else cfg
        out[name] = _dp_check(
            label, name, runs[name], c,
            lambda r, c=c: c.n_layers * chunk * r['dispatches'],
            (b, c.n_heads // 2, c.n_kv_heads // 2))
    rounds = runs['spec'][0]['spec']['rounds']
    out['spec'] = _dp_check(
        label, 'spec', runs['spec'], d_cfg,
        lambda r: d_cfg.n_layers * (SPEC_K + 1) * rounds,
        (b, d_cfg.n_heads // 2, d_cfg.n_kv_heads // 2))
    if any(r['k4'] for r in runs['prefill']):
        raise AssertionError(f'{label}: the prefill role decoded')
    head = {name: recs[0] for name, recs in runs.items()}
    whole = (2 * cfg.n_layers * DP_SLOTS * cfg.n_kv_heads * DP_MAX_LEN
             * cfg.head_dim * torch.tensor([], dtype=cfg.dtype).element_size())
    if any(4 * r['cache_bytes'] != whole for r in runs['slot']):
        raise AssertionError(f'{label}: slot-layout ranks hold '
                             f'{[r["cache_bytes"] for r in runs["slot"]]} '
                             f'B of cache, not a quarter of {whole}')
    for name in ('slot', 'paged', 'moe'):
        h = head[name]
        reqs = plan['runs'][[r['name'] for r in plan['runs']].index(name)][
            'reqs']
        _check_answers(reqs, [(200, {'tokens': [a]}) for a in h['answers']],
                       cfg.vocab_size)
        # The lines add up to the answer; on the paged layout the request
        # again is a share hit of the stream's committed blocks (another
        # order of sums), so only the slot layouts repeat it exactly.
        n_lines, adds_up, same, n = h['stream']
        if not adds_up or n != 40 or n_lines < 2 \
                or not (same or name == 'paged'):
            raise AssertionError(f'{label} {name}: the stream {h["stream"]}')
    for r in runs['paged']:
        kb = r['kv_blocks']
        if kb['owned'] or kb['free'] + kb['cached'] != kb['usable'] \
                or kb['used'] != kb['cached']:
            raise AssertionError(f'{label} paged: rank {r["rank"]} blocks '
                                 f'{kb}')
    for t in range(DP_SPEC['tensor']):
        crcs = {r['pool_crc'] for r in runs['paged'] if r['coords'][1] == t}
        if len(crcs) != 1:
            raise AssertionError(f'{label} paged: tensor index {t} pools '
                                 f'differ across data: {crcs}')
    if head['decode']['heads'] != cfg.n_kv_heads:
        raise AssertionError(f'{label}: handoffs of '
                             f'{head["decode"]["heads"]} kv heads')
    if not rounds:
        raise AssertionError(f'{label}: no speculative round')
    prompts = plan['runs'][0]['lone']
    with _cut_depth(llama, 'bench-1b', layers), \
            _cut_depth(llama, 'moe-8x1b', layers):
        server = srv_lib.LlmServer('bench-1b', engine='off', max_len=1024)
        try:
            parts = {name: [_check_greedy(gen_lib, server, p, got, False)
                            for p, got in zip(prompts, head[name]['lone'])]
                     for name in ('slot', 'paged', 'spec', 'decode')}
        finally:
            server.stop()
            del server
            torch.cuda.empty_cache()
        parts['moe'] = _tp_reference(
            srv_lib, gen_lib, 'moe-8x1b', plan['runs'][2]['lone'],
            head['moe']['lone'], False, max_len=1024)[2]
    card = _card()
    for name in ('slot', 'paged', 'moe'):
        h = head[name]
        tokens = sum(len(a) for a in h['answers'])
        steps = [r['dispatches'] * chunk for r in runs[name]]
        per_step = [round(r['collectives'] / n, 1)
                    for r, n in zip(runs[name], steps)]
        model = 'moe-8x1b' if name == 'moe' else 'bench-1b'
        print(f'  [{card}] {label} {name} ({model} '
              f'at {layers} layers, data=2,tensor=2, {world} ranks, '
              f'{h["backend"]}): {len(h["answers"])} concurrent requests, '
              f'{tokens} tokens in {h["wall"]:.2f} s = '
              f'{tokens / h["wall"]:.2f} tok/s; lone greedy against tp 1: '
              f'partings (position, top-2 gap) {parts[name]}; K4 by rank '
              f'{out[name]} at B={b} Hq {shape[1]} Hkv {shape[2]}; '
              f'collectives by rank {per_step} a decode step of its life; '
              f'peak by rank '
              f'{[r["peak"] for r in runs[name]]} B; cache by rank '
              f'{[r["cache_bytes"] for r in runs[name]]} B', flush=True)
    same = sum(a == b for a, b in zip(head['decode']['lone'],
                                      head['slot']['lone']))
    print(f'  {label}: slot-layout cache a rank '
          f'{runs["slot"][0]["cache_bytes"]} B = tp 1\'s {whole} / 4; paged '
          f'blocks {head["paged"]["kv_blocks"]}, tiers '
          f'{head["paged"].get("tiers")}, pools equal across data by '
          f'tensor index; spec rounds {rounds}, {head["spec"]["spec"]}, '
          f'partings {parts["spec"]}; handoffs of {TP_LONE} with whole '
          f'heads ({head["decode"]["heads"]}): partings {parts["decode"]}, '
          f'{same} of {len(TP_LONE)} = the slot run\'s answers (prefill '
          f'groups follow arrival); digests equal on every rank in '
          f'every run; gang {wall:.1f} s, the head\'s seconds by run '
          f'{ {n: round(recs[0]["run_s"], 1) for n, recs in runs.items()} }',
          flush=True)
    return out


# 18g: the continuous engine on the other axes JAX serves on (fsdp, pipe,
# seq, expert), each beside tensor, in one gang of four ranks, the meshes
# in turn (``SpmdEngine(mesh=)``, as 18f: no flag builds these meshes).
AXES_MESHES = {'fsdp2_tp2': {'fsdp': 2, 'tensor': 2},
               'pipe2_tp2': {'pipe': 2, 'fsdp': 1, 'tensor': 2},
               'seq2_tp2': {'seq': 2, 'fsdp': 1, 'tensor': 2},
               'expert2_tp2': {'expert': 2, 'fsdp': 1, 'tensor': 2}}
# --nccl: moe-8x1b on expert=4 at all of its layers, and bench-1b on
# pipe=2,tensor=2, a card a rank.
NCCL_AXES_MESHES = {'expert4': {'expert': 4, 'fsdp': 1},
                    'pipe2_tp2': AXES_MESHES['pipe2_tp2']}


def _axes_plan(llama, layers, meshes=AXES_MESHES):
    """18g's runs: on each mesh the slot layout and the paged layout (18f's
    paged run: blocks of 16, 257 blocks, sharing and tiers on), with 18f's
    traffic: bench-1b phase 8's 24 requests, its stream and the 4 lone
    greedy requests; moe-8x1b (the ``expert`` meshes) 8 of them, the
    stream and a lone greedy request, as 18f's MoE run. A run-length cut
    for the script's time limit, as 18f's MoE run's: 8 of the 24
    requests on every mesh."""
    base = _dp_plan(llama, layers)
    by_name = {run['name']: run for run in base['runs']}
    runs = []
    for mesh_name, spec in meshes.items():
        moe = 'expert' in mesh_name
        for layout in ('slot', 'paged'):
            run = dict(by_name['moe' if moe else 'slot'],
                       name=f'{mesh_name} {layout}', mesh=spec)
            run['reqs'] = run['reqs'][:8]
            if layout == 'paged':
                for key in ('kw', 'env', 'spill'):
                    run[key] = by_name['paged'][key]
            runs.append(run)
    return dict(base, runs=runs)


def _rank_weight_bytes(llama, cfg, spec):
    """The bytes of one rank's slices of a ``cfg`` tree on a mesh of
    ``spec``, by JAX's rules (the router float32)."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel import sharding as sharding_lib
    sizes = dict(dict.fromkeys(mesh_lib.AXIS_ORDER, 1), **spec)
    mesh = mesh_lib.Mesh(sizes, torch.device('cpu'))
    rules = sharding_lib.ShardingRules()
    elt = torch.tensor([], dtype=cfg.dtype).element_size()
    total = 0

    def walk(shapes, axes, name=''):
        nonlocal total
        if isinstance(shapes, dict):
            for k in shapes:
                walk(shapes[k], axes[k], k)
            return
        local = sharding_lib.local_shape(shapes, sharding_lib.logical_sharding(
            mesh, rules, axes))
        total += math.prod(local) * (4 if name == 'router' else elt)
    walk(llama.param_shapes(cfg), llama.param_logical_axes(cfg))
    return total


def _check_slices(label, name, ranks, cfg, spec, want_bytes):
    """Each rank holds its slices: its layers (``pipe``), ``embed``
    columns (``fsdp``), heads (``tensor``) and experts (``expert``), and
    its weight bytes are those of its split; no rank holds a whole
    weight under ``fsdp`` nor the whole expert set under ``expert``."""
    a = dict(dict.fromkeys(('pipe', 'fsdp', 'expert', 'tensor'), 1), **spec)
    want = {'wq': [cfg.n_layers // a['pipe'], cfg.d_model // a['fsdp'],
                   cfg.n_heads // a['tensor'], cfg.head_dim],
            'embed': [cfg.vocab_size // a['tensor'],
                      cfg.d_model // a['fsdp']],
            'we_gate': None if not cfg.num_experts else [
                cfg.n_layers // a['pipe'], cfg.num_experts // a['expert'],
                cfg.d_model // a['fsdp'], cfg.d_ff // a['tensor']]}
    for r in ranks:
        if r['shapes'] != want or r['param_bytes'] != want_bytes:
            raise AssertionError(f'{label} {name}: rank {r["rank"]} holds '
                                 f'{r["shapes"]}, {r["param_bytes"]} B; '
                                 f'expected {want}, {want_bytes} B')


def start_serve_axes(llama, log_dir, label='18g', layers=SERVE_LAYERS,
                     meshes=AXES_MESHES, moe_layers=None):
    """Start 18g's gang: four ranks (gloo on the one card; NCCL a card a
    rank under ``--nccl``, with its own ``meshes``), bench-1b at
    ``layers`` layers and moe-8x1b at ``moe_layers`` (default
    ``layers``), each mesh's runs in turn (``_axes_plan``). Returns the
    handle that ``serve_axes_phase`` checks."""
    plan = _axes_plan(llama, layers, meshes)
    plan['layers']['moe-8x1b'] = moe_layers or layers
    return _dp_spawn(plan, log_dir, label, DP_WORLD)


def _only_expert(spec):
    """Whether a mesh splits nothing but the experts: each token's expert
    outputs are then summed over ``expert`` with exact zeros from the
    ranks that hold none of its experts, so its logits are one device's
    bit for bit."""
    return {a for a, n in spec.items() if n > 1} == {'expert'}


def _one_device_lone(llama, model, n_layers, run):
    """``run``'s lone greedy requests through a one-device engine of the
    same seed-0 weights, slots, max_len and layout, sent at once on an
    idle engine, as the gang's head sent them."""
    from skypilot_tpu_torch.models import engine as engine_lib
    cfg = dataclasses.replace(llama.PRESETS[model], n_layers=n_layers)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    params = llama.init_params(cfg, gen, device='cuda')
    eng = engine_lib.ContinuousEngine(params, cfg, slots=DP_SLOTS,
                                      max_len=DP_MAX_LEN, device='cuda',
                                      **run.get('kw', {}))
    eng.start()
    try:
        futs = [eng.submit(p, run['new']) for p in run['lone']]
        return [list(f.result(timeout=600)) for f in futs]
    finally:
        eng.stop()
        del eng, params
        torch.cuda.empty_cache()


def serve_axes_phase(srv_lib, gen_lib, llama, gang):
    """18g: ``serve.spmd.SpmdEngine`` on fsdp=2,tensor=2, pipe=2,tensor=2
    and seq=2,tensor=2 (bench-1b) and expert=2,tensor=2 (moe-8x1b), 16
    slots, max_len 1024, bf16 + bf16 KV, the slot and paged layouts of
    each mesh, served by ``gang`` (``start_serve_axes``). In every run
    every rank's digest and engine state are equal, its K4 calls are the
    layers it holds x chunk_steps x dispatches at its shard, and it holds
    exactly its slices; a slot-layout rank holds its share of tp 1's
    cache; the paged block accounts reconcile and the pools (but the junk
    sink) are equal on the ranks that hold the same layers and heads; the
    answers have their lengths, the stream adds up to its answer, and the
    lone greedy requests equal a tp 1 replica of the same seed under the
    gap rule, or, on a mesh that splits only the experts
    (``_only_expert``), a one-device engine's token for token. Returns
    K4's launches per rank by run."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    plan, label = gang['plan'], gang['label']
    layers, moe_layers = (plan['layers'][m] for m in ('bench-1b',
                                                       'moe-8x1b'))
    cfg = dataclasses.replace(llama.PRESETS['bench-1b'], n_layers=layers)
    moe_cfg = dataclasses.replace(llama.PRESETS['moe-8x1b'],
                                  n_layers=moe_layers)
    runs = _dp_collect(gang)
    wall = time.monotonic() - gang['t0']
    chunk = 8  # SKYTPU_LLM_CHUNK_STEPS's default
    elt = torch.tensor([], dtype=cfg.dtype).element_size()
    out, figs = {}, []
    for run in plan['runs']:
        name, spec = run['name'], run['mesh']
        a = dict(dict.fromkeys(mesh_lib.AXIS_ORDER, 1), **spec)
        c = moe_cfg if run['model'] == 'moe-8x1b' else cfg
        ranks = runs[name]
        b = DP_SLOTS // (a['data'] * a['fsdp'])
        shape = (b, c.n_heads // a['tensor'], c.n_kv_heads // a['tensor'])
        out[name] = _dp_check(
            label, name, ranks, c,
            lambda r, n=c.n_layers // a['pipe']: n * chunk * r['dispatches'],
            shape)
        _check_slices(label, name, ranks, c, spec,
                      _rank_weight_bytes(llama, c, spec))
        h = ranks[0]
        _check_answers(run['reqs'], [(200, {'tokens': [x]})
                                     for x in h['answers']], c.vocab_size)
        n_lines, adds_up, same, n = h['stream']
        if not adds_up or n != 40 or n_lines < 2 \
                or not (same or name.endswith('paged')):
            raise AssertionError(f'{label} {name}: the stream {h["stream"]}')
        if name.endswith('paged'):
            pools = {}
            for r in ranks:
                kb = r['kv_blocks']
                if kb['owned'] or kb['free'] + kb['cached'] != kb['usable'] \
                        or kb['used'] != kb['cached']:
                    raise AssertionError(f'{label} {name}: rank '
                                         f'{r["rank"]} blocks {kb}')
                pools.setdefault((r['at']['pipe'], r['at']['tensor']),
                                 set()).add(r['pool_crc'])
            if any(len(crcs) != 1 for crcs in pools.values()):
                raise AssertionError(f'{label} {name}: pools differ across '
                                     f'the ranks of one shard: {pools}')
        else:
            whole = (2 * c.n_layers * DP_SLOTS * c.n_kv_heads * DP_MAX_LEN
                     * c.head_dim * elt)
            share = a['pipe'] * a['data'] * a['fsdp'] * a['tensor']
            if any(r['cache_bytes'] * share != whole for r in ranks):
                raise AssertionError(
                    f'{label} {name}: ranks hold '
                    f'{[r["cache_bytes"] for r in ranks]} B of cache, not '
                    f'1/{share} of {whole}')
        figs.append((name, run, h, ranks, shape))
    # The lone greedy requests against tp 1 replicas of the same seed,
    # each (prompt, answer) checked once: the meshes' answers agree.
    parts, seen = {}, {}
    for name, run, h, _, _ in figs:
        if not _only_expert(run['mesh']):
            continue
        want = _one_device_lone(llama, run['model'], moe_layers
                                if run['model'] == 'moe-8x1b' else layers,
                                run)
        if h['lone'] != want:
            raise AssertionError(f'{label} {name}: lone answers {h["lone"]}'
                                 f', a one-device engine {want}')
        parts[name] = 'equal to a one-device engine token for token'
    for model, n_layers in (('bench-1b', layers), ('moe-8x1b', moe_layers)):
        mine = [f for f in figs if f[1]['model'] == model
                and f[0] not in parts]
        if not mine:
            continue
        with _cut_depth(llama, model, n_layers):
            server = srv_lib.LlmServer(model, engine='off',
                                       max_len=DP_MAX_LEN)
        try:
            for name, run, h, _, _ in mine:
                parts[name] = []
                for p, got in zip(run['lone'], h['lone']):
                    key = (model, tuple(p), tuple(got))
                    if key not in seen:
                        seen[key] = _check_greedy(gen_lib, server, p, got,
                                                  False)
                    parts[name].append(seen[key])
                parts[name] = (f'against tp 1, partings (position, top-2 '
                               f'gap) {parts[name]}')
        finally:
            server.stop()
            del server
            torch.cuda.empty_cache()
    card = _card()
    for name, run, h, ranks, shape in figs:
        tokens = sum(len(x) for x in h['answers'])
        steps = [r['dispatches'] * chunk for r in ranks]
        per_step = [round(r['collectives'] / n, 1)
                    for r, n in zip(ranks, steps)]
        layers_of = (moe_layers if run['model'] == 'moe-8x1b' else layers)
        print(f'  [{card}] {label} {name} ({run["model"]} at {layers_of} '
              f'layers, {ranks[0]["backend"]}, {DP_WORLD} ranks): '
              f'{len(h["answers"])} concurrent requests, {tokens} tokens in '
              f'{h["wall"]:.2f} s = {tokens / h["wall"]:.2f} tok/s; host ms '
              f'a decode step (dispatch gap / {chunk}) by rank '
              f'{[round(r["gap_ms"] / chunk, 2) for r in ranks]}; '
              f'collectives by rank {per_step} a decode step of its life; '
              f'peak by rank {[r["peak"] for r in ranks]} B; weights by '
              f'rank {[r["param_bytes"] for r in ranks]} B; cache by rank '
              f'{[r["cache_bytes"] for r in ranks]} B; K4 by rank '
              f'{out[name]} at B={shape[0]} Hq {shape[1]} Hkv {shape[2]}; '
              f'lone greedy: {parts[name]}', flush=True)
    print(f'  {label}: digests and engine states equal on every rank in '
          f'every run; gang {wall:.1f} s, the head\'s seconds by run '
          f'{ {n: round(recs[0]["run_s"], 1) for n, recs in runs.items()} }',
          flush=True)
    return out


# --nccl: tensor-parallel serving over NCCL, one rank a card, on a machine
# with four cards. Two hosts of two cards each, as two machines would see
# them.
NCCL_TP = 4
NCCL_HOSTS = [{'CUDA_VISIBLE_DEVICES': '0,1'}, {'CUDA_VISIBLE_DEVICES': '2,3'}]
# K4 at one rank's shard: bench-1b and llama3-8b at tp 4 (Hkv 2).
NCCL_CASES = ((TP4_BENCH_CASE, 16, 4, 2, 128, 1024),
              (TP4_RECIPE_CASE, 16, 8, 2, 128, 2048))


def _shard_kernels(da):
    """K4 against its plain version at NCCL_CASES, bf16 and int8 caches,
    bf16 queries (tolerance 2e-2, as phase 2's bf16)."""
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    rng = np.random.default_rng(4)
    for label, b, hq, hkv, d, m in NCCL_CASES:
        lengths = [0, 1, m, m + 1] + rng.integers(1, m + 1, b - 4).tolist()
        for mode, (_, quant) in MODES.items():
            args = _make_case(gen, b, hq, hkv, d, m, lengths,
                              torch.bfloat16, quant)
            out = da.flash_decode(*args)
            torch.cuda.synchronize()
            err = float((out.float() - da.flash_decode_reference(
                *args).float()).abs().max())
            if not err <= 2e-2:
                raise AssertionError(f'flash_decode[{mode}] at {label}: '
                                     f'max abs err {err}')
            print(f'  flash_decode[{mode} cache] at {label}: max abs err '
                  f'{err:.3g} (tolerance 2e-2)', flush=True)


def nccl_main() -> int:
    """``python3 chip_smoke.py --nccl``, on a machine with four cards:
    18a's checks for bench-1b at ``--tp 4`` on one host, 18b's for the
    serve-multihost recipe at ``--tp 4`` as two hosts of two cards and
    18c's (the paged decode replica, its tiers' gathers and scatters to
    the head on the model's NCCL groups beside the gloo arrival
    broadcast) at ``--tp 4`` on one host, every
    rank on its own card over NCCL (/health ``tp_backend`` nccl, nothing
    staged through the host), after K4 at their Hkv 2 shard is held to
    its plain version."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < NCCL_TP:
        print(f'chip_smoke --nccl: needs {NCCL_TP} CUDA devices',
              file=sys.stderr)
        return 2
    _share_bytecode()
    from skypilot_tpu_torch.models import generate as gen_lib
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import attention as fa
    from skypilot_tpu_torch.ops import decode_attention as da
    from skypilot_tpu_torch.serve import llm_server as srv_lib
    from skypilot_tpu_torch.train import run as train_run
    cards = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(cards, flush=True)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'nccl {".".join(map(str, torch.cuda.nccl.version()))}',
          flush=True)
    _phase('nccl 1: build K4 and K1-K3; K4 at the tp 4 shards')
    _build_all([da, fa])
    _shard_kernels(da)
    log_dir = tempfile.mkdtemp(prefix='skytpu-nccl-')
    try:
        _phase(f'nccl 2: bench-1b --tp {NCCL_TP}, one host, NCCL')
        bench = tp_bench_phase(srv_lib, gen_lib, llama, log_dir, NCCL_TP,
                               'nccl', 'nccl-a')
        _phase(f'nccl 3: the serve-multihost recipe at --tp {NCCL_TP}, '
               f'{TP_HOSTS} hosts of {NCCL_TP // TP_HOSTS} cards, NCCL')
        recipe = tp_recipe_phase(srv_lib, gen_lib, llama, log_dir, NCCL_TP,
                                 'nccl', 'nccl-b', NCCL_HOSTS)
        _phase(f'nccl 4: the multislice-train recipe (bench-1b, '
               f'data=2,fsdp=2) as {MESH_HOSTS} hosts of 2 cards, NCCL')
        train = mesh_train_phase(llama, train_run, log_dir, 'nccl-19a',
                                 NCCL_HOSTS, llama.BENCH_1B.n_layers)
        _phase(f'nccl 5: the moe-finetune recipe (moe-8x1b, all 18 layers, '
               f'fsdp=2,expert=2) as {MESH_HOSTS} hosts of 2 cards, NCCL')
        moe = moe_mesh_phase(llama, train_run, log_dir, 'nccl-19d',
                             NCCL_HOSTS, MESH_HOSTS,
                             llama.MOE_8X1B.n_layers, resume=False)
        _phase('nccl 6: program B (small MoE, pipe=2,expert=2) over NCCL, '
               'a card a rank')
        staged = small_mesh_phase(log_dir, tuple(
            prog[:1] + ('pipe=2,expert=2,fsdp=1',) + prog[2:]
            for prog in SMALL_MESHES if prog[0] in ('B', 'B4')),
            NCCL_TP, 'nccl-19c')
        _phase('nccl 7: 19e, bench-1b in 4 stages, then 6 layers in 3, on '
               'pipe=2, a card a rank')
        stages = pipe_stage_phase(llama, train_run, log_dir, 'nccl-19e',
                                  NCCL_HOSTS[:1])
        uneven = pipe_stage_phase(llama, train_run, log_dir,
                                  'nccl-19e-uneven', NCCL_HOSTS[:1],
                                  UNEVEN_LAYERS, UNEVEN_STAGES)
        _phase('nccl 8: 18f, the engine on data=2,tensor=2 (bench-1b, '
               f'{SERVE_LAYERS} layers), a card a rank')
        with _cut_depth(llama, 'bench-1b', SERVE_LAYERS), \
                _cut_depth(llama, 'moe-8x1b', SERVE_LAYERS):
            data = tp_data_phase(srv_lib, gen_lib, llama, log_dir,
                                 'nccl-18f')
        # Its tp 1 prefill replica runs in this process, on card 0.
        _phase(f'nccl 9: 18c at --tp {NCCL_TP} (bench-1b, paged, sharing '
               'and tiers on, the decode role), one host, NCCL')
        paged = tp_paged_phase(srv_lib, gen_lib, llama, log_dir, NCCL_TP,
                               'nccl', 'nccl-c')
        _phase('nccl 10: 18g, the engine on expert=4 (moe-8x1b, all '
               f'{llama.MOE_8X1B.n_layers} layers) and on pipe=2,tensor=2 '
               f'(bench-1b, {SERVE_LAYERS} layers), a card a rank')
        with _cut_depth(llama, 'bench-1b', SERVE_LAYERS):
            axes = serve_axes_phase(srv_lib, gen_lib, llama, start_serve_axes(
                llama, log_dir, 'nccl-18g', meshes=NCCL_AXES_MESHES,
                moe_layers=llama.MOE_8X1B.n_layers))
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
        shutil.rmtree(MESH_CKPT_DIR, ignore_errors=True)
    print(cards, flush=True)
    print(json.dumps({'nccl': {'bench-1b tp4 K4 bf16 launches by rank': bench,
                               'llama3-8b tp4 K4 int8 launches by rank':
                               recipe,
                               'bench-1b tp4 paged K4 bf16 launches by '
                               'rank': paged,
                               'bench-1b data=2,fsdp=2 K1-K3 launches':
                               train,
                               'moe-8x1b fsdp=2,expert=2 K1-K3 launches':
                               moe, 'bench-1b 4 stages on pipe=2 K1-K3 '
                               'launches': stages,
                               'bench-1b 3 stages on pipe=2 K1-K3 '
                               'launches': uneven,
                               'data=2,tensor=2 K4 launches by run and '
                               'rank': data,
                               'expert=4 and pipe=2,tensor=2 K4 launches '
                               'by run and rank': axes, **staged}}),
          flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


# -- phase 19: sharded training, every rank a process ----------------------------

TRAIN_RUN = [sys.executable, '-m', 'skypilot_tpu_torch.train.run']
# 19a: the multislice-train recipe (examples/llm/multislice-train/
# train.yaml) as two host processes of two ranks; --steps 500 -> 3,
# fsdp=-1 -> 2 (on one card -1 resolves to the 2 hosts' one card each),
# and --warmup-steps 100 -> 1, so that steps 2 and 3 take the full
# learning rate and their updates show in the bf16 weights.
MESH_TRAIN_ARGV = ['--model', 'bench-1b', '--global-batch-size', '32',
                   '--seq-len', '2048', '--mesh', 'data=2,fsdp=2',
                   '--steps', '3', '--warmup-steps', '1', '--log-every', '1']
MESH_HOSTS = 2
# 19b: the lora-finetune recipe on --mesh fsdp=2 (its fsdp=-1 is one card
# here): 2 steps saved, resumed to 4, against 4 uninterrupted.
MESH_LORA_ARGV = ['--model', 'bench-1b', '--global-batch-size', '16',
                  '--seq-len', '2048', '--mesh', 'fsdp=2', '--lora-rank',
                  '16', '--lora-alpha', '32', '--lora-targets',
                  'wq,wk,wv,wo', '--log-every', '1']
MESH_CKPT_DIR = '_ckpt_mesh_smoke'  # under the checkout; removed at the end
MESH_RUN_S = 600
MESH_LOSS_RTOL = 2e-2    # 19a: a step's loss against one rank's
MESH_WEIGHT_RTOL = 1e-2  # 19a: ||w - w_one|| / ||w_one|| over the weights
MESH_NORM_RTOL = 1e-2    # 19a: a step's grad_norm against one rank's
MESH_UPDATE_RTOL = 0.5   # 19a: ||u - u_one|| / ||u_one||, u = w - w_init
MESH_HALF_BATCH = 16     # 19a: a wrong gradient, which both limits must catch
# 19c: the small fp32 model on three meshes of eight ranks, one gang:
# JAX's programs A, B and C (``__graft_entry__.dryrun_multichip``), B an
# MoE model (4 experts, top-2) in 2 pipeline stages of 2 microbatches;
# B4 is B with 4 layers in 4 stages, two a pipe rank. (name, mesh, moe,
# layers, pipeline stages) each.
SMALL_MESHES = (('A', 'data=2,fsdp=2,tensor=2', False, 2, 1),
                ('B', 'pipe=2,expert=2,tensor=2,fsdp=1', True, 2, 2),
                ('C', 'data=2,seq=2,tensor=2,fsdp=1', False, 2, 1),
                ('B4', 'pipe=2,expert=2,tensor=2,fsdp=1', True, 4, 4))
SMALL_MESH_TOL = 1e-4    # 19c: card against CPU, fp32
# 19d: the moe-finetune recipe (examples/llm/moe-finetune/moe_finetune.yaml)
# as four ranks on the one card: --mesh fsdp=2,expert=8 -> fsdp=2,expert=2
# (sixteen ranks on one card would be sixteen CUDA contexts and a 16-way
# staging), --global-batch-size 16 -> 4 (two rows a fsdp group), --steps
# 2000 -> 3, the warm-up 100 -> 1, --save-every 50 -> 2, and moe-8x1b at
# MOE_MESH_LAYERS of its 18 layers, widths untouched (at 9 the phase took
# 201 s, of them 75 s the resumed relaunch's restore, step and save of a
# 7 GB state).
MOE_MESH_ARGV = ['--model', 'moe-8x1b', '--global-batch-size', '4',
                 '--seq-len', '2048', '--mesh', 'fsdp=2,expert=2',
                 '--steps', '3', '--warmup-steps', '1', '--log-every', '1']
MOE_MESH_LAYERS = 4
MOE_MESH_HALF = 2        # 19d: a wrong gradient, which the limits must catch


def _train_gang(argv, hosts, log_dir, label, host_env=None, extra_env=None):
    """``python -m skypilot_tpu_torch.train.run argv`` as ``hosts`` host
    processes (the gang launcher's env when more than one; each spawns its
    local ranks), each in its own session, with ``extra_env``. Returns the
    rank summaries in rank order, the logs' text and the wall seconds;
    raises unless every host exits 0."""
    env = dict(os.environ, **(extra_env or {}))
    if hosts > 1:
        env.update(JAX_COORDINATOR_ADDRESS=f'127.0.0.1:{_free_port()}',
                   JAX_NUM_PROCESSES=str(hosts),
                   MEGASCALE_NUM_SLICES=str(hosts))
    procs, logs = [], []
    t0 = time.monotonic()
    try:
        for h in range(hosts):
            logs.append(os.path.join(log_dir, f'{label}-host{h}.log'))
            with open(logs[-1], 'a') as log:  # O_APPEND: the host's ranks
                procs.append(subprocess.Popen(
                    TRAIN_RUN + argv, stdout=log, stderr=subprocess.STDOUT,
                    start_new_session=True,
                    env=dict(env, **(host_env[h] if host_env else {}),
                             **({'JAX_PROCESS_ID': str(h)} if hosts > 1
                                else {}))))
        for proc in procs:
            proc.wait(max(MESH_RUN_S - (time.monotonic() - t0), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc in procs:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
    wall = time.monotonic() - t0
    texts = [open(path, errors='replace').read() for path in logs]
    if any(p.returncode for p in procs):
        raise AssertionError(
            f'{label}: hosts exited {[p.returncode for p in procs]}:\n'
            + '\n'.join(t[-4000:] for t in texts))
    summaries = sorted(
        (json.loads(m) for t in texts
         for m in re.findall(r'^\[train\] rank-summary (\{.*\})$', t,
                             re.MULTILINE)), key=lambda s: s['rank'])
    return summaries, texts, wall


def _step_state(root, step):
    """A committed step's arrays (host 0's manifest) as CPU tensors."""
    from skypilot_tpu_torch.ckpt import manifest as manifest_lib
    from skypilot_tpu_torch.ckpt import snapshot as snapshot_lib
    path = os.path.join(root, manifest_lib.step_dirname(step))
    if not manifest_lib.is_committed(path):
        raise AssertionError(f'{path} is not committed')
    return {name: snapshot_lib.from_host(arr).clone()
            for name, arr in manifest_lib.iter_host_arrays(path, 0)}


def _check_ranks(label, summaries, world, steps, n_layers):
    """Every rank ran every step with the same finite losses and the same
    grad_norm bits, and launched K1/K2/K3 2L / L / L times a step (L
    ``n_layers``, or ``n_layers[rank]`` where ranks run different
    counts; then the wants come back by rank)."""
    if len(summaries) != world:
        raise AssertionError(f'{label}: {len(summaries)} rank summaries of '
                             f'{world}')
    wants = [{'flash_fwd': 2 * n * steps, 'flash_bwd_dq': n * steps,
              'flash_bwd_dkv': n * steps} for n in (
        n_layers if isinstance(n_layers, list) else [n_layers] * world)]
    for s in summaries:
        want = wants[s['rank']]
        if s['launches'] != want:
            raise AssertionError(f'{label}: rank {s["rank"]} launched '
                                 f'{s["launches"]}, expected {want}')
        if not all(math.isfinite(x) for x in s['losses']) \
                or len(s['losses']) != steps:
            raise AssertionError(f'{label}: rank {s["rank"]} losses '
                                 f'{s["losses"]}')
    if any(len({tuple(s[key]) for s in summaries}) != 1
           for key in ('losses', 'grad_norms', 'moe_aux')):
        raise AssertionError(f'{label}: ranks disagree: '
                             + '; '.join(f'{s["losses"]} {s["grad_norms"]} '
                                         f'{s["moe_aux"]}' for s in summaries))
    return wants if isinstance(n_layers, list) else wants[0]


def _rank_figs(label, summaries, steps):
    for s in summaries:
        c = s['collectives']
        kinds = ', '.join(
            f'{k} {v["calls"] / steps:.1f} calls {v["bytes"] / steps / 1e6:.1f}'
            f' MB {v["seconds"] / steps:.3f} s' for k, v in
            sorted(c['by_kind'].items()))
        print(f'  {label} rank {s["rank"]} ({s["backend"]}, {s["device"]}): '
              f'step ms {[round(x, 1) for x in s["window_step_ms"]]}; '
              f'collectives a step {c["calls"] / steps:.1f} calls, '
              f'{c["bytes"] / steps / 1e6:.1f} MB, '
              f'{c["seconds"] / steps:.3f} host s ({kinds}); weights '
              f'{s["weight_bytes"]} B; peak '
              f'{(s["peak_bytes"] or 0) / 2 ** 30:.2f} GiB '
              f'({s["peak_bytes"]} B)', flush=True)


def mesh_train_phase(llama, train_run, log_dir, label='19a', host_env=None,
                     layers=SERVE_LAYERS):
    """19a: the multislice-train recipe through ``train.run`` on
    ``data=2,fsdp=2`` as two host processes of two ranks (gloo on one
    card; NCCL with ``host_env``'s cards), then the same global batch on
    one rank in this process: every step's loss within MESH_LOSS_RTOL
    and grad_norm within MESH_NORM_RTOL, the updated weights (the gang's
    final checkpoint) within MESH_WEIGHT_RTOL in relative L2 and their
    updates within MESH_UPDATE_RTOL, limits that one rank's run on
    MESH_HALF_BATCH rows must exceed; equal grad_norm bits on every rank,
    K1/K2/K3 36/18/18 a step on every rank, and each rank's weight bytes
    half the whole plus the replicated leaves. bench-1b at ``layers``
    layers; the one-rank runs come after the gang (at batch 32 they take
    most of the card). Returns the launches of the gang's ranks, summed
    per kernel."""
    cfg, steps, world = dataclasses.replace(llama.BENCH_1B,
                                            n_layers=layers), 3, 4
    ckpt = os.path.abspath(os.path.join(MESH_CKPT_DIR, label))
    with _cut_depth(llama, 'bench-1b', layers):
        (summaries, _, wall), (one, half, one_s) = _gang_and_one_rank(
            train_run, MESH_TRAIN_ARGV + ['--ckpt-dir', ckpt,
                                          '--save-every', '1000'],
            MESH_HOSTS, log_dir, label, host_env,
            _depth_env(log_dir, 'bench-1b', layers)
            if layers != llama.BENCH_1B.n_layers else None,
            MESH_TRAIN_ARGV, MESH_HALF_BATCH, beside=False)
    per_rank = _check_ranks(label, summaries, world, steps, layers)
    shapes = llama.param_shapes(cfg)
    whole = 2 * sum(math.prod(s) for s in _flat_shapes(shapes))
    replicated = 2 * sum(math.prod(shapes['layers'][k]) for k in
                         ('attn_norm', 'mlp_norm')) + 2 * cfg.d_model
    want_bytes = (whole - replicated) // 2 + replicated
    if any(s['weight_bytes'] != want_bytes for s in summaries):
        raise AssertionError(f'{label}: weight bytes by rank '
                             f'{[s["weight_bytes"] for s in summaries]}, '
                             f'expected {want_bytes} (whole {whole})')
    _rank_figs(label, summaries, steps)
    readings = _against_one_rank(label, llama, cfg, one, half,
                                 MESH_HALF_BATCH, summaries[0],
                                 _step_state(ckpt, steps))
    print(f'  {label} bench-1b at {layers} of 18 layers on data=2,fsdp=2 '
          f'({MESH_HOSTS} hosts x 2 ranks, {summaries[0]["backend"]}): '
          f'{readings}; K1/K2/K3 by rank {per_rank} = expected; weights a '
          f'rank {want_bytes} B = ({whole} - {replicated}) / 2 + '
          f'{replicated}; gang {wall:.1f} s, one rank {one_s:.1f} s',
          flush=True)
    return {k: v * world for k, v in per_rank.items()}


# 19e: several pipeline stages on each pipe rank (no flag: a model's
# ``pipeline_stages`` with ``Trainer(mesh=)``), bench-1b at full width and
# STAGE_LAYERS layers in as many stages of STAGE_MICRO microbatches, on
# pipe=2 (two stages a rank), global batch 8, seq 2048, 2 steps; then a
# second gang at UNEVEN_LAYERS layers in UNEVEN_STAGES stages, which
# pipe=2 does not divide: rank 0 runs stages 0-1 (layers 0-3, holding
# 0-2 at rest), rank 1 stage 2 (layers 4-5 of its 3-5), so one layer
# goes from rank 1 to rank 0 a step and its gradient back.
STAGE_LAYERS = 4
STAGE_MICRO = 4
STAGE_ARGV = ['--model', 'bench-1b', '--global-batch-size', '8',
              '--seq-len', '2048', '--mesh', 'pipe=2,fsdp=1', '--steps',
              '2', '--warmup-steps', '1', '--log-every', '1']
STAGE_HALF = 4   # 19e: a wrong gradient, which the limits must catch
UNEVEN_LAYERS, UNEVEN_STAGES = 6, 3


def _stage_fields(stages):
    return dict(pipeline_stages=stages, pipeline_microbatches=STAGE_MICRO)


def _stage_ckpt(label):
    return os.path.abspath(os.path.join(MESH_CKPT_DIR, label))


def stage_gang(llama, log_dir, label='19e', host_env=None,
               layers=STAGE_LAYERS, stages=STAGE_LAYERS):
    """19e's gang alone: ``train.run`` on ``pipe=2`` as two ranks,
    bench-1b at ``layers`` layers in ``stages`` stages (``_train_gang``'s
    result). Runs only subprocesses, so it may run beside this process's
    own work."""
    return _train_gang(
        STAGE_ARGV + ['--ckpt-dir', _stage_ckpt(label), '--save-every',
                      '1000'], 1, log_dir, label, host_env,
        _depth_env(log_dir, 'bench-1b', layers, **_stage_fields(stages)))


def _stage_sets(layers, stages, pipe):
    """(each rank's layers of its stage block, each rank's layers at
    rest), by arithmetic: blocks of ceil(stages / pipe) stages, the last
    ranks fewer or none; the stack split evenly at rest."""
    per, held, k = layers // stages, layers // pipe, -(-stages // pipe)
    need = [set(range(min(p * k, stages) * per, min(p * k + k, stages) * per))
            for p in range(pipe)]
    return need, [set(range(p * held, (p + 1) * held)) for p in range(pipe)]


def _check_exchange(label, llama, cfg, summaries, steps):
    """Each rank's ``exchange`` (forward) and ``exchange_grad`` (backward)
    a step: one call each way, carrying the layers its stage block lacks
    from their owners and their gradients back, as many bytes as those
    layers, none where the stages split evenly; and no all-gather or
    reduce-scatter at all (nothing gathers the stack). Returns the
    readings."""
    pipe = len(summaries)
    need, rest = _stage_sets(cfg.n_layers, cfg.pipeline_stages, pipe)
    layer_bytes = 2 * sum(math.prod(shape[1:]) for shape in _flat_shapes(
        llama.param_shapes(cfg)['layers']))
    moves = any(need[u] & rest[o] for o in range(pipe) for u in range(pipe)
                if o != u)
    readings = []
    for s in summaries:
        p, by = s['rank'], s['collectives']['by_kind']
        sent = sum(len(need[u] & rest[p]) for u in range(pipe) if u != p)
        back = sum(len(need[p] & rest[o]) for o in range(pipe) if o != p)
        want = ({'exchange': [steps, sent * layer_bytes * steps],
                 'exchange_grad': [steps, back * layer_bytes * steps]}
                if moves else {})
        got = {kind: [by[kind]['calls'], by[kind]['bytes']]
               for kind in ('exchange', 'exchange_grad') if kind in by}
        if got != want or {'all_gather', 'reduce_scatter'} & by.keys():
            raise AssertionError(
                f'{label}: rank {p} moved {got} ({sorted(by)}), expected '
                f'{want} and no all_gather or reduce_scatter')
        readings.append(f'rank {p} sends {sent * layer_bytes} B forward, '
                        f'{back * layer_bytes} B of gradients back a step')
    return '; '.join(readings) + f' (a layer {layer_bytes} B)'


def pipe_stage_phase(llama, train_run, log_dir, label='19e',
                     host_env=None, layers=STAGE_LAYERS,
                     stages=STAGE_LAYERS, gang=None):
    """19e: ``train.run`` on ``pipe=2`` as two ranks (gloo on the one
    card; NCCL with ``host_env``'s cards; ``gang``, a future of
    ``stage_gang``'s result, when it was started already), bench-1b at
    ``layers`` layers in ``stages`` pipeline stages (blocks of
    ceil(stages / 2) a rank, the schedule's M + S - 1 ticks over all) of
    STAGE_MICRO microbatches, 2 steps, then the same batch on one rank in
    this process (every stage in one process): each step's loss within
    MESH_LOSS_RTOL, grad_norm within MESH_NORM_RTOL, the final weights
    within MESH_WEIGHT_RTOL and their update within MESH_UPDATE_RTOL of
    one rank's, limits that one rank on STAGE_HALF rows must exceed;
    every rank's grad_norm bits equal, K1/K2/K3 2 x its block's layers x
    the microbatches / half that a step, and the exchange of the layers a
    rank's block lacks (``_check_exchange``). Returns the launches of the
    gang's ranks, summed per kernel."""
    fields = _stage_fields(stages)
    cfg = dataclasses.replace(llama.BENCH_1B, n_layers=layers, **fields)
    steps, world = 2, 2
    summaries, _, wall = (gang.result() if gang is not None else
                          stage_gang(llama, log_dir, label, host_env, layers,
                                     stages))
    with _cut_depth(llama, 'bench-1b', layers, **fields):
        one, half, one_s = _one_rank_runs(train_run, STAGE_ARGV, STAGE_HALF)
    # A rank runs its block's layers on every microbatch.
    need = _stage_sets(layers, stages, world)[0]
    per_rank = _check_ranks(label, summaries, world, steps,
                            [len(n) * STAGE_MICRO for n in need])
    moved = _check_exchange(label, llama, cfg, summaries, steps)
    _rank_figs(label, summaries, steps)
    readings = _against_one_rank(label, llama, cfg, one, half, STAGE_HALF,
                                 summaries[0],
                                 _step_state(_stage_ckpt(label), steps))
    print(f'  {label} bench-1b at {layers} of 18 layers in {stages} stages '
          f'x {STAGE_MICRO} microbatches on pipe=2 (layers by rank '
          f'{[sorted(n) for n in need]}, {summaries[0]["backend"]}): '
          f'{readings}; K1/K2/K3 by rank {per_rank} = expected; {moved}; '
          f'peak by rank {[s["peak_bytes"] for s in summaries]} B; gang '
          f'{wall:.1f} s, one rank {one_s:.1f} s', flush=True)
    return {k: sum(w[k] for w in per_rank) for k in per_rank[0]}


def _named_params(params):
    from skypilot_tpu_torch.ckpt import snapshot as snapshot_lib
    return {leaf.name: leaf.value for leaf in
            snapshot_lib.flatten_named({'params': params})[0]}


def _gang_and_one_rank(train_run, argv, hosts, log_dir, label, host_env,
                       extra_env, one_argv, half_batch, beside):
    """``_train_gang``'s result and ``_one_rank_runs``': beside each other
    when ``beside`` (the one card has room for both), else one after the
    other (and always with a card a rank, ``host_env``, where the gang's
    step times are measured alone)."""
    if host_env is not None or not beside:
        gang = _train_gang(argv, hosts, log_dir, label, host_env, extra_env)
        return gang, _one_rank_runs(train_run, one_argv, half_batch)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        refs = pool.submit(_one_rank_runs, train_run, one_argv, half_batch)
        gang = _train_gang(argv, hosts, log_dir, label, host_env, extra_env)
        return gang, refs.result()


def _one_rank_runs(train_run, argv, half_batch):
    """``train.run.main`` on one rank in this process with ``argv``'s
    global batch (its ``--mesh`` dropped), then on ``half_batch`` rows
    (what a gang that lost a data shard computes): (one, half, seconds of
    both)."""
    argv = list(argv)
    i = argv.index('--mesh')
    del argv[i:i + 2]
    t0 = time.perf_counter()
    one = train_run.main(argv)
    i = argv.index('--global-batch-size')
    argv[i + 1] = str(half_batch)
    half = train_run.main(argv)
    return one, half, time.perf_counter() - t0


def _against_one_rank(label, llama, cfg, one, half, half_batch, gang,
                      saved):
    """The gang's run (``gang``: a rank's summary; ``saved``: its final
    weights, whole, or None) against ``_one_rank_runs``' ``one`` on the
    same batch: each step's loss within MESH_LOSS_RTOL, grad_norm within
    MESH_NORM_RTOL and an MoE model's moe_aux within MESH_LOSS_RTOL; the
    weights within MESH_WEIGHT_RTOL in relative L2 and their updates
    within MESH_UPDATE_RTOL. ``half`` (``half_batch`` rows) must exceed
    the grad_norm and update limits (without ``saved``: the loss or
    grad_norm limit). Returns the readings."""

    def apart(key, run):
        return max(abs(a - b) / abs(b) for a, b in zip(run[key], one[key]))
    loss_rel = apart('losses', gang)
    norm_rel = apart('grad_norms', gang)
    half_loss_rel = apart('losses', half)
    half_norm_rel = apart('grad_norms', half)
    readings = (f'losses {gang["losses"]}, one rank {loss_rel:.3g} relative '
                f'apart (limit {MESH_LOSS_RTOL}); grad_norm '
                f'{gang["grad_norms"]} on every rank, {norm_rel:.3g} '
                f'relative from one rank\'s (limit {MESH_NORM_RTOL})')
    ok = loss_rel <= MESH_LOSS_RTOL and norm_rel <= MESH_NORM_RTOL
    if one['moe_aux']:
        aux_rel = apart('moe_aux', gang)
        readings += (f'; moe_aux {gang["moe_aux"]}, {aux_rel:.3g} relative '
                     f'from one rank\'s (limit {MESH_LOSS_RTOL})')
        ok = ok and aux_rel <= MESH_LOSS_RTOL
    caught = half_norm_rel > MESH_NORM_RTOL or half_loss_rel > MESH_LOSS_RTOL
    readings += (f'; a batch of {half_batch} on one rank: loss '
                 f'{half_loss_rel:.3g}, grad_norm {half_norm_rel:.3g} apart')
    if saved is not None:
        init = llama.init_params(cfg, torch.Generator(device='cuda')
                                 .manual_seed(0), 'cuda')
        ref, start, wrong = (_named_params(one['state']['params']),
                             _named_params(init),
                             _named_params(half['state']['params']))
        diff = norm = upd = upd_norm = half_upd = 0.0
        for name, w in ref.items():
            got = saved[name].to('cuda').float()
            w, w0 = w.detach().float(), start[name].float()
            diff += float(((got - w) ** 2).sum())
            norm += float((w ** 2).sum())
            d_ref = w - w0
            upd += float(((got - w0 - d_ref) ** 2).sum())
            half_upd += float(((wrong[name].detach().float() - w0 - d_ref)
                               ** 2).sum())
            upd_norm += float((d_ref ** 2).sum())
        del init, start, ref, wrong
        w_rel, u_rel = math.sqrt(diff / norm), math.sqrt(upd / upd_norm)
        half_u_rel = math.sqrt(half_upd / upd_norm)
        readings += (f', updates {half_u_rel:.3g} apart; weights '
                     f'{w_rel:.3g} relative L2 from one rank (limit '
                     f'{MESH_WEIGHT_RTOL}), their updates {u_rel:.3g} (limit '
                     f'{MESH_UPDATE_RTOL})')
        ok = ok and w_rel <= MESH_WEIGHT_RTOL and u_rel <= MESH_UPDATE_RTOL
        caught = half_norm_rel > MESH_NORM_RTOL and \
            half_u_rel > MESH_UPDATE_RTOL
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f'{label}: {readings}')
    if not caught:
        raise AssertionError(f'{label}: the limits do not tell a wrong '
                             f'gradient: {readings}')
    return readings


def _local_bytes(llama, cfg, sizes):
    """(a rank's weight bytes, its expert bytes, the whole model's expert
    bytes) on a mesh of axis ``sizes`` under the default rules (the MoE
    router float32, every other leaf ``cfg.dtype``)."""
    from skypilot_tpu_torch.parallel import sharding as sharding_lib

    class _Shape:
        shape = {a: sizes.get(a, 1) for a in (
            'data', 'pipe', 'fsdp', 'seq', 'expert', 'tensor')}
    rules = sharding_lib.ShardingRules()
    size = torch.tensor([], dtype=cfg.dtype).element_size()
    out = [0, 0, 0]

    def walk(shapes, axes, name):
        if isinstance(shapes, dict):
            for k in shapes:
                walk(shapes[k], axes[k], k)
            return
        local = math.prod(sharding_lib.local_shape(
            shapes, sharding_lib.NamedSharding(_Shape,
                                               rules.mesh_axes(axes))))
        width = 4 if name == 'router' else size
        out[0] += local * width
        if name.startswith('we_'):
            out[1] += local * width
            out[2] += math.prod(shapes) * width
    walk(llama.param_shapes(cfg), llama.param_logical_axes(cfg), '')
    return tuple(out)


def moe_mesh_phase(llama, train_run, log_dir, label='19d', host_env=None,
                   hosts=1, layers=MOE_MESH_LAYERS, resume=True):
    """19d: the moe-finetune recipe through ``train.run`` on
    ``fsdp=2,expert=2`` (four ranks: one host on the one card over gloo,
    or ``hosts`` hosts of ``host_env``'s cards), moe-8x1b at ``layers``
    layers, global batch 4, 3 steps, against the same batch on one rank in
    this process (``_against_one_rank``: loss, moe_aux, grad_norm and,
    with ``resume``, the final weights); every rank's metrics' bits equal,
    K1/K2/K3 2L / L / L a step on every rank, a rank's weight bytes those
    of its quarter of the experts and half of the rest (the router
    float32). With ``resume`` (checkpoints at 2 and 3): the router and
    every expert of every layer moved, and a relaunch resumed from step 2
    writes a step 3 equal to the uninterrupted one bit for bit. Returns
    K1-K3's launches, every rank's."""
    cfg = dataclasses.replace(llama.MOE_8X1B, n_layers=layers)
    steps, world = 3, 4
    env = (_depth_env(log_dir, 'moe-8x1b', layers)
           if layers != llama.MOE_8X1B.n_layers else {})
    # One slice: the gang launcher's MEGASCALE_NUM_SLICES counts hosts.
    argv = MOE_MESH_ARGV + ['--num-slices', '1']
    root = os.path.abspath(os.path.join(MESH_CKPT_DIR, label))
    side = root + '-uninterrupted'
    for path in (root, side):
        shutil.rmtree(path, ignore_errors=True)
    if resume:
        argv += ['--ckpt-dir', root, '--save-every', '2']
    with _cut_depth(llama, 'moe-8x1b', layers):
        (summaries, _, wall), (one, half, one_s) = _gang_and_one_rank(
            train_run, argv, hosts, log_dir, label, host_env, env,
            MOE_MESH_ARGV, MOE_MESH_HALF, beside=True)
    per_rank = _check_ranks(label, summaries, world, steps, layers)
    want_bytes, expert_bytes, experts = _local_bytes(
        llama, cfg, {'fsdp': 2, 'expert': 2})
    if any(s['weight_bytes'] != want_bytes for s in summaries) \
            or 4 * expert_bytes != experts:
        raise AssertionError(f'{label}: weight bytes by rank '
                             f'{[s["weight_bytes"] for s in summaries]}, '
                             f'expected {want_bytes} with {expert_bytes} '
                             f'of the experts\' {experts}')
    _rank_figs(label, summaries, steps)
    _phase(f'  {label} gang done in {wall:.1f} s')
    saved = _step_state(root, steps) if resume else None
    readings = _against_one_rank(label, llama, cfg, one, half,
                                 MOE_MESH_HALF, summaries[0], saved)
    del one, half
    launches = {k: v * world for k, v in per_rank.items()}
    note = ''
    if resume:
        init = _named_params(llama.init_params(
            cfg, torch.Generator(device='cuda').manual_seed(0), 'cuda'))
        still = []
        for name, w0 in init.items():
            if "['moe']" not in name:
                continue
            w, w0 = saved[name], w0.cpu()
            # Per layer, and per expert of the expert leaves ([L, E, ...]).
            parts = [(i,) if 'router' in name else (i, e)
                     for i in range(layers) for e in range(
                         1 if 'router' in name else cfg.num_experts)]
            still += [f'{name}{list(ix)}' for ix in parts
                      if torch.equal(w[ix], w0[ix])]
        del init
        torch.cuda.empty_cache()
        if still:
            raise AssertionError(f'{label}: unchanged after {steps} steps: '
                                 f'{still[:8]}')
        os.makedirs(side)
        from skypilot_tpu_torch.ckpt import manifest as manifest_lib
        os.rename(os.path.join(root, manifest_lib.step_dirname(steps)),
                  os.path.join(side, manifest_lib.step_dirname(steps)))
        again, texts, r_wall = _train_gang(argv, hosts, log_dir,
                                           f'{label}-resume', host_env, env)
        if '[train] resumed from checkpoint step 2' not in texts[0]:
            raise AssertionError(f'{label}: the relaunch did not resume '
                                 'from step 2')
        if again[0]['losses'] != summaries[0]['losses'][2:]:
            raise AssertionError(f'{label}: resumed step 3 loss '
                                 f'{again[0]["losses"]}, uninterrupted '
                                 f'{summaries[0]["losses"]}')
        resumed, straight = _step_state(root, steps), _step_state(side, steps)
        if resumed.keys() != straight.keys() or not all(
                torch.equal(resumed[n], straight[n]) for n in straight):
            raise AssertionError(f'{label}: the resumed step 3 differs from '
                                 'the uninterrupted one')
        for k, v in _check_ranks(f'{label} resumed', again, world, 1,
                                 layers).items():
            launches[k] += v * world
        note = (f'; the router and all {cfg.num_experts} experts of every '
                f'layer moved; resumed from step 2: step 3 = the '
                f'uninterrupted step 3 bit for bit ({len(straight)} arrays, '
                f'{r_wall:.1f} s)')
        del resumed, straight, saved
    print(f'  {label} moe-8x1b at {layers} of 18 layers on fsdp=2,expert=2 '
          f'({hosts} host(s), {summaries[0]["backend"]}): {readings}; '
          f'K1/K2/K3 by rank {per_rank} = expected; weights a rank '
          f'{want_bytes} B, of them experts {expert_bytes} B = a quarter of '
          f'{experts} B{note}; gang {wall:.1f} s, one rank {one_s:.1f} s',
          flush=True)
    return launches


def _flat_shapes(tree):
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _flat_shapes(v)]
    return [tree]


def mesh_lora_phase(llama, log_dir, pool, layers=SERVE_LAYERS):
    """19b: the lora-finetune recipe through ``train.run`` on ``fsdp=2``
    (two ranks, one card), bench-1b at ``layers`` layers: A 2 steps saved
    at 2, B resumed to 4, and C 4 steps beside them (on ``pool``); B's
    step 4 = C's bit for bit (adapters, base, optimizer state), B's
    losses = C's last two and A's = C's first two, the base = the initial
    weights bit for bit, K1/K2/K3 at B=8 a rank."""
    cfg, world = dataclasses.replace(llama.BENCH_1B, n_layers=layers), 2
    env = _depth_env(log_dir, 'bench-1b', layers)
    root = os.path.abspath(os.path.join(MESH_CKPT_DIR, '19b'))
    ab, c = os.path.join(root, 'ab'), os.path.join(root, 'c')
    uninterrupted = pool.submit(_train_gang, MESH_LORA_ARGV + [
        '--steps', '4', '--save-every', '4', '--ckpt-dir', c], 1, log_dir,
        '19b-C', None, env)
    runs, texts = {}, {}
    for name, extra in (('A', ['--steps', '2', '--save-every', '2',
                               '--ckpt-dir', ab]),
                        ('B', ['--steps', '4', '--save-every', '2',
                               '--ckpt-dir', ab])):
        runs[name], (texts[name],), wall = _train_gang(
            MESH_LORA_ARGV + extra, 1, log_dir, f'19b-{name}', None, env)
        _phase(f'  19b {name}: {wall:.1f} s')
    runs['C'], _, wall = uninterrupted.result()
    _phase(f'  19b C (beside A and B): {wall:.1f} s')
    if '[train] resumed from checkpoint step 2' not in texts['B']:
        raise AssertionError('19b: B did not resume from step 2')
    _check_ranks('19b C', runs['C'], world, 4, layers)
    if runs['A'][0]['losses'] != runs['C'][0]['losses'][:2] \
            or runs['B'][0]['losses'] != runs['C'][0]['losses'][2:]:
        raise AssertionError(f'19b: losses A {runs["A"][0]["losses"]} B '
                             f'{runs["B"][0]["losses"]} C '
                             f'{runs["C"][0]["losses"]}')
    resumed, straight = _step_state(ab, 4), _step_state(c, 4)
    if resumed.keys() != straight.keys():
        raise AssertionError('19b: the two step-4 states differ in names')
    for name in straight:
        if not torch.equal(resumed[name], straight[name]):
            raise AssertionError(f'19b: {name} differs between resumed and '
                                 'uninterrupted')
    from skypilot_tpu_torch.ckpt import snapshot as snapshot_lib
    init = llama.init_params(cfg, torch.Generator(device='cuda')
                             .manual_seed(0), 'cuda')
    for leaf in snapshot_lib.flatten_named({'params': init})[0]:
        if not torch.equal(straight[leaf.name], leaf.value.cpu()):
            raise AssertionError(f'19b: the base moved: {leaf.name}')
    adapters = sum(t.numel() for n, t in straight.items()
                   if n.startswith("['lora']"))
    del init, resumed, straight
    torch.cuda.empty_cache()
    _rank_figs('19b C', runs['C'], 4)
    print(f'  19b bench-1b at {layers} of 18 layers, LoRA rank 16 on fsdp=2 '
          f'(2 ranks, '
          f'{runs["C"][0]["backend"]}): losses {runs["C"][0]["losses"]}; '
          f'A + B = C bit for bit (every array of step 4: {adapters} '
          'adapter values, the base, the optimizer state); the base = '
          'the initial weights bit for bit', flush=True)
    return {k: v * world for k, v in
            runs['C'][0]['launches'].items()}


_SMALL_MESH_SCRIPT = r"""
import dataclasses, json, os, sys
import torch
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import attention
from skypilot_tpu_torch.parallel import gang as gang_lib
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.train import data as data_lib
from skypilot_tpu_torch.train import optim, trainer as trainer_lib

world, programs, out_dir, label = (int(sys.argv[1]), json.loads(sys.argv[2]),
                                   sys.argv[3], sys.argv[4])
gang = gang_lib.initialize(world, 'cuda', sys.argv[1:],
                           [sys.executable, __file__], label)
fa = attention.flash_attention
dense = dataclasses.replace(llama.TINY, d_model=128, n_heads=4,
                            n_kv_heads=2, head_dim=64, d_ff=256,
                            dtype=torch.float32)
report = {'rank': gang.rank, 'backend': gang.backend}
for name, spec, moe, layers, stages in programs:
    model = dataclasses.replace(dense, n_layers=layers)
    if moe:
        model = dataclasses.replace(
            model, num_experts=4, expert_top_k=2, pipeline_stages=stages,
            pipeline_microbatches=2)
    card = mesh_lib.build_mesh(mesh_lib.parse_spec(spec), device=gang.device)
    # The reference: the same process group on the CPU (gloo), or one
    # process on this rank's card (a NCCL group has no CPU medium).
    ref = (mesh_lib.Mesh(card.shape, torch.device('cpu'), card.device_mesh,
                         card.backend) if gang.backend == 'gloo' else None)
    cfg = trainer_lib.TrainerConfig(model=model, global_batch_size=4,
                                    seq_len=128, warmup_steps=1,
                                    learning_rate=1e-2)
    init = optim.tree_map(lambda t: t.numpy(), llama.init_params(
        model, torch.Generator().manual_seed(0), 'cpu'))
    runs = {}
    for where, mesh in (('card', card), ('ref', ref)):
        for counter in ('fwd_launches', 'bwd_dq_launches',
                        'bwd_dkv_launches'):
            setattr(fa, counter, 0)
        tr = (trainer_lib.Trainer(cfg, mesh=mesh) if mesh is not None
              else trainer_lib.Trainer(cfg, device=gang.device))
        st = tr.init_state_from_numpy(init)
        losses = []
        for b in data_lib.synthetic_batches(4, 128, model.vocab_size,
                                            seed=3, num_batches=2):
            st, m = tr.step(st, b)
            losses.append(float(m['loss']))
        whole = st if mesh is None else tr.host_view(st, gang.local)
        runs[where] = (losses, [t.detach().cpu() for t in
                                optim.tree_leaves(whole['params'])])
        if where == 'card':
            launches = {'flash_fwd': fa.fwd_launches,
                        'flash_bwd_dq': fa.bwd_dq_launches,
                        'flash_bwd_dkv': fa.bwd_dkv_launches}
    report[name] = {
        'losses': runs['card'][0], 'launches': launches,
        'loss_err': max(abs(a - b) for a, b in zip(runs['card'][0],
                                                   runs['ref'][0])),
        'param_err': max(float((a - b).abs().max()) for a, b in zip(
            runs['card'][1], runs['ref'][1])),
        'moved': max(float((a - torch.from_numpy(b)).abs().max())
                     for a, b in zip(runs['ref'][1],
                                     optim.tree_leaves(init)))}
with open(os.path.join(out_dir, f'{label}.{gang.rank}.json'), 'w') as f:
    json.dump(report, f)
gang.close(60)
sys.stdout.flush()
os._exit(0)
"""


def _small_launches(spec, moe, layers):
    """K1-K3 a rank launches in 19c's two steps of the small model:
    dense 2 x layers / layers / layers a step; a pipeline (programs B
    and B4) its pipe rank's layers over 2 microbatches; program C none
    (ring attention is an einsum)."""
    if 'seq=2' in spec:
        return {'flash_fwd': 0, 'flash_bwd_dq': 0, 'flash_bwd_dkv': 0}
    # The layers, or a pipe rank's layers x the microbatches.
    per_step = layers if not moe else layers // 2 * 2
    return {'flash_fwd': 2 * per_step * 2, 'flash_bwd_dq': per_step * 2,
            'flash_bwd_dkv': per_step * 2}


def small_mesh_phase(log_dir, programs=SMALL_MESHES, world=8, label='19c'):
    """19c: the small fp32 model of phase 5 (head_dim 64) on each of
    ``programs``' meshes, ``world`` ranks in one gang on the card (gloo)
    or a card a rank (NCCL), two Adafactor steps on the card and then,
    from the same weights, on the CPU over the same process group
    (gloo), or in one process on the rank's card (NCCL): losses and
    gathered params within SMALL_MESH_TOL on every rank, the weights
    moved, K1-K3 as ``_small_launches`` says. Returns the launches, all
    ranks' summed, by program."""
    script = os.path.join(log_dir, 'small_mesh.py')
    with open(script, 'w') as f:
        f.write(_SMALL_MESH_SCRIPT)
    log = os.path.join(log_dir, f'{label}.log')
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    t0 = time.monotonic()
    with open(log, 'a') as out:  # O_APPEND: the ranks write to it
        proc = subprocess.Popen([sys.executable, script, str(world),
                                 json.dumps(programs), log_dir, label],
                                stdout=out, stderr=subprocess.STDOUT,
                                env=env, start_new_session=True)
        try:
            proc.wait(MESH_RUN_S)
        except subprocess.TimeoutExpired:
            pass
        finally:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
    text = open(log, errors='replace').read()
    if proc.returncode:
        raise AssertionError(f'{label} exited {proc.returncode}:\n'
                             f'{text[-4000:]}')
    ranks = []
    for r in range(world):
        path = os.path.join(log_dir, f'{label}.{r}.json')
        if os.path.exists(path):
            with open(path) as f:
                ranks.append(json.load(f))
    if len(ranks) != world:
        raise AssertionError(f'{label}: {len(ranks)} ranks of {world}')
    launches = {}
    for name, spec, moe, layers, stages in programs:
        want = _small_launches(spec, moe, layers)
        bad = [r['rank'] for r in ranks
               if not (r[name]['loss_err'] <= SMALL_MESH_TOL
                       and r[name]['param_err'] <= SMALL_MESH_TOL
                       and r[name]['moved'] > 1e-3
                       and r[name]['launches'] == want)]
        if bad:
            raise AssertionError(f'{label} program {name} on {spec}: ranks '
                                 f'{bad} off: {[r[name] for r in ranks]}')
        launches[f'phase {label} program {name} ({spec})'] = {
            k: v * world for k, v in want.items()}
        print(f'  {label} program {name}: small fp32 '
              f'{layers}-layer '
              + (f'MoE, {stages} stages x 2 microbatches' if moe
                 else 'dense') + ' '
              f'model on {spec} ({world} ranks, {ranks[0]["backend"]}): '
              f'losses {ranks[0][name]["losses"]}; card vs '
              f'{"CPU" if ranks[0]["backend"] == "gloo" else "one process"}'
              f' max loss err {max(r[name]["loss_err"] for r in ranks)}, '
              f'max param err {max(r[name]["param_err"] for r in ranks)} '
              f'(limits {SMALL_MESH_TOL}) on every rank; weights moved up '
              f'to {ranks[0][name]["moved"]}; K1/K2/K3 a rank {want}',
              flush=True)
    print(f'  {label}: {time.monotonic() - t0:.1f} s', flush=True)
    return launches


def mesh_phase(llama, train_run):
    """Phase 19. Returns K1-K3's launches of 19a-19e, every rank's, by
    path."""
    log_dir = tempfile.mkdtemp(prefix='skytpu-mesh-')
    torch.cuda.empty_cache()  # the ranks share the card with this process
    try:
        # 19a beside 19b (whose uninterrupted run goes beside its saved
        # and resumed runs), then 19c beside 19d and 19e: their step times
        # are not a lone gang's. 19e after 19d, not beside it or 19a: the
        # one-rank runs of either take most of the card, and 19e ran out
        # of memory beside both (PERF.md section 6).
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            multislice = pool.submit(mesh_train_phase, llama, train_run,
                                     log_dir)
            launches = {'phase 19b lora-fsdp': mesh_lora_phase(
                llama, log_dir, pool)}
            _phase('  19b done')
            launches['phase 19a train-multislice'] = multislice.result()
        _phase(f'  19a-19b side by side: {time.perf_counter() - t0:.1f} s')
        # 19e's uneven gang (subprocesses) runs beside its 4-stage gang,
        # whose one-rank runs come first; then the uneven one-rank runs.
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            small = pool.submit(small_mesh_phase, log_dir)
            launches['phase 19d moe-finetune'] = moe_mesh_phase(
                llama, train_run, log_dir)
            _phase('  19d done')
            uneven = pool.submit(stage_gang, llama, log_dir, '19e-uneven',
                                 None, UNEVEN_LAYERS, UNEVEN_STAGES)
            launches['phase 19e pipe-stages'] = pipe_stage_phase(
                llama, train_run, log_dir)
            _phase('  19e 4 stages done')
            launches['phase 19e pipe-stages uneven'] = pipe_stage_phase(
                llama, train_run, log_dir, '19e-uneven',
                layers=UNEVEN_LAYERS, stages=UNEVEN_STAGES, gang=uneven)
            _phase('  19e done')
            launches.update(small.result())
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
        shutil.rmtree(MESH_CKPT_DIR, ignore_errors=True)
    return launches


def _check_dispatches(label, launches, d0, d1, cfg, dec):
    """K4 launched n_layers x chunk_steps x the decode replica's dispatches
    in the window, and neither the prefill nor the colocated replica
    dispatched a decode chunk in it."""
    dec_d = d1['decode'] - d0['decode']
    expected = cfg.n_layers * dec.chunk_steps * dec_d
    if launches != expected or not dec_d \
            or d1['prefill'] != d0['prefill'] \
            or d1['colocated'] != d0['colocated']:
        raise AssertionError(
            f'{label}: flash_decode launched {launches} times over {dec_d} '
            f'decode-replica chunks (expected {expected}); prefill replica '
            f'{d1["prefill"] - d0["prefill"]} chunks, colocated '
            f'{d1["colocated"] - d0["colocated"]}')


def _build_all(libs):
    """One nvcc per kernel library, all started together; prints each
    kernel's registers, any spills, and any wgmma the compiler had to
    serialise."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        logs = list(pool.map(lambda lib: lib.build_library(), libs))
    print(f'  built {", ".join(lib.SOURCE.name for lib in libs)} in '
          f'{time.perf_counter() - t0:.2f} s', flush=True)
    for lib, log in zip(libs, logs):
        for line in log.splitlines():
            if ('registers' in line or 'wgmma' in line
                    or 'spill' in line and ' 0 bytes spill' not in line):
                print(f'  {lib.SOURCE.name}: {line.strip()}', flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    _share_bytecode()
    from skypilot_tpu_torch.ckpt import manifest as ckpt_manifest
    from skypilot_tpu_torch.models import engine as engine_lib
    from skypilot_tpu_torch.models import generate as gen_lib
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models import lora as lora_lib
    from skypilot_tpu_torch.models import moe as moe_lib
    from skypilot_tpu_torch.models import paged as paged_lib
    from skypilot_tpu_torch.models import quantization as quant_lib
    from skypilot_tpu_torch.observability import blackbox
    from skypilot_tpu_torch.observability import trace as trace_lib
    from skypilot_tpu_torch.ops import attention as fa
    from skypilot_tpu_torch.ops import decode_attention as da
    from skypilot_tpu_torch.serve import disagg as disagg_lib
    from skypilot_tpu_torch.serve import llm_server as srv_lib
    from skypilot_tpu_torch.serve import metrics as metrics_lib
    from skypilot_tpu_torch.serve import warmup as warmup_lib
    from skypilot_tpu_torch.train import data as data_lib
    from skypilot_tpu_torch.train import run as train_run
    from skypilot_tpu_torch.train import trainer as trainer_lib
    from skypilot_tpu_torch.utils.device import resolve_device
    print(_card(), flush=True)
    resolve_device()
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'python {sys.version.split()[0]}', flush=True)

    _phase('phase 1: build')
    _build_all([da, fa])

    _phase('phase 2: flash_decode (K4) against its plain version')
    kernels = kernel_phase(da)

    _phase('phase 3: flash attention (K1-K3) against the plain versions')
    flash = attention_phase(fa)
    check_sm90_bodies(fa)

    _phase('phase 4: small model serving, card against CPU')
    small_model_phase(llama, gen_lib)
    small_engine_phase(llama, engine_lib)
    small_paged_engine_phase(llama, engine_lib)
    small_spec_engine_phase(llama, engine_lib)
    mm_phase(quant_lib, llama)

    _phase('phase 5: small model training, card against CPU')
    small_train_phase(llama, trainer_lib, data_lib)
    small_lora_phase(llama, trainer_lib, lora_lib)

    _phase('phase 6: training bench-1b at seq 4096 through train.run')
    train_launches = train_phase(llama, fa, train_run)

    _phase(f'phase 7: serving bench-1b ({SERVE_LAYERS} of 18 layers) over '
           'HTTP, window path (--engine off)')
    with _cut_depth(llama, 'bench-1b', SERVE_LAYERS):
        for quantize, kv_cache in ((None, 'bf16'), ('int8', 'int8')):
            serving_phase(srv_lib, gen_lib, da, quantize, kv_cache)

    _phase(f'phase 8: serving bench-1b ({SERVE_LAYERS} of 18 layers) over '
           'HTTP, the default continuous engine')
    launches, engine_figs = {}, {}
    with _cut_depth(llama, 'bench-1b', SERVE_LAYERS):
        for mode, quantize in (('bf16', None), ('int8', 'int8')):
            launches[mode], engine_figs[mode] = engine_phase(
                srv_lib, gen_lib, engine_lib, da, quantize, mode)

    _phase(f'phase 9: the serve-llama recipe (llama3-1b, {RECIPE_LAYERS} of '
           '16 layers, int8 + int8 KV, prefix pool 8, max_len 2048) over '
           'HTTP, then chunked prefill')
    by_path = {mode: {'phase 8 bench-1b engine': n}
               for mode, n in launches.items()}
    with _cut_depth(llama, 'llama3-1b', RECIPE_LAYERS):
        by_path['int8']['phase 9 serve-llama'], recipe_figs = recipe_phase(
            srv_lib, gen_lib, da)
    _phase(f'phase 10: the llama-finetune recipe (llama3-1b at '
           f'{FINETUNE_LAYERS} of 16 layers, batch 8, seq 2048) through '
           'train.run: save, resume, preempt')
    with _cut_depth(llama, 'llama3-1b', FINETUNE_LAYERS):
        finetune_launches, trainer_bundle = finetune_phase(
            llama, fa, train_run, ckpt_manifest, layers=FINETUNE_LAYERS)

    _phase(f'phase 11: the paged layout at full width (llama3-1b, '
           f'{RECIPE_LAYERS} of 16 layers, int8 + int8 KV, max_len 2048, '
           '--kv-layout paged) over HTTP')
    with _cut_depth(llama, 'llama3-1b', RECIPE_LAYERS):
        by_path['int8']['phase 11 serve-paged'] = paged_phase(
            srv_lib, gen_lib, da, recipe_figs[8])

    _phase(f'phase 12: the lora-finetune recipe (bench-1b at '
           f'{SERVE_LAYERS} of 18 layers, batch 16, seq 2048, --mesh '
           'fsdp=-1, rank 16) through train.run: save, resume')
    with _cut_depth(llama, 'bench-1b', SERVE_LAYERS):
        lora_launches = lora_phase(llama, fa, train_run, lora_lib,
                                   trainer_lib)

    _phase(f'phase 13: speculative decoding (bench-1b at {SERVE_LAYERS} of '
           '18 layers + bench-draft, k 4) over HTTP: the engine, the window '
           'path, an identical draft')
    with _cut_depth(llama, 'bench-1b', SERVE_LAYERS):
        by_path['bf16']['phase 13 serve-spec'] = spec_phase(
            srv_lib, gen_lib, engine_lib, llama, da, engine_figs['bf16'])

    _phase('phase 14: mixture of experts (moe-8x1b): a small MoE model card '
           'against CPU, serving over HTTP through the engine and the window '
           'path, training through train.run')
    small_moe_phase(llama, moe_lib, gen_lib, engine_lib, trainer_lib,
                    data_lib)
    _phase('  14a done')
    moe_figs = {}
    with _cut_depth(llama, 'moe-8x1b', SERVE_LAYERS):
        for mode, quantize in (('bf16', None), ('int8', 'int8')):
            by_path[mode]['phase 14 serve-moe'], moe_figs[mode] = \
                moe_engine_phase(srv_lib, gen_lib, da, quantize, mode)
        _phase(f'  14b done (moe-8x1b at {SERVE_LAYERS} of 18 layers)')
        by_path['bf16']['phase 14 window-moe'] = moe_window_phase(
            srv_lib, gen_lib, da)
    _phase('  14c done')
    with _cut_depth(llama, 'moe-8x1b', SERVE_LAYERS):
        moe_launches = moe_train_phase(llama, fa, train_run, trainer_lib)
    for mode in MODES:
        print(f'  serve-moe {mode}: {moe_figs[mode]["tok_s"]:.1f} tok/s, '
              f'{moe_figs[mode]["host_ms_per_step"]:.2f} host ms a step; '
              f'phase 8 bench-1b {mode}: {engine_figs[mode]["tok_s"]:.1f} '
              f'tok/s, {engine_figs[mode]["step_ms"]:.2f} ms', flush=True)

    for mode in MODES:
        for case in (LLAMA_CASE, DRAFT_CASE, DISAGG_CASE, TP2_CASE,
                     TP8_CASE, TP4_BENCH_CASE, TP4_RECIPE_CASE,
                     DRAFT_TP2_CASE, DP_CASE):
            row = next(c for c in kernels[mode]['cases']
                       if c['case'] == case and c['dtype'] == 'bfloat16')
            print(f'  flash_decode[{mode} cache] at {case}: ms {row["ms"]}'
                  f' plain_ms {row["plain_ms"]} library_ms '
                  f'{row["library_ms"]} bound_ms {row["bound_ms"]} '
                  f'({row["bound_by"]})', flush=True)

    _phase('phase 15: the replica\'s boot and fleet contract (bench-1b): '
           'three boots through python -m skypilot_tpu_torch.serve.'
           'llm_server, then QoS admission under a flood')
    kernel_cache = tempfile.mkdtemp(prefix='skytpu-kernels-')
    try:
        boot_phase(kernel_cache)
        _phase('  15a done')
        with _cut_depth(llama, 'bench-1b', SERVE_LAYERS):
            by_path['bf16']['phase 15 serve-qos'] = qos_phase(
                srv_lib, gen_lib, da, metrics_lib, warmup_lib)

        _phase(f'phase 16: serve-traced (bench-1b, 16a-16b at '
               f'{SERVE_LAYERS} of 18 layers): request tracing, the '
               'black-box recorder, the /debug routes, OpenMetrics '
               'exemplars, the device doctor')
        with _cut_depth(llama, 'bench-1b', SERVE_LAYERS):
            by_path['bf16']['phase 16 serve-traced'] = traced_phase(
                srv_lib, gen_lib, da, metrics_lib, trace_lib, blackbox)
        _phase('  16a-16b done')
        failure_dump_phase(llama, engine_lib, blackbox)
        sigquit_phase(kernel_cache, llama.PRESETS['bench-1b'].vocab_size)
        _check_trainer_bundle(trainer_bundle)
        doctor_phase()
    finally:
        shutil.rmtree(kernel_cache, ignore_errors=True)

    # 18g's gang (its own processes) starts here and serves beside phase
    # 17 (one process) and 18a-18f; phase 18 checks what it served.
    axes_dir, axes_gang = tempfile.mkdtemp(prefix='skytpu-axes-'), None
    try:
        axes_gang = start_serve_axes(llama, axes_dir)
        _phase('phase 17: serve-disagg (bench-1b): colocated, prefill and '
               'decode replicas, the export -> prepare -> fetch -> import '
               'legs over HTTP; 17a paged bf16, 17c transports and '
               'failures, 17b slot int8')
        disagg = disagg_phase(srv_lib, gen_lib, engine_lib, paged_lib,
                              disagg_lib, da)
        by_path['bf16']['phase 17 serve-disagg'] = disagg['bf16']
        by_path['int8']['phase 17 serve-disagg int8'] = disagg['int8']

        _phase(f'phase 18: serve-tp: bench-1b at {SERVE_LAYERS} of 18 '
               'layers, --tp 2 (18a), the '
               f'serve-multihost recipe (llama3-8b int8 at {TP8_LAYERS} of '
               '32 layers, --tp 8 as 2 hosts x 4 ranks, 18b), then at tp 2 '
               'the paged decode replica with sharing and tiers (18c), a '
               f'draft (18d), moe-8x1b at {SERVE_LAYERS} layers (18e), the '
               'engine on data=2,tensor=2 (18f) and on fsdp=2,tensor=2, '
               'pipe=2,tensor=2, seq=2,tensor=2 and (moe-8x1b) '
               'expert=2,tensor=2 (18g, serving since phase 17); every '
               'rank a process on the one card, gloo')
        tp_bench, tp_recipe, tp_more = tp_phase(srv_lib, gen_lib, llama,
                                                axes_gang)
    finally:
        if axes_gang is not None:
            _dp_stop(axes_gang)
        shutil.rmtree(axes_dir, ignore_errors=True)
    by_path['bf16']['phase 18a serve-tp (2 ranks)'] = sum(tp_bench)
    by_path['int8']['phase 18b serve-multihost (8 ranks)'] = sum(tp_recipe)
    by_path['bf16']['phase 18c serve-tp-paged (2 ranks)'] = sum(
        tp_more['18c'])
    by_path['bf16']['phase 18d serve-tp-spec (2 ranks)'] = sum(
        tp_more['18d'])
    by_path['bf16']['phase 18e serve-tp-moe (2 ranks)'] = sum(
        tp_more['18e'])
    for run, n in tp_more['18f'].items():
        by_path['bf16'][f'phase 18f serve-dp {run} (4 ranks)'] = sum(n)
    for run, n in tp_more['18g'].items():
        by_path['bf16'][f'phase 18g serve-axes {run} (4 ranks)'] = sum(n)

    _phase('phase 19: sharded training: the multislice-train recipe '
           '(bench-1b, data=2,fsdp=2 as 2 hosts x 2 ranks, 19a), the '
           'lora-finetune recipe on fsdp=2 with a resume (19b), a small '
           'fp32 model on four meshes card against CPU (19c), the '
           'moe-finetune recipe (19d), bench-1b in 4 stages on pipe=2 '
           '(19e), every rank a process on the one card, gloo')
    mesh_launches = mesh_phase(llama, train_run)

    _phase('phase 20: summary')
    print(_card(), flush=True)  # again here, where the output's tail has it
    entries = []
    for name, (replaces, _, source) in FLASH.items():
        paths = {'phase 6 train-s4096': train_launches[name],
                 'phase 10 llama-finetune': finetune_launches[name],
                 'phase 12 lora-finetune': lora_launches[name],
                 'phase 14 train-moe': moe_launches[name],
                 **{path: n[name] for path, n in mesh_launches.items()}}
        entries.append({
            'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': sum(paths.values()),
            'launches_by_path': paths, **flash[name]})
    for mode, (replaces, _) in MODES.items():
        head = kernels[mode]['head']  # the engine's B=16 M=1024, bf16
        entries.append({
            'name': f'flash_decode[{mode} cache]', 'route': 'cuda',
            'source': CSRC + 'decode_attention.cu',
            'replaces': replaces, 'launches': sum(by_path[mode].values()),
            'launches_by_path': by_path[mode], 'timed_at': ENGINE_CASE,
            'max_abs_err': kernels[mode]['max_abs_err'],
            'ms': head['ms'], 'plain_ms': head['plain_ms'],
            'bound_ms': head['bound_ms'], 'bound_by': head['bound_by'],
            'library_ms': head['library_ms'],
            'by_shape': {case: {k: kernels[mode][key][k] for k in (
                'ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_by')}
                for key, case in (('llama', LLAMA_CASE),
                                  ('draft', DRAFT_CASE),
                                  ('disagg', DISAGG_CASE),
                                  ('tp2', TP2_CASE), ('tp8', TP8_CASE),
                                  ('tp4a', TP4_BENCH_CASE),
                                  ('tp4b', TP4_RECIPE_CASE),
                                  ('draft_tp2', DRAFT_TP2_CASE),
                                  ('dp', DP_CASE))}})
    print(json.dumps({'kernels': entries}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(nccl_main() if sys.argv[1:] == ['--nccl'] else main())
