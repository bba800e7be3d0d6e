#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``skypilot_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

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
   (llama3-1b: B=16, Hq 32, Hkv 8, D=64, M=2048, the same lengths) and
   the speculative engine's draft (bench-draft: B=16, Hq 8, Hkv 8, D=64,
   M=1024, the same lengths), bf16 and int8 caches, bf16 and fp32
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
   S=2048). Absolute
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
   64/128, causal or not) shows HGMMA and UTMALDG in the library's SASS
   and ptxas reports 0 spill bytes for it.
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
   launches over A, B and C = 2 x 16 / 16 / 16 per step. Then the recipe
   in a subprocess (``--steps 10 --save-every 3``, with
   ``--ckpt-local-dir``) gets SIGTERM after its line ``step 4/10``: exit
   143 with step 3 or later durable; a relaunch with ``--steps 5`` must
   print the resumed line and exit 0. Every committed step passes
   ``verify_step(deep=True)``. Prints step ms, tokens/s, MFU, peak device
   memory, snapshot bytes, the stall of each async and sync save, persist,
   restore and emergency-persist seconds.
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
   for bit; the adapters hold 4,128,768 values; the optimizer state is
   under half the base's size; K1/K2/K3 launches = 2 x 18 / 18 / 18 per
   step. Prints step ms, tokens/s, MFU and peak device memory.
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
   every expert leaf moved, K1 = 2 x 18 x 3, K2 = K3 = 18 x 3; step ms,
   tokens/s, the printed mfu and the active-parameter share.
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
   and 200 with it, K4 = n_layers x chunk_steps x dispatches.
16. Summary: the card's name and power limit again, one JSON line of
   kernels (K1-K3's launches are phases 6, 10, 12 and 14, K4's phase
   8's, 13's, 14's and 15's for the bf16 cache, phases 8's, 9's, 11's and 14's
   for the int8 cache, each path's count in ``launches_by_path``; K4's
   times are the engine-shape case of phase 2, K1-K3's the train-s4096
   shape, each named in ``timed_at``, with the llama-finetune,
   lora-finetune and train-moe shapes (K1-K3) and the serve-llama and
   draft shapes (K4) under ``by_shape``), then the last line ``{"ok":
   true, "device": {...}}``.

It exits with an error, printing no result, when CUDA is absent or when
the ``skypilot_tpu_torch`` package is not beside it.
"""
import collections
import concurrent.futures
import contextlib
import dataclasses
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
TRAIN_CASE = 'train B=2 S=4096'  # K1-K3 at train-s4096 (BENCH_1B)
FINETUNE_CASE = 'llama3-1b B=8 S=2048'  # K1-K3 at llama-finetune's shape
LORA_CASE = 'bench-1b B=16 S=2048'  # K1-K3 at the lora-finetune recipe's
MOE_CASE = 'moe-8x1b B=2 S=2048'  # K1-K3 at train-moe's shape (phase 14d)
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
# layers, so that the whole script stays well inside its time limit.
RECIPE_LAYERS = 8
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
                          ('draft', DRAFT_CASE)):
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
    ]
    worst = {name: 0.0 for name in FLASH}
    timed = {TRAIN_CASE: {}, FINETUNE_CASE: {}, LORA_CASE: {},
             MOE_CASE: {}}
    for label, b, hq, hkv, s, d, dtype, causal in cases:
        q, k, v, do = _attn_case(gen, b, hq, hkv, s, d, dtype)
        o, lse = fa.flash_fwd(q, k, v, causal)
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
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
        print(f'  {label:18s} {str(dtype).split(".")[-1]:8s} causal={causal} '
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
                                 MOE_CASE: timed[MOE_CASE][name]})
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
        if len(names) != 4:
            raise AssertionError(f'{body}: {len(names)} instances in the '
                                 'SASS, expected 4 (D 64/128, causal or not)')
        for name in names:
            missing = [op for op in ('HGMMA', 'UTMALDG')
                       if op not in functions[name]]
            if missing or spills.get(name) != 0:
                raise AssertionError(f'{name}: missing {missing} in SASS, '
                                     f'spill bytes {spills.get(name)}')
        print(f'  {body}: {len(names)} instances, each with HGMMA and '
              'UTMALDG in its SASS and 0 spill bytes', flush=True)


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
def _cut_depth(llama, name, n_layers):
    """``llama.PRESETS[name]`` at ``n_layers`` layers, its widths
    untouched, while open."""
    full = llama.PRESETS[name]
    llama.PRESETS[name] = dataclasses.replace(full, n_layers=n_layers)
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


def _preempt_and_relaunch(manifest, root, env):
    """The recipe in a subprocess, SIGTERM after the line 'step 4/10',
    then a relaunch to 5 steps. Returns the newest committed step after
    the exit, what the SIGTERM handler reported (durable step or None,
    seconds), and the seconds from SIGTERM to exit."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(env, PYTHONPATH=here)
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
    return durable, (m.group(1), float(m.group(2))), exit_s


def finetune_phase(llama, fa, train_run, manifest):
    """The llama-finetune recipe through train.run with checkpoints: A
    trains 4 steps saving at 2 and 4 (async); B resumes to 6; C runs 6
    uninterrupted with --ckpt-sync, saving at 3 and 6. B's losses and
    final state must equal C's bit for bit, A's losses C's first four.
    Then the recipe in a subprocess is preempted and relaunched, and
    every committed step passes a deep verify. Returns K1-K3's launches
    over A, B and C."""
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
        durable, handler, exit_s = _preempt_and_relaunch(
            manifest, root,
            dict(os.environ, SKYTPU_TRAIN_TELEMETRY_DIR=sub_spool))
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
    return launches


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
LORA_ADAPTER_VALUES = 18 * 229_376  # 4,128,768 at rank 16 on BENCH_1B


def lora_phase(llama, fa, train_run, lora_lib, trainer_lib):
    """The lora-finetune recipe through train.run with checkpoints: A
    trains 4 steps saving at 2 and 4 (async); B resumes to 6; C runs 6
    uninterrupted in a fresh dir (sync saves at 3 and 6). A's losses must
    equal C's first four, B's C's last two, B's final state (adapters,
    optimizer state, base) C's bit for bit; the base after 6 steps equals
    the initial weights bit for bit; the adapters hold 4,128,768 values
    and the optimizer state is under half the base's size. Returns K1-K3's
    launches over A, B and C (2 x 18 / 18 / 18 per step)."""
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
            layers, steps = llama.BENCH_1B.n_layers, 4 + 2 + 6
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
            init = llama.init_params(llama.BENCH_1B, torch.Generator(
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
            if adapter_values != LORA_ADAPTER_VALUES or \
                    not opt_values < base_values / 2:
                raise AssertionError(f'adapters {adapter_values} values (want '
                                     f'{LORA_ADAPTER_VALUES}), optimizer state '
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
                  token_mask=None):
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
                   token_mask=token_mask)

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
    router and every expert leaf moved, K1 = 2 x 18 x 3 and K2 = K3 = 18
    x 3. Returns the launches."""
    cfg = llama.MOE_8X1B
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


def boot_phase():
    """15a: three fresh replicas through ``python -m
    skypilot_tpu_torch.serve.llm_server`` sharing one empty kernel-build
    cache, SKYTPU_PROFILE=1: A cold, B warm, C warm with SKYTPU_WARMUP=1."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.observability import profiler
    vocab = llama.PRESETS[BOOT_ARGV[BOOT_ARGV.index('--model') + 1]] \
        .vocab_size
    figs = {}
    with tempfile.TemporaryDirectory(prefix='skytpu-boot-') as tmp:
        cache = os.path.join(tmp, 'kernels')
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
    from skypilot_tpu_torch.ckpt import manifest as ckpt_manifest
    from skypilot_tpu_torch.models import engine as engine_lib
    from skypilot_tpu_torch.models import generate as gen_lib
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models import lora as lora_lib
    from skypilot_tpu_torch.models import moe as moe_lib
    from skypilot_tpu_torch.models import quantization as quant_lib
    from skypilot_tpu_torch.ops import attention as fa
    from skypilot_tpu_torch.ops import decode_attention as da
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

    _phase('phase 7: serving bench-1b over HTTP, window path (--engine off)')
    for quantize, kv_cache in ((None, 'bf16'), ('int8', 'int8')):
        serving_phase(srv_lib, gen_lib, da, quantize, kv_cache)

    _phase('phase 8: serving bench-1b over HTTP, the default continuous '
           'engine')
    launches, engine_figs = {}, {}
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
    _phase('phase 10: the llama-finetune recipe (llama3-1b, batch 8, seq '
           '2048) through train.run: save, resume, preempt')
    finetune_launches = finetune_phase(llama, fa, train_run, ckpt_manifest)

    _phase(f'phase 11: the paged layout at full width (llama3-1b, '
           f'{RECIPE_LAYERS} of 16 layers, int8 + int8 KV, max_len 2048, '
           '--kv-layout paged) over HTTP')
    with _cut_depth(llama, 'llama3-1b', RECIPE_LAYERS):
        by_path['int8']['phase 11 serve-paged'] = paged_phase(
            srv_lib, gen_lib, da, recipe_figs[8])

    _phase('phase 12: the lora-finetune recipe (bench-1b, batch 16, seq '
           '2048, --mesh fsdp=-1, rank 16) through train.run: save, resume')
    lora_launches = lora_phase(llama, fa, train_run, lora_lib, trainer_lib)

    _phase('phase 13: speculative decoding (bench-1b + bench-draft, k 4) '
           'over HTTP: the engine, the window path, an identical draft')
    by_path['bf16']['phase 13 serve-spec'] = spec_phase(
        srv_lib, gen_lib, engine_lib, llama, da, engine_figs['bf16'])

    _phase('phase 14: mixture of experts (moe-8x1b): a small MoE model card '
           'against CPU, serving over HTTP through the engine and the window '
           'path, training through train.run')
    small_moe_phase(llama, moe_lib, gen_lib, engine_lib, trainer_lib,
                    data_lib)
    _phase('  14a done')
    moe_figs = {}
    for mode, quantize in (('bf16', None), ('int8', 'int8')):
        by_path[mode]['phase 14 serve-moe'], moe_figs[mode] = \
            moe_engine_phase(srv_lib, gen_lib, da, quantize, mode)
    _phase('  14b done')
    by_path['bf16']['phase 14 window-moe'] = moe_window_phase(
        srv_lib, gen_lib, da)
    _phase('  14c done')
    moe_launches = moe_train_phase(llama, fa, train_run, trainer_lib)
    for mode in MODES:
        print(f'  serve-moe {mode}: {moe_figs[mode]["tok_s"]:.1f} tok/s, '
              f'{moe_figs[mode]["host_ms_per_step"]:.2f} host ms a step; '
              f'phase 8 bench-1b {mode}: {engine_figs[mode]["tok_s"]:.1f} '
              f'tok/s, {engine_figs[mode]["step_ms"]:.2f} ms', flush=True)

    for mode in MODES:
        for case in (LLAMA_CASE, DRAFT_CASE):
            row = next(c for c in kernels[mode]['cases']
                       if c['case'] == case and c['dtype'] == 'bfloat16')
            print(f'  flash_decode[{mode} cache] at {case}: ms {row["ms"]}'
                  f' plain_ms {row["plain_ms"]} library_ms '
                  f'{row["library_ms"]} bound_ms {row["bound_ms"]} '
                  f'({row["bound_by"]})', flush=True)

    _phase('phase 15: the replica\'s boot and fleet contract (bench-1b): '
           'three boots through python -m skypilot_tpu_torch.serve.'
           'llm_server, then QoS admission under a flood')
    boot_phase()
    _phase('  15a done')
    by_path['bf16']['phase 15 serve-qos'] = qos_phase(
        srv_lib, gen_lib, da, metrics_lib, warmup_lib)

    _phase('phase 16: summary')
    print(_card(), flush=True)  # again here, where the output's tail has it
    entries = []
    for name, (replaces, _, source) in FLASH.items():
        paths = {'phase 6 train-s4096': train_launches[name],
                 'phase 10 llama-finetune': finetune_launches[name],
                 'phase 12 lora-finetune': lora_launches[name],
                 'phase 14 train-moe': moe_launches[name]}
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
                                  ('draft', DRAFT_CASE))}})
    print(json.dumps({'kernels': entries}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
