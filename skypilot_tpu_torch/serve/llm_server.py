"""LLM inference replica, in PyTorch: the continuous engine and the
window-batching path.

Port of ``skypilot_tpu/serve/llm_server.py``, two of its paths:

* CONTINUOUS BATCHING (default, ``--engine continuous``): each row of a
  request takes one slot of ``models/engine.py``'s ``ContinuousEngine``
  (16 slots, 8-step chunks, pipelined unless ``--pipeline off``;
  ``--prefix-cache N`` keeps N popular prompt prefixes' KV;
  ``SKYTPU_LLM_PREFILL_CHUNK`` chunks long prompts). ``--kv-layout
  paged`` serves from a block pool of ``--kv-blocks`` blocks, with
  copy-on-write block sharing (``--prefix-share``, default on there) and
  KV tiers (``SKYTPU_KV_TIERS``, ``SKYTPU_KV_HOST_BYTES``,
  ``SKYTPU_KV_SPILL_DIR``). ``--draft-model`` (``SKYTPU_LLM_DRAFT``)
  rides a draft model inside the engine: per-slot propose/verify rounds
  of ``SKYTPU_LLM_SPEC_K`` (default 4) proposals. Short
  requests drain mid-stream while long ones keep decoding. ``"stream": true``
  writes NDJSON lines ``{"row": i, "tokens": [...]}`` as the engine emits
  them, then ``{"done": true}`` (an ``{"error": ...}`` line on failure), in
  a body that ends when the connection closes.
* WINDOW BATCHING (``--engine off``, and every seeded sampled request,
  whose output must depend on its seed alone): concurrent requests that
  land within the batch window (``SKYTPU_LLM_BATCH_WINDOW_MS``, at most
  ``SKYTPU_LLM_MAX_BATCH`` rows) are right-padded into one ``generate``
  call. A seeded request is never batched with another. With a draft,
  greedy batches of uniform prompt length decode through
  ``speculative.generate_speculative`` (the target's exact greedy
  stream; ``/health`` ``speculative`` counts them).

The fleet contract (what ``sky serve``'s controller, autoscalers and SLO
engine read): ``/health`` with ``queue.depth_total``, the ``qos``,
``compile_cache``, ``warmup`` and ``ttft_ms`` blocks (``ttft_ms`` from a
512-deep window of recent TTFTs: the first emission on the engine path,
the whole call on the window path), and ``profile`` with
``SKYTPU_PROFILE=1``; ``/metrics`` (Prometheus text, ``serve/metrics.py``)
and ``/debug/profile``, both behind ``SKYTPU_METRICS_TOKEN`` when it is
set. ``--qos on`` (``SKYTPU_QOS``) puts ``serve/qos.py``'s admission in
front of both paths: priority classes, tenant quotas, 429 with
``Retry-After`` on a shed, 504 past a class's queue TTL.

``main()`` boots as the JAX replica does, marking the cold-start ledger
(``observability/profiler.py``): imports, the arguments, the kernel-build
cache (``SKYTPU_COMPILE_CACHE``), the CUDA context under deferred
signals (``utils/cuda_client_guard.py``), the weights and engine, the
warm-up (``SKYTPU_WARMUP=1``, ``serve/warmup.py``; a failed warm-up fails
the boot), then the listener. ``/health`` answers 503 ``warming`` while a
warm-up runs and marks ``ready`` on its first 200.

TRACING (``observability/trace.py``; on by default, ``SKYTPU_TRACE=0``
turns it off): every ``/generate`` gets a ``serve.generate`` root span,
joined to the caller's ``X-SkyTPU-Trace`` (``resume=true`` with
``X-SkyTPU-Trace-Resume``), with ``qos.queue_wait``, ``serve.prefill``,
``serve.decode`` (a ``serve.decode.chunk`` child per emission, with the
engine's pipeline-overlap deltas), ``serve.stream`` and ``serve.window``
children built after the fact from the timestamps the engine's callbacks
already record: the engine thread never touches the tracer, and greedy
tokens are the same with tracing on or off. The retention verdict of a
response that is not streamed rides back on ``X-SkyTPU-Trace-Verdict``;
the same traced observations are the histograms' exemplars. The
FLIGHT RECORDER (``observability/blackbox.py``) keeps the engine's edges
and the drain; every bundle carries this replica's ``/health``.

DISAGGREGATED PREFILL/DECODE (``--role``, ``SKYTPU_LLM_ROLE``; the wire
format is ``serve/disagg.py``'s skytpu-kv/1): a ``prefill`` replica
answers ``/v1/kv/export`` (prefill, park the handoff for
``/v1/kv/fetch``, or write it to ``SKYTPU_DISAGG_STAGING``), a ``decode``
replica ``/v1/kv/prepare`` (how many leading blocks its trie holds) and
``/v1/kv/import`` (install and decode, buffered or NDJSON with
``?stream=1``: 400 for bytes that are unusable, 409 for bytes that cannot
be installed here, before any line). ``/v1/kv/chains`` resolves advert
digests to prompts. Every role serves ``/generate`` too, the load
balancer's colocated fallback, which counts ``X-SkyTPU-Disagg-Fallback``.
QoS gates the export and charges the whole budget there. The
``serve.kv_export`` and ``serve.kv_import`` roots join the load
balancer's ``lb.handoff.*`` legs through ``X-SkyTPU-Trace``.

TENSOR PARALLELISM (``--tp N``, ``SKYTPU_LLM_TP``; ``serve/spmd.py``): one
process per rank. ``main()`` brings the ranks up (rank 0 starts N - 1
followers with its own argv, or joins the hosts of a multi-host replica
under the gang launcher's env); rank 0 serves HTTP, every rank holds its
shard of the weights (initialised and quantized sharded) and of the KV
cache, and ``SpmdEngine`` keeps them in lockstep. ``/health`` ``tp`` is N
(``tp_backend`` names the collective backend). As the JAX replica does
with its decode kernel on (the port's is always on), ``--engine off`` with
``--tp > 1`` is refused at startup and a seeded request on such a replica
gets a 400. SIGTERM drains rank 0 and broadcasts stop: every rank exits
0; a rank that dies makes rank 0 fail its waiters and exit non-zero.
Each rank prints a ``tp-rank-summary`` JSON line on its way out. One
check is the port's own: token
ids outside the vocabulary get a 400 (a JAX gather clamps them; a CUDA
index fault would end the replica's CUDA context), and a body that is not
JSON gets a 400 whose trace carries ``error`` (JAX answers it 500).

HTTP bodies are read by ``Content-Length`` (a handoff of bench-1b in bf16
is 73,728 bytes a prompt token); a chunked body gets 411.

HTTP is the standard library's ``ThreadingHTTPServer``. Handler threads
validate and submit; the engine thread (or the window worker thread)
runs all device work.

API (token-level, as the JAX replica, so the shared load balancer can
drive either):
  GET  /health    -> {"status": "ok", "model": ..., "device": ...,
                      "role": ..., "disagg": {handoff counters},
                      "queue": {"pending", "overflow", "depth_total"},
                      "engine": {engine stats} (absent with --engine off),
                      "qos": {...} (QoS on), "compile_cache": {...},
                      "warmup": {...}, "ttft_ms": {...} (after a request),
                      "profile": {...} (SKYTPU_PROFILE=1),
                      "draft_model": ..., "speculative": {...} (a draft),
                      "prefix_summary": {...} (paged, sharing on),
                      "trace": {tail retention stats}, ...}
  GET  /metrics (OpenMetrics with exemplars when Accept asks for it),
       /debug/traces, /debug/blackbox, /debug/exemplars, /debug/alerts,
       /debug/profile (bearer SKYTPU_METRICS_TOKEN when set)
  POST /generate  {"tokens": [[...]], "max_new_tokens": N,
                   "temperature": t?, "seed": s?, "top_k": k?,
                   "top_p": p?, "eos_token": id or [ids]?, "stream": b?,
                   "priority": class?, "tenant": id?}
                  -> {"tokens": [[...]]}, or NDJSON lines when streamed
  POST /v1/kv/export   {"tokens": [...], "max_new_tokens": N, ...}
                  -> {"layout", "nbytes", "prompt_len", "full_blocks",
                      "block", "handoff" or "staging_ref"}
  GET  /v1/kv/fetch?handoff=ID&skip_blocks=N -> the payload (one-shot)
  POST /v1/kv/prepare  {"tokens": [...]} -> {"skip_blocks": N}
  POST /v1/kv/chains   {"digests": [hex...]} -> {"chains": [[...]]}
  POST /v1/kv/import[?stream=1]  the payload, or {"staging_ref": ref}
                  -> {"tokens": [[...]]}, or NDJSON lines when streamed

Run: ``python -m skypilot_tpu_torch.serve.llm_server --model llama3-1b
--max-len 2048 --quantize int8 --kv-cache int8 --prefix-cache 8`` (the
serve-llama recipe; ``--kv-layout paged [--kv-blocks N] [--prefix-share
on|off]`` in place of ``--prefix-cache 8`` for the paged layout; port
from --port or SKYTPU_REPLICA_PORT; ``--engine off`` for the window path
only; ``--qos on`` for admission control; ``SKYTPU_WARMUP=1`` to warm up
before the listener binds).
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import http.server
import json
import os
import queue
import secrets
import signal
import sys
import threading
import time
import urllib.parse
import weakref
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import torch

from skypilot_tpu_torch.models import engine as engine_lib
from skypilot_tpu_torch.models import generate as gen_lib
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import quantization as quant_lib
from skypilot_tpu_torch.models import speculative
from skypilot_tpu_torch.observability import blackbox
from skypilot_tpu_torch.observability import profiler
from skypilot_tpu_torch.observability import slo
from skypilot_tpu_torch.observability import trace as trace_lib
from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.serve import disagg as disagg_lib
from skypilot_tpu_torch.serve import metrics as metrics_lib
from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.serve import qos as qos_lib
from skypilot_tpu_torch.serve import spmd
from skypilot_tpu_torch.serve import warmup as warmup_lib
from skypilot_tpu_torch.utils import cuda_client_guard
from skypilot_tpu_torch.utils import users as users_lib
from skypilot_tpu_torch.utils.device import resolve_device

MAX_BATCH = int(os.environ.get('SKYTPU_LLM_MAX_BATCH', '32'))
BATCH_WINDOW_S = float(os.environ.get('SKYTPU_LLM_BATCH_WINDOW_MS',
                                      '8')) / 1000.0


class _ChunkRecorder:
    """A request's emission times: the engine thread's callback appends
    (time, row, tokens) and nothing else; the histograms and the TTFT
    window read them after the request ends."""
    __slots__ = ('t0', 'events')

    def __init__(self):
        self.t0 = time.time()
        self.events: List[Tuple[float, int, int]] = []

    def cb(self, ri: int, then: Optional[Callable] = None) -> Callable:
        events = self.events

        def _cb(toks):
            events.append((time.time(), ri, len(toks)))
            if then is not None:
                then(toks)
        return _cb


class _Pending:

    def __init__(self, rows: List[List[int]], max_new: int,
                 temperature: float, seed: Optional[int],
                 top_k: int = 0, top_p: float = 1.0, eos=None):
        self.rows = rows
        self.max_new = max_new
        self.temperature = temperature
        self.seed = seed
        self.top_k = top_k
        self.top_p = top_p
        self.eos = eos  # frozenset of stop ids, or None
        self.future: concurrent.futures.Future = concurrent.futures.Future()

    @property
    def group_key(self):
        # Sampling noise depends on batch composition, so a seeded
        # request is NEVER batched with anything else.
        if self.temperature > 0 and self.seed is not None:
            return ('seeded', id(self))
        # Sampling params are per-generate()-call scalars here, so only
        # like-configured requests share a batch.
        return (self.temperature, self.top_k, self.top_p, None)


# The handoff's admissions bypass the arrival broadcast that keeps a
# tensor-parallel replica's ranks in lockstep (serve/spmd.py).
TP_HANDOFF_ERROR = ('KV export and import are not ported on a --tp > 1 '
                    'replica yet')


class LlmServer:
    """One model replica. ``device`` None = CUDA (raises without a
    card); the tests pass ``device='cpu'``."""

    def __init__(self, model: str, max_len: int = 1024, seed: int = 0,
                 quantize: Optional[str] = None,
                 kv_cache: Optional[str] = None, device=None,
                 engine: Optional[str] = None,
                 kv_layout: Optional[str] = None,
                 prefix_cache: Optional[int] = None,
                 pipeline: Optional[str] = None,
                 draft_model: Optional[str] = None,
                 kv_blocks: Optional[int] = None,
                 prefix_share: Optional[str] = None,
                 qos: Optional[str] = None,
                 qos_opts: Optional[Dict[str, Any]] = None,
                 role: Optional[str] = None, tp: Optional[int] = None):
        # Cheap knobs first: a typo must not cost the weight init.
        engine = check_knobs(model, engine, qos)
        self.tp = check_tp(tp, engine)
        self.world = mesh_lib.world_size()
        if self.world != max(self.tp, 1):
            raise ValueError(
                f'--tp {self.tp} needs {self.tp} ranks in the process '
                f'group, found {self.world}: start the replica through '
                'llm_server.main or serve.spmd, which bring them up')
        # The disaggregated-serving role: 'prefill' replicas are routed
        # /v1/kv/export, 'decode' replicas /v1/kv/import; every role
        # still serves /generate (the load balancer's fallback).
        self.role = role or os.environ.get('SKYTPU_LLM_ROLE', 'colocated')
        if self.role not in ('colocated', 'prefill', 'decode'):
            raise ValueError(f'Unknown role {self.role!r}; '
                             "'colocated', 'prefill' or 'decode'")
        # QoS admission (serve/qos.py), off by default: without it no
        # scheduler exists and the serving path is the ungated one.
        qos_on = qos_lib.enabled(qos)
        qos_opts = dict(qos_opts or {})
        if qos_on and not qos_opts:
            qos_lib.validate_env()
        if pipeline not in (None, 'on', 'off'):
            raise ValueError(f'Unknown pipeline {pipeline!r}; '
                             "'on' or 'off'")
        if prefix_share not in (None, 'on', 'off'):
            raise ValueError(f'Unknown prefix_share {prefix_share!r}; '
                             "'on' or 'off'")
        # The paged pool's size in blocks, junk sink included; 0/None =
        # the engine's default (full capacity).
        self.kv_blocks = kv_blocks or int(
            os.environ.get('SKYTPU_LLM_KV_BLOCKS', '0')) or None
        # Speculative decoding: with the continuous engine the draft rides
        # inside it (per-slot rounds); with --engine off it rides the
        # window path (models/speculative.py), greedy batches only.
        self.draft_model = (draft_model
                            or os.environ.get('SKYTPU_LLM_DRAFT') or None)
        self.spec_k = int(os.environ.get('SKYTPU_LLM_SPEC_K', '4'))
        if self.spec_k < 1:
            raise ValueError(f'SKYTPU_LLM_SPEC_K must be >= 1, got '
                             f'{self.spec_k}')
        self.device = resolve_device(device)
        # Tensor parallelism: a mesh whose tensor axis spans the ranks;
        # weights and KV shard by the logical rules (parallel/sharding.py).
        self.mesh = None
        if self.tp > 1:
            self.mesh = mesh_lib.build_mesh(
                mesh_lib.MeshSpec(fsdp=1, tensor=self.tp), device=self.device)
        if engine == 'continuous':
            engine_lib.check_options(
                kv_layout=kv_layout, prefix_slots=prefix_cache,
                draft=self.draft_model is not None, role=self.role,
                mesh=self.mesh,
                moe=llama.PRESETS[model].num_experts > 0)
        self.kv_cache = (kv_cache
                         or os.environ.get('SKYTPU_LLM_KV_CACHE', 'bf16'))
        if self.kv_cache not in ('bf16', 'int8'):
            raise ValueError(f'Unknown kv_cache {self.kv_cache!r}; '
                             "'bf16' or 'int8'")
        self.quantize = quantize or os.environ.get('SKYTPU_LLM_QUANTIZE')
        if self.quantize and self.quantize != 'int8':
            raise ValueError(f'Unknown quantization {self.quantize!r}; '
                             "only 'int8' (weight-only) is supported")
        self.model_name = model
        self.cfg = llama.PRESETS[model]
        self.max_len = min(max_len, self.cfg.max_seq_len)
        self.draft_cfg = None
        if self.draft_model is not None:
            if self.draft_model not in llama.PRESETS:
                raise ValueError(f'Unknown draft model '
                                 f'{self.draft_model!r}')
            if self.cfg.num_experts > 0:
                raise ValueError(
                    '--draft-model requires a dense target model; '
                    f'{model!r} is MoE (expert capacity is per forward '
                    'call, so a multi-token verify breaks greedy '
                    'exactness)')
            self.draft_cfg = llama.PRESETS[self.draft_model]
            if self.draft_cfg.vocab_size != self.cfg.vocab_size:
                raise ValueError(
                    'draft and target must share a vocabulary '
                    f'({self.draft_cfg.vocab_size} vs '
                    f'{self.cfg.vocab_size})')
            if self.draft_cfg.max_seq_len < self.max_len:
                # Otherwise every spec-eligible request would fail the
                # context check of generate_speculative.
                raise ValueError(
                    f'draft model {self.draft_model!r} max_seq_len '
                    f'{self.draft_cfg.max_seq_len} < server max_len '
                    f'{self.max_len}')
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        if self.mesh is not None:
            # Born sharded: each rank builds and quantizes its slices
            # only; the same seed gives the tp=1 replica's weights.
            self.params = llama.init_params_sharded(self.cfg, gen, self.mesh,
                                                    device=self.device)
            if self.quantize:
                self.params = quant_lib.quantize_params_sharded(
                    self.params, self.cfg, self.mesh)
            if self.mesh.stages_on_host:
                # Ranks share the card: what this rank freed is theirs.
                torch.cuda.empty_cache()
        else:
            self.params = llama.init_params(self.cfg, gen, self.device)
            if self.quantize:
                self.params = quant_lib.quantize_params(self.params)
        # The draft's weights from seed + 1, unquantized (as the JAX
        # replica keeps them).
        self.draft_params = None
        self._spec_stats = {'requests': 0, 'verifies': 0, 'proposals': 0,
                            'accepted': 0}
        if self.draft_cfg is not None:
            dgen = torch.Generator(device=self.device)
            dgen.manual_seed(seed + 1)
            self.draft_params = llama.init_params(self.draft_cfg, dgen,
                                                  self.device)
        profiler.mark('weights_load')
        profiler.register_logical('weights',
                                  profiler.tree_nbytes(self.params))
        if self.draft_params is not None:
            profiler.register_logical(
                'draft_weights', profiler.tree_nbytes(self.draft_params))
        self._queue: 'queue.Queue[Optional[_Pending]]' = queue.Queue()
        self._overflow: Deque[_Pending] = collections.deque()
        self._worker: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.batches_served = 0
        self.max_batch_seen = 0
        # (rows, max_new) of the latest generate() calls, in order: lets
        # a caller tie kernel launch counts to the work that was done.
        self.generate_calls: Deque[Tuple[int, int]] = collections.deque(
            maxlen=1024)
        self.draining = False
        self._inflight = 0
        self.engine: Optional[engine_lib.ContinuousEngine] = None
        if engine == 'continuous':
            # Ranks in lockstep take the arrival broadcast.
            engine_cls = (spmd.SpmdEngine if self.world > 1
                          else engine_lib.ContinuousEngine)
            self.engine = engine_cls(
                self.params, self.cfg, max_len=self.max_len, seed=seed,
                mesh=self.mesh,
                kv_quantize=self.kv_cache == 'int8', kv_layout=kv_layout,
                kv_blocks=self.kv_blocks, prefix_slots=prefix_cache,
                pipeline=None if pipeline is None else pipeline == 'on',
                prefix_share=(None if prefix_share is None
                              else prefix_share == 'on'),
                draft_params=self.draft_params, draft_cfg=self.draft_cfg,
                spec_k=self.spec_k, role=self.role, device=self.device)
        self.qos: Optional[qos_lib.QosScheduler] = None
        if qos_on:
            if not qos_opts.get('max_inflight'):
                # The gate sits where the device's bound on concurrency
                # is: the engine's slots, or the window path's batch cap.
                qos_opts['max_inflight'] = (
                    int(os.environ.get('SKYTPU_QOS_MAX_INFLIGHT', '0'))
                    or (self.engine.slots if self.engine is not None
                        else MAX_BATCH))
            self.qos = qos_lib.QosScheduler(**qos_opts)
        # Recent TTFTs (seconds) behind /health's ttft_ms, which the SLO
        # engine's serve.ttft_p99 rule reads.
        self._ttft_window: Deque[float] = collections.deque(maxlen=512)
        # The KV handoff's state: exports parked for their fetch (TTL),
        # the same-host staging directory, and the byte and second
        # counters behind /health's disagg and the skytpu_disagg_*
        # families (updated under _lock: handler threads run
        # concurrently).
        self._handoffs = disagg_lib.HandoffRegistry()
        self.staging_dir = os.environ.get(disagg_lib.STAGING_ENV) or None
        self.disagg_stats: Dict[str, Any] = {
            'exports': 0, 'export_bytes': 0, 'export_seconds': 0.0,
            'imports': 0, 'import_bytes': 0, 'import_seconds': 0.0,
            'import_rejects': 0, 'fallbacks_served': 0}
        # Incident bundles of this process carry this replica's /health,
        # through a weak reference: the registration must not keep a
        # stopped replica's weights and KV on the card.
        blackbox.set_process_label(f'llm_server:{self.role}')
        health_ref = weakref.WeakMethod(self.health_snapshot)
        blackbox.register_health_provider(
            lambda: None if health_ref() is None else health_ref()())
        # main() runs the warm-up before the listener binds and replaces
        # this report; the 'jit_warmup' crossing is marked only by a
        # warm-up that ran.
        self.warmup_report: Dict[str, Any] = warmup_lib.skipped(
            'SKYTPU_WARMUP disabled')
        self._warming = False

    # -- /health -------------------------------------------------------------

    def health(self) -> Tuple[int, Dict[str, Any]]:
        """(HTTP status, /health body): 503 while draining or warming up;
        with ``SKYTPU_PROFILE`` on, the first 200 marks ``ready`` and the
        device memory is sampled (at most every ``SKYTPU_PROFILE_MEM_S``
        seconds)."""
        if self.draining:
            # Readiness probes see 503: the LB stops routing here while
            # in-flight requests finish.
            return 503, {'status': 'draining', 'model': self.model_name}
        if self._warming:
            return 503, {'status': 'warming', 'model': self.model_name}
        if profiler.enabled():
            profiler.mark('ready')
            profiler.maybe_sample_device_memory(self.device)
        return 200, self.health_snapshot()

    def health_snapshot(self) -> Dict[str, Any]:
        """The /health body, under the JAX replica's keys, with the port's
        ``device`` and ``tp_backend`` (the collective backend of a
        ``--tp > 1`` replica: ``nccl``, or ``gloo`` where ranks share a
        card or run on the CPU; None at tp 1)."""
        body: Dict[str, Any] = {
            'status': 'draining' if self.draining else 'ok',
            'model': self.model_name,
            'device': str(self.device),
            'quantize': self.quantize, 'tp': self.tp,
            'tp_backend': None if self.mesh is None else self.mesh.backend,
            'kv_cache': self.kv_cache,
            'max_len': self.max_len,
            'draft_model': self.draft_model,
            'batches_served': self.batches_served,
            'max_batch_seen': self.max_batch_seen,
            # The pool role and the replica's handoff accounting, which
            # the controller mirrors into the skytpu_disagg_* gauges.
            'role': self.role,
            'disagg': {**self._disagg_snapshot(),
                       'parked': len(self._handoffs),
                       'staging': bool(self.staging_dir)}}
        # depth_total is the controller's routing and scaling signal: the
        # window FIFO, its overflow and the QoS queue.
        queue = {'pending': self._queue.qsize(),
                 'overflow': len(self._overflow)}
        queue['depth_total'] = queue['pending'] + queue['overflow']
        if self.qos is not None:
            qos_stats = self.qos.stats()
            body['qos'] = qos_stats
            queue['depth_total'] += qos_stats['queue_depth_total']
        body['queue'] = queue
        # The controller labels a boot warm or cold from compile_cache.
        body['compile_cache'] = _build.compile_cache()
        body['warmup'] = self.warmup_report
        # Tail-retention accounting: pending and retained depth and the
        # keeps by verdict.
        body['trace'] = trace_lib.tail_stats()
        if self._ttft_window:
            waits = sorted(round(t * 1000.0, 1) for t in self._ttft_window)
            body['ttft_ms'] = {'count': len(waits),
                               'p50': qos_lib.nearest_rank(waits, 50),
                               'p95': qos_lib.nearest_rank(waits, 95),
                               'p99': qos_lib.nearest_rank(waits, 99)}
        if profiler.enabled():
            body['profile'] = profiler.snapshot()
        if self.engine is not None:
            body['engine'] = self.engine.stats()
            # The prefix-affinity advert (paged, sharing on): top level,
            # as in the JAX replica, so routers need not know the
            # engine's stats shape.
            summary = self.engine.prefix_summary()
            if summary is not None:
                body['prefix_summary'] = summary
        if self.draft_params is not None:
            # The window path's speculative counters (the engine's are in
            # its stats), as the JAX replica reports them.
            spec = dict(self._spec_stats)
            spec['acceptance_rate'] = (
                round(spec['accepted'] / spec['proposals'], 4)
                if spec['proposals'] else None)
            body['speculative'] = spec
        return body

    def metrics(self, openmetrics: bool = False) -> bytes:
        """The ``/metrics`` body (``serve/metrics.py``); ``openmetrics``
        writes the exposition that carries exemplars."""
        return metrics_lib.render_serving(
            engine=self.engine.stats() if self.engine is not None else None,
            qos=self.qos.stats() if self.qos is not None else None,
            disagg=self._disagg_snapshot(), openmetrics=openmetrics)

    def _disagg_snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self.disagg_stats)

    def _disagg_add(self, **deltas) -> None:
        with self._lock:
            for key, d in deltas.items():
                self.disagg_stats[key] += d

    # -- batching worker -----------------------------------------------------

    def _collect(self) -> Optional[List[_Pending]]:
        """One batch: the first waiter plus whatever lands inside the
        window, capped at MAX_BATCH total rows. A request that would push
        the batch past the cap spills into the NEXT batch. None = stop."""
        if self._overflow:
            first = self._overflow.popleft()
        else:
            first = self._queue.get()
            if first is None:
                return None
        batch = [first]
        rows = len(first.rows)
        deadline = time.monotonic() + BATCH_WINDOW_S
        while rows < MAX_BATCH:
            if self._overflow:
                nxt = self._overflow.popleft()
            else:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:  # stop: finish this batch first
                    self._queue.put(None)
                    break
            if rows + len(nxt.rows) > MAX_BATCH:
                self._overflow.append(nxt)
                break
            batch.append(nxt)
            rows += len(nxt.rows)
        return batch

    def _split_fitting(self, group: List[_Pending]) -> List[List[_Pending]]:
        """Partition a group so each sub-batch satisfies
        longest_prompt + max(max_new) <= max_len: requests are validated
        one by one, but a batch combines one request's long prompt with
        ANOTHER's large max_new."""
        out: List[List[_Pending]] = []
        cur: List[_Pending] = []
        cur_longest = 0
        cur_max_new = 0
        for p in group:
            longest = max(len(r) for r in p.rows)
            if cur and (max(cur_longest, longest)
                        + max(cur_max_new, p.max_new)) > self.max_len:
                out.append(cur)
                cur, cur_longest, cur_max_new = [], 0, 0
            cur.append(p)
            cur_longest = max(cur_longest, longest)
            cur_max_new = max(cur_max_new, p.max_new)
        if cur:
            out.append(cur)
        return out

    def _run_group(self, group: List[_Pending]) -> None:
        """Execute one compatible group as padded generate() calls."""
        for sub in self._split_fitting(group):
            rows: List[List[int]] = []
            for p in sub:
                rows.extend(p.rows)
            padded, lens = gen_lib.pad_prompts(rows, device=self.device)
            max_new = max(p.max_new for p in sub)
            temperature = sub[0].temperature
            seed = sub[0].seed
            lens_host = [len(r) for r in rows]
            # With a draft: greedy batches of uniform prompt length
            # (generate_speculative takes no per-row lengths) whose window
            # overhang fits max_len; everything else takes generate().
            if (self.draft_params is not None and temperature == 0
                    and min(lens_host) == max(lens_host)
                    and max(lens_host) + max_new + self.spec_k + 1
                    <= self.max_len):
                out, spec = speculative.generate_speculative(
                    self.params, self.cfg, self.draft_params,
                    self.draft_cfg, padded, max_new, k=self.spec_k,
                    max_len=self.max_len,
                    kv_quantize=self.kv_cache == 'int8')
                with self._lock:
                    self._spec_stats['requests'] += len(sub)
                    for key in ('verifies', 'proposals', 'accepted'):
                        self._spec_stats[key] += spec[key]
                self._deliver(sub, out.tolist())
                continue
            generator = None
            if temperature > 0:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(
                    seed if seed is not None else secrets.randbits(31))
            out = gen_lib.generate(
                self.params, self.cfg, padded, max_new,
                temperature=temperature, generator=generator,
                max_len=self.max_len, prompt_lengths=lens,
                kv_quantize=self.kv_cache == 'int8',
                top_k=sub[0].top_k, top_p=sub[0].top_p).tolist()
            self.generate_calls.append((len(rows), max_new))
            self._deliver(sub, out)

    @staticmethod
    def _deliver(sub: List[_Pending], out: List[List[int]]) -> None:
        """Each request gets only the tokens it asked for, cut at its
        first stop id (inclusive). The batch decodes to the group max: no
        per-row early exit on this path."""
        i = 0
        for p in sub:
            n = len(p.rows)
            p.future.set_result(
                [gen_lib.truncate_at_stop(r[:p.max_new], p.eos)[0]
                 for r in out[i:i + n]])
            i += n

    def _worker_loop(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            groups: Dict[Any, List[_Pending]] = {}
            for p in batch:
                groups.setdefault(p.group_key, []).append(p)
            self.batches_served += 1
            self.max_batch_seen = max(
                self.max_batch_seen, sum(len(p.rows) for p in batch))
            for group in groups.values():
                try:
                    self._run_group(group)
                except Exception as e:  # noqa: BLE001 -- fail the waiters
                    for p in group:
                        if not p.future.done():
                            p.future.set_exception(e)

    def _ensure_worker(self) -> None:
        with self._lock:
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._worker_loop, name='llm-worker', daemon=True)
                self._worker.start()

    def stop(self, timeout: float = 60.0) -> None:
        """Finish queued window work, then end the worker thread and the
        engine's thread."""
        with self._lock:
            worker = self._worker
        if worker is not None and worker.is_alive():
            self._queue.put(None)
            worker.join(timeout)
        if self.engine is not None:
            self.engine.stop()

    def _busy(self) -> bool:
        """Requests in handlers, or held by the engine's queue or slots."""
        return self._inflight > 0 or (self.engine is not None
                                      and self.engine.busy())

    # -- /generate -----------------------------------------------------------

    def handle_generate(self, raw: bytes, write: Optional[Callable],
                        headers: Any,
                        reply_headers: Optional[Dict[str, str]] = None
                        ) -> Tuple[int, Optional[Dict[str, Any]]]:
        """The ``/generate`` route: parse the raw body and run ``generate``
        inside the request's ``serve.generate`` root span, joined to an
        incoming ``X-SkyTPU-Trace``. The root's retention verdict, final
        only once the root closes, goes into ``reply_headers`` as
        ``X-SkyTPU-Trace-Verdict`` unless the answer was streamed (its
        headers are gone by then)."""
        headers = headers or {}
        if headers.get('X-SkyTPU-Disagg-Fallback'):
            # The load balancer re-served this request whole after a
            # handoff failed: skytpu_disagg_fallback_total counts it.
            self._disagg_add(fallbacks_served=1)
        tctx = trace_lib.start_trace('serve.generate', headers=headers)
        if not tctx:  # untraced: no further tracing cost
            return self._parse_and_generate(raw, write, headers,
                                            reply_headers)
        with tctx:
            if headers.get(trace_lib.RESUME_HEADER):
                # The LB re-serves a request that died mid-stream here:
                # both legs stitch into one journey, kept as 'resumed'.
                trace_lib.set_attr(resume=True)
            status, payload = self._parse_and_generate(raw, write, headers,
                                                       reply_headers)
            trace_lib.set_attr(status=status)
        verdict = (tctx.record or {}).get('retained')
        if verdict and payload is not None and reply_headers is not None:
            reply_headers[trace_lib.VERDICT_HEADER] = verdict
        return status, payload

    def _parse_and_generate(self, raw: bytes, write: Optional[Callable],
                            headers: Any,
                            reply_headers: Optional[Dict[str, str]]
                            ) -> Tuple[int, Optional[Dict[str, Any]]]:
        try:
            body = json.loads(raw or b'null')
        except ValueError as e:
            # The JAX handler raises here (its trace carries the error
            # and the client gets a 500); the port answers 400 and keeps
            # the error on the trace, which retention keeps as 'error'.
            trace_lib.set_attr(error=type(e).__name__)
            return 400, {'error': 'request body must be JSON'}
        return self.generate(body, write, headers, reply_headers)

    def generate(self, body: Any, write: Optional[Callable] = None,
                 headers: Any = None,
                 reply_headers: Optional[Dict[str, str]] = None
                 ) -> Tuple[int, Optional[Dict[str, Any]]]:
        """Validate one request body and run it: (HTTP status, JSON). A
        streamed request (``"stream": true``) passes each NDJSON line to
        ``write`` (one dict per call, from this thread) as the engine
        emits it, and returns (200, None). ``headers`` are the request's
        (priority, tenant, bearer); a shed's ``Retry-After`` goes into
        ``reply_headers``. Draining still ACCEPTS work: the LB keeps
        routing here until its next probe sees the 503 readiness."""
        with self._lock:
            self._inflight += 1
        try:
            return self._generate_inner(body, write, headers or {},
                                        reply_headers)
        finally:
            with self._lock:
                self._inflight -= 1

    def _generate_inner(self, body: Any, write: Optional[Callable],
                        headers: Any,
                        reply_headers: Optional[Dict[str, str]]
                        ) -> Tuple[int, Optional[Dict[str, Any]]]:
        if not isinstance(body, dict):
            return 400, {'error': 'request body must be a JSON object'}
        tokens = body.get('tokens')
        if not tokens:
            return 400, {'error': 'tokens required'}
        try:
            max_new = int(body.get('max_new_tokens', 32))
            temperature = float(body.get('temperature', 0.0))
            top_k = int(body.get('top_k', 0))
            top_p = float(body.get('top_p', 1.0))
        except (TypeError, ValueError):
            return 400, {'error': 'max_new_tokens/temperature/top_k/top_p '
                                  'must be numeric'}
        if max_new < 1:
            return 400, {'error': 'max_new_tokens must be >= 1'}
        if top_k < 0 or not 0.0 < top_p <= 1.0:
            return 400, {'error': 'top_k must be >= 0 and top_p in (0, 1]'}
        eos = body.get('eos_token')
        if eos is not None:
            def _id(x):
                # JSON true/false pass isinstance(x, int): a silent stop
                # id 0/1 instead of a 400.
                if isinstance(x, bool):
                    raise ValueError(x)
                return int(x)
            try:
                eos = frozenset([_id(eos)] if isinstance(eos, int)
                                else (_id(t) for t in eos))
            except (TypeError, ValueError):
                return 400, {'error': 'eos_token must be an int or list of '
                                      'ints'}
        try:
            if isinstance(tokens[0], int):
                tokens = [tokens]
            rows = [[int(t) for t in row] for row in tokens]
        except (TypeError, ValueError, KeyError, IndexError):
            return 400, {'error': 'tokens must be rows of ints'}
        if not all(rows):
            return 400, {'error': 'empty token rows not allowed'}
        if any(t < 0 or t >= self.cfg.vocab_size for r in rows for t in r):
            return 400, {'error': f'token ids must be in [0, '
                                  f'{self.cfg.vocab_size})'}
        longest = max(len(r) for r in rows)
        if longest + max_new > self.max_len:
            return 400, {'error': f'prompt+max_new_tokens exceeds max_len '
                                  f'{self.max_len}'}
        seed = body.get('seed')
        seeded = temperature > 0 and seed is not None
        if seeded and self.tp > 1:
            # Seeded requests ride the window path, which cannot shard
            # the decode kernel (the JAX replica's words, for its kernel).
            return 400, {'error': 'seeded sampling is unavailable with '
                                  'SKYTPU_DECODE_KERNEL=pallas on a '
                                  '--tp > 1 replica'}
        stream = bool(body.get('stream'))
        if stream and (self.engine is None or seeded or write is None):
            return 400, {'error': 'stream requires the continuous engine '
                                  '(unseeded requests, '
                                  'SKYTPU_LLM_ENGINE!=off)'}
        trace_lib.set_attr(rows=len(rows), max_new=max_new, stream=stream)
        args = (rows, max_new, temperature, seed, top_k, top_p, eos)
        if self.qos is not None:
            return self._generate_qos(body, headers, reply_headers, write,
                                      args, seeded, stream)
        # A histogram label only: with QoS off the priority field is
        # advisory and never rejects.
        try:
            qos_class = qos_lib.classify(body, headers)
        except ValueError:
            qos_class = 'standard'
        if stream:
            self._generate_stream(write, *args, qos_class=qos_class)
            return 200, None
        if self.engine is not None and not seeded:
            return self._run_engine(*args, qos_class=qos_class)
        pending = _Pending(rows, max_new, temperature, seed,
                           top_k=top_k, top_p=top_p, eos=eos)
        self._ensure_worker()
        t_queued = time.time()
        self._queue.put(pending)
        return self._await_window(pending, t_queued, qos_class)

    def _run_engine(self, rows, max_new: int, temperature: float, seed,
                    top_k: int, top_p: float, eos, qos_class: str
                    ) -> Tuple[int, Dict[str, Any]]:
        """The continuous-engine path: one slot per row, its emission
        times recorded for the TTFT window and the histograms."""
        del seed  # unseeded by construction
        rec = _ChunkRecorder()
        # The engine's counters before: only a traced request's spans
        # read them.
        pipe0 = (self._pipeline_stats()
                 if trace_lib.current() is not None else None)
        futs = [self.engine.submit(r, max_new, temperature, top_k=top_k,
                                   top_p=top_p, eos=eos, on_tokens=rec.cb(i))
                for i, r in enumerate(rows)]
        try:
            out = [f.result() for f in futs]
        except Exception as e:  # noqa: BLE001 -- the engine failed
            return 500, {'error': f'{type(e).__name__}: {e}'}
        self._observe_serving(rec, qos_class, pipe0)
        return 200, {'tokens': out}

    def _await_window(self, pending: _Pending, t_start: float,
                      qos_class: str) -> Tuple[int, Dict[str, Any]]:
        try:
            out = pending.future.result()
        except Exception as e:  # noqa: BLE001 -- the batch failed
            return 500, {'error': f'{type(e).__name__}: {e}'}
        self._observe_window(t_start, out, qos_class)
        return 200, {'tokens': out}

    def _pipeline_stats(self) -> Optional[Dict[str, Any]]:
        """The engine's pipeline-overlap and block-share counters, read
        without its lock (plain attributes: trace annotations, not
        accounting). None for an engine without them."""
        eng = self.engine
        if eng is None or not hasattr(eng, 'host_overlap_ms'):
            return None
        return {
            'pipeline_depth': getattr(eng, 'pipeline_depth', 0),
            'dispatch_gap_ms': round(
                getattr(eng, '_gap_ms_total', 0.0)
                / max(getattr(eng, '_gap_count', 0), 1), 3),
            'host_overlap_ms': eng.host_overlap_ms,
            'bubble_ms': eng.bubble_ms,
            'share_hits': getattr(eng, 'share_hits', 0),
            'cow_forks': getattr(eng, 'cow_forks', 0),
            'prefill_tokens_saved': getattr(eng, 'prefill_tokens_saved', 0),
        }

    def _observe_serving(self, rec: _ChunkRecorder, qos_class: str,
                         pipe0: Optional[Dict[str, Any]],
                         parent: Optional[trace_lib.Span] = None) -> None:
        """TTFT (submit to the first emission) into the window and the
        histograms, then the decode phase and rate, as the JAX replica
        observes them; for a traced request the trace id is each
        observation's exemplar, and the ``serve.prefill``,
        ``serve.decode`` and ``serve.decode.chunk`` spans are built from
        the same timestamps. All after the fact: the tokens are already
        delivered."""
        events = sorted(rec.events)
        if not events:
            return
        anchor = parent if parent is not None else trace_lib.current()
        tid = anchor.trace_id if anchor is not None else None
        ttft = max(events[0][0] - rec.t0, 0.0)
        profiler.mark('first_token')
        self._ttft_window.append(ttft)
        metrics_lib.observe_serving('skytpu_serve_ttft_seconds', ttft,
                                    trace_id=tid, qos_class=qos_class)
        metrics_lib.observe_serving('skytpu_serve_phase_seconds', ttft,
                                    trace_id=tid, phase='prefill',
                                    qos_class=qos_class)
        first_t, last_t = events[0][0], events[-1][0]
        toks = sum(n for _, _, n in events)
        decode_s = max(last_t - first_t, 0.0)
        metrics_lib.observe_serving('skytpu_serve_phase_seconds', decode_s,
                                    trace_id=tid, phase='decode',
                                    qos_class=qos_class)
        # The first emission's tokens came out of the prefill window.
        decode_toks = toks - events[0][2]
        if decode_s > 0 and decode_toks > 0:
            metrics_lib.observe_serving('skytpu_serve_decode_tok_s',
                                        decode_toks / decode_s,
                                        trace_id=tid, qos_class=qos_class)
        if anchor is None:
            return
        if anchor.end is not None:
            # An already-closed parent (the stream span after a client
            # hung up): later emissions would outgrow it.
            events = [e for e in events if e[0] <= anchor.end]
            if not events:
                return
            first_t, last_t = events[0][0], events[-1][0]
            toks = sum(n for _, _, n in events)
        trace_lib.set_attr(qos_class=qos_class,
                           ttft_ms=round(ttft * 1000.0, 3), tokens=toks)
        # "prefill" is submit -> first emission: engine queue time, the
        # prefill and the first decode chunk.
        pipe1 = self._pipeline_stats()
        pattrs: Dict[str, Any] = {'tokens': events[0][2]}
        if pipe0 and pipe1:
            # Engine-wide deltas while this request was in flight
            # (co-resident requests share them: context, not
            # attribution).
            for k in ('share_hits', 'cow_forks', 'prefill_tokens_saved'):
                d = (pipe1.get(k) or 0) - (pipe0.get(k) or 0)
                if d:
                    pattrs[k] = d
        trace_lib.add_span('serve.prefill', rec.t0, first_t, parent=anchor,
                           **pattrs)
        dattrs: Dict[str, Any] = {'tokens': toks}
        if pipe0 and pipe1:
            for k in ('host_overlap_ms', 'bubble_ms'):
                dattrs[k] = round(
                    (pipe1.get(k) or 0.0) - (pipe0.get(k) or 0.0), 3)
            dattrs['dispatch_gap_ms'] = pipe1.get('dispatch_gap_ms')
            dattrs['pipeline_depth'] = pipe1.get('pipeline_depth')
        decode_span = trace_lib.add_span('serve.decode', first_t, last_t,
                                         parent=anchor, **dattrs)
        # One child per emission, capped: the tail folds into one.
        prev_t = first_t
        for t, ri, n in events[1:65]:
            trace_lib.add_span('serve.decode.chunk', prev_t, t,
                               parent=decode_span, row=ri, tokens=n)
            prev_t = t
        if len(events) > 65:
            trace_lib.add_span('serve.decode.chunk', prev_t, last_t,
                               parent=decode_span, aggregated=True,
                               tokens=sum(n for _, _, n in events[65:]))

    def _observe_window(self, t_start: float, out, qos_class: str) -> None:
        """The window path has no per-chunk signal: its TTFT is the whole
        call, and a traced request gets one ``serve.window`` span."""
        now = time.time()
        dur = max(now - t_start, 0.0)
        toks = sum(len(r) for r in out)
        cur = trace_lib.current()
        tid = cur.trace_id if cur is not None else None
        profiler.mark('first_token')
        self._ttft_window.append(dur)
        metrics_lib.observe_serving('skytpu_serve_ttft_seconds', dur,
                                    trace_id=tid, qos_class=qos_class)
        metrics_lib.observe_serving('skytpu_serve_phase_seconds', dur,
                                    trace_id=tid, phase='window',
                                    qos_class=qos_class)
        if dur > 0 and toks:
            metrics_lib.observe_serving('skytpu_serve_decode_tok_s',
                                        toks / dur, trace_id=tid,
                                        qos_class=qos_class)
        trace_lib.set_attr(qos_class=qos_class, tokens=toks)
        trace_lib.add_span('serve.window', t_start, now, tokens=toks)

    # -- QoS-gated dispatch (serve/qos.py; SKYTPU_QOS=1 / --qos on) ----------

    def _dispatch_window(self, pending: _Pending) -> None:
        """A window-path request enters the batching FIFO only at its
        grant: until then it waits (and expires, or is shed) in the
        weighted-fair queue."""
        self._ensure_worker()
        self._queue.put(pending)

    def _generate_qos(self, body, headers, reply_headers, write, args,
                      seeded: bool, stream: bool
                      ) -> Tuple[int, Optional[Dict[str, Any]]]:
        """classify -> admit (quota, overload) -> wait for the grant ->
        the ungated path -> release. An admitted request's output is the
        ungated path's; QoS decides only when work starts and which
        requests are refused (400 for an unknown class, 429 with
        ``Retry-After`` on a shed, 504 past the class's TTL)."""
        rows, max_new, temperature, seed, top_k, top_p, eos = args
        try:
            qos_class = qos_lib.classify(body, headers)
        except ValueError as e:
            return 400, {'error': str(e)}
        tenant = qos_lib.resolve_tenant(headers, body)
        trace_lib.set_attr(qos_class=qos_class, tenant=tenant)
        pending = on_dispatch = None
        if (self.engine is None or seeded) and not stream:
            pending = _Pending(rows, max_new, temperature, seed,
                               top_k=top_k, top_p=top_p, eos=eos)
            on_dispatch = (lambda p=pending: self._dispatch_window(p))
        t_submit = time.time()
        try:
            ticket = self.qos.submit(
                qos_class, tenant, cost=float(len(rows)),
                est_tokens=float(len(rows) * max_new),
                on_dispatch=on_dispatch)
            ticket.granted.result()
        except qos_lib.ShedError as e:
            if reply_headers is not None:
                reply_headers['Retry-After'] = str(e.retry_after_s)
            return 429, {'error': str(e), 'qos_class': qos_class,
                         'shed': True}
        except qos_lib.QueueTimeout as e:
            return 504, {'error': str(e), 'qos_class': qos_class}
        t_granted = time.time()
        cur = trace_lib.current()
        metrics_lib.observe_serving(
            'skytpu_serve_queue_wait_seconds', max(t_granted - t_submit, 0.0),
            trace_id=cur.trace_id if cur is not None else None,
            qos_class=qos_class)
        trace_lib.add_span('qos.queue_wait', t_submit, t_granted,
                           tenant=tenant)
        # What the quota refund counts at release: the tokens made on
        # success, 0 on a server-side failure (a full refund).
        generated = 0
        try:
            if stream:
                counter = [0]
                self._generate_stream(write, *args, token_count=counter,
                                      qos_class=qos_class)
                generated = counter[0]
                return 200, None
            if pending is None:
                status, reply = self._run_engine(*args, qos_class=qos_class)
            else:
                status, reply = self._await_window(pending, t_granted,
                                                   qos_class)
            if status == 200:
                generated = sum(len(o) for o in reply['tokens'])
            return status, reply
        finally:
            self.qos.release(ticket, generated_tokens=generated)

    def _generate_stream(self, write: Callable, rows, max_new: int,
                         temperature: float, seed, top_k: int, top_p: float,
                         eos, token_count: Optional[List[int]] = None,
                         qos_class: str = 'standard') -> None:
        """NDJSON streaming: ``{"row": i, "tokens": [...]}`` per emission
        (decode-chunk granularity), then ``{"done": true}``; a failure
        mid-stream is reported in-band as ``{"error": ...}``. The engine
        fires a request's callbacks before it resolves the future, so the
        future's done-callback (a ``None`` in the queue) comes after the
        last tokens of its row. ``token_count`` [n] counts the tokens
        written (the QoS quota's refund)."""
        del seed  # unseeded by construction
        lines: 'queue.Queue[Optional[Tuple[int, List[int]]]]' = \
            queue.Queue()
        rec = _ChunkRecorder()
        pipe0 = (self._pipeline_stats()
                 if trace_lib.current() is not None else None)
        futs = []
        for ri, row in enumerate(rows):
            fut = self.engine.submit(
                row, max_new, temperature,
                on_tokens=rec.cb(ri, lambda toks, ri=ri: lines.put(
                    (ri, toks))),
                top_k=top_k, top_p=top_p, eos=eos)
            fut.add_done_callback(lambda _: lines.put(None))
            futs.append(fut)
        try:
            open_rows = len(futs)
            while open_rows:
                item = lines.get()
                if item is None:
                    open_rows -= 1
                    continue
                if token_count is not None:
                    token_count[0] += len(item[1])
                write({'row': item[0], 'tokens': item[1]})
            for fut in futs:
                fut.result()  # raises if the engine failed the request
            write({'done': True})
        except Exception as e:  # noqa: BLE001 -- report in-band
            # The failure may BE the transport (client gone): the error
            # line is best-effort; the requests run on in the engine.
            with contextlib.suppress(Exception):
                write({'error': str(e)})
        # The stream span runs submit -> the last line; prefill and decode
        # nest inside it.
        stream_span = trace_lib.add_span('serve.stream', rec.t0, time.time())
        self._observe_serving(rec, qos_class, pipe0, parent=stream_span)

    # -- KV handoff (serve/disagg.py) ------------------------------------------

    def _traced(self, name: str, headers: Any, fn: Callable, *args):
        """``fn(*args)`` inside the root span ``name`` joined to an incoming
        ``X-SkyTPU-Trace``, counted in flight (the drain waits for it);
        its status goes on the root."""
        with self._lock:
            self._inflight += 1
        try:
            tctx = trace_lib.start_trace(name, headers=headers or {})
            if not tctx:
                return fn(*args)
            with tctx:
                status, payload = fn(*args)
                trace_lib.set_attr(status=status)
            return status, payload
        finally:
            with self._lock:
                self._inflight -= 1

    def _parse_handoff_request(self, body: Any) -> tuple:
        """An export's request: ONE row and the generation ask that rides
        the handoff. Returns (row, max_new, temperature, top_k, top_p,
        eos) or raises ValueError with a client-facing message."""
        if not isinstance(body, dict):
            raise ValueError('request body must be a JSON object')
        tokens = body.get('tokens')
        if not tokens:
            raise ValueError('tokens required')
        if isinstance(tokens[0], list):
            if len(tokens) != 1:
                raise ValueError('KV handoff carries ONE prompt per '
                                 'request (the handoff unit is a row)')
            tokens = tokens[0]
        row = [int(t) for t in tokens]
        if not row:
            raise ValueError('empty token rows not allowed')
        if any(t < 0 or t >= self.cfg.vocab_size for t in row):
            raise ValueError(f'token ids must be in [0, '
                             f'{self.cfg.vocab_size})')
        max_new = int(body.get('max_new_tokens', 32))
        if max_new < 1:
            raise ValueError('max_new_tokens must be >= 1')
        temperature = float(body.get('temperature', 0.0))
        top_k = int(body.get('top_k', 0))
        top_p = float(body.get('top_p', 1.0))
        if top_k < 0 or not 0.0 < top_p <= 1.0:
            raise ValueError('top_k must be >= 0 and top_p in (0, 1]')
        eos = body.get('eos_token')
        if eos is not None:
            eos = frozenset([int(eos)] if isinstance(eos, int)
                            else (int(t) for t in eos))
        if len(row) + max_new > self.max_len:
            raise ValueError(f'prompt+max_new_tokens exceeds max_len '
                             f'{self.max_len}')
        return row, max_new, temperature, top_k, top_p, eos

    def kv_export(self, raw: bytes, headers: Any = None,
                  reply_headers: Optional[Dict[str, str]] = None
                  ) -> Tuple[int, Dict[str, Any]]:
        """``POST /v1/kv/export``, the prefill role's admission: prefill
        the prompt, sample its first token and PARK the handoff. The
        answer carries the negotiation facts (sizes, the shareable chain)
        and a claim id for ``/v1/kv/fetch``, or, with a staging directory,
        the ref of the payload already written there."""
        if self.engine is None:
            return 400, {'error': 'KV export requires the continuous '
                                  'engine'}
        if self.tp > 1:
            return 400, {'error': TP_HANDOFF_ERROR}
        return self._traced('serve.kv_export', headers,
                            self._kv_export_inner, raw, headers or {},
                            reply_headers)

    def _kv_export_inner(self, raw: bytes, headers: Any,
                         reply_headers: Optional[Dict[str, str]]
                         ) -> Tuple[int, Dict[str, Any]]:
        try:
            body = json.loads(raw or b'null')
            args = self._parse_handoff_request(body)
        except (ValueError, TypeError) as e:
            return 400, {'error': str(e)}
        row, max_new = args[0], args[1]
        # QoS gates the EXPORT: on a disaggregated fleet the queue forms
        # here, and the whole generation budget is charged on this side
        # (the decode pool emits but never meters). A refusal refunds it.
        ticket = None
        if self.qos is not None:
            try:
                qos_class = qos_lib.classify(body, headers)
            except ValueError as e:
                return 400, {'error': str(e)}
            tenant = qos_lib.resolve_tenant(headers, body)
            try:
                ticket = self.qos.submit(
                    qos_class, tenant, cost=float(len(row)),
                    est_tokens=float(len(row) * max_new))
                ticket.granted.result()
            except qos_lib.ShedError as e:
                if reply_headers is not None:
                    reply_headers['Retry-After'] = str(e.retry_after_s)
                return 429, {'error': str(e), 'qos_class': qos_class,
                             'shed': True}
            except qos_lib.QueueTimeout as e:
                return 504, {'error': str(e), 'qos_class': qos_class}
        try:
            status, payload = self._kv_export_admitted(*args)
        except BaseException:
            if ticket is not None:
                self.qos.abandon(ticket)
            raise
        if ticket is not None:
            self.qos.release(ticket, generated_tokens=(
                max_new if status == 200 else 0))
        return status, payload

    def _kv_export_admitted(self, row, max_new, temperature, top_k, top_p,
                            eos) -> Tuple[int, Dict[str, Any]]:
        t0 = time.time()
        try:
            fut = self.engine.submit_prefill(
                row, max_new, temperature, top_k=top_k, top_p=top_p,
                eos=eos)
        except ValueError as e:  # MoE, draft and footprint refusals
            return 400, {'error': str(e)}
        try:
            handoff = fut.result()
        except Exception as e:  # noqa: BLE001 -- the engine failed it
            return 500, {'error': f'prefill export failed: {e}'}
        header = disagg_lib.build_header(handoff, model=self.model_name,
                                         kv_cache=self.kv_cache)
        nbytes = disagg_lib.payload_nbytes(header)
        resp = {'layout': handoff.layout, 'nbytes': nbytes,
                'prompt_len': handoff.prompt_len,
                'full_blocks': handoff.full_blocks,
                'block': handoff.block}
        if self.staging_dir:
            # Same-host path: the payload written once into the shared
            # directory; the decode replica reads it from there.
            ref, nbytes = disagg_lib.write_staging(self.staging_dir,
                                                   handoff, header)
            resp['staging_ref'] = ref
            resp['nbytes'] = nbytes
        else:
            resp['handoff'] = self._handoffs.put(handoff)
        self._disagg_add(exports=1, export_bytes=nbytes,
                         export_seconds=time.time() - t0)
        trace_lib.add_span('serve.prefill', t0, time.time(),
                           tokens=len(row))
        trace_lib.set_attr(nbytes=nbytes, prompt_len=len(row),
                           staged=bool(self.staging_dir))
        return 200, resp

    def kv_fetch(self, query: Dict[str, str]
                 ) -> Tuple[int, Any]:
        """``GET /v1/kv/fetch?handoff=&skip_blocks=``: claim a parked
        export's payload (bytes), without the plane records of its first
        ``skip_blocks`` full blocks, which the decode side holds. One-shot:
        the handoff is consumed whether serialization succeeds or not."""
        hid = query.get('handoff', '')
        handoff = self._handoffs.pop(hid)
        if handoff is None:
            return 404, {'error': f'unknown or expired handoff {hid!r}'}
        try:
            skip = int(query.get('skip_blocks', 0))
            header = disagg_lib.build_header(
                handoff, model=self.model_name, kv_cache=self.kv_cache,
                skip_blocks=skip)
        except ValueError as e:
            return 400, {'error': str(e)}
        return 200, disagg_lib.serialize_bytes(handoff, header)

    def kv_prepare(self, raw: bytes) -> Tuple[int, Dict[str, Any]]:
        """``POST /v1/kv/prepare``: how many leading FULL prompt blocks
        this replica's share trie holds, the prefix the transfer skips."""
        if self.engine is None:
            return 200, {'skip_blocks': 0}
        try:
            body = json.loads(raw or b'null')
            tokens = body.get('tokens') or []
            if tokens and isinstance(tokens[0], list):
                tokens = tokens[0]
            row = [int(t) for t in tokens]
        except (ValueError, TypeError, AttributeError):
            return 400, {'error': 'tokens must be ints'}
        return 200, {'skip_blocks': self.engine.probe_chain(row)}

    def kv_chains(self, raw: bytes) -> Tuple[int, Dict[str, Any]]:
        """``POST /v1/kv/chains``: the token rows this replica's trie (and
        tiers) still hold for advert chain digests, the remediation
        pre-warm's handshake."""
        if self.engine is None:
            return 200, {'chains': []}
        try:
            body = json.loads(raw or b'null')
            digests = [bytes.fromhex(str(h))
                       for h in (body.get('digests') or [])]
        except (ValueError, TypeError, AttributeError):
            return 400, {'error': 'digests must be hex strings'}
        return 200, {'chains': self.engine.resolve_chains(digests)}

    def kv_import(self, raw: bytes, headers: Any = None,
                  query: Optional[Dict[str, str]] = None,
                  write: Optional[Callable] = None
                  ) -> Tuple[int, Optional[Dict[str, Any]]]:
        """``POST /v1/kv/import``, the decode role's admission: validate
        the payload (checksums first: corrupt bytes never reach the
        device), install it and serve the generation. Buffered, or with
        ``?stream=1`` NDJSON lines passed to ``write`` as on /generate
        (then (200, None)). 400: the bytes are unusable; 409: well formed
        but not installable here, answered before any line."""
        if self.engine is None:
            return 400, {'error': 'KV import requires the continuous '
                                  'engine'}
        if self.tp > 1:
            return 400, {'error': TP_HANDOFF_ERROR}
        return self._traced('serve.kv_import', headers,
                            self._kv_import_inner, raw, headers or {},
                            query or {}, write)

    def _kv_import_inner(self, raw: bytes, headers: Any,
                         query: Dict[str, str], write: Optional[Callable]
                         ) -> Tuple[int, Optional[Dict[str, Any]]]:
        t0 = time.time()
        try:
            ctype = str(headers.get('Content-Type') or '')
            if ctype.startswith('application/json') \
                    and not raw.startswith(disagg_lib.MAGIC):
                # Same-host path: the body is a staging ref.
                body = json.loads(raw)
                data = disagg_lib.read_staging(
                    self.staging_dir, str(body.get('staging_ref') or ''))
            else:
                data = raw
            header, arrays = disagg_lib.parse(data)
            disagg_lib.check_compat(
                header, model=self.model_name, kv_cache=self.kv_cache,
                kv_layout=self.engine.kv_layout,
                kv_block=self.engine.kv_block, max_len=self.max_len)
            kwargs = disagg_lib.import_kwargs(header, arrays)
            vocab = self.cfg.vocab_size
            if any(t < 0 or t >= vocab
                   for t in kwargs['row'] + [kwargs['first']]):
                raise ValueError(f'token ids must be in [0, {vocab})')
        except disagg_lib.DisaggCompatError as e:
            self._disagg_add(import_rejects=1)
            return 409, {'error': str(e)}
        except (disagg_lib.DisaggError, ValueError, TypeError,
                KeyError, AttributeError) as e:
            self._disagg_add(import_rejects=1)
            return 400, {'error': str(e)}
        stream = query.get('stream') in ('1', 'true')
        rec = _ChunkRecorder()
        if stream and write is not None:
            return self._kv_import_stream(kwargs, len(data), rec, t0, write)
        try:
            fut = self.engine.submit_import(on_tokens=rec.cb(0), **kwargs)
        except ValueError as e:
            self._disagg_add(import_rejects=1)
            return 400, {'error': str(e)}
        try:
            tokens = fut.result()
        except Exception as e:  # noqa: BLE001 -- install failed: 409,
            # so that the load balancer re-serves colocated.
            self._disagg_add(import_rejects=1)
            return 409, {'error': f'import install failed: {e}'}
        self._note_import(len(data), t0, rec)
        return 200, {'tokens': [list(tokens)]}

    def _note_import(self, nbytes: int, t0: float,
                     rec: _ChunkRecorder) -> None:
        self._disagg_add(imports=1, import_bytes=nbytes,
                         import_seconds=time.time() - t0)
        self._observe_serving(rec, 'standard', None)

    def _kv_import_stream(self, kwargs: Dict[str, Any], nbytes: int,
                          rec: _ChunkRecorder, t0: float,
                          write: Callable
                          ) -> Tuple[int, Optional[Dict[str, Any]]]:
        """NDJSON for an imported request, the wire shape of a streamed
        /generate, so the load balancer pipes it to the client. A doomed
        import (evicted negotiated blocks) fails at admission, before
        its first emission: the first line waits for either, so it gets
        its 409 instead of a broken stream."""
        lines: 'queue.Queue[Optional[List[int]]]' = queue.Queue()
        try:
            fut = self.engine.submit_import(
                on_tokens=rec.cb(0, lines.put), **kwargs)
        except ValueError as e:
            self._disagg_add(import_rejects=1)
            return 400, {'error': str(e)}
        fut.add_done_callback(lambda _: lines.put(None))
        first = lines.get()
        if first is None:
            try:
                fut.result()
            except Exception as e:  # noqa: BLE001 -- no line sent yet
                self._disagg_add(import_rejects=1)
                return 409, {'error': f'import install failed: {e}'}
        try:
            while first is not None:
                write({'row': 0, 'tokens': first})
                first = lines.get()
            fut.result()
            write({'done': True})
            self._note_import(nbytes, t0, rec)
        except Exception as e:  # noqa: BLE001 -- mid-stream: in-band
            with contextlib.suppress(Exception):
                write({'error': str(e)})
        return 200, None

    # -- HTTP ------------------------------------------------------------------

    def make_httpd(self, host: str, port: int
                   ) -> http.server.ThreadingHTTPServer:
        """A bound (not yet serving) HTTP server for this replica;
        ``port`` 0 picks a free one (``httpd.server_address[1]``)."""
        httpd = _HttpServer((host, port), _Handler)
        httpd.llm = self
        return httpd

    def drain(self, httpd: http.server.ThreadingHTTPServer,
              timeout_s: float) -> None:
        """Graceful drain: /health turns 503 at once; the HTTP server
        shuts down once in-flight requests, and the engine's queued and
        slotted ones, finish (or at ``timeout_s``)."""
        self.draining = True

        def _finish():
            deadline = time.monotonic() + timeout_s
            while self._busy() and time.monotonic() < deadline:
                time.sleep(0.2)
            httpd.shutdown()

        threading.Thread(target=_finish, name='llm-drain',
                         daemon=True).start()


# The routes behind the scrape token: path -> (replica, query) -> JSON
# body (/metrics writes its exposition itself). /debug/alerts lists the
# history by default, as JAX's does.
_SCRAPE_ROUTES: Dict[str, Optional[Callable[['LlmServer', Dict[str, str]],
                                            Dict[str, Any]]]] = {
    '/metrics': None,
    '/debug/profile': lambda llm, q: profiler.debug_payload(q, llm.device),
    '/debug/traces': lambda llm, q: trace_lib.debug_payload(q),
    '/debug/blackbox': lambda llm, q: blackbox.debug_payload(q),
    '/debug/exemplars': lambda llm, q: metrics_lib.exemplars_payload(q),
    '/debug/alerts': lambda llm, q: slo.alerts_payload(
        {'history': '1', **q}),
}


_POST_ROUTES = ('/generate', '/v1/kv/export', '/v1/kv/prepare',
                '/v1/kv/chains', '/v1/kv/import')


class _HttpServer(http.server.ThreadingHTTPServer):
    daemon_threads = True
    # The listen backlog: a flood of connections (a QoS overload) must
    # reach admission, to be queued or shed, not be reset by the kernel
    # (the standard library's default is 5; aiohttp's, the JAX
    # replica's server, 128).
    request_queue_size = 128


class _Handler(http.server.BaseHTTPRequestHandler):
    server_version = 'skypilot-tpu-torch'

    def _reply(self, status: int, payload: Dict[str, Any],
               headers: Optional[Dict[str, str]] = None) -> None:
        data = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header('Content-Type', 'application/json')
        self.send_header('Content-Length', str(len(data)))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(data)

    def _send(self, status: int, data: bytes, content_type: str) -> None:
        self.send_response(status)
        self.send_header('Content-Type', content_type)
        self.send_header('Content-Length', str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802 -- http.server's name
        path, _, query = self.path.partition('?')
        llm = self.server.llm
        if path == '/health':
            self._reply(*llm.health())
            return
        if path == '/v1/kv/fetch':
            status, payload = llm.kv_fetch(
                dict(urllib.parse.parse_qsl(query)))
            if isinstance(payload, bytes):
                self._send(status, payload, 'application/octet-stream')
            else:
                self._reply(status, payload)
            return
        if path not in _SCRAPE_ROUTES:
            self._reply(404, {'error': f'no route {self.path}'})
        elif not users_lib.metrics_scrape_allowed(self.headers):
            # The scrape token gates /metrics and every /debug route
            # (SKYTPU_METRICS_TOKEN; unset = open), as on the JAX replica.
            self._reply(401, {'error': 'unauthorized'})
        elif path == '/metrics':
            # Content negotiation: an OpenMetrics scraper gets the
            # exposition that carries exemplars.
            om = 'openmetrics-text' in self.headers.get('Accept', '')
            self._send(200, llm.metrics(openmetrics=om),
                       metrics_lib.OPENMETRICS_CONTENT_TYPE if om
                       else metrics_lib.CONTENT_TYPE)
        else:
            self._reply(200, _SCRAPE_ROUTES[path](
                llm, dict(urllib.parse.parse_qsl(query))))

    def do_POST(self):  # noqa: N802 -- http.server's name
        path, _, query = self.path.partition('?')
        if path not in _POST_ROUTES:
            self._reply(404, {'error': f'no route {self.path}'})
            return
        if 'chunked' in self.headers.get('Transfer-Encoding', '').lower():
            # Bodies are read by Content-Length; a chunked one would be
            # misread, so it is refused (and the connection closed).
            self.close_connection = True
            self._reply(411, {'error': 'send the body with a '
                                       'Content-Length, not chunked'})
            return
        length = int(self.headers.get('Content-Length') or 0)
        raw = self.rfile.read(length)
        llm = self.server.llm
        if path == '/v1/kv/prepare':
            self._reply(*llm.kv_prepare(raw))
            return
        if path == '/v1/kv/chains':
            self._reply(*llm.kv_chains(raw))
            return
        streaming = []

        def write(line: Dict[str, Any]) -> None:
            # NDJSON in a body that ends when the connection closes
            # (HTTP/1.0: no length, no chunked encoding).
            if not streaming:
                self.send_response(200)
                self.send_header('Content-Type', 'application/x-ndjson')
                self.end_headers()
                streaming.append(True)
            self.wfile.write(json.dumps(line).encode() + b'\n')
            self.wfile.flush()

        reply_headers: Dict[str, str] = {}
        if path == '/v1/kv/export':
            status, payload = llm.kv_export(raw, self.headers,
                                            reply_headers)
        elif path == '/v1/kv/import':
            status, payload = llm.kv_import(
                raw, self.headers, dict(urllib.parse.parse_qsl(query)),
                write)
        else:
            status, payload = llm.handle_generate(raw, write, self.headers,
                                                  reply_headers)
        if payload is not None:
            self._reply(status, payload, reply_headers)

    def log_message(self, format, *args):  # noqa: A002 -- base signature
        del format, args  # quiet: one line per request is noise here


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='PyTorch/CUDA LLM replica (continuous engine, or '
                    'window batching)')
    parser.add_argument('--model', default='tiny',
                        choices=sorted(llama.PRESETS))
    parser.add_argument('--max-len', type=int, default=1024)
    parser.add_argument('--port', type=int,
                        default=int(os.environ.get('SKYTPU_REPLICA_PORT',
                                                   '8080')))
    parser.add_argument('--host', default='0.0.0.0')
    parser.add_argument('--quantize', default=None,
                        help="'int8' = weight-only quantized decode "
                             '(also via SKYTPU_LLM_QUANTIZE)')
    parser.add_argument('--kv-cache', default=None,
                        choices=('bf16', 'int8'),
                        help='int8 = quantized KV cache (also via '
                             'SKYTPU_LLM_KV_CACHE)')
    parser.add_argument('--engine', default=None,
                        help="'continuous' (default: the slot engine) or "
                             "'off' (window batching only; also via "
                             'SKYTPU_LLM_ENGINE)')
    parser.add_argument('--tp', type=int, default=None,
                        help='tensor-parallel degree: shard weights/KV '
                             'over N ranks, one process each; rank 0 '
                             'starts the others (also via SKYTPU_LLM_TP)')
    parser.add_argument('--kv-layout', default=None,
                        choices=('slot', 'paged'),
                        help="the engine's KV layout: 'paged' = block-table "
                             'KV pool, requests reserve only their actual '
                             'ask (also via SKYTPU_LLM_KV_LAYOUT)')
    parser.add_argument('--kv-blocks', type=int, default=None,
                        help='paged pool size in blocks incl. the junk '
                             'sink (also via SKYTPU_LLM_KV_BLOCKS; '
                             'default = full capacity; size it below '
                             'slots*max_len/block to save memory, and '
                             'admissions queue when it runs out)')
    parser.add_argument('--prefix-share', default=None,
                        choices=('on', 'off'),
                        help='copy-on-write block-level prefix sharing on '
                             'the paged pool (default on with --kv-layout '
                             'paged; also via SKYTPU_LLM_PREFIX_SHARE)')
    parser.add_argument('--prefix-cache', type=int, default=None,
                        help='device pool slots for popular prompt '
                             'prefixes (opt-in, default 0; costs N extra '
                             'max_len cache rows; also via '
                             'SKYTPU_LLM_PREFIX_CACHE)')
    parser.add_argument('--draft-model', default=None,
                        help='preset name of a small draft model for '
                             'speculative decoding (rides inside the '
                             'continuous engine, or the window path '
                             "with --engine off; dense targets only; "
                             'also via SKYTPU_LLM_DRAFT)')
    parser.add_argument('--pipeline', default=None,
                        choices=('on', 'off'),
                        help='pipelined decode dispatch: keep one chunk '
                             'in flight so host bookkeeping overlaps '
                             'device compute (default on; off = serial '
                             'engine; also via SKYTPU_LLM_PIPELINE)')
    parser.add_argument('--role', default=None,
                        choices=('colocated', 'prefill', 'decode'),
                        help='disaggregated-serving pool role (also via '
                             'SKYTPU_LLM_ROLE): prefill replicas retire '
                             'prompts at the first token and export the '
                             'KV (/v1/kv/export), decode replicas '
                             'import it and stream (/v1/kv/import); '
                             'every role still serves /generate for '
                             'the colocated fallback (default '
                             'colocated)')
    parser.add_argument('--qos', default=None, choices=('on', 'off'),
                        help='QoS admission control: priority classes '
                             '(interactive/standard/batch), per-tenant '
                             'token-bucket quotas, and overload '
                             'shedding with 429+Retry-After (default '
                             'off; also via SKYTPU_QOS; knobs: '
                             'SKYTPU_QOS_WEIGHTS/_MAX_QUEUE/_TTL_S/'
                             '_TENANT_RPS/_TENANT_TPS/_TENANT_LIMITS/'
                             '_MAX_INFLIGHT)')
    parser.add_argument('--device', default=None, choices=('cuda', 'cpu'),
                        help="where the replica computes (default cuda; "
                             "'cpu' runs it, and its --tp ranks over gloo, "
                             'on the CPU)')
    return parser


def check_knobs(model: str, engine: Optional[str],
                qos: Optional[str]) -> str:
    """The replica's cheap checks, before anything costs time: the model
    preset, the engine (returned, ``SKYTPU_LLM_ENGINE`` applied) and the
    QoS switch."""
    if model not in llama.PRESETS:
        raise ValueError(f'Unknown model {model!r}; one of '
                         f'{sorted(llama.PRESETS)}')
    engine = engine or os.environ.get('SKYTPU_LLM_ENGINE', 'continuous')
    if engine not in ('continuous', 'off'):
        raise ValueError(f"Unknown engine {engine!r}; 'continuous' "
                         "or 'off'")
    if qos not in (None, 'on', 'off'):
        raise ValueError(f"Unknown qos {qos!r}; 'on' or 'off'")
    return engine


def check_tp(tp: Optional[int], engine: str) -> int:
    """The tensor-parallel degree (``SKYTPU_LLM_TP`` applied). The decode
    kernel is always on here, and the window path cannot shard it: the
    JAX replica refuses ``--engine off`` with ``--tp > 1`` when its
    kernel is on, in these words."""
    tp = tp or int(os.environ.get('SKYTPU_LLM_TP', '1'))
    if tp < 1:
        raise ValueError(f'--tp must be >= 1, got {tp}')
    if tp > 1 and engine == 'off':
        raise ValueError('SKYTPU_DECODE_KERNEL=pallas with --tp > 1 '
                         'requires the continuous engine (the window path '
                         'cannot shard the kernel)')
    return tp


def server_from_args(args: argparse.Namespace, device=None) -> LlmServer:
    """The replica that ``build_parser``'s ``args`` describe; ``device``
    None = CUDA."""
    return LlmServer(args.model, max_len=args.max_len,
                     quantize=args.quantize, kv_cache=args.kv_cache,
                     engine=args.engine, kv_layout=args.kv_layout,
                     prefix_cache=args.prefix_cache, pipeline=args.pipeline,
                     kv_blocks=args.kv_blocks,
                     prefix_share=args.prefix_share,
                     draft_model=args.draft_model, qos=args.qos,
                     role=args.role, tp=args.tp, device=device)


def _rank_summary(server: LlmServer, gang) -> None:
    """The ``tp-rank-summary`` line a rank prints on its way out: its
    weights' bytes, the card's peak memory, its collectives and their
    host seconds, its decode-kernel calls and engine dispatches, and the
    digest of every token it sampled (equal on every rank)."""
    from skypilot_tpu_torch.ops import decode_attention
    cuda = server.device.type == 'cuda'
    line = 'tp-rank-summary ' + json.dumps({
        'rank': gang.rank, 'world': gang.world, 'backend': gang.backend,
        'staged': bool(server.mesh is not None
                       and server.mesh.stages_on_host),
        'param_bytes': profiler.tree_nbytes(server.params),
        'peak_bytes': (torch.cuda.max_memory_allocated(server.device)
                       if cuda else None),
        'collectives': collectives.STATS['calls'],
        'collective_s': round(collectives.STATS['seconds'], 6),
        'flash_decode_launches': decode_attention.flash_decode.launches,
        'dispatches': server.engine.dispatches,
        'broadcasts': server.engine.broadcasts,
        'sampled_digest': server.engine.sampled_digest})
    # One write: the ranks of a host share its stdout.
    sys.stdout.flush()
    os.write(sys.stdout.fileno(), (line + '\n').encode())


def main(argv: Optional[List[str]] = None, device=None) -> None:
    """Boot as the JAX replica does, marking the cold-start ledger, then
    serve until SIGTERM/SIGINT; ``device`` None = ``--device``, whose
    default is CUDA. A warm-up that reports an error fails the boot.
    SIGQUIT writes every thread's stack to the recorder's spool
    (``sigquit-<pid>-llm_server:<role>.txt``) without stopping the
    replica; SIGTERM records ``server.drain``, starts the drain, dumps a
    ``sigterm`` incident bundle, and exits 0 once the drain ends.

    With ``--tp N`` the ranks come up first (``serve/spmd.py``
    ``maybe_initialize``, under deferred shutdown signals); a follower
    rank builds the same replica and runs ``spmd.follower_main``, rank 0
    serves. A failed collective or a follower that exits early ends the
    process with status 1."""
    profiler.mark('imports')
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if device is None:
        device = args.device
    elif args.device is None:
        argv += ['--device', torch.device(device).type]  # for the followers
    engine = check_knobs(args.model, args.engine, args.qos)
    tp = check_tp(args.tp, engine)
    # SIGQUIT interrogation before the CUDA context: a replica hung in its
    # init is the one an operator most needs to `kill -QUIT`.
    role = args.role or os.environ.get('SKYTPU_LLM_ROLE') or 'colocated'
    blackbox.set_process_label(f'llm_server:{role}')
    blackbox.install_sigquit()
    _build.compile_cache()  # before any kernel library is built or loaded
    device_type = 'cuda' if device is None else torch.device(device).type
    # The ranks' bring-up is one guarded critical section: a drain landing
    # mid-init would wedge every rank of the gang.
    with cuda_client_guard.deferred_signals():
        gang = spmd.maybe_initialize(tp, device_type, argv)
    built: List[LlmServer] = []

    def _die(reason: str, fail_waiters: bool = True) -> None:
        print(f'llm_server: tp rank {gang.rank}: {reason}; exiting 1',
              file=sys.stderr, flush=True)
        if fail_waiters and built and built[0].engine is not None:
            # Off this thread: the engine thread may hold the engine's
            # lock inside a collective that never returns.
            threading.Thread(
                target=built[0].engine._fail_everything,  # noqa: SLF001
                args=(RuntimeError(reason),), daemon=True).start()
        for child in gang.children:
            child.kill()
        time.sleep(1.0)  # the failed waiters' answers go out
        os._exit(1)

    if gang is not None:
        gang.watch_children(_die)
        device = gang.device  # the rank's own card, by index
    dev = torch.device('cuda' if device is None else device)
    cuda_client_guard.init_backend_guarded(
        None if device is None else dev.type, index=dev.index or 0)
    server = server_from_args(args, device=device)
    built.append(server)
    if gang is not None:
        server.engine.on_fatal = lambda exc: _die(str(exc), False)
        if not gang.is_head:
            code = 1
            try:
                spmd.follower_main(server)
                code = 0
            finally:
                _rank_summary(server, gang)
                try:
                    gang.close(spmd.TIMEOUT_S)
                except collectives.CollectiveError as exc:
                    print(f'llm_server: tp rank {gang.rank}: {exc}',
                          file=sys.stderr, flush=True)
                    code = 1
                # The follower's process ends here, without the
                # interpreter's teardown of the rank's C++ state (the
                # process groups' threads), which can abort the exit.
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(code)
    if warmup_lib.enabled():
        server._warming = True  # noqa: SLF001 -- the replica's own boot
        try:
            server.warmup_report = warmup_lib.run(server)
        finally:
            server._warming = False  # noqa: SLF001
        if 'error' in server.warmup_report:
            server.stop()
            raise RuntimeError(f'warm-up failed: '
                               f'{server.warmup_report["error"]}')
    if server.world > 1:
        # The head's lockstep loop runs from startup: the followers wait
        # in the arrival collective, and a drain before the first request
        # must still reach them by the stop broadcast.
        server.engine.start()
    httpd = server.make_httpd(args.host, args.port)
    dumps: List[threading.Thread] = []

    def _graceful(*_):
        if server.draining:
            # Second signal: stop now.
            threading.Thread(target=httpd.shutdown, daemon=True).start()
            return
        blackbox.record('server.drain', inflight=int(server._inflight))  # noqa: SLF001
        server.drain(httpd, float(os.environ.get('SKYTPU_LLM_DRAIN_S',
                                                 '30')))
        # Preemption forensics off the signal handler (the dump writes a
        # file); the exit below waits for it.
        dump = threading.Thread(
            target=blackbox.dump, args=('sigterm',),
            kwargs={'reason': 'replica drain'}, name='llm-drain-dump',
            daemon=True)
        dump.start()
        dumps.append(dump)

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _graceful)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        server.stop()  # a gang's stop broadcast: every rank leaves
        for dump in dumps:
            dump.join(30)
        if gang is not None:
            _rank_summary(server, gang)
            codes = gang.close(spmd.TIMEOUT_S)
            if any(code != 0 for code in codes):
                raise SystemExit(f'tp followers exited with {codes}')


if __name__ == '__main__':
    main()
