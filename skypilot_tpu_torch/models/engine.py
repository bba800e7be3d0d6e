"""Continuous-batching decode engine, on one device.

Port of ``skypilot_tpu/models/engine.py``: one persistent decode batch of
``slots`` rows over a resident KV cache, in one of two layouts. The slot
layout (the default) holds ``max_len`` positions per slot; the paged
layout (``kv_layout='paged'``, ``SKYTPU_LLM_KV_LAYOUT``) shares
fixed-size blocks of one pool (``models/paged.py``). Arriving requests are prefilled in
power-of-two groups (prompts right-padded to power-of-two buckets), their
cache rows inserted into free slots, and K-step decode chunks advance all
slots together. Short requests drain and their slots refill while long
ones keep streaming.

* Chunks are pipelined one deep (``SKYTPU_LLM_PIPELINE``, default on):
  chunk N+1 is issued against the current slot snapshot before chunk N's
  tokens are read, so reading them, stop-token truncation, callbacks,
  slot freeing and admission all run while the device computes N+1.
  PyTorch's ``.cpu()`` would wait for the whole stream (N+1 included), so
  each chunk's tokens, and each prefill group's first tokens, are copied
  into pinned host memory without blocking when they are issued, and a
  CUDA event recorded after the copy is all that retirement waits for.
  Host arrays go to the device the same way (``_to_device``): a copy
  from pageable memory would wait for the chunk in flight.
* A free slot keeps decoding junk until it is reused (the batch shape is
  fixed). Its length grows without bound, so ``forward_cached`` is given
  ``active_rows``: as in the JAX package, the slots the host saw occupied
  when it issued the chunk, ANDed here with ``lengths < limit`` (an
  insert sets ``limit`` to prompt + max_new - 1), which turns off a
  request's row once it has every write it needs, in its last chunk and
  in the stale one the pipeline issues after it. Rows not active write at
  a clamped offset, as ``dynamic_update_slice`` does in the JAX package,
  and attend all M positions once their length passes M, so no junk row
  reaches the overflow assert (on the card an assert ends the CUDA
  context). MoE routing keeps JAX's mask: the snapshot alone
  (``route_rows``), so a request that finishes mid-chunk takes expert
  capacity for the rest of that chunk, as it does in the JAX engine.
* MoE models (``num_experts > 0``) follow the JAX engine's rules: expert
  capacity is per forward call and couples the rows of a batch, so the
  engine dispatches serially (pipeline depth 0) and quietly turns off
  chunked prefill, the prefix pool and block sharing (with it the KV
  tiers); a draft model is refused.
* Prefix pool (``prefix_slots`` > 0, ``SKYTPU_LLM_PREFIX_CACHE``): popular
  prompt prefixes keep their KV in ``prefix_slots`` extra max_len rows.
  A prefix is matched at power-of-two lengths (at least 16, strictly
  shorter than the prompt), stored on its second sighting, evicted LRU;
  a hit gathers the prefix rows and prefills only the suffix. Exact by
  causality: position i's KV depends on tokens <= i only.
* Chunked prefill (``prefill_chunk`` > 0, ``SKYTPU_LLM_PREFILL_CHUNK``):
  a prompt longer than ``prefill_chunk`` (at most two at a time) leaves
  the queue and advances one ``prefill_chunk``-token piece per loop turn
  into a scratch max_len row, between decode chunks; its first token is
  read through a pinned copy, and the finished row parks until a slot
  frees (free slots are held back for parked rows).
* Paged layout (``kv_blocks`` incl. the junk-sink block 0, default full
  capacity; ``kv_block`` positions per block, ``SKYTPU_LLM_KV_BLOCK``,
  default 16): a request reserves ``ceil((prompt + max_new) / block)``
  blocks at admission and QUEUES while the pool is short (backpressure);
  a chunked long prefill parks until its blocks are free. The device
  sees only block tables: the free list and per-slot block lists are
  host-side, and a freed slot's row writes the junk sink.
* Copy-on-write block sharing (``prefix_share``, paged only, default on,
  ``SKYTPU_LLM_PREFIX_SHARE``): full prompt blocks commit into a share
  trie (``paged.BlockTrie``); a request whose head matches points its
  table at the shared blocks, forks a partially matched tail block, and
  prefills only its tail directly over the pool (``_admit_shared``).
  Idle shared blocks are evicted LRU when the pool runs short.
* KV tiers (``kv_tiers``, on by default wherever sharing is,
  ``SKYTPU_KV_TIERS``): evicted chains demote to host memory and spill to
  ``SKYTPU_KV_SPILL_DIR`` (``serve/kv_tiers.py``) and promote back on a
  later match instead of being recomputed. The demote gather is issued
  on the stream before the evicted ids can be rewritten, and its planes
  reach the host through ``_HostCopy``; promotes go to the device
  through ``_to_device``.
* Speculative decoding (``draft_params``/``draft_cfg`` set, ``spec_k``
  proposals a round, ``SKYTPU_LLM_SPEC_K``, default 4): each engine turn
  is a draft-propose / target-verify ROUND over all slots
  (``_run_spec_round``). A draft KV cache (slot layout, also under a
  paged target) tracks the same committed stream: the draft prefills
  each prompt whole (chunked prompts chunk it too, ``d_consumed``), its
  k+1 greedy steps per round run K4, and the target scores the window
  [last, p1..pk] in ONE k+1-position forward (``all_logits``, the einsum
  path; paged: ``paged.forward_paged``). Acceptance is decided on the
  host per slot: greedy slots commit their accepted prefix plus the
  target's correction (the solo greedy stream, whatever the draft);
  sampled slots commit one token drawn from the verify's position-0
  logits with the engine's generator. Rollback rewrites both caches'
  ``lengths``. The round's proposals, target argmaxes and samples reach
  the host in one ``_HostCopy``. Rounds are serial (``pipeline_depth``
  0: acceptance shapes the next round), a request's write limit and its
  paged reservation cover the k+1 window overhang, and ``submit``
  reserves it below ``max_len``. Block sharing is off with a draft, as
  in the JAX engine.
* Every decode step runs the flash-decode kernel (``ops/decode_attention``,
  K4) in every layer, through ``forward_cached`` or, paged, through
  ``paged.forward_paged`` on the gathered ``[B, Hkv, max_len, D]`` view.
* Randomness comes from one ``torch.Generator`` on the engine's device,
  seeded from ``seed`` (the counterpart of ``jax.random.PRNGKey(seed)``);
  the draws differ from JAX's, the distribution does not. Per-request
  seeded determinism is impossible under continuous batching, so the
  replica routes seeded requests to the window path.

A chunk is K eager forward calls (JAX runs one compiled ``lax.scan``),
so the engine is bound by the host's time to issue them.

* Disaggregated prefill/decode (``role``, ``SKYTPU_LLM_ROLE``;
  ``serve/disagg.py`` is the wire format): ``submit_prefill`` admits an
  EXPORT, prefilled like any request (its reservation and write limit
  cover the prompt alone, so no decode chunk writes its row) and retired
  at its first token: the future resolves to a ``PrefillHandoff`` of host
  planes, gathered from the pool (paged, through ``paged.export_blocks``
  over a pow2-padded table) or from the prefill cache (slot layout), and
  read through ``_HostCopy``, the export's one designed wait, outside the
  lock. A loop turn whose slots hold only exports runs no decode chunk.
  ``submit_import`` validates the planes' shapes before it queues (a
  fault on the engine thread would fail every request in flight); the
  loop installs queued imports first (``_admit_imports``), FIFO, each
  when a slot and its full block reservation are free, the planes going
  to the device through ``_to_device``. Leading blocks the share trie
  already holds install as references (``probe_chain`` answers how many);
  a negotiated block that was evicted fails that import alone
  (``KVImportError``). Every role still serves ``submit``.

* Tensor parallelism (``mesh=``, one process per rank; ``serve/spmd.py``
  keeps the ranks in lockstep): the weights are this rank's slices
  (``quantization.shard_params``; a whole tree is sliced here, the
  draft's by the same rules), and the caches are born sharded on
  kv_heads in ``_init_device_state``, at construction and at every
  ``_fail_everything`` recovery: the slot layout's cache, the paged
  pool, the draft's cache and their int8 scales. The slot vectors, the
  block tables, the rewind state, the generator and all host accounting
  (free list, trie, LRU) stay whole on every rank, so every device
  decision stays a pure function of the request stream. Every forward
  passes the mesh (``forward_cached``, ``paged.forward_paged``, the MoE
  block; the decode kernel per head shard). The KV tiers live on the
  head alone, whole, in JAX's layout: a demote gathers every rank's
  heads of the evicted blocks there (``_heads_to_head``), a promote
  scatters them back (``_heads_from_head``), and each tier answer that
  shapes a device decision comes from the head (``_decide``). An export
  gathers its planes to the head likewise, and an import's planes go
  from the head to each rank when it admits.

* Data parallelism (a mesh whose ``data`` axis is larger than 1, beside
  ``tensor``; JAX's rule ``batch -> (data, fsdp)``): the weights are
  whole over ``data``. The slot layout's cache, the prefix pool and the
  draft's dense cache split their rows over the row axes (``data`` and
  ``fsdp``), each rank holding a contiguous block (``generate.data_rows``,
  ``data`` outermost) of its kv heads; the paged pool stays whole over
  them and split on kv_heads, as in JAX. Host accounting and the slot
  vectors (last tokens, write limits, the paged tables and lengths) stay
  whole on every rank. A decode chunk or a spec round runs the rank's
  block of the rows (the generator draws the whole batch's noise and
  keeps the block's, so it stays in step on every rank) and all-gathers
  the block's tokens over the row axes; a paged step also gathers each
  layer's new K/V, so that every rank writes every row. A prefill group,
  a chunked prefill and a share hit's tail run whole on every rank of
  the row axes (the mesh's ``whole_rows`` view), and each rank inserts
  only the rows of its block; a prefix-pool hit is summed over the row
  axes from the rank that holds it.

* The other axes JAX serves on (``generate.py``'s module docstring):
  ``fsdp`` also splits the weights on their ``embed`` dim, each layer
  gathered over ``fsdp`` just before it runs; ``pipe`` gives each rank
  its block of the layers and of every cache (``layers -> pipe``), the
  hidden state passing rank to rank in each forward; ``seq`` splits a
  prefill's positions (the caches and weights stay whole over it);
  ``expert`` gives each rank its experts. The KV tiers and the handoffs
  stay with the head: a plane bound there is gathered over ``tensor``
  (heads) and ``pipe`` (layers) by the ranks at index 0 of the other
  axes (``_REPLICA_AXES``), and what the head scatters back (a promote,
  an import) is then broadcast over each of those axes in turn.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import os
import threading
import time
import zlib
from typing import List, Optional

import numpy as np
import torch

from skypilot_tpu_torch.ckpt import manifest as manifest_lib
from skypilot_tpu_torch.models import generate as gen_lib
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import paged as paged_lib
from skypilot_tpu_torch.models import sampling
# The flight recorder (observability/blackbox.py): record() is one deque
# append of host values, so the engine's edges (admit, dispatch, retire,
# bubble, fail) never read a device tensor.
from skypilot_tpu_torch.observability import blackbox
from skypilot_tpu_torch.observability import profiler
from skypilot_tpu_torch.observability import trace as trace_lib
from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.utils import prefix_affinity as affinity_lib
from skypilot_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class _Request:
    """Host-side bookkeeping for one prompt row occupying (at most) one
    slot. ``tokens`` accumulates emitted ids; the future resolves with
    the full list once ``max_new`` have been produced. ``on_tokens``
    (optional) is called from the ENGINE thread with each newly emitted
    batch of ids as it lands (streaming); it must not block."""
    row: List[int]
    max_new: int
    temperature: float
    future: concurrent.futures.Future
    tokens: List[int] = dataclasses.field(default_factory=list)
    on_tokens: Optional[object] = None
    top_k: int = 0        # 0 = off
    top_p: float = 1.0    # >= 1 = off
    eos: Optional[frozenset] = None  # stop ids; None = run to max_new
    # Disaggregated serving (serve/disagg.py): an EXPORT is the prefill
    # role's admission; it prefills normally, then retires at its first
    # token, the future resolving to a PrefillHandoff. ``export_src``
    # keeps the slot layout's source (prefill cache, row index) from the
    # prefill to the drain that gathers it; paged exports gather from
    # the pool instead.
    export: bool = False
    export_src: Optional[tuple] = None
    # Times this request parked on a background spill fetch (KV tiers);
    # after two it is admitted as a plain miss.
    tier_parks: int = 0
    # The trace span current where it was submitted (the replica's
    # ``serve.generate``): the KV tier spans of its admission parent to
    # it from the engine and tier threads, which have no current span.
    trace_parent: Optional[object] = None


class _HostCopy:
    """A device tensor on its way to the host: on CUDA, a non-blocking
    copy into pinned memory and an event recorded after it, so reading
    waits for this copy and not for work issued later on the stream. On
    the CPU, the tensor itself. numpy has no bfloat16 here, so a bf16
    tensor reads as its uint16 storage words."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        self._words = t.dtype == torch.bfloat16
        if self._words:
            t = t.view(torch.int16)
        if t.device.type == 'cuda':
            self._host = torch.empty(t.shape, dtype=t.dtype,
                                     pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        out = self._host.numpy()
        return out.view(np.uint16) if self._words else out


@dataclasses.dataclass
class _Prefilling:
    """An in-flight incremental (chunked) long prefill. ``first`` is set
    once the final chunk has sampled the request's first token; the
    entry may then PARK awaiting a free slot."""
    req: _Request
    cache: Optional[gen_lib.KVCache] = None  # scratch max_len row
    consumed: int = 0                        # prompt tokens prefilled
    first: Optional[torch.Tensor] = None
    first_host: Optional[int] = None
    # Spec mode: the draft's own scratch row and progress (it starts at 0
    # even when the target's head came from a prefix hit).
    d_cache: Optional[gen_lib.KVCache] = None
    d_consumed: int = 0

    @property
    def parked(self) -> bool:
        return self.first is not None


@dataclasses.dataclass
class _Inflight:
    """One issued-but-unread decode chunk: the slot snapshot it was issued
    against plus its tokens on their way to the host. Retirement emits
    against the snapshot: a slot freed (or reused) after dispatch fails
    the ``_slot_req[i] is req`` identity check and its tokens are dropped
    as junk."""
    reqs: List[Optional[_Request]]
    toks: _HostCopy
    steps: int


@dataclasses.dataclass
class PrefillHandoff:
    """One prompt's computed KV state, host-side, ready to transfer to a
    decode-role engine (the handoff unit of ``serve/disagg.py``).

    Paged layout: ``k``/``v`` are [L, nb, Hkv, P, D] in pool block layout
    (block i covers prompt positions [i*P, (i+1)*P)); positions of the
    last block past ``prompt_len`` carry junk that is never attended. The
    full-block chain (the trie keys) follows from ``row`` and ``block``,
    which is what lets shared prefixes transfer as references. Slot
    layout: ``k``/``v`` are [L, 1, Hkv, prompt_len, D]. Scale planes
    (``k_s``/``v_s``, float32) are present iff the KV cache is int8. A
    bf16 plane is a ``ckpt.manifest.RawArray`` of its uint16 words."""
    row: List[int]
    first: int
    max_new: int
    temperature: float
    top_k: int
    top_p: float
    eos: Optional[frozenset]
    layout: str
    prompt_len: int
    block: int = 0
    n_blocks: int = 0
    k: Optional[object] = None
    v: Optional[object] = None
    k_s: Optional[np.ndarray] = None
    v_s: Optional[np.ndarray] = None

    @property
    def full_blocks(self) -> int:
        """Blocks fully covered by the prompt: the shareable chain."""
        return self.prompt_len // self.block if self.block else 0


@dataclasses.dataclass
class _ImportEntry:
    """A decode-role admission waiting for a slot and blocks: the
    imported prompt planes plus the request state (its first token was
    sampled by the prefill side). ``block_start`` is the index of the
    first prompt block present in the planes; earlier blocks were
    negotiated away as local trie references."""
    req: _Request
    first: int
    layout: str
    block_start: int = 0
    k: Optional[object] = None
    v: Optional[object] = None
    k_s: Optional[np.ndarray] = None
    v_s: Optional[np.ndarray] = None


class KVImportError(RuntimeError):
    """A transferred handoff could not be installed (blocks negotiated
    away as shared references were evicted between the prepare round
    trip and the import). The replica answers 409 and the load balancer
    falls back to colocated serving."""


def _chain_row(node) -> List[int]:
    """The token row of a trie node's whole chain, root to node."""
    parts = []
    while node is not None:
        parts.append(node.key)
        node = node.parent
    return [t for key in reversed(parts) for t in key]


def _plane_words(arr):
    """(host array, torch dtype for ``_to_device``) of a handoff plane: a
    bf16 ``RawArray`` gives its uint16 words and ``torch.bfloat16``."""
    if isinstance(arr, manifest_lib.RawArray):
        if arr.dtype != 'bfloat16':
            raise ValueError(f'handoff plane dtype {arr.dtype!r} has no '
                             'torch counterpart')
        return arr.words, torch.bfloat16
    return np.asarray(arr), None


def _host_plane(copy: '_HostCopy', dtype: torch.dtype):
    """A plane read off the device: bf16 as a ``RawArray`` of its words
    under JAX's dtype name, any other type as the numpy array."""
    host = copy.numpy()
    if dtype == torch.bfloat16:
        return manifest_lib.RawArray(host, 'bfloat16')
    return host


# Idle engine pacing: the loop parks in _wake.wait(_IDLE_WAIT_S) when no
# slot is active; submit() sets the event, so the wait length only bounds
# how often an IDLE replica spins, not admission latency.
_IDLE_WAIT_S = 1.0


def prompt_bucket(n: int, lo: int = 16) -> int:
    """Smallest power-of-two >= n (>= lo): the padded prefill width."""
    b = lo
    while b < n:
        b *= 2
    return b


def _to_device(a: np.ndarray, device: torch.device,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A host array as a tensor on ``device``, issued without waiting for
    the device (pinned staging, ``non_blocking``). ``dtype`` bfloat16
    takes ``a`` as uint16 storage words (``_HostCopy``'s bf16 form)."""
    a = np.ascontiguousarray(a)
    words = dtype == torch.bfloat16
    t = torch.from_numpy(a.view(np.int16) if words else a)
    if device.type == 'cuda':
        t = t.pin_memory().to(device, non_blocking=True)
    return t.view(torch.bfloat16) if words else t


def _host_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a pool plane on the host (bf16: uint16 words)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    return torch.empty((), dtype=dtype).numpy().dtype


def _insert_impl(cache: gen_lib.KVCache, last: torch.Tensor,
                 limit: torch.Tensor, cache_n: gen_lib.KVCache,
                 firsts: torch.Tensor, limits_n: torch.Tensor,
                 slots: torch.Tensor, owned=None) -> None:
    """Write a prefilled N-row cache into engine slots ``slots`` [N], in
    place: one indexed write per cache tensor. The prefill cache is only
    ``width`` (prompt bucket) positions long and only [0, width) of each
    slot's row is written; what the previous occupant left beyond that is
    never attended (valid-length masking) and later decode writes
    overwrite it. Sets each slot's length, last token and write limit
    (``owned``: see ``_insert_cache_impl``)."""
    _insert_cache_impl(cache, cache_n, slots, owned)
    last[slots] = firsts
    limit[slots] = limits_n


def _insert_cache_impl(cache: gen_lib.KVCache, cache_n: gen_lib.KVCache,
                       slots: torch.Tensor, owned=None) -> None:
    """The cache half of ``_insert_impl``, alone for the DRAFT cache (spec
    mode), whose committed stream and write limit are the target's.
    ``owned`` (the cache holds a block of the slots): (this block's rows
    to write, the rows of ``cache_n`` they take), or None for every
    row."""
    if owned is not None:
        slots, pick = owned
        cache_n = gen_lib.KVCache(
            k=cache_n.k[:, pick], v=cache_n.v[:, pick],
            lengths=cache_n.lengths[pick],
            k_s=None if cache_n.k_s is None else cache_n.k_s[:, pick],
            v_s=None if cache_n.v_s is None else cache_n.v_s[:, pick])
    width = cache_n.k.shape[3]
    cache.k[:, slots, :, :width] = cache_n.k
    cache.v[:, slots, :, :width] = cache_n.v
    if cache.quantized:
        cache.k_s[:, slots, :, :width] = cache_n.k_s
        cache.v_s[:, slots, :, :width] = cache_n.v_s
    cache.lengths[slots] = cache_n.lengths


def _gather_prefix_impl(pool: gen_lib.KVCache, idx: torch.Tensor,
                        lengths: torch.Tensor, width: int,
                        mine: Optional[torch.Tensor] = None,
                        mesh=None) -> gen_lib.KVCache:
    """A new prefill cache whose row i holds pool row idx[i]'s first
    ``width`` positions, with ``lengths[i]`` valid prefix tokens (0 = a
    miss: the zeros gathered from pool row 0 are never attended, and the
    suffix write starts at 0). One indexed copy per cache tensor.
    ``mine`` [N] bool (the pool holds a block of its rows over ``mesh``'s
    row axes, ``data`` and ``fsdp``; ``idx`` are rows of the block): rows
    held elsewhere are zeros here, and the sum over the row axes gives
    every rank every row (one nonzero term each: exact)."""

    def take(arr):
        out = arr[:, idx, :, :width]
        if mine is None:
            return out
        keep = mine.view(1, -1, *(1,) * (out.dim() - 2))
        return gen_lib.sum_rows(torch.where(keep, out,
                                            torch.zeros_like(out)), mesh)
    ks = vs = None
    if pool.quantized:
        ks, vs = take(pool.k_s), take(pool.v_s)
    return gen_lib.KVCache(k=take(pool.k), v=take(pool.v),
                           lengths=lengths, k_s=ks, v_s=vs)


def _store_prefix_impl(pool: gen_lib.KVCache, cache_n: gen_lib.KVCache,
                       row: int, slot: int, p: int) -> None:
    """Copy the first ``p`` positions of prefill row ``row`` into pool
    row ``slot``, in place. Causality makes this exact: a longer prompt's
    first p positions ARE the prefix's KV (int8 codes and scales are per
    position, so they copy verbatim)."""
    pool.k[:, slot, :, :p] = cache_n.k[:, row, :, :p]
    pool.v[:, slot, :, :p] = cache_n.v[:, row, :, :p]
    if pool.quantized:
        pool.k_s[:, slot, :, :p] = cache_n.k_s[:, row, :, :p]
        pool.v_s[:, slot, :, :p] = cache_n.v_s[:, row, :, :p]


def _filters_or_none(top_ks: np.ndarray, top_ps: np.ndarray):
    """None when every row's filters are off: ``filter_logits`` then
    skips the full-vocab sort on the decode loop."""
    if bool(top_ks.any()) or bool((top_ps < 1.0).any()):
        return top_ks, top_ps
    return None, None


def _chunk_impl(cfg: llama.LlamaConfig, k_steps: int, params,
                cache: gen_lib.KVCache, last: torch.Tensor,
                limit: torch.Tensor, occupied: torch.Tensor,
                temps: Optional[torch.Tensor],
                top_ks: Optional[torch.Tensor],
                top_ps: Optional[torch.Tensor],
                generator: Optional[torch.Generator], mesh=None):
    """K decode steps over ALL slots: returns (cache, last, toks [K, B]).
    ``occupied`` [B] is the host's slot snapshot at dispatch (JAX's
    ``active``). Per-slot sampling params ride as data (temps 0 = greedy,
    top_ks 0 / top_ps 1 = filters off); ``generator`` None = every row
    greedy. Where ``mesh``'s row axes (``data``, ``fsdp``) split the
    slots, the cache is this rank's block of them: the chunk decodes the
    block and gathers its tokens over those axes, so ``last`` and
    ``toks`` are whole."""
    b = last.shape[0]
    rows = gen_lib.data_rows(mesh, b)
    last, limit, occupied, temps, top_ks, top_ps = _block(
        rows, last, limit, occupied, temps, top_ks, top_ps)
    row_lens = torch.ones((last.shape[0],), dtype=torch.int32,
                          device=last.device)
    toks = []
    for _ in range(k_steps):
        active = occupied & (cache.lengths < limit)
        logits, cache = gen_lib.forward_cached(params, last[:, None], cache,
                                               cfg, row_lens, active,
                                               route_rows=occupied,
                                               mesh=mesh)
        last = sampling.sample(logits, temps, generator, top_ks, top_ps,
                               rows, b)
        toks.append(last)
    return (cache,) + _gather_rows(torch.stack(toks), rows, mesh)


def _block(rows: Optional[slice], *vectors):
    """``vectors`` [B] (None passes) cut to this rank's block of the
    rows, or whole where ``rows`` is None."""
    if rows is None:
        return vectors
    return tuple(None if v is None else v[rows] for v in vectors)


def _gather_rows(toks: torch.Tensor, rows: Optional[slice], mesh) -> tuple:
    """(last, toks): a chunk's tokens [K, block] gathered whole over the
    row axes, and the last step's [B] (a copy: the engine writes into
    it)."""
    if rows is not None:
        toks = gen_lib.gather_rows(toks, mesh, dim=1)
    return toks[-1].clone(), toks


def _paged_insert_impl(pool: paged_lib.PagedKVCache, last: torch.Tensor,
                       limit: torch.Tensor, cache_n: gen_lib.KVCache,
                       firsts: torch.Tensor, limits_n: torch.Tensor,
                       tables_new: torch.Tensor,
                       slots: torch.Tensor) -> None:
    """``_insert_impl`` for the paged layout: scatter the prefilled rows
    into the blocks of ``tables_new`` [N, MB] and install the tables,
    lengths, last tokens and write limits at ``slots``, in place."""
    paged_lib._insert_impl(pool, cache_n, tables_new, slots)  # noqa: SLF001
    last[slots] = firsts
    limit[slots] = limits_n


def _paged_chunk_impl(cfg: llama.LlamaConfig, k_steps: int, params,
                      cache: paged_lib.PagedKVCache, last: torch.Tensor,
                      limit: torch.Tensor, occupied: torch.Tensor,
                      temps: Optional[torch.Tensor],
                      top_ks: Optional[torch.Tensor],
                      top_ps: Optional[torch.Tensor],
                      generator: Optional[torch.Generator], mesh=None):
    """K decode steps over the PAGED pool: the twin of ``_chunk_impl``
    with ``paged.forward_paged`` in place of ``forward_cached``. Rows not
    active (``occupied`` ANDed with ``lengths < limit`` at every step)
    write the junk sink. An MoE model's rows are active while
    ``occupied``, as in the JAX engine: a row that finishes mid-chunk
    routes its junk for the rest of the chunk, so it must also write and
    read that junk where JAX's does, in its own blocks. MoE dispatches
    serially, so the chunk is read before those blocks are released.
    Where ``mesh``'s row axes split the slots, the rank decodes its block
    of them over the whole pool (``paged.forward_paged``) and gathers the
    block's tokens over those axes."""
    b = last.shape[0]
    rows = gen_lib.data_rows(mesh, b)
    mine, temps, top_ks, top_ps = _block(rows, last, temps, top_ks, top_ps)
    toks = []
    for _ in range(k_steps):
        active = (occupied if cfg.num_experts > 0
                  else occupied & (cache.lengths < limit))
        logits, cache = paged_lib.forward_paged(params, mine[:, None],
                                                cache, cfg, active,
                                                mesh=mesh)
        mine = sampling.sample(logits, temps, generator, top_ks, top_ps,
                               rows, b)
        toks.append(mine)
    return (cache,) + _gather_rows(torch.stack(toks), rows, mesh)


def _rewind_impl(cache, adj: torch.Tensor) -> None:
    """Per-row rollback, in place: positions past a row's valid length
    are never attended and get overwritten, so rejecting proposals is a
    lengths subtraction (the dense cache and the paged pool alike)."""
    cache.lengths.sub_(adj)


def _spec_impl(t_cfg: llama.LlamaConfig, d_cfg: llama.LlamaConfig, k: int,
               t_params, d_params, t_cache, d_cache: gen_lib.KVCache,
               last: torch.Tensor, limit: torch.Tensor,
               occupied: torch.Tensor, temps: Optional[torch.Tensor],
               top_ks: Optional[torch.Tensor],
               top_ps: Optional[torch.Tensor],
               generator: Optional[torch.Generator], mesh=None):
    """One speculative round over ALL slots. Returns (t_cache, d_cache,
    out [B, 2k+3] int32 = props [B, k+1] | tgt [B, k+1] | samp [B]) with
    BOTH caches advanced k+1 positions (the host rolls back per row).

    The draft runs k+1 greedy steps (the surplus step writes p_k's KV, as
    in ``models/speculative.py``); the target scores the window [last,
    p1..pk] in one forward with per-position logits; ``samp`` is drawn
    from the verify's position-0 logits with each row's sampling params,
    so for a sampled row a round is one plain decode step. A row is
    active while ``occupied`` and its length is below ``limit``. Under a
    tensor ``mesh`` both models' forwards run sharded (the draft's k+1
    steps run the decode kernel on its head shard) and every rank holds
    the whole logits, so the proposals and the verdicts agree. Where its
    row axes split the slots, the round runs this rank's block of them
    (the draft's cache and a dense target's hold the block; a paged
    target's pool is whole) and ``out`` is gathered over those axes."""
    b = last.shape[0]
    rows = gen_lib.data_rows(mesh, b)
    paged = not isinstance(t_cache, gen_lib.KVCache)
    # A paged target's pool, tables and lengths are whole.
    t_active = occupied & (t_cache.lengths < limit) if paged else None
    last, limit, occupied, temps, top_ks, top_ps = _block(
        rows, last, limit, occupied, temps, top_ks, top_ps)
    ones = torch.ones((last.shape[0],), dtype=torch.int32,
                      device=last.device)
    props = []
    tok = last
    for _ in range(k + 1):
        active = occupied & (d_cache.lengths < limit)
        logits, d_cache = gen_lib.forward_cached(d_params, tok[:, None],
                                                 d_cache, d_cfg, ones, active,
                                                 mesh=mesh)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        props.append(tok)
    props = torch.stack(props, dim=1)  # [B, k+1]
    window = torch.cat([last[:, None], props[:, :k]], dim=1)
    if not paged:
        active = occupied & (t_cache.lengths < limit)
        logits_all, t_cache = gen_lib.forward_cached(
            t_params, window, t_cache, t_cfg, (k + 1) * ones, active,
            all_logits=True, mesh=mesh)
    else:  # paged target: multi-position block writes, lengths rewind
        logits_all, t_cache = paged_lib.forward_paged(
            t_params, window, t_cache, t_cfg, t_active, all_logits=True,
            mesh=mesh)
    tgt = torch.argmax(logits_all, dim=-1).to(torch.int32)  # [B, k+1]
    samp = sampling.sample(logits_all[:, 0], temps, generator, top_ks,
                           top_ps, rows, b)
    out = torch.cat([props, tgt, samp.to(torch.int32)[:, None]], dim=1)
    if rows is not None:
        out = gen_lib.gather_rows(out, mesh, dim=0)
    return t_cache, d_cache, out


_insert = profiler.profiled('engine.insert', _insert_impl)
_insert_cache = profiler.profiled('engine.insert_cache', _insert_cache_impl)
_rewind = profiler.profiled('engine.rewind', _rewind_impl)
_spec = profiler.profiled('engine.spec_round', _spec_impl)
_chunk = profiler.profiled('engine.chunk', _chunk_impl)
_paged_insert = profiler.profiled('paged.insert', _paged_insert_impl)
_paged_chunk = profiler.profiled('engine.paged_chunk', _paged_chunk_impl)
_prefill_shared = profiler.profiled('paged.prefill_shared',
                                    paged_lib._prefill_shared_impl)  # noqa: SLF001
_fork_block = profiler.profiled('paged.fork_block',
                                paged_lib._fork_block_impl)  # noqa: SLF001
_gather_blocks = profiler.profiled('paged.gather_blocks',
                                   paged_lib._gather_blocks_impl)  # noqa: SLF001
_export_blocks = profiler.profiled('paged.export_blocks',
                                   paged_lib._export_blocks_impl)  # noqa: SLF001
_import_blocks = profiler.profiled('paged.import_blocks',
                                   paged_lib._import_blocks_impl)  # noqa: SLF001
_prefill = gen_lib.jit_prefill  # JAX's engine calls generate.prefill too
_sample = profiler.profiled('engine.sample', sampling.sample)
_gather_prefix = profiler.profiled('engine.gather_prefix',
                                   _gather_prefix_impl)
_store_prefix = profiler.profiled('engine.store_prefix', _store_prefix_impl)


def check_options(*, kv_layout: Optional[str] = None,
                  prefix_slots: Optional[int] = None,
                  prefill_chunk: Optional[int] = None, draft: bool = False,
                  mesh=None, prefix_share: Optional[bool] = None,
                  kv_tiers: Optional[bool] = None,
                  role: Optional[str] = None, moe: bool = False) -> tuple:
    """Resolve the engine's options against their environment defaults
    and refuse the ones not ported yet (``NotImplementedError``) or
    unknown (``ValueError``). Returns (kv_layout, prefix_slots,
    prefill_chunk, role, prefix_share, kv_tiers). As in the JAX engine,
    block sharing is on only with the paged layout and without a draft
    (``draft``: the engine has one; spec mode keeps its own dense draft
    prefill), and KV tiers only with sharing. An MoE model (``moe``)
    gets no prefix pool, no chunked prefill and no block sharing
    (``engine.py:680-726`` of the JAX package): expert capacity is per
    forward call, so each would route differently from the monolithic
    prefill. Needs no weights, so a replica checks its flags before it
    builds them. A mesh may split any axis JAX serves on (``data``,
    ``pipe``, ``fsdp``, ``seq``, ``expert``, ``tensor``); on it every
    layout, a draft, MoE, the KV tiers and each role serve as on one
    device."""
    kv_layout = (kv_layout or os.environ.get('SKYTPU_LLM_KV_LAYOUT')
                 or 'slot')
    if kv_layout not in ('slot', 'paged'):
        raise ValueError(f'Unknown kv_layout {kv_layout!r}; '
                         "'slot' or 'paged'")
    if prefix_slots is None:
        prefix_slots = int(os.environ.get('SKYTPU_LLM_PREFIX_CACHE', '0'))
    if prefill_chunk is None:
        prefill_chunk = int(os.environ.get('SKYTPU_LLM_PREFILL_CHUNK', '0'))
    if prefix_share is None:
        prefix_share = os.environ.get('SKYTPU_LLM_PREFIX_SHARE', '1') != '0'
    prefix_share = (bool(prefix_share) and kv_layout == 'paged'
                    and not draft and not moe)
    if moe:
        prefix_slots = prefill_chunk = 0
    if kv_tiers is None:
        kv_tiers = os.environ.get('SKYTPU_KV_TIERS', '1') != '0'
    kv_tiers = bool(kv_tiers) and prefix_share
    role = role or os.environ.get('SKYTPU_LLM_ROLE', 'colocated')
    if role not in ('colocated', 'prefill', 'decode'):
        raise ValueError(f'Unknown engine role {role!r}; '
                         "'colocated', 'prefill' or 'decode'")
    return (kv_layout, max(int(prefix_slots), 0), max(int(prefill_chunk), 0),
            role, prefix_share, kv_tiers)


def _local_params(params, cfg: llama.LlamaConfig, mesh):
    """This rank's slices of ``params`` on ``mesh``: a whole tree is
    sliced (``quantization.shard_params``), a tree of slices passes
    (``llama.init_params_sharded``). The draft rides the same rules, so
    its heads and kv_heads must divide the tensor axis, and its layers
    ``pipe``, as the target's do."""
    from skypilot_tpu_torch.models import quantization as quant_lib
    from skypilot_tpu_torch.parallel import sharding as sharding_lib
    tp = mesh.shape['tensor']
    if cfg.n_kv_heads % tp or cfg.n_heads % tp:
        raise ValueError(f'{cfg.n_heads} heads and {cfg.n_kv_heads} kv '
                         f'heads do not split over tensor ({tp} shards)')
    llama.check_mesh(cfg, mesh.shape)
    # Leaves whose shape tells a whole tree from a tree of slices: a
    # sharded mesh splits some dim of one of them.
    paths = [('embed',), ('layers', 'wq')] + (
        [('layers', 'moe', 'we_gate')] if cfg.num_experts else [])
    rules = sharding_lib.ShardingRules()
    for path in paths:
        leaf, shape, logical = (functools.reduce(dict.__getitem__, path, t)
                                for t in (params, llama.param_shapes(cfg),
                                          llama.param_logical_axes(cfg)))
        got = tuple((leaf['q8'] if quant_lib.is_quantized(leaf)
                     else leaf).shape)
        local = sharding_lib.local_shape(
            shape, sharding_lib.logical_sharding(mesh, rules, logical))
        if got == tuple(local) != tuple(shape):
            return params
        if got != tuple(shape):
            raise ValueError(f'{"/".join(path)} of shape {got}: neither the '
                             f'whole {tuple(shape)} nor a {mesh} slice '
                             f'{tuple(local)}')
    return quant_lib.shard_params(params, cfg, mesh)


# The mesh axes over which the KV planes a replica's head sends and
# receives are whole (neither ``layers`` nor ``kv_heads`` maps there).
_REPLICA_AXES = ('data', 'fsdp', 'seq', 'expert')


class ContinuousEngine:
    """Slot server: submit() rows from any thread; a dedicated engine
    thread owns the device state and loops admit -> decode-chunk -> emit.
    See the module docstring for the design. ``device`` None = CUDA
    (raises without a card); the tests pass ``device='cpu'``.

    Block accounting (paged layout): ``_free_blocks`` is the free list,
    ``_slot_blocks[i]`` the blocks slot i owns outright and
    ``_slot_shared[i]`` the trie nodes it holds a reference on; with the
    trie's referenced and idle blocks they partition the usable pool.
    Every method that touches them runs under ``_lock``."""

    # The rank that serves HTTP and owns the KV tiers: every rank of a
    # single-process engine (``serve/spmd.py`` sets it per rank).
    _head = True

    def __init__(self, params, cfg: llama.LlamaConfig, *,
                 slots: Optional[int] = None, max_len: int = 1024,
                 chunk_steps: Optional[int] = None,
                 prefill_batch: Optional[int] = None, seed: int = 0,
                 mesh=None, kv_quantize: Optional[bool] = None,
                 prefix_slots: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 draft_params=None,
                 draft_cfg: Optional[llama.LlamaConfig] = None,
                 spec_k: Optional[int] = None,
                 kv_layout: Optional[str] = None,
                 kv_blocks: Optional[int] = None,
                 kv_block: Optional[int] = None,
                 pipeline: Optional[bool] = None,
                 prefix_share: Optional[bool] = None,
                 kv_tiers: Optional[bool] = None,
                 role: Optional[str] = None, device=None):
        # Speculative mode: the draft proposes, the target verifies, per
        # slot, inside the continuous batch (module docstring).
        if (draft_params is None) != (draft_cfg is None):
            raise ValueError('draft_params and draft_cfg go together')
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.spec_k = (spec_k if spec_k is not None
                       else int(os.environ.get('SKYTPU_LLM_SPEC_K', '4')))
        if draft_cfg is not None:
            if self.spec_k < 1:
                raise ValueError(f'spec_k must be >= 1, got {self.spec_k}')
            if cfg.num_experts > 0:
                # Expert capacity is per forward CALL: a k+1-token verify
                # routes differently than sequential decode.
                raise ValueError('speculative decoding requires a dense '
                                 'target (MoE expert capacity is per '
                                 'forward call; a k+1-token verify would '
                                 'break greedy exactness)')
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    'draft and target must share a vocabulary '
                    f'({draft_cfg.vocab_size} vs {cfg.vocab_size})')
        (self.kv_layout, self.prefix_slots, self.prefill_chunk,
         self.role, self.prefix_share, tiers_on) = check_options(
            kv_layout=kv_layout, prefix_slots=prefix_slots,
            prefill_chunk=prefill_chunk,
            draft=draft_params is not None or draft_cfg is not None,
            mesh=mesh, prefix_share=prefix_share, kv_tiers=kv_tiers,
            role=role, moe=cfg.num_experts > 0)
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        # Work each rank of the row axes does for the whole batch (a
        # prefill group) runs on the mesh's whole-rows view.
        self._whole = None if self.mesh is None else self.mesh.whole_rows()
        if self.mesh is not None:
            params = _local_params(params, cfg, self.mesh)
            if draft_params is not None:
                self.draft_params = _local_params(draft_params, draft_cfg,
                                                  self.mesh)
        self.params = params
        self.cfg = cfg
        self.slots = slots or int(os.environ.get('SKYTPU_LLM_SLOTS', '16'))
        # This rank's block of the slots (None: it holds them all).
        self._rows = gen_lib.data_rows(self.mesh, self.slots)
        self.max_len = min(max_len, cfg.max_seq_len)
        self.chunk_steps = chunk_steps or int(
            os.environ.get('SKYTPU_LLM_CHUNK_STEPS', '8'))
        self.prefill_batch = min(
            prefill_batch or int(os.environ.get('SKYTPU_LLM_PREFILL_BATCH',
                                                '8')), self.slots)
        if kv_quantize is None:
            kv_quantize = os.environ.get('SKYTPU_LLM_KV_CACHE') == 'int8'
        self.kv_quantize = bool(kv_quantize)
        # Pipelined dispatch (default ON): one decode chunk in flight so
        # host bookkeeping overlaps device compute. Depth 0 = serial.
        if pipeline is None:
            pipeline = os.environ.get('SKYTPU_LLM_PIPELINE', '1') != '0'
        self.pipeline_depth = 1 if pipeline else 0
        if cfg.num_experts > 0:
            # A chunk in flight runs against a snapshot one retirement
            # stale, so a row freed meanwhile would still take expert
            # capacity and change the live rows' routing.
            self.pipeline_depth = 0
        if draft_cfg is not None:
            # Rounds are host-synchronous by construction: acceptance
            # decides the rollback that shapes the next round's inputs.
            self.pipeline_depth = 0
        # A verify may write k+1 positions past a row's last committed one
        # before its tail rolls back: submit reserves that overhang below
        # max_len, and a row's write limit and paged reservation cover it.
        self._overhang = self.spec_k + 1 if draft_cfg is not None else 0
        self._submit_max = self.max_len - self._overhang
        self._seed = seed
        self.kv_block = kv_block or int(
            os.environ.get('SKYTPU_LLM_KV_BLOCK', '16'))
        if self.kv_layout == 'paged':
            # Pool size INCLUDING the junk-sink block 0; the default is
            # full capacity (no saving, always safe), deployments size it
            # down and admission backpressures.
            self.kv_blocks = kv_blocks or (
                self.slots * (self.max_len // self.kv_block) + 1)
        # Bound on the /health prefix advert's entries.
        self._summary_max = max(
            int(os.environ.get('SKYTPU_PREFIX_SUMMARY_MAX', '64')), 0)
        # KV tiers: one per replica, on its head, holding whole planes in
        # JAX's layout; the other ranks follow its answers (``_decide``).
        self._tiers_on = tiers_on
        self._kv_tiers = None
        if tiers_on and self._head:
            from skypilot_tpu_torch.serve import kv_tiers as kv_tiers_lib
            self._kv_tiers = kv_tiers_lib.KVTiers.from_env(
                cfg, self.kv_block, quantized=self.kv_quantize)
        # The engine's side of the tier decisions, equal on every rank:
        # evicted blocks gathered for a demote, blocks promoted, requests
        # parked on a fetch, and fetch completions re-queued.
        self.tier_counts = {'evicted': 0, 'promoted': 0, 'parked': 0,
                            'fetches_done': 0}
        # Requests parked on a background spill fetch; its completion
        # re-queues them at the head of _pending.
        self._tier_waiting: List[_Request] = []
        self.prefix_min = 16  # smallest cacheable/matchable prefix
        self._prefix_index: 'collections.OrderedDict[tuple, int]' = \
            collections.OrderedDict()  # prefix tokens -> pool row (LRU)
        self._prefix_seen: 'collections.OrderedDict[tuple, int]' = \
            collections.OrderedDict()  # sighting counts (bounded)
        self._init_device_state()
        self._slot_req: List[Optional[_Request]] = [None] * self.slots
        self._pending: collections.deque = collections.deque()
        # Decode-role admissions (submit_import), installed FIFO ahead of
        # local admission.
        self._pending_imports: collections.deque = collections.deque()
        # [(reqs, firsts on their way to the host)] of prefilled groups.
        self._unfetched: List[tuple] = []
        self._admitting: List[_Request] = []  # mid-prefill group
        self._prefilling: List[_Prefilling] = []  # chunked long prefills
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        # Pipeline state: at most ONE issued-but-unread chunk.
        self._inflight: Optional[_Inflight] = None
        self._last_dispatch_t: Optional[float] = None
        self._no_flight_since: Optional[float] = None
        # Stats (read by /health).
        self.prefills = 0
        self.prefill_groups = 0
        self.prefill_tokens = 0
        self.prefill_ms = 0.0
        self.prefill_bubble_ms = 0.0  # prefill host time decode waited on
        self.prefill_chunks = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.prefix_stores = 0
        # Block-share accounting (stats()['prefix_share']).
        self.share_hits = 0
        self.share_hit_tokens = 0
        self.share_misses = 0
        self.share_commits = 0
        self.share_evictions = 0
        self.cow_forks = 0
        self.prefill_tokens_saved = 0  # prompt tokens the pool skipped
        self.chunks_run = 0
        self.tokens_emitted = 0
        # A running crc32 of every token emitted (``_fold_sampled``): the
        # ranks of a sharded replica must agree.
        self.sampled_digest = 0
        self.peak_active = 0
        self.spec_rounds = 0
        self.spec_proposals = 0
        self.spec_accepted = 0
        # KV handoff (stats()['disagg']): prefill-role retirements and
        # decode-role installs, their host ms, and failed installs.
        self.exports = 0
        self.imports = 0
        self.export_ms = 0.0
        self.import_ms = 0.0
        self.import_errors = 0
        # Overlap (stats()['pipeline']): host work done while a chunk
        # computes vs host time the device idled with work waiting.
        self.dispatches = 0
        self.host_overlap_ms = 0.0
        self.bubble_ms = 0.0
        self._gap_ms_total = 0.0
        self._gap_count = 0

    # -- public API (any thread) ------------------------------------------

    def submit(self, row: List[int], max_new: int,
               temperature: float = 0.0, on_tokens=None,
               top_k: int = 0, top_p: float = 1.0,
               eos=None) -> concurrent.futures.Future:
        req = self._build_request(row, max_new, temperature, on_tokens,
                                  top_k, top_p, eos)
        self._enqueue(req)
        return req.future

    def _enqueue(self, req: _Request) -> None:
        """Queue a built request (a submit, an export) for admission."""
        with self._lock:
            self._pending.append(req)
        self.start()  # idempotent; revives a stop()ped engine
        self._wake.set()

    def _enqueue_import(self, entry: '_ImportEntry') -> None:
        """Queue a validated import for ``_admit_imports``."""
        with self._lock:
            self._pending_imports.append(entry)
        self.start()
        self._wake.set()

    def submit_prefill(self, row: List[int], max_new: int,
                       temperature: float = 0.0, top_k: int = 0,
                       top_p: float = 1.0,
                       eos=None) -> concurrent.futures.Future:
        """Prefill-role admission: compute the prompt's KV, sample the
        first token and RETIRE; the future resolves with a
        ``PrefillHandoff`` that a decode-role engine imports
        (``submit_import``). ``max_new`` only rides the handoff: this
        engine reserves blocks for the prompt alone. MoE expert capacity
        couples the rows of a batch, so an MoE model's prompt KV is not
        batch-independent and is refused, as in the JAX engine; so is a
        draft, whose cache does not transfer. Under a mesh the planes
        are gathered to the head, whole, before the future resolves."""
        if self.cfg.num_experts > 0:
            raise ValueError('KV handoff requires a dense model (MoE '
                             'expert capacity is per forward call, so '
                             'exported prompt KV is not batch-'
                             'independent)')
        if self.draft_cfg is not None:
            raise ValueError('KV handoff does not compose with '
                             'speculative decoding (the draft cache '
                             'does not transfer)')
        req = self._build_request(row, max_new, temperature, None,
                                  top_k, top_p, eos, export=True)
        self._enqueue(req)
        return req.future

    def submit_import(self, row: List[int], max_new: int, first: int,
                      *, temperature: float = 0.0, top_k: int = 0,
                      top_p: float = 1.0, eos=None, on_tokens=None,
                      layout: str = 'paged', block_start: int = 0,
                      k=None, v=None, k_s=None,
                      v_s=None) -> concurrent.futures.Future:
        """Decode-role admission of an imported prompt: install the
        transferred planes (paged: block scatter and table install; slot:
        a row insert), emit ``first`` as the request's first token and
        decode on. Queues like local admission until a slot and the full
        block reservation are free. The planes' shapes are checked HERE:
        an install that raised on the engine thread would fail every
        request in flight (``_fail_everything``), and crc32 covers plane
        bytes only, not the header's shapes. The planes carry whole KV
        heads (JAX's wire format); under a mesh each rank installs its
        own, which the head scatters when the import admits."""
        if layout != self.kv_layout:
            raise ValueError(f'handoff layout {layout!r} does not match '
                             f'engine kv_layout {self.kv_layout!r}')
        if self.cfg.num_experts > 0 or self.draft_cfg is not None:
            raise ValueError('KV handoff requires a dense, '
                             'non-speculative engine')
        if ((k_s is not None) != self.kv_quantize) and k is not None:
            raise ValueError('handoff KV quantization does not match '
                             'the engine kv_cache mode')
        cfg = self.cfg
        if self.kv_layout == 'paged':
            p = self.kv_block
            nb_prompt = -(-len(row) // p)
            nb_present = nb_prompt - int(block_start)
            if nb_present < 0:
                raise ValueError(
                    f'handoff block_start {block_start} exceeds the '
                    f'prompt chain ({nb_prompt} blocks)')
            want = (cfg.n_layers, nb_present, cfg.n_kv_heads, p,
                    cfg.head_dim)
        else:
            nb_present = 1  # one dense record, exact prompt width
            want = (cfg.n_layers, 1, cfg.n_kv_heads, len(row),
                    cfg.head_dim)
        if nb_present > 0:  # == 0: full local prefix share, no planes
            if k is None or v is None \
                    or tuple(k.shape) != want or tuple(v.shape) != want:
                raise ValueError(
                    f'handoff k/v planes must be {want}, got '
                    f'{None if k is None else tuple(k.shape)} / '
                    f'{None if v is None else tuple(v.shape)}')
            if self.kv_quantize and (
                    k_s is None or v_s is None
                    or tuple(k_s.shape) != want[:-1]
                    or tuple(v_s.shape) != want[:-1]):
                raise ValueError(
                    f'handoff k_s/v_s scale planes must be {want[:-1]}')
            for arr in (k, v):
                _plane_words(arr)  # a dtype torch lacks raises here
        req = self._build_request(row, max_new, temperature, on_tokens,
                                  top_k, top_p, eos)
        entry = _ImportEntry(req=req, first=int(first), layout=layout,
                             block_start=int(block_start),
                             k=k, v=v, k_s=k_s, v_s=v_s)
        self._enqueue_import(entry)
        return req.future

    # -- a tensor-parallel replica's head (``serve/spmd.py``) ---------------

    def _decide(self, fn, share=None):
        """``fn()``: a decision taken from state that only the head holds
        (the KV tiers). One process answers itself; ``serve/spmd.py``'s
        head computes it alone and broadcasts it (``share(answer)`` when
        given: what the other ranks need of it), so that every rank takes
        it in the same iteration."""
        del share
        return fn()

    def _replica_zero(self, axes: tuple = _REPLICA_AXES) -> bool:
        """True on the ranks at index 0 of each of ``axes``: by default
        every axis that splits neither the layers nor the KV heads."""
        return all(self.mesh.axis_index(a) == 0 for a in axes)

    def _heads_to_head(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        """A KV plane (layers on dim 0, heads on dim 2) whole, on the
        head: under a mesh the ranks' heads are gathered there over
        ``tensor``, then their layers over ``pipe`` (collectives of the
        ranks at index 0 of the other axes, which hold what the head
        needs; None on the other ranks)."""
        if self.mesh is None:
            return t
        if not self._replica_zero():
            return None
        t = collectives.gather_to(t, self.mesh, dim=2)
        if self.mesh.axis_index('tensor') != 0:
            return None
        return collectives.gather_to(t, self.mesh, 'pipe', dim=0)

    def _heads_from_head(self, t: Optional[torch.Tensor], shape: tuple,
                         dtype: torch.dtype) -> torch.Tensor:
        """This rank's layers and KV heads of the head's whole plane ``t``
        of ``shape`` (layers on dim 0, heads on dim 2; None on the other
        ranks): under a mesh the head scatters the layers over ``pipe``
        and each of those ranks the heads over ``tensor``, at index 0 of
        the other axes, which then broadcast them over each of those
        axes in turn."""
        if self.mesh is None:
            return t
        pipe, tp = self.mesh.shape['pipe'], self.mesh.shape['tensor']
        mid = (shape[0] // pipe,) + tuple(shape[1:])
        local = mid[:2] + (shape[2] // tp,) + mid[3:]
        if self._replica_zero():
            if self.mesh.axis_index('tensor') == 0:
                t = collectives.scatter_from(t, self.mesh, mid, dtype,
                                             'pipe', dim=0)
            t = collectives.scatter_from(t, self.mesh, local, dtype, dim=2)
        for i, axis in enumerate(_REPLICA_AXES):
            if self._replica_zero(_REPLICA_AXES[i + 1:]):
                t = collectives.broadcast(t, self.mesh, local, dtype, axis)
        return t

    def _owned(self, slots) -> Optional[tuple]:
        """``_insert_impl``'s ``owned`` for a group bound for ``slots``
        (host ints): None where this rank holds every slot, else (its
        block's rows, the group's rows they take) on the device, both
        empty when none of them is its own."""
        if self._rows is None:
            return None
        lo, hi = self._rows.start, self._rows.stop
        pick = [i for i, s in enumerate(slots) if lo <= s < hi]
        dev = self.device
        return (_to_device(np.asarray([slots[i] - lo for i in pick],
                                      np.int64), dev),
                _to_device(np.asarray(pick, np.int64), dev))

    def _own_rows(self, v: torch.Tensor) -> torch.Tensor:
        """A slot vector [B] cut to this rank's block of the slots."""
        return v if self._rows is None else v[self._rows]

    def probe_chain(self, row: List[int]) -> int:
        """How many leading FULL prompt blocks of ``row`` this engine's
        share trie already holds: the handoff negotiation's answer, which
        lets the transfer skip those blocks' bytes. Touches the matched
        nodes (LRU refresh) so that eviction is unlikely to race the
        import that follows; a race that still loses fails the import,
        and the load balancer falls back."""
        if self._trie is None:
            return 0
        with self._lock:
            return len(self._touch_chain(row))

    def _touch_chain(self, row: List[int]) -> list:
        """Match ``row``'s full prompt blocks in the trie and refresh
        their LRU place (caller holds the lock)."""
        p = self.kv_block
        nodes, _, _ = self._trie.match(row, limit=(len(row) // p) * p)
        for nd in nodes:
            self._trie.touch(nd)
        return nodes

    def resolve_chains(self, digests: List[bytes]) -> List[List[int]]:
        """Token rows for the advert chain digests this engine's trie
        still holds (``BlockTrie.resolve_chains``), longest first, plus,
        with KV tiers, those the host and spill tiers hold. Empty when
        sharing is off. The remediation pre-warm replays them through the
        export/import path so that a successor's trie starts hot."""
        if self._trie is None:
            return []
        with self._lock:
            rows = self._trie.resolve_chains(digests)
        if self._kv_tiers is not None:
            missing = [d for d in digests if d not in rows]
            if missing:
                rows.update(self._kv_tiers.resolve_rows(missing))
        return sorted(rows.values(), key=len, reverse=True)

    def prefix_summary(self) -> Optional[dict]:
        """Bounded resident-chain summary for prefix-affinity routing
        (``BlockTrie.summary``), or None when sharing is off; the
        replica's /health body carries it. Tier-resident chains ride
        along as ``[chain_hex, depth, tier]`` rows (1 = host, 2 =
        spilled)."""
        if self._trie is None:
            return None
        with self._lock:
            summ = self._trie.summary(self._summary_max)
        if self._kv_tiers is not None:
            have = {e[0] for e in summ['entries']}
            room = self._summary_max - len(summ['entries'])
            extra, trunc = self._kv_tiers.advert_entries(room, have)
            summ['entries'].extend(extra)
            summ['truncated'] = bool(summ['truncated'] or trunc)
            summ['tiers'] = True
        return summ

    def _build_request(self, row, max_new, temperature, on_tokens,
                       top_k, top_p, eos, export: bool = False) -> _Request:
        # An export retires at its first token: it is checked against the
        # prompt's footprint (max_new is spent downstream).
        budget = 1 if export else max_new
        if len(row) + budget > self._submit_max:
            extra = ('' if self._submit_max == self.max_len else
                     f' (max_len {self.max_len} minus the speculative '
                     f'verify window overhang {self._overhang})')
            raise ValueError(
                f'prompt ({len(row)}) + max_new ({budget}) exceeds '
                f'engine max_len limit {self._submit_max}{extra}')
        if self.kv_layout == 'paged' and (max_new > 1 or export):
            need = self._blocks_for(len(row), budget)
            if need > self.kv_blocks - 1:
                # Bigger than the WHOLE pool: it could never be admitted
                # and would starve everything queued behind it.
                raise ValueError(
                    f'request needs {need} KV blocks but the pool has '
                    f'only {self.kv_blocks - 1}; raise kv_blocks or '
                    'shrink prompt+max_new')
        if top_k < 0 or not 0.0 < top_p <= 1.0:
            raise ValueError('top_k must be >= 0 and top_p in (0, 1]')
        if eos is not None and not isinstance(eos, frozenset):
            eos = frozenset([eos] if isinstance(eos, int) else
                            (int(t) for t in eos))
        fut: concurrent.futures.Future = concurrent.futures.Future()
        # Engine futures are UNCANCELLABLE (running from birth): a client
        # disconnect cancelling a pending future would flip it done, and
        # the emission loop would then skip the slot forever (a slot
        # leak). The request runs to completion with nobody reading it.
        fut.set_running_or_notify_cancel()
        return _Request(list(row), max_new, float(temperature), fut,
                        on_tokens=on_tokens, top_k=int(top_k),
                        top_p=float(top_p), eos=eos, export=export,
                        trace_parent=trace_lib.current())

    def start(self) -> None:
        # Under the lock: two first-submitters racing here must not both
        # spawn a loop thread (two loops would share one device cache).
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._stop = False
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name='skytpu-torch-decode-engine')
                self._thread.start()

    def stop(self) -> None:
        self._stop = True
        self._wake.set()
        if self._kv_tiers is not None:
            # Tier worker first: a fetch completing after the loop thread
            # died would re-queue its parked requests into a _pending
            # nobody drains.
            self._kv_tiers.stop()
        if self._thread is not None:
            self._thread.join(timeout=10)
            if self._thread.is_alive():
                return  # wedged mid-chunk; don't race its state
        # The loop thread is gone: anything still queued or occupying a
        # slot would otherwise wait forever (a streaming handler blocks
        # on these futures).
        with self._lock:
            live = bool(self._pending or self._admitting or self._prefilling
                        or self._unfetched or self._tier_waiting
                        or self._pending_imports
                        or any(r is not None for r in self._slot_req))
        if live:
            self._fail_everything(RuntimeError('engine stopped'))

    def busy(self) -> bool:
        """Requests queued (imports too), parked on a tier fetch,
        prefilling or holding a slot."""
        with self._lock:
            return bool(self._pending or self._admitting or self._prefilling
                        or self._unfetched or self._tier_waiting
                        or self._pending_imports
                        or any(r is not None for r in self._slot_req))

    def stats(self) -> dict:
        """Counters for /health under the JAX engine's ``stats()`` keys.
        ``prefill_tokens`` counts the prompt tokens prefill computed;
        ``prefill_tokens_saved`` those shared blocks or the prefix pool
        skipped (as in the JAX engine, a pool hit seeding a chunked
        prefill counts in ``prefix_cache`` only). ``kv_blocks`` (paged):
        free + owned + shared + cached == usable, in one snapshot;
        ``host``/``spilled`` count blocks held off the device by the
        tiers, outside that partition."""
        with self._lock:
            active = sum(r is not None for r in self._slot_req)
            free_blocks = owned_blocks = shared_blocks = cached_blocks = 0
            if self.kv_layout == 'paged':
                free_blocks = len(self._free_blocks)
                owned_blocks = sum(len(b) for b in self._slot_blocks)
                if self._trie is not None:
                    shared_blocks = self._trie.referenced
                    cached_blocks = self._trie.reclaimable
            # Lock order engine -> tiers: host/spilled agree with the
            # kv_tiers block they summarize.
            tier_stats = None
            if self._kv_tiers is not None:
                tier_stats = self._kv_tiers.stats()
                tier_stats['waiting'] = len(self._tier_waiting)
            return {
                'slots': self.slots, 'active_slots': active,
                'kv_cache': 'int8' if self.kv_quantize else 'bf16',
                'kv_layout': self.kv_layout,
                # The role and the handoff counters: exports are
                # prefill-role retirements, imports decode-role installs;
                # queued_imports is the decode pool's backpressure signal.
                'role': self.role,
                'disagg': {'exports': self.exports,
                           'imports': self.imports,
                           'export_ms': round(self.export_ms, 3),
                           'import_ms': round(self.import_ms, 3),
                           'import_errors': self.import_errors,
                           'queued_imports': len(self._pending_imports)},
                'kv_blocks': (None if self.kv_layout != 'paged' else {
                    'total': self.kv_blocks, 'block': self.kv_block,
                    'free': free_blocks, 'usable': self.kv_blocks - 1,
                    'used': self.kv_blocks - 1 - free_blocks,
                    'owned': owned_blocks, 'shared': shared_blocks,
                    'cached': cached_blocks,
                    'host': tier_stats['host_blocks'] if tier_stats else 0,
                    'spilled': (tier_stats['spilled_blocks']
                                if tier_stats else 0),
                    'cow_forks': self.cow_forks}),
                'kv_tiers': tier_stats,
                'queued': len(self._pending), 'prefills': self.prefills,
                'prefill_groups': self.prefill_groups,
                'prefill_batch': self.prefill_batch,
                'prefill_chunk': self.prefill_chunk,
                'prefill_chunks': self.prefill_chunks,
                'prefilling': len(self._prefilling),
                'chunks_run': self.chunks_run,
                'chunk_steps': self.chunk_steps,
                'tokens_emitted': self.tokens_emitted,
                'peak_active_slots': self.peak_active,
                # Depth 1 = one chunk kept in flight; 0 = serial.
                # host_overlap_ms and bubble_ms are CUMULATIVE;
                # dispatch_gap_ms is the mean host-side gap between
                # consecutive chunk dispatches.
                'pipeline': {
                    'pipeline_depth': self.pipeline_depth,
                    'dispatches': self.dispatches,
                    'dispatch_gap_ms': round(
                        self._gap_ms_total / max(self._gap_count, 1), 3),
                    'host_overlap_ms': round(self.host_overlap_ms, 3),
                    'bubble_ms': round(self.bubble_ms, 3)},
                'speculative': None if self.draft_cfg is None else {
                    'k': self.spec_k,
                    'rounds': self.spec_rounds,
                    'proposals': self.spec_proposals,
                    'accepted': self.spec_accepted,
                    'acceptance_rate': (
                        self.spec_accepted / self.spec_proposals
                        if self.spec_proposals else 0.0)},
                'prefix_cache': {
                    'slots': self.prefix_slots,
                    'entries': len(self._prefix_index),
                    'hits': self.prefix_hits,
                    'hit_tokens': self.prefix_hit_tokens,
                    'stores': self.prefix_stores},
                'prefix_share': {
                    'enabled': self.prefix_share,
                    'hits': self.share_hits,
                    'hit_tokens': self.share_hit_tokens,
                    'misses': self.share_misses,
                    'hit_rate': round(
                        self.share_hits
                        / max(self.share_hits + self.share_misses, 1), 4),
                    'commits': self.share_commits,
                    'evictions': self.share_evictions,
                    'cow_forks': self.cow_forks,
                    'shared_blocks': shared_blocks,
                    'cached_blocks': cached_blocks},
                'prefill_tokens': self.prefill_tokens,
                'prefill_tokens_saved': self.prefill_tokens_saved,
                'prefill_ms': round(self.prefill_ms, 3),
                'prefill_bubble_ms': round(self.prefill_bubble_ms, 3)}

    # -- engine thread -----------------------------------------------------

    def _device_scope(self):
        if self.device.type == 'cuda':
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _loop(self) -> None:
        with torch.inference_mode(), self._device_scope():
            while not self._stop:
                try:
                    if self._iterate():
                        self._wake.wait(_IDLE_WAIT_S)
                        self._wake.clear()
                except Exception as exc:  # noqa: BLE001 -- fail all waiters
                    # Fail in-flight work, rebuild device state, KEEP
                    # LOOPING: exiting would strand a request submitted
                    # while this thread still looked alive.
                    self._fail_everything(exc)
                    self._wake.wait(0.1)
                    self._wake.clear()

    def _iterate(self) -> bool:
        """One turn of the loop (a pure function of the queues and the slot
        state, which ``serve/spmd.py``'s lockstep relies on). Returns True
        when the engine is idle: no slot holds a request and no long
        prompt is prefilling."""
        t0 = time.perf_counter()
        # Prefill advance BEFORE admission: a parked finished prefill
        # must win a freed slot over younger shorts.
        self._advance_prefill()
        # Imported prompts admit FIRST: their prefill is already paid for
        # on the prefill pool. Parked, they do not block local admission
        # (a decode replica also serves the colocated fallback).
        self._admit_imports()
        self._admit()
        if self._inflight is not None:
            # Admission issued while a chunk computes is pure overlap:
            # the host work the pipeline hides.
            with self._lock:
                self.host_overlap_ms += (time.perf_counter() - t0) * 1e3
        if not any(r is not None for r in self._slot_req):
            # Every request of a still-in-flight chunk's snapshot is done
            # by now (a live one would hold its slot), so the flush only
            # drops junk.
            self._flush_pipeline(quiet=True)
            self._drain_firsts()  # e.g. all max_new == 1
            self._note_decode_quiet()
            # Keep chunking a long prompt without waiting.
            return not self._prefilling
        with self._lock:
            only_exports = all(r is None or r.export
                               for r in self._slot_req)
        if only_exports:
            # The prefill role's steady state: every occupied slot is an
            # export awaiting its drain, so a decode chunk over them would
            # be junk. Drain (gather and retire them) and admit again.
            self._flush_pipeline(quiet=True)
            self._drain_firsts()
            return False
        if self.draft_cfg is not None:
            self._run_spec_round()
        else:
            self._run_chunk()
        return False

    def _fail_everything(self, exc: Exception) -> None:
        with self._lock:
            doomed = list(self._pending) + [
                r for r in self._slot_req if r is not None] + [
                r for reqs, _ in self._unfetched for r in reqs] + \
                list(self._admitting) + [p.req for p in self._prefilling] \
                + [e.req for e in self._pending_imports] \
                + list(self._tier_waiting)
            self._pending.clear()
            self._pending_imports.clear()
            self._tier_waiting = []
            self._slot_req = [None] * self.slots
            self._unfetched = []
            self._admitting = []
            self._prefilling = []
            # The in-flight chunk goes with the device state.
            self._inflight = None
            self._last_dispatch_t = None
            self._no_flight_since = None
        for req in doomed:  # dupes are safe: first set_exception wins
            if not req.future.done():
                req.future.set_exception(exc)
        # The cause and blast radius go on the ring, then the ring (with
        # stacks, traces and health) freezes into an incident bundle.
        # Waiters were failed first (the dump writes a file); the rebuild
        # runs after, so its own failure cannot lose the evidence.
        blackbox.record('engine.fail', cause=repr(exc)[:200],
                        doomed=len(doomed))
        blackbox.dump('engine_failure', reason=repr(exc)[:200])
        # Fresh device state (and, paged, a fresh free list and trie): the
        # failed call may have half-written the old buffers.
        self._init_device_state()

    @torch.inference_mode()
    def _init_device_state(self) -> None:
        dev = self.device
        # Share-trie state exists on every layout (None = sharing off).
        self._trie: Optional[paged_lib.BlockTrie] = None
        self._slot_shared: List[list] = [[] for _ in range(self.slots)]
        # Each paged slot's host copy of its block table row (an export
        # gathers its blocks through it); None while free.
        self._slot_table: List[Optional[np.ndarray]] = \
            [None] * self.slots
        if self.kv_layout == 'paged':
            # Born sharded under a mesh, as the slot layout's cache.
            self._cache = paged_lib.init_pool(
                self.cfg, self.slots, self.max_len, self.kv_blocks,
                self.kv_block, quantize=self.kv_quantize, device=dev,
                mesh=self.mesh)
            # Host-side accounting: block 0 is the junk sink, never
            # allocated; _slot_blocks holds each slot's OWNED blocks,
            # _slot_shared its refcounted trie nodes.
            self._free_blocks = list(range(1, self.kv_blocks))
            self._slot_blocks: List[List[int]] = [
                [] for _ in range(self.slots)]
            if self.prefix_share:
                self._trie = paged_lib.BlockTrie(self.kv_block)
        else:
            # Born sharded under a mesh: this rank's kv heads only.
            self._cache = gen_lib.init_cache(self.cfg, self.slots,
                                             self.max_len,
                                             quantize=self.kv_quantize,
                                             device=dev, mesh=self.mesh)
        self._last = torch.zeros((self.slots,), dtype=torch.int32,
                                 device=dev)
        # A row is active while lengths < limit (module docstring); a
        # free slot's limit is 0.
        self._limit = torch.zeros((self.slots,), dtype=torch.int32,
                                  device=dev)
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(self._seed)
        profiler.register_logical('kv_cache',
                                  profiler.tree_nbytes(self._cache))
        self._d_cache = None
        if self.draft_cfg is not None:
            # The draft cache is dense (one max_len row per slot) on both
            # layouts, as in the JAX engine.
            self._d_cache = gen_lib.init_cache(self.draft_cfg, self.slots,
                                               self.max_len,
                                               quantize=self.kv_quantize,
                                               device=dev, mesh=self.mesh)
            profiler.register_logical('kv_draft',
                                      profiler.tree_nbytes(self._d_cache))
        # The pool is zero-filled like every cache here: a miss gathers
        # row 0, whose positions are masked, and 0 x NaN would be NaN.
        self._prefix_pool = None
        if self.prefix_slots > 0:
            self._prefix_pool = gen_lib.init_cache(
                self.cfg, self.prefix_slots, self.max_len,
                quantize=self.kv_quantize, device=dev, mesh=self.mesh)
            profiler.register_logical(
                'prefix_pool', profiler.tree_nbytes(self._prefix_pool))
        self._prefix_index.clear()
        self._prefix_seen.clear()
        self._prefix_free = list(range(self.prefix_slots))

    # -- paged block accounting (callers hold _lock) -----------------------

    def _blocks_for(self, row_len: int, max_new: int) -> int:
        """Blocks reserved at admission: the request's actual ask, not
        max_len, plus (spec mode) the verify window's overhang, which a
        round writes before it rolls back. The ONE definition: submit-time
        feasibility and admission-time reservation must never disagree."""
        return -(-(row_len + max_new + self._overhang) // self.kv_block)

    def _limit_for(self, req: _Request) -> int:
        """A slot's write limit: its row is active while its length is
        below this (prompt + max_new - 1, plus the spec window). An
        export's is its prompt: no decode chunk writes its row."""
        budget = 1 if req.export else req.max_new
        return len(req.row) + budget - 1 + self._overhang

    def _blocks_needed(self, req: _Request) -> int:
        # An export retires at its first token: its reservation covers
        # the prompt, never max_new.
        return self._blocks_for(len(req.row),
                                1 if req.export else req.max_new)

    def _release_blocks(self, slot: int) -> None:
        """Return a finished slot's owned blocks to the free list and
        drop its references on shared ones: refs-0 blocks park in the
        trie's idle LRU as reusable cache (a detached node's block frees
        for real)."""
        self._slot_table[slot] = None
        if self.kv_layout != 'paged':
            return
        self._free_blocks.extend(self._slot_blocks[slot])
        self._slot_blocks[slot] = []
        if self._trie is not None and self._slot_shared[slot]:
            for node in self._slot_shared[slot]:
                freed = self._trie.release(node)
                if freed is not None:
                    self._free_blocks.append(freed)
            self._slot_shared[slot] = []

    def _blocks_avail(self) -> int:
        """Allocatable blocks RIGHT NOW: the free list plus the idle
        (refs == 0) trie blocks the allocator may evict."""
        avail = len(self._free_blocks)
        if self._trie is not None:
            avail += self._trie.reclaimable
        return avail

    def _alloc_blocks(self, n: int, parent=None) -> List[int]:
        """Pop ``n`` blocks, evicting idle trie blocks LRU when the free
        list runs short (callers checked ``_blocks_avail() >= n``). With
        KV tiers, eviction DEMOTES: the evicted chains' KV is gathered
        off the pool on the stream before the freed ids can be written
        again; ``parent`` is the admitting request's trace span, which
        the demotion's ``serve.kv_demote`` span joins."""
        if len(self._free_blocks) < n and self._trie is not None:
            pairs = self._trie.evict_nodes(n - len(self._free_blocks))
            self.share_evictions += len(pairs)
            if self._tiers_on and pairs:
                self._demote_evicted(pairs, parent)
            self._free_blocks.extend(b for b, _ in pairs)
        return [self._free_blocks.pop() for _ in range(n)]

    def _demote_evicted(self, pairs: list, parent=None) -> None:
        """Queue just-evicted trie chains for host-tier demotion: ONE
        pow2-padded export gather over the victim blocks, issued HERE,
        before this admission (or any later one) can write the freed ids,
        so stream order has it read the pre-eviction KV. Its planes go to
        the host as ``_HostCopy``s (pinned, non-blocking, an event each):
        the tier thread waits on those events, never on the stream, and
        the engine thread never waits at all. A chain that served a share
        hit is hot: a saturated queue still takes it (``KVTiers.accepts``).

        Under a mesh the tier lives on the head: every rank gathers its
        heads of EVERY evicted block to the head (``_heads_to_head``, a
        collective, so the gather cannot wait on the head's answers), and
        the head alone asks ``accepts`` and offers the whole planes."""
        tiers = self._kv_tiers
        items = []
        for blk, node in pairs:
            if self.mesh is None and not tiers.accepts(node.chain,
                                                       hot=node.hits > 0):
                continue
            items.append((node, len(items), blk))
        if not items:
            return
        self.tier_counts['evicted'] += len(items)
        nbp = 1
        while nbp < len(items):
            nbp *= 2
        tbl = np.zeros((nbp,), np.int64)  # pad -> junk sink block 0
        tbl[:len(items)] = [blk for _, _, blk in items]
        planes = tuple(
            None if t is None else self._heads_to_head(t)
            for t in _export_blocks(self._cache, _to_device(tbl,
                                                            self.device)))
        if tiers is None:
            return  # a follower: its heads went to the head
        if self.mesh is not None:
            items = [it for it in items
                     if tiers.accepts(it[0].chain, hot=it[0].hits > 0)]
            if not items:
                return
        tiers.offer_demote([(node.chain, _chain_row(node), gi)
                            for node, gi, _ in items],
                           tuple(None if t is None else _HostCopy(t)
                                 for t in planes), parent=parent)

    def _tier_consult(self, row: List[int], nodes: list) -> tuple:
        """Extend a trie match through the tier index, block by block
        (chain digests, as the adverts use): consecutive host-tier hits
        become the promote list; the first spilled block switches to a
        fetch list; any gap ends the walk (promotion stays contiguous).
        The last prompt token is never covered."""
        p = self.kv_block
        tiers = self._kv_tiers
        promote: list = []
        fetch: list = []
        prev = nodes[-1].chain if nodes else None
        pos = len(nodes) * p
        limit = len(row) - 1
        while pos + p <= limit:
            digest = affinity_lib.chain_digest(prev, row[pos:pos + p])
            where = tiers.lookup(digest)
            if where == 'host' and not fetch:
                promote.append(digest)
            elif where == 'spilled':
                fetch.append(digest)
            else:
                break
            prev = digest
            pos += p
        return promote, fetch

    def _tier_fetch_done(self, digests: List[bytes], ok: bool) -> None:
        """Tier-thread callback: a background spill fetch finished
        (blocks host-resident now, or quarantined). Re-queue every parked
        request at the FRONT of the queue, keeping their FIFO seniority."""
        del digests, ok  # re-matching consults the index afresh
        self._requeue_tier_waiting()
        self._wake.set()

    def _requeue_tier_waiting(self) -> None:
        with self._lock:
            if not self._tier_waiting:
                return
            self.tier_counts['fetches_done'] += 1
            for req in reversed(self._tier_waiting):
                self._pending.appendleft(req)
            self._tier_waiting = []

    @staticmethod
    def _fire_callbacks(emitted: List[tuple]) -> None:
        """Run on_tokens callbacks OUTSIDE the lock, each guarded: a
        raising callback (a streaming client that went away) loses ITS
        stream only; it must not reach _loop's failure path, which would
        fail every other request and rebuild the cache."""
        for req, new in emitted:
            try:
                req.on_tokens(new)
            except Exception:  # noqa: BLE001 -- isolate per request
                req.on_tokens = None  # stop notifying the dead consumer

    def _sampling_args(self, temps: np.ndarray, top_ks: np.ndarray,
                       top_ps: np.ndarray) -> tuple:
        """(temps, generator, top_ks, top_ps) for ``sampling.sample`` on
        the device, from per-row host arrays. All None when no row
        samples: every row then takes the argmax and no noise is drawn."""
        if not bool((temps > 0).any()):
            return None, None, None, None
        dev = self.device
        tk, tp = _filters_or_none(top_ks, top_ps)
        return (_to_device(temps, dev), self._gen,
                None if tk is None else _to_device(tk, dev),
                None if tp is None else _to_device(tp, dev))

    def _admit(self) -> None:
        """Prefill pending requests into free slots, in power-of-two
        GROUPS: one padded [N, S] forward + one insert per group, the
        group size capped at ``prefill_batch``. Prompts longer than
        ``prefill_chunk`` leave the queue for the incremental path
        (``_advance_prefill``), at most two at a time; FIFO order holds:
        a long head blocks later shorts only while that capacity is
        full. Paged: a group admits only requests whose blocks fit the
        allocatable pool (backpressure), and a block-share hit at the
        head of the queue takes ``_admit_shared`` instead."""
        while True:
            with self._lock:
                while (self.prefill_chunk and self._pending
                       and len(self._prefilling) < 2
                       and len(self._pending[0].row) > self.prefill_chunk):
                    self._prefilling.append(
                        _Prefilling(self._pending.popleft()))
                if (self.prefill_chunk and self._pending
                        and len(self._pending[0].row) > self.prefill_chunk):
                    return  # long head waiting on prefill capacity
                shared, parked_on_fetch = self._match_head()
                if shared == 'wait':
                    return  # backpressure: the hit head waits
                if parked_on_fetch:
                    continue
                if shared is None:
                    free = [i for i, r in enumerate(self._slot_req)
                            if r is None]
                    # Slots owed to parked finished prefills are
                    # reserved: a steady stream of shorts would
                    # otherwise starve them.
                    parked = sum(1 for e in self._prefilling if e.parked)
                    n = min(max(len(free) - parked, 0), len(self._pending),
                            self.prefill_batch)
                    if self.prefill_chunk:
                        # Only CONSECUTIVE short requests join a group.
                        run = 0
                        for p in self._pending:
                            if len(p.row) > self.prefill_chunk or run >= n:
                                break
                            run += 1
                        n = run
                    if self.kv_layout == 'paged':
                        # Admit only requests whose reservation fits the
                        # allocatable pool; a later share HIT also ends
                        # the group (it heads the queue next turn).
                        avail = self._blocks_avail()
                        run = 0
                        for p in self._pending:
                            if run >= n:
                                break
                            if (run > 0 and self._trie is not None
                                    and (p.max_new > 1 or p.export)
                                    and self._trie.match(p.row)[0]):
                                break
                            nb = (self._blocks_needed(p)
                                  if p.max_new > 1 or p.export else 0)
                            if nb > avail:
                                break
                            avail -= nb
                            run += 1
                        n = run
                    if n == 0:
                        return
                    g = 1
                    while g * 2 <= n:
                        g *= 2
                    reqs = [self._pending.popleft() for _ in range(g)]
                    # Mid-prefill requests live in NO other structure: a
                    # failure here must still fail their futures.
                    self._admitting = reqs
            if shared is not None:
                self._admit_shared(*shared)
                with self._lock:
                    self._admitting = []
                blackbox.record('engine.admit', n=1, shared=True,
                                prompt_len=len(shared[0].row))
                continue
            self._prefill_group(reqs, free[:g])
            with self._lock:
                self._admitting = []
            blackbox.record('engine.admit', n=len(reqs), shared=False,
                            prompt_len=max(len(r.row) for r in reqs))

    def _match_head(self):
        """Under the lock: look the queue's head up in the share trie and
        the tier index. Returns (shared, parked_on_fetch): ``shared`` is
        the ``_admit_shared`` arguments of a hit that has its slot and
        blocks (pinned and allocated here), ``'wait'`` for a hit that
        must wait for them (FIFO: younger requests do not jump it), or
        None for a miss; ``parked_on_fetch`` is True when the head left
        the queue to wait on a background spill fetch."""
        if (self._trie is None or not self._pending
                or (self._pending[0].max_new <= 1
                    and not self._pending[0].export)):
            return None, False
        head = self._pending[0]
        nodes, partial, plen = self._trie.match(head.row)
        promote: list = []
        if self._tiers_on:
            promote, parked = self._decide(
                lambda: self._tier_admission(head, nodes))
            if parked:
                head.tier_parks += 1
                self.tier_counts['parked'] += 1
                self._pending.popleft()
                self._tier_waiting.append(head)
                return None, True
        if promote:
            # The promoted chain covers >= one full block past the trie
            # match: more than any partial-tail fork donor could.
            partial, plen = None, 0
        if not (nodes or promote):
            return None, False
        free_s = [i for i, r in enumerate(self._slot_req) if r is None]
        pk = sum(1 for e in self._prefilling if e.parked)
        need = self._blocks_needed(head) - len(nodes)
        # The matched chain's IDLE blocks are about to be pinned, so they
        # are not allocatable supply for this same admission.
        pinned = sum(1 for nd in nodes if nd.refs == 0)
        p_idle = int(partial is not None and partial.refs == 0)
        if self._blocks_avail() - pinned - p_idle < need \
                and partial is not None:
            # The fork donor is pure upside: drop it before parking the
            # whole queue on its pin.
            partial, plen, p_idle = None, 0, 0
        if len(free_s) - pk <= 0 \
                or self._blocks_avail() - pinned - p_idle < need:
            return 'wait', False
        # Pin the matched chain (and the fork donor) BEFORE allocating:
        # eviction must not reclaim blocks this admission uses.
        for nd in nodes:
            self._trie.acquire(nd)
        if partial is not None:
            self._trie.acquire(partial)
        owned = self._alloc_blocks(need, head.trace_parent)
        slot = free_s[0]
        self._pending.popleft()
        self._slot_req[slot] = head
        self._slot_blocks[slot] = list(owned)
        self._slot_shared[slot] = list(nodes)
        self._admitting = [head]
        # Claim the host-tier entries LAST (validated and popped): a
        # backpressure return above must not have consumed them. A corrupt
        # entry truncates the promoted head; the owned blocks serve the
        # tail. Under a mesh the other ranks learn only how many blocks
        # the head promotes, and get their heads of them in
        # ``_admit_shared``.
        pro = []
        if promote:
            taken = self._decide(
                lambda: self._kv_tiers.take_for_promote(promote), len)
            pro = taken if self._head else [None] * taken
            self.tier_counts['promoted'] += len(pro)
        return (head, slot, nodes, partial, plen, owned, pro), False

    def _tier_admission(self, head: _Request, nodes: list) -> tuple:
        """The head's tier consult for the queue's head (``_match_head``,
        under the lock): returns (digests to promote, whether the request
        parks on a spill fetch), after asking for any fetch."""
        promote, fetch = self._tier_consult(head.row, nodes)
        if fetch and not nodes and not promote and head.tier_parks < 2:
            # Whole chain cold on disk: park THIS request on a bounded
            # background fetch (younger requests keep admitting);
            # completion re-queues it at the head. Saturation or repeated
            # parks degrade to a plain miss.
            if self._kv_tiers.request_fetch(fetch, self._tier_fetch_done,
                                            parent=head.trace_parent):
                return promote, True
        elif fetch:
            # Partial warmth: admit with what is resident now and warm
            # the spilled tail for next time.
            self._kv_tiers.request_fetch(fetch, self._tier_fetch_done,
                                         parent=head.trace_parent)
        return promote, False

    def _admit_shared(self, req: _Request, slot: int, nodes: list,
                      partial, plen: int, owned: List[int],
                      pro: Optional[list] = None) -> None:
        """Admit ONE block-share hit: the table head points at the shared
        blocks (referenced by ``_match_head``), host-tier promotes
        (``pro``, validated planes, one per block) scatter into the
        leading owned blocks, a partially matched tail block is forked
        copy-on-write into the next owned block, and only the unshared
        tail prefills, directly over the pool. Every step is issued on
        the engine's stream in that order."""
        t0 = time.perf_counter()
        had_active = any(r is not None and r is not req
                         for r in self._slot_req)
        p = self.kv_block
        row = req.row
        pro = pro or []
        dev = self.device
        covered = (len(nodes) + len(pro)) * p + plen
        mb = self.max_len // p
        table = np.zeros((mb,), np.int32)
        table[:len(nodes)] = [nd.block for nd in nodes]
        table[len(nodes):len(nodes) + len(owned)] = owned
        with self._lock:
            self._slot_table[slot] = table.copy()
        if pro:
            tw0 = time.time()
            # Promote: scatter the demoted chain's planes into the first
            # len(pro) owned blocks, pow2-padded with junk-sink ids (the
            # zeros of the padding land in block 0 only), and install the
            # table and covered length (the tail prefill below overwrites
            # both with the final values).
            nbp = 1
            while nbp < len(pro):
                nbp *= 2
            blocks = np.zeros((nbp,), np.int64)
            blocks[:len(pro)] = owned[:len(pro)]
            cfg = self.cfg
            shp = (cfg.n_layers, nbp, cfg.n_kv_heads, p, cfg.head_dim)
            kdt = self._cache.k.dtype
            on_dev = {}
            for name in ('k', 'v') + (('k_s', 'v_s') if self.kv_quantize
                                      else ()):
                code = name in ('k', 'v')
                dt = kdt if code else torch.float32
                shape = shp if code else shp[:-1]
                whole = None
                if self._head:  # the tier's whole planes; scattered below
                    arr = np.zeros(shape, _host_dtype(dt))
                    for j, planes in enumerate(pro):
                        arr[:, j] = planes[name]
                    whole = _to_device(arr, dev, dt)
                on_dev[name] = self._heads_from_head(whole, shape, dt)
            _import_blocks(self._cache, on_dev['k'], on_dev['v'],
                           on_dev.get('k_s'), on_dev.get('v_s'),
                           _to_device(blocks, dev),
                           _to_device(table, dev), slot, covered)
            trace_lib.add_span('serve.kv_promote', tw0, time.time(),
                               parent=req.trace_parent,
                               blocks=len(pro), tokens=len(pro) * p)
        if partial is not None:
            # The first append past the shared partial block forks it:
            # copy the donor into our next owned block; the tail prefill
            # then writes from in-block offset ``plen``.
            _fork_block(self._cache, partial.block, owned[0])
        suffix = row[covered:]
        # The padded width must not overhang max_len: positions past the
        # table CLIP to its last entry, which with a full reservation is
        # the request's own live block. Room always suffices: submit
        # checks row + max_new <= max_len.
        w = min(prompt_bucket(len(suffix)), self.max_len - covered)
        padded = np.zeros((1, w), np.int32)
        padded[0, :len(suffix)] = suffix
        logits = _prefill_shared(
            self.cfg, self.params, self._cache, _to_device(padded, dev),
            _to_device(table[None], dev), slot,
            _to_device(np.asarray([covered], np.int32), dev),
            _to_device(np.asarray([len(suffix)], np.int32), dev),
            mesh=self._whole)
        first = _sample(logits, *self._sampling_args(
            np.asarray([req.temperature], np.float32),
            np.asarray([req.top_k], np.int32),
            np.asarray([req.top_p], np.float32)))
        self._last[slot] = first[0]
        self._limit[slot] = self._limit_for(req)
        with self._lock:
            if partial is not None:
                # The fork donor was pinned only across the copy; it
                # returns to the idle LRU.
                freed = self._trie.release(partial)
                if freed is not None:
                    self._free_blocks.append(freed)
                self.cow_forks += 1
            self._commit_prompt_blocks(slot, row, nodes)
            self._unfetched.append(([req], _HostCopy(first)))
            self.prefills += 1
            self.prefill_groups += 1
            self.share_hits += 1
            self.share_hit_tokens += covered
            self.prefill_tokens += len(suffix)
            self.prefill_tokens_saved += covered
        self._note_prefill_time(t0, had_active)

    def _commit_prompt_blocks(self, slot: int, row: List[int],
                              shared_nodes: list) -> None:
        """Index the slot's full PROMPT blocks in the share trie (caller
        holds the lock). Ownership transfers: committed blocks leave
        ``_slot_blocks`` for the refcounted ``_slot_shared``. Duplicate
        content (an identical commit that won the race, or a chunked long
        prefill that COPIED its matched head) keeps our copy owned and
        chains deeper commits under the existing node."""
        if self._trie is None:
            return
        p = self.kv_block
        nb_commit = len(row) // p  # only blocks fully inside the prompt
        base = len(shared_nodes)
        if nb_commit <= base:
            return
        owned = self._slot_blocks[slot]
        idx_block = {base + j: b for j, b in enumerate(owned)}
        parent = shared_nodes[-1] if shared_nodes else None
        for i in range(base, nb_commit):
            key = tuple(row[i * p:(i + 1) * p])
            existing = self._trie.child(parent, key)
            if existing is not None:
                parent = existing
                continue
            blk = idx_block[i]
            node = self._trie.commit(parent, key, blk)
            owned.remove(blk)
            self._slot_shared[slot].append(node)
            self.share_commits += 1
            parent = node

    def _note_prefill_time(self, t0: float, had_active: bool) -> None:
        """Host wall time spent issuing prefill work, and the slice of it
        decode provably waited on (active slots, nothing in flight)."""
        dt_ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self.prefill_ms += dt_ms
            if had_active and self._inflight is None:
                self.prefill_bubble_ms += dt_ms

    def _match_prefix(self, row: List[int]):
        """Longest cached prefix of ``row`` at power-of-two lengths
        STRICTLY shorter than the prompt (the last prompt token must be
        prefilled to produce the first logits). Returns (p, pool_row)."""
        best = (0, 0)
        b = self.prefix_min
        while b <= len(row) - 1:
            slot = self._prefix_index.get(tuple(row[:b]))
            if slot is not None:
                best = (b, slot)
                self._prefix_index.move_to_end(tuple(row[:b]))  # LRU
            b *= 2
        return best

    def _maybe_store_prefixes(self, rows, p_lens,
                              cache_n: gen_lib.KVCache) -> None:
        """Store each row's largest bucket prefix on its SECOND sighting
        (a pool row is too precious for one-shot prompts); LRU-evict
        when full. Issued after the prefill that wrote ``cache_n`` and
        before the insert, on the same stream."""
        for i, row in enumerate(rows):
            p = self.prefix_min
            while p * 2 <= len(row):
                p *= 2
            if p > len(row) or p < self.prefix_min:
                continue
            if p_lens[i] >= p:
                continue  # the hit already covers this prefix
            key = tuple(row[:p])
            if key in self._prefix_index:
                continue
            self._prefix_seen[key] = self._prefix_seen.get(key, 0) + 1
            self._prefix_seen.move_to_end(key)
            while len(self._prefix_seen) > 512:
                self._prefix_seen.popitem(last=False)
            if self._prefix_seen[key] < 2:
                continue
            if self._prefix_free:
                slot = self._prefix_free.pop()
            else:
                _, slot = self._prefix_index.popitem(last=False)  # LRU
            self._store_prefix(cache_n, i, slot, p)
            self._prefix_index[key] = slot
            with self._lock:
                self.prefix_stores += 1

    def _gather_prefix(self, pool_rows: List[int], p_lens: List[int],
                       width: int) -> gen_lib.KVCache:
        """``_gather_prefix_impl`` of pool rows ``pool_rows`` (host ints):
        where the pool holds a block of its rows on each data rank, each
        row comes from its holder, summed over ``data``."""
        dev = self.device
        lens = _to_device(np.asarray(p_lens, np.int32), dev)
        blk = gen_lib.data_rows(self.mesh, self.prefix_slots)
        if blk is None:
            return _gather_prefix(
                self._prefix_pool,
                _to_device(np.asarray(pool_rows, np.int64), dev), lens,
                width)
        rows = np.asarray(pool_rows, np.int64)
        mine = (rows >= blk.start) & (rows < blk.stop)
        return _gather_prefix(
            self._prefix_pool,
            _to_device(np.where(mine, rows - blk.start, 0), dev), lens,
            width, _to_device(mine, dev), self.mesh)

    def _store_prefix(self, cache_n: gen_lib.KVCache, row: int, slot: int,
                      p: int) -> None:
        """``_store_prefix_impl`` into pool row ``slot``, on the data rank
        whose block of the pool holds it."""
        blk = gen_lib.data_rows(self.mesh, self.prefix_slots)
        if blk is None:
            _store_prefix(self._prefix_pool, cache_n, row, slot, p)
        elif blk.start <= slot < blk.stop:
            _store_prefix(self._prefix_pool, cache_n, row,
                          slot - blk.start, p)

    def _prefill_one_chunk(self, params, cfg: llama.LlamaConfig,
                           cache1: gen_lib.KVCache, row: List[int],
                           consumed: int):
        """One bounded chunk of a single-row incremental prefill of the
        target (or, spec mode, the draft). Returns (logits, cache,
        new_consumed). The padded width may not overhang max_len (the
        cache write would raise); room always suffices, as the prompt is
        < max_len (``submit`` validates row + max_new <= max_len)."""
        w = min(self.prefill_chunk, self.max_len - consumed)
        chunk = row[consumed:consumed + w]
        padded = np.zeros((1, w), np.int32)
        padded[0, :len(chunk)] = chunk
        dev = self.device
        logits, cache1 = _prefill(
            params, _to_device(padded, dev), cache1, cfg,
            _to_device(np.asarray([len(chunk)], np.int32), dev),
            mesh=self._whole)
        if params is self.params:  # the draft's chunks do not count
            with self._lock:
                self.prefill_tokens += len(chunk)
        return logits, cache1, consumed + len(chunk)

    def _advance_prefill(self) -> None:
        if not self._prefilling:
            return
        t0 = time.perf_counter()
        had_active = any(r is not None for r in self._slot_req)
        try:
            self._advance_prefill_impl()
        finally:
            self._note_prefill_time(t0, had_active)

    def _advance_prefill_impl(self) -> None:
        """Advance the oldest in-flight long prefill by ONE chunk (the
        per-iteration budget that bounds how long active slots wait
        between decode chunks), and in spec mode the draft's too. On the
        target's final chunk: sample the first token; insert once the
        draft has caught up and a slot frees."""
        entry = self._prefilling[0]
        req = entry.req
        spec = self.draft_cfg is not None
        dev = self.device
        # The draft advances first: it starts at 0 even when the target's
        # head came from a prefix hit (the pool stores target KV only), and
        # a parked target must not stall the draft's remaining chunks.
        if spec and entry.cache is not None \
                and entry.d_consumed < len(req.row):
            _, entry.d_cache, entry.d_consumed = self._prefill_one_chunk(
                self.draft_params, self.draft_cfg, entry.d_cache, req.row,
                entry.d_consumed)
            with self._lock:
                self.prefill_chunks += 1
        if entry.parked:
            self._finish_long_prefill(entry)
            return
        if entry.cache is None:
            # First chunk: seed from the share trie (block granularity,
            # preferred) or the prefix pool when the prompt's head is
            # cached (long popular prompts are where reuse pays).
            cache1, p_hit = None, 0
            if self._trie is not None:
                with self._lock:
                    t_nodes, _, _ = self._trie.match(req.row)
                    t_blocks = [nd.block for nd in t_nodes]
                    for nd in t_nodes:
                        self._trie.touch(nd)
                if t_blocks:
                    # Seed the dense scratch row from the shared blocks
                    # (one gather, issued before any later admission can
                    # evict them); the tail then computes only unshared
                    # tokens. The row is inserted whole at finish, so this
                    # path shares COMPUTE, not storage: its copies of the
                    # matched head dedup against the chain at commit.
                    tbl = np.zeros((self.max_len // self.kv_block,),
                                   np.int64)
                    tbl[:len(t_blocks)] = t_blocks
                    p_hit = len(t_blocks) * self.kv_block
                    cache1 = _gather_blocks(
                        self._cache, _to_device(tbl, dev),
                        _to_device(np.asarray([p_hit], np.int32), dev))
                    with self._lock:
                        self.share_hits += 1
                        self.share_hit_tokens += p_hit
                        self.prefill_tokens_saved += p_hit
                else:
                    with self._lock:
                        self.share_misses += 1
            if cache1 is None and self._prefix_pool is not None:
                p_hit, pool_row = self._match_prefix(req.row)
                if p_hit:
                    cache1 = self._gather_prefix([pool_row], [p_hit],
                                                 self.max_len)
                    with self._lock:
                        self.prefix_hits += 1
                        self.prefix_hit_tokens += p_hit
            if cache1 is None:
                cache1 = gen_lib.init_cache(self.cfg, 1, self.max_len,
                                            quantize=self.kv_quantize,
                                            device=dev, mesh=self._whole)
            entry.cache, entry.consumed = cache1, p_hit
            if spec:
                entry.d_cache = gen_lib.init_cache(
                    self.draft_cfg, 1, self.max_len,
                    quantize=self.kv_quantize, device=dev, mesh=self._whole)
        logits, entry.cache, entry.consumed = self._prefill_one_chunk(
            self.params, self.cfg, entry.cache, req.row, entry.consumed)
        with self._lock:
            self.prefill_chunks += 1
        if entry.consumed >= len(req.row):
            if self._prefix_pool is not None:
                # Store this prompt's bucket prefix on its second
                # sighting, like the grouped path.
                self._maybe_store_prefixes([req.row], [0], entry.cache)
            # Sample the first token ONCE off the final chunk's logits;
            # the entry may then park for a free slot (or, spec mode, for
            # the draft's remaining chunks).
            entry.first = _sample(logits, *self._sampling_args(
                np.asarray([req.temperature], np.float32),
                np.asarray([req.top_k], np.int32),
                np.asarray([req.top_p], np.float32)))
            # The chunked path's one host read (stop ids and the slot
            # decision need the value now): a pinned copy and its event,
            # which still follow the decode chunk in flight.
            entry.first_host = int(_HostCopy(entry.first).numpy()[0])
            self._finish_long_prefill(entry)

    def _finish_long_prefill(self, entry: _Prefilling) -> None:
        """Emit a finished long prefill's first token and insert its
        scratch row into a free slot; return without popping (PARK) when
        no slot is free, paged, the pool cannot hold its blocks, or, spec
        mode, the draft has not caught up."""
        req = entry.req
        if self.draft_cfg is not None and entry.d_consumed < len(req.row):
            return  # the draft cache is still catching up
        if req.export:
            self._finish_long_export(entry)
            return
        done = (req.max_new == 1
                or gen_lib.truncate_at_stop([entry.first_host],
                                            req.eos)[1])
        slot = None
        table_row = None
        with self._lock:
            if not done:
                free = [i for i, r in enumerate(self._slot_req)
                        if r is None]
                if not free:
                    return  # park; retried next iteration
                if self.kv_layout == 'paged':
                    nb = self._blocks_needed(req)
                    if self._blocks_avail() < nb:
                        return  # park until a completion frees blocks
                    blocks = self._alloc_blocks(nb, req.trace_parent)
                    table_row = np.zeros(
                        (self.max_len // self.kv_block,), np.int32)
                    table_row[:nb] = blocks
                    self._slot_blocks[free[0]] = list(blocks)
                    self._slot_table[free[0]] = table_row.copy()
                slot = free[0]
                self._slot_req[slot] = req
            self._prefilling.pop(0)
            self.prefills += 1
            req.tokens.append(entry.first_host)
            self.tokens_emitted += 1
        if req.on_tokens is not None:
            self._fire_callbacks([(req, [entry.first_host])])
        if done:
            if not req.future.done():
                req.future.set_result(req.tokens)
            return
        dev = self.device
        limits = _to_device(np.asarray([self._limit_for(req)], np.int32),
                            dev)
        slots = _to_device(np.asarray([slot], np.int64), dev)
        if self.kv_layout == 'paged':
            _paged_insert(self._cache, self._last, self._limit, entry.cache,
                          entry.first, limits,
                          _to_device(table_row[None], dev), slots)
            with self._lock:
                if self._slot_req[slot] is req:
                    self._commit_prompt_blocks(slot, req.row, [])
        else:
            _insert(self._cache, self._last, self._limit, entry.cache,
                    entry.first, limits, slots, self._owned([slot]))
        if self.draft_cfg is not None:
            _insert_cache(self._d_cache, entry.d_cache, slots,
                          self._owned([slot]))

    def _finish_long_export(self, entry: _Prefilling) -> None:
        """Export retirement of a chunked long prefill. The slot layout
        gathers the scratch row directly (no slot at all); paged inserts
        into pool blocks first, committing the prompt chain so that later
        sharers and later exports of the same long preamble hit the trie,
        and gathers back out. Parks (returns without popping) until a
        slot and the blocks are free, like a normal finish."""
        req = entry.req
        if self.kv_layout == 'paged':
            with self._lock:
                free = [i for i, r in enumerate(self._slot_req)
                        if r is None]
                nb = self._blocks_needed(req)
                if not free or self._blocks_avail() < nb:
                    return  # park; retried next iteration
                blocks = self._alloc_blocks(nb, req.trace_parent)
                table_row = np.zeros((self.max_len // self.kv_block,),
                                     np.int32)
                table_row[:nb] = blocks
                slot = free[0]
                self._slot_req[slot] = req
                self._slot_blocks[slot] = list(blocks)
                self._slot_table[slot] = table_row.copy()
            dev = self.device
            _paged_insert(self._cache, self._last, self._limit, entry.cache,
                          entry.first,
                          _to_device(np.asarray([self._limit_for(req)],
                                                np.int32), dev),
                          _to_device(table_row[None], dev),
                          _to_device(np.asarray([slot], np.int64), dev))
            with self._lock:
                if self._slot_req[slot] is req:
                    self._commit_prompt_blocks(slot, req.row, [])
        else:
            req.export_src = (entry.cache, 0)
        with self._lock:
            self._prefilling.pop(0)
            self.prefills += 1
        self._export_and_retire(req, entry.first_host)

    def _prefill_group(self, reqs: List[_Request],
                       slots: List[int]) -> None:
        """Prefill a group and insert it into ``slots``. With the prefix
        pool, each row's cached prefix is gathered and only its suffix
        is prefilled; gather, prefill, store and insert are issued in
        that order on the engine's stream."""
        t0 = time.perf_counter()
        had_active = any(r is not None for r in self._slot_req)
        n = len(reqs)
        dev = self.device
        rows = [r.row for r in reqs]
        p_lens = [0] * n
        pool_rows = [0] * n
        if self._prefix_pool is not None:
            for i, row in enumerate(rows):
                p_lens[i], pool_rows[i] = self._match_prefix(row)
            # Demote any hit whose prefix + PADDED suffix would overflow
            # the cache width: the write would raise past max_len (JAX's
            # would clamp, smearing padded junk over real prefix KV).
            while True:
                s_b = min(prompt_bucket(max(
                    len(r) - p for r, p in zip(rows, p_lens))),
                    self.max_len)
                bad = [i for i in range(n)
                       if p_lens[i] and p_lens[i] + s_b > self.max_len]
                if not bad:
                    break
                for i in bad:
                    p_lens[i], pool_rows[i] = 0, 0
        suffixes = [row[p:] for row, p in zip(rows, p_lens)]
        width_s = min(prompt_bucket(max(len(s) for s in suffixes)),
                      self.max_len)
        cache_width = min(prompt_bucket(
            max(p + width_s for p in p_lens)), self.max_len)
        padded = np.zeros((n, width_s), np.int32)
        lens = np.zeros((n,), np.int32)
        temps = np.zeros((n,), np.float32)
        top_ks = np.zeros((n,), np.int32)
        top_ps = np.ones((n,), np.float32)
        for i, (r, suf) in enumerate(zip(reqs, suffixes)):
            padded[i, :len(suf)] = suf
            lens[i] = len(suf)
            temps[i] = r.temperature
            top_ks[i] = r.top_k
            top_ps[i] = r.top_p
        hits = sum(1 for p in p_lens if p)
        if hits:
            cache_n = self._gather_prefix(pool_rows, p_lens, cache_width)
            with self._lock:
                self.prefix_hits += hits
                self.prefix_hit_tokens += sum(p_lens)
        else:
            cache_n = gen_lib.init_cache(self.cfg, n, cache_width,
                                         quantize=self.kv_quantize,
                                         device=dev, mesh=self._whole)
        logits, cache_n = _prefill(self.params, _to_device(padded, dev),
                                   cache_n, self.cfg, _to_device(lens, dev),
                                   mesh=self._whole)
        with self._lock:
            self.prefill_tokens += int(lens.sum())
            self.prefill_tokens_saved += sum(p_lens)
        if self._prefix_pool is not None:
            self._maybe_store_prefixes(rows, p_lens, cache_n)
        firsts = _sample(logits, *self._sampling_args(temps, top_ks,
                                                      top_ps))
        # Insert EVERY row (a single-token request's row becomes harmless
        # junk in a still-free slot: its limit equals its length, so it is
        # never active). The first-token VALUES are read lazily
        # (_drain_firsts), while the next decode chunk computes. A row's
        # limit counts its whole prompt, prefix included.
        limits = _to_device(np.asarray(
            [self._limit_for(r) for r in reqs], np.int32), dev)
        slots_d = _to_device(np.asarray(slots, np.int64), dev)
        if self.kv_layout == 'paged':
            mb = self.max_len // self.kv_block
            tables_host = np.zeros((n, mb), np.int32)
            with self._lock:
                for i, r in enumerate(reqs):
                    if r.max_new <= 1 and not r.export:
                        continue  # resolves at prefill: junk-sink row
                    # An export takes blocks even at max_new 1: the
                    # handoff gathers from the pool.
                    nb = self._blocks_needed(r)
                    # _admit reserved them
                    blocks = self._alloc_blocks(nb, r.trace_parent)
                    self._slot_blocks[slots[i]] = blocks
                    tables_host[i, :nb] = blocks
                    self._slot_table[slots[i]] = tables_host[i].copy()
            _paged_insert(self._cache, self._last, self._limit, cache_n,
                          firsts, limits, _to_device(tables_host, dev),
                          slots_d)
            if self._trie is not None:
                # Index the group's full prompt blocks for later sharers
                # (the insert above was issued first, so any later gather
                # of these blocks follows their content on the stream).
                with self._lock:
                    for i, r in enumerate(reqs):
                        if r.max_new > 1 or r.export:
                            self._commit_prompt_blocks(slots[i], rows[i],
                                                       [])
                            self.share_misses += 1
        else:
            _insert(self._cache, self._last, self._limit, cache_n, firsts,
                    limits, slots_d, self._owned(slots))
        if self.draft_cfg is not None:
            # The draft tracks the same committed stream, so it prefills
            # the FULL rows (the prefix pool stores target KV only; the
            # draft is small enough that re-prefilling a cached head costs
            # little).
            width_f = min(prompt_bucket(max(len(r) for r in rows)),
                          self.max_len)
            padded_f = np.zeros((n, width_f), np.int32)
            lens_f = np.zeros((n,), np.int32)
            for i, r in enumerate(rows):
                padded_f[i, :len(r)] = r
                lens_f[i] = len(r)
            d_cache_n = gen_lib.init_cache(self.draft_cfg, n, width_f,
                                           quantize=self.kv_quantize,
                                           device=dev, mesh=self._whole)
            _, d_cache_n = _prefill(self.draft_params,
                                    _to_device(padded_f, dev), d_cache_n,
                                    self.draft_cfg, _to_device(lens_f, dev),
                                    mesh=self._whole)
            _insert_cache(self._d_cache, d_cache_n, slots_d,
                          self._owned(slots))
        with self._lock:
            self.prefills += n
            self.prefill_groups += 1
            self._unfetched.append((reqs, _HostCopy(firsts)))
            for i, req in enumerate(reqs):
                if req.export and self.kv_layout != 'paged':
                    # A slot-layout export is gathered straight from the
                    # prefill cache at the drain: no slot occupancy.
                    req.export_src = (cache_n, i)
                elif req.max_new > 1 or req.export:
                    # Paged exports hold their slot and blocks until the
                    # drain gathers them out of the pool.
                    self._slot_req[slots[i]] = req
        self._note_prefill_time(t0, had_active)

    def _drain_firsts(self) -> None:
        """Read deferred first tokens. MUST run before a chunk's emission
        so every admitted request's token list starts with its prefill
        token; also completes single-token requests."""
        with self._lock:
            batches = self._unfetched
            self._unfetched = []
        done: List[_Request] = []
        emitted: List[tuple] = []
        exports: List[tuple] = []
        for reqs, firsts in batches:
            firsts_host = firsts.numpy()
            self._fold_sampled(firsts_host)
            with self._lock:
                for i, req in enumerate(reqs):
                    first = int(firsts_host[i])
                    if req.export:
                        # The prefill role's retirement: the first token
                        # rides the handoff, nothing is emitted, and the
                        # gather (and its wait) runs outside the lock.
                        exports.append((req, first))
                        continue
                    req.tokens.append(first)
                    self.tokens_emitted += 1
                    if req.on_tokens is not None:
                        emitted.append((req, [first]))
                    first_is_eos = gen_lib.truncate_at_stop(
                        [first], req.eos)[1]
                    if first_is_eos or len(req.tokens) >= req.max_new:
                        done.append(req)
                        if first_is_eos:
                            # The slot was occupied at admission (only
                            # max_new == 1 requests skip occupancy).
                            for si, r in enumerate(self._slot_req):
                                if r is req:
                                    self._slot_req[si] = None
                                    self._release_blocks(si)
                                    break
        self._fire_callbacks(emitted)
        for req in done:
            if not req.future.done():
                req.future.set_result(req.tokens)
        for req, first in exports:
            self._export_and_retire(req, first)

    # -- disaggregated prefill/decode handoff (serve/disagg.py) ------------

    def _export_and_retire(self, req: _Request, first: int) -> None:
        """Resolve an export with its ``PrefillHandoff`` and free its slot
        and blocks. A failed gather fails THIS request alone; the engine
        keeps serving."""
        t0 = time.perf_counter()
        err = None
        try:
            handoff = self._build_handoff(req, first)
        except collectives.CollectiveError:
            raise  # the ranks' lockstep is lost: serve/spmd.py ends it
        except Exception as exc:  # noqa: BLE001 -- isolate per request
            handoff, err = None, exc
        with self._lock:
            for si, r in enumerate(self._slot_req):
                if r is req:
                    self._slot_req[si] = None
                    self._release_blocks(si)
                    break
            req.export_src = None  # drop the prefill cache's reference
            self.export_ms += (time.perf_counter() - t0) * 1e3
            if handoff is not None:
                self.exports += 1
        if handoff is None:
            if not req.future.done():
                req.future.set_exception(err)
            return
        if not req.future.done():
            req.future.set_result(handoff)

    def _build_handoff(self, req: _Request, first: int) -> PrefillHandoff:
        """The prompt's planes, read off the device: the slot layout's
        row of the prefill cache, or the paged slot's blocks through ONE
        ``paged.export_blocks`` gather over a pow2-padded table. Issued on
        the stream before the slot's blocks are released, so any later
        write to them follows the gather; the host copies are pinned and
        read through ``_HostCopy``, the export's one wait, outside the
        lock. Under a mesh each plane's KV heads are gathered to the head
        first (a collective of the engine thread), so the handoff carries
        whole heads, JAX's format; the other ranks' handoffs carry no
        planes."""
        n = len(req.row)
        base = dict(row=list(req.row), first=int(first),
                    max_new=req.max_new, temperature=req.temperature,
                    top_k=req.top_k, top_p=req.top_p, eos=req.eos,
                    prompt_len=n)
        if self.kv_layout != 'paged':
            cache_n, i = req.export_src  # kept by _prefill_group
            planes = [cache_n.k[:, i:i + 1, :, :n],
                      cache_n.v[:, i:i + 1, :, :n]]   # [L, 1, H, n, D]
            if cache_n.quantized:
                planes += [cache_n.k_s[:, i:i + 1, :, :n],
                           cache_n.v_s[:, i:i + 1, :, :n]]
            k, v, k_s, v_s = self._host_planes(planes)
            return PrefillHandoff(layout='slot', k=k, v=v, k_s=k_s,
                                  v_s=v_s, **base)
        p = self.kv_block
        nb = -(-n // p)
        with self._lock:
            slot = next((si for si, r in enumerate(self._slot_req)
                         if r is req), None)
            table = self._slot_table[slot] if slot is not None else None
        if table is None:
            raise RuntimeError('export request lost its slot before '
                               'its planes were gathered')
        nbp = 1
        while nbp < nb:
            nbp *= 2  # pow2-padded gather: log2(MB) shapes
        tbl = np.zeros((nbp,), np.int64)
        tbl[:nb] = table[:nb]
        planes = [t[:, :nb] for t in _export_blocks(
            self._cache, _to_device(tbl, self.device)) if t is not None]
        k, v, k_s, v_s = self._host_planes(planes)
        return PrefillHandoff(layout='paged', block=p, n_blocks=nb,
                              k=k, v=v, k_s=k_s, v_s=v_s, **base)

    def _host_planes(self, planes: list) -> list:
        """(k, v, k_s, v_s) of an export on the host, the scales None
        for a bf16 cache: each plane's heads gathered to the head, all
        copies issued before the first read. Nones off the head."""
        whole = [self._heads_to_head(t) for t in planes]
        if not self._head:
            return [None] * 4
        copies = [_HostCopy(t) for t in whole]
        return ([_host_plane(c, t.dtype) for c, t in zip(copies, whole)]
                + [None, None])[:4]

    def _admit_imports(self) -> None:
        """Install queued imported prompts (decode-role admission), FIFO.
        Each head needs a free slot and its FULL block reservation (prompt
        + max_new: the decode side owns the generation budget); a head
        that cannot admit parks the import queue, the decode pool's
        backpressure (``queued_imports``). The leading chain the share
        trie holds installs as table REFERENCES; only new blocks
        scatter. A head whose negotiated references were evicted fails
        alone with ``KVImportError``."""
        while True:
            t0 = time.perf_counter()
            doomed = None
            with self._lock:
                if not self._pending_imports:
                    return
                entry = self._pending_imports[0]
                req = entry.req
                first_is_eos = gen_lib.truncate_at_stop(
                    [entry.first], req.eos)[1]
                trivial = first_is_eos or req.max_new <= 1
                slot = None
                nodes: list = []
                table_row = None
                if not trivial:
                    free = [i for i, r in enumerate(self._slot_req)
                            if r is None]
                    parked = sum(1 for e in self._prefilling if e.parked)
                    if len(free) - parked <= 0:
                        return  # backpressure: the head waits
                    slot = free[0]
                    if self.kv_layout == 'paged':
                        n = len(req.row)
                        p = self.kv_block
                        if self._trie is not None:
                            nodes, _, _ = self._trie.match(
                                req.row, limit=(n // p) * p)
                        if len(nodes) < entry.block_start:
                            # Blocks negotiated away as references were
                            # evicted between prepare and import.
                            self._pending_imports.popleft()
                            self.import_errors += 1
                            doomed = req
                        else:
                            need = (self._blocks_for(n, req.max_new)
                                    - len(nodes))
                            pinned = sum(1 for nd in nodes
                                         if nd.refs == 0)
                            if self._blocks_avail() - pinned < need:
                                return  # backpressure: the head waits
                            for nd in nodes:
                                self._trie.acquire(nd)
                            owned = self._alloc_blocks(need,
                                                       req.trace_parent)
                            table_row = np.zeros(
                                (self.max_len // p,), np.int32)
                            table_row[:len(nodes)] = [nd.block
                                                      for nd in nodes]
                            table_row[len(nodes):len(nodes) + len(owned)] \
                                = owned
                            self._slot_blocks[slot] = list(owned)
                            self._slot_shared[slot] = list(nodes)
                            self._slot_table[slot] = table_row.copy()
                    if doomed is None:
                        self._slot_req[slot] = req
                        self._pending_imports.popleft()
                else:
                    self._pending_imports.popleft()
            if doomed is not None:
                if not doomed.future.done():
                    doomed.future.set_exception(KVImportError(
                        'handoff blocks negotiated as shared references '
                        'were evicted before import'))
                continue
            if trivial:
                req.tokens.append(entry.first)
                with self._lock:
                    self.tokens_emitted += 1
                    self.imports += 1
                if req.on_tokens is not None:
                    self._fire_callbacks([(req, [entry.first])])
                if not req.future.done():
                    req.future.set_result(req.tokens)
                continue
            # The device install runs outside the lock: submit() must not
            # wait on it.
            if self.kv_layout == 'paged':
                self._install_import_paged(entry, slot, nodes, table_row)
            else:
                self._install_import_dense(entry, slot)
            with self._lock:
                if self._slot_req[slot] is req:
                    self._commit_prompt_blocks(slot, req.row, nodes)
                if self._trie is not None:
                    if nodes:
                        self.share_hits += 1
                        self.share_hit_tokens += len(nodes) * self.kv_block
                    else:
                        self.share_misses += 1
                req.tokens.append(entry.first)
                self.tokens_emitted += 1
                self.imports += 1
                self.import_ms += (time.perf_counter() - t0) * 1e3
            if req.on_tokens is not None:
                self._fire_callbacks([(req, [entry.first])])

    def _install_import_paged(self, entry: _ImportEntry, slot: int,
                              nodes: list, table_row: np.ndarray) -> None:
        """Scatter the transferred prompt blocks into the pool and install
        the slot's table, length, last token and write limit: one
        ``paged.import_blocks`` over a pow2-padded block list (padding
        and, when the whole chain is shared, the one zero block land in
        the junk sink). Blocks below the local share point install as
        references; their transferred bytes, if any, are ignored. Under
        a mesh the head holds the planes (whole heads) and scatters each
        rank its own."""
        req = entry.req
        n = len(req.row)
        p = self.kv_block
        dev = self.device
        nb_prompt = -(-n // p)
        start = max(len(nodes), entry.block_start)
        ids = table_row[start:nb_prompt]
        nbp = 1
        while nbp < max(len(ids), 1):
            nbp *= 2
        blocks = np.zeros((nbp,), np.int64)  # pad -> junk sink
        blocks[:len(ids)] = ids
        cfg = self.cfg
        shp = (cfg.n_layers, nbp, cfg.n_kv_heads, p, cfg.head_dim)
        lo = start - entry.block_start
        hi = nb_prompt - entry.block_start
        # The pool's dtype, not the entry's: a handoff whose whole chain
        # is shared carries no planes at all.
        on_dev = []
        for name in ('k', 'v', 'k_s', 'v_s'):
            scale = name in ('k_s', 'v_s')
            if scale and not self.kv_quantize:
                on_dev.append(None)
                continue
            want = torch.float32 if scale else self._cache.k.dtype
            shape = shp[:-1] if scale else shp
            t = None
            if self._head:
                src = getattr(entry, name) if len(ids) else None
                if src is None:
                    pad = np.zeros(shape, _host_dtype(want))
                    tdt = want
                else:
                    words, tdt = _plane_words(src)
                    pad = np.zeros(shape, words.dtype)
                    pad[:, :len(ids)] = words[:, lo:hi]
                t = _to_device(pad, dev, tdt)
                t = t if t.dtype == want else t.to(want)
            on_dev.append(self._heads_from_head(t, shape, want))
        _import_blocks(self._cache, *on_dev, _to_device(blocks, dev),
                       _to_device(table_row, dev), slot, n)
        self._last[slot] = entry.first
        self._limit[slot] = self._limit_for(req)

    def _install_import_dense(self, entry: _ImportEntry,
                              slot: int) -> None:
        """Slot-layout install: a 1-row prefill cache rebuilt from the
        transferred planes, inserted like a local prefill's row (under a
        mesh the head scatters each rank its heads of the planes)."""
        req = entry.req
        n = len(req.row)
        dev = self.device
        w = min(prompt_bucket(n), self.max_len)
        kdt = self._cache.k.dtype
        cfg = self.cfg
        tensors = {}
        for name in ('k', 'v', 'k_s', 'v_s'):
            scale = name in ('k_s', 'v_s')
            if scale and not self.kv_quantize:
                tensors[name] = None
                continue
            want = torch.float32 if scale else kdt
            shape = (cfg.n_layers, 1, cfg.n_kv_heads, w) + (
                () if scale else (cfg.head_dim,))
            t = None
            if self._head:
                words, tdt = _plane_words(getattr(entry, name))
                pad = np.zeros(shape, words.dtype)
                pad[:, :, :, :n] = words
                t = _to_device(pad, dev, tdt)
                t = t if t.dtype == want else t.to(want)
            tensors[name] = self._heads_from_head(t, shape, want)
        cache_n = gen_lib.KVCache(
            k=tensors['k'], v=tensors['v'],
            lengths=_to_device(np.asarray([n], np.int32), dev),
            k_s=tensors['k_s'], v_s=tensors['v_s'])
        _insert(self._cache, self._last, self._limit, cache_n,
                _to_device(np.asarray([entry.first], np.int32), dev),
                _to_device(np.asarray([self._limit_for(req)], np.int32),
                           dev),
                _to_device(np.asarray([slot], np.int64), dev),
                self._owned([slot]))

    def _run_spec_round(self) -> None:
        """One draft-propose / target-verify round over all slots (spec
        mode's decode step). Greedy slots commit their accepted prefix and
        the target's correction; sampled slots one token drawn from the
        verify's position-0 logits; free slots one target token (as a
        decode step would). Both caches then roll back per row to their
        committed lengths. Serial: the round's one host read waits for it,
        and the device idles through the bookkeeping (``bubble_ms``)."""
        with self._lock:
            reqs = list(self._slot_req)
        k = self.spec_k
        temps = np.zeros((self.slots,), np.float32)
        top_ks = np.zeros((self.slots,), np.int32)
        top_ps = np.ones((self.slots,), np.float32)
        occupied = np.zeros((self.slots,), bool)
        for i, r in enumerate(reqs):
            if r is not None:
                temps[i] = r.temperature
                top_ks[i] = r.top_k
                top_ps[i] = r.top_p
                occupied[i] = True
        now = time.perf_counter()
        with self._lock:
            self.peak_active = max(self.peak_active, int(occupied.sum()))
            if self._no_flight_since is not None:
                self.bubble_ms += (now - self._no_flight_since) * 1e3
                self._no_flight_since = None
            self.dispatches += 1
        temps_d, gen, tk, tp = self._sampling_args(temps, top_ks, top_ps)
        self._cache, self._d_cache, out = _spec(
            self.cfg, self.draft_cfg, k, self.params, self.draft_params,
            self._cache, self._d_cache, self._last, self._limit,
            _to_device(occupied, self.device), temps_d, tk, tp, gen,
            mesh=self.mesh)
        # ONE transfer for the round's props, tgt and samp.
        out = _HostCopy(out)
        # First tokens first, while the round computes: emission counts on
        # every admitted request's list already holding its prefill token.
        self._drain_firsts()
        host = out.numpy()
        t0 = time.perf_counter()
        props_h, tgt_h, samp_h = (host[:, :k + 1], host[:, k + 1:2 * k + 2],
                                  host[:, 2 * k + 2])
        committed = np.ones((self.slots,), np.int32)
        new_last = tgt_h[:, 0].astype(np.int32).copy()  # free-slot default
        done: List[_Request] = []
        emitted: List[tuple] = []
        with self._lock:
            self.spec_rounds += 1
            self.chunks_run += 1
            for i, req in enumerate(reqs):
                if req is None or self._slot_req[i] is not req \
                        or req.future.done() or req.export:
                    continue  # a free slot's junk, or an export's
                a = None
                if req.temperature == 0.0:
                    a = 0
                    while a < k and props_h[i, a] == tgt_h[i, a]:
                        a += 1
                    new = [int(t) for t in props_h[i, :a]]
                    new.append(int(tgt_h[i, a]))
                    committed[i] = a + 1
                    new_last[i] = int(tgt_h[i, a])
                else:
                    # Exactly one plain decode step per round: greedy
                    # acceptance would skew the sampling distribution.
                    new = [int(samp_h[i])]
                    new_last[i] = int(samp_h[i])
                new = new[:req.max_new - len(req.tokens)]
                new, hit_eos = gen_lib.truncate_at_stop(new, req.eos)
                self._fold_sampled(new)
                if a is not None:
                    # Counted after the clamp and the stop: a round cut
                    # inside its accepted prefix proposed and accepted
                    # only what it emitted. JAX counts k and a before the
                    # cut (ROADMAP, faults of the reference).
                    cut = len(new) < a + 1
                    self.spec_proposals += len(new) if cut else k
                    self.spec_accepted += len(new) if cut else a
                req.tokens.extend(new)
                self.tokens_emitted += len(new)
                if req.on_tokens is not None and new:
                    emitted.append((req, new))
                if hit_eos or len(req.tokens) >= req.max_new:
                    self._slot_req[i] = None
                    self._release_blocks(i)
                    done.append(req)
        # Rollback: both models advanced k+1; each row keeps `committed`.
        dev = self.device
        adj = _to_device(np.int32(k + 1) - committed, dev)
        # The paged pool's lengths are whole; the dense caches hold this
        # rank's block of the slots.
        _rewind(self._cache, adj if self.kv_layout == 'paged'
                else self._own_rows(adj))
        _rewind(self._d_cache, self._own_rows(adj))
        self._last = _to_device(new_last, dev)
        self._fire_callbacks(emitted)
        for req in done:
            if not req.future.done():
                req.future.set_result(req.tokens)
        with self._lock:
            self.bubble_ms += (time.perf_counter() - t0) * 1e3
        self._no_flight_since = None

    def _run_chunk(self) -> None:
        """Issue one decode chunk and retire its predecessor.

        Pipelined (``pipeline_depth == 1``, the default): chunk N+1 is
        issued against the current slot snapshot BEFORE chunk N's tokens
        are read, so N's read, stop-token truncation, callbacks, slot
        freeing, and the admission at the top of the next loop turn all
        run while the device computes N+1. Greedy output is identical to
        the serial engine: rows are independent, and a slot that finished
        in N decodes one discardable chunk more. Serial (depth 0): issue,
        read, bookkeep; the device idles through all host work (the
        measured bubble)."""
        prev, self._inflight = self._inflight, self._dispatch_chunk()
        if prev is not None:
            self._retire_chunk(prev)
        if self.pipeline_depth == 0:
            self._flush_pipeline()

    def _dispatch_chunk(self) -> _Inflight:
        """Issue one K-step decode chunk over ALL slots against the
        current slot snapshot. Dispatch and retirement strictly alternate;
        an insert that reuses a slot freed while retiring chunk N is
        issued after chunk N+1, so stream order puts N+1's junk writes for
        that slot before the insert that overwrites them. Paged, the same
        order puts N+1's last writes into the blocks released while
        retiring N before any admission that reallocates them."""
        with self._lock:
            reqs = list(self._slot_req)
        temps = np.zeros((self.slots,), np.float32)
        top_ks = np.zeros((self.slots,), np.int32)
        top_ps = np.ones((self.slots,), np.float32)
        occupied = np.zeros((self.slots,), bool)
        for i, r in enumerate(reqs):
            if r is not None:
                temps[i] = r.temperature
                top_ks[i] = r.top_k
                top_ps[i] = r.top_p
                occupied[i] = True
        now = time.perf_counter()
        bubble_closed_ms = None
        with self._lock:
            self.peak_active = max(self.peak_active, int(occupied.sum()))
            if self._last_dispatch_t is not None:
                # Gaps across quiet stretches are excluded (the baseline
                # is nulled in _note_decode_quiet).
                self._gap_ms_total += (now - self._last_dispatch_t) * 1e3
                self._gap_count += 1
            self._last_dispatch_t = now
            if self._no_flight_since is not None:
                # Host time with slots waiting and nothing on the device:
                # the serial-mode bubble pipelining closes.
                bubble_closed_ms = (now - self._no_flight_since) * 1e3
                self.bubble_ms += bubble_closed_ms
                self._no_flight_since = None
            self.dispatches += 1
        # occupied is the host's own snapshot: no device read here.
        blackbox.record('engine.dispatch', active=int(occupied.sum()))
        if bubble_closed_ms is not None:
            blackbox.record('engine.bubble', ms=round(bubble_closed_ms, 3),
                            edge='dispatch')
        temps_d, gen, tk, tp = self._sampling_args(temps, top_ks, top_ps)
        args = (self.cfg, self.chunk_steps, self.params, self._cache,
                self._last, self._limit, _to_device(occupied, self.device),
                temps_d, tk, tp, gen)
        chunk = _paged_chunk if self.kv_layout == 'paged' else _chunk
        self._cache, self._last, toks = chunk(*args, mesh=self.mesh)
        return _Inflight(reqs=reqs, toks=_HostCopy(toks),
                         steps=self.chunk_steps)

    def _note_decode_quiet(self) -> None:
        """No active slot: stop the bubble clock and the dispatch-gap
        baseline (the gap across a quiet stretch is not chunk cadence)."""
        self._no_flight_since = None
        self._last_dispatch_t = None

    def _flush_pipeline(self, quiet: bool = False) -> None:
        """Retire the in-flight chunk (if any) and mark the device idle
        with the host working, so time until the next dispatch counts as
        bubble. ``quiet``: the idle branch dropping a junk-only chunk; no
        decode work waits, so its time counts toward neither overlap nor
        bubble."""
        flight, self._inflight = self._inflight, None
        if flight is not None:
            self._retire_chunk(flight, quiet=quiet)
        if self._no_flight_since is None:
            self._no_flight_since = time.perf_counter()

    def _fold_sampled(self, tokens) -> None:
        """Fold ``tokens`` (int32) into ``sampled_digest``: a prefill
        group's first tokens, and each request's tokens as it emits
        them. Nothing else a chunk or round samples: a free slot's row,
        a row past its limit and a row that finished in the chunk before
        read the junk sink, where the writes of rows not active collide
        and a GPU orders them as it likes, so ranks that decode the same
        rows (seq, expert) may read other junk there."""
        self.sampled_digest = zlib.crc32(
            np.asarray(tokens, dtype=np.int32).tobytes(), self.sampled_digest)

    def _retire_chunk(self, flight: _Inflight, quiet: bool = False) -> None:
        """Read an issued chunk's tokens and run the host bookkeeping:
        stop-token truncation, streaming callbacks, slot freeing, future
        resolution. Under pipelining this runs while the NEXT chunk
        computes on the device."""
        # First tokens first: emission counts on every admitted request's
        # list already holding its prefill token (and a first-token eos
        # resolved here frees its slot before this chunk's junk for it
        # could be appended).
        self._drain_firsts()
        toks_host = flight.toks.numpy()  # [K, B]
        t0 = time.perf_counter()
        done: List[_Request] = []
        emitted: List[tuple] = []
        with self._lock:
            self.chunks_run += 1
            for i, req in enumerate(flight.reqs):
                if req is None or self._slot_req[i] is not req \
                        or req.future.done() or req.export:
                    # Stale snapshot entry: the slot was freed (possibly
                    # reused) since dispatch; appending would mutate a
                    # list already handed to the future. An export's row
                    # is inactive and its drain retires it.
                    continue
                take = min(req.max_new - len(req.tokens), flight.steps)
                new = [int(t) for t in toks_host[:take, i]]
                # Stop at the first stop id; the slot frees now instead
                # of burning max_new's tail.
                new, hit_eos = gen_lib.truncate_at_stop(new, req.eos)
                self._fold_sampled(new)
                req.tokens.extend(new)
                self.tokens_emitted += len(new)
                if req.on_tokens is not None and new:
                    emitted.append((req, new))
                if hit_eos or len(req.tokens) >= req.max_new:
                    self._slot_req[i] = None
                    self._release_blocks(i)
                    done.append(req)
        self._fire_callbacks(emitted)
        for req in done:
            if not req.future.done():
                req.future.set_result(req.tokens)
            # Counts only: token ids never enter the ring.
            blackbox.record('engine.retire', emitted=len(req.tokens),
                            max_new=req.max_new)
        dt_ms = (time.perf_counter() - t0) * 1e3
        was_bubble = False
        with self._lock:
            if self._inflight is not None:
                self.host_overlap_ms += dt_ms  # a chunk computed meanwhile
            elif not quiet:
                self.bubble_ms += dt_ms  # serial: the device sat idle
                was_bubble = True
        if was_bubble:
            blackbox.record('engine.bubble', ms=round(dt_ms, 3),
                            edge='retire')
