"""KV-cache autoregressive generation (the serving-side compute path).

Port of ``skypilot_tpu/models/generate.py``: a prefill through
``forward_cached``, then one ``forward_cached`` per new token, for dense
and MoE models alike.
JAX's ``lax.scan`` over layers and over decode steps becomes a Python
loop over both; the per-layer cache slices are views of the stacked
``[L, B, Hkv, M, D]`` buffers.

Unlike the JAX package, which returns new arrays, the port writes the
cache IN PLACE: ``forward_cached`` fills the caller's cache buffers and
returns a ``KVCache`` that shares them, with advanced ``lengths``.

``generate`` runs its prefill and its decode loop as the JAX package's
programs ``generate.prefill`` and ``generate.decode_scan`` on the
profiler's ledger (``observability/profiler.py``); the engine and the
speculative path prefill through the same ``jit_prefill``.

Every decode step (S=1) on a CUDA tensor runs the flash-decode kernel
(``ops/decode_attention.py``) in every layer; there is no opt-in and no
size gate. Prefill (S>1), and everything on the CPU, runs the plain
einsum path, as the JAX package computes prefill with XLA einsums.

TENSOR PARALLELISM (``forward_cached(..., mesh=)``, one process per rank):
each rank holds its slices of the weights (``quantization.shard_params``)
and of the cache (``init_cache(..., mesh=)``), in the Megatron layout that
JAX's rules imply (``parallel/sharding.py``): ``wq``/``wk``/``wv`` split
by column on heads and kv_heads, ``w_gate``/``w_up`` on mlp; ``wo`` and
``w_down`` split by row, each followed by one all-reduce where GSPMD puts
JAX's (``mm``'s ``reduce``); ``embed`` split on vocab (a masked lookup,
then an all-reduce, which is exact: one rank holds each row); ``lm_head``
split on vocab, its float32 logits all-gathered, so every rank samples
the same logits with the same generator state and the ranks' tokens
agree; norms replicated. The decode kernel runs per head shard, JAX's
``generate.kernel_shard_ctx``: each rank calls ``flash_decode`` on its own
``[B, Hkv/tp, M, D]`` cache and ``[B, Hq/tp, D]`` queries (and int8
scales), and the cache is never gathered.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from skypilot_tpu_torch.models import llama, moe, sampling
from skypilot_tpu_torch.models.quantization import mm as _mm
from skypilot_tpu_torch.observability import profiler
from skypilot_tpu_torch.ops import decode_attention
from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.parallel import sharding as sharding_lib

Params = llama.Params


@dataclasses.dataclass
class KVCache:
    """Per-layer key/value buffers [L, B, Hkv, max_len, D]; ``lengths``
    [B] int32 counts each row's cached tokens (rows advance
    independently, so right-padded prompts of different lengths share a
    batch). Int8 mode (``k_s``/``v_s`` [L, B, Hkv, max_len] float32 set):
    k/v hold int8 codes with a symmetric per-position scale over D."""
    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor
    k_s: Optional[torch.Tensor] = None
    v_s: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_s is not None


KV_AXES = ('layers', 'batch', 'kv_heads', None, 'head_dim')


def init_cache(cfg: llama.LlamaConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None, quantize: bool = False,
               device=None, mesh=None) -> KVCache:
    """Zeroed cache on ``device``; ``quantize=True`` = int8 codes plus
    float32 per-position scales. With a tensor-parallel ``mesh`` the
    buffers are born sharded: this rank's kv heads only."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    if tensor_mesh(mesh) is not None:
        shape = sharding_lib.local_shape(shape, sharding_lib.logical_sharding(
            mesh, sharding_lib.ShardingRules(), KV_AXES))
    lengths = torch.zeros((batch,), dtype=torch.int32, device=device)
    if quantize:
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            lengths=lengths,
            k_s=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            v_s=torch.zeros(shape[:-1], dtype=torch.float32, device=device))
    dtype = dtype or cfg.dtype
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   lengths=lengths)


def _cached_attention(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, positions: torch.Tensor,
                      valid_len: torch.Tensor,
                      k_s: Optional[torch.Tensor] = None,
                      v_s: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, S, Hq, D] at ``positions`` [B, S]; k/v_cache [B, Hkv, M, D]
    already holding this block's keys; ``valid_len`` [B]. At S=1 (a
    decode step, where ``positions == valid_len - 1``) this is
    ``flash_decode``: the kernel on CUDA, its plain version on the CPU.
    At S>1 it is the einsum path. Under tensor parallelism the heads are
    this rank's shard, so the kernel runs per head shard."""
    if q.shape[1] == 1:
        out = decode_attention.flash_decode(
            q[:, 0], k_cache, v_cache, valid_len.to(torch.int32), k_s, v_s)
        return out[:, None]
    return decode_attention.cached_attention_reference(
        q, k_cache, v_cache, positions, valid_len, k_s, v_s)


def _row_update(cache: torch.Tensor, new: torch.Tensor,
                starts: torch.Tensor) -> None:
    """Write ``new`` [B, Hkv, S, ...] into ``cache`` [B, Hkv, M, ...] at
    per-row offsets ``starts`` [B], in place. An out-of-range position
    raises (an index error on the CPU, a device assert on CUDA); only
    ``forward_cached`` clamps, and only for rows that are not active."""
    b, hkv, s = new.shape[:3]
    dev = cache.device
    bi = torch.arange(b, device=dev)[:, None, None]
    hi = torch.arange(hkv, device=dev)[None, :, None]
    pi = (starts.long()[:, None] + torch.arange(s, device=dev))[:, None, :]
    cache[bi, hi, pi] = new


def _quantize_block(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, Hkv, S, D] -> (int8 codes, [B, Hkv, S] float32 scales):
    symmetric per-position max|x|/127 over D."""
    x32 = x.float()
    s = torch.clamp_min(torch.amax(torch.abs(x32), dim=-1) / 127.0, 1e-8)
    q8 = torch.clamp(torch.round(x32 / s[..., None]), -127,
                     127).to(torch.int8)
    return q8, s


def _write_block(cache_arr: torch.Tensor, scale_arr: Optional[torch.Tensor],
                 block: torch.Tensor, starts: torch.Tensor) -> None:
    """Write a [B, Hkv, S, D] block at per-row offsets, in place,
    quantizing on the way in when the cache is int8 (``scale_arr`` set)."""
    if scale_arr is not None:
        block, s = _quantize_block(block)
        _row_update(scale_arr, s, starts)
    _row_update(cache_arr, block.to(cache_arr.dtype), starts)


def _check_fits(starts: torch.Tensor, s: int, max_len: int,
                active_rows: Optional[torch.Tensor] = None) -> None:
    """Assert start + S <= max_len for every row (every active row, when
    ``active_rows`` is given), without a host sync on CUDA (an
    asynchronous device assert)."""
    fits = starts + s <= max_len
    if active_rows is not None:
        fits = fits | ~active_rows
    torch._assert_async(torch.all(fits),
                        'KV cache overflow: start + S > max_len')


def _write_starts(starts: torch.Tensor, s: int, max_len: int,
                  active_rows: Optional[torch.Tensor]) -> torch.Tensor:
    """Write offsets: ``starts`` for active rows; rows not active write at
    min(start, max_len - S), where ``dynamic_update_slice`` puts them."""
    if active_rows is None:
        return starts
    return torch.where(active_rows, starts,
                       torch.clamp(starts, max=max_len - s))


def _qkv_proj(cfg: llama.LlamaConfig, x: torch.Tensor, layer: Params,
              positions: torch.Tensor):
    """Attention front half: norm, QKV projections, RoPE."""
    h = llama.rms_norm(x, layer['attn_norm'], cfg.norm_eps)
    q = _mm(h, layer['wq'], 'bsd,dhk->bshk')
    k = _mm(h, layer['wk'], 'bsd,dhk->bshk')
    v = _mm(h, layer['wv'], 'bsd,dhk->bshk')
    q = llama.rope(q, positions, cfg.rope_theta)
    k = llama.rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mlp_tail(cfg: llama.LlamaConfig, x: torch.Tensor, layer: Params,
              token_mask: Optional[torch.Tensor] = None,
              reduce=None) -> torch.Tensor:
    """Decoder-block back half (post-attention norm + MoE or dense SwiGLU
    MLP), residual included. ``token_mask`` [B, S] (MoE only) keeps
    padded and junk positions out of expert routing. ``reduce`` sums the
    row-split ``w_down`` product over the tensor ranks."""
    h = llama.rms_norm(x, layer['mlp_norm'], cfg.norm_eps)
    if cfg.num_experts > 0:
        out, _ = moe.moe_mlp(h, layer['moe'], cfg.num_experts,
                             cfg.expert_top_k, cfg.expert_capacity_factor,
                             token_mask=token_mask)
        return x + out
    gate = _mm(h, layer['w_gate'], 'bsd,df->bsf')
    up = _mm(h, layer['w_up'], 'bsd,df->bsf')
    return x + _mm(F.silu(gate) * up, layer['w_down'], 'bsf,fd->bsd',
                   reduce=reduce)


def _cached_layer(cfg: llama.LlamaConfig, x: torch.Tensor, layer: Params,
                  positions: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, cache_lens: torch.Tensor,
                  valid: torch.Tensor,
                  k_s: Optional[torch.Tensor] = None,
                  v_s: Optional[torch.Tensor] = None,
                  token_mask: Optional[torch.Tensor] = None,
                  reduce=None) -> torch.Tensor:
    """One decoder block writing this block's K/V into the (per-layer
    view of the) cache. x: [B, S, d]; ``cache_lens`` [B] = write
    offsets; ``valid`` [B] = cache_lens + real new tokens per row;
    ``token_mask`` [B, S] = the positions MoE routes (``_route_mask``).
    Short rows of a padded batch write junk past their real length; it
    is never attended and later steps overwrite it."""
    q, k, v = _qkv_proj(cfg, x, layer, positions)
    _write_block(k_cache, k_s, k.transpose(1, 2), cache_lens)
    _write_block(v_cache, v_s, v.transpose(1, 2), cache_lens)
    att = _cached_attention(q, k_cache, v_cache, positions, valid, k_s, v_s)
    x = x + _mm(att, layer['wo'], 'bshk,hkd->bsd', reduce=reduce)
    return _mlp_tail(cfg, x, layer, token_mask, reduce)


def _route_mask(cfg: llama.LlamaConfig, positions: torch.Tensor,
                valid: torch.Tensor, uniform: bool,
                route_rows: Optional[torch.Tensor]
                ) -> Optional[torch.Tensor]:
    """The MoE token mask [B, S] in ``cfg.dtype`` (``generate.py:326``):
    None for a dense model, and for a uniform batch with no rows given
    (every position is real); else ``positions < valid``, ANDed with
    ``route_rows``. Padded positions and rows outside ``route_rows`` take
    no expert capacity."""
    if cfg.num_experts == 0 or (uniform and route_rows is None):
        return None
    mask = positions < valid[:, None]
    if route_rows is not None:
        mask = mask & route_rows[:, None]
    return mask.to(cfg.dtype)


def tensor_mesh(mesh):
    """``mesh`` when its ``tensor`` axis is larger than 1, else None: the
    sharded serving path splits heads, mlp and vocab over that axis
    (``engine.check_options`` refuses every other)."""
    if mesh is None or mesh.shape['tensor'] == 1:
        return None
    return mesh


def _embed(table: torch.Tensor, tokens: torch.Tensor, cfg, mesh):
    """Embedding rows of ``tokens``; on a tensor mesh ``table`` is this
    rank's vocab slice: rows it does not hold are zero, and the sum over
    the ranks (exact: one nonzero term) is the lookup."""
    table = table.to(cfg.dtype)
    if mesh is None:
        return table[tokens.long()]
    n = table.shape[0]
    ids = tokens.long() - mesh.axis_index('tensor') * n
    inside = (ids >= 0) & (ids < n)
    rows = table[ids.clamp(0, n - 1)]
    return collectives.psum(
        torch.where(inside[..., None], rows, torch.zeros_like(rows)), mesh)


def forward_cached(params: Params, tokens: torch.Tensor, cache: KVCache,
                   cfg: llama.LlamaConfig,
                   row_lens: Optional[torch.Tensor] = None,
                   active_rows: Optional[torch.Tensor] = None,
                   all_logits: bool = False,
                   route_rows: Optional[torch.Tensor] = None,
                   mesh=None) -> Tuple[torch.Tensor, KVCache]:
    """Run ``tokens`` [B, S] through the model appending to ``cache``
    (in place); returns (float32 logits of each row's LAST REAL position
    [B, vocab], the cache with advanced lengths). Prefill (S = padded
    prompt length) and decode (S = 1) alike. ``row_lens`` [B] gives each
    row's real token count within ``tokens`` (default: all S).
    ``all_logits`` returns float32 logits at EVERY position [B, S, vocab]
    instead (a speculative verify needs the target's prediction after
    each proposed token; S is the small draft window).

    ``active_rows`` [B] bool marks the rows that are live requests (the
    continuous engine decodes its whole slot batch, and a free slot's row
    is junk whose length grows without bound). Live rows compute exactly
    what they compute without it. A row that is not active writes at
    min(start, M - S), as ``dynamic_update_slice`` clamps in the JAX
    package, and its lengths may pass M (attention then covers all M);
    the overflow assert covers the active rows only.

    ``route_rows`` [B] bool marks the rows whose tokens take MoE expert
    capacity, JAX's ``active_rows`` (None = ``active_rows``). The engine
    passes its dispatch snapshot here: a request that finishes mid-chunk
    keeps routing its junk for the rest of the chunk, as in the JAX
    engine, while ``active_rows`` turns its writes off. Expert routing is
    the one place where rows of a batch affect each other.

    ``mesh`` (tensor parallelism, module docstring): ``params`` and
    ``cache`` are this rank's slices; every rank of the tensor axis must
    call with the same tokens, and all get the same logits."""
    tp = tensor_mesh(mesh)
    reduce = None if tp is None else (lambda t: collectives.psum(t, tp))
    b, s = tokens.shape
    dev = tokens.device
    max_len = cache.k.shape[3]
    steps = torch.arange(s, dtype=torch.int32, device=dev)
    positions = cache.lengths[:, None] + steps[None, :]
    valid = cache.lengths + (s if row_lens is None
                             else row_lens.to(torch.int32))
    _check_fits(cache.lengths, s, max_len, active_rows)
    write_start = _write_starts(cache.lengths, s, max_len, active_rows)
    token_mask = _route_mask(
        cfg, positions, valid, row_lens is None,
        active_rows if route_rows is None else route_rows)
    x = _embed(params['embed'], tokens, cfg, tp)
    for i in range(cfg.n_layers):
        x = _cached_layer(
            cfg, x, llama.layer_params(params['layers'], i), positions,
            cache.k[i], cache.v[i], write_start, valid,
            cache.k_s[i] if cache.quantized else None,
            cache.v_s[i] if cache.quantized else None, token_mask, reduce)
    x = llama.rms_norm(x, params['final_norm'], cfg.norm_eps)
    new_cache = dataclasses.replace(cache, lengths=valid)
    if all_logits:
        logits = _mm(x, params['lm_head'], 'bsd,dv->bsv',
                     out_dtype=torch.float32)
    else:
        if row_lens is None:
            last = x[:, -1]
        else:
            last = x[torch.arange(b, device=dev), row_lens.long() - 1]
        logits = _mm(last, params['lm_head'], 'bd,dv->bv',
                     out_dtype=torch.float32)
    if tp is not None:
        logits = collectives.all_gather(logits, tp, dim=-1)
    return logits, new_cache


def _sample(logits: torch.Tensor, temperature: float,
            generator: Optional[torch.Generator], top_k: int = 0,
            top_p: float = 1.0) -> torch.Tensor:
    """Scalar-config sampling for the batch path."""
    if temperature == 0.0 or generator is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    b = logits.shape[0]
    dev = logits.device
    filters_on = top_k > 0 or top_p < 1.0  # off: skip the vocab sort
    return sampling.sample(
        logits, torch.full((b,), temperature, device=dev), generator,
        torch.full((b,), top_k, dtype=torch.int32, device=dev)
        if filters_on else None,
        torch.full((b,), top_p, device=dev) if filters_on else None)


def truncate_at_stop(tokens, eos):
    """Cut a generated row at its first stop id, INCLUSIVE. Returns
    (tokens, hit)."""
    if eos:
        for j, t in enumerate(tokens):
            if t in eos:
                return tokens[:j + 1], True
    return tokens, False


def pad_prompts(rows: Sequence[Sequence[int]], pad_id: int = 0,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Right-pad variable-length token rows into (tokens [B, S_max],
    lengths [B]) int32 tensors on ``device``."""
    lens = [len(r) for r in rows]
    out = np.full((len(rows), max(lens)), pad_id, np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = np.asarray(r, np.int32)
    return (torch.from_numpy(out).to(device),
            torch.tensor(lens, dtype=torch.int32, device=device))


jit_prefill = profiler.profiled('generate.prefill', forward_cached)


def _decode_scan_impl(params: Params, cache: KVCache, first: torch.Tensor,
                      generator: Optional[torch.Generator],
                      cfg: llama.LlamaConfig, n: int, temperature: float,
                      top_k: int, top_p: float, uniform: bool
                      ) -> List[torch.Tensor]:
    """The n - 1 decode steps after ``first`` [B]: one
    ``forward_cached`` and one draw each (JAX's ``lax.scan``)."""
    ones = (None if uniform else torch.ones(
        (first.shape[0],), dtype=torch.int32, device=first.device))
    token, out = first, []
    for _ in range(n - 1):
        logits, cache = forward_cached(params, token[:, None], cache, cfg,
                                       ones)
        token = _sample(logits, temperature, generator, top_k, top_p)
        out.append(token)
    return out


_decode_scan = profiler.profiled('generate.decode_scan', _decode_scan_impl)


@torch.inference_mode()
def generate(params: Params, cfg: llama.LlamaConfig,
             prompt: torch.Tensor, max_new_tokens: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             max_len: Optional[int] = None,
             prompt_lengths: Optional[torch.Tensor] = None,
             kv_quantize: bool = False, top_k: int = 0,
             top_p: float = 1.0) -> torch.Tensor:
    """prompt [B, S_p] int -> [B, max_new_tokens] int32 generated ids, on
    the prompt's device. Greedy when temperature == 0. ``prompt_lengths``
    [B] marks each row's real length in a right-padded batch
    (``pad_prompts``). ``kv_quantize`` = int8 KV cache. ``top_k`` /
    ``top_p`` filter sampled rows. Sampling draws from ``generator``,
    which must live on the prompt's device."""
    b, s_p = prompt.shape
    max_len = max_len or min(cfg.max_seq_len, s_p + max_new_tokens)
    if s_p + max_new_tokens > max_len:
        raise ValueError(f'prompt {s_p} + max_new_tokens {max_new_tokens} '
                         f'exceeds max_len {max_len}')
    if top_k < 0 or not 0.0 < top_p <= 1.0:
        raise ValueError('top_k must be >= 0 and top_p in (0, 1]')
    if temperature > 0.0 and generator is None:
        raise ValueError('temperature > 0 requires a torch.Generator')
    cache = init_cache(cfg, b, max_len, quantize=kv_quantize,
                       device=prompt.device)
    logits, cache = jit_prefill(params, prompt, cache, cfg, prompt_lengths)
    first = _sample(logits, temperature, generator, top_k, top_p)
    rest = _decode_scan(params, cache, first, generator, cfg,
                        max_new_tokens, temperature, top_k, top_p,
                        prompt_lengths is None)
    return torch.stack([first] + rest, dim=1)
