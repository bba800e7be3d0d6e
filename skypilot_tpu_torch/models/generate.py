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

THE OTHER AXES, by JAX's rules table (``parallel/sharding.py``); work
that every rank does for the whole batch (a prefill group) passes the
mesh's ``whole_rows`` view (``Mesh.whole_rows``):

* ``data`` and ``fsdp`` (``batch -> (data, fsdp)``) split the cache's
  rows, so each rank holds a contiguous block of them (``data_rows``,
  ``data`` outermost) and ``forward_cached`` runs on that block;
* ``fsdp`` (``embed -> fsdp``) also splits every weight on its ``embed``
  dim; each layer's weights are gathered over ``fsdp`` just before it
  runs (``run_layers``), one layer at a time, as training gathers them;
* ``pipe`` (``layers -> pipe``) gives each rank a contiguous block of the
  layers and of the cache; the hidden state passes rank to rank in each
  forward, and every rank ends with the same logits;
* ``seq`` (``seqlen -> seq``) splits a prefill's positions
  (``seq_block``); each layer gathers the block's K/V over ``seq``
  before the cache write, so the cache stays whole over ``seq``; a
  decode step runs whole on every ``seq`` rank;
* ``expert`` gives each rank its experts (``moe_mlp(mesh=)``), whose
  outputs are summed over ``expert`` before the one rounding; the MoE
  block takes its expert capacity over every rank's tokens.
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
    float32 per-position scales. With a sharded ``mesh`` the buffers are
    born sharded by JAX's rules: this rank's layers (``pipe``) and kv
    heads (``tensor``) of its block of the rows (``data`` and ``fsdp``,
    unless the view is ``whole_rows``), and the lengths of those rows.
    ``seq`` and ``expert`` split no dim of the cache."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    if mesh is not None and mesh.size > 1:
        shape = sharding_lib.local_shape(shape, sharding_lib.logical_sharding(
            mesh, serve_rules(mesh), KV_AXES))
    lengths = torch.zeros((shape[1],), dtype=torch.int32, device=device)
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
              reduce=None, moe_on=(None, None)) -> torch.Tensor:
    """Decoder-block back half (post-attention norm + MoE or dense SwiGLU
    MLP), residual included. ``token_mask`` [B, S] (MoE only) keeps
    padded and junk positions out of expert routing. ``reduce`` sums the
    row-split ``w_down`` product over the tensor ranks. On a tensor
    ``mesh`` the MoE block runs ``moe_mlp(mesh=)`` with JAX's rules: each
    rank holds every expert's slice of the ``mlp`` columns, the tokens
    are whole on every rank (so capacity and drop order are the one
    device's), and ``we_down``'s partial sums are summed over ``tensor``.
    ``moe_on`` is (mesh, rules) of the MoE block (``_moe_on``): where
    ``data`` and ``fsdp`` split the rows, or ``seq`` the positions, the
    capacity and the drop order are taken over every rank's tokens
    (``moe_mlp``'s token axes); on ``expert`` each rank runs its experts
    and their outputs are summed over ``expert`` before the one
    rounding."""
    h = llama.rms_norm(x, layer['mlp_norm'], cfg.norm_eps)
    if cfg.num_experts > 0:
        out, _ = moe.moe_mlp(h, layer['moe'], cfg.num_experts,
                             cfg.expert_top_k, cfg.expert_capacity_factor,
                             token_mask=token_mask, mesh=moe_on[0],
                             rules=moe_on[1])
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
                  reduce=None, moe_on=(None, None),
                  seq=None) -> torch.Tensor:
    """One decoder block writing this block's K/V into the (per-layer
    view of the) cache. x: [B, S, d]; ``cache_lens`` [B] = write
    offsets; ``valid`` [B] = cache_lens + real new tokens per row;
    ``token_mask`` [B, S] = the positions MoE routes (``_route_mask``).
    Short rows of a padded batch write junk past their real length; it
    is never attended and later steps overwrite it. ``seq`` (the mesh,
    where ``seq`` splits the positions): ``x`` and ``positions`` are this
    rank's block of them, and the block's K/V are gathered over ``seq``
    before the cache write, so every rank writes, and attends, them
    all."""
    q, k, v = _qkv_proj(cfg, x, layer, positions)
    if seq is not None:
        k, v = (collectives.all_gather(t, seq, 'seq', dim=1) for t in (k, v))
    _write_block(k_cache, k_s, k.transpose(1, 2), cache_lens)
    _write_block(v_cache, v_s, v.transpose(1, 2), cache_lens)
    att = _cached_attention(q, k_cache, v_cache, positions, valid, k_s, v_s)
    x = x + _mm(att, layer['wo'], 'bshk,hkd->bsd', reduce=reduce)
    return _mlp_tail(cfg, x, layer, token_mask, reduce, moe_on)


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
    view whose collectives sum the heads', mlp's and vocab's splits."""
    if mesh is None or mesh.shape['tensor'] == 1:
        return None
    return mesh


# JAX's ``batch -> (data, fsdp)``: the axes that split a serving batch's
# rows, ``data`` outermost.
ROW_AXES = ('data', 'fsdp')


def serve_rules(mesh, seq_split: bool = False
                ) -> sharding_lib.ShardingRules:
    """JAX's rules as one serving call applies them on ``mesh``: ``batch``
    splits nothing on a ``whole_rows`` view, and ``seqlen`` splits the
    positions only where the call splits them (``seq_block``)."""
    off = {'batch'} if mesh.rows_whole else set()
    if not seq_split:
        off.add('seqlen')
    return sharding_lib.ShardingRules(tuple(
        (name, None if name in off else axes)
        for name, axes in sharding_lib.ShardingRules().rules))


def data_rows(mesh, batch: int) -> Optional[slice]:
    """This rank's block of a serving batch of ``batch`` rows where the
    mesh's ``data`` and ``fsdp`` axes split them (JAX's ``batch ->
    (data, fsdp)``: contiguous blocks, ``data`` outermost); None where
    every rank holds them all (one block, or a ``whole_rows`` view)."""
    if mesh is None or mesh.rows_whole:
        return None
    i, n = sharding_lib.shard_index(mesh, ROW_AXES)
    if n == 1:
        return None
    size = batch // n
    return slice(i * size, (i + 1) * size)


def gather_rows(t: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's block of rows of ``t`` (along ``dim``), in
    ``data_rows`` order: the inverse of the split."""
    for axis in reversed(ROW_AXES):  # the minor axis first
        t = collectives.all_gather(t, mesh, axis, dim)
    return t


def sum_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over the ranks of the row axes."""
    for axis in ROW_AXES:
        t = collectives.psum(t, mesh, axis)
    return t


def seq_block(mesh, s: int) -> Tuple[int, int]:
    """(start, length) of this rank's block of a call's ``s`` positions:
    JAX's ``seqlen -> seq`` splits a prefill's positions into blocks of
    at least 2. A decode step (``s`` 1), and a window that ``seq`` does
    not divide (a verify of k + 1 positions), run whole on every ``seq``
    rank."""
    n = 1 if mesh is None else mesh.shape['seq']
    if n == 1 or s % n or s // n < 2:
        return 0, s
    return mesh.axis_index('seq') * (s // n), s // n


def _moe_on(mesh, seq_split: bool) -> tuple:
    """(mesh, rules) the MoE block routes over: any sharded mesh (its
    token axes set the capacity, ``expert`` splits the experts), with the
    call's rules (``serve_rules``); (None, None) on one device."""
    if mesh is None:
        return None, None
    return mesh, serve_rules(mesh, seq_split)


def _unstack_axes(axes):
    """A stacked leaf's logical axes, without the leading ``layers``."""
    if isinstance(axes, dict):
        return {k: _unstack_axes(v) for k, v in axes.items()}
    return axes[1:]


def _fsdp_axes(params: Params, cfg: llama.LlamaConfig, mesh):
    """The logical axes of ``params``' leaves (a quantized tree's too),
    each layer leaf's without ``layers``, for gathering their ``embed``
    dims over ``fsdp``; None where ``fsdp`` is 1."""
    if mesh is None or mesh.shape['fsdp'] == 1:
        return None
    from skypilot_tpu_torch.models import quantization as quant_lib
    axes = quant_lib.logical_axes_for(params, cfg)
    return dict(axes, layers=_unstack_axes(axes['layers']))


def gather_fsdp(w, axes, mesh):
    """A leaf or a tree of leaves (a layer: its quantized weights and MoE
    block too) gathered whole over ``fsdp`` on each leaf's dim whose
    logical axis maps there (``embed``), as training's
    ``collectives.gather_fsdp`` gathers a layer before use; ``w`` itself
    where ``axes`` is None. One collective for the whole tree: each
    split leaf's bytes, its ``fsdp`` dim first, go in one buffer."""
    if axes is None:
        return w
    split = []  # (path, leaf, its fsdp dim)

    def find(t, a, path):
        if isinstance(t, dict):
            for k in t:
                find(t[k], a[k], path + (k,))
            return
        for dim, entry in enumerate(sharding_lib.ShardingRules().mesh_axes(a)):
            if 'fsdp' in sharding_lib.spec_axes((entry,)):
                split.append((path, t, dim))
    find(w, axes, ())
    if not split:
        return w
    parts = [t.movedim(d, 0).contiguous() for _, t, d in split]
    raw = [p.reshape(-1).view(torch.uint8) for p in parts]
    # Each leaf's bytes start 8-aligned, so that they view as its dtype.
    pads = [(-r.numel()) % 8 for r in raw]
    total = sum(r.numel() + pad for r, pad in zip(raw, pads))
    got = collectives.all_gather(torch.cat([
        torch.cat([r, r.new_zeros(pad)]) if pad else r
        for r, pad in zip(raw, pads)]), mesh, 'fsdp', 0)
    out = _copy_tree(w)
    at = 0
    for (path, _, d), part, r, pad in zip(split, parts, raw, pads):
        blocks = [got[i * total + at:i * total + at + r.numel()].view(
            part.dtype).view(part.shape)
            for i in range(mesh.shape['fsdp'])]
        at += r.numel() + pad
        node = out
        for k in path[:-1]:
            node = node[k]
        whole = torch.cat(blocks, 0).movedim(0, d)
        if path:
            node[path[-1]] = whole
        else:
            out = whole
    return out


def _copy_tree(t):
    """A dict tree's structure copied, its leaves shared."""
    return {k: _copy_tree(v) for k, v in t.items()} if isinstance(
        t, dict) else t


def run_layers(params: Params, cfg: llama.LlamaConfig, mesh,
               x: Optional[torch.Tensor], shape: tuple, fn) -> torch.Tensor:
    """``x = fn(layer, i, x)`` over this rank's layers, ``i`` the index in
    its block of the stack: every layer where ``pipe`` is 1. On a
    ``pipe`` mesh (JAX's ``layers -> pipe``) rank p holds the p-th
    contiguous block of the layers; the hidden state (of ``shape``) goes
    rank to rank, each stage's output broadcast over ``pipe`` (``x`` is
    None on the ranks after the first, which wait for it), so every rank
    ends with the last stage's. Each layer's weights are gathered over
    ``fsdp`` just before it runs, one layer at a time."""
    axes = _fsdp_axes(params, cfg, mesh)
    layer_axes = None if axes is None else axes['layers']
    pipe = 1 if mesh is None else mesh.shape['pipe']
    me = 0 if pipe == 1 else mesh.axis_index('pipe')
    for stage in range(pipe):
        if stage == me:
            for i in range(cfg.n_layers // pipe):
                layer = gather_fsdp(llama.layer_params(params['layers'], i),
                                    layer_axes, mesh)
                x = fn(layer, i, x)
        if pipe > 1:
            x = collectives.broadcast(x if stage == me else None, mesh,
                                      shape, cfg.dtype, axis='pipe',
                                      src=stage)
    return x


def first_stage(mesh) -> bool:
    """True on the ranks that embed: the first ``pipe`` stage's."""
    return mesh is None or mesh.axis_index('pipe') == 0


def _top_axes(params: Params, cfg, mesh, name: str):
    """The logical axes of top-level leaf ``name`` where ``fsdp`` splits
    the weights, else None."""
    axes = _fsdp_axes(params, cfg, mesh)
    return None if axes is None else axes[name]


def _embed(params: Params, tokens: torch.Tensor, cfg, mesh):
    """Embedding rows of ``tokens``. On a tensor mesh the table is this
    rank's vocab slice: rows it does not hold are zero, and the sum over
    the ranks (exact: one nonzero term) is the lookup. Where ``fsdp``
    splits the table's ``embed`` dim, the ranks of ``fsdp`` look up each
    other's tokens too (they hold other rows of the batch where ``fsdp``
    splits it) and the rows' columns are gathered over ``fsdp``: the
    same values as a lookup in the gathered table, for a fraction of its
    bytes."""
    if _top_axes(params, cfg, mesh, 'embed') is None:
        return _lookup(params['embed'], tokens, cfg, mesh)
    split = not mesh.rows_whole  # the rows are split over fsdp too
    ids = (collectives.all_gather(tokens, mesh, 'fsdp', 0) if split
           else tokens)
    rows = collectives.all_gather(_lookup(params['embed'], ids, cfg, mesh),
                                  mesh, 'fsdp', dim=-1)
    if not split:
        return rows
    b = tokens.shape[0]
    return rows[mesh.axis_index('fsdp') * b:][:b]


def _lookup(table: torch.Tensor, tokens: torch.Tensor, cfg, mesh):
    """The rows of ``table`` (this rank's vocab slice on a tensor mesh)
    for ``tokens``, summed over ``tensor``."""
    table = table.to(cfg.dtype)
    tp = tensor_mesh(mesh)
    if tp is None:
        return table[tokens.long()]
    n = table.shape[0]
    ids = tokens.long() - tp.axis_index('tensor') * n
    inside = (ids >= 0) & (ids < n)
    rows = table[ids.clamp(0, n - 1)]
    return collectives.psum(
        torch.where(inside[..., None], rows, torch.zeros_like(rows)), tp)


def unembed(params: Params, x: torch.Tensor, cfg, mesh, spec: str
            ) -> torch.Tensor:
    """Float32 logits of ``x`` (``spec`` 'bd,dv->bv' or 'bsd,dv->bsv'),
    whole on every rank: the vocab-split logits are gathered over
    ``tensor``. Where ``fsdp`` splits ``lm_head``'s ``embed`` rows, each
    rank multiplies its block of ``x``'s columns by its rows and the
    float32 sums are summed over ``fsdp`` (the rows of ``x`` gathered
    first where ``fsdp`` splits them too): a few kB of activations and
    sums move instead of the table."""
    lm_head = params['lm_head']
    if _top_axes(params, cfg, mesh, 'lm_head') is None:
        logits = _mm(x, lm_head, spec, out_dtype=torch.float32)
    else:
        split = not mesh.rows_whole  # the rows are split over fsdp too
        b = x.shape[0]
        if split:
            x = collectives.all_gather(x, mesh, 'fsdp', 0)
        i = mesh.axis_index('fsdp')
        n = (lm_head['q8'] if isinstance(lm_head, dict) else lm_head).shape[0]
        logits = _mm(x[..., i * n:(i + 1) * n], lm_head, spec,
                     out_dtype=torch.float32,
                     reduce=lambda t: collectives.psum(t, mesh, 'fsdp'))
        if split:
            logits = logits[i * b:(i + 1) * b]
    tp = tensor_mesh(mesh)
    if tp is not None:
        logits = collectives.all_gather(logits, tp, dim=-1)
    return logits


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

    ``mesh`` (module docstring): ``params`` and ``cache`` are this
    rank's slices; every rank of the axes that do not split the rows
    must call with the same tokens, and all get the same logits. Where
    ``data`` and ``fsdp`` split the rows, ``tokens`` and the masks are
    this rank's block of them, as the cache is."""
    mesh = mesh if mesh is not None and mesh.size > 1 else None
    tp = tensor_mesh(mesh)
    reduce = None if tp is None else (lambda t: collectives.psum(t, tp))
    b, s = tokens.shape
    dev = tokens.device
    max_len = cache.k.shape[3]
    lo, n = seq_block(mesh, s)
    steps = torch.arange(s, dtype=torch.int32, device=dev)
    positions = cache.lengths[:, None] + steps[None, :]
    valid = cache.lengths + (s if row_lens is None
                             else row_lens.to(torch.int32))
    _check_fits(cache.lengths, s, max_len, active_rows)
    write_start = _write_starts(cache.lengths, s, max_len, active_rows)
    positions = positions[:, lo:lo + n]
    token_mask = _route_mask(
        cfg, positions, valid, row_lens is None,
        active_rows if route_rows is None else route_rows)
    moe_on = _moe_on(mesh, n < s)
    seq = mesh if n < s else None
    x = (_embed(params, tokens[:, lo:lo + n], cfg, mesh)
         if first_stage(mesh) else None)

    def layer_fn(layer, i, x):
        return _cached_layer(
            cfg, x, layer, positions, cache.k[i], cache.v[i], write_start,
            valid, cache.k_s[i] if cache.quantized else None,
            cache.v_s[i] if cache.quantized else None, token_mask, reduce,
            moe_on, seq)
    x = run_layers(params, cfg, mesh, x, (b, n, cfg.d_model), layer_fn)
    if seq is not None:
        x = collectives.all_gather(x, mesh, 'seq', dim=1)
    x = llama.rms_norm(x, params['final_norm'], cfg.norm_eps)
    new_cache = dataclasses.replace(cache, lengths=valid)
    if all_logits:
        return unembed(params, x, cfg, mesh, 'bsd,dv->bsv'), new_cache
    if row_lens is None:
        last = x[:, -1]
    else:
        last = x[torch.arange(b, device=dev), row_lens.long() - 1]
    return unembed(params, last, cfg, mesh, 'bd,dv->bv'), new_cache


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
