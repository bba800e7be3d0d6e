"""Paged (block-table) KV cache for the continuous serving engine.

Port of ``skypilot_tpu/models/paged.py``. The slot layout reserves one
``[max_len]`` cache row per slot, so mixed-length traffic strands memory
in tail padding. The paged layout carves the cache into fixed-size
position BLOCKS shared from one pool: each slot holds a small block table,
a request reserves only ``ceil((prompt + max_new) / block)`` blocks, and
the pool can be sized well below ``slots x max_len``.

* The pool is one ``[L, NB, Hkv, P, D]`` buffer per plane (int8 adds
  float32 scales ``[L, NB, Hkv, P]``); block tables are a ``[B, MB]``
  int32 tensor.
* Decode writes are per-row scatters ``pool[table[b, len // P], :,
  len % P] = kv``; the GATHER assembles each slot's blocks into the dense
  ``[B, Hkv, MB*P, D]`` attention view, one contiguous copy, and the
  layer reuses ``generate._cached_attention``: on a CUDA decode step that
  is the flash-decode kernel (K4), on the gathered view, unchanged.
* Table entries a request does not own point at block 0, a JUNK SINK no
  request ever owns. Rows that are not active (a freed slot keeps
  decoding, as the batch shape is fixed) write there whatever their stale
  table says: it may name blocks already given to another request.

As in the rest of the port, the pool is written IN PLACE: every mover
below changes the caller's tensors, and ``forward_paged`` returns a cache
that shares them with advanced ``lengths``. The host-side accounting
(free list, per-slot block lists, the share trie ``BlockTrie``) lives in
``models/engine.py``; the device sees only tables.

Copy-on-write block sharing: committed full prompt blocks are indexed in
``BlockTrie`` by their token chains, with per-block refcounts. A
matching request points its table head at the shared blocks and prefills
only its tail directly over the pool (``_prefill_shared_impl``); a
partially matched tail block is forked (``_fork_block_impl``) first.
Eviction is refcount-aware LRU over idle blocks; the KV tiers
(``serve/kv_tiers.py``) take the evicted chains' KV through
``_export_blocks_impl`` and give it back through ``_import_blocks_impl``.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

import torch

from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models.generate import (KVCache, _cached_attention,
                                                _mlp_tail, _qkv_proj,
                                                _quantize_block)
from skypilot_tpu_torch.models.quantization import mm as _mm
from skypilot_tpu_torch.utils import prefix_affinity as affinity_lib


@dataclasses.dataclass
class PagedKVCache:
    """Block pool + per-slot tables. ``k``/``v``: [L, NB, Hkv, P, D];
    ``tables``: [B, MB] int32 block ids (0 = junk sink / unallocated);
    ``lengths``: [B] int32 tokens cached per slot. Int8 mode adds
    per-position float32 scales [L, NB, Hkv, P]."""
    k: torch.Tensor
    v: torch.Tensor
    tables: torch.Tensor
    lengths: torch.Tensor
    k_s: Optional[torch.Tensor] = None
    v_s: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_s is not None

    @property
    def block(self) -> int:
        return self.k.shape[3]

    @property
    def max_blocks(self) -> int:
        return self.tables.shape[1]


def init_pool(cfg: llama.LlamaConfig, slots: int, max_len: int,
              n_blocks: int, block: int, quantize: bool = False,
              device=None) -> PagedKVCache:
    """A zeroed pool on ``device``. ``n_blocks`` INCLUDES block 0 (the
    junk sink): usable capacity is ``(n_blocks - 1) * block`` positions.
    ``max_blocks`` per slot covers ``max_len``. The block size must be a
    power of two: prefill widths are power-of-two buckets, and the
    insert scatters ``width // block`` whole blocks."""
    if block < 1 or block & (block - 1):
        raise ValueError(f'block size must be a power of two, '
                         f'got {block}')
    if max_len % block:
        raise ValueError(f'max_len {max_len} must be a multiple of the '
                         f'block size {block}')
    mb = max_len // block
    shape = (cfg.n_layers, n_blocks, cfg.n_kv_heads, block, cfg.head_dim)
    tables = torch.zeros((slots, mb), dtype=torch.int32, device=device)
    lengths = torch.zeros((slots,), dtype=torch.int32, device=device)
    if quantize:
        return PagedKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            tables=tables, lengths=lengths,
            k_s=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            v_s=torch.zeros(shape[:-1], dtype=torch.float32, device=device))
    return PagedKVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.dtype, device=device),
        tables=tables, lengths=lengths)


# ---------------------------------------------------------------------------
# Insert: scatter a dense prefilled cache (``generate.KVCache``; the
# prefill path is unchanged) into pool blocks.


def _insert_impl(pool: PagedKVCache, cache_n: KVCache,
                 tables_new: torch.Tensor, slots: torch.Tensor) -> None:
    """Write dense rows ``cache_n`` [L, N, H, W, D] (W a multiple of P,
    or < P) into the pool under each row's block table ``tables_new``
    [N, MB], and install those tables and the rows' lengths at ``slots``
    [N], in place. Positions beyond a row's reserved blocks carry junk
    (never attended) and land in the junk sink."""
    p = pool.block
    w = cache_n.k.shape[3]
    tables_new = tables_new.long()

    def scatter(pool_arr, new):  # new: [L, N, H, W, ...]
        if w < p:
            pool_arr[:, tables_new[:, 0], :, :w] = new
            return
        nb = w // p
        # [L, N, H, nb, P, ...] -> [L, N*nb, H, P, ...] against flat ids.
        l, n, h = new.shape[:3]
        rest = new.shape[4:]
        v = new.reshape(l, n, h, nb, p, *rest).transpose(2, 3)
        pool_arr[:, tables_new[:, :nb].reshape(-1)] = v.reshape(
            l, n * nb, h, p, *rest)

    scatter(pool.k, cache_n.k)
    scatter(pool.v, cache_n.v)
    if pool.quantized:
        scatter(pool.k_s, cache_n.k_s)
        scatter(pool.v_s, cache_n.v_s)
    slots = slots.long()
    pool.tables[slots] = tables_new.to(torch.int32)
    pool.lengths[slots] = cache_n.lengths


# ---------------------------------------------------------------------------
# Forwards over the pool: scatter the step's K/V, gather the slots'
# blocks into the dense attention view, reuse the dense math. S=1 is the
# decode step; S>1 is the prefill of a shared hit's tail
# (``_prefill_shared_impl``) and a speculative verify window.


def _block_offsets(tables: torch.Tensor, lengths: torch.Tensor, s: int,
                   p: int, active_rows: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flattened (block ids, in-block offsets) for positions
    [lengths, lengths+S) per row: the ONE definition of the table lookup
    (past-table positions clip to the last entry; rows not active divert
    to the junk sink), shared by the code and scale planes."""
    mb = tables.shape[1]
    pos = lengths[:, None] + torch.arange(s, dtype=torch.int32,
                                          device=lengths.device)[None]
    blk = torch.gather(tables, 1, torch.clamp(pos // p, 0, mb - 1).long())
    if active_rows is not None:
        blk = torch.where(active_rows[:, None], blk, 0)
    return blk.reshape(-1).long(), (pos % p).reshape(-1).long()


def _scatter_multi(pool: torch.Tensor, tables: torch.Tensor,
                   lengths: torch.Tensor, new: torch.Tensor,
                   active_rows: Optional[torch.Tensor]) -> None:
    """Scatter ``new`` [B, H, S, D] at positions [lengths, lengths+S) per
    row into ``pool`` [NB, H, P, D] under ``tables`` [B, MB], in place.
    The two index tensors are split by a slice, so the indexed dimension
    comes first: ``pool[blk, :, off]`` is [B*S, H, D]. Only rows diverted
    to block 0 can share a (block, offset) pair."""
    b, h, s, d = new.shape
    blk, off = _block_offsets(tables, lengths, s, pool.shape[2],
                              active_rows)
    pool[blk, :, off] = new.transpose(1, 2).reshape(b * s, h, d)


def _scatter_multi_s(pool_s: torch.Tensor, tables: torch.Tensor,
                     lengths: torch.Tensor, new_s: torch.Tensor,
                     active_rows: Optional[torch.Tensor]) -> None:
    """[B, H, S] scale-plane counterpart of ``_scatter_multi``."""
    b, h, s = new_s.shape
    blk, off = _block_offsets(tables, lengths, s, pool_s.shape[2],
                              active_rows)
    pool_s[blk, :, off] = new_s.transpose(1, 2).reshape(b * s, h)


def _view(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """The dense attention view of ``pool`` [NB, H, P, ...] under
    ``tables`` [B, MB]: [B, H, MB*P, ...], one contiguous gather (the
    block and head indices broadcast to [B, H, MB], so the gathered
    tensor is already in view order and the reshape is free)."""
    nb, h, p = pool.shape[:3]
    heads = torch.arange(h, device=pool.device)[None, :, None]
    g = pool[tables.long()[:, None, :], heads]  # [B, H, MB, P, ...]
    return g.reshape(g.shape[0], h, -1, *pool.shape[3:])


def _paged_layer(cfg: llama.LlamaConfig, x: torch.Tensor, layer,
                 lengths: torch.Tensor, tables: torch.Tensor,
                 k_pool: torch.Tensor, v_pool: torch.Tensor,
                 active_rows: Optional[torch.Tensor],
                 k_s: Optional[torch.Tensor],
                 v_s: Optional[torch.Tensor],
                 token_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decoder block at S >= 1 over the paged pool (per-layer views
    ``[NB, H, P, D]``, written in place). The math is ``generate``'s
    (``_qkv_proj`` / ``_cached_attention`` / ``_mlp_tail``); only the
    cache write (pool scatter) and read (block gather) differ from the
    dense layer. Rows not active write the junk sink: within a chunk a
    finishing row stays active and its blocks are released only after
    the chunk is read, so active writes never race a reallocation.
    ``token_mask`` [B, S]: the positions MoE routes."""
    s = x.shape[1]
    positions = lengths[:, None] + torch.arange(
        s, dtype=torch.int32, device=x.device)[None]  # [B, S]
    q, k, v = _qkv_proj(cfg, x, layer, positions)
    kt = k.transpose(1, 2)  # [B, Hkv, S, D]
    vt = v.transpose(1, 2)
    if k_s is not None:
        k8, ks_new = _quantize_block(kt)
        v8, vs_new = _quantize_block(vt)
        _scatter_multi(k_pool, tables, lengths, k8, active_rows)
        _scatter_multi(v_pool, tables, lengths, v8, active_rows)
        _scatter_multi_s(k_s, tables, lengths, ks_new, active_rows)
        _scatter_multi_s(v_s, tables, lengths, vs_new, active_rows)
    else:
        _scatter_multi(k_pool, tables, lengths, kt.to(k_pool.dtype),
                       active_rows)
        _scatter_multi(v_pool, tables, lengths, vt.to(v_pool.dtype),
                       active_rows)
    att = _cached_attention(
        q, _view(k_pool, tables), _view(v_pool, tables), positions,
        lengths + s,
        _view(k_s, tables) if k_s is not None else None,
        _view(v_s, tables) if v_s is not None else None)
    x = x + _mm(att, layer['wo'], 'bshk,hkd->bsd')
    return _mlp_tail(cfg, x, layer, token_mask)


def forward_paged(params, tokens: torch.Tensor, cache: PagedKVCache,
                  cfg: llama.LlamaConfig,
                  active_rows: Optional[torch.Tensor] = None,
                  all_logits: bool = False,
                  logit_index: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, PagedKVCache]:
    """Run ``tokens`` [B, S] over the paged pool (S=1 decode step; S=W
    padded tail prefill); returns (float32 logits, the cache advanced S,
    sharing the pool). ``all_logits`` returns per-POSITION logits
    [B, S, V]; ``logit_index`` [B] instead picks each row's own last
    REAL position (padded prefill); by default the last position's. The
    structural twin of ``generate.forward_cached`` with pool
    scatter/gather replacing the dense row update. An MoE model routes
    every position of the ``active_rows`` (all rows when None), as at
    ``paged.py:280`` of the JAX package: there is no padding term, as the
    JAX engine runs MoE through this forward at S = 1 only."""
    b, s = tokens.shape
    token_mask = None
    if cfg.num_experts > 0:
        mask = torch.ones((b, s), dtype=torch.bool, device=tokens.device)
        if active_rows is not None:
            mask = mask & active_rows[:, None]
        token_mask = mask.to(cfg.dtype)
    x = params['embed'].to(cfg.dtype)[tokens.long()]
    for i in range(cfg.n_layers):
        x = _paged_layer(
            cfg, x, llama.layer_params(params['layers'], i), cache.lengths,
            cache.tables, cache.k[i], cache.v[i], active_rows,
            cache.k_s[i] if cache.quantized else None,
            cache.v_s[i] if cache.quantized else None, token_mask)
    x = llama.rms_norm(x, params['final_norm'], cfg.norm_eps)
    new_cache = dataclasses.replace(cache, lengths=cache.lengths + s)
    if all_logits:
        return (_mm(x, params['lm_head'], 'bsd,dv->bsv',
                    out_dtype=torch.float32), new_cache)
    if logit_index is not None:
        last = x[torch.arange(b, device=x.device), logit_index.long()]
    else:
        last = x[:, -1]
    return (_mm(last, params['lm_head'], 'bd,dv->bv',
                out_dtype=torch.float32), new_cache)


# ---------------------------------------------------------------------------
# Copy-on-write block-level prefix sharing (vLLM/SGLang-style). Committed
# full token blocks are indexed host-side in a trie keyed by token-block
# chains (exact match), with per-block refcounts. All BlockTrie methods
# assume the caller holds the engine lock.


class _TrieNode:
    """One committed full KV block. ``key`` is the block's token tuple;
    ``children`` chain deeper blocks of the same prefix. ``detached``
    marks a node whose ancestor was evicted: it can never be matched
    again, so when its refs drop to zero its block frees directly.
    ``chain`` is the digest of the whole token chain root->here
    (``utils/prefix_affinity.py``); ``hits``/``hit_tick`` carry a
    DECAYED match count (``BlockTrie._hotness``)."""
    __slots__ = ('block', 'key', 'parent', 'children', 'refs', 'detached',
                 'chain', 'hits', 'hit_tick')

    def __init__(self, block: int, key: tuple,
                 parent: Optional['_TrieNode']):
        self.block = block
        self.key = key
        self.parent = parent
        self.children: Dict[tuple, '_TrieNode'] = {}
        self.refs = 1
        self.detached = False
        self.chain = affinity_lib.chain_digest(
            parent.chain if parent is not None else None, key)
        self.hits = 0.0
        self.hit_tick = 0


class BlockTrie:
    """Host-side index of committed prefix blocks. Invariant: every block
    the trie holds is either ``referenced`` (refs > 0, pinned by at least
    one live slot) or in the ``idle`` LRU (refs == 0, reclaimable);
    ``reclaimable`` is exact because eviction cascades over a popped
    node's whole idle subtree."""

    # Hotness half-life in MATCH EVENTS (deterministic, replay-safe).
    HITS_HALF_LIFE = 512

    def __init__(self, block: int):
        self.block = block
        self.children: Dict[tuple, _TrieNode] = {}
        self.idle: 'collections.OrderedDict[_TrieNode, None]' = \
            collections.OrderedDict()
        self.referenced = 0  # nodes with refs > 0 (incl. detached)
        self._match_tick = 0  # total match() calls; the decay clock

    @property
    def reclaimable(self) -> int:
        return len(self.idle)

    @property
    def blocks_held(self) -> int:
        return self.referenced + len(self.idle)

    def match(self, row: List[int],
              limit: Optional[int] = None
              ) -> Tuple[List[_TrieNode], Optional[_TrieNode], int]:
        """Longest committed chain covering ``row`` at block granularity,
        capped at ``limit`` tokens (default ``len(row) - 1``: the last
        prompt token must be computed to produce the first logits).
        Returns (full-block nodes, partial-tail node, partial length):
        the partial node is a committed child whose tokens extend the row
        past the full matches by 1..block-1 tokens, the copy-on-write
        fork candidate."""
        limit = len(row) - 1 if limit is None else limit
        p = self.block
        self._match_tick += 1
        nodes: List[_TrieNode] = []
        kids = self.children
        pos = 0
        while pos + p <= limit:
            node = kids.get(tuple(row[pos:pos + p]))
            if node is None:
                break
            node.hits = self._hotness(node) + 1.0  # decay, then bump
            node.hit_tick = self._match_tick
            nodes.append(node)
            pos += p
            kids = node.children
        partial, plen = None, 0
        rest = row[pos:limit]
        if rest:
            for key, node in kids.items():
                m = 0
                for a, b in zip(key, rest):
                    if a != b:
                        break
                    m += 1
                if m > plen:
                    partial, plen = node, m
        return nodes, partial, plen

    def acquire(self, node: _TrieNode) -> None:
        if node.refs == 0:
            self.referenced += 1
            self.idle.pop(node, None)
        node.refs += 1

    def release(self, node: _TrieNode) -> Optional[int]:
        """Decref; returns the node's block id when it must be FREED now
        (a detached node dying), else None (live nodes park in the idle
        LRU as reusable cache)."""
        node.refs -= 1
        if node.refs > 0:
            return None
        self.referenced -= 1
        if node.detached:
            return node.block
        self.idle[node] = None  # newest end of the LRU
        return None

    def touch(self, node: _TrieNode) -> None:
        if node in self.idle:
            self.idle.move_to_end(node)

    def commit(self, parent: Optional[_TrieNode], key: tuple,
               block: int) -> Optional[_TrieNode]:
        """Attach ``block`` as a committed child of ``parent`` (None =
        root). Returns the new node (born with refs=1, held by the
        committing slot), or None when an identical-content child already
        exists: the caller keeps its duplicate and chains deeper commits
        under the existing node."""
        kids = parent.children if parent is not None else self.children
        if key in kids:
            return None
        node = _TrieNode(block, key, parent)
        kids[key] = node
        self.referenced += 1
        return node

    def child(self, parent: Optional[_TrieNode],
              key: tuple) -> Optional[_TrieNode]:
        kids = parent.children if parent is not None else self.children
        return kids.get(key)

    def _hotness(self, node: _TrieNode) -> float:
        """Match count decayed by match events since the node's last hit
        (half-life ``HITS_HALF_LIFE``): the advert ordering signal."""
        if node.hits <= 0.0:
            return 0.0
        age = self._match_tick - node.hit_tick
        return node.hits * 0.5 ** (age / self.HITS_HALF_LIFE)

    def summary(self, max_entries: int = 64) -> dict:
        """Compact resident-chain advert for prefix-affinity routing: up
        to ``max_entries`` ``[chain_hex, depth]`` pairs plus pool-level
        counts, truncated hottest-first, then deepest-first, then by
        chain digest (a deterministic order). Detached nodes are
        excluded."""
        items = []  # (-hotness, -depth, chain_bytes)
        total = 0
        stack = [(node, 1) for node in self.children.values()]
        while stack:
            node, depth = stack.pop()
            total += 1
            if not node.detached:
                items.append((-self._hotness(node), -depth, node.chain))
            stack.extend((ch, depth + 1)
                         for ch in node.children.values())
        kept = heapq.nsmallest(max(int(max_entries), 0), items)
        return {'v': affinity_lib.SUMMARY_VERSION, 'block': self.block,
                'nodes': total, 'resident': self.blocks_held,
                'truncated': len(items) > len(kept),
                'entries': [[c.hex(), -d] for (_, d, c) in kept]}

    def resolve_chains(self, digests: List[bytes]) -> Dict[bytes, List[int]]:
        """Map chain digests back to the token chains this trie holds, by
        walking parents root-ward. Detached nodes are excluded."""
        want = set(digests)
        out: Dict[bytes, List[int]] = {}
        stack = list(self.children.values())
        while stack and want:
            node = stack.pop()
            stack.extend(node.children.values())
            if node.detached or node.chain not in want:
                continue
            want.discard(node.chain)
            parts = []
            cur: Optional[_TrieNode] = node
            while cur is not None:
                parts.append(cur.key)
                cur = cur.parent
            row: List[int] = []
            for key in reversed(parts):
                row.extend(key)
            out[node.chain] = row
        return out

    def evict(self, n: int) -> List[int]:
        """Reclaim >= n blocks from the idle LRU (a popped node's
        unreachable idle descendants free with it). Returns the freed
        block ids."""
        return [b for b, _ in self.evict_nodes(n)]

    def evict_nodes(self, n: int) -> List[Tuple[int, _TrieNode]]:
        """Like :meth:`evict` but returns ``(block, node)`` pairs: a
        detached node keeps ``key``/``parent``/``chain``, so the KV tiers
        can rebuild each evicted chain's token row and DEMOTE the block's
        KV; the caller must gather the blocks before the freed ids are
        rescattered."""
        freed: List[Tuple[int, _TrieNode]] = []
        while self.idle and len(freed) < n:
            node, _ = self.idle.popitem(last=False)
            freed.extend(self._detach(node))
        return freed

    def _detach(self, node: _TrieNode) -> List[Tuple[int, _TrieNode]]:
        kids = (node.parent.children if node.parent is not None
                else self.children)
        kids.pop(node.key, None)
        freed = [(node.block, node)]
        stack = list(node.children.values())
        node.children = {}
        while stack:
            ch = stack.pop()
            stack.extend(ch.children.values())
            if ch.refs == 0:
                # Reachable refs-0 nodes are in the idle LRU by
                # construction; unreachable ones free with the subtree.
                self.idle.pop(ch, None)
                freed.append((ch.block, ch))
            else:
                ch.detached = True  # frees at its final release()
        return freed


# ---------------------------------------------------------------------------
# Block movers. Block lists are padded to a power of two with junk-sink
# ids by the caller; padding reads and writes land in block 0 only.


def _fork_block_impl(pool: PagedKVCache, src: int, dst: int) -> None:
    """Copy-on-write fork: duplicate block ``src`` into owned block
    ``dst`` (all planes, all positions; positions past the shared
    partial length are overwritten by the tail prefill and decode writes
    and never attended before that), in place."""
    planes = (pool.k, pool.v) + ((pool.k_s, pool.v_s) if pool.quantized
                                 else ())
    for arr in planes:
        arr[:, dst] = arr[:, src]


def _gather_blocks_impl(pool: PagedKVCache, blocks: torch.Tensor,
                        p_len: torch.Tensor) -> KVCache:
    """Assemble shared blocks into a new DENSE 1-row prefill cache (the
    chunked long-prefill path seeds its scratch row from the trie this
    way). ``blocks`` is a full [MB] table row padded with junk-sink 0s,
    so the width is always MB*P = max_len; ``p_len`` [1] marks the valid
    shared-prefix tokens (sink junk beyond it is never attended)."""
    blocks = blocks.long()

    def view(arr):  # [L, NB, H, P, ...] -> [L, 1, H, MB*P, ...]
        g = arr[:, blocks].transpose(1, 2)
        l, h = g.shape[:2]
        return g.reshape(l, 1, h, -1, *arr.shape[4:])

    ks = vs = None
    if pool.quantized:
        ks, vs = view(pool.k_s), view(pool.v_s)
    return KVCache(k=view(pool.k), v=view(pool.v), lengths=p_len,
                   k_s=ks, v_s=vs)


def _export_blocks_impl(pool: PagedKVCache, blocks: torch.Tensor):
    """Gather ``blocks`` [NB] (junk-sink-0-padded) out of the pool into
    new tensors, keeping the block layout [L, NB, H, P, ...]. Returns
    (k, v, k_s, v_s), the scale planes None for an unquantized pool."""
    blocks = blocks.long()
    k, v = pool.k[:, blocks], pool.v[:, blocks]
    if pool.quantized:
        return k, v, pool.k_s[:, blocks], pool.v_s[:, blocks]
    return k, v, None, None


def _import_blocks_impl(pool: PagedKVCache, k_new: torch.Tensor,
                        v_new: torch.Tensor,
                        k_s_new: Optional[torch.Tensor],
                        v_s_new: Optional[torch.Tensor],
                        blocks: torch.Tensor, table_row: torch.Tensor,
                        slot: int, length: int) -> None:
    """Scatter block data [L, NB, H, P, ...] into the pool at ``blocks``
    [NB] and install ``table_row`` [MB] and ``length`` at ``slot``, in
    place. Padding entries point at the junk sink, so the zeros of a
    padded import land there only."""
    blocks = blocks.long()
    pool.k[:, blocks] = k_new
    pool.v[:, blocks] = v_new
    if k_s_new is not None:
        pool.k_s[:, blocks] = k_s_new
        pool.v_s[:, blocks] = v_s_new
    pool.tables[slot] = table_row
    pool.lengths[slot] = length


def _prefill_shared_impl(cfg: llama.LlamaConfig, params,
                         cache: PagedKVCache, tokens: torch.Tensor,
                         table_row: torch.Tensor, slot: int,
                         start: torch.Tensor,
                         slen: torch.Tensor) -> torch.Tensor:
    """Suffix prefill DIRECTLY over the pool: the block-share hit path.
    ``tokens`` [1, W] is the padded unshared tail; ``table_row`` [1, MB]
    already points its head at the shared blocks and its tail at owned
    ones; ``start`` [1] is the shared token count and ``slen`` [1] the
    real tail length. The forward reads the shared prefix through the
    block gather and scatters the tail's KV straight into the owned
    blocks (no dense scratch row, no insert copy). Installs the table
    and final length at ``slot``, in place, and returns the tail's
    last-real-token logits [1, V]."""
    row_cache = PagedKVCache(k=cache.k, v=cache.v, tables=table_row,
                             lengths=start, k_s=cache.k_s, v_s=cache.v_s)
    logits, _ = forward_paged(params, tokens, row_cache, cfg,
                              logit_index=slen - 1)
    cache.tables[slot] = table_row[0]
    cache.lengths[slot] = start[0] + slen[0]
    return logits
