"""Greedy speculative decoding: a draft proposes, the target verifies.

Port of ``skypilot_tpu/models/speculative.py``. A small DRAFT model
proposes ``k`` tokens one step at a time (cheap steps, each a
flash-decode step on the card); the TARGET then scores all k in ONE
``forward_cached`` over the window with per-position logits (the einsum
path: K4 takes one query position). A proposal is accepted while it
equals the target's own argmax, and the first divergence is replaced by
the target's token, so the committed stream is EXACTLY the target's
greedy generation, whatever the draft proposes: the draft changes speed,
never output.

Acceptance is decided on the host; rollback rewrites the caches'
``lengths``: positions past a row's valid length are never attended and
the next window overwrites them. Both models must share a vocabulary.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.models import generate as gen_lib
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.observability import profiler


def _propose_impl(cfg: llama.LlamaConfig, k: int, params,
                  cache: gen_lib.KVCache, cur: torch.Tensor
                  ) -> Tuple[gen_lib.KVCache, torch.Tensor]:
    """k+1 greedy draft steps from ``cur`` [B]: returns (cache, proposals
    [k+1, B]), of which the first k are verified. The surplus step
    writes p_k's KV into the draft cache: without it a fully accepted
    window would leave the draft without its newest committed token. Its
    output token is discarded."""
    toks = []
    tok = cur
    for _ in range(k + 1):
        logits, cache = gen_lib.forward_cached(params, tok[:, None], cache,
                                               cfg)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(tok)
    return cache, torch.stack(toks)


def _verify_impl(cfg: llama.LlamaConfig, params, cache: gen_lib.KVCache,
                 window: torch.Tensor
                 ) -> Tuple[gen_lib.KVCache, torch.Tensor]:
    """One target forward over ``window`` [B, k+1] (= [cur, p1..pk]):
    returns (cache, the target's argmax at every position [B, k+1])."""
    logits, cache = gen_lib.forward_cached(params, window, cache, cfg,
                                           all_logits=True)
    return cache, torch.argmax(logits, dim=-1).to(torch.int32)


_propose = profiler.profiled('spec.propose', _propose_impl)
_verify = profiler.profiled('spec.verify', _verify_impl)


def _rewind(cache: gen_lib.KVCache, adj) -> gen_lib.KVCache:
    """Roll each row back by ``adj`` (int or [B]) positions."""
    return dataclasses.replace(cache, lengths=cache.lengths - adj)


@torch.inference_mode()
def generate_speculative(target_params, target_cfg: llama.LlamaConfig,
                         draft_params, draft_cfg: llama.LlamaConfig,
                         prompt: torch.Tensor, max_new_tokens: int,
                         k: int = 4, max_len: Optional[int] = None,
                         kv_quantize: bool = False
                         ) -> Tuple[torch.Tensor, dict]:
    """prompt [B, S] int -> ([B, max_new_tokens] int32 ids on the
    prompt's device, stats).

    Greedy-exact: the output equals ``generate.generate(target_params,
    target_cfg, prompt, max_new_tokens)`` whatever the draft.
    ``stats['acceptance_rate']`` is the share of draft proposals the
    target accepted (committed tokens per verify are ``1 + k *
    acceptance_rate`` on average)."""
    if target_cfg.num_experts > 0:
        # MoE expert capacity is per forward call: a k+1-token verify
        # routes differently than sequential decode, which would break
        # greedy exactness.
        raise ValueError('speculative decoding requires a dense target '
                         'model (MoE expert capacity is per forward '
                         'call; a multi-token verify breaks greedy '
                         'exactness)')
    if target_cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError('draft and target must share a vocabulary '
                         f'({draft_cfg.vocab_size} vs '
                         f'{target_cfg.vocab_size})')
    if k < 1:
        raise ValueError(f'k must be >= 1, got {k}')
    b, s_p = prompt.shape
    # +k+1 slack: a verify window may overhang the last committed
    # position before its tail is rolled back.
    max_len = max_len or min(target_cfg.max_seq_len,
                             draft_cfg.max_seq_len,
                             s_p + max_new_tokens + k + 1)
    if s_p + max_new_tokens + k > max_len:
        raise ValueError(
            f'prompt ({s_p}) + max_new ({max_new_tokens}) + window '
            f'overhang ({k}) exceeds max_len {max_len}')
    if max_len > draft_cfg.max_seq_len or \
            max_len > target_cfg.max_seq_len:
        # Decoding past a model's trained context degrades silently.
        raise ValueError(
            f'max_len {max_len} exceeds a model max_seq_len (draft '
            f'{draft_cfg.max_seq_len}, target {target_cfg.max_seq_len})')
    dev = prompt.device
    # int8 caches compose: quantization is per position and deterministic,
    # so accepted prefixes carry exactly the codes sequential decode
    # would have written.
    t_cache = gen_lib.init_cache(target_cfg, b, max_len,
                                 quantize=kv_quantize, device=dev)
    d_cache = gen_lib.init_cache(draft_cfg, b, max_len,
                                 quantize=kv_quantize, device=dev)
    logits, t_cache = gen_lib.jit_prefill(target_params, prompt, t_cache,
                                          target_cfg)
    _, d_cache = gen_lib.jit_prefill(draft_params, prompt, d_cache,
                                     draft_cfg)
    cur = torch.argmax(logits, dim=-1).to(torch.int32)

    out = [[int(t)] for t in cur.tolist()]
    proposals_total = proposals_accepted = verifies = 0
    # Invariant at the loop top: both caches hold exactly the committed
    # context EXCLUDING cur (each row's newest committed token); all rows
    # share one committed length (rows that already have max_new keep
    # decoding, their surplus is not emitted).
    while min(len(o) for o in out) < max_new_tokens:
        d_cache, props = _propose(draft_cfg, k, draft_params, d_cache, cur)
        # The verify window [cur, p1..pk] checks every proposal;
        # tgt[:, j] is the target's choice after window[:j+1].
        window = torch.cat([cur[:, None], props.transpose(0, 1)[:, :k]],
                           dim=1)
        t_cache, tgt = _verify(target_cfg, target_params, t_cache, window)
        host = torch.cat([props.transpose(0, 1), tgt], dim=1).cpu().numpy()
        props_h, tgt_h = host[:, :k + 1], host[:, k + 1:]  # [B, k+1] each
        # Rows share the cache length, so the batch commits the shortest
        # accepted prefix; each row emits its own proposals up to it, then
        # the target's token there.
        a_rows = []
        for r in range(b):
            a = 0
            while a < k and props_h[r, a] == tgt_h[r, a]:
                a += 1
            a_rows.append(a)
        a_min = min(a_rows)
        verifies += 1
        proposals_total += k * b
        proposals_accepted += sum(a_rows)
        for r in range(b):
            out[r].extend(int(t) for t in props_h[r, :a_min])
            out[r].append(int(tgt_h[r, a_min]))
        cur = tgt[:, a_min].contiguous()
        # Both models advanced k+1; keep the committed a_min + 1 (cur's
        # KV included).
        t_cache = _rewind(t_cache, k - a_min)
        d_cache = _rewind(d_cache, k - a_min)

    toks = torch.tensor(np.asarray([o[:max_new_tokens] for o in out],
                                   np.int32), device=dev)
    stats = {
        'verifies': verifies,
        'proposals': proposals_total,
        'accepted': proposals_accepted,
        'acceptance_rate': (proposals_accepted / proposals_total
                            if proposals_total else 0.0),
        'tokens_per_verify': (sum(len(o) for o in out) / b - 1)
                             / max(verifies, 1),
    }
    return toks, stats
