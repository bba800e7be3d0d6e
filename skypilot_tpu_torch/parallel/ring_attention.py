"""Ring attention: sequence parallelism over the ``seq`` mesh axis.

Port of ``skypilot_tpu/parallel/ring_attention.py``. The sequence is
split over ``seq``: each rank holds its block of the positions of q, k
and v, and K/V blocks rotate around the ring (``collectives.rotate``,
JAX's ``ppermute`` with pairs (j, j + 1)), one hop after each block's
attention, so a rank never holds more than one other block. The blocks
combine by the online softmax of the flash kernel, in float32 with
JAX's guards: masked logits are ``_NEG_INF``, a row's shift is clamped
at ``_NEG_INF / 2`` and its masked probabilities zeroed, and the output
is ``acc / max(l, 1e-30)``.

JAX computes the block products as einsums, not in a Pallas kernel, and
so does the port: plain torch einsums, no flash kernel. The gradients of
K and V ride the inverse rotation back to the rank that owns the block
(``collectives.rotate``'s backward).

JAX's ``ring_attention`` wraps ``ring_attention_local`` in a
``shard_map`` over the batch, head and ``seq`` axes. Here every rank
already holds its shard of each (one process per rank), so the two are
one function; on a mesh whose ``seq`` is 1, or with no mesh, it is plain
attention on the local block.
"""
from __future__ import annotations

import torch

from skypilot_tpu_torch.parallel import collectives

_NEG_INF = -1e30


def _block_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                q_start: int, k_start: int, causal: bool):
    """One (q block x kv block): (unnormalised out, row max m, row sum l),
    each float32, shaped [B, Hkv, group, Sq, ...]."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    assert hq % hkv == 0, (hq, hkv)
    qg = q.reshape(b, hkv, hq // hkv, sq, d).float()
    s_ij = torch.einsum('bhgqd,bhkd->bhgqk', qg, k.float()) * d ** -0.5
    if causal:
        sk = k.shape[2]
        qi = q_start + torch.arange(sq, device=q.device)[:, None]
        ki = k_start + torch.arange(sk, device=q.device)[None, :]
        s_ij = torch.where(ki <= qi, s_ij, _NEG_INF)
    m = s_ij.amax(dim=-1, keepdim=True)
    # The shift keeps its gradient, so the cross-block rescales cancel in
    # the backward as softmax's shift does; a fully masked row's is clamped
    # and its probabilities zeroed.
    p = torch.exp(s_ij - torch.clamp_min(m, _NEG_INF / 2))
    p = torch.where(s_ij <= _NEG_INF / 2, 0.0, p)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum('bhgqk,bhkd->bhgqd', p, v.float())
    return o, m, l


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mesh=None, axis_name: str = 'seq',
                         causal: bool = True) -> torch.Tensor:
    """This rank's block of attention: q [B, Hq, S_loc, D], k/v [B, Hkv,
    S_loc, D], this rank's positions of the sequence split over
    ``axis_name``; returns the output block in q's dtype. Every rank of
    the axis must call it (n - 1 rotations of K and of V)."""
    n = 1 if mesh is None else mesh.shape[axis_name]
    me = 0 if mesh is None else mesh.axis_index(axis_name)
    b, hq, s_loc, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    q_start = me * s_loc
    acc = q.new_zeros((b, hkv, group, s_loc, d), dtype=torch.float32)
    m_run = torch.full((b, hkv, group, s_loc, 1), _NEG_INF,
                       dtype=torch.float32, device=q.device)
    l_run = torch.zeros_like(m_run)
    k_cur, v_cur = k, v
    for i in range(n):
        src = (me - i) % n  # whose K/V block this rank holds now
        o_blk, m_blk, l_blk = _block_attn(q, k_cur, v_cur, q_start,
                                          src * s_loc, causal)
        m_new = torch.maximum(m_run, m_blk)
        alpha = torch.exp(m_run - m_new)
        beta = torch.exp(m_blk - m_new)
        acc = acc * alpha + o_blk * beta
        l_run = l_run * alpha + l_blk * beta
        m_run = m_new
        if i < n - 1:  # no rotation after the last block
            k_cur = collectives.rotate(k_cur, mesh, axis_name)
            v_cur = collectives.rotate(v_cur, mesh, axis_name)
    out = acc / torch.clamp_min(l_run, 1e-30)
    return out.reshape(b, hq, s_loc, d).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh=None, causal: bool = True,
                   axis_name: str = 'seq') -> torch.Tensor:
    """JAX's sharded entry point: q [B, Hq, S, D] and k/v [B, Hkv, S, D]
    with S split over ``axis_name``. Each rank passes its shard (its
    rows, heads and positions) and gets its shard of the output."""
    return ring_attention_local(q, k, v, mesh, axis_name, causal)
