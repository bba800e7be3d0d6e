"""Mixture-of-Experts MLP: top-k routing with a static expert capacity.

Port of ``skypilot_tpu/models/moe.py``: the GShard/Switch formulation,
computed as the JAX package computes it, on one device or on a mesh. Routing, dispatch
and combine are dense one-hot products with static shapes; the experts'
SwiGLU runs as one batched product over the expert dim. The router is
float32; dispatch priority is choice-major (every token's first choice
beats any second choice) and a choice past an expert's ``capacity`` is
dropped; the Switch load-balancing loss comes back beside the output.

Two departures in form, none in value:

* ``jax.nn.one_hot`` gives a zero row for an index outside ``[0, C)``,
  which every unchosen or dropped (token, expert) pair has; torch's
  ``one_hot`` raises on it, so the slot one-hot is a comparison with
  ``arange(C)``.
* A token picks distinct experts, so for each (token, expert) at most one
  of its K choices is kept. The port sums over K before it builds the
  ``[N, E, C]`` dispatch and combine tensors (JAX builds ``[N, K, E, C]``
  first): the same numbers, with 1/K of the memory.

Ties: ``torch.topk`` does not promise ``lax.top_k``'s order (lower index
first) between equal probabilities. The router's probabilities are
float32, where an exact tie between two experts is rare; where one
occurs, the port may route to the other expert.

On a mesh (``moe_mlp(mesh=, rules=)``, one process per rank) the block
computes what JAX's GSPMD computes from the global ``[B, S, D]``:

* Capacity and drop order are global. ``N``, the capacity and the
  choice-major count run over every token of the batch, flattened in
  ``n = b * S + s`` order across the batch axes' and ``seq``'s shards:
  each rank all-gathers the ranks' per-row choice counts and places its
  tokens after every earlier block's choices, so the same tokens drop
  as in JAX.
* Tokens are not split over ``expert`` (``batch`` maps to ``data`` and
  ``fsdp``): every ``expert`` rank routes the same rows and runs its
  ``E / expert`` experts (``moe_logical_axes``) on its own tokens'
  slots. The rows and the combine weights enter that part through
  ``collectives.copy_to`` over ``expert`` (their gradients are summed
  there); ``we_down``'s partial sums are summed over ``tensor`` and the
  experts' outputs over ``expert`` (``reduce_from``).
* The router, its softmax and the balance loss are computed alike on
  every ``expert`` rank and summed nowhere over it; the loss's means are
  over the global tokens (sums over the batch axes and ``seq``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def init_moe_params(generator: torch.Generator, n_layers: int,
                    d_model: int, d_ff: int, num_experts: int,
                    dtype: torch.dtype,
                    device: Optional[torch.device] = None) -> Params:
    """Random MoE weights, stacked over ``n_layers`` as the layer tree is
    (JAX vmaps its per-layer init): ``router`` float32 ``[L, d, E]``,
    ``we_gate`` and ``we_up`` ``[L, E, d, F]`` and ``we_down``
    ``[L, E, F, d]`` in ``dtype``, each normal(0, fan_in**-0.5)."""

    def normal(shape, fan_in, out_dtype):
        w = torch.randn((n_layers, *shape), generator=generator,
                        dtype=torch.float32, device=device)
        return w.mul_(fan_in ** -0.5).to(out_dtype)

    e = num_experts
    return {
        # Float32: routing decisions are precision-sensitive.
        'router': normal((d_model, e), d_model, torch.float32),
        'we_gate': normal((e, d_model, d_ff), d_model, dtype),
        'we_up': normal((e, d_model, d_ff), d_model, dtype),
        'we_down': normal((e, d_ff, d_model), d_ff, dtype),
    }


def moe_logical_axes() -> Params:
    """Logical sharding axes of one layer's MoE block (JAX's
    ``moe.moe_logical_axes``)."""
    return {
        'router': ('embed', None),
        'we_gate': ('expert', 'embed', 'mlp'),
        'we_up': ('expert', 'embed', 'mlp'),
        'we_down': ('expert', 'mlp', 'embed'),
    }


def expert_capacity(num_tokens: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Static per-expert slot count, rounded up to a multiple of 8."""
    cap = math.ceil(top_k * num_tokens / num_experts * capacity_factor)
    return max(8, -(-cap // 8) * 8)


def _token_axes(mesh, rules) -> Tuple[str, ...]:
    """The mesh axes that split a ``[B, S, D]`` activation's tokens: the
    batch axes, then the sequence's."""
    from skypilot_tpu_torch.parallel import sharding as sharding_lib
    return tuple(a for a in sharding_lib.spec_axes(
        rules.mesh_axes(('batch', 'seqlen'))) if mesh.shape[a] > 1)


def _row_offsets(counts: torch.Tensor, mesh, rules) -> torch.Tensor:
    """Per local row, per choice and expert, the choice-major position of
    the row's first slot among all the tokens: the choices of every
    earlier choice index (over all tokens), plus this choice's in the
    blocks (row, ``seq`` shard) before the row's, in ``b * S + s`` order
    (on a mesh, every rank's blocks: an all-gather of the counts).
    ``counts`` [rows, K, E] are this rank's per-row counts."""
    rows = counts.shape[0]
    c = counts[None, None]                             # [1, 1, rows, K, E]
    me_seq = me_batch = 0
    if mesh is not None:
        from skypilot_tpu_torch.parallel import collectives
        from skypilot_tpu_torch.parallel import sharding as sharding_lib
        seq_axis = rules.mesh_axes(('batch', 'seqlen'))[1]
        if seq_axis is not None and mesh.shape[seq_axis] > 1:
            me_seq = mesh.axis_index(seq_axis)
            c = collectives.all_gather(c, mesh, seq_axis, 1)
        batch = rules.mesh_axes(('batch',))[0]
        me_batch, _ = sharding_lib.shard_index(mesh, batch)
        c = sharding_lib.gather(c, sharding_lib.NamedSharding(
            mesh, (batch,)))                        # [nb, n_seq, rows, K, E]
    n_seq = c.shape[1]
    blocks = c.transpose(1, 2).reshape(-1, *counts.shape[1:])
    before = torch.cumsum(blocks, dim=0) - blocks      # exclusive, by block
    totals = blocks.sum(0)                             # [K, E]
    earlier_choices = torch.cumsum(totals, dim=0) - totals
    mine = (me_batch * rows + torch.arange(rows, device=counts.device)) \
        * n_seq + me_seq
    return before[mine] + earlier_choices


def moe_mlp(x: torch.Tensor, params: Params, num_experts: int, top_k: int,
            capacity_factor: float,
            token_mask: Optional[torch.Tensor] = None, mesh=None,
            rules=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` [B, S, D] -> (``[B, S, D]`` in x's dtype, float32 aux loss).

    ``token_mask`` [B, S] (1 = a real token) keeps positions out of
    routing: a masked token takes no expert capacity (it is dropped
    before the capacity cumsum) and its output is zero. The aux loss
    divides by all B*S tokens, masked ones included, as JAX's does.

    With ``mesh`` (training; ``rules`` default to JAX's) ``x`` is this
    rank's block of the global tokens and ``params`` this layer's
    experts of this rank's ``expert`` shard, each gathered over
    ``fsdp``: see the module docstring."""
    b, s, d = x.shape
    n = b * s
    e, k = num_experts, top_k
    token_axes = ()
    if mesh is not None:
        from skypilot_tpu_torch.parallel import collectives
        from skypilot_tpu_torch.parallel import sharding as sharding_lib
        rules = rules or sharding_lib.ShardingRules()
        token_axes = _token_axes(mesh, rules)
    n_global = n * math.prod(mesh.shape[a] for a in token_axes)
    cap = expert_capacity(n_global, e, k, capacity_factor)
    xf = x.reshape(n, d)

    probs = torch.softmax(xf.float() @ params['router'], dim=-1)  # [N, E]
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)            # [N, K]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    choice_hot = F.one_hot(gate_idx, e).float()                   # [N, K, E]
    if token_mask is not None:
        m = token_mask.reshape(n).float()
        gate_vals = gate_vals * m[:, None]
        choice_hot = choice_hot * m[:, None, None]

    # Position of each (token, choice) in its expert's buffer: the count
    # in choice-major order, row by row (exact: small integers in float32).
    hot = choice_hot.reshape(b, s, k, e)
    pos = (torch.cumsum(hot, dim=1) - 1.0 + _row_offsets(
        hot.sum(1), mesh, rules)[:, None]).reshape(n, k, e)      # [N, K, E]
    keep = choice_hot * (pos < cap)

    # Sum over K first (at most one choice per (token, expert) is kept).
    kept = keep.sum(1)                                            # [N, E]
    slot = (pos * keep).sum(1)
    if mesh is not None:
        # The slots of this rank's experts; the rows and the combine
        # weights enter the expert-split part, so their gradients are
        # summed over ``expert``.
        axis = rules.mesh_axes(('expert',))[0]
        if axis is not None and mesh.shape[axis] > 1:
            first, n_loc = _expert_block(mesh, axis, e)
            kept, slot = (t[:, first:first + n_loc] for t in (kept, slot))
            keep = keep[:, :, first:first + n_loc]
        xf = collectives.copy_to(xf, mesh, axis) if axis else xf
        gate_vals = (collectives.copy_to(gate_vals, mesh, axis) if axis
                     else gate_vals)
    gate = (gate_vals[:, :, None] * keep).sum(1)
    slots = torch.arange(cap, device=x.device, dtype=slot.dtype)
    dispatch = (slot[..., None] == slots).float() * kept[..., None]
    combine = dispatch * gate[..., None]                          # [N, E, C]

    expert_in = torch.einsum('nec,nd->ecd', dispatch,
                             xf.float()).to(x.dtype)
    if mesh is not None:
        expert_in = collectives.copy_to(expert_in, mesh, 'tensor')
    h_gate = torch.einsum('ecd,edf->ecf', expert_in, params['we_gate'])
    h_up = torch.einsum('ecd,edf->ecf', expert_in, params['we_up'])
    expert_out = torch.einsum('ecf,efd->ecd', F.silu(h_gate) * h_up,
                              params['we_down'])
    if mesh is not None:
        expert_out = collectives.reduce_from(expert_out, mesh, 'tensor')
    out = torch.einsum('nec,ecd->nd', combine, expert_out.float())

    # Switch aux loss: E * sum_e f_e * P_e, least at uniform routing.
    if mesh is None:
        frac_dispatched = choice_hot[:, 0, :].mean(dim=0)
        mean_prob = probs.mean(dim=0)
    else:
        if axis is not None:
            out = collectives.reduce_from(out, mesh, axis)
        dispatched = choice_hot[:, 0, :].sum(dim=0)
        prob_sum = probs.sum(dim=0)
        for a in token_axes:
            dispatched = collectives.psum(dispatched, mesh, a)
            # Each rank's loss holds the whole aux: the identity backward
            # gives each rank its own tokens' share of the gradient.
            prob_sum = collectives.reduce_from(prob_sum, mesh, a)
        frac_dispatched = dispatched / n_global
        mean_prob = prob_sum / n_global
    aux = e * torch.sum(frac_dispatched * mean_prob)
    return out.reshape(b, s, d).to(x.dtype), aux


def _expert_block(mesh, axis: str, num_experts: int) -> Tuple[int, int]:
    """(first expert, count) of this rank's block of the experts."""
    n = num_experts // mesh.shape[axis]
    return mesh.axis_index(axis) * n, n
