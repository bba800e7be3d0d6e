"""Mixture-of-Experts MLP: top-k routing with a static expert capacity.

Port of ``skypilot_tpu/models/moe.py`` for one device: the GShard/Switch
formulation, computed as the JAX package computes it. Routing, dispatch
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

``moe_logical_axes`` (sharding over the ``expert`` mesh axis) goes with
the mesh, which the port does not have yet.
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


def expert_capacity(num_tokens: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Static per-expert slot count, rounded up to a multiple of 8."""
    cap = math.ceil(top_k * num_tokens / num_experts * capacity_factor)
    return max(8, -(-cap // 8) * 8)


def moe_mlp(x: torch.Tensor, params: Params, num_experts: int, top_k: int,
            capacity_factor: float,
            token_mask: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` [B, S, D] -> (``[B, S, D]`` in x's dtype, float32 aux loss).

    ``token_mask`` [B, S] (1 = a real token) keeps positions out of
    routing: a masked token takes no expert capacity (it is dropped
    before the capacity cumsum) and its output is zero. The aux loss
    divides by all B*S tokens, masked ones included, as JAX's does."""
    b, s, d = x.shape
    n = b * s
    e, k = num_experts, top_k
    cap = expert_capacity(n, e, k, capacity_factor)
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
    # in choice-major order.
    flat = choice_hot.transpose(0, 1).reshape(k * n, e)
    pos = torch.cumsum(flat, dim=0) - 1.0
    keep = flat * (pos < cap)
    pos = pos.reshape(k, n, e).transpose(0, 1)                    # [N, K, E]
    keep = keep.reshape(k, n, e).transpose(0, 1)

    # Sum over K first (at most one choice per (token, expert) is kept).
    kept = keep.sum(1)                                            # [N, E]
    slot = (pos * keep).sum(1)
    gate = (gate_vals[:, :, None] * keep).sum(1)
    slots = torch.arange(cap, device=x.device, dtype=slot.dtype)
    dispatch = (slot[..., None] == slots).float() * kept[..., None]
    combine = dispatch * gate[..., None]                          # [N, E, C]

    expert_in = torch.einsum('nec,nd->ecd', dispatch,
                             xf.float()).to(x.dtype)
    h_gate = torch.einsum('ecd,edf->ecf', expert_in, params['we_gate'])
    h_up = torch.einsum('ecd,edf->ecf', expert_in, params['we_up'])
    expert_out = torch.einsum('ecf,efd->ecd', F.silu(h_gate) * h_up,
                              params['we_down'])
    out = torch.einsum('nec,ecd->nd', combine, expert_out.float())

    # Switch aux loss: E * sum_e f_e * P_e, least at uniform routing.
    frac_dispatched = choice_hot[:, 0, :].mean(dim=0)
    aux = e * torch.sum(frac_dispatched * probs.mean(dim=0))
    return out.reshape(b, s, d).to(x.dtype), aux
