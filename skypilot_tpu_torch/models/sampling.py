"""Token sampling: temperature, top-k and top-p (nucleus).

Port of ``skypilot_tpu/models/sampling.py``. Per-row vectors over a
``[B, V]`` logits block; one descending sort feeds both filters, and
disabled rows take neutral values (k=0, p=1, temperature 0 = greedy).
Randomness comes from an explicit ``torch.Generator``: the draws differ
from ``jax.random.categorical``'s for the same seed, the distribution
does not.
"""
from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def filter_logits(logits: torch.Tensor, top_k: Optional[torch.Tensor],
                  top_p: Optional[torch.Tensor]) -> torch.Tensor:
    """Mask ``logits`` [B, V] to each row's top-k ids, then to the
    smallest nucleus whose cumulative probability reaches top_p, taken
    over the renormalized top-k distribution (the HF/vLLM order).
    ``top_k`` [B] int (0 = off); ``top_p`` [B] float (>= 1 = off).
    Masked entries are set to -1e30."""
    if top_k is None and top_p is None:
        return logits
    v = logits.shape[-1]
    out = logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    if top_k is not None:
        k = torch.clamp(top_k.long(), 0, v)
        idx = torch.clamp(k - 1, 0, v - 1)
        kth = torch.gather(sorted_logits, -1, idx[:, None])[:, 0]
        thr = torch.where(k > 0, kth, torch.full_like(kth, -torch.inf))
        out = torch.where(out >= thr[:, None], out,
                          torch.full_like(out, _NEG_INF))
        ranks = torch.arange(v, device=logits.device)[None, :]
        sorted_logits = torch.where(
            (k[:, None] > 0) & (ranks >= k[:, None]),
            torch.full_like(sorted_logits, _NEG_INF), sorted_logits)
    if top_p is not None:
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # Positions whose PRECEDING mass is < p (the first token is
        # always kept); the threshold is the smallest kept logit.
        in_nucleus = (cum - probs) < top_p[:, None]
        nucleus_min = torch.amin(
            torch.where(in_nucleus, sorted_logits,
                        torch.full_like(sorted_logits, torch.inf)), dim=-1)
        thr_p = torch.where(top_p < 1.0, nucleus_min,
                            torch.full_like(nucleus_min, -torch.inf))
        out = torch.where(out >= thr_p[:, None], out,
                          torch.full_like(out, _NEG_INF))
    return out


def sample(logits: torch.Tensor, temps: torch.Tensor,
           generator: Optional[torch.Generator],
           top_k: Optional[torch.Tensor] = None,
           top_p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, V] logits -> [B] int32 ids. Rows with temperature 0 take the
    argmax; the others sample from the filtered, temperature-scaled
    distribution (temperature applies before the nucleus is taken).
    Sampling is argmax(logits + Gumbel noise), the same categorical draw
    as ``jax.random.categorical``."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        return greedy
    scaled = logits / torch.clamp_min(temps, 1e-6)[:, None]
    filtered = filter_logits(scaled, top_k, top_p)
    u = torch.rand(filtered.shape, generator=generator,
                   dtype=torch.float32, device=filtered.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(torch.clamp(u, tiny, 1.0)))
    sampled = torch.argmax(filtered + gumbel, dim=-1).to(torch.int32)
    return torch.where(temps > 0, sampled, greedy)
