"""Int8 weight-only quantization for the serving path.

Port of ``skypilot_tpu/models/quantization.py`` (single device; the
sharded variants come with the multi-device slice). Target weights become
``{'q8': int8, 's': float32}`` leaves with symmetric per-output-channel
scales; ``mm`` multiplies by the int8 codes cast to the activation dtype
and applies the scale to the float32 sums of the product, as the JAX
package does. The products are library GEMMs (``torch.einsum``,
``torch.mm``): the JAX package leaves them to XLA.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

Params = Dict[str, Any]

# Per-target: number of CONTRACTION dims at the front of the (unstacked)
# weight; the remaining dims are output channels (one scale each).
_LAYER_TARGETS = {
    'wq': 1, 'wk': 1, 'wv': 1,   # (d, h, k): contract d
    'wo': 2,                     # (h, k, d): contract h,k
    'w_gate': 1, 'w_up': 1,      # (d, f)
    'w_down': 1,                 # (f, d)
}
_TOP_TARGETS = {'lm_head': 1}    # (d, v); embed stays full precision


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and 'q8' in w


def _contract_dims(n_contract: int, stacked: bool):
    return tuple(range(1, 1 + n_contract) if stacked else range(n_contract))


def _quantize(w: torch.Tensor, n_contract: int,
              stacked: bool) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8: s = max|W|/127 over the
    contraction dims, q = round(W/s)."""
    dims = _contract_dims(n_contract, stacked)
    w32 = w.float()
    s_b = torch.amax(torch.abs(w32), dim=dims, keepdim=True) / 127.0
    s_b = torch.clamp_min(s_b, 1e-8)  # all-zero channels: no div-by-zero
    q = torch.clamp(torch.round(w32 / s_b), -127, 127).to(torch.int8)
    return {'q8': q, 's': s_b.squeeze(dims)}


def dequantize(w: Dict[str, torch.Tensor], n_contract: int,
               stacked: bool) -> torch.Tensor:
    s = w['s']
    for dim in _contract_dims(n_contract, stacked):
        s = s.unsqueeze(dim)
    return w['q8'].float() * s


def quantize_params(params: Params) -> Params:
    """Quantize the dense matmul weights; embed and norms pass through.
    The returned tree drops into ``generate.forward_cached`` unchanged."""
    layers = dict(params['layers'])
    for name, n_c in _LAYER_TARGETS.items():
        if name in layers:
            layers[name] = _quantize(layers[name], n_c, stacked=True)
    out = {**params, 'layers': layers}
    for name, n_c in _TOP_TARGETS.items():
        if name in out:
            out[name] = _quantize(out[name], n_c, stacked=False)
    return out


def _sums_f32(spec: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The float32 sums of ``einsum(spec, x, w)``, both operands in
    ``x``'s dtype, rounded nowhere. On CUDA a bf16 pair goes to a bf16 x
    bf16 -> float32 GEMM (``torch.mm`` with ``out_dtype``), so no float32
    copy of the weight is made; ``spec`` must then contract x's trailing
    dims with w's leading dims, in order, as every projection of the
    model does. Elsewhere the operands are taken in float32, where a bf16
    value, and the product of two, is exact."""
    if x.device.type != 'cuda' or x.dtype == torch.float32:
        return torch.einsum(spec, x.float(), w.float())
    ins, out = spec.split('->')
    xs, ws = ins.split(',')
    n = sum(c not in out for c in ws)
    if xs[len(xs) - n:] != ws[:n] or out != xs[:len(xs) - n] + ws[n:]:
        raise ValueError(f'mm: {spec!r} does not contract the trailing '
                         "dims of x with the leading dims of w")
    k = math.prod(w.shape[:n])
    y = torch.mm(x.reshape(-1, k), w.reshape(k, -1), out_dtype=torch.float32)
    return y.reshape(*x.shape[:x.dim() - n], *w.shape[n:])


def mm(x: torch.Tensor, w: Any, spec: str,
       out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``einsum(spec, x, w)`` that also takes a quantized weight: the
    product of ``x`` and the int8 codes cast to ``x``'s dtype (exact in
    bf16: |q| <= 127) yields float32 sums, each output channel is scaled,
    and the result is rounded once, to ``out_dtype`` or ``x``'s dtype, as
    the JAX package's ``preferred_element_type=float32`` product is. The
    scale's dims are the weight's non-contracted dims, which the einsum
    emits as the output's trailing dims, so the scale broadcasts from the
    right. ``out_dtype`` plays the part of JAX's
    ``preferred_element_type``: float32 asks for the float32 sums of the
    products, which a product in ``x``'s dtype would round to that dtype
    first (bf16 logits tie far more often than the reference's)."""
    if not is_quantized(w):
        if out_dtype == torch.float32 and x.dtype != torch.float32:
            return _sums_f32(spec, x, w)
        y = torch.einsum(spec, x, w)
        return y if out_dtype is None else y.to(out_dtype)
    y = _sums_f32(spec, x, w['q8'].to(x.dtype)) * w['s']
    return y.to(out_dtype if out_dtype is not None else x.dtype)

