"""LoRA adapters for the llama family: a tree transformation, not module
surgery.

Port of ``skypilot_tpu/models/lora.py`` for one device. Adapters are a
separate tree mirroring the targeted weights, stacked over layers like
the base params (``[L, ...]`` leaves). ``merge`` computes the effective
weight ``W + (alpha / r) * A @ B`` inside the train step (in float32,
rounded once to the weight's dtype, as JAX rounds it). Gradients are
taken with respect to the adapters only: the base tensors carry no
``requires_grad``, so the base is frozen by construction and the
optimizer state is adapter-sized.

A carries the target's input dims and a ``rank`` dim, B ``rank`` and the
output dims. ``lora_logical_axes`` (sharding of the adapters) goes with
the mesh, which the port does not have yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.utils.device import DeviceLike, resolve_device

Params = Dict[str, Any]

# Per target: the number of input dims of the stacked weight after the
# leading layer dim; the rest are output dims. E.g. wq (L, d, heads,
# head_dim) contracts d -> (heads, head_dim).
_TARGET_IN_DIMS = {
    'wq': 1, 'wk': 1, 'wv': 1,  # (L, d, n_heads/kv, head_dim)
    'wo': 2,                    # (L, heads, head_dim, d)
    'w_gate': 1, 'w_up': 1,     # (L, d, d_ff)
    'w_down': 1,                # (L, d_ff, d)
}

DEFAULT_TARGETS = ('wq', 'wk', 'wv', 'wo')
ALL_TARGETS = tuple(_TARGET_IN_DIMS)


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 16
    alpha: float = 32.0
    targets: Tuple[str, ...] = DEFAULT_TARGETS

    def __post_init__(self):
        if self.rank <= 0:
            raise ValueError(f'LoRA rank must be positive, got {self.rank}')
        unknown = set(self.targets) - set(_TARGET_IN_DIMS)
        if unknown:
            raise ValueError(
                f'Unknown LoRA targets {sorted(unknown)}; choose from '
                f'{sorted(_TARGET_IN_DIMS)}')

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _split_shape(w_shape: Tuple[int, ...], target: str):
    """(layer, *in, *out) split of a stacked weight's shape."""
    n_in = _TARGET_IN_DIMS[target]
    return w_shape[0], tuple(w_shape[1:1 + n_in]), tuple(w_shape[1 + n_in:])


def _check_targets(layer_keys, targets) -> None:
    """Raise the actionable error of the JAX package, not a KeyError, for
    a target the model does not have (an MoE model has no dense MLP)."""
    missing = [t for t in targets if t not in layer_keys]
    if missing:
        raise ValueError(
            f'LoRA target(s) {missing} not in this model (MoE models '
            "adapt attention only: targets=('wq','wk','wv','wo'))")


def init_lora(generator: torch.Generator, params: Params, cfg: LoraConfig,
              dtype: torch.dtype = torch.bfloat16,
              device: DeviceLike = None) -> Params:
    """Adapter tree for the targeted layer weights, in sorted target
    order: A ~ N(0, 1/fan_in) drawn in float32 from ``generator`` (which
    must live on ``device``), B = 0, so the merged model starts exactly
    at the base (delta zero). The draws differ from ``jax.random``'s; the
    tests carry JAX's adapters over with ``lora_from_numpy``."""
    dev = resolve_device(device)
    layers = params['layers']
    _check_targets(layers, cfg.targets)
    adapters: Params = {}
    for target in sorted(cfg.targets):
        n_layers, in_shape, out_shape = _split_shape(
            tuple(layers[target].shape), target)
        fan_in = int(np.prod(in_shape))
        a = torch.randn((n_layers, *in_shape, cfg.rank),
                        generator=generator, dtype=torch.float32,
                        device=dev)
        adapters[target] = {
            'a': (a * fan_in ** -0.5).to(dtype),
            'b': torch.zeros((n_layers, cfg.rank, *out_shape), dtype=dtype,
                             device=dev),
        }
    return adapters


def lora_from_numpy(tree: Any, device: DeviceLike = None) -> Params:
    """Carry a JAX adapter tree, given as numpy arrays, into the port,
    each leaf in its own dtype (``ml_dtypes``' bfloat16 goes through
    float32, which is exact)."""
    dev = resolve_device(device)

    def leaf(arr) -> torch.Tensor:
        arr = np.asarray(arr)
        if arr.dtype.name == 'bfloat16':
            return torch.from_numpy(arr.astype(np.float32)).to(
                device=dev, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(arr)).to(dev)

    return {t: {k: leaf(v) for k, v in ab.items()} for t, ab in tree.items()}


def _delta(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(L, *in, r) x (L, r, *out) -> (L, *in, *out), batched over the
    layer dim: one batched matmul."""
    n_layers, r = a.shape[0], a.shape[-1]
    in_shape, out_shape = a.shape[1:-1], b.shape[2:]
    out = torch.bmm(a.reshape(n_layers, -1, r), b.reshape(n_layers, r, -1))
    return out.view(n_layers, *in_shape, *out_shape)


def merge(params: Params, adapters: Params, cfg: LoraConfig) -> Params:
    """Effective params: each targeted weight becomes
    ``(W.float() + scale * A@B in float32).to(W.dtype)``; every other
    leaf is the same tensor (same tree, so ``loss_fn``, ``generate`` and
    checkpointing take it unchanged)."""
    layers = dict(params['layers'])
    for target, ab in adapters.items():
        w = layers[target]
        delta = _delta(ab['a'].float(), ab['b'].float())
        layers[target] = (w.float() + cfg.scale * delta).to(w.dtype)
    return {**params, 'layers': layers}


def param_count(adapters: Params) -> int:
    return sum(leaf.numel() for ab in adapters.values()
               for leaf in ab.values())
