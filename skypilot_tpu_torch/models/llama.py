"""Llama-family transformer: the dense serving parts, in PyTorch.

Port of ``skypilot_tpu/models/llama.py``: the same config, presets and
weight tree, so a JAX tree carried over by ``params_from_numpy`` drops
into the port unchanged. Weights are stacked over layers (``[L, ...]``
leaves under ``layers``), exactly the JAX scan layout.

Only what the serving path needs is here: the full-sequence ``forward``,
``loss_fn``, remat and MoE come with the training slice. For
``num_experts > 0`` the functions that would need MoE raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from skypilot_tpu_torch.utils.device import DeviceLike, resolve_device

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14_336
    head_dim: int = 128
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    dtype: torch.dtype = torch.bfloat16
    num_experts: int = 0
    expert_top_k: int = 2
    expert_capacity_factor: float = 1.5
    pipeline_stages: int = 1
    pipeline_microbatches: int = 1

    @property
    def param_count(self) -> int:
        d, L = self.d_model, self.n_layers
        attn = d * self.n_heads * self.head_dim * 2 + \
            d * self.n_kv_heads * self.head_dim * 2
        if self.num_experts > 0:
            mlp = self.num_experts * 3 * d * self.d_ff + d * self.num_experts
        else:
            mlp = 3 * d * self.d_ff
        embed = self.vocab_size * d * 2  # in + out (untied)
        return L * (attn + mlp + 2 * d) + embed + d


# -- presets (same widths as the JAX package) ---------------------------------

LLAMA3_8B = LlamaConfig()
LLAMA3_1B = LlamaConfig(vocab_size=128_256, d_model=2048, n_layers=16,
                        n_heads=32, n_kv_heads=8, d_ff=8192, head_dim=64)
BENCH_1B = LlamaConfig(vocab_size=32_768, d_model=2048, n_layers=18,
                       n_heads=16, n_kv_heads=8, d_ff=7168, head_dim=128,
                       max_seq_len=4096)
TINY = LlamaConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                   n_kv_heads=2, d_ff=128, head_dim=16, max_seq_len=512)
MOE_TINY = dataclasses.replace(TINY, num_experts=4, expert_top_k=2)
MOE_8X1B = dataclasses.replace(BENCH_1B, num_experts=8, expert_top_k=2)
TINY_MH = dataclasses.replace(TINY, n_heads=8, n_kv_heads=8)
BENCH_DRAFT = LlamaConfig(vocab_size=32_768, d_model=512, n_layers=4,
                          n_heads=8, n_kv_heads=8, d_ff=1536,
                          head_dim=64, max_seq_len=4096)

PRESETS = {'llama3-8b': LLAMA3_8B, 'llama3-1b': LLAMA3_1B,
           'bench-1b': BENCH_1B, 'bench-draft': BENCH_DRAFT,
           'tiny': TINY, 'moe-tiny': MOE_TINY,
           'moe-8x1b': MOE_8X1B, 'tiny-mh': TINY_MH}


def require_dense(cfg: LlamaConfig) -> None:
    if cfg.num_experts > 0:
        raise NotImplementedError(
            'MoE models are not ported yet (skypilot_tpu_torch serves '
            'dense models only)')


# -- params -------------------------------------------------------------------


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Random weights in the JAX tree and layout (``llama.py:105``):
    normal(0, fan_in**-0.5) in ``cfg.dtype``, norms at one, and the
    embedding scaled by ``d_model**0.5``. ``generator`` must live on
    ``device``. The values differ from ``jax.random``'s for the same
    seed; tests carry JAX weights over with ``params_from_numpy``."""
    require_dense(cfg)
    dev = resolve_device(device)
    d, L = cfg.d_model, cfg.n_layers

    def norm_init(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    def dense_init(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (w * fan_in ** -0.5).to(cfg.dtype)

    layers = {
        'attn_norm': norm_init((L, d)),
        'wq': dense_init((L, d, cfg.n_heads, cfg.head_dim), d),
        'wk': dense_init((L, d, cfg.n_kv_heads, cfg.head_dim), d),
        'wv': dense_init((L, d, cfg.n_kv_heads, cfg.head_dim), d),
        'wo': dense_init((L, cfg.n_heads, cfg.head_dim, d),
                         cfg.n_heads * cfg.head_dim),
        'mlp_norm': norm_init((L, d)),
        'w_gate': dense_init((L, d, cfg.d_ff), d),
        'w_up': dense_init((L, d, cfg.d_ff), d),
        'w_down': dense_init((L, cfg.d_ff, d), cfg.d_ff),
    }
    return {
        'embed': dense_init((cfg.vocab_size, d), d) * (d ** 0.5),
        'layers': layers,
        'final_norm': norm_init((d,)),
        'lm_head': dense_init((d, cfg.vocab_size), d),
    }


def params_from_numpy(tree: Any, cfg: LlamaConfig,
                      device: DeviceLike = None) -> Params:
    """Carry a JAX weight tree, given as numpy arrays, into the port:
    a key-for-key copy. Int8 ``q8`` codes stay int8 and ``s`` scales stay
    float32 (``models/quantization.py``); every other leaf becomes
    ``cfg.dtype``. ``torch.from_numpy`` cannot read ``ml_dtypes``'
    bfloat16, so such leaves go through float32 first, which is exact."""
    dev = resolve_device(device)

    def leaf(key: str, arr) -> torch.Tensor:
        arr = np.asarray(arr)
        if arr.dtype.name == 'bfloat16':
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.array(arr))  # a writable copy
        if key == 'q8':
            dtype = torch.int8
        elif key == 's':
            dtype = torch.float32
        else:
            dtype = cfg.dtype
        return t.to(device=dev, dtype=dtype)

    def walk(key: str, node):
        if isinstance(node, dict):
            return {k: walk(k, v) for k, v in node.items()}
        return leaf(key, node)

    return walk('', tree)


# -- building blocks ----------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """In float32, cast back to ``x``'s dtype, then times ``weight``
    (the JAX cast order)."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * weight


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         ) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S]. Angles in float32."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs  # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def layer_params(layers: Params, index: int) -> Params:
    """One layer's slice of the stacked ``layers`` tree (views, no copy);
    quantized ``{'q8', 's'}`` leaves are sliced leaf by leaf."""
    out: Params = {}
    for name, leaf in layers.items():
        if isinstance(leaf, dict):
            out[name] = {k: v[index] for k, v in leaf.items()}
        else:
            out[name] = leaf[index]
    return out
