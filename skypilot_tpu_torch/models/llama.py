"""Llama-family transformer in PyTorch: serving parts and the training
forward.

Port of ``skypilot_tpu/models/llama.py``: the same config, presets and
weight tree, so a JAX tree carried over by ``params_from_numpy`` drops
into the port unchanged. Weights are stacked over layers (``[L, ...]``
leaves under ``layers``), exactly the JAX scan layout, and stay stacked
in training too: Adafactor factors and scales each stacked leaf as a whole
(``train/optim.py``), as optax does.

The training forward (``forward_with_aux``, ``forward``, ``loss_fn``)
runs the layers in a Python loop (JAX: ``lax.scan``) with attention
through ``ops.attention.flash_attention`` (K1 forward, K2/K3 backward on
the card). Remat policies map onto ``torch.utils.checkpoint``.
An MoE model (``num_experts > 0``) takes ``models/moe.py``'s block in
place of the dense MLP under ``layers/moe``; its balance loss is summed
over the layers and weighted into ``loss_fn`` as in the JAX package.
Pipeline stages raise ``NotImplementedError``; sequence parallelism
is not ported. ``param_logical_axes`` and ``init_params_sharded`` give a
dense model's serving weights on a tensor-parallel mesh
(``parallel/``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from skypilot_tpu_torch.models import moe
from skypilot_tpu_torch.ops.attention import flash_attention
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

    @property
    def active_param_count(self) -> int:
        """``param_count`` with only the ``expert_top_k`` experts a token
        runs through counted (equal to it for a dense model)."""
        if self.num_experts == 0:
            return self.param_count
        unused = self.num_experts - self.expert_top_k
        return self.param_count - self.n_layers * unused * 3 * \
            self.d_model * self.d_ff


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


# -- params -------------------------------------------------------------------


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Random weights in the JAX tree and layout (``llama.py:105``):
    normal(0, fan_in**-0.5) in ``cfg.dtype``, norms at one, and the
    embedding scaled by ``d_model**0.5``. ``generator`` must live on
    ``device``. The values differ from ``jax.random``'s for the same
    seed; tests carry JAX weights over with ``params_from_numpy``. An
    MoE model's layers hold ``moe`` (``models/moe.py``) in place of
    ``w_gate``/``w_up``/``w_down``."""
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
    }
    if cfg.num_experts > 0:
        layers['moe'] = moe.init_moe_params(generator, L, d, cfg.d_ff,
                                            cfg.num_experts, cfg.dtype, dev)
    else:
        layers['w_gate'] = dense_init((L, d, cfg.d_ff), d)
        layers['w_up'] = dense_init((L, d, cfg.d_ff), d)
        layers['w_down'] = dense_init((L, cfg.d_ff, d), cfg.d_ff)
    return {
        'embed': dense_init((cfg.vocab_size, d), d) * (d ** 0.5),
        'layers': layers,
        'final_norm': norm_init((d,)),
        'lm_head': dense_init((d, cfg.vocab_size), d),
    }


def param_logical_axes(cfg: LlamaConfig) -> Params:
    """Logical sharding axes matching ``init_params``' tree (leaves are
    tuples), JAX's ``llama.param_logical_axes``, for dense configs (the
    MoE block's axes come with sharded training)."""
    if cfg.num_experts > 0:
        raise NotImplementedError(
            'moe_logical_axes is not ported yet: skypilot_tpu_torch shards '
            'dense models only')
    return {
        'embed': ('vocab', 'embed'),
        'layers': {
            'attn_norm': ('layers', None),
            'wq': ('layers', 'embed', 'heads', 'head_dim'),
            'wk': ('layers', 'embed', 'kv_heads', 'head_dim'),
            'wv': ('layers', 'embed', 'kv_heads', 'head_dim'),
            'wo': ('layers', 'heads', 'head_dim', 'embed'),
            'mlp_norm': ('layers', None),
            'w_gate': ('layers', 'embed', 'mlp'),
            'w_up': ('layers', 'embed', 'mlp'),
            'w_down': ('layers', 'mlp', 'embed'),
        },
        'final_norm': (None,),
        'lm_head': ('embed', 'vocab'),
    }


def init_params_sharded(cfg: LlamaConfig, generator: torch.Generator,
                        mesh, rules=None, device: DeviceLike = None
                        ) -> Params:
    """This rank's slices of ``init_params``' tree on ``mesh``, cut by
    ``param_logical_axes``: concatenated over the ranks they equal
    ``init_params``' tensors from the same generator state bit for bit,
    so a tp=1 and a tp=N replica serve the same weights from one seed.
    Leaf by leaf, in ``init_params``' draw order, the whole leaf is drawn
    in float32 (the generator's stream cannot be cut), this rank's slice
    is kept in ``cfg.dtype`` and the rest freed, so no device holds the
    whole model. Ranks that share one device take turns, so that only
    one whole leaf is drawn on it at a time."""
    from skypilot_tpu_torch.parallel import collectives
    from skypilot_tpu_torch.parallel import sharding as sharding_lib
    rules = rules or sharding_lib.ShardingRules()
    axes = param_logical_axes(cfg)
    dev = resolve_device(device)
    d, L = cfg.d_model, cfg.n_layers

    def spec(logical):
        return sharding_lib.logical_sharding(mesh, rules, logical)

    def norm_init(shape, logical):
        return torch.ones(sharding_lib.local_shape(shape, spec(logical)),
                          dtype=cfg.dtype, device=dev)

    def dense_init(shape, fan_in, logical):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        part = sharding_lib.local_slice(w, spec(logical))
        del w
        return (part * fan_in ** -0.5).to(cfg.dtype)

    def build() -> Params:
        la = axes['layers']
        layers = {
            'attn_norm': norm_init((L, d), la['attn_norm']),
            'wq': dense_init((L, d, cfg.n_heads, cfg.head_dim), d, la['wq']),
            'wk': dense_init((L, d, cfg.n_kv_heads, cfg.head_dim), d,
                             la['wk']),
            'wv': dense_init((L, d, cfg.n_kv_heads, cfg.head_dim), d,
                             la['wv']),
            'wo': dense_init((L, cfg.n_heads, cfg.head_dim, d),
                             cfg.n_heads * cfg.head_dim, la['wo']),
            'mlp_norm': norm_init((L, d), la['mlp_norm']),
            'w_gate': dense_init((L, d, cfg.d_ff), d, la['w_gate']),
            'w_up': dense_init((L, d, cfg.d_ff), d, la['w_up']),
            'w_down': dense_init((L, cfg.d_ff, d), cfg.d_ff, la['w_down']),
        }
        return {
            'embed': dense_init((cfg.vocab_size, d), d,
                                axes['embed']) * (d ** 0.5),
            'layers': layers,
            'final_norm': norm_init((d,), axes['final_norm']),
            'lm_head': dense_init((d, cfg.vocab_size), d, axes['lm_head']),
        }

    return collectives.take_turns(mesh, build)


def params_from_numpy(tree: Any, cfg: LlamaConfig,
                      device: DeviceLike = None) -> Params:
    """Carry a JAX weight tree, given as numpy arrays, into the port:
    a key-for-key copy. Int8 ``q8`` codes stay int8, and ``s`` scales
    (``models/quantization.py``) and the MoE ``router`` stay float32;
    every other leaf becomes ``cfg.dtype``. ``torch.from_numpy`` cannot
    read ``ml_dtypes``' bfloat16, so such leaves go through float32
    first, which is exact."""
    dev = resolve_device(device)

    def leaf(key: str, arr) -> torch.Tensor:
        arr = np.asarray(arr)
        if arr.dtype.name == 'bfloat16':
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.array(arr))  # a writable copy
        if key == 'q8':
            dtype = torch.int8
        elif key in ('s', 'router'):
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


# -- the training forward -----------------------------------------------------


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum('bsd,d...->bs...', x, w)`` as one matmul."""
    out = x @ w.reshape(w.shape[0], -1)
    return out.view(*x.shape[:-1], *w.shape[1:])


def _qkv(cfg: LlamaConfig, x: torch.Tensor, layer: Params):
    """Attention norm and the q/k/v projections (JAX: 'qkv_proj')."""
    h = rms_norm(x, layer['attn_norm'], cfg.norm_eps)
    return (_project(h, layer['wq']), _project(h, layer['wk']),
            _project(h, layer['wv']))


def _attend(cfg: LlamaConfig, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """RoPE and causal flash attention: [B, S, H, D] in and out
    (JAX: 'attn_out')."""
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return flash_attention(qt, kt, vt, causal=True).transpose(1, 2)


def _attn_residual(x: torch.Tensor, att: torch.Tensor,
                   layer: Params) -> torch.Tensor:
    """x + att . wo (JAX: 'attn_proj')."""
    wo = layer['wo']
    return x + att.reshape(*att.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1])


def _mlp_hidden(cfg: LlamaConfig, x: torch.Tensor, layer: Params):
    """MLP norm and the gate/up projections."""
    h = rms_norm(x, layer['mlp_norm'], cfg.norm_eps)
    return h @ layer['w_gate'], h @ layer['w_up']


def _mlp_down(gate: torch.Tensor, up: torch.Tensor,
              layer: Params) -> torch.Tensor:
    """silu(gate) * up . w_down (JAX: 'mlp_down')."""
    return (F.silu(gate) * up) @ layer['w_down']


def _mlp(cfg: LlamaConfig, x: torch.Tensor, layer: Params) -> torch.Tensor:
    return _mlp_down(*_mlp_hidden(cfg, x, layer), layer)


def _ffn(cfg: LlamaConfig, x: torch.Tensor, layer: Params
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's back half without its residual: (out, aux). An MoE
    model runs the MLP norm and ``models/moe.py``'s block; the dense MLP's
    aux is 0."""
    if cfg.num_experts > 0:
        h = rms_norm(x, layer['mlp_norm'], cfg.norm_eps)
        return moe.moe_mlp(h, layer['moe'], cfg.num_experts,
                           cfg.expert_top_k, cfg.expert_capacity_factor)
    return _mlp(cfg, x, layer), x.new_zeros((), dtype=torch.float32)


def _decoder_layer(cfg: LlamaConfig, x: torch.Tensor, layer: Params,
                   positions: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder block (``llama.py:217``); returns (x, aux), aux being
    the MoE block's balance loss (0 for the dense MLP)."""
    att = _attend(cfg, *_qkv(cfg, x, layer), positions)
    x = _attn_residual(x, att, layer)
    out, aux = _ffn(cfg, x, layer)
    return x + out, aux


def _ckpt(fn: Callable, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def _remat_full(cfg, x, layer, positions):
    return _ckpt(lambda x_: _decoder_layer(cfg, x_, layer, positions), x)


def _remat_attn(cfg, x, layer, positions):
    att = _ckpt(lambda x_: _attend(cfg, *_qkv(cfg, x_, layer), positions), x)

    def rest(x_, att_):
        x_ = _attn_residual(x_, att_, layer)
        out, aux = _ffn(cfg, x_, layer)
        return x_ + out, aux
    return _ckpt(rest, x, att)


def _remat_heavy(cfg, x, layer, positions):
    q, k, v = _ckpt(lambda x_: _qkv(cfg, x_, layer), x)
    att = _ckpt(lambda *t: _attend(cfg, *t, positions), q, k, v)
    x = _attn_residual(x, att, layer)
    out, aux = _ckpt(lambda x_: _ffn(cfg, x_, layer), x)
    return x + out, aux


def _remat_dots(cfg, x, layer, positions):
    if cfg.num_experts > 0:
        return _remat_heavy(cfg, x, layer, positions)
    q, k, v = _ckpt(lambda x_: _qkv(cfg, x_, layer), x)
    att = _ckpt(lambda *t: _attend(cfg, *t, positions), q, k, v)
    x = _attn_residual(x, att, layer)
    gate, up = _ckpt(lambda x_: _mlp_hidden(cfg, x_, layer), x)
    return x + _mlp_down(gate, up, layer), x.new_zeros((), dtype=torch.float32)


# The JAX policies (``llama.py:267``) name the matmul outputs XLA may keep.
# Here each policy checkpoints segments of the layer, so the backward keeps
# the segment boundaries and recomputes the rest; the attention segment
# (RoPE + flash attention) is always recomputed, as under XLA, where the
# kernel's residuals carry no name. Per layer the backward keeps:
#   full:  the layer input x;
#   attn:  x and the attention output att;
#   heavy: x, q/k/v before RoPE, att, and x after the attention residual;
#   dots:  as heavy, plus gate, up and the products the plain MLP tail
#          saves (silu(gate), silu(gate) * up).
# The MoE block is one segment wherever the dense MLP is recomputed (and
# under 'dots' too, as under 'heavy'). Every policy returns (x, aux), and
# gradients do not depend on the policy.
REMAT_POLICIES: Dict[str, Callable] = {
    'full': _remat_full,
    'attn': _remat_attn,
    'dots': _remat_dots,
    'heavy': _remat_heavy,
}


def _unstack(layers: Params) -> list:
    """The stacked ``layers`` tree as one tree per layer. Each stacked
    leaf is unbound once, so the backward stacks each leaf's layer
    gradients into one ``[L, ...]`` tensor (indexing ``leaf[i]`` would
    give every layer its own full-size zero gradient)."""
    per_leaf = {}
    for name, leaf in layers.items():
        if isinstance(leaf, dict):  # the MoE block's leaves
            parts = {k: v.unbind(0) for k, v in leaf.items()}
            per_leaf[name] = [dict(zip(parts, vals))
                              for vals in zip(*parts.values())]
        else:
            per_leaf[name] = leaf.unbind(0)
    n = len(next(iter(per_leaf.values())))
    return [{name: leaves[i] for name, leaves in per_leaf.items()}
            for i in range(n)]


def _layer_stack(cfg: LlamaConfig, x: torch.Tensor, layers: Params,
                 positions: torch.Tensor, remat: bool,
                 remat_policy: str = 'full'
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer loop (JAX: ``lax.scan``); returns (x, aux_sum)."""
    if remat and remat_policy not in REMAT_POLICIES:
        raise ValueError(f'Unknown remat_policy {remat_policy!r}; choose '
                         f'from {sorted(REMAT_POLICIES)}')
    aux = x.new_zeros((), dtype=torch.float32)
    for layer in _unstack(layers):
        if remat:
            x, a = REMAT_POLICIES[remat_policy](cfg, x, layer, positions)
        else:
            x, a = _decoder_layer(cfg, x, layer, positions)
        aux = aux + a
    return x, aux


def forward_with_aux(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
                     remat: bool = False, remat_policy: str = 'full'
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, vocab] fp32, aux loss).

    The unembedding multiplies float32 copies of x and ``lm_head``: exact
    for bf16 operands, as JAX's ``preferred_element_type=float32`` is."""
    if cfg.pipeline_stages > 1:
        raise NotImplementedError('pipeline stages are not ported yet')
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    x = F.embedding(tokens.long(), params['embed'].to(cfg.dtype))
    x, aux = _layer_stack(cfg, x, params['layers'], positions, remat,
                          remat_policy)
    x = rms_norm(x, params['final_norm'], cfg.norm_eps)
    return x.float() @ params['lm_head'].float(), aux


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            remat: bool = False) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, vocab] (fp32)."""
    return forward_with_aux(params, tokens, cfg, remat=remat)[0]


MOE_AUX_WEIGHT = 0.01


def loss_fn(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            remat: bool = True, remat_policy: str = 'full'
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy over tokens[:, 1:] (``llama.py:398``):
    the forward runs on the full sequence and logits[:, :-1] predict
    tokens[:, 1:]. Returns (total, {'loss', 'perplexity'}); an MoE model
    adds ``MOE_AUX_WEIGHT`` times the per-layer mean balance loss to the
    total and reports that mean as ``moe_aux``."""
    logits, aux = forward_with_aux(params, tokens, cfg, remat=remat,
                                   remat_policy=remat_policy)
    logits = logits[:, :-1]
    targets = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None]).squeeze(-1)
    nll = (logz - gold).mean()
    metrics = {'loss': nll, 'perplexity': torch.exp(nll)}
    total = nll
    if cfg.num_experts > 0:
        aux_mean = aux / cfg.n_layers
        total = nll + MOE_AUX_WEIGHT * aux_mean
        metrics['moe_aux'] = aux_mean
    return total, metrics
