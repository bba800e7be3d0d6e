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
``param_logical_axes`` and ``init_params_sharded`` give a dense model's
weights on a mesh (``parallel/``).

With ``mesh=`` (one process per rank, each holding its slices of the
weights as ``param_logical_axes`` places them) the training forward
issues the collectives JAX's GSPMD inserts (``llama.py:300-426``): each
layer's weights are all-gathered over ``fsdp`` inside the layer's
checkpointed segment (the backward gathers them again and
reduce-scatters their gradients), q/k/v and gate/up are column-split
over ``tensor`` and ``wo``/``w_down`` row-split with a ``psum`` before
the residual add, K1 runs on the rank's rows and head shard, the
embedding is a masked lookup over the rank's vocab block and a ``psum``,
and the logits stay vocab-split: the log-sum-exp takes a ``pmax`` and a
``psum`` of the exps, the gold logit a masked ``psum``. ``loss_fn``
returns the rank's share of the global mean (its rows' summed loss over
the global token count), whose gradients summed over the batch axes are
the global mean's. Pipeline stages, sequence parallelism (``seq``), the
``expert`` axis and MoE models under a mesh raise
``NotImplementedError`` (ROADMAP section 1, item 1).
"""
from __future__ import annotations

import dataclasses
import math
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
            'dense models only (ROADMAP section 1, item 1)')
    return {
        'embed': ('vocab', 'embed'),
        'layers': dict(DENSE_LAYER_AXES),
        'final_norm': (None,),
        'lm_head': ('embed', 'vocab'),
    }


# The dense layer's logical axes (JAX's ``llama.py:160-178``).
DENSE_LAYER_AXES = {
    'attn_norm': ('layers', None),
    'wq': ('layers', 'embed', 'heads', 'head_dim'),
    'wk': ('layers', 'embed', 'kv_heads', 'head_dim'),
    'wv': ('layers', 'embed', 'kv_heads', 'head_dim'),
    'wo': ('layers', 'heads', 'head_dim', 'embed'),
    'mlp_norm': ('layers', None),
    'w_gate': ('layers', 'embed', 'mlp'),
    'w_up': ('layers', 'embed', 'mlp'),
    'w_down': ('layers', 'mlp', 'embed'),
}


def param_shapes(cfg: LlamaConfig) -> Params:
    """The whole shape of every leaf of a dense ``init_params`` tree."""
    d, L, hd = cfg.d_model, cfg.n_layers, cfg.head_dim
    return {
        'embed': (cfg.vocab_size, d),
        'layers': {
            'attn_norm': (L, d),
            'wq': (L, d, cfg.n_heads, hd),
            'wk': (L, d, cfg.n_kv_heads, hd),
            'wv': (L, d, cfg.n_kv_heads, hd),
            'wo': (L, cfg.n_heads, hd, d),
            'mlp_norm': (L, d),
            'w_gate': (L, d, cfg.d_ff),
            'w_up': (L, d, cfg.d_ff),
            'w_down': (L, cfg.d_ff, d),
        },
        'final_norm': (d,),
        'lm_head': (d, cfg.vocab_size),
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


def _column(h: torch.Tensor, mesh) -> torch.Tensor:
    """A replicated activation entering a column-split product: its
    gradient is summed over ``tensor``."""
    if mesh is None:
        return h
    from skypilot_tpu_torch.parallel import collectives
    return collectives.copy_to(h, mesh, 'tensor')


def _row(out: torch.Tensor, mesh) -> torch.Tensor:
    """A row-split product's partial sums, summed over ``tensor``."""
    if mesh is None:
        return out
    from skypilot_tpu_torch.parallel import collectives
    return collectives.reduce_from(out, mesh, 'tensor')


def _qkv(cfg: LlamaConfig, x: torch.Tensor, layer: Params, mesh=None):
    """Attention norm and the q/k/v projections (JAX: 'qkv_proj')."""
    h = _column(rms_norm(x, layer['attn_norm'], cfg.norm_eps), mesh)
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
                   layer: Params, mesh=None) -> torch.Tensor:
    """x + att . wo (JAX: 'attn_proj')."""
    wo = layer['wo']
    return x + _row(att.reshape(*att.shape[:2], -1)
                    @ wo.reshape(-1, wo.shape[-1]), mesh)


def _mlp_hidden(cfg: LlamaConfig, x: torch.Tensor, layer: Params,
                mesh=None):
    """MLP norm and the gate/up projections."""
    h = _column(rms_norm(x, layer['mlp_norm'], cfg.norm_eps), mesh)
    return h @ layer['w_gate'], h @ layer['w_up']


def _mlp_down(gate: torch.Tensor, up: torch.Tensor,
              layer: Params, mesh=None) -> torch.Tensor:
    """silu(gate) * up . w_down (JAX: 'mlp_down')."""
    return _row((F.silu(gate) * up) @ layer['w_down'], mesh)


def _mlp(cfg: LlamaConfig, x: torch.Tensor, layer: Params,
         mesh=None) -> torch.Tensor:
    return _mlp_down(*_mlp_hidden(cfg, x, layer, mesh), layer, mesh)


def _ffn(cfg: LlamaConfig, x: torch.Tensor, layer: Params, mesh=None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's back half without its residual: (out, aux). An MoE
    model runs the MLP norm and ``models/moe.py``'s block; the dense MLP's
    aux is 0."""
    if cfg.num_experts > 0:
        h = rms_norm(x, layer['mlp_norm'], cfg.norm_eps)
        return moe.moe_mlp(h, layer['moe'], cfg.num_experts,
                           cfg.expert_top_k, cfg.expert_capacity_factor)
    return _mlp(cfg, x, layer, mesh), x.new_zeros((), dtype=torch.float32)


def _decoder_layer(cfg: LlamaConfig, x: torch.Tensor, layer: Params,
                   positions: torch.Tensor, mesh=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder block (``llama.py:217``); returns (x, aux), aux being
    the MoE block's balance loss (0 for the dense MLP)."""
    att = _attend(cfg, *_qkv(cfg, x, layer, mesh), positions)
    x = _attn_residual(x, att, layer, mesh)
    out, aux = _ffn(cfg, x, layer, mesh)
    return x + out, aux


def _ckpt(fn: Callable, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def _remat_full(cfg, x, layer, positions, mesh=None):
    return _ckpt(lambda x_: _decoder_layer(cfg, x_, layer, positions, mesh),
                 x)


def _remat_attn(cfg, x, layer, positions, mesh=None):
    att = _ckpt(lambda x_: _attend(cfg, *_qkv(cfg, x_, layer, mesh),
                                   positions), x)

    def rest(x_, att_):
        x_ = _attn_residual(x_, att_, layer, mesh)
        out, aux = _ffn(cfg, x_, layer, mesh)
        return x_ + out, aux
    return _ckpt(rest, x, att)


def _remat_heavy(cfg, x, layer, positions, mesh=None):
    q, k, v = _ckpt(lambda x_: _qkv(cfg, x_, layer, mesh), x)
    att = _ckpt(lambda *t: _attend(cfg, *t, positions), q, k, v)
    x = _attn_residual(x, att, layer, mesh)
    out, aux = _ckpt(lambda x_: _ffn(cfg, x_, layer, mesh), x)
    return x + out, aux


def _remat_dots(cfg, x, layer, positions, mesh=None):
    if cfg.num_experts > 0:
        return _remat_heavy(cfg, x, layer, positions)
    q, k, v = _ckpt(lambda x_: _qkv(cfg, x_, layer, mesh), x)
    att = _ckpt(lambda *t: _attend(cfg, *t, positions), q, k, v)
    x = _attn_residual(x, att, layer, mesh)
    gate, up = _ckpt(lambda x_: _mlp_hidden(cfg, x_, layer, mesh), x)
    return (x + _mlp_down(gate, up, layer, mesh),
            x.new_zeros((), dtype=torch.float32))


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
# gradients do not depend on the policy. On a mesh a weight is gathered
# over fsdp where a segment reads it, so a checkpointed segment gathers
# again in the backward (JAX's ``jax.checkpoint`` over the gathered
# params); a weight read outside one ('wo' under heavy and dots, 'w_down'
# under dots) stays gathered until its gradient is taken.
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


class _Gathered:
    """One layer's weight shards, each gathered over ``fsdp`` where it is
    read (``collectives.gather_fsdp``: its gradient comes back
    reduce-scattered)."""

    def __init__(self, layer: Params, mesh, rules):
        self._layer, self._mesh = layer, mesh
        self._dims = {
            name: [d - 1 for d, entry in enumerate(
                rules.mesh_axes(DENSE_LAYER_AXES[name]))
                if entry is not None and 'fsdp' in (
                    (entry,) if isinstance(entry, str) else entry)]
            for name in layer}

    def __getitem__(self, name: str) -> torch.Tensor:
        from skypilot_tpu_torch.parallel import collectives
        w = self._layer[name]
        for dim in self._dims[name]:
            w = collectives.gather_fsdp(w, self._mesh, dim)
        return w


def _layer_stack(cfg: LlamaConfig, x: torch.Tensor, layers: Params,
                 positions: torch.Tensor, remat: bool,
                 remat_policy: str = 'full', mesh=None, rules=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer loop (JAX: ``lax.scan``); returns (x, aux_sum)."""
    if remat and remat_policy not in REMAT_POLICIES:
        raise ValueError(f'Unknown remat_policy {remat_policy!r}; choose '
                         f'from {sorted(REMAT_POLICIES)}')
    aux = x.new_zeros((), dtype=torch.float32)
    for layer in _unstack(layers):
        if mesh is not None:
            layer = _Gathered(layer, mesh, rules)
        if remat:
            x, a = REMAT_POLICIES[remat_policy](cfg, x, layer, positions,
                                                mesh)
        else:
            x, a = _decoder_layer(cfg, x, layer, positions, mesh)
        aux = aux + a
    return x, aux


def check_mesh(cfg: LlamaConfig, mesh) -> None:
    """Raise ``NotImplementedError`` for what the port does not shard yet:
    the ``seq``, ``pipe`` and ``expert`` axes, and MoE models."""
    for axis, what in (('seq', 'sequence parallelism (ring attention)'),
                       ('pipe', 'pipeline stages'),
                       ('expert', 'expert parallelism')):
        if mesh.shape[axis] > 1:
            raise NotImplementedError(
                f'{axis}={mesh.shape[axis]}: {what} is not ported yet '
                '(ROADMAP section 1, item 1)')
    if cfg.num_experts > 0:
        raise NotImplementedError(
            'an MoE model on a mesh is not ported yet (ROADMAP section 1, '
            'item 1)')


def _block_of(mesh, axis: str, size: int) -> Tuple[int, int]:
    """(start, length) of this rank's block of ``size`` over ``axis``."""
    n = mesh.shape[axis]
    return mesh.axis_index(axis) * (size // n), size // n


def _embed_sharded(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
                   mesh, rules) -> torch.Tensor:
    """The vocab-split embedding: the table gathered over ``fsdp``, a
    lookup masked to this rank's vocab block, then a ``psum`` over
    ``tensor``."""
    from skypilot_tpu_torch.parallel import collectives
    spec = rules.mesh_axes(('vocab', 'embed'))
    emb = params['embed'].to(cfg.dtype)
    if spec[1] is not None:
        emb = collectives.gather_fsdp(emb, mesh, 1)
    if spec[0] is None:
        return F.embedding(tokens.long(), emb)
    start, size = _block_of(mesh, spec[0], cfg.vocab_size)
    ids = tokens.long() - start
    inside = (ids >= 0) & (ids < size)
    x = F.embedding(ids.clamp(0, size - 1), emb) * inside[..., None].to(
        emb.dtype)
    return collectives.reduce_from(x, mesh, spec[0])


def forward_with_aux(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
                     remat: bool = False, remat_policy: str = 'full',
                     mesh=None, rules=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, vocab] fp32, aux loss).

    The unembedding multiplies float32 copies of x and ``lm_head``: exact
    for bf16 operands, as JAX's ``preferred_element_type=float32`` is.
    On a mesh (``rules`` default to JAX's) ``tokens`` are this rank's
    rows and the logits this rank's vocab block."""
    if cfg.pipeline_stages > 1:
        raise NotImplementedError('pipeline stages are not ported yet '
                                  '(ROADMAP section 1, item 1)')
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    if mesh is None:
        x = F.embedding(tokens.long(), params['embed'].to(cfg.dtype))
    else:
        from skypilot_tpu_torch.parallel import collectives
        from skypilot_tpu_torch.parallel import sharding as sharding_lib
        check_mesh(cfg, mesh)
        rules = rules or sharding_lib.ShardingRules()
        x = _embed_sharded(params, tokens, cfg, mesh, rules)
    x, aux = _layer_stack(cfg, x, params['layers'], positions, remat,
                          remat_policy, mesh, rules)
    x = rms_norm(x, params['final_norm'], cfg.norm_eps)
    lm_head = params['lm_head']
    if mesh is not None:
        x = _column(x, mesh)
        if rules.mesh_axes(('embed', 'vocab'))[0] is not None:
            lm_head = collectives.gather_fsdp(lm_head, mesh, 0)
    return x.float() @ lm_head.float(), aux


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            remat: bool = False) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, vocab] (fp32)."""
    return forward_with_aux(params, tokens, cfg, remat=remat)[0]


MOE_AUX_WEIGHT = 0.01


def _nll_sum_sharded(logits: torch.Tensor, targets: torch.Tensor,
                     cfg: LlamaConfig, mesh, rules) -> torch.Tensor:
    """The summed next-token loss of this rank's rows over vocab-split
    logits: a global log-sum-exp (``pmax`` of the rows' maxima, then a
    ``psum`` of the exps) and the gold logit as a masked ``psum``."""
    from skypilot_tpu_torch.parallel import collectives
    axis = rules.mesh_axes(('embed', 'vocab'))[1]
    if axis is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None]).squeeze(-1)
        return (logz - gold).sum()
    start, size = _block_of(mesh, axis, cfg.vocab_size)
    m = collectives.pmax(logits.detach().amax(dim=-1), mesh, axis)
    sumexp = collectives.reduce_from(
        torch.exp(logits - m[..., None]).sum(dim=-1), mesh, axis)
    logz = m + torch.log(sumexp)
    ids = targets - start
    inside = (ids >= 0) & (ids < size)
    gold = torch.gather(logits, -1, ids.clamp(0, size - 1)[..., None])
    gold = collectives.reduce_from(
        gold.squeeze(-1) * inside.to(logits.dtype), mesh, axis)
    return (logz - gold).sum()


def loss_fn(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            remat: bool = True, remat_policy: str = 'full', mesh=None,
            rules=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy over tokens[:, 1:] (``llama.py:398``):
    the forward runs on the full sequence and logits[:, :-1] predict
    tokens[:, 1:]. Returns (total, {'loss', 'perplexity'}); an MoE model
    adds ``MOE_AUX_WEIGHT`` times the per-layer mean balance loss to the
    total and reports that mean as ``moe_aux``.

    On a mesh ``tokens`` are this rank's rows of the global batch and
    ``total`` is this rank's share of the global mean (its rows' summed
    loss over the global token count): summed over the batch axes, its
    gradients are the global mean's. The metrics are the global mean's,
    equal on every rank."""
    logits, aux = forward_with_aux(params, tokens, cfg, remat=remat,
                                   remat_policy=remat_policy, mesh=mesh,
                                   rules=rules)
    logits = logits[:, :-1]
    targets = tokens[:, 1:].long()
    if mesh is not None:
        from skypilot_tpu_torch.parallel import collectives
        from skypilot_tpu_torch.parallel import sharding as sharding_lib
        rules = rules or sharding_lib.ShardingRules()
        batch = sharding_lib.spec_axes(rules.mesh_axes(('batch',)))
        count = targets.numel() * math.prod(mesh.shape[a] for a in batch)
        total = _nll_sum_sharded(logits, targets, cfg, mesh, rules) / count
        nll = collectives.psum_scalars([total.detach()], [batch], mesh)[0]
        return total, {'loss': nll, 'perplexity': torch.exp(nll)}
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
