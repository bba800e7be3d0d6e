"""The trainer's optimizer chain, ported by hand from optax.

``make_optimizer`` in ``skypilot_tpu/train/trainer.py:66`` chains
``clip_by_global_norm`` with ``optax.adafactor`` or ``optax.adamw`` under
a ``warmup_cosine_decay_schedule``. ``torch.optim.Adafactor`` follows
another rule, so this module repeats optax's, transform by transform and
in optax's order, on trees (nested dicts) of tensors:

* ``adafactor``: factored second-moment RMS scaling over each leaf's two
  largest dims (``optax/_src/factorized.py``), then ``clip_by_block_rms``,
  the learning rate, ``scale_by_param_block_rms`` and the sign flip
  (``optax/_src/alias.py`` ``adafactor``); optax's defaults throughout;
* ``adamw``: ``scale_by_adam``, ``add_decayed_weights``, then the
  negated learning rate.

A leaf is a whole stacked ``[L, ...]`` tensor, as in the JAX tree, so the
factored dims and the parameter-scale RMS are those of the stack. State
tensors take the dtype of their leaf, as optax's do; the step counts are
Python ints, and the schedule and decay scalars are computed in float32
as JAX computes them, so an fp32 run repeats optax's arithmetic. Where
optax multiplies a leaf by a Python scalar (a weakly typed JAX scalar) or
casts a scalar to the leaf's dtype, the port rounds that scalar to the
leaf's dtype first (``_in``): in bfloat16, ``0.1 * g`` is
``bf16(0.1) * g`` in JAX, not ``float(0.1) * g`` as in PyTorch.

On a mesh (``Chain.shard``) each leaf is one rank's slice, and optax's
reductions over a leaf are GSPMD's over the WHOLE leaf: the factored
dims are chosen from the whole shape, and every sum over a sharded dim
(the factored row and column means, the row means' mean, the block RMS
of updates and of params, the global norm) is taken in float32 on the
rank's slice and ``psum``med over that dim's mesh axes before it is
divided and rounded (``_sum_over``). Local means would train another
model without an error. A replicated leaf is counted once.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

Tree = Any
Schedule = Callable[[int], float]


# -- trees ------------------------------------------------------------------------


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def paired_leaves(tree: Tree, other: Tree) -> List[Tuple[Any, Any]]:
    """(leaf, ``other``'s leaf at the same keys) in ``tree``'s order."""
    out: List[Tuple[Any, Any]] = []
    tree_map(lambda a, b: out.append((a, b)), tree, other)
    return out


def global_norm(tree: Tree, specs: Tree = None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (``optax.global_norm``),
    summed per leaf in the leaf's dtype. With ``specs`` (a tree of
    ``NamedSharding``s over ``mesh``) the leaves are slices: each one's
    float32 sum is ``psum``med over the axes that shard it."""
    leaves = tree_leaves(tree)
    if specs is None:
        return torch.sqrt(sum(torch.sum(g * g) for g in leaves))
    from skypilot_tpu_torch.parallel import collectives
    from skypilot_tpu_torch.parallel import sharding as sharding_lib
    shards = [s for _, s in paired_leaves(tree, specs)]
    sums = collectives.psum_scalars(
        [torch.sum(g.float() * g.float()) for g in leaves],
        [sharding_lib.spec_axes(s.spec) for s in shards], mesh)
    return torch.sqrt(sum(s.to(g.dtype) for s, g in zip(sums, leaves)))


def _block_means(tree: Tree, specs: Tree, mesh) -> List[torch.Tensor]:
    """Each leaf's mean of squares over the WHOLE leaf, in its dtype, from
    its slices (one collective per mesh axis for all of them)."""
    from skypilot_tpu_torch.parallel import collectives
    from skypilot_tpu_torch.parallel import sharding as sharding_lib
    leaves, shards = zip(*paired_leaves(tree, specs))
    sums = collectives.psum_scalars(
        [torch.sum(x.float() * x.float()) for x in leaves],
        [sharding_lib.spec_axes(s.spec) for s in shards], mesh)
    return [(s / float(np.prod(sharding_lib.global_shape(x.shape, sh))))
            .to(x.dtype) for s, x, sh in zip(sums, leaves, shards)]


def _sum_over(x: torch.Tensor, dim: int, entry, mesh) -> torch.Tensor:
    """float32 sum of ``x`` over ``dim`` (kept), ``psum``med over the mesh
    axes ``entry`` shards that dim over."""
    from skypilot_tpu_torch.parallel import collectives
    s = x.float().sum(dim=dim, keepdim=True)
    for axis in ((entry,) if isinstance(entry, str) else entry or ()):
        s = collectives.psum(s, mesh, axis)
    return s


def factored_dims(shape, min_dim_size_to_factor: int = 128) -> Any:
    """The two largest dims (``factorized._factored_dims``), as (d1, d0)
    with d0 the largest, or None when the second largest is below
    ``min_dim_size_to_factor``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


@functools.lru_cache(maxsize=4096)
def _rounded(x: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(x, dtype=dtype))


def _in(x: float, like: torch.Tensor) -> float:
    """``x`` rounded to ``like``'s dtype, as JAX converts a weakly typed
    Python scalar (or ``jnp.array(x, dtype=like.dtype)``) before the op;
    PyTorch then multiplies in float32 and rounds once, as XLA does."""
    return _rounded(float(x), like.dtype)


# -- schedule ---------------------------------------------------------------------


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then cosine to ``end_value``
    at ``decay_steps``; evaluated in float32."""
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps

    def linear(count: int):
        if warmup_steps <= 0:
            return f32(init_value)
        c = min(max(count, 0), warmup_steps)
        frac = f32(1) - f32(c) / f32(warmup_steps)
        return f32(init_value - peak_value) * frac + f32(peak_value)

    def cosine(count: int):
        c = f32(min(count, cos_steps))
        cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(cos_steps),
                                          dtype=f32))
        return f32(peak_value) * (f32(1 - alpha) * cos + f32(alpha))

    def schedule(count: int) -> float:
        return float(linear(count) if count < warmup_steps
                     else cosine(count - warmup_steps))
    return schedule


# -- transforms --------------------------------------------------------------------


class Transform:
    """optax's GradientTransformation: ``init(params) -> state`` and
    ``update(updates, state, params) -> (updates, state)``. After
    ``shard(mesh, specs)`` the leaves are slices placed by ``specs``."""

    mesh = None
    specs: Tree = None

    def shard(self, mesh, specs: Tree) -> None:
        """Update slices of leaves placed by ``specs`` (a tree of
        ``NamedSharding``s like the params') on ``mesh``."""
        self.mesh, self.specs = mesh, specs

    def init(self, params: Tree) -> Any:
        return ()

    def update(self, updates: Tree, state: Any, params: Tree
               ) -> Tuple[Tree, Any]:
        raise NotImplementedError


class Chain(Transform):
    def __init__(self, *transforms: Transform):
        self.transforms = transforms

    def init(self, params):
        return [t.init(params) for t in self.transforms]

    def shard(self, mesh, specs):
        super().shard(mesh, specs)
        for t in self.transforms:
            t.shard(mesh, specs)

    def update(self, updates, state, params):
        new_state = []
        for t, s in zip(self.transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, new_state


class ClipByGlobalNorm(Transform):
    """Scale every update by max_norm / global_norm when the norm is at
    least max_norm (``optax.clip_by_global_norm``), without a host sync."""

    def __init__(self, max_norm: float):
        self.max_norm = max_norm

    def update(self, updates, state, params):
        g_norm = global_norm(updates, self.specs, self.mesh)
        keep = g_norm < self.max_norm
        return tree_map(
            lambda t: torch.where(keep, t,
                                  (t / g_norm.to(t.dtype)) * self.max_norm),
            updates), state


class ScaleByFactoredRms(Transform):
    """``optax.scale_by_factored_rms`` with its defaults."""

    def __init__(self, decay_rate: float = 0.8,
                 min_dim_size_to_factor: int = 128, epsilon: float = 1e-30):
        self.decay_rate = decay_rate
        self.min_dim = min_dim_size_to_factor
        self.epsilon = epsilon

    def factored_dims(self, shape) -> Any:
        return factored_dims(shape, self.min_dim)

    def _whole(self, p: torch.Tensor, sh) -> Tuple[int, ...]:
        if sh is None:
            return tuple(p.shape)
        from skypilot_tpu_torch.parallel import sharding as sharding_lib
        return sharding_lib.global_shape(p.shape, sh)

    def init(self, params):
        def leaf(p, sh=None):
            dims = self.factored_dims(self._whole(p, sh))
            z = lambda shape: torch.zeros(  # noqa: E731
                shape, dtype=p.dtype, device=p.device)
            if dims is None:
                return {'v': z(p.shape)}
            d1, d0 = dims
            return {'v_row': z(np.delete(p.shape, d0).tolist()),
                    'v_col': z(np.delete(p.shape, d1).tolist())}
        stats = (tree_map(leaf, params) if self.specs is None
                 else tree_map(leaf, params, self.specs))
        return {'count': 0, 'stats': stats}

    def update(self, updates, state, params):
        f32 = np.float32
        t = f32(state['count'] + 1)
        decay = f32(1) - t ** f32(-self.decay_rate)
        keep, new = float(decay), float(f32(1) - decay)

        def leaf(g, s, sh=None):
            dtype = g.dtype
            grad_sqr = g * g + self.epsilon
            shape = self._whole(g, sh)
            dims = self.factored_dims(shape)
            if dims is None:
                v = (keep * s['v'].float() + new * grad_sqr.float()).to(dtype)
                return g * v ** -0.5, {'v': v}
            d1, d0 = dims
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            if sh is None:
                row_mean = grad_sqr.mean(dim=d0)
                col_mean = grad_sqr.mean(dim=d1)
            else:
                # Means over the WHOLE leaf's dims: a sharded dim's sum is
                # psummed over its mesh axes before the division.
                row_mean = (_sum_over(grad_sqr, d0, sh.spec[d0], self.mesh)
                            / shape[d0]).to(dtype).squeeze(d0)
                col_mean = (_sum_over(grad_sqr, d1, sh.spec[d1], self.mesh)
                            / shape[d1]).to(dtype).squeeze(d1)
            v_row = (keep * s['v_row'].float()
                     + new * row_mean.float()).to(dtype)
            v_col = (keep * s['v_col'].float()
                     + new * col_mean.float()).to(dtype)
            if sh is None:
                row_col_mean = v_row.mean(dim=reduced_d1, keepdim=True)
            else:
                row_col_mean = (_sum_over(v_row, reduced_d1, sh.spec[d1],
                                          self.mesh)
                                / shape[d1]).to(dtype)
            row_factor = (v_row / row_col_mean) ** -0.5
            col_factor = v_col ** -0.5
            out = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            return out, {'v_row': v_row, 'v_col': v_col}

        pairs = (tree_map(leaf, updates, state['stats'])
                 if self.specs is None else
                 tree_map(leaf, updates, state['stats'], self.specs))
        is_pair = lambda x: isinstance(x, tuple)  # noqa: E731
        out = _unzip(pairs, 0, is_pair)
        stats = _unzip(pairs, 1, is_pair)
        return out, {'count': state['count'] + 1, 'stats': stats}


def _unzip(tree, i, is_pair):
    if is_pair(tree):
        return tree[i]
    return {k: _unzip(v, i, is_pair) for k, v in tree.items()}


class ClipByBlockRms(Transform):
    """u / max(1, rms(u) / threshold) per leaf."""

    def __init__(self, threshold: float):
        self.threshold = threshold

    def update(self, updates, state, params):
        if self.specs is None:
            means = iter([torch.mean(u * u) for u in tree_leaves(updates)])
        else:
            means = iter(_block_means(updates, self.specs, self.mesh))

        def clip(u):
            denom = torch.clamp_min(
                torch.sqrt(next(means)) / self.threshold, 1.0)
            return u / denom
        return tree_map(clip, updates), state


class ScaleBySchedule(Transform):
    """Multiply by ``sign * schedule(count)`` in each update's dtype."""

    def __init__(self, schedule: Schedule, sign: float = 1.0):
        self.schedule = schedule
        self.sign = sign

    def init(self, params):
        return {'count': 0}

    def update(self, updates, state, params):
        step = self.sign * self.schedule(state['count'])
        return (tree_map(lambda u: u * _in(step, u), updates),
                {'count': state['count'] + 1})


class ScaleByParamBlockRms(Transform):
    """u * max(rms(p), min_scale) per leaf (``safe_root_mean_squares``)."""

    def __init__(self, min_scale: float = 1e-3):
        self.min_scale = min_scale

    def update(self, updates, state, params):
        if self.specs is None:
            means = iter([torch.mean(p * p) for p in tree_leaves(params)])
        else:
            means = iter(_block_means(params, self.specs, self.mesh))

        def scale(u, p):
            rms = torch.sqrt(next(means))
            return u * torch.clamp_min(rms, self.min_scale)
        return tree_map(scale, updates, params), state


class ScaleByAdam(Transform):
    """``optax.scale_by_adam`` (eps_root 0, no Nesterov)."""

    def __init__(self, b1: float, b2: float, eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return {'count': 0, 'mu': tree_map(torch.zeros_like, params),
                'nu': tree_map(torch.zeros_like, params)}

    def update(self, updates, state, params):
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda g, m: _in(1 - b1, g) * g + _in(b1, m) * m,
                      updates, state['mu'])
        nu = tree_map(lambda g, n: _in(1 - b2, g) * (g * g) + _in(b2, n) * n,
                      updates, state['nu'])
        count = state['count'] + 1
        f32 = np.float32
        c1 = float(f32(1) - f32(b1) ** f32(count))
        c2 = float(f32(1) - f32(b2) ** f32(count))
        out = tree_map(
            lambda m, n: (m / _in(c1, m)) / (torch.sqrt(n / _in(c2, n))
                                             + _in(self.eps, n)), mu, nu)
        return out, {'count': count, 'mu': mu, 'nu': nu}


class AddDecayedWeights(Transform):
    def __init__(self, weight_decay: float):
        self.weight_decay = weight_decay

    def update(self, updates, state, params):
        return tree_map(lambda u, p: u + _in(self.weight_decay, p) * p,
                        updates, params), state


# -- the chains --------------------------------------------------------------------


def adafactor(learning_rate: Schedule) -> Chain:
    """``optax.adafactor(learning_rate)`` with optax's defaults:
    min_dim_size_to_factor 128, decay_rate 0.8, clipping_threshold 1.0,
    multiply_by_parameter_scale, eps 1e-30, no momentum. optax flips the
    sign last; flipping it with the learning rate gives the same bits."""
    return Chain(ScaleByFactoredRms(), ClipByBlockRms(1.0),
                 ScaleBySchedule(learning_rate, sign=-1.0),
                 ScaleByParamBlockRms())


def adamw(learning_rate: Schedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> Chain:
    """``optax.adamw``: Adam, decoupled weight decay, -learning_rate."""
    return Chain(ScaleByAdam(b1, b2, eps), AddDecayedWeights(weight_decay),
                 ScaleBySchedule(learning_rate, sign=-1.0))


def apply_updates(params: Tree, updates: Tree) -> None:
    """params += updates, in place and in each param's dtype (optax's
    ``apply_updates`` returns ``(p + u).astype(p.dtype)``)."""
    with torch.no_grad():
        for p, u in zip(tree_leaves(params), tree_leaves(updates)):
            p.add_(u.to(p.dtype))
