"""Logical-axis sharding rules.

Port of ``skypilot_tpu/parallel/sharding.py``. Params and activations
carry *logical* axis names (``'embed'``, ``'mlp'``, ``'heads'``,
``'vocab'``, ``'batch'``, ...); ``ShardingRules`` maps them to mesh axes
with JAX's rule table and its rule "never two dims on one mesh axis".
``mesh_axes`` returns a plain tuple where JAX returns a ``PartitionSpec``.

JAX places a whole array and lets GSPMD insert collectives. Here each
rank holds its own slice of every leaf: ``shard_pytree`` returns THIS
rank's slice, cut by the same spec JAX's ``NamedSharding`` would give its
device, and the model code issues the collectives itself
(``models/generate.py``, ``models/llama.py``). ``constrain`` is then a
no-op, as JAX's is outside a mesh: a rank's tensor already has the layout
its code made. ``batch_rows`` is a rank's block of a global batch under
``('batch', ...)``: ``data`` major, then ``fsdp``, as ``P(('data',
'fsdp'))`` orders it; ``gather`` is the inverse of ``local_slice``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch

LogicalAxes = Tuple[Optional[str], ...]
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis -> mesh axis (or tuple of mesh axes, or None =
    replicate). The default is JAX's FSDP + TP llama recipe: batch over
    ``(data, fsdp)``; embed over ``fsdp``; heads, kv_heads, mlp and vocab
    over ``tensor``; sequence over ``seq``."""
    rules: Tuple[Tuple[str, Union[None, str, Tuple[str, ...]]], ...] = (
        ('batch', ('data', 'fsdp')),
        ('seqlen', 'seq'),
        ('embed', 'fsdp'),
        ('heads', 'tensor'),
        ('kv_heads', 'tensor'),
        ('mlp', 'tensor'),
        ('vocab', 'tensor'),
        ('head_dim', None),
        ('layers', 'pipe'),
        ('stage', 'pipe'),
        ('expert', 'expert'),
        ('act_embed', 'tensor'),
    )

    def mesh_axes(self, logical: Sequence[Optional[str]]) -> Spec:
        table = dict(self.rules)
        out = []
        used = set()
        for name in logical:
            axis = table.get(name) if name is not None else None
            # Never map two tensor dims onto the same mesh axis.
            if axis is not None:
                flat = (axis,) if isinstance(axis, str) else tuple(axis)
                if any(a in used for a in flat):
                    axis = None
                else:
                    used.update(flat)
            out.append(axis)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: JAX's ``NamedSharding``."""
    mesh: Any
    spec: Spec


def logical_sharding(mesh, rules: ShardingRules,
                     logical: Sequence[Optional[str]]) -> NamedSharding:
    return NamedSharding(mesh, rules.mesh_axes(logical))


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_index(mesh, entry) -> Tuple[int, int]:
    """(this rank's shard index, shard count) along a dim sharded over
    ``entry`` (a mesh axis or a tuple of them, major first)."""
    idx, n = 0, 1
    for axis in _axes_of(entry):
        idx = idx * mesh.shape[axis] + mesh.axis_index(axis)
        n *= mesh.shape[axis]
    return idx, n


def local_shape(shape: Sequence[int], sharding: NamedSharding
                ) -> Tuple[int, ...]:
    """The shape of one rank's slice of an array of ``shape``."""
    out = []
    for size, entry in zip(shape, sharding.spec):
        n = math.prod(sharding.mesh.shape[a] for a in _axes_of(entry))
        if size % n:
            raise ValueError(f'dim of size {size} does not split over '
                             f'{entry} ({n} shards)')
        out.append(size // n)
    return tuple(out) + tuple(shape[len(sharding.spec):])


def local_slice(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's slice of ``x`` under ``sharding``: a copy, so the whole
    array can be freed."""
    local_shape(x.shape, sharding)  # divisibility
    for dim, entry in enumerate(sharding.spec):
        idx, n = shard_index(sharding.mesh, entry)
        if n > 1:
            size = x.shape[dim] // n
            x = x.narrow(dim, idx * size, size)
    return x.clone(memory_format=torch.contiguous_format)


def global_shape(shape: Sequence[int], sharding: NamedSharding
                 ) -> Tuple[int, ...]:
    """The whole array's shape, from one rank's slice of it."""
    return tuple(
        size * math.prod(sharding.mesh.shape[a] for a in _axes_of(entry))
        for size, entry in zip(shape, sharding.spec)) + tuple(
            shape[len(sharding.spec):])


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """The mesh axes a spec shards over, in its dims' order."""
    return tuple(a for entry in spec for a in _axes_of(entry))


def gather(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """The whole array from every rank's slice of it (the inverse of
    ``local_slice``; a collective over each sharded axis, every rank of
    the mesh must call it)."""
    from skypilot_tpu_torch.parallel import collectives
    for dim, entry in enumerate(sharding.spec):
        for axis in reversed(_axes_of(entry)):  # minor axis first
            x = collectives.all_gather(x, sharding.mesh, axis, dim)
    return x


def batch_rows(x: torch.Tensor, mesh, rules: 'ShardingRules'
               ) -> torch.Tensor:
    """This rank's block of rows of a global batch ``x`` (dim 0), as
    ``('batch', ...)`` places it: ``data`` major, then ``fsdp``."""
    spec = rules.mesh_axes(('batch',) + (None,) * (x.dim() - 1))
    idx, n = shard_index(mesh, spec[0])
    if x.shape[0] % n:
        raise ValueError(f'global batch {x.shape[0]} does not split over '
                         f'{spec[0]} ({n} shards)')
    size = x.shape[0] // n
    return x[idx * size:(idx + 1) * size]


def crosses_hosts(mesh, axis: str, local: int) -> bool:
    """True when ``axis``'s groups span more than one host of ``local``
    ranks each (ranks are laid out row-major over the mesh's axes, a
    host's ranks contiguous)."""
    names = list(mesh.axis_names)
    stride = math.prod(mesh.shape[a] for a in names[names.index(axis) + 1:])
    span = stride * mesh.shape[axis]
    if mesh.shape[axis] == 1:
        return False
    # A group is {base + k * stride}; it stays on one host iff each block
    # of ``span`` ranks lies inside one host's ``local`` ranks.
    return span > local or local % span != 0


def _is_axes(x) -> bool:
    return isinstance(x, tuple)


def map_logical(fn: Callable[[Any, Any], Any], logical_tree: Any,
                tree: Any) -> Any:
    """``fn(logical_axes, leaf)`` over a pytree of dicts whose leaves
    line up with ``logical_tree``'s tuples."""
    if _is_axes(logical_tree):
        return fn(logical_tree, tree)
    return {k: map_logical(fn, logical_tree[k], v) for k, v in tree.items()}


def sharding_tree(logical_tree: Any, mesh, rules: ShardingRules) -> Any:
    """Pytree of ``NamedSharding``s matching a pytree of logical-axes
    tuples."""
    if _is_axes(logical_tree):
        return logical_sharding(mesh, rules, logical_tree)
    return {k: sharding_tree(v, mesh, rules)
            for k, v in logical_tree.items()}


def shard_pytree(tree: Any, logical_tree: Any, mesh,
                 rules: ShardingRules) -> Any:
    """This rank's slice of every leaf of ``tree``, each cut by its
    logical axes (JAX's ``device_put`` with the same shardings)."""
    return map_logical(
        lambda la, leaf: local_slice(leaf, logical_sharding(mesh, rules, la)),
        logical_tree, tree)


def constrain(x: torch.Tensor, mesh, rules: ShardingRules,
              logical: Sequence[Optional[str]]) -> torch.Tensor:
    """JAX's ``with_sharding_constraint`` by logical names: a no-op, since
    each rank's tensor already has the layout its code built."""
    del mesh, rules, logical
    return x
