"""Snapshot stage: device -> host copy of the train state.

Port of ``skypilot_tpu/ckpt/snapshot.py``. The only part of a save the
step loop waits for, and it waits for less than JAX's ``device_get``:
``take`` issues the copies into pinned host buffers on the current
(compute) stream and records a CUDA event, so the step after it runs
behind the copy on the device while the host goes on. Copies on the
compute stream are ordered before the next step's in-place weight
update (``train/optim.py`` ``apply_updates``) for free; the reader of the
bytes (the commit worker, ``emergency_persist``) calls
:meth:`Snapshot.wait` first.

Names are JAX's ``jax.tree_util.keystr`` paths in JAX's flatten order
(dict keys sorted), so a step written here is a step of the JAX
package's format and back. Under a key ``'opt_state'`` the value is a
``train/optim.py`` state, named as optax lays its state out: the
factored second moments as ``.count``, ``.v_row[...]``, ``.v_col[...]``
and ``.v[...]`` over every param, with optax's ``(1,)`` zero placeholders
where a leaf is factored (``v``) or not (``v_row``, ``v_col``); Adam as
``.count``, ``.mu[...]``, ``.nu[...]``; a schedule as ``.count``; the
empty states hold no leaves. Python ints (the counts and ``step``) are
saved as int32 0-d arrays and restored as ints.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.ckpt import manifest as manifest_lib
from skypilot_tpu_torch.ckpt.manifest import CheckpointError

_ALIGN = 64  # byte alignment of each array in the host buffer


@dataclasses.dataclass
class Leaf:
    """One named array of a state: ``value`` is a tensor, a numpy array,
    a Python int, or None for an optax placeholder (``(1,)`` zeros)."""
    name: str
    value: Any
    shape: Tuple[int, ...]
    dtype: str  # the saved dtype name, as JAX writes it

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * \
            _itemsize(self.dtype)


def _itemsize(dtype: str) -> int:
    return manifest_lib.resolve_dtype(dtype).itemsize


def _dtype_name(dtype: Any) -> str:
    """'bfloat16', 'float32', ... for a torch or numpy dtype."""
    return str(dtype).replace('torch.', '')


def _key(k: Any) -> str:
    return f'[{k!r}]'


def _int_leaf(name: str, value: int) -> Leaf:
    return Leaf(name, int(value), (), 'int32')


def _flatten(node: Any, path: str, out: List[Leaf]) -> Callable:
    """Append ``node``'s leaves to ``out``; return the function that
    rebuilds ``node`` from {name: restored value}."""
    if isinstance(node, dict):
        builds = {}
        for k in sorted(node):
            sub = path + _key(k)
            builds[k] = (_flatten_opt(node[k], sub, out)
                         if k == 'opt_state' else
                         _flatten(node[k], sub, out))
        # The rebuilt dict keeps the state's key order: the port's tree
        # functions walk it in that order (global_norm's sum, say).
        return lambda vals: {k: builds[k](vals) for k in node}
    if isinstance(node, (list, tuple)):
        kind = type(node)
        builds = [_flatten(v, path + f'[{i}]', out)
                  for i, v in enumerate(node)]
        return lambda vals: kind(b(vals) for b in builds)
    if node is None:
        return lambda vals: None
    if isinstance(node, torch.Tensor):
        out.append(Leaf(path, node, tuple(node.shape),
                        _dtype_name(node.dtype)))
    elif isinstance(node, (np.ndarray, np.generic)):
        out.append(Leaf(path, node, tuple(np.shape(node)),
                        _dtype_name(np.asarray(node).dtype)))
    elif isinstance(node, int) and not isinstance(node, bool):
        out.append(_int_leaf(path, node))
    else:
        raise CheckpointError(f'cannot snapshot {path!r}: leaf of type '
                              f'{type(node).__name__}')
    return lambda vals: vals[path]


def _is_stats(node: Any) -> bool:
    """The dict ``ScaleByFactoredRms`` keeps for one param."""
    return isinstance(node, dict) and \
        set(node) in ({'v'}, {'v_row', 'v_col'})


def _param_paths(tree: Any, path: str = '') -> List[Tuple[str, Any]]:
    """(keystr suffix, stats) for every param of a stats tree, sorted."""
    if _is_stats(tree):
        return [(path, tree)]
    return [x for k in sorted(tree)
            for x in _param_paths(tree[k], path + _key(k))]


def _flatten_opt(node: Any, path: str, out: List[Leaf]) -> Callable:
    """Flatten a ``train/optim.py`` state under optax's names."""
    if isinstance(node, (list, tuple)):
        kind = type(node)
        builds = [_flatten_opt(v, path + f'[{i}]', out)
                  for i, v in enumerate(node)]
        return lambda vals: kind(b(vals) for b in builds)
    keys = set(node) if isinstance(node, dict) else None
    if keys is None or 'count' not in keys or \
            keys - {'count'} not in (set(), {'stats'}, {'mu', 'nu'}):
        raise CheckpointError(f'cannot snapshot {path!r}: not an optimizer '
                              'state of train/optim.py')
    count = path + '.count'
    out.append(_int_leaf(count, node['count']))
    if keys == {'count'}:  # ScaleBySchedule
        return lambda vals: {'count': vals[count]}
    if keys == {'count', 'mu', 'nu'}:  # ScaleByAdam
        mu = _flatten(node['mu'], path + '.mu', out)
        nu = _flatten(node['nu'], path + '.nu', out)
        return lambda vals: {'count': vals[count], 'mu': mu(vals),
                             'nu': nu(vals)}
    # ScaleByFactoredRms: optax's FactoredState(count, v_row, v_col, v).
    stats = _param_paths(node['stats'])
    for field in ('v_row', 'v_col', 'v'):
        for sub, leaf in stats:
            name = f'{path}.{field}{sub}'
            if field in leaf:
                t = leaf[field]
                out.append(Leaf(name, t, tuple(t.shape),
                                _dtype_name(t.dtype)))
            else:
                dtype = next(iter(leaf.values())).dtype
                out.append(Leaf(name, None, (1,), _dtype_name(dtype)))

    def build(vals, tree=node['stats'], sub=''):
        if _is_stats(tree):
            return {f: vals[f'{path}.{f}{sub}'] for f in tree}
        return {k: build(vals, v, sub + _key(k)) for k, v in tree.items()}
    return lambda vals: {'count': vals[count], 'stats': build(vals)}


def flatten_named(tree: Any) -> Tuple[List[Leaf], Callable]:
    """The leaves of ``tree`` under their JAX names, in JAX's order, and
    the function that rebuilds the tree from {name: value}."""
    leaves: List[Leaf] = []
    build = _flatten(tree, '', leaves)
    return leaves, build


# -- host buffers ---------------------------------------------------------


class HostBuffers:
    """One flat host buffer per state layout, pinned when the state lives
    on the card, reused across saves (a llama3-1b state is 3.3 GB: it is
    not allocated per save). A ``take`` into it overwrites the snapshot
    taken before; the manager takes one only once the one before is
    committed."""

    def __init__(self):
        self._layout: Optional[Tuple] = None
        self._views: List[torch.Tensor] = []

    def views(self, leaves: List[Leaf], pin: bool) -> List[torch.Tensor]:
        layout = (pin,) + tuple((lf.shape, lf.dtype) for lf in leaves)
        if layout != self._layout:
            self._views = []  # drop the old buffer before the new one
            offsets, total = [], 0
            for leaf in leaves:
                offsets.append(total)
                total += -(-leaf.nbytes // _ALIGN) * _ALIGN
            flat = torch.empty(max(total, 1), dtype=torch.uint8,
                               pin_memory=pin)
            self._views = [
                flat[o:o + lf.nbytes].view(_torch_dtype(lf.dtype)).view(
                    lf.shape) for o, lf in zip(offsets, leaves)]
            self._layout = layout
        return self._views


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise CheckpointError(f'no torch dtype {name!r}')
    return dtype


def host_array(t: torch.Tensor) -> manifest_lib.HostArray:
    """A host tensor's bytes as the manifest writes them (shared memory,
    no copy): numpy, or a RawArray of storage words for bfloat16."""
    name = _dtype_name(t.dtype)
    if name in manifest_lib.WORD_DTYPES:
        words = t.view(torch.int16).numpy().view(
            manifest_lib.WORD_DTYPES[name])
        return manifest_lib.RawArray(words, name)
    return t.numpy()


def from_host(arr: manifest_lib.HostArray) -> torch.Tensor:
    """The inverse of :func:`host_array`: a CPU tensor over the same
    bytes (the range reads hand out read-only buffers; the caller copies
    out of it at once)."""
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', UserWarning)  # read-only buffer
        if isinstance(arr, manifest_lib.RawArray):
            return torch.from_numpy(arr.words.view(np.int16)).view(
                _torch_dtype(arr.dtype))
        return torch.from_numpy(arr)


# -- snapshot -------------------------------------------------------------


@dataclasses.dataclass
class Snapshot:
    step: int
    arrays: List[Tuple[str, manifest_lib.HostArray]]
    nbytes: int
    # Step-loop stall the save cost on the host (back-pressure wait +
    # issuing the copies); the manager adds ``copy_s`` and reports it.
    stall_s: float = 0.0
    # Device time of the copies, known once they are done (``wait``).
    copy_s: float = 0.0
    events: Optional[Tuple[Any, Any]] = None  # (start, end) CUDA events

    def wait(self) -> None:
        """Block until every byte is on the host. Launches nothing."""
        events, self.events = self.events, None
        if events is not None:
            events[1].synchronize()
            self.copy_s = events[0].elapsed_time(events[1]) / 1e3


def take(step: int, state: Any,
         buffers: Optional[HostBuffers] = None) -> Snapshot:
    """Copy ``state`` to the host under its JAX names. Tensors go into
    ``buffers`` (fresh ones when None) without waiting for the device;
    numpy leaves are copied, ints become int32 0-d arrays, placeholders
    zeros. Call ``wait()`` before reading the arrays."""
    leaves, _ = flatten_named(state)
    tensors = [lf for lf in leaves if isinstance(lf.value, torch.Tensor)]
    on_card = any(lf.value.is_cuda for lf in tensors)
    buffers = buffers or HostBuffers()
    dst = dict(zip((lf.name for lf in tensors),
                   buffers.views(tensors, pin=on_card)))
    events = None
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    for leaf in tensors:
        dst[leaf.name].copy_(leaf.value.detach(), non_blocking=on_card)
    if on_card:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        events = (start, end)
    arrays = []
    for leaf in leaves:
        if leaf.name in dst:
            arr = host_array(dst[leaf.name])
        elif leaf.value is None:
            arr = host_array(torch.zeros(leaf.shape,
                                         dtype=_torch_dtype(leaf.dtype)))
        elif isinstance(leaf.value, int):
            arr = np.asarray(leaf.value, dtype=np.int32)
        else:
            arr = np.array(leaf.value)  # a copy: the caller may mutate it
        arrays.append((leaf.name, arr))
    return Snapshot(step=int(step), arrays=arrays,
                    nbytes=sum(a.nbytes for _, a in arrays), events=events)


def restore_leaf(leaf: Leaf, arr: manifest_lib.HostArray) -> Any:
    """Put one array read from disk where ``leaf`` was: tensors are
    written in place (``copy_`` under ``no_grad``, so params stay leaf
    tensors with ``requires_grad``), ints come back as ints, numpy
    leaves as fresh arrays; placeholders carry nothing."""
    if isinstance(leaf.value, torch.Tensor):
        with torch.no_grad():
            leaf.value.copy_(from_host(arr))
        return leaf.value
    if leaf.value is None:
        return None
    if isinstance(leaf.value, int):
        return int(np.asarray(arr))
    return np.array(arr)
