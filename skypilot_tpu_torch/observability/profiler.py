"""Program ledger and device-memory accounting (the engine's subset).

Port of the part of ``skypilot_tpu/observability/profiler.py`` that the
continuous engine calls:

* ``profiled(name, fn)`` is the counterpart of ``profiled_jit``. PyTorch
  compiles nothing, so where the JAX ledger records compiles this one
  counts calls per program name, and with ``SKYTPU_PROFILE`` on it records
  the host ms of the first call of each shape signature (the call that
  builds a kernel library, where one is built, or warms the allocator).
* ``tree_nbytes``, ``register_logical`` and ``logical_bytes`` name the
  device memory a component holds (the engine registers its KV cache).
* ``sample_device_memory`` reads the CUDA caching allocator
  (``memory_allocated``, ``max_memory_allocated``, ``mem_get_info``) and
  reconciles it against the logical registrations.
* ``snapshot`` and ``reset`` read and clear the state.

The JAX module's compile listener, cold-start ledger and ``debug_payload``
are not ported yet.

State lives in one ``Ledger`` object; the module-level functions use the
process-wide instance ``LEDGER``, as the JAX module keeps one registry
per process.
"""
from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Callable, Dict, Optional

import torch

_SHAPES_KEPT = 8  # shape signatures remembered per program


def enabled() -> bool:
    """Master switch, read live; off by default, as in the JAX package."""
    return os.environ.get('SKYTPU_PROFILE', '0') not in ('0', '', 'off')


def _shape_sig(args: tuple) -> str:
    """Bounded signature of a call's tensor arguments (one level deep:
    tensors, and the tensor fields of a dataclass such as ``KVCache``)."""
    parts = []
    for a in args:
        fields = getattr(a, '__dataclass_fields__', None)
        items = ([getattr(a, f) for f in fields] if fields else [a])
        for t in items:
            if isinstance(t, torch.Tensor):
                parts.append(f'{str(t.dtype).split(".")[-1]}'
                             f'{list(t.shape)}')
            elif isinstance(t, (int, float, bool, str)) or t is None:
                parts.append(repr(t))
            else:
                parts.append(type(t).__name__)
    return ','.join(parts)[:240]


class Ledger:
    """Calls per program, first-call ms per shape, logical memory."""

    def __init__(self):
        self._lock = threading.Lock()
        self._programs: Dict[str, Dict[str, Any]] = {}
        self._logical: Dict[str, int] = {}
        self._last_mem: Optional[Dict[str, Any]] = None

    def _entry(self, name: str) -> Dict[str, Any]:
        st = self._programs.get(name)
        if st is None:
            st = {'calls': 0, 'first_call_ms': 0.0,
                  'shapes': collections.OrderedDict()}
            self._programs[name] = st
        return st

    def note_call(self, name: str) -> None:
        with self._lock:
            self._entry(name)['calls'] += 1

    def shape_seen(self, name: str, sig: str) -> bool:
        with self._lock:
            return sig in self._entry(name)['shapes']

    def note_first_call(self, name: str, sig: str, ms: float) -> None:
        with self._lock:
            st = self._entry(name)
            shapes: 'collections.OrderedDict[str, float]' = st['shapes']
            if sig in shapes:
                return
            shapes[sig] = round(ms, 3)
            st['first_call_ms'] += ms
            while len(shapes) > _SHAPES_KEPT:
                shapes.popitem(last=False)

    def register_logical(self, kind: str, nbytes: int) -> None:
        with self._lock:
            self._logical[str(kind)] = int(nbytes)

    def logical_bytes(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._logical)

    def sample_device_memory(self, device=None) -> Optional[Dict[str, Any]]:
        """One snapshot of the CUDA allocator of ``device`` (a CUDA device)
        against the logical registrations; None while profiling is off.
        For a CPU device it reports the logical bytes only."""
        if not enabled():
            return None
        logical = self.logical_bytes()
        total = sum(logical.values())
        out: Dict[str, Any] = {'ts': round(time.time(), 3),
                               'logical': logical, 'logical_bytes': total}
        dev = torch.device('cuda' if device is None else device)
        if dev.type == 'cuda':
            in_use = torch.cuda.memory_allocated(dev)
            free, limit = torch.cuda.mem_get_info(dev)
            out.update({
                'bytes_in_use': in_use,
                'peak_bytes': torch.cuda.max_memory_allocated(dev),
                'bytes_limit': limit,
                'headroom_bytes': free,
                'headroom_frac': round(free / limit, 4) if limit else None,
                'unattributed_bytes': max(in_use - total, 0),
                'unattributed_frac': (round(max(in_use - total, 0)
                                            / in_use, 4) if in_use else 0.0),
            })
        with self._lock:
            self._last_mem = out
        return out

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {'enabled': enabled()}
        if not out['enabled']:
            return out
        with self._lock:
            programs = {
                name: {'calls': st['calls'],
                       'first_call_ms': round(st['first_call_ms'], 3),
                       'shapes': dict(st['shapes'])}
                for name, st in sorted(self._programs.items())}
            mem = self._last_mem
        out.update({
            'programs': programs,
            'calls_total': sum(p['calls'] for p in programs.values()),
            'first_call_ms_total': round(
                sum(p['first_call_ms'] for p in programs.values()), 3),
            'device_memory': mem})
        return out

    def reset(self) -> None:
        with self._lock:
            for st in self._programs.values():
                st['calls'] = 0
                st['first_call_ms'] = 0.0
                st['shapes'].clear()
            self._logical.clear()
            self._last_mem = None


LEDGER = Ledger()


def profiled(name: str, fn: Callable, ledger: Ledger = LEDGER) -> Callable:
    """``fn`` with a call ledger under ``name``. Profiling off: one
    counter bump per call. On: the first call of each shape signature is
    timed on the host clock (for a CUDA call that is the time to issue
    it, plus whatever build or allocation it waits for)."""

    def wrapper(*args, **kwargs):
        ledger.note_call(name)
        if not enabled():
            return fn(*args, **kwargs)
        sig = _shape_sig(args)
        if ledger.shape_seen(name, sig):
            return fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        ledger.note_first_call(name, sig, (time.perf_counter() - t0) * 1e3)
        return out

    wrapper.program_name = name
    wrapper.__wrapped__ = fn
    return wrapper


def tree_nbytes(tree) -> int:
    """Bytes of the tensors in a nested dict / list / dataclass."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    fields = getattr(tree, '__dataclass_fields__', None)
    if fields:
        return sum(tree_nbytes(getattr(tree, f)) for f in fields)
    return 0


def register_logical(kind: str, nbytes: int) -> None:
    LEDGER.register_logical(kind, nbytes)


def logical_bytes() -> Dict[str, int]:
    return LEDGER.logical_bytes()


def sample_device_memory(device=None) -> Optional[Dict[str, Any]]:
    return LEDGER.sample_device_memory(device)


def snapshot() -> Dict[str, Any]:
    return LEDGER.snapshot()


def reset() -> None:
    LEDGER.reset()

