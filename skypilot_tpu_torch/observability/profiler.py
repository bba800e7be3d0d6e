"""Runtime profiler: program ledger, device-memory accounting and the
cold-start phase ledger.

Port of ``skypilot_tpu/observability/profiler.py``:

* ``PROGRAMS`` declares the JAX package's 19 programs under its names,
  with their shape budgets (``budget_for``; ``SKYTPU_PROFILE_BUDGETS``
  overrides them, ``name=n,...``). ``profiled(name, fn)`` is the
  counterpart of ``profiled_jit`` and refuses an undeclared name.
* The ledger. PyTorch compiles nothing, so its "compile" is the first call
  of a program with a new shape signature: that call pays for what a
  steady-state call does not (cuBLAS's choice of algorithm for a new GEMM
  shape, the caching allocator's growth, the build or load of a kernel
  library), timed on the host clock. A program past its budget of
  distinct signatures is a recompile storm. ``compile_totals`` sums the
  ledger; ``jit_cache_sizes`` counts the distinct signatures each program
  was seen with, the counterpart of the jit caches' sizes.
* The steady state stays fixed: with ``SKYTPU_PROFILE`` off a call costs
  one counter bump (``calls`` in the snapshot, the port's own block) and
  no signature. ``tracking()`` makes the ledger look at signatures while
  profiling is off, which the warm-up (``serve/warmup.py``) needs to
  confirm its coverage; it records signatures then, not compiles.
* ``COLD_START_PHASES``, ``mark`` (which refuses an undeclared phase) and
  ``cold_start_ledger``: first crossings from the process's birth (read
  from ``/proc``), durations that telescope to ``total_s``.
* Device memory: ``register_logical``/``logical_bytes`` name what each
  component holds; ``sample_device_memory`` reads the CUDA caching
  allocator against them; ``maybe_sample_device_memory`` does so at most
  every ``SKYTPU_PROFILE_MEM_S`` seconds (the replica's ``/health``).
* ``snapshot`` (the ``/health`` ``profile`` block), ``try_snapshot``,
  ``debug_payload`` (``/debug/profile``) and ``reset``.

State lives in one ``Ledger`` object; the module-level functions use the
process-wide instance ``LEDGER``, as the JAX module keeps one registry per
process.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Program:
    """One declared program: ``budget`` is the number of distinct shape
    signatures it is designed to take over a process's life."""
    name: str
    doc: str
    budget: int


#: The JAX package's programs, names, docs and budgets as declared there.
PROGRAMS: Tuple[Program, ...] = (
    Program('generate.prefill',
            'Prompt prefill (forward_cached over a padded prompt '
            'block): one shape per power-of-two prompt bucket x '
            'admission-group batch x uniform/mixed-length variant.',
            budget=24),
    Program('generate.decode_scan',
            'Window-path decode lax.scan: one shape per (batch, '
            'max_new, filters-on/off) combination.', budget=16),
    Program('engine.insert',
            'Prefilled-rows → slot-cache scatter: one shape per '
            'prompt bucket x admission-group size.', budget=24),
    Program('engine.gather_prefix',
            'Prefix-pool row gather seeding a prefill cache: one '
            'shape per prompt bucket.', budget=12),
    Program('engine.store_prefix',
            'Prefill row → prefix-pool store: one shape per stored '
            'power-of-two prefix length.', budget=12),
    Program('engine.sample',
            'Per-slot first-token sampling over prefill logits: one '
            'shape per admission-group size x filter variant.',
            budget=16),
    Program('engine.chunk',
            'The K-step dense decode chunk — THE steady-state '
            'program: one shape per filters-None/array pytree '
            'variant.', budget=4),
    Program('engine.paged_chunk',
            'The K-step paged decode chunk (block scatter/gather '
            'twin of engine.chunk).', budget=4),
    Program('engine.insert_cache',
            'Draft-cache-only insert (speculative mode).', budget=24),
    Program('engine.rewind',
            'Per-row lengths rollback after a speculative round.',
            budget=4),
    Program('engine.spec_round',
            'One draft-propose / target-verify round over all slots.',
            budget=4),
    Program('paged.insert',
            'Dense prefill rows → pool-block scatter: one shape per '
            'prompt bucket x admission-group size.', budget=24),
    Program('paged.fork_block',
            'Copy-on-write fork of one partially shared block.',
            budget=4),
    Program('paged.gather_blocks',
            'Shared-chain blocks → dense scratch row (chunked long '
            'prefill seed); compiles once (fixed MB*P width).',
            budget=4),
    Program('paged.export_blocks',
            'Pool-layout block gather for a KV-handoff export: one '
            'shape per power-of-two block count.', budget=12),
    Program('paged.import_blocks',
            'Handoff install: block scatter + table/length write in '
            'one dispatch; one shape per power-of-two block count.',
            budget=12),
    Program('paged.prefill_shared',
            'Suffix prefill directly over the pool (the block-share '
            'hit path): one shape per tail bucket.', budget=12),
    Program('spec.propose',
            'k+1 greedy draft proposal steps (solo speculative '
            'path).', budget=4),
    Program('spec.verify',
            'One k+1-token target verify forward (solo speculative '
            'path).', budget=4),
)

PROGRAM_NAMES = frozenset(p.name for p in PROGRAMS)
_BY_NAME: Dict[str, Program] = {p.name: p for p in PROGRAMS}

#: Cold-start phases in their designed order; each ``mark`` records a
#: phase's first crossing.
COLD_START_PHASES: Tuple[str, ...] = (
    'imports',
    'backend_init.plugin_discovery',
    'backend_init.device_enumeration',
    'weights_load',
    'jit_warmup',
    'ready',
    'first_token',
)

_SHAPES_KEPT = 8     # newest signatures listed per program
_SIGS_KEPT = 4096    # distinct signatures remembered per program


def enabled() -> bool:
    """Master switch, read live; off by default, as in the JAX package."""
    return os.environ.get('SKYTPU_PROFILE', '0') not in ('0', '', 'off')


def mem_sample_interval_s() -> float:
    try:
        return max(float(os.environ.get('SKYTPU_PROFILE_MEM_S', '15')),
                   0.25)
    except ValueError:
        return 15.0


def _budget_overrides() -> Dict[str, int]:
    out: Dict[str, int] = {}
    for part in os.environ.get('SKYTPU_PROFILE_BUDGETS', '').split(','):
        name, _, val = part.strip().partition('=')
        if not name or not val:
            continue
        try:
            out[name] = max(int(val), 1)
        except ValueError:
            continue
    return out


def budget_for(name: str) -> int:
    return _budget_overrides().get(name, _BY_NAME[name].budget)


def _process_birth_mono() -> float:
    """This process's birth on the monotonic clock, from its start ticks
    in ``/proc/self/stat``, so the ledger covers the interpreter's start
    and the imports before this module. Import time off Linux."""
    try:
        with open('/proc/self/stat', encoding='utf-8') as f:
            ticks = int(f.read().rsplit(')', 1)[1].split()[19])
        hertz = os.sysconf('SC_CLK_TCK')
        with open('/proc/uptime', encoding='utf-8') as f:
            uptime = float(f.read().split()[0])
        return time.monotonic() - max(uptime - ticks / hertz, 0.0)
    except (OSError, ValueError, IndexError, AttributeError):
        return time.monotonic()


BIRTH_MONO = _process_birth_mono()


def _shape_sig(args: tuple) -> str:
    """Bounded signature of a call's arguments (one level deep: tensors,
    scalars, and the tensor fields of a dataclass such as ``KVCache``)."""
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
    """Calls, first calls per signature and storms per program; logical
    and sampled device memory; cold-start crossings."""

    def __init__(self, birth_mono: float = BIRTH_MONO):
        self._lock = threading.Lock()
        self._programs: Dict[str, Dict[str, Any]] = {}
        self._logical: Dict[str, int] = {}
        self._last_mem: Optional[Dict[str, Any]] = None
        self._last_mem_mono = 0.0
        self._tracking = 0
        self._birth = birth_mono
        self._birth_wall = time.time() - (time.monotonic() - birth_mono)
        self._phase_ts: 'collections.OrderedDict[str, float]' = \
            collections.OrderedDict()

    # -- programs ------------------------------------------------------------

    def _entry(self, name: str) -> Dict[str, Any]:
        st = self._programs.get(name)
        if st is None:
            st = {'calls': 0, 'compiles': 0, 'compile_ms': 0.0,
                  'storms': 0, 'last_compile_ts': None,
                  'shapes': collections.deque(maxlen=_SHAPES_KEPT),
                  'sigs': set()}
            self._programs[name] = st
        return st

    def register(self, name: str) -> None:
        with self._lock:
            self._entry(name)

    def note_call(self, name: str) -> None:
        with self._lock:
            self._entry(name)['calls'] += 1

    @property
    def looking(self) -> bool:
        """Whether calls are signed: profiling on, or a ``tracking()``
        block open."""
        return self._tracking > 0 or enabled()

    @contextlib.contextmanager
    def tracking(self) -> Iterator[None]:
        """Sign every call inside the block, profiling on or off."""
        with self._lock:
            self._tracking += 1
        try:
            yield
        finally:
            with self._lock:
                self._tracking -= 1

    def shape_seen(self, name: str, sig: str) -> bool:
        with self._lock:
            return sig in self._entry(name)['sigs']

    def note_first_call(self, name: str, sig: str, ms: float) -> None:
        """A call with a signature new to ``name``: remembered always, and
        counted as a compile (timed, against the budget) while profiling
        is on."""
        profiling = enabled()
        with self._lock:
            st = self._entry(name)
            if sig in st['sigs']:
                return
            if len(st['sigs']) < _SIGS_KEPT:
                st['sigs'].add(sig)
            if not profiling:
                return
            st['compiles'] += 1
            st['compile_ms'] += ms
            st['last_compile_ts'] = round(time.time(), 3)
            st['shapes'].appendleft(sig)
            if st['compiles'] > budget_for(name):
                st['storms'] += 1

    def compile_totals(self) -> Tuple[int, float, int]:
        """(compiles, compile_ms, storms) over every program."""
        with self._lock:
            sts = list(self._programs.values())
            return (sum(st['compiles'] for st in sts),
                    sum(st['compile_ms'] for st in sts),
                    sum(st['storms'] for st in sts))

    def jit_cache_sizes(self) -> Dict[str, int]:
        """Distinct signatures each wrapped program was called with while
        the ledger looked."""
        with self._lock:
            return {name: len(st['sigs'])
                    for name, st in self._programs.items()}

    # -- cold start ----------------------------------------------------------

    def mark(self, phase: str) -> None:
        """Record ``phase``'s first crossing; later marks are ignored."""
        if phase not in COLD_START_PHASES:
            raise ValueError(f'unknown cold-start phase {phase!r}; '
                             f'declared: {", ".join(COLD_START_PHASES)}')
        with self._lock:
            self._phase_ts.setdefault(phase, time.monotonic())

    def cold_start_ledger(self) -> Dict[str, Any]:
        """Durations in crossing order, each from the previous crossing
        (or the process's birth) to its own: they sum to ``total_s``.
        ``complete`` once 'ready' is crossed."""
        with self._lock:
            items = sorted(self._phase_ts.items(), key=lambda kv: kv[1])
        phases: Dict[str, float] = {}
        prev = self._birth
        for name, ts in items:
            phases[name] = round(max(ts - prev, 0.0), 4)
            prev = max(ts, prev)
        return {'started_at': round(self._birth_wall, 3),
                'phases': phases,
                'total_s': round(prev - self._birth, 4),
                'complete': 'ready' in phases}

    # -- device memory -------------------------------------------------------

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
            self._last_mem_mono = time.monotonic()
        return out

    def maybe_sample_device_memory(self, device=None
                                   ) -> Optional[Dict[str, Any]]:
        """``sample_device_memory`` at most every
        ``SKYTPU_PROFILE_MEM_S`` seconds; the last sample in between."""
        if not enabled():
            return None
        with self._lock:
            last, last_mono = self._last_mem, self._last_mem_mono
        if last is not None and \
                time.monotonic() - last_mono < mem_sample_interval_s():
            return last
        return self.sample_device_memory(device)

    # -- read side -----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The ``/health`` ``profile`` block: JAX's keys (``compile`` per
        program, the totals, ``cold_start``, ``device_memory``) and the
        port's ``calls`` per program."""
        out: Dict[str, Any] = {'enabled': enabled()}
        if not out['enabled']:
            return out
        compiles: Dict[str, Any] = {}
        calls: Dict[str, int] = {}
        with self._lock:
            for name in sorted(self._programs):
                st = self._programs[name]
                compiles[name] = {
                    'compiles': st['compiles'],
                    'compile_ms': round(st['compile_ms'], 3),
                    'budget': budget_for(name),
                    'storms': st['storms'],
                    'last_compile_ts': st['last_compile_ts'],
                    'shapes': list(st['shapes'])}
                calls[name] = st['calls']
            mem = self._last_mem
        n, ms, storms = self.compile_totals()
        out.update({
            'compile': compiles,
            'compiles_total': n,
            'compile_ms_total': round(ms, 3),
            'storms_total': storms,
            'cold_start': self.cold_start_ledger(),
            'device_memory': mem,
            'calls': calls,
        })
        return out

    def reset(self) -> None:
        """Clear counts, signatures, memory and crossings; wrapped
        programs stay listed."""
        with self._lock:
            for st in self._programs.values():
                st.update(calls=0, compiles=0, compile_ms=0.0, storms=0,
                          last_compile_ts=None)
                st['shapes'].clear()
                st['sigs'].clear()
            self._logical.clear()
            self._last_mem = None
            self._last_mem_mono = 0.0
            self._phase_ts.clear()


LEDGER = Ledger()


def profiled(name: str, fn: Callable, ledger: Ledger = LEDGER) -> Callable:
    """``fn`` on the ledger under the declared program ``name``. Profiling
    off and no ``tracking()``: one counter bump per call. Otherwise each
    call is signed, and the first call of a new signature is timed on the
    host clock (for a CUDA call, the time to issue it plus whatever build
    or allocation it waits for)."""
    if name not in PROGRAM_NAMES:
        raise ValueError(f'profiled program {name!r} is not declared in '
                         'observability/profiler.py PROGRAMS')
    ledger.register(name)

    def wrapper(*args, **kwargs):
        ledger.note_call(name)
        if not ledger.looking:
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


def mark(phase: str) -> None:
    LEDGER.mark(phase)


def cold_start_ledger() -> Dict[str, Any]:
    return LEDGER.cold_start_ledger()


def tracking():
    return LEDGER.tracking()


def compile_totals() -> Tuple[int, float, int]:
    return LEDGER.compile_totals()


def jit_cache_sizes() -> Dict[str, int]:
    return LEDGER.jit_cache_sizes()


def register_logical(kind: str, nbytes: int) -> None:
    LEDGER.register_logical(kind, nbytes)


def logical_bytes() -> Dict[str, int]:
    return LEDGER.logical_bytes()


def sample_device_memory(device=None) -> Optional[Dict[str, Any]]:
    return LEDGER.sample_device_memory(device)


def maybe_sample_device_memory(device=None) -> Optional[Dict[str, Any]]:
    return LEDGER.maybe_sample_device_memory(device)


def snapshot() -> Dict[str, Any]:
    return LEDGER.snapshot()


def try_snapshot() -> Optional[Dict[str, Any]]:
    """``snapshot`` that never raises; None while profiling is off."""
    try:
        return snapshot() if enabled() else None
    except Exception:  # noqa: BLE001 -- a dump path must not fail on it
        return None


def debug_payload(query: Any, device=None) -> Dict[str, Any]:
    """The ``/debug/profile`` body: ``?mem=1`` samples device memory now,
    ``?programs=1`` appends the ``PROGRAMS`` catalog."""
    if str(query.get('mem', '')) in ('1', 'true'):
        sample_device_memory(device)
    out = snapshot()
    if str(query.get('programs', '')) in ('1', 'true'):
        out['programs'] = [dataclasses.asdict(p) for p in PROGRAMS]
    return out


def reset() -> None:
    LEDGER.reset()
