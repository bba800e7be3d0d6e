"""Black-box flight recorder: the last events of a process, dumped as an
incident bundle at the moment things go wrong.

Copy of ``skypilot_tpu/observability/blackbox.py``, which uses no
framework, held to it by ``tests/test_torch_blackbox.py``: the same 24
:data:`EVENTS`, the same :data:`TRIGGERS`, the ring (``record`` is one
deque append: no I/O, no device read, legal on the engine thread),
``dump`` / ``build_bundle`` and the bundle's keys, rotation
(``SKYTPU_BLACKBOX_KEEP``), ``list_bundles`` / ``read_bundle`` /
``debug_payload`` (``/debug/blackbox``), ``install_sigquit`` and its
``sigquit-<pid>-<proc>.txt`` stack files, and secret redaction: a bundle
records that a token is set, never its value.

Where the copy differs, it reads the port: the bundle's ``env_flags`` list
the :data:`ENV_FLAGS` that the port reads (its own copy, not JAX's
``env_flags`` registry), the trace and profiler snapshots are the port's,
the only process known to register the SIGQUIT handler is the port's
replica (``skypilot_tpu_torch.serve.llm_server``), and the fan-out reads
the process table of the port's doctor (``utils/cuda_doctor.py``).

Triggers: an engine failure (``models/engine.py`` ``_fail_everything``),
SIGTERM (the trainer's emergency persist, the replica's drain), a probe's
phase deadline (``utils/cuda_doctor.py``), and on demand
(``/debug/blackbox?dump=1``, ``kill -QUIT``). ``SKYTPU_BLACKBOX=0`` turns
recording and dumping off. Bundles carry shapes and counts, never token ids
or prompt text.

CLI: ``python -m skypilot_tpu_torch.observability.blackbox --list``
prints the spool as JSON; ``--dump`` first SIGQUITs every port replica on
the host so their stacks land in the spool.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from skypilot_tpu_torch.utils import atomic_io


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    doc: str


#: Every black-box event name recorded anywhere in the tree, declared
#: once (the metric-registry convention): skylint's ``event-name`` rule
#: fails on any ``blackbox.record('...')`` of an undeclared name AND on
#: any declared name no code records (dead-event detection).
EVENTS: Tuple[Event, ...] = (
    # -- serving engine (models/engine.py) ----------------------------
    Event('engine.admit',
          'A prefill admission group (or one block-share hit) entered '
          'decode slots.'),
    Event('engine.retire',
          'A request retired (EOS or max_new); counts only, never '
          'token ids.'),
    Event('engine.dispatch',
          'A decode chunk was dispatched over the active slots.'),
    Event('engine.bubble',
          'The device provably sat idle waiting on host work (ms).'),
    Event('engine.fail',
          '_fail_everything: the cause and blast radius of an engine '
          'loop failure.'),
    # -- serving front door / LB --------------------------------------
    Event('server.drain',
          'A replica received SIGTERM and began its graceful drain.'),
    Event('lb.handoff',
          'A disaggregated KV handoff completed end to end.'),
    Event('lb.fallback',
          'The LB abandoned a handoff (or lost a replica mid-stream) '
          'and re-served colocated.'),
    Event('lb.replica_set',
          'The ready-replica set changed (health flip, scale event).'),
    # -- serve control plane -------------------------------------------
    Event('serve.scale',
          'The autoscaler changed a replica target (pool-aware).'),
    Event('serve.replica_launch',
          'A replica launch was issued (role/pool tagged).'),
    Event('serve.replica_dark',
          'A previously READY replica stopped answering probes '
          '(preemption-shaped).'),
    Event('serve.replica_terminate',
          'A replica was torn down (scale-down, failure, rollout).'),
    Event('serve.remediation',
          'The remediation engine decided an action (executed, '
          'observed, or suppressed by budget/hysteresis).'),
    # -- checkpoint pipeline (skypilot_tpu/ckpt/) ----------------------
    Event('ckpt.snapshot',
          'Device->host snapshot taken on the step-loop thread.'),
    Event('ckpt.commit',
          'A step directory committed durably (marker renamed).'),
    Event('ckpt.mirror',
          'A committed step replicated into the mirror bucket.'),
    Event('ckpt.emergency',
          'Preemption-path emergency persist entered.'),
    Event('ckpt.restore',
          'A checkpoint restored (source: local | mirror | orbax).'),
    # -- agent / jobs --------------------------------------------------
    Event('agent.heartbeat',
          'The cluster daemon shipped a heartbeat tick.'),
    Event('agent.autostop',
          'The autostop policy acted (stop | down).'),
    Event('sched.watchdog',
          'A watchdog sweep acted: requeued / reaped / gave up ids.'),
    # -- probes --------------------------------------------------------
    Event('probe.phase',
          'The phased TPU init probe crossed (or aborted in) a phase.'),
    # -- runtime profiler (observability/profiler.py) ------------------
    Event('profiler.storm',
          'A profiled jit program compiled past its declared shape '
          'budget (recompile storm): program, count, budget.'),
)

EVENT_NAMES = frozenset(e.name for e in EVENTS)
assert len(EVENT_NAMES) == len(EVENTS), 'duplicate event declaration'

#: Bounded trigger vocabulary — the ``skytpu_incident_bundles_total``
#: label set, and what ``?dump=1&trigger=`` is clamped to.
#: ``slo_breach`` is the SLO engine's degradation capture
#: (observability/slo.py): a page-severity alert transitioning to
#: firing dumps the implicated processes, so gradual saturation — not
#: just crashes — arrives with a frozen timeline attached.
TRIGGERS = ('engine_failure', 'sigterm', 'watchdog', 'probe_deadline',
            'slo_breach', 'manual')

#: Env flags whose values are secrets: bundles record presence, never
#: the value.
_SECRET_FLAGS = frozenset({
    'SKYTPU_API_TOKEN', 'SKYTPU_METRICS_TOKEN',
    'SKYTPU_OAUTH_CLIENT_SECRET', 'SKYTPU_OAUTH_CLIENT_ID',
})

BUNDLE_PREFIX = 'incident-'

#: The SKYTPU_* flags the port reads (a bundle's ``env_flags`` keys): the
#: port's own list, every name also declared in JAX's registry
#: (``tests/test_torch_blackbox.py`` holds both to the sources).
ENV_FLAGS = (
    'SKYTPU_API_TOKEN', 'SKYTPU_BLACKBOX', 'SKYTPU_BLACKBOX_DIR',
    'SKYTPU_BLACKBOX_KEEP', 'SKYTPU_BLACKBOX_RING',
    'SKYTPU_CKPT_HOLD_FILE', 'SKYTPU_CKPT_HOLD_STEP',
    'SKYTPU_CKPT_READERS', 'SKYTPU_COMPILE_CACHE', 'SKYTPU_DECODE_KERNEL',
    'SKYTPU_DISAGG_STAGING', 'SKYTPU_DISAGG_TTL_S',
    'SKYTPU_GUARD_SPARE_MAX_S', 'SKYTPU_KV_FETCH_MAX',
    'SKYTPU_KV_HOST_BYTES', 'SKYTPU_KV_SPILL_DIR', 'SKYTPU_KV_TIERS',
    'SKYTPU_LLM_BATCH_WINDOW_MS', 'SKYTPU_LLM_CHUNK_STEPS',
    'SKYTPU_LLM_DRAFT', 'SKYTPU_LLM_DRAIN_S', 'SKYTPU_LLM_ENGINE',
    'SKYTPU_LLM_KV_BLOCK', 'SKYTPU_LLM_KV_BLOCKS',
    'SKYTPU_LLM_KV_CACHE', 'SKYTPU_LLM_KV_LAYOUT',
    'SKYTPU_LLM_MAX_BATCH', 'SKYTPU_LLM_PIPELINE',
    'SKYTPU_LLM_PREFILL_BATCH', 'SKYTPU_LLM_PREFILL_CHUNK',
    'SKYTPU_LLM_PREFIX_CACHE', 'SKYTPU_LLM_PREFIX_SHARE',
    'SKYTPU_LLM_QUANTIZE', 'SKYTPU_LLM_ROLE', 'SKYTPU_LLM_SLOTS',
    'SKYTPU_LLM_SPEC_K', 'SKYTPU_LLM_TP', 'SKYTPU_METRICS_TOKEN',
    'SKYTPU_OAUTH_CLIENT_ID', 'SKYTPU_OAUTH_CLIENT_SECRET',
    'SKYTPU_PEAK_FLOPS', 'SKYTPU_PKG_ROOT', 'SKYTPU_PREFIX_SUMMARY_MAX',
    'SKYTPU_PROBE_HARD_DEADLINE_S', 'SKYTPU_PROBE_HOLD_FILE',
    'SKYTPU_PROBE_HOLD_MAX_S', 'SKYTPU_PROBE_PHASE_DEADLINE_S',
    'SKYTPU_PROFILE', 'SKYTPU_PROFILE_BUDGETS', 'SKYTPU_PROFILE_MEM_S',
    'SKYTPU_QOS', 'SKYTPU_QOS_FALLBACK_TOK_S',
    'SKYTPU_QOS_MAX_INFLIGHT', 'SKYTPU_QOS_MAX_QUEUE',
    'SKYTPU_QOS_SWEEP_S', 'SKYTPU_QOS_TENANT_LIMITS',
    'SKYTPU_QOS_TENANT_RPS', 'SKYTPU_QOS_TENANT_TPS',
    'SKYTPU_QOS_TTL_S', 'SKYTPU_QOS_WEIGHTS', 'SKYTPU_REPLICA_PORT',
    'SKYTPU_SESSION_FINGERPRINT', 'SKYTPU_SLO', 'SKYTPU_STATE_DIR',
    'SKYTPU_TRACE', 'SKYTPU_TRACE_EXPORT', 'SKYTPU_TRACE_EXPORT_DIR',
    'SKYTPU_TRACE_EXPORT_KEEP', 'SKYTPU_TRACE_RING',
    'SKYTPU_TRACE_SAMPLE', 'SKYTPU_TRACE_TAIL',
    'SKYTPU_TRACE_TAIL_BASELINE_PER_MIN', 'SKYTPU_TRACE_TAIL_KEEP',
    'SKYTPU_TRACE_TAIL_LATENCY_MS', 'SKYTPU_TRACE_TAIL_PENDING',
    'SKYTPU_TRACE_TAIL_PENDING_S', 'SKYTPU_TRACE_TAIL_RING',
    'SKYTPU_TRACE_TAIL_TTFT_MS', 'SKYTPU_TRAIN_TELEMETRY_DIR',
    'SKYTPU_TRAIN_TELEMETRY_MAX_KB', 'SKYTPU_WARMUP',
    'SKYTPU_WARMUP_BUCKETS', 'SKYTPU_WARMUP_ROUNDS',
)


def enabled() -> bool:
    """Master switch, read live (the byte-parity probe and tests flip
    it mid-process): unset/empty/'0'/'off' with SKYTPU_BLACKBOX unset
    means ON — the recorder is default-on like tracing."""
    return os.environ.get('SKYTPU_BLACKBOX', '1') not in ('0', '', 'off')


# (raw env string, parsed value): record() runs per decode chunk on the
# engine thread, so the ring-size check must not re-parse an int per
# event — the cache keys on the RAW string, keeping the tests' live
# mid-process reconfiguration working at the cost of one dict lookup
# and a string compare.
_RING_SIZE_CACHE: Tuple[str, int] = ('512', 512)


def _ring_size() -> int:
    global _RING_SIZE_CACHE
    raw = os.environ.get('SKYTPU_BLACKBOX_RING', '512')
    if raw != _RING_SIZE_CACHE[0]:
        try:
            val = max(int(raw), 16)
        except ValueError:
            val = 512
        _RING_SIZE_CACHE = (raw, val)
    return _RING_SIZE_CACHE[1]


def _keep() -> int:
    try:
        return max(int(os.environ.get('SKYTPU_BLACKBOX_KEEP', '32')), 1)
    except ValueError:
        return 32


def spool_dir() -> str:
    d = os.environ.get('SKYTPU_BLACKBOX_DIR')
    if d:
        return os.path.expanduser(d)
    state = os.path.expanduser(
        os.environ.get('SKYTPU_STATE_DIR', '~/.skypilot_tpu'))
    return os.path.join(state, 'blackbox')


class _Ring:
    """The per-process event ring. The append fast path is ONE
    ``deque.append`` — GIL-atomic AND signal-safe: record() runs inside
    SIGTERM handlers (trainer preemption), which interrupt an arbitrary
    thread between bytecodes, so a blocking lock here could deadlock
    against the very frame it interrupted. The lock exists only for the
    rare maxlen swap (env changed mid-process — tests) and is taken
    NON-blocking: a contended swap just retries on the next append."""

    def __init__(self):
        # The rebind in append() is serialized by a non-blocking _lock
        # try; every other access is deliberately lock-free GIL-atomic
        # deque work (see class docstring) — NOT declared guarded-by.
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(
            maxlen=_ring_size())

    def append(self, slot: tuple) -> None:
        ring = self._events
        if ring.maxlen != _ring_size():  # env changed (tests)
            if self._lock.acquire(blocking=False):
                try:
                    self._events = collections.deque(
                        self._events, maxlen=_ring_size())
                    ring = self._events
                finally:
                    self._lock.release()
            # else: a concurrent swap (or an interrupted holder) owns
            # it — append to the old deque; nothing may block here.
        ring.append(slot)

    def snapshot(self) -> List[tuple]:
        # list(deque) is GIL-atomic against concurrent appends.
        return list(self._events)

    def reset(self) -> None:
        self._events.clear()


_RING = _Ring()
# Cumulative dumps by trigger (feeds skytpu_incident_bundles_total at
# scrape time). int value stores under the ring lock via _note_dump.
_DUMP_COUNTS: Dict[str, int] = {}
_DUMP_LOCK = threading.Lock()
# Optional /health provider: the serving replica (and the API server)
# register a zero-argument callable returning their current health body
# so bundles carry the same snapshot operators already read.
_HEALTH_PROVIDER: Optional[Callable[[], Dict[str, Any]]] = None
# Process label stamped into bundles ('llm_server', 'agent_daemon', ...).
_PROC = 'python'
# Kept open for the process lifetime: faulthandler writes to the fd on
# SIGQUIT even while the GIL is wedged.
_SIGQUIT_FILE = None


def record(name: str, **attrs: Any) -> None:
    """Append one event to the ring: (wall ts, monotonic ts, name,
    attrs). No I/O, no host sync, nothing allocated beyond the slot —
    safe on the engine thread. Attrs must be small scalars/strings;
    NEVER token ids or prompt text (the redaction contract)."""
    if not enabled():
        return
    _RING.append((time.time(), time.monotonic(), name, attrs or None))


def events() -> List[Dict[str, Any]]:
    """The ring as JSON-able dicts, oldest first."""
    return [{'ts': round(e[0], 6), 'mono': round(e[1], 6),
             'name': e[2], **({'attrs': e[3]} if e[3] else {})}
            for e in _RING.snapshot()]


def reset() -> None:
    """Drop recorder state (tests / probes)."""
    _RING.reset()
    _SUMMARY_CACHE.clear()
    with _DUMP_LOCK:
        _DUMP_COUNTS.clear()


def set_process_label(label: str) -> None:
    global _PROC
    _PROC = str(label)


def register_health_provider(
        fn: Optional[Callable[[], Dict[str, Any]]]) -> None:
    global _HEALTH_PROVIDER
    _HEALTH_PROVIDER = fn


def dump_counts() -> Dict[str, int]:
    with _DUMP_LOCK:
        return dict(_DUMP_COUNTS)


def _note_dump(trigger: str) -> None:
    # Non-blocking: dump() runs inside signal handlers, which can
    # interrupt a thread mid-_note_dump — a blocking acquire would
    # self-deadlock. Losing one metric increment beats hanging the
    # preemption path.
    if _DUMP_LOCK.acquire(timeout=0.2):
        try:
            _DUMP_COUNTS[trigger] = _DUMP_COUNTS.get(trigger, 0) + 1
        finally:
            _DUMP_LOCK.release()


def _env_flag_values() -> Dict[str, str]:
    """Values of every flag of :data:`ENV_FLAGS` present in this
    process's environment; secrets are masked to presence."""
    out: Dict[str, str] = {}
    for name in ENV_FLAGS:
        val = os.environ.get(name)
        if val is None:
            continue
        out[name] = '<redacted>' if name in _SECRET_FLAGS else val
    return out


def _thread_stacks() -> str:
    """All-thread stacks via faulthandler. It only writes to real file
    descriptors, so dump into a scratch file in the spool and read it
    back."""
    import faulthandler
    import tempfile
    try:
        d = spool_dir()
        os.makedirs(d, exist_ok=True)
        with tempfile.TemporaryFile(mode='w+', dir=d,
                                    encoding='utf-8') as f:
            faulthandler.dump_traceback(file=f, all_threads=True)
            f.seek(0)
            return f.read()
    except Exception:  # noqa: BLE001 — stacks are best-effort
        return ''


def _trace_snapshot() -> Dict[str, Any]:
    """Open + recent trace spans from the trace ring — the bridge from
    an incident bundle to the dashboard waterfall."""
    try:
        from skypilot_tpu_torch.observability import trace as trace_lib
        return {
            'open': trace_lib.open_spans(limit=32),
            'recent': trace_lib.collect(limit=8, include_exported=False),
            # Tail-retention keeps: the journeys this process had just
            # decided were interesting — a post-mortem fetches them by
            # id (/debug/traces?trace_id=, LB ?stitch=1) even after the
            # recency ring churned past them.
            'retained': trace_lib.retained_ids(limit=16),
        }
    except Exception:  # noqa: BLE001 — tracing off/broken: still dump
        return {'open': [], 'recent': [], 'retained': []}


def _profiler_snapshot() -> Optional[Dict[str, Any]]:
    """Latest runtime-profiler state (observability/profiler.py) for
    the bundle: compile ledger, device-memory accounting, cold-start
    phases. None while SKYTPU_PROFILE is off — a disabled profiler
    must not bloat bundles — and best-effort like every dump leg."""
    try:
        from skypilot_tpu_torch.observability import profiler
        return profiler.try_snapshot()
    except Exception:  # noqa: BLE001 — a broken profiler must not
        return None    # block the dump


def build_bundle(trigger: str, reason: Optional[str] = None,
                 extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The bundle dict (separated from the write path so the probe
    child and tests can inspect without touching the spool)."""
    health = None
    if _HEALTH_PROVIDER is not None:
        try:
            health = _HEALTH_PROVIDER()
        except Exception:  # noqa: BLE001 — a wedged engine must not
            health = None  # block the dump that documents the wedge
    bundle: Dict[str, Any] = {
        'version': 1,
        'ts': round(time.time(), 6),
        'pid': os.getpid(),
        'proc': _PROC,
        'trigger': trigger if trigger in TRIGGERS else 'manual',
        'reason': reason,
        'events': events(),
        'traces': _trace_snapshot(),
        'health': health,
        'env_flags': _env_flag_values(),
        'profile': _profiler_snapshot(),
        'stacks': _thread_stacks(),
    }
    if extra:
        bundle['extra'] = extra
    return bundle


def dump(trigger: str, reason: Optional[str] = None,
         extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Freeze the ring into an incident bundle file. Returns the bundle
    path, or None when disabled or on any failure — dumping is
    best-effort by contract (it runs from failure paths and signal
    handlers; it must never make a bad situation worse)."""
    if not enabled():
        return None
    try:
        bundle = build_bundle(trigger, reason=reason, extra=extra)
        d = spool_dir()
        os.makedirs(d, exist_ok=True)
        fname = (f'{BUNDLE_PREFIX}{int(bundle["ts"] * 1000):013d}-'
                 f'{os.getpid()}-{bundle["trigger"]}.json')
        # Atomic publish: a crash mid-write leaves only the dot-tmp,
        # which list_bundles() never surfaces (torn-tail discipline);
        # a FAILED write unlinks it — bundle names are unique per
        # dump, so orphans would accumulate forever (resource-pair).
        atomic_io.atomic_write(
            os.path.join(d, fname), lambda f: json.dump(bundle, f),
            fsync=True, tmp=os.path.join(d, f'.{fname}.tmp'))
        _rotate(d)
        _note_dump(bundle['trigger'])
        return os.path.join(d, fname)
    except Exception:  # noqa: BLE001 — see docstring
        return None


def _rotate(d: str) -> None:
    try:
        names = sorted(n for n in os.listdir(d)
                       if n.startswith(BUNDLE_PREFIX)
                       and n.endswith('.json'))
        for stale in names[:-_keep()]:
            try:
                os.remove(os.path.join(d, stale))
            except OSError:
                pass
    except OSError:
        pass


# Summary cache: committed bundles are IMMUTABLE (atomic tmp-write +
# rename, never rewritten), so a summary keyed by (name, size) never
# goes stale — the dashboard's 2 s incidents poll must not re-parse
# megabytes of stacks/events per refresh. Evicted when the file leaves
# the listing (rotation). Guarded by _CACHE_LOCK: the listing runs on
# both servers' executor pools concurrently.
_SUMMARY_CACHE: Dict[str, Tuple[int, Dict[str, Any]]] = {}
_CACHE_LOCK = threading.Lock()


def list_bundles(limit: int = 50) -> List[Dict[str, Any]]:
    """Newest committed bundles, summarized (full bundles can be large;
    the list is what dashboards/CLI render). Unparsable files — torn
    writes that somehow acquired the .json suffix, partial copies — are
    invisible, matching the spool's atomic-publish contract."""
    d = spool_dir()
    try:
        names = sorted((n for n in os.listdir(d)
                        if n.startswith(BUNDLE_PREFIX)
                        and n.endswith('.json')), reverse=True)
    except OSError:
        return []
    with _CACHE_LOCK:
        for stale in set(_SUMMARY_CACHE) - set(names):
            _SUMMARY_CACHE.pop(stale, None)
    out = []
    for name in names[:max(limit, 0)]:
        path = os.path.join(d, name)
        try:
            size = os.path.getsize(path)
        except OSError:
            continue
        with _CACHE_LOCK:
            cached = _SUMMARY_CACHE.get(name)
        if cached is not None and cached[0] == size:
            out.append(dict(cached[1], path=path))
            continue
        try:
            with open(path, encoding='utf-8') as f:
                b = json.load(f)
            if not isinstance(b, dict) or 'trigger' not in b:
                continue
        except (OSError, ValueError):
            continue
        summary = {
            'file': name,
            'ts': b.get('ts'),
            'pid': b.get('pid'),
            'proc': b.get('proc'),
            'trigger': b.get('trigger'),
            'reason': b.get('reason'),
            'events': len(b.get('events') or ()),
            'trace_ids': sorted({t.get('trace_id')
                                 for t in (b.get('traces') or {}).get(
                                     'recent') or []
                                 if t.get('trace_id')})[:4],
        }
        with _CACHE_LOCK:
            _SUMMARY_CACHE[name] = (size, summary)
        out.append(dict(summary, path=path))
    return out


def listing(limit: int = 50,
            include_sigquit: bool = True) -> Dict[str, Any]:
    """The spool-listing payload shared by the module CLI,
    core.debug_bundles, and the backend's local branch — ONE function so
    the CLI/API/dashboard views cannot drift field-wise."""
    out: Dict[str, Any] = {'dir': spool_dir(), 'enabled': enabled(),
                           'bundles': list_bundles(limit=limit)}
    if include_sigquit:
        out['sigquit_dumps'] = sigquit_files()
    return out


def read_bundle(name: str) -> Optional[Dict[str, Any]]:
    """One full bundle by spool file name (path components rejected —
    this backs an HTTP parameter)."""
    if os.sep in name or name != os.path.basename(name) \
            or not name.startswith(BUNDLE_PREFIX) \
            or not name.endswith('.json'):
        return None
    try:
        with open(os.path.join(spool_dir(), name), encoding='utf-8') as f:
            b = json.load(f)
        return b if isinstance(b, dict) else None
    except (OSError, ValueError):
        return None


def debug_payload(query: Any) -> Dict[str, Any]:
    """The ``/debug/blackbox`` response body, shared by the API server
    and the serving replica. ``?dump=1`` dumps NOW (trigger clamped to
    the registry; default 'manual') and inlines the fresh bundle;
    ``?file=<name>`` fetches one bundle; otherwise lists the spool."""
    out: Dict[str, Any] = {'enabled': enabled(), 'dir': spool_dir()}
    if str(query.get('dump', '')) in ('1', 'true'):
        trigger = str(query.get('trigger') or 'manual')
        path = dump(trigger, reason=str(query.get('reason') or '') or None)
        out['dumped'] = path
        if path is not None:
            out['bundle'] = read_bundle(os.path.basename(path))
    elif query.get('file'):
        out['bundle'] = read_bundle(str(query.get('file')))
    try:
        limit = min(max(int(query.get('limit', 50)), 1), 200)
    except (TypeError, ValueError):
        limit = 50
    out['bundles'] = list_bundles(limit=limit)
    return out


# -- signal hooks ------------------------------------------------------------


def install_sigquit() -> bool:
    """``faulthandler.register(SIGQUIT)`` with the dump going to a spool
    file, not stderr: ``kill -QUIT <pid>`` interrogates a hung process
    (stacks dump even while the GIL is wedged — faulthandler's handler
    is C-level) without killing it, and the evidence lands where
    ``stpu debug bundles`` already looks. Idempotent; returns False on
    platforms/threads where registration is impossible."""
    global _SIGQUIT_FILE
    if _SIGQUIT_FILE is not None:
        return True
    # Deliberately NOT gated on enabled(): SIGQUIT's DEFAULT
    # disposition is terminate-with-core, and `stpu debug dump`
    # signals every _SIGQUIT_SAFE_CMDS process on the host — a
    # SKYTPU_BLACKBOX=0 replica that skipped registration would be
    # KILLED by the interrogation. The handler only acts on an
    # operator-sent signal, so registering costs nothing in the
    # disabled steady state.
    try:
        import faulthandler
        import signal
        d = spool_dir()
        os.makedirs(d, exist_ok=True)
        _prune_dead_sigquit_files(d)
        path = os.path.join(d, f'sigquit-{os.getpid()}-{_PROC}.txt')
        _SIGQUIT_FILE = open(path, 'a', encoding='utf-8')
        faulthandler.register(signal.SIGQUIT, file=_SIGQUIT_FILE,
                              all_threads=True)
        return True
    except (AttributeError, ValueError, OSError):
        # No SIGQUIT (non-POSIX) / not the main thread / unwritable
        # spool: the recorder still works, only the kill -QUIT path is
        # unavailable.
        _SIGQUIT_FILE = None
        return False


def _prune_dead_sigquit_files(d: str) -> None:
    """faulthandler needs its target file OPEN at registration, so
    sigquit files are created eagerly — each process start would leak
    one forever under replica churn. Every installer therefore sweeps
    files whose embedded pid is no longer alive (the bounded-spool
    design constraint; live processes' files are untouched)."""
    try:
        names = os.listdir(d)
    except OSError:
        return
    for name in names:
        if not name.startswith('sigquit-') or not name.endswith('.txt'):
            continue
        parts = name[len('sigquit-'):].split('-', 1)
        try:
            pid = int(parts[0])
        except (ValueError, IndexError):
            pid = -1
        alive = False
        if pid > 0:
            try:
                os.kill(pid, 0)
                alive = True
            except ProcessLookupError:
                alive = False
            except PermissionError:
                alive = True  # someone else's live process
            except OSError:
                continue
        if not alive:
            try:
                os.remove(os.path.join(d, name))
            except OSError:
                pass


# -- CLI (relayed by `stpu debug` through the cluster agent) -----------------


#: Entrypoints that call install_sigquit() at startup. ONLY these are
#: safe to interrogate with SIGQUIT: for any other process the signal's
#: DEFAULT disposition is terminate-with-core — "dump stacks" must
#: never read as "kill the fleet".
_SIGQUIT_SAFE_CMDS = (
    'skypilot_tpu_torch.serve.llm_server',
)


def sigquit_framework_procs() -> List[int]:
    """SIGQUIT every framework process on this host that is KNOWN to
    register the faulthandler SIGQUIT handler (the cuda_doctor process
    table — stdlib /proc probing — filtered to _SIGQUIT_SAFE_CMDS), so
    their stacks land in the spool; returns the pids signalled."""
    import signal
    try:
        from skypilot_tpu_torch.utils import cuda_doctor
        procs = cuda_doctor.framework_processes()
    except Exception:  # noqa: BLE001 — /proc probing is best-effort
        return []
    hit = []
    me = os.getpid()
    for p in procs:
        pid = p.get('pid')
        cmd = p.get('cmdline') or ''
        if not pid or pid == me:
            continue
        if not any(c in cmd for c in _SIGQUIT_SAFE_CMDS):
            continue
        try:
            os.kill(pid, signal.SIGQUIT)
            hit.append(pid)
        except (ProcessLookupError, PermissionError):
            continue
    return hit


def sigquit_files(limit: int = 64) -> List[Dict[str, Any]]:
    d = spool_dir()
    try:
        names = sorted((n for n in os.listdir(d)
                        if n.startswith('sigquit-')
                        and n.endswith('.txt')),
                       reverse=True)[:max(limit, 0)]
    except OSError:
        return []
    out = []
    for name in names:
        path = os.path.join(d, name)
        try:
            st = os.stat(path)
            out.append({'file': name, 'path': path,
                        'mtime': round(st.st_mtime, 3),
                        'size': st.st_size})
        except OSError:
            continue
    return out


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        description='black-box incident-bundle spool tool')
    parser.add_argument('--dump', action='store_true',
                        help='SIGQUIT every framework process on this '
                             'host (stacks land in the spool), then '
                             'list the spool')
    parser.add_argument('--list', action='store_true',
                        help='list committed incident bundles as JSON')
    parser.add_argument('--limit', type=int, default=50)
    args = parser.parse_args(argv)
    signalled = None
    if args.dump:
        signalled = sigquit_framework_procs()
        time.sleep(0.5)  # let the C-level handlers finish writing
    out = listing(limit=args.limit)
    if signalled is not None:
        out['signalled'] = signalled
    print(json.dumps(out, sort_keys=True))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
