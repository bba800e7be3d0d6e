"""The serving replica's ``/metrics``: Prometheus text format and the
OpenMetrics exposition, by hand.

Port of the serving half of ``skypilot_tpu/server/metrics.py``
(``SERVING_REGISTRY``, ``render_serving`` and the exemplar store). The
card's machine need not have ``prometheus_client``, so this module writes
both expositions itself: the same families under the same names, types,
help texts and label names, rendered from the stats dicts the replica keeps
for ``/health`` (``tests/test_torch_fleet_contract.py`` parses both
replicas' scrapes and compares them).

* Histograms, observed by the replica per request and labelled by QoS
  class: ``skytpu_serve_ttft_seconds``, ``_queue_wait_seconds``,
  ``_phase_seconds{phase}`` and ``_decode_tok_s``. Each labelled child
  also gets its ``<name>_created`` sample, as ``prometheus_client``
  writes it.
* Exemplars: ``observe_serving(..., trace_id=...)`` records the trace id
  of a traced observation against its bucket, in the histogram (the
  OpenMetrics exposition writes it on the bucket line as
  ``# {trace_id="..."} value ts``) and in a capped in-process store
  (``_EXEMPLAR_CAP`` 512, newest per (family, labels, bucket)) that
  ``/debug/exemplars`` lists (``exemplars_payload``).
* Gauges set at scrape time: ``skytpu_trace_retained_total{verdict}`` and
  ``skytpu_trace_pending`` from ``observability/trace.py``'s tail store,
  ``skytpu_incident_bundles_total{trigger}`` from
  ``observability/blackbox.py``'s dump counts, the ``skytpu_replica_*``
  engine gauges, ``skytpu_replica_kv_blocks{state}``, the KV-tier gauges,
  ``skytpu_replica_qos_queue_depth{qos_class}``, the profiler's compile,
  device-memory and cold-start gauges (series only while
  ``SKYTPU_PROFILE`` is on), and the ``skytpu_disagg_*`` families from
  the replica's handoff counters (``disagg``; without them cleared, the
  fallback 0, as JAX renders them).

``render_serving(..., openmetrics=True)`` writes the OpenMetrics text that
``prometheus_client``'s exposition writes for the same registry (the
``_created`` samples inside their histogram, Go-style floats, ``# EOF``);
the replica serves it to a scraper whose ``Accept`` asks for
``application/openmetrics-text``.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from skypilot_tpu_torch.observability import blackbox
from skypilot_tpu_torch.observability import profiler
from skypilot_tpu_torch.observability import trace as trace_lib

CONTENT_TYPE = 'text/plain; version=0.0.4; charset=utf-8'
OPENMETRICS_CONTENT_TYPE = \
    'application/openmetrics-text; version=1.0.0; charset=utf-8'

LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)
DECODE_RATE_BUCKETS = (1, 5, 10, 25, 50, 100, 250, 500, 1000, 2500,
                       5000, 10000, 25000)


def _num(v: float) -> str:
    """A sample value as ``prometheus_client`` writes it."""
    v = float(v)
    if v == math.inf:
        return '+Inf'
    if v == -math.inf:
        return '-Inf'
    if math.isnan(v):
        return 'NaN'
    return repr(v)


def _go(v: float) -> str:
    """A sample value as ``prometheus_client``'s OpenMetrics exposition
    writes it (``floatToGoString``: Go switches to exponents sooner)."""
    v = float(v)
    s = _num(v)
    dot = s.find('.')
    if v > 0 and dot > 6 and not math.isinf(v):
        mantissa = f'{s[0]}.{s[1:dot]}{s[dot + 1:]}'.rstrip('0.')
        return f'{mantissa}e+0{dot - 1}'
    return s


def _labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ''
    esc = (lambda v: str(v).replace('\\', r'\\').replace('\n', r'\n')
           .replace('"', r'\"'))
    return '{' + ','.join(f'{k}="{esc(v)}"'
                          for k, v in sorted(labels.items())) + '}'


def _head(out: List[str], name: str, doc: str, kind: str,
          openmetrics: bool = False) -> None:
    doc = doc.replace('\\', r'\\').replace('\n', r'\n')
    if openmetrics:
        doc = doc.replace('"', r'\"')
    out.append(f'# HELP {name} {doc}')
    out.append(f'# TYPE {name} {kind}')


class Histogram:
    """A labelled histogram: cumulative bucket counts, sum and count per
    child, each child's creation time, and the newest exemplar of each of
    its buckets."""

    def __init__(self, name: str, doc: str, labelnames: Sequence[str],
                 buckets: Sequence[float]):
        self.name, self.doc = name, doc
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(float(b) for b in buckets) + (math.inf,)
        self._lock = threading.Lock()
        # label values -> [bucket counts..., sum, created]
        self._children: Dict[Tuple[str, ...], List[float]] = {}
        # (label values, bucket index) -> (trace id, value, ts)
        self._exemplars: Dict[Tuple[Tuple[str, ...], int],
                              Tuple[str, float, float]] = {}

    def observe(self, value: float, exemplar: Optional[str] = None,
                **labels: str) -> float:
        """Count one observation; returns its bucket's upper bound."""
        key = tuple(str(labels[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = [0.0] * len(self.buckets) + [0.0, time.time()]
                self._children[key] = child
            for i, b in enumerate(self.buckets):
                if value <= b:
                    child[i] += 1.0
                    if exemplar:
                        self._exemplars[(key, i)] = (
                            exemplar, float(value), time.time())
                    break
            child[-2] += float(value)
        return b

    def render(self, out: List[str], openmetrics: bool = False) -> None:
        with self._lock:
            children = {k: list(v) for k, v in self._children.items()}
            exemplars = dict(self._exemplars)
        fmt = _go if openmetrics else _num
        _head(out, self.name, self.doc, 'histogram', openmetrics)
        for key, child in children.items():
            labels = dict(zip(self.labelnames, key))
            total = 0.0
            for i, (b, n) in enumerate(zip(self.buckets, child)):
                total += n
                line = (f'{self.name}_bucket'
                        f'{_labels(dict(labels, le=fmt(b)))} {fmt(total)}')
                ex = exemplars.get((key, i)) if openmetrics else None
                if ex is not None:
                    line += (f' # {_labels({"trace_id": ex[0]})} '
                             f'{fmt(ex[1])} {ex[2]}')
                out.append(line)
            out.append(f'{self.name}_count{_labels(labels)} {fmt(total)}')
            out.append(f'{self.name}_sum{_labels(labels)} '
                       f'{fmt(child[-2])}')
            if openmetrics:  # inside the family, after the sum
                out.append(f'{self.name}_created{_labels(labels)} '
                           f'{fmt(child[-1])}')
        if children and not openmetrics:
            _head(out, f'{self.name}_created', self.doc, 'gauge')
            for key, child in children.items():
                out.append(f'{self.name}_created'
                           f'{_labels(dict(zip(self.labelnames, key)))} '
                           f'{_num(child[-1])}')

    def reset(self) -> None:
        with self._lock:
            self._children.clear()
            self._exemplars.clear()


# skylint: allow-metric(the port's copy of the JAX registry's series)
SERVE_TTFT = Histogram(
    'skytpu_serve_ttft_seconds',
    'Time to first generated token AFTER admission (engine submit -> '
    'first emission; QoS queue wait is excluded — add '
    'skytpu_serve_queue_wait_seconds for the client-experienced '
    'total), by QoS class.', ['qos_class'], LATENCY_BUCKETS_S)
# skylint: allow-metric(the port's copy of the JAX registry's series)
SERVE_QUEUE_WAIT = Histogram(
    'skytpu_serve_queue_wait_seconds',
    'QoS admission queue wait (submit -> dispatch grant), by QoS class.',
    ['qos_class'], LATENCY_BUCKETS_S)
# skylint: allow-metric(the port's copy of the JAX registry's series)
SERVE_PHASE = Histogram(
    'skytpu_serve_phase_seconds',
    'Per-phase serving durations (phase = prefill | decode | window).',
    ['phase', 'qos_class'], LATENCY_BUCKETS_S)
# skylint: allow-metric(the port's copy of the JAX registry's series)
SERVE_DECODE_RATE = Histogram(
    'skytpu_serve_decode_tok_s',
    'Per-request decode throughput (tokens / decode seconds).',
    ['qos_class'], DECODE_RATE_BUCKETS)
HISTOGRAMS = {h.name: h for h in (SERVE_TTFT, SERVE_QUEUE_WAIT,
                                  SERVE_PHASE, SERVE_DECODE_RATE)}

# Gauges in the JAX registry's order: (name, help, label names).
_GAUGES: Tuple[Tuple[str, str, Tuple[str, ...]], ...] = (
    ('skytpu_trace_retained_total',
     'Traces kept by tail-based retention on this process, by verdict '
     '(the bounded trace.VERDICTS vocabulary: slow | slow_ttft | error '
     '| shed | evicted | resumed | slo_breach | recompile_storm | '
     'baseline | propagated).', ('verdict',)),
    ('skytpu_trace_pending',
     'Tail-pending trace fragments currently parked awaiting a '
     'retention verdict (TTL-bounded).', ()),
    ('skytpu_replica_tokens_emitted',
     'Cumulative tokens emitted by this replica engine.', ()),
    ('skytpu_replica_slots', 'Engine decode slots on this replica.', ()),
    ('skytpu_replica_active_slots', 'Engine slots currently decoding.', ()),
    ('skytpu_replica_qos_queue_depth',
     'QoS admission queue depth on this replica, by class.',
     ('qos_class',)),
    ('skytpu_replica_prefix_hits',
     'Cumulative block-share prefix-cache hits on this replica.', ()),
    ('skytpu_replica_prefix_hit_rate',
     'Block-share hit rate (hits / (hits + misses)) over the replica '
     'lifetime.', ()),
    ('skytpu_replica_prefix_cow_forks',
     'Cumulative copy-on-write forks of partially shared KV blocks.', ()),
    ('skytpu_replica_prefill_tokens',
     'Cumulative prompt tokens the prefill actually computed.', ()),
    ('skytpu_replica_prefill_tokens_saved',
     'Cumulative prompt tokens skipped via shared/cached prefix KV.', ()),
    ('skytpu_replica_prefill_bubble_ms',
     'Cumulative prefill host time decode provably waited on (ms).', ()),
    ('skytpu_replica_kv_blocks',
     'Paged KV pool block accounting by state (free | owned | shared | '
     'cached partition the usable device pool exactly; host and '
     'spilled count hierarchical-tier blocks living OFF-device in the '
     'host-DRAM pool and the spill segment store).', ('state',)),
    ('skytpu_kv_tier_hits',
     'Cumulative admissions served from a KV tier instead of recompute '
     '(host = promoted straight from the host-DRAM pool; spilled = '
     'fetched from a spill segment first).', ('tier',)),
    ('skytpu_kv_tier_bytes',
     'Serialized KV bytes currently resident per tier (host-DRAM pool '
     'vs on-disk spill segments).', ('tier',)),
    ('skytpu_kv_tier_promote_seconds',
     'Cumulative wall-clock spent promoting demoted chains back into '
     'the device pool (validate + jit_import_blocks scatter).', ()),
    ('skytpu_disagg_handoffs',
     'Cumulative KV handoffs on this replica by direction (export = '
     'prefill-role retirements, import = decode-role installs).',
     ('direction',)),
    ('skytpu_disagg_handoff_bytes',
     'Cumulative KV-handoff payload bytes by direction (export planes '
     'serialized / import planes installed; skipped shared-prefix '
     'blocks transfer as references and cost nothing here).',
     ('direction',)),
    ('skytpu_disagg_handoff_seconds',
     'Cumulative wall-clock spent in KV handoffs by direction '
     '(export: prefill + serialize + park; import: parse + validate + '
     'install + decode-admission wait).', ('direction',)),
    ('skytpu_disagg_fallback_total',
     'Requests this replica served whole after the LB abandoned a KV '
     'handoff (export/transfer/import failure or a decode replica '
     'dying mid-stream).', ()),
    ('skytpu_incident_bundles_total',
     'Incident bundles written by this process since start, by trigger '
     '(engine_failure | sigterm | watchdog | probe_deadline | '
     'slo_breach | manual).', ('trigger',)),
    ('skytpu_compile_total',
     'Cumulative XLA compiles per profiled jit program (compile '
     'ledger). Nonzero AFTER warm-up under a fixed-shape mix means the '
     'compile-once-per-shape contract is being violated.', ('program',)),
    ('skytpu_compile_seconds',
     'Cumulative trace+lower+compile wall seconds per profiled jit '
     'program.', ('program',)),
    ('skytpu_recompile_storm_total',
     'Cumulative compiles past a program\'s declared shape budget '
     '(recompile storms), by program; feeds the serve.recompile_storm '
     'SLO rule.', ('program',)),
    ('skytpu_device_mem_bytes',
     'Device-memory accounting by kind: allocator in_use/peak/limit/'
     'headroom plus the engine\'s logical registrations '
     '(logical_weights, logical_kv_cache, ...) and the unattributed '
     'residue (leak/fragmentation signal).', ('kind',)),
    ('skytpu_replica_warmup_seconds',
     'Cold-start phase-ledger durations on this replica by phase '
     '(imports | backend_init.* | weights_load | jit_warmup | ready | '
     'first_token); phases telescope and sum to the observed process '
     'wall-clock.', ('phase',)),
)

#: Every family of the scrape, histograms first, in the JAX order.
FAMILY_NAMES = tuple(HISTOGRAMS) + tuple(g[0] for g in _GAUGES)


_EXEMPLAR_CAP = 512
_EXEMPLARS_LOCK = threading.Lock()
# (metric, sorted-labels-tuple, le) -> {trace_id, value, ts}; dict
# insertion order doubles as recency for the cap eviction.
_EXEMPLARS: Dict[Tuple[str, tuple, float], Dict[str, Any]] = {}


def observe_serving(name: str, value: float,
                    trace_id: Optional[str] = None,
                    **labels: str) -> None:
    """One observation of a serving histogram, by family name. A traced
    observation (``trace_id``: head-sampled or tail-pending) becomes its
    bucket's exemplar, on the OpenMetrics bucket line and in the store
    ``/debug/exemplars`` lists."""
    le = HISTOGRAMS[name].observe(
        value, exemplar=str(trace_id)[:64] if trace_id else None, **labels)
    if not trace_id:
        return
    key = (name, tuple(sorted(labels.items())), float(le))
    entry = {'trace_id': str(trace_id), 'value': round(float(value), 6),
             'ts': round(time.time(), 3)}
    with _EXEMPLARS_LOCK:
        _EXEMPLARS.pop(key, None)  # re-insert at the recency tail
        _EXEMPLARS[key] = entry
        while len(_EXEMPLARS) > _EXEMPLAR_CAP:
            _EXEMPLARS.pop(next(iter(_EXEMPLARS)))


def exemplars_payload(query: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, Any]:
    """The ``/debug/exemplars`` body: the exemplar store, newest first,
    optionally one ``?metric=``. Each entry links a histogram bucket to
    the trace id of its newest traced observation (resolve it through
    ``/debug/traces?trace_id=``)."""
    query = query or {}
    want = str(query.get('metric') or '') or None
    with _EXEMPLARS_LOCK:
        items = list(_EXEMPLARS.items())
    out = []
    for (name, labels, le), entry in reversed(items):
        if want and name != want:
            continue
        out.append({'metric': name, 'labels': dict(labels),
                    'le': (le if le != math.inf else '+Inf'), **entry})
    return {'count': len(out), 'exemplars': out}


def _observability_samples(
) -> Dict[str, List[Tuple[Dict[str, str], float]]]:
    """The retention gauges (``trace.tail_stats()``) and the incident
    bundles this process wrote, by trigger (``blackbox.dump_counts()``)."""
    stats = trace_lib.tail_stats()
    return {
        'skytpu_trace_retained_total': [
            ({'verdict': v}, float(n))
            for v, n in (stats.get('verdicts') or {}).items()],
        'skytpu_trace_pending': [({}, float(stats.get('pending') or 0))],
        'skytpu_incident_bundles_total': [
            ({'trigger': t}, float(n))
            for t, n in blackbox.dump_counts().items()],
    }


def _engine_samples(engine: Optional[Dict[str, Any]]
                    ) -> Dict[str, List[Tuple[Dict[str, str], float]]]:
    """The engine gauges' samples from its stats; zeros (and no labelled
    series) without stats, as the JAX replica renders a stopping
    engine."""
    s: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    eng = engine or {}

    def put(name, value, **labels):
        s.setdefault(name, []).append((labels, float(value or 0)))

    put('skytpu_replica_tokens_emitted', eng.get('tokens_emitted'))
    put('skytpu_replica_slots', eng.get('slots'))
    put('skytpu_replica_active_slots', eng.get('active_slots'))
    share = eng.get('prefix_share') or {}
    put('skytpu_replica_prefix_hits', share.get('hits'))
    put('skytpu_replica_prefix_hit_rate', share.get('hit_rate'))
    put('skytpu_replica_prefix_cow_forks', share.get('cow_forks'))
    put('skytpu_replica_prefill_tokens', eng.get('prefill_tokens'))
    put('skytpu_replica_prefill_tokens_saved',
        eng.get('prefill_tokens_saved'))
    put('skytpu_replica_prefill_bubble_ms', eng.get('prefill_bubble_ms'))
    kb = eng.get('kv_blocks')
    if isinstance(kb, dict):
        for state in ('free', 'owned', 'shared', 'cached', 'host',
                      'spilled'):
            put('skytpu_replica_kv_blocks', kb.get(state), state=state)
    tiers = eng.get('kv_tiers')
    if isinstance(tiers, dict) and tiers.get('enabled'):
        put('skytpu_kv_tier_hits', tiers.get('host_hits'), tier='host')
        put('skytpu_kv_tier_hits', tiers.get('spill_hits'), tier='spilled')
        put('skytpu_kv_tier_bytes', tiers.get('host_bytes'), tier='host')
        put('skytpu_kv_tier_bytes', tiers.get('spilled_bytes'),
            tier='spilled')
        put('skytpu_kv_tier_promote_seconds',
            (tiers.get('promote_ms') or 0) / 1e3)
    else:
        put('skytpu_kv_tier_promote_seconds', 0)
    return s


def _profile_samples() -> Dict[str, List[Tuple[Dict[str, str], float]]]:
    s: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    if not profiler.enabled():
        return s
    snap = profiler.snapshot()

    def put(name, value, **labels):
        s.setdefault(name, []).append((labels, float(value)))

    for name, st in (snap.get('compile') or {}).items():
        put('skytpu_compile_total', st['compiles'], program=name)
        put('skytpu_compile_seconds', st['compile_ms'] / 1000.0,
            program=name)
        put('skytpu_recompile_storm_total', st['storms'], program=name)
    mem = snap.get('device_memory') or {}
    for kind, key in (('in_use', 'bytes_in_use'), ('peak', 'peak_bytes'),
                      ('limit', 'bytes_limit'),
                      ('headroom', 'headroom_bytes'),
                      ('unattributed', 'unattributed_bytes')):
        if isinstance(mem.get(key), (int, float)):
            put('skytpu_device_mem_bytes', mem[key], kind=kind)
    for kind, nbytes in (mem.get('logical') or {}).items():
        put('skytpu_device_mem_bytes', nbytes, kind=f'logical_{kind}')
    for phase, secs in (snap.get('cold_start') or {}).get('phases',
                                                          {}).items():
        put('skytpu_replica_warmup_seconds', secs, phase=phase)
    return s


def _disagg_samples(disagg: Optional[Dict[str, Any]]
                    ) -> Dict[str, List[Tuple[Dict[str, str], float]]]:
    """The skytpu_disagg_* families from the replica's handoff counters
    (``LlmServer.disagg_stats``); without them only the fallback total,
    at 0, as JAX's ``render_serving`` leaves it."""
    s: Dict[str, List[Tuple[Dict[str, str], float]]] = {
        'skytpu_disagg_fallback_total': [
            ({}, float((disagg or {}).get('fallbacks_served') or 0))]}
    if not disagg:
        return s
    for direction in ('export', 'import'):
        for name, key in (('skytpu_disagg_handoffs', f'{direction}s'),
                          ('skytpu_disagg_handoff_bytes',
                           f'{direction}_bytes'),
                          ('skytpu_disagg_handoff_seconds',
                           f'{direction}_seconds')):
            s.setdefault(name, []).append(
                ({'direction': direction}, float(disagg.get(key) or 0)))
    return s


def render_serving(engine: Optional[Dict[str, Any]] = None,
                   qos: Optional[Dict[str, Any]] = None,
                   disagg: Optional[Dict[str, Any]] = None,
                   openmetrics: bool = False) -> bytes:
    """The replica's scrape body: the histograms, then every gauge
    family, from the engine's, the QoS scheduler's and the KV handoff's
    stats (None where the replica has none). ``openmetrics`` writes the
    OpenMetrics exposition, with exemplars on bucket lines and a final
    ``# EOF``."""
    samples = _engine_samples(engine)
    samples.update(_profile_samples())
    samples.update(_observability_samples())
    samples.update(_disagg_samples(disagg))
    for cls, c in ((qos or {}).get('classes') or {}).items():
        if isinstance(c, dict):
            samples.setdefault('skytpu_replica_qos_queue_depth', []).append(
                ({'qos_class': cls}, float(c.get('depth') or 0)))
    fmt = _go if openmetrics else _num
    out: List[str] = []
    for hist in HISTOGRAMS.values():
        hist.render(out, openmetrics)
    for name, doc, _ in _GAUGES:
        _head(out, name, doc, 'gauge', openmetrics)
        for labels, value in samples.get(name, ()):
            out.append(f'{name}{_labels(labels)} {fmt(value)}')
    if openmetrics:
        out.append('# EOF')
    return ('\n'.join(out) + '\n').encode()


def reset() -> None:
    """Drop every histogram's observations and the exemplar store
    (tests)."""
    for hist in HISTOGRAMS.values():
        hist.reset()
    with _EXEMPLARS_LOCK:
        _EXEMPLARS.clear()
