"""The serving replica's ``/metrics``: Prometheus text format, by hand.

Port of the serving half of ``skypilot_tpu/server/metrics.py``
(``SERVING_REGISTRY`` and ``render_serving``). The card's machine need not
have ``prometheus_client``, so this module writes the exposition itself:
the same families under the same names, types, help texts and label
names, rendered from the stats dicts the replica keeps for ``/health``
(``tests/test_torch_fleet_contract.py`` parses both replicas' scrapes and
compares them).

* Histograms, observed by the replica per request and labelled by QoS
  class: ``skytpu_serve_ttft_seconds``, ``_queue_wait_seconds``,
  ``_phase_seconds{phase}`` and ``_decode_tok_s``. Each labelled child
  also gets its ``<name>_created`` sample, as ``prometheus_client``
  writes it.
* Gauges set at scrape time: the ``skytpu_replica_*`` engine gauges,
  ``skytpu_replica_kv_blocks{state}``, the KV-tier gauges,
  ``skytpu_replica_qos_queue_depth{qos_class}``, the profiler's compile,
  device-memory and cold-start gauges (series only while
  ``SKYTPU_PROFILE`` is on), and the ``skytpu_disagg_*`` families as the
  JAX replica renders them with no handoffs (cleared, the fallback 0).
* ``skytpu_trace_retained_total{verdict}``, ``skytpu_trace_pending`` and
  ``skytpu_incident_bundles_total{trigger}`` render as on a JAX process
  that has retained no trace and written no bundle: the port has no
  tracing or black-box recorder yet.

The OpenMetrics exposition, which carries exemplars (trace ids on bucket
lines), needs tracing and is not ported.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from skypilot_tpu_torch.observability import profiler

CONTENT_TYPE = 'text/plain; version=0.0.4; charset=utf-8'

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


def _labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ''
    esc = (lambda v: str(v).replace('\\', r'\\').replace('\n', r'\n')
           .replace('"', r'\"'))
    return '{' + ','.join(f'{k}="{esc(v)}"'
                          for k, v in sorted(labels.items())) + '}'


def _head(out: List[str], name: str, doc: str, kind: str) -> None:
    doc = doc.replace('\\', r'\\').replace('\n', r'\n')
    out.append(f'# HELP {name} {doc}')
    out.append(f'# TYPE {name} {kind}')


class Histogram:
    """A labelled histogram: cumulative bucket counts, sum and count per
    child, and each child's creation time."""

    def __init__(self, name: str, doc: str, labelnames: Sequence[str],
                 buckets: Sequence[float]):
        self.name, self.doc = name, doc
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(float(b) for b in buckets) + (math.inf,)
        self._lock = threading.Lock()
        # label values -> [bucket counts..., sum, created]
        self._children: Dict[Tuple[str, ...], List[float]] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = tuple(str(labels[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = [0.0] * len(self.buckets) + [0.0, time.time()]
                self._children[key] = child
            for i, b in enumerate(self.buckets):
                if value <= b:
                    child[i] += 1.0
                    break
            child[-2] += float(value)

    def render(self, out: List[str]) -> None:
        with self._lock:
            children = {k: list(v) for k, v in self._children.items()}
        _head(out, self.name, self.doc, 'histogram')
        for key, child in children.items():
            labels = dict(zip(self.labelnames, key))
            total = 0.0
            for b, n in zip(self.buckets, child):
                total += n
                out.append(f'{self.name}_bucket'
                           f'{_labels(dict(labels, le=_num(b)))} '
                           f'{_num(total)}')
            out.append(f'{self.name}_count{_labels(labels)} {_num(total)}')
            out.append(f'{self.name}_sum{_labels(labels)} '
                       f'{_num(child[-2])}')
        if children:
            _head(out, f'{self.name}_created', self.doc, 'gauge')
            for key, child in children.items():
                out.append(f'{self.name}_created'
                           f'{_labels(dict(zip(self.labelnames, key)))} '
                           f'{_num(child[-1])}')

    def reset(self) -> None:
        with self._lock:
            self._children.clear()


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


def observe_serving(name: str, value: float, **labels: str) -> None:
    """One observation of a serving histogram, by family name."""
    HISTOGRAMS[name].observe(value, **labels)


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


def render_serving(engine: Optional[Dict[str, Any]] = None,
                   qos: Optional[Dict[str, Any]] = None) -> bytes:
    """The replica's scrape body: the histograms, then every gauge
    family, from the engine's and the QoS scheduler's stats (None where
    the replica has none)."""
    samples = _engine_samples(engine)
    samples.update(_profile_samples())
    samples['skytpu_trace_pending'] = [({}, 0.0)]
    samples['skytpu_disagg_fallback_total'] = [({}, 0.0)]
    for cls, c in ((qos or {}).get('classes') or {}).items():
        if isinstance(c, dict):
            samples.setdefault('skytpu_replica_qos_queue_depth', []).append(
                ({'qos_class': cls}, float(c.get('depth') or 0)))
    out: List[str] = []
    for hist in HISTOGRAMS.values():
        hist.render(out)
    for name, doc, _ in _GAUGES:
        _head(out, name, doc, 'gauge')
        for labels, value in samples.get(name, ()):
            out.append(f'{name}{_labels(labels)} {_num(value)}')
    return ('\n'.join(out) + '\n').encode()


def reset() -> None:
    """Drop every histogram's observations (tests)."""
    for hist in HISTOGRAMS.values():
        hist.reset()
