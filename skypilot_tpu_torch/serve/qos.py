"""QoS admission control for the serving replica.

Port copy of the framework-free ``skypilot_tpu/serve/qos.py``, held to it
by ``tests/test_torch_qos.py``: the same classes, weighted-fair order,
token buckets, shed-batch-first with ``Retry-After``, queue TTLs and
``stats()``, decision for decision. The JAX replica is asyncio-bound; this
one is a ``ThreadingHTTPServer``. So here a grant is a
``concurrent.futures.Future`` that the handler's thread waits on, the TTL
sweeper is a daemon thread (started by the first submit, gone once the
queue is empty, as the JAX sweeper task is), and one reentrant lock
guards all of the scheduler's state, where the JAX scheduler relies on
its event loop.

* ``classify`` / ``resolve_tenant``: the priority class from the
  ``priority`` field or the ``X-SkyTPU-Priority`` header, and the tenant
  (a bearer token that resolves through ``utils/users.py``, else the
  ``X-SkyTPU-Tenant`` header or ``tenant`` field, else ``anonymous``).
* ``WeightedFairQueue``: start-time fair queuing over the classes.
* ``TokenBucket``: per-tenant requests/s and generated-tokens/s.
* ``QosScheduler``: admission, the dispatch gate at ``max_inflight`` rows,
  TTL eviction, shedding, ``stats()`` for ``/health``.

Off by default: ``SKYTPU_QOS=1`` or ``--qos on`` turns it on.
"""
from __future__ import annotations

import collections
import concurrent.futures
import heapq
import math
import os
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

# Highest -> lowest priority; tuple order defines shed victim search.
CLASSES = ('interactive', 'standard', 'batch')
_DEFAULT_WEIGHTS = {'interactive': 8.0, 'standard': 4.0, 'batch': 1.0}
_DEFAULT_TTL_S = {'interactive': 10.0, 'standard': 30.0, 'batch': 120.0}

PRIORITY_HEADER = 'X-SkyTPU-Priority'
TENANT_HEADER = 'X-SkyTPU-Tenant'


def enabled(flag: Optional[str] = None) -> bool:
    """QoS on/off: an explicit ``--qos on|off`` wins, else SKYTPU_QOS."""
    if flag is not None:
        return flag == 'on'
    return os.environ.get('SKYTPU_QOS', '0') not in ('0', '', 'off')


def parse_class_map(spec: Optional[str],
                    defaults: Dict[str, float]) -> Dict[str, float]:
    """``'interactive:8,batch:2'`` -> per-class float map over defaults."""
    out = dict(defaults)
    for cls in CLASSES:
        out.setdefault(cls, 1.0)
    if not spec:
        return out
    for part in str(spec).split(','):
        part = part.strip()
        if not part:
            continue
        name, _, val = part.partition(':')
        name = name.strip().lower()
        if name not in CLASSES:
            raise ValueError(f'unknown QoS class {name!r}; '
                             f'have {list(CLASSES)}')
        out[name] = float(val)
    return out


def parse_tenant_limits(spec: Optional[str]
                        ) -> Dict[str, Tuple[float, float]]:
    """``'alice=5/1000,bob=1/50'`` -> {tenant: (req/s, gen-tokens/s)};
    0 disables that limit for the tenant."""
    out: Dict[str, Tuple[float, float]] = {}
    if not spec:
        return out
    for part in str(spec).split(','):
        part = part.strip()
        if not part:
            continue
        name, _, lim = part.partition('=')
        rps, _, tps = lim.partition('/')
        out[name.strip()] = (float(rps or 0), float(tps or 0))
    return out


def validate_env() -> None:
    """Parse (and thereby validate) every QoS env knob. The server calls
    this BEFORE weight init — a typo'd SKYTPU_QOS_* var must not cost
    the operator a minutes-long sharded init (the same principle as the
    other cheap serving knobs)."""
    env = os.environ.get
    parse_class_map(env('SKYTPU_QOS_WEIGHTS'), _DEFAULT_WEIGHTS)
    parse_class_map(env('SKYTPU_QOS_TTL_S'), _DEFAULT_TTL_S)
    parse_tenant_limits(env('SKYTPU_QOS_TENANT_LIMITS'))
    for name in ('SKYTPU_QOS_MAX_QUEUE', 'SKYTPU_QOS_MAX_INFLIGHT'):
        int(env(name, '0'))
    # Strict here even though the scheduler's own reads fall back to
    # defaults: a typo'd quota knob falling back to 0 means quotas are
    # SILENTLY unlimited — the failure the operator least wants.
    for name in ('SKYTPU_QOS_TENANT_RPS', 'SKYTPU_QOS_TENANT_TPS',
                 'SKYTPU_QOS_SWEEP_S', 'SKYTPU_QOS_FALLBACK_TOK_S'):
        float(env(name, '0'))


def classify(body: Any, headers: Any = None) -> str:
    """Priority class from the request (``priority`` field beats the
    ``X-SkyTPU-Priority`` header). Unknown values raise ValueError —
    the server surfaces a 400 rather than silently downgrading."""
    raw = body.get('priority') if isinstance(body, dict) else None
    if raw is None and headers is not None:
        raw = headers.get(PRIORITY_HEADER)
    if raw is None:
        return 'standard'
    cls = str(raw).strip().lower()
    if cls not in CLASSES:
        raise ValueError(f'unknown priority {raw!r}; '
                         f'one of {list(CLASSES)}')
    return cls


def resolve_tenant(headers: Any = None, body: Any = None) -> str:
    """Tenant id for quota accounting. The authenticated ``users/``
    identity wins (a bearer token is verifiable); the self-declared
    header/field is honored otherwise (trusted inside single-operator
    deployments); everything else shares one ``anonymous`` bucket."""
    if headers is not None:
        from skypilot_tpu_torch.utils import users as users_lib
        # users.bearer_token also rejects non-UTF-8 (surrogate-escaped)
        # bearers, which would otherwise crash token hashing mid-request.
        token = (users_lib.bearer_token(headers) or '').strip()
        if token:
            name = users_lib.tenant_from_token(token)
            if name:
                return name
    declared = headers.get(TENANT_HEADER) if headers is not None else None
    if not declared and isinstance(body, dict):
        declared = body.get('tenant')
    if declared:
        return str(declared)[:64]
    return 'anonymous'


class ShedError(Exception):
    """Admission refused (quota exhausted or overload): HTTP 429 with a
    Retry-After the client can actually use."""

    def __init__(self, reason: str, retry_after_s: float = 1.0):
        super().__init__(reason)
        self.reason = reason
        if not math.isfinite(retry_after_s):
            retry_after_s = 3600.0
        self.retry_after_s = int(min(max(math.ceil(retry_after_s), 1),
                                     3600))


class QueueTimeout(Exception):
    """Queued past its class TTL: evicted instead of served dead."""


def nearest_rank(sorted_vals: List, q: int):
    """Nearest-rank percentile: the ceil(q*n/100)-1 index of an
    ascending list (int(0.95*n) would report the MAX for every
    n <= 20). None on empty input. Shared with serve/loadgen.py so the
    server's queue-wait percentiles and the load generator's latency
    percentiles can never silently diverge."""
    if not sorted_vals:
        return None
    return sorted_vals[max(-(-len(sorted_vals) * q // 100) - 1, 0)]


class TokenBucket:
    """Standard token bucket: ``rate``/s refill up to ``burst``."""

    def __init__(self, rate: float, burst: Optional[float] = None,
                 time_fn: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else max(rate, 1.0))
        self.level = self.burst
        self._time = time_fn
        self._t = time_fn()

    def _refill(self, now: float) -> None:
        if now > self._t:
            self.level = min(self.burst,
                             self.level + (now - self._t) * self.rate)
        self._t = now

    def try_take(self, n: float = 1.0,
                 now: Optional[float] = None) -> bool:
        now = self._time() if now is None else now
        self._refill(now)
        if self.level >= n:
            self.level -= n
            return True
        return False

    def give(self, n: float) -> None:
        """Refund (e.g. the unused part of a generated-token ask)."""
        self.level = min(self.burst, self.level + n)

    def seconds_until(self, n: float = 1.0,
                      now: Optional[float] = None) -> float:
        now = self._time() if now is None else now
        self._refill(now)
        if self.level >= n:
            return 0.0
        if self.rate <= 0:
            return float('inf')
        return (n - self.level) / self.rate


class _Item:
    __slots__ = ('payload', 'cls', 'cost', 'enqueued_at', 'deadline',
                 'tag', 'seq', 'dead')

    def __lt__(self, other):  # heap tie-break safety
        return self.seq < other.seq


class WeightedFairQueue:
    """Start-time fair queuing over the priority classes.

    Arrivals are tagged ``F = max(V, last_F[class]) + cost / weight``
    (V = virtual time, advanced to each popped tag) and the smallest
    tag pops first: a weight-8 class drains 8x a weight-1 class under
    shared backlog, a lone class drains at full speed, and a class
    that idles cannot bank credit to later lock out the others."""

    def __init__(self, weights: Optional[Dict[str, float]] = None,
                 time_fn: Callable[[], float] = time.monotonic):
        self.weights = dict(_DEFAULT_WEIGHTS)
        self.weights.update(weights or {})
        for cls in CLASSES:
            self.weights.setdefault(cls, 1.0)
        self._heap: List[Tuple[float, int, _Item]] = []
        self._by_class: Dict[str, Deque[_Item]] = {
            cls: collections.deque() for cls in CLASSES}
        self._vtime = 0.0
        self._last_tag = {cls: 0.0 for cls in CLASSES}
        self._seq = 0
        self._dead = 0  # lazily-deleted entries still in the heap
        self._time = time_fn

    def push(self, payload: Any, cls: str, cost: float = 1.0,
             ttl_s: Optional[float] = None) -> _Item:
        now = self._time()
        start = max(self._vtime, self._last_tag[cls])
        tag = start + max(cost, 1e-9) / max(self.weights[cls], 1e-9)
        self._last_tag[cls] = tag
        item = _Item()
        item.payload, item.cls, item.cost = payload, cls, cost
        item.enqueued_at = now
        item.deadline = (now + ttl_s) if ttl_s and ttl_s > 0 else None
        item.tag, item.seq, item.dead = tag, self._seq, False
        self._seq += 1
        heapq.heappush(self._heap, (tag, item.seq, item))
        self._by_class[cls].append(item)
        return item

    def pop(self) -> Optional[_Item]:
        while self._heap:
            tag, _, item = heapq.heappop(self._heap)
            if item.dead:  # lazily-deleted (evicted/shed/removed)
                self._dead -= 1
                continue
            item.dead = True
            self._by_class[item.cls].remove(item)
            self._vtime = max(self._vtime, tag)
            return item
        return None

    def _compact(self) -> None:
        """Purge lazily-deleted heap entries once they outnumber the
        live ones. pop() alone cannot be relied on to drain them: under
        a saturated dispatch gate (stalled engine) nothing pops, while
        shed/evict keep marking entries dead — the heap would otherwise
        grow with every admission for as long as the stall lasts."""
        if self._dead > max(len(self._heap) - self._dead, 16):
            self._heap = [e for e in self._heap if not e[2].dead]
            heapq.heapify(self._heap)
            self._dead = 0

    def remove(self, item: _Item) -> bool:
        if item.dead:
            return False
        item.dead = True
        self._by_class[item.cls].remove(item)
        self._dead += 1
        self._compact()
        return True

    def newest(self, cls: str) -> Optional[_Item]:
        dq = self._by_class[cls]
        return dq[-1] if dq else None

    def expired(self, now: Optional[float] = None) -> List[_Item]:
        """Remove and return every queued item past its deadline."""
        now = self._time() if now is None else now
        out = []
        for dq in self._by_class.values():
            for item in list(dq):
                if item.deadline is not None and now >= item.deadline:
                    item.dead = True
                    dq.remove(item)
                    self._dead += 1
                    out.append(item)
        if out:
            self._compact()
        return out

    def depth(self, cls: str) -> int:
        return len(self._by_class[cls])

    def depths(self) -> Dict[str, int]:
        return {cls: len(dq) for cls, dq in self._by_class.items()}

    @property
    def total(self) -> int:
        return sum(len(dq) for dq in self._by_class.values())


class _Ticket:
    """One admitted request waiting for (or holding) a dispatch grant."""
    __slots__ = ('cls', 'tenant', 'cost', 'est_tokens', 'granted', 'item',
                 'state', 'on_dispatch')

    def __init__(self, cls: str, tenant: str, cost: float,
                 est_tokens: float, on_dispatch: Optional[Callable]):
        self.cls, self.tenant = cls, tenant
        self.cost, self.est_tokens = cost, est_tokens
        self.on_dispatch = on_dispatch
        self.granted: Optional[concurrent.futures.Future] = None
        self.item: Optional[_Item] = None
        self.state = 'queued'  # queued -> inflight -> done


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


class QosScheduler:
    """The admission subsystem: quota -> overload check -> weighted-fair
    queue -> dispatch gate. Handler threads and the sweeper thread call
    it; ``_lock`` (reentrant) guards every piece of its state."""

    def __init__(self, *, max_inflight: int,
                 weights: Optional[Dict[str, float]] = None,
                 max_queue: Optional[int] = None,
                 ttl_s: Optional[Dict[str, float]] = None,
                 tenant_rps: Optional[float] = None,
                 tenant_tps: Optional[float] = None,
                 tenant_limits: Optional[Dict[str, Tuple[float, float]]]
                 = None,
                 sweep_s: Optional[float] = None,
                 fallback_tok_s: Optional[float] = None,
                 time_fn: Callable[[], float] = time.monotonic):
        env = os.environ.get
        self.max_inflight = max(int(max_inflight), 1)
        self.weights = (dict(weights) if weights is not None else
                        parse_class_map(env('SKYTPU_QOS_WEIGHTS'),
                                        _DEFAULT_WEIGHTS))
        self.max_queue = int(max_queue if max_queue is not None
                             else env('SKYTPU_QOS_MAX_QUEUE', '256'))
        ttls = (dict(ttl_s) if ttl_s is not None else
                parse_class_map(env('SKYTPU_QOS_TTL_S'), _DEFAULT_TTL_S))
        self.ttl_s = {cls: float(ttls.get(cls, _DEFAULT_TTL_S[cls]))
                      for cls in CLASSES}
        # Default quotas (0 = unlimited); per-tenant overrides win.
        self.tenant_rps = float(
            tenant_rps if tenant_rps is not None
            else _env_float('SKYTPU_QOS_TENANT_RPS', 0.0))
        self.tenant_tps = float(
            tenant_tps if tenant_tps is not None
            else _env_float('SKYTPU_QOS_TENANT_TPS', 0.0))
        self.tenant_limits = (dict(tenant_limits) if tenant_limits
                              else parse_tenant_limits(
                                  env('SKYTPU_QOS_TENANT_LIMITS')))
        self.sweep_s = float(sweep_s if sweep_s is not None
                             else _env_float('SKYTPU_QOS_SWEEP_S', 0.25))
        # Retry-After denominator before any throughput is observed.
        self.fallback_tok_s = max(float(
            fallback_tok_s if fallback_tok_s is not None
            else _env_float('SKYTPU_QOS_FALLBACK_TOK_S', 100.0)), 1e-6)
        self._time = time_fn
        self._wfq = WeightedFairQueue(self.weights, time_fn=time_fn)
        self._buckets: Dict[str, Dict[str, Optional[TokenBucket]]] = {}
        # In-flight COST (rows), not request count: max_inflight's
        # default is the engine's slot budget, which is per row.
        self._inflight = 0.0
        self._sweeper: Optional[threading.Thread] = None
        self._lock = threading.RLock()
        self._admitted = {c: 0 for c in CLASSES}
        self._shed = {c: 0 for c in CLASSES}
        self._evicted = {c: 0 for c in CLASSES}
        self._waits: Dict[str, Deque[float]] = {
            c: collections.deque(maxlen=512) for c in CLASSES}
        # (t, tokens) completions in a sliding window -> observed tok/s.
        self._tok_events: Deque[Tuple[float, int]] = collections.deque()

    # -- quota -------------------------------------------------------------

    def _tenant_buckets(self, tenant: str
                        ) -> Dict[str, Optional[TokenBucket]]:
        b = self._buckets.get(tenant)
        if b is not None:
            # LRU move-to-end: eviction must hit the least-recently-USED
            # bucket — insertion-order eviction would let a client spray
            # unique tenant ids to flush its own exhausted bucket and
            # restart at full burst.
            self._buckets[tenant] = self._buckets.pop(tenant)
        else:
            if len(self._buckets) >= 4096:  # abuse bound
                self._buckets.pop(next(iter(self._buckets)))
            rps, tps = self.tenant_limits.get(
                tenant, (self.tenant_rps, self.tenant_tps))
            b = {
                'rps': (TokenBucket(rps, max(rps, 1.0), self._time)
                        if rps > 0 else None),
                # 2s of burst: one full ask may exceed a second's refill.
                'tps': (TokenBucket(tps, max(tps * 2.0, 1.0), self._time)
                        if tps > 0 else None),
            }
            self._buckets[tenant] = b
        return b

    # -- throughput / Retry-After ------------------------------------------

    def note_tokens(self, n: int) -> None:
        with self._lock:
            self._tok_events.append((self._time(), int(n)))

    def observed_tok_s(self) -> float:
        now = self._time()
        with self._lock:
            while self._tok_events and now - self._tok_events[0][0] > 30.0:
                self._tok_events.popleft()
            if not self._tok_events:
                return 0.0
            span = max(now - self._tok_events[0][0], 1.0)
            return sum(n for _, n in self._tok_events) / span

    def _retry_after(self) -> float:
        """Queued token backlog over observed decode throughput: how long
        until the current queue plausibly drains."""
        rate = self.observed_tok_s() or self.fallback_tok_s
        backlog = sum((it.payload.est_tokens or 1.0)
                      for dq in self._wfq._by_class.values()  # noqa: SLF001
                      for it in dq)
        return min(max(backlog / rate, 1.0), 120.0)

    # -- admission ---------------------------------------------------------

    def submit(self, cls: str, tenant: str, *, cost: float = 1.0,
               est_tokens: float = 0.0,
               on_dispatch: Optional[Callable[[], None]] = None,
               ttl_s: Optional[float] = None) -> _Ticket:
        """Admit one request. Returns a ticket whose ``granted`` future
        resolves at dispatch (then run the work and ``release``), raises
        ``ShedError`` when quota or overload refuses the arrival, and
        may shed a QUEUED lower-class victim instead (its ``granted``
        future gets the ShedError)."""
        assert cls in CLASSES, cls
        with self._lock:
            return self._submit(cls, tenant, cost, est_tokens, on_dispatch,
                                ttl_s)

    def _submit(self, cls: str, tenant: str, cost: float,
                est_tokens: float, on_dispatch: Optional[Callable[[], None]],
                ttl_s: Optional[float]) -> _Ticket:
        now = self._time()
        self._expire()
        buckets = self._tenant_buckets(tenant)
        rps_b, tps_b = buckets['rps'], buckets['tps']
        if rps_b is not None and not rps_b.try_take(1.0, now):
            with self._lock:
                self._shed[cls] += 1
            raise ShedError(f'tenant {tenant!r} request quota exceeded',
                            rps_b.seconds_until(1.0, now))
        if est_tokens > 0 and tps_b is not None and \
                not tps_b.try_take(est_tokens, now):
            if rps_b is not None:
                rps_b.give(1.0)  # the request never ran
            with self._lock:
                self._shed[cls] += 1
            raise ShedError(f'tenant {tenant!r} token quota exceeded',
                            tps_b.seconds_until(est_tokens, now))
        if self._wfq.total >= self.max_queue:
            self._shed_for(cls, tenant, est_tokens, rps_b, tps_b)
        ticket = _Ticket(cls, tenant, cost, est_tokens, on_dispatch)
        ticket.granted = concurrent.futures.Future()
        ticket.item = self._wfq.push(
            ticket, cls, cost,
            ttl_s if ttl_s is not None else self.ttl_s.get(cls))
        with self._lock:
            self._admitted[cls] += 1
        self._ensure_sweeper()
        self._pump()
        return ticket

    def _shed_for(self, cls: str, tenant: str, est_tokens: float,
                  rps_b: Optional[TokenBucket],
                  tps_b: Optional[TokenBucket]) -> None:
        """Aggregate queue full: evict the NEWEST waiter of the lowest
        class strictly below the arrival (newest = least sunk wait, and
        its tenant retries soonest); no victim -> shed the arrival."""
        victim = None
        for lower in reversed(CLASSES):
            if CLASSES.index(lower) <= CLASSES.index(cls):
                break
            v = self._wfq.newest(lower)
            if v is not None:
                victim = v
                break
        if victim is None:
            if tps_b is not None and est_tokens > 0:
                tps_b.give(est_tokens)
            if rps_b is not None:
                rps_b.give(1.0)
            with self._lock:
                self._shed[cls] += 1
            raise ShedError('server overloaded', self._retry_after())
        self._wfq.remove(victim)
        vt: _Ticket = victim.payload
        vt.state = 'done'
        self._refund(vt)  # never served: full quota refund
        with self._lock:
            self._shed[vt.cls] += 1
        if vt.granted is not None and not vt.granted.done():
            vt.granted.set_exception(ShedError(
                'server overloaded (displaced by a higher-priority '
                'arrival)', self._retry_after()))

    def _refund(self, ticket: _Ticket) -> None:
        """Full quota refund for a request that was admitted but never
        served (displaced, TTL-evicted, or abandoned while queued):
        both the request token and the generated-token ask go back —
        the same accounting as the arrival-overload shed path, so
        overload outside a tenant's control never burns its quota."""
        b = self._buckets.get(ticket.tenant)
        if not b:
            return
        if b['rps'] is not None:
            b['rps'].give(1.0)
        if b['tps'] is not None and ticket.est_tokens > 0:
            b['tps'].give(ticket.est_tokens)

    # -- dispatch / completion ---------------------------------------------

    def _pump(self) -> None:
        # The gate budgets in COST units (rows), the same unit as
        # max_inflight's engine-slots default — a multi-row request
        # takes its row count, so waiting cannot silently move back
        # into the engine's own (priority-blind, TTL-free) queue.
        # Admission is until-full: the request that crosses the line is
        # dispatched whole rather than split.
        while self._inflight < self.max_inflight:
            item = self._wfq.pop()
            if item is None:
                break
            ticket: _Ticket = item.payload
            ticket.state = 'inflight'
            self._inflight += max(ticket.cost, 1.0)
            with self._lock:
                self._waits[ticket.cls].append(
                    max(self._time() - item.enqueued_at, 0.0))
            if ticket.granted is not None and not ticket.granted.done():
                ticket.granted.set_result(None)
            if ticket.on_dispatch is not None:
                ticket.on_dispatch()

    def release(self, ticket: _Ticket,
                generated_tokens: Optional[int] = None) -> None:
        """Work finished (or failed): free the in-flight slot, refund
        the unused token ask, and feed the throughput estimator."""
        with self._lock:
            self._release(ticket, generated_tokens)

    def _release(self, ticket: _Ticket,
                 generated_tokens: Optional[int]) -> None:
        if ticket.state != 'inflight':
            return
        ticket.state = 'done'
        self._inflight = max(self._inflight - max(ticket.cost, 1.0), 0.0)
        if generated_tokens is not None:
            b = self._buckets.get(ticket.tenant)
            if b and b['tps'] is not None and \
                    ticket.est_tokens > generated_tokens:
                b['tps'].give(ticket.est_tokens - generated_tokens)
            self.note_tokens(generated_tokens)
        self._pump()

    def abandon(self, ticket: _Ticket) -> None:
        """Caller gave up (client disconnect): drop a queued ticket, or
        release a dispatched one, so no in-flight slot leaks."""
        with self._lock:
            if ticket.state == 'queued' and ticket.item is not None and \
                    self._wfq.remove(ticket.item):
                ticket.state = 'done'
                self._refund(ticket)  # never served
                if ticket.granted is not None and \
                        not ticket.granted.done():
                    ticket.granted.cancel()  # nobody is waiting anymore
                return
            self._release(ticket, None)

    # -- TTL eviction ------------------------------------------------------

    def _expire(self, now: Optional[float] = None) -> None:
        with self._lock:
            self._expire_locked(now)

    def _expire_locked(self, now: Optional[float]) -> None:
        for item in self._wfq.expired(now):
            ticket: _Ticket = item.payload
            ticket.state = 'done'
            with self._lock:
                self._evicted[ticket.cls] += 1
            self._refund(ticket)  # never served
            if ticket.granted is not None and not ticket.granted.done():
                ticket.granted.set_exception(QueueTimeout(
                    f'{ticket.cls} request queued past its '
                    f'{self.ttl_s.get(ticket.cls)}s TTL'))

    def _ensure_sweeper(self) -> None:
        """TTL eviction must not depend on traffic or dispatch progress:
        a stalled engine pops nothing, so expiry runs off a timer thread,
        started here (under the lock) and gone once the queue is empty."""
        if self.sweep_s <= 0:
            return
        if self._sweeper is None:
            self._sweeper = threading.Thread(target=self._sweep_loop,
                                             name='qos-sweeper', daemon=True)
            self._sweeper.start()

    def _sweep_loop(self) -> None:
        while True:
            time.sleep(self.sweep_s)
            with self._lock:
                self._expire()
                self._pump()
                if self._wfq.total == 0:
                    self._sweeper = None  # the next submit starts one
                    return

    # -- observability -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Compact snapshot for /health (and from there the controller,
        Prometheus metrics, metrics history, and the dashboard). Must
        stay well under the prober's 16 KB health-body cap."""

        with self._lock:
            tok_s = self.observed_tok_s()
            classes = {}
            for cls in CLASSES:
                waits = sorted(round(w * 1000.0, 1)
                               for w in self._waits[cls])
                classes[cls] = {
                    'depth': self._wfq.depth(cls),
                    'weight': self.weights[cls],
                    'admitted': self._admitted[cls],
                    'shed': self._shed[cls],
                    'evicted': self._evicted[cls],
                    'queue_wait_ms': {
                        'count': len(waits),
                        'p50': nearest_rank(waits, 50),
                        'p95': nearest_rank(waits, 95),
                        'max': waits[-1] if waits else None,
                    },
                }
            return {
                'enabled': True,
                'queue_depth_total': self._wfq.total,
                'inflight': round(self._inflight, 1),
                'max_inflight': self.max_inflight,
                'max_queue': self.max_queue,
                'shed_total': sum(self._shed.values()),
                'evicted_total': sum(self._evicted.values()),
                'observed_tok_s': round(tok_s, 1),
                'classes': classes,
            }
