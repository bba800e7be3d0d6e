"""The port's QoS admission (``skypilot_tpu_torch/serve/qos.py``) against
the JAX package's ``skypilot_tpu/serve/qos.py``: the same scripted
submits, releases, abandons and clock steps under an injected clock give
the same grants, sheds (with their ``Retry-After``), evictions and
``stats()``, exactly. The JAX scheduler runs inside an event loop; the
port's grants are ``concurrent.futures`` futures and its sweeper a
thread. Also the pieces around it (the fair queue, the token bucket,
classification, tenants, the env checks) and the users-table reader."""
import asyncio
import concurrent.futures
import sys
import threading
import time

import pytest

from skypilot_tpu.serve import qos as jax_qos
from skypilot_tpu_torch.serve import qos as port_qos
from skypilot_tpu_torch.utils import users as port_users


class FakeClock:

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _opts(clock, **kw):
    opts = dict(max_inflight=2, max_queue=12,
                weights={'interactive': 8.0, 'standard': 4.0,
                         'batch': 1.0},
                ttl_s={'interactive': 60.0, 'standard': 60.0,
                       'batch': 60.0},
                tenant_rps=0, tenant_tps=0, sweep_s=0, time_fn=clock)
    opts.update(kw)
    return opts


def _grant(ticket):
    """A ticket's grant as plain data: pending, granted, shed (with its
    Retry-After), evicted or cancelled."""
    fut = ticket.granted
    if not fut.done():
        return 'pending'
    if fut.cancelled():
        return 'cancelled'
    err = fut.exception()
    if err is None:
        return 'granted'
    if type(err).__name__ == 'ShedError':
        return f'shed:{err.retry_after_s}'
    return type(err).__name__


def _play(lib, script, opts):
    """Run ``script`` on ``lib``'s scheduler: a list of ('submit', cls,
    tenant, kw), ('release', i, generated), ('abandon', i),
    ('advance', dt) and ('expire',). Returns the trace: each op's
    outcome, every ticket's grant state and stats() after each op."""
    clock = FakeClock()
    qos = lib.QosScheduler(**_opts(clock, **opts))
    tickets, trace = [], []
    for op in script:
        if op[0] == 'submit':
            _, cls, tenant, kw = op
            try:
                tickets.append(qos.submit(cls, tenant, **kw))
                outcome = 'admitted'
            except lib.ShedError as e:
                outcome = f'shed:{e.retry_after_s}:{e.reason}'
        elif op[0] == 'release':
            qos.release(tickets[op[1]], generated_tokens=op[2])
            outcome = None
        elif op[0] == 'abandon':
            qos.abandon(tickets[op[1]])
            outcome = None
        elif op[0] == 'advance':
            clock.advance(op[1])
            outcome = None
        else:
            qos._expire()  # noqa: SLF001 -- the sweeper's tick, by hand
            qos._pump()  # noqa: SLF001
            outcome = None
        trace.append((op, outcome, [_grant(t) for t in tickets],
                      [t.state for t in tickets], qos.stats()))
    return trace


def _both(script, **opts):
    async def jax_side():
        return _play(jax_qos, script, opts)
    want = asyncio.run(jax_side())
    got = _play(port_qos, script, opts)
    assert got == want
    return got


def _overload_script():
    script = []
    for i in range(24):
        cls = 'interactive' if i % 2 == 0 else 'batch'
        script += [('submit', cls, 'tenant', {'est_tokens': 8.0}),
                   ('advance', 0.01)]
    return script


SCRIPTS = {
    'dispatch_follows_priority': (
        [('submit', 'standard', 'a', {}), ('submit', 'batch', 'a', {}),
         ('submit', 'interactive', 'a', {}), ('release', 0, 1),
         ('release', 2, 1), ('release', 1, 1)],
        {'max_inflight': 1}),
    'tenant_quota_429_with_retry_after': (
        [('submit', 'standard', 'alice', {}),
         ('submit', 'standard', 'alice', {}),
         ('submit', 'standard', 'carol', {}),
         ('submit', 'standard', 'bob', {'est_tokens': 16.0}),
         ('submit', 'standard', 'bob', {'est_tokens': 16.0}),
         ('release', 2, 4),
         ('submit', 'standard', 'bob', {'est_tokens': 16.0}),
         ('advance', 0.7),
         ('submit', 'standard', 'alice', {})],
        {'max_inflight': 4, 'tenant_limits': {'alice': (1.0, 0.0),
                                              'bob': (0.0, 10.0)}}),
    'ttl_eviction_without_dispatch': (
        [('submit', 'standard', 'a', {}), ('submit', 'interactive', 'a', {}),
         ('advance', 6.0), ('expire',), ('release', 0, 0)],
        {'max_inflight': 1, 'ttl_s': {'interactive': 5.0, 'standard': 60.0,
                                      'batch': 60.0}}),
    'overload_batch_absorbs_sheds': (_overload_script(), {}),
    'abandon_refunds_queued_token_ask': (
        [('submit', 'standard', 'bob', {'est_tokens': 12.0}),
         ('submit', 'standard', 'bob', {'est_tokens': 8.0}),
         ('submit', 'standard', 'bob', {'est_tokens': 8.0}),
         ('abandon', 1),
         ('submit', 'standard', 'bob', {'est_tokens': 8.0}),
         ('release', 0, 12), ('release', 2, 8)],
        {'max_inflight': 1, 'tenant_limits': {'bob': (0.0, 10.0)}}),
    'victim_shed_refunds_rps_token': (
        [('submit', 'standard', 'other', {}), ('submit', 'batch', 'slow', {}),
         ('submit', 'interactive', 'other', {}), ('release', 0, 1),
         ('submit', 'batch', 'slow', {}), ('release', 2, 1),
         ('release', 3, 1)],
        {'max_inflight': 1, 'max_queue': 1,
         'tenant_limits': {'slow': (1.0, 0.0)}}),
    'gate_budgets_rows_not_requests': (
        [('submit', 'standard', 'a', {'cost': 4.0}),
         ('submit', 'standard', 'a', {'cost': 1.0}), ('release', 0, 4),
         ('release', 1, 1)],
        {'max_inflight': 4}),
    'victim_shed_carries_retry_after': (
        [('submit', 'batch', 'a', {}), ('submit', 'batch', 'a', {}),
         ('submit', 'interactive', 'a', {}), ('release', 0, 1),
         ('release', 2, 1)],
        {'max_inflight': 1, 'max_queue': 1}),
    'retry_after_from_observed_throughput': (
        [('submit', 'standard', 'a', {'est_tokens': 64.0}),
         ('release', 0, 640), ('advance', 2.0)]
        + [('submit', 'batch', 'a', {'est_tokens': 500.0})] * 4
        + [('submit', 'standard', 'a', {'est_tokens': 500.0})] * 2,
        {'max_inflight': 1, 'max_queue': 3}),
}


@pytest.mark.parametrize('name', sorted(SCRIPTS))
def test_scheduler_decisions_equal_jax(name):
    script, opts = SCRIPTS[name]
    trace = _both(script, **opts)
    final = trace[-1][-1]
    if name == 'overload_batch_absorbs_sheds':
        # The JAX test's acceptance facts hold on the shared trace.
        assert final['shed_total'] > 0
        assert final['classes']['interactive']['shed'] == 0
        assert final['classes']['batch']['shed'] == final['shed_total']
    if name == 'tenant_quota_429_with_retry_after':
        outcomes = [o for _, o, *_ in trace if o and o.startswith('shed')]
        assert outcomes[0].startswith('shed:1:')  # Retry-After 1 s
    if name == 'ttl_eviction_without_dispatch':
        assert final['classes']['interactive']['evicted'] == 1


def test_scheduler_drains_the_overload_like_jax():
    """The JAX acceptance drain: release every dispatched ticket until
    nothing is in flight; the port grants in the same order and ends
    with the same stats."""
    def play(lib):
        clock = FakeClock()
        qos = lib.QosScheduler(**_opts(clock))
        tickets, order = [], []
        for i in range(24):
            cls = 'interactive' if i % 2 == 0 else 'batch'
            try:
                tickets.append((cls, qos.submit(cls, 'tenant',
                                                est_tokens=8.0)))
            except lib.ShedError:
                pass
            clock.advance(0.01)
        for _ in range(100):
            inflight = [t for _, t in tickets if t.state == 'inflight']
            if not inflight:
                break
            for t in inflight:
                order.append(tickets.index(next(
                    p for p in tickets if p[1] is t)))
                qos.release(t, generated_tokens=8)
            clock.advance(0.05)
        return order, qos.stats()

    async def jax_side():
        return play(jax_qos)
    want = asyncio.run(jax_side())
    got = play(port_qos)
    assert got == want
    assert got[1]['classes']['interactive']['queue_wait_ms']['count'] == 12


def test_fair_queue_and_bucket_equal_jax():
    for lib in (jax_qos, port_qos):
        clock = FakeClock()
        wfq = lib.WeightedFairQueue({'interactive': 4.0, 'batch': 1.0},
                                    time_fn=clock)
        for i in range(12):
            wfq.push(('i', i), 'interactive', ttl_s=5.0 if i == 3 else None)
            wfq.push(('b', i), 'batch')
        clock.advance(6.0)
        expired = [it.payload for it in wfq.expired()]
        order = []
        while (item := wfq.pop()) is not None:
            order.append(item.payload)
        b = lib.TokenBucket(rate=2.0, burst=2.0, time_fn=clock)
        bucket = [b.try_take(1.0), b.try_take(1.0), b.try_take(1.0),
                  b.seconds_until(1.0)]
        if lib is jax_qos:
            want = (expired, order, bucket)
    assert (expired, order, bucket) == want
    assert expired == [('i', 3)] and order[:10].count(('b', 0)) == 1


def test_fair_queue_heap_compacts_under_saturated_gate():
    clock = FakeClock()
    wfq = port_qos.WeightedFairQueue(time_fn=clock)
    for i in range(5000):
        item = wfq.push(i, 'batch', ttl_s=0.5)
        if i % 2:
            wfq.remove(item)
        clock.advance(0.001)
        wfq.expired()
    assert wfq.total <= 500
    assert len(wfq._heap) <= 2 * max(wfq.total, 16) + 1  # noqa: SLF001


@pytest.mark.parametrize('body, headers', [
    ({'priority': 'interactive'}, None),
    ({}, {'X-SkyTPU-Priority': 'Batch'}),
    ({}, None),
    ({'priority': 'batch'}, {'X-SkyTPU-Priority': 'interactive'}),
    ({'priority': 'urgent'}, None),
])
def test_classify_equals_jax(body, headers):
    def run(lib):
        try:
            return lib.classify(body, headers)
        except ValueError as e:
            return f'ValueError: {e}'
    assert run(port_qos) == run(jax_qos)


def test_parse_maps_nearest_rank_and_env_checks_equal_jax(monkeypatch):
    spec = 'interactive:10,batch:0.5'
    assert port_qos.parse_class_map(spec, port_qos._DEFAULT_WEIGHTS) == \
        jax_qos.parse_class_map(spec, jax_qos._DEFAULT_WEIGHTS)
    assert port_qos.parse_tenant_limits('alice=5/1000, bob=1/50') == \
        jax_qos.parse_tenant_limits('alice=5/1000, bob=1/50')
    vals = sorted([3.0, 1.0, 7.5, 2.0, 9.0, 4.0])
    for q in (50, 95, 99):
        assert port_qos.nearest_rank(vals, q) == jax_qos.nearest_rank(vals, q)
    assert port_qos.nearest_rank([], 50) is None
    for var, value in (('SKYTPU_QOS_WEIGHTS', 'gold:1'),
                       ('SKYTPU_QOS_MAX_QUEUE', 'many'),
                       ('SKYTPU_QOS_TENANT_RPS', '1O')):
        monkeypatch.setenv(var, value)
        for lib in (jax_qos, port_qos):
            with pytest.raises(ValueError):
                lib.validate_env()
        monkeypatch.delenv(var)
    for lib in (jax_qos, port_qos):
        lib.validate_env()
    monkeypatch.setenv('SKYTPU_QOS', '1')
    assert port_qos.enabled() and port_qos.enabled('on')
    assert not port_qos.enabled('off')


def test_resolve_tenant_and_users_reader_equal_jax(monkeypatch, tmp_path):
    """Tenants from the users table (a JAX-written sqlite file read by
    the port's reader), the declared header or field, or anonymous; and
    the scrape-token gate."""
    from skypilot_tpu import users as jax_users
    monkeypatch.setenv('SKYTPU_STATE_DIR', str(tmp_path))
    monkeypatch.delenv('SKYTPU_API_TOKEN', raising=False)
    for lib in (jax_users, port_users):
        lib._TENANT_CACHE.clear()  # noqa: SLF001
    # No users: single-user mode, every token is the local admin.
    assert port_users.authenticate('x') == jax_users.authenticate('x')
    jax_users.add_user('alice', 'tok-a', 'user')
    for lib in (jax_users, port_users):
        lib._TENANT_CACHE.clear()  # noqa: SLF001
    cases = [({'Authorization': 'Bearer tok-a',
               'X-SkyTPU-Tenant': 'spoof'}, {}),
             ({'Authorization': 'Bearer nope',
               'X-SkyTPU-Tenant': 'team-x'}, {}),
             ({}, {'tenant': 'bodyside'}), ({}, {}),
             ({'Authorization': 'Basic abc'}, {'tenant': 'y' * 80})]
    for headers, body in cases:
        assert port_qos.resolve_tenant(headers, body) == \
            jax_qos.resolve_tenant(headers, body)
    assert port_qos.resolve_tenant(*cases[0]) == 'alice'
    assert port_users.bearer_token({'Authorization': 'Bearer \udcff'}) \
        is None
    monkeypatch.setenv('SKYTPU_API_TOKEN', 'root-tok')
    assert port_users.authenticate('root-tok') == \
        jax_users.authenticate('root-tok') == {'name': 'root',
                                               'role': 'admin'}
    for headers in ({}, {'Authorization': 'Bearer s3cret'},
                    {'Authorization': 'Bearer wrong'}):
        monkeypatch.delenv('SKYTPU_METRICS_TOKEN', raising=False)
        assert port_users.metrics_scrape_allowed(headers)
        monkeypatch.setenv('SKYTPU_METRICS_TOKEN', 's3cret')
        assert port_users.metrics_scrape_allowed(headers) == \
            jax_users.metrics_scrape_allowed(headers)


def test_sweeper_thread_evicts_a_stalled_waiter_and_exits():
    """TTL eviction runs off the sweeper thread when nothing dispatches;
    the thread ends once the queue is empty."""
    qos = port_qos.QosScheduler(
        max_inflight=1, max_queue=8, sweep_s=0.05, tenant_rps=0,
        tenant_tps=0, ttl_s={'interactive': 0.2, 'standard': 30.0,
                             'batch': 30.0})
    stuck = qos.submit('standard', 'a')
    waiting = qos.submit('interactive', 'a')
    with pytest.raises(port_qos.QueueTimeout, match='TTL'):
        waiting.granted.result(timeout=10)
    assert qos.stats()['classes']['interactive']['evicted'] == 1
    deadline = time.monotonic() + 10
    while qos._sweeper is not None:  # noqa: SLF001
        assert time.monotonic() < deadline
        time.sleep(0.02)
    qos.release(stuck, generated_tokens=0)
    assert qos.stats()['inflight'] == 0


def test_concurrent_submits_and_releases_lose_no_update():
    """Handler threads admit and release at once (more threads than
    cores, a short switch interval): every request is granted exactly
    once and the gate ends empty."""
    qos = port_qos.QosScheduler(max_inflight=3, max_queue=10_000,
                                sweep_s=0.01, tenant_rps=0, tenant_tps=0)
    n_threads, per_thread = 32, 25
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work(i):
            for j in range(per_thread):
                cls = port_qos.CLASSES[(i + j) % 3]
                t = qos.submit(cls, f't{i % 4}', est_tokens=2.0)
                t.granted.result(timeout=60)
                qos.release(t, generated_tokens=2)
        with concurrent.futures.ThreadPoolExecutor(n_threads) as pool:
            for f in [pool.submit(work, i) for i in range(n_threads)]:
                f.result(timeout=120)
    finally:
        sys.setswitchinterval(old)
    stats = qos.stats()
    assert stats['inflight'] == 0 and stats['queue_depth_total'] == 0
    assert sum(c['admitted'] for c in stats['classes'].values()) == \
        n_threads * per_thread
    assert stats['shed_total'] == stats['evicted_total'] == 0
    assert threading.active_count() < 64
