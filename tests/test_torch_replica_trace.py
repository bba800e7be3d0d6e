"""Request tracing on the replica: the port's replica against the JAX
replica on the CPU, and a JAX load balancer in front of a port replica.

Both replicas answer the same traced requests (the engine, a stream, the
window path, QoS admission); each request's ``serve.generate`` trace must
hold the same span names, parentage and attribute keys. Tracing only
observes: greedy tokens are the same with ``SKYTPU_TRACE`` on and off.
"""
import asyncio
import collections
import json
import threading
import time
import urllib.error
import urllib.request

import pytest
from aiohttp import web

from skypilot_tpu.observability import trace as jax_trace
from skypilot_tpu.serve import llm_server as jax_srv
from skypilot_tpu.serve.load_balancer import LoadBalancer
from skypilot_tpu.utils import common_utils
from skypilot_tpu_torch.observability import trace as port_trace
from skypilot_tpu_torch.serve import llm_server as port_srv

MAX_LEN = 64
TOKEN = 'scrape-only-token'
QOS_OPTS = dict(max_inflight=2, max_queue=8, sweep_s=0, tenant_rps=0,
                tenant_tps=0,
                ttl_s={'interactive': 30.0, 'standard': 30.0,
                       'batch': 30.0})
ROUTES = ('/debug/traces', '/debug/blackbox', '/debug/exemplars',
          '/debug/alerts')


@pytest.fixture(autouse=True)
def traced(monkeypatch):
    monkeypatch.setenv('SKYTPU_TRACE', '1')
    monkeypatch.setenv('SKYTPU_TRACE_TAIL', '1')
    monkeypatch.delenv('SKYTPU_TRACE_SAMPLE', raising=False)
    monkeypatch.delenv('SKYTPU_METRICS_TOKEN', raising=False)
    monkeypatch.setenv('SKYTPU_TRACE_TAIL_BASELINE_PER_MIN', '0')
    for mod in (jax_trace, port_trace):
        mod.reset()
    yield
    for mod in (jax_trace, port_trace):
        mod.flush_keep_exports()
        mod.reset()


def _serve_jax(server):
    """The JAX replica's aiohttp app on a free port, in a daemon thread
    whose loop stays up, as in tests/test_observability.py (stopping it
    under a pending window worker only raises at garbage collection)."""
    port = common_utils.find_free_port(25100)
    started = threading.Event()
    loop = asyncio.new_event_loop()

    def run():
        asyncio.set_event_loop(loop)
        runner = web.AppRunner(server.make_app())
        loop.run_until_complete(runner.setup())
        loop.run_until_complete(
            web.TCPSite(runner, '127.0.0.1', port).start())
        started.set()
        loop.run_forever()

    threading.Thread(target=run, daemon=True).start()
    assert started.wait(30)
    return f'127.0.0.1:{port}'


def _serve_port(server):
    httpd = server.make_httpd('127.0.0.1', 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f'127.0.0.1:{httpd.server_address[1]}', httpd


@pytest.fixture()
def pair(request):
    """(jax endpoint, port endpoint) of two replicas built alike; the
    parameter is the LlmServer keyword arguments."""
    kw = dict(request.param)
    if kw.get('qos') == 'on':
        kw['qos_opts'] = dict(QOS_OPTS)
    jserver = jax_srv.LlmServer('tiny', max_len=MAX_LEN, **kw)
    pserver = port_srv.LlmServer('tiny', max_len=MAX_LEN, device='cpu',
                                 **kw)
    jep = _serve_jax(jserver)
    pep, httpd = _serve_port(pserver)
    try:
        yield jep, pep
    finally:
        httpd.shutdown()
        httpd.server_close()
        pserver.stop()
        if jserver.engine is not None:
            jserver.engine.stop()


def _http(ep, path, body=None, headers=None):
    """(status, headers, body bytes); HTTP errors too."""
    data = None if body is None else (
        body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(f'http://{ep}{path}', data=data,
                                 headers=dict(headers or {}),
                                 method='GET' if body is None else 'POST')
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _trace(ep, tid, headers=None):
    status, _, raw = _http(ep, f'/debug/traces?trace_id={tid}',
                           headers=headers)
    assert status == 200, raw
    body = json.loads(raw)
    assert body['count'] == 1, body
    return body['traces'][0]


def _shape(tr):
    """A trace's spans as a multiset of (name, parent's name, attribute
    keys), and the root's attribute keys."""
    by_id = {s['span_id']: s['name'] for s in tr['spans']}
    shape = collections.Counter(
        (s['name'], by_id.get(s['parent_id']),
         tuple(sorted(s.get('attrs') or ()))) for s in tr['spans'])
    return shape, sorted(tr['attrs'])


def _nested(tr):
    """Every span closed, and inside its parent."""
    by_id = {s['span_id']: s for s in tr['spans']}
    for s in tr['spans']:
        assert s['end'] is not None and s['end'] >= s['start'], s
        parent = by_id.get(s['parent_id'])
        if parent is not None:
            assert parent['start'] <= s['start'] + 1e-6, (parent, s)
            assert s['end'] <= parent['end'] + 1e-6, (parent, s)


BODIES = {
    'engine': {'tokens': [[1, 2, 3]], 'max_new_tokens': 12},
    'two rows': {'tokens': [[1, 2, 3], [4, 5, 6, 7]],
                 'max_new_tokens': 10},
    'stream': {'tokens': [[9, 8, 7]], 'max_new_tokens': 12,
               'stream': True},
}


@pytest.mark.parametrize('pair, names', [
    ({}, ('engine', 'two rows', 'stream')),
    ({'engine': 'off'}, ('engine', 'two rows')),
    ({'qos': 'on'}, ('engine', 'stream')),
], indirect=['pair'], ids=['engine', 'window', 'qos'])
def test_spans_equal_jax_replica(pair, names):
    jep, pep = pair
    for name in names:
        body = BODIES[name]
        shapes, verdicts = [], []
        for ep, mod in ((jep, jax_trace), (pep, port_trace)):
            header = mod.make_header()
            status, headers, raw = _http(
                ep, '/generate', body,
                {mod.TRACE_HEADER: header, 'X-SkyTPU-Tenant': 'tracer',
                 'Content-Type': 'application/json'})
            assert status == 200, raw
            tr = _trace(ep, mod.parse_header(header)[0])
            _nested(tr)
            roots = [s for s in tr['spans'] if s['name'] == 'serve.generate']
            assert len(roots) == 1
            assert roots[0]['parent_id'] == mod.parse_header(header)[1]
            shapes.append(_shape(tr))
            verdicts.append(headers.get(mod.VERDICT_HEADER))
        assert shapes[1] == shapes[0], name
        assert verdicts[1] == verdicts[0], name
        names_seen = {n for n, _, _ in shapes[1][0]}
        assert ('serve.stream' in names_seen) == bool(body.get('stream'))


@pytest.mark.parametrize('pair', [{}], indirect=True, ids=['engine'])
def test_health_trace_and_routes_behind_the_token(pair, monkeypatch):
    jep, pep = pair
    for ep in (jep, pep):
        _http(ep, '/generate', BODIES['engine'])
    jh = json.loads(_http(jep, '/health')[2])
    ph = json.loads(_http(pep, '/health')[2])
    assert set(ph['trace']) == set(jh['trace'])
    assert ph['trace'] == port_trace.tail_stats()
    assert set(ph) - {'device', 'tp_backend'} == set(jh)
    for ep in (jep, pep):
        for path in ROUTES:
            assert _http(ep, path)[0] == 200, (ep, path)
    monkeypatch.setenv('SKYTPU_METRICS_TOKEN', TOKEN)
    for ep in (jep, pep):
        for path in ROUTES + ('/metrics',):
            assert _http(ep, path)[0] == 401, (ep, path)
            assert _http(ep, path, headers={
                'Authorization': 'Bearer wrong'})[0] == 401
            status, _, raw = _http(ep, path, headers={
                'Authorization': f'Bearer {TOKEN}'})
            assert status == 200, (ep, path, raw)
    auth = {'Authorization': f'Bearer {TOKEN}'}
    alerts = [json.loads(_http(ep, '/debug/alerts', headers=auth)[2])
              for ep in (jep, pep)]
    assert alerts[1] == alerts[0]
    shapes = [set(json.loads(_http(ep, '/debug/blackbox',
                                   headers=auth)[2])) for ep in (jep, pep)]
    assert shapes[1] == shapes[0]
    status, headers, raw = _http(pep, '/metrics', headers=dict(
        auth, Accept='application/openmetrics-text; version=1.0.0'))
    assert status == 200 and raw.decode().rstrip('\n').endswith('# EOF')
    assert headers['Content-Type'].startswith(
        'application/openmetrics-text')


@pytest.mark.parametrize('pair', [{}], indirect=True, ids=['engine'])
def test_malformed_body_is_retained_as_error(pair):
    """A body that is not JSON: the JAX replica raises in its handler (a
    500, its trace kept as 'error'); the port answers 400 and keeps the
    trace as 'error' too."""
    jep, pep = pair
    jheader = jax_trace.make_header()
    status, headers, _ = _http(jep, '/generate', b'{not json',
                               {jax_trace.TRACE_HEADER: jheader})
    assert status == 500
    assert _trace(jep, jax_trace.parse_header(jheader)[0])[
        'retained'] == 'error'
    header = port_trace.make_header()
    status, headers, _ = _http(pep, '/generate', b'{not json',
                               {port_trace.TRACE_HEADER: header})
    assert status == 400
    assert headers[port_trace.VERDICT_HEADER] == 'error'
    tr = _trace(pep, port_trace.parse_header(header)[0])
    assert tr['retained'] == 'error'
    assert tr['attrs']['error'] == 'JSONDecodeError'


def test_greedy_tokens_identical_with_tracing_on_and_off(monkeypatch):
    server = port_srv.LlmServer('tiny', max_len=MAX_LEN, device='cpu')
    window = port_srv.LlmServer('tiny', max_len=MAX_LEN, device='cpu',
                                engine='off')
    eps = []
    for s in (server, window):
        ep, httpd = _serve_port(s)
        eps.append((ep, httpd, s))
    reqs = [dict(BODIES['engine']), dict(BODIES['two rows']),
            {'tokens': [[3] * 20], 'max_new_tokens': 30}]
    try:
        runs = []
        for flag in ('1', '0', '1'):
            monkeypatch.setenv('SKYTPU_TRACE', flag)
            out = []
            for ep, _, _ in eps:
                for body in reqs:
                    status, headers, raw = _http(ep, '/generate', body, {
                        port_trace.TRACE_HEADER: port_trace.make_header()})
                    assert status == 200
                    out.append(json.loads(raw)['tokens'])
                status, _, raw = _http(eps[0][0], '/generate', dict(
                    BODIES['stream']))
                out.append(raw)
            runs.append(out)
        assert runs[0] == runs[1] == runs[2]
    finally:
        for _, httpd, s in eps:
            httpd.shutdown()
            httpd.server_close()
            s.stop()


def test_jax_load_balancer_stitches_a_port_replica(monkeypatch):
    """A JAX LB in front of a port replica: ``?stitch=1&trace_id=`` merges
    the LB's ``lb.request`` and the replica's ``serve.generate`` into one
    waterfall, and the LB's keep reaches the replica's PENDING fragment
    through the trailing ``/debug/traces?retain=`` (the replica's own
    verdict said nothing: no baseline keeps on its side)."""
    monkeypatch.setenv('SKYTPU_TRACE_SAMPLE', '0')  # tail-pending legs
    monkeypatch.setenv('SKYTPU_TRACE_TAIL_BASELINE_PER_MIN', '1000')
    monkeypatch.setattr(port_trace._TAIL, '_baseline_allow',  # noqa: SLF001
                        lambda: False)
    server = port_srv.LlmServer('tiny', max_len=MAX_LEN, device='cpu')
    pep, httpd = _serve_port(server)
    lb = LoadBalancer(common_utils.find_free_port(25300))
    lb.set_replicas([pep])
    lb.start_in_thread()
    try:
        header = jax_trace.make_header(sampled=False)
        tid = jax_trace.parse_header(header)[0]
        status, _, raw = _http(f'127.0.0.1:{lb.port}', '/generate',
                               BODIES['engine'],
                               {jax_trace.TRACE_HEADER: header})
        assert status == 200, raw
        deadline = time.monotonic() + 30
        while port_trace.tail_stats()['promoted'] < 1:
            assert time.monotonic() < deadline, port_trace.tail_stats()
            time.sleep(0.05)
        assert port_trace.tail_stats()['pending'] == 0
        status, _, raw = _http(f'127.0.0.1:{lb.port}',
                               f'/debug/traces?stitch=1&trace_id={tid}')
        assert status == 200, raw
        body = json.loads(raw)
        assert body['stitched_from'] == [pep]
        assert body['count'] == 1
        tr = body['traces'][0]
        names = [s['name'] for s in tr['spans']]
        assert 'lb.request' in names and 'serve.generate' in names
        by_id = {s['span_id']: s for s in tr['spans']}
        replica_root = next(s for s in tr['spans']
                            if s['name'] == 'serve.generate')
        assert by_id[replica_root['parent_id']]['name'] == 'lb.request'
        assert tr['retained'] == 'baseline'
        assert _trace(pep, tid)['retained'] == 'baseline'
    finally:
        lb.stop()
        httpd.shutdown()
        httpd.server_close()
        server.stop()


def test_jax_load_balancer_stitches_the_handoff_legs(monkeypatch):
    """A JAX LB in front of a port prefill and a port decode replica: one
    traced request through the handoff stitches into one waterfall, the
    LB's ``lb.handoff.export``/``fetch``/``import`` legs beside the
    replicas' ``serve.kv_export`` (with its ``serve.prefill`` child) and
    ``serve.kv_import`` roots, each root joined to the LB's trace."""
    servers = {role: port_srv.LlmServer('tiny', max_len=MAX_LEN,
                                        device='cpu', kv_layout='paged',
                                        role=role)
               for role in ('prefill', 'decode')}
    eps, httpds = {}, []
    for role, s in servers.items():
        eps[role], httpd = _serve_port(s)
        httpds.append(httpd)
    lb = LoadBalancer(common_utils.find_free_port(25500))
    lb.set_replicas(list(eps.values()),
                    roles={ep: role for role, ep in eps.items()})
    lb.start_in_thread()
    try:
        header = jax_trace.make_header()
        tid = jax_trace.parse_header(header)[0]
        body = {'tokens': [list(range(1, 40))], 'max_new_tokens': 6}
        status, headers, raw = _http(f'127.0.0.1:{lb.port}', '/generate',
                                     body, {jax_trace.TRACE_HEADER: header})
        assert status == 200, raw
        assert headers.get('X-SkyTPU-Disagg') == 'remote'
        # Both replicas run in this process, so the port's tracer holds
        # both fragments of the journey.
        spans = {sp['name']: sp for sp in _trace(eps['prefill'],
                                                 tid)['spans']}
        assert {'nbytes', 'prompt_len', 'staged', 'status'} <= set(
            spans['serve.kv_export']['attrs'])
        assert spans['serve.kv_import']['attrs']['status'] == 200
        assert spans['serve.kv_import']['attrs']['tokens'] == 6
        status, _, raw = _http(f'127.0.0.1:{lb.port}',
                               f'/debug/traces?stitch=1&trace_id={tid}')
        assert status == 200, raw
        stitched = json.loads(raw)
        assert sorted(stitched['stitched_from']) == sorted(eps.values())
        tr = stitched['traces'][0]
        by_id = {s['span_id']: s for s in tr['spans']}
        names = collections.Counter(s['name'] for s in tr['spans'])
        for name in ('lb.request', 'lb.handoff.export', 'lb.handoff.fetch',
                     'lb.handoff.import', 'serve.kv_export',
                     'serve.kv_import', 'serve.prefill', 'serve.decode'):
            assert names[name] >= 1, (name, names)
        for root in ('serve.kv_export', 'serve.kv_import'):
            span = next(s for s in tr['spans'] if s['name'] == root)
            assert by_id[span['parent_id']]['name'].startswith('lb.'), span
        prefill = [s for s in tr['spans'] if s['name'] == 'serve.prefill']
        assert {by_id[s['parent_id']]['name'] for s in prefill} == {
            'serve.kv_export', 'serve.kv_import'}
    finally:
        lb.stop()
        for httpd in httpds:
            httpd.shutdown()
            httpd.server_close()
        for s in servers.values():
            s.stop()
