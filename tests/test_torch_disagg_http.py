"""The port's replicas in the prefill and decode roles, over HTTP, behind
the JAX package's load balancer (``skypilot_tpu/serve/load_balancer.py``,
framework-free), on the CPU.

Counterparts of ``tests/test_serve_disagg.py``'s HTTP tests: the load
balancer's export -> prepare -> fetch -> import legs give the colocated
replica's tokens (buffered and streamed) and fill ``/health``'s ``disagg``
and the ``skytpu_disagg_*`` families; a corrupt payload gets 400 and a
dead prefill pool the colocated fallback (``fallbacks_served``,
``skytpu_disagg_fallback_total``); a QoS shed of the export (429) falls
back too; the staging directory carries the payload; a decode replica
killed mid-stream is resumed elsewhere. Then the routes' own status codes
(404 for an expired handoff, 400, 409, 411) and a mixed fleet: a JAX
prefill replica with a port decode replica, and the reverse (float32
TINY, the same weights, JAX's colocated tokens).
"""
import asyncio
import dataclasses
import http.client
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp import web

from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.serve import llm_server as jax_srv
from skypilot_tpu.serve.load_balancer import LoadBalancer
from skypilot_tpu.utils import common_utils
from skypilot_tpu_torch.models import llama as port_llama
from skypilot_tpu_torch.serve import disagg as pd
from skypilot_tpu_torch.serve import llm_server as port_srv

MAX_LEN = 96


def _row(n, salt=0):
    return [(7 * i + 11 * salt) % 250 + 1 for i in range(n)]


def _http(ep, path, body=None, headers=None, timeout=300):
    """(status, headers, body bytes) of one request; ``body`` a dict is
    sent as JSON, bytes as they are."""
    data = body if body is None or isinstance(body, bytes) else \
        json.dumps(body).encode()
    hdrs = dict(headers or {})
    if isinstance(body, dict):
        hdrs.setdefault('Content-Type', 'application/json')
    req = urllib.request.Request(f'http://{ep}{path}', data=data,
                                 headers=hdrs,
                                 method='GET' if body is None else 'POST')
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _serve_port(server):
    httpd = server.make_httpd('127.0.0.1', 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f'127.0.0.1:{httpd.server_address[1]}', httpd


def _serve_jax(server, port_base):
    """The JAX replica's aiohttp app on a free port, in a daemon thread
    (tests/test_serve_disagg.py ``_start_http``)."""
    port = common_utils.find_free_port(port_base)
    started = threading.Event()

    def run():
        loop = asyncio.new_event_loop()
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


def _lb(eps, port_base):
    lb = LoadBalancer(common_utils.find_free_port(port_base))
    lb.set_replicas(list(eps.values()),
                    roles={ep: role for role, ep in eps.items()})
    lb.start_in_thread()
    return lb


def _close(servers, httpds, lb=None):
    if lb is not None:
        lb.stop()
    for httpd in httpds:
        httpd.shutdown()
        httpd.server_close()
    for s in servers:
        s.stop()


def _scrape(ep, name):
    _, _, raw = _http(ep, '/metrics')
    for line in raw.decode().splitlines():
        if line.startswith(name + ' ') or line.startswith(name + '{'):
            yield line.rsplit(' ', 1)[0], float(line.rsplit(' ', 1)[1])


@pytest.fixture(scope='module')
def fleet():
    """Port prefill, decode and colocated replicas (tiny, paged) behind
    a role-aware JAX load balancer."""
    servers = {role: port_srv.LlmServer('tiny', max_len=MAX_LEN,
                                        kv_layout='paged', role=role,
                                        device='cpu')
               for role in ('prefill', 'decode', 'colocated')}
    eps, httpds = {}, []
    for role, s in servers.items():
        eps[role], httpd = _serve_port(s)
        httpds.append(httpd)
    lb = _lb(eps, 26100)
    try:
        yield servers, eps, lb
    finally:
        _close(servers.values(), httpds, lb)


def _stream(ep, body, headers=None):
    """The NDJSON lines of a streamed request."""
    status, _, raw = _http(ep, '/generate', dict(body, stream=True),
                           headers)
    assert status == 200, raw
    return [json.loads(ln) for ln in raw.decode().splitlines()
            if ln.strip()]


def test_lb_handoff_matches_colocated_and_counts(fleet):
    servers, eps, lb = fleet
    lb_ep = f'127.0.0.1:{lb.port}'
    body = {'tokens': [_row(21, 10)], 'max_new_tokens': 10}
    _, _, direct = _http(eps['colocated'], '/generate', body)
    status, hdrs, via = _http(lb_ep, '/generate', body)
    assert status == 200, via
    assert json.loads(via) == json.loads(direct)
    assert hdrs.get('X-SkyTPU-Disagg') == 'remote'
    assert hdrs.get('X-Served-By') == eps['decode']
    lines = _stream(lb_ep, body)
    assert lines[-1] == {'done': True}
    assert [t for ln in lines[:-1] for t in ln['tokens']] \
        == json.loads(direct)['tokens'][0]
    assert lb.disagg_stats['handoffs'] == 2
    h_pre = json.loads(_http(eps['prefill'], '/health')[2])
    h_dec = json.loads(_http(eps['decode'], '/health')[2])
    assert h_pre['role'] == 'prefill' and h_dec['role'] == 'decode'
    assert h_pre['disagg']['exports'] == 2
    assert h_pre['disagg']['export_bytes'] > 0
    assert h_pre['disagg']['parked'] == 0
    assert h_dec['disagg']['imports'] == 2
    assert h_dec['disagg']['import_bytes'] > 0
    assert h_dec['engine']['disagg']['imports'] == 2
    assert h_pre['engine']['disagg']['exports'] == 2
    assert h_dec['disagg']['fallbacks_served'] == 0
    assert h_dec['engine']['disagg']['import_errors'] == 0
    # Exports alone ran no decode chunk on the prefill replica.
    assert h_pre['engine']['pipeline']['dispatches'] == 0
    got = dict(_scrape(eps['decode'], 'skytpu_disagg_handoff_bytes'))
    assert got['skytpu_disagg_handoff_bytes{direction="import"}'] \
        == h_dec['disagg']['import_bytes']


def test_corrupt_payload_400_and_dead_prefill_falls_back(fleet):
    servers, eps, lb = fleet
    pre_ep, dec_ep = eps['prefill'], eps['decode']
    body = {'tokens': [_row(17, 11)], 'max_new_tokens': 8}
    status, _, raw = _http(pre_ep, '/v1/kv/export', body)
    assert status == 200, raw
    exp = json.loads(raw)
    status, _, data = _http(pre_ep,
                            f'/v1/kv/fetch?handoff={exp["handoff"]}')
    assert status == 200 and len(data) == exp['nbytes']
    bad = bytearray(data)
    bad[-5] ^= 0xFF
    imports0 = servers['decode'].engine.imports
    rejects0 = servers['decode'].disagg_stats['import_rejects']
    status, _, raw = _http(dec_ep, '/v1/kv/import', bytes(bad),
                           {'Content-Type': 'application/octet-stream'})
    assert status == 400, raw
    assert 'crc32' in json.loads(raw)['error']
    assert servers['decode'].disagg_stats['import_rejects'] == rejects0 + 1
    assert servers['decode'].engine.imports == imports0
    # The intact payload still installs.
    status, _, raw = _http(dec_ep, '/v1/kv/import', data,
                           {'Content-Type': 'application/octet-stream'})
    assert status == 200, raw
    try:
        fallbacks0 = lb.disagg_stats['fallbacks']
        lb.set_replicas(['127.0.0.1:9', dec_ep, eps['colocated']],
                        roles={'127.0.0.1:9': 'prefill', dec_ep: 'decode',
                               eps['colocated']: 'colocated'})
        status, hdrs, via = _http(f'127.0.0.1:{lb.port}', '/generate', body)
        assert status == 200, via
        _, _, direct = _http(eps['colocated'], '/generate', body)
        assert json.loads(via) == json.loads(direct)
        assert lb.disagg_stats['fallbacks'] == fallbacks0 + 1
        served = [role for role, ep in eps.items()
                  if ep == hdrs.get('X-Served-By')]
        assert served in (['decode'], ['colocated'])
        assert servers[served[0]].disagg_stats['fallbacks_served'] == 1
        assert dict(_scrape(eps[served[0]], 'skytpu_disagg_fallback_total')
                    )['skytpu_disagg_fallback_total'] == 1.0
    finally:
        lb.set_replicas(list(eps.values()),
                        roles={ep: role for role, ep in eps.items()})


def test_route_status_codes(fleet):
    """404 for an unknown or consumed handoff, 400 for a bad ``skip_blocks``
    or body, 409 for a payload this replica cannot install, 411 for a
    chunked body, and the prepare/chains answers."""
    servers, eps, _ = fleet
    pre_ep, dec_ep = eps['prefill'], eps['decode']
    assert _http(pre_ep, '/v1/kv/fetch?handoff=nope')[0] == 404
    body = {'tokens': [_row(40, 12)], 'max_new_tokens': 6}
    exp = json.loads(_http(pre_ep, '/v1/kv/export', body)[2])
    assert exp['full_blocks'] == 2 and exp['block'] == 16
    assert _http(pre_ep, f'/v1/kv/fetch?handoff={exp["handoff"]}'
                 '&skip_blocks=3')[0] == 400
    # One-shot: consumed by the refused fetch.
    assert _http(pre_ep, f'/v1/kv/fetch?handoff={exp["handoff"]}')[0] \
        == 404
    for bad in ({'tokens': []}, {'tokens': [[1, 2], [3]]},
                {'tokens': [1, 2], 'max_new_tokens': 0},
                {'tokens': [10 ** 6]},
                {'tokens': _row(90), 'max_new_tokens': 10}):
        assert _http(pre_ep, '/v1/kv/export', bad)[0] == 400, bad
    assert _http(dec_ep, '/v1/kv/import', b'garbage',
                 {'Content-Type': 'application/octet-stream'})[0] == 400
    assert _http(dec_ep, '/v1/kv/import', {'staging_ref': 'x.kvh'})[0] \
        == 400  # no staging directory on this replica
    # A slot-layout payload is well formed but not installable here.
    slot = port_srv.LlmServer('tiny', max_len=MAX_LEN, role='prefill',
                              device='cpu')
    try:
        h = slot.engine.submit_prefill(_row(9), 4).result(timeout=300)
        data = pd.serialize_bytes(h, pd.build_header(
            h, model='tiny', kv_cache='bf16'))
    finally:
        slot.stop()
    for path in ('/v1/kv/import', '/v1/kv/import?stream=1'):
        status, _, raw = _http(dec_ep, path, data,
                               {'Content-Type': 'application/octet-stream'})
        assert status == 409, raw
    # A negotiated prefix the decode trie does not hold: the streamed
    # import fails at admission and answers 409 before any line.
    exp = json.loads(_http(pre_ep, '/v1/kv/export', body)[2])
    status, _, data = _http(pre_ep, f'/v1/kv/fetch?handoff='
                            f'{exp["handoff"]}&skip_blocks=2')
    assert status == 200
    errors = servers['decode'].engine.import_errors
    status, hdrs, raw = _http(dec_ep, '/v1/kv/import?stream=1', data,
                              {'Content-Type': 'application/octet-stream'})
    assert status == 409, raw
    assert 'evicted' in json.loads(raw)['error']
    assert hdrs['Content-Type'] == 'application/json'
    assert servers['decode'].engine.import_errors == errors + 1
    conn = http.client.HTTPConnection(*dec_ep.split(':'))
    conn.putrequest('POST', '/v1/kv/import')
    conn.putheader('Transfer-Encoding', 'chunked')
    conn.endheaders()
    conn.send(b'5\r\nhello\r\n0\r\n\r\n')
    assert conn.getresponse().status == 411
    conn.close()
    assert json.loads(_http(dec_ep, '/v1/kv/prepare',
                            {'tokens': [_row(5)]})[2]) == {'skip_blocks': 0}
    assert _http(dec_ep, '/v1/kv/prepare', {'tokens': ['x']})[0] == 400
    assert json.loads(_http(dec_ep, '/v1/kv/chains',
                            {'digests': ['00' * 16]})[2]) == {'chains': []}
    assert _http(dec_ep, '/v1/kv/chains', {'digests': ['zz']})[0] == 400
    assert _http(dec_ep, '/v1/kv/nope', {})[0] == 404


def test_qos_shed_export_is_429_and_the_lb_falls_back(monkeypatch):
    """QoS gates the export: with the tenant's request bucket empty the
    second export sheds 429 with Retry-After and no prefill runs; behind
    the load balancer that request is served colocated."""
    monkeypatch.setenv('SKYTPU_QOS_TENANT_RPS', '0.001')
    servers = {
        'prefill': port_srv.LlmServer('tiny', max_len=MAX_LEN,
                                      kv_layout='paged', role='prefill',
                                      qos='on', device='cpu'),
        'decode': port_srv.LlmServer('tiny', max_len=MAX_LEN,
                                     kv_layout='paged', role='decode',
                                     device='cpu')}
    eps, httpds = {}, []
    for role, s in servers.items():
        eps[role], httpd = _serve_port(s)
        httpds.append(httpd)
    lb = _lb(eps, 26300)
    try:
        pre = servers['prefill']
        body = {'tokens': [_row(9, 12)], 'max_new_tokens': 6}
        assert _http(eps['prefill'], '/v1/kv/export', body)[0] == 200
        assert pre.disagg_stats['exports'] == 1
        status, hdrs, raw = _http(eps['prefill'], '/v1/kv/export',
                                  {**body, 'tokens': [_row(9, 13)]})
        assert status == 429, raw
        assert hdrs.get('Retry-After')
        assert pre.disagg_stats['exports'] == 1
        assert pre.engine.prefills == 1
        assert pre.qos.stats()['shed_total'] == 1
        status, hdrs, via = _http(f'127.0.0.1:{lb.port}', '/generate',
                                  {**body, 'tokens': [_row(11, 14)]})
        assert status == 200, via
        assert lb.disagg_stats['fallbacks'] == 1
        assert hdrs.get('X-SkyTPU-Disagg') is None
        assert servers['decode'].disagg_stats['fallbacks_served'] \
            + pre.disagg_stats['fallbacks_served'] == 1
    finally:
        _close(servers.values(), httpds, lb)


def test_staging_directory_carries_the_payload(tmp_path, monkeypatch):
    monkeypatch.setenv(pd.STAGING_ENV, str(tmp_path))
    servers = {role: port_srv.LlmServer('tiny', max_len=MAX_LEN,
                                        kv_layout='paged', role=role,
                                        device='cpu')
               for role in ('prefill', 'decode')}
    eps, httpds = {}, []
    for role, s in servers.items():
        eps[role], httpd = _serve_port(s)
        httpds.append(httpd)
    lb = _lb(eps, 26500)
    try:
        for salt in (13, 14):
            body = {'tokens': [_row(26, salt)], 'max_new_tokens': 9}
            _, _, direct = _http(eps['decode'], '/generate', body)
            status, hdrs, via = _http(f'127.0.0.1:{lb.port}', '/generate',
                                      body)
            assert status == 200, via
            assert json.loads(via) == json.loads(direct)
            assert hdrs.get('X-SkyTPU-Disagg') == 'staged'
        h = json.loads(_http(eps['prefill'], '/health')[2])
        assert h['disagg']['staging'] is True
        assert h['disagg']['exports'] == 2
        assert len(list(tmp_path.glob('*' + pd.STAGING_SUFFIX))) == 2
        assert json.loads(_http(eps['decode'], '/health')[2])[
            'disagg']['imports'] == 2
    finally:
        _close(servers.values(), httpds, lb)


def _midstream_attempt(salt, port_base):
    servers = {role: port_srv.LlmServer('tiny', max_len=160,
                                        kv_layout='paged', role=role,
                                        device='cpu')
               for role in ('prefill', 'decode', 'colocated')}
    for s in servers.values():
        s.engine.chunk_steps = 1  # a line per token: a wide window
    eps, httpds = {}, []
    for role, s in servers.items():
        eps[role], httpd = _serve_port(s)
        httpds.append(httpd)
    lb = _lb(eps, port_base)
    try:
        body = {'tokens': [_row(19, salt)], 'max_new_tokens': 128}
        want = json.loads(_http(eps['colocated'], '/generate',
                                body)[2])['tokens'][0]
        req = urllib.request.Request(
            f'http://127.0.0.1:{lb.port}/generate',
            data=json.dumps(dict(body, stream=True)).encode(),
            headers={'Content-Type': 'application/json'}, method='POST')
        got, killed = [], False
        with urllib.request.urlopen(req, timeout=300) as r:
            for line in r:
                if not line.strip():
                    continue
                obj = json.loads(line)
                assert 'error' not in obj, obj
                if obj.get('done'):
                    break
                got.extend(obj.get('tokens') or [])
                if not killed and got:
                    servers['decode'].engine.stop()
                    killed = True
        assert killed
        return (got, want, lb.disagg_stats['resumed_streams'],
                servers['colocated'].disagg_stats['fallbacks_served'])
    finally:
        _close(servers.values(), httpds, lb)


def test_decode_replica_killed_midstream_is_resumed():
    """The decode replica's engine dies mid-stream: its in-band error
    line makes the load balancer resume on a survivor, skipping the
    tokens already sent; the client sees one whole, correct stream.
    Retried, as in JAX's test: the tiny model can finish all 128 tokens
    before the kill lands."""
    for attempt in range(3):
        got, want, resumed, fallbacks = _midstream_attempt(
            12 + attempt, 26700 + 200 * attempt)
        assert got == want
        if resumed:
            assert fallbacks == 1
            return
    raise AssertionError('decode finished before the kill in 3 attempts')


# -- a mixed fleet: float32 TINY, the same weights in both packages ----------

JAX_CFG = dataclasses.replace(jax_llama.TINY, dtype=jnp.float32)
PORT_CFG = dataclasses.replace(port_llama.TINY, dtype=torch.float32)


@pytest.mark.parametrize('prefill_pkg', ['jax', 'port'])
def test_mixed_fleet_hands_off_across_packages(prefill_pkg, monkeypatch):
    monkeypatch.setitem(jax_llama.PRESETS, 'tiny-f32', JAX_CFG)
    monkeypatch.setitem(port_llama.PRESETS, 'tiny-f32', PORT_CFG)
    jax_roles = ('prefill', 'colocated') if prefill_pkg == 'jax' \
        else ('decode', 'colocated')
    port_role = 'decode' if prefill_pkg == 'jax' else 'prefill'
    jservers = {role: jax_srv.LlmServer('tiny-f32', max_len=MAX_LEN,
                                        kv_layout='paged', role=role)
                for role in jax_roles}
    pserver = port_srv.LlmServer('tiny-f32', max_len=MAX_LEN,
                                 kv_layout='paged', role=port_role,
                                 device='cpu')
    weights = port_llama.params_from_numpy(
        jax.tree.map(np.asarray, jservers['colocated'].params), PORT_CFG,
        'cpu')
    pserver.params = pserver.engine.params = weights
    eps = {role: _serve_jax(s, 26900 + 20 * i)
           for i, (role, s) in enumerate(jservers.items())}
    eps[port_role], httpd = _serve_port(pserver)
    lb = _lb(eps, 27000)
    try:
        for n, max_new, salt in ((13, 12, 0), (33, 16, 1), (40, 8, 2)):
            body = {'tokens': [_row(n, salt)], 'max_new_tokens': max_new}
            _, _, direct = _http(eps['colocated'], '/generate', body)
            status, hdrs, via = _http(f'127.0.0.1:{lb.port}', '/generate',
                                      body)
            assert status == 200, via
            assert hdrs.get('X-SkyTPU-Disagg') == 'remote'
            assert json.loads(via) == json.loads(direct)
        assert lb.disagg_stats['handoffs'] == 3
        assert lb.disagg_stats['fallbacks'] == 0
        h = json.loads(_http(eps[port_role], '/health')[2])
        assert h['role'] == port_role
        counter = 'imports' if port_role == 'decode' else 'exports'
        assert h['disagg'][counter] == 3
    finally:
        lb.stop()
        httpd.shutdown()
        httpd.server_close()
        pserver.stop()
        for s in jservers.values():
            if s.engine is not None:
                s.engine.stop()


def test_role_flag_and_the_recorders_process_label(monkeypatch):
    """``--role`` parses into the replica (``SKYTPU_LLM_ROLE`` when it is
    absent), and the recorder's bundles carry ``llm_server:<role>``."""
    from skypilot_tpu_torch.observability import blackbox
    args = port_srv.build_parser().parse_args(
        ['--model', 'tiny', '--max-len', '64', '--role', 'decode'])
    assert args.role == 'decode'
    with pytest.raises(SystemExit):
        port_srv.build_parser().parse_args(['--role', 'router'])
    server = port_srv.server_from_args(args, device='cpu')
    try:
        assert server.role == server.engine.role == 'decode'
        assert blackbox._PROC == 'llm_server:decode'  # noqa: SLF001
        assert server.health()[1]['role'] == 'decode'
    finally:
        server.stop()
    monkeypatch.setenv('SKYTPU_LLM_ROLE', 'prefill')
    server = port_srv.LlmServer('tiny', max_len=64, device='cpu')
    try:
        assert server.role == server.engine.role == 'prefill'
    finally:
        server.stop()
    with pytest.raises(ValueError, match='role'):
        port_srv.LlmServer('tiny', max_len=64, role='router', device='cpu')
