"""The port's replica against the fleet's readers (TINY, on the CPU).

``sky serve``'s controller, autoscalers, SLO engine and metrics history
read a replica's ``/health``; Prometheus reads its ``/metrics``. These
tests put the same queued requests, QoS tickets and TTFTs into a JAX
replica and a port replica and run the JAX package's readers over both
bodies: ``controller._queue_pressure``, ``DualPoolAutoscaler
._queue_depth``, ``slo.replica_signal_fields`` and ``metrics_history
.sample_once``'s per-replica extraction read the same values (F1:
``queue.depth_total``; F2: no ``engine`` key without an engine). The
port's scrape has ``render_serving``'s families, types and label names.
Also the port's QoS paths over HTTP (429 with ``Retry-After``, 504 past
a TTL, 400), the scrape token, the warm-up (covered, the ``warming``
503, a failed warm-up failing the boot), the boot order of ``main()``,
and the ``compile_cache`` block."""
import asyncio
import concurrent.futures
import json
import threading
import time
import types
import urllib.error
import urllib.request

import pytest
import torch
from prometheus_client.parser import text_string_to_metric_families

from skypilot_tpu.serve import llm_server as jax_srv
from skypilot_tpu_torch.models import generate as port_gen
from skypilot_tpu_torch.observability import profiler as port_profiler
from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.serve import llm_server as port_srv
from skypilot_tpu_torch.serve import metrics as port_metrics
from skypilot_tpu_torch.serve import warmup as port_warmup

MAX_LEN = 64
# /health keys the JAX replica has and a later slice brings to the port
# (ROADMAP.md): none since tensor parallelism brought tp. The port adds
# its device and its collective backend.
LATER_SLICES = set()
PORT_ONLY = {'device', 'tp_backend'}
QOS_OPTS = dict(max_inflight=1, max_queue=8, sweep_s=0, tenant_rps=0,
                tenant_tps=0)


def _http(url, path, body=None, headers=None, timeout=120):
    """(status, headers, body bytes) of one request."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f'{url}{path}', data=data,
                                 headers=dict(headers or {}),
                                 method='GET' if body is None else 'POST')
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _serve(server):
    httpd = server.make_httpd('127.0.0.1', 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread, f'http://127.0.0.1:{httpd.server_address[1]}'


def _close(httpd, thread, server):
    httpd.shutdown()
    httpd.server_close()
    server.stop()
    thread.join(10)


def _queue_same_work(jserver, pserver):
    """Two window-path requests pending and one overflowing in each
    replica's batching FIFO, three QoS tickets (one granted, two queued)
    and the same five TTFTs."""
    marker = object()
    for server, put in ((jserver, jserver._queue.put_nowait),  # noqa: SLF001
                        (pserver, pserver._queue.put)):  # noqa: SLF001
        put(marker)
        put(marker)
        server._overflow.append(marker)  # noqa: SLF001
        server._ttft_window.extend([0.02, 0.5, 0.031, 0.7, 0.011])  # noqa: SLF001

    async def jax_tickets():
        return [jserver.qos.submit(c, 'a', est_tokens=4.0)
                for c in ('standard', 'batch', 'interactive')]
    asyncio.run(jax_tickets())
    for c in ('standard', 'batch', 'interactive'):
        pserver.qos.submit(c, 'a', est_tokens=4.0)


def _readers(body):
    """What each fleet reader takes from one /health body."""
    from skypilot_tpu.observability import slo
    from skypilot_tpu.serve import autoscalers, controller
    rep = {'health': json.dumps(body), 'endpoint': 'r'}
    return {'queue_pressure': controller._queue_pressure([rep]),  # noqa: SLF001
            'queue_depth': autoscalers.DualPoolAutoscaler._queue_depth(rep),  # noqa: SLF001
            'signals': slo.replica_signal_fields(body)}


def _sample(monkeypatch, tmp_path, bodies):
    """``metrics_history.sample_once`` over one service whose replicas
    report ``bodies``: its per-replica slices, keyed by replica id."""
    from skypilot_tpu.serve import serve_state
    from skypilot_tpu.server import metrics_history
    monkeypatch.setenv('SKYTPU_STATE_DIR', str(tmp_path))
    ready = types.SimpleNamespace(value='READY')
    monkeypatch.setattr(serve_state, 'list_services',
                        lambda: [{'name': 'svc', 'status': ready}])
    monkeypatch.setattr(serve_state, 'list_replicas', lambda name: [
        {'replica_id': i, 'status': ready, 'health': json.dumps(b)}
        for i, b in enumerate(bodies)])
    sample = metrics_history.sample_once(record=False)
    return [{key: sample[key].get(f'svc/{i}') for key in (
        'serve_replica_health', 'serve_tokens_by_replica',
        'serve_qos_by_replica')} for i in range(len(bodies))]


@pytest.mark.parametrize('engine', ['continuous', 'off'])
def test_fleet_readers_read_both_replicas_alike(engine, monkeypatch,
                                                tmp_path):
    monkeypatch.delenv('SKYTPU_COMPILE_CACHE', raising=False)
    jserver = jax_srv.LlmServer('tiny', max_len=MAX_LEN, engine=engine,
                                qos='on', qos_opts=dict(QOS_OPTS))
    pserver = port_srv.LlmServer('tiny', max_len=MAX_LEN, engine=engine,
                                 qos='on', qos_opts=dict(QOS_OPTS),
                                 device='cpu')
    try:
        _queue_same_work(jserver, pserver)
        jbody = jserver.health_snapshot()
        status, pbody = pserver.health()
        assert status == 200
        # F1: the same depth, window FIFO + overflow + QoS queue.
        assert pbody['queue'] == jbody['queue'] == {
            'pending': 2, 'overflow': 1, 'depth_total': 5}
        assert pbody['ttft_ms'] == jbody['ttft_ms']
        assert set(pbody) - PORT_ONLY == set(jbody) - LATER_SLICES
        assert pbody['role'] == jbody['role'] == 'colocated'
        assert pbody['disagg'] == jbody['disagg']
        # F2: no engine, no key (a string there made the readers raise).
        assert ('engine' in pbody) == ('engine' in jbody) == \
            (engine == 'continuous')
        assert _readers(pbody) == _readers(jbody)
        assert _readers(pbody)['queue_pressure'] == (5.0, {'r': 5.0})
        jslice, pslice = _sample(monkeypatch, tmp_path, [jbody, pbody])
        assert pslice == jslice
        assert pslice['serve_qos_by_replica']['depth'] == 2
        assert pslice['serve_replica_health']['ttft_p99_ms'] == 700.0
    finally:
        if jserver.engine is not None:
            jserver.engine.stop()
        pserver.stop()


def test_engine_off_body_breaks_no_reader(monkeypatch, tmp_path):
    """The body of a window-path replica without QoS, as the fleet
    meets it by default: every reader runs and reads zero pressure."""
    server = port_srv.LlmServer('tiny', max_len=MAX_LEN, engine='off',
                                device='cpu')
    try:
        status, body = server.generate({'tokens': [[3, 4, 5]],
                                        'max_new_tokens': 3})
        assert status == 200
        health = server.health()[1]
        assert 'engine' not in health and 'qos' not in health
        read = _readers(health)
        assert read['queue_pressure'] == (0.0, {'r': 0.0})
        assert read['signals']['queue_depth'] == 0.0
        assert read['signals']['ttft_p99_ms'] == health['ttft_ms']['p99']
        assert _sample(monkeypatch, tmp_path, [health])[0][
            'serve_replica_health'] == read['signals']
    finally:
        server.stop()


# -- /metrics ----------------------------------------------------------------


def _families(text):
    """{family: (type, label names over its samples)}."""
    return {f.name: (f.type, frozenset(k for s in f.samples
                                       for k in s.labels))
            for f in text_string_to_metric_families(text)}


def test_metrics_families_types_and_labels_equal_jax(monkeypatch):
    """The same engine, QoS and profiler state rendered by both: the
    same families, types and label names."""
    from skypilot_tpu.observability import blackbox
    from skypilot_tpu.observability import profiler as jax_profiler
    from skypilot_tpu.observability import trace as trace_lib
    from skypilot_tpu.server import metrics as jax_metrics
    server = port_srv.LlmServer('tiny', max_len=MAX_LEN, device='cpu',
                                kv_layout='paged', qos='on',
                                qos_opts=dict(QOS_OPTS))
    try:
        server.generate({'tokens': [list(range(1, 20))],
                         'max_new_tokens': 4})
        engine, qos = server.engine.stats(), server.qos.stats()
    finally:
        server.stop()
    assert isinstance(engine['kv_blocks'], dict)
    engine['kv_tiers'] = dict(engine['kv_tiers'] or {}, enabled=True)
    profile = {'enabled': True,
               'compile': {'engine.chunk': {'compiles': 2,
                                            'compile_ms': 40.0,
                                            'storms': 0}},
               'device_memory': {'bytes_in_use': 5, 'peak_bytes': 6,
                                 'bytes_limit': 9, 'headroom_bytes': 4,
                                 'unattributed_bytes': 1,
                                 'logical': {'weights': 4}},
               'cold_start': {'phases': {'imports': 1.5,
                                         'weights_load': 2.0}}}
    monkeypatch.setenv('SKYTPU_PROFILE', '1')
    for lib in (jax_profiler, port_profiler):
        monkeypatch.setattr(lib, 'snapshot', lambda: profile)
    from skypilot_tpu_torch.observability import blackbox as port_blackbox
    from skypilot_tpu_torch.observability import trace as port_trace
    for bb, tr in ((blackbox, trace_lib), (port_blackbox, port_trace)):
        monkeypatch.setattr(bb, 'dump_counts', lambda: {})
        monkeypatch.setattr(tr, 'tail_stats',
                            lambda: {'pending': 0, 'verdicts': {}})
    for observe in (jax_metrics.observe_serving,
                    port_metrics.observe_serving):
        observe('skytpu_serve_ttft_seconds', 0.2, qos_class='standard')
        observe('skytpu_serve_queue_wait_seconds', 0.01, qos_class='batch')
        observe('skytpu_serve_phase_seconds', 0.3, phase='decode',
                qos_class='standard')
        observe('skytpu_serve_decode_tok_s', 80.0, qos_class='standard')
    want = _families(jax_metrics.render_serving(engine=engine,
                                                qos=qos).decode())
    got = _families(port_metrics.render_serving(engine=engine,
                                                 qos=qos).decode())
    assert got == want
    # Without an engine or QoS: the zeroed and cleared series alike.
    assert _families(port_metrics.render_serving().decode()) == \
        _families(jax_metrics.render_serving().decode())
    assert set(port_metrics.FAMILY_NAMES) <= set(got)


def _disagg_samples(text):
    return {(s.name, tuple(sorted(s.labels.items()))): s.value
            for f in text_string_to_metric_families(text)
            if f.name.startswith('skytpu_disagg_') for s in f.samples}


def test_disagg_families_are_filled_as_jax_fills_them():
    """``render_serving(disagg=...)``: the skytpu_disagg_* samples (by
    direction, and the fallback total) JAX renders from the same
    counters; without counters, JAX's cleared families."""
    from skypilot_tpu.server import metrics as jax_metrics
    stats = {'exports': 3, 'export_bytes': 12345, 'export_seconds': 0.5,
             'imports': 2, 'import_bytes': 6789, 'import_seconds': 0.25,
             'import_rejects': 1, 'fallbacks_served': 4}
    want = _disagg_samples(jax_metrics.render_serving(
        disagg=stats).decode())
    got = _disagg_samples(port_metrics.render_serving(
        disagg=stats).decode())
    assert got == want
    assert got[('skytpu_disagg_handoff_bytes',
                (('direction', 'import'),))] == 6789
    assert got[('skytpu_disagg_fallback_total', ())] == 4
    assert _disagg_samples(port_metrics.render_serving().decode()) == \
        _disagg_samples(jax_metrics.render_serving().decode()) == {
            ('skytpu_disagg_fallback_total', ()): 0.0}


def _f32_presets(monkeypatch):
    """float32 TINY as 'tiny-f32' in both packages, so that one set of
    weights serves both replicas alike."""
    import dataclasses

    import jax.numpy as jnp
    from skypilot_tpu.models import llama as jax_llama
    from skypilot_tpu_torch.models import llama as port_llama
    monkeypatch.setitem(jax_llama.PRESETS, 'tiny-f32', dataclasses.replace(
        jax_llama.TINY, dtype=jnp.float32))
    cfg = dataclasses.replace(port_llama.TINY, dtype=torch.float32)
    monkeypatch.setitem(port_llama.PRESETS, 'tiny-f32', cfg)
    return cfg


def _handoff_traffic(pre, dec, rows):
    """Each row exported on ``pre``, fetched and imported on ``dec``
    (HTTP), then one corrupt import and one fallback-marked /generate."""
    for row in rows:
        exp = json.loads(_http(pre, '/v1/kv/export',
                               {'tokens': [row], 'max_new_tokens': 6},
                               {'Content-Type': 'application/json'})[2])
        status, _, data = _http(pre, f'/v1/kv/fetch?handoff='
                                f'{exp["handoff"]}', timeout=120)
        assert status == 200
        req = urllib.request.Request(
            f'{dec}/v1/kv/import', data=data, method='POST',
            headers={'Content-Type': 'application/octet-stream'})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
    req = urllib.request.Request(
        f'{dec}/v1/kv/import', data=b'SKYTPUKV1garbage', method='POST',
        headers={'Content-Type': 'application/octet-stream'})
    try:
        urllib.request.urlopen(req, timeout=120)
        raise AssertionError('a corrupt payload was accepted')
    except urllib.error.HTTPError as e:
        assert e.code == 400
    status, _, _ = _http(dec, '/generate',
                         {'tokens': [rows[0]], 'max_new_tokens': 3},
                         {'X-SkyTPU-Disagg-Fallback': '1'})
    assert status == 200


def _serve_jax(server):
    import asyncio

    from aiohttp import web

    from skypilot_tpu.utils import common_utils
    port = common_utils.find_free_port(27300)
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
    return f'http://127.0.0.1:{port}'


def test_role_and_disagg_equal_jax_after_the_same_traffic(monkeypatch):
    """A JAX prefill + decode pair and a port pair (float32 TINY, the same
    weights) take the same handoffs, a corrupt import and a fallback:
    /health's ``role`` and ``disagg`` agree but for the seconds and for
    the byte counts, which may differ by the width of the crc32s' decimal
    digits in each header (the planes' float32 sums differ in their last
    bits; at most 8 bytes a payload here). The dual-pool autoscaler and
    the controller's role map read both fleets alike."""
    import jax
    import numpy as np
    from skypilot_tpu.serve import autoscalers, service_spec
    from skypilot_tpu_torch.models import llama as port_llama
    cfg = _f32_presets(monkeypatch)
    monkeypatch.delenv('SKYTPU_DISAGG_STAGING', raising=False)
    jservers = {role: jax_srv.LlmServer('tiny-f32', max_len=MAX_LEN,
                                        kv_layout='paged', role=role)
                for role in ('prefill', 'decode')}
    weights = port_llama.params_from_numpy(
        jax.tree.map(np.asarray, jservers['prefill'].params), cfg, 'cpu')
    pservers = {role: port_srv.LlmServer('tiny-f32', max_len=MAX_LEN,
                                         kv_layout='paged', role=role,
                                         device='cpu')
                for role in ('prefill', 'decode')}
    for s in pservers.values():
        s.params = s.engine.params = weights
    jurls = {role: _serve_jax(s) for role, s in jservers.items()}
    served = {role: _serve(s) for role, s in pservers.items()}
    rows = [[(7 * i + 3 * k) % 250 + 1 for i in range(n)]
            for k, n in enumerate((13, 33, 40))]
    try:
        _handoff_traffic(jurls['prefill'], jurls['decode'], rows)
        _handoff_traffic(served['prefill'][2], served['decode'][2], rows)
        bodies = {}
        for role in ('prefill', 'decode'):
            jbody = json.loads(_http(jurls[role], '/health')[2])
            pbody = json.loads(_http(served[role][2], '/health')[2])
            bodies[role] = (jbody, pbody)
            assert pbody['role'] == jbody['role'] == role
            jd, pd = dict(jbody['disagg']), dict(pbody['disagg'])
            assert pd.keys() == jd.keys()
            for key in ('export_seconds', 'import_seconds'):
                assert (pd.pop(key) > 0) == (jd.pop(key) > 0), key
            for key in ('export_bytes', 'import_bytes'):
                assert abs(pd.pop(key) - jd.pop(key)) <= 8 * len(rows), key
            assert pd == jd
            eng_j = jbody['engine']['disagg']
            eng_p = pbody['engine']['disagg']
            assert {k: v for k, v in eng_p.items() if not k.endswith('_ms')} \
                == {k: v for k, v in eng_j.items() if not k.endswith('_ms')}
        assert bodies['decode'][1]['disagg']['imports'] == 3
        assert bodies['decode'][1]['disagg']['fallbacks_served'] == 1
        # The controller's role map and the dual-pool autoscaler.
        policy = service_spec.ReplicaPolicy.from_config(
            {'disagg': {'prefill': {'min_replicas': 1, 'max_replicas': 3},
                        'decode': {'min_replicas': 1, 'max_replicas': 4}},
             'target_queue_per_replica': 2,
             'target_decode_tok_s_per_replica': 100})
        decisions = []
        for which in (0, 1):
            reps = [{'replica_id': i, 'role': bodies[role][which]['role'],
                     'status': 'READY', 'endpoint': f'r{i}:80',
                     'weight': 1.0,
                     'health': json.dumps(bodies[role][which])}
                    for i, role in enumerate(('prefill', 'decode'))]
            assert {r['endpoint']: r.get('role') or 'colocated'
                    for r in reps} == {'r0:80': 'prefill',
                                       'r1:80': 'decode'}
            scaler = autoscalers.make_autoscaler(policy)
            pools = [
                [autoscalers.DualPoolAutoscaler._queue_depth(r)  # noqa: SLF001
                 for r in scaler._pool(reps, role)]  # noqa: SLF001
                for role in ('prefill', 'decode')]
            d1 = scaler.evaluate(2, 0, [], now=1000.0, replicas=reps)
            d2 = scaler.evaluate(2, 0, [], now=1010.0, replicas=reps)
            decisions.append((pools, (d1.num_prefill, d1.num_decode),
                              (d2.num_prefill, d2.num_decode)))
        assert decisions[0] == decisions[1]
    finally:
        for httpd, thread, _ in served.values():
            httpd.shutdown()
            httpd.server_close()
            thread.join(10)
        for s in pservers.values():
            s.stop()
        for s in jservers.values():
            if s.engine is not None:
                s.engine.stop()


def test_metrics_and_debug_profile_behind_the_scrape_token(monkeypatch):
    server = port_srv.LlmServer('tiny', max_len=MAX_LEN, device='cpu')
    httpd, thread, url = _serve(server)
    try:
        assert _http(url, '/generate', {'tokens': [[5, 6, 7]],
                                        'max_new_tokens': 3})[0] == 200
        monkeypatch.delenv('SKYTPU_METRICS_TOKEN', raising=False)
        status, headers, text = _http(url, '/metrics')
        assert status == 200
        assert headers['Content-Type'].startswith('text/plain')
        fams = _families(text.decode())
        assert set(port_metrics.FAMILY_NAMES) <= set(fams)
        ttft = next(f for f in text_string_to_metric_families(
            text.decode()) if f.name == 'skytpu_serve_ttft_seconds')
        assert any(s.name.endswith('_count') and s.value >= 1
                   for s in ttft.samples)
        monkeypatch.setenv('SKYTPU_METRICS_TOKEN', 's3cret')
        monkeypatch.setenv('SKYTPU_PROFILE', '1')
        for path in ('/metrics', '/debug/profile?programs=1'):
            assert _http(url, path)[0] == 401
            assert _http(url, path, headers={
                'Authorization': 'Bearer wrong'})[0] == 401
            assert _http(url, path, headers={
                'Authorization': 'Bearer s3cret'})[0] == 200
        body = json.loads(_http(url, '/debug/profile?programs=1', headers={
            'Authorization': 'Bearer s3cret'})[2])
        assert [p['name'] for p in body['programs']] == \
            [p.name for p in port_profiler.PROGRAMS]
        assert set(body['calls']) <= port_profiler.PROGRAM_NAMES
    finally:
        _close(httpd, thread, server)


def test_profile_program_names_are_jaxs(monkeypatch):
    """Both paths' programs reach /health under JAX's names:
    ``generate.prefill`` for every prefill, ``generate.decode_scan`` and
    ``engine.chunk``."""
    monkeypatch.setenv('SKYTPU_PROFILE', '1')
    server = port_srv.LlmServer('tiny', max_len=MAX_LEN, device='cpu')
    try:
        server.generate({'tokens': [[3, 4, 5]], 'max_new_tokens': 9})
        server.generate({'tokens': [[3, 4]], 'max_new_tokens': 4,
                         'temperature': 0.5, 'seed': 1})
        prof = server.health()[1]['profile']
    finally:
        server.stop()
    from skypilot_tpu.observability import profiler as jax_profiler
    used = {n for n, c in prof['calls'].items() if c}
    assert used <= jax_profiler.PROGRAM_NAMES
    assert {'generate.prefill', 'generate.decode_scan', 'engine.chunk',
            'engine.insert'} <= used
    assert prof['compile']['generate.prefill']['compiles'] >= 2


# -- QoS over HTTP -----------------------------------------------------------


class _StalledEngine:
    """An engine whose requests never finish."""
    slots = 4

    def submit(self, *args, **kwargs):
        return concurrent.futures.Future()

    def stats(self):
        return {'slots': self.slots, 'active_slots': 0, 'queued': 0}

    def prefix_summary(self):
        return None

    def busy(self):
        return False

    def stop(self):
        pass


def test_qos_429_with_retry_after_and_400():
    server = port_srv.LlmServer(
        'tiny', max_len=MAX_LEN, device='cpu', qos='on',
        qos_opts=dict(QOS_OPTS, max_inflight=4,
                      tenant_limits={'limited': (0.01, 0.0)}))
    httpd, thread, url = _serve(server)
    payload = {'tokens': [[1, 2, 3]], 'max_new_tokens': 4}
    hdrs = {'X-SkyTPU-Tenant': 'limited', 'Content-Type': 'application/json'}
    try:
        first = _http(url, '/generate', payload, hdrs)
        assert first[0] == 200
        # A burst of 1 refilled at 0.01/s: the second is refused.
        status, headers, body = _http(url, '/generate', payload, hdrs)
        assert status == 429, body
        assert 90 <= int(headers['Retry-After']) <= 100
        want = port_gen.generate(server.params, server.cfg,
                                 torch.tensor([[1, 2, 3]]), 4,
                                 max_len=MAX_LEN).tolist()
        assert json.loads(first[2])['tokens'] == want
        assert json.loads(body)['shed'] is True
        assert _http(url, '/generate', payload,
                     {'X-SkyTPU-Tenant': 'other'})[0] == 200
        status, _, body = _http(url, '/generate',
                                dict(payload, priority='urgent'))
        assert status == 400 and 'priority' in json.loads(body)['error']
        lines = _http(url, '/generate', dict(payload, stream=True),
                      {'X-SkyTPU-Tenant': 'streamer'})[2].splitlines()
        assert json.loads(lines[-1]) == {'done': True}
        health = json.loads(_http(url, '/health')[2])
        assert health['qos']['shed_total'] == 1
        assert health['qos']['classes']['standard']['shed'] == 1
        assert health['qos']['inflight'] == 0
        assert health['queue']['depth_total'] == 0
        # Each served request fed the TTFT window once; the shed none.
        assert health['ttft_ms']['count'] == 3
    finally:
        _close(httpd, thread, server)


def test_qos_504_past_the_ttl_under_a_stalled_engine():
    server = port_srv.LlmServer(
        'tiny', max_len=MAX_LEN, device='cpu', qos='on',
        qos_opts=dict(QOS_OPTS, sweep_s=0.05,
                      ttl_s={'interactive': 3.0, 'standard': 30.0,
                             'batch': 30.0}))
    server.engine.stop()
    server.engine = _StalledEngine()
    httpd, thread, url = _serve(server)
    payload = {'tokens': [[1, 2, 3]], 'max_new_tokens': 4}
    try:
        threading.Thread(target=_http, args=(url, '/generate', payload),
                         kwargs={'timeout': 30}, daemon=True).start()
        deadline = time.monotonic() + 10
        while json.loads(_http(url, '/health')[2])['qos']['inflight'] != 1:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        waiter = concurrent.futures.ThreadPoolExecutor(1).submit(
            _http, url, '/generate', dict(payload, priority='interactive'))
        while True:  # the waiter is queued: depth_total counts it
            health = json.loads(_http(url, '/health')[2])
            if health['queue']['depth_total'] == 1:
                break
            assert not waiter.done(), waiter.result()
            time.sleep(0.01)
        assert health['qos']['queue_depth_total'] == 1
        status, _, body = waiter.result(timeout=30)
        assert status == 504 and 'TTL' in json.loads(body)['error']
        health = json.loads(_http(url, '/health')[2])
        assert health['qos']['classes']['interactive']['evicted'] == 1
        assert health['queue']['depth_total'] == 0
    finally:
        server.draining = True
        _close(httpd, thread, server)


# -- warm-up, boot and the compile-cache block --------------------------------


@pytest.mark.parametrize('engine', ['continuous', 'off'])
def test_warmup_covers_the_cpu_replica(engine, monkeypatch):
    from skypilot_tpu.serve import warmup as jax_warmup
    monkeypatch.delenv('SKYTPU_PROFILE', raising=False)
    assert port_warmup.prompt_buckets(MAX_LEN) == \
        jax_warmup.prompt_buckets(MAX_LEN) == [16, 32]
    assert port_warmup.prompt_buckets(1024) == \
        jax_warmup.prompt_buckets(1024)
    assert port_warmup._row(32, 1, 2) == jax_warmup._row(32, 1, 2)  # noqa: SLF001
    assert port_warmup.skipped('x') == jax_warmup.skipped('x')
    server = port_srv.LlmServer('tiny', max_len=MAX_LEN, device='cpu',
                                engine=engine)
    try:
        report = port_warmup.run(server)
        assert report['ran'] and report['covered'], report
        assert 'error' not in report and report['rounds'] >= 2
        assert report['cache_entries'] > 0  # signatures met on round 1
        assert 'cache_canary' not in report  # no kernel-build cache here
        assert not server._ttft_window  # noqa: SLF001 -- no user request
    finally:
        server.stop()


def test_warming_503_and_the_boot_order(monkeypatch):
    """``main()`` with SKYTPU_WARMUP=1 (the HTTP server a stub): /health
    answers 503 'warming' during the warm-up; the ledger crosses imports,
    the backend init, weights_load and jit_warmup in that order; the
    first 200 marks ready."""
    seen = {}
    real_run = port_warmup.run

    def run(server):
        seen['during'] = server.health()
        return real_run(server)

    class _Httpd:
        def serve_forever(self):
            seen['after'] = seen['server'].health()

        def server_close(self):
            pass

    def make_httpd(server, host, port):
        seen['server'] = server
        return _Httpd()

    monkeypatch.setenv('SKYTPU_WARMUP', '1')
    monkeypatch.setenv('SKYTPU_PROFILE', '1')
    monkeypatch.setattr(port_warmup, 'run', run)
    monkeypatch.setattr(port_srv.LlmServer, 'make_httpd', make_httpd)
    monkeypatch.setattr(port_srv.signal, 'signal', lambda sig, fn: None)
    port_profiler.reset()
    try:
        port_srv.main(['--model', 'tiny', '--max-len', str(MAX_LEN)],
                      device='cpu')
    finally:
        phases = list(port_profiler.cold_start_ledger()['phases'])
        port_profiler.reset()
    assert seen['during'] == (503, {'status': 'warming', 'model': 'tiny'})
    status, body = seen['after']
    assert status == 200 and body['warmup']['covered']
    assert phases == ['imports', 'backend_init.plugin_discovery',
                      'backend_init.device_enumeration', 'weights_load',
                      'jit_warmup', 'ready']
    assert body['profile']['cold_start']['complete'] is True


def test_a_failed_warmup_fails_the_boot(monkeypatch):
    monkeypatch.setenv('SKYTPU_WARMUP', '1')
    monkeypatch.setattr(port_warmup, 'run', lambda server: {
        'ran': True, 'covered': False, 'error': 'RuntimeError: boom'})
    monkeypatch.setattr(port_srv.signal, 'signal', lambda sig, fn: None)
    with pytest.raises(RuntimeError, match='warm-up failed: .*boom'):
        port_srv.main(['--model', 'tiny', '--max-len', str(MAX_LEN)],
                      device='cpu')


def test_compile_cache_block(monkeypatch, tmp_path):
    from skypilot_tpu.models import engine as jax_engine
    monkeypatch.setattr(_build, '_CACHE_STATE', None)
    monkeypatch.delenv('SKYTPU_COMPILE_CACHE', raising=False)
    assert _build.compile_cache() == {'enabled': False}
    assert _build.build_dir() == _build.BUILD_DIR
    cache = tmp_path / 'kernels'
    monkeypatch.setenv('SKYTPU_COMPILE_CACHE', str(cache))
    monkeypatch.setattr(_build, '_CACHE_STATE', None)
    state = _build.compile_cache()
    assert state == {'enabled': True, 'dir': str(cache),
                     'entries_at_start': 0, 'warm': False}
    assert _build.build_dir() == cache and cache.is_dir()
    (cache / 'libdecode_attention-0123.so').write_bytes(b'')
    (cache / 'libdecode_attention-0123.log').write_text('')
    assert _build.compile_cache() is state  # read once per process
    monkeypatch.setattr(_build, '_CACHE_STATE', None)
    assert _build.compile_cache()['warm'] is True
    assert _build.compile_cache()['entries_at_start'] == 1
    # The keys the controller reads off JAX's block.
    assert set(state) == {'enabled', 'dir', 'entries_at_start', 'warm'}
    assert jax_engine.maybe_enable_compile_cache.__doc__.count("'warm'")
