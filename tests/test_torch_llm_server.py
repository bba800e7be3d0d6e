"""The port's window-path replica on the CPU (TINY): HTTP round trips,
request validation against the JAX replica's messages, /health, batching,
seeded determinism, drain, and the refusal of unported engines."""
import asyncio
import concurrent.futures
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from skypilot_tpu_torch.models import generate as port_gen
from skypilot_tpu_torch.serve import llm_server as port_srv

MAX_LEN = 64


def _post(url, body, timeout=120):
    req = urllib.request.Request(
        f'{url}/generate', data=json.dumps(body).encode(),
        headers={'Content-Type': 'application/json'}, method='POST')
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, path, timeout=30):
    try:
        with urllib.request.urlopen(f'{url}{path}', timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _serve(server):
    httpd = server.make_httpd('127.0.0.1', 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread, f'http://127.0.0.1:{httpd.server_address[1]}'


@pytest.fixture(scope='module')
def replica():
    server = port_srv.LlmServer('tiny', max_len=MAX_LEN, device='cpu')
    httpd, thread, url = _serve(server)
    yield server, url
    httpd.shutdown()
    httpd.server_close()
    server.stop()
    thread.join(10)


def _solo(server, rows, max_new, **kw):
    tokens, lens = port_gen.pad_prompts(rows, device='cpu')
    return port_gen.generate(server.params, server.cfg, tokens, max_new,
                             max_len=server.max_len, prompt_lengths=lens,
                             **kw).tolist()


def test_generate_over_http_equals_port_generate(replica):
    server, url = replica
    rows = [[5, 6, 7, 8, 9], [3, 4]]
    status, body = _post(url, {'tokens': rows, 'max_new_tokens': 6})
    assert status == 200
    assert body['tokens'] == _solo(server, rows, 6)
    # A single flat row is accepted as one row.
    status, body = _post(url, {'tokens': [3, 4], 'max_new_tokens': 6})
    assert status == 200 and body['tokens'] == [_solo(server, rows, 6)[1]]


def test_eos_truncates_inclusive(replica):
    server, url = replica
    full = _solo(server, [[1, 2, 3]], 8)[0]
    stop = full[3]
    status, body = _post(url, {'tokens': [[1, 2, 3]], 'max_new_tokens': 8,
                               'eos_token': [stop]})
    assert status == 200
    assert body['tokens'] == [full[:full.index(stop) + 1]]


class _FakeRequest:
    """Just enough of an aiohttp request for the JAX validation path."""

    def __init__(self, body):
        self._body = body
        self.headers = {}

    async def json(self):
        return self._body


@pytest.fixture(scope='module')
def jax_replica():
    from skypilot_tpu.serve import llm_server as jax_srv
    return jax_srv.LlmServer('tiny', max_len=MAX_LEN, engine='off')


BAD_REQUESTS = {
    'no_tokens': {'max_new_tokens': 3},
    'empty_tokens': {'tokens': []},
    'max_new_not_numeric': {'tokens': [[1]], 'max_new_tokens': 'x'},
    'top_p_not_numeric': {'tokens': [[1]], 'top_p': [0.5]},
    'max_new_zero': {'tokens': [[1]], 'max_new_tokens': 0},
    'top_k_negative': {'tokens': [[1]], 'top_k': -1},
    'top_p_zero': {'tokens': [[1]], 'top_p': 0.0},
    'top_p_above_one': {'tokens': [[1]], 'top_p': 1.5},
    'eos_bool': {'tokens': [[1]], 'eos_token': True},
    'eos_strings': {'tokens': [[1]], 'eos_token': ['a']},
    'tokens_not_ints': {'tokens': [['a', 'b']]},
    'tokens_string': {'tokens': 'abc'},
    'empty_row': {'tokens': [[1, 2], []]},
    'too_long': {'tokens': [list(range(60))], 'max_new_tokens': 5},
}


@pytest.mark.parametrize('name', sorted(BAD_REQUESTS))
def test_bad_requests_get_the_jax_400s(replica, jax_replica, name):
    body = BAD_REQUESTS[name]
    _, url = replica
    resp = asyncio.run(jax_replica._generate_inner(  # noqa: SLF001
        _FakeRequest(body)))
    assert resp.status == 400
    status, got = _post(url, body)
    assert status == 400
    assert got == json.loads(resp.body)


def test_port_only_refusals(replica):
    _, url = replica
    status, body = _post(url, {'tokens': [[1, 2]], 'stream': True})
    assert status == 400 and 'continuous engine' in body['error']
    status, body = _post(url, {'tokens': [[1, 256]]})
    assert status == 400 and 'token ids' in body['error']
    status, body = _post(url, [1, 2])
    assert status == 400 and 'JSON object' in body['error']
    status, _ = _get(url, '/nope')
    assert status == 404


def test_health_fields(replica):
    server, url = replica
    status, body = _get(url, '/health')
    assert status == 200
    assert body['status'] == 'ok'
    assert body['model'] == 'tiny'
    assert body['device'] == 'cpu'
    assert body['engine'] == 'off'
    assert body['kv_cache'] == 'bf16' and body['max_len'] == MAX_LEN
    assert isinstance(body['batches_served'], int)
    assert isinstance(body['max_batch_seen'], int)
    assert body['batches_served'] == server.batches_served


def test_seeded_sampling_is_deterministic(replica):
    _, url = replica
    body = {'tokens': [[7, 8, 9]], 'max_new_tokens': 6, 'temperature': 0.9,
            'seed': 123, 'top_k': 20}
    first = _post(url, body)
    assert first[0] == 200
    assert _post(url, body) == first
    assert all(0 <= t < 256 for t in first[1]['tokens'][0])


def test_concurrent_requests_share_a_batch(monkeypatch):
    monkeypatch.setattr(port_srv, 'BATCH_WINDOW_S', 0.5)
    server = port_srv.LlmServer('tiny', max_len=MAX_LEN, seed=1,
                                device='cpu')
    httpd, thread, url = _serve(server)
    try:
        rows = [[1, 2, 3], [4, 5, 6, 7, 8], [9]]
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            outs = list(pool.map(
                lambda r: _post(url, {'tokens': [r], 'max_new_tokens': 4}),
                rows))
        for r, (status, body) in zip(rows, outs):
            assert status == 200
            # Padded into one batch; compared against the same batch run
            # directly (bf16 sums may differ with the batch shape).
            assert body['tokens'][0] == _solo(server, rows, 4)[rows.index(r)]
        assert server.max_batch_seen == 3
        assert list(server.generate_calls) == [(3, 4)]
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()
        thread.join(10)


def test_split_fitting_respects_max_len():
    server = port_srv.LlmServer.__new__(port_srv.LlmServer)
    server.max_len = 20
    mk = port_srv._Pending  # noqa: SLF001
    group = [mk([[1] * 15], 2, 0.0, None), mk([[1] * 3], 10, 0.0, None),
             mk([[1] * 5], 4, 0.0, None)]
    subs = server._split_fitting(group)  # noqa: SLF001
    assert [len(s) for s in subs] == [1, 2]
    seeded = mk([[1]], 2, 0.5, 7)
    assert seeded.group_key != mk([[1]], 2, 0.5, 7).group_key
    assert group[0].group_key == group[1].group_key


def test_drain_turns_health_503_then_shuts_down():
    server = port_srv.LlmServer('tiny', max_len=MAX_LEN, device='cpu')
    httpd, thread, url = _serve(server)
    try:
        assert _post(url, {'tokens': [[1, 2]], 'max_new_tokens': 2})[0] == 200
        server.draining = True
        status, body = _get(url, '/health')
        assert status == 503 and body['status'] == 'draining'
        # Draining still accepts work (the LB may route here until its
        # next probe).
        assert _post(url, {'tokens': [[1, 2]], 'max_new_tokens': 2})[0] == 200
        server.drain(httpd, timeout_s=10)
        thread.join(15)
        assert not thread.is_alive()
    finally:
        httpd.server_close()
        server.stop()


def test_unported_engines_and_bad_knobs_are_refused():
    with pytest.raises(ValueError, match='later slice'):
        port_srv.LlmServer('tiny', engine='continuous', device='cpu')
    with pytest.raises(ValueError, match='later slice'):
        port_srv.main(['--model', 'tiny', '--engine', 'continuous'])
    with pytest.raises(ValueError, match='kv_cache'):
        port_srv.LlmServer('tiny', kv_cache='fp8', device='cpu')
    with pytest.raises(ValueError, match='quantization'):
        port_srv.LlmServer('tiny', quantize='int4', device='cpu')
    with pytest.raises(ValueError, match='Unknown model'):
        port_srv.LlmServer('gpt-5', device='cpu')
    with pytest.raises(NotImplementedError):
        port_srv.LlmServer('moe-tiny', device='cpu')


def test_int8_replica_serves():
    server = port_srv.LlmServer('tiny', max_len=MAX_LEN, quantize='int8',
                                kv_cache='int8', device='cpu')
    status, body = server.generate({'tokens': [[4, 5, 6]],
                                    'max_new_tokens': 5})
    server.stop()
    assert status == 200
    assert body['tokens'] == _solo(server, [[4, 5, 6]], 5, kv_quantize=True)
    assert np.asarray(body['tokens']).shape == (1, 5)
    assert isinstance(server.params['lm_head'], dict)
    assert server.params['lm_head']['q8'].dtype == torch.int8
