"""The port's replica on the CPU (TINY): HTTP round trips through the
default continuous engine and through the window path, NDJSON streaming,
request validation against the JAX replica's messages, /health, batching,
seeded determinism, drain, and the refusal of options not ported yet."""
import asyncio
import concurrent.futures
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from skypilot_tpu_torch.models import generate as port_gen
from skypilot_tpu_torch.models import llama as port_llama
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
    # A seeded stream would need the window path, which does not stream
    # (the JAX replica's 400).
    status, body = _post(url, {'tokens': [[1, 2]], 'stream': True,
                               'temperature': 0.5, 'seed': 3})
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
    assert body['engine']['slots'] == 16
    assert body['engine']['kv_layout'] == 'slot'
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
                                device='cpu', engine='off')
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


REFUSED = {  # name -> (LlmServer kwargs, env, exception, message)
    'kv_layout_typo': (dict(kv_layout='dense'), {}, ValueError, 'kv_layout'),
    # --draft-model is ported; JAX's refusals of a draft stay.
    'draft_unknown': (dict(draft_model='gpt-5-draft'), {}, ValueError,
                      'Unknown draft model'),
    'draft_short_context': (dict(max_len=512, draft_model='tiny-short',
                                 preset=('tiny-short', 128)), {},
                            ValueError, 'max_seq_len'),
    'engine_typo': (dict(engine='turbo'), {}, ValueError, 'Unknown engine'),
    'pipeline_typo': (dict(pipeline='maybe'), {}, ValueError,
                      'Unknown pipeline'),
    'kv_cache': (dict(kv_cache='fp8'), {}, ValueError, 'kv_cache'),
    'quantization': (dict(quantize='int4'), {}, ValueError, 'quantization'),
    'model': (dict(model='gpt-5'), {}, ValueError, 'Unknown model'),
    'prefix_share_typo': (dict(prefix_share='yes'), {}, ValueError,
                          'Unknown prefix_share'),
}
# Refused until ported; now the replica serves them. The paged layout
# with block sharing on (the JAX default there); an MoE model with its
# pipeline serial and its prefix pool off, as the JAX engine runs it.
ACCEPTED = {  # name -> (LlmServer kwargs, env)
    'paged': (dict(kv_layout='paged'), {}),
    'paged_env': ({}, {'SKYTPU_LLM_KV_LAYOUT': 'paged'}),
    'moe': (dict(model='moe-tiny', prefix_cache=8), {}),
}


@pytest.mark.parametrize('name', sorted(set(REFUSED) | set(ACCEPTED)))
def test_unported_engines_and_bad_knobs_are_refused(name, monkeypatch):
    if name in ACCEPTED:
        kwargs, env = ACCEPTED[name]
    else:
        kwargs, env, exc, message = REFUSED[name]
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    kwargs = dict(kwargs)
    model = kwargs.pop('model', 'tiny')
    preset = kwargs.pop('preset', None)
    if preset is not None:  # (name, max_seq_len): a TINY of that context
        monkeypatch.setitem(port_llama.PRESETS, preset[0],
                            dataclasses.replace(port_llama.TINY,
                                                max_seq_len=preset[1]))
    if name in REFUSED:
        with pytest.raises(exc, match=message):
            port_srv.LlmServer(model, device='cpu', **kwargs)
        return
    server = port_srv.LlmServer(model, max_len=MAX_LEN, device='cpu',
                                **kwargs)
    try:
        if model == 'moe-tiny':
            stats = server.health()[1]['engine']
            assert stats['pipeline']['pipeline_depth'] == 0
            assert stats['prefix_cache']['slots'] == 0
        else:
            assert server.engine.kv_layout == 'paged'
            assert server.engine.prefix_share
        status, body = server.generate({'tokens': [[4, 5, 6]],
                                        'max_new_tokens': 5})
        assert status == 200
        assert body['tokens'] == _solo(server, [[4, 5, 6]], 5)
    finally:
        server.stop()


def test_cli_refuses_an_unknown_engine():
    with pytest.raises(ValueError, match='Unknown engine'):
        port_srv.main(['--model', 'tiny', '--engine', 'continuous-ish'])


def test_cli_refuses_the_paged_layout(monkeypatch):
    """Refused until the paged layout was ported: ``main`` now builds a
    paged replica from ``--kv-layout paged --kv-blocks N --prefix-share
    off`` and serves (the HTTP server is a stub); without CUDA and
    without ``device`` it still refuses to start."""
    argv = ['--model', 'tiny', '--max-len', str(MAX_LEN), '--kv-layout',
            'paged', '--kv-blocks', '9', '--prefix-share', 'off', '--host',
            '127.0.0.1', '--port', '0']
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        port_srv.main(argv)
    calls = {}

    class _Httpd:
        def serve_forever(self):
            server = calls['server']
            calls['answer'] = server.generate({'tokens': [[7, 8]],
                                               'max_new_tokens': 3})

        def server_close(self):
            pass

    def make_httpd(server, host, port):
        calls['server'] = server
        return _Httpd()
    monkeypatch.setattr(port_srv.LlmServer, 'make_httpd', make_httpd)
    monkeypatch.setattr(port_srv.signal, 'signal', lambda sig, fn: None)
    port_srv.main(argv, device='cpu')
    engine = calls['server'].engine
    assert engine.kv_layout == 'paged' and engine.kv_blocks == 9
    assert not engine.prefix_share and engine._kv_tiers is None  # noqa: SLF001
    status, body = calls['answer']
    assert status == 200
    assert body['tokens'] == _solo(calls['server'], [[7, 8]], 3)


@pytest.mark.parametrize('argv, env', [
    (['--kv-layout', 'paged', '--kv-blocks', '17', '--prefix-share', 'on'],
     {}),
    (['--kv-layout', 'paged'], {'SKYTPU_LLM_KV_BLOCKS': '11',
                                'SKYTPU_LLM_PREFIX_SHARE': '0'}),
    ([], {'SKYTPU_LLM_KV_LAYOUT': 'paged', 'SKYTPU_KV_TIERS': '0'}),
], ids=['flags', 'env', 'layout_env'])
def test_paged_argv_builds_the_jax_replicas_engine(argv, env, monkeypatch):
    """``--kv-layout``, ``--kv-blocks`` and ``--prefix-share`` (and their
    environment fallbacks) parse in both replicas' argparse and build
    engines with the same paged options."""
    from skypilot_tpu.serve import llm_server as jax_srv
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    argv = ['--model', 'tiny', '--max-len', str(MAX_LEN)] + argv
    jserver = jax_srv.server_from_args(jax_srv.build_parser().parse_args(argv))
    pserver = port_srv.server_from_args(
        port_srv.build_parser().parse_args(argv), device='cpu')
    try:
        for attr in ('kv_layout', 'kv_blocks', 'kv_block', 'prefix_share',
                     'slots', 'max_len'):
            assert (getattr(pserver.engine, attr)
                    == getattr(jserver.engine, attr)), attr
        assert ((pserver.engine._kv_tiers is None)  # noqa: SLF001
                == (jserver.engine._kv_tiers is None))  # noqa: SLF001
    finally:
        jserver.engine.stop()
        pserver.stop()


def test_paged_replica_health_carries_the_prefix_summary():
    """Over HTTP: a repeated 24-token head hits the share trie, and
    /health carries the engine's block accounts and, at top level as in
    the JAX replica, the prefix advert naming the committed chain."""
    from skypilot_tpu.utils import prefix_affinity as jax_affinity
    server = port_srv.LlmServer('tiny', max_len=MAX_LEN, device='cpu',
                                kv_layout='paged')
    httpd, thread, url = _serve(server)
    try:
        head = list(range(1, 25))
        for tail in ([30, 31], [40, 41]):
            status, body = _post(url, {'tokens': [head + tail],
                                       'max_new_tokens': 4})
            assert status == 200 and len(body['tokens'][0]) == 4
        status, body = _get(url, '/health')
        assert status == 200
        eng = body['engine']
        assert eng['kv_layout'] == 'paged'
        assert eng['kv_blocks']['total'] == 16 * MAX_LEN // 16 + 1
        assert eng['prefix_share']['hits'] == 1
        assert eng['kv_tiers']['enabled']
        summary = body['prefix_summary']
        info = jax_affinity.parse_summary(summary)
        hashes = jax_affinity.chain_hashes(head, summary['block'], 8)
        assert jax_affinity.match_depth(hashes, info['hashes']) == 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()
        thread.join(10)


# The serve-llama recipe (examples/llm/serve-llama/serve.yaml) on TINY.
RECIPE_ARGV = ['--model', 'tiny', '--max-len', '64', '--quantize', 'int8',
               '--kv-cache', 'int8', '--prefix-cache', '8', '--pipeline',
               'off', '--kv-layout', 'slot']


@pytest.mark.parametrize('argv, env', [
    (RECIPE_ARGV, {}),
    (RECIPE_ARGV[:8], {'SKYTPU_LLM_PREFIX_CACHE': '5',
                       'SKYTPU_LLM_PREFILL_CHUNK': '32',
                       'SKYTPU_LLM_PIPELINE': '0'}),
], ids=['flags', 'env'])
def test_recipe_argv_builds_the_jax_replicas_engine(argv, env, monkeypatch):
    """The recipe's command line (with ``--model tiny``) parses in both
    replicas' argparse and builds an engine with the same options; the
    environment fills what the flags leave out, as in the JAX replica."""
    from skypilot_tpu.serve import llm_server as jax_srv
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    jserver = jax_srv.server_from_args(jax_srv.build_parser().parse_args(argv))
    pserver = port_srv.server_from_args(
        port_srv.build_parser().parse_args(argv), device='cpu')
    try:
        for attr in ('max_len', 'quantize', 'kv_cache'):
            assert getattr(pserver, attr) == getattr(jserver, attr), attr
        for attr in ('slots', 'max_len', 'chunk_steps', 'prefill_batch',
                     'kv_quantize', 'kv_layout', 'prefix_slots',
                     'prefill_chunk', 'pipeline_depth'):
            assert (getattr(pserver.engine, attr)
                    == getattr(jserver.engine, attr)), attr
        assert pserver.engine.prefix_slots == (8 if '--prefix-cache' in argv
                                               else 5)
        assert pserver.engine.pipeline_depth == 0
        assert pserver.engine._prefix_pool.k.dtype == torch.int8  # noqa: SLF001
        assert port_srv.quant_lib.is_quantized(pserver.params['lm_head'])
    finally:
        jserver.engine.stop()
        pserver.stop()


def test_recipe_argv_runs_through_main(monkeypatch):
    """``main`` with the recipe's command line builds the replica, binds
    the flags' host and port, installs the drain handlers and serves;
    the HTTP server is a stub whose ``serve_forever`` returns at once."""
    calls = {}

    class _Httpd:
        def serve_forever(self):
            calls['served'] = True

        def server_close(self):
            calls['closed'] = True

    def make_httpd(server, host, port):
        calls['server'], calls['bind'] = server, (host, port)
        return _Httpd()

    handlers = {}
    monkeypatch.setattr(port_srv.LlmServer, 'make_httpd', make_httpd)
    monkeypatch.setattr(port_srv.signal, 'signal',
                        lambda sig, fn: handlers.__setitem__(sig, fn))
    port_srv.main(RECIPE_ARGV + ['--host', '127.0.0.1', '--port', '0'],
                  device='cpu')
    assert calls['bind'] == ('127.0.0.1', 0)
    assert calls['served'] and calls['closed']
    assert set(handlers) == {port_srv.signal.SIGTERM, port_srv.signal.SIGINT}
    server = calls['server']
    assert server.engine.prefix_slots == 8
    assert server.engine.kv_quantize


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


# -- the continuous engine over HTTP ----------------------------------------------


def _post_stream(url, body, timeout=120):
    """(status, NDJSON lines) of one streamed request."""
    req = urllib.request.Request(
        f'{url}/generate', data=json.dumps(dict(body, stream=True)).encode(),
        headers={'Content-Type': 'application/json'}, method='POST')
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, [json.loads(line) for line in
                          r.read().decode().splitlines() if line.strip()]


def test_generate_goes_through_the_default_engine(replica):
    server, url = replica
    assert server.engine is not None
    before = server.engine.stats()['prefills']
    calls = len(server.generate_calls)
    rows = [[5, 6, 7, 8, 9], [3, 4], [11, 12, 13]]
    status, body = _post(url, {'tokens': rows, 'max_new_tokens': 6})
    assert status == 200
    assert body['tokens'] == [_solo(server, [r], 6)[0] for r in rows]
    assert server.engine.stats()['prefills'] == before + len(rows)
    assert len(server.generate_calls) == calls  # the window path idled
    # Sampled, unseeded: also the engine, ids in the vocabulary.
    status, body = _post(url, {'tokens': [[1, 2]], 'max_new_tokens': 5,
                               'temperature': 0.9, 'top_p': 0.8})
    assert status == 200 and len(body['tokens'][0]) == 5
    assert all(0 <= t < 256 for t in body['tokens'][0])
    assert server.engine.stats()['prefills'] == before + len(rows) + 1


def test_stream_lines_add_up_to_the_unstreamed_tokens(replica):
    _, url = replica
    body = {'tokens': [[5, 6, 7], [9, 10]], 'max_new_tokens': 20}
    status, want = _post(url, body)
    assert status == 200
    status, lines = _post_stream(url, body)
    assert status == 200
    assert lines[-1] == {'done': True}
    got = [[], []]
    for line in lines[:-1]:
        assert set(line) == {'row', 'tokens'}
        got[line['row']].extend(line['tokens'])
    assert got == want['tokens']
    assert len(lines) > 3  # one line per emission, not one per request
    # A stop id ends a streamed row early, inclusive.
    stop = want['tokens'][0][4]
    status, lines = _post_stream(url, dict(body, eos_token=stop))
    row0 = [t for ln in lines[:-1] if ln['row'] == 0 for t in ln['tokens']]
    assert row0 == want['tokens'][0][:want['tokens'][0].index(stop) + 1]
    assert lines[-1] == {'done': True}


def test_stream_reports_engine_failure_in_band(monkeypatch):
    server = port_srv.LlmServer('tiny', max_len=MAX_LEN, device='cpu')
    httpd, thread, url = _serve(server)
    try:
        def fail(*args, **kwargs):
            raise RuntimeError('device lost')
        monkeypatch.setattr(port_srv.engine_lib, '_chunk', fail)
        status, lines = _post_stream(url, {'tokens': [[1, 2, 3]],
                                           'max_new_tokens': 6})
        assert status == 200
        assert lines[-1] == {'error': 'device lost'}
        # At most the first token came before the failed chunk.
        assert len(lines) <= 2
        assert all(set(ln) == {'row', 'tokens'} for ln in lines[:-1])
        status, body = _post(url, {'tokens': [[1, 2, 3]],
                                   'max_new_tokens': 6})
        assert status == 500 and 'device lost' in body['error']
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()
        thread.join(10)


def test_seeded_requests_take_the_window_path(replica):
    server, url = replica
    prefills = server.engine.stats()['prefills']
    calls = len(server.generate_calls)
    body = {'tokens': [[7, 8, 9]], 'max_new_tokens': 4, 'temperature': 0.7,
            'seed': 11}
    status, out = _post(url, body)
    assert status == 200 and len(out['tokens'][0]) == 4
    assert len(server.generate_calls) == calls + 1
    assert server.engine.stats()['prefills'] == prefills


def test_health_engine_stats_are_a_subset_of_jax(replica, jax_replica):
    _, url = replica
    from skypilot_tpu.models import engine as jax_engine
    from skypilot_tpu.models import llama as jax_llama
    import jax
    jeng = jax_engine.ContinuousEngine(
        jax_llama.init_params(jax.random.PRNGKey(0), jax_llama.TINY),
        jax_llama.TINY, max_len=MAX_LEN)
    want = jeng.stats()
    status, body = _get(url, '/health')
    assert status == 200
    got = body['engine']
    assert set(got) <= set(want)
    assert set(got['pipeline']) <= set(want['pipeline'])
    assert got['slots'] == want['slots'] and got['kv_layout'] == 'slot'
    for key in ('prefix_cache', 'prefill_chunk', 'prefill_chunks',
                'prefilling', 'prefill_tokens_saved'):
        assert key in got, key
    assert set(got['prefix_cache']) == set(want['prefix_cache'])


def test_prefix_pool_over_http_shows_in_health():
    """A replica with ``prefix_cache=4``: the third sighting of a prompt
    hits the pool (in ``/health``) and answers what ``generate`` does."""
    server = port_srv.LlmServer('tiny', max_len=MAX_LEN, prefix_cache=4,
                                device='cpu')
    httpd, thread, url = _serve(server)
    try:
        row = list(range(1, 25))
        want = _solo(server, [row], 5)
        for _ in range(3):
            assert _post(url, {'tokens': [row], 'max_new_tokens': 5}) == \
                (200, {'tokens': want})
        engine = _get(url, '/health')[1]['engine']
        assert engine['prefix_cache'] == {'slots': 4, 'entries': 1,
                                          'hits': 1, 'hit_tokens': 16,
                                          'stores': 1}
        assert engine['prefill_tokens_saved'] == 16
        assert engine['prefill_tokens'] == 3 * 24 - 16
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()
        thread.join(10)


def test_engine_off_serves_the_window_path():
    server = port_srv.LlmServer('tiny', max_len=MAX_LEN, device='cpu',
                                engine='off')
    try:
        assert server.engine is None
        assert 'engine' not in server.health()[1]  # as in JAX
        status, body = server.generate({'tokens': [[4, 5, 6]],
                                        'max_new_tokens': 5})
        assert status == 200 and list(server.generate_calls) == [(1, 5)]
        assert body['tokens'] == _solo(server, [[4, 5, 6]], 5)
        status, body = server.generate({'tokens': [[4, 5]], 'stream': True},
                                       write=lambda line: None)
        assert status == 400 and 'continuous engine' in body['error']
    finally:
        server.stop()


def test_drain_waits_for_the_engine_slots():
    server = port_srv.LlmServer('tiny', max_len=MAX_LEN, device='cpu')
    httpd, thread, url = _serve(server)
    try:
        fut = server.engine.submit([1, 2, 3], 40)  # no handler waits on it
        server.drain(httpd, timeout_s=60)
        thread.join(60)
        assert not thread.is_alive()
        assert fut.done() and len(fut.result()) == 40
    finally:
        httpd.server_close()
        server.stop()


def test_health_carries_the_profile_when_profiling(replica, monkeypatch):
    _, url = replica
    monkeypatch.setenv('SKYTPU_PROFILE', '0')
    assert 'profile' not in _get(url, '/health')[1]
    monkeypatch.setenv('SKYTPU_PROFILE', '1')
    assert _post(url, {'tokens': [[3, 4, 5]], 'max_new_tokens': 9})[0] == 200
    prof = _get(url, '/health')[1]['profile']
    assert prof['enabled'] is True
    assert prof['calls']['engine.chunk'] >= 1
    assert prof['compile']['generate.prefill']['shapes']  # first calls timed
    mem = prof['device_memory']
    assert mem['logical']['kv_cache'] > 0 and 'bytes_in_use' not in mem
