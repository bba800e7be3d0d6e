"""The prefill and decode roles on a tensor-parallel replica of the port,
against the JAX package, on the CPU.

One gang of two gloo ranks (``test_torch_tp.run_gang``) runs every
port-side tp 2 engine and replica of this file (``serve/spmd.py``, float32
TINY weights carried over from JAX). An export gathers each rank's KV
heads to the head, which writes the skytpu-kv/1 payload with whole heads
(``serve/disagg.py``, JAX's wire format); an import is checked on the
head and each rank gets its heads of the planes from there when it
admits. So the payloads cross between a tp 2 replica, a tp 1 replica and
the JAX package in every direction, and the decoded tokens are JAX's
colocated ones.

The planes of a two-layer model on two ranks differ from one rank's in
the last bits (the second layer's input went through a sum over the
ranks, in another order); at one layer no such sum precedes them, and
the tp 2 payload equals the tp 1 payload byte for byte.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import engine as jax_engine
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.serve import disagg as jd
from skypilot_tpu_torch.models import engine as port_engine
from skypilot_tpu_torch.models import llama as port_llama
from skypilot_tpu_torch.serve import disagg as pd
from test_torch_tp import _numpy_tree, run_gang

MAX_LEN = 96
JAX_CFG = dataclasses.replace(jax_llama.TINY, dtype=jnp.float32)
PORT_CFG = dataclasses.replace(port_llama.TINY, dtype=torch.float32)
ONE_LAYER = dataclasses.replace(PORT_CFG, n_layers=1)
LAYOUTS = ('slot', 'paged')
PLANE_TOL = 1e-5


def _row(n, salt=0):
    return [(7 * i + 11 * salt) % 250 + 1 for i in range(n)]


# JAX's three (n, max_new, salt) cases (tests/test_serve_disagg.py).
CASES = [(_row(13, 0), 12), (_row(33, 1), 16), (_row(1, 2), 8)]

_BODY = '''
import dataclasses, json, threading, urllib.error, urllib.request
import numpy as np
from skypilot_tpu_torch.models import engine as engine_lib
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.serve import disagg as pd
from skypilot_tpu_torch.serve import llm_server, spmd

cfg = dataclasses.replace(llama.TINY, dtype=torch.float32)
full = llama.params_from_numpy(inputs['params'], cfg, 'cpu')

def run(role, layout, work, name, c=cfg, params=full, **kw):
    eng = spmd.SpmdEngine(params, c, slots=4, max_len=96, role=role,
                          kv_layout=layout, mesh=mesh, device='cpu', **kw)
    if rank == 0:
        out[name] = work(eng)
        eng.stop()
    else:
        eng.start()
        eng._thread.join()
    out[name + '_state'] = llm_server._rank_engine_state(eng)

def exports(rows, kv_cache='bf16'):
    def work(eng):
        got = []
        for row, n in rows:
            h = eng.submit_prefill(row, n).result(timeout=120)
            got.append(pd.serialize_bytes(h, pd.build_header(
                h, model='tiny', kv_cache=kv_cache)))
        return got
    return work

def imports(payloads):
    def work(eng):
        got = []
        for data in payloads:
            header, arrays = pd.parse(data)
            got.append(eng.submit_import(
                **pd.import_kwargs(header, arrays)).result(timeout=120))
        return got
    return work

for layout in ('slot', 'paged'):
    run('prefill', layout, exports(inputs['cases']), 'export_' + layout)
    if rank == 0:
        own = out['export_' + layout]
    run('decode', layout, imports(inputs['port1_' + layout]
                                  + inputs['jax_' + layout]
                                  + (own if rank == 0 else [])),
        'import_' + layout)
run('prefill', 'paged', exports(inputs['cases'], 'int8'), 'export_int8',
    kv_quantize=True)
one = dataclasses.replace(cfg, n_layers=1)
run('prefill', 'paged', exports(inputs['cases']), 'export_one', c=one,
    params=llama.params_from_numpy(inputs['one'], one, 'cpu'))

# The five /v1/kv/* routes of a 2-rank replica over HTTP.
server = llm_server.LlmServer('tiny', max_len=96, tp=2, role='decode',
                              kv_layout='paged', device='cpu')
if rank == 0:
    httpd = server.make_httpd('127.0.0.1', 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = 'http://127.0.0.1:%d' % httpd.server_address[1]

    def call(path, body, ctype='application/json', raw=False):
        req = urllib.request.Request(url + path, body,
                                     headers={'Content-Type': ctype})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                data = r.read()
                return r.status, (data if raw else json.loads(data))
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    row = inputs['cases'][1][0]
    http = {}
    body = json.dumps({'tokens': [row], 'max_new_tokens': 8}).encode()
    http['colocated'] = call('/generate', body)
    http['export'] = call('/v1/kv/export', body)
    hid = http['export'][1]['handoff']
    fetched = call('/v1/kv/fetch?handoff=' + hid, None, raw=True)
    http['fetch'] = fetched[0]
    http['fetch_again'] = call('/v1/kv/fetch?handoff=' + hid, None)[0]
    http['prepare'] = call('/v1/kv/prepare', body)
    http['import'] = call('/v1/kv/import', fetched[1],
                          'application/octet-stream')
    http['chains'] = call('/v1/kv/chains',
                          json.dumps({'digests': []}).encode())[0]
    http['export_empty'] = call('/v1/kv/export', b'{}')
    http['import_garbage'] = call('/v1/kv/import', b'not a payload',
                                  'application/octet-stream')[0]
    header, arrays = pd.parse(fetched[1])
    foreign = engine_lib.PrefillHandoff(
        row=row, first=1, max_new=8, temperature=0.0, top_k=0, top_p=1.0,
        eos=None, layout='paged', prompt_len=len(row), block=16,
        n_blocks=header['n_blocks'], k=arrays['k'], v=arrays['v'])
    http['import_foreign'] = call('/v1/kv/import', pd.serialize_bytes(
        foreign, pd.build_header(foreign, model='tiny-mh',
                                 kv_cache='bf16')),
        'application/octet-stream')[0]
    http['health'] = call('/health', None)[1]
    out['http'] = http
    httpd.shutdown()
    server.stop()
else:
    spmd.follower_main(server)
out['http_state'] = llm_server._rank_engine_state(server.engine)
'''


@pytest.fixture(scope='module')
def weights():
    jp = jax_llama.init_params(jax.random.PRNGKey(0), JAX_CFG)
    return jp, port_llama.params_from_numpy(
        jax.tree.map(np.asarray, jp), PORT_CFG, 'cpu')


def _port(params, role, layout, cfg=PORT_CFG, **kw):
    return port_engine.ContinuousEngine(params, cfg, slots=4,
                                        max_len=MAX_LEN, role=role,
                                        kv_layout=layout, device='cpu', **kw)


def _jax(params, role, layout):
    return jax_engine.ContinuousEngine(params, JAX_CFG, slots=4,
                                       max_len=MAX_LEN, role=role,
                                       kv_layout=layout)


def _export(pkg, eng, row, n, kv_cache='bf16'):
    h = eng.submit_prefill(row, n).result(timeout=300)
    return pkg.serialize_bytes(h, pkg.build_header(h, model='tiny',
                                                   kv_cache=kv_cache))


def _import(pkg, eng, data):
    header, arrays = pkg.parse(data)
    return list(eng.submit_import(**pkg.import_kwargs(header, arrays))
                .result(timeout=300))


def _one_layer(params):
    out = dict(params)
    out['layers'] = {k: v[:1] for k, v in params['layers'].items()}
    return out


@pytest.fixture(scope='module')
def world(tmp_path_factory, weights):
    """The references of this process (JAX's colocated tokens and
    payloads, the port's tp 1 payloads), then the gang."""
    jp, pp = weights
    ref = {}
    for layout in LAYOUTS:
        engines = [_jax(jp, 'colocated', layout), _jax(jp, 'prefill',
                                                       layout),
                   _port(pp, 'prefill', layout)]
        try:
            ref['want_' + layout] = [
                list(engines[0].submit(r, n).result(timeout=300))
                for r, n in CASES]
            ref['jax_' + layout] = [_export(jd, engines[1], r, n)
                                    for r, n in CASES]
            ref['port1_' + layout] = [_export(pd, engines[2], r, n)
                                      for r, n in CASES]
        finally:
            for e in engines:
                e.stop()
    one = _port(_one_layer(pp), 'prefill', 'paged', cfg=ONE_LAYER)
    try:
        ref['one'] = [_export(pd, one, r, n) for r, n in CASES]
    finally:
        one.stop()
    inputs = {'params': jax.tree.map(np.asarray, jp), 'cases': CASES,
              'one': _one_layer(_numpy_tree(jp))}
    inputs.update({k: v for k, v in ref.items()
                   if k.startswith(('jax_', 'port1_'))})
    outs = run_gang(tmp_path_factory.mktemp('tp_disagg'), 2, _BODY,
                    inputs=inputs)
    return ref, outs


@pytest.mark.parametrize('layout', LAYOUTS)
def test_tp2_prefill_hands_off_to_tp1_and_to_jax(world, weights, layout):
    """A tp 2 prefill replica's payloads decode on a tp 1 port replica and
    on JAX's decode engine to JAX's colocated tokens."""
    ref, outs = world
    jp, pp = weights
    payloads = outs[0]['export_' + layout]
    decoders = [_port(pp, 'decode', layout), _jax(jp, 'decode', layout)]
    try:
        for pkg, eng in zip((pd, jd), decoders):
            assert [_import(pkg, eng, d) for d in payloads] == \
                ref['want_' + layout]
    finally:
        for e in decoders:
            e.stop()
    assert outs[0]['export_' + layout + '_state'] == \
        outs[1]['export_' + layout + '_state']
    assert outs[0]['export_' + layout + '_state']['disagg'][0] == len(CASES)


@pytest.mark.parametrize('layout', LAYOUTS)
def test_tp1_jax_and_tp2_prefills_hand_off_to_tp2(world, layout):
    """A tp 2 decode replica installs payloads of a tp 1 port replica, of
    JAX's prefill engine and of a tp 2 replica (each rank its heads,
    scattered by the head): JAX's colocated tokens every time, both ranks
    counting the same imports."""
    ref, outs = world
    want = ref['want_' + layout]
    assert outs[0]['import_' + layout] == want * 3
    state = outs[0]['import_' + layout + '_state']
    assert state == outs[1]['import_' + layout + '_state']
    assert state['disagg'][1] == 3 * len(CASES)


@pytest.mark.parametrize('layout', LAYOUTS)
def test_tp2_payload_is_jaxs_format_with_whole_heads(world, layout):
    """The tp 2 payload parses in JAX's package: JAX's header fields and
    plane shapes (every KV head), planes within PLANE_TOL of the tp 1
    port's and of JAX's."""
    ref, outs = world
    for got, one, jx in zip(outs[0]['export_' + layout],
                            ref['port1_' + layout], ref['jax_' + layout]):
        h2, a2 = jd.parse(got)
        h1, a1 = jd.parse(one)
        hj, aj = jd.parse(jx)
        for key in ('row', 'first', 'layout', 'prompt_len', 'n_blocks',
                    'block', 'model', 'kv_cache'):
            assert h2.get(key) == h1.get(key) == hj.get(key), key
        for name in ('k', 'v'):
            assert a2[name].shape == a1[name].shape == aj[name].shape
            assert a2[name].shape[2] == JAX_CFG.n_kv_heads
            np.testing.assert_allclose(a2[name], a1[name], rtol=0,
                                       atol=PLANE_TOL)
            np.testing.assert_allclose(a2[name], aj[name], rtol=0,
                                       atol=PLANE_TOL)


def test_tp2_export_equals_tp1_byte_for_byte_at_one_layer(world):
    """At one layer no sum over the ranks precedes the planes: the tp 2
    payload, heads gathered in the head's order, is the tp 1 payload
    byte for byte."""
    ref, outs = world
    assert outs[0]['export_one'] == ref['one']


def test_int8_kv_tp2_export_carries_whole_scale_planes(world, weights):
    """int8 KV under tp 2: the codes and their scale planes are gathered
    alike, and the payload decodes on a tp 1 int8 replica to its own
    colocated tokens."""
    _, outs = world
    _, pp = weights
    colo = _port(pp, 'colocated', 'paged', kv_quantize=True)
    dec = _port(pp, 'decode', 'paged', kv_quantize=True)
    try:
        for data, (row, n) in zip(outs[0]['export_int8'], CASES):
            header, arrays = pd.parse(data)
            assert set(arrays) == {'k', 'v', 'k_s', 'v_s'}
            assert arrays['k_s'].shape == arrays['k'].shape[:-1]
            assert arrays['k_s'].shape[2] == JAX_CFG.n_kv_heads
            assert _import(pd, dec, data) == \
                colo.submit(row, n).result(timeout=300)
    finally:
        colo.stop()
        dec.stop()


def test_kv_routes_of_a_two_rank_replica(world):
    """``/v1/kv/export`` -> ``fetch`` (one-shot: 404 after) ->
    ``prepare`` -> ``import`` on a ``--tp 2`` replica: the handoff's
    tokens are the replica's own colocated answer; an empty export body
    and unusable bytes get 400, a payload of another model 409, as on
    one device. Both ranks count the import."""
    _, outs = world
    http = outs[0]['http']
    assert http['colocated'][0] == 200
    assert http['export'][0] == 200
    assert http['fetch'] == 200 and http['fetch_again'] == 404
    assert http['prepare'][0] == 200
    assert http['prepare'][1]['skip_blocks'] == 2  # committed by /generate
    assert http['import'] == (200, {'tokens': http['colocated'][1]['tokens']})
    assert http['chains'] == 200
    assert http['export_empty'] == (400, {'error': 'tokens required'})
    assert http['import_garbage'] == 400
    assert http['import_foreign'] == 409
    assert (http['health']['tp'], http['health']['role']) == (2, 'decode')
    assert http['health']['disagg']['imports'] == 1
    assert outs[0]['http_state'] == outs[1]['http_state']
