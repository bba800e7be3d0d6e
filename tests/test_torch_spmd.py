"""The port's multi-rank replica (``serve/spmd.py``, ``llm_server --tp``)
on the CPU: real OS processes joined by gloo over loopback, as the gang
launcher's env contract wires hosts (JAX ``tests/test_serve_spmd.py``).

Rank 0 serves the replica's HTTP surface; the other ranks run the
lockstep follower. Its answers must equal the same sharded program run
through the engine API in a gang of the test's own (the port's
counterpart of JAX's single-process oracle). Every process has a hard
timeout and its process group is killed at the end.
"""
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest
import torch

from skypilot_tpu.serve import spmd as jax_spmd
from skypilot_tpu_torch.serve import llm_server as port_srv
from skypilot_tpu_torch.serve import spmd as port_spmd
from test_torch_tp import REPO, run_gang

UP_S = 120          # spawn to a healthy head
EXIT_S = 30         # SIGTERM to every rank's exit
LOST_S = 20         # a follower's death to the head's exit (stated limit)
ROWS = [([5, 6, 7, 8], 6), ([9, 10, 11], 6), ([21, 22, 23, 24, 25], 5)]
ENV = {'SKYTPU_LLM_SLOTS': '2', 'SKYTPU_LLM_CHUNK_STEPS': '4'}
ARGV = ['--model', 'tiny-mh', '--max-len', '64', '--tp', '2',
        '--device', 'cpu', '--host', '127.0.0.1']
SEEDED_ERROR = ('seeded sampling is unavailable with '
                'SKYTPU_DECODE_KERNEL=pallas on a --tp > 1 replica')


@pytest.mark.parametrize('env,want', [
    ({}, None),
    ({'JAX_COORDINATOR_ADDRESS': '10.0.0.1:1234', 'JAX_NUM_PROCESSES': '4',
      'JAX_PROCESS_ID': '2'}, ('10.0.0.1:1234', 4, 2)),
    ({'JAX_COORDINATOR_ADDRESS': '10.0.0.1:1234',
      'JAX_NUM_PROCESSES': '1'}, None),
    ({'JAX_NUM_PROCESSES': '2', 'JAX_PROCESS_ID': '1'}, None)])
def test_distributed_env_contract(monkeypatch, env, want):
    """JAX test_serve_spmd.py:141: the gang launcher's env, read alike."""
    for name in ('JAX_COORDINATOR_ADDRESS', 'JAX_NUM_PROCESSES',
                 'JAX_PROCESS_ID'):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert port_spmd.distributed_env() == jax_spmd.distributed_env() == want


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _launch(tmp_path, name, argv, env):
    log = open(tmp_path / f'{name}.log', 'wb')
    proc = subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.serve.spmd', *argv],
        cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES='', **ENV, **env),
        start_new_session=True)
    proc.log_file = log
    return proc


def _get(url, path, timeout=10):
    with urllib.request.urlopen(url + path, timeout=timeout) as r:
        return json.loads(r.read())


def _post(url, body, timeout=120):
    req = urllib.request.Request(url + '/generate', json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wait_up(url, procs, tmp_path):
    deadline = time.monotonic() + UP_S
    while time.monotonic() < deadline:
        for name, proc in procs.items():
            if proc.poll() is not None:
                raise AssertionError(f'{name} died ({proc.returncode}): '
                                     + _tail(tmp_path, name))
        try:
            if _get(url, '/health', timeout=2)['status'] == 'ok':
                return
        except (OSError, ValueError):
            pass
        time.sleep(0.5)
    raise AssertionError('head never became healthy: '
                         + _tail(tmp_path, 'rank0'))


def _tail(tmp_path, name):
    return (tmp_path / f'{name}.log').read_text(errors='replace')[-3000:]


def _summaries(tmp_path, name):
    """The ``tp-rank-summary`` lines in ``name``'s log."""
    return [json.loads(m) for m in re.findall(
        r'tp-rank-summary (\{[^{}]*\})', _tail(tmp_path, name))]


def _summary_ranks(tmp_path, name):
    """The ranks whose ``tp-rank-summary`` line is in ``name``'s log."""
    return [s['rank'] for s in _summaries(tmp_path, name)]


def _reap(procs):
    for proc in procs.values():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        proc.log_file.close()


def _hosts(tmp_path, http_port):
    """Two host processes of one rank each under the gang launcher's env."""
    coord = f'127.0.0.1:{_free_port()}'
    return {f'rank{r}': _launch(
        tmp_path, f'rank{r}', ARGV + ['--port', str(http_port)],
        {'JAX_COORDINATOR_ADDRESS': coord, 'JAX_NUM_PROCESSES': '2',
         'JAX_PROCESS_ID': str(r)}) for r in range(2)}


_ORACLE_BODY = '''
from skypilot_tpu_torch.serve import llm_server, spmd
server = llm_server.LlmServer('tiny-mh', max_len=64, tp=2, device='cpu')
if rank == 0:
    out['answers'] = [server.engine.submit(row, n).result(timeout=120)
                      for row, n in inputs['rows']]
    server.stop()
else:
    spmd.follower_main(server)
'''


def test_two_process_replica_answers_like_the_sharded_oracle(tmp_path):
    """JAX test_serve_spmd.py:74: ``python -m skypilot_tpu_torch.serve.spmd``
    as two hosts over loopback answers over HTTP what the same sharded
    program answers through the engine API; seeded requests get JAX's
    400; SIGTERM drains the head and every rank exits 0."""
    (tmp_path / 'oracle').mkdir()
    want = run_gang(tmp_path / 'oracle', 2, _ORACLE_BODY,
                    inputs={'rows': ROWS}, env=ENV)[0]['answers']
    port = _free_port()
    url = f'http://127.0.0.1:{port}'
    procs = _hosts(tmp_path, port)
    try:
        _wait_up(url, procs, tmp_path)
        # One row per POST, awaited: each prefill is a group of one on
        # both sides, the same program sequence as the oracle's.
        for (row, n), expect in zip(ROWS, want):
            status, body = _post(url, {'tokens': [row], 'max_new_tokens': n})
            assert status == 200, body
            assert body['tokens'][0] == expect, row
        status, body = _post(url, {'tokens': [[5, 6]], 'max_new_tokens': 3,
                                   'temperature': 0.8, 'seed': 7})
        assert (status, body['error']) == (400, SEEDED_ERROR)
        # Sampled without a seed: the ranks draw from the same logits
        # with the same generator (their digests, below).
        status, body = _post(url, {'tokens': [[3, 4, 5]],
                                   'max_new_tokens': 6, 'temperature': 0.9,
                                   'top_p': 0.9})
        assert status == 200 and len(body['tokens'][0]) == 6, body
        # The handoff's admissions would bypass the arrival broadcast.
        for route in ('/v1/kv/export', '/v1/kv/import'):
            req = urllib.request.Request(url + route, b'{}')
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req, timeout=30)
            assert err.value.code == 400
            assert json.loads(err.value.read())['error'] == \
                port_srv.TP_HANDOFF_ERROR
        health = _get(url, '/health')
        assert (health['tp'], health['tp_backend']) == (2, 'gloo')
        assert health['engine']['tokens_emitted'] >= 16
        procs['rank0'].send_signal(signal.SIGTERM)
        for name, proc in procs.items():
            assert proc.wait(EXIT_S) == 0, _tail(tmp_path, name)
    finally:
        _reap(procs)
    summaries = sorted((s for name in procs
                        for s in _summaries(tmp_path, name)),
                       key=lambda s: s['rank'])
    assert [s['rank'] for s in summaries] == [0, 1]
    # Every token either rank sampled, free slots' included, agrees.
    assert summaries[0]['sampled_digest'] == summaries[1]['sampled_digest']
    assert summaries[0]['sampled_digest'] != 0


def test_stop_before_the_first_request_does_not_hang(tmp_path):
    """``--tp 2`` on one host: rank 0 starts its follower itself; SIGTERM
    before any request reaches the follower by the stop broadcast, and
    both ranks exit 0."""
    port = _free_port()
    url = f'http://127.0.0.1:{port}'
    procs = {'rank0': _launch(tmp_path, 'rank0',
                              ARGV + ['--port', str(port)], {})}
    try:
        _wait_up(url, procs, tmp_path)
        procs['rank0'].send_signal(signal.SIGTERM)
        assert procs['rank0'].wait(EXIT_S) == 0, _tail(tmp_path, 'rank0')
    finally:
        _reap(procs)
    assert sorted(_summary_ranks(tmp_path, 'rank0')) == [0, 1]


def _children(pid):
    with open(f'/proc/{pid}/task/{pid}/children', encoding='utf-8') as f:
        return [int(p) for p in f.read().split()]


@pytest.mark.parametrize('layout', ['hosts', 'local'])
def test_killed_follower_ends_the_head_within_its_limit(tmp_path, layout):
    """A follower killed mid-service makes the head fail its waiters and
    exit non-zero within LOST_S, never hang (two host processes: the
    next collective fails; one host: the head also watches the follower
    it spawned)."""
    port = _free_port()
    url = f'http://127.0.0.1:{port}'
    if layout == 'hosts':
        procs = _hosts(tmp_path, port)
    else:
        procs = {'rank0': _launch(tmp_path, 'rank0',
                                  ARGV + ['--port', str(port)], {})}
    try:
        _wait_up(url, procs, tmp_path)
        assert _post(url, {'tokens': [[5, 6, 7]],
                           'max_new_tokens': 4})[0] == 200
        victim = (procs['rank1'].pid if layout == 'hosts'
                  else _children(procs['rank0'].pid)[0])
        t0 = time.monotonic()
        os.kill(victim, signal.SIGKILL)
        code = procs['rank0'].wait(LOST_S)
        assert code != 0
        assert time.monotonic() - t0 < LOST_S
    finally:
        _reap(procs)


def test_engine_off_with_tp_is_refused_in_jaxs_words():
    """JAX llm_server.py:350: the window path cannot shard the decode
    kernel, so ``--engine off --tp 2`` is refused before anything starts
    (no rank is spawned, no weight is built)."""
    want = ('SKYTPU_DECODE_KERNEL=pallas with --tp > 1 requires the '
            'continuous engine (the window path cannot shard the kernel)')
    with pytest.raises(ValueError) as err:
        port_srv.LlmServer('tiny', tp=2, engine='off', device='cpu')
    assert str(err.value) == want
    with pytest.raises(ValueError) as err:
        port_srv.main(['--model', 'tiny', '--engine', 'off', '--tp', '2',
                       '--device', 'cpu'])
    assert str(err.value) == want


def test_mesh_refusals_name_what_is_not_ported():
    """Paged, draft, MoE and the roles under a mesh raise a named
    NotImplementedError; none runs silently on one rank."""
    from skypilot_tpu_torch.models import engine as port_engine
    from skypilot_tpu_torch.parallel import mesh as port_mesh

    class _Coords:
        def get_local_rank(self, axis):
            return 0
    sizes = {a: 1 for a in port_mesh.AXIS_ORDER}
    mesh = port_mesh.Mesh(dict(sizes, tensor=2), None, _Coords(), 'gloo')
    for kw, what in ((dict(kv_layout='paged'), 'the paged layout'),
                     (dict(draft=True), 'a draft model'),
                     (dict(moe=True), 'an MoE model'),
                     (dict(role='prefill'), 'a prefill or decode role'),
                     (dict(role='decode'), 'a prefill or decode role')):
        with pytest.raises(NotImplementedError, match=what):
            port_engine.check_options(mesh=mesh, **kw)
    data = port_mesh.Mesh(dict(sizes, data=2, tensor=2), None, _Coords(),
                          'gloo')
    with pytest.raises(NotImplementedError, match='data axis'):
        port_engine.check_options(mesh=data)
    # A KV export or import would admit on the head alone.
    eng = port_engine.ContinuousEngine.__new__(port_engine.ContinuousEngine)
    eng.mesh = mesh
    for call in (lambda: eng.submit_prefill([1, 2], 4),
                 lambda: eng.submit_import([1, 2], 4, 1, layout='slot')):
        with pytest.raises(NotImplementedError,
                           match='a KV export or import'):
            call()


def test_nccl_rank_computes_on_its_own_card(monkeypatch, tmp_path):
    """Under NCCL a rank computes on its local rank's card, named by
    index all the way down: the current CUDA device is per thread, and an
    unindexed 'cuda' on the engine thread is card 0. The card and the
    process group are stood in for; the wiring is what is checked."""
    from skypilot_tpu_torch.models import engine as port_engine
    from skypilot_tpu_torch.parallel import mesh as port_mesh
    from skypilot_tpu_torch.utils import cuda_client_guard
    seen = {}
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    monkeypatch.setattr(torch.cuda, 'set_device',
                        lambda d: seen.update(set_device=torch.device(d)))
    monkeypatch.setattr(port_spmd, '_store', lambda init, rank, world: None)
    monkeypatch.setattr(port_spmd, '_exit_with_parent', lambda: None)
    monkeypatch.setattr(
        port_spmd.dist, 'init_process_group',
        lambda backend, **kw: seen.update(
            group=(backend, kw['rank'], kw['device_id'])))
    for name in ('JAX_COORDINATOR_ADDRESS', 'JAX_NUM_PROCESSES',
                 'JAX_PROCESS_ID'):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv(port_spmd.LOCAL_RANK_ENV, '2')
    monkeypatch.setenv(port_spmd.RANK_ENV, '2')
    monkeypatch.setenv(port_spmd.INIT_ENV, f'file://{tmp_path}/rendezvous')
    gang = port_spmd.maybe_initialize(4, 'cuda', [])
    card = torch.device('cuda', 2)
    assert (gang.backend, gang.rank, gang.device) == ('nccl', 2, card)
    assert seen == {'set_device': card, 'group': ('nccl', 2, card)}

    class _Built(Exception):
        pass

    def built(args, device=None):
        seen['server'] = device
        raise _Built
    monkeypatch.setattr(port_spmd, 'maybe_initialize', lambda *a: gang)
    monkeypatch.setattr(
        cuda_client_guard, 'init_backend_guarded',
        lambda platform=None, index=0: seen.update(context=(platform, index)))
    monkeypatch.setattr(port_srv, 'server_from_args', built)
    with pytest.raises(_Built):
        port_srv.main(['--model', 'tiny', '--tp', '4'])
    assert (seen['context'], seen['server']) == (('cuda', 2), card)
    # The server's mesh and the engine thread's scope keep the index.
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    assert port_mesh.build_mesh(device=card).device == card
    eng = port_engine.ContinuousEngine.__new__(port_engine.ContinuousEngine)
    eng.device = card
    assert eng._device_scope().idx == 2  # noqa: SLF001


@pytest.mark.parametrize('backend,order', [
    ('nccl', ['barrier', 'destroy', 'release', 'mark']),
    ('gloo', ['barrier', 'release', 'destroy', 'mark'])])
def test_ranks_leave_in_their_backends_order(monkeypatch, backend, order):
    """NCCL's teardown is collective: a rank tears its groups down right
    after the barrier, before it waits for the ranks it spawned to exit
    (they would wait for it in theirs). gloo's is local and comes after,
    as before. A host's first rank above 0, with a follower of its own."""
    seen = []
    monkeypatch.setattr(port_spmd.collectives, 'barrier',
                        lambda: seen.append('barrier'))
    monkeypatch.setattr(port_spmd.dist, 'destroy_process_group',
                        lambda: seen.append('destroy'))

    class _Store:
        def set(self, key, value):
            seen.append('mark')
    gang = port_spmd.Gang(rank=2, world=4, local_rank=0, local=2,
                          backend=backend, device=torch.device('cpu'),
                          store=_Store())
    monkeypatch.setattr(gang, 'release_children',
                        lambda timeout: seen.append('release') or [0])
    assert gang.close(1.0) == [0]
    assert seen == order
