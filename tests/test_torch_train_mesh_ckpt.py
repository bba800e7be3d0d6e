"""Checkpoints of sharded training, on the CPU: JAX's semantics
(``skypilot_tpu/ckpt/snapshot.py:35-60``) on the port's gang.

- A JAX checkpoint written on an 8-device ``fsdp`` mesh is restored by a
  2-rank port gang (``fsdp=2``), leaf for leaf, and trains on as JAX
  does; a port gang's checkpoint is restored by JAX, leaf for leaf.
- ``train.run`` on ``fsdp=2`` saved at step 2 and resumed to step 4
  equals 4 uninterrupted steps bit for bit.
- SIGTERM to a 2-rank gang: every rank exits 143, the newest saved step
  is committed, and a relaunch resumes from it.

A float32 model whose dims reach 128 (Adafactor factors its embedding,
head and MLP weights, so the factored moments are sliced too).
"""
import dataclasses
import os
import re
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from skypilot_tpu.ckpt import manager as jax_manager
from skypilot_tpu.ckpt import snapshot as jax_snapshot
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.parallel import mesh as jax_mesh
from skypilot_tpu.train import trainer as jax_trainer
from skypilot_tpu_torch.ckpt import manifest as manifest_lib

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_tp import REPO, run_gang  # noqa: E402

WIDE32 = dataclasses.replace(jax_llama.TINY, d_model=128, d_ff=256,
                             dtype=jnp.float32)
BATCH, SEQ = 8, 32
TOL = 1e-5
CLI_TIMEOUT_S = 240


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, WIDE32.vocab_size, (BATCH, SEQ)).astype(np.int32)
            for _ in range(n)]


def _jax_trainer(mesh=None):
    return jax_trainer.Trainer(jax_trainer.TrainerConfig(
        model=WIDE32, global_batch_size=BATCH, seq_len=SEQ, warmup_steps=1,
        optimizer='adafactor'), mesh=mesh)


_BODY = '''
import dataclasses
import numpy as np
from skypilot_tpu_torch.ckpt import snapshot
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.parallel import gang as gang_lib
from skypilot_tpu_torch.train import checkpoint as ckpt_lib
from skypilot_tpu_torch.train import trainer as trainer_lib

cfg = dataclasses.replace(llama.TINY, d_model=128, d_ff=256,
                          dtype=torch.float32)
tr = trainer_lib.Trainer(trainer_lib.TrainerConfig(
    model=cfg, global_batch_size=8, seq_len=32, warmup_steps=1,
    optimizer='adafactor'), mesh=mesh)
gang = gang_lib.Gang(rank=rank, world=world, local_rank=rank, local=world,
                     backend='gloo', device=torch.device('cpu'))

def value(leaf):
    if isinstance(leaf.value, torch.Tensor):  # a replicated leaf: the
        return leaf.value.numpy().copy()      # state's own tensor
    if leaf.value is None:  # optax's placeholder, as a save writes it
        return np.zeros(leaf.shape, leaf.dtype)
    return np.asarray(leaf.value)

def named(state):
    whole = tr.host_view(state, world)
    return {leaf.name: value(leaf)
            for leaf in snapshot.flatten_named(whole)[0]}

# JAX's checkpoint, restored on this mesh and trained one more step.
st = tr.init_state_from_numpy(inputs['params'])
mgr = ckpt_lib.CheckpointManager(inputs['jax_dir'], trainer=tr, gang=gang)
st = mgr.restore_latest(st)
mgr.close()
out['restored'] = named(st)
out['local_embed'] = tuple(st['params']['embed'].shape)
st, m = tr.step(st, inputs['next'])
out['next_loss'] = float(m['loss'])

# The port's own: two steps from JAX's weights, saved at step 2.
st = tr.init_state_from_numpy(inputs['params'])
for b in inputs['batches']:
    st, _ = tr.step(st, b)
mgr = ckpt_lib.CheckpointManager(inputs['port_dir'], trainer=tr, gang=gang,
                                 save_interval_steps=1, async_save=True)
mgr.save(2, st)
mgr.close()
out['saved'] = named(st)
'''


@pytest.fixture(scope='module')
def crossed(tmp_path_factory):
    root = tmp_path_factory.mktemp('cross')
    mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec(fsdp=8),
                               devices=jax.devices()[:8])
    jt = _jax_trainer(mesh)
    jstate = jt.init_state(0)
    params = jax.tree.map(np.asarray, jstate['params'])
    step = jt.compiled_step()
    batches = _batches(3, 1)
    for b in batches[:2]:
        jstate, _ = step(jstate, jnp.asarray(b))
    jm = jax_manager.AsyncCheckpointManager(str(root / 'jax'),
                                            async_save=False, telemetry=None)
    jm.save(2, jstate, force=True)
    jm.close()
    saved = dict((n, np.asarray(a)) for n, a in
                 jax_snapshot.flatten_named(jstate)[0])
    jstate, jm_ = step(jstate, jnp.asarray(batches[2]))
    ranks = run_gang(root, 2, _BODY, spec={'fsdp': 2}, inputs={
        'params': params, 'jax_dir': str(root / 'jax'),
        'port_dir': str(root / 'port'), 'batches': batches[:2],
        'next': batches[2]})
    return saved, float(jm_['loss']), ranks, str(root / 'port')


def test_jax_mesh_checkpoint_restores_into_a_port_gang(crossed):
    saved, next_loss, ranks, _ = crossed
    for out in ranks:
        assert out['local_embed'] == (256, 64)  # embed split over fsdp
        assert set(out['restored']) == set(saved)
        for name, want in saved.items():
            got = out['restored'][name]
            assert np.array_equal(np.asarray(got), np.asarray(want)), name
        assert out['next_loss'] == pytest.approx(next_loss, rel=TOL)


def test_port_gang_checkpoint_restores_into_jax(crossed):
    _, _, ranks, port_dir = crossed
    jt = _jax_trainer()
    jm = jax_manager.AsyncCheckpointManager(port_dir, telemetry=None)
    jstate = jm.restore_latest(jt.init_state(0))
    jm.close()
    assert int(jstate['step']) == 2
    for name, arr in jax_snapshot.flatten_named(jstate)[0]:
        assert np.array_equal(np.asarray(arr),
                              np.asarray(ranks[0]['saved'][name])), name


# -- train.run on a gang: resume, SIGTERM --------------------------------------


def _cli(args, ckpt, tmp_path, name, wait=True, **kw):
    """``python -m skypilot_tpu_torch.train.run`` on a 2-rank gang of the
    CPU (its own session: the test ends every process in it)."""
    log = open(tmp_path / f'{name}.log', 'w+')
    proc = subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.train.run', '--model',
         'tiny', '--mesh', 'fsdp=2', '--device', 'cpu',
         '--global-batch-size', '4', '--seq-len', '32', '--log-every', '1',
         '--warmup-steps', '1', '--ckpt-dir', str(ckpt), *args],
        stdout=log, stderr=subprocess.STDOUT, start_new_session=True,
        env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES='',
                 **kw))
    if not wait:
        return proc, log
    try:
        proc.wait(CLI_TIMEOUT_S)
    finally:
        _end(proc)
    log.seek(0)
    text = log.read()
    log.close()
    assert proc.returncode == 0, text[-3000:]
    return text


def _end(proc):
    """Kill whatever is left of the run's session."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def _step_arrays(root, step):
    path = os.path.join(root, manifest_lib.step_dirname(step))
    assert manifest_lib.is_committed(path)
    return {name: np.asarray(getattr(arr, 'words', arr)).copy()
            for name, arr in manifest_lib.iter_host_arrays(path, 0)}


def test_resume_on_the_mesh_equals_uninterrupted_bit_for_bit(tmp_path):
    a = _cli(['--steps', '2', '--save-every', '2'], tmp_path / 'ab',
             tmp_path, 'a')
    assert "[train] mesh {'data': 1, 'pipe': 1, 'fsdp': 2" in a
    b = _cli(['--steps', '4', '--save-every', '2'], tmp_path / 'ab',
             tmp_path, 'b')
    assert '[train] resumed from checkpoint step 2' in b
    _cli(['--steps', '4', '--save-every', '2', '--ckpt-sync'],
         tmp_path / 'c', tmp_path, 'c')
    resumed = _step_arrays(str(tmp_path / 'ab'), 4)
    straight = _step_arrays(str(tmp_path / 'c'), 4)
    assert resumed.keys() == straight.keys()
    for name in straight:
        assert np.array_equal(resumed[name], straight[name]), name


def test_sigterm_exits_143_on_every_rank_with_the_step_committed(tmp_path):
    ckpt = tmp_path / 'ck'
    proc, log = _cli(['--steps', '50', '--save-every', '2',
                      '--step-time-floor', '0.5'], ckpt, tmp_path, 'run',
                     wait=False)
    try:
        deadline = time.monotonic() + CLI_TIMEOUT_S
        while time.monotonic() < deadline:
            log.seek(0)
            if '[train] step 5/50' in log.read():
                break
            assert proc.poll() is None, 'the run ended before step 5'
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)  # the host's first rank only
        proc.wait(60)
    finally:
        _end(proc)
    log.seek(0)
    text = log.read()
    log.close()
    assert proc.returncode == 143, text[-3000:]
    codes = re.search(r'ranks spawned here exited with \[(.*?)\]', text)
    assert codes and codes.group(1) == '143', text[-3000:]
    persisted = int(re.search(r'emergency persist returned step (\d+)',
                              text).group(1))
    steps = [s for s, _ in manifest_lib.committed_steps(str(ckpt))]
    assert persisted >= 4 and max(steps) == persisted
    again = _cli(['--steps', str(persisted + 1)], ckpt, tmp_path, 'again')
    assert f'resumed from checkpoint step {persisted}' in again


_BLOCKED_RANK = '''
import os, signal, socket, sys
from datetime import timedelta
sys.path.insert(0, {repo!r})
import torch.distributed as dist
from skypilot_tpu_torch.train import run
signal.signal(signal.SIGTERM, lambda signum, frame: os._exit(143))
run.exit_on_sigterm_from_a_thread()
with socket.socket() as s:
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
print('waiting', flush=True)
# A wait inside torch's C++ that no peer ends, as a collective whose peer
# has left: Python's handler alone would run only when it times out.
dist.TCPStore('127.0.0.1', port, 2, True, timedelta(seconds=60),
              wait_for_workers=True)
'''


def test_a_rank_blocked_in_a_collective_exits_143_on_sigterm(tmp_path):
    """A host's follower ranks may sit in a collective that the host's
    first rank, busy in its SIGTERM handler, never joins: they exit 143
    at once all the same (``run.exit_on_sigterm_from_a_thread``)."""
    script = tmp_path / 'blocked.py'
    script.write_text(_BLOCKED_RANK.format(repo=REPO))
    proc = subprocess.Popen([sys.executable, str(script)],
                            stdout=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        assert proc.stdout.readline().strip() == 'waiting'
        time.sleep(1.0)  # into the wait
        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(30) == 143
        assert time.monotonic() - t0 < 10
    finally:
        _end(proc)
