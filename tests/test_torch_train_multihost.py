"""Sharded training across host processes, and ``train.run``'s mesh
flags, on the CPU.

- Program D of ``__graft_entry__.dryrun_multichip``: program A over
  ``num_slices=2`` as two host processes of four ranks each under the
  gang launcher's env (``JAX_COORDINATOR_ADDRESS``,
  ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``, ``MEGASCALE_NUM_SLICES``):
  JAX's program A numbers, with ``data`` across the two hosts.
- ``train.run --mesh data=2,fsdp=2 --num-slices 2`` prints JAX's mesh
  line and ``[train] done`` and leaves no rank behind; ``pipe``, ``seq``
  and ``expert`` exit 2, each by name; a spec that does not divide
  raises JAX's ``ValueError`` text.
- A leaf split across two host processes cannot be checkpointed: JAX's
  ``CheckpointError`` text.
"""
import os
import pickle
import signal
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from skypilot_tpu.parallel import mesh as jax_mesh
from skypilot_tpu_torch.train import run as port_run

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_tp import REPO  # noqa: E402
from test_torch_train_sharded import (RTOL, _close, _jax_run,  # noqa: E402
                                      _leaves, _tokens)

HOSTS_TIMEOUT_S = 240


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _hosts(tmp_path, command, hosts=2, slices=2, timeout=HOSTS_TIMEOUT_S):
    """``command`` as ``hosts`` host processes under the gang launcher's
    env, each in its own session (its spawned ranks with it); returns
    their exit codes and logs."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES='',
               JAX_COORDINATOR_ADDRESS=f'127.0.0.1:{_free_port()}',
               JAX_NUM_PROCESSES=str(hosts),
               MEGASCALE_NUM_SLICES=str(slices))
    procs, logs = [], []
    try:
        for h in range(hosts):
            logs.append(open(tmp_path / f'host{h}.log', 'w+'))
            procs.append(subprocess.Popen(
                command, stdout=logs[-1], stderr=subprocess.STDOUT,
                env=dict(env, JAX_PROCESS_ID=str(h)),
                start_new_session=True))
        for p in procs:
            try:
                p.wait(timeout)
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
    texts = []
    for log in logs:
        log.seek(0)
        texts.append(log.read())
        log.close()
    return [p.returncode for p in procs], texts


_HOST_SCRIPT = '''
import dataclasses, os, pickle, sys
sys.path.insert(0, {repo!r})
import torch
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.parallel import gang as gang_lib
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.train import optim, trainer as trainer_lib

tmp = sys.argv[1]
gang = gang_lib.initialize(8, 'cpu', sys.argv[1:],
                           [sys.executable, __file__], 'program D')
mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(data=2, fsdp=2, tensor=2),
                           num_slices=2, device='cpu')
with open(os.path.join(tmp, 'inputs.pkl'), 'rb') as f:
    inputs = pickle.load(f)
cfg = dataclasses.replace(llama.TINY, dtype=torch.float32)
tr = trainer_lib.Trainer(trainer_lib.TrainerConfig(
    model=cfg, global_batch_size=4, seq_len=128, optimizer='adafactor',
    remat=True, warmup_steps=1), mesh=mesh)
st = tr.init_state_from_numpy(inputs['params'])
out = {{'losses': [], 'norms': [], 'host': gang.host,
       'data': mesh.axis_index('data')}}
for toks in inputs['tokens']:
    st, m = tr.step(st, toks)
    out['losses'].append(float(m['loss']))
    out['norms'].append(float(m['grad_norm']))
whole = tr.host_view(st, gang.local)
out['params'] = optim.tree_map(lambda t: t.numpy(), whole['params'])
torch.save(out, os.path.join(tmp, f'out.{{gang.rank}}.pt'))
gang.close(60)
sys.stdout.flush()
os._exit(0)
'''


def test_program_d_two_hosts_give_program_a(tmp_path):
    init, losses, norms, final = _jax_run()
    with open(tmp_path / 'inputs.pkl', 'wb') as f:
        pickle.dump({'params': init['params'], 'tokens': _tokens()}, f)
    script = tmp_path / 'host.py'
    script.write_text(textwrap.dedent(_HOST_SCRIPT.format(repo=REPO)))
    codes, texts = _hosts(tmp_path, [sys.executable, str(script),
                                     str(tmp_path)])
    assert codes == [0, 0], '\n'.join(t[-3000:] for t in texts)
    ranks = [torch.load(tmp_path / f'out.{r}.pt', weights_only=False)
             for r in range(8)]
    for r, out in enumerate(ranks):
        # data crosses the two slices: each host holds one data index.
        assert out['host'] == out['data'] == r // 4
        _close(out['losses'], losses, RTOL)
        _close(out['norms'], norms, RTOL)
    for w, g in zip(_leaves(final['params']), _leaves(ranks[0]['params'])):
        _close(g, w, RTOL)


def _run_cli(args, tmp_path, **env):
    return subprocess.run(
        [sys.executable, '-m', 'skypilot_tpu_torch.train.run', *args],
        capture_output=True, text=True, timeout=HOSTS_TIMEOUT_S,
        start_new_session=True, cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES='',
                 **env))


def test_cli_trains_on_the_mesh_and_leaves_no_rank_behind(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.train.run', '--model',
         'tiny', '--mesh', 'data=2,fsdp=2', '--num-slices', '2', '--steps',
         '2', '--device', 'cpu', '--global-batch-size', '4'],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True,
        env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=''))
    try:
        out, _ = proc.communicate(timeout=HOSTS_TIMEOUT_S)
        # Every rank of the session is gone with the first.
        with pytest.raises(ProcessLookupError):
            os.killpg(proc.pid, 0)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    assert proc.returncode == 0, out[-3000:]
    sizes = {'data': 2, 'pipe': 1, 'fsdp': 2, 'seq': 1, 'expert': 1,
             'tensor': 1}
    assert f'[train] mesh {sizes} over 2 slice(s)' in out
    assert out.count('[train] rank-summary') == 4
    assert '[train] done' in out


@pytest.mark.parametrize('axis', ['pipe', 'seq', 'expert'])
def test_unported_axes_exit_2_by_name(axis, capsys):
    """The pipe, seq and expert axes, which exited 2 by name before, are
    ported: each plans a gang of two ranks (none starts here; they train
    in tests/test_torch_train_axes.py), and nothing is refused."""
    parser = port_run.build_parser()
    sizes, slices, ranks = port_run._plan_mesh(  # noqa: SLF001
        parser, parser.parse_args(['--model', 'tiny', '--mesh',
                                   f'{axis}=2,fsdp=1', '--device', 'cpu']))
    assert (sizes[axis], slices, ranks) == (2, 1, 2)
    assert capsys.readouterr().err == ''


@pytest.mark.parametrize('spec,slices,n,env', [
    ('data=3,fsdp=2', 2, 6, {}),  # data does not split over the slices
    ('data=3', 1, 2, {'JAX_COORDINATOR_ADDRESS': '127.0.0.1:1',
                      'JAX_NUM_PROCESSES': '2'}),  # -1 over 2 hosts
])
def test_a_spec_that_does_not_divide_gives_jax_error(spec, slices, n, env,
                                                     monkeypatch):
    axes = dict(p.split('=') for p in spec.split(','))
    with pytest.raises(ValueError) as want:
        jax_mesh.build_mesh(jax_mesh.MeshSpec(**{k: int(v) for k, v in
                                                 axes.items()}),
                            devices=jax.devices()[:n], num_slices=slices)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError) as got:
        port_run.main(['--model', 'tiny', '--mesh', spec, '--num-slices',
                       str(slices), '--device', 'cpu'])
    assert str(got.value) == str(want.value)


def test_a_leaf_split_across_hosts_cannot_be_checkpointed(tmp_path):
    codes, texts = _hosts(tmp_path, [
        sys.executable, '-m', 'skypilot_tpu_torch.train.run', '--model',
        'tiny', '--mesh', 'fsdp=2', '--num-slices', '1', '--device', 'cpu',
        '--global-batch-size', '2', '--seq-len', '32', '--steps', '1',
        '--ckpt-dir', str(tmp_path / 'ck')], slices=1)
    assert all(codes), texts
    for text in texts:
        assert ("cannot snapshot \"['params']['embed']\": array is sharded "
                'across hosts (not fully addressable)') in text, text[-3000:]


def test_fsdp_minus_one_on_one_host_is_one_device():
    """A -1 axis resolves against the gang's devices (one per host on the
    CPU), as JAX's against its devices: the lora-finetune recipe's
    ``fsdp=-1`` on one host trains on one device, as before."""
    parser = port_run.build_parser()
    sizes, slices, ranks = port_run._plan_mesh(  # noqa: SLF001
        parser, parser.parse_args(['--mesh', 'fsdp=-1', '--device', 'cpu']))
    assert (sizes['fsdp'], slices, ranks) == (1, 1, 1)


def test_two_hosts_commit_a_step_through_the_writers_barrier(tmp_path):
    """Two host processes of one rank each on ``data=2`` (every leaf
    whole on each host): each writes its host manifest, the writers meet
    at the store's barrier, rank 0 commits; a relaunch resumes."""
    from skypilot_tpu_torch.ckpt import manifest as manifest_lib
    ckpt = tmp_path / 'ck'
    argv = [sys.executable, '-m', 'skypilot_tpu_torch.train.run', '--model',
            'tiny', '--mesh', 'data=2', '--num-slices', '2', '--device',
            'cpu', '--global-batch-size', '2', '--seq-len', '32',
            '--save-every', '1', '--ckpt-dir', str(ckpt)]
    codes, texts = _hosts(tmp_path, argv + ['--steps', '2'])
    assert codes == [0, 0], '\n'.join(t[-3000:] for t in texts)
    step = os.path.join(str(ckpt), manifest_lib.step_dirname(2))
    assert manifest_lib.is_committed(step)
    assert all(os.path.exists(os.path.join(
        step, manifest_lib.host_manifest_name(h))) for h in (0, 1))
    codes, texts = _hosts(tmp_path, argv + ['--steps', '3'])
    assert codes == [0, 0], '\n'.join(t[-3000:] for t in texts)
    assert '[train] resumed from checkpoint step 2' in texts[0]


_MACHINES_SCRIPT = '''
import dataclasses, os, sys
sys.path.insert(0, {repo!r})
import torch
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.parallel import collectives as C
from skypilot_tpu_torch.parallel import gang as gang_lib
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.train import optim, trainer as trainer_lib

tmp = sys.argv[1]
gang = gang_lib.initialize(4, 'cpu', sys.argv[1:],
                           [sys.executable, __file__], 'two machines')


def run():
    mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(data=2, fsdp=2),
                               num_slices=2, device='cpu')
    g = torch.Generator().manual_seed(gang.rank)
    xs = [torch.randn(4, 8, 3, generator=g),
          torch.randn(3 << 18, generator=g).to(torch.bfloat16)]
    res = {{}}
    for i, x in enumerate(xs):
        for axis in ('data', 'fsdp'):
            res[f'psum{{i}}{{axis}}'] = C.psum(x, mesh, axis)
            res[f'pmax{{i}}{{axis}}'] = C.pmax(x, mesh, axis)
            res[f'gather{{i}}{{axis}}'] = C.all_gather(x, mesh, axis, -1)
            res[f'ring{{i}}{{axis}}'] = C.ppermute_ring(x, mesh, axis)
            res[f'scatter{{i}}{{axis}}'] = C.reduce_scatter(x, mesh, axis, 0)
    cfg = dataclasses.replace(llama.TINY, dtype=torch.float32)
    tr = trainer_lib.Trainer(trainer_lib.TrainerConfig(
        model=cfg, global_batch_size=4, seq_len=64, warmup_steps=1),
        mesh=mesh)
    st = tr.init_state(seed=0)
    for step in range(2):
        toks = torch.randint(0, cfg.vocab_size, (4, 64),
                             generator=torch.Generator().manual_seed(step))
        st, m = tr.step(st, toks)
        res[f'loss{{step}}'] = m['loss']
    res.update({{f'param{{i}}': t for i, t in enumerate(
        optim.tree_leaves(tr.host_view(st, gang.local)['params']))}})
    arenas = {{a: type(v).__name__ for a, v in mesh.arenas.items()}}
    return {{k: v.float().numpy() for k, v in res.items()}}, arenas


out = {{'gloo': run()}}
# Ranks that share a card stage through the host: forced for CPU tensors,
# once on this one machine, once as if each host were a machine of its own.
mesh_lib.Mesh.stages_on_host = property(lambda self: True)
out['one_machine'] = run()
C._machine = lambda: f'machine{{gang.host}}'
out['two_machines'] = run()
torch.save(out, os.path.join(tmp, f'out.{{gang.rank}}.pt'))
gang.close(60)
sys.stdout.flush()
os._exit(0)
'''


def test_staged_groups_that_span_machines_go_through_gloo(tmp_path):
    """Ranks that stage through the host share an arena of host memory
    only within one machine: with each host process on a machine of its
    own, the ``data`` groups (across the hosts) copy to the host and run
    gloo's collectives, the ``fsdp`` groups keep their arena, and every
    collective and two training steps give plain gloo's values."""
    script = tmp_path / 'host.py'
    script.write_text(textwrap.dedent(_MACHINES_SCRIPT.format(repo=REPO)))
    codes, texts = _hosts(tmp_path, [sys.executable, str(script),
                                     str(tmp_path)])
    assert codes == [0, 0], '\n'.join(t[-3000:] for t in texts)
    for r in range(4):
        out = torch.load(tmp_path / f'out.{r}.pt', weights_only=False)
        assert out['gloo'][1] == {}
        assert out['one_machine'][1] == {'data': '_Arena', 'fsdp': '_Arena'}
        assert out['two_machines'][1] == {'data': 'bool', 'fsdp': '_Arena'}
        want = out['gloo'][0]
        for name in ('one_machine', 'two_machines'):
            for key, got in out[name][0].items():
                if key.startswith(('psum', 'scatter', 'loss', 'param')):
                    # Sums in another order (float32 over one step each).
                    np.testing.assert_allclose(
                        got, want[key], rtol=1e-6, atol=1e-6,
                        err_msg=f'{name} {key} rank {r}')
                else:
                    assert np.array_equal(got, want[key]), (name, key, r)
