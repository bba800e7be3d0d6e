"""Training over the pipe, seq and expert axes: the port's ``Trainer``
against the JAX package's, and ``train.run`` on an expert mesh, on the
CPU.

Programs B and C of ``__graft_entry__.dryrun_multichip`` (``MULTICHIP_r05``
runs them on 8 devices), in float32 so that the tolerance is tight:

- B: MoE (``MOE_TINY``: 4 experts, top-2) with 2 pipeline stages and 2
  microbatches on ``pipe=2,expert=2,tensor=2``, batch 2, seq 64;
- C: dense ``TINY`` on ``data=2,seq=2,tensor=2`` (ring attention), batch
  2, seq 128.

JAX's ``Trainer`` runs each on 8 virtual CPU devices; the port runs both,
one after the other, on one 8-rank gloo gang (``run_gang`` of
``tests/test_torch_tp.py``), from JAX's initial weights and on
``_run_step``'s seeded tokens: two Adafactor steps (the warm-up's first
is at rate 0), the losses, ``grad_norm`` and ``moe_aux`` of both within
RTOL of JAX's, and every leaf of the gathered params after them.

Then ``python -m skypilot_tpu_torch.train.run --model moe-tiny --mesh
fsdp=2,expert=2`` (four ranks): 2 steps saved, resumed to 4, equal to 4
uninterrupted steps bit for bit.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.parallel import mesh as jax_mesh
from skypilot_tpu.train import trainer as jax_trainer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_tp import run_gang  # noqa: E402
from test_torch_train_mesh_ckpt import _cli, _step_arrays  # noqa: E402

RTOL = 1e-4
STEPS = 2
PROGRAMS = {
    'B': dict(mesh={'pipe': 2, 'expert': 2, 'tensor': 2, 'fsdp': 1},
              model='moe', batch=2, seq=64),
    'C': dict(mesh={'data': 2, 'seq': 2, 'tensor': 2, 'fsdp': 1},
              model='dense', batch=2, seq=128),
}


def _jax_cfg(kind):
    if kind == 'moe':
        return dataclasses.replace(jax_llama.MOE_TINY, dtype=jnp.float32,
                                   pipeline_stages=2, pipeline_microbatches=2)
    return dataclasses.replace(jax_llama.TINY, dtype=jnp.float32)


def _tokens(cfg, batch, seq):
    """``_run_step``'s tokens (seed 0), then one more batch (seed 1)."""
    return [np.random.default_rng(i).integers(
        0, cfg.vocab_size, size=(batch, seq)).astype(np.int32)
        for i in range(STEPS)]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _jax_run(name):
    prog = PROGRAMS[name]
    cfg = _jax_cfg(prog['model'])
    mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec(**prog['mesh']),
                               devices=jax.devices()[:8])
    tr = jax_trainer.Trainer(jax_trainer.TrainerConfig(
        model=cfg, global_batch_size=prog['batch'], seq_len=prog['seq'],
        optimizer='adafactor', remat=True, warmup_steps=1), mesh=mesh)
    state = tr.init_state(seed=0)
    init = jax.tree.map(np.asarray, state['params'])
    step = tr.compiled_step()
    metrics = []
    for toks in _tokens(cfg, prog['batch'], prog['seq']):
        state, m = step(state, jnp.asarray(toks))
        metrics.append({k: float(v) for k, v in m.items()})
    return init, metrics, jax.tree.map(np.asarray, state['params'])


_BODY = '''
import dataclasses
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.train import optim, trainer as trainer_lib

for name, prog in inputs['programs'].items():
    pmesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(**prog['mesh']),
                                device='cpu')
    if prog['model'] == 'moe':
        cfg = dataclasses.replace(llama.MOE_TINY, dtype=torch.float32,
                                  pipeline_stages=2, pipeline_microbatches=2)
    else:
        cfg = dataclasses.replace(llama.TINY, dtype=torch.float32)
    tr = trainer_lib.Trainer(trainer_lib.TrainerConfig(
        model=cfg, global_batch_size=prog['batch'], seq_len=prog['seq'],
        optimizer='adafactor', remat=True, warmup_steps=1), mesh=pmesh)
    st = tr.init_state_from_numpy(inputs['init'][name])
    metrics = []
    for toks in inputs['tokens'][name]:
        st, m = tr.step(st, toks)
        metrics.append({k: float(v) for k, v in m.items()})
    whole = tr.host_view(st, world)
    out[name] = {'metrics': metrics,
                 'final': optim.tree_map(lambda t: t.detach().numpy(),
                                         whole['params'])}
'''


@pytest.fixture(scope='module')
def programs(tmp_path_factory):
    """JAX's programs B and C, and the port's 8-rank gang running both
    from the same weights and tokens."""
    runs = {name: _jax_run(name) for name in PROGRAMS}
    inputs = {'programs': PROGRAMS,
              'init': {n: r[0] for n, r in runs.items()},
              'tokens': {n: _tokens(_jax_cfg(p['model']), p['batch'],
                                    p['seq'])
                         for n, p in PROGRAMS.items()}}
    ranks = run_gang(tmp_path_factory.mktemp('gang_bc'), 8, _BODY,
                     spec={'fsdp': 8}, inputs=inputs)
    return runs, ranks


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=RTOL * 1e-2)


@pytest.mark.parametrize('name', sorted(PROGRAMS))
def test_program_matches_jax_trainer(programs, name):
    runs, ranks = programs
    init, want_metrics, final = runs[name]
    keys = {'loss', 'grad_norm'} | (
        {'moe_aux'} if PROGRAMS[name]['model'] == 'moe' else set())
    for rank in ranks:  # every rank's metrics are the global ones
        for got, want in zip(rank[name]['metrics'], want_metrics):
            for key in keys:
                _close(got[key], want[key])
    assert len({tuple(m['grad_norm'] for m in r[name]['metrics'])
                for r in ranks}) == 1
    got = ranks[0][name]['final']
    for w, g in zip(_leaves(final), _leaves(got)):
        assert g.shape == w.shape
        _close(g, w)
    moved = max(float(np.abs(a - b).max())
                for a, b in zip(_leaves(final), _leaves(init)))
    assert moved > 1e-4  # the second step moved the weights


def test_train_run_on_an_expert_mesh_resumes_bit_for_bit(tmp_path):
    """The moe-finetune recipe's axes on moe-tiny: ``--mesh
    fsdp=2,expert=2`` (four ranks) saved at 2 and resumed to 4 equals 4
    uninterrupted steps, every array of step 4 bit for bit."""
    mesh = ['--model', 'moe-tiny', '--mesh', 'fsdp=2,expert=2']
    a = _cli(mesh + ['--steps', '2', '--save-every', '2'], tmp_path / 'ab',
             tmp_path, 'a')
    assert "'fsdp': 2, 'seq': 1, 'expert': 2" in a and 'moe_aux=' in a
    b = _cli(mesh + ['--steps', '4', '--save-every', '2'], tmp_path / 'ab',
             tmp_path, 'b')
    assert '[train] resumed from checkpoint step 2' in b
    c = _cli(mesh + ['--steps', '4', '--save-every', '2', '--ckpt-sync'],
             tmp_path / 'c', tmp_path, 'c')
    for text in (a, b, c):
        assert 'x 4 ranks (gloo)' in text
    step4 = [line for line in c.splitlines() if 'step 4/4' in line]
    assert step4 and step4[0].split(' step_ms')[0] in b
    resumed = _step_arrays(str(tmp_path / 'ab'), 4)
    straight = _step_arrays(str(tmp_path / 'c'), 4)
    assert resumed.keys() == straight.keys()
    assert any('we_gate' in name for name in straight)
    for name in straight:
        assert np.array_equal(resumed[name], straight[name]), name
