"""Several pipeline stages on each ``pipe`` rank, against the JAX package,
on the CPU.

JAX splits the layer stack into ``pipeline_stages`` stages and shards the
stage dim over ``pipe``, so with ``pipeline_stages = k * pipe`` each rank
holds k consecutive stages and the schedule runs ``M + S - 1`` ticks over
all S stages. The port's ``parallel/pipeline.py`` runs the same ticks: a
rank runs its valid stages one after another, hands its stage j's output
to stage j + 1 in memory and only its last stage's output to the next
rank.

One 8-rank gloo gang (``run_gang`` of ``tests/test_torch_tp.py``) on
``pipe=2,expert=2,tensor=2`` computes every port-side figure:

- the toy pipeline of ``tests/test_torch_parallel_axes.py`` (8 layers of
  tanh(x @ w)) in 4 stages over ``pipe=2``: outputs, aux and the
  gradients of the inputs and of every layer against JAX's
  ``pipeline_apply`` on one device;
- ``tests/test_pipeline_moe.py:158``'s program (MoE, batch 4, seq 64)
  with a 4-layer ``MOE_TINY``, ``pipeline_stages`` 4 and 2 microbatches:
  two Adafactor steps of the port's ``Trainer`` against JAX's on 8
  virtual devices, the metrics and every leaf within 1e-4;
- the same program at 6 layers in 3 stages, which ``pipe=2`` does not
  divide: JAX pads the stage dim, so pipe rank 0 runs stages 0 and 1 and
  rank 1 stage 2 (``pipeline.stage_block``).
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.parallel import mesh as jax_mesh
from skypilot_tpu.parallel import pipeline as jax_pipe
from skypilot_tpu.train import trainer as jax_trainer
from skypilot_tpu_torch.models import llama as port_llama
from skypilot_tpu_torch.parallel import pipeline as port_pipe

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parallel_axes import (AUX_W, _jax_toy,  # noqa: E402
                                      _toy_inputs)
from test_torch_tp import run_gang  # noqa: E402
from test_torch_train_axes import _leaves  # noqa: E402

TOY_STAGES = 4
VAL_TOL = 1e-5
RTOL = 1e-4
STEPS = 2
MESH = {'pipe': 2, 'expert': 2, 'tensor': 2, 'fsdp': 1}
BATCH, SEQ = 4, 64


# (layers, pipeline_stages) of each Trainer program.
PROGRAMS = {'four': (4, 4), 'three': (6, 3)}


def _jax_cfg(name='four'):
    layers, stages = PROGRAMS[name]
    return dataclasses.replace(jax_llama.MOE_TINY, dtype=jnp.float32,
                               n_layers=layers, pipeline_stages=stages,
                               pipeline_microbatches=2)


def _tokens(cfg):
    return [np.random.default_rng(i).integers(
        0, cfg.vocab_size, size=(BATCH, SEQ)).astype(np.int32)
        for i in range(STEPS)]


def _jax_run(name='four'):
    cfg = _jax_cfg(name)
    mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec(**MESH),
                               devices=jax.devices()[:8])
    tr = jax_trainer.Trainer(jax_trainer.TrainerConfig(
        model=cfg, global_batch_size=BATCH, seq_len=SEQ,
        optimizer='adafactor', remat=True, warmup_steps=1), mesh=mesh)
    state = tr.init_state(seed=0)
    init = jax.tree.map(np.asarray, state['params'])
    step = tr.compiled_step()
    metrics = []
    for toks in _tokens(cfg):
        state, m = step(state, jnp.asarray(toks))
        metrics.append({k: float(v) for k, v in m.items()})
    return init, metrics, jax.tree.map(np.asarray, state['params'])


_BODY = '''
import dataclasses
import numpy as np
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.parallel import pipeline as pipe_lib
from skypilot_tpu_torch.train import optim, trainer as trainer_lib

def t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32)).requires_grad_(grad)

pm = mesh_lib.build_mesh(mesh_lib.MeshSpec(**inputs['mesh']), device='cpu')

# The toy in 4 stages over pipe=2: this rank's 4 layers are 2 stages.
p = pm.axis_index('pipe')
ws, x, ct = inputs['toy']
per = ws.shape[0] // 2
w = t(ws[p * per:(p + 1) * per], True)
tx = t(x, True)

def stage(stage_ws, x_mb):
    y = x_mb
    for wl in stage_ws.unbind(0):
        y = torch.tanh(y @ wl)
    return y, (y ** 2).mean()

outputs, aux = pipe_lib.pipeline_apply(stage, w, tx,
                                       num_stages=inputs['stages'], mesh=pm)
aux_all = collectives.reduce_from(aux, pm, 'pipe')
part = ((outputs * t(ct)).sum() if p == 1 else outputs.sum() * 0.0)
g_w, g_x = torch.autograd.grad(part + inputs['aux_w'] * aux_all, [w, tx])
out['pipe'] = {'rank': p, 'outputs': outputs.detach().numpy(),
               'aux': float(aux_all), 'g_w': g_w.numpy(),
               'g_x': g_x.numpy()}

for name, (layers, stages) in inputs['programs'].items():
    cfg = dataclasses.replace(llama.MOE_TINY, dtype=torch.float32,
                              n_layers=layers, pipeline_stages=stages,
                              pipeline_microbatches=2)
    tr = trainer_lib.Trainer(trainer_lib.TrainerConfig(
        model=cfg, global_batch_size=inputs['batch'], seq_len=inputs['seq'],
        optimizer='adafactor', remat=True, warmup_steps=1), mesh=pm)
    st = tr.init_state_from_numpy(inputs['init'][name])
    metrics = []
    for toks in inputs['tokens']:
        st, m = tr.step(st, toks)
        metrics.append({k: float(v) for k, v in m.items()})
    whole = tr.host_view(st, world)
    out[name] = {'metrics': metrics,
                 'layers': tuple(st['params']['layers']['wq'].shape),
                 'final': optim.tree_map(lambda a: a.detach().numpy(),
                                         whole['params'])}
'''


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """JAX's 4-stage program on 8 virtual devices, and the port's 8-rank
    gang running the toy and the program from the same inputs."""
    jax_runs = {name: _jax_run(name) for name in PROGRAMS}
    inputs = {'mesh': MESH, 'toy': _toy_inputs(), 'stages': TOY_STAGES,
              'aux_w': AUX_W, 'batch': BATCH, 'seq': SEQ,
              'programs': PROGRAMS,
              'init': {name: run[0] for name, run in jax_runs.items()},
              'tokens': _tokens(_jax_cfg())}
    ranks = run_gang(tmp_path_factory.mktemp('pipe_stages'), 8, _BODY,
                     spec={'fsdp': 8}, inputs=inputs)
    return jax_runs, ranks


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol * 1e-2 if tol == RTOL else tol)


def test_pipeline_apply_two_stages_a_rank_matches_jax(runs):
    """4 stages over pipe=2, 3 microbatches (6 ticks): the last stage's
    rank holds the outputs, every rank the summed aux; each rank's layer
    gradients are its block of JAX's, and the input gradient lands on the
    first stage's rank."""
    ranks = runs[1]
    want_out, want_aux, want_gws, want_gx = _jax_toy(TOY_STAGES)
    per = want_gws.shape[0] // 2
    for rank in ranks:
        got = rank['pipe']
        p = got['rank']
        _close(got['aux'], want_aux, VAL_TOL)
        _close(got['g_w'], want_gws[p * per:(p + 1) * per], VAL_TOL)
        if p == 1:
            _close(got['outputs'], want_out, VAL_TOL)
        else:
            assert not np.any(got['outputs'])
            _close(got['g_x'], want_gx, VAL_TOL)
    assert {r['pipe']['rank'] for r in ranks} == {0, 1}


def _check_program(runs, name):
    """Every rank's loss, grad_norm and moe_aux within 1e-4 of JAX's, one
    grad_norm on every rank, and every leaf of the gathered params after
    the steps."""
    jax_runs, ranks = runs
    init, want_metrics, final = jax_runs[name]
    for rank in ranks:
        for got, want in zip(rank[name]['metrics'], want_metrics):
            for key in ('loss', 'grad_norm', 'moe_aux'):
                _close(got[key], want[key], RTOL)
    assert len({tuple(m['grad_norm'] for m in r[name]['metrics'])
                for r in ranks}) == 1
    got = ranks[0][name]['final']
    for w, g in zip(_leaves(final), _leaves(got)):
        assert g.shape == w.shape
        _close(g, w, RTOL)
    moved = max(float(np.abs(a - b).max())
                for a, b in zip(_leaves(final), _leaves(init)))
    assert moved > 1e-4


def test_trainer_four_stages_on_two_pipe_ranks_matches_jax(runs):
    """Two Trainer steps of the 4-layer MoE in 4 stages on
    ``pipe=2,expert=2,tensor=2``: every rank's loss, grad_norm and
    moe_aux within 1e-4 of JAX's, one grad_norm on every rank, and every
    leaf of the gathered params after the steps."""
    _check_program(runs, 'four')


def test_trainer_three_stages_on_two_pipe_ranks_matches_jax(runs):
    """Two Trainer steps of a 6-layer MoE in 3 stages on
    ``pipe=2,expert=2,tensor=2``, which JAX trains by padding the stage
    dim: pipe rank 0 runs stages 0-1 and rank 1 stage 2, each still
    holding its 3 layers of the stack (``layers -> pipe``). The metrics
    and every leaf within 1e-4 of JAX's."""
    _check_program(runs, 'three')
    for rank in runs[1]:
        assert rank['three']['layers'][0] == 3


@pytest.mark.parametrize('layers,stages,pipe,ok', [
    (4, 4, 2, True), (8, 8, 2, True), (4, 2, 2, True), (4, 1, 2, True),
    (6, 3, 2, True), (4, 2, 4, True), (8, 4, 8, True),
    (6, 2, 4, False)])
def test_check_mesh_takes_whole_stages_a_rank(layers, stages, pipe, ok):
    """Every stage count JAX's Trainer trains passes: a multiple of
    ``pipe``, 1 (one stage a rank), or one that ``pipe`` does not divide
    (3 on pipe=2, 2 on pipe=4, 4 on pipe=8: JAX pads the stage dim, and
    each rank runs a block of ``ceil(stages / pipe)`` whole stages, the
    last ranks fewer or none). Layers that do not split over ``pipe``
    are refused, as JAX refuses to place them, in JAX's
    ``split_stages`` words."""
    cfg = dataclasses.replace(port_llama.MOE_TINY, n_layers=layers,
                              pipeline_stages=stages)
    sizes = dict.fromkeys(('data', 'fsdp', 'seq', 'expert', 'tensor'), 1)
    sizes['pipe'] = pipe
    if ok:
        port_llama.check_mesh(cfg, sizes)
        return
    with pytest.raises(ValueError) as err:
        port_llama.check_mesh(cfg, sizes)
    assert str(err.value) == f'{layers} layers not divisible by ' \
                             f'{pipe} stages'


@pytest.mark.parametrize('stages,ranks,blocks', [
    (3, 2, [(0, 2), (2, 1)]), (4, 2, [(0, 2), (2, 2)]),
    (2, 4, [(0, 1), (1, 1), (2, 0), (2, 0)]),
    (5, 4, [(0, 2), (2, 2), (4, 1), (5, 0)])])
def test_stage_blocks_follow_the_padded_stage_dim(stages, ranks, blocks):
    """Each rank's (first stage, count): ``ceil(stages / ranks)`` a rank,
    as the stage dim padded to a multiple of the ranks splits."""
    assert [port_pipe.stage_block(stages, ranks, p)
            for p in range(ranks)] == blocks


def test_split_stages_words_match_jax():
    """A stack that does not split into the stages: JAX's words."""
    with pytest.raises(ValueError) as want:
        jax_pipe.split_stages(jnp.zeros((6, 2)), 4)
    with pytest.raises(ValueError) as got:
        port_pipe.split_stages(torch.zeros((6, 2)), 4)
    assert str(got.value) == str(want.value)
