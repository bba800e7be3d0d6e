"""Several pipeline stages on each ``pipe`` rank, against the JAX package,
on the CPU.

JAX splits the layer stack into ``pipeline_stages`` stages and shards the
stage dim over ``pipe``, so with ``pipeline_stages = k * pipe`` each rank
holds k consecutive stages and the schedule runs ``M + S - 1`` ticks over
all S stages. The port's ``parallel/pipeline.py`` runs the same ticks: a
rank runs its valid stages one after another, hands its stage j's output
to stage j + 1 in memory and only its last stage's output to the next
rank.

Where ``pipe`` does not divide the stages, JAX pads the stage dim, so a
rank runs a block of ``ceil(stages / pipe)`` stages (``stage_block``)
while its layers at rest stay an even block of the stack (``layers ->
pipe``), and GSPMD moves only the layers of a stage that lie on another
device. The port does the same (``collectives.exchange_rows``): a rank
receives the layers of its block that another rank holds, their
gradients go back to that rank, and nothing the size of the whole stack
is built.

One 8-rank gloo gang (``run_gang`` of ``tests/test_torch_tp.py``) on
``pipe=2,expert=2,tensor=2`` computes:

- the toy pipeline of ``tests/test_torch_parallel_axes.py`` (8 layers of
  tanh(x @ w)) in 4 stages over ``pipe=2``: outputs, aux and the
  gradients of the inputs and of every layer against JAX's
  ``pipeline_apply`` on one device;
- ``tests/test_pipeline_moe.py:158``'s program (MoE, batch 4, seq 64)
  with a 4-layer ``MOE_TINY``, ``pipeline_stages`` 4 and 2 microbatches:
  two Adafactor steps of the port's ``Trainer`` against JAX's on 8
  virtual devices, the metrics and every leaf within 1e-4;
- the same program at 6 layers in 3 stages, which ``pipe=2`` does not
  divide: pipe rank 0 runs stages 0 and 1 (layers 0-3, of which it holds
  0-2) and rank 1 stage 2 (layers 4-5 of its 3-5).

One 4-rank gang on ``pipe=4`` runs two more layouts ``pipe`` does not
divide, each two Adafactor steps of float32 ``TINY`` against JAX's
``Trainer`` on 4 virtual devices: 4 layers in 2 stages (ranks 2-3 run
no stage but hold layers 2-3) and, narrow, 20 layers in 5 stages (rank
3's layers go to ranks 1 and 2). Both gangs record every collective the
steps issue, so the tests see what moves over ``pipe`` and how much.
"""
import dataclasses
import math
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


# (base preset, layers, pipeline_stages, other fields) of each Trainer
# program: the 8-rank gang's, then the 4-rank gang's on MESH4.
NARROW = {'d_model': 32, 'n_heads': 2, 'n_kv_heads': 1, 'd_ff': 64}
PROGRAMS = {'four': ('MOE_TINY', 4, 4, {}), 'three': ('MOE_TINY', 6, 3, {})}
PROGRAMS4 = {'two': ('TINY', 4, 2, {}), 'five': ('TINY', 20, 5, NARROW)}
MESH4 = {'pipe': 4, 'fsdp': 1}
# (layers, stages, pipe): the program that runs it, and the layers each
# pipe rank's block lacks (its stage block less its layers at rest).
UNEVEN = {(6, 3, 2): ('three', [1, 0]), (4, 2, 4): ('two', [1, 2, 0, 0]),
          (20, 5, 4): ('five', [3, 6, 4, 0])}


def _jax_cfg(name='four'):
    base, layers, stages, fields = {**PROGRAMS, **PROGRAMS4}[name]
    return dataclasses.replace(getattr(jax_llama, base), dtype=jnp.float32,
                               n_layers=layers, pipeline_stages=stages,
                               pipeline_microbatches=2, **fields)


def _tokens(cfg):
    return [np.random.default_rng(i).integers(
        0, cfg.vocab_size, size=(BATCH, SEQ)).astype(np.int32)
        for i in range(STEPS)]


def _jax_run(name='four', spec=MESH, world=8):
    cfg = _jax_cfg(name)
    mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec(**spec),
                               devices=jax.devices()[:world])
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


_PROGRAMS_BODY = '''
import dataclasses
import numpy as np
from torch.utils._python_dispatch import TorchDispatchMode
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.parallel import pipeline as pipe_lib
from skypilot_tpu_torch.train import optim, trainer as trainer_lib

def t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32)).requires_grad_(grad)

pm = mesh_lib.build_mesh(mesh_lib.MeshSpec(**inputs['mesh']), device='cpu')

# Every collective: (what, kind, bytes sent, all_to_all's (received,
# sent) element counts by rank of the axis, or None).
calls = []
_timed, _a2a = collectives._timed, dist.all_to_all_single

def _recorded(what, fn, kind='other', nbytes=0):
    calls.append([what, kind, nbytes, None])
    return _timed(what, fn, kind, nbytes)

def _recorded_a2a(out_t, in_t, out_splits, in_splits, **kw):
    calls[-1][3] = (list(out_splits), list(in_splits))
    return _a2a(out_t, in_t, out_splits, in_splits, **kw)

collectives._timed, dist.all_to_all_single = _recorded, _recorded_a2a

class _Shapes(TorchDispatchMode):
    """The shape of every tensor an op makes, forward and backward."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(o, torch.Tensor):
                self.seen.add(tuple(o.shape))
        return out

def blocks_of(cfg, layers):
    """The rank's stage block of ``layers`` (``llama._stage_layers``):
    each block leaf's (shape, storage bytes, bytes at rest), whether an
    op made a tensor of a whole-stack leaf's shape, and the largest error
    of each rank-held row's gradient under a loss that weighs whole-stack
    row g by g + 1 (every row runs in some rank's block)."""
    held = [w.detach().requires_grad_(True)
            for w in pipe_lib.tree_leaves(layers)]
    first = pipe_lib.stage_rows(cfg.n_layers, cfg.pipeline_stages,
                                pm.shape['pipe'])[pm.axis_index('pipe')][0]
    shapes = _Shapes()
    with shapes:
        blocks = pipe_lib.tree_leaves(llama._stage_layers(
            pipe_lib.tree_rebuild(layers, held), cfg,
            cfg.pipeline_stages, pm))
        loss = sum((b * (first + 1 + torch.arange(b.shape[0])).view(
            (-1,) + (1,) * (b.dim() - 1))).sum() for b in blocks)
        grads = torch.autograd.grad(loss, held)
    start = pm.axis_index('pipe') * held[0].shape[0]
    err = max(float((g - (start + 1 + torch.arange(g.shape[0])).view(
        (-1,) + (1,) * (g.dim() - 1))).abs().max()) for g in grads)
    whole = any((cfg.n_layers,) + tuple(w.shape[1:]) in shapes.seen
                for w in held)
    return {'blocks': [(tuple(b.shape), b.untyped_storage().nbytes(),
                        w.numel() * w.element_size())
                       for b, w in zip(blocks, held)],
            'whole_shape': whole, 'grad_err': err}

def run_programs():
    for name, (base, layers, stages, fields) in inputs['programs'].items():
        cfg = dataclasses.replace(getattr(llama, base), dtype=torch.float32,
                                  n_layers=layers, pipeline_stages=stages,
                                  pipeline_microbatches=2, **fields)
        tr = trainer_lib.Trainer(trainer_lib.TrainerConfig(
            model=cfg, global_batch_size=inputs['batch'],
            seq_len=inputs['seq'], optimizer='adafactor', remat=True,
            warmup_steps=1), mesh=pm)
        st = tr.init_state_from_numpy(inputs['init'][name])
        held = pipe_lib.tree_leaves(st['params']['layers'])
        blocks = blocks_of(cfg, st['params']['layers'])
        metrics = []
        calls.clear()
        for toks in inputs['tokens']:
            st, m = tr.step(st, toks)
            metrics.append({k: float(v) for k, v in m.items()})
        steps = list(calls)
        whole = tr.host_view(st, world)
        out[name] = {'metrics': metrics, 'pipe': pm.axis_index('pipe'),
                     'layers': tuple(st['params']['layers']['wq'].shape),
                     'row_numel': sum(w[0].numel() for w in held),
                     'calls': steps, **blocks,
                     'final': optim.tree_map(lambda a: a.detach().numpy(),
                                             whole['params'])}
'''

# ``exchange_rows`` alone at 20 rows in 5 stages on pipe=4: float32 and
# bfloat16 leaves (one all_to_all each) and a frozen one, over gloo and
# then through the shared-memory arena of ranks that share a card.
_EXCHANGE = '''
def exchange_case():
    gen = torch.Generator().manual_seed(0)
    whole = [torch.randn(20, 3, generator=gen),
             torch.randn(20, 2, 2, generator=gen).to(torch.bfloat16),
             torch.randn(20, 4, generator=gen)]
    p = pm.axis_index('pipe')
    needs = pipe_lib.stage_rows(20, 5, 4)
    mine = [w[p * 5:(p + 1) * 5].clone().requires_grad_(i < 2)
            for i, w in enumerate(whole)]
    calls.clear()
    blocks = collectives.exchange_rows(mine, pm, 'pipe', needs)
    first, end = needs[p]
    weight = (first + 1 + torch.arange(end - first)).float()
    loss = sum((b.float() * weight.view((-1,) + (1,) * (b.dim() - 1))).sum()
               for b in blocks)
    grads = torch.autograd.grad(loss, mine[:2])
    return {'blocks': [b.detach() for b in blocks],
            'want': [w[first:end] for w in whole],
            'grads': list(grads), 'rows': p * 5,
            'kinds': [(c[1], c[2]) for c in calls]}

out['exchange'] = {'gloo': exchange_case()}
mesh_lib.Mesh.stages_on_host = property(lambda self: True)
out['exchange']['shared'] = exchange_case()
out['exchange']['arena'] = isinstance(pm.arenas.get('pipe'),
                                      collectives._Arena)
'''

_BODY = _PROGRAMS_BODY + '''

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

run_programs()
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


@pytest.fixture(scope='module')
def runs4(tmp_path_factory):
    """JAX's 4-rank programs on 4 virtual devices (``pipe=4``), and the
    port's 4-rank gang running them from the same inputs."""
    jax_runs = {name: _jax_run(name, MESH4, 4) for name in PROGRAMS4}
    inputs = {'mesh': MESH4, 'batch': BATCH, 'seq': SEQ,
              'programs': PROGRAMS4,
              'init': {name: run[0] for name, run in jax_runs.items()},
              'tokens': _tokens(_jax_cfg('two'))}
    ranks = run_gang(tmp_path_factory.mktemp('pipe_stages4'), 4,
                     _PROGRAMS_BODY + 'run_programs()\n' + _EXCHANGE,
                     spec={'fsdp': 4}, inputs=inputs)
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
    """Every rank's loss, grad_norm and (MoE) moe_aux within 1e-4 of
    JAX's, one grad_norm on every rank, and every leaf of the gathered
    params after the steps."""
    jax_runs, ranks = runs
    init, want_metrics, final = jax_runs[name]
    for rank in ranks:
        for got, want in zip(rank[name]['metrics'], want_metrics):
            assert got.keys() >= want.keys() >= {'loss', 'grad_norm'}
            for key in ('loss', 'grad_norm', 'moe_aux'):
                if key in want:
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
    dim: pipe rank 0 runs stages 0-1 and rank 1 stage 2, each holding its
    3 layers of the stack at rest (``layers -> pipe``) and rank 0
    receiving layer 3 for the step. The metrics and every leaf within
    1e-4 of JAX's."""
    _check_program(runs, 'three')
    for rank in runs[1]:
        assert rank['three']['layers'][0] == 3


def test_trainer_two_stages_on_four_pipe_ranks_matches_jax(runs4):
    """Two Trainer steps of float32 TINY at 4 layers in 2 stages on
    ``pipe=4``: ranks 0 and 1 run a stage each (layers 0-1 and 2-3),
    ranks 2 and 3 none, though they hold layers 2 and 3 at rest. The
    metrics and every leaf within 1e-4 of JAX's on 4 devices."""
    _check_program(runs4, 'two')
    for rank in runs4[1]:
        assert rank['two']['layers'][0] == 1


def test_trainer_five_stages_on_four_pipe_ranks_matches_jax(runs4):
    """Two Trainer steps of a narrow float32 TINY at 20 layers in 5
    stages on ``pipe=4``: blocks of 2 stages (8 layers) on ranks 0-1, 1
    stage on rank 2, none on rank 3, whose 5 layers go to ranks 1 and 2.
    The metrics and every leaf within 1e-4 of JAX's on 4 devices."""
    _check_program(runs4, 'five')
    for rank in runs4[1]:
        assert rank['five']['layers'][0] == 5


def _uneven(request, layout):
    """(ranks' outputs of the layout's program, its name)."""
    name = UNEVEN[layout][0]
    runs = request.getfixturevalue('runs' if layout[2] == 2 else 'runs4')
    return runs[1], name


def _block_less_rest(layers, stages, pipe):
    """{(owner, user): layers}: the layers of each user's stage block
    that the owner holds at rest, by arithmetic alone."""
    per, held, k = layers // stages, layers // pipe, -(-stages // pipe)
    need = [set(range(min(p * k, stages) * per,
                      min(p * k + k, stages) * per)) for p in range(pipe)]
    rest = [set(range(p * held, (p + 1) * held)) for p in range(pipe)]
    return {(o, u): len(need[u] & rest[o]) for o in range(pipe)
            for u in range(pipe) if o != u and need[u] & rest[o]}


def _exchanges(rank, name, kind):
    return [c for c in rank[name]['calls'] if c[1] == kind]


@pytest.mark.parametrize('layout', sorted(UNEVEN))
def test_uneven_layout_receives_only_what_its_block_lacks(request, layout):
    """Each step's forward moves, to each pipe rank, exactly the layers of
    its stage block that another rank holds, from that rank (1/0 at 6
    layers in 3 stages on pipe=2; 1/2/0/0 at 4 in 2 on pipe=4; 3/6/4/0
    at 20 in 5 on pipe=4), in one all_to_all a step on every rank,
    those that move nothing too; ``STATS`` counts the bytes each sends."""
    ranks, name = _uneven(request, layout)
    pipe = layout[2]
    moves = _block_less_rest(*layout)
    assert [sum(v for (o, u), v in moves.items() if u == p)
            for p in range(pipe)] == UNEVEN[layout][1]
    seen = set()
    for rank in ranks:
        p, width = rank[name]['pipe'], rank[name]['row_numel']
        seen.add(p)
        fwd = _exchanges(rank, name, 'exchange')
        assert len(fwd) == STEPS
        for what, _, nbytes, (got, sent) in fwd:
            assert what == 'all_to_all over pipe'
            assert got == [moves.get((o, p), 0) * width
                           for o in range(pipe)]
            assert sent == [moves.get((p, u), 0) * width
                            for u in range(pipe)]
            assert nbytes == sum(sent) * 4
        assert sum(got) // width == UNEVEN[layout][1][p]
    assert seen == set(range(pipe))


@pytest.mark.parametrize('layout', sorted(UNEVEN))
def test_uneven_layout_sends_gradients_back_to_their_owners(request,
                                                            layout):
    """Each step's backward sends the gradient of every layer a rank
    received back to the rank that sent it, and nothing else: one
    all_to_all a step, the forward's counts transposed, and no
    all-gather or reduce-scatter over ``pipe`` (the weights at rest stay
    split, and no rank gathers the stack)."""
    ranks, name = _uneven(request, layout)
    for rank in ranks:
        fwd = _exchanges(rank, name, 'exchange')
        back = _exchanges(rank, name, 'exchange_grad')
        assert len(back) == STEPS
        for f, b in zip(fwd, back):
            assert b[0] == 'all_to_all over pipe'
            assert b[3] == (f[3][1], f[3][0])
        over_pipe = {c[0] for c in rank[name]['calls']
                     if c[0].endswith(' over pipe')}
        assert not over_pipe & {'all_gather over pipe',
                                'reduce_scatter over pipe'}
        assert sum(c[0] == 'all_to_all over pipe'
                   for c in rank[name]['calls']) == 2 * STEPS


@pytest.mark.parametrize('layout', sorted(UNEVEN))
def test_uneven_stage_blocks_hold_no_whole_stack(request, layout):
    """No leaf of the block a rank runs has storage larger than its block
    or its slice at rest (a view of that slice where the block lies in
    it), no op forward or backward makes a tensor of a whole-stack
    leaf's shape, and every layer's gradient reaches the rank that holds
    it (a loss weighing layer g by g + 1)."""
    ranks, name = _uneven(request, layout)
    layers, stages, pipe = layout
    for rank in ranks:
        out = rank[name]
        first, end = port_pipe.stage_rows(layers, stages, pipe)[out['pipe']]
        for shape, storage, at_rest in out['blocks']:
            assert shape[0] == end - first
            block = math.prod(shape) * 4
            assert storage <= max(block, at_rest)
        assert not out['whole_shape']
        assert out['grad_err'] == 0.0


def test_even_layout_moves_no_weights_over_pipe(runs):
    """4 layers in 4 stages on ``pipe=2`` (stages ``pipe`` divides): each
    rank's block is its layers at rest, as they lie, and no weight moves
    over ``pipe`` (no exchange, all-gather or reduce-scatter there)."""
    for rank in runs[1]:
        out = rank['four']
        assert all(storage == at_rest for _, storage, at_rest in
                   out['blocks'])
        kinds = {c[0] for c in out['calls']}
        assert not kinds & {'all_to_all over pipe', 'all_gather over pipe',
                            'reduce_scatter over pipe'}
        assert not _exchanges(rank, 'four', 'exchange')
        assert out['grad_err'] == 0.0


def test_exchange_rows_through_gloo_and_the_arena(runs4):
    """``exchange_rows`` on a float32, a bfloat16 and a frozen leaf, 20
    rows in 5 stages on ``pipe=4``: each rank's block is the whole
    stack's rows of its stages, each held row's gradient is what the
    rank running it computed, one all_to_all a dtype moves each way (the
    frozen leaf's gradient not at all), and the arena of ranks that
    share a card gives gloo's bits."""
    for rank in runs4[1]:
        got = rank['exchange']
        assert got['arena']
        for way in ('gloo', 'shared'):
            run = got[way]
            for block, want in zip(run['blocks'], run['want']):
                assert block.dtype == want.dtype
                assert torch.equal(block, want)
            for g in run['grads']:
                rows = run['rows'] + 1 + torch.arange(g.shape[0])
                assert torch.equal(g.float(), rows.float().view(
                    (-1,) + (1,) * (g.dim() - 1)).expand(g.shape))
            assert [k for k, _ in run['kinds']] == ['exchange'] * 2 + [
                'exchange_grad'] * 2
        for a, b in zip(got['gloo']['blocks'] + got['gloo']['grads'],
                        got['shared']['blocks'] + got['shared']['grads']):
            assert torch.equal(a, b)
        assert got['gloo']['kinds'] == got['shared']['kinds']


@pytest.mark.parametrize('layers,stages,pipe,rows', [
    (6, 3, 2, [(0, 4), (4, 6)]), (4, 2, 4, [(0, 2), (2, 4), (4, 4), (4, 4)]),
    (20, 5, 4, [(0, 8), (8, 16), (16, 20), (20, 20)]),
    (8, 4, 2, [(0, 4), (4, 8)])])
def test_stage_rows_are_the_stage_blocks_layers(layers, stages, pipe, rows):
    """Each rank's layers: those of its ``stage_block``, empty where it
    runs no stage."""
    assert port_pipe.stage_rows(layers, stages, pipe) == rows


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
