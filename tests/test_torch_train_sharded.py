"""Sharded training of the port against the JAX package, on the CPU.

The port trains one process per rank (``run_gang`` of
``tests/test_torch_tp.py``: gloo over a file rendezvous, every rank's
process ended inside the test); JAX runs in this process on the virtual
CPU devices of ``tests/conftest.py``. Float32 TINY (a float32 copy of
the preset) makes the tolerances tight: the port's order of sums differs
from GSPMD's, nothing else.

- Program A of ``__graft_entry__.dryrun_multichip``: a dense llama on
  ``data=2,fsdp=2,tensor=2``, batch 4, seq 128, Adafactor, remat
  'full', two steps on ``_run_step``'s seeded tokens: losses, grad_norm
  and every gathered leaf within 1e-4 relative of JAX's Trainer.
- LoRA rank 4 on every target on the same mesh (JAX's deferred
  ``test_lora.py::test_trainer_lora_sharded_step_on_fsdp_mesh``): losses
  and adapters within 1e-4 of JAX, the base unchanged bit for bit.
- ``fsdp=4`` and ``data=2,fsdp=2`` (and ``data=2,tensor=2`` with
  accumulation, ``fsdp=2,tensor=2`` and ``data=2,tensor=2`` under the
  'dots' and 'heavy' remat policies), one after another on one 4-rank
  gang: equal to the port's one-process step within 1e-5.
- The sharded optimizer: one Adafactor and one AdamW update of a leaf
  whose factored dim is split, and of a replicated norm leaf, equal to
  the one-device update of the whole leaf within 1e-6.
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
from skypilot_tpu.models import lora as jax_lora
from skypilot_tpu.parallel import mesh as jax_mesh
from skypilot_tpu.train import trainer as jax_trainer
from skypilot_tpu_torch.models import llama as port_llama
from skypilot_tpu_torch.models import lora as port_lora
from skypilot_tpu_torch.train import optim as port_optim
from skypilot_tpu_torch.train import trainer as port_trainer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_tp import run_gang  # noqa: E402

TINY32 = dataclasses.replace(jax_llama.TINY, dtype=jnp.float32)
MESH_A = {'data': 2, 'fsdp': 2, 'tensor': 2}
BATCH, SEQ, STEPS = 4, 128, 2
RTOL = 1e-4        # port gang against JAX (program A, LoRA)
SELF_RTOL = 1e-5   # port gang against the port on one process
OPT_TOL = 1e-6     # the sharded optimizer against the whole leaf's update
# Adafactor scales an update by the parameter's RMS, at least 1e-3, and
# the warm-up's first step is 0: at the default 3e-4 the zero-initialised
# B would move by ~3e-7 in two steps, below what the comparison sees.
LORA_LR = 1e-1


def _tokens():
    """``__graft_entry__._run_step``'s tokens, one seed per step."""
    return [np.random.default_rng(i).integers(
        0, TINY32.vocab_size, size=(BATCH, SEQ)).astype(np.int32)
        for i in range(STEPS)]


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _leaves(tree):
    """A dict tree's leaves in sorted-key order (JAX's flatten order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _jax_run(lora=None, lr=3e-4):
    mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec(**MESH_A),
                               devices=jax.devices()[:8])
    tc = jax_trainer.TrainerConfig(
        model=TINY32, global_batch_size=BATCH, seq_len=SEQ,
        optimizer='adafactor', remat=True, warmup_steps=1, lora=lora,
        learning_rate=lr)
    tr = jax_trainer.Trainer(tc, mesh=mesh)
    state = tr.init_state(seed=0)
    if lora is not None:
        # JAX makes bf16 adapters; float32 ones keep the comparison tight
        # (the optimizer state follows their dtype).
        state['lora'] = jax.tree.map(lambda x: x.astype(jnp.float32),
                                     state['lora'])
        state['opt_state'] = tr.optimizer.init(state['lora'])
    init = {'params': _np(state['params'])}
    if lora is not None:
        init['lora'] = _np(state['lora'])
    step = tr.compiled_step()
    losses, norms = [], []
    for toks in _tokens():
        state, m = step(state, jnp.asarray(toks))
        losses.append(float(m['loss']))
        norms.append(float(m['grad_norm']))
    final = {'params': _np(state['params'])}
    if lora is not None:
        final['lora'] = _np(state['lora'])
    return init, losses, norms, final


_BODY = '''
import dataclasses
import numpy as np
from skypilot_tpu_torch.models import llama, lora as lora_lib
from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.train import optim, trainer as trainer_lib

cfg = dataclasses.replace(llama.TINY, dtype=torch.float32)

def train(name, init, lora=None, lr=3e-4):
    tc = trainer_lib.TrainerConfig(
        model=cfg, global_batch_size=4, seq_len=128, optimizer='adafactor',
        remat=True, warmup_steps=1, lora=lora, learning_rate=lr)
    tr = trainer_lib.Trainer(tc, mesh=mesh)
    st = tr.init_state_from_numpy(init['params'], lora=init.get('lora'))
    losses, norms = [], []
    for toks in inputs['tokens']:
        st, m = tr.step(st, toks)
        losses.append(float(m['loss']))
        norms.append(float(m['grad_norm']))
    whole = tr.host_view(st, world)
    out[name] = {'losses': losses, 'norms': norms,
                 'final': optim.tree_map(lambda t: t.numpy(),
                                         {k: whole[k] for k in
                                          ('params', 'lora') if k in whole}),
                 'local_wq': tuple(st['params']['layers']['wq'].shape)}

train('full', inputs['full'])
if 'lora' in inputs:
    train('lora', inputs['lora'], lora_lib.LoraConfig(
        rank=4, targets=lora_lib.ALL_TARGETS), lr=inputs['lora_lr'])
out['stats'] = dict(collectives.STATS)
'''


@pytest.fixture(scope='module')
def program_a(tmp_path_factory):
    """JAX's program A and LoRA on ``data=2,fsdp=2,tensor=2``, and the
    port's 8-rank gang from the same weights and tokens."""
    jax_full = _jax_run()
    lora_cfg = jax_lora.LoraConfig(rank=4, targets=jax_lora.ALL_TARGETS)
    jax_lo = _jax_run(lora_cfg, LORA_LR)
    inputs = {'tokens': _tokens(), 'full': jax_full[0], 'lora': jax_lo[0],
              'lora_lr': LORA_LR}
    ranks = run_gang(tmp_path_factory.mktemp('gang_a'), 8, _BODY,
                     spec=MESH_A, inputs=inputs)
    return {'full': jax_full, 'lora': jax_lo}, ranks


def _close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=rtol * 1e-2)


def test_program_a_matches_jax_trainer(program_a):
    jax_runs, ranks = program_a
    _, losses, norms, final = jax_runs['full']
    for out in ranks:  # every rank's metrics are the global ones
        _close(out['full']['losses'], losses, RTOL)
        _close(out['full']['norms'], norms, RTOL)
    assert len({tuple(o['full']['norms']) for o in ranks}) == 1
    got = ranks[0]['full']['final']['params']
    for w, g in zip(_leaves(final['params']), _leaves(got)):
        assert g.shape == w.shape
        _close(g, w, RTOL)
    # The weights moved, so the comparison is of real updates.
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        _leaves(final['params']), _leaves(jax_runs['full'][0]['params'])))
    assert moved > 1e-4
    # Each rank holds a quarter of wq: embed over fsdp, heads over tensor.
    assert ranks[0]['full']['local_wq'] == (2, 32, 2, 16)


def test_lora_on_the_mesh_matches_jax_and_freezes_the_base(program_a):
    jax_runs, ranks = program_a
    init, losses, _, final = jax_runs['lora']
    for out in ranks:
        _close(out['lora']['losses'], losses, RTOL)
    got = ranks[0]['lora']['final']
    for w, g in zip(_leaves(final['lora']), _leaves(got['lora'])):
        _close(g, w, RTOL)
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        _leaves(final['lora']), _leaves(init['lora'])))
    assert moved > 1e-4
    for w, g in zip(_leaves(init['params']), _leaves(got['params'])):
        assert np.array_equal(w, g)  # the base, bit for bit


def test_lora_logical_axes_equal_jax():
    cfg = jax_lora.LoraConfig(rank=4, targets=jax_lora.ALL_TARGETS)
    want = jax_lora.lora_logical_axes(jax_llama.TINY, cfg)
    got = port_lora.lora_logical_axes(
        port_llama.TINY, port_lora.LoraConfig(
            rank=4, targets=port_lora.ALL_TARGETS))
    assert got == want


# -- fsdp alone, and the multislice recipe's shape, against one process -------

_SELF_BODY = '''
import dataclasses
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.train import optim, trainer as trainer_lib
cfg = dataclasses.replace(llama.TINY, dtype=torch.float32)
for key, spec, optimizer, accum, policy in inputs['cases']:
    tc = trainer_lib.TrainerConfig(
        model=cfg, global_batch_size=4, seq_len=128, optimizer=optimizer,
        remat=True, warmup_steps=1, accum_steps=accum, remat_policy=policy)
    tr = trainer_lib.Trainer(tc, mesh=mesh_lib.build_mesh(
        mesh_lib.MeshSpec(**spec), device='cpu'))
    st = tr.init_state(seed=0)
    res = out[key] = {'losses': []}
    for toks in inputs['tokens']:
        st, m = tr.step(st, toks)
        res['losses'].append(float(m['loss']))
        res['norm'] = float(m['grad_norm'])
    res['params'] = optim.tree_map(lambda t: t.numpy(),
                                   tr.host_view(st, world)['params'])
'''
# (spec, optimizer, accum_steps, remat policy): four ranks each.
SELF_CASES = [
    ({'fsdp': 4}, 'adafactor', 1, 'full'),
    ({'data': 2, 'fsdp': 2}, 'adafactor', 1, 'full'),
    ({'data': 2, 'tensor': 2}, 'adamw', 2, 'full'),
    ({'fsdp': 2, 'tensor': 2}, 'adafactor', 1, 'dots'),
    ({'data': 2, 'tensor': 2}, 'adafactor', 1, 'heavy')]


def _case_key(case):
    spec, optimizer, accum, policy = case
    return (','.join(f'{k}={v}' for k, v in spec.items())
            + f'-{optimizer}-accum{accum}-{policy}')


@pytest.fixture(scope='module')
def self_runs(tmp_path_factory):
    """Every ``SELF_CASES`` mesh, one after another on one 4-rank gang."""
    cases = [(_case_key(c),) + c for c in SELF_CASES]
    ranks = run_gang(tmp_path_factory.mktemp('gang_self'), 4, _SELF_BODY,
                     inputs={'tokens': _tokens(), 'cases': cases})
    return ranks


@pytest.mark.parametrize('case', SELF_CASES, ids=_case_key)
def test_mesh_step_equals_one_process(self_runs, case):
    """The same seed on one process and on the mesh: the mesh draws the
    same weights (whole leaves, then its slices) and trains on the same
    tokens, under each remat policy's segments."""
    _, optimizer, accum, policy = case
    tc = port_trainer.TrainerConfig(
        model=dataclasses.replace(port_llama.TINY, dtype=torch.float32),
        global_batch_size=BATCH, seq_len=SEQ, optimizer=optimizer,
        remat=True, warmup_steps=1, accum_steps=accum, remat_policy=policy)
    tr = port_trainer.Trainer(tc, device='cpu')
    st = tr.init_state(seed=0)
    losses = []
    for toks in _tokens():
        st, m = tr.step(st, toks)
        losses.append(float(m['loss']))
    for out in self_runs:
        got = out[_case_key(case)]
        _close(got['losses'], losses, SELF_RTOL)
        _close(got['norm'], float(m['grad_norm']), SELF_RTOL)
    for w, g in zip(_leaves(port_optim.tree_map(
            lambda t: t.detach().numpy(), st['params'])),
            _leaves(self_runs[0][_case_key(case)]['params'])):
        _close(g, w, SELF_RTOL)


# -- the sharded optimizer -----------------------------------------------------

_OPT_BODY = '''
from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.train import optim
specs = {'w': sharding.NamedSharding(mesh, ('fsdp', None)),
         'norm': sharding.NamedSharding(mesh, (None,))}
for name in ('adafactor', 'adamw'):
    chain = (optim.adafactor(lambda c: 1e-2) if name == 'adafactor'
             else optim.adamw(lambda c: 1e-2, weight_decay=0.1))
    chain.shard(mesh, specs)
    params = {k: sharding.local_slice(torch.from_numpy(v), specs[k])
              for k, v in inputs['params'].items()}
    grads = {k: sharding.local_slice(torch.from_numpy(v), specs[k])
             for k, v in inputs['grads'].items()}
    state = chain.init(params)
    updates, _ = chain.update(grads, state, params)
    out[name] = {k: sharding.gather(updates[k], specs[k]).numpy()
                 for k in updates}
'''


def test_sharded_optimizer_equals_the_whole_leafs_update(tmp_path):
    """A [256, 128] leaf split over fsdp along dim 0 (its largest, the
    factored row dim d0) and a replicated norm leaf. Guards
    ``train/optim.py`` ``_sum_over`` (the factored means over d0 and d1
    and the row means' mean) and ``_block_means`` (clip_by_block_rms and
    the parameter-scale RMS): each taken over the rank's slice alone, the
    update differs from the whole leaf's by far more than OPT_TOL."""
    rng = np.random.default_rng(3)
    params = {'w': rng.standard_normal((256, 128)).astype(np.float32),
              'norm': rng.standard_normal((128,)).astype(np.float32)}
    # Rows of very different scale, so that local means differ.
    grads = {'w': (rng.standard_normal((256, 128))
                   * np.linspace(0.1, 10, 256)[:, None]).astype(np.float32),
             'norm': rng.standard_normal((128,)).astype(np.float32)}
    ranks = run_gang(tmp_path, 2, _OPT_BODY, spec={'fsdp': 2},
                     inputs={'params': params, 'grads': grads})
    assert port_optim.factored_dims((256, 128)) == (1, 0)
    for name in ('adafactor', 'adamw'):
        chain = (port_optim.adafactor(lambda c: 1e-2)
                 if name == 'adafactor'
                 else port_optim.adamw(lambda c: 1e-2, weight_decay=0.1))
        p = {k: torch.from_numpy(v) for k, v in params.items()}
        g = {k: torch.from_numpy(v) for k, v in grads.items()}
        want, _ = chain.update(g, chain.init(p), p)
        for out in ranks:
            for k in ('w', 'norm'):
                np.testing.assert_allclose(out[name][k], want[k].numpy(),
                                           rtol=OPT_TOL, atol=OPT_TOL * 1e-3)


# -- collectives through shared memory -----------------------------------------

_SHM_BODY = '''
import dataclasses
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.parallel import collectives as C
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.train import optim, trainer as trainer_lib

def run():
    g = torch.Generator().manual_seed(rank)
    # 3 MB past the first arena's 1 MB: the arena is made anew.
    xs = [torch.randn(5, 6, generator=g), torch.randn(4, 8, 3, generator=g),
          torch.randn(3 << 18, generator=g).to(torch.bfloat16)]
    res = {}
    for i, x in enumerate(xs):
        for axis in ('data', 'tensor'):
            res[f'psum{i}{axis}'] = C.psum(x, mesh, axis)
            res[f'pmax{i}{axis}'] = C.pmax(x, mesh, axis)
            res[f'gather{i}{axis}'] = C.all_gather(x, mesh, axis, 0)
            res[f'gather_last{i}{axis}'] = C.all_gather(x, mesh, axis, -1)
            res[f'ring{i}{axis}'] = C.ppermute_ring(x, mesh, axis)
            if x.shape[0] % 2 == 0:
                res[f'scatter{i}{axis}'] = C.reduce_scatter(x, mesh, axis, 0)
    cfg = dataclasses.replace(llama.TINY, dtype=torch.float32)
    tr = trainer_lib.Trainer(trainer_lib.TrainerConfig(
        model=cfg, global_batch_size=4, seq_len=128, warmup_steps=1),
        mesh=mesh)
    st = tr.init_state(seed=0)
    for toks in inputs['tokens']:
        st, m = tr.step(st, toks)
        res['loss'] = m['loss']
    res.update({f'param{i}': t for i, t in enumerate(
        optim.tree_leaves(tr.host_view(st, world)['params']))})
    return {k: v.float().numpy() for k, v in res.items()}

out['gloo'] = run()
# Ranks that share a card stage through the host's shared memory: forced
# here for CPU tensors.
mesh_lib.Mesh.stages_on_host = property(lambda self: True)
out['shared'] = run()
out['arenas'] = len(mesh.arenas)
'''


def test_collectives_through_shared_memory_equal_gloos(tmp_path):
    """The collectives of ranks that share a card (and so a host) go
    through an arena of shared host memory (``collectives._shared``):
    every collective and a training step give gloo's values."""
    ranks = run_gang(tmp_path, 4, _SHM_BODY,
                     spec={'data': 2, 'fsdp': 1, 'tensor': 2},
                     inputs={'tokens': _tokens()})
    for out in ranks:
        assert out['arenas'] >= 2  # one for each axis's group
        for key, want in out['gloo'].items():
            got = out['shared'][key]
            if key.startswith(('psum', 'scatter', 'loss', 'param')):
                # Sums in another order (float32 over one step each).
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                           err_msg=key)
            else:
                assert np.array_equal(got, want), key
