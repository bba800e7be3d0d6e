"""Speculative rounds on a tensor-parallel replica of the port, against
the JAX package, on the CPU.

One gang of two gloo ranks (``test_torch_tp.run_gang``) runs every
port-side engine of this file: ``serve/spmd.SpmdEngine`` with a draft
sharded by the target's rules (float32 TINY weights carried over from
JAX), both forwards of a round sharded and the decode kernel's plain
version per head shard, the draft's included. The JAX side runs in this
process on a ``tensor=2`` mesh of the virtual CPU devices
(``test_engine_spec.py:229``) and on one device.

Acceptance, rollback and sampling are functions of logits that every
rank holds whole, so both ranks' speculative counters must be equal, and
equal to JAX's where the requests arrive one at a time (admission groups
do not then depend on timing).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from skypilot_tpu.models import engine as jax_engine
from skypilot_tpu.models import generate as jax_gen
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.parallel import mesh as jax_mesh
from test_torch_tp import _numpy_tree, run_gang

JAX_CFG = dataclasses.replace(jax_llama.TINY, dtype=jnp.float32)
TP_ROWS = [[5, 6, 7], [8, 9, 10, 11]]              # test_engine_spec.py:240
REUSE_ROWS = [[5, 6, 7], [8, 9, 10, 11], [12, 13, 14]]  # :277, slots 2
IDENTICAL_ROW = [5, 6, 7, 8]                       # :263, 9 new
SPEC_K = 3

_BODY = '''
import dataclasses
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.serve import llm_server, spmd

cfg = dataclasses.replace(llama.TINY, dtype=torch.float32)
target = llama.params_from_numpy(inputs['target'], cfg, 'cpu')
draft = llama.params_from_numpy(inputs['draft'], cfg, 'cpu')

def engine_run(name, rows, n, d_params, together=False, **kw):
    eng = spmd.SpmdEngine(target, cfg, max_len=64, spec_k=inputs['k'],
                          draft_params=d_params, draft_cfg=cfg, mesh=mesh,
                          device='cpu', **kw)
    out[name + '_draft_heads'] = eng.draft_params['layers']['wk'].shape[2]
    out[name + '_cache_heads'] = eng._d_cache.k.shape[2]
    if rank == 0:
        if together:
            futs = [eng.submit(r, n) for r in rows]
            out[name] = [f.result(timeout=120) for f in futs]
        else:
            out[name] = [eng.submit(r, n).result(timeout=120) for r in rows]
        out[name + '_spec'] = eng.stats()['speculative']
        eng.stop()
    else:
        eng.start()
        eng._thread.join()
    out[name + '_state'] = llm_server._rank_engine_state(eng)

engine_run('together', inputs['tp_rows'], 6, draft, together=True, slots=4)
engine_run('serial', inputs['tp_rows'], 6, draft, slots=4)
engine_run('reuse', inputs['reuse_rows'], 6, draft, together=True, slots=2,
           kv_layout='paged')
engine_run('identical', [inputs['identical_row']], 9, target, slots=4,
           kv_layout='paged')
'''


@pytest.fixture(scope='module')
def weights():
    return (jax_llama.init_params(jax.random.PRNGKey(0), JAX_CFG),
            jax_llama.init_params(jax.random.PRNGKey(99), JAX_CFG))


@pytest.fixture(scope='module')
def gang(tmp_path_factory, weights):
    target, draft = weights
    inputs = {'target': _numpy_tree(target), 'draft': _numpy_tree(draft),
              'k': SPEC_K, 'tp_rows': TP_ROWS, 'reuse_rows': REUSE_ROWS,
              'identical_row': IDENTICAL_ROW}
    return run_gang(tmp_path_factory.mktemp('tp_spec'), 2, _BODY,
                    inputs=inputs)


def _solo(params, row, n):
    out = jax_gen.generate(params, JAX_CFG, jnp.asarray([row], jnp.int32),
                           max_new_tokens=n, max_len=64)
    return np.asarray(out[0]).tolist()


def _jax_run(target, draft, rows, n, mesh=True, together=False, **kw):
    if mesh:
        kw['mesh'] = jax_mesh.build_mesh(
            jax_mesh.MeshSpec(fsdp=1, tensor=2), devices=jax.devices()[:2])
    eng = jax_engine.ContinuousEngine(target, JAX_CFG, max_len=64,
                                      spec_k=SPEC_K, draft_params=draft,
                                      draft_cfg=JAX_CFG, **kw)
    eng.start()
    try:
        if together:
            futs = [eng.submit(r, n) for r in rows]
            got = [f.result(timeout=300) for f in futs]
        else:
            got = [eng.submit(r, n).result(timeout=300) for r in rows]
        return got, eng.stats()['speculative']
    finally:
        eng.stop()


def _spec(st):
    return {k: st[k] for k in ('k', 'rounds', 'proposals', 'accepted',
                               'acceptance_rate')}


def _ranks_agree(outs, name):
    assert outs[0][name + '_state'] == outs[1][name + '_state']
    for out in outs:
        # The draft's kv heads split over tensor like the target's.
        assert out[name + '_draft_heads'] == JAX_CFG.n_kv_heads // 2
        assert out[name + '_cache_heads'] == JAX_CFG.n_kv_heads // 2


def test_spec_tensor_parallel_matches_jax_tensor2(gang, weights):
    """test_engine_spec.py:229 on the port's gang: a divergent draft
    sharded like the target, two rows at once; tokens equal JAX's
    engine on tensor=2 and the solo generation."""
    target, draft = weights
    want, _ = _jax_run(target, draft, TP_ROWS, 6, together=True, slots=4)
    assert gang[0]['together'] == want == [
        _solo(target, r, 6) for r in TP_ROWS]
    _ranks_agree(gang, 'together')
    assert gang[0]['together_spec']['rounds'] > 0


def test_spec_stats_under_tp_equal_jax(gang, weights):
    """The rows one at a time: the rounds, proposals and acceptances of
    the port's tp 2 replica equal JAX's tensor=2 engine's, and both
    ranks count the same."""
    target, draft = weights
    want, st = _jax_run(target, draft, TP_ROWS, 6, slots=4)
    assert gang[0]['serial'] == want
    assert _spec(gang[0]['serial_spec']) == _spec(st)
    _ranks_agree(gang, 'serial')
    assert gang[0]['serial_state']['speculative'] == [
        st['rounds'], st['proposals'], st['accepted']]


def test_spec_paged_under_tp_with_slot_reuse(gang, weights):
    """test_engine_spec.py:276 under tp 2: the verify is a multi-token
    paged forward over the sharded pool; three rows through two slots
    equal the solo generation and JAX's single-device engine."""
    target, draft = weights
    want, _ = _jax_run(target, draft, REUSE_ROWS, 6, mesh=False,
                       together=True, slots=2, kv_layout='paged')
    assert gang[0]['reuse'] == want == [
        _solo(target, r, 6) for r in REUSE_ROWS]
    _ranks_agree(gang, 'reuse')


def test_identical_draft_paged_tp_accepts_everything(gang, weights):
    """test_engine_spec.py:258: the target as its own draft, paged, under
    tp 2: every proposal accepted, byte-exact against the solo
    generation."""
    target, _ = weights
    assert gang[0]['identical'] == [_solo(target, IDENTICAL_ROW, 9)]
    st = gang[0]['identical_spec']
    assert st['acceptance_rate'] == 1.0 and st['proposals'] > 0
    _ranks_agree(gang, 'identical')
