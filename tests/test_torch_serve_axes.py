"""The continuous engine on every mesh axis JAX serves on, against the JAX
package, on the CPU.

JAX's ``ContinuousEngine(mesh=)`` places weights and caches by its rules
table (``parallel/sharding.py``): ``batch -> (data, fsdp)``, ``embed ->
fsdp``, ``layers -> pipe``, ``seqlen -> seq``, ``expert -> expert``, and
the heads, mlp and vocab over ``tensor``. The port holds the same
layouts, one process per rank (``serve/spmd.SpmdEngine``):

- ``fsdp`` splits the slots with ``data`` (contiguous blocks, ``data``
  outermost) and the weights on their ``embed`` dim, each layer gathered
  over ``fsdp`` just before it runs;
- ``pipe`` gives each rank its block of the layers and of the KV cache,
  the hidden state going rank to rank in each forward;
- ``seq`` splits a prefill's positions, whose K/V are gathered over
  ``seq`` before the cache write; a decode step runs whole;
- ``expert`` gives each rank its experts, their outputs summed over
  ``expert`` before the one rounding.

Two gloo gangs (``test_torch_tp.run_gang``) run every port-side engine:
two ranks for the meshes of two devices, four for the others. The JAX
side runs in this process on the same meshes of virtual CPU devices,
while the gangs run. Float32 TINY and MOE_TINY weights come from JAX.
"""
import concurrent.futures
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from skypilot_tpu.models import engine as jax_engine
from skypilot_tpu.models import generate as jax_gen
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.models import quantization as jax_quant
from skypilot_tpu.parallel import mesh as jax_mesh
from skypilot_tpu.serve import disagg as jd

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_tp import _numpy_tree, run_gang  # noqa: E402
from test_torch_tp_data import (HEADS, SHARE_ROWS,  # noqa: E402
                                SLOT_ROWS, _binding_traffic, _drive, _one)

JAX_CFG = dataclasses.replace(jax_llama.TINY, dtype=jnp.float32)
MOE_JAX = dataclasses.replace(jax_llama.MOE_TINY, dtype=jnp.float32,
                              expert_capacity_factor=1.0)
LOGIT_TOL = 1e-4
SPEC_K = 3
ROLE_MAX_LEN = 96


def _spec(**axes):
    return dict(dict.fromkeys(('data', 'pipe', 'fsdp', 'seq', 'expert',
                               'tensor'), 1), **axes)


# Mesh name -> its axes. The MoE meshes serve MOE_TINY (4 experts, top 2).
DENSE = {'fsdp2': _spec(fsdp=2), 'fsdp2_tp2': _spec(fsdp=2, tensor=2),
         'data2_fsdp2': _spec(data=2, fsdp=2), 'pipe2': _spec(pipe=2),
         'pipe2_tp2': _spec(pipe=2, tensor=2),
         'seq2_tp2': _spec(seq=2, tensor=2)}
MOE_MESHES = {'expert2': _spec(expert=2),
              'expert2_tp2': _spec(expert=2, tensor=2),
              'fsdp2_expert2': _spec(fsdp=2, expert=2)}
MESHES = dict(DENSE, **MOE_MESHES)
# The meshes every option of the engine runs on: a draft, the prefix
# pool with chunked prefill, the KV tiers and the prefill/decode roles.
OPTION_MESHES = ('fsdp2_tp2', 'pipe2_tp2', 'seq2_tp2')

BASE = list(range(1, 17))
LONG = list(range(1, 41))
SCENARIOS = {
    'slot': dict(kw=dict(slots=4, max_len=64, chunk_steps=4),
                 rounds=[[_one(r, 5) for r in SLOT_ROWS]]),
    # Four rows at once, then share hits and a copy-on-write fork.
    'paged': dict(kw=dict(slots=4, max_len=64, chunk_steps=2,
                          kv_layout='paged', kv_tiers=False),
                  rounds=[[_one(r, 6) for r in SLOT_ROWS]] + [
                      [_one(r, 6)] for r in SHARE_ROWS]),
}
OPTIONS = {
    # The prefix pool (a row on each fsdp rank) and a 40-token prompt
    # prefilled 8 at a time (4 a seq rank), its third sighting seeded
    # from the pool.
    'prefix': dict(kw=dict(slots=4, max_len=64, chunk_steps=4,
                           prefix_slots=2, prefill_chunk=8),
                   rounds=[[_one(BASE + [40], 3)], [_one(BASE + [40], 3)],
                           [_one(LONG, 4)], [_one(LONG, 4)],
                           [_one(LONG, 4), _one([9, 8, 7], 6)]]),
    # A divergent draft: its verify window of k + 1 = 4 positions splits
    # over seq.
    'spec_slot': dict(kw=dict(slots=4, max_len=64, spec_k=SPEC_K),
                      rounds=[[_one(r, 6) for r in SLOT_ROWS]]),
    'spec_paged': dict(kw=dict(slots=2, max_len=64, spec_k=SPEC_K,
                               kv_layout='paged'),
                       rounds=[[_one(r, 6) for r in SLOT_ROWS[:3]]]),
}
MOE = {'moe_slot': dict(kw=dict(slots=16, max_len=64, chunk_steps=4),
                        rounds=[_binding_traffic()]),
       'moe_paged': dict(kw=dict(slots=16, max_len=64, chunk_steps=4,
                                 kv_layout='paged'),
                         rounds=[_binding_traffic()]),
       'moe_slot_kv8': dict(kw=dict(slots=16, max_len=64, chunk_steps=4,
                                    kv_quantize=True),
                            rounds=[_binding_traffic()])}
# test_torch_tp_data.py's tier rounds: five heads through 4 usable
# blocks and a host tier of one whole-head chain.
TIERS = dict(kw=dict(slots=4, max_len=64, chunk_steps=2, kv_layout='paged',
                     kv_blocks=5),
             rounds=[[_one(h + [5, 6, 7, 8], 6)] for h in HEADS] + [
                 [_one(HEADS[0] + [9, 9, 9], 6)]])
CASES = [([(7 * i) % 250 + 1 for i in range(13)], 12),
         ([(7 * i + 11) % 250 + 1 for i in range(33)], 16)]
# A padded prefill of 4 rows (one a rank of data=2,fsdp=2), then two
# decode steps.
PREFILL = np.asarray([[5, 6, 7, 8, 9, 10, 11, 12], [1, 2, 3, 4, 5, 0, 0, 0],
                      [9, 9, 8, 8, 7, 7, 0, 0], [3, 1, 4, 1, 5, 9, 2, 6]],
                     np.int32)
LENS = np.asarray([8, 5, 6, 8], np.int32)
STEPS = [np.asarray([3, 4, 5, 6], np.int32),
         np.asarray([7, 8, 9, 10], np.int32)]


def _plan(names):
    """Each mesh's engine runs: the layouts, and for the option meshes
    every option; MoE meshes the MoE runs."""
    plan = []
    for name in names:
        runs = sorted(MOE) if name in MOE_MESHES else sorted(SCENARIOS)
        if name in OPTION_MESHES:
            runs += sorted(OPTIONS) + ['tiers', 'roles']
        plan.append((name, MESHES[name], runs))
    return plan


_BODY = '''
import dataclasses, os
import numpy as np
from unittest import mock
from skypilot_tpu_torch.models import generate as gen_lib
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import quantization as quant_lib
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.serve import disagg as pd
from skypilot_tpu_torch.serve import llm_server, spmd

cfg = dataclasses.replace(llama.TINY, dtype=torch.float32)
moe_cfg = dataclasses.replace(llama.MOE_TINY, dtype=torch.float32,
                              expert_capacity_factor=1.0)
full = llama.params_from_numpy(inputs['params'], cfg, 'cpu')
draft = llama.params_from_numpy(inputs['draft'], cfg, 'cpu')
moe = llama.params_from_numpy(inputs['moe_params'], moe_cfg, 'cpu')

def shapes(eng):
    p = eng.params
    got = {'wq': tuple(p['layers']['wq'].shape),
           'embed': tuple(p['embed'].shape),
           'lm_head': tuple(p['lm_head'].shape),
           'cache': tuple(eng._cache.k.shape)}
    if 'moe' in p['layers']:
        got['we_gate'] = tuple(p['layers']['moe']['we_gate'].shape)
        got['router'] = tuple(p['layers']['moe']['router'].shape)
    return got

def engine_run(key, m, scenario, params, c, queued=False, env=None,
               **extra):
    os.environ.update(env or {})
    eng = spmd.SpmdEngine(params, c, mesh=m, device='cpu',
                          **dict(scenario['kw'], **extra))
    out[key + '_shapes'] = shapes(eng)
    if rank == 0:
        got = []
        for i, rnd in enumerate(scenario['rounds']):
            if queued and i == 0:
                with mock.patch.object(spmd.SpmdEngine, 'start',
                                       lambda self: None):
                    futs = [eng.submit(r, n, **s) for r, n, s in rnd]
                spmd.SpmdEngine.start(eng)
            else:
                futs = [eng.submit(r, n, **s) for r, n, s in rnd]
            got += [f.result(timeout=120) for f in futs]
            if eng._kv_tiers is not None:
                assert eng._kv_tiers.quiesce(30)
        out[key] = got
        st = eng.stats()
        out[key + '_pool_stats'] = dict(
            st['prefix_cache'], saved=st['prefill_tokens_saved'],
            chunks=st['prefill_chunks'])
        out[key + '_spec'] = st['speculative']
        out[key + '_tiers'] = (None if eng._kv_tiers is None
                               else eng._kv_tiers.stats())
        eng.stop()
    else:
        eng.start()
        eng._thread.join()
    out[key + '_state'] = llm_server._rank_engine_state(eng)
    out[key + '_digest'] = eng.sampled_digest
    out[key + '_blocks'] = eng.stats()['kv_blocks']
    if eng.kv_layout == 'paged':
        out[key + '_pool'] = [eng._cache.k.numpy().copy(),
                              eng._cache.v.numpy().copy()]
    for k in (env or {}):
        del os.environ[k]

def roles(key, m):
    for layout in ('slot', 'paged'):
        payloads = []
        for role in ('prefill', 'decode'):
            eng = spmd.SpmdEngine(full, cfg, slots=4, max_len=96,
                                  role=role, kv_layout=layout, mesh=m,
                                  device='cpu')
            if rank == 0:
                if role == 'prefill':
                    for row, n in inputs['cases']:
                        h = eng.submit_prefill(row, n).result(timeout=120)
                        payloads.append(pd.serialize_bytes(
                            h, pd.build_header(h, model='tiny',
                                               kv_cache='bf16')))
                    out[key + '_export_' + layout] = payloads
                else:
                    got = []
                    for data in payloads + inputs['jax_' + layout]:
                        header, arrays = pd.parse(data)
                        got.append(eng.submit_import(**pd.import_kwargs(
                            header, arrays)).result(timeout=120))
                    out[key + '_import_' + layout] = got
                eng.stop()
            else:
                eng.start()
                eng._thread.join()
            out[key + '_' + role + '_' + layout + '_state'] = \\
                llm_server._rank_engine_state(eng)

def logits_run(name, m, c, whole):
    params = quant_lib.shard_params(whole, c, m)
    rows = gen_lib.data_rows(m, 4)
    rows = slice(None) if rows is None else rows
    cache = gen_lib.init_cache(c, 4, 32, device='cpu', mesh=m)
    toks = torch.from_numpy(inputs['prefill'])[rows]
    lens = torch.from_numpy(inputs['lens'])[rows]
    logits, cache = gen_lib.forward_cached(params, toks, cache, c, lens,
                                           mesh=m)
    got = [logits.numpy()]
    for t in inputs['steps']:
        logits, cache = gen_lib.forward_cached(
            params, torch.from_numpy(t)[rows][:, None], cache, c,
            torch.ones((toks.shape[0],), dtype=torch.int32), mesh=m)
        got.append(logits.numpy())
    out[name + '_logits'] = (rows.start or 0, got)

for name, spec, runs in inputs['plan']:
    m = mesh_lib.build_mesh(mesh_lib.MeshSpec(**spec), device='cpu')
    out[name + '_coords'] = {a: m.axis_index(a) for a in m.axis_names}
    is_moe = 'moe_slot' in runs
    logits_run(name, m, moe_cfg if is_moe else cfg, moe if is_moe else full)
    for run in runs:
        key = name + ':' + run
        if run == 'roles':
            roles(key, m)
        elif run == 'tiers':
            engine_run(key, m, inputs['tiers'], full, cfg, env={
                'SKYTPU_KV_SPILL_DIR': os.path.join(tmp, 'spill-' + name),
                'SKYTPU_KV_HOST_BYTES': '8192'})
        elif run.startswith('moe'):
            engine_run(key, m, inputs['moe'][run], moe, moe_cfg,
                       queued=True)
        elif run.startswith('spec'):
            engine_run(key, m, inputs['options'][run], full, cfg,
                       draft_params=draft, draft_cfg=cfg)
        elif run in inputs['options']:
            engine_run(key, m, inputs['options'][run], full, cfg)
        else:
            engine_run(key, m, inputs['scenarios'][run], full, cfg)
'''


@pytest.fixture(scope='module')
def weights():
    return (jax_llama.init_params(jax.random.PRNGKey(0), JAX_CFG),
            jax_llama.init_params(jax.random.PRNGKey(99), JAX_CFG),
            jax_llama.init_params(jax.random.PRNGKey(7), MOE_JAX))


def _jax_mesh(name):
    spec = MESHES[name]
    n = int(np.prod(list(spec.values())))
    return jax_mesh.build_mesh(jax_mesh.MeshSpec(**spec),
                               devices=jax.devices()[:n])


def _jax_run(params, scenario, cfg=JAX_CFG, mesh=None, queued=False,
             **extra):
    eng = jax_engine.ContinuousEngine(params, cfg, mesh=mesh,
                                      **dict(scenario['kw'], **extra))
    if not queued:
        eng.start()
    try:
        got = _drive(eng, scenario, queued)
        st = eng.stats()
        return got, dict(st['prefix_cache'], saved=st['prefill_tokens_saved'],
                         chunks=st['prefill_chunks'])
    finally:
        eng.stop()


def _jax_logits(params, cfg, mesh):
    """JAX's forward_cached over weights placed on ``mesh``: the padded
    prefill's last-token logits, then two decode steps'."""
    placed = jax_quant.shard_params(params, cfg, mesh)
    cache = jax_gen.init_cache(cfg, 4, 32)
    logits, cache = jax_gen.forward_cached(
        placed, jnp.asarray(PREFILL), cache, cfg,
        row_lens=jnp.asarray(LENS))
    want = [np.asarray(logits)]
    for t in STEPS:
        logits, cache = jax_gen.forward_cached(
            placed, jnp.asarray(t)[:, None], cache, cfg,
            row_lens=jnp.ones((4,), jnp.int32))
        want.append(np.asarray(logits))
    return want


def _export(eng, row, n):
    h = eng.submit_prefill(row, n).result(timeout=300)
    return jd.serialize_bytes(h, jd.build_header(h, model='tiny',
                                                 kv_cache='bf16'))


def _jax_refs(weights):
    """Every JAX-side figure, on each mesh: the logits, each engine run's
    tokens, and the roles' payloads and tokens."""
    jp, dp, mp = weights
    refs = {}
    for name in MESHES:
        mesh = _jax_mesh(name)
        moe = name in MOE_MESHES
        refs[name + '_logits'] = _jax_logits(mp if moe else jp,
                                             MOE_JAX if moe else JAX_CFG,
                                             mesh)
        for run, sc in (MOE if moe else SCENARIOS).items():
            refs[name + ':' + run] = _jax_run(
                mp if moe else jp, sc, MOE_JAX if moe else JAX_CFG, mesh,
                queued=moe)
        if name not in OPTION_MESHES:
            continue
        for run, sc in OPTIONS.items():
            extra = (dict(draft_params=dp, draft_cfg=JAX_CFG)
                     if run.startswith('spec') else {})
            refs[name + ':' + run] = _jax_run(jp, sc, mesh=mesh, **extra)
    # The handoffs' colocated tokens and the tiers' rounds, on one device:
    # the roles' tests decode the port's payloads on JAX's engine on each
    # mesh, and the tiers do not depend on the mesh.
    for layout in ('slot', 'paged'):
        eng = jax_engine.ContinuousEngine(jp, JAX_CFG, slots=4,
                                          max_len=ROLE_MAX_LEN,
                                          kv_layout=layout)
        eng.start()
        try:
            refs['colocated_' + layout] = [
                list(eng.submit(r, n).result(timeout=300))
                for r, n in CASES]
        finally:
            eng.stop()
    return refs


@pytest.fixture(scope='module')
def world(tmp_path_factory, weights):
    """(JAX's figures, {mesh name: each rank's outputs}): the two gangs
    run while JAX computes its side in this process."""
    jp, dp, mp = weights
    # JAX's handoffs reach the port's decode replica of every option
    # mesh: the mesh does not change them (whole heads, JAX's format).
    payloads = {}
    for layout in ('slot', 'paged'):
        eng = jax_engine.ContinuousEngine(jp, JAX_CFG, slots=4,
                                          max_len=ROLE_MAX_LEN,
                                          role='prefill', kv_layout=layout)
        eng.start()
        try:
            payloads[layout] = [_export(eng, r, n) for r, n in CASES]
        finally:
            eng.stop()
    inputs = {'params': _numpy_tree(jp), 'draft': _numpy_tree(dp),
              'moe_params': _numpy_tree(mp), 'scenarios': SCENARIOS,
              'options': OPTIONS, 'moe': MOE, 'tiers': TIERS,
              'cases': CASES, 'prefill': PREFILL, 'lens': LENS,
              'steps': STEPS, 'jax_slot': payloads['slot'],
              'jax_paged': payloads['paged']}
    gangs = {2: [n for n, s in MESHES.items()
                 if np.prod(list(s.values())) == 2],
             4: [n for n, s in MESHES.items()
                 if np.prod(list(s.values())) == 4]}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futs = {size: pool.submit(
            run_gang, tmp_path_factory.mktemp(f'serve_axes{size}'), size,
            _BODY, spec={'fsdp': size},
            inputs=dict(inputs, plan=_plan(names)), timeout=480)
            for size, names in gangs.items()}
        refs = _jax_refs(weights)
        ranks = {size: f.result() for size, f in futs.items()}
    by_mesh = {name: ranks[size] for size, names in gangs.items()
               for name in names}
    return refs, by_mesh, payloads


def _agree(ranks, key):
    """Every rank took the same decisions and read the same tokens."""
    assert len({repr(r[key + '_state']) for r in ranks}) == 1
    assert len({r[key + '_digest'] for r in ranks}) == 1


@pytest.mark.parametrize('name', sorted(MESHES))
def test_logits_match_jax_on_the_mesh(world, name):
    """A padded prefill of 4 rows and two decode steps through
    ``forward_cached`` on the mesh (each rank its block of the rows where
    ``data`` and ``fsdp`` split them): float32 logits within 1e-4 of
    JAX's forward over weights placed on the same mesh, equal on the
    ranks that hold the same rows."""
    refs, by_mesh, _ = world
    want = refs[name + '_logits']
    for out in by_mesh[name]:
        start, got = out[name + '_logits']
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w[start:start + g.shape[0]],
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize('run', sorted(SCENARIOS))
@pytest.mark.parametrize('name', sorted(DENSE))
def test_greedy_tokens_equal_jax_on_the_mesh(world, name, run):
    """Four rows at once (the slot layout), or four at once and the
    share rows one at a time (the paged layout, with share hits and a
    copy-on-write fork): tokens equal JAX's engine on the same mesh,
    and every rank read the same tokens and took the same decisions."""
    refs, by_mesh, _ = world
    key = name + ':' + run
    want, _ = refs[key]
    ranks = by_mesh[name]
    assert ranks[0][key] == want
    _agree(ranks, key)
    if run == 'paged':
        hits, _, _, commits, _, forks = ranks[0][key + '_state']['share']
        assert hits >= 2 and commits >= 1 and forks >= 1
        for out in ranks:
            kb = out[key + '_blocks']
            assert kb['free'] + kb['cached'] == kb['usable']


@pytest.mark.parametrize('run', sorted(MOE))
@pytest.mark.parametrize('name', sorted(MOE_MESHES))
def test_moe_under_binding_capacity_matches_jax(world, name, run):
    """24 requests through 16 slots at capacity factor 1.0, slot and
    paged layouts, bf16 and int8 KV: on ``expert`` each rank runs its
    experts and their outputs are summed over ``expert``; on ``fsdp``
    the capacity and drop order are taken over both row blocks' tokens.
    Tokens equal JAX's engine on the same mesh token for token."""
    refs, by_mesh, _ = world
    key = name + ':' + run
    want, _ = refs[key]
    assert by_mesh[name][0][key] == want
    _agree(by_mesh[name], key)


def _slices(name):
    """What one rank of mesh ``name`` holds of each leaf and of the slot
    layout's cache: its layers (pipe), embed columns (fsdp), heads and
    vocab (tensor), experts (expert) and slots (data x fsdp)."""
    a = MESHES[name]
    cfg = MOE_JAX if name in MOE_MESHES else JAX_CFG
    L, d, v = cfg.n_layers // a['pipe'], cfg.d_model, cfg.vocab_size
    got = {'wq': (L, d // a['fsdp'], cfg.n_heads // a['tensor'],
                  cfg.head_dim),
           'embed': (v // a['tensor'], d // a['fsdp']),
           'lm_head': (d // a['fsdp'], v // a['tensor'])}
    slots = 16 if name in MOE_MESHES else 4
    got['cache'] = (L, slots // (a['data'] * a['fsdp']),
                    cfg.n_kv_heads // a['tensor'], 64, cfg.head_dim)
    if name in MOE_MESHES:
        got['we_gate'] = (L, cfg.num_experts // a['expert'],
                          d // a['fsdp'], cfg.d_ff // a['tensor'])
        got['router'] = (L, d // a['fsdp'], cfg.num_experts)
    return got


@pytest.mark.parametrize('name', sorted(MESHES))
def test_each_rank_holds_exactly_its_slices(world, name):
    """Every rank's weights and slot-layout cache are its slices by JAX's
    rules, and the ranks cover every coordinate of the mesh once."""
    _, by_mesh, _ = world
    run = 'moe_slot' if name in MOE_MESHES else 'slot'
    want = _slices(name)
    for out in by_mesh[name]:
        assert out[name + ':' + run + '_shapes'] == want
    coords = {tuple(sorted(out[name + '_coords'].items()))
              for out in by_mesh[name]}
    assert len(coords) == len(by_mesh[name])


def test_paged_pool_splits_its_layers_over_pipe(world):
    """The paged pool takes ``POOL_AXES``: on pipe=2,tensor=2 a rank holds
    one of the two layers and one of the two kv heads of every block."""
    _, by_mesh, _ = world
    for out in by_mesh['pipe2_tp2']:
        assert out['pipe2_tp2:paged_shapes']['cache'] == (
            1, 4 * 64 // 16 + 1, 1, 16, JAX_CFG.head_dim)


@pytest.mark.parametrize('run', sorted(OPTIONS))
@pytest.mark.parametrize('name', OPTION_MESHES)
def test_options_match_jax_on_the_mesh(world, name, run):
    """The prefix pool with chunked prefill, and a divergent draft (slot
    and paged targets) sharded like the target: tokens (and the pool's
    counts) equal JAX's engine on the same mesh, and every rank agrees."""
    refs, by_mesh, _ = world
    key = name + ':' + run
    want, stats = refs[key]
    ranks = by_mesh[name]
    assert ranks[0][key] == want
    _agree(ranks, key)
    if run == 'prefix':
        assert ranks[0][key + '_pool_stats'] == stats
        assert stats['hits'] >= 2 and stats['chunks'] >= 5
    else:
        assert ranks[0][key + '_spec']['rounds'] > 0


@pytest.mark.parametrize('name', OPTION_MESHES)
def test_tiers_demote_and_promote_on_the_mesh(world, weights, name,
                                              monkeypatch, tmp_path):
    """The KV tiers' rounds: demotes gather every rank's layers and heads
    to the head, promotes scatter them back and broadcast them over the
    other axes. Tokens equal JAX's single-device engine (the tiers do not
    depend on the mesh) and every rank took the same decisions."""
    monkeypatch.setenv('SKYTPU_KV_SPILL_DIR', str(tmp_path / 'spill'))
    monkeypatch.setenv('SKYTPU_KV_HOST_BYTES', '8192')
    refs, by_mesh, _ = world
    if 'tiers' not in refs:
        refs['tiers'] = _jax_run(weights[0], TIERS)[0]
    want = refs['tiers']
    key = name + ':tiers'
    ranks = by_mesh[name]
    assert ranks[0][key] == want
    _agree(ranks, key)
    tiers = ranks[0][key + '_tiers']
    assert tiers['demotes'] >= 1 and tiers['promotes'] >= 1, tiers
    evicted, promoted, _, _ = ranks[0][key + '_state']['tier_counts']
    assert evicted >= 1 and promoted >= 1


@pytest.mark.parametrize('layout', ['slot', 'paged'])
@pytest.mark.parametrize('name', OPTION_MESHES)
def test_roles_hand_off_on_the_mesh(world, weights, name, layout):
    """A prefill replica on the mesh exports whole layers and heads, JAX's
    format: JAX's decode engine on the same mesh decodes them to JAX's
    colocated tokens. A decode replica of the port on the mesh imports
    its own payloads and JAX's, to the same tokens."""
    refs, by_mesh, _ = world
    want = refs['colocated_' + layout]
    out = by_mesh[name][0]
    assert out[name + ':roles_import_' + layout] == want * 2
    exported = out[name + ':roles_export_' + layout]
    for data in exported:
        header, arrays = jd.parse(data)
        assert arrays['k'].shape[0] == JAX_CFG.n_layers
        assert arrays['k'].shape[2] == JAX_CFG.n_kv_heads
    eng = jax_engine.ContinuousEngine(weights[0], JAX_CFG, slots=4,
                                      max_len=ROLE_MAX_LEN, role='decode',
                                      kv_layout=layout,
                                      mesh=_jax_mesh(name))
    eng.start()
    try:
        got = []
        for data in exported:
            header, arrays = jd.parse(data)
            got.append(list(eng.submit_import(
                **jd.import_kwargs(header, arrays)).result(timeout=300)))
    finally:
        eng.stop()
    assert got == want
    for role in ('prefill', 'decode'):
        assert len({repr(r[name + ':roles_' + role + '_' + layout
                           + '_state']) for r in by_mesh[name]}) == 1
