"""The continuous engine on a ``data x tensor`` mesh, against the JAX
package, on the CPU.

One gang of four gloo ranks (``test_torch_tp.run_gang``, ``data=2,
tensor=2``) runs every port-side engine of this file:
``serve/spmd.SpmdEngine`` over float32 TINY weights carried over from
JAX. The weights split over ``tensor`` and are whole over ``data``. The
slot layout's cache, the prefix pool and the draft's cache split their
rows over ``data`` (JAX's ``batch -> data``), each rank holding half the
slots of half the kv heads; the paged pool is whole over ``data``, so
its copies on the two data ranks of one tensor index must stay equal bit
for bit. The JAX side runs in this process: its engine on a ``data=2,
tensor=2`` mesh of four virtual CPU devices (``test_engine.py:156``),
and its single-device engine where the answer does not depend on the
mesh (the KV tiers). The port's own single-device engine is the
reference for sampled rows, whose noise comes from the generator.

Every scenario but the KV tiers' runs again through the shared-memory
arena (``Mesh.stages_on_host``), as ranks that share a card exchange
their data.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import engine as jax_engine
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.parallel import mesh as jax_mesh
from skypilot_tpu.serve import disagg as jd
from skypilot_tpu_torch.models import engine as port_engine
from skypilot_tpu_torch.models import llama as port_llama
from skypilot_tpu_torch.serve import disagg as pd
from test_torch_tp import _numpy_tree, run_gang

JAX_CFG = dataclasses.replace(jax_llama.TINY, dtype=jnp.float32)
PORT_CFG = dataclasses.replace(port_llama.TINY, dtype=torch.float32)
MOE_JAX = dataclasses.replace(jax_llama.MOE_TINY, dtype=jnp.float32,
                              expert_capacity_factor=1.0)
SPEC = {'data': 2, 'fsdp': 1, 'tensor': 2}


def _one(row, n, **sampling):
    return (list(row), n, sampling)


# Heads of 24 tokens (a full block and a half), as test_torch_kv_tiers.py.
HEADS = [[((17 * h + j) % 250) + 1 for j in range(24)] for h in range(5)]
SHARE_ROWS = [HEADS[0] + HEADS[1][:10], HEADS[0] + [3, 4, 5], HEADS[1] + [6],
              HEADS[0] + HEADS[1][:4] + [7]]
# test_engine.py:178: four rows at once, 5 new, through 4 slots.
SLOT_ROWS = [[5, 6, 7], [9, 8, 7, 6], [1, 2], [3, 4, 5, 6, 7]]
BASE = list(range(1, 17))
LONG = list(range(1, 41))
# Each scenario: engine kwargs and rounds of (row, max_new, sampling)
# submitted together, a round's answers read before the next is sent.
SCENARIOS = {
    'slot': dict(kw=dict(slots=4, max_len=64, chunk_steps=4),
                 rounds=[[_one(r, 5) for r in SLOT_ROWS]]),
    # The pool's two rows land on the two data ranks; the 40-token prompt
    # prefills 8 at a time, its third sighting seeded from the pool.
    'prefix': dict(kw=dict(slots=4, max_len=64, chunk_steps=4,
                           prefix_slots=2, prefill_chunk=8),
                   rounds=[[_one(BASE + [40], 3)], [_one(BASE + [40], 3)],
                           [_one(BASE + [50 + i, 60 + i], 6)
                            for i in range(3)],
                           [_one(LONG, 4)], [_one(LONG, 4)],
                           [_one(LONG, 4), _one([9, 8, 7], 6)]]),
    # Four rows at once, then test_torch_tp_paged.py's share rows one at
    # a time: share hits and a copy-on-write fork.
    'paged': dict(kw=dict(slots=4, max_len=64, chunk_steps=2,
                          kv_layout='paged', kv_tiers=False),
                  rounds=[[_one(r, 6) for r in SLOT_ROWS]] + [
                      [_one(r, 6)] for r in SHARE_ROWS]),
}
# Sampled rows, every request queued before the first iteration: against
# the port's single-device engine of the same seed.
SAMPLED = dict(kw=dict(slots=4, max_len=64, chunk_steps=4, seed=11),
               rounds=[[_one([5, 6, 7], 8, temperature=0.8, top_k=5),
                        _one([9, 8, 7, 6], 8, temperature=1.0, top_p=0.9),
                        _one([1, 2], 8, temperature=0.7),
                        _one([3, 4, 5, 6, 7], 8),
                        _one([11, 12, 13], 8, temperature=1.2, top_k=20,
                             top_p=0.8)]])
# test_torch_tp_paged.py's tier rounds: five heads of 24 tokens through 4
# usable blocks and a host tier of one whole-head chain.
FETCH_ROUNDS = [[_one(h + [5, 6, 7, 8], 6)] for h in HEADS] + [
    [_one(HEADS[0] + [9, 9, 9], 6)]]
TIERS = dict(kw=dict(slots=4, max_len=64, chunk_steps=2, kv_layout='paged',
                     kv_blocks=5), rounds=FETCH_ROUNDS)


def _binding_traffic(seed=3, n=24):
    """test_torch_tp_moe.py's: prompts of 2-13 tokens, max_new 2-9."""
    rng = np.random.default_rng(seed)
    return [_one(rng.integers(0, 256, int(rng.integers(2, 14))).tolist(),
                 int(rng.integers(2, 10))) for _ in range(n)]


MOE = {layout: dict(kw=dict(slots=16, max_len=64, chunk_steps=4,
                            kv_layout=layout),
                    rounds=[_binding_traffic()])
       for layout in ('slot', 'paged')}
SPEC_K = 3
DRAFT = {'spec_slot': dict(kw=dict(slots=4, max_len=64, spec_k=SPEC_K),
                           rounds=[[_one(r, 6) for r in SLOT_ROWS]]),
         'spec_paged': dict(kw=dict(slots=2, max_len=64, spec_k=SPEC_K,
                                    kv_layout='paged'),
                            rounds=[[_one(r, 6) for r in SLOT_ROWS[:3]]])}
ROLE_MAX_LEN = 96


def _row(n, salt=0):
    return [(7 * i + 11 * salt) % 250 + 1 for i in range(n)]


CASES = [(_row(13, 0), 12), (_row(33, 1), 16), (_row(1, 2), 8)]

_BODY = '''
import dataclasses, os
import numpy as np
from unittest import mock
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.serve import disagg as pd
from skypilot_tpu_torch.serve import llm_server, spmd

cfg = dataclasses.replace(llama.TINY, dtype=torch.float32)
full = llama.params_from_numpy(inputs['params'], cfg, 'cpu')
draft = llama.params_from_numpy(inputs['draft'], cfg, 'cpu')
moe_cfg = dataclasses.replace(llama.MOE_TINY, dtype=torch.float32,
                              expert_capacity_factor=1.0)
moe = llama.params_from_numpy(inputs['moe_params'], moe_cfg, 'cpu')

def engine_run(name, scenario, params=full, c=cfg, queued=False, env=None,
               **extra):
    os.environ.update(env or {})
    eng = spmd.SpmdEngine(params, c, mesh=mesh, device='cpu',
                          **dict(scenario['kw'], **extra))
    out[name + '_cache'] = tuple(eng._cache.k.shape)
    if eng._d_cache is not None:
        out[name + '_draft_cache'] = tuple(eng._d_cache.k.shape)
    if eng._prefix_pool is not None:
        out[name + '_prefix_pool'] = tuple(eng._prefix_pool.k.shape)
    if rank == 0:
        got = []
        for i, rnd in enumerate(scenario['rounds']):
            if queued and i == 0:
                # Queued before the first arrival broadcast, so the first
                # admission sees them all.
                with mock.patch.object(spmd.SpmdEngine, 'start',
                                       lambda self: None):
                    futs = [eng.submit(r, n, **s) for r, n, s in rnd]
                spmd.SpmdEngine.start(eng)
            else:
                futs = [eng.submit(r, n, **s) for r, n, s in rnd]
            got += [f.result(timeout=120) for f in futs]
            if eng._kv_tiers is not None:
                assert eng._kv_tiers.quiesce(30)
        out[name] = got
        st = eng.stats()
        out[name + '_pool_stats'] = dict(
            st['prefix_cache'], saved=st['prefill_tokens_saved'],
            chunks=st['prefill_chunks'])
        out[name + '_spec'] = st['speculative']
        out[name + '_tiers'] = (None if eng._kv_tiers is None
                                else eng._kv_tiers.stats())
        eng.stop()
    else:
        eng.start()
        eng._thread.join()
        out[name + '_tiers'] = eng._kv_tiers
    out[name + '_state'] = llm_server._rank_engine_state(eng)
    out[name + '_digest'] = eng.sampled_digest
    out[name + '_blocks'] = eng.stats()['kv_blocks']
    if eng.kv_layout == 'paged':
        out[name + '_pool'] = [eng._cache.k.float().numpy().copy(),
                               eng._cache.v.float().numpy().copy()]
    for k in (env or {}):
        del os.environ[k]

def all_scenarios(prefix):
    for name, sc in inputs['scenarios'].items():
        engine_run(prefix + name, sc)
    engine_run(prefix + 'sampled', inputs['sampled'], queued=True)
    for layout, sc in inputs['moe_scenarios'].items():
        engine_run(prefix + 'moe_' + layout, sc, params=moe, c=moe_cfg,
                   queued=True)
    for name, sc in inputs['draft_scenarios'].items():
        engine_run(prefix + name, sc, draft_params=draft, draft_cfg=cfg)

def roles(prefix):
    for layout in ('slot', 'paged'):
        payloads = []
        def export(eng):
            for row, n in inputs['cases']:
                h = eng.submit_prefill(row, n).result(timeout=120)
                payloads.append(pd.serialize_bytes(h, pd.build_header(
                    h, model='tiny', kv_cache='bf16')))
        def imports(eng, datas):
            got = []
            for data in datas:
                header, arrays = pd.parse(data)
                got.append(eng.submit_import(**pd.import_kwargs(
                    header, arrays)).result(timeout=120))
            return got
        for role in ('prefill', 'decode'):
            eng = spmd.SpmdEngine(full, cfg, slots=4, max_len=96, role=role,
                                  kv_layout=layout, mesh=mesh,
                                  device='cpu')
            if rank == 0:
                if role == 'prefill':
                    export(eng)
                    out[prefix + 'export_' + layout] = payloads
                else:
                    out[prefix + 'import_' + layout] = imports(
                        eng, payloads + inputs['jax_' + layout])
                eng.stop()
            else:
                eng.start()
                eng._thread.join()
            out[prefix + role + '_' + layout + '_state'] = \\
                llm_server._rank_engine_state(eng)

all_scenarios('')
roles('')
fetch_env = {'SKYTPU_KV_SPILL_DIR': os.path.join(tmp, 'spill'),
             'SKYTPU_KV_HOST_BYTES': '8192'}
engine_run('tiers', inputs['tiers'], env=fetch_env)
# Through the arena, as ranks that share a card exchange their data.
mesh_lib.Mesh.stages_on_host = property(lambda self: True)
all_scenarios('arena_')
roles('arena_')
engine_run('arena_tiers', inputs['tiers'], env=dict(
    fetch_env, SKYTPU_KV_SPILL_DIR=os.path.join(tmp, 'spill-arena')))
out['arenas'] = sorted(mesh.arenas)
out['coords'] = (mesh.axis_index('data'), mesh.axis_index('tensor'))
'''


@pytest.fixture(scope='module')
def weights():
    jp = jax_llama.init_params(jax.random.PRNGKey(0), JAX_CFG)
    return (jp, jax_llama.init_params(jax.random.PRNGKey(99), JAX_CFG),
            jax_llama.init_params(jax.random.PRNGKey(7), MOE_JAX))


def _jax_mesh():
    return jax_mesh.build_mesh(jax_mesh.MeshSpec(**SPEC),
                               devices=jax.devices()[:4])


def _drive(eng, scenario, queued=False):
    """The gang head's rounds on an engine of this process (started by
    the caller unless ``queued``: then the first round is queued before
    the loop starts, and the loop starts here)."""
    got = []
    for i, rnd in enumerate(scenario['rounds']):
        if queued and i == 0:
            with mock.patch.object(type(eng), 'start', lambda self: None):
                futs = [eng.submit(r, n, **s) for r, n, s in rnd]
            type(eng).start(eng)
        else:
            futs = [eng.submit(r, n, **s) for r, n, s in rnd]
        got += [list(f.result(timeout=300)) for f in futs]
    return got


def _pool_stats(eng):
    st = eng.stats()
    return dict(st['prefix_cache'], saved=st['prefill_tokens_saved'],
                chunks=st['prefill_chunks'])


def _jax_run(params, scenario, cfg=JAX_CFG, mesh=True, queued=False,
             **extra):
    eng = jax_engine.ContinuousEngine(
        params, cfg, mesh=_jax_mesh() if mesh else None,
        **dict(scenario['kw'], **extra))
    if not queued:
        eng.start()
    try:
        got = _drive(eng, scenario, queued)
        return got, _pool_stats(eng), eng.stats()['speculative']
    finally:
        eng.stop()


def _port_run(params, scenario, cfg=PORT_CFG, queued=False):
    eng = port_engine.ContinuousEngine(params, cfg, device='cpu',
                                       **scenario['kw'])
    if not queued:
        eng.start()
    try:
        return _drive(eng, scenario, queued)
    finally:
        eng.stop()


@pytest.fixture(scope='module')
def world(tmp_path_factory, weights):
    """JAX's payloads for the roles, then the gang."""
    jp, dp, mp = weights
    inputs = {'params': _numpy_tree(jp), 'draft': _numpy_tree(dp),
              'moe_params': _numpy_tree(mp), 'scenarios': SCENARIOS,
              'sampled': SAMPLED, 'moe_scenarios': MOE,
              'draft_scenarios': DRAFT, 'tiers': TIERS, 'cases': CASES}
    for layout in ('slot', 'paged'):
        eng = jax_engine.ContinuousEngine(jp, JAX_CFG, slots=4,
                                          max_len=ROLE_MAX_LEN,
                                          role='prefill', kv_layout=layout,
                                          mesh=_jax_mesh())
        eng.start()
        try:
            inputs['jax_' + layout] = [_export(jd, eng, r, n)
                                       for r, n in CASES]
        finally:
            eng.stop()
    return run_gang(tmp_path_factory.mktemp('tp_data'), 4, _BODY,
                    spec=SPEC, inputs=inputs)


def _export(pkg, eng, row, n):
    h = eng.submit_prefill(row, n).result(timeout=300)
    return pkg.serialize_bytes(h, pkg.build_header(h, model='tiny',
                                                   kv_cache='bf16'))


_REFS = {}


def _jax_ref(weights, name):
    """JAX's engine on data=2,tensor=2 for scenario ``name`` (once)."""
    if name not in _REFS:
        jp, dp, mp = weights
        if name in SCENARIOS:
            _REFS[name] = _jax_run(jp, SCENARIOS[name])
        elif name.startswith('moe_'):
            _REFS[name] = _jax_run(mp, MOE[name[4:]], cfg=MOE_JAX,
                                   queued=True)
        else:
            _REFS[name] = _jax_run(jp, DRAFT[name], draft_params=dp,
                                   draft_cfg=JAX_CFG)
    return _REFS[name]


def _port_weights(weights):
    return port_llama.params_from_numpy(
        jax.tree.map(np.asarray, weights[0]), PORT_CFG, 'cpu')


def _agree(ranks, name):
    """Every rank took the same decisions and read the same tokens."""
    assert len({repr(r[name + '_state']) for r in ranks}) == 1
    assert len({r[name + '_digest'] for r in ranks}) == 1


ROUTES = ['', 'arena_']


@pytest.mark.parametrize('route', ROUTES)
def test_slot_layout_matches_jax_data2_tensor2_and_tp1(world, weights,
                                                       route):
    """test_engine.py:156 on the port's gang: four rows at once through
    four slots split two a data rank; tokens equal JAX's engine on
    data=2,tensor=2 and the port's single-device engine."""
    want, _, _ = _jax_ref(weights, 'slot')
    tp1 = _port_run(_port_weights(weights), SCENARIOS['slot'])
    assert world[0][route + 'slot'] == want == tp1
    _agree(world, route + 'slot')


def test_each_rank_holds_its_block_of_the_slots(world):
    """A slot-layout rank holds slots/2 rows of kv_heads/2 heads (a
    quarter of one device's cache), as do the prefix pool and the draft's
    cache; the paged pool is whole over data, split on kv heads."""
    L, hkv, d = JAX_CFG.n_layers, JAX_CFG.n_kv_heads, JAX_CFG.head_dim
    for out in world:
        assert out['slot_cache'] == (L, 2, hkv // 2, 64, d)
        assert out['prefix_prefix_pool'] == (L, 1, hkv // 2, 64, d)
        assert out['spec_slot_draft_cache'] == (L, 2, hkv // 2, 64, d)
        assert out['spec_paged_draft_cache'] == (L, 1, hkv // 2, 64, d)
        assert out['paged_cache'] == (L, 4 * 64 // 16 + 1, hkv // 2, 16, d)
    assert sorted(out['coords'] for out in world) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert world[0]['arenas'] == ['data', 'tensor']


@pytest.mark.parametrize('route', ROUTES)
def test_prefix_pool_and_chunked_prefill_match_jax(world, weights, route):
    """The prefix pool's rows on both data ranks (stores, hits gathered
    from the rank that holds them) and a 40-token prompt chunked 8 at a
    time, its third sighting seeded from the pool: tokens and the pool's
    counts equal JAX's engine on data=2,tensor=2."""
    want, stats, _ = _jax_ref(weights, 'prefix')
    assert world[0][route + 'prefix'] == want
    assert world[0][route + 'prefix_pool_stats'] == stats
    assert stats['hits'] >= 4 and stats['stores'] >= 2
    _agree(world, route + 'prefix')


@pytest.mark.parametrize('route', ROUTES)
def test_sampled_rows_equal_the_single_device_engine(world, weights, route):
    """Top-k, top-p and temperature rows with one seed: every rank draws
    the whole batch's noise and keeps its block's, so the tokens equal
    the port's single-device engine of the same seed, and every rank
    read the same tokens."""
    tp1 = _port_run(_port_weights(weights), SAMPLED, queued=True)
    assert world[0][route + 'sampled'] == tp1
    _agree(world, route + 'sampled')


def _pools_equal_over_data(ranks, name):
    """The two data ranks of each tensor index hold the same pool."""
    by_tensor = {}
    for out in ranks:
        by_tensor.setdefault(out['coords'][1], []).append(out[name + '_pool'])
    for pools in by_tensor.values():
        assert len(pools) == 2
        for a, b in zip(*pools):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('route', ROUTES)
def test_paged_sharing_matches_jax_and_pools_agree(world, weights, route):
    """The paged layout with block sharing on data=2,tensor=2: tokens
    equal JAX's engine on the same mesh, share hits and a copy-on-write
    fork happened, every block came back, and the pool is the same bits
    on both data ranks of each tensor index."""
    want, _, _ = _jax_ref(weights, 'paged')
    name = route + 'paged'
    assert world[0][name] == want
    _agree(world, name)
    hits, _, _, commits, _, forks = world[0][name + '_state']['share']
    assert hits >= 2 and commits >= 1 and forks >= 1
    for out in world:
        kb = out[name + '_blocks']
        assert kb['free'] + kb['cached'] == kb['usable']
    _pools_equal_over_data(world, name)


@pytest.mark.parametrize('route', ROUTES)
def test_tiers_demote_spill_fetch_promote_like_jax(world, weights, route,
                                                   monkeypatch, tmp_path):
    """test_torch_tp_paged.py's tier rounds on data=2,tensor=2: demotes
    gathered to the head from data index 0's tensor group, promotes
    scattered there and broadcast over data. Tokens equal JAX's
    single-device engine (the tiers do not depend on the mesh), the
    accounts and tier decisions are equal on every rank, and each tensor
    index's pools are equal across data."""
    monkeypatch.setenv('SKYTPU_KV_SPILL_DIR', str(tmp_path / 'spill'))
    monkeypatch.setenv('SKYTPU_KV_HOST_BYTES', '8192')
    want, _, _ = _jax_run(weights[0], TIERS, mesh=False)
    name = route + 'tiers'
    assert world[0][name] == want
    _agree(world, name)
    tiers = world[0][name + '_tiers']
    assert tiers['demotes'] >= 1 and tiers['promotes'] >= 1, tiers
    assert tiers['fetches'] >= 1 and tiers['corrupt'] == 0, tiers
    evicted, promoted, parked, fetched = world[0][name + '_state'][
        'tier_counts']
    assert evicted >= 1 and promoted >= 1 and parked >= 1 and fetched >= 1
    assert all(out[name + '_tiers'] is None for out in world[1:])
    _pools_equal_over_data(world, name)


@pytest.mark.parametrize('route', ROUTES)
@pytest.mark.parametrize('layout', ['slot', 'paged'])
def test_moe_under_binding_capacity_matches_jax(world, weights, layout,
                                                route):
    """24 requests through 16 slots (8 a data rank) at capacity factor
    1.0: the capacity and drop order are taken over both data ranks'
    tokens, so the port equals JAX's engine on data=2,tensor=2 token for
    token."""
    want, _, _ = _jax_ref(weights, 'moe_' + layout)
    assert world[0][route + 'moe_' + layout] == want
    _agree(world, route + 'moe_' + layout)


@pytest.mark.parametrize('route', ROUTES)
@pytest.mark.parametrize('name', sorted(DRAFT))
def test_draft_rounds_match_jax(world, weights, name, route):
    """A divergent draft sharded like the target, its dense cache split
    over data: the rounds' tokens equal JAX's engine on data=2,tensor=2,
    rounds ran, and every rank took the same verdicts."""
    want, _, _ = _jax_ref(weights, name)
    assert world[0][route + name] == want
    assert world[0][route + name + '_spec']['rounds'] > 0
    _agree(world, route + name)


@pytest.mark.parametrize('route', ROUTES)
@pytest.mark.parametrize('layout', ['slot', 'paged'])
def test_roles_hand_off_on_data_mesh(world, weights, layout, route):
    """A prefill replica on data=2,tensor=2 exports JAX's format with
    whole heads; a decode replica on the same mesh imports its payloads
    and JAX's (data=2,tensor=2 prefill) into its slots on either data
    rank, and decodes JAX's colocated tokens. The port's payloads also
    decode on JAX's decode engine."""
    jp = weights[0]
    want = []
    for role in ('colocated', 'decode'):
        eng = jax_engine.ContinuousEngine(jp, JAX_CFG, slots=4,
                                          max_len=ROLE_MAX_LEN, role=role,
                                          kv_layout=layout, mesh=_jax_mesh())
        eng.start()
        try:
            if role == 'colocated':
                want = [list(eng.submit(r, n).result(timeout=300))
                        for r, n in CASES]
            else:
                got = []
                for data in world[0][route + 'export_' + layout]:
                    header, arrays = jd.parse(data)
                    got.append(list(eng.submit_import(
                        **jd.import_kwargs(header, arrays)).result(
                            timeout=300)))
                assert got == want
        finally:
            eng.stop()
    assert world[0][route + 'import_' + layout] == want * 2
    for role in ('prefill', 'decode'):
        states = {repr(out[route + role + '_' + layout + '_state'])
                  for out in world}
        assert len(states) == 1
    for data in world[0][route + 'export_' + layout]:
        header, arrays = pd.parse(data)
        assert arrays['k'].shape[2] == JAX_CFG.n_kv_heads
