"""The paged layout, block sharing and the KV tiers on a tensor-parallel
replica of the port, against the JAX package, on the CPU.

One gang of two gloo ranks (``test_torch_tp.run_gang``) computes every
port-side figure of this file: ``serve/spmd.SpmdEngine`` over float32
TINY weights carried over from JAX, the pool born sharded on kv_heads and
the decode kernel's plain version per head shard. The JAX side runs in
this process: its engine on a ``tensor=2`` mesh of the virtual CPU
devices (``test_engine_paged.py:246`` and ``:266``), and its single-device
engine for the tiers, whose answers do not depend on the mesh.

The tiers live on the head (rank 0), whole, in JAX's layout: each rank
gathers its heads of an evicted chain to the head and gets its heads of a
promoted one from there, and every tier answer reaches the other rank
through the head's broadcast. So both ranks' block accounts and the
engine's side of the tier decisions must be equal, and a spill that reads
back corrupt makes every rank recompute.
"""
import dataclasses
import os
import time

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
# test_engine_paged.py:255 (slots 2: the third row reuses a slot) and :270.
TP_ROWS = [[5, 6, 7], [8, 9, 10, 11], [12, 13]]
KV8_ROW = [7, 8, 9, 10]
# Heads of 24 tokens (a full block and a half), as test_torch_kv_tiers.py.
HEADS = [[((17 * h + j) % 250) + 1 for j in range(24)] for h in range(5)]
FETCH_ROUNDS = ([h + [5, 6, 7, 8] for h in HEADS], [HEADS[0] + [9, 9, 9]])
CORRUPT_ROUNDS = ([h + [5, 6, 7, 8] for h in HEADS[:3]],
                  [h + [9, 9, 9] for h in HEADS[:3]])
SHARE_ROWS = [HEADS[0] + HEADS[1][:10], HEADS[0] + [3, 4, 5], HEADS[1] + [6],
              HEADS[0] + HEADS[1][:4] + [7]]

_BODY = '''
import dataclasses, os, time
import numpy as np
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.serve import kv_tiers, llm_server, spmd

cfg = dataclasses.replace(llama.TINY, dtype=torch.float32)
full = llama.params_from_numpy(inputs['params'], cfg, 'cpu')

def corrupt(spill):
    # Wait until the head's tier published a segment, then flip the last
    # byte of each: a fetch of it fails its crc32.
    deadline = time.time() + 30
    while eng_now[0]._kv_tiers.stats()['spills'] < 1:
        assert time.time() < deadline
        time.sleep(0.01)
    for name in os.listdir(spill):
        if name.endswith(kv_tiers.SEG_SUFFIX):
            with open(os.path.join(spill, name), 'r+b') as f:
                f.seek(-1, os.SEEK_END)
                last = f.read(1)
                f.seek(-1, os.SEEK_END)
                f.write(bytes([last[0] ^ 0xFF]))

eng_now = [None]

def engine_run(name, rounds, env=None, together=False, corrupt_dir=None,
               keep_pool=False, **kw):
    os.environ.update(env or {})
    eng = spmd.SpmdEngine(full, cfg, chunk_steps=2, mesh=mesh,
                          device='cpu', kv_layout='paged', **kw)
    eng_now[0] = eng
    out[name + '_pool_heads'] = eng._cache.k.shape[2]
    if rank == 0:
        got = []
        for i, rows in enumerate(rounds):
            if together:
                futs = [eng.submit(r, 6) for r in rows]
                got += [f.result(timeout=120) for f in futs]
            else:
                got += [eng.submit(r, 6).result(timeout=120) for r in rows]
            if eng._kv_tiers is not None:
                assert eng._kv_tiers.quiesce(30)
            if corrupt_dir is not None and i == 0:
                corrupt(corrupt_dir)
        out[name] = got
        out[name + '_tiers'] = (None if eng._kv_tiers is None
                                else eng._kv_tiers.stats())
        eng.stop()
    else:
        eng.start()
        eng._thread.join()
        out[name + '_tiers'] = eng._kv_tiers
    out[name + '_state'] = llm_server._rank_engine_state(eng)
    out[name + '_blocks'] = eng.stats()['kv_blocks']
    if keep_pool:  # this rank's heads of every block, promoted ones too
        out[name + '_pool'] = [eng._cache.k.float().numpy().copy(),
                               eng._cache.v.float().numpy().copy()]
    for k in (env or {}):
        del os.environ[k]

engine_run('tp', [inputs['tp_rows']], together=True, slots=2)
engine_run('kv8', [[inputs['kv8_row']]], slots=2, kv_quantize=True)
engine_run('share', [inputs['share_rows']], slots=4, kv_tiers=False)
fetch_env = {'SKYTPU_KV_SPILL_DIR': os.path.join(tmp, 'spill-fetch'),
             'SKYTPU_KV_HOST_BYTES': '8192'}
engine_run('fetch', inputs['fetch_rounds'], env=fetch_env, slots=4,
           kv_blocks=5, keep_pool=True)
bf16 = llama.params_from_numpy(inputs['params'], llama.TINY, 'cpu')

def bf16_run(name):
    global full, cfg
    env = {'SKYTPU_KV_SPILL_DIR': os.path.join(tmp, 'spill-' + name),
           'SKYTPU_KV_HOST_BYTES': '4096'}
    kept, (full, cfg) = (full, cfg), (bf16, llama.TINY)
    engine_run(name, inputs['fetch_rounds'], env=env, slots=4, kv_blocks=5,
               keep_pool=True)
    full, cfg = kept

# bf16 through gloo's gather and scatter: the reference of the arena's.
bf16_run('bf16_gloo')
# Through the arena, as ranks that share a card exchange their heads:
# the same rounds in float32 (against JAX's engine and the gloo run
# above) and in bf16 (the tier's planes are bf16 words in a process
# without ml_dtypes).
from skypilot_tpu_torch.parallel import mesh as mesh_lib
staged = mesh_lib.Mesh.stages_on_host
mesh_lib.Mesh.stages_on_host = property(lambda self: True)
engine_run('arena32', inputs['fetch_rounds'], slots=4, kv_blocks=5,
           keep_pool=True, env=dict(
               fetch_env, SKYTPU_KV_SPILL_DIR=os.path.join(tmp, 'spill-a32')))
bf16_run('bf16')
mesh_lib.Mesh.stages_on_host = staged
out['arena'] = sorted(mesh.arenas)
corrupt_env = {'SKYTPU_KV_SPILL_DIR': os.path.join(tmp, 'spill-corrupt'),
               'SKYTPU_KV_HOST_BYTES': '1'}
engine_run('corrupt', inputs['corrupt_rounds'], env=corrupt_env, slots=4,
           kv_blocks=5, corrupt_dir=corrupt_env['SKYTPU_KV_SPILL_DIR'])
'''


@pytest.fixture(scope='module')
def jax_params():
    return jax_llama.init_params(jax.random.PRNGKey(0), JAX_CFG)


@pytest.fixture(scope='module')
def gang(tmp_path_factory, jax_params):
    inputs = {'params': _numpy_tree(jax_params), 'tp_rows': TP_ROWS,
              'kv8_row': KV8_ROW, 'share_rows': SHARE_ROWS,
              'fetch_rounds': FETCH_ROUNDS,
              'corrupt_rounds': CORRUPT_ROUNDS}
    return run_gang(tmp_path_factory.mktemp('tp_paged'), 2, _BODY,
                    inputs=inputs)


def _solo(params, row, n=6, **kw):
    out = jax_gen.generate(params, JAX_CFG, jnp.asarray([row], jnp.int32),
                           max_new_tokens=n, max_len=64, **kw)
    return np.asarray(out[0]).tolist()


def _jax_tp_engine(params, **kw):
    mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec(fsdp=1, tensor=2),
                               devices=jax.devices()[:2])
    eng = jax_engine.ContinuousEngine(params, JAX_CFG, slots=2, max_len=64,
                                      chunk_steps=2, kv_layout='paged',
                                      mesh=mesh, **kw)
    eng.start()
    return eng


def _equal_on_ranks(outs, name):
    assert outs[0][name + '_state'] == outs[1][name + '_state']
    assert outs[0][name + '_pool_heads'] == JAX_CFG.n_kv_heads // 2


def test_paged_tensor_parallel_matches_jax_tensor2(gang, jax_params):
    """test_engine_paged.py:246 on the port's gang: the pool born
    sharded on kv_heads, three rows through two slots; tokens equal JAX's
    engine on tensor=2 and the solo generation, every block returned on
    both ranks."""
    outs = gang
    eng = _jax_tp_engine(jax_params)
    try:
        futs = [eng.submit(r, 6) for r in TP_ROWS]
        want = [f.result(timeout=300) for f in futs]
    finally:
        eng.stop()
    assert outs[0]['tp'] == want == [_solo(jax_params, r) for r in TP_ROWS]
    _equal_on_ranks(outs, 'tp')
    for out in outs:
        kb = out['tp_blocks']
        assert kb['free'] == kb['total'] - 1 == kb['usable']


def test_paged_tp_with_kv_int8_matches_jax_tensor2(gang, jax_params):
    """test_engine_paged.py:266: int8 KV codes and their scale planes
    sharded on kv_heads like the codes."""
    outs = gang
    eng = _jax_tp_engine(jax_params, kv_quantize=True)
    try:
        want = eng.submit(KV8_ROW, 6).result(timeout=300)
    finally:
        eng.stop()
    assert outs[0]['kv8'] == [want] == [
        _solo(jax_params, KV8_ROW, kv_quantize=True)]
    _equal_on_ranks(outs, 'kv8')


def test_block_sharing_under_tp_is_host_state_equal_on_both_ranks(
        gang, jax_params):
    """Share hits, a copy-on-write fork (the last row ends inside a
    committed block) and commits under tp 2: answers equal the solo generation and
    both ranks hold the same trie accounts."""
    outs = gang
    assert outs[0]['share'] == [_solo(jax_params, r) for r in SHARE_ROWS]
    _equal_on_ranks(outs, 'share')
    hits, _, _, commits, _, forks = outs[0]['share_state']['share']
    assert hits >= 2 and commits >= 1 and forks >= 1


def _jax_tier_run(params, tmp_path, monkeypatch, host_bytes, rounds,
                  corrupt=False):
    spill = tmp_path / f'jax-{host_bytes}'
    monkeypatch.setenv('SKYTPU_KV_SPILL_DIR', str(spill))
    monkeypatch.setenv('SKYTPU_KV_HOST_BYTES', str(host_bytes))
    eng = jax_engine.ContinuousEngine(params, JAX_CFG, slots=4, max_len=64,
                                      chunk_steps=2, kv_layout='paged',
                                      kv_blocks=5)
    out = []
    try:
        for i, rows in enumerate(rounds):
            out += [eng.submit(r, 6).result(timeout=300) for r in rows]
            assert eng._kv_tiers.quiesce(30)  # noqa: SLF001
            if corrupt and i == 0:
                deadline = time.time() + 30
                while eng.stats()['kv_tiers']['spills'] < 1:
                    assert time.time() < deadline
                    time.sleep(0.01)
                for name in os.listdir(spill):
                    if name.endswith('.seg'):
                        with open(spill / name, 'r+b') as f:
                            f.seek(-1, os.SEEK_END)
                            last = f.read(1)
                            f.seek(-1, os.SEEK_END)
                            f.write(bytes([last[0] ^ 0xFF]))
    finally:
        eng.stop()
    return out


def test_tiers_under_tp_demote_spill_fetch_promote_like_jax(
        gang, jax_params, tmp_path, monkeypatch):
    """Five heads through a pool of 4 usable blocks and a host tier that
    holds one whole-head chain (8,192 bytes, as on one device): evicted
    chains demote from both ranks to the head, spill, and the first head
    asked again parks on a fetch and promotes, each rank getting its own
    heads back. Tokens equal JAX's single-device engine and the solo
    generation; the block accounts and the engine's tier decisions are
    equal on both ranks."""
    outs = gang
    want = _jax_tier_run(jax_params, tmp_path, monkeypatch, 8192,
                         FETCH_ROUNDS)
    rows = FETCH_ROUNDS[0] + FETCH_ROUNDS[1]
    assert outs[0]['fetch'] == want == [_solo(jax_params, r) for r in rows]
    _equal_on_ranks(outs, 'fetch')
    tiers = outs[0]['fetch_tiers']
    assert tiers['demotes'] >= 1 and tiers['spills'] >= 1, tiers
    assert tiers['fetches'] >= 1 and tiers['promotes'] >= 1, tiers
    assert tiers['corrupt'] == 0, tiers
    evicted, promoted, parked, fetched = outs[0]['fetch_state'][
        'tier_counts']
    assert evicted >= 1 and promoted >= 1 and parked >= 1 and fetched >= 1
    assert outs[1]['fetch_tiers'] is None  # the follower holds no tier


def _same_as_through_gloo(outs, name, ref):
    """Run ``name`` (through the arena) gave the answers and took the
    engine's tier decisions of run ``ref`` (through gloo's gather and
    scatter), and each rank's pool, the promoted blocks among it, is that
    run's bit for bit. (The tier thread's own counts, spills among them,
    follow its timing and may differ.)"""
    _equal_on_ranks(outs, name)
    assert outs[0][name] == outs[0][ref]
    assert outs[0][name + '_state'] == outs[0][ref + '_state']
    for run in (name, ref):
        tiers = outs[0][run + '_tiers']
        assert tiers['promotes'] >= 1 and tiers['fetches'] >= 1, tiers
        assert tiers['corrupt'] == 0 and tiers['quarantined'] == 0, tiers
    for out in outs:
        for mine, theirs in zip(out[name + '_pool'], out[ref + '_pool']):
            np.testing.assert_array_equal(mine, theirs)


def test_tiers_through_the_arena_match_jax_and_gloo(
        gang, jax_params, tmp_path, monkeypatch):
    """The fetch rounds again, the ranks exchanging their heads through
    shared host memory as ranks that share a card do: each demote's heads
    gathered to the head through the arena, each promote's scattered from
    it. Tokens equal JAX's single-device engine; the tier decisions and
    each rank's pool equal the run through gloo's gather and scatter."""
    outs = gang
    assert outs[0]['arena'] == ['tensor']
    want = _jax_tier_run(jax_params, tmp_path, monkeypatch, 8192,
                         FETCH_ROUNDS)
    assert outs[0]['arena32'] == want
    _same_as_through_gloo(outs, 'arena32', 'fetch')


def test_bf16_tiers_through_the_arena_promote_whole_heads(gang):
    """A bf16 pool whose ranks exchange their heads through shared host
    memory, as ranks that share a card do: the tier on the head holds
    bf16 words (no ml_dtypes in a rank's process) and promotes them. The
    answers, the tier decisions and each rank's pool equal the same bf16
    rounds through gloo's gather and scatter. A bf16 promote raised in
    such a process before (ROADMAP §3)."""
    outs = gang
    assert outs[0]['arena'] == ['tensor']
    rows = FETCH_ROUNDS[0] + FETCH_ROUNDS[1]
    assert [len(g) for g in outs[0]['bf16']] == [6] * len(rows)
    _same_as_through_gloo(outs, 'bf16', 'bf16_gloo')


def test_corrupt_spill_makes_every_rank_recompute(gang, jax_params,
                                                  tmp_path, monkeypatch):
    """Every chain spills (host bytes 1) and the head's segments are
    bit-flipped between the rounds: the head's fetch fails its crc32 and
    quarantines, nothing promotes, and both ranks recompute the same
    prompt tokens; the answers still equal JAX's and the solo
    generation."""
    outs = gang
    want = _jax_tier_run(jax_params, tmp_path, monkeypatch, 1,
                         CORRUPT_ROUNDS, corrupt=True)
    rows = CORRUPT_ROUNDS[0] + CORRUPT_ROUNDS[1]
    assert outs[0]['corrupt'] == want == [
        _solo(jax_params, r) for r in rows]
    _equal_on_ranks(outs, 'corrupt')
    tiers = outs[0]['corrupt_tiers']
    assert tiers['corrupt'] >= 1 and tiers['quarantined'] >= 1, tiers
    assert tiers['promotes'] == 0, tiers
    assert outs[0]['corrupt_state']['tier_counts'][1] == 0  # no promote
