"""Parity of the port's continuous engine in the paged layout, with block
sharing and its accounting, with the JAX engine, on float32 TINY on the
CPU.

Counterparts of ``tests/test_engine_paged.py`` and of the engine cases of
``tests/test_engine_prefix_share.py``. Each script runs on the JAX engine
and on the port's with the same options; every batch of requests is
queued whole before the engine looks at the queue, so both engines admit
it in the same groups. Greedy tokens must equal JAX's and the port's own
solo ``generate``; the block accounts (free, owned, shared, cached), the
share counters and the prefill counters must equal JAX's. MoE runs paged
without block sharing, as in the JAX engine (``tests/test_torch_moe.py``
holds it under a binding capacity). Left out: tensor parallelism
(ROADMAP §1 item 9), whose gate is checked to stay refused.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import engine as jax_engine
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.utils import prefix_affinity as jax_affinity
from skypilot_tpu_torch.models import engine as port_engine
from skypilot_tpu_torch.models import generate as port_gen
from skypilot_tpu_torch.models import llama as port_llama

MAX_LEN = 64

JAX_CFG = dataclasses.replace(jax_llama.TINY, dtype=jnp.float32)
PORT_CFG = dataclasses.replace(port_llama.TINY, dtype=torch.float32)
HEAD = [((11 * j) % 250) + 1 for j in range(24)]  # 1 full block + 8


@pytest.fixture(scope='module')
def weights():
    """(jax params, port params), float32 TINY, same values."""
    jp = jax_llama.init_params(jax.random.PRNGKey(0), JAX_CFG)
    return jp, port_llama.params_from_numpy(
        jax.tree.map(np.asarray, jp), PORT_CFG, 'cpu')


def _solo(pp, row, n, max_len=MAX_LEN, **kw):
    prompt = torch.tensor([row], dtype=torch.int32)
    return port_gen.generate(pp, PORT_CFG, prompt, n, max_len=max_len,
                             **kw)[0].tolist()


def _mk(which, params, **kw):
    kw.setdefault('slots', 4)
    kw.setdefault('max_len', MAX_LEN)
    kw.setdefault('chunk_steps', 4)
    kw.setdefault('kv_layout', 'paged')
    if which == 'jax':
        return jax_engine.ContinuousEngine(params, JAX_CFG, **kw)
    return port_engine.ContinuousEngine(params, PORT_CFG, device='cpu', **kw)


def _batch(eng, jobs):
    """Queue ``jobs`` [(row, max_new, kw)] at once, then start (or wake)
    the engine; returns the futures. The engine sees the whole batch at
    its next look at the queue, so both engines group it alike."""
    reqs = [eng._build_request(row, n, kw.get('temperature', 0.0),  # noqa: SLF001
                               kw.get('on_tokens'), kw.get('top_k', 0),
                               kw.get('top_p', 1.0), kw.get('eos'))
            for row, n, kw in jobs]
    with eng._lock:  # noqa: SLF001
        eng._pending.extend(reqs)  # noqa: SLF001
    eng.start()
    eng._wake.set()  # noqa: SLF001
    return [r.future for r in reqs]


def _serve(eng, batches, timeout=300):
    """Each batch of ``batches`` in turn, waiting for its answers."""
    out = []
    for jobs in batches:
        out += [f.result(timeout=timeout) for f in _batch(eng, jobs)]
        if eng._kv_tiers is not None:  # noqa: SLF001
            assert eng._kv_tiers.quiesce(30)  # noqa: SLF001
    return out


def _accounts(eng):
    """The stats both engines must agree on, once idle."""
    deadline = time.time() + 30
    while True:
        with eng._lock:  # noqa: SLF001
            busy = (eng._pending or eng._admitting or eng._prefilling  # noqa: SLF001
                    or eng._unfetched or eng._tier_waiting  # noqa: SLF001
                    or any(r is not None for r in eng._slot_req))  # noqa: SLF001
        if not busy:
            break
        assert time.time() < deadline
        time.sleep(0.01)
    st = eng.stats()
    return {k: st[k] for k in ('kv_layout', 'kv_blocks', 'prefix_share',
                               'prefill_tokens', 'prefill_tokens_saved',
                               'prefills', 'prefill_chunks',
                               'tokens_emitted', 'active_slots',
                               'prefix_cache')}


def _on_both(weights, script, **kw):
    """``script(engine)`` on the JAX engine, then on the port's, both built
    with the options ``kw``; returns (JAX's result, the port's)."""
    out = []
    for which, params in zip(('jax', 'port'), weights):
        eng = _mk(which, params, **kw)
        try:
            out.append(script(eng))
        finally:
            eng.stop()
    return out


def _drained(acc):
    """After a drain: nothing owned or referenced, and free + cached ==
    usable (no block leaked)."""
    kb = acc['kv_blocks']
    return (kb['owned'] == 0 and kb['shared'] == 0
            and kb['free'] + kb['cached'] == kb['usable'])


def _both_equal(weights, batches, **kw):
    """Serve ``batches`` on both engines: equal answers and accounts;
    returns (answers, accounts)."""
    (jout, jacc), (pout, pacc) = _on_both(
        weights, lambda e: (_serve(e, batches), _accounts(e)), **kw)
    assert pout == jout
    assert pacc == jacc
    return pout, pacc


def _jobs(rows, n, **kw):
    return [(r, n, kw) for r in rows]


# -- counterparts of tests/test_engine_paged.py --------------------------------------


def test_paged_greedy_matches_generate(weights):
    rows = [[5, 6, 7], [8, 9, 10, 11, 12], [13, 14], [15, 16, 17, 18],
            [19, 20, 21]]  # more rows than slots: forces reuse
    out, acc = _both_equal(weights, [_jobs(rows, 6)], prefix_share=False)
    assert out == [_solo(weights[1], r, 6) for r in rows]
    kb = acc['kv_blocks']
    assert acc['kv_layout'] == 'paged'
    assert kb['free'] == kb['total'] - 1  # every reservation returned


def test_paged_pool_smaller_than_slot_pinned_equivalent(weights):
    """A pool of 9 usable blocks (144 positions) serves 4 slots that the
    slot layout charges 4 x 64 = 256 positions for."""
    rows = [[5, 6, 7], [8, 9, 10, 11, 12, 13, 14, 15], [16, 17], [18] * 20,
            [21, 22, 23]]
    out, acc = _both_equal(weights, [_jobs(rows, 6)], kv_blocks=10)
    assert out == [_solo(weights[1], r, 6) for r in rows]
    assert _drained(acc) and acc['kv_blocks']['usable'] == 9


def test_paged_backpressure_queues_when_pool_exhausted(weights):
    """One usable block: three requests of 3 + 13 tokens admit strictly
    one at a time, and all complete exactly."""
    rows = [[5, 6, 7], [9, 8, 7], [11, 12, 13]]

    def script(eng):
        out = _serve(eng, [_jobs(rows, 13)])
        return out, _accounts(eng), eng.stats()['peak_active_slots']
    (jout, jacc, jpeak), (pout, pacc, ppeak) = _on_both(
        weights, script, kv_blocks=2, chunk_steps=2)
    assert pout == jout == [_solo(weights[1], r, 13) for r in rows]
    assert pacc == jacc
    assert pacc['kv_blocks']['free'] + pacc['kv_blocks']['cached'] == 1
    assert ppeak == jpeak == 1  # serialized


def test_paged_kv_int8_matches_kv_int8_oracle(weights):
    row = [7, 8, 9, 10]
    out, _ = _both_equal(weights, [_jobs([row], 6)], kv_quantize=True)
    assert out == [_solo(weights[1], row, 6, kv_quantize=True)]


def test_paged_single_token_request_reserves_no_blocks(weights):
    out, acc = _both_equal(weights, [_jobs([[2, 3, 4]], 1)], kv_blocks=2)
    assert out == [_solo(weights[1], [2, 3, 4], 1)]
    assert acc['kv_blocks']['free'] == 1  # untouched


def test_paged_eos_frees_blocks_early(weights):
    row = [5, 6, 7]
    solo = _solo(weights[1], row, 10)
    out, acc = _both_equal(weights, [_jobs([row], 10, eos=solo[3])],
                           chunk_steps=2)
    assert out == [solo[:4]]
    assert acc['kv_blocks']['free'] == acc['kv_blocks']['total'] - 1


def test_paged_chunked_prefill_exact_and_parks_on_exhaustion(weights):
    """The holder takes 2 of 3 usable blocks; the 34-token prompt needs
    3, so its chunked prefill finishes and PARKS until they free."""
    holder, long_row = [3, 4, 5], list(range(1, 35))
    out, acc = _both_equal(
        weights, [[(holder, 20, {}), (long_row, 4, {})]], prefill_chunk=8,
        kv_blocks=4, chunk_steps=2)
    assert out == [_solo(weights[1], holder, 20),
                   _solo(weights[1], long_row, 4)]
    assert acc['prefill_chunks'] >= 5
    assert _drained(acc) and acc['kv_blocks']['usable'] == 3


def test_paged_sampling_and_streaming(weights):
    """A greedy stream's callbacks add up to its answer (equal to JAX's);
    a sampled row is in range (the draws differ from JAX's)."""
    row = [11, 12, 13]
    seen = []
    eng = _mk('port', weights[1])
    try:
        g, s = _batch(eng, [(row, 8, {'on_tokens': seen.append}),
                            ([8, 9, 10], 6, {'temperature': 1.0,
                                             'top_k': 8})])
        got, sampled = g.result(timeout=300), s.result(timeout=300)
    finally:
        eng.stop()
    jeng = _mk('jax', weights[0])
    try:
        want = _serve(jeng, [_jobs([row], 8)])[0]
    finally:
        jeng.stop()
    assert got == want == _solo(weights[1], row, 8)
    assert [t for c in seen for t in c] == got
    assert len(sampled) == 6 and all(0 <= t < PORT_CFG.vocab_size
                                     for t in sampled)


def test_paged_freed_slot_junk_never_corrupts_reallocated_blocks(weights):
    """A (slot 0) and B (slot 1) complete; C admits into slot 0 holding
    B's released blocks while slot 1 keeps decoding with a stale table
    pointing at them. Rows not active write the junk sink, so C's KV is
    intact."""
    a, b, c = [5, 6, 7], [8, 9, 10, 11], [21, 22, 23]
    out, acc = _both_equal(
        weights, [[(a, 6, {}), (b, 8, {})], _jobs([c], 12)], slots=2,
        prefix_share=False)
    pp = weights[1]
    assert out == [_solo(pp, a, 6), _solo(pp, b, 8), _solo(pp, c, 12)]
    assert _drained(acc)


def test_paged_prefix_cache_exact_on_repeat(weights):
    """The dense prefix pool on the paged layout (sharing off, as it
    would intercept the repeats first): repeats hit the pool, exactly."""
    row = list(range(40, 60)) + [7, 8, 9]
    out, acc = _both_equal(weights, [_jobs([row], 6)] * 3, prefix_slots=4,
                           prefix_share=False)
    assert out == [_solo(weights[1], row, 6)] * 3
    assert acc['prefix_cache']['hits'] >= 1
    assert acc['prefix_cache']['stores'] >= 1
    assert _drained(acc)


def test_paged_gates(weights):
    jp, pp = weights
    for which, params in (('jax', jp), ('port', pp)):
        with pytest.raises(ValueError, match='multiple of the'):
            _mk(which, params, max_len=72, kv_block=16, slots=2)
        with pytest.raises(ValueError, match='Unknown kv_layout'):
            _mk(which, params, kv_layout='banana')
        # A request bigger than the WHOLE pool is refused at submit.
        eng = _mk(which, params, slots=2, kv_blocks=2)
        with pytest.raises(ValueError, match='KV blocks'):
            eng.submit(list(range(10)), 10)  # 20 tokens -> 2 blocks > 1
        eng.stop()


def test_paged_moe_and_spec_stay_refused(weights):
    """MoE and a draft model are both ported now (this name predates
    them): paged, each runs as JAX's does, with block sharing (and so the
    tiers) off, and an MoE request gives JAX's tokens
    (``test_engine_paged.py:164``)."""
    jp, pp = weights
    j_moe = dataclasses.replace(jax_llama.MOE_TINY, dtype=jnp.float32,
                                expert_capacity_factor=4.0)
    p_moe = dataclasses.replace(port_llama.MOE_TINY, dtype=torch.float32,
                                expert_capacity_factor=4.0)
    jmp = jax_llama.init_params(jax.random.PRNGKey(7), j_moe)
    pmp = port_llama.params_from_numpy(jax.tree.map(np.asarray, jmp), p_moe,
                                       'cpu')
    jeng = jax_engine.ContinuousEngine(jmp, j_moe, kv_layout='paged',
                                       slots=2, max_len=32)
    eng = port_engine.ContinuousEngine(pmp, p_moe, kv_layout='paged',
                                       slots=2, max_len=32, device='cpu')
    try:
        assert eng.prefix_share is jeng.prefix_share is False
        assert eng._kv_tiers is None and jeng._kv_tiers is None  # noqa: SLF001
        row = [11, 12, 13, 14]
        assert eng.submit(row, 5).result(timeout=120) == \
            jeng.submit(row, 5).result(timeout=300)
    finally:
        eng.stop()
        jeng.stop()
    jeng = _mk('jax', jp, kv_layout='paged', slots=2, max_len=64,
               draft_params=jp, draft_cfg=JAX_CFG)
    eng = _mk('port', pp, kv_layout='paged', slots=2, max_len=64,
              draft_params=pp, draft_cfg=PORT_CFG)
    try:
        assert eng.prefix_share is jeng.prefix_share is False
        assert eng._kv_tiers is None and jeng._kv_tiers is None  # noqa: SLF001
        row = [5, 6, 7]
        assert eng.submit(row, 6).result(timeout=120) == \
            jeng.submit(row, 6).result(timeout=300)
    finally:
        eng.stop()
        jeng.stop()


# -- counterparts of the engine cases of tests/test_engine_prefix_share.py -----------


def _mixed_rows(n=12, shared_frac=0.75, tail=8):
    rows = []
    for i in range(n):
        if (i * shared_frac) % 1 < shared_frac:
            rows.append(HEAD + [((7 * i + j) % 250) + 1
                                for j in range(tail)])
        else:
            rows.append([((13 * i + j) % 250) + 1
                         for j in range(len(HEAD) + tail)])
    return rows


def test_share_greedy_byte_parity_on_vs_off(weights):
    rows = _mixed_rows()
    batches = [_jobs(rows[:1], 6), _jobs(rows[1:], 6)]
    out = {}
    acc = {}
    for share in (True, False):
        out[share], acc[share] = _both_equal(weights, batches,
                                             chunk_steps=2,
                                             prefix_share=share)
    assert out[True] == out[False] == [_solo(weights[1], r, 6)
                                       for r in rows]
    st = acc[True]['prefix_share']
    assert st['enabled'] and st['hits'] >= 1 and st['hit_tokens'] >= 16
    assert st['cow_forks'] >= 1  # 24-token head: full block + 8
    assert acc[True]['prefill_tokens'] < acc[False]['prefill_tokens']
    assert not acc[False]['prefix_share']['enabled']


def test_share_cow_fork_on_divergent_append(weights):
    """Two prompts share 24 tokens (1 full block + 8 into the next): the
    second forks the donor block, and the donor's chain stays intact."""
    a = HEAD + [31, 32, 33, 34, 35, 36, 37, 38]
    b = HEAD + [41, 42, 43, 44, 45, 46, 47, 48]
    out, acc = _both_equal(weights, [_jobs([a], 8), _jobs([b, a], 8)],
                           chunk_steps=2)
    pp = weights[1]
    assert out == [_solo(pp, a, 8), _solo(pp, b, 8), _solo(pp, a, 8)]
    assert acc['prefix_share']['cow_forks'] >= 1
    assert acc['prefix_share']['hits'] >= 2


def test_share_chunked_prefill_tail_only(weights):
    """The chunked path seeds its scratch row from the trie and computes
    only the unshared tail."""
    seed_row = HEAD + list(range(150, 170))
    long_row = HEAD + list(range(100, 130))  # 54 tokens
    res = {}
    for share in (True, False):
        def script(eng):
            out = _serve(eng, [_jobs([seed_row], 4)])
            t0 = eng.stats()['prefill_tokens']
            out += _serve(eng, [_jobs([long_row], 4)])
            return out, eng.stats()['prefill_tokens'] - t0, _accounts(eng)
        (jout, jd, jacc), (pout, pd, pacc) = _on_both(
            weights, script, prefill_chunk=8, chunk_steps=2,
            prefix_share=share)
        assert (pout, pd, pacc) == (jout, jd, jacc)
        res[share] = (pout, pd)
    assert res[True][0] == res[False][0]
    assert res[True][0][1] == _solo(weights[1], long_row, 4)
    assert res[True][1] <= res[False][1] - 16


def test_share_int8_kv_parity(weights):
    rows = [HEAD + [61, 62, 63], HEAD + [71, 72]]
    out, acc = _both_equal(weights, [_jobs(rows[:1], 6), _jobs(rows[1:], 6)],
                           kv_quantize=True, chunk_steps=2)
    assert out == [_solo(weights[1], r, 6, kv_quantize=True) for r in rows]
    assert acc['prefix_share']['hits'] >= 1


def test_share_eos_and_drain_reconcile_exactly(weights):
    """EOS frees early by DECREF; after the drain free + cached == usable
    with nothing owned or referenced."""
    row = HEAD + [91, 92, 93]
    solo = _solo(weights[1], row, 10)
    out, acc = _both_equal(
        weights, [_jobs([row], 10), _jobs([row], 10, eos=solo[3])],
        chunk_steps=2)
    assert out == [solo, solo[:4]]
    assert _drained(acc) and acc['kv_blocks']['cached'] >= 1


def test_share_eviction_under_pool_pressure(weights):
    """4 usable blocks: each 28-token prompt + 6 new needs 3 and leaves 1
    cached block behind, so the third admission must evict; the newest
    head still hits afterwards."""
    heads = [[((17 * h + j) % 250) + 1 for j in range(24)]
             for h in range(3)]
    rows = [h + [5, 6, 7, 8] for h in heads] + [heads[-1] + [9, 9, 9]]
    out, acc = _both_equal(weights, [_jobs([r], 6) for r in rows],
                           kv_blocks=5, chunk_steps=2)
    assert out == [_solo(weights[1], r, 6) for r in rows]
    assert acc['prefix_share']['evictions'] >= 1
    assert acc['prefix_share']['hits'] == 1
    assert _drained(acc)


def test_share_backpressure_with_referenced_blocks(weights):
    """A holder pins the shared head while the pool backpressures younger
    requests: all complete, none corrupt, and the pool reconciles."""
    base = HEAD + [3, 4]
    others = [[((23 * i + j) % 250) + 1 for j in range(10)]
              for i in range(3)]
    out, acc = _both_equal(
        weights, [[(base, 20, {})] + _jobs(others, 8)], kv_blocks=6,
        chunk_steps=2)
    pp = weights[1]
    assert out == [_solo(pp, base, 20)] + [_solo(pp, r, 8) for r in others]
    assert _drained(acc)


def test_share_hit_near_full_context_no_clip_corruption(weights):
    """80 shared + 40 unique tokens at max_len 128: the 40-token tail's
    pad width is clamped so no padded write clips into the request's own
    last block."""
    head = [((29 * j) % 250) + 1 for j in range(80)]
    a = head + [((3 * j) % 250) + 1 for j in range(2)]
    b = head + [((5 * j) % 250) + 1 for j in range(40)]
    out, acc = _both_equal(weights, [_jobs([a], 6), _jobs([b], 8)],
                           max_len=128, chunk_steps=2)
    pp = weights[1]
    assert out == [_solo(pp, a, 6, max_len=128), _solo(pp, b, 8, max_len=128)]
    assert acc['prefix_share']['hits'] >= 1


def test_share_hit_parks_when_matched_chain_is_the_idle_supply(weights):
    """Pool of 3: A leaves 2 idle blocks, C holds the free one, then B's
    hit (2 pinned + 1 owned) must wait for C without counting its own
    chain as supply, and still come out exact."""
    a = [((31 * j) % 250) + 1 for j in range(32)]
    c_row, b_row = [9, 8, 7], a + [5, 6, 7, 8]
    out, acc = _both_equal(
        weights, [_jobs([a], 2), [(c_row, 12, {}), (b_row, 8, {})]],
        kv_blocks=4, chunk_steps=2)
    pp = weights[1]
    assert out == [_solo(pp, a, 2), _solo(pp, c_row, 12), _solo(pp, b_row, 8)]
    assert acc['prefix_share']['hits'] >= 1 and _drained(acc)


def test_stats_surface_share_counters(weights):
    jp, pp = weights
    want = _mk('jax', jp).stats()
    got = _mk('port', pp).stats()
    for block in ('kv_blocks', 'prefix_share', 'kv_tiers'):
        assert set(got[block]) == set(want[block]), block
    assert got['kv_blocks'] == want['kv_blocks']
    assert got['prefix_share'] == want['prefix_share']
    for key in ('prefill_tokens', 'prefill_tokens_saved',
                'prefill_bubble_ms'):
        assert key in got
    assert set(got) <= set(want)


def test_engine_prefix_summary_advertises_resident_chains(weights,
                                                          monkeypatch):
    """After shared-head traffic the port's ``prefix_summary`` equals
    JAX's, entry for entry; an LB-side hash of the prompt matches it; the
    SKYTPU_PREFIX_SUMMARY_MAX bound holds; a share-off engine adverts
    nothing."""
    monkeypatch.setenv('SKYTPU_PREFIX_SUMMARY_MAX', '2')
    a = HEAD + [31, 32, 33, 34, 35, 36, 37, 38]
    b = HEAD + [41, 42, 43, 44, 45, 46, 47, 48]

    def script(eng):
        _serve(eng, [_jobs([a], 6), _jobs([b], 6)])
        return eng.prefix_summary()
    want, got = _on_both(weights, script, chunk_steps=2)
    assert got == want and got['entries'] and len(got['entries']) <= 2
    info = jax_affinity.parse_summary(got)
    hashes = jax_affinity.chain_hashes(a, got['block'], 32)
    assert jax_affinity.match_depth(hashes, info['hashes']) >= 1
    off = _mk('port', weights[1], prefix_share=False)
    assert off.prefix_summary() is None


def test_fail_everything_rebuilds_the_pool_and_trie(weights, monkeypatch):
    """A failure on the engine thread fails the requests in flight and
    rebuilds the pool, the free list and the trie; the engine then serves
    the next request exactly."""
    _, pp = weights
    eng = _mk('port', pp, chunk_steps=2)
    try:
        row = HEAD + [1, 2, 3]
        assert _serve(eng, [_jobs([row], 4)]) == [_solo(pp, row, 4)]
        assert eng.stats()['kv_blocks']['cached'] == 1

        def boom(*args, **kwargs):
            raise RuntimeError('injected')
        monkeypatch.setattr(port_engine, '_prefill_shared', boom)
        with pytest.raises(RuntimeError, match='injected'):
            _serve(eng, [_jobs([row], 4)])
        monkeypatch.undo()
        deadline = time.time() + 30  # the rebuild follows the failure
        while eng.stats()['kv_blocks']['free'] != MAX_LEN // 16 * 4:
            assert time.time() < deadline, eng.stats()['kv_blocks']
            time.sleep(0.01)
        kb = _accounts(eng)['kv_blocks']
        assert kb['free'] == kb['usable'] and kb['cached'] == 0
        assert _serve(eng, [_jobs([row], 4)]) == [_solo(pp, row, 4)]
    finally:
        eng.stop()


def test_kv_tiers_env_and_options_resolve_like_jax(weights, monkeypatch):
    """Sharing only on the paged layout, tiers only with sharing, and
    the environment defaults, as the JAX engine resolves them."""
    jp, pp = weights
    cases = [({}, {}), ({'prefix_share': False}, {}),
             ({'kv_tiers': False}, {}), ({}, {'SKYTPU_KV_TIERS': '0'}),
             ({}, {'SKYTPU_LLM_PREFIX_SHARE': '0'}),
             ({'kv_layout': 'slot', 'prefix_share': True}, {})]
    for kw, env in cases:
        for var in ('SKYTPU_KV_TIERS', 'SKYTPU_LLM_PREFIX_SHARE'):
            monkeypatch.delenv(var, raising=False)
        for var, value in env.items():
            monkeypatch.setenv(var, value)
        jeng, peng = _mk('jax', jp, **kw), _mk('port', pp, **kw)
        assert peng.prefix_share == jeng.prefix_share, (kw, env)
        assert (peng._kv_tiers is None) == (jeng._kv_tiers is None), (  # noqa: SLF001
            kw, env)
        if peng.kv_layout == 'paged':
            assert peng.kv_blocks == jeng.kv_blocks
