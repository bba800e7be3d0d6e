"""Parity of the port's speculative rounds inside the continuous engine
(``models/engine.py`` with a draft) with the JAX engine, on float32 TINY
on the CPU. Counterparts of ``tests/test_engine_spec.py``, all but its two
tensor-parallel cases, which wait for the mesh.

Every greedy stream must equal its solo greedy generation token for
token, whatever slot it landed in, whenever it was admitted, whatever the
free slots decode and whatever the draft proposes, on both KV layouts;
where the same script runs on the JAX engine with the same weights, its
streams and its ``speculative`` counts (proposals, accepted, and rounds
where a single request fixes them) must equal the port's. Sampled rows
draw from a ``torch.Generator`` and are checked for length and range.
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
from skypilot_tpu_torch.models import engine as port_engine
from skypilot_tpu_torch.models import generate as port_gen
from skypilot_tpu_torch.models import llama as port_llama
from skypilot_tpu_torch.serve import llm_server as port_srv

MAX_LEN = 64
JAX_CFG = dataclasses.replace(jax_llama.TINY, dtype=jnp.float32)
PORT_CFG = dataclasses.replace(port_llama.TINY, dtype=torch.float32)
ROWS = [[5, 6, 7], [8, 9, 10, 11, 12], [13, 14], [15, 16, 17, 18],
        [19, 20, 21]]  # more rows than the 4 slots: slots are reused


def _carry(jp):
    return port_llama.params_from_numpy(jax.tree.map(np.asarray, jp),
                                        PORT_CFG, 'cpu')


@pytest.fixture(scope='module')
def weights():
    """(jax target, port target), float32 TINY, same values."""
    jp = jax_llama.init_params(jax.random.PRNGKey(0), JAX_CFG)
    return jp, _carry(jp)


@pytest.fixture(scope='module')
def draft():
    """A draft over the same vocabulary with DIFFERENT weights: proposals
    often diverge, exercising rejection and rollback."""
    jd = jax_llama.init_params(jax.random.PRNGKey(99), JAX_CFG)
    return jd, _carry(jd)


def _solo(pp, row, n, max_len=MAX_LEN, **kw):
    return port_gen.generate(pp, PORT_CFG, torch.tensor([row]), n,
                             max_len=max_len, **kw)[0].tolist()


def _mk(pp, dp, **kw):
    kw.setdefault('slots', 4)
    kw.setdefault('max_len', MAX_LEN)
    kw.setdefault('spec_k', 3)
    eng = port_engine.ContinuousEngine(pp, PORT_CFG, draft_params=dp,
                                       draft_cfg=PORT_CFG, device='cpu',
                                       **kw)
    eng.start()
    return eng


def _jax_mk(jp, jd, **kw):
    kw.setdefault('slots', 4)
    kw.setdefault('max_len', MAX_LEN)
    kw.setdefault('spec_k', 3)
    eng = jax_engine.ContinuousEngine(jp, JAX_CFG, draft_params=jd,
                                      draft_cfg=JAX_CFG, **kw)
    eng.start()
    return eng


def _on_both(weights, drafts, script, **kw):
    """``script(engine)`` on the JAX engine, then on the port's, built
    with the same weights and options; returns (JAX's result, port's)."""
    (jp, pp), (jd, pd) = weights, drafts
    out = []
    for eng in (lambda: _jax_mk(jp, jd, **kw), lambda: _mk(pp, pd, **kw)):
        e = eng()
        try:
            out.append(script(e))
        finally:
            e.stop()
    return out


def _spec_counts(eng, rounds=False):
    st = eng.stats()['speculative']
    keys = ('k', 'proposals', 'accepted', 'acceptance_rate') + (
        ('rounds',) if rounds else ())
    return {key: st[key] for key in keys}


def test_spec_greedy_matches_generate_and_jax_with_divergent_draft(
        weights, draft):
    def script(eng):
        futs = [eng.submit(r, 6) for r in ROWS]
        return [f.result(timeout=300) for f in futs], _spec_counts(eng)
    (jout, jst), (pout, pst) = _on_both(weights, draft, script)
    assert pout == jout == [_solo(weights[1], r, 6) for r in ROWS]
    assert pst == jst and pst['proposals'] > 0


def test_spec_identical_draft_reaches_full_acceptance(weights):
    """Draft == target: every greedy proposal is the target's own argmax;
    acceptance 100%, and a round commits k+1 tokens."""
    row = [5, 6, 7, 8]

    def script(eng):
        return eng.submit(row, 9).result(timeout=300), _spec_counts(
            eng, rounds=True)
    (jout, jst), (pout, pst) = _on_both(weights, weights, script)
    assert pout == jout == _solo(weights[1], row, 9)
    assert pst == jst
    assert pst['acceptance_rate'] == 1.0 and pst['rounds'] <= 3


def test_spec_mid_stream_admission_stays_exact(weights, draft):
    pp, pd = weights[1], draft[1]
    eng = _mk(pp, pd)
    try:
        long_row = [3, 4, 5, 6]
        f1 = eng.submit(long_row, 20)
        deadline = time.time() + 60
        while eng.spec_rounds < 1 and time.time() < deadline:
            time.sleep(0.01)
        assert eng.spec_rounds >= 1, 'engine never started spec rounds'
        late_row = [9, 8, 7]
        f2 = eng.submit(late_row, 4)
        assert f2.result(timeout=120) == _solo(pp, late_row, 4)
        assert f1.result(timeout=120) == _solo(pp, long_row, 20)
    finally:
        eng.stop()


def test_spec_slot_reuse_resets_both_caches(weights, draft):
    def script(eng):
        a = eng.submit([1, 2, 3], 5).result(timeout=300)
        b = eng.submit([40, 41, 42, 43, 44, 45], 7).result(timeout=300)
        return [a, b], _spec_counts(eng, rounds=True)
    (jout, jst), (pout, pst) = _on_both(weights, draft, script, slots=1)
    assert pout == jout == [_solo(weights[1], [1, 2, 3], 5),
                            _solo(weights[1], [40, 41, 42, 43, 44, 45], 7)]
    assert pst == jst


def test_spec_with_kv_int8_matches_kv_int8_oracle(weights, draft):
    """int8 KV quantization is per position and deterministic, so the
    rollback replays exactly the codes sequential decode writes."""
    row = [7, 8, 9, 10]

    def script(eng):
        return eng.submit(row, 6).result(timeout=300), _spec_counts(eng)
    (jout, jst), (pout, pst) = _on_both(weights, draft, script,
                                        kv_quantize=True)
    assert pout == jout == _solo(weights[1], row, 6, kv_quantize=True)
    assert pst == jst


def test_spec_sampled_rows_advance_one_token_per_round(weights, draft):
    """A sampled request shares the spec engine (one token a round, drawn
    from the verify's position-0 logits), while a concurrent greedy
    request stays exact; top_k=1 sampling is greedy."""
    pp, pd = weights[1], draft[1]
    eng = _mk(pp, pd)
    try:
        g = eng.submit([5, 6, 7], 6)
        s = eng.submit([8, 9, 10], 6, temperature=1.0, top_k=8)
        one = eng.submit([11, 12, 13], 6, temperature=0.8, top_k=1)
        assert g.result(timeout=120) == _solo(pp, [5, 6, 7], 6)
        out = s.result(timeout=120)
        assert len(out) == 6 and all(0 <= t < 256 for t in out)
        assert one.result(timeout=120) == _solo(pp, [11, 12, 13], 6)
        st = eng.stats()['speculative']
        # Only the greedy request's rounds propose: its 5 decode tokens at
        # up to 4 a round.
        assert st['proposals'] % 3 == 0 and st['rounds'] >= 5
    finally:
        eng.stop()


def test_spec_eos_mid_window_stops_and_frees(weights):
    """An eos inside an accepted window truncates the emission at the stop
    id and frees the slot (the identical draft makes the window hold
    several accepted tokens)."""
    row = [5, 6, 7]
    solo = _solo(weights[1], row, 10)
    eos = solo[3]  # the greedy 4th token: mid-window at k=3

    def script(eng):
        got = eng.submit(row, 10, eos=eos).result(timeout=300)
        active = eng.stats()['active_slots']
        got2 = eng.submit(row, 4, eos=[99999]).result(timeout=300)
        return got, active, got2
    (jg, ja, jg2), (pg, pa, pg2) = _on_both(weights, weights, script)
    assert pg == jg == solo[:4] and pa == ja == 0
    assert pg2 == jg2 == solo[:4]


def test_spec_streaming_callback_sees_exact_stream(weights, draft):
    pp, pd = weights[1], draft[1]
    eng = _mk(pp, pd)
    try:
        seen = []
        row = [11, 12, 13]
        fut = eng.submit(row, 8, on_tokens=lambda t: seen.append(list(t)))
        want = _solo(pp, row, 8)
        assert fut.result(timeout=120) == want
        assert [t for chunk in seen for t in chunk] == want
        assert len(seen) > 1  # the first token, then each round's
    finally:
        eng.stop()


def test_spec_chunked_prefill_exact(weights, draft):
    """Long prompts chunk into BOTH caches and the output stays exact."""
    long_row = list(range(1, 31))  # 30 tokens -> 4 chunks each model
    short = [5, 6, 7]

    def script(eng):
        got = eng.submit(long_row, 6).result(timeout=300)
        st = eng.stats()
        got2 = eng.submit(short, 4).result(timeout=300)
        return (got, got2, st['prefill_chunks'], st['prefilling'],
                st['active_slots'], st['prefill_tokens'])
    jr, pr = _on_both(weights, draft, script, prefill_chunk=8)
    assert pr == jr
    assert pr[:2] == (_solo(weights[1], long_row, 6),
                      _solo(weights[1], short, 4))
    assert pr[2] >= 8 and pr[3:5] == (0, 0)
    assert pr[5] == 30  # the draft's chunks are not counted


def test_spec_with_prefix_cache_exact_on_repeat(weights, draft):
    """The prefix pool (target KV only) composes with spec: repeats hit
    the pool and stay exact; the draft re-prefills its own full row."""
    row = list(range(40, 60)) + [7, 8, 9]  # 23 tokens: 16-token bucket

    def script(eng):
        outs = [eng.submit(row, 6).result(timeout=300) for _ in range(3)]
        return outs, eng.stats()['prefix_cache']
    (jout, jst), (pout, pst) = _on_both(weights, draft, script,
                                        prefix_slots=4)
    assert pout == jout == [_solo(weights[1], row, 6)] * 3
    assert pst == jst and pst['hits'] >= 1


def test_spec_with_paged_kv_identical_draft(weights):
    """The verify is a multi-position paged forward (writes span blocks),
    rollback the same lengths rewind, and block reservations carry the
    k+1 window overhang."""
    row = [5, 6, 7, 8]

    def script(eng):
        got = eng.submit(row, 9).result(timeout=300)
        st = eng.stats()
        return (got, st['speculative']['acceptance_rate'], st['kv_layout'],
                st['kv_blocks']['free'] == st['kv_blocks']['total'] - 1,
                eng.prefix_share)
    jr, pr = _on_both(weights, weights, script, kv_layout='paged',
                      kv_block=16)
    assert pr == jr == (_solo(weights[1], row, 9), 1.0, 'paged', True,
                        False)


def test_spec_with_paged_kv_divergent_draft_and_reuse(weights, draft):
    rows = [[5, 6, 7], [8, 9, 10, 11], [12, 13, 14]]  # reuse

    def script(eng):
        futs = [eng.submit(r, 6) for r in rows]
        return [f.result(timeout=300) for f in futs], _spec_counts(eng)
    (jout, jst), (pout, pst) = _on_both(weights, draft, script,
                                        kv_layout='paged', kv_block=16,
                                        slots=2)
    assert pout == jout == [_solo(weights[1], r, 6) for r in rows]
    assert pst == jst


def test_spec_with_paged_kv_int8_and_eos(weights):
    pp = weights[1]
    row = [5, 6, 7]
    want = _solo(pp, row, 10, kv_quantize=True)
    eng = _mk(pp, pp, kv_layout='paged', kv_block=16, kv_quantize=True)
    try:
        got = eng.submit(row, 10, eos=want[3]).result(timeout=120)
        assert got == want[:4]
        assert eng.stats()['active_slots'] == 0
    finally:
        eng.stop()


def test_spec_submit_cap_reserves_window_overhang(weights, draft):
    """submit keeps prompt + max_new + the k+1 window inside max_len, and
    a request at the limit runs clear of the overflow assert (its write
    limit covers the overhang)."""
    pp, pd = weights[1], draft[1]
    eng = _mk(pp, pd, max_len=32)
    jeng = _jax_mk(weights[0], draft[0], max_len=32)
    try:
        for e in (eng, jeng):
            with pytest.raises(ValueError, match='verify window overhang'):
                e.submit(list(range(20)), 9)  # 29 > 32 - 4
        got = eng.submit(list(range(20)), 8).result(timeout=120)
        assert got == jeng.submit(list(range(20)), 8).result(timeout=300)
        assert got == _solo(pp, list(range(20)), 8, max_len=32)
        # The paged reservation covers the overhang: ceil((20+8+4)/16).
        assert eng._blocks_for(20, 8) == 2  # noqa: SLF001
    finally:
        eng.stop()
        jeng.stop()


def test_spec_options_resolve_as_the_jax_engine(weights, draft, monkeypatch):
    """Spec mode: serial rounds, no block sharing, SKYTPU_LLM_SPEC_K
    (default 4), the speculative stats block; refusals as JAX's."""
    (jp, pp), (jd, pd) = weights, draft
    monkeypatch.delenv('SKYTPU_LLM_SPEC_K', raising=False)
    for kw in ({}, dict(kv_layout='paged', kv_block=16)):
        j = jax_engine.ContinuousEngine(jp, JAX_CFG, slots=2, max_len=32,
                                        draft_params=jd, draft_cfg=JAX_CFG,
                                        **kw)
        p = port_engine.ContinuousEngine(pp, PORT_CFG, slots=2, max_len=32,
                                         draft_params=pd, draft_cfg=PORT_CFG,
                                         device='cpu', **kw)
        for attr in ('spec_k', 'pipeline_depth', 'prefix_share',
                     'kv_layout', '_submit_max'):
            assert getattr(p, attr) == getattr(j, attr), attr
        assert (p._kv_tiers is None) == (j._kv_tiers is None)  # noqa: SLF001
        assert p.stats()['speculative'] == j.stats()['speculative']
        assert p.stats()['speculative']['k'] == 4
    monkeypatch.setenv('SKYTPU_LLM_SPEC_K', '2')
    assert port_engine.ContinuousEngine(
        pp, PORT_CFG, slots=2, max_len=32, draft_params=pd,
        draft_cfg=PORT_CFG, device='cpu').spec_k == 2
    bad = {
        'k_zero': (dict(spec_k=0), 'spec_k must be'),
        'vocab': (dict(draft_cfg_vocab=300), 'share a vocabulary'),
        'half_pair': (dict(no_cfg=True), 'go together'),
    }
    for name, (kw, match) in bad.items():
        d_cfg_j, d_cfg_p = JAX_CFG, PORT_CFG
        if 'draft_cfg_vocab' in kw:
            d_cfg_j = dataclasses.replace(JAX_CFG, vocab_size=300)
            d_cfg_p = dataclasses.replace(PORT_CFG, vocab_size=300)
        opts = {k: v for k, v in kw.items() if k == 'spec_k'}
        if kw.get('no_cfg'):
            d_cfg_j = d_cfg_p = None
        with pytest.raises(ValueError, match=match):
            jax_engine.ContinuousEngine(jp, JAX_CFG, slots=2, max_len=32,
                                        draft_params=jd, draft_cfg=d_cfg_j,
                                        **opts)
        with pytest.raises(ValueError, match=match):
            port_engine.ContinuousEngine(pp, PORT_CFG, slots=2, max_len=32,
                                         draft_params=pd, draft_cfg=d_cfg_p,
                                         device='cpu', **opts)


def test_spec_rejects_moe_target(weights):
    jp, pp = weights
    moe_j = dataclasses.replace(jax_llama.MOE_TINY,
                                expert_capacity_factor=4.0)
    moe_params = jax_llama.init_params(jax.random.PRNGKey(7), moe_j)
    with pytest.raises(ValueError, match='dense target'):
        jax_engine.ContinuousEngine(moe_params, moe_j, draft_params=jp,
                                    draft_cfg=JAX_CFG)
    moe_p = dataclasses.replace(port_llama.MOE_TINY,
                                expert_capacity_factor=4.0)
    with pytest.raises(ValueError, match='dense target'):
        port_engine.ContinuousEngine(pp, moe_p, draft_params=pp,
                                     draft_cfg=PORT_CFG, device='cpu')


# -- the replica with a draft in the engine ---------------------------------------


def test_llm_server_engine_with_draft_roundtrip(weights, monkeypatch):
    """--draft-model rides the continuous engine: exact greedy output over
    the replica's /generate, streamed and not, and the engine's
    speculative counters in /health."""
    pp = weights[1]
    monkeypatch.setitem(port_llama.PRESETS, 'tiny-f32', PORT_CFG)
    server = port_srv.LlmServer('tiny-f32', max_len=MAX_LEN,
                                engine='continuous', draft_model='tiny-f32',
                                device='cpu')
    try:
        server.params = pp
        server.engine.params = pp
        assert server.engine.draft_params is server.draft_params
        row = [5, 6, 7, 8]
        status, body = server.generate({'tokens': [row],
                                        'max_new_tokens': 6})
        assert status == 200 and body['tokens'][0] == _solo(pp, row, 6)
        lines = []
        status, _ = server.generate({'tokens': [row], 'max_new_tokens': 6,
                                     'stream': True}, lines.append)
        assert status == 200 and lines[-1] == {'done': True}
        assert [t for x in lines[:-1] for t in x['tokens']] == \
            body['tokens'][0]
        status, health = server.health()
        spec = health['engine']['speculative']
        assert spec['rounds'] >= 1 and spec['k'] == 4
        assert health['draft_model'] == 'tiny-f32'
        assert health['engine']['pipeline']['pipeline_depth'] == 0
    finally:
        server.stop()


REPLICA_REFUSALS = {  # name -> (LlmServer kwargs, message)
    'moe_target': (dict(model='moe-tiny', draft_model='tiny'),
                   'dense target'),
    'unknown_draft': (dict(model='tiny', draft_model='gpt-5'),
                      'Unknown draft model'),
    'vocab': (dict(model='tiny', draft_model='bench-draft'),
              'share a vocabulary'),
}


@pytest.mark.parametrize('name', sorted(REPLICA_REFUSALS))
def test_llm_server_refuses_bad_drafts_as_jax(name):
    from skypilot_tpu.serve import llm_server as jax_srv
    kw, match = REPLICA_REFUSALS[name]
    kw = dict(kw)
    model = kw.pop('model')
    with pytest.raises(ValueError, match=match):
        jax_srv.LlmServer(model, max_len=64, engine='off', **kw)
    with pytest.raises(ValueError, match=match):
        port_srv.LlmServer(model, max_len=64, engine='off', device='cpu',
                           **kw)


@pytest.mark.parametrize('cut', ['max_new', 'eos'])
def test_spec_counts_only_what_a_cut_round_emits(weights, cut):
    """A greedy request that ends inside a round: with the identical
    draft (k=3) the first round accepts all 3 proposals, but ``max_new``
    3, or a stop id at the third token, leaves room for 2 of them after
    the prefill's token. The tokens equal JAX's engine. JAX adds k and a
    before the clamp and the stop (``engine.py:2767-2768``), so its
    counts exceed the 2 tokens the round emitted: a fault of the
    reference (ROADMAP section 3). The port counts after the cut: 2
    proposed, 2 accepted."""
    row = [5, 6, 7, 8]
    solo = _solo(weights[1], row, 9)
    kw = dict(max_new=3) if cut == 'max_new' else dict(max_new=9,
                                                       eos=[solo[2]])

    def script(eng):
        got = eng.submit(row, kw['max_new'],
                         eos=kw.get('eos')).result(timeout=300)
        return got, _spec_counts(eng, rounds=True)
    (jout, jst), (pout, pst) = _on_both(weights, weights, script)
    assert pout == jout == solo[:3]
    emitted = len(pout) - 1  # the first token is the prefill's
    assert jst['rounds'] == pst['rounds'] == 1
    assert jst['proposals'] == jst['accepted'] == 3 > emitted
    assert pst['proposals'] == pst['accepted'] == emitted == 2
    assert pst['acceptance_rate'] == 1.0
