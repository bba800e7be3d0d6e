"""Parity of the port's continuous engine (slot layout) with the JAX
engine and with the port's own solo ``generate``, on float32 TINY on the
CPU, plus its ``forward_cached(active_rows=...)`` against JAX's and the
profiler subset it uses.

Weights come from the JAX ``init_params`` and are carried over with
``params_from_numpy``. Every greedy stream must equal its solo
generation token for token, whatever slot it landed in, whenever it was
admitted and whatever junk the free slots decode. Sampled draws come from
a ``torch.Generator`` and differ from JAX's, so sampled rows are checked
for range and for their filters (top_k=1 is greedy).
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import engine as jax_engine
from skypilot_tpu.models import generate as jax_gen
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.observability import profiler as jax_profiler
from skypilot_tpu_torch.models import engine as port_engine
from skypilot_tpu_torch.models import generate as port_gen
from skypilot_tpu_torch.models import llama as port_llama
from skypilot_tpu_torch.observability import profiler as port_profiler

LOGIT_TOL = 1e-5
MAX_LEN = 64

JAX_CFG = dataclasses.replace(jax_llama.TINY, dtype=jnp.float32)
PORT_CFG = dataclasses.replace(port_llama.TINY, dtype=torch.float32)
ROWS = [[5, 6, 7], [8, 9, 10, 11, 12], [13, 14], [15, 16, 17, 18],
        [19, 20, 21]]  # more rows than the 4 slots: slots are reused


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


def _mk(pp, **kw):
    kw.setdefault('slots', 4)
    kw.setdefault('max_len', MAX_LEN)
    kw.setdefault('chunk_steps', 4)
    eng = port_engine.ContinuousEngine(pp, PORT_CFG, device='cpu', **kw)
    eng.start()
    return eng


# -- the engine against the JAX engine and the solo oracle -----------------------


def test_greedy_equals_solo_generate_and_the_jax_engine(weights):
    jp, pp = weights
    jeng = jax_engine.ContinuousEngine(jp, JAX_CFG, slots=4, max_len=MAX_LEN,
                                       chunk_steps=4)
    try:
        jfuts = [jeng.submit(r, 6) for r in ROWS]
        want = [f.result(timeout=300) for f in jfuts]
    finally:
        jeng.stop()
    eng = _mk(pp)
    try:
        got = [f.result(timeout=120) for f in [eng.submit(r, 6)
                                               for r in ROWS]]
        stats = eng.stats()
    finally:
        eng.stop()
    assert got == want
    assert got == [_solo(pp, r, 6) for r in ROWS]
    assert stats['prefills'] == len(ROWS)
    assert stats['active_slots'] == 0
    assert stats['tokens_emitted'] == 6 * len(ROWS)


def test_stats_keys_are_a_subset_of_the_jax_engines(weights):
    jp, pp = weights
    want = jax_engine.ContinuousEngine(jp, JAX_CFG, slots=2,
                                       max_len=32).stats()
    got = port_engine.ContinuousEngine(pp, PORT_CFG, slots=2, max_len=32,
                                       device='cpu').stats()
    assert set(got) <= set(want)
    assert set(got['pipeline']) == set(want['pipeline'])
    for key in ('slots', 'kv_layout', 'chunk_steps', 'prefill_batch',
                'role', 'kv_cache', 'prefix_cache', 'prefill_chunk',
                'prefill_chunks', 'prefilling', 'prefill_tokens_saved'):
        assert got[key] == want[key], key
    assert got['pipeline']['pipeline_depth'] == 1
    got = port_engine.ContinuousEngine(
        pp, PORT_CFG, slots=2, max_len=32, prefix_slots=3, prefill_chunk=8,
        device='cpu').stats()
    want = jax_engine.ContinuousEngine(jp, JAX_CFG, slots=2, max_len=32,
                                       prefix_slots=3,
                                       prefill_chunk=8).stats()
    assert set(got) <= set(want)
    for key in ('prefix_cache', 'prefill_chunk', 'prefill_chunks',
                'prefilling', 'prefill_tokens_saved'):
        assert got[key] == want[key], key
    assert got['prefix_cache']['slots'] == 3 and got['prefill_chunk'] == 8


def test_defaults_are_the_jax_engines(weights, monkeypatch):
    for var in ('SKYTPU_LLM_SLOTS', 'SKYTPU_LLM_CHUNK_STEPS',
                'SKYTPU_LLM_PREFILL_BATCH', 'SKYTPU_LLM_KV_CACHE',
                'SKYTPU_LLM_PIPELINE'):
        monkeypatch.delenv(var, raising=False)
    jp, pp = weights
    jeng = jax_engine.ContinuousEngine(jp, JAX_CFG)
    peng = port_engine.ContinuousEngine(pp, PORT_CFG, device='cpu')
    for attr in ('slots', 'max_len', 'chunk_steps', 'prefill_batch',
                 'kv_quantize', 'pipeline_depth', 'kv_layout', 'role'):
        assert getattr(peng, attr) == getattr(jeng, attr), attr
    monkeypatch.setenv('SKYTPU_LLM_SLOTS', '3')
    monkeypatch.setenv('SKYTPU_LLM_KV_CACHE', 'int8')
    monkeypatch.setenv('SKYTPU_LLM_PIPELINE', '0')
    peng = port_engine.ContinuousEngine(pp, PORT_CFG, max_len=32,
                                        device='cpu')
    assert (peng.slots, peng.kv_quantize, peng.pipeline_depth) == (3, True, 0)
    assert peng._cache.k.dtype == torch.int8  # noqa: SLF001


def test_mid_stream_admission(weights):
    """A request admitted while another is mid-decode perturbs neither."""
    _, pp = weights
    eng = _mk(pp, chunk_steps=2)
    try:
        long_row = [3, 4, 5, 6]
        f1 = eng.submit(long_row, 20)
        deadline = time.time() + 60
        while eng.chunks_run < 1 and time.time() < deadline:
            time.sleep(0.005)
        assert eng.chunks_run >= 1 and not f1.done()
        f2 = eng.submit([9, 8, 7], 4)
        assert f2.result(timeout=120) == _solo(pp, [9, 8, 7], 4)
        assert f1.result(timeout=120) == _solo(pp, long_row, 20)
    finally:
        eng.stop()


def test_slot_reuse_resets_cache_row(weights):
    _, pp = weights
    eng = _mk(pp, slots=1)
    try:
        assert eng.submit([1, 2, 3], 5).result(timeout=120) == \
            _solo(pp, [1, 2, 3], 5)
        row = [40, 41, 42, 43, 44, 45]
        assert eng.submit(row, 7).result(timeout=120) == _solo(pp, row, 7)
    finally:
        eng.stop()


def test_single_token_request_never_occupies_a_slot(weights):
    _, pp = weights
    eng = _mk(pp, slots=1)
    try:
        assert eng.submit([2, 3, 4], 1).result(timeout=120) == \
            _solo(pp, [2, 3, 4], 1)
        assert eng.stats()['active_slots'] == 0
        assert eng.stats()['chunks_run'] == 0  # resolved at prefill
    finally:
        eng.stop()


@pytest.mark.parametrize('pipeline', [True, False], ids=['pipelined',
                                                         'serial'])
def test_eos_mid_chunk_frees_the_slot(weights, pipeline):
    """The stop id lands mid-chunk (while, pipelined, the next chunk is in
    flight): the stream ends at it, inclusive, no junk is appended later,
    and the single slot is at once reusable."""
    _, pp = weights
    eng = _mk(pp, slots=1, chunk_steps=2, pipeline=pipeline)
    try:
        row = [5, 6, 7]
        solo = _solo(pp, row, 10)
        got = eng.submit(row, 10, eos=solo[3]).result(timeout=120)
        assert got == solo[:solo.index(solo[3]) + 1]
        assert eng.stats()['active_slots'] == 0
        other = [40, 41, 42, 43, 44, 45]
        assert eng.submit(other, 7).result(timeout=120) == \
            _solo(pp, other, 7)
        assert got == solo[:solo.index(solo[3]) + 1]
        # A stop set that is never hit runs to max_new.
        assert eng.submit(row, 4, eos=[999]).result(timeout=120) == solo[:4]
    finally:
        eng.stop()


def test_eos_on_the_first_token(weights):
    _, pp = weights
    eng = _mk(pp, slots=1)
    try:
        row = [5, 6, 7]
        first = _solo(pp, row, 1)[0]
        got = eng.submit(row, 10, eos=first).result(timeout=120)
        assert got == [first]
        assert eng.stats()['active_slots'] == 0
        other = [9, 8, 7]
        assert eng.submit(other, 3).result(timeout=120) == _solo(pp, other, 3)
        assert got == [first]  # the in-flight chunk appended nothing
    finally:
        eng.stop()


def test_oversized_request_is_refused_as_jax_refuses_it(weights):
    jp, pp = weights
    jeng = jax_engine.ContinuousEngine(jp, JAX_CFG, slots=2, max_len=32)
    peng = port_engine.ContinuousEngine(pp, PORT_CFG, slots=2, max_len=32,
                                        device='cpu')
    for eng in (jeng, peng):
        with pytest.raises(ValueError, match='max_len') as info:
            eng.submit([1] * 30, 8)
        assert 'exceeds engine max_len limit 32' in str(info.value)
        with pytest.raises(ValueError, match='top_k'):
            eng.submit([1], 2, top_p=0.0)


@pytest.mark.parametrize('n', [1, 15, 16, 17, 100, 1000, 1024])
def test_prompt_bucket_matches_jax(n):
    assert port_engine.prompt_bucket(n) == jax_engine.prompt_bucket(n)
    assert port_engine.prompt_bucket(n, lo=8) == \
        jax_engine.prompt_bucket(n, lo=8)


def test_per_slot_sampling_mix(weights):
    """Greedy, top_k=1 sampled and top-k sampled requests share the
    decode batch: the first two equal the greedy solo run, the third
    stays in the vocabulary."""
    _, pp = weights
    eng = _mk(pp, chunk_steps=2)
    try:
        g = eng.submit([5, 6, 7], 6)
        k1 = eng.submit([5, 6, 7], 6, temperature=1.5, top_k=1)
        s = eng.submit([8, 9, 10], 6, temperature=1.0, top_k=8, top_p=0.9)
        want = _solo(pp, [5, 6, 7], 6)
        assert g.result(timeout=120) == want
        assert k1.result(timeout=120) == want
        out = s.result(timeout=120)
        assert len(out) == 6 and all(0 <= t < PORT_CFG.vocab_size
                                     for t in out)
    finally:
        eng.stop()


def test_sampled_tokens_stay_in_the_top_k(weights):
    """Each sampled token of a top-k request is one of the k largest
    logits of the step that drew it (checked on the solo cache)."""
    _, pp = weights
    eng = _mk(pp, chunk_steps=3)
    try:
        row, k = [3, 4, 5], 3
        out = eng.submit(row, 8, temperature=2.0, top_k=k).result(
            timeout=120)
    finally:
        eng.stop()
    cache = port_gen.init_cache(PORT_CFG, 1, MAX_LEN, device='cpu')
    toks = torch.tensor([row], dtype=torch.int32)
    with torch.inference_mode():
        for t in out:
            logits, cache = port_gen.forward_cached(pp, toks, cache,
                                                    PORT_CFG)
            assert t in torch.topk(logits[0], k).indices.tolist()
            toks = torch.tensor([[t]], dtype=torch.int32)


def test_streaming_callback_is_exact(weights):
    _, pp = weights
    eng = _mk(pp, chunk_steps=2)
    try:
        chunks = []
        fut = eng.submit([5, 6, 7], 7, on_tokens=chunks.append)
        final = fut.result(timeout=120)
        assert final == _solo(pp, [5, 6, 7], 7)
        time.sleep(0.3)  # let any stale in-flight retirement land
        assert [t for c in chunks for t in c] == final
        assert len(chunks) >= 4  # the first token, then 3 chunks of 2
    finally:
        eng.stop()


def test_raising_callback_stays_isolated(weights):
    _, pp = weights
    eng = _mk(pp, chunk_steps=2)
    try:
        def boom(_):
            raise RuntimeError('client went away')
        bad = eng.submit([1, 2, 3], 6, on_tokens=boom)
        good_chunks = []
        good = eng.submit([9, 8, 7], 6, on_tokens=good_chunks.append)
        assert good.result(timeout=120) == _solo(pp, [9, 8, 7], 6)
        assert bad.result(timeout=120) == _solo(pp, [1, 2, 3], 6)
        assert [t for c in good_chunks for t in c] == good.result()
    finally:
        eng.stop()


def test_survives_a_forced_failure(weights):
    """A failed call fails the waiters with the real error at once,
    rebuilds the device state and keeps serving."""
    import concurrent.futures as cf
    _, pp = weights
    eng = _mk(pp)
    try:
        assert eng.submit([1, 2, 3], 4).result(timeout=120) == \
            _solo(pp, [1, 2, 3], 4)
        eng._cache = None  # noqa: SLF001 -- sabotage the device state
        with pytest.raises(Exception) as info:
            eng.submit([4, 5, 6], 4).result(timeout=120)
        assert not isinstance(info.value, cf.TimeoutError)
        assert eng.submit([7, 8, 9], 4).result(timeout=120) == \
            _solo(pp, [7, 8, 9], 4)
    finally:
        eng.stop()


def test_stop_fails_what_is_left(weights):
    _, pp = weights
    eng = port_engine.ContinuousEngine(pp, PORT_CFG, slots=1, max_len=32,
                                       device='cpu')
    eng._pending.append(eng._build_request(  # noqa: SLF001
        [1, 2], 3, 0.0, None, 0, 1.0, None))
    fut = eng._pending[0].future  # noqa: SLF001
    eng.stop()  # no thread ever ran: the queued request fails
    with pytest.raises(RuntimeError, match='engine stopped'):
        fut.result(timeout=5)


def test_kv_int8_equals_generate_kv_quantize(weights):
    _, pp = weights
    eng = _mk(pp, kv_quantize=True)
    try:
        rows = [[5, 6, 7], [8, 9, 10, 11], [13, 14]]
        futs = [eng.submit(r, 6) for r in rows]
        for row, fut in zip(rows, futs):
            assert fut.result(timeout=120) == _solo(pp, row, 6,
                                                    kv_quantize=True), row
        assert eng.stats()['kv_cache'] == 'int8'
    finally:
        eng.stop()


# -- the pipeline ---------------------------------------------------------------


def test_pipelined_default_reports_overlap(weights):
    _, pp = weights
    eng = _mk(pp)
    assert eng.pipeline_depth == 1
    try:
        futs = [eng.submit(r, 6) for r in ROWS]
        for row, fut in zip(ROWS, futs):
            assert fut.result(timeout=120) == _solo(pp, row, 6), row
        pl = eng.stats()['pipeline']
        assert pl['pipeline_depth'] == 1 and pl['dispatches'] >= 2
        assert pl['host_overlap_ms'] > 0 and pl['dispatch_gap_ms'] > 0
    finally:
        eng.stop()


def test_pipelined_output_identical_to_serial(weights):
    _, pp = weights
    rows = ROWS + [[3, 4]]
    results = {}
    for pipe in (True, False):
        eng = _mk(pp, chunk_steps=2, pipeline=pipe)
        assert eng.pipeline_depth == (1 if pipe else 0)
        try:
            results[pipe] = [f.result(timeout=120)
                             for f in [eng.submit(r, 7) for r in rows]]
        finally:
            eng.stop()
    assert results[True] == results[False]
    assert results[True] == [_solo(pp, r, 7) for r in rows]


def test_serial_engine_reports_bubble_not_overlap(weights):
    _, pp = weights
    eng = _mk(pp, pipeline=False)
    try:
        for f in [eng.submit([i + 2, i + 3], 6) for i in range(4)]:
            f.result(timeout=120)
        pl = eng.stats()['pipeline']
        assert pl['pipeline_depth'] == 0 and pl['dispatches'] >= 2
        assert pl['bubble_ms'] > 0 and pl['host_overlap_ms'] == 0
    finally:
        eng.stop()


def test_idle_engine_wakes_on_submit(weights, monkeypatch):
    """The idle loop parks in a long wait; a submit wakes it through the
    event, well inside a deadline the wait alone would blow."""
    _, pp = weights
    monkeypatch.setattr(port_engine, '_IDLE_WAIT_S', 30.0)
    eng = _mk(pp)
    try:
        assert eng.submit([1, 2, 3], 4).result(timeout=120) == \
            _solo(pp, [1, 2, 3], 4)
        time.sleep(0.3)  # parked in the 30 s idle wait
        assert eng.submit([4, 5, 6], 4).result(timeout=10) == \
            _solo(pp, [4, 5, 6], 4)
    finally:
        eng.stop()


# -- junk rows past max_len -------------------------------------------------------


def test_idle_slot_decodes_past_max_len_without_fault(weights):
    """slots=2, max_len=32: requests one after another keep slot 0 busy
    while slot 1 idles for more than 32 decode steps, so its length runs
    past max_len. No error, and every output equals its solo run."""
    _, pp = weights
    eng = _mk(pp, slots=2, max_len=32)
    try:
        for i in range(5):
            row = [i + 1, i + 2, i + 3]
            assert eng.submit(row, 12).result(timeout=120) == \
                _solo(pp, row, 12, max_len=32), i
        stats = eng.stats()
        steps = stats['pipeline']['dispatches'] * stats['chunk_steps']
        assert steps > 32
        assert int(eng._cache.lengths.max()) > 32  # noqa: SLF001
    finally:
        eng.stop()


@pytest.mark.parametrize('s, lengths', [(1, [5, 7, 20]), (4, [0, 3, 14])],
                         ids=['decode', 'block'])
def test_forward_cached_active_rows_matches_jax(weights, s, lengths):
    """An inactive row whose start is past M - S writes where JAX's
    dynamic_update_slice clamps it; live rows' logits agree within 1e-5
    and the caches agree."""
    jp, pp = weights
    m, b = 16, 3
    rng = np.random.default_rng(5)
    lens = np.asarray(lengths, np.int32)
    k0 = rng.standard_normal((2, b, 2, m, 16)).astype(np.float32)
    v0 = rng.standard_normal((2, b, 2, m, 16)).astype(np.float32)
    tokens = rng.integers(0, 256, (b, s)).astype(np.int32)
    active = np.asarray([True, True, False])
    row_lens = np.full((b,), s, np.int32)
    jc = jax_gen.KVCache(k=jnp.asarray(k0), v=jnp.asarray(v0),
                         lengths=jnp.asarray(lens))
    jlog, jc = jax_gen.forward_cached(jp, jnp.asarray(tokens), jc, JAX_CFG,
                                      jnp.asarray(row_lens),
                                      jnp.asarray(active))
    pc = port_gen.KVCache(k=torch.from_numpy(k0.copy()),
                          v=torch.from_numpy(v0.copy()),
                          lengths=torch.from_numpy(lens.copy()))
    plog, pc = port_gen.forward_cached(pp, torch.from_numpy(tokens), pc,
                                       PORT_CFG, torch.from_numpy(row_lens),
                                       torch.from_numpy(active))
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog),
                               atol=LOGIT_TOL, rtol=0)
    np.testing.assert_array_equal(pc.lengths.numpy(), np.asarray(jc.lengths))
    for got, want in ((pc.k, jc.k), (pc.v, jc.v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_TOL, rtol=0)
        # The live rows' positions outside this step's write are untouched.
        np.testing.assert_array_equal(got.numpy()[:, :2, :, :lengths[0]],
                                      k0[:, :2, :, :lengths[0]]
                                      if got is pc.k else
                                      v0[:, :2, :, :lengths[0]])


def test_active_rows_keep_the_overflow_assert(weights):
    _, pp = weights
    cache = port_gen.init_cache(PORT_CFG, 2, 8, device='cpu')
    cache.lengths.copy_(torch.tensor([8, 3], dtype=torch.int32))
    tok = torch.zeros((2, 1), dtype=torch.int32)
    ones = torch.ones((2,), dtype=torch.int32)
    with pytest.raises(RuntimeError, match='overflow'):
        port_gen.forward_cached(pp, tok, cache, PORT_CFG, ones,
                                torch.tensor([True, True]))
    _, out = port_gen.forward_cached(pp, tok, cache, PORT_CFG, ones,
                                     torch.tensor([False, True]))
    assert out.lengths.tolist() == [9, 4]


def _preload(eng, jobs):
    """Queue ``jobs`` [(row, max_new, eos)] before the engine's thread
    starts, so the first admission takes them as one group (slots in
    order) on either engine; returns their futures."""
    reqs = [eng._build_request(row, n, 0.0, None, 0, 1.0, eos)  # noqa: SLF001
            for row, n, eos in jobs]
    with eng._lock:  # noqa: SLF001
        eng._pending.extend(reqs)  # noqa: SLF001
    eng.start()
    return [r.future for r in reqs]


def test_active_rows_is_the_dispatch_snapshot_like_jax(weights, monkeypatch):
    """Request B (slot 1) stops at an eos mid-chunk while A (slot 0) runs
    on. JAX's ``active`` is the host's slot snapshot at dispatch; the
    port's mask, at every step of every chunk, is a subset of it, and from
    the chunk issued after the retirement that freed B's slot it is False
    there, as JAX's is. The MoE routing mask (``route_rows``) is JAX's
    snapshot itself at every step. Greedy tokens are unchanged."""
    jp, pp = weights
    a_row, b_row = [3, 4, 5], [9, 8, 7, 6]
    solo_b = _solo(pp, b_row, 12)
    j = next(j for j in range(2, 12) if solo_b[j] not in solo_b[:j])
    jobs = [(a_row, 20, None), (b_row, 12, solo_b[j])]
    masks = {'jax': [], 'port': []}
    routes = []  # the port's route_rows, per chunk and step
    b_done = {'jax': [], 'port': []}  # B resolved when the chunk was issued
    futs = {}
    jax_chunk, port_chunk = jax_engine._jit_chunk, port_engine._chunk  # noqa: SLF001
    port_fwd = port_gen.forward_cached

    def jchunk(*args, **kw):
        masks['jax'].append(np.asarray(args[8]).copy())  # active
        b_done['jax'].append(futs['jax'][1].done())
        return jax_chunk(*args, **kw)

    def pchunk(*args, **kw):
        masks['port'].append([])
        routes.append([])
        b_done['port'].append(futs['port'][1].done())
        return port_chunk(*args, **kw)

    def pfwd(params, tokens, cache, cfg, row_lens=None, active_rows=None,
             **kw):
        if active_rows is not None:  # a decode step of a chunk
            masks['port'][-1].append(active_rows.clone().numpy())
            routes[-1].append(kw['route_rows'].clone().numpy())
        return port_fwd(params, tokens, cache, cfg, row_lens, active_rows,
                        **kw)

    monkeypatch.setattr(jax_engine, '_jit_chunk', jchunk)
    monkeypatch.setattr(port_engine, '_chunk', pchunk)
    monkeypatch.setattr(port_gen, 'forward_cached', pfwd)
    out = {}
    for name, eng in (('jax', jax_engine.ContinuousEngine(
            jp, JAX_CFG, slots=2, max_len=MAX_LEN, chunk_steps=4)),
            ('port', port_engine.ContinuousEngine(
                pp, PORT_CFG, slots=2, max_len=MAX_LEN, chunk_steps=4,
                device='cpu'))):
        try:
            futs[name] = _preload(eng, jobs)
            out[name] = [f.result(timeout=300) for f in futs[name]]
        finally:
            eng.stop()
    monkeypatch.undo()
    assert out['port'] == out['jax']
    assert out['port'] == [_solo(pp, a_row, 20), solo_b[:j + 1]]
    assert b_done['port'] == b_done['jax']
    assert len(masks['port']) == len(masks['jax'])
    after = 0
    for jm, steps, route, done in zip(masks['jax'], masks['port'], routes,
                                      b_done['port']):
        assert len(steps) == len(route) == 4
        for pm, rm in zip(steps, route):
            assert not (pm & ~jm).any(), (pm, jm)
            assert np.array_equal(rm, jm), (rm, jm)
        if done:
            assert not jm[1] and not any(pm[1] for pm in steps)
            after += bool(jm[0])
    assert after >= 1  # A was still decoding after B's slot was freed


def _jax_mk(jp, **kw):
    kw.setdefault('slots', 4)
    kw.setdefault('max_len', MAX_LEN)
    kw.setdefault('chunk_steps', 4)
    eng = jax_engine.ContinuousEngine(jp, JAX_CFG, **kw)
    eng.start()
    return eng


def _on_both(weights, script, **kw):
    """``script(engine)`` on the JAX engine, then on the port's, both built
    with the options ``kw``; returns (JAX's result, the port's)."""
    jp, pp = weights
    out = []
    for mk, params in ((_jax_mk, jp), (_mk, pp)):
        eng = mk(params, **kw)
        try:
            out.append(script(eng))
        finally:
            eng.stop()
    return out


def _pool_stats(eng):
    st = eng.stats()
    return dict(st['prefix_cache'], saved=st['prefill_tokens_saved'],
                chunks=st['prefill_chunks'])


# -- the prefix pool against the JAX engine -------------------------------------


def test_prefix_pool_exact_on_repeat(weights):
    """Second sighting stores the 16-token prefix; the third request
    gathers it and prefills only the suffix, and still equals the solo
    generation."""
    row = list(range(1, 25))

    def script(eng):
        return ([eng.submit(row, 5).result(timeout=300) for _ in range(3)],
                _pool_stats(eng))
    (jout, jst), (pout, pst) = _on_both(weights, script, prefix_slots=4)
    assert pout == jout == [_solo(weights[1], row, 5)] * 3
    assert pst == jst
    assert (pst['stores'], pst['entries'], pst['hits'], pst['hit_tokens'],
            pst['saved']) == (1, 1, 1, 16, 16)


def test_prefix_pool_shared_prefix_variants(weights):
    """Prompts sharing a stored 16-token prefix all hit the pool, grouped
    or not, and each equals its own solo generation."""
    base = list(range(1, 17))
    variants = [base + [50 + i, 60 + i] for i in range(3)]

    def script(eng):
        for _ in range(2):
            eng.submit(base + [40], 3).result(timeout=300)
        stores = eng.stats()['prefix_cache']['stores']
        futs = [eng.submit(v, 6) for v in variants]
        return [f.result(timeout=300) for f in futs], stores, _pool_stats(eng)
    (jout, jstores, jst), (pout, pstores, pst) = _on_both(
        weights, script, prefix_slots=4)
    assert pout == jout == [_solo(weights[1], v, 6) for v in variants]
    assert pstores == jstores == 1
    assert pst == jst and pst['hits'] == 3 and pst['hit_tokens'] == 48


def test_prefix_pool_eviction_and_reuse(weights):
    """One pool row, two alternating prefixes: LRU eviction recycles the
    row and outputs stay exact."""
    a, b = list(range(1, 20)), list(range(100, 119))

    def script(eng):
        outs = [eng.submit(row, 4).result(timeout=300)
                for _ in range(2) for row in (a, b)]
        return outs, _pool_stats(eng)
    (jout, jst), (pout, pst) = _on_both(weights, script, prefix_slots=1)
    assert pout == jout == [_solo(weights[1], r, 4) for r in (a, b, a, b)]
    assert pst == jst and pst['entries'] == 1 and pst['stores'] == 2


def test_prefix_pool_with_kv_int8(weights):
    """Pool rows carry int8 codes and scales verbatim: reuse equals the
    solo int8-KV generation."""
    row = list(range(3, 27))

    def script(eng):
        return ([eng.submit(row, 5).result(timeout=300) for _ in range(3)],
                _pool_stats(eng))
    (jout, jst), (pout, pst) = _on_both(weights, script, prefix_slots=2,
                                        kv_quantize=True)
    assert pout == jout == [_solo(weights[1], row, 5, kv_quantize=True)] * 3
    assert pst == jst and pst['hits'] == 1


def test_prefix_pool_demotion_near_max_len(weights):
    """A hit whose padded suffix would run past max_len is demoted to a
    full prefill (the port's cache write would raise; JAX's would clamp
    over the prefix): exact output, no hit counted, no fault."""
    short = list(range(1, 18))
    long_row = short[:16] + list(range(200, 246))  # 62: 16 + bucket(46) > 64

    def script(eng):
        for _ in range(2):
            eng.submit(short, 3).result(timeout=300)
        return eng.submit(long_row, 2).result(timeout=300), _pool_stats(eng)
    (jout, jst), (pout, pst) = _on_both(weights, script, prefix_slots=2)
    assert pout == jout == _solo(weights[1], long_row, 2)
    assert pst == jst and pst['stores'] == 1 and pst['hit_tokens'] == 0


# -- chunked prefill against the JAX engine -------------------------------------


def test_chunked_prefill_exact(weights):
    """A 30-token prompt with prefill_chunk 8 advances in 4 chunks and
    equals the solo generation; short prompts keep the grouped path."""
    long_row, short = list(range(1, 31)), [5, 6, 7]

    def script(eng):
        got = eng.submit(long_row, 6).result(timeout=300)
        st = eng.stats()
        return (got, eng.submit(short, 4).result(timeout=300),
                st['prefill_chunks'], st['prefilling'], st['active_slots'],
                eng.stats()['prefill_chunks'])
    jout, pout = _on_both(weights, script, prefill_chunk=8)
    assert pout == jout
    assert pout[:2] == (_solo(weights[1], long_row, 6),
                        _solo(weights[1], short, 4))
    assert pout[2:] == (4, 0, 0, 4)


def test_chunked_prefill_interleaves_with_decode(weights):
    """A short request keeps decoding while a 40-token prompt chunks in,
    4 tokens a chunk: both exact, 10 chunks, and decode chunks ran while
    the long prompt was prefilling."""
    short, long_row = [9, 8, 7], list(range(1, 41))

    def script(eng):
        f_short = eng.submit(short, 12)
        f_long = eng.submit(long_row, 4)
        return ([f_short.result(timeout=300), f_long.result(timeout=300)],
                eng.stats()['prefill_chunks'])
    (jout, jchunks), (pout, pchunks) = _on_both(
        weights, script, prefill_chunk=4, chunk_steps=2)
    assert pout == jout == [_solo(weights[1], short, 12),
                            _solo(weights[1], long_row, 4)]
    assert pchunks == jchunks == 10


def test_chunked_prefill_parks_until_a_slot_frees(weights):
    """One slot, busy: the finished long prefill parks and lands once the
    slot frees; exact output."""
    holder, long_row = [3, 4, 5], list(range(10, 30))

    def script(eng):
        f1 = eng.submit(holder, 10)
        f2 = eng.submit(long_row, 3)
        return [f1.result(timeout=300), f2.result(timeout=300)]
    jout, pout = _on_both(weights, script, slots=1, prefill_chunk=4,
                          chunk_steps=2)
    assert pout == jout == [_solo(weights[1], holder, 10),
                            _solo(weights[1], long_row, 3)]


def test_chunked_prefill_with_the_prefix_pool(weights):
    """The second sighting of a 40-token prompt stores its 32-token
    prefix; the third seeds its chunked prefill from the pool and runs
    exactly 1 chunk (8 tokens) instead of 5."""
    long_row = list(range(1, 41))

    def script(eng):
        outs = [eng.submit(long_row, 4).result(timeout=300)
                for _ in range(2)]
        before = eng.stats()['prefill_chunks']
        outs.append(eng.submit(long_row, 4).result(timeout=300))
        return outs, eng.stats()['prefill_chunks'] - before, _pool_stats(eng)
    (jout, jd, jst), (pout, pd, pst) = _on_both(
        weights, script, prefill_chunk=8, prefix_slots=4)
    assert pout == jout == [_solo(weights[1], long_row, 4)] * 3
    assert pd == jd == 1
    assert pst == jst
    assert (pst['stores'], pst['hits'], pst['hit_tokens']) == (1, 1, 32)


# -- options not ported yet -------------------------------------------------------


def _data_mesh():
    """A mesh with a data axis: the one mesh axis serving does not take
    yet (tensor parallelism is tests/test_torch_tp.py's)."""
    from skypilot_tpu_torch.parallel import mesh as port_mesh
    sizes = {a: 1 for a in port_mesh.AXIS_ORDER}
    return port_mesh.Mesh(dict(sizes, data=2, tensor=2),
                          torch.device('cpu'))


UNPORTED = {
    'mesh': dict(mesh=_data_mesh()),
}
# Refused until the paged layout, block sharing and KV tiers, draft
# rounds (a draft model, paged or not) and the prefill and decode roles
# were ported; now accepted and resolved as the JAX engine resolves them
# (block sharing only on the paged layout and without a draft, tiers only
# with sharing, serial rounds with a draft; every role still serves
# submit). 'draft' and 'draft_params' name the pair; a half pair is
# refused with JAX's ValueError.
PORTED = {
    'paged': dict(kv_layout='paged'),
    'block_sharing': dict(prefix_share=True),
    'kv_tiers': dict(kv_tiers=True),
    'draft': dict(draft=True),
    'draft_params': dict(draft=True, kv_layout='paged'),
    'draft_half_pair': dict(draft='half'),
    'prefill_role': dict(role='prefill'),
    'decode_role': dict(role='decode'),
}


@pytest.mark.parametrize('name', sorted(set(UNPORTED) | set(PORTED)))
def test_unported_options_raise_at_construction(weights, name):
    jp, pp = weights
    if name in UNPORTED:
        with pytest.raises(NotImplementedError, match='not ported yet'):
            port_engine.ContinuousEngine(pp, PORT_CFG, slots=2, max_len=32,
                                         device='cpu', **UNPORTED[name])
        return
    opts = dict(PORTED[name])
    draft = opts.pop('draft', None)
    jkw, pkw = dict(opts), dict(opts)
    if draft == 'half':  # draft_params without draft_cfg, and the reverse
        for kw in (dict(draft_params=jp), dict(draft_cfg=JAX_CFG)):
            with pytest.raises(ValueError, match='go together'):
                jax_engine.ContinuousEngine(jp, JAX_CFG, slots=2,
                                            max_len=32, **kw)
        for kw in (dict(draft_params=pp), dict(draft_cfg=PORT_CFG)):
            with pytest.raises(ValueError, match='go together'):
                port_engine.ContinuousEngine(pp, PORT_CFG, slots=2,
                                             max_len=32, device='cpu', **kw)
        return
    if draft:
        jkw.update(draft_params=jp, draft_cfg=JAX_CFG, spec_k=2)
        pkw.update(draft_params=pp, draft_cfg=PORT_CFG, spec_k=2)
    jeng = jax_engine.ContinuousEngine(jp, JAX_CFG, slots=2, max_len=32,
                                       **jkw)
    eng = port_engine.ContinuousEngine(pp, PORT_CFG, slots=2, max_len=32,
                                       device='cpu', **pkw)
    try:
        for attr in ('kv_layout', 'prefix_share', 'pipeline_depth',
                     'role'):
            assert getattr(eng, attr) == getattr(jeng, attr), attr
        assert (eng._kv_tiers is None) == (jeng._kv_tiers is None)  # noqa: SLF001
        row = [5, 6, 7]
        assert eng.submit(row, 4).result(timeout=120) == _solo(pp, row, 4)
    finally:
        eng.stop()


def test_unported_methods_and_bad_options(weights):
    _, pp = weights
    eng = port_engine.ContinuousEngine(pp, PORT_CFG, slots=2, max_len=32,
                                       device='cpu')
    # The roles' methods are ported (tests/test_torch_disagg.py): on a
    # colocated slot engine an export works, a paged handoff is refused
    # as JAX refuses it, and sharing is off.
    try:
        handoff = eng.submit_prefill([1, 2, 3], 2).result(timeout=120)
        assert (handoff.layout, handoff.prompt_len) == ('slot', 3)
        with pytest.raises(ValueError, match='layout'):
            eng.submit_import([1], 2, 3)
        assert eng.probe_chain([1]) == 0
        assert eng.resolve_chains([]) == []
    finally:
        eng.stop()
    with pytest.raises(ValueError, match='kv_layout'):
        port_engine.ContinuousEngine(pp, PORT_CFG, kv_layout='dense',
                                     device='cpu')
    with pytest.raises(ValueError, match='role'):
        port_engine.ContinuousEngine(pp, PORT_CFG, role='router',
                                     device='cpu')
    # MoE is ported: the engine builds, with the JAX engine's MoE rules.
    moe = port_engine.ContinuousEngine(
        port_llama.init_params(port_llama.MOE_TINY,
                               torch.Generator().manual_seed(0), 'cpu'),
        port_llama.MOE_TINY, prefix_slots=4, prefill_chunk=8,
        device='cpu')
    assert (moe.pipeline_depth, moe.prefix_slots, moe.prefill_chunk) == \
        (0, 0, 0)


# -- the profiler subset ----------------------------------------------------------


def test_profiled_counts_calls_and_times_first_shapes(monkeypatch):
    ledger = port_profiler.Ledger()
    fn = port_profiler.profiled('engine.chunk', lambda x: x * 2, ledger)
    monkeypatch.setenv('SKYTPU_PROFILE', '0')
    assert fn(torch.ones(2)).tolist() == [2.0, 2.0]
    assert ledger.snapshot() == {'enabled': False}
    monkeypatch.setenv('SKYTPU_PROFILE', '1')
    fn(torch.ones(2))
    fn(torch.ones(2))
    fn(torch.ones(3))
    snap = ledger.snapshot()
    prog = snap['compile']['engine.chunk']
    assert snap['calls']['engine.chunk'] == 4
    assert sorted(prog['shapes']) == ['float32[2]', 'float32[3]']
    assert prog['compiles'] == 2 and prog['compile_ms'] >= 0.0
    ledger.reset()
    assert ledger.snapshot()['calls']['engine.chunk'] == 0


def test_tree_nbytes_and_logical_memory_match_jax(monkeypatch):
    rng = np.random.default_rng(0)
    tree = {'a': rng.standard_normal((3, 4)).astype(np.float32),
            'b': [rng.integers(0, 9, (5,)).astype(np.int8),
                  rng.standard_normal((2, 2)).astype(np.float32)]}
    ported = {'a': torch.from_numpy(tree['a']),
              'b': [torch.from_numpy(x) for x in tree['b']]}
    assert port_profiler.tree_nbytes(ported) == \
        jax_profiler.tree_nbytes(tree)
    cache = port_gen.init_cache(PORT_CFG, 2, 8, quantize=True, device='cpu')
    assert port_profiler.tree_nbytes(cache) == sum(
        t.numel() * t.element_size()
        for t in (cache.k, cache.v, cache.lengths, cache.k_s, cache.v_s))
    ledger = port_profiler.Ledger()
    ledger.register_logical('kv_cache', 100)
    ledger.register_logical('kv_cache', 120)  # re-registering replaces
    assert ledger.logical_bytes() == {'kv_cache': 120}
    monkeypatch.setenv('SKYTPU_PROFILE', '1')
    mem = ledger.sample_device_memory('cpu')
    assert mem['logical_bytes'] == 120
    assert ledger.snapshot()['device_memory'] == mem


def test_engine_registers_its_cache(weights):
    _, pp = weights
    eng = port_engine.ContinuousEngine(pp, PORT_CFG, slots=2, max_len=32,
                                       device='cpu')
    assert port_profiler.logical_bytes()['kv_cache'] == \
        port_profiler.tree_nbytes(eng._cache)  # noqa: SLF001
