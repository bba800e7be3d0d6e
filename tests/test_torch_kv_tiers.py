"""The port's KV tiers (``serve/kv_tiers.py``) against the JAX package's,
on the CPU.

Counterparts of ``tests/test_kv_tiers.py`` on the port's module: the host
pool's accounting and decayed-hotness eviction, the spill segments'
round trip and torn-write invariants (a truncated, clobbered or
bit-flipped segment is invisible or fails its crc32), quarantine on a
corrupt fetch or promote, the tier-tagged adverts. Segment files are
byte for byte JAX's, and each package reads the other's. The engine
cases run the JAX engine and the port's on the same requests (float32
TINY): demote, spill, fetch and promote, and a corrupt spill falling
back to recompute, with greedy tokens equal to JAX's; and the reference
fault the port works around: JAX's tiers expect bf16 K/V planes, so a
float32 pool's chains quarantine there and promote here.
"""
import dataclasses
import os
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from skypilot_tpu.models import engine as jax_engine
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.serve import kv_tiers as jax_tiers
from skypilot_tpu.utils import atomic_io as jax_atomic_io
from skypilot_tpu_torch.models import engine as port_engine
from skypilot_tpu_torch.models import generate as port_gen
from skypilot_tpu_torch.models import llama as port_llama
from skypilot_tpu_torch.serve import kv_tiers
from skypilot_tpu_torch.utils import atomic_io


def _tiers(host_bytes=1 << 20, spill_dir='', fetch_max=2, lib=kv_tiers,
           **kw):
    return lib.KVTiers(block=4, n_layers=2, n_kv_heads=1, head_dim=3,
                       quantized=kw.pop('quantized', True),
                       host_bytes=host_bytes, spill_dir=spill_dir,
                       fetch_max=fetch_max, **kw)


def _arrays(tiers, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, dtype) in tiers._plane_spec.items():  # noqa: SLF001
        if dtype == 'int8':
            out[name] = rng.integers(-8, 8, size=shape).astype(np.int8)
        elif dtype == 'bfloat16':  # storage words, as the port holds them
            out[name] = rng.standard_normal(shape).astype(
                ml_dtypes.bfloat16).view(np.uint16)
        else:
            out[name] = rng.standard_normal(shape).astype(np.float32)
    return out


def _entry(tiers, digest, row, seed=0, lib=kv_tiers):
    planes = [tiers._plane(n, a) for n, a in _arrays(tiers, seed).items()]  # noqa: SLF001
    return lib.TierEntry(digest, list(row), planes)


# -- HostPool ------------------------------------------------------------------------


def test_host_pool_accounting_and_pop():
    t = _tiers()
    pool = t._host  # noqa: SLF001
    a = _entry(t, b'a' * 8, range(4), seed=1)
    b = _entry(t, b'b' * 8, range(8), seed=2)
    pool.insert(a)
    pool.insert(b)
    assert pool.bytes == a.nbytes + b.nbytes
    assert b'a' * 8 in pool and b'b' * 8 in pool
    got = pool.pop(b'a' * 8)
    assert got is a and pool.bytes == b.nbytes
    assert pool.pop(b'missing!') is None and pool.bytes == b.nbytes


def test_host_pool_decayed_hotness_protects_hot_oldtimer():
    t = _tiers()
    pool = t._host  # noqa: SLF001
    hot = _entry(t, b'hot_8byt', range(4), seed=1)
    pool.insert(hot)
    for _ in range(4):
        pool.touch(hot.digest)
    cold = _entry(t, b'cold8byt', range(4), seed=2)
    pool.insert(cold)
    assert pool.evict_cold() is cold
    assert hot.digest in pool


# -- SpillStore: the segment format and its torn-write invariants -----------------------


def test_spill_segment_roundtrip_range_read(tmp_path):
    t = _tiers()
    store = kv_tiers.SpillStore(str(tmp_path))
    e1 = _entry(t, b'digest_1', range(4), seed=1)
    e2 = _entry(t, b'digest_2', range(8), seed=2)
    want = {e.digest: {p['name']: p['data'] for p in e.planes}
            for e in (e1, e2)}
    path = store.write_segment([e1, e2])
    assert path is not None and os.path.exists(path)
    store.admit(path, [e1, e2])
    assert store.bytes == e1.nbytes + e2.nbytes
    cache = {}
    for digest in (e1.digest, e2.digest):
        p, rec = store.index[digest]
        planes = kv_tiers.SpillStore.read_entry(p, rec, cache)
        assert {pl['name']: pl['data'] for pl in planes} == want[digest]
    store2 = kv_tiers.SpillStore(str(tmp_path))
    assert store2.load_index() == 2 and store2.load_errors == 0
    p, rec = store2.index[e1.digest]
    planes = kv_tiers.SpillStore.read_entry(p, rec, {})
    assert {pl['name']: pl['data'] for pl in planes} == want[e1.digest]


def test_truncated_segment_invisible_on_reload(tmp_path):
    t = _tiers()
    store = kv_tiers.SpillStore(str(tmp_path))
    path = store.write_segment([_entry(t, b'digest_1', range(4))])
    size = os.path.getsize(path)
    with open(path, 'r+b') as f:
        f.truncate(size - 7)
    store2 = kv_tiers.SpillStore(str(tmp_path))
    assert store2.load_index() == 0
    assert store2.load_errors == 1
    assert b'digest_1' not in store2


def test_bad_magic_and_garbage_segments_invisible_on_reload(tmp_path):
    t = _tiers()
    store = kv_tiers.SpillStore(str(tmp_path))
    path = store.write_segment([_entry(t, b'digest_1', range(4))])
    with open(path, 'r+b') as f:
        f.write(b'XXXX')  # clobber the magic
    (tmp_path / ('junk' + kv_tiers.SEG_SUFFIX)).write_bytes(b'\x00' * 16)
    (tmp_path / 'seg-dead.seg.tmp').write_bytes(b'partial')
    store2 = kv_tiers.SpillStore(str(tmp_path))
    assert store2.load_index() == 0
    assert store2.load_errors == 2  # clobbered + junk; .tmp ignored


def test_bitflip_payload_fails_crc_on_range_read(tmp_path):
    t = _tiers()
    store = kv_tiers.SpillStore(str(tmp_path))
    e = _entry(t, b'digest_1', range(4), seed=3)
    path = store.write_segment([e])
    store.admit(path, [e])
    _p, rec = store.index[e.digest]
    base = len(kv_tiers.SEG_MAGIC) + kv_tiers._LEN.size  # noqa: SLF001
    with open(path, 'r+b') as f:
        head = f.read(base)
        (hlen,) = kv_tiers._LEN.unpack_from(head, len(kv_tiers.SEG_MAGIC))  # noqa: SLF001
        off = base + hlen + int(rec['planes'][0]['offset'])
        f.seek(off)
        byte = f.read(1)
        f.seek(off)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(ValueError, match='crc32 mismatch'):
        kv_tiers.SpillStore.read_entry(path, rec, {})


@pytest.mark.parametrize('quantized', [True, False], ids=['int8', 'bf16'])
def test_segment_files_byte_identical_and_cross_readable(tmp_path,
                                                         quantized):
    """The same entries written by either package's SpillStore make the
    same bytes; each package indexes, range-reads and decodes the other's
    segment. A bf16 plane is uint16 words in the port and ml_dtypes
    bfloat16 in JAX, the same bytes under the same dtype name."""
    pt = _tiers(quantized=quantized)
    jt = _tiers(quantized=quantized, lib=jax_tiers)
    rows = [list(range(4)), list(range(8))]
    arrays = [_arrays(pt, seed=s) for s in (1, 2)]
    pent = [kv_tiers.TierEntry(bytes([65 + i]) * 8, rows[i],
                               [pt._plane(n, a) for n, a in arr.items()])  # noqa: SLF001
            for i, arr in enumerate(arrays)]
    jarrs = [{n: (a.view(ml_dtypes.bfloat16) if a.dtype == np.uint16
                  else a) for n, a in arr.items()} for arr in arrays]
    jent = [jax_tiers.TierEntry(bytes([65 + i]) * 8, rows[i],
                                [jt._plane(n, a) for n, a in arr.items()])  # noqa: SLF001
            for i, arr in enumerate(jarrs)]
    assert [p['dtype'] for p in pent[0].planes] == \
        [p['dtype'] for p in jent[0].planes]
    pdir, jdir = tmp_path / 'port', tmp_path / 'jax'
    ppath = kv_tiers.SpillStore(str(pdir)).write_segment(pent)
    jpath = jax_tiers.SpillStore(str(jdir)).write_segment(jent)
    with open(ppath, 'rb') as f, open(jpath, 'rb') as g:
        assert f.read() == g.read()
    for lib, tiers, root, want in ((jax_tiers, jt, pdir, jarrs),
                                   (kv_tiers, pt, jdir, arrays)):
        store = lib.SpillStore(str(root))
        assert store.load_index() == 2 and store.load_errors == 0
        for i, e in enumerate(pent):
            path, rec = store.index[e.digest]
            planes = lib.SpillStore.read_entry(path, rec, {})
            got = tiers._decode_entry(lib.TierEntry(e.digest, rows[i],  # noqa: SLF001
                                                    planes))
            assert got is not None and set(got) == set(want[i])
            for name, arr in want[i].items():
                assert got[name].dtype == arr.dtype, name
                np.testing.assert_array_equal(got[name], arr)


def test_atomic_write_matches_jax(tmp_path):
    for lib in (atomic_io, jax_atomic_io):
        path = tmp_path / f'{lib.__name__}.bin'
        assert lib.atomic_write(str(path), lambda f: f.write(b'abc'),
                                mode='wb', fsync=True) == 3
        assert path.read_bytes() == b'abc'

        def fail(f):
            f.write(b'partial')
            raise OSError('disk full')
        with pytest.raises(OSError, match='disk full'):
            lib.atomic_write(str(path), fail, mode='wb')
        assert path.read_bytes() == b'abc'
        assert not os.path.exists(str(path) + '.tmp')


# -- KVTiers: quarantine and the recompute fallback (no engine) -------------------------


def test_fetch_of_corrupt_segment_quarantines_chain(tmp_path):
    t = _tiers(spill_dir=str(tmp_path))
    e = _entry(t, b'digest_1', range(4), seed=4)
    t._spill_entries([e])  # noqa: SLF001
    assert t.lookup(e.digest) == 'spilled'
    path, _rec = t._spill.index[e.digest]  # noqa: SLF001
    with open(path, 'r+b') as f:
        f.seek(-1, os.SEEK_END)
        last = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last[0] ^ 0xFF]))
    done = []
    assert t.request_fetch([e.digest], lambda digests, ok: done.append(ok))
    assert t.quiesce(10)
    t.stop()
    assert done == [False]
    st = t.stats()
    assert st['corrupt'] == 1 and st['quarantined'] == 1, st
    assert t.lookup(e.digest) is None
    assert e.digest not in t._spill  # noqa: SLF001
    deadline = time.time() + 5
    while os.path.exists(path) and time.time() < deadline:
        time.sleep(0.02)
    assert not os.path.exists(path)


def test_fetch_of_clean_segment_reloads_to_host(tmp_path):
    t = _tiers(spill_dir=str(tmp_path))
    e = _entry(t, b'digest_1', range(4), seed=5)
    t._spill_entries([e])  # noqa: SLF001
    done = []
    assert t.request_fetch([e.digest], lambda digests, ok: done.append(ok))
    assert t.quiesce(10)
    t.stop()
    assert done == [True]
    assert t.lookup(e.digest) == 'host'
    st = t.stats()
    assert st['reloads'] == 1 and st['spill_hits'] == 1, st


def test_take_for_promote_corrupt_entry_truncates_and_quarantines():
    t = _tiers()
    entries = [_entry(t, bytes([65 + i]) * 8, range(4 * (i + 1)),
                      seed=10 + i) for i in range(3)]
    for e in entries:
        t._host.insert(e)  # noqa: SLF001
    p0 = entries[1].planes[0]
    p0['data'] = bytes([p0['data'][0] ^ 0xFF]) + p0['data'][1:]
    got = t.take_for_promote([e.digest for e in entries])
    assert len(got) == 1
    assert set(got[0]) == {'k', 'v', 'k_s', 'v_s'}
    st = t.stats()
    assert st['corrupt'] == 1 and st['quarantined'] == 1, st
    assert t.lookup(entries[1].digest) is None
    assert t.lookup(entries[2].digest) == 'host'
    bad = _entry(t, b'digest_z', range(4), seed=20)
    bad.planes[0]['shape'] = [1, 1, 1, 1]
    bad.planes[0]['data'] = bad.planes[0]['data'][:12]
    bad.planes[0]['nbytes'] = 12
    bad.planes[0]['crc32'] = kv_tiers._crc(bad.planes[0]['data'])  # noqa: SLF001
    t._host.insert(bad)  # noqa: SLF001
    assert t.take_for_promote([bad.digest]) == []
    assert t.lookup(bad.digest) is None


def test_advert_entries_tier_tags_and_exclusion(tmp_path):
    t = _tiers(spill_dir=str(tmp_path))
    host_e = _entry(t, b'digest_h', range(4), seed=6)
    t._host.insert(host_e)  # noqa: SLF001
    spill_e = _entry(t, b'digest_s', range(8), seed=7)
    t._spill_entries([spill_e])  # noqa: SLF001
    rows, truncated = t.advert_entries(8, set())
    assert not truncated
    by_hex = {r[0]: r for r in rows}
    assert by_hex[host_e.digest.hex()][2] == 1
    assert by_hex[spill_e.digest.hex()][2] == 2
    assert by_hex[host_e.digest.hex()][1] == 1
    assert by_hex[spill_e.digest.hex()][1] == 2
    rows, _ = t.advert_entries(8, {host_e.digest.hex()})
    assert [r[0] for r in rows] == [spill_e.digest.hex()]
    rows, truncated = t.advert_entries(0, set())
    assert rows == [] and truncated
    t.stop()


def test_resolve_rows_covers_host_and_spill(tmp_path):
    t = _tiers(spill_dir=str(tmp_path))
    t._host.insert(_entry(t, b'digest_h', [1, 2, 3, 4], seed=8))  # noqa: SLF001
    t._spill_entries([_entry(t, b'digest_s', list(range(1, 9)), seed=9)])  # noqa: SLF001
    rows = t.resolve_rows([b'digest_h', b'digest_s', b'digest_x'])
    assert rows == {b'digest_h': [1, 2, 3, 4],
                    b'digest_s': [1, 2, 3, 4, 5, 6, 7, 8]}
    t.stop()


def test_host_copy_and_to_device_carry_bf16_as_words():
    """bf16 planes reach the host as uint16 storage words and go back to
    a bf16 tensor from them, bit for bit."""
    t = torch.randn(3, 5).to(torch.bfloat16)
    words = port_engine._HostCopy(t).numpy()  # noqa: SLF001
    assert words.dtype == np.uint16
    assert words.tobytes() == t.view(torch.int16).numpy().tobytes()
    back = port_engine._to_device(words, torch.device('cpu'),  # noqa: SLF001
                                  torch.bfloat16)
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)


# -- the engines ------------------------------------------------------------------------


JAX_CFG = dataclasses.replace(jax_llama.TINY, dtype=jnp.float32)
PORT_CFG = dataclasses.replace(port_llama.TINY, dtype=torch.float32)


@pytest.fixture(scope='module')
def weights():
    jp = jax_llama.init_params(jax.random.PRNGKey(0), JAX_CFG)
    return jp, port_llama.params_from_numpy(
        jax.tree.map(np.asarray, jp), PORT_CFG, 'cpu')


def _solo(pp, row, n, cfg=PORT_CFG):
    prompt = torch.tensor([row], dtype=torch.int32)
    return port_gen.generate(pp, cfg, prompt, n, max_len=64)[0].tolist()


HEADS = [[((17 * h + j) % 250) + 1 for j in range(24)] for h in range(5)]
ROUND1 = [h + [5, 6, 7, 8] for h in HEADS[:3]]
ROUND2 = [h + [9, 9, 9] for h in HEADS[:3]]


def _tier_run(eng, corrupt_dir=None, round1=ROUND1, round2=ROUND2):
    """The first round's rows one at a time (a pool of 4 usable blocks
    evicts the older chains), then the second's. ``corrupt_dir``:
    bit-flip every spill segment there between the rounds."""
    out = []
    for row in round1:
        out.append(eng.submit(row, 6).result(timeout=300))
    assert eng._kv_tiers.quiesce(30)  # noqa: SLF001
    mid = eng.stats()['kv_tiers']
    if corrupt_dir is not None:
        # JAX's quiesce may return while its spill segment is still being
        # written; the spill counts once the segment is published.
        deadline = time.time() + 30
        while eng.stats()['kv_tiers']['spills'] < 1:
            assert time.time() < deadline
            time.sleep(0.01)
        segs = [p for p in os.listdir(corrupt_dir)
                if p.endswith(kv_tiers.SEG_SUFFIX)]
        assert segs
        for name in segs:
            with open(os.path.join(corrupt_dir, name), 'r+b') as f:
                f.seek(-1, os.SEEK_END)
                last = f.read(1)
                f.seek(-1, os.SEEK_END)
                f.write(bytes([last[0] ^ 0xFF]))
    for row in round2:
        out.append(eng.submit(row, 6).result(timeout=300))
    assert eng._kv_tiers.quiesce(30)  # noqa: SLF001
    st = eng.stats()
    kb, tiers = st['kv_blocks'], st['kv_tiers']
    assert kb['host'] == tiers['host_blocks']
    assert kb['spilled'] == tiers['spilled_blocks']
    return out, mid, tiers, st['prefix_share']


def _engines(weights, tmp_path, monkeypatch, host_bytes, tag, cfgs=None):
    jcfg, pcfg = cfgs or (JAX_CFG, PORT_CFG)
    out = {}
    for which, params in zip(('jax', 'port'), weights):
        spill = tmp_path / f'{tag}-{which}'
        monkeypatch.setenv('SKYTPU_KV_SPILL_DIR', str(spill))
        monkeypatch.setenv('SKYTPU_KV_HOST_BYTES', str(host_bytes))
        if which == 'jax':
            eng = jax_engine.ContinuousEngine(
                params, jcfg, slots=4, max_len=64, chunk_steps=2,
                kv_layout='paged', kv_blocks=5)
        else:
            eng = port_engine.ContinuousEngine(
                params, pcfg, slots=4, max_len=64, chunk_steps=2,
                kv_layout='paged', kv_blocks=5, device='cpu')
        out[which] = (eng, str(spill))
    return out


def test_engine_corrupt_spill_degrades_to_recompute(weights, tmp_path,
                                                    monkeypatch):
    """Every chain spills (host bytes 1), every segment is bit-flipped:
    the second round still equals JAX's tokens and the solo oracle,
    fails no request, and quarantines the corrupt chains."""
    res = {}
    for which, (eng, spill) in _engines(weights, tmp_path, monkeypatch, 1,
                                        'corrupt').items():
        try:
            res[which] = _tier_run(eng, corrupt_dir=spill)
        finally:
            eng.stop()
    assert res['port'][0] == res['jax'][0] == [
        _solo(weights[1], r, 6) for r in ROUND1 + ROUND2]
    _, mid, tiers, _ = res['port']
    assert mid['spills'] >= 1
    assert tiers['corrupt'] >= 1 and tiers['quarantined'] >= 1, tiers
    assert tiers['promotes'] == 0


def test_engine_spill_fetch_promote(weights, tmp_path, monkeypatch):
    """Five heads through a host tier that holds one chain (one block,
    8,192 bytes), so older demotes spill; asked again, the spilled first
    head parks on a background fetch, is re-queued and promotes the
    fetched block instead of recomputing it: tokens equal JAX's (which
    recomputes, see the float32 fault below) and the solo oracle."""
    round1 = [h + [5, 6, 7, 8] for h in HEADS]
    round2 = [HEADS[0] + [9, 9, 9]]
    res = {}
    for which, (eng, _) in _engines(weights, tmp_path, monkeypatch, 8192,
                                    'fetch').items():
        try:
            res[which] = _tier_run(eng, round1=round1, round2=round2)
        finally:
            eng.stop()
    assert res['port'][0] == res['jax'][0] == [
        _solo(weights[1], r, 6) for r in round1 + round2]
    _, mid, tiers, share = res['port']
    assert mid['spills'] >= 1 and mid['demotes'] >= 1, mid
    assert tiers['fetches'] >= 1 and tiers['promotes'] >= 1, tiers
    assert tiers['corrupt'] == 0 and tiers['quarantined'] == 0, tiers
    assert share['hits'] >= 1


def test_float32_pool_promotes_where_jax_quarantines(weights, tmp_path,
                                                     monkeypatch):
    """The reference fault (ROADMAP §3): JAX's KVTiers fixes the K/V plane
    dtype to bfloat16 while its pool is allocated in ``cfg.dtype``, so
    every float32 chain it demotes fails the promote gate and is
    quarantined; the port's plane spec takes the pool's dtype, so the
    same chains promote. The tokens are equal either way."""
    res = {}
    for which, (eng, _) in _engines(weights, tmp_path, monkeypatch,
                                    1 << 28, 'f32').items():
        try:
            res[which] = _tier_run(eng)
        finally:
            eng.stop()
    assert res['port'][0] == res['jax'][0] == [
        _solo(weights[1], r, 6) for r in ROUND1 + ROUND2]
    jt, pt = res['jax'][2], res['port'][2]
    assert jt['demotes'] >= 1 and jt['promotes'] == 0
    assert jt['corrupt'] >= 1 and jt['quarantined'] >= 1, jt
    assert pt['demotes'] >= jt['demotes'] and pt['promotes'] >= 1
    assert pt['corrupt'] == 0 and pt['quarantined'] == 0, pt
    assert res['port'][3]['hit_tokens'] > res['jax'][3]['hit_tokens']


def test_bf16_pool_tier_counters_equal_jax(tmp_path, monkeypatch):
    """On a bf16 pool, where JAX's tiers work, the port's demote and
    promote the same blocks: equal tier and share counters, tokens in
    range (bf16 greedy tokens are not compared across frameworks)."""
    jcfg, pcfg = jax_llama.TINY, port_llama.TINY
    jp = jax_llama.init_params(jax.random.PRNGKey(0), jcfg)
    pp = port_llama.params_from_numpy(jax.tree.map(np.asarray, jp), pcfg,
                                      'cpu')
    res = {}
    for which, (eng, _) in _engines((jp, pp), tmp_path, monkeypatch,
                                    1 << 28, 'bf16', (jcfg, pcfg)).items():
        try:
            res[which] = _tier_run(eng)
        finally:
            eng.stop()
    keys = ('demotes', 'promotes', 'spills', 'corrupt', 'quarantined',
            'host_blocks', 'host_bytes', 'dropped')
    assert {k: res['port'][2][k] for k in keys} == \
        {k: res['jax'][2][k] for k in keys}
    assert res['port'][3] == res['jax'][3]
    assert res['port'][2]['promotes'] >= 1
    for toks in res['port'][0]:
        assert len(toks) == 6 and all(0 <= t < pcfg.vocab_size
                                      for t in toks)


def test_saturated_demote_queue_keeps_hot_chains(weights, monkeypatch):
    """Evictions that come while the demote queue is saturated (here a
    bound of 1 and a tier worker held back): a one-shot chain is refused
    but a chain that served a share hit is still taken, so a later
    request promotes it. A cold chain's KV is recomputed, a hot one's
    never is; the tokens equal the solo oracle either way."""
    monkeypatch.setattr(kv_tiers, '_DEMOTE_QUEUE_MAX', 1)
    gate = threading.Event()
    work = kv_tiers.KVTiers._worker  # noqa: SLF001

    def held(self):
        gate.wait(60)
        work(self)
    monkeypatch.setattr(kv_tiers.KVTiers, '_worker', held)
    monkeypatch.setenv('SKYTPU_KV_HOST_BYTES', str(1 << 28))
    monkeypatch.delenv('SKYTPU_KV_SPILL_DIR', raising=False)
    pp = weights[1]
    eng = port_engine.ContinuousEngine(
        pp, PORT_CFG, slots=4, max_len=64, chunk_steps=2,
        kv_layout='paged', kv_blocks=5, device='cpu')
    rows = [HEADS[1] + [5, 6, 7, 8],   # cold, evicted first: queued
            HEADS[0] + [5, 6, 7, 8],
            HEADS[0] + [9, 9, 9],      # shares HEADS[0]'s block: hot
            HEADS[2] + [5, 6, 7, 8],   # evicts HEADS[1] (queue empty)
            HEADS[3] + [5, 6, 7, 8],   # evicts HEADS[0], queue saturated
            HEADS[4] + [5, 6, 7, 8]]   # evicts HEADS[2], queue saturated
    try:
        out = [eng.submit(r, 6).result(timeout=300) for r in rows]
        assert eng.stats()['kv_tiers']['demotes'] == 0  # worker held
        gate.set()
        assert eng._kv_tiers.quiesce(30)  # noqa: SLF001
        mid = eng.stats()['kv_tiers']
        again = [HEADS[0] + [7, 7, 7], HEADS[2] + [7, 7, 7]]
        out += [eng.submit(r, 6).result(timeout=300) for r in again]
        assert eng._kv_tiers.quiesce(30)  # noqa: SLF001
        tiers = eng.stats()['kv_tiers']
    finally:
        gate.set()
        eng.stop()
    assert out == [_solo(pp, r, 6) for r in rows + again]
    assert mid['demotes'] == 2, mid  # HEADS[1] and HEADS[0], not HEADS[2]
    assert tiers['promotes'] == 1, tiers  # HEADS[0]'s block only
    assert tiers['corrupt'] == 0 and tiers['dropped'] == 0, tiers
