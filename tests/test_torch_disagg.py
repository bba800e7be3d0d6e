"""The port's skytpu-kv/1 handoff and the engine's prefill and decode roles,
against the JAX package, on the CPU.

Wire format: for the same planes (bf16 words, float32, int8 with float32
scales; paged and slot; ``skip_blocks`` 0 and 2) the port's header,
payload and crc32s equal JAX's byte for byte, each package's ``parse``
reads the other's bytes bit for bit, corrupt and truncated payloads raise
the same classes, and staging files cross between the packages.

Engines: float32 TINY, the weights carried by ``params_from_numpy``.
Prefill -> bytes -> decode gives the colocated greedy tokens exactly
(the port's and JAX's), within the port and across the packages both
ways; the exported planes equal JAX's within 1e-5 (float32 sums taken in
another order). The counterparts of ``tests/test_serve_disagg.py``'s
engine tests: negotiation (``probe_chain``), a handoff whose whole chain
is shared, an evicted negotiated prefix, a shape-skewed payload, import
backpressure, and the MoE and draft refusals.
"""
import dataclasses
import threading
import time
import zlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from skypilot_tpu.models import engine as jax_engine
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.serve import disagg as jd
from skypilot_tpu.utils import prefix_affinity as jax_affinity
from skypilot_tpu_torch.ckpt.manifest import RawArray
from skypilot_tpu_torch.models import engine as port_engine
from skypilot_tpu_torch.models import llama as port_llama
from skypilot_tpu_torch.serve import disagg as pd

MAX_LEN = 96
JAX_CFG = dataclasses.replace(jax_llama.TINY, dtype=jnp.float32)
PORT_CFG = dataclasses.replace(port_llama.TINY, dtype=torch.float32)
# JAX's three (n, max_new, salt) cases (tests/test_serve_disagg.py).
CASES = ((13, 12, 0), (33, 16, 1), (1, 8, 2))
# Planes of the same float32 prefill, computed by the two frameworks:
# sums in another order.
PLANE_TOL = 1e-5


def _row(n, salt=0):
    return [(7 * i + 11 * salt) % 250 + 1 for i in range(n)]


# -- the wire format ----------------------------------------------------------


def _planes(kind, layout, rng):
    """(jax planes, port planes): k, v, k_s, v_s of one handoff, the same
    values, in each package's host form (bf16: ml_dtypes against the
    port's RawArray words)."""
    shape = (2, 3, 2, 16, 8) if layout == 'paged' else (2, 1, 2, 37, 8)
    out_j, out_p = [], []
    for _ in range(2):
        f = rng.standard_normal(shape).astype(np.float32)
        if kind == 'bf16':
            words = (f.view(np.uint32) >> 16).astype(np.uint16)
            out_j.append(words.view(ml_dtypes.bfloat16))
            out_p.append(RawArray(words, 'bfloat16'))
        elif kind == 'int8':
            codes = rng.integers(-127, 128, shape).astype(np.int8)
            out_j.append(codes)
            out_p.append(codes)
        else:
            out_j.append(f)
            out_p.append(f)
    scales = [None, None]
    if kind == 'int8':
        scales = [rng.random(shape[:-1]).astype(np.float32)
                  for _ in range(2)]
    return out_j + scales, out_p + scales


def _handoffs(kind, layout, seed=0):
    rng = np.random.default_rng(seed)
    pj, pp = _planes(kind, layout, rng)
    base = dict(row=_row(37, 3), first=42, max_new=9, temperature=0.7,
                top_k=5, top_p=0.9, eos=frozenset({3, 1}), layout=layout,
                prompt_len=37)
    if layout == 'paged':
        base.update(block=16, n_blocks=3)
    jh = jax_engine.PrefillHandoff(k=pj[0], v=pj[1], k_s=pj[2], v_s=pj[3],
                                   **base)
    ph = port_engine.PrefillHandoff(k=pp[0], v=pp[1], k_s=pp[2],
                                    v_s=pp[3], **base)
    return jh, ph


def _words(arr):
    """An array's storage bytes as a comparable numpy array."""
    if isinstance(arr, RawArray):
        return arr.words
    if arr.dtype == ml_dtypes.bfloat16:
        return arr.view(np.uint16)
    return np.asarray(arr)


WIRE = [(kind, layout, skip) for kind in ('bf16', 'f32', 'int8')
        for layout in ('paged', 'slot') for skip in (0, 2)
        if not (layout == 'slot' and skip)]


@pytest.mark.parametrize('kind, layout, skip', WIRE)
def test_header_and_payload_bytes_equal_jax(kind, layout, skip):
    jh, ph = _handoffs(kind, layout)
    kw = dict(model='tiny', kv_cache='int8' if kind == 'int8' else 'bf16',
              skip_blocks=skip)
    want = jd.build_header(jh, **kw)
    got = pd.build_header(ph, **kw)
    assert got == want
    assert [p['dtype'] for p in got['planes']][:1] == [
        {'bf16': 'bfloat16', 'f32': 'float32', 'int8': 'int8'}[kind]]
    assert list(pd.serialize(ph, got)) == list(jd.serialize(jh, want))
    assert pd.serialize_bytes(ph, got) == jd.serialize_bytes(jh, want)
    assert pd.payload_nbytes(got) == jd.payload_nbytes(want) \
        == len(jd.serialize_bytes(jh, want))


@pytest.mark.parametrize('kind, layout, skip', WIRE)
def test_each_parse_reads_the_others_bytes(kind, layout, skip):
    jh, ph = _handoffs(kind, layout, seed=1)
    kw = dict(model='tiny', kv_cache='bf16', skip_blocks=skip)
    jdata = jd.serialize_bytes(jh, jd.build_header(jh, **kw))
    pdata = pd.serialize_bytes(ph, pd.build_header(ph, **kw))
    h_pj, a_pj = pd.parse(jdata)   # the port reads JAX's bytes
    h_jp, a_jp = jd.parse(pdata)   # JAX reads the port's
    assert h_pj == h_jp == jd.build_header(jh, **kw)
    assert a_pj.keys() == a_jp.keys()
    for name in a_pj:
        src = getattr(jh, name)
        if layout == 'paged':
            src = src[:, skip:]
        np.testing.assert_array_equal(_words(a_pj[name]), _words(src))
        np.testing.assert_array_equal(_words(a_jp[name]), _words(src))
        assert isinstance(a_pj[name], RawArray) == (
            kind == 'bf16' and name in ('k', 'v'))
    assert pd.import_kwargs(h_pj, a_pj).keys() \
        == jd.import_kwargs(h_jp, a_jp).keys()


def test_corrupt_truncated_and_foreign_payloads_raise_jaxs_classes():
    jh, ph = _handoffs('bf16', 'paged')
    data = pd.serialize_bytes(ph, pd.build_header(ph, model='tiny',
                                                  kv_cache='bf16'))
    flipped = bytearray(data)
    flipped[len(flipped) // 2] ^= 0xFF
    hlen = int.from_bytes(data[9:13], 'little')
    bad_json = bytearray(data)
    bad_json[13] = 0xFF
    for blob in (bytes(flipped), data[:-7], data[:8],
                 b'NOTAKVMAGIC' + data[11:], data[:13 + hlen - 1],
                 bytes(bad_json)):
        with pytest.raises(jd.DisaggFormatError):
            jd.parse(blob)
        with pytest.raises(pd.DisaggFormatError):
            pd.parse(blob)
    header, _ = pd.parse(data)
    for kw in (dict(model='other'), dict(kv_cache='int8'),
               dict(kv_layout='slot'), dict(kv_block=999),
               dict(max_len=10)):
        full = dict(model='tiny', kv_cache='bf16', kv_layout='paged',
                    kv_block=16, max_len=MAX_LEN)
        full.update(kw)
        with pytest.raises(jd.DisaggCompatError):
            jd.check_compat(header, **full)
        with pytest.raises(pd.DisaggCompatError):
            pd.check_compat(header, **full)
    full = dict(model='tiny', kv_cache='bf16', kv_layout='paged',
                kv_block=16, max_len=MAX_LEN)
    pd.check_compat(header, **full)
    assert issubclass(pd.DisaggFormatError, pd.DisaggError)
    assert issubclass(pd.DisaggCompatError, pd.DisaggError)
    with pytest.raises(ValueError):
        pd.build_header(ph, model='tiny', kv_cache='bf16', skip_blocks=3)
    _, slot = _handoffs('f32', 'slot')
    with pytest.raises(ValueError):
        pd.build_header(slot, model='tiny', kv_cache='bf16', skip_blocks=1)
    assert (pd.MAGIC, pd.FORMAT, pd.STAGING_ENV, pd.STAGING_SUFFIX,
            pd.DEFAULT_TTL_S) == (jd.MAGIC, jd.FORMAT, jd.STAGING_ENV,
                                  jd.STAGING_SUFFIX, jd.DEFAULT_TTL_S)


def test_staging_written_by_one_package_is_read_by_the_other(tmp_path):
    jh, ph = _handoffs('bf16', 'paged', seed=2)
    kw = dict(model='tiny', kv_cache='bf16')
    jref, jn = jd.write_staging(str(tmp_path), jh, jd.build_header(jh, **kw))
    pref, pn = pd.write_staging(str(tmp_path), ph, pd.build_header(ph, **kw))
    assert jn == pn
    assert pd.read_staging(str(tmp_path), jref) \
        == jd.read_staging(str(tmp_path), pref)
    header, arrays = pd.parse(pd.read_staging(str(tmp_path), jref))
    np.testing.assert_array_equal(arrays['k'].words, _words(jh.k))
    assert zlib.crc32(arrays['v'].words[:, 0].tobytes()) & 0xFFFFFFFF \
        == header['planes'][1]['crc32']
    for bad in ('../' + pref, 'nope' + pd.STAGING_SUFFIX, 'x.tmp'):
        with pytest.raises(pd.DisaggError):
            pd.read_staging(str(tmp_path), bad)
    with pytest.raises(pd.DisaggError):
        pd.read_staging(None, pref)
    assert not list(tmp_path.glob('*.tmp'))


def test_registry_is_one_shot_and_expires():
    reg = pd.HandoffRegistry(ttl_s=0.2)
    hid = reg.put('payload')
    assert len(reg) == 1
    assert reg.pop(hid) == 'payload'
    assert reg.pop(hid) is None
    stale = reg.put('stale')
    time.sleep(0.3)
    assert reg.pop(stale) is None and reg.expired >= 1
    assert len(reg) == 0


# -- the engines ----------------------------------------------------------------


@pytest.fixture(scope='module')
def weights():
    """(jax params, port params), float32 TINY, the same values."""
    jp = jax_llama.init_params(jax.random.PRNGKey(0), JAX_CFG)
    return jp, port_llama.params_from_numpy(
        jax.tree.map(np.asarray, jp), PORT_CFG, 'cpu')


def _mk(which, weights, role='colocated', **kw):
    kw.setdefault('slots', 4)
    kw.setdefault('max_len', MAX_LEN)
    if which == 'jax':
        return jax_engine.ContinuousEngine(weights[0], JAX_CFG, role=role,
                                           **kw)
    return port_engine.ContinuousEngine(weights[1], PORT_CFG, role=role,
                                        device='cpu', **kw)


def _stop(*engines):
    for e in engines:
        e.stop()


def _export(pkg, eng, row, max_new, skip=0, kv_cache='bf16', **kw):
    h = eng.submit_prefill(row, max_new, **kw).result(timeout=300)
    return pkg.serialize_bytes(h, pkg.build_header(
        h, model='tiny', kv_cache=kv_cache, skip_blocks=skip))


def _import(pkg, eng, data, **extra):
    header, arrays = pkg.parse(data)
    return eng.submit_import(**pkg.import_kwargs(header, arrays),
                             **extra).result(timeout=300)


def _f32(arr):
    return np.asarray(arr, np.float32)


@pytest.mark.parametrize('layout', ['slot', 'paged'])
def test_prefill_bytes_decode_matches_colocated_and_jax(weights, layout):
    """JAX's three cases: the port's handoff gives the port's and JAX's
    colocated greedy tokens exactly; the exported planes equal JAX's
    within PLANE_TOL."""
    engines = dict(
        colo=_mk('port', weights, kv_layout=layout),
        pre=_mk('port', weights, 'prefill', kv_layout=layout),
        dec=_mk('port', weights, 'decode', kv_layout=layout),
        jcolo=_mk('jax', weights, kv_layout=layout),
        jpre=_mk('jax', weights, 'prefill', kv_layout=layout))
    try:
        for n, max_new, salt in CASES:
            row = _row(n, salt)
            want = engines['colo'].submit(row, max_new).result(timeout=300)
            assert list(engines['jcolo'].submit(row, max_new).result(
                timeout=300)) == want
            data = _export(pd, engines['pre'], row, max_new)
            assert _import(pd, engines['dec'], data) == want
            _, got = pd.parse(data)
            _, ref = jd.parse(_export(jd, engines['jpre'], row, max_new))
            assert got.keys() == ref.keys() == {'k', 'v'}
            for name in got:
                assert got[name].shape == ref[name].shape
                np.testing.assert_allclose(_f32(got[name]),
                                           _f32(ref[name]), rtol=0,
                                           atol=PLANE_TOL)
        pre, dec = engines['pre'], engines['dec']
        assert pre.exports == 3 and pre.imports == 0
        assert dec.imports == 3 and dec.exports == 0
        assert pre.stats()['disagg']['exports'] == 3
        assert dec.stats()['disagg']['imports'] == 3
        assert pre.stats()['role'] == 'prefill'
        assert pre.stats()['disagg'].keys() \
            == engines['jpre'].stats()['disagg'].keys()
        # Exports alone never dispatch a decode chunk.
        assert pre.stats()['pipeline']['dispatches'] == 0
        assert pre.stats()['kv_blocks'] is None or \
            pre.stats()['kv_blocks']['owned'] == 0
    finally:
        _stop(*engines.values())


@pytest.mark.parametrize('layout', ['slot', 'paged'])
@pytest.mark.parametrize('direction', ['jax-to-port', 'port-to-jax'])
def test_handoff_crosses_packages(weights, layout, direction):
    """A JAX prefill engine hands off to a port decode engine, and the
    reverse: the greedy tokens are JAX's colocated ones."""
    src, dst = direction.split('-to-')
    pkgs = {'jax': jd, 'port': pd}
    pre = _mk(src, weights, 'prefill', kv_layout=layout)
    dec = _mk(dst, weights, 'decode', kv_layout=layout)
    colo = _mk('jax', weights, kv_layout=layout)
    try:
        for n, max_new, salt in CASES:
            row = _row(n, salt + 5)
            want = list(colo.submit(row, max_new).result(timeout=300))
            data = _export(pkgs[src], pre, row, max_new)
            assert list(_import(pkgs[dst], dec, data)) == want
    finally:
        _stop(pre, dec, colo)


@pytest.mark.parametrize('layout', ['slot', 'paged'])
def test_int8_kv_handoff_carries_the_scale_planes(weights, layout):
    colo = _mk('port', weights, kv_layout=layout, kv_quantize=True)
    pre = _mk('port', weights, 'prefill', kv_layout=layout,
              kv_quantize=True)
    dec = _mk('port', weights, 'decode', kv_layout=layout,
              kv_quantize=True)
    try:
        for n, max_new, salt in CASES:
            row = _row(n, salt + 9)
            want = colo.submit(row, max_new).result(timeout=300)
            data = _export(pd, pre, row, max_new, kv_cache='int8')
            header, arrays = pd.parse(data)
            assert set(arrays) == {'k', 'v', 'k_s', 'v_s'}
            assert arrays['k'].dtype == np.int8
            assert arrays['k_s'].shape == arrays['k'].shape[:-1]
            assert _import(pd, dec, data) == want
        with pytest.raises(ValueError, match='quantization'):
            plain = _mk('port', weights, 'prefill', kv_layout=layout)
            try:
                bf = _export(pd, plain, _row(9), 4)
            finally:
                plain.stop()
            _import(pd, dec, bf)
    finally:
        _stop(colo, pre, dec)


@pytest.mark.parametrize('layout', ['slot', 'paged'])
def test_chunked_long_prompt_exports(weights, layout):
    """A prompt longer than ``prefill_chunk`` exports through the chunked
    path (``_finish_long_export``) and decodes to the colocated tokens."""
    colo = _mk('port', weights, kv_layout=layout)
    pre = _mk('port', weights, 'prefill', kv_layout=layout,
              prefill_chunk=16)
    dec = _mk('port', weights, 'decode', kv_layout=layout)
    try:
        row = _row(45, 4)
        want = colo.submit(row, 10).result(timeout=300)
        assert _import(pd, dec, _export(pd, pre, row, 10)) == want
        assert pre.stats()['prefill_chunks'] >= 3
        assert pre.exports == 1
    finally:
        _stop(colo, pre, dec)


def _warm_pair(weights, rows, **kw):
    """A JAX and a port decode engine (paged, sharing on) whose tries
    hold ``rows``' chains."""
    engines = [_mk(w, weights, 'decode', kv_layout='paged',
                   prefix_share=True, kv_tiers=False, **kw)
               for w in ('jax', 'port')]
    for eng in engines:
        for row in rows:
            eng.submit(row, 4).result(timeout=300)
    return engines


def test_probe_chain_and_resolve_chains_equal_jax(weights):
    p = 16
    head = _row(2 * p, 3)
    rows = [head + _row(5, 4), _row(3 * p + 2, 7)]
    jdec, pdec = _warm_pair(weights, rows)
    try:
        for row in (head + _row(7, 5), head, rows[1], _row(40, 11),
                    head[:p] + _row(30, 2), _row(3, 1)):
            assert pdec.probe_chain(row) == jdec.probe_chain(row), row
        assert pdec.probe_chain(head + _row(7, 5)) == 2
        digests, prev = [], None
        for row in rows:
            prev = None
            for i in range(len(row) // p):
                prev = jax_affinity.chain_digest(prev,
                                                 row[i * p:(i + 1) * p])
                digests.append(prev)
        digests.append(b'\x00' * len(digests[0]))
        assert pdec.resolve_chains(digests) == [
            list(r) for r in jdec.resolve_chains(digests)]
        off = _mk('port', weights, kv_layout='paged', prefix_share=False)
        assert off.probe_chain(head) == 0 and off.resolve_chains(
            digests) == []
        off.stop()
    finally:
        _stop(jdec, pdec)


def test_negotiated_prefix_installs_as_references(weights):
    """skip_blocks from ``probe_chain``: a smaller payload, installed over
    the trie's blocks, the colocated tokens. A prompt whose whole chain
    is shared carries no planes at all (the install scatters one zero
    block into the junk sink)."""
    p = 16
    head = _row(2 * p, 3)
    colo = _mk('port', weights, kv_layout='paged')
    pre = _mk('port', weights, 'prefill', kv_layout='paged')
    jdec, dec = _warm_pair(weights, [head + _row(5, 4), _row(2 * p, 8)])
    try:
        row = head + _row(7, 5)
        skip = dec.probe_chain(row)
        assert skip == 2
        want = colo.submit(row, 12).result(timeout=300)
        full = _export(pd, pre, row, 12)
        skipped = _export(pd, pre, row, 12, skip=skip)
        assert len(full) - len(skipped) > 0
        hits = dec.share_hits
        assert _import(pd, dec, skipped) == want
        assert dec.share_hits == hits + 1
        # The same skipped payload on the JAX decode engine.
        assert list(_import(jd, jdec, skipped)) == want
        whole = _row(2 * p, 8)
        assert dec.probe_chain(whole) == 2
        want = colo.submit(whole, 12).result(timeout=300)
        data = _export(pd, pre, whole, 12, skip=2)
        header, arrays = pd.parse(data)
        assert not header['planes'] and not arrays
        assert _import(pd, dec, data) == want
    finally:
        _stop(colo, pre, jdec, dec)


def test_evicted_negotiated_prefix_fails_that_import_alone(weights):
    pre = _mk('port', weights, 'prefill', kv_layout='paged')
    dec = _mk('port', weights, 'decode', kv_layout='paged',
              prefix_share=True)
    colo = _mk('port', weights, kv_layout='paged')
    try:
        row = _row(2 * 16 + 5, 6)
        header, arrays = pd.parse(_export(pd, pre, row, 8))
        kwargs = pd.import_kwargs(header, arrays)
        kwargs['block_start'] = 2  # a negotiation the trie cannot honour
        for name in ('k', 'v'):
            kwargs[name] = kwargs[name][:, 2:]
        with pytest.raises(port_engine.KVImportError):
            dec.submit_import(**kwargs).result(timeout=300)
        assert dec.import_errors == 1
        assert dec.stats()['disagg']['import_errors'] == 1
        # The engine keeps serving: a clean import and a local request.
        row2 = _row(20, 7)
        want = colo.submit(row2, 6).result(timeout=300)
        assert _import(pd, dec, _export(pd, pre, row2, 6)) == want
        assert dec.submit(row2, 6).result(timeout=300) == want
    finally:
        _stop(pre, dec, colo)


def test_shape_skewed_payload_is_rejected_before_enqueue(weights):
    pre = _mk('port', weights, 'prefill', kv_layout='paged')
    dec = _mk('port', weights, 'decode', kv_layout='paged')
    try:
        header, arrays = pd.parse(_export(pd, pre, _row(13, 9), 8))
        skewed = pd.import_kwargs(header, arrays)
        skewed['k'] = skewed['k'][:, :, :, :-1]
        missing = pd.import_kwargs(header, arrays)
        missing['k'] = None
        forged = pd.import_kwargs(header, arrays)
        forged['block_start'] = 5
        slot = pd.import_kwargs(header, arrays)
        slot['layout'] = 'slot'
        for kwargs in (skewed, missing, forged, slot):
            with pytest.raises(ValueError):
                dec.submit_import(**kwargs)
        assert dec.stats()['disagg']['queued_imports'] == 0
        good = dec.submit_import(
            **pd.import_kwargs(header, arrays)).result(timeout=300)
        assert len(good) == 8
    finally:
        _stop(pre, dec)


def test_import_backpressure_shows_in_queued_imports(weights):
    """9 usable blocks: one 32 + 64 import needs 6, so a second waits
    (``queued_imports``) until the first frees its blocks."""
    pre = _mk('port', weights, 'prefill', kv_layout='paged')
    dec = _mk('port', weights, 'decode', kv_layout='paged', kv_blocks=10,
              prefix_share=False)
    colo = _mk('port', weights, kv_layout='paged')
    try:
        row_a, row_b = _row(32, 8), _row(32, 9)
        want_a = colo.submit(row_a, 64).result(timeout=300)
        want_b = colo.submit(row_b, 64).result(timeout=300)
        data_a = _export(pd, pre, row_a, 64)
        data_b = _export(pd, pre, row_b, 64)
        seen_a = threading.Event()
        header, arrays = pd.parse(data_a)
        fut_a = dec.submit_import(**pd.import_kwargs(header, arrays),
                                  on_tokens=lambda toks: seen_a.set())
        assert seen_a.wait(120)
        header, arrays = pd.parse(data_b)
        fut_b = dec.submit_import(**pd.import_kwargs(header, arrays))
        deadline = time.time() + 60
        queued = 0
        while time.time() < deadline and not fut_a.done():
            queued = dec.stats()['disagg']['queued_imports']
            if queued:
                break
            time.sleep(0.005)
        assert queued >= 1, 'import B never queued behind A'
        assert not fut_b.done()
        assert fut_a.result(timeout=300) == want_a
        assert fut_b.result(timeout=300) == want_b
        assert dec.stats()['disagg']['queued_imports'] == 0
    finally:
        _stop(pre, dec, colo)


def test_moe_and_draft_engines_refuse_submit_prefill(weights):
    moe_cfg = dataclasses.replace(port_llama.PRESETS['moe-tiny'],
                                  dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(0)
    moe = port_engine.ContinuousEngine(
        port_llama.init_params(moe_cfg, gen, 'cpu'), moe_cfg, slots=2,
        max_len=MAX_LEN, role='prefill', device='cpu')
    spec = port_engine.ContinuousEngine(
        weights[1], PORT_CFG, slots=2, max_len=MAX_LEN,
        draft_params=weights[1], draft_cfg=PORT_CFG, role='prefill',
        device='cpu')
    try:
        for eng, what in ((moe, 'dense model'), (spec, 'speculative')):
            with pytest.raises(ValueError, match=what):
                eng.submit_prefill(_row(9), 4)
            with pytest.raises(ValueError, match='dense'):
                eng.submit_import(_row(9), 4, 1, layout='slot')
    finally:
        _stop(moe, spec)


def test_roles_are_options_of_the_engine(weights):
    for role in ('colocated', 'prefill', 'decode'):
        assert port_engine.check_options(role=role)[3] == role
    with pytest.raises(ValueError):
        port_engine.check_options(role='router')
    # A role under a tensor mesh is accepted: the head gathers and
    # scatters the handoff's whole KV heads (tests/test_torch_tp_disagg.py).
    from skypilot_tpu_torch.parallel import mesh as port_mesh
    sizes = {a: 1 for a in port_mesh.AXIS_ORDER}
    for role in ('prefill', 'decode'):
        assert port_engine.check_options(
            mesh=port_mesh.Mesh(dict(sizes, tensor=2), None),
            role=role)[3] == role
    eng = _mk('port', weights, 'decode', kv_layout='paged')
    try:
        stats = eng.stats()
        jeng = _mk('jax', weights, 'decode', kv_layout='paged')
        try:
            assert stats.keys() == jeng.stats().keys()
            assert stats['disagg'] == jeng.stats()['disagg']
        finally:
            jeng.stop()
    finally:
        eng.stop()


@pytest.mark.parametrize('layout', ['slot', 'paged'])
def test_exports_beside_colocated_traffic_on_one_engine(weights, layout):
    """A prefill replica also serves the load balancer's colocated
    fallback: exports and decoding requests queued together share the
    prefill groups and the decode chunks, and each comes out as alone."""
    colo = _mk('port', weights, kv_layout=layout)
    pre = _mk('port', weights, 'prefill', kv_layout=layout)
    dec = _mk('port', weights, 'decode', kv_layout=layout)
    try:
        rows = [_row(n, salt + 20) for n, _, salt in CASES]
        want = [colo.submit(r, 10).result(timeout=300) for r in rows]
        reqs = [pre._build_request(r, 10, 0.0, None, 0, 1.0, None,  # noqa: SLF001
                                   export=i % 2 == 0)
                for i, r in enumerate(rows + rows)]
        with pre._lock:  # noqa: SLF001 -- one batch, one look
            pre._pending.extend(reqs)  # noqa: SLF001
        pre.start()
        pre._wake.set()  # noqa: SLF001
        for i, req in enumerate(reqs):
            out = req.future.result(timeout=300)
            if req.export:
                data = pd.serialize_bytes(out, pd.build_header(
                    out, model='tiny', kv_cache='bf16'))
                out = _import(pd, dec, data)
            assert out == want[i % len(rows)], i
        assert pre.exports == 3
        assert pre.stats()['pipeline']['dispatches'] > 0
    finally:
        _stop(colo, pre, dec)
