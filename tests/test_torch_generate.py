"""Parity of the port's model, quantization, sampling and generate with the
JAX package on TINY.

Weights come from the JAX ``init_params`` and are carried over with
``params_from_numpy``; inputs are made with numpy from a seed. float32
logits agree within 1e-4 (sums taken in another order), greedy tokens on
float32 TINY are identical. bfloat16 rounds at other places in the two
frameworks, so bfloat16 logits are held to 8e-2 and greedy bytes are not
compared across frameworks (a 0.0096 logit near-tie was seen to flip).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import generate as jax_gen
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.models import quantization as jax_quant
from skypilot_tpu.models import sampling as jax_sampling
from skypilot_tpu_torch.models import generate as port_gen
from skypilot_tpu_torch.models import llama as port_llama
from skypilot_tpu_torch.models import quantization as port_quant
from skypilot_tpu_torch.models import sampling as port_sampling

LOGIT_TOL = 1e-4
BF16_LOGIT_TOL = 8e-2
MAX_LEN = 32

JAX_CFG = dataclasses.replace(jax_llama.TINY, dtype=jnp.float32)
PORT_CFG = dataclasses.replace(port_llama.TINY, dtype=torch.float32)


def _to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope='module')
def weights():
    """(jax params, port params), float32 TINY, same values."""
    jp = jax_llama.init_params(jax.random.PRNGKey(0), JAX_CFG)
    return jp, port_llama.params_from_numpy(_to_numpy(jp), PORT_CFG, 'cpu')


@pytest.fixture(scope='module')
def quant_weights(weights):
    jp = jax_quant.quantize_params(weights[0])
    return jp, port_llama.params_from_numpy(_to_numpy(jp), PORT_CFG, 'cpu')


def _prompt(seed, b, s):
    return np.random.default_rng(seed).integers(
        0, JAX_CFG.vocab_size, (b, s)).astype(np.int32)


# -- llama ----------------------------------------------------------------------


def test_presets_have_the_jax_widths():
    assert set(port_llama.PRESETS) == set(jax_llama.PRESETS)
    for name, jcfg in jax_llama.PRESETS.items():
        pcfg = port_llama.PRESETS[name]
        for field in dataclasses.fields(jcfg):
            if field.name != 'dtype':
                assert getattr(pcfg, field.name) == getattr(jcfg, field.name), (
                    name, field.name)
        assert pcfg.param_count == jcfg.param_count
        assert pcfg.dtype == torch.bfloat16


def test_init_params_tree_and_layout_match_jax():
    jshapes = jax.eval_shape(
        lambda k: jax_llama.init_params(k, jax_llama.TINY),
        jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    pp = port_llama.init_params(port_llama.TINY, gen, 'cpu')
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    pflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(pp)[0]}
    assert set(jflat) == set(pflat)
    for key, spec in jflat.items():
        assert tuple(pflat[key].shape) == spec.shape, key
        assert pflat[key].dtype == torch.bfloat16, key
    d = port_llama.TINY.d_model
    emb_std = float(pp['embed'].float().std())
    assert abs(emb_std - 1.0) < 0.1  # normal * d**-0.5 * d**0.5
    assert abs(float(pp['layers']['wq'].float().std()) - d ** -0.5) < 0.02
    assert torch.equal(pp['final_norm'], torch.ones(d, dtype=torch.bfloat16))


def test_moe_is_not_ported_yet():
    """MoE is ported now (this name predates it): MOE_TINY's weights
    come in JAX's tree, and ``forward_cached`` and greedy ``generate``
    on float32 MOE_TINY equal JAX's (logits within 1e-4, tokens equal).
    ``tests/test_torch_moe.py`` holds the rest of the MoE path."""
    jcfg = dataclasses.replace(jax_llama.MOE_TINY, dtype=jnp.float32)
    pcfg = dataclasses.replace(port_llama.MOE_TINY, dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    mine = port_llama.init_params(port_llama.MOE_TINY, gen, 'cpu')
    assert sorted(mine['layers']['moe']) == ['router', 'we_down', 'we_gate',
                                             'we_up']
    assert mine['layers']['moe']['router'].dtype == torch.float32
    jp = jax_llama.init_params(jax.random.PRNGKey(7), jcfg)
    pp = port_llama.params_from_numpy(_to_numpy(jp), pcfg, 'cpu')
    prompt = _prompt(14, 2, 9)
    want, _ = jax_gen.forward_cached(jp, jnp.asarray(prompt),
                                     jax_gen.init_cache(jcfg, 2, MAX_LEN),
                                     jcfg)
    got, _ = port_gen.forward_cached(
        pp, torch.from_numpy(prompt),
        port_gen.init_cache(pcfg, 2, MAX_LEN, device='cpu'), pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    want = jax_gen.generate(jp, jcfg, jnp.asarray(prompt), 5,
                            max_len=MAX_LEN)
    got = port_gen.generate(pp, pcfg, torch.from_numpy(prompt), 5,
                            max_len=MAX_LEN)
    assert got.tolist() == np.asarray(want).tolist()


def test_params_from_numpy_carries_bf16_leaves_exactly():
    jp = jax_llama.init_params(jax.random.PRNGKey(1), jax_llama.TINY)
    pp = port_llama.params_from_numpy(_to_numpy(jp), port_llama.TINY, 'cpu')
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        got = pp
        for k in path:
            got = got[k.key]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(leaf, np.float32))


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 4, 16), dtype=np.float32)
    w = rng.standard_normal((16,), dtype=np.float32)
    pos = rng.integers(0, 400, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        port_llama.rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                            1e-5).numpy(),
        np.asarray(jax_llama.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        port_llama.rope(torch.from_numpy(x), torch.from_numpy(pos),
                        500_000.0).numpy(),
        np.asarray(jax_llama.rope(jnp.asarray(x), jnp.asarray(pos),
                                  500_000.0)),
        atol=1e-4, rtol=1e-4)


# -- quantization ---------------------------------------------------------------


def test_quantize_params_matches_jax(weights, quant_weights):
    jq, _ = quant_weights
    pq = port_quant.quantize_params(weights[1])
    for scope, names in (('layers', port_quant._LAYER_TARGETS),  # noqa: SLF001
                         (None, port_quant._TOP_TARGETS)):  # noqa: SLF001
        for name in names:
            j = jq[scope][name] if scope else jq[name]
            p = pq[scope][name] if scope else pq[name]
            assert p['q8'].dtype == torch.int8
            np.testing.assert_array_equal(p['q8'].numpy(), np.asarray(j['q8']))
            np.testing.assert_allclose(p['s'].numpy(), np.asarray(j['s']),
                                       atol=1e-7, rtol=0)
    assert port_quant.is_quantized(pq['lm_head'])
    assert not port_quant.is_quantized(pq['embed'])
    deq = port_quant.dequantize(pq['layers']['wo'], 2, stacked=True)
    np.testing.assert_allclose(
        deq.numpy(),
        np.asarray(jax_quant.dequantize(jq['layers']['wo'], 2, stacked=True)),
        atol=1e-6)


@pytest.mark.parametrize('quantized', [False, True], ids=['bf16', 'int8'])
def test_mm_float32_output_keeps_float32_sums(quantized):
    """``out_dtype=float32`` (the lm_head's logits) is JAX's
    ``preferred_element_type=float32``: float32 sums of bf16 products, not
    a bf16 product cast up (whose logits tie on bf16's coarse grid)."""
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.standard_normal((4, 64)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((64, 256)) * 0.1, jnp.bfloat16)
    jw = jax_quant._quantize(w, 1, False) if quantized else w  # noqa: SLF001
    want = np.asarray(jax_quant.mm(x, jw, 'bd,dv->bv',
                                   preferred_element_type=jnp.float32))
    pw = (port_llama.params_from_numpy(
        {'lm_head': jax.tree.map(np.asarray, jw)}, port_llama.TINY,
        'cpu')['lm_head'])
    px = torch.tensor(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    got = port_quant.mm(px, pw, 'bd,dv->bv', out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    rounded = got.to(torch.bfloat16).float()
    assert float((got - rounded).abs().max()) > 1e-3  # not on bf16's grid


def _bf16_ordinals(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns as integers that step by one per ulp across 0."""
    i = bits.astype(np.int32)
    return np.where(i & 0x8000, -(i & 0x7fff), i)


# Largest share of bf16 outputs allowed to differ from JAX's at all, by one
# ulp: float32 sums taken in another order cross a rounding boundary now and
# then (6e-5 read here at lm_head's spec). A product rounded to bf16 before
# its scale (rounded twice) differs in about a quarter of them.
MM_BF16_DIFF_SHARE = 1e-2


@pytest.mark.parametrize('spec, x_shape, w_shape, n_contract', [
    ('bsd,dhk->bshk', (2, 8, 512), (512, 8, 64), 1),   # wq
    ('bd,dv->bv', (16, 512), (512, 4096), 1),           # lm_head, bf16 out
    ('bshk,hkd->bsd', (2, 8, 8, 64), (8, 64, 512), 2),  # wo
], ids=['wq', 'lm_head', 'wo'])
def test_mm_int8_bf16_rounds_once_like_jax(spec, x_shape, w_shape,
                                           n_contract):
    """int8 weights on bf16 activations: JAX scales the float32 sums and
    rounds once. The port's output is within one bf16 ulp of JAX's, and
    only a small share of values differs at all."""
    rng = np.random.default_rng(12)
    x = jnp.asarray(rng.standard_normal(x_shape), jnp.bfloat16)
    jw = jax_quant._quantize(  # noqa: SLF001
        jnp.asarray(rng.standard_normal(w_shape) * 0.05, jnp.float32),
        n_contract, False)
    want = np.asarray(jax_quant.mm(x, jw, spec))
    assert want.dtype == jnp.bfloat16
    pw = {k: torch.from_numpy(np.array(v)) for k, v in jw.items()}
    px = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    got = port_quant.mm(px, pw, spec)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    ulps = np.abs(_bf16_ordinals(got.view(torch.int16).numpy().view(np.uint16))
                  - _bf16_ordinals(want.view(np.uint16)))
    assert ulps.max() <= 1
    assert (ulps > 0).mean() <= MM_BF16_DIFF_SHARE


# -- sampling -------------------------------------------------------------------


@pytest.mark.parametrize('top_k, top_p', [
    ([3, 0, 7, 256], None),
    (None, [0.5, 1.0, 0.9, 0.05]),
    ([3, 0, 7, 50], [0.5, 0.7, 1.0, 0.95]),
])
def test_filter_logits_matches_jax(top_k, top_p):
    logits = np.random.default_rng(4).standard_normal(
        (4, 256)).astype(np.float32) * 3
    k_np = None if top_k is None else np.asarray(top_k, np.int32)
    p_np = None if top_p is None else np.asarray(top_p, np.float32)
    want = np.asarray(jax_sampling.filter_logits(
        jnp.asarray(logits), None if k_np is None else jnp.asarray(k_np),
        None if p_np is None else jnp.asarray(p_np)))
    got = port_sampling.filter_logits(
        torch.from_numpy(logits),
        None if k_np is None else torch.from_numpy(k_np),
        None if p_np is None else torch.from_numpy(p_np)).numpy()
    np.testing.assert_array_equal(got, want)


def test_sampled_rows_stay_in_the_filtered_support():
    logits = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, 256)).astype(np.float32) * 2)
    temps = torch.tensor([1.0, 0.7, 0.0, 2.0])
    top_k = torch.tensor([5, 0, 5, 20], dtype=torch.int32)
    top_p = torch.tensor([1.0, 0.6, 1.0, 0.9])
    support = port_sampling.filter_logits(
        logits / torch.clamp_min(temps, 1e-6)[:, None], top_k, top_p) > -1e29
    gen = torch.Generator().manual_seed(0)
    seen = torch.zeros_like(support)
    for _ in range(200):
        ids = port_sampling.sample(logits, temps, gen, top_k, top_p)
        assert ids.dtype == torch.int32
        assert bool(support[torch.arange(4), ids.long()].all())
        assert int(ids[2]) == int(torch.argmax(logits[2]))  # temp 0: greedy
        seen[torch.arange(4), ids.long()] = True
    assert int(seen[0].sum()) > 1  # row 0 really samples
    # Same seed, same draws: the generator is the only randomness.
    a = port_sampling.sample(logits, temps, torch.Generator().manual_seed(3),
                             top_k, top_p)
    b = port_sampling.sample(logits, temps, torch.Generator().manual_seed(3),
                             top_k, top_p)
    assert torch.equal(a, b)


# -- forward_cached and generate -----------------------------------------------


def _forward_pair(jp, pp, tokens, row_lens, kv_quant, steps=2):
    """Prefill then ``steps`` decode steps in both frameworks; returns the
    list of (jax logits, port logits) per call."""
    b = tokens.shape[0]
    jc = jax_gen.init_cache(JAX_CFG, b, MAX_LEN, quantize=kv_quant)
    pc = port_gen.init_cache(PORT_CFG, b, MAX_LEN, quantize=kv_quant,
                             device='cpu')
    jl = None if row_lens is None else jnp.asarray(row_lens)
    pl = None if row_lens is None else torch.from_numpy(row_lens)
    out = []
    jlog, jc = jax_gen.forward_cached(jp, jnp.asarray(tokens), jc, JAX_CFG,
                                      jl)
    plog, pc = port_gen.forward_cached(pp, torch.from_numpy(tokens), pc,
                                       PORT_CFG, pl)
    out.append((np.asarray(jlog), plog.numpy()))
    nxt = np.array(jnp.argmax(jlog, -1), np.int32)
    for _ in range(steps):
        ones = None if row_lens is None else np.ones((b,), np.int32)
        jlog, jc = jax_gen.forward_cached(
            jp, jnp.asarray(nxt)[:, None], jc, JAX_CFG,
            None if ones is None else jnp.asarray(ones))
        plog, pc = port_gen.forward_cached(
            pp, torch.from_numpy(nxt)[:, None], pc, PORT_CFG,
            None if ones is None else torch.from_numpy(ones))
        out.append((np.asarray(jlog), plog.numpy()))
        nxt = np.array(jnp.argmax(jlog, -1), np.int32)
    np.testing.assert_array_equal(pc.lengths.numpy(), np.asarray(jc.lengths))
    return out


@pytest.mark.parametrize('padded', [False, True], ids=['uniform', 'padded'])
@pytest.mark.parametrize('kv_quant', [False, True], ids=['kv_full', 'kv_int8'])
@pytest.mark.parametrize('w_quant', [False, True], ids=['w_full', 'w_int8'])
def test_forward_cached_logits_match_jax(weights, quant_weights, padded,
                                         kv_quant, w_quant):
    jp, pp = quant_weights if w_quant else weights
    tokens = _prompt(6, 3, 9)
    row_lens = np.asarray([9, 4, 6], np.int32) if padded else None
    for jlog, plog in _forward_pair(jp, pp, tokens, row_lens, kv_quant):
        assert plog.dtype == np.float32 and plog.shape == (3, 256)
        np.testing.assert_allclose(plog, jlog, atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize('padded', [False, True], ids=['uniform', 'padded'])
@pytest.mark.parametrize('kv_quant', [False, True], ids=['kv_full', 'kv_int8'])
def test_greedy_generate_identical_to_jax(weights, padded, kv_quant):
    jp, pp = weights
    tokens = _prompt(7, 3, 8)
    lens = np.asarray([8, 3, 5], np.int32) if padded else None
    want = np.asarray(jax_gen.generate(
        jp, JAX_CFG, jnp.asarray(tokens), 7, max_len=MAX_LEN,
        prompt_lengths=None if lens is None else jnp.asarray(lens),
        kv_quantize=kv_quant))
    got = port_gen.generate(
        pp, PORT_CFG, torch.from_numpy(tokens), 7, max_len=MAX_LEN,
        prompt_lengths=None if lens is None else torch.from_numpy(lens),
        kv_quantize=kv_quant)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_logits_within_tolerance():
    jp = jax_llama.init_params(jax.random.PRNGKey(2), jax_llama.TINY)
    pp = port_llama.params_from_numpy(_to_numpy(jp), port_llama.TINY, 'cpu')
    tokens = _prompt(8, 2, 6)
    lens = np.asarray([6, 2], np.int32)
    jc = jax_gen.init_cache(jax_llama.TINY, 2, MAX_LEN)
    pc = port_gen.init_cache(port_llama.TINY, 2, MAX_LEN, device='cpu')
    jlog, jc = jax_gen.forward_cached(jp, jnp.asarray(tokens), jc,
                                      jax_llama.TINY, jnp.asarray(lens))
    plog, pc = port_gen.forward_cached(pp, torch.from_numpy(tokens), pc,
                                       port_llama.TINY,
                                       torch.from_numpy(lens))
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog),
                               atol=BF16_LOGIT_TOL, rtol=0)
    nxt = np.asarray([3, 5], np.int32)
    jlog, _ = jax_gen.forward_cached(jp, jnp.asarray(nxt)[:, None], jc,
                                     jax_llama.TINY,
                                     jnp.ones((2,), jnp.int32))
    plog, _ = port_gen.forward_cached(pp, torch.from_numpy(nxt)[:, None],
                                      pc, port_llama.TINY,
                                      torch.ones((2,), dtype=torch.int32))
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog),
                               atol=BF16_LOGIT_TOL, rtol=0)


def test_sampled_generate_is_seeded_and_in_vocab(weights):
    _, pp = weights
    tokens = torch.from_numpy(_prompt(9, 2, 5))

    def run(seed):
        return port_gen.generate(
            pp, PORT_CFG, tokens, 6, temperature=0.8,
            generator=torch.Generator().manual_seed(seed), max_len=MAX_LEN,
            top_k=10, top_p=0.9)
    a, b = run(1), run(1)
    assert torch.equal(a, b)
    assert a.shape == (2, 6)
    assert int(a.min()) >= 0 and int(a.max()) < PORT_CFG.vocab_size
    with pytest.raises(ValueError, match='Generator'):
        port_gen.generate(pp, PORT_CFG, tokens, 3, temperature=0.5)


def test_cache_write_past_max_len_raises_not_clamps(weights):
    _, pp = weights
    cache = port_gen.init_cache(PORT_CFG, 1, 8, device='cpu')
    cache.lengths.fill_(6)
    with pytest.raises(RuntimeError, match='overflow'):
        port_gen.forward_cached(pp, torch.zeros((1, 3), dtype=torch.int32),
                                cache, PORT_CFG)
    with pytest.raises(ValueError, match='max_len'):
        port_gen.generate(pp, PORT_CFG, torch.zeros((1, 5), dtype=torch.int32),
                          5, max_len=8)


def test_pad_prompts_and_truncate_match_jax():
    rows = [[5, 6, 7], [1], [9, 9]]
    jt, jl = jax_gen.pad_prompts(rows)
    pt, plen = port_gen.pad_prompts(rows, device='cpu')
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(plen.numpy(), np.asarray(jl))
    assert pt.dtype == plen.dtype == torch.int32
    for toks, eos in (([1, 2, 3, 2], frozenset({2})), ([1, 2], None),
                      ([4, 5], frozenset({7}))):
        assert port_gen.truncate_at_stop(toks, eos) == \
            jax_gen.truncate_at_stop(toks, eos)
