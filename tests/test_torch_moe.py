"""Parity of the port's mixture-of-experts path with the JAX package, on
the CPU.

* ``models/moe.py``: ``moe_mlp`` against JAX's at capacity factors 8.0 (no
  drops), 1.0 and 0.5 (drops), with and without a token mask, in float32
  (within 1e-5) and bfloat16 (within 3e-2); ``expert_capacity``; the
  counterparts of ``tests/test_pipeline_moe.py``'s MoE tests, gradients
  against ``jax.grad`` (the router's included).
* ``llama``: ``forward_with_aux`` and ``loss_fn`` (with its ``moe_aux``)
  and their gradients on float32 MOE_TINY, for every remat policy.
* ``generate``: ``forward_cached`` logits (1e-4) and greedy tokens
  (equal) on float32 MOE_TINY, padded mixed-length batches included.
* The engine, slot and paged, token for token against the JAX engine
  under a capacity that binds, with requests that finish mid-chunk: the
  routing-mask test. It fails when the decode step routes by
  ``occupied & (lengths < limit)`` (the write mask) instead of JAX's
  dispatch snapshot. Expert capacity is at least 8, so a decode step
  binds only with more than 8 rows: the engine has 16 slots.
* The JAX engine's MoE rules (serial dispatch; no chunked prefill, prefix
  pool or block sharing; no draft), int8 weights (experts and router stay
  unquantized), LoRA (attention only), the ``Trainer`` against JAX's,
  ``train.run --model moe-tiny`` and the replica.

Weights come from the JAX ``init_params`` and are carried over with
``params_from_numpy``; inputs are made with numpy from a seed. Both
engines get every request before their loop starts, so they admit the
same groups into the same slots.
"""
import dataclasses
import json
import threading
import urllib.request
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import engine as jax_engine
from skypilot_tpu.models import generate as jax_gen
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.models import moe as jax_moe
from skypilot_tpu.models import quantization as jax_quant
from skypilot_tpu.train import trainer as jax_trainer
from skypilot_tpu_torch.models import engine as port_engine
from skypilot_tpu_torch.models import generate as port_gen
from skypilot_tpu_torch.models import llama as port_llama
from skypilot_tpu_torch.models import lora as port_lora
from skypilot_tpu_torch.models import moe as port_moe
from skypilot_tpu_torch.models import quantization as port_quant
from skypilot_tpu_torch.serve import llm_server as port_srv
from skypilot_tpu_torch.train import optim as port_optim
from skypilot_tpu_torch.train import run as port_run
from skypilot_tpu_torch.train import trainer as port_trainer

MLP_TOL = 1e-5
BF16_MLP_TOL = 3e-2
LOGIT_TOL = 1e-4
GRAD_TOL = 1e-5
PARAM_TOL = 2e-5
MAX_LEN = 64


def _cfgs(capacity_factor):
    """(JAX, port) float32 MOE_TINY at ``capacity_factor``."""
    return (dataclasses.replace(jax_llama.MOE_TINY, dtype=jnp.float32,
                                expert_capacity_factor=capacity_factor),
            dataclasses.replace(port_llama.MOE_TINY, dtype=torch.float32,
                                expert_capacity_factor=capacity_factor))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _sorted_leaves(tree):
    """Leaves in jax.tree's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    return [tree]


def _weights(capacity_factor, seed=7):
    jcfg, pcfg = _cfgs(capacity_factor)
    jp = jax_llama.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, pcfg, jp, port_llama.params_from_numpy(_np(jp), pcfg, 'cpu')


@pytest.fixture(scope='module')
def ample():
    """Capacity factor 4.0: no token is dropped (JAX's ``tiny_moe``)."""
    return _weights(4.0)


@pytest.fixture(scope='module')
def tight():
    """Capacity factor 1.0: drops happen."""
    return _weights(1.0)


def _moe_params(seed, d, f, e, dtype=jnp.float32):
    jp = jax_moe.init_moe_params(jax.random.PRNGKey(seed), d, f, e, dtype)
    pdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    pp = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.float32 if k == 'router' else pdt) for k, v in jp.items()}
    return jp, pp


# -- models/moe.py ------------------------------------------------------------


def test_expert_capacity_matches_jax():
    for n in (1, 4, 10, 16, 100, 256, 4096):
        for e, k, cf in ((4, 2, 1.0), (8, 2, 1.5), (4, 1, 0.5),
                         (8, 2, 1.25), (1, 1, 4.0)):
            assert port_moe.expert_capacity(n, e, k, cf) == \
                jax_moe.expert_capacity(n, e, k, cf), (n, e, k, cf)
    # moe-8x1b training at batch 2, seq 2048.
    assert port_moe.expert_capacity(4096, 8, 2, 1.5) == 1536


def _loads(x, router, k):
    """Choices per expert, from numpy: the most any expert is asked for."""
    logits = x.reshape(-1, x.shape[-1]).astype(np.float64) @ router
    top = np.argsort(-logits, axis=-1)[:, :k]
    return np.bincount(top.ravel(), minlength=router.shape[1])


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('capacity_factor', [8.0, 1.0, 0.5])
def test_moe_mlp_matches_jax(capacity_factor, masked, dtype):
    d, f, e, k = 16, 32, 4, 2
    jdt = jnp.float32 if dtype == 'float32' else jnp.bfloat16
    jp, pp = _moe_params(1, d, f, e, jdt)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 24, d)).astype(np.float32)
    mask = ((rng.random((2, 24)) > 0.3).astype(np.float32)
            if masked else None)
    cap = port_moe.expert_capacity(48, e, k, capacity_factor)
    real = x if mask is None else x[mask == 1]
    most = _loads(real, np.asarray(jp['router'], np.float64), k).max()
    # 0.5 drops (a choice with pos >= cap); 8.0 cannot. Every unchosen
    # (token, expert) pair ahead of an expert's first choice has pos -1.
    if capacity_factor != 1.0:
        assert (most > cap) == (capacity_factor == 0.5)
    jx = jnp.asarray(x).astype(jdt)
    want, want_aux = jax_moe.moe_mlp(
        jx, jp, e, k, capacity_factor,
        token_mask=None if mask is None else jnp.asarray(mask))
    px = torch.from_numpy(x).to(pp['we_gate'].dtype)
    got, aux = port_moe.moe_mlp(
        px, pp, e, k, capacity_factor,
        token_mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == px.dtype and tuple(got.shape) == x.shape
    tol = MLP_TOL if dtype == 'float32' else BF16_MLP_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)
    if mask is not None:  # masked tokens come out zero
        assert bool(torch.all(got.float()[torch.from_numpy(mask) == 0] == 0))


def test_moe_single_expert_equals_dense_mlp():
    """``test_pipeline_moe.py:107``: 1 expert, top-1 and ample capacity
    reduce to the dense SwiGLU."""
    d, f = 16, 32
    _, pp = _moe_params(0, d, f, 1)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 8, d)).astype(np.float32))
    out, aux = port_moe.moe_mlp(x, pp, num_experts=1, top_k=1,
                                capacity_factor=4.0)
    dense = (torch.nn.functional.silu(x @ pp['we_gate'][0])
             * (x @ pp['we_up'][0])) @ pp['we_down'][0]
    torch.testing.assert_close(out, dense, atol=1e-5, rtol=1e-5)
    assert float(aux) == pytest.approx(1.0)


def test_moe_routes_all_tokens_with_capacity():
    """``test_pipeline_moe.py:121``, and JAX's numbers on its inputs."""
    d, f, e = 8, 16, 4
    jp, pp = _moe_params(1, d, f, e)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (2, 16, d)))
    want, want_aux = jax_moe.moe_mlp(jnp.asarray(x), jp, e, 2, 8.0)
    out, aux = port_moe.moe_mlp(torch.from_numpy(x.copy()), pp, e, 2, 8.0)
    assert bool(torch.isfinite(out).all())
    assert 0.5 < float(aux) < float(e)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=MLP_TOL)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)


@pytest.mark.parametrize('capacity_factor', [2.0, 0.5])
def test_moe_grads_match_jax(capacity_factor):
    """``test_pipeline_moe.py:133`` against ``jax.grad``: every leaf's
    gradient, the router's (through the gates and the aux loss) and x's
    included."""
    d, f, e = 8, 16, 4
    jp, pp = _moe_params(1, d, f, e)
    x = np.random.default_rng(3).standard_normal((1, 8, d)).astype(
        np.float32)

    def jax_loss(p, x):
        out, aux = jax_moe.moe_mlp(x, p, e, 2, capacity_factor)
        return (out ** 2).mean() + 0.01 * aux

    want_p, want_x = jax.grad(jax_loss, argnums=(0, 1))(jp, jnp.asarray(x))
    for leaf in pp.values():
        leaf.requires_grad_(True)
    px = torch.from_numpy(x).requires_grad_(True)
    out, aux = port_moe.moe_mlp(px, pp, e, 2, capacity_factor)
    ((out ** 2).mean() + 0.01 * aux).backward()
    for name, leaf in pp.items():
        assert bool(torch.isfinite(leaf.grad).all()), name
        np.testing.assert_allclose(leaf.grad.numpy(),
                                   np.asarray(want_p[name]),
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)
    assert float(pp['router'].grad.abs().sum()) > 0
    np.testing.assert_allclose(px.grad.numpy(), np.asarray(want_x),
                               atol=GRAD_TOL, rtol=GRAD_TOL)


def test_expert_capacity_rounding():
    """``test_pipeline_moe.py:149``."""
    assert port_moe.expert_capacity(256, 4, 2, 1.0) == 128
    assert port_moe.expert_capacity(10, 4, 1, 1.0) == 8  # floor of 8
    assert port_moe.expert_capacity(100, 4, 2, 1.25) % 8 == 0


def test_token_mask_isolates_real_tokens_from_junk():
    """``test_generate.py:301``: under a tight capacity, masked junk comes
    out zero and takes no capacity, so the real tokens' outputs do not
    depend on it; and JAX's outputs are the port's."""
    d, e = 8, 2
    jp, pp = _moe_params(0, d, 16, e)
    rng = np.random.default_rng(1)
    real = rng.standard_normal((1, 4, d)).astype(np.float32)
    junk_a = rng.standard_normal((1, 4, d)).astype(np.float32) * 10
    junk_b = rng.standard_normal((1, 4, d)).astype(np.float32) * -7
    mask = np.concatenate([np.ones((1, 4)), np.zeros((1, 4))],
                          axis=1).astype(np.float32)
    outs = []
    for junk in (junk_a, junk_b):
        x = np.concatenate([real, junk], axis=1)
        got, _ = port_moe.moe_mlp(torch.from_numpy(x), pp, e, 1, 1.0,
                                  token_mask=torch.from_numpy(mask))
        want, _ = jax_moe.moe_mlp(jnp.asarray(x), jp, e, 1, 1.0,
                                  token_mask=jnp.asarray(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=MLP_TOL)
        outs.append(got)
    assert torch.equal(outs[0][:, :4], outs[1][:, :4])
    assert torch.equal(outs[0][:, 4:], torch.zeros(1, 4, d))


def test_init_params_tree_matches_jax():
    jshapes = jax.eval_shape(
        lambda k: jax_llama.init_params(k, jax_llama.MOE_TINY),
        jax.random.PRNGKey(0))
    pp = port_llama.init_params(port_llama.MOE_TINY,
                                torch.Generator().manual_seed(0), 'cpu')
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    pflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(pp)[0]}
    assert set(jflat) == set(pflat)
    for key, spec in jflat.items():
        assert tuple(pflat[key].shape) == spec.shape, key
        assert str(pflat[key].dtype).split('.')[-1] == spec.dtype.name, key
    cfg = port_llama.MOE_TINY
    assert sum(t.numel() for t in _sorted_leaves(pp)) == cfg.param_count
    assert port_llama.MOE_8X1B.param_count == 6_702_868_480


# -- llama: forward, loss, gradients ------------------------------------------


def _tokens(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize('policy', ['full', 'attn', 'heavy', 'dots', None])
def test_loss_aux_and_grads_match_jax(tight, policy):
    jcfg, pcfg, jp, _ = tight
    tokens = _tokens(0, 2, 32)
    remat = policy is not None
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jax_llama.loss_fn(p, jnp.asarray(tokens), jcfg,
                                    remat=remat,
                                    remat_policy=policy or 'full'),
        has_aux=True)(jp)
    params = port_llama.params_from_numpy(_np(jp), pcfg, 'cpu')
    for leaf in port_optim.tree_leaves(params):
        leaf.requires_grad_(True)
    p_loss, p_metrics = port_llama.loss_fn(
        params, torch.from_numpy(tokens), pcfg, remat=remat,
        remat_policy=policy or 'full')
    p_loss.backward()
    assert abs(float(p_loss.detach()) - float(loss)) <= GRAD_TOL
    p_aux = float(p_metrics['moe_aux'].detach())
    assert p_aux == pytest.approx(float(metrics['moe_aux']), rel=1e-5)
    assert p_aux > 0.5
    for want, got in zip(jax.tree.leaves(grads), _sorted_leaves(params)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)


def test_forward_with_aux_matches_jax(tight):
    jcfg, pcfg, jp, pp = tight
    tokens = _tokens(1, 2, 24)
    want, want_aux = jax_llama.forward_with_aux(jp, jnp.asarray(tokens),
                                                jcfg)
    got, aux = port_llama.forward_with_aux(pp, torch.from_numpy(tokens),
                                           pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)


# -- generate -----------------------------------------------------------------


def test_cached_prefill_logits_match_forward_and_jax(ample):
    """``test_generate.py:147``."""
    jcfg, pcfg, jp, pp = ample
    prompt = _tokens(11, 2, 9)
    cache = port_gen.init_cache(pcfg, 2, 32, device='cpu')
    logits, cache = port_gen.forward_cached(pp, torch.from_numpy(prompt),
                                            cache, pcfg)
    full = port_llama.forward(pp, torch.from_numpy(prompt), pcfg)[:, -1]
    torch.testing.assert_close(logits, full, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    want, _ = jax_gen.forward_cached(jp, jnp.asarray(prompt),
                                     jax_gen.init_cache(jcfg, 2, 32), jcfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert cache.lengths.tolist() == [9, 9]


@pytest.mark.parametrize('which', ['ample', 'tight'])
def test_greedy_generation_matches_jax(which, request):
    """``test_generate.py:160``: greedy tokens equal JAX's (and, with
    ample capacity, the full re-forward's)."""
    jcfg, pcfg, jp, pp = request.getfixturevalue(which)
    prompt = _tokens(12, 2, 5)
    got = port_gen.generate(pp, pcfg, torch.from_numpy(prompt), 6)
    want = jax_gen.generate(jp, jcfg, jnp.asarray(prompt), max_new_tokens=6)
    assert got.tolist() == np.asarray(want).tolist()
    if which == 'ample':
        toks = torch.from_numpy(prompt)
        for _ in range(6):
            nxt = port_llama.forward(pp, toks, pcfg)[:, -1].argmax(-1)
            toks = torch.cat([toks, nxt[:, None].to(toks.dtype)], dim=1)
        assert got.tolist() == toks[:, 5:].tolist()


@pytest.mark.parametrize('kv_int8', [False, True])
def test_padded_mixed_length_batch_matches_individual(ample, kv_int8):
    """``test_generate.py:278``: right-padded MoE rows generate what each
    generates alone (padding takes no expert capacity), and what JAX's
    padded batch generates."""
    jcfg, pcfg, jp, pp = ample
    rng = np.random.default_rng(31)
    rows = [rng.integers(0, 256, n).tolist() for n in (3, 7, 4)]
    padded, lens = port_gen.pad_prompts(rows, device='cpu')
    got = port_gen.generate(pp, pcfg, padded, 5, prompt_lengths=lens,
                            max_len=32, kv_quantize=kv_int8)
    for i, row in enumerate(rows):
        solo = port_gen.generate(pp, pcfg, torch.tensor([row]), 5,
                                 max_len=32, kv_quantize=kv_int8)
        assert got[i].tolist() == solo[0].tolist(), i
    jpad, jlens = jax_gen.pad_prompts(rows)
    want = jax_gen.generate(jp, jcfg, jpad, max_new_tokens=5,
                            prompt_lengths=jlens, max_len=32,
                            kv_quantize=kv_int8)
    assert got.tolist() == np.asarray(want).tolist()


def test_padded_batch_under_tight_capacity_matches_jax(tight):
    """With drops, padded rows route as JAX's do: padding is masked out
    of the capacity cumsum in both."""
    jcfg, pcfg, jp, pp = tight
    rng = np.random.default_rng(32)
    rows = [rng.integers(0, 256, n).tolist() for n in (2, 9, 5, 12)]
    padded, lens = port_gen.pad_prompts(rows, device='cpu')
    got = port_gen.generate(pp, pcfg, padded, 6, prompt_lengths=lens,
                            max_len=32)
    jpad, jlens = jax_gen.pad_prompts(rows)
    want = jax_gen.generate(jp, jcfg, jpad, max_new_tokens=6,
                            prompt_lengths=jlens, max_len=32)
    assert got.tolist() == np.asarray(want).tolist()


# -- the engine ---------------------------------------------------------------


def _run_all(eng, reqs):
    """Submit every request before the engine's loop starts, so the
    first admission sees them all; return their tokens."""
    with mock.patch.object(type(eng), 'start', lambda self: None):
        futs = [eng.submit(row, n) for row, n in reqs]
    type(eng).start(eng)
    try:
        return [f.result(timeout=300) for f in futs]
    finally:
        eng.stop()


def _binding_traffic(seed=3, n=24):
    """Prompts of 2-13 tokens, max_new 2-9: with chunks of 4 steps most
    requests finish mid-chunk."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, int(rng.integers(2, 14))).tolist(),
             int(rng.integers(2, 10))) for _ in range(n)]


@pytest.mark.parametrize('kv_int8', [False, True])
@pytest.mark.parametrize('layout', ['slot', 'paged'])
def test_engine_routing_mask_matches_jax_under_binding_capacity(
        tight, layout, kv_int8):
    """The routing-mask test. 16 slots at capacity factor 1.0 bind at
    every decode step (capacity 8 for 32 choices over 4 experts). A
    request that finishes mid-chunk keeps routing its junk for the rest
    of the chunk in the JAX engine (its mask is the dispatch snapshot),
    so the port must too, token for token."""
    jcfg, pcfg, jp, pp = tight
    reqs = _binding_traffic()
    kw = dict(slots=16, max_len=MAX_LEN, chunk_steps=4, kv_layout=layout,
              kv_quantize=kv_int8)
    want = _run_all(jax_engine.ContinuousEngine(jp, jcfg, **kw), reqs)
    eng = port_engine.ContinuousEngine(pp, pcfg, device='cpu', **kw)
    got = _run_all(eng, reqs)
    assert got == want
    assert eng.stats()['pipeline']['pipeline_depth'] == 0


def test_engine_moe_junk_slots_take_no_expert_capacity(ample):
    """``test_engine.py:119``: after a warm-up leaves junk in freed slots,
    a lone greedy request equals its solo ``generate``."""
    _, pcfg, _, pp = ample
    for layout in ('slot', 'paged'):
        eng = port_engine.ContinuousEngine(pp, pcfg, slots=4, max_len=32,
                                           chunk_steps=4, kv_layout=layout,
                                           device='cpu')
        try:
            for f in [eng.submit([i + 1, i + 2], 3) for i in range(4)]:
                f.result(timeout=120)
            row = [11, 12, 13, 14]
            got = eng.submit(row, 5).result(timeout=120)
        finally:
            eng.stop()
        solo = port_gen.generate(pp, pcfg, torch.tensor([row]), 5,
                                 max_len=32)
        assert got == solo[0].tolist(), layout


def test_engine_applies_the_jax_moe_rules(ample, monkeypatch):
    """``test_engine.py:322``, ``:870``, ``test_engine_pipeline.py:185``,
    ``test_engine_prefix_share.py:292``: an MoE engine dispatches
    serially and quietly turns off chunked prefill, the prefix pool and
    block sharing (with it the KV tiers), as the JAX engine does; a
    draft is refused."""
    jcfg, pcfg, jp, pp = ample
    monkeypatch.setenv('SKYTPU_LLM_PREFIX_SHARE', '1')
    for layout in ('slot', 'paged'):
        kw = dict(slots=2, max_len=32, prefix_slots=4, prefill_chunk=8,
                  pipeline=True, kv_layout=layout)
        jeng = jax_engine.ContinuousEngine(jp, jcfg, **kw)
        eng = port_engine.ContinuousEngine(pp, pcfg, device='cpu', **kw)
        for e in (jeng, eng):
            assert e.pipeline_depth == 0
            assert e.prefill_chunk == 0
            assert e.prefix_slots == 0
            assert e._prefix_pool is None  # noqa: SLF001
            assert not e.prefix_share
            assert e._kv_tiers is None  # noqa: SLF001
        assert eng.stats()['pipeline']['pipeline_depth'] == 0
    with pytest.raises(ValueError, match='dense target'):
        port_engine.ContinuousEngine(pp, pcfg, draft_params=pp,
                                     draft_cfg=pcfg, device='cpu')


def test_quantized_moe_keeps_experts_and_router(ample):
    """``test_quantization.py:77``: int8 weights leave the experts and
    the router as they are, and greedy tokens equal JAX's."""
    jcfg, pcfg, jp, pp = ample
    q = port_quant.quantize_params(pp)
    assert not any(port_quant.is_quantized(v)
                   for v in q['layers']['moe'].values())
    for name, leaf in q['layers']['moe'].items():
        assert leaf is pp['layers']['moe'][name]
    assert q['layers']['moe']['router'].dtype == torch.float32
    assert port_quant.is_quantized(q['layers']['wq'])
    prompt = _tokens(13, 2, 8)
    got = port_gen.generate(q, pcfg, torch.from_numpy(prompt), 4)
    jq = jax_quant.quantize_params(jp)
    want = jax_gen.generate(jq, jcfg, jnp.asarray(prompt), 4)
    assert got.tolist() == np.asarray(want).tolist()
    # The carried-over JAX int8 tree gives the same tokens.
    qq = port_llama.params_from_numpy(_np(jq), pcfg, 'cpu')
    assert port_gen.generate(qq, pcfg, torch.from_numpy(prompt),
                             4).tolist() == got.tolist()


# -- training -----------------------------------------------------------------


def test_lora_on_moe_takes_attention_targets_only(ample):
    """``test_lora.py:70-87``: MLP targets raise JAX's 'attention only'
    error, from ``init_lora`` and from the ``Trainer`` before it trains;
    attention targets are adapted."""
    jcfg, pcfg, jp, pp = ample
    for targets in (('w_gate',), ('w_up', 'w_down')):
        with pytest.raises(ValueError, match='attention only'):
            port_lora.init_lora(torch.Generator(), pp,
                                port_lora.LoraConfig(targets=targets),
                                device='cpu')
    trainer = port_trainer.Trainer(port_trainer.TrainerConfig(
        model=pcfg, global_batch_size=2, seq_len=16,
        lora=port_lora.LoraConfig(targets=('wq', 'w_gate'))), device='cpu')
    with pytest.raises(ValueError, match='attention only'):
        trainer.init_state(seed=0)
    with pytest.raises(ValueError, match='attention only'):
        trainer.init_state_from_numpy(_np(jp))
    got = port_lora.init_lora(torch.Generator(), pp,
                              port_lora.LoraConfig(rank=2), device='cpu')
    assert sorted(got) == ['wk', 'wo', 'wq', 'wv']


@pytest.mark.parametrize('variant', ['adafactor', 'adamw', 'lora'])
def test_trainer_matches_jax_trainer(tight, variant):
    """3 steps of the ``Trainer`` on MOE_TINY against JAX's: losses,
    ``moe_aux`` and params (with LoRA, the adapters)."""
    jcfg, pcfg, _, _ = tight
    kw = dict(global_batch_size=2, seq_len=32, warmup_steps=1,
              optimizer='adamw' if variant == 'adamw' else 'adafactor')
    j_lora = p_lora = None
    if variant == 'lora':
        from skypilot_tpu.models import lora as jax_lora
        j_lora = jax_lora.LoraConfig(rank=2)
        p_lora = port_lora.LoraConfig(rank=2)
    j_trainer = jax_trainer.Trainer(jax_trainer.TrainerConfig(
        model=jcfg, lora=j_lora, **kw))
    j_state = j_trainer.init_state(0)
    p_trainer = port_trainer.Trainer(port_trainer.TrainerConfig(
        model=pcfg, lora=p_lora, **kw), device='cpu')
    p_state = p_trainer.init_state_from_numpy(
        jax.tree.map(np.array, j_state['params']),
        None if j_lora is None else jax.tree.map(np.array,
                                                 j_state['lora']))
    step = j_trainer.compiled_step()
    rng = np.random.default_rng(5)
    for _ in range(3):
        batch = rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
        j_state, j_metrics = step(j_state, jnp.asarray(batch))
        p_state, p_metrics = p_trainer.step(p_state, batch)
        assert abs(float(p_metrics['loss'])
                   - float(j_metrics['loss'])) <= GRAD_TOL
        assert float(p_metrics['moe_aux']) == pytest.approx(
            float(j_metrics['moe_aux']), rel=1e-5)
    key = 'params' if j_lora is None else 'lora'
    for want, got in zip(jax.tree.leaves(j_state[key]),
                         _sorted_leaves(p_state[key])):
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=PARAM_TOL, rtol=0)


def test_train_run_trains_moe_tiny_and_refuses_the_expert_mesh(capsys):
    """moe-tiny trains through ``train.run``; an expert mesh trains too
    (tests/test_torch_train_axes.py), and the one refusal left is JAX's
    ``ValueError`` for experts that do not split over the axis, raised
    before any rank starts."""
    out = port_run.main(['--model', 'moe-tiny', '--global-batch-size', '2',
                         '--seq-len', '32', '--steps', '3',
                         '--warmup-steps', '1', '--log-every', '1',
                         '--device', 'cpu'])
    assert len(out['losses']) == len(out['moe_aux']) == 3
    assert all(np.isfinite(out['losses'] + out['moe_aux']))
    printed = capsys.readouterr().out
    assert 'B active' in printed and 'moe_aux=' in printed
    with pytest.raises(ValueError, match='4 experts do not split over '
                                         'expert'):
        port_run.main(['--model', 'moe-tiny', '--mesh', 'fsdp=2,expert=8',
                       '--device', 'cpu'])
    assert 'rank-summary' not in capsys.readouterr().out


# -- the replica --------------------------------------------------------------


def _post(url, body):
    req = urllib.request.Request(
        f'{url}/generate', data=json.dumps(body).encode(),
        headers={'Content-Type': 'application/json'}, method='POST')
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


@pytest.mark.parametrize('engine', ['continuous', 'off'])
def test_replica_serves_moe_tiny(engine):
    server = port_srv.LlmServer('moe-tiny', max_len=MAX_LEN, device='cpu',
                                engine=engine, prefix_cache=8)
    httpd = server.make_httpd('127.0.0.1', 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f'http://127.0.0.1:{httpd.server_address[1]}'
    try:
        row = [5, 6, 7, 8]
        status, body = _post(url, {'tokens': [row], 'max_new_tokens': 6})
        assert status == 200
        solo = port_gen.generate(server.params, server.cfg,
                                 torch.tensor([row]), 6,
                                 max_len=server.max_len)
        assert body['tokens'] == solo.tolist()
        health = server.health()[1]
        if engine == 'continuous':
            stats = health['engine']
            assert stats['pipeline']['pipeline_depth'] == 0
            assert stats['prefix_cache']['slots'] == 0
        else:
            assert 'engine' not in health  # as in JAX
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()
        thread.join(10)
    with pytest.raises(ValueError, match='dense target'):
        port_srv.LlmServer('moe-tiny', device='cpu', draft_model='tiny')
