"""Parity of the port's speculative decoding (``models/speculative.py``,
``forward_cached(all_logits=True)``, the replica's window path with
``--draft-model``) with the JAX package, on float32 TINY on the CPU.
Counterparts of ``tests/test_speculative.py``.

Greedy speculative output is the target's own greedy generation for any
draft, so it must equal JAX's greedy ``generate`` token for token, with a
random draft, a perfect draft and an int8 KV cache; the stats dict
(verifies, proposals, accepted, rates) must equal JAX's for the same
draft weights. Per-position logits within 1e-5 of JAX's. Every refusal
raises as JAX's does.

Weights come from the JAX ``init_params`` and are carried over with
``params_from_numpy``; prompts are numpy arrays handed to both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import generate as jax_gen
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.models import speculative as jax_spec
from skypilot_tpu_torch.models import generate as port_gen
from skypilot_tpu_torch.models import llama as port_llama
from skypilot_tpu_torch.models import speculative as port_spec
from skypilot_tpu_torch.serve import llm_server as port_srv

LOGIT_TOL = 1e-5
JAX_T = dataclasses.replace(jax_llama.TINY, dtype=jnp.float32)
JAX_D = dataclasses.replace(JAX_T, n_layers=1, d_model=32, n_heads=2,
                            n_kv_heads=1, d_ff=64, head_dim=16)


def _port_cfg(cfg):
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg) if f.name != 'dtype'}
    return port_llama.LlamaConfig(**fields, dtype=torch.float32)


PORT_T, PORT_D = _port_cfg(JAX_T), _port_cfg(JAX_D)


@pytest.fixture(scope='module')
def pair():
    """(jax target, jax draft, port target, port draft): a smaller,
    differently initialized draft over the same vocabulary."""
    jt = jax_llama.init_params(jax.random.PRNGKey(0), JAX_T)
    jd = jax_llama.init_params(jax.random.PRNGKey(99), JAX_D)
    return (jt, jd,
            port_llama.params_from_numpy(jax.tree.map(np.asarray, jt),
                                         PORT_T, 'cpu'),
            port_llama.params_from_numpy(jax.tree.map(np.asarray, jd),
                                         PORT_D, 'cpu'))


def _jax_greedy(params, prompt, n, kv_quantize=False):
    return np.asarray(jax_gen.generate(params, JAX_T, jnp.asarray(prompt),
                                       max_new_tokens=n, max_len=64,
                                       kv_quantize=kv_quantize))


def _both_spec(pair, prompt, n, k, draft='draft', **kw):
    """generate_speculative on both packages: (JAX out, JAX stats, port
    out, port stats). ``draft='target'``: the target as its own draft."""
    jt, jd, pt, pd = pair
    if draft == 'target':
        jd, pd, jdc, pdc = jt, pt, JAX_T, PORT_T
    else:
        jdc, pdc = JAX_D, PORT_D
    jo, js = jax_spec.generate_speculative(jt, JAX_T, jd, jdc,
                                           jnp.asarray(prompt), n, k=k,
                                           max_len=64, **kw)
    po, ps = port_spec.generate_speculative(pt, PORT_T, pd, pdc,
                                            torch.from_numpy(prompt), n,
                                            k=k, max_len=64, **kw)
    return np.asarray(jo), js, po.numpy(), ps


# -- forward_cached(all_logits=True) -----------------------------------------------


@pytest.mark.parametrize('kv_quantize', [False, True])
def test_forward_cached_all_logits_matches_jax(pair, kv_quantize):
    """A prefill, then a 4-position window with per-position logits (the
    verify's shape), against JAX's at 1e-5."""
    jt, _, pt, _ = pair
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 256, (2, 7)).astype(np.int32)
    window = rng.integers(0, 256, (2, 4)).astype(np.int32)
    jc = jax_gen.init_cache(JAX_T, 2, 32, quantize=kv_quantize)
    _, jc = jax_gen.forward_cached(jt, jnp.asarray(prompt), jc, JAX_T)
    want, jc = jax_gen.forward_cached(jt, jnp.asarray(window), jc, JAX_T,
                                      all_logits=True)
    pc = port_gen.init_cache(PORT_T, 2, 32, quantize=kv_quantize,
                             device='cpu')
    _, pc = port_gen.forward_cached(pt, torch.from_numpy(prompt), pc, PORT_T)
    got, pc = port_gen.forward_cached(pt, torch.from_numpy(window), pc,
                                      PORT_T, all_logits=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 4, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert pc.lengths.tolist() == np.asarray(jc.lengths).tolist() == [11, 11]
    # The last position's logits are what the default returns.
    last, _ = port_gen.forward_cached(
        pt, torch.from_numpy(window), port_gen.init_cache(
            PORT_T, 2, 32, quantize=kv_quantize, device='cpu'), PORT_T)
    full, _ = port_gen.forward_cached(
        pt, torch.from_numpy(window), port_gen.init_cache(
            PORT_T, 2, 32, quantize=kv_quantize, device='cpu'), PORT_T,
        all_logits=True)
    assert torch.equal(full[:, -1], last)


# -- generate_speculative ------------------------------------------------------------


@pytest.mark.parametrize('k', [1, 2, 4])
def test_speculative_exact_with_random_draft(pair, k):
    prompt = np.asarray([[5, 6, 7], [9, 8, 7]], np.int32)
    want = _jax_greedy(pair[0], prompt, 10)
    jo, js, po, ps = _both_spec(pair, prompt, 10, k)
    assert np.array_equal(jo, want) and np.array_equal(po, want), k
    assert po.dtype == np.int32
    assert ps == js and ps['verifies'] >= 1


def test_speculative_exact_with_perfect_draft(pair):
    """Target as draft: every proposal accepted, each verify commits the
    full window, and the stream is still exactly greedy."""
    prompt = np.asarray([[3, 4, 5, 6]], np.int32)
    want = _jax_greedy(pair[0], prompt, 12)
    jo, js, po, ps = _both_spec(pair, prompt, 12, 4, draft='target')
    assert np.array_equal(po, want) and np.array_equal(jo, want)
    assert ps == js
    assert ps['acceptance_rate'] == 1.0
    assert ps['tokens_per_verify'] >= 3.6 and ps['verifies'] <= 3


def test_speculative_kv_int8_exact(pair):
    prompt = np.asarray([[5, 6, 7]], np.int32)
    want = _jax_greedy(pair[0], prompt, 10, kv_quantize=True)
    jo, js, po, ps = _both_spec(pair, prompt, 10, 3, kv_quantize=True)
    assert np.array_equal(po, want) and np.array_equal(jo, want)
    assert ps == js


REFUSALS = {  # name -> (k, prompt len, max_new, max_len, draft cfg change,
    #                      target is MoE, message)
    'draft_context': (4, 3, 10, 64, dict(max_seq_len=32), False, 'draft'),
    'vocab': (4, 2, 4, None, dict(vocab_size=257), False, 'vocab'),
    'overlong': (8, 30, 30, 64, {}, False, 'max_len'),
    'k_zero': (0, 3, 4, 64, {}, False, 'k must be'),
    'moe_target': (4, 3, 4, None, {}, True, 'dense target'),
}


@pytest.mark.parametrize('name', sorted(REFUSALS))
def test_speculative_refusals_match_jax(pair, name):
    k, s, n, max_len, change, moe, match = REFUSALS[name]
    jt, jd, pt, pd = pair
    prompt = np.ones((1, s), np.int32)
    j_t_cfg = (dataclasses.replace(jax_llama.MOE_TINY,
                                   expert_capacity_factor=4.0)
               if moe else JAX_T)
    if moe:
        jt = jax_llama.init_params(jax.random.PRNGKey(7), j_t_cfg)
    with pytest.raises(ValueError, match=match):
        jax_spec.generate_speculative(
            jt, j_t_cfg, jd, dataclasses.replace(JAX_D, **change),
            jnp.asarray(prompt), n, k=k, max_len=max_len)
    with pytest.raises(ValueError, match=match):
        port_spec.generate_speculative(
            pt, _port_cfg(j_t_cfg) if moe else PORT_T, pd,
            dataclasses.replace(PORT_D, **change), torch.from_numpy(prompt),
            n, k=k, max_len=max_len)


# -- the replica's window path (--engine off) ---------------------------------------


def test_llm_server_draft_model_window_path(pair, monkeypatch):
    """Greedy requests decode speculatively on the window path and return
    the target's exact greedy stream (JAX's, on float32 TINY); /health
    carries the counters. A sampled request and a batch of mixed lengths
    take generate()."""
    jt, _, pt, _ = pair
    monkeypatch.setitem(port_llama.PRESETS, 'tiny-f32', PORT_T)
    server = port_srv.LlmServer('tiny-f32', max_len=64, engine='off',
                                draft_model='tiny-f32', device='cpu')
    try:
        server.params = pt  # oracle weights
        row = [5, 6, 7]
        want = _jax_greedy(jt, np.asarray([row], np.int32), 8)[0].tolist()
        status, body = server.generate({'tokens': [row],
                                        'max_new_tokens': 8})
        assert status == 200 and body['tokens'][0] == want
        status, health = server.health()
        assert health['draft_model'] == 'tiny-f32'
        spec = health['speculative']
        assert spec['requests'] == 1 and spec['verifies'] >= 1
        assert spec['proposals'] == 4 * spec['verifies']
        # Mixed lengths and sampled requests take the plain path.
        status, _ = server.generate({'tokens': [[1, 2], [3, 4, 5]],
                                     'max_new_tokens': 4})
        status2, _ = server.generate({'tokens': [[1, 2]], 'seed': 3,
                                      'temperature': 0.7,
                                      'max_new_tokens': 4})
        assert status == status2 == 200
        assert server.health()[1]['speculative']['requests'] == 1
    finally:
        server.stop()


def test_llm_server_rejects_short_context_draft(monkeypatch):
    short = dataclasses.replace(port_llama.TINY, max_seq_len=128)
    monkeypatch.setitem(port_llama.PRESETS, 'tiny-short', short)
    with pytest.raises(ValueError, match='max_seq_len'):
        port_srv.LlmServer('tiny', max_len=512, engine='off',
                           draft_model='tiny-short', device='cpu')
