"""The pipe, seq and expert axes of the port against the JAX package, on
the CPU: ``parallel/pipeline.py``, ``parallel/ring_attention.py`` and
``models/moe.py`` on a mesh.

One process: ``split_stages``, ``pipeline_apply`` on a toy stage (values,
the aux loss with bubbles masked, gradients) and ``llama.forward`` with
``pipeline_stages=2`` on one device, each against JAX's
(``tests/test_pipeline_moe.py:31-99``); ``_block_attn`` and a one-shard
ring against JAX's; the MoE logical axes.

A 4-rank gloo gang (``run_gang`` of ``tests/test_torch_tp.py``, one
start for the module) runs, on four meshes one after another:

- ``pipe=4``: the toy pipeline over ranks, 3 microbatches (6 ticks, 3 of
  them a bubble on some stage): the last stage's outputs, the aux summed
  over the stages and every gradient against JAX's ``pipeline_apply``;
- ``seq=4``: ring attention, causal and not, the output and the q/k/v
  gradients of every rank's block against JAX's ``ring_attention`` on a
  ``seq=4`` mesh of the virtual devices;
- ``data=2,expert=2`` and ``seq=2,expert=2``: ``moe_mlp`` with a
  capacity factor of 0.5, so that tokens drop, against JAX's on the
  global batch: outputs, aux loss, and the gradients of the router,
  of every expert leaf and of the input.

Float32 throughout; tolerances 1e-5 (values) and 1e-4 (gradients, whose
sums run over ranks in another order than one device's).
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.models import moe as jax_moe
from skypilot_tpu.parallel import mesh as jax_mesh
from skypilot_tpu.parallel import pipeline as jax_pipe
from skypilot_tpu.parallel import ring_attention as jax_ring
from skypilot_tpu_torch.models import llama as port_llama
from skypilot_tpu_torch.models import moe as port_moe
from skypilot_tpu_torch.parallel import pipeline as port_pipe
from skypilot_tpu_torch.parallel import ring_attention as port_ring

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_tp import run_gang  # noqa: E402

VAL_TOL = 1e-5
GRAD_TOL = 1e-4
TINY32 = dataclasses.replace(jax_llama.TINY, dtype=jnp.float32)

# The toy pipeline: 8 layers of tanh(x @ w), aux = mean(y ** 2) a stage.
PIPE_LAYERS, PIPE_D, PIPE_MICRO, PIPE_MB = 8, 8, 3, 2
AUX_W = 0.5
# Ring attention: q [B, Hq, S, D], k/v [B, Hkv, S, D] (group 2).
RING = dict(b=2, hq=4, hkv=2, s=32, d=8)
# MoE: 4 experts, top-2, capacity factor 0.5 (choices drop).
MOE = dict(b=4, s=8, d=16, f=32, e=4, k=2, cf=0.5)
MOE_AUX_W = 0.3


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32)).requires_grad_(grad)


# -- the toy pipeline ----------------------------------------------------------


def _toy_inputs():
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((PIPE_LAYERS, PIPE_D, PIPE_D)) * 0.3
          ).astype(np.float32)
    x = rng.standard_normal((PIPE_MICRO, PIPE_MB, PIPE_D)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    return ws, x, ct


def _jax_toy(num_stages):
    """JAX's pipeline on the toy: (outputs, aux, d ws, d x) of
    sum(outputs * ct) + AUX_W * aux."""
    ws, x, ct = _toy_inputs()

    def stage_fn(stage_ws, x_mb):
        def body(carry, w):
            return jnp.tanh(carry @ w), None
        y, _ = jax.lax.scan(body, x_mb, stage_ws)
        return y, jnp.mean(y ** 2)

    def loss(ws, x):
        out, aux = jax_pipe.pipeline_apply(
            stage_fn, jax_pipe.split_stages(ws, num_stages), x,
            num_stages=num_stages)
        return jnp.sum(out * ct) + AUX_W * aux, (out, aux)

    (_, (out, aux)), (g_ws, g_x) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(ws), jnp.asarray(x))
    return [np.asarray(a) for a in (out, aux, g_ws, g_x)]


def _port_toy_stage(stage_ws, x_mb):
    y = x_mb
    for w in stage_ws.unbind(0):
        y = torch.tanh(y @ w)
    return y, (y ** 2).mean()


@pytest.mark.parametrize('num_stages', [1, 2, 4])
def test_pipeline_apply_one_process_matches_jax(num_stages):
    ws, x, ct = _toy_inputs()
    want_out, want_aux, want_gws, want_gx = _jax_toy(num_stages)
    tw, tx = _t(ws, True), _t(x, True)
    out, aux = port_pipe.pipeline_apply(
        _port_toy_stage, port_pipe.split_stages(tw, num_stages), tx,
        num_stages=num_stages)
    (out * _t(ct)).sum().add(AUX_W * aux).backward()
    _close(out.detach(), want_out, VAL_TOL)
    _close(float(aux.detach()), want_aux, VAL_TOL)
    _close(tw.grad, want_gws, GRAD_TOL)
    _close(tx.grad, want_gx, GRAD_TOL)


def test_pipeline_apply_aux_counts_each_valid_pair_once():
    """JAX's ``test_pipeline_apply_aux_masks_bubbles``: 2 stages x 3
    microbatches of an identity stage whose aux is 1: 6, bubbles masked."""
    x = torch.ones((3, 2, 4))

    def stage_fn(params, x_mb):
        del params
        return x_mb, torch.ones(())

    out, aux = port_pipe.pipeline_apply(
        stage_fn, torch.zeros((2, 1, 4, 4)), x, num_stages=2)
    assert float(aux) == 6.0
    assert torch.equal(out, x)


def test_split_stages_matches_jax_and_rejects_indivisible():
    tree = {'a': np.arange(24, dtype=np.float32).reshape(4, 3, 2),
            'moe': {'b': np.arange(8, dtype=np.float32).reshape(4, 2)}}
    want = jax_pipe.split_stages(jax.tree.map(jnp.asarray, tree), 2)
    got = port_pipe.split_stages(
        {'a': _t(tree['a']), 'moe': {'b': _t(tree['moe']['b'])}}, 2)
    assert np.array_equal(got['a'].numpy(), np.asarray(want['a']))
    assert np.array_equal(got['moe']['b'].numpy(),
                          np.asarray(want['moe']['b']))
    for split in (jax_pipe.split_stages, port_pipe.split_stages):
        with pytest.raises(ValueError, match='3 layers not divisible by 2'):
            split(jnp.zeros((3, 2)) if split is jax_pipe.split_stages
                  else torch.zeros((3, 2)), 2)


# -- llama with pipeline stages on one device ---------------------------------


def _llama_params(cfg):
    params = jax_llama.init_params(jax.random.PRNGKey(0), cfg)
    return params, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize('stages,micro', [(2, 2), (2, 4)])
def test_llama_forward_with_pipeline_stages_matches_jax(stages, micro):
    """``test_pipeline_moe.py:83``'s pipelined forward, against JAX's
    pipelined forward on the same weights (float32 TINY)."""
    cfg = dataclasses.replace(TINY32, pipeline_stages=stages,
                              pipeline_microbatches=micro)
    params, tree = _llama_params(cfg)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)
    want = np.asarray(jax_llama.forward(params, jnp.asarray(toks), cfg))
    pcfg = dataclasses.replace(port_llama.TINY, dtype=torch.float32,
                               pipeline_stages=stages,
                               pipeline_microbatches=micro)
    got = port_llama.forward(port_llama.params_from_numpy(tree, pcfg, 'cpu'),
                             torch.from_numpy(toks), pcfg)
    _close(got.detach(), want, VAL_TOL)


def test_llama_moe_loss_with_pipeline_stages_matches_jax():
    """An MoE model's loss under 2 stages x 2 microbatches: the aux sums
    over the valid pairs and divides by the microbatches, as JAX's."""
    cfg = dataclasses.replace(jax_llama.MOE_TINY, dtype=jnp.float32,
                              pipeline_stages=2, pipeline_microbatches=2)
    params, tree = _llama_params(cfg)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)
    _, want = jax_llama.loss_fn(params, jnp.asarray(toks), cfg, remat=False)
    pcfg = dataclasses.replace(port_llama.MOE_TINY, dtype=torch.float32,
                               pipeline_stages=2, pipeline_microbatches=2)
    _, got = port_llama.loss_fn(
        port_llama.params_from_numpy(tree, pcfg, 'cpu'),
        torch.from_numpy(toks), pcfg, remat=True)
    for key in ('loss', 'moe_aux'):
        _close(float(got[key]), float(want[key]), VAL_TOL)


def test_llama_pipeline_bad_microbatch_count_raises_jax_error():
    """``test_pipeline_moe.py:96``: 4 rows do not split into 3."""
    cfg = dataclasses.replace(port_llama.TINY, dtype=torch.float32,
                              pipeline_stages=2, pipeline_microbatches=3)
    params = port_llama.init_params(cfg, torch.Generator().manual_seed(0),
                                    'cpu')
    with pytest.raises(ValueError, match='batch 4 not divisible by 3 '
                                         'microbatches'):
        port_llama.forward(params, torch.zeros((4, 16), dtype=torch.int32),
                           cfg)


# -- ring attention and MoE axes, one process ----------------------------------


def _ring_inputs():
    rng = np.random.default_rng(2)
    r = RING
    q = rng.standard_normal((r['b'], r['hq'], r['s'], r['d']))
    k = rng.standard_normal((r['b'], r['hkv'], r['s'], r['d']))
    v = rng.standard_normal((r['b'], r['hkv'], r['s'], r['d']))
    ct = rng.standard_normal(q.shape)
    return [a.astype(np.float32) for a in (q, k, v, ct)]


def test_block_attn_matches_jax():
    q, k, v, _ = _ring_inputs()
    for causal, q_start, k_start in ((True, 8, 0), (True, 0, 8),
                                     (False, 0, 0)):
        want = jax_ring._block_attn(  # noqa: SLF001
            jnp.asarray(q[:, :, :8]), jnp.asarray(k[:, :, 8:16]),
            jnp.asarray(v[:, :, 8:16]), q_start, k_start, causal)
        got = port_ring._block_attn(  # noqa: SLF001
            _t(q[:, :, :8]), _t(k[:, :, 8:16]), _t(v[:, :, 8:16]), q_start,
            k_start, causal)
        for g, w in zip(got, want):
            _close(g, np.asarray(w), VAL_TOL)


def test_ring_attention_on_one_shard_is_attention():
    """With no ``seq`` ranks the ring is one block: JAX's ring on a
    ``seq=1`` mesh."""
    q, k, v, _ = _ring_inputs()
    mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec(fsdp=1),
                               devices=jax.devices()[:1])
    for causal in (True, False):
        want = jax_ring.ring_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), mesh, causal=causal)
        got = port_ring.ring_attention(_t(q), _t(k), _t(v), causal=causal)
        _close(got, np.asarray(want), VAL_TOL)


def test_moe_logical_axes_equal_jax():
    """The MoE axes are JAX's, and ``quantize_params_sharded`` takes an
    MoE model through them (the experts stay unquantized, as in
    ``quantize_params``)."""
    from skypilot_tpu_torch.models import quantization as port_quant
    from skypilot_tpu_torch.parallel import mesh as port_mesh
    assert port_moe.moe_logical_axes() == jax_moe.moe_logical_axes()
    assert port_llama.param_logical_axes(port_llama.MOE_TINY) == \
        jax_llama.param_logical_axes(jax_llama.MOE_TINY)
    cfg = port_llama.MOE_TINY
    params = port_llama.init_params(cfg, torch.Generator().manual_seed(0),
                                    'cpu')
    got = port_quant.quantize_params_sharded(
        params, cfg, port_mesh.single_device_mesh('cpu'))
    want = port_quant.quantize_params(params)
    for name in ('wq', 'wo'):
        assert torch.equal(got['layers'][name]['q8'],
                           want['layers'][name]['q8'])
    for name, leaf in params['layers']['moe'].items():
        assert got['layers']['moe'][name] is leaf


# -- the 4-rank gang -------------------------------------------------------------


def _jax_ring(causal):
    q, k, v, ct = _ring_inputs()
    mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec(fsdp=1, seq=4),
                               devices=jax.devices()[:4])

    def loss(q, k, v):
        out = jax_ring.ring_attention(q, k, v, mesh, causal=causal)
        return jnp.sum(out * ct), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _moe_inputs():
    m = MOE
    rng = np.random.default_rng(3)
    p = jax_moe.init_moe_params(jax.random.PRNGKey(4), m['d'], m['f'],
                                m['e'], jnp.float32)
    x = rng.standard_normal((m['b'], m['s'], m['d'])).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    return jax.tree.map(np.asarray, p), x, ct


def _jax_moe():
    m = MOE
    p, x, ct = _moe_inputs()

    def loss(p, x):
        out, aux = jax_moe.moe_mlp(x, p, m['e'], m['k'], m['cf'])
        return jnp.sum(out * ct) + MOE_AUX_W * aux, (out, aux)

    (_, (out, aux)), (g_p, g_x) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    return (np.asarray(out), float(aux), jax.tree.map(np.asarray, g_p),
            np.asarray(g_x))


_BODY = '''
import numpy as np
from skypilot_tpu_torch.models import moe as moe_lib
from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.parallel import pipeline as pipe_lib
from skypilot_tpu_torch.parallel import ring_attention as ring_lib

def t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32)).requires_grad_(grad)

# pipe=4: the toy pipeline, one stage a rank.
pm = mesh_lib.build_mesh(mesh_lib.MeshSpec(fsdp=1, pipe=4), device='cpu')
p = pm.axis_index('pipe')
ws, x, ct = inputs['toy']
per = ws.shape[0] // 4
w = t(ws[p * per:(p + 1) * per], True)
tx = t(x, True)

def stage(stage_ws, x_mb):
    y = x_mb
    for wl in stage_ws.unbind(0):
        y = torch.tanh(y @ wl)
    return y, (y ** 2).mean()

outputs, aux = pipe_lib.pipeline_apply(stage, w, tx, num_stages=4, mesh=pm)
aux_all = collectives.reduce_from(aux, pm, 'pipe')
part = ((outputs * t(ct)).sum() if p == 3 else outputs.sum() * 0.0)
g_w, g_x = torch.autograd.grad(part + inputs['aux_w'] * aux_all, [w, tx])
out['pipe'] = {'stage': p, 'outputs': outputs.detach().numpy(),
               'aux': float(aux_all), 'g_w': g_w.numpy(),
               'g_x': g_x.numpy()}

# seq=4: ring attention on this rank's block of positions.
sm = mesh_lib.build_mesh(mesh_lib.MeshSpec(fsdp=1, seq=4), device='cpu')
si = sm.axis_index('seq')
q, k, v, rct = inputs['ring']
blk = q.shape[2] // 4
cut = lambda a: a[:, :, si * blk:(si + 1) * blk]
out['ring'] = {'block': si}
for causal in (True, False):
    tq, tk, tv = (t(cut(a), True) for a in (q, k, v))
    o = ring_lib.ring_attention(tq, tk, tv, sm, causal=causal)
    grads = torch.autograd.grad((o * t(cut(rct))).sum(), [tq, tk, tv])
    out['ring'][causal] = [o.detach().numpy()] + [g.numpy() for g in grads]

# data=2,expert=2 and seq=2,expert=2: moe_mlp, capacity binding.
m = inputs['moe_cfg']
mp, mx, mct = inputs['moe']
for name, spec in (('data', dict(fsdp=1, data=2, expert=2)),
                   ('seq', dict(fsdp=1, seq=2, expert=2))):
    em = mesh_lib.build_mesh(mesh_lib.MeshSpec(**spec), device='cpu')
    ei = em.axis_index('expert')
    e_loc = m['e'] // 2
    if name == 'data':
        rows = slice(em.axis_index('data') * 2, em.axis_index('data') * 2 + 2)
        cols = slice(None)
        token_axis = 'data'
    else:
        rows = slice(None)
        cols = slice(em.axis_index('seq') * 4, em.axis_index('seq') * 4 + 4)
        token_axis = 'seq'
    params = {'router': t(mp['router'], True)}
    for key in ('we_gate', 'we_up', 'we_down'):
        params[key] = t(mp[key][ei * e_loc:(ei + 1) * e_loc], True)
    xin = t(mx[rows, cols], True)
    y, a = moe_lib.moe_mlp(xin, params, m['e'], m['k'], m['cf'], mesh=em)
    leaves = [params[k] for k in sorted(params)] + [xin]
    grads = torch.autograd.grad(
        (y * t(mct[rows, cols])).sum() + inputs['moe_aux_w'] * a, leaves)
    # The weights' gradients are this rank's tokens' share: summed over
    # the token axis, as the trainer sums them.
    summed = [collectives.psum(g, em, token_axis) for g in grads[:-1]]
    out['moe_' + name] = {
        'expert': ei, 'rows': (rows.start, rows.stop),
        'cols': (cols.start, cols.stop), 'out': y.detach().numpy(),
        'aux': float(a), 'grads': dict(zip(sorted(params),
                                           [g.numpy() for g in summed])),
        'g_x': grads[-1].numpy()}
'''


@pytest.fixture(scope='module')
def gang(tmp_path_factory):
    p, x, ct = _moe_inputs()
    inputs = {'toy': _toy_inputs(), 'aux_w': AUX_W, 'ring': _ring_inputs(),
              'moe_cfg': MOE, 'moe': (p, x, ct), 'moe_aux_w': MOE_AUX_W}
    return run_gang(tmp_path_factory.mktemp('axes'), 4, _BODY,
                    spec={'fsdp': 4}, inputs=inputs)


def test_pipeline_over_pipe_ranks_matches_jax(gang):
    want_out, want_aux, want_gws, want_gx = _jax_toy(4)
    per = PIPE_LAYERS // 4
    for r in gang:
        got = r['pipe']
        s = got['stage']
        _close(got['aux'], want_aux, VAL_TOL)
        _close(got['g_w'], want_gws[s * per:(s + 1) * per], GRAD_TOL)
        if s == 3:
            _close(got['outputs'], want_out, VAL_TOL)
        else:
            assert not got['outputs'].any()  # only the last stage's are real
        if s == 0:
            _close(got['g_x'], want_gx, GRAD_TOL)
        else:
            assert not got['g_x'].any()  # the microbatches enter at stage 0


@pytest.mark.parametrize('causal', [True, False])
def test_ring_attention_over_seq_ranks_matches_jax(gang, causal):
    want = _jax_ring(causal)
    blk = RING['s'] // 4
    for r in gang:
        i = r['ring']['block']
        for got, w in zip(r['ring'][causal], want):
            _close(got, w[:, :, i * blk:(i + 1) * blk], GRAD_TOL)


@pytest.mark.parametrize('name', ['data', 'seq'])
def test_moe_on_an_expert_mesh_matches_jax(gang, name):
    """The capacity binds (JAX drops choices at this factor), and every
    rank's output, aux and gradients equal JAX's on the global batch:
    the same tokens dropped, each expert's gradient on its rank."""
    want_out, want_aux, want_g, want_gx = _jax_moe()
    m = MOE
    n = m['b'] * m['s']
    cap = jax_moe.expert_capacity(n, m['e'], m['k'], m['cf'])
    assert cap * m['e'] < n * m['k']  # fewer slots than choices: drops
    e_loc = m['e'] // 2
    for r in gang:
        got = r['moe_' + name]
        rows, cols = slice(*got['rows']), slice(*got['cols'])
        _close(got['out'], want_out[rows, cols], VAL_TOL)
        _close(got['aux'], want_aux, VAL_TOL)
        _close(got['g_x'], want_gx[rows, cols], GRAD_TOL)
        _close(got['grads']['router'], want_g['router'], GRAD_TOL)
        ei = got['expert']
        for key in ('we_gate', 'we_up', 'we_down'):
            _close(got['grads'][key],
                   want_g[key][ei * e_loc:(ei + 1) * e_loc], GRAD_TOL)
