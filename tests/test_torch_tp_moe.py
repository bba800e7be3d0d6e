"""An MoE model on a tensor-parallel replica of the port, against the JAX
package, on the CPU.

One gang of two gloo ranks (``test_torch_tp.run_gang``) runs every
port-side engine of this file: ``serve/spmd.SpmdEngine`` over float32
MOE_TINY weights carried over from JAX. The experts split on ``mlp`` over
``tensor`` (``moe.moe_logical_axes``) and ``moe_mlp(mesh=)`` sums
``we_down``'s partial products over the ranks; the tokens are whole on
every rank, so the capacity, JAX's choice-major drop order and the
engine's routing mask are the one device's. The JAX side runs its engine
in this process on a ``tensor=2`` mesh of the virtual CPU devices.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from skypilot_tpu.models import engine as jax_engine
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.parallel import mesh as jax_mesh
from test_torch_tp import _numpy_tree, run_gang

MAX_LEN = 64


def _cfg(capacity_factor):
    return dataclasses.replace(jax_llama.MOE_TINY, dtype=jnp.float32,
                               expert_capacity_factor=capacity_factor)


def _binding_traffic(seed=3, n=24):
    """test_torch_moe.py's: prompts of 2-13 tokens, max_new 2-9; with
    chunks of 4 steps most requests finish mid-chunk."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, int(rng.integers(2, 14))).tolist(),
             int(rng.integers(2, 10))) for _ in range(n)]


TRAFFIC = _binding_traffic()

_BODY = '''
import dataclasses
from unittest import mock
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import quantization as quant_lib
from skypilot_tpu_torch.serve import llm_server, spmd

def engine_run(name, params, cfg, reqs, **kw):
    eng = spmd.SpmdEngine(params, cfg, slots=16, max_len=64, chunk_steps=4,
                          mesh=mesh, device='cpu', **kw)
    moe = eng.params['layers']['moe']
    out[name + '_experts'] = {k: tuple(v.shape) for k, v in moe.items()}
    out[name + '_depth'] = eng.pipeline_depth
    if rank == 0:
        # Every request queued before the loop's first arrival broadcast:
        # the first admission sees them all, as JAX's test_torch_moe runs.
        with mock.patch.object(spmd.SpmdEngine, 'start', lambda self: None):
            futs = [eng.submit(r, n) for r, n in reqs]
        spmd.SpmdEngine.start(eng)
        out[name] = [f.result(timeout=120) for f in futs]
        eng.stop()
    else:
        eng.start()
        eng._thread.join()
    out[name + '_state'] = llm_server._rank_engine_state(eng)

tight = dataclasses.replace(llama.MOE_TINY, dtype=torch.float32,
                            expert_capacity_factor=1.0)
params = llama.params_from_numpy(inputs['tight'], tight, 'cpu')
engine_run('slot', params, tight, inputs['traffic'])
engine_run('paged', params, tight, inputs['traffic'], kv_layout='paged')

# The replica born sharded and int8-quantized: the experts stay in their
# dtype, the router float32, each rank holding half of every expert.
server = llm_server.LlmServer('moe-tiny', max_len=64, tp=2,
                              quantize='int8', device='cpu')
moe = server.params['layers']['moe']
out['q8_experts'] = {k: (tuple(v.shape), str(v.dtype))
                     for k, v in moe.items()}
out['q8_wq'] = quant_lib.is_quantized(server.params['layers']['wq'])
if rank == 0:
    out['q8'] = server.engine.submit([5, 6, 7, 8], 6).result(timeout=120)
    server.stop()
else:
    spmd.follower_main(server)
'''


@pytest.fixture(scope='module')
def tight():
    cfg = _cfg(1.0)
    return cfg, jax_llama.init_params(jax.random.PRNGKey(7), cfg)


@pytest.fixture(scope='module')
def gang(tmp_path_factory, tight):
    _, params = tight
    return run_gang(tmp_path_factory.mktemp('tp_moe'), 2, _BODY,
                    inputs={'tight': _numpy_tree(params),
                            'traffic': TRAFFIC})


def _jax_run(cfg, params, **kw):
    mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec(fsdp=1, tensor=2),
                               devices=jax.devices()[:2])
    eng = jax_engine.ContinuousEngine(params, cfg, slots=16,
                                      max_len=MAX_LEN, chunk_steps=4,
                                      mesh=mesh, **kw)
    with mock.patch.object(type(eng), 'start', lambda self: None):
        futs = [eng.submit(r, n) for r, n in TRAFFIC]  # queued, then run
    type(eng).start(eng)
    try:
        return [f.result(timeout=300) for f in futs]
    finally:
        eng.stop()


@pytest.mark.parametrize('layout', ['slot', 'paged'])
def test_moe_engine_under_binding_capacity_matches_jax_tensor2(
        gang, tight, layout):
    """24 requests through 16 slots at capacity factor 1.0 (capacity 8
    for 32 choices over 4 experts binds at every decode step): the
    port's tp 2 gang equals JAX's engine on tensor=2 token for token, and
    both ranks dispatch serially and count the same."""
    cfg, params = tight
    want = _jax_run(cfg, params, kv_layout=layout)
    assert gang[0][layout] == want
    assert gang[0][layout + '_state'] == gang[1][layout + '_state']
    for out in gang:
        assert out[layout + '_depth'] == 0


def test_each_rank_holds_half_of_every_expert(gang, tight):
    """``moe_logical_axes``: we_gate and we_up split their mlp columns,
    we_down its mlp rows, over tensor; the router is whole."""
    cfg, _ = tight
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    want = {'router': (cfg.n_layers, d, e),
            'we_gate': (cfg.n_layers, e, d, f // 2),
            'we_up': (cfg.n_layers, e, d, f // 2),
            'we_down': (cfg.n_layers, e, f // 2, d)}
    for out in gang:
        assert out['slot_experts'] == want


def test_int8_replica_keeps_experts_and_router_under_tp(gang):
    """``--quantize int8 --tp 2`` on an MoE preset, born sharded: the
    attention and head weights are int8, the experts keep the model's
    dtype and the router float32, each rank holding half of each
    expert; the replica answers."""
    for out in gang:
        shapes = out['q8_experts']
        assert shapes['router'][1] == 'torch.float32'
        for name in ('we_gate', 'we_up', 'we_down'):
            assert shapes[name][1] == 'torch.bfloat16'
        assert shapes['we_gate'][0][-1] == jax_llama.MOE_TINY.d_ff // 2
        assert out['q8_wq']
    assert len(gang[0]['q8']) == 6
    assert all(0 <= t < jax_llama.MOE_TINY.vocab_size for t in gang[0]['q8'])
