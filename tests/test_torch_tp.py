"""Tensor-parallel serving of the port against the JAX package, on the CPU.

The port runs one process per rank: ``run_gang`` starts the ranks as
subprocesses joined by gloo over a file rendezvous under ``tmp_path``,
each with a hard timeout and its process group killed at the end. The
JAX side runs in this process on a ``tensor=2`` mesh of the virtual CPU
devices (``tests/conftest.py``). Counterparts of JAX's
``test_engine.py`` tensor-parallel tests: tp 2 greedy (:137), int8
weights (:187), born sharded (:210), int8 KV (:353).

Float32 TINY gives exact greedy tokens; the int8 products are held to
JAX's within one bf16 ulp (the float32 sums are reduced before the one
rounding, as GSPMD reduces them).
"""
import dataclasses
import os
import pickle
import signal
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from skypilot_tpu.models import engine as jax_engine
from skypilot_tpu.models import generate as jax_gen
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.models import quantization as jax_quant
from skypilot_tpu.parallel import mesh as jax_mesh
from skypilot_tpu_torch.models import engine as port_engine
from skypilot_tpu_torch.models import llama as port_llama
from skypilot_tpu_torch.models import quantization as port_quant
from skypilot_tpu_torch.parallel import sharding as port_sharding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GANG_TIMEOUT_S = 240
MAX_LEN = 64
LOGIT_TOL = 1e-5
JAX_CFG = dataclasses.replace(jax_llama.TINY, dtype=jnp.float32)
ROWS = [[5, 6, 7], [8, 9, 10, 11, 12], [13, 14]]  # JAX test_engine.py:148
Q8_ROW = [7, 8, 9, 10]                             # JAX test_engine.py:200
KV8_ROW = [3, 4, 5, 6]                             # JAX test_engine.py:363
SAMPLED = [([4, 5, 6], 8, 1.0, 20, 1.0), ([7, 8, 9, 10], 8, 0.8, 0, 0.9)]

_PRELUDE = '''
import datetime, os, pickle, sys
sys.path.insert(0, {repo!r})
import torch
import torch.distributed as dist
rank, world, init, tmp = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
dist.init_process_group('gloo', init_method=init, world_size=world,
                        rank=rank,
                        timeout=datetime.timedelta(seconds=120))
from skypilot_tpu_torch.parallel import mesh as mesh_lib
mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(**{spec!r}), device='cpu')
with open(os.path.join(tmp, 'inputs.pkl'), 'rb') as f:
    inputs = pickle.load(f)
out = {{}}
'''
_EPILOGUE = '''
torch.save(out, os.path.join(tmp, f'out.{rank}.pt'))
dist.destroy_process_group()
sys.stdout.flush()
sys.stderr.flush()
os._exit(0)  # no interpreter teardown of the process groups' threads
'''


def run_gang(tmp_path, world, body, spec=None, inputs=None, env=None,
             timeout=GANG_TIMEOUT_S):
    """Run ``body`` on ``world`` ranks (gloo, CPU); returns each rank's
    ``out`` dict. The body sees ``rank``, ``world``, ``mesh`` (``spec``,
    default tensor=world) and ``inputs``."""
    spec = spec or {'fsdp': 1, 'tensor': world}
    tmp = str(tmp_path)
    with open(os.path.join(tmp, 'inputs.pkl'), 'wb') as f:
        pickle.dump(inputs or {}, f)
    script = os.path.join(tmp, 'rank.py')
    with open(script, 'w', encoding='utf-8') as f:
        f.write(_PRELUDE.format(repo=REPO, spec=spec)
                + textwrap.dedent(body) + _EPILOGUE)
    init = f'file://{tmp}/rendezvous'
    # A rank's tiny products gain nothing from a thread per core, and
    # gangs of several test files at once would oversubscribe the cores.
    threads = str(max(1, (os.cpu_count() or 1) // (2 * world)))
    child_env = dict(os.environ, CUDA_VISIBLE_DEVICES='',
                     GLOO_SOCKET_IFNAME='lo', OMP_NUM_THREADS=threads,
                     **(env or {}))
    logs, procs = [], []
    try:
        for rank in range(world):
            log = open(os.path.join(tmp, f'rank{rank}.log'), 'wb')
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, script, str(rank), str(world), init, tmp],
                stdout=log, stderr=subprocess.STDOUT, env=child_env,
                start_new_session=True))
        deadline = time.monotonic() + timeout
        for proc in procs:
            proc.wait(max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        for log in logs:
            log.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        tails = '\n'.join(
            f'--- rank {r} ({c}):\n'
            + open(os.path.join(tmp, f'rank{r}.log'),
                   encoding='utf-8', errors='replace').read()[-3000:]
            for r, c in enumerate(codes))
        raise AssertionError(f'gang failed {codes}\n{tails}')
    # The ranks' own outputs, numpy arrays among them.
    return [torch.load(os.path.join(tmp, f'out.{r}.pt'), weights_only=False)
            for r in range(world)]


def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)
                                             if a.dtype == jnp.bfloat16
                                             else a), tree)


def _jax_mesh():
    return jax_mesh.build_mesh(jax_mesh.MeshSpec(fsdp=1, tensor=2),
                               devices=jax.devices()[:2])


# -- one gang computes every port-side figure of this file ------------------

_BODY = '''
import dataclasses
import numpy as np
from skypilot_tpu_torch.models import engine as engine_lib
from skypilot_tpu_torch.models import generate as gen_lib
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import quantization as quant_lib
from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.serve import llm_server, spmd

cfg = dataclasses.replace(llama.TINY, dtype=torch.float32)
full = llama.params_from_numpy(inputs['params'], cfg, 'cpu')
params = quant_lib.shard_params(full, cfg, mesh)

# forward_cached: a padded prefill, then two decode steps.
toks = torch.tensor(inputs['prefill'], dtype=torch.int32)
lens = torch.tensor(inputs['lens'], dtype=torch.int32)
cache = gen_lib.init_cache(cfg, 2, 32, device='cpu', mesh=mesh)
out['cache_heads'] = cache.k.shape[2]
logits, cache = gen_lib.forward_cached(params, toks, cache, cfg, lens,
                                       mesh=mesh)
steps = [logits]
for t in inputs['steps']:
    logits, cache = gen_lib.forward_cached(
        params, torch.tensor(t, dtype=torch.int32)[:, None], cache, cfg,
        torch.ones((2,), dtype=torch.int32), mesh=mesh)
    steps.append(logits)
out['logits'] = [s.numpy() for s in steps]

# int8 weights: the row-split product, reduced before the one rounding.
bcfg = llama.TINY
q_full = llama.params_from_numpy(inputs['q_params'], bcfg, 'cpu')
q_local = quant_lib.shard_params(q_full, bcfg, mesh)
x = torch.from_numpy(inputs['mlp_in']).to(torch.bfloat16)
f_local = x.shape[-1] // world
x_local = x[..., rank * f_local:(rank + 1) * f_local]
w = {k: v[0] for k, v in q_local['layers']['w_down'].items()}
out['mm_int8'] = quant_lib.mm(
    x_local, w, 'bsf,fd->bsd',
    reduce=lambda t: collectives.psum(t, mesh)).float().numpy()

# Sharded init and quantization against slices of the whole tree.
gen = torch.Generator(); gen.manual_seed(0)
sharded = llama.init_params_sharded(bcfg, gen, mesh, device='cpu')
out['init_sharded'] = sharded
out['quant_sharded'] = quant_lib.quantize_params_sharded(sharded, bcfg, mesh)

# The engine, every rank in lockstep (serve/spmd.py); every sampling
# call of every rank is recorded.
draws = []
plain_sample = engine_lib.sampling.sample
profiled_sample = engine_lib._sample
def record(fn):
    def wrapped(*a, **k):
        t = fn(*a, **k)
        draws.append(t.clone())
        return t
    return wrapped
engine_lib.sampling.sample = record(plain_sample)
engine_lib._sample = record(profiled_sample)

def engine_run(name, tree=full, **kw):
    eng = spmd.SpmdEngine(tree, cfg, slots=4, max_len=64, chunk_steps=4,
                          mesh=mesh, device='cpu', **kw)
    wq = eng.params['layers']['wq']
    out[name + '_local_heads'] = (wq['q8'] if isinstance(wq, dict)
                                  else wq).shape[2]
    if rank == 0:
        futs = [eng.submit(r, n) for r, n in inputs[name]]
        futs += [eng.submit(r, n, temperature=t, top_k=k, top_p=p)
                 for r, n, t, k, p in inputs.get(name + '_sampled', [])]
        out[name] = [f.result(timeout=120) for f in futs]
        eng.stop()
    else:
        eng.start()
        eng._thread.join()
    out[name + '_draws'] = [d.numpy() for d in draws]
    draws.clear()

engine_run('greedy')
engine_run('q8', llama.params_from_numpy(inputs['q_params32'], cfg, 'cpu'))
engine_run('kv8', kv_quantize=True)

# Born sharded: the replica initialises and quantizes its slices.
server = llm_server.LlmServer('tiny', max_len=64, tp=2, quantize='int8',
                              device='cpu')
out['born_q8_shape'] = tuple(server.params['layers']['wq']['q8'].shape)
out['same_tree'] = server.params is server.engine.params
out['health_tp'] = (server.health_snapshot()['tp'],
                    server.health_snapshot()['tp_backend'])
if rank == 0:
    out['born'] = server.engine.submit([5, 6, 7], 4).result(timeout=120)
    server.stop()
else:
    spmd.follower_main(server)
'''


@pytest.fixture(scope='module')
def jax_params():
    return jax_llama.init_params(jax.random.PRNGKey(0), JAX_CFG)


@pytest.fixture(scope='module')
def jax_bf16_params():
    return jax_llama.init_params(jax.random.PRNGKey(0), jax_llama.TINY)


@pytest.fixture(scope='module')
def gang(tmp_path_factory, jax_params, jax_bf16_params):
    rng = np.random.default_rng(0)
    inputs = {
        'params': _numpy_tree(jax_params),
        'q_params': _numpy_tree(jax_quant.quantize_params(jax_bf16_params)),
        'prefill': [[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 0, 0]],
        'lens': [6, 4],
        'steps': [[11, 12], [13, 14]],
        'mlp_in': rng.standard_normal((2, 3, jax_llama.TINY.d_ff)).astype(
            np.float32),
        'greedy': [(r, 6) for r in ROWS],
        'greedy_sampled': SAMPLED,
        'q_params32': _numpy_tree(jax_quant.quantize_params(jax_params)),
        'q8': [(Q8_ROW, 6)],
        'kv8': [(KV8_ROW, 5)],
    }
    outs = run_gang(tmp_path_factory.mktemp('tp_gang'), 2, _BODY,
                    inputs=inputs)
    return inputs, outs


# -- forward_cached ----------------------------------------------------------


def test_forward_cached_logits_match_jax_sharded(gang, jax_params):
    """Port tp 2 logits (prefill, then two decode steps) within 1e-5 of
    JAX's forward_cached over weights placed on a tensor=2 mesh."""
    inputs, outs = gang
    mesh = _jax_mesh()
    params = jax_quant.shard_params(jax_params, JAX_CFG, mesh)
    cache = jax_gen.init_cache(JAX_CFG, 2, 32)
    logits, cache = jax_gen.forward_cached(
        params, jnp.asarray(inputs['prefill'], jnp.int32), cache, JAX_CFG,
        row_lens=jnp.asarray(inputs['lens'], jnp.int32))
    want = [np.asarray(logits)]
    for t in inputs['steps']:
        # Per-row lengths after a padded prefill: ones, not the uniform
        # path (as generate's decode passes them).
        logits, cache = jax_gen.forward_cached(
            params, jnp.asarray(t, jnp.int32)[:, None], cache, JAX_CFG,
            row_lens=jnp.ones((2,), jnp.int32))
        want.append(np.asarray(logits))
    for out in outs:
        assert out['cache_heads'] == JAX_CFG.n_kv_heads // 2
        for got, ref in zip(out['logits'], want):
            np.testing.assert_allclose(got, ref, atol=LOGIT_TOL,
                                       rtol=LOGIT_TOL)
    # Every rank holds the same all-gathered logits, bit for bit.
    for a, b in zip(outs[0]['logits'], outs[1]['logits']):
        np.testing.assert_array_equal(a, b)


def test_int8_row_split_reduces_before_rounding(gang, jax_bf16_params):
    """The row-split int8 product (w_down) is within one bf16 ulp of JAX's
    sharded product: the float32 sums are reduced before the scale and
    the one rounding."""
    inputs, outs = gang
    mesh = _jax_mesh()
    q = jax_quant.quantize_params(jax_bf16_params)
    w = {k: v[0] for k, v in q['layers']['w_down'].items()}
    w = {'q8': jax.device_put(w['q8'], NamedSharding(mesh, P('tensor'))),
         's': jax.device_put(w['s'], NamedSharding(mesh, P()))}
    x = jax.device_put(jnp.asarray(inputs['mlp_in'], jnp.bfloat16),
                       NamedSharding(mesh, P(None, None, 'tensor')))
    # skylint: allow-jit(the reference's sharded product, a test oracle)
    want = np.asarray(jax.jit(lambda x_, w_: jax_quant.mm(
        x_, w_, 'bsf,fd->bsd'))(x, w).astype(jnp.float32))
    ulp = np.abs(np.asarray(jnp.asarray(want, jnp.bfloat16)
                            .astype(jnp.float32)))
    ulp = np.maximum(np.spacing(ulp.astype(np.float32)) * 2 ** 16,
                     np.finfo(np.float32).tiny)
    for out in outs:
        diff = np.abs(out['mm_int8'] - want)
        assert np.all(diff <= ulp), float(np.max(diff / ulp))
    np.testing.assert_array_equal(outs[0]['mm_int8'], outs[1]['mm_int8'])


def _assemble(parts, logical):
    """The whole leaf from the ranks' slices: concatenated along the dim
    sharded over ``tensor``, else every rank's copy must be the whole."""
    spec = port_sharding.ShardingRules().mesh_axes(logical)
    if 'tensor' not in spec:
        for part in parts[1:]:
            assert torch.equal(part, parts[0])
        return parts[0]
    return torch.cat(parts, dim=spec.index('tensor'))


def _assert_slices_of(whole, parts, logical):
    if isinstance(whole, dict):
        for k in whole:
            _assert_slices_of(whole[k], [p[k] for p in parts],
                              logical[k])
        return
    got = _assemble(parts, logical)
    assert got.dtype == whole.dtype and torch.equal(got, whole)


def test_sharded_init_and_quantization_are_slices_of_the_whole(gang):
    """``init_params_sharded`` and ``quantize_params_sharded`` on 2 ranks
    concatenate to ``init_params`` and ``quantize_params`` of the same
    seed bit for bit (bf16 TINY): a tp 1 and a tp 2 replica serve the
    same weights."""
    _, outs = gang
    cfg = port_llama.TINY
    gen = torch.Generator()
    gen.manual_seed(0)
    whole = port_llama.init_params(cfg, gen, 'cpu')
    _assert_slices_of(whole, [o['init_sharded'] for o in outs],
                      port_llama.param_logical_axes(cfg))
    q = port_quant.quantize_params(whole)
    _assert_slices_of(q, [o['quant_sharded'] for o in outs],
                      port_quant.logical_axes_for(q, cfg))


# -- the engine --------------------------------------------------------------


def _jax_engine(params, **kw):
    eng = jax_engine.ContinuousEngine(params, JAX_CFG, slots=4,
                                      max_len=MAX_LEN, chunk_steps=4,
                                      mesh=_jax_mesh(), **kw)
    eng.start()
    return eng


def test_engine_tp2_greedy_matches_jax_tensor2_and_port_tp1(gang,
                                                            jax_params):
    """JAX test_engine.py:137: tp 2 greedy streams equal JAX's tensor=2
    engine and the port's own single-device engine."""
    inputs, outs = gang
    jeng = _jax_engine(jax_params)
    try:
        want = [f.result(timeout=300) for f in [jeng.submit(r, n)
                                                for r, n in inputs['greedy']]]
    finally:
        jeng.stop()
    cfg = dataclasses.replace(port_llama.TINY, dtype=torch.float32)
    eng = port_engine.ContinuousEngine(
        port_llama.params_from_numpy(inputs['params'], cfg, 'cpu'), cfg,
        slots=4, max_len=MAX_LEN, chunk_steps=4, device='cpu')
    try:
        tp1 = [f.result(timeout=120) for f in [eng.submit(r, n)
                                               for r, n in inputs['greedy']]]
    finally:
        eng.stop()
    got = outs[0]['greedy'][:len(ROWS)]
    assert got == want == tp1
    assert outs[0]['greedy_local_heads'] == JAX_CFG.n_heads // 2


def test_engine_tp2_int8_weights_match_jax(gang, jax_params):
    """JAX test_engine.py:187: an int8 weight tree under tensor=2 (codes
    split like the weight, scales with their output channels) gives JAX's
    tensor=2 engine's greedy tokens."""
    inputs, outs = gang
    jeng = _jax_engine(jax_quant.quantize_params(jax_params))
    try:
        want = [jeng.submit(r, n).result(timeout=300)
                for r, n in inputs['q8']]
    finally:
        jeng.stop()
    assert outs[0]['q8'] == want


def test_ranks_sample_the_same_token_at_every_step(gang):
    """Every rank samples the same all-gathered logits with the same
    generator state: each sampling call (prefill firsts and every chunk
    step, greedy and sampled rows) returns the same tokens on both."""
    inputs, outs = gang
    for name in ('greedy', 'q8', 'kv8'):
        a, b = outs[0][name + '_draws'], outs[1][name + '_draws']
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    sampled = outs[0]['greedy'][len(ROWS):]
    assert [len(s) for s in sampled] == [n for _, n, *_ in SAMPLED]
    assert all(0 <= t < JAX_CFG.vocab_size for s in sampled for t in s)


def test_engine_kv_int8_tp2_matches_jax(gang, jax_params):
    """JAX test_engine.py:353: int8 KV under tensor parallelism, the scale
    planes sharded with their kv heads."""
    inputs, outs = gang
    jeng = _jax_engine(jax_params, kv_quantize=True)
    try:
        want = [jeng.submit(r, n).result(timeout=300)
                for r, n in inputs['kv8']]
    finally:
        jeng.stop()
    assert outs[0]['kv8'] == want


def test_server_tp_quantized_params_born_sharded(gang):
    """JAX test_engine.py:210: ``LlmServer(tp=2, quantize='int8')``
    initialises and quantizes its slices (each rank holds half of wq's
    heads), both paths serve the same resident tree, and it generates."""
    _, outs = gang
    cfg = port_llama.TINY
    for out in outs:
        assert out['born_q8_shape'] == (cfg.n_layers, cfg.d_model,
                                        cfg.n_heads // 2, cfg.head_dim)
        assert out['same_tree'] is True
        assert out['health_tp'] == (2, 'gloo')
    assert len(outs[0]['born']) == 4
