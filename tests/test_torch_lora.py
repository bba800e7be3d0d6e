"""Parity of the port's LoRA (``models/lora.py``, LoRA in ``Trainer``,
``train.run --lora-*``, LoRA checkpoints) with the JAX package, on the
CPU. Counterparts of ``tests/test_lora.py``, all but the sharded FSDP
step, which waits for the mesh.

* ``merge`` on the same A and B as JAX's: fp32 within 1e-6, bf16 within
  one ulp of the merged weight.
* The port's ``Trainer`` with LoRA against JAX's, 3 steps on fp32 TINY,
  Adafactor and AdamW, accum_steps 1 and 2: losses within 1e-5
  relative, the base bit for bit unchanged. Adapters in float32 within
  2e-5 (the full finetune test's tolerance; measured 7e-7); in bfloat16,
  the dtype both trainers give them, at most 1% of the values further
  from JAX's than 2e-5 or one bf16 ulp (whichever is larger) and none by
  more than 5% of the learning rate (measured: 0.2% of the values, by up
  to 0.6% of it, with AdamW; Adafactor within 2.4e-7): float32 gradient
  sums taken in another order round to bf16 across a boundary now and
  then, and AdamW's update lr * m / sqrt(v) carries such a flip into a
  fraction of lr.
* ``train/optim.py`` against optax on adapter-shaped leaves, whose
  second-largest dim is below optax's factoring minimum of 128, so
  Adafactor takes its unfactored branch on many-dimensional leaves; and
  in bfloat16, where optax rounds its scalars (learning rate, Adam's
  decays, bias corrections, weight decay) to the leaf's dtype.
* LoRA checkpoints cross between the packages both ways.

Inputs are made with numpy from a seed and handed to both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from skypilot_tpu.ckpt import manager as jax_manager
from skypilot_tpu.ckpt import snapshot as jax_snapshot
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.models import lora as jax_lora
from skypilot_tpu.train import trainer as jax_trainer
from skypilot_tpu_torch.ckpt import snapshot as port_snapshot
from skypilot_tpu_torch.ckpt.manager import AsyncCheckpointManager
from skypilot_tpu_torch.models import llama as port_llama
from skypilot_tpu_torch.models import lora as port_lora
from skypilot_tpu_torch.train import optim as port_optim
from skypilot_tpu_torch.train import run as port_run
from skypilot_tpu_torch.train import trainer as port_trainer

LOSS_RTOL = 1e-5
ADAPTER_TOL = 2e-5
# bf16 adapters: the share of the learning rate by which an update may
# differ where a gradient rounded to bf16 across a boundary (see above).
BF16_LR_SHARE = 0.05
TINY32 = dataclasses.replace(jax_llama.TINY, dtype=jnp.float32)


def _port_cfg(cfg, dtype=torch.float32):
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg) if f.name != 'dtype'}
    return port_llama.LlamaConfig(**fields, dtype=dtype)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _sorted_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    return [tree]


def _to_numpy(t):
    """A copy of a port tensor as numpy (bf16 through float32, exact)."""
    t = t.detach()
    return np.array((t.float() if t.dtype == torch.bfloat16 else t).numpy())


def _bumped(adapters, seed):
    """JAX adapters with B made nonzero (from numpy), so deltas are real."""
    rng = np.random.default_rng(seed)
    return {t: {'a': ab['a'],
                'b': jnp.asarray(rng.standard_normal(ab['b'].shape) * 0.02,
                                 ab['b'].dtype)}
            for t, ab in adapters.items()}


# -- the adapter tree ----------------------------------------------------------


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_merge_matches_jax(dtype):
    jcfg = dataclasses.replace(jax_llama.TINY, dtype=getattr(jnp, dtype))
    params = jax_llama.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = jax_lora.LoraConfig(rank=2, alpha=8.0,
                              targets=('wq', 'wo', 'w_down'))
    adapters = _bumped(jax_lora.init_lora(jax.random.PRNGKey(1), params,
                                          cfg, dtype=getattr(jnp, dtype)), 3)
    want = jax_lora.merge(params, adapters, cfg)
    pcfg = port_lora.LoraConfig(rank=2, alpha=8.0,
                                targets=('wq', 'wo', 'w_down'))
    pparams = port_llama.params_from_numpy(
        _np(params), _port_cfg(jcfg, getattr(torch, dtype)), 'cpu')
    got = port_lora.merge(pparams, port_lora.lora_from_numpy(
        _np(adapters), 'cpu'), pcfg)
    assert pcfg.scale == cfg.scale == 4.0
    for name in ('wq', 'wo', 'w_down'):
        g = got['layers'][name]
        w = np.asarray(want['layers'][name], np.float32)
        assert g.dtype == pparams['layers'][name].dtype
        if dtype == 'float32':
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
        else:
            ulp = np.abs(np.asarray(want['layers'][name]).astype(
                np.float32)) * 2.0 ** -7 + 1e-38
            assert np.all(np.abs(_to_numpy(g) - w) <= ulp), name
    # Non-targets are the same tensors.
    assert got['layers']['wk'] is pparams['layers']['wk']
    assert got['embed'] is pparams['embed']


def test_init_delta_is_zero_so_merged_equals_base():
    cfg = _port_cfg(TINY32)
    params = port_llama.init_params(cfg, torch.Generator().manual_seed(0),
                                    'cpu')
    lcfg = port_lora.LoraConfig(rank=4)
    adapters = port_lora.init_lora(torch.Generator().manual_seed(1), params,
                                   lcfg, device='cpu')
    assert all(not torch.any(ab['b']) for ab in adapters.values())
    assert all(torch.any(ab['a']) for ab in adapters.values())
    tokens = torch.ones((2, 16), dtype=torch.int32)
    base = port_llama.forward(params, tokens, cfg)
    merged = port_llama.forward(port_lora.merge(params, adapters, lcfg),
                                tokens, cfg)
    assert torch.equal(base, merged)


def test_adapter_shapes_dtypes_and_count_match_jax():
    params = jax_llama.init_params(jax.random.PRNGKey(0), jax_llama.TINY)
    for targets in (jax_lora.DEFAULT_TARGETS, jax_lora.ALL_TARGETS):
        want = jax_lora.init_lora(jax.random.PRNGKey(1), params,
                                  jax_lora.LoraConfig(rank=4,
                                                      targets=targets))
        pparams = port_llama.params_from_numpy(
            _np(params), _port_cfg(jax_llama.TINY, torch.bfloat16), 'cpu')
        got = port_lora.init_lora(torch.Generator().manual_seed(1), pparams,
                                  port_lora.LoraConfig(rank=4,
                                                       targets=targets),
                                  device='cpu')
        assert list(got) == list(want)
        for t in want:
            for k in ('a', 'b'):
                assert tuple(got[t][k].shape) == want[t][k].shape, (t, k)
                assert got[t][k].dtype == torch.bfloat16
        assert port_lora.param_count(got) == jax_lora.param_count(want)
    base = sum(p.numel() for p in _sorted_leaves(pparams))
    assert port_lora.param_count(port_lora.init_lora(
        torch.Generator().manual_seed(1), pparams,
        port_lora.LoraConfig(rank=4), device='cpu')) < base * 0.2
    # The recipe's adapters at BENCH_1B: 18 layers x 229,376 values.
    bench = {'layers': {
        'wq': torch.empty((18, 2048, 16, 128), device='meta'),
        'wk': torch.empty((18, 2048, 8, 128), device='meta'),
        'wv': torch.empty((18, 2048, 8, 128), device='meta'),
        'wo': torch.empty((18, 16, 128, 2048), device='meta')}}
    shapes = {t: (port_lora._split_shape(tuple(w.shape), t))  # noqa: SLF001
              for t, w in bench['layers'].items()}
    count = sum(n * (int(np.prod(i)) * 16 + 16 * int(np.prod(o)))
                for n, i, o in shapes.values())
    assert count == 4_128_768 == 18 * 229_376


def test_invalid_config_rejected_as_jax_rejects():
    for kw, match in ((dict(rank=0), 'rank must be positive'),
                      (dict(targets=('wq', 'nope')), 'Unknown LoRA targets')):
        with pytest.raises(ValueError, match=match):
            jax_lora.LoraConfig(**kw)
        with pytest.raises(ValueError, match=match):
            port_lora.LoraConfig(**kw)
    moe = jax_llama.init_params(jax.random.PRNGKey(0), jax_llama.MOE_TINY)
    with pytest.raises(ValueError, match='attention only'):
        jax_lora.init_lora(jax.random.PRNGKey(1), moe,
                           jax_lora.LoraConfig(targets=('w_gate',)))
    pmoe = jax.tree.map(lambda x: torch.from_numpy(np.asarray(x, np.float32)),
                        moe)
    with pytest.raises(ValueError, match='attention only'):
        port_lora.init_lora(torch.Generator(), pmoe,
                            port_lora.LoraConfig(targets=('w_gate',)),
                            device='cpu')
    # Attention targets exist in an MoE model.
    got = port_lora.init_lora(torch.Generator(), pmoe,
                              port_lora.LoraConfig(rank=2), device='cpu')
    assert sorted(got) == ['wk', 'wo', 'wq', 'wv']
    # The trainer refuses a LoRA target the model lacks, before training.
    trainer = port_trainer.Trainer(port_trainer.TrainerConfig(
        model=_port_cfg(TINY32), global_batch_size=2, seq_len=16,
        lora=port_lora.LoraConfig(targets=('wq',))), device='cpu')
    tree = _np(jax_llama.init_params(jax.random.PRNGKey(0), TINY32))
    del tree['layers']['wq']
    with pytest.raises(ValueError, match='attention only'):
        trainer.init_state_from_numpy(
            tree, lora={'wq': {'a': np.zeros((2, 64, 16), np.float32),
                               'b': np.zeros((2, 16, 4, 16), np.float32)}})


# -- the optimizer on adapter shapes ------------------------------------------

_ADAPTER_SHAPES = {'a_qkv': (2, 2048, 16), 'b_q': (2, 16, 16, 128),
                   'a_o': (2, 16, 128, 16), 'b_o': (2, 16, 2048),
                   'a_small': (2, 64, 2)}


def test_adapter_leaves_take_the_unfactored_branch_as_in_optax():
    from optax._src import factorized
    rms = port_optim.ScaleByFactoredRms()
    for shape in list(_ADAPTER_SHAPES.values()) + [
            (18, 2048, 16), (18, 16, 16, 128), (18, 16, 8, 128),
            (18, 16, 128, 16), (18, 16, 2048)]:
        want = factorized._factored_dims(shape, True, 128)
        assert rms.factored_dims(shape) == want, shape
        if len(shape) == 3 and shape[-1] == 16:
            assert want is None  # second-largest dim 16 < 128


@pytest.mark.parametrize('name', ['adafactor', 'adamw'])
def test_optimizer_matches_optax_on_adapter_shapes(name):
    rng = np.random.default_rng(6)

    def tree(scale):
        return {k: (rng.standard_normal(s) * scale).astype(np.float32)
                for k, s in _ADAPTER_SHAPES.items()}
    params = tree(0.05)
    sched = (0.0, 1e-2, 1, 10)
    if name == 'adafactor':
        jax_opt = optax.chain(optax.clip_by_global_norm(1.0),
                              optax.adafactor(
                                  optax.warmup_cosine_decay_schedule(*sched)))
        port_opt = port_optim.Chain(
            port_optim.ClipByGlobalNorm(1.0), port_optim.adafactor(
                port_optim.warmup_cosine_decay_schedule(*sched)))
    else:
        jax_opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
            optax.warmup_cosine_decay_schedule(*sched), b1=0.9, b2=0.95,
            weight_decay=0.1))
        port_opt = port_optim.Chain(
            port_optim.ClipByGlobalNorm(1.0), port_optim.adamw(
                port_optim.warmup_cosine_decay_schedule(*sched), b1=0.9,
                b2=0.95, weight_decay=0.1))
    j_params = jax.tree.map(jnp.asarray, params)
    p_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    j_state, p_state = jax_opt.init(j_params), port_opt.init(p_params)
    if name == 'adafactor':
        stats = p_state[1][0]['stats']
        assert all(set(stats[k]) == {'v'} for k in _ADAPTER_SHAPES)
    for step in range(4):
        grads = tree(1e-4 if step == 0 else 0.3)
        j_up, j_state = jax_opt.update(jax.tree.map(jnp.asarray, grads),
                                       j_state, j_params)
        p_up, p_state = port_opt.update(
            {k: torch.from_numpy(v) for k, v in grads.items()}, p_state,
            p_params)
        for k in _ADAPTER_SHAPES:
            np.testing.assert_allclose(p_up[k].numpy(), np.asarray(j_up[k]),
                                       rtol=1e-5, atol=1e-8, err_msg=k)
        j_params = optax.apply_updates(j_params, j_up)
        port_optim.apply_updates(p_params, p_up)


@pytest.mark.parametrize('name', ['adafactor', 'adamw'])
def test_optimizer_matches_optax_bit_for_bit_in_bf16(name):
    """bf16 leaves (LoRA adapters, bf16 full finetuning): the same bf16
    grads through both chains give the same bf16 updates, bit for bit.
    Fails where the port multiplies by an unrounded float32 scalar (the
    learning rate, Adam's decays and bias corrections, weight decay)."""
    rng = np.random.default_rng(9)
    shapes = dict(_ADAPTER_SHAPES, factored=(2, 256, 4, 128))

    def tree(scale):
        return {k: (rng.standard_normal(s) * scale).astype(np.float32)
                for k, s in shapes.items()}
    sched = (0.0, 3e-3, 2, 10)
    if name == 'adafactor':
        jax_opt = optax.chain(optax.clip_by_global_norm(1.0),
                              optax.adafactor(
                                  optax.warmup_cosine_decay_schedule(*sched)))
        port_opt = port_optim.Chain(
            port_optim.ClipByGlobalNorm(1.0), port_optim.adafactor(
                port_optim.warmup_cosine_decay_schedule(*sched)))
    else:
        jax_opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
            optax.warmup_cosine_decay_schedule(*sched), b1=0.9, b2=0.95,
            weight_decay=0.1))
        port_opt = port_optim.Chain(
            port_optim.ClipByGlobalNorm(1.0), port_optim.adamw(
                port_optim.warmup_cosine_decay_schedule(*sched), b1=0.9,
                b2=0.95, weight_decay=0.1))

    def bf16(tree_np):
        return ({k: jnp.asarray(v, jnp.bfloat16) for k, v in tree_np.items()},
                {k: torch.from_numpy(v).to(torch.bfloat16)
                 for k, v in tree_np.items()})
    j_params, p_params = bf16(tree(0.05))
    j_state, p_state = jax_opt.init(j_params), port_opt.init(p_params)
    for step in range(4):
        j_g, p_g = bf16(tree(1e-4 if step == 0 else 0.3))
        j_up, j_state = jax_opt.update(j_g, j_state, j_params)
        p_up, p_state = port_opt.update(p_g, p_state, p_params)
        for k in shapes:
            assert p_up[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                _to_numpy(p_up[k]), np.asarray(j_up[k], np.float32),
                err_msg=f'step {step} {k}')
        j_params = optax.apply_updates(j_params, j_up)
        port_optim.apply_updates(p_params, p_up)
    for k in shapes:
        np.testing.assert_array_equal(_to_numpy(p_params[k]),
                                      np.asarray(j_params[k], np.float32))


# -- the trainer ----------------------------------------------------------------


def _trainers(optimizer, accum_steps=1, targets=('wq', 'wk', 'wv', 'wo'),
              rank=4, lr=3e-4, adapter_dtype='bfloat16'):
    kw = dict(global_batch_size=2, seq_len=32, warmup_steps=1,
              optimizer=optimizer, accum_steps=accum_steps,
              learning_rate=lr)
    jt = jax_trainer.Trainer(jax_trainer.TrainerConfig(
        model=TINY32, lora=jax_lora.LoraConfig(rank=rank, targets=targets),
        **kw))
    jstate = jt.init_state(0)
    if adapter_dtype != 'bfloat16':
        # JAX makes bf16 adapters; the optimizer state follows their dtype.
        jstate['lora'] = jax.tree.map(
            lambda x: x.astype(getattr(jnp, adapter_dtype)), jstate['lora'])
        jstate['opt_state'] = jt.optimizer.init(jstate['lora'])
    pt = port_trainer.Trainer(port_trainer.TrainerConfig(
        model=_port_cfg(TINY32),
        lora=port_lora.LoraConfig(rank=rank, targets=targets), **kw),
        device='cpu')
    pstate = pt.init_state_from_numpy(_np(jstate['params']),
                                      lora=_np(jstate['lora']))
    return jt, jstate, pt, pstate


@pytest.mark.parametrize('adapter_dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('optimizer', ['adafactor', 'adamw'])
@pytest.mark.parametrize('accum_steps', [1, 2])
def test_trainer_lora_matches_jax_trainer(optimizer, accum_steps,
                                          adapter_dtype):
    jt, jstate, pt, pstate = _trainers(optimizer, accum_steps, lr=1e-2,
                                       adapter_dtype=adapter_dtype)
    base = [p.clone() for p in _sorted_leaves(pstate['params'])]
    lora0 = [_to_numpy(p) for p in _sorted_leaves(pstate['lora'])]
    step = jt.compiled_step()
    rng = np.random.default_rng(7)
    for _ in range(3):
        batch = rng.integers(0, TINY32.vocab_size, (2, 32)).astype(np.int32)
        jstate, jm = step(jstate, jnp.asarray(batch))
        pstate, pm = pt.step(pstate, batch)
        assert float(pm['loss']) == pytest.approx(float(jm['loss']),
                                                  rel=LOSS_RTOL)
        assert float(pm['grad_norm']) == pytest.approx(
            float(jm['grad_norm']), rel=1e-2)
    assert pstate['step'] == int(jstate['step']) == 3
    moved = 0.0
    for want, got, start in zip(jax.tree.leaves(jstate['lora']),
                                _sorted_leaves(pstate['lora']), lora0):
        assert got.dtype == getattr(torch, adapter_dtype)
        assert got.requires_grad
        want = np.asarray(want, np.float32)
        if adapter_dtype == 'float32':
            np.testing.assert_allclose(got.detach().numpy(), want,
                                       atol=ADAPTER_TOL, rtol=0)
        else:
            diff = np.abs(_to_numpy(got) - want)
            off = diff > np.maximum(np.abs(want) * 2.0 ** -7, ADAPTER_TOL)
            assert off.mean() <= 0.01 and diff.max() <= BF16_LR_SHARE * 1e-2

        moved = max(moved, float(np.abs(want - start).max()))
    assert moved > 50 * ADAPTER_TOL  # the check compares real movement
    for a, b in zip(base, _sorted_leaves(pstate['params'])):
        assert torch.equal(a, b) and not b.requires_grad
    for want, got in zip(jax.tree.leaves(jstate['params']), base):
        assert np.array_equal(np.asarray(want), got.numpy())


def test_trainer_lora_step_freezes_base_and_learns():
    cfg = port_trainer.TrainerConfig(
        model=_port_cfg(TINY32), global_batch_size=2, seq_len=32,
        optimizer='adamw', learning_rate=1e-2, warmup_steps=1, remat=False,
        lora=port_lora.LoraConfig(rank=4))
    trainer = port_trainer.Trainer(cfg, device='cpu')
    state = trainer.init_state(seed=0)
    assert 'lora' in state
    before = [p.clone() for p in _sorted_leaves(state['params'])]
    rng = np.random.default_rng(0)
    fixed = rng.integers(0, TINY32.vocab_size, (2, 32)).astype(np.int32)
    losses = []
    for _ in range(8):
        state, metrics = trainer.step(state, fixed)
        losses.append(float(metrics['loss']))
    for a, b in zip(before, _sorted_leaves(state['params'])):
        assert torch.equal(a, b)
    assert losses[-1] < losses[0], losses
    assert float(state['lora']['wq']['b'].float().norm()) > 0.0
    # Seeds: the same seed gives the same adapters, another seed others.
    again = trainer.init_state(seed=0)['lora']['wq']['a']
    other = trainer.init_state(seed=1)['lora']['wq']['a']
    assert torch.equal(again, trainer.init_state(seed=0)['lora']['wq']['a'])
    assert not torch.equal(again, other)


@pytest.mark.parametrize('optimizer', ['adafactor', 'adamw'])
def test_trainer_lora_opt_state_is_adapter_sized(optimizer):
    _, jstate, _, pstate = _trainers(optimizer, rank=2)
    got = [lf for lf in port_snapshot.flatten_named(pstate)[0]
           if lf.name.startswith("['opt_state']")]
    want = [(n, a) for n, a in jax_snapshot.flatten_named(jstate)[0]
            if n.startswith("['opt_state']")]
    assert [lf.name for lf in got] == [n for n, _ in want]
    assert [lf.shape for lf in got] == [tuple(a.shape) for _, a in want]
    opt = sum(int(np.prod(lf.shape)) for lf in got)
    base = sum(p.numel() for p in _sorted_leaves(pstate['params']))
    assert opt < base * 0.5


# -- checkpoints across the packages -----------------------------------------------


def _named(tree):
    return {lf.name: lf.value for lf in port_snapshot.flatten_named(tree)[0]}


@pytest.mark.parametrize('direction', ['jax_to_port', 'port_to_jax'])
def test_lora_checkpoint_crosses_packages(tmp_path, direction):
    """One package trains 2 LoRA steps and saves; the other restores and
    both train 2 more side by side."""
    jt, jstate, pt, pstate = _trainers('adafactor')
    names = [lf.name for lf in port_snapshot.flatten_named(pstate)[0]]
    assert names == [n for n, _ in jax_snapshot.flatten_named(jstate)[0]]
    assert any(n.startswith("['lora']['wq']['a']") for n in names)
    rng = np.random.default_rng(8)
    batches = [rng.integers(0, TINY32.vocab_size, (2, 32)).astype(np.int32)
               for _ in range(4)]
    step = jt.compiled_step()
    if direction == 'jax_to_port':
        for b in batches[:2]:
            jstate, _ = step(jstate, jnp.asarray(b))
        jm = jax_manager.AsyncCheckpointManager(
            str(tmp_path), async_save=False, telemetry=None)
        jm.save(2, jstate, force=True)
        jm.close()
        pm = AsyncCheckpointManager(str(tmp_path), telemetry=None)
        pstate = pm.restore_latest(pstate)
        pm.close()
        assert pstate['step'] == 2
        assert all(p.requires_grad for p in _sorted_leaves(pstate['lora']))
        assert not any(p.requires_grad
                       for p in _sorted_leaves(pstate['params']))
    else:
        for b in batches[:2]:
            pstate, _ = pt.step(pstate, b)
        pm = AsyncCheckpointManager(str(tmp_path), async_save=True,
                                    telemetry=None)
        pm.save(2, pstate, force=True)
        pm.close()
        jm = jax_manager.AsyncCheckpointManager(str(tmp_path),
                                                telemetry=None)
        jstate = jm.restore_latest(jstate)
        jm.close()
        assert int(jstate['step']) == 2
    for b in batches[2:]:
        jstate, jm_ = step(jstate, jnp.asarray(b))
        pstate, pm_ = pt.step(pstate, b)
        assert float(pm_['loss']) == pytest.approx(float(jm_['loss']),
                                                   rel=LOSS_RTOL)
    got = _named(pstate)
    for name, want in jax_snapshot.flatten_named(jstate)[0]:
        if name.startswith("['lora']"):
            np.testing.assert_allclose(_to_numpy(got[name]),
                                       np.asarray(want, np.float32),
                                       atol=ADAPTER_TOL, rtol=0,
                                       err_msg=name)


# -- train.run --------------------------------------------------------------------


def test_run_main_lora_trains_and_resumes(tmp_path, capsys):
    """The LoRA recipe's entry point on the CPU: --lora-rank 2 with
    targets wq,wv, run twice into one checkpoint dir (the spot-recovery
    contract of test_run_cli_lora_smoke)."""
    ckpt = str(tmp_path / 'ckpt')
    argv = ['--model', 'tiny', '--steps', '3', '--global-batch-size', '2',
            '--seq-len', '32', '--lora-rank', '2', '--lora-targets', 'wq,wv',
            '--mesh', 'fsdp=-1', '--ckpt-dir', ckpt, '--save-every', '1',
            '--log-every', '1', '--device', 'cpu']
    first = port_run.main(argv)
    out = capsys.readouterr().out
    assert '[train] done' in out and 'lora rank 2' in out
    assert sorted(first['state']['lora']) == ['wq', 'wv']
    second = port_run.main(argv)
    assert 'resumed from checkpoint step 3' in capsys.readouterr().out
    assert second['start_step'] == 3 and second['losses'] == []
    for x, y in zip(_sorted_leaves(first['state']['lora']),
                    _sorted_leaves(second['state']['lora'])):
        assert torch.equal(x, y)
