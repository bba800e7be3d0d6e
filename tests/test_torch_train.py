"""Parity of the port's training path with the JAX package, on the CPU.

* ``train/data.py``: the port's copy against the original, same seeds.
* ``llama.loss_fn`` and its gradients on fp32 TINY against
  ``jax.value_and_grad(llama.loss_fn)`` with the same weights, for every
  remat policy and without remat (tolerance 1e-5; measured ~3e-8).
* ``train/optim.py`` against optax on random stacked leaves, including
  factored shapes: updates within 1e-5 relative (1e-8 absolute, against
  updates of ~1e-2), params within 1e-6.
* ``Trainer``: 4 steps, warmup 1, on a fp32 model whose dims reach 128 so
  Adafactor factors, for Adafactor and AdamW, accum_steps 1 and 2, against
  the JAX ``Trainer`` from the same weights and batches. Losses within
  1e-5, params within 2e-5 after 4 steps (measured 1e-6 and 7e-6; AdamW's
  first updates are near lr * sign(g), which magnifies the grads' last
  bits where g is near 0).

* ``train.run`` with checkpoints: 4 steps and a resumed run to 6 give
  exactly the losses and state of 6 steps without a break; telemetry
  windows and checkpoint records reach the spool; a run sent SIGTERM exits
  143 with its freshest snapshot durable, and its relaunch resumes.

Inputs are made with numpy from a seed and handed to both packages.
"""
import dataclasses
import os
import pathlib
import re
import signal
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.train import data as jax_data
from skypilot_tpu.train import trainer as jax_trainer
from skypilot_tpu_torch.ckpt import manifest as ckpt_manifest
from skypilot_tpu_torch.ckpt import snapshot as ckpt_snapshot
from skypilot_tpu_torch.models import llama as port_llama
from skypilot_tpu_torch.observability import train_telemetry
from skypilot_tpu_torch.train import data as port_data
from skypilot_tpu_torch.train import optim as port_optim
from skypilot_tpu_torch.train import run as port_run
from skypilot_tpu_torch.train import trainer as port_trainer

LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
PARAM_TOL = 2e-5
TINY32 = dataclasses.replace(jax_llama.TINY, dtype=jnp.float32)
# Dims reach 128 so Adafactor factors embed, lm_head and the MLP weights.
WIDE32 = dataclasses.replace(jax_llama.TINY, d_model=128, d_ff=256,
                             dtype=jnp.float32)


def _port_cfg(cfg):
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg) if f.name != 'dtype'}
    return port_llama.LlamaConfig(**fields, dtype=torch.float32)


def _sorted_leaves(tree):
    """Leaves in jax.tree's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    return [tree]


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


# -- data ------------------------------------------------------------------------


def test_synthetic_batches_match_original():
    for seed in (0, 3):
        a = list(jax_data.synthetic_batches(3, 17, 300, seed=seed,
                                            num_batches=2))
        b = list(port_data.synthetic_batches(3, 17, 300, seed=seed,
                                             num_batches=2))
        assert all(np.array_equal(x, y) and y.dtype == np.int32
                   for x, y in zip(a, b))


def test_byte_corpus_batches_match_original(tmp_path):
    path = tmp_path / 'corpus.txt'
    path.write_bytes(bytes(range(256)) * 3)
    a = jax_data.byte_corpus_batches(str(path), 2, 40, seed=1)
    b = port_data.byte_corpus_batches(str(path), 2, 40, seed=1)
    for _ in range(3):
        assert np.array_equal(next(a), next(b))
    with pytest.raises(ValueError, match='too small'):
        next(port_data.byte_corpus_batches(str(path), 2, 10_000))


def test_token_dataset_matches_original(tmp_path):
    tokens = np.random.default_rng(2).integers(0, 1000, 4000)
    path = str(tmp_path / 'tokens.bin')
    port_data.write_token_file(path, tokens)
    jax_path = str(tmp_path / 'tokens_jax.bin')
    jax_data.write_token_file(jax_path, tokens)
    assert open(path, 'rb').read() == open(jax_path, 'rb').read()
    a = jax_data.TokenDataset(path, seq_len=64, batch_size=4, seed=5,
                              num_shards=2, shard=1)
    b = port_data.TokenDataset(path, seq_len=64, batch_size=4, seed=5,
                               num_shards=2, shard=1)
    assert a.steps_per_epoch == b.steps_per_epoch
    for step in (0, 1, 30):
        assert np.array_equal(a.batch(step), b.batch(step))
    with pytest.raises(ValueError, match='outside the model vocab'):
        port_data.TokenDataset(path, 64, 4, vocab_size=10).batch(0)


# -- model -------------------------------------------------------------------------


def _port_params(tree, cfg):
    params = port_llama.params_from_numpy(tree, _port_cfg(cfg), 'cpu')
    for leaf in port_optim.tree_leaves(params):
        leaf.requires_grad_(True)
    return params


@pytest.mark.parametrize('policy', ['full', 'attn', 'heavy', 'dots', None])
def test_loss_and_grads_match_jax(policy):
    params = jax_llama.init_params(jax.random.PRNGKey(0), TINY32)
    tokens = _tokens(0, 2, 32, TINY32.vocab_size)
    remat = policy is not None
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jax_llama.loss_fn(p, jnp.asarray(tokens), TINY32,
                                    remat=remat,
                                    remat_policy=policy or 'full'),
        has_aux=True)(params)

    port = _port_params(jax.tree.map(np.asarray, params), TINY32)
    p_loss, p_metrics = port_llama.loss_fn(
        port, torch.from_numpy(tokens), _port_cfg(TINY32), remat=remat,
        remat_policy=policy or 'full')
    p_loss.backward()
    assert abs(float(p_loss.detach()) - float(loss)) <= LOSS_TOL
    assert abs(float(p_metrics['perplexity'].detach())
               - float(metrics['perplexity'])) <= LOSS_TOL * 1e3
    for want, got in zip(jax.tree.leaves(grads), _sorted_leaves(port)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)


def test_forward_logits_match_jax():
    params = jax_llama.init_params(jax.random.PRNGKey(1), TINY32)
    tokens = _tokens(1, 2, 24, TINY32.vocab_size)
    want = jax_llama.forward(params, jnp.asarray(tokens), TINY32)
    got = port_llama.forward(
        port_llama.params_from_numpy(jax.tree.map(np.asarray, params),
                                     _port_cfg(TINY32), 'cpu'),
        torch.from_numpy(tokens), _port_cfg(TINY32))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2, 24, TINY32.vocab_size)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_gradients_do_not_depend_on_remat_policy():
    cfg = _port_cfg(TINY32)
    tree = jax.tree.map(np.asarray, jax_llama.init_params(
        jax.random.PRNGKey(2), TINY32))
    tokens = torch.from_numpy(_tokens(2, 2, 20, cfg.vocab_size))
    grads = {}
    for policy in [None] + sorted(port_llama.REMAT_POLICIES):
        params = _port_params(tree, TINY32)
        loss, _ = port_llama.loss_fn(params, tokens, cfg,
                                     remat=policy is not None,
                                     remat_policy=policy or 'full')
        loss.backward()
        grads[policy] = [p.grad for p in _sorted_leaves(params)]
    for policy, got in grads.items():
        for a, b in zip(got, grads[None]):
            torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6,
                                       msg=f'policy {policy}')


def test_stacked_leaves_get_one_gradient_each():
    cfg = _port_cfg(TINY32)
    params = _port_params(jax.tree.map(np.asarray, jax_llama.init_params(
        jax.random.PRNGKey(3), TINY32)), TINY32)
    loss, _ = port_llama.loss_fn(params, torch.from_numpy(
        _tokens(3, 1, 16, cfg.vocab_size)), cfg)
    loss.backward()
    for name, leaf in params['layers'].items():
        assert leaf.grad.shape == leaf.shape, name
        assert bool(torch.all(leaf.grad.flatten(1).abs().sum(1) > 0)), name


def test_unported_model_features_raise():
    cfg = _port_cfg(TINY32)
    params = port_llama.init_params(cfg, torch.Generator().manual_seed(0),
                                    'cpu')
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    # MoE is ported: an MoE model's forward runs (tests/test_torch_moe.py
    # holds it against JAX's). Pipeline stages are ported: on one device
    # they give the unpipelined forward's logits
    # (tests/test_torch_parallel_axes.py holds them against JAX's), and
    # JAX's errors remain for stages or microbatches that do not divide.
    moe_cfg = dataclasses.replace(cfg, num_experts=4)
    moe_params = port_llama.init_params(
        moe_cfg, torch.Generator().manual_seed(0), 'cpu')
    assert port_llama.forward(moe_params, tokens, moe_cfg).shape == \
        (1, 8, cfg.vocab_size)
    torch.testing.assert_close(
        port_llama.forward(params, tokens.expand(2, 8),
                           dataclasses.replace(cfg, pipeline_stages=2,
                                               pipeline_microbatches=2)),
        port_llama.forward(params, tokens.expand(2, 8), cfg),
        rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match='not divisible by 3 stages'):
        port_llama.forward(params, tokens,
                           dataclasses.replace(cfg, pipeline_stages=3))
    with pytest.raises(ValueError, match='not divisible by 2 microbatches'):
        port_llama.forward(params, tokens,
                           dataclasses.replace(cfg, pipeline_stages=2,
                                               pipeline_microbatches=2))
    with pytest.raises(ValueError, match='remat_policy'):
        port_llama.loss_fn(params, tokens, cfg, remat_policy='bogus')


# -- optimizer --------------------------------------------------------------------

_SHAPES = {'factored4d': (2, 256, 4, 128), 'factored2d': (130, 300),
           'small2d': (2, 64), 'vector': (128,), 'stack3d': (2, 128, 256)}


def _random_tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in _SHAPES.items()}


@pytest.mark.parametrize('name', ['adafactor', 'adamw'])
def test_optimizer_matches_optax(name):
    rng = np.random.default_rng(4)
    params = _random_tree(rng)
    jax_sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 1, 10)
    port_sched = port_optim.warmup_cosine_decay_schedule(0.0, 1e-2, 1, 10)
    if name == 'adafactor':
        jax_opt = optax.chain(optax.clip_by_global_norm(1.0),
                              optax.adafactor(learning_rate=jax_sched))
        port_opt = port_optim.Chain(port_optim.ClipByGlobalNorm(1.0),
                                    port_optim.adafactor(port_sched))
    else:
        jax_opt = optax.chain(optax.clip_by_global_norm(1.0),
                              optax.adamw(jax_sched, b1=0.9, b2=0.95,
                                          weight_decay=0.1))
        port_opt = port_optim.Chain(
            port_optim.ClipByGlobalNorm(1.0),
            port_optim.adamw(port_sched, b1=0.9, b2=0.95, weight_decay=0.1))
    j_params = jax.tree.map(jnp.asarray, params)
    p_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    j_state, p_state = jax_opt.init(j_params), port_opt.init(p_params)
    for step in range(4):
        # Step 0 has a norm below the clip, the others above it.
        grads = _random_tree(rng, scale=1e-4 if step == 0 else 0.3)
        j_up, j_state = jax_opt.update(jax.tree.map(jnp.asarray, grads),
                                       j_state, j_params)
        p_up, p_state = port_opt.update(
            {k: torch.from_numpy(v) for k, v in grads.items()}, p_state,
            p_params)
        for k in _SHAPES:
            np.testing.assert_allclose(p_up[k].numpy(), np.asarray(j_up[k]),
                                       rtol=1e-5, atol=1e-8, err_msg=k)
        j_params = optax.apply_updates(j_params, j_up)
        port_optim.apply_updates(p_params, p_up)
    for k in _SHAPES:
        np.testing.assert_allclose(p_params[k].numpy(),
                                   np.asarray(j_params[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_factored_dims_follow_optax():
    from optax._src import factorized
    rms = port_optim.ScaleByFactoredRms()
    for shape in list(_SHAPES.values()) + [(18, 2048, 16, 128),
                                           (18, 16, 128, 2048),
                                           (32768, 2048), (128, 128)]:
        assert rms.factored_dims(shape) == factorized._factored_dims(
            shape, True, 128), shape


@pytest.mark.parametrize('args', [(0.0, 3e-4, 100, 10_000),
                                  (0.0, 1e-2, 1, 5), (0.0, 1e-3, 0, 7),
                                  (0.0, 1e-3, 3, 4)])
def test_schedule_matches_optax(args):
    want = optax.warmup_cosine_decay_schedule(*args)
    got = port_optim.warmup_cosine_decay_schedule(*args)
    for count in (0, 1, 2, 3, 4, 50, 101, 5_000, 20_000):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6,
                                           abs=1e-12), count


# -- trainer ------------------------------------------------------------------------


@pytest.mark.parametrize('optimizer', ['adafactor', 'adamw'])
@pytest.mark.parametrize('accum_steps', [1, 2])
def test_trainer_matches_jax_trainer(optimizer, accum_steps):
    kw = dict(global_batch_size=2, seq_len=32, warmup_steps=1,
              optimizer=optimizer, accum_steps=accum_steps)
    j_trainer = jax_trainer.Trainer(jax_trainer.TrainerConfig(
        model=WIDE32, **kw))
    j_state = j_trainer.init_state(0)
    init = jax.tree.map(np.array, j_state['params'])
    p_trainer = port_trainer.Trainer(port_trainer.TrainerConfig(
        model=_port_cfg(WIDE32), **kw), device='cpu')
    p_state = p_trainer.init_state_from_numpy(init)
    step = j_trainer.compiled_step()
    rng = np.random.default_rng(5)
    for _ in range(4):
        batch = rng.integers(0, WIDE32.vocab_size, (2, 32)).astype(np.int32)
        j_state, j_metrics = step(j_state, jnp.asarray(batch))
        p_state, p_metrics = p_trainer.step(p_state, batch)
        assert abs(float(p_metrics['loss'])
                   - float(j_metrics['loss'])) <= LOSS_TOL
        assert float(p_metrics['grad_norm']) == pytest.approx(
            float(j_metrics['grad_norm']), rel=1e-5)
    assert p_state['step'] == int(j_state['step']) == 4
    moved = 0.0
    for want, got, start in zip(jax.tree.leaves(j_state['params']),
                                _sorted_leaves(p_state['params']),
                                jax.tree.leaves(init)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=PARAM_TOL, rtol=0)
        moved = max(moved, float(np.abs(np.asarray(want) - start).max()))
    assert moved > 50 * PARAM_TOL  # the check compares real movement


def test_trainer_accounting_and_config_match_jax():
    for kw in (dict(global_batch_size=4, seq_len=128),
               dict(global_batch_size=2, seq_len=4096)):
        j = jax_trainer.TrainerConfig(model=jax_llama.BENCH_1B, **kw)
        p = port_trainer.TrainerConfig(model=port_llama.BENCH_1B, **kw)
        assert port_trainer.tokens_per_step(p) == \
            jax_trainer.tokens_per_step(j)
        assert port_trainer.model_flops_per_step(p) == \
            jax_trainer.model_flops_per_step(j)
    for bad, match in ((dict(remat_policy='nope'), 'remat_policy'),
                       (dict(global_batch_size=3, accum_steps=2),
                        'accum_steps')):
        with pytest.raises(ValueError, match=match):
            port_trainer.TrainerConfig(model=port_llama.TINY, **bad)
    cfg = port_trainer.TrainerConfig(model=port_llama.TINY, optimizer='sgd')
    with pytest.raises(ValueError, match='optimizer'):
        port_trainer.Trainer(cfg, device='cpu')


def test_trainer_refuses_what_is_not_ported():
    """Every axis is ported (tests/test_torch_train_axes.py trains over
    pipe, seq and expert against JAX): a mesh is refused only where the
    config does not split over it, with JAX's ``ValueError``. The
    meshes here carry shapes only; nothing runs on them."""
    import types
    ones = {a: 1 for a in ('data', 'pipe', 'fsdp', 'seq', 'expert',
                           'tensor')}

    def mesh(**sizes):
        return types.SimpleNamespace(shape=dict(ones, **sizes),
                                     device=torch.device("cpu"))
    cfg = port_trainer.TrainerConfig(model=port_llama.TINY,
                                     global_batch_size=4, seq_len=128)
    for sizes, match in ((dict(pipe=4), '2 layers not divisible by 4 '
                                        'stages'),
                         (dict(seq=3), 'sequence length 128 does not '
                                       'split over seq'),
                         (dict(data=8), 'global batch 4 does not split')):
        with pytest.raises(ValueError, match=match):
            port_trainer.Trainer(cfg, device='cpu', mesh=mesh(**sizes))
    staged = dataclasses.replace(port_llama.TINY, pipeline_stages=2,
                                 pipeline_microbatches=3)
    with pytest.raises(ValueError, match='batch 4 not divisible by 3 '
                                         'microbatches'):
        port_trainer.Trainer(dataclasses.replace(cfg, model=staged),
                             device='cpu', mesh=mesh(pipe=2))
    # MoE trains on one device and on a mesh whose expert axis splits
    # its 4 experts (the shardings are built; 3 does not split them).
    moe = dataclasses.replace(cfg, model=port_llama.MOE_TINY)
    port_trainer.Trainer(moe, device='cpu')
    tr = port_trainer.Trainer(moe, device='cpu', mesh=mesh(expert=2))
    assert tr.param_shardings['layers']['moe']['we_gate'].spec == \
        ('pipe', 'expert', 'fsdp', 'tensor')
    with pytest.raises(ValueError, match='4 experts do not split over '
                                         'expert'):
        port_trainer.Trainer(moe, device='cpu', mesh=mesh(expert=3))


def test_trainer_train_loop_calls_back_every_log_every_steps():
    trainer = port_trainer.Trainer(port_trainer.TrainerConfig(
        model=_port_cfg(TINY32), global_batch_size=2, seq_len=16,
        warmup_steps=1), device='cpu')
    state = trainer.init_state(seed=0)
    before = [p.detach().clone() for p in _sorted_leaves(state['params'])]
    seen = []
    batches = port_data.synthetic_batches(2, 16, TINY32.vocab_size, seed=1,
                                          num_batches=4)
    state, metrics = trainer.train(state, batches, log_every=2,
                                   callback=lambda i, m: seen.append((i, m)))
    assert [i for i, _ in seen] == [2, 4] and state['step'] == 4
    assert set(seen[-1][1]) == {'loss', 'perplexity', 'grad_norm'}
    assert seen[-1][1]['loss'] == float(metrics['loss'])
    assert any(not torch.equal(a, b.detach()) for a, b in
               zip(before, _sorted_leaves(state['params'])))


def test_run_main_trains_on_cpu(capsys):
    out = port_run.main(['--model', 'tiny', '--steps', '3', '--seq-len',
                         '32', '--warmup-steps', '1', '--log-every', '2',
                         '--device', 'cpu'])
    text = capsys.readouterr().out
    assert '[train] step 2/3 loss=' in text and '[train] step 3/3' in text
    assert '[train] done' in text
    assert len(out['losses']) == 3 and all(np.isfinite(out['losses']))
    assert out['state']['step'] == 3


@pytest.mark.parametrize('flag', [
    (['--mesh', 'pipe=4,fsdp=1'], '2 layers not divisible by 4 stages'),
    (['--mesh', 'seq=2,fsdp=1', '--seq-len', '33'],
     'sequence length 33 does not split over seq'),
    (['--mesh', 'expert=3,fsdp=1', '--model', 'moe-tiny'],
     '4 experts do not split over expert')])
def test_run_main_refuses_unported_flags(flag, capsys):
    """Every mesh axis trains now (pipe, seq and expert in
    tests/test_torch_train_axes.py; data, fsdp and tensor in
    tests/test_torch_train_sharded.py and ``..._multihost.py``). What
    ``train.run`` still refuses is a model, sequence or expert count
    that does not split over the mesh: JAX's ``ValueError``, raised
    before any rank starts."""
    argv, match = flag
    with pytest.raises(ValueError, match=match):
        port_run.main(['--device', 'cpu'] + argv)
    assert 'rank-summary' not in capsys.readouterr().out


@pytest.mark.parametrize('model,mesh', [
    ('moe-8x1b', 'fsdp=2,expert=8'),  # the moe-finetune recipe's mesh
    ('bench-1b', 'pipe=2,fsdp=1'), ('bench-1b', 'seq=2,fsdp=1')])
def test_run_plans_the_new_axes(model, mesh):
    """The moe-finetune recipe's ``--mesh`` and the pipe and seq axes,
    which exited 2 before, plan a gang (no rank starts here)."""
    args = port_run.build_parser().parse_args(
        ['--model', model, '--mesh', mesh, '--global-batch-size', '16',
         '--seq-len', '2048'])
    sizes, slices, ranks = port_run._plan_mesh(  # noqa: SLF001
        port_run.build_parser(), args, port_run._config(args))  # noqa: SLF001
    want = dict(p.split('=') for p in mesh.split(','))
    assert all(sizes[a] == int(n) for a, n in want.items())
    assert slices == 1 and ranks == int(np.prod(list(sizes.values())))


# -- train.run with checkpoints ------------------------------------------------

_RUN = ['--model', 'tiny', '--seq-len', '32', '--warmup-steps', '1',
        '--log-every', '1', '--device', 'cpu']


def _state_leaves(state):
    return ckpt_snapshot.flatten_named(state)[0]


@pytest.mark.parametrize('optimizer', ['adafactor', 'adamw'])
def test_run_resumes_to_the_uninterrupted_run(tmp_path, capsys, optimizer):
    """4 steps saving at 2 and 4 (async), then a relaunch to 6: exactly
    the losses and state of 6 steps without a break (the port's
    counterpart of test_checkpoint_save_restore_resume)."""
    run = _RUN + ['--optimizer', optimizer]
    d1, d2 = str(tmp_path / 'd1'), str(tmp_path / 'd2')
    a = port_run.main(run + ['--steps', '4', '--save-every', '2',
                             '--ckpt-dir', d1])
    b = port_run.main(run + ['--steps', '6', '--save-every', '2',
                             '--ckpt-dir', d1])
    assert '[train] resumed from checkpoint step 4' in capsys.readouterr().out
    c = port_run.main(run + ['--steps', '6', '--save-every', '3',
                             '--ckpt-dir', d2, '--ckpt-sync'])
    assert a['start_step'] == 0 and b['start_step'] == 4
    assert a['losses'] == c['losses'][:4] and b['losses'] == c['losses'][4:]
    for x, y in zip(_state_leaves(b['state']), _state_leaves(c['state'])):
        assert x.name == y.name
        if isinstance(x.value, torch.Tensor):
            assert torch.equal(x.value, y.value), x.name
        else:
            assert x.value == y.value, x.name
    assert [s for s, _ in ckpt_manifest.committed_steps(d1)] == [2, 4, 6]
    assert [s for s, _ in ckpt_manifest.committed_steps(d2)] == [3, 6]
    # A run that ends off the interval still saves its last step.
    port_run.main(run + ['--steps', '7', '--save-every', '3',
                         '--ckpt-dir', d2])
    assert [s for s, _ in ckpt_manifest.committed_steps(d2)] == [3, 6, 7]


def test_run_writes_telemetry_windows_and_checkpoint_records(tmp_path,
                                                             monkeypatch):
    spool = str(tmp_path / 'spool')
    monkeypatch.setenv(train_telemetry.ENV_DIR, spool)
    port_run.main(_RUN + ['--steps', '4', '--log-every', '2',
                          '--save-every', '2', '--ckpt-dir',
                          str(tmp_path / 'ck')])
    port_run.main(_RUN + ['--steps', '5', '--log-every', '2',
                          '--ckpt-dir', str(tmp_path / 'ck')])
    recs = train_telemetry.read_records(spool)
    windows = [r for r in recs if 'kind' not in r]
    assert [(r['step'], r['steps_in_window']) for r in windows] == \
        [(2, 2), (4, 2), (5, 1)]
    assert all(r['tokens_per_s'] > 0 and 'loss' in r for r in windows)
    ops = [(r['op'], r['step']) for r in recs if r.get('kind') == 'ckpt']
    assert ops == [('save', 2), ('save', 4), ('restore', 4), ('save', 5)]


def _wait_for(proc, text, timeout):
    """Read the child's lines until one holds ``text``."""
    lines, found = [], threading.Event()

    def pump():
        for line in proc.stdout:
            lines.append(line)
            if text in line:
                found.set()
        found.set()

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    assert found.wait(timeout) and any(text in x for x in lines), lines
    return lines, reader


def test_sigterm_persists_the_freshest_snapshot_and_relaunch_resumes(
        tmp_path):
    repo = str(pathlib.Path(port_run.__file__).resolve().parents[2])
    ck = str(tmp_path / 'ck')
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.train.run', *_RUN,
           '--save-every', '2', '--step-time-floor', '0.4', '--ckpt-dir',
           ck]
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.Popen(cmd + ['--steps', '200'], cwd=repo, env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        lines, reader = _wait_for(proc, '[train] step 3/200', 120)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 143
        reader.join(10)
    finally:
        if proc.poll() is None:
            proc.kill()
    text = ''.join(lines)
    m = re.search(r'emergency persist returned step (\d+)', text)
    assert m, text
    durable = int(m.group(1))
    printed = max(int(x) for x in re.findall(r'step (\d+)/200', text))
    # The freshest snapshot is the last save's step: every 2 steps.
    assert durable == printed // 2 * 2 >= 2
    assert ckpt_manifest.committed_steps(ck)[-1][0] == durable
    relaunch = subprocess.run(cmd + ['--steps', str(durable + 1)],
                              cwd=repo, env=env, capture_output=True,
                              text=True, timeout=120, check=False)
    assert relaunch.returncode == 0, relaunch.stderr
    assert f'[train] resumed from checkpoint step {durable}' in \
        relaunch.stdout
    assert f'step {durable + 1}/{durable + 1}' in relaunch.stdout
