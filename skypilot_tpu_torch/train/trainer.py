"""Training loop on one device: train state and the train step.

Port of ``skypilot_tpu/train/trainer.py``. JAX's jitted step over a mesh
becomes an eager step on one device: ``loss_fn`` forward and backward
(flash attention K1-K3 on the card), then the optax chain of
``train/optim.py`` applied in place. ``mesh``/``rules`` (sharding) are
not ported yet and raise ``NotImplementedError``. An MoE model trains
like a dense one; its metrics carry ``moe_aux``, and LoRA adapts its
attention only.

The state is ``{'step': int, 'params': tree, 'opt_state': ...}``; the
trainable leaves carry ``requires_grad`` and are updated in place (JAX
returns new arrays), which keeps one copy of the weights on the card.
With LoRA (``TrainerConfig.lora``) the state also holds ``'lora'``, the
adapter tree (``models/lora.py``): the loss runs on ``merge(params,
lora)``, the gradients and the optimizer state cover the adapters only,
and the base params carry no ``requires_grad`` (frozen by construction).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import lora as lora_lib
from skypilot_tpu_torch.train import optim
from skypilot_tpu_torch.utils.device import (H100_BF16_DENSE_FLOPS,
                                             DeviceLike, resolve_device)


@dataclasses.dataclass
class TrainerConfig:
    model: llama.LlamaConfig
    global_batch_size: int = 8
    seq_len: int = 2048
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000  # LR cosine-decay horizon
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    optimizer: str = 'adafactor'  # 'adafactor' | 'adamw'
    # Microbatches per optimizer step; their grads are summed in fp32.
    accum_steps: int = 1
    remat: bool = True
    remat_policy: str = 'full'  # models/llama.py REMAT_POLICIES
    # LoRA finetuning (models/lora.py): None = full finetune.
    lora: Optional[lora_lib.LoraConfig] = None

    def __post_init__(self):
        if self.remat_policy not in llama.REMAT_POLICIES:
            raise ValueError(
                f'Unknown remat_policy {self.remat_policy!r}; choose from '
                f'{sorted(llama.REMAT_POLICIES)}')
        if self.accum_steps < 1 or \
                self.global_batch_size % self.accum_steps:
            raise ValueError(
                f'accum_steps ({self.accum_steps}) must divide '
                f'global_batch_size ({self.global_batch_size})')


def make_optimizer(cfg: TrainerConfig) -> optim.Chain:
    """clip_by_global_norm, then adafactor or adamw under a warmup-cosine
    schedule that is 0 at step 0 (``trainer.py:66``)."""
    schedule = optim.warmup_cosine_decay_schedule(
        0.0, cfg.learning_rate, cfg.warmup_steps,
        max(cfg.total_steps, cfg.warmup_steps + 1))
    if cfg.optimizer == 'adafactor':
        opt = optim.adafactor(schedule)
    elif cfg.optimizer == 'adamw':
        opt = optim.adamw(schedule, b1=0.9, b2=0.95,
                          weight_decay=cfg.weight_decay)
    else:
        raise ValueError(f'Unknown optimizer {cfg.optimizer!r}')
    return optim.Chain(optim.ClipByGlobalNorm(cfg.grad_clip_norm), opt)


class Trainer:
    """Owns the optimizer and runs train steps on one device (CUDA unless
    ``device='cpu'``)."""

    def __init__(self, cfg: TrainerConfig, device: DeviceLike = None,
                 mesh=None, rules=None):
        if mesh is not None or rules is not None:
            raise NotImplementedError(
                'sharded training (mesh/rules) is not ported yet: the port '
                'trains on one device')
        self.cfg = cfg
        self.device = resolve_device(device)
        self.optimizer = make_optimizer(cfg)

    # -- state init --------------------------------------------------------

    def init_state(self, seed: int = 0) -> Dict[str, Any]:
        """Random weights from ``seed`` (``torch.Generator``: not the
        values ``jax.random`` gives for the same seed); with LoRA, the
        adapters from a generator seeded with ``fold_in(seed, 1)``, as
        JAX draws them from ``fold_in(key, 1)``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return self._state(llama.init_params(self.cfg.model, gen,
                                             self.device), seed)

    def init_state_from_numpy(self, tree: Any,
                              lora: Any = None) -> Dict[str, Any]:
        """Start from a JAX weight tree and, with LoRA, a JAX adapter tree
        (``init_lora``'s from seed 0 when None), given as numpy arrays."""
        return self._state(llama.params_from_numpy(tree, self.cfg.model,
                                                   self.device), 0, lora)

    def _state(self, params, seed: int, lora: Any = None) -> Dict[str, Any]:
        adapters = None
        if self.cfg.lora is not None:
            if lora is None:
                gen = torch.Generator(device=self.device).manual_seed(
                    fold_in(seed, 1))
                adapters = lora_lib.init_lora(gen, params, self.cfg.lora,
                                              device=self.device)
            else:
                lora_lib._check_targets(params['layers'],  # noqa: SLF001
                                        self.cfg.lora.targets)
                adapters = lora_lib.lora_from_numpy(lora, self.device)
        # Only the trainable tree carries requires_grad; with LoRA the
        # optimizer state covers the adapters only.
        trainable = params if adapters is None else adapters
        for p in optim.tree_leaves(trainable):
            p.requires_grad_(True)
        state = {'step': 0, 'params': params,
                 'opt_state': self.optimizer.init(trainable)}
        if adapters is not None:
            state['lora'] = adapters
        return state

    # -- train step --------------------------------------------------------

    def _grads(self, state: Dict[str, Any], tokens
               ) -> Tuple[Dict[str, torch.Tensor], Any]:
        """Gradients of the loss with respect to the trainable tree (the
        params, or with LoRA the adapters, the loss then running on the
        merged params), and the step's metrics."""
        cfg = self.cfg
        lora = cfg.lora
        trainable = state['params'] if lora is None else state['lora']
        leaves = optim.tree_leaves(trainable)

        def one(toks):
            params = (state['params'] if lora is None else
                      lora_lib.merge(state['params'], trainable, lora))
            loss, metrics = llama.loss_fn(params, toks, cfg.model,
                                          remat=cfg.remat,
                                          remat_policy=cfg.remat_policy)
            grads = torch.autograd.grad(loss, leaves)
            return {k: v.detach() for k, v in metrics.items()}, grads

        a = cfg.accum_steps
        if a == 1:
            metrics, grads = one(tokens)
        else:
            # One microbatch's activations live at a time; grads and
            # metrics are summed in fp32 and averaged back.
            g_sum, m_sum = None, None
            for chunk in tokens.reshape(a, tokens.shape[0] // a,
                                        tokens.shape[1]):
                m, g = one(chunk)
                if g_sum is None:
                    g_sum = [x.float() for x in g]
                    m_sum = {k: v.float() for k, v in m.items()}
                else:
                    for acc, x in zip(g_sum, g):
                        acc.add_(x.float())
                    for k, v in m.items():
                        m_sum[k] = m_sum[k] + v.float()
                del g
            grads = [(x / a).to(p.dtype) for x, p in zip(g_sum, leaves)]
            metrics = {k: v / a for k, v in m_sum.items()}
            # exp is nonlinear: perplexity from the mean loss.
            metrics['perplexity'] = torch.exp(metrics['loss'])
        it = iter(grads)
        return optim.tree_map(lambda _: next(it), trainable), metrics

    def step(self, state: Dict[str, Any], tokens: Any
             ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        """One optimizer step over a [global_batch, S] batch of token ids
        (numpy or torch). Updates the trainable tree (``state['params']``,
        or with LoRA ``state['lora']``) in place."""
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.from_numpy(np.asarray(tokens))
        tokens = tokens.to(self.device)
        trainable = (state['params'] if self.cfg.lora is None
                     else state['lora'])
        grads, metrics = self._grads(state, tokens)
        with torch.no_grad():
            updates, opt_state = self.optimizer.update(
                grads, state['opt_state'], trainable)
            optim.apply_updates(trainable, updates)
            metrics['grad_norm'] = optim.global_norm(grads)
        return {**state, 'step': state['step'] + 1,
                'opt_state': opt_state}, metrics

    def train(self, state: Dict[str, Any], batches: Iterable,
              log_every: int = 10,
              callback: Optional[Callable[[int, Dict], None]] = None):
        metrics: Dict[str, torch.Tensor] = {}
        for i, tokens in enumerate(batches):
            state, metrics = self.step(state, tokens)
            if callback is not None and (i + 1) % log_every == 0:
                callback(i + 1, {k: float(v) for k, v in metrics.items()})
        return state, metrics


def fold_in(seed: int, data: int) -> int:
    """A new generator seed from (seed, data): the counterpart of
    ``jax.random.fold_in`` for ``torch.Generator`` seeds (distinct,
    deterministic streams; not JAX's values)."""
    digest = hashlib.blake2b(f'{seed}:{data}'.encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, 'little') >> 1


def tokens_per_step(cfg: TrainerConfig) -> int:
    return cfg.global_batch_size * (cfg.seq_len - 1)


def model_flops_per_step(cfg: TrainerConfig) -> float:
    """6*N*T model FLOPs (fwd+bwd), the JAX package's accounting."""
    return 6.0 * cfg.model.param_count * tokens_per_step(cfg)


def mfu(cfg: TrainerConfig, step_s: float) -> float:
    """Model FLOP/s as a share of the H100's dense bf16 peak."""
    return model_flops_per_step(cfg) / step_s / H100_BF16_DENSE_FLOPS
