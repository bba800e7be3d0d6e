"""Training loop: train state and the train step, on one device or over
a mesh of ranks.

Port of ``skypilot_tpu/train/trainer.py``. JAX's jitted step over a mesh
becomes an eager step: ``loss_fn`` forward and backward (flash attention
K1-K3 on the card), then the optax chain of ``train/optim.py`` applied
in place. An MoE model trains like a dense one on one device; its
metrics carry ``moe_aux``, and LoRA adapts its attention only.

With ``mesh=`` (``parallel/mesh.py``: one process per rank, every rank
constructs the same ``Trainer`` and calls the same methods) the state
holds this rank's slices of every leaf, placed by
``llama.param_logical_axes`` (and ``lora.lora_logical_axes``) under
``rules`` (JAX's by default): ``init_state`` draws whole leaves and keeps
the slices, so a mesh starts from the one-device weights of the same
seed; the optimizer state mirrors the slices. ``step`` takes the GLOBAL
batch and keeps this rank's rows (``sharding.batch_rows``; under a
pipeline its block of each microbatch, so that a microbatch is JAX's
rows), whole: a ``seq`` rank keeps its block of positions inside the
forward. The loss runs the sharded forward (``llama.loss_fn(mesh=)``,
over every axis: ``data``, ``fsdp``, ``tensor``, ring attention over
``seq``, the MoE experts over ``expert``, one pipeline stage a ``pipe``
rank). Each gradient is summed over ``data`` and ``seq`` (a rank's rows
and positions), over ``fsdp`` unless its leaf is split there (whose
gathers reduce-scatter it already), and over ``pipe`` unless its leaf is
split there (the embedding, the final norm and the head: only the stage
that uses one has a gradient for it); never over ``expert`` or
``tensor``, whose values enter split work through ``copy_to`` and come
back summed. The optimizer's reductions are global (``optim.Chain.shard``
counts each element once). The metrics, ``grad_norm`` included, are the
global ones, equal on every rank. ``host_view`` and ``load_host_view``
carry a state to and from whole arrays (checkpoints), leaves split over
``pipe`` and ``expert`` included. ``check_mesh`` raises JAX's
``ValueError`` for a config that does not split over the mesh.

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
    ``device='cpu'``), or on this rank's slices of a ``mesh`` (then on
    ``mesh.device``)."""

    def __init__(self, cfg: TrainerConfig, device: DeviceLike = None,
                 mesh=None, rules=None):
        self.cfg = cfg
        self.mesh = mesh
        self.optimizer = make_optimizer(cfg)
        if mesh is None:
            self.device = resolve_device(device)
            self.rules = None
            return
        from skypilot_tpu_torch.parallel import sharding as sharding_lib
        self.device = mesh.device
        self.rules = rules or sharding_lib.ShardingRules()
        check_mesh(cfg, mesh.shape, self.rules)
        self.param_shardings = sharding_lib.sharding_tree(
            llama.param_logical_axes(cfg.model), mesh, self.rules)
        self.lora_shardings = None
        trainable = self.param_shardings
        if cfg.lora is not None:
            self.lora_shardings = sharding_lib.sharding_tree(
                lora_lib.lora_logical_axes(cfg.model, cfg.lora), mesh,
                self.rules)
            trainable = self.lora_shardings
        self.trainable_shardings = trainable
        self.optimizer.shard(mesh, trainable)

    # -- state init --------------------------------------------------------

    def init_state(self, seed: int = 0) -> Dict[str, Any]:
        """Random weights from ``seed`` (``torch.Generator``: not the
        values ``jax.random`` gives for the same seed); with LoRA, the
        adapters from a generator seeded with ``fold_in(seed, 1)``, as
        JAX draws them from ``fold_in(key, 1)``. On a mesh, this rank's
        slices of the same weights."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if self.mesh is None:
            params = llama.init_params(self.cfg.model, gen, self.device)
        else:
            params = llama.init_params_sharded(
                self.cfg.model, gen, self.mesh, self.rules, self.device)
        return self._state(params, seed)

    def init_state_from_numpy(self, tree: Any,
                              lora: Any = None) -> Dict[str, Any]:
        """Start from a JAX weight tree and, with LoRA, a JAX adapter tree
        (``init_lora``'s from seed 0 when None), given as numpy arrays
        (whole leaves; on a mesh each rank keeps its slices)."""
        if self.mesh is None:
            params = llama.params_from_numpy(tree, self.cfg.model,
                                             self.device)
        else:
            params = self._slices(llama.params_from_numpy(
                tree, self.cfg.model, 'cpu'), self.param_shardings)
        return self._state(params, 0, lora)

    def _slices(self, tree: Any, shardings: Any) -> Any:
        """This rank's slices of whole host leaves, on its device."""
        from skypilot_tpu_torch.parallel import sharding as sharding_lib
        return optim.tree_map(
            lambda t, sh: sharding_lib.local_slice(t, sh).to(self.device),
            tree, shardings)

    def _state(self, params, seed: int, lora: Any = None) -> Dict[str, Any]:
        adapters = None
        if self.cfg.lora is not None:
            if lora is None:
                gen = torch.Generator(device=self.device).manual_seed(
                    fold_in(seed, 1))
                if self.mesh is None:
                    adapters = lora_lib.init_lora(gen, params, self.cfg.lora,
                                                  device=self.device)
                else:
                    adapters = lora_lib.init_lora_sharded(
                        gen, self.cfg.model, self.cfg.lora, self.mesh,
                        self.rules, device=self.device)
            else:
                lora_lib._check_targets(params['layers'],  # noqa: SLF001
                                        self.cfg.lora.targets)
                if self.mesh is None:
                    adapters = lora_lib.lora_from_numpy(lora, self.device)
                else:
                    adapters = self._slices(lora_lib.lora_from_numpy(
                        lora, 'cpu'), self.lora_shardings)
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
        mesh = self.mesh
        trainable = state['params'] if lora is None else state['lora']
        leaves = optim.tree_leaves(trainable)

        def one(toks):
            params = (state['params'] if lora is None else
                      lora_lib.merge(state['params'], trainable, lora,
                                     mesh, self.rules))
            if mesh is not None:
                toks = self._rows(toks)
            loss, metrics = llama.loss_fn(params, toks, cfg.model,
                                          remat=cfg.remat,
                                          remat_policy=cfg.remat_policy,
                                          mesh=mesh, rules=self.rules)
            # A pipe stage does not use every leaf (the embedding is stage
            # 0's, the head the last stage's): its gradient there is 0.
            staged = mesh is not None and mesh.shape['pipe'] > 1
            grads = torch.autograd.grad(loss, leaves, allow_unused=staged,
                                        materialize_grads=staged)
            return {k: v.detach() for k, v in metrics.items()}, grads

        a = cfg.accum_steps
        if a == 1:
            metrics, grads = one(tokens)
            grads = self._sum_over_batch(state, grads)
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
            g_sum = self._sum_over_batch(state, g_sum)
            grads = [(x / a).to(p.dtype) for x, p in zip(g_sum, leaves)]
            metrics = {k: v / a for k, v in m_sum.items()}
            # exp is nonlinear: perplexity from the mean loss.
            metrics['perplexity'] = torch.exp(metrics['loss'])
        it = iter(grads)
        return optim.tree_map(lambda _: next(it), trainable), metrics

    def _rows(self, tokens: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch, on its device: under a
        pipeline, its block of each microbatch in turn."""
        from skypilot_tpu_torch.parallel import sharding as sharding_lib
        micro = _microbatches(self.cfg.model, self.mesh.shape)
        groups = tokens.reshape(micro, tokens.shape[0] // micro,
                                *tokens.shape[1:])
        return torch.cat([sharding_lib.batch_rows(g, self.mesh, self.rules)
                          for g in groups]).to(self.device)

    def _sum_over_batch(self, state, grads):
        """On a mesh: each gradient summed over ``data`` and ``seq``, and
        over ``fsdp`` and ``pipe`` where its leaf is not split there (the
        gathers of an fsdp-split leaf reduce-scatter its gradient
        already; a pipe-split leaf is its stage's own)."""
        if self.mesh is None:
            return grads
        from skypilot_tpu_torch.parallel import collectives
        from skypilot_tpu_torch.parallel import sharding as sharding_lib
        trainable = self.trainable_shardings
        shards = [s for _, s in optim.paired_leaves(
            state['params'] if self.cfg.lora is None else state['lora'],
            trainable)]
        axes = [tuple(a for a in ('data', 'fsdp', 'seq', 'pipe')
                      if a not in sharding_lib.spec_axes(s.spec))
                for s in shards]
        return collectives.psum_grads(list(grads), axes, self.mesh)

    def step(self, state: Dict[str, Any], tokens: Any
             ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        """One optimizer step over a [global_batch, S] batch of token ids
        (numpy or torch). Updates the trainable tree (``state['params']``,
        or with LoRA ``state['lora']``) in place."""
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.from_numpy(np.asarray(tokens))
        if self.mesh is None:
            tokens = tokens.to(self.device)
        trainable = (state['params'] if self.cfg.lora is None
                     else state['lora'])
        grads, metrics = self._grads(state, tokens)
        with torch.no_grad():
            updates, opt_state = self.optimizer.update(
                grads, state['opt_state'], trainable)
            optim.apply_updates(trainable, updates)
            metrics['grad_norm'] = optim.global_norm(
                grads, self.optimizer.specs, self.mesh)
        return {**state, 'step': state['step'] + 1,
                'opt_state': opt_state}, metrics

    # -- whole arrays (checkpoints) -----------------------------------------

    def state_shardings(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """A tree like ``state`` whose tensor leaves are replaced by their
        ``NamedSharding`` (None for the ints): the params', the
        adapters', and the optimizer state's, which mirror the trainable
        leaves' (a factored second moment drops the dim it is a mean
        over)."""
        from skypilot_tpu_torch.parallel import sharding as sharding_lib
        trainable = self.trainable_shardings
        key = 'params' if self.cfg.lora is None else 'lora'

        def stats(sh, leaf, p):
            if 'v' in leaf:
                return {'v': sh}
            d1, d0 = optim.factored_dims(
                sharding_lib.global_shape(p.shape, sh))
            drop = lambda d: sharding_lib.NamedSharding(  # noqa: E731
                sh.mesh, sh.spec[:d] + sh.spec[d + 1:])
            return {'v_row': drop(d0), 'v_col': drop(d1)}

        def opt(node):
            if isinstance(node, (list, tuple)):
                return type(node)(opt(n) for n in node)
            out = {'count': None}
            if 'stats' in node:
                out['stats'] = optim.tree_map(stats, trainable,
                                              node['stats'], state[key])
            if 'mu' in node:
                out['mu'] = out['nu'] = trainable
            return out

        out = {'step': None, 'params': self.param_shardings,
               'opt_state': opt(state['opt_state'])}
        if self.cfg.lora is not None:
            out['lora'] = self.lora_shardings
        return out

    def host_view(self, state: Dict[str, Any], ranks_per_host: int
                  ) -> Dict[str, Any]:
        """``state`` with every leaf whole (gathered over the mesh), as
        one process holds it in JAX; a collective every rank calls. A
        leaf no axis splits is the state's own tensor, not a copy. A
        leaf split over an axis that crosses hosts (of
        ``ranks_per_host`` ranks each) raises JAX's ``CheckpointError``:
        a host's view of it is not whole."""
        from skypilot_tpu_torch.ckpt.manifest import CheckpointError
        from skypilot_tpu_torch.parallel import sharding as sharding_lib
        for name, tree in (('params', self.param_shardings),
                           ('lora', self.lora_shardings)):
            for path, sh in _named(tree, f"['{name}']"):
                crossing = [a for a in sharding_lib.spec_axes(sh.spec)
                            if sharding_lib.crosses_hosts(
                                self.mesh, a, ranks_per_host)]
                if crossing:
                    raise CheckpointError(
                        f'cannot snapshot {path!r}: array is sharded across '
                        'hosts (not fully addressable). The native '
                        'checkpoint path currently supports host-replicated '
                        f'state only (here it is split over {crossing}; the '
                        "JAX package's orbax codec, which writes such "
                        'arrays, needs JAX).')
        with torch.no_grad():
            return _zip_map(
                lambda t, sh: t if sh is None else
                sharding_lib.gather(t.detach(), sh),
                state, self.state_shardings(state))

    def host_template(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """A tree like ``host_view(state)`` of empty host tensors (whole
        shapes), for a checkpoint to be read into."""
        from skypilot_tpu_torch.parallel import sharding as sharding_lib
        return _zip_map(
            lambda t, sh: t if sh is None else torch.empty(
                sharding_lib.global_shape(t.shape, sh), dtype=t.dtype),
            state, self.state_shardings(state))

    def load_host_view(self, state: Dict[str, Any],
                       whole: Dict[str, Any]) -> Dict[str, Any]:
        """Write this rank's slices of ``whole`` (a restored
        ``host_template``) into ``state``'s tensors in place; returns the
        state with ``whole``'s ints (the step and the counts)."""
        from skypilot_tpu_torch.parallel import sharding as sharding_lib

        def put(t, sh, w):
            if sh is None:
                return w
            with torch.no_grad():
                t.copy_(sharding_lib.local_slice(w, sh))
            return t
        return _zip_map(put, state, self.state_shardings(state), whole)

    def train(self, state: Dict[str, Any], batches: Iterable,
              log_every: int = 10,
              callback: Optional[Callable[[int, Dict], None]] = None):
        metrics: Dict[str, torch.Tensor] = {}
        for i, tokens in enumerate(batches):
            state, metrics = self.step(state, tokens)
            if callback is not None and (i + 1) % log_every == 0:
                callback(i + 1, {k: float(v) for k, v in metrics.items()})
        return state, metrics


def _microbatches(model: llama.LlamaConfig, sizes: Dict[str, int]) -> int:
    """The pipeline's microbatches (1 without one)."""
    if sizes['pipe'] > 1 or model.pipeline_stages > 1:
        return max(model.pipeline_microbatches, 1)
    return 1


def check_mesh(cfg: TrainerConfig, sizes: Dict[str, int],
               rules=None) -> None:
    """JAX's ``ValueError`` where ``cfg`` does not split over a mesh of
    axis ``sizes``: the layers over ``pipe`` (``llama.check_mesh``), a
    step's batch into the pipeline's microbatches (JAX's words) and each
    of those over the batch axes, the sequence over ``seq``, the experts
    over ``expert``. Other dims that do not split (heads, vocab) raise
    when the weights are placed (``sharding.local_shape``)."""
    from skypilot_tpu_torch.parallel import sharding as sharding_lib
    rules = rules or sharding_lib.ShardingRules()
    llama.check_mesh(cfg.model, sizes)
    batch = sharding_lib.spec_axes(rules.mesh_axes(('batch',)))
    shards = int(np.prod([sizes[a] for a in batch]))
    rows = cfg.global_batch_size // cfg.accum_steps
    micro = _microbatches(cfg.model, sizes)
    if rows % micro:
        raise ValueError(f'batch {rows} not divisible by {micro} '
                         'microbatches')
    if rows // micro % shards:
        raise ValueError(f'global batch {rows} does not split over {batch} '
                         f'({shards} shards) in each of {micro} '
                         'microbatch(es)')
    if cfg.seq_len % sizes['seq']:
        raise ValueError(f'sequence length {cfg.seq_len} does not split '
                         f'over seq ({sizes["seq"]} shards)')


def _zip_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *others)`` over trees of dicts, lists and tuples that
    share ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _named(tree: Any, path: str):
    """(keystr path, leaf) for every leaf of a tree of dicts."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f'{path}[{k!r}]')
    else:
        yield path, tree


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
