"""Pipeline parallelism: the GPipe schedule over stages of the layer stack.

Port of ``skypilot_tpu/parallel/pipeline.py``. The layers split into
``S`` contiguous stages (``split_stages``); ``M`` microbatches go
through them in ``M + S - 1`` ticks, and at tick ``i`` stage ``s``
holds microbatch ``i - s`` (valid when ``0 <= i - s < M``). The stages'
aux losses are summed over the valid (stage, microbatch) pairs only, so
a regulariser such as MoE's balance loss stays exact.

``pipeline_apply`` has two forms:

* One process (no mesh, or a mesh whose ``pipe`` is 1): every stage's
  layers are here, stacked on a leading stage dim, and each tick runs
  the valid stages one after another (JAX vmaps them). Plain autograd
  differentiates it; the results are JAX's on one device.
* Ranks over ``pipe``: with ``k = ceil(S / pipe)``, rank p holds the
  layers of stages ``p*k .. min(p*k + k, S) - 1`` (``stage_block``: JAX
  shards the stage dim over ``pipe``, padding it to a multiple of
  ``pipe`` where it does not divide, so the last ranks hold fewer stages,
  or none). At each tick a rank runs its valid stages one after another;
  its stage j's output feeds its stage j + 1 at the next tick in memory,
  and only its last stage's output crosses to the next rank: after each
  tick but the last, every rank hands it over (``collectives.ppermute_ring``
  over ``pipe``, JAX's roll of the stage dim). A bubble computes nothing
  but still sends (zeros), so every rank issues the same collectives in
  the same order. The schedule is one ``torch.autograd.Function``: the
  forward keeps each valid (tick, stage) graph, and the backward walks
  the ticks in reverse, takes each stage's gradients from its graph and
  hands the gradient of its input to the stage before it: in memory, or
  to the previous rank by the inverse rotation. The first stage's
  inputs (the microbatches) and the last stage's outputs are real on
  those ranks; elsewhere the outputs are zeros and the microbatches only
  give the shapes.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

from skypilot_tpu_torch.parallel import collectives

StageFn = Callable[[Any, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    return [tree]


def tree_rebuild(tree: Any, leaves) -> Any:
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def split_stages(stacked_params: Any, num_stages: int) -> Any:
    """Layer-stacked leaves ``[L, ...]`` -> ``[S, L // S, ...]``: layer l
    lands on stage ``l // (L // S)``, contiguous layers per stage."""

    def reshape(p):
        length = p.shape[0]
        if length % num_stages:
            raise ValueError(
                f'{length} layers not divisible by {num_stages} stages')
        return p.reshape((num_stages, length // num_stages)
                         + tuple(p.shape[1:]))

    return _tree_map(reshape, stacked_params)


def stage_block(num_stages: int, ranks: int, index: int) -> Tuple[int, int]:
    """(first stage, stage count) of rank ``index`` of ``ranks``: blocks
    of ``ceil(num_stages / ranks)`` consecutive stages, as JAX's stage dim
    padded to a multiple of the ranks splits; the last ranks hold fewer
    stages, or none."""
    k = -(-num_stages // ranks)
    first = min(index * k, num_stages)
    return first, min(k, num_stages - first)


def stage_rows(n_layers: int, num_stages: int, ranks: int
               ) -> List[Tuple[int, int]]:
    """Each rank's (first layer, end layer) of the stack: the layers of
    its ``stage_block``, ``n_layers // num_stages`` a stage."""
    per = n_layers // num_stages
    out = []
    for index in range(ranks):
        first, count = stage_block(num_stages, ranks, index)
        out.append((first * per, (first + count) * per))
    return out


def _valid(stage: int, tick: int, num_micro: int) -> bool:
    return stage <= tick < stage + num_micro


def pipeline_apply(stage_fn: StageFn, stage_params: Any,
                   microbatches: torch.Tensor, *, num_stages: int,
                   mesh=None, axis: str = 'pipe'
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``microbatches`` ``[M, mb, ...]`` through the stages; returns
    ``(outputs [M, mb, ...], aux)``, ``aux`` the float32 sum of
    ``stage_fn``'s aux over the valid (stage, microbatch) pairs.

    ``stage_fn(params, x_mb) -> (y_mb, aux_scalar)`` applies one stage's
    layers to one microbatch. With no ``pipe`` ranks, ``stage_params``
    carries a leading stage dim on every leaf (``split_stages``). Over
    ``pipe`` ranks it is this rank's layers of its block of the stages
    (``stage_block``; no layers on a rank that holds none); the outputs
    are real on the last stage's rank (zeros elsewhere) and ``aux`` is
    the sum over this rank's stages; every rank of the axis must call
    it."""
    if mesh is None or mesh.shape[axis] == 1:
        return _local(stage_fn, stage_params, microbatches, num_stages)
    return _Pipeline.apply(stage_fn, stage_params, mesh, axis, microbatches,
                           num_stages, *tree_leaves(stage_params))


def _local(stage_fn: StageFn, stage_params: Any,
           microbatches: torch.Tensor, num_stages: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every stage in this process: JAX's scan of ticks, the stages of a
    tick one after another and bubbles skipped."""
    num_micro = microbatches.shape[0]
    stages = [_tree_map(lambda p, s=s: p[s], stage_params)
              for s in range(num_stages)]
    buffer: List[Any] = [None] * num_stages
    outputs: List[Any] = [None] * num_micro
    aux = microbatches.new_zeros((), dtype=torch.float32)
    for i in range(num_micro + num_stages - 1):
        buffer[0] = microbatches[min(i, num_micro - 1)]
        out: List[Any] = [None] * num_stages
        tick_aux = None
        for s in range(num_stages):
            if _valid(s, i, num_micro):
                out[s], a = stage_fn(stages[s], buffer[s])
                tick_aux = a if tick_aux is None else tick_aux + a
        aux = aux + tick_aux
        if i >= num_stages - 1:
            outputs[i - (num_stages - 1)] = out[-1]
        buffer = [out[-1]] + out[:-1]  # stage s's output feeds stage s + 1
    return torch.stack(outputs), aux


class _Pipeline(torch.autograd.Function):
    """The GPipe schedule over ``pipe`` ranks (see the module docstring)."""

    @staticmethod
    def forward(ctx, stage_fn: StageFn, tree: Any, mesh, axis: str,
                microbatches: torch.Tensor, num_stages: int, *leaves):
        p, n = mesh.axis_index(axis), mesh.shape[axis]
        first, k = stage_block(num_stages, n, p)
        num_micro = microbatches.shape[0]
        ticks = num_micro + num_stages - 1
        params = [t.detach().requires_grad_(t.requires_grad) for t in leaves]
        outputs = torch.zeros_like(microbatches)
        aux = microbatches.new_zeros((), dtype=torch.float32)
        saved = {}
        received = None
        held: List[Any] = [None] * k  # each local stage's last output
        with torch.enable_grad():
            # The rank's stages: views of its layers, inside the graph.
            local = split_stages(tree_rebuild(tree, params), k) if k else None
            stages = [_tree_map(lambda t, j=j: t[j], local)
                      for j in range(k)]
            for i in range(ticks):
                outs: List[Any] = [None] * k
                for j in range(k):
                    s = first + j
                    if not _valid(s, i, num_micro):
                        continue
                    if j > 0:  # the rank's previous stage, last tick
                        src = held[j - 1]
                    else:
                        src = (microbatches[i].detach() if p == 0
                               else received)
                    x = src.detach().requires_grad_(True)
                    y, a = stage_fn(stages[j], x)
                    saved[i, j] = (x, y, a)
                    outs[j] = y.detach()
                    aux = aux + a.detach().float()
                    if s == num_stages - 1:
                        outputs[i - s] = outs[j]
                held = outs
                if i < ticks - 1:  # a bubble sends zeros
                    out = (outs[-1] if k and outs[-1] is not None
                           else torch.zeros_like(microbatches[0]))
                    received = collectives.ppermute_ring(out, mesh, axis)
        ctx.mesh, ctx.axis, ctx.saved, ctx.params = mesh, axis, saved, params
        ctx.num_stages = num_stages
        return outputs, aux

    @staticmethod
    def backward(ctx, g_outputs, g_aux):
        mesh, axis, saved, params = ctx.mesh, ctx.axis, ctx.saved, ctx.params
        num_stages = ctx.num_stages
        p, n = mesh.axis_index(axis), mesh.shape[axis]
        first, k = stage_block(num_stages, n, p)
        ticks = g_outputs.shape[0] + num_stages - 1
        trainable = [t for t in params if t.requires_grad]
        g_micro = torch.zeros_like(g_outputs)
        zero = torch.zeros_like(g_outputs[0])
        g_send = zero
        g_held: List[Any] = [None] * k  # each stage's input grad, tick + 1
        for i in reversed(range(ticks)):
            # The gradient of the rank's last stage's output: the next
            # rank's first stage's input gradient at tick i + 1 (the
            # inverse of the tick's hand-over).
            g_recv = (collectives.ppermute_ring(g_send, mesh, axis, shift=-1)
                      if i < ticks - 1 else zero)
            g_send = zero
            g_in: List[Any] = [None] * k
            for j in reversed(range(k)):
                if (i, j) not in saved:
                    continue
                x, y, a = saved.pop((i, j))
                s = first + j
                if s == num_stages - 1:  # the loss's
                    g_out = g_outputs[i - s]
                elif j == k - 1:
                    g_out = g_recv
                else:  # the rank's next stage's, in memory
                    g_out = g_held[j + 1]
                outs, grads = [y], [g_out]
                if a.requires_grad:
                    outs.append(a)
                    grads.append(g_aux.to(a.dtype))
                torch.autograd.backward(outs, grads, inputs=[x] + trainable)
                if j > 0:
                    g_in[j] = x.grad
                elif p == 0:  # the first stage's input is the microbatch
                    g_micro[i] = x.grad
                else:
                    g_send = x.grad
            g_held = g_in
        ctx.saved = None
        return (None, None, None, None, g_micro, None, *[
            t.grad if t.requires_grad else None for t in params])
