"""Collectives over a mesh axis, their self-test and their benchmark.

Port of ``skypilot_tpu/parallel/collectives.py``: ``verify_collectives``
(sum, all-gather and ring permute on every axis larger than 1, with JAX's
expected values) and ``allreduce_benchmark`` (nccl-tests' algbw and busbw:
for all-reduce over n ranks, busbw = algbw * 2 * (n - 1) / n), which the
``examples/tpu_comm_test.yaml`` recipe runs.

JAX's GSPMD inserts the model's collectives itself; the port issues them
by hand through ``psum``, ``pmax`` and ``all_gather`` here, which the
sharded forward (``models/generate.py``) and quantization call. Training
differentiates through them: ``gather_fsdp`` (all-gather forward,
reduce-scatter backward: an fsdp shard of a parameter), ``copy_to``
(identity forward, ``psum`` backward: a replicated activation entering a
column-split product), ``reduce_from`` (``psum`` forward, identity
backward: a row-split product's partial sums) and ``psum_grads`` (the
gradient all-reduce over the batch axes) are JAX's transpose rules for
the collectives GSPMD would insert. On an axis of size 1 each returns its
input.

On a gloo mesh whose ranks compute on CUDA (``Mesh.stages_on_host``)
every collective stages through host memory, and the copies wait for
the device, so such a rank runs serially. Ranks share a card only when
they share a host, but a group of several hosts' ranks (``data`` across
slices, say) may still span machines. So a group's first staged call
asks whether all its ranks run on one machine (``_open_arena``). If they
do, the group goes through an arena of shared host memory (``_Arena``):
each rank copies its input into its slot, waits at the group's gloo
barrier, and copies the slots it needs back to the card, where a sum is
taken in one fixed order, so every rank gets the same bits; gloo's own
transfers over loopback were 4-10 times slower (PERF.md section 6). If
they do not, each call copies its input to the host and runs gloo's
collective on that copy. The arena exists only for ranks that share a
card: NCCL meshes and CPU tensors never use it. ``STATS`` counts the calls, their bytes
(this rank's input) and their host seconds, in all and per kind (with
staging, the seconds include the wait for the device; with NCCL, only
the issue). A failed collective raises ``CollectiveError``: a gang that
lost a rank cannot go on in lockstep.
"""
from __future__ import annotations

import os
import socket
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

STATS: Dict = {'calls': 0, 'seconds': 0.0, 'bytes': 0, 'by_kind': {}}


class CollectiveError(RuntimeError):
    """A collective failed: a peer died, hung past the group's timeout or
    refused the operation."""


def reset_stats() -> None:
    STATS.update(calls=0, seconds=0.0, bytes=0, by_kind={})


def _timed(what: str, fn, kind: str = 'other', nbytes: int = 0):
    t0 = time.perf_counter()
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 -- any backend error is fatal here
        raise CollectiveError(f'{what} failed: {exc}') from exc
    finally:
        dt = time.perf_counter() - t0
        STATS['calls'] += 1
        STATS['seconds'] += dt
        STATS['bytes'] += nbytes
        k = STATS['by_kind'].setdefault(
            kind, {'calls': 0, 'bytes': 0, 'seconds': 0.0})
        k['calls'] += 1
        k['bytes'] += nbytes
        k['seconds'] += dt


# The flat-tensor reduce-scatter (named ``reduce_scatter_tensor`` before
# PyTorch 2.13, which deprecates that name).
_reduce_scatter_single = getattr(dist, 'reduce_scatter_single',
                                 dist.reduce_scatter_tensor)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _to_medium(x: torch.Tensor, mesh) -> torch.Tensor:
    if mesh.stages_on_host:
        return x.contiguous().to('cpu', copy=True)
    return x.contiguous().clone()


def _machine() -> str:
    """The name of the machine this rank runs on."""
    return socket.gethostname()


class _Arena:
    """Host memory shared by the ranks of one group on one machine: a
    file in the temporary directory, mapped by each rank and unlinked
    once all have mapped it, in two halves used by turns, each with a
    slot per rank. A collective copies the rank's input into its slot of
    this turn's half, waits at the group's barrier, and reads the slots
    it needs: one barrier a call, since a rank writes a half again only
    after the next call's barrier, which every peer enters after its
    reads of that half."""

    def __init__(self, mem: torch.Tensor, index: int, n: int, cap: int):
        self.mem, self.index, self.n, self.cap, self.turn = mem, index, n, cap, 0

    def slot(self, half: int, i: int, nbytes: int) -> torch.Tensor:
        start = (half * self.n + i) * self.cap
        return self.mem[start:start + nbytes]


def _open_arena(group, index: int, n: int, cap: int) -> Optional[_Arena]:
    """The group's arena of ``cap`` bytes a slot (a collective of the
    group), or None when its ranks do not all run on one machine: the
    group's first rank makes the file, and the others map it only when
    they see that file and run on that rank's machine, which every rank
    must for any of them to use it."""
    import tempfile
    import uuid
    size = 2 * n * cap
    where = [None, _machine()]
    if index == 0:
        where[0] = os.path.join(tempfile.gettempdir(),
                                f'skytorch-arena-{uuid.uuid4().hex}')
        mem = torch.from_file(where[0], shared=True, size=size,
                              dtype=torch.uint8)
    dist.broadcast_object_list(where, src=dist.get_global_rank(group, 0),
                               group=group)
    path, machine = where
    here = (index == 0 or (machine == _machine() and os.path.isfile(path)
                           and os.path.getsize(path) == size))
    seen: List[Optional[bool]] = [None] * n
    dist.all_gather_object(seen, here, group=group)
    if index != 0 and all(seen):
        mem = torch.from_file(path, shared=True, size=size, dtype=torch.uint8)
    dist.barrier(group=group)
    if index == 0:
        os.unlink(path)
    return _Arena(mem, index, n, cap) if all(seen) else None


def _arena(group, mesh, axis: str, nbytes: int) -> Optional[_Arena]:
    """The group's arena (kept on the mesh; False there for a group that
    spans machines), made anew (a collective of the group) when a call
    needs more than it holds; every rank of the group asks for the same
    sizes in the same order."""
    arena = mesh.arenas.get(axis)
    if arena is False:
        return None
    if arena is None or arena.cap < nbytes:
        cap = max(nbytes, 2 * arena.cap if arena else 1 << 20)
        mesh.arenas[axis] = None  # the old mapping goes before the new one
        arena = _open_arena(group, mesh.axis_index(axis), mesh.shape[axis],
                            cap)
        mesh.arenas[axis] = arena if arena is not None else False
    return arena


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.uint8)


def _shared(x: torch.Tensor, mesh, axis: str, read):
    """A collective through the group's arena, or None when the mesh does
    not stage through the host or the group spans machines: this rank's
    ``x`` into its slot, the barrier, then ``read(slots, arena)`` on this
    rank's device, ``slots(i, start, nbytes)`` giving a device copy of
    rank i's bytes."""
    if not mesh.stages_on_host:
        return None
    group = mesh.group(axis)
    raw = _bytes(x)
    arena = _arena(group, mesh, axis, raw.numel())
    if arena is None:
        return None
    half, arena.turn = arena.turn, arena.turn ^ 1
    arena.slot(half, arena.index, raw.numel()).copy_(raw)
    dist.barrier(group=group)

    def slots(i, start=0, nbytes=raw.numel()):
        out = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
        return out.copy_(arena.slot(half, i, start + nbytes)[start:])
    return read(slots, arena)


def _reduce(x: torch.Tensor, mesh, axis: str, op) -> torch.Tensor:
    group = mesh.group(axis)
    if group is None:
        return x
    kind = 'all_reduce' if op == dist.ReduceOp.SUM else 'all_reduce_max'

    def read(slots, arena):
        parts = torch.stack([slots(i).view(x.dtype) for i in range(arena.n)])
        out = (parts.sum(0, dtype=x.dtype)
               if op == dist.ReduceOp.SUM else parts.amax(0))
        return out.view(x.shape)

    def run():
        out = _shared(x, mesh, axis, read)
        if out is not None:
            return out
        y = _to_medium(x, mesh)
        dist.all_reduce(y, op=op, group=group)
        return y.to(x.device)
    return _timed(f'all_reduce over {axis}', run, kind, _nbytes(x))


def psum(x: torch.Tensor, mesh, axis: str = 'tensor') -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (JAX's ``lax.psum``),
    in ``x``'s dtype; every rank gets the same bits."""
    return _reduce(x, mesh, axis, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, mesh, axis: str = 'tensor') -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks of ``axis``."""
    return _reduce(x, mesh, axis, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, mesh, axis: str = 'tensor',
               dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in axis order (JAX's
    ``all_gather(..., tiled=True)``)."""
    group = mesh.group(axis)
    if group is None:
        return x

    def run():
        n = mesh.shape[axis]
        parts = _shared(x, mesh, axis, lambda slots, arena: [
            slots(i).view(x.dtype).view(x.shape) for i in range(n)])
        if parts is not None:
            return torch.cat(parts, dim=dim)
        y = _to_medium(x, mesh)
        out = torch.empty((n,) + tuple(y.shape), dtype=y.dtype,
                          device=y.device)
        dist.all_gather(list(out.unbind(0)), y, group=group)
        return torch.cat(out.unbind(0), dim=dim).to(x.device)
    return _timed(f'all_gather over {axis}', run, 'all_gather', _nbytes(x))


def ppermute_ring(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Shard j receives shard (j - 1) % n's ``x`` (JAX's ``ppermute`` with
    pairs (j, j + 1))."""
    group = mesh.group(axis)
    if group is None:
        return x
    n = mesh.shape[axis]
    j = mesh.axis_index(axis)

    def run():
        out = _shared(x, mesh, axis, lambda slots, arena: slots(
            (j - 1) % n).view(x.dtype).view(x.shape))
        if out is not None:
            return out
        y = _to_medium(x, mesh)
        out = torch.empty_like(y)
        ops = [dist.P2POp(dist.isend, y,
                          dist.get_global_rank(group, (j + 1) % n), group),
               dist.P2POp(dist.irecv, out,
                          dist.get_global_rank(group, (j - 1) % n), group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out.to(x.device)
    return _timed(f'ring permute over {axis}', run, 'ppermute', _nbytes(x))


def reduce_scatter(x: torch.Tensor, mesh, axis: str,
                   dim: int = 0) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``, of which this rank
    keeps its block along ``dim`` (JAX's ``psum_scatter(...,
    tiled=True)``)."""
    group = mesh.group(axis)
    if group is None:
        return x
    n = mesh.shape[axis]

    def run():
        y = x.movedim(dim, 0).contiguous()
        shape = (y.shape[0] // n, *y.shape[1:])

        def read(slots, arena):
            block = _nbytes(y) // n
            parts = torch.stack([
                slots(i, arena.index * block, block).view(y.dtype)
                for i in range(n)])
            return parts.sum(0, dtype=y.dtype).view(shape)
        out = _shared(y, mesh, axis, read)
        if out is None:
            medium = _to_medium(y, mesh)
            out = torch.empty(shape, dtype=y.dtype, device=medium.device)
            _reduce_scatter_single(out, medium, group=group)
        return out.to(x.device).movedim(0, dim)
    return _timed(f'reduce_scatter over {axis}', run, 'reduce_scatter',
                  _nbytes(x))


# -- collectives autograd passes through ------------------------------------


class _GatherFsdp(torch.autograd.Function):
    """All-gather along ``dim`` forward; reduce-scatter of the gradient
    backward (the transpose of an all-gather)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.contiguous(), ctx.mesh, ctx.axis,
                              ctx.dim), None, None, None


class _CopyTo(torch.autograd.Function):
    """Identity forward; ``psum`` of the gradient backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g.contiguous(), ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    """``psum`` forward; identity backward (every rank of the axis goes on
    with the same sum, so each one's gradient is the sum's)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return psum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def gather_fsdp(x: torch.Tensor, mesh, dim: int,
                axis: str = 'fsdp') -> torch.Tensor:
    """A parameter's shard gathered along ``dim`` over ``axis`` for use;
    its gradient comes back reduce-scattered: summed over the axis's
    ranks (their rows of the batch), this rank's block kept."""
    if mesh.group(axis) is None:
        return x
    return _GatherFsdp.apply(x, mesh, axis, dim)


def copy_to(x: torch.Tensor, mesh, axis: str = 'tensor') -> torch.Tensor:
    """``x``, replicated over ``axis``, entering work split over it: the
    gradient is summed over the axis."""
    if mesh.group(axis) is None:
        return x
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh, axis: str = 'tensor') -> torch.Tensor:
    """The sum over ``axis`` of partial results (a row-split product), the
    gradient passed through."""
    if mesh.group(axis) is None:
        return x
    return _ReduceFrom.apply(x, mesh, axis)


def psum_grads(grads: Sequence[torch.Tensor], axes: Sequence[Sequence[str]],
               mesh) -> List[torch.Tensor]:
    """Each gradient summed over its mesh axes (``axes[i]`` for
    ``grads[i]``): the data-parallel all-reduce, one collective per axis
    and dtype over the gradients flattened together."""
    out = list(grads)
    for axis in ('fsdp', 'data'):
        if mesh.group(axis) is None:
            continue
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, (g, ax) in enumerate(zip(out, axes)):
            if axis in ax:
                by_dtype.setdefault(g.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([out[i].reshape(-1) for i in idx])
            flat = psum(flat, mesh, axis)
            for i, part in zip(idx, flat.split([out[i].numel()
                                               for i in idx])):
                out[i] = part.view_as(out[i])
    return out


def psum_scalars(values: Sequence[torch.Tensor],
                 axes: Sequence[Sequence[str]], mesh) -> List[torch.Tensor]:
    """Float32 scalars, each summed over its mesh axes (``axes[i]``), in
    one collective per axis over the values that axis reduces."""
    out = [v.float() for v in values]
    for axis in mesh.axis_names:
        idx = [i for i, ax in enumerate(axes) if axis in ax]
        if not idx or mesh.group(axis) is None:
            continue
        summed = psum(torch.stack([out[i] for i in idx]), mesh, axis)
        for j, i in enumerate(idx):
            out[i] = summed[j]
    return out


def barrier() -> None:
    """Every rank of the default group waits for the others."""
    _timed('barrier', dist.barrier, 'barrier')


def take_turns(mesh, fn):
    """``fn()`` on every rank; ranks that share one card (their
    collectives stage through host memory) run it one at a time and hand
    their freed memory back to the card before the next, so that one
    rank's transient memory is on the card at once."""
    if not mesh.stages_on_host:
        return fn()
    out = None
    for turn in range(dist.get_world_size()):
        if dist.get_rank() == turn:
            out = fn()
            _sync(mesh.device)
            torch.cuda.empty_cache()
        barrier()
    return out


def _sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def allreduce_benchmark(payload_mb: float = 64.0, mesh=None,
                        axis_name: str = 'fsdp',
                        iters: int = 10) -> Dict[str, float]:
    """Time a sum of a payload sharded across ``axis_name``: each rank
    reduces payload / n bytes, the nccl-tests per-rank buffer."""
    if mesh is None:
        from skypilot_tpu_torch.parallel import mesh as mesh_lib
        mesh = mesh_lib.build_mesh()
    n = mesh.shape[axis_name]
    if n == 1:
        return {'ranks': 1, 'payload_mb': payload_mb, 'algbw_gbps': 0.0,
                'busbw_gbps': 0.0, 'note': 'single rank; nothing to reduce'}
    n_elems = int(payload_mb * 1e6 / 4)
    n_elems -= n_elems % n
    per_rank_elems = n_elems // n
    out = torch.ones((per_rank_elems,), dtype=torch.float32,
                     device=mesh.device)
    out = psum(out, mesh, axis_name)
    _sync(mesh.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = psum(out, mesh, axis_name)
    _sync(mesh.device)
    dt = (time.perf_counter() - t0) / iters
    bytes_payload = per_rank_elems * 4
    algbw = bytes_payload / dt / 1e9
    busbw = algbw * 2 * (n - 1) / n
    return {'ranks': n, 'payload_mb': payload_mb,
            'time_per_allreduce_ms': dt * 1e3,
            'algbw_gbps': algbw, 'busbw_gbps': busbw}


def verify_collectives(mesh=None) -> Dict[str, bool]:
    """Correctness smoke of sum / all-gather / ring permute over every mesh
    axis with size > 1: the 'is the fabric sane' check of comm-test
    recipes. Every rank of the mesh must call it."""
    if mesh is None:
        from skypilot_tpu_torch.parallel import mesh as mesh_lib
        mesh = mesh_lib.build_mesh()
    results: Dict[str, bool] = {}
    for axis in mesh.axis_names:
        n = mesh.shape[axis]
        if n == 1:
            continue
        idx = mesh.axis_index(axis)
        x = torch.arange(8, dtype=torch.float32, device=mesh.device)
        mine = torch.full((1,), float(idx), device=mesh.device)
        s = psum(x, mesh, axis).cpu().numpy()
        g = all_gather(mine, mesh, axis, dim=0).cpu().numpy()
        rolled = ppermute_ring(mine, mesh, axis).cpu().numpy()
        results[axis] = bool(
            np.allclose(s, np.arange(8) * n)
            and np.allclose(g, np.arange(n))
            and np.allclose(rolled, [(idx - 1) % n]))
    return results

