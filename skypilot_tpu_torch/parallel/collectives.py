"""Collectives over a mesh axis, their self-test and their benchmark.

Port of ``skypilot_tpu/parallel/collectives.py``: ``verify_collectives``
(sum, all-gather and ring permute on every axis larger than 1, with JAX's
expected values) and ``allreduce_benchmark`` (nccl-tests' algbw and busbw:
for all-reduce over n ranks, busbw = algbw * 2 * (n - 1) / n), which the
``examples/tpu_comm_test.yaml`` recipe runs.

JAX's GSPMD inserts the model's collectives itself; the port issues them
by hand through ``psum``, ``pmax`` and ``all_gather`` here, which the
sharded forward (``models/generate.py``) and quantization call;
``gather_to`` and ``scatter_from`` move KV heads between a serving
replica's ranks and its head (``models/engine.py``: demotes to the KV
tiers and exports gather, promotes and imports scatter), and
``broadcast`` hands what the head's ``data`` index received to the other
``data`` ranks. Training
differentiates through them: ``gather_fsdp`` (all-gather forward,
reduce-scatter backward: an fsdp shard of a parameter), ``copy_to``
(identity forward, ``psum`` backward: a replicated activation entering a
column-split product), ``reduce_from`` (``psum`` forward, identity
backward: a row-split product's partial sums) and ``psum_grads`` (the
gradient all-reduce over the batch axes) are JAX's transpose rules for
the collectives GSPMD would insert, and ``rotate`` (a ring permute whose
gradient takes the inverse rotation: ring attention's K/V hop) is
``ppermute``'s. ``exchange_rows`` (an uneven ``all_to_all`` forward,
the reverse one backward) hands a pipe rank the layers of its stage
block that other ranks hold, where the stages do not split evenly over
``pipe``. On an axis of size 1 each returns its input.

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

import math
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


def _shared(x: torch.Tensor, mesh, axis: str, read, write=None,
            size: Optional[int] = None):
    """A collective through the group's arena, or None when the mesh does
    not stage through the host or the group spans machines: this rank's
    ``x`` into its slot (or ``write(slot)`` fills any slots, ``slot(i)``
    being rank i's bytes of this turn: ``x``'s size, or ``size`` bytes,
    which every rank of the group must pass alike), the barrier, then
    ``read(slots, arena)`` on this rank's device, ``slots(i, start,
    nbytes)`` giving a device copy of rank i's bytes."""
    if not mesh.stages_on_host:
        return None
    group = mesh.group(axis)
    raw = _bytes(x)
    size = raw.numel() if size is None else size
    arena = _arena(group, mesh, axis, size)
    if arena is None:
        return None
    half, arena.turn = arena.turn, arena.turn ^ 1
    if write is None:
        arena.slot(half, arena.index, raw.numel()).copy_(raw)
    else:
        write(lambda i: arena.slot(half, i, size))
    dist.barrier(group=group)

    def slots(i, start=0, nbytes=size):
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


def gather_to(x: torch.Tensor, mesh, axis: str = 'tensor', dim: int = -1,
              dst: int = 0) -> Optional[torch.Tensor]:
    """The ranks' ``x`` (one shape on every rank) concatenated along
    ``dim`` in axis order, on rank ``dst`` of ``axis`` alone; None on
    the others. The serving engine brings its ranks' KV heads to the
    head this way (a demote, an export)."""
    group = mesh.group(axis)
    if group is None:
        return x
    n = mesh.shape[axis]
    mine = mesh.axis_index(axis) == dst

    def run():
        parts = _shared(x, mesh, axis, lambda slots, arena: [
            slots(i).view(x.dtype).view(x.shape) for i in range(n)]
            if mine else [])
        if parts is not None:
            return torch.cat(parts, dim=dim) if mine else None
        y = _to_medium(x, mesh)
        out = [torch.empty_like(y) for _ in range(n)] if mine else None
        dist.gather(y, out, dst=dist.get_global_rank(group, dst),
                    group=group)
        return torch.cat(out, dim=dim).to(x.device) if mine else None
    return _timed(f'gather over {axis}', run, 'gather', _nbytes(x))


def scatter_from(x: Optional[torch.Tensor], mesh, shape, dtype,
                 axis: str = 'tensor', dim: int = -1,
                 src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` cut into ``axis``-size blocks along ``dim``:
    rank i of the axis gets block i, of ``shape`` and ``dtype`` (``x``
    is None on every rank but ``src``). The inverse of ``gather_to``:
    the head hands each rank its KV heads (a promote, an import)."""
    group = mesh.group(axis)
    if group is None:
        return x
    n = mesh.shape[axis]
    me = mesh.axis_index(axis)
    out = torch.empty(shape, dtype=dtype, device=mesh.device)

    def run():
        blocks = (None if me != src else [
            b.contiguous() for b in x.chunk(n, dim)])

        def write(slot):
            for i, b in enumerate(blocks or ()):
                slot(i).copy_(_bytes(b))
        got = _shared(out, mesh, axis, lambda slots, arena: slots(me).view(
            dtype).view(shape), write=write)
        if got is not None:
            return got
        medium = (torch.empty_like(out, device='cpu')
                  if mesh.stages_on_host else out)
        dist.scatter(medium, None if blocks is None else [
            b.to(medium.device) for b in blocks],
            src=dist.get_global_rank(group, src), group=group)
        return medium.to(mesh.device)
    return _timed(f'scatter over {axis}', run, 'scatter', _nbytes(out))


def broadcast(x: Optional[torch.Tensor], mesh, shape, dtype,
              axis: str = 'data', src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank of ``axis``, of ``shape`` and
    ``dtype`` (``x`` is None on the other ranks). A serving replica's
    head hands the ranks of the other ``data`` indices what it scattered
    on its own (a promote, an import)."""
    group = mesh.group(axis)
    if group is None:
        return x
    mine = mesh.axis_index(axis) == src
    out = (x.contiguous() if mine
           else torch.empty(shape, dtype=dtype, device=mesh.device))

    def run():
        got = _shared(out, mesh, axis, lambda slots, arena: slots(
            src).view(dtype).view(shape))
        if got is not None:
            return got
        medium = _to_medium(out, mesh)
        dist.broadcast(medium, src=dist.get_global_rank(group, src),
                       group=group)
        return medium.to(mesh.device)
    return _timed(f'broadcast over {axis}', run, 'broadcast', _nbytes(out))


def ppermute_ring(x: torch.Tensor, mesh, axis: str,
                  shift: int = 1) -> torch.Tensor:
    """Shard j receives shard (j - shift) % n's ``x`` (JAX's ``ppermute``
    with pairs (j, j + shift)); ``shift=-1`` is the inverse rotation."""
    group = mesh.group(axis)
    if group is None:
        return x
    n = mesh.shape[axis]
    j = mesh.axis_index(axis)

    def run():
        out = _shared(x, mesh, axis, lambda slots, arena: slots(
            (j - shift) % n).view(x.dtype).view(x.shape))
        if out is not None:
            return out
        y = _to_medium(x, mesh)
        out = torch.empty_like(y)
        ops = [dist.P2POp(dist.isend, y,
                          dist.get_global_rank(group, (j + shift) % n),
                          group),
               dist.P2POp(dist.irecv, out,
                          dist.get_global_rank(group, (j - shift) % n),
                          group)]
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


def all_to_all(x: torch.Tensor, mesh, axis: str, counts,
               kind: str = 'exchange') -> torch.Tensor:
    """An uneven all-to-all over ``axis``: ``counts[i][j]`` elements of
    ``x``'s dtype go from rank i to rank j. ``x`` is this rank's pieces,
    flat, in the order of their destinations; the result is the pieces
    this rank receives, flat, in the order of their sources. Every rank
    of the axis passes the same ``counts`` and calls it, those with
    nothing to send or receive too. ``STATS`` counts ``x``'s bytes (what
    this rank sends) under ``kind``."""
    group = mesh.group(axis)
    if group is None:
        return x
    n, me = mesh.shape[axis], mesh.axis_index(axis)
    send = [int(counts[me][j]) for j in range(n)]
    recv = [int(counts[i][me]) for i in range(n)]
    width = x.element_size()

    def write(slot):
        slot(me)[:_nbytes(x)].copy_(_bytes(x))

    def read(slots, arena):
        parts = [slots(i, sum(counts[i][:me]) * width, recv[i] * width)
                 for i in range(n) if recv[i]]
        out = parts[0] if len(parts) == 1 else torch.cat(
            parts or [x.new_empty(0, dtype=torch.uint8)])
        return out.view(x.dtype)

    def run():
        out = _shared(x, mesh, axis, read, write,
                      max(sum(row) for row in counts) * width)
        if out is not None:
            return out
        y = _to_medium(x, mesh) if mesh.stages_on_host else x.contiguous()
        out = torch.empty(sum(recv), dtype=x.dtype, device=y.device)
        dist.all_to_all_single(out, y, recv, send, group=group)
        return out.to(x.device)
    return _timed(f'all_to_all over {axis}', run, kind, _nbytes(x))


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


class _Rotate(torch.autograd.Function):
    """``ppermute_ring`` forward; the inverse rotation of the gradient
    backward, which brings it back to the rank that sent the value."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return ppermute_ring(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return ppermute_ring(g.contiguous(), ctx.mesh, ctx.axis,
                             shift=-1), None, None


def _rows_from(needs, held: int, src: int, dst: int):
    """The rows [lo, hi) that rank ``dst`` needs (``needs[dst]``) of those
    rank ``src`` holds (``[src * held, (src + 1) * held)``), or None."""
    lo = max(needs[dst][0], src * held)
    hi = min(needs[dst][1], (src + 1) * held)
    return (lo, hi) if lo < hi else None


def _row_counts(moves, width: int):
    """Elements each rank sends each other rank: ``width`` a row."""
    return [[(m[1] - m[0]) * width if m else 0 for m in row]
            for row in moves]


def _move_rows(tensors, take, moves, mesh, axis: str, kind: str):
    """The rows ``moves[i][j]`` (``(lo, hi)``, whole-stack rows that rank
    i sends rank j, or None) of each tensor that is not None, in one
    ``all_to_all`` a dtype (in the order of first appearance, the same on
    every rank); ``take(i, m)`` cuts this rank's rows ``m`` of tensor i.
    Returns (tensor index, rows, what came) for each piece this rank
    received, by source rank."""
    n, me = mesh.shape[axis], mesh.axis_index(axis)
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        if t is not None:
            groups.setdefault(t.dtype, []).append(i)
    out = []
    for idx in groups.values():
        widths = [math.prod(tensors[i].shape[1:]) for i in idx]
        send = [take(i, m).reshape(-1) for m in moves[me] if m for i in idx]
        got = all_to_all(torch.cat(send) if send
                         else tensors[idx[0]].new_empty(0), mesh, axis,
                         _row_counts(moves, sum(widths)), kind)
        start = 0
        for src in range(n):
            m = moves[src][me]
            for i, width in zip(idx, widths) if m else ():
                size = (m[1] - m[0]) * width
                out.append((i, m, got[start:start + size].view(
                    (m[1] - m[0],) + tuple(tensors[i].shape[1:]))))
                start += size
    return out


class _ExchangeRows(torch.autograd.Function):
    """Row-stacked leaves held over ``axis`` in even blocks (rank i holds
    rows ``[i * held, (i + 1) * held)``), each rank's ``needs`` rows out:
    the rows another rank holds come through one ``all_to_all`` a dtype,
    and their gradients go back to that rank the same way; a rank's own
    rows are a view where they are its whole block, else copied into the
    block beside the received ones, and their gradients stay here."""

    @staticmethod
    def forward(ctx, mesh, axis, needs, *leaves):
        n, me = mesh.shape[axis], mesh.axis_index(axis)
        held = leaves[0].shape[0]
        base = me * held
        moves = [[_rows_from(needs, held, i, j) if i != j else None
                  for j in range(n)] for i in range(n)]
        pieces: List[List] = [[] for _ in leaves]  # (first row, rows)
        for i, m, rows in _move_rows(
                leaves, lambda i, m: leaves[i][m[0] - base:m[1] - base],
                moves, mesh, axis, 'exchange'):
            pieces[i].append((m[0], rows))
        own = _rows_from(needs, held, me, me)
        blocks = []
        for leaf, got in zip(leaves, pieces):
            mine = leaf[own[0] - base:own[1] - base] if own else leaf[:0]
            if not got:  # the own rows, as they lie
                blocks.append(mine)
                continue
            if own:
                got.append((own[0], mine))
            blocks.append(torch.cat([t for _, t in sorted(
                got, key=lambda p: p[0])]))
        ctx.mesh, ctx.axis, ctx.needs, ctx.moves = mesh, axis, needs, moves
        ctx.held, ctx.own = held, own
        ctx.leaves = [(t.shape, t.dtype, t.device) for t in leaves]
        return tuple(blocks)

    @staticmethod
    def backward(ctx, *grads):
        mesh, axis, moves, own = ctx.mesh, ctx.axis, ctx.moves, ctx.own
        n, me = mesh.shape[axis], mesh.axis_index(axis)
        base, first = me * ctx.held, ctx.needs[me][0]
        wanted = ctx.needs_input_grad[3:]
        out = [torch.zeros(shape, dtype=dtype, device=device) if w else None
               for (shape, dtype, device), w in zip(ctx.leaves, wanted)]
        for g, block in zip(out, grads):
            if g is not None and own:
                g[own[0] - base:own[1] - base] += block[
                    own[0] - first:own[1] - first]
        # Each received piece's gradient back to its owner.
        back = [[moves[j][i] for j in range(n)] for i in range(n)]
        for i, m, rows in _move_rows(
                [g if w else None for g, w in zip(grads, wanted)],
                lambda i, m: grads[i][m[0] - first:m[1] - first], back,
                mesh, axis, 'exchange_grad'):
            out[i][m[0] - base:m[1] - base] += rows
        return (None, None, None, *out)


def exchange_rows(leaves: Sequence[torch.Tensor], mesh, axis: str,
                  needs: Sequence[Sequence[int]]) -> List[torch.Tensor]:
    """Rows ``needs[r]`` (``(start, end)``, whole-stack row numbers) of
    leaves stacked on dim 0 whose rows the ranks of ``axis`` hold in even
    blocks (these ``leaves`` are this rank's), for rank r of the axis:
    only the rows another rank holds move (an uneven ``all_to_all`` a
    dtype, counted under ``exchange``), and their gradients go back to
    their owners (``exchange_grad``); no leaf of the whole stack, nor its
    gradient, is built. Every rank of the axis calls it with the same
    ``needs``, those that need or hold nothing another needs too."""
    if mesh.group(axis) is None:
        return [t[needs[0][0]:needs[0][1]] for t in leaves]
    return list(_ExchangeRows.apply(mesh, axis, tuple(map(tuple, needs)),
                                    *leaves))


def gather_fsdp(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """A parameter's shard gathered along ``dim`` over ``fsdp`` for use;
    its gradient comes back reduce-scattered: summed over the axis's
    ranks (their rows of the batch), this rank's block kept."""
    if mesh.group('fsdp') is None:
        return x
    return _GatherFsdp.apply(x, mesh, 'fsdp', dim)


def copy_to(x: torch.Tensor, mesh, axis: str = 'tensor') -> torch.Tensor:
    """``x``, replicated over ``axis``, entering work split over it: the
    gradient is summed over the axis. With no gradient to take (serving,
    under ``torch.inference_mode``) it is ``x`` itself."""
    if mesh.group(axis) is None or not torch.is_grad_enabled():
        return x
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh, axis: str = 'tensor') -> torch.Tensor:
    """The sum over ``axis`` of partial results (a row-split product), the
    gradient passed through. With no gradient to take it is ``psum``."""
    if mesh.group(axis) is None:
        return x
    if not torch.is_grad_enabled():
        return psum(x, mesh, axis)
    return _ReduceFrom.apply(x, mesh, axis)


def rotate(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Shard j receives shard j - 1's ``x`` around ``axis``'s ring, and
    the gradient goes back the other way (ring attention's K/V hop)."""
    if mesh is None or mesh.group(axis) is None:
        return x
    return _Rotate.apply(x, mesh, axis)


def psum_grads(grads: Sequence[torch.Tensor], axes: Sequence[Sequence[str]],
               mesh) -> List[torch.Tensor]:
    """Each gradient summed over its mesh axes (``axes[i]`` for
    ``grads[i]``): the data-parallel all-reduce (and the sums over
    ``seq`` and ``pipe``), one collective per axis and dtype over the
    gradients flattened together."""
    out = list(grads)
    for axis in ('fsdp', 'data', 'seq', 'pipe'):
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

