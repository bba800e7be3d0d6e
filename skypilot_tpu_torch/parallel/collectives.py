"""Collectives over a mesh axis, their self-test and their benchmark.

Port of ``skypilot_tpu/parallel/collectives.py``: ``verify_collectives``
(sum, all-gather and ring permute on every axis larger than 1, with JAX's
expected values) and ``allreduce_benchmark`` (nccl-tests' algbw and busbw:
for all-reduce over n ranks, busbw = algbw * 2 * (n - 1) / n), which the
``examples/tpu_comm_test.yaml`` recipe runs.

JAX's GSPMD inserts the model's collectives itself; the port issues them
by hand through ``psum``, ``pmax`` and ``all_gather`` here, which the
sharded forward (``models/generate.py``) and quantization call. On an
axis of size 1 each returns its input. On a gloo mesh whose ranks compute
on CUDA (ranks that share one card) a collective copies its input to the
host, reduces there and copies back: the copy waits for the device, so
such a rank runs serially. ``STATS`` counts the calls and their host
seconds (with staging, that includes the wait for the device; with NCCL,
only the issue). A failed collective raises ``CollectiveError``: a gang
that lost a rank cannot go on in lockstep.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

STATS = {'calls': 0, 'seconds': 0.0}


class CollectiveError(RuntimeError):
    """A collective failed: a peer died, hung past the group's timeout or
    refused the operation."""


def _timed(what: str, fn):
    t0 = time.perf_counter()
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 -- any backend error is fatal here
        raise CollectiveError(f'{what} failed: {exc}') from exc
    finally:
        STATS['calls'] += 1
        STATS['seconds'] += time.perf_counter() - t0


def _to_medium(x: torch.Tensor, mesh) -> torch.Tensor:
    if mesh.stages_on_host:
        return x.to('cpu')
    return x.contiguous().clone()


def _reduce(x: torch.Tensor, mesh, axis: str, op) -> torch.Tensor:
    group = mesh.group(axis)
    if group is None:
        return x

    def run():
        y = _to_medium(x, mesh)
        dist.all_reduce(y, op=op, group=group)
        return y.to(x.device)
    return _timed(f'all_reduce over {axis}', run)


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
        y = _to_medium(x, mesh)
        parts = [torch.empty_like(y) for _ in range(mesh.shape[axis])]
        dist.all_gather(parts, y, group=group)
        return torch.cat(parts, dim=dim).to(x.device)
    return _timed(f'all_gather over {axis}', run)


def ppermute_ring(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Shard j receives shard (j - 1) % n's ``x`` (JAX's ``ppermute`` with
    pairs (j, j + 1))."""
    group = mesh.group(axis)
    if group is None:
        return x
    n = mesh.shape[axis]
    j = mesh.axis_index(axis)

    def run():
        y = _to_medium(x, mesh)
        out = torch.empty_like(y)
        ops = [dist.P2POp(dist.isend, y,
                          dist.get_global_rank(group, (j + 1) % n), group),
               dist.P2POp(dist.irecv, out,
                          dist.get_global_rank(group, (j - 1) % n), group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out.to(x.device)
    return _timed(f'ring permute over {axis}', run)


def barrier() -> None:
    """Every rank of the default group waits for the others."""
    _timed('barrier', dist.barrier)


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

