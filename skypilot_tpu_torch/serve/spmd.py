"""Tensor-parallel and multi-host serving: one replica over several ranks.

Port of ``skypilot_tpu/serve/spmd.py``. JAX runs ``--tp N`` as one
process over N devices and adds processes only across hosts; PyTorch's
idiom, and NCCL's, is one process per rank. So here every rank is a
process that holds its shard of the weights and of the KV cache and
issues the model's collectives itself (``models/generate.py``), and
``SpmdEngine`` keeps the ranks in lockstep the way JAX keeps its hosts:
``models/engine.py`` makes every device decision as a pure function of
(pending queue, slot state, generator seed), so the only input that
differs between ranks is request ARRIVAL, and ``SpmdEngine`` makes
arrival a collective. At the top of every engine iteration the head
(global rank 0) broadcasts the newly arrived request specs (two-phase: a
fixed-shape length header, then the pickled payload) and one snapshot of
``stop``; every rank appends the same requests in the same order and runs
the same loop body, so all ranks issue the same collectives in the same
order. The broadcast doubles as the lockstep barrier: followers block in
it until the head's next iteration. Only the engine thread issues
collectives. Followers hold silent twins of the requests; HTTP,
streaming callbacks and ``/health`` live on the head alone.

The gang (``maybe_initialize``, over ``parallel/gang.py``, which sharded
training shares): the gang launcher's env contract says how many host
processes there are; each starts ``tp / JAX_NUM_PROCESSES`` local ranks,
itself and the followers it spawns with its own argv; ``--tp N`` with no
gang env is one host whose rank 0 starts N - 1 followers. The backend
follows the topology (``parallel/mesh.backend_for``), never a fallback
on error. The whole bring-up runs under ``cuda_client_guard.deferred_signals``
as JAX's does: a drain landing mid-init would wedge every rank.

Failure: a collective that fails (a peer died, or hung past
``TIMEOUT_S``, 120 s) ends the lockstep:
``SpmdEngine`` fails every waiter and calls ``on_fatal``, and the replica
exits non-zero; the head also watches the followers it spawned and exits
non-zero within a second of one dying, even mid-init. JAX leaves this to
the gang layer; here the replica never hangs the gang. A follower ignores
SIGTERM and SIGINT: it exits 0 on the head's stop broadcast, which the
head's drain sends.

Caveat, as JAX's: seeded sampling is refused (the window path is
head-local, and a head-only forward over sharded weights would deadlock
the collectives).

Run: ``python -m skypilot_tpu_torch.serve.spmd --model llama3-8b
--max-len 2048 --tp 8 --quantize int8 --kv-cache int8`` on each host
under the gang launcher's env (``examples/llm/serve-multihost/serve.yaml``), or
``python -m skypilot_tpu_torch.serve.llm_server --tp 2`` on one host;
``--device cpu`` runs the gang on the CPU over gloo.
"""
from __future__ import annotations

import pickle
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from skypilot_tpu_torch.models.engine import ContinuousEngine, _Request
from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.parallel import gang as gang_lib

# The gang lives in ``parallel/gang.py``, shared with sharded training;
# its names stay importable from here.
LOCAL_RANK_ENV = gang_lib.LOCAL_RANK_ENV
RANK_ENV = gang_lib.RANK_ENV
INIT_ENV = gang_lib.INIT_ENV
TIMEOUT_S = gang_lib.TIMEOUT_S
WATCH_S = gang_lib.WATCH_S
Gang = gang_lib.Gang
distributed_env = gang_lib.distributed_env
_store = gang_lib._store  # noqa: SLF001 -- re-exported for callers here
_exit_with_parent = gang_lib._exit_with_parent  # noqa: SLF001 -- as above


def maybe_initialize(tp: int, device_type: str,
                     argv: Sequence[str]) -> Optional[Gang]:
    """Join (and, on a host's first rank, start) the replica's ranks for
    ``--tp tp``; None when the replica is one process. ``argv`` is the
    replica's command line, which the spawned followers get too
    (``python -m skypilot_tpu_torch.serve.spmd``). The rank computes on
    ``Gang.device``: on CUDA, its local rank's card under NCCL and the
    first card under gloo, by index."""
    if tp <= 1 and distributed_env() is None:
        return None
    return gang_lib.initialize(
        tp, device_type, argv,
        gang_lib.module_command('skypilot_tpu_torch.serve.spmd'),
        f'--tp {tp}', store=_store, exit_with_parent=_exit_with_parent)


def _broadcast_bytes(payload: Optional[bytes], group) -> bytes:
    """Rank 0's ``payload`` on every rank of ``group``: a length header,
    then the bytes (two fixed-shape broadcasts)."""
    try:
        header = torch.tensor([len(payload) if payload is not None else 0],
                              dtype=torch.int64)
        dist.broadcast(header, src=0, group=group)
        if payload is not None:
            buf = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
        else:
            buf = torch.empty((int(header[0]),), dtype=torch.uint8)
        dist.broadcast(buf, src=0, group=group)
    except Exception as exc:  # noqa: BLE001 -- the lockstep is lost
        raise collectives.CollectiveError(
            f'arrival broadcast failed: {exc}') from exc
    return payload if payload is not None else buf.numpy().tobytes()


class SpmdEngine(ContinuousEngine):
    """Continuous engine whose request arrival is a collective: see the
    module docstring. Construct identically on every rank (same seed,
    same knobs); the head additionally serves ``submit()``/HTTP.
    ``on_fatal(exc)`` runs on the engine thread after a collective failed
    and every waiter was failed."""

    _GUARDED_BY = {'_incoming': '_incoming_lock'}

    def __init__(self, *args, **kw):
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self._incoming: List[_Request] = []
        self._incoming_lock = threading.Lock()
        self.on_fatal: Optional[Callable[[Exception], None]] = None
        self.fatal: Optional[Exception] = None
        self.broadcasts = 0
        # The arrival broadcast moves host bytes: a gloo group, the
        # default one unless the model's collectives run on NCCL.
        self._arrival_group = (None if dist.get_backend() == 'gloo'
                               else dist.new_group(backend='gloo'))
        super().__init__(*args, **kw)

    # -- arrival --------------------------------------------------------

    def submit(self, row, max_new, temperature=0.0, on_tokens=None,
               top_k=0, top_p=1.0, eos=None):
        if self.rank != 0:
            raise RuntimeError('submit() is head-only; follower ranks '
                               'receive requests via the broadcast')
        # Same validation and construction as the parent, but queued in
        # _incoming so that arrival stays collective.
        req = self._build_request(row, max_new, temperature, on_tokens,
                                  top_k, top_p, eos)
        with self._incoming_lock:
            self._incoming.append(req)
        self.start()
        self._wake.set()
        return req.future

    @staticmethod
    def _spec_of(req: _Request) -> dict:
        return {'row': list(req.row), 'max_new': req.max_new,
                'temperature': req.temperature, 'top_k': req.top_k,
                'top_p': req.top_p,
                'eos': sorted(req.eos) if req.eos else None}

    def _exchange_incoming(self) -> Tuple[bool, List[_Request]]:
        """The per-iteration collective: the head ships (stop?, new request
        specs); every rank returns the same batch in the same order. The
        head keeps its real request objects (live futures and streams),
        followers build silent twins."""
        self.broadcasts += 1
        if self.rank == 0:
            with self._incoming_lock:
                batch = self._incoming
                self._incoming = []
            # Snapshot stop ONCE: returning the live flag instead of the
            # broadcast value would let a stop() landing mid-iteration
            # end the head while followers got stop=False and hang in the
            # next collective.
            stop = self._stop
            _broadcast_bytes(pickle.dumps(
                {'stop': stop, 'reqs': [self._spec_of(r) for r in batch]}),
                self._arrival_group)
            return stop, batch
        msg = pickle.loads(_broadcast_bytes(None, self._arrival_group))
        # The same constructor as submit(): identical validation and the same
        # uncancellable futures as the head's real objects.
        reqs = [
            self._build_request(
                s['row'], s['max_new'], s['temperature'], None,
                s['top_k'], s['top_p'],
                frozenset(s['eos']) if s['eos'] else None)
            for s in msg['reqs']]
        return msg['stop'], reqs

    # -- lockstep loop --------------------------------------------------

    def stop(self) -> None:
        # The stop signal travels by the broadcast: the loop must be
        # RUNNING to deliver it, or the followers would wait in their
        # collective forever (a replica drained before its first
        # request). start() is idempotent.
        if self.fatal is None:
            self.start()
        super().stop()

    def _lost(self, exc: Exception) -> None:
        """A collective failed: the ranks cannot go on in lockstep. Fail
        every waiter, then hand over to ``on_fatal``."""
        self.fatal = exc
        self._fail_everything(exc)
        if self.on_fatal is not None:
            self.on_fatal(exc)

    def _loop(self) -> None:
        with torch.inference_mode(), self._device_scope():
            while True:
                try:
                    stop, reqs = self._exchange_incoming()
                except collectives.CollectiveError as exc:
                    self._lost(exc)
                    return
                with self._lock:
                    self._pending.extend(reqs)
                if stop:
                    return
                try:
                    idle = self._iterate()
                except collectives.CollectiveError as exc:
                    self._lost(exc)
                    return
                except Exception as exc:  # noqa: BLE001 -- fail waiters
                    # The parent's recovery. Only an error raised on EVERY
                    # rank alike (a shape fault, an OOM) recovers cleanly;
                    # one rank's loss surfaces as a CollectiveError.
                    self._fail_everything(exc)
                    time.sleep(0.05)
                    continue
                if idle and self.rank == 0 and not self._pending:
                    # Idle pacing lives on the head; followers pace on the
                    # broadcast itself.
                    self._wake.wait(0.02)
                    self._wake.clear()


def follower_main(server) -> None:
    """Run a follower rank's ``server`` (built from the same flags as the
    head's: same seed, same weights, same knobs): start its engine and
    block until the head's stop broadcast. SIGTERM and SIGINT are
    ignored; the head's drain ends the follower."""
    import signal
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, signal.SIG_IGN)
    server.engine.start()
    server.engine._thread.join()  # noqa: SLF001 -- the follower's one job
    if server.engine.fatal is not None:
        raise SystemExit(f'tp rank {server.engine.rank}: '
                         f'{server.engine.fatal}')


def main(argv: Optional[List[str]] = None, device=None) -> None:
    """The replica's entry point on every host process of a multi-host
    replica: the same command line on each (``llm_server.main`` brings up
    the gang, serves HTTP on the head and runs ``follower_main``
    elsewhere)."""
    from skypilot_tpu_torch.serve import llm_server
    llm_server.main(argv, device=device)


if __name__ == '__main__':
    main()
