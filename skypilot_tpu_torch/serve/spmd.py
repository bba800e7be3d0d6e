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

Everything else the head alone knows reaches the other ranks the same
way. An export's twin carries its flag; an import's carries its row,
first token, layout and block start, and its planes stay on the head,
which scatters each rank its KV heads when the import admits. The trie
refresh of a ``/v1/kv/prepare`` probe and the completion of a KV tier
fetch ride the next arrival broadcast. The KV tiers live on the head (a
worker thread whose progress differs from rank to rank could not answer
alike), and ``_decide`` broadcasts each of their answers that shapes a
device decision (a promote, a park on a fetch) at the point of the
iteration where every rank needs it.

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
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from skypilot_tpu_torch.models.engine import (ContinuousEngine, _ImportEntry,
                                              _Request)
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

    _GUARDED_BY = {'_incoming': '_incoming_lock',
                   '_incoming_imports': '_incoming_lock',
                   '_incoming_touches': '_incoming_lock',
                   '_fetched': '_incoming_lock'}

    def __init__(self, *args, **kw):
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self._head = self.rank == 0
        self._incoming: List[_Request] = []
        self._incoming_imports: List[_ImportEntry] = []
        self._incoming_touches: List[List[int]] = []
        self._fetched = False
        self._incoming_lock = threading.Lock()
        self.on_fatal: Optional[Callable[[Exception], None]] = None
        self.fatal: Optional[Exception] = None
        self.broadcasts = 0
        self.decisions = 0
        # The arrival broadcast moves host bytes: a gloo group, the
        # default one unless the model's collectives run on NCCL.
        self._arrival_group = (None if dist.get_backend() == 'gloo'
                               else dist.new_group(backend='gloo'))
        super().__init__(*args, **kw)

    # -- arrival --------------------------------------------------------

    def _check_head(self, what: str) -> None:
        if self.rank != 0:
            raise RuntimeError(f'{what} is head-only; follower ranks '
                               'receive requests via the broadcast')

    def _enqueue(self, req: _Request) -> None:
        # Same validation and construction as the parent (submit and
        # submit_prefill), but queued in _incoming so that arrival stays
        # collective.
        self._check_head('submit()')
        with self._incoming_lock:
            self._incoming.append(req)
        self.start()
        self._wake.set()

    def _enqueue_import(self, entry: _ImportEntry) -> None:
        # Validated on the head (submit_import); the planes stay here
        # and each rank's heads of them are scattered at the install.
        self._check_head('submit_import()')
        with self._incoming_lock:
            self._incoming_imports.append(entry)
        self.start()
        self._wake.set()

    def probe_chain(self, row: List[int]) -> int:
        """The parent's answer, read off the trie without touching it: the
        LRU refresh rides the next arrival broadcast, so that every rank
        refreshes the same nodes in the same iteration (eviction order,
        and with it the block ids, must agree)."""
        if self._trie is None:
            return 0
        p = self.kv_block
        n = 0
        with self._lock:
            kids = self._trie.children
            for pos in range(0, (len(row) // p) * p, p):
                node = kids.get(tuple(row[pos:pos + p]))
                if node is None:
                    break
                n += 1
                kids = node.children
        with self._incoming_lock:
            self._incoming_touches.append(list(row))
        self._wake.set()
        return n

    def _tier_fetch_done(self, digests, ok) -> None:
        # The tier thread (the head's): the re-queue of the requests
        # parked on the fetch rides the next arrival broadcast.
        del digests, ok
        with self._incoming_lock:
            self._fetched = True
        self._wake.set()

    def _decide(self, fn, share=None):
        """The head's answer to ``fn()`` on every rank (the parent's
        ``_decide``): the head computes it and broadcasts
        ``share(answer)``, or the answer itself; the others receive. A
        decision that raises on the head raises on every rank alike, so
        the parent's recovery runs everywhere in step."""
        self.decisions += 1
        if self.rank == 0:
            try:
                answer = fn()
                msg = ('ok', share(answer) if share is not None else answer)
            except Exception as exc:  # noqa: BLE001 -- raised on every rank
                answer, msg = None, ('error', repr(exc))
            _broadcast_bytes(pickle.dumps(msg), self._arrival_group)
        else:
            msg = pickle.loads(_broadcast_bytes(None, self._arrival_group))
            answer = msg[1]
        if msg[0] == 'error':
            raise RuntimeError(f'the head\'s decision failed: {msg[1]}')
        return answer

    @staticmethod
    def _spec_of(req: _Request) -> dict:
        return {'row': list(req.row), 'max_new': req.max_new,
                'temperature': req.temperature, 'top_k': req.top_k,
                'top_p': req.top_p,
                'eos': sorted(req.eos) if req.eos else None,
                'export': req.export}

    def _twin(self, s: dict) -> _Request:
        # The same constructor as submit(): identical validation and the
        # same uncancellable futures as the head's real objects.
        return self._build_request(
            s['row'], s['max_new'], s['temperature'], None, s['top_k'],
            s['top_p'], frozenset(s['eos']) if s['eos'] else None,
            export=s['export'])

    def _exchange_incoming(self) -> dict:
        """The per-iteration collective: the head ships (stop?, new request
        specs, new imports without their planes, rows whose trie chains a
        ``probe_chain`` refreshed, whether a tier fetch completed); every
        rank returns the same batch in the same order. The head keeps its
        real request objects (live futures and streams, an import's
        planes), followers build silent twins."""
        self.broadcasts += 1
        if self.rank == 0:
            with self._incoming_lock:
                batch, self._incoming = self._incoming, []
                imports, self._incoming_imports = self._incoming_imports, []
                touches, self._incoming_touches = self._incoming_touches, []
                fetched, self._fetched = self._fetched, False
            # Snapshot stop ONCE: returning the live flag instead of the
            # broadcast value would let a stop() landing mid-iteration
            # end the head while followers got stop=False and hang in the
            # next collective.
            stop = self._stop
            _broadcast_bytes(pickle.dumps(
                {'stop': stop, 'reqs': [self._spec_of(r) for r in batch],
                 'imports': [dict(self._spec_of(e.req), first=e.first,
                                  layout=e.layout,
                                  block_start=e.block_start)
                             for e in imports],
                 'touches': touches, 'fetched': fetched}),
                self._arrival_group)
            return {'stop': stop, 'reqs': batch, 'imports': imports,
                    'touches': touches, 'fetched': fetched}
        msg = pickle.loads(_broadcast_bytes(None, self._arrival_group))
        msg['reqs'] = [self._twin(s) for s in msg['reqs']]
        msg['imports'] = [
            _ImportEntry(req=self._twin(s), first=s['first'],
                         layout=s['layout'], block_start=s['block_start'])
            for s in msg['imports']]
        return msg

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

    def _arrive(self, msg: dict) -> None:
        """Apply one arrival batch, identically on every rank."""
        if msg['fetched']:
            self._requeue_tier_waiting()
        with self._lock:
            self._pending.extend(msg['reqs'])
            self._pending_imports.extend(msg['imports'])
            if self._trie is not None:
                for row in msg['touches']:
                    self._touch_chain(row)

    def _loop(self) -> None:
        with torch.inference_mode(), self._device_scope():
            while True:
                try:
                    msg = self._exchange_incoming()
                except collectives.CollectiveError as exc:
                    self._lost(exc)
                    return
                self._arrive(msg)
                if msg['stop']:
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
