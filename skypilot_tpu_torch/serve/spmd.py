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

The gang (``maybe_initialize``): the gang launcher's env contract
(``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``,
the names the JAX package's gang agent sets, ``skypilot_tpu/agent/``) says how many host
processes there are. Each host process starts ``tp / JAX_NUM_PROCESSES``
local ranks, itself and the followers it spawns with its own argv, with
global rank = process_id x local + local_rank; ``--tp N`` with no gang
env is one host whose rank 0 starts N - 1 followers. The rendezvous is
the coordinator address over TCP, or a file in a fresh temporary
directory for one host. The backend follows the topology
(``parallel/mesh.backend_for``): NCCL where every local rank has its own
GPU, gloo where ranks share one or run on the CPU; never a fallback on
error. The whole bring-up runs under ``cuda_client_guard.deferred_signals``
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

import dataclasses
import datetime
import os
import pickle
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from skypilot_tpu_torch.models.engine import ContinuousEngine, _Request
from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.parallel import mesh as mesh_lib

# Set by a host process for the local ranks it spawns (the port's own
# names: they are not flags of the JAX package).
LOCAL_RANK_ENV = 'SKYTORCH_TP_LOCAL_RANK'
RANK_ENV = 'SKYTORCH_TP_RANK'
INIT_ENV = 'SKYTORCH_TP_INIT'
# How long a collective, and a rank's leaving, may wait for a peer before
# the rank counts it lost.
TIMEOUT_S = 120.0
# A follower's mark in the store once it has left the gang.
_LEFT = 'skytorch/left/'
# How often the head looks at the followers it spawned.
WATCH_S = 0.5


def distributed_env() -> Optional[Tuple[str, int, int]]:
    """(coordinator, num_processes, process_id) from the gang launcher's
    env contract, or None when running single-process."""
    addr = os.environ.get('JAX_COORDINATOR_ADDRESS')
    n = int(os.environ.get('JAX_NUM_PROCESSES', '1'))
    if not addr or n <= 1:
        return None
    return addr, n, int(os.environ.get('JAX_PROCESS_ID', '0'))


@dataclasses.dataclass
class Gang:
    """This process's place in the replica's ranks."""
    rank: int
    world: int
    local_rank: int
    local: int
    backend: str
    # Where this rank computes, with its index: the current CUDA device is
    # per thread, so the engine thread pins this one (``_device_scope``).
    device: torch.device
    children: List[subprocess.Popen] = dataclasses.field(
        default_factory=list)
    rendezvous_dir: Optional[str] = None
    store: Optional[dist.Store] = None

    @property
    def is_head(self) -> bool:
        return self.rank == 0

    def watch_children(self, on_death: Callable[[str], None]) -> None:
        """Call ``on_death(reason)`` from a watcher thread when a spawned
        follower exits before ``release_children``."""
        def watch():
            while self.children:
                for child in list(self.children):
                    code = child.poll()
                    if code is not None and child in self.children:
                        on_death(f'tp follower pid {child.pid} exited '
                                 f'with {code}')
                        return
                time.sleep(WATCH_S)
        threading.Thread(target=watch, name='tp-followers',
                         daemon=True).start()

    def close(self, timeout: float) -> List[Optional[int]]:
        """Leave the gang after the stop broadcast: a barrier (every rank is
        past its last collective), ``release_children``, then this
        process's groups are torn down (a group left to the interpreter's
        exit can abort the process). A follower marks its leaving in the
        store after its teardown and the head, which hosts the store,
        waits for every mark before its own: no rank loses the store
        mid-teardown. NCCL's teardown is collective, so under NCCL every
        rank tears its groups down right after the barrier, before any
        waits for another to exit. Returns the spawned followers' exit
        codes; raises ``CollectiveError`` when a rank is lost on the
        way."""
        lost = None
        try:
            collectives.barrier()
        except collectives.CollectiveError as exc:
            lost = exc
        together = self.backend == 'nccl'
        if together and lost is None:
            dist.destroy_process_group()
        codes = self.release_children(timeout)
        if self.is_head:
            if lost is None:
                try:
                    self.store.wait([f'{_LEFT}{r}'
                                     for r in range(1, self.world)],
                                    datetime.timedelta(seconds=timeout))
                except Exception as exc:  # noqa: BLE001 -- a rank is lost
                    lost = collectives.CollectiveError(
                        f'tp ranks did not leave: {exc}')
            if not together:
                dist.destroy_process_group()
        else:
            if not together:
                dist.destroy_process_group()
            if lost is None:
                self.store.set(f'{_LEFT}{self.rank}', b'1')
        self.store = None
        if self.rendezvous_dir:
            for name in os.listdir(self.rendezvous_dir):
                os.unlink(os.path.join(self.rendezvous_dir, name))
            os.rmdir(self.rendezvous_dir)
            self.rendezvous_dir = None
        if lost is not None:
            raise lost
        return codes

    def release_children(self, timeout: float) -> List[Optional[int]]:
        """Stop watching, wait up to ``timeout`` for the followers to exit,
        kill any left; returns their exit codes."""
        children, self.children = self.children, []
        deadline = time.monotonic() + timeout
        codes = []
        for child in children:
            try:
                codes.append(child.wait(max(deadline - time.monotonic(), 0)))
            except subprocess.TimeoutExpired:
                child.kill()
                codes.append(child.wait())
        return codes


def _store(init: str, rank: int, world: int) -> dist.Store:
    """The gang's store: TCP at the coordinator (hosted by rank 0), or a
    file."""
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    if init.startswith('tcp://'):
        host, port = init[len('tcp://'):].rsplit(':', 1)
        return dist.TCPStore(host, int(port), world, rank == 0, timeout)
    return dist.FileStore(init[len('file://'):], world)


def _spawn(argv: Sequence[str], local_rank: int, rank: int,
           init: str) -> subprocess.Popen:
    env = dict(os.environ, **{LOCAL_RANK_ENV: str(local_rank),
                              RANK_ENV: str(rank), INIT_ENV: init})
    return subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.serve.spmd', *argv],
        env=env)


def _exit_with_parent() -> None:
    """A spawned follower ends (status 1) when the host process that
    started it is gone."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(WATCH_S)
        os._exit(1)
    threading.Thread(target=watch, name='tp-parent', daemon=True).start()


def maybe_initialize(tp: int, device_type: str,
                     argv: Sequence[str]) -> Optional[Gang]:
    """Join (and, on a host's first rank, start) the replica's ranks for
    ``--tp tp``; None when the replica is one process. ``argv`` is the
    replica's command line, which the spawned followers get too. The
    rank computes on ``Gang.device``: on CUDA, its local rank's card
    under NCCL and the first card under gloo, by index."""
    env = distributed_env()
    if tp <= 1 and env is None:
        return None
    n_proc, proc_id = (env[1], env[2]) if env else (1, 0)
    if tp % n_proc:
        raise ValueError(f'--tp {tp} does not split over '
                         f'JAX_NUM_PROCESSES={n_proc} host processes')
    local = tp // n_proc
    backend = mesh_lib.backend_for(device_type, local)
    if env is None or env[0].split(':')[0] in ('127.0.0.1', 'localhost'):
        # Every rank is on this host: gloo (the arrival broadcast's, and
        # the model's where ranks share a device) talks over loopback.
        os.environ.setdefault('GLOO_SOCKET_IFNAME', 'lo')
    gang = Gang(rank=0, world=tp, local_rank=0, local=local,
                backend=backend, device=torch.device(device_type))
    if LOCAL_RANK_ENV in os.environ:
        gang.local_rank = int(os.environ[LOCAL_RANK_ENV])
        gang.rank = int(os.environ[RANK_ENV])
        init = os.environ[INIT_ENV]
        _exit_with_parent()
    else:
        gang.rank = proc_id * local
        if env is not None:
            init = f'tcp://{env[0]}'
        else:
            gang.rendezvous_dir = tempfile.mkdtemp(prefix='skytpu-tp-')
            init = f'file://{gang.rendezvous_dir}/rendezvous'
        gang.children = [_spawn(argv, i, gang.rank + i, init)
                         for i in range(1, local)]
    if device_type == 'cuda':
        # NCCL: each local rank on its own card; gloo: all on the first.
        gang.device = torch.device(
            'cuda', gang.local_rank if backend == 'nccl' else 0)
        torch.cuda.set_device(gang.device)
    gang.store = _store(init, gang.rank, tp)
    dist.init_process_group(
        backend, store=gang.store, world_size=tp, rank=gang.rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
        device_id=gang.device if backend == 'nccl' else None)
    return gang


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
