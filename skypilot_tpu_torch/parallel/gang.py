"""A host's ranks over ``torch.distributed``: the gang that a sharded
replica (``serve/spmd.py``) and a sharded trainer (``train/run.py``)
both run on.

JAX runs one process per host over all of its devices; PyTorch's idiom,
and NCCL's, is one process per rank. The gang launcher's env contract
(``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``,
the names the JAX package's gang agent sets, ``skypilot_tpu/agent/``)
says how many host processes there are. Each host process starts
``world / JAX_NUM_PROCESSES`` local ranks, itself and the followers it
spawns with its own argv, with global rank = process_id x local +
local_rank; with no gang env the one host's first rank starts
``world - 1`` followers. The rendezvous is the coordinator address over
TCP, or a file in a fresh temporary directory for one host. The backend
follows the topology (``parallel/mesh.backend_for``): NCCL where every
local rank has its own GPU, gloo where ranks share one or run on the CPU;
never a fallback on error.

A follower ends (status 1) when the host process that started it is
gone; ``Gang.forward_signal`` hands a signal the host's first rank got
to the followers it spawned. ``Gang.close`` takes the ranks out in an
order every backend survives.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

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
# How often a host's first rank looks at the followers it spawned.
WATCH_S = 0.5


def distributed_env() -> Optional[Tuple[str, int, int]]:
    """(coordinator, num_processes, process_id) from the gang launcher's
    env contract, or None when running single-process."""
    addr = os.environ.get('JAX_COORDINATOR_ADDRESS')
    n = int(os.environ.get('JAX_NUM_PROCESSES', '1'))
    if not addr or n <= 1:
        return None
    return addr, n, int(os.environ.get('JAX_PROCESS_ID', '0'))


def host_processes() -> int:
    """The gang's host processes (``JAX_NUM_PROCESSES``; 1 without the
    gang env)."""
    env = distributed_env()
    return env[1] if env else 1


@dataclasses.dataclass
class Gang:
    """This process's place in the gang's ranks."""
    rank: int
    world: int
    local_rank: int
    local: int
    backend: str
    # Where this rank computes, with its index: the current CUDA device is
    # per thread, so a thread that computes pins this one.
    device: torch.device
    children: List[subprocess.Popen] = dataclasses.field(
        default_factory=list)
    rendezvous_dir: Optional[str] = None
    store: Optional[dist.Store] = None

    @property
    def is_head(self) -> bool:
        return self.rank == 0

    @property
    def host(self) -> int:
        """This rank's host process (``JAX_PROCESS_ID``)."""
        return self.rank // self.local

    @property
    def hosts(self) -> int:
        return self.world // self.local

    def watch_children(self, on_death: Callable[[str], None]) -> None:
        """Call ``on_death(reason)`` from a watcher thread when a spawned
        follower exits before ``release_children``."""
        def watch():
            while self.children:
                for child in list(self.children):
                    code = child.poll()
                    if code is not None and child in self.children:
                        on_death(f'rank pid {child.pid} exited with '
                                 f'{code}')
                        return
                time.sleep(WATCH_S)
        threading.Thread(target=watch, name='gang-followers',
                         daemon=True).start()

    def forward_signal(self, signum: int) -> None:
        """Send ``signum`` to every follower this process spawned."""
        for child in self.children:
            if child.poll() is None:
                child.send_signal(signum)

    def close(self, timeout: float) -> List[Optional[int]]:
        """Leave the gang: a barrier (every rank is past its last
        collective), ``release_children``, then this process's groups are
        torn down (a group left to the interpreter's exit can abort the
        process). A follower marks its leaving in the store after its
        teardown and the head, which hosts the store, waits for every
        mark before its own: no rank loses the store mid-teardown. NCCL's
        teardown is collective, so under NCCL every rank tears its groups
        down right after the barrier, before any waits for another to
        exit. Returns the spawned followers' exit codes; raises
        ``CollectiveError`` when a rank is lost on the way."""
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
                        f'ranks did not leave: {exc}')
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


def _spawn(command: Sequence[str], argv: Sequence[str], local_rank: int,
           rank: int, init: str) -> subprocess.Popen:
    env = dict(os.environ, **{LOCAL_RANK_ENV: str(local_rank),
                              RANK_ENV: str(rank), INIT_ENV: init})
    return subprocess.Popen([*command, *argv], env=env)


def _exit_with_parent() -> None:
    """A spawned follower ends (status 1) when the host process that
    started it is gone."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(WATCH_S)
        os._exit(1)
    threading.Thread(target=watch, name='gang-parent', daemon=True).start()


def module_command(module: str) -> List[str]:
    """The command that runs ``python -m module`` with this interpreter."""
    return [sys.executable, '-m', module]


def initialize(world: int, device_type: str, argv: Sequence[str],
               command: Sequence[str], what: str,
               store: Callable = _store,
               exit_with_parent: Callable = _exit_with_parent) -> Gang:
    """Join (and, on a host's first rank, start) a gang of ``world``
    ranks; a follower runs ``command`` + ``argv`` (this process's own
    command line). ``what`` names the request in the error when
    ``world`` does not split over the host processes. The rank computes
    on ``Gang.device``: on CUDA, its local rank's card under NCCL and
    the first card under gloo, by index."""
    env = distributed_env()
    n_proc, proc_id = (env[1], env[2]) if env else (1, 0)
    if world % n_proc:
        raise ValueError(f'{what} does not split over '
                         f'JAX_NUM_PROCESSES={n_proc} host processes')
    local = world // n_proc
    backend = mesh_lib.backend_for(device_type, local)
    if env is None or env[0].split(':')[0] in ('127.0.0.1', 'localhost'):
        # Every rank is on this host: gloo (the model's collectives where
        # ranks share a device, and host-side ones) talks over loopback.
        os.environ.setdefault('GLOO_SOCKET_IFNAME', 'lo')
    gang = Gang(rank=0, world=world, local_rank=0, local=local,
                backend=backend, device=torch.device(device_type))
    if LOCAL_RANK_ENV in os.environ:
        gang.local_rank = int(os.environ[LOCAL_RANK_ENV])
        gang.rank = int(os.environ[RANK_ENV])
        init = os.environ[INIT_ENV]
        exit_with_parent()
    else:
        gang.rank = proc_id * local
        if env is not None:
            init = f'tcp://{env[0]}'
        else:
            gang.rendezvous_dir = tempfile.mkdtemp(prefix='skytorch-gang-')
            init = f'file://{gang.rendezvous_dir}/rendezvous'
        gang.children = [_spawn(command, argv, i, gang.rank + i, init)
                         for i in range(1, local)]
    if device_type == 'cpu':
        # The host's cores shared among its ranks, not each rank's own.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // local))
    if device_type == 'cuda':
        # NCCL: each local rank on its own card; gloo: all on the first.
        gang.device = torch.device(
            'cuda', gang.local_rank if backend == 'nccl' else 0)
        torch.cuda.set_device(gang.device)
    gang.store = store(init, gang.rank, world)
    dist.init_process_group(
        backend, store=gang.store, world_size=world, rank=gang.rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
        device_id=gang.device if backend == 'nccl' else None)
    return gang
