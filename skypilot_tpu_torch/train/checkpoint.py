"""Checkpoint/restore for train state: facade over ``ckpt/``.

Port of ``skypilot_tpu/train/checkpoint.py``: recipes mount a bucket at
e.g. ``/ckpt`` and save here; on spot preemption the managed-jobs
controller relaunches the task, which calls ``restore_latest`` and
resumes from the last durable step. The implementation is the native
snapshot->commit->mirror pipeline (``ckpt/``), which writes the JAX
package's format. ``codec='orbax'`` is refused: orbax needs JAX.

Under a mesh (``trainer`` with a mesh, ``gang`` the rank's place), with
JAX's semantics (``skypilot_tpu/ckpt/snapshot.py:35-60``): each host
writes its full view as one host manifest. Every rank gathers the state
to whole arrays at a save (``Trainer.host_view``, a collective; a leaf
split across hosts raises JAX's ``CheckpointError``); the host's first
rank writes them, and after a barrier of the hosts' first ranks rank 0
writes the COMMIT marker. At a restore every rank reads its host's
manifest into whole host arrays and keeps its slices
(``Trainer.load_host_view``). So a step crosses both ways between the
packages and between one device and a mesh.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from skypilot_tpu_torch.ckpt import manager as manager_lib


class CheckpointManager:

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 100,
                 async_save: bool = False,
                 local_dir: Optional[str] = None,
                 codec: str = 'native', trainer: Any = None,
                 gang: Any = None, **manager_kwargs: Any):
        if codec == 'orbax':
            raise ValueError("codec='orbax' is not available in the PyTorch "
                             'port: orbax needs JAX; the native codec '
                             'writes the same format as skypilot_tpu')
        if codec != 'native':
            raise ValueError(f'unknown checkpoint codec {codec!r} '
                             "(expected 'native')")
        self.directory = directory
        self.codec = codec
        self.save_interval_steps = max(int(save_interval_steps), 1)
        # The newest step this run restored or saved (every rank agrees).
        self.saved_step: Optional[int] = None
        self._trainer = (trainer if trainer is not None
                         and getattr(trainer, 'mesh', None) is not None
                         else None)
        self._local = gang.local if gang is not None else 1
        self.writer = gang is None or gang.local_rank == 0
        if gang is not None:
            manager_kwargs.setdefault('process_index', gang.host)
            manager_kwargs.setdefault('process_count', gang.hosts)
            if gang.hosts > 1:
                manager_kwargs.setdefault('barrier', _hosts_barrier(gang))
        self._mgr = manager_lib.AsyncCheckpointManager(
            directory, local_dir=local_dir, max_to_keep=max_to_keep,
            save_interval_steps=save_interval_steps,
            async_save=async_save, writer=self.writer, **manager_kwargs)

    def save(self, step: int, state: Dict[str, Any],
             force: bool = False) -> bool:
        """Save if the interval policy says so (or force=True). Async
        mode returns once the copies are issued; durability follows in
        the background (``close``/``latest_step`` flush). Under a mesh
        every rank calls it (the gather is a collective)."""
        if not (force or step % self.save_interval_steps == 0):
            return False
        if self._trainer is not None:
            state = self._trainer.host_view(state, self._local)
        self.saved_step = step
        if not self.writer:
            return True
        return self._mgr.save(step, state, force=True)

    def latest_step(self) -> Optional[int]:
        return self._mgr.latest_step()

    def restore_latest(
            self, state: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Restore the newest VALID checkpoint into the given state
        (written in place). None if no checkpoint exists yet — caller
        starts from scratch. Torn or corrupt steps are skipped with
        fallback to the previous durable one (ckpt.manager). Under a mesh
        each rank keeps its slices of its host's whole arrays."""
        if self._trainer is None:
            restored = self._mgr.restore_latest(state)
        else:
            whole = self._mgr.restore_latest(
                self._trainer.host_template(state))
            restored = (None if whole is None else
                        self._trainer.load_host_view(state, whole))
        if restored is not None:
            self.saved_step = restored['step']
        return restored

    def emergency_persist(self) -> Optional[int]:
        """Preemption path: make the freshest snapshot durable without
        launching device work (a host's first rank; None elsewhere)."""
        if not self.writer:
            return None
        return self._mgr.emergency_persist()

    def close(self) -> None:
        self._mgr.close()


def _hosts_barrier(gang):
    """A barrier of the hosts' first ranks (the writers), through the
    gang's store: the commit worker's barrier runs beside the step loop's
    collectives, and a process group of the writers alone would hang the
    other ranks under NCCL, where a rank outside a new group still joins
    the split of the default group's communicator."""
    import datetime
    import itertools

    from skypilot_tpu_torch.parallel import gang as gang_lib
    rounds = itertools.count()
    timeout = datetime.timedelta(seconds=gang_lib.TIMEOUT_S)

    def barrier():
        key = f'skytorch/ckpt-barrier/{next(rounds)}/'
        gang.store.set(key + str(gang.host), b'1')
        gang.store.wait([key + str(h) for h in range(gang.hosts)], timeout)
    return barrier


def save_for_preemption(directory: str, step: int,
                        state: Dict[str, Any]) -> None:
    """One-shot forced save (for SIGTERM handlers on spot VMs).

    Reuses the LIVE manager for this directory when one exists — its
    last host-side snapshot persists without copying state from the
    device again under the preemption deadline (an in-flight async
    persist is simply flushed, and if no snapshot was ever taken the
    manager snapshots the given state once). The manager owns the
    directory: never bolt on a second writer. Only a caller with NO open
    manager takes the standalone path, via a single native commit."""
    live = manager_lib.live_manager(directory)
    if live is not None:
        live.emergency_persist(state=state, step=step)
        return
    manager_lib.oneshot_save(directory, step, state)
