"""Checkpoint/restore for train state: facade over ``ckpt/``.

Port of ``skypilot_tpu/train/checkpoint.py``: recipes mount a bucket at
e.g. ``/ckpt`` and save here; on spot preemption the managed-jobs
controller relaunches the task, which calls ``restore_latest`` and
resumes from the last durable step. The implementation is the native
snapshot->commit->mirror pipeline (``ckpt/``), which writes the JAX
package's format. ``codec='orbax'`` is refused: orbax needs JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from skypilot_tpu_torch.ckpt import manager as manager_lib


class CheckpointManager:

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 100,
                 async_save: bool = False,
                 local_dir: Optional[str] = None,
                 codec: str = 'native', **manager_kwargs: Any):
        if codec == 'orbax':
            raise ValueError("codec='orbax' is not available in the PyTorch "
                             'port: orbax needs JAX; the native codec '
                             'writes the same format as skypilot_tpu')
        if codec != 'native':
            raise ValueError(f'unknown checkpoint codec {codec!r} '
                             "(expected 'native')")
        self.directory = directory
        self.codec = codec
        self._mgr = manager_lib.AsyncCheckpointManager(
            directory, local_dir=local_dir, max_to_keep=max_to_keep,
            save_interval_steps=save_interval_steps,
            async_save=async_save, **manager_kwargs)

    def save(self, step: int, state: Dict[str, Any],
             force: bool = False) -> bool:
        """Save if the interval policy says so (or force=True). Async
        mode returns once the copies are issued; durability follows in
        the background (``close``/``latest_step`` flush)."""
        return self._mgr.save(step, state, force=force)

    def latest_step(self) -> Optional[int]:
        return self._mgr.latest_step()

    def restore_latest(
            self, state: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Restore the newest VALID checkpoint into the given state
        (written in place). None if no checkpoint exists yet — caller
        starts from scratch. Torn or corrupt steps are skipped with
        fallback to the previous durable one (ckpt.manager)."""
        return self._mgr.restore_latest(state)

    def emergency_persist(self) -> Optional[int]:
        """Preemption path: make the freshest snapshot durable without
        launching device work."""
        return self._mgr.emergency_persist()

    def close(self) -> None:
        self._mgr.close()


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
