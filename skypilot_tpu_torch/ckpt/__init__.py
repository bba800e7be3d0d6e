"""Crash-consistent checkpointing: snapshot -> commit -> mirror.

Port of ``skypilot_tpu/ckpt``. It writes and reads the JAX package's
on-disk format (``skytpu-ckpt/1``) under JAX's array names, so a step
either package commits restores into the other.

Layering: ``manifest`` (read side + file format), ``committer``/``mirror``
(write side) — numpy/stdlib copies of the originals — and
``snapshot``/``manager`` (torch-facing orchestration: pinned
device->host copies, restore in place). ``train/checkpoint.py`` keeps the
historical facade.
"""
from skypilot_tpu_torch.ckpt.manager import (AsyncCheckpointManager,
                                             CheckpointError, live_manager,
                                             oneshot_save)
from skypilot_tpu_torch.ckpt.manifest import (committed_steps, partial_dirs,
                                              verify_step)

__all__ = [
    'AsyncCheckpointManager',
    'CheckpointError',
    'committed_steps',
    'live_manager',
    'oneshot_save',
    'partial_dirs',
    'verify_step',
]
