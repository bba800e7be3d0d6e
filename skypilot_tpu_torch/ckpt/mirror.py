"""Mirror stage: replicate committed steps into the bucket directory.

A copy of ``skypilot_tpu/ckpt/mirror.py``.

The fast save lands in the local staging dir (committer.py, atomic
rename); this module copies a committed step into the mounted bucket
dir in the background. On fuse-mounted object stores a directory rename
is NOT atomic (gcsfuse/rclone rewrite it object-by-object), so the
mirror writes files IN PLACE into the final-named dir and writes the
``COMMIT`` marker last — the marker is the commit point there, and a
crash mid-upload leaves a marker-less dir every reader ignores
(manifest.committed_steps) and GC sweeps.

Restore prefers the local staging copy (same bytes, faster medium) and
falls back to the bucket; when the two diverge — e.g. the previous
incarnation died after committing locally but before the upload
finished, or this is a fresh VM whose staging dir is empty — the newest
COMMITTED step across both wins (ckpt.manager.AsyncCheckpointManager).
"""
from __future__ import annotations

import os
import shutil
from typing import List, Optional

from skypilot_tpu_torch.ckpt import manifest as manifest_lib


def push_step(step_path: str, bucket_root: str) -> str:
    """Copy one committed local step into ``bucket_root``, marker-last.
    Idempotent: an already-committed mirror copy is left alone; a torn
    previous upload is restarted from scratch."""
    name = os.path.basename(step_path)
    dst = os.path.join(bucket_root, name)
    if manifest_lib.is_committed(dst):
        return dst
    shutil.rmtree(dst, ignore_errors=True)  # torn previous upload
    os.makedirs(dst, exist_ok=True)
    names = [n for n in os.listdir(step_path)
             if n != manifest_lib.COMMIT_FILE]
    for n in sorted(names):
        shutil.copyfile(os.path.join(step_path, n), os.path.join(dst, n))
        manifest_lib.fsync_file(os.path.join(dst, n))
    # Marker LAST: its presence asserts every file above it is complete.
    shutil.copyfile(os.path.join(step_path, manifest_lib.COMMIT_FILE),
                    os.path.join(dst, manifest_lib.COMMIT_FILE))
    manifest_lib.fsync_file(os.path.join(dst, manifest_lib.COMMIT_FILE))
    manifest_lib.fsync_dir(dst)
    return dst


def sync_committed(local_root: str, bucket_root: str,
                   keep: Optional[int] = None) -> List[str]:
    """Push every committed local step the bucket lacks (newest last so
    an interrupted sync leaves the freshest possible durable point),
    then GC the bucket's debris/old steps."""
    pushed = []
    for _, path in manifest_lib.committed_steps(local_root):
        dst = os.path.join(bucket_root, os.path.basename(path))
        if not manifest_lib.is_committed(dst):
            pushed.append(push_step(path, bucket_root))
    if keep is not None:
        gc_bucket(bucket_root, keep)
    return pushed


def gc_bucket(bucket_root: str, keep: int) -> None:
    for path in manifest_lib.partial_dirs(bucket_root):
        shutil.rmtree(path, ignore_errors=True)
    committed = manifest_lib.committed_steps(bucket_root)
    if keep > 0:
        for _, path in committed[:-keep]:
            shutil.rmtree(path, ignore_errors=True)
