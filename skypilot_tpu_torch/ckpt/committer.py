"""Commit stage: turn a host-side snapshot into a durable step directory.

A copy of ``skypilot_tpu/ckpt/committer.py``: the same files, in the same
order, under the same protocol.

Protocol (single host, the common case)::

    step_N.tmp/            assembled here (stale .tmp swept first)
        shard-h0000.bin    raw bytes, fsynced
        manifest-h0000.json
        MANIFEST.json
        COMMIT             marker last, fsynced
    step_N/                one atomic os.replace + parent-dir fsync

Multi-host (shared filesystem — the mounted checkpoint bucket): rank 0
creates the ``.tmp`` dir; every host waits for it and writes its OWN
shard + host manifest; then an all-hosts ``barrier()``; only after the
barrier does rank 0 write the aggregate manifest + COMMIT marker and
rename. A host that dies mid-write therefore can never produce a
committed step missing a shard — the marker does not exist until every
host has passed the barrier.

Crash injection for tests: when
``SKYTPU_CKPT_HOLD_FILE`` names an existing file, ``commit_step`` parks
just BEFORE the commit marker/rename (optionally only at the step named
by ``SKYTPU_CKPT_HOLD_STEP``), so a prober can ``kill -9`` the process
mid-commit at a deterministic point.
"""
from __future__ import annotations

import os
import shutil
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from skypilot_tpu_torch.ckpt import manifest as manifest_lib

ENV_HOLD_FILE = 'SKYTPU_CKPT_HOLD_FILE'
ENV_HOLD_STEP = 'SKYTPU_CKPT_HOLD_STEP'


def _maybe_hold(step: int) -> None:
    hold = os.environ.get(ENV_HOLD_FILE)
    if not hold:
        return
    want = os.environ.get(ENV_HOLD_STEP)
    if want is not None and int(want) != step:
        return
    while os.path.exists(hold):
        time.sleep(0.05)


def _wait_for(path: str, timeout: float = 120.0) -> None:
    deadline = time.time() + timeout
    while not os.path.exists(path):
        if time.time() > deadline:
            raise manifest_lib.CheckpointError(
                f'timed out waiting for {path} (rank-0 writer dead?)')
        time.sleep(0.05)


def commit_step(root: str, step: int,
                named_arrays: Sequence[Tuple[str, np.ndarray]],
                *, host: int = 0, num_hosts: int = 1,
                barrier: Optional[Callable[[], None]] = None,
                keep: Optional[int] = None) -> str:
    """Write one durable step under ``root``; returns the final path.
    Blocking — the async manager calls this from its worker thread."""
    final = os.path.join(root, manifest_lib.step_dirname(step))
    tmp = final + manifest_lib.TMP_SUFFIX
    if host == 0:
        os.makedirs(root, exist_ok=True)
        if os.path.exists(final):
            # Re-commit of an existing step (emergency persist racing a
            # completed async persist): already durable, nothing to do.
            if manifest_lib.is_committed(final):
                return final
            shutil.rmtree(final, ignore_errors=True)
        shutil.rmtree(tmp, ignore_errors=True)  # stale crash debris
        os.makedirs(tmp)
    else:
        _wait_for(tmp)
    manifest_lib.write_host_files(tmp, host, named_arrays)
    if barrier is not None:
        barrier()
    if host != 0:
        # Rank 0 renames after the barrier; this host's step is durable
        # once the final dir appears.
        _wait_for(final)
        return final
    manifest_lib.write_json(
        os.path.join(tmp, manifest_lib.MANIFEST_FILE), {
            'format': manifest_lib.FORMAT,
            'step': step,
            'num_hosts': num_hosts,
            'ts': round(time.time(), 3),
        })
    _maybe_hold(step)
    manifest_lib.write_json(os.path.join(tmp, manifest_lib.COMMIT_FILE),
                            {'step': step, 'ts': round(time.time(), 3)})
    manifest_lib.fsync_dir(tmp)
    os.replace(tmp, final)
    manifest_lib.fsync_dir(root)
    if keep is not None:
        gc_root(root, keep)
    return final


def gc_root(root: str, keep: int) -> Dict[str, List[str]]:
    """Sweep torn-write debris and committed steps beyond ``keep``
    (newest kept). Rank-0 only in multi-host deployments."""
    removed: Dict[str, List[str]] = {'partial': [], 'old': []}
    for path in manifest_lib.partial_dirs(root):
        shutil.rmtree(path, ignore_errors=True)
        removed['partial'].append(path)
    committed = manifest_lib.committed_steps(root)
    if keep > 0:
        for _, path in committed[:-keep]:
            shutil.rmtree(path, ignore_errors=True)
            removed['old'].append(path)
    return removed
