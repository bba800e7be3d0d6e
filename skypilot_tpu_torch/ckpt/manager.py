"""Crash-consistent async checkpoint manager: snapshot -> commit -> mirror.

Port of ``skypilot_tpu/ckpt/manager.py``, with its semantics:

* **snapshot** — runs on the caller's thread inside ``save()``: the
  device->host copies into pinned buffers are issued on the compute
  stream (``snapshot.take``). At most one snapshot is in flight: if the
  previous persist has not finished, ``save()`` blocks first
  (back-pressure; the stall is measured and reported). The buffers are
  reused, so a snapshot is only taken once the one before is committed.
* **commit** — a background worker waits for the copies' event, then
  writes shard files + checksummed manifests into ``step_N.tmp`` and
  atomically renames (committer.py; multi-host: per-host shards,
  all-hosts barrier, rank-0 COMMIT marker).
* **mirror** — when a local staging dir is configured, commits land
  there first and the worker then replicates the committed step into
  the durable bucket dir marker-last (mirror.py).

Restore validates before it trusts: layout (names, shapes, dtypes) off
the manifest before any byte is read, checksum-verified ranges, torn and
uncommitted steps skipped with fallback to the previous durable step,
partials GC'd. It writes into the given state's tensors in place.

Preemption: ``emergency_persist()`` never launches device work — it
flushes the in-flight persist and, if the freshest snapshot is newer
than the last durable step, commits it synchronously (local AND mirror)
before the process dies.

Each stage leaves its edge on the flight recorder
(``observability/blackbox.py``), under JAX's names: ``ckpt.snapshot``,
``ckpt.commit``, ``ckpt.mirror``, ``ckpt.emergency`` and ``ckpt.restore``.

A sharded trainer runs one manager per rank: the host's first rank
writes its host's shards (``writer=True``, the default); the others
(``writer=False``) only restore, and leave the root's garbage to the
writer.

Not ported: the orbax compat reader (orbax needs JAX; a directory that
holds only orbax steps raises ``CheckpointError``).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

from skypilot_tpu_torch.ckpt import committer, manifest as manifest_lib, mirror
from skypilot_tpu_torch.ckpt import snapshot as snapshot_lib
from skypilot_tpu_torch.observability import blackbox

CheckpointError = manifest_lib.CheckpointError

# directory realpath -> weakref to the live manager, so a SIGTERM-path
# emergency save can reuse its host-side snapshot instead of
# re-serializing from device under the preemption deadline.
_LIVE: 'weakref.WeakValueDictionary[str, AsyncCheckpointManager]' = \
    weakref.WeakValueDictionary()


def live_manager(directory: str) -> Optional['AsyncCheckpointManager']:
    return _LIVE.get(os.path.realpath(os.path.expanduser(directory)))


class AsyncCheckpointManager:

    _GUARDED_BY = {'_pending': '_lock', '_snapshot': '_lock',
                   '_last_committed': '_lock', '_worker': '_lock',
                   '_closed': '_lock', '_worker_error': '_lock'}

    def __init__(self, directory: str, *, local_dir: Optional[str] = None,
                 max_to_keep: int = 3, save_interval_steps: int = 100,
                 async_save: bool = True,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 barrier: Optional[Callable[[], None]] = None,
                 telemetry: Any = 'env', writer: bool = True):
        self.directory = os.path.abspath(os.path.expanduser(directory))
        self.local_dir = (os.path.abspath(os.path.expanduser(local_dir))
                          if local_dir else None)
        # Commits land in the fast staging dir when one is configured;
        # the bucket dir then becomes the mirror target.
        self._commit_root = self.local_dir or self.directory
        self._mirror_root = self.directory if self.local_dir else None
        self.max_to_keep = max_to_keep
        self.save_interval_steps = max(int(save_interval_steps), 1)
        self.async_save = async_save
        self._host, self._num_hosts = self._resolve_topology(
            process_index, process_count)
        self._barrier = barrier if barrier is not None else \
            (self._default_barrier if self._num_hosts > 1 else None)
        if telemetry == 'env':
            from skypilot_tpu_torch.observability import train_telemetry
            telemetry = train_telemetry.TelemetryWriter.from_env()
        self._telemetry = telemetry
        os.makedirs(self._commit_root, exist_ok=True)
        if self._mirror_root:
            os.makedirs(self._mirror_root, exist_ok=True)

        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._buffers = snapshot_lib.HostBuffers()
        self._pending: Optional[snapshot_lib.Snapshot] = None
        self._snapshot: Optional[snapshot_lib.Snapshot] = None
        self._last_committed: Optional[int] = None
        self._worker: Optional[threading.Thread] = None
        self._closed = False
        self._worker_error: Optional[BaseException] = None
        # Thread id of a caller currently inside ANY public entry that
        # may hold the (non-reentrant) manager lock: a SIGTERM handler
        # runs on that same thread between bytecodes, so re-entering
        # would self-deadlock. emergency_persist bails out instead —
        # the close() flush is the backstop.
        self._busy_thread: Optional[int] = None
        self.writer = writer
        if not writer:
            return
        if self._host == 0:
            committer.gc_root(self._commit_root, self.max_to_keep)
            if self._mirror_root:
                mirror.gc_bucket(self._mirror_root, self.max_to_keep)
        _LIVE[os.path.realpath(self.directory)] = self

    @staticmethod
    def _resolve_topology(process_index, process_count):
        if process_index is not None or process_count is not None:
            return int(process_index or 0), int(process_count or 1)
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
        return 0, 1

    @staticmethod
    def _default_barrier() -> None:
        import torch.distributed as dist
        dist.barrier()

    @contextlib.contextmanager
    def _entered(self):
        prev = self._busy_thread
        self._busy_thread = threading.get_ident()
        try:
            yield
        finally:
            self._busy_thread = prev

    # -- save path ---------------------------------------------------------

    def should_save(self, step: int, force: bool = False) -> bool:
        return force or step % self.save_interval_steps == 0

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Snapshot the state and persist it (in the background when
        async). Blocks only to issue the device->host copies, plus
        back-pressure if the previous persist is still in flight."""
        if not self.should_save(step, force):
            return False
        if not self.writer:
            raise CheckpointError('save on a manager opened with '
                                  'writer=False')
        with self._entered():
            return self._save_inner(step, state)

    def _save_inner(self, step: int, state: Any) -> bool:
        stall0 = time.perf_counter()
        with self._lock:
            self._raise_worker_error_locked()
            while self._pending is not None:
                self._idle.wait()  # back-pressure: one snapshot in flight
                self._raise_worker_error_locked()
            # The retained snapshot is committed (its persist finished
            # without error); the take below overwrites its buffers.
            self._snapshot = None
        snap = snapshot_lib.take(step, state, self._buffers)
        snap.stall_s = time.perf_counter() - stall0
        # Flight recorder: each stage leaves an edge on the ring, so a
        # preemption bundle shows how far the last save got.
        blackbox.record('ckpt.snapshot', step=int(step),
                        stall_s=round(snap.stall_s, 6))
        if self.async_save:
            with self._lock:
                self._snapshot = snap
                self._pending = snap
                self._ensure_worker_locked()
                self._idle.notify_all()
        else:
            # skylint: locked(sync mode never starts the worker thread —
            # the trainer thread is the sole mutator here; emergency
            # persist on this thread is serialized by _busy_thread)
            self._snapshot = snap
            self._emit('save', **self._persist(snap, sync_stall0=stall0))
        return True

    # skylint: locked(the _locked suffix contract — every caller holds
    # _lock when ensuring the worker)
    def _ensure_worker_locked(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._worker_loop, name='skytpu-ckpt-commit',
                daemon=True)
            self._worker.start()

    def _worker_loop(self) -> None:
        while True:
            with self._lock:
                while self._pending is None and not self._closed:
                    self._idle.wait()
                if self._pending is None and self._closed:
                    return
                snap = self._pending
            try:
                record = self._persist(snap, stall_s=snap.stall_s)
            except BaseException as e:  # noqa: BLE001 — surfaced to saver
                with self._lock:
                    self._worker_error = e
                    self._pending = None
                    self._idle.notify_all()
                return
            with self._lock:
                self._pending = None
                self._idle.notify_all()
            # Durability is published before the record is written: a
            # SIGTERM handler waiting on this persist may have interrupted
            # the step loop inside the same writer's emit, holding its
            # lock until the handler returns.
            self._emit('save', **record)

    def _persist(self, snap: snapshot_lib.Snapshot,
                 stall_s: Optional[float] = None,
                 sync_stall0: Optional[float] = None,
                 emergency: bool = False) -> Dict[str, Any]:
        """Commit (and mirror) one snapshot; returns the fields of its
        telemetry record, which the caller emits."""
        snap.wait()  # the bytes are on the host from here on
        if stall_s is not None:
            # The copies ran on the compute stream: the steps behind
            # them waited that long on the device.
            stall_s += snap.copy_s
        t0 = time.perf_counter()
        committer.commit_step(
            self._commit_root, snap.step, snap.arrays,
            host=self._host, num_hosts=self._num_hosts,
            barrier=self._barrier, keep=self.max_to_keep)
        blackbox.record('ckpt.commit', step=int(snap.step),
                        emergency=emergency)
        if self._mirror_root and self._host == 0:
            mirror.push_step(
                os.path.join(self._commit_root,
                             manifest_lib.step_dirname(snap.step)),
                self._mirror_root)
            mirror.gc_bucket(self._mirror_root, self.max_to_keep)
            blackbox.record('ckpt.mirror', step=int(snap.step))
        save_s = time.perf_counter() - t0
        # skylint: locked(cross-thread publish kept DELIBERATELY bare —
        # _pending back-pressure means one persist in flight, so this is
        # a single-writer GIL-atomic int store; taking the non-reentrant
        # lock here would re-open the second-SIGTERM self-deadlock
        # window emergency_persist's lock-free path exists to avoid)
        self._last_committed = snap.step
        if sync_stall0 is not None:
            # Sync mode: the caller stalled for the WHOLE persist.
            stall_s = time.perf_counter() - sync_stall0
        return dict(step=snap.step, seconds=save_s, stall_s=stall_s,
                    nbytes=snap.nbytes,
                    async_save=self.async_save and sync_stall0 is None,
                    emergency=emergency)

    # skylint: locked(the _locked suffix contract — every caller holds
    # _lock when draining the worker error)
    def _raise_worker_error_locked(self) -> None:
        if self._worker_error is not None:
            err, self._worker_error = self._worker_error, None
            raise CheckpointError(
                f'background checkpoint persist failed: {err!r}') from err

    def wait_until_finished(self, timeout: Optional[float] = None) -> bool:
        """Block until no persist is in flight. Returns False on
        timeout."""
        deadline = None if timeout is None else time.time() + timeout
        with self._lock:
            while self._pending is not None:
                remaining = None if deadline is None \
                    else deadline - time.time()
                if remaining is not None and remaining <= 0:
                    return False
                self._idle.wait(remaining)
            self._raise_worker_error_locked()
        return True

    # -- preemption path ---------------------------------------------------

    def emergency_persist(self, timeout: float = 60.0,
                          state: Any = None,
                          step: Optional[int] = None) -> Optional[int]:
        """Make the freshest snapshot durable before the process dies.
        Flushes an in-flight persist (it holds the freshest snapshot)
        or commits the retained snapshot synchronously, mirror
        included — launching no device work (it only waits for the
        snapshot's copies). If NO snapshot was ever taken and the caller
        supplies ``state``/``step`` (the save_for_preemption path), one
        is taken now — that case is the only device access. Returns the
        durable step, or None when no durability could be guaranteed."""
        blackbox.record('ckpt.emergency')
        if self._busy_thread == threading.get_ident():
            # Signal handler interrupted a manager entry on this very
            # thread (save/close/latest_step may hold the non-reentrant
            # lock): re-entering would self-deadlock. The trainer's
            # finally-close() flushes the pending persist.
            # skylint: locked(taking the non-reentrant lock here IS the
            # deadlock this branch exists to avoid; GIL-atomic read of a
            # monotonic int publish)
            return self._last_committed
        try:
            if not self.wait_until_finished(timeout=timeout):
                # The worker is STILL mid-commit on the freshest
                # snapshot: persisting it again from this thread would
                # race two writers on the same step dir. Report no
                # guarantee; the worker may yet finish before SIGKILL.
                return None
        except CheckpointError:
            pass  # worker died — safe to persist the snapshot directly
        # skylint: locked(post wait_until_finished the worker is idle and
        # the process is dying — this thread is the sole toucher; taking
        # the lock would add a self-deadlock window under a second
        # signal, not safety)
        snap = self._snapshot
        if snap is None:
            if state is None:
                return self._last_committed  # skylint: locked(as above)
            snap = snapshot_lib.take(step or 0, state, self._buffers)
            self._snapshot = snap  # skylint: locked(as above)
        if self._last_committed != snap.step:  # skylint: locked(as above)
            self._emit('save', **self._persist(snap, emergency=True))
        elif self._mirror_root and self._host == 0:
            # Committed locally but the VM is about to vanish: make sure
            # the bucket holds it too.
            mirror.sync_committed(self._commit_root, self._mirror_root,
                                  keep=self.max_to_keep)
        return snap.step

    # -- restore path ------------------------------------------------------

    def _candidates(self) -> List[Any]:
        """Committed steps across staging + bucket, newest first; the
        staging copy wins a step tie (same bytes, faster medium)."""
        seen: Dict[int, str] = {}
        for root in (self._commit_root, self._mirror_root):
            if not root:
                continue
            for step, path in manifest_lib.committed_steps(root):
                seen.setdefault(step, path)
        return sorted(seen.items(), reverse=True)

    def latest_step(self) -> Optional[int]:
        """Newest DURABLE step (pending async persists are flushed
        first so the answer never goes backwards after a crash)."""
        with self._entered():
            self.wait_until_finished()
            cands = self._candidates()
            if cands:
                return cands[0][0]
            self._refuse_orbax()
            return None

    def restore_latest(self, state: Any) -> Optional[Any]:
        """Restore the newest checkpoint that VALIDATES into the given
        state's layout, writing into its tensors. Torn/corrupt steps are
        skipped (and GC'd) with fallback to the previous durable one; if
        every candidate is corrupt a CheckpointError names them all.
        None when the directory holds no checkpoint at all — caller
        starts fresh."""
        t0 = time.perf_counter()
        errors: List[str] = []
        for step, path in self._candidates():
            try:
                restored = self._materialize(path, state)
            except CheckpointError as e:
                if self._num_hosts > 1:
                    # No cross-rank agreement protocol exists: if THIS
                    # rank silently fell back while peers validated
                    # their own shards of the newer step, the gang
                    # would resume at divergent steps. Fail loudly;
                    # the operator GCs the bad step and relaunches.
                    raise CheckpointError(
                        f'rank {self._host}: newest step failed '
                        f'validation ({e}); refusing silent fallback '
                        'in multi-host mode — remove the corrupt step '
                        'dir on the shared filesystem and relaunch')
                errors.append(str(e))
                if isinstance(e, manifest_lib.CorruptionError):
                    # Only BYTE-level damage is quarantined. A layout
                    # mismatch (key/shape/dtype drift vs the caller's
                    # state) is a good checkpoint the caller cannot
                    # load — deleting it would turn a config error into
                    # irreversible data loss.
                    self._quarantine(path)
                continue
            # skylint: locked(restore runs before the step loop starts —
            # no worker thread exists yet to race with)
            self._last_committed = step
            source = ('local' if path.startswith(self._commit_root)
                      else 'mirror')
            blackbox.record('ckpt.restore', step=step, source=source)
            self._emit('restore', step=step,
                       seconds=time.perf_counter() - t0,
                       source=source)
            return restored
        if errors:
            raise CheckpointError(
                'no valid checkpoint: every candidate failed validation: '
                + ' | '.join(errors))
        self._refuse_orbax()
        return None

    def _quarantine(self, path: str) -> None:
        """A committed-looking step that failed validation is torn or
        bit-rotted: remove it so the next incarnation does not re-read
        it (rank 0's writer only; non-fatal on shared-fs races)."""
        if self._host != 0 or not self.writer:
            return
        import shutil
        shutil.rmtree(path, ignore_errors=True)

    def _materialize(self, step_path: str, state: Any) -> Any:
        host = self._host
        if not os.path.exists(os.path.join(
                step_path, manifest_lib.host_manifest_name(host))):
            host = 0  # restore onto fewer hosts: fall back to rank 0's
        leaves, build = snapshot_lib.flatten_named(state)
        # Layout validation off the manifest ALONE (name/shape/dtype all
        # live in the entry table) before any array byte is read: a
        # layout mismatch must fail fast, not after streaming gigabytes,
        # and must leave the state's tensors untouched.
        hm = manifest_lib.read_json(os.path.join(
            step_path, manifest_lib.host_manifest_name(host)))
        entries = {e['name']: e for e in hm['arrays']}
        for leaf in leaves:
            entry = entries.get(leaf.name)
            if entry is None:
                raise CheckpointError(
                    f'{step_path}: array {leaf.name!r} missing from '
                    'manifest (state layout changed?)')
            on_disk = tuple(entry['shape'])
            if on_disk != leaf.shape:
                raise CheckpointError(
                    f'{step_path}: {leaf.name!r} shape {on_disk} '
                    f'!= expected {leaf.shape}')
            if entry['dtype'] != leaf.dtype:
                raise CheckpointError(
                    f'{step_path}: {leaf.name!r} dtype {entry["dtype"]} '
                    f'!= expected {leaf.dtype}')
        # Shard-parallel weight streaming: the bounded reader pool
        # (SKYTPU_CKPT_READERS) fetches + crc32-verifies ranges AHEAD
        # of this loop while it copies the previous array to the device.
        want = {leaf.name: leaf for leaf in leaves}
        values: Dict[str, Any] = {}
        for name, value in manifest_lib.iter_host_arrays(
                step_path, host, verify=True):
            leaf = want.get(name)
            if leaf is None:
                continue  # manifest superset: restoring onto a subtree
            values[name] = snapshot_lib.restore_leaf(leaf, value)
        return build(values)

    def _refuse_orbax(self) -> None:
        """Digit-named step dirs are orbax's; its reader needs JAX."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        if any(n.isdigit() and os.path.isdir(
                os.path.join(self.directory, n)) for n in names):
            raise CheckpointError(
                f'{self.directory} holds orbax-format checkpoints, which '
                'the PyTorch port cannot read (orbax needs JAX); restore '
                'them with skypilot_tpu and save in the native format')

    # -- lifecycle ---------------------------------------------------------

    def _emit(self, op: str, **fields: Any) -> None:
        if self._telemetry is None:
            return
        from skypilot_tpu_torch.observability import train_telemetry
        self._telemetry.emit(train_telemetry.ckpt_record(op=op, **fields))

    def close(self) -> None:
        """Flush the in-flight persist and stop the worker."""
        with self._entered():
            self.wait_until_finished()
            with self._lock:
                self._closed = True
                self._idle.notify_all()
            # skylint: locked(join must run unlocked — the exiting worker
            # needs _lock to observe _closed; _closed=True above stops
            # any new worker from being ensured)
            if self._worker is not None:
                # skylint: locked(as above — unlocked join by design)
                self._worker.join(timeout=30)


def oneshot_save(directory: str, step: int, state: Any,
                 local_dir: Optional[str] = None) -> None:
    """One synchronous native save with no manager lifecycle — the
    fallback for ``save_for_preemption`` callers that never opened a
    manager."""
    snap = snapshot_lib.take(step, state)
    snap.wait()
    root = os.path.abspath(os.path.expanduser(local_dir or directory))
    committer.commit_step(root, snap.step, snap.arrays)
    if local_dir:
        mirror.push_step(
            os.path.join(root, manifest_lib.step_dirname(snap.step)),
            os.path.abspath(os.path.expanduser(directory)))
