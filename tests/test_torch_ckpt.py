"""The port's crash-consistent checkpointing (``skypilot_tpu_torch/ckpt``)
on the CPU, held to the JAX package's.

* The counterparts of ``tests/test_ckpt.py`` on torch states: async equals
  sync, interval and force, back-pressure, telemetry, kill mid-commit,
  corrupt and truncated steps, layout mismatch refused but kept, the
  multi-host marker after the barrier, the mirror, the preemption path,
  the shard-parallel restore.
* The train state's names, shapes and dtypes are those of
  ``skypilot_tpu.ckpt.snapshot.flatten_named`` on the JAX ``Trainer``'s
  state (Adafactor with and without factored leaves, AdamW).
* Across packages: the same weights saved by both give byte-identical
  shard and manifest files; a step either package saves restores into
  the other and trains on within 1e-5 relative (fp32 TINY); bf16 steps
  read back value for value both ways.
* The copies (``manifest``, ``committer``, ``mirror``,
  ``train_telemetry``) write the same files and records as the
  originals.
"""
import dataclasses
import filecmp
import json
import os
import shutil
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ckpt import committer as jax_committer
from skypilot_tpu.ckpt import manager as jax_manager
from skypilot_tpu.ckpt import manifest as jax_manifest
from skypilot_tpu.ckpt import mirror as jax_mirror
from skypilot_tpu.ckpt import snapshot as jax_snapshot
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.observability import train_telemetry as jax_telemetry
from skypilot_tpu.train import trainer as jax_trainer
from skypilot_tpu_torch.ckpt import committer, manifest as manifest_lib, mirror
from skypilot_tpu_torch.ckpt import snapshot as snapshot_lib
from skypilot_tpu_torch.ckpt.manager import (AsyncCheckpointManager,
                                             CheckpointError, live_manager)
from skypilot_tpu_torch.models import llama as port_llama
from skypilot_tpu_torch.observability import train_telemetry
from skypilot_tpu_torch.train import checkpoint as ckpt_lib
from skypilot_tpu_torch.train import trainer as port_trainer

TOL = 1e-5
TINY32 = dataclasses.replace(jax_llama.TINY, dtype=jnp.float32)
# Dims reach 128 so Adafactor factors embed, lm_head and the MLP weights.
WIDE = dataclasses.replace(jax_llama.TINY, d_model=128, d_ff=256)


def _state(seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return {
        'step': seed,
        'params': {'w': torch.randn(16, 8, generator=g),
                   'b': torch.randn(8, generator=g),
                   'e': torch.randn(4, 4, generator=g).to(torch.bfloat16)},
        'opt': (seed, {'m': torch.randn(16, 8, generator=g)}),
    }


def _named(tree):
    leaves, _ = snapshot_lib.flatten_named(tree)
    return {leaf.name: leaf.value for leaf in leaves}


def _assert_tree_equal(got, want):
    got, want = _named(got), _named(want)
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w), name
        else:
            assert g == w and type(g) is type(w), name


def _commit(root, step, state, **kw):
    snap = snapshot_lib.take(step, state)
    snap.wait()
    return committer.commit_step(root, step, snap.arrays, **kw)


def _port_cfg(cfg, dtype):
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg) if f.name != 'dtype'}
    return port_llama.LlamaConfig(**fields, dtype=dtype)


# -- round trip + async semantics -------------------------------------------


def test_async_roundtrip_matches_sync(tmp_path):
    for mode, sub in ((False, 'sync'), (True, 'async')):
        mgr = AsyncCheckpointManager(str(tmp_path / sub),
                                     save_interval_steps=1,
                                     async_save=mode, telemetry=None)
        assert mgr.save(1, _state(3))
        assert mgr.save(2, _state(4))
        assert mgr.latest_step() == 2
        target = _state(99)
        restored = mgr.restore_latest(target)
        _assert_tree_equal(restored, _state(4))
        # Written in place: the caller's tensors now hold step 2.
        assert restored['params']['w'] is target['params']['w']
        mgr.close()


def test_interval_policy_and_force(tmp_path):
    mgr = AsyncCheckpointManager(str(tmp_path), save_interval_steps=5,
                                 async_save=False, telemetry=None)
    assert not mgr.save(3, _state())
    assert mgr.save(5, _state())
    assert mgr.save(7, _state(), force=True)
    assert mgr.latest_step() == 7
    mgr.close()


def test_backpressure_single_snapshot_in_flight(tmp_path, monkeypatch):
    """A save issued while the previous persist is in flight blocks
    (back-pressure) rather than queue a second snapshot; the snapshot in
    flight is committed with its own bytes although the host buffers
    are reused by the next save."""
    gate = threading.Event()
    orig = committer.commit_step
    in_flight = []

    def slow_commit(root, step, arrays, **kw):
        in_flight.append(step)
        assert gate.wait(30)
        return orig(root, step, arrays, **kw)

    monkeypatch.setattr(committer, 'commit_step', slow_commit)
    mgr = AsyncCheckpointManager(str(tmp_path), save_interval_steps=1,
                                 async_save=True, telemetry=None)
    mgr.save(1, _state(1))
    deadline = time.time() + 10
    while not in_flight and time.time() < deadline:
        time.sleep(0.01)
    assert in_flight == [1]
    done = []
    t = threading.Thread(
        target=lambda: (mgr.save(2, _state(2)), done.append(True)))
    t.start()
    time.sleep(0.3)
    assert not done, 'second save must block while persist 1 in flight'
    gate.set()
    t.join(timeout=30)
    assert done and not t.is_alive()
    mgr.close()
    assert mgr.latest_step() == 2
    for step, seed in ((1, 1), (2, 2)):
        got = manifest_lib.load_host_arrays(
            os.path.join(str(tmp_path), manifest_lib.step_dirname(step)), 0)
        want = snapshot_lib.take(step, _state(seed)).arrays
        assert [n for n, _ in want] == list(got)
        for name, arr in want:
            assert got[name].tobytes() == arr.tobytes(), (step, name)


def test_host_buffers_are_reused_across_saves():
    buffers = snapshot_lib.HostBuffers()
    a = snapshot_lib.take(1, _state(1), buffers)
    b = snapshot_lib.take(2, _state(2), buffers)
    wa = dict(a.arrays)["['params']['w']"]
    wb = dict(b.arrays)["['params']['w']"]
    assert np.shares_memory(wa, wb)  # one buffer, overwritten
    assert np.array_equal(wb, _state(2)['params']['w'].numpy())
    assert a.nbytes == b.nbytes


def test_telemetry_records_save_and_restore(tmp_path):
    spool = str(tmp_path / 'spool')
    writer = train_telemetry.TelemetryWriter(spool)
    mgr = AsyncCheckpointManager(str(tmp_path / 'ck'),
                                 save_interval_steps=1, async_save=True,
                                 telemetry=writer)
    mgr.save(1, _state(1))
    mgr.close()
    mgr2 = AsyncCheckpointManager(str(tmp_path / 'ck'),
                                  save_interval_steps=1,
                                  telemetry=writer)
    assert mgr2.restore_latest(_state(0)) is not None
    mgr2.close()
    recs = train_telemetry.read_records(spool)
    saves = [r for r in recs if r.get('kind') == 'ckpt'
             and r['op'] == 'save']
    restores = [r for r in recs if r.get('kind') == 'ckpt'
                and r['op'] == 'restore']
    assert len(saves) == 1 and saves[0]['async'] and \
        saves[0]['seconds'] > 0 and 'stall_s' in saves[0]
    assert saves[0]['nbytes'] == snapshot_lib.take(1, _state(1)).nbytes
    assert len(restores) == 1 and restores[0]['step'] == 1
    assert restores[0]['source'] == 'local'
    # The JAX goodput accounting reads the port's records as its own.
    totals = jax_telemetry.ckpt_totals(recs)
    assert totals['saves'] == 1 and totals['restores'] == 1
    # ckpt records must not masquerade as training windows.
    assert jax_telemetry.latest_record(spool) is None


# -- crash consistency -------------------------------------------------------


def test_kill_mid_commit_falls_back_to_previous_step(tmp_path):
    root = str(tmp_path)
    _commit(root, 2, _state(2))
    tmp_dir = os.path.join(root, manifest_lib.step_dirname(4)
                           + manifest_lib.TMP_SUFFIX)
    os.makedirs(tmp_dir)
    manifest_lib.write_host_files(tmp_dir, 0,
                                  snapshot_lib.take(4, _state(4)).arrays)
    bare = os.path.join(root, manifest_lib.step_dirname(6))
    os.makedirs(bare)
    manifest_lib.write_host_files(bare, 0,
                                  snapshot_lib.take(6, _state(6)).arrays)

    assert [s for s, _ in manifest_lib.committed_steps(root)] == [2]
    assert sorted(manifest_lib.partial_dirs(root)) == sorted(
        [tmp_dir, bare])
    mgr = AsyncCheckpointManager(root, telemetry=None)
    assert mgr.latest_step() == 2
    _assert_tree_equal(mgr.restore_latest(_state(0)), _state(2))
    mgr.close()
    assert manifest_lib.partial_dirs(root) == []  # GC'd at init


def test_corrupt_manifest_rejected_with_fallback(tmp_path):
    root = str(tmp_path)
    _commit(root, 2, _state(2))
    path4 = _commit(root, 4, _state(4))
    with open(os.path.join(path4, manifest_lib.host_manifest_name(0)),
              'w', encoding='utf-8') as f:
        f.write('{"not": "a manifest\x00')
    mgr = AsyncCheckpointManager(root, telemetry=None)
    _assert_tree_equal(mgr.restore_latest(_state(0)), _state(2))
    assert not os.path.exists(path4)  # quarantined
    mgr.close()


def test_corrupt_only_checkpoint_raises_clear_error(tmp_path):
    root = str(tmp_path)
    path2 = _commit(root, 2, _state(2))
    shard = os.path.join(path2, manifest_lib.shard_name(0))
    data = bytearray(open(shard, 'rb').read())
    data[len(data) // 2] ^= 0xFF
    with open(shard, 'wb') as f:
        f.write(bytes(data))
    mgr = AsyncCheckpointManager(root, telemetry=None)
    with pytest.raises(CheckpointError, match='checksum mismatch'):
        mgr.restore_latest(_state(0))
    mgr.close()


def test_layout_mismatch_rejected_but_never_deleted(tmp_path):
    """Shape/dtype/key drift is a GOOD checkpoint the caller cannot
    load: refused before any byte is read (the caller's tensors stay as
    they were) and never deleted."""
    root = str(tmp_path)
    path2 = _commit(root, 2, _state(2))
    mgr = AsyncCheckpointManager(root, telemetry=None)
    wrong = _state(0)
    wrong['params']['w'] = torch.zeros(4, 4)
    before = wrong['params']['b'].clone()
    with pytest.raises(CheckpointError, match='shape'):
        mgr.restore_latest(wrong)
    assert torch.equal(wrong['params']['b'], before)
    assert os.path.isdir(path2), 'layout mismatch must not delete data'
    wrong_dtype = _state(0)
    wrong_dtype['params']['e'] = wrong_dtype['params']['e'].float()
    with pytest.raises(CheckpointError, match='dtype'):
        mgr.restore_latest(wrong_dtype)
    missing = _state(0)
    missing['params']['x'] = torch.zeros(2)
    with pytest.raises(CheckpointError, match='missing from manifest'):
        mgr.restore_latest(missing)
    assert os.path.isdir(path2)
    _assert_tree_equal(mgr.restore_latest(_state(0)), _state(2))
    mgr.close()


def test_truncated_shard_rejected(tmp_path):
    root = str(tmp_path)
    _commit(root, 2, _state(2))
    path4 = _commit(root, 4, _state(4))
    shard = os.path.join(path4, manifest_lib.shard_name(0))
    with open(shard, 'rb+') as f:
        f.truncate(os.path.getsize(shard) - 16)
    report = manifest_lib.verify_step(path4, deep=False)
    assert not report['ok'] and 'truncated' in report['errors'][0]
    mgr = AsyncCheckpointManager(root, telemetry=None)
    _assert_tree_equal(mgr.restore_latest(_state(0)), _state(2))
    mgr.close()


# -- multi-host --------------------------------------------------------------


def test_multihost_marker_only_after_all_hosts_barrier(tmp_path):
    root = str(tmp_path)
    barrier = threading.Barrier(2)
    observed = []

    def checked_barrier():
        tmp_dir = os.path.join(root, manifest_lib.step_dirname(1)
                               + manifest_lib.TMP_SUFFIX)
        marker_at_entry = os.path.exists(
            os.path.join(tmp_dir, manifest_lib.COMMIT_FILE))
        barrier.wait(timeout=30)
        observed.append({'shards': sorted(os.listdir(tmp_dir)),
                         'marker': marker_at_entry})

    errs = []

    def run(host):
        try:
            mgr = AsyncCheckpointManager(root, process_index=host,
                                         process_count=2,
                                         barrier=checked_barrier,
                                         async_save=False, telemetry=None)
            mgr.save(1, _state(host), force=True)
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=run, args=(h,)) for h in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errs, errs
    assert len(observed) == 2
    for obs in observed:
        assert not obs['marker'], observed
        assert {manifest_lib.shard_name(0),
                manifest_lib.shard_name(1)} <= set(obs['shards']), observed
    final = os.path.join(root, manifest_lib.step_dirname(1))
    assert manifest_lib.is_committed(final)
    assert manifest_lib.read_manifest(final)['num_hosts'] == 2
    # Each host restores its own shard; a host beyond the saved
    # topology falls back to rank 0's.
    for host, seed in ((0, 0), (1, 1), (3, 0)):
        mgr = AsyncCheckpointManager(root, process_index=host,
                                     process_count=4,
                                     barrier=lambda: None, telemetry=None)
        _assert_tree_equal(mgr.restore_latest(_state(9)), _state(seed))
        mgr.close()


# -- mirror ------------------------------------------------------------------


def test_mirror_push_and_divergence_resolution(tmp_path):
    local, bucket = str(tmp_path / 'local'), str(tmp_path / 'bucket')
    mgr = AsyncCheckpointManager(bucket, local_dir=local,
                                 save_interval_steps=1, async_save=False,
                                 telemetry=None)
    mgr.save(2, _state(2))
    mgr.save(4, _state(4))
    mgr.close()
    assert [s for s, _ in manifest_lib.committed_steps(bucket)] == [2, 4]

    _commit(bucket, 6, _state(6))
    mgr = AsyncCheckpointManager(bucket, local_dir=local, telemetry=None)
    assert mgr.latest_step() == 6
    _assert_tree_equal(mgr.restore_latest(_state(0)), _state(6))
    mgr.close()

    _commit(local, 8, _state(8))
    torn = os.path.join(bucket, manifest_lib.step_dirname(9))
    os.makedirs(torn)
    mgr = AsyncCheckpointManager(bucket, local_dir=local, telemetry=None)
    _assert_tree_equal(mgr.restore_latest(_state(0)), _state(8))
    mgr.close()


def test_mirror_upload_writes_marker_last(tmp_path, monkeypatch):
    local, bucket = str(tmp_path / 'l'), str(tmp_path / 'b')
    step_path = _commit(local, 2, _state(2))
    copied = []
    orig = shutil.copyfile

    def spy(src, dst):
        copied.append(os.path.basename(dst))
        return orig(src, dst)

    monkeypatch.setattr(shutil, 'copyfile', spy)
    mirror.push_step(step_path, bucket)
    assert copied[-1] == manifest_lib.COMMIT_FILE
    assert copied.count(manifest_lib.COMMIT_FILE) == 1
    assert manifest_lib.is_committed(
        os.path.join(bucket, manifest_lib.step_dirname(2)))


# -- preemption path ---------------------------------------------------------


def test_emergency_persist_reuses_snapshot_without_device(tmp_path,
                                                          monkeypatch):
    root = str(tmp_path)
    mgr = ckpt_lib.CheckpointManager(root, save_interval_steps=1,
                                     async_save=True, telemetry=None)
    state = _state(5)
    mgr.save(5, state)
    assert live_manager(root) is not None

    def no_device(*a, **k):
        raise AssertionError('emergency save touched the device')

    monkeypatch.setattr(snapshot_lib, 'take', no_device)
    ckpt_lib.save_for_preemption(root, 5, state)
    assert mgr.latest_step() == 5
    mgr.close()


def test_emergency_persist_flushes_held_commit(tmp_path, monkeypatch):
    root = str(tmp_path)
    hold = str(tmp_path / 'hold')
    open(hold, 'w').close()
    monkeypatch.setenv(committer.ENV_HOLD_FILE, hold)
    mgr = AsyncCheckpointManager(root, save_interval_steps=1,
                                 async_save=True, telemetry=None)
    mgr.save(3, _state(3))
    timer = threading.Timer(0.4, os.unlink, args=(hold,))
    timer.start()
    assert mgr.emergency_persist(timeout=30) == 3
    timer.join(10)
    assert [s for s, _ in manifest_lib.committed_steps(root)] == [3]
    mgr.close()


def test_emergency_persist_commits_snapshot_of_a_dead_worker(
        tmp_path, monkeypatch):
    """The worker failed: the retained snapshot is persisted directly,
    from its host bytes, without a new device copy."""
    root = str(tmp_path)
    mgr = AsyncCheckpointManager(root, save_interval_steps=1,
                                 async_save=True, telemetry=None)
    orig = committer.commit_step

    def broken(*args, **kwargs):
        raise OSError('disk gone')

    monkeypatch.setattr(committer, 'commit_step', broken)
    mgr.save(4, _state(4))
    with pytest.raises(CheckpointError, match='disk gone'):
        mgr.wait_until_finished(timeout=30)
    monkeypatch.setattr(committer, 'commit_step', orig)

    def no_device(*a, **k):
        raise AssertionError('emergency save touched the device')

    monkeypatch.setattr(snapshot_lib, 'take', no_device)
    assert mgr.emergency_persist(timeout=10) == 4
    restored = AsyncCheckpointManager(root, telemetry=None)
    _assert_tree_equal(restored.restore_latest(_state(0)), _state(4))
    restored.close()
    mgr.close()


def test_emergency_persist_inside_the_interrupted_telemetry_emit(
        tmp_path, monkeypatch):
    """A SIGTERM handler runs on the thread it interrupted, which may be
    inside the shared telemetry writer's emit (the step loop's window
    record, just after its log line): the persist in flight still counts
    as durable as soon as it commits, and a direct emergency commit does
    not deadlock on the writer's lock."""
    spool = str(tmp_path / 'spool')
    writer = train_telemetry.TelemetryWriter(spool)
    hold = str(tmp_path / 'hold')
    open(hold, 'w').close()
    monkeypatch.setenv(committer.ENV_HOLD_FILE, hold)
    mgr = AsyncCheckpointManager(str(tmp_path / 'ck'), save_interval_steps=1,
                                 async_save=True, telemetry=writer)
    mgr.save(3, _state(3))
    timer = threading.Timer(0.3, os.unlink, args=(hold,))
    timer.start()
    with writer._emit_lock:  # the interrupted emit
        t0 = time.perf_counter()
        assert mgr.emergency_persist(timeout=20) == 3
        assert time.perf_counter() - t0 < 10
    timer.join(10)
    mgr.close()
    # A dead worker: the handler commits the snapshot itself, emitting
    # through the lock its own thread already holds.
    monkeypatch.delenv(committer.ENV_HOLD_FILE)
    orig = committer.commit_step

    def broken(*args, **kwargs):
        raise OSError('disk gone')

    mgr = AsyncCheckpointManager(str(tmp_path / 'ck2'),
                                 save_interval_steps=1, async_save=True,
                                 telemetry=writer)
    monkeypatch.setattr(committer, 'commit_step', broken)
    mgr.save(4, _state(4))
    with pytest.raises(CheckpointError):
        mgr.wait_until_finished(timeout=30)
    monkeypatch.setattr(committer, 'commit_step', orig)
    got = []

    def handler():
        with writer._emit_lock:
            got.append(mgr.emergency_persist(timeout=10))

    thread = threading.Thread(target=handler, daemon=True)
    thread.start()
    thread.join(30)
    assert not thread.is_alive() and got == [4]
    mgr.close()
    ops = [(r['op'], r['step'], r.get('emergency', False))
           for r in train_telemetry.read_records(spool)]
    assert ops == [('save', 3, False), ('save', 4, True)]


def test_save_for_preemption_without_manager_is_oneshot_native(tmp_path):
    root = str(tmp_path / 'fresh')
    ckpt_lib.save_for_preemption(root, 7, _state(7))
    assert [s for s, _ in manifest_lib.committed_steps(root)] == [7]


def test_orbax_steps_are_refused_and_codec_orbax_raises(tmp_path):
    root = str(tmp_path)
    os.makedirs(os.path.join(root, '10', 'default'))
    mgr = AsyncCheckpointManager(root, telemetry=None)
    with pytest.raises(CheckpointError, match='orbax') as exc:
        mgr.restore_latest(_state(0))
    assert root in str(exc.value)
    with pytest.raises(CheckpointError, match='orbax'):
        mgr.latest_step()
    mgr.close()
    # A native step beside them wins, as in JAX.
    _commit(root, 2, _state(2))
    mgr = AsyncCheckpointManager(root, telemetry=None)
    _assert_tree_equal(mgr.restore_latest(_state(0)), _state(2))
    mgr.close()
    with pytest.raises(ValueError, match='orbax needs JAX'):
        ckpt_lib.CheckpointManager(str(tmp_path / 'o'), codec='orbax')
    empty = AsyncCheckpointManager(str(tmp_path / 'empty'), telemetry=None)
    assert empty.restore_latest(_state(0)) is None
    assert empty.latest_step() is None
    empty.close()


# -- shard-parallel restore ---------------------------------------------------


def _wide_state(seed: int = 0, arrays: int = 100):
    g = torch.Generator().manual_seed(seed)
    return {'params': {
        f'a{i:03d}': torch.randn(7, 3 + i % 5, generator=g).to(
            (torch.float32, torch.float64, torch.bfloat16)[i % 3])
        for i in range(arrays)}}


def test_parallel_restore_byte_identical_to_sequential(tmp_path):
    path = _commit(str(tmp_path), 2, _wide_state(11))
    seq = manifest_lib.load_host_arrays(path, 0)
    par = manifest_lib.load_host_arrays_parallel(path, 0, readers=4)
    assert list(par.keys()) == list(seq.keys())
    for name in seq:
        assert type(seq[name]) is type(par[name])
        assert seq[name].dtype == par[name].dtype
        assert seq[name].tobytes() == par[name].tobytes(), name


def test_parallel_restore_bit_flip_rejected_with_fallback(tmp_path):
    root = str(tmp_path)
    _commit(root, 2, _state(2))
    path4 = _commit(root, 4, _state(4))
    hm = manifest_lib.read_json(
        os.path.join(path4, manifest_lib.host_manifest_name(0)))
    victim = hm['arrays'][len(hm['arrays']) // 2]
    shard = os.path.join(path4, hm['shard'])
    with open(shard, 'rb+') as f:
        f.seek(victim['offset'] + victim['nbytes'] // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(manifest_lib.CorruptionError,
                       match=victim['name'].replace('[', r'\[')):
        manifest_lib.load_host_arrays_parallel(path4, 0)
    report = manifest_lib.verify_step(path4, deep=True, readers=3)
    assert not report['ok'] and 'checksum mismatch' in report['errors'][0]
    mgr = AsyncCheckpointManager(root, telemetry=None)
    _assert_tree_equal(mgr.restore_latest(_state(0)), _state(2))
    mgr.close()


def test_parallel_restore_reader_pool_bounded(tmp_path, monkeypatch):
    path = _commit(str(tmp_path), 2, _wide_state(7))
    lock = threading.Lock()
    live = {'now': 0, 'max': 0, 'calls': 0}
    orig = manifest_lib._read_range

    def counted(fd, entry, step_dir, shard, verify):
        with lock:
            live['now'] += 1
            live['calls'] += 1
            live['max'] = max(live['max'], live['now'])
        try:
            time.sleep(0.002)
            return orig(fd, entry, step_dir, shard, verify)
        finally:
            with lock:
                live['now'] -= 1

    monkeypatch.setattr(manifest_lib, '_read_range', counted)
    out = manifest_lib.load_host_arrays_parallel(path, 0, readers=4)
    assert len(out) == 100 and live['calls'] == 100
    assert live['max'] <= 4, f'pool exceeded its bound: {live["max"]}'
    monkeypatch.setenv('SKYTPU_CKPT_READERS', '2')
    live.update(now=0, max=0, calls=0)
    list(manifest_lib.iter_host_arrays(path, 0))
    assert live['calls'] == 100 and live['max'] <= 2


# -- the train state under JAX's names -----------------------------------------


def _both_states(model, optimizer, dtype):
    """The JAX Trainer's initial state and the port's from its weights."""
    kw = dict(global_batch_size=2, seq_len=16, warmup_steps=1,
              optimizer=optimizer)
    jt = jax_trainer.Trainer(jax_trainer.TrainerConfig(
        model=dataclasses.replace(model, dtype=dtype), **kw))
    jstate = jt.init_state(0)
    pt = port_trainer.Trainer(port_trainer.TrainerConfig(
        model=_port_cfg(model, getattr(torch, jnp.dtype(dtype).name)), **kw),
        device='cpu')
    pstate = pt.init_state_from_numpy(jax.tree.map(np.asarray,
                                                   jstate['params']))
    return jt, jstate, pt, pstate


@pytest.mark.parametrize('optimizer', ['adafactor', 'adamw'])
@pytest.mark.parametrize('model', [jax_llama.TINY, WIDE],
                         ids=['tiny', 'factored'])
def test_train_state_names_match_jax(model, optimizer):
    _, jstate, _, pstate = _both_states(model, optimizer, jnp.bfloat16)
    want, _ = jax_snapshot.flatten_named(jstate)
    got, _ = snapshot_lib.flatten_named(pstate)
    assert [leaf.name for leaf in got] == [name for name, _ in want]
    for leaf, (name, arr) in zip(got, want):
        assert leaf.shape == tuple(arr.shape), name
        assert leaf.dtype == str(arr.dtype), name
    if model is jax_llama.TINY and optimizer == 'adafactor':
        assert len(got) == 51


@pytest.mark.parametrize('optimizer', ['adafactor', 'adamw'])
@pytest.mark.parametrize('model', [jax_llama.TINY, WIDE],
                         ids=['tiny', 'factored'])
def test_same_state_saves_byte_identical_files(tmp_path, model, optimizer):
    """The same weights at step 0, saved by the JAX manager and by the
    port's: the shard and the host manifest are the same bytes."""
    _, jstate, _, pstate = _both_states(model, optimizer, jnp.bfloat16)
    jm = jax_manager.AsyncCheckpointManager(str(tmp_path / 'j'),
                                            async_save=False,
                                            telemetry=None)
    jm.save(0, jstate, force=True)
    jm.close()
    pm = AsyncCheckpointManager(str(tmp_path / 'p'), async_save=False,
                                telemetry=None)
    pm.save(0, pstate, force=True)
    pm.close()
    for name in (manifest_lib.shard_name(0),
                 manifest_lib.host_manifest_name(0)):
        assert filecmp.cmp(tmp_path / 'j' / 'step_00000000' / name,
                           tmp_path / 'p' / 'step_00000000' / name,
                           shallow=False), name


def _batches(n, seed, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (2, 16)).astype(np.int32)
            for _ in range(n)]


def _assert_params_close(port_params, jax_params):
    flat = jax_snapshot.flatten_named(jax_params)[0]
    got = _named(port_params)
    for name, want in flat:
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   np.asarray(want), rtol=TOL, atol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize('optimizer', ['adafactor', 'adamw'])
def test_jax_checkpoint_restores_into_port_and_trains_on(tmp_path,
                                                         optimizer):
    """JAX trains fp32 TINY 3 steps and saves; the port restores and
    trains 3 more; JAX's own continuation is the reference."""
    jt, jstate, pt, pstate = _both_states(jax_llama.TINY, optimizer,
                                          jnp.float32)
    batches = _batches(6, 1, TINY32.vocab_size)
    step = jt.compiled_step()
    for b in batches[:3]:
        jstate, _ = step(jstate, jnp.asarray(b))
    jm = jax_manager.AsyncCheckpointManager(str(tmp_path), async_save=False,
                                            telemetry=None)
    jm.save(3, jstate, force=True)
    jm.close()
    pm = AsyncCheckpointManager(str(tmp_path), telemetry=None)
    pstate = pm.restore_latest(pstate)
    pm.close()
    assert pstate['step'] == 3 and isinstance(pstate['step'], int)
    assert pstate['opt_state'][1][0]['count'] == 3
    assert all(p.requires_grad and p.is_leaf for p in
               jax.tree.leaves(pstate['params']))
    for b in batches[3:]:
        jstate, jm_ = step(jstate, jnp.asarray(b))
        pstate, pm_ = pt.step(pstate, b)
        assert float(pm_['loss']) == pytest.approx(float(jm_['loss']),
                                                   rel=TOL)
    _assert_params_close({'params': pstate['params']},
                         {'params': jstate['params']})


@pytest.mark.parametrize('optimizer', ['adafactor', 'adamw'])
def test_port_checkpoint_restores_into_jax_and_trains_on(tmp_path,
                                                         optimizer):
    """The reverse: the port trains 3 steps and saves; JAX's
    ``restore_latest`` reads it and trains 3 more beside the port."""
    jt, jstate, pt, pstate = _both_states(jax_llama.TINY, optimizer,
                                          jnp.float32)
    batches = _batches(6, 2, TINY32.vocab_size)
    for b in batches[:3]:
        pstate, _ = pt.step(pstate, b)
    pm = AsyncCheckpointManager(str(tmp_path), async_save=True,
                                telemetry=None)
    pm.save(3, pstate, force=True)
    pm.close()
    jm = jax_manager.AsyncCheckpointManager(str(tmp_path), telemetry=None)
    jstate = jm.restore_latest(jstate)
    jm.close()
    assert int(jstate['step']) == 3
    step = jt.compiled_step()
    for b in batches[3:]:
        jstate, jm_ = step(jstate, jnp.asarray(b))
        pstate, pm_ = pt.step(pstate, b)
        assert float(pm_['loss']) == pytest.approx(float(jm_['loss']),
                                                   rel=TOL)
    _assert_params_close({'params': pstate['params']},
                         {'params': jstate['params']})


def test_bf16_checkpoints_read_back_value_for_value_both_ways(tmp_path):
    _, jstate, pt, pstate = _both_states(jax_llama.TINY, 'adafactor',
                                         jnp.bfloat16)
    # Port -> JAX: a trained port state, bf16 weights and moments.
    pstate, _ = pt.step(pstate, _batches(1, 3, 256)[0])
    pm = AsyncCheckpointManager(str(tmp_path / 'p'), async_save=False,
                                telemetry=None)
    pm.save(1, pstate, force=True)
    pm.close()
    jm = jax_manager.AsyncCheckpointManager(str(tmp_path / 'p'),
                                            telemetry=None)
    from_port = jm.restore_latest(jstate)
    jm.close()
    port_named = _named(pstate)
    for name, arr in jax_snapshot.flatten_named(from_port)[0]:
        want = port_named[name]
        if want is None:
            assert not np.asarray(arr).any(), name  # optax placeholder
            continue
        want = want.detach().float().numpy() if isinstance(
            want, torch.Tensor) else np.asarray(want)
        assert np.array_equal(np.asarray(arr).astype(np.float32), want), name
    # JAX -> port: JAX's bf16 state read by the port.
    jm = jax_manager.AsyncCheckpointManager(str(tmp_path / 'j'),
                                            async_save=False,
                                            telemetry=None)
    jm.save(1, from_port, force=True)
    jm.close()
    _, _, _, fresh = _both_states(jax_llama.TINY, 'adafactor', jnp.bfloat16)
    pm = AsyncCheckpointManager(str(tmp_path / 'j'), telemetry=None)
    got = _named(pm.restore_latest(fresh))
    pm.close()
    for name, value in port_named.items():
        if isinstance(value, torch.Tensor):
            assert got[name].dtype == torch.bfloat16
            assert torch.equal(got[name], value.detach()), name
        else:
            assert got[name] == value, name


# -- the copies against their originals -----------------------------------------


def _np_arrays(seed):
    rng = np.random.default_rng(seed)
    return [("['a']", rng.normal(size=(5, 3)).astype(np.float32)),
            ("['b']", np.asarray(seed, np.int32)),
            ("['c']", rng.integers(0, 9, (4,)).astype(np.int64))]


def _tree_files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            path = os.path.join(dirpath, n)
            rel = os.path.relpath(path, root)
            data = open(path, 'rb').read()
            if n in (manifest_lib.MANIFEST_FILE, manifest_lib.COMMIT_FILE):
                data = json.dumps({k: v for k, v in json.loads(data).items()
                                   if k != 'ts'})
            out[rel] = data
    return out


def test_manifest_committer_mirror_copies_match_originals(tmp_path):
    for lib, man, com, mir in (
            ('j', jax_manifest, jax_committer, jax_mirror),
            ('p', manifest_lib, committer, mirror)):
        root, bucket = tmp_path / lib / 'root', tmp_path / lib / 'bucket'
        for step in (1, 2, 3):
            com.commit_step(str(root), step, _np_arrays(step), keep=2)
        os.makedirs(root / 'step_00000009.tmp')
        os.makedirs(root / 'step_00000008')
        assert [s for s, _ in man.committed_steps(str(root))] == [2, 3]
        assert len(man.partial_dirs(str(root))) == 2
        mir.sync_committed(str(root), str(bucket), keep=1)
        com.gc_root(str(root), 1)
        report = man.verify_step(str(root / 'step_00000003'))
        assert report['ok'] and report['arrays'] == 3
    assert _tree_files(tmp_path / 'j') == _tree_files(tmp_path / 'p')
    got = manifest_lib.load_host_arrays(
        str(tmp_path / 'p' / 'bucket' / 'step_00000003'), 0)
    want = jax_manifest.load_host_arrays(
        str(tmp_path / 'j' / 'bucket' / 'step_00000003'), 0)
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype
        assert np.array_equal(got[name], want[name])


def test_bfloat16_travels_as_raw_words_under_jax_dtype_name(tmp_path):
    import ml_dtypes
    rng = np.random.default_rng(4)
    arr = rng.normal(size=(3, 5)).astype(ml_dtypes.bfloat16)
    raw = manifest_lib.RawArray(arr.view(np.uint16), 'bfloat16')
    os.makedirs(tmp_path / 'j')
    os.makedirs(tmp_path / 'p')
    jax_manifest.write_host_files(str(tmp_path / 'j'), 0, [('x', arr)])
    manifest_lib.write_host_files(str(tmp_path / 'p'), 0, [('x', raw)])
    assert _tree_files(tmp_path / 'j') == _tree_files(tmp_path / 'p')
    back = manifest_lib.load_host_arrays(str(tmp_path / 'j'), 0)['x']
    assert isinstance(back, manifest_lib.RawArray)
    assert back.dtype == 'bfloat16' and back.shape == (3, 5)
    t = snapshot_lib.from_host(back)
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.float().numpy(), arr.astype(np.float32))
    with pytest.raises(CheckpointError, match='cannot resolve dtype'):
        manifest_lib.resolve_dtype('bfloat7')


def test_train_telemetry_copy_matches_original(tmp_path, monkeypatch):
    monkeypatch.setenv('SKYTPU_PEAK_FLOPS', '1e15')
    kw = dict(step=7, steps=3, window_s=1.5, tokens_per_step=100.0,
              model_flops_per_step=1e12, loss=2.5, ts=123.0)
    assert train_telemetry.window_record(**kw) == \
        jax_telemetry.window_record(**kw)
    ck = dict(op='save', step=4, seconds=1.25, stall_s=0.01, nbytes=99,
              async_save=True, emergency=True, ts=5.0)
    assert train_telemetry.ckpt_record(**ck) == jax_telemetry.ckpt_record(**ck)
    for lib, mod in (('j', jax_telemetry), ('p', train_telemetry)):
        writer = mod.TelemetryWriter(str(tmp_path / lib), max_bytes=400)
        for i in range(6):
            writer.emit(mod.window_record(**dict(kw, step=i)))
    assert _tree_files(tmp_path / 'j') == _tree_files(tmp_path / 'p')
    assert train_telemetry.read_records(str(tmp_path / 'p')) == \
        jax_telemetry.read_records(str(tmp_path / 'j'))
    monkeypatch.setenv(train_telemetry.ENV_DIR, str(tmp_path / 'env'))
    assert train_telemetry.TelemetryWriter.from_env() is not None
    monkeypatch.delenv(train_telemetry.ENV_DIR)
    assert train_telemetry.TelemetryWriter.from_env() is None
