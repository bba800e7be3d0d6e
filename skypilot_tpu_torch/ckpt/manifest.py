"""Checkpoint on-disk format: shard files + checksummed JSON manifests.

Layout of one committed step (the native ``skytpu-ckpt/1`` format)::

    <root>/step_00000040/
        shard-h0000.bin        per-host raw array bytes, concatenated
        manifest-h0000.json    that host's array table (shape/dtype/
                               offset/nbytes/crc32 per array)
        MANIFEST.json          aggregate: step, num_hosts, format
        COMMIT                 commit marker — written LAST

Durability protocol (write side lives in ``committer.py``/``mirror.py``):
on a POSIX filesystem the step is assembled in ``step_N.tmp`` and
atomically renamed, so a final-named dir is complete by construction.
On fuse-mounted object stores (the bucket mirror) a directory rename is
NOT atomic (gcsfuse/rclone rewrite it object-by-object), so there the
files are uploaded in place and the ``COMMIT`` marker — written last —
is the commit point. Readers therefore require BOTH: a final-named dir
AND its marker. Anything else (a ``.tmp`` dir, a marker-less dir, a
manifest that fails its checksum) is a torn write to skip and GC.

This module is the READ side plus the shared file helpers, a copy of
``skypilot_tpu/ckpt/manifest.py`` (stdlib and numpy only) that writes and
reads the same bytes. One change: the original resolves ``bfloat16``
through ``ml_dtypes``, which the port does not load. Here an array numpy
has no dtype for travels as a :class:`RawArray`: its storage words under
the dtype name JAX records (``str(arr.dtype)``), so the shard bytes, the
crc32 and the manifest entry are those JAX writes.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import itertools
import json
import os
import re
import zlib
from typing import (Any, Dict, Iterator, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np

FORMAT = 'skytpu-ckpt/1'
MANIFEST_FILE = 'MANIFEST.json'
COMMIT_FILE = 'COMMIT'
TMP_SUFFIX = '.tmp'
_STEP_RE = re.compile(r'^step_(\d{8})$')


class CheckpointError(Exception):
    """A checkpoint directory failed validation. The message names the
    step dir and the first failing check so operators can GC or debug
    it."""


class CorruptionError(CheckpointError):
    """The on-disk BYTES are bad (torn write, truncation, checksum
    mismatch, unreadable manifest) — safe to quarantine/GC the step.
    Distinct from layout mismatches (state shape/dtype/key drift),
    which describe a perfectly good checkpoint the CALLER cannot load:
    deleting those would turn a recoverable config error into data
    loss."""


def step_dirname(step: int) -> str:
    return f'step_{step:08d}'


def parse_step_dirname(name: str) -> Optional[int]:
    m = _STEP_RE.match(name)
    return int(m.group(1)) if m else None


def shard_name(host: int) -> str:
    return f'shard-h{host:04d}.bin'


def host_manifest_name(host: int) -> str:
    return f'manifest-h{host:04d}.json'


# Dtypes numpy lacks, by saved name -> the storage word their bytes are
# read as (torch views them back: ``ckpt/snapshot.py``).
WORD_DTYPES = {'bfloat16': np.dtype(np.uint16)}


@dataclasses.dataclass(frozen=True)
class RawArray:
    """An array of a dtype numpy lacks: its C-order storage ``words`` and
    the dtype name the manifest records. Written and read like an array."""
    words: np.ndarray
    dtype: str

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.words.shape

    @property
    def nbytes(self) -> int:
        return self.words.nbytes

    def tobytes(self) -> bytes:
        return self.words.tobytes()


HostArray = Union[np.ndarray, RawArray]


def resolve_dtype(name: str) -> np.dtype:
    """np.dtype of the stored elements from the saved name; a dtype numpy
    lacks resolves to its storage word (``WORD_DTYPES``)."""
    if name in WORD_DTYPES:
        return WORD_DTYPES[name]
    try:
        return np.dtype(name)
    except TypeError as e:
        raise CheckpointError(f'cannot resolve dtype {name!r}: {e}') from e


def _host_array(raw: bytes, entry: Dict[str, Any]) -> HostArray:
    arr = np.frombuffer(raw, dtype=resolve_dtype(entry['dtype'])).reshape(
        entry['shape'])
    return RawArray(arr, entry['dtype']) \
        if entry['dtype'] in WORD_DTYPES else arr


def fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # fuse mounts may refuse O_RDONLY on dirs; best-effort
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_json(path: str, obj: Dict[str, Any]) -> None:
    with open(path, 'w', encoding='utf-8') as f:
        json.dump(obj, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())


def write_host_files(step_dir: str, host: int,
                     named_arrays: Sequence[Tuple[str, HostArray]],
                     ) -> Dict[str, Any]:
    """Write one host's shard + manifest into ``step_dir`` (fsynced).
    Returns the host manifest dict."""
    shard_path = os.path.join(step_dir, shard_name(host))
    entries: List[Dict[str, Any]] = []
    offset = 0
    with open(shard_path, 'wb') as f:
        for name, arr in named_arrays:
            # NOT ascontiguousarray: that promotes 0-d scalars to 1-d,
            # corrupting the shape table. tobytes() already emits C order.
            if not isinstance(arr, RawArray):
                arr = np.asarray(arr)
            raw = arr.tobytes()
            f.write(raw)
            entries.append({
                'name': name,
                'shape': list(arr.shape),
                'dtype': str(arr.dtype),
                'offset': offset,
                'nbytes': len(raw),
                'crc32': zlib.crc32(raw) & 0xFFFFFFFF,
            })
            offset += len(raw)
        f.flush()
        os.fsync(f.fileno())
    manifest = {
        'format': FORMAT,
        'host': host,
        'shard': shard_name(host),
        'shard_nbytes': offset,
        'arrays': entries,
    }
    write_json(os.path.join(step_dir, host_manifest_name(host)), manifest)
    return manifest


def read_json(path: str) -> Dict[str, Any]:
    try:
        with open(path, encoding='utf-8') as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CorruptionError(f'{path}: unreadable manifest: {e}') from e
    if not isinstance(obj, dict):
        raise CorruptionError(f'{path}: manifest is not a JSON object')
    return obj


def read_manifest(step_dir: str) -> Dict[str, Any]:
    m = read_json(os.path.join(step_dir, MANIFEST_FILE))
    if m.get('format') != FORMAT:
        raise CheckpointError(
            f'{step_dir}: unknown checkpoint format {m.get("format")!r} '
            f'(expected {FORMAT})')
    return m


def is_committed(step_dir: str) -> bool:
    return (parse_step_dirname(os.path.basename(step_dir)) is not None
            and os.path.exists(os.path.join(step_dir, COMMIT_FILE))
            and os.path.exists(os.path.join(step_dir, MANIFEST_FILE)))


def committed_steps(root: str) -> List[Tuple[int, str]]:
    """(step, path) for every committed step under ``root``, ascending.
    Marker-less or ``.tmp`` dirs are invisible by design — they are torn
    writes (kill mid-commit, partial mirror upload)."""
    out = []
    try:
        names = os.listdir(root)
    except OSError:
        return []
    for name in names:
        step = parse_step_dirname(name)
        path = os.path.join(root, name)
        if step is not None and is_committed(path):
            out.append((step, path))
    return sorted(out)


def partial_dirs(root: str) -> List[str]:
    """Torn-write debris under ``root``: ``.tmp`` dirs and final-named
    dirs missing their commit marker. GC candidates."""
    out = []
    try:
        names = os.listdir(root)
    except OSError:
        return []
    for name in names:
        path = os.path.join(root, name)
        if not os.path.isdir(path):
            continue
        if name.endswith(TMP_SUFFIX) and \
                parse_step_dirname(name[:-len(TMP_SUFFIX)]) is not None:
            out.append(path)
        elif parse_step_dirname(name) is not None and not is_committed(path):
            out.append(path)
    return sorted(out)


def load_host_arrays(step_dir: str, host: int,
                     verify: bool = True) -> Dict[str, HostArray]:
    """Read one host's arrays, checksum-verified. Raises CheckpointError
    on a truncated shard or any crc32 mismatch — a torn or bit-rotted
    write must never restore silently."""
    manifest = read_json(os.path.join(step_dir, host_manifest_name(host)))
    shard_path = os.path.join(step_dir, manifest['shard'])
    try:
        size = os.path.getsize(shard_path)
    except OSError as e:
        raise CorruptionError(f'{step_dir}: missing shard '
                              f'{manifest["shard"]}: {e}') from e
    if size != manifest['shard_nbytes']:
        raise CorruptionError(
            f'{step_dir}: truncated shard {manifest["shard"]}: '
            f'{size} bytes on disk, manifest says '
            f'{manifest["shard_nbytes"]}')
    out: Dict[str, HostArray] = {}
    with open(shard_path, 'rb') as f:
        for entry in manifest['arrays']:
            f.seek(entry['offset'])
            raw = f.read(entry['nbytes'])
            if len(raw) != entry['nbytes']:
                raise CorruptionError(
                    f'{step_dir}: short read for {entry["name"]!r}')
            if verify and (zlib.crc32(raw) & 0xFFFFFFFF) != entry['crc32']:
                raise CorruptionError(
                    f'{step_dir}: checksum mismatch for {entry["name"]!r} '
                    f'in {manifest["shard"]} — corrupt or torn write')
            out[entry['name']] = _host_array(raw, entry)
    return out


def default_readers() -> int:
    """Reader-pool width for shard-parallel range reads
    (SKYTPU_CKPT_READERS; floor 1). One knob shared by the parallel
    restore and deep verify."""
    try:
        n = int(os.environ.get('SKYTPU_CKPT_READERS', '8') or '8')
    except ValueError:
        n = 8
    return max(n, 1)


def _read_range(fd: int, entry: Dict[str, Any], step_dir: str,
                shard: str, verify: bool) -> bytes:
    """One array's byte range off the shared shard fd (``os.pread`` —
    positional, so concurrent readers never fight over a file offset),
    checksum-verified in the reader thread so crc32 work parallelizes
    with the reads themselves."""
    raw = os.pread(fd, entry['nbytes'], entry['offset'])
    if len(raw) != entry['nbytes']:
        raise CorruptionError(
            f'{step_dir}: short read for {entry["name"]!r}')
    if verify and (zlib.crc32(raw) & 0xFFFFFFFF) != entry['crc32']:
        raise CorruptionError(
            f'{step_dir}: checksum mismatch for {entry["name"]!r} '
            f'in {shard} — corrupt or torn write')
    return raw


def _iter_host_ranges(step_dir: str, host: int, *, verify: bool = True,
                      readers: Optional[int] = None,
                      ) -> Iterator[Tuple[Dict[str, Any], bytes]]:
    """Shard-parallel range reads: yield ``(entry, raw)`` in manifest
    order while a bounded reader pool prefetches and checksums LATER
    ranges (window = 2x pool, so the consumer never waits on a read it
    could have overlapped — the restore path's host-to-device copy runs
    while the pool fetches ahead). The shared range-read helper behind
    the parallel restore and deep verify; stdlib-only, same
    truncation/crc32 failure contract as the sequential
    ``load_host_arrays``."""
    manifest = read_json(os.path.join(step_dir, host_manifest_name(host)))
    shard_path = os.path.join(step_dir, manifest['shard'])
    try:
        size = os.path.getsize(shard_path)
    except OSError as e:
        raise CorruptionError(f'{step_dir}: missing shard '
                              f'{manifest["shard"]}: {e}') from e
    if size != manifest['shard_nbytes']:
        raise CorruptionError(
            f'{step_dir}: truncated shard {manifest["shard"]}: '
            f'{size} bytes on disk, manifest says '
            f'{manifest["shard_nbytes"]}')
    pool = readers if readers is not None else default_readers()
    pool = max(int(pool), 1)
    fd = os.open(shard_path, os.O_RDONLY)
    try:
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=pool,
                thread_name_prefix='skytpu-ckpt-read') as ex:
            entries = iter(manifest['arrays'])
            inflight: 'collections.deque' = collections.deque()
            for entry in itertools.islice(entries, pool * 2):
                inflight.append((entry, ex.submit(
                    _read_range, fd, entry, step_dir,
                    manifest['shard'], verify)))
            while inflight:
                entry, fut = inflight.popleft()
                raw = fut.result()  # re-raises CorruptionError
                nxt = next(entries, None)
                if nxt is not None:
                    inflight.append((nxt, ex.submit(
                        _read_range, fd, nxt, step_dir,
                        manifest['shard'], verify)))
                yield entry, raw
    finally:
        os.close(fd)


def iter_host_arrays(step_dir: str, host: int, *, verify: bool = True,
                     readers: Optional[int] = None,
                     ) -> Iterator[Tuple[str, HostArray]]:
    """Streaming shard-parallel restore: ``(name, array)`` in manifest
    order, ranges fetched/checksummed by the bounded reader pool
    (:func:`_iter_host_ranges`). The restore path consumes this lazily
    so host→device transfer of array N overlaps the fetch of N+1."""
    for entry, raw in _iter_host_ranges(step_dir, host, verify=verify,
                                        readers=readers):
        yield entry['name'], _host_array(raw, entry)


def load_host_arrays_parallel(step_dir: str, host: int,
                              verify: bool = True,
                              readers: Optional[int] = None,
                              ) -> Dict[str, HostArray]:
    """Drop-in parallel equivalent of :func:`load_host_arrays` — byte-
    identical result (tests assert it), reads issued by the bounded
    pool instead of one sequential seek/read loop."""
    return dict(iter_host_arrays(step_dir, host, verify=verify,
                                 readers=readers))


def verify_step(step_dir: str, deep: bool = True,
                readers: Optional[int] = None) -> Dict[str, Any]:
    """Validate one step dir; never raises. ``deep`` re-reads every
    array's byte range and checks its crc32 through the SAME bounded
    reader pool the parallel restore uses (the restore-path check);
    shallow only validates manifests + shard sizes. ``readers``
    overrides the pool width (default SKYTPU_CKPT_READERS)."""
    report: Dict[str, Any] = {
        'path': step_dir,
        'step': parse_step_dirname(os.path.basename(step_dir)),
        'committed': is_committed(step_dir),
        'hosts': 0, 'arrays': 0, 'nbytes': 0,
        'ok': False, 'errors': [],
    }
    if not report['committed']:
        report['errors'].append(
            'uncommitted (missing COMMIT marker or MANIFEST.json)')
        return report
    try:
        top = read_manifest(step_dir)
        num_hosts = int(top.get('num_hosts', 1))
        if top.get('step') != report['step']:
            raise CheckpointError(
                f'{step_dir}: manifest step {top.get("step")} does not '
                f'match directory name')
        report['hosts'] = num_hosts
        for host in range(num_hosts):
            hm = read_json(os.path.join(step_dir,
                                        host_manifest_name(host)))
            shard_path = os.path.join(step_dir, hm['shard'])
            size = os.path.getsize(shard_path)
            if size != hm['shard_nbytes']:
                raise CheckpointError(
                    f'{step_dir}: truncated shard {hm["shard"]}: {size} '
                    f'!= {hm["shard_nbytes"]}')
            report['arrays'] += len(hm['arrays'])
            report['nbytes'] += hm['shard_nbytes']
            if deep:
                for _ in _iter_host_ranges(step_dir, host, verify=True,
                                           readers=readers):
                    pass  # drain: the pool checksums every range
    except (CheckpointError, OSError, KeyError, TypeError,
            ValueError) as e:
        report['errors'].append(str(e))
        return report
    report['ok'] = True
    return report
