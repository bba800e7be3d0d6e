"""Disaggregated prefill/decode serving: the skytpu-kv/1 KV-handoff wire
layer.

Copy of ``skypilot_tpu/serve/disagg.py``, held to it by
``tests/test_torch_disagg.py``: for the same planes the header, the
payload and every crc32 are the bytes the JAX package writes, and each
package's ``parse`` reads the other's payloads and staging files.

A prefill-role replica computes a prompt's KV (``models/engine.py``
``submit_prefill``), serializes it here, and a decode-role replica
imports it (``submit_import``) and resumes continuous decode, with greedy
output byte-identical to colocated serving.

Wire format (``skytpu-kv/1``)::

    MAGIC 'SKYTPUKV1' | u32 header_len | header JSON | plane bytes...

The header carries the request state (prompt tokens, first sampled
token, sampling params, generation budget) plus a manifest of the plane
records that follow: per plane dtype/shape/nbytes/crc32, the convention
of the checkpoint manifest (``ckpt/manifest.py``). A reader rejects any
truncation or bit-flip before a single byte reaches the device.

numpy has no bfloat16 on a machine without ``ml_dtypes``, so a bf16 plane
travels as a :class:`~skypilot_tpu_torch.ckpt.manifest.RawArray`: its
2-byte storage words under the dtype name ``'bfloat16'``, the name, bytes
and crc32 JAX writes from an ml_dtypes array. ``parse`` hands such planes
back as ``RawArray`` words, which the engine moves to the device as bf16.

Prefix references, not bytes: for the paged layout the prompt's
full-block chain (``models/paged.py`` ``BlockTrie``) is derivable from
the tokens and the block size, so the decode side can be asked
(``/v1/kv/prepare``) how many leading blocks it already holds; the
transfer then starts at ``skip_blocks`` and the import installs the
skipped prefix as local refcounted references.

Two transports: the same-host staging directory
(``SKYTPU_DISAGG_STAGING``; the payload written once, read by the decode
replica) and the payload over HTTP to ``/v1/kv/import``. Any
parse/compat/install error is a typed exception here, a 4xx on the
replica and a colocated fallback at the load balancer.
"""
from __future__ import annotations

import json
import os
import struct
import threading
import time
import uuid
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from skypilot_tpu_torch.ckpt.manifest import RawArray
from skypilot_tpu_torch.ckpt.manifest import resolve_dtype
from skypilot_tpu_torch.ckpt.manifest import WORD_DTYPES
from skypilot_tpu_torch.utils import atomic_io

MAGIC = b'SKYTPUKV1'
FORMAT = 'skytpu-kv/1'
_LEN = struct.Struct('<I')

# Parked exports (awaiting fetch) expire after this; staging files are
# swept on the same horizon.
DEFAULT_TTL_S = float(os.environ.get('SKYTPU_DISAGG_TTL_S', '60'))
STAGING_ENV = 'SKYTPU_DISAGG_STAGING'
STAGING_SUFFIX = '.kvh'


class DisaggError(Exception):
    """Base: anything that should trigger the colocated fallback."""


class DisaggFormatError(DisaggError):
    """Corrupt/truncated payload (bad magic, short read, crc32
    mismatch): the bytes are unusable; reject before device install."""


class DisaggCompatError(DisaggError):
    """A well-formed payload this replica cannot install (model /
    layout / kv dtype / block-size mismatch)."""


def _block(arr, b: int):
    """Block ``b`` of a paged plane [L, nb, ...] (a view)."""
    if isinstance(arr, RawArray):
        return RawArray(arr.words[:, b], arr.dtype)
    return arr[:, b]


def _host(arr) -> Tuple[str, np.ndarray]:
    """(the dtype name the header records, the C-order array whose bytes
    the payload carries) of one plane."""
    if isinstance(arr, RawArray):
        return arr.dtype, np.ascontiguousarray(arr.words)
    arr = np.ascontiguousarray(arr)
    return str(arr.dtype), arr


def _planes(handoff) -> List[Tuple[str, Optional[int], Any]]:
    """(name, block_index_or_None, array) records in stream order.
    Paged handoffs serialize PER BLOCK (each block a unit with its own
    checksums, so ``skip_blocks`` slicing and chunked transfer align
    with validation); dense handoffs are one record."""
    out: List[Tuple[str, Optional[int], Any]] = []
    if handoff.layout == 'paged':
        for b in range(handoff.n_blocks):
            out.append(('k', b, _block(handoff.k, b)))
            out.append(('v', b, _block(handoff.v, b)))
            if handoff.k_s is not None:
                out.append(('k_s', b, _block(handoff.k_s, b)))
                out.append(('v_s', b, _block(handoff.v_s, b)))
    else:
        out.append(('k', None, handoff.k))
        out.append(('v', None, handoff.v))
        if handoff.k_s is not None:
            out.append(('k_s', None, handoff.k_s))
            out.append(('v_s', None, handoff.v_s))
    return out


def build_header(handoff, *, model: str, kv_cache: str,
                 skip_blocks: int = 0) -> Dict[str, Any]:
    """The payload header: request state + plane manifest. With
    ``skip_blocks`` > 0 (paged only) the first ``skip_blocks`` FULL
    blocks transfer as references: their plane records are omitted
    and the importer resolves them against its own trie."""
    if skip_blocks and handoff.layout != 'paged':
        raise ValueError('skip_blocks requires the paged layout')
    if skip_blocks > handoff.full_blocks:
        raise ValueError(
            f'skip_blocks {skip_blocks} exceeds the shareable chain '
            f'({handoff.full_blocks} full blocks)')
    planes = []
    for name, b, arr in _planes(handoff):
        if b is not None and b < skip_blocks:
            continue
        dtype, arr = _host(arr)
        planes.append({'name': name, 'block': b,
                       'dtype': dtype, 'shape': list(arr.shape),
                       'nbytes': int(arr.nbytes),
                       'crc32': zlib.crc32(arr.tobytes()) & 0xFFFFFFFF})
    return {
        'format': FORMAT, 'model': model, 'kv_cache': kv_cache,
        'layout': handoff.layout, 'block': handoff.block,
        'n_blocks': handoff.n_blocks, 'skip_blocks': int(skip_blocks),
        'prompt_len': handoff.prompt_len,
        'row': list(handoff.row), 'first': int(handoff.first),
        'max_new': int(handoff.max_new),
        'temperature': float(handoff.temperature),
        'top_k': int(handoff.top_k), 'top_p': float(handoff.top_p),
        'eos': sorted(handoff.eos) if handoff.eos else None,
        'planes': planes,
    }


def serialize(handoff, header: Dict[str, Any]) -> Iterator[bytes]:
    """Yield the payload as chunks: header first, then one chunk per
    plane record (the natural units for a chunked HTTP POST)."""
    hdr = json.dumps(header).encode()
    yield MAGIC + _LEN.pack(len(hdr)) + hdr
    skip = int(header.get('skip_blocks') or 0)
    for _, b, arr in _planes(handoff):
        if b is not None and b < skip:
            continue
        yield _host(arr)[1].tobytes()


def serialize_bytes(handoff, header: Dict[str, Any]) -> bytes:
    return b''.join(serialize(handoff, header))


def payload_nbytes(header: Dict[str, Any]) -> int:
    hdr = json.dumps(header).encode()
    return (len(MAGIC) + _LEN.size + len(hdr)
            + sum(p['nbytes'] for p in header['planes']))


def parse(data: bytes) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Parse + VALIDATE a payload. Returns (header, arrays) where the
    paged arrays are re-stacked [L, nb_present, ...] starting at
    ``skip_blocks``; a bf16 plane is a ``RawArray`` of its words. Raises
    ``DisaggFormatError`` on any truncation, bad magic, or checksum
    mismatch: corrupt bytes never reach the device."""
    if len(data) < len(MAGIC) + _LEN.size or not data.startswith(MAGIC):
        raise DisaggFormatError('bad handoff magic')
    off = len(MAGIC)
    (hlen,) = _LEN.unpack_from(data, off)
    off += _LEN.size
    if off + hlen > len(data):
        raise DisaggFormatError('truncated handoff header')
    try:
        header = json.loads(bytes(data[off:off + hlen]).decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise DisaggFormatError(f'unreadable handoff header: {e}') from e
    if not isinstance(header, dict) or header.get('format') != FORMAT:
        raise DisaggFormatError(
            f'unknown handoff format {header.get("format")!r}'
            if isinstance(header, dict) else 'non-object handoff header')
    off += hlen
    per_plane: Dict[str, List[np.ndarray]] = {}
    dtypes: Dict[str, str] = {}
    for rec in header.get('planes') or []:
        n = int(rec['nbytes'])
        if off + n > len(data):
            raise DisaggFormatError(
                f'truncated handoff payload at plane {rec["name"]}'
                f'/block {rec["block"]}: need {n} bytes, '
                f'{len(data) - off} left')
        raw = data[off:off + n]
        off += n
        if (zlib.crc32(raw) & 0xFFFFFFFF) != rec['crc32']:
            raise DisaggFormatError(
                f'crc32 mismatch on plane {rec["name"]}/block '
                f'{rec["block"]}: corrupt or torn handoff')
        arr = np.frombuffer(raw, dtype=resolve_dtype(rec['dtype']))
        arr = arr.reshape(rec['shape'])
        per_plane.setdefault(rec['name'], []).append(arr)
        dtypes[rec['name']] = rec['dtype']
    arrays: Dict[str, Any] = {}
    for name, parts in per_plane.items():
        if header.get('layout') == 'paged':
            # Blocks were serialized [L, H, P(, D)] each; restack on a
            # new block axis 1 -> [L, nb_present, H, P(, D)].
            arr = np.stack(parts, axis=1)
        else:
            arr = parts[0]
        arrays[name] = (RawArray(arr, dtypes[name])
                        if dtypes[name] in WORD_DTYPES else arr)
    return header, arrays


def import_kwargs(header: Dict[str, Any],
                  arrays: Dict[str, Any]) -> Dict[str, Any]:
    """The ``ContinuousEngine.submit_import`` kwargs for a parsed
    payload (sampling state rebuilt, eos renormalized)."""
    eos = header.get('eos')
    return dict(
        row=[int(t) for t in header['row']],
        max_new=int(header['max_new']), first=int(header['first']),
        temperature=float(header.get('temperature') or 0.0),
        top_k=int(header.get('top_k') or 0),
        top_p=float(header.get('top_p') or 1.0),
        eos=frozenset(int(t) for t in eos) if eos else None,
        layout=header.get('layout') or 'paged',
        block_start=int(header.get('skip_blocks') or 0),
        k=arrays.get('k'), v=arrays.get('v'),
        k_s=arrays.get('k_s'), v_s=arrays.get('v_s'))


def check_compat(header: Dict[str, Any], *, model: str, kv_cache: str,
                 kv_layout: str, kv_block: int, max_len: int) -> None:
    """Raise ``DisaggCompatError`` unless this replica can install the
    payload byte-exactly."""
    want = {'model': model, 'kv_cache': kv_cache, 'layout': kv_layout}
    for key, mine in want.items():
        theirs = header.get(key)
        if theirs != mine:
            raise DisaggCompatError(
                f'handoff {key} {theirs!r} != replica {mine!r}')
    if kv_layout == 'paged' and int(header.get('block') or 0) != kv_block:
        raise DisaggCompatError(
            f'handoff block size {header.get("block")} != replica '
            f'{kv_block}')
    if len(header.get('row') or []) + int(header.get('max_new') or 0) \
            > max_len:
        raise DisaggCompatError(
            f'prompt + max_new exceeds replica max_len {max_len}')


# ---------------------------------------------------------------------------
# Parked exports: a prefill replica holds the host-side handoff between
# /v1/kv/export (header returned to the LB) and /v1/kv/fetch (bytes
# pulled, possibly skipping negotiated blocks). Device blocks are
# already released by then: parking costs host memory only, bounded by
# the TTL sweep (an LB that died mid-flow leaks nothing durable).


class HandoffRegistry:

    def __init__(self, ttl_s: float = DEFAULT_TTL_S):
        self.ttl_s = ttl_s
        self._lock = threading.Lock()
        self._entries: Dict[str, Tuple[float, Any]] = {}
        self.expired = 0

    def _sweep_locked(self, now: float) -> None:
        dead = [hid for hid, (exp, _) in self._entries.items()
                if exp < now]
        for hid in dead:
            del self._entries[hid]
        self.expired += len(dead)

    def put(self, handoff) -> str:
        hid = uuid.uuid4().hex
        now = time.time()
        with self._lock:
            self._sweep_locked(now)
            self._entries[hid] = (now + self.ttl_s, handoff)
        return hid

    def pop(self, hid: str):
        """One-shot claim; None when unknown/expired."""
        now = time.time()
        with self._lock:
            self._sweep_locked(now)
            entry = self._entries.pop(hid, None)
        return entry[1] if entry is not None else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# ---------------------------------------------------------------------------
# Same-host staging: the full payload written once by the prefill
# replica, read directly by a decode replica sharing the directory.
# Atomic via tmp-write + rename; refs are bare basenames so a hostile
# ref cannot traverse out of the dir.


def write_staging(staging_dir: str, handoff,
                  header: Dict[str, Any]) -> Tuple[str, int]:
    """Write the full payload; returns (ref, nbytes). Opportunistically
    sweeps refs older than the TTL (abandoned flows)."""
    os.makedirs(staging_dir, exist_ok=True)
    now = time.time()
    for name in os.listdir(staging_dir):
        if not name.endswith(STAGING_SUFFIX):
            continue
        path = os.path.join(staging_dir, name)
        try:
            if now - os.path.getmtime(path) > DEFAULT_TTL_S:
                os.unlink(path)
        except OSError:
            pass
    ref = uuid.uuid4().hex + STAGING_SUFFIX

    def _writer(f) -> int:
        n = 0
        for chunk in serialize(handoff, header):
            f.write(chunk)
            n += len(chunk)
        return n

    # The sweep above matches *STAGING_SUFFIX names only, so a failed
    # write must not strand its '.tmp': atomic_write unlinks it before
    # the error propagates (the LB then falls back to colocated).
    nbytes = atomic_io.atomic_write(
        os.path.join(staging_dir, ref), _writer, mode='wb', fsync=True)
    return ref, nbytes


def read_staging(staging_dir: Optional[str], ref: str) -> bytes:
    if not staging_dir:
        raise DisaggError('no staging dir configured on this replica')
    if os.path.basename(ref) != ref or not ref.endswith(STAGING_SUFFIX):
        raise DisaggError(f'invalid staging ref {ref!r}')
    path = os.path.join(staging_dir, ref)
    try:
        with open(path, 'rb') as f:
            return f.read()
    except OSError as e:
        raise DisaggError(f'staging ref unreadable: {e}') from e
