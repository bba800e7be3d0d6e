"""Hierarchical KV memory: device pool -> host DRAM -> spill-dir store.

Port of ``skypilot_tpu/serve/kv_tiers.py``: the memory ladder under the
paged engine's share trie (``models/paged.py`` ``BlockTrie``). Eviction
of idle trie chains would otherwise discard KV that cost prefill to
build.

* **Demote** (device -> host): when ``_alloc_blocks`` evicts idle trie
  chains, the engine thread issues ONE pow2-padded
  ``paged._export_blocks_impl`` gather on the compute stream, before the
  freed ids can be rescattered, and starts a non-blocking copy of the
  gathered planes into pinned host memory with an event after it
  (``models/engine.py`` ``_HostCopy``). This module's background thread
  waits on that event alone, never on the stream (a ``.cpu()`` would
  wait for the decode chunk in flight), and serializes each block as
  checksummed planes into the bounded :class:`HostPool`.
* **Spill** (host -> disk): when the host pool exceeds
  ``SKYTPU_KV_HOST_BYTES`` its coldest entries are batched into
  range-readable ``skytpu-kvseg/1`` segment files (offset/nbytes/crc32
  per plane, tmp-write + rename via ``utils/atomic_io``), written by the
  same background thread. The files are byte for byte the JAX package's:
  either package reads the other's.
* **Promote** (host -> device): ``ContinuousEngine._admit`` consults
  :meth:`KVTiers.lookup` before declaring a trie miss; host-resident
  blocks re-import through ``paged._import_blocks_impl`` (shape and dtype
  validated first; a corrupt entry is quarantined and the request
  recomputes). Spill-resident chains are fetched by the background
  thread (at most ``SKYTPU_KV_FETCH_MAX`` at once) while the request
  parks; completion re-queues it at the head.

Planes travel as numpy arrays. A bf16 plane is its uint16 storage words
under the dtype name ``bfloat16`` (the card's machine has no numpy
bfloat16), which are the bytes JAX writes for it. The expected K/V plane
dtype is the pool's (``kv_dtype``): the JAX module fixes it to
``bfloat16``, so there a float32 pool's chains never promote (ROADMAP
§3).

Corruption contract: every byte is crc32-checked at the tier boundary;
any mismatch quarantines the chain digest, and later lookups miss.
Tiering can never lose or fail a request.

Thread/lock discipline: the engine calls into this module under ITS
lock; this module's own lock is leaf-level (engine lock -> KVTiers lock,
never the reverse: completion callbacks fire with no KVTiers lock held).
The JAX module's trace spans are not ported.
"""
from __future__ import annotations

import collections
import json
import os
import struct
import threading
import time
import uuid
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from skypilot_tpu_torch.utils import atomic_io

SEG_MAGIC = b'SKYTPUSEG1'
SEG_FORMAT = 'skytpu-kvseg/1'
SEG_SUFFIX = '.seg'
_LEN = struct.Struct('<I')

# Engine-side demote queue bound: chains offered past this are simply
# dropped (a missed demotion is a future recompute, never an error).
_DEMOTE_QUEUE_MAX = 64
# A HOT chain (one that served a share hit) is still taken until the
# queue holds this many times the bound: under a burst of evictions the
# one-shot suffixes are dropped first and the shared prefixes a later
# request would promote are kept.
_HOT_HEADROOM = 4
# Bounded scan width for the decayed-hotness eviction pick: the LRU
# front is the cold end; among its first K entries the coldest by
# decayed hit count goes first (a recently-inserted-but-never-hit
# entry must not outlive a genuinely hot old-timer).
_EVICT_SCAN = 8

# Plane dtypes numpy lacks travel as storage words of this dtype.
_WORDS = {'bfloat16': np.dtype(np.uint16)}


def _crc(b: bytes) -> int:
    return zlib.crc32(b) & 0xFFFFFFFF


class TierEntry:
    """One demoted full KV block: the token row of its whole chain
    (root -> this block) plus checksummed plane bytes in the JAX package's
    plane convention (k/v [L, H, P, D], k_s/v_s [L, H, P])."""

    __slots__ = ('digest', 'row', 'planes', 'nbytes', 'hits', 'hit_tick')

    def __init__(self, digest: bytes, row: List[int],
                 planes: List[Dict[str, Any]]):
        self.digest = digest
        self.row = row
        # [{'name','dtype','shape','nbytes','crc32','data'}] — 'data'
        # present host-side, absent for spill-index entries (the bytes
        # live in the segment file at 'offset').
        self.planes = planes
        self.nbytes = sum(int(p['nbytes']) for p in planes)
        self.hits = 0.0
        self.hit_tick = 0


class HostPool:
    """Bounded host-DRAM tier: digest -> TierEntry, capacity-managed
    by a decayed-hotness LRU. All methods assume the caller holds the
    owning :class:`KVTiers` lock."""

    HITS_HALF_LIFE = 512  # lookup events, mirroring BlockTrie's clock

    def __init__(self, cap_bytes: int):
        self.cap_bytes = cap_bytes
        self.entries: 'collections.OrderedDict[bytes, TierEntry]' = \
            collections.OrderedDict()
        self.bytes = 0
        self._tick = 0

    def __contains__(self, digest: bytes) -> bool:
        return digest in self.entries

    def _hotness(self, e: TierEntry) -> float:
        if e.hits <= 0.0:
            return 0.0
        return e.hits * 0.5 ** ((self._tick - e.hit_tick)
                                / self.HITS_HALF_LIFE)

    def touch(self, digest: bytes) -> None:
        e = self.entries.get(digest)
        if e is None:
            return
        self._tick += 1
        e.hits = self._hotness(e) + 1.0
        e.hit_tick = self._tick
        self.entries.move_to_end(digest)

    def insert(self, entry: TierEntry) -> TierEntry:
        """Admit ``entry`` (newest end). The entry is OWNED by the
        pool from here: capacity eviction (:meth:`evict_cold`) or
        promotion (:meth:`pop`) releases it. Returns the entry so
        call-site ownership visibly escapes into the pool."""
        self.entries[entry.digest] = entry
        self.bytes += entry.nbytes
        return entry

    def pop(self, digest: bytes) -> Optional[TierEntry]:
        e = self.entries.pop(digest, None)
        if e is not None:
            self.bytes -= e.nbytes
        return e

    def over_capacity(self) -> bool:
        return self.cap_bytes > 0 and self.bytes > self.cap_bytes

    def evict_cold(self) -> Optional[TierEntry]:
        """Pop the coldest entry: scan the LRU front (oldest
        ``_EVICT_SCAN``) and take the lowest decayed hotness — pure
        insertion-order LRU would let one early hot chain be flushed
        by a drive-by scan of one-shot prefixes."""
        if not self.entries:
            return None
        front = []
        for digest in self.entries:
            front.append(digest)
            if len(front) >= _EVICT_SCAN:
                break
        coldest = min(front,
                      key=lambda d: self._hotness(self.entries[d]))
        return self.pop(coldest)


class SpillStore:
    """Range-readable segment files in the spill directory. A
    segment holds a batch of demoted entries::

        SEG_MAGIC | u32 len | manifest JSON | payload bytes

    The manifest records, per entry, the digest + token row and per
    plane ``offset`` (into the payload region) / ``nbytes`` / crc32 /
    dtype / shape — the ckpt-manifest convention, so a promote reads
    exactly the ranges it needs. Writes are tmp + rename
    (``atomic_io``), so a torn write leaves NO visible segment;
    :meth:`load_index` additionally drops any file whose manifest is
    unreadable or whose payload extents exceed the file size (a
    partial file is invisible to the index). Caller holds the KVTiers
    lock for index mutation; file I/O happens on the background
    thread only."""

    def __init__(self, root: str):
        self.root = root
        # digest -> (path, entry-manifest dict)
        self.index: Dict[bytes, Tuple[str, Dict[str, Any]]] = {}
        # path -> live digests (file unlinked when its set drains)
        self._file_live: Dict[str, set] = {}
        self.bytes = 0
        self.load_errors = 0

    def __contains__(self, digest: bytes) -> bool:
        return digest in self.index

    def load_index(self) -> int:
        """(Re)build the index from the directory. Returns entries
        admitted; torn/truncated/unparseable segments are skipped and
        counted in ``load_errors``."""
        self.index.clear()
        self._file_live.clear()
        self.bytes = 0
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return 0
        for name in names:
            if not name.endswith(SEG_SUFFIX):
                continue
            path = os.path.join(self.root, name)
            try:
                size = os.path.getsize(path)
                with open(path, 'rb') as f:
                    head = f.read(len(SEG_MAGIC) + _LEN.size)
                    if not head.startswith(SEG_MAGIC) or \
                            len(head) < len(SEG_MAGIC) + _LEN.size:
                        raise ValueError('bad segment magic')
                    (hlen,) = _LEN.unpack_from(head, len(SEG_MAGIC))
                    manifest = json.loads(f.read(hlen).decode())
            except (OSError, ValueError, UnicodeDecodeError):
                self.load_errors += 1
                continue
            if not isinstance(manifest, dict) or \
                    manifest.get('format') != SEG_FORMAT:
                self.load_errors += 1
                continue
            base = len(SEG_MAGIC) + _LEN.size + hlen
            entries = manifest.get('entries') or []
            # Whole-or-nothing per file: if ANY advertised range falls
            # outside the file, the write was torn — nothing in it is
            # trustworthy enough to serve.
            try:
                extent = max((base + int(p['offset']) + int(p['nbytes'])
                              for e in entries for p in e['planes']),
                             default=base)
            except (KeyError, TypeError, ValueError):
                self.load_errors += 1
                continue
            if extent > size:
                self.load_errors += 1
                continue
            for e in entries:
                try:
                    digest = bytes.fromhex(e['digest'])
                except (KeyError, ValueError):
                    self.load_errors += 1
                    continue
                self.index[digest] = (path, e)
                self._file_live.setdefault(path, set()).add(digest)
                self.bytes += sum(int(p['nbytes']) for p in e['planes'])
        return len(self.index)

    def write_segment(self, entries: List[TierEntry]) -> Optional[str]:
        """Serialize ``entries`` into one new segment (background
        thread). Returns the path, or None on I/O failure (the
        entries are then simply dropped — spill is best-effort)."""
        os.makedirs(self.root, exist_ok=True)
        recs = []
        blobs: List[bytes] = []
        off = 0
        for e in entries:
            planes = []
            for p in e.planes:
                data = p['data']
                planes.append({'name': p['name'], 'offset': off,
                               'nbytes': int(p['nbytes']),
                               'crc32': int(p['crc32']),
                               'dtype': p['dtype'],
                               'shape': list(p['shape'])})
                blobs.append(data)
                off += len(data)
            recs.append({'digest': e.digest.hex(), 'row': list(e.row),
                         'planes': planes})
        manifest = json.dumps({'format': SEG_FORMAT,
                               'entries': recs}).encode()
        path = os.path.join(self.root,
                            'seg-' + uuid.uuid4().hex + SEG_SUFFIX)

        def _writer(f) -> int:
            f.write(SEG_MAGIC + _LEN.pack(len(manifest)) + manifest)
            for b in blobs:
                f.write(b)
            return 1

        try:
            atomic_io.atomic_write(path, _writer, mode='wb', fsync=True)
        except OSError:
            return None
        return path

    def admit(self, path: str, entries: List[TierEntry]) -> None:
        """Index a just-written segment (caller holds the KVTiers
        lock). Entry manifests are rebuilt with offsets, data
        dropped."""
        off = 0
        for e in entries:
            planes = []
            for p in e.planes:
                planes.append({'name': p['name'], 'offset': off,
                               'nbytes': int(p['nbytes']),
                               'crc32': int(p['crc32']),
                               'dtype': p['dtype'],
                               'shape': list(p['shape'])})
                off += int(p['nbytes'])
            rec = {'digest': e.digest.hex(), 'row': list(e.row),
                   'planes': planes}
            self.index[e.digest] = (path, rec)
            self._file_live.setdefault(path, set()).add(e.digest)
            self.bytes += e.nbytes

    def remove(self, digest: bytes) -> None:
        """Drop an index entry (promoted or quarantined); a segment
        file whose every entry is gone is unlinked by the background
        thread via :meth:`drained_file`."""
        hit = self.index.pop(digest, None)
        if hit is None:
            return
        path, rec = hit
        self.bytes -= sum(int(p['nbytes']) for p in rec['planes'])
        live = self._file_live.get(path)
        if live is not None:
            live.discard(digest)

    def drained_file(self, path: str) -> bool:
        live = self._file_live.get(path)
        if live is not None and not live:
            del self._file_live[path]
            return True
        return False

    @staticmethod
    def read_entry(path: str, rec: Dict[str, Any],
                   hlen_cache: Dict[str, int]) -> List[Dict[str, Any]]:
        """Range-read one entry's planes off ``path`` and crc-verify
        each. Raises ValueError on any mismatch/short read (the caller
        quarantines). Background thread only."""
        base = hlen_cache.get(path)
        with open(path, 'rb') as f:
            if base is None:
                head = f.read(len(SEG_MAGIC) + _LEN.size)
                if not head.startswith(SEG_MAGIC):
                    raise ValueError('bad segment magic')
                (hlen,) = _LEN.unpack_from(head, len(SEG_MAGIC))
                base = len(SEG_MAGIC) + _LEN.size + hlen
                hlen_cache[path] = base
            out = []
            for p in rec['planes']:
                f.seek(base + int(p['offset']))
                raw = f.read(int(p['nbytes']))
                if len(raw) != int(p['nbytes']):
                    raise ValueError(
                        f"short read on plane {p['name']}")
                if _crc(raw) != int(p['crc32']):
                    raise ValueError(
                        f"crc32 mismatch on plane {p['name']} — "
                        'corrupt or torn spill segment')
                out.append({'name': p['name'], 'dtype': p['dtype'],
                            'shape': list(p['shape']),
                            'nbytes': int(p['nbytes']),
                            'crc32': int(p['crc32']), 'data': raw})
        return out


class _DemoteJob:
    __slots__ = ('items', 'handles', 'quantized')

    def __init__(self, items, handles, quantized):
        self.items = items        # [(digest, row, gather_index)]
        self.handles = handles    # (k, v, k_s, v_s) device arrays
        self.quantized = quantized


class KVTiers:
    """The engine-facing facade over the host + spill tiers plus the
    background demote/spill/fetch worker. See the module docstring for
    the ladder; see ``models/engine.py`` for the admission wiring."""

    def __init__(self, *, block: int, n_layers: int, n_kv_heads: int,
                 head_dim: int, quantized: bool,
                 host_bytes: int = 1 << 28, spill_dir: str = '',
                 fetch_max: int = 2, kv_dtype: str = 'bfloat16'):
        self.block = block
        self.quantized = quantized
        # Expected per-block plane geometry: the shape/dtype gate a
        # promote validates BEFORE any byte is staged for the device.
        # ``kv_dtype`` is the unquantized pool's dtype name.
        kdt = 'int8' if quantized else kv_dtype
        self._plane_spec: Dict[str, Tuple[Tuple[int, ...], str]] = {
            'k': ((n_layers, n_kv_heads, block, head_dim), kdt),
            'v': ((n_layers, n_kv_heads, block, head_dim), kdt),
        }
        if quantized:
            sshape = (n_layers, n_kv_heads, block)
            self._plane_spec['k_s'] = (sshape, 'float32')
            self._plane_spec['v_s'] = (sshape, 'float32')
        self._lock = threading.Lock()
        self._host = HostPool(int(host_bytes))
        self._spill = SpillStore(spill_dir) if spill_dir else None
        self.fetch_max = max(int(fetch_max), 1)
        self._quarantine: set = set()
        self._demote_q: 'collections.deque[_DemoteJob]' = \
            collections.deque()
        self._fetch_q: 'collections.deque[tuple]' = collections.deque()
        self._pending_demote: set = set()   # digests queued, not landed
        self._pending_fetch: set = set()
        self._wake = threading.Event()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._hlen_cache: Dict[str, int] = {}
        # A job popped and not yet finished (its spill may still be being
        # written after its digests left the pending sets).
        self._working = False
        # Stats (mirrored into engine.stats()['kv_tiers']).
        self.demotes = 0
        self.promotes = 0
        self.spills = 0
        self.reloads = 0
        self.fetches = 0
        self.corrupt = 0
        self.dropped = 0
        self.host_hits = 0
        self.spill_hits = 0
        self.demote_ms = 0.0
        self.promote_ms = 0.0
        if self._spill is not None:
            self._spill.load_index()

    @classmethod
    def from_env(cls, cfg, block: int, *,
                 quantized: bool) -> 'KVTiers':
        """Construct from the ``SKYTPU_KV_*`` deployment flags, for a pool
        of ``cfg.dtype`` (``SKYTPU_KV_HOST_BYTES``, default 256 MiB;
        ``SKYTPU_KV_SPILL_DIR``, default none; ``SKYTPU_KV_FETCH_MAX``,
        default 2)."""
        return cls(
            block=block, n_layers=cfg.n_layers,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            quantized=quantized,
            host_bytes=int(os.environ.get('SKYTPU_KV_HOST_BYTES',
                                          str(1 << 28))),
            spill_dir=os.environ.get('SKYTPU_KV_SPILL_DIR', ''),
            fetch_max=int(os.environ.get('SKYTPU_KV_FETCH_MAX', '2')),
            kv_dtype=str(cfg.dtype).replace('torch.', ''))

    # -- engine-side API (called under the ENGINE lock) -------------------

    def accepts(self, digest: bytes, hot: bool = False) -> bool:
        """Worth demoting? Not if the tier ladder already holds it, a
        corrupt copy poisoned it, or the demote queue is saturated (for
        a ``hot`` chain, ``_HOT_HEADROOM`` times saturated)."""
        with self._lock:
            if digest in self._quarantine or digest in self._host or \
                    digest in self._pending_demote:
                return False
            if self._spill is not None and digest in self._spill:
                return False
            bound = _DEMOTE_QUEUE_MAX * (_HOT_HEADROOM if hot else 1)
            return sum(len(j.items) for j in self._demote_q) < bound

    def offer_demote(self, items: List[Tuple[bytes, List[int], int]],
                     handles) -> None:
        """Park an issued eviction gather for background serialization.
        ``items`` are (digest, chain token row, index into the gather's
        block axis); ``handles`` the (k, v, k_s, v_s) planes on their way
        to the host, each None or an object whose ``numpy()`` waits for
        its own copy only. Engine thread, engine lock held: nothing here
        blocks. Past the hot bound every offer is dropped; the caller
        asked :meth:`accepts` for each item first."""
        with self._lock:
            if sum(len(j.items) for j in self._demote_q) >= \
                    _DEMOTE_QUEUE_MAX * _HOT_HEADROOM:
                self.dropped += len(items)
                return
            for digest, _row, _gi in items:
                self._pending_demote.add(digest)
            self._demote_q.append(
                _DemoteJob(items, handles, self.quantized))
        self._ensure_thread()
        self._wake.set()

    def lookup(self, digest: bytes) -> Optional[str]:
        """'host' | 'spilled' | None — the admission-time tier
        consult. Touches the host LRU on a hit."""
        with self._lock:
            if digest in self._quarantine:
                return None
            if digest in self._host:
                self._host.touch(digest)
                return 'host'
            if self._spill is not None and digest in self._spill:
                return 'spilled'
            return None

    def take_for_promote(self, digests: List[bytes]
                         ) -> List[Dict[str, np.ndarray]]:
        """Claim host-tier entries for re-import: crc-verify and
        shape/dtype-validate each, decode to arrays, POP from the pool
        (the blocks are becoming trie-resident again). Truncates at
        the first missing/invalid entry — the promoted head must stay
        chain-contiguous — and quarantines corrupt ones. Never
        raises."""
        t0 = time.perf_counter()
        out: List[Dict[str, np.ndarray]] = []
        with self._lock:
            for digest in digests:
                entry = self._host.pop(digest)
                if entry is None:
                    break
                arrays = self._decode_entry(entry)
                if arrays is None:
                    self._quarantine.add(digest)
                    self.corrupt += 1
                    break
                out.append(arrays)
            self.promotes += len(out)
            self.host_hits += len(out)
            self.promote_ms += (time.perf_counter() - t0) * 1e3
        return out

    def request_fetch(self, digests: List[bytes],
                      on_done: Callable[[List[bytes], bool], None]
                      ) -> bool:
        """Queue a background spill->host reload (bounded by
        ``fetch_max`` in-flight). Returns False when saturated or
        nothing fetchable — the caller treats that as a plain miss."""
        with self._lock:
            if self._spill is None:
                return False
            want = [d for d in digests
                    if d in self._spill and d not in self._pending_fetch
                    and d not in self._quarantine]
            if not want:
                # All already in flight: piggyback on the existing
                # fetch — its completion callback re-queues waiters.
                return any(d in self._pending_fetch for d in digests)
            if len(self._fetch_q) >= self.fetch_max:
                return False
            for d in want:
                self._pending_fetch.add(d)
            self._fetch_q.append((want, on_done))
        self._ensure_thread()
        self._wake.set()
        return True

    def resolve_rows(self, digests: List[bytes]
                     ) -> Dict[bytes, List[int]]:
        """Token rows for tier-resident chain digests — the
        remediation pre-warm extension: a drain-migrate reads the
        victim's HOST tier too, so a migration carries the long tail,
        not just the HBM-hot head."""
        out: Dict[bytes, List[int]] = {}
        with self._lock:
            for d in digests:
                e = self._host.entries.get(d)
                if e is not None:
                    out[d] = list(e.row)
                elif self._spill is not None and d in self._spill:
                    out[d] = [int(t)
                              for t in self._spill.index[d][1]['row']]
        return out

    def advert_entries(self, limit: int, exclude: set
                       ) -> Tuple[List[list], bool]:
        """Tier-tagged affinity-advert rows ``[chain_hex, depth,
        tier]`` (tier 1 = host, 2 = spilled), hottest-host-first, for
        the /health prefix summary. ``exclude`` holds chain hexes the
        HBM trie already advertises."""
        if limit <= 0:
            with self._lock:
                n = len(self._host.entries) + (
                    len(self._spill.index) if self._spill else 0)
            return [], n > 0
        rows: List[list] = []
        with self._lock:
            host = sorted(self._host.entries.values(),
                          key=self._host._hotness, reverse=True)
            for e in host:
                hexd = e.digest.hex()
                if hexd in exclude:
                    continue
                rows.append([hexd, len(e.row) // self.block, 1])
            if self._spill is not None:
                for d, (_path, rec) in self._spill.index.items():
                    hexd = d.hex()
                    if hexd in exclude:
                        continue
                    rows.append([hexd, len(rec['row']) // self.block, 2])
        return rows[:limit], len(rows) > limit

    def stats(self) -> dict:
        with self._lock:
            spilled = len(self._spill.index) if self._spill else 0
            return {
                'enabled': True,
                'host_blocks': len(self._host.entries),
                'host_bytes': self._host.bytes,
                'host_capacity_bytes': self._host.cap_bytes,
                'spilled_blocks': spilled,
                'spilled_bytes': self._spill.bytes if self._spill else 0,
                'spill_dir': bool(self._spill),
                'demotes': self.demotes, 'promotes': self.promotes,
                'spills': self.spills, 'reloads': self.reloads,
                'fetches': self.fetches, 'corrupt': self.corrupt,
                'quarantined': len(self._quarantine),
                'dropped': self.dropped,
                'host_hits': self.host_hits,
                'spill_hits': self.spill_hits,
                'demote_ms': round(self.demote_ms, 3),
                'promote_ms': round(self.promote_ms, 3),
            }

    # -- lifecycle ---------------------------------------------------------

    def _ensure_thread(self) -> None:
        t = self._thread
        if t is not None and t.is_alive():
            return
        self._stop = False
        self._thread = threading.Thread(target=self._worker,
                                        name='kv-tiers', daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop = True
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10)

    def quiesce(self, timeout_s: float = 30.0) -> bool:
        """Wait for the demote/fetch queues to drain and the job in hand
        to finish, its spill segment included (tests and
        ``chip_smoke.py``; serving never blocks on the tier thread). The
        JAX module's version can return while that segment is still being
        written (ROADMAP §3)."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            with self._lock:
                idle = not self._demote_q and not self._fetch_q \
                    and not self._pending_demote \
                    and not self._pending_fetch and not self._working
            if idle:
                return True
            time.sleep(0.01)
        return False

    # -- background worker -------------------------------------------------

    def _worker(self) -> None:
        while not self._stop:
            with self._lock:
                job = self._demote_q.popleft() if self._demote_q \
                    else None
                fetch = None
                if job is None and self._fetch_q:
                    fetch = self._fetch_q.popleft()
                self._working = job is not None or fetch is not None
            try:
                if job is not None:
                    try:
                        self._drain_demote(job)
                    except Exception:  # noqa: BLE001 — best-effort tier
                        with self._lock:
                            for digest, _r, _gi in job.items:
                                self._pending_demote.discard(digest)
                            self.dropped += len(job.items)
                    continue
                if fetch is not None:
                    self._drain_fetch(*fetch)
                    continue
            finally:
                with self._lock:
                    self._working = False
            self._wake.wait(0.2)
            self._wake.clear()

    def _drain_demote(self, job: _DemoteJob) -> None:
        """Background thread: wait for the demoted planes' own host
        copies (never for the device stream), then checksum them into
        the host pool and spill what overflows it."""
        tp = time.perf_counter()
        k, v, k_s, v_s = (None if h is None else h.numpy()
                          for h in job.handles)
        landed: List[TierEntry] = []
        for digest, row, gi in job.items:
            planes = [self._plane(n, a[:, gi])
                      for n, a in (('k', k), ('v', v))]
            if k_s is not None:
                planes.append(self._plane('k_s', k_s[:, gi]))
                planes.append(self._plane('v_s', v_s[:, gi]))
            landed.append(TierEntry(digest, row, planes))
        spill_batch: List[TierEntry] = []
        with self._lock:
            for e in landed:
                self._pending_demote.discard(e.digest)
                if e.digest in self._host or e.digest in self._quarantine:
                    continue
                self._host.insert(e)
                self.demotes += 1
            while self._host.over_capacity():
                cold = self._host.evict_cold()
                if cold is None:
                    break
                if self._spill is not None:
                    spill_batch.append(cold)
                else:
                    self.dropped += 1
            self.demote_ms += (time.perf_counter() - tp) * 1e3
        if spill_batch:
            self._spill_entries(spill_batch)

    def _spill_entries(self, batch: List[TierEntry]) -> None:
        path = self._spill.write_segment(batch)
        with self._lock:
            if path is None:
                self.dropped += len(batch)
                return
            self._spill.admit(path, batch)
            self.spills += len(batch)

    def _drain_fetch(self, digests: List[bytes], on_done) -> None:
        ok = True
        loaded: List[TierEntry] = []
        drained: List[str] = []
        for digest in digests:
            with self._lock:
                hit = self._spill.index.get(digest) \
                    if self._spill is not None else None
            if hit is None:
                continue
            path, rec = hit
            try:
                planes = SpillStore.read_entry(path, rec,
                                               self._hlen_cache)
            except (OSError, ValueError):
                ok = False
                with self._lock:
                    self._quarantine.add(digest)
                    self._spill.remove(digest)
                    if self._spill.drained_file(path):
                        drained.append(path)
                    self.corrupt += 1
                continue
            loaded.append(TierEntry(
                digest, [int(t) for t in rec['row']], planes))
            with self._lock:
                self._spill.remove(digest)
                if self._spill.drained_file(path):
                    drained.append(path)
        spill_batch: List[TierEntry] = []
        with self._lock:
            for e in loaded:
                if e.digest not in self._host:
                    self._host.insert(e)
                    self._host.touch(e.digest)
            self.reloads += len(loaded)
            self.fetches += 1
            self.spill_hits += len(loaded)
            while self._host.over_capacity():
                cold = self._host.evict_cold()
                if cold is None:
                    break
                # Don't thrash: a reload displacing colder entries
                # spills them rather than dropping.
                if self._spill is not None and \
                        cold.digest not in set(d for d in digests):
                    spill_batch.append(cold)
                else:
                    self.dropped += 1
            for d in digests:
                self._pending_fetch.discard(d)
        if spill_batch:
            self._spill_entries(spill_batch)
        for path in drained:
            try:
                os.unlink(path)
            except OSError:
                pass
        # Completion OUTSIDE every KVTiers lock: the callback takes
        # the engine lock (lock order is engine -> tiers, never the
        # reverse).
        on_done(digests, ok)

    # -- serialization helpers ---------------------------------------------

    def _plane(self, name: str, arr: np.ndarray) -> Dict[str, Any]:
        """A checksummed plane record; uint16 words name their dtype
        ``bfloat16`` (no pool holds uint16 itself)."""
        arr = np.ascontiguousarray(arr)
        data = arr.tobytes()
        dtype = 'bfloat16' if arr.dtype == np.uint16 else str(arr.dtype)
        return {'name': name, 'dtype': dtype,
                'shape': list(arr.shape), 'nbytes': len(data),
                'crc32': _crc(data), 'data': data}

    def _decode_entry(self, entry: TierEntry
                      ) -> Optional[Dict[str, np.ndarray]]:
        """Planes -> validated arrays, or None when ANY plane fails
        the crc/shape/dtype gate (the caller quarantines). Validation
        runs BEFORE the bytes can reach a device scatter. A bf16 plane
        decodes to its uint16 storage words."""
        want = dict(self._plane_spec)
        out: Dict[str, np.ndarray] = {}
        for p in entry.planes:
            spec = want.pop(p['name'], None)
            if spec is None:
                return None
            shape, dtype = spec
            if tuple(p['shape']) != shape or p['dtype'] != dtype:
                return None
            data = p['data']
            if len(data) != int(p['nbytes']) or \
                    _crc(data) != int(p['crc32']):
                return None
            out[p['name']] = np.frombuffer(
                data, dtype=_WORDS.get(dtype, np.dtype(dtype))
            ).reshape(shape)
        if want:
            return None  # a required plane is missing
        return out
