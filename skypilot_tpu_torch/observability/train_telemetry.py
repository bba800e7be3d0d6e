"""Trainer step telemetry: a bounded JSONL spool per training process.

The writer side of ``skypilot_tpu/observability/train_telemetry.py``,
copied: the same records in the same spool file, so the gang driver (which
exports the spool dir) and the goodput accounting (which reads it) treat a
port trainer like a JAX one. ``read_records`` is kept for tests and
``chip_smoke.py``; the cluster-level summaries stay in the original.

The write side rides the trainer's existing ``--log-every`` metrics fetch
(``train/run.py``): one record per log window — step time, tokens/s,
achieved MFU, loss — appended to a spool file under the job's runtime
dir. Pure file append, no device sync of its own; when the spool dir env
var is unset the writer is ``None``. The checkpoint manager appends one
record per save and restore. Stdlib only.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

# Spool location contract: the gang driver exports this per worker
# (pointing under the job's log dir); recipes may override it. Unset =>
# telemetry fully disabled.
ENV_DIR = 'SKYTPU_TRAIN_TELEMETRY_DIR'
SPOOL_FILE = 'train_telemetry.jsonl'
# Spool bound: one rotation generation is kept (``.1``), so disk usage is
# capped at ~2x this size per training process.
ENV_MAX_KB = 'SKYTPU_TRAIN_TELEMETRY_MAX_KB'
DEFAULT_MAX_KB = 512


def _max_bytes() -> int:
    try:
        return int(float(os.environ.get(ENV_MAX_KB,
                                        str(DEFAULT_MAX_KB))) * 1024)
    except ValueError:
        return DEFAULT_MAX_KB * 1024


def peak_flops_per_s() -> float:
    """Accelerator peak (FLOP/s) for MFU accounting. There is no portable
    in-band way to ask a device for its peak, so it travels as an env var
    (recipes/launch templates set it per accelerator type); 0 = unknown,
    MFU omitted."""
    try:
        return float(os.environ.get('SKYTPU_PEAK_FLOPS', '0'))
    except ValueError:
        return 0.0


def window_record(*, step: int, steps: int, window_s: float,
                  tokens_per_step: float, model_flops_per_step: float,
                  loss: Optional[float] = None,
                  ts: Optional[float] = None) -> Dict[str, Any]:
    """One log-window record from plain numbers (the trainer computes
    tokens/flops per step via its own helpers so this module never
    imports the model stack)."""
    import time
    window_s = max(window_s, 1e-9)
    rec: Dict[str, Any] = {
        'ts': round(ts if ts is not None else time.time(), 3),
        'step': int(step),
        'steps_in_window': int(steps),
        'window_s': round(window_s, 6),
        'step_time_s': round(window_s / max(steps, 1), 6),
        'tokens_per_s': round(tokens_per_step * steps / window_s, 3),
        'model_flops_per_s': round(
            model_flops_per_step * steps / window_s, 3),
    }
    if loss is not None:
        rec['loss'] = round(float(loss), 6)
    peak = peak_flops_per_s()
    if peak > 0:
        rec['mfu'] = round(rec['model_flops_per_s'] / peak, 6)
    return rec


def ckpt_record(*, op: str, step: int, seconds: float,
                stall_s: Optional[float] = None,
                nbytes: Optional[int] = None,
                source: Optional[str] = None,
                async_save: Optional[bool] = None,
                emergency: bool = False,
                ts: Optional[float] = None) -> Dict[str, Any]:
    """One checkpoint event (``op`` = 'save' | 'restore') from the ckpt
    manager. Rides the same spool as the window records; the ``kind``
    field keeps the two record families separable (window records have
    none — the PR-4 on-disk format predates it)."""
    import time
    rec: Dict[str, Any] = {
        'kind': 'ckpt',
        'op': op,
        'ts': round(ts if ts is not None else time.time(), 3),
        'step': int(step),
        'seconds': round(float(seconds), 6),
    }
    if stall_s is not None:
        rec['stall_s'] = round(float(stall_s), 6)
    if nbytes is not None:
        rec['nbytes'] = int(nbytes)
    if source is not None:
        rec['source'] = source
    if async_save is not None:
        rec['async'] = bool(async_save)
    if emergency:
        rec['emergency'] = True
    return rec


class TelemetryWriter:
    """Append-only JSONL spool, bounded by one-generation rotation.

    Every failure path disables the writer instead of raising: telemetry
    must never take a training step down with it."""

    def __init__(self, spool_dir: str,
                 max_bytes: Optional[int] = None):
        import threading
        self._path = os.path.join(os.path.expanduser(spool_dir), SPOOL_FILE)
        self._max_bytes = max_bytes if max_bytes is not None else _max_bytes()
        self._broken = False
        # One writer instance is shared across threads (train loop,
        # ckpt commit worker, SIGTERM handler): the check-then-rotate
        # in emit() must not race itself, or a stale size check can
        # os.replace a fresh spool over the rotated generation. Reentrant:
        # the SIGTERM handler runs on the thread it interrupted, which
        # may be inside emit() (the original's Lock would deadlock there).
        self._emit_lock = threading.RLock()
        try:
            os.makedirs(os.path.dirname(self._path), exist_ok=True)
            self._heal_torn_tail()
        except OSError:
            self._broken = True

    def _heal_torn_tail(self) -> None:
        """A process that crashed mid-append leaves an unterminated line;
        terminate it so this writer's first record does not fuse onto the
        torn one (the reader drops the torn line either way)."""
        try:
            with open(self._path, 'rb+') as f:
                f.seek(0, os.SEEK_END)
                if f.tell() == 0:
                    return
                f.seek(-1, os.SEEK_END)
                if f.read(1) != b'\n':
                    f.write(b'\n')
        except OSError:
            pass  # no spool yet

    @classmethod
    def from_env(cls) -> Optional['TelemetryWriter']:
        spool_dir = os.environ.get(ENV_DIR)
        if not spool_dir:
            return None
        return cls(spool_dir)

    def emit(self, record: Dict[str, Any]) -> None:
        if self._broken:
            return
        try:
            line = json.dumps(record, sort_keys=True)
            with self._emit_lock:
                try:
                    if os.path.getsize(self._path) + len(line) > \
                            self._max_bytes:
                        os.replace(self._path, self._path + '.1')
                except OSError:
                    pass  # no spool yet: nothing to rotate
                with open(self._path, 'a', encoding='utf-8') as f:
                    f.write(line + '\n')
        except (OSError, TypeError, ValueError):
            self._broken = True


def read_records(spool_dir: str) -> List[Dict[str, Any]]:
    """All records in a spool, oldest first (rotated generation included);
    malformed lines (torn writes) are skipped."""
    out: List[Dict[str, Any]] = []
    base = os.path.join(os.path.expanduser(spool_dir), SPOOL_FILE)
    for path in (base + '.1', base):
        try:
            with open(path, encoding='utf-8') as f:
                lines = f.readlines()
        except OSError:
            continue
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
    return out
