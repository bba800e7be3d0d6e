"""Atomic file publication: tmp-write, optional fsync, rename.

Copy of ``atomic_write`` of ``skypilot_tpu/utils/atomic_io.py``, held to
the original by ``tests/test_torch_kv_tiers.py``. The KV tiers' spill
segments (``serve/kv_tiers.py``) are published through it, so a reader
or a crash never sees a torn segment.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Optional


def atomic_write(path: str, writer: Callable[[Any], Any], *,
                 mode: str = 'w', encoding: Optional[str] = 'utf-8',
                 fsync: bool = False, tmp: Optional[str] = None):
    """Write ``path`` atomically: ``writer(f)`` fills the tmp file,
    then it is fsync'd (opt-in) and renamed over ``path``. On any
    failure the tmp is unlinked and the exception propagates. Returns
    ``writer``'s return value."""
    if tmp is None:
        tmp = path + '.tmp'
    if 'b' in mode:
        encoding = None
    try:
        with open(tmp, mode, encoding=encoding) as f:
            result = writer(f)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        return result
    except BaseException:
        # Never strand the half-written tmp.
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
