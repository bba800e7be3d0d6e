"""Defer SIGTERM/SIGINT while this process creates its CUDA context.

Port of ``skypilot_tpu/utils/tpu_client_guard.py``:

* ``deferred_signals()`` records SIGTERM and SIGINT instead of dying, and
  delivers them again once the block ends. CPython runs a Python handler
  only between bytecodes, so a signal that arrives while the driver is
  inside a C call takes effect after the call returns: a drain or a
  Ctrl-C never lands in the middle of context creation.
* The marker files (``skytpu-guarded-init-<pid>`` in the temporary
  directory, holding the pid's kernel start time) make a guarded init
  visible to other processes; ``guarded_init_pids()`` lists the live
  holders and removes stale markers. The name is the JAX package's, so a
  reaper of either package spares a process of the other mid-init.
* ``init_backend_guarded()`` loads the CUDA driver and runtime, counts the
  devices and creates the context of the first one under that guard,
  marking the cold-start ledger's ``backend_init.*`` sub-phases
  (``observability/profiler.py``). It returns the devices.

These three are copies of the framework-free originals; only
``init_backend_guarded`` differs. Where the JAX function swallows a
failure of its backend probe, this one raises: with no CUDA device, and
no ``platform='cpu'``, it fails, so no replica starts on the CPU by
accident.
"""
from __future__ import annotations

import contextlib
import os
import signal
import tempfile
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence

import torch

from skypilot_tpu_torch.observability import profiler

GUARD_SIGNALS = (signal.SIGTERM, signal.SIGINT)

_MARKER_PREFIX = 'skytpu-guarded-init-'


def _marker_path(pid: Optional[int] = None) -> str:
    return os.path.join(tempfile.gettempdir(),
                        f'{_MARKER_PREFIX}{pid or os.getpid()}')


def _starttime(pid: int) -> Optional[str]:
    """Kernel start-time ticks of ``pid``: a marker names its holder by
    (pid, start time), so a recycled pid never inherits a leaked
    marker."""
    try:
        with open(f'/proc/{pid}/stat', encoding='utf-8') as f:
            return f.read().rsplit(')', 1)[1].split()[19]
    except (OSError, IndexError):
        return None


def guarded_init_pids() -> Dict[int, float]:
    """Live pids inside a guarded backend init, mapped to the age of
    their marker in seconds. Markers of dead or recycled pids are removed
    on the way."""
    out: Dict[int, float] = {}
    now = time.time()
    try:
        names = os.listdir(tempfile.gettempdir())
    except OSError:
        return out
    for name in names:
        if not name.startswith(_MARKER_PREFIX):
            continue
        try:
            pid = int(name[len(_MARKER_PREFIX):])
        except ValueError:
            continue
        path = os.path.join(tempfile.gettempdir(), name)
        try:
            with open(path, encoding='utf-8') as f:
                recorded_start = f.read().strip()
        except OSError:
            continue
        if recorded_start and recorded_start == _starttime(pid):
            try:
                out[pid] = max(0.0, now - os.stat(path).st_mtime)
            except OSError:
                pass
        else:  # dead, recycled, or unreadable: stale
            try:
                os.unlink(path)
            except OSError:
                pass
    return out


@contextlib.contextmanager
def deferred_signals(
        signals: Sequence[signal.Signals] = GUARD_SIGNALS,
) -> Iterator[List[int]]:
    """Record and defer ``signals`` for the duration of the block.

    Yields the live list of deferred signal numbers. On exit the old
    handlers come back and each deferred signal is sent to this process
    again, in arrival order: a deferred SIGTERM still terminates. Off the
    main thread this is a no-op (only the main thread may install
    handlers, and only it receives signals)."""
    pending: List[int] = []
    if threading.current_thread() is not threading.main_thread():
        yield pending
        return
    old = {}
    for sig in signals:
        try:
            old[sig] = signal.signal(
                sig, lambda signum, frame: pending.append(signum))
        except (ValueError, OSError):  # not supported on this platform
            pass
    marker = _marker_path()
    try:
        with open(marker, 'w', encoding='utf-8') as f:
            f.write(_starttime(os.getpid()) or '')
    except OSError:
        marker = None
    try:
        yield pending
    finally:
        if marker:
            try:
                os.unlink(marker)
            except OSError:
                pass
        for sig, handler in old.items():
            try:
                signal.signal(sig, handler)
            except (ValueError, OSError):
                pass
        for signum in pending:
            os.kill(os.getpid(), signum)


def init_backend_guarded(platform: Optional[str] = None) -> list:
    """The devices this process serves from, with the CUDA context of the
    first one created while shutdown signals are deferred. ``platform``
    None or 'cuda' = CUDA, which must be there (RuntimeError otherwise);
    'cpu' = the CPU, which the tests ask for by name. Idempotent: a
    second call finds the context made.

    Marks ``backend_init.plugin_discovery`` once the driver and the
    runtime are loaded and ``backend_init.device_enumeration`` once the
    devices are counted and the context exists."""
    if platform not in (None, 'cuda', 'cpu'):
        raise ValueError(f"Unknown platform {platform!r}; 'cuda' or 'cpu'")
    with deferred_signals():
        if platform == 'cpu':
            profiler.mark('backend_init.plugin_discovery')
            profiler.mark('backend_init.device_enumeration')
            return [torch.device('cpu')]
        if not torch.cuda.is_available():
            raise RuntimeError('CUDA is not available: the replica runs on '
                               "an NVIDIA GPU unless the caller asks for "
                               "platform='cpu'")
        torch.cuda.init()
        profiler.mark('backend_init.plugin_discovery')
        devices = [torch.device('cuda', i)
                   for i in range(torch.cuda.device_count())]
        torch.cuda.synchronize(devices[0])  # creates the primary context
        profiler.mark('backend_init.device_enumeration')
        return devices
