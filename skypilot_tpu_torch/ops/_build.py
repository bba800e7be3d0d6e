"""Builds the port's CUDA sources into shared libraries at first use.

Every kernel of the port is CUDA C++ under ``csrc/`` with a plain C
interface. ``Library`` compiles one source with ``nvcc`` for ``sm_90a``
into ``csrc/build/`` (gitignored), keyed by a hash of the source, every
``csrc/`` header it includes, and the flags (``source_tag``), so an
unchanged source is compiled once per checkout and a header edit rebuilds,
and loads it with ``ctypes``. ``-Xptxas -v`` makes the compiler report each
kernel's registers, shared memory and spills; ``build()`` returns that
report and ``report()`` reads it back from beside the library. ``sass()``
disassembles the built library with ``cuobjdump``. No library links
against the driver (``-lcuda``): a kernel that needs a driver function,
such as the tensor-map encoder of TMA, reaches it at run time through
``cudaGetDriverEntryPoint``.

Two libraries can build at once (each holds its own lock), so a caller
that needs several starts their builds together.

``SKYTPU_COMPILE_CACHE`` points the builds at a directory that outlives
the checkout (the counterpart of the JAX package's persistent compilation
cache, ``models/engine.maybe_enable_compile_cache``): a replica that boots
where one ran before loads its libraries from there instead of running
``nvcc``. ``compile_cache()`` reports that directory as the replica's
``/health`` ``compile_cache`` block: ``warm`` says whether it held a built
library when this process first looked.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
from typing import Callable, Optional

CSRC = pathlib.Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = CSRC / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') \
        or '/usr/local/cuda'
    path = os.path.join(home, 'bin', 'nvcc')
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the port\'s kernels are built '
                           'from source with the CUDA toolkit')
    return path


_CACHE_STATE: Optional[dict] = None


def compile_cache() -> dict:
    """Where this process builds its libraries, read once per process:
    ``{'enabled': False}`` without ``SKYTPU_COMPILE_CACHE`` (builds go to
    ``csrc/build/``), else ``{'enabled': True, 'dir', 'entries_at_start',
    'warm'}`` with the built libraries the directory held at that first
    look. A directory that cannot be made raises."""
    global _CACHE_STATE
    if _CACHE_STATE is None:
        raw = (os.environ.get('SKYTPU_COMPILE_CACHE') or '').strip()
        if not raw:
            _CACHE_STATE = {'enabled': False}
        else:
            path = pathlib.Path(raw).expanduser().resolve()
            path.mkdir(parents=True, exist_ok=True)
            entries = cache_entries(path)
            _CACHE_STATE = {'enabled': True, 'dir': str(path),
                            'entries_at_start': entries,
                            'warm': entries > 0}
    return _CACHE_STATE


def cache_entries(path: pathlib.Path) -> int:
    """Built libraries in ``path``."""
    return len(list(path.glob('lib*.so')))


def build_dir() -> pathlib.Path:
    state = compile_cache()
    return pathlib.Path(state['dir']) if state['enabled'] else BUILD_DIR


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _local_sources(source: pathlib.Path) -> list:
    """``source`` and every header it includes with quotes, transitively,
    found beside the file that includes it."""
    seen, todo = [], [source]
    while todo:
        path = todo.pop(0)
        if path in seen or not path.exists():
            continue
        seen.append(path)
        todo += [path.parent / m.decode()
                 for m in _INCLUDE.findall(path.read_bytes())]
    return seen


def source_tag(source: pathlib.Path) -> str:
    """Hash of ``source``, the local headers it includes and the flags:
    the key of its built library."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in _local_sources(source):
        h.update(path.name.encode() + b'\0' + path.read_bytes())
    return h.hexdigest()[:16]


class Library:
    """One ``csrc/`` source, compiled and loaded at first use.

    ``configure(lib)`` sets the ``argtypes``/``restype`` of the loaded
    library's functions. Each source exports
    ``skytorch_cuda_error_string(int)`` for ``check``."""

    def __init__(self, source_name: str,
                 configure: Callable[[ctypes.CDLL], None]):
        self.source = CSRC / source_name
        self._configure = configure
        self._lib: Optional[ctypes.CDLL] = None
        self._so: Optional[pathlib.Path] = None
        self._lock = threading.Lock()

    def build(self) -> str:
        """Compile (unless this source and these flags were built already)
        and load. Returns the compiler's output of this call, '' when the
        library was built before."""
        with self._lock:
            if self._lib is not None:
                return ''
            out_dir = build_dir()
            so = out_dir / (f'lib{self.source.stem}-'
                            f'{source_tag(self.source)}.so')
            log = ''
            if not so.exists():
                compiler = nvcc()
                out_dir.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f'{so.name}.{os.getpid()}.tmp')
                cmd = [compiler, *NVCC_FLAGS, '-o', str(tmp),
                       str(self.source)]
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   check=False)
                if r.returncode != 0:
                    raise RuntimeError(f'nvcc {self.source.name} failed '
                                       f'({r.returncode}):\n'
                                       f'{r.stdout}{r.stderr}')
                log = r.stdout + r.stderr
                so.with_suffix('.log').write_text(log)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            lib.skytorch_cuda_error_string.argtypes = [ctypes.c_int]
            lib.skytorch_cuda_error_string.restype = ctypes.c_char_p
            self._configure(lib)
            self._lib, self._so = lib, so
            return log

    def report(self) -> str:
        """The compiler's output of the build this library loaded."""
        self.get()
        log = self._so.with_suffix('.log')
        return log.read_text() if log.exists() else ''

    def sass(self) -> str:
        """``cuobjdump -sass`` of the built library."""
        self.get()
        tool = os.path.join(os.path.dirname(nvcc()), 'cuobjdump')
        return subprocess.run([tool, '-sass', str(self._so)],
                              capture_output=True, text=True,
                              check=True).stdout

    def get(self) -> ctypes.CDLL:
        if self._lib is None:
            self.build()
        return self._lib

    def check(self, rc: int, what: str) -> None:
        """Raise if a launch function returned a CUDA error code."""
        if rc != 0:
            msg = self.get().skytorch_cuda_error_string(rc).decode()
            raise RuntimeError(f'{what} kernel launch failed: {msg} ({rc})')
