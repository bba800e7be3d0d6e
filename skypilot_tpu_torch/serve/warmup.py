"""Warm-up before traffic: the replica's dark window pays the first calls.

Port of ``skypilot_tpu/serve/warmup.py``. A replica that reports READY
before any request ran pays its first calls on its first users: on the
card that is the build or load of the kernel library, cuBLAS's choice of
algorithm for each new GEMM shape and the caching allocator's growth
(the JAX replica pays XLA compiles there). The replica's ``main()`` runs
``run`` after the weights load and before the listener binds, so no
probe sees a 200 before it ends. It drives the steady-state shape set
through every program the configuration uses, then replays the same mix
until a whole round adds no shape signature to the profiler's ledger
(``observability/profiler.py``): that replay is the coverage the READY
gate asks for. The ledger looks at signatures during the warm-up even
with ``SKYTPU_PROFILE`` off (``profiler.tracking()``).

Shapes are the engine's power-of-two prompt buckets up to ``max_len``,
capped by the smallest declared budget among the wrapped programs, so the
warm-up cannot itself storm. ``_cache_canary`` makes a round trip of the
kernel-build cache (``ops/_build.py``, ``SKYTPU_COMPILE_CACHE``): it builds
or loads the flash-decode library there, so a directory that cannot be
written shows up inside the dark window.
"""
from __future__ import annotations

import os
import pathlib
import time
from typing import Any, Dict, List, Optional

from skypilot_tpu_torch.models import generate as gen_lib
from skypilot_tpu_torch.observability import profiler
from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import decode_attention

_PROMPT_LO = 16  # engine.prompt_bucket's floor
_WARMUP_MAX_NEW = 4  # enough decode to run a chunk


def skipped(reason: str) -> Dict[str, Any]:
    """The report of a boot that did not warm up, with the reason
    ``/health`` shows for the missing ``jit_warmup`` crossing."""
    return {'ran': False, 'covered': False, 'warmup_skipped': reason}


def enabled() -> bool:
    return os.environ.get('SKYTPU_WARMUP', '0') == '1'


def _int_env(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)) or str(default))
    except ValueError:
        return default


def prompt_buckets(max_len: int) -> List[int]:
    """Every power-of-two prompt bucket that still fits a decode tail
    inside ``max_len``, smallest first, capped by SKYTPU_WARMUP_BUCKETS
    and by the smallest declared budget among the wrapped programs."""
    buckets = []
    b = _PROMPT_LO
    while b + _WARMUP_MAX_NEW <= max_len:
        buckets.append(b)
        b *= 2
    sizes = profiler.jit_cache_sizes()
    if sizes:
        budget_cap = min(profiler.budget_for(n) for n in sizes)
        buckets = buckets[:max(budget_cap, 1)]
    cap = _int_env('SKYTPU_WARMUP_BUCKETS', 0)
    if cap > 0:
        buckets = buckets[:cap]
    return buckets or [_PROMPT_LO]


def _compile_marker() -> tuple:
    """(ledger compiles, distinct signatures): unchanged across a replay
    round means the round met no new shape."""
    compiles, _ms, _storms = profiler.compile_totals()
    return compiles, sum(profiler.jit_cache_sizes().values())


def _cache_canary(server) -> Optional[Dict[str, int]]:
    """Round trip of the kernel-build cache: build (or load) the
    flash-decode library in it. {'entries_before', 'entries_after'};
    None with the cache off, or on the CPU, where no kernel runs."""
    state = _build.compile_cache()
    if not state.get('enabled') or server.device.type != 'cuda':
        return None
    path = pathlib.Path(state['dir'])
    before = _build.cache_entries(path)
    decode_attention.build_library()
    return {'entries_before': before,
            'entries_after': _build.cache_entries(path)}


def _row(bucket: int, rnd: int, idx: int) -> List[int]:
    """A prompt of exactly ``bucket`` ids that shares no prefix with any
    other bucket's or round's row (the first id differs), so that no row
    hits the prefix pool or the block trie and skips the full-size
    prefill."""
    return [((7 * i + 13 * rnd + 29 * (idx + 1)) % 240) + 1
            for i in range(bucket)]


def _drive_engine(server, buckets: List[int], rnd: int) -> None:
    """One round through the continuous engine, three arrival patterns
    per bucket: solo (a group-of-one prefill at the bucket's shape), a
    concurrent duplicate pair (the grouped prefill, and the full-match
    path of the pool or the trie), and a prefix of the solo row (a
    partial hit: fork plus remainder prefill)."""
    for idx, bucket in enumerate(buckets):
        solo = _row(bucket, rnd, idx)
        server.engine.submit(
            solo, _WARMUP_MAX_NEW, 0.0).result(timeout=600)
        pair_row = _row(bucket, rnd, idx + len(buckets))
        pair = [server.engine.submit(pair_row, _WARMUP_MAX_NEW, 0.0)
                for _ in range(2)]
        for f in pair:
            f.result(timeout=600)
        if bucket > 4:
            server.engine.submit(solo[:bucket - 3], _WARMUP_MAX_NEW,
                                 0.0).result(timeout=600)


def _drive_window(server, buckets: List[int], rnd: int) -> None:
    """The window path (engine off): a greedy ``generate`` at each
    bucketed prompt length."""
    for idx, bucket in enumerate(buckets):
        padded, lens = gen_lib.pad_prompts([_row(bucket, rnd, idx)],
                                           device=server.device)
        gen_lib.generate(server.params, server.cfg, padded,
                         _WARMUP_MAX_NEW, temperature=0.0,
                         max_len=server.max_len, prompt_lengths=lens,
                         kv_quantize=server.kv_cache == 'int8').tolist()


def run(server) -> Dict[str, Any]:
    """Warm the replica and confirm coverage. Returns the report that
    ``/health`` shows as ``warmup``; an error is reported in its body,
    as the JAX replica does (the replica's ``main()`` then fails the
    boot)."""
    t0 = time.monotonic()
    buckets = prompt_buckets(server.max_len)
    rounds_max = max(_int_env('SKYTPU_WARMUP_ROUNDS', 4), 1)
    report: Dict[str, Any] = {'ran': True, 'buckets': buckets,
                              'rounds': 0, 'covered': False}
    error: Optional[str] = None
    with profiler.tracking():
        start = _compile_marker()
        try:
            canary = _cache_canary(server)
            if canary is not None:
                report['cache_canary'] = canary
            for rnd in range(rounds_max):
                before = _compile_marker()
                if server.engine is not None:
                    _drive_engine(server, buckets, rnd)
                else:
                    _drive_window(server, buckets, rnd)
                report['rounds'] += 1
                if report['rounds'] > 1 and _compile_marker() == before:
                    report['covered'] = True
                    break
        except Exception as e:  # noqa: BLE001 -- reported in the body
            error = f'{type(e).__name__}: {e}'
        end = _compile_marker()
    report['compiles'] = max(end[0] - start[0], 0)
    report['cache_entries'] = max(end[1] - start[1], 0)
    report['wall_s'] = round(time.monotonic() - t0, 3)
    if error:
        report['error'] = error[:200]
    profiler.mark('jit_warmup')
    return report
