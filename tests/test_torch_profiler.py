"""The port's runtime profiler (``observability/profiler.py``) and guarded
CUDA init (``utils/cuda_client_guard.py``) against the JAX package's
``observability/profiler.py`` and ``utils/tpu_client_guard.py``: the
program registry and budgets, the storm rule, the cold-start phase ledger
(monotone, telescoping, undeclared phases refused), ``debug_payload``,
the steady state with profiling off, and the signal guard with its
marker files."""
import dataclasses
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from skypilot_tpu.observability import profiler as jax_profiler
from skypilot_tpu.utils import tpu_client_guard as jax_guard
from skypilot_tpu_torch.models import generate as port_gen
from skypilot_tpu_torch.observability import profiler as port_profiler
from skypilot_tpu_torch.utils import cuda_client_guard as port_guard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_programs_and_phases_are_jaxs():
    assert [dataclasses.asdict(p) for p in port_profiler.PROGRAMS] == \
        [dataclasses.asdict(p) for p in jax_profiler.PROGRAMS]
    assert port_profiler.COLD_START_PHASES == jax_profiler.COLD_START_PHASES
    with pytest.raises(ValueError, match='not declared'):
        port_profiler.profiled('engine.prefill', lambda x: x)


def test_budget_overrides_equal_jax(monkeypatch):
    monkeypatch.setenv('SKYTPU_PROFILE_BUDGETS',
                       'engine.chunk=2, generate.prefill=x,spec.verify=0')
    for p in port_profiler.PROGRAMS:
        assert port_profiler.budget_for(p.name) == \
            jax_profiler.budget_for(p.name), p.name
    assert port_profiler.budget_for('engine.chunk') == 2


def test_storm_at_budget_plus_one_like_jax(monkeypatch):
    """Three distinct shapes through a program whose budget is 2: both
    ledgers count three compiles and one storm."""
    import jax.numpy as jnp
    monkeypatch.setenv('SKYTPU_PROFILE', '1')
    monkeypatch.setenv('SKYTPU_PROFILE_BUDGETS', 'spec.verify=2')
    jax_profiler.reset()
    jfn = jax_profiler.profiled_jit('spec.verify', lambda x: x * 2.0)
    for n in (2, 3, 4, 4):
        jfn(jnp.ones((n,), jnp.float32))
    want = jax_profiler.snapshot()['compile']['spec.verify']
    ledger = port_profiler.Ledger()
    pfn = port_profiler.profiled('spec.verify', lambda x: x * 2.0, ledger)
    for n in (2, 3, 4, 4):
        pfn(torch.ones(n))
    got = ledger.snapshot()
    prog = got['compile']['spec.verify']
    assert (prog['compiles'], prog['storms'], prog['budget']) == \
        (want['compiles'], want['storms'], want['budget']) == (3, 1, 2)
    assert got['storms_total'] == 1 and got['calls']['spec.verify'] == 4
    assert ledger.compile_totals()[0] == 3
    assert ledger.jit_cache_sizes()['spec.verify'] == 3
    jax_profiler.reset()


def test_profiling_off_counts_calls_and_signs_only_while_tracking(
        monkeypatch):
    monkeypatch.setenv('SKYTPU_PROFILE', '0')
    ledger = port_profiler.Ledger()
    fn = port_profiler.profiled('engine.sample', lambda x: x + 1, ledger)
    fn(torch.ones(2))
    assert ledger.jit_cache_sizes() == {'engine.sample': 0}
    with ledger.tracking():
        fn(torch.ones(2))
        fn(torch.ones(5))
        fn(torch.ones(5))
    fn(torch.ones(7))
    assert ledger.jit_cache_sizes() == {'engine.sample': 2}
    assert ledger.compile_totals() == (0, 0.0, 0)  # signatures only
    assert ledger.snapshot() == {'enabled': False}
    monkeypatch.setenv('SKYTPU_PROFILE', '1')
    assert ledger.snapshot()['calls'] == {'engine.sample': 5}
    assert port_profiler.try_snapshot() is not None
    monkeypatch.setenv('SKYTPU_PROFILE', '0')
    assert port_profiler.try_snapshot() is None


def test_cold_start_ledger_is_monotone_and_telescopes():
    birth = time.monotonic() - 0.05
    ledger = port_profiler.Ledger(birth_mono=birth)
    for phase in port_profiler.COLD_START_PHASES:
        ledger.mark(phase)
        time.sleep(0.01)
    ledger.mark('imports')  # a later mark of a crossed phase is ignored
    cs = ledger.cold_start_ledger()
    assert list(cs['phases']) == list(port_profiler.COLD_START_PHASES)
    assert all(d >= 0 for d in cs['phases'].values())
    assert cs['phases']['imports'] >= 0.04  # from the birth
    assert sum(cs['phases'].values()) == pytest.approx(cs['total_s'],
                                                       abs=1e-3)
    assert cs['complete'] is True
    for lib in (port_profiler, jax_profiler):
        with pytest.raises(ValueError, match='unknown cold-start phase'):
            lib.mark('warmup')
    partial = port_profiler.Ledger(birth_mono=birth)
    partial.mark('weights_load')
    assert partial.cold_start_ledger()['complete'] is False
    assert set(cs) == set(jax_profiler.cold_start_ledger())


def test_process_birth_precedes_the_import():
    """The birth comes from /proc, before the interpreter's imports."""
    code = ('import time; t = time.monotonic(); import torch; '
            'from skypilot_tpu_torch.observability import profiler as p; '
            'print(t - p.BIRTH_MONO)')
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       check=True)
    assert 0.0 < float(r.stdout.split()[-1]) < 60.0


def test_snapshot_and_debug_payload_have_jaxs_keys(monkeypatch):
    monkeypatch.setenv('SKYTPU_PROFILE', '1')
    ledger = port_profiler.LEDGER
    port_profiler.register_logical('weights', 1024)
    snap = ledger.snapshot()
    want = jax_profiler.snapshot()
    assert set(snap) == set(want) | {'calls'}
    assert set(snap['compile']) <= port_profiler.PROGRAM_NAMES
    assert port_gen.jit_prefill.program_name in snap['compile']
    body = port_profiler.debug_payload({'programs': '1', 'mem': '1'}, 'cpu')
    jbody = jax_profiler.debug_payload({'programs': '1'})
    assert body['programs'] == jbody['programs']
    assert body['device_memory']['logical']['weights'] == 1024
    assert 'bytes_in_use' not in body['device_memory']  # CPU: logical only


def test_memory_sample_is_rate_limited(monkeypatch):
    monkeypatch.setenv('SKYTPU_PROFILE', '1')
    monkeypatch.setenv('SKYTPU_PROFILE_MEM_S', '60')
    ledger = port_profiler.Ledger()
    first = ledger.maybe_sample_device_memory('cpu')
    ledger.register_logical('kv_cache', 5)
    assert ledger.maybe_sample_device_memory('cpu') is first
    monkeypatch.setenv('SKYTPU_PROFILE_MEM_S', '0.25')
    time.sleep(0.3)
    assert ledger.maybe_sample_device_memory('cpu')['logical_bytes'] == 5
    assert port_profiler.mem_sample_interval_s() == \
        jax_profiler.mem_sample_interval_s()


# -- the guarded CUDA init ---------------------------------------------------

_DEFER = r'''
import os, signal, sys
from skypilot_tpu_torch.utils.cuda_client_guard import deferred_signals
with deferred_signals() as pending:
    os.kill(os.getpid(), signal.SIGTERM)
    for _ in range(1000):
        pass
    print('survived-inside-guard', len(pending), flush=True)
print('UNREACHABLE-after-guard', flush=True)
'''


def test_signal_deferred_and_redelivered():
    r = subprocess.run([sys.executable, '-c', _DEFER], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert 'survived-inside-guard 1' in r.stdout
    assert 'UNREACHABLE' not in r.stdout
    assert r.returncode == -signal.SIGTERM


def test_no_pending_signal_is_a_noop():
    prior = signal.getsignal(signal.SIGTERM)
    with port_guard.deferred_signals() as pending:
        assert pending == []
        assert signal.getsignal(signal.SIGTERM) is not prior
    assert signal.getsignal(signal.SIGTERM) is prior


def test_marker_visible_to_both_packages_and_cleaned():
    """A port process inside the guard is listed by the port's and the
    JAX package's ``guarded_init_pids`` (one marker name), and its marker
    goes once the process is gone."""
    code = ('import time\n'
            'from skypilot_tpu_torch.utils.cuda_client_guard import '
            'deferred_signals\n'
            'with deferred_signals():\n'
            '    print("in-guard", flush=True)\n'
            '    time.sleep(60)\n')
    child = subprocess.Popen([sys.executable, '-c', code], cwd=REPO,
                             stdout=subprocess.PIPE, text=True)
    try:
        assert child.stdout.readline().strip() == 'in-guard'
        assert child.pid in port_guard.guarded_init_pids()
        assert child.pid in jax_guard.guarded_init_pids()
    finally:
        child.kill()
        child.wait()
    deadline = time.time() + 10
    while child.pid in port_guard.guarded_init_pids():
        assert time.time() < deadline
        time.sleep(0.2)


def test_init_backend_guarded_cpu_and_refusal(monkeypatch):
    port_profiler.reset()
    assert port_guard.init_backend_guarded('cpu') == [torch.device('cpu')]
    phases = port_profiler.cold_start_ledger()['phases']
    assert list(phases) == ['backend_init.plugin_discovery',
                            'backend_init.device_enumeration']
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        port_guard.init_backend_guarded()
    with pytest.raises(ValueError, match='Unknown platform'):
        port_guard.init_backend_guarded('tpu')
    port_profiler.reset()


def test_init_backend_guarded_cuda_order(monkeypatch):
    """The CUDA path's order, with the driver calls recorded: loaded
    (plugin discovery), counted, the first context made (enumeration),
    all while SIGTERM is deferred."""
    calls = []
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'init', lambda: calls.append('init'))
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)

    def sync(dev):
        calls.append(('sync', str(dev),
                      signal.getsignal(signal.SIGTERM) is not prior))
    monkeypatch.setattr(torch.cuda, 'synchronize', sync)
    prior = signal.getsignal(signal.SIGTERM)
    port_profiler.reset()
    devices = port_guard.init_backend_guarded()
    assert devices == [torch.device('cuda', 0), torch.device('cuda', 1)]
    assert calls == ['init', ('sync', 'cuda:0', True)]
    assert list(port_profiler.cold_start_ledger()['phases']) == [
        'backend_init.plugin_discovery', 'backend_init.device_enumeration']
    port_profiler.reset()
