"""The port stands alone: importing every module of ``skypilot_tpu_torch``
(``ckpt/`` and ``observability/`` included) loads neither JAX nor anything
of ``skypilot_tpu``, nor ``ml_dtypes`` or ``orbax``, which come with JAX
and which a CUDA host of the port need not have, nor
``prometheus_client`` (the port writes its scrape by hand); no source of it (nor
``chip_smoke.py``) imports any of them, and its entry points refuse to
run without CUDA unless asked for the CPU by name."""
import ast
import json
import pathlib
import subprocess
import sys

import pytest
import torch

import skypilot_tpu_torch
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.serve import llm_server
from skypilot_tpu_torch.train import run as train_run
from skypilot_tpu_torch.train import trainer as trainer_lib
from skypilot_tpu_torch.utils import cuda_doctor
from skypilot_tpu_torch.utils import device as device_lib

PKG = pathlib.Path(skypilot_tpu_torch.__file__).resolve().parent
REPO = PKG.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'skypilot_tpu', 'ml_dtypes',
             'orbax', 'prometheus_client')

_IMPORT_ALL = r'''
import importlib, importlib.abc, pkgutil, sys

FORBIDDEN = %r

def forbidden(name):
    return any(name == f or name.startswith(f + '.') for f in FORBIDDEN)

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if forbidden(name):
            raise ImportError('blocked import of ' + name)
        return None

for name in [m for m in sys.modules if forbidden(m)]:
    del sys.modules[name]
sys.meta_path.insert(0, Block())
import skypilot_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    skypilot_tpu_torch.__path__, 'skypilot_tpu_torch.')]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if forbidden(m))
assert not leaked, leaked
print(len(names), 'modules')
print(' '.join(names))
''' % (FORBIDDEN,)


def test_importing_every_module_loads_no_jax_and_no_skypilot_tpu():
    r = subprocess.run([sys.executable, '-c', _IMPORT_ALL], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       check=False)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[0]) >= 10  # every module was imported
    walked = set(r.stdout.splitlines()[1].split())
    for sub in ('ckpt.manifest', 'ckpt.committer', 'ckpt.mirror',
                'ckpt.snapshot', 'ckpt.manager', 'train.checkpoint',
                'observability.train_telemetry', 'models.paged',
                'serve.kv_tiers', 'utils.prefix_affinity',
                'utils.atomic_io', 'models.lora', 'models.speculative',
                'parallel.mesh', 'parallel.sharding',
                'parallel.collectives', 'serve.spmd', 'serve.qos',
                'serve.metrics',
                'serve.warmup', 'utils.cuda_client_guard', 'utils.users',
                'observability.profiler', 'observability.trace',
                'observability.blackbox', 'observability.slo',
                'utils.cuda_doctor'):
        assert 'skypilot_tpu_torch.' + sub in walked, sub


@pytest.mark.parametrize('path', sorted(
    str(p.relative_to(PKG)) for p in PKG.rglob('*.py')) + [
        '../chip_smoke.py'])  # the port's smoke test drives it on the card
def test_no_source_file_imports_jax_or_skypilot_tpu(path):
    tree = ast.parse((PKG / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or '']
        else:
            continue
        for name in names:
            assert name.split('.')[0] not in FORBIDDEN, (path, name)


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch, tmp_path,
                                                     capsys):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        device_lib.resolve_device()
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        llm_server.LlmServer('tiny')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        llm_server.LlmServer('tiny', kv_layout='paged')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        llama.init_params(llama.TINY, torch.Generator())
    cfg = trainer_lib.TrainerConfig(model=llama.TINY, seq_len=16)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        trainer_lib.Trainer(cfg)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        train_run.main(['--model', 'tiny', '--steps', '1'])
    ckpt = str(tmp_path / 'ck')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        train_run.main(['--model', 'tiny', '--steps', '1', '--ckpt-dir',
                        ckpt])
    out = train_run.main(['--model', 'tiny', '--steps', '1', '--seq-len',
                          '16', '--ckpt-dir', ckpt, '--device', 'cpu'])
    assert out['state']['step'] == 1
    assert trainer_lib.Trainer(cfg, device='cpu').device.type == 'cpu'
    assert device_lib.resolve_device('cpu') == torch.device('cpu')
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    # The doctor probes CUDA unless asked for the CPU: with no visible GPU
    # it exits 1 naming the missing device; asked for the CPU, it passes.
    monkeypatch.setenv('CUDA_VISIBLE_DEVICES', '')
    capsys.readouterr()
    assert cuda_doctor.main(['--timeout', '120']) == 1
    report = json.loads(capsys.readouterr().out)
    assert report['probe']['outcome'] == 'no_device'
    assert 'no CUDA device' in report['probe']['diagnosis']
    assert cuda_doctor.main(['--timeout', '120', '--device', 'cpu']) == 0
    assert json.loads(capsys.readouterr().out)['probe']['ok']
