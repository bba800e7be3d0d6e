"""A pipe rank's peak memory and what moves over ``pipe`` a step, for
checkouts given in turn.

    python -m skypilot_tpu_torch.tools.stage_peak TREE [TREE ...]

For each TREE (the root of a checkout: ``.`` for this one), in the order
given, runs that checkout's ``python -m skypilot_tpu_torch.train.run``
on ``--mesh pipe=2,fsdp=1`` (two ranks: one card over gloo, or a card a
rank where the machine gives NCCL) on ``--model`` (bench-1b) at full
width, cut to ``--layers`` (6) layers in ``--stages`` (3) pipeline
stages of 4 microbatches by a ``sitecustomize``, global batch 8, seq
2048, 2 steps, warmup 1: ``chip_smoke.py`` 19e's uneven gang. Prints one
JSON line a run: each rank's ``peak_bytes`` (its process's
``torch.cuda.max_memory_allocated``), step ms, and collectives a step by
kind (calls, bytes this rank sent). To hold two versions to each other,
unpack the parent into a directory git ignores and give it and this
checkout alternately (``PARENT . . PARENT``). On the CPU, ``--model
tiny --seq-len 64 --device cpu`` rehearses it.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

RUN_S = 600


def run(tree: str, args) -> dict:
    """One ``train.run`` of ``tree``'s package: its ranks' figures."""
    tree = os.path.abspath(tree)
    with tempfile.TemporaryDirectory(prefix='stage-peak-') as cut:
        with open(os.path.join(cut, 'sitecustomize.py'), 'w') as f:
            f.write('import dataclasses\n'
                    'from skypilot_tpu_torch.models import llama\n'
                    f'llama.PRESETS[{args.model!r}] = dataclasses.replace('
                    f'llama.PRESETS[{args.model!r}], n_layers={args.layers}, '
                    f'pipeline_stages={args.stages}, '
                    'pipeline_microbatches=4)\n')
        argv = ['--model', args.model, '--global-batch-size', '8',
                '--seq-len', str(args.seq_len), '--mesh', 'pipe=2,fsdp=1',
                '--steps', str(args.steps), '--warmup-steps', '1',
                '--log-every', '1'] + (
            ['--device', args.device] if args.device else [])
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([cut, tree]))
        proc = subprocess.run(
            [sys.executable, '-m', 'skypilot_tpu_torch.train.run'] + argv,
            cwd=tree, env=env, capture_output=True, text=True,
            timeout=RUN_S)
    if proc.returncode:
        raise RuntimeError(f'{tree}: train.run exited {proc.returncode}:\n'
                           f'{proc.stdout[-3000:]}{proc.stderr[-3000:]}')
    ranks = sorted((json.loads(m) for m in re.findall(
        r'^\[train\] rank-summary (\{.*\})$', proc.stdout, re.MULTILINE)),
        key=lambda s: s['rank'])
    steps = args.steps
    return {'tree': tree, 'layers': args.layers, 'stages': args.stages,
            'ranks': [{
                'rank': s['rank'], 'backend': s['backend'],
                'device': s['device'], 'peak_bytes': s['peak_bytes'],
                'step_ms': s['window_step_ms'],
                'per_step': {k: {'calls': v['calls'] / steps,
                                 'bytes': v['bytes'] / steps}
                             for k, v in sorted(
                                 s['collectives']['by_kind'].items())}}
                for s in ranks]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('trees', nargs='+')
    parser.add_argument('--model', default='bench-1b')
    parser.add_argument('--layers', type=int, default=6)
    parser.add_argument('--stages', type=int, default=3)
    parser.add_argument('--seq-len', type=int, default=2048)
    parser.add_argument('--steps', type=int, default=2)
    parser.add_argument('--device', default=None)
    args = parser.parse_args(argv)
    if args.device != 'cpu':
        print(subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip(), flush=True)
    for tree in args.trees:
        print(json.dumps(run(tree, args)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
