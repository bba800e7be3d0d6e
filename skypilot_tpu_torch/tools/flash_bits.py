"""K1-K3's outputs at the training shapes, saved, or compared bit for bit.

    python -m skypilot_tpu_torch.tools.flash_bits --save DIR
    python -m skypilot_tpu_torch.tools.flash_bits --compare DIR

At each of the shapes that ``chip_smoke.py`` phase 3 times (train-s4096,
llama-finetune's D=64, lora-finetune, train-moe, one train-multislice
rank; causal, bf16), makes q, k, v and dO from a fixed seed on the card,
runs K1 (``flash_fwd``), then K2 and K3 (``flash_bwd_dq``,
``flash_bwd_dkv``) on K1's o and lse, and either saves o, lse, dq, dk
and dv under DIR or compares them with the ones saved there, printing
one JSON line a shape: each output's largest absolute difference and
whether its bits are equal.

The package imported is the one on ``sys.path``: to hold two versions of
the kernels to each other, save from one checkout and compare from the
other, for example ``PYTHONPATH=. python <this file> --save DIR`` in the
first. Needs one CUDA card; the outputs take about 2 GB of disk.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import torch

from skypilot_tpu_torch.ops import attention
from skypilot_tpu_torch.utils.device import resolve_device

SHAPES = {  # label: (B, Hq, Hkv, S, D)
    'train-s4096': (2, 16, 8, 4096, 128),
    'llama-finetune D=64': (8, 32, 8, 2048, 64),
    'lora-finetune': (16, 16, 8, 2048, 128),
    'train-moe': (2, 16, 8, 2048, 128),
    'multislice rank': (8, 16, 8, 2048, 128),
}


def outputs(b: int, hq: int, hkv: int, s: int, d: int, seed: int) -> dict:
    gen = torch.Generator(device='cuda').manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen,
                           device='cuda').to(torch.bfloat16)
    q, k, v, do = (rand(b, hq, s, d), rand(b, hkv, s, d), rand(b, hkv, s, d),
                   rand(b, hq, s, d))
    o, lse = attention.flash_fwd(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    dq = attention.flash_bwd_dq(q, k, v, do, lse, delta, True)
    dk, dv = attention.flash_bwd_dkv(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    return {'o': o, 'lse': lse, 'dq': dq, 'dk': dk, 'dv': dv}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    mode = parser.add_mutually_exclusive_group(required=True)
    mode.add_argument('--save', type=pathlib.Path)
    mode.add_argument('--compare', type=pathlib.Path)
    parser.add_argument('--seed', type=int, default=1)
    args = parser.parse_args()
    resolve_device()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    folder = args.save or args.compare
    folder.mkdir(parents=True, exist_ok=True)
    for i, (label, shape) in enumerate(SHAPES.items()):
        got = outputs(*shape, seed=args.seed)
        path = folder / f'shape{i}.pt'
        if args.save:
            torch.save({k: t.cpu() for k, t in got.items()}, path)
            continue
        want = torch.load(path)
        row = {'shape': label}
        for name, t in got.items():
            diff = (t.cpu().float() - want[name].float()).abs().max()
            row[name] = {'same_bits': torch.equal(t.cpu(), want[name]),
                         'max_abs_diff': float(diff)}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
