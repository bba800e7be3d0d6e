"""Training entry point: ``python -m skypilot_tpu_torch.train.run``.

Port of ``skypilot_tpu/train/run.py`` for one device, e.g. BENCH_1B at
seq 4096 on one H100:

    python -m skypilot_tpu_torch.train.run --model bench-1b --seq-len 4096 \\
        --global-batch-size 2 --steps 20 --log-every 5

It takes the original's model, batch, optimizer, data and remat flags,
plus ``--warmup-steps`` and ``--device`` (CUDA unless ``cpu``).
Checkpointing (``--ckpt-*``), meshes (``--mesh``, ``--num-slices``) and
LoRA (``--lora-rank``) are not ported yet: they exit with code 2. Every
``--log-every`` steps it prints ``[train] step i/N loss=...`` as the
original does, with the window's step ms, tokens/s, and model FLOP/s as a
share of the card's dense bf16 peak (989 TFLOP/s, an H100 SXM at 700 W)
beside the card's name. ``main`` returns the per-step losses and the final
state, so a script can drive it in-process.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import torch

from skypilot_tpu_torch.utils.device import H100_BF16_DENSE_FLOPS

_NOT_PORTED = ('ckpt_dir', 'ckpt_local_dir', 'ckpt_sync', 'mesh',
               'num_slices', 'lora_rank')


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='Train a Llama preset on one device (PyTorch port).')
    parser.add_argument('--model', default='tiny',
                        help='preset name (models/llama.py PRESETS)')
    parser.add_argument('--steps', type=int, default=100)
    parser.add_argument('--global-batch-size', type=int, default=2)
    parser.add_argument('--seq-len', type=int, default=128)
    parser.add_argument('--optimizer', default='adafactor')
    parser.add_argument('--accum-steps', type=int, default=1,
                        help='gradient accumulation: microbatches per '
                             'optimizer step (global batch must divide)')
    parser.add_argument('--total-steps', type=int, default=10_000,
                        help='LR cosine-decay horizon')
    parser.add_argument('--warmup-steps', type=int, default=100,
                        help='LR warmup steps (the LR is 0 at step 0)')
    parser.add_argument('--data', default=None,
                        help='pretokenized token file (train/data.py '
                             'TokenDataset); synthetic stream when unset')
    parser.add_argument('--remat-policy', default='full',
                        help='remat policy (models/llama.py '
                             'REMAT_POLICIES)')
    parser.add_argument('--log-every', type=int, default=10)
    parser.add_argument('--device', default=None,
                        help="'cpu' to run without a card; CUDA otherwise")
    # Flags of the JAX entry point that the port does not run yet.
    parser.add_argument('--ckpt-dir', default=None, help='not ported yet')
    parser.add_argument('--ckpt-local-dir', default=None,
                        help='not ported yet')
    parser.add_argument('--ckpt-sync', action='store_true',
                        help='not ported yet')
    parser.add_argument('--mesh', default=None, help='not ported yet')
    parser.add_argument('--num-slices', type=int, default=None,
                        help='not ported yet')
    parser.add_argument('--lora-rank', type=int, default=0,
                        help='not ported yet')
    return parser


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    parser = build_parser()
    args = parser.parse_args(argv)
    for name in _NOT_PORTED:
        if getattr(args, name):
            parser.exit(2, f'--{name.replace("_", "-")} is not ported yet '
                           '(skypilot_tpu_torch trains on one device, '
                           'without checkpoints or LoRA)\n')

    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import attention
    from skypilot_tpu_torch.train import data as data_lib
    from skypilot_tpu_torch.train import trainer as trainer_lib

    cfg = trainer_lib.TrainerConfig(
        model=llama.PRESETS[args.model],
        global_batch_size=args.global_batch_size, seq_len=args.seq_len,
        optimizer=args.optimizer, accum_steps=args.accum_steps,
        total_steps=args.total_steps, warmup_steps=args.warmup_steps,
        remat=True, remat_policy=args.remat_policy)
    trainer = trainer_lib.Trainer(cfg, device=args.device)
    dev = trainer.device
    on_card = dev.type == 'cuda'
    card = torch.cuda.get_device_name(dev) if on_card else 'cpu'
    if on_card:
        t0 = time.perf_counter()
        attention.build_library()
        print(f'[train] flash-attention kernels ready in '
              f'{time.perf_counter() - t0:.1f} s', flush=True)
    state = trainer.init_state(seed=0)
    print(f'[train] {args.model} ({cfg.model.param_count / 1e9:.2f}B '
          f'params) seq {cfg.seq_len} batch {cfg.global_batch_size} '
          f'{cfg.optimizer} remat {cfg.remat_policy} on {card}', flush=True)

    dataset = None
    if args.data:
        dataset = data_lib.TokenDataset(args.data, seq_len=cfg.seq_len,
                                        batch_size=cfg.global_batch_size)
    flops = trainer_lib.model_flops_per_step(cfg)
    tokens = trainer_lib.tokens_per_step(cfg)
    losses: List[torch.Tensor] = []
    windows: List[float] = []
    window_t0, window_steps = time.perf_counter(), 0
    for i in range(args.steps):
        if dataset is not None:
            batch = dataset.batch(i)
        else:
            batch = next(iter(data_lib.synthetic_batches(
                cfg.global_batch_size, cfg.seq_len, cfg.model.vocab_size,
                seed=i, num_batches=1)))
        state, metrics = trainer.step(state, batch)
        losses.append(metrics['loss'])
        step, window_steps = i + 1, window_steps + 1
        if step % args.log_every == 0 or step == args.steps:
            loss = float(metrics['loss'])  # waits for the step
            if on_card:
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            step_s = (now - window_t0) / window_steps
            windows.append(step_s * 1e3)
            rate = (f'mfu={trainer_lib.mfu(cfg, step_s):.2%} of '
                    f'{H100_BF16_DENSE_FLOPS / 1e12:.0f} TFLOP/s bf16 dense '
                    'peak'
                    if on_card else 'mfu=not measured')
            print(f'[train] step {step}/{args.steps} loss={loss:.4f} '
                  f'step_ms={step_s * 1e3:.1f} '
                  f'tokens/s={tokens / step_s:.0f} '
                  f'model_flops/s={flops / step_s:.3e} {rate} ({card})',
                  flush=True)
            window_t0, window_steps = now, 0
    print('[train] done', flush=True)
    return {'losses': torch.stack(losses).tolist() if losses else [],
            'window_step_ms': windows, 'state': state}


if __name__ == '__main__':
    main()
