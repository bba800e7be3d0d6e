"""Where a training step's time goes on the card, for BENCH_1B at seq 4096
unless ``--model`` names another preset.

    python -m skypilot_tpu_torch.tools.train_profile [--steps 3]
        [--remat-policy full]
    # the lora-finetune recipe's step:
    python -m skypilot_tpu_torch.tools.train_profile --lora-rank 16 \
        --global-batch-size 16 --seq-len 2048
    # moe-8x1b (8 experts, top-2) on one card:
    python -m skypilot_tpu_torch.tools.train_profile --model moe-8x1b \
        --global-batch-size 2 --seq-len 2048

Runs the port's ``Trainer`` (global batch 2 unless set, Adafactor, warmup
1; with ``--lora-rank``, LoRA of rank r, alpha 32, targets wq,wk,wv,wo)
and prints JSON lines:

* ``step``: step ms on the host clock over ``--steps`` steps after two
  warm-up steps, each window ended by ``torch.cuda.synchronize()``;
  tokens/s; model FLOP/s (6 N T) and its share of the H100's dense bf16
  peak (``utils/device.py``); peak device memory;
* ``profile``: over one step under ``torch.profiler``, the device's busy
  share (kernel time over wall time), kernels per step, device time by
  group (the flash-attention kernels K1-K3, float32 GEMMs, which are an
  MoE model's one-hot dispatch and combine products, other GEMMs, the
  rest), the device
  time of each of K1, K2 and K3, and the top kernels by device time;
* ``lm_head``: the unembedding product at this shape as the port runs it
  (float32 copies of x and ``lm_head``, TF32 off, which is exact for bf16
  operands as JAX's ``preferred_element_type=float32`` is) against a
  bf16 product with a bf16 result, forward only, CUDA events.

Needs one CUDA card; numbers are for the card named on the first line.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import attention
from skypilot_tpu_torch.train import data as data_lib
from skypilot_tpu_torch.train import trainer as trainer_lib
from skypilot_tpu_torch.utils.device import resolve_device

SEQ_LEN, GLOBAL_BATCH = 4096, 2
_FLASH = ('flash_fwd', 'flash_bwd_dq', 'flash_bwd_dkv')  # both bodies


def _group(name: str) -> str:
    if any(k in name for k in _FLASH):
        return 'flash_attention'
    low = name.lower()
    if 'sgemm' in low or 'gemm_f32f32' in low:
        return 'gemm_fp32'
    if any(k in low for k in ('gemm', 'xmma', 'cutlass', 'nvjet')):
        return 'gemm'
    return 'other'


def _event_ms(fn, iters: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--steps', type=int, default=3)
    parser.add_argument('--model', default='bench-1b',
                        help='preset name (models/llama.py PRESETS)')
    parser.add_argument('--remat-policy', default='full')
    parser.add_argument('--global-batch-size', type=int,
                        default=GLOBAL_BATCH)
    parser.add_argument('--seq-len', type=int, default=SEQ_LEN)
    parser.add_argument('--lora-rank', type=int, default=0,
                        help='LoRA rank (alpha 32, wq,wk,wv,wo); 0 = full '
                             'finetune')
    args = parser.parse_args(argv)

    dev = resolve_device()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    attention.build_library()
    lora = None
    if args.lora_rank:
        from skypilot_tpu_torch.models import lora as lora_lib
        lora = lora_lib.LoraConfig(rank=args.lora_rank, alpha=32.0)
    cfg = trainer_lib.TrainerConfig(
        model=llama.PRESETS[args.model],
        global_batch_size=args.global_batch_size,
        seq_len=args.seq_len, warmup_steps=1,
        remat_policy=args.remat_policy, lora=lora)
    trainer = trainer_lib.Trainer(cfg, device=dev)
    state = trainer.init_state(seed=0)
    batches = data_lib.synthetic_batches(cfg.global_batch_size, cfg.seq_len,
                                         cfg.model.vocab_size, seed=0)

    def step():
        nonlocal state
        state, metrics = trainer.step(state, next(batches))
        return metrics

    for _ in range(2):  # warm-up (allocator, cuBLAS heuristics)
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        metrics = step()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / args.steps
    flops = trainer_lib.model_flops_per_step(cfg)
    print(json.dumps({
        'step': {'model': args.model, 'seq_len': cfg.seq_len,
                 'global_batch_size': cfg.global_batch_size,
                 'remat_policy': cfg.remat_policy,
                 'lora_rank': args.lora_rank,
                 'step_ms': step_s * 1e3,
                 'tokens_per_s': trainer_lib.tokens_per_step(cfg) / step_s,
                 'model_flops_per_s': flops / step_s,
                 'mfu_vs_bf16_dense_peak': trainer_lib.mfu(cfg, step_s),
                 'active_param_share': (cfg.model.active_param_count
                                        / cfg.model.param_count),
                 'loss': float(metrics['loss']),
                 'moe_aux': (float(metrics['moe_aux'])
                             if 'moe_aux' in metrics else None),
                 'peak_memory_gib':
                     torch.cuda.max_memory_allocated() / 2 ** 30}}),
          flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = collections.defaultdict(float)
    count = 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] += evt.time_range.end - evt.time_range.start
            count += 1
    if not count:
        print(json.dumps({'profile': 'not measured (no device events)'}),
              flush=True)
    else:
        busy = sum(by_name.values())
        groups = collections.defaultdict(float)
        for name, t in by_name.items():
            groups[_group(name)] += t
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        flash = {k: sum(t for name, t in by_name.items() if k in name) / 1e3
                 for k in _FLASH}
        print(json.dumps({'profile': {
            'wall_ms': wall_us / 1e3, 'device_busy_ms': busy / 1e3,
            'device_busy_share': busy / wall_us, 'kernels_per_step': count,
            'device_ms_by_group': {k: v / 1e3 for k, v in groups.items()},
            'flash_ms_by_kernel': flash,
            'top_kernels_ms': [(k[:90], t / 1e3) for k, t in top]}}),
            flush=True)

    rows = cfg.global_batch_size * cfg.seq_len
    x = torch.randn(rows, cfg.model.d_model, device=dev).to(torch.bfloat16)
    w = state['params']['lm_head'].detach()
    print(json.dumps({'lm_head': {
        'shape': [rows, cfg.model.d_model, cfg.model.vocab_size],
        'fp32_copies_ms': _event_ms(lambda: x.float() @ w.float(), 10),
        'bf16_ms': _event_ms(lambda: x @ w, 10)}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
