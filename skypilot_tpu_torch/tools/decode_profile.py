"""Where a decode step's time goes on the card, for BENCH_1B.

    python -m skypilot_tpu_torch.tools.decode_profile

For bf16 weights + bf16 KV and for int8 weights + int8 KV, at B=1 and
B=32 (prompt 128, max_len 1024), it prints one JSON line each with:

* ``step_ms``: host-clock time of one decode step, from two ``generate``
  calls that differ only in the number of new tokens (so the prefill
  cancels out), each ended by ``torch.cuda.synchronize()``;
* ``device_busy_share``: the device time of all kernels over the wall
  time of a ``torch.profiler`` window around one ``generate`` call;
* ``kernels_per_token`` (prefill included) and the top kernels by device time, with
  ``flash_decode``'s share.

Needs one CUDA card; numbers are for the card named on the first line.
"""
from __future__ import annotations

import collections
import json
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from skypilot_tpu_torch.models import generate as gen_lib
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import quantization as quant_lib
from skypilot_tpu_torch.utils.device import resolve_device

PROMPT = 128
MAX_LEN = 1024


def _generate(params, cfg, prompt, lens, n, kv_int8):
    out = gen_lib.generate(params, cfg, prompt, n, max_len=MAX_LEN,
                           prompt_lengths=lens, kv_quantize=kv_int8)
    torch.cuda.synchronize()
    return out


def _step_ms(params, cfg, prompt, lens, kv_int8):
    times = {}
    for n in (17, 65):
        _generate(params, cfg, prompt, lens, n, kv_int8)  # warm-up
        t0 = time.perf_counter()
        _generate(params, cfg, prompt, lens, n, kv_int8)
        times[n] = time.perf_counter() - t0
    return (times[65] - times[17]) / 48 * 1e3


def _profile(params, cfg, prompt, lens, kv_int8, n=9):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _generate(params, cfg, prompt, lens, n, kv_int8)
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = collections.defaultdict(float)
    count = 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] += evt.time_range.end - evt.time_range.start
            count += 1
    busy = sum(by_name.values())
    if not count:
        return {'device_busy_share': 'not measured (no device events)'}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    decode = sum(t for k, t in by_name.items() if 'decode_kernel' in k)
    return {'device_busy_share': busy / wall_us,
            'kernels_per_token': count / n,
            'flash_decode_share_of_device_time': decode / busy,
            'top_kernels_us': [(k[:80], t) for k, t in top]}


def main() -> int:
    dev = resolve_device()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    cfg = llama.BENCH_1B
    base = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    for label, kv_int8 in (('bf16', False), ('int8', True)):
        params = quant_lib.quantize_params(base) if kv_int8 else base
        for b in (1, 32):
            prompt = torch.randint(0, cfg.vocab_size, (b, PROMPT),
                                   device=dev, dtype=torch.int32)
            lens = torch.full((b,), PROMPT, dtype=torch.int32, device=dev)
            row = {'weights_kv': label, 'batch': b,
                   'step_ms': _step_ms(params, cfg, prompt, lens, kv_int8)}
            row['decode_tok_s'] = b / row['step_ms'] * 1e3
            row.update(_profile(params, cfg, prompt, lens, kv_int8))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
