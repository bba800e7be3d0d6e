"""Where the continuous engine's time goes on the card, for BENCH_1B.

    python -m skypilot_tpu_torch.tools.engine_profile
    python -m skypilot_tpu_torch.tools.engine_profile --model llama3-1b \
        --max-len 2048 --kv-layout both --weights-kv int8 --pipeline on
    python -m skypilot_tpu_torch.tools.engine_profile --weights-kv bf16 \
        --draft-model bench-draft   # speculative rounds (k 4)
    python -m skypilot_tpu_torch.tools.engine_profile --model moe-8x1b \
        --pipeline off   # MoE: the engine dispatches serially

For bf16 weights + bf16 KV and for int8 weights + int8 KV, the engine in
the replica's default configuration (16 slots, ``max_len`` 1024, chunks of
8 steps, the slot layout) is filled with 16 requests at once (prompt 128,
64 new tokens each, greedy, no shared prefix), pipelined and then serial
(``pipeline=False``), after one warm-up round. The flags pick the model,
``max_len``, the KV layouts (``paged``: blocks of 16, the full-capacity
pool, sharing and tiers at their defaults), the weight and KV modes and
the pipeline settings to run; ``--draft-model`` gives the engine a draft
(weights from seed 1, ``--spec-k`` proposals a round; rounds are serial,
so the pipeline setting has no effect and one run is made per layout and
mode, and a "step" is a round). It prints one JSON line per run with:

* ``tok_s``: generated tokens over the host-clock time from submit to the
  last answer (prefill included);
* ``step_ms``: host-clock time per decode step, from the first chunk's
  dispatch to the last answer over the decode steps issued;
* ``pipeline``: the engine's ``stats()['pipeline']`` for the run (overlap,
  bubble, dispatch gap);
* ``device_busy_share``: the device time of all kernels over the wall
  time of a ``torch.profiler`` window around a second such round;
  ``kernels_per_step``; ``flash_decode_share_of_device_time`` and
  ``flash_decode_device_us_per_call`` (both kernels of a call, K4);
  and the top kernels by device time.

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

from skypilot_tpu_torch.models import engine as engine_lib
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import quantization as quant_lib
from skypilot_tpu_torch.ops.decode_attention import flash_decode
from skypilot_tpu_torch.utils.device import resolve_device

SLOTS, PROMPT, NEW, MAX_LEN = 16, 128, 64, 1024
# The two kernels of one flash_decode call (csrc/decode_attention.cu).
_FLASH_DECODE = ('decode_split_kernel', 'decode_combine_kernel')


def _round(eng, rows):
    """Submit every row at once and wait; returns (wall s, decode wall s,
    decode steps (rounds with a draft), tokens)."""
    d0 = eng.stats()['pipeline']['dispatches']
    t0 = time.perf_counter()
    futs = [eng.submit(r, NEW) for r in rows]
    while eng.stats()['pipeline']['dispatches'] == d0:
        time.sleep(0.0005)
    t_decode = time.perf_counter()
    tokens = sum(len(f.result(timeout=600)) for f in futs)
    t1 = time.perf_counter()
    while eng.busy():
        time.sleep(0.001)
    steps = ((eng.stats()['pipeline']['dispatches'] - d0)
             * (1 if eng.draft_cfg is not None else eng.chunk_steps))
    return t1 - t0, t1 - t_decode, steps, tokens


def _profiled_round(eng, rows):
    calls = flash_decode.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, steps, _ = _round(eng, rows)
        wall_us = (time.perf_counter() - t0) * 1e6
    calls = flash_decode.launches - calls
    by_name = collections.defaultdict(float)
    count = 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] += evt.time_range.end - evt.time_range.start
            count += 1
    if not count:
        return {'device_busy_share': 'not measured (no device events)'}
    busy = sum(by_name.values())
    decode = sum(t for k, t in by_name.items()
                 if any(name in k for name in _FLASH_DECODE))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {'device_busy_share': busy / wall_us,
            'kernels_per_step': count / steps,
            'flash_decode_share_of_device_time': decode / busy,
            'flash_decode_device_us_per_call': decode / calls,
            'top_kernels_us': [(k[:80], t) for k, t in top]}


def _choices(value, both):
    return both if value == 'both' else (value,)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--model', default='bench-1b',
                        choices=sorted(llama.PRESETS))
    parser.add_argument('--max-len', type=int, default=MAX_LEN)
    parser.add_argument('--kv-layout', default='slot',
                        choices=('slot', 'paged', 'both'))
    parser.add_argument('--weights-kv', default='both',
                        choices=('bf16', 'int8', 'both'))
    parser.add_argument('--pipeline', default='both',
                        choices=('on', 'off', 'both'))
    parser.add_argument('--draft-model', default=None,
                        choices=sorted(llama.PRESETS))
    parser.add_argument('--spec-k', type=int, default=4)
    args = parser.parse_args(argv)
    if args.draft_model:
        args.pipeline = 'off'  # spec rounds are serial
    dev = resolve_device()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    cfg = llama.PRESETS[args.model]
    base = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    gen = torch.Generator().manual_seed(1)
    rows = torch.randint(0, cfg.vocab_size, (SLOTS, PROMPT),
                         generator=gen).tolist()
    spec = {}
    if args.draft_model:
        d_cfg = llama.PRESETS[args.draft_model]
        spec = dict(draft_cfg=d_cfg, spec_k=args.spec_k,
                    draft_params=llama.init_params(
                        d_cfg, torch.Generator(device=dev).manual_seed(1),
                        dev))
    runs = [(label, layout, pipeline)
            for label in _choices(args.weights_kv, ('bf16', 'int8'))
            for layout in _choices(args.kv_layout, ('slot', 'paged'))
            for pipeline in _choices(args.pipeline, ('on', 'off'))]
    for label in dict.fromkeys(r[0] for r in runs):
        int8 = label == 'int8'
        params = quant_lib.quantize_params(base) if int8 else base
        for _, layout, pipeline in (r for r in runs if r[0] == label):
            eng = engine_lib.ContinuousEngine(
                params, cfg, slots=SLOTS, max_len=args.max_len,
                chunk_steps=8, kv_quantize=int8, kv_layout=layout,
                pipeline=pipeline == 'on', device=dev, **spec)
            try:
                _round(eng, rows)  # warm-up
                p0 = eng.stats()['pipeline']
                wall, decode_wall, steps, tokens = _round(eng, rows)
                p1 = eng.stats()['pipeline']
                row = {'model': args.model, 'weights_kv': label,
                       'draft_model': args.draft_model,
                       'kv_layout': layout,
                       'pipeline': eng.pipeline_depth > 0,
                       'tok_s': tokens / wall,
                       'step_ms': decode_wall / steps * 1e3,
                       'decode_steps': steps,
                       'pipeline_stats': {
                           'dispatches': p1['dispatches'] - p0['dispatches'],
                           'host_overlap_ms': p1['host_overlap_ms']
                           - p0['host_overlap_ms'],
                           'bubble_ms': p1['bubble_ms'] - p0['bubble_ms'],
                           'dispatch_gap_ms': p1['dispatch_gap_ms']}}
                if spec:
                    row['speculative'] = eng.stats()['speculative']
                row.update(_profiled_round(eng, rows))
            finally:
                eng.stop()
            print(json.dumps(row), flush=True)
        del params
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
