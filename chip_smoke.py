#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``skypilot_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Build: compiles the flash-decode kernel from ``skypilot_tpu_torch/csrc``
   with nvcc and prints the seconds and the compiler's register report.
2. Kernel against its plain version at BENCH_1B decode shapes (Hq=16,
   Hkv=8, D=128, M=1024, B in {1, 32}; M=1000; a D=64 case), bf16 and
   int8 caches, bf16 and fp32 queries. Tolerances: bf16 2e-2 (bf16 output
   rounding, sums in another order), fp32 1e-4. Prints kernel, plain,
   library (SDPA) and bound ms per case, from CUDA events after warm-up.
3. End to end on a small model (head_dim 64, float32): prefill and decode
   logits on the card (through the kernel) against the CPU (plain path).
4. Serving: ``LlmServer('bench-1b', max_len=1024)`` over HTTP, bf16
   weights + bf16 KV, then int8 weights + int8 KV. A few concurrent
   requests (greedy and seeded-sampled); checks status, token counts and
   ids, repeat determinism, agreement with a direct ``generate`` call, and
   that the kernel was launched n_layers * (max_new - 1) times for each
   generate call. Prints decode tokens/s.
5. Summary: one JSON line of kernels, then the last line
   ``{"ok": true, "device": {...}}``.

It exits with an error, printing no result, when CUDA is absent or when
the ``skypilot_tpu_torch`` package is not beside it.
"""
import concurrent.futures
import dataclasses
import itertools
import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12        # HBM3, SXM data sheet
H100_OPS_PER_S = {torch.bfloat16: 989e12,   # dense tensor-core bf16
                  torch.float32: 67e12}     # fp32 outside tensor cores
L2_BYTES = 50 * 2 ** 20
MODES = {'bf16': ('skypilot_tpu/ops/decode_attention.py:147', False),
         'int8': ('skypilot_tpu/ops/decode_attention.py:162', True)}


def _card() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int) -> float:
    """Mean ms per call from CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 2: the kernel against its plain version ------------------------------


def _make_case(gen, b, hq, hkv, d, m, lengths, dtype, quant):
    dev = 'cuda'
    q = torch.randn(b, hq, d, generator=gen, device=dev).to(dtype)
    kf = torch.randn(b, hkv, m, d, generator=gen, device=dev)
    vf = torch.randn(b, hkv, m, d, generator=gen, device=dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    if not quant:
        return [q, kf.to(dtype), vf.to(dtype), lens, None, None]
    k_s = torch.clamp_min(kf.abs().amax(-1) / 127.0, 1e-8)
    v_s = torch.clamp_min(vf.abs().amax(-1) / 127.0, 1e-8)
    k8 = torch.clamp(torch.round(kf / k_s[..., None]), -127, 127)
    v8 = torch.clamp(torch.round(vf / v_s[..., None]), -127, 127)
    return [q, k8.to(torch.int8), v8.to(torch.int8), lens, k_s, v_s]


def _bound(args):
    """Least time for the work this call needs: each input byte it must
    read (K/V and scales up to each row's length; an empty row reads all
    M) and each output byte written once, over HBM bandwidth; or its
    flops over the peak rate for q's type; whichever is larger."""
    q, k, v, lens, k_s, _ = args
    b, hq, d = q.shape
    hkv, m = k.shape[1], k.shape[2]
    span = [x if x > 0 else m for x in (min(int(y), m) for y in lens.tolist())]
    pos = sum(span) * hkv
    nbytes = (2 * q.numel() * q.element_size() + lens.numel() * 4
              + 2 * pos * d * k.element_size()
              + (2 * pos * 4 if k_s is not None else 0))
    ops = 4 * pos * (hq // hkv) * d
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_OPS_PER_S[q.dtype] * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def _copies(args):
    """Enough copies of the inputs to exceed L2, so that timed launches
    read device memory the way a decode step (which streams every layer's
    cache and all weights between two reads of one layer) finds it."""
    nbytes = sum(t.numel() * t.element_size() for t in args
                 if t is not None)
    n = max(1, -(-2 * L2_BYTES // nbytes))
    return [args] + [[None if t is None else t.clone() for t in args]
                     for _ in range(n - 1)]


def _sdpa_ms(args, iters):
    """One PyTorch call computing the same function (bf16 cache only):
    scaled_dot_product_attention with GQA and a length mask."""
    q, k, v, lens, _, _ = args
    m = k.shape[2]
    mask = (torch.arange(m, device='cuda')[None, :]
            < torch.clamp_min(lens, 1)[:, None].long())[:, None, None, :]
    sets = [(q[:, :, None], a[1], a[2]) for a in _copies(args)]
    it = itertools.count()

    def call():
        qq, kk, vv = sets[next(it) % len(sets)]
        torch.nn.functional.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mask, enable_gqa=True)
    return _time_ms(call, iters)


def kernel_phase(da):
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    rng = np.random.default_rng(0)
    mixed = rng.integers(1, 1025, 32).tolist()
    mixed[:3] = [1024, 1, 33]  # full, one position, a mid-tile end
    shapes = [  # (label, b, hq, hkv, d, m, lengths)
        ('B=32 M=1024', 32, 16, 8, 128, 1024, mixed),
        ('B=1 M=1024', 1, 16, 8, 128, 1024, [700]),
        ('B=4 M=1000', 4, 16, 8, 128, 1000, [1000, 999, 517, 0]),
        ('B=8 M=1024 D=64', 8, 32, 8, 64, 1024,
         rng.integers(1, 1025, 8).tolist()),
    ]
    results = {mode: {'max_abs_err': 0.0, 'cases': []} for mode in MODES}
    for mode, (_, quant) in MODES.items():
        for label, b, hq, hkv, d, m, lengths in shapes:
            for dtype in (torch.bfloat16, torch.float32):
                args = _make_case(gen, b, hq, hkv, d, m, lengths, dtype,
                                  quant)
                out = da.flash_decode(*args)
                torch.cuda.synchronize()
                ref = da.flash_decode_reference(*args)
                tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
                err = float((out.float() - ref.float()).abs().max())
                if not torch.allclose(out.float(), ref.float(), atol=tol,
                                      rtol=tol):
                    raise AssertionError(
                        f'flash_decode {mode} {label} {dtype}: max abs err '
                        f'{err} beyond {tol}')
                results[mode]['max_abs_err'] = max(
                    results[mode]['max_abs_err'], err)
                row = {'case': label, 'dtype': str(dtype).split('.')[-1],
                       'max_abs_err': err, 'tol': tol}
                if dtype == torch.bfloat16:  # the serving type: time it
                    sets = _copies(args)
                    it = itertools.count()
                    row['ms'] = _time_ms(
                        lambda: da.flash_decode(
                            *sets[next(it) % len(sets)]), 200)
                    row['plain_ms'] = _time_ms(
                        lambda: da.flash_decode_reference(*args), 20)
                    row['library_ms'] = (None if quant
                                         else _sdpa_ms(args, 100))
                    row['bound_ms'], row['bound_by'] = _bound(args)
                results[mode]['cases'].append(row)
                print(f'  {mode:4s} {label:16s} {row["dtype"]:8s} '
                      + ' '.join(f'{k}={v}' for k, v in row.items()
                                 if k not in ('case', 'dtype')), flush=True)
    return results


# -- phase 3: end to end on a small model, card against CPU -----------------------


def small_model_phase(llama, gen_lib):
    cfg = dataclasses.replace(llama.TINY, d_model=128, n_heads=4,
                              n_kv_heads=2, head_dim=64, dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
    on_card = _tree_to(params, 'cuda')
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 12)
                                           ).astype(np.int32))
    row_lens = torch.tensor([12, 5, 9], dtype=torch.int32)
    worst = 0.0
    for kv_quant in (False, True):
        caches = {dev: gen_lib.init_cache(cfg, 3, 32, quantize=kv_quant,
                                          device=dev)
                  for dev in ('cpu', 'cuda')}
        toks, lens = tokens, row_lens
        for _ in range(8):
            logits = {}
            for dev, p in (('cpu', params), ('cuda', on_card)):
                logits[dev], caches[dev] = gen_lib.forward_cached(
                    p, toks.to(dev), caches[dev], cfg, lens.to(dev))
            err = float((logits['cuda'].cpu() - logits['cpu']).abs().max())
            worst = max(worst, err)
            if not err <= 1e-3:
                raise AssertionError(f'small model logits: card vs CPU '
                                     f'max abs err {err} > 1e-3')
            toks = torch.argmax(logits['cpu'], -1).to(torch.int32)[:, None]
            lens = torch.ones(3, dtype=torch.int32)
    print(f'  small model (d_model 128, head_dim 64, fp32), prefill + 7 '
          f'decode steps, full and int8 KV: max abs logit err card vs CPU '
          f'{worst} (limit 1e-3)', flush=True)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# -- phase 4: the serving replica ---------------------------------------------------


def _post(url, body, timeout=600):
    req = urllib.request.Request(
        f'{url}/generate', data=json.dumps(body).encode(),
        headers={'Content-Type': 'application/json'}, method='POST')
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def serving_phase(srv_lib, gen_lib, da, quantize, kv_cache):
    server = srv_lib.LlmServer('bench-1b', max_len=1024, quantize=quantize,
                               kv_cache=kv_cache)
    cfg = server.cfg
    httpd = server.make_httpd('127.0.0.1', 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f'http://127.0.0.1:{httpd.server_address[1]}'
    try:
        rng = np.random.default_rng(2)

        def prompt(n):
            return rng.integers(0, cfg.vocab_size, n).tolist()
        greedy = {'tokens': [prompt(17)], 'max_new_tokens': 32}
        reqs = [greedy,
                {'tokens': [prompt(128)], 'max_new_tokens': 48},
                {'tokens': [prompt(300)], 'max_new_tokens': 64},
                {'tokens': [prompt(64)], 'max_new_tokens': 40,
                 'temperature': 0.8, 'seed': 7, 'top_k': 50, 'top_p': 0.95}]
        _post(url, {'tokens': [prompt(8)], 'max_new_tokens': 2})  # warm-up
        server.generate_calls.clear()
        da.flash_decode.launches = 0
        with concurrent.futures.ThreadPoolExecutor(len(reqs)) as pool:
            answers = list(pool.map(lambda r: _post(url, r), reqs))
        launches = da.flash_decode.launches
        calls = list(server.generate_calls)
        expected = sum(cfg.n_layers * (max_new - 1) for _, max_new in calls)
        if launches != expected or not calls:
            raise AssertionError(f'flash_decode launched {launches} times '
                                 f'for generate calls {calls}; expected '
                                 f'{expected}')
        for req, (status, body) in zip(reqs, answers):
            rows = body['tokens']
            if status != 200 or len(rows) != 1 \
                    or len(rows[0]) != req['max_new_tokens'] \
                    or not all(0 <= t < cfg.vocab_size for t in rows[0]):
                raise AssertionError(f'bad answer {status} {body}')
        if _post(url, greedy)[1] != _post(url, greedy)[1]:
            raise AssertionError('repeated greedy request changed tokens')
        if _post(url, reqs[3])[1] != answers[3][1]:
            raise AssertionError('repeated seeded request changed tokens')
        tokens, lens = gen_lib.pad_prompts(greedy['tokens'],
                                           device=server.device)
        direct = gen_lib.generate(server.params, cfg, tokens, 32,
                                  max_len=1024, prompt_lengths=lens,
                                  kv_quantize=kv_cache == 'int8').tolist()
        if _post(url, greedy)[1]['tokens'] != direct:
            raise AssertionError('served tokens differ from generate()')
        rates = {}
        for rows in (1, 32):
            body = {'tokens': [prompt(128) for _ in range(rows)],
                    'max_new_tokens': 64}
            _post(url, body)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _post(url, body)
            rates[rows] = rows * 64 / (time.perf_counter() - t0)
        label = f'{quantize or "bf16"} weights + {kv_cache} KV'
        print(f'  bench-1b {label}: {len(reqs)} concurrent requests in '
              f'{len(calls)} generate calls {calls}, flash_decode launches '
              f'{launches} = n_layers x sum(max_new - 1); request tok/s '
              f'(prompt 128 + 64 new): B=1 {rates[1]:.1f}, '
              f'B=32 {rates[32]:.1f}', flush=True)
        return launches
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()
        thread.join(30)
        del server
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    from skypilot_tpu_torch.models import generate as gen_lib
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import decode_attention as da
    from skypilot_tpu_torch.serve import llm_server as srv_lib
    from skypilot_tpu_torch.utils.device import resolve_device
    print(_card(), flush=True)
    resolve_device()
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'python {sys.version.split()[0]}', flush=True)

    print('phase 1: build', flush=True)
    t0 = time.perf_counter()
    log = da.build_library()
    print(f'  built {da.SOURCE.name} in {time.perf_counter() - t0:.2f} s',
          flush=True)
    for line in log.splitlines():
        if 'registers' in line:
            print('  ' + line.strip(), flush=True)

    print('phase 2: flash_decode against its plain version', flush=True)
    kernels = kernel_phase(da)

    print('phase 3: small model end to end, card against CPU', flush=True)
    small_model_phase(llama, gen_lib)

    print('phase 4: serving bench-1b over HTTP', flush=True)
    launches = {'bf16': serving_phase(srv_lib, gen_lib, da, None, 'bf16'),
                'int8': serving_phase(srv_lib, gen_lib, da, 'int8', 'int8')}

    entries = []
    for mode, (replaces, _) in MODES.items():
        head = kernels[mode]['cases'][0]  # B=32 M=1024 bf16: serving shape
        entries.append({
            'name': f'flash_decode[{mode} cache]', 'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/decode_attention.cu',
            'replaces': replaces, 'launches': launches[mode],
            'max_abs_err': kernels[mode]['max_abs_err'],
            'ms': head['ms'], 'plain_ms': head['plain_ms'],
            'bound_ms': head['bound_ms'], 'bound_by': head['bound_by'],
            'library_ms': head['library_ms']})
    print(json.dumps({'kernels': entries}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
