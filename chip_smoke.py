#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``skypilot_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Build: compiles both kernel libraries of ``skypilot_tpu_torch/csrc``
   (flash-decode K4, flash-attention K1-K3), one nvcc each, started
   together; prints the seconds and the compiler's register report.
2. K4 against its plain version at BENCH_1B decode shapes (Hq=16,
   Hkv=8, D=128, M=1024, B in {1, 32}; M=1000; a D=64 case), at the edges
   of the kernel's split of the cache (lengths of a chunk and one either
   side, 1, 0 and M, at B=7 and at B=32), with one chunk longer than M
   (M=48, group 1) and a group that is no power of two (3), bf16 and int8
   caches, bf16 and fp32 queries. Tolerances: bf16 2e-2 (bf16 output
   rounding, sums in another order), fp32 1e-4. Every case is also held
   against ``flash_decode_split_reference`` at the kernel's own chunk
   (``decode_split``), the same partials and merge, so only the order of
   sums differs: fp32 to 1e-5, bf16 to ||got - want|| / ||want|| of each
   (row, head) within SPLIT_REL_TOL. Prints kernel, plain, library (SDPA)
   and bound ms per bf16 case, from CUDA events around calls issued one
   after another after warm-up; where the host takes longer to issue a
   call than the device to run it (K4 at small B), that is the host's
   time per call.
3. K1, K2, K3 against their plain versions: the training shape (B=2,
   Hq 16, Hkv 8, D 128, S=4096, bf16, causal), B=1, non-causal, ragged
   S=1000 and S=65, D=64 with group 4, fp32 inputs (the CUDA-core
   bodies; bf16 runs the tensor-core ones), and the edges of the 128-row
   tiles of K1 and K3 (S=4032, a multiple of 64 but not of 128; S=129;
   S=1; D=64 with group 2 at S=4096). Absolute tolerances: bf16 o 2e-2,
   grads 5e-2; fp32 1e-4 and 1e-3 (lse always 1e-3). Those are near the
   size of a bf16 value at S=4096, so each of o, dq, dk, dv is also held
   to a relative limit on every tile of 64 rows along S:
   ||got - want|| / ||want|| over the tile (REL_TOL). Prints kernel,
   plain, library (SDPA forward for K1, SDPA's backward for K2+K3
   together) and bound ms for the training shape, with TFLOP/s and the
   share of the bound. Fails unless every instance of the wgmma bodies of
   K1, K2 and K3 (12: D 64/128, causal or not) shows HGMMA and UTMALDG in
   the library's SASS and ptxas reports 0 spill bytes for it.
4. Serving end to end on a small model (head_dim 64, float32): prefill
   and decode logits on the card (through K4) against the CPU.
5. Training end to end on a small model (head_dim 64, float32): 3 steps
   of the port's ``Trainer`` on the card (K1-K3) and on the CPU from the
   same weights and batches; losses and params compared.
6. Training BENCH_1B, the training main path: ``train.run.main`` at seq
   4096, global batch 2, Adafactor, remat 'full', 4 steps, warmup 1.
   Every loss must be finite, the weights must move, and the launch
   counts must be K1 = 2 * 18 * 4 (remat runs the forward again) and
   K2 = K3 = 18 * 4.
7. Serving, the serving main path: ``LlmServer('bench-1b', max_len=1024)``
   over HTTP, bf16 weights + bf16 KV, then int8 weights + int8 KV. A few
   concurrent requests (greedy and seeded-sampled); checks status, token
   counts and ids, repeat determinism, agreement with a direct
   ``generate`` call, and that K4 was called n_layers * (max_new - 1)
   times for each generate call (a call is two launches: the split
   kernel and the merge). Prints decode tokens/s.
8. Summary: one JSON line of kernels, then the last line
   ``{"ok": true, "device": {...}}``.

It exits with an error, printing no result, when CUDA is absent or when
the ``skypilot_tpu_torch`` package is not beside it.
"""
import concurrent.futures
import dataclasses
import itertools
import json
import math
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

from skypilot_tpu_torch.utils.device import H100_BF16_DENSE_FLOPS

H100_BYTES_PER_S = 3.35e12        # HBM3, SXM data sheet
H100_OPS_PER_S = {torch.bfloat16: H100_BF16_DENSE_FLOPS,
                  torch.float32: 67e12}     # fp32 outside tensor cores
# K1-K3: largest ||got - want|| / ||want|| allowed on any 64-row tile, for
# (o, grads); about 4x the largest that sound kernels read on an H100 (bf16
# o 2.4e-3, dq 2.7e-4, dk 1.3e-4, dv 8.6e-5; fp32 4.2e-7).
REL_TOL = {torch.bfloat16: (1e-2, 1e-3), torch.float32: (2e-6, 2e-6)}
# K4 in bf16: largest ||got - want|| / ||want|| allowed of any (row, head)
# against the split plain version at the kernel's chunk; about 4x the
# largest that a sound kernel reads on an H100 (5.0e-3, mostly the output's
# bf16 rounding).
SPLIT_REL_TOL = 2e-2
L2_BYTES = 50 * 2 ** 20
MODES = {'bf16': ('skypilot_tpu/ops/decode_attention.py:147', False),
         'int8': ('skypilot_tpu/ops/decode_attention.py:162', True)}
CSRC = 'skypilot_tpu_torch/csrc/'
FLASH = {  # K1-K3: wrapper name -> (TPU kernel, launch counter, source)
    'flash_fwd': ('skypilot_tpu/ops/attention.py:106', 'fwd_launches',
                  CSRC + 'flash_attention_sm90.cuh'),
    'flash_bwd_dq': ('skypilot_tpu/ops/attention.py:206',
                     'bwd_dq_launches', CSRC + 'flash_attention_sm90.cuh'),
    'flash_bwd_dkv': ('skypilot_tpu/ops/attention.py:257',
                      'bwd_dkv_launches', CSRC + 'flash_attention_sm90.cuh')}
# The wgmma + TMA bodies of K1, K2 and K3 (D 64 and 128, causal or not each).
SM90_BODIES = ('flash_fwd_sm90_kernel', 'flash_bwd_dq_sm90_kernel',
               'flash_bwd_dkv_sm90_kernel')


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


def _row_head_rel(got, want):
    """Largest ||got - want|| / ||want|| over D, of any (row, head)."""
    got, want = got.float(), want.float()
    return float(((got - want).norm(dim=-1)
                  / want.norm(dim=-1).clamp_min(1e-30)).max())


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

    def edges(b, m):  # lengths at the edges of the split of the cache
        c = da.decode_split(b, 8, m)[1]
        return ([c - 1, c, c + 1, 1, 0, m, 2 * c + 1]
                + rng.integers(1, m + 1, b - 7).tolist())
    shapes = [  # (label, b, hq, hkv, d, m, lengths)
        ('B=32 M=1024', 32, 16, 8, 128, 1024, mixed),
        ('B=1 M=1024', 1, 16, 8, 128, 1024, [700]),
        ('B=4 M=1000', 4, 16, 8, 128, 1000, [1000, 999, 517, 0]),
        ('B=8 M=1024 D=64', 8, 32, 8, 64, 1024,
         rng.integers(1, 1025, 8).tolist()),
        ('edges B=7 M=1024', 7, 16, 8, 128, 1024, edges(7, 1024)),
        ('edges B=32 M=1024', 32, 16, 8, 128, 1024, edges(32, 1024)),
        ('M=48 G=1', 3, 8, 8, 64, 48, [48, 0, 17]),
        ('M=256 G=3', 2, 24, 8, 128, 256, [200, 5]),
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
                       'max_abs_err': err, 'tol': tol,
                       'split': da.decode_split(b, hkv, m)}
                # The kernel's own order of work: fp32 to 1e-5; bf16 (the
                # output rounded to bf16) per (row, head) to SPLIT_REL_TOL.
                split = da.flash_decode_split_reference(
                    *args, chunk=row['split'][1])
                if dtype == torch.float32:
                    row['split_err'] = float((out - split).abs().max())
                    if not torch.allclose(out, split, atol=1e-5, rtol=1e-5):
                        raise AssertionError(
                            f'flash_decode {mode} {label}: max abs err '
                            f'{row["split_err"]} against the split plain '
                            'version beyond 1e-5')
                else:
                    row['split_rel'] = _row_head_rel(out, split)
                    if not row['split_rel'] <= SPLIT_REL_TOL:
                        raise AssertionError(
                            f'flash_decode {mode} {label} bf16: '
                            f'||got - want|| / ||want|| of a (row, head) '
                            f'{row["split_rel"]} against the split plain '
                            f'version beyond {SPLIT_REL_TOL}')
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


# -- phase 3: K1-K3 against their plain versions ----------------------------------


def _attn_case(gen, b, hq, hkv, s, d, dtype):
    def r(*shape):
        return torch.randn(*shape, generator=gen, device='cuda').to(dtype)
    return r(b, hq, s, d), r(b, hkv, s, d), r(b, hkv, s, d), r(b, hq, s, d)


def _attn_flops(q, causal, n_matmuls):
    """Flops of n_matmuls products over the (query, key) pairs; causal
    counts the pairs of the lower triangle only."""
    b, hq, s, d = q.shape
    pairs = s * (s + 1) // 2 if causal else s * s
    return 2 * n_matmuls * d * pairs * b * hq


def _attn_bound(q, k, causal, n_matmuls, nbytes):
    """max(flops / peak for q's type, bytes / HBM rate), in ms."""
    t_ops = _attn_flops(q, causal, n_matmuls) / H100_OPS_PER_S[q.dtype]
    t_bytes = nbytes / H100_BYTES_PER_S
    return ((t_ops * 1e3, 'operations') if t_ops >= t_bytes
            else (t_bytes * 1e3, 'bytes'))


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _tile_rel_err(got, want, tile=64):
    """Largest ||got - want|| / ||want|| over tiles of ``tile`` rows
    along S (dim -2; every batch and head of the tile together), so that a
    fault confined to a few tiles, such as late rows, shows at full size."""
    def per_tile(x):
        sq = (x.double() ** 2).transpose(-2, 0).reshape(x.shape[-2], -1)
        sq = torch.nn.functional.pad(sq.sum(1), (0, -x.shape[-2] % tile))
        return sq.reshape(-1, tile).sum(1).sqrt()
    return float((per_tile(got - want) / per_tile(want)).max())


def attention_phase(fa):
    gen = torch.Generator(device='cuda')
    gen.manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (label, b, hq, hkv, s, d, dtype, causal)
        ('train B=2 S=4096', 2, 16, 8, 4096, 128, bf16, True),
        ('B=1 S=4096', 1, 16, 8, 4096, 128, bf16, True),
        ('full S=2048', 1, 16, 8, 2048, 128, bf16, False),
        ('ragged S=1000', 1, 16, 8, 1000, 128, bf16, True),
        ('D=64 G=4 S=1024', 1, 32, 8, 1024, 64, bf16, True),
        ('G=4 full S=65', 2, 4, 1, 65, 128, bf16, False),
        ('fp32 S=1000', 1, 16, 8, 1000, 128, f32, True),
        ('fp32 full S=517', 2, 8, 2, 517, 64, f32, False),
        ('S=4032', 1, 16, 8, 4032, 128, bf16, True),
        ('S=129', 1, 16, 8, 129, 128, bf16, True),
        ('S=1', 1, 16, 8, 1, 128, bf16, True),
        ('D=64 G=2 S=4096', 1, 16, 8, 4096, 64, bf16, True),
    ]
    worst = {name: 0.0 for name in FLASH}
    head = {}
    for label, b, hq, hkv, s, d, dtype, causal in cases:
        q, k, v, do = _attn_case(gen, b, hq, hkv, s, d, dtype)
        o, lse = fa.flash_fwd(q, k, v, causal)
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        ro, rlse = fa.flash_fwd_reference(q, k, v, causal)
        rdq = fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
        rdk, rdv = fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                              causal)
        fwd_tol, grad_tol = (2e-2, 5e-2) if dtype == bf16 else (1e-4, 1e-3)
        errs, rels = {}, {}
        for name, got, want, tol in (
                ('o', o, ro, fwd_tol), ('lse', lse, rlse, 1e-3),
                ('dq', dq, rdq, grad_tol), ('dk', dk, rdk, grad_tol),
                ('dv', dv, rdv, grad_tol)):
            got, want = got.float(), want.float()
            err = float((got - want).abs().max())
            if not (torch.isfinite(got).all()
                    and torch.allclose(got, want, atol=tol, rtol=tol)):
                raise AssertionError(f'{label} {dtype}: {name} max abs err '
                                     f'{err} beyond {tol}')
            # One key: the softmax's gradient is exactly zero and both sides
            # hold rounding noise, which only the absolute limit bounds.
            zero_grad = s == 1 and name in ('dq', 'dk')
            if float(want.abs().max()) == 0.0 and not zero_grad:
                raise AssertionError(f'{label}: {name} is all zero')
            errs[name] = err
            if zero_grad:
                continue
            if name != 'lse':  # lse ~ log S: the abs limit is relative
                rel_tol = REL_TOL[dtype][name != 'o']
                rels[name] = _tile_rel_err(got, want)
                if not rels[name] <= rel_tol:
                    raise AssertionError(
                        f'{label} {dtype}: {name} tile relative err '
                        f'{rels[name]} beyond {rel_tol}')
        worst['flash_fwd'] = max(worst['flash_fwd'], errs['o'], errs['lse'])
        worst['flash_bwd_dq'] = max(worst['flash_bwd_dq'], errs['dq'])
        worst['flash_bwd_dkv'] = max(worst['flash_bwd_dkv'], errs['dk'],
                                     errs['dv'])
        print(f'  {label:18s} {str(dtype).split(".")[-1]:8s} causal={causal} '
              + ' '.join(f'{k}_err={v:.3g}' for k, v in errs.items())
              + ' ' + ' '.join(f'{k}_tile_rel={v:.3g}'
                               for k, v in rels.items()), flush=True)
        if head:
            continue
        # The training shape: time each kernel, its plain version, the
        # library call and the bound.
        calls = {
            'flash_fwd': (lambda: fa.flash_fwd(q, k, v, causal),
                          lambda: fa.flash_fwd_reference(q, k, v, causal),
                          2, _nbytes(q, k, v, o, lse)),
            'flash_bwd_dq': (
                lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal),
                lambda: fa.flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                                  causal),
                3, _nbytes(q, k, v, do, lse, delta, dq)),
            'flash_bwd_dkv': (
                lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal),
                lambda: fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                   causal),
                4, _nbytes(q, k, v, do, lse, delta, dk, dv)),
        }
        sdpa = _sdpa_train_ms(q, k, v, do, causal)
        for name, (kernel, plain, n_mm, nbytes) in calls.items():
            bound, by = _attn_bound(q, k, causal, n_mm, nbytes)
            head[name] = {
                'ms': _time_ms(kernel, 10), 'plain_ms': _time_ms(plain, 2),
                'library_ms': sdpa['fwd' if name == 'flash_fwd' else 'bwd'],
                'bound_ms': bound, 'bound_by': by}
            tflops = _attn_flops(q, causal, n_mm) / head[name]['ms'] / 1e9
            print(f'    {name}: ' + ' '.join(
                f'{k}={v}' for k, v in head[name].items())
                + f' tflops={tflops:.1f} bound_share='
                f'{bound / head[name]["ms"]:.1%}', flush=True)
        # SDPA's work: 2 products forward; 5 backward (S and dP again,
        # dV, dK, dQ).
        print(f'    sdpa: fwd {sdpa["fwd"]} ms '
              f'{_attn_flops(q, causal, 2) / sdpa["fwd"] / 1e9:.1f} TFLOP/s,'
              f' bwd {sdpa["bwd"]} ms '
              f'{_attn_flops(q, causal, 5) / sdpa["bwd"] / 1e9:.1f} TFLOP/s',
              flush=True)
        del calls
    return {name: dict(head[name], max_abs_err=worst[name])
            for name in FLASH}


def check_sm90_bodies(fa):
    """Every instance of the K1, K2 and K3 bodies for bf16 must run wgmma
    (HGMMA) on TMA loads (UTMALDG), and ptxas must report no spill bytes
    for it."""
    report = fa.compiler_report().splitlines()
    spills = {}
    for line, nxt in zip(report, report[1:] + ['']):
        m = re.search(r'Function properties for (\S+)', line)
        n = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      nxt)
        if m and n:
            spills[m.group(1)] = int(n.group(1)) + int(n.group(2))
    functions = {chunk.split()[0]: chunk
                 for chunk in fa.sass().split('Function : ')[1:]}
    for body in SM90_BODIES:  # 3 bodies x 4 instances
        names = sorted(f for f in functions if body in f)
        if len(names) != 4:
            raise AssertionError(f'{body}: {len(names)} instances in the '
                                 'SASS, expected 4 (D 64/128, causal or not)')
        for name in names:
            missing = [op for op in ('HGMMA', 'UTMALDG')
                       if op not in functions[name]]
            if missing or spills.get(name) != 0:
                raise AssertionError(f'{name}: missing {missing} in SASS, '
                                     f'spill bytes {spills.get(name)}')
        print(f'  {body}: {len(names)} instances, each with HGMMA and '
              'UTMALDG in its SASS and 0 spill bytes', flush=True)


def _sdpa_train_ms(q, k, v, do, causal):
    """One PyTorch call computing the same function: SDPA forward, and
    SDPA's backward (dq, dk, dv together)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd = _time_ms(lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True),
                   10)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = sdpa(*leaves, is_causal=causal, enable_gqa=True)
    bwd = _time_ms(lambda: torch.autograd.grad(out, leaves, do,
                                               retain_graph=True), 10)
    return {'fwd': fwd, 'bwd': bwd}


# -- phase 4: serving a small model, card against CPU --------------------------------


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


# -- phase 5: training a small model, card against CPU -------------------------------


def small_train_phase(llama, trainer_lib, data_lib):
    """3 Adafactor steps (warmup 1, lr 1e-2 so the weights move) of a
    head_dim-64 fp32 model on the card and on the CPU from the same
    weights. Tolerances: loss 1e-4, params 1e-4 (fp32; sums in another
    order, then three Adafactor normalisations)."""
    model = dataclasses.replace(llama.TINY, d_model=128, n_heads=4,
                                n_kv_heads=2, head_dim=64, d_ff=256,
                                dtype=torch.float32)
    cfg = trainer_lib.TrainerConfig(model=model, global_batch_size=2,
                                    seq_len=200, warmup_steps=1,
                                    learning_rate=1e-2)
    init = llama.init_params(model, torch.Generator().manual_seed(0), 'cpu')
    runs = {}
    for dev in ('cpu', 'cuda'):
        trainer = trainer_lib.Trainer(cfg, device=dev)
        state = trainer.init_state_from_numpy(_tree_to_numpy(init))
        losses = []
        for batch in data_lib.synthetic_batches(2, 200, model.vocab_size,
                                                seed=3, num_batches=3):
            state, metrics = trainer.step(state, batch)
            losses.append(float(metrics['loss']))
        runs[dev] = (losses, _flat(state['params']))
    loss_err = max(abs(a - b) for a, b in zip(runs['cpu'][0],
                                              runs['cuda'][0]))
    param_err = max(float((a - b.cpu()).abs().max()) for a, b in zip(
        runs['cpu'][1], runs['cuda'][1]))
    moved = max(float((a - b).abs().max()) for a, b in zip(
        runs['cpu'][1], _flat(init)))
    if not (loss_err <= 1e-4 and param_err <= 1e-4 and moved > 1e-3):
        raise AssertionError(f'small model training: card vs CPU loss err '
                             f'{loss_err}, param err {param_err} (limits '
                             f'1e-4), weights moved {moved}')
    print(f'  small model (d_model 128, head_dim 64, fp32), 3 Adafactor '
          f'steps: losses {runs["cuda"][0]}; card vs CPU max loss err '
          f'{loss_err}, max param err {param_err} (limits 1e-4); weights '
          f'moved up to {moved}', flush=True)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree.detach()]


def _tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


# -- phase 6: training BENCH_1B through the entry point -------------------------------


def train_phase(llama, fa, train_run):
    steps, layers = 4, llama.BENCH_1B.n_layers
    for counter in ('fwd_launches', 'bwd_dq_launches', 'bwd_dkv_launches'):
        setattr(fa.flash_attention, counter, 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train_run.main(['--model', 'bench-1b', '--seq-len', '4096',
                          '--global-batch-size', '2', '--steps', str(steps),
                          '--warmup-steps', '1', '--optimizer', 'adafactor',
                          '--remat-policy', 'full', '--log-every', '1'])
    wall = time.perf_counter() - t0
    launches = {name: getattr(fa.flash_attention, counter)
                for name, (_, counter, _) in FLASH.items()}
    expected = {'flash_fwd': 2 * layers * steps,
                'flash_bwd_dq': layers * steps,
                'flash_bwd_dkv': layers * steps}
    if launches != expected:
        raise AssertionError(f'training launches {launches}, expected '
                             f'{expected}')
    losses = out['losses']
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f'training losses {losses}')
    init = llama.init_params(llama.BENCH_1B, torch.Generator(
        device='cuda').manual_seed(0), 'cuda')
    changed = total = 0
    for a, b in zip(_flat(out['state']['params']), _flat(init)):
        changed += int((a != b).sum())
        total += a.numel()
    del init
    if changed == 0:
        raise AssertionError('training left every weight unchanged')
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'  bench-1b seq 4096 batch 2, {steps} steps in {wall:.1f} s: '
          f'losses {losses}; step ms by window {out["window_step_ms"]}; '
          f'{changed / total:.2%} of weights changed (bf16 weights keep '
          f'updates below half an ulp); peak device memory {peak:.1f} GiB; '
          f'launches {launches} = expected', flush=True)
    del out
    torch.cuda.empty_cache()
    return launches


# -- phase 7: the serving replica ---------------------------------------------------


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


def _build_all(libs):
    """One nvcc per kernel library, all started together; prints each
    kernel's registers, any spills, and any wgmma the compiler had to
    serialise."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        logs = list(pool.map(lambda lib: lib.build_library(), libs))
    print(f'  built {", ".join(lib.SOURCE.name for lib in libs)} in '
          f'{time.perf_counter() - t0:.2f} s', flush=True)
    for lib, log in zip(libs, logs):
        for line in log.splitlines():
            if ('registers' in line or 'wgmma' in line
                    or 'spill' in line and ' 0 bytes spill' not in line):
                print(f'  {lib.SOURCE.name}: {line.strip()}', flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    from skypilot_tpu_torch.models import generate as gen_lib
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import attention as fa
    from skypilot_tpu_torch.ops import decode_attention as da
    from skypilot_tpu_torch.serve import llm_server as srv_lib
    from skypilot_tpu_torch.train import data as data_lib
    from skypilot_tpu_torch.train import run as train_run
    from skypilot_tpu_torch.train import trainer as trainer_lib
    from skypilot_tpu_torch.utils.device import resolve_device
    print(_card(), flush=True)
    resolve_device()
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'python {sys.version.split()[0]}', flush=True)

    print('phase 1: build', flush=True)
    _build_all([da, fa])

    print('phase 2: flash_decode (K4) against its plain version', flush=True)
    kernels = kernel_phase(da)

    print('phase 3: flash attention (K1-K3) against the plain versions',
          flush=True)
    flash = attention_phase(fa)
    check_sm90_bodies(fa)

    print('phase 4: small model serving, card against CPU', flush=True)
    small_model_phase(llama, gen_lib)

    print('phase 5: small model training, card against CPU', flush=True)
    small_train_phase(llama, trainer_lib, data_lib)

    print('phase 6: training bench-1b at seq 4096 through train.run',
          flush=True)
    train_launches = train_phase(llama, fa, train_run)

    print('phase 7: serving bench-1b over HTTP', flush=True)
    launches = {'bf16': serving_phase(srv_lib, gen_lib, da, None, 'bf16'),
                'int8': serving_phase(srv_lib, gen_lib, da, 'int8', 'int8')}

    entries = []
    for name, (replaces, _, source) in FLASH.items():
        entries.append({
            'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': train_launches[name],
            **flash[name]})
    for mode, (replaces, _) in MODES.items():
        head = kernels[mode]['cases'][0]  # B=32 M=1024 bf16: serving shape
        entries.append({
            'name': f'flash_decode[{mode} cache]', 'route': 'cuda',
            'source': CSRC + 'decode_attention.cu',
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
