"""Flash attention for training: forward, and backward through dQ and dK/dV.

Port of ``skypilot_tpu/ops/attention.py``. The three Pallas kernels there
become CUDA C++ kernels for Hopper: the bf16 bodies of all three in
``csrc/flash_attention_sm90.cuh`` (TMA rings fed by a producer warpgroup,
products on wgmma), the fp32 bodies and the C entry points in
``csrc/flash_attention.cu``; built with ``nvcc`` at first use and loaded
with ``ctypes`` (``ops/_build.py``). At the training shapes the kernels
are bound by the tensor cores' rate, not by memory, so their design is
about keeping wgmma busy: loads run ahead through the rings and the
exponentials of one consumer overlap the other's products; all three are
persistent, one block per SM taking work tiles from a counter in
L2-sized sections (the header of ``flash_attention_sm90.cuh`` says more;
``flash_schedule`` mirrors how the bodies cut their work).

* K1 ``flash_fwd`` (``_flash_fwd_kernel``, ``attention.py:106``): o and
  the fp32 log-sum-exp;
* K2 ``flash_bwd_dq`` (``_flash_bwd_dq_kernel``, ``attention.py:206``):
  dq in q's dtype, from fp32 sums;
* K3 ``flash_bwd_dkv`` (``_flash_bwd_dkv_kernel``, ``attention.py:257``):
  dk and dv in fp32, summed over the GQA group.

Each wrapper launches its kernel on CUDA tensors (or raises) and computes
its plain version on CPU tensors, and only there. ``flash_attention`` is
the public op: a ``torch.autograd.Function`` whose forward is K1 and whose
backward is ``delta = rowsum(dO * o)`` (a PyTorch elementwise pass, as the
JAX package leaves it to XLA) then K2 and K3. It takes any S >= 1: the
kernels mask ragged tails, so neither the JAX package's S % 128 gate nor
its VMEM fallback (``_BWD_VMEM_CAP_ELEMS``) is carried over.

Layouts are the JAX package's: q [B, Hq, S, D], k/v [B, Hkv, S, D] with
query head h reading kv head h // (Hq // Hkv); lse and delta
[B, Hq, S, 1] fp32.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import flash_schedule

_NEG_INF = -1e30
HEAD_DIMS = (64, 128)  # the head widths the presets use
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# -- plain versions -------------------------------------------------------------


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Plain attention, line for line ``attention.py:72``: products of
    q's dtype summed in fp32, fp32 softmax, probabilities cast to v's
    dtype before the product with v."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    assert hq % hkv == 0, (hq, hkv)
    qg = q.reshape(b, hkv, hq // hkv, s, d)
    scale = d ** -0.5
    logits = torch.einsum('bhgqd,bhkd->bhgqk', qg.float(), k.float()) * scale
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum('bhgqk,bhkd->bhgqd', probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, hq, s, d).to(q.dtype)


def _logits(q, k, causal):
    """fp32 scaled logits [B, Hkv, G, S, S] and the causal keep-mask
    (None when not causal)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, s, d)
    logits = torch.einsum('bhgqd,bhkd->bhgqk', qg.float(),
                          k.float()) * d ** -0.5
    mask = (torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
            if causal else None)
    return logits, mask


def flash_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: (o in q's dtype, lse [B, Hq, S, 1] fp32).
    Unnormalised probabilities, relative to the row max, are cast to v's
    dtype before the product with v; o divides by their fp32 sum after."""
    b, hq, s, d = q.shape
    logits, mask = _logits(q, k, causal)
    if mask is not None:
        logits = logits.masked_fill(~mask, _NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    acc = torch.einsum('bhgqk,bhkd->bhgqd', p.to(v.dtype).float(), v.float())
    o = (acc / l).reshape(b, hq, s, d).to(q.dtype)
    return o, (m + torch.log(l)).reshape(b, hq, s, 1)


def _probs_and_dlogits(q, k, v, do, lse, delta, causal):
    """p = exp(s - lse), masked to 0, and ds = p (dO.V^T - delta) scale,
    both fp32 [B, Hkv, G, S, S], as the backward kernels recompute them."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    logits, mask = _logits(q, k, causal)
    p = torch.exp(logits - lse.reshape(b, hkv, g, s, 1))
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    dp = torch.einsum('bhgqd,bhkd->bhgqk',
                      do.reshape(b, hkv, g, s, d).float(), v.float())
    ds = (p * (dp - delta.reshape(b, hkv, g, s, 1))) * d ** -0.5
    return p, ds


def flash_bwd_dq_reference(q, k, v, do, lse, delta,
                           causal: bool = True) -> torch.Tensor:
    """Plain version of K2: dq = ds.K in q's dtype, ds cast to k's dtype
    before the product."""
    b, hq, s, d = q.shape
    _, ds = _probs_and_dlogits(q, k, v, do, lse, delta, causal)
    dq = torch.einsum('bhgqk,bhkd->bhgqd', ds.to(k.dtype).float(), k.float())
    return dq.reshape(b, hq, s, d).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: (dk, dv) fp32 [B, Hkv, S, D], summed over the
    GQA group; p cast to do's dtype for dv, ds to q's dtype for dk."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    p, ds = _probs_and_dlogits(q, k, v, do, lse, delta, causal)
    dog = do.reshape(b, hkv, g, s, d)
    qg = q.reshape(b, hkv, g, s, d)
    dv = torch.einsum('bhgqk,bhgqd->bhkd', p.to(do.dtype).float(),
                      dog.float())
    dk = torch.einsum('bhgqk,bhgqd->bhkd', ds.to(q.dtype).float(),
                      qg.float())
    return dk, dv


# -- the CUDA kernels ---------------------------------------------------------------


def _configure(lib) -> None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    shape = [i32, i32, i32, i32, i32, f32, ptr]  # b, hq, hkv, s, d, scale,
    lib.skytorch_flash_fwd.argtypes = [           # stream
        i32, i32, ptr, ptr, ptr, ptr, ptr, ptr] + shape  # o, lse, counter
    lib.skytorch_flash_bwd_dq.argtypes = [
        i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr] + shape  # dq, ctr
    lib.skytorch_flash_bwd_dkv.argtypes = [
        i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr] + shape
    lib.skytorch_flash_plan.argtypes = [i32] * 6 + [ptr]
    for fn in (lib.skytorch_flash_fwd, lib.skytorch_flash_bwd_dq,
               lib.skytorch_flash_bwd_dkv, lib.skytorch_flash_plan):
        fn.restype = i32


_LIBRARY = _build.Library('flash_attention.cu', _configure)
SOURCE = _LIBRARY.source


def build_library() -> str:
    """Compile ``csrc/flash_attention.cu`` (unless built already) and
    load it; returns this call's compiler output ('' if built before)."""
    return _LIBRARY.build()


def compiler_report() -> str:
    """The compiler's register and spill report of the loaded library."""
    return _LIBRARY.report()


def sass() -> str:
    """The loaded library's SASS (``cuobjdump -sass``)."""
    return _LIBRARY.sass()


def plan(kernel: str, head_dim: int, batch: int, hq: int, hkv: int,
         seq: int) -> Tuple[int, ...]:
    """The library's own account of a bf16 launch of ``kernel`` ('fwd',
    'dq' or 'dkv') on the current card: (blocks, SMs, query rows a tile,
    keys a tile, ring stages, shared memory bytes, units of a section of
    the work list: (batch, head)s for K1 and K2, (batch, kv head)s for
    K3).
    ``flash_schedule.plan`` mirrors it."""
    if kernel not in flash_schedule.KERNELS:
        raise ValueError(f'flash_plan: kernel {kernel!r} is not one of '
                         f'{flash_schedule.KERNELS}')
    out = (ctypes.c_int * 7)()
    rc = _LIBRARY.get().skytorch_flash_plan(
        flash_schedule.KERNELS.index(kernel), head_dim, batch, hq, hkv, seq,
        out)
    _LIBRARY.check(rc, 'flash_plan')
    return tuple(out)


def _check(q, k, v, *rows) -> None:
    """What the kernels take: q [B, Hq, S, D], k/v [B, Hkv, S, D] of one
    dtype (fp32 or bf16), D in HEAD_DIMS, Hkv dividing Hq; every tensor
    on q's device, contiguous, 16-byte aligned. ``rows`` are further
    [B, Hq, S, ...] tensors (dO in q's dtype, fp32 lse and delta)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError('flash_attention: q must be [B, Hq, S, D] and '
                         'k/v [B, Hkv, S, D]')
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f'flash_attention: dtype {q.dtype} not supported '
                         '(float32 or bfloat16)')
    if d not in HEAD_DIMS:
        raise ValueError(f'flash_attention: head_dim {d} not supported '
                         f'(one of {HEAD_DIMS})')
    if hkv < 1 or hq % hkv:
        raise ValueError(f'flash_attention: {hq} query heads over {hkv} kv '
                         'heads (the group must divide)')
    if s < 1 or b > 65535 or hq > 65535:
        raise ValueError(f'flash_attention: shape {tuple(q.shape)} out of '
                         'range')
    for name, t in (('k', k), ('v', v)):
        if tuple(t.shape) != (b, hkv, s, d) or t.dtype != q.dtype:
            raise ValueError(f'flash_attention: {name} must be '
                             f'{(b, hkv, s, d)} {q.dtype}, got '
                             f'{tuple(t.shape)} {t.dtype}')
    for t in rows:
        if tuple(t.shape[:3]) != (b, hq, s):
            raise ValueError(f'flash_attention: a [B, Hq, S, ...] operand '
                             f'is {tuple(t.shape)}')
    for t in (q, k, v) + rows:
        if t.device != q.device:
            raise ValueError(f'flash_attention: operands on {t.device} and '
                             f'{q.device}')
        if not t.is_contiguous():
            raise ValueError('flash_attention: operands must be contiguous')
        if t.data_ptr() % 16:
            raise ValueError('flash_attention: operands must be 16-byte '
                             'aligned (the kernels read 16-byte vectors)')


def _on_cuda(q: torch.Tensor) -> bool:
    """False for CPU tensors (take the plain version); True for CUDA;
    raises for any other device."""
    if q.device.type == 'cpu':
        return False
    if q.device.type != 'cuda':
        raise ValueError(f'flash_attention: no kernel for device {q.device}')
    return True


_COUNTERS = {}  # (device, stream) -> K1's, K2's and K3's int32 counters


def _counter(device: torch.device, stream: int, kernel: str) -> int:
    """Address of ``kernel``'s work-tile counter for launches on this
    stream: zero, and left zero by every launch, so launches in stream
    order share it; another stream's launches may overlap them, so each
    stream has its own, and each kernel its own on it."""
    key = (device, stream)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(len(flash_schedule.KERNELS),
                                     dtype=torch.int32, device=device)
    return _COUNTERS[key][flash_schedule.KERNELS.index(kernel)].data_ptr()


def _shape_args(q, k, stream):
    b, hq, s, d = q.shape
    return [b, hq, k.shape[1], s, d, d ** -0.5, stream]


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: (o [B, Hq, S, D] in q's dtype, lse [B, Hq, S, 1] fp32)."""
    if not _on_cuda(q):
        return flash_fwd_reference(q, k, v, causal)
    _check(q, k, v)
    lib = _LIBRARY.get()
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3] + (1,), dtype=torch.float32,
                      device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.skytorch_flash_fwd(
        _DTYPE_CODES[q.dtype], int(causal), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        _counter(q.device, stream, 'fwd'),
        *_shape_args(q, k, stream))
    _LIBRARY.check(rc, 'flash_fwd')
    flash_attention.fwd_launches += 1
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True
                 ) -> torch.Tensor:
    """K2: dq [B, Hq, S, D] in q's dtype."""
    if not _on_cuda(q):
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    _check_bwd(q, k, v, do, lse, delta)
    lib = _LIBRARY.get()
    dq = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.skytorch_flash_bwd_dq(
        _DTYPE_CODES[q.dtype], int(causal), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), _counter(q.device, stream, 'dq'),
        *_shape_args(q, k, stream))
    _LIBRARY.check(rc, 'flash_bwd_dq')
    flash_attention.bwd_dq_launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (dk, dv) [B, Hkv, S, D] fp32."""
    if not _on_cuda(q):
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal)
    _check_bwd(q, k, v, do, lse, delta)
    lib = _LIBRARY.get()
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.skytorch_flash_bwd_dkv(
        _DTYPE_CODES[q.dtype], int(causal), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _counter(q.device, stream, 'dkv'),
        *_shape_args(q, k, stream))
    _LIBRARY.check(rc, 'flash_bwd_dkv')
    flash_attention.bwd_dkv_launches += 1
    return dk, dv


def _check_bwd(q, k, v, do, lse, delta) -> None:
    _check(q, k, v, do, lse, delta)
    if tuple(do.shape) != tuple(q.shape) or do.dtype != q.dtype:
        raise ValueError(f'flash_attention: dO must be {tuple(q.shape)} '
                         f'{q.dtype}')
    for name, t in (('lse', lse), ('delta', delta)):
        if tuple(t.shape) != tuple(q.shape[:3]) + (1,) \
                or t.dtype != torch.float32:
            raise ValueError(f'flash_attention: {name} must be '
                             f'{tuple(q.shape[:3]) + (1,)} float32')


# -- autograd -------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """Forward K1, saving (q, k, v, o, lse); backward K2 and K3. Keeps no
    state across calls, so a remat recompute may run the forward again."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk.to(k.dtype), dv.to(v.dtype), None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q [B, Hq, S, D]; k/v [B, Hkv, S, D] (GQA) -> o [B, Hq, S, D].

    Differentiable. On CUDA tensors the forward is K1 and the backward K2
    and K3, or it raises; on CPU tensors the same ``autograd.Function``
    runs the plain versions. ``flash_attention.fwd_launches``,
    ``.bwd_dq_launches`` and ``.bwd_dkv_launches`` count kernel
    launches."""
    return _FlashAttention.apply(q, k, v, causal)


flash_attention.fwd_launches = 0
flash_attention.bwd_dq_launches = 0
flash_attention.bwd_dkv_launches = 0
