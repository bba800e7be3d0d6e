"""Flash-decode: attention of one new token over the whole KV cache.

Port of ``skypilot_tpu/ops/decode_attention.py`` (the Pallas kernel
``_decode_kernel``, launched for a bf16 cache at ``:147`` and for an int8
cache at ``:162``). The kernel is CUDA C++ for Hopper in
``csrc/decode_attention.cu``, compiled with ``nvcc`` at first use into a
shared library with a plain C interface and loaded with ``ctypes``
(``ops/_build.py``).

* ``flash_decode`` is the wrapper: on CUDA tensors it launches the kernel
  (or raises); on CPU tensors, and only there, it computes the plain
  version. There is no size gate: the kernel takes any cache length.
* ``flash_decode_reference`` is the plain version: the einsum path of
  ``generate._cached_attention`` at S=1.
* ``cached_attention_reference`` is that einsum path for any S (prefill
  runs it on every device; the JAX package has no kernel there either).

Empty rows (``lengths[b] == 0``) follow the plain version: every cache
position is masked to the same -1e30 logit, so the softmax is uniform and
the output is the mean of V over all M positions. The kernel does the
same rather than raising, so no launch needs the lengths on the host.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from skypilot_tpu_torch.ops import _build

_NEG_INF = -1e30
HEAD_DIMS = (64, 128)  # the head widths the presets use
MAX_GROUP = 8          # query heads per kv head the kernel holds

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# -- plain version ------------------------------------------------------------


def cached_attention_reference(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor,
                               positions: torch.Tensor,
                               valid_len: torch.Tensor,
                               k_s: Optional[torch.Tensor] = None,
                               v_s: Optional[torch.Tensor] = None,
                               ) -> torch.Tensor:
    """q [B, S, Hq, D] at absolute ``positions`` [B, S]; k/v_cache
    [B, Hkv, M, D] already holding this block's keys; ``valid_len`` [B].
    Attends causally over each row's first ``valid_len[b]`` slots. Int8
    caches fold ``k_s``/``v_s`` [B, Hkv, M] in per position: key scales
    into the logits, value scales into the probabilities. Line for line
    the einsum path of the JAX ``_cached_attention``
    (``generate.py:174-198``): products of q's dtype summed in float32."""
    b, s, hq, d = q.shape
    hkv, max_len = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    qg = q.transpose(1, 2).reshape(b, hkv, group, s, d)
    scale = d ** -0.5
    logits = torch.einsum('bhgqd,bhkd->bhgqk', qg.float(),
                          k_cache.to(q.dtype).float()) * scale
    if k_s is not None:
        logits = logits * k_s[:, :, None, None, :]
    ki = torch.arange(max_len, device=q.device).view(1, 1, 1, 1, max_len)
    qi = positions[:, None, None, :, None]
    mask = (ki <= qi) & (ki < valid_len.view(b, 1, 1, 1, 1))
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    if v_s is not None:
        probs = probs * v_s[:, :, None, None, :]
    out = torch.einsum('bhgqk,bhkd->bhgqd', probs.to(q.dtype).float(),
                       v_cache.to(q.dtype).float())
    return out.reshape(b, hkv * group, s, d).transpose(1, 2).to(q.dtype)


def flash_decode_reference(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, lengths: torch.Tensor,
                           k_s: Optional[torch.Tensor] = None,
                           v_s: Optional[torch.Tensor] = None,
                           ) -> torch.Tensor:
    """Plain version of ``flash_decode``: q [B, Hq, D] is the token at
    position ``lengths[b] - 1``; returns [B, Hq, D]."""
    positions = (lengths.long() - 1)[:, None]
    return cached_attention_reference(q[:, None], k_cache, v_cache,
                                      positions, lengths, k_s, v_s)[:, 0]


# -- the CUDA kernel ----------------------------------------------------------


def _configure(lib) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.skytorch_flash_decode.argtypes = [
        i32, i32,                      # dtype code, quantized
        ptr, ptr, ptr, ptr, ptr,       # q, k, v, k_s, v_s
        ptr, ptr,                      # lengths, out
        i32, i32, i32, i32, i32,       # batch, hkv, group, max_len, d
        ctypes.c_float, ptr]           # scale, stream
    lib.skytorch_flash_decode.restype = i32


_LIBRARY = _build.Library('decode_attention.cu', _configure)
SOURCE = _LIBRARY.source


def build_library() -> str:
    """Compile ``csrc/decode_attention.cu`` (unless this source was built
    already) and load it. Returns the compiler's output of this call,
    which ``-Xptxas -v`` makes the registers and shared memory of each
    kernel; '' when the library was built before."""
    return _LIBRARY.build()


def _check(q, k_cache, v_cache, lengths, k_s, v_s) -> None:
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError('flash_decode: q must be [B, Hq, D] and the '
                         'caches [B, Hkv, M, D]')
    b, hq, d = q.shape
    hkv, m = k_cache.shape[1], k_cache.shape[2]
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f'flash_decode: q dtype {q.dtype} not supported '
                         '(float32 or bfloat16)')
    if d not in HEAD_DIMS:
        raise ValueError(f'flash_decode: head_dim {d} not supported '
                         f'(one of {HEAD_DIMS})')
    if hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f'flash_decode: {hq} query heads over {hkv} kv '
                         f'heads (the group must divide, <= {MAX_GROUP})')
    if m < 1:
        raise ValueError('flash_decode: empty cache')
    quant = k_s is not None
    if quant != (v_s is not None):
        raise ValueError('flash_decode: k_s and v_s go together')
    cache_dtype = torch.int8 if quant else q.dtype
    for name, t in (('k_cache', k_cache), ('v_cache', v_cache)):
        if tuple(t.shape) != (b, hkv, m, d) or t.dtype != cache_dtype:
            raise ValueError(f'flash_decode: {name} must be '
                             f'{(b, hkv, m, d)} {cache_dtype}, got '
                             f'{tuple(t.shape)} {t.dtype}')
    if quant:
        for name, t in (('k_s', k_s), ('v_s', v_s)):
            if tuple(t.shape) != (b, hkv, m) or t.dtype != torch.float32:
                raise ValueError(f'flash_decode: {name} must be '
                                 f'{(b, hkv, m)} float32')
    if tuple(lengths.shape) != (b,) or lengths.dtype != torch.int32:
        raise ValueError('flash_decode: lengths must be [B] int32')
    for name, t in (('q', q), ('k_cache', k_cache), ('v_cache', v_cache),
                    ('lengths', lengths), ('k_s', k_s), ('v_s', v_s)):
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f'flash_decode: {name} on {t.device}, q on '
                             f'{q.device}')
        if not t.is_contiguous():
            raise ValueError(f'flash_decode: {name} must be contiguous')
    for name, t in (('k_cache', k_cache), ('v_cache', v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f'flash_decode: {name} must be 16-byte '
                             'aligned (the kernel reads 16-byte vectors)')


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, lengths: torch.Tensor,
                 k_s: Optional[torch.Tensor] = None,
                 v_s: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, Hq, D] (the single decode position), k/v_cache
    [B, Hkv, M, D] (q's dtype, or int8 with ``k_s``/``v_s`` [B, Hkv, M]
    float32 scales), lengths [B] int32 -> out [B, Hq, D] in q's dtype,
    attending positions < lengths[b].

    CUDA tensors launch the kernel on the current stream, or raise; CPU
    tensors take ``flash_decode_reference``. ``flash_decode.launches``
    counts the kernel launches."""
    if q.device.type == 'cpu':
        return flash_decode_reference(q, k_cache, v_cache, lengths, k_s, v_s)
    if q.device.type != 'cuda':
        raise ValueError(f'flash_decode: no kernel for device {q.device}')
    _check(q, k_cache, v_cache, lengths, k_s, v_s)
    lib = _LIBRARY.get()
    b, hq, d = q.shape
    hkv, m = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    quant = k_s is not None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.skytorch_flash_decode(
        _DTYPE_CODES[q.dtype], int(quant),
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_s.data_ptr() if quant else None,
        v_s.data_ptr() if quant else None,
        lengths.data_ptr(), out.data_ptr(),
        b, hkv, hq // hkv, m, d, d ** -0.5, stream)
    _LIBRARY.check(rc, 'flash_decode')
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
