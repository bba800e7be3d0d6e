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
* ``flash_decode_split_reference`` is the plain version of the kernel's
  own order of work: partials per chunk of the cache (the probabilities
  relative to the chunk's max, rounded as the kernel rounds them), then
  the log-sum-exp merge. ``chip_smoke.py`` holds the fp32 kernel to it at
  the kernel's own chunk size.
* ``decode_split`` picks that chunk size from (B, Hkv, M) alone.
* ``cached_attention_reference`` is that einsum path for any S (prefill
  runs it on every device; the JAX package has no kernel there either).

The kernel is bound by memory: it reads each row's K and V up to its
length once. A row walked by one block is a latency chain, so the cache
axis is split across blocks (enough chunks that B=1 fills the card) and a
second small kernel merges the chunks; a call is those two launches.

Empty rows (``lengths[b] == 0``) follow the plain version: every cache
position is masked to the same -1e30 logit, so the softmax is uniform and
the output is the mean of V over all M positions. The kernel does the
same rather than raising, so no launch needs the lengths on the host.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from skypilot_tpu_torch.ops import _build

_NEG_INF = -1e30
HEAD_DIMS = (64, 128)  # the head widths the presets use
MAX_GROUP = 8          # query heads per kv head the kernel holds

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 32              # cache positions per ring stage of a block (kTile)
_TARGET_BLOCKS = 1024  # blocks a call aims for: ~8 per SM of an H100's 132
_CHUNK_TILES = (4, 8)  # tiles a block walks, at least and at most


@functools.lru_cache(maxsize=256)
def decode_split(batch: int, hkv: int, max_len: int) -> Tuple[int, int]:
    """(splits, chunk): the kernel's blocks per (row, kv head) and the
    cache positions each one walks, a multiple of ``TILE``. Cached per
    shape: a decode step calls it once per layer with the same shape.

    Chosen from the shape alone, never from the lengths, so that no
    launch reads them back: enough chunks that ``batch * hkv * splits``
    approaches ``_TARGET_BLOCKS`` (a small batch still fills the card),
    each chunk 4 to 8 tiles long (shorter chunks cost more in each block's
    fixed work and in the merge than they gain in blocks: on an H100 80GB
    HBM3 at 700 W, B=1 M=1024 ran slower at 2 tiles than at 4)."""
    tiles = -(-max_len // TILE)
    per_row = -(-_TARGET_BLOCKS // (batch * hkv))
    chunk_tiles = min(max(-(-tiles // per_row), _CHUNK_TILES[0]),
                      _CHUNK_TILES[1])
    chunk = chunk_tiles * TILE
    return -(-max_len // chunk), chunk


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


def flash_decode_split_reference(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor, lengths: torch.Tensor,
                                 k_s: Optional[torch.Tensor] = None,
                                 v_s: Optional[torch.Tensor] = None, *,
                                 chunk: int) -> torch.Tensor:
    """Plain version of the kernel's order of work: the cache axis in
    chunks of ``chunk`` positions (the kernel's is ``decode_split``'s), one
    partial per chunk (its max m, l = sum exp(s - m), and acc = P.V with
    p = exp(s - m) times the value scale, rounded to q's dtype), then the
    merge with weights w = exp(m - max m): sum w acc / max(sum w l,
    1e-30). Positions at or past a row's length are absent (-inf, weight
    0), and so is a chunk that holds none of a row's positions; an empty
    row counts all M positions at the masked logit -1e30 (the mean of
    V). Same arguments and result as ``flash_decode_reference``."""
    b, hq, d = q.shape
    hkv, m = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    qg = q.reshape(b, hkv, group, d).float()
    logits = torch.einsum('bhgd,bhkd->bhgk', qg,
                          k_cache.to(q.dtype).float()) * d ** -0.5
    if k_s is not None:
        logits = logits * k_s[:, :, None, :]
    lens = lengths.long()
    empty = (lens <= 0).view(b, 1, 1, 1)
    span = torch.where(lens <= 0, m, lens.clamp(max=m)).view(b, 1, 1, 1)
    ki = torch.arange(m, device=q.device).view(1, 1, 1, m)
    logits = torch.where(ki < span,
                         torch.where(empty, torch.full_like(logits, _NEG_INF),
                                     logits),
                         torch.full_like(logits, float('-inf')))
    n = -(-m // chunk)
    pad = n * chunk - m
    logits = torch.nn.functional.pad(logits, (0, pad), value=float('-inf'))
    logits = logits.view(b, hkv, group, n, chunk)
    mc = logits.amax(dim=-1, keepdim=True)  # -inf: an absent chunk
    p = torch.exp(logits - torch.where(torch.isinf(mc),
                                       torch.zeros_like(mc), mc))
    l = p.sum(dim=-1)
    if v_s is not None:
        p = p * torch.nn.functional.pad(v_s, (0, pad)).view(
            b, hkv, 1, n, chunk)
    v = torch.nn.functional.pad(v_cache.to(q.dtype).float(), (0, 0, 0, pad))
    acc = torch.einsum('bhgnc,bhncd->bhgnd', p.to(q.dtype).float(),
                       v.view(b, hkv, n, chunk, d))
    mc = mc[..., 0]
    w = torch.exp(mc - mc.amax(dim=-1, keepdim=True))
    out = (w[..., None] * acc).sum(dim=3) / torch.clamp_min(
        (w * l).sum(dim=-1), 1e-30)[..., None]
    return out.reshape(b, hq, d).to(q.dtype)


# -- the CUDA kernel ----------------------------------------------------------


def _configure(lib) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.skytorch_flash_decode.argtypes = [
        i32, i32,                      # dtype code, quantized
        ptr, ptr, ptr, ptr, ptr,       # q, k, v, k_s, v_s
        ptr, ptr, ptr,                 # lengths, out, partials
        i32, i32, i32, i32, i32, i32,  # batch, hkv, group, max_len, d, chunk
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
    counts the calls that launched the kernel: each is two launches, the
    split kernel and the merge of its partials."""
    if q.device.type == 'cpu':
        return flash_decode_reference(q, k_cache, v_cache, lengths, k_s, v_s)
    if q.device.type != 'cuda':
        raise ValueError(f'flash_decode: no kernel for device {q.device}')
    _check(q, k_cache, v_cache, lengths, k_s, v_s)
    lib = _LIBRARY.get()
    b, hq, d = q.shape
    hkv, m = k_cache.shape[1], k_cache.shape[2]
    splits, chunk = decode_split(b, hkv, m)
    out = torch.empty_like(q)
    part = torch.empty(b * hq * splits * (d + 2), dtype=torch.float32,
                       device=q.device)
    quant = k_s is not None
    # The current stream's raw handle, without building a torch.cuda.Stream
    # (which takes several microseconds of host time; a decode step calls
    # this once per layer and is bound by the host).
    stream = torch._C._cuda_getCurrentRawStream(q.get_device())  # noqa: SLF001
    rc = lib.skytorch_flash_decode(
        _DTYPE_CODES[q.dtype], int(quant),
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_s.data_ptr() if quant else None,
        v_s.data_ptr() if quant else None,
        lengths.data_ptr(), out.data_ptr(), part.data_ptr(),
        b, hkv, hq // hkv, m, d, chunk, d ** -0.5, stream)
    _LIBRARY.check(rc, 'flash_decode')
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
