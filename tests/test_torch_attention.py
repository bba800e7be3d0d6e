"""Parity of the port's flash attention (training path) with the JAX package.

The same numpy inputs go through the JAX Pallas kernels in interpret mode
on the CPU (block sizes shrunk to 128 as ``tests/test_ops_attention.py``
does, so S=384 spans several blocks) and through the port's plain
versions of K1 (forward), K2 (dQ) and K3 (dK/dV), which the port's
wrappers run on CPU tensors. The port's autograd op is held against
``jax.vjp`` of the JAX reference. float32; tolerances: o and lse 1e-4,
gradients 1e-3 (sums over S=384 taken in another order).

The CUDA kernels themselves run only on a card: ``chip_smoke.py`` holds
them against these plain versions at the training shapes there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops import attention as jax_attn
from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import attention as port_attn

FWD_TOL = 1e-4
GRAD_TOL = 1e-3


@pytest.fixture()
def small_blocks(monkeypatch):
    """Shrink the JAX kernels' blocks so S=384 spans several blocks."""
    for name in ('FWD_BLOCK_Q', 'FWD_BLOCK_K', 'DQ_BLOCK_Q', 'DQ_BLOCK_K',
                 'DKV_BLOCK'):
        monkeypatch.setattr(jax_attn, name, 128)


def _inputs(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    do = rng.standard_normal((b, hq, s, d), dtype=np.float32)
    return q, k, v, do


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('group', [1, 2])
def test_plain_kernels_match_jax_interpret_kernels(small_blocks, causal,
                                                   group):
    b, hkv, s, d = 2, 2, 384, 64
    q, k, v, do = _inputs(group + 2 * causal, b, hkv * group, hkv, s, d)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = jax_attn._flash_fwd(jq, jk, jv, causal, interpret=True)
    dq, dk, dv = jax_attn._flash_bwd(jq, jk, jv, o, lse, jdo, causal,
                                     interpret=True)

    t = torch.from_numpy
    po, plse = port_attn.flash_fwd(t(q), t(k), t(v), causal)
    _close(po, o, FWD_TOL)
    _close(plse, lse, FWD_TOL)
    # The backward kernels are fed the JAX forward's residuals, so each
    # is checked on its own inputs.
    jo, jlse = t(np.array(o)), t(np.array(lse))
    delta = (t(do) * jo).sum(-1, keepdim=True)
    pdq = port_attn.flash_bwd_dq(t(q), t(k), t(v), t(do), jlse, delta,
                                 causal)
    pdk, pdv = port_attn.flash_bwd_dkv(t(q), t(k), t(v), t(do), jlse, delta,
                                       causal)
    assert pdk.dtype == pdv.dtype == torch.float32
    for got, want in ((pdq, dq), (pdk, dk), (pdv, dv)):
        _close(got, want, GRAD_TOL)


@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('shape', [(2, 4, 2, 384, 64), (1, 8, 2, 100, 64),
                                   (1, 2, 2, 1, 128), (2, 4, 4, 33, 16)])
def test_autograd_matches_jax_vjp_of_reference(causal, shape):
    """Forward and dq/dk/dv of ``flash_attention`` (the autograd op whose
    backward is K2 and K3) against ``jax.vjp`` of ``attention_reference``,
    including ragged S (100, 33, 1) that the JAX kernels would not take."""
    b, hq, hkv, s, d = shape
    q, k, v, do = _inputs(s + causal, b, hq, hkv, s, d)
    o, vjp = jax.vjp(lambda a, b_, c: jax_attn.attention_reference(
        a, b_, c, causal), *map(jnp.asarray, (q, k, v)))
    grads = vjp(jnp.asarray(do))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = port_attn.flash_attention(tq, tk, tv, causal=causal)
    out.backward(torch.from_numpy(do))
    _close(out.detach(), o, FWD_TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads):
        _close(got, want, GRAD_TOL)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_attention_reference_matches_jax(dtype):
    """The port's plain attention, line for line the JAX one, in both
    types (bf16: the same casts, so equal up to the sums' order, 2e-2)."""
    q, k, v, _ = _inputs(7, 1, 4, 2, 40, 16)
    jdt = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
    tdt = torch.bfloat16 if dtype == 'bfloat16' else torch.float32
    want = jax_attn.attention_reference(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)), causal=True)
    got = port_attn.attention_reference(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), causal=True)
    assert got.dtype == tdt
    tol = 2e-2 if dtype == 'bfloat16' else 1e-5
    _close(got.float(), np.asarray(want.astype(jnp.float32)), tol)


def test_lse_is_logsumexp_of_scaled_logits():
    q, k, v, _ = _inputs(9, 1, 2, 2, 96, 64)
    _, lse = port_attn.flash_fwd(*map(torch.from_numpy, (q, k, v)),
                                 causal=False)
    logits = np.einsum('bhqd,bhkd->bhqk', q, k) * 64 ** -0.5
    want = jax.scipy.special.logsumexp(logits, axis=-1)[..., None]
    _close(lse, want, FWD_TOL)


def test_cpu_wrappers_run_plain_versions_and_count_no_launch():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(3, 1, 4, 2, 70, 64))
    fa = port_attn.flash_attention
    before = (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
    o, lse = port_attn.flash_fwd(q, k, v)
    ro, rlse = port_attn.flash_fwd_reference(q, k, v)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    tq = q.clone().requires_grad_()
    port_attn.flash_attention(tq, k, v).backward(do)
    assert (fa.fwd_launches, fa.bwd_dq_launches,
            fa.bwd_dkv_launches) == before


def test_wrappers_refuse_a_device_without_kernel():
    q = torch.zeros((1, 2, 8, 64), device='meta')
    kv = torch.zeros((1, 1, 8, 64), device='meta')
    with pytest.raises(ValueError, match='no kernel'):
        port_attn.flash_fwd(q, kv, kv)
    with pytest.raises(ValueError, match='no kernel'):
        port_attn.flash_attention(q, kv, kv)


def _args(b=1, hq=16, hkv=8, s=130, d=128, dtype=torch.bfloat16):
    q = torch.zeros((b, hq, s, d), dtype=dtype)
    kv = torch.zeros((b, hkv, s, d), dtype=dtype)
    return q, kv, kv.clone()


@pytest.mark.parametrize('bad, match', [
    (dict(d=16), 'head_dim 16'),
    (dict(d=96), 'head_dim 96'),
    (dict(hq=12, hkv=8), 'group'),
    (dict(dtype=torch.float16), 'dtype'),
])
def test_kernel_checks_refuse_what_they_do_not_take(bad, match):
    with pytest.raises(ValueError, match=match):
        port_attn._check(*_args(**bad))  # noqa: SLF001


def test_kernel_checks_shapes_dtypes_and_layout():
    port_attn._check(*_args())  # noqa: SLF001 -- the training shape
    port_attn._check(*_args(d=64, hq=32, s=1))  # noqa: SLF001
    q, k, v = _args()
    with pytest.raises(ValueError, match='k must be'):
        port_attn._check(q, k.float(), v)  # noqa: SLF001
    with pytest.raises(ValueError, match='contiguous'):
        port_attn._check(q.transpose(1, 2).contiguous().transpose(1, 2),  # noqa: SLF001
                         k, v)
    lse = torch.zeros(q.shape[:3] + (1,))
    with pytest.raises(ValueError, match='dO must be'):
        port_attn._check_bwd(q, k, v, q.float(), lse, lse)  # noqa: SLF001
    with pytest.raises(ValueError, match='lse must be'):
        port_attn._check_bwd(q, k, v, q, lse.double(), lse)  # noqa: SLF001


def test_build_without_nvcc_raises_and_leaves_no_library(monkeypatch,
                                                           tmp_path):
    """The shared build helper finds nvcc on PATH or under CUDA_HOME; with
    neither it raises instead of loading anything."""
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.delenv('CUDA_PATH', raising=False)
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'build')
    lib = _build.Library('flash_attention.cu', lambda _: None)
    assert lib.source.exists()
    with pytest.raises(RuntimeError, match='nvcc not found'):
        lib.build()
    assert not (tmp_path / 'build').exists()


def test_build_tag_covers_the_headers_a_source_includes(tmp_path):
    """The built library's key hashes the source and every local header it
    includes, transitively, so a header edit rebuilds; system headers and
    headers it does not include do not enter it."""
    src = tmp_path / 'k.cu'
    src.write_text('#include <cuda.h>\n#include "a.cuh"\nint x;\n')
    (tmp_path / 'a.cuh').write_text('#pragma once\n  #include "b.cuh"\n')
    (tmp_path / 'b.cuh').write_text('int y;\n')
    (tmp_path / 'unused.cuh').write_text('int z;\n')
    tag = _build.source_tag(src)
    assert tag == _build.source_tag(src)
    (tmp_path / 'unused.cuh').write_text('int z = 1;\n')
    assert _build.source_tag(src) == tag
    (tmp_path / 'b.cuh').write_text('int y = 1;\n')
    changed = _build.source_tag(src)
    assert changed != tag
    (tmp_path / 'a.cuh').write_text('#pragma once\n')
    assert _build.source_tag(src) not in (tag, changed)


def test_flash_library_key_covers_its_wgmma_header():
    names = [p.name for p in _build._local_sources(port_attn.SOURCE)]  # noqa: SLF001
    assert names == ['flash_attention.cu', 'flash_attention_sm90.cuh']
