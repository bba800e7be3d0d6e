"""Parity of the port's decode attention with the JAX package.

The same numpy inputs go through the JAX flash-decode kernel (Pallas, in
interpret mode on the CPU), the JAX einsum path of ``_cached_attention``,
and the port's ``flash_decode_reference`` (the plain version the port's
wrapper runs on CPU tensors). Cases mirror ``tests/test_ops_attention.py``
(mixed lengths, int8 mode, several blocks). float32, tolerance 2e-5: the
sums are taken in another order, nothing else differs.

The kernel splits the cache axis across blocks and merges the chunks'
partials; ``flash_decode_split_reference`` is the plain version of that
order of work, held here to the JAX kernel over chunk sizes and lengths at
the chunk edges, and ``decode_split``, which picks the chunk from the
shape alone, is checked for what the kernel needs of it.

The CUDA kernel itself runs only on a card: ``chip_smoke.py`` holds it
against both plain versions at the serving shapes there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import generate as jax_gen
from skypilot_tpu.ops import decode_attention as jax_da
from skypilot_tpu_torch.models import generate as port_gen
from skypilot_tpu_torch.ops import decode_attention as port_da

TOL = 2e-5


def _inputs(seed, b, hq, hkv, m, d, quant):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    kf = rng.standard_normal((b, hkv, m, d), dtype=np.float32)
    vf = rng.standard_normal((b, hkv, m, d), dtype=np.float32)
    if not quant:
        return q, kf, vf, None, None
    # Quantized the way the cache write path does (per-position scales).
    k_s = np.maximum(np.abs(kf).max(-1) / 127.0, 1e-8).astype(np.float32)
    v_s = np.maximum(np.abs(vf).max(-1) / 127.0, 1e-8).astype(np.float32)
    k8 = np.clip(np.round(kf / k_s[..., None]), -127, 127).astype(np.int8)
    v8 = np.clip(np.round(vf / v_s[..., None]), -127, 127).astype(np.int8)
    return q, k8, v8, k_s, v_s


def _jax_einsum(q, k, v, lengths, k_s, v_s):
    lengths = jnp.asarray(lengths)
    out = jax_gen._cached_attention(  # noqa: SLF001 -- the oracle
        jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v),
        positions=(lengths - 1)[:, None], valid_len=lengths,
        k_s=None if k_s is None else jnp.asarray(k_s),
        v_s=None if v_s is None else jnp.asarray(v_s))
    return np.asarray(out[:, 0])


def _port(q, k, v, lengths, k_s, v_s):
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    out = port_da.flash_decode_reference(t(q), t(k), t(v), t(lengths),
                                         t(k_s), t(v_s))
    return out.numpy()


# (b, hq, hkv, m, d, lengths, quant, block_k): the three JAX kernel cases
# of tests/test_ops_attention.py, plus an empty row and a wider group.
CASES = {
    'mixed_lengths': (3, 4, 2, 96, 16, [5, 96, 41], False, None),
    'int8': (2, 4, 2, 64, 16, [33, 64], True, None),
    'multi_block': (2, 4, 2, 256, 16, [97, 256], False, 64),
    'multi_block_int8': (2, 4, 2, 256, 16, [1, 200], True, 64),
    'group4_d64': (2, 8, 2, 128, 64, [128, 70], False, 64),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_reference_matches_jax_kernel_and_einsum(name):
    b, hq, hkv, m, d, lens, quant, block_k = CASES[name]
    q, k, v, k_s, v_s = _inputs(len(name), b, hq, hkv, m, d, quant)
    lengths = np.asarray(lens, np.int32)
    got = _port(q, k, v, lengths, k_s, v_s)
    kernel = np.asarray(jax_da.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths),
        None if k_s is None else jnp.asarray(k_s),
        None if v_s is None else jnp.asarray(v_s),
        interpret=True, block_k=block_k))
    np.testing.assert_allclose(got, kernel, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, _jax_einsum(q, k, v, lengths, k_s, v_s),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize('quant', [False, True])
def test_empty_row_is_mean_of_values(quant):
    """lengths[b] == 0: every position gets the same masked logit, so the
    plain version (like the JAX one) returns the mean of V over all M.
    The CUDA kernel follows this convention rather than raising."""
    q, k, v, k_s, v_s = _inputs(3, 2, 4, 2, 32, 16, quant)
    lengths = np.asarray([0, 9], np.int32)
    got = _port(q, k, v, lengths, k_s, v_s)
    np.testing.assert_allclose(got, _jax_einsum(q, k, v, lengths, k_s, v_s),
                               atol=TOL, rtol=TOL)
    vals = v.astype(np.float32) * (1.0 if v_s is None else v_s[..., None])
    mean = vals[0].mean(axis=1)  # [Hkv, D]
    np.testing.assert_allclose(got[0], np.repeat(mean, 2, axis=0),
                               atol=TOL, rtol=TOL)


def test_cached_attention_prefill_matches_jax():
    """S > 1 (prefill) takes the einsum path on every device; check it
    with a causal block written at per-row offsets."""
    rng = np.random.default_rng(11)
    b, s, hq, hkv, m, d = 2, 5, 4, 2, 24, 16
    q = rng.standard_normal((b, s, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, m, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, m, d), dtype=np.float32)
    starts = np.asarray([0, 7], np.int32)
    positions = (starts[:, None] + np.arange(s, dtype=np.int32)).astype(
        np.int32)
    valid = (starts + np.asarray([5, 3], np.int32)).astype(np.int32)
    want = np.asarray(jax_gen._cached_attention(  # noqa: SLF001
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(positions), jnp.asarray(valid)))
    got = port_gen._cached_attention(  # noqa: SLF001
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(positions), torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_cpu_wrapper_runs_plain_version_and_counts_no_launch():
    q, k, v, k_s, v_s = _inputs(5, 2, 4, 2, 32, 16, True)
    lengths = torch.tensor([32, 3], dtype=torch.int32)
    before = port_da.flash_decode.launches
    t = torch.from_numpy
    got = port_da.flash_decode(t(q), t(k), t(v), lengths, t(k_s), t(v_s))
    want = port_da.flash_decode_reference(t(q), t(k), t(v), lengths,
                                          t(k_s), t(v_s))
    assert torch.equal(got, want)
    assert port_da.flash_decode.launches == before


def test_wrapper_refuses_a_device_without_kernel():
    q = torch.zeros((1, 2, 64), device='meta')
    kv = torch.zeros((1, 1, 8, 64), device='meta')
    with pytest.raises(ValueError, match='no kernel'):
        port_da.flash_decode(q, kv, kv,
                             torch.zeros((1,), dtype=torch.int32,
                                         device='meta'))


def _args(b=2, hq=16, hkv=8, m=64, d=128, dtype=torch.bfloat16, quant=False):
    q = torch.zeros((b, hq, d), dtype=dtype)
    cdt = torch.int8 if quant else dtype
    k = torch.zeros((b, hkv, m, d), dtype=cdt)
    v = torch.zeros((b, hkv, m, d), dtype=cdt)
    s = torch.zeros((b, hkv, m)) if quant else None
    return [q, k, v, torch.zeros((b,), dtype=torch.int32), s, s]


@pytest.mark.parametrize('bad, match', [
    (dict(d=16), 'head_dim 16'),
    (dict(d=96), 'head_dim 96'),
    (dict(hq=12, hkv=8), 'group'),
    (dict(hq=64, hkv=4), 'group'),
    (dict(dtype=torch.float16), 'dtype'),
])
def test_kernel_checks_refuse_what_it_does_not_take(bad, match):
    with pytest.raises(ValueError, match=match):
        port_da._check(*_args(**bad))  # noqa: SLF001


def test_kernel_checks_shapes_dtypes_and_layout():
    port_da._check(*_args())  # noqa: SLF001 -- the serving shape passes
    port_da._check(*_args(d=64, hq=32, quant=True))  # noqa: SLF001
    args = _args(quant=True)
    args[5] = None
    with pytest.raises(ValueError, match='together'):
        port_da._check(*args)  # noqa: SLF001
    args = _args()
    args[1] = args[1].to(torch.float32)
    with pytest.raises(ValueError, match='k_cache'):
        port_da._check(*args)  # noqa: SLF001
    args = _args()
    args[3] = args[3].long()
    with pytest.raises(ValueError, match='lengths'):
        port_da._check(*args)  # noqa: SLF001
    args = _args()
    args[2] = args[2].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match='contiguous'):
        port_da._check(*args)  # noqa: SLF001



# -- the split of the cache axis ----------------------------------------------

SPLIT_M = 256


@pytest.mark.parametrize('quant', [False, True], ids=['cache', 'int8'])
@pytest.mark.parametrize('chunk', [1, 32, 64, 128, SPLIT_M])
def test_split_reference_matches_jax_kernel(chunk, quant):
    """Partials per chunk, then the log-sum-exp merge, in float32 against
    the JAX kernel in interpret mode and the einsum path: lengths 0 (the
    mean of V over all M), 1, a chunk and one either side, and M.
    Tolerance 2e-5, as above: only the order of sums differs."""
    q, k, v, k_s, v_s = _inputs(chunk + quant, 6, 4, 2, SPLIT_M, 16, quant)
    lengths = np.asarray([0, 1, max(chunk - 1, 0), chunk, chunk + 1,
                          SPLIT_M], np.int32)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got = port_da.flash_decode_split_reference(
        t(q), t(k), t(v), t(lengths), t(k_s), t(v_s), chunk=chunk).numpy()
    kernel = np.asarray(jax_da.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths),
        None if k_s is None else jnp.asarray(k_s),
        None if v_s is None else jnp.asarray(v_s), interpret=True))
    np.testing.assert_allclose(got, kernel, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, _jax_einsum(q, k, v, lengths, k_s, v_s),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize('quant', [False, True], ids=['cache', 'int8'])
def test_split_reference_in_bf16_stays_near_the_plain_version(quant):
    """In bf16 the split version rounds p relative to each chunk's max
    instead of the row's, as the kernel does; it stays within the bf16
    tolerance the kernel is held to (2e-2) of the plain version."""
    q, k, v, k_s, v_s = _inputs(9, 5, 8, 4, SPLIT_M, 64, quant)
    lengths = torch.tensor([0, 1, 65, 200, SPLIT_M], dtype=torch.int32)
    q = torch.from_numpy(q).bfloat16()
    if quant:
        k, v = torch.from_numpy(k), torch.from_numpy(v)
        k_s, v_s = torch.from_numpy(k_s), torch.from_numpy(v_s)
    else:
        k, v = torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16()
    got = port_da.flash_decode_split_reference(q, k, v, lengths, k_s, v_s,
                                               chunk=64)
    want = port_da.flash_decode_reference(q, k, v, lengths, k_s, v_s)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_decode_split_fills_the_card_at_batch_one():
    splits, chunk = port_da.decode_split(1, 8, 1024)
    assert 8 * splits >= 64
    assert chunk * splits >= 1024


@pytest.mark.parametrize('batch, hkv, max_len', [
    (1, 8, 1024), (32, 8, 1024), (4, 8, 1000), (8, 8, 1024), (3, 8, 48),
    (1, 8, 1), (1, 1, 32768), (256, 8, 1024), (2, 8, 257), (64, 2, 4096)])
def test_decode_split_chunks_are_whole_tiles_covering_the_cache(
        batch, hkv, max_len):
    """From (B, Hkv, M) alone, never the lengths, which no launch may read
    back: whole tiles, and just enough chunks to cover M."""
    splits, chunk = port_da.decode_split(batch, hkv, max_len)
    assert chunk >= port_da.TILE and chunk % port_da.TILE == 0
    assert (splits - 1) * chunk < max_len <= splits * chunk
