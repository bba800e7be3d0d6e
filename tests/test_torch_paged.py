"""Parity of the port's paged KV layout (``models/paged.py``) with the JAX
package's, on float32 TINY on the CPU.

The same pool, made with numpy from a seed (random codes in every block,
block tables over a shuffled pool), goes through JAX's function and the
port's: ``forward_paged`` at S=1, at S=k+1 with ``all_logits`` and as a
padded prefill with ``logit_index``, in full and int8 KV, with logits
held to 1e-5 and the pool after the call equal; the insert, the fork,
the export/import round trip and the shared-tail prefill likewise.
``BlockTrie`` is driven through seeded random sequences of operations
beside JAX's, and the chain digests are held byte for byte.
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import generate as jax_gen
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.models import paged as jax_paged
from skypilot_tpu.utils import prefix_affinity as jax_affinity
from skypilot_tpu_torch.models import generate as port_gen
from skypilot_tpu_torch.models import llama as port_llama
from skypilot_tpu_torch.models import paged as port_paged
from skypilot_tpu_torch.utils import prefix_affinity as port_affinity

LOGIT_TOL = 1e-5
POOL_TOL = 1e-5  # written K/V: float32 projections, summed in another order

JAX_CFG = dataclasses.replace(jax_llama.TINY, dtype=jnp.float32)
PORT_CFG = dataclasses.replace(port_llama.TINY, dtype=torch.float32)
# Slots, block, blocks per slot, pool blocks. The block equals TINY's
# head_dim (16): JAX's paged layer works at no other block (ROADMAP §3).
B, P, MB, NB = 3, 16, 4, 14


@pytest.fixture(scope='module')
def weights():
    jp = jax_llama.init_params(jax.random.PRNGKey(0), JAX_CFG)
    return jp, port_llama.params_from_numpy(
        jax.tree.map(np.asarray, jp), PORT_CFG, 'cpu')


def _pool_arrays(seed, quant, lengths, p=P):
    """numpy planes of a pool of ``p``-position blocks whose every block
    holds random KV, and block tables over a shuffled pool (block 0 never
    in a table's reserved head; entries past it are the junk sink)."""
    rng = np.random.default_rng(seed)
    cfg = JAX_CFG
    mb, nb = MB * P // p, (NB - 1) * P // p + 1
    shape = (cfg.n_layers, nb, cfg.n_kv_heads, p, cfg.head_dim)
    if quant:
        planes = {'k': rng.integers(-127, 128, shape).astype(np.int8),
                  'v': rng.integers(-127, 128, shape).astype(np.int8),
                  'k_s': rng.uniform(0.001, 0.02, shape[:-1]
                                     ).astype(np.float32),
                  'v_s': rng.uniform(0.001, 0.02, shape[:-1]
                                     ).astype(np.float32)}
    else:
        planes = {'k': rng.standard_normal(shape).astype(np.float32),
                  'v': rng.standard_normal(shape).astype(np.float32)}
    ids = rng.permutation(np.arange(1, nb))
    tables = np.zeros((B, mb), np.int32)
    for b, n in enumerate(lengths):
        need = min(-(-(n + p) // p), mb)
        tables[b, :need] = ids[:need]
        ids = ids[need:]
    return planes, tables, np.asarray(lengths, np.int32)


def _pools(planes, tables, lengths):
    """(JAX pool, port pool) holding the same arrays."""
    jpool = jax_paged.PagedKVCache(
        k=jnp.asarray(planes['k']), v=jnp.asarray(planes['v']),
        tables=jnp.asarray(tables), lengths=jnp.asarray(lengths),
        k_s=jnp.asarray(planes['k_s']) if 'k_s' in planes else None,
        v_s=jnp.asarray(planes['v_s']) if 'v_s' in planes else None)
    t = {n: torch.from_numpy(a.copy()) for n, a in planes.items()}
    ppool = port_paged.PagedKVCache(
        k=t['k'], v=t['v'], tables=torch.from_numpy(tables.copy()),
        lengths=torch.from_numpy(lengths.copy()), k_s=t.get('k_s'),
        v_s=t.get('v_s'))
    return jpool, ppool


def _assert_pools_equal(jpool, ppool, tol=POOL_TOL):
    names = ('k', 'v', 'tables', 'lengths') + (
        ('k_s', 'v_s') if ppool.quantized else ())
    for name in names:
        want = np.asarray(getattr(jpool, name))
        got = getattr(ppool, name).numpy()
        assert got.dtype == want.dtype, name
        if want.dtype == np.float32:
            np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(
        0, JAX_CFG.vocab_size, (b, s)).astype(np.int32)


# -- the digests of the share trie and the adverts --------------------------------


@pytest.mark.parametrize('tokens, block', [
    (list(range(40)), 16), ([7] * 33, 8), ([], 16),
    ([0, -1, 2 ** 40, 128255], 2)])
def test_chain_digest_and_hashes_byte_equal_jax(tokens, block):
    assert port_affinity.SUMMARY_VERSION == jax_affinity.SUMMARY_VERSION
    assert port_affinity.chain_digest(None, tokens) == \
        jax_affinity.chain_digest(None, tokens)
    parent = jax_affinity.chain_digest(None, [1, 2, 3])
    assert port_affinity.chain_digest(parent, tokens) == \
        jax_affinity.chain_digest(parent, tokens)
    for max_chains in (0, 1, 64):
        assert port_affinity.chain_hashes(tokens, block, max_chains) == \
            jax_affinity.chain_hashes(tokens, block, max_chains)


# -- the forward over the pool -------------------------------------------------------


@pytest.mark.parametrize('quant', [False, True], ids=['full', 'int8'])
def test_forward_paged_decode_step_matches_jax(weights, quant):
    """S=1 with one row not active: logits and the pool after the step
    equal JAX's, and the inactive row wrote only the junk sink."""
    jp, pp = weights
    planes, tables, lengths = _pool_arrays(1, quant, [5, 17, 24])
    jpool, ppool = _pools(planes, tables, lengths)
    toks = _tokens(2, B, 1)
    active = np.asarray([True, False, True])
    jl, jpool = jax_paged.forward_paged(jp, jnp.asarray(toks), jpool,
                                        JAX_CFG, jnp.asarray(active))
    pl, ppool = port_paged.forward_paged(pp, torch.from_numpy(toks), ppool,
                                         PORT_CFG, torch.from_numpy(active))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_TOL)
    _assert_pools_equal(jpool, ppool)
    assert ppool.lengths.tolist() == [6, 18, 25]


@pytest.mark.parametrize('quant', [False, True], ids=['full', 'int8'])
def test_forward_paged_window_all_logits_matches_jax(weights, quant):
    """S=k+1 (a verify window spanning a block edge) with
    ``all_logits``: [B, S, V] logits and the pool equal JAX's."""
    jp, pp = weights
    planes, tables, lengths = _pool_arrays(3, quant, [6, 13, 0])
    jpool, ppool = _pools(planes, tables, lengths)
    toks = _tokens(4, B, 4)
    jl, jpool = jax_paged.forward_paged(jp, jnp.asarray(toks), jpool,
                                        JAX_CFG, all_logits=True)
    pl, ppool = port_paged.forward_paged(pp, torch.from_numpy(toks), ppool,
                                         PORT_CFG, all_logits=True)
    assert tuple(pl.shape) == (B, 4, JAX_CFG.vocab_size)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_TOL)
    _assert_pools_equal(jpool, ppool)


@pytest.mark.parametrize('quant', [False, True], ids=['full', 'int8'])
def test_forward_paged_padded_prefill_logit_index_matches_jax(weights,
                                                              quant):
    jp, pp = weights
    planes, tables, lengths = _pool_arrays(5, quant, [0, 8, 3])
    jpool, ppool = _pools(planes, tables, lengths)
    toks = _tokens(6, B, 8)
    index = np.asarray([7, 2, 5], np.int32)
    jl, jpool = jax_paged.forward_paged(jp, jnp.asarray(toks), jpool,
                                        JAX_CFG,
                                        logit_index=jnp.asarray(index))
    pl, ppool = port_paged.forward_paged(pp, torch.from_numpy(toks), ppool,
                                         PORT_CFG,
                                         logit_index=torch.from_numpy(index))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_TOL)
    _assert_pools_equal(jpool, ppool)


@pytest.mark.parametrize('quant', [False, True], ids=['full', 'int8'])
def test_inactive_rows_write_only_the_junk_sink(weights, quant):
    """Every row not active points its table at live blocks of the others
    (a freed slot's stale table): after a decode step those blocks are
    untouched and only block 0 changed besides the active row's block."""
    _, pp = weights
    planes, tables, lengths = _pool_arrays(7, quant, [9, 9, 9])
    tables[1] = tables[0]
    tables[2] = tables[0]
    _, ppool = _pools(planes, tables, lengths)
    before = ppool.k.clone()
    active = torch.tensor([True, False, False])
    port_paged.forward_paged(pp, torch.from_numpy(_tokens(8, B, 1)), ppool,
                             PORT_CFG, active)
    changed = sorted(set((before != ppool.k).nonzero()[:, 1].tolist()))
    assert changed == [0, int(tables[0, 9 // P])]
    # The active row's own write is at its position only.
    blk, off = int(tables[0, 9 // P]), 9 % P
    diff = (before[:, blk] != ppool.k[:, blk]).nonzero()[:, 2]
    assert set(diff.tolist()) == {off}


def _relayout(planes, tables, p):
    """The same per-row cache content laid out in ``p``-position blocks:
    each row's positions copied, in order, into fresh blocks."""
    dense = {n: np.concatenate([a[:, tables[:, j]] for j in
                                range(tables.shape[1])], axis=3)
             for n, a in planes.items()}  # [L, B, H, MB*P, ...]
    m = dense['k'].shape[3]
    mb = m // p
    nb = B * mb + 1
    out = {n: np.zeros((a.shape[0], nb) + a.shape[2:3] + (p,) + a.shape[4:],
                       a.dtype) for n, a in dense.items()}
    new_tables = np.arange(1, nb, dtype=np.int32).reshape(B, mb)
    for n, a in dense.items():
        for b in range(B):
            for j in range(mb):
                out[n][:, new_tables[b, j]] = a[:, b, :, j * p:(j + 1) * p]
    return out, new_tables


@pytest.mark.parametrize('quant', [False, True], ids=['full', 'int8'])
def test_block_other_than_head_dim_reference_fault(weights, quant):
    """A reference fault, worked around in the port: JAX's ``_paged_layer``
    takes the block size from ``k_pool.shape[3]``, the head dim of its
    per-layer pool, so its gathered view cannot be shaped unless the
    block equals the head dim (llama3-1b: head_dim 64, block 16). JAX
    raises at block 8 on TINY (head_dim 16); the port's decode step at
    block 8 equals JAX's at block 16 over the same cache content."""
    jp, pp = weights
    planes, tables, lengths = _pool_arrays(15, quant, [5, 17, 30])
    toks = _tokens(16, B, 1)
    jpool, _ = _pools(planes, tables, lengths)
    jl, _ = jax_paged.forward_paged(jp, jnp.asarray(toks), jpool, JAX_CFG)
    small, small_tables = _relayout(planes, tables, 8)
    jsmall, psmall = _pools(small, small_tables, lengths)
    with pytest.raises(TypeError, match='reshape'):
        jax_paged.forward_paged(jp, jnp.asarray(toks), jsmall, JAX_CFG)
    pl, _ = port_paged.forward_paged(pp, torch.from_numpy(toks), psmall,
                                     PORT_CFG)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_TOL)


def test_gathered_view_is_contiguous_and_in_view_order():
    rng = np.random.default_rng(9)
    pool = torch.from_numpy(rng.standard_normal((NB, 2, P, 4)).astype(
        np.float32))
    tables = torch.from_numpy(rng.integers(0, NB, (B, MB)).astype(np.int32))
    got = port_paged._view(pool, tables)  # noqa: SLF001
    assert got.is_contiguous() and tuple(got.shape) == (B, 2, MB * P, 4)
    want = pool[tables.long()].transpose(1, 2).reshape(B, 2, MB * P, 4)
    assert torch.equal(got, want)
    scales = pool[..., 0].contiguous()
    got_s = port_paged._view(scales, tables)  # noqa: SLF001
    assert got_s.is_contiguous() and tuple(got_s.shape) == (B, 2, MB * P)


# -- the movers ------------------------------------------------------------------------


@pytest.mark.parametrize('quant', [False, True], ids=['full', 'int8'])
@pytest.mark.parametrize('width', [4, 32], ids=['w<block', 'w=2blocks'])
def test_insert_matches_jax(weights, quant, width):
    """A prefilled dense cache [L, N, H, W, D] scattered under new tables
    (the second row's table is all junk sink, as a single-token request's
    is) and installed at two slots: the pool equals JAX's."""
    planes, tables, lengths = _pool_arrays(10, quant, [4, 4, 4])
    jpool, ppool = _pools(planes, tables, lengths)
    cfg = JAX_CFG
    rng = np.random.default_rng(11)
    shape = (cfg.n_layers, 2, cfg.n_kv_heads, width, cfg.head_dim)
    if quant:
        dense = {'k': rng.integers(-127, 128, shape).astype(np.int8),
                 'v': rng.integers(-127, 128, shape).astype(np.int8),
                 'k_s': rng.uniform(0.01, 0.1, shape[:-1]).astype(np.float32),
                 'v_s': rng.uniform(0.01, 0.1, shape[:-1]).astype(np.float32)}
    else:
        dense = {'k': rng.standard_normal(shape).astype(np.float32),
                 'v': rng.standard_normal(shape).astype(np.float32)}
    dl = np.asarray([width - 1, 1], np.int32)
    new_tables = np.zeros((2, MB), np.int32)
    new_tables[0, :2] = [12, 13]
    slots = np.asarray([2, 0], np.int32)
    jcache = jax_gen.KVCache(**{n: jnp.asarray(a) for n, a in dense.items()},
                             lengths=jnp.asarray(dl))
    pcache = port_gen.KVCache(**{n: torch.from_numpy(a)
                                 for n, a in dense.items()},
                              lengths=torch.from_numpy(dl))
    jpool = jax_paged._insert_impl(jpool, jcache, jnp.asarray(new_tables),  # noqa: SLF001
                                   jnp.asarray(slots))
    port_paged._insert_impl(ppool, pcache, torch.from_numpy(new_tables),  # noqa: SLF001
                            torch.from_numpy(slots).long())
    _assert_pools_equal(jpool, ppool)


@pytest.mark.parametrize('quant', [False, True], ids=['full', 'int8'])
def test_fork_export_import_match_jax(quant):
    planes, tables, lengths = _pool_arrays(12, quant, [3, 10, 20])
    jpool, ppool = _pools(planes, tables, lengths)
    jpool = jax_paged._fork_block_impl(jpool, jnp.int32(5), jnp.int32(9))  # noqa: SLF001
    port_paged._fork_block_impl(ppool, 5, 9)  # noqa: SLF001
    _assert_pools_equal(jpool, ppool)
    blocks = np.asarray([9, 3, 0, 0], np.int32)  # pow2-padded, sink-filled
    jout = jax_paged._export_blocks_impl(jpool, jnp.asarray(blocks))  # noqa: SLF001
    pout = port_paged._export_blocks_impl(ppool, torch.from_numpy(blocks))  # noqa: SLF001
    for j, p in zip(jout, pout):
        assert (j is None) == (p is None) == (not quant and j is None)
        if p is not None:
            np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    # Import the exported blocks elsewhere (padding rows zeroed, as a
    # promote pads): both pools equal, the padding landed in block 0.
    dest = np.asarray([11, 2, 0, 0], np.int32)
    padded = [None if p is None else p.clone() for p in pout]
    for p in padded:
        if p is not None:
            p[:, 2:] = 0
    row = np.zeros((MB,), np.int32)
    row[:2] = [11, 2]
    jpool = jax_paged._import_blocks_impl(  # noqa: SLF001
        jpool, *[None if p is None else jnp.asarray(p.numpy())
                 for p in padded], jnp.asarray(dest), jnp.asarray(row),
        jnp.int32(1), jnp.int32(13))
    port_paged._import_blocks_impl(  # noqa: SLF001
        ppool, *padded, torch.from_numpy(dest), torch.from_numpy(row), 1, 13)
    _assert_pools_equal(jpool, ppool)
    assert torch.equal(ppool.k[:, 11], pout[0][:, 0])
    assert ppool.tables[1].tolist() == row.tolist()
    assert int(ppool.lengths[1]) == 13


@pytest.mark.parametrize('quant', [False, True], ids=['full', 'int8'])
def test_prefill_shared_and_gather_blocks_match_jax(weights, quant):
    """The shared-tail prefill of slot 1 over a table whose head is
    shared blocks: the tail's logits and the pool equal JAX's; the
    gathered dense row of those blocks equals JAX's too."""
    jp, pp = weights
    planes, tables, lengths = _pool_arrays(13, quant, [8, 0, 5])
    jpool, ppool = _pools(planes, tables, lengths)
    row = np.zeros((1, MB), np.int32)
    row[0, :3] = [tables[0, 0], 12, 13]  # shared head block, then owned
    toks = _tokens(14, 1, 16)
    start, slen = np.asarray([8], np.int32), np.asarray([11], np.int32)
    jl, jpool = jax_paged._prefill_shared_impl(  # noqa: SLF001
        JAX_CFG, jp, jpool, jnp.asarray(toks), jnp.asarray(row),
        jnp.int32(1), jnp.asarray(start), jnp.asarray(slen))
    pl = port_paged._prefill_shared_impl(  # noqa: SLF001
        PORT_CFG, pp, ppool, torch.from_numpy(toks), torch.from_numpy(row), 1,
        torch.from_numpy(start), torch.from_numpy(slen))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_TOL)
    _assert_pools_equal(jpool, ppool)
    assert int(ppool.lengths[1]) == 19
    p_len = np.asarray([19], np.int32)
    jrow = jax_paged._gather_blocks_impl(jpool, jnp.asarray(row[0]),  # noqa: SLF001
                                         jnp.asarray(p_len))
    prow = port_paged._gather_blocks_impl(ppool, torch.from_numpy(row[0]),  # noqa: SLF001
                                          torch.from_numpy(p_len))
    for name in ('k', 'v') + (('k_s', 'v_s') if quant else ()):
        got, want = getattr(prow, name), np.asarray(getattr(jrow, name))
        assert got.is_contiguous() and tuple(got.shape) == want.shape
        if want.dtype == np.float32:
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=POOL_TOL, err_msg=name)
        else:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


@pytest.mark.parametrize('block, max_len, match', [
    (12, 48, 'power of two'), (16, 72, 'multiple of the')])
def test_init_pool_gates_like_jax(block, max_len, match):
    with pytest.raises(ValueError, match=match):
        jax_paged.init_pool(JAX_CFG, 2, max_len, 8, block)
    with pytest.raises(ValueError, match=match):
        port_paged.init_pool(PORT_CFG, 2, max_len, 8, block)
    pool = port_paged.init_pool(PORT_CFG, 2, 64, 9, 16, quantize=True)
    want = jax_paged.init_pool(JAX_CFG, 2, 64, 9, 16, quantize=True)
    for name in ('k', 'v', 'tables', 'lengths', 'k_s', 'v_s'):
        assert tuple(getattr(pool, name).shape) == \
            getattr(want, name).shape, name
    assert (pool.block, pool.max_blocks) == (16, 4)


# -- the share trie ----------------------------------------------------------------------


def _trie_ops(seed, n_ops=300):
    """A seeded random sequence of trie operations on short token rows
    over a small vocabulary (so chains share heads and diverge)."""
    rng = random.Random(seed)
    ops = []
    for _ in range(n_ops):
        kind = rng.choice(['match', 'match', 'commit', 'commit', 'release',
                           'acquire', 'evict', 'touch', 'summary'])
        row = [rng.randrange(3) for _ in range(rng.randrange(1, 14))]
        ops.append((kind, row, rng.randrange(1, 4), rng.randrange(1 << 30)))
    return ops


def _drive(lib, ops):
    """Run ``ops`` on ``lib.BlockTrie(2)``; returns the log of every
    result, in terms that compare across the packages."""
    t = lib.BlockTrie(2)
    held = []  # nodes the sequence holds a reference on
    next_block = [1]
    log = []

    def name(node):
        return None if node is None else (node.block, node.key, node.chain)
    for kind, row, n, pick in ops:
        if kind == 'match':
            nodes, partial, plen = t.match(row)
            log.append(([name(x) for x in nodes], name(partial), plen))
        elif kind == 'commit':
            nodes, _, _ = t.match(row, limit=len(row))
            parent = nodes[-1] if nodes else None
            start = len(nodes) * 2
            key = tuple(row[start:start + 2])
            if len(key) == 2:
                node = t.commit(parent, key, next_block[0])
                next_block[0] += 1
                if node is not None:
                    held.append(node)
                log.append(name(node))
        elif kind == 'release' and held:
            node = held.pop(pick % len(held))
            log.append(t.release(node))
        elif kind == 'acquire' and held:
            node = held[pick % len(held)]
            t.acquire(node)
            held.append(node)
        elif kind == 'evict':
            log.append(sorted(t.evict(n)))
        elif kind == 'touch' and held:
            t.touch(held[pick % len(held)])
        elif kind == 'summary':
            log.append(t.summary(4))
        log.append((t.referenced, t.reclaimable, t.blocks_held))
    summ = t.summary(64)
    digests = [bytes.fromhex(e[0]) for e in summ['entries']] + [b'\0' * 8]
    log.append(summ)
    log.append(sorted(t.resolve_chains(digests).items()))
    return log


@pytest.mark.parametrize('seed', range(6))
def test_block_trie_matches_jax_on_random_sequences(seed):
    ops = _trie_ops(seed)
    assert _drive(port_paged, ops) == _drive(jax_paged, ops)


def test_trie_match_commit_refcounts():
    t = port_paged.BlockTrie(4)
    row = list(range(1, 14))  # 13 tokens -> 3 full blocks of 4
    assert t.match(row) == ([], None, 0)
    n1 = t.commit(None, tuple(row[0:4]), 10)
    n2 = t.commit(n1, tuple(row[4:8]), 11)
    nodes, partial, plen = t.match(row)
    assert [n.block for n in nodes] == [10, 11]
    assert partial is None and plen == 0
    # match is capped at len(row) - 1: an exactly covered prompt leaves
    # its last token to compute.
    nodes, _, _ = t.match(row[:9])
    assert len(nodes) == 2
    nodes, _, _ = t.match(row[:8])
    assert [n.block for n in nodes] == [10]
    assert t.referenced == 2 and t.reclaimable == 0
    assert t.release(n1) is None and t.release(n2) is None
    assert t.referenced == 0 and t.reclaimable == 2
    t.acquire(n1)
    assert t.referenced == 1 and t.reclaimable == 1


def test_trie_partial_match_names_fork_donor():
    t = port_paged.BlockTrie(4)
    committed = [1, 2, 3, 4, 5, 6, 7, 8]
    n1 = t.commit(None, tuple(committed[:4]), 10)
    t.commit(n1, tuple(committed[4:]), 11)
    nodes, partial, plen = t.match([1, 2, 3, 4, 5, 6, 99, 98, 97])
    assert [n.block for n in nodes] == [10]
    assert partial is not None and partial.block == 11 and plen == 2


def test_trie_eviction_cascades_and_detaches():
    t = port_paged.BlockTrie(2)
    a = t.commit(None, (1, 2), 10)
    b = t.commit(a, (3, 4), 11)
    c = t.commit(b, (5, 6), 12)
    t.release(a)
    t.release(c)  # b stays referenced
    assert t.reclaimable == 2
    freed = t.evict(1)  # pops a (LRU), cascades idle c, detaches b
    assert sorted(freed) == [10, 12]
    assert b.detached and t.match([1, 2, 3, 4, 5]) == ([], None, 0)
    assert t.release(b) == 11  # the detached survivor frees directly
    assert t.referenced == 0 and t.reclaimable == 0


def test_trie_duplicate_commit_dedups():
    t = port_paged.BlockTrie(2)
    n = t.commit(None, (1, 2), 10)
    assert t.commit(None, (1, 2), 20) is None  # caller keeps its copy
    assert t.child(None, (1, 2)) is n
