"""How the bf16 flash-attention bodies cut their work (``ops/flash_schedule``).

K1 (the forward) is persistent: at most one block per SM, each taking
(batch, head, query tile) work tiles in list order from a counter. These
tests hold the Python mirror of that list to what the kernel needs:
every work tile listed exactly once; heads in L2-sized sections, and
longest causal sweep first inside each; no more blocks than SMs; every
body's shared memory within what a block may take. ``chip_smoke.py``
holds the mirror to the library's own ``skytorch_flash_plan`` on the
card.
"""
import collections

import pytest

from skypilot_tpu_torch.ops import attention
from skypilot_tpu_torch.ops import flash_schedule as fs

# (B, Hq, Hkv, S): the training shapes (train-s4096, llama-finetune,
# lora-finetune, one train-multislice rank, train-moe), and lists where a
# persistent walk can fail (more work tiles than SMs, a ragged last tile,
# B*Hq no multiple of the SM count, fewer work tiles than SMs), and one of
# several L2 sections with a short last one.
SHAPES = [(2, 16, 8, 4096), (8, 32, 8, 2048), (16, 16, 8, 2048),
          (8, 16, 8, 2048), (2, 16, 8, 2048), (3, 12, 4, 1000),
          (5, 16, 8, 1537), (1, 16, 8, 1), (1, 16, 8, 129), (2, 4, 1, 65),
          (21, 16, 8, 4096)]
SMS = [132, 114, 7, 1]
HEAD_DIMS = [64, 128]


def _rows(head_dim):
    return fs.TILES[('fwd', head_dim)].rows


def _sweep(head_dim, seq, tile):
    return fs.fwd_key_tiles(head_dim, True, tile[2] * _rows(head_dim), seq)


@pytest.mark.parametrize('head_dim', HEAD_DIMS)
@pytest.mark.parametrize('batch,hq,hkv,seq', SHAPES)
def test_fwd_list_holds_every_work_tile_once(batch, hq, hkv, seq,
                                             head_dim):
    listed = fs.fwd_work_list(head_dim, batch, hq, hkv, seq)
    tiles = -(-seq // _rows(head_dim))
    seen = collections.Counter(listed)
    want = {(b, h, t) for b in range(batch) for h in range(hq)
            for t in range(tiles)}
    assert set(seen) == want
    assert max(seen.values()) == 1


@pytest.mark.parametrize('sms', SMS)
@pytest.mark.parametrize('head_dim', HEAD_DIMS)
@pytest.mark.parametrize('batch,hq,hkv,seq', SHAPES)
def test_fwd_grid_is_at_most_one_block_per_sm(batch, hq, hkv, seq,
                                              head_dim, sms):
    grid = fs.fwd_blocks(head_dim, batch, hq, seq, sms)
    assert 1 <= grid <= sms
    assert grid == min(sms, batch * hq * -(-seq // _rows(head_dim)))


@pytest.mark.parametrize('head_dim', HEAD_DIMS)
@pytest.mark.parametrize('batch,hq,hkv,seq', SHAPES)
def test_fwd_list_is_longest_sweep_first_by_l2_section(batch, hq, hkv, seq,
                                                        head_dim):
    group = hq // hkv
    heads = batch * hq
    sec = fs.fwd_section_heads(head_dim, seq, group, heads)
    # Whole kv heads whose K and V fit the L2 budget (one at the least),
    # or every head.
    assert sec == heads or sec % group == 0
    assert sec == group or sec // group * 4 * seq * head_dim <= (
        fs.L2_SECTION_BYTES)
    listed = fs.fwd_work_list(head_dim, batch, hq, hkv, seq)
    tiles = -(-seq // _rows(head_dim))
    sections = [listed[i:i + sec * tiles]
                for i in range(0, len(listed), sec * tiles)]
    assert len(sections) == -(-heads // sec)
    for k, part in enumerate(sections):
        assert {b * hq + h for b, h, _ in part} == set(
            range(k * sec, min((k + 1) * sec, heads)))
        lengths = [_sweep(head_dim, seq, t) for t in part]
        assert lengths == sorted(lengths, reverse=True)
        # A kv head's query heads lie next to each other.
        firsts = [b * hq + h for b, h, _ in part[:min(sec, heads - k * sec)]]
        assert firsts == sorted(firsts)


def test_fwd_sections_split_only_heads_past_the_l2_budget():
    # train-s4096 (16 kv heads of 2 MB) and llama-finetune (64 of 0.5 MB)
    # fit in one section; lora-finetune's 128 kv heads of 1 MB take four.
    assert fs.fwd_section_heads(128, 4096, 2, 32) == 32
    assert fs.fwd_section_heads(64, 2048, 4, 256) == 256
    assert fs.fwd_section_heads(128, 2048, 2, 256) == 64
    assert fs.fwd_section_heads(128, 1 << 20, 2, 256) == 2  # one kv head


@pytest.mark.parametrize('head_dim', [64, 128])
@pytest.mark.parametrize('kernel', fs.KERNELS)
def test_every_body_fits_a_blocks_shared_memory(kernel, head_dim):
    assert fs.smem_bytes(kernel, head_dim) <= fs.SMEM_PER_BLOCK
    t = fs.TILES[(kernel, head_dim)]
    assert t.rows % 64 == 0 and t.keys % 64 == 0 and t.stages >= 3


def test_smem_of_the_bodies_as_the_header_computes_it():
    # Q + 3 stages of K and V at D=128; 192 rows of Q, 4 stages at D=64.
    assert fs.smem_bytes('fwd', 128) == 1024 + 32768 + 6 * 32768 + 9 * 8
    assert fs.smem_bytes('fwd', 64) == 1024 + 24576 + 8 * 16384 + 11 * 8
    assert fs.smem_bytes('dkv', 128) == 1024 + 65536 + 3 * (32768 + 512) + 56
    assert fs.smem_bytes('dkv', 64) == 1024 + 32768 + 4 * (32768 + 1024) + 72
    assert fs.smem_bytes('dq', 128) == 1024 + 65536 + 4 * 32768 + 72


@pytest.mark.parametrize('head_dim', HEAD_DIMS)
def test_fwd_key_tiles_reach_the_diagonal_or_s(head_dim):
    keys, rows = fs.TILES[('fwd', head_dim)].keys, _rows(head_dim)
    for seq in (1, 65, 129, 1000, 1537, 2048):
        for q0 in range(0, seq, rows):
            n = fs.fwd_key_tiles(head_dim, True, q0, seq)
            last_row = min(q0 + rows, seq) - 1
            assert (n - 1) * keys <= last_row < n * keys
            assert fs.fwd_key_tiles(head_dim, False, q0, seq) == -(-seq
                                                                    // keys)


def test_plan_mirrors_the_library_tuple():
    assert fs.plan('fwd', 64, 3, 12, 4, 1000, 132) == (
        132, 132, 192, 128, 4, fs.smem_bytes('fwd', 64), 36)
    assert fs.plan('fwd', 128, 16, 16, 8, 2048, 132)[6] == 64
    assert fs.plan('fwd', 128, 1, 16, 8, 1, 132)[0] == 16
    assert fs.plan('dkv', 64, 3, 12, 4, 1000, 132)[:5] == (
        3 * 4 * 8, 132, 128, 128, 4)
    assert fs.plan('dq', 128, 5, 16, 8, 1537, 132)[:5] == (
        5 * 16 * 13, 132, 128, 64, 4)
    with pytest.raises(ValueError):
        attention.plan('nope', 64, 1, 1, 1, 1)
