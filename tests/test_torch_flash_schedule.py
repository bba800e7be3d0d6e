"""How the bf16 flash-attention bodies cut their work (``ops/flash_schedule``).

K1 (the forward), K2 (dQ) and K3 (dK, dV) are persistent: at most one
block per SM, each taking work tiles in list order from a counter (K1,
K2: the query rows of a tile of one (batch, head); K3: the keys of a
tile of one (batch, kv head)). These tests hold the Python mirror of
those lists to what the kernels need: every work tile listed exactly
once; units in L2-sized sections, and longest causal sweep first inside
each; no GQA group split; no more blocks than SMs; every body's shared
memory within what a block may take. ``chip_smoke.py`` holds the mirror
to the library's own ``skytorch_flash_plan`` on the card.
"""
import collections

import pytest

from skypilot_tpu_torch.ops import attention
from skypilot_tpu_torch.ops import flash_schedule as fs

# (B, Hq, Hkv, S): the training shapes (train-s4096, llama-finetune,
# lora-finetune, one train-multislice rank, train-moe), and lists where a
# persistent walk can fail (more work tiles than SMs, a ragged last tile,
# B*Hq no multiple of the SM count, fewer work tiles than SMs), and ones
# of several L2 sections with a short last one (K1 and K2; K3 with GQA
# group 4 at D=128).
SHAPES = [(2, 16, 8, 4096), (8, 32, 8, 2048), (16, 16, 8, 2048),
          (8, 16, 8, 2048), (2, 16, 8, 2048), (3, 12, 4, 1000),
          (5, 16, 8, 1537), (1, 16, 8, 1), (1, 16, 8, 129), (2, 4, 1, 65),
          (21, 16, 8, 4096), (3, 32, 8, 3000)]
SMS = [132, 114, 7, 1]
HEAD_DIMS = [64, 128]


def _sweep(kernel, head_dim, seq, tile):
    return fs.streamed_tiles(kernel, head_dim, True, tile[2], seq)


@pytest.mark.parametrize('kernel', fs.KERNELS)
@pytest.mark.parametrize('head_dim', HEAD_DIMS)
@pytest.mark.parametrize('batch,hq,hkv,seq', SHAPES)
def test_fwd_list_holds_every_work_tile_once(batch, hq, hkv, seq,
                                             head_dim, kernel):
    listed = fs.work_list(kernel, head_dim, batch, hq, hkv, seq)
    tiles = fs.tiles_per_unit(kernel, head_dim, seq)
    per_batch = hkv if kernel == 'dkv' else hq
    seen = collections.Counter(listed)
    want = {(b, h, t) for b in range(batch) for h in range(per_batch)
            for t in range(tiles)}
    assert set(seen) == want
    assert max(seen.values()) == 1


@pytest.mark.parametrize('kernel', fs.KERNELS)
@pytest.mark.parametrize('sms', SMS)
@pytest.mark.parametrize('head_dim', HEAD_DIMS)
@pytest.mark.parametrize('batch,hq,hkv,seq', SHAPES)
def test_fwd_grid_is_at_most_one_block_per_sm(batch, hq, hkv, seq,
                                              head_dim, sms, kernel):
    grid = fs.blocks(kernel, head_dim, batch, hq, hkv, seq, sms)
    assert 1 <= grid <= sms
    assert grid == min(sms, len(fs.work_list(kernel, head_dim, batch, hq,
                                             hkv, seq)))


@pytest.mark.parametrize('kernel', fs.KERNELS)
@pytest.mark.parametrize('head_dim', HEAD_DIMS)
@pytest.mark.parametrize('batch,hq,hkv,seq', SHAPES)
def test_fwd_list_is_longest_sweep_first_by_l2_section(batch, hq, hkv, seq,
                                                        head_dim, kernel):
    group = hq // hkv
    units = fs.units(kernel, batch, hq, hkv)
    per_batch = hkv if kernel == 'dkv' else hq
    sec = fs.section_units(kernel, head_dim, batch, hq, hkv, seq)
    # The bytes a section streams (K1, K2: K and V of its kv heads; K3: Q
    # and dO of its kv heads' groups) fit the L2 budget, or it is one kv
    # head's.
    if kernel == 'dkv':
        assert sec == 1 or sec * 4 * seq * head_dim * group <= (
            fs.L2_SECTION_BYTES)
    else:
        assert sec == units or sec % group == 0
        assert sec == group or sec // group * 4 * seq * head_dim <= (
            fs.L2_SECTION_BYTES)
    listed = fs.work_list(kernel, head_dim, batch, hq, hkv, seq)
    tiles = fs.tiles_per_unit(kernel, head_dim, seq)
    sections = [listed[i:i + sec * tiles]
                for i in range(0, len(listed), sec * tiles)]
    assert len(sections) == -(-units // sec)
    for k, part in enumerate(sections):
        assert {b * per_batch + h for b, h, _ in part} == set(
            range(k * sec, min((k + 1) * sec, units)))
        lengths = [_sweep(kernel, head_dim, seq, t) for t in part]
        assert lengths == sorted(lengths, reverse=True)
        # A kv head's query heads lie next to each other.
        firsts = [b * per_batch + h
                  for b, h, _ in part[:min(sec, units - k * sec)]]
        assert firsts == sorted(firsts)


@pytest.mark.parametrize('kernel', fs.KERNELS)
@pytest.mark.parametrize('head_dim', HEAD_DIMS)
@pytest.mark.parametrize('batch,hq,hkv,seq', SHAPES)
def test_list_never_splits_a_gqa_group(batch, hq, hkv, seq, head_dim,
                                       kernel):
    """K1's and K2's sections hold every query head of each kv head they
    touch; K3's work tile is a kv head's keys, whose sweep runs over the
    whole group."""
    group = hq // hkv
    listed = fs.work_list(kernel, head_dim, batch, hq, hkv, seq)
    tiles = fs.tiles_per_unit(kernel, head_dim, seq)
    sec = fs.section_units(kernel, head_dim, batch, hq, hkv, seq)
    if kernel == 'dkv':
        t = fs.TILES[(kernel, head_dim)]
        for _, _, kt in listed:
            first = kt * t.keys // t.rows
            assert _sweep(kernel, head_dim, seq, (0, 0, kt)) == (
                -(-seq // t.rows) - first)
        return
    for i in range(0, len(listed), sec * tiles):
        heads = {(b, h) for b, h, _ in listed[i:i + sec * tiles]}
        for b, h in heads:
            kv = h // group
            assert {(b, kv * group + g) for g in range(group)} <= heads


def test_fwd_sections_split_only_heads_past_the_l2_budget():
    # train-s4096 (16 kv heads of 2 MB) and llama-finetune (64 of 0.5 MB)
    # fit in one section; lora-finetune's 128 kv heads of 1 MB take four.
    assert fs.fwd_section_heads(128, 4096, 2, 32) == 32
    assert fs.fwd_section_heads(64, 2048, 4, 256) == 256
    assert fs.fwd_section_heads(128, 2048, 2, 256) == 64
    assert fs.fwd_section_heads(128, 1 << 20, 2, 256) == 2  # one kv head
    # K3 streams Q and dO of a kv head's group: 2 MB a pair at lora (eight
    # sections of 16), 4 MB at train-s4096 (two of 8), 2 MB at
    # llama-finetune's D=64, group 4 (four of 16).
    assert fs.section_units('dkv', 128, 16, 16, 8, 2048) == 16
    assert fs.section_units('dkv', 128, 2, 16, 8, 4096) == 8
    assert fs.section_units('dkv', 64, 8, 32, 8, 2048) == 16
    assert fs.section_units('dkv', 128, 1, 16, 8, 1 << 20) == 1
    assert fs.section_units('dq', 128, 16, 16, 8, 2048) == 64


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
    # Two K/V buffers, then the Q/dO/lse/delta stages; 14 / 16 barriers
    # and two taken slots of three ints.
    assert fs.smem_bytes('dkv', 128) == (
        1024 + 2 * 65536 + 3 * (32768 + 512) + 14 * 8 + 24)
    assert fs.smem_bytes('dkv', 64) == (
        1024 + 2 * 32768 + 4 * (32768 + 1024) + 16 * 8 + 24)
    # Two Q and dO buffers, then 3 stages of 64 keys of K and V at D=128,
    # 4 of 128 keys at D=64; 12 / 14 barriers and the taken slots.
    assert fs.smem_bytes('dq', 128) == 1024 + 2 * 65536 + 3 * 32768 + 13 * 8
    assert fs.smem_bytes('dq', 64) == 1024 + 2 * 32768 + 4 * 32768 + 15 * 8


@pytest.mark.parametrize('kernel', fs.KERNELS)
@pytest.mark.parametrize('head_dim', HEAD_DIMS)
def test_fwd_key_tiles_reach_the_diagonal_or_s(head_dim, kernel):
    """K1 and K2 read key tiles up to a work tile's last row (causal) or
    all of S; K3 reads query tiles from the first that reaches its first
    key (causal) or all of them."""
    t = fs.TILES[(kernel, head_dim)]
    for seq in (1, 65, 129, 1000, 1537, 2048):
        for tile in range(fs.tiles_per_unit(kernel, head_dim, seq)):
            n = fs.streamed_tiles(kernel, head_dim, True, tile, seq)
            if kernel == 'dkv':
                q_tiles = -(-seq // t.rows)
                first = q_tiles - n
                assert first * t.rows <= tile * t.keys < (first + 1) * t.rows
                assert fs.streamed_tiles(kernel, head_dim, False, tile,
                                         seq) == q_tiles
                continue
            last_row = min((tile + 1) * t.rows, seq) - 1
            assert (n - 1) * t.keys <= last_row < n * t.keys
            assert fs.streamed_tiles(kernel, head_dim, False, tile,
                                     seq) == -(-seq // t.keys)


def test_plan_mirrors_the_library_tuple():
    assert fs.plan('fwd', 64, 3, 12, 4, 1000, 132) == (
        132, 132, 192, 128, 4, fs.smem_bytes('fwd', 64), 36)
    assert fs.plan('fwd', 128, 16, 16, 8, 2048, 132)[6] == 64
    assert fs.plan('fwd', 128, 1, 16, 8, 1, 132)[0] == 16
    assert fs.plan('dkv', 64, 3, 12, 4, 1000, 132) == (
        3 * 4 * 8, 132, 128, 128, 4, fs.smem_bytes('dkv', 64), 12)
    assert fs.plan('dq', 128, 5, 16, 8, 1537, 132) == (
        132, 132, 128, 64, 3, fs.smem_bytes('dq', 128), 80)
    assert fs.plan('dq', 64, 8, 32, 8, 2048, 132)[:5] == (
        132, 132, 128, 128, 4)
    # The multi-section walk of chip_smoke.py's phase 3: K2's 96 heads in
    # sections of 84, K3's 24 (batch, kv head)s in sections of 5.
    assert fs.plan('dq', 128, 3, 32, 8, 3000, 132)[6] == 84
    assert fs.plan('dkv', 128, 3, 32, 8, 3000, 132)[6] == 5
    with pytest.raises(ValueError):
        attention.plan('nope', 64, 1, 1, 1, 1)
