"""How the bf16 flash-attention bodies cut their work, mirrored in Python.

``csrc/flash_attention_sm90.cuh`` decides on the card how K1 (forward),
K2 (dQ) and K3 (dK, dV) tile their work: the rows and keys of a tile,
the stages of the ring of loads, the shared memory a block takes, and
the list of work tiles that K1's persistent blocks take, in order, from
a counter. This module repeats those decisions so that the CPU tests can
check them (every work tile listed once, longest causal sweep first in
each L2-sized section of heads; at most one block per SM; shared memory
within a block's limit), and ``chip_smoke.py`` holds it against the
library's own ``skytorch_flash_plan`` (``attention.plan``) on the card.
Nothing here launches a kernel.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

SMEM_PER_BLOCK = 232_448  # H100: the most dynamic shared memory a block takes
L2_SECTION_BYTES = 32 << 20  # kFwdL2Bytes: K and V of a section of K1's list
KERNELS = ('fwd', 'dq', 'dkv')  # K1, K2, K3: skytorch_flash_plan's 0, 1, 2
_BOX_ROW_BYTES = 128  # one row of a 64-column bf16 box
_ALIGN = 1024  # slack to align the swizzled tiles
_BARRIER = 8  # bytes of an mbarrier


@dataclasses.dataclass(frozen=True)
class Tiles:
    rows: int    # query rows of a tile (K1, K2: a block's; K3: streamed)
    keys: int    # keys of a tile (K1, K2: streamed; K3: a block's)
    stages: int  # stages of the ring of streamed tiles


TILES = {
    ('fwd', 64): Tiles(192, 128, 4), ('fwd', 128): Tiles(128, 128, 3),
    ('dq', 64): Tiles(128, 64, 4), ('dq', 128): Tiles(128, 64, 4),
    ('dkv', 64): Tiles(128, 128, 4), ('dkv', 128): Tiles(64, 128, 3),
}


def _tile_bytes(head_dim: int, rows: int) -> int:
    return head_dim // 64 * rows * _BOX_ROW_BYTES


def smem_bytes(kernel: str, head_dim: int) -> int:
    """Dynamic shared memory of one block of ``kernel`` at ``head_dim``:
    fwd_smem, dq_smem and dkv_smem of the header."""
    t = TILES[(kernel, head_dim)]
    q, kv = _tile_bytes(head_dim, t.rows), _tile_bytes(head_dim, t.keys)
    if kernel == 'fwd':  # Q; K and V stages; Q full/empty, 2 a stage, taken
        return _ALIGN + q + 2 * t.stages * kv + (3 + 2 * t.stages) * _BARRIER
    if kernel == 'dq':  # Q and dO; K and V stages
        return (_ALIGN + 2 * q + t.stages * 2 * kv
                + (1 + 2 * t.stages) * _BARRIER)
    # K and V; Q, dO, lse and delta stages
    return (_ALIGN + 2 * kv + t.stages * (2 * q + 2 * t.rows * 4)
            + (1 + 2 * t.stages) * _BARRIER)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def fwd_blocks(head_dim: int, batch: int, hq: int, seq: int,
               sms: int) -> int:
    """K1's grid: one block per SM, at most one per work tile."""
    return min(sms, batch * hq * _ceil(seq, TILES[('fwd', head_dim)].rows))


def fwd_section_heads(head_dim: int, seq: int, group: int,
                      heads: int) -> int:
    """(Batch, head)s of a section of K1's work list: as many kv heads'
    bf16 K and V as fit in L2_SECTION_BYTES (at least one), times the
    group."""
    kv_heads = max(1, L2_SECTION_BYTES // (4 * seq * head_dim))
    return min(kv_heads * group, heads)


def fwd_work_tile(w: int, head_dim: int, batch: int, hq: int, hkv: int,
                  seq: int) -> Tuple[int, int, int]:
    """Work-list entry ``w`` as (b, h, query tile): section by section of
    ``fwd_section_heads`` (batch, head)s, and inside a section the last
    query tile of each of its heads first (heads of one kv head next to
    each other), then the one before, and so on."""
    tiles = _ceil(seq, TILES[('fwd', head_dim)].rows)
    heads = batch * hq
    sec = fwd_section_heads(head_dim, seq, hq // hkv, heads)
    first = w // (sec * tiles) * sec
    n_heads = min(sec, heads - first)
    within = w - first * tiles
    bh = first + within % n_heads
    return bh // hq, bh % hq, tiles - 1 - within // n_heads


def fwd_key_tiles(head_dim: int, causal: bool, q0: int, seq: int) -> int:
    """Key tiles K1 reads for the query rows of a work tile from q0."""
    t = TILES[('fwd', head_dim)]
    end = min(q0 + t.rows, seq) if causal else seq
    return _ceil(end, t.keys)


def fwd_work_list(head_dim: int, batch: int, hq: int, hkv: int, seq: int
                  ) -> List[Tuple[int, int, int]]:
    """K1's work list, (b, h, query tile) in the order the blocks take
    them from the counter."""
    works = batch * hq * _ceil(seq, TILES[('fwd', head_dim)].rows)
    return [fwd_work_tile(w, head_dim, batch, hq, hkv, seq)
            for w in range(works)]


def plan(kernel: str, head_dim: int, batch: int, hq: int, hkv: int,
         seq: int, sms: int) -> Tuple[int, ...]:
    """(blocks, SMs, query rows a tile, keys a tile, stages, shared memory
    bytes, K1's (batch, head)s a section or 0) of a bf16 launch: what
    ``skytorch_flash_plan`` reports."""
    t = TILES[(kernel, head_dim)]
    sec = 0
    if kernel == 'fwd':
        blocks = fwd_blocks(head_dim, batch, hq, seq, sms)
        sec = fwd_section_heads(head_dim, seq, hq // hkv, batch * hq)
    elif kernel == 'dq':
        blocks = batch * hq * _ceil(seq, t.rows)
    else:
        blocks = batch * hkv * _ceil(seq, t.keys)
    return (blocks, sms, t.rows, t.keys, t.stages,
            smem_bytes(kernel, head_dim), sec)
