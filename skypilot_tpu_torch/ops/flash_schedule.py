"""How the bf16 flash-attention bodies cut their work, mirrored in Python.

``csrc/flash_attention_sm90.cuh`` decides on the card how K1 (forward),
K2 (dQ) and K3 (dK, dV) tile their work: the rows and keys of a tile,
the stages of the ring of loads, the shared memory a block takes, and
the list of work tiles that each kernel's persistent blocks take, in
order, from a counter. This module repeats those decisions so that the
CPU tests can check them (every work tile listed once, longest causal
sweep first in each L2-sized section, a GQA group never split; at most
one block per SM; shared memory within a block's limit), and
``chip_smoke.py`` holds it against the library's own
``skytorch_flash_plan`` (``attention.plan``) on the card. Nothing here
launches a kernel.

A work tile is, for K1 and K2, the query rows of a tile of one (batch,
head) (the unit of their lists), and for K3 the keys of a tile of one
(batch, kv head) (its unit).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

SMEM_PER_BLOCK = 232_448  # H100: the most dynamic shared memory a block takes
# kL2SectionBytes: what one section of a work list streams (K1, K2: K and
# V; K3: Q and dO of the whole group).
L2_SECTION_BYTES = 32 << 20
KERNELS = ('fwd', 'dq', 'dkv')  # K1, K2, K3: skytorch_flash_plan's 0, 1, 2
_BOX_ROW_BYTES = 128  # one row of a 64-column bf16 box
_ALIGN = 1024  # slack to align the swizzled tiles
_BARRIER = 8  # bytes of an mbarrier


@dataclasses.dataclass(frozen=True)
class Tiles:
    rows: int    # query rows of a tile (K1, K2: a block's; K3: streamed)
    keys: int    # keys of a tile (K1, K2: streamed; K3: a block's)
    stages: int  # stages of the ring of streamed tiles
    buffers: int = 1  # copies of the resident tiles (K2: Q, dO; K3: K, V)


TILES = {
    ('fwd', 64): Tiles(192, 128, 4), ('fwd', 128): Tiles(128, 128, 3),
    ('dq', 64): Tiles(128, 128, 4, 2), ('dq', 128): Tiles(128, 64, 3, 2),
    ('dkv', 64): Tiles(128, 128, 4, 2), ('dkv', 128): Tiles(64, 128, 3, 2),
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
    if kernel == 'dq':  # Q and dO buffers; K and V stages; Q full/empty
        return (_ALIGN + t.buffers * 2 * q + t.stages * 2 * kv  # and taken
                + (3 * t.buffers + 2 * t.stages + 1) * _BARRIER)  # a buffer
    # K and V buffers; Q, dO, lse and delta stages; K/V full/empty a
    # buffer, taken full/empty a slot, 2 a stage; two taken slots of 3 ints
    return (_ALIGN + 2 * t.buffers * kv + t.stages * (2 * q + 2 * t.rows * 4)
            + (2 * t.buffers + 4 + 2 * t.stages) * _BARRIER + 6 * 4)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def tiles_per_unit(kernel: str, head_dim: int, seq: int) -> int:
    """Work tiles of one unit: query tiles (K1, K2) or key tiles (K3)."""
    t = TILES[(kernel, head_dim)]
    return _ceil(seq, t.keys if kernel == 'dkv' else t.rows)


def units(kernel: str, batch: int, hq: int, hkv: int) -> int:
    """Units of a work list: (batch, head)s, or (batch, kv head)s for K3."""
    return batch * (hkv if kernel == 'dkv' else hq)


def blocks(kernel: str, head_dim: int, batch: int, hq: int, hkv: int,
           seq: int, sms: int) -> int:
    """A kernel's grid: one block per SM, at most one per work tile."""
    works = units(kernel, batch, hq, hkv) * tiles_per_unit(kernel, head_dim,
                                                            seq)
    return min(sms, works)


def fwd_section_heads(head_dim: int, seq: int, group: int,
                      heads: int) -> int:
    """(Batch, head)s of a section of K1's and K2's work lists: as many
    kv heads' bf16 K and V as fit in L2_SECTION_BYTES (at least one),
    times the group."""
    kv_heads = max(1, L2_SECTION_BYTES // (4 * seq * head_dim))
    return min(kv_heads * group, heads)


def section_units(kernel: str, head_dim: int, batch: int, hq: int,
                  hkv: int, seq: int) -> int:
    """Units of a section of ``kernel``'s work list. K3's streams Q and
    dO, so its section is as many (batch, kv head)s as have their whole
    group's bf16 Q and dO fit in L2_SECTION_BYTES (at least one)."""
    group = hq // hkv
    if kernel == 'dkv':
        pairs = max(1, L2_SECTION_BYTES // (4 * seq * head_dim * group))
        return min(pairs, batch * hkv)
    return fwd_section_heads(head_dim, seq, group, batch * hq)


def work_tile(kernel: str, w: int, head_dim: int, batch: int, hq: int,
              hkv: int, seq: int) -> Tuple[int, int, int]:
    """Work-list entry ``w`` as (b, head, tile), the head being a kv
    head for K3: section by section of ``section_units``, and inside a
    section every unit's longest sweep first (K1, K2: its last query
    tile; K3: its key tile 0), units in order (so a kv head's query
    heads lie next to each other), then every unit's next, and so on."""
    tiles = tiles_per_unit(kernel, head_dim, seq)
    n = units(kernel, batch, hq, hkv)
    sec = section_units(kernel, head_dim, batch, hq, hkv, seq)
    first = w // (sec * tiles) * sec
    n_units = min(sec, n - first)
    within = w - first * tiles
    unit = first + within % n_units
    rank = within // n_units
    per_batch = hkv if kernel == 'dkv' else hq
    tile = rank if kernel == 'dkv' else tiles - 1 - rank
    return unit // per_batch, unit % per_batch, tile


def work_list(kernel: str, head_dim: int, batch: int, hq: int, hkv: int,
              seq: int) -> List[Tuple[int, int, int]]:
    """``kernel``'s work list, (b, head, tile) in the order the blocks
    take them from the counter."""
    works = units(kernel, batch, hq, hkv) * tiles_per_unit(kernel, head_dim,
                                                            seq)
    return [work_tile(kernel, w, head_dim, batch, hq, hkv, seq)
            for w in range(works)]


def streamed_tiles(kernel: str, head_dim: int, causal: bool, tile: int,
                   seq: int) -> int:
    """The sweep of work tile ``tile``: key tiles that K1 and K2 read for
    its query rows (causal: up to its last row), or query tiles of one
    head that K3 reads for its keys (causal: from the first that reaches
    them)."""
    t = TILES[(kernel, head_dim)]
    if kernel == 'dkv':
        first = tile * t.keys // t.rows if causal else 0
        return _ceil(seq, t.rows) - first
    end = min((tile + 1) * t.rows, seq) if causal else seq
    return _ceil(end, t.keys)


def plan(kernel: str, head_dim: int, batch: int, hq: int, hkv: int,
         seq: int, sms: int) -> Tuple[int, ...]:
    """(blocks, SMs, query rows a tile, keys a tile, stages, shared memory
    bytes, units of a section of the work list) of a bf16 launch: what
    ``skytorch_flash_plan`` reports."""
    t = TILES[(kernel, head_dim)]
    return (blocks(kernel, head_dim, batch, hq, hkv, seq, sms), sms, t.rows,
            t.keys, t.stages, smem_bytes(kernel, head_dim),
            section_units(kernel, head_dim, batch, hq, hkv, seq))
