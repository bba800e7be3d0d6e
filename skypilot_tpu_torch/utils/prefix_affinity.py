"""Prefix-chain hashing: the trie-side half of prefix-affinity routing.

Copy of the framework-free ``chain_digest``, ``chain_hashes`` and
``SUMMARY_VERSION`` of ``skypilot_tpu/utils/prefix_affinity.py``, held
byte for byte to the original by ``tests/test_torch_paged.py``: the
share trie (``models/paged.py``) names each committed block chain by its
digest, the replica's ``/health`` advert carries those digests, and the
KV tiers (``serve/kv_tiers.py``) key their host pool and spill segments
on them, so a digest computed here must equal the one a JAX replica or
load balancer computes over the same tokens.

``digest(chain) = blake2b8(digest(parent_chain) || block_tokens)``, each
token as 8 little-endian signed bytes.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence

# The summary schema's version: a load balancer ignores a summary of a
# version it does not know.
SUMMARY_VERSION = 1

_DIGEST_SIZE = 8  # 16 hex chars per chain on the wire


def chain_digest(parent: Optional[bytes],
                 block_tokens: Sequence[int]) -> bytes:
    """Digest of one more block appended to a parent chain. ``parent``
    is the parent chain's digest (None at the root)."""
    h = hashlib.blake2b(digest_size=_DIGEST_SIZE)
    if parent:
        h.update(parent)
    for t in block_tokens:
        h.update(int(t).to_bytes(8, 'little', signed=True))
    return h.digest()


def chain_hashes(tokens: Sequence[int], block: int,
                 max_chains: int) -> List[str]:
    """Hex digests of the prompt's leading full-block chains:
    ``out[d-1]`` covers ``tokens[:d*block]``, the granularity the trie
    commits at."""
    if block <= 0:
        return []
    out: List[str] = []
    digest: Optional[bytes] = None
    n_full = min(len(tokens) // block, max(int(max_chains), 0))
    for d in range(n_full):
        digest = chain_digest(digest, tokens[d * block:(d + 1) * block])
        out.append(digest.hex())
    return out
