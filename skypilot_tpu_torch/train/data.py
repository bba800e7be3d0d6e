"""Input pipelines: synthetic LM batches + byte-level text corpus.

The port's own copy of ``skypilot_tpu/train/data.py`` (numpy only; the
port imports nothing of ``skypilot_tpu``), held to the original by
``tests/test_torch_train.py``. The trainer moves each batch to the device.

The reference recipe streams HF wikitext; with zero egress here, the
equivalents are (a) a seeded synthetic stream with the same shapes (bench,
tests) and (b) a byte-tokenizer over local text files (real-loss demos).
Host-side numpy only — batches land on device via the trainer's shardings.
"""
from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np


def synthetic_batches(batch_size: int, seq_len: int, vocab_size: int,
                      seed: int = 0,
                      num_batches: Optional[int] = None) -> Iterator[np.ndarray]:
    """Zipf-ish token distribution so loss curves look like language, not
    uniform noise (uniform makes the loss start at ln(V) and stay there)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    i = 0
    while num_batches is None or i < num_batches:
        yield rng.choice(vocab_size, size=(batch_size, seq_len),
                         p=probs).astype(np.int32)
        i += 1


def byte_corpus_batches(path: str, batch_size: int, seq_len: int,
                        seed: int = 0) -> Iterator[np.ndarray]:
    """Next-byte LM over a local file (vocab 256)."""
    with open(os.path.expanduser(path), 'rb') as f:
        data = np.frombuffer(f.read(), dtype=np.uint8)
    if len(data) < seq_len + 1:
        raise ValueError(f'{path} too small ({len(data)} bytes) for '
                         f'seq_len={seq_len}')
    rng = np.random.default_rng(seed)
    while True:
        starts = rng.integers(0, len(data) - seq_len - 1, size=batch_size)
        yield np.stack([data[s:s + seq_len] for s in starts]).astype(np.int32)


class TokenDataset:
    """Memory-mapped pretokenized corpus -> deterministic [B, S] batches.

    The production input pipeline (reference counterpart: the HF dataset
    streaming inside ``run_clm.py`` — workload-level there, first-class
    here). Design for TPU training:

    * the token file is a flat array of token ids (``write_token_file``),
      memory-mapped — no copy at open, the OS pages in what the host
      actually reads;
    * the corpus is cut into non-overlapping ``seq_len`` windows, visited
      in a seeded permutation (epoch-shuffled without materializing
      indices per epoch beyond one permutation array);
    * ``batch(step)`` is a PURE function of (step, shard): checkpoint
      resume replays the exact trajectory (the managed-jobs recovery
      contract), and data-parallel ranks pass ``shard/num_shards`` to read
      DISJOINT rows of the same global batch — no coordination, no
      duplicate samples.
    """

    def __init__(self, path: str, seq_len: int, batch_size: int,
                 dtype=np.uint32, seed: int = 0,
                 num_shards: int = 1, shard: int = 0,
                 vocab_size: Optional[int] = None):
        assert 0 <= shard < num_shards, (shard, num_shards)
        assert batch_size % num_shards == 0, \
            f'global batch {batch_size} not divisible by {num_shards} shards'
        self.tokens = np.memmap(os.path.expanduser(path), dtype=dtype,
                                mode='r')
        self.seq_len = seq_len
        self.global_batch = batch_size
        self.shard_batch = batch_size // num_shards
        self.shard = shard
        self.vocab_size = vocab_size
        self.num_windows = len(self.tokens) // seq_len
        if self.num_windows < batch_size:
            # Fewer windows than one global batch would silently duplicate
            # samples WITHIN a batch and across "disjoint" dp shards —
            # breaking the no-duplicate contract the docstring promises.
            raise ValueError(
                f'{path}: only {self.num_windows} windows of seq_len '
                f'{seq_len} (need >= global batch {batch_size})')
        self._perm = np.random.default_rng(seed).permutation(
            self.num_windows)

    @property
    def steps_per_epoch(self) -> int:
        return max(1, self.num_windows // self.global_batch)

    def batch(self, step: int) -> np.ndarray:
        """This shard's rows of global batch ``step`` ([shard_batch, S],
        int32). Wraps (re-shuffles implicitly via the fixed permutation)
        past the end of the corpus."""
        base = step * self.global_batch + self.shard * self.shard_batch
        rows = []
        for r in range(self.shard_batch):
            w = self._perm[(base + r) % self.num_windows]
            rows.append(self.tokens[w * self.seq_len:
                                    (w + 1) * self.seq_len])
        out = np.stack(rows).astype(np.int32)
        if self.vocab_size is not None:
            hi = int(out.max())
            lo = int(out.min())
            if hi >= self.vocab_size or lo < 0:
                # Out-of-range ids would be silently clamped by the jitted
                # embedding gather — training would proceed on garbage.
                raise ValueError(
                    f'token id range [{lo}, {hi}] outside the model vocab '
                    f'({self.vocab_size}) at step {step} — wrong tokenizer '
                    'or dtype for this model?')
        return out

    def batches(self, start_step: int = 0) -> Iterator[np.ndarray]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


def write_token_file(path: str, tokens: np.ndarray,
                     dtype=np.uint32) -> None:
    """Persist a flat token-id array in TokenDataset's format."""
    np.asarray(tokens, dtype=dtype).tofile(os.path.expanduser(path))
