"""Deterministic synthetic token pipeline: DP-sharded, resumable, zero I/O.

token[i] = splitmix-style hash of (seed, i) mod vocab — every rank can
materialize any slice of the global stream independently, so elastic resizes
and restarts never re-read or shuffle data. State is a single step counter
(checkpointed), making data order exactly reproducible across failures.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def synth_tokens(seed: int, start: int, count: int, vocab: int) -> np.ndarray:
    idx = np.arange(start, start + count, dtype=np.uint64)
    h = _splitmix64(idx ^ _splitmix64(np.uint64(seed) * np.ones(1, np.uint64)))
    return (h % np.uint64(vocab)).astype(np.int32)


def synth_sequence_rows(seed: int, rows: np.ndarray, seq_len: int,
                        vocab: int, p_markov: float = 0.8) -> np.ndarray:
    """Learnable synthetic corpus: with prob ``p_markov`` the next token is a
    fixed affine map of the previous one (the model can learn the permutation
    table), else fresh noise. Fully determined by (seed, row index) so any
    rank/topology materializes identical data. rows: (B,) global row ids."""
    b = len(rows)
    h = np.stack([synth_tokens(seed, int(r) * (seq_len + 7), seq_len, 1 << 30)
                  for r in rows])  # (B, S) raw hashes
    out = np.empty((b, seq_len), np.int32)
    out[:, 0] = h[:, 0] % vocab
    markov = (h % 1000) < int(p_markov * 1000)
    for t in range(1, seq_len):
        mapped = (out[:, t - 1] * 31 + 7) % vocab
        out[:, t] = np.where(markov[:, t], mapped, h[:, t] % vocab)
    return out


@dataclasses.dataclass
class PipelineState:
    step: int = 0


class DataPipeline:
    """Yields {tokens, labels} batches for a (possibly sharded) host.

    dp_rank/dp_size carve the global batch; the same (seed, step) always
    yields the same global batch regardless of topology — the elastic-resize
    guarantee."""

    def __init__(self, cfg: ModelConfig, global_batch: int, seq_len: int,
                 seed: int = 0, dp_rank: int = 0, dp_size: int = 1,
                 state: Optional[PipelineState] = None):
        assert global_batch % dp_size == 0
        self.cfg = cfg
        self.global_batch = global_batch
        self.local_batch = global_batch // dp_size
        self.seq_len = seq_len
        self.seed = seed
        self.dp_rank = dp_rank
        self.dp_size = dp_size
        self.state = state or PipelineState()

    def next_batch(self) -> Dict[str, np.ndarray]:
        step = self.state.step
        base = step * self.global_batch + self.dp_rank * self.local_batch
        rows = np.arange(base, base + self.local_batch)
        arr = synth_sequence_rows(self.seed, rows, self.seq_len + 1,
                                  self.cfg.vocab_size)
        self.state.step += 1
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    def state_dict(self) -> Dict[str, int]:
        return {"step": self.state.step}

    def load_state_dict(self, d: Dict[str, int]):
        self.state.step = int(d["step"])
