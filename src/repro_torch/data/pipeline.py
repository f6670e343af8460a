"""Deterministic synthetic token pipeline, sharded per host (the port's
own copy of ``repro.data.pipeline``: numpy only, the same batches bit for
bit).

Each host materialises only its shard of the global batch
(``shard_id`` / ``num_shards``), derived from (seed, step) alone, so a
restart resumes mid-epoch exactly and no host reads another's data.

The sequences follow a learnable affine recurrence
    x_{t+1} = (a·x_t + b) mod vocab
with stream-global (a, b) and a random x_0 per sequence: the transition is
a fixed function of the current token, so a model drives the loss toward
zero by learning it (``examples/train_lm.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_shards: int = 1
    shard_id: int = 0

    @property
    def shard_batch(self) -> int:
        if self.global_batch % self.num_shards:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split into {self.num_shards} shards")
        return self.global_batch // self.num_shards


class TokenStream:
    """Stateless: ``batch(step)`` is a pure function of the step, so it is
    restart-safe. Batches are numpy int32 {"tokens", "labels"} [b, S]."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        b = cfg.shard_batch
        # an independent generator per (step, shard)
        seed = (np.uint64(cfg.seed) * np.uint64(1_000_003)
                + np.uint64(step) * np.uint64(cfg.num_shards)
                + np.uint64(cfg.shard_id))
        rng = np.random.default_rng(int(seed))
        grng = np.random.default_rng(cfg.seed)  # the stream-global transition
        a = np.int64(grng.integers(1, 64) * 2 + 1)
        c = np.int64(grng.integers(0, cfg.vocab))
        seq = rng.integers(0, cfg.vocab, size=(b, 1), dtype=np.int64)
        rows = [seq]
        for _ in range(cfg.seq_len):
            seq = (a * seq + c) % cfg.vocab
            rows.append(seq)
        tokens = np.concatenate(rows, axis=1)  # [b, seq_len + 1]
        return {"tokens": tokens[:, :-1].astype(np.int32),
                "labels": tokens[:, 1:].astype(np.int32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def to_device(batch: dict, device) -> dict:
    """The batch's numpy arrays as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
