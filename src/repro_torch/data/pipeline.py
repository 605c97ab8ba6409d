"""Deterministic sharded synthetic data pipeline.

A copy of ``repro/data/pipeline.py`` (which imports ``repro.models.config``),
numpy only: the same ``SeedSequence([seed, step, row])`` per row, so the
port and the reference draw the same global batches.

Every substrate is real (no "assume a loader exists"): this one generates a
learnable affine-bigram language (``t+1 = (a·t + b) mod V`` with noise), is
seeded and *host-shardable* — each data-parallel host draws only its own
batch slice from the same global stream, so restarts and elastic re-shards
replay identical global batches (the property the fault-tolerance tests
assert).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05
    a: int = 31
    b: int = 7
    host_id: int = 0
    num_hosts: int = 1

    def __post_init__(self):
        if self.global_batch % self.num_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.local_batch = self.global_batch // self.num_hosts

    def _rng_for(self, step: int, row: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, row]))

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Global-batch rows [host_id·local : (host_id+1)·local)."""
        rows = range(self.host_id * self.local_batch,
                     (self.host_id + 1) * self.local_batch)
        toks = np.empty((self.local_batch, self.seq_len + 1), np.int32)
        for i, r in enumerate(rows):
            rng = self._rng_for(step, r)
            t = np.empty(self.seq_len + 1, np.int64)
            t[0] = rng.integers(self.vocab_size)
            noise = rng.random(self.seq_len) < self.noise
            rand = rng.integers(self.vocab_size, size=self.seq_len)
            for j in range(self.seq_len):
                t[j + 1] = (rand[j] if noise[j]
                            else (self.a * t[j] + self.b) % self.vocab_size)
            toks[i] = t
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_batch_specs(cfg: ModelConfig, batch: int, seq: int):
    """Concrete host-side arrays for one smoke batch of any modality."""
    rng = np.random.default_rng(0)
    out: dict[str, np.ndarray] = {}
    s_text = seq
    if cfg.frontend == "vision":
        p = min(cfg.num_patches, seq // 2)
        s_text = seq - p
        out["patches"] = rng.standard_normal(
            (batch, p, cfg.frontend_dim)).astype(np.float32)
        out["tokens"] = rng.integers(
            cfg.vocab_size, size=(batch, s_text)).astype(np.int32)
        labels = np.full((batch, seq), -1, np.int32)
        labels[:, p:] = rng.integers(cfg.vocab_size, size=(batch, s_text))
        out["labels"] = labels
    elif cfg.frontend == "audio":
        out["frames"] = rng.standard_normal(
            (batch, seq, cfg.frontend_dim)).astype(np.float32)
        out["labels"] = rng.integers(cfg.vocab_size,
                                     size=(batch, seq)).astype(np.int32)
    else:
        out["tokens"] = rng.integers(cfg.vocab_size,
                                     size=(batch, seq)).astype(np.int32)
        out["labels"] = rng.integers(cfg.vocab_size,
                                     size=(batch, seq)).astype(np.int32)
    return out
