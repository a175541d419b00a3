"""Data pipeline: deterministic synthetic LM stream with restartable
sharded iteration state (host shard, epoch, offset) — checkpointable so a
restarted job resumes mid-epoch without sample repetition/loss.

A copy of ``repro.train.data`` (numpy only): the batches are the
reference's, byte for byte."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DataState:
    seed: int
    batch: int
    seq: int
    vocab: int
    shard: int = 0
    num_shards: int = 1
    step: int = 0

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        """Typed restore: checkpoint round-trips hand back numpy scalars
        (np.savez boxes every int), so coerce each field through its
        declared type — the iterator must resume with real Python ints."""
        fields = {f.name: f.type for f in dataclasses.fields(cls)}
        return cls(**{k: int(v) for k, v in d.items() if k in fields})


class SyntheticLM:
    """Markov-ish synthetic tokens: deterministic per (seed, shard, step) —
    the content is reproducible across restarts and host re-layouts."""

    def __init__(self, state: DataState):
        self.state = state

    def _rng(self, step):
        s = self.state
        return np.random.default_rng(
            np.random.SeedSequence([s.seed, s.shard, step])
        )

    def next_batch(self):
        s = self.state
        rng = self._rng(s.step)
        # structured stream (zipf-ish marginals + local repetition) so the
        # loss curve is non-trivial for the examples
        base = rng.zipf(1.3, size=(s.batch, s.seq)).astype(np.int64)
        tokens = (base % (s.vocab - 2)) + 1
        rep = rng.random((s.batch, s.seq)) < 0.3
        tokens[:, 1:] = np.where(rep[:, 1:], tokens[:, :-1], tokens[:, 1:])
        s.step += 1
        return {
            "tokens": tokens.astype(np.int32),
            "labels": tokens.astype(np.int32),
        }

    def next_embeds_batch(self, d_model, dtype=np.float32):
        s = self.state
        rng = self._rng(s.step)
        b = self.next_batch()
        b["embeds"] = rng.standard_normal((s.batch, s.seq, d_model)).astype(dtype)
        del b["tokens"]
        return b
