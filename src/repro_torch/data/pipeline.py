"""Deterministic synthetic data pipeline: the port's numpy copy of
``src/repro/data/pipeline.py``, batch for batch byte-equal.

Design goals for 1000+-node operation (DESIGN.md §6):
  * stateless addressing — batch ``step`` is a pure function of
    (seed, step), so any host can (re)compute any shard: restart and
    straggler fail-over need no data server and no coordination;
  * checkpointable — pipeline state is just the integer step;
  * shardable — ``shard_slice`` returns only the host's rows.

The token stream is a mixture of a Zipf-ish unigram draw and a structured
"copy run" pattern so the LM loss actually decreases during the end-to-end
example (pure-uniform tokens have irreducible loss = log V).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.config import ModelConfig


@dataclass
class SyntheticPipeline:
    model: ModelConfig
    batch: int
    seq_len: int
    seed: int = 0

    # ------------------------------------------------------------------
    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))

    def _tokens(self, rng, rows: int, cols: int) -> np.ndarray:
        v = self.model.vocab_size
        # zipf-ish unigram over a 1024-symbol head + uniform tail
        head = min(1024, v)
        ranks = np.arange(1, head + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = rng.choice(head, size=(rows, cols), p=probs).astype(np.int32)
        # structured copy runs: repeat the previous token with p=0.25
        rep = rng.random((rows, cols)) < 0.25
        for c in range(1, cols):
            toks[:, c] = np.where(rep[:, c], toks[:, c - 1], toks[:, c])
        return toks

    def get_batch(self, step: int) -> Dict[str, np.ndarray]:
        """Full global batch for ``step`` (deterministic)."""
        rng = self._rng(step)
        m, B, S = self.model, self.batch, self.seq_len
        if m.is_encoder_decoder:
            toks = self._tokens(rng, B, S + 1)
            frames = rng.standard_normal(
                (B, m.encoder_seq, m.d_model)).astype(np.float32)
            return {"frames": frames, "tokens": toks[:, :-1],
                    "labels": toks[:, 1:]}
        if m.frontend == "patch_stub":
            F = m.num_frontend_tokens
            toks = self._tokens(rng, B, S - F + 1)
            patch = rng.standard_normal((B, F, m.d_model)).astype(np.float32)
            return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                    "patch_embeds": patch}
        toks = self._tokens(rng, B, S + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def shard_slice(self, step: int, shard: int, num_shards: int):
        """Only this host's rows — identical to slicing the global batch."""
        full = self.get_batch(step)
        rows = self.batch // num_shards
        return {k: v[shard * rows:(shard + 1) * rows] for k, v in full.items()}

    # checkpointable state ------------------------------------------------
    def state_dict(self, step: int) -> Dict[str, int]:
        return {"seed": self.seed, "step": int(step)}

    @classmethod
    def from_state(cls, model: ModelConfig, batch: int, seq_len: int,
                   state: Dict[str, int]) -> "SyntheticPipeline":
        return cls(model, batch, seq_len, seed=state["seed"])
