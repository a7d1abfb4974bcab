"""Deterministic synthetic LM token pipeline (``repro.data.tokens``'s
counterpart).

A fixed random order-1 Markov chain over the vocabulary, sampled per
step. The chain has low-entropy rows (temperature ``peak``), so
cross-entropy can drop well below log(V) as a model learns the
transition table.

The Markov table is drawn with numpy exactly as the JAX package draws it,
so it is bitwise JAX's. The token draws are not: they come from a
``torch.Generator`` seeded from ``SeedSequence([seed, step])`` (JAX uses
its threefry keys), so a batch is a pure function of (seed, step) but
its tokens differ from the JAX stream's.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def _generator(*entropy: int) -> torch.Generator:
    state = np.random.SeedSequence(list(entropy)).generate_state(1, np.uint32)
    return torch.Generator().manual_seed(int(state[0]))


@dataclass(frozen=True)
class TokenStream:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_states: int = 64     # Markov states (vocab ids 0..n_states-1 used)
    peak: float = 6.0      # logit scale; higher => lower entropy rows
    device: str = "cuda"   # where batches are returned

    def _table(self) -> np.ndarray:
        r = np.random.default_rng(self.seed)
        logits = self.peak * r.standard_normal(
            (self.n_states, self.n_states)).astype(np.float32)
        p = np.exp(logits - logits.max(axis=1, keepdims=True))
        return p / p.sum(axis=1, keepdims=True)

    def batch(self, step: int) -> dict:
        """(tokens, labels) for ``step`` — pure function of (seed, step).
        The chain is walked on the host by inverse-CDF draws, one uniform
        per token."""
        cdf = np.cumsum(self._table().astype(np.float64), axis=1)
        gen = _generator(self.seed, step)
        b, s = self.global_batch, self.seq_len
        state = torch.randint(0, self.n_states, (b,), generator=gen).numpy()
        u = torch.rand((s, b), generator=gen, dtype=torch.float64).numpy()
        seq = np.empty((b, s + 1), np.int32)
        seq[:, 0] = state
        for i in range(s):
            row = cdf[state]
            state = np.minimum((row < u[i][:, None] * row[:, -1:]).sum(1),
                               self.n_states - 1)
            seq[:, i + 1] = state
        seq = torch.from_numpy(seq).to(self.device)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    def extra_inputs(self, cfg, step: int) -> dict:
        """Modality-stub inputs: vlm patches (``img_embeds``) or enc-dec
        audio frames (``frames``), 0.02 * N(0, 1) in f32 from a generator
        seeded by (seed ^ 0x5EED, step); JAX's draws are not reproduced."""
        b = self.global_batch
        shape = {"vlm": ("img_embeds", cfg.n_img_tokens),
                 "encdec": ("frames", cfg.encoder_ctx)}.get(cfg.family)
        if shape is None:
            return {}
        name, t = shape
        gen = _generator(self.seed ^ 0x5EED, step)
        return {name: (0.02 * torch.randn((b, t, cfg.d_model),
                                          generator=gen)).to(self.device)}


def synthetic_batch(cfg, shape, step: int = 0, seed: int = 0,
                    device="cuda") -> dict:
    """One training batch matching ``bundle.input_specs(shape)``."""
    stream = TokenStream(cfg.vocab, shape.seq_len, shape.global_batch,
                         seed=seed, device=device)
    batch = stream.batch(step)
    if cfg.family == "vlm":
        t = cfg.n_img_tokens
        batch = {"tokens": batch["tokens"][:, :shape.seq_len - t],
                 "labels": batch["labels"][:, :shape.seq_len - t]}
    batch.update(stream.extra_inputs(cfg, step))
    return batch
