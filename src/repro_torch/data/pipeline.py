"""Deterministic, stateless data pipeline.

Counterpart of ``repro.data.pipeline``.  ``synthetic_batch`` is a pure
function of ``(seed, step)``, so any host can (re)produce any batch at
any time: no loader state to checkpoint.  It draws from a
``torch.Generator`` seeded from both, not from threefry, so its tokens
are not the reference's (whose bits even differ between JAX releases).
``MemmapTokens`` reads a flat token file and is bit-equal to the
reference's.
"""
from __future__ import annotations

import numpy as np
import torch


def _generator(seed: int, step: int) -> torch.Generator:
    """A host generator seeded from ``(seed, step)`` through numpy's
    ``SeedSequence`` (the CPU generator keeps 32 bits of a seed)."""
    return torch.Generator().manual_seed(
        int(np.random.SeedSequence([seed, step]).generate_state(1)[0]))


def synthetic_batch(cfg, step, batch, seq, seed=0, device=None):
    """Next-token-prediction batch: inputs/labels/mask (+frontend stub),
    drawn on the host and moved to ``device``."""
    toks = torch.randint(0, cfg.vocab, (batch, seq + 1),
                         generator=_generator(seed, step),
                         dtype=torch.int32)
    out = {"inputs": toks[:, :-1], "labels": toks[:, 1:],
           "mask": torch.ones((batch, seq), dtype=torch.float32)}
    if cfg.n_frontend_tokens:
        out["frontend"] = torch.randn(
            (batch, cfg.n_frontend_tokens, cfg.d_model),
            generator=_generator(seed + 1, step), dtype=torch.float32)
    return {k: v.to(device) for k, v in out.items()}


class MemmapTokens:
    """Flat int32 token file -> deterministic batches by step index."""

    def __init__(self, path, seq_len, dtype=np.int32):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.seq = seq_len
        self.n_seqs = (len(self.data) - 1) // seq_len

    def batch_for_step(self, cfg, step, batch, device=None):
        idx = (step * batch + np.arange(batch)) % self.n_seqs
        starts = idx * self.seq
        toks = np.stack([self.data[s:s + self.seq + 1] for s in starts])
        toks = torch.as_tensor(toks.astype(np.int32), device=device)
        return {"inputs": toks[:, :-1], "labels": toks[:, 1:],
                "mask": torch.ones((batch, self.seq), dtype=torch.float32,
                                   device=device)}
