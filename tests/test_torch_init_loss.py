"""The step-0 loss of the gemma-style models at their full width: the
port's == the reference's from the same parameters.

recurrentgemma-9b and paligemma-3b tie their embedding and scale it by
sqrt(d_model) on the way in.  At initialisation the scaled embedding
dominates the residual stream, so a position's largest logit is that of
its own input token and the loss of a next-token label starts far above
ln(vocab), near the loss of the same parameters with every block skipped
(the "embedding-only" loss).  ``chip_smoke.py`` therefore bounds these
two models' step-0 loss by [ln(vocab) - 2, embedding-only + 2] rather
than by ln(vocab) +- 2.  This file holds that band to the reference: at
full d_model, cut in depth as the smoke cuts them (one (rec, rec, attn)
group; four decoder layers), the port's step-0 loss equals ``repro``'s
from the same converted parameters and tokens, and the reference's own
loss lies in the band and above ln(vocab) + 2.

The vocabulary is cut to 2^15 rows so that the tied embedding (4.2 GB
at recurrentgemma-9b's full 256000 x 4096) and the logits' copies of it
fit a CPU test; a position's logits keep their full-width arithmetic,
and the own-token logit that sets the loss does not depend on the row
count.  Default (bfloat16) compute, as the smoke trains them; tolerance
2e-2 relative (bfloat16 rounding of 4096-wide sums, in another order).
"""
import dataclasses
import gc
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.models import transformer as rtf

from repro_torch.configs import get_config
from repro_torch.models import convert
from repro_torch.models import transformer as tf
from repro_torch.training import train_step as ts

TOL = 2e-2
VOCAB = 2 ** 15
# (arch, the smoke's depth cut, batch, seq)
CASES = [("recurrentgemma-9b", 3, 1, 32), ("paligemma-3b", 4, 1, 32)]


def _ref_loss(params, cfg, batch, skip_blocks=False):
    """The reference's loss (``repro.training.train_step.loss_fn``'s
    arithmetic), or with ``skip_blocks`` its embedding-only loss."""
    if skip_blocks:
        x, _ = rtf._embed_in(params, cfg, batch["inputs"],
                             batch.get("frontend"))
        logits = rtf._logits(params, cfg, x)
    else:
        logits, _ = rtf.forward(params, cfg, batch["inputs"],
                                batch.get("frontend"))
    logits = logits[:, -batch["labels"].shape[1]:]
    gold = jnp.take_along_axis(logits, batch["labels"][..., None], -1)
    return float((jax.nn.logsumexp(logits, -1) - gold[..., 0]).mean())


def _to_jax(tree):
    """A numpy tree as JAX arrays sharing the numpy buffers."""
    return jax.tree.map(lambda a: jnp.from_dlpack(
        torch.from_numpy(np.ascontiguousarray(a))), tree)


@pytest.mark.parametrize("arch,layers,b,s", CASES)
def test_gemma_step0_loss_matches_reference_at_full_width(arch, layers, b,
                                                          s):
    cut = {"n_layers": layers, "vocab": VOCAB}
    cfg = dataclasses.replace(get_config(arch), **cut)
    rcfg = dataclasses.replace(ref_config(arch), **cut)
    assert (cfg.d_model, cfg.vocab) == (rcfg.d_model, rcfg.vocab)
    with torch.no_grad():
        model = tf.init_params(torch.Generator().manual_seed(0), cfg)
        rng = np.random.default_rng(0)
        toks = rng.integers(0, cfg.vocab, (b, s + 1), dtype=np.int32)
        batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:],
                 "mask": np.ones((b, s), np.float32)}
        if cfg.n_frontend_tokens:
            batch["frontend"] = rng.standard_normal(
                (b, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        got, _ = ts.loss_fn(model, cfg, tb)
        got = float(got)
        tree = _to_jax(convert.to_reference(model))
        del model
        gc.collect()
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        want = _ref_loss(tree, rcfg, jb)
        skip = _ref_loss(tree, rcfg, jb, skip_blocks=True)
    lnv = math.log(cfg.vocab)
    print(f"{arch} ({layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab}, batch {b} x seq {s}): step-0 loss port {got:.4f}, "
          f"repro {want:.4f} (relative {abs(got - want) / want:.2e}); "
          f"repro's embedding-only loss {skip:.4f}; ln V {lnv:.4f}")
    assert abs(got - want) <= TOL * want
    assert want > lnv + 2.0
    assert lnv - 2.0 <= want <= skip + 2.0
