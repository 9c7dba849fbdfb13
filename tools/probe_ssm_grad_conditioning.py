"""How far a reordered sum moves mamba2's first gradients, in float32
and in float64 compute.

    PYTHONPATH=src python tools/probe_ssm_grad_conditioning.py [--layers 2]
        [--batch 2] [--seq 512] [--device cpu]

mamba2-2.7b at full width, its depth cut, one batch of
``data.pipeline.synthetic_batch`` (the second half's last half masked,
as ``chip_smoke.py``'s phase 8g masks it), the weights from a seed.
Prints, for the leaves farthest off, max |g - g_ref| over max |g_ref|
of:

- the float32 gradients against those of the same model in float64
  (parameters and compute): float32's own error;
- the float32 gradients with the SSM's in-projection summed from four
  row blocks of ``w_in`` (the row-parallel projection of a (1, 4) mesh)
  against the plain float32 gradients;
- the same with the head's logits computed in four vocabulary blocks
  (the vocab-parallel head) alone;
- both reorderings in float64 compute (float32 parameters, the SSD scan
  in float32 as always, the logits and the loss in float64) against
  float64 compute without them.

Runs on the CPU in about two minutes with 8 threads (no card needed).
"""
import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import synthetic_batch  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.training import train_step as ts  # noqa: E402

SPLIT = 4


def _split_proj(p, x, cd, group):
    """``x @ w_in`` summed from ``SPLIT`` row blocks, in rank order."""
    w = p.w_in.to(cd)
    r = w.shape[0] // SPLIT
    out = None
    for i in range(SPLIT):
        part = torch.einsum("bsd,de->bse", x[..., i * r:(i + 1) * r],
                            w[i * r:(i + 1) * r])
        out = part if out is None else out + part
    return out


def _split_logits(p, cfg, x, head, group=None):
    """The tied head's logits in ``SPLIT`` vocabulary blocks."""
    x = p.ln_f(x)
    v = head.shape[0] // SPLIT
    return torch.cat([torch.einsum("bsd,vd->bsv", x,
                                   head[i * v:(i + 1) * v].to(x.dtype))
                      for i in range(SPLIT)], dim=-1).to(
        torch.promote_types(x.dtype, torch.float32))


def _grads(model, batch):
    for p in model.parameters():
        p.grad = None
    loss, _ = ts.loss_fn(model, model.cfg, batch)
    loss.backward()
    return {n: p.grad.detach().double().clone()
            for n, p in model.named_parameters()}


def _worst(got, want, k=3):
    rel = {n: float((got[n] - want[n]).abs().max()
                    / want[n].abs().max().clamp_min(1e-300)) for n in want}
    return ", ".join(f"{n} {e:.3e}" for n, e in
                     sorted(rel.items(), key=lambda kv: -kv[1])[:k])


def _with(patches, fn):
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, new in patches:
        setattr(mod, name, new)
    try:
        return fn()
    finally:
        for mod, name, old in saved:
            setattr(mod, name, old)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    base = dataclasses.replace(get_config("mamba2-2.7b"),
                               n_layers=args.layers)
    batch = synthetic_batch(base, 0, args.batch, args.seq, seed=93,
                            device=dev)
    batch["mask"][args.batch // 2:, args.seq // 2:] = 0.0
    proj = [(ssm, "_in_proj", _split_proj)]
    head = [(tf, "_logits", _split_logits)]
    print(f"mamba2-2.7b, {args.layers} layers, full width, batch "
          f"{args.batch} x {args.seq}, on {dev}; max |g - g_ref| / max "
          f"|g_ref|, the three leaves farthest off:")
    out = {}
    for compute in ("float32", "float64"):
        cfg = dataclasses.replace(base, compute_dtype=compute)
        model = tf.init_params(torch.Generator(dev).manual_seed(94), cfg)
        g = out[compute] = _grads(model, batch)
        if compute == "float32":
            print(f"  float32, rows of w_in in {SPLIT} blocks: "
                  + _worst(_with(proj, lambda: _grads(model, batch)), g))
            print(f"  float32, the head in {SPLIT} vocabulary blocks: "
                  + _worst(_with(head, lambda: _grads(model, batch)), g))
        else:
            print(f"  float64 compute, both reorderings: "
                  + _worst(_with(proj + head,
                                 lambda: _grads(model, batch)), g))
        del model
    cfg = dataclasses.replace(base, param_dtype="float64",
                              compute_dtype="float64")
    model = tf.init_params(torch.Generator(dev).manual_seed(94),
                           dataclasses.replace(base, compute_dtype="float64"))
    model = model.double()
    model.cfg = cfg
    for m in model.modules():
        if hasattr(m, "cfg"):
            m.cfg = cfg
    print(f"  float32 against float64 parameters and compute: "
          + _worst(out["float32"], _grads(model, batch)))


if __name__ == "__main__":
    main()
