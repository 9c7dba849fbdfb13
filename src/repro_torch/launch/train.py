"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/run1 \
        --device cpu

Counterpart of ``repro.launch.train``, with its flags and ``[train]``
lines, plus ``--device``: the card unless the caller names another, and
without a card it raises rather than train on the CPU.

  * checkpoint every --ckpt-every steps (atomic, keep-last-k) through
    ``repro_torch.ckpt.checkpoint`` in the reference's stacked leaf order
    and shapes (``models.convert``), so either package's launcher resumes
    the other's checkpoint,
  * automatic resume from the latest step in --ckpt-dir,
  * fault injection (--fail-at N simulates a crash; relaunching resumes),
  * straggler detection: per-step wall time is tracked against a rolling
    median; outliers are logged with the step re-issued data-identically
    (the pipeline is stateless, see repro_torch/data/pipeline.py),
  * optional int8 error-feedback gradient compression (--compress).

The model initialises from ``torch.Generator`` seed 0 on the device and
trains on ``synthetic_batch`` tokens; no weights or data are read.
``main`` returns the final ``TrainState`` with a record of the run as its
``record`` attribute: the device, the first step, per step the loss,
``grad_norm`` and wall time, and the seconds of each checkpoint save and
of the restore (the conversion included).  The ``SystemExit`` raised at
``--fail-at`` carries the same record as its ``record``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ck
from repro_torch.configs import get_config, get_smoke
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.models import convert
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import make_train_state, train_step_fn


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch.launch.train runs on the GPU by default, and torch "
            "finds no CUDA device; pass --device cpu to train on the CPU")
    return dev


def _synced(dev, t0) -> float:
    """Seconds since ``t0`` once ``dev`` has finished its queued work."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="simulate a crash after this step")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--comm", default="a2a")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; raises without "
                         "one)")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    dev = _resolve_device(args.device)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    adam = opt.AdamWConfig(
        lr=args.lr, total_steps=args.steps,
        warmup=min(20, args.steps // 10 + 1),
        grad_compress="int8" if args.compress else "none")

    start, restore_s = 0, None
    latest = ck.latest_step(args.ckpt_dir) if args.ckpt_dir else None
    if latest is not None:
        t0 = time.perf_counter()
        tree = ck.restore(args.ckpt_dir, latest,
                          convert.reference_like(cfg, args.compress))
        state = convert.from_reference(tree, cfg, dev)
        del tree
        restore_s = _synced(dev, t0)
        start = latest
        print(f"[train] resumed from step {latest}")
    else:
        state = make_train_state(torch.Generator(dev).manual_seed(0), cfg,
                                 adam=adam)

    # the local path runs no topology switch, so --comm selects nothing yet
    step_fn = train_step_fn(cfg, adam=adam)
    record = {"device": str(dev), "start": start, "steps": [], "loss": [],
              "grad_norm": [], "seconds": [], "save_seconds": [],
              "restore_seconds": restore_s}
    times = []
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        batch = synthetic_batch(cfg, step, args.batch, args.seq,
                                device=dev)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])        # waits for the device
        dt = time.perf_counter() - t0
        times.append(dt)
        for k, v in (("steps", step), ("loss", loss), ("seconds", dt),
                     ("grad_norm", float(metrics["grad_norm"]))):
            record[k].append(v)
        med = float(np.median(times[-20:]))
        if len(times) > 5 and dt > 3.0 * med:
            print(f"[train] STRAGGLER step {step}: {dt:.2f}s vs median "
                  f"{med:.2f}s (stateless pipeline -> safe to re-issue)")
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step}  loss {loss:.4f}"
                  f"  gnorm {float(metrics['grad_norm']):.3f}"
                  f"  lr {float(metrics['lr']):.2e}  {dt:.2f}s")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            t0 = time.perf_counter()
            ck.save(args.ckpt_dir, step + 1, convert.to_reference(state))
            record["save_seconds"].append(time.perf_counter() - t0)
        if args.fail_at is not None and step + 1 >= args.fail_at:
            crash = SystemExit(f"[train] simulated failure at step "
                               f"{step + 1} -- relaunch to resume")
            crash.record = record
            raise crash
    print("[train] done")
    state.record = record
    return state


if __name__ == "__main__":
    main()
