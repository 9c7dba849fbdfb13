"""Run ``chip_smoke.py``'s phase 8h (the dry run) alone on the card.

    python3 tools/probe_dryrun_phase.py

Builds the kernels, then calls ``chip_smoke._dryrun_phase`` with a launch
counter like ``chip_smoke.main``'s: the dry-run CLI's cells in
subprocesses on fake ranks, the flups-poisson cell's solver at
``DRY_N`` on a one-rank NCCL mesh against its dry run, and the measured
bf16 matmul and copy rates.  Phase 8e does not run here, so the line
that divides its step's counted FLOPs by its time reads nan.
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import LAUNCHES, _build, reset_launches  # noqa: E402


def run_counted(run, fn):
    """``fn()`` with the launch counts set to 0 just before and read just
    after; they must be ``chip_smoke.EXPECTED[run]``."""
    torch.cuda.synchronize()
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    got = {k: v for k, v in counts.items() if v}
    if got != cs.EXPECTED[run]:
        raise AssertionError(f"{run}: launches {got}, expected "
                             f"{cs.EXPECTED[run]}")
    return out, counts


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, sys.version.split()[0])
    t0 = time.time()
    _build.build()
    _build.library()
    print(f"build {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    cs._dryrun_phase(torch.device("cuda"), smi, run_counted, float("nan"))
    print(f"probe {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
