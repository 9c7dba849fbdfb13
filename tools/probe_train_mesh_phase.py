"""Run ``chip_smoke.py``'s phase 8g (LM training on a mesh) alone on the
card.

    python3 tools/probe_train_mesh_phase.py

Calls ``chip_smoke._lm_train_mesh_phase`` with TF32 off, as
``chip_smoke.main`` sets it: the one-process runs, then four gloo ranks
spawned on the card (the sharded dense legs, the tensor-parallel leg,
the MoE leg), every check of the phase and its printed lines.  No
kernel is built: the phase runs none.
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

if __name__ == "__main__":
    import torch

    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    t = time.perf_counter()
    cs._lm_train_mesh_phase(torch.device("cuda"), smi)
    print(f"phase 8g alone: {time.perf_counter() - t:.1f} s", flush=True)
