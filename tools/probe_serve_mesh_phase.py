"""Run ``chip_smoke.py``'s phase 8f (LM serving) alone on the card.

    python3 tools/probe_serve_mesh_phase.py

Calls ``chip_smoke._lm_serve_phase`` with TF32 off, as
``chip_smoke.main`` sets it: qwen3-0.6b served at its full config, the
other families at a cut depth, the smoke configs on the card against
the host CPU, then four gloo ranks spawned on the card (ring attention,
the expert-parallel MoE, and the sharded serving legs of
``LM_SHARD_LEGS``: tensor parallelism on (1, 4), FSDP on (4, 1), both on
(2, 2)), every check of the phase and its printed lines.  No kernel is
built: the phase runs none.
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
    cs._lm_serve_phase(torch.device("cuda"), smi)
    print(f"phase 8f alone: {time.perf_counter() - t:.1f} s", flush=True)
