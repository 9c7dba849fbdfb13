"""Architecture registry: ``--arch <id>`` -> config, shapes, applicability.

Counterpart of ``repro.configs``.  The ten LM configs are the reference's,
field for field; ``"flups-poisson"`` is the distributed Poisson solve's
``PoissonArchConfig`` (``configs.flups_poisson``), with the engine names
mapped to the port's.
"""
from __future__ import annotations

from dataclasses import dataclass
from importlib import import_module

_MODULES = {
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "minitron-8b": "minitron_8b",
    "glm4-9b": "glm4_9b",
    "starcoder2-7b": "starcoder2_7b",
    "qwen3-0.6b": "qwen3_0_6b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "mamba2-2.7b": "mamba2_2_7b",
    "whisper-medium": "whisper_medium",
    "paligemma-3b": "paligemma_3b",
    "flups-poisson": "flups_poisson",
}

LM_ARCHS = tuple(a for a in _MODULES if a != "flups-poisson")
ALL_ARCHS = tuple(_MODULES)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def _module(arch: str):
    return import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke(arch: str):
    return _module(arch).SMOKE


def arch_shapes(arch: str):
    """The shape cells defined for an architecture.

    ``long_500k`` needs sub-quadratic sequence mixing: run for ssm/hybrid
    only.  The flups-poisson arch uses its own grid, not the LM shapes.
    """
    if arch == "flups-poisson":
        return ()
    cfg = get_config(arch)
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        names.append("long_500k")
    return tuple(SHAPES[n] for n in names)
