"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

Each wrapper launches its kernel on a CUDA tensor and counts the launch in
``LAUNCHES``; on a CPU tensor it runs the kernel's plain PyTorch version
(``ref``), which follows the kernel's algorithm step by step.
"""
from ._build import LAUNCHES, TWO_PASS, reset_launches  # noqa: F401

__all__ = ["LAUNCHES", "TWO_PASS", "reset_launches"]
