"""PyTorch + CUDA port of the FLUPS Poisson solver (``repro``).

The single-process solve for plans with unbounded and periodic directions
runs end to end on one NVIDIA GPU: ``torch.fft`` (cuFFT on the card) on
the ``"torch"`` engine, hand-written CUDA kernels for the Stockham FFT,
the fused FFT x Green pass and the spectral scale on the ``"cuda"``
engine (the default).  The package imports no JAX and nothing of
``repro``; its tests hold it against ``repro`` on the same inputs.
"""
from .core.solver import PoissonSolver, make_plan  # noqa: F401

__all__ = ["PoissonSolver", "make_plan"]
