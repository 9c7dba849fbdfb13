"""PyTorch + CUDA port of the FLUPS Poisson solver (``repro``).

The single-process solve runs end to end on one NVIDIA GPU for every BC
mix (unbounded, periodic, even/odd symmetric, semi-unbounded): ``torch.fft``
(cuFFT on the card) on the ``"torch"`` engine, hand-written CUDA kernels
for the Stockham FFT, the fused FFT x Green and FFT x twiddle passes, the
spectral scale and the r2r twiddle on the ``"cuda"`` engine (the default).
``BiotSavartSolver`` solves ``lap(u) = curl(w)`` for a vortex method;
``get_solver`` is the construct-or-fetch plan cache a time-stepper calls
every step.  ``PoissonSolver.solve`` runs under the resilient runtime
(``repro_torch.runtime``): the ``verify=`` health guards, retries and the
degradation ladder (``cuda -> torch`` for injected faults only,
``scheduled -> baseline``, ``deferred -> upfront``), ending in
``SolveError``; ``BiotSavartSolver.solve`` does not yet, as in
``repro``.  ``DistributedPoissonSolver`` is the pencil-distributed solve
over a ``torch.distributed`` ``DeviceMesh`` (the four comm strategies of
``core.comm`` on each mesh axis's process group); ``get_solver(mesh=...)``
builds and caches it.  ``repro_torch.plan`` is the plan space, the cost
model and the guided search: ``comm="auto"`` times only the cost model's
shortlist by default, and ``plan.search_plan`` searches mesh shape,
order, relayout and radix on top of it.  ``PoissonServer`` serves
solves to many tenants: requests whose ``PlanSpec`` freeze to one key
coalesce into one batched solve, from a warm pool of solvers under a
memory budget (``repro_torch.serve``; ``python -m
repro_torch.launch.serve`` drives it with threaded clients).
``python -m repro_torch.launch.solve`` is the paper's workload on a grid
of ranks, with the survivable ``--ckpt`` loop over
``repro_torch.ckpt.checkpoint``.  The LM substrate's training path
is ported too: ``repro_torch.configs`` (the ten LM configs),
``repro_torch.models`` (``Transformer(cfg)`` and the converter from and
to the reference's parameter trees), ``repro_torch.training`` (AdamW
with int8 error feedback, the train step), ``repro_torch.data`` and
``python -m repro_torch.launch.train``.  The
package imports no JAX and nothing of ``repro``; its tests hold it
against ``repro`` on the same inputs.
"""
from .core.biot_savart import BiotSavartSolver  # noqa: F401
from .core.comm import CommConfig  # noqa: F401
from .core.solver import (PoissonSolver, evict_solver_entries,  # noqa: F401
                          get_solver, make_plan)
from .distributed.pencil import DistributedPoissonSolver  # noqa: F401
from .runtime import SolveError  # noqa: F401
from .serve import PlanSpec, PoissonServer  # noqa: F401

__all__ = ["BiotSavartSolver", "CommConfig", "DistributedPoissonSolver",
           "PlanSpec", "PoissonServer", "PoissonSolver", "SolveError",
           "evict_solver_entries", "get_solver", "make_plan"]
