"""flups_poisson: the paper's own workload as a selectable architecture --
a distributed unbounded Poisson solve on the production mesh (the FFT side
of the framework, run through the same dry-run/roofline machinery).

Counterpart of ``repro.configs.flups_poisson``, field for field, with the
engine names mapped: the reference's ``"xla"`` is ``"torch"`` here
(``torch.fft``, cuFFT on the card) and its ``"pallas"`` is ``"cuda"``
(the hand kernels)."""
from dataclasses import dataclass

from repro_torch.core.bc import BCType, DataLayout
from repro_torch.core.green import GreenKind

ARCH = "flups-poisson"


@dataclass(frozen=True)
class PoissonArchConfig:
    name: str
    n: int                      # cells per direction (global)
    layout: DataLayout
    bcs: tuple
    green: str
    batch: int = 1              # fields solved per step (data parallel)
    engine: str = "torch"       # transform engine: "torch" | "cuda"
    # Hockney doubling placement for the unbounded dirs: "deferred" (pruned
    # transforms + valid-extent topology switches, DESIGN.md #8) or
    # "upfront" (dense textbook baseline kept for A/B runs)
    doubling: str = "deferred"
    # data-layout policy (DESIGN.md #9): "scheduled" (plan-time layout
    # schedule; relayouts folded into the topology-switch unpack, zero
    # standalone transposes between stages) or "baseline" (per-direction
    # moveaxis round trips, the A/B reference)
    relayout: str = "scheduled"
    # topology-switch communication (DESIGN.md #2), applied whenever the
    # launcher passes the stock default strategy:
    # "a2a" | "pipelined" | "fused" | "overlap" | "auto" (plan-time tuner)
    comm: str = "a2a"
    comm_chunks: int = 2        # pipelined/overlap granularity (n_batch)
    # autotuner cache knobs (comm="auto"): winners are cached in-process per
    # (shape, bcs, layout, mesh) key; a non-empty path (or $REPRO_COMM_CACHE)
    # persists them as JSON so later processes skip the timing sweep
    comm_autotune_cache: str = ""
    comm_autotune_max_chunks: int = 4   # sweep n_chunks in {2, 4, ...}
    # comm="auto" candidate policy (DESIGN.md #12): "guided" ranks the
    # candidate space with the analytic cost model and wall-clock times
    # only the shortlisted frontier (~1/6 of the space); "brute" sweeps
    # every candidate (the oracle reference the guided mode is gated on)
    comm_autotune_search: str = "guided"
    # per-candidate wall-clock budget for the comm="auto" sweep, seconds
    # (0 = unlimited, or $REPRO_COMM_BUDGET); one pathological candidate
    # must never stall plan construction -- it is skipped and recorded in
    # the solver's autotune census (DESIGN.md #10)
    comm_autotune_budget_s: float = 0.0
    # numerical health guard armed on every solve (DESIGN.md #10):
    # "" (off) | "nan" (finiteness) | "residual" (finiteness + FD residual)
    # | "abft" (per-stage checksum invariants with inline selective
    # recompute and wire/compute attribution -- DESIGN.md #13)
    verify: str = ""
    verify_rtol: float = 0.5
    # ABFT mismatch tolerance; 0.0 = auto per dtype (runtime.abft.tol_for)
    abft_rtol: float = 0.0


U = (BCType.UNB, BCType.UNB)

CONFIG = PoissonArchConfig(
    # 2048^3 global cells: ~2.1 GB/chip on the doubled spectral domain at
    # 256 chips -- a production-plausible per-chip load (paper: 96^3/core)
    name=ARCH, n=2048, layout=DataLayout.NODE, bcs=(U, U, U),
    green=GreenKind.CHAT2, batch=2,
)

SMOKE = PoissonArchConfig(
    name=ARCH + "-smoke", n=16, layout=DataLayout.NODE, bcs=(U, U, U),
    green=GreenKind.CHAT2, batch=1,
)
