"""Graceful-degradation ladder + retry policy (DESIGN.md #10).

Counterpart of ``repro.runtime.resilience``.  Every configurable fast path
of the solve has a documented slower-but-safer fallback; on failure the
runtime walks them one knob at a time:

    retry (bounded exponential backoff, transient errors only)
      -> engine    cuda      -> torch      (injected hand-kernel faults
                                            only; torch.fft is cuFFT on
                                            the card, never the kernels'
                                            plain versions)
      -> comm      overlap   -> pipelined -> a2a   (collective faults)
                   fused     -> pipelined
      -> relayout  scheduled -> baseline   (fused-transpose faults)
      -> doubling  deferred  -> upfront    (pruned-extent faults)

Only the distributed solver's config has a ``comm`` knob; single-process
configs skip those rungs.  Each downgrade is recorded as a structured dict in the solver's
``stats["degradations"]`` (and warned once); when the ladder is exhausted,
or the caller's ``may_degrade`` refuses the next rung, a ``SolveError``
carrying the stage provenance and the full degradation trail is raised.
The ladder is deliberately one-directional and monotonic: a solve only
ever gets more conservative, so a deterministic fault is routed around in
at most ``len(ladder)`` rebuilds and the result -- all rungs are
numerically equivalent pipelines -- matches the fault-free baseline.
"""
from __future__ import annotations

import random
import time
import warnings
from dataclasses import dataclass

__all__ = ["SolveError", "LADDER", "next_rung", "is_transient",
           "run_with_ladder", "reset_warn_once"]


# knob -> (from, to) downgrades, walked in priority order; one downgrade
# per failed attempt (the "step down one rung" contract)
LADDER = (
    ("engine",   (("cuda", "torch"),)),
    ("comm",     (("overlap", "pipelined"), ("fused", "pipelined"),
                  ("pipelined", "a2a"))),
    ("relayout", (("scheduled", "baseline"),)),
    ("doubling", (("deferred", "upfront"),)),
)


class SolveError(RuntimeError):
    """Terminal solve failure: the ladder is exhausted (or the error is not
    one a config downgrade can address).  Carries the failing stage, the
    final config, and the structured degradation trail."""

    def __init__(self, msg: str, *, stage=None, config=None,
                 degradations=()):
        super().__init__(msg)
        self.stage = stage
        self.config = dict(config or {})
        self.degradations = list(degradations)


@dataclass(frozen=True)
class _RetryPolicy:
    """Bounded exponential backoff for transient failures (the whole-solve
    budget: ``retries`` attempts across all rungs).  Each delay is drawn
    uniformly from ``[base_delay, 3 * previous_delay]`` capped at
    ``max_delay`` (the AWS decorrelated-jitter schedule, the reference's
    default) so co-batched tenants that trip on the same transient do NOT
    retry in lockstep.  ``seed`` pins the jitter RNG (tests); None draws
    it from entropy."""

    retries: int = 2
    base_delay: float = 0.05
    max_delay: float = 1.0
    seed: int | None = None


_DEFAULT_POLICY = _RetryPolicy()


def next_rung(cfg: dict):
    """One downgrade below ``cfg``: ``(new_cfg, action)`` or None when the
    config is already fully conservative."""
    for knob, downs in LADDER:
        cur = cfg.get(knob)
        for frm, to in downs:
            if cur == frm:
                new = dict(cfg)
                new[knob] = to
                return new, f"{knob}:{frm}->{to}"
    return None


# substrings marking an execution error as transient (retry-worthy) when it
# does not carry an explicit ``transient`` attribute -- the runtime-level
# statuses a fleet surfaces for preemptions and flaky links
_TRANSIENT_MARKERS = ("RESOURCE_EXHAUSTED", "UNAVAILABLE",
                      "DEADLINE_EXCEEDED", "ABORTED")


def is_transient(e: BaseException) -> bool:
    t = getattr(e, "transient", None)
    if t is not None:
        return bool(t)
    msg = str(e)
    return any(m in msg for m in _TRANSIENT_MARKERS)


_WARNED: set = set()


def _warn_once(msg: str):
    if msg not in _WARNED:
        _WARNED.add(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)


def reset_warn_once():
    """Re-arm the one-shot degradation warnings: a long-lived process
    (a server, a test session) must be able to see them again.  Called
    from ``solver.clear_solver_cache`` and the test fixtures."""
    _WARNED.clear()


def run_with_ladder(attempt, *, config: dict, reconfigure, stats: dict,
                    may_degrade=None, policy: _RetryPolicy = None,
                    sleep=time.sleep):
    """Run ``attempt()`` under the degradation ladder.

    ``attempt()`` performs one full try (dispatch + optional verify) under
    the CURRENT config and raises on failure.  ``reconfigure(cfg)``
    rebuilds the solver's pipeline for ``cfg`` -- it is also invoked for
    transient retries with the unchanged config (the analogue of
    re-establishing a collective after a link blip).  ``may_degrade(exc,
    action)`` may refuse a rung for a failure (the solver refuses the
    engine rung for every failure that no armed fault injected); a refused
    rung raises ``SolveError`` at once.  Returns the first successful
    attempt's result; raises ``SolveError`` when the ladder is exhausted.
    """
    policy = policy or _DEFAULT_POLICY
    cfg = dict(config)
    retries_left = policy.retries
    delay = policy.base_delay
    # the jitter RNG is drawn at the first retry: seeding one from entropy
    # is a syscall, and the happy path retries nothing
    rng = None
    records = stats.setdefault("degradations", [])
    while True:
        try:
            return attempt()
        except SolveError:
            raise
        except Exception as e:  # noqa: BLE001 -- every failure walks the ladder
            stage = getattr(e, "stage", None) or "solve"
            if is_transient(e) and retries_left > 0:
                retries_left -= 1
                stats["retries"] = stats.get("retries", 0) + 1
                _warn_once(f"solve: transient failure at {stage} "
                           f"({type(e).__name__}); retrying with backoff")
                sleep(delay)
                if rng is None:
                    rng = random.Random(policy.seed)
                delay = min(policy.max_delay,
                            rng.uniform(policy.base_delay,
                                        max(delay, policy.base_delay) * 3.0))
                reconfigure(dict(cfg))
                continue
            nxt = next_rung(cfg)
            if nxt is None:
                why = "the ladder exhausted"
            elif may_degrade is not None and not may_degrade(e, nxt[1]):
                why = f"{nxt[1]} refused"
                nxt = None
            if nxt is None:
                raise SolveError(
                    f"solve: failed at stage {stage!r} with {why} "
                    f"(config {cfg}): {e!r}",
                    stage=stage, config=cfg, degradations=records) from e
            cfg, action = nxt
            rec = {"stage": stage, "action": action,
                   "error": f"{type(e).__name__}: {e}"[:300],
                   "config": dict(cfg)}
            records.append(rec)
            _warn_once(f"solve: degrading {action} after failure at "
                       f"stage {stage!r} ({type(e).__name__})")
            reconfigure(dict(cfg))
