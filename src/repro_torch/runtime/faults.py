"""Deterministic fault injection: the substrate of the chaos test suite.

Counterpart of ``repro.runtime.faults``, on tensors.  The stage names are
the reference's (``solve.dispatch``, ``fwd.<d>``, ``bwd.<d>``, ``green``;
in the distributed solve ``dist.dispatch``, ``comm.<strategy>`` before a
topology switch and the ``comm.wire.<strategy>`` taint on its payload),
except that the hand-kernel fail points of the ``"cuda"`` engine are
``cuda.fwd.<d>``, ``cuda.bwd.<d>`` and ``cuda.green``: the port's names
for the reference's ``pallas.*``.  Each rank of a distributed solve
polls its own plan, so a fault meant for the whole mesh is armed on
every rank.

A ``FaultPlan`` is a list of ``FaultSpec`` entries armed either by entering
the plan as a context manager or via the ``$REPRO_FAULTS`` environment
variable (a JSON list of spec dicts, or a path to a file holding one).
Production code is instrumented with three kinds of cheap hooks -- all of
them no-ops (one ``None`` check) when no plan is active:

``fail_point(stage)``
    Raises ``InjectedFault`` when a raising spec (kind ``error``,
    ``pallas_lowering``, ``device_loss`` or ``torn_write``) matches the
    hook's stage name.  Hooks sit at dispatch boundaries
    (``solve.dispatch``, ``cuda.fwd.<d>``, ``cuda.bwd.<d>``,
    ``cuda.green``), so an armed spec simulates a kernel failing to build
    or launch -- deterministically, at the same point every run.

``taint(stage, x)``
    Returns ``x`` with one entry overwritten by NaN/Inf (kinds ``nan`` /
    ``inf``) or perturbed by a finite delta (kind ``flip`` -- the silent-
    data-corruption model: a bit flip lands a wrong-but-finite value that
    ``verify="nan"`` is blind to).  Torch runs eagerly, so the hook polls
    the plan on every call of its stage (the reference's polls once per
    trace); ``count`` limits the firings either way.

``should_fire(kind, step=k)``
    Time-step poll (no raise): a time-stepping loop asks it whether
    a ``device_loss`` spec fires at step ``k``.

Spec matching is by ``fnmatch`` pattern over stage names, with ``after`` /
``count`` controlling which matching hits actually fire -- a ``count``-
limited spec models a transient fault (fires N times, then the retry
succeeds); ``count=-1`` models a hard fault that only a config downgrade
can route around (e.g. ``stage="cuda.*"`` disappears once the ladder
steps the engine down to ``"torch"``).

Every firing is appended to ``FaultPlan.log`` so tests can assert exactly
which faults fired where; ``firings()`` counts them, so the solver can
tell a failure an armed fault caused from a real one.
"""
from __future__ import annotations

import fnmatch
import json
import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["InjectedFault", "FaultSpec", "FaultPlan", "armed", "active",
           "firings", "fail_point",
           "taint", "taint_host", "should_fire", "mangle_cache_entry",
           "plan_token", "plan_from_env", "suppressed"]

# raising kinds (fail_point); "stall" wedges the hook (sleeps ``seconds``)
# instead of raising -- the model of a hung collective / stuck worker;
# value kinds (taint) are "nan" / "inf" / "flip"; "corrupt_cache" is
# consumed by ``mangle_cache_entry``.  "pallas_lowering" keeps the
# reference's name: it is the kind of a kernel that fails to build
RAISING_KINDS = ("error", "pallas_lowering", "device_loss", "torn_write",
                 "stall")
VALUE_KINDS = ("nan", "inf", "flip")
KINDS = RAISING_KINDS + VALUE_KINDS + ("corrupt_cache",)


class InjectedFault(RuntimeError):
    """A fault raised by ``fail_point`` -- carries stage provenance and the
    transient flag the retry policy consults."""

    def __init__(self, stage: str, kind: str, transient: bool = False):
        super().__init__(f"injected {kind} fault at stage {stage!r}")
        self.stage = stage
        self.kind = kind
        self.transient = transient


@dataclass
class FaultSpec:
    """One armed fault.

    ``stage``: fnmatch pattern over hook stage names ("*" = everywhere).
    ``after``: skip this many matching hits before the first firing.
    ``count``: fire at most this many times (-1 = every matching hit).
    ``step``:  time-step faults (``should_fire``) only fire when the
               polled step equals this (None = any step).
    ``transient``: mark raised faults retryable (the backoff path) instead
               of degradation-worthy.
    ``seconds``: ``stall`` kinds only -- how long the hook wedges.
    """

    kind: str
    stage: str = "*"
    after: int = 0
    count: int = 1
    step: int | None = None
    transient: bool = False
    seconds: float = 30.0
    hits: int = field(default=0, compare=False)
    fired: int = field(default=0, compare=False)

    def __post_init__(self):
        assert self.kind in KINDS, self.kind

    def _matches(self, stage: str) -> bool:
        return fnmatch.fnmatchcase(stage, self.stage)

    def _fire(self) -> bool:
        """Advance the hit counter; True when this hit fires."""
        self.hits += 1
        if self.hits <= self.after:
            return False
        if self.count >= 0 and self.fired >= self.count:
            return False
        self.fired += 1
        return True


class FaultPlan:
    """A deterministic set of armed faults; also a context manager."""

    def __init__(self, specs=()):
        self.specs = [s if isinstance(s, FaultSpec) else FaultSpec(**s)
                      for s in specs]
        self.log: list[dict] = []
        self._lock = threading.Lock()
        self._token = next(_TOKENS)

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self):
        _push(self)
        return self

    def __exit__(self, *exc):
        _pop(self)
        return False

    # -- matching ----------------------------------------------------------
    def _poll(self, stage: str, kinds, step=None):
        """First matching spec that fires at this hit, or None."""
        with self._lock:
            for s in self.specs:
                if s.kind not in kinds or not s._matches(stage):
                    continue
                if s.step is not None and s.step != step:
                    continue
                if s._fire():
                    self.log.append({"stage": stage, "kind": s.kind,
                                     "step": step, "hit": s.hits})
                    return s
        return None


_TOKENS = iter(range(1, 1 << 62))
_ACTIVE: list[FaultPlan] = []
_STACK_LOCK = threading.Lock()


def _push(plan: FaultPlan):
    with _STACK_LOCK:
        _ACTIVE.append(plan)


def _pop(plan: FaultPlan):
    with _STACK_LOCK:
        if plan in _ACTIVE:
            _ACTIVE.remove(plan)


def plan_from_env(env: str = "REPRO_FAULTS") -> FaultPlan | None:
    """Build (and activate) a plan from ``$REPRO_FAULTS``: a JSON list of
    FaultSpec dicts, or a path to a JSON file holding one.  Returns None
    when the variable is unset/empty.  The caller owns deactivation (use
    the returned plan as a context manager)."""
    raw = os.environ.get(env, "").strip()
    if not raw:
        return None
    if not raw.startswith("["):
        with open(raw) as fh:
            raw = fh.read()
    return FaultPlan(json.loads(raw))


_SUPPRESS = threading.local()


class suppressed:
    """Context manager making ``fail_point``/``taint`` no-ops on this
    thread: a check that re-runs a stage to build the reference side of a
    comparison must not let an armed spec fire on that side too (it would
    corrupt both sides identically and hide the fault)."""

    def __enter__(self):
        self._prev = getattr(_SUPPRESS, "on", False)
        _SUPPRESS.on = True
        return self

    def __exit__(self, *exc):
        _SUPPRESS.on = self._prev
        return False


def _suppressed() -> bool:
    return getattr(_SUPPRESS, "on", False)


def armed() -> bool:
    """True when any plan is armed: the hooks' one check on the hot path
    (they build no stage name and poll nothing while it is False)."""
    return bool(_ACTIVE)


def active() -> FaultPlan | None:
    """The innermost armed plan, or None (no plan armed: one list check)."""
    if not _ACTIVE or _suppressed():
        return None
    return _ACTIVE[-1]


def firings() -> int:
    """How many faults the innermost armed plan has fired (0 when none is
    armed): the solver compares it around an attempt to tell an injected
    failure from a real one."""
    return len(_ACTIVE[-1].log) if _ACTIVE else 0


def plan_token():
    """Identity of the active plan (None when inactive) -- mixed into the
    ``get_solver`` cache key so solvers built under an armed plan are
    never served to fault-free callers."""
    p = _ACTIVE[-1] if _ACTIVE else None
    return None if p is None else p._token


def fail_point(stage: str):
    """Raise ``InjectedFault`` when a raising spec matches this stage; a
    ``stall`` spec wedges the hook for ``spec.seconds`` instead (modelling
    a hung collective or stuck worker thread)."""
    p = active()
    if p is None:
        return
    s = p._poll(stage, RAISING_KINDS)
    if s is None:
        return
    if s.kind == "stall":
        time.sleep(s.seconds)
        return
    raise InjectedFault(stage, s.kind, transient=s.transient)


def _flip_delta(mod, flat):
    # finite SDC model: a high-bit flip perturbs one scalar by well above
    # the block's dynamic range (8*max + 1 keeps it finite yet decisive)
    return 8.0 * mod.max(mod.abs(flat)) + 1.0


def taint(stage: str, x):
    """Corrupt one entry of the tensor ``x`` when a value spec matches.
    ``nan``/``inf`` overwrite; ``flip`` adds a finite out-of-range delta.
    Returns a corrupted copy (the caller's tensor is never written), or
    ``x`` itself when nothing fires."""
    p = active()
    if p is None:
        return x
    s = p._poll(stage, VALUE_KINDS)
    if s is None:
        return x
    out = x.clone(memory_format=torch.contiguous_format)
    flat = out.view(-1)
    if s.kind == "flip":
        flat[0] += _flip_delta(torch, flat)
    else:
        flat[0] = float("inf") if s.kind == "inf" else float("nan")
    return out


def taint_host(stage: str, arr):
    """Host-side (numpy) variant of ``taint`` for data read back from disk
    (checkpoint leaves): models storage rot between save and restore."""
    p = active()
    if p is None:
        return arr
    s = p._poll(stage, VALUE_KINDS)
    if s is None:
        return arr
    out = np.array(arr)  # private copy; never rot the caller's buffer
    flat = out.reshape(-1)
    if s.kind == "flip":
        flat[0] += np.asarray(_flip_delta(np, flat), dtype=out.dtype)
    else:
        flat[0] = np.inf if s.kind == "inf" else np.nan
    return out


def should_fire(kind: str, step=None, stage: str = "step") -> bool:
    """Time-step poll (device loss at step k); never raises."""
    p = active()
    if p is None:
        return False
    return p._poll(stage, (kind,), step=step) is not None


def mangle_cache_entry(data: dict, stage: str = "autotune.cache"):
    """Corrupt a loaded cache dict in place when a ``corrupt_cache`` spec
    matches -- models on-disk cache rot; the loader must survive it (fall
    through to a live measurement)."""
    p = active()
    if p is None:
        return data
    s = p._poll(stage, ("corrupt_cache",))
    if s is not None and data:
        for k in data:
            data[k] = {"strategy": "bogus-strategy", "n_chunks": "NaN"}
    return data
