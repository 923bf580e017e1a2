"""Deterministic crash-point injection for the durability I/O paths —
the port's copy of the JAX package's ``durability/crashpoints.py`` (pure
Python; the port keeps its own registry, so the two packages' points
never mix).

A durability layer is only as crash-consistent as the WORST point a
process can die at, and "we fsync before rename" is a claim about
exactly those points. This module makes the claim testable: every
durability I/O boundary (the WAL's append/fsync/rotate steps, the
snapshot's write/rename/manifest/prune steps) registers a NAMED
crashpoint and calls :func:`hit` when execution crosses it. Normally
``hit`` is a counter tick; under :func:`armed` the named point raises
:class:`SimulatedCrash` ONCE — modelling a process killed mid-I/O with
everything already flushed to the OS durable, everything after the
point lost — and the fuzz loop (:func:`fuzz`) then runs recovery on
the surviving files and asserts bit-identity with the uninterrupted
run.

Design notes, stated plainly:

- **Crash = exception, flush = reached-the-OS.** An in-process
  "crash" cannot drop the page cache, so the simulation's fidelity
  contract is: bytes written BEFORE a crashpoint are flushed to the OS
  before ``hit`` is called (the WAL flushes before ``wal.mid_append``
  so the torn frame is really on disk), and nothing is written after
  the raise. What the simulation cannot model — a power loss eating
  OS-buffered-but-unfsynced pages — is covered instead by the
  fsync-policy detector (``wal.fsync_honored``), which proves the fsync
  calls actually happen at the promised boundaries; a WAL that never
  fsyncs must fail it.
- **One-shot arming.** A fired crashpoint disarms itself: recovery
  code crossing the same boundary (the torn-tail truncate is itself a
  write) must not crash again — the process restarted clean.
- **Registration is the coverage contract**: the fuzz matrix's first
  axis is :func:`registered`, and :func:`recording` collects the points
  a workload crossed, so a dead crashpoint (an I/O boundary the fuzz loop
  stopped exercising) shows. The 15 points of this package: ``wal.*`` ×6
  and ``snapshot.*`` ×9, with the JAX package's names and descriptions.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.metrics import metrics


class SimulatedCrash(BaseException):
    """The process died at crashpoint ``name``. Deliberately NOT an
    ``Exception``: durability code paths that soften errors to
    counters (``except Exception``) must not absorb a simulated kill —
    a real SIGKILL would not be absorbable either."""

    def __init__(self, name: str):
        super().__init__(f"simulated crash at crashpoint {name!r}")
        self.name = name


_REGISTRY: Dict[str, str] = {}
_lock = threading.Lock()
_armed: Optional[str] = None
_recorded: Optional[set] = None


def register(name: str, description: str) -> str:
    """Register a named crashpoint (module import time, next to the
    I/O code that hits it). Re-registration with the same description
    is idempotent; with a different one it is a naming collision."""
    with _lock:
        if _REGISTRY.get(name, description) != description:
            raise ValueError(
                f"crashpoint {name!r} already registered with a different "
                f"description"
            )
        _REGISTRY[name] = description
    return name


def registered() -> Tuple[str, ...]:
    """Every registered crashpoint name, sorted (the fuzz matrix's
    first axis)."""
    with _lock:
        return tuple(sorted(_REGISTRY))


def describe(name: str) -> str:
    with _lock:
        return _REGISTRY[name]


def hit(name: str) -> None:
    """Cross crashpoint ``name``: record it, and die (once) if armed.
    Unregistered names refuse loudly — a typo here would silently
    excuse the boundary from the whole fuzz matrix."""
    global _armed
    with _lock:
        if name not in _REGISTRY:
            raise KeyError(f"crashpoint {name!r} was never registered")
        if _recorded is not None:
            _recorded.add(name)
        fire = _armed == name
        if fire:
            _armed = None  # one-shot: the restarted process runs clean
    if fire:
        metrics.count(f"durability.crashpoint_fired.{name}")
        raise SimulatedCrash(name)


@contextlib.contextmanager
def armed(name: str):
    """Arm crashpoint ``name`` for the block (one-shot: the first hit
    fires and disarms). Leaving the block always disarms — a workload
    that never crossed the armed point must not leak the arming into
    the next one."""
    global _armed
    if name not in _REGISTRY:
        raise KeyError(f"crashpoint {name!r} was never registered")
    with _lock:
        prev, _armed = _armed, name
    try:
        yield
    finally:
        with _lock:
            _armed = prev


@contextlib.contextmanager
def recording():
    """Collect the set of crashpoints crossed inside the block (the
    coverage-contract probe). Yields the live set."""
    global _recorded
    with _lock:
        prev, _recorded = _recorded, set()
        live = _recorded
    try:
        yield live
    finally:
        with _lock:
            _recorded = prev


def fuzz(
    crash_run: Callable[[str], object],
    recover: Callable[[], Tuple[object, object]],
    equal: Callable[[object, object], bool],
    names: Optional[Tuple[str, ...]] = None,
) -> List[str]:
    """The kill-then-recover loop: for each crashpoint,
    run ``crash_run(name)`` with the point armed (it must actually die
    there — a survivor means the workload no longer crosses the
    boundary), then ``recover()`` the surviving files; it returns
    ``(got, want)`` — the recovered state and what the caller's
    invariant says it must equal (typically the last DURABLE record,
    which depends on where the kill landed) — compared with ``equal``.
    Returns failure strings (empty = green). ``crash_run`` owns fresh
    directories per call (a closure/box shared with ``recover``) —
    this loop owns only the protocol."""
    failures: List[str] = []
    for name in names or registered():
        try:
            with armed(name):
                crash_run(name)
        except SimulatedCrash as crash:
            if crash.name != name:
                failures.append(
                    f"{name}: crashed at {crash.name!r} instead"
                )
                continue
        else:
            failures.append(
                f"{name}: workload never crossed the armed crashpoint "
                f"(boundary no longer exercised — fuzz hole)"
            )
            continue
        try:
            got, want = recover()
        except Exception as exc:
            failures.append(
                f"{name}: recovery failed: {type(exc).__name__}: {exc}"
            )
            continue
        if not equal(got, want):
            failures.append(
                f"{name}: recovered state is NOT bit-identical to the "
                f"last durable record"
            )
    return failures


__all__ = [
    "SimulatedCrash", "armed", "describe", "fuzz", "hit", "recording",
    "register", "registered",
]
