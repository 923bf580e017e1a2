"""Process-global host metrics registry (counters and gauges).

The part of the JAX package's ``utils/metrics.py`` that the dense ORSWOT
model feeds: ``metrics.count(name, n)`` for monotonic counters (e.g.
``orswot.merges``), ``metrics.observe(name, value)`` for last/min/max/
sum/n gauges (e.g. ``orswot.deferred_depth``), ``metrics.time(name)``
for the ``<name>_seconds`` wall-clock gauge of a block, and
``snapshot()`` to read them (``reset()`` clears them); ``state_nbytes``
prices a state, and ``deferred_depth`` / ``observe_depth`` read the live
parked-slot depth the mesh entries and streams record. Host-side only;
no kernel touches it.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict

import torch


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, Dict[str, float]] = {}

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            g = self._gauges.setdefault(
                name, {"last": 0.0, "min": float("inf"), "max": float("-inf"),
                       "sum": 0.0, "n": 0},
            )
            g["last"] = value
            g["min"] = min(g["min"], value)
            g["max"] = max(g["max"], value)
            g["sum"] += value
            g["n"] += 1

    @contextlib.contextmanager
    def time(self, name: str):
        """Observe the block's wall-clock seconds as ``<name>_seconds``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(f"{name}_seconds", time.perf_counter() - t0)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": {k: dict(v) for k, v in self._gauges.items()},
            }


metrics = Metrics()


def state_nbytes(state) -> int:
    """Total bytes of a state's tensors (a NamedTuple tree)."""
    if hasattr(state, "element_size"):
        return state.numel() * state.element_size()
    return sum(state_nbytes(x) for x in state)


def deferred_depth(state) -> float:
    """Live deferred-buffer depth of a (possibly batched) state tree: the
    MAX over replicas of valid parked slots summed across every buffer
    level (fields named ``*dvalid``, the masked-epoch convention of the
    dense, sparse and nested kinds). The BASELINE §6.5 "deferred-buffer
    depth" gauge. One host read of the summed depths."""
    total = None

    def walk(node):
        nonlocal total
        if hasattr(node, "_fields"):
            for name in node._fields:
                child = getattr(node, name)
                if name.endswith("dvalid"):
                    d = child.sum(dim=-1, dtype=torch.int64)
                    total = d if total is None else total + d
                elif hasattr(child, "_fields"):
                    walk(child)

    walk(state)
    if total is None:
        return 0.0
    return float(total.max())


def observe_depth(name: str, state) -> None:
    """Record ``deferred_depth(state)`` under ``<name>.deferred_depth``."""
    metrics.observe(f"{name}.deferred_depth", deferred_depth(state))


__all__ = ["Metrics", "deferred_depth", "metrics", "observe_depth", "state_nbytes"]
