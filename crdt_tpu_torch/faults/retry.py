"""Host-side exchange resilience: timeout, exponential backoff with
jitter — counterpart of the JAX package's ``faults/retry.py``.

Every exchange between hosts is an idempotent lattice join (or an
idempotent op re-ingest keyed by unique identifiers), so RETRYING A WHOLE
EXCHANGE IS ALWAYS SAFE. :func:`with_retries` wraps one exchange attempt;
on exhaustion it raises :class:`DcnExchangeFailed` carrying the
last-good state the caller resumes from. Counters (the JAX names):
``faults.retries``, ``faults.timeouts``, ``faults.gave_up``.

A timed-out attempt's worker thread cannot be killed: it is abandoned as
a daemon thread and may still complete in the background. The
per-attempt ``timeout`` is therefore only safe around exchanges whose
late completion cannot interleave with the retry (a plain RPC, a blob
fetch), never around a collective.

``parallel.multihost``'s host all-gather, ``sync_tenant_rows`` and
``sync_list`` take ``retry=`` through :func:`with_retries` (their
``torch.distributed`` gathers refuse a per-attempt timeout). Each retry
emits a ``dcn_retry`` flight event; the give-up emits
``dcn_exchange_failed`` and auto-dumps the recorder before it raises.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from .. import obs
from ..utils.metrics import metrics


@dataclass(frozen=True)
class RetryPolicy:
    """Backoff shape for one exchange. ``base_delay`` grows by
    ``backoff`` per retry up to ``max_delay``; each sleep is scaled by
    ``1 + U(0, jitter)``; ``timeout`` is the per-ATTEMPT deadline in
    seconds (None = wait forever); ``seed`` makes the jitter
    deterministic."""

    attempts: int = 5
    base_delay: float = 0.05
    max_delay: float = 2.0
    backoff: float = 2.0
    jitter: float = 0.5
    timeout: Optional[float] = None
    seed: Optional[int] = None

    def __post_init__(self):
        if self.attempts < 1:
            raise ValueError("attempts must be >= 1")
        if self.backoff < 1.0:
            raise ValueError("backoff must be >= 1.0")


DEFAULT_POLICY = RetryPolicy()


class DcnExchangeFailed(RuntimeError):
    """An exchange exhausted its retry budget. ``last_good`` is the
    resume point the caller handed in; ``cause`` the final attempt's
    exception."""

    def __init__(self, op: str, attempts: int, cause: BaseException, last_good: Any = None):
        super().__init__(
            f"DCN exchange '{op}' failed after {attempts} attempt(s): "
            f"{type(cause).__name__}: {cause} — resume from last_good"
        )
        self.op = op
        self.attempts = attempts
        self.cause = cause
        self.last_good = last_good


class _AttemptTimeout(RuntimeError):
    pass


def _call_with_timeout(fn: Callable[[], Any], timeout: Optional[float], op: str) -> Any:
    if timeout is None:
        return fn()
    box: dict = {}

    def runner():
        try:
            box["result"] = fn()
        except BaseException as exc:  # re-raised on the caller thread
            box["error"] = exc

    t = threading.Thread(target=runner, name=f"dcn-{op}", daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        # Abandoned (module docstring): safe only because the exchange is
        # idempotent.
        metrics.count("faults.timeouts")
        raise _AttemptTimeout(f"'{op}' attempt exceeded {timeout}s")
    if "error" in box:
        raise box["error"]
    return box["result"]


def with_retries(
    fn: Callable[[], Any],
    policy: Optional[RetryPolicy] = None,
    *,
    op: str = "dcn",
    last_good: Any = None,
    sleep: Callable[[float], None] = time.sleep,
) -> Any:
    """Run one idempotent exchange under ``policy``. Returns ``fn()``'s
    value; raises :class:`DcnExchangeFailed` (carrying ``last_good``)
    after the final attempt. ``sleep`` is injectable for tests."""
    policy = policy or DEFAULT_POLICY
    rng = random.Random(policy.seed)
    delay = policy.base_delay
    last_exc: Optional[BaseException] = None
    for attempt in range(policy.attempts):
        if attempt:
            metrics.count("faults.retries")
            obs.emit("dcn_retry", op=op, attempt=attempt, error=type(last_exc).__name__)
            pause = min(delay, policy.max_delay)
            pause *= 1.0 + policy.jitter * rng.random()
            sleep(pause)
            delay *= policy.backoff
        try:
            return _call_with_timeout(fn, policy.timeout, op)
        except DcnExchangeFailed:
            raise  # a nested wrapped exchange already gave up
        except (KeyboardInterrupt, SystemExit):
            raise  # an operator abort is never retried into
        except Exception as exc:
            last_exc = exc
    metrics.count("faults.gave_up")
    assert last_exc is not None
    # The postmortem boundary: record the exhaustion and write the flight
    # artifact BEFORE raising (auto_dump never masks the exception).
    obs.emit("dcn_exchange_failed", op=op, attempts=policy.attempts,
             error=type(last_exc).__name__)
    obs.auto_dump("dcn_exchange_failed", op=op)
    raise DcnExchangeFailed(op, policy.attempts, last_exc, last_good=last_good) from last_exc


__all__ = ["DEFAULT_POLICY", "DcnExchangeFailed", "RetryPolicy", "with_retries"]
