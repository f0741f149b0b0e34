"""Retry discipline primitives: jittered exponential backoff + a per-peer
circuit breaker.

Shared by both sides of the service mesh's failure story:

- **callers of flaky peers** (services/trader_host.py): bounded RPC
  retries with ``jittered_backoff_ms`` between attempts, and a
  ``CircuitBreaker`` per peer so a dead trader stops costing every
  monitor round its full collect-window timeout — after
  ``fail_threshold`` consecutive failures the breaker OPENS (calls are
  skipped outright), and after ``reset_after_s`` it goes HALF-OPEN,
  letting exactly one probe through on the next cadence: success closes
  it, failure re-opens it.
- **clients of back-pressured servers** (bench serving/live clients,
  services/workload.py): 503 quotes carry ``RetryAfterMs``; the client
  sleeps a jittered exponential multiple of the quote (never a fixed
  sleep — synchronized clients re-collide — and never an immediate
  retry) under a bounded attempt budget, surfacing exhaustion instead of
  spinning forever.

The jitter is the standard "equal jitter" form: half the exponential
delay deterministic, half uniform — bounded below (no thundering
immediate retries) and decorrelated above.
"""

from __future__ import annotations

import threading
import time


def jittered_backoff_ms(attempt: int, base_ms: float, cap_ms: float,
                        rng) -> float:
    """Delay before retry ``attempt`` (0-based): equal-jitter exponential
    ``d = min(cap, base * 2^attempt); sleep in [d/2, d)``. ``rng`` is a
    ``numpy.random.Generator`` (callers own the seed/determinism
    policy)."""
    d = min(float(cap_ms), float(base_ms) * (2.0 ** max(int(attempt), 0)))
    return d / 2.0 + float(rng.uniform(0.0, d / 2.0))


class CircuitBreaker:
    """Three-state per-peer breaker (closed -> open -> half-open).

    Thread-safe; ``allow()`` is the gate callers consult before dialing,
    ``record_success``/``record_failure`` feed it outcomes. While OPEN all
    calls are skipped; after ``reset_after_s`` ONE probe is admitted
    (HALF-OPEN) — its outcome closes or re-opens the breaker. ``clock``
    is injectable for tests."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(self, fail_threshold: int = 3, reset_after_s: float = 10.0,
                 clock=time.monotonic):
        self.fail_threshold = max(int(fail_threshold), 1)
        self.reset_after_s = float(reset_after_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self.opened_total = 0  # lifetime opens (telemetry)

    @property
    def state(self) -> str:
        with self._lock:
            if (self._state == self.OPEN
                    and self._clock() - self._opened_at >= self.reset_after_s):
                return self.HALF_OPEN  # would admit a probe
            return self._state

    def allow(self) -> bool:
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if self._clock() - self._opened_at >= self.reset_after_s:
                    # admit exactly one probe; concurrent callers see
                    # HALF_OPEN and are refused until it reports back
                    self._state = self.HALF_OPEN
                    return True
                return False
            return False  # HALF_OPEN: a probe is already in flight

    def record_success(self) -> None:
        with self._lock:
            self._state = self.CLOSED
            self._failures = 0

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if (self._state == self.HALF_OPEN
                    or self._failures >= self.fail_threshold):
                if self._state != self.OPEN:
                    self.opened_total += 1
                self._state = self.OPEN
                self._opened_at = self._clock()
