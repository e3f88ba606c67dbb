"""Shared client-side retry discipline (r18): budgets, breakers, jitter.

Every resilient client in the stack (``PSClient``, ``DataServiceClient``,
``ServeClient``/``ServePool``) retries: reconnect-and-replay on transport
faults, back-off-and-retry on the server's typed RETRY_LATER shed
answers.  Uncoordinated, those retries are how one blip becomes a
METASTABLE failure — N clients recovering in lockstep re-arrive as a
thundering herd, the herd re-overloads the server, the overload produces
more retries, and the storm outlives the blip that started it.  This
module is the ONE definition of the discipline that prevents it, used by
all three clients (dtxlint's ``retry-discipline`` rule refuses a
reconnect/retry loop in ``parallel/``/``data/``/``serve/`` that does not
consult it):

- :func:`jittered` — equal-jitter exponential backoff.  Deterministic
  backoff synchronizes recovering clients onto the same retry instants;
  the jitter decorrelates them, so the post-blip re-arrival is a ramp,
  not a spike.
- :class:`RetryBudget` — a token bucket that caps RETRIES at a fraction
  of SUCCESSES (plus a burst allowance for cold starts and short blips).
  Healthy traffic keeps the bucket full; a retry STORM — every op
  failing, every failure retried — drains it, and further retries are
  refused until real successes refill it.  Budget exhaustion surfaces as
  the caller's existing typed deadline error plus a flight-recorder
  event, so a storm is attributable, not silent.
- :class:`CircuitBreaker` (per ADDRESS, process-wide registry via
  :func:`breaker_for`) — consecutive transport failures against one
  address open the breaker for a jittered, exponentially growing window;
  while open, dial attempts fail fast (or skip to a replica) instead of
  burning connect timeouts against a dead peer; a half-open probe after
  the window closes it again on the first success.  All clients of one
  process share each address's breaker, so one client's discovery that a
  peer is down spares every other client the same timeout.

Telemetry: ``retry/spent``, ``retry/budget_exhausted``,
``retry/breaker_open`` and ``retry/breaker_fast_fails`` accumulate in the
process registry (scraped by every service's STATS answer and rendered
per role by ``tools/dtxtop``).
"""

from __future__ import annotations

import random
import threading
import time

from ..utils import faults, telemetry

_OBS_SPENT = telemetry.REGISTRY.counter("retry/spent")
_OBS_EXHAUSTED = telemetry.REGISTRY.counter("retry/budget_exhausted")
_OBS_BREAKER_OPEN = telemetry.REGISTRY.counter("retry/breaker_open")
_OBS_FAST_FAILS = telemetry.REGISTRY.counter("retry/breaker_fast_fails")

#: Module-wide jitter source.  Deliberately NOT seeded: cross-process
#: decorrelation is the whole point — reproducing exact retry instants
#: would re-synchronize the herd the jitter exists to break up.  Tests
#: that need determinism pass their own ``rng``.
_rng = random.Random()


def jittered(
    base_s: float, attempt: int = 0, cap_s: float = 2.0,
    rng: random.Random | None = None,
) -> float:
    """Equal-jitter exponential backoff: for retry ``attempt`` (0-based),
    the nominal delay is ``min(cap_s, base_s * 2**attempt)`` and the
    returned delay is uniform in [nominal/2, nominal] — half the wait is
    guaranteed (no hot-loop zero delays), half is decorrelation."""
    nominal = min(float(cap_s), float(base_s) * (2 ** min(int(attempt), 16)))
    r = rng if rng is not None else _rng
    return nominal / 2 + r.uniform(0.0, nominal / 2)


class RetryBudget:
    """Token-bucket retry budget: retries capped at a fraction of
    successes.

    The bucket starts at ``burst`` tokens (cold starts and short blips
    retry freely); every SUCCESS deposits ``ratio`` tokens (capped at
    ``burst``), every retry spends one.  When the bucket is empty,
    :meth:`try_spend` refuses — the caller surfaces its typed deadline
    error instead of feeding the storm.  Thread-safe; one instance per
    client (the budget prices THAT client's retry pressure)."""

    def __init__(self, ratio: float = 0.2, burst: float = 20.0):
        self.ratio = float(ratio)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._lock = threading.Lock()
        self._exhausted_logged = False

    @property
    def tokens(self) -> float:
        return self._tokens

    def on_success(self) -> None:
        with self._lock:
            self._tokens = min(self.burst, self._tokens + self.ratio)
            self._exhausted_logged = False

    def try_spend(self) -> bool:
        """Spend one retry token; False when the budget is exhausted (the
        first refusal of a dry spell logs a flight-recorder event, so a
        storm leaves evidence without flooding the ring)."""
        log_it = False
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                spent = True
            else:
                spent = False
                if not self._exhausted_logged:
                    self._exhausted_logged = True
                    log_it = True
        if spent:
            _OBS_SPENT.inc()
            return True
        _OBS_EXHAUSTED.inc()
        if log_it:
            faults.log_event(
                "retry_budget_exhausted", role=faults.current_role(),
                ratio=self.ratio, burst=self.burst,
            )
        return False


class ShedRetry:
    """Per-op shed-retry pacing: the ONE spelling of "the server answered
    RETRY_LATER — back off and try again" shared by the wire clients.
    Each backoff is jittered off the server's hint, spends the client's
    :class:`RetryBudget`, and the whole shed-retry spell is bounded by
    the op timeout (``default_s`` when the client has none): a server
    that keeps shedding past it surfaces the caller's typed deadline
    error instead of being polled forever."""

    __slots__ = ("_budget", "_window_s", "_deadline", "_attempt")

    def __init__(
        self, budget: RetryBudget, op_timeout_s: float | None,
        default_s: float = 30.0,
    ):
        self._budget = budget
        self._window_s = float(op_timeout_s) if op_timeout_s else default_s
        self._deadline: float | None = None  # armed on the first shed
        self._attempt = 0

    def backoff(self, hint_ms: int) -> bool:
        """One shed answer: sleep a jittered backoff honoring the
        server's ``hint_ms`` and return True (retry), or return False —
        give up (the shed window or the retry budget is exhausted; the
        caller raises its typed deadline error)."""
        now = time.monotonic()
        if self._deadline is None:
            self._deadline = now + self._window_s
        if now >= self._deadline or not self._budget.try_spend():
            return False
        time.sleep(jittered(max(hint_ms, 10) / 1e3, self._attempt, cap_s=2.0))
        self._attempt += 1
        return True


class CircuitBreaker:
    """Per-address circuit breaker: ``threshold`` CONSECUTIVE transport
    failures open it for a jittered window that doubles per re-open
    (``open_s`` .. ``max_open_s``); while open, :meth:`allow` answers
    False (fail fast / try a replica).  After the window a half-open
    probe is allowed, and one success fully closes it.  Process-wide per
    address (see :func:`breaker_for`): every client sharing the address
    shares the verdict."""

    def __init__(
        self, addr, *, threshold: int = 5, open_s: float = 0.5,
        max_open_s: float = 4.0,
    ):
        self.addr = addr
        self.threshold = int(threshold)
        self.open_s = float(open_s)
        self.max_open_s = float(max_open_s)
        self._lock = threading.Lock()
        self._failures = 0
        self._opens = 0  # consecutive opens since the last success
        self._open_until = 0.0
        self.opened_total = 0

    def allow(self, now: float | None = None) -> bool:
        """Whether a dial attempt may proceed (False while open; True
        again once the window passed — the half-open probe)."""
        t = time.monotonic() if now is None else now
        with self._lock:
            ok = t >= self._open_until
        if not ok:
            _OBS_FAST_FAILS.inc()
        return ok

    def probe_in_s(self, now: float | None = None) -> float:
        """Seconds until the next half-open probe (0 = allowed now)."""
        t = time.monotonic() if now is None else now
        with self._lock:
            return max(0.0, self._open_until - t)

    def wait_for_probe(self, t_end: float) -> None:
        """Sleep toward the next half-open probe — the ONE spelling of
        the open-breaker wait the reconnect loops share: bounded by 0.5 s
        chunks (the breaker may close early on another client's success)
        and by the caller's reconnect deadline ``t_end``.  This wait IS
        the attempt's pacing — callers skip their own backoff sleep for
        the iteration it paced."""
        time.sleep(min(
            self.probe_in_s(), 0.5, max(0.0, t_end - time.monotonic()),
        ))

    def on_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._opens = 0
            self._open_until = 0.0

    def on_failure(self, now: float | None = None) -> None:
        t = time.monotonic() if now is None else now
        opened = False
        with self._lock:
            self._failures += 1
            if self._failures >= self.threshold:
                self._failures = 0
                window = jittered(
                    self.open_s, self._opens, cap_s=self.max_open_s
                )
                self._opens += 1
                self._open_until = t + window
                self.opened_total += 1
                opened = True
        if opened:
            _OBS_BREAKER_OPEN.inc()
            faults.log_event(
                "breaker_open", role=faults.current_role(),
                addr=f"{self.addr[0]}:{self.addr[1]}"
                if isinstance(self.addr, tuple) else str(self.addr),
                opens=self.opened_total,
            )


_breakers: dict = {}
_breakers_lock = threading.Lock()


def breaker_for(addr) -> CircuitBreaker:
    """The process-wide breaker for ``addr`` (``(host, port)``), created
    on first use — one shared verdict per address, so N clients pay one
    discovery timeout for a dead peer, not N."""
    with _breakers_lock:
        b = _breakers.get(addr)
        if b is None:
            b = _breakers[addr] = CircuitBreaker(addr)
        return b


def reset_breakers() -> None:
    """Drop every registered breaker (test isolation)."""
    with _breakers_lock:
        _breakers.clear()
