"""Shared retry helper — capped exponential backoff with seeded jitter.

The repo previously grew one-off retry loops (the TCPStore client connect
loop slept a flat 0.1s with no jitter; transient engine-step errors simply
killed the serving loop).  This module is the single policy those paths now
share:

    from paddle_tpu_torch.core.retry import RetryPolicy, retry_call

    retry_call(connect, policy=RetryPolicy(max_attempts=8, base_delay=0.05),
               retry_on=(OSError,), op="store.connect")

Backoff is the standard ``min(max_delay, base * multiplier**i)`` curve with
*equal jitter* (half fixed, half uniform-random) so simultaneous retriers
decorrelate instead of stampeding; the jitter stream is seeded per call, so a
test passing ``seed=`` replays byte-identical sleep schedules.  Attempt
counts land in the observability registry (``retry_attempts`` histogram +
``retry_exhausted_total``, labelled by ``op``) whenever telemetry is on.
"""
from __future__ import annotations

import random
import time

__all__ = ["RetryPolicy", "RetryError", "retry_call"]


class RetryError(RuntimeError):
    """All attempts failed (or the deadline lapsed); ``__cause__`` is the
    last underlying error and ``attempts`` how many were made."""

    def __init__(self, op, attempts, last):
        super().__init__(
            f"{op or 'operation'} failed after {attempts} attempt(s): "
            f"{type(last).__name__}: {last}")
        self.attempts = attempts


class RetryPolicy:
    """Backoff shape: ``max_attempts`` total tries, delays growing from
    ``base_delay`` by ``multiplier`` capped at ``max_delay``, each delay
    jittered to ``[delay/2, delay]`` (equal jitter).  ``deadline`` bounds the
    whole retried operation in wall seconds — no sleep is started that the
    deadline could not cover.  ``seed`` fixes the jitter stream (tests)."""

    def __init__(self, max_attempts=5, base_delay=0.05, max_delay=2.0,
                 multiplier=2.0, jitter=True, deadline=None, seed=None):
        if int(max_attempts) < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = bool(jitter)
        self.deadline = deadline
        self.seed = seed

    def delays(self):
        """The sleep schedule between attempts (``max_attempts - 1`` values)."""
        rng = random.Random(self.seed)
        for i in range(self.max_attempts - 1):
            d = min(self.max_delay, self.base_delay * self.multiplier ** i)
            if self.jitter:
                d = d / 2 + rng.uniform(0, d / 2)
            yield d


def retry_call(fn, *args, policy=None, retry_on=(Exception,), op="",
               on_retry=None, sleep=time.sleep, clock=time.monotonic,
               **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying on ``retry_on`` errors per
    ``policy`` (default :class:`RetryPolicy`).  ``on_retry(attempt, err,
    delay)`` observes each failure before its backoff sleep; ``sleep`` and
    ``clock`` are injectable for deterministic tests.  Raises
    :class:`RetryError` (from the last error) when attempts or the deadline
    run out; non-matching errors propagate immediately."""
    policy = policy or RetryPolicy()
    start = clock()
    delays = policy.delays()
    attempt = 0
    while True:
        attempt += 1
        try:
            result = fn(*args, **kwargs)
        except retry_on as e:
            delay = next(delays, None)
            expired = (policy.deadline is not None and delay is not None
                       and clock() - start + delay > policy.deadline)
            if delay is None or expired:
                _record(op, attempt, exhausted=True)
                raise RetryError(op, attempt, e) from e
            if on_retry is not None:
                on_retry(attempt, e, delay)
            sleep(delay)
        else:
            _record(op, attempt, exhausted=False)
            return result


def _record(op, attempts, exhausted):
    """Mirror the outcome into the registry; free while telemetry is off.
    Lazy import: core must stay importable without the observability pkg."""
    from .. import observability as _obs
    if not _obs.enabled():
        return
    _obs.RETRY_ATTEMPTS.labels(op=op or "unknown").observe(attempts)
    if exhausted:
        _obs.RETRY_EXHAUSTED.labels(op=op or "unknown").inc()
