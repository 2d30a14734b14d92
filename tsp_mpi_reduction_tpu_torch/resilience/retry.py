"""Bounded retry with exponential backoff and deterministic jitter.

The serve ladder and checkpoint/cache paths use this to absorb TRANSIENT
faults (:class:`~.faults.TransientFault` — which includes every
registry-injected fault) without turning them into dropped requests. The
policy is deliberately small: bounded attempts, capped exponential delay,
seeded jitter so chaos runs replay byte-identically, and an optional wall
budget so a retry loop can never outspend a request's deadline.
Every absorbed fault counts into ``HEALTH.retries``.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type

from .faults import TransientFault
from .health import HEALTH


@dataclass
class RetryPolicy:
    #: total attempts (1 = no retry)
    max_attempts: int = 3
    base_delay_s: float = 0.01
    max_delay_s: float = 0.25
    #: fraction of each delay randomized away (0 = full deterministic
    #: backoff; 0.5 = delays land in [0.5x, 1.0x])
    jitter: float = 0.5
    #: seeds the jitter RNG (default 0: every retry schedule in this repo
    #: replays byte-identically, which chaos runs and tests rely on);
    #: pass None for nondeterministic jitter if thundering-herd spreading
    #: across processes ever matters more than replayability
    seed: Optional[int] = 0
    retry_on: Tuple[Type[BaseException], ...] = (TransientFault,)

    def delay_s(self, attempt: int, rng: random.Random) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        raw = min(self.base_delay_s * (2 ** (attempt - 1)), self.max_delay_s)
        return raw * (1.0 - self.jitter * rng.random())

    def call(
        self,
        fn: Callable,
        *,
        budget_s: Optional[float] = None,
        on_retry: Optional[Callable[[int, BaseException], None]] = None,
    ):
        """Run ``fn`` with up to ``max_attempts`` tries. Re-raises the last
        transient fault when attempts (or the wall ``budget_s``) run out;
        non-retryable exceptions propagate immediately."""
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        # the jitter RNG is built lazily, on the first retry: the no-fault
        # fast path (every request's cache lookup and rung attempt goes
        # through here) must not pay the Mersenne seeding, and the retry
        # schedule stays byte-identical — the first delay still comes from
        # a fresh Random(seed)
        rng: Optional[random.Random] = None
        t0 = time.monotonic()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn()
            except self.retry_on as exc:
                if attempt >= self.max_attempts:
                    raise
                if rng is None:
                    rng = random.Random(self.seed)
                delay = self.delay_s(attempt, rng)
                if (
                    budget_s is not None
                    and time.monotonic() - t0 + delay > budget_s
                ):
                    raise
                HEALTH.incr("retries")
                if on_retry is not None:
                    on_retry(attempt, exc)
                time.sleep(delay)
