"""Deterministic fault injection for the serving stack.

Production code calls :func:`hook` at named *sites* (cold decode, blob
read, fused kernel launch, planner, wave execute, worker).  With no plan
installed the hook is a single global read plus an ``is None`` branch —
cheap enough to leave in the hot path permanently (the disabled cost is
measured by ``benchmarks/bench_serving.py`` and gated below 2% of p50).

Chaos tests install a seeded :class:`FaultPlan` that scripts *exact*
failure schedules: "fail the 3rd cold decode", "crash the worker on its
first wave", "fail 10% of kernel launches under seed 7".  Schedules are
deterministic — the same plan against the same call sequence injects the
same faults — so chaos runs are reproducible and bit-exact comparisons
against an undisturbed control server are meaningful.

Typical test usage::

    plan = FaultPlan(seed=7).fail("cold_decode", at=[0]).fail(
        "kernel_launch", rate=0.1)
    with installed(plan):
        ... drive the server ...
    assert plan.injected("cold_decode") == 1
"""
from __future__ import annotations

import contextlib
import random
import threading
import zlib
from typing import Callable, Iterable, Optional

# Canonical injection sites wired into the serving stack.  Hooks accept
# arbitrary site names (tests may add private sites), but these are the
# ones production code fires.
SITES = (
    "planner",        # cold-table planning (server._plan_cold)
    "wave_execute",   # top of a drained wave (server._execute_wave)
    "kernel_launch",  # fused batch launch (scheduler.BatchScheduler._run_group)
    "blob_read",      # cold blob fetch (catalog.ColdTable._decode)
    "cold_decode",    # synopsis decode (catalog.ColdTable._decode)
    "worker",         # admission worker heartbeat (scheduler._loop)
)


class InjectedFault(RuntimeError):
    """Raised by a fired fault rule; carries the site and call index."""

    def __init__(self, site: str, index: int, note: str = ""):
        self.site = site
        self.index = index
        msg = f"injected fault at {site}#{index}"
        if note:
            msg += f" ({note})"
        super().__init__(msg)


class _Rule:
    """One scheduled failure: matches call indices, then acts."""

    def __init__(self, site: str, seed: int, order: int,
                 at: Optional[Iterable[int]], first: int, every: int,
                 rate: float, exc: Optional[Callable[[str, int], Exception]],
                 action: Optional[Callable[[], None]], note: str):
        self.site = site
        self.at = frozenset(at) if at is not None else None
        self.first = first
        self.every = every
        self.rate = rate
        self.exc = exc
        self.action = action
        self.note = note
        # Per-rule deterministic stream: seed x site x registration order.
        self.rng = random.Random(
            (seed << 16) ^ zlib.crc32(site.encode()) ^ order)

    def matches(self, index: int) -> bool:
        if self.at is not None and index in self.at:
            return True
        if self.first and index < self.first:
            return True
        if self.every and (index + 1) % self.every == 0:
            return True
        if self.rate > 0.0 and self.rng.random() < self.rate:
            return True
        return False


class FaultPlan:
    """A seeded, scripted schedule of failures keyed by injection site.

    Rules are evaluated in registration order at every :func:`hook` call
    for their site; the first matching rule fires.  A rule either raises
    (``exc``, default :class:`InjectedFault`) or runs ``action`` (e.g. a
    ``time.sleep`` to inject latency) — an ``action`` that returns
    normally does not raise.
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._lock = threading.Lock()
        self._rules: dict[str, list[_Rule]] = {}
        self._counts: dict[str, int] = {}
        self._injected: dict[str, int] = {}
        self._order = 0

    def fail(self, site: str, *, at: Optional[Iterable[int]] = None,
             first: int = 0, every: int = 0, rate: float = 0.0,
             exc: Optional[Callable[[str, int], Exception]] = None,
             action: Optional[Callable[[], None]] = None,
             note: str = "") -> "FaultPlan":
        """Register a failure rule for ``site``; returns ``self`` to chain.

        ``at`` fires on exact 0-based call indices; ``first`` fires on the
        first N calls; ``every`` fires on every k-th call; ``rate`` fires
        pseudo-randomly (deterministic under the plan seed).  ``exc`` is a
        factory ``(site, index) -> Exception``; ``action`` is called
        instead of raising when given (use it for latency injection).
        """
        with self._lock:
            rule = _Rule(site, self.seed, self._order, at, first, every,
                         rate, exc, action, note)
            self._order += 1
            self._rules.setdefault(site, []).append(rule)
        return self

    def fire(self, site: str) -> None:
        """Account one call at ``site`` and inject per the schedule."""
        with self._lock:
            index = self._counts.get(site, 0)
            self._counts[site] = index + 1
            hit = None
            for rule in self._rules.get(site, ()):
                if rule.matches(index):
                    hit = rule
                    break
            if hit is not None:
                self._injected[site] = self._injected.get(site, 0) + 1
        if hit is None:
            return
        if hit.action is not None:
            hit.action()
            return
        factory = hit.exc
        if factory is None:
            raise InjectedFault(site, index, hit.note)
        raise factory(site, index)

    def count(self, site: str) -> int:
        """Total hook calls observed at ``site`` so far."""
        with self._lock:
            return self._counts.get(site, 0)

    def injected(self, site: str) -> int:
        """Number of faults actually fired at ``site`` so far."""
        with self._lock:
            return self._injected.get(site, 0)

    def snapshot(self) -> dict:
        """Counts and injections per site, for assertions and reports."""
        with self._lock:
            return {"counts": dict(self._counts),
                    "injected": dict(self._injected)}


_ACTIVE: Optional[FaultPlan] = None


def hook(site: str) -> None:
    """Fire the active fault plan at ``site``; no-op when none installed."""
    plan = _ACTIVE
    if plan is not None:
        plan.fire(site)


def install(plan: FaultPlan) -> None:
    """Make ``plan`` the process-wide active fault plan."""
    global _ACTIVE
    _ACTIVE = plan


def clear() -> None:
    """Remove the active fault plan (hooks become no-ops again)."""
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[FaultPlan]:
    """Return the currently installed plan, or ``None``."""
    return _ACTIVE


@contextlib.contextmanager
def installed(plan: FaultPlan):
    """Context manager: install ``plan``, restore the previous plan on exit."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = prev
