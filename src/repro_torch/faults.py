"""repro_torch.faults — seeded, deterministic fault injection.

The paper's operating regime *is* failure: stragglers, dropouts and
flaky links on the training side (§V "varying client conditions"), and
on the serving side the north star's "heavy traffic from millions of
users" guarantees bursts, dispatch errors and corrupted artifacts.
Companion work (arXiv:2501.15038 adaptive selection, arXiv:2411.01490
anomalous-client detection) treats client/server failure as normal;
this module makes every degradation path *provable* in CI by making the
faults themselves deterministic.

A :class:`FaultSpec` names the fault classes and their schedules; a
:class:`FaultInjector` is the runtime: each *site* (a short string
naming an operation — ``"scorer"``, ``"ckpt_write"``, ...) keeps its own
call counter and its own seeded generator, so whether call #k at a site
fires is a pure function of ``(spec.seed, site, k)`` — independent of
thread interleaving, wall time, or what any other site drew. Two runs
with the same spec inject byte-identical fault sequences, which is what
lets ``tests/test_faults.py`` assert exact shed counts, breaker
transitions and recovery paths instead of flaky probabilistic ones.

Standard sites (consumers may invent more — any string works):

  ``ckpt_write``   checkpoint serialization/IO errors on save
  ``ckpt_read``    checkpoint IO errors on restore
  ``scorer``       serving-engine scoring-dispatch exceptions
  ``publish``      model-slot publish crashes
  ``refederate``   re-federation session failures

Wiring is explicit where possible (``ServeEngine(injector=...)``,
``Refederator(injector=...)``) and ambient for the low-level checkpoint
IO, which has no construction site of its own: ``with injector.scoped():
...`` installs the injector process-wide so ``checkpoint/io.py`` hooks
see it — a plain module global (NOT a context-var) so background
re-federation threads inherit it.

Synthetic request bursts (:class:`BurstSpec`) are the sixth fault
class: not an exception but an arrival-pattern generator —
``spec.burst.sizes(windows, base)`` yields a deterministic per-window
request count where every ``period``-th window is ``mult`` times the
base load, the overload shape ``benchmarks/serve_bench.py`` measures
shed rate and p99-under-burst against.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import zlib
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

STANDARD_SITES = ("ckpt_write", "ckpt_read", "scorer", "publish",
                  "refederate")


class InjectedFault(RuntimeError):
    """The deterministic failure a :class:`FaultInjector` raises.

    Carries the site and the (0-based) call index that fired so
    degradation paths can log/assert exactly which injection they
    absorbed."""

    def __init__(self, site: str, index: int):
        self.site = site
        self.index = index
        super().__init__(f"injected fault at site {site!r} (call #{index})")


@dataclasses.dataclass(frozen=True)
class BurstSpec:
    """Deterministic synthetic traffic bursts: every ``period``-th
    window offers ``mult``x the base request count (``phase`` shifts
    which window bursts first)."""
    period: int = 4
    mult: int = 8
    phase: int = 0

    def is_burst(self, window: int) -> bool:
        return self.period > 0 and (window % self.period) == (
            self.phase % self.period)

    def size(self, window: int, base: int) -> int:
        return base * self.mult if self.is_burst(window) else base

    def sizes(self, windows: int, base: int) -> List[int]:
        return [self.size(w, base) for w in range(windows)]


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Which fault classes fire, and how often.

    ``*_p`` fields are per-call probabilities drawn from a per-site
    seeded generator (1.0 = every call, the persistent-failure regime
    that must open circuit breakers). ``at`` maps a site to EXACT call
    indices that fire regardless of probability — the surgical schedule
    tests use ("fail attempt 0, succeed attempt 1"). ``burst`` is the
    synthetic arrival-pattern fault class for the serving queue.
    """
    seed: int = 0
    ckpt_write_p: float = 0.0
    ckpt_read_p: float = 0.0
    scorer_p: float = 0.0
    publish_p: float = 0.0
    refederate_p: float = 0.0
    at: Mapping[str, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)
    burst: Optional[BurstSpec] = None

    _P_FIELDS = {"ckpt_write": "ckpt_write_p", "ckpt_read": "ckpt_read_p",
                 "scorer": "scorer_p", "publish": "publish_p",
                 "refederate": "refederate_p"}

    def probability(self, site: str) -> float:
        return float(getattr(self, self._P_FIELDS.get(site, ""), 0.0)
                     if site in self._P_FIELDS else 0.0)

    def validate(self) -> "FaultSpec":
        for site, f in self._P_FIELDS.items():
            p = getattr(self, f)
            if not (0.0 <= p <= 1.0):
                raise ValueError(f"FaultSpec.{f}={p} outside [0, 1]")
        for site, idxs in self.at.items():
            if any(int(i) < 0 for i in idxs):
                raise ValueError(
                    f"FaultSpec.at[{site!r}]={idxs}: indices must be >= 0")
        if self.burst is not None and (self.burst.period < 1
                                       or self.burst.mult < 1):
            raise ValueError(
                f"BurstSpec(period={self.burst.period}, "
                f"mult={self.burst.mult}): both must be >= 1")
        return self


class FaultInjector:
    """Runtime for a :class:`FaultSpec`: per-site call counters + seeded
    draws, thread-safe (sites may be polled from the serving thread and
    a background re-federation thread concurrently)."""

    def __init__(self, spec: Optional[FaultSpec] = None):
        self.spec = (spec or FaultSpec()).validate()
        self._lock = threading.Lock()
        self._rng: Dict[str, np.random.Generator] = {}
        self.calls: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}

    def _site_rng(self, site: str) -> np.random.Generator:
        if site not in self._rng:
            # (seed, crc32(site)) keys the stream: deterministic per
            # site, independent across sites, stable across processes
            self._rng[site] = np.random.default_rng(
                [self.spec.seed, zlib.crc32(site.encode())])
        return self._rng[site]

    # ------------------------------------------------------------------
    def _advance(self, site: str) -> Tuple[bool, int]:
        with self._lock:
            k = self.calls.get(site, 0)
            self.calls[site] = k + 1
            fire = k in set(int(i) for i in self.spec.at.get(site, ()))
            p = self.spec.probability(site)
            if p > 0.0:
                # the draw advances even when at= already decided, so
                # the stream position stays a function of k alone
                fire = bool(self._site_rng(site).random() < p) or fire
            if fire:
                self.fired[site] = self.fired.get(site, 0) + 1
            return fire, k

    def poll(self, site: str) -> bool:
        """Advance ``site``'s counter; True when this call is scheduled
        to fail. A pure function of (seed, site, call index)."""
        return self._advance(site)[0]

    def check(self, site: str) -> None:
        """Raise :class:`InjectedFault` when this call is scheduled to
        fail — the one-liner degradation paths wrap in try/except."""
        fire, k = self._advance(site)
        if fire:
            raise InjectedFault(site, k)

    def counts(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {s: {"calls": self.calls.get(s, 0),
                        "fired": self.fired.get(s, 0)}
                    for s in sorted(set(self.calls) | set(self.fired))}

    # ------------------------------------------------------------------
    # ambient installation for the low-level checkpoint IO hooks
    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def scoped(self):
        """Install this injector as the process-wide ambient injector
        consulted by ``repro.checkpoint.io`` (a module global, visible
        to background threads; restores the previous one on exit)."""
        global _ACTIVE
        prev = _ACTIVE
        _ACTIVE = self
        try:
            yield self
        finally:
            _ACTIVE = prev


_ACTIVE: Optional[FaultInjector] = None


def active() -> Optional[FaultInjector]:
    """The ambient injector installed by ``FaultInjector.scoped()`` (or
    None outside any chaos scope)."""
    return _ACTIVE


def check_active(site: str) -> None:
    """Hook for modules without an injection constructor argument
    (checkpoint IO): fault-check ``site`` against the ambient injector;
    a no-op when no chaos scope is active."""
    inj = _ACTIVE
    if inj is not None:
        inj.check(site)


__all__ = [
    "BurstSpec", "FaultInjector", "FaultSpec", "InjectedFault",
    "STANDARD_SITES", "active", "check_active",
]
