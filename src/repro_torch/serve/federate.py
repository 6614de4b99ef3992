"""Re-federation: the drift trigger drives a bounded-rounds
``ExperimentSession`` and hot-swaps the refreshed checkpoint back in.

This closes the train -> serve -> drift -> re-federate loop: the
:class:`~repro_torch.serve.monitor.DriftMonitor` fires, the
:class:`Refederator` runs a fresh federation (optionally on a background
thread so the serving loop keeps scoring), checkpoints it (which writes
the validation sidecar), publishes the checkpoint into the
:class:`~repro_torch.serve.swap.ModelSlot`, and re-arms the monitor with the
shifted serving distribution as the new reference. The serving engine
flips the refreshed model in at its next batch boundary — zero requests
dropped across the whole cycle.

Round accounting: each re-federation session counts its own rounds from
zero, so the publish passes ``round_base`` = the currently served
model's round counter — version round indices stay monotone across
re-federations and the swap layer's staleness gate keeps rejecting
genuinely old artifacts.

Failure is the normal regime: a re-federation attempt that
raises — session failure, checkpoint IO error, publish crash, any
``repro_torch.faults`` injection — retries up to ``max_retries`` times with
exponential backoff and deterministic seeded jitter. A firing whose
retry budget is exhausted counts ONE consecutive failure; after
``breaker_threshold`` consecutive failed firings the circuit breaker
OPENS: triggers are swallowed (counted in ``skipped``) for
``breaker_cooldown`` firings, then the next trigger runs a single
HALF-OPEN probe (no retry budget) — success re-closes the breaker,
failure re-opens it. ``breaker_state`` / ``consecutive_failures`` /
``last_error`` expose the machine for ``serve/health.py``; a broken
federation pipeline therefore costs the serving loop nothing but stale
models, never a crash and never an unbounded retry storm.

On the card, a background re-federation launches its session's kernels
from its own thread on PyTorch's current stream, by default the device's
default stream, which the serving thread's scoring uses too: the copy a
publish makes is ordered before every later scoring launch.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.api.session import ExperimentSession
from repro_torch.serve.swap import ModelSlot

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half-open"


class Refederator:
    """Runs one bounded federation per trigger and publishes the result.

    Parameters
    ----------
    slot         : the ModelSlot the serving engine scores from
    spec_factory : ``trigger_index -> ExperimentSpec`` — each firing
                   builds the spec for that re-federation (typically
                   with a data factory reflecting the CURRENT traffic
                   distribution; its ``rounds`` field bounds the run)
    ckpt_dir     : where refreshed checkpoints (+ sidecars) land
    monitor      : re-armed (``adopt_current=True``) after a successful
                   publish, so the post-swap distribution becomes the
                   new drift reference; None skips re-arming
    background   : True runs each federation on a daemon thread (the
                   serving loop keeps pumping); False runs inline
    max_retries  : extra attempts per firing after the first fails
    backoff_base / backoff_factor / max_backoff
                 : exponential backoff (seconds) between attempts
    jitter       : fractional deterministic jitter on each backoff,
                   drawn from a generator seeded by ``(seed, firing)``
    breaker_threshold : consecutive failed firings that OPEN the breaker
    breaker_cooldown  : triggers swallowed while open before the
                        half-open probe (0 = probe on the very next)
    sleep        : injectable clock for tests (defaults to time.sleep)
    injector     : optional ``repro_torch.faults.FaultInjector`` — sites
                   ``"refederate"`` (before the session runs) and
                   ``"publish"`` (before the checkpoint publishes)
    device       : where each re-federation session runs (the card
                   unless named) and where ``publish_checkpoint``
                   restores it (the slot's device when None)
    """

    def __init__(self, slot: ModelSlot,
                 spec_factory: Callable[[int], "object"], *,
                 ckpt_dir: str, monitor=None, background: bool = True,
                 on_complete: Optional[Callable] = None,
                 max_retries: int = 2, backoff_base: float = 0.25,
                 backoff_factor: float = 2.0, max_backoff: float = 30.0,
                 jitter: float = 0.1, breaker_threshold: int = 3,
                 breaker_cooldown: int = 1, seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep,
                 injector=None, device=None):
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got {breaker_threshold}")
        if breaker_cooldown < 0:
            raise ValueError(
                f"breaker_cooldown must be >= 0, got {breaker_cooldown}")
        self.slot = slot
        self.spec_factory = spec_factory
        self.ckpt_dir = ckpt_dir
        self.monitor = monitor
        self.background = background
        self.on_complete = on_complete
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.backoff_factor = float(backoff_factor)
        self.max_backoff = float(max_backoff)
        self.jitter = float(jitter)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown = int(breaker_cooldown)
        self.seed = int(seed)
        self.sleep = sleep
        self.injector = injector
        self.device = device
        self.completed = 0
        self.fired = 0
        self.retries = 0                  # lifetime retry attempts
        self.skipped = 0                  # triggers swallowed (open/busy)
        self.consecutive_failures = 0     # failed FIRINGS (post-retries)
        self.last_error: Optional[BaseException] = None
        self.last_checkpoint: Optional[str] = None
        self.last_outcome: Optional[str] = None   # "ok" | "failed" | None
        self._breaker = BREAKER_CLOSED
        self._cooldown_left = 0
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    @property
    def busy(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    @property
    def breaker_state(self) -> str:
        with self._lock:
            return self._breaker

    def fire(self) -> bool:
        """Kick off one re-federation (the engine's ``on_trigger``
        hook). Returns False — without starting anything — when a run
        is already in flight (overlapping triggers coalesce) or the
        circuit breaker swallows the trigger during its open cooldown.
        The first trigger past the cooldown runs as the HALF-OPEN
        probe: one attempt, no retries."""
        with self._lock:
            if self.busy:
                self.skipped += 1
                return False
            probe = False
            if self._breaker == BREAKER_OPEN:
                if self._cooldown_left > 0:
                    self._cooldown_left -= 1
                    self.skipped += 1
                    return False
                self._breaker = BREAKER_HALF_OPEN
                probe = True
            k = self.fired
            self.fired += 1
            if self.background:
                self._thread = threading.Thread(
                    target=self._run, args=(k, probe), daemon=True,
                    name=f"refederate-{k}")
                self._thread.start()
                return True
        self._run(k, probe)
        return True

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the in-flight background federation. Returns True
        when no run remains in flight. The thread reference is cleared
        ONLY when the join actually completed — after a timeout expiry
        the still-running daemon stays referenced and ``busy`` keeps
        reporting True."""
        t = self._thread
        if t is None:
            return True
        t.join(timeout)
        if t.is_alive():
            return False
        with self._lock:
            if self._thread is t:
                self._thread = None
        return True

    # ------------------------------------------------------------------
    def _backoff(self, attempt: int, rng) -> float:
        base = min(self.max_backoff,
                   self.backoff_base * self.backoff_factor ** attempt)
        return base * (1.0 + self.jitter * float(rng.random()))

    def _attempt(self, k: int) -> None:
        """One full re-federation attempt; any raise means failure."""
        if self.injector is not None:
            self.injector.check("refederate")
        spec = self.spec_factory(k)
        session = ExperimentSession.open(spec, device=self.device)
        session.run(spec.rounds)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        path = os.path.join(self.ckpt_dir, f"refederated_{k:03d}.ckpt")
        session.checkpoint(path)
        self.last_checkpoint = path
        if self.injector is not None:
            self.injector.check("publish")
        # each session counts rounds from zero; base on the served
        # model's counter so version rounds stay monotone and the
        # staleness gate still rejects genuinely old artifacts
        self.slot.publish_checkpoint(
            path, spec=spec, round_base=self.slot.meta.round_idx,
            device=self.device)
        if self.monitor is not None:
            self.monitor.rearm(adopt_current=True)

    def _run(self, k: int, probe: bool = False) -> None:
        # a failed re-federation must not kill serving: every attempt's
        # exception is absorbed into retry/backoff, then into the
        # breaker — only `last_error` and health surface it
        rng = np.random.default_rng([self.seed, k])
        budget = 1 if probe else self.max_retries + 1
        for attempt in range(budget):
            try:
                self._attempt(k)
            except Exception as e:
                self.last_error = e
                if attempt + 1 < budget:
                    with self._lock:
                        self.retries += 1
                    self.sleep(self._backoff(attempt, rng))
                    continue
                with self._lock:
                    self.last_outcome = "failed"
                    self.consecutive_failures += 1
                    if probe or (self.consecutive_failures
                                 >= self.breaker_threshold):
                        self._breaker = BREAKER_OPEN
                        self._cooldown_left = self.breaker_cooldown
                return
            with self._lock:
                self.completed += 1
                self.consecutive_failures = 0
                self.last_error = None
                self.last_outcome = "ok"
                self._breaker = BREAKER_CLOSED
            if self.on_complete is not None:
                self.on_complete(k, self.last_checkpoint)
            return
