"""Weibull-interval-driven checkpoint manager (paper §IV-C).

Wraps checkpoint/io.py with the adaptive policy
(core/checkpoint_policy.py): the manager is told the current (simulated
or real) time and the failure history; it re-fits (λ, k) and writes a
checkpoint whenever the optimal interval has elapsed.

Rolling retention and verified recovery: every save also lands in a
sequence-numbered history file (``ckpt_<tag>_00007.msgpack``), pruned to
the newest ``keep``, and :meth:`latest_good` walks that history newest
first, returning the first artifact whose content digest verifies, so a
corrupted (or injected-fault) latest checkpoint degrades to the previous
good one. :meth:`restore` does that itself with ``fallback=True``.
The JAX package's manager (``repro/checkpoint/manager.py``), over the
port's I/O.
"""
from __future__ import annotations

import os
import re
import shutil
import time
from typing import List, Optional

import numpy as np

from repro_torch import faults
from repro_torch.checkpoint import io
from repro_torch.checkpoint.io import CheckpointCorruptError
from repro_torch.core.checkpoint_policy import fit_weibull, optimal_interval


class CheckpointManager:
    def __init__(self, directory: str, total_time: float = 3600.0,
                 recovery_time: float = 5.0, min_interval: float = 1.0,
                 keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.total_time = total_time
        self.recovery_time = recovery_time
        self.min_interval = min_interval
        self.keep = keep
        self.failures: List[float] = []
        self.last_save: Optional[float] = None
        self.interval = total_time / 20.0   # prior before any failures
        self.saves = 0

    def record_failure(self, t: float):
        self.failures.append(t)
        if len(self.failures) >= 2:
            lam, k = fit_weibull(np.diff(sorted(self.failures)))
            self.interval = max(
                self.min_interval,
                optimal_interval(self.total_time, self.recovery_time, lam, k))

    def should_save(self, now: float) -> bool:
        if self.last_save is None:
            return True
        return (now - self.last_save) >= self.interval

    def path(self, tag: str = "latest") -> str:
        return os.path.join(self.dir, f"ckpt_{tag}.msgpack")

    def _history_path(self, tag: str, seq: int) -> str:
        return os.path.join(self.dir, f"ckpt_{tag}_{seq:05d}.msgpack")

    def history(self, tag: str = "latest") -> List[str]:
        """Retained history paths for ``tag``, newest first."""
        pat = re.compile(rf"^ckpt_{re.escape(tag)}_(\d{{5}})\.msgpack$")
        entries = []
        for name in os.listdir(self.dir):
            m = pat.match(name)
            if m:
                entries.append((int(m.group(1)),
                                os.path.join(self.dir, name)))
        return [p for _seq, p in sorted(entries, reverse=True)]

    def save(self, tree, now: float = None, tag: str = "latest"):
        now = time.time() if now is None else now
        canonical = self.path(tag)
        io.save(canonical, tree)
        # the history copy shares the just-written bytes (the digest rides
        # inside the file), so a later bit flip of either copy is detected
        # on its own
        hist = self._history_path(tag, self.saves)
        shutil.copyfile(canonical, hist)
        self.last_save = now
        self.saves += 1
        for stale in self.history(tag)[self.keep:]:
            os.remove(stale)

    def maybe_save(self, tree, now: float, tag: str = "latest") -> bool:
        if self.should_save(now):
            self.save(tree, now, tag)
            return True
        return False

    def latest_good(self, tag: str = "latest") -> Optional[str]:
        """Newest retained checkpoint whose content digest verifies: the
        canonical path first, then the rolling history newest first. None
        when no trustworthy artifact survives."""
        for cand in [self.path(tag)] + self.history(tag):
            if io.verify(cand):
                return cand
        return None

    def restore(self, like, tag: str = "latest", fallback: bool = False):
        """Restore ``tag``'s canonical checkpoint. With ``fallback=True`` a
        corrupt (or missing) canonical artifact degrades to
        :meth:`latest_good` instead of raising; only when no retained
        artifact verifies does the original error surface."""
        try:
            return io.restore(self.path(tag), like)
        except (CheckpointCorruptError, OSError, faults.InjectedFault):
            if not fallback:
                raise
            good = self.latest_good(tag)
            if good is None:
                raise
            return io.restore(good, like)
