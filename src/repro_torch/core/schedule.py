"""ScheduleSpec — the server-coordination axis as an explicit spec.

The paper's central experimental contrast (§IV-B, Fig. 2) is *when the
server aggregates*: synchronously at a barrier, or continuously with
staleness discounting. Historically that axis lived inside
``StrategyConfig.mode`` — a string entangled with the strategy presets,
which made "fedavg but asynchronous" or "ours but with a staleness
cutoff" impossible to spell. ``ScheduleSpec`` lifts it out:

  kind="sync"        barrier aggregation — the round completes when the
                     slowest participating client arrives; barrier idle
                     time is tracked explicitly.
  kind="async"       continuous aggregation — the round clock advances at
                     a QUORUM of arrivals; stragglers' updates are still
                     applied, discounted by α(τ)=α₀(1+τ)^-0.5.
  kind="semi-async"  the middle ground (Marfo et al. 2025, §IV-B): the
                     quorum clock of async, but updates staler than
                     ``max_staleness`` quorum ranks are DROPPED rather
                     than discounted — bounded-staleness aggregation.

Both simulation paths (host loop/megastep and the scanned device control
plane) consume the same ScheduleSpec; ``StrategyConfig.mode`` keeps
working through :meth:`ScheduleSpec.from_strategy` (the deprecation
shim — see the CHANGES.md migration table).

A copy of the JAX package's ``core/schedule.py``, kept identical in output.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

SCHEDULE_KINDS = ("sync", "async", "semi-async")


@dataclasses.dataclass(frozen=True)
class ScheduleSpec:
    kind: str = "sync"                    # sync | async | semi-async
    quorum: float = 0.5                   # async/semi-async: round clock
                                          # advances at this arrival frac
    max_staleness: Optional[int] = None   # semi-async only: drop updates
                                          # with quorum rank τ beyond this
    alpha0: float = 1.0                   # fresh-update weight in the
                                          # staleness discount α(τ)

    # ------------------------------------------------------------------
    @property
    def is_sync(self) -> bool:
        return self.kind == "sync"

    def issues(self) -> List[Tuple[str, object, str]]:
        """(field, value, hint) triples for every violation — feeds the
        multi-error ``SpecError`` report instead of failing field-first."""
        out = []
        if self.kind not in SCHEDULE_KINDS:
            out.append(("schedule.kind", self.kind,
                        f"expected one of {SCHEDULE_KINDS}"))
        if not (0.0 < self.quorum <= 1.0):
            out.append(("schedule.quorum", self.quorum,
                        "quorum must be in (0, 1]"))
        if self.alpha0 <= 0.0:
            out.append(("schedule.alpha0", self.alpha0,
                        "alpha0 must be > 0"))
        if self.kind == "semi-async" and self.max_staleness is None:
            out.append(("schedule.max_staleness", None,
                        "semi-async is defined by its staleness bound; "
                        "set max_staleness >= 0 (or use kind='async' for "
                        "unbounded discounted staleness)"))
        if self.max_staleness is not None:
            if self.kind == "sync":
                out.append(("schedule.max_staleness", self.max_staleness,
                            "max_staleness is an async-family knob; a "
                            "sync barrier has no stale arrivals"))
            elif self.max_staleness < 0:
                out.append(("schedule.max_staleness", self.max_staleness,
                            "max_staleness must be >= 0"))
        return out

    def validate(self) -> "ScheduleSpec":
        issues = self.issues()
        if issues:
            raise ValueError(
                "invalid ScheduleSpec: "
                + "; ".join(f"{f}={v!r}: {h}" for f, v, h in issues))
        return self

    # ------------------------------------------------------------------
    # deprecation shim: the legacy StrategyConfig.mode spelling
    # ------------------------------------------------------------------
    @classmethod
    def from_strategy(cls, strategy) -> "ScheduleSpec":
        """Derive the schedule a legacy ``StrategyConfig`` implies.

        ``mode``/``quorum``/``alpha0`` on StrategyConfig are the old
        spelling of this axis; every preset and call-site that still
        sets them keeps working through this shim (migration:
        ``StrategyConfig.mode`` → ``ExperimentSpec.schedule``).
        """
        return cls(kind=getattr(strategy, "mode", "sync"),
                   quorum=getattr(strategy, "quorum", 0.5),
                   alpha0=getattr(strategy, "alpha0", 1.0))


def resolve_schedule(schedule, strategy) -> ScheduleSpec:
    """Normalize the spec-level ``schedule`` axis.

    ``None``          -> derived from the strategy (legacy shim);
    ``str``           -> that kind over the strategy's quorum/alpha0;
    ``ScheduleSpec``  -> taken as-is (overrides the strategy's mode).
    """
    base = ScheduleSpec.from_strategy(strategy)
    if schedule is None:
        return base
    if isinstance(schedule, str):
        return dataclasses.replace(base, kind=schedule)
    if isinstance(schedule, ScheduleSpec):
        return schedule
    raise TypeError(f"cannot resolve schedule from {type(schedule)}; "
                    "expected None, a kind string or a ScheduleSpec")
