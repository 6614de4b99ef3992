"""serve/health — one snapshot unifying every degradation signal.

The launchers (and anything operating the serving stack) should not
have to interrogate four objects to answer "is this deployment
degrading, and how": :func:`snapshot` collects the engine's queue /
shed / deadline / degraded-mode accounting, the slot's model-version
provenance and age, the re-federator's circuit-breaker state and last
outcome, and the drift monitor's trigger state into one plain-data
:class:`HealthSnapshot` with a single ``status`` verdict:

  ``ok``        nothing degrading
  ``degraded``  serving continues but something is bent — overload
                mode active, requests shed or expired, dispatch errors
                absorbed, drift trigger raised, or the last
                re-federation failed
  ``critical``  the re-federation circuit breaker is OPEN (the model
                can no longer refresh — stale-model risk compounds)

Every field is plain data (``to_dict()`` is JSON-ready), so the
snapshot is equally a log line, a metrics export, or an assertion
surface for the chaos suite (``tests/test_faults.py``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

STATUS_OK = "ok"
STATUS_DEGRADED = "degraded"
STATUS_CRITICAL = "critical"


@dataclasses.dataclass(frozen=True)
class HealthSnapshot:
    """Point-in-time degradation picture of a serving deployment.

    Sources are optional — fields from an absent component hold their
    neutral defaults, so a bare engine (no federator, no monitor) still
    snapshots cleanly."""
    status: str = STATUS_OK
    # engine
    queue_depth: int = 0
    queue_limit: Optional[int] = None
    queue_depth_ema: float = 0.0
    inflight: int = 0
    degraded_mode: bool = False
    shed: int = 0
    deadline_miss: int = 0
    dispatch_errors: int = 0
    served: int = 0
    submitted: int = 0
    dropped: int = 0
    # model slot
    model_version: Optional[int] = None
    model_round: Optional[int] = None
    model_source: Optional[str] = None
    model_age_seconds: Optional[float] = None
    staged_version: Optional[int] = None
    # re-federator
    breaker_state: Optional[str] = None
    consecutive_failures: int = 0
    refederations_completed: int = 0
    refederations_fired: int = 0
    refederation_retries: int = 0
    triggers_skipped: int = 0
    last_refederation: Optional[str] = None     # "ok" | "failed" | None
    last_error: Optional[str] = None
    refederation_busy: bool = False
    # drift monitor
    drift_statistic: Optional[float] = None
    drift_triggered: Optional[bool] = None
    drift_triggers: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @property
    def healthy(self) -> bool:
        return self.status == STATUS_OK


def _status(engine_stats, refederator, monitor) -> str:
    if refederator is not None and refederator.breaker_state == "open":
        return STATUS_CRITICAL
    bent = False
    if engine_stats is not None:
        bent |= bool(engine_stats.degraded or engine_stats.shed
                     or engine_stats.deadline_miss or engine_stats.errors
                     or engine_stats.dropped)
    if refederator is not None:
        bent |= refederator.last_outcome == "failed"
        bent |= refederator.breaker_state == "half-open"
    if monitor is not None:
        bent |= bool(monitor.triggered)
    return STATUS_DEGRADED if bent else STATUS_OK


def snapshot(engine=None, refederator=None, slot=None, monitor=None,
             now=time.time) -> HealthSnapshot:
    """Collect a :class:`HealthSnapshot` from whichever components this
    deployment has. ``slot`` defaults to ``engine.slot`` /
    ``refederator.slot`` when omitted; ``monitor`` defaults to
    ``engine.monitor``. ``model_age_seconds`` is wall time since the
    active version's publish (sidecar ``written_at``) when the slot's
    source is a checkpoint path, else None."""
    fields: Dict[str, Any] = {}
    stats = None
    if engine is not None:
        stats = engine.stats()
        fields.update(
            queue_depth=stats.pending, queue_limit=engine.queue_limit,
            queue_depth_ema=stats.queue_depth_ema,
            inflight=stats.inflight, degraded_mode=stats.degraded,
            shed=stats.shed, deadline_miss=stats.deadline_miss,
            dispatch_errors=stats.errors, served=stats.served,
            submitted=stats.submitted, dropped=stats.dropped)
        if monitor is None:
            monitor = engine.monitor
        if slot is None:
            slot = engine.slot
    if slot is None and refederator is not None:
        slot = refederator.slot
    if slot is not None:
        meta = slot.meta
        fields.update(model_version=meta.version,
                      model_round=meta.round_idx,
                      model_source=meta.source,
                      staged_version=slot.staged_version,
                      model_age_seconds=_model_age(meta, now))
    if refederator is not None:
        err = refederator.last_error
        fields.update(
            breaker_state=refederator.breaker_state,
            consecutive_failures=refederator.consecutive_failures,
            refederations_completed=refederator.completed,
            refederations_fired=refederator.fired,
            refederation_retries=refederator.retries,
            triggers_skipped=refederator.skipped,
            last_refederation=refederator.last_outcome,
            last_error=None if err is None else repr(err),
            refederation_busy=refederator.busy)
    if monitor is not None:
        fields.update(drift_statistic=monitor.statistic,
                      drift_triggered=monitor.triggered,
                      drift_triggers=monitor.trigger_count)
    fields["status"] = _status(stats, refederator, monitor)
    return HealthSnapshot(**fields)


def _model_age(meta, now) -> Optional[float]:
    """Age of the served artifact: wall seconds since its sidecar's
    ``written_at`` when the version came from a checkpoint publish."""
    source = meta.source
    if not source or source in ("init", "publish"):
        return None
    try:
        from repro_torch.api import session as session_mod
        sc = session_mod.read_sidecar(source)
        return max(0.0, float(now()) - float(sc["written_at"]))
    except Exception:
        return None
