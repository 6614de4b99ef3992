"""Batched streaming inference engine for the global anomaly detector.

The train side of the repo produces a global model; this is the *serve*
side: a request queue + micro-batching scoring loop that turns
individual flow-scoring requests into fixed-shape batched dispatches.

Design points:

- **Power-of-two batch buckets.** A micro-batch of ``n`` requests is
  padded up to the next power of two (capped at ``max_batch``), so every
  shape the scorer ever sees is one of ``log2(max_batch)+1`` buckets (the
  JAX package compiles one scorer a bucket; here the scorer runs eagerly
  on the slot's device, and a CUDA graph a bucket would need no more
  shapes than these). Padded tail rows are masked out of responses AND
  out of the drift monitor's statistics.
- **Drift monitoring in the pump.** When a :class:`~repro_torch.serve.
  monitor.DriftMonitor` is attached, its EMA update runs on the padded
  batch right after the scorer, on the same device; the probabilities,
  the scores and the scalar statistic come back to the host in ONE copy
  a pump, the statistic for the trigger policy.
- **Hot-swap at batch boundaries.** Every pump acquires
  ``(params, version)`` from the :class:`~repro_torch.serve.swap.
  ModelSlot` ONCE — a batch never mixes models, a staged publish flips
  in O(1) between batches, and every response is stamped with the
  version that scored it. Nothing is ever dropped on a swap: requests
  queued across a publish are scored by whichever model is active when
  their batch runs.
- **Latency/throughput accounting.** Per-request enqueue->response
  latency feeds p50/p99 percentiles (overall and per bucket) and
  flows/sec.

Graceful degradation: traffic bursts and dispatch faults must
bend the engine, never break it —

- **Bounded queue + admission control.** ``queue_limit`` caps the
  request deque; an arrival over the cap is SHED at admission (counted
  in ``ServeStats.shed``, raised as :class:`QueueFullError` from
  :meth:`submit`, returned as ``None`` from :meth:`try_submit`) —
  latency under overload is bounded by queue depth instead of growing
  without limit, and every *accepted* request is still answered.
- **Per-request deadlines.** ``deadline_ms`` (engine default or per
  :meth:`submit`) stamps an expiry; a request whose deadline passes
  while queued is answered with an explicit ``expired=True`` response
  (counted in ``ServeStats.deadline_miss``) instead of being scored
  late or silently dropped.
- **Overload-driven degraded mode.** A queue-depth EMA crossing
  ``degrade_high``·``queue_limit`` flips the engine into degraded mode
  (hysteresis at ``degrade_low``): batches score through the plain
  scorer WITHOUT the drift-monitor statistics, shrinking the pump's
  device work exactly when throughput matters most;
  ``ServeStats.degraded`` and ``degraded_pumps`` expose it,
  ``serve/health.py`` aggregates it.
- **Dispatch-fault absorption.** A scoring dispatch that raises
  (including ``repro_torch.faults`` injected scorer faults) re-queues
  its requests AT THE FRONT in order and returns — the batch retries on the
  next pump; only ``max_dispatch_retries`` CONSECUTIVE failures
  re-raise. Accepted requests survive transient scorer faults —
  ``dropped`` stays 0 by construction, now with in-flight accounting
  (:class:`ServeStats`) so it can never transiently go negative either.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import mlp_detector
from repro_torch.serve.swap import ModelSlot


class QueueFullError(RuntimeError):
    """Admission control shed this request: the bounded queue is at
    ``queue_limit``. The request was NEVER accepted — nothing is owed a
    response — and the shed is counted in ``ServeStats.shed``."""


@dataclasses.dataclass(frozen=True)
class Response:
    """One scored request."""
    request_id: int
    probs: np.ndarray          # (num_classes,) class probabilities
    score: float               # anomaly score: 1 - P(class 0 / Normal)
    model_version: int         # ModelSlot version that scored it
    latency: float             # seconds, submit -> response
    expired: bool = False      # deadline passed while queued — probs and
    #                            score are NaN-filled, never model output


@dataclasses.dataclass(frozen=True)
class ServeStats:
    submitted: int             # ACCEPTED requests (shed never counts)
    served: int                # responses returned (scored + expired)
    pending: int
    inflight: int              # popped for a dispatch, not yet answered
    dropped: int               # zero by construction; reported to prove it
    shed: int                  # admission rejections (queue_limit)
    deadline_miss: int         # answered expired (deadline passed queued)
    errors: int                # scoring-dispatch failures (batch retried)
    degraded: bool             # currently in skip-monitor degraded mode
    degraded_pumps: int        # scoring pumps run in degraded mode
    queue_depth_ema: float     # the overload detector's smoothed depth
    swaps: int                 # model flips observed by the scoring loop
    p50_ms: float
    p99_ms: float
    flows_per_sec: float       # scored rows / busy (scoring) seconds
    busy_seconds: float
    by_bucket: Dict[int, dict]  # bucket -> {count, p50_ms, p99_ms,
    #                                        flows_per_sec}


def _percentile(lat: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(lat), q)) if lat else 0.0


class ServeEngine:
    """Request-queue + micro-batching scoring loop.

    The engine is single-consumer (one thread calls :meth:`pump` /
    :meth:`drain`) but multi-producer: :meth:`submit` is thread-safe, as
    is a background thread publishing models into the slot. ``cfg`` is
    an mlp-family ``ArchConfig`` (the paper's detector); ``score_fn``
    overrides the default ``mlp_detector.predict`` scorer with any
    ``(params, x) -> (B, num_classes) probs`` callable on tensors. The
    engine scores on its slot's device; an attached monitor must live
    there too.

    Robustness knobs (all optional — by default the queue is unbounded
    and requests carry no deadline): ``queue_limit`` bounds the queue
    (admission shed), ``deadline_ms`` stamps a default per-request expiry,
    ``degrade_high``/``degrade_low`` are the queue-depth-EMA hysteresis
    fractions of ``queue_limit`` for degraded mode, ``injector`` wires a
    ``repro_torch.faults.FaultInjector`` into the scoring dispatch (site
    ``"scorer"``), ``max_dispatch_retries`` caps consecutive dispatch
    failures before the error propagates.
    """

    def __init__(self, slot: ModelSlot, cfg, *, max_batch: int = 256,
                 monitor=None, score_fn: Optional[Callable] = None,
                 now: Callable[[], float] = time.perf_counter,
                 queue_limit: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 degrade_high: float = 0.75, degrade_low: float = 0.25,
                 ema_decay: float = 0.9, max_dispatch_retries: int = 8,
                 injector=None):
        if max_batch < 1 or (max_batch & (max_batch - 1)) != 0:
            raise ValueError(
                f"max_batch must be a power of two >= 1, got {max_batch} "
                "(batch buckets are powers of two so the scorer sees few "
                "shapes)")
        if queue_limit is not None and queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        if not (0.0 <= degrade_low < degrade_high <= 1.0):
            raise ValueError(
                f"need 0 <= degrade_low < degrade_high <= 1, got "
                f"({degrade_low}, {degrade_high}) — the hysteresis band "
                "that keeps degraded mode from flapping")
        if not (0.0 <= ema_decay < 1.0):
            raise ValueError(f"ema_decay must be in [0, 1), got {ema_decay}")
        if max_dispatch_retries < 1:
            raise ValueError(
                f"max_dispatch_retries must be >= 1, got "
                f"{max_dispatch_retries}")
        if monitor is not None and monitor.device != slot.device:
            raise ValueError(
                f"the monitor lives on {monitor.device} and the slot on "
                f"{slot.device}; the drift update runs on the scoring "
                "batch, so both must share a device")
        self.slot = slot
        self.cfg = cfg
        self.max_batch = int(max_batch)
        self.monitor = monitor
        self.now = now
        self._now0 = now()
        self.queue_limit = None if queue_limit is None else int(queue_limit)
        self.deadline_ms = deadline_ms
        self.degrade_high = float(degrade_high)
        self.degrade_low = float(degrade_low)
        self.ema_decay = float(ema_decay)
        self.max_dispatch_retries = int(max_dispatch_retries)
        self.injector = injector
        # the scorer without the monitor is also the degraded-mode path
        # when a monitor is attached: skipping the drift statistics
        # shrinks the pump's device work under overload
        self._predict = score_fn or (
            lambda p, x: mlp_detector.predict(p, x, cfg))

        self._lock = threading.Lock()
        self._queue: collections.deque = collections.deque()
        self._next_id = 0
        self._closed = False
        self.on_trigger: Optional[Callable[[], Any]] = None

        self.submitted = 0
        self.served = 0
        self.errors = 0
        self.shed = 0
        self.deadline_miss = 0
        self._inflight = 0
        self._degraded = False
        self._degraded_pumps = 0
        self._depth_ema = 0.0
        self._dispatch_failures = 0      # CONSECUTIVE; success resets
        self._busy = 0.0
        self._latencies: List[float] = []
        self._by_bucket: Dict[int, dict] = {}
        self._versions_served: set = set()
        self._swaps_seen = 0
        self._last_version: Optional[int] = None

    # ------------------------------------------------------------------
    # producers
    # ------------------------------------------------------------------
    def _admit(self, x, deadline_ms) -> Optional[int]:
        x = np.asarray(x, np.float32)
        if x.shape != (self.cfg.num_features,):
            raise ValueError(
                f"expected one flow of shape ({self.cfg.num_features},), "
                f"got {x.shape}")
        dl = self.deadline_ms if deadline_ms is None else deadline_ms
        with self._lock:
            if self._closed:
                raise RuntimeError(
                    "ServeEngine is shut down — no new requests accepted")
            if self.queue_limit is not None \
                    and len(self._queue) >= self.queue_limit:
                self.shed += 1
                return None
            rid = self._next_id
            self._next_id += 1
            self.submitted += 1
            t_in = self.now()
            expiry = None if dl is None else t_in + float(dl) / 1e3
            self._queue.append((rid, x, t_in, expiry))
        return rid

    def submit(self, x, *, deadline_ms: Optional[float] = None) -> int:
        """Enqueue one flow (``(num_features,)``) for scoring; returns
        its request id. Raises :class:`QueueFullError` when admission
        control sheds it (bounded queue at ``queue_limit``) and
        RuntimeError after :meth:`shutdown`. ``deadline_ms`` overrides
        the engine-default expiry for this request."""
        rid = self._admit(x, deadline_ms)
        if rid is None:
            raise QueueFullError(
                f"queue at limit ({self.queue_limit}) — request shed "
                "(ServeStats.shed counts it; use try_submit for a "
                "non-raising probe)")
        return rid

    def try_submit(self, x, *,
                   deadline_ms: Optional[float] = None) -> Optional[int]:
        """:meth:`submit` that returns None instead of raising when the
        bounded queue sheds the request — the burst-load producer API."""
        return self._admit(x, deadline_ms)

    def submit_many(self, X, *, best_effort: bool = False,
                    deadline_ms: Optional[float] = None) -> List[int]:
        """Enqueue each row of ``(n, num_features)`` — one request per
        flow (micro-batching regroups them into buckets). With
        ``best_effort=True`` shed rows are skipped (their ids omitted)
        instead of raising :class:`QueueFullError`."""
        out = []
        for row in np.asarray(X, np.float32):
            rid = self._admit(row, deadline_ms)
            if rid is None and not best_effort:
                raise QueueFullError(
                    f"queue at limit ({self.queue_limit}) — request shed "
                    f"after {len(out)} rows (best_effort=True skips "
                    "instead)")
            if rid is not None:
                out.append(rid)
        return out

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def degraded(self) -> bool:
        with self._lock:
            return self._degraded

    @property
    def queue_depth_ema(self) -> float:
        with self._lock:
            return self._depth_ema

    # ------------------------------------------------------------------
    # the scoring loop
    # ------------------------------------------------------------------
    def bucket_for(self, n: int) -> int:
        """Smallest power-of-two bucket holding ``n`` requests (<= the
        ``max_batch`` cap, since pumps never take more than that)."""
        if not 1 <= n <= self.max_batch:
            raise ValueError(f"n={n} outside [1, {self.max_batch}]")
        return 1 << (n - 1).bit_length()

    def _expired_responses(self, expired, t_now) -> List[Response]:
        """Answer deadline-missed requests explicitly — NaN payload,
        ``expired=True`` — and account them (served + deadline_miss).
        They are answered, never dropped: zero-drop covers them."""
        if not expired:
            return []
        version = self.slot.meta.version
        nan_probs = np.full((self.cfg.num_classes,), np.nan, np.float32)
        out = [Response(request_id=rid, probs=nan_probs,
                        score=float("nan"), model_version=version,
                        latency=t_now - t_in, expired=True)
               for rid, _x, t_in, _dl in expired]
        with self._lock:
            self.served += len(out)
            self.deadline_miss += len(out)
        return out

    def pump(self) -> List[Response]:
        """Score ONE micro-batch: flip in any staged model, expire
        deadline-missed requests, take up to ``max_batch`` queued
        requests, pad to the power-of-two bucket, dispatch, stamp
        responses. Returns [] when the queue is empty. A dispatch
        failure re-queues the batch at the front and returns the
        expired responses only (retry on the next pump)."""
        t_now = self.now()
        with self._lock:
            depth = len(self._queue)
            self._depth_ema = (self.ema_decay * self._depth_ema
                               + (1.0 - self.ema_decay) * depth)
            if self.queue_limit is not None:
                if (not self._degraded and self._depth_ema
                        > self.degrade_high * self.queue_limit):
                    self._degraded = True
                elif (self._degraded and self._depth_ema
                        < self.degrade_low * self.queue_limit):
                    self._degraded = False
            reqs, expired = [], []
            while self._queue and len(reqs) < self.max_batch:
                entry = self._queue.popleft()
                if entry[3] is not None and t_now > entry[3]:
                    expired.append(entry)
                else:
                    reqs.append(entry)
            self._inflight += len(reqs)
            degraded = self._degraded
            use_monitor = self.monitor is not None and not degraded
            if reqs and degraded:
                self._degraded_pumps += 1
        out = self._expired_responses(expired, t_now)
        if not reqs:
            return out

        t0 = self.now()
        params, meta = self.slot.acquire()
        if self._last_version is not None \
                and meta.version != self._last_version:
            self._swaps_seen += 1
        self._last_version = meta.version
        n = len(reqs)
        bucket = self.bucket_for(n)
        xpad = np.zeros((bucket, self.cfg.num_features), np.float32)
        for i, (_rid, x, _t, _dl) in enumerate(reqs):
            xpad[i] = x
        fired = False
        try:
            if self.injector is not None:
                self.injector.check("scorer")
            probs, scores, mstate, stat = self._score(params, xpad, n,
                                                      use_monitor)
        except Exception:
            # graceful absorption: the batch goes BACK to the front of
            # the queue in order — accepted requests are never lost to a
            # transient dispatch fault; persistent failure (consecutive
            # > max_dispatch_retries) propagates to the caller
            with self._lock:
                self._queue.extendleft(reversed(reqs))
                self._inflight -= n
                self.errors += 1
                self._dispatch_failures += 1
                give_up = self._dispatch_failures > self.max_dispatch_retries
            if give_up:
                raise
            return out
        t_done = self.now()
        if use_monitor:
            fired = self.monitor.observe(mstate, stat)

        lats = []
        for i, (rid, _x, t_in, _dl) in enumerate(reqs):
            lat = t_done - t_in
            lats.append(lat)
            out.append(Response(request_id=rid, probs=probs[i],
                                score=float(scores[i]),
                                model_version=meta.version, latency=lat))
        dt = t_done - t0
        with self._lock:
            self._dispatch_failures = 0
            self.served += n
            self._inflight -= n
            self._busy += dt
            self._latencies.extend(lats)
            self._versions_served.add(meta.version)
            b = self._by_bucket.setdefault(
                bucket, {"count": 0, "rows": 0, "seconds": 0.0,
                         "latencies": []})
            b["count"] += 1
            b["rows"] += n
            b["seconds"] += dt
            b["latencies"].extend(lats)
        if fired and self.on_trigger is not None:
            self.on_trigger()
        return out

    @torch.no_grad()
    def _score(self, params, xpad: np.ndarray, n: int, use_monitor: bool):
        """Score one padded batch on the slot's device: one copy in, and
        one copy back of the probabilities, the scores and (with the
        monitor) its statistic, the pump's one wait for the device.
        Returns numpy (bucket, num_classes) probabilities and (bucket,)
        scores, and the monitor's new state and statistic (a 0-dim CPU
        tensor), or None for both."""
        x = torch.from_numpy(xpad).to(self.slot.device)
        probs = self._predict(params, x)
        scores = 1.0 - probs[:, 0]
        parts = [probs, scores[:, None]]
        mstate = stat = None
        if use_monitor:
            mask = (torch.arange(x.shape[0], device=x.device) < n).to(
                torch.float32)
            mstate, stat = self.monitor.step(
                self.monitor.state, self.monitor.reference, x, scores,
                mask=mask)
            parts.append(stat.reshape(1, 1).expand(x.shape[0], 1))
        host = torch.cat(parts, dim=1).cpu()        # device sync point
        k = probs.shape[1]
        if use_monitor:
            stat = host[0, k + 1]
        host = host.numpy()
        return host[:, :k], host[:, k], mstate, stat

    def drain(self) -> List[Response]:
        """Pump until the queue is empty (requests submitted by other
        threads DURING the drain are served too)."""
        out: List[Response] = []
        while self.pending:
            out.extend(self.pump())
        return out

    def shutdown(self) -> ServeStats:
        """Drain every queued request, then refuse new submissions —
        the zero-dropped-requests guarantee is checkable afterwards as
        ``stats().served == stats().submitted``."""
        while True:
            with self._lock:
                if not self._queue:
                    self._closed = True
                    break
            self.pump()
        return self.stats()

    # ------------------------------------------------------------------
    # accounting
    # ------------------------------------------------------------------
    def reset_stats(self) -> None:
        """Zero the latency/throughput accounting (e.g. after a warmup
        pass, so compile time stays out of steady-state percentiles).
        Model versions, swap counters, degraded-mode state and the
        request-id sequence are preserved. Call only with an empty
        queue and no in-flight batch — in-flight requests submitted
        before a reset would count as served-but-never-submitted."""
        with self._lock:
            if self._queue or self._inflight:
                raise RuntimeError(
                    f"reset_stats with {len(self._queue)} requests "
                    f"queued and {self._inflight} in flight — drain "
                    "first")
            self.submitted = 0
            self.served = 0
            self.errors = 0
            self.shed = 0
            self.deadline_miss = 0
            self._degraded_pumps = 0
            self._busy = 0.0
            self._latencies = []
            self._by_bucket = {}

    def stats(self) -> ServeStats:
        """One consistent snapshot: every counter (and the queue/
        in-flight depths the derived ``dropped`` needs) is read under a
        single lock acquisition, so ``dropped`` can never transiently go
        negative under concurrent submitters or a racing
        :meth:`reset_stats` (it counts only what was popped for a
        dispatch and not yet answered — the ``inflight`` field)."""
        with self._lock:
            submitted, served = self.submitted, self.served
            pending, inflight = len(self._queue), self._inflight
            lat = list(self._latencies)
            busy = self._busy
            by_bucket = {
                k: {"count": v["count"], "rows": v["rows"],
                    "p50_ms": round(_percentile(v["latencies"], 50) * 1e3,
                                    4),
                    "p99_ms": round(_percentile(v["latencies"], 99) * 1e3,
                                    4),
                    "flows_per_sec": round(
                        v["rows"] / max(v["seconds"], 1e-9), 1)}
                for k, v in sorted(self._by_bucket.items())}
            return ServeStats(
                submitted=submitted, served=served,
                pending=pending, inflight=inflight,
                dropped=submitted - served - pending - inflight,
                shed=self.shed, deadline_miss=self.deadline_miss,
                errors=self.errors, degraded=self._degraded,
                degraded_pumps=self._degraded_pumps,
                queue_depth_ema=round(self._depth_ema, 4),
                swaps=self._swaps_seen,
                p50_ms=round(_percentile(lat, 50) * 1e3, 4),
                p99_ms=round(_percentile(lat, 99) * 1e3, 4),
                flows_per_sec=round(
                    (served - self.deadline_miss) / max(busy, 1e-9), 1),
                busy_seconds=round(busy, 4),
                by_bucket=by_bucket)

    @property
    def versions_served(self) -> List[int]:
        with self._lock:
            return sorted(self._versions_served)
