"""The port's serving layer under injected chaos, case by case after the
serving classes of the JAX package's ``tests/test_faults.py``: the
bounded queue and shedding, deadlines, the degraded-mode hysteresis,
scorer-fault absorption, the re-federator's retries, backoff and circuit
breaker, and the health snapshot, with the injectable clock and the
port's own seeded fault injector (``repro_torch.faults``); then the
chaos mix against the JAX package's engine on the same weights, flows and
fault schedule (ids and counts equal), and a stress test of concurrent
submitters."""
import json
import sys
import threading

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax

from repro import faults as jfaults
from repro import serve as jserve
from repro.configs import anomaly_mlp as janomaly
from repro.models import api as jmodel_api

import repro_torch as T
from repro_torch.api import parity
from repro_torch.configs import anomaly_mlp
from repro_torch.faults import (BurstSpec, FaultInjector, FaultSpec,
                                InjectedFault)
from repro_torch.models import api as model_api
from repro_torch.serve import (DriftMonitor, ModelSlot, QueueFullError,
                               Refederator, ServeEngine, health_snapshot)
from repro_torch.serve import health as health_mod

CFG = anomaly_mlp.SMOKE


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these cases run many tiny operations, and where
    several test workers share the machine, more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(seed=0):
    return model_api.init_params(torch.Generator().manual_seed(seed), CFG)


def _slot(**kw):
    return ModelSlot(_params(), device="cpu", **kw)


def _flows(seed, n):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, CFG.num_features)).astype(np.float32)


class _Clock:
    """Injectable monotonic clock for deadline tests."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------
# engine: admission control + deadlines + degraded mode + absorption
# ---------------------------------------------------------------------
class TestBoundedQueue:
    def test_shed_at_limit_and_zero_drop_of_accepted(self):
        eng = ServeEngine(_slot(), CFG, max_batch=8, queue_limit=4)
        for i in range(4):
            eng.submit(_flows(i, 1)[0])
        with pytest.raises(QueueFullError, match="queue at limit"):
            eng.submit(_flows(9, 1)[0])
        assert eng.try_submit(_flows(9, 1)[0]) is None
        stats = eng.shutdown()
        assert stats.submitted == stats.served == 4
        assert stats.shed == 2 and stats.dropped == 0

    def test_submit_many_best_effort_skips_shed_rows(self):
        eng = ServeEngine(_slot(), CFG, max_batch=8, queue_limit=3)
        with pytest.raises(QueueFullError):
            eng.submit_many(_flows(0, 5))
        eng.drain()
        ids = eng.submit_many(_flows(1, 5), best_effort=True)
        assert len(ids) == 3
        stats = eng.shutdown()
        assert stats.served == stats.submitted
        assert stats.shed >= 2 and stats.dropped == 0

    def test_burst_windows_shed_but_never_drop(self):
        burst = BurstSpec(period=3, mult=6, phase=2)
        eng = ServeEngine(_slot(), CFG, max_batch=16, queue_limit=16)
        for w, size in enumerate(burst.sizes(6, 8)):
            eng.submit_many(_flows(100 + w, size), best_effort=True)
            eng.pump()
        stats = eng.shutdown()
        assert stats.shed > 0                    # bursts overflowed
        assert stats.served == stats.submitted   # accepted all answered
        assert stats.dropped == 0 and stats.errors == 0


class TestDeadlines:
    def test_expired_requests_answered_with_nan(self):
        clock = _Clock()
        eng = ServeEngine(_slot(), CFG, max_batch=8, now=clock,
                          deadline_ms=10.0)
        eng.submit(_flows(0, 1)[0])                       # default 10ms
        eng.submit(_flows(1, 1)[0], deadline_ms=1000.0)   # override
        clock.t = 0.5                                     # 500ms later
        out = eng.pump()
        assert len(out) == 2
        by_id = {r.request_id: r for r in out}
        assert by_id[0].expired and np.isnan(by_id[0].score)
        assert np.all(np.isnan(by_id[0].probs))
        assert by_id[0].probs.shape == (CFG.num_classes,)
        assert not by_id[1].expired and not np.isnan(by_id[1].score)
        stats = eng.shutdown()
        assert stats.deadline_miss == 1
        assert stats.served == stats.submitted == 2
        assert stats.dropped == 0

    def test_expired_latency_excluded_from_percentiles(self):
        clock = _Clock()
        eng = ServeEngine(_slot(), CFG, max_batch=8, now=clock)
        eng.submit(_flows(0, 1)[0], deadline_ms=1.0)
        clock.t = 9.0                                     # huge miss
        eng.submit(_flows(1, 1)[0])
        eng.drain()
        stats = eng.shutdown()
        assert stats.deadline_miss == 1
        # the 9-second expired wait must not pollute scoring latency
        assert stats.p99_ms < 9000.0


class TestDegradedMode:
    def _overload_engine(self, monitor=None):
        # ema_decay=0 -> the EMA IS the instantaneous depth, so the
        # hysteresis thresholds are exact and the test deterministic
        return ServeEngine(_slot(), CFG, max_batch=8, monitor=monitor,
                           queue_limit=40, degrade_high=0.5,
                           degrade_low=0.25, ema_decay=0.0)

    def test_hysteresis_enters_and_exits(self):
        eng = self._overload_engine()
        eng.submit_many(_flows(0, 30))      # depth 30 > 0.5*40
        eng.pump()
        assert eng.degraded
        eng.drain()                          # depth falls under 0.25*40
        eng.pump()                           # one empty pump re-evaluates
        assert not eng.degraded
        stats = eng.shutdown()
        assert stats.degraded_pumps >= 1
        assert stats.served == stats.submitted and stats.dropped == 0

    def test_degraded_pumps_skip_drift_monitor(self):
        x = _flows(0, 256)
        mon = DriftMonitor.from_sample(x, np.abs(x[:, 0]), threshold=0.5,
                                       patience=1, device="cpu")
        eng = self._overload_engine(monitor=mon)
        before = float(mon.state.count)
        eng.submit_many(_flows(1, 30) + 5.0)   # wildly shifted traffic
        eng.pump()
        assert eng.degraded
        # shifted windows scored while degraded never feed the monitor
        assert float(mon.state.count) == before
        assert not mon.triggered
        eng.drain()
        eng.shutdown()

    def test_engine_validates_its_knobs(self):
        for kw, match in ((dict(queue_limit=0), "queue_limit"),
                          (dict(degrade_low=0.5, degrade_high=0.5),
                           "hysteresis"),
                          (dict(ema_decay=1.0), "ema_decay"),
                          (dict(max_dispatch_retries=0),
                           "max_dispatch_retries")):
            with pytest.raises(ValueError, match=match):
                ServeEngine(_slot(), CFG, **kw)


class TestScorerFaults:
    def test_transient_fault_requeues_in_order(self):
        inj = FaultInjector(FaultSpec(at={"scorer": (0,)}))
        eng = ServeEngine(_slot(), CFG, max_batch=8, injector=inj)
        eng.submit_many(_flows(0, 5))
        assert eng.pump() == []                  # absorbed, requeued
        assert eng.stats().errors == 1
        assert eng.stats().pending == 5 and eng.stats().inflight == 0
        out = eng.pump()                         # retry succeeds
        assert [r.request_id for r in out] == [0, 1, 2, 3, 4]
        stats = eng.shutdown()
        assert stats.served == stats.submitted == 5
        assert stats.dropped == 0 and stats.errors == 1

    def test_persistent_fault_raises_after_budget(self):
        inj = FaultInjector(FaultSpec(scorer_p=1.0))
        eng = ServeEngine(_slot(), CFG, max_batch=8, injector=inj,
                          max_dispatch_retries=2)
        eng.submit_many(_flows(0, 3))
        assert eng.pump() == []                  # failures 1, 2 absorbed
        assert eng.pump() == []
        with pytest.raises(InjectedFault, match="scorer"):
            eng.pump()                           # consecutive > budget
        stats = eng.stats()
        assert stats.pending == 3 and stats.inflight == 0
        assert stats.dropped == 0                # still owed, not lost

    def test_success_resets_consecutive_failure_budget(self):
        inj = FaultInjector(FaultSpec(at={"scorer": (0, 2)}))
        eng = ServeEngine(_slot(), CFG, max_batch=8, injector=inj,
                          max_dispatch_retries=1)
        eng.submit_many(_flows(0, 2))
        assert eng.pump() == []                  # fault #0 absorbed
        assert len(eng.pump()) == 2              # success resets counter
        eng.submit_many(_flows(1, 2))
        assert eng.pump() == []                  # fault #2: budget fresh
        assert len(eng.pump()) == 2
        stats = eng.shutdown()
        assert stats.served == stats.submitted == 4
        assert stats.errors == 2 and stats.dropped == 0

    def test_a_failing_score_fn_is_absorbed_like_an_injected_fault(self):
        calls = []

        def flaky(params, x):
            calls.append(x.shape[0])
            if len(calls) == 1:
                raise RuntimeError("device fault")
            return torch.softmax(x[:, :CFG.num_classes], dim=-1)
        eng = ServeEngine(_slot(), CFG, max_batch=8, score_fn=flaky)
        eng.submit_many(_flows(0, 3))
        assert eng.pump() == []
        assert [r.request_id for r in eng.pump()] == [0, 1, 2]
        stats = eng.shutdown()
        assert stats.errors == 1 and stats.dropped == 0

    def test_chaos_mix_never_drops_accepted(self):
        """Scorer faults + deadlines + bounded queue + bursts at once:
        every accepted request is answered exactly once."""
        accepted, answered, stats, _out = _chaos_mix(
            lambda **kw: ServeEngine(_slot(), CFG, **kw),
            FaultInjector(FaultSpec(seed=5, scorer_p=0.25,
                                    burst=BurstSpec(period=3, mult=5))))
        assert sorted(answered) == sorted(accepted)
        assert stats.dropped == 0
        assert stats.errors > 0                  # chaos actually fired
        assert stats.shed > 0


def _chaos_mix(make_engine, inj):
    eng = make_engine(max_batch=16, queue_limit=32, deadline_ms=60_000.0,
                      injector=inj)
    accepted, answered, responses = [], [], []
    for w, size in enumerate(inj.spec.burst.sizes(9, 8)):
        accepted += eng.submit_many(_flows(w, size), best_effort=True)
        got = eng.pump()
        responses += got
        answered += [r.request_id for r in got]
    while eng.pending:
        got = eng.pump()
        responses += got
        answered += [r.request_id for r in got]
    stats = eng.shutdown()
    return accepted, answered, stats, responses


def test_chaos_mix_matches_jax():
    """The chaos mix on the same weights, flows and fault schedule in
    both packages: the same requests accepted, shed and answered in the
    same order with the same versions, the same counts, and the
    probabilities by ``parity.serve_mismatches``."""
    jcfg = janomaly.SMOKE
    jp = jmodel_api.init_params(jax.random.PRNGKey(1), jcfg)
    kw = dict(seed=5, scorer_p=0.25)
    got = _chaos_mix(
        lambda **k: ServeEngine(ModelSlot(T.params_from_jax(jp, "cpu"),
                                          device="cpu"), CFG, **k),
        FaultInjector(FaultSpec(**kw, burst=BurstSpec(period=3, mult=5))))
    want = _chaos_mix(
        lambda **k: jserve.ServeEngine(jserve.ModelSlot(jp), jcfg, **k),
        jfaults.FaultInjector(jfaults.FaultSpec(
            **kw, burst=jfaults.BurstSpec(period=3, mult=5))))
    assert got[0] == want[0] and got[1] == want[1]
    for f in ("submitted", "served", "shed", "deadline_miss", "errors",
              "dropped", "degraded_pumps", "swaps"):
        assert getattr(got[2], f) == getattr(want[2], f), f
    assert parity.serve_mismatches(got[3], want[3]) == []


def test_concurrent_submitters_are_all_answered():
    """More submitter threads than cores race the scoring loop with a
    short switch interval: every accepted id is answered exactly once,
    shed and accepted add up, and nothing is dropped."""
    eng = ServeEngine(_slot(), CFG, max_batch=16, queue_limit=64)
    per, threads = 120, 12
    accepted = [[] for _ in range(threads)]

    def submitter(k):
        X = _flows(1000 + k, per)
        for i in range(0, per, 8):
            accepted[k] += eng.submit_many(X[i:i + 8], best_effort=True)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=submitter, args=(k,), daemon=True)
              for k in range(threads)]
        for t in ts:
            t.start()
        answered = []
        while any(t.is_alive() for t in ts) or eng.pending:
            answered += [r.request_id for r in eng.pump()]
        for t in ts:
            t.join(10)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    ids = [i for a in accepted for i in a]
    assert sorted(answered) == sorted(ids) == list(range(len(ids)))
    stats = eng.shutdown()
    assert stats.submitted + stats.shed == per * threads
    assert stats.served == stats.submitted and stats.dropped == 0


# ---------------------------------------------------------------------
# refederator: retry / backoff / breaker / join
# ---------------------------------------------------------------------
class _ScriptedRefederator(Refederator):
    """Refederator whose attempts follow a boolean script (True =
    raise) — exercises the retry/backoff/breaker machinery without
    running real federation sessions."""

    def __init__(self, script, **kw):
        kw.setdefault("background", False)
        kw.setdefault("sleep", lambda s: self.sleeps.append(s))
        self.sleeps = []
        super().__init__(_slot(), lambda k: None,
                         ckpt_dir="/nonexistent/unused", device="cpu",
                         **kw)
        self._script = list(script)
        self.attempts = 0

    def _attempt(self, k):
        i = self.attempts
        self.attempts += 1
        if i < len(self._script) and self._script[i]:
            raise RuntimeError(f"scripted failure #{i}")


class TestRefederatorRetries:
    def test_retries_until_success_within_budget(self):
        r = _ScriptedRefederator([True, True, False], max_retries=2)
        assert r.fire()
        assert r.attempts == 3 and r.completed == 1 and r.retries == 2
        assert r.last_outcome == "ok" and r.last_error is None
        assert r.breaker_state == "closed" and r.consecutive_failures == 0
        assert len(r.sleeps) == 2               # backoff between attempts

    def test_backoff_is_exponential_capped_and_deterministic(self):
        kw = dict(max_retries=3, backoff_base=0.5, backoff_factor=4.0,
                  max_backoff=3.0, jitter=0.1, seed=11)
        a = _ScriptedRefederator([True] * 4, **kw)
        b = _ScriptedRefederator([True] * 4, **kw)
        a.fire()
        b.fire()
        assert a.sleeps == b.sleeps             # seeded jitter
        assert len(a.sleeps) == 3
        for i, s in enumerate(a.sleeps):
            base = min(3.0, 0.5 * 4.0 ** i)
            assert base <= s <= base * 1.1      # jitter in [0, 10%]
        assert a.last_outcome == "failed" and a.consecutive_failures == 1

    def test_backoff_draws_the_reference_jitter(self):
        """The seeded jitter is the JAX package's: the same generator
        ``np.random.default_rng([seed, firing])`` in the same order."""
        kw = dict(max_retries=3, backoff_base=0.5, backoff_factor=2.0,
                  max_backoff=30.0, jitter=0.1, seed=3)
        a = _ScriptedRefederator([True] * 8, **kw)
        a.fire()
        a.fire()
        jsleeps = []
        j = jserve.Refederator(jserve.ModelSlot(
            {"w": np.zeros(2, np.float32)}), lambda k: None,
            ckpt_dir="/nonexistent/unused", background=False,
            sleep=jsleeps.append, **kw)
        j._attempt = lambda k: (_ for _ in ()).throw(RuntimeError("x"))
        j.fire()
        j.fire()
        assert a.sleeps == jsleeps and len(jsleeps) == 6

    def test_breaker_opens_after_threshold_consecutive_failures(self):
        r = _ScriptedRefederator([True] * 10, max_retries=0,
                                 breaker_threshold=2, breaker_cooldown=1)
        assert r.fire() and r.breaker_state == "closed"
        assert r.fire() and r.breaker_state == "open"
        assert r.consecutive_failures == 2
        # cooldown: the next trigger is swallowed without an attempt
        before = r.attempts
        assert not r.fire()
        assert r.attempts == before and r.skipped == 1
        # then the half-open probe runs ONE attempt and re-opens
        assert r.fire()
        assert r.attempts == before + 1
        assert r.breaker_state == "open" and r.retries == 0

    def test_half_open_probe_success_recloses(self):
        r = _ScriptedRefederator([True, True, False, False],
                                 max_retries=0, breaker_threshold=2,
                                 breaker_cooldown=0)
        r.fire()
        r.fire()
        assert r.breaker_state == "open"
        assert r.fire()                          # cooldown 0 -> probe now
        assert r.breaker_state == "closed"
        assert r.completed == 1 and r.consecutive_failures == 0
        assert r.fire() and r.completed == 2     # normal service resumed

    def test_success_resets_consecutive_failures(self):
        r = _ScriptedRefederator([True, False, True], max_retries=0,
                                 breaker_threshold=2)
        r.fire()
        assert r.consecutive_failures == 1
        r.fire()
        assert r.consecutive_failures == 0 and r.last_outcome == "ok"
        r.fire()
        assert r.consecutive_failures == 1       # not 2: no breaker
        assert r.breaker_state == "closed"

    def test_injected_refederate_fault_counts_like_any_failure(self):
        inj = FaultInjector(FaultSpec(refederate_p=1.0))
        r = Refederator(_slot(), lambda k: None,
                        ckpt_dir="/nonexistent/unused", background=False,
                        max_retries=0, breaker_threshold=1, injector=inj,
                        sleep=lambda s: None, device="cpu")
        r.fire()
        assert isinstance(r.last_error, InjectedFault)
        assert r.breaker_state == "open"

    def test_validates_its_knobs(self):
        for kw, match in ((dict(max_retries=-1), "max_retries"),
                          (dict(breaker_threshold=0), "breaker_threshold"),
                          (dict(breaker_cooldown=-1), "breaker_cooldown")):
            with pytest.raises(ValueError, match=match):
                Refederator(_slot(), lambda k: None, ckpt_dir="unused",
                            **kw)

    def test_join_timeout_keeps_thread_and_busy(self):
        release = threading.Event()

        class _Blocking(_ScriptedRefederator):
            def _attempt(self, k):
                release.wait(10)

        r = _Blocking([], background=True)
        assert r.fire()
        assert r.join(timeout=0.05) is False     # still running
        assert r.busy                            # not lied about
        assert not r.fire() and r.skipped == 1   # coalesced, not doubled
        release.set()
        assert r.join(timeout=5) is True
        assert not r.busy
        assert r.completed == 1


# ---------------------------------------------------------------------
# health snapshot
# ---------------------------------------------------------------------
class TestHealth:
    def test_ok_engine_snapshot(self):
        eng = ServeEngine(_slot(model=CFG.name), CFG, max_batch=8,
                          queue_limit=16)
        eng.submit_many(_flows(0, 4))
        eng.drain()
        h = health_snapshot(eng)
        assert h.status == "ok" and h.healthy
        assert h.served == 4 and h.shed == 0 and h.dropped == 0
        assert h.queue_limit == 16 and h.model_version == 0
        json.dumps(h.to_dict())                  # JSON-ready, by contract

    def test_shed_marks_degraded_status(self):
        eng = ServeEngine(_slot(), CFG, max_batch=8, queue_limit=2)
        eng.submit_many(_flows(0, 5), best_effort=True)
        eng.drain()
        h = health_snapshot(eng)
        assert h.status == "degraded" and h.shed == 3

    def test_open_breaker_is_critical(self):
        r = _ScriptedRefederator([True] * 3, max_retries=0,
                                 breaker_threshold=1)
        r.fire()
        h = health_snapshot(refederator=r)
        assert h.status == "critical"
        assert h.breaker_state == "open"
        assert h.last_refederation == "failed"
        assert h.consecutive_failures == 1
        assert h.last_error and "scripted failure" in h.last_error

    def test_snapshot_composes_all_sources(self):
        x = _flows(0, 256)
        mon = DriftMonitor.from_sample(x, np.abs(x[:, 0]), threshold=0.5,
                                       patience=1, device="cpu")
        eng = ServeEngine(_slot(model=CFG.name), CFG, max_batch=8,
                          monitor=mon)
        r = _ScriptedRefederator([False])
        r.fire()
        h = health_snapshot(eng, refederator=r)
        assert h.last_refederation == "ok"
        assert h.refederations_completed == 1
        assert h.drift_triggered is False
        assert h.status == "ok"

    def test_model_age_reads_the_port_sidecar(self, tmp_path):
        """A version published from a port checkpoint has an age, read
        from the port's sidecar (``written_at``)."""
        spec = T.ExperimentSpec(
            model=CFG, data=T.DataSpec(n_samples=512, eval_samples=128),
            world=T.WorldSpec(num_clients=3, profile="uniform"),
            strategy="fedavg", strategy_kwargs=dict(batch_size=32),
            rounds=1)
        s = T.ExperimentSession.open(spec, device="cpu")
        s.run()
        path = str(tmp_path / "run.ckpt")
        s.checkpoint(path)
        slot = _slot(model=CFG.name)
        slot.publish_checkpoint(path)
        slot.acquire()
        h = health_snapshot(slot=slot, now=lambda: 1e12)
        assert h.model_source == path and h.model_age_seconds > 0

    def test_status_constants_exported(self):
        assert health_mod.STATUS_OK == "ok"
        assert health_mod.STATUS_DEGRADED == "degraded"
        assert health_mod.STATUS_CRITICAL == "critical"
