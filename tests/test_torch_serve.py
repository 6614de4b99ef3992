"""The port's serving layer (repro_torch/serve): batch bucketing, hot-swap
atomicity, drift monitoring, sidecar validation and the re-federation
loop, case by case after the JAX package's ``tests/test_serve.py``, on the
CPU; then the port against the JAX package on the same weights
(``params_from_jax``) and the same flows: probabilities, request ids,
versions and shed, expired and error counts by ``api/parity.py``'s
serving rules, every window's drift statistic within its
``drift_stat_bound`` and the trigger windows equal (no statistic within
its bound of the threshold), the continuous loop's structure, and a JAX
session checkpoint refused by ``publish_checkpoint`` before unpickling."""
import json
import os
import pickle
import threading

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.api as J
from repro import serve as jserve
from repro.configs import anomaly_mlp as janomaly
from repro.faults import FaultInjector as JFaultInjector
from repro.faults import FaultSpec as JFaultSpec
from repro.models import api as jmodel_api
from repro.models import mlp_detector as jmlp

import repro_torch as T
from repro_torch import serve
from repro_torch.api import parity
from repro_torch.api import session as session_mod
from repro_torch.configs import anomaly_mlp, registry
from repro_torch.core import scenario as scenario_mod
from repro_torch.data import synthetic
from repro_torch.faults import FaultInjector, FaultSpec
from repro_torch.launch import serve as launch_serve
from repro_torch.models import api as model_api
from repro_torch.models import mlp_detector
from repro_torch.serve import (DriftMonitor, ModelSlot, Refederator,
                               ServeEngine, ServeModelError,
                               StaleCheckpointError)

CFG = anomaly_mlp.SMOKE
JCFG = janomaly.SMOKE


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


def _slot(seed=0, **kw):
    return ModelSlot(_params(seed), device="cpu", **kw)


def _flows(seed, n):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, CFG.num_features)).astype(np.float32)


def _scores(params, x):
    with torch.no_grad():
        return 1.0 - mlp_detector.predict(
            params, torch.as_tensor(x), CFG)[:, 0].numpy()


def _monitor(x, scores, **kw):
    return DriftMonitor.from_sample(x, scores, device="cpu", **kw)


# ---------------------------------------------------------------------
# engine: bucketing + padding + accounting
# ---------------------------------------------------------------------
class TestBuckets:
    def test_bucket_for_rounds_up_to_power_of_two(self):
        eng = ServeEngine(_slot(), CFG, max_batch=64)
        assert [eng.bucket_for(n) for n in (1, 2, 3, 5, 8, 9, 33, 64)] \
            == [1, 2, 4, 8, 8, 16, 64, 64]
        with pytest.raises(ValueError):
            eng.bucket_for(0)
        with pytest.raises(ValueError):
            eng.bucket_for(65)

    def test_max_batch_must_be_power_of_two(self):
        with pytest.raises(ValueError, match="power of two"):
            ServeEngine(_slot(), CFG, max_batch=48)

    def test_padded_tail_matches_unpadded_scores(self):
        """A 5-request batch runs in the 8-bucket; the pad rows must not
        leak into responses and the real rows must score as a tight
        batch would."""
        params = _params()
        eng = ServeEngine(ModelSlot(params, device="cpu"), CFG, max_batch=8)
        X = _flows(3, 5)
        eng.submit_many(X)
        out = eng.pump()
        assert [r.request_id for r in out] == [0, 1, 2, 3, 4]
        with torch.no_grad():
            direct = mlp_detector.predict(params, torch.from_numpy(X),
                                          CFG).numpy()
        got = np.stack([r.probs for r in out])
        assert got.dtype == np.float32 and got.shape == (5, CFG.num_classes)
        np.testing.assert_allclose(got, direct, rtol=parity.PROBS_RTOL,
                                   atol=parity.PROBS_ATOL)
        for r in out:
            assert isinstance(r.score, float)
            np.testing.assert_allclose(r.score, 1.0 - r.probs[0], rtol=1e-6)

    def test_stream_splits_into_buckets_and_counts(self):
        eng = ServeEngine(_slot(), CFG, max_batch=32)
        eng.submit_many(_flows(0, 70))          # 32 + 32 + 6-in-8
        out = eng.drain()
        assert len(out) == 70
        stats = eng.shutdown()
        assert stats.submitted == stats.served == 70
        assert stats.dropped == 0 and stats.errors == 0
        assert set(stats.by_bucket) == {32, 8}
        assert stats.by_bucket[32]["rows"] == 64
        assert stats.by_bucket[8]["rows"] == 6
        assert stats.p99_ms >= stats.p50_ms >= 0.0

    def test_reset_stats_preserves_versions_and_ids(self):
        eng = ServeEngine(_slot(), CFG, max_batch=16)
        eng.submit_many(_flows(9, 10))
        with pytest.raises(RuntimeError, match="drain first"):
            eng.reset_stats()
        eng.drain()
        eng.reset_stats()
        assert eng.stats().submitted == 0
        rid = eng.submit(_flows(9, 1)[0])
        assert rid == 10                     # id sequence not reset
        eng.drain()
        assert eng.stats().served == 1
        assert eng.versions_served == [0]    # version history kept

    def test_submit_validates_shape(self):
        eng = ServeEngine(_slot(), CFG)
        with pytest.raises(ValueError, match="shape"):
            eng.submit(np.zeros(CFG.num_features + 1, np.float32))

    def test_shutdown_drains_then_refuses(self):
        eng = ServeEngine(_slot(), CFG, max_batch=16)
        eng.submit_many(_flows(1, 21))
        stats = eng.shutdown()
        assert stats.served == 21 and stats.pending == 0
        assert stats.dropped == 0
        with pytest.raises(RuntimeError, match="shut down"):
            eng.submit(np.zeros(CFG.num_features, np.float32))

    def test_monitor_must_share_the_slot_device(self):
        x = _flows(0, 64)

        class _Elsewhere:
            device = torch.device("meta")
        with pytest.raises(ValueError, match="share a device"):
            ServeEngine(_slot(), CFG, monitor=_Elsewhere())
        # the same device is accepted
        ServeEngine(_slot(), CFG, monitor=_monitor(x, np.abs(x[:, 0])))


# ---------------------------------------------------------------------
# swap: double-buffered slot semantics
# ---------------------------------------------------------------------
class TestModelSlot:
    def test_flip_happens_at_acquire_and_is_versioned(self):
        slot = _slot(0, model="m", round_idx=2)
        _p0, m0 = slot.acquire()
        assert m0.version == 0 and m0.round_idx == 2
        slot.publish(_params(1), round_idx=5)
        assert slot.version == 0              # not flipped yet
        assert slot.staged_version == 1
        _p1, m1 = slot.acquire()
        assert m1.version == 1 and m1.round_idx == 5
        assert slot.swaps == 1 and slot.staged_version is None

    def test_republish_before_flip_last_writer_wins(self):
        slot = _slot()
        slot.publish(_params(1))
        meta2 = slot.publish(_params(2))
        assert meta2.version == 2
        p, m = slot.acquire()
        assert m.version == 2 and slot.swaps == 1   # one flip, newest wins
        assert torch.equal(p["w0"], _params(2)["w0"])

    def test_swap_atomicity_under_churn(self):
        """Background publishes racing a scoring loop: every batch sees a
        single consistent version, versions are monotone, and no request
        is dropped."""
        eng = ServeEngine(_slot(), CFG, max_batch=16)
        stop = threading.Event()
        pool = [_params(k) for k in range(1, 4)]

        def publisher():
            k = 0
            while not stop.is_set():
                eng.slot.publish(pool[k % len(pool)])
                k += 1

        t = threading.Thread(target=publisher, daemon=True)
        t.start()
        seen = []
        try:
            for chunk in range(30):
                eng.submit_many(_flows(chunk, 13))
                batch = eng.drain()
                for r in batch:
                    seen.append((r.request_id, r.model_version))
        finally:
            stop.set()
            t.join(5)
        assert not t.is_alive()
        stats = eng.shutdown()
        assert stats.served == stats.submitted == 30 * 13
        assert stats.dropped == 0 and stats.errors == 0
        versions = [v for _rid, v in sorted(seen)]
        assert versions == sorted(versions), "versions must be monotone"
        assert len(eng.versions_served) >= 2, "churn never flipped a model"

    def test_slot_copies_what_it_holds(self):
        """The slot holds a copy: mutating the source in place after
        ModelSlot() or publish() leaves the served scores unmoved. Numpy
        parameters are accepted and f64 leaves become f32."""
        src = _params(0)
        slot = ModelSlot(src, device="cpu")
        eng = ServeEngine(slot, CFG, max_batch=8)
        X = _flows(5, 8)

        def scores():
            eng.submit_many(X)
            return np.array([r.score for r in eng.drain()])

        before = scores()
        for v in src.values():
            v.add_(1.0)
        np.testing.assert_array_equal(scores(), before)
        new = _params(1)
        slot.publish(new)
        after_publish = scores()
        for v in new.values():
            v.mul_(-3.0)
        np.testing.assert_array_equal(scores(), after_publish)
        slot.publish({k: v.numpy().astype(np.float64)
                      for k, v in _params(1).items()})
        p, _m = slot.acquire()
        assert all(t.dtype == torch.float32 for t in p.values())
        np.testing.assert_array_equal(scores(), after_publish)

    def test_megastep_arena_views_publish_as_copies(self):
        """A megastep simulation's parameters are views into its arena,
        which the next round updates in place: published, they must not
        follow it."""
        spec = T.ExperimentSpec(**SMALL_T)
        sim = T.build_simulation(spec, device="cpu")
        sim.run(1)
        slot = ModelSlot(sim.params, device="cpu")
        eng = ServeEngine(slot, CFG, max_batch=16)
        X = _flows(6, 16)
        eng.submit_many(X)
        before = np.stack([r.probs for r in eng.drain()])
        w0 = sim.params["w0"].clone()
        sim.run(1)
        assert not torch.equal(sim.params["w0"], w0), "the arena moved"
        eng.submit_many(X)
        np.testing.assert_array_equal(
            np.stack([r.probs for r in eng.drain()]), before)


# ---------------------------------------------------------------------
# scenario drift-stat helpers + monitor policy
# ---------------------------------------------------------------------
class TestDriftStats:
    def test_reference_snapshot_is_exact_moments(self):
        x = _flows(0, 512)
        s = np.abs(x[:, 0])
        ref = scenario_mod.reference_snapshot(torch.from_numpy(x),
                                              torch.from_numpy(s))
        np.testing.assert_allclose(ref.feat_mean.numpy(), x.mean(0),
                                   atol=1e-5)
        np.testing.assert_allclose(ref.feat_var.numpy(), x.var(0),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(ref.score_mean), s.mean(),
                                   atol=1e-5)

    def test_update_is_masked_and_chunking_snaps_first_batch(self):
        x = _flows(1, 64)
        s = x[:, 0]
        stats = scenario_mod.init_drift_stats(CFG.num_features)
        # pad rows carry garbage; the mask must exclude them
        xpad = np.concatenate([x, 1e6 * np.ones_like(x[:32])])
        spad = np.concatenate([s, 1e6 * np.ones_like(s[:32])])
        mask = np.concatenate([np.ones(64), np.zeros(32)]).astype(
            np.float32)
        upd = scenario_mod.drift_stats_update(
            stats, torch.from_numpy(xpad), torch.from_numpy(spad),
            mask=torch.from_numpy(mask))
        np.testing.assert_allclose(upd.feat_mean.numpy(), x.mean(0),
                                   atol=1e-4)
        assert float(upd.count) == 64.0

    def test_statistic_zero_on_reference_and_grows_with_shift(self):
        x = _flows(2, 1024)
        s = np.abs(x[:, 1])
        ref = scenario_mod.reference_snapshot(torch.from_numpy(x),
                                              torch.from_numpy(s))
        same = scenario_mod.drift_stats_update(
            scenario_mod.init_drift_stats(CFG.num_features),
            torch.from_numpy(x), torch.from_numpy(s))
        base = float(scenario_mod.drift_statistic(same, ref))
        assert base < 0.05
        shifted = scenario_mod.drift_stats_update(
            scenario_mod.init_drift_stats(CFG.num_features),
            torch.from_numpy(x + 2.0), torch.from_numpy(s))
        far = float(scenario_mod.drift_statistic(shifted, ref))
        assert far > 1.0 > base


class TestDriftMonitor:
    def _monitor(self, **kw):
        x = _flows(0, 512)
        return _monitor(x, np.abs(x[:, 0]), threshold=0.5, **kw)

    def _window(self, mon, x):
        st, stat = mon.step(mon.state, mon.reference, torch.from_numpy(x),
                            torch.from_numpy(np.abs(x[:, 0])))
        assert stat.dim() == 0 and stat.device == mon.device
        return mon.observe(st, stat)

    def test_triggers_after_exactly_patience_windows(self):
        mon = self._monitor(patience=3)
        fired = [self._window(mon, _flows(10 + w, 128) + 3.0)
                 for w in range(5)]
        assert fired == [False, False, True, False, False]
        assert mon.triggered and mon.trigger_count == 1

    def test_clean_windows_reset_the_patience_counter(self):
        mon = self._monitor(patience=2)
        for w, shift in enumerate([3.0, 0.0, 3.0, 0.0, 3.0]):
            assert not self._window(mon, _flows(20 + w, 256) + shift)
        assert not mon.triggered

    def test_rearm_adopt_current_clears_and_renormalizes(self):
        mon = self._monitor(patience=1)
        assert self._window(mon, _flows(30, 512) + 3.0)
        mon.rearm(adopt_current=True)
        assert not mon.triggered
        assert float(mon.state.count) == 0.0
        # the shifted distribution is now the reference -> quiet again
        x2 = _flows(31, 512) + 3.0
        st2, stat2 = mon.step(mon.state, mon.reference,
                              torch.from_numpy(x2),
                              torch.from_numpy(np.abs(x2[:, 0])))
        assert float(stat2) < 0.2
        assert not mon.observe(st2, stat2)

    def test_rearm_validates_its_arguments(self):
        mon = self._monitor(patience=1)
        with pytest.raises(ValueError, match="at least one"):
            mon.rearm(adopt_current=True)
        with pytest.raises(ValueError, match="not both"):
            mon.rearm(reference=mon.reference, adopt_current=True)
        with pytest.raises(ValueError, match="patience"):
            self._monitor(patience=0)

    def test_rearm_is_visible_to_later_batches(self):
        """A rearm after some batches of a bucket changes the statistic
        of the next batch of the same bucket (the reference is an
        argument of the step)."""
        params = _params()
        x = _flows(40, 256)
        mon = _monitor(x, _scores(params, x), threshold=0.5, patience=1)
        eng = ServeEngine(ModelSlot(params, device="cpu"), CFG,
                          max_batch=32, monitor=mon)
        eng.submit_many(_flows(41, 32) + 3.0)
        eng.drain()
        hot = mon.statistic
        assert hot > 0.5
        mon.rearm(adopt_current=True)           # shifted = new normal
        eng.submit_many(_flows(42, 32) + 3.0)   # same bucket
        eng.drain()
        assert mon.statistic < 0.5 < hot

    def test_engine_on_trigger_fires_once_per_arming(self):
        x = _flows(50, 256)
        mon = _monitor(x, np.abs(x[:, 0]), threshold=0.5, patience=2)
        eng = ServeEngine(_slot(), CFG, max_batch=64, monitor=mon,
                          score_fn=lambda p, xb: torch.stack(
                              [1.0 - torch.abs(xb[:, 0]),
                               torch.abs(xb[:, 0])], dim=1))
        hits = []
        eng.on_trigger = lambda: hits.append(mon.statistic)
        for w in range(5):
            eng.submit_many(_flows(60 + w, 64) + 4.0)
            eng.drain()
        assert len(hits) == 1 and mon.trigger_count == 1


# ---------------------------------------------------------------------
# checkpoint sidecar + publish_checkpoint validation
# ---------------------------------------------------------------------
SMALL_T = dict(model=CFG,
               data=T.DataSpec(n_samples=512, eval_samples=128),
               world=T.WorldSpec(num_clients=3, profile="uniform"),
               strategy="ours",
               strategy_kwargs=dict(batch_size=32, lr=3e-2, local_epochs=1),
               rounds=2, seed=0)


@pytest.fixture(scope="module")
def trained_ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("serve_ckpt") / "run.ckpt")
    session = T.ExperimentSession.open(T.ExperimentSpec(**SMALL_T),
                                       device="cpu")
    with torch.no_grad():
        session.run()
    session.checkpoint(path)
    return path, {k: v.clone() for k, v in session.result().params.items()}


class TestCheckpointSidecar:
    def test_checkpoint_writes_sidecar(self, trained_ckpt):
        path, _ = trained_ckpt
        meta = session_mod.read_sidecar(path)
        assert meta["model"] == CFG.name
        assert meta["rounds_done"] == 2
        assert meta["fingerprint"]
        assert meta["package"] == "repro_torch"
        assert os.path.exists(session_mod.sidecar_path(path))

    def test_read_sidecar_missing_is_pointed(self, tmp_path):
        with pytest.raises(FileNotFoundError, match="sidecar"):
            session_mod.read_sidecar(str(tmp_path / "nope.ckpt"))

    def test_publish_checkpoint_flips_in(self, trained_ckpt):
        path, params = trained_ckpt
        slot = ModelSlot(_params(), model=CFG.name, round_idx=0,
                         device="cpu")
        meta = slot.publish_checkpoint(path)
        assert meta.version == 1 and meta.round_idx == 2
        assert meta.source == path
        got, m = slot.acquire()
        assert m.version == 1
        for k in params:
            assert torch.equal(got[k], params[k])
            assert got[k].device == slot.device

    def test_rejects_model_mismatch(self, trained_ckpt):
        path, _ = trained_ckpt
        slot = ModelSlot(_params(), model="other-arch", device="cpu")
        with pytest.raises(ServeModelError, match="different architecture"):
            slot.publish_checkpoint(path)

    def test_rejects_stale_round_counter(self, trained_ckpt):
        path, _ = trained_ckpt
        slot = ModelSlot(_params(), model=CFG.name, round_idx=10,
                         device="cpu")
        with pytest.raises(StaleCheckpointError, match="round"):
            slot.publish_checkpoint(path)
        # explicit rollback and round_base offsets both unblock it
        assert slot.publish_checkpoint(path, allow_stale=True).version >= 1
        slot2 = ModelSlot(_params(), model=CFG.name, round_idx=10,
                          device="cpu")
        meta = slot2.publish_checkpoint(path, round_base=10)
        assert meta.round_idx == 12

    def test_fallback_publishes_the_newest_good_checkpoint(
            self, trained_ckpt, tmp_path):
        path, params = trained_ckpt
        good = str(tmp_path / "good.ckpt")
        for suffix in ("", ".meta.json"):
            with open(path + suffix, "rb") as f, \
                    open(good + suffix, "wb") as g:
                g.write(f.read())
        bad = str(tmp_path / "bad.ckpt")
        with open(bad, "wb") as f:
            f.write(b"garbage")                 # no sidecar
        slot = ModelSlot(_params(), model=CFG.name, device="cpu")
        with pytest.raises(FileNotFoundError):
            slot.publish_checkpoint(bad)
        meta = slot.publish_checkpoint(bad, fallback=True)
        assert meta.source == good
        got, _m = slot.acquire()
        assert torch.equal(got["w0"], params["w0"])

    def test_refuses_a_jax_checkpoint_before_unpickling(self, tmp_path,
                                                        monkeypatch):
        """A JAX session checkpoint's sidecar has no port mark: refused
        before the restore, and pickle never sees its bytes."""
        path = str(tmp_path / "jax.ckpt")
        spec = J.ExperimentSpec(**{**SMALL_T, "model": JCFG,
                                   "data": J.DataSpec(n_samples=512,
                                                      eval_samples=128),
                                   "world": J.WorldSpec(num_clients=3,
                                                        profile="uniform"),
                                   "rounds": 1})
        s = J.ExperimentSession.open(spec)
        s.run()
        s.checkpoint(path)
        meta = json.load(open(session_mod.sidecar_path(path)))
        assert meta.get("package") != "repro_torch"

        def no_unpickling(*a, **k):
            raise AssertionError("unpickled a foreign checkpoint")

        def no_restore(*a, **k):
            raise AssertionError("paid for the restore of a foreign "
                                 "checkpoint")
        monkeypatch.setattr(pickle, "loads", no_unpickling)
        monkeypatch.setattr(pickle, "load", no_unpickling)
        monkeypatch.setattr(T.ExperimentSession, "restore", no_restore)
        slot = ModelSlot(_params(), model=CFG.name, device="cpu")
        with pytest.raises(ValueError, match="not a repro_torch"):
            slot.publish_checkpoint(path)
        assert slot.staged_version is None


# ---------------------------------------------------------------------
# the full loop, in process (miniature)
# ---------------------------------------------------------------------
def _traffic(seed, n, shift):
    X, y = synthetic.make_unsw_like(seed, n, CFG.num_features,
                                    CFG.num_classes)
    return X + shift, y


def _loop_spec(mod, shift, seed):
    model = CFG if mod is T else JCFG
    return mod.ExperimentSpec(
        model=model, data=mod.DataSpec(
            n_samples=512, eval_samples=128,
            factory=lambda s, n: _traffic(s, n, shift)),
        world=mod.WorldSpec(num_clients=3, profile="uniform"),
        strategy="ours",
        strategy_kwargs=dict(batch_size=32, lr=3e-2, local_epochs=1),
        rounds=2, seed=seed)


def _run_loop(tmp_path, params=None):
    """The miniature continuous loop on the port (the JAX package's
    ``TestContinuousLoop``): drifted traffic triggers an inline
    re-federation, which publishes; returns what the structure check
    reads."""
    session = T.ExperimentSession.open(_loop_spec(T, 0.0, 0), device="cpu",
                                       params=params)
    session.run()
    params = session.result().params
    slot = ModelSlot(params, model=CFG.name, round_idx=2, device="cpu")
    Xr, _ = _traffic(7, 512, 0.0)
    mon = _monitor(Xr, _scores(params, Xr), threshold=0.5, patience=2)
    refed = Refederator(slot, lambda k: _loop_spec(T, 2.0, 100 + k),
                        ckpt_dir=str(tmp_path), monitor=mon,
                        background=False, device="cpu")
    eng = ServeEngine(slot, CFG, max_batch=64, monitor=mon)
    eng.on_trigger = refed.fire
    for w in range(6):                           # drifted traffic
        X, _y = _traffic(200 + w, 64, 2.0)
        eng.submit_many(X)
        eng.drain()
        if refed.completed:
            break
    if refed.last_error is not None:
        raise refed.last_error
    eng.on_trigger = None
    X, _y = _traffic(300, 64, 2.0)               # post-swap window
    eng.submit_many(X)
    post = {r.model_version for r in eng.drain()}
    stats = eng.shutdown()
    return dict(triggers=mon.trigger_count, completed=refed.completed,
                windows=w + 1, post_versions=post,
                rearmed=not mon.triggered, dropped=stats.dropped,
                errors=stats.errors, swaps=slot.swaps,
                checkpoint=refed.last_checkpoint,
                versions=eng.versions_served, round=slot.meta.round_idx)


class TestContinuousLoop:
    def test_trigger_refederates_and_recovers(self, tmp_path):
        got = _run_loop(tmp_path)
        assert got["triggers"] == 1 and got["completed"] == 1
        assert got["checkpoint"] and os.path.exists(
            session_mod.sidecar_path(got["checkpoint"]))
        assert got["post_versions"] == {1}
        assert got["rearmed"]                    # re-armed
        assert got["dropped"] == 0 and got["errors"] == 0
        assert got["swaps"] >= 1
        assert got["round"] == 4                 # 2 + the session's 2

    def test_loop_structure_matches_jax(self, tmp_path):
        """The same loop in both packages from the same initial weights:
        the trigger, the completed re-federation, the versions and the
        zero drops are the same (the re-federated weights are not: the
        JAX session draws them from a PRNG key)."""
        jparams = jmodel_api.init_params(jax.random.PRNGKey(0), JCFG)
        got = _run_loop(tmp_path / "port",
                        params=T.params_from_jax(jparams, "cpu"))

        session = J.ExperimentSession.open(_loop_spec(J, 0.0, 0))
        session.run()
        p = session.result().params
        slot = jserve.ModelSlot(p, model=JCFG.name, round_idx=2)
        Xr, _ = _traffic(7, 512, 0.0)
        sref = 1.0 - np.asarray(jmlp.predict(p, jnp.asarray(Xr),
                                             JCFG))[:, 0]
        mon = jserve.DriftMonitor.from_sample(Xr, sref, threshold=0.5,
                                              patience=2)
        refed = jserve.Refederator(
            slot, lambda k: _loop_spec(J, 2.0, 100 + k),
            ckpt_dir=str(tmp_path / "jax"), monitor=mon, background=False)
        eng = jserve.ServeEngine(slot, JCFG, max_batch=64, monitor=mon)
        eng.on_trigger = refed.fire
        for w in range(6):
            X, _y = _traffic(200 + w, 64, 2.0)
            eng.submit_many(X)
            eng.drain()
            if refed.completed:
                break
        eng.on_trigger = None
        X, _y = _traffic(300, 64, 2.0)
        eng.submit_many(X)
        post = {r.model_version for r in eng.drain()}
        stats = eng.shutdown()
        want = dict(triggers=mon.trigger_count, completed=refed.completed,
                    windows=w + 1, post_versions=post,
                    rearmed=not mon.triggered, dropped=stats.dropped,
                    errors=stats.errors, swaps=slot.swaps,
                    versions=eng.versions_served,
                    round=slot.meta.round_idx)
        got.pop("checkpoint")
        assert got == want


# ---------------------------------------------------------------------
# the port against the JAX package on the same weights and flows
# ---------------------------------------------------------------------
class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# windows of flows: sizes that hit buckets 64, 8, 1, 64 (a 100-row window
# is 64 + 36-in-64), some drifted; deadlines expire one window's head
WINDOWS = [(64, 0.0), (5, 0.0), (1, 0.0), (100, 1.5), (40, 1.5), (64, 1.5),
           (30, 0.0)]


def _drive(eng, mon, clock, x_all):
    """Feed WINDOWS through an engine of either package with the same
    clock: the responses, the statistic of every pump that fed the
    monitor, the rows it fed (the flows of its scored requests), and
    each accepted request's flow."""
    out, stats_per_pump, rows, flows = [], [], [], {}
    start = 0
    for w, (n, _shift) in enumerate(WINDOWS):
        X = x_all[start:start + n]
        start += n
        head = eng.submit_many(X[: n // 2],
                               deadline_ms=5.0 if w == 4 else None)
        clock.t += 0.01 if w == 4 else 0.0     # the head expires
        # a full queue sheds every later row of the window's tail
        tail = eng.submit_many(X[n // 2:], best_effort=True)
        flows.update(zip(head, X[: n // 2]))
        flows.update(zip(tail, X[n // 2:]))
        while eng.pending:
            before = len(mon.history)
            got = eng.pump()
            out.extend(got)
            if len(mon.history) > before:
                stats_per_pump.append(mon.history[-1])
                rows.append([flows[r.request_id] for r in got
                             if not r.expired])
        clock.t += 0.001
    return out, stats_per_pump, rows


def test_engine_and_monitor_match_jax_on_same_weights():
    """Same weights, flows, clock, queue limit, deadlines and an injected
    scorer fault: ids, versions, expired flags and counts equal; probs by
    ``parity.serve_mismatches``; every pump's drift statistic within its
    ``parity.drift_stat_bound`` and no statistic within its bound of the
    threshold, so the trigger windows are the same."""
    jp = jmodel_api.init_params(jax.random.PRNGKey(3), JCFG)
    tp = T.params_from_jax(jp, "cpu")
    rng = np.random.default_rng(11)
    parts = []
    for n, shift in WINDOWS:
        X, _y = synthetic.make_unsw_like(int(rng.integers(1 << 30)), n,
                                         CFG.num_features, CFG.num_classes)
        parts.append(X + shift)
    x_all = np.concatenate(parts).astype(np.float32)
    Xr, _ = synthetic.make_unsw_like(99, 512, CFG.num_features,
                                     CFG.num_classes)
    s_t = _scores(tp, Xr)
    s_j = 1.0 - np.asarray(jmlp.predict(jp, jnp.asarray(Xr), JCFG))[:, 0]
    np.testing.assert_allclose(s_t, s_j, atol=parity.PROBS_RTOL
                               + parity.PROBS_ATOL)
    kw = dict(threshold=0.3, patience=2)
    mon_t = _monitor(Xr, s_t, **kw)
    mon_j = jserve.DriftMonitor.from_sample(Xr, s_j, **kw)
    fired = {"port": [], "jax": []}
    runs = {}
    for name, slot, mon, inj in (
            ("port", ModelSlot(tp, device="cpu"), mon_t,
             FaultInjector(FaultSpec(at={"scorer": (2,)}))),
            ("jax", jserve.ModelSlot(jp), mon_j,
             JFaultInjector(JFaultSpec(at={"scorer": (2,)})))):
        clock = _Clock()
        Engine = ServeEngine if name == "port" else jserve.ServeEngine
        eng = Engine(slot, CFG if name == "port" else JCFG, max_batch=64,
                     monitor=mon, now=clock, queue_limit=70,
                     injector=inj)
        eng.on_trigger = (lambda nm=name, m=mon:
                          fired[nm].append(len(m.history) - 1))
        out, stats, rows = _drive(eng, mon, clock, x_all)
        st = eng.shutdown()
        runs[name] = (out, stats, rows, st)
    (out_t, stats_t, rows_t, st_t), (out_j, stats_j, rows_j, st_j) = \
        runs["port"], runs["jax"]
    assert parity.serve_mismatches(out_t, out_j) == []
    for f in ("submitted", "served", "shed", "deadline_miss", "errors",
              "dropped", "degraded_pumps"):
        assert getattr(st_t, f) == getattr(st_j, f), f
    assert st_t.shed > 0 and st_t.deadline_miss > 0 and st_t.errors == 1
    assert sorted(st_t.by_bucket) == sorted(st_j.by_bucket)
    assert [len(r) for r in rows_t] == [len(r) for r in rows_j]
    seen, bounds = [], []
    for w, pumped in enumerate(rows_t):
        seen.extend(pumped)
        bucket = 1 << (len(pumped) - 1).bit_length()
        bounds.append(parity.drift_stat_bound(
            np.stack(seen), Xr, s_j, bucket, w + 1, stats_j[w]))
    assert parity.drift_problems(stats_t, stats_j, bounds,
                                 kw["threshold"]) == []
    assert fired["port"] == fired["jax"] and fired["port"], fired
    assert max(bounds) < 1e-2


# ---------------------------------------------------------------------
# registry surface and the launcher
# ---------------------------------------------------------------------
def test_registry_list_archs_is_public_and_sorted():
    archs = registry.list_archs()
    assert archs == sorted(archs)
    assert "anomaly-mlp" in archs
    for a in archs:
        assert registry.get_config(a, smoke=True) is not None


def test_serve_names_cover_the_jax_package():
    assert set(jserve.__all__) <= set(serve.__all__)
    for name in serve.__all__:
        assert getattr(serve, name) is not None


@pytest.mark.parametrize("from_checkpoint", [False, True])
def test_launcher_serves_the_detector(trained_ckpt, from_checkpoint,
                                      capsys):
    argv = ["--arch", "anomaly-mlp", "--smoke", "--device", "cpu",
            "--batch", "32", "--requests", "96"]
    if from_checkpoint:
        argv += ["--from-checkpoint", trained_ckpt[0]]
    assert launch_serve.main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("scored 96 flows")
    assert ("model v1" in out[0]) == from_checkpoint
    assert out[1].startswith("health: ok")


def test_serve_anomaly_with_admission_control(capsys):
    stats = launch_serve.serve_anomaly(CFG, 32, requests=96, queue_limit=8,
                                       deadline_ms=60_000.0, device="cpu")
    assert stats.shed == 96 - stats.submitted > 0
    assert stats.served == stats.submitted and stats.dropped == 0
    assert "health: degraded" in capsys.readouterr().out


def test_mlp_family_has_no_prefill_and_names_the_server():
    with pytest.raises(NotImplementedError, match="repro_torch.serve"):
        model_api.prefill(_params(), {}, CFG)
