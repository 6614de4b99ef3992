"""The port's ExperimentSession (api/session.py): streaming, callbacks and
checkpoint/resume equal by bits on the loop, megastep, scanned and spmd
paths (with int8 error feedback, a scenario, a topology and a lazy world),
case by case after the JAX package's ``tests/test_session.py``; then the
port against the JAX package: the spec fingerprint's keys, a JAX session
checkpoint refused before unpickling, and a JAX mid-run state carried
across by ``convert.sim_state_from_jax`` / ``spmd_state_from_jax``, whose
next rounds agree with JAX's within ``api/parity.py``'s tolerances (every
θ decision held only where no ratio lies within ``THETA_BAND`` of θ)."""
import dataclasses
import json
import os
import pickle
import shutil

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax

import repro.api as J
from repro.api import runner as jrunner
from repro.api import session as jsession

import repro_torch as T
from repro_torch import faults
from repro_torch.api import parity
from repro_torch.api import runner as trunner
from repro_torch.api import session as session_mod
from repro_torch.checkpoint.io import CheckpointCorruptError

from test_torch_spmd import JaxSpmdDraws


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these cases run many tiny operations, and where
    several test workers share the machine, more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _small(mod):
    return dict(model="anomaly-mlp-smoke",
                data=mod.DataSpec(n_samples=1500, eval_samples=300),
                rounds=6, seed=0)


def _sim_spec(mod=T, **kw):
    """Selection, dropout, θ, dynamic batch and checkpointing: every piece
    of engine state a resume must restore."""
    base = dict(_small(mod),
                world=mod.WorldSpec(num_clients=5, profile="heterogeneous",
                                    dropout_p=0.25),
                strategy=mod.get_strategy("ours").build(batch_size=32,
                                                        select_fraction=0.8))
    return mod.ExperimentSpec(**{**base, **kw})


def _spmd_spec(mod=T, **kw):
    st = mod.StrategyConfig(mode="sync", theta=0.65, selection=True,
                            select_fraction=0.5, dynamic_batch=False,
                            checkpointing=False, batch_size=32, lr=3e-2,
                            max_samples_per_round=64,
                            quantize_updates=kw.pop("quantize", False))
    base = dict(_small(mod), engine="spmd", strategy=st,
                world=mod.WorldSpec(num_clients=4, profile="heterogeneous",
                                    dropout_p=0.2))
    return mod.ExperimentSpec(**{**base, **kw})


def _int8_spec(**kw):
    return T.ExperimentSpec(
        **{**_small(T), **kw},
        world=T.WorldSpec(num_clients=4, profile="uniform"),
        strategy=T.get_strategy("ours").build(batch_size=32,
                                              dynamic_batch=False,
                                              quantize_updates=True))


def _lazy_spec(**kw):
    return T.ExperimentSpec(
        model="anomaly-mlp-smoke",
        data=T.DataSpec(samples_per_client=96, eval_samples=64),
        world=T.WorldSpec(num_clients=40, profile="heterogeneous",
                          resident=False, dropout_p=0.1),
        strategy="ours", strategy_kwargs=dict(batch_size=32,
                                              select_fraction=0.1,
                                              quantize_updates=True),
        candidate_frac=0.5, candidate_shards=4, rounds=6, seed=0, **kw)


def _open(spec):
    return T.ExperimentSession.open(spec, device="cpu")


def _restore(path, spec=None, **kw):
    return T.ExperimentSession.restore(path, spec, device="cpu", **kw)


def _assert_records_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        # equal, NaN included (the scanned path's rounds before an eval)
        np.testing.assert_equal(dataclasses.astuple(x),
                                dataclasses.astuple(y))


def _assert_params_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _tensors(tree) -> list:
    return [t for t in jax.tree.leaves(tree, is_leaf=torch.is_tensor)
            if torch.is_tensor(t)]


def _topology(engine):
    return (engine.state.topology if isinstance(engine, T.SpmdDriver)
            else engine._topo_state)


def _resume_case(spec, k, tmp_path, total=None):
    total = total or spec.rounds
    full = _open(spec)
    full.run(total)
    part = _open(spec)
    part.run(k)
    path = str(tmp_path / "session.ckpt")
    part.checkpoint(path)
    resumed = _restore(path)
    assert resumed.rounds_done == k
    resumed.run(total - k)
    _assert_records_equal(full.records, resumed.records)
    _assert_params_equal(full.result().params, resumed.result().params)
    return full, resumed


# ---------------------------------------------------------------------------
# resume equal by bits: path x world
# ---------------------------------------------------------------------------

RESUME_CASES = {
    "megastep": (lambda: _sim_spec(), 3),
    "loop": (lambda: _sim_spec(megastep=False), 3),
    "scanned-r4": (lambda: _sim_spec(rounds_per_dispatch=4, rounds=8), 4),
    "int8-megastep": (lambda: _int8_spec(), 3),
    "int8-loop": (lambda: _int8_spec(megastep=False), 3),
    "spmd": (lambda: _spmd_spec(), 3),
    "spmd-int8": (lambda: _spmd_spec(quantize=True), 3),
    "scenario-megastep": (lambda: _sim_spec(scenario="dynamic"), 3),
    "scenario-loop": (lambda: _sim_spec(scenario="dynamic",
                                        megastep=False), 3),
    "scenario-scanned-r4": (lambda: _sim_spec(
        scenario="dynamic", rounds_per_dispatch=4, rounds=8), 4),
    "scenario-spmd": (lambda: _spmd_spec(scenario="dynamic"), 3),
    "topology-megastep": (lambda: _sim_spec(topology="two-tier-pods"), 3),
    "topology-scanned-r4": (lambda: _sim_spec(
        topology="two-tier-pods", rounds_per_dispatch=4, rounds=8), 4),
    "topology-spmd": (lambda: _spmd_spec(topology="two-tier-pods"), 3),
    "lazy-megastep": (lambda: _lazy_spec(), 3),
    "lazy-loop": (lambda: _lazy_spec(megastep=False), 3),
}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resume_is_equal_by_bits(case, tmp_path):
    make, k = RESUME_CASES[case]
    spec = make()
    full, resumed = _resume_case(spec, k, tmp_path)
    eng_full, eng_res = full.engine, resumed.engine
    assert eng_res.theta_ratios == eng_full.theta_ratios
    if spec.topology is not None:
        for x, y in zip(_tensors(_topology(eng_full)),
                        _tensors(_topology(eng_res))):
            assert torch.equal(x, y)
    if spec.engine == "sim":
        assert eng_res.cohorts == eng_full.cohorts
        assert eng_res.failure_log == eng_full.failure_log
        np.testing.assert_array_equal(eng_res.client_pass_rates(),
                                      eng_full.client_pass_rates())
    if case.startswith("lazy"):
        assert eng_res.loaders.resident <= eng_res.loaders.capacity


def test_resume_scanned_midchunk_trajectory(tmp_path):
    """A checkpoint inside a dispatch (k not a multiple of R): every field
    the dispatch computes and the final parameters are equal by bits (a
    round's draws are seeded by its absolute index); only the accuracy
    samples may move, since the host eval runs once a dispatch. With fused
    eval at eval_every 1 the accuracy is equal too."""
    spec = _sim_spec(rounds_per_dispatch=4, rounds=8)
    full = _open(spec)
    full.run(8)
    part = _open(spec)
    part.run(3)
    path = str(tmp_path / "mid.ckpt")
    part.checkpoint(path)
    resumed = _restore(path)
    resumed.run(5)
    for a, b in zip(full.records, resumed.records):
        for f in ("round", "sim_time", "comm_time", "idle_time",
                  "bytes_sent", "updates_applied", "accept_rate", "loss"):
            assert getattr(a, f) == getattr(b, f), f
    _assert_params_equal(full.result().params, resumed.result().params)
    fused = dataclasses.replace(spec, fused_eval=True)
    _resume_case(fused, 2, tmp_path)


def test_eval_every_adds_one_sample_at_a_run_boundary(tmp_path):
    """The JAX package's rule: each ``run()`` evaluates its final round, so
    a checkpoint boundary adds one accuracy sample there; ``stream()``
    adds none and equals one ``run(n)``."""
    spec = _sim_spec(eval_every=4)
    full = _open(spec)
    full.run(6)
    streamed = _open(spec)
    assert [r.accuracy for r in streamed.stream(6)] == \
        [r.accuracy for r in full.records]
    part = _open(spec)
    part.run(3)
    part.checkpoint(str(tmp_path / "e.ckpt"))
    resumed = _restore(str(tmp_path / "e.ckpt"))
    resumed.run(3)
    differ = [a.round for a, b in zip(full.records, resumed.records)
              if a.accuracy != b.accuracy]
    assert differ == [2, 3]        # sampled at round 2, carried to round 3
    for a, b in zip(full.records, resumed.records):
        assert dataclasses.replace(a, accuracy=0) == \
            dataclasses.replace(b, accuracy=0)


# ---------------------------------------------------------------------------
# restore validation
# ---------------------------------------------------------------------------

def test_restore_mismatched_spec_raises(tmp_path):
    spec = _sim_spec(rounds=2)
    s = _open(spec)
    s.run(2)
    path = str(tmp_path / "m.ckpt")
    s.checkpoint(path)
    with pytest.raises(T.CheckpointMismatchError, match="seed") as ei:
        _restore(path, dataclasses.replace(spec, seed=7))
    assert set(ei.value.mismatches) == {"seed"}
    with pytest.raises(T.CheckpointMismatchError, match="engine"):
        _restore(path, _spmd_spec(rounds=2, seed=0))
    with pytest.raises(T.CheckpointMismatchError, match="topology"):
        _restore(path, dataclasses.replace(spec, topology="two-tier-pods"))
    # a different round budget is not a mismatch (sessions extend runs)
    resumed = _restore(path, dataclasses.replace(spec, rounds=5))
    resumed.run(3)
    assert resumed.rounds_done == 5


def test_restore_scenario_mismatch_raises(tmp_path):
    spec = _sim_spec(scenario="dynamic", rounds=2)
    s = _open(spec)
    s.run(2)
    path = str(tmp_path / "scn.ckpt")
    s.checkpoint(path)
    for other in ("drift", None):
        with pytest.raises(T.CheckpointMismatchError, match="scenario"):
            _restore(path, dataclasses.replace(spec, scenario=other))


def test_checkpoint_is_atomic_and_restorable_without_spec(tmp_path):
    s = _open(_sim_spec(rounds=2))
    s.run(1)
    path = str(tmp_path / "a.ckpt")
    s.checkpoint(path)
    assert os.path.exists(path) and not os.path.exists(path + ".tmp")
    meta = session_mod.read_sidecar(path)
    assert meta["package"] == "repro_torch" and meta["rounds_done"] == 1
    # a plain spec is embedded: restore() needs no spec argument
    assert _restore(path).rounds_done == 1


def test_restore_without_an_embedded_spec(tmp_path):
    """A spec holding a lambda cannot be pickled: the checkpoint embeds
    none, restore() asks for it, and with it continues equal by bits."""
    spec = _sim_spec(rounds=4, eval_fn=lambda p, b: 0.5)
    full = _open(spec)
    full.run(4)
    s = _open(spec)
    s.run(2)
    path = str(tmp_path / "nospec.ckpt")
    s.checkpoint(path)
    with pytest.raises(ValueError, match="does not embed its spec"):
        _restore(path)
    resumed = _restore(path, spec)
    resumed.run(2)
    _assert_records_equal(full.records, resumed.records)


def test_payload_holds_only_cpu_tensors(tmp_path):
    """Every tensor of a checkpoint's payload is a CPU copy (a CUDA
    tensor would tie the pickle to CUDA at load time), and none aliases
    the live engine state."""
    for spec in (_int8_spec(), _int8_spec(megastep=False),
                 _sim_spec(rounds_per_dispatch=2, rounds=2),
                 _spmd_spec(quantize=True)):
        s = _open(spec)
        s.run(2)
        tensors = _tensors(s._driver.state_dict())
        assert tensors and all(t.device.type == "cpu" for t in tensors)
        live = _tensors(s.engine.state if spec.engine == "spmd"
                        else vars(s.engine))
        assert not {t.data_ptr() for t in live if t.numel()} & {
            t.data_ptr() for t in tensors if t.numel()}


# ---------------------------------------------------------------------------
# corruption, verified fallback and injected faults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [_sim_spec, _spmd_spec],
                         ids=["sim", "spmd"])
def test_corrupt_restore_falls_back_equal_by_bits(make, tmp_path):
    """Two checkpoints, the newest corrupted: restore refuses it by name,
    and ``fallback=True`` recovers the older one, equal by bits."""
    s = _open(make(rounds=2))
    s.run(1)
    old = str(tmp_path / "old.ckpt")
    s.checkpoint(old)
    params_at_1 = {k: v.clone() for k, v in s.result().params.items()}
    s.run(1)
    new = str(tmp_path / "new.ckpt")
    s.checkpoint(new)
    with open(new, "r+b") as f:               # flip a byte of the newest
        f.seek(100)
        c = f.read(1)
        f.seek(100)
        f.write(bytes([c[0] ^ 0xFF]))
    with pytest.raises(CheckpointCorruptError, match="new.ckpt"):
        _restore(new)
    assert session_mod.latest_good_checkpoint(str(tmp_path)) == old
    resumed = _restore(new, fallback=True)
    assert resumed.rounds_done == 1
    _assert_params_equal(params_at_1, resumed.result().params)


@pytest.mark.parametrize("mode", ["truncated", "orphan", "stale-digest",
                                  "bad-sidecar"])
def test_corrupt_modes_are_named(mode, tmp_path):
    """Truncation, a stripped sidecar, a stale digest and an unreadable
    sidecar each raise ``CheckpointCorruptError`` naming the artifact."""
    s = _open(_sim_spec(rounds=1))
    s.run(1)
    path = str(tmp_path / "base.ckpt")
    s.checkpoint(path)
    meta = session_mod.read_sidecar(path)
    assert meta["sha256"] and meta["payload_bytes"] == os.path.getsize(path)
    bad = str(tmp_path / f"{mode}.ckpt")
    shutil.copyfile(path, bad)
    if mode != "orphan":
        shutil.copyfile(session_mod.sidecar_path(path),
                        session_mod.sidecar_path(bad))
    match = {"truncated": "truncated.ckpt", "orphan": "sidecar",
             "stale-digest": "digest mismatch",
             "bad-sidecar": "unreadable sidecar"}[mode]
    if mode == "truncated":
        with open(bad, "r+b") as f:
            f.truncate(os.path.getsize(bad) // 2)
    elif mode == "stale-digest":
        with open(session_mod.sidecar_path(bad), "w") as f:
            json.dump(dict(meta, sha256="0" * 64), f)
    elif mode == "bad-sidecar":
        with open(session_mod.sidecar_path(bad), "w") as f:
            f.write("{not json")
    with pytest.raises(CheckpointCorruptError, match=match):
        _restore(bad)
    # the intact original is what the recovery scan finds
    assert session_mod.latest_good_checkpoint(str(tmp_path)) == path
    assert _restore(bad, fallback=True).rounds_done == 1


def test_injected_write_fault_leaves_the_old_checkpoint(tmp_path):
    """An injected ``ckpt_write`` fault fires before any byte lands: the
    checkpoint and sidecar already at the path are untouched. The JAX
    package's injector does not reach the port (each owns its own)."""
    s = _open(_sim_spec(rounds=2))
    s.run(1)
    path = str(tmp_path / "f.ckpt")
    s.checkpoint(path)
    before = (open(path, "rb").read(),
              open(session_mod.sidecar_path(path)).read())
    s.run(1)
    inj = faults.FaultInjector(faults.FaultSpec(ckpt_write_p=1.0))
    with inj.scoped():
        with pytest.raises(faults.InjectedFault):
            s.checkpoint(path)
    assert (open(path, "rb").read(),
            open(session_mod.sidecar_path(path)).read()) == before
    assert not os.path.exists(path + ".tmp")
    from repro import faults as jfaults
    jinj = jfaults.FaultInjector(jfaults.FaultSpec(ckpt_write_p=1.0))
    with jinj.scoped():
        s.checkpoint(path)
    assert _restore(path).rounds_done == 2


# ---------------------------------------------------------------------------
# streaming and callbacks
# ---------------------------------------------------------------------------

def test_stream_yields_rounds_in_order():
    s = _open(_sim_spec(rounds=4))
    assert [r.round for r in s.stream(4)] == [0, 1, 2, 3]
    assert s.rounds_done == 4


def test_iter_runs_spec_budget():
    s = _open(_sim_spec(rounds_per_dispatch=2, rounds=3))
    assert [r.round for r in s] == [0, 1, 2]


def test_callback_early_stop():
    s = _open(_sim_spec(rounds=6))
    seen = []

    def stop_after_two(rec):
        seen.append(rec.round)
        if rec.round >= 1:
            return False                      # the early-stop hook

    s.add_callback(stop_after_two)
    list(s.stream(6))
    assert s.stopped
    assert s.rounds_done == 2 and seen == [0, 1]
    assert s.run(4) == []                     # a stopped session stays put


def test_run_then_more_rounds_continues_numbering():
    s = _open(_spmd_spec(rounds=4))
    s.run(2)
    more = s.run(2)
    assert [r.round for r in more] == [2, 3]
    assert [r.round for r in s.records] == [0, 1, 2, 3]
    s.request_stop()
    assert s.run(1) == [] and s.stopped


@pytest.mark.parametrize("path", ["megastep", "loop", "scanned", "spmd"])
def test_run_experiment_is_the_direct_drive_through_a_session(path,
                                                              monkeypatch):
    """``run_experiment`` opens a session; its records and parameters equal
    the engine driven directly (``build_simulation(spec).run`` /
    ``SpmdDriver.run_rounds``) by bits."""
    spec = {"megastep": _sim_spec(rounds=3),
            "loop": _sim_spec(rounds=3, megastep=False),
            "scanned": _sim_spec(rounds=3, rounds_per_dispatch=2),
            "spmd": _spmd_spec(rounds=3)}[path]
    opened = []
    real_open = T.ExperimentSession.open.__func__

    def spy(cls, *a, **kw):
        opened.append(a[0])
        return real_open(cls, *a, **kw)

    monkeypatch.setattr(T.ExperimentSession, "open", classmethod(spy))
    res = T.run_experiment(spec, device="cpu")
    assert opened == [spec]
    if spec.engine == "spmd":
        driver = T.SpmdDriver(spec, device="cpu")
        records, params = driver.run_rounds(spec.rounds), driver.params
    else:
        sim = T.build_simulation(spec, device="cpu")
        sim.run(spec.rounds, eval_final=True)
        records = T.result_from_simulation(spec, sim).records
        params = sim.params
    _assert_records_equal(res.records, records)
    _assert_params_equal(res.params, params)


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [_sim_spec, _spmd_spec],
                         ids=["sim", "spmd"])
def test_fingerprint_has_the_jax_fields(make):
    spec, jspec = make(T, scenario="dynamic"), make(J, scenario="dynamic")
    got, want = (session_mod._spec_fingerprint(spec),
                 jsession._spec_fingerprint(jspec))
    assert set(got) == set(want) == set(session_mod._FINGERPRINT_DOC)
    assert len(session_mod._FINGERPRINT_DOC) == 17
    for k in ("engine", "model", "seed", "eval_every", "megastep",
              "rounds_per_dispatch", "fused_eval", "optimizer",
              "lr_schedule", "eval_fn"):
        assert got[k] == want[k], k


def test_jax_session_checkpoint_is_refused_before_unpickling(tmp_path,
                                                             monkeypatch):
    jspec = _sim_spec(J, rounds=1)
    js = J.ExperimentSession.open(jspec)
    js.run(1)
    path = str(tmp_path / "jax.ckpt")
    js.checkpoint(path)
    loads = []
    monkeypatch.setattr(session_mod.pickle, "loads",
                        lambda *a, **k: loads.append(a))
    with pytest.raises(ValueError, match="sim_state_from_jax"):
        _restore(path)
    with pytest.raises(ValueError, match="sim_state_from_jax"):
        _restore(path, fallback=True)
    assert loads == []
    assert session_mod.latest_good_checkpoint(str(tmp_path)) is None


def _conv_spec(mod, **kw):
    return mod.ExperimentSpec(**{**dict(
        model="anomaly-mlp-smoke",
        data=mod.DataSpec(n_samples=1500, eval_samples=300, alpha=0.5),
        world=mod.WorldSpec(num_clients=4, dropout_p=0.1),
        comm=mod.CommModel(bandwidth=5e6, latency=0.5, t_sample=2e-3,
                           t_launch=0.25),
        strategy="ours",
        strategy_kwargs=dict(batch_size=32, lr=3e-2, local_epochs=2,
                             quantize_updates=True),
        rounds=4, seed=0), **kw})


@pytest.mark.parametrize("megastep", [True, False],
                         ids=["megastep", "loop"])
def test_jax_midrun_sim_state_continues_in_the_port(megastep):
    """The JAX package's ``ours`` + int8 run, 2 rounds in: its
    ``state_dict()`` through ``sim_state_from_jax`` into a port
    simulation, whose next 2 rounds match JAX's own next 2 by
    ``parity.record_mismatches`` (times, bytes, counts and accept rates
    equal; accuracy within ACC_TOL, loss within LOSS_RTOL), every θ test
    farther than THETA_BAND from θ, and the same selector records."""
    jspec = _conv_spec(J, megastep=megastep).validate()
    jsim = jrunner.build_simulation(jspec)
    jsim.run(2)
    state = T.sim_state_from_jax(jax.device_get(jsim.state_dict()), "cpu")
    jsim.run(2)
    want = [jrunner.record_from_metrics(m) for m in jsim.history]
    sim = T.build_simulation(_conv_spec(T, megastep=megastep),
                             device="cpu")
    sim.load_state_dict(state)
    sim.run(2)
    assert sim.theta_ratios, "the θ filter never ran"
    assert not parity.theta_band_violations(sim.theta_ratios, 0.65)
    got = [T.record_from_metrics(m) for m in sim.history]
    assert not parity.record_mismatches(got, want)
    assert {c: dataclasses.asdict(r) for c, r in sim.selector.records.items()
            } == {c: dataclasses.asdict(r)
                  for c, r in jsim.selector.records.items()}


def test_jax_midrun_spmd_state_continues_in_the_port():
    """The same for the spmd engine (``cmfl`` + int8, JAX's draws fed in),
    through ``spmd_state_from_jax``."""
    jspec = _conv_spec(J, engine="spmd", strategy="cmfl").validate()
    jd = jrunner.SpmdDriver(jspec)
    jd.run_rounds(2)
    state = T.spmd_state_from_jax(jax.device_get(jd.state_dict()), "cpu")
    want = jd.run_rounds(2)
    spec = _conv_spec(T, engine="spmd", strategy="cmfl")
    driver = T.SpmdDriver(spec, device="cpu",
                          draws=JaxSpmdDraws(spec.seed, 4, 4))
    driver.load_state_dict(state)
    got = driver.run_rounds(2)
    assert [r.round for r in got] == [2, 3]
    assert driver.theta_ratios, "the θ filter never ran"
    assert not parity.theta_band_violations(driver.theta_ratios, 0.65)
    assert not parity.record_mismatches(got, want)
    assert not parity.control_mismatches(
        {f: v.numpy() for f, v in driver.state.control._asdict().items()},
        jax.device_get(jd.state.control)._asdict())


def test_sim_state_from_jax_refuses_the_scanned_path():
    jspec = _sim_spec(J, rounds=2, rounds_per_dispatch=2)
    jsim = jrunner.build_simulation(jspec.validate())
    jsim.run(2)
    with pytest.raises(ValueError, match="control_from_jax"):
        T.sim_state_from_jax(jax.device_get(jsim.state_dict()), "cpu")


def test_restored_world_is_held_to_the_checkpoint(tmp_path):
    """The scenario's world is recomputed from round 0 on restore and held
    to the saved one by bits: a checkpoint whose world was changed is
    refused, not silently replaced."""
    spec = _sim_spec(scenario="dynamic", rounds=3)
    s = _open(spec)
    s.run(3)
    state = pickle.loads(pickle.dumps(s._driver.state_dict()))
    state["world_state"]["bw_scale"] = state["world_state"]["bw_scale"] * 2
    sim = T.build_simulation(spec, device="cpu")
    with pytest.raises(ValueError, match="bw_scale"):
        sim.load_state_dict(state)
    d = trunner.SpmdDriver(_spmd_spec(scenario="dynamic"), device="cpu")
    d.run_rounds(2)
    st = d.state_dict()
    st["fl_state"] = st["fl_state"]._replace(world=st["fl_state"].world
                                             ._replace(drift_amp=st[
                                                 "fl_state"].world.drift_amp
                                                 + 1))
    fresh = trunner.SpmdDriver(_spmd_spec(scenario="dynamic"), device="cpu")
    with pytest.raises(ValueError, match="drift_amp"):
        fresh.load_state_dict(st)
