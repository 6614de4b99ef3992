"""The port's dynamic-world scenarios (core/scenario.py) against the JAX
package's, and on their own.

Module parity: ``world_step`` / ``replay`` given the reference's link
normals, within ``parity.world_mismatches``; ``apply_drift`` and
``drift_directions`` by bits; the ``DriftStats`` functions within f32
rounding; the validation issues field for field.

Engine parity at smoke size: each path of the port runs from the JAX
simulation's initial weights with the reference's own world trajectory
(``WorldSource(views=...)``) and, where the path draws on the device, its
draws; the records within ``parity`` (``record_mismatches`` on the
loop, the megastep and spmd, ``scanned_mismatches`` on the scanned
path), the selector records and the failure logs equal. No θ ratio may lie
within THETA_BAND of θ. Then the port alone: R = 4 equals R = 1, the loop
its megastep within ``path_mismatches``, the byzantine client rejected by
θ on every path, the churn roster conserved, the ε pool live-only.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import repro.api as J
from repro.api import runner as jrunner
from repro.core import control as jcontrol
from repro.core import scenario as jscn
from repro.models import api as japi

import repro_torch as T
from repro_torch.api import parity
from repro_torch.core import control as tcontrol
from repro_torch.core import scenario as tscn

from test_torch_scanned import JaxDraws
from test_torch_spmd import JaxSpmdDraws

PRESETS = sorted(tscn.SCENARIO_PRESETS)
# two points of tests/test_scenarios.py's random grid, one with a sine drift
RANDOM = {
    "random-a": dict(drift=dict(rate=0.13, max_amp=0.9, seed=3),
                     churn=dict(period=3, leave_frac=0.4, seed=2),
                     links=dict(bw_sigma=0.45, lat_sigma=0.1, clip=3.0,
                                seed=5),
                     dropout=dict(boundaries=(2, 7), scales=(0.5, 1.5, 3.0)),
                     byzantine=dict(n_byz=2, scale=1.5, sign_flip=False)),
    "random-b": dict(drift=dict(mode="sine", period=5, max_amp=0.7, seed=1),
                     links=dict(bw_sigma=0.2, lat_sigma=0.5, seed=9),
                     byzantine=dict(n_byz=1, scale=3.0)),
}


def _scenario(mod, name):
    if name == "churn-beyond-k":
        # 3 of 5 clients offline, fewer live than the 3 selected: the
        # scanned cohort then holds dead clients, which must carry no weight
        return mod.ScenarioSpec(churn=mod.ChurnSpec(period=2, leave_frac=0.6),
                                links=mod.LinkSpec(seed=1))
    if name in RANDOM:
        parts = {"drift": mod.DriftSpec, "churn": mod.ChurnSpec,
                 "links": mod.LinkSpec, "dropout": mod.DropoutSchedule,
                 "byzantine": mod.ByzantineSpec}
        return mod.ScenarioSpec(**{k: parts[k](**v)
                                   for k, v in RANDOM[name].items()})
    return mod.SCENARIO_PRESETS[name]


class JaxNormals:
    """The JAX package's link normals of round r: ``fold_in(PRNGKey(seed),
    r)`` split into the bandwidth and latency keys (core/scenario.py)."""

    def __init__(self, seed, n):
        self.seed, self.n = seed, n

    def __call__(self, r):
        key = jax.random.fold_in(jax.random.PRNGKey(self.seed), jnp.int32(r))
        kb, kl = jax.random.split(key)
        return (np.asarray(jax.random.normal(kb, (self.n,))),
                np.asarray(jax.random.normal(kl, (self.n,))))


# ---------------------------------------------------------------------------
# module parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [5, 10])
@pytest.mark.parametrize("name", PRESETS + sorted(RANDOM))
def test_world_matches_jax(name, n):
    jspec, tspec = _scenario(jscn, name), _scenario(tscn, name)
    want = jscn.replay(jscn.resolve_scenario(jspec), n, 12)
    scn = tscn.resolve_scenario(tspec)
    normals = JaxNormals(tspec.links.seed, n) if tspec.links else None
    got = tscn.replay(scn, n, 12, normals=normals)
    if scn is None:
        assert got == want == [None] * 12
        return
    sine = scn.drift is not None and scn.drift.mode == "sine"
    assert not parity.world_mismatches(got, want, sine=sine)
    # the engines' source gives the same views, and on the device the
    # same bits as a row
    src = tscn.WorldSource(scn, n, "cpu", normals=normals)
    src.prepare(3, 5)
    for r in range(3, 8):
        ws = src.world(r)
        assert torch.equal(ws.live, torch.from_numpy(got[r]["live"]))
        assert torch.equal(ws.bw_scale, torch.from_numpy(got[r]["bw_scale"]))
        assert float(ws.drift_amp) == got[r]["drift_amp"]
        assert float(ws.dropout_scale) == got[r]["dropout_scale"]


def test_world_is_the_same_whatever_the_grouping():
    scn = tscn.SCENARIO_PRESETS["dynamic"]
    whole = tscn.replay(scn, 6, 8)
    src = tscn.WorldSource(scn, 6, "cpu")
    for r0, rounds in ((0, 3), (3, 1), (4, 4)):
        src.prepare(r0, rounds)
        for r in range(r0, r0 + rounds):
            ws = src.world(r)
            assert torch.equal(ws.lat_scale,
                               torch.from_numpy(whole[r]["lat_scale"]))
    # the port's normals: one Generator a round, seeded (seed, round)
    a, b = tscn.LinkNormals(0, 6)(5)
    z = np.random.default_rng([0, 5]).standard_normal(12, dtype=np.float32)
    assert np.array_equal(np.concatenate([a, b]), z)


@pytest.mark.parametrize("shape", [(6,), (3, 6), (2, 3, 6)],
                         ids=["B", "steps-B", "C-steps-B"])
def test_apply_drift_matches_jax(shape):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape + (7,)).astype(np.float32)
    y = rng.integers(0, 4, shape).astype(np.int32)
    dirs = tscn.drift_directions(tscn.DriftSpec(seed=4), 4, 7)
    amp = np.float32(0.37)
    want = jscn.apply_drift({"x": jnp.asarray(x), "y": jnp.asarray(y)},
                            jnp.float32(amp), jnp.asarray(dirs))
    got = tscn.apply_drift({"x": torch.from_numpy(x),
                            "y": torch.from_numpy(y).long()},
                           torch.tensor(amp), torch.from_numpy(dirs))
    assert np.array_equal(got["x"].numpy(), np.asarray(want["x"]))
    assert torch.equal(got["y"], torch.from_numpy(y).long())
    # the stacked cohort drifts each sample as the flat batch does
    flat = tscn.apply_drift({"x": torch.from_numpy(x.reshape(-1, 7)),
                             "y": torch.from_numpy(y.reshape(-1)).long()},
                            float(amp), torch.from_numpy(dirs))
    assert torch.equal(flat["x"], got["x"].reshape(-1, 7))
    with pytest.raises(ValueError, match="feature/label"):
        tscn.apply_drift({"tokens": torch.zeros(3)}, 0.1,
                         torch.from_numpy(dirs))


def test_drift_stats_match_jax():
    rng = np.random.default_rng(2)
    ref_x = rng.standard_normal((64, 5)).astype(np.float32)
    ref_s = rng.random(64).astype(np.float32)
    jref = jscn.reference_snapshot(ref_x, ref_s)
    tref = tscn.reference_snapshot(ref_x, ref_s)
    js, ts = jscn.init_drift_stats(5), tscn.init_drift_stats(5)
    for i in range(4):
        x = (rng.standard_normal((16, 5)) + 0.3 * i).astype(np.float32)
        s = rng.random(16).astype(np.float32)
        mask = (np.arange(16) < 16 - 3 * i).astype(np.float32)
        js = jscn.drift_stats_update(js, x, s, mask if i else None)
        ts = tscn.drift_stats_update(ts, x, s, mask if i else None)
    for a, b in ((tref, jref), (ts, js)):
        for f, v in a._asdict().items():
            np.testing.assert_allclose(v.numpy(), np.asarray(getattr(b, f)),
                                       rtol=2e-6, atol=1e-7, err_msg=f)
    np.testing.assert_allclose(
        float(tscn.drift_statistic(ts, tref)),
        float(jscn.drift_statistic(js, jref)), rtol=2e-6)
    # an all-padding window changes nothing
    same = tscn.drift_stats_update(ts, np.ones((4, 5), np.float32),
                                   np.ones(4, np.float32),
                                   np.zeros(4, np.float32))
    assert all(torch.equal(a, b) for a, b in zip(same, ts))


INVALID = {
    "drift": dict(drift=dict(mode="cubic", rate=-1.0, max_amp=0.0,
                             period=0)),
    "churn": dict(churn=dict(period=0, leave_frac=1.0)),
    "links": dict(links=dict(bw_sigma=-0.1, lat_sigma=-0.2, clip=1.0)),
    "dropout": dict(dropout=dict(boundaries=(4, 2), scales=(1.0, -2.0))),
    "byzantine": dict(byzantine=dict(n_byz=-1, scale=0.0)),
}


@pytest.mark.parametrize("name", sorted(INVALID))
def test_validation_matches_jax(name):
    parts = {"drift": "DriftSpec", "churn": "ChurnSpec", "links": "LinkSpec",
             "dropout": "DropoutSchedule", "byzantine": "ByzantineSpec"}

    def issues(mod):
        kw = {k: getattr(mod, parts[k])(**v) for k, v in INVALID[name].items()}
        spec = mod.ScenarioSpec(**kw)
        with pytest.raises(ValueError, match="invalid ScenarioSpec"):
            spec.validate()
        try:
            _spec(mod, spec, "megastep").validate()
        except mod.SpecError as e:
            return spec.issues(), [(i.field, i.value, i.hint)
                                   for i in e.issues]
        raise AssertionError("the spec validated")

    jscn_issues, jspec_issues = issues(J)
    tscn_issues, tspec_issues = issues(T)
    assert tscn_issues == jscn_issues and tscn_issues
    assert tspec_issues == jspec_issues
    assert all(f.startswith("scenario.") for f, _v, _h in tspec_issues)


@pytest.mark.parametrize("case", ["unknown-preset", "all-byzantine",
                                  "not-a-spec"])
def test_spec_refuses_a_bad_scenario_as_jax_does(case):
    def fields(mod):
        scenario = {"unknown-preset": "hurricane",
                    "all-byzantine": mod.ScenarioSpec(
                        byzantine=mod.ByzantineSpec(n_byz=5)),
                    "not-a-spec": 3}[case]
        with pytest.raises(mod.SpecError) as err:
            _spec(mod, scenario, "megastep").validate()
        return [(i.field, i.hint) for i in err.value.issues]

    assert fields(T) == fields(J)
    assert fields(T)[0][0] in ("scenario", "scenario.byzantine.n_byz")


@pytest.mark.parametrize("name", PRESETS)
def test_spec_accepts_every_preset(name):
    for path in PATHS:
        spec = _spec(T, name, path).validate()
        want = J.SCENARIO_PRESETS[name]
        got = spec.resolve_scenario()
        if name == "static":
            assert got is None
        else:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert not T.seed_vectorizable(_spec(T, name, "spmd")) \
        or name == "static"


# ---------------------------------------------------------------------------
# the engines against the JAX package
# ---------------------------------------------------------------------------

PATHS = ("loop", "megastep", "scanned4", "spmd")


def _spec(mod, scenario, path, rounds=4, model="anomaly-mlp-smoke", n=1500,
          clients=5, seed=0):
    """The smoke world of the port's parity tests on one path: ``ours``
    picking 3 of 5 (int8 on the megastep and scanned paths) on the sim
    engine, ``cmfl`` on spmd."""
    kw = dict(batch_size=32, lr=3e-2, local_epochs=2)
    fields = {}
    if path == "spmd":
        strategy, fields["engine"] = "cmfl", "spmd"
    else:
        strategy = "ours"
        kw.update(select_fraction=0.6, dynamic_batch=False,
                  quantize_updates=path != "loop")
        fields["megastep"] = path != "loop"
        if path.startswith("scanned"):
            fields.update(rounds_per_dispatch=int(path[-1]), fused_eval=True)
    if isinstance(scenario, str) and scenario == "churn-beyond-k":
        scenario = _scenario(mod, scenario)
    return mod.ExperimentSpec(
        model=model,
        data=mod.DataSpec(n_samples=n, eval_samples=300, alpha=0.5),
        world=mod.WorldSpec(num_clients=clients, dropout_p=0.1),
        comm=mod.CommModel(bandwidth=5e6, latency=0.5, t_sample=2e-3,
                           t_launch=0.25),
        strategy=strategy, strategy_kwargs=kw, scenario=scenario,
        rounds=rounds, seed=seed, **fields)


def _p0(jspec):
    return {k: np.asarray(v) for k, v in japi.init_params(
        jax.random.PRNGKey(jspec.seed), jspec.resolve_model()).items()}


def _views(views):
    return [{k: (np.array(v) if isinstance(v, np.ndarray) else v)
             for k, v in view.items()} for view in views]


def _run_jax_and_port(scenario, path, **kw):
    """(port result holder, JAX result holder, port spec): the JAX run, and
    the port's from its weights, its world and its draws."""
    jspec = _spec(J, scenario, path, **kw).validate()
    tspec = _spec(T, scenario, path, **kw).validate()
    n = tspec.world.num_clients
    scn = tspec.resolve_scenario()
    if path == "spmd":
        jdrv = jrunner.SpmdDriver(jspec)
        views = []
        jrecs = []
        for _ in range(jspec.rounds):      # the world its step ran under
            jrecs += jdrv.run_rounds(1)
            views.append(jscn.host_view(jdrv.state.world))
        src = tscn.WorldSource(scn, n, "cpu", views=_views(views))
        k = n
        tdrv = T.SpmdDriver(tspec, device="cpu", params=_p0(jspec),
                            draws=JaxSpmdDraws(jspec.seed, n, k),
                            world_source=src)
        return tdrv, tdrv.run_rounds(tspec.rounds), jdrv, jrecs, tspec
    views = jscn.replay(jspec.resolve_scenario(), n, jspec.rounds)
    src = tscn.WorldSource(scn, n, "cpu", views=_views(views))
    jsim = jrunner.build_simulation(jspec)
    draws = (JaxDraws(jspec.seed, *jsim._scan_shapes())
             if path.startswith("scanned") else None)
    sim = T.build_simulation(tspec, device="cpu", params=_p0(jspec),
                             draws=draws, world_source=src)
    jsim.run(jspec.rounds, eval_final=True)
    sim.run(tspec.rounds)
    got = T.result_from_simulation(tspec, sim).records
    want = [jrunner.record_from_metrics(m) for m in jsim.history]
    return sim, got, jsim, want, tspec


ENGINE_CASES = [(s, p) for s in ("byzantine", "churn+flaky-links", "dynamic",
                                 "churn-beyond-k") for p in PATHS]


@pytest.mark.parametrize("scenario,path", ENGINE_CASES,
                         ids=[f"{s}-{p}" for s, p in ENGINE_CASES])
def test_engine_matches_jax(scenario, path):
    sim, got, jsim, want, tspec = _run_jax_and_port(scenario, path)
    close_calls = parity.theta_band_violations(sim.theta_ratios, 0.65)
    assert not close_calls, close_calls      # choose another seed
    if path.startswith("scanned"):
        problems = parity.scanned_mismatches(got, want)
        assert not problems, problems
        assert not parity.control_mismatches(
            {f: v.numpy() for f, v in sim._scan_ctl._asdict().items()},
            jsim._scan_ctl._asdict())
        return
    problems = parity.record_mismatches(got, want)
    assert not problems, problems
    if path == "spmd":
        assert np.array_equal(sim.client_pass_rates(),
                              np.asarray(jsim.state.control.pass_rate))
        return
    assert {c: dataclasses.asdict(r) for c, r in sim.selector.records.items()} \
        == {c: dataclasses.asdict(r) for c, r in jsim.selector.records.items()}
    assert sim.failure_log == jsim.failure_log


def test_full_width_megastep_matches_jax():
    """The paper's model at full width (54,602 parameters) under the
    dynamic world, int8 on the megastep, two rounds."""
    sim, got, jsim, want, _ = _run_jax_and_port(
        "dynamic", "megastep", rounds=2, model="anomaly-mlp", n=1600,
        clients=4, seed=2)
    assert sim._arena.n == 54_602
    assert not parity.theta_band_violations(sim.theta_ratios, 0.65)
    problems = parity.record_mismatches(got, want)
    assert not problems, problems
    assert sim.failure_log == jsim.failure_log


# ---------------------------------------------------------------------------
# the port on its own
# ---------------------------------------------------------------------------

def _run(spec):
    return T.run_experiment(spec, device="cpu")


def test_scanned_dispatch_grouping_does_not_change_the_run():
    spec = _spec(T, "dynamic", "scanned4", rounds=6)
    r4 = _run(spec).records
    r1 = _run(dataclasses.replace(spec, rounds_per_dispatch=1)).records
    assert r4 == r1


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_loop_matches_megastep(quantize):
    records = {}
    for path in ("loop", "megastep"):
        spec = _spec(T, "dynamic", path, rounds=6)
        kw = dict(spec.strategy_kwargs, quantize_updates=quantize)
        records[path] = _run(dataclasses.replace(spec,
                                                 strategy_kwargs=kw)).records
    problems = parity.path_mismatches(records["loop"], records["megastep"])
    assert not problems, problems


@pytest.mark.parametrize("path", PATHS)
def test_byzantine_client_is_rejected(path):
    """The sign-flipped client 0's θ pass-rate EMA collapses below 0.5 and
    below every honest client's (the JAX package's harness contract)."""
    spec = _spec(T, "byzantine", path, rounds=8)
    st = dict(spec.strategy_kwargs, theta=0.6)
    if path != "spmd":
        st.update(select_fraction=1.0)
    spec = dataclasses.replace(
        spec, strategy_kwargs=st,
        data=dataclasses.replace(spec.data, partition="iid"))
    if path == "spmd":
        drv = T.SpmdDriver(spec.validate(), device="cpu")
        drv.run_rounds(spec.rounds)
        rates = drv.client_pass_rates()
    else:
        sim = T.build_simulation(spec, device="cpu")
        sim.run(spec.rounds)
        rates = sim.client_pass_rates()
    assert rates[0] < 0.5 and rates[0] < rates[1:].min(), rates


@pytest.mark.parametrize("path", PATHS)
def test_churn_roster_is_conserved(path):
    scn = tscn.ChurnSpec(period=2, leave_frac=0.4)
    spec = _spec(T, tscn.ScenarioSpec(churn=scn), path, rounds=6)
    views = tscn.replay(spec.resolve_scenario(), 5, 6)
    lives = [v["live"] for v in views]
    assert [int(l.sum()) for l in lives] == [3] * 6
    assert len({tuple(l) for l in lives}) == 3      # the block rotates
    for rec, live in zip(_run(spec).records, lives):
        assert rec.updates_applied <= int(live.sum())


def test_epsilon_pool_excludes_churned_clients():
    n, k = 8, 3
    live = torch.tensor([True, False, True, False, True, True, True, False])
    scores = torch.where(live, torch.linspace(1.0, 0.1, n), -torch.inf)
    rng = np.random.default_rng(0)
    seen = set()
    for _ in range(20):
        eps_u = torch.from_numpy(rng.random(k, dtype=np.float32))
        pick_u = torch.from_numpy(rng.random(k, dtype=np.float32))
        cohort = tcontrol.select_topk_epsilon(scores, k, 1.0, eps_u, pick_u,
                                              live=live)
        assert bool(live[cohort].all()), cohort
        want = jcontrol.select_topk_epsilon(
            jnp.asarray(scores.numpy()), k, 1.0, jnp.asarray(eps_u.numpy()),
            jnp.asarray(pick_u.numpy()), live=jnp.asarray(live.numpy()))
        assert cohort.tolist() == np.asarray(want).tolist()
        seen.update(tcontrol.select_topk_epsilon(scores, k, 1.0, eps_u,
                                                 pick_u).tolist())
    assert seen - {0, 2, 4, 5, 6}          # without the mask they are picked
