"""The port's scanned path (``rounds_per_dispatch``, ``fused_eval``)
against the JAX package's, on smoke-size specs, from the JAX simulation's
own initial parameters.

The JAX package draws inside its scan from a PRNG key that torch cannot
replay, so the port's run here takes its draws from ``JaxDraws``, a draw
source that repeats the reference's key calls (``fold_in``, ``split`` in
four, three uniforms and a ``randint`` bounded by the cohort's shard
sizes). With the same draws the runs agree within
``repro_torch.api.parity``: round labels, update counts, accept rates,
selections and the integer ``ControlState`` fields equal; the f32
accumulators, EMAs, accuracy and loss within its scanned-path tolerances;
the error feedback after one round from the same state. No θ ratio may lie
within THETA_BAND of θ, where a decision could flip on float noise.

Also the port on its own: its draws do not depend on the dispatch
grouping (R = 4 equals R = 1, a partial final dispatch included), the
seed batch equals solo runs, and what the engine and the spec refuse.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import repro.api as J
from repro.api import runner as jrunner
from repro.core import control as jctl
from repro.models import api as japi

import repro_torch as T
from repro_torch.api import parity
from repro_torch.convert import control_from_jax
from repro_torch.core import async_engine as tae
from repro_torch.core import control as tcontrol


class JaxDraws:
    """The JAX package's scanned draws (core/megastep.py, round_body), for
    the port's round body: the reference's own calls on its own keys."""

    def __init__(self, seed, k, steps, batch):
        self.base = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
        self.k, self.shape = k, (k, steps, batch)

    def prepare(self, round0, rounds):
        pass

    def keys(self, r):
        return jax.random.split(jax.random.fold_in(self.base, jnp.int32(r)),
                                4)

    def round_draws(self, r):
        return tuple(torch.from_numpy(np.array(
            jax.random.uniform(key, (self.k,)))) for key in self.keys(r)[:3])

    def batch_index(self, r, sz):
        sz = jnp.asarray(sz.numpy().astype(np.int32))
        idx = jax.random.randint(self.keys(r)[3], self.shape, 0,
                                 sz[:, None, None])
        return torch.from_numpy(np.asarray(idx).astype(np.int64))


def _spec(mod, strategy, rounds=8, R=4, fused=False, dropout=0.0,
          partition="dirichlet", eval_every=1, **kw):
    return mod.ExperimentSpec(
        model="anomaly-mlp-smoke",
        data=mod.DataSpec(n_samples=1200, eval_samples=300, alpha=0.5,
                          partition=partition),
        world=mod.WorldSpec(num_clients=5, dropout_p=dropout),
        comm=mod.CommModel(bandwidth=5e6, latency=0.5, t_sample=2e-3,
                           t_launch=0.25),
        strategy=strategy, strategy_kwargs=dict(batch_size=32, lr=3e-2, **kw),
        rounds=rounds, seed=0, rounds_per_dispatch=R, fused_eval=fused,
        eval_every=eval_every)


CASES = {
    "fedavg": dict(strategy="fedavg"),
    "cmfl": dict(strategy="cmfl"),
    "ours-select": dict(strategy="ours", select_fraction=0.75, dropout=0.2,
                        fused=True),
    "ours-int8": dict(strategy="ours", quantize_updates=True),
}


def _p0(jspec):
    return {k: np.asarray(v) for k, v in japi.init_params(
        jax.random.PRNGKey(jspec.seed), jspec.resolve_model()).items()}


def _port(kw, jsim):
    """The port's simulation of the spec ``_spec(T, **kw)``, from the JAX
    run's initial parameters and with its draws."""
    spec = _spec(T, **kw)
    sim = T.build_simulation(spec, device="cpu", params=_p0(_spec(J, **kw)),
                             draws=JaxDraws(0, *jsim._scan_shapes()))
    return spec, sim


def _jax_cohort(jsim, draws, r):
    """The cohort the JAX round body selects at round r from its state."""
    K = jsim._scan_shapes()[0]
    st = jsim.strategy
    if not (st.selection and K < jsim.num_clients):
        return list(range(K))
    eps_u, pick_u, _ = (jnp.asarray(d.numpy()) for d in draws.round_draws(r))
    return np.asarray(jctl.two_stage_select(
        jctl.score(jsim._scan_ctl), K, epsilon=0.1, eps_u=eps_u,
        pick_u=pick_u)).tolist()


@pytest.mark.parametrize("case", sorted(CASES))
def test_scanned_run_matches_jax(case):
    jspec = _spec(J, **CASES[case]).validate()
    jsim = jrunner.build_simulation(jspec)
    draws = JaxDraws(0, *jsim._scan_shapes())
    if case == "ours-select":
        # round by round, to read the reference's selection from its state
        jsim._scan_setup()
        want_cohorts = []
        for r in range(jspec.rounds):
            want_cohorts.append(_jax_cohort(jsim, draws, r))
            jsim.run(1)
    else:
        jsim.run(jspec.rounds)
        want_cohorts = [list(range(jsim._scan_shapes()[0]))] * jspec.rounds
    spec, sim = _port(CASES[case], jsim)
    sim.run(spec.rounds)

    assert not parity.theta_band_violations(sim.theta_ratios, 0.65)
    if jspec.resolve_strategy().theta is not None:
        assert sim.theta_ratios, "the θ filter never ran"
    got = T.result_from_simulation(spec, sim).records
    want = [jrunner.record_from_metrics(m) for m in jsim.history]
    assert not parity.scanned_mismatches(got, want)
    assert sim.cohorts == want_cohorts
    assert not parity.control_mismatches(
        {f: v.numpy() for f, v in sim._scan_ctl._asdict().items()},
        jsim._scan_ctl)
    assert sim.server_step == jsim.server_step
    assert len(sim.failure_log) == len(jsim.failure_log)
    np.testing.assert_allclose(sim.client_pass_rates(),
                               jsim.client_pass_rates(),
                               rtol=parity.EMA_RTOL)
    assert sim.dispatches == (2 if spec.fused_eval else 4)
    if case == "ours-select":
        assert sum(r.updates_applied for r in got) > 0
        assert any(c != sorted(c) for c in sim.cohorts), \
            "selection never reordered the cohort"


def test_one_round_from_a_jax_mid_run_state():
    """Both packages step one round from the same state (the JAX run's
    after three rounds): selection, records and control state agree, and
    the error feedback within parity.ef_mismatches."""
    kw = dict(strategy="ours", quantize_updates=True, select_fraction=0.6,
              dropout=0.2, R=1)
    jsim = jrunner.build_simulation(_spec(J, **kw).validate())
    jsim.run(3)
    _spec_t, sim = _port(kw, jsim)
    sim._scan_setup()
    sim._params_mat = torch.from_numpy(np.array(jsim._params_mat))
    if jsim._ref_mat is not None:
        sim._scan_ref = torch.from_numpy(np.array(jsim._ref_mat))
    sim._scan_ref_valid = torch.tensor(bool(jsim._scan_ref_valid))
    sim._scan_ctl = control_from_jax(
        {f: np.asarray(v) for f, v in jsim._scan_ctl._asdict().items()},
        "cpu")
    for f in ("sim_time", "comm_time", "idle_time", "bytes_sent",
              "round_idx", "_scan_round0"):
        setattr(sim, f, getattr(jsim, f))
    sim._scan_acc = torch.tensor([jsim.sim_time, jsim.comm_time,
                                  jsim.idle_time, jsim.bytes_sent],
                                 dtype=torch.float32)
    want_cohort = _jax_cohort(jsim, sim._draws, 3)
    jsim.run(1)
    sim.run(1)
    assert sim.cohorts == [want_cohort]
    assert len(want_cohort) == 3
    got = [T.record_from_metrics(m) for m in sim.history]
    assert not parity.scanned_mismatches(
        got, [jrunner.record_from_metrics(jsim.history[-1])])
    assert got[0].round == 3
    assert not parity.control_mismatches(
        {f: v.numpy() for f, v in sim._scan_ctl._asdict().items()},
        jsim._scan_ctl)
    assert not parity.ef_mismatches(sim._scan_ctl.ef.numpy(),
                                    np.asarray(jsim._scan_ctl.ef))
    want_mat = np.asarray(jsim._params_mat)
    np.testing.assert_allclose(sim._params_mat.numpy(), want_mat, rtol=1e-4,
                               atol=1e-5 * np.abs(want_mat).max())


def _own(R, rounds=8, **kw):
    spec = _spec(T, "ours", rounds=rounds, R=R, fused=True,
                 quantize_updates=True, select_fraction=0.6, dropout=0.2,
                 **kw)
    sim = T.build_simulation(spec, device="cpu")
    sim.run(spec.rounds)
    return sim


@pytest.mark.parametrize("R,rounds", [(4, 8), (3, 7)])
def test_grouping_of_rounds_changes_nothing(R, rounds):
    """R rounds per dispatch against one: the same run to the bit, a
    partial final dispatch included (R = 3 over 7 rounds is 3 + 3 + 1)."""
    grouped, single = _own(R, rounds), _own(1, rounds)
    assert grouped.history == single.history
    assert [m.round for m in grouped.history] == list(range(rounds))
    assert all(np.isfinite(m.accuracy) for m in grouped.history)
    assert grouped.cohorts == single.cohorts
    for a, b in zip(grouped._scan_ctl, single._scan_ctl):
        assert torch.equal(a, b)
    assert torch.equal(grouped._params_mat, single._params_mat)
    assert grouped.dispatches == -(-rounds // R)
    assert single.dispatches == rounds


def _batch_spec(**over):
    return dataclasses.replace(
        _spec(T, "ours", rounds=5, R=3, fused=True, partition="iid",
              eval_every=2), **over)


def test_seed_batch_matches_solo_runs():
    spec = _batch_spec()
    seeds = [0, 1, 2]
    batch = T.run_scanned_seed_batch(spec, seeds, device="cpu")
    for s, res in zip(seeds, batch):
        solo = T.run_experiment(dataclasses.replace(spec, seed=s),
                                device="cpu")
        assert res.seed == s and len(res.records) == spec.rounds
        assert res.records == solo.records
        for k, v in res.params.items():
            assert torch.equal(v, solo.params[k])
    assert batch[0].records != batch[1].records


def test_seed_batch_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="trace shapes"):
        T.run_scanned_seed_batch(_batch_spec(data=T.DataSpec(
            n_samples=1200, eval_samples=300, partition="dirichlet")),
            [0, 1, 2], device="cpu")
    with pytest.raises(ValueError, match="rounds_per_dispatch"):
        T.run_scanned_seed_batch(_batch_spec(rounds_per_dispatch=None,
                                             fused_eval=False), [0, 1],
                                 device="cpu")


REFUSALS = {
    "rounds_per_dispatch needs the megastep": (
        dict(megastep=False, rounds_per_dispatch=2), "megastep"),
    "fused_eval needs rounds_per_dispatch": (
        dict(rounds_per_dispatch=None, fused_eval=True), "fused_eval"),
    "fused_eval refuses a custom eval_fn": (
        dict(fused_eval=True, eval_fn=lambda params, batch: 0.0),
        "fused_eval"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_engine_and_spec_refuse_what_the_reference_refuses(name):
    over, field = REFUSALS[name]
    spec = dataclasses.replace(_spec(T, "ours", rounds=2, R=2), **over)
    with pytest.raises(T.SpecError) as err:
        spec.validate()
    assert any(i.field == field for i in err.value.issues), err.value
    world = spec.build_world()
    with pytest.raises(ValueError):
        tae.FederatedSimulation(
            spec.resolve_model(), world.client_arrays, world.eval_arrays,
            spec.resolve_strategy(), world.profiles, device="cpu",
            megastep=spec.megastep, eval_fn=spec.eval_fn,
            rounds_per_dispatch=spec.rounds_per_dispatch,
            fused_eval=spec.fused_eval)


def test_scanned_spec_runs_on_the_card_by_default(monkeypatch):
    spec = _spec(T, "ours", rounds=2, R=2, fused=True)
    assert spec.validate() is spec
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.run_experiment(spec)


def _flaky_world():
    """tests/test_megastep.py::test_scanned_selection_prefers_reliable_clients:
    six equal shards of the smoke data, clients 0 and 1 dropping out with
    p = 0.9, half of the clients selected each round."""
    from repro_torch.data import synthetic
    from repro_torch.configs import anomaly_mlp
    cfg = anomaly_mlp.SMOKE
    X, y = synthetic.make_unsw_like(0, 1500, cfg.num_features,
                                    cfg.num_classes)
    clients = [{"x": X[i * 250:(i + 1) * 250], "y": y[i * 250:(i + 1) * 250]}
               for i in range(6)]
    Xe, ye = synthetic.make_unsw_like(1, 300, cfg.num_features,
                                      cfg.num_classes)
    return cfg, clients, {"x": Xe, "y": ye}


def _flaky_sim(engine, get_strategy, cfg, clients, ev, **kw):
    strat = get_strategy("ours").build(batch_size=32, dynamic_batch=False,
                                       select_fraction=0.5)
    profiles = engine.uniform_profiles(6)
    for cid in (0, 1):
        profiles[cid] = dataclasses.replace(profiles[cid], dropout_p=0.9)
    return engine.FederatedSimulation(cfg, clients, ev, strat, profiles,
                                      seed=kw.pop("seed", 0), megastep=True,
                                      rounds_per_dispatch=5, **kw)


def test_red_reference_selection_case_is_its_draws():
    """The JAX test named above fails on this stack: with the reference's
    draws, ε-exploration never picks reliable client 5, whose score stays
    at its initial 0.5, while flaky client 0 ends at 0.514. The port fed
    the same draws ends in the same state; fed its own draws, at five
    seeds, the flaky clients rank below every reliable one. So the
    assertion depends on which clients the draws explore, not on the
    selection rule."""
    from repro.api.strategies import get_strategy as jget
    from repro.configs import anomaly_mlp as jcfg
    from repro.core import async_engine as jae
    from repro_torch.api.strategies import get_strategy as tget
    cfg, clients, ev = _flaky_world()
    jsim = _flaky_sim(jae, jget, jcfg.SMOKE, clients, ev)
    jsim.run(25)
    jscores = np.asarray(jctl.score(jsim._scan_ctl))
    p0 = _p0(_spec(J, "ours"))
    sim = _flaky_sim(tae, tget, cfg, clients, ev, device="cpu", params=p0,
                     draws=JaxDraws(0, *jsim._scan_shapes()))
    sim.run(25)
    assert not parity.control_mismatches(
        {f: v.numpy() for f, v in sim._scan_ctl._asdict().items()},
        jsim._scan_ctl)
    np.testing.assert_allclose(_scores(sim), jscores, rtol=parity.EMA_RTOL)
    assert jscores[5] == 0.5 and jscores[0] > 0.5          # the red case
    assert not any(5 in c for c in sim.cohorts)
    for seed in range(5):
        own = _flaky_sim(tae, tget, cfg, clients, ev, device="cpu",
                         params=p0, seed=seed)
        own.run(25)
        s = _scores(own)
        assert s[:2].max() < s[2:].min(), (seed, s)


def _scores(sim):
    return tcontrol.score(sim._scan_ctl).numpy()
