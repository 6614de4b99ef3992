"""The port's spmd engine (``engine="spmd"``: ``SpmdDriver``,
``run_experiment``, ``run_spmd_seed_batch``) against the JAX package's, on
smoke-size specs, from the JAX package's own initial weights and draws.

The paper's synchronous baselines of Table II (``fedavg``, ``cmfl``,
``acfl``, ``fedl2p``) and ``cmfl`` with int8 wire compression run 3
rounds in both packages; the port's driver is handed the JAX weights
(``PRNGKey(spec.seed)``) and ``JaxSpmdDraws``, the reference's own key
calls. Records agree within ``repro_torch.api.parity.record_mismatches``
(times, bytes, update counts and accept rates equal; accuracy and loss to
float rounding), and no θ ratio lies within THETA_BAND of θ.

Also the port on its own: the degenerate sim ≡ spmd parity that
tests/test_api.py asserts for the JAX package, the seed batch against
solo runs, and the spec's acceptances and refusals next to the JAX
package's.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import repro.api as J
from repro.api import runner as jrunner
from repro.models import api as japi

import repro_torch as T
from repro_torch.api import parity

CLIENTS = 4


class JaxSpmdDraws:
    """The JAX spmd step's draws: ``fold_in(PRNGKey(seed), step)`` split
    into (k_sel, k_drop); k_sel split into the ε and pick keys."""

    def __init__(self, seed, num_clients, k):
        self.seed, self.num_clients, self.k = seed, num_clients, k

    def round_draws(self, step):
        key = jax.random.fold_in(jax.random.PRNGKey(self.seed),
                                 jnp.int32(step))
        k_sel, k_drop = jax.random.split(key)
        ke, kp = jax.random.split(k_sel)
        out = (jax.random.uniform(ke, (self.k,)),
               jax.random.uniform(kp, (self.k,)),
               jax.random.uniform(k_drop, (self.num_clients,)))
        return tuple(torch.from_numpy(np.array(a)) for a in out)


def _spec(mod, strategy, dropout=0.1, **kw):
    return mod.ExperimentSpec(
        model="anomaly-mlp-smoke",
        data=mod.DataSpec(n_samples=1500, eval_samples=300, alpha=0.5),
        world=mod.WorldSpec(num_clients=CLIENTS, dropout_p=dropout),
        comm=mod.CommModel(bandwidth=5e6, latency=0.5, t_sample=2e-3,
                           t_launch=0.25),
        strategy=strategy,
        strategy_kwargs=dict(batch_size=32, lr=3e-2, local_epochs=2, **kw),
        rounds=3, seed=0, engine="spmd")


def _p0(jspec):
    return {k: np.asarray(v) for k, v in japi.init_params(
        jax.random.PRNGKey(jspec.seed), jspec.resolve_model()).items()}


def _select_k(spec):
    st = spec.resolve_strategy()
    if st.grad_norm_selection or (st.selection and st.select_fraction < 1):
        return max(1, int(st.select_fraction * CLIENTS))
    return CLIENTS


CASES = {
    "fedavg": dict(strategy="fedavg"),
    "cmfl": dict(strategy="cmfl"),
    "acfl": dict(strategy="acfl"),
    "fedl2p": dict(strategy="fedl2p"),
    "cmfl+int8": dict(strategy="cmfl", quantize_updates=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spmd_run_matches_jax(case):
    """Records, the final parameters and the control state (its EMAs
    observe the driver's analytic round-time hint) against the JAX
    package's driver, which ``run_experiment`` runs for engine='spmd'."""
    jspec = _spec(J, **CASES[case])
    jdriver = jrunner.SpmdDriver(jspec.validate())
    want = jdriver.result(jdriver.run_rounds(jspec.rounds))
    spec = _spec(T, **CASES[case])
    p0 = _p0(jspec)
    driver = T.SpmdDriver(spec, device="cpu", params=p0,
                          draws=JaxSpmdDraws(spec.seed, CLIENTS,
                                             _select_k(spec)))
    got = driver.result(driver.run_rounds(spec.rounds))
    theta = spec.resolve_strategy().theta
    if theta is not None:
        assert driver.theta_ratios, "the θ filter never ran"
        assert not parity.theta_band_violations(driver.theta_ratios, theta)
    assert not parity.record_mismatches(got.records, want.records)
    assert (got.engine, got.num_clients, got.param_bytes) == \
        (want.engine, want.num_clients, want.param_bytes)
    assert all(np.isfinite(r.accuracy) for r in got.records)
    assert not parity.spmd_param_mismatches(
        {k: v.numpy() for k, v in got.params.items()},
        jax.device_get(want.params), p0, spec.rounds, bf16_agg=True)
    assert not parity.control_mismatches(
        {f: v.numpy() for f, v in driver.state.control._asdict().items()},
        jax.device_get(jdriver.state.control)._asdict())
    np.testing.assert_array_equal(driver.client_pass_rates(),
                                  jdriver.client_pass_rates())


def test_spmd_lr_schedule_matches_jax():
    """An LR schedule of the step counter, in each package's own ops."""
    jspec = dataclasses.replace(_spec(J, "fedavg", dropout=0.0),
                                lr_schedule=lambda s: 0.06 * 0.5 ** s)
    spec = dataclasses.replace(_spec(T, "fedavg", dropout=0.0),
                               lr_schedule=lambda s: 0.06 * 0.5 ** s)
    want = J.run_experiment(jspec)
    got = T.run_experiment(spec, device="cpu", params=_p0(jspec))
    assert not parity.record_mismatches(got.records, want.records)
    plain = T.run_experiment(dataclasses.replace(spec, lr_schedule=None),
                             device="cpu", params=_p0(jspec))
    assert plain.records[-1].loss != got.records[-1].loss


def test_run_experiment_is_the_driver():
    spec = _spec(T, "cmfl")
    p0 = _p0(_spec(J, "cmfl"))
    res = T.run_experiment(spec, device="cpu", params=p0)
    driver = T.SpmdDriver(spec, device="cpu", params=p0)
    assert res.records == driver.run_rounds(spec.rounds)
    assert res.engine == "spmd"
    for k, v in res.params.items():
        assert torch.equal(v, driver.params[k])
    rates = driver.client_pass_rates()
    assert rates.shape == (CLIENTS,) and np.isfinite(rates).all()


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.run_experiment(_spec(T, "fedavg"))


# ---------------------------------------------------------------------------
# the port on its own
# ---------------------------------------------------------------------------

def _degenerate(mod):
    """tests/test_api.py's degenerate configuration: one local step
    (max_samples == batch), no θ, uniform profiles, zero latency."""
    st = mod.StrategyConfig(mode="sync", theta=None, selection=False,
                            dynamic_batch=False, checkpointing=False,
                            batch_size=32, lr=3e-2, local_epochs=1,
                            max_samples_per_round=32)
    return mod.ExperimentSpec(
        model="anomaly-mlp-smoke",
        data=mod.DataSpec(n_samples=1200, eval_samples=300),
        world=mod.WorldSpec(num_clients=4, profile="uniform"),
        comm=mod.CommModel(bandwidth=5e6, latency=0.0, t_sample=2e-3,
                           t_launch=0.25),
        strategy=st, rounds=3, seed=0)


def test_sim_spmd_parity_degenerate():
    spec = _degenerate(T)
    p0 = _p0(_degenerate(J))
    sim = T.run_experiment(spec, device="cpu", params=p0)
    spmd = T.run_experiment(dataclasses.replace(spec, engine="spmd"),
                            device="cpu", params=p0)
    assert (sim.num_clients, sim.param_bytes) == \
        (spmd.num_clients, spmd.param_bytes)
    for a, b in zip(sim.records, spmd.records):
        for f in ("round", "sim_time", "comm_time", "idle_time",
                  "bytes_sent", "accept_rate"):
            assert getattr(a, f) == getattr(b, f), f
        assert a.updates_applied == b.updates_applied == sim.num_clients
        np.testing.assert_allclose(a.accuracy, b.accuracy, atol=1e-6)
        np.testing.assert_allclose(a.loss, b.loss, rtol=1e-4)


def test_seed_batch_equals_solo_runs():
    spec = dataclasses.replace(_spec(T, "fedavg", dropout=0.0), eval_every=2)
    assert T.seed_vectorizable(spec)
    # one cohort shape: these seeds' smallest shards all take 16 local
    # steps (seeds 0 and 1 take 8, and the batch refuses to mix them)
    seeds = (2, 3, 4)
    batch = T.run_spmd_seed_batch(spec, seeds, device="cpu")
    for s, res in zip(seeds, batch):
        solo = T.run_experiment(dataclasses.replace(spec, seed=s),
                                device="cpu")
        assert res.seed == s
        assert res.records == solo.records
        for k, v in res.params.items():
            assert torch.equal(v, solo.params[k])
    with pytest.raises(ValueError, match="seed-vectorizable"):
        T.run_spmd_seed_batch(_spec(T, "fedavg"), seeds, device="cpu")
    with pytest.raises(ValueError, match="cohort shapes"):
        T.run_spmd_seed_batch(spec, (1, 2), device="cpu")


# spec options -> what the JAX package says, and what the port adds
ACCEPTED = {
    "fedavg": dict(strategy="fedavg"),
    "selection": dict(strategy="acfl"),
    "dropout": dict(strategy="cmfl", world=dict(dropout_p=0.3)),
    "quantize": dict(strategy="cmfl", quantize_updates=True),
    "per_client_lr": dict(strategy="fedl2p"),
    "lr_schedule": dict(strategy="fedavg", lr_schedule=lambda s: 0.01),
    "optimizer-sgd": dict(strategy="fedavg", optimizer="sgd"),
    "scenario": dict(strategy="cmfl", scenario="dynamic"),
    "topology": dict(strategy="cmfl", topology="two-tier-pods"),
}
REFUSED_LIKE_JAX = {
    "async": (dict(strategy="ours", dynamic_batch=False), "schedule.kind"),
    "dynamic_batch": (dict(strategy="cmfl", dynamic_batch=True),
                      "strategy.dynamic_batch"),
    "rounds_per_dispatch": (dict(strategy="fedavg", rounds_per_dispatch=4),
                            "rounds_per_dispatch"),
    "fused_eval": (dict(strategy="fedavg", fused_eval=True), "fused_eval"),
}
NOT_PORTED = {
    "adamw": (dict(optimizer="adamw"), "optimizer", 14),
    "adafactor": (dict(optimizer="adafactor"), "optimizer", 14),
    "candidate_frac": (dict(candidate_frac=0.5), "candidate_frac", 10),
}
_SPEC_FIELDS = ("rounds_per_dispatch", "fused_eval", "lr_schedule",
                "optimizer", "scenario", "topology", "candidate_frac")


def _make(mod, options):
    options = dict(options)
    strategy = options.pop("strategy", "fedavg")
    world = options.pop("world", {})
    fields = {k: options.pop(k) for k in _SPEC_FIELDS if k in options}
    spec = _spec(mod, strategy, **options)
    return dataclasses.replace(
        spec, world=dataclasses.replace(spec.world, **world), **fields)


def _fields(mod, options):
    try:
        _make(mod, options).validate()
    except mod.SpecError as e:
        return e.issues
    return []


@pytest.mark.parametrize("name", sorted(ACCEPTED))
def test_spec_accepts_what_the_spmd_engine_runs(name):
    assert _fields(J, ACCEPTED[name]) == []
    assert _fields(T, ACCEPTED[name]) == []


@pytest.mark.parametrize("name", sorted(REFUSED_LIKE_JAX))
def test_spec_refuses_as_jax_does(name):
    options, field = REFUSED_LIKE_JAX[name]
    assert field in [i.field for i in _fields(J, options)]
    assert field in [i.field for i in _fields(T, options)]


@pytest.mark.parametrize("name", sorted(NOT_PORTED))
def test_spec_refuses_what_is_not_ported_naming_its_item(name):
    options, field, item = NOT_PORTED[name]
    issues = [i for i in _fields(T, options) if i.field == field]
    assert issues, name
    assert re.search(rf"ROADMAP\.md queue 1 item {item}\b", issues[0].hint)
