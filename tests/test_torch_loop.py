"""The port's per-client reference loop (``megastep=False``), its int8
wire compression with error feedback (``quantize_updates``) on both
execution paths, and a custom ``eval_fn``, against the JAX package: the
port's simulation on the CPU against the one ``repro.api.runner`` builds
and runs, record for record, from the JAX simulation's own initial
parameters; and the port's two paths against each other.

Tolerances: ``repro_torch.api.parity`` states them, with their reasons.
Records as in tests/test_torch_engine.py; error-feedback state after
round 0 within ``ef_mismatches`` (later rounds compound the rare code
flips, see parity.py); the port's loop against its megastep within
``path_mismatches``, the JAX package's own tolerances for that pair. The
quantized runs use seed 2: on seed 0 one θ ratio of the full-width case
lies 8.6e-5 from θ, inside the band where the decision is not
reproducible.
"""
import dataclasses

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import repro.api as J
from repro.api import runner as jrunner
from repro.models import api as japi

import repro_torch as T
from repro_torch.api import parity
from repro_torch.kernels import ops as tops
from repro_torch.models import api as tapi

CASES = {
    "smoke": dict(model="anomaly-mlp-smoke", n=1500, ev=300, clients=4,
                  rounds=3),
    "anomaly-mlp": dict(model="anomaly-mlp", n=1600, ev=400, clients=4,
                        rounds=2),
}


def _spec(mod, case, strategy, seed=0, quantize=False, **kw):
    c = CASES[case]
    return mod.ExperimentSpec(
        model=c["model"],
        data=mod.DataSpec(n_samples=c["n"], eval_samples=c["ev"], alpha=0.5),
        world=mod.WorldSpec(num_clients=c["clients"], dropout_p=0.1),
        comm=mod.CommModel(bandwidth=5e6, latency=0.5, t_sample=2e-3,
                           t_launch=0.25),
        strategy=strategy,
        strategy_kwargs=dict(batch_size=64, lr=3e-2, local_epochs=2,
                             quantize_updates=quantize),
        rounds=c["rounds"], seed=seed, **kw)


def _run_both(tspec, jspec, rounds=None):
    """(port simulation, JAX simulation), the port's from the JAX one's
    weights, each run for ``rounds`` (default: the spec's)."""
    jsim = jrunner.build_simulation(jspec.validate())
    p0 = japi.init_params(jax.random.PRNGKey(jspec.seed),
                          jspec.resolve_model())
    sim = T.build_simulation(tspec, device="cpu",
                             params={k: np.asarray(v) for k, v in p0.items()})
    jsim.run(rounds or jspec.rounds, eval_final=True)
    sim.run(rounds or tspec.rounds)
    return sim, jsim


def _assert_same_run(sim, jsim, tspec):
    close_calls = parity.theta_band_violations(sim.theta_ratios, 0.65)
    assert not close_calls, close_calls      # choose another seed
    got = T.result_from_simulation(tspec, sim).records
    want = [jrunner.record_from_metrics(m) for m in jsim.history]
    mismatches = parity.record_mismatches(got, want)
    assert not mismatches, mismatches
    assert {c: dataclasses.asdict(r) for c, r in sim.selector.records.items()} \
        == {c: dataclasses.asdict(r) for c, r in jsim.selector.records.items()}
    assert sim.failure_log == jsim.failure_log
    assert sim.server_step == jsim.server_step
    assert [l.batch_size for l in sim.loaders] == \
        [l.batch_size for l in jsim.loaders]


@pytest.mark.parametrize("strategy", ["fedavg", "ours"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_loop_matches_jax(case, strategy):
    tspec = _spec(T, case, strategy, megastep=False)
    sim, jsim = _run_both(tspec, _spec(J, case, strategy, megastep=False))
    _assert_same_run(sim, jsim, tspec)
    if strategy == "ours":
        assert sim.theta_ratios, "the θ filter never ran against a reference"
        assert sorted(sim.ref_sign) == sorted(jsim.ref_sign)


@pytest.mark.parametrize("megastep", [True, False], ids=["megastep", "loop"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_quantized_matches_jax(case, megastep):
    tspec = _spec(T, case, "ours", seed=2, quantize=True, megastep=megastep)
    sim, jsim = _run_both(tspec, _spec(J, case, "ours", seed=2,
                                       quantize=True, megastep=megastep),
                          rounds=1)
    assert sim._wire_bytes == jsim._wire_bytes == \
        sim._arena.rows * (1024 + 4)
    if megastep:
        # row N takes the padding rows' residuals; no result reads it
        assert sim._ef_arena.shape == tuple(jsim._ef_arena.shape)
        problems = parity.ef_mismatches(sim._ef_arena[:-1].numpy(),
                                        np.asarray(jsim._ef_arena)[:-1])
        assert not problems, problems
        assert sim._ef_arena[:-1].any()
    else:
        assert sorted(sim._ef_state) == sorted(jsim._ef_state)
        for cid, err in sim._ef_state.items():
            want = {k: torch.from_numpy(np.array(v))
                    for k, v in jsim._ef_state[cid].items()}
            assert sorted(err) == sorted(want)
            problems = parity.ef_mismatches(tops.flatten_to_lanes(err)[0],
                                            tops.flatten_to_lanes(want)[0])
            assert not problems, (cid, problems)
    jsim.run(tspec.rounds - 1, eval_final=True)
    sim.run(tspec.rounds - 1)
    _assert_same_run(sim, jsim, tspec)
    assert sim.theta_ratios


@pytest.mark.parametrize("megastep", [True, False], ids=["megastep", "loop"])
def test_custom_eval_fn_matches_jax(megastep):
    """eval_fn(params, eval_batch) replaces the accuracy: here minus the
    mean eval loss, in each package's own terms."""
    case = "smoke"
    jcfg = _spec(J, case, "ours").resolve_model()
    tcfg = _spec(T, case, "ours").resolve_model()
    tspec = _spec(T, case, "ours", megastep=megastep,
                  eval_fn=lambda p, b: -float(tapi.loss_fn(p, b, tcfg)))
    jspec = _spec(J, case, "ours", megastep=megastep,
                  eval_fn=lambda p, b: -float(japi.loss_fn(p, b, jcfg)))
    sim, jsim = _run_both(tspec, jspec)
    _assert_same_run(sim, jsim, tspec)
    assert all(-3.0 < m.accuracy < 0.0 for m in sim.history)
    assert sim.history[-1].accuracy == pytest.approx(
        -float(tapi.loss_fn(sim.params, sim._eval_dev, tcfg)))


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_loop_matches_megastep(case, quantize):
    p0 = tapi.init_params(torch.Generator().manual_seed(2),
                          _spec(T, case, "ours").resolve_model())
    records = {}
    for megastep in (True, False):
        spec = _spec(T, case, "ours", seed=2, quantize=quantize,
                     megastep=megastep)
        records[megastep] = T.run_experiment(spec, device="cpu",
                                             params=p0).records
    problems = parity.path_mismatches(records[False], records[True])
    assert not problems, problems
    assert any(r.updates_applied for r in records[True][1:])
