"""The port's ``run_sweep`` (api/sweep.py), ``api/stats.py`` and AUC-ROC
against the JAX package's: the Mann-Whitney U test and summaries equal to
JAX's on the same samples and to scipy's asymptotic p; seed groups run as
one seed-stacked spmd state equal to serial runs; dotted axes, filters,
up-front validation; and ``mlp_detector.auc_roc`` (ordinal ranks from a
stable sort, as the JAX package's code) on tied and untied scores, after
``tests/test_sweep.py``."""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.api as J
from repro.api import stats as jstats
from repro.models import api as japi
from repro.models import mlp_detector as jmlp

import repro_torch as T
from repro_torch.api import stats
from repro_torch.models import mlp_detector as tmlp


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
                rounds=3, seed=0)


def _degenerate(mod, bs=32, **kw):
    return mod.StrategyConfig(mode="sync", theta=None, selection=False,
                              dynamic_batch=False, checkpointing=False,
                              batch_size=bs, lr=3e-2, local_epochs=1,
                              max_samples_per_round=2 * bs, **kw)


def _spmd_spec(**kw):
    base = dict(_small(T), engine="spmd", strategy=_degenerate(T),
                world=T.WorldSpec(num_clients=4, profile="heterogeneous"))
    return T.ExperimentSpec(**{**base, **kw})


# ---------------------------------------------------------------------------
# stats: the JAX package's numbers, scipy's asymptotic p
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alt", ["two-sided", "greater", "less"])
def test_mann_whitney_matches_jax_and_scipy(alt):
    scipy_stats = pytest.importorskip("scipy.stats")
    rng = np.random.default_rng(0)
    for _ in range(25):
        n1, n2 = rng.integers(3, 16, 2)
        a = rng.normal(0.0, 1.0, n1).round(1)      # rounding forces ties
        b = rng.normal(0.3, 1.0, n2).round(1)
        ours = T.mann_whitney_u(a, b, alternative=alt)
        assert dataclasses.asdict(ours) == dataclasses.asdict(
            jstats.mann_whitney_u(a, b, alternative=alt))
        ref = scipy_stats.mannwhitneyu(a, b, alternative=alt,
                                       method="asymptotic")
        np.testing.assert_allclose(ours.u, ref.statistic, atol=1e-12)
        np.testing.assert_allclose(ours.p_value, ref.pvalue, atol=1e-12)


def test_mann_whitney_direction_and_validation():
    lo, hi = [0.1, 0.2, 0.3, 0.25, 0.15], [0.8, 0.9, 0.85, 0.95, 0.7]
    assert T.mann_whitney_u(hi, lo, "greater").significant(0.05)
    assert not T.mann_whitney_u(lo, hi, "greater").significant(0.05)
    with pytest.raises(ValueError, match="alternative"):
        T.mann_whitney_u(lo, hi, "sideways")
    with pytest.raises(ValueError, match="samples"):
        T.mann_whitney_u([], hi)


def test_ranks_medians_and_summaries_match_jax():
    x = [10.0, 20.0, 20.0, 30.0]
    np.testing.assert_array_equal(stats.rankdata(x), jstats.rankdata(x))
    np.testing.assert_allclose(stats.rankdata(x), [1.0, 2.5, 2.5, 4.0])
    assert T.median_iqr(range(1, 10)) == (5.0, 3.0, 7.0) == \
        jstats.median_iqr(range(1, 10))
    groups = {"a": [0.1, 0.4, 0.3], "b": [0.9, 0.2]}
    assert stats.summarize(groups) == jstats.summarize(groups)


# ---------------------------------------------------------------------------
# AUC-ROC: ordinal ranks, as the JAX package's code computes them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_auc_roc_matches_jax(tied):
    rng = np.random.default_rng(1)
    for n in (2, 17, 300):
        s = rng.random(n).astype(np.float32)
        if tied:                     # a handful of distinct scores
            s = (np.round(s * 4) / 4).astype(np.float32)
        y = (rng.random(n) < 0.4).astype(np.float32)
        got = tmlp.auc_roc(torch.from_numpy(s), torch.from_numpy(y))
        want = jmlp.auc_roc(jnp.asarray(s), jnp.asarray(y))
        assert got.dtype == torch.float32
        assert float(got) == float(want)


def test_result_auc_roc_matches_jax():
    """``ExperimentResult.auc_roc`` on the same parameters and eval split:
    the softmax and the rank statistic within f32 rounding of JAX's."""
    jspec = J.ExperimentSpec(**_small(J),
                             world=J.WorldSpec(num_clients=4))
    cfg = jspec.resolve_model()
    p0 = {k: np.asarray(v) for k, v in japi.init_params(
        jax.random.PRNGKey(0), cfg).items()}
    ev = jspec.build_world().eval_arrays
    want = J.ExperimentResult(engine="sim", strategy="ours", rounds=0,
                              seed=0, records=[], cfg=cfg, params=p0,
                              eval_arrays=ev).auc_roc()
    got = T.ExperimentResult(
        engine="sim", strategy="ours", rounds=0, seed=0, records=[],
        cfg=cfg, params=T.params_from_jax(p0, "cpu"),
        eval_arrays=ev).auc_roc()
    assert 0.0 <= got <= 1.0
    assert abs(got - want) < 1e-3
    probs = tmlp.predict(T.params_from_jax(p0, "cpu"),
                         torch.from_numpy(ev["x"]), cfg)
    np.testing.assert_allclose(
        probs.numpy(), np.asarray(jmlp.predict(p0, ev["x"], cfg)),
        rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# run_sweep
# ---------------------------------------------------------------------------

def test_seed_group_equals_serial_runs():
    """A seed group runs as one seed-stacked spmd state; each seed's
    records and parameters equal its serial session-backed run."""
    sweep = T.run_sweep(_spmd_spec(), axes={"seed": [0, 1, 2]},
                        device="cpu")
    assert sweep.vectorized_groups == 1
    assert all(p.vectorized for p in sweep.points)
    serial = T.run_sweep(_spmd_spec(), axes={"seed": [0, 1, 2]},
                         vectorize=False, device="cpu")
    assert serial.vectorized_groups == 0
    for p, q in zip(sweep.points, serial.points):
        assert p.result.seed == q.result.seed == p.overrides["seed"]
        assert p.result.records == q.result.records
        for k in p.result.params:
            assert torch.equal(p.result.params[k], q.result.params[k])


def test_sweep_ours_vs_fedavg_has_a_p_value():
    """The paper's shape: seeds of ``ours`` against ``fedavg`` on the sim
    engine, a Mann-Whitney p and the comparison report."""
    spec = T.ExperimentSpec(**{**_small(T), "rounds": 2}, strategy="ours",
                            strategy_kwargs=dict(batch_size=32),
                            world=T.WorldSpec(num_clients=4,
                                              profile="heterogeneous"))
    seen = []
    sweep = T.run_sweep(spec, axes={"strategy": ["ours", "fedavg"],
                                    "seed": range(3)},
                        progress=seen.append, device="cpu")
    assert len(sweep.points) == 6 and len(seen) == 6
    r = sweep.compare("strategy", "ours", "fedavg", metric="accuracy",
                      alternative="greater")
    assert r.n_a == r.n_b == 3 and 0.0 <= r.p_value <= 1.0
    report = sweep.report("accuracy", baseline="fedavg")
    assert "strategy=ours" in report and "p_vs_fedavg" in report
    assert len(sweep.values("bytes_sent", strategy="ours")) == 3
    auc = sweep.values("auc", strategy="fedavg")
    assert auc.shape == (3,) and np.all((auc >= 0) & (auc <= 1))
    rows = sweep.summary("loss")
    assert [row[0] for row in rows] == ["strategy=ours", "strategy=fedavg"]
    assert sweep.groups()["strategy=ours"].shape == (3,)


def test_sweep_dotted_axes_and_filter():
    spec = T.ExperimentSpec(**_small(T), strategy=_degenerate(T),
                            world=T.WorldSpec(num_clients=4,
                                              profile="uniform"))
    sweep = T.run_sweep(spec, axes={"data.alpha": [0.1, 1.0],
                                    "strategy_kwargs.lr": [0.01],
                                    "seed": [0, 1]}, device="cpu")
    assert len(sweep.points) == 4
    pts = sweep.filter(**{"data.alpha": 0.1})
    assert len(pts) == 2
    assert all(p.spec.data.alpha == 0.1 for p in pts)
    assert all(p.spec.strategy_kwargs == {"lr": 0.01} for p in pts)
    built = T.api.sweep.build_point_spec(spec, {"world.num_clients": 6})
    assert built.world.num_clients == 6 and spec.world.num_clients == 4


def test_sweep_validates_points_up_front():
    with pytest.raises(T.SpecError):
        T.run_sweep(_spmd_spec(), axes={"engine": ["sim", "ray"],
                                        "seed": [0]}, device="cpu")


def test_sweep_requires_axes():
    with pytest.raises(ValueError, match="axes"):
        T.run_sweep(_spmd_spec(), axes={}, device="cpu")


def test_sweep_vectorize_true_raises_where_seeds_cannot_batch():
    spec = _spmd_spec(strategy=dataclasses.replace(
        _degenerate(T), selection=True, select_fraction=0.5))
    assert not T.seed_vectorizable(spec)
    with pytest.raises(ValueError, match="seed batch"):
        T.run_sweep(spec, axes={"seed": [0, 1]}, vectorize=True,
                    device="cpu")


def test_presets_and_the_baselines_shim():
    from repro.api import PRESETS as JPRESETS
    from repro_torch.core import baselines
    assert sorted(T.PRESETS) == sorted(JPRESETS)
    assert baselines.PRESETS is T.PRESETS
    for name, factory in T.PRESETS.items():
        assert dataclasses.asdict(factory(batch_size=32)) == \
            dataclasses.asdict(JPRESETS[name](batch_size=32))
        assert getattr(baselines, name) is factory
