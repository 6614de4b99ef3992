"""World scale in the port against the JAX package: two-stage selection
(``selection.candidate_quota`` / ``candidate_mask_np``,
``control.candidate_mask`` / ``two_stage_select``), the single-device
population plane (``core/population.py``) and non-resident worlds
(``client_seed``, ``LazyPartition``, ``LoaderPool``, ``build_lazy_world``),
on numpy inputs made from a seed and on the loop, megastep, scanned and
spmd engines. Tied scores are the usual case (a fresh control state scores
every client the same), so every selection case runs with ties too."""
import dataclasses
import gc
import weakref

import numpy as np
import pytest
pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import torch

import repro.api as J
from repro.api import runner as jrunner
from repro.core import control as jctl
from repro.core import population as jpop
from repro.core import selection as jsel
from repro.data import loader as jloader
from repro.data import partition as jpart
from repro.models import api as japi

import repro_torch as T
from repro_torch.api import parity
from repro_torch.core import aggregation as tagg
from repro_torch.core import control as tctl
from repro_torch.core import population as tpop
from repro_torch.core import selection as tsel
from repro_torch.data import loader as tloader
from repro_torch.data import partition as tpart

from test_torch_scanned import JaxDraws
from test_torch_spmd import JaxSpmdDraws


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these cases run many tiny operations, and where
    several test workers share the machine, more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scores(n, kind, seed=1):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=n).astype(np.float32)
    if kind == "tied":                 # a handful of distinct values
        # (+ 0.0 turns -0.0 into 0.0: no score is -0.0, and lax.top_k
        # orders -0.0 below 0.0 where numpy and torch see a tie)
        s = np.round(s).astype(np.float32) + np.float32(0.0)
    elif kind == "fresh":              # every client the same
        s = np.full(n, 0.25, np.float32)
    elif kind == "neg-inf":            # churned clients masked out
        s[rng.random(n) < 0.3] = -np.inf
    return s


KINDS = ("normal", "tied", "fresh", "neg-inf")
# the JAX package's functions compiled once a shape (eager calls compile
# each operation anew, which dominates these cases' time)
_jax_mask = jax.jit(jctl.candidate_mask,
                    static_argnames=("k", "frac", "shards"))
_jax_select = jax.jit(jctl.two_stage_select,
                      static_argnames=("k", "candidate_frac",
                                       "candidate_shards", "epsilon"))
_jax_candidates = jax.jit(jpop.logical_candidates,
                          static_argnames=("k", "frac", "shards"))
_jax_topk = jax.jit(jpop.topk_from_candidates, static_argnames="k")
# tests/test_population.py's grids: the mask cases and the quota floor
MASK_GRID = [(10, 3, 0.5, 4), (16, 4, 0.25, 4), (16, 7, 0.1, 8),
             (33, 5, 0.3, 8), (64, 64, 0.02, 8),
             (10, 7, 0.01, 8), (12, 12, 0.01, 5), (9, 9, 0.01, 4)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,k,frac,shards", MASK_GRID)
def test_candidate_masks_match_jax(n, k, frac, shards, kind):
    s = _scores(n, kind)
    assert tsel.candidate_quota(n, k, frac, shards) == \
        jsel.candidate_quota(n, k, frac, shards)
    want = jsel.candidate_mask_np(s, k, frac, shards)
    np.testing.assert_array_equal(tsel.candidate_mask_np(s, k, frac, shards),
                                  want)
    np.testing.assert_array_equal(np.asarray(_jax_mask(
        jnp.asarray(s), k=k, frac=frac, shards=shards)), want)
    got = tctl.candidate_mask(torch.from_numpy(s), k, frac, shards)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("live", [False, True], ids=["all", "live"])
@pytest.mark.parametrize("epsilon", [0.0, 0.5])
def test_two_stage_select_matches_jax(kind, live, epsilon):
    n, k = 40, 6
    rng = np.random.default_rng(3)
    s = _scores(n, kind, seed=5)
    lv = rng.random(n) > 0.3 if live else None
    if lv is not None:
        s = np.where(lv, s, -np.inf).astype(np.float32)
    eps_u = rng.random(k).astype(np.float32)
    pick_u = rng.random(k).astype(np.float32)
    for frac, shards in ((None, 8), (0.25, 4), (0.5, 3), (1.0, 8)):
        want = _jax_select(
            jnp.asarray(s), k=k, candidate_frac=frac, candidate_shards=shards,
            epsilon=epsilon, eps_u=jnp.asarray(eps_u),
            pick_u=jnp.asarray(pick_u),
            live=None if lv is None else jnp.asarray(lv))
        got = tctl.two_stage_select(
            torch.from_numpy(s), k, candidate_frac=frac,
            candidate_shards=shards, epsilon=epsilon,
            eps_u=torch.from_numpy(eps_u), pick_u=torch.from_numpy(pick_u),
            live=None if lv is None else torch.from_numpy(lv))
        assert got.tolist() == np.asarray(want).tolist(), (frac, shards)
    single = tctl.select_topk_epsilon(torch.from_numpy(s), k)
    for shards in (1, 4, 8):
        assert tctl.two_stage_select(
            torch.from_numpy(s), k, candidate_frac=1.0,
            candidate_shards=shards).tolist() == single.tolist()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,shards", [(40, 8), (37, 8), (37, 5), (12, 1)])
def test_logical_candidates_and_topk_match_jax(n, shards, kind):
    s = _scores(n, kind, seed=n)
    for k, frac in ((4, 0.2), (6, 0.5), (min(n, 9), 1.0)):
        jv, ji = _jax_candidates(jnp.asarray(s), k=k, frac=frac,
                                 shards=shards)
        tv, ti = tpop.logical_candidates(torch.from_numpy(s), k, frac,
                                         shards)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert ti.tolist() == np.asarray(ji).tolist()
        want = _jax_topk(jv, ji, k=k)
        got = tpop.topk_from_candidates(tv, ti, k)
        assert got.tolist() == np.asarray(want).tolist()
        assert all(c < n for c in got.tolist())
    v = torch.tensor([1.0, 3.0, 3.0, 0.5, 3.0])
    i = torch.tensor([40, 7, 3, 1, 11])
    assert tpop.topk_from_candidates(v, i, 3).tolist() == [3, 7, 11]


# ---------------------------------------------------------------------------
# the population plane
# ---------------------------------------------------------------------------

def _state_arrays(n, seed):
    """fig3_scaling's seeded control statistics as numpy arrays."""
    rng = np.random.default_rng(seed)
    return dict(avail=rng.uniform(0.2, 1.0, n).astype(np.float32),
                pass_rate=rng.uniform(0.5, 1.0, n).astype(np.float32),
                round_time=rng.uniform(0.5, 2.0, n).astype(np.float32))


def _states(n, seed):
    a = _state_arrays(n, seed)
    j = jctl.init_control(n)._replace(**{f: jnp.asarray(v)
                                         for f, v in a.items()})
    t = tctl.init_control(n)._replace(**{f: torch.from_numpy(v)
                                         for f, v in a.items()})
    return j, t


def _obs(k, seed):
    rng = np.random.default_rng(seed)
    failed = rng.random(k) < 0.2
    active = ~failed
    return dict(failed=failed, active=active,
                passed=(rng.random(k) < 0.8) & active,
                round_time=rng.uniform(0.2, 3.0, k).astype(np.float32),
                sent=active,
                norms=rng.uniform(0.05, 2.5, k).astype(np.float32))


def _state_problems(got, want):
    """Integer and bool fields equal, floats within parity.EMA_RTOL."""
    return parity.population_mismatches(
        {f: getattr(got, f).numpy() for f in tpop._FIELDS},
        {f: np.asarray(getattr(want, f)) for f in tpop._FIELDS},
        tpop._FIELDS)


@pytest.mark.parametrize("n,shards", [(24, 4), (24, 1), (40, 8), (37, 8)])
def test_round_update_matches_jax_and_logical_equals_global(n, shards):
    jglob, tglob = _states(n, seed=11)
    tlog = tglob
    rng = np.random.default_rng(0)
    jround = jax.jit(jpop.round_update)
    k = 8
    for r in range(5):
        cohort = rng.choice(n, size=k, replace=False)
        if r == 2:                      # the first and the last client
            cohort = np.concatenate([cohort[:k - 2], [0, n - 1]])
        obs = _obs(k, seed=100 + r)
        jglob = jround(jglob, jnp.asarray(cohort.astype(np.int32)),
                       **{f: jnp.asarray(v) for f, v in obs.items()})
        tobs = {f: torch.from_numpy(v) for f, v in obs.items()}
        tc = torch.from_numpy(cohort.astype(np.int64))
        tglob = tpop.round_update(tglob, tc, **tobs)
        tlog = tpop.round_update_logical(tlog, tc, shards=shards, **tobs)
        assert not _state_problems(tglob, jglob), r
        for f in tpop._FIELDS:
            a, b = getattr(tlog, f), getattr(tglob, f)
            assert a.dtype == b.dtype and torch.equal(a, b), (f, r)
    jlog = jax.jit(jpop.round_update_logical, static_argnames="shards")(
        jglob, jnp.asarray(cohort.astype(np.int32)), shards=shards,
        **{f: jnp.asarray(v) for f, v in obs.items()})
    tlog = tpop.round_update_logical(tglob, tc, shards=shards, **tobs)
    assert not _state_problems(tlog, jlog)


class JaxPopulationDraws:
    """The JAX package's population-round observations of round r
    (core/population.py, ``build_population_round``)."""

    def __init__(self, seed, k):
        self.base, self.k = jax.random.PRNGKey(seed), k

    def round(self, r):
        kf, kp, kt, kn = jax.random.split(
            jax.random.fold_in(self.base, r), 4)
        failed = jax.random.bernoulli(kf, 0.05, (self.k,))
        passed = jax.random.bernoulli(kp, 0.9, (self.k,)) & ~failed
        rt = jax.random.uniform(kt, (self.k,), jnp.float32, 0.5, 1.5)
        norms = jax.random.uniform(kn, (self.k,), jnp.float32, 0.1, 2.0)
        return tuple(torch.from_numpy(np.array(a))
                     for a in (failed, passed, rt, norms))


@pytest.mark.parametrize("frac", [None, 0.25, 1.0])
def test_population_round_matches_jax(frac):
    n, k, seed = 48, 8, 3
    jfn = jax.jit(jpop.build_population_round(
        n, k, candidate_frac=frac, candidate_shards=4, seed=seed))
    tfn = tpop.build_population_round(n, k, candidate_frac=frac,
                                      candidate_shards=4,
                                      draws=JaxPopulationDraws(seed, k))
    jst, tst = _states(n, seed=21)
    for r in range(3):
        jst, jc = jfn(jst, jnp.int32(r))
        tst, tc = tfn(tst, r)
        assert tc.tolist() == np.asarray(jc).tolist(), r
        assert not _state_problems(tst, jst), r
    # over a mesh the round builds (tests/test_torch_population_mesh.py
    # runs it on four gloo ranks)
    assert callable(tpop.build_population_round(n, k, mesh=object()))


def test_population_draws_are_keyed_by_the_round():
    a = tpop.PopulationDraws(5, 16, "cpu")
    failed, passed, rt, norms = a.round(3)
    assert failed.dtype == torch.bool and passed.dtype == torch.bool
    assert rt.dtype == norms.dtype == torch.float32
    assert float(rt.min()) >= 0.5 and float(rt.max()) < 1.5
    assert float(norms.min()) >= 0.1 and float(norms.max()) < 2.0
    for x, y in zip(a.round(3), tpop.PopulationDraws(5, 16, "cpu").round(3)):
        assert torch.equal(x, y)
    assert not torch.equal(a.round(4)[2], rt)


# ---------------------------------------------------------------------------
# non-resident worlds
# ---------------------------------------------------------------------------

def test_client_seed_and_lazy_partition_match_jax():
    for s in range(3):
        for c in (0, 1, 63, 999_999):
            assert tpart.client_seed(s, c) == jpart.client_seed(s, c)
    tp, jp = tpart.LazyPartition(1_000_000, 256, 3), \
        jpart.LazyPartition(1_000_000, 256, 3)
    assert len(tp) == len(jp) == 1_000_000
    for c in (0, 42, 999_999):
        assert tp.shard(c) == jp.shard(c)
    with pytest.raises(IndexError):
        tp.shard(1_000_000)
    with pytest.raises(ValueError):
        tpart.LazyPartition(0, 256)


def _lazy_spec(mod, n=12, resident=False, rounds=2, **kw):
    return mod.ExperimentSpec(
        model="anomaly-mlp-smoke",
        data=mod.DataSpec(samples_per_client=96, eval_samples=64),
        world=mod.WorldSpec(num_clients=n, profile="heterogeneous",
                            resident=resident),
        rounds=rounds, seed=0, **kw)


def _same_arrays(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        x, y = np.asarray(a[key]), np.asarray(b[key])
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), key


def test_loader_pool_streams_evictions_and_state_match_jax():
    tw = _lazy_spec(T).validate().build_world()
    jw = _lazy_spec(J).validate().build_world()
    pools = [tloader.LoaderPool(tw.client_arrays, lambda c: 16, seed=5,
                                capacity=2),
             tloader.LoaderPool(tw.client_arrays, lambda c: 16, seed=5,
                                capacity=64),
             jloader.LoaderPool(jw.client_arrays, lambda c: 16, seed=5,
                                capacity=2)]
    for cid in [0, 1, 0, 2, 3, 4, 0, 1, 2]:     # evicts in the small pools
        small, big, ref = (p[cid].sample() for p in pools)
        _same_arrays(small, ref)
        _same_arrays(big, ref)
    assert pools[0].resident <= 2 and pools[2].resident <= 2
    state = pools[0].state_dict()
    assert state == pools[2].state_dict() and state["lazy"] is True
    fresh = tloader.LoaderPool(tw.client_arrays, lambda c: 16, seed=5,
                               capacity=2)
    fresh.load_state_dict(state)
    for cid in (0, 1, 2, 5):                     # 5 never sampled
        _same_arrays(fresh[cid].sample(), pools[0][cid].sample())


def test_lazy_world_matches_jax_pointwise_at_a_million_clients():
    """A few clients of a 1,000,000-client world, evaluated one by one:
    nothing population-sized but the profile arrays is built."""
    kw = dict(n=1_000_000)
    tw = dataclasses.replace(
        _lazy_spec(T, **kw), data=T.DataSpec(samples_per_client=256,
                                             eval_samples=64)).build_world()
    jw = dataclasses.replace(
        _lazy_spec(J, **kw), data=J.DataSpec(samples_per_client=256,
                                             eval_samples=64)).build_world()
    assert tw.lazy and tw.num_clients == 1_000_000
    for cid in (0, 1, 777_777, 999_999):
        _same_arrays(tw.client_arrays[cid], jw.client_arrays[cid])
        assert dataclasses.asdict(tw.profiles[cid]) == \
            dataclasses.asdict(jw.profiles[cid])
    _same_arrays(tw.eval_arrays, jw.eval_arrays)
    for f in ("speed", "net_latency", "dropout_p", "memory"):
        _same_arrays({f: tw.profiles.field(f)}, {f: jw.profiles.field(f)})
    assert len(tw.client_arrays._cache) <= tw.client_arrays.cache_size
    with pytest.raises(IndexError):
        tw.client_arrays[1_000_000]


SCALE_ISSUES = ("candidate_frac", "candidate_shards", "world.resident",
                "data.samples_per_client", "data.factory")
INVALID = {
    "frac-zero": dict(candidate_frac=0.0),
    "frac-above-one": dict(candidate_frac=1.5),
    "shards-zero": dict(candidate_shards=0),
    "no-samples": dict(data=dict(samples_per_client=None)),
    "samples-zero": dict(data=dict(samples_per_client=0)),
    "spmd": dict(engine="spmd"),
    "scanned": dict(rounds_per_dispatch=2),
    "factory": dict(data=dict(factory=lambda seed, n: None)),
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_spec_refuses_scale_options_as_jax_does(case):
    def issues(mod):
        opts = dict(INVALID[case])
        data = opts.pop("data", {})
        spec = _lazy_spec(mod, **opts)
        spec = dataclasses.replace(spec, data=dataclasses.replace(
            spec.data, **data))
        with pytest.raises(mod.SpecError) as err:
            spec.validate()
        return [(i.field, i.hint) for i in err.value.issues
                if i.field in SCALE_ISSUES]
    want = issues(J)
    assert want and issues(T) == want


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

PATHS = ("loop", "megastep", "scanned1", "scanned4", "spmd")


def _spec(mod, path, rounds=3, clients=6, seed=0, **fields):
    """A selecting smoke world on one path: ``ours`` picking half (int8 on
    the megastep and scanned paths), a synchronous selecting strategy on
    spmd (``tests/harness.base_spec``'s)."""
    if path == "spmd":
        strategy = mod.StrategyConfig(
            mode="sync", theta=0.6, selection=True, select_fraction=0.5,
            dynamic_batch=False, checkpointing=True, batch_size=32,
            max_samples_per_round=64)
        kw, fields["engine"] = {}, "spmd"
    else:
        strategy = "ours"
        kw = dict(batch_size=32, lr=3e-2, select_fraction=0.5,
                  dynamic_batch=False, quantize_updates=path != "loop")
        fields["megastep"] = path != "loop"
        if path.startswith("scanned"):
            fields.update(rounds_per_dispatch=int(path[-1]),
                          fused_eval=True)
    return mod.ExperimentSpec(
        model="anomaly-mlp-smoke",
        data=mod.DataSpec(n_samples=1600, eval_samples=300,
                          partition="iid"),
        world=mod.WorldSpec(num_clients=clients, dropout_p=0.1),
        comm=mod.CommModel(bandwidth=5e6, latency=0.5, t_sample=2e-3,
                           t_launch=0.25),
        strategy=strategy, strategy_kwargs=kw, rounds=rounds, seed=seed,
        **fields)


def _p0(jspec):
    return {k: np.asarray(v) for k, v in japi.init_params(
        jax.random.PRNGKey(jspec.seed), jspec.resolve_model()).items()}


def _run_port(spec, **kw):
    """(run object, records) of ``spec`` on the CPU."""
    if spec.engine == "spmd":
        drv = T.SpmdDriver(spec, device="cpu", **kw)
        return drv, drv.run_rounds(spec.rounds)
    sim = T.build_simulation(spec, device="cpu", **kw)
    sim.run(spec.rounds)
    return sim, T.result_from_simulation(spec, sim).records


@pytest.mark.parametrize("path", PATHS)
def test_frac_one_equals_single_stage(path):
    spec = _spec(T, path).validate()
    one = dataclasses.replace(spec, candidate_frac=1.0,
                              candidate_shards=3).validate()
    a, ra = _run_port(spec)
    b, rb = _run_port(one)
    assert ra == rb
    if path.startswith("scanned"):
        assert a.cohorts == b.cohorts and len(a.cohorts) == spec.rounds
    elif path != "spmd":
        assert a.failure_log == b.failure_log


def _run_jax_and_port(path, **kw):
    jspec = _spec(J, path, **kw).validate()
    tspec = _spec(T, path, **kw).validate()
    if path == "spmd":
        jdrv = jrunner.SpmdDriver(jspec)
        want = jdrv.run_rounds(jspec.rounds)
        n = tspec.world.num_clients
        k = jrunner._spmd_control_plane(
            jspec, jspec.resolve_strategy(), None).select_k
        tdrv, got = _run_port(tspec, params=_p0(jspec),
                              draws=JaxSpmdDraws(jspec.seed, n, k))
        return tdrv, got, jdrv, want, tspec
    jsim = jrunner.build_simulation(jspec)
    draws = (JaxDraws(jspec.seed, *jsim._scan_shapes())
             if path.startswith("scanned") else None)
    jsim.run(jspec.rounds, eval_final=True)
    want = [jrunner.record_from_metrics(m) for m in jsim.history]
    sim, got = _run_port(tspec, params=_p0(jspec), draws=draws)
    return sim, got, jsim, want, tspec


@pytest.mark.parametrize("path", PATHS)
def test_two_stage_engine_matches_jax(path):
    sim, got, jsim, want, _ = _run_jax_and_port(
        path, candidate_frac=0.5, candidate_shards=2)
    assert not parity.theta_band_violations(sim.theta_ratios, 0.65)
    if path.startswith("scanned"):
        assert not parity.scanned_mismatches(got, want)
        assert not parity.control_mismatches(
            {f: v.numpy() for f, v in sim._scan_ctl._asdict().items()},
            jsim._scan_ctl._asdict())
        return
    assert not parity.record_mismatches(got, want)
    if path == "spmd":
        assert not parity.control_mismatches(
            {f: v.numpy() for f, v in sim.state.control._asdict().items()},
            jsim.state.control._asdict())
        return
    assert {c: dataclasses.asdict(r) for c, r in sim.selector.records.items()} \
        == {c: dataclasses.asdict(r) for c, r in jsim.selector.records.items()}
    assert sim.failure_log == jsim.failure_log


def test_lazy_loop_matches_lazy_megastep():
    """The JAX package's own contract (tests/test_population.py)."""
    spec = dataclasses.replace(_lazy_spec(T, n=6, candidate_frac=0.5,
                                          candidate_shards=2),
                               strategy_kwargs=dict(select_fraction=0.5))
    loop = T.run_experiment(dataclasses.replace(spec, megastep=False),
                            device="cpu")
    mega = T.run_experiment(spec, device="cpu")
    assert not parity.path_mismatches(loop.records, mega.records)


def test_lazy_megastep_matches_jax():
    jspec = _lazy_spec(J, n=12, strategy_kwargs=dict(
        select_fraction=0.5, quantize_updates=True), rounds=3,
        candidate_frac=0.5, candidate_shards=4).validate()
    tspec = _lazy_spec(T, n=12, strategy_kwargs=dict(
        select_fraction=0.5, quantize_updates=True), rounds=3,
        candidate_frac=0.5, candidate_shards=4).validate()
    jsim = jrunner.build_simulation(jspec)
    jsim.run(jspec.rounds, eval_final=True)
    sim, got = _run_port(tspec, params=_p0(jspec))
    assert sim.loaders.lazy and sim.loaders.resident <= \
        sim.loaders.capacity == 64
    assert not parity.theta_band_violations(sim.theta_ratios, 0.65)
    assert not parity.record_mismatches(
        got, [jrunner.record_from_metrics(m) for m in jsim.history])
    assert sim.failure_log == jsim.failure_log
    assert sim.loaders.state_dict() == jsim.loaders.state_dict()
    with pytest.raises(RuntimeError, match="resident"):
        sim._scan_setup()


def test_a_lazy_simulation_dies_with_its_last_reference():
    """No reference cycle keeps a finished lazy simulation, and its error-
    feedback arena, alive until the cycle collector runs: its LoaderPool's
    batch-size function does not refer back to it."""
    spec = _lazy_spec(T, n=12, strategy_kwargs=dict(
        select_fraction=0.5, quantize_updates=True), candidate_frac=0.5,
        candidate_shards=2).validate()
    enabled = gc.isenabled()
    gc.disable()
    try:
        sim = T.build_simulation(spec, device="cpu")
        sim.run(spec.rounds)
        assert sim.loaders.lazy and sim._ef_arena is not None
        gone, arena = weakref.ref(sim), weakref.ref(sim._ef_arena)
        del sim
        assert gone() is None and arena() is None
    finally:
        if enabled:
            gc.enable()


def test_alpha_table_is_sized_by_the_cohort():
    """τ < the round's arrival count <= the cohort size K: the (K + 1)-
    entry table equals the (N + 1)-entry one's prefix by bits."""
    for alpha0 in (0.5, 1.0):
        full = tagg.staleness_weights_np(np.arange(100_001), alpha0)
        for k in (1, 64, 2_000):
            short = tagg.staleness_weights_np(np.arange(k + 1), alpha0)
            assert short.tobytes() == full[:k + 1].tobytes()
    spec = _spec(T, "megastep").validate()
    sim = T.build_simulation(spec, device="cpu")
    assert len(sim._alpha_table) == 3 + 1
    spec = dataclasses.replace(spec, strategy_kwargs=dict(
        spec.strategy_kwargs, select_fraction=1.0))
    assert len(T.build_simulation(spec, device="cpu")._alpha_table) == 6 + 1
