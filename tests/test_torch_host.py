"""The port's numpy host layer against the JAX package's: the copies must
give byte-identical outputs (same Generator draws in the same order), and
the α staleness table must equal the one the JAX package computes in XLA
f32."""
import dataclasses

import numpy as np
import pytest
pytest.importorskip("torch")

from repro.core import aggregation as jagg
from repro.core import async_engine as jae
from repro.core import batchsize as jbs
from repro.core import checkpoint_policy as jck
from repro.core import scenario as jscn
from repro.core import schedule as jsched
from repro.core import selection as jsel
from repro.data import loader as jloader
from repro.data import partition as jpart
from repro.data import synthetic as jsyn

from repro_torch.core import aggregation as tagg
from repro_torch.core import async_engine as tae
from repro_torch.core import batchsize as tbs
from repro_torch.core import checkpoint_policy as tck
from repro_torch.core import scenario as tscn
from repro_torch.core import schedule as tsched
from repro_torch.core import selection as tsel
from repro_torch.data import loader as tloader
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_datasets_are_byte_identical(seed):
    for args in [(seed, 500), (seed, 300, 16, 4)]:
        for a, b in zip(jsyn.make_unsw_like(*args), tsyn.make_unsw_like(*args)):
            _same(a, b)
    for a, b in zip(jsyn.make_road_like(seed, 200, window=32),
                    tsyn.make_road_like(seed, 200, window=32)):
        _same(a, b)


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_lm_tokens_are_byte_identical(seed):
    for args in [(seed, 6, 33, 512), (seed, 2, 128, 151936)]:
        for a, b in zip(jsyn.make_lm_tokens(*args),
                        tsyn.make_lm_tokens(*args)):
            _same(a, b)


@pytest.mark.parametrize("alpha", [0.1, 0.5, 5.0])
def test_partitions_are_byte_identical(alpha):
    _, y = jsyn.make_unsw_like(0, 2000)
    for a, b in zip(jpart.dirichlet_partition(y, 10, alpha=alpha, seed=3),
                    tpart.dirichlet_partition(y, 10, alpha=alpha, seed=3)):
        _same(a, b)
    for a, b in zip(jpart.iid_partition(2000, 7, seed=3),
                    tpart.iid_partition(2000, 7, seed=3)):
        _same(a, b)


def test_loader_draws_are_byte_identical():
    x, y = jsyn.make_unsw_like(1, 300)
    arrays = {"x": x, "y": y}
    jl, tl = jloader.ArrayLoader(arrays, 64, seed=5), \
        tloader.ArrayLoader(arrays, 64, seed=5)
    for bs in (64, 17, 1000):
        jl.set_batch_size(bs)
        tl.set_batch_size(bs)
        assert jl.batch_size == tl.batch_size
        for _ in range(3):
            ja, ta = jl.sample(), tl.sample()
            for k in arrays:
                _same(ja[k], ta[k])
        for ja, ta in zip(jl.epoch(), tl.epoch()):
            for k in arrays:
                _same(ja[k], ta[k])


def test_selector_draws_are_identical():
    js, ts = jsel.AdaptiveClientSelector(12, seed=4), \
        tsel.AdaptiveClientSelector(12, seed=4)
    rng = np.random.default_rng(0)
    for _ in range(20):
        for c in range(12):
            kw = dict(delivered=bool(rng.random() < 0.8),
                      passed=bool(rng.random() < 0.6),
                      round_time=float(rng.uniform(0.1, 5.0)))
            js.observe(c, **kw)
            ts.observe(c, **kw)
        assert js.select(5) == ts.select(5)
        assert [js.score(c) for c in range(12)] == \
            [ts.score(c) for c in range(12)]


def test_batch_controller_is_identical():
    jc, tc = jbs.BatchSizeController(), tbs.BatchSizeController()
    rng = np.random.default_rng(1)
    for cid in range(8):
        m = dict(compute=float(rng.lognormal(0, 0.6)),
                 memory=float(rng.uniform(0.4, 1)),
                 latency=float(rng.uniform(0.01, 0.2)))
        assert jc.initial(cid, jbs.ClientMetrics(**m)) == \
            tc.initial(cid, tbs.ClientMetrics(**m))
    for _ in range(6):
        times = {c: float(rng.uniform(0.5, 8.0)) for c in range(8)}
        assert jc.feedback(times) == tc.feedback(times)


def test_weibull_fit_and_interval_are_identical():
    rng = np.random.default_rng(2)
    for shape in (0.7, 1.5, 3.0):
        gaps = rng.weibull(shape, size=25) * 4.0
        jfit, tfit = jck.fit_weibull(gaps), tck.fit_weibull(gaps)
        assert jfit == tfit
        assert jck.optimal_interval(50.0, 0.2, *jfit) == \
            tck.optimal_interval(50.0, 0.2, *tfit)
    assert jck.fit_weibull([]) == tck.fit_weibull([])
    assert jck.fit_weibull([3.0]) == tck.fit_weibull([3.0])


def test_schedule_spec_is_identical():
    st = jae.StrategyConfig(mode="async", quorum=0.3, alpha0=0.6)
    tst = tae.StrategyConfig(mode="async", quorum=0.3, alpha0=0.6)
    assert dataclasses.asdict(jsched.ScheduleSpec.from_strategy(st)) == \
        dataclasses.asdict(tsched.ScheduleSpec.from_strategy(tst))
    for kind in ("sync", "semi-async", "bogus"):
        assert dataclasses.asdict(jsched.resolve_schedule(kind, st)) == \
            dataclasses.asdict(tsched.resolve_schedule(kind, tst))
        assert jsched.resolve_schedule(kind, st).issues() == \
            tsched.resolve_schedule(kind, tst).issues()


@pytest.mark.parametrize("alpha0", [0.5, 0.6, 0.9, 1.0])
def test_alpha_table_equals_xla_f32(alpha0):
    """Bit-equal for every τ < 2^20, where XLA's f32 power is one ulp off
    the correctly rounded value at 631 τ; the port refuses τ beyond, which
    only a cohort of 2^20 or more clients reaches (τ < the cohort size)."""
    taus = np.arange(1 << 20)
    _same(jagg.staleness_weights_np(taus, alpha0),
          tagg.staleness_weights_np(taus, alpha0))
    for bad in ([1 << 20], [-1], [2.0]):
        with pytest.raises(ValueError, match="cohort size"):
            tagg.staleness_weights_np(np.asarray(bad), alpha0)


def test_profile_factories_are_identical():
    for kw in (dict(seed=1), dict(seed=9, dropout_p=0.1, speed_sigma=1.0)):
        ja = jae.heterogeneous_profile_arrays(11, **kw)
        ta = tae.heterogeneous_profile_arrays(11, **kw)
        for k in ja:
            _same(ja[k], ta[k])
        assert [dataclasses.asdict(p) for p in
                jae.heterogeneous_profiles(11, **kw)] == \
            [dataclasses.asdict(p) for p in
             tae.heterogeneous_profiles(11, **kw)]
    assert [dataclasses.asdict(p) for p in jae.uniform_profiles(4, 0.2)] == \
        [dataclasses.asdict(p) for p in tae.uniform_profiles(4, 0.2)]
    for k, v in jae.uniform_profile_arrays(4, 0.2).items():
        _same(v, tae.uniform_profile_arrays(4, 0.2)[k])
    for n, bs in [(10, 64), (4000, 64), (2000, 256), (50, 1024)]:
        for st in (dict(), dict(local_epochs=2, max_samples_per_round=512)):
            assert jae.local_step_count(n, bs, jae.StrategyConfig(**st)) == \
                tae.local_step_count(n, bs, tae.StrategyConfig(**st))


@pytest.mark.parametrize("seed", [0, 5])
def test_drift_directions_are_byte_identical(seed):
    for classes, features in ((10, 49), (2, 16)):
        _same(jscn.drift_directions(jscn.DriftSpec(seed=seed), classes,
                                    features),
              tscn.drift_directions(tscn.DriftSpec(seed=seed), classes,
                                    features))


def test_topology_copies_are_the_reference_sources():
    """``topology/spec.py`` is a byte-identical copy; ``tree.py`` and
    ``comm.py`` differ only in their import of ``spec``."""
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1] / "src"
    ref, port = root / "repro" / "topology", root / "repro_torch" / "topology"
    assert (port / "spec.py").read_bytes() == (ref / "spec.py").read_bytes()
    for name in ("tree.py", "comm.py"):
        got = (port / name).read_text().splitlines()
        want = (ref / name).read_text().splitlines()
        assert len(got) == len(want)
        differ = [(g, w) for g, w in zip(got, want) if g != w]
        assert differ == [("from repro_torch.topology.spec import "
                           "TopologySpec",
                           "from repro.topology.spec import TopologySpec")]


def test_population_copies_are_identical():
    """The copies of ``selection.candidate_quota`` / ``candidate_mask_np``,
    ``partition.client_seed`` / ``LazyPartition``, ``loader.LoaderPool``
    and ``async_engine.ProfileView`` give the reference's outputs."""
    rng = np.random.default_rng(6)
    for n, k, frac, shards in [(10, 3, 0.5, 4), (33, 5, 0.3, 8),
                               (9, 9, 0.01, 4), (1000, 64, 0.02, 8)]:
        s = np.round(rng.normal(size=n), 1).astype(np.float32) + 0.0
        assert tsel.candidate_quota(n, k, frac, shards) == \
            jsel.candidate_quota(n, k, frac, shards)
        _same(tsel.candidate_mask_np(s, k, frac, shards),
              jsel.candidate_mask_np(s, k, frac, shards))
    for seed, cid in [(0, 0), (0, 5), (5, 0), (3, 999_999)]:
        assert tpart.client_seed(seed, cid) == jpart.client_seed(seed, cid)
        assert tpart.LazyPartition(1_000_000, 256, seed).shard(cid) == \
            jpart.LazyPartition(1_000_000, 256, seed).shard(cid)
    data = [dict(zip(("x", "y"), jsyn.make_unsw_like(c, 40)))
            for c in range(5)]
    pools = [mod.LoaderPool(data, lambda c: 8 + c, seed=2, capacity=2)
             for mod in (tloader, jloader)]
    for cid in (0, 1, 2, 0, 3, 4, 1):
        for a, b in zip(*(p[cid].sample().values() for p in pools)):
            _same(a, b)
    assert pools[0].state_dict() == pools[1].state_dict()
    arrays = jae.heterogeneous_profile_arrays(7, seed=2, dropout_p=0.1)
    assert [dataclasses.asdict(p) for p in tae.ProfileView(arrays)[:]] == \
        [dataclasses.asdict(p) for p in jae.ProfileView(arrays)[:]]


def test_numpy_only_copies_are_the_reference_sources():
    """``api/stats.py`` (Mann-Whitney U, rank and median summaries) is a
    byte-identical copy; ``faults.py`` (the seeded fault injector, with
    its own ambient injector) differs only in its docstring's first line,
    which names the port's module."""
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1] / "src"
    port, ref = root / "repro_torch", root / "repro"
    assert (port / "api" / "stats.py").read_bytes() == \
        (ref / "api" / "stats.py").read_bytes()
    got = (port / "faults.py").read_text().splitlines()
    want = (ref / "faults.py").read_text().splitlines()
    assert len(got) == len(want) and got[1:] == want[1:]
    assert got[0] == ('"""repro_torch.faults — seeded, deterministic fault '
                      'injection.')


def test_serve_health_is_the_reference_source():
    """``serve/health.py`` is the reference's source once its one import
    of the session module names the port's package."""
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1] / "src"
    want = (root / "repro" / "serve" / "health.py").read_text()
    got = (root / "repro_torch" / "serve" / "health.py").read_text()
    old = "        from repro.api import session as session_mod\n"
    assert want.count(old) == 1
    assert got == want.replace(
        old, "        from repro_torch.api import session as session_mod\n")


def test_fault_injector_copy_draws_the_reference_schedule():
    """The copied injector fires at the same calls as the reference's for
    the same spec, and the two ambient injectors are separate."""
    from repro import faults as jfaults
    from repro_torch import faults as tfaults
    spec = dict(seed=3, ckpt_write_p=0.4, scorer_p=0.7, at={"publish": (1,)})
    tinj = tfaults.FaultInjector(tfaults.FaultSpec(**spec))
    jinj = jfaults.FaultInjector(jfaults.FaultSpec(**spec))
    for site in ("ckpt_write", "scorer", "publish") * 6:
        assert tinj.poll(site) == jinj.poll(site)
    assert tinj.counts() == jinj.counts()
    with jinj.scoped():
        assert tfaults.active() is None
        tfaults.check_active("ckpt_write")      # the port's: no-op
