"""The port's hierarchical topologies (repro_torch/topology,
core/hierarchy.py) against the JAX package's, and on the engines.

Module parity: spec, tree and link pricing equal (presets, ``issues()``,
pod counts, child masks, links, ``leaf_pods`` at a million ids); the
grouped plain sign count equal to the JAX package's ``vmap`` of
``cohort_alignment`` over parents; ``TopologyRuntime.step`` on the same
numpy deltas, weights and pods for several rounds held to the JAX
package's by ``parity.topology_problems`` (summaries equal, no θ test
within THETA_BAND of θ, accumulators within TOPO_ACCUM_RTOL of
Σ_c|w_c·u_c|, reference signs equal outside the rounding band of |agg|,
both bounds from a float64 replay of the same inputs);
``maybe_pod_sync`` against the JAX package's at sync_every 1 and 4.

Engine cells at ``anomaly-mlp-smoke`` size, 4 rounds: on the loop, the
megastep, the scanned path at R = 1 and 4 and spmd, the records with a
topology equal by bits to the same run without it; with a θ-free tree
every path's summary is the same; the port's summary equals the JAX
package's on the same spec (megastep and spmd, a θ tree).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import repro.api as J
from repro import topology as jtopo
from repro.api import runner as jrunner
from repro.core import alignment as jalign
from repro.core import async_engine as jae
from repro.core import hierarchy as jhier
from repro.kernels.arena import ParamArena as JArena
from repro.models import api as japi

import repro_torch as T
from repro_torch import topology as ttopo
from repro_torch.api import parity
from repro_torch.convert import topology_from_jax
from repro_torch.core import async_engine as tae
from repro_torch.core import hierarchy as thier
from repro_torch.kernels import arena as tarena
from repro_torch.kernels import ref as tref

from test_torch_spmd import JaxSpmdDraws

LANE = 1024


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these cases run many tiny operations, and where
    several test workers share the machine, more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiers(mod, *tiers, seed=0):
    """A TopologySpec of ``mod`` from (name, fanout, sync_every, theta)."""
    return mod.TopologySpec(tiers=tuple(
        mod.TierSpec(name, fanout=f, sync_every=s, theta=th)
        for name, f, s, th in tiers), assignment_seed=seed)


# (name, fanout, sync_every, theta) trees: a padded region tier (4 edge
# pods of 3 clients into 2 regions of 3 slots), with and without θ
PADDED = (("edge", 3, 1, None), ("region", 3, 2, None), ("global", None, 4,
                                                         None))
PADDED_THETA = (("edge", 3, 1, None), ("region", 3, 2, 0.65),
                ("global", None, 4, 0.65))
EVERY_ROUND = (("pod", 4, 1, None), ("global", None, 1, 0.65))
FALLBACK = (("edge", 3, 1, None), ("region", 3, 1, 0.65),
            ("global", None, 1, 0.65))   # its direction turns every round
BAD = {
    "no-fanout": (("a", None, 1, None), ("b", None, 2, None)),
    "leaf-cadence": (("a", 2, 2, None), ("b", None, 4, None)),
    "nested": (("a", 2, 1, None), ("b", 2, 3, None), ("c", None, 4, None)),
    "names": (("a", 2, 1, None), ("a", None, 2, None)),
    "theta": (("a", 2, 1, None), ("b", None, 2, 1.5)),
    "fanout": (("a", 0, 1, None), ("b", None, 2, None)),
}


# ---------------------------------------------------------------------------
# spec, tree, links
# ---------------------------------------------------------------------------

def test_spec_matches_jax():
    for name in jtopo.TOPOLOGY_PRESETS:
        assert dataclasses.asdict(ttopo.TOPOLOGY_PRESETS[name]) == \
            dataclasses.asdict(jtopo.TOPOLOGY_PRESETS[name])
        assert ttopo.TOPOLOGY_PRESETS[name].issues() == \
            jtopo.TOPOLOGY_PRESETS[name].issues() == []
    for tiers in list(BAD.values()) + [PADDED_THETA, EVERY_ROUND]:
        got, want = _tiers(ttopo, *tiers), _tiers(jtopo, *tiers)
        assert got.issues() == want.issues()
        assert got.active() == want.active()
    assert ttopo.resolve_topology(None) is None
    assert ttopo.resolve_topology(ttopo.TopologySpec()) is None
    assert ttopo.resolve_topology(_tiers(ttopo, ("a", 2, 1, None))) is None
    for bad, err in (("no-such-preset", ValueError), (42, TypeError)):
        with pytest.raises(err):
            ttopo.resolve_topology(bad)
        with pytest.raises(err):
            jtopo.resolve_topology(bad)


@pytest.mark.parametrize("n", [1, 10, 25, 64, 1000])
def test_tree_and_links_match_jax(n):
    trees = [(ttopo.TOPOLOGY_PRESETS[k], jtopo.TOPOLOGY_PRESETS[k])
             for k in sorted(jtopo.TOPOLOGY_PRESETS)]
    trees += [(_tiers(ttopo, *t, seed=3), _tiers(jtopo, *t, seed=3))
              for t in (PADDED_THETA, EVERY_ROUND)]
    comm = (tae.CommModel(bandwidth=5e6, latency=0.5),
            jae.CommModel(bandwidth=5e6, latency=0.5))
    for tspec, jspec in trees:
        got, want = ttopo.build_tree(tspec, n), jtopo.build_tree(jspec, n)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for b in range(want.num_boundaries):
            assert np.array_equal(ttopo.child_valid(got, b),
                                  jtopo.child_valid(want, b))
        for c in (None,) + comm:
            assert ttopo.boundary_links(tspec, c, 54_602) == tuple(
                ttopo.TierLink(**dataclasses.asdict(link)) for link in
                jtopo.boundary_links(jspec, c, 54_602))
    assert ttopo.flat_star_bytes(n, 54_602, 16) == \
        jtopo.flat_star_bytes(n, 54_602, 16)


def test_leaf_pods_match_jax_pointwise_at_1m():
    n = 1_000_000
    spec = "edge-region-global"
    got = ttopo.build_tree(ttopo.TOPOLOGY_PRESETS[spec], n)
    want = jtopo.build_tree(jtopo.TOPOLOGY_PRESETS[spec], n)
    ids = np.concatenate([np.arange(0, n, 997), [n - 1]]).astype(np.int64)
    pods = ttopo.leaf_pods(got, ids)
    assert pods.dtype == np.int32
    assert np.array_equal(pods, jtopo.leaf_pods(want, ids))
    for c in ids[::101]:
        assert ttopo.leaf_pods(got, c) == jtopo.leaf_pods(want, c)
    assert pods.min() >= 0 and pods.max() < got.pods[0]


# ---------------------------------------------------------------------------
# the grouped sign count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P,group", [(1, 4), (2, 1), (2, 4), (3, 2)])
def test_grouped_sign_count_matches_jax_vmap(P, group):
    """Client c against reference c // group: the port's plain version
    against ``vmap(cohort_alignment)`` over parents; the last group all
    zeros (a padding child slot's accumulator)."""
    rng = np.random.default_rng(P * 10 + group)
    R, n = 2, 2 * LANE - 100
    u = rng.standard_normal((P * group, R, LANE)).astype(np.float32)
    u[:, :, :8] = 0.0
    u[:, :, 8:16] = -0.0
    u[-group:] = 0.0
    u[:, -1, -100:] = 0.0
    r = rng.integers(-1, 2, (P, R, LANE)).astype(np.int8)
    r[:, -1, -100:] = -2
    want = jax.vmap(lambda a, b: jalign.cohort_alignment(a, b, n))(
        jnp.asarray(u.reshape(P, group, R, LANE)), jnp.asarray(r))
    counts = tref.per_client_sign_align(torch.from_numpy(u),
                                        torch.from_numpy(r))
    got = counts / torch.tensor(float(n))
    assert np.array_equal(got.numpy(), np.asarray(want).reshape(-1))
    if P == 1:       # one reference given as (R, LANE): the flat call
        assert torch.equal(tref.per_client_sign_align(
            torch.from_numpy(u), torch.from_numpy(r[0])), counts)


@pytest.mark.parametrize("P", [1, 2])
def test_grouped_sign_count_of_an_empty_arena_is_zero(P):
    """R = 0: C zero counts, as the kernel writes them."""
    u = torch.zeros((4, 0, LANE))
    r = torch.zeros((P, 0, LANE), dtype=torch.int8)
    assert torch.equal(tref.per_client_sign_align(u, r), torch.zeros(4))
    assert torch.equal(tref.per_client_sign_align(u, r[0]), torch.zeros(4))


# ---------------------------------------------------------------------------
# TopologyRuntime.step against the JAX package's
# ---------------------------------------------------------------------------

class Replay:
    """Float64 replay of the accumulate-and-sync step on the same inputs:
    the Σ_c |w_c·u_c| each accumulator holds (the reduction rule's
    scale; a tier's sum of its accepted children's bounds taken over all
    of them, an upper bound) and, for each boundary's last sync, where
    |agg| lies within the rounding band of 0."""

    def __init__(self, tree, arena, thetas, cadences):
        self.tree, self.thetas, self.cadences = tree, thetas, cadences
        self.n = arena.n
        self.vmask = arena.valid_mask()
        B = tree.num_boundaries
        self.acc = [np.zeros((tree.pods[b], arena.rows, LANE))
                    for b in range(B)]
        self.scale = [a.copy() for a in self.acc]
        self.ref = [np.where(self.vmask, 0, -2)[None].repeat(
            tree.pods[b + 1], 0) for b in range(B)]
        self.has_ref = [np.zeros(tree.pods[b + 1], bool) for b in range(B)]
        self.band = [None] * B
        self.tests = [[] for _ in range(B)]     # each θ test's ratio

    def step(self, r, d, w, pods):
        c = w[:, None, None].astype(np.float64) * d
        np.add.at(self.acc[0], pods, c)
        np.add.at(self.scale[0], pods, np.abs(c))
        tree = self.tree
        for b in range(tree.num_boundaries):
            if (r + 1) % self.cadences[b]:
                continue
            parents, group = tree.pods[b + 1], tree.groups[b]
            shape = (parents, group) + self.acc[b].shape[1:]

            def grouped(x):
                out = np.zeros((parents * group,) + x.shape[1:])
                out[:len(x)] = x
                return out.reshape(shape)

            kids, ks = grouped(self.acc[b]), grouped(self.scale[b])
            valid = ttopo.child_valid(tree, b)
            passed = valid
            if self.thetas[b] is not None:
                ratios = (np.sign(kids) == self.ref[b][:, None]).reshape(
                    parents, group, -1).sum(-1) / self.n
                passed = (ratios >= self.thetas[b]) & valid
                self.tests[b] += list(
                    ratios[self.has_ref[b][:, None] & valid])
            passed = np.where(~self.has_ref[b][:, None], valid, passed)
            passed = np.where((passed.sum(1) == 0)[:, None], valid, passed)
            wf = passed.astype(np.float64)
            agg = np.einsum("pg,pgrl->prl", wf, kids) / np.maximum(
                wf.sum(1), 1e-9)[:, None, None]
            agg_scale = np.einsum("pg,pgrl->prl", valid.astype(np.float64),
                                  ks)
            self.band[b] = np.abs(agg) <= \
                2 * parity.TOPO_ACCUM_RTOL * agg_scale
            self.ref[b] = np.where(self.vmask[None], np.sign(agg), -2)
            self.has_ref[b][:] = True
            self.acc[b][:] = 0.0
            self.scale[b][:] = 0.0
            if b + 1 < tree.num_boundaries:
                self.acc[b + 1] += agg
                self.scale[b + 1] += agg_scale


def _round_inputs(rng, N, K, base, r, flipped):
    """Round r's cohort (K of N clients), deltas and weights: the common
    direction ``base``, sign-flipped for the clients in ``flipped``, plus
    noise; round 2 is empty (no weight, no deltas)."""
    cohort = rng.permutation(N)[:K]
    d = (base[None] * np.where(np.isin(cohort, flipped), -1.0, 1.0)[
        :, None, None] + 0.3 * rng.standard_normal((K,) + base.shape))
    w = rng.random(K) * (rng.random(K) < 0.8)
    if r == 2:
        d, w = np.zeros_like(d), np.zeros_like(w)
    return cohort, d.astype(np.float32), (w / max(w.sum(), 1.0)).astype(
        np.float32)


@pytest.mark.parametrize("tiers", [PADDED, PADDED_THETA, EVERY_ROUND,
                                   FALLBACK],
                         ids=["theta-none-padded", "theta-0.65", "bootstrap-"
                              "sync-every-round", "all-vetoed-fallback"])
def test_step_matches_jax(tiers):
    N, K, rounds = 10, 7, 8
    template = {"w": np.zeros((40, 60), np.float32),
                "b": np.zeros((60,), np.float32)}
    jarena, tarena_ = JArena(template), tarena.ParamArena(template)
    jspec, tspec = _tiers(jtopo, *tiers, seed=1), _tiers(ttopo, *tiers, seed=1)
    jrt = jtopo.TopologyRuntime(jspec, N, jarena,
                                jae.CommModel(bandwidth=5e6, latency=0.5))
    trt = ttopo.TopologyRuntime(tspec, N, tarena_,
                                tae.CommModel(bandwidth=5e6, latency=0.5),
                                device="cpu")
    assert np.array_equal(trt.pod_of.numpy(), np.asarray(jrt.pod_of))
    thetas = [t[3] for t in tiers[1:]]
    replay = Replay(trt.tree, tarena_, thetas, [t[2] for t in tiers[1:]])
    jstep = jax.jit(jrt.step)
    jstate, tstate = jrt.init(), trt.init()
    rng = np.random.default_rng(7)
    flipped = ([] if tiers is FALLBACK
               else np.flatnonzero(trt.pod_of.numpy() == 1))
    base = np.sign(rng.standard_normal((tarena_.rows, LANE))) * (
        0.5 + rng.random((tarena_.rows, LANE)))
    for r in range(rounds):
        cohort, d, w = _round_inputs(
            rng, N, K, -base if tiers is FALLBACK and r % 2 else base, r,
            flipped)
        pods = np.asarray(trt.pod_of.numpy()[cohort])
        jstate = jstep(jstate, jnp.int32(r), jnp.asarray(d), jnp.asarray(w),
                       jnp.asarray(pods, jnp.int32))
        tstate = trt.step(tstate, r, torch.from_numpy(d), torch.from_numpy(w),
                          torch.from_numpy(pods).to(torch.int64))
        replay.step(r, d, w, pods)
        jhost = jax.device_get(jstate)
        problems = parity.topology_problems(
            trt.summary(tstate, rounds=r + 1),
            jrt.summary(jstate, rounds=r + 1), trt.closest_theta_tests(), thetas,
            states=(tstate, jhost), scale=replay.scale,
            ref_band=replay.band)
        assert not problems, (r, problems)
    summary = trt.summary(tstate, rounds)
    assert trt.theta_test_counts() == [len(t) for t in replay.tests]
    for b, r, j, x in trt.closest_theta_tests():   # the replay's closest
        assert abs(x - thetas[b]) == pytest.approx(
            min(abs(t - thetas[b]) for t in replay.tests[b]), abs=1e-6)
    if tiers is PADDED_THETA:        # the flipped pod is vetoed, others not
        assert summary["vetoes"][0] > 0 and summary["accepts"][0] > 0
    if tiers is FALLBACK:            # every θ test fails, every child passes
        # (after the empty round a pod that trains nothing matches the
        # all-zero reference: ratio 1)
        assert np.mean([t < 0.65 for t in replay.tests[0]]) > 0.8
        assert summary["vetoes"][0] == 0.0
    # the JAX state carried across is the JAX state
    conv = topology_from_jax(jhost, "cpu")
    assert trt.summary(conv, rounds) == jrt.summary(jstate, rounds)
    for a, b in zip(conv.accum + conv.ref, jhost.accum + jhost.ref):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_step_with_a_tensor_round_selects_like_a_host_round():
    """The spmd step's form (the round a 0-dim tensor, both branches
    selected by torch.where) gives the host-round form's state by bits."""
    template = {"w": np.zeros((30, 40), np.float32)}
    arena = tarena.ParamArena(template)
    spec = _tiers(ttopo, *PADDED_THETA)
    host_rt = ttopo.TopologyRuntime(spec, 10, arena, device="cpu")
    dev_rt = ttopo.TopologyRuntime(spec, 10, arena, device="cpu")
    a, b = host_rt.init(), dev_rt.init()
    rng = np.random.default_rng(3)
    for r in range(6):
        d = torch.from_numpy(rng.standard_normal((10, arena.rows, LANE))
                             .astype(np.float32))
        w = torch.full((10,), 0.1)
        a = host_rt.step(a, r, d, w)
        b = dev_rt.step(b, torch.tensor(r, dtype=torch.int32), d, w)
    for x, y in zip(jax.tree_util.tree_leaves(tuple(a)),
                    jax.tree_util.tree_leaves(tuple(b))):
        assert torch.equal(x, y)
    assert host_rt.closest_theta_tests() == dev_rt.closest_theta_tests()
    assert host_rt.theta_test_counts() == dev_rt.theta_test_counts()


def test_runtime_memory_stays_flat_across_rounds():
    """What the runtime keeps between rounds (its tensors and their
    bytes) does not grow with the run's length: after 2 rounds as after
    12, on both forms of the round."""
    template = {"w": np.zeros((30, 40), np.float32)}
    arena = tarena.ParamArena(template)
    spec = _tiers(ttopo, *EVERY_ROUND)
    rng = np.random.default_rng(5)
    d = torch.from_numpy(rng.standard_normal((10, arena.rows, LANE))
                         .astype(np.float32))
    w = torch.full((10,), 0.1)

    def kept(rt):
        out = []
        for v in vars(rt).values():
            for t in (v if isinstance(v, (list, tuple)) else [v]):
                if torch.is_tensor(t):
                    out.append(t.numel() * t.element_size())
        return out

    for tensor_round in (False, True):
        rt = ttopo.TopologyRuntime(spec, 10, arena, device="cpu")
        state, sizes, counts = rt.init(), [], []
        for r in range(12):
            state = rt.step(state, torch.tensor(r) if tensor_round else r,
                            d, w)
            if r in (1, 11):
                sizes.append(kept(rt))
                counts.append(rt.theta_test_counts()[0])
        assert sizes[0] == sizes[1]
        assert counts[1] > counts[0] > 0


@pytest.mark.parametrize("C", [1, 2, 7, 33])
def test_leaf_accumulation_is_a_fixed_order_segment_sum(C):
    """Rows of repeated and absent pods, in any order: within
    TOPO_ACCUM_RTOL of the float64 sum's Σ|w·u| and equal by bits from
    run to run and to the rows permuted within their pods' order."""
    template = {"w": np.zeros((20, 60), np.float32)}
    arena = tarena.ParamArena(template)
    rt = ttopo.TopologyRuntime(_tiers(ttopo, *PADDED), 10, arena,
                               device="cpu")
    rng = np.random.default_rng(C)
    d = rng.standard_normal((C, arena.rows, LANE)).astype(np.float32)
    w = rng.random(C).astype(np.float32)
    pods = rng.integers(0, rt.tree.pods[0] - 1, C)     # the last pod empty
    acc0 = torch.from_numpy(rng.standard_normal(
        (rt.tree.pods[0], arena.rows, LANE)).astype(np.float32))
    got = rt.accumulate(acc0, torch.from_numpy(d), torch.from_numpy(w),
                        torch.from_numpy(pods))
    c = w[:, None, None].astype(np.float64) * d
    want, scale = acc0.numpy().astype(np.float64), np.abs(
        acc0.numpy()).astype(np.float64)
    np.add.at(want, pods, c)
    np.add.at(scale, pods, np.abs(c))
    assert np.all(np.abs(got.numpy() - want)
                  <= parity.TOPO_ACCUM_RTOL * scale)
    assert torch.equal(got[-1], acc0[-1])
    assert torch.equal(got, rt.accumulate(acc0, torch.from_numpy(d),
                                          torch.from_numpy(w),
                                          torch.from_numpy(pods)))
    by_pod = np.argsort(pods, kind="stable")
    assert torch.equal(got, rt.accumulate(
        acc0, torch.from_numpy(d[by_pod]), torch.from_numpy(w[by_pod]),
        torch.from_numpy(pods[by_pod])))


# ---------------------------------------------------------------------------
# core/hierarchy.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sync_every", [1, 4])
def test_maybe_pod_sync_matches_jax(sync_every):
    P, rounds = 4, 8
    rng = np.random.default_rng(sync_every)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    jstate = jhier.init_pod_sync({k: jnp.asarray(v)
                                  for k, v in params.items()})
    tstate = thier.init_pod_sync({k: torch.from_numpy(v)
                                  for k, v in params.items()})
    jpods = {k: jnp.asarray(np.repeat(v[None], P, 0))
             for k, v in params.items()}
    tpods = {k: torch.from_numpy(np.repeat(v[None], P, 0))
             for k, v in params.items()}
    sync = jax.jit(lambda p, s: jhier.maybe_pod_sync(
        p, s, sync_every=sync_every, theta=0.65))
    accepts = []
    signs = {k: np.sign(rng.standard_normal(v.shape))
             for k, v in params.items()}
    for r in range(rounds):
        # a drift of fixed signs shared by pods 0-2, the opposite one for
        # pod 3, away from 0 so no sign is a rounding question
        drift = {k: signs[k] * (0.05 + 0.1 * rng.random(v.shape))
                 for k, v in params.items()}
        step = {k: (np.stack([v, v, v, -v]) + 0.01 * rng.standard_normal(
            (P,) + v.shape)).astype(np.float32) for k, v in drift.items()}
        jpods = {k: jpods[k] + step[k] for k in step}
        tpods = {k: tpods[k] + torch.from_numpy(step[k]) for k in step}
        jpods, jstate, jm = sync(jpods, jstate)
        tpods, tstate, tm = thier.maybe_pod_sync(tpods, tstate,
                                                 sync_every=sync_every)
        for k in params:
            want = np.asarray(jpods[k])
            assert np.allclose(tpods[k].numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max()), (r, k)
            assert np.array_equal(tstate.global_ref_sign[k].numpy(),
                                  np.asarray(jstate.global_ref_sign[k]))
            want = np.asarray(jstate.last_global[k])
            assert np.allclose(tstate.last_global[k].numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
        assert int(tstate.rounds_since_sync) == int(jstate.rounds_since_sync)
        assert bool(tstate.has_ref) == bool(jstate.has_ref)
        for k in ("synced", "pod_accept"):
            assert float(tm[k]) == float(jm[k]), (r, k)
        # the mean of equal ratios, reduced in another order: one ulp
        want = np.float32(jm["pod_alignment"])
        assert abs(np.float32(tm["pod_alignment"]) - want) <= \
            np.spacing(want), r
        accepts.append(float(tm["pod_accept"]))
    # the veto fires once a reference exists (pod 3 moves against it)
    assert 0.75 in accepts and 1.0 in accepts


def test_as_topology_spec_is_the_two_tier_preset():
    assert thier.as_topology_spec() == ttopo.TOPOLOGY_PRESETS["two-tier-pods"]
    assert dataclasses.asdict(thier.as_topology_spec(fanout=4, sync_every=2)) \
        == dataclasses.asdict(jhier.as_topology_spec(fanout=4, sync_every=2))


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

PATHS = ("loop", "megastep", "scanned1", "scanned4", "spmd")
# the cells' trees for 5 clients: pods (3, 2, 1)
THETA_FREE = (("pod", 2, 1, None), ("region", 2, 2, None),
              ("global", None, 4, None))
THETA_TREE = (("pod", 2, 1, None), ("region", 2, 1, 0.65),
              ("global", None, 2, 0.65))


def _spec(mod, path, topology=None, rounds=4):
    """The smoke world on one path: ``ours`` + int8 picking 3 of 5 on the
    sim engine (plain ``ours`` on the loop), ``cmfl`` on spmd."""
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
    return mod.ExperimentSpec(
        model="anomaly-mlp-smoke",
        data=mod.DataSpec(n_samples=1500, eval_samples=300, alpha=0.5),
        world=mod.WorldSpec(num_clients=5, dropout_p=0.1),
        comm=mod.CommModel(bandwidth=5e6, latency=0.5, t_sample=2e-3,
                           t_launch=0.25),
        strategy=strategy, strategy_kwargs=kw, topology=topology,
        rounds=rounds, seed=0, **fields)


def _p0(spec):
    return {k: np.asarray(v) for k, v in japi.init_params(
        jax.random.PRNGKey(spec.seed), spec.resolve_model()).items()}


def _run(spec, params):
    """(records, summary, θ tests of the topology, engine θ ratios)."""
    if spec.engine == "spmd":
        drv = T.SpmdDriver(spec, device="cpu", params=params)
        recs = drv.run_rounds(spec.rounds)
        if spec.resolve_topology() is None:
            return recs, None, [], drv.theta_ratios
        (rt,) = drv.step.topology_runtimes.values()
        return (recs, rt.summary(drv.state.topology, rounds=spec.rounds),
                rt.closest_theta_tests(), drv.theta_ratios)
    sim = T.build_simulation(spec, device="cpu", params=params)
    sim.run(spec.rounds)
    return (T.result_from_simulation(spec, sim).records,
            sim.topology_summary(),
            sim._topo.closest_theta_tests() if sim._topo is not None else [],
            sim.theta_ratios)


@pytest.mark.parametrize("path", PATHS)
def test_engine_records_are_those_without_the_topology(path):
    params = _p0(_spec(J, path))
    flat = _run(_spec(T, path), params)
    summaries = {}
    for tiers in (THETA_FREE, THETA_TREE):
        recs, summary, _tests, ratios = _run(
            _spec(T, path, _tiers(T, *tiers)), params)
        assert recs == flat[0]                  # equal by bits
        assert ratios == flat[3]
        summaries[tiers] = summary
    assert summaries[THETA_FREE]["syncs"] == [2, 1]
    assert summaries[THETA_FREE]["vetoes"] == [0.0, 0.0]
    assert summaries[THETA_TREE]["syncs"] == [4, 2]


def test_theta_free_summaries_agree_across_paths():
    params = _p0(_spec(J, "megastep"))
    tiers = _tiers(T, *THETA_FREE)
    first = None
    for path in PATHS:
        _recs, summary, _t, _r = _run(_spec(T, path, tiers), params)
        first = first or summary
        assert summary == first, path


@pytest.mark.parametrize("path", ["megastep", "spmd"])
def test_engine_summary_matches_jax(path):
    jspec = _spec(J, path, _tiers(J, *THETA_TREE)).validate()
    tspec = _spec(T, path, _tiers(T, *THETA_TREE)).validate()
    thetas = [t[3] for t in THETA_TREE[1:]]
    if path == "spmd":
        jdrv = jrunner.SpmdDriver(jspec)
        jdrv.run_rounds(jspec.rounds)
        n = jdrv.world.num_clients
        jrt = jtopo.TopologyRuntime(
            jspec.resolve_topology(), n,
            JArena(jax.eval_shape(lambda: jdrv.state.params)),
            jspec.resolve_comm())
        want = jrt.summary(jdrv.state.topology, rounds=jspec.rounds)
        tdrv = T.SpmdDriver(tspec, device="cpu", params=_p0(jspec),
                            draws=JaxSpmdDraws(jspec.seed, n, n))
        tdrv.run_rounds(tspec.rounds)
        (trt,) = tdrv.step.topology_runtimes.values()
        got = trt.summary(tdrv.state.topology, rounds=tspec.rounds)
        tests = trt.closest_theta_tests()
        assert not parity.theta_band_violations(tdrv.theta_ratios, 0.65)
    else:
        jsim = jrunner.build_simulation(jspec)
        jsim.run(jspec.rounds)
        want = jsim.topology_summary()
        sim = T.build_simulation(tspec, device="cpu", params=_p0(jspec))
        sim.run(tspec.rounds)
        got = sim.topology_summary()
        tests = sim._topo.closest_theta_tests()
        assert not parity.theta_band_violations(sim.theta_ratios, 0.65)
    assert tests, "the θ tree made no θ test"
    problems = parity.topology_problems(got, want, tests, thetas)
    assert not problems, problems
