"""The port's spmd train step (``repro_torch.core.fl_step``) against the
JAX package's, step by step, on the smoke MLP.

Both steps start from the same ``FLState`` (the JAX package's
``init_state``, carried across by ``convert.fl_state_from_jax``), take the
same batches (numpy, from a seed) and the same draws: the JAX package
draws selection and dropout from ``fold_in(PRNGKey(cp.seed), step)``,
which torch cannot replay, so the port's step is handed ``JaxSpmdDraws``,
the reference's own key calls. After one and after three steps, under the
JAX package's default bf16 aggregation and under f32:

  * masks, selections and deliveries of every step, and the reference
    signs, are equal; so are accept rates and bytes (ratios of small
    integers, whole payloads and 1/8-byte beacons);
  * parameters within ``parity.spmd_param_mismatches``, loss within
    ``parity.LOSS_RTOL``, the control state within
    ``parity.control_mismatches`` — each tolerance with its reason in
    ``repro_torch/api/parity.py``.

Then the JAX package's five semantic tests of the step
(tests/test_fl_step.py), on the port alone.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import anomaly_mlp as jcfgs
from repro.core import fl_step as jfl
from repro.optim import adamw as jopt

from repro_torch.api import parity
from repro_torch.configs import anomaly_mlp as tcfgs
from repro_torch.convert import fl_state_from_jax
from repro_torch.core import control as tctl
from repro_torch.core import fl_step as tfl
from repro_torch.core.draws import SpmdDraws
from repro_torch.optim import adamw as topt

C, B, LR = 4, 64, 3e-2


class JaxSpmdDraws:
    """The JAX spmd step's draws (core/fl_step.py, control plane):
    ``fold_in(PRNGKey(seed), step)`` split into (k_sel, k_drop); dropout
    uniforms (C,) from k_drop; k_sel split into the ε and pick keys, (k,)
    uniforms each."""

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


# case -> (theta, control-plane options or None)
CASES = {
    "fedavg": (None, None),
    "theta": (0.65, None),
    "grad_norm": (0.65, dict(select_k=2, grad_norm_selection=True)),
    "per_client_lr": (None, dict(select_k=C, per_client_lr=True)),
    "quantize": (0.65, dict(select_k=C, quantize=True)),
    "dropout": (0.65, dict(select_k=3, dropout_p=(0.3,) * C)),
    "two_stage": (0.65, dict(select_k=2, candidate_frac=0.5,
                             candidate_shards=2, dropout_p=(0.3,) * C)),
}
AGG = {"bf16": (jnp.bfloat16, torch.bfloat16),
       "f32": (jnp.float32, torch.float32)}


def _batch(i, cfg):
    rng = np.random.default_rng(100 + i)
    return {"x": rng.normal(size=(C, B, cfg.num_features)).astype(np.float32),
            "y": rng.integers(0, cfg.num_classes, size=(C, B))}


@functools.lru_cache(maxsize=None)
def _jax_step(case, agg):
    theta, cpkw = CASES[case]
    cp = jfl.ControlPlane(num_clients=C, **cpkw) if cpkw else None
    return cp, jax.jit(jfl.make_raw_step(
        jcfgs.SMOKE, jopt.sgd(LR, momentum=0.0), theta=theta,
        control_plane=cp, agg_dtype=AGG[agg][0]))


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("agg", sorted(AGG))
@pytest.mark.parametrize("case", sorted(CASES))
def test_step_matches_jax(case, agg, steps):
    theta, cpkw = CASES[case]
    jcp, jstep = _jax_step(case, agg)
    tcp = tfl.ControlPlane(num_clients=C, **cpkw) if cpkw else None
    opt = topt.sgd(LR, momentum=0.0)
    js = jfl.init_state(jax.random.PRNGKey(0), jcfgs.SMOKE,
                        jopt.sgd(LR, momentum=0.0), control_plane=jcp)
    ts = fl_state_from_jax(jax.device_get(js), device="cpu")
    start = {k: v.clone() for k, v in ts.params.items()}
    tstep = tfl.make_raw_step(tcfgs.SMOKE, opt, theta=theta,
                              control_plane=tcp, agg_dtype=AGG[agg][1])
    draws = JaxSpmdDraws(0, C, tcp.select_k) if tcp else None
    for i in range(steps):
        b = _batch(i, tcfgs.SMOKE)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, {"x": torch.from_numpy(b["x"]),
                            "y": torch.from_numpy(b["y"])},
                       draws.round_draws(i) if draws else None)
        for k in ("mask", "selected", "delivered"):
            np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]),
                                          err_msg=f"step {i}: {k}")
        for k in ("accept_rate", "bytes_sent", "bytes_baseline"):
            assert float(tm[k]) == float(jm[k]), (i, k)
        assert abs(float(tm["loss"]) - float(jm["loss"])) \
            <= parity.LOSS_RTOL * abs(float(jm["loss"])), i
        if theta is not None and i > 0:
            assert not parity.theta_band_violations(
                [(i, c, float(x)) for c, x in enumerate(tm["ratios"])],
                theta)
    want = jax.device_get(js)
    assert int(ts.step) == int(want.step) == steps
    for k in ts.ref_sign:
        np.testing.assert_array_equal(ts.ref_sign[k].numpy(),
                                      np.asarray(want.ref_sign[k]), err_msg=k)
    assert not parity.spmd_param_mismatches(
        {k: v.numpy() for k, v in ts.params.items()}, want.params,
        {k: v.numpy() for k, v in start.items()}, steps,
        bf16_agg=agg == "bf16")
    for k in ("accepted", "rounds"):
        assert float(ts.metrics[k]) == float(want.metrics[k])
    if tcp is not None:
        got = {f: v.numpy() for f, v in ts.control._asdict().items()}
        assert not parity.control_mismatches(got, want.control._asdict())
        if tcp.quantize:
            assert not parity.ef_mismatches(got["ef"],
                                            np.asarray(want.control.ef))


def _default_optimizer_step_matches_jax():
    """``init_state`` and ``make_raw_step`` without an optimizer take the
    config's (adamw without master weights for the f32 mlp), as JAX's do:
    one θ step from the reference's state, records equal and weights by
    the adamw rule of ``api/parity.py``."""
    js = jfl.init_state(jax.random.PRNGKey(0), jcfgs.SMOKE)
    before = jax.device_get(js)
    ts = fl_state_from_jax(before, device="cpu")
    assert set(ts.opt_state) == {"m", "v", "count"}
    assert set(tfl.init_state(torch.Generator().manual_seed(0), tcfgs.SMOKE,
                              device="cpu").opt_state) == {"m", "v", "count"}
    b = _batch(0, tcfgs.SMOKE)
    js, jm = jax.jit(jfl.make_raw_step(jcfgs.SMOKE, agg_dtype=jnp.float32))(
        js, {k: jnp.asarray(v) for k, v in b.items()})
    ts, tm = tfl.make_raw_step(tcfgs.SMOKE, agg_dtype=torch.float32)(
        ts, {"x": torch.from_numpy(b["x"]), "y": torch.from_numpy(b["y"])})
    after = jax.device_get(js)
    for k in ("mask", "accept_rate", "bytes_sent"):
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]))
    g = {k: np.asarray(after.opt_state["m"][k], np.float64) / 0.1
         for k in after.params}
    bounds = {k: parity.grad_bound(v, 256, B) for k, v in g.items()}
    assert parity.adamw_weight_problems(
        {k: v.numpy() for k, v in ts.params.items()}, after.params, [g],
        [bounds], [1e-3]) == []


def test_step_refuses_what_is_not_ported():
    opt = topt.sgd(LR)
    # the default optimizer (optim.for_config: adamw) is run, not refused;
    # tests/test_torch_train.py holds it against the JAX package's, and
    # here one step of the mlp without an optimizer against JAX's
    _default_optimizer_step_matches_jax()
    # two-stage selection is run, not refused
    two = tfl.ControlPlane(num_clients=C, select_k=2, candidate_frac=0.5,
                           candidate_shards=2)
    state2 = tfl.init_state(torch.Generator().manual_seed(0), tcfgs.SMOKE,
                            opt, control_plane=two, device="cpu")
    step2 = tfl.make_raw_step(tcfgs.SMOKE, opt, control_plane=two)
    b = _batch(0, tcfgs.SMOKE)
    draws = SpmdDraws(0, C, 2, "cpu").round_draws(0)
    want = tctl.two_stage_select(
        tctl.score(state2.control), 2, candidate_frac=0.5,
        candidate_shards=2, epsilon=two.epsilon, eps_u=draws[0],
        pick_u=draws[1])
    _, m = step2(state2, {"x": torch.from_numpy(b["x"]),
                          "y": torch.from_numpy(b["y"])}, draws)
    assert torch.nonzero(m["selected"]).reshape(-1).tolist() == \
        sorted(want.tolist())
    step = tfl.make_raw_step(tcfgs.SMOKE, opt, control_plane=tfl.ControlPlane(
        num_clients=C, select_k=2))
    state = tfl.init_state(torch.Generator().manual_seed(0), tcfgs.SMOKE, opt,
                           control_plane=tfl.ControlPlane(num_clients=C,
                                                          select_k=2),
                           device="cpu")
    b = _batch(0, tcfgs.SMOKE)
    with pytest.raises(ValueError, match="draws"):
        step(state, {"x": torch.from_numpy(b["x"]),
                     "y": torch.from_numpy(b["y"])})


# ---------------------------------------------------------------------------
# the JAX package's semantic tests of the step (tests/test_fl_step.py)
# ---------------------------------------------------------------------------

CFG = tcfgs.CONFIG.replace(mlp_hidden=(16, 8), num_features=10,
                           num_classes=3)


def _sem_batch(Cn=4, Bn=8, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": torch.from_numpy(rng.normal(size=(Cn, Bn, CFG.num_features))
                                  .astype(np.float32)),
            "y": torch.from_numpy(rng.integers(0, CFG.num_classes,
                                               size=(Cn, Bn)))}


def _sem_state(opt):
    return tfl.init_state(torch.Generator().manual_seed(0), CFG, opt,
                          device="cpu")


def _theta_none_is_fedavg():
    """mask forced to ones equals the no-filter baseline."""
    opt = topt.sgd(1e-2)
    s0 = _sem_state(opt)
    b = _sem_batch()
    s1, _ = tfl.build_fl_train_step(CFG, opt, theta=None)(s0, b)
    s2, _ = tfl.build_fl_train_step(CFG, opt, theta=0.0)(s0, b)
    for k in s1.params:
        np.testing.assert_allclose(s1.params[k].numpy(),
                                   s2.params[k].numpy(), rtol=1e-6)


def _filtering_changes_aggregate_when_masked():
    opt = topt.sgd(1e-2)
    step = tfl.build_fl_train_step(CFG, opt, theta=0.65)
    b = _sem_batch()
    s1, m1 = step(_sem_state(opt), b)       # bootstrap round accepts all
    assert float(m1["accept_rate"]) == 1.0
    _, m2 = step(s1, b)
    assert 0.0 <= float(m2["accept_rate"]) <= 1.0
    assert np.isfinite(float(m2["loss"]))
    assert float(m2["bytes_sent"]) <= float(m2["bytes_baseline"]) + 1e-6


def _no_pass_fallback_keeps_training():
    """If no client passes θ, the fallback accepts all (no stall)."""
    opt = topt.sgd(1e-2)
    step = tfl.build_fl_train_step(CFG, opt, theta=1.01)
    b = _sem_batch()
    s1, _ = step(_sem_state(opt), b)
    s2, m2 = step(s1, b)
    assert float(m2["accept_rate"]) == 0.0       # nobody passes θ > 1
    assert any(not np.allclose(s1.params[k].numpy(), s2.params[k].numpy())
               for k in s1.params), "the fallback must keep the model moving"


def _loss_decreases_over_rounds():
    opt = topt.sgd(5e-2)
    s = _sem_state(opt)
    step = tfl.build_fl_train_step(CFG, opt, theta=0.55)
    losses = []
    for i in range(15):
        s, m = step(s, _sem_batch(seed=i % 3))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def _ref_sign_updates():
    opt = topt.sgd(1e-2)
    s0 = _sem_state(opt)
    assert all(int(v.abs().max()) == 0 for v in s0.ref_sign.values())
    s1, _ = tfl.build_fl_train_step(CFG, opt, theta=0.65)(s0, _sem_batch())
    assert sum(int(v.abs().sum()) for v in s1.ref_sign.values()) > 0


SEMANTICS = {f.__name__.strip("_"): f for f in (
    _theta_none_is_fedavg, _filtering_changes_aggregate_when_masked,
    _no_pass_fallback_keeps_training, _loss_decreases_over_rounds,
    _ref_sign_updates)}


@pytest.mark.parametrize("name", sorted(SEMANTICS))
def test_step_semantics(name):
    SEMANTICS[name]()


def test_seed_batched_step_is_the_raw_step_per_seed():
    opt = topt.sgd(1e-2)
    seeds = (3, 4)
    batched = tfl.init_seed_batched_state(seeds, CFG, opt, device="cpu")
    vstep = tfl.build_seed_batched_step(CFG, opt, theta=0.65)
    raw = tfl.make_raw_step(CFG, opt, theta=0.65)
    solo = [tfl.init_state(torch.Generator().manual_seed(s), CFG, opt,
                           device="cpu") for s in seeds]
    for i in range(2):
        bs = [_sem_batch(seed=10 * i + j) for j in range(len(seeds))]
        batched, bm = vstep(batched, {k: torch.stack([b[k] for b in bs])
                                      for k in bs[0]})
        for j, b in enumerate(bs):
            solo[j], m = raw(solo[j], b)
            for k, v in m.items():
                assert torch.equal(bm[k][j], v), (i, j, k)
    for j, s in enumerate(solo):
        for k, v in s.params.items():
            assert torch.equal(batched.params[k][j], v)
