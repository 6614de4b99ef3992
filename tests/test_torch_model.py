"""The port's anomaly-detection MLP and momentum SGD against the JAX
package's, from the same parameters and batches (numpy, from a seed), at
the SMOKE width and the full anomaly-mlp width.

Tolerance: f32 throughout, compared to rtol 1e-5 with an absolute floor of
1e-5 of the largest magnitude in the array — XLA and torch take their
matrix products and reductions in different orders, so entries agree to a
few ulps of the array's scale, and entries near zero only to that scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import anomaly_mlp as jcfg
from repro.models import api as japi
from repro.models import mlp_detector as jmlp
from repro.optim import adamw as jopt

from repro_torch.configs import anomaly_mlp as tcfg
from repro_torch.convert import params_from_jax
from repro_torch.models import api as tapi
from repro_torch.models import mlp_detector as tmlp
from repro_torch.optim import adamw as topt

CONFIGS = {"smoke": (jcfg.SMOKE, tcfg.SMOKE),
           "anomaly-mlp": (jcfg.CONFIG, tcfg.CONFIG)}


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30))


_jinit = jax.jit(japi.init_params, static_argnums=1)


def _setup(name, batch=64, seed=0):
    jc, tc = CONFIGS[name]
    jp = _jinit(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, jc.num_features)).astype(np.float32)
    y = rng.integers(0, jc.num_classes, size=batch).astype(np.int32)
    return jc, tc, jp, x, y


def _tbatch(x, y):
    return {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()}


def test_params_from_jax_round_trip():
    jc, tc, jp, _, _ = _setup("anomaly-mlp")
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    assert sorted(tp) == sorted(jp)
    assert sum(v.numel() for v in tp.values()) == tc.param_count() == 54602
    for k in jp:
        assert tp[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


def test_init_params_draws_the_reference_distribution():
    tc = tcfg.CONFIG
    p = tapi.init_params(torch.Generator().manual_seed(0), tc)
    jp = _jinit(jax.random.PRNGKey(0), jcfg.CONFIG)
    for k in jp:
        assert tuple(p[k].shape) == tuple(jp[k].shape)
        if k.startswith("b"):
            assert not p[k].any()
        else:
            fan_in = p[k].shape[0]
            std = float(p[k].std()) * np.sqrt(fan_in)
            assert abs(std - 1.0) < 0.05, (k, std)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_loss_accuracy_match(name):
    jc, tc, jp, x, y = _setup(name)
    tp = params_from_jax(jp, "cpu")
    _close(tmlp.forward(tp, torch.from_numpy(x), tc).numpy(),
           jmlp.forward(jp, jnp.asarray(x), jc))
    _close(tapi.loss_fn(tp, _tbatch(x, y), tc).numpy(),
           japi.loss_fn(jp, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, jc))
    assert float(tapi.build_default_eval(tc)(tp, _tbatch(x, y))) == \
        float(japi.build_default_eval(jc)(jp, {"x": jnp.asarray(x),
                                               "y": jnp.asarray(y)}))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_gradients_and_sgd_step_match(name):
    jc, tc, jp, x, y = _setup(name, seed=1)
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda q: japi.loss_fn(q, jb, jc)))(jp)
    tp = params_from_jax(jp, "cpu")
    q = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tloss = tapi.loss_fn(q, _tbatch(x, y), tc)
    names = sorted(q)
    tg = dict(zip(names, torch.autograd.grad(tloss, [q[k] for k in names])))
    _close(tloss.detach().numpy(), jloss)
    for k in names:
        _close(tg[k].numpy(), jg[k])

    # two momentum-SGD steps from a fresh state, the second with momentum
    jo, to = jopt.sgd(lr=3e-2), topt.sgd(lr=3e-2)
    js, ts = jo.init(jp), to.init(tp)
    jnew, tnew = jp, tp
    jupdate = jax.jit(jo.update)
    for _ in range(2):
        jnew, js = jupdate(jg, js, jnew)
        tnew, ts = to.update(tg, ts, tnew)
    for k in names:
        _close(tnew[k].numpy(), jnew[k])
        _close(ts["mom"][k].numpy(), js["mom"][k])


def test_cohort_forward_equals_per_client():
    _, tc, jp, x, y = _setup("smoke")
    tp = params_from_jax(jp, "cpu")
    rng = np.random.default_rng(5)
    cohort = {k: torch.stack([v, v + 0.01 * torch.from_numpy(
        rng.standard_normal(tuple(v.shape)).astype(np.float32))])
        for k, v in tp.items()}
    xs = torch.from_numpy(np.stack([x, x[::-1].copy()]))
    ys = torch.from_numpy(np.stack([y, y[::-1].copy()])).long()
    losses = tapi.loss_fn(cohort, {"x": xs, "y": ys}, tc)
    assert losses.shape == (2,)
    for c in range(2):
        one = tapi.loss_fn({k: v[c] for k, v in cohort.items()},
                           {"x": xs[c], "y": ys[c]}, tc)
        _close(losses[c].numpy(), one.numpy())
