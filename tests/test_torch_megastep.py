"""The port's cohort megastep against the JAX package's, given the same
params_mat, cohort batches, lr_scale and ref_mat (numpy, from a seed).

Tolerances: deltas, losses, norms and new parameters are f32 results of
several SGD steps whose products XLA and torch order differently, so they
agree to rtol 1e-4 with an absolute floor of 1e-5 of the array's scale.
A delta entry that small can take the other sign, so the sign-alignment
ratios may differ by a few counts in 54,602 (about 1e-4): they are held to
2e-4. Given the SAME deltas, the apply step's new reference sign is equal
wherever the global movement is above that float noise, and the -2
padding sentinel is equal everywhere. With int8 compression the error
feedback is held to ``repro_torch.api.parity.ef_mismatches`` (float noise,
and the rare code that took its neighbour at a tie).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import anomaly_mlp as jcfg
from repro.core import megastep as jmega
from repro.kernels import arena as jarena
from repro.models import api as japi
from repro.optim import adamw as jopt

from repro_torch.api import parity
from repro_torch.configs import anomaly_mlp as tcfg
from repro_torch.core import megastep as tmega
from repro_torch.kernels import arena as tarena
from repro_torch.optim import adamw as topt

CONFIGS = {"smoke": (jcfg.SMOKE, tcfg.SMOKE),
           "anomaly-mlp": (jcfg.CONFIG, tcfg.CONFIG)}


def _close(got, want, rtol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30))


def _setup(name, C=4, steps=4, B=32, seed=0):
    jc, tc = CONFIGS[name]
    jp = japi.init_params(jax.random.PRNGKey(seed), jc)
    ja = jarena.ParamArena(jp)
    ta = tarena.ParamArena({k: np.asarray(v) for k, v in jp.items()})
    pmat = np.array(ja.pack(jp))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((C, steps, B, jc.num_features)).astype(np.float32)
    y = rng.integers(0, jc.num_classes, size=(C, steps, B)).astype(np.int32)
    lr_scale = np.array([1.0, 0.5, 2.0, 1.0][:C], np.float32)
    prev = pmat + 0.01 * rng.standard_normal(pmat.shape).astype(np.float32)
    ref = np.array(ja.sign_ref(jnp.asarray(pmat), jnp.asarray(prev)))
    return jc, tc, ja, ta, pmat, x, y, lr_scale, ref


def _tbatch(x, y):
    return {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("has_ref", [False, True])
def test_cohort_step_matches_jax(name, has_ref):
    jc, tc, ja, ta, pmat, x, y, lr_scale, ref = _setup(name)
    jstep = jmega.build_cohort_step(jc, jopt.sgd(lr=3e-2), ja, theta=0.65)
    jd, jl, jr, jn, _ = jstep(jnp.asarray(pmat),
                              {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                              jnp.asarray(lr_scale), None,
                              jnp.asarray(ref) if has_ref else None,
                              None, None, has_ref=has_ref)
    tstep = tmega.build_cohort_step(tc, topt.sgd(lr=3e-2), ta, theta=0.65)
    td, tl, tr, tn, _ = tstep(torch.from_numpy(pmat), _tbatch(x, y),
                              torch.from_numpy(lr_scale), None,
                              torch.from_numpy(ref) if has_ref else None,
                              None, None, has_ref=has_ref)
    _close(td.numpy(), jd)
    _close(tl.numpy(), jl)
    _close(tn.numpy(), jn)
    assert np.abs(tr.numpy() - np.asarray(jr)).max() <= 2e-4
    if not has_ref:
        assert (tr.numpy() == 1.0).all()
    # padding slots of the deltas stay exactly zero
    assert not td.reshape(td.shape[0], -1)[:, ta.n:].any()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_quantized_cohort_step_matches_jax(name):
    """Cohort of 3 padded to 4: the pad row reads and writes the error
    arena's extra row N = 5; client rows gather and scatter by id."""
    jc, tc, ja, ta, pmat, x, y, lr_scale, ref = _setup(name)
    rng = np.random.default_rng(11)
    ef = (1e-4 * rng.standard_normal((6, ta.rows, ta.lane))).astype(np.float32)
    idx = np.array([4, 0, 2, 5])
    jstep = jmega.build_cohort_step(jc, jopt.sgd(lr=3e-2), ja, theta=0.65,
                                    quantize=True)
    jd, jl, jr, jn, jef = jstep(jnp.asarray(pmat),
                                {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                                jnp.asarray(lr_scale), None, jnp.asarray(ref),
                                jnp.asarray(ef), jnp.asarray(idx, jnp.int32),
                                has_ref=True)
    tstep = tmega.build_cohort_step(tc, topt.sgd(lr=3e-2), ta, theta=0.65,
                                    quantize=True)
    td, tl, tr, tn, tef = tstep(torch.from_numpy(pmat), _tbatch(x, y),
                                torch.from_numpy(lr_scale), None,
                                torch.from_numpy(ref), torch.from_numpy(ef),
                                torch.from_numpy(idx), has_ref=True)
    assert tef.shape == ef.shape
    np.testing.assert_array_equal(tef.numpy()[[1, 3]], ef[[1, 3]])
    assert not parity.ef_mismatches(tef.numpy()[:5], np.asarray(jef)[:5])
    assert not parity.ef_mismatches(td.numpy()[:3], np.asarray(jd)[:3])
    _close(tl.numpy(), jl)
    _close(tn.numpy(), jn)
    assert np.abs(tr.numpy() - np.asarray(jr)).max() <= 2e-4
    # the payload is the dequantized codes: at most 255 levels a row
    rows = td.numpy().reshape(-1, ta.lane)
    assert max(len(np.unique(r)) for r in rows) <= 255


def test_cohort_step_scales_each_clients_gradient():
    """lr_scale multiplies the gradient before momentum, so with one step
    a client's delta scales with its lr_scale (up to the rounding of
    p - lr·g at the parameters' own magnitude)."""
    _, tc, _, ta, pmat, x, y, _, _ = _setup("smoke", C=2, steps=1)
    x[1], y[1] = x[0], y[0]
    tstep = tmega.build_cohort_step(tc, topt.sgd(lr=3e-2), ta)
    td, *_ = tstep(torch.from_numpy(pmat), _tbatch(x, y),
                   torch.tensor([1.0, 0.25]), None, None, None, None,
                   has_ref=False)
    np.testing.assert_allclose(td[1].numpy(), 0.25 * td[0].numpy(), rtol=0,
                               atol=2.0 ** -22 * np.abs(pmat).max())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_apply_update_matches_jax(name):
    jc, tc, ja, ta, pmat, x, y, lr_scale, _ = _setup(name)
    rng = np.random.default_rng(9)
    groups = [0.01 * rng.standard_normal((C, ta.rows, ta.lane))
              .astype(np.float32) for C in (4, 2)]
    for g in groups:
        g.reshape(g.shape[0], -1)[:, ta.n:] = 0.0
    weights = [np.array([0.25, 0.0, 0.5, 0.0], np.float32),
               np.array([0.125, 0.0], np.float32)]
    jnew, jref = jmega.build_apply_update(ja)(
        jnp.asarray(pmat), tuple(jnp.asarray(g) for g in groups),
        tuple(jnp.asarray(w) for w in weights))
    tnew, tref = tmega.build_apply_update(ta)(
        torch.from_numpy(pmat), tuple(torch.from_numpy(g) for g in groups),
        tuple(torch.from_numpy(w) for w in weights))
    _close(tnew.numpy(), jnew, rtol=1e-6)
    assert tref.dtype == torch.int8
    jref = np.asarray(jref)
    moved = np.abs(np.asarray(jnew) - pmat) > 1e-6 * np.abs(pmat).max()
    pad = ~ta.valid_mask()
    np.testing.assert_array_equal(tref.numpy()[moved | pad], jref[moved | pad])
    assert (tref.numpy()[pad] == -2).all()
