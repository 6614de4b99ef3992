"""The port's optimizers, LR schedules and loss scaler
(``repro_torch.optim``) against the JAX package's ``repro.optim``, on the
same numpy inputs.

Tolerances, each with its reason:

  * adamw: both packages compute m, v, the bias corrections and the step
    in the same order, in f32. XLA's f32 power may sit one ulp off the
    correctly rounded value that the port takes (core/xla_pow.py), and the
    bias corrections carry that through two divisions and a square root
    into the step, so weights and moments agree within ``ADAM_ULPS`` f32
    ulps of the reference; bf16 weights are the f32 masters rounded once,
    so within one bf16 ulp.
  * adafactor: its row and column means sum n positive terms (g² + ε) in
    another order than XLA's, within n·2^-24 relative; the factored
    denominator multiplies two such means and divides by a third, and the
    update takes its rsqrt and the RMS clip: ``FACTOR_RTOL`` =
    4·n·2^-24 + 4 ulps of each state leaf's largest value, n = 8 the
    widest mean here; a weight moves by lr·u with |u| ≤ √size (the RMS
    clip), so the weights within FACTOR_RTOL of max|w| + lr·√size.
  * schedules: ``cos`` in f32 is within one ulp (at most 2^-24 in [-1,
    1]) in either package, and the cosine schedule adds 1 and scales it
    by lr·(1 − final_frac)/2, which keeps that absolute gap while the
    value near 0 shrinks: lr·2^-24 plus ``SCHED_ULPS`` ulps of the value.
  * the scaler's arithmetic is exact (powers of two), held equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import registry as jreg
from repro.optim import adamw as jopt
from repro.optim import scaler as jsc
from repro.optim import schedule as jsched

from repro_torch.configs import registry as treg
from repro_torch.optim import adamw as topt
from repro_torch.optim import scaler as tsc
from repro_torch.optim import schedule as tsched
from repro_torch.tree import named_leaves, tree_map

ADAM_ULPS = 4
SCHED_ULPS = 2
FACTOR_RTOL = 4 * 8 * 2.0 ** -24 + 4 * 2.0 ** -23


def _tree(seed, dtype=np.float32, scale=1.0):
    """A nest of leaves of several ranks: a vector, a matrix, a stacked
    (L, in, out) leaf and a nested dict."""
    rng = np.random.default_rng(seed)
    t = {"b": rng.normal(size=(7,)),
         "w": rng.normal(size=(6, 5)),
         "layers": {"wq": rng.normal(size=(3, 4, 8)),
                    "ln": {"w": rng.normal(size=(3, 8))}}}
    return tree_map(lambda a: (a * scale).astype(dtype), t)


def _jnp(tree, dtype=None):
    return tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _torch(tree, dtype=None):
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32),
                                           dtype=dtype), tree)


def _np(tree):
    return tree_map(lambda t: (t.float().numpy() if torch.is_tensor(t)
                               else np.asarray(t, np.float32)), tree)


def _ulp_gap(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float64) - want) / np.spacing(
        np.maximum(np.abs(want), np.float32(1e-30)))


def _close_ulps(got, want, ulps, where=""):
    for (p, g), (_, w) in zip(named_leaves(_np(got)), named_leaves(_np(want))):
        gap = _ulp_gap(g, w).max(initial=0.0)
        assert gap <= ulps, (where, p, gap)


def _run(opt_j, opt_t, params, steps, dtype_j=None, dtype_t=None, lrs=None):
    pj, pt = _jnp(params, dtype_j), _torch(params, dtype_t)
    sj, st = opt_j.init(pj), opt_t.init(pt)
    outs = []
    for i in range(steps):
        g = _tree(100 + i, scale=10.0 ** (i - 1))
        lr_j = None if lrs is None else jnp.float32(lrs[i])
        lr_t = None if lrs is None else torch.tensor(lrs[i])
        pj, sj = opt_j.update(_jnp(g), sj, pj, lr_now=lr_j)
        pt, st = opt_t.update(_torch(g), st, pt, lr_now=lr_t)
        outs.append(((pj, sj), (pt, st)))
    return outs


@pytest.mark.parametrize("keep_master", [False, True])
@pytest.mark.parametrize("lr_now", [False, True])
def test_adamw_f32_matches_jax(keep_master, lr_now):
    lrs = [1e-2, 3e-3, 5e-4, 2e-2] if lr_now else None
    outs = _run(jopt.adamw(1e-2, weight_decay=0.01, keep_master=keep_master),
                topt.adamw(1e-2, weight_decay=0.01, keep_master=keep_master),
                _tree(0), 4, lrs=lrs)
    for i, ((pj, sj), (pt, st)) in enumerate(outs):
        assert int(st["count"]) == int(sj["count"]) == i + 1
        assert set(st) == set(sj)
        _close_ulps(pt, pj, ADAM_ULPS, f"params step {i}")
        for k in ("m", "v") + (("master",) if keep_master else ()):
            _close_ulps(st[k], sj[k], ADAM_ULPS, f"{k} step {i}")


def test_adamw_bf16_weights_with_master_match_jax():
    outs = _run(jopt.adamw(1e-2, keep_master=True),
                topt.adamw(1e-2, keep_master=True), _tree(1), 4,
                dtype_j=jnp.bfloat16, dtype_t=torch.bfloat16)
    for i, ((pj, sj), (pt, st)) in enumerate(outs):
        _close_ulps(st["master"], sj["master"], ADAM_ULPS, f"master {i}")
        for (p, g), (_, w) in zip(named_leaves(pt), named_leaves(pj)):
            assert g.dtype == torch.bfloat16
            w = np.asarray(w.astype(jnp.float32))
            # one bf16 ulp: the masters' last f32 bit may round either way
            ulp = np.spacing(np.abs(w).astype(np.float32)) * 2.0 ** 16
            assert (np.abs(g.float().numpy() - w) <= ulp).all(), (i, p)


def test_adafactor_matches_jax():
    outs = _run(jopt.adafactor(5e-2), topt.adafactor(5e-2), _tree(2), 4)
    for i, ((pj, sj), (pt, st)) in enumerate(outs):
        assert int(st["count"]) == int(sj["count"]) == i + 1
        for (p, g), (q, w) in zip(named_leaves(_np(st["stats"])),
                                  named_leaves(_np(sj["stats"]))):
            assert p == q
            assert np.abs(g - w).max() <= FACTOR_RTOL * np.abs(w).max(), \
                (i, p)
        for (p, g), (_, w) in zip(named_leaves(_np(pt)), named_leaves(_np(pj))):
            tol = FACTOR_RTOL * (np.abs(w).max() + 5e-2 * np.sqrt(w.size))
            assert np.abs(g - w).max() <= tol, (i, p)


def test_adafactor_state_shapes():
    st = topt.adafactor(1e-2).init({"m": torch.ones(8, 16),
                                    "v": torch.ones(5)})
    assert st["stats"]["m"]["r"].shape == (8,)
    assert st["stats"]["m"]["c"].shape == (16,)
    assert st["stats"]["v"]["v"].shape == (5,)


@pytest.mark.parametrize("make", ["adamw", "adafactor", "sgd"])
def test_optimizer_descends_quadratic(make):
    """tests/test_optim.py's case, on the port."""
    opt = {"adamw": lambda: topt.adamw(1e-1),
           "adafactor": lambda: topt.adafactor(5e-1),
           "sgd": lambda: topt.sgd(1e-1)}[make]()
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    state = opt.init(params)
    l0 = float((params["w"] ** 2).sum())
    for _ in range(50):
        params, state = opt.update({"w": 2 * params["w"]}, state, params)
    assert float((params["w"] ** 2).sum()) < 0.1 * l0


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-34b", "arctic-480b",
                                  "anomaly-mlp", "granite-moe-1b-a400m"])
@pytest.mark.parametrize("smoke", [False, True])
def test_for_config_picks_what_jax_picks(arch, smoke):
    tc, jc = treg.get_config(arch, smoke), jreg.get_config(arch, smoke)
    p = {"w": np.ones((4, 3), np.float32)}
    jst = jopt.for_config(jc).init(_jnp(p))
    tst = topt.for_config(tc).init(_torch(p))
    assert sorted(tst) == sorted(jst)
    assert [n for n, _ in named_leaves(tst)] == \
        [n for n, _ in named_leaves(jax.device_get(jst))]


# --------------------------------------------------------------------------
# schedules
# --------------------------------------------------------------------------

SCHEDULES = {   # name -> (schedule, its base lr)
    "constant": (lambda m: m.constant(3e-4), 3e-4),
    "cosine": (lambda m: m.cosine(3e-4, warmup_steps=5, total_steps=40),
               3e-4),
    "cosine-frac": (lambda m: m.cosine(1.0, 10, 100, final_frac=0.0), 1.0),
    "step_decay": (lambda m: m.step_decay(1e-2, decay_every=7, gamma=0.3),
                   1e-2),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax(name):
    make, lr = SCHEDULES[name]
    fj, ft = make(jsched), make(tsched)
    for step in range(0, 120):
        want = np.float32(fj(step))
        tol = lr * 2.0 ** -24 + SCHED_ULPS * float(np.spacing(abs(want)))
        for got in (ft(step), ft(torch.tensor(step, dtype=torch.int32))):
            assert got.dim() == 0 and got.dtype == torch.float32
            assert abs(float(got) - float(want)) <= tol, (step, got, want)


# --------------------------------------------------------------------------
# the loss scaler
# --------------------------------------------------------------------------

def test_scaler_overflow_skips_and_halves():
    state = tsc.init_scaler(1024.0)
    finite = tsc.grads_finite({"w": torch.tensor([torch.inf, 1.0])})
    assert finite.dtype == torch.bool and not bool(finite)
    ns = tsc.next_state(state, finite)
    assert float(ns.scale) == 512.0 and int(ns.good_steps) == 0
    kept, _ = tsc.apply_or_skip(finite, {"w": torch.ones(2)},
                                {"w": torch.zeros(2)}, {}, {})
    assert torch.equal(kept["w"], torch.zeros(2))


@pytest.mark.parametrize("case", ["growth", "cap", "floor", "reset"])
def test_scaler_rules_match_jax(case):
    init, seq, kw = {
        "growth": (8.0, [True] * 200, dict(growth_interval=200)),
        "cap": (2.0 ** 23, [True] * 9, dict(growth_interval=3)),
        "floor": (4.0, [False] * 5, {}),
        "reset": (64.0, [True, True, False, True, True, True],
                  dict(growth_interval=3)),
    }[case]
    js, ts = jsc.init_scaler(init), tsc.init_scaler(init)
    for fin in seq:
        js = jsc.next_state(js, jnp.bool_(fin), **kw)
        ts = tsc.next_state(ts, torch.tensor(fin), **kw)
        assert float(ts.scale) == float(js.scale)
        assert int(ts.good_steps) == int(js.good_steps)
        assert ts.good_steps.dtype == torch.int32
    if case == "cap":
        assert float(ts.scale) == 2.0 ** 24
    if case == "floor":
        assert float(ts.scale) == 1.0


def test_scaler_scale_unscale_roundtrip():
    state = tsc.init_scaler(2.0 ** 10)
    assert float(tsc.scale_loss(torch.tensor(3.5), state)) == 3.5 * 2 ** 10
    un = tsc.unscale_grads({"w": torch.tensor([2.0 ** 10 * 4.0],
                                              dtype=torch.float16)}, state)
    assert un["w"].dtype == torch.float32 and float(un["w"]) == 4.0


def test_fp16_training_with_scaler_end_to_end():
    """tests/test_optim.py's fp16 case on the port: scaled loss, unscale,
    skip on overflow; the weights are the JAX run's, step for step."""
    tparams = {"w": torch.tensor([2.0, -1.0], dtype=torch.float16)}
    jparams = {"w": jnp.array([2.0, -1.0], jnp.float16)}
    topt_, jopt_ = topt.sgd(1e-1), jopt.sgd(1e-1)
    tstate, jstate = topt_.init(tparams), jopt_.init(jparams)
    ts, js = tsc.init_scaler(2.0 ** 8), jsc.init_scaler(2.0 ** 8)

    def jloss(p):
        w = p["w"].astype(jnp.float32)
        return jnp.sum(w * w)

    for _ in range(30):
        w = tparams["w"].detach().requires_grad_(True)
        loss = (w.to(torch.float32) ** 2).sum()
        g, = torch.autograd.grad(tsc.scale_loss(loss, ts), w)
        g = tsc.unscale_grads({"w": g}, ts)
        fin = tsc.grads_finite(g)
        new_p, new_st = topt_.update(g, tstate, tparams)
        tparams, tstate = tsc.apply_or_skip(fin, new_p, tparams, new_st,
                                            tstate)
        ts = tsc.next_state(ts, fin)

        jg = jax.grad(lambda p: jsc.scale_loss(jloss(p), js))(jparams)
        jg = jsc.unscale_grads(jg, js)
        jfin = jsc.grads_finite(jg)
        jp, jst = jopt_.update(jg, jstate, jparams)
        jparams, jstate = jsc.apply_or_skip(jfin, jp, jparams, jst, jstate)
        js = jsc.next_state(js, jfin)
        assert bool(fin) == bool(jfin)
        np.testing.assert_array_equal(
            tparams["w"].float().numpy(),
            np.asarray(jparams["w"].astype(jnp.float32)))
    assert float((tparams["w"].float() ** 2).sum()) < 0.5
