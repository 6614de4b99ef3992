"""Training the language models on the port (the spmd step with the
config's optimizer, ``models/transformer.py``'s backward, the flash
kernel's backward, the MoE VJPs, ``run_experiment`` with token data and
``launch/train.py``) against the JAX package on the CPU, from the same
weights (JAX's, carried across by ``convert``) and the same numpy inputs.

Tolerances, each with its reason (``api/parity.py`` derives the first
two):
  * gradients: ``parity.grad_problems``, each leaf within
    ``grad_bound`` = 2·(K + T)·2^-24 of its largest |g| (two packages'
    f32 reductions of width K over T positions);
  * weights after adamw steps: ``parity.adamw_weight_problems``, held
    elementwise where every step's |g| exceeds its bound and within the
    sign flip's 2·lr·R elsewhere;
  * losses within ``parity.LOSS_RTOL`` (relative);
  * remat against no remat on the port: equal by bits in f32 (the same
    operations recomputed);
  * the flash backward against ``jax.grad`` through the JAX package's
    ``blockwise_attention``: ``grad_bound`` with K the key length plus
    the head dim and T the query length (its sums);
  * θ decisions reproducible only with no ratio within
    ``parity.THETA_BAND`` of θ (``parity.theta_band_violations``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import repro.api as J
from repro.configs import registry as jreg
from repro.core import fl_step as jfl
from repro.models import api as japi
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.optim import adamw as jopt
from repro.optim import schedule as jsched

import repro_torch as T
from repro_torch.api import parity
from repro_torch.configs import registry as treg
from repro_torch.convert import (fl_state_from_jax, lm_params_from_jax,
                                 opt_state_from_jax)
from repro_torch.core import fl_step as tfl
from repro_torch.kernels import flash_attn as tfa
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.models import moe as tmoe
from repro_torch.optim import adamw as topt
from repro_torch.optim import schedule as tsched
from repro_torch.tree import from_paths, named_leaves, tree_map
from repro_torch.tree import get as tree_get
from test_torch_moe import _jax_routing

ARCHS = ["qwen2-1.5b", "granite-moe-1b-a400m", "internvl2-2b"]
C, B = 2, 2
LR = 1e-3     # optim.for_config's default, the step's without a schedule


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: where several test workers share the machine,
    more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch, **kw):
    kw = dict(dict(dtype="float32"), **kw)
    return (jreg.get_config(arch, smoke=True).replace(**kw),
            treg.get_config(arch, smoke=True).replace(**kw))


def _tokens(cfg, lead, seq, seed=0):
    """Numpy token batch of ``seq`` positions with leading dims ``lead``
    (for vlm the patch embeddings take the first ``num_patches``)."""
    rng = np.random.default_rng(seed)
    patches = cfg.num_patches if cfg.family == "vlm" else 0
    shape = tuple(lead) + (seq - patches,)
    out = {"tokens": rng.integers(0, cfg.vocab_size, size=shape),
           "labels": rng.integers(0, cfg.vocab_size, size=shape)}
    if patches:
        out["patch_embeds"] = rng.normal(
            size=tuple(lead) + (patches, cfg.d_model)).astype(np.float32)
    return out


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _flat(tree):
    return {"/".join(map(str, p)): np.asarray(
        v.detach().float().numpy() if torch.is_tensor(v) else v, np.float32)
        for p, v in named_leaves(tree)}


def _width(cfg, seq):
    """K: the widest contraction behind a gradient element."""
    return max(cfg.d_model, cfg.d_ff, cfg.padded_vocab, seq)


def _torch_grads(tc, params, batch):
    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    leaves = [v for _, v in named_leaves(p)]
    loss = tapi.loss_fn(p, _tb(batch), tc)
    grads = torch.autograd.grad(loss, leaves)
    names = ["/".join(map(str, q)) for q, _ in named_leaves(p)]
    return loss.item(), {n: g.numpy() for n, g in zip(names, grads)}


# --------------------------------------------------------------------------
# the loss's backward
# --------------------------------------------------------------------------

LOSS_CASES = {   # name -> (arch, attention_impl, remat, seq)
    "qwen2 full": ("qwen2-1.5b", "full", False, 64),
    "qwen2 full remat": ("qwen2-1.5b", "full", True, 64),
    "qwen2 blockwise remat": ("qwen2-1.5b", "blockwise", True, 512),
    "qwen2 blockwise window": ("qwen2-1.5b", "blockwise", False, 1024),
    "granite-moe full": ("granite-moe-1b-a400m", "full", False, 64),
    "granite-moe overflow remat": ("granite-moe-1b-a400m", "full", True, 64),
    "internvl2 full remat": ("internvl2-2b", "full", True, 64),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_and_grads_match_jax(case):
    arch, impl, remat, seq = LOSS_CASES[case]
    kw = dict(attention_impl=impl, remat=remat)
    if "window" in case:
        kw["sliding_window"] = 600
    if "overflow" in case:
        kw["capacity_factor"] = 0.5     # every expert's buffer overflows
    jc, tc = _cfgs(arch, **kw)
    jp = jax.device_get(japi.init_params(jax.random.PRNGKey(0), jc))
    b = _tokens(jc, (B,), seq)
    jl, jg = jax.value_and_grad(japi.loss_fn)(jp, _jb(b), jc)
    tl, tg = _torch_grads(tc, lm_params_from_jax(jp, "cpu"), b)
    assert abs(tl - float(jl)) <= parity.LOSS_RTOL * abs(float(jl))
    assert parity.grad_problems(tg, _flat(jax.device_get(jg)),
                                _width(tc, seq), B * seq) == []


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_gradients_by_bits(arch):
    """``torch.utils.checkpoint`` recomputes each layer's forward in the
    backward: the same operations, so the same gradient."""
    jc, tc = _cfgs(arch)
    p = lm_params_from_jax(jax.device_get(japi.init_params(
        jax.random.PRNGKey(1), jc)), "cpu")
    b = _tokens(tc, (B,), 64, seed=1)
    l0, g0 = _torch_grads(tc.replace(remat=False), p, b)
    l1, g1 = _torch_grads(tc.replace(remat=True), p, b)
    assert l0 == l1
    for k in g0:
        assert np.array_equal(g0[k], g1[k]), k


# --------------------------------------------------------------------------
# the flash kernel's backward (plain torch on both devices)
# --------------------------------------------------------------------------

FLASH_CASES = {   # name -> (B, S, H, K, hd, causal, window, block)
    "causal gqa": (2, 512, 4, 2, 32, True, None, 512),
    "causal gqa small blocks": (1, 512, 6, 2, 32, True, None, 128),
    "sliding window": (1, 1024, 4, 1, 32, True, 300, 256),
    "full mha": (1, 512, 2, 2, 64, False, None, 512),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_backward_matches_jax_grad(case, monkeypatch):
    Bq, S, H, K, hd, causal, window, block = FLASH_CASES[case]
    monkeypatch.setattr(tfa, "BACKWARD_BLOCK", block)
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(Bq, S, n, hd)).astype(np.float32)
               for n in (H, K, K))
    dout = rng.normal(size=(Bq, S, H * hd)).astype(np.float32)

    def jf(q, k, v):
        return jlayers.blockwise_attention(q, k, v, causal=causal,
                                           sliding_window=window,
                                           out_dtype=jnp.float32)

    jout, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = tfa.flash_attention_gqa(tq, tk, tv, causal=causal,
                                  sliding_window=window)
    out.reshape(Bq, S, H * hd).backward(torch.as_tensor(dout))
    np.testing.assert_allclose(out.detach().reshape(Bq, S, -1).numpy(),
                               np.asarray(jout), rtol=0, atol=1e-5)
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), jgrads):
        assert parity.grad_problems({name: got.numpy()},
                                    {name: np.asarray(want)}, S + hd,
                                    S) == [], case


def test_flash_backward_runs_under_grad_with_no_refusal():
    """The wrapper took no input that requires grad before it had a
    backward; now it differentiates, and the launch count stays 0 on the
    CPU."""
    q = torch.randn(1, 256, 2, 32, requires_grad=True)
    k = torch.randn(1, 256, 1, 32, requires_grad=True)
    v = torch.randn(1, 256, 1, 32, requires_grad=True)
    before = tfa.launches
    out = tfa.flash_attention_gqa(q, k, v, causal=True)
    out.sum().backward()
    assert tfa.launches == before
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))


# --------------------------------------------------------------------------
# the MoE VJPs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "arctic-480b"])
def test_moe_ffn_vjp_matches_jax(arch, capacity_factor):
    """One layer's gradients (input, router, experts, dense residual)
    against the JAX custom VJPs, with and without dropped choices; the
    routing equal under ``parity.routing_problems``' margin."""
    jc, tc = _cfgs(arch, capacity_factor=capacity_factor)
    jp = jax.device_get(jmoe.moe_params(jc, jax.random.PRNGKey(3),
                                        jnp.float32))
    x = np.random.default_rng(3).normal(size=(2, 16, jc.d_model)).astype(
        np.float32)
    dy = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)

    def jf(p, x):
        out, aux = jmoe.moe_ffn(jc, p, x)
        return jnp.sum(out * dy) + 0.3 * aux

    jg = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = tree_map(lambda t: t.requires_grad_(True),
                  lm_params_from_jax(jp, "cpu"))
    tx = torch.tensor(x, requires_grad=True)
    out, aux = tmoe.moe_ffn(tc, tp, tx)
    r = tmoe.route(tc, tp["router"].detach(), tx.detach().reshape(
        -1, tc.d_model))
    assert r.capacity == jmoe.capacity(jc, 32)
    assert parity.routing_problems(
        [r], [_jax_routing(jc, jp["router"], jnp.asarray(x))]) == []
    ((out * torch.as_tensor(dy)).sum() + 0.3 * aux).backward()
    got = _flat({"p": tree_map(lambda t: t.grad, tp), "x": tx.grad})
    want = _flat({"p": jax.device_get(jg[0]), "x": np.asarray(jg[1])})
    assert parity.grad_problems(got, want, jc.d_ff + jc.d_model, 32) == []
    if capacity_factor < 1:
        assert not r.keep.all()


def test_moe_combine_backward_takes_dw_in_f32():
    """bf16: the combine's weight gradient is Σ_d dy·ye in f32, rounded
    once (JAX ``_combine_bwd``); autograd of the plain gather would round
    each bf16 product first."""
    rng = np.random.default_rng(5)
    T_, k, d, EC = 6, 2, 64, 16
    ye = torch.tensor(rng.normal(size=(EC, d)), dtype=torch.bfloat16,
                      requires_grad=True)
    w = torch.tensor(rng.random(T_ * k), dtype=torch.bfloat16,
                     requires_grad=True)
    slot = torch.as_tensor(rng.permutation(EC)[:T_ * k])
    cfs = torch.zeros(EC, dtype=torch.int64)
    cfs[slot] = torch.arange(T_ * k)
    valid = torch.zeros(EC, dtype=torch.bool)
    valid[slot] = True
    out = tmoe._Combine.apply(ye, w, slot, cfs, valid, k)
    dout = torch.tensor(rng.normal(size=(T_, d)), dtype=torch.bfloat16)
    out.backward(dout)
    want = (dout.float().repeat_interleave(k, 0)
            * ye.detach().float()[slot]).sum(-1).to(torch.bfloat16)
    assert torch.equal(w.grad, want)


# --------------------------------------------------------------------------
# the spmd step (core/fl_step.py) against the JAX package's
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_lm_step(arch, theta):
    jc, _ = _cfgs(arch)
    return jax.jit(jfl.make_raw_step(jc, theta=theta,
                                     agg_dtype=jnp.float32))


def _jax_grads_of_step(before, after, b1=0.9):
    """A step's aggregated gradient, from the reference's first moments:
    g = (m_t − b1·m_{t−1}) / (1 − b1)."""
    m0, m1 = _flat(before["m"]), _flat(after["m"])
    return {k: (m1[k].astype(np.float64) - b1 * m0[k]) / (1 - b1)
            for k in m1}


@pytest.mark.parametrize("theta", [0.65, None])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-1b-a400m"])
def test_fl_step_default_optimizer_matches_jax(arch, theta):
    """Three steps of each package's step without an optimizer (the
    config's: adamw without master weights for f32 weights). Each port
    step starts from the reference's state before it (so nothing
    compounds): masks, accept rates and bytes equal, loss within
    LOSS_RTOL, reference signs and weights by the adamw rule. Then the port's own
    three consecutive steps: the same records, loss within LOSS_RTOL."""
    jc, tc = _cfgs(arch)
    jstep = _jax_lm_step(arch, theta)
    tstep = tfl.make_raw_step(tc, theta=theta, agg_dtype=torch.float32)
    js = jfl.init_state(jax.random.PRNGKey(0), jc)
    own = fl_state_from_jax(jax.device_get(js), device="cpu")
    assert set(own.opt_state) == {"m", "v", "count"}
    seq = 32
    ratios = []
    for i in range(3):
        b = _tokens(tc, (C, B), seq, seed=10 + i)
        before = jax.device_get(js)
        ts = fl_state_from_jax(before, device="cpu")
        js, jm = jstep(js, _jb(b))
        after = jax.device_get(js)
        ts, tm = tstep(ts, _tb(b))
        own, om = tstep(own, _tb(b))
        for m in (tm, om):
            for k in ("mask", "selected", "delivered"):
                np.testing.assert_array_equal(m[k].numpy(),
                                              np.asarray(jm[k]), k)
            for k in ("accept_rate", "bytes_sent", "bytes_baseline"):
                assert float(m[k]) == float(jm[k]), (i, k)
            assert abs(float(m["loss"]) - float(jm["loss"])) <= \
                parity.LOSS_RTOL * abs(float(jm["loss"]))
        if theta is not None and i > 0:
            ratios += [(i, c, float(x)) for c, x in enumerate(tm["ratios"])]
        g = _jax_grads_of_step(before.opt_state, after.opt_state)
        bounds = {k: parity.grad_bound(v, _width(tc, seq), B * seq)
                  for k, v in g.items()}
        assert parity.ref_sign_problems(_flat(ts.ref_sign),
                                        _flat(after.ref_sign), g,
                                        bounds) == []
        assert parity.adamw_weight_problems(
            _flat(ts.params), _flat(after.params), [g], [bounds], [1e-3],
            count0=i, where=f"step {i}: ") == []
        assert int(ts.opt_state["count"]) == i + 1
    if theta is not None:
        assert not parity.theta_band_violations(ratios, theta)


def test_fl_step_lm_keeps_position_when_nothing_is_accepted():
    """Every participant dropped: weights, optimizer state and reference
    sign stay as they were, held back in place in the new tensors."""
    _, tc = _cfgs("qwen2-1.5b")
    cp = tfl.ControlPlane(num_clients=C, select_k=C, dropout_p=(0.5,) * C)
    state = tfl.init_state(torch.Generator().manual_seed(0), tc,
                           control_plane=cp, device="cpu")
    step = tfl.make_raw_step(tc, theta=None, control_plane=cp)
    b = _tb(_tokens(tc, (C, B), 32))
    drop_all = (None, None, torch.zeros(C))
    state, _ = step(state, b, (None, None, torch.ones(C)))
    before = _flat(state.params), _flat(state.opt_state)
    new, m = step(state, b, drop_all)
    assert float(m["mask"].sum()) == 0
    for k, v in _flat(new.params).items():
        assert np.array_equal(v, before[0][k]), k
    for k, v in _flat(new.opt_state).items():
        assert np.array_equal(v, before[1][k]), k


def _bf16_client_grads(tc, params, batch, c):
    """Client ``c``'s loss and gradients (name -> bf16 tensor) at the
    shared ``params``, by the port's own backward."""
    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    named = named_leaves(p)
    loss = tapi.loss_fn(p, {k: torch.as_tensor(v[c]) for k, v in
                            batch.items()}, tc)
    grads = torch.autograd.grad(loss, [v for _, v in named])
    return loss.detach(), {q: g for (q, _), g in zip(named, grads)}


@pytest.mark.parametrize("theta", [0.65, None])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-1b-a400m"])
def test_fl_step_bf16_weights_keep_f32_masters_as_jax(arch, theta):
    """The smoke configs' own bf16: ``for_config`` gives adamw with f32
    master weights, each client's gradient is bf16 (as JAX's of a bf16
    weight) and goes into the f32 arena. Three steps, each port step from
    the reference's state before it.

    The two packages' forward and backward round in bf16 at different
    points, and granite-moe's routing meets bf16 ties, so their gradients
    part far beyond ``grad_bound``'s f32 reductions (the f32 case above
    holds them). What the bf16 path adds is held against the JAX package
    where nothing but the path decides it:
      * the records against JAX's step: masks and bytes equal, θ
        decisions outside ``THETA_BAND``;
      * the aggregate: each client's bf16 gradient by the port's own
        backward, put on its leaf by name, in f32, summed as the plain
        aggregation sums (client by client), so equal by bits to what
        the step's arena gives if it packs each gradient on its own leaf;
      * the master step: JAX's ``for_config`` optimizer on that aggregate
        from the same state gives m and v within ``ADAM_ULPS`` f32 ulps,
        and masters within ``ADAM_ULPS`` ulps of the larger of the master
        and the step lr·R (test_torch_optim.py: XLA's f32 power moves the
        bias corrections, and so the step, by an ulp; a master that the
        step takes near 0 keeps that step's absolute gap);
      * the weights: the port's masters rounded to the weight's dtype, by
        bits (bf16 but the f32 MoE router), and within one bf16 ulp of
        JAX's (whose masters may round either way in their last f32 bit);
        the reference signs those of the aggregate, by bits."""
    from test_torch_optim import ADAM_ULPS, _close_ulps
    jc = jreg.get_config(arch, smoke=True)
    tc = treg.get_config(arch, smoke=True)
    assert tc.dtype == jc.dtype == "bfloat16"
    jstep = jax.jit(jfl.make_raw_step(jc, theta=theta,
                                      agg_dtype=jnp.float32))
    tstep = tfl.make_raw_step(tc, theta=theta, agg_dtype=torch.float32)
    jopt_cfg = jopt.for_config(jc)
    js = jfl.init_state(jax.random.PRNGKey(0), jc)
    seq, ratios = 32, []
    for i in range(3):
        b = _tokens(tc, (C, B), seq, seed=10 + i)
        before = jax.device_get(js)
        ts = fl_state_from_jax(before, device="cpu")
        assert set(ts.opt_state) == {"m", "v", "count", "master"}
        js, jm = jstep(js, _jb(b))
        new, tm = tstep(ts, _tb(b))
        for k in ("mask", "selected", "delivered"):
            np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]),
                                          k)
        for k in ("accept_rate", "bytes_sent", "bytes_baseline"):
            assert float(tm[k]) == float(jm[k]), (i, k)
        if theta is not None and i > 0:
            ratios += [(i, c, float(x)) for c, x in enumerate(tm["ratios"])]

        per_client = [_bf16_client_grads(tc, ts.params, b, c)
                      for c in range(C)]
        assert float(tm["loss"]) == float(
            torch.stack([l.float() for l, _ in per_client]).mean())
        w = tm["mask"] / torch.clamp_min(tm["mask"].sum(), 1e-9)
        agg = {}
        for name, _ in named_leaves(ts.params):
            weight = tree_get(ts.params, name)
            assert all(g[name].dtype == weight.dtype
                       for _, g in per_client), name
            acc = torch.zeros(per_client[0][1][name].shape)
            for c, (_, g) in enumerate(per_client):
                acc = acc + w[c] * g[name].float()
            agg[name] = acc
        paths = [q for q, _ in named_leaves(ts.params)]
        want_p, want_o = jopt_cfg.update(
            from_paths(paths, [jnp.asarray(agg[q].numpy()) for q in paths]),
            before.opt_state, before.params)
        want_p, want_o = jax.device_get((want_p, want_o))
        assert int(new.opt_state["count"]) == int(want_o["count"]) == i + 1
        for k in ("m", "v"):
            _close_ulps(new.opt_state[k], want_o[k], ADAM_ULPS,
                        f"{k} step {i}")
        step_size = LR * parity.adam_ratio_bound(i + 1)
        for (q, got), (_, want) in zip(named_leaves(new.opt_state["master"]),
                                       named_leaves(want_o["master"])):
            scale = np.maximum(np.abs(np.asarray(want)), step_size)
            gap = np.abs(got.numpy().astype(np.float64) - want)
            assert (gap <= ADAM_ULPS * np.spacing(
                scale.astype(np.float32))).all(), (i, q, gap.max())
        master = dict(named_leaves(new.opt_state["master"]))
        for (q, got), (_, want) in zip(named_leaves(new.params),
                                       named_leaves(want_p)):
            assert got.dtype == tree_get(ts.params, q).dtype, q
            assert torch.equal(got, master[q].to(got.dtype)), (i, q)
            want = np.asarray(want.astype(jnp.float32))
            ulp = np.spacing(np.abs(want).astype(np.float32)) * 2.0 ** 16
            assert (np.abs(got.float().numpy() - want) <= ulp).all(), (i, q)
        for q, ref in named_leaves(new.ref_sign):
            assert torch.equal(ref, torch.sign(agg[q]).to(torch.int8)), q
    if theta is not None:
        assert not parity.theta_band_violations(ratios, theta)


def test_fl_step_bf16_keeps_masters_and_weights_when_nothing_is_accepted():
    """Every participant dropped at the smoke config's bf16: the bf16
    weights and the f32 masters (two tensors each, unlike f32 weights,
    which are their own master) stay as they were, as do m, v, the count
    and the reference signs."""
    tc = treg.get_config("qwen2-1.5b", smoke=True)
    assert tc.dtype == "bfloat16"
    cp = tfl.ControlPlane(num_clients=C, select_k=C, dropout_p=(0.5,) * C)
    state = tfl.init_state(torch.Generator().manual_seed(0), tc,
                           control_plane=cp, device="cpu")
    assert set(state.opt_state) == {"m", "v", "count", "master"}
    step = tfl.make_raw_step(tc, theta=0.65, control_plane=cp)
    b = _tb(_tokens(tc, (C, B), 32))
    state, _ = step(state, b, (None, None, torch.ones(C)))
    before = [dict(named_leaves(t)) for t in
              (state.params, state.opt_state, state.ref_sign)]
    before = [{k: v.clone() for k, v in d.items()} for d in before]
    new, m = step(state, b, (None, None, torch.zeros(C)))
    assert float(m["mask"].sum()) == 0
    for got, want in zip((new.params, new.opt_state, new.ref_sign), before):
        for k, v in named_leaves(got):
            assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
    master = dict(named_leaves(new.opt_state["master"]))
    for k, v in named_leaves(new.params):
        assert torch.equal(v, master[k].to(torch.bfloat16)), k


def test_opt_state_from_jax_continues_each_optimizer():
    """A JAX adamw, adafactor or sgd state carried across mid-run: one
    more step of each package from it agrees with the other's."""
    rng = np.random.default_rng(2)
    params = {"w": rng.normal(size=(5, 4)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)}
    for jo, to in ((jopt.adamw(1e-2), topt.adamw(1e-2)),
                   (jopt.adafactor(1e-2), topt.adafactor(1e-2)),
                   (jopt.sgd(1e-2), topt.sgd(1e-2))):
        jp = _jb(params)
        js = jo.init(jp)
        for i in range(2):
            g = _jb({k: rng.normal(size=v.shape).astype(np.float32)
                     for k, v in params.items()})
            jp, js = jo.update(g, js, jp)
        ts = opt_state_from_jax(jax.device_get(js), device="cpu")
        assert [p for p, _ in named_leaves(ts)] == \
            [p for p, _ in named_leaves(jax.device_get(js))]
        tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in params.items()}
        jp2, _ = jo.update(_jb(g), js, jp)
        tp2, _ = to.update(_tb(g), ts, tp)
        for k in params:
            np.testing.assert_allclose(tp2[k].numpy(), np.asarray(jp2[k]),
                                       rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------
# run_experiment with token data on the spmd engine
# --------------------------------------------------------------------------

def _lm_spec(mod, optimizer, theta=0.55, steps=3):
    cfg = (jreg if mod is J else treg).get_config("qwen2-1.5b").replace(
        num_layers=2, d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
        d_ff=128, vocab_size=512, remat=False)
    sched = (jsched if mod is J else tsched).cosine(3e-4, warmup_steps=20,
                                                   total_steps=steps)
    return mod.ExperimentSpec(
        model=cfg,
        data=mod.DataSpec(dataset="lm", partition="iid", seq_len=32,
                          n_samples=C * 2 * 64, eval_samples=16),
        world=mod.WorldSpec(num_clients=C, profile="uniform"),
        strategy="cmfl",
        strategy_kwargs=dict(batch_size=2, lr=3e-4, theta=theta,
                             local_epochs=1, max_samples_per_round=2),
        engine="spmd", rounds=steps, seed=0, optimizer=optimizer,
        lr_schedule=sched)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_run_experiment_lm_matches_jax(optimizer):
    """``examples/federated_lm.py``'s spec (at its smoke size) on both
    packages from the JAX run's initial weights: records equal but loss
    and the -loss quality proxy, which agree within LOSS_RTOL."""
    jspec, tspec = _lm_spec(J, optimizer), _lm_spec(T, optimizer)
    want = J.run_experiment(jspec)
    jopt_ = {"adamw": jopt.adamw, "adafactor": jopt.adafactor}[optimizer]
    p0 = jax.device_get(jfl.init_state(jax.random.PRNGKey(0),
                                       jspec.resolve_model(),
                                       jopt_(3e-4)).params)
    got = T.run_experiment(tspec, device="cpu", params=p0)
    assert len(got.records) == len(want.records) == 3
    for g, w in zip(got.records, want.records):
        for f in parity.EXACT_FIELDS:
            assert getattr(g, f) == getattr(w, f), f
        for f in ("loss", "accuracy"):
            assert abs(getattr(g, f) - getattr(w, f)) <= \
                parity.LOSS_RTOL * abs(getattr(w, f)), f


def test_lm_spec_validates_as_jax_does():
    """Token data needs an iid partition (JAX's rule, its message); the
    same spec on the sim engine validates in both packages and builds on
    the port's."""
    for mod in (J, T):
        spec = dataclasses.replace(_lm_spec(mod, "adamw"),
                                   data=mod.DataSpec(dataset="lm",
                                                     partition="dirichlet"))
        with pytest.raises(ValueError, match="iid"):
            spec.build_world()
        dataclasses.replace(_lm_spec(mod, "adamw"), engine="sim").validate()
    sim = T.build_simulation(dataclasses.replace(_lm_spec(T, "adamw"),
                                                 engine="sim"), device="cpu")
    assert sim.cfg.family == "dense"
    assert set(sim.eval_arrays) == {"tokens", "labels"}
    assert treg.get_config("qwen2-1.5b") == T.ExperimentSpec(
        model="qwen2-1.5b").resolve_model()


# --------------------------------------------------------------------------
# launch/train.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--arch", "anomaly-mlp", "--steps", "3"],
    ["--arch", "qwen2-1.5b", "--smoke", "--steps", "3", "--clients", "2"],
    ["--arch", "granite-moe-1b-a400m", "--smoke", "--steps", "2",
     "--no-filter"],
    ["--arch", "internvl2-2b", "--smoke", "--steps", "2", "--seq", "32"],
])
def test_train_main_exits_0_on_the_cpu(argv, tmp_path, capsys):
    assert ttrain.main(argv + ["--device", "cpu", "--log-every", "1",
                               "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "loss=" in out and "done:" in out
    assert "checkpoints=1" in out


def test_train_batches_are_jax_s():
    """``make_batch_fn`` draws the JAX trainer's batches."""
    from repro.launch import train as jtrain
    for arch in ("anomaly-mlp", "internvl2-2b"):
        jc, tc = _cfgs(arch)
        jb = jtrain.make_batch_fn(jc, 2, 3, 16, seed=4)()
        tb = ttrain.make_batch_fn(tc, 2, 3, 16, seed=4, device="cpu")()
        assert sorted(jb) == sorted(tb)
        for k in jb:
            np.testing.assert_array_equal(tb[k].float().numpy(),
                                          np.asarray(jb[k], np.float32))


def test_train_refuses_the_audio_family():
    """The audio family's batches, once refused, are the JAX trainer's:
    tokens, labels and the stubbed frontend's frames ``enc_embeds``,
    drawn from the same Generator in the same order."""
    from repro.launch import train as jtrain
    jc, tc = _cfgs("whisper-tiny")
    jb = jtrain.make_batch_fn(jc, 2, 1, 16, seed=4)()
    tb = ttrain.make_batch_fn(tc, 2, 1, 16, seed=4, device="cpu")()
    assert sorted(tb) == sorted(jb) == ["enc_embeds", "labels", "tokens"]
    assert tb["enc_embeds"].shape == (2, 1, tc.encoder_seq, tc.d_model)
    for k in jb:
        np.testing.assert_array_equal(tb[k].float().numpy(),
                                      np.asarray(jb[k], np.float32))


def test_train_batches_default_to_the_card():
    """An entry point's helper: without a device its batches go to the
    card, and where there is none it says so."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: its batches go there")
    cfg = treg.get_config("anomaly-mlp", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.make_batch_fn(cfg, 2, 2, 16)
