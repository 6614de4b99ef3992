"""The port's moe and vlm families on the CPU against the JAX package,
from the same weights (JAX's carried across by ``lm_params_from_jax``)
and the same numpy inputs: configs, ``moe_ffn`` against both of JAX's
dispatch branches, prefill, decode, the ``loss_fn`` forward, ``serve_lm`` and the
launcher.

Tolerances, with their reasons:
  * f32 ``moe_ffn`` outputs within 1e-5 of max|out|, the aux within 1e-6
    relative: the router and expert products sum in another order in XLA
    and torch (a few f32 ulps of each product's scale, 2^-24 · d), and
    the aux is a mean of the same gates.
  * f32 model logits and caches within 1e-4 of their largest magnitude,
    as ``tests/test_torch_lm.py`` holds the dense family: each layer
    passes the difference on.
  * bf16 ``moe_ffn`` within ``_bf16_bound``: each package's value is
    within a bound of the exact function of the same bf16 inputs, built
    from the roundings that each step may take (derived there), so the
    two are within twice that.
  * routing (expert choices, kept flags, slots) equal under
    ``parity.routing_problems``, whose margin is derived from the two
    runs' router logits (``api/parity.py``).
  * decode against prefill within the port: rtol = atol = 2e-3, with
    capacity drops turned off, as ``tests/test_decode_consistency.py``.
  * greedy tokens equal where JAX's top-1/top-2 logit margin is at least
    1e-3 at every step (asserted), as ``tests/test_torch_lm.py``.
"""
import dataclasses
import functools
import math
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import registry as jreg
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models import moe as jmoe

from repro_torch.api import parity
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import moe
from repro_torch.models import transformer

ARCHS = ["granite-moe-1b-a400m", "arctic-480b", "internvl2-2b"]
MOE = ["granite-moe-1b-a400m", "arctic-480b"]
B, S = 2, 512
MARGIN = 1e-3
U_BF16 = 2.0 ** -8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: where several test workers share the machine,
    more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch, impl="full", dtype="float32", **kw):
    kw = dict(attention_impl=impl, dtype=dtype, **kw)
    return (jreg.get_config(arch, smoke=True).replace(**kw),
            treg.get_config(arch, smoke=True).replace(**kw))


@functools.lru_cache(maxsize=None)
def _jax_params(arch, dtype="float32"):
    jc, _ = _cfgs(arch, dtype=dtype)
    return jax.device_get(japi.init_params(jax.random.PRNGKey(0), jc))


def _inputs(cfg, batch, seq, seed=0):
    """Numpy inputs of ``seq`` positions: tokens, and for vlm the patch
    embeddings (N(0, 1)) in front of them."""
    rng = np.random.default_rng(seed)
    patches = cfg.num_patches if cfg.family == "vlm" else 0
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  size=(batch, seq - patches))}
    if patches:
        out["patch_embeds"] = rng.normal(
            size=(batch, patches, cfg.d_model)).astype(np.float32)
    return out


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _close(got, want, rel):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    gap = np.abs(got - want).max()
    assert gap <= rel * np.abs(want).max(), (gap, np.abs(want).max())


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch, smoke):
    tc, jc = treg.get_config(arch, smoke), jreg.get_config(arch, smoke)
    for f in dataclasses.fields(ArchConfig):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    for prop in ("hd", "padded_vocab", "q_groups"):
        assert getattr(tc, prop) == getattr(jc, prop)
    for active in (False, True):
        assert tc.param_count(active) == jc.param_count(active_only=active)
    assert treg.config_for_shape(arch, "long_500k", smoke) == \
        ArchConfig(**{f.name: getattr(jreg.config_for_shape(
            arch, "long_500k", smoke), f.name)
            for f in dataclasses.fields(ArchConfig)})


def test_registry_lists_the_moe_and_vlm_archs():
    assert set(ARCHS) <= set(treg.list_archs())
    assert treg.get_config("granite-moe-1b-a400m").param_count(True) == \
        478_993_408
    arctic = treg.get_config("arctic-480b")
    assert (arctic.num_experts, arctic.top_k, arctic.moe_dense_residual) == \
        (128, 2, True)


@pytest.mark.parametrize("arch", MOE)
def test_capacity_matches_jax(arch):
    tc, jc = treg.get_config(arch), jreg.get_config(arch)
    for tokens in (1, 4, 7, 512, 2048, 8192):
        assert moe.capacity(tc, tokens) == jmoe.capacity(jc, tokens)
    if arch == "granite-moe-1b-a400m":
        # the full-width serve: prefill T = 4 · 2048, decode T = 4
        assert moe.capacity(tc, 8192) == 2560 and moe.capacity(tc, 4) == 4


# --------------------------------------------------------------------------
# moe_ffn against the JAX package
# --------------------------------------------------------------------------

def _jax_routing(jc, router, x):
    """The routing of the JAX package's ``moe_ffn`` (models/moe.py, from
    the router's softmax to the slots), step for step."""
    xt = jnp.asarray(x).reshape(-1, jc.d_model)
    T, E, k = xt.shape[0], jc.num_experts, jc.top_k
    C = jmoe.capacity(jc, T)
    logits = xt.astype(jnp.float32) @ jnp.asarray(router)
    gates = jax.nn.softmax(logits, axis=-1)
    _, topi = jax.lax.top_k(gates, k)
    flat_e = topi.reshape(T * k)
    mask = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.cumsum(mask, axis=0) - mask
    flat_pos = jnp.take_along_axis(pos, flat_e[:, None], axis=1)[:, 0]
    keep = flat_pos < C
    slot = jnp.where(keep, flat_e * C + flat_pos, E * C)
    return types.SimpleNamespace(**{n: np.asarray(v) for n, v in dict(
        logits=logits, topi=topi, keep=keep, slot=slot).items()})


def _moe_case(arch, dtype, seed=0, tokens=(2, 16), **kw):
    jc, tc = _cfgs(arch, dtype=dtype, **kw)
    jp = jax.device_get(jmoe.moe_params(jc, jax.random.PRNGKey(seed),
                                        jc.compute_dtype))
    x = np.random.default_rng(seed).normal(
        size=tokens + (jc.d_model,)).astype(np.float32)
    jx = jnp.asarray(x, jc.compute_dtype)
    tx = torch.as_tensor(x).to(tc.compute_dtype)
    return jc, tc, jp, jx, tx


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("dispatch", ["gather", "scatter"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_matches_jax(arch, dispatch, capacity_factor):
    """arctic carries the dense residual, granite-moe does not; a capacity
    factor of 0.5 overflows every expert's buffer."""
    jc, tc, jp, jx, tx = _moe_case(arch, "float32", moe_dispatch=dispatch,
                                   capacity_factor=capacity_factor)
    want, want_aux = jmoe.moe_ffn(jc, jp, jx)
    p = lm_params_from_jax(jp, device="cpu")
    assert ("dense" in p) == tc.moe_dense_residual
    got, aux = moe.moe_ffn(tc, p, tx)
    assert got.shape == tx.shape and aux.dtype == torch.float32
    _close(got, want, 1e-5)
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * abs(float(want_aux))
    r = moe.route(tc, p["router"], tx.reshape(-1, tc.d_model))
    assert parity.routing_problems(
        [r], [_jax_routing(jc, jp["router"], jx)]) == []
    if capacity_factor < 1:
        assert not r.keep.all()
    assert int(r.load.sum()) == r.keep.numel()


@pytest.mark.parametrize("arch", MOE)
def test_dispatch_branches_agree_by_bits(arch):
    """Both of the JAX package's ``moe_dispatch`` values are accepted and
    compute one function (unsharded, one path serves both); any other
    value is refused."""
    _, tc, jp, _, tx = _moe_case(arch, "float32", capacity_factor=0.5)
    p = lm_params_from_jax(jp, device="cpu")
    gather, aux_g = moe.moe_ffn(tc, p, tx)
    scatter, aux_s = moe.moe_ffn(tc.replace(moe_dispatch="scatter"), p, tx)
    assert torch.equal(gather, scatter) and torch.equal(aux_g, aux_s)
    with pytest.raises(ValueError, match="moe_dispatch"):
        moe.moe_ffn(tc.replace(moe_dispatch="dense"), p, tx)


def _bf16_bound(cfg, p, x, r):
    """The largest |out − out'| two bf16 evaluations of ``moe_ffn`` on the
    same bf16 inputs may show, element by element, given one routing r.

    Each package's value lies within E of the exact function of its
    inputs, so the two lie within 2E. E follows the steps, each an f32
    computation rounded to bf16 (u = 2^-8) once or, in XLA, once per
    operation: a product of n terms summed in f32 is within γ_n·Σ|terms|
    of exact (γ_n = n·2^-24/(1 − n·2^-24)) and rounds once; silu (Lipschitz
    1.1) rounds up to twice (x·sigmoid(x)) and takes its input's error
    times 1.1; the product with the up projection rounds once; each
    choice's weight is the f32 gate rounded to bf16 (its f32 value a few
    ulps apart in the two packages, so up to one bf16 ulp apart), its
    product with the expert output rounds once, and the k products are
    summed with up to k roundings; the dense residual, where present,
    takes the same bound with weight 1 and one more rounding for the
    add. Exact values are taken in f64 from the bf16 inputs."""
    f64 = torch.float64
    T, d = x.shape
    k, C = cfg.top_k, r.capacity
    g = lambda n: n * 2.0 ** -24 / (1 - n * 2.0 ** -24)    # noqa: E731

    def swiglu(xin, wg, wu, wd):
        a1, a2 = xin @ wg, xin @ wu
        e1 = U_BF16 * a1.abs() + g(d) * (xin.abs() @ wg.abs())
        e2 = U_BF16 * a2.abs() + g(d) * (xin.abs() @ wu.abs())
        s = torch.nn.functional.silu(a1)
        es = 1.1 * e1 + 2 * U_BF16 * (s.abs() + 1.1 * e1)
        h = s * a2
        eh = (s.abs() + es) * e2 + a2.abs() * es + U_BF16 * (
            (s.abs() + es) * (a2.abs() + e2))
        y = h @ wd
        ey = eh @ wd.abs() + g(h.shape[-1]) * ((h.abs() + eh) @ wd.abs())
        return y, ey + U_BF16 * (y.abs() + ey)

    xe = moe.dispatch(cfg, x, r).to(f64)                   # (E, C, d)
    y, ey = swiglu(xe, p["wg"].to(f64), p["wu"].to(f64), p["wd"].to(f64))
    slot = torch.clamp_max(r.slot, y.shape[0] * C - 1)
    y = y.reshape(-1, d)[slot].reshape(T, k, d).abs()
    ey = ey.reshape(-1, d)[slot].reshape(T, k, d)
    w = (r.topv.reshape(T * k) * r.keep).to(f64).reshape(T, k, 1).abs()
    terms = w * (y + ey)
    bound = (w * ey + 2 * U_BF16 * terms).sum(1) + k * U_BF16 * terms.sum(1)
    if cfg.moe_dense_residual:
        dp = p["dense"]
        yd, eyd = swiglu(x.to(f64), dp["wg"].to(f64), dp["wu"].to(f64),
                         dp["wd"].to(f64))
        out = terms.sum(1) + yd.abs() + eyd
        bound = bound + eyd + U_BF16 * (out + bound)
    return 2 * bound


@pytest.mark.parametrize("dispatch", ["gather", "scatter"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_bf16_within_the_rounding_bound(arch, dispatch):
    jc, tc, jp, jx, tx = _moe_case(arch, "bfloat16", moe_dispatch=dispatch,
                                   capacity_factor=0.5)
    p = lm_params_from_jax(jp, device="cpu")
    assert p["router"].dtype == torch.float32
    assert p["wg"].dtype == torch.bfloat16
    want, want_aux = jmoe.moe_ffn(jc, jp, jx)
    got, aux = moe.moe_ffn(tc, p, tx)
    assert got.dtype == torch.bfloat16
    xt = tx.reshape(-1, tc.d_model)
    r = moe.route(tc, p["router"], xt)
    assert parity.routing_problems(
        [r], [_jax_routing(jc, jp["router"], jx)]) == []
    bound = _bf16_bound(tc, p, xt, r).reshape(got.shape).numpy()
    gap = np.abs(got.to(torch.float32).numpy()
                 - np.asarray(want, np.float32))
    assert (gap <= bound).all(), (gap.max(), (gap - bound).max())
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * abs(float(want_aux))


def test_top_k_orders_ties_as_jax():
    """Equal gates: the lower expert first, as ``jax.lax.top_k``."""
    rng = np.random.default_rng(0)
    gates = rng.integers(0, 3, size=(64, 8)).astype(np.float32) / 4
    gates[0] = 0.5                                  # all eight tied
    want_v, want_i = jax.lax.top_k(jnp.asarray(gates), 3)
    v, i = moe.top_k(torch.as_tensor(gates), 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(v.numpy(), np.asarray(want_v))
    assert i[0].tolist() == [0, 1, 2]
    # a zero router gives every expert the same gate: experts 0..k-1
    _, tc, jp, _, tx = _moe_case("granite-moe-1b-a400m", "float32")
    r = moe.route(tc, torch.zeros_like(lm_params_from_jax(
        jp, device="cpu")["router"]), tx.reshape(-1, tc.d_model))
    assert (r.topi == torch.arange(tc.top_k)).all()


def test_routing_problems_name_flips_and_near_ties():
    _, tc, jp, _, tx = _moe_case("granite-moe-1b-a400m", "float32")
    p = lm_params_from_jax(jp, device="cpu")
    xt = tx.reshape(-1, tc.d_model)
    r = moe.route(tc, p["router"], xt)
    assert parity.routing_problems([r], [r]) == []
    assert parity.routing_problems([r], [r, r]) == [
        "1 routed calls against 2"]
    # the order of a token's choices is not a decision; another expert,
    # another slot or another kept flag at equal logits is a fault
    swapped = r._replace(topi=r.topi.flip(1), keep=r.keep.reshape(
        -1, tc.top_k).flip(1).reshape(-1), slot=r.slot.reshape(
        -1, tc.top_k).flip(1).reshape(-1))
    assert parity.routing_problems([swapped], [r]) == []
    topi = r.topi.clone()
    topi[3, 0] = next(e for e in range(tc.num_experts) if e not in topi[3])
    assert parity.routing_problems([r._replace(topi=topi)], [r]) == [
        "call 0: topi differs at tokens [3]"]
    slot = r.slot.clone()
    slot[2 * tc.top_k + 1] += 1
    keep = r.keep.clone()
    keep[7 * tc.top_k] ^= True
    assert parity.routing_problems([r._replace(slot=slot, keep=keep)],
                                   [r]) == [
        "call 0: keep differs at tokens [7]",
        "call 0: slot differs at tokens [2]"]
    # logits moved by more than the k-th gap: that token's routing is not
    # reproducible, and the check names it
    z = r.logits.clone()
    top = torch.sort(z[5], descending=True).values
    z[5] += (top[tc.top_k - 1] - top[tc.top_k]).abs()
    problems = parity.routing_problems([r._replace(logits=z)], [r])
    assert len(problems) == 1 and problems[0].startswith("call 0 token 5:")


# --------------------------------------------------------------------------
# the model: prefill, decode, loss
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_prefill(arch, impl):
    jc, _ = _cfgs(arch, impl)
    logits, cache = japi.prefill(_jax_params(arch),
                                 _jax_batch(_inputs(jc, B, S)), jc)
    return jax.device_get((logits, cache))


def test_moe_and_vlm_trees_convert():
    """The JAX trees arrive whole: an f32 router beside bf16 experts, the
    dense residual and the patch projection, with the port's own tree's
    names, shapes and dtypes."""
    for arch in ARCHS:
        jp = _jax_params(arch, "bfloat16")
        p = lm_params_from_jax(jp, device="cpu")
        _, tc = _cfgs(arch, dtype="bfloat16")
        own = transformer.init_params(torch.Generator().manual_seed(0), tc)
        got, mine = _flat(p), _flat(own)
        assert got.keys() == mine.keys()
        for name, t in got.items():
            assert (t.shape, t.dtype) == (mine[name].shape,
                                          mine[name].dtype), name
            np.testing.assert_array_equal(t.to(torch.float32).numpy(),
                                          np.asarray(_get(jp, name),
                                                     np.float32))
        if tc.num_experts:
            assert got["layers/moe/router"].dtype == torch.float32
            assert got["layers/moe/wg"].dtype == torch.bfloat16
        assert ("layers/moe/dense/wg" in got) == tc.moe_dense_residual
        assert ("patch_proj" in got) == (tc.family == "vlm")


def _flat(tree, prefix=""):
    """{"a/b/c": leaf} of a nested dict."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    return {k: v for n, sub in tree.items()
            for k, v in _flat(sub, prefix + n + "/").items()}


def _get(tree, name):
    for part in name.split("/"):
        tree = tree[part]
    return tree


@pytest.mark.parametrize("impl", ["full", "blockwise"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, impl):
    jc, tc = _cfgs(arch, impl)
    want_logits, want_cache = _jax_prefill(arch, impl)
    params = lm_params_from_jax(_jax_params(arch), device="cpu")
    logits, cache = tapi.prefill(params, _torch_batch(_inputs(jc, B, S)), tc)
    assert logits.shape == (B, S, tc.padded_vocab) and cache["step"] == S
    _close(logits, want_logits, 1e-4)
    for name in ("k", "v"):
        _close(cache[name], want_cache[name], 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_aux_and_loss_match_jax(arch):
    jc, tc = _cfgs(arch, "blockwise")
    batch = _inputs(jc, B, S, seed=1)
    batch["labels"] = np.random.default_rng(2).integers(
        0, jc.vocab_size, size=batch["tokens"].shape)
    jp = _jax_params(arch)
    params = lm_params_from_jax(jp, device="cpu")
    _, _, want_aux = japi.module_for(jc).forward(jp, _jax_batch(batch), jc)
    _, _, aux = transformer.forward(params, _torch_batch(batch), tc)
    assert aux.dtype == torch.float32
    if tc.num_experts:
        # one Switch term a layer, each at least 1 (Cauchy-Schwarz)
        assert float(aux) >= tc.num_layers * (1 - 1e-6)
        assert abs(float(aux) - float(want_aux)) <= 1e-5 * float(want_aux)
    else:
        assert float(aux) == float(want_aux) == 0.0
    want = japi.loss_fn(jp, _jax_batch(batch), jc)
    got = tapi.loss_fn(params, _torch_batch(batch), tc)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


def _graft(api, cfg, cache, total, **kw):
    full = api.init_cache(cfg, B, total, **kw)
    for n in ("k", "v"):
        if isinstance(full[n], torch.Tensor):
            full[n][:, :, :cache[n].shape[2]] = cache[n]
        else:
            full[n] = jax.lax.dynamic_update_slice(
                full[n], jnp.asarray(cache[n]).astype(full[n].dtype),
                (0,) * full[n].ndim)
    full["step"] = cache["k"].shape[2]
    return full


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax(arch):
    """Four decode steps after the graft, both fed JAX's greedy tokens
    (T = B = 2 a step: capacity 4, nothing dropped)."""
    jc, tc = _cfgs(arch, "blockwise")
    logits, cache = _jax_prefill(arch, "blockwise")
    total = S + 4
    jcache = _graft(japi, jc, cache, total)
    jcache["step"] = jnp.asarray(S, jnp.int32)
    params = lm_params_from_jax(_jax_params(arch), device="cpu")
    _, tcache = tapi.prefill(params, _torch_batch(_inputs(jc, B, S)), tc)
    tcache = _graft(tapi, tc, tcache, total, device="cpu")
    tok = np.asarray(jnp.argmax(logits[:, -1:], axis=-1))
    for _ in range(4):
        want, jcache = japi.decode_step(_jax_params(arch), jcache,
                                        {"tokens": jnp.asarray(tok)}, jc)
        got, tcache = tapi.decode_step(params, tcache,
                                       {"tokens": torch.tensor(tok)}, tc)
        _close(got, want, 1e-4)
        tok = np.asarray(jnp.argmax(want[:, -1:], axis=-1))
    assert tcache["step"] == total and int(jcache["step"]) == total


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """The port's own consistency, as tests/test_decode_consistency.py:
    capacity drops depend on the batch's other tokens, so they are turned
    off (capacity factor 100) and prefill and decode route alike."""
    _, cfg = _cfgs(arch, capacity_factor=100.0)
    n = 12 + (cfg.num_patches if cfg.family == "vlm" else 0)
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    full = _torch_batch(_inputs(cfg, B, n))
    logits_full, _ = tapi.prefill(params, full, cfg)
    prefix = dict(full, tokens=full["tokens"][:, :-1])
    _, cache = tapi.prefill(params, prefix, cfg)
    cache = _graft(tapi, cfg, cache, n, device="cpu")
    logits_step, new = tapi.decode_step(
        params, cache, {"tokens": full["tokens"][:, -1:]}, cfg)
    np.testing.assert_allclose(logits_step[:, 0].numpy(),
                               logits_full[:, -1].numpy(), rtol=2e-3,
                               atol=2e-3)
    assert new["step"] == n


# --------------------------------------------------------------------------
# serve_lm and the launcher
# --------------------------------------------------------------------------

def _jax_margins(jc, params, prompt_len, steps):
    """JAX's greedy loop as ``serve_lm`` runs it (its prompt: zero patches
    for vlm), eager, with the top-1/top-2 margin at each step."""
    rng = np.random.default_rng(0)
    patches = jc.num_patches if jc.family == "vlm" else 0
    batch = {"tokens": jnp.asarray(rng.integers(
        0, jc.vocab_size, size=(B, prompt_len - patches)))}
    if patches:
        batch["patch_embeds"] = jnp.zeros((B, patches, jc.d_model),
                                          jc.compute_dtype)
    logits, cache = japi.prefill(params, batch, jc)
    cache = _graft(japi, jc, cache, prompt_len + steps)
    cache["step"] = jnp.asarray(prompt_len, jnp.int32)
    margins, toks = [], []
    for i in range(steps + 1):
        top2 = np.sort(np.asarray(logits[:, -1], np.float32), axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        if i < steps:
            logits, cache = japi.decode_step(params, cache, {"tokens": tok}, jc)
    return np.stack(margins, axis=1), np.concatenate(toks, axis=1)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "internvl2-2b"])
def test_serve_lm_matches_jax(arch, capsys):
    jc, tc = _cfgs(arch, "blockwise")
    steps = 4
    want = np.asarray(jserve.serve_lm(jc, B, S, steps, seed=0))
    margins, eager = _jax_margins(jc, _jax_params(arch), S, steps)
    np.testing.assert_array_equal(eager, want)
    near = [(b, i) for b in range(B) for i in range(steps + 1)
            if margins[b, i] < MARGIN]
    assert not near, f"JAX's top-2 margin is below {MARGIN} at (row, step) " \
                     f"{near}: greedy tokens are not reproducible there"
    got = tserve.serve_lm(tc, B, S, steps, seed=0, device="cpu",
                          params=lm_params_from_jax(_jax_params(arch),
                                                    device="cpu"))
    assert got.shape == (B, 1 + steps)
    np.testing.assert_array_equal(got.numpy(), want)
    assert re.search(rf"prefill: {B}x{S} in .*decode: {steps} steps",
                     capsys.readouterr().out)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "internvl2-2b"])
def test_serve_main_runs_a_smoke_moe_and_vlm_arch_on_the_cpu(arch, capsys):
    assert tserve.main(["--arch", arch, "--smoke", "--batch", "1",
                        "--prompt-len", "512", "--decode-steps", "2",
                        "--attention-impl", "blockwise",
                        "--device", "cpu"]) == 0
    assert "prefill: 1x512" in capsys.readouterr().out


def test_vlm_prompt_counts_its_patches(monkeypatch):
    """serve_lm's vlm prompt: prompt_len − num_patches tokens behind
    num_patches zero embeddings, and the decode starts at prompt_len."""
    _, tc = _cfgs("internvl2-2b")
    seen = {}
    prefill, decode = transformer.prefill, transformer.decode_step

    def spy_prefill(params, batch, cfg):
        seen["batch"] = batch
        return prefill(params, batch, cfg)

    def spy_decode(params, cache, batch, cfg):
        seen.setdefault("step", cache["step"])
        return decode(params, cache, batch, cfg)

    monkeypatch.setattr(transformer, "prefill", spy_prefill)
    monkeypatch.setattr(transformer, "decode_step", spy_decode)
    tserve.serve_lm(tc, 1, 40, 1, device="cpu")
    batch = seen["batch"]
    assert batch["tokens"].shape == (1, 40 - tc.num_patches)
    assert batch["patch_embeds"].shape == (1, tc.num_patches, tc.d_model)
    assert not batch["patch_embeds"].any() and seen["step"] == 40
    np.testing.assert_array_equal(batch["tokens"].numpy(), np.random.default_rng(
        0).integers(0, tc.vocab_size, size=(1, 40 - tc.num_patches)))
