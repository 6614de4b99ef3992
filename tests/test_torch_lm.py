"""The port's LM serving path for the dense family on the CPU against the
JAX package, from the same weights (JAX's ``init_params`` carried across
by ``lm_params_from_jax``) and the same numpy prompts: configs, prefill,
decode, ``serve_lm``, and what the port refuses.

Tolerances, with their reasons:
  * f32 logits within 1e-4 of max|logit|: matmuls sum in another order
    in XLA and torch, and each layer passes the difference on.
  * f32 v caches within the bound of their projection's reduction
    (``_v_bound``: 2·γ_n of Σ_k |x_k·W_kj| + |b_j| element by element,
    n the fan-in); k caches within 1e-5 plus max|k| times one
    f32 ulp of the largest rotary angle (S − 1 radians). XLA's fused
    rotary (the prefill runs under ``lax.scan``) is about one ulp of the
    angle off: 2.6e-5 from an f64 reference at S = 512, where JAX's eager
    rotary and the port's are 3.7e-7 off.
  * bf16 logits within 3e-2 of max|logit|, the JAX package's own bf16
    tolerance (``tests/test_flash_attn.py``).
  * decode against prefill within the port: rtol = atol = 2e-3, as
    ``tests/test_decode_consistency.py``.
  * greedy tokens equal, where JAX's top-1/top-2 logit margin is at least
    1e-3 at every step (asserted, naming row and step): a near-tie is not
    reproducible across implementations.
"""
import dataclasses
import functools
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import registry as jreg
from repro.core import fl_step as jfl
from repro.launch import serve as jserve
from repro.models import api as japi

from repro_torch.configs import registry as treg
from repro_torch.configs import shapes as tshapes
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.core import fl_step as tfl
from repro_torch.kernels import flash_attn as tfa
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer

DENSE = ["qwen2-1.5b", "stablelm-1.6b", "phi3-mini-3.8b", "granite-34b"]
B, S = 2, 512
MARGIN = 1e-3


def _cfgs(arch, impl="full", dtype="float32"):
    kw = dict(attention_impl=impl, dtype=dtype)
    return (jreg.get_config(arch, smoke=True).replace(**kw),
            treg.get_config(arch, smoke=True).replace(**kw))


@functools.lru_cache(maxsize=None)
def _jax_params(arch, dtype="float32"):
    jc, _ = _cfgs(arch, dtype=dtype)
    return jax.device_get(japi.init_params(jax.random.PRNGKey(0), jc))


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


def _close_logits(got, want, rel):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    gap = np.abs(got - want).max()
    assert gap <= rel * np.abs(want).max(), (gap, np.abs(want).max())


def _v_bound(cfg, params, tokens):
    """The largest |v − v'| two f32 evaluations of the prefill may put
    between their v caches, element by element: (L, B, S, K, hd).

    Each element is v_j = Σ_{k<n} x_k·W_kj + b_j over the fan-in n =
    d_model, x the layer's normed input. A sum of n terms evaluated in
    f32 in any order (XLA's and MKL's blocked GEMMs, with or without FMA)
    is within γ_n·Σ_k |x_k·W_kj| of the exact sum, γ_n = n·u / (1 − n·u)
    and u = 2^-24 (Higham, Accuracy and Stability of Numerical
    Algorithms, 2nd ed., §3.1), and the bias adds one rounding more: so
    two evaluations lie within 2·γ_{n+1}·(Σ_k |x_k·W_kj| + |b_j|) of each
    other. The scale is taken from the port's own forward. From the second
    layer on, x itself carries the earlier layers' roundings; on the four
    smoke configs the gap is at most 19 u of the scale there (4 u in the
    first layer), far inside 2·γ_{n+1} (514 u at n = 256), and a weight
    of W_v moved by 1e-3 moves v by |x_k|·1e-3, beyond it."""
    x = params["embed"][tokens]
    S = x.shape[1]
    positions = torch.arange(S)[None, :]
    n = cfg.d_model + 1
    gamma = n * 2.0 ** -24 / (1 - n * 2.0 ** -24)
    out = []
    for i in range(cfg.num_layers):
        lp = transformer._layer(params["layers"], i)
        a_in = tlayers.apply_norm(cfg, x, lp["ln1"])
        scale = a_in.abs() @ lp["attn"]["wv"].abs()
        if "bv" in lp["attn"]:
            scale = scale + lp["attn"]["bv"].abs()
        out.append(2 * gamma * scale.reshape(
            x.shape[0], S, cfg.num_kv_heads, cfg.hd))
        a_out, _ = tlayers.full_attention(
            cfg, lp["attn"], a_in, positions=positions, causal=True,
            sliding_window=cfg.sliding_window)
        x = x + a_out
        x = x + tlayers.ffn(cfg, lp["ffn"],
                            tlayers.apply_norm(cfg, x, lp["ln2"]))
    return torch.stack(out).numpy()


def _close_cache(got, want, seq, v_bound):
    g, w = got["v"].numpy(), np.asarray(want["v"])
    assert g.shape == w.shape == v_bound.shape
    beyond = np.abs(g - w) > v_bound
    assert not beyond.any(), ("v", int(beyond.sum()), np.abs(g - w).max())
    angle_ulp = 2.0 ** (math.floor(math.log2(seq - 1)) - 23)
    g, w = got["k"].numpy(), np.asarray(want["k"])
    assert g.shape == w.shape
    tol = 1e-5 + angle_ulp * np.abs(w).max()
    assert np.abs(g - w).max() <= tol, ("k", np.abs(g - w).max(), tol)


@functools.lru_cache(maxsize=None)
def _jax_prefill(arch, impl):
    jc, _ = _cfgs(arch, impl)
    logits, cache = jfl.build_prefill_step(jc)(
        _jax_params(arch), {"tokens": jnp.asarray(_tokens(jc.vocab_size,
                                                          (B, S)))})
    return jax.device_get((logits, cache))


def _graft_jax(jc, cache, total):
    full = japi.init_cache(jc, B, total)
    out = {n: jax.lax.dynamic_update_slice(full[n], cache[n].astype(
        full[n].dtype), (0,) * full[n].ndim) for n in ("k", "v")}
    out["step"] = jnp.asarray(cache["k"].shape[2], jnp.int32)
    return out


def _graft_torch(tc, cache, total):
    full = tapi.init_cache(tc, B, total, device="cpu")
    for n in ("k", "v"):
        full[n][:, :, :cache[n].shape[2]] = cache[n]
    full["step"] = cache["step"]
    return full


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", DENSE + ["anomaly-mlp"])
def test_configs_match_jax(arch, smoke):
    tc, jc = treg.get_config(arch, smoke), jreg.get_config(arch, smoke)
    for f in dataclasses.fields(ArchConfig):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    for prop in ("hd", "padded_vocab", "q_groups"):
        assert getattr(tc, prop) == getattr(jc, prop)
    assert tc.compute_dtype == getattr(torch, jc.compute_dtype.name)
    assert tc.param_count() == jc.param_count()
    assert treg.config_for_shape(arch, "long_500k", smoke) == \
        ArchConfig(**{f.name: getattr(jreg.config_for_shape(
            arch, "long_500k", smoke), f.name)
            for f in dataclasses.fields(ArchConfig)})


def test_registry_and_shapes():
    assert treg.list_archs() == sorted(
        DENSE + ["anomaly-mlp", "granite-moe-1b-a400m", "internvl2-2b",
                 "arctic-480b", "rwkv6-7b", "hymba-1.5b", "whisper-tiny"])
    assert treg.list_archs() == jreg.list_archs()
    assert treg.get_config("qwen2-1.5b").param_count() == 1_777_088_000
    from repro.configs import shapes as jshapes
    assert tshapes.SHAPES.keys() == jshapes.SHAPES.keys()
    for name in jshapes.SHAPES:
        assert dataclasses.asdict(tshapes.SHAPES[name]) == \
            dataclasses.asdict(jshapes.SHAPES[name])
        assert dataclasses.asdict(tshapes.SMOKE_SHAPES[name]) == \
            dataclasses.asdict(jshapes.SMOKE_SHAPES[name])


# --------------------------------------------------------------------------
# prefill and decode against JAX
# --------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["full", "blockwise"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_matches_jax(arch, impl):
    jc, tc = _cfgs(arch, impl)
    want_logits, want_cache = _jax_prefill(arch, impl)
    params = lm_params_from_jax(_jax_params(arch), device="cpu")
    toks = torch.as_tensor(_tokens(jc.vocab_size, (B, S)))
    logits, cache = tfl.build_prefill_step(tc)(params, {"tokens": toks})
    assert logits.shape == (B, S, tc.padded_vocab)
    assert cache["step"] == S
    _close_logits(logits, want_logits, 1e-4)
    _close_cache(cache, want_cache, S, _v_bound(tc, params, toks))


def test_prefill_matches_jax_bf16():
    jc, tc = _cfgs("qwen2-1.5b", "blockwise", "bfloat16")
    jp = _jax_params("qwen2-1.5b", "bfloat16")
    params = lm_params_from_jax(jp, device="cpu")
    assert params["embed"].dtype == torch.bfloat16
    assert torch.equal(params["embed"].to(torch.float32),
                       torch.from_numpy(np.asarray(jp["embed"], np.float32)))
    toks = _tokens(jc.vocab_size, (B, S))
    want, _ = japi.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    got, cache = tapi.prefill(params, {"tokens": torch.as_tensor(toks)}, tc)
    assert got.dtype == torch.bfloat16 and cache["k"].dtype == torch.bfloat16
    _close_logits(got.to(torch.float32), want, 3e-2)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_jax(arch):
    """Four decode steps after the graft, both fed JAX's greedy tokens."""
    jc, tc = _cfgs(arch, "blockwise")
    logits, cache = _jax_prefill(arch, "blockwise")
    total = S + 4
    jcache = _graft_jax(jc, jax.tree.map(jnp.asarray, cache), total)
    params = lm_params_from_jax(_jax_params(arch), device="cpu")
    _, tcache = tapi.prefill(params, {"tokens": torch.as_tensor(
        _tokens(jc.vocab_size, (B, S)))}, tc)
    tcache = _graft_torch(tc, tcache, total)
    step = tfl.build_serve_step(tc)
    tok = np.asarray(jnp.argmax(logits[:, -1:], axis=-1))
    for _ in range(4):
        want, jcache = jfl.build_serve_step(jc)(
            _jax_params(arch), jcache, {"tokens": jnp.asarray(tok)})
        got, tcache = step(params, tcache, {"tokens": torch.tensor(tok)})
        _close_logits(got, want, 1e-4)
        tok = np.asarray(jnp.argmax(want[:, -1:], axis=-1))
    assert tcache["step"] == total and int(jcache["step"]) == total


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_prefill(arch):
    """The port's own consistency, as tests/test_decode_consistency.py."""
    _, cfg = _cfgs(arch)
    n = 12
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    full = torch.as_tensor(_tokens(cfg.vocab_size, (B, n)))
    logits_full, _ = tapi.prefill(params, {"tokens": full}, cfg)
    _, cache = tapi.prefill(params, {"tokens": full[:, :-1]}, cfg)
    cache = _graft_torch(cfg, cache, n)
    logits_step, new = tapi.decode_step(params, cache, {"tokens": full[:, -1:]},
                                        cfg)
    np.testing.assert_allclose(logits_step[:, 0].numpy(),
                               logits_full[:, -1].numpy(), rtol=2e-3,
                               atol=2e-3)
    # the old cache stays as it was (a new cache is returned, as in JAX)
    assert cache["step"] == n - 1 and not cache["k"][:, :, n - 1].any()
    assert new["step"] == n and new["k"][:, :, n - 1].any()


def test_sliding_window_decode_matches_jax():
    """The cyclic cache: a window of 8 over a 12-token prompt and four
    decode steps (blockwise falls back to the dense path below 512)."""
    arch = "qwen2-1.5b"
    jc, tc = _cfgs(arch)
    jc, tc = jc.replace(sliding_window=16), tc.replace(sliding_window=16)
    params = lm_params_from_jax(_jax_params(arch), device="cpu")
    toks = _tokens(jc.vocab_size, (B, 12))
    want, jcache = japi.prefill(_jax_params(arch), {"tokens": jnp.asarray(toks)},
                                jc)
    got, tcache = tapi.prefill(params, {"tokens": torch.as_tensor(toks)}, tc)
    _close_logits(got, want, 1e-4)
    jcache = _graft_jax(jc, jcache, 20)
    tcache = _graft_torch(tc, tcache, 20)
    assert tcache["k"].shape[2] == 16
    tok = np.asarray(jnp.argmax(want[:, -1:], axis=-1))
    for _ in range(8):                   # wraps the 16-slot cache
        want, jcache = japi.decode_step(_jax_params(arch), jcache,
                                        {"tokens": jnp.asarray(tok)}, jc)
        got, tcache = tapi.decode_step(params, tcache,
                                       {"tokens": torch.tensor(tok)}, tc)
        _close_logits(got, want, 1e-4)
        tok = np.asarray(jnp.argmax(want[:, -1:], axis=-1))


# --------------------------------------------------------------------------
# serve_lm end to end
# --------------------------------------------------------------------------

def _jax_margins(jc, params, prompt_len, steps):
    """JAX's greedy loop, eager, with the top-1/top-2 margin at each step."""
    logits, cache = japi.prefill(params, {"tokens": jnp.asarray(
        _tokens(jc.vocab_size, (B, prompt_len)))}, jc)
    cache = _graft_jax(jc, cache, prompt_len + steps)
    margins, toks = [], []
    for i in range(steps + 1):
        last = np.asarray(logits[:, -1], np.float32)
        top2 = np.sort(last, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        if i < steps:
            logits, cache = japi.decode_step(params, cache, {"tokens": tok}, jc)
    return np.stack(margins, axis=1), np.concatenate(toks, axis=1)


def test_serve_lm_matches_jax(capsys):
    jc, tc = _cfgs("qwen2-1.5b", "blockwise")
    steps = 4
    want = np.asarray(jserve.serve_lm(jc, B, S, steps, seed=0))
    margins, eager = _jax_margins(jc, _jax_params("qwen2-1.5b"), S, steps)
    np.testing.assert_array_equal(eager, want)
    near = [(b, i) for b in range(B) for i in range(steps + 1)
            if margins[b, i] < MARGIN]
    assert not near, f"JAX's top-2 margin is below {MARGIN} at (row, step) " \
                     f"{near}: greedy tokens are not reproducible there"
    got = tserve.serve_lm(tc, B, S, steps, seed=0, device="cpu",
                          params=lm_params_from_jax(_jax_params("qwen2-1.5b"),
                                                    device="cpu"))
    assert got.shape == (B, 1 + steps)
    np.testing.assert_array_equal(got.numpy(), want)
    assert re.search(r"prefill: 2x512 in .*decode: 4 steps",
                     capsys.readouterr().out)


def test_serve_main_runs_a_smoke_arch_on_the_cpu(capsys):
    assert tserve.main(["--arch", "granite-34b", "--smoke", "--batch", "1",
                        "--prompt-len", "512", "--decode-steps", "2",
                        "--attention-impl", "blockwise",
                        "--device", "cpu"]) == 0
    assert "decode: 2 steps" in capsys.readouterr().out


# --------------------------------------------------------------------------
# what the port refuses
# --------------------------------------------------------------------------

UNPORTED = {"rwkv6-7b": "ssm", "hymba-1.5b": "hybrid",
            "whisper-tiny": "audio"}


@pytest.mark.parametrize("arch", sorted(UNPORTED))
def test_unported_families_are_refused(arch):
    """The ssm, hybrid and audio families, once refused everywhere, run
    through ``models/api.py`` (their own modules); the transformer still
    refuses them, naming the module that runs each."""
    cfg = treg.get_config(arch, smoke=True)
    assert cfg.family == UNPORTED[arch]
    module = {"ssm": "rwkv6", "hybrid": "hybrid", "audio": "whisper"}[
        cfg.family]
    assert tapi.module_for(cfg).__name__ == f"repro_torch.models.{module}"
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int64)}
    for call in (lambda: transformer.prefill({}, batch, cfg),
                 lambda: transformer.init_params(torch.Generator(), cfg),
                 lambda: transformer.init_cache(cfg, 1, 8)):
        with pytest.raises(NotImplementedError,
                           match=f"repro_torch.models.{module} runs it"):
            call()
    assert cfg.param_count() == jreg.get_config(arch, smoke=True
                                                ).param_count()


def test_serving_the_detector_is_refused():
    """The mlp family's prefill is refused, naming the detector's server;
    the launcher's mlp branch serves through it instead of refusing."""
    assert tserve.main(["--arch", "anomaly-mlp", "--device", "cpu",
                        "--requests", "16"]) == 0
    cfg = treg.get_config("anomaly-mlp")
    with pytest.raises(NotImplementedError, match="repro_torch.serve"):
        tapi.prefill({}, {"x": torch.zeros((1, 49))}, cfg)


def test_blockwise_branch_takes_the_kernel_wrapper_on_the_card_only(
        monkeypatch):
    """On the CPU the blockwise branch runs the plain loop and the
    wrapper is never called; the launch count stays put."""
    _, tc = _cfgs("qwen2-1.5b", "blockwise")
    calls = []
    monkeypatch.setattr(tfa, "flash_attention_gqa",
                        lambda *a, **k: calls.append(1))
    before = tfa.launches
    params = transformer.init_params(torch.Generator().manual_seed(0), tc)
    tapi.prefill(params, {"tokens": torch.zeros((1, 512), dtype=torch.int64)},
                 tc)
    assert not calls and tfa.launches == before
