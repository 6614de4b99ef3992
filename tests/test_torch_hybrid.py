"""The hybrid family (``models/hybrid.py``, ``configs/hymba_1_5b.py``) on
the port against the JAX package on the CPU, in f32 at the SMOKE config,
from the same weights and inputs: the config, prefill logits and every
cache leaf (full and blockwise attention), decode (a sliding window
too), the loss's gradient, one spmd step, ``serve_lm``. Tolerances and
their reasons: ``lm_family_parity.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import lm_family_parity as P
from repro.configs import registry as jreg
from repro.models import api as japi

from repro_torch.api import parity
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.core import fl_step as tfl
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import hybrid
from repro_torch.tree import named_leaves

ARCH = "hymba-1.5b"
B, S = 2, 24
C = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: where several test workers share the machine,
    more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(**kw):
    return lm_params_from_jax(P.jax_params(ARCH, **kw), device="cpu")


# --------------------------------------------------------------------------
# config
# --------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_jax(smoke):
    """Every field, ``param_count`` (the JAX package's approximate
    formula) and the ``long_500k`` variant: the attention heads take a
    window of 4,096 (256 at SMOKE), the SSM runs natively."""
    tc, jc = treg.get_config(ARCH, smoke), jreg.get_config(ARCH, smoke)
    for f in dataclasses.fields(ArchConfig):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.param_count() == jc.param_count()
    long, jlong = (r.config_for_shape(ARCH, "long_500k", smoke)
                   for r in (treg, jreg))
    assert long.sliding_window == jlong.sliding_window == (
        256 if smoke else 4096)
    assert long == tc.replace(sliding_window=long.sliding_window)


def test_init_params_match_jax_s_tree():
    """The port's own weights have the JAX tree's names, shapes and dtypes
    (``A_log``, ``dt_bias`` and ``D`` f32 in a bf16 model) and its
    constants."""
    jc, tc = P.cfgs(ARCH, dtype="bfloat16")
    want = jax.device_get(japi.init_params(jax.random.PRNGKey(0), jc))
    got = tapi.init_params(torch.Generator().manual_seed(0), tc)
    g = {"/".join(map(str, p)): v for p, v in named_leaves(got)}
    w = {"/".join(map(str, p)): np.asarray(v) for p, v in named_leaves(want)}
    assert g.keys() == w.keys()
    for k in w:
        assert tuple(g[k].shape) == w[k].shape, k
        assert str(g[k].dtype).split(".")[-1] == w[k].dtype.name, k
    for k in ("layers/mamba/dt_bias", "layers/mamba/D",
              "layers/mamba/conv_b", "layers/attn_out_norm/w"):
        np.testing.assert_array_equal(g[k].float().numpy(),
                                      w[k].astype(np.float32), k)
    np.testing.assert_allclose(g["layers/mamba/A_log"].numpy(),
                               w["layers/mamba/A_log"], rtol=2.0 ** -23)


def test_params_carry_across_exactly():
    """``convert.lm_params_from_jax`` keeps the nest (``mamba`` and the two
    branch norms) and every leaf by bits, the f32 ``A_log``, ``dt_bias``
    and ``D`` of a bf16 model as f32."""
    jp = P.jax_params(ARCH, dtype="bfloat16")
    tp = lm_params_from_jax(jp, device="cpu")
    for k in ("A_log", "dt_bias", "D"):
        assert tp["layers"]["mamba"][k].dtype == torch.float32, k
    assert tp["layers"]["mamba"]["Win"].dtype == torch.bfloat16
    got, want = P.flat(tp), P.flat(jp)
    assert got.keys() == want.keys() and "layers/mamba/A_log" in got
    for k in want:
        assert np.array_equal(got[k], want[k]), k


# --------------------------------------------------------------------------
# the mamba branch
# --------------------------------------------------------------------------

def test_ssm_scan_matches_jax():
    """The selective scan alone on the same f32 inputs: outputs and the
    final state by ``parity.state_problems`` (K = n: the sum over the
    state)."""
    from repro.models import hybrid as jhyb
    rng = np.random.default_rng(1)
    Bq, T, di, n = 2, 40, 24, 8
    mp = {"A_log": np.log(np.tile(np.arange(1, n + 1, dtype=np.float32),
                                  (di, 1))),
          "D": rng.normal(size=(di,)).astype(np.float32)}
    x1 = rng.normal(size=(Bq, T, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(Bq, T, di)) - 3)).astype(
        np.float32)
    Bm, Cm = (rng.normal(size=(Bq, T, n)).astype(np.float32)
              for _ in range(2))
    h0 = rng.normal(size=(Bq, di, n)).astype(np.float32)
    jy, jh = jhyb._ssm_scan({k: jnp.asarray(v) for k, v in mp.items()},
                            *(jnp.asarray(a) for a in (x1, dt, Bm, Cm, h0)))
    ty, th = hybrid._ssm_scan({k: torch.as_tensor(v) for k, v in mp.items()},
                              *(torch.as_tensor(a)
                                for a in (x1, dt, Bm, Cm, h0)))
    assert parity.state_problems({"y": ty.numpy(), "h": th.numpy()},
                                 {"y": np.asarray(jy), "h": np.asarray(jh)},
                                 n, T) == []


def test_softplus_is_jax_s():
    """log1p(exp(−|x|)) + max(x, 0), as ``jax.nn.softplus``: within two
    f32 ulps (exp's and log1p's, each an ulp in either library)."""
    x = np.linspace(-40, 40, 2001).astype(np.float32)
    np.testing.assert_allclose(
        hybrid._softplus(torch.as_tensor(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=2 * 2.0 ** -23,
        atol=0)


# --------------------------------------------------------------------------
# prefill and decode against JAX
# --------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["full", "blockwise"])
def test_prefill_matches_jax(impl):
    """At 512 tokens the blockwise branch takes the flash path (the plain
    loop on the CPU, as JAX's ``blockwise_attention``)."""
    seq = 512 if impl == "blockwise" else S
    Bq = 1 if impl == "blockwise" else B
    jc, tc = P.cfgs(ARCH, attention_impl=impl)
    batch = P.inputs(jc, (Bq,), seq)
    want_logits, want_cache = P.jax_prefill(ARCH, P.jax_params(ARCH), batch,
                                            attention_impl=impl)
    logits, cache = tapi.prefill(_params(), P.tb(batch), tc)
    assert logits.shape == (Bq, seq, tc.padded_vocab)
    assert cache["step"] == seq == int(want_cache["step"])
    P.close_logits(logits, want_logits)
    assert P.cache_problems(tc, cache, want_cache, seq) == []


def test_decode_matches_jax():
    """Four decode steps after the graft (the states carried over), both
    fed JAX's greedy tokens; the states after them."""
    jc, tc = P.cfgs(ARCH)
    jp, tp = P.jax_params(ARCH), _params()
    batch = P.inputs(jc, (B,), S)
    logits, jcache = japi.prefill(jp, P.jb(batch), jc)
    _, tcache = tapi.prefill(tp, P.tb(batch), tc)
    jcache = P.graft_jax(jc, jcache, B, S + 4)
    tcache = P.graft_torch(tc, tcache, B, S + 4)
    tok = np.asarray(jnp.argmax(logits[:, -1:], axis=-1))
    for _ in range(4):
        want, jcache = japi.decode_step(jp, jcache,
                                        {"tokens": jnp.asarray(tok)}, jc)
        got, tcache = tapi.decode_step(tp, tcache,
                                       {"tokens": torch.tensor(tok)}, tc)
        P.close_logits(got, want)
        tok = np.asarray(jnp.argmax(want[:, -1:], axis=-1))
    assert tcache["step"] == S + 4 == int(jcache["step"])
    assert P.cache_problems(tc, tcache, jax.device_get(jcache), S + 4) == []


def test_sliding_window_decode_matches_jax():
    """``long_500k``'s variant: the attention cache cyclic over a window of
    16 (a 12-token prompt, 8 decode steps wrap it), the SSM state and the
    conv window carried over."""
    jc, tc = P.cfgs(ARCH, sliding_window=16)
    jp, tp = P.jax_params(ARCH), _params()
    batch = P.inputs(jc, (B,), 12)
    want, jcache = japi.prefill(jp, P.jb(batch), jc)
    got, tcache = tapi.prefill(tp, P.tb(batch), tc)
    P.close_logits(got, want)
    jcache = P.graft_jax(jc, jcache, B, 20)
    tcache = P.graft_torch(tc, tcache, B, 20)
    assert tcache["k"].shape[2] == 16
    tok = np.asarray(jnp.argmax(want[:, -1:], axis=-1))
    for _ in range(8):
        want, jcache = japi.decode_step(jp, jcache,
                                        {"tokens": jnp.asarray(tok)}, jc)
        got, tcache = tapi.decode_step(tp, tcache,
                                       {"tokens": torch.tensor(tok)}, tc)
        P.close_logits(got, want)
        tok = np.asarray(jnp.argmax(want[:, -1:], axis=-1))
    assert P.cache_problems(tc, tcache, jax.device_get(jcache), 20) == []


def test_decode_matches_prefill():
    """The port's own consistency: prefill(T − 1) and one decode step
    against prefill(T); the old cache stays as it was."""
    _, tc = P.cfgs(ARCH)
    params = hybrid.init_params(torch.Generator().manual_seed(0), tc)
    n = 12
    full = torch.as_tensor(P.inputs(tc, (B,), n)["tokens"])
    logits_full, cache_full = tapi.prefill(params, {"tokens": full}, tc)
    _, cache = tapi.prefill(params, {"tokens": full[:, :-1]}, tc)
    cache = P.graft_torch(tc, cache, B, n)
    before = cache["h"].clone()
    step_logits, new = tapi.decode_step(params, cache,
                                        {"tokens": full[:, -1:]}, tc)
    np.testing.assert_allclose(step_logits[:, 0].numpy(),
                               logits_full[:, -1].numpy(), rtol=2e-3,
                               atol=2e-3)
    for k in ("h", "conv"):
        np.testing.assert_allclose(new[k].numpy(), cache_full[k].numpy(),
                                   rtol=2e-3, atol=2e-3)
    for k in ("k", "v"):
        np.testing.assert_allclose(new[k][:, :, :n].numpy(),
                                   cache_full[k].numpy(), rtol=2e-3,
                                   atol=2e-3)
    assert torch.equal(cache["h"], before) and cache["step"] == n - 1
    assert new["step"] == n


# --------------------------------------------------------------------------
# the loss's backward and the spmd step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(remat):
    assert P.loss_and_grad_problems(ARCH, remat, B, S) == []


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_fl_step_matches_jax(optimizer):
    """One spmd step of each package from JAX's state, with the
    optimizer ``for_config`` gives for that kind (the full config names
    adamw, the SMOKE one adamw):
    ``lm_family_parity.fl_step_problems``."""
    assert P.fl_step_problems(ARCH, optimizer, C, B) == []


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_fl_step_bf16_arena_packs_f32_leaves(optimizer):
    """A bf16 model's arena holds its f32 leaves (``A_log``, ``dt_bias``,
    ``D``) as f32 and runs a step of the config's optimizer (adamw with
    f32 masters, or adafactor) with finite loss."""
    _, tc = P.cfgs(ARCH, dtype="bfloat16", optimizer=optimizer)
    state = tfl.init_state(torch.Generator().manual_seed(0), tc,
                           device="cpu")
    mamba = state.params["layers"]["mamba"]
    assert mamba["dt_bias"].dtype == torch.float32
    step = tfl.make_raw_step(tc, theta=None)
    new, m = step(state, P.tb(P.inputs(tc, (C, 1), 8, labels=True)))
    assert np.isfinite(float(m["loss"]))
    new_mamba = new.params["layers"]["mamba"]
    assert new_mamba["dt_bias"].dtype == torch.float32
    assert new_mamba["Win"].dtype == torch.bfloat16
    assert not torch.equal(new_mamba["dt_bias"], mamba["dt_bias"])


# --------------------------------------------------------------------------
# serve_lm end to end
# --------------------------------------------------------------------------

def test_serve_lm_matches_jax(capsys):
    P.serve_lm_matches_jax(ARCH, B, S)
    assert "decode: 4 steps" in capsys.readouterr().out


def test_serve_main_runs_the_smoke_arch_on_the_cpu(capsys):
    assert tserve.main(["--arch", ARCH, "--smoke", "--batch", "1",
                        "--prompt-len", "16", "--decode-steps", "2",
                        "--device", "cpu"]) == 0
    assert "decode: 2 steps" in capsys.readouterr().out
