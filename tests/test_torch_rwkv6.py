"""The ssm family (``models/rwkv6.py``, ``configs/rwkv6_7b.py``) on the
port against the JAX package on the CPU, in f32 at the SMOKE config, from
the same weights and inputs: the config, prefill logits and every cache
leaf, decode, the loss's gradient, one spmd step (adamw and adafactor),
``serve_lm``. Tolerances and their reasons: ``lm_family_parity.py``.
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
from repro_torch.models import rwkv6
from repro_torch.tree import named_leaves

ARCH = "rwkv6-7b"
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
    """Every field, ``param_count`` (the JAX package's approximate formula:
    6,494,490,624 at full width) and the ``long_500k`` variant (no
    window: rwkv6 runs it natively)."""
    tc, jc = treg.get_config(ARCH, smoke), jreg.get_config(ARCH, smoke)
    for f in dataclasses.fields(ArchConfig):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.param_count() == jc.param_count()
    if not smoke:
        assert tc.param_count() == 6_494_490_624
        assert tc.optimizer == "adafactor"
    assert jreg.config_for_shape(ARCH, "long_500k", smoke).sliding_window \
        is None
    assert treg.config_for_shape(ARCH, "long_500k", smoke) == tc


def test_init_params_match_jax_s_tree():
    """The port's own weights have the JAX tree's names, shapes and dtypes
    (``w0`` and ``u`` f32 in a bf16 model) and its constants."""
    jc, tc = P.cfgs(ARCH, dtype="bfloat16")
    want = jax.device_get(japi.init_params(jax.random.PRNGKey(0), jc))
    got = tapi.init_params(torch.Generator().manual_seed(0), tc)
    g = {"/".join(map(str, p)): v for p, v in named_leaves(got)}
    w = {"/".join(map(str, p)): np.asarray(v) for p, v in named_leaves(want)}
    assert g.keys() == w.keys()
    for k in w:
        assert tuple(g[k].shape) == w[k].shape, k
        assert str(g[k].dtype).split(".")[-1] == w[k].dtype.name, k
    for k in ("layers/tmix/w0", "layers/tmix/u", "layers/tmix/mus",
              "layers/ln1/w", "ln0/b"):
        np.testing.assert_array_equal(g[k].float().numpy(),
                                      w[k].astype(np.float32), k)


def test_params_carry_across_exactly():
    """``convert.lm_params_from_jax`` keeps the nest (``ln0``, the stacked
    ``tmix`` and ``cmix``) and every leaf by bits, the f32 ``w0`` and
    ``u`` of a bf16 model as f32."""
    jp = P.jax_params(ARCH, dtype="bfloat16")
    tp = lm_params_from_jax(jp, device="cpu")
    assert tp["layers"]["tmix"]["w0"].dtype == torch.float32
    assert tp["layers"]["tmix"]["u"].dtype == torch.float32
    assert tp["layers"]["tmix"]["Wr"].dtype == torch.bfloat16
    got, want = P.flat(tp), P.flat(jp)
    assert got.keys() == want.keys() and "ln0/w" in got
    for k in want:
        assert np.array_equal(got[k], want[k]), k


# --------------------------------------------------------------------------
# the layer pieces
# --------------------------------------------------------------------------

def test_group_norm_divides_by_n():
    """``jnp.var`` divides by n; torch's by n − 1 unless told otherwise."""
    from repro.models import rwkv6 as jrwkv
    x = np.random.default_rng(0).normal(size=(2, 3, 8)).astype(np.float32)
    w = np.linspace(0.5, 1.5, 8).astype(np.float32)
    b = np.linspace(-1, 1, 8).astype(np.float32)
    want = np.asarray(jrwkv._group_norm(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(b), 2))
    got = rwkv6._group_norm(torch.as_tensor(x), torch.as_tensor(w),
                            torch.as_tensor(b), 2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_wkv_scan_matches_jax():
    """The recurrence alone on the same f32 inputs: outputs and the final
    state by ``parity.state_problems`` (K = hd: the sum over the key
    index)."""
    from repro.models import rwkv6 as jrwkv
    rng = np.random.default_rng(1)
    Bq, T, H, hd = 2, 40, 3, 16
    r, k, v = (rng.normal(size=(Bq, T, H, hd)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.normal(size=(Bq, T, H, hd)) - 2)).astype(
        np.float32)
    u = rng.normal(size=(H, hd)).astype(np.float32)
    S0 = rng.normal(size=(Bq, H, hd, hd)).astype(np.float32)
    jo, jS = jrwkv._wkv_scan(*(jnp.asarray(a) for a in (r, k, v, w, u, S0)))
    to, tS = rwkv6._wkv_scan(*(torch.as_tensor(a)
                               for a in (r, k, v, w, u, S0)))
    assert parity.state_problems({"o": to.numpy(), "S": tS.numpy()},
                                 {"o": np.asarray(jo), "S": np.asarray(jS)},
                                 hd, T) == []


# --------------------------------------------------------------------------
# prefill and decode against JAX
# --------------------------------------------------------------------------

def test_prefill_matches_jax():
    jc, tc = P.cfgs(ARCH)
    batch = P.inputs(jc, (B,), S)
    want_logits, want_cache = P.jax_prefill(ARCH, P.jax_params(ARCH), batch)
    logits, cache = tapi.prefill(_params(), P.tb(batch), tc)
    assert logits.shape == (B, S, tc.padded_vocab)
    assert cache["step"] == S == int(want_cache["step"])
    P.close_logits(logits, want_logits)
    assert P.cache_problems(tc, cache, want_cache, S) == []


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


def test_decode_matches_prefill():
    """The port's own consistency: prefill(T − 1) and one decode step
    against prefill(T); the old cache stays as it was."""
    _, tc = P.cfgs(ARCH)
    params = rwkv6.init_params(torch.Generator().manual_seed(0), tc)
    n = 12
    full = torch.as_tensor(P.inputs(tc, (B,), n)["tokens"])
    logits_full, cache_full = tapi.prefill(params, {"tokens": full}, tc)
    _, cache = tapi.prefill(params, {"tokens": full[:, :-1]}, tc)
    before = cache["S"].clone()
    step_logits, new = tapi.decode_step(params, cache,
                                        {"tokens": full[:, -1:]}, tc)
    np.testing.assert_allclose(step_logits[:, 0].numpy(),
                               logits_full[:, -1].numpy(), rtol=2e-3,
                               atol=2e-3)
    for k in ("S", "tshift", "cshift"):
        np.testing.assert_allclose(new[k].numpy(), cache_full[k].numpy(),
                                   rtol=2e-3, atol=2e-3)
    assert torch.equal(cache["S"], before) and cache["step"] == n - 1
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
    adafactor, the SMOKE one adamw):
    ``lm_family_parity.fl_step_problems``."""
    assert P.fl_step_problems(ARCH, optimizer, C, B) == []


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_fl_step_bf16_arena_packs_f32_leaves(optimizer):
    """A bf16 model's arena holds its f32 leaves (``w0``, ``u``) as f32
    and runs a step of ``for_config``'s optimizer of each kind (adamw
    with f32 masters, adafactor) with finite loss."""
    _, tc = P.cfgs(ARCH, dtype="bfloat16", optimizer=optimizer)
    state = tfl.init_state(torch.Generator().manual_seed(0), tc,
                           device="cpu")
    assert state.params["layers"]["tmix"]["w0"].dtype == torch.float32
    step = tfl.make_raw_step(tc, theta=None)
    new, m = step(state, P.tb(P.inputs(tc, (C, 1), 8, labels=True)))
    assert np.isfinite(float(m["loss"]))
    assert new.params["layers"]["tmix"]["w0"].dtype == torch.float32
    assert new.params["layers"]["tmix"]["Wk"].dtype == torch.bfloat16
    assert not torch.equal(new.params["layers"]["tmix"]["w0"],
                           state.params["layers"]["tmix"]["w0"])


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
