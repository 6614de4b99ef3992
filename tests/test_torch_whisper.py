"""The audio family (``models/whisper.py``, ``configs/whisper_tiny.py``)
on the port against the JAX package on the CPU, in f32 at the SMOKE
config, from the same weights and inputs (the stubbed frontend's frames
``enc_embeds`` numpy normals): the config, the sinusoidal tables and
cross attention of ``models/layers.py``, prefill logits and every cache
leaf (full and blockwise attention), decode, the loss's gradient, one
spmd step, ``serve_lm``, the trainer's batches and ``run_experiment``
with token data. Tolerances and their reasons: ``lm_family_parity.py``.
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

from repro_torch.configs import registry as treg
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.core import fl_step as tfl
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import layers as tlayers
from repro_torch.models import whisper
from repro_torch.tree import named_leaves

ARCH = "whisper-tiny"
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
    """Every field and ``param_count``; ``long_500k`` is skipped by both
    packages (an audio encoder-decoder)."""
    tc, jc = treg.get_config(ARCH, smoke), jreg.get_config(ARCH, smoke)
    for f in dataclasses.fields(ArchConfig):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.param_count() == jc.param_count()
    for r in (treg, jreg):
        with pytest.raises(ValueError, match="skips long_500k"):
            r.config_for_shape(ARCH, "long_500k", smoke)
    assert treg.config_for_shape(ARCH, "prefill_32k", smoke) == tc


def test_init_params_match_jax_s_tree():
    """The port's own weights have the JAX tree's names, shapes and dtypes
    (encoder and decoder stacks, tied embedding, no LM head)."""
    jc, tc = P.cfgs(ARCH, dtype="bfloat16")
    want = jax.device_get(japi.init_params(jax.random.PRNGKey(0), jc))
    got = tapi.init_params(torch.Generator().manual_seed(0), tc)
    g = {"/".join(map(str, p)): v for p, v in named_leaves(got)}
    w = {"/".join(map(str, p)): np.asarray(v) for p, v in named_leaves(want)}
    assert g.keys() == w.keys() and "lm_head" not in g
    for k in w:
        assert tuple(g[k].shape) == w[k].shape, k
        assert str(g[k].dtype).split(".")[-1] == w[k].dtype.name, k


def test_params_carry_across_exactly():
    """``convert.lm_params_from_jax`` keeps the nest (``enc_layers``,
    ``enc_norm``, ``dec_layers`` with both attentions) and every leaf by
    bits."""
    jp = P.jax_params(ARCH, dtype="bfloat16")
    tp = lm_params_from_jax(jp, device="cpu")
    assert tp["dec_layers"]["cross_attn"]["bk"].dtype == torch.bfloat16
    got, want = P.flat(tp), P.flat(jp)
    assert got.keys() == want.keys()
    assert {"enc_layers/attn/wq", "enc_norm/b",
            "dec_layers/cross_attn/wv"} <= got.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k


# --------------------------------------------------------------------------
# layers.py: sinusoidal positions and cross attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seq,d", [(64, 128), (1500, 384), (512, 384)])
def test_sinusoidal_positions_match_jax(seq, d):
    """The table, and each row by ``sinusoidal_position_at``. The angle
    pos / 10000^(i/d) is an f32 quotient of a correctly rounded power in
    both packages, so equal; sin and cos are each within one f32 ulp of
    the exact value in either library (2^-24 absolute, the table lying in
    [−1, 1]), so two within 2^-23."""
    from repro.models import layers as jlayers
    want = np.asarray(jlayers.sinusoidal_positions(seq, d))
    got = tlayers.sinusoidal_positions(seq, d).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -23)
    for pos in (0, 1, seq // 2, seq - 1):
        row = tlayers.sinusoidal_position_at(pos, d).numpy()
        np.testing.assert_allclose(
            row, np.asarray(jlayers.sinusoidal_position_at(pos, d)), rtol=0,
            atol=2.0 ** -23)
        np.testing.assert_array_equal(row, got[pos])


@pytest.mark.parametrize("impl", ["full", "blockwise"])
def test_cross_attention_matches_jax(impl):
    """``full_attention(xkv=...)``: k and v from the encoder's frames, no
    rotary, no mask, the dense path whatever ``attention_impl`` says
    unless both lengths are multiples of 512 (Se 1,500 never is; 1,024
    takes the flash path, unmasked)."""
    from repro.models import layers as jlayers
    jc, tc = P.cfgs(ARCH, attention_impl=impl)
    rng = np.random.default_rng(2)
    p = {k: np.array(v[0]) for k, v in P.jax_params(ARCH)["dec_layers"][
        "cross_attn"].items()}
    for Sq, Se in ((512, 1500), (512, 1024), (7, 64)):
        x = rng.normal(size=(1, Sq, jc.d_model)).astype(np.float32)
        e = rng.normal(size=(1, Se, jc.d_model)).astype(np.float32)
        want, (wk, wv) = jlayers.full_attention(
            jc, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
            xkv=jnp.asarray(e), causal=False, use_rope=False)
        got, (gk, gv) = tlayers.full_attention(
            tc, {k: torch.as_tensor(v) for k, v in p.items()},
            torch.as_tensor(x), xkv=torch.as_tensor(e), causal=False,
            use_rope=False)
        assert gk.shape == (1, Se, tc.num_kv_heads, tc.hd)
        P.close_logits(got, want)
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk), rtol=0,
                                   atol=1e-5)


def test_cross_decode_attention_matches_jax():
    """``decode_attention(cross=True)``: one query against the
    pre-projected encoder k and v, which stay as they are."""
    from repro.models import layers as jlayers
    jc, tc = P.cfgs(ARCH)
    rng = np.random.default_rng(3)
    p = {k: np.array(v[1]) for k, v in P.jax_params(ARCH)["dec_layers"][
        "cross_attn"].items()}
    x = rng.normal(size=(2, 1, jc.d_model)).astype(np.float32)
    ck, cv = (rng.normal(size=(2, jc.encoder_seq, jc.num_kv_heads,
                                jc.hd)).astype(np.float32) for _ in range(2))
    want, wk, _ = jlayers.decode_attention(
        jc, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(ck), jnp.asarray(cv), 5, cross=True)
    tk = torch.as_tensor(ck)
    got = tlayers.decode_attention(
        tc, {k: torch.as_tensor(v) for k, v in p.items()},
        torch.as_tensor(x), tk, torch.as_tensor(cv), 5, cross=True)
    P.close_logits(got, want)
    assert np.array_equal(tk.numpy(), ck) and np.array_equal(
        np.asarray(wk), ck)


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


def test_decode_matches_prefill():
    """The port's own consistency: prefill(T − 1) and one decode step
    against prefill(T); the old cache stays as it was."""
    _, tc = P.cfgs(ARCH)
    params = whisper.init_params(torch.Generator().manual_seed(0), tc)
    n = 12
    inp = P.inputs(tc, (B,), n)
    full = torch.as_tensor(inp["tokens"])
    enc = torch.as_tensor(inp["enc_embeds"])
    logits_full, cache_full = tapi.prefill(
        params, {"tokens": full, "enc_embeds": enc}, tc)
    _, cache = tapi.prefill(params, {"tokens": full[:, :-1],
                                     "enc_embeds": enc}, tc)
    cache = P.graft_torch(tc, cache, B, n)
    before = cache["k"].clone()
    step_logits, new = tapi.decode_step(params, cache,
                                        {"tokens": full[:, -1:]}, tc)
    np.testing.assert_allclose(step_logits[:, 0].numpy(),
                               logits_full[:, -1].numpy(), rtol=2e-3,
                               atol=2e-3)
    for k in ("xk", "xv"):
        assert torch.equal(new[k], cache[k]), k
    for k in ("k", "v"):
        np.testing.assert_allclose(new[k][:, :, :n].numpy(),
                                   cache_full[k].numpy(), rtol=2e-3,
                                   atol=2e-3)
    assert torch.equal(cache["k"], before) and cache["step"] == n - 1
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


def test_fl_step_slices_enc_embeds_by_client():
    """The LM step hands each client its own ``enc_embeds`` slice: a
    client's loss in the step's records is the loss of its own tokens and
    frames."""
    _, tc = P.cfgs(ARCH)
    state = tfl.init_state(torch.Generator().manual_seed(0), tc,
                           device="cpu")
    step = tfl.make_raw_step(tc, theta=None)
    b = P.tb(P.inputs(tc, (C, 1), 8, labels=True, seed=5))
    losses = [float(tapi.loss_fn(state.params, {k: v[c] for k, v in
                                                b.items()}, tc))
              for c in range(C)]
    _, m = step(state, b)
    assert float(m["loss"]) == pytest.approx(np.mean(losses), rel=1e-6)
    assert losses[0] != losses[1]


def test_run_experiment_with_token_data_fails_as_jax():
    """The ``lm`` dataset's splits hold tokens and labels only, no
    ``enc_embeds`` (JAX ``api/world.py``), so a whisper spec on it fails
    in both packages, with the same KeyError."""
    import repro.api as J
    import repro_torch as T

    def spec(mod, reg):
        cfg = reg.get_config(ARCH, smoke=True).replace(dtype="float32")
        return mod.ExperimentSpec(
            model=cfg, data=mod.DataSpec(dataset="lm", partition="iid",
                                         seq_len=16, n_samples=32,
                                         eval_samples=8),
            world=mod.WorldSpec(num_clients=C, profile="uniform"),
            strategy="cmfl", strategy_kwargs=dict(batch_size=2, lr=3e-4),
            engine="spmd", rounds=1, seed=0)

    with pytest.raises(KeyError, match="enc_embeds"):
        J.run_experiment(spec(J, jreg))
    with pytest.raises(KeyError, match="enc_embeds"):
        T.run_experiment(spec(T, treg), device="cpu")


def test_train_main_runs_the_smoke_arch_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train as ttrain
    assert ttrain.main(["--arch", ARCH, "--smoke", "--steps", "2",
                        "--clients", "2", "--per-client-batch", "1",
                        "--seq", "16", "--device", "cpu", "--log-every",
                        "1", "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "loss=" in out and "checkpoints=1" in out


# --------------------------------------------------------------------------
# serve_lm end to end
# --------------------------------------------------------------------------

def test_serve_lm_matches_jax(capsys):
    P.serve_lm_matches_jax(ARCH, B, S)
    assert "decode: 4 steps" in capsys.readouterr().out


def test_serve_main_runs_the_smoke_arch_on_the_cpu(capsys):
    assert tserve.main(["--arch", ARCH, "--smoke", "--batch", "1",
                        "--prompt-len", "512", "--decode-steps", "2",
                        "--attention-impl", "blockwise",
                        "--device", "cpu"]) == 0
    assert "decode: 2 steps" in capsys.readouterr().out
