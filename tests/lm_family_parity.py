"""Helpers shared by the ssm, hybrid and audio families' parity tests
(``test_torch_rwkv6.py``, ``test_torch_hybrid.py``,
``test_torch_whisper.py``): the port against the JAX package on the CPU,
in f32 at the SMOKE configs, from the same weights (JAX's, carried across
by ``convert.lm_params_from_jax``) and the same numpy inputs.

Imported by those files after their ``pytest.importorskip("torch")``.

Tolerances, each with its reason:
  * logits within 1e-4 of max|logit| (``LOGIT_RTOL``): matmuls sum in
    another order in XLA and torch, and each layer passes the gap on;
  * cache leaves (recurrent states, token shifts, conv windows, KV
    caches) by ``parity.state_problems``: 2·(K + T)·2^-24 of the leaf's
    largest |value|, K the widest reduction behind it, T the steps taken;
  * decode against prefill within the port: rtol = atol = 2e-3, as
    ``tests/test_decode_consistency.py``;
  * loss within ``parity.LOSS_RTOL``, gradients by ``parity.grad_problems``;
  * weights after a step by ``parity.adamw_weight_problems``, or for
    adafactor by ``parity.adafactor_replay_problems`` (JAX's optimizer
    replayed on the port's own gradient, read by ``parity.recording``);
  * greedy tokens equal where JAX's top-2 margin is at least ``MARGIN``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jreg
from repro.core import fl_step as jfl
from repro.models import api as japi

from repro_torch.api import parity
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.tree import named_leaves, tree_map

LOGIT_RTOL = 1e-4
MARGIN = 1e-3
LR = 1e-3     # optim.for_config's default, the step's without a schedule


def cfgs(arch, **kw):
    """(JAX config, port config) of the arch's SMOKE, in f32 unless named."""
    kw = dict(dict(dtype="float32"), **kw)
    return (jreg.get_config(arch, smoke=True).replace(**kw),
            treg.get_config(arch, smoke=True).replace(**kw))


@functools.lru_cache(maxsize=None)
def _jax_params(arch, seed, items):
    jc, _ = cfgs(arch, **dict(items))
    return jax.device_get(japi.init_params(jax.random.PRNGKey(seed), jc))


def jax_params(arch, seed=0, **kw):
    """The JAX package's initial weights of the config, as numpy."""
    return _jax_params(arch, seed, tuple(sorted(kw.items())))


def inputs(cfg, lead, seq, seed=0, labels=False):
    """A numpy batch of ``seq`` tokens with leading dims ``lead``, and for
    the audio family the stubbed frontend's frames ``enc_embeds``."""
    rng = np.random.default_rng(seed)
    shape = tuple(lead) + (seq,)
    out = {"tokens": rng.integers(0, cfg.vocab_size, size=shape)}
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab_size, size=shape)
    if cfg.family == "audio":
        out["enc_embeds"] = rng.normal(size=tuple(lead) + (
            cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tb(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def flat(tree):
    """name -> f32 numpy array of every leaf of a nest (tensors or
    arrays)."""
    return {"/".join(map(str, p)): np.asarray(
        v.detach().float().numpy() if torch.is_tensor(v) else v, np.float32)
        for p, v in named_leaves(tree)}


def state_width(cfg):
    """K of a cache leaf: the widest reduction behind it (the model and
    FFN widths, and for audio the encoder frames the cross attention
    sums)."""
    return max(cfg.d_model, cfg.d_ff,
               cfg.encoder_seq if cfg.family == "audio" else 0)


def grad_width(cfg, seq):
    """K of a gradient element: the widest contraction behind it."""
    return max(state_width(cfg), cfg.padded_vocab, seq)


def close_logits(got, want, rel=LOGIT_RTOL):
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    gap = np.abs(got - want).max()
    assert gap <= rel * np.abs(want).max(), (gap, np.abs(want).max())


def cache_problems(cfg, got, want, steps):
    """Every leaf of two caches but ``step`` by ``parity.state_problems``;
    the shapes equal."""
    names = sorted(k for k in want if k != "step")
    assert sorted(k for k in got if k != "step") == names
    g = {k: got[k].float().numpy() for k in names}
    w = {k: np.asarray(want[k], np.float32) for k in names}
    for k in names:
        assert g[k].shape == w[k].shape, (k, g[k].shape, w[k].shape)
    return parity.state_problems(g, w, state_width(cfg), steps)


def graft_jax(jc, cache, batch, total):
    """The JAX package's own graft (``launch/serve.py``): leaves of the
    same rank and another shape copied into the leading slice of a full
    cache, the others carried over."""
    full = japi.init_cache(jc, batch, total)
    out = jax.tree.map(
        lambda dst, src: jax.lax.dynamic_update_slice(
            dst, src.astype(dst.dtype), (0,) * dst.ndim)
        if dst.ndim == src.ndim and dst.shape != src.shape else src,
        full, jax.tree.map(jnp.asarray, cache))
    out["step"] = jnp.asarray(int(cache["step"]), jnp.int32)
    return out


def graft_torch(tc, cache, batch, total):
    out = tserve.graft_cache(tapi.init_cache(tc, batch, total, device="cpu"),
                             cache)
    out["step"] = int(cache["step"])
    return out


@functools.lru_cache(maxsize=None)
def _jax_prefill_step(arch, items):
    jc, _ = cfgs(arch, **dict(items))
    return jfl.build_prefill_step(jc)


def jax_prefill(arch, params, batch, **kw):
    """JAX's jitted prefill (``fl_step.build_prefill_step``), as numpy."""
    step = _jax_prefill_step(arch, tuple(sorted(kw.items())))
    return jax.device_get(step(params, jb(batch)))


def torch_grads(tc, params, batch):
    """The port's loss and gradients (name -> numpy) at ``params``."""
    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    leaves = [v for _, v in named_leaves(p)]
    loss = tapi.loss_fn(p, tb(batch), tc)
    grads = torch.autograd.grad(loss, leaves)
    names = ["/".join(map(str, q)) for q, _ in named_leaves(p)]
    return loss.item(), {n: g.numpy() for n, g in zip(names, grads)}


def jax_greedy(jc, params, batch, steps):
    """JAX's greedy loop, eager: the tokens and, at each step, the
    top-1/top-2 margin of each row."""
    logits, cache = japi.prefill(params, jb(batch), jc)
    B, S = batch["tokens"].shape
    cache = graft_jax(jc, cache, B, S + steps)
    margins, toks = [], []
    for i in range(steps + 1):
        last = np.asarray(logits[:, -1], np.float32)
        top2 = np.sort(last, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        if i < steps:
            logits, cache = japi.decode_step(params, cache, {"tokens": tok},
                                             jc)
    return np.stack(margins, axis=1), np.concatenate(toks, axis=1)


def null_scales(cfg, grads):
    """An attention without rotary (whisper's) holds its key biases at
    their key weights' scale (``parity.null_bias_scales``)."""
    if cfg.family != "audio":
        return {}
    return parity.null_bias_scales(
        grads, [k for k in grads if k.endswith("attn/bk")])


def loss_and_grad_problems(arch, remat, batch, seq):
    """The port's loss and gradient at JAX's weights against
    ``jax.value_and_grad`` of JAX's ``loss_fn``: the loss within
    ``LOSS_RTOL``, the gradients' problems by ``parity.grad_problems``."""
    jc, tc = cfgs(arch, remat=remat)
    jp = jax_params(arch)
    b = inputs(jc, (batch,), seq, labels=True)
    jl, jg = jax.value_and_grad(japi.loss_fn)(jp, jb(b), jc)
    tl, tg = torch_grads(tc, lm_params_from_jax(jp, device="cpu"), b)
    assert abs(tl - float(jl)) <= parity.LOSS_RTOL * abs(float(jl))
    want = flat(jax.device_get(jg))
    return parity.grad_problems(tg, want, grad_width(tc, seq), batch * seq,
                                scales=null_scales(tc, want))


def _jax_aggregate(jc, params, batch, mask):
    """The step's aggregated gradient by the JAX package's backward: each
    client's gradient, weighted by its share of the mask, in f64."""
    w = np.asarray(mask, np.float64) / max(float(np.sum(mask)), 1e-9)
    grad = jax.jit(jax.grad(lambda p, b: japi.loss_fn(p, b, jc)))
    agg = None
    for c in range(len(w)):
        g = flat(jax.device_get(grad(
            params, {k: jnp.asarray(v[c]) for k, v in batch.items()})))
        agg = {k: w[c] * v.astype(np.float64) + (agg[k] if agg else 0.0)
               for k, v in g.items()}
    return agg


def _stats(tree):
    """Adafactor's statistics nest as leaf name -> {"r", "c"} or {"v"}."""
    out = {}
    for k, v in flat(tree).items():
        leaf, stat = k.rsplit("/", 1)
        out.setdefault(leaf, {})[stat] = v
    return out


def fl_step_problems(arch, optimizer, clients, batch, seq=16):
    """One step of each package's ``make_raw_step`` (θ 0.65, f32
    aggregation, no control plane: no draws) from JAX's state, the
    config's optimizer kind ``optimizer``. The records are asserted equal;
    returns the problems of the gradient (the port's, read where its
    optimizer receives it, against JAX's per-client gradients weighted by
    the mask), the reference signs, and the weights: adamw's by its rule,
    adafactor's by the JAX optimizer replayed on the port's own gradient
    from the same state."""
    from repro.optim import adamw as jopt
    from repro_torch.convert import fl_state_from_jax
    from repro_torch.core import fl_step as tfl
    from repro_torch.optim import adamw as topt
    jc, tc = cfgs(arch, optimizer=optimizer)
    jstep = jax.jit(jfl.make_raw_step(jc, theta=0.65,
                                      agg_dtype=jnp.float32))
    opt, seen = parity.recording(topt.for_config(tc))
    tstep = tfl.make_raw_step(tc, opt, theta=0.65, agg_dtype=torch.float32)
    js = jfl.init_state(jax.random.PRNGKey(0), jc)
    before = jax.device_get(js)
    ts = fl_state_from_jax(before, device="cpu")
    assert sorted(ts.opt_state) == sorted(before.opt_state)
    b = inputs(jc, (clients, batch), seq, seed=3, labels=True)
    js, jm = jstep(js, jb(b))
    after = jax.device_get(js)
    ts, tm = tstep(ts, tb(b))
    for k in ("mask", "selected", "delivered"):
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]), k)
    for k in ("accept_rate", "bytes_sent", "bytes_baseline"):
        assert float(tm[k]) == float(jm[k]), k
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
        parity.LOSS_RTOL * abs(float(jm["loss"]))
    assert float(jm["mask"].sum()) > 0
    g = _jax_aggregate(jc, before.params, b, jm["mask"])
    scales = null_scales(tc, g)
    width, rows = grad_width(tc, seq), batch * seq
    bounds = {k: parity.grad_bound(scales.get(k, v), width, rows)
              for k, v in g.items()}
    problems = parity.grad_problems(flat(seen[0]), g, width, rows,
                                    scales=scales)
    problems += parity.ref_sign_problems(flat(ts.ref_sign),
                                         flat(after.ref_sign), g, bounds)
    if optimizer == "adamw":
        return problems + parity.adamw_weight_problems(
            flat(ts.params), flat(after.params), [g], [bounds], [LR])
    replay, rstate = jax.device_get(jax.jit(jopt.for_config(jc).update)(
        jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(), seen[0])),
        before.opt_state, before.params))
    return problems + parity.adafactor_replay_problems(
        flat(ts.params), flat(replay), LR, _stats(rstate["stats"]))


def serve_lm_matches_jax(arch, batch, seq, steps=4):
    """``serve_lm``'s tokens from JAX's weights equal the JAX package's,
    where JAX's top-2 margin is at least ``MARGIN`` at every step
    (asserted, naming row and step)."""
    from repro.launch import serve as jserve
    jc, tc = cfgs(arch)
    want = np.asarray(jserve.serve_lm(jc, batch, seq, steps, seed=0))
    margins, eager = jax_greedy(jc, jax_params(arch),
                                inputs(jc, (batch,), seq), steps)
    np.testing.assert_array_equal(eager, want)
    near = [(b, i) for b in range(batch) for i in range(steps + 1)
            if margins[b, i] < MARGIN]
    assert not near, f"JAX's top-2 margin is below {MARGIN} at {near}"
    got = tserve.serve_lm(tc, batch, seq, steps, seed=0, device="cpu",
                          params=lm_params_from_jax(jax_params(arch),
                                                    device="cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
