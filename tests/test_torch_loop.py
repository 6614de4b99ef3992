"""The port's per-client reference loop (``megastep=False``), its int8
wire compression with error feedback (``quantize_updates``) on both
execution paths, and a custom ``eval_fn``, against the JAX package: the
port's simulation on the CPU against the one ``repro.api.runner`` builds
and runs, record for record, from the JAX simulation's own initial
parameters; and the port's two paths against each other.

Tolerances: ``repro_torch.api.parity`` states them, with their reasons.
Records as in tests/test_torch_engine.py. Round 0 of an int8 run in its
two parts (see parity.py): the codec by bits, on the port's own pre-codec
deltas, and every local step of every client from the reference's state
within ``step_mismatches``, the ReLU sides within ``relu_kinks`` (seed 2's
anomaly-mlp case has one pre-activation within rounding of 0: client 2,
last local step, sample 0, unit 48 of the second hidden layer, on which
the two packages' whole error-feedback states part by machine); the
port's loop against its megastep within
``path_mismatches``, the JAX package's own tolerances for that pair. The
quantized runs use seed 2: on seed 0 one θ ratio of the full-width case
lies 8.6e-5 from θ, inside the band where the decision is not
reproducible.
"""
import dataclasses

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax.numpy as jnp
import repro.api as J
from repro.api import runner as jrunner
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import api as japi
from repro.models import layers as jlayers
from repro.models import mlp_detector as jmlp
from repro.optim import adamw as jadamw

import repro_torch as T
from repro_torch.api import parity
from repro_torch.core import async_engine as tengine
from repro_torch.core import compression as tcompression
from repro_torch.core import megastep as tmegastep
from repro_torch.models import api as tapi
from repro_torch.models import mlp_detector as tmlp
from repro_torch.optim import adamw as tadamw

CASES = {
    "smoke": dict(model="anomaly-mlp-smoke", n=1500, ev=300, clients=4,
                  rounds=3),
    "anomaly-mlp": dict(model="anomaly-mlp", n=1600, ev=400, clients=4,
                        rounds=2),
}


def _spec(mod, case, strategy, seed=0, quantize=False, **kw):
    c = CASES[case]
    return mod.ExperimentSpec(
        model=c["model"],
        data=mod.DataSpec(n_samples=c["n"], eval_samples=c["ev"], alpha=0.5),
        world=mod.WorldSpec(num_clients=c["clients"], dropout_p=0.1),
        comm=mod.CommModel(bandwidth=5e6, latency=0.5, t_sample=2e-3,
                           t_launch=0.25),
        strategy=strategy,
        strategy_kwargs=dict(batch_size=64, lr=3e-2, local_epochs=2,
                             quantize_updates=quantize),
        rounds=c["rounds"], seed=seed, **kw)


def _run_both(tspec, jspec, rounds=None):
    """(port simulation, JAX simulation), the port's from the JAX one's
    weights, each run for ``rounds`` (default: the spec's)."""
    jsim = jrunner.build_simulation(jspec.validate())
    p0 = japi.init_params(jax.random.PRNGKey(jspec.seed),
                          jspec.resolve_model())
    sim = T.build_simulation(tspec, device="cpu",
                             params={k: np.asarray(v) for k, v in p0.items()})
    jsim.run(rounds or jspec.rounds, eval_final=True)
    sim.run(rounds or tspec.rounds)
    return sim, jsim


def _assert_same_run(sim, jsim, tspec):
    close_calls = parity.theta_band_violations(sim.theta_ratios, 0.65)
    assert not close_calls, close_calls      # choose another seed
    got = T.result_from_simulation(tspec, sim).records
    want = [jrunner.record_from_metrics(m) for m in jsim.history]
    mismatches = parity.record_mismatches(got, want)
    assert not mismatches, mismatches
    assert {c: dataclasses.asdict(r) for c, r in sim.selector.records.items()} \
        == {c: dataclasses.asdict(r) for c, r in jsim.selector.records.items()}
    assert sim.failure_log == jsim.failure_log
    assert sim.server_step == jsim.server_step
    assert [l.batch_size for l in sim.loaders] == \
        [l.batch_size for l in jsim.loaders]


@pytest.mark.parametrize("strategy", ["fedavg", "ours"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_loop_matches_jax(case, strategy):
    tspec = _spec(T, case, strategy, megastep=False)
    sim, jsim = _run_both(tspec, _spec(J, case, strategy, megastep=False))
    _assert_same_run(sim, jsim, tspec)
    if strategy == "ours":
        assert sim.theta_ratios, "the θ filter never ran against a reference"
        assert sorted(sim.ref_sign) == sorted(jsim.ref_sign)


def _record_round(monkeypatch):
    """Records the port's local trainings (client ids, start parameters,
    batches, LR scales) and codec calls (inputs, outputs), in call order."""
    drawn, trainings, codec = [], [], []
    draw, train = tengine.FederatedSimulation._client_batches, \
        tmegastep.local_sgd

    def client_batches(self, cid):
        out = draw(self, cid)
        drawn.append((cid, out[1], self.loaders[cid].batch_size))
        return out

    def local_sgd(cfg, opt, params, batches, lr_scale):
        shape = tuple(batches["x"].shape[1:3])
        cids = [c for c, *s in drawn if tuple(s) == shape]
        drawn[:] = [d for d in drawn if d[0] not in cids]
        trainings.append((cids, dict(params), dict(batches), lr_scale))
        return train(cfg, opt, params, batches, lr_scale)

    def recorded(fn):
        def call(*args):
            out = fn(*args)
            codec.append((args, out))
            return out
        return call

    monkeypatch.setattr(tengine.FederatedSimulation, "_client_batches",
                        client_batches)
    monkeypatch.setattr(tmegastep, "local_sgd", local_sgd)
    for name in ("compress_update", "compress_cohort"):
        monkeypatch.setattr(tcompression, name,
                            recorded(getattr(tcompression, name)))
    return trainings, codec


def _pre_activations(mod, params, x, cfg):
    """The hidden layers' pre-activations, by the package's own forward on
    the layers below (its last layer is not rectified)."""
    return [mod.forward({k: params[k] for k in params if int(k[1:]) <= i}, x,
                        dataclasses.replace(cfg, mlp_hidden=cfg.mlp_hidden[:i]))
            for i in range(len(cfg.mlp_hidden))]


def _jax_local_step(cfg, lr):
    """The JAX package's local step (core/megastep._train_cohort) over a
    cohort, with the ReLU's derivative taken from given masks: its values
    stay jax.nn.relu's."""
    opt = jadamw.sgd(lr=lr)

    def loss(p, batch, masks):
        x = batch["x"]
        for i in range(len(cfg.mlp_hidden) + 1):
            x = x @ p[f"w{i}"] + p[f"b{i}"]
            if i < len(cfg.mlp_hidden):
                gated = jnp.where(masks[i], x, 0.0)
                x = gated + jax.lax.stop_gradient(jax.nn.relu(x) - gated)
        return jlayers.softmax_xent(x, batch["y"])

    def step(p, state, batch, scale, masks):
        grads = jax.grad(loss)(p, batch, masks)
        return opt.update(jax.tree.map(lambda g: g * scale, grads), state, p)

    return jax.jit(jax.vmap(step)), opt


def _local_steps_vs_jax(trainings, tspec, jspec):
    """Every local step of every recorded training, the port's from the
    JAX package's state at that step: (kinks, problems)."""
    tcfg, jcfg = tspec.resolve_model(), jspec.resolve_model()
    lr = tspec.strategy_kwargs["lr"]
    jstep, jopt = _jax_local_step(jcfg, lr)
    topt = tadamw.sgd(lr=lr)
    kinks, problems = [], []
    for cids, params, batches, lr_scale in trainings:
        C, steps = batches["x"].shape[:2]
        jp = {k: jnp.broadcast_to(v.numpy(), (C,) + tuple(v.shape))
              for k, v in params.items()}
        jstate = jopt.init(jp)
        scale = jnp.asarray(lr_scale.numpy())
        for t in range(steps):
            batch = {k: v[:, t] for k, v in batches.items()}
            jbatch = {"x": jnp.asarray(batch["x"].numpy()),
                      "y": jnp.asarray(batch["y"].numpy().astype(np.int32))}
            tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
            tstate = {"mom": {k: torch.from_numpy(np.array(v))
                              for k, v in jstate["mom"].items()}}
            got, _, _ = tmegastep.local_step(tcfg, topt, tp, tstate, batch,
                                             lr_scale)
            z_got = [z.numpy() for z in
                     _pre_activations(tmlp, tp, batch["x"], tcfg)]
            z_want = [np.asarray(z) for z in jax.vmap(
                lambda p, x: _pre_activations(jmlp, p, x, jcfg))(
                    jp, jbatch["x"])]
            zabs = [np.asarray(z) for z in jax.vmap(
                lambda p, x: _pre_activations(
                    jmlp, jax.tree.map(jnp.abs, p), jnp.abs(x), jcfg))(
                        jp, jbatch["x"])]
            # |h| of the layers below is their rectified values, not |z|
            for i in range(1, len(zabs)):
                h = np.maximum(z_want[i - 1], 0.0)
                zabs[i] = np.einsum("cbh,chj->cbj", h, np.abs(
                    np.asarray(jp[f"w{i}"]))) + np.abs(
                        np.asarray(jp[f"b{i}"]))[:, None]
            for c, cid in enumerate(cids):
                for i, (zg, zw, za) in enumerate(zip(z_got, z_want, zabs)):
                    k, f = parity.relu_kinks(
                        zg[c], zw[c], za[c],
                        f"client {cid}, step {t}, layer {i}: ")
                    kinks += k
                    problems += f
            want, _ = jstep(jp, jstate, jbatch, scale,
                            [jnp.asarray(z > 0) for z in z_got])
            for c, cid in enumerate(cids):
                problems += parity.step_mismatches(
                    {k: v[c] for k, v in got.items()},
                    {k: np.asarray(v[c]) for k, v in want.items()},
                    {k: np.asarray(v[c]) for k, v in jp.items()},
                    f"client {cid}, step {t}: ")
            jp, jstate = jstep(jp, jstate, jbatch, scale,
                               [jnp.asarray(z > 0) for z in z_want])
    return kinks, problems


@pytest.mark.parametrize("megastep", [True, False], ids=["megastep", "loop"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_quantized_matches_jax(case, megastep, monkeypatch):
    tspec = _spec(T, case, "ours", seed=2, quantize=True, megastep=megastep)
    jspec = _spec(J, case, "ours", seed=2, quantize=True, megastep=megastep)
    trainings, codec = _record_round(monkeypatch)
    sim, jsim = _run_both(tspec, jspec, rounds=1)
    monkeypatch.undo()
    assert sim._wire_bytes == jsim._wire_bytes == \
        sim._arena.rows * (1024 + 4)
    # round 0's codec, by bits: the JAX package's plain codec
    # (kernels/ref.py) on the port's own pre-codec deltas gives the port's
    # wire payload and residuals
    assert len(codec) == len(trainings)
    for (cids, *_), (args, out) in zip(trainings, codec):
        if megastep:
            corrected = (args[0] + args[1]).numpy()
            q, s = jref.quantize_q8(corrected.reshape(-1, corrected.shape[-1]))
            restored = np.asarray(jref.dequantize_q8(q, s)).reshape(
                corrected.shape)
            want = (restored, corrected - restored)
            assert torch.equal(sim._ef_arena[torch.tensor(cids)],
                               out[1][:len(cids)])
        else:
            corrected = {k: jnp.asarray((v + args[1][k]).numpy())
                         for k, v in args[0].items()}
            mat, _n = jops.flatten_to_lanes(corrected)
            q, s = jref.quantize_q8(mat)
            restored = jops.unflatten_from_lanes(jref.dequantize_q8(q, s),
                                                 corrected)
            want = (q, s) + tuple(corrected[k] - restored[k]
                                  for k in sorted(corrected))
            assert sim._ef_state[cids[0]] is out[3]
            out = out[:2] + tuple(out[3][k] for k in sorted(out[3]))
        for g, w in zip(out, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
    assert sim._ef_arena[:-1].any() if megastep else sim._ef_state
    # round 0's local training, step by step from the reference's state
    kinks, problems = _local_steps_vs_jax(trainings, tspec, jspec)
    assert not problems, (problems, kinks)
    jsim.run(tspec.rounds - 1, eval_final=True)
    sim.run(tspec.rounds - 1)
    _assert_same_run(sim, jsim, tspec)
    assert sim.theta_ratios


@pytest.mark.parametrize("megastep", [True, False], ids=["megastep", "loop"])
def test_custom_eval_fn_matches_jax(megastep):
    """eval_fn(params, eval_batch) replaces the accuracy: here minus the
    mean eval loss, in each package's own terms."""
    case = "smoke"
    jcfg = _spec(J, case, "ours").resolve_model()
    tcfg = _spec(T, case, "ours").resolve_model()
    tspec = _spec(T, case, "ours", megastep=megastep,
                  eval_fn=lambda p, b: -float(tapi.loss_fn(p, b, tcfg)))
    jspec = _spec(J, case, "ours", megastep=megastep,
                  eval_fn=lambda p, b: -float(japi.loss_fn(p, b, jcfg)))
    sim, jsim = _run_both(tspec, jspec)
    _assert_same_run(sim, jsim, tspec)
    assert all(-3.0 < m.accuracy < 0.0 for m in sim.history)
    assert sim.history[-1].accuracy == pytest.approx(
        -float(tapi.loss_fn(sim.params, sim._eval_dev, tcfg)))


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_loop_matches_megastep(case, quantize):
    p0 = tapi.init_params(torch.Generator().manual_seed(2),
                          _spec(T, case, "ours").resolve_model())
    records = {}
    for megastep in (True, False):
        spec = _spec(T, case, "ours", seed=2, quantize=quantize,
                     megastep=megastep)
        records[megastep] = T.run_experiment(spec, device="cpu",
                                             params=p0).records
    problems = parity.path_mismatches(records[False], records[True])
    assert not problems, problems
    assert any(r.updates_applied for r in records[True][1:])
