"""Helpers shared by the sim-engine language-model parity tests
(``test_torch_sim_lm.py``, ``test_torch_sim_lm_families.py``): the port's
loop, megastep and scanned paths against the JAX package's
``FederatedSimulation`` on the CPU, from the JAX simulation's own initial
weights (carried across by ``convert.lm_params_from_jax``) and, on the
scanned path, its own draws (``JaxDraws``).

Imported by those files after their ``pytest.importorskip("torch")``.

The world: the arch's SMOKE config, 4 clients, ``ours`` (async, θ 0.65)
selecting half of them, iid token data of ``seq_len`` 32, batches of 2
and 2 local steps a client, 2 rounds. Held, with each rule's reason in
``repro_torch/api/parity.py``:
  * f32 weights (the SMOKE config with ``dtype="float32"``): the records
    by ``parity.record_mismatches`` (``scanned_mismatches`` on the
    scanned path), the θ tests outside ``THETA_BAND``, and after round 0
    the globals by ``parity.sim_weight_problems`` and the reference signs
    by ``parity.ref_sign_problems``, both against ``sim_round_bounds`` of
    the port's own gradients (read by ``parity.recording``);
  * the config's own bf16: the records' exact fields
    (``parity.exact_field_mismatches``; ``param_bytes`` counts bf16 at 2
    bytes in both) and the θ tests outside ``THETA_BAND``.
"""
import jax
import numpy as np
import torch

import repro as J
import repro_torch as T
from repro.api import runner as jrunner
from repro.configs import registry as jreg

from repro_torch.api import parity
from repro_torch.api import runner as trunner
from repro_torch.configs import registry as treg
from repro_torch.core import async_engine as tae
from repro_torch.kernels.arena import ParamArena
from repro_torch.optim import adamw as topt
from repro_torch.tree import named_leaves

from test_torch_scanned import JaxDraws

CLIENTS, SEQ, BATCH, STEPS, ROUNDS = 4, 32, 2, 2, 2
THETA = 0.65
MOMENTUM = 0.9        # the engine's optim.sgd default


def cfgs(arch, dtype=None):
    """(JAX config, port config) of the arch's SMOKE, in ``dtype`` when
    named."""
    kw = {} if dtype is None else dict(dtype=dtype)
    return (jreg.get_config(arch, smoke=True).replace(**kw),
            treg.get_config(arch, smoke=True).replace(**kw))


def spec(mod, cfg, path="megastep", rounds=ROUNDS, **extra):
    kw = {"loop": dict(megastep=False), "megastep": {},
          "scanned": dict(rounds_per_dispatch=2, fused_eval=True)}[path]
    return mod.ExperimentSpec(
        model=cfg,
        data=mod.DataSpec(dataset="lm", partition="iid", seq_len=SEQ,
                          n_samples=16 * CLIENTS, eval_samples=4),
        world=mod.WorldSpec(num_clients=CLIENTS),
        strategy="ours",
        strategy_kwargs=dict(batch_size=BATCH, select_fraction=0.5,
                             theta=THETA, dynamic_batch=False,
                             max_samples_per_round=BATCH * STEPS),
        rounds=rounds, seed=0, **kw, **extra)


def flat(tree):
    """name -> f32 numpy array of a nest of arrays or tensors."""
    return {"/".join(map(str, p)): np.asarray(
        v.detach().float().cpu().numpy() if torch.is_tensor(v) else v,
        np.float32) for p, v in named_leaves(tree)}


def _globals(sim, arena):
    """The simulation's globals and reference signs as name -> array."""
    if sim.megastep:
        flat_p = np.asarray(sim._params_mat, np.float32).reshape(-1)
        flat_r = np.asarray(sim._ref_mat).reshape(-1)
        p, r, off = {}, {}, 0
        for name, shape, size in zip(arena.names, arena.shapes,
                                     arena.sizes):
            p[name] = flat_p[off:off + size].reshape(shape)
            r[name] = flat_r[off:off + size].reshape(shape)
            off += size
        return p, r
    return flat(sim.params), flat(sim.ref_sign)


class Pair:
    """One spec run by both packages: ``jsim`` the JAX simulation, ``sim``
    the port's on the CPU from JAX's initial weights (and draws, on the
    scanned path); ``grads`` the gradients the port's optimizer received,
    in call order (client by client, S steps each)."""

    def __init__(self, arch, path, dtype=None, monkeypatch=None):
        self.jc, self.tc = cfgs(arch, dtype)
        self.jsim = jrunner.build_simulation(spec(J, self.jc, path).validate())
        self.p0 = jax.device_get(self.jsim.params)
        self.grads = []
        if monkeypatch is not None:
            plain = topt.sgd

            def sgd(lr):
                opt, seen = parity.recording(plain(lr=lr))
                self.grads = seen
                return opt

            monkeypatch.setattr(tae.optim_mod, "sgd", sgd)
        draws = (JaxDraws(0, *self.jsim._scan_shapes())
                 if path == "scanned" else None)
        self.sim = T.build_simulation(spec(T, self.tc, path), device="cpu",
                                      params=self.p0, draws=draws)
        self.arena = ParamArena(self.p0)

    def run(self, rounds):
        self.jsim.run(rounds)
        self.sim.run(rounds)

    def records(self):
        return ([trunner.record_from_metrics(m) for m in self.sim.history],
                [jrunner.record_from_metrics(m) for m in self.jsim.history])

    def round0_problems(self):
        """After one round from the shared start: the globals and the
        reference signs against ``sim_round_bounds`` of the port's own
        gradients (f32 weights only)."""
        start = flat(self.p0)
        got, got_ref = _globals(self.sim, self.arena)
        want, want_ref = _globals(self.jsim, self.arena)
        width = parity.lm_grad_width(self.tc, SEQ)
        steps = len(self.grads)
        per_client = [
            parity.sgd_delta_bounds(
                [flat(g) for g in self.grads[c:c + STEPS]],
                self.sim.strategy.lr, MOMENTUM, width, BATCH * SEQ)
            for c in range(0, steps, STEPS)]
        assert per_client, "the port's optimizer saw no gradient"
        bounds = parity.sim_round_bounds(want, start, per_client, STEPS,
                                         self.sim.schedule.alpha0)
        moved = {k: want[k] - start[k] for k in want}
        return (parity.sim_weight_problems(got, want, bounds)
                + parity.ref_sign_problems(got_ref, want_ref, moved, bounds))
