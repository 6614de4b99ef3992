"""Run an ``ExperimentSpec`` on the port.

``run_experiment(spec)``  — a thin wrapper over ``ExperimentSession``
    (api/session.py): open, run ``spec.rounds`` as one batch (its final
    round always evaluated), collect the normalized result. For streaming,
    callbacks, checkpoint and resume, or sweeps, use ``ExperimentSession``
    or ``run_sweep`` (api/sweep.py) directly.

``build_simulation(spec)`` — the event-driven ``FederatedSimulation`` an
    ``engine='sim'`` spec describes.

``SpmdDriver(spec)``       — the stepping driver of ``engine='spmd'``: one
    step per round over a (C, B, ...) cohort batch (core/fl_step.py), with
    the same CommModel applied analytically for sync-barrier timing and
    byte accounting, so both engines emit the same ``RoundRecord``s; its
    ``run_rounds`` / ``state_dict`` / ``load_state_dict`` serve session
    streaming and checkpoint/resume.

``run_scanned_seed_batch(spec, seeds)`` / ``run_spmd_seed_batch(spec,
    seeds)`` — the scanned sim path or the spmd engine at several seeds,
    every metric kept on the device and read back once at the end.

All run on the card unless ``device`` names another device, and start
from ``params`` (a parameter dict, e.g. the JAX package's initial
parameters as numpy arrays) when given; ``draws`` replaces the port's own
draw source (core/draws.py) and ``world_source`` the world trajectory of
a scenario (core/scenario.py, ``WorldSource``), so a test can feed the
JAX package's draws and worlds.

Degenerate parity: with uniform profiles, zero latency, theta=None and
one local step (``max_samples_per_round == batch_size``), the two engines
produce the same records — the sim runs one SGD step per client and
averages the parameters, which equals the spmd step's SGD step on the
client-mean gradient (the spmd engine uses momentum 0, as the sim resets
momentum every round).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.api.result import ExperimentResult, RoundRecord
from repro_torch.api.spec import ExperimentSpec
from repro_torch.core import async_engine as ae
from repro_torch.core import compression, fl_step
from repro_torch.core import scenario as scenario_mod
from repro_torch.core.draws import SpmdDraws
from repro_torch.data.loader import ArrayLoader
from repro_torch.device import resolve_device
from repro_torch.kernels import arena as arena_mod
from repro_torch.models import api as model_api
from repro_torch.optim import adamw as optim_mod


def build_simulation(spec: ExperimentSpec, *, device=None,
                     params=None, draws=None,
                     world_source=None) -> "ae.FederatedSimulation":
    """The event-driven simulation an ``engine='sim'`` spec describes
    (``draws``: the scanned path's draw source, core/draws.py;
    ``world_source``: the scenario's world trajectory; None for the port's
    own)."""
    spec.validate()
    world = spec.build_world()
    return ae.FederatedSimulation(spec.resolve_model(), world.client_arrays,
                                  world.eval_arrays, spec.resolve_strategy(),
                                  world.profiles, comm=spec.resolve_comm(),
                                  seed=spec.seed, eval_every=spec.eval_every,
                                  schedule=spec.resolve_schedule(),
                                  device=device, params=params,
                                  eval_fn=spec.eval_fn,
                                  megastep=spec.megastep,
                                  rounds_per_dispatch=spec.rounds_per_dispatch,
                                  fused_eval=spec.fused_eval, draws=draws,
                                  scenario=spec.resolve_scenario(),
                                  world_source=world_source,
                                  topology=spec.resolve_topology(),
                                  candidate_frac=spec.candidate_frac,
                                  candidate_shards=spec.candidate_shards)


def record_from_metrics(m: "ae.RoundMetrics") -> RoundRecord:
    return RoundRecord(round=m.round, sim_time=m.sim_time,
                       comm_time=m.comm_time, idle_time=m.idle_time,
                       bytes_sent=m.bytes_sent,
                       updates_applied=m.updates_applied,
                       accept_rate=m.accept_rate, accuracy=m.accuracy,
                       loss=m.loss)


def result_from_simulation(spec: ExperimentSpec, sim, wall_time: float = 0.0
                           ) -> ExperimentResult:
    records = [record_from_metrics(m) for m in sim.history]
    return ExperimentResult(
        engine="sim", strategy=spec.strategy_name(), rounds=len(records),
        seed=spec.seed, records=records, cfg=sim.cfg, params=sim.params,
        eval_arrays=sim.eval_arrays, num_clients=sim.num_clients,
        param_bytes=sim.param_bytes, wall_time=wall_time)


def run_experiment(spec: ExperimentSpec, *, device=None, params=None,
                   draws=None, world_source=None) -> ExperimentResult:
    """One-shot facade: open a session (the keywords go to the engine),
    run ``spec.rounds``, return the normalized result."""
    from repro_torch.api.session import ExperimentSession

    session = ExperimentSession.open(spec, device=device, params=params,
                                     draws=draws, world_source=world_source)
    session.run(spec.rounds)
    return session.result()


def run_scanned_seed_batch(spec: ExperimentSpec, seeds: Sequence[int], *,
                           device=None) -> List[ExperimentResult]:
    """Run the scanned path at every seed, with fused eval forced on, and
    read every seed's metrics back once, at the end.

    Each seed's records equal that seed's solo scanned run
    (``run_experiment(replace(spec, seed=s, fused_eval=True))``): each
    seed is its own simulation, with its own world, weights, control state
    and draws. The seeds run one after another inside each dispatch
    window; batching the seed axis into one launch stream is later work.
    Every seed must resolve the same scanned shapes (select_k, steps_phys,
    batch_phys), as the JAX package requires for its vmapped batch.
    """
    t0 = time.time()
    if spec.engine != "sim" or not spec.rounds_per_dispatch:
        raise ValueError(
            "run_scanned_seed_batch runs the scanned sim engine — the spec "
            "needs engine='sim' and rounds_per_dispatch")
    specs = [dataclasses.replace(spec, seed=int(s),
                                 fused_eval=True).validate() for s in seeds]
    sims = [build_simulation(s, device=device) for s in specs]
    shapes = {sim._scan_shapes() for sim in sims}
    if len(shapes) > 1:
        raise ValueError(
            f"seeds resolve different scanned trace shapes {sorted(shapes)} "
            "(select_k, steps_phys, batch_phys must agree); equalize data "
            "sizes across seeds or run serially")
    R = spec.rounds_per_dispatch
    per_seed = [[] for _ in sims]     # device metrics, read back at the end
    round0 = 0
    while round0 < spec.rounds:
        Rg = min(R, spec.rounds - round0)
        mark = spec.rounds - 1 if round0 + Rg == spec.rounds else -1
        for ms, sim in zip(per_seed, sims):
            ms.append(sim._scan_dispatch(Rg, mark))
        round0 += Rg
    stacked = {k: torch.cat([ms[k] for seed_ms in per_seed for ms in seed_ms])
               for k in per_seed[0][0]}
    host = ae.FederatedSimulation.scan_readback(stacked)
    elapsed = time.time() - t0
    out, off = [], 0
    for s, sim, seed_ms in zip(specs, sims, per_seed):
        for ms in seed_ms:
            Rg = ms["loss"].shape[0]
            sim._record_scanned({k: v[off:off + Rg] for k, v in host.items()})
            off += Rg
        out.append(result_from_simulation(s, sim, wall_time=elapsed))
    return out


# ---------------------------------------------------------------------------
# engine="spmd"
# ---------------------------------------------------------------------------

def _resolve_optimizer(spec: ExperimentSpec, st):
    opt = spec.optimizer
    if opt is None or opt == "sgd":
        # momentum=0 mirrors the simulator's per-round optimizer reset,
        # which is what makes the degenerate sim/spmd parity exact
        return optim_mod.sgd(st.lr, momentum=0.0)
    if isinstance(opt, str):
        if opt == "adamw":
            return optim_mod.adamw(st.lr)
        if opt == "adafactor":
            return optim_mod.adafactor(st.lr)
        raise ValueError(f"unknown optimizer {opt!r}; expected "
                         "'sgd', 'adamw', 'adafactor' or an Optimizer")
    return opt


def _spmd_control_plane(spec: ExperimentSpec, st, world,
                        round_time_hint=()) -> "fl_step.ControlPlane":
    """Device control-plane options of the spmd step: selection, dropout,
    per-client LR and wire quantization as cohort masking."""
    C = world.num_clients if world is not None else spec.world.num_clients
    k = C
    if st.grad_norm_selection or (st.selection and st.select_fraction < 1.0):
        k = max(1, int(st.select_fraction * C))
    dropout = ()
    if world is not None and any(p.dropout_p > 0 for p in world.profiles):
        dropout = tuple(float(p.dropout_p) for p in world.profiles)
    elif spec.world.dropout_p > 0:
        dropout = (float(spec.world.dropout_p),) * C
    return fl_step.ControlPlane(
        num_clients=C, select_k=k, candidate_frac=spec.candidate_frac,
        candidate_shards=spec.candidate_shards,
        grad_norm_selection=st.grad_norm_selection,
        dropout_p=dropout, quantize=st.quantize_updates,
        per_client_lr=st.per_client_lr,
        round_time_hint=tuple(float(t) for t in round_time_hint),
        seed=spec.seed)


def build_spmd_components(spec: ExperimentSpec, world=None,
                          round_time_hint=(), *, device=None, params=None,
                          agg_dtype: torch.dtype = torch.bfloat16):
    """(cfg, strategy, optimizer, state, step) for custom loops. Strategies
    that use selection, dropout, quantized updates or per-client LR get the
    device control plane (``fl_step.ControlPlane``); the step then takes
    its draws as a third argument. ``agg_dtype`` is the plain
    aggregation's precision on the CPU (the JAX package's bf16 unless
    named; the card's kernel reduces in f32)."""
    cfg = spec.resolve_model()
    st = spec.resolve_strategy()
    comm = spec.resolve_comm()
    opt = _resolve_optimizer(spec, st)
    cp = _spmd_control_plane(spec, st, world, round_time_hint)
    C = cp.num_clients
    if not cp.active():
        cp = None
    scn = spec.resolve_scenario()
    dirs = None
    if scn is not None and scn.drift is not None:
        dirs = scenario_mod.drift_directions(scn.drift, cfg.num_classes,
                                             cfg.num_features)
    topo = spec.resolve_topology()
    gen = torch.Generator().manual_seed(spec.seed)
    state = fl_step.init_state(gen, cfg, opt, control_plane=cp,
                               scenario=scn, topology=topo, params=params,
                               num_clients=C, device=device, comm=comm)
    step = fl_step.build_fl_train_step(cfg, opt, theta=st.theta,
                                       lr_schedule=spec.lr_schedule,
                                       beacon_bytes=comm.beacon_bytes,
                                       control_plane=cp, scenario=scn,
                                       drift_dirs=dirs, agg_dtype=agg_dtype,
                                       topology=topo, comm=comm,
                                       num_clients=C)
    return cfg, st, opt, state, step


def _account_comm_round(profiles, comm, steps, n_samples, mask,
                        participating, payload_bytes, acc,
                        lat_scale=None, bw_scale=None) -> None:
    """One sync round's analytic CommModel arithmetic, shared by the
    driver and the seed batch: each participating client pays train time
    + transfer (full payload if its update passed the mask, else the
    1-bit skip beacon); the round advances at the barrier (slowest
    arrival), and idle time is the spread below it. ``lat_scale`` /
    ``bw_scale`` are the round's per-client link multipliers (a
    scenario's link walks; None: static links). Accumulates into
    ``acc``'s sim/comm/idle time entries."""
    arrivals = []
    for cid, prof in enumerate(profiles):
        if not participating[cid]:
            continue        # unselected, dropped or churned: silent
        t_train = (steps * comm.t_launch
                   + n_samples * comm.t_sample) / max(prof.speed, 1e-3)
        payload = payload_bytes if mask[cid] > 0 else comm.beacon_bytes
        lat = prof.net_latency * (float(lat_scale[cid])
                                  if lat_scale is not None else 1.0)
        bw = comm.bandwidth * (float(bw_scale[cid])
                               if bw_scale is not None else 1.0)
        transfer = lat + payload / bw
        acc["comm_time"] += transfer
        arrivals.append(t_train + transfer)
    barrier = max(arrivals) if arrivals else 0.0
    acc["sim_time"] += barrier
    acc["idle_time"] += sum(barrier - a for a in arrivals)


def _spmd_loaders(spec: ExperimentSpec, st, world) -> List[ArrayLoader]:
    loaders = [ArrayLoader(arrays, st.batch_size, seed=spec.seed + cid)
               for cid, arrays in enumerate(world.client_arrays)]
    sizes = {l.batch_size for l in loaders}
    if len(sizes) > 1:
        raise ValueError(
            f"engine='spmd' needs one cohort batch shape, but client shard "
            f"sizes clamp batch_size to {sorted(sizes)}; lower "
            f"strategy batch_size or raise data.n_samples")
    return loaders


def _cohort_batch(loaders: Sequence[ArrayLoader], steps: int) -> dict:
    """Each client's ``steps`` draws, concatenated: numpy (C, steps·B, ...)."""
    per_client = []
    for loader in loaders:
        draws = [loader.sample() for _ in range(steps)]
        per_client.append({k: np.concatenate([d[k] for d in draws])
                           for k in draws[0]})
    return {k: np.stack([c[k] for c in per_client]) for k in per_client[0]}


def _build_eval(cfg, eval_fn):
    return eval_fn or model_api.build_default_eval(cfg)


# metrics the driver reads back each round, in one copy
_READBACK = ("mask", "selected", "delivered", "ratios", "bytes_sent",
             "accept_rate", "loss")


def _readback(metrics: dict) -> dict:
    """The per-round metrics on the host, from one device-to-host copy."""
    parts = [metrics[k].reshape(-1).to(torch.float32) for k in _READBACK]
    flat = torch.cat(parts).cpu().numpy()
    out, off = {}, 0
    for k, p in zip(_READBACK, parts):
        out[k] = flat[off:off + p.numel()]
        off += p.numel()
    return out


class SpmdDriver:
    """Stepping driver of the spmd engine.

    Owns the step, the per-client host loaders (seeded ``spec.seed +
    cid``, as the JAX package's), the draw source of the control plane
    and the analytic CommModel accounting. ``run_rounds(n)`` advances n
    rounds and returns their ``RoundRecord``s; each round reads its
    metrics back in one copy. ``theta_ratios`` keeps every θ test as
    (round, client, ratio), as the simulation does.
    ``state_dict`` / ``load_state_dict`` serialize the ``FLState`` (as CPU
    tensors), the loaders' Generator positions, the accumulators, the last
    accuracy and ``theta_ratios``, so a restored driver (on any device)
    continues as the uninterrupted one would (api/session.py).
    """

    def __init__(self, spec: ExperimentSpec, *, device=None, params=None,
                 draws=None, world_source=None,
                 agg_dtype: torch.dtype = torch.bfloat16):
        spec.validate()
        self.spec = spec
        self.device = resolve_device(device)
        self.comm = spec.resolve_comm()
        st = spec.resolve_strategy()
        self.world = spec.build_world()
        self.num_clients = self.world.num_clients
        self.loaders = _spmd_loaders(spec, st, self.world)
        bs = self.loaders[0].batch_size
        # the simulator's local steps as ONE cohort gradient step; the
        # minimum over clients keeps the (C, steps*bs, ...) batch
        # rectangular
        self.steps = min(ae.local_step_count(l.n, bs, st)
                         for l in self.loaders)
        self.n_samples = self.steps * bs
        # analytic per-client round time (train + transfer): the control
        # plane's timeliness signal for reliability-scored selection
        hint = [(self.steps * self.comm.t_launch
                 + self.n_samples * self.comm.t_sample)
                / max(p.speed, 1e-3) + p.net_latency
                for p in self.world.profiles]
        self.cfg, self.st, self._opt, self.state, self.step = \
            build_spmd_components(spec, world=self.world,
                                  round_time_hint=hint, device=self.device,
                                  params=params, agg_dtype=agg_dtype)
        cp = _spmd_control_plane(spec, st, self.world)
        self.draws = None            # the control plane's uniforms, if any
        if cp.active() and (cp.has_dropout or cp.draws_exploration):
            self.draws = draws if draws is not None else SpmdDraws(
                spec.seed, self.num_clients, cp.select_k, self.device)
        scn = spec.resolve_scenario()
        self.worlds = None           # the scenario's world, round by round
        if scn is not None:
            self.worlds = world_source or scenario_mod.WorldSource(
                scn, self.num_clients, self.device)
        self.evaluate = _build_eval(self.cfg, spec.eval_fn)
        self.eval_dev = ae._to_device(self.world.eval_arrays, self.device)
        self.param_bytes = int(fl_step._update_bytes(self.state.params))
        self.payload_bytes = (compression.arena_wire_bytes(
            arena_mod.ParamArena(self.state.params))
            if self.st.quantize_updates else self.param_bytes)
        self.round_idx = 0
        self.acc = {"sim_time": 0.0, "comm_time": 0.0, "idle_time": 0.0,
                    "bytes_sent": 0.0}
        self._last_accuracy = float("nan")
        self.theta_ratios = []

    # ------------------------------------------------------------------
    @property
    def params(self):
        return self.state.params

    @property
    def eval_arrays(self):
        return self.world.eval_arrays

    def _draw_batch(self) -> dict:
        return ae._to_device(_cohort_batch(self.loaders, self.steps),
                             self.device)

    def _account(self, rnd: int, m: dict, evaluate: bool) -> RoundRecord:
        mask = m["mask"]
        participating = (m["selected"] * m["delivered"]) > 0
        if self.st.theta is not None and rnd > 0:
            self.theta_ratios += [(rnd, cid, float(m["ratios"][cid]))
                                  for cid in np.flatnonzero(participating)]
        acc = self.acc
        lat_scale = bw_scale = None
        if self.worlds is not None:
            # a link walk re-prices this round's transfers (churned
            # clients already have delivered = 0)
            wv = self.worlds.view(rnd)
            lat_scale, bw_scale = wv["lat_scale"], wv["bw_scale"]
        _account_comm_round(self.world.profiles, self.comm, self.steps,
                            self.n_samples, mask, participating=participating,
                            payload_bytes=self.payload_bytes, acc=acc,
                            lat_scale=lat_scale, bw_scale=bw_scale)
        acc["bytes_sent"] += float(m["bytes_sent"][0])
        if evaluate:
            self._last_accuracy = float(
                self.evaluate(self.state.params, self.eval_dev))
        return RoundRecord(
            round=rnd, sim_time=acc["sim_time"],
            comm_time=acc["comm_time"], idle_time=acc["idle_time"],
            bytes_sent=acc["bytes_sent"],
            # the COUNT of client updates applied this round
            updates_applied=int(mask.sum()),
            accept_rate=float(m["accept_rate"][0]),
            accuracy=self._last_accuracy, loss=float(m["loss"][0]))

    def run_rounds(self, n: int, eval_final: bool = True
                   ) -> List[RoundRecord]:
        """Advance n rounds. Evaluation follows the absolute eval_every
        cadence; ``eval_final`` also evaluates the last round of the
        batch."""
        records = []
        first, last = self.round_idx, self.round_idx + n - 1
        for rnd in range(first, last + 1):
            batch = self._draw_batch()
            draws = (self.draws.round_draws(rnd) if self.draws is not None
                     else None)
            world = None
            if self.worlds is not None:
                self.worlds.prepare(rnd, 1)
                world = self.worlds.world(rnd)
            self.state, m = self.step(self.state, batch, draws, world)
            evaluate = ((rnd % self.spec.eval_every == 0)
                        or (eval_final and rnd == last))
            records.append(self._account(rnd, _readback(m), evaluate))
        self.round_idx = last + 1
        return records

    def client_pass_rates(self) -> np.ndarray:
        """(num_clients,) θ pass-rate EMAs of the device control plane."""
        if self.state.control is None:
            raise ValueError(
                "the spmd control plane is inactive (no selection / "
                "dropout / quantize / per-client LR), so no pass-rate "
                "EMAs are tracked")
        return self.state.control.pass_rate.cpu().numpy()

    # ------------------------------------------------------------------
    # serialization (ExperimentSession.checkpoint / restore)
    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        """Everything a resume equal by bits needs, as picklable host
        values; every tensor a CPU copy. The draws hold no state (seeded
        by (seed, absolute step), core/draws.py) and the world rebuilds
        from the spec."""
        return {
            "round_idx": self.round_idx,
            "fl_state": ae._moved(self.state, "cpu"),
            "loaders": [l.rng.bit_generator.state for l in self.loaders],
            "acc": dict(self.acc),
            "last_accuracy": self._last_accuracy,
            "theta_ratios": list(self.theta_ratios),
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict` output into a freshly built driver of
        the same spec, on this driver's device. The scenario's world of
        the last round run, recomputed from round 0, must equal the saved
        ``FLState.world`` by bits, or this raises."""
        if len(state["loaders"]) != len(self.loaders):
            raise ValueError(
                f"checkpoint has {len(state['loaders'])} client loaders, "
                f"this world has {len(self.loaders)}")
        fl = state["fl_state"]
        if (fl.control is None) != (self.state.control is None) or (
                fl.topology is None) != (self.state.topology is None):
            raise ValueError("checkpoint and driver disagree on the "
                             "control plane or the topology")
        self.round_idx = state["round_idx"]
        self.state = ae._moved(fl, self.device)
        if self.worlds is not None and self.round_idx > 0:
            differ = scenario_mod.view_differences(
                scenario_mod.host_view(self.state.world),
                self.worlds.view(self.round_idx - 1))
            if differ:
                raise ValueError(
                    f"the world of round {self.round_idx - 1} recomputed "
                    f"from the scenario differs from the checkpoint's in "
                    f"{differ}")
            self.worlds.reset()
        for l, s in zip(self.loaders, state["loaders"]):
            g = np.random.default_rng(0)
            g.bit_generator.state = s
            l.rng = g
        self.acc = dict(state["acc"])
        self._last_accuracy = state["last_accuracy"]
        self.theta_ratios = list(state["theta_ratios"])

    def result(self, records, wall_time: float = 0.0) -> ExperimentResult:
        return ExperimentResult(
            engine="spmd", strategy=self.spec.strategy_name(),
            rounds=len(records), seed=self.spec.seed, records=list(records),
            cfg=self.cfg, params=self.state.params,
            eval_arrays=self.world.eval_arrays,
            num_clients=self.num_clients, param_bytes=self.param_bytes,
            wall_time=wall_time)


# ---------------------------------------------------------------------------
# several seeds of the spmd engine
# ---------------------------------------------------------------------------

def seed_vectorizable(spec: ExperimentSpec, st=None) -> bool:
    """True when same-shape replicas of ``spec`` at several seeds can
    share one seed-stacked state: the spmd engine with an INACTIVE control
    plane (selection, dropout, quantization and per-client LR keep
    per-run state and draws, so those sweeps run serially)."""
    if spec.engine != "spmd":
        return False
    st = st or spec.resolve_strategy()
    if st.grad_norm_selection or (st.selection and st.select_fraction < 1.0):
        return False
    if st.quantize_updates or st.per_client_lr:
        return False
    if spec.resolve_scenario() is not None:
        return False        # each seed runs its own world
    if spec.resolve_topology() is not None:
        return False        # each seed its own TopologyState
    return spec.world.dropout_p <= 0


def run_spmd_seed_batch(spec: ExperimentSpec, seeds: Sequence[int], *,
                        device=None, params: Optional[Sequence[dict]] = None
                        ) -> List[ExperimentResult]:
    """Run ``spec`` at every seed with one seed-stacked ``FLState``.

    Per-seed worlds are built on the host; weights start per seed (drawn
    from the seed, or ``params[i]``), and every round steps all seeds
    through ``fl_step.build_seed_batched_step`` — the seeds one after
    another, as ctypes kernels cannot be vmapped. Every metric stays on
    the device until one readback after the last round; ``dispatches``
    counts the host's round steps and evaluations. Each seed's records
    equal its solo ``SpmdDriver`` run. Requires ``seed_vectorizable``
    specs and one cohort shape across seeds. Each result's ``wall_time``
    is the whole batch's.
    """
    t0 = time.time()
    st = spec.resolve_strategy()
    if not seed_vectorizable(spec, st):
        raise ValueError(
            "spec is not seed-vectorizable (needs engine='spmd' with an "
            "inactive control plane); run the seeds serially instead")
    dev = resolve_device(device)
    specs = [dataclasses.replace(spec, seed=int(s)).validate()
             for s in seeds]
    cfg = spec.resolve_model()
    comm = spec.resolve_comm()
    opt = _resolve_optimizer(spec, st)
    worlds = [s.build_world() for s in specs]
    C = worlds[0].num_clients
    loaders = [_spmd_loaders(s, st, w) for s, w in zip(specs, worlds)]
    steps_per_seed = {min(ae.local_step_count(l.n, ls[0].batch_size, st)
                          for l in ls) for ls in loaders}
    if len(steps_per_seed) > 1:
        raise ValueError(
            f"seeds produce different cohort shapes (local steps "
            f"{sorted(steps_per_seed)}); the seed batch needs one — "
            f"raise data.n_samples or run serially")
    steps = steps_per_seed.pop()
    n_samples = steps * loaders[0][0].batch_size

    state = fl_step.init_seed_batched_state(
        [s.seed for s in specs], cfg, opt, params=params, device=dev)
    vstep = fl_step.build_seed_batched_step(
        cfg, opt, theta=st.theta, lr_schedule=spec.lr_schedule,
        beacon_bytes=comm.beacon_bytes)
    evaluate = _build_eval(cfg, spec.eval_fn)
    eval_dev = [ae._to_device(w.eval_arrays, dev) for w in worlds]
    param_bytes = int(sum(p[0].numel() * p.element_size()
                          for p in state.params.values()))

    S = len(specs)
    eval_rounds = [rnd for rnd in range(spec.rounds)
                   if rnd % spec.eval_every == 0 or rnd == spec.rounds - 1]
    # every metric stays on the device until the one readback below
    dispatches = 0
    metric_buf, acc_buf = [], {}
    for rnd in range(spec.rounds):
        per_seed = [_cohort_batch(ls, steps) for ls in loaders]
        batch = ae._to_device({k: np.stack([b[k] for b in per_seed])
                               for k in per_seed[0]}, dev)
        state, m = vstep(state, batch)
        dispatches += 1
        metric_buf.append(m)
        if rnd in eval_rounds:
            acc_buf[rnd] = torch.stack([
                torch.as_tensor(evaluate({k: v[i] for k, v in
                                          state.params.items()},
                                         eval_dev[i]), device=dev)
                for i in range(S)])
            dispatches += 1
    assert dispatches == spec.rounds + len(eval_rounds), \
        "buffered readback must not change the dispatch count"
    keys = ("mask", "bytes_sent", "accept_rate", "loss")
    host = {k: torch.stack([m[k] for m in metric_buf]).cpu().numpy()
            for k in keys}
    host_acc = {rnd: a.cpu().numpy() for rnd, a in acc_buf.items()}

    records: List[List[RoundRecord]] = [[] for _ in range(S)]
    for i in range(S):
        acc = {"sim_time": 0.0, "comm_time": 0.0, "idle_time": 0.0,
               "bytes_sent": 0.0}
        last_acc = float("nan")
        for rnd in range(spec.rounds):
            mask = host["mask"][rnd, i]
            # no selection, dropout or quantization: everyone
            # participates with the full payload
            _account_comm_round(worlds[i].profiles, comm, steps, n_samples,
                                mask, participating=np.ones(C, bool),
                                payload_bytes=param_bytes, acc=acc)
            acc["bytes_sent"] += float(host["bytes_sent"][rnd, i])
            if rnd in host_acc:
                last_acc = float(host_acc[rnd][i])
            records[i].append(RoundRecord(
                round=rnd, sim_time=acc["sim_time"],
                comm_time=acc["comm_time"], idle_time=acc["idle_time"],
                bytes_sent=acc["bytes_sent"],
                updates_applied=int(mask.sum()),
                accept_rate=float(host["accept_rate"][rnd, i]),
                accuracy=last_acc, loss=float(host["loss"][rnd, i])))

    elapsed = time.time() - t0
    return [ExperimentResult(
        engine="spmd", strategy=s.strategy_name(), rounds=s.rounds,
        seed=s.seed, records=records[i], cfg=cfg,
        params={k: v[i] for k, v in state.params.items()},
        eval_arrays=worlds[i].eval_arrays, num_clients=C,
        param_bytes=param_bytes, wall_time=elapsed)
        for i, s in enumerate(specs)]
