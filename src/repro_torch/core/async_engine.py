"""Event-driven federated simulation engine (paper §IV-B, §V), in PyTorch.

N clients with heterogeneous speed / network / dropout profiles train the
real model on their non-IID shard; the server runs either

  sync  — barrier aggregation: the round completes when the SLOWEST
          selected client's update arrives; barrier idle time is tracked;
  async — the round clock advances at a QUORUM of arrivals, and updates
          are applied with staleness weighting α(τ)=α₀(1+τ)^-0.5.

Strategy flags mirror the paper's ablations (Table III): ``theta`` (the
sign-alignment filter against the sign of the last global update),
``selection`` (adaptive top-k), ``dynamic_batch`` and ``checkpointing``
(Weibull interval).

This is the JAX package's megastep path: each round's client work runs
as one cohort step per (steps, batch) shape group (core/megastep.py) and
the server aggregation is one weighted arena sum. All host randomness
(dropout, batch draws, selection) comes from the same seeded numpy
Generators in the same order as the JAX package, so timing, bytes and
selection reproduce it exactly; the parameters agree to float rounding.

Simulated time model (recorded separately from real wall time):
  train_time  = (steps · t_launch + samples · t_sample) / speed
  comm_time   = latency + bytes/bandwidth   (a θ-filtered client still
                sends a 1-bit "skip" beacon)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.convert import params_from_jax
from repro_torch.core import aggregation
from repro_torch.core import megastep as megastep_mod
from repro_torch.core.batchsize import BatchSizeController, ClientMetrics
from repro_torch.core.checkpoint_policy import fit_weibull, optimal_interval
from repro_torch.core.schedule import ScheduleSpec
from repro_torch.core.selection import AdaptiveClientSelector
from repro_torch.data.loader import ArrayLoader
from repro_torch.device import resolve_device
from repro_torch.kernels import arena as arena_mod
from repro_torch.models import api
from repro_torch.optim import adamw as optim_mod


@dataclasses.dataclass
class CommModel:
    bandwidth: float = 1e9        # bytes/s client->server
    latency: float = 0.05         # s per message
    t_sample: float = 2e-6        # s of compute per training sample (ref speed)
    t_launch: float = 0.0         # fixed per-step dispatch overhead
    beacon_bytes: float = 0.125   # 1-bit "skip" beacon of a θ-filtered client


@dataclasses.dataclass
class ClientProfile:
    speed: float = 1.0            # relative compute throughput
    net_latency: float = 0.05
    dropout_p: float = 0.0
    memory: float = 1.0


@dataclasses.dataclass
class StrategyConfig:
    # mode / quorum / alpha0 are the legacy spelling of the server
    # schedule axis; the engine consumes a ScheduleSpec derived from them
    mode: str = "async"                   # async | sync
    theta: Optional[float] = 0.65         # None -> no filtering
    selection: bool = True
    select_fraction: float = 1.0          # top-k fraction when selecting
    dynamic_batch: bool = False
    checkpointing: bool = True
    local_epochs: int = 1
    batch_size: int = 64
    lr: float = 5e-3
    alpha0: float = 1.0                   # fresh-update weight α₀
    quorum: float = 0.5                   # async round advances at this frac
    per_client_lr: bool = False           # FedL2P-style personalization
    grad_norm_selection: bool = False     # ACFL-style critical-period proxy
    quantize_updates: bool = False        # int8 + error feedback (not ported)
    max_samples_per_round: int = 4096     # per-round sample cap


def local_step_count(n: int, batch_size: int, st: StrategyConfig) -> int:
    """Per-round local step count, quantized UP to powers of two (caps the
    number of cohort shape groups per round)."""
    cap = max(1, st.max_samples_per_round // batch_size)
    steps = max(1, math.ceil(st.local_epochs * n / batch_size))
    steps = min(steps, cap)
    steps = 1 << (steps - 1).bit_length()          # next power of two
    return min(steps, cap)


@dataclasses.dataclass
class RoundMetrics:
    round: int
    sim_time: float          # simulated end-to-end wall clock so far
    comm_time: float         # cumulative transfer seconds
    idle_time: float         # cumulative barrier-idle seconds (sync only)
    bytes_sent: float
    updates_applied: int
    accept_rate: float
    accuracy: float
    loss: float


def _to_device(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """numpy batch -> device tensors; integer labels become int64 here, at
    the device boundary, so the numpy layer stays the JAX package's."""
    out = {}
    for k, a in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(a))
        if not t.is_floating_point():
            t = t.to(torch.int64)
        out[k] = t.to(device)
    return out


class FederatedSimulation:
    def __init__(self, cfg, client_arrays: List[dict], eval_arrays: dict,
                 strategy: StrategyConfig, profiles: List[ClientProfile],
                 comm: CommModel = None, seed: int = 0, eval_every: int = 1,
                 schedule: Optional[ScheduleSpec] = None, *, device=None,
                 params=None):
        if strategy.quantize_updates:
            raise NotImplementedError(
                "quantize_updates (int8 error feedback) is not ported yet; "
                "it comes with ROADMAP.md queue 1 item 7")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.strategy = strategy
        self.schedule = (schedule if schedule is not None
                         else ScheduleSpec.from_strategy(strategy)).validate()
        self.comm = comm or CommModel()
        self.profiles = profiles
        self.rng = np.random.default_rng(seed)
        self.seed = seed
        self.num_clients = len(client_arrays)
        self.eval_arrays = eval_arrays
        self._eval_dev = _to_device(eval_arrays, self.device)
        self.eval_every = max(1, int(eval_every))

        # --- model/optim setup ------------------------------------------
        if params is None:
            gen = torch.Generator().manual_seed(seed)
            params = api.init_params(gen, cfg)
        params = params_from_jax(
            {k: (v.detach().cpu() if torch.is_tensor(v) else v)
             for k, v in params.items()}, self.device)
        self.param_bytes = sum(p.numel() * p.element_size()
                               for p in params.values())
        self.opt = optim_mod.sgd(lr=strategy.lr)
        self._eval = api.build_default_eval(cfg)

        # --- cohort megastep / parameter arena ----------------------------
        self._arena = arena_mod.ParamArena(params)
        self._params_mat = self._arena.pack(params)
        self._ref_mat = None          # (rows, lane) int8, -2 padding
        self._cohort_step = megastep_mod.build_cohort_step(
            cfg, self.opt, self._arena, theta=strategy.theta)
        self._apply_update = megastep_mod.build_apply_update(self._arena)

        # --- per-client state --------------------------------------------
        self.batch_ctrl = BatchSizeController()

        def initial_bs(cid: int) -> int:
            bs = strategy.batch_size
            if strategy.dynamic_batch:
                p = profiles[cid]
                bs = self.batch_ctrl.initial(cid, ClientMetrics(
                    compute=p.speed, memory=p.memory,
                    latency=p.net_latency))
            return bs

        self.loaders = [ArrayLoader(arrays, initial_bs(cid), seed=seed + cid)
                        for cid, arrays in enumerate(client_arrays)]
        self.selector = AdaptiveClientSelector(self.num_clients, seed=seed)
        self.client_lr_scale = np.ones(self.num_clients)
        self.grad_norms = np.ones(self.num_clients)

        # --- fault tolerance ----------------------------------------------
        self.failure_log: List[float] = []
        self.checkpoints: Dict[int, bool] = {}
        self.ckpt_interval = 10.0
        self.recovery_time = 0.2      # restore from checkpoint
        self.restart_time = 1.0       # cold restart without one

        # τ < #arrivals <= N: one table lookup per arrival
        self._alpha_table = aggregation.staleness_weights_np(
            np.arange(self.num_clients + 1), self.schedule.alpha0)

        # --- accounting -----------------------------------------------------
        self.sim_time = 0.0
        self.comm_time = 0.0
        self.idle_time = 0.0
        self.bytes_sent = 0.0
        self.server_step = 0
        self.round_idx = 0            # absolute rounds completed
        self.history: List[RoundMetrics] = []
        # (round, cid, ratio) of every θ test made against a reference —
        # what a parity check reads to see how close a decision came to θ
        self.theta_ratios: List[tuple] = []

    # ------------------------------------------------------------------
    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The global parameters, as views into the arena."""
        return self._arena.unpack(self._params_mat)

    # ------------------------------------------------------------------
    # client-local work (simulated timing + real gradients)
    # ------------------------------------------------------------------
    def _client_batches(self, cid: int):
        """Fixed-step resampled batches (step count from
        ``local_step_count``)."""
        loader = self.loaders[cid]
        bs = loader.batch_size
        steps = local_step_count(loader.n, bs, self.strategy)
        batches = [loader.sample() for _ in range(steps)]
        stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
        return stacked, steps, steps * bs

    def _train_time(self, steps: int, n_samples: int,
                    prof: ClientProfile) -> float:
        return (steps * self.comm.t_launch
                + n_samples * self.comm.t_sample) / max(prof.speed, 1e-3)

    def _transfer_time(self, sent: bool, prof: ClientProfile) -> float:
        lat, bw = prof.net_latency, self.comm.bandwidth
        if sent:
            return lat + self.param_bytes / bw
        return lat + self.comm.beacon_bytes / bw

    # ------------------------------------------------------------------
    # rounds
    # ------------------------------------------------------------------
    def _select_clients(self) -> List[int]:
        st = self.strategy
        k = max(1, int(st.select_fraction * self.num_clients))
        if st.grad_norm_selection:
            return [int(c) for c in np.argsort(-self.grad_norms)[:k]]
        if st.selection and st.select_fraction < 1.0:
            return self.selector.select(k)
        return list(range(self.num_clients))

    def run_round(self, rnd: int, evaluate: bool = True) -> RoundMetrics:
        self.round_idx += 1
        return self._run_round_mega(rnd, evaluate)

    def _finish_round(self, rnd: int, evaluate: bool, n_selected: int,
                      losses: List[float], n_sent: int, updates_applied: int,
                      round_times: Dict[int, float]) -> RoundMetrics:
        """Round tail: Weibull checkpoint refit, dynamic-batch feedback,
        (optional) evaluation, metrics."""
        st = self.strategy
        if st.checkpointing and len(self.failure_log) >= 2:
            lam, k = fit_weibull(np.diff(sorted(self.failure_log)))
            self.ckpt_interval = optimal_interval(
                max(self.sim_time, 1.0), self.recovery_time, lam, k)
        if st.dynamic_batch:
            for cid, b in self.batch_ctrl.feedback(round_times).items():
                if cid < len(self.loaders):
                    self.loaders[cid].set_batch_size(b)
        if evaluate:
            acc = float(self._eval(self.params, self._eval_dev))
        else:
            # off-round: carry the last measured accuracy forward
            acc = self.history[-1].accuracy if self.history else float("nan")
        m = RoundMetrics(
            round=rnd, sim_time=self.sim_time, comm_time=self.comm_time,
            idle_time=self.idle_time, bytes_sent=self.bytes_sent,
            updates_applied=updates_applied,
            accept_rate=n_sent / max(n_selected, 1), accuracy=acc,
            loss=float(np.mean(losses)) if losses else float("nan"))
        self.history.append(m)
        return m

    def _run_round_mega(self, rnd: int, evaluate: bool = True) -> RoundMetrics:
        st = self.strategy
        selected = self._select_clients()
        round_start = self.sim_time

        # pass 1: dropout draws, in the JAX package's Generator order
        cohort: List[int] = []
        meta: Dict[int, tuple] = {}       # cid -> (delay, steps, n_samples)
        for cid in selected:
            prof = self.profiles[cid]
            delay = 0.0
            if self.rng.random() < min(1.0, prof.dropout_p):
                self.failure_log.append(round_start)
                self.selector.observe(cid, delivered=False)
                if not st.checkpointing:
                    continue                      # client lost this round
                delay = (self.recovery_time if self.checkpoints.get(cid)
                         else self.restart_time)
            cohort.append(cid)
            meta[cid] = (delay, 0, 0)

        # pass 2: per-loader batch draws, grouped by (steps, batch)
        groups: Dict[tuple, dict] = {}
        for cid in cohort:
            batches, steps, n_samples = self._client_batches(cid)
            meta[cid] = (meta[cid][0], steps, n_samples)
            g = groups.setdefault((steps, self.loaders[cid].batch_size),
                                  {"cids": [], "batches": []})
            g["cids"].append(cid)
            g["batches"].append(batches)

        # pass 3: one cohort step per shape group. The cohort width is
        # padded UP to a power of two (the last client's batch replicated,
        # its results discarded, its aggregation weight 0), as in the JAX
        # package, so the same arena shapes reach the kernels.
        has_ref = self._ref_mat is not None and st.theta is not None
        per_client: Dict[int, tuple] = {}     # cid -> (loss, ratio, norm)
        group_results = []                    # (cids, padded_C, deltas)
        for (steps, bs), g in groups.items():
            cids = g["cids"]
            C = len(cids)
            padded = 1 << (C - 1).bit_length()
            blist = g["batches"] + [g["batches"][-1]] * (padded - C)
            batch = _to_device({k: np.stack([b[k] for b in blist])
                                for k in blist[0]}, self.device)
            lr_scale = np.ones(padded, np.float32)
            lr_scale[:C] = self.client_lr_scale[cids]
            deltas, losses, ratios, norms = self._cohort_step(
                self._params_mat, batch,
                torch.from_numpy(lr_scale).to(self.device),
                self._ref_mat if has_ref else None, has_ref=has_ref)
            losses, ratios, norms = (losses.cpu().numpy(),
                                     ratios.cpu().numpy(),
                                     norms.cpu().numpy())
            for j, cid in enumerate(cids):
                per_client[cid] = (float(losses[j]), float(ratios[j]),
                                   float(norms[j]))
                if has_ref:
                    self.theta_ratios.append((rnd, cid, float(ratios[j])))
            group_results.append((cids, padded, deltas))

        # pass 4: event-driven accounting, in the selection order
        losses_all: List[float] = []
        arrivals = []                     # (arrive, cid, sent)
        round_times: Dict[int, float] = {}
        n_sent = 0
        for cid in cohort:
            delay, steps, n_samples = meta[cid]
            loss, ratio, gn = per_client[cid]
            prof = self.profiles[cid]
            losses_all.append(loss)
            sent = (st.theta is None or not has_ref
                    or ratio >= st.theta)
            transfer = self._transfer_time(sent, prof)
            arrive = (round_start + delay
                      + self._train_time(steps, n_samples, prof) + transfer)
            arrivals.append((arrive, cid, sent))
            round_times[cid] = arrive - round_start
            self.selector.observe(cid, delivered=True, passed=sent,
                                  round_time=arrive - round_start)
            self.grad_norms[cid] = 0.5 * self.grad_norms[cid] + 0.5 * gn
            if st.per_client_lr:
                self.client_lr_scale[cid] = float(np.clip(
                    self.client_lr_scale[cid] * (1.05 if gn < 1.0 else 0.9),
                    0.25, 2.0))
            if sent:
                n_sent += 1
                self.bytes_sent += float(self.param_bytes)
            else:
                self.bytes_sent += self.comm.beacon_bytes
            self.comm_time += transfer
            if st.checkpointing:
                self.checkpoints[cid] = True   # periodic local state save

        arrivals.sort(key=lambda a: a[0])
        updates_applied = 0
        sched = self.schedule
        weights: Dict[int, float] = {}    # cid -> aggregation weight

        if sched.is_sync:
            senders = [cid for (_, cid, sent) in arrivals if sent]
            if senders:
                w = 1.0 / len(senders)
                weights = {cid: w for cid in senders}
                self.server_step += 1
                updates_applied = len(senders)
            if arrivals:
                barrier = arrivals[-1][0]
                self.idle_time += sum(barrier - a for (a, *_r) in arrivals)
                self.sim_time = barrier
        else:
            # async: quorum clock + buffered mean of staleness-discounted
            # deltas; semi-async drops arrivals staler than the bound
            if arrivals:
                q_idx = max(0, math.ceil(sched.quorum * len(arrivals)) - 1)
                self.sim_time = arrivals[q_idx][0]
                buf = []
                for i, (_arrive, cid, sent) in enumerate(arrivals):
                    if not sent:
                        continue
                    tau = max(0, i - q_idx)
                    if (sched.max_staleness is not None
                            and tau > sched.max_staleness):
                        continue          # too stale: transmitted, dropped
                    alpha = float(self._alpha_table[tau])
                    buf.append((cid, alpha))
                    self.server_step += 1
                    updates_applied += 1
                if buf:
                    inv = 1.0 / len(buf)
                    weights = {cid: alpha * inv for cid, alpha in buf}

        # server aggregation: one weighted arena sum per shape group
        if weights:
            d_groups = tuple(d for (_cids, _p, d) in group_results)
            w_groups = []
            for cids, padded, _d in group_results:
                w = np.zeros(padded, np.float32)    # pad rows weigh nothing
                w[:len(cids)] = [weights.get(c, 0.0) for c in cids]
                w_groups.append(torch.from_numpy(w).to(self.device))
            new_mat, ref_mat = self._apply_update(self._params_mat,
                                                  d_groups, tuple(w_groups))
            self._params_mat = new_mat
            # reference direction = sign of the global movement this round
            if updates_applied and st.theta is not None:
                self._ref_mat = ref_mat

        return self._finish_round(rnd, evaluate, len(selected), losses_all,
                                  n_sent, updates_applied, round_times)

    def run(self, num_rounds: int,
            eval_final: bool = True) -> List[RoundMetrics]:
        first = self.round_idx          # absolute: resumes keep numbering
        for r in range(first, first + num_rounds):
            # eval_every > 1 skips the eval on off-rounds; the final round
            # is evaluated too (unless eval_final=False)
            evaluate = ((r % self.eval_every == 0)
                        or (eval_final and r == first + num_rounds - 1))
            self.run_round(r, evaluate=evaluate)
        return self.history


# ---------------------------------------------------------------------------
# profile factories (the same Generator draws, in the same order, as the
# JAX package's)
# ---------------------------------------------------------------------------

def heterogeneous_profile_arrays(n: int, seed: int = 0,
                                 dropout_p: float = 0.0,
                                 speed_sigma: float = 0.6) -> dict:
    rng = np.random.default_rng(seed)
    speeds = rng.lognormal(0.0, speed_sigma, size=n)
    lats = rng.uniform(0.01, 0.2, size=n)
    mems = rng.uniform(0.4, 1.0, size=n)
    return {"speed": speeds, "net_latency": lats,
            "dropout_p": np.full(n, float(dropout_p)), "memory": mems}


def uniform_profile_arrays(n: int, dropout_p: float = 0.0) -> dict:
    return {"speed": np.ones(n), "net_latency": np.zeros(n),
            "dropout_p": np.full(n, float(dropout_p)),
            "memory": np.ones(n)}


def heterogeneous_profiles(n: int, seed: int = 0, dropout_p: float = 0.0,
                           speed_sigma: float = 0.6) -> List[ClientProfile]:
    """Lognormal speeds (stragglers!), uniform latencies."""
    a = heterogeneous_profile_arrays(n, seed=seed, dropout_p=dropout_p,
                                     speed_sigma=speed_sigma)
    return [ClientProfile(speed=float(s), net_latency=float(l),
                          dropout_p=dropout_p, memory=float(m))
            for s, l, m in zip(a["speed"], a["net_latency"], a["memory"])]


def uniform_profiles(n: int, dropout_p: float = 0.0) -> List[ClientProfile]:
    return [ClientProfile(speed=1.0, net_latency=0.0, dropout_p=dropout_p,
                          memory=1.0) for _ in range(n)]
