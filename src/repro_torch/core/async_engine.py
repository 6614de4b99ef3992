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

Three execution paths, as in the JAX package. By default (``megastep``)
each round's client work runs as one cohort step per (steps, batch) shape
group (core/megastep.py) and the server aggregation is one weighted arena
sum. ``megastep=False`` selects the per-client reference loop: each client
trains alone, is θ-tested leaf by leaf, and the server averages parameter
dicts. ``rounds_per_dispatch=R`` selects the scanned path: the control
plane lives on the device (core/control.py) and R whole rounds run as one
dispatch (``megastep.build_scanned_rounds``), read back once at its end;
``fused_eval`` evaluates inside the dispatch too. Its random draws come
from a draw source (core/draws.py), not from the host Generators.
``quantize_updates`` puts int8 with error feedback on the wire on any
path (core/compression.py): one error-feedback arena for all clients on
the megastep and scanned paths, one buffer dict per client on the loop.
A ``scenario`` (core/scenario.py) changes the world round by round on
every path: churn takes clients out of selection, link walks re-price
each transfer, a regime multiplies the dropout probabilities, drift
shifts the training batches and byzantine clients scale their updates
before the codec and the θ filter. Every path takes the world of round r
from one ``WorldSource`` (computed on the host), so they all run the same
world, on the card as on the CPU.
A hierarchical ``topology`` (repro_torch/topology) is a measurement layer
over the flat round on every path: each round the leaf pods accumulate
exactly the weighted deltas the aggregation consumed and the due
inter-tier syncs run (the loop and the megastep once a round on the host
round index, the scanned path inside the dispatch), so the records are
those of the same run without it; ``topology_summary()`` reads its
accounting.
On the megastep and the loop, all host randomness (dropout, batch draws,
selection) comes from the same seeded numpy Generators in the same order
as the JAX package, so timing, bytes and selection reproduce it exactly;
the parameters agree to float rounding.

Simulated time model (recorded separately from real wall time):
  train_time  = (steps · t_launch + samples · t_sample) / speed
  comm_time   = latency + bytes/bandwidth   (a θ-filtered client still
                sends a 1-bit "skip" beacon)
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.convert import params_from_jax
from repro_torch.core import aggregation, alignment, compression
from repro_torch.core import control as control_mod
from repro_torch.core import megastep as megastep_mod
from repro_torch.core import scenario as scenario_mod
from repro_torch.core.batchsize import BatchSizeController, ClientMetrics
from repro_torch.core.checkpoint_policy import fit_weibull, optimal_interval
from repro_torch.core.draws import HostDraws
from repro_torch.core.schedule import ScheduleSpec
from repro_torch.core.selection import (AdaptiveClientSelector,
                                        candidate_mask_np)
from repro_torch.data.loader import ArrayLoader, LoaderPool
from repro_torch.device import resolve_device
from repro_torch.kernels import arena as arena_mod
from repro_torch.models import api
from repro_torch.optim import adamw as optim_mod
from repro_torch.topology import engine as topology_mod
from repro_torch.topology.spec import resolve_topology


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
    quantize_updates: bool = False        # int8 + error feedback on the wire
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


def _moved(tree, device):
    """A copy of a tree of tensors (dicts, NamedTuples, tuples, None) on
    ``device``."""
    if torch.is_tensor(tree):
        return tree.to(device, copy=True)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _moved(t, device) for k, t in tree.items()}
    parts = [_moved(t, device) for t in tree]
    return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)


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
                 params=None, eval_fn: Optional[Callable] = None,
                 megastep: bool = True,
                 rounds_per_dispatch: Optional[int] = None,
                 fused_eval: bool = False, draws=None, scenario=None,
                 world_source=None, topology=None,
                 candidate_frac: Optional[float] = None,
                 candidate_shards: int = 8):
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
        self.megastep = bool(megastep)
        # rounds_per_dispatch=None -> host control plane (per-round
        # megastep / reference loop); an int >= 1 -> the device-resident
        # control plane, R rounds per dispatch
        self.rounds_per_dispatch = (int(rounds_per_dispatch)
                                    if rounds_per_dispatch else None)
        if self.rounds_per_dispatch and not self.megastep:
            raise ValueError("rounds_per_dispatch requires megastep=True "
                             "(the scanned path runs on the parameter "
                             "arena)")
        # fused eval evaluates inside the dispatch: it needs the scanned
        # path and the default eval, whose result stays a device tensor
        self.fused_eval = bool(fused_eval)
        if self.fused_eval and not self.rounds_per_dispatch:
            raise ValueError("fused_eval evaluates inside the scanned "
                             "dispatch — set rounds_per_dispatch")
        if self.fused_eval and eval_fn is not None:
            raise ValueError("fused_eval keeps the accuracy on the device "
                             "inside the dispatch; a custom eval_fn returns "
                             "a host float — drop one of the two")
        # two-stage selection: None -> single-stage; 1.0 equals it by bits
        # (an all-True candidate mask) on every path
        self.candidate_frac = (None if candidate_frac is None
                               else float(candidate_frac))
        self.candidate_shards = max(1, int(candidate_shards))
        # a non-resident world (api/world.LazyWorld) materializes loaders
        # per selected cohort; the scanned path stacks the population
        self._lazy_world = bool(getattr(client_arrays, "lazy", False))
        if self._lazy_world and self.rounds_per_dispatch:
            raise ValueError(
                "the scanned control plane gathers client data "
                "device-side, so the population must be resident — drop "
                "rounds_per_dispatch for lazy worlds")
        # --- dynamic-world scenario (core/scenario.py) --------------------
        # None / inactive -> the world stays frozen at round 0 and every
        # path below runs as it does without one; ``world_source`` replaces
        # the port's own trajectory (a test feeds the reference's)
        self.scenario = scenario_mod.resolve_scenario(scenario)
        self._worlds = None
        self._world_view = None       # this round's host view (or None)
        self._drift_dirs = None
        if self.scenario is not None:
            self._worlds = world_source or scenario_mod.WorldSource(
                self.scenario, self.num_clients, self.device)
            if self.scenario.drift is not None:
                keys = set(client_arrays[0])
                if "x" not in keys or "y" not in keys:
                    raise ValueError(
                        "scenario.drift needs feature/label client arrays "
                        f"('x' + 'y'); got {sorted(keys)}")
                self._drift_dirs = torch.from_numpy(
                    scenario_mod.drift_directions(
                        self.scenario.drift, cfg.num_classes,
                        cfg.num_features)).to(self.device)

        # host round trips of the scanned path: one per dispatch of R
        # rounds (its metrics read back once) plus one per host eval
        # readback; the megastep and the loop paths read back several
        # times a round and do not count here
        self.dispatches = 0

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
        # eval_fn(params_dict, eval_batch) -> float replaces the default
        self._eval = eval_fn or api.build_default_eval(cfg)

        # --- parameter state: the arena (megastep) or a dict (loop) -------
        self._arena = arena_mod.ParamArena(params)
        self._params_mat = None       # (rows, lane) f32 when megastep
        self._params_tree = None      # parameter dict on the loop
        self._ref_mat = None          # (rows, lane) int8, -2 padding
        self.ref_sign = None          # the loop's int8 sign dict
        self._ef_arena = None         # (N + 1, rows, lane) EF buffers
        self._ef_state: Dict[int, Dict[str, torch.Tensor]] = {}  # loop EF
        if self.megastep:
            self._params_mat = self._arena.pack(params)
            self._cohort_step = megastep_mod.build_cohort_step(
                cfg, self.opt, self._arena, theta=strategy.theta,
                quantize=strategy.quantize_updates)
            self._apply_update = megastep_mod.build_apply_update(self._arena)
            if strategy.quantize_updates:
                # the extra row N takes the residuals of the cohort-width
                # padding rows; no result reads it
                self._ef_arena = compression.init_error_arena(
                    self.num_clients + 1, self._arena, self.device)
        else:
            self._params_tree = params
        # wire bytes of one compressed update (the loop sets it from the
        # first payload it sends)
        self._wire_bytes = (compression.arena_wire_bytes(self._arena)
                            if self.megastep and strategy.quantize_updates
                            else None)

        # --- hierarchical topology (repro_torch/topology) -----------------
        # an accumulate-and-sync measurement layer over the flat round:
        # the training trajectory is untouched; its state advances EVERY
        # round on every path, so the absolute-round sync cadence does not
        # depend on how rounds are grouped
        self.topology = resolve_topology(topology)
        self._topo = None
        self._topo_state = None
        if self.topology is not None:
            self._topo = topology_mod.TopologyRuntime(
                self.topology, self.num_clients, self._arena, self.comm,
                self.device)
            self._topo_state = self._topo.init()

        # --- per-client state --------------------------------------------
        # the closure holds the controller, not ``self``: the lazy
        # world's LoaderPool keeps it, and a reference back to the
        # simulation would keep a finished run's device arrays alive until
        # the cycle collector happened to run
        batch_ctrl = self.batch_ctrl = BatchSizeController()

        def initial_bs(cid: int) -> int:
            bs = strategy.batch_size
            if strategy.dynamic_batch:
                p = profiles[cid]
                bs = batch_ctrl.initial(cid, ClientMetrics(
                    compute=p.speed, memory=p.memory,
                    latency=p.net_latency))
            return bs

        if self._lazy_world:
            # loaders (and the shards behind them) materialize per selected
            # cohort, LRU-bounded: host memory follows the cohort size
            k = max(1, int(strategy.select_fraction * self.num_clients))
            self.loaders = LoaderPool(client_arrays, initial_bs, seed=seed,
                                      capacity=max(4 * k, 64))
        else:
            self.loaders = [ArrayLoader(arrays, initial_bs(cid),
                                        seed=seed + cid)
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

        # τ < #arrivals <= the cohort size: one table lookup per arrival
        self._alpha_table = aggregation.staleness_weights_np(
            np.arange(self._cohort_size() + 1), self.schedule.alpha0)

        # --- device-resident control plane (scanned path, built lazily) ---
        self._draws = draws           # None -> HostDraws at _scan_setup
        self._scan_fns: Dict[int, Callable] = {}   # R -> dispatch callable
        self._scan_world = None       # (data, sizes, speed, latency, drop_p)
        self._scan_ctl = None         # ControlState carry
        self._scan_ref = None         # (rows, lane) int8 reference carry
        self._scan_ref_valid = None   # 0-dim bool carry
        self._scan_acc = None         # (4,) f32 sim/comm/idle/bytes carry
        self._scan_prev_acc = None    # 0-dim f32 accuracy carry (fused)
        self._scan_alpha = None       # α(τ) for τ < K on the device
        self._scan_round0 = 0

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
        # the scanned path's selected cohort of every round
        self.cohorts: List[List[int]] = []

    # ------------------------------------------------------------------
    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The global parameters: views into the arena on the megastep
        path, the loop's own dict otherwise."""
        if self.megastep:
            return self._arena.unpack(self._params_mat)
        return self._params_tree

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

    def _payload_bytes(self) -> float:
        if self.strategy.quantize_updates and self._wire_bytes:
            return float(self._wire_bytes)
        return float(self.param_bytes)

    def _transfer_time(self, sent: bool, prof: ClientProfile,
                       cid: Optional[int] = None) -> float:
        lat, bw = prof.net_latency, self.comm.bandwidth
        wv = self._world_view
        if wv is not None and cid is not None:
            # the link walk re-prices this round's transfer
            lat *= float(wv["lat_scale"][cid])
            bw *= float(wv["bw_scale"][cid])
        if sent:
            return lat + self._payload_bytes() / bw
        return lat + self.comm.beacon_bytes / bw

    def _drift(self, batch: dict) -> dict:
        """This round's drift on a batch on the device (none without it)."""
        if self._drift_dirs is None:
            return batch
        return scenario_mod.apply_drift(
            batch, self._world_view["drift_amp"], self._drift_dirs)

    def _train_client(self, cid: int):
        """The loop's local training of one client, as a cohort of one;
        a byzantine client's update is scaled before the codec; with
        compression, the update is the dequantized payload and the
        client's error-feedback buffers advance. Returns (new_params,
        delta, loss, train_time)."""
        batches, steps, n_samples = self._client_batches(cid)
        batch = self._drift(_to_device({k: v[None] for k, v in
                                        batches.items()}, self.device))
        lr_scale = torch.tensor([self.client_lr_scale[cid]],
                                dtype=torch.float32, device=self.device)
        old = self.params
        trained, loss = megastep_mod.local_sgd(self.cfg, self.opt, old,
                                               batch, lr_scale)
        new_params = {k: v[0] for k, v in trained.items()}
        delta = {k: new_params[k] - old[k] for k in old}
        wv = self._world_view
        if wv is not None and float(wv["byz_factor"][cid]) != 1.0:
            f = torch.tensor(float(wv["byz_factor"][cid]),
                             dtype=torch.float32, device=self.device)
            delta = {k: d * f for k, d in delta.items()}
            new_params = {k: old[k] + delta[k] for k in old}
        if self.strategy.quantize_updates:
            err = self._ef_state.setdefault(
                cid, compression.init_error_state(delta))
            q, s, _n, self._ef_state[cid] = compression.compress_update(
                delta, err)
            delta = compression.decompress_update(q, s, delta)
            new_params = {k: old[k] + delta[k] for k in old}
            self._wire_bytes = compression.transport_bytes(q, s)
        train_time = self._train_time(steps, n_samples, self.profiles[cid])
        return new_params, delta, float(loss[0]), train_time

    def _filter_update(self, rnd: int, cid: int, delta) -> bool:
        """The loop's client-side θ filter (Algorithm 1 lines 27-32):
        whether the client sends its update."""
        if self.strategy.theta is None or self.ref_sign is None:
            return True
        ratio = float(alignment.alignment_ratio(delta, self.ref_sign))
        self.theta_ratios.append((rnd, cid, ratio))
        return ratio >= self.strategy.theta

    # ------------------------------------------------------------------
    # rounds
    # ------------------------------------------------------------------
    def _cohort_size(self) -> int:
        """The most clients a round selects: K under selection, else N."""
        st = self.strategy
        if st.grad_norm_selection or (st.selection
                                      and st.select_fraction < 1.0):
            return max(1, int(st.select_fraction * self.num_clients))
        return self.num_clients

    def _select_clients(self) -> List[int]:
        """This round's cohort. Under churn the live roster applies before
        top-k, as on the scanned and spmd paths: churned clients are
        absent, never observed and never failed. With ``candidate_frac``
        the top-k and the ε pool are restricted to the candidate union of
        the same live-masked scores the device paths rank."""
        st = self.strategy
        k = max(1, int(st.select_fraction * self.num_clients))
        live = (self._world_view["live"] if self._world_view is not None
                else None)
        if st.grad_norm_selection:
            gn = self.grad_norms if live is None else np.where(
                live, self.grad_norms, -np.inf)
            return [int(c) for c in np.argsort(-gn)[:k]
                    if live is None or live[c]]
        if st.selection and st.select_fraction < 1.0:
            candidates = None
            if self.candidate_frac is not None:
                scores = np.array([self.selector.score(c)
                                   for c in range(self.num_clients)])
                if live is not None:
                    scores = np.where(np.asarray(live, bool), scores,
                                      -np.inf)
                candidates = candidate_mask_np(scores, k,
                                               self.candidate_frac,
                                               self.candidate_shards)
            return self.selector.select(k, live=live, candidates=candidates)
        return [c for c in range(self.num_clients)
                if live is None or live[c]]

    def _advance_world(self) -> None:
        """The world of the round now starting (absolute index
        ``round_idx - 1``), as one host view for its accounting."""
        if self._worlds is not None:
            self._world_view = self._worlds.view(self.round_idx - 1)

    def run_round(self, rnd: int, evaluate: bool = True) -> RoundMetrics:
        self.round_idx += 1
        self._advance_world()
        if self.megastep:
            return self._run_round_mega(rnd, evaluate)
        return self._run_round_loop(rnd, evaluate)

    def _draw_dropout(self, cid: int, round_start: float) -> Optional[float]:
        """The client's dropout draw: None if it is lost this round, else
        its restart delay (0 when it did not drop)."""
        p = self.profiles[cid].dropout_p
        if self._world_view is not None:
            p = p * self._world_view["dropout_scale"]
        if self.rng.random() < min(1.0, p):
            self.failure_log.append(round_start)
            self.selector.observe(cid, delivered=False)
            if not self.strategy.checkpointing:
                return None                       # client lost this round
            return (self.recovery_time if self.checkpoints.get(cid)
                    else self.restart_time)
        return 0.0

    def _deliver(self, cid: int, round_start: float, delay: float,
                 train_time: float, sent: bool, gn: float) -> float:
        """One trained client's event accounting, in selection order:
        transfer, selector, grad-norm EMA, LR scale, bytes, checkpoint.
        Returns its arrival time."""
        st = self.strategy
        transfer = self._transfer_time(sent, self.profiles[cid], cid)
        arrive = round_start + delay + train_time + transfer
        self.selector.observe(cid, delivered=True, passed=sent,
                              round_time=arrive - round_start)
        self.grad_norms[cid] = 0.5 * self.grad_norms[cid] + 0.5 * gn
        if st.per_client_lr:
            self.client_lr_scale[cid] = float(np.clip(
                self.client_lr_scale[cid] * (1.05 if gn < 1.0 else 0.9),
                0.25, 2.0))
        if sent:
            self.bytes_sent += self._payload_bytes()
        else:
            self.bytes_sent += self.comm.beacon_bytes
        self.comm_time += transfer
        if st.checkpointing:
            self.checkpoints[cid] = True   # periodic local state save
        return arrive

    def _schedule(self, arrivals: List[tuple]) -> List[tuple]:
        """Advance the clock over the round's arrivals (sorted in place;
        (arrive, cid, sent, ...)) and return the updates the server
        applies, as (cid, α) in arrival order: every sender with α = 1
        under sync; under async the senders no staler than the bound, with
        α(τ) from the quorum arrival on."""
        arrivals.sort(key=lambda a: a[0])
        sched = self.schedule
        applied = []
        if sched.is_sync:
            applied = [(a[1], 1.0) for a in arrivals if a[2]]
            if applied:
                self.server_step += 1
            if arrivals:
                barrier = arrivals[-1][0]
                self.idle_time += sum(barrier - a[0] for a in arrivals)
                self.sim_time = barrier
        elif arrivals:
            # async: quorum clock + buffered mean of staleness-discounted
            # deltas; semi-async drops arrivals staler than the bound
            q_idx = max(0, math.ceil(sched.quorum * len(arrivals)) - 1)
            self.sim_time = arrivals[q_idx][0]
            for i, a in enumerate(arrivals):
                if not a[2]:
                    continue
                tau = max(0, i - q_idx)
                if (sched.max_staleness is not None
                        and tau > sched.max_staleness):
                    continue          # too stale: transmitted, dropped
                applied.append((a[1], float(self._alpha_table[tau])))
                self.server_step += 1
        return applied

    def _topology_host_round(self, deltas, cids, weights) -> None:
        """Advance the topology state for the round that just ran on the
        loop or the megastep: leaf-pod accumulation of exactly the
        weighted deltas the aggregation consumed, and the due syncs, on
        the absolute round index ``round_idx - 1``. Called every round,
        empty rounds too.

        deltas: a list of (rows, lane) arena rows (the loop) with their
        client ids ``cids``, or the megastep's (cids, padded, deltas) shape
        groups (their real rows, in group order); weights: cid -> weight.
        """
        if self._topo is None:
            return
        if deltas and isinstance(deltas[0], tuple):
            d = torch.cat([g[2][:len(g[0])] for g in deltas])
            cids = [c for g in deltas for c in g[0]]
        elif deltas:
            d = torch.stack(deltas)
        else:                              # empty round: cadence still ticks
            d = torch.zeros((1, self._arena.rows, self._arena.lane),
                            dtype=torch.float32, device=self.device)
            cids = [0]
        w = torch.tensor([float(weights.get(c, 0.0)) for c in cids],
                         dtype=torch.float32).to(self.device)
        pods = self._topo.pod_of[torch.tensor(cids, dtype=torch.int64)
                                 .to(self.device)]
        self._topo_state = self._topo.step(self._topo_state,
                                           self.round_idx - 1, d, w, pods)

    def topology_summary(self) -> Optional[dict]:
        """Per-tier inter-tier bytes, seconds, syncs, accepts and vetoes and
        the flat-star comparison (None without a topology)."""
        if self._topo is None:
            return None
        return self._topo.summary(self._topo_state, rounds=self.round_idx)

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
        delays: Dict[int, float] = {}
        for cid in selected:
            delay = self._draw_dropout(cid, round_start)
            if delay is not None:
                cohort.append(cid)
                delays[cid] = delay

        # pass 2: per-loader batch draws, grouped by (steps, batch)
        groups: Dict[tuple, dict] = {}
        train_times: Dict[int, float] = {}
        for cid in cohort:
            batches, steps, n_samples = self._client_batches(cid)
            train_times[cid] = self._train_time(steps, n_samples,
                                                self.profiles[cid])
            g = groups.setdefault((steps, self.loaders[cid].batch_size),
                                  {"cids": [], "batches": []})
            g["cids"].append(cid)
            g["batches"].append(batches)

        # pass 3: one cohort step per shape group. The cohort width is
        # padded UP to a power of two (the last client's batch replicated,
        # its results discarded, its aggregation weight 0), as in the JAX
        # package, so the same arena shapes reach the kernels; with
        # compression the pad rows read and write the error arena's extra
        # row N.
        has_ref = self._ref_mat is not None and st.theta is not None
        per_client: Dict[int, tuple] = {}     # cid -> (loss, ratio, norm)
        group_results = []                    # (cids, padded_C, deltas)
        for (steps, bs), g in groups.items():
            cids = g["cids"]
            C = len(cids)
            padded = 1 << (C - 1).bit_length()
            blist = g["batches"] + [g["batches"][-1]] * (padded - C)
            batch = self._drift(_to_device({k: np.stack([b[k] for b in blist])
                                            for k in blist[0]}, self.device))
            lr_scale = np.ones(padded, np.float32)
            lr_scale[:C] = self.client_lr_scale[cids]
            byz = None
            wv = self._world_view
            if wv is not None and (wv["byz_factor"] != 1.0).any():
                byz = np.ones(padded, np.float32)
                byz[:C] = wv["byz_factor"][cids]
                byz = torch.from_numpy(byz).to(self.device)
            idx = None
            if st.quantize_updates:
                idx = torch.tensor(cids + [self.num_clients] * (padded - C),
                                   dtype=torch.int64, device=self.device)
            deltas, losses, ratios, norms, self._ef_arena = self._cohort_step(
                self._params_mat, batch,
                torch.from_numpy(lr_scale).to(self.device), byz,
                self._ref_mat if has_ref else None, self._ef_arena, idx,
                has_ref=has_ref)
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
            loss, ratio, gn = per_client[cid]
            losses_all.append(loss)
            sent = st.theta is None or not has_ref or ratio >= st.theta
            arrive = self._deliver(cid, round_start, delays[cid],
                                   train_times[cid], sent, gn)
            arrivals.append((arrive, cid, sent))
            round_times[cid] = arrive - round_start
            n_sent += sent

        applied = self._schedule(arrivals)
        updates_applied = len(applied)

        # server aggregation: one weighted arena sum per shape group
        weights: Dict[int, float] = {}
        if applied:
            inv = 1.0 / len(applied)
            weights = {cid: alpha * inv for cid, alpha in applied}
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
            if st.theta is not None:
                self._ref_mat = ref_mat
        self._topology_host_round(group_results, None, weights)

        return self._finish_round(rnd, evaluate, len(selected), losses_all,
                                  n_sent, updates_applied, round_times)

    def _run_round_loop(self, rnd: int, evaluate: bool = True) -> RoundMetrics:
        """The per-client reference loop: each surviving client trains
        alone, is θ-tested against the sign dict, and the server averages
        the sent parameter dicts (sync) or buffers their discounted deltas
        (async)."""
        st = self.strategy
        selected = self._select_clients()
        round_start = self.sim_time
        prev_params = self.params
        arrivals = []                     # (arrive, cid, sent, new_params)
        round_times: Dict[int, float] = {}
        losses: List[float] = []
        n_sent = 0
        topo_deltas, topo_cids = [], []   # arena rows (topology only)
        for cid in selected:
            delay = self._draw_dropout(cid, round_start)
            if delay is None:
                continue
            new_params, delta, loss, train_time = self._train_client(cid)
            if self._topo is not None:
                topo_deltas.append(self._arena.pack(delta))
                topo_cids.append(cid)
            losses.append(loss)
            sent = self._filter_update(rnd, cid, delta)
            gn = math.sqrt(sum(float(torch.dot(g.reshape(-1), g.reshape(-1)))
                               for _k, g in sorted(delta.items())))
            arrive = self._deliver(cid, round_start, delay, train_time, sent,
                                   gn)
            arrivals.append((arrive, cid, sent, new_params))
            round_times[cid] = arrive - round_start
            n_sent += sent

        applied = self._schedule(arrivals)
        updates_applied = len(applied)
        inv = 1.0 / max(len(applied), 1)
        self._topology_host_round(topo_deltas, topo_cids,
                                  {c: alpha * inv for c, alpha in applied})
        if applied:
            sent_params = {a[1]: a[3] for a in arrivals if a[2]}
            if self.schedule.is_sync:
                self._params_tree = aggregation.fedavg({
                    k: torch.stack([sent_params[c][k] for c, _a in applied])
                    for k in prev_params})
            else:
                self._params_tree = aggregation.buffered_async_update(
                    prev_params, [(alpha, sent_params[c])
                                  for c, alpha in applied])
            # reference direction = sign of the global movement this round
            if st.theta is not None:
                self.ref_sign = alignment.tree_sign(
                    {k: self._params_tree[k].to(torch.float32)
                     - prev_params[k].to(torch.float32)
                     for k in prev_params})

        return self._finish_round(rnd, evaluate, len(selected), losses,
                                  n_sent, updates_applied, round_times)

    # ------------------------------------------------------------------
    # scanned path: the device-resident control plane, R rounds of
    # {select -> train -> θ-filter -> aggregate -> control update} per
    # dispatch (core/megastep.build_scanned_rounds)
    # ------------------------------------------------------------------
    def _scan_setup(self):
        """Build the device world and the scanned carry once (lazy)."""
        if self._scan_world is not None:
            return self._scan_world
        if self._lazy_world:
            raise RuntimeError(
                "the scanned control plane stacks the full population "
                "device-side; non-resident worlds run the loop/megastep "
                "paths")
        cap = max(l.n for l in self.loaders)
        stacked = {}
        for k in self.loaders[0].arrays:
            parts = []
            for l in self.loaders:
                a = np.asarray(l.arrays[k])
                pad = np.zeros((cap - len(a),) + a.shape[1:], a.dtype)
                parts.append(np.concatenate([a, pad]) if len(pad) else a)
            stacked[k] = np.stack(parts)
        data = _to_device(stacked, self.device)

        def vec(values, dtype):
            return torch.tensor(values, dtype=dtype, device=self.device)

        sizes = vec([l.n for l in self.loaders], torch.int32)
        speed = vec([p.speed for p in self.profiles], torch.float32)
        latency = vec([p.net_latency for p in self.profiles], torch.float32)
        dropout_p = vec([p.dropout_p for p in self.profiles], torch.float32)
        self._scan_world = (data, sizes, speed, latency, dropout_p)
        self._scan_ctl = control_mod.init_control(
            self.num_clients,
            batch_sizes=[l.batch_size for l in self.loaders],
            arena=self._arena, quantize=self.strategy.quantize_updates,
            device=self.device)
        k, steps_phys, batch_phys = self._scan_shapes()
        # α(τ) for τ < K: the quorum arrival is τ = 0, the last τ = K - 1
        self._scan_alpha = torch.from_numpy(self._alpha_table[:k]).to(
            self.device)
        if self._draws is None:
            self._draws = HostDraws(self.seed, k, steps_phys, batch_phys,
                                    self.device)
        self._scan_ref = (self._ref_mat if self._ref_mat is not None else
                          torch.from_numpy(np.where(
                              self._arena.valid_mask(), 0, -2).astype(
                                  np.int8)).to(self.device))
        self._scan_ref_valid = torch.tensor(self._ref_mat is not None,
                                            device=self.device)
        self._scan_acc = vec([self.sim_time, self.comm_time, self.idle_time,
                              self.bytes_sent], torch.float32)
        self._scan_prev_acc = vec(self.history[-1].accuracy if self.history
                                  else math.nan, torch.float32)
        return self._scan_world

    def _scan_shapes(self):
        """Static (select_k, steps_phys, batch_phys) of the scanned rounds."""
        st = self.strategy
        k = self._cohort_size()
        batch_phys = min(l.batch_size for l in self.loaders)
        steps_phys = min(local_step_count(l.n, batch_phys, st)
                         for l in self.loaders)
        return k, steps_phys, batch_phys

    def _scan_fn(self, R: int):
        """The dispatch callable of R rounds (built once per R)."""
        if R not in self._scan_fns:
            self._scan_setup()
            k, steps_phys, batch_phys = self._scan_shapes()
            self._scan_fns[R] = megastep_mod.build_scanned_rounds(
                self.cfg, self.opt, self._arena, self.strategy, self.comm,
                num_clients=self.num_clients, select_k=k,
                steps_phys=steps_phys, batch_phys=batch_phys,
                rounds_per_dispatch=R, param_bytes=self.param_bytes,
                schedule=self.schedule, alpha_table=self._scan_alpha,
                wire_bytes=self._wire_bytes,
                recovery_time=self.recovery_time,
                restart_time=self.restart_time,
                eval_fn=(self._eval if self.fused_eval else None),
                eval_every=self.eval_every, scenario=self.scenario,
                drift_dirs=self._drift_dirs, topology=self._topo,
                candidate_frac=self.candidate_frac,
                candidate_shards=self.candidate_shards)
        return self._scan_fns[R]

    def _scan_args(self, eval_mark: int = -1) -> list:
        """The arguments of the next dispatch: the carry and the world, all
        already on the device, and host ints; nothing is copied here."""
        data, sizes, speed, latency, dropout_p = self._scan_setup()
        args = [self._params_mat, self._scan_ref, self._scan_ref_valid,
                self._scan_ctl, data, sizes, speed, latency, dropout_p,
                self._draws, self._worlds, self._topo_state,
                self._scan_round0, self._scan_acc]
        if self.fused_eval:
            args += [self._scan_prev_acc, eval_mark, self._eval_dev]
        return args

    def scan_carry(self) -> tuple:
        """A copy of the scanned path's carry before its next round:
        (parameters, reference sign, its flag, ControlState with the error
        feedback, topology state, accumulators, carried accuracy, the next
        round's index), for ``load_scan_carry`` of a simulation of the
        same spec on any device."""
        self._scan_setup()
        return _moved((self._params_mat, self._scan_ref,
                       self._scan_ref_valid, self._scan_ctl,
                       self._topo_state, self._scan_acc,
                       self._scan_prev_acc), self.device) + (
                           self._scan_round0,)

    def load_scan_carry(self, carry: tuple) -> None:
        """Continue the scanned path from ``carry`` (``scan_carry`` of a
        simulation of the same spec): the next dispatch runs round
        ``carry[-1]`` from that state, with that round's draws."""
        self._scan_setup()
        (self._params_mat, self._scan_ref, self._scan_ref_valid,
         self._scan_ctl, self._topo_state, self._scan_acc,
         self._scan_prev_acc) = _moved(carry[:-1], self.device)
        self._scan_round0 = int(carry[-1])

    def _scan_dispatch(self, R: int, eval_mark: int = -1) -> dict:
        """Run the next R rounds as one dispatch and keep its carry; returns
        the per-round metrics, still on the device."""
        carry, ms = self._scan_fn(R)(*self._scan_args(eval_mark))
        (self._params_mat, self._scan_ref, self._scan_ref_valid,
         self._scan_ctl, self._topo_state, self._scan_acc, prev_acc) = carry
        if self.fused_eval:
            self._scan_prev_acc = prev_acc
        self._scan_round0 += R
        self.dispatches += 1
        return ms

    @staticmethod
    def scan_readback(ms: dict) -> Dict[str, np.ndarray]:
        """Every metric of one or more dispatches in ONE device-to-host
        copy. Integer metrics and client ids are exact in f32 (below
        2^24)."""
        names = sorted(ms)
        cols = [ms[k].to(torch.float32).reshape(ms[k].shape[0], -1)
                for k in names]
        host = torch.cat(cols, dim=1).cpu().numpy()
        out, off = {}, 0
        for k, c in zip(names, cols):
            width = c.shape[1]
            v = host[:, off:off + width]
            out[k] = v[:, 0] if ms[k].dim() == 1 else v
            off += width
        return out

    def _record_scanned(self, ms: Dict[str, np.ndarray], eval_acc=None):
        """Append one dispatch's host metrics to the history and the
        accounting (``eval_acc``: the host eval of its last round), and
        expose the reference sign once one exists."""
        Rg = len(ms["loss"])
        start = self.round_idx
        prev_acc = (self.history[-1].accuracy if self.history
                    else float("nan"))
        for j in range(Rg):
            if "accuracy" in ms:
                acc = float(ms["accuracy"][j])
            elif j == Rg - 1 and eval_acc is not None:
                acc = eval_acc
            else:
                acc = prev_acc
            self.history.append(RoundMetrics(
                round=start + j,
                sim_time=float(ms["sim_time"][j]),
                comm_time=float(ms["comm_time"][j]),
                idle_time=float(ms["idle_time"][j]),
                bytes_sent=float(ms["bytes_sent"][j]),
                updates_applied=int(ms["updates_applied"][j]),
                accept_rate=float(ms["accept_rate"][j]), accuracy=acc,
                loss=float(ms["loss"][j])))
            self.cohorts.append([int(c) for c in ms["cohort"][j]])
            self.theta_ratios.extend(
                (start + j, int(c), float(x))
                for c, x in zip(ms["cohort"][j], ms["ratios"][j])
                if not math.isnan(x))
        self.server_step += int(ms["updates_applied"].sum())
        # failure times are known to round granularity only on the scanned
        # path; each is logged at its round's start clock
        starts = [self.sim_time] + [float(t) for t in ms["sim_time"][:-1]]
        for j in range(Rg):
            self.failure_log.extend([starts[j]] * int(ms["n_failures"][j]))
        self.sim_time = float(ms["sim_time"][-1])
        self.comm_time = float(ms["comm_time"][-1])
        self.idle_time = float(ms["idle_time"][-1])
        self.bytes_sent = float(ms["bytes_sent"][-1])
        self.round_idx += Rg
        self._ref_mat = (self._scan_ref if bool(self._scan_ref_valid)
                         else None)

    def _run_scanned(self, num_rounds: int,
                     eval_final: bool = True) -> List[RoundMetrics]:
        R = self.rounds_per_dispatch
        start = self.round_idx   # absolute round labels across run() calls
        done = 0
        while done < num_rounds:
            Rg = min(R, num_rounds - done)
            last = start + done + Rg - 1
            is_final = eval_final and last == start + num_rounds - 1
            # fused: only the final round of the run() is forced; the rest
            # follow the absolute eval_every cadence inside the dispatch
            ms = self.scan_readback(self._scan_dispatch(
                Rg, last if (self.fused_eval and is_final) else -1))
            eval_acc = None
            if not self.fused_eval and (
                    is_final or any(r % self.eval_every == 0
                                    for r in range(start + done, last + 1))):
                # evaluated once per dispatch, at its last round
                eval_acc = float(self._eval(self.params, self._eval_dev))
                self.dispatches += 1
            self._record_scanned(ms, eval_acc)
            done += Rg
        return self.history

    # ------------------------------------------------------------------
    # full-state serialization (api/session.py's checkpoint and restore)
    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        """Everything a resume equal by bits needs, as picklable host
        values: the round index; the engine's, the loaders' (a lazy
        world's ``LoaderPool`` keeps only the streams that advanced) and
        the selector's Generator positions; the selector records, batch
        assignment, LR scales and update norms; the failure log and the
        simulated checkpoints; the loop's error-feedback buffers and the
        cohort paths' error-feedback arena; the wire bytes; the parameters
        (arena matrix or dict) and the θ reference (arena signs or sign
        dict); the world of the last round run and the topology state; the
        scanned path's carry (reference sign and its flag, ControlState,
        accumulators, carried accuracy, absolute round); the accounting,
        server step, dispatch count and history.

        Every tensor is a CPU copy, so a checkpoint written on the card
        unpickles and restores where there is no CUDA. The training data
        is not stored: the world rebuilds from the spec's seed. Nor is a
        PRNG key: the draw sources (``HostDraws``, ``SpmdDraws``,
        ``LinkNormals``, ``PopulationDraws``, core/draws.py) are seeded by
        (seed, absolute round) and hold no state."""
        host = functools.partial(_moved, device="cpu")
        scan = None
        if self._scan_world is not None:
            scan = {"carry": host((self._scan_ref, self._scan_ref_valid,
                                   self._scan_ctl, self._scan_acc,
                                   self._scan_prev_acc)),
                    "round0": int(self._scan_round0)}
        world = None
        if self._worlds is not None and self.round_idx > 0:
            view = self._worlds.view(self.round_idx - 1)
            world = {k: (v.copy() if isinstance(v, np.ndarray) else v)
                     for k, v in view.items()}
        return {
            "round_idx": self.round_idx,
            "rng": self.rng.bit_generator.state,
            "loaders": (self.loaders.state_dict() if self._lazy_world
                        else [{"batch_size": l.batch_size,
                               "rng": l.rng.bit_generator.state}
                              for l in self.loaders]),
            "selector": {
                "rng": self.selector.rng.bit_generator.state,
                "records": {cid: dataclasses.asdict(r)
                            for cid, r in self.selector.records.items()}},
            "batch_assignment": dict(self.batch_ctrl.assignment),
            "client_lr_scale": np.array(self.client_lr_scale),
            "grad_norms": np.array(self.grad_norms),
            "failure_log": list(self.failure_log),
            "checkpoints": dict(self.checkpoints),
            "ckpt_interval": float(self.ckpt_interval),
            "ef_state": host(self._ef_state),
            "ef_arena": host(self._ef_arena),
            "wire_bytes": self._wire_bytes,
            "params_mat": host(self._params_mat),
            "params_tree": host(self._params_tree),
            "ref_mat": host(self._ref_mat),
            "ref_sign": host(self.ref_sign),
            "world_state": world,
            "topology": host(self._topo_state),
            "scan": scan,
            "sim_time": self.sim_time, "comm_time": self.comm_time,
            "idle_time": self.idle_time, "bytes_sent": self.bytes_sent,
            "server_step": self.server_step,
            "dispatches": self.dispatches,
            "history": [dataclasses.asdict(m) for m in self.history],
            "theta_ratios": list(self.theta_ratios),
            "cohorts": [list(c) for c in self.cohorts],
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict` output into a freshly built
        simulation of the same spec, on this simulation's device.

        The world is not taken from the checkpoint: the ``WorldSource``
        recomputes its trajectory from round 0, and the world of the last
        round run must equal the saved one by bits, or this raises."""
        from repro_torch.core.selection import ClientRecord

        def gen(saved):
            g = np.random.default_rng(0)
            g.bit_generator.state = saved
            return g

        on = functools.partial(_moved, device=self.device)
        saved_loaders = state["loaders"]
        saved_lazy = (isinstance(saved_loaders, dict)
                      and saved_loaders.get("lazy"))
        if self._lazy_world != bool(saved_lazy):
            raise ValueError(
                "checkpoint world residency mismatch: saved "
                f"{'lazy' if saved_lazy else 'eager'} loaders, this "
                f"world is {'lazy' if self._lazy_world else 'eager'}")
        if self._lazy_world:
            self.loaders.load_state_dict(saved_loaders)
        else:
            if len(saved_loaders) != len(self.loaders):
                raise ValueError(
                    f"checkpoint has {len(saved_loaders)} client loaders, "
                    f"this world has {len(self.loaders)}")
            for l, s in zip(self.loaders, saved_loaders):
                l.batch_size = s["batch_size"]
                l.rng = gen(s["rng"])
        if (state["topology"] is None) != (self._topo is None):
            raise ValueError("checkpoint and simulation disagree on "
                             "whether a topology runs")
        self.round_idx = state["round_idx"]
        self.rng = gen(state["rng"])
        self.selector.rng = gen(state["selector"]["rng"])
        self.selector.records = {
            cid: ClientRecord(**r)
            for cid, r in state["selector"]["records"].items()}
        self.batch_ctrl.assignment = dict(state["batch_assignment"])
        self.client_lr_scale = np.array(state["client_lr_scale"])
        self.grad_norms = np.array(state["grad_norms"])
        self.failure_log = list(state["failure_log"])
        self.checkpoints = dict(state["checkpoints"])
        self.ckpt_interval = state["ckpt_interval"]
        self._ef_state = on(state["ef_state"])
        self._ef_arena = on(state["ef_arena"])
        self._wire_bytes = state["wire_bytes"]
        self._params_mat = on(state["params_mat"])
        self._params_tree = on(state["params_tree"])
        self._ref_mat = on(state["ref_mat"])
        self.ref_sign = on(state["ref_sign"])
        self._topo_state = on(state["topology"])
        self._load_world(state["world_state"])
        # a prepared dispatch's device buffers belong to the run that
        # prepared them; the next dispatch prepares its own
        for src in (self._draws, self._worlds):
            if hasattr(src, "reset"):
                src.reset()
        scan = state["scan"]
        if scan is not None:
            self._scan_setup()       # the device world and the shapes
            (self._scan_ref, self._scan_ref_valid, self._scan_ctl,
             self._scan_acc, self._scan_prev_acc) = on(scan["carry"])
            self._scan_round0 = scan["round0"]
        self.sim_time = state["sim_time"]
        self.comm_time = state["comm_time"]
        self.idle_time = state["idle_time"]
        self.bytes_sent = state["bytes_sent"]
        self.server_step = state["server_step"]
        self.dispatches = state["dispatches"]
        self.history = [RoundMetrics(**m) for m in state["history"]]
        self.theta_ratios = list(state["theta_ratios"])
        self.cohorts = [list(c) for c in state["cohorts"]]

    def _load_world(self, saved: Optional[dict]) -> None:
        """Hold this simulation's world of the last round run to the saved
        one, by bits."""
        if saved is None:
            if self._worlds is not None and self.round_idx > 0:
                raise ValueError("checkpoint has no world, but this "
                                 "simulation runs a scenario")
            return
        if self._worlds is None:
            raise ValueError("checkpoint carries a world, but this "
                             "simulation runs no scenario")
        got = self._worlds.view(self.round_idx - 1)
        differ = scenario_mod.view_differences(got, saved)
        if differ:
            raise ValueError(
                f"the world of round {self.round_idx - 1} recomputed from "
                f"the scenario differs from the checkpoint's in {differ}")
        self._world_view = got

    def client_pass_rates(self) -> np.ndarray:
        """(num_clients,) θ pass-rate EMAs the server has learned: the
        device ControlState on the scanned path, the host selector records
        otherwise."""
        if self._scan_ctl is not None:
            return self._scan_ctl.pass_rate.cpu().numpy()
        return np.array([self.selector.records[c].pass_rate
                         for c in range(self.num_clients)])

    def run(self, num_rounds: int,
            eval_final: bool = True) -> List[RoundMetrics]:
        if self.rounds_per_dispatch:
            return self._run_scanned(num_rounds, eval_final=eval_final)
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


class ProfileView:
    """Sequence[ClientProfile] over per-field arrays: ``view[cid]`` builds
    one dataclass per access instead of holding one per client (at 1M
    clients a list is hundreds of MB of Python objects, the four float
    arrays 32 MB), as the JAX package's."""

    def __init__(self, arrays: dict):
        self._a = arrays

    def __len__(self) -> int:
        return len(self._a["speed"])

    def field(self, name: str) -> np.ndarray:
        return self._a[name]

    def __getitem__(self, cid):
        if isinstance(cid, slice):
            return [self[i] for i in range(*cid.indices(len(self)))]
        a = self._a
        return ClientProfile(speed=float(a["speed"][cid]),
                             net_latency=float(a["net_latency"][cid]),
                             dropout_p=float(a["dropout_p"][cid]),
                             memory=float(a["memory"][cid]))


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
