"""The spmd engine's federated train step: one synchronous round as one
call (the JAX package's ``core/fl_step.py``).

One FL round = one step over a client-batched global batch (leading dim C):
  1. per-client gradients at the shared weights: the weights are expanded
     with a leading client axis and one autograd backward of the SUM of the
     C clients' mean losses gives each copy exactly its client's gradient
     (the JAX package's ``vmap(value_and_grad)``);
  2. the gradients are packed ONCE into the (C, rows, LANE) arena, and the
     per-client sign-alignment ratios against the sign of the previous
     global update (Algorithm 1) run as one kernel sweep over it;
  3. the mask ``ratio ≥ θ`` gates a weighted arena sum over C;
  4. optimizer update and the new reference sign.

``theta=None`` is the synchronous FedAvg baseline. If no client passes,
parameters, optimizer state and reference sign are kept.

A ``ControlPlane`` routes the device control plane (core/control.py)
through the same step as cohort masking: top-k + ε-greedy selection over
reliability scores (or by update norm), per-client dropout draws,
per-client LR scaling and int8 + error-feedback wire quantization.
Unselected or dropped clients carry zero weight and zero bytes, so the
cohort's width stays C. The step reads nothing back to the host: every
decision on a device value is a tensor operation.

The JAX package draws selection and dropout from
``fold_in(PRNGKey(cp.seed), step)``, which torch cannot replay, so the
draws are an input of the step: ``step(state, batch, draws)`` with
``draws = (eps_u (k,), pick_u (k,), drop_u (C,))`` f32 uniforms
(``core/draws.py``, ``SpmdDraws``); ``None`` where the control plane draws
nothing.

Aggregation precision follows the JAX package's ``agg_dtype`` (default
bf16): on the CPU the plain ``weighted_sum`` reduces in it, as the JAX
oracle does; the CUDA kernel reduces in f32 whatever it is asked, as the
Pallas kernels do (kernels/arena.py).

A dynamic-world ``scenario`` (core/scenario.py) is attached the same way:
the JAX package transitions ``FLState.world`` inside its compiled step
from a PRNG key; here the caller passes the round's ``WorldState``
(``scenario.WorldSource``, computed on the host) as the step's
``world``, and the step keeps it in ``FLState.world``. Churn gates the
cohort masks, drift shifts the batch, the regime scales the dropout
probabilities and byzantine factors scale the updates before the codec
and the θ test.

A hierarchical ``topology`` (repro_torch/topology) rides in
``FLState.topology``: step (4b) accumulates the same weighted cohort
updates the aggregation consumed into the leaf pods and runs the due
inter-tier syncs, the cadence keyed off the absolute ``step`` counter and
selected by ``torch.where`` (nothing read back). The parameters, masks
and metrics are those of the same step without it.

Not ported yet: two-stage candidate selection (ROADMAP.md queue 1 item
10). The prefill and serve steps at the end serve the dense language
models.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.convert import params_from_jax
from repro_torch.core import alignment, compression
from repro_torch.core import control as control_mod
from repro_torch.core import scenario as scenario_mod
from repro_torch.device import resolve_device
from repro_torch.kernels import arena as arena_mod
from repro_torch.kernels import ref as _ref
from repro_torch.models import api
from repro_torch.topology import engine as topology_engine
from repro_torch.topology.spec import resolve_topology


class FLState(NamedTuple):
    params: dict
    opt_state: dict
    ref_sign: dict          # int8 sign of the last accepted global update
    step: torch.Tensor      # 0-dim int32
    metrics: dict           # running counters (accepted updates, rounds)
    control: Optional[control_mod.ControlState] = None
    world: Optional[scenario_mod.WorldState] = None   # the last round's
    topology: Optional[topology_engine.TopologyState] = None
    # hierarchical topology state: per-tier pod accumulators and reference
    # signs, advanced inside the step every round


@dataclasses.dataclass(frozen=True)
class ControlPlane:
    """Static configuration of the spmd engine's device control plane.

    ``select_k == num_clients`` disables selection; an empty
    ``dropout_p`` disables dropout draws. ``round_time_hint`` is the
    analytic per-client round time (train + transfer at the CommModel's
    rates) that the reliability EMAs observe. ``candidate_frac`` must be
    None (two-stage selection is ROADMAP.md queue 1 item 10).
    """
    num_clients: int
    select_k: int
    epsilon: float = 0.1
    candidate_frac: Optional[float] = None
    candidate_shards: int = 8
    grad_norm_selection: bool = False
    dropout_p: Tuple[float, ...] = ()
    quantize: bool = False
    per_client_lr: bool = False
    round_time_hint: Tuple[float, ...] = ()
    seed: int = 0
    ema: float = 0.8

    @property
    def selecting(self) -> bool:
        return (self.grad_norm_selection
                or self.select_k < self.num_clients)

    @property
    def has_dropout(self) -> bool:
        return any(p > 0 for p in self.dropout_p)

    @property
    def draws_exploration(self) -> bool:
        """Whether selection takes ε-greedy draws (top-k by score with
        ε > 0; the update-norm ranking draws nothing)."""
        return (self.selecting and not self.grad_norm_selection
                and self.epsilon > 0.0)

    def active(self) -> bool:
        return (self.selecting or self.has_dropout or self.quantize
                or self.per_client_lr)


def _not_ported(what: str, item: int):
    return NotImplementedError(f"{what} is not ported yet; it comes with "
                               f"ROADMAP.md queue 1 item {item}")


def _check_options(optimizer, control_plane) -> None:
    if optimizer is None:
        raise _not_ported("the JAX package's default optimizer (adamw, "
                          "optim.for_config)", 14)
    if control_plane is not None and control_plane.candidate_frac is not None:
        raise _not_ported("two-stage candidate selection", 10)


def _template(cfg) -> Dict[str, torch.Tensor]:
    """The config's parameter shapes and dtypes (a small CPU init)."""
    return api.init_params(torch.Generator().manual_seed(0), cfg)


def init_state(generator: Optional[torch.Generator], cfg, optimizer=None,
               control_plane: Optional[ControlPlane] = None,
               scenario=None, topology=None, *, params=None,
               num_clients: Optional[int] = None, device=None,
               comm=None) -> FLState:
    """The step's initial state on ``device`` (the card unless named):
    weights from ``params`` (a dict of tensors or arrays, e.g. the JAX
    package's) or drawn from ``generator``; with an active ``scenario``,
    the world before round 0, and with a ``topology`` its empty tier
    state (links priced off ``comm``), of ``num_clients`` clients (or
    the control plane's)."""
    _check_options(optimizer, control_plane)
    dev = resolve_device(device)
    if params is None:
        params = api.init_params(generator, cfg)
    params = params_from_jax({k: (v.detach().cpu() if torch.is_tensor(v)
                                  else v) for k, v in params.items()}, dev)
    ctl = None
    if control_plane is not None and control_plane.active():
        ctl = control_mod.init_control(
            control_plane.num_clients, arena=arena_mod.ParamArena(params),
            quantize=control_plane.quantize, device=dev)
    n = num_clients if num_clients is not None else (
        control_plane.num_clients if control_plane is not None else None)
    world = None
    if scenario_mod.is_active(scenario):
        if n is None:
            raise ValueError("init_state(scenario=...) needs num_clients "
                             "(or a control_plane that names it)")
        world = scenario_mod.WorldState(*(
            t.to(dev) for t in scenario_mod.init_world(scenario, n)))
    topo = None
    topology = resolve_topology(topology)
    if topology is not None:
        if n is None:
            raise ValueError("init_state(topology=...) needs num_clients "
                             "(or a control_plane that names it)")
        topo = topology_engine.TopologyRuntime(
            topology, n, arena_mod.ParamArena(params), comm, dev).init()
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return FLState(params, optimizer.init(params),
                   {k: torch.zeros_like(p, dtype=torch.int8)
                    for k, p in params.items()},
                   torch.zeros((), dtype=torch.int32, device=dev),
                   {"accepted": zero, "rounds": zero.clone()}, ctl, world,
                   topo)


def _per_client_grads(params: Dict[str, torch.Tensor], batch, cfg):
    """(C,) losses and the per-client gradient dict (leading axis C) at
    the shared ``params``."""
    C = batch["x"].shape[0]
    names = tuple(sorted(params))
    p = {k: params[k].expand((C,) + params[k].shape).clone()
         .requires_grad_(True) for k in names}
    with torch.enable_grad():
        loss = api.loss_fn(p, batch, cfg)                      # (C,)
        grads = torch.autograd.grad(loss.sum(), [p[k] for k in names])
    return loss.detach(), dict(zip(names, grads))


def make_raw_step(cfg, optimizer=None, theta: Optional[float] = 0.65,
                  lr_schedule=None, agg_dtype: torch.dtype = torch.bfloat16,
                  beacon_bytes: float = 0.125,
                  control_plane: Optional[ControlPlane] = None,
                  scenario=None, drift_dirs=None, topology=None, comm=None,
                  num_clients: Optional[int] = None):
    """``step(state, batch, draws=None, world=None) -> (state, metrics)``.

    batch leaves have leading dims (C, per_client_batch, ...), on the
    state's device. theta=None -> synchronous FedAvg (mask == ones).
    agg_dtype: the plain aggregation's precision on the CPU (the CUDA
    kernel reduces in f32). beacon_bytes: wire cost of a filtered client's
    1-bit skip beacon, charged into ``bytes_sent``. control_plane: the
    device control plane as cohort masking; its draws come in ``draws``.
    scenario: the dynamic world (a ``ScenarioSpec``), whose round comes in
    ``world`` (a ``WorldState`` on the state's device); ``drift_dirs``
    ((classes, features) f32) with a drift. topology: a hierarchical
    topology of ``num_clients`` clients (or the control plane's), links
    priced off ``comm``, advanced in ``FLState.topology``.
    """
    _check_options(optimizer, control_plane)
    scn = scenario if scenario_mod.is_active(scenario) else None
    dirs = {}                        # device -> drift directions
    arena = arena_mod.ParamArena(_template(cfg))
    cp = control_plane if (control_plane is not None
                           and control_plane.active()) else None
    wire_bytes = (float(compression.arena_wire_bytes(arena))
                  if (cp and cp.quantize) else None)
    topology = resolve_topology(topology)
    n_top = num_clients if num_clients is not None else (
        cp.num_clients if cp is not None else None)
    if topology is not None and n_top is None:
        raise ValueError("make_raw_step(topology=...) needs num_clients "
                         "(or an active control_plane)")
    runtimes: Dict[torch.device, topology_engine.TopologyRuntime] = {}
    consts: Dict[torch.device, dict] = {}

    def constants(dev: torch.device, C: int) -> dict:
        """Per-device constants, copied to the device once."""
        if dev not in consts:
            consts[dev] = {
                "drop_p": (torch.tensor(cp.dropout_p, dtype=torch.float32,
                                        device=dev)
                           if cp and cp.has_dropout else None),
                "hint": (torch.tensor(cp.round_time_hint, dtype=torch.float32,
                                      device=dev)
                         if cp and cp.round_time_hint else
                         torch.ones((C,), dtype=torch.float32, device=dev)),
                "cohort": torch.arange(C, device=dev),
            }
        return consts[dev]

    @torch.no_grad()
    def step(state: FLState, batch, draws=None, world=None):
        dev = state.step.device
        # (0) dynamic world: this round's WorldState
        ws = state.world
        if scn is not None:
            if world is None:
                raise ValueError("this step runs a scenario: pass the "
                                 "round's world (scenario.WorldSource)")
            ws = world
            if scn.drift is not None:
                if dev not in dirs:
                    dirs[dev] = torch.as_tensor(drift_dirs).to(dev)
                batch = scenario_mod.apply_drift(batch, ws.drift_amp,
                                                 dirs[dev])
        # (1) per-client gradients at the shared weights
        loss, grads = _per_client_grads(state.params, batch, cfg)
        C = loss.shape[0]
        ctl = state.control
        k = constants(dev, C)
        ones = torch.ones((C,), dtype=torch.bool, device=dev)

        # (1b) control plane: selection + dropout as static-width masks
        if cp is not None:
            if draws is None and (cp.has_dropout or cp.draws_exploration):
                raise ValueError("this control plane draws selection or "
                                 "dropout uniforms: pass draws=(eps_u, "
                                 "pick_u, drop_u) (core/draws.py)")
            eps_u, pick_u, drop_u = draws if draws is not None else (None,) * 3
            if cp.has_dropout:
                drop_p = k["drop_p"]
                if scn is not None and scn.dropout is not None:
                    drop_p = drop_p * ws.dropout_scale
                delivered = drop_u >= drop_p
            else:
                delivered = ones
            live = None if scn is None else ws.live
            if cp.grad_norm_selection:
                gn = ctl.grad_norm if live is None else torch.where(
                    live, ctl.grad_norm, -torch.inf)
                sel_idx = torch.argsort(-gn, stable=True)[:cp.select_k]
            elif cp.selecting:
                scores = control_mod.score(ctl)
                if live is not None:
                    scores = torch.where(live, scores, -torch.inf)
                sel_idx = control_mod.select_topk_epsilon(
                    scores, cp.select_k, cp.epsilon, eps_u=eps_u,
                    pick_u=pick_u, live=live)
            else:
                sel_idx = None
            selected = (ones if sel_idx is None else
                        torch.zeros_like(ones).index_fill(0, sel_idx, True))
            if live is not None:
                # churned clients are absent: they deliver nothing and the
                # reliability EMAs never observe them
                delivered = delivered & live
            active = selected & delivered
        else:
            selected = delivered = active = ones
            if scn is not None:
                delivered = ws.live
                active = selected & delivered
        f_active = active.to(torch.float32)

        # (2)+(3) selective aggregation on the (C, rows, LANE) arena
        u = arena.pack_cohort(grads)
        if cp is not None and cp.per_client_lr:
            u = u * ctl.lr_scale[:, None, None]
        if scn is not None and scn.byzantine is not None:
            # corruption before the codec and the θ test: the server
            # receives (and the filter judges) the corrupted update
            u = u * ws.byz_factor[:, None, None]
        if cp is not None and cp.quantize:
            # int8 + error feedback on the wire; only participating
            # clients quantize and carry residuals
            restored, residual = compression.compress_cohort(u, ctl.ef[:C])
            a3 = active[:, None, None]
            u = torch.where(a3, restored, u)
            ctl = ctl._replace(ef=torch.cat(
                [torch.where(a3, residual, ctl.ef[:C]), ctl.ef[C:]]))
        # norms AFTER the quantize round trip: what the server receives
        norms = torch.sqrt((u * u).sum(dim=(1, 2)))
        if theta is None:
            ratios = torch.ones((C,), dtype=torch.float32, device=dev)
            passed = mask = f_active
        else:
            ratios = alignment.cohort_alignment(
                u, arena.pack_signs(state.ref_sign), arena.n)
            passed = alignment.selection_mask(ratios, theta)
            # round 0 has no reference direction yet: accept all
            passed = torch.where(state.step == 0, torch.ones_like(passed),
                                 passed)
            passed = passed * f_active
            # if NO participating client passes θ, accept all participants
            # rather than stall (the JAX package's production fallback)
            mask = torch.where(passed.sum() > 0, passed, f_active)
        w = mask / torch.clamp_min(mask.sum(), 1e-9)
        agg = arena.unpack(arena_mod.weighted_sum(u, w, compute_dtype=agg_dtype),
                           dtype=torch.float32)
        any_accepted = mask.sum() > 0

        # (4) optimizer update; hold position if nothing was accepted
        lr_now = lr_schedule(state.step) if lr_schedule else None
        new_params, new_opt = optimizer.update(agg, state.opt_state,
                                               state.params, lr_now=lr_now)
        new_params, new_opt = _tree_map(
            lambda n, o: torch.where(any_accepted, n, o),
            (new_params, new_opt), (state.params, state.opt_state))
        new_ref = {n: torch.where(any_accepted, _ref.sign(a), state.ref_sign[n])
                   for n, a in agg.items()}

        # (4b) hierarchical topology: leaf-pod accumulation of the SAME
        # weighted cohort updates the aggregation consumed + due syncs
        topo = state.topology
        if topology is not None:
            if dev not in runtimes:
                runtimes[dev] = topology_engine.TopologyRuntime(
                    topology, n_top, arena, comm, dev)
            topo = runtimes[dev].step(topo, state.step, u, w)

        # (5) control-plane statistics for the next round's selection
        if cp is not None:
            cohort = k["cohort"]
            sent = mask > 0
            ctl = control_mod.observe(ctl, cohort,
                                      mask=(selected if scn is None
                                            else selected & ws.live),
                                      delivered=delivered, passed=sent,
                                      round_time=k["hint"], ema=cp.ema)
            ctl = control_mod.grad_norm_update(ctl, cohort, norms, active)
            if cp.per_client_lr:
                ctl = control_mod.lr_scale_update(ctl, cohort, norms, active)
            ctl = control_mod.staleness_update(ctl, cohort, sent)

        update_bytes = wire_bytes if wire_bytes else _update_bytes(
            state.params)
        n_sel = (selected if scn is None
                 else selected & ws.live).sum().to(torch.float32)
        metrics = {
            "loss": loss.mean(),
            # pre-fallback pass fraction over the selected cohort
            "accept_rate": passed.sum() / torch.clamp_min(n_sel, 1.0),
            "alignment_mean": ratios.mean(),
            # per-client transmit mask (post-fallback)
            "mask": mask,
            "selected": selected.to(torch.float32),
            "delivered": delivered.to(torch.float32),
            # bytes on the wire: full updates for the mask, the 1-bit skip
            # beacon for filtered participants, nothing for the rest
            "bytes_sent": (mask.sum() * update_bytes
                           + (f_active - mask).sum() * beacon_bytes),
            "bytes_baseline": torch.full((), C * _update_bytes(state.params),
                                         dtype=torch.float32, device=dev),
            # the θ ratios (ones without θ); not in the JAX package's
            # metrics, read by the driver's θ-band bookkeeping
            "ratios": ratios,
        }
        run = {"accepted": state.metrics["accepted"] + mask.sum(),
               "rounds": state.metrics["rounds"] + 1.0}
        return FLState(new_params, new_opt, new_ref, state.step + 1, run,
                       ctl, ws, topo), metrics

    # device -> the topology's runtime there: its summary() and
    # closest_theta_tests() read a run's FLState.topology and θ tests
    step.topology_runtimes = runtimes
    return step


def build_fl_train_step(cfg, optimizer=None, theta: Optional[float] = 0.65,
                        lr_schedule=None, beacon_bytes: float = 0.125,
                        control_plane: Optional[ControlPlane] = None,
                        scenario=None, drift_dirs=None, topology=None,
                        agg_dtype: torch.dtype = torch.bfloat16, comm=None,
                        num_clients: Optional[int] = None):
    """The trainers' step: ``make_raw_step`` as it is (PyTorch runs
    eagerly; the JAX package jits it here). ``agg_dtype`` stays the JAX
    package's bf16 unless named, as its builder never overrides it."""
    return make_raw_step(cfg, optimizer, theta, lr_schedule,
                         agg_dtype=agg_dtype, beacon_bytes=beacon_bytes,
                         control_plane=control_plane, scenario=scenario,
                         drift_dirs=drift_dirs, topology=topology, comm=comm,
                         num_clients=num_clients)


# ---------------------------------------------------------------------------
# several seeds in one state
# ---------------------------------------------------------------------------

def _tree_map(fn, *trees):
    """``fn`` over the tensors of nested dicts and tuples of one shape."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, tuple):
        parts = [_tree_map(fn, *p) for p in zip(*trees)]
        return type(first)(*parts) if hasattr(first, "_fields") \
            else tuple(parts)
    return fn(*trees)


def init_seed_batched_state(seeds: Sequence[int], cfg, optimizer=None, *,
                            params: Optional[Sequence[dict]] = None,
                            device=None) -> FLState:
    """Per-seed ``init_state`` results stacked along a leading seed axis:
    weights drawn from a generator seeded with each seed, or taken from
    ``params[i]``. Control planes are not supported, as in the JAX
    package."""
    states = [init_state(torch.Generator().manual_seed(int(s)), cfg,
                         optimizer, params=None if params is None
                         else params[i], device=device)
              for i, s in enumerate(seeds)]
    return _tree_map(lambda *xs: torch.stack(xs), *states)


def build_seed_batched_step(cfg, optimizer=None,
                            theta: Optional[float] = 0.65,
                            lr_schedule=None, beacon_bytes: float = 0.125):
    """``step(batched_state, batch)`` over a leading seed axis S (batch
    leaves (S, C, B, ...)): S independent runs, metrics seed-stacked.
    The kernels are ctypes calls, which torch cannot vmap, so the seeds
    run one after another; each seed's slice goes through the raw step
    exactly as a solo run would."""
    raw = make_raw_step(cfg, optimizer, theta, lr_schedule,
                        beacon_bytes=beacon_bytes)

    def step(state: FLState, batch):
        outs = [raw(_tree_map(lambda x, i=i: x[i], state),
                    {k: v[i] for k, v in batch.items()})
                for i in range(state.step.shape[0])]
        return _tree_map(lambda *xs: torch.stack(xs), *outs)

    return step


def _update_bytes(params) -> float:
    return float(sum(p.numel() * p.element_size() for p in params.values()))


# ---------------------------------------------------------------------------
# serving / prefill steps (the dense language models)
# ---------------------------------------------------------------------------

def build_prefill_step(cfg):
    def step(params, batch):
        return api.prefill(params, batch, cfg)
    return step


def build_serve_step(cfg):
    def step(params, cache, batch):
        return api.decode_step(params, cache, batch, cfg)
    return step
