"""The spmd engine's federated train step: one synchronous round as one
call (the JAX package's ``core/fl_step.py``).

One FL round = one step over a client-batched global batch (leading dim C):
  1. per-client gradients at the shared weights (the JAX package's
     ``vmap(value_and_grad)``): for the mlp, the weights are expanded with
     a leading client axis and one autograd backward of the SUM of the C
     clients' mean losses gives each copy exactly its client's gradient;
     for a language model (a token batch: ``tokens``, ``labels``, for vlm
     ``patch_embeds``), one backward per client, each client's gradient
     packed straight into its slab of the arena, so no (C, ...) gradient
     nest is held beside it;
  2. the gradients are packed ONCE into the (C, rows, LANE) arena, and the
     per-client sign-alignment ratios against the sign of the previous
     global update (Algorithm 1) run as one kernel sweep over it;
  3. the mask ``ratio ≥ θ`` gates a weighted arena sum over C;
  4. optimizer update and the new reference sign.

``theta=None`` is the synchronous FedAvg baseline. If no client passes,
parameters, optimizer state and reference sign are kept. Without an
optimizer the step takes the config's (``optim.for_config``: adamw, or
adafactor for the large archs). The new parameters and optimizer state
are the optimizer's own tensors, held back in place (``torch.where`` into
them) where nothing was accepted; the cohort arena is released before
the optimizer runs, so a step at qwen2-1.5b's width holds one copy of
the arena and two of the optimizer state at its peak.

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

With ``ControlPlane.candidate_frac`` selection is two-stage
(``control.two_stage_select``) on the same draws. The prefill and serve steps at the end serve the dense language
models.

On a mesh (the JAX package's ``jax.jit(step, in_shardings=...)``): the
same ``make_raw_step``, ``build_prefill_step`` and ``build_serve_step``
take a state, weights, batches and caches distributed as DTensors by
``launch/sharding.py``'s specs. The prefill and decode steps run the
model on the DTensors as they come, DTensor choosing each operator's
collectives (and a DTensor cache written by a masked select, not a slot
copy). The training step of a language model lays out its arena so:

  * the arena's CLIENT dim is sharded over the config's client axes in
    the mesh (``client_axes_in_mesh``: "data", and "pod" on 2×16×16;
    arctic's "pod" only), its rows whole: each rank packs its own
    clients. Each client's loss and gradient run on the mesh's other
    axes (the weights tensor-parallel over "model", arctic's expert banks
    and per-client batch over "data" too), and each gradient leaf is
    gathered whole (``full_tensor``: an all-gather over "model" of every
    tensor-parallel leaf, an all-reduce of a partial one) before it is
    packed into the client's slab;
  * the count is then per client, on local slabs (``per_client_sign_align``
    ``Shard(0)``), its (C,) ratios all-gathered so that the θ mask, the
    fallback and the weights are computed on every rank alike; the
    aggregation is a local weighted sum and one all-reduce over the client
    axes (``kernels/sharded.py``);
  * the aggregate is split back to each weight's placement without a
    collective, and the optimizer runs on the DTensor weights and state.

At qwen2-1.5b × train_4k on 16×16 (C 16, one client a "data" rank, 16 ×
4,096 tokens a client) this costs, a rank and a step, the gradient's
gather over "model" (each tensor-parallel leaf's 15/16 that the rank does
not hold, in bf16), the f32 arena's all-reduce over "data" (1,735,822 ×
1,024 × 4 bytes = 7.11 GB of result) and the reference signs' gather;
``launch/dryrun.py --mesh single`` prints them by kind and mesh dims
(torch 2.13: 3.72·10^10 bytes of all-gather over "model" a rank, the
model's own activations' gathers among them, and 7.11·10^9 of all-reduce
over "data").
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import dist
from repro_torch import tree as tree_mod
from repro_torch.convert import lm_params_from_jax, params_from_jax
from repro_torch.core import alignment, compression
from repro_torch.core import control as control_mod
from repro_torch.core import scenario as scenario_mod
from repro_torch.device import resolve_device
from repro_torch.kernels import arena as arena_mod
from repro_torch.kernels import ref as _ref
from repro_torch.models import api
from repro_torch.optim import adamw as optim_mod
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
    rates) that the reliability EMAs observe. ``candidate_frac`` adds the
    per-shard candidate pre-filter before the exact masked top-k (None:
    single-stage; 1.0 equals it by bits).
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


def _params_on(params, cfg, dev):
    """The weights on ``dev``: the mlp's as a flat dict of f32 tensors, a
    language model's as its nest in its own dtypes (numpy, e.g. the JAX
    package's, or tensors)."""
    if cfg.family == "mlp":
        return params_from_jax({k: (v.detach().cpu() if torch.is_tensor(v)
                                    else v) for k, v in params.items()}, dev)
    return tree_mod.tree_map(
        lambda v: (v.detach().to(dev) if torch.is_tensor(v)
                   else lm_params_from_jax(v, dev)), params)


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
    the control plane's). Without an ``optimizer``, the config's
    (``optim.for_config``). A language model's weights are drawn on the
    generator's device (a CUDA generator draws on the card)."""
    optimizer = optimizer or optim_mod.for_config(cfg)
    dev = resolve_device(device)
    if params is None:
        params = api.init_params(generator, cfg, "cpu" if (
            cfg.family == "mlp" and dev.type != "meta") else dev)
    if dev.type != "meta":          # the dry run's weights: shapes only
        params = _params_on(params, cfg, dev)
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
                   tree_mod.tree_map(
                       lambda p: torch.zeros_like(p, dtype=torch.int8),
                       params),
                   torch.zeros((), dtype=torch.int32, device=dev),
                   {"accepted": zero, "rounds": zero.clone()}, ctl, world,
                   topo)


def _per_client_grads(params: Dict[str, torch.Tensor], batch, cfg):
    """(C,) losses and the per-client gradient dict (leading axis C) at
    the shared ``params`` (the mlp)."""
    C = batch["x"].shape[0]
    names = tuple(sorted(params))
    p = {k: params[k].expand((C,) + params[k].shape).clone()
         .requires_grad_(True) for k in names}
    with torch.enable_grad():
        loss = api.loss_fn(p, batch, cfg)                      # (C,)
        grads = torch.autograd.grad(loss.sum(), [p[k] for k in names])
    return loss.detach(), dict(zip(names, grads))


def _lm_client_grads(params, batch, cfg, arena) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
    """(C,) losses and the (C, rows, LANE) f32 arena of the per-client
    gradients at the shared ``params`` of a language model: one backward
    per client, each gradient (in its weight's dtype, as JAX's) packed
    into the client's slab as it comes, then dropped."""
    C = batch["tokens"].shape[0]
    dev = batch["tokens"].device
    u = torch.empty((C, arena.rows, arena.lane), dtype=torch.float32,
                    device=dev)
    losses = []
    for c in range(C):
        p = tree_mod.tree_map(lambda t: t.detach().requires_grad_(True),
                              params)
        leaves = arena.leaves(p)
        with torch.enable_grad():
            loss = api.loss_fn(p, {k: v[c] for k, v in batch.items()}, cfg)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        arena.pack_into(u[c], tree_mod.from_paths(arena.paths, [
            torch.zeros_like(t) if g is None else g
            for g, t in zip(grads, leaves)]))
        losses.append(loss.detach().to(torch.float32))
        del p, leaves, grads, loss
    return torch.stack(losses), u


def _keep(keep: torch.Tensor, new, old):
    """``new`` as where(keep, new, old), leaf by leaf, written into
    ``new``'s own tensors (one leaf's temporary at a time); a tensor that
    appears twice in ``new`` (adamw's f32 weights are its master copy) is
    written once and stays one tensor. A DTensor leaf is written shard by
    shard in the old leaf's layout, redistributed to it first where it
    holds a partial sum or another sharding (as ``out_shardings`` lays out
    the JAX step's state)."""
    done = {}

    def one(n, o):
        key = id(n)
        if key not in done:
            if dist.is_dtensor(n):
                if tuple(n.placements) != tuple(o.placements):
                    n = n.redistribute(o.device_mesh, o.placements)
                torch.where(keep, n.to_local(), o.to_local(),
                            out=n.to_local())
            else:
                torch.where(keep, n, o, out=n)
            done[key] = n
        return done[key]

    return tree_mod.tree_map(one, new, old)


def _whole(t):
    """A DTensor gathered whole (what every rank reads alike: the θ test's
    reference signs and ratios, the step counter, the loss); a plain
    tensor as it is."""
    return t.full_tensor() if dist.is_dtensor(t) else t


def _aggregate_as_grads(agg, arena, params):
    """The aggregated arena as a gradient nest of f32 leaves. On a mesh
    each leaf is a DTensor laid out as its weight: the aggregate is whole
    on every rank, so each keeps its own piece, no collective."""
    if not dist.is_dtensor(agg):
        return arena.unpack(agg, dtype=torch.float32)
    from torch.distributed.tensor import DTensor

    def like(g, p):
        rep = DTensor.from_local(g, p.device_mesh,
                                 dist.placements(p.device_mesh, {}),
                                 run_check=False)
        return rep.redistribute(p.device_mesh, p.placements)

    return tree_mod.tree_map(like, arena.unpack(_whole(agg),
                                                dtype=torch.float32), params)


def _lm_client_grads_on_mesh(params, batch, cfg, arena, mesh):
    """The sharded ``_lm_client_grads``: (the (C,) losses, the (C, rows,
    LANE) f32 arena), both DTensors ``Shard(0)`` over the client axes.
    This rank's clients (its slice of the batch's client dim) run one
    after another on the mesh's other axes, the weights as they are
    distributed there; each gradient is gathered whole and packed into
    the client's slab (the module's docstring)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import mesh as mesh_mod
    names = mesh_mod.axis_names(mesh)
    client = mesh_mod.client_axes_in_mesh(cfg, mesh)
    cdims = [names.index(a) for a in client]
    sdims = [i for i in range(len(names)) if i not in cdims]
    sub = mesh[tuple(names[i] for i in sdims)]

    def on_sub(t, lead: int):
        """A DTensor on ``mesh`` (its first ``lead`` dims this rank's own
        and dropped) as a DTensor on ``sub``; client axes must not shard
        what is kept."""
        pl = t.placements
        for d in cdims:
            if pl[d].is_shard() and pl[d].dim >= lead:
                raise ValueError(f"a leaf sharded over client axis "
                                 f"{names[d]!r}: {pl}")
        keep = [Shard(pl[d].dim - lead) if pl[d].is_shard() else Replicate()
                for d in sdims]
        return keep

    C = batch["tokens"].shape[0]
    local = {k: v.to_local() for k, v in batch.items()}
    C_l = local["tokens"].shape[0]
    dev = local["tokens"].device
    u = torch.empty((C_l, arena.rows, arena.lane), dtype=torch.float32,
                    device=dev)
    bpl = {k: on_sub(v, 1) for k, v in batch.items()}
    losses = []
    for c in range(C_l):
        p = tree_mod.tree_map(
            lambda t: dist.wrap(t.to_local(), sub, on_sub(t, 0),
                                t.shape).requires_grad_(True), params)
        leaves = arena.leaves(p)
        b = {k: dist.wrap(v[c], sub, bpl[k], batch[k].shape[1:])
             for k, v in local.items()}
        with torch.enable_grad(), implicit_replication():
            loss = api.loss_fn(p, b, cfg)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        arena.pack_into(u[c], tree_mod.from_paths(arena.paths, [
            torch.zeros(t.shape, dtype=t.dtype, device=dev) if g is None
            else g.full_tensor() for g, t in zip(grads, leaves)]))
        losses.append(loss.full_tensor().to(torch.float32))
        del p, leaves, grads, loss, b
    shards = {d: 0 for d in cdims}
    return (dist.from_local(torch.stack(losses), mesh, shards, (C,)),
            dist.from_local(u, mesh, shards, (C, arena.rows, arena.lane)))


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
    priced off ``comm``, advanced in ``FLState.topology``. Without an
    ``optimizer``, the config's (``optim.for_config``). A state of
    DTensors runs the same step on their mesh (the module's docstring): a
    language model without a control plane, scenario or topology.
    """
    optimizer = optimizer or optim_mod.for_config(cfg)
    lm = cfg.family != "mlp"
    scn = scenario if scenario_mod.is_active(scenario) else None
    dirs = {}                        # device -> drift directions
    cp = control_plane if (control_plane is not None
                           and control_plane.active()) else None
    # the arena's layout, from the first state's weights (only names,
    # shapes and dtypes are read)
    layout: Dict[str, object] = {}
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
        mesh = (state.step.device_mesh if dist.is_dtensor(state.step)
                else None)
        if mesh is not None and (not lm or cp is not None or scn is not None
                                 or topology is not None
                                 or draws is not None):
            raise ValueError("the step on a mesh trains a language model "
                             "without a control plane, scenario or "
                             "topology")
        dev = (state.step.to_local() if mesh is not None
               else state.step).device
        if not layout:
            layout["arena"] = arena_mod.ParamArena(state.params)
            layout["wire_bytes"] = (
                float(compression.arena_wire_bytes(layout["arena"]))
                if (cp and cp.quantize) else None)
        arena, wire_bytes = layout["arena"], layout["wire_bytes"]
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
        if lm and mesh is not None:
            loss, u = _lm_client_grads_on_mesh(state.params, batch, cfg,
                                               arena, mesh)
        elif lm:
            loss, u = _lm_client_grads(state.params, batch, cfg, arena)
        else:
            loss, grads = _per_client_grads(state.params, batch, cfg)
            u = arena.pack_cohort(grads)
            del grads
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
                sel_idx = control_mod.two_stage_select(
                    scores, cp.select_k, candidate_frac=cp.candidate_frac,
                    candidate_shards=cp.candidate_shards,
                    epsilon=cp.epsilon, eps_u=eps_u, pick_u=pick_u,
                    live=live)
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
        # (read by the control plane only)
        norms = torch.sqrt((u * u).sum(dim=(1, 2))) if cp is not None \
            else None
        if theta is None:
            ratios = torch.ones((C,), dtype=torch.float32, device=dev)
            passed = mask = f_active
        else:
            ratios = _whole(alignment.cohort_alignment(
                u, arena.pack_signs(tree_mod.tree_map(_whole,
                                                      state.ref_sign)),
                arena.n))
            passed = alignment.selection_mask(ratios, theta)
            # round 0 has no reference direction yet: accept all
            passed = torch.where(_whole(state.step) == 0,
                                 torch.ones_like(passed), passed)
            passed = passed * f_active
            # if NO participating client passes θ, accept all participants
            # rather than stall (the JAX package's production fallback)
            mask = torch.where(passed.sum() > 0, passed, f_active)
        w = mask / torch.clamp_min(mask.sum(), 1e-9)
        agg = _aggregate_as_grads(
            arena_mod.weighted_sum(u, w, compute_dtype=agg_dtype), arena,
            state.params)
        any_accepted = mask.sum() > 0

        # (4) hierarchical topology: leaf-pod accumulation of the SAME
        # weighted cohort updates the aggregation consumed + due syncs
        topo = state.topology
        if topology is not None:
            if dev not in runtimes:
                runtimes[dev] = topology_engine.TopologyRuntime(
                    topology, n_top, arena, comm, dev)
            topo = runtimes[dev].step(topo, state.step, u, w)
        u = None                     # the arena is released here

        # (4b) optimizer update; hold position if nothing was accepted
        with _on_mesh(state.params):
            lr_now = lr_schedule(state.step) if lr_schedule else None
            new_params, new_opt = optimizer.update(
                agg, state.opt_state, state.params, lr_now=lr_now)
            new_ref = tree_mod.tree_map(
                lambda a, r: torch.where(any_accepted, _ref.sign(a), r),
                agg, state.ref_sign)
            new_params, new_opt = _keep(any_accepted, (new_params, new_opt),
                                        (state.params, state.opt_state))

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
            "loss": _whole(loss).mean(),
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
        with _on_mesh(state.params):
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
    return tree_mod.tree_map(lambda *xs: torch.stack(xs), *states)


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
        outs = [raw(tree_mod.tree_map(lambda x, i=i: x[i], state),
                    {k: v[i] for k, v in batch.items()})
                for i in range(state.step.shape[0])]
        return tree_mod.tree_map(lambda *xs: torch.stack(xs), *outs)

    return step


def _update_bytes(params) -> float:
    return float(sum(p.numel() * p.element_size()
                     for p in tree_mod.leaves(params)))


# ---------------------------------------------------------------------------
# serving / prefill steps (the dense language models)
# ---------------------------------------------------------------------------

def _on_mesh(*trees):
    """implicit replication (plain tensors read as replicated) when any
    leaf is a DTensor, else nothing."""
    import contextlib
    if any(dist.is_dtensor(t) for tr in trees for t in tree_mod.leaves(tr)):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        return implicit_replication()
    return contextlib.nullcontext()


def build_prefill_step(cfg):
    def step(params, batch):
        with _on_mesh(params, batch):
            return api.prefill(params, batch, cfg)
    return step


def build_serve_step(cfg):
    def step(params, cache, batch):
        with _on_mesh(params, cache, batch):
            return api.decode_step(params, cache, batch, cfg)
    return step
