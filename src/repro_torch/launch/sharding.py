"""Sharding rules for every parameter, state, batch and cache nest: the
JAX package's ``launch/sharding.py`` under the same names, with a spec
type of the port's own and DTensor placements in place of
``NamedSharding``.

Strategy (the JAX module's):
  * weights: tensor-parallel over "model" on their widest eligible dim,
    replicated over the client axes ("pod", "data") — every FL client
    needs full weights;
  * MoE expert tensors with cfg.expert_parallel: expert dim over "data"
    (expert parallelism) + ff dim over "model";
  * optimizer state mirrors its parameter's spec (adafactor's factored
    row / col vectors drop the corresponding spec entry);
  * training batch: leading client dim over cfg.client_axes; per-client
    batch dim over "data" when "data" is not a client axis (arctic);
  * decode caches: batch over "data" (when divisible), sequence / window
    over "model"; SSM states shard heads / channels over "model".

Dims are only sharded when evenly divisible by the mesh axis size —
``_maybe`` falls back to replication otherwise (e.g. vocab 32001).

A spec is a ``P``: one entry a tensor dim, each None (replicated), an
axis name, or a tuple of axis names. ``to_placements(mesh, spec)`` turns it
into one DTensor placement a mesh dim: ``Shard(d)`` where an entry d names
that mesh axis, ``Replicate()`` otherwise. DTensor shards one tensor dim
over several mesh dims left to right, so a tuple entry must list its axes
in mesh order; any other order is refused (the JAX rules only ever make
mesh order, ``("pod", "data")``). The shapes the rules read come from the
port's own meta init (``api.init_params(None, cfg, "meta")``), which
stands in for ``jax.eval_shape``; a mesh is anything with
``mesh_dim_names`` and ``shape`` (a ``DeviceMesh`` or
``launch.mesh.AbstractMesh``).
"""
from __future__ import annotations

import torch

from repro_torch import tree as tree_mod
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import api

_STACK_KEYS = {"layers", "enc_layers", "dec_layers"}


class P:
    """A partition spec: one entry per tensor dim (None, an axis name, or
    a tuple of axis names). A leaf of a nest, unlike a tuple."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


def _axis_size(mesh, name):
    return mesh_mod.axis_size(mesh, name)


def _maybe(mesh, axis, dim):
    """axis name if dim divides evenly, else None (replicated)."""
    n = _axis_size(mesh, axis)
    return axis if (n > 1 and dim % n == 0) else None


def _names(path) -> list:
    return [str(p) for p in path if isinstance(p, str)]


def _map_with_path(fn, tree):
    """``fn(names, leaf)`` over a nest's leaves, the nest kept (dicts,
    NamedTuples, tuples and lists; ``None`` stays)."""
    def go(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: go(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            keys = getattr(node, "_fields", range(len(node)))
            parts = [go(v, path + (k,)) for k, v in zip(keys, node)]
            if hasattr(node, "_fields"):
                return type(node)(*parts)
            return type(node)(parts)
        return fn(_names(path), node)
    return go(tree, ())


# --------------------------------------------------------------------------
# parameter rules
# --------------------------------------------------------------------------

# column-parallel (shard LAST dim over model): input projections
_COL = {"wq", "wk", "wv", "wg", "wu", "w1", "Wr", "Wk", "Wv", "Wg", "Win",
        "Wdt2", "conv_w", "lm_head", "patch_proj"}
# row-parallel (shard SECOND-TO-LAST dim over model): output projections
_ROW = {"wo", "wd", "w2", "Wo", "Wout", "Wdt1", "WB", "WC", "A_log"}
# last-dim sharded vectors
_VEC = {"bq", "bk", "bv", "b1", "dt_bias", "D", "conv_b"}
# always replicated (norms, scalar-ish, small loras, router)
_REP = {"w", "b", "mus", "mu_base", "mu_k", "mu_r", "w0", "u", "gn_w",
        "gn_b", "W1", "W2", "dw1", "dw2", "router", "b2", "count", "scale",
        "good_steps", "step"}


def _param_rule(cfg, names, shape, mesh, mode="train"):
    name = names[-1] if names else ""
    stacked = any(n in _STACK_KEYS for n in names)
    lead = (None,) if stacked else ()
    body = tuple(shape[1:]) if stacked else tuple(shape)
    nd = len(body)

    def spec(*entries):
        return P(*(lead + tuple(entries)))

    # --- MoE expert tensors: (E, d, ff) / (E, ff, d) -----------------------
    if "moe" in names and name in {"wg", "wu", "wd"} and nd == 3:
        if not cfg.expert_parallel and mode == "train":
            # small expert banks are replicated for training: TP-sharding
            # the ff dim replicates the client dim around the backward's
            # contraction (the JAX package measured the train-step
            # all-reduce 32x larger); serving keeps the ff-sharded banks
            return spec(None, None, None)
        e_axis = (_maybe(mesh, "data", body[0])
                  if cfg.expert_parallel else None)
        if name in {"wg", "wu"}:
            return spec(e_axis, None, _maybe(mesh, "model", body[2]))
        return spec(e_axis, _maybe(mesh, "model", body[1]), None)

    if name == "embed":
        # never vocab-shard the embedding table: the token lookup is a
        # gather, which a sharded vocab turns into one-hot products;
        # d-sharding keeps the lookup local
        v, d = body
        return spec(None, _maybe(mesh, "model", d))
    if name == "lm_head":
        # vocab-shard the head: a plain product, no gather, and no
        # (B, S, V) f32 logits all-reduce
        d, v = body
        if _maybe(mesh, "model", v):
            return spec(None, "model")
        return spec(_maybe(mesh, "model", d), None)
    if name in _REP:
        return spec(*([None] * nd))
    if name in _COL and nd >= 2:
        return spec(*([None] * (nd - 1) + [_maybe(mesh, "model", body[-1])]))
    if name in _ROW and nd >= 2:
        return spec(*([None] * (nd - 2)
                      + [_maybe(mesh, "model", body[-2]), None]))
    if name in _VEC and nd == 1:
        return spec(_maybe(mesh, "model", body[-1]))
    # mlp detector leaves (w0, b0, ...) and anything unknown: replicate
    return spec(*([None] * nd))


def _param_shapes(cfg):
    return api.init_params(None, cfg, "meta")


def param_pspecs(cfg, mesh, mode: str = "train"):
    """Nest of ``P`` matching ``api.init_params(cfg)``. mode: "train" |
    "serve" — non-EP MoE expert banks are replicated for training but
    TP-sharded for serving (see ``_param_rule``)."""
    return _map_with_path(
        lambda names, leaf: _param_rule(cfg, names, leaf.shape, mesh, mode),
        _param_shapes(cfg))


def state_pspecs(cfg, mesh, optimizer):
    """``FLState`` spec: params / opt / ref_sign sharded, counters
    replicated.

    The optimizer state is mapped by its structure: adamw's m / v /
    master and sgd's mom mirror the param nest; adafactor's factored
    stats drop the corresponding spec entry (row stat: last dim; col
    stat: second-to-last dim)."""
    from repro_torch.core import fl_step
    pspecs = param_pspecs(cfg, mesh)
    pshapes = _param_shapes(cfg)
    oshapes = optimizer.init(pshapes)

    def factored_stat_spec(spec, stat):
        entries = tuple(spec)
        if "r" in stat:   # factored: r drops last dim, c drops dim -2
            return {"r": P(*entries[:-1]),
                    "c": P(*(entries[:-2] + entries[-1:]))}
        return {"v": spec}

    ospecs = {}
    for key, sub in oshapes.items():
        if key == "count":
            ospecs[key] = P()
        elif key == "stats":   # adafactor
            ospecs[key] = _zip_specs(factored_stat_spec, pspecs, sub)
        else:                  # m / v / master / mom mirror params
            ospecs[key] = pspecs
    metrics_spec = {"accepted": P(), "rounds": P()}
    return fl_step.FLState(pspecs, ospecs, pspecs, P(), metrics_spec)


def _zip_specs(fn, specs, other):
    """``fn(spec, other_subtree)`` at every spec leaf of ``specs``, where
    ``other`` has the same dict nest above those leaves."""
    if isinstance(specs, dict):
        return {k: _zip_specs(fn, specs[k], other[k]) for k in specs}
    return fn(specs, other)


# --------------------------------------------------------------------------
# batch / cache rules
# --------------------------------------------------------------------------

def train_batch_pspecs(cfg, mesh, batch_shapes):
    """Leading dim = clients over cfg.client_axes; dim1 over spare axis."""
    names = mesh_mod.axis_names(mesh)
    client_axes = tuple(a for a in cfg.client_axes if a in names)
    lead = client_axes if client_axes else None
    spare = "data" if "data" not in (client_axes or ()) else None

    def rule(path, leaf):
        nd = leaf.dim()
        entries = [lead] + [None] * (nd - 1)
        if spare and nd >= 2 and leaf.shape[1] % _axis_size(mesh, spare) == 0:
            entries[1] = spare
        return P(*entries)

    return _map_with_path(rule, batch_shapes)


def _batch_axes(mesh, dim):
    """Largest prefix of ('pod', 'data') that divides ``dim`` (leaving the
    pod axis idle on decode shapes replicates and reduces the whole cache
    across pods)."""
    axes = [a for a in ("pod", "data") if a in mesh_mod.axis_names(mesh)]
    n = 1
    for a in axes:
        n *= _axis_size(mesh, a)
    if n > 1 and dim % n == 0:
        return tuple(axes) if len(axes) > 1 else axes[0]
    return _maybe(mesh, "data", dim)


def infer_batch_pspecs(mesh, batch_shapes):
    """Prefill / decode token batches: batch dim over ('pod', 'data')."""
    def rule(path, leaf):
        if leaf.dim() == 0:
            return P()
        b = _batch_axes(mesh, leaf.shape[0])
        return P(*([b] + [None] * (leaf.dim() - 1)))
    return _map_with_path(rule, batch_shapes)


def cache_pspecs(cfg, mesh, cache_shapes):
    """Decode caches: (L, B, S, ...) KV -> batch over data, seq over model;
    SSM states -> heads / channels over model."""
    def rule(names, leaf):
        name = names[-1] if names else ""
        nd = leaf.dim() if isinstance(leaf, torch.Tensor) else 0
        if name == "step" or nd <= 1:
            return P()
        shape = leaf.shape
        if name in {"k", "v", "xk", "xv"}:      # (L, B, S, K, hd)
            _, b, s = shape[:3]
            return P(None, _batch_axes(mesh, b),
                     _maybe(mesh, "model", s), None, None)
        if name == "S":                          # rwkv (L, B, H, hd, hd)
            _, b, h = shape[:3]
            return P(None, _batch_axes(mesh, b),
                     _maybe(mesh, "model", h), None, None)
        if name in {"tshift", "cshift"}:         # (L, B, d)
            _, b, d = shape
            return P(None, _batch_axes(mesh, b), _maybe(mesh, "model", d))
        if name == "h":                          # hybrid (L, B, di, n)
            _, b, di, _n = shape
            return P(None, _batch_axes(mesh, b),
                     _maybe(mesh, "model", di), None)
        if name == "conv":                       # (L, B, taps, di)
            _, b, _t, di = shape
            return P(None, _batch_axes(mesh, b), None,
                     _maybe(mesh, "model", di))
        return P(*([None] * nd))
    return _map_with_path(rule, cache_shapes)


# --------------------------------------------------------------------------
# population-plane rules (ControlState / WorldState / per-client scalars)
# --------------------------------------------------------------------------

def population_pspecs(tree, mesh, num_clients: int):
    """Shard every ``(num_clients, ...)``-leading leaf over "data".

    Covers ``core.control.ControlState``, ``core.scenario.WorldState`` and
    any bare per-client array. Leaves whose leading dim is not the
    population — scalars, (K,)-cohort slots, the ``(N+1, rows, lane)``
    error-feedback arena with its dummy-row layout, 0-width placeholders
    — replicate, as does a population that does not divide the "data"
    axis (``_maybe``)."""
    n = int(num_clients)

    def rule(names, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) >= 1 and shape[0] == n and _maybe(mesh, "data", n):
            return P(*(("data",) + (None,) * (len(shape) - 1)))
        return P(*((None,) * len(shape)))

    return _map_with_path(rule, tree)


def shard_population(tree, mesh, num_clients: int):
    """The population nest distributed under ``population_pspecs``."""
    return distribute(tree, mesh, population_pspecs(tree, mesh, num_clients))


# --------------------------------------------------------------------------
# specs -> DTensor placements
# --------------------------------------------------------------------------

def to_placements(mesh, spec: P) -> tuple:
    """One DTensor placement a mesh dim: ``Shard(d)`` where entry d of
    ``spec`` names that mesh axis, ``Replicate()`` otherwise. A tuple entry
    must name its axes in mesh order (DTensor's order over mesh dims)."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_mod.axis_names(mesh)
    placements = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, not in "
                                 f"the mesh's {names}")
            if not isinstance(placements[names.index(a)], Replicate):
                raise ValueError(f"spec {spec} shards two dims over {a!r}")
            placements[names.index(a)] = Shard(d)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(
                f"spec {spec}: entry {entry} lists its axes out of mesh "
                f"order {names}; DTensor would shard dim {d} in another "
                f"order than the spec says")
    return tuple(placements)


def distribute(tree, mesh, specs):
    """Each tensor of ``tree`` distributed over ``mesh`` by its spec in
    ``specs`` (a nest of the same structure); other leaves kept. A tensor
    that appears twice (adamw's f32 weights are its master copy) is
    distributed once, so it stays one tensor."""
    from torch.distributed.tensor import distribute_tensor
    done = {}

    def one(leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        if id(leaf) not in done:
            done[id(leaf)] = distribute_tensor(
                leaf, mesh, to_placements(mesh, spec))
        return done[id(leaf)]

    return tree_mod.tree_map(one, tree, specs)
