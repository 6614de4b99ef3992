"""The port's sharding rules (``repro_torch.launch.sharding``) against the
JAX package's (``repro.launch.sharding``), leaf by leaf by path, with no
devices and no process group: the JAX side on ``jax.sharding.AbstractMesh``
(jax 0.9's ``(sizes, names)`` signature), the port's on
``launch.mesh.AbstractMesh``, both at every assigned architecture's full
size on the 16 × 16, 2 × 16 × 16 and 1 × 1 meshes and a folded 8.
``tests/test_sharding.py`` does not collect on this stack (jax 0.4.37's
``AbstractMesh`` signature), so its checks are ported here on the port's
rules: every spec divides its dim, expert parallelism only for arctic,
arctic's expert sharding."""
import functools

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh as JaxMesh
from jax.sharding import PartitionSpec as JaxP

from repro.configs import registry as jreg
from repro.configs.shapes import SHAPES as JSHAPES
from repro.core import control as jctl
from repro.launch import mesh as jmesh
from repro.launch import sharding as js
from repro.models import api as japi
from repro.optim import adamw as joptim

from repro_torch.configs import registry as treg
from repro_torch.configs.shapes import SHAPES
from repro_torch.core import control as tctl
from repro_torch.core import fl_step as tfl
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as ts
from repro_torch.models import api as tapi
from repro_torch.optim import adamw as toptim

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "1x1": ((1, 1), ("data", "model")),
    "fold8": (jmesh.fold_mesh_shape(8), ("data", "model")),
}
ARCHS = jreg.ASSIGNED_ARCHS


def _meshes(name):
    sizes, names = MESHES[name]
    return JaxMesh(tuple(sizes), names), tmesh.AbstractMesh(sizes, names)


def _entry(e):
    """A spec entry, a one-name tuple read as the name."""
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def jax_specs(tree) -> dict:
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JaxP))[0]
    for path, spec in flat:
        out["/".join(js._path_names(path))] = tuple(
            _entry(e) for e in spec)
    return out


def torch_specs(tree) -> dict:
    out = {}

    def go(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k, v in node.items():
                go(v, path + (k,))
        elif isinstance(node, (tuple, list)):
            for k, v in zip(getattr(node, "_fields", range(len(node))),
                            node):
                go(v, path + (k,))
        else:
            assert isinstance(node, ts.P), (path, node)
            out["/".join(p for p in path if isinstance(p, str))] = tuple(
                _entry(e) for e in node)
    go(tree, ())
    return out


def _same(theirs, ours):
    assert set(theirs) == set(ours), set(theirs) ^ set(ours)
    wrong = {k: (theirs[k], ours[k]) for k in theirs if theirs[k] != ours[k]}
    assert not wrong, wrong


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch, shape_name, C):
    cfg = jreg.config_for_shape(arch, shape_name)
    shape = JSHAPES[shape_name]
    return (japi.input_specs(cfg, shape, num_clients=C)
            if shape.kind == "train" else japi.input_specs(cfg, shape))


def _torch_shapes(arch, shape_name, C):
    cfg = treg.config_for_shape(arch, shape_name)
    shape = SHAPES[shape_name]
    return (tapi.input_specs(cfg, shape, num_clients=C)
            if shape.kind == "train" else tapi.input_specs(cfg, shape))


# --------------------------------------------------------------------------
# parity with the JAX rules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch, mesh):
    jm, tm = _meshes(mesh)
    for mode in ("train", "serve"):
        _same(jax_specs(js.param_pspecs(jreg.get_config(arch), jm, mode)),
              torch_specs(ts.param_pspecs(treg.get_config(arch), tm, mode)))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs_equal_jax(arch, mesh):
    """adamw (with masters) and adafactor (factored stats drop an
    entry), whatever the config's own optimizer."""
    jm, tm = _meshes(mesh)
    for name in ("adamw", "adafactor"):
        theirs = js.state_pspecs(jreg.get_config(arch), jm,
                                 getattr(joptim, name)())
        ours = ts.state_pspecs(treg.get_config(arch), tm,
                               getattr(toptim, name)())
        _same(jax_specs(theirs), torch_specs(ours))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_jax(arch, mesh):
    """train_batch_pspecs at C = num_clients(cfg, mesh), infer_batch_pspecs
    and cache_pspecs over every shape of the arch."""
    jm, tm = _meshes(mesh)
    for shape_name, shape in JSHAPES.items():
        if shape_name == "long_500k" and arch in jreg.LONG_CTX_SKIP:
            continue
        jcfg = jreg.config_for_shape(arch, shape_name)
        tcfg = treg.config_for_shape(arch, shape_name)
        C = tmesh.num_clients(tcfg, tm)
        assert C == jmesh.num_clients(jcfg, jm)
        theirs, ours = _jax_shapes(arch, shape_name, C), \
            _torch_shapes(arch, shape_name, C)
        if shape.kind == "train":
            _same(jax_specs(js.train_batch_pspecs(jcfg, jm, theirs["batch"])),
                  torch_specs(ts.train_batch_pspecs(tcfg, tm,
                                                    ours["batch"])))
            continue
        _same(jax_specs(js.infer_batch_pspecs(jm, theirs["batch"])),
              torch_specs(ts.infer_batch_pspecs(tm, ours["batch"])))
        if shape.kind == "decode":
            _same(jax_specs(js.cache_pspecs(jcfg, jm, theirs["cache"])),
                  torch_specs(ts.cache_pspecs(tcfg, tm, ours["cache"])))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("n", [256, 1000, 1001])
def test_population_specs_equal_jax(n, mesh):
    """A control state with the error-feedback arena (N+1 rows), a bare
    per-client vector and a scalar: the population's leaves over "data"
    when n divides it, the rest replicated."""
    jm, tm = _meshes(mesh)
    arena = type("Arena", (), {"rows": 3, "lane": 1024})()
    jtree = (jctl.init_control(n, arena=arena, quantize=True),
             np.zeros((n, 4), np.float32), np.float32(0))
    ttree = (tctl.init_control(n, arena=arena, quantize=True),
             torch.zeros((n, 4)), torch.zeros(()))
    _same(jax_specs(js.population_pspecs(jtree, jm, n)),
          torch_specs(ts.population_pspecs(ttree, tm, n)))


# --------------------------------------------------------------------------
# tests/test_sharding.py's checks, on the port's rules
# --------------------------------------------------------------------------

def _check_divisible(tree, specs, mesh, where):
    shapes = {"/".join(p for p in path if isinstance(p, str)):
              tuple(getattr(leaf, "shape", ()))
              for path, leaf in _named(tree)}
    specs = torch_specs(specs)
    assert set(shapes) == set(specs), where
    for key, spec in specs.items():
        shape = shapes[key]
        assert len(spec) <= len(shape), (where, key, shape, spec)
        for dim, entry in zip(shape, spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            n = int(np.prod([tmesh.axis_size(mesh, a) for a in axes]))
            assert dim % n == 0, (where, key, shape, spec)


def _named(tree, path=()):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _named(v, path + (k,))]
    if isinstance(tree, (tuple, list)):
        keys = getattr(tree, "_fields", range(len(tree)))
        return [x for k, v in zip(keys, tree) for x in _named(v, path + (k,))]
    return [(path, tree)]


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_divide_their_dims(arch, mesh):
    """Params, the config's training state and every shape's batch (at
    the mesh's client count) or cache divide evenly, as
    tests/test_sharding.py holds the JAX rules."""
    tm = _meshes(mesh)[1]
    cfg = treg.get_config(arch)
    _check_divisible(tapi.init_params(None, cfg, "meta"),
                     ts.param_pspecs(cfg, tm), tm, arch)
    opt = toptim.for_config(cfg)
    state = tfl.init_state(None, cfg, opt, device="meta")
    _check_divisible(state, ts.state_pspecs(cfg, tm, opt), tm, arch)
    for shape_name, shape in SHAPES.items():
        if shape_name == "long_500k" and arch in treg.LONG_CTX_SKIP:
            continue
        scfg = treg.config_for_shape(arch, shape_name)
        specs = _torch_shapes(arch, shape_name,
                              tmesh.num_clients(scfg, tm))
        if shape.kind == "train":
            _check_divisible(specs["batch"], ts.train_batch_pspecs(
                scfg, tm, specs["batch"]), tm, (arch, shape_name))
        elif shape.kind == "prefill":
            _check_divisible(specs["batch"], ts.infer_batch_pspecs(
                tm, specs["batch"]), tm, (arch, shape_name))
        else:
            _check_divisible(specs["cache"], ts.cache_pspecs(
                scfg, tm, specs["cache"]), tm, (arch, shape_name))


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_configs_distribution_fields_equal_jax(smoke):
    """expert_parallel and client_axes of every config equal the JAX
    package's; expert parallelism only for arctic (on the "pod" axis)."""
    theirs, ours = jreg.all_configs(smoke), treg.all_configs(smoke)
    assert set(theirs) == set(ours)
    for arch in ours:
        assert ours[arch].expert_parallel == theirs[arch].expert_parallel
        assert ours[arch].client_axes == theirs[arch].client_axes
        if not smoke:
            assert ours[arch].expert_parallel == (arch == "arctic-480b")
    if not smoke:
        assert ours["arctic-480b"].client_axes == ("pod",)


def test_arctic_expert_sharding():
    tm = _meshes("16x16")[1]
    specs = ts.param_pspecs(treg.get_config("arctic-480b"), tm)
    assert tuple(specs["layers"]["moe"]["wg"]) == (None, "data", None,
                                                   "model")
    assert tuple(specs["layers"]["moe"]["wd"]) == (None, "data", "model",
                                                   None)


# --------------------------------------------------------------------------
# specs -> placements
# --------------------------------------------------------------------------

def test_to_placements_follows_mesh_order_and_refuses_other_orders():
    from torch.distributed.tensor import Replicate, Shard
    tm = tmesh.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert ts.to_placements(tm, ts.P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert ts.to_placements(tm, ts.P()) == (Replicate(),) * 3
    assert ts.to_placements(tm, ts.P(None, "data")) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="mesh order"):
        ts.to_placements(tm, ts.P(("data", "pod")))
    with pytest.raises(ValueError, match="two dims"):
        ts.to_placements(tm, ts.P("data", "data"))
    with pytest.raises(ValueError, match="not in"):
        ts.to_placements(tm, ts.P("expert"))
