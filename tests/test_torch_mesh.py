"""``repro_torch.launch.mesh`` against the JAX package's ``launch/mesh.py``
on the CPU: ``fold_mesh_shape`` for every device count from 1 to 1,024
with and without ``multi_pod``, errors included; the client axes and
counts and ``topology_pspec`` on the production and folded meshes (JAX on
``AbstractMesh``, no devices); that importing the port's mesh modules
starts no process group; and the roofline's collective term by link
(``roofline/analysis.py``). The meshes built in a fake world are
``tests/test_torch_sharded_step.py``'s."""
import pytest
torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh as JaxMesh

from repro.configs import registry as jreg
from repro.launch import mesh as jmesh

from repro_torch.configs import registry as treg
from repro_torch.launch import mesh as tmesh
from repro_torch.roofline import analysis


def _fold(fn, n, multi_pod):
    try:
        return fn(n, multi_pod=multi_pod)
    except RuntimeError as e:
        return ("RuntimeError", "even" in str(e), ">= 2" in str(e))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_fold_mesh_shape_equals_jax(multi_pod):
    for n in list(range(-1, 1025)):
        assert _fold(tmesh.fold_mesh_shape, n, multi_pod) == \
            _fold(jmesh.fold_mesh_shape, n, multi_pod), n


MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((1, 1), ("data", "model")),
          (jmesh.fold_mesh_shape(8), ("data", "model")),
          (jmesh.fold_mesh_shape(48, multi_pod=True),
           ("pod", "data", "model")),
          ((4, 1), ("data", "model"))]


@pytest.mark.parametrize("sizes,names", MESHES,
                         ids=["x".join(map(str, m[0])) for m in MESHES])
def test_client_axes_counts_and_topology_spec_equal_jax(sizes, names):
    jm, tm = JaxMesh(tuple(sizes), names), tmesh.AbstractMesh(sizes, names)
    for arch in jreg.ASSIGNED_ARCHS:
        jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
        assert tmesh.client_axes_in_mesh(tcfg, tm) == \
            jmesh.client_axes_in_mesh(jcfg, jm)
        assert tmesh.num_clients(tcfg, tm) == jmesh.num_clients(jcfg, jm)
    for min_pods in (None, 1, 2, 16, 64):
        assert tuple(tmesh.topology_pspec(tm, min_pods)) == tuple(
            jmesh.topology_pspec(jm, min_pods))
    for name in ("pod", "data", "model", "expert"):
        want = dict(zip(names, sizes)).get(name, 1)
        assert tmesh.axis_size(tm, name) == want


def test_train_client_counts_on_the_production_meshes():
    """C = 16 on single, 32 on multi; arctic 1 and 2 (its clients live on
    "pod" only)."""
    single = tmesh.AbstractMesh(*tmesh.SINGLE_POD)
    multi = tmesh.AbstractMesh(*tmesh.MULTI_POD)
    qwen, arctic = treg.get_config("qwen2-1.5b"), \
        treg.get_config("arctic-480b")
    assert (tmesh.num_clients(qwen, single),
            tmesh.num_clients(qwen, multi)) == (16, 32)
    assert (tmesh.num_clients(arctic, single),
            tmesh.num_clients(arctic, multi)) == (1, 2)


def test_importing_the_mesh_modules_starts_no_process_group():
    import subprocess
    import sys
    code = ("import torch.distributed as d; "
            "import repro_torch.launch.mesh, repro_torch.launch.sharding, "
            "repro_torch.launch.dryrun, repro_torch.kernels.sharded, "
            "repro_torch.core.population, repro_torch.core.fl_step; "
            "print(d.is_initialized())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_a_mesh_needs_a_process_group():
    """No test worker starts a process group: the mesh tests start theirs
    in subprocesses (``tests/mesh_ranks.py``)."""
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_production_mesh()


@pytest.mark.parametrize("size,nodes,want", [
    (16, None, "infiniband"), (8, None, "nvlink"), (2, None, "nvlink"),
    (16, 2, "infiniband"), (8, 1, "nvlink"), (2, 2, "infiniband")])
def test_collective_link_by_group(size, nodes, want):
    """A group of 16 ranks crosses nodes of 8 (InfiniBand); one of 8 within
    a node rides NVLink; a census row's recorded nodes decide over its
    size (the "pod" axis's 2 ranks lie 256 ranks apart)."""
    row = {"kind": "all-reduce", "group_size": size, "bytes": 1e9}
    if nodes is not None:
        row["nodes"] = nodes
    assert analysis.link(row) == want


def test_collective_term_splits_by_link():
    census = {"collective_bytes": 3e9, "collectives": [
        {"kind": "all-reduce", "group_size": 16, "nodes": 2, "bytes": 1e9},
        {"kind": "all-gather", "group_size": 8, "nodes": 1, "bytes": 2e9}]}
    t_nv, t_ib = analysis.collective_times(census)
    assert t_nv == pytest.approx(2e9 / analysis.NVLINK_BW)
    assert t_ib == pytest.approx(1e9 / analysis.IB_BW)
    assert (analysis.NVLINK_BW, analysis.IB_BW, analysis.NODE_CARDS) == (
        450e9, 50e9, 8)
