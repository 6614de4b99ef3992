"""The dry run on the production meshes (``repro_torch.launch.dryrun
--mesh single|multi|both``) on the CPU: its plan against the JAX
package's ``--list`` for each mesh (a subprocess: the JAX module sets
``XLA_FLAGS`` at import), and qwen2-1.5b's training step (full size, on
meta) traced on 16 × 16 and 2 × 16 × 16 in a subprocess (a fake world of
512 ranks): rows with the mesh's name and chips, per-device FLOPs,
collective bytes by kind and by mesh dims, and the collective term split
by link."""
import json
import os
import subprocess
import sys

import pytest
torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(module, *args, timeout=600):
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH="src"))


@pytest.mark.parametrize("mesh", ["single", "multi", "both"])
def test_list_equals_the_jax_plan(mesh):
    ours = _run("repro_torch.launch.dryrun", "--list", "--mesh", mesh)
    theirs = _run("repro.launch.dryrun", "--list", "--mesh", mesh)
    assert ours.returncode == theirs.returncode == 0, ours.stderr
    assert ours.stdout.splitlines() == theirs.stdout.splitlines()
    assert len(ours.stdout.splitlines()) == 39 * (2 if mesh == "both" else 1)


@pytest.fixture(scope="module")
def train_rows(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dry") / "rows.jsonl")
    out = _run("repro_torch.launch.dryrun", "--arch", "qwen2-1.5b",
               "--shape", "train_4k", "--mesh", "both", "--results", path)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    rows = [json.loads(ln) for ln in open(path)]
    return {(r["shape"], r["mesh"]): r for r in rows}, out.stdout


@pytest.mark.parametrize("mesh,chips", [("16x16", 256), ("2x16x16", 512)])
def test_training_step_traces_with_collectives(train_rows, mesh,
                                                     chips):
    rows, _ = train_rows
    r = rows[("train_4k", mesh)]
    assert r["chips"] == chips
    assert r["hlo_flops"] > 0 and r["collective_bytes"] > 0
    # the arena's all-reduce over the client axes, the tensor-parallel
    # products' reductions and the gradients' gathers over "model"
    assert r["per_op_bytes"]["all-reduce"] > 0
    assert r["per_op_bytes"]["all-gather"] > 0
    # every mesh dim of 16 ranks crosses nodes of 8
    assert r["t_collective_ib"] > 0
    assert r["t_collective"] == pytest.approx(
        r["t_collective_nvlink"] + r["t_collective_ib"])


def test_train_rows_cover_both_meshes(train_rows):
    rows, stdout = train_rows
    assert set(rows) == {("train_4k", m) for m in ("16x16", "2x16x16")}
    for r in rows.values():
        assert r["bytes_per_device"]["peak_bytes"] > 0
    assert "all-reduce over data" in stdout
    assert "all combos traced" in stdout


def test_multi_pod_reduces_over_the_pod_axis(train_rows):
    """On 2 × 16 × 16 the clients span "pod" and "data": the arena's
    all-reduce runs over both, and C doubles to 32."""
    _, stdout = train_rows
    block = stdout.split("train_4k × 2x16x16")[1].split("[dryrun]")[0]
    assert "all-reduce over pod (2 ranks)" in block
    assert "all-reduce over data (16 ranks)" in block
