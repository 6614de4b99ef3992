"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's, on the CPU: the registry's names, every (architecture × shape)
input spec, the prefill and decode steps of every full-size combo traced
on meta against ``jax.eval_shape`` (the counterpart of
``tests/test_abstract_lowering.py``; the training combos are
``tests/test_torch_dryrun_train.py``), the plan and ``--list``, the
results file's round trip and the refused production meshes.

The JAX package's ``launch/dryrun.py`` sets ``XLA_FLAGS`` at import (512
host devices), which would reach every later test of the same worker, so
it runs here only in a subprocess.

Shapes and dtypes must be equal. The one leaf of another kind is a decode
cache's ``step``: a () int32 array in JAX, a Python int in the port (its
decode reads the position on the host).
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import registry as jreg
from repro.configs.shapes import SHAPES as JSHAPES
from repro.models import api as japi

from repro_torch import tree as ttree
from repro_torch.configs import registry as treg
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun
from repro_torch.models import api as tapi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMBOS = [(a, s) for a in jreg.ASSIGNED_ARCHS for s in JSHAPES
          if not (s == "long_500k" and a in jreg.LONG_CTX_SKIP)]
SERVE_COMBOS = [(a, s) for a, s in COMBOS if JSHAPES[s].kind != "train"]


def jax_leaves(tree) -> dict:
    """path (dict keys) -> (shape, dtype name) of a JAX nest."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        out[key] = (tuple(leaf.shape), np.dtype(leaf.dtype).name)
    return out


def torch_leaves(tree) -> dict:
    """path -> (shape, dtype name) of a port nest; a Python int (a decode
    cache's step) as a () int32 leaf."""
    out = {}
    for path, leaf in ttree.named_leaves(tree):
        if isinstance(leaf, int):
            out[path] = ((), "int32")
        else:
            assert leaf.device.type == "meta", path
            out[path] = (tuple(leaf.shape),
                         str(leaf.dtype).replace("torch.", ""))
    return out


def test_assigned_archs_and_all_configs_equal_jax():
    assert treg.ASSIGNED_ARCHS == jreg.ASSIGNED_ARCHS
    for smoke in (False, True):
        t, j = treg.all_configs(smoke), jreg.all_configs(smoke)
        assert list(t) == list(j)
        for name in t:
            assert t[name].name == j[name].name
            assert t[name].param_count() == j[name].param_count()


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_input_specs_match_jax(arch, shape):
    """Keys, shapes and dtypes of every input of the step, full size, as
    meta tensors (train: the 1 × 1 mesh's one client)."""
    jc = jreg.config_for_shape(arch, shape)
    tc = treg.config_for_shape(arch, shape)
    want = japi.input_specs(jc, JSHAPES[shape], num_clients=1)
    got = tapi.input_specs(tc, SHAPES[shape], num_clients=1)
    assert sorted(got) == sorted(want)
    assert torch_leaves(got) == jax_leaves(want)
    if "cache" in got:
        assert isinstance(got["cache"]["step"], int)


@pytest.mark.parametrize("arch,shape", SERVE_COMBOS)
def test_full_size_serve_steps_match_eval_shape(arch, shape):
    """Every full-size prefill and decode combo traced on meta by the
    port's steps (``build_prefill_step``, ``build_serve_step``): logits and
    cache of ``jax.eval_shape``'s shapes and dtypes."""
    jc = jreg.config_for_shape(arch, shape)
    jspecs = japi.input_specs(jc, JSHAPES[shape])
    params = jax.eval_shape(lambda: japi.init_params(jax.random.PRNGKey(0),
                                                     jc))
    out, _census, _bytes = dryrun.trace_step(arch, shape)
    if JSHAPES[shape].kind == "prefill":
        want = jax.eval_shape(lambda p, b: japi.prefill(p, b, jc), params,
                              jspecs["batch"])
    else:
        want = jax.eval_shape(lambda p, c, b: japi.decode_step(p, c, b, jc),
                              params, jspecs["cache"], jspecs["batch"])
    assert torch_leaves({"logits": out[0]}) == jax_leaves(
        {"logits": want[0]})
    assert torch_leaves(out[1]) == jax_leaves(want[1])


def test_long_recurrence_dry_runs_in_seconds():
    """rwkv6-7b's prefill at 32,768 tokens: its WKV loop traced as one
    step counted T times (while_trips), in seconds."""
    import time
    t0 = time.perf_counter()
    _out, census, _ = dryrun.trace_step("rwkv6-7b", "prefill_32k")
    assert time.perf_counter() - t0 < 30.0
    stats = census.analyze()
    assert stats["while_trips"] == {"wkv_scan": 32768}
    assert stats["flops"] > 0 and stats["peak_bytes"] > 0


def _run(module, *args):
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH="src"))


def test_plan_and_list_equal_the_jax_plan():
    """39 (arch, shape) combos in the JAX plan's order, on the port's one
    mesh ``1x1``; the JAX package's ``--list --mesh single`` runs in a
    subprocess."""
    ns = type("Args", (), {"arch": None, "shape": None})()
    combos = dryrun.plan(ns)
    assert [c[:2] for c in combos] == COMBOS and len(combos) == 39
    assert {c[2:] for c in combos} == {("1x1", False)}
    ours = _run("repro_torch.launch.dryrun", "--list")
    theirs = _run("repro.launch.dryrun", "--list", "--mesh", "single")
    assert ours.returncode == theirs.returncode == 0, ours.stderr
    assert [ln.split()[:2] for ln in ours.stdout.splitlines()] == \
        [ln.split()[:2] for ln in theirs.stdout.splitlines()]
    assert {ln.split()[2] for ln in ours.stdout.splitlines()} == {"1x1"}


def test_results_round_trip_and_refused_meshes(tmp_path, capsys):
    """A combo's row is appended once; a second run skips what the file
    holds unless ``--force``; the production meshes are planned, as the
    JAX package names them (``tests/test_torch_dryrun_mesh.py`` traces
    them)."""
    path = str(tmp_path / "dry.jsonl")
    assert dryrun.main(["--arch", "whisper-tiny", "--results", path]) == 0
    rows = [json.loads(ln) for ln in open(path)]
    assert [(r["arch"], r["shape"], r["mesh"], r["chips"]) for r in rows] == [
        ("whisper-tiny", s, "1x1", 1)
        for s in ("train_4k", "prefill_32k", "decode_32k")]
    assert all(r["bytes_per_device"]["peak_bytes"] > 0 for r in rows)
    capsys.readouterr()
    assert dryrun.main(["--arch", "whisper-tiny", "--results", path]) == 0
    assert capsys.readouterr().out.count("skip (cached)") == 3
    assert dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                        "--results", path, "--force"]) == 0
    assert len(open(path).read().splitlines()) == 4
    capsys.readouterr()
    for mesh, names in (("single", {"single"}), ("multi", {"multi"}),
                        ("both", {"single", "multi"})):
        assert dryrun.main(["--mesh", mesh, "--list"]) == 0
        lines = capsys.readouterr().out.splitlines()
        assert len(lines) == 39 * len(names)
        assert {ln.split()[2] for ln in lines} == names
