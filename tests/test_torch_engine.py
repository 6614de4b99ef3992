"""The port's whole slice against the JAX package: ``repro_torch``'s
simulation on the CPU against the one ``repro.api.run_experiment`` builds
and runs (``build_simulation`` + ``run``, final round evaluated), record
for record, from the JAX simulation's own initial parameters; plus the
port's boundaries (no JAX import, the default device, what the spec
refuses, and ``chip_smoke.py`` failing where there is no card).

Tolerances: ``repro_torch.api.parity`` states them, with their reasons,
and ``chip_smoke.py`` holds the card to the same ones. Times, bytes,
update counts and accept rates are equal, as is every client's selector
record; accuracy and loss agree within ACC_TOL and LOSS_RTOL; and the
test asserts that no θ ratio of the seeds used lies within THETA_BAND of
θ, where a decision could flip on float noise.
"""
import ast
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import repro.api as J
from repro.api import runner as jrunner
from repro.models import api as japi

import repro_torch as T
from repro_torch import device as tdevice
from repro_torch.configs import registry as tregistry
from repro_torch.launch import serve as tserve
from repro_torch.api import parity
from repro_torch.models import api as tapi

ROOT = pathlib.Path(__file__).resolve().parents[1]

CASES = {
    "smoke": dict(model="anomaly-mlp-smoke", n=1500, ev=300, clients=4,
                  rounds=3),
    "anomaly-mlp": dict(model="anomaly-mlp", n=1600, ev=400, clients=4,
                        rounds=2),
}


def _spec(mod, case, strategy):
    c = CASES[case]
    return mod.ExperimentSpec(
        model=c["model"],
        data=mod.DataSpec(n_samples=c["n"], eval_samples=c["ev"], alpha=0.5),
        world=mod.WorldSpec(num_clients=c["clients"], dropout_p=0.1),
        comm=mod.CommModel(bandwidth=5e6, latency=0.5, t_sample=2e-3,
                           t_launch=0.25),
        strategy=strategy,
        strategy_kwargs=dict(batch_size=64, lr=3e-2, local_epochs=2),
        rounds=c["rounds"], seed=0)


def assert_records_match(got, want, theta_ratios=(), theta=0.65):
    """Port records ``got`` against reference records ``want``."""
    close_calls = parity.theta_band_violations(theta_ratios, theta)
    assert not close_calls, close_calls      # choose another seed
    mismatches = parity.record_mismatches(got, want)
    assert not mismatches, mismatches


@pytest.mark.parametrize("strategy", ["fedavg", "ours"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_run_experiment_matches_jax(case, strategy):
    jspec = _spec(J, case, strategy)
    jsim = jrunner.build_simulation(jspec.validate())
    jsim.run(jspec.rounds, eval_final=True)
    want = [jrunner.record_from_metrics(m) for m in jsim.history]
    p0 = japi.init_params(jax.random.PRNGKey(jspec.seed),
                          jspec.resolve_model())
    sim = T.build_simulation(_spec(T, case, strategy), device="cpu",
                             params={k: np.asarray(v) for k, v in p0.items()})
    sim.run(jspec.rounds)
    got = T.result_from_simulation(_spec(T, case, strategy), sim)
    assert_records_match(got.records, want, sim.theta_ratios)
    if strategy == "ours":
        assert sim.theta_ratios, "the θ filter never ran against a reference"
    assert {c: dataclasses.asdict(r) for c, r in sim.selector.records.items()} \
        == {c: dataclasses.asdict(r) for c, r in jsim.selector.records.items()}
    assert sim.failure_log == jsim.failure_log
    assert sim.ckpt_interval == jsim.ckpt_interval
    assert sim.server_step == jsim.server_step
    assert [l.batch_size for l in sim.loaders] == \
        [l.batch_size for l in jsim.loaders]
    assert (got.param_bytes, got.num_clients) == \
        (jsim.param_bytes, jsim.num_clients)


def test_run_experiment_is_the_simulation_run():
    spec = _spec(T, "smoke", "ours")
    p0 = tapi.init_params(torch.Generator().manual_seed(1),
                          spec.resolve_model())
    res = T.run_experiment(spec, device="cpu", params=p0)
    sim = T.build_simulation(spec, device="cpu", params=p0)
    sim.run(spec.rounds)
    assert res.records == T.result_from_simulation(spec, sim).records
    assert all(np.isfinite(r.accuracy) for r in res.records)
    for k, v in res.params.items():
        assert torch.equal(v, sim.params[k])


def test_import_leaves_jax_out():
    code = ("import sys, repro_torch, repro_torch.api, "
            "repro_torch.kernels.sign_align, repro_torch.kernels.masked_agg,"
            "repro_torch.kernels.quantize, repro_torch.core.compression,"
            "repro_torch.kernels.gather, repro_torch.core.control,"
            "repro_torch.core.draws, repro_torch.core.fl_step,"
            "repro_torch.kernels.ops, repro_torch.kernels.arena,"
            "repro_torch.api.runner, repro_torch.api.parity,"
            "repro_torch.convert, repro_torch.launch.serve,"
            "repro_torch.models.transformer, repro_torch.kernels.flash_attn,"
            "repro_torch.configs.registry, repro_torch.api.session,"
            "repro_torch.api.sweep, repro_torch.api.stats,"
            "repro_torch.checkpoint.io, repro_torch.checkpoint.manager,"
            "repro_torch.faults, repro_torch.core.baselines;"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')];"
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_sources_import_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)\b(?!_)", re.M)
    for f in files:
        hits = pattern.findall(f.read_text())
        assert not hits, (f, hits)
    assert len(files) > 20
    scanned = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"src/repro_torch/api/session.py", "src/repro_torch/api/sweep.py",
            "src/repro_torch/api/stats.py", "src/repro_torch/faults.py",
            "src/repro_torch/checkpoint/io.py",
            "src/repro_torch/checkpoint/manager.py",
            "src/repro_torch/core/baselines.py"} <= scanned


def _asks_for_torch(node) -> bool:
    """``pytest.importorskip("torch")``, bare or assigned."""
    call = node.value if isinstance(node, (ast.Expr, ast.Assign)) else None
    return (isinstance(call, ast.Call)
            and isinstance(call.func, ast.Attribute)
            and call.func.attr == "importorskip"
            and isinstance(call.func.value, ast.Name)
            and call.func.value.id == "pytest"
            and [getattr(a, "value", None) for a in call.args] == ["torch"])


def _imported_roots(node) -> list:
    if isinstance(node, ast.Import):
        return [a.name.split(".")[0] for a in node.names]
    if isinstance(node, ast.ImportFrom) and not node.level:
        return [node.module.split(".")[0]]
    return []


def test_port_tests_skip_where_torch_is_absent():
    """Every tests/test_torch_*.py calls ``pytest.importorskip("torch")`` at
    module level before its first import of torch, repro_torch, repro or
    another test module (which may import them), so that where torch is
    not installed the file is skipped instead of failing to collect."""
    files = sorted((ROOT / "tests").glob("test_torch_*.py"))
    assert len(files) >= 15
    needs_torch = {"torch", "repro", "repro_torch"}
    for f in files:
        body = ast.parse(f.read_text()).body
        skip = next((n.lineno for n in body if _asks_for_torch(n)), None)
        first = next((n.lineno for n in body if any(
            r in needs_torch or r.startswith("test_")
            for r in _imported_roots(n))), None)
        assert skip is not None, f"{f.name}: no pytest.importorskip('torch')"
        assert first is None or skip < first, (
            f"{f.name}: line {first} imports before the importorskip at "
            f"line {skip}")


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdevice.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        T.run_experiment(_spec(T, "smoke", "ours"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.serve_lm(tregistry.get_config("qwen2-1.5b", smoke=True), 1, 8, 1)
    assert tdevice.resolve_device("cpu").type == "cpu"


REFUSED = {
    "optimizer": dict(engine="spmd", strategy="fedavg", optimizer="adamw"),
    "model": dict(model="qwen2-1.5b"),
}


@pytest.mark.parametrize("field", sorted(REFUSED))
def test_spec_refuses_what_is_not_ported(field):
    spec = dataclasses.replace(_spec(T, "smoke", "ours"), **REFUSED[field])
    with pytest.raises(T.SpecError) as err:
        spec.validate()
    issues = [i for i in err.value.issues if i.field == field]
    assert issues, err.value
    assert re.search(r"ROADMAP\.md queue 1 item \d+", issues[0].hint)


# options the port refused before it ran them, now accepted and run:
# spec -> the fields that set the option (a non-resident world also needs
# data.samples_per_client, by the JAX package's rule)
ACCEPTED = {
    "topology": lambda s: dict(topology="two-tier-pods"),
    "candidate_frac": lambda s: dict(candidate_frac=0.5, candidate_shards=2),
    "world.resident": lambda s: dict(
        world=dataclasses.replace(s.world, resident=False),
        data=dataclasses.replace(s.data, samples_per_client=96)),
}
# options that leave the records of the run without them: a topology is
# measurement only
SAME_RECORDS = ("topology",)


@pytest.mark.parametrize("field", sorted(ACCEPTED))
def test_spec_accepts_and_runs_what_is_ported(field):
    """A spec with the option validates as the JAX package's does and runs
    on the CPU (selecting half the clients, so two-stage selection bites);
    a topology leaves the records of the run without it."""
    def smoke(mod):
        s = dataclasses.replace(_spec(mod, "smoke", "ours"), rounds=2)
        return dataclasses.replace(s, strategy_kwargs=dict(
            s.strategy_kwargs, select_fraction=0.5))
    base, jbase = smoke(T), smoke(J)
    spec = dataclasses.replace(base, **ACCEPTED[field](base))
    jspec = dataclasses.replace(jbase, **ACCEPTED[field](jbase))
    assert spec.validate() is spec and jspec.validate() is jspec
    got = T.run_experiment(spec, device="cpu")
    assert len(got.records) == 2
    assert all(np.isfinite(r.loss) for r in got.records)
    if field in SAME_RECORDS:
        assert got.records == T.run_experiment(base, device="cpu").records


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
