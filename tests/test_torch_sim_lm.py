"""The dense language model (qwen2-1.5b's SMOKE config) on the port's
three sim paths (the per-client loop, the cohort megastep, the scanned
control plane) against the JAX package's ``FederatedSimulation`` on the
CPU, under the paper's async ``ours`` strategy; the mlp's sim records
equal by bits to what they were before the language models joined the
sim paths; the token-data drift refusal. Rules and world:
``sim_lm_parity.py``.
"""
import dataclasses
import hashlib

import pytest
torch = pytest.importorskip("torch")

import repro as J
import repro.api as Japi
import repro_torch as T
import sim_lm_parity as P
from repro_torch.api import parity

ARCH = "qwen2-1.5b"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: where several test workers share the machine,
    more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_theta_tests(sim):
    assert sim.theta_ratios, "the θ filter never ran against a reference"
    close = parity.theta_band_violations(sim.theta_ratios, P.THETA)
    assert not close, close


@pytest.mark.parametrize("path", ["loop", "megastep"])
def test_f32_matches_jax(path, monkeypatch):
    """Round 0 from the shared start: the globals and the reference signs
    within ``sim_round_bounds``; both rounds: the records by
    ``record_mismatches``."""
    pair = P.Pair(ARCH, path, dtype="float32", monkeypatch=monkeypatch)
    pair.run(1)
    assert pair.round0_problems() == []
    pair.run(1)
    got, want = pair.records()
    assert parity.record_mismatches(got, want) == []
    _assert_theta_tests(pair.sim)


def test_f32_scanned_matches_jax():
    """The scanned path at 2 rounds a dispatch with fused eval, fed JAX's
    draws: ``scanned_mismatches``."""
    pair = P.Pair(ARCH, "scanned", dtype="float32")
    pair.run(P.ROUNDS)
    got, want = pair.records()
    assert parity.scanned_mismatches(got, want) == []
    _assert_theta_tests(pair.sim)
    assert pair.sim.dispatches == 1


def test_bf16_exact_fields_match_jax():
    """The config's own bf16 on the megastep: the records' exact fields
    (bf16 leaves count 2 bytes on the wire in both packages) and the θ
    tests; loss and accuracy finite."""
    pair = P.Pair(ARCH, "megastep")
    pair.run(P.ROUNDS)
    got, want = pair.records()
    assert pair.sim.param_bytes == pair.jsim.param_bytes == 2 * pair.arena.n
    assert parity.exact_field_mismatches(got, want) == []
    assert all(torch.isfinite(torch.tensor([r.loss, r.accuracy])).all()
               for r in got)
    _assert_theta_tests(pair.sim)


def test_run_experiment_trains_an_lm_on_the_sim_engine():
    """``run_experiment`` over a session, bf16 on the megastep: the same
    records as the simulation driven directly, and the returned weights
    keep their nest and dtype."""
    _, tc = P.cfgs(ARCH)
    spec = P.spec(T, tc)
    p0 = T.build_simulation(spec, device="cpu").params
    res = T.run_experiment(spec, device="cpu", params=p0)
    sim = T.build_simulation(spec, device="cpu", params=p0)
    sim.run(spec.rounds)
    assert res.records == T.result_from_simulation(spec, sim).records
    assert res.params["layers"]["attn"]["wq"].dtype == torch.bfloat16


def test_drift_refusal_on_tokens_unchanged():
    """A drift scenario over token data is refused on the same field with
    the JAX package's words."""
    hints = []
    for mod, api, cfg in zip((J, T), (Japi, T), P.cfgs(ARCH)):
        spec = P.spec(mod, cfg, scenario=api.ScenarioSpec(
            drift=api.DriftSpec()))
        with pytest.raises(api.SpecError) as err:
            spec.validate()
        hints.append([i.hint for i in err.value.issues
                      if i.field == "scenario.drift"])
    assert hints[0] and hints[0] == hints[1]


# The quickstart's smoke spec (examples/quickstart.py with REPRO_SMOKE) under
# ``ours`` on the port, before the language models joined the sim paths:
# each round's (round, sim_time, comm_time, idle_time, bytes_sent,
# updates_applied, accept_rate, accuracy, loss) and the SHA-256 of the final
# weights' bytes (keys sorted).
MLP_BEFORE = {
    False: ([(0, 1.3276215462294552, 0.4183393299228062, 0.0, 18240.0, 4,
              1.0, 0.7333333492279053, 1.0707160979509354),
             (1, 2.0875003173511586, 0.8348547098456124, 0.0, 27360.25, 2,
              0.5, 0.7766666412353516, 0.9989380314946175)],
            {True: "e53b148e68584f217363c8a8a965fdb3"
                   "ea84a43923bf07a90542c042a8c78d64",
             False: "e53b148e68584f217363c8a8a965fdb3"
                    "ea84a43923bf07a90542c042a8c78d64"}),
    True: ([(0, 1.327120746229455, 0.4163361299228062, 0.0, 8224.0, 4, 1.0,
             0.7333333492279053, 1.0707160979509354),
            (1, 2.0869995173511584, 0.8318499098456125, 0.0, 12336.25, 2,
             0.5, 0.7766666412353516, 0.9992325752973557)],
           {True: "abd05f81a8ec3f5280d8a3651b294b23"
                  "59fdfbf6083655f1854172185f115fbd",
            False: "c62a68b5af625abf3d6f3147cc4788d8"
                   "5405c7ab50bb3c242071d594abf4ccff"}),
}


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("megastep", [True, False])
def test_mlp_records_equal_by_bits_to_before(megastep, int8):
    records, digests = MLP_BEFORE[int8]
    spec = T.ExperimentSpec(
        model="anomaly-mlp-smoke",
        data=T.DataSpec(n_samples=1500, eval_samples=300, alpha=0.5),
        world=T.WorldSpec(num_clients=4, dropout_p=0.1),
        comm=T.CommModel(bandwidth=5e6, latency=0.5, t_sample=2e-3,
                         t_launch=0.25),
        strategy="ours",
        strategy_kwargs=dict(batch_size=64, lr=3e-2, local_epochs=2,
                             quantize_updates=int8),
        rounds=2, seed=0, megastep=megastep)
    sim = T.build_simulation(spec, device="cpu")
    sim.run(spec.rounds)
    assert [dataclasses.astuple(r) for r in sim.history] == records
    h = hashlib.sha256()
    for k in sorted(sim.params):
        h.update(sim.params[k].contiguous().numpy().tobytes())
    assert h.hexdigest() == digests[megastep]
