"""The moe, ssm and hybrid language models (granite-moe-1b-a400m,
rwkv6-7b and hymba-1.5b at their SMOKE configs) on the port's cohort
megastep against the JAX package's ``FederatedSimulation`` on the CPU,
under the paper's async ``ours`` strategy; the audio and vlm models
(whisper-tiny, internvl2-2b), whose inputs the token dataset lacks, fail
on the sim engines with the JAX package's ``KeyError`` at the first round.
Rules and world: ``sim_lm_parity.py``.
"""
import pytest
torch = pytest.importorskip("torch")

import repro as J
import repro_torch as T
import sim_lm_parity as P
from repro.api import runner as jrunner
from repro_torch.api import parity

FAMILIES = {"moe": "granite-moe-1b-a400m", "ssm": "rwkv6-7b",
            "hybrid": "hymba-1.5b"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: where several test workers share the machine,
    more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_f32_megastep_matches_jax(family, monkeypatch):
    """Round 0 from the shared start: the globals and the reference signs
    within ``sim_round_bounds``; both rounds: the records by
    ``record_mismatches`` and the θ tests outside ``THETA_BAND``."""
    pair = P.Pair(FAMILIES[family], "megastep", dtype="float32",
                  monkeypatch=monkeypatch)
    assert pair.tc.family == family
    pair.run(1)
    assert pair.round0_problems() == []
    pair.run(1)
    got, want = pair.records()
    assert parity.record_mismatches(got, want) == []
    assert pair.sim.theta_ratios
    assert not parity.theta_band_violations(pair.sim.theta_ratios, P.THETA)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bf16_megastep_exact_fields_match_jax(family):
    """The config's own bf16, one round: the records' exact fields, with
    bf16 leaves counted at 2 bytes on the wire in both packages."""
    pair = P.Pair(FAMILIES[family], "megastep")
    pair.run(1)
    got, want = pair.records()
    assert pair.sim.param_bytes == pair.jsim.param_bytes < 4 * pair.arena.n
    assert parity.exact_field_mismatches(got, want) == []


@pytest.mark.parametrize("path", ["megastep", "loop"])
@pytest.mark.parametrize("arch,key", [("whisper-tiny", "enc_embeds"),
                                      ("internvl2-2b", "patch_embeds")])
def test_inputs_the_token_data_lacks_fail_as_jax_does(arch, key, path):
    """The spec validates and the simulation builds in both packages; the
    first round raises the same ``KeyError`` on the same missing input."""
    jc, tc = P.cfgs(arch)
    errors = []
    for build in (lambda: jrunner.build_simulation(
                      P.spec(J, jc, path).validate()),
                  lambda: T.build_simulation(P.spec(T, tc, path),
                                             device="cpu")):
        sim = build()
        with pytest.raises(KeyError) as err:
            sim.run(1)
        errors.append(err.value.args)
    assert errors == [(key,), (key,)]
