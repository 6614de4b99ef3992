"""The population plane over a real process group: four gloo ranks on the
CPU (``tests/mesh_ranks.py``'s ``population`` task, one spawn for the
module) run ``round_update_sharded``, ``sharded_candidates`` and
``build_population_round(mesh=...)`` on a ("data" 4, "model" 1) mesh. Held
by bits, ragged populations included (n 64 and 1,001 over 4 ranks):
``round_update_sharded`` to the JAX package's ``round_update`` fed the
same numpy inputs (and to the port's), ``sharded_candidates`` to the JAX
package's ``logical_candidates(shards=4)``, the mesh round to the port's
``build_population_round(candidate_shards=4)``."""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import control as jctl
from repro.core import population as jpop

from repro_torch.core import control as tctl
from repro_torch.core import population as tpop

import mesh_ranks

SIZES = (64, 1001)
ROUNDS = 4
K = 8
CAND = ((8, 0.02), (8, 0.25), (16, 1.0))


def _inputs(rng):
    inputs = {"pop_sizes": np.array(SIZES), "pop_rounds": np.int64(ROUNDS),
              "cand_cases": np.array(CAND)}
    for n in SIZES:
        inputs[f"pop{n}_avail"] = rng.uniform(0, 1, n).astype(np.float32)
        inputs[f"pop{n}_pass_rate"] = rng.uniform(0, 1, n).astype(np.float32)
        inputs[f"pop{n}_round_time"] = rng.uniform(0.2, 3, n).astype(
            np.float32)
        inputs[f"pop{n}_batch"] = (2 ** rng.integers(3, 8, n)).astype(
            np.int32)
        inputs[f"pop{n}_lr_scale"] = rng.uniform(0.25, 2, n).astype(
            np.float32)
        inputs[f"pop{n}_grad_norm"] = rng.uniform(0, 2, n).astype(np.float32)
        inputs[f"pop{n}_staleness"] = rng.integers(0, 5, n).astype(np.int32)
        inputs[f"pop{n}_has_ckpt"] = rng.random(n) < 0.5
        for r in range(ROUNDS):
            cohort = rng.choice(n, size=K, replace=False)
            if r == 1:                  # the first and the last client
                cohort[:2] = (0, n - 1)
            failed = rng.random(K) < 0.2
            active = ~failed
            inputs[f"pop{n}_r{r}_cohort"] = cohort.astype(np.int64)
            inputs[f"pop{n}_r{r}_failed"] = failed
            inputs[f"pop{n}_r{r}_active"] = active
            inputs[f"pop{n}_r{r}_passed"] = (rng.random(K) < 0.8) & active
            inputs[f"pop{n}_r{r}_round_time"] = rng.uniform(
                0.2, 3.0, K).astype(np.float32)
            inputs[f"pop{n}_r{r}_sent"] = active
            inputs[f"pop{n}_r{r}_norms"] = rng.uniform(
                0.05, 2.5, K).astype(np.float32)
        s = np.round(rng.normal(size=n)).astype(np.float32) + np.float32(0)
        s[rng.random(n) < 0.1] = -np.inf            # ties and -inf scores
        inputs[f"pop{n}_scores"] = s
    return inputs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("population_ranks")
    inputs = _inputs(np.random.default_rng(7))
    np.savez(workdir / "inputs.npz", **inputs)
    return inputs, mesh_ranks.run("population", str(workdir))


def _jax_state(inputs, n):
    return jctl.init_control(n)._replace(**{
        f: jnp.asarray(inputs[f"pop{n}_{f}"]) for f in tpop._FIELDS})


def _torch_state(inputs, n):
    return tctl.init_control(n)._replace(**{
        f: torch.from_numpy(inputs[f"pop{n}_{f}"]) for f in tpop._FIELDS})


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("n", SIZES)
def test_sharded_round_update_equals_jax_round_update_by_bits(ranks, n):
    """Against the JAX function run eagerly, operation by operation: under
    ``jax.jit`` XLA fuses the round-time EMA and parts from it by one f32
    ulp (n 64, round 0, client 52: 2.6181686 against 2.6181688), which the
    single-device tests allow for with ``parity.EMA_RTOL``."""
    inputs, out = ranks
    jround = jpop.round_update
    jst = _jax_state(inputs, n)
    tst = _torch_state(inputs, n)
    for r in range(ROUNDS):
        obs = {k: inputs[f"pop{n}_r{r}_{k}"] for k in (
            "failed", "active", "passed", "round_time", "sent", "norms")}
        cohort = inputs[f"pop{n}_r{r}_cohort"]
        jst = jround(jst, jnp.asarray(cohort.astype(np.int32)),
                     **{k: jnp.asarray(v) for k, v in obs.items()})
        tst = tpop.round_update(tst, torch.from_numpy(cohort),
                                **{k: torch.from_numpy(v)
                                   for k, v in obs.items()})
        for f in tpop._FIELDS:
            got = out[f"pop{n}_r{r}_{f}"]
            want = np.asarray(getattr(jst, f))
            assert got.dtype == want.dtype, (f, r)
            np.testing.assert_array_equal(_bits(got), _bits(want),
                                          err_msg=f"{f} round {r}")
            np.testing.assert_array_equal(
                _bits(got), _bits(getattr(tst, f).numpy()))


def test_ragged_population_splits_as_torch_chunk(ranks):
    """Rank 0's slice is ceil(n / 4) rows: 16 of 64, 251 of 1,001 (the
    JAX package's ``per``)."""
    _, out = ranks
    assert int(out["pop64_r0_local"]) == 16
    assert int(out["pop1001_r0_local"]) == 251


@pytest.mark.parametrize("case", range(len(CAND)))
@pytest.mark.parametrize("n", SIZES)
def test_sharded_candidates_equal_jax_logical_candidates(ranks, n, case):
    inputs, out = ranks
    k, frac = CAND[case]
    v, i = jax.jit(jpop.logical_candidates,
                   static_argnames=("k", "frac", "shards"))(
        jnp.asarray(inputs[f"pop{n}_scores"]), k=int(k), frac=float(frac),
        shards=4)
    np.testing.assert_array_equal(_bits(out[f"cand{n}_{case}_v"]),
                                  _bits(np.asarray(v)))
    np.testing.assert_array_equal(out[f"cand{n}_{case}_i"],
                                  np.asarray(i).astype(np.int64))
    tv, ti = tpop.logical_candidates(
        torch.from_numpy(inputs[f"pop{n}_scores"]), int(k), float(frac), 4)
    np.testing.assert_array_equal(_bits(out[f"cand{n}_{case}_v"]),
                                  _bits(tv.numpy()))
    np.testing.assert_array_equal(out[f"cand{n}_{case}_i"], ti.numpy())


@pytest.mark.parametrize("frac", [0.25, 1.0])
@pytest.mark.parametrize("n", SIZES)
def test_mesh_round_equals_the_four_shard_round(ranks, n, frac):
    _, out = ranks
    for r in range(3):
        assert bool(out[f"round{n}_{frac}_r{r}_cohorts_equal"]), r
        assert bool(out[f"round{n}_{frac}_r{r}_state_equal"]), r
