"""The port's device control plane (``repro_torch.core.control``) and its
cohort gather against the JAX package, on the same numpy inputs.

The JAX functions run eagerly here, one XLA operation at a time, so
nothing is fused: where the port does the same f32 operations in the same
order, the results are equal bit for bit (integers, booleans, and the f32
EMAs, scores and scales alike). Selections are ids and must be equal.

The cohort gather's plain version is held to the JAX oracle (``jnp.take``)
bit for bit, signed zeros and NaN payloads included, and to the one-hot
Pallas kernel in interpret mode with ``==`` on finite inputs only: the
one-hot sum adds 0·src[n] for every other slab, which turns −0.0 into
+0.0 and spreads a NaN or Inf to every output.
"""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import aggregation as jagg
from repro.core import async_engine as jae
from repro.core import control as jctl
from repro.kernels import gather as jgather
from repro.kernels import ref as jref
from repro.kernels.arena import ParamArena as JArena

from repro_torch.convert import control_from_jax
from repro_torch.core import aggregation as tagg
from repro_torch.core import async_engine as tae
from repro_torch.core import control as tctl
from repro_torch.kernels import _build
from repro_torch.kernels import arena as tarena
from repro_torch.kernels import gather as tgather

N = 9


def _state(seed=0):
    """A mid-run JAX ControlState with spread statistics, and the port's
    copy of it."""
    rng = np.random.default_rng(seed)
    js = jctl.init_control(N, batch_sizes=[64, 128, 256, 64, 512, 1024, 64,
                                           128, 256])
    js = js._replace(
        avail=jnp.asarray(rng.uniform(0.2, 1.0, N), jnp.float32),
        pass_rate=jnp.asarray(rng.uniform(0.0, 1.0, N), jnp.float32),
        round_time=jnp.asarray(rng.uniform(0.5, 9.0, N), jnp.float32),
        lr_scale=jnp.asarray(rng.uniform(0.25, 2.0, N), jnp.float32),
        grad_norm=jnp.asarray(rng.uniform(0.1, 3.0, N), jnp.float32),
        staleness=jnp.asarray(rng.integers(0, 5, N), jnp.int32),
        has_ckpt=jnp.asarray(rng.random(N) < 0.5))
    return js, control_from_jax(_np(js), "cpu")


def _np(state):
    return {f: np.asarray(getattr(state, f)) for f in state._fields}


def _assert_state_equal(t_state, j_state):
    for f in j_state._fields:
        got = getattr(t_state, f).numpy()
        want = np.asarray(getattr(j_state, f))
        assert got.dtype == want.dtype, (f, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f)


def _obs(seed=1, K=5):
    rng = np.random.default_rng(seed)
    cohort = rng.permutation(N)[:K]
    failed = rng.random(K) < 0.5
    passed = rng.random(K) < 0.5
    rt = rng.uniform(0.5, 12.0, K).astype(np.float32)
    return cohort, failed, passed, rt


def test_init_control_matches_jax():
    tmpl = {"w": np.zeros((2, 1500), np.float32)}
    for quantize in (False, True):
        js = jctl.init_control(4, batch_sizes=[64, 128, 64, 256],
                               arena=JArena(tmpl), quantize=quantize)
        ts = tctl.init_control(4, batch_sizes=[64, 128, 64, 256],
                               arena=tarena.ParamArena(tmpl),
                               quantize=quantize)
        _assert_state_equal(ts, js)
    with pytest.raises(ValueError, match="ParamArena"):
        tctl.init_control(4, quantize=True)


@pytest.mark.parametrize("checkpointing", [False, True])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_observe_round_matches_jax_bitwise(seed, checkpointing):
    js, ts = _state(seed)
    cohort, failed, passed, rt = _obs(seed)
    # with checkpointing every failed client recovers and is observed
    # twice: delivered=False first, then delivered=True
    active = np.ones_like(failed) if checkpointing else ~failed
    want = jctl.observe_round(js, jnp.asarray(cohort), jnp.asarray(failed),
                              jnp.asarray(active), jnp.asarray(passed),
                              jnp.asarray(rt))
    got = tctl.observe_round(ts, torch.from_numpy(cohort),
                             torch.from_numpy(failed),
                             torch.from_numpy(active),
                             torch.from_numpy(passed), torch.from_numpy(rt))
    _assert_state_equal(got, want)
    # the f32 factor: 1 - 0.8f is 0.19999999f, not 0.2f
    assert np.float32(1) - np.float32(0.8) != np.float32(0.2)


def test_score_matches_jax_bitwise():
    js, ts = _state(4)
    np.testing.assert_array_equal(tctl.score(ts).numpy(),
                                  np.asarray(jctl.score(js)))


@pytest.mark.parametrize("live", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_select_topk_epsilon_matches_jax(seed, live):
    rng = np.random.default_rng(seed)
    scores = rng.random(N).astype(np.float32)
    scores[[1, 4]] = scores[7]                     # ties: lower id first
    K = 4
    eps_u = rng.random(K).astype(np.float32)
    eps_u[seed % K] = 0.01                         # at least one swap
    pick_u = rng.random(K).astype(np.float32)
    lv = rng.random(N) < 0.7 if live else None
    if live:
        scores = np.where(lv, scores, -np.inf).astype(np.float32)
    for epsilon in (0.0, 0.3, 1.0):
        want = jctl.select_topk_epsilon(
            jnp.asarray(scores), K, epsilon, eps_u=jnp.asarray(eps_u),
            pick_u=jnp.asarray(pick_u),
            live=None if lv is None else jnp.asarray(lv))
        got = tctl.select_topk_epsilon(
            torch.from_numpy(scores), K, epsilon,
            eps_u=torch.from_numpy(eps_u), pick_u=torch.from_numpy(pick_u),
            live=None if lv is None else torch.from_numpy(lv))
        assert got.dtype == torch.int64
        assert got.tolist() == np.asarray(want).tolist(), epsilon
        assert len(set(got.tolist())) == K


def test_select_topk_draws_from_a_generator():
    scores = torch.tensor([0.1, 0.9, 0.5, 0.7, 0.3])
    assert tctl.select_topk(scores, 2).tolist() == [1, 3]
    a = tctl.select_topk(scores, 2, torch.Generator().manual_seed(3), 1.0)
    b = tctl.select_topk(scores, 2, torch.Generator().manual_seed(3), 1.0)
    assert a.tolist() == b.tolist() and len(set(a.tolist())) == 2
    # two-stage: shards [0.1, 0.9, 0.5] and [0.7, 0.3] keep their top 2
    # (quota = max(ceil(0.5·3), ceil((2 + 1)/2)) = 2), so the union is
    # {1, 2, 3, 4} and the top 2 of it are 1 and 3
    assert tctl.candidate_mask(scores, 2, 0.5, 2).tolist() == \
        [False, True, True, True, True]
    assert tctl.two_stage_select(scores, 2, candidate_frac=0.5,
                                 candidate_shards=2).tolist() == [1, 3]
    # with exploration the swaps stay inside the union
    for seed in range(8):
        got = tctl.select_topk(scores, 2, torch.Generator().manual_seed(seed),
                               1.0, candidate_frac=0.5, candidate_shards=2)
        assert 0 not in got.tolist() and len(set(got.tolist())) == 2


@pytest.mark.parametrize("seed", range(4))
def test_batch_rule_and_feedback_match_jax(seed):
    js, ts = _state(seed)
    cohort, failed, _passed, rt = _obs(seed + 10, K=6)
    valid = ~failed
    if seed == 3:
        valid[:] = False                           # nobody reported
    rt[0] = rt[1] * 1.5                            # exactly at the factor
    want = jctl.batch_feedback(js, jnp.asarray(cohort), jnp.asarray(rt),
                               jnp.asarray(valid))
    got = tctl.batch_feedback(ts, torch.from_numpy(cohort),
                              torch.from_numpy(rt), torch.from_numpy(valid))
    _assert_state_equal(got, want)


@pytest.mark.parametrize("rule", ["grad_norm", "lr_scale", "staleness",
                                  "checkpoint"])
def test_per_client_rules_match_jax_bitwise(rule):
    js, ts = _state(5)
    cohort, failed, passed, rt = _obs(6)
    norms = np.array([0.3, 1.0, 2.5, 0.99999994, 7.0], np.float32)
    jc, tc = jnp.asarray(cohort), torch.from_numpy(cohort)
    if rule == "staleness":
        want = jctl.staleness_update(js, jc, jnp.asarray(passed))
        got = tctl.staleness_update(ts, tc, torch.from_numpy(passed))
    elif rule == "checkpoint":
        want = jctl.checkpoint_update(js, jc, jnp.asarray(~failed))
        got = tctl.checkpoint_update(ts, tc, torch.from_numpy(~failed))
    else:
        jfn = getattr(jctl, f"{rule}_update")
        tfn = getattr(tctl, f"{rule}_update")
        want = jfn(js, jc, jnp.asarray(norms), jnp.asarray(~failed))
        got = tfn(ts, tc, torch.from_numpy(norms), torch.from_numpy(~failed))
    _assert_state_equal(got, want)


def _world_sizes():
    """Every client shard size of the scanned tests' worlds, and more."""
    from repro_torch.api import DataSpec, ExperimentSpec, WorldSpec
    sizes = set(range(1, 80))
    for n, clients in ((1200, 5), (20000, 10)):
        spec = ExperimentSpec(model="anomaly-mlp-smoke",
                              data=DataSpec(n_samples=n, eval_samples=10),
                              world=WorldSpec(num_clients=clients))
        sizes |= {len(c["y"]) for c in spec.build_world().client_arrays}
    return sorted(sizes | {4095, 4096, 4097, 9999})


def test_local_steps_matches_jax_and_the_host_rule():
    n = np.array(_world_sizes(), np.int32)
    for batch in (1, 7, 32, 64, 100, 128, 256, 512, 1024):
        b = np.full_like(n, batch)
        for epochs, cap in ((1, 4096), (2, 4096), (2, 64), (3, 1000)):
            want = np.asarray(jctl.local_steps(jnp.asarray(n), jnp.asarray(b),
                                               epochs, cap))
            got = tctl.local_steps(torch.from_numpy(n), torch.from_numpy(b),
                                   epochs, cap).numpy()
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want)
            st = tae.StrategyConfig(local_epochs=epochs,
                                    max_samples_per_round=cap)
            host = [tae.local_step_count(int(x), batch, st) for x in n]
            np.testing.assert_array_equal(got, host)
            assert host == [jae.local_step_count(int(x), batch, st)
                            for x in n]


def test_staleness_weight_table_matches_jax():
    """Every τ in 0..64, including the τ (5, 6, 16, ...) where an f32
    power in torch is one ulp off XLA's."""
    for alpha0 in (0.6, 1.0):
        table = torch.from_numpy(tagg.staleness_weights_np(np.arange(65),
                                                           alpha0))
        tau = torch.arange(65, dtype=torch.int32).flip(0).reshape(5, 13)
        got = tagg.staleness_weight(tau, table).numpy()
        want = np.asarray(jagg.staleness_weight(tau.numpy(), alpha0))
        np.testing.assert_array_equal(got, want)
        f32_power = (torch.tensor(alpha0) * (1.0 + tau.float()) ** -0.5)
        assert not np.array_equal(f32_power.numpy(), want)


# ---------------------------------------------------------------------------
# cohort gather
# ---------------------------------------------------------------------------

def _slabs(N, R, seed=0, special=False):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((N, R, 1024)).astype(np.float32)
    src[:, :, :8] = -0.0
    if special:
        src[1, 0, 8] = np.nan
        src[1, 0, 9] = np.float32(np.frombuffer(
            np.uint32(0x7FC0_1234).tobytes(), np.float32)[0])   # payload
        src[2, -1, 10:12] = (np.inf, -np.inf)
        src[3, 0, 12:14] = (1e-45, -1e-40)                      # subnormal
    return src


@pytest.mark.parametrize("N,R,idx", [(11, 54, list(range(10))),
                                     (11, 54, [10, 3, 7, 0, 5]),
                                     (7, 3, [6, 1, 2, 3, 1])])
def test_cohort_gather_matches_jax_oracle_bitwise(N, R, idx):
    src = _slabs(N, R, special=True)
    ix = np.array(idx, np.int64)
    want = np.asarray(jref.cohort_gather(jnp.asarray(src),
                                         jnp.asarray(ix, jnp.int32)))
    got = tarena.cohort_gather(torch.from_numpy(src), torch.from_numpy(ix))
    assert got.shape == (len(idx), R, 1024) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  src[ix].view(np.int32))


@pytest.mark.parametrize("N,R,idx", [(11, 54, [10, 3, 7, 0, 5]),
                                     (7, 3, [6, 1, 2, 3, 1])])
def test_cohort_gather_matches_the_pallas_kernel_on_finite_inputs(N, R, idx):
    src = _slabs(N, R, seed=1)
    ix = np.array(idx, np.int64)
    onehot = (ix[:, None] == np.arange(N)[None, :]).astype(np.float32)
    pallas = np.asarray(jgather.onehot_gather(jnp.asarray(src),
                                              jnp.asarray(onehot),
                                              interpret=True))
    got = tgather.cohort_gather(torch.from_numpy(src),
                                torch.from_numpy(ix)).numpy()
    assert np.array_equal(got, pallas)           # == : -0.0 equals +0.0
    # and where the one-hot sum parts from the oracle: signed zeros
    assert np.signbit(got[:, :, :8]).all()
    assert not np.signbit(pallas[:, :, :8]).any()


def _on_xpu(t):
    """A fake tensor of ``t``'s shape and dtype on an XPU, a device with
    neither a kernel nor a plain version of the port's (no data)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return torch.empty(t.shape, dtype=t.dtype, device="xpu")


def _bad_gathers():
    src = torch.zeros((3, 2, 1024))
    idx = torch.tensor([0, 2])
    return {
        "src dtype": (src.double(), idx),
        "src lane": (src[..., :512], idx),
        "src 2-D": (src[0], idx),
        "src no slabs": (src[:0], idx),
        "idx dtype": (src, idx.to(torch.int32)),
        "idx 2-D": (src, idx[None]),
        "idx empty": (src, idx[:0]),
        # a device with no kernel (meta tensors take the shape-only call)
        "device": (_on_xpu(src), _on_xpu(idx)),
        "devices differ": (src, idx.to("meta")),
    }


@pytest.mark.parametrize("bad", sorted(_bad_gathers()))
def test_gather_wrapper_rejects_what_the_kernel_does_not_take(bad):
    with pytest.raises((TypeError, ValueError)):
        tgather.cohort_gather(*_bad_gathers()[bad])


def test_cpu_gather_launches_no_kernel_and_checks_bounds():
    before = tgather.launches
    out = tgather.cohort_gather(torch.ones((2, 1, 1024)), torch.tensor([1]))
    assert out.shape == (1, 1, 1024) and tgather.launches == before
    with pytest.raises(IndexError):
        tgather.cohort_gather(torch.ones((2, 1, 1024)), torch.tensor([2]))


def test_cuda_tensor_gets_the_kernel_or_an_exception(monkeypatch):
    """A CUDA tensor never falls back to the plain version: here, with no
    card and no CUDA toolkit, the kernel's build raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda-home")
    monkeypatch.setattr(_build, "_loaded", {})
    before = tgather.launches
    with FakeTensorMode():
        src = torch.empty((3, 2, 1024), device="cuda")
        idx = torch.zeros((2,), dtype=torch.int64, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc"):
            tgather.cohort_gather(src, idx)
    assert tgather.launches == before
