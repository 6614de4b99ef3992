"""The kernels' placement rules (``repro_torch.kernels.sharded``) on a
2 × 2 ("data", "model") mesh of four gloo ranks on the CPU
(``tests/mesh_ranks.py``'s ``kernels`` task, one spawn for the module):
each wrapper called on DTensors at smoke shapes, the result gathered whole
and held to the same wrapper's single-device call (the plain versions
here). Counts, int8 codes and scales, gathers and the error-feedback round
trip by bits; weighted sums by the rule of the client-axis reductions
(1e-6 of Σ_c |w_c·u_c|, plus one f32 ulp of p for ``fused_update``); flash
attention within 1e-5. The fake world's collectives move no data, so
these run on real ranks. One count past 2^24 matches, split over two row
shards, shows the int64 all-reduce: f32 partials would round it.

The same ranks then run smoke qwen2's spmd step on the 2 × 2 mesh (four
clients, two packed a "data" rank, the weights tensor-parallel over
"model") beside the unsharded step from the same state, three steps:
where the 1 × 1 mesh of ``tests/test_torch_sharded_step.py`` moves
nothing, this one exercises the client offsets, the order of the client
shards and the gradients' gathers, by the rules stated below."""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attn, gather, masked_agg, quantize
from repro_torch.kernels import sign_align

import mesh_ranks

C, R, LANE = 4, 6, 1024
BIG_ROWS = 2 * 16400            # two row shards of 16,400 rows
LAYOUTS = ("clients", "rows", "both", "replicated")
STEPS = 3


def _inputs(rng):
    tokens = rng.integers(0, 512, (4, 1, 128)).astype(np.int64)
    u = rng.normal(size=(C, R, LANE)).astype(np.float32)
    u[rng.random(u.shape) < 0.05] = 0.0
    ref = rng.integers(-1, 2, size=(R, LANE)).astype(np.int8)
    ref.reshape(-1)[-100:] = -2                      # padding sentinel
    return {
        "u": u, "ref": ref,
        "refs2": rng.integers(-1, 2, size=(2, R, LANE)).astype(np.int8),
        "w": rng.uniform(0, 1, C).astype(np.float32),
        "p": rng.normal(size=(R, LANE)).astype(np.float32),
        "x": (rng.normal(size=(R, LANE)) * rng.uniform(
            0.01, 10, (R, 1))).astype(np.float32),
        "e": (rng.normal(size=(R, LANE)) * 0.01).astype(np.float32),
        "src": rng.normal(size=(5, R, LANE)).astype(np.float32),
        "idx": np.array([4, 0, 2], np.int64),
        "q": rng.normal(size=(2, 128, 4, 16)).astype(np.float32),
        "k": rng.normal(size=(2, 128, 2, 16)).astype(np.float32),
        "v": rng.normal(size=(2, 128, 2, 16)).astype(np.float32),
        "big_rows": np.int64(BIG_ROWS),
        # smoke qwen2's step on the mesh: 4 clients × 1 × 128 tokens
        "step2_tokens": tokens, "step2_labels": np.roll(tokens, -1, -1),
        "step2_steps": np.int64(STEPS),
    }


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("kernel_ranks")
    inputs = _inputs(np.random.default_rng(11))
    np.savez(workdir / "inputs.npz", **inputs)
    return ({k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()},
            mesh_ranks.run("kernels", str(workdir)))


def _sum_bound(u, w):
    return 1e-6 * float((w[:, None, None] * u).abs().sum(0).max())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sign_counts_equal_by_bits(ranks, layout):
    t, out = ranks
    want = sign_align.per_client_sign_align(t["u"], t["ref"]).numpy()
    np.testing.assert_array_equal(out[f"count_{layout}"], want)


def test_grouped_sign_counts_equal_by_bits(ranks):
    """Two references, the clients and rows sharded: each rank's clients
    lie in one group."""
    t, out = ranks
    np.testing.assert_array_equal(
        out["count_grouped"],
        sign_align.per_client_sign_align(t["u"], t["refs2"]).numpy())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_weighted_sums_within_the_reduction_rule(ranks, layout):
    t, out = ranks
    bound = _sum_bound(t["u"], t["w"])
    agg = masked_agg.masked_agg(t["u"], t["w"]).numpy()
    np.testing.assert_allclose(out[f"agg_{layout}"], agg, rtol=0,
                               atol=bound)
    np.testing.assert_allclose(out[f"wsum_{layout}"], agg, rtol=0,
                               atol=bound)
    fused = masked_agg.fused_update(t["p"], t["u"], t["w"]).numpy()
    ulp = np.spacing(np.abs(fused)).max()
    np.testing.assert_allclose(out[f"fused_{layout}"], fused, rtol=0,
                               atol=bound + ulp)
    if layout in ("rows", "replicated"):       # clients whole: one sum
        np.testing.assert_array_equal(out[f"agg_{layout}"], agg)
        np.testing.assert_array_equal(out[f"fused_{layout}"], fused)


@pytest.mark.parametrize("layout", ["rows", "rows2"])
def test_codec_and_round_trip_equal_by_bits(ranks, layout):
    """Row-wise kernels over rows sharded on one mesh dim and on both."""
    t, out = ranks
    q, s = quantize.quantize_q8(t["x"])
    np.testing.assert_array_equal(out[f"q_{layout}"], q.numpy())
    np.testing.assert_array_equal(out[f"s_{layout}"], s.numpy())
    np.testing.assert_array_equal(out[f"deq_{layout}"],
                                  quantize.dequantize_q8(q, s).numpy())
    rest, res = quantize.ef_round_trip(t["x"], t["e"])
    np.testing.assert_array_equal(out[f"rt_{layout}"], rest.numpy())
    np.testing.assert_array_equal(out[f"res_{layout}"], res.numpy())
    count = sign_align.sign_align_counts(t["x"], t["ref"]).numpy()
    np.testing.assert_array_equal(out[f"count1_{layout}"], count)


def test_cohort_gather_equals_by_bits(ranks):
    t, out = ranks
    np.testing.assert_array_equal(
        out["gather"], gather.cohort_gather(t["src"], t["idx"]).numpy())


@pytest.mark.parametrize("layout", ["bh", "seq"])
def test_flash_attention_within_its_rule(ranks, layout):
    """Batch over "data" and heads over "model" (each rank's query heads
    read its own KV head); a sharded sequence is gathered first."""
    t, out = ranks
    want = flash_attn.flash_attention_gqa(t["q"], t["k"], t["v"],
                                          causal=True).numpy()
    np.testing.assert_allclose(out[f"flash_{layout}"], want, rtol=0,
                               atol=1e-5)


def test_count_past_2_24_is_all_reduced_in_int64(ranks):
    _, out = ranks
    exact = 2 ** 24 + 2
    f32_partials = np.float32(np.float32(2 ** 24 + 1) + np.float32(1))
    assert f32_partials != exact          # what an f32 all-reduce gives
    assert float(out["big"]) == exact
    assert out["big_clients"].tolist() == [exact]


# --------------------------------------------------------------------------
# smoke qwen2's step on the 2 x 2 mesh against the unsharded step
# --------------------------------------------------------------------------
# The model's tensor-parallel products sum over "model" in another order
# than one device does, so the step is held by rules, not by bits:
#   * a ratio within RATIO_TOL (each slot whose gradient sign the reordering
#     flips moves a ratio by 1/n: 1e-5 is some 33 of the 3.35M slots), while
#     two clients' ratios part by more than ten times that, so that a client
#     packed at the wrong offset or in the wrong order shows;
#   * the θ mask and every count-derived metric by bits, the loss within
#     1e-6;
#   * a weight within STATE_RTOL of the step's own update (sgd with
#     momentum: the weights are linear in the aggregate), the momentum
#     within STATE_RTOL of its largest magnitude, each plus one f32 ulp;
#   * the reference signs: at most REF_FLIPS of the arena's slots differ.
RATIO_TOL, STATE_RTOL, REF_FLIPS = 1e-5, 2e-5, 1e-5
EXACT_METRICS = ("accept_rate", "bytes_baseline", "bytes_sent", "delivered",
                 "mask", "selected")


def test_mesh_step_shards_clients_and_weights(ranks):
    _, out = ranks
    assert int(out["step2_local_clients"]) == 2       # 4 clients, 2 a rank
    assert int(out["step2_sharded_weights"]) > 0       # over "model"


@pytest.mark.parametrize("step", range(STEPS))
def test_mesh_step_ratios_and_mask_against_unsharded(ranks, step):
    _, out = ranks
    plain = out[f"step2_s{step}_ratios_plain"]
    got = out[f"step2_s{step}_ratios_mesh"]
    np.testing.assert_allclose(got, plain, rtol=0, atol=RATIO_TOL)
    if step > 0:      # round 0's reference is empty: ratios tie in pairs
        gaps = np.abs(plain[:, None] - plain[None, :])[~np.eye(C, dtype=bool)]
        assert gaps.min() > 10 * RATIO_TOL
    for k in EXACT_METRICS:
        np.testing.assert_array_equal(out[f"step2_s{step}_{k}_mesh"],
                                      out[f"step2_s{step}_{k}_plain"],
                                      err_msg=k)
    np.testing.assert_allclose(out[f"step2_s{step}_loss_mesh"],
                               out[f"step2_s{step}_loss_plain"], rtol=1e-6)


@pytest.mark.parametrize("step", range(STEPS))
def test_mesh_step_state_against_unsharded(ranks, step):
    _, out = ranks
    names = out["step2_leaves"]
    err, scale = out[f"step2_s{step}_err"], out[f"step2_s{step}_scale"]
    ulp = out[f"step2_s{step}_ulp"]
    flips = slots = 0
    for name, e, s, u in zip(names, err, scale, ulp):
        group = name.split("/")[0]
        if group == "2":                              # reference signs
            flips, slots = flips + e, slots + s
        elif group in ("0", "1"):                     # weights, momentum
            assert e <= STATE_RTOL * s + u, (name, e, s, u)
        else:                                         # step, counters
            assert e == 0, name
    assert slots > 0 and flips <= REF_FLIPS * slots, (flips, slots)
