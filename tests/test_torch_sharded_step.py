"""The spmd step on DTensors (``core/fl_step.py``'s one step body) and the
census of a mesh (``roofline/census.py``), on the CPU.

The step of smoke qwen2 (full attention and blockwise) runs on a one-rank
gloo debug mesh (1 × 1, ``tests/mesh_ranks.py``'s ``step`` task) from the
same state and batch as the unsharded step, three steps and then one in
which θ passes one of the two clients and filters the other (so that the
filtered client's skip beacon is charged into ``bytes_sent``): its state
(weights, optimizer state, reference signs, counters) and every metric
equal by bits, every leaf of the state a DTensor, and the kernels' plain
versions called as the unsharded step calls them: one count a step and,
aggregating in f32, one aggregation (bf16 aggregation on the CPU is an
einsum, as the JAX oracle's). The counterpart of the JAX package's
``test_sharded_step_runs_on_debug_mesh``; the card's launches are
``chip_smoke.py``'s.

In a fake world (``fake`` task): one smoke layer (attention and FFN) on a
1 × 4 "model" mesh, whose all-reduce bytes equal the rules' reckoning (the
two row-parallel products, ``wo`` and ``wd``, reduce B·S·d elements
each), and the census of qwen2-1.5b's training step (full size, on meta)
on the 1 × 1 mesh equal to the plain step's: FLOPs by operator, kernel
launches and peak, no collective bytes."""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.configs import registry

import mesh_ranks

B, S = 2, 64
FFN_SMOKE = 384                 # smoke qwen2's d_ff


@pytest.fixture(scope="module")
def step_run(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("step_ranks")
    cfg = registry.get_config("qwen2-1.5b", smoke=True)
    rng = np.random.default_rng(5)
    # C 2 clients × 1 × 512 tokens (blockwise takes S % 512 == 0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 1, 512)).astype(np.int64)
    np.savez(workdir / "inputs.npz", tokens=tokens,
             labels=np.roll(tokens, -1, axis=-1))
    return mesh_ranks.run("step", str(workdir))


@pytest.fixture(scope="module")
def fake_run(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("fake_world")
    np.savez(workdir / "inputs.npz", layer_b=np.int64(B),
             layer_s=np.int64(S))
    return mesh_ranks.run("fake", str(workdir))


@pytest.mark.parametrize("step", range(3))
@pytest.mark.parametrize("attn", ["full", "blockwise"])
def test_sharded_step_equals_unsharded_by_bits(step_run, attn, step):
    out = step_run
    assert bool(out[f"{attn}_s{step}_state_equal"])
    assert bool(out[f"{attn}_s{step}_metrics_equal"])
    assert int(out[f"{attn}_s{step}_dtensor_leaves"]) > 0


@pytest.mark.parametrize("attn", ["full", "blockwise"])
def test_sharded_step_calls_the_kernels_as_the_unsharded_step(step_run,
                                                              attn):
    """Rows: the count, the aggregation; columns: unsharded, sharded."""
    agg = 1 if attn == "blockwise" else 0
    for s in range(3):
        assert step_run[f"{attn}_s{s}_calls"].tolist() == [[1, 1],
                                                           [agg, agg]]


@pytest.mark.parametrize("attn", ["full", "blockwise"])
def test_sharded_step_charges_the_filtered_clients_beacon(step_run, attn):
    out = step_run
    assert bool(out[f"{attn}_split_state_equal"])
    names = out[f"{attn}_split_metric_names"].tolist()
    equal = out[f"{attn}_split_metrics_equal"].tolist()
    assert all(equal), [n for n, e in zip(names, equal) if not e]
    assert sorted(out[f"{attn}_split_mask"].tolist()) == [0.0, 1.0]
    assert float(out[f"{attn}_split_bytes_sent"]) == (
        float(out[f"{attn}_split_update_bytes"]) + mesh_ranks.BEACON)


def test_census_all_reduce_bytes_of_a_layer(fake_run):
    out = fake_run
    d, elem = int(out["layer_d"]), int(out["layer_elem_bytes"])
    assert float(out["layer_allreduce_bytes"]) == 2 * B * S * d * elem
    assert float(out["layer_allreduce_calls"]) == 2
    assert out["layer_allreduce_dims"].tolist() == ["model"]
    assert out["layer_nodes"].tolist() == [1]


def test_census_flops_by_product_of_a_layer(fake_run):
    """The products' FLOPs by local shapes add up to the products' FLOPs,
    and the column-parallel up projection is local: its output's last dim
    is the FFN width over the 4 "model" ranks."""
    out = fake_run
    assert float(out["layer_product_flops"]) == float(out["layer_mm_flops"])
    assert float(out["layer_product_flops"]) > 0
    d = int(out["layer_d"])
    assert any(p.endswith(f"({d}, {FFN_SMOKE // 4})")
               for p in out["layer_products"].tolist()), \
        out["layer_products"].tolist()


@pytest.mark.parametrize("count", ["flops", "mm", "launches", "peak",
                                   "collective"])
def test_census_on_one_device_mesh_equals_the_plain_census(fake_run, count):
    out = fake_run
    plain, mesh1 = out[f"step_plain_{count}"], out[f"step_mesh1_{count}"]
    if count == "collective":
        assert float(plain) == float(mesh1) == 0.0
    else:
        np.testing.assert_array_equal(mesh1, plain)


def test_fake_world_meshes(fake_run):
    out = fake_run
    assert bool(out["refused"])
    assert out["single_shape"].tolist() == [16, 16]
    assert out["single_names"].tolist() == ["data", "model"]
    assert out["multi_shape"].tolist() == [2, 16, 16]
    assert out["multi_names"].tolist() == ["pod", "data", "model"]
    assert str(out["single_type"]) == "cpu"
    assert out["population_shape"].tolist() == [16, 1]
    assert out["debug_shape"].tolist() == [1, 1]
