"""The port's LM step and prefill on a mesh against the JAX package's
compiled ones on the same mesh, on the CPU.

Smoke qwen2-1.5b (2 layers, d 192, 6 heads, 2 KV heads, d_ff 384) × the
smoke ``train_4k`` (C 2 × 4 × 64) and ``prefill_32k`` (2 × 96), on a 2 × 4
("data", "model") mesh: the JAX step compiled on 8 forced host devices and
counted by ``hlo_census``, the port's traced on meta in a fake world of 8
ranks and counted by its census (``tests/mesh_census.py``; each side in a
subprocess, started together). On one device the two censuses count the
same FLOPs (``test_torch_roofline.py``); on a mesh what they count is the
layout each step chose, so this holds the port's layout to GSPMD's:

  * matrix-product FLOPs a device within 5% of JAX's. The layouts agree
    on every projection (Megatron's column- then row-parallel products,
    the down projection contracting over its rank's 96 of 384); they
    differ in attention, whose 6 heads do not divide 4 ranks: the port
    computes each group of 3 heads on 2 ranks alike (``layers.
    head_groups``), GSPMD splits some of those products' head dim over
    the 2 as well, so the port counts 4.1% (train) and 4.3% (prefill)
    more;
  * collective bytes a device at most 1.25× JAX's (the port's are under
    JAX's: it gathers no weight for the arena's reshapes);
  * no product of the port's has the whole d_ff (384) as a dim: none
    contracts over it, nor makes it, on a "model" rank.
"""
import json
import os
import subprocess
import sys

import pytest
torch = pytest.importorskip("torch")

from repro_torch.models import layers

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FLOPS_RTOL = 0.05
COLLECTIVE_RATIO = 1.25
D_FF = 384                     # smoke qwen2's


@pytest.fixture(scope="module")
def censuses(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_census")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    jax_env = dict(env, XLA_FLAGS=("--xla_force_host_platform_device_count"
                                   "=8 " + env.get("XLA_FLAGS", "")))
    procs = {side: subprocess.Popen(
        [sys.executable, os.path.join(HERE, "mesh_census.py"), side,
         str(tmp / f"{side}.json")], env=jax_env if side == "jax" else env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for side in ("jax", "torch")}
    out = {}
    for side, p in procs.items():
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        with open(tmp / f"{side}.json") as f:
            out[side] = json.load(f)
    return out


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_flops_a_device_equal_the_jax_step(censuses, shape):
    ours, theirs = (censuses[s][shape]["flops"] for s in ("torch", "jax"))
    assert ours == pytest.approx(theirs, rel=FLOPS_RTOL), (ours, theirs)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_collective_bytes_within_the_jax_step(censuses, shape):
    ours = censuses["torch"][shape]["collective_bytes"]
    theirs = censuses["jax"][shape]["collective_bytes"]
    assert 0 < ours <= COLLECTIVE_RATIO * theirs, (
        censuses["torch"][shape]["per_op_bytes"],
        censuses["jax"][shape]["per_op_bytes"])


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_no_product_spans_the_whole_ffn(censuses, shape):
    whole = [p for p in censuses["torch"][shape]["products"]
             if str(D_FF) in p.replace("(", " ").replace(")", " ")
             .replace(",", " ").split()]
    assert not whole, whole


@pytest.mark.parametrize("H,K,m,want", [
    (12, 2, 16, (4, 4)),        # qwen2-1.5b on 16 ranks: 3 heads a rank
    (6, 2, 4, (2, 2)),          # smoke qwen2 on the 2 × 4 mesh
    (6, 2, 2, (2, 1)),          # smoke qwen2 on the 2 × 2 gloo mesh
    (16, 8, 16, (16, 1)),       # heads divide the axis: one a rank
    (14, 2, 4, (2, 2)),         # 7 a KV head: groups of whole KV heads
    (8, 8, 1, (1, 1)),          # one rank
])
def test_head_groups(H, K, m, want):
    f, r = layers.head_groups(H, K, m)
    assert (f, r) == want
    assert f * r == m and H % f == 0
    per, G = H // f, H // K
    assert per % G == 0 or G % per == 0
