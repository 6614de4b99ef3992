"""The port's census and roofline (``repro_torch.roofline``) on the CPU, on
meta tensors: the census's unit cases as ``tests/test_roofline.py`` holds
the JAX package's HLO census, its matrix-product FLOPs against that census
on the same steps, the recurrences' loops counted as their step × T, and
``model_flops`` and the results file against the JAX package.

Tolerances: FLOPs are integers on both sides (2·|result|·K of every matrix
product) and must be equal. The JAX census counts the dots of the compiled
HLO; the port's, the matrix products it dispatches; on the two smoke cases
here they are the same products.
"""
import dataclasses
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
torch = pytest.importorskip("torch")

from repro.configs import registry as jreg
from repro.configs.shapes import SHAPES as JSHAPES
from repro.core import fl_step as jfl
from repro.models import api as japi
from repro.roofline import analysis as janalysis
from repro.roofline import hlo_census

from repro_torch import loops
from repro_torch.configs import registry as treg
from repro_torch.configs.shapes import SHAPES
from repro_torch.core import fl_step as tfl
from repro_torch.models import api as tapi
from repro_torch.models import hybrid, rwkv6
from repro_torch.models import layers as tlayers
from repro_torch.roofline import analysis
from repro_torch.roofline.census import Census

META = "meta"


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _count(fn, *args) -> dict:
    c = Census()
    with c:
        fn(*args)
    return c.analyze()


def test_flat_matmul_flops():
    res = _count(lambda a, b: a @ b, _meta(64, 128), _meta(128, 32))
    assert res["flops"] == 2 * 64 * 128 * 32
    assert res["flops_by_op"] == {"aten::mm": 2 * 64 * 128 * 32}


@pytest.mark.parametrize("op", ["linear", "bmm", "einsum", "addmm"])
def test_every_matmul_form_counts(op):
    """``linear``, ``einsum`` and ``matmul`` reach the dispatcher as mm,
    addmm or bmm: each counts 2·|result|·K."""
    x, w = _meta(4, 8, 16), _meta(32, 16)
    fns = {"linear": lambda: torch.nn.functional.linear(x, w),
           "bmm": lambda: torch.bmm(x, _meta(4, 16, 32)),
           "einsum": lambda: torch.einsum("bsd,ed->bse", x, w),
           "addmm": lambda: torch.addmm(_meta(32), x[0], w.t())}
    res = _count(fns[op])
    want = 2 * (8 * 32 if op == "addmm" else 4 * 8 * 32) * 16
    assert res["flops"] == want


def test_loop_multiplies_by_trip_count():
    """A loop counted once under ``loop(name, L)`` equals the loop run L
    times, as the JAX census's ``while`` trip counts."""
    L, D = 7, 32
    ws, x = _meta(L, D, D), _meta(4, D)

    def unrolled():
        h = x
        for i in range(L):
            h = torch.tanh(h @ ws[i])

    def counted():
        with loops.loop("layers", L):
            torch.tanh(x @ ws[0])

    a, b = _count(unrolled), _count(counted)
    assert a["flops"] == b["flops"] == L * 2 * 4 * D * D
    assert a["traffic_bytes"] == b["traffic_bytes"]
    assert b["while_trips"] == {"layers": L}
    assert a["while_trips"] == {}


def test_nested_loops_multiply():
    Lo, Li, D = 3, 5, 16

    def f():
        with loops.loop("outer", Lo), loops.loop("inner", Li):
            torch.tanh(_meta(2, D) @ _meta(D, D))

    res = _count(f)
    assert res["flops"] == Lo * Li * 2 * 2 * D * D
    assert res["while_trips"] == {"outer": Lo, "inner": Li}


def test_loop_without_a_census_is_inert():
    with loops.loop("nothing", 5):
        y = _meta(3, 4) @ _meta(4, 2)
    assert y.shape == (3, 2)


def test_traffic_positive_and_bounded():
    res = _count(lambda x: (x @ x).sum(), _meta(256, 256))
    # the product's result written and re-read, the sum's 4 bytes
    assert res["traffic_bytes"] == 2 * 256 * 256 * 4 + 2 * 4
    c = Census()
    x = _meta(256, 256)
    c.hold(x)
    with c:
        (x @ x).sum()
    res = c.analyze()
    assert res["traffic_bytes"] >= 256 * 256 * 4            # the input
    assert res["traffic_bytes"] < 100 * 256 * 256 * 4
    assert res["peak_bytes"] == 2 * 256 * 256 * 4 + 4


def test_views_and_allocations_move_no_bytes():
    """Views move and allocate nothing, an allocation writes nothing, an
    in-place operator writes its result and allocates nothing, and a
    copy of a transpose materialises."""
    x = _meta(64, 64)
    res = _count(lambda: (x.t(), x.reshape(-1)[:10].view(2, 5),
                          torch.empty(1000, device=META)))
    assert res["traffic_bytes"] == 0
    assert res["peak_bytes"] == 1000 * 4
    res = _count(lambda: x.add_(1))
    assert (res["traffic_bytes"], res["peak_bytes"]) == (2 * 64 * 64 * 4, 0)
    res = _count(lambda: x.t().reshape(-1))
    assert res["traffic_bytes"] == res["peak_bytes"] * 2 == 2 * 64 * 64 * 4


def test_peak_follows_frees():
    """Each new storage is live until its last tensor dies; views share
    their base's storage."""
    def f():
        a = _meta(1000)              # 4,000 bytes
        b = a * 2                    # 8,000 live: the peak
        del a                        # 4,000
        c = b[:10] + 1               # 4,040 (the slice is b's storage)
        del b, c
        return _meta(1500) + 1       # 12,000 at its end, 6,000 before

    c = Census()
    with c:
        out = f()
    assert c.analyze()["peak_bytes"] == 12000
    del out
    assert c.live == 0


def test_kernels_count_as_launches():
    """A hand-written kernel's shape-only call is one launch with its
    reckoned bytes and operations, and no aten operator of its own."""
    from repro_torch.kernels import masked_agg, sign_align
    u, w = _meta(3, 5, 1024), _meta(3)
    r = _meta(5, 1024, dtype=torch.int8)
    res = _count(lambda: (sign_align.per_client_sign_align(u, r),
                          masked_agg.masked_agg(u, w)))
    n = 5 * 1024
    assert res["kernel_launches"] == {"per_client_sign_align": 1,
                                      "masked_agg": 1}
    assert res["flops"] == 2 * 3 * n + 2 * 3 * n
    assert res["traffic_bytes"] == (3 * n * 4 + n + 12) + (3 * n * 4 + 12
                                                           + n * 4)
    assert set(res["op_counts"]) == {"repro_torch::per_client_sign_align",
                                     "repro_torch::masked_agg"}


def _loop_on_meta(step, xs, rest):
    """The recurrences' own loop, run on meta tensors: step t on
    ``x[:, t]``, the outputs stacked."""
    carry, outs = rest[-1], []
    for t in range(xs[0].shape[1]):
        y, carry = step(*(x[:, t] for x in xs), *rest[:-1], carry)
        outs.append(y)
    return torch.stack(outs, dim=1), carry


SCANS = {   # name -> (step, xs shapes, rest shapes, the model's call)
    "wkv_scan": (rwkv6._wkv_step, [(2, 5, 3, 4)] * 4, [(1, 3, 4, 1),
                                                        (2, 3, 4, 4)]),
    "ssm_scan": (hybrid._ssm_step, [(2, 5, 6), (2, 5, 6), (2, 5, 3),
                                    (2, 5, 3)], [(6, 3), (6,), (2, 6, 3)]),
}


@pytest.mark.parametrize("name", sorted(SCANS))
def test_meta_scan_counts_its_step_T_times(name):
    """On meta the recurrence runs one step counted T times: the same
    bytes and the same operators as the loop over T steps (but the stack
    of the outputs, a copy of the same bytes), its output and carry of
    the loop's shapes."""
    step, x_shapes, rest_shapes = SCANS[name]
    xs = [_meta(*s) for s in x_shapes]
    rest = [_meta(*s) for s in rest_shapes]
    T = x_shapes[0][1]
    looped = Census()
    with looped:
        y0, c0 = _loop_on_meta(step, xs, rest)
    scanned = Census()
    with scanned:
        y1, c1 = tlayers.meta_scan(step, xs, rest, name)
    a, b = looped.analyze(), scanned.analyze()
    assert (y1.shape, c1.shape) == (y0.shape, c0.shape)
    assert b["while_trips"] == {name: T}
    assert b["traffic_bytes"] == a["traffic_bytes"]
    assert b["flops"] == a["flops"]
    assembly = {"aten::stack", "aten::clone", "aten::expand",
                "aten::unsqueeze", "aten::detach", "aten::alias"}
    assert {k: v for k, v in b["op_counts"].items() if k not in assembly} \
        == {k: v for k, v in a["op_counts"].items() if k not in assembly}


def test_models_do_not_import_the_roofline():
    """The models reach the census only through ``repro_torch.loops``: no
    module of ``models/`` imports ``roofline/`` or ``launch/``."""
    pattern = re.compile(
        r"^\s*(from|import)\s+repro_torch\.(roofline|launch)\b", re.M)
    models = Path(tlayers.__file__).parent
    for f in sorted(models.glob("*.py")):
        assert not pattern.search(f.read_text()), f.name


def test_meta_scan_backward_gives_input_shaped_gradients():
    step, x_shapes, rest_shapes = SCANS["wkv_scan"]
    xs = [_meta(*s).requires_grad_() for s in x_shapes]
    rest = [_meta(*s).requires_grad_() for s in rest_shapes]
    c = Census()
    with c:
        y, carry = tlayers.meta_scan(step, xs, rest, "wkv_scan")
        grads = torch.autograd.grad((y.sum() + carry.sum()), xs + rest)
    assert [g.shape for g in grads] == [t.shape for t in xs + rest]
    assert c.analyze()["while_trips"] == {"wkv_scan": x_shapes[0][1]}


def _jax_flops(fn, *specs) -> float:
    return hlo_census.analyze(jax.jit(fn).lower(*specs).compile().as_text())[
        "flops"]


def test_prefill_flops_equal_the_hlo_census():
    """qwen2 smoke's prefill with full attention: the same matrix
    products in both packages."""
    jc = jreg.get_config("qwen2-1.5b", smoke=True).replace(
        attention_impl="full")
    tc = treg.get_config("qwen2-1.5b", smoke=True).replace(
        attention_impl="full")
    B, S = 2, 96
    params = jax.eval_shape(lambda: japi.init_params(jax.random.PRNGKey(0),
                                                     jc))
    want = _jax_flops(lambda p, b: japi.prefill(p, b, jc), params,
                      {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)})
    got = _count(lambda: tapi.prefill(
        tapi.init_params(None, tc, META),
        {"tokens": _meta(B, S, dtype=torch.int32)}, tc))
    assert got["flops"] == want


def test_mlp_train_step_flops_equal_the_hlo_census():
    """The anomaly-mlp's spmd train step at C 4 × 32: the per-client
    forward and backward products in both packages, and the aggregation,
    which the JAX package's CPU oracle computes as a dot (``einsum
    "crl,c->rl"``) and the port's dry run as the masked_agg kernel, whose
    reckoned 2·C·n operations are that dot's FLOPs; the sign count is no
    product in either (its reckoned operations are left out)."""
    jc, tc = jreg.get_config("anomaly-mlp"), treg.get_config("anomaly-mlp")
    C, B = 4, 32
    state = jax.eval_shape(lambda: jfl.init_state(jax.random.PRNGKey(0), jc))
    want = _jax_flops(jfl.make_raw_step(jc, theta=0.65), state, {
        "x": jax.ShapeDtypeStruct((C, B, jc.num_features), jnp.float32),
        "y": jax.ShapeDtypeStruct((C, B), jnp.int32)})
    got = _count(tfl.make_raw_step(tc, theta=0.65),
                 tfl.init_state(None, tc, device=META),
                 {"x": _meta(C, B, tc.num_features),
                  "y": _meta(C, B, dtype=torch.int32)})
    assert got["kernel_launches"] == {"per_client_sign_align": 1,
                                      "masked_agg": 1}
    assert got["flops"] - got["flops_by_op"][
        "repro_torch::per_client_sign_align"] == want


COMBOS = [(a, s) for a in treg.ASSIGNED_ARCHS + ["anomaly-mlp"]
          for s in SHAPES]


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_model_flops_equal_the_jax_package(arch, shape):
    assert analysis.model_flops(treg.get_config(arch), SHAPES[shape]) == \
        janalysis.model_flops(jreg.get_config(arch), JSHAPES[shape])


def test_roofline_terms_use_the_h100_peaks(tmp_path):
    """The three terms over the H100's data-sheet peaks (bf16 989 TFLOP/s,
    HBM 3.35 TB/s, NVLink 450 GB/s each way), no TPU constant; rows round
    trip through the JSONL file."""
    assert (analysis.PEAK_FLOPS_BF16, analysis.HBM_BW, analysis.NVLINK_BW) \
        == (989e12, 3.35e12, 450e9)
    cfg, shape = treg.get_config("qwen2-1.5b"), SHAPES["prefill_32k"]
    census = {"flops": 989e12, "traffic_bytes": 6.7e12,
              "collective_bytes": 0.0, "op_counts": {"aten::mm": 3.0}}
    roof = analysis.analyze("qwen2-1.5b", shape, "1x1", 1, census, cfg,
                            memory_stats={"peak_bytes": 5})
    assert (roof.t_compute, roof.t_memory, roof.t_collective) == (1.0, 2.0,
                                                                  0.0)
    assert roof.dominant == "memory"
    assert math.isclose(roof.useful_ratio,
                        analysis.model_flops(cfg, shape) / 989e12)
    assert "qwen2-1.5b" in roof.as_row() and "-> memory" in roof.as_row()
    path = str(tmp_path / "rows.jsonl")
    analysis.save_jsonl(path, [roof, roof])
    assert analysis.load_jsonl(path) == [dataclasses.asdict(roof)] * 2
    assert [f.name for f in dataclasses.fields(analysis.Roofline)] == [
        f.name for f in dataclasses.fields(janalysis.Roofline)]
