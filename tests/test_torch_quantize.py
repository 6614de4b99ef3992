"""The port's int8 wire codec (plain versions, on the CPU) and its error
feedback against the JAX package, on the same numpy inputs: the codes,
scales and dequantized values of ``quantize_q8`` / ``dequantize_q8``, the
dict codec of ``kernels/ops.py`` and ``core/compression.py``.

Tolerances: none. Quantization is elementwise work around one reduction,
a max, so the port is bit-equal to the JAX package's jnp oracle
(``repro.kernels.ref``): codes, scales, dequantized values and residuals.
One difference is the JAX package's own: where XLA compiles the division
by the constant 127 (the Pallas kernel, in interpret mode too, and any
jitted caller), it rewrites it as a product with the f32 reciprocal, so
those scales are max(amax, 1e-12)·fl(1/127), one ulp off the true quotient
in some rows. The tests state that rewrite exactly instead of allowing an
ulp; the codes agree on these inputs all the same.
"""
import importlib.util
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import anomaly_mlp as jcfg
from repro.core import compression as jcomp
from repro.kernels import arena as jarena
from repro.kernels import ops as jops
from repro.kernels import quantize as jq
from repro.kernels import ref as jref
from repro.models import api as japi

from repro_torch.core import compression as tcomp
from repro_torch.kernels import _build
from repro_torch.kernels import arena as tarena
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quantize as tq
from repro_torch.kernels import ref as tref

LANE = 1024


def _rows(R, seed=0):
    """Rows of widely spread magnitudes, then the special rows: all zero,
    ±0, exact ties (amax 127 so the scale is exactly 1, and ±(k + 0.5)),
    magnitudes near 1e30 and a subnormal row."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((R, LANE))
         * rng.lognormal(0.0, 3.0, (R, 1))).astype(np.float32)
    x[0] = 0.0
    x[1, ::2], x[1, 1::2] = 0.0, -0.0
    x[2] = np.arange(LANE) % 254 - 126.5
    x[2, 0], x[2, 1] = 127.0, -127.0
    x[3] = rng.standard_normal(LANE) * 1e30
    x[4] = rng.standard_normal(LANE) * 1e-40
    return x


def _xla_scale(x):
    """The scale as XLA's compiled code computes it (see the docstring)."""
    amax = np.maximum(np.abs(x).max(axis=-1, keepdims=True), np.float32(1e-12))
    return amax * np.float32(1.0 / 127.0)


def _params(seed=3):
    p = japi.init_params(jax.random.PRNGKey(seed), jcfg.CONFIG)
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v) + 1e-3 * rng.standard_normal(v.shape))
            .astype(np.float32) for k, v in p.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(np.asarray(v)) for k, v in tree.items()}


@pytest.mark.parametrize("R", [54, 35, 864])
def test_quantize_matches_jax(R):
    x = _rows(R, seed=R)
    q, s = tq.quantize_q8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and q.shape == (R, LANE)
    assert s.dtype == torch.float32 and s.shape == (R, 1)
    oq, os_ = jref.quantize_q8(jnp.asarray(x))
    pq, ps = jq.quantize_q8(jnp.asarray(x), interpret=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(oq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(os_))
    np.testing.assert_array_equal(q.numpy(), np.asarray(pq))
    np.testing.assert_array_equal(np.asarray(ps), _xla_scale(x))
    # the special rows: zero codes, scale exactly 1 and half-even ties
    assert not q[:2].any() and not q[4].any()
    assert s[2, 0] == 1.0
    np.testing.assert_array_equal(q[2].numpy(), np.round(x[2]))
    d = tq.dequantize_q8(q, s).numpy()
    for want in (jref.dequantize_q8(jnp.asarray(q.numpy()), jnp.asarray(s.numpy())),
                 jq.dequantize_q8(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                                  interpret=True)):
        np.testing.assert_array_equal(d, np.asarray(want))


def test_quantize_tree_matches_jax():
    tree = _params()
    q, s, n = tops.quantize_tree(_t(tree))
    mat, jn = jops.flatten_to_lanes(_j(tree))
    np.testing.assert_array_equal(tops.flatten_to_lanes(_t(tree))[0].numpy(),
                                  np.asarray(mat))
    jq_, js, jn2 = jops.quantize_tree(_j(tree), interpret=True)
    assert n == jn == jn2 == 54602
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(np.asarray(js), _xla_scale(np.asarray(mat)))
    np.testing.assert_array_equal(s.numpy(),
                                  np.asarray(jref.quantize_q8(mat)[1]))
    got = tops.dequantize_tree(q, s, _t(tree))
    want = jops.dequantize_tree(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                                _j(tree), interpret=True)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].shape == tuple(want[k].shape)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_compress_cohort_matches_jax():
    rng = np.random.default_rng(5)
    deltas = (1e-2 * rng.standard_normal((4, 54, LANE))).astype(np.float32)
    err = (1e-4 * rng.standard_normal((4, 54, LANE))).astype(np.float32)
    got = tcomp.compress_cohort(torch.from_numpy(deltas),
                                torch.from_numpy(err))
    want = jcomp.compress_cohort(jnp.asarray(deltas), jnp.asarray(err))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _cohort(C, R, e_kind, seed):
    """(deltas, err) (C, R, LANE) f32: every client's rows from ``_rows``
    (the special rows included), and err zero or random at a thousandth
    of each row's largest |delta|."""
    deltas = np.stack([_rows(R, seed=seed + c) for c in range(C)])
    if e_kind == "zero":
        return deltas, np.zeros_like(deltas)
    rng = np.random.default_rng(seed)
    err = (rng.standard_normal(deltas.shape)
           * np.abs(deltas).max(axis=-1, keepdims=True) * 1e-3)
    return deltas, err.astype(np.float32)


@pytest.mark.parametrize("e_kind", ["zero", "random"])
def test_compress_cohort_is_the_four_op_composition(e_kind):
    """The fused round trip's plain version is, bit for bit, the add, the
    codec's two halves and the subtract that the cohort paths ran before
    it was fused, on the special rows too."""
    deltas, err = _cohort(4, 54, e_kind, seed=11)
    got = tcomp.compress_cohort(torch.from_numpy(deltas),
                                torch.from_numpy(err))
    corrected = torch.from_numpy(deltas) + torch.from_numpy(err)
    q, s = tref.quantize_q8(corrected.reshape(-1, LANE))
    restored = tref.dequantize_q8(q, s).reshape(corrected.shape)
    for g, w in zip(got, (restored, corrected - restored)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g.view(torch.int32).numpy(),
                                      w.view(torch.int32).numpy())
    if e_kind == "zero":
        # client 0's special rows: zero rows restore to zero, the tie row
        # (scale exactly 1) rounds half to even and carries the halves
        r, e = got[0][0].numpy(), got[1][0].numpy()
        assert not r[:2].any() and not e[:2].any()
        np.testing.assert_array_equal(r[2], np.round(deltas[0, 2]))
        np.testing.assert_array_equal(e[2], deltas[0, 2] - np.round(
            deltas[0, 2]))


@pytest.mark.parametrize("e_kind", ["zero", "random"])
def test_compress_cohort_matches_jax_on_special_rows(e_kind):
    """Equal to the JAX package on every row but the subnormal ones, where
    XLA on the CPU flushes subnormals: its residual there is 0, where the
    port carries d + e exactly (the codes are 0 on both sides)."""
    deltas, err = _cohort(3, 35, e_kind, seed=21)
    got = tcomp.compress_cohort(torch.from_numpy(deltas),
                                torch.from_numpy(err))
    want = jcomp.compress_cohort(jnp.asarray(deltas), jnp.asarray(err))
    sub = np.zeros(deltas.shape[:2], dtype=bool)
    sub[:, 4] = True                               # _rows' subnormal row
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy()[~sub], np.asarray(w)[~sub])
    assert not got[0].numpy()[sub].any() and not np.asarray(want[0])[sub].any()
    np.testing.assert_array_equal(np.asarray(want[1])[sub], 0.0)
    np.testing.assert_array_equal(got[1].numpy()[sub], (deltas + err)[sub])


def test_round_trip_refuses_with_the_codecs_messages():
    """``ef_round_trip`` refuses no rows, a wrong width and a wrong dtype
    in either input as ``quantize_q8`` refuses them, naming the input."""
    x = torch.zeros((3, LANE))
    cases = [(x[:0], ValueError, [("d", (x[:0], x[:0]))])]
    for bad, exc in ((x[:, :512], ValueError), (x.double(), TypeError)):
        cases.append((bad, exc, [("d", (bad, x)), ("e", (x, bad))]))
    for bad, exc, calls in cases:
        with pytest.raises(exc) as want:
            tq.quantize_q8(bad)
        for name, args in calls:
            with pytest.raises(exc) as got:
                tq.ef_round_trip(*args)
            assert str(got.value) == str(want.value).replace(
                "x ", f"{name} ", 1).replace("expected x", f"expected {name}")
    with pytest.raises(ValueError, match=r"e must have d's shape \(3, 1024\)"):
        tq.ef_round_trip(x, x[:2])


def test_compress_update_matches_jax(monkeypatch):
    """JAX's dict codec runs its Pallas kernel; routed through the jnp
    oracle instead, it must equal the port bit for bit."""
    monkeypatch.setitem(jops._KERNELS, "quantize_q8", (
        lambda x, interpret: jref.quantize_q8(x), None))
    monkeypatch.setitem(jops._KERNELS, "dequantize_q8", (
        lambda q, s, interpret: jref.dequantize_q8(q, s), None))
    update = _params(seed=7)
    rng = np.random.default_rng(8)
    error = {k: (1e-4 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in update.items()}
    q, s, n, new_err = tcomp.compress_update(_t(update), _t(error))
    jq_, js, jn, jnew_err = jcomp.compress_update(_j(update), _j(error))
    assert n == jn
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    for k in update:
        np.testing.assert_array_equal(new_err[k].numpy(), np.asarray(jnew_err[k]))
    got = tcomp.decompress_update(q, s, _t(update))
    want = jcomp.decompress_update(jq_, js, _j(update))
    for k in update:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_wire_bytes_and_buffers_match_jax():
    tree = _params()
    ta = tarena.ParamArena(tree)
    ja = jarena.ParamArena(_j(tree))
    q, s, _n = tops.quantize_tree(_t(tree))
    assert (tcomp.arena_wire_bytes(ta) == tcomp.transport_bytes(q, s)
            == jcomp.arena_wire_bytes(ja) == 54 * 1024 + 4 * 54)
    assert tcomp.compression_ratio(_t(tree)) == jcomp.compression_ratio(
        _j(tree))
    ef = tcomp.init_error_arena(11, ta, "cpu")
    assert ef.shape == tuple(jcomp.init_error_arena(11, ja).shape)
    assert ef.dtype == torch.float32 and not ef.any()
    state = tcomp.init_error_state(_t(tree))
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: v.shape for k, v in tree.items()}
    assert not any(v.any() for v in state.values())


def _on_xpu(t):
    """A fake tensor of ``t``'s shape and dtype on an XPU, a device with
    neither a kernel nor a plain version of the port's (no data)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return torch.empty(t.shape, dtype=t.dtype, device="xpu")


def _bad_calls():
    x = torch.zeros((3, LANE))
    q = torch.zeros((3, LANE), dtype=torch.int8)
    s = torch.ones((3, 1))
    return {
        "x dtype": (tq.quantize_q8, (x.double(),)),
        "x 1-D": (tq.quantize_q8, (x[0],)),
        "x lane": (tq.quantize_q8, (x[:, :512],)),
        "x no rows": (tq.quantize_q8, (x[:0],)),
        # a device with no kernel (meta tensors take the shape-only call)
        "x device": (tq.quantize_q8, (_on_xpu(x),)),
        "q dtype": (tq.dequantize_q8, (q.to(torch.int16), s)),
        "q lane": (tq.dequantize_q8, (q[:, :512], s)),
        "scale shape": (tq.dequantize_q8, (q, s[:, 0])),
        "scale rows": (tq.dequantize_q8, (q, s[:2])),
        "scale dtype": (tq.dequantize_q8, (q, s.double())),
        "scale device": (tq.dequantize_q8, (q, s.to("meta"))),
        "q device": (tq.dequantize_q8, (_on_xpu(q), _on_xpu(s))),
        "d dtype": (tq.ef_round_trip, (x.double(), x)),
        "e dtype": (tq.ef_round_trip, (x, x.to(torch.bfloat16))),
        "d no rows": (tq.ef_round_trip, (x[:0], x[:0])),
        "e rows": (tq.ef_round_trip, (x, x[:2])),
        "e lane": (tq.ef_round_trip, (x, x[:, :512])),
        "e device": (tq.ef_round_trip, (x, x.to("meta"))),
    }


@pytest.mark.parametrize("bad", sorted(_bad_calls()))
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    fn, args = _bad_calls()[bad]
    with pytest.raises((TypeError, ValueError)):
        fn(*args)


def test_cpu_calls_launch_no_kernel():
    before = dict(tq.launches)
    q, s = tq.quantize_q8(torch.ones((2, LANE)))
    tq.dequantize_q8(q, s)
    assert tq.launches == before


def test_cpu_round_trip_launches_no_kernel():
    before = dict(tq.launches)
    tcomp.compress_cohort(torch.ones((2, 3, LANE)), torch.zeros((2, 3, LANE)))
    tq.ef_round_trip(torch.ones((2, LANE)), torch.ones((2, LANE)))
    assert tq.launches == before


def test_card_cases_straddle_the_codec_launch_switch():
    """``csrc/quantize.cu`` launches ``quantize_q8`` and ``ef_round_trip``
    with 512 threads a row up to ``kWideRows`` rows and 256 beyond, so
    ``chip_smoke.py`` must hold both launch shapes to the plain version
    (at the switch's last and first row counts among its cases) and time
    both (``CODEC_SIZES``), or a branch would go unchecked on the card."""
    text = (_build.CSRC / "quantize.cu").read_text()
    wide = int(re.search(r"constexpr long long kWideRows = (\d+);",
                         text).group(1))
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert {wide, wide + 1} <= set(smoke.CODEC_CHECK_ROWS)
    assert min(smoke.CODEC_SIZES) <= wide < max(smoke.CODEC_SIZES)
