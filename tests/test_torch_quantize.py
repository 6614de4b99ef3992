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
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import anomaly_mlp as jcfg
from repro.core import compression as jcomp
from repro.kernels import arena as jarena
from repro.kernels import ops as jops
from repro.kernels import quantize as jq
from repro.kernels import ref as jref
from repro.models import api as japi

from repro_torch.core import compression as tcomp
from repro_torch.kernels import arena as tarena
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quantize as tq

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
    got = tcomp.compress_cohort(torch.from_numpy(deltas), torch.from_numpy(err))
    want = jcomp.compress_cohort(jnp.asarray(deltas), jnp.asarray(err))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


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


def _bad_calls():
    x = torch.zeros((3, LANE))
    q = torch.zeros((3, LANE), dtype=torch.int8)
    s = torch.ones((3, 1))
    return {
        "x dtype": (tq.quantize_q8, (x.double(),)),
        "x 1-D": (tq.quantize_q8, (x[0],)),
        "x lane": (tq.quantize_q8, (x[:, :512],)),
        "x no rows": (tq.quantize_q8, (x[:0],)),
        "x device": (tq.quantize_q8, (x.to("meta"),)),
        "q dtype": (tq.dequantize_q8, (q.to(torch.int16), s)),
        "q lane": (tq.dequantize_q8, (q[:, :512], s)),
        "scale shape": (tq.dequantize_q8, (q, s[:, 0])),
        "scale rows": (tq.dequantize_q8, (q, s[:2])),
        "scale dtype": (tq.dequantize_q8, (q, s.double())),
        "scale device": (tq.dequantize_q8, (q, s.to("meta"))),
        "q device": (tq.dequantize_q8, (q.to("meta"), s.to("meta"))),
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
