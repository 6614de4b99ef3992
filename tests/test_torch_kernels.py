"""The port's arena kernels (plain versions, on the CPU) against the JAX
package: its jnp references and its Pallas kernels in interpret mode, on
the same numpy inputs.

Tolerances: sign-alignment counts are integers and must be equal. The
weighted sum is compared elementwise to rtol 1e-6 of Σ_c |w_c·u_c|, the
scale of the terms being summed: the two sides add the same products in
different orders (XLA's einsum against a client-by-client loop), and the
error of an f32 sum is bounded relative to that scale, not to the sum,
which may cancel to near zero. Where a zero-weight client's row holds
±Inf, both sides give NaN (0·Inf) at the same positions, and only there.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import anomaly_mlp as jcfg
from repro.kernels import arena as jarena
from repro.kernels import masked_agg as jma
from repro.kernels import ref as jref
from repro.kernels import sign_align as jsa
from repro.models import api as japi

from repro_torch.kernels import _build
from repro_torch.kernels import arena as tarena
from repro_torch.kernels import masked_agg as tma
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sign_align as tsa

SHAPES = [(1, 1), (5, 7), (16, 54)]
# masked_agg also at a chunk of 16 clients and its tails (C 1, 9, 17, 40)
# by one row and a ragged 257, and with ±Inf in a zero-weight client's row
AGG_CASES = [pytest.param(C, R, False, id=f"{C}-{R}") for C, R in SHAPES + [
    (C, R) for C in (1, 9, 17, 40) for R in (1, 257) if (C, R) != (1, 1)]
] + [pytest.param(16, 54, True, id="16-54-inf")]


def _inputs(C, R, seed=0):
    """Updates with +0/-0 slots and reference signs with zeros and the -2
    padding sentinel on the tail of the last row."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((C, R, 1024)).astype(np.float32)
    u[:, :, :16] = 0.0
    u[:, :, 16:32] = -0.0
    r = np.sign(rng.standard_normal((R, 1024))).astype(np.int8)
    r[:, 8:24] = 0
    r[-1, -200:] = -2
    u[:, -1, -200:] = 0.0
    w = rng.standard_normal(C).astype(np.float32)
    return u, r, w


def _sum_scale(u, w):
    return np.abs(u * w[:, None, None]).sum(axis=0)


@pytest.mark.parametrize("C,R", SHAPES)
def test_sign_align_matches_jax_exactly(C, R):
    u, r, _ = _inputs(C, R)
    got = tsa.per_client_sign_align(torch.from_numpy(u), torch.from_numpy(r))
    assert got.dtype == torch.float32 and got.shape == (C,)
    oracle = np.asarray(jref.per_client_sign_align(jnp.asarray(u),
                                                   jnp.asarray(r)))
    pallas = np.asarray(jsa.per_client_sign_align(jnp.asarray(u),
                                                  jnp.asarray(r)))
    np.testing.assert_array_equal(got.numpy(), oracle)
    np.testing.assert_array_equal(got.numpy(), pallas)


def _with_inf(u, w):
    """+Inf and -Inf in the row of client 1, whose weight is 0."""
    w[1] = 0.0
    u[1, 0, 5] = np.inf
    u[1, -1, 700] = -np.inf
    return u, w


@pytest.mark.parametrize("C,R,inf", AGG_CASES)
def test_masked_agg_matches_jax(C, R, inf):
    u, _, w = _inputs(C, R, seed=1)
    if inf:
        u, w = _with_inf(u, w)
    got = tma.masked_agg(torch.from_numpy(u), torch.from_numpy(w)).numpy()
    with np.errstate(invalid="ignore"):
        bound = 1e-6 * _sum_scale(u, w)
    assert np.isnan(got).sum() == (2 if inf else 0)
    for want in (np.asarray(jref.masked_agg(jnp.asarray(u), jnp.asarray(w))),
                 np.asarray(jma.masked_agg(jnp.asarray(u), jnp.asarray(w)))):
        assert got.shape == want.shape == (R, 1024)
        both_nan = np.isnan(got) & np.isnan(want)
        assert ((np.abs(got - want) <= bound) | both_nan).all()


def test_masked_agg_takes_zero_rows():
    """R = 0 passes the wrapper's checks: an empty (0, 1024) f32 result, as
    the jnp oracle gives (``chip_smoke.py`` holds the card's kernel to the
    same, with no fault)."""
    u, _, w = _inputs(16, 1, seed=2)
    u = u[:, :0]
    got = tma.masked_agg(torch.from_numpy(u), torch.from_numpy(w))
    want = np.asarray(jref.masked_agg(jnp.asarray(u), jnp.asarray(w)))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (0, 1024)


def test_sign_align_takes_zero_rows():
    """R = 0 passes the wrapper's checks: C zero counts in f32, as the jnp
    oracle gives (``chip_smoke.py`` holds the card's kernel to the same: it
    writes the zeros and loads nothing)."""
    u, r, _ = _inputs(3, 1, seed=2)
    u, r = u[:, :0], r[:0]
    got = tsa.per_client_sign_align(torch.from_numpy(u), torch.from_numpy(r))
    want = np.asarray(jref.per_client_sign_align(jnp.asarray(u),
                                                 jnp.asarray(r)))
    assert got.dtype == torch.float32 and got.tolist() == [0.0, 0.0, 0.0]
    np.testing.assert_array_equal(got.numpy(), want)


def past_int32_rows(seed: int, odd: bool, dtype=np.float32):
    """One row of updates with every finite sign case (±0, subnormals,
    -2 padding in the reference), its reference signs, and the matches m
    of the row, counted by numpy; m is odd or even as asked (slot 6's
    reference set to match or to miss)."""
    rng = np.random.default_rng(seed)
    row = rng.standard_normal(1024).astype(dtype)
    row[:6] = [0.0, -0.0, 1e-40, -1e-40, 0.0, -0.0]
    r = rng.integers(-2, 2, 1024).astype(np.int8)
    signs = np.sign(row.astype(np.float64)).astype(np.int8)
    if int(np.sum(signs == r)) % 2 != odd:
        r[6] = -2 if r[6] == signs[6] else signs[6]
    return row, r, int(np.sum(signs == r))


# (rows, whether R·m is exact in f32): n = R·1024 = 2^31 slots exactly,
# whose count R·m is a multiple of 2^21 (exact), and one row more with an
# odd m, an odd count past 2^24 that rounds
PAST_INT32 = [pytest.param(2 ** 21, True, id="2^31-slots-exact"),
              pytest.param(2 ** 21 + 1, False, id="2^31+1024-slots-rounds")]


@pytest.mark.parametrize("R,exact", PAST_INT32)
def test_sign_align_refuses_counts_past_int32(R, exact):
    """Counts past 2^31 slots are exact (the test keeps the name it had
    while the wrappers refused them): the plain version counts
    a (1, R, 1024) broadcast view of one row (nothing of that size is
    allocated) exactly, R·m for m matches a row, converted to f32 once
    (round to nearest even, as numpy's int -> float32), chunk by chunk of
    rows in int64; the exact case against (R, 1024) reference signs, the
    rounding one against P = 1 references (1, R, 1024)."""
    row, r, m = past_int32_rows(5, odd=not exact)
    u = torch.from_numpy(row).expand(1, R, 1024)
    rr = torch.from_numpy(r).expand(R, 1024)
    want = np.array([R * m], dtype=np.float32)
    assert (float(want[0]) == R * m) == exact
    got = tsa.per_client_sign_align(u, rr if exact else rr[None])
    assert got.dtype == torch.float32 and got.shape == (1,)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def test_sign_is_zero_on_signed_zeros_and_never_matches_sentinel():
    x = torch.tensor([0.0, -0.0, 1e-30, -1e-30, 3.0])
    assert tref.sign(x).tolist() == [0, 0, 1, -1, 1]
    u = torch.zeros((2, 1, 1024))
    r = torch.full((1, 1024), -2, dtype=torch.int8)
    assert tsa.per_client_sign_align(u, r).tolist() == [0.0, 0.0]


def _function_body(text, name):
    """The body of the first definition of function ``name``, braces
    included."""
    at = re.search(r"\b" + name + r"\([^;{]*\)\s*\{", text)
    assert at, f"no definition of {name}"
    depth = 0
    for j in range(at.end() - 1, len(text)):
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            return text[at.end() - 1:j + 1]
    raise AssertionError(f"{name}: unbalanced braces")


def test_sign_kernel_waits_on_the_cluster_before_remote_shared_memory():
    """Guards the CUDA C++ Programming Guide's rule for distributed shared
    memory: a block may touch another block's shared memory only once a
    cluster barrier it has waited on guarantees that block has started.
    ``sign_align_kernel`` and the chunked count's ``sign_align_chunk_kernel``
    count through one inlined body, ``cluster_count``, and touch no remote
    shared memory of their own; inside that body a wait (``cluster.sync()``,
    ``barrier.cluster.wait`` or a helper that executes it) must come
    before the first ``map_shared_rank``, and a split barrier's arrive
    before its wait."""
    text = re.sub(r"//[^\n]*", "", (_build.CSRC / "sign_align.cu").read_text())
    helpers = re.findall(r"__device__[^(;]*\b(\w+)\(\)\s*\{", text)

    def calls(ptx, *also):
        names = [rf"\b{h}\(\)" for h in helpers
                 if ptx in _function_body(text, h)]
        return re.compile("|".join([re.escape(ptx), *also, *names]))

    for kernel in ("sign_align_kernel", "sign_align_chunk_kernel"):
        body = _function_body(text, kernel)
        assert re.search(r"\bcluster_count\(", body), (
            f"{kernel} does not count through cluster_count")
        assert "map_shared_rank" not in body, kernel
    body = _function_body(text, "cluster_count")
    remote = body.index("map_shared_rank")
    wait = calls("barrier.cluster.wait", r"\bcluster\.sync\(\)").search(body)
    assert wait and wait.start() < remote, (
        "cluster_count: map_shared_rank comes before any cluster barrier "
        "wait")
    arrive = calls("barrier.cluster.arrive").search(body)
    if arrive:
        assert arrive.start() < wait.start(), (
            "cluster_count: the wait precedes its arrive")


@pytest.mark.parametrize("bad", ["dtype", "shape", "lane"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    u, r, w = _inputs(2, 3)
    u, r, w = torch.from_numpy(u), torch.from_numpy(r), torch.from_numpy(w)
    if bad == "dtype":
        args_sa, args_ma = (u.double(), r), (u, w.double())
    elif bad == "shape":
        args_sa, args_ma = (u, r[:2]), (u, w[:1])
    else:
        args_sa, args_ma = (u[..., :512], r[..., :512]), (u[..., :512], w)
    with pytest.raises((TypeError, ValueError)):
        tsa.per_client_sign_align(*args_sa)
    with pytest.raises((TypeError, ValueError)):
        tma.masked_agg(*args_ma)


def _templates():
    return {"anomaly-mlp": jcfg.CONFIG, "anomaly-mlp-smoke": jcfg.SMOKE}


@pytest.mark.parametrize("name", sorted(_templates()))
def test_arena_matches_jax(name):
    cfg = _templates()[name]
    jparams = japi.init_params(jax.random.PRNGKey(3), cfg)
    np_params = {k: np.array(v) for k, v in jparams.items()}
    ja = jarena.ParamArena(jparams)
    ta = tarena.ParamArena(np_params)
    assert (ta.n, ta.rows, ta.pad) == (ja.n, ja.rows, ja.pad)
    if name == "anomaly-mlp":
        assert (ta.n, ta.rows) == (54602, 54)
    tparams = {k: torch.from_numpy(v) for k, v in np_params.items()}
    mat = ta.pack(tparams)
    np.testing.assert_array_equal(mat.numpy(), np.asarray(ja.pack(jparams)))
    for k, v in ta.unpack(mat).items():
        np.testing.assert_array_equal(v.numpy(), np_params[k])
    np.testing.assert_array_equal(ta.valid_mask(), ja.valid_mask())

    rng = np.random.default_rng(4)
    cohort = {k: np.stack([v, v * 2.0, -v]) for k, v in np_params.items()}
    cmat = ta.pack_cohort({k: torch.from_numpy(v) for k, v in cohort.items()})
    np.testing.assert_array_equal(
        cmat.numpy(),
        np.asarray(ja.pack_cohort({k: jnp.asarray(v)
                                   for k, v in cohort.items()})))
    for k, v in ta.unpack_cohort(cmat).items():
        np.testing.assert_array_equal(v.numpy(), cohort[k])

    new = np.asarray(mat).copy()
    new += rng.standard_normal(new.shape).astype(np.float32)
    new[0, :7] = mat.numpy()[0, :7]            # zero movement -> sign 0
    got = ta.sign_ref(torch.from_numpy(new), mat)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ja.sign_ref(jnp.asarray(new),
                                            jnp.asarray(mat.numpy()))))
