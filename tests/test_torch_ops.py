"""The port's ``fused_update`` and ``sign_align_counts`` (plain versions, on
the CPU) and its kernel-ops API (``repro_torch.kernels.ops``) against the
JAX package: its Pallas kernels in interpret mode, its jnp references and
its ``repro.kernels.ops`` wrappers, on the same numpy inputs. The CUDA
kernels are held to the same plain versions on the card by
``chip_smoke.py``.

Tolerances, as ``chip_smoke.py`` states them for the card (where it adds
the f32 terms to the bf16 one: at its C of 257 and 300 the kernel's fmaf
sums and the plain version's products and sums can round to bf16 values
more than one bf16 ulp apart):
  * sign-alignment counts are integers and must be equal;
  * ``fused_update`` in f32 within 1e-6 of Σ_c |w_c·u_c| (the scale of the
    summands: both sides add the same products in other orders) plus one
    ulp of the larger of |p| and |result| (the final subtraction rounds
    once more, half an ulp on each side; the result may lie in the binade
    above p's); in bf16 within one bf16 ulp of the result (the f32 value
    is rounded once to bf16, and an f32 difference in its last bits can
    fall on either side of a rounding boundary); with ±Inf in a
    zero-weight client's row both sides give NaN (0·Inf) at the same
    positions, and only there;
  * ratios are a count divided by n in f32 and must be equal; weighted
    sums within 1e-6 of Σ_c |w_c·u_c|, as above.
"""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels import arena as jarena
from repro.kernels import masked_agg as jma
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import sign_align as jsa

from repro_torch.kernels import arena as tarena
from repro_torch.kernels import masked_agg as tma
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sign_align as tsa

LANE = 1024
ROWS = [8, 16, 40]                        # tests/test_kernels.py's SHAPES
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _pair(x: np.ndarray, dtype: str):
    """The same f32 array as a jnp and a torch array of ``dtype`` (both
    round to bf16 to nearest even, so the bits agree)."""
    _, jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _as_f32(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits)."""
    _, e = np.frexp(np.abs(x).astype(np.float64))
    return np.ldexp(1.0, e - 8)


# ---------------------------------------------------------------------------
# sign_align_counts
# ---------------------------------------------------------------------------

def _count_inputs(R: int, seed: int):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((R, LANE)).astype(np.float32)
    g[:, :16] = 0.0
    g[:, 16:32] = -0.0
    g[-1, -300:] = 0.0                  # padding: zero updates
    r = np.sign(rng.standard_normal((R, LANE))).astype(np.int8)
    r[:, 40:60] = 0
    r[-1, -300:] = -2                   # padding sentinel
    return g, r


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("R", ROWS)
def test_sign_align_counts_matches_pallas_and_oracle(R, dtype):
    g, r = _count_inputs(R, seed=R)
    jg, tg = _pair(g, dtype)
    got = tsa.sign_align_counts(tg, torch.from_numpy(r))
    assert got.shape == () and got.dtype == torch.float32
    pallas = jsa.sign_align_counts(jg, jnp.asarray(r), interpret=True)
    oracle = jref.sign_align_counts(jg, jnp.asarray(r))
    assert float(got) == float(pallas) == float(oracle)
    assert float(got) == float(tref.sign_align_counts(tg, torch.from_numpy(r)))


# ---------------------------------------------------------------------------
# fused_update
# ---------------------------------------------------------------------------

def _fused_inputs(C: int, R: int, seed: int):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((R, LANE)).astype(np.float32)
    u = rng.standard_normal((C, R, LANE)).astype(np.float32)
    w = (rng.random(C).astype(np.float32) * np.float32(0.01))
    if C > 1:
        w[1] = 0.0                      # a filtered client
    return p, u, w


def _fused_excess(got, want, p, u, w, dtype) -> float:
    """Largest excess of |got − want| over the tolerance (≤ 0 passes)."""
    got, want = _as_f32(got), _as_f32(want)
    both_nan = np.isnan(got) & np.isnan(want)
    with np.errstate(invalid="ignore"):
        gap = np.abs(got.astype(np.float64) - want)
        if dtype == "bf16":
            excess = gap - _bf16_ulp(want)
        else:
            scale = np.abs(u * w[:, None, None]).sum(axis=0)
            ulp = np.spacing(np.maximum(np.abs(p), np.abs(want)))
            excess = gap - 1e-6 * scale - ulp
    return float(np.where(both_nan, -np.inf, excess).max())


# also at a chunk of 16 clients and its tails (C 1, 9, 17, 40) by one row
# and a ragged 257, and with ±Inf in a zero-weight client's row
FUSED_CASES = [pytest.param(C, R, False, id=f"{C}-{R}") for C, R in [
    (4, 16), (1, 8), (8, 40)] + [(C, R) for C in (1, 9, 17, 40)
                                 for R in (1, 257)]] + [
    pytest.param(10, 54, True, id="10-54-inf")]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("C,R,inf", FUSED_CASES)
def test_fused_update_matches_pallas_and_oracle(C, R, inf, dtype):
    p, u, w = _fused_inputs(C, R, seed=C * R)
    if inf:                             # w[1] is 0: a filtered client
        u[1, 0, 5], u[1, -1, 700] = np.inf, -np.inf
    jp, tp = _pair(p, dtype)
    got = tma.fused_update(tp, torch.from_numpy(u), torch.from_numpy(w))
    assert got.dtype == tp.dtype and got.shape == tp.shape
    pallas = jma.fused_update(jp, jnp.asarray(u), jnp.asarray(w),
                              interpret=True)
    oracle = jref.fused_update(jp, jnp.asarray(u), jnp.asarray(w))
    p32 = _as_f32(tp)
    assert np.isnan(_as_f32(got)).sum() == (2 if inf else 0)
    for want in (pallas, oracle):
        assert _fused_excess(got, want, p32, u, w, dtype) <= 0.0
    # the plain version is p − masked_agg, rounded once into p's dtype
    again = (tp.float() - tref.masked_agg(torch.from_numpy(u),
                                          torch.from_numpy(w))).to(tp.dtype)
    torch.testing.assert_close(got, again, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_update_takes_zero_rows(dtype):
    """R = 0 passes the wrapper's checks: an empty result in p's dtype, as
    the jnp oracle gives (``chip_smoke.py`` holds the card's kernel to the
    same, with no fault)."""
    p, u, w = _fused_inputs(10, 1, seed=2)
    p, u = p[:0], u[:, :0]
    jp, tp = _pair(p, dtype)
    got = tma.fused_update(tp, torch.from_numpy(u), torch.from_numpy(w))
    want = jref.fused_update(jp, jnp.asarray(u), jnp.asarray(w))
    assert got.dtype == tp.dtype
    assert tuple(got.shape) == tuple(want.shape) == (0, LANE)
    assert want.dtype == jp.dtype


def test_fused_update_does_not_touch_p():
    p, u, w = _fused_inputs(3, 4, seed=1)
    tp = torch.from_numpy(p.copy())
    tma.fused_update(tp, torch.from_numpy(u), torch.from_numpy(w))
    assert np.array_equal(tp.numpy(), p)


@pytest.mark.parametrize("call,args,err", [
    ("counts", dict(g=(8, 1000)), ValueError),
    ("counts", dict(g_dtype=torch.float16), TypeError),
    ("counts", dict(r_dtype=torch.int32), TypeError),
    ("fused", dict(p=(7, LANE)), ValueError),
    ("fused", dict(p_dtype=torch.float16), TypeError),
    ("fused", dict(w=(3,)), ValueError),
])
def test_wrappers_check_their_arguments(call, args, err):
    if call == "counts":
        g = torch.zeros(args.get("g", (8, LANE)),
                        dtype=args.get("g_dtype", torch.float32))
        r = torch.zeros((8, LANE), dtype=args.get("r_dtype", torch.int8))
        with pytest.raises(err):
            tsa.sign_align_counts(g, r)
    else:
        p = torch.zeros(args.get("p", (8, LANE)),
                        dtype=args.get("p_dtype", torch.float32))
        u = torch.zeros((2, 8, LANE))
        w = torch.zeros(args.get("w", (2,)))
        with pytest.raises(err):
            tma.fused_update(p, u, w)


# (rows, whether the count is exact in f32), as in test_torch_kernels.py
PAST_INT32 = [pytest.param(2 ** 21, True, id="2^31-slots-exact"),
              pytest.param(2 ** 21 + 1, False, id="2^31+1024-slots-rounds")]


@pytest.mark.parametrize("R,exact", PAST_INT32)
def test_sign_align_counts_refuses_counts_past_int32(R, exact):
    """Counts past 2^31 slots are exact (the test keeps the name it had
    while the wrapper refused them): the plain
    ``sign_align_counts`` counts a bf16 (R, 1024) broadcast view of one row
    (nothing of that size is allocated) exactly, R·m for m matches a row
    (an even m at 2^31 slots, exact in f32; an odd m a row more, which
    rounds), converted to f32 once as numpy's int -> float32 rounds."""
    rng = np.random.default_rng(6)
    row = torch.from_numpy(rng.standard_normal(LANE).astype(np.float32))
    row[:4] = torch.tensor([0.0, -0.0, 1e-40, -1e-40])
    row = row.to(torch.bfloat16)
    r = torch.from_numpy(rng.integers(-2, 2, LANE).astype(np.int8))
    signs = torch.sign(row.float()).to(torch.int8)
    if int((signs == r).sum()) % 2 == exact:
        r[4] = -2 if r[4] == signs[4] else signs[4]
    m = int((signs == r).sum())
    want = np.array(R * m, dtype=np.float32)
    assert (float(want) == R * m) == exact
    got = tsa.sign_align_counts(row.expand(R, LANE), r.expand(R, LANE))
    assert got.dtype == torch.float32 and got.shape == ()
    assert got.numpy().view(np.int32) == want.view(np.int32)


def test_cpu_tensors_launch_no_kernel():
    before = (dict(tsa.launches), dict(tma.launches))
    g, r = _count_inputs(8, seed=3)
    tsa.sign_align_counts(torch.from_numpy(g), torch.from_numpy(r))
    p, u, w = _fused_inputs(2, 8, seed=3)
    tma.fused_update(*(torch.from_numpy(a) for a in (p, u, w)))
    assert (dict(tsa.launches), dict(tma.launches)) == before


# ---------------------------------------------------------------------------
# the arena's spmd helpers
# ---------------------------------------------------------------------------

def _tree(seed: int):
    """A parameter dict of three leaves, 1,237 values: two arena rows."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((40, 30)).astype(np.float32),
            "b": rng.standard_normal(30).astype(np.float32),
            "v": rng.standard_normal(7).astype(np.float32)}


def test_arena_pack_signs_and_unpack_match_jax():
    tree = _tree(0)
    signs = {k: np.sign(v).astype(np.int8) for k, v in tree.items()}
    ja = jarena.ParamArena({k: jnp.asarray(v) for k, v in tree.items()})
    ta = tarena.ParamArena({k: torch.from_numpy(v) for k, v in tree.items()})
    got = ta.pack_signs({k: torch.from_numpy(v) for k, v in signs.items()})
    want = ja.pack_signs({k: jnp.asarray(v) for k, v in signs.items()})
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), tops.ref_sign_lanes(
            {k: torch.from_numpy(v) for k, v in signs.items()}).numpy())
    mat = ta.pack({k: torch.from_numpy(v) for k, v in tree.items()})
    out = ta.unpack(mat, dtype=torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for v in out.values())
    back = ta.unpack(mat)
    for k, v in tree.items():
        assert back[k].dtype == torch.float32
        np.testing.assert_array_equal(back[k].numpy(), v)


@pytest.mark.parametrize("C,R", [(10, 54), (4, 3)])
def test_weighted_sum_bf16_is_the_jax_oracle_bit_for_bit(C, R):
    """On the CPU the bf16 aggregation is the JAX oracle's arithmetic:
    one einsum over bf16-rounded inputs, rounded once."""
    rng = np.random.default_rng(C + R)
    u = rng.standard_normal((C, R, LANE)).astype(np.float32)
    mask = (rng.random(C) > 0.3).astype(np.float32)
    mask[0] = 1.0
    w = mask / np.float32(max(mask.sum(), 1e-9))
    got = tarena.weighted_sum(torch.from_numpy(u), torch.from_numpy(w),
                              compute_dtype=torch.bfloat16)
    want = jarena.weighted_sum(jnp.asarray(u), jnp.asarray(w),
                               compute_dtype=jnp.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    f32 = tarena.weighted_sum(torch.from_numpy(u), torch.from_numpy(w))
    assert torch.equal(f32, tref.masked_agg(torch.from_numpy(u),
                                            torch.from_numpy(w)))
    p = rng.standard_normal((R, LANE)).astype(np.float32)
    assert torch.equal(
        tarena.fused_apply(torch.from_numpy(p), torch.from_numpy(u),
                           torch.from_numpy(w)),
        tref.fused_update(torch.from_numpy(p), torch.from_numpy(u),
                          torch.from_numpy(w)))


# ---------------------------------------------------------------------------
# the ops wrappers against repro.kernels.ops
# ---------------------------------------------------------------------------

def _stacked(C: int, seed: int):
    trees = [_tree(seed * 100 + i) for i in range(C)]
    return {k: np.stack([t[k] for t in trees]) for k in trees[0]}


def _both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in tree.items()})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ops_ratios_match_jax(seed):
    upd = _tree(seed)
    ref_sign = {k: np.sign(v * 0.7 + 0.05).astype(np.int8)
                for k, v in _tree(seed + 50).items()}
    ref_sign["v"][:3] = 0
    (ju, tu), (jr, tr) = _both(upd), _both(ref_sign)
    got = tops.sign_align_ratio(tu, tr)
    assert got.shape == () and got.dtype == torch.float32
    assert float(got) == float(jops.sign_align_ratio(ju, jr))
    C = 5
    (js, ts) = _both(_stacked(C, seed))
    got = tops.per_client_sign_align_ratio(ts, tr)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.per_client_sign_align_ratio(js, jr)))


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ops_aggregation_matches_jax(seed, weights):
    C = 6
    stacked = _stacked(C, seed)
    rng = np.random.default_rng(seed)
    mask = (rng.random(C) > 0.4).astype(np.float32)
    mask[0] = 1.0
    wts = rng.random(C).astype(np.float32) if weights else None
    js, ts = _both(stacked)
    jw = None if wts is None else jnp.asarray(wts)
    tw = None if wts is None else torch.from_numpy(wts)
    eff = mask * (wts if wts is not None else 1.0)
    eff = eff / max(eff.sum(), 1e-9)
    scale = {k: np.abs(v * eff.reshape((C,) + (1,) * (v.ndim - 1))).sum(0)
             for k, v in stacked.items()}

    got = tops.masked_aggregate(ts, torch.from_numpy(mask), tw)
    want = jops.masked_aggregate(js, jnp.asarray(mask), jw)
    for k in stacked:
        assert got[k].dtype == torch.float32
        gap = np.abs(got[k].numpy() - np.asarray(want[k]))
        assert (gap <= 1e-6 * scale[k]).all(), k

    lr = 0.03
    params = _tree(seed + 7)
    jp, tp = _both(params)
    got = tops.fused_selective_update(tp, ts, torch.from_numpy(mask), lr, tw)
    want = jops.fused_selective_update(jp, js, jnp.asarray(mask), lr, jw)
    for k in stacked:
        gap = np.abs(got[k].numpy() - np.asarray(want[k]))
        tol = 1e-6 * lr * scale[k] + np.spacing(
            np.maximum(np.abs(params[k]), np.abs(np.asarray(want[k]))))
        assert (gap <= tol).all(), k
