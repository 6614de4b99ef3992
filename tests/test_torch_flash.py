"""The port's flash attention on the CPU (the plain version behind the
wrapper, and ``blockwise_attention``'s loop) against the JAX package's
Pallas kernel in interpret mode, its ``_naive`` oracle and
``layers.blockwise_attention``, on the same numpy inputs.

Tolerances, with their reasons:
  * f32: 1e-5 absolute on N(0, 1) inputs. The plain version is a dense
    softmax, the others online over blocks, so the sums run in another
    order; their f32 results differ by about 1e-6.
  * bf16: one bf16 ulp (of the larger of the two magnitudes) plus the
    f32 tolerance, elementwise: both round once from f32 values up to
    1e-5 apart, each by at most half an ulp. One ulp alone is not enough
    near zero, where the bf16 ulp falls below the f32 gap (an output of
    3.8e-6 against 3.7e-6 on these inputs).
  * the port's ``blockwise_attention`` against the JAX one: 3e-4, the JAX
    package's own tolerance for that function (``tests/test_flash_attn.py``).
The rotary frequencies must be bit-equal to the JAX package's.

The card's bf16 kernel (``csrc/flash_attn_wgmma.cu``) cannot run here; its
arithmetic can. A torch emulation of it (bf16 Q·Kᵀ products summed in f32,
then the scale, folded with log2(e) as the kernel's exp2 softmax does;
online softmax over KV tiles of 64; P split into bf16 hi and lo parts,
O += P_hi·V + P_lo·V in f32; l from the f32 P) is held to the plain
version with ``chip_smoke.py``'s own tolerance function, and the same
emulation with P rounded to bf16 alone is shown to exceed it.
"""
import importlib.util
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from test_flash_attn import _naive

from repro.kernels.flash_attn import flash_attention as pallas_flash
from repro.models import layers as JL

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attn as tfa
from repro_torch.kernels import ref
from repro_torch.models import layers as TL

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(x, dtype):
    """The same values as a torch and a jnp array of ``dtype`` (bf16 by
    one round to nearest even of the f32 values, on both sides)."""
    tdt, jdt = DTYPES[dtype]
    t = torch.from_numpy(x).to(tdt)
    return t, jnp.asarray(t.to(torch.float32).numpy()).astype(jdt)


def bf16_ulp(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """One bf16 ulp (8 significant bits) at the larger of |a| and |b|."""
    _, e = np.frexp(np.maximum(np.abs(a), np.abs(b)))
    return np.ldexp(np.float32(1.0), e - 8)


def _assert_close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        excess = np.abs(got - want) - bf16_ulp(got, want) - 1e-5
        assert (excess <= 0).all(), excess.max()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(4, 256, 64), (12, 512, 32)])
def test_plain_flash_matches_pallas_and_naive(shape, causal, dtype):
    q, k, v = (_pair(_normal(shape, seed), dtype) for seed in (0, 1, 2))
    got = tfa.flash_attention(q[0], k[0], v[0], causal=causal)
    assert got.dtype == DTYPES[dtype][0] and got.shape == shape
    got = got.to(torch.float32).numpy()
    pallas = pallas_flash(q[1], k[1], v[1], causal=causal)
    assert pallas.dtype == DTYPES[dtype][1]
    _assert_close(got, pallas, dtype)
    _assert_close(got, _naive(q[1], k[1], v[1], causal), dtype)


def _gqa_inputs(B, S, K, G, hd, seed=0):
    return (_normal((B, S, K * G, hd), seed), _normal((B, S, K, hd), seed + 1),
            _normal((B, S, K, hd), seed + 2))


@pytest.mark.parametrize("window", [None, 200])
@pytest.mark.parametrize("K,G", [(2, 3), (1, 4)])
def test_gqa_layout_matches_jax_blockwise(K, G, window):
    """Query head h reads KV head h // G: G > 1 with K > 1 tells it apart
    from h % K."""
    B, S, hd = 2, 1024, 32
    q, k, v = _gqa_inputs(B, S, K, G, hd)
    want = np.asarray(JL.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        sliding_window=window, out_dtype=jnp.float32, block=256))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    H = K * G
    flat = ref.flash_attention(
        tq.transpose(1, 2).reshape(B * H, S, hd),
        tk.transpose(1, 2).reshape(B * K, S, hd),
        tv.transpose(1, 2).reshape(B * K, S, hd), True, window, kv_groups=G)
    flat = flat.reshape(B, H, S, hd).transpose(1, 2).reshape(B, S, H * hd)
    np.testing.assert_allclose(flat.numpy(), want, rtol=0, atol=1e-5)
    wrapped = tfa.flash_attention_gqa(tq, tk, tv, causal=True,
                                      sliding_window=window)
    assert torch.equal(wrapped.reshape(B, S, H * hd), flat)
    loop = TL.blockwise_attention(tq, tk, tv, causal=True,
                                  sliding_window=window,
                                  out_dtype=torch.float32, block=256)
    np.testing.assert_allclose(loop.numpy(), want, rtol=3e-4, atol=3e-4)


def test_head_mapping_is_h_over_g():
    """Distinct KV heads: the plain version's output for query head h
    equals single-head attention against KV head h // G, not h % K."""
    B, S, K, G, hd = 1, 256, 2, 3, 32
    q, k, v = (torch.from_numpy(a) for a in _gqa_inputs(B, S, K, G, hd, 7))
    out = tfa.flash_attention_gqa(q, k, v, causal=True)
    for h in range(K * G):
        one = tfa.flash_attention(q[:, :, h], k[:, :, h // G], v[:, :, h // G],
                                  causal=True)
        assert torch.equal(out[:, :, h], one)
    assert not torch.equal(out[:, :, 1], tfa.flash_attention(
        q[:, :, 1], k[:, :, 1 % K], v[:, :, 1 % K], causal=True))


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("hd", [32, 64, 96, 128])
@pytest.mark.parametrize("fraction", [1.0, 0.25])
def test_rope_freqs_bit_equal_to_jax(hd, theta, fraction):
    inv, rot = TL.rope_freqs(hd, fraction, theta)
    jinv, jrot = JL.rope_freqs(hd, fraction, theta)
    assert rot == jrot and inv.dtype == torch.float32
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))


BAD = {
    "S % 128": lambda q, k, v: (q[:, :200], k, v, {}),
    "Sk % 128": lambda q, k, v: (q, k[:, :200], v[:, :200], {}),
    "hd > 256": lambda q, k, v: (q.repeat(1, 1, 9), k.repeat(1, 1, 9),
                                 v.repeat(1, 1, 9), {}),
    "hd % 8": lambda q, k, v: (q[..., :28], k[..., :28], v[..., :28], {}),
    "dtype": lambda q, k, v: (q, k.to(torch.bfloat16), v, {}),
    "float16": lambda q, k, v: (q.half(), k.half(), v.half(), {}),
    "S > Sk causal": lambda q, k, v: (q, k[:, :128], v[:, :128], {}),
    "strided hd": lambda q, k, v: (q[..., ::2], k[..., ::2], v[..., ::2], {}),
}


@pytest.mark.parametrize("bad", sorted(BAD))
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.from_numpy(_normal((2, 256, 32), s)) for s in range(3))
    q, k, v, kw = BAD[bad](q, k, v)
    with pytest.raises((TypeError, ValueError, RuntimeError)):
        tfa.flash_attention(q, k, v, causal=True, **kw)


@pytest.mark.parametrize("window", [None, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_wrapper_differentiates_like_the_plain_version(causal, window):
    """Under grad the wrapper is an autograd Function (it refused inputs
    that require grad before it had a backward): its backward, one query
    block at a time, against autograd of the plain dense version, f32,
    within 1e-5 of each gradient's largest magnitude (sums over the keys
    and queries in another order)."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(11)
    B, S, H, K, hd = 1, 256, 4, 2, 32
    arrays = [rng.normal(size=(B, S, n, hd)).astype(np.float32)
              for n in (H, K, K)]
    dout = torch.from_numpy(rng.normal(size=(B, S, H, hd)).astype(
        np.float32))
    q, k, v = (torch.tensor(a, requires_grad=True) for a in arrays)
    tfa.flash_attention_gqa(q, k, v, causal=causal,
                            sliding_window=window).backward(dout)
    q2, k2, v2 = (torch.tensor(a, requires_grad=True) for a in arrays)
    plain = ref.flash_attention(
        q2.transpose(1, 2).reshape(B * H, S, hd),
        k2.transpose(1, 2).reshape(B * K, S, hd),
        v2.transpose(1, 2).reshape(B * K, S, hd), causal, window,
        kv_groups=H // K).reshape(B, H, S, hd).transpose(1, 2)
    plain.backward(dout)
    for got, want in ((q.grad, q2.grad), (k.grad, k2.grad),
                      (v.grad, v2.grad)):
        assert float((got - want).abs().max()) <= \
            1e-5 * float(want.abs().max())


def test_cpu_call_launches_no_kernel():
    before = tfa.launches
    q = torch.from_numpy(_normal((2, 128, 32), 0))
    assert tfa.flash_attention(q, q, q).shape == (2, 128, 32)
    assert tfa.launches == before


def test_cuda_tensor_gets_the_kernel_or_an_exception(monkeypatch):
    """A CUDA tensor never falls back to the plain version: here, with no
    card and no CUDA toolkit, the kernel's build raises, from
    ``flash_attention`` and from ``blockwise_attention`` alike."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda-home")
    monkeypatch.setattr(_build, "_loaded", {})
    before = tfa.launches
    with FakeTensorMode():
        flat = torch.empty((4, 512, 32), device="cuda")
        q = torch.empty((1, 512, 4, 32), device="cuda")
        kv = torch.empty((1, 512, 2, 32), device="cuda")
        with pytest.raises(RuntimeError, match="nvcc"):
            tfa.flash_attention(flat, flat, flat)
        with pytest.raises(RuntimeError, match="nvcc"):
            TL.blockwise_attention(q, kv, kv, causal=True,
                                   out_dtype=torch.float32)
    assert tfa.launches == before


def _chip_smoke():
    """``chip_smoke.py`` as a module, for the card's tolerance function
    ``flash_excess`` (and its ``bf16_ulp``)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


LOG2E = 1.4426950408889634


def _emulate_wgmma(q, k, v, causal, window, kv_groups, split=True):
    """The wgmma kernel's arithmetic on the CPU: q (BH, S, hd), k/v
    (BH / G, Sk, hd) bf16 -> (BH, S, hd) bf16. With ``split=False``, P
    is rounded to bf16 before P·V (FlashAttention-3's choice)."""
    S, Sk, hd = q.shape[1], k.shape[1], q.shape[2]
    kf = k.float().repeat_interleave(kv_groups, 0)
    vf = v.float().repeat_interleave(kv_groups, 0)
    scale_log2 = (torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
                  * torch.tensor(LOG2E, dtype=torch.float32))
    scores = (q.float() @ kf.transpose(1, 2)) * scale_log2
    i = torch.arange(S)[:, None]
    j = torch.arange(Sk)[None, :]
    keep = torch.ones((S, Sk), dtype=torch.bool)
    if causal:
        keep &= j <= i
    if window is not None:
        keep &= (i - j) < window
    scores = torch.where(keep, scores, -1e30)
    m = torch.full(q.shape[:2] + (1,), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    for t in range(0, Sk, 64):
        s, vt = scores[:, :, t:t + 64], vf[:, t:t + 64]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2(s - m_new)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        acc = acc * corr + hi @ vt
        if split:
            acc = acc + (p - hi).to(torch.bfloat16).float() @ vt
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)).to(torch.bfloat16)


def _bf16_flat(BH, S, hd, G, seed):
    q = _pair(_normal((BH, S, hd), seed), "bfloat16")[0]
    k, v = (_pair(_normal((BH // G, S, hd), seed + i), "bfloat16")[0]
            for i in (1, 2))
    return q, k, v


@pytest.mark.parametrize("mode", ["causal", "full", "window"])
@pytest.mark.parametrize("hd", [64, 96, 128])
def test_split_p_emulation_within_chip_tolerance(hd, mode):
    """GQA (G = 2) at S 256: the split-P arithmetic stays within one bf16
    ulp plus 1e-5 of the plain version, as the card's check demands."""
    causal, window = mode != "full", (100 if mode == "window" else None)
    q, k, v = _bf16_flat(8, 256, hd, 2, seed=hd)
    want = ref.flash_attention(q, k, v, causal, window, kv_groups=2)
    got = _emulate_wgmma(q, k, v, causal, window, 2)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert _chip_smoke().flash_excess(got, want) <= 0.0


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_p_alone_exceeds_chip_tolerance(causal):
    """Why the kernel splits P: rounding P to bf16 before P·V moves the
    output past the tolerance (here by 1.9e-3 causal and 4.2e-4 full),
    where the split stays inside it."""
    q, k, v = _bf16_flat(4, 512, 128, 1, seed=3)
    want = ref.flash_attention(q, k, v, causal, None)
    excess = _chip_smoke().flash_excess
    assert excess(_emulate_wgmma(q, k, v, causal, None, 1), want) <= 0.0
    assert excess(_emulate_wgmma(q, k, v, causal, None, 1, split=False),
                  want) > 0.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_route_is_a_function_of_dtype_and_hd(dtype):
    """Every hd the contract admits (multiples of 8 up to 256): bf16 at
    64, 96 and 128 takes the wgmma kernel, everything else the SIMT one."""
    for hd in range(8, tfa.MAX_HD + 1, 8):
        want = ("wgmma" if dtype == torch.bfloat16 and hd in (64, 96, 128)
                else "simt")
        assert tfa.route(dtype, hd) == want, hd


def test_cuda_bf16_gets_the_wgmma_kernel_or_an_exception(monkeypatch):
    """A bf16 hd-128 CUDA call builds csrc/flash_attn_wgmma.cu and, when
    that fails, raises; it never reaches the SIMT source or the plain
    version. An f32 call of the same shape builds the SIMT source."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    asked = []

    def load(name):
        asked.append(name)
        raise RuntimeError(f"nvcc not found (building {name})")

    monkeypatch.setattr(_build, "load", load)
    before = (tfa.launches, dict(tfa.launches_by_route))
    with FakeTensorMode():
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.empty((1, 512, 4, 128), device="cuda", dtype=dtype)
            kv = torch.empty((1, 512, 2, 128), device="cuda", dtype=dtype)
            with pytest.raises(RuntimeError, match="nvcc"):
                TL.blockwise_attention(q, kv, kv, causal=True,
                                       out_dtype=dtype)
    assert asked == ["flash_attn_wgmma", "flash_attn"]
    assert (tfa.launches, tfa.launches_by_route) == before
