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
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
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
    "requires_grad": lambda q, k, v: (q.requires_grad_(), k, v, {}),
}


@pytest.mark.parametrize("bad", sorted(BAD))
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.from_numpy(_normal((2, 256, 32), s)) for s in range(3))
    q, k, v, kw = BAD[bad](q, k, v)
    with pytest.raises((TypeError, ValueError, RuntimeError)):
        tfa.flash_attention(q, k, v, causal=True, **kw)


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
